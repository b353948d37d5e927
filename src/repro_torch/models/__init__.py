"""The LM stack's models (dense family): ``config.ModelConfig``,
``layers`` (RMSNorm, RoPE, attention, MLP) and ``model.LM``."""
