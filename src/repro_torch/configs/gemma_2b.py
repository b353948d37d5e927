"""Gemma-2B [arXiv:2403.08295; hf]: 18L d=2048 8H MQA (kv=1) head_dim=256,
GeGLU d_ff=16384, vocab 256000, tied embeddings, sqrt(d) embed scale."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=256000,
        block_pattern=(("attn", "mlp"),),
        mlp_type="geglu", tie_embeddings=True, scale_embed=True,
    )
