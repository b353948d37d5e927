"""Granite-20B-code [arXiv:2405.04324; hf]: 52L, otherwise as granite-34b."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        block_pattern=(("attn", "mlp"),),
        mlp_type="gelu",
    )
