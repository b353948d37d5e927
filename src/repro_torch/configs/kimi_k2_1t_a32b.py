"""Kimi K2 (paper-table proxy) [arXiv:2501.kimi2; unverified]: 61L d=7168
64H GQA kv=8, per-expert d_ff=2048, 384 experts top-8, vocab 163840.
~1.03T total / ~31B active. Spec followed as assigned (no MLA/shared
expert — the pool entry lists plain GQA)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        head_dim=112, d_ff=2048, vocab_size=163840,
        block_pattern=(("attn", "moe"),),
        n_experts=384, experts_per_token=8,
        mlp_type="swiglu",
    )
