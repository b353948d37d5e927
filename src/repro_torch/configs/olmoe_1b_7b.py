"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B config.json]:
16L d=2048 16H (MHA) head_dim 128, per-expert SwiGLU d_ff=1024, 64
experts top-8, vocab 50304. ~6.9B total / ~1.3B active. The published
model normalises q and k; the reference's attention block does not. The
capacity factor 1.25 is the reference's default."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1024, vocab_size=50304,
        block_pattern=(("attn", "moe"),),
        n_experts=64, experts_per_token=8,
        mlp_type="swiglu",
    )
