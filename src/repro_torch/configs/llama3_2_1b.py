"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified]: 16L d=2048 32H
GQA kv=8, SwiGLU d_ff=8192, vocab 128256, tied embeddings, rope 500k."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        head_dim=64, d_ff=8192, vocab_size=128256,
        block_pattern=(("attn", "mlp"),),
        mlp_type="swiglu", tie_embeddings=True, rope_theta=500_000.0,
    )
