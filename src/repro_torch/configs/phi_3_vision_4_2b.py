"""Phi-3-vision-128k [hf:microsoft/Phi-3-vision-128k-instruct; hf]:
phi3-mini backbone 32L d=3072 32H MHA d_ff=8192 SwiGLU vocab 32064.
CLIP frontend is a stub: input_specs() provides precomputed patch
embeddings mixed into the sequence (assignment spec)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        head_dim=96, d_ff=8192, vocab_size=32064,
        block_pattern=(("attn", "mlp"),),
        mlp_type="swiglu", frontend="vision",
    )
