"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427;
hf:google/recurrentgemma-2b config.json]: 26L d=2560 10H MQA head_dim=256,
GeGLU d_ff=7680, vocab 256000, RG-LRU + local attention (window 2048) at
a 2:1 ratio. 26 = 2×13, so the (r,r,a) cycle is encoded
as a 13-layer pattern (9r+4a) — identical block counts (18 recurrent /
8 attention), positions shifted by one in the second half. subquadratic →
runs long_500k (local-attn ring cache + O(1) recurrent state)."""
from repro_torch.models.config import ModelConfig

_R = ("rglru", "mlp")
_A = ("local_attn", "mlp")


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=(_R, _R, _A, _R, _R, _A, _R, _R, _A, _R, _R, _A, _R),
        mlp_type="geglu", window=2048, rglru_width=2560,
        tie_embeddings=True, scale_embed=True, subquadratic=True,
    )
