"""MusicGen-medium backbone [arXiv:2306.05284; hf]: 48L d=1536 24H MHA
d_ff=6144 (plain GELU MLP), vocab 2048 (EnCodec codes). The EnCodec
frontend is a stub: input_specs() provides precomputed frame embeddings
(assignment spec); decode emits EnCodec tokens via the embedding table."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048,
        block_pattern=(("attn", "mlp"),),
        mlp_type="gelu", frontend="audio",
    )
