"""Granite-34B-code [arXiv:2405.04324; hf]: 88L d=6144 48H MQA (kv=1)
d_ff=24576 (4·d, plain GELU — the 4× ratio implies the non-gated
GPTBigCode-style MLP; with it the config lands on 34B), vocab 49152."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        block_pattern=(("attn", "mlp"),),
        mlp_type="gelu",
    )
