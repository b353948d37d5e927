"""xLSTM-125M [arXiv:2405.04517, the paper's 125M language-model scale;
no released config.json, so unverified]: 12 blocks d=768 4 heads,
no separate FFN (d_ff=0; xLSTM blocks carry their own up/down projection).
mLSTM:sLSTM ratio 5:1 (period-6 pattern), per the paper's mostly-mLSTM
small configs. subquadratic → runs long_500k with O(1) state."""
from repro_torch.models.config import ModelConfig

_M = ("mlstm",)
_S = ("slstm",)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        head_dim=192, d_ff=0, vocab_size=50304,
        block_pattern=(_M, _M, _M, _M, _M, _S),
        subquadratic=True,
    )
