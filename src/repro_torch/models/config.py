"""Model configuration for the LM-family architecture pool (a copy of
``repro.models.config``; pure Python).

One frozen dataclass describes every assigned architecture; per-arch files
in repro_torch/configs/ instantiate it with the exact published numbers.
Layers follow a cycled ``block_pattern`` (e.g. Griffin's recurrent/
recurrent/local-attention 2:1 pattern); parameters are grouped by pattern
period, as the reference stacks them for its scan over groups.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BLOCK_KINDS = ("attn", "local_attn", "mlp", "moe", "rglru", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 → d_model // n_heads
    # Per-layer block pattern, cycled across layers. Each entry is a tuple
    # of blocks applied in sequence within that layer position.
    block_pattern: tuple[tuple[str, ...], ...] = (("attn", "mlp"),)
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # MLP/activation
    mlp_type: str = "swiglu"    # swiglu | geglu | gelu
    # Attention
    window: int = 0             # sliding window for local_attn blocks
    rope_theta: float = 10_000.0
    # Recurrent blocks
    rglru_width: int = 0        # 0 → d_model
    conv_width: int = 4
    mlstm_chunk: int = 0        # 0 = sequential scan; >0 = chunkwise (§Perf)
    # Embedding
    tie_embeddings: bool = False
    scale_embed: bool = False   # gemma-style sqrt(d) embedding scale
    frontend: Optional[str] = None  # None | "audio" | "vision"
    # Numerics
    dtype: str = "bfloat16"     # activation/compute dtype
    param_dtype: str = "float32"
    # Notes for DESIGN/EXPERIMENTS (e.g. long_500k applicability)
    subquadratic: bool = False

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern period {len(self.block_pattern)}")
        for grp in self.block_pattern:
            for kind in grp:
                if kind not in BLOCK_KINDS:
                    raise ValueError(f"unknown block kind {kind!r}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        """Scan length: number of pattern repetitions."""
        return self.n_layers // len(self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        D, F, V, H = self.d_model, self.d_ff, self.vocab_size, self.n_heads
        hd, kv = self.head_dim_, self.n_kv_heads
        total = V * D if self.tie_embeddings else 2 * V * D
        per_pattern = 0
        for grp in self.block_pattern:
            for kind in grp:
                if kind in ("attn", "local_attn"):
                    per_pattern += D * H * hd + 2 * D * kv * hd + H * hd * D
                elif kind == "mlp":
                    n_in = 2 if self.mlp_type in ("swiglu", "geglu") else 1
                    per_pattern += (n_in * D * F) + F * D
                elif kind == "moe":
                    per_pattern += D * self.n_experts  # router
                    per_pattern += self.n_experts * 3 * D * F
                elif kind == "rglru":
                    w = self.rglru_width or D
                    per_pattern += 2 * D * w + w * self.conv_width + 2 * w + w * D
                elif kind in ("mlstm", "slstm"):
                    w = 2 * D  # up-projection width
                    per_pattern += 2 * D * w + w * D + 4 * w * (w // max(self.n_heads, 1))
            per_pattern += 2 * D  # norms
        total += per_pattern * self.n_groups
        total += D  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dead = (self.n_experts - self.experts_per_token) * 3 * D * F
        n_moe = sum(grp.count("moe") for grp in self.block_pattern) * self.n_groups
        return self.param_count() - dead * n_moe


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    period = len(cfg.block_pattern)
    base = dict(
        n_layers=2 * period if period <= 3 else period,
        d_model=64,
        n_heads=max(2, min(4, cfg.n_heads)),
        n_kv_heads=1 if cfg.n_kv_heads == 1 else 2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        rglru_width=64 if cfg.rglru_width else 0,
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
