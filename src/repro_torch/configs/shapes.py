"""Assigned input shapes for the LM-family pool (seq_len × global_batch).

``train_4k`` lowers train_step; ``prefill_32k`` lowers prefill_step;
``decode_32k``/``long_500k`` lower decode_step (one new token against a
seq_len cache). ``long_500k`` requires sub-quadratic attention: it runs
only for SSM/hybrid archs (cfg.subquadratic) and is recorded as skipped
for pure full-attention archs (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True
