"""MoE router load-balance lens (numpy copy of
``repro.train.router_stats``).

MoE capacity overflow is the same size-cap-then-redistribute problem as
the paper's recursive splitting (§II-D): experts play clusters, the
capacity factor plays N. This module reports the router histogram the
way the reference's cluster-size figures report clusters.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def router_stats(gate_e: np.ndarray, cfg: ModelConfig,
                 capacity: int | None = None) -> dict:
    """gate_e int32[T, k] — per-token expert choices from one MoE layer.

    Returns load histogram, imbalance (max/mean — the paper's straggler
    metric for clusters), and the drop fraction at the given capacity.
    """
    E = cfg.n_experts
    loads = np.bincount(np.asarray(gate_e).reshape(-1), minlength=E)
    mean = loads.mean() if E else 0.0
    if capacity is None:
        T = gate_e.shape[0]
        capacity = int(np.ceil(T * cfg.experts_per_token
                               * cfg.capacity_factor / max(E, 1)))
    dropped = np.maximum(loads - capacity, 0).sum()
    return {
        "loads": loads,
        "imbalance": float(loads.max() / mean) if mean else 0.0,
        "capacity": capacity,
        "drop_fraction": float(dropped / max(loads.sum(), 1)),
        "top8_loads": np.sort(loads)[::-1][:8].tolist(),
    }
