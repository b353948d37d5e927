"""The paper benches' scaling, a copy of ``benchmarks/common.py``: user
scales per dataset that keep each dataset's item universe, and C²
parameters that keep the paper's occupancy ratios at those scales,
b ≈ n/16 and N ≈ 3% of n, at k = 10 (the paper's 30 would be ~1% of a
scaled dataset per neighborhood)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.params import C2Params, params_for

BENCH_SCALES = {
    "ml1M": 0.35, "ml10M": 0.06, "ml20M": 0.02,
    "AM": 0.055, "DBLP": 0.15, "GW": 0.15,
}
BENCH_K = 10


def bench_params(name: str, n_users: int, k: int = BENCH_K,
                 **overrides) -> C2Params:
    """The benches' parameters for ``n_users`` users of dataset ``name``."""
    b = 1 << max(6, int(np.ceil(np.log2(max(n_users / 16, 1)))))
    N = max(64, int(0.03 * n_users))
    kw = dict(k=k, b=b, max_cluster=N)
    kw.update(overrides)
    return dataclasses.replace(params_for(name), **kw)
