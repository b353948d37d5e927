"""Reverse adjacency of a KNN graph (host numpy copy of
``repro.knn.greedy.reverse_neighbors_np``).

The Hyrec and NNDescent builders of the reference are not ported yet
(ROADMAP queue 1 items 2 and 10); the serving index needs only this.
"""
from __future__ import annotations

import numpy as np

from repro_torch.types import PAD_ID


def reverse_neighbors_np(ids: np.ndarray, r_max: int) -> np.ndarray:
    """int32[n, r_max]: up to ``r_max`` in-neighbors per user, PAD_ID padded.

    Edges are visited in a fixed seeded permutation so that truncation at
    ``r_max`` is unbiased and identical to the reference's.
    """
    n, k = ids.shape
    rev = np.full((n, r_max), PAD_ID, dtype=np.int32)
    counts = np.zeros(n, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = ids.reshape(-1)
    order = np.random.default_rng(0).permutation(n * k)  # unbiased truncation
    for e in order:
        d = dst[e]
        if d == PAD_ID:
            continue
        c = counts[d]
        if c < r_max:
            rev[d, c] = src[e]
            counts[d] = c + 1
    return rev
