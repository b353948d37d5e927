"""LPT bin-packing of clusters (torch port of the LPT functions of
``repro.core.distributed``).

The paper's thread pool and synchronised priority queue become a static
LPT (longest-processing-time) bin-packing of clusters. Serving shards
(``query/sharded.py``) place clusters with :func:`lpt_assign` and weigh
the shards with :func:`lpt_loads`. The reference also runs the build's
Step 2 with one bin per mesh device; that path waits for one card per
bin (ROADMAP queue 1 item 5, rest: the mesh).
"""
from __future__ import annotations

import numpy as np


def lpt_assign(costs: np.ndarray, n_bins: int) -> np.ndarray:
    """Longest-processing-time assignment: returns bin id per item."""
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_bins, dtype=np.float64)
    assign = np.zeros(len(costs), dtype=np.int64)
    for i in order:
        b = int(np.argmin(loads))
        assign[i] = b
        loads[b] += costs[i]
    return assign


def lpt_loads(costs: np.ndarray, assign: np.ndarray,
              n_bins: int) -> np.ndarray:
    """Per-bin load of an assignment (shared by build + serving shards)."""
    loads = np.zeros(n_bins, dtype=np.float64)
    np.add.at(loads, assign, np.asarray(costs, dtype=np.float64))
    return loads
