"""Query-serving quality metric (copy of ``repro.eval.metrics.knn_recall``)."""
from __future__ import annotations

import numpy as np

from repro_torch.types import PAD_ID


def knn_recall(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean per-row recall@k of approximate KNN ids vs exact ids.

    Rows are id lists (PAD_ID = absent); each row scores
    |approx ∩ exact| / |exact|.
    """
    vals = []
    for a, e in zip(approx_ids, exact_ids):
        e = e[e != PAD_ID]
        if len(e) == 0:
            continue
        a = a[a != PAD_ID]
        vals.append(len(np.intersect1d(a, e)) / len(e))
    return float(np.mean(vals)) if vals else 0.0
