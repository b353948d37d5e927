"""Evaluation metrics: KNN quality (paper Eq. 1/2), query recall and
recommendation recall (paper §V-B); port of ``repro.eval.metrics``.

Sums stay in numpy over the same float32 arrays as the reference, so the
order of the sum, which decides the last bit, is the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sketch.exact import edge_jaccard
from repro_torch.types import PAD_ID, Dataset, KNNGraph


def exact_avg_sim(ds: Dataset, graph: KNNGraph, *, device="cuda") -> float:
    """avg_sim (Eq. 1) with *exact* Jaccard on raw profiles."""
    n, k = graph.ids.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = graph.ids.reshape(-1)
    sims = edge_jaccard(ds, src, dst, device=device)
    return float(sims.sum() / (n * k))


def quality(ds: Dataset, approx: KNNGraph, exact: KNNGraph, *,
            device="cuda") -> float:
    """Eq. 2: avg_sim(approx) / avg_sim(exact), both exact-Jaccard-scored."""
    denom = exact_avg_sim(ds, exact, device=device)
    if denom == 0:
        return 1.0
    return exact_avg_sim(ds, approx, device=device) / denom


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


def recommend(train: Dataset, graph: KNNGraph,
              n_rec: int = 30) -> list[np.ndarray]:
    """Simple user-based CF (paper §V-B): score items by the summed
    similarity of neighbors who have them; recommend top ``n_rec`` unseen."""
    recs = []
    for u in range(train.n_users):
        scores: dict[int, float] = {}
        seen = set(train.profile(u).tolist())
        for v, s in zip(graph.ids[u], graph.sims[u]):
            if v == PAD_ID or s <= 0:
                continue
            for it in train.profile(int(v)):
                if int(it) not in seen:
                    scores[int(it)] = scores.get(int(it), 0.0) + float(s)
        top = sorted(scores.items(), key=lambda kv: -kv[1])[:n_rec]
        recs.append(np.array([it for it, _ in top], dtype=np.int32))
    return recs


def recall(recs: list[np.ndarray], test_rows: list[np.ndarray]) -> float:
    """Mean per-user recall of held-out items."""
    vals = []
    for rec, test in zip(recs, test_rows):
        if len(test) == 0:
            continue
        vals.append(len(np.intersect1d(rec, test)) / len(test))
    return float(np.mean(vals)) if vals else 0.0
