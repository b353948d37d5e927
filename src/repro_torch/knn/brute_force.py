"""Brute-force KNN graph (paper §IV-B1), the exact reference (port of
``repro.knn.brute_force``).

Computes all n·(n−1) similarities, blocked over rows so the similarity
matrix never materializes whole. Each row block is one call of the
cluster-KNN wrapper (``kernels/goldfinger_knn/ops.knn``) with the block's
rows as queries and every row as the database: the CUDA kernel on a GPU,
its plain version on the CPU. The kernel masks self pairs and ranks equal
sims by column, as the reference's ``lax.top_k``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.goldfinger_knn import ops as gk_ops
from repro_torch.sketch.goldfinger import GoldFinger, words_tensor
from repro_torch.types import NEG_INF, PAD_ID, KNNGraph


def brute_force_knn(gf: GoldFinger, k: int, block: int = 512, *,
                    device="cuda") -> KNNGraph:
    """Exact (under the GoldFinger estimator) KNN graph, row-blocked."""
    dev = resolve_device(device)
    n = gf.n
    words = words_tensor(gf.words, dev)
    card = torch.from_numpy(np.asarray(gf.card, np.int32)).to(dev)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids_out = np.full((n, k), PAD_ID, dtype=np.int32)
    sims_out = np.full((n, k), NEG_INF, dtype=np.float32)
    for start in range(0, n, block):
        stop = min(start + block, n)
        ids, sims = gk_ops.knn(words[start:stop], card[start:stop],
                               all_ids[start:stop], words, card, all_ids, k)
        ids_out[start:stop] = ids.cpu().numpy()
        sims_out[start:stop] = sims.cpu().numpy()
    return KNNGraph(ids=ids_out, sims=sims_out)


def n_similarities(n: int) -> int:
    """Similarity-computation count of brute force (paper: n(n−1)/2)."""
    return n * (n - 1) // 2
