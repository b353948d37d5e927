"""Step 3 of C²: merging the t partial KNN graphs (paper Alg. 3).

Torch port of ``repro.core.merge``: concatenate each user's t×k
candidates, mask duplicates (reusing their sims) and self-edges, and take
one wide top-k.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.knn.topk import merge_topk
from repro_torch.types import KNNGraph


def merge_partial(ids: np.ndarray, sims: np.ndarray, k: int,
                  device="cuda") -> KNNGraph:
    """ids/sims: [t, n, k'] per-configuration partial KNNs → final graph."""
    dev = resolve_device(device)
    t, n, _ = ids.shape
    with obs.span("merge"):
        ids_t = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
        sims_t = torch.from_numpy(np.ascontiguousarray(sims)).to(dev)
        obs.count("merge.h2d_bytes", ids_t.nbytes + sims_t.nbytes)
        flat_ids = ids_t.permute(1, 0, 2).reshape(n, -1)
        flat_sims = sims_t.permute(1, 0, 2).reshape(n, -1)
        self_ids = torch.arange(n, dtype=torch.int32, device=dev)
        out_ids, out_sims = merge_topk(flat_ids, flat_sims, k, self_ids)
        graph = KNNGraph(ids=out_ids.cpu().numpy(),
                         sims=out_sims.cpu().numpy())
        obs.count("merge.d2h_bytes", graph.ids.nbytes + graph.sims.nbytes)
    return graph
