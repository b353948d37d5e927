"""Exact Jaccard over raw profiles, used to evaluate graph quality (port
of ``repro.sketch.exact``).

Every KNN algorithm of the paper estimates similarities through
GoldFinger; the quality metric (Eq. 2) compares graphs by the similarity
of their edges, scored here with the exact set Jaccard so estimator error
is charged to the algorithm.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sketch.goldfinger import jaccard_epilogue
from repro_torch.types import PAD_ID, Dataset

# Search-side stand-in for PAD_ID: keeps each sorted row ascending and
# never matches a real item id.
_SENTINEL = np.int32(2**31 - 1)


def edge_jaccard(ds: Dataset, src: np.ndarray, dst: np.ndarray, *,
                 chunk: int = 8192, device="cuda") -> np.ndarray:
    """Exact Jaccard for an edge list (host arrays in and out); PAD_ID dst
    → 0. Membership is counted by ``torch.searchsorted`` of the source's
    items in the destination's sorted row, on ``device``, ``chunk`` edges
    at a time; the sims are the GoldFinger scorers' f32 epilogue
    ``inter / max(union, 1)`` over exact counts."""
    dev = resolve_device(device)
    padded, _ = ds.padded_profiles()
    padded_sorted = np.sort(np.where(padded == PAD_ID, _SENTINEL, padded),
                            axis=1)
    prof = torch.from_numpy(padded).to(dev)
    prof_sorted = torch.from_numpy(padded_sorted).to(dev)
    sizes = torch.from_numpy(ds.profile_sizes).to(dev)
    dst_safe = np.where(dst == PAD_ID, 0, dst)
    src_t = torch.from_numpy(np.asarray(src, np.int64)).to(dev)
    dst_t = torch.from_numpy(np.asarray(dst_safe, np.int64)).to(dev)
    last = prof.shape[1] - 1
    sims = np.empty(len(src_t), dtype=np.float32)
    for s in range(0, len(src_t), chunk):
        su, sv = src_t[s:s + chunk], dst_t[s:s + chunk]
        pu, pv = prof[su], prof_sorted[sv]
        idx = torch.searchsorted(pv, pu).clamp_(0, last)
        hit = (torch.gather(pv, 1, idx) == pu) & (pu != PAD_ID)
        inter = hit.sum(dim=1)
        sims[s:s + chunk] = jaccard_epilogue(
            inter, sizes[su], sizes[sv]).cpu().numpy()
    return np.where(dst == PAD_ID, 0.0, sims)
