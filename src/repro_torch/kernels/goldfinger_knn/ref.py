"""Plain PyTorch version of the cluster-KNN kernel (``csrc/goldfinger_knn.cu``).

Same function as ``repro.kernels.goldfinger_knn.ref``: all-pairs
GoldFinger Jaccard, PAD and self pairs masked to −inf, then a top-k that
ranks equal sims by database column (``lax.top_k``'s order, through a
stable sort). Runs on any device; on the main path only CPU tensors reach
it.
"""
from __future__ import annotations

import torch

from repro_torch.knn.topk import topk_desc
from repro_torch.sketch.goldfinger import jaccard_pairwise
from repro_torch.types import NEG_INF, PAD_ID


def knn_ref(q_words, q_card, q_ids, d_words, d_card, d_ids, k: int):
    """Top-k database neighbors per query row, batched over leading dims.

    q_words int32[..., nq, W] bit-views, q_card / q_ids int32[..., nq]
    (PAD_ID = dead row); d_* likewise. Self pairs (q_id == d_id) and PAD
    rows are excluded. Returns (ids int32[..., nq, k], sims f32[..., nq, k]);
    past the nd database rows (k > nd) the slots are PAD/−inf, as the
    kernels' (``knn_pallas`` and ``csrc/goldfinger_knn.cu``).
    """
    sims = jaccard_pairwise(q_words, q_card, d_words, d_card)
    valid = ((d_ids[..., None, :] != PAD_ID)
             & (q_ids[..., :, None] != PAD_ID)
             & (q_ids[..., :, None] != d_ids[..., None, :]))
    sims = torch.where(valid, sims, NEG_INF)
    nd = sims.shape[-1]
    if k > nd:  # empty database columns past the last: PAD/-inf
        sims = torch.nn.functional.pad(sims, (0, k - nd), value=NEG_INF)
        d_ids = torch.nn.functional.pad(d_ids, (0, k - nd), value=PAD_ID)
    top_sims, pos = topk_desc(sims, k)
    nbr = torch.gather(d_ids[..., None, :].expand(sims.shape), -1, pos)
    top_ids = torch.where(top_sims == NEG_INF, PAD_ID, nbr)
    return top_ids.to(torch.int32), top_sims


def cluster_knn_ref(words, card, member_ids, k: int):
    """Per-cluster KNN: words int32[m, cap, W] → ([m, cap, k] ids, sims)."""
    return knn_ref(words, card, member_ids, words, card, member_ids, k)
