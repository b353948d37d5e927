"""The shared plain GoldFinger estimator for gathered candidate lanes.

Every plain path that scores a query against a list of index rows — the
plain descent hop (:mod:`repro_torch.kernels.descent_score.ref`) and the
seed scoring of ``query/search.descent_init`` — runs this one function,
so they agree bit for bit with each other, with the CUDA kernels (same
integer intersection, same f32 epilogue) and with
``repro.kernels.descent_score.ref.row_scorer``.
"""
from __future__ import annotations

import torch

from repro_torch.sketch.goldfinger import jaccard_epilogue, popcount32
from repro_torch.types import NEG_INF, PAD_ID


def score_lanes(words: torch.Tensor, card: torch.Tensor,
                q_words: torch.Tensor, q_card: torch.Tensor,
                cand_ids: torch.Tensor) -> torch.Tensor:
    """Sims of each query against its PAD_ID-padded candidate id row.

    words int32[n, W] bit-views, card int32[n]; q_words int32[q, W],
    q_card int32[q]; cand_ids int32[q, C]. Returns f32[q, C], −inf on
    PAD lanes. The intersection is accumulated one word at a time.
    """
    pad = cand_ids == PAD_ID
    safe = torch.where(pad, 0, cand_ids).long()
    cw = words[safe]                                    # [q, C, W]
    cc = torch.where(pad, 0, card[safe])
    inter = torch.zeros(cand_ids.shape, dtype=torch.int32,
                        device=cand_ids.device)
    for w in range(words.shape[1]):
        inter += popcount32(q_words[:, None, w] & cw[:, :, w])
    sims = jaccard_epilogue(inter, q_card[:, None], cc)
    return torch.where(pad, NEG_INF, sims)
