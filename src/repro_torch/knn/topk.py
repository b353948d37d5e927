"""Shared top-k neighbor utilities (torch port of ``repro.knn.topk``).

Two tie-break hazards are handled here once, for every caller:
``torch.topk`` does not break ties at the lowest column the way
``lax.top_k`` does, and ``torch.argsort`` is unstable by default. Every
selection therefore goes through a *stable* descending sort
(:func:`topk_desc`), which ranks equal values by column exactly as
``lax.top_k``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.types import NEG_INF, PAD_ID, KNNGraph


def topk_desc(x: torch.Tensor, k: int):
    """(values, positions) of the k largest entries per row, ties to the
    lowest column — ``lax.top_k``'s order."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """bool[n, c]: True for the first occurrence of each id in its row.

    Stable-sorts ids per row, marks repeats, then scatters the mask back
    through the permutation.
    """
    order = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = torch.gather(ids, -1, order)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    return torch.empty_like(first).scatter_(-1, order, first)


def select_topk(cand_sims: torch.Tensor, cand_ids: torch.Tensor, k: int,
                *, dedup_ids: bool = False):
    """k rounds of (max, first-occurrence) selection.

    cand_sims f32[n, c], cand_ids i32[n, c] → (f32[n, k], i32[n, k]).
    Ties resolve to the lowest column. With ``dedup_ids`` every column
    carrying a round's winning id retires with the winner. This is the
    selection the CUDA kernels implement; :func:`merge_topk` is the
    sort-based equivalent the plain paths use.
    """
    n, c = cand_sims.shape
    col = torch.arange(c, device=cand_sims.device).expand(n, c)
    sims = cand_sims.clone()
    sel_sims, sel_ids = [], []
    for _ in range(k):
        m = sims.max(dim=1).values
        hit = sims == m[:, None]
        first_col = torch.where(hit, col, c).min(dim=1).values
        win = torch.gather(cand_ids, 1, first_col[:, None])[:, 0]
        sel_sims.append(m)
        sel_ids.append(win)
        kill = col == first_col[:, None]
        if dedup_ids:
            kill = kill | (cand_ids == win[:, None])
        sims = torch.where(kill, NEG_INF, sims)
    return (torch.stack(sel_sims, dim=1),
            torch.stack(sel_ids, dim=1).to(torch.int32))


def merge_topk(ids: torch.Tensor, sims: torch.Tensor, k: int,
               self_ids: torch.Tensor | None = None):
    """Per-row top-k with dedup / self-edge / PAD masking.

    ids int32[n, c] candidate neighbor ids (PAD_ID = absent), sims
    float32[n, c]. Returns (ids int32[n, k], sims float32[n, k]) sorted by
    sim desc, ties to the earliest column, PAD/−inf filled.
    """
    if ids.shape[1] < k:  # fewer candidates than requested neighbors
        pad = k - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=PAD_ID)
        sims = torch.nn.functional.pad(sims, (0, pad), value=NEG_INF)
    valid = ids != PAD_ID
    if self_ids is not None:
        valid &= ids != self_ids[:, None]
    valid &= dedup_mask(ids)
    masked = torch.where(valid, sims, NEG_INF)
    top_sims, pos = topk_desc(masked, k)
    top_ids = torch.gather(ids, 1, pos)
    top_ids = torch.where(top_sims == NEG_INF, PAD_ID, top_ids)
    return top_ids, top_sims


def union_graphs(a: KNNGraph, b: KNNGraph, k: int | None = None, *,
                 device="cuda") -> KNNGraph:
    """Merge two KNN graphs per user through :func:`merge_topk` on
    ``device`` (self edges, PAD lanes and repeated ids dropped; equal sims
    keep a's lanes first)."""
    k = k or a.k
    dev = resolve_device(device)
    ids = torch.from_numpy(np.concatenate(
        [np.asarray(a.ids), np.asarray(b.ids)], axis=1)).to(dev)
    sims = torch.from_numpy(np.concatenate(
        [np.asarray(a.sims), np.asarray(b.sims)], axis=1)).to(dev)
    self_ids = torch.arange(a.n, dtype=ids.dtype, device=dev)
    out_ids, out_sims = merge_topk(ids, sims, k, self_ids)
    return KNNGraph(ids=out_ids.cpu().numpy(), sims=out_sims.cpu().numpy())
