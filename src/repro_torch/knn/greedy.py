"""Greedy incremental KNN baselines: Hyrec [3] and NNDescent [11,12]
(torch port of ``repro.knn.greedy``).

Both start from a random k-degree graph and refine it by exploring
neighbors-of-neighbors (paper §IV-B2):

* **Hyrec**: compares each user u against u's neighbors' neighbors.
* **NNDescent**: compares all pairs (uᵢ, uⱼ) among u's neighbors and
  updates *their* neighborhoods — realized through the reverse-
  neighborhood formulation: the candidate set of x is the union of the
  neighborhoods of every u that lists x (co-neighbors), which is exactly
  the set of pairs NNDescent generates.

Termination matches §IV-C: stop when the per-iteration update count drops
below δ·k·n (δ=0.001) or after ``max_iters`` (30). Each iteration is plain
torch on ``device`` (the reference's are plain jnp: no kernel): gather the
candidates' fingerprints [n, c, W], score every row against its own
candidates in one batched :func:`jaccard_pairwise` ([n, 1, W] × [n, c, W]),
and merge through :func:`merge_topk`. The δ check runs on the host after
every iteration. The reference's ``_reverse_neighbors`` (a ``fori_loop``
version of :func:`reverse_neighbors_np`) has no caller there and is not
ported.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.knn.topk import merge_topk
from repro_torch.sketch.goldfinger import (GoldFinger, jaccard_pairwise,
                                           words_tensor)
from repro_torch.types import NEG_INF, PAD_ID, KNNGraph


@dataclasses.dataclass
class GreedyStats:
    iters: int
    updates: list[int]
    n_sims: int
    t_total: float


def random_graph(n: int, k: int, seed: int) -> np.ndarray:
    """Initial random k-degree graph (no self edges)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n - 1, size=(n, k), dtype=np.int32)
    rows = np.arange(n, dtype=np.int32)[:, None]
    ids = np.where(ids >= rows, ids + 1, ids)  # skip self
    return ids


def _candidate_sims(cand_ids, words, card):
    """f32[n, c]: each row's Jaccard against its own candidates (−inf on
    PAD lanes), from their gathered fingerprints [n, c, W]. The
    reference's ``_initial_sims`` and the scoring in its
    ``_refine_block``."""
    pad = cand_ids == PAD_ID
    safe = torch.where(pad, 0, cand_ids).long()
    cw = words[safe]
    cc = torch.where(pad, 0, card[safe])
    sims = jaccard_pairwise(words[:, None, :], card[:, None], cw, cc)[:, 0]
    return torch.where(pad, NEG_INF, sims)


def _hyrec_candidates(ids):
    """Neighbors-of-neighbors: [n, k·k]."""
    n, k = ids.shape
    pad = ids == PAD_ID
    non = ids[torch.where(pad, 0, ids).long()].reshape(n, k * k)
    return torch.where(pad.repeat_interleave(k, dim=1), PAD_ID, non)


def _refine_block(ids, sims, cand_ids, words, card, k: int):
    """One refinement pass: merge candidate lists into the current graph.

    ids/sims: [n, k] current graph; cand_ids: [n, c] proposals (PAD_ID ok).
    Returns new (ids, sims, n_changed): n_changed the rows whose id list
    changed (the paper's update counter), a 0-d tensor.
    """
    n = ids.shape[0]
    cand_sims = _candidate_sims(cand_ids, words, card)
    all_ids = torch.cat([ids, cand_ids], dim=1)
    all_sims = torch.cat([sims, cand_sims], dim=1)
    self_ids = torch.arange(n, dtype=torch.int32, device=ids.device)
    new_ids, new_sims = merge_topk(all_ids, all_sims, k, self_ids)
    changed = (new_ids != ids).any(dim=1).sum()
    return new_ids, new_sims, changed


def _device_tables(gf: GoldFinger, dev):
    return (words_tensor(gf.words, dev),
            torch.from_numpy(np.asarray(gf.card, np.int32)).to(dev))


def hyrec(gf: GoldFinger, k: int, max_iters: int = 30, delta: float = 0.001,
          seed: int = 0, ids0: np.ndarray | None = None, *, device="cuda"):
    """Hyrec KNN graph construction."""
    dev = resolve_device(device)
    n = gf.n
    words, card = _device_tables(gf, dev)
    t0 = time.perf_counter()
    ids = torch.from_numpy(np.asarray(
        ids0 if ids0 is not None else random_graph(n, k, seed),
        np.int32)).to(dev)
    sims = _candidate_sims(ids, words, card)
    updates, n_sims = [], n * k
    it = 0
    for it in range(1, max_iters + 1):
        cands = _hyrec_candidates(ids)
        ids, sims, changed = _refine_block(ids, sims, cands, words, card, k)
        n_sims += n * k * k
        changed = int(changed)
        updates.append(changed)
        if changed < delta * k * n:
            break
    graph = KNNGraph(ids=ids.cpu().numpy(), sims=sims.cpu().numpy())
    stats = GreedyStats(iters=it, updates=updates, n_sims=n_sims,
                        t_total=time.perf_counter() - t0)
    return graph, stats


def nndescent(gf: GoldFinger, k: int, max_iters: int = 30,
              delta: float = 0.001, seed: int = 0,
              ids0: np.ndarray | None = None, *, device="cuda"):
    """NNDescent KNN graph construction (reverse-join formulation)."""
    dev = resolve_device(device)
    n = gf.n
    words, card = _device_tables(gf, dev)
    t0 = time.perf_counter()
    ids = torch.from_numpy(np.asarray(
        ids0 if ids0 is not None else random_graph(n, k, seed + 1),
        np.int32)).to(dev)
    sims = _candidate_sims(ids, words, card)
    updates, n_sims = [], n * k
    r_max = k  # sampled reverse degree, as in NNDescent's ρ-sampling
    it = 0
    for it in range(1, max_iters + 1):
        rev = torch.from_numpy(
            reverse_neighbors_np(ids.cpu().numpy(), r_max)).to(dev)
        # Co-neighbor join: neighbors of (forward ∪ reverse) neighbors.
        both = torch.cat([ids, rev], dim=1)  # [n, 2k]
        pad = both == PAD_ID
        cands = ids[torch.where(pad, 0, both).long()].reshape(n, -1)
        cands = torch.where(pad.repeat_interleave(k, dim=1), PAD_ID, cands)
        cands = torch.cat([cands, rev], dim=1)  # [n, 2k·k + r_max]
        ids, sims, changed = _refine_block(ids, sims, cands, words, card, k)
        n_sims += n * (2 * k * k + r_max)
        changed = int(changed)
        updates.append(changed)
        if changed < delta * k * n:
            break
    graph = KNNGraph(ids=ids.cpu().numpy(), sims=sims.cpu().numpy())
    stats = GreedyStats(iters=it, updates=updates, n_sims=n_sims,
                        t_total=time.perf_counter() - t0)
    return graph, stats


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
