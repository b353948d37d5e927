"""Batched graph descent for query serving (torch port of
``repro.query.search``).

Every query of a wave keeps a fixed-width beam of its best candidates;
each hop gathers the forward AND reverse neighbors of the beam
(friend-of-a-friend), scores them against the query fingerprint with the
GoldFinger estimator, and re-selects the beam. The hop has three
implementations with bitwise-identical results:

* ``kernel=False`` — the plain unfused hop
  (``kernels/descent_score/ref.py``): gather, score every lane, dedup
  after the fact, one wide stable top-k;
* ``kernel=True`` — ``kernels/descent_score/ops.descent_hop``: the fused
  CUDA hop on a GPU (its plain version on the CPU), which suppresses
  duplicate/PAD/in-beam lanes before scoring and reports how many lanes
  it scored;
* ``kernel=True, dma=True`` — the DMA hop, which gathers the surviving
  rows through a shared-memory ring and also reports the fingerprint
  bytes it gathered and skipped.

Waves run :func:`batched_descent`; continuous batching runs the same
pieces a hop at a time over a fixed slot array (:func:`slot_admit`,
:func:`slot_hop`, and :func:`slot_prefix_stable` for adaptive budgets).
The sharded placement has its counterparts over a stack of shards
(:func:`batched_descent_sharded`, :func:`shard_slot_admit`,
:func:`shard_slot_hop`, :func:`shard_slot_prefix`), one hop launch for the
stack: ``query/sharded.py`` holds every shard in one stack, or one stack
of one shard per device.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.descent_score import ops as ds_ops
from repro_torch.kernels.descent_score import ref as ds_ref
from repro_torch.kernels.scoring import score_lanes
from repro_torch.knn.topk import merge_topk
from repro_torch.sketch.goldfinger import jaccard_pairwise, words_tensor
from repro_torch.types import NEG_INF, PAD_ID


def descent_init(words, card, q_words, q_card, seed_ids, *, beam: int,
                 tomb=None):
    """Score routed seeds and select the initial beam per query.

    Returns (beam_ids int32[q, beam], beam_sims float32[q, beam]),
    sim-descending, PAD_ID padded. ``tomb`` (bool[n] or None) PADs out
    seeds naming tombstoned rows before scoring.
    """
    if tomb is not None:
        seed_ids = ds_ref.mask_dead(tomb, seed_ids)
    return merge_topk(seed_ids,
                      score_lanes(words, card, q_words, q_card, seed_ids),
                      beam)


def descent_step(graph_ids, rev_ids, words, card, q_words, q_card,
                 beam_ids, beam_sims, *, kernel: bool = False,
                 dma: bool = False, tomb=None):
    """One descent hop for every query row.

    ``kernel=False`` runs the plain unfused hop, ``kernel=True`` the fused
    hop, and ``dma=True`` on top the DMA hop: bitwise the same ids and sims
    all three ways. Rows are independent, which is what lets the
    continuous slots advance in-flight queries hop by hop while other rows
    take fresh admissions.

    Returns ``(beam_ids, beam_sims, stats)`` with ``stats`` int32[q, 3] of
    ``(n_scored, dma_bytes, bytes_saved)`` for this hop: zeros for the
    plain hop (it scores every lane, as in the reference), ``n_scored``
    alone for the fused hop, all three for the DMA hop.
    """
    if kernel:
        ids, sims, *counts = ds_ops.descent_hop(
            graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
            beam_sims, tomb=tomb, dma=dma, with_counts=True)
        return ids, sims, torch.stack(counts, dim=1)
    ids, sims = ds_ref.descent_hop_ref(graph_ids, rev_ids, words, card,
                                       q_words, q_card, beam_ids, beam_sims,
                                       tomb=tomb)
    return ids, sims, torch.zeros((beam_ids.shape[0], 3), dtype=torch.int32,
                                  device=beam_ids.device)


def batched_descent(graph_ids, rev_ids, words, card, q_words, q_card,
                    seed_ids, *, k: int, beam: int, hops: int,
                    kernel: bool = False, dma: bool = False, tomb=None):
    """Beam search over the index graph for a wave of queries.

    graph_ids int32[n, kg], rev_ids int32[n, r]: forward/reverse adjacency.
    words int32[n, W] bit-views, card int32[n]: index fingerprints.
    q_words int32[q, W], q_card int32[q]: query fingerprints.
    seed_ids int32[q, S]: routed seed candidates (PAD_ID padded).
    Returns (ids int32[q, k], sims float32[q, k], stats int32[q, 3]) with
    ``stats`` the per-hop ``(n_scored, dma_bytes, bytes_saved)`` summed
    over the hops.
    """
    beam_ids, beam_sims = descent_init(words, card, q_words, q_card,
                                       seed_ids, beam=beam, tomb=tomb)
    acc = torch.zeros((beam_ids.shape[0], 3), dtype=torch.int32,
                      device=beam_ids.device)
    for _ in range(hops):
        beam_ids, beam_sims, stats = descent_step(
            graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
            beam_sims, kernel=kernel, dma=dma, tomb=tomb)
        acc += stats
    ids, sims = merge_topk(beam_ids, beam_sims, k)
    return ids, sims, acc


def slot_admit(words, card, new_words, new_card, new_seeds, slot_idx,
               q_words, q_card, beam_ids, beam_sims, *, beam: int,
               tomb=None):
    """Admit requests into the persistent slot state, in place.

    ``new_*`` hold one row per admitted request, ``slot_idx`` int64[A] its
    slot. Each admitted row's beam is initialised from its routed seeds
    (:func:`descent_init`) and its fingerprint parked in ``q_words`` /
    ``q_card``, so later hops never upload per-slot query state. The four
    slot tensors are updated with ``index_copy_`` and returned. A whole
    admission generation goes in one call: ``descent_init`` is
    row-independent, so the rows' results do not depend on how requests
    are grouped.
    """
    init_ids, init_sims = descent_init(words, card, new_words, new_card,
                                       new_seeds, beam=beam, tomb=tomb)
    q_words.index_copy_(0, slot_idx, new_words)
    q_card.index_copy_(0, slot_idx, new_card)
    beam_ids.index_copy_(0, slot_idx, init_ids)
    beam_sims.index_copy_(0, slot_idx, init_sims)
    return q_words, q_card, beam_ids, beam_sims


def slot_hop(graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
             beam_sims, active, *, kernel: bool = False, dma: bool = False,
             tomb=None):
    """One continuous-batching tick over the whole slot array.

    Every row takes one :func:`descent_step` hop (the kernels run at the
    fixed slot capacity); ``active`` (bool[n_slots]) rows keep the result
    and inactive rows pass through unchanged. Returns ``(beam_ids,
    beam_sims, changed, stats)``: ``changed[i]`` is False once row i's beam
    reached a fixed point this hop (a hop is a function of the beam, so an
    unchanged beam never changes again, and the request may complete early
    with its full-budget result); ``stats`` is the hop's raw int32[n_slots,
    3], which the caller masks by its own active set.
    """
    nids, nsims, stats = descent_step(graph_ids, rev_ids, words, card,
                                      q_words, q_card, beam_ids, beam_sims,
                                      kernel=kernel, dma=dma, tomb=tomb)
    changed = (nids != beam_ids).any(dim=1) & active
    out_ids = torch.where(active[:, None], nids, beam_ids)
    out_sims = torch.where(active[:, None], nsims, beam_sims)
    return out_ids, out_sims, changed, stats


def slot_prefix_stable(beam_ids, prev_prefix, *, k: int):
    """Per-slot stability of the top-k prefix between consecutive hops.

    Adaptive budgets (``PlanSpec.adaptive``) free a slot once its result,
    the beam's k-prefix, has held for ``adaptive`` hops: a beam's tail
    keeps churning long after the answer settled. Takes single-placement
    ``[n_slots, beam]`` and sharded ``[S, n_slots, beam]`` beams; a slot
    is stable only when every shard's prefix is. Returns ``(stable
    bool[n_slots], prefix)``, ``prefix`` the current k-prefix (a copy) to
    pass back as ``prev_prefix`` on the next tick.
    """
    cur = beam_ids[..., :k].clone()
    same = cur == prev_prefix
    stable = (same.all(dim=2).all(dim=0) if beam_ids.dim() == 3
              else same.all(dim=1))
    return stable, cur


# -- the sharded placement ----------------------------------------------------
#
# The sharded placement (``query/sharded.py``) stacks its shards' local
# subgraphs, ``[S, cap, ·]`` tables, and every shard keeps its own beams
# over them, ``[S, q, B]`` in its own local ids; the query fingerprints are
# every shard's. Each hop is ONE launch for all shards
# (``ops.descent_hop_sharded``: the shard is a grid axis of both kernels),
# the counterpart of the reference's hop vmapped over the shard axis. The
# plain pieces (seed scoring, the plain hop, the merges) are row-wise, so
# they run once for all shards with the shard axis folded into the rows
# (tables ``[S·cap, ·]``, shard s's ids offset by ``s·cap``): each row
# holds one shard's ids, shifted alike, which gives the reference's bits.


def _rows(t):
    """``[S, r, ·]`` → ``[S·r, ·]``: the shard axis folded into the rows."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def _fold(ids, cap: int):
    """Shard-local ids ``[S, r, c]`` as rows of the folded ``[S·cap, ·]``
    tables (shard s's rows start at ``s·cap``): ``[S·r, c]``, PAD stays
    PAD."""
    base = torch.arange(ids.shape[0], dtype=ids.dtype,
                        device=ids.device).mul_(cap).view(-1, 1, 1)
    return _rows(torch.where(ids == PAD_ID, PAD_ID, ids + base))


def _unfold(ids, S: int, cap: int):
    """:func:`_fold`'s inverse: rows ``[S·q, c]`` of folded ids back to
    each shard's local ids ``[S, q, c]``."""
    ids = ids.reshape(S, ids.shape[0] // S, ids.shape[-1])
    base = torch.arange(S, dtype=ids.dtype,
                        device=ids.device).mul_(cap).view(-1, 1, 1)
    return torch.where(ids == PAD_ID, PAD_ID, ids - base)


def descent_init_sharded(l_words, l_card, q_words, q_card, l_seeds, *,
                         beam: int, l_tomb=None):
    """Every shard's initial beams from its own owner-partitioned local
    seeds ``l_seeds`` int32[S, q, cols]: (ids int32[S, q, beam], sims
    f32[S, q, beam])."""
    S, cap = l_words.shape[:2]
    ids, sims = descent_init(
        _rows(l_words), _rows(l_card), q_words.repeat(S, 1),
        q_card.repeat(S), _fold(l_seeds, cap), beam=beam,
        tomb=None if l_tomb is None else _rows(l_tomb))
    return _unfold(ids, S, cap), sims.reshape(S, l_seeds.shape[1], beam)


def descent_step_sharded(l_graph, l_rev, l_words, l_card, q_words, q_card,
                         beam_ids, beam_sims, *, kernel: bool = False,
                         dma: bool = False, l_tomb=None):
    """One hop of every shard's beams ``[S, q, B]``: with ``kernel`` one
    launch of the fused (or, with ``dma``, the DMA) hop for all shards,
    else the plain hop once over the folded shards. Returns ``(beam_ids, beam_sims,
    stats)`` with ``stats`` int32[S, q, 3], each shard's as
    :func:`descent_step` gives it."""
    if kernel:
        ids, sims, *counts = ds_ops.descent_hop_sharded(
            l_graph, l_rev, l_words, l_card, q_words, q_card, beam_ids,
            beam_sims, tomb=l_tomb, dma=dma, with_counts=True)
        return ids, sims, torch.stack(counts, dim=-1)
    (S, cap), (q, B) = l_graph.shape[:2], beam_ids.shape[1:]
    ids, sims, stats = descent_step(
        _fold(l_graph, cap), _fold(l_rev, cap), _rows(l_words),
        _rows(l_card), q_words.repeat(S, 1), q_card.repeat(S),
        _fold(beam_ids, cap), _rows(beam_sims),
        tomb=None if l_tomb is None else _rows(l_tomb))
    return (_unfold(ids, S, cap), sims.reshape(S, q, B),
            stats.reshape(S, q, 3))


def map_shard_ids(table, ids):
    """Each shard's ids [S, q, c] mapped through its row of ``table``
    int32[S, ·] (local → global through l2g, or old → new local ids
    through a reshard's remap); PAD stays PAD."""
    S, q, c = ids.shape
    safe = torch.where(ids == PAD_ID, 0, ids).long().reshape(S, q * c)
    out = torch.gather(table, 1, safe).reshape(S, q, c)
    return torch.where(ids == PAD_ID, PAD_ID, out)


def _merge_rows(ids, sims, k: int):
    """:func:`merge_topk` of every row of ``[S, q, c]`` (row-wise, so the
    shard axis folds into the rows)."""
    S, q, c = ids.shape
    out_ids, out_sims = merge_topk(ids.reshape(S * q, c),
                                   sims.reshape(S * q, c), k)
    return out_ids.reshape(S, q, k), out_sims.reshape(S, q, k)


def batched_descent_sharded(l_graph, l_rev, l_words, l_card, l2g, l_tomb,
                            q_words, q_card, l_seeds, *, k: int, beam: int,
                            hops: int, kernel: bool = False,
                            dma: bool = False):
    """Every shard's beam search for a wave of queries (the reference's
    ``_vmapped_descent``): init from the shard's own seeds, ``hops``
    sharded hops, each shard's top k, mapped to global ids.

    Returns (ids int32[S, q, k] global, sims f32[S, q, k], stats
    int32[S, q, 3]) with ``stats`` summed over the hops; the cross-shard
    merge is the caller's (``sharded._merge_shard_topk``).
    """
    beam_ids, beam_sims = descent_init_sharded(
        l_words, l_card, q_words, q_card, l_seeds, beam=beam, l_tomb=l_tomb)
    acc = torch.zeros(beam_ids.shape[:2] + (3,), dtype=torch.int32,
                      device=beam_ids.device)
    for _ in range(hops):
        beam_ids, beam_sims, stats = descent_step_sharded(
            l_graph, l_rev, l_words, l_card, q_words, q_card, beam_ids,
            beam_sims, kernel=kernel, dma=dma, l_tomb=l_tomb)
        acc += stats
    ids, sims = _merge_rows(beam_ids, beam_sims, k)
    return map_shard_ids(l2g, ids), sims, acc


def shard_slot_admit(l_words, l_card, new_words, new_card, new_seeds,
                     slot_idx, q_words, q_card, beam_ids, beam_sims, *,
                     beam: int, l_tomb=None):
    """Admit requests into every shard's persistent slot state, in place.

    ``new_seeds`` int32[S, A, cols] are the admitted rows'
    owner-partitioned local seeds (``ShardedDescent.shard_seeds``): each
    shard initialises its slot rows from the seeds it owns, as the sharded
    wave seeds its descent. Beams are ``[S, n_slots, beam]``.
    """
    init_ids, init_sims = descent_init_sharded(
        l_words, l_card, new_words, new_card, new_seeds, beam=beam,
        l_tomb=l_tomb)
    q_words.index_copy_(0, slot_idx, new_words)
    q_card.index_copy_(0, slot_idx, new_card)
    beam_ids.index_copy_(1, slot_idx, init_ids)
    beam_sims.index_copy_(1, slot_idx, init_sims)
    return q_words, q_card, beam_ids, beam_sims


def shard_slot_hop(l_graph, l_rev, l_words, l_card, q_words, q_card,
                   beam_ids, beam_sims, active, *, kernel: bool = False,
                   dma: bool = False, l_tomb=None):
    """One continuous tick over every shard's slot array: one sharded hop
    of all rows; ``active`` rows keep the result. ``changed[i]`` is False
    only when slot i's beam reached a fixed point on EVERY shard, so the
    request may complete early with its full-budget result. ``stats`` is
    the raw int32[n_slots, 3] summed over shards; the caller masks it by
    its own active set."""
    nids, nsims, stats = descent_step_sharded(
        l_graph, l_rev, l_words, l_card, q_words, q_card, beam_ids,
        beam_sims, kernel=kernel, dma=dma, l_tomb=l_tomb)
    changed = (nids != beam_ids).any(dim=2).any(dim=0) & active
    keep = active[None, :, None]
    return (torch.where(keep, nids, beam_ids),
            torch.where(keep, nsims, beam_sims), changed,
            stats.sum(dim=0, dtype=torch.int32))


def shard_slot_prefix(l2g, beam_ids, beam_sims, *, k: int):
    """Every shard's top k of its slot beams ``[S, n_slots, B]``, in
    global ids: each beam is a ``merge_topk`` output, so its top k is its
    k-prefix, the wave's per-shard closing merge. Returns (ids int32[S,
    n_slots, k], sims f32[S, n_slots, k]); merged shard-major across shards
    (``sharded._merge_shard_topk``) they give the sharded wave's bits."""
    return (map_shard_ids(l2g, beam_ids[:, :, :k].contiguous()),
            beam_sims[:, :, :k])


def new_slot_part(n_slots: int, W: int, beam: int, k_prefix: int, device,
                  shards: int | None = None):
    """Empty slot arrays on ``device``: query fingerprints int32[n_slots,
    W] and card int32[n_slots], beams ``[n_slots, beam]`` (``[shards,
    n_slots, beam]`` for a set of shards) of PAD / -inf, and with
    ``k_prefix`` the adaptive budgets' stored k-prefixes of PAD."""
    lead = () if shards is None else (shards,)
    shape = lead + (n_slots, beam)
    return SimpleNamespace(
        q_words=torch.zeros((n_slots, W), dtype=torch.int32, device=device),
        q_card=torch.zeros(n_slots, dtype=torch.int32, device=device),
        beam_ids=torch.full(shape, PAD_ID, dtype=torch.int32, device=device),
        beam_sims=torch.full(shape, NEG_INF, dtype=torch.float32,
                             device=device),
        prefix_ids=(torch.full(lead + (n_slots, k_prefix), PAD_ID,
                               dtype=torch.int32, device=device)
                    if k_prefix else None))


def _exact_block(words, card, tomb, q_words, q_card, k: int,
                 dchunk: int = 512):
    """Exact top-k of a query block over every index row, streaming the
    database axis in ``dchunk``-column tiles through ``merge_topk`` (the
    running set is concatenated first, so equal-sim ties keep the
    earliest id, exactly as one global top-k)."""
    n = words.shape[0]
    q = q_words.shape[0]
    dev = q_words.device
    ids = torch.full((q, k), PAD_ID, dtype=torch.int32, device=dev)
    sims = torch.full((q, k), NEG_INF, dtype=torch.float32, device=dev)
    for s in range(0, n, dchunk):
        e = min(s + dchunk, n)
        c_sims = jaccard_pairwise(q_words, q_card, words[s:e], card[s:e])
        c_sims = torch.where(tomb[s:e][None, :], NEG_INF, c_sims)
        c_ids = torch.arange(s, e, dtype=torch.int32,
                             device=dev)[None, :].expand(q, e - s)
        ids, sims = merge_topk(torch.cat([ids, c_ids], dim=1),
                               torch.cat([sims, c_sims], dim=1), k)
    return ids, sims


def exact_knn(words: np.ndarray, card: np.ndarray, q_words: np.ndarray,
              q_card: np.ndarray, k: int, block: int = 256,
              tomb: np.ndarray | None = None, device="cuda"):
    """Brute-force query KNN (ground truth for recall), query-blocked.

    Host uint32 fingerprints in, host (ids int32[q, k], sims f32[q, k])
    out; the work runs on ``device``. ``tomb`` (bool[n] or None) drops
    tombstoned rows to −inf so the ground truth ranks survivors only.
    """
    dev = resolve_device(device)
    w = words_tensor(words, dev)
    c = torch.from_numpy(np.asarray(card, dtype=np.int32)).to(dev)
    t = (torch.zeros(w.shape[0], dtype=torch.bool, device=dev)
         if tomb is None else torch.from_numpy(np.asarray(tomb, bool)).to(dev))
    qw = words_tensor(q_words, dev)
    qc = torch.from_numpy(np.asarray(q_card, dtype=np.int32)).to(dev)
    q = qw.shape[0]
    ids_out = np.full((q, k), PAD_ID, dtype=np.int32)
    sims_out = np.full((q, k), NEG_INF, dtype=np.float32)
    for s in range(0, q, block):
        e = min(s + block, q)
        ids, sims = _exact_block(w, c, t, qw[s:e], qc[s:e], k)
        ids_out[s:e] = ids.cpu().numpy()
        sims_out[s:e] = sims.cpu().numpy()
    return ids_out, sims_out
