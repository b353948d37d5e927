"""Plain PyTorch version of the descent-hop kernels (``csrc/descent_hop.cu``,
``csrc/descent_hop_dma.cu``).

The unfused hop of ``repro.kernels.descent_score.ref``: gather forward +
reverse neighbors of the beam, score every candidate lane, let
:func:`~repro_torch.knn.topk.merge_topk` mask duplicates/PADs and rank.
The kernel must match it bit for bit (ids and sims). :func:`scored_lanes`
is the kernels' third output, the count of lanes that survive the
pre-scoring suppression, and :func:`dma_counts` the DMA hop's byte
counters. :func:`descent_hop_sharded_ref` is the sharded placement's hop,
shard by shard. Serving runs this hop under scorer ``"jnp"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scoring import score_lanes
from repro_torch.knn.topk import merge_topk
from repro_torch.types import NEG_INF, PAD_ID


def mask_dead(tomb, ids, sims=None):
    """PAD out lanes naming tombstoned rows (``tomb`` bool[n]) in place,
    positionally; with ``sims`` those lanes also drop to −inf."""
    safe = torch.where(ids == PAD_ID, 0, ids).long()
    dead = (ids != PAD_ID) & tomb[safe]
    out_ids = torch.where(dead, PAD_ID, ids)
    if sims is None:
        return out_ids
    return out_ids, torch.where(dead, NEG_INF, sims)


def gather_candidates(graph_ids, rev_ids, beam_ids, tomb=None):
    """int32[q, B·(kg+kr)]: forward then reverse neighbors of every beam
    lane, PAD under PAD beam lanes, tombstoned ids PAD. ``beam_ids`` must
    already have its dead lanes masked."""
    nq, B = beam_ids.shape
    kg, kr = graph_ids.shape[1], rev_ids.shape[1]
    dead = beam_ids == PAD_ID
    safe = torch.where(dead, 0, beam_ids).long()
    fwd = graph_ids[safe].reshape(nq, B * kg)
    fwd = torch.where(dead.repeat_interleave(kg, dim=1), PAD_ID, fwd)
    rev = rev_ids[safe].reshape(nq, B * kr)
    rev = torch.where(dead.repeat_interleave(kr, dim=1), PAD_ID, rev)
    cand = torch.cat([fwd, rev], dim=1)
    if tomb is not None:
        cand = mask_dead(tomb, cand)
    return cand


def descent_hop_ref(graph_ids, rev_ids, words, card, q_words, q_card,
                    beam_ids, beam_sims, tomb=None):
    """One friend-of-a-friend hop, unfused. Returns (beam_ids, beam_sims).

    Tables: graph_ids int32[n, kg], rev_ids int32[n, kr], words int32[n, W]
    bit-views, card int32[n], tomb bool[n] or None. Queries: q_words
    int32[q, W], q_card int32[q], beam_ids int32[q, B], beam_sims f32[q, B].
    """
    if tomb is not None:
        beam_ids, beam_sims = mask_dead(tomb, beam_ids, beam_sims)
    cand = gather_candidates(graph_ids, rev_ids, beam_ids, tomb)
    cand_sims = score_lanes(words, card, q_words, q_card, cand)
    return merge_topk(torch.cat([beam_ids, cand], dim=1),
                      torch.cat([beam_sims, cand_sims], dim=1),
                      beam_ids.shape[1])


def survivors(cand, beam_ids):
    """bool[q, C]: lanes the kernel scores — not PAD, not in the beam.
    Membership by a search of each sorted beam row, so a wide beam costs
    q·C·log B, not a [q, C, B] comparison."""
    if beam_ids.shape[1] == 0:
        return cand != PAD_ID
    beam = torch.sort(beam_ids, dim=1).values.contiguous()
    at = torch.searchsorted(beam, cand.contiguous())
    at = at.clamp(max=beam.shape[1] - 1)
    in_beam = torch.gather(beam, 1, at) == cand
    return (cand != PAD_ID) & ~in_beam


def scored_lanes(graph_ids, rev_ids, beam_ids, tomb=None):
    """int32[q]: candidate lanes surviving PAD / tombstone / in-beam
    suppression — the kernel's ``n_scored``."""
    if tomb is not None:
        beam_ids = mask_dead(tomb, beam_ids)
    cand = gather_candidates(graph_ids, rev_ids, beam_ids, tomb)
    return survivors(cand, beam_ids).sum(dim=1, dtype=torch.int32)


def dma_counts(n_scored, W: int, C: int):
    """The DMA hop's byte counters from its scored lanes: (dma_bytes,
    bytes_saved) int32[q] — fingerprint bytes of the C = B·(kg+kr)
    candidate lanes gathered (one W-word row per scored lane) and left
    unread."""
    return n_scored * (W * 4), (C - n_scored) * (W * 4)


def descent_hop_sharded_ref(graph_ids, rev_ids, words, card, q_words, q_card,
                            beam_ids, beam_sims, tomb=None):
    """The sharded placement's hop: :func:`descent_hop_ref` and
    :func:`scored_lanes` of each shard, stacked. Tables [S, cap, ·] (tomb
    bool[S, cap] or None), beams [S, q, B] in each shard's own row ids,
    q_words / q_card shared. Returns (ids int32[S, q, B], sims f32[S, q,
    B], n_scored int32[S, q]) — the contract of both kernels' shard grid
    axis."""
    ids, sims, scored = [], [], []
    for s in range(graph_ids.shape[0]):
        t = None if tomb is None else tomb[s]
        i, m = descent_hop_ref(graph_ids[s], rev_ids[s], words[s], card[s],
                               q_words, q_card, beam_ids[s], beam_sims[s],
                               tomb=t)
        ids.append(i)
        sims.append(m)
        scored.append(scored_lanes(graph_ids[s], rev_ids[s], beam_ids[s],
                                   tomb=t))
    return torch.stack(ids), torch.stack(sims), torch.stack(scored)
