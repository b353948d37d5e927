"""Plain reference of C² query serving: the index over a reference build,
FastRandomHash routing of unseen profiles into the build's clusters, and
the beam descent over the KNN graph's forward and reverse edges.

What a served query must return, by the semantics the port guarantees
(its serving paths are bitwise equal under every batching and scorer):

* routing: the query's distinct item hashes per configuration, the same
  hash functions as the build; every cluster whose split path is a prefix
  of them, deepest first; from those, members in cluster order until
  ``seeds_per_config`` seeds per configuration; where no configuration
  places the query, ``seeds_per_config`` users evenly spaced over all ids;
* the initial beam: the ``beam`` best distinct seeds by GoldFinger
  similarity, ties to the earlier seed;
* a hop: each beam lane's forward neighbours (its graph row) and then its
  reverse neighbours, after the beam's own lanes, re-ranked to the
  ``beam`` best distinct ids, ties to the earlier lane;
* the answer: the first k of the beam after ``hops`` hops.

The reverse adjacency holds up to k in-neighbours a user, taken in the
order of one fixed permutation (seed 0) of all edges, the port's index
format. Popcounts use a byte table; the estimator's epilogue is
:func:`c2bench.reference.c2.epilogue` in ``dtype``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from c2bench.reference import c2

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def reverse_edges(ids: np.ndarray, r_max: int) -> np.ndarray:
    """int64[n, r_max]: in-neighbours of each user, in the order of the
    seed-0 permutation of the n·k edges, PAD padded."""
    n, k = ids.shape
    order = np.random.default_rng(0).permutation(n * k)
    dst = ids.reshape(-1)[order]
    src = (order // k).astype(np.int64)
    live = dst != c2.PAD
    dst, src = dst[live], src[live]
    by = np.argsort(dst, kind="stable")
    dst, src = dst[by], src[by]
    rank = np.arange(len(dst)) - np.searchsorted(dst, dst, side="left")
    keep = rank < r_max
    rev = np.full((n, r_max), c2.PAD, dtype=np.int64)
    rev[dst[keep], rank[keep]] = src[keep]
    return rev


@dataclasses.dataclass
class Index:
    ids: torch.Tensor        # int64[n, k] graph
    rev: torch.Tensor        # int64[n, k] reverse edges
    bytes_: torch.Tensor     # uint8[n, n_bits / 8] fingerprints
    card: torch.Tensor       # int64[n]
    lut: dict                # (config, path) -> members
    seeds: np.ndarray        # hash seeds
    c2: dict


def index(b: c2.Build, c2cfg: dict, device) -> Index:
    """The servable index of a reference build."""
    lut = {(int(cfg), tuple(path)): mem for mem, cfg, path
           in zip(b.plan.members, b.plan.config, b.plan.paths)}
    return Index(
        ids=torch.from_numpy(b.ids).to(device),
        rev=torch.from_numpy(reverse_edges(b.ids, b.ids.shape[1])).to(device),
        bytes_=torch.from_numpy(np.packbits(b.bits, axis=1)).to(device),
        card=torch.from_numpy(b.card).to(device),
        lut=lut, seeds=c2.hash_seeds(c2cfg), c2=c2cfg)


def route(ix: Index, items: np.ndarray, offsets: np.ndarray,
          per_config: int) -> np.ndarray:
    """Seed ids per query: int64[q, t · per_config], PAD padded."""
    cfg = ix.c2
    q, t = len(offsets) - 1, cfg["t"]
    cands = c2.distinct_hashes(c2.item_hashes(items, ix.seeds, cfg["b"]),
                               offsets, cfg["b"], cfg["split_depth"])
    out = np.full((q, t * per_config), c2.PAD, dtype=np.int64)
    n = ix.ids.shape[0]
    for qi in range(q):
        for i in range(t):
            found, path = [], ()
            for h in cands[i, qi]:
                if h == c2.NO_HASH:
                    break
                path += (int(h),)
                mem = ix.lut.get((i, path))
                if mem is not None:
                    found.append(mem)
            seeds = np.concatenate(found[::-1])[:per_config] if found else []
            out[qi, i * per_config:i * per_config + len(seeds)] = seeds
        if (out[qi] == c2.PAD).all():
            take = np.linspace(0, n - 1, num=min(per_config, n),
                               dtype=np.int64)
            out[qi, :len(take)] = take
    return out


def score(ix: Index, q_bytes: torch.Tensor, q_card: torch.Tensor,
          cand: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Similarity of each query to each candidate id, −inf on PAD lanes."""
    pad = cand == c2.PAD
    safe = torch.where(pad, 0, cand)
    pop = _POP8.to(cand.device)
    inter = pop[(ix.bytes_[safe] & q_bytes[:, None, :]).int()].sum(-1)
    sims = c2.epilogue(inter, q_card[:, None], ix.card[safe], dtype)
    return sims.masked_fill(pad, float("-inf"))


def descend(ix: Index, q_bytes, q_card, seeds: torch.Tensor, *, k: int,
            beam: int, hops: int, dtype=torch.float32):
    """Beam search from the routed seeds: (ids int64[q, k], sims f32[q, k])."""
    beam_ids, beam_sims = c2.topk_unique(
        seeds, score(ix, q_bytes, q_card, seeds, dtype), beam)
    q = beam_ids.shape[0]
    for _ in range(hops):
        dead = beam_ids == c2.PAD
        safe = torch.where(dead, 0, beam_ids)
        fwd = ix.ids[safe].masked_fill(dead[:, :, None], c2.PAD)
        rev = ix.rev[safe].masked_fill(dead[:, :, None], c2.PAD)
        cand = torch.cat([fwd.reshape(q, -1), rev.reshape(q, -1)], dim=1)
        beam_ids, beam_sims = c2.topk_unique(
            torch.cat([beam_ids, cand], dim=1),
            torch.cat([beam_sims, score(ix, q_bytes, q_card, cand, dtype)],
                      dim=1), beam)
    return beam_ids[:, :k], beam_sims[:, :k]


def answer(ix: Index, items: np.ndarray, offsets: np.ndarray, qcfg: dict,
           device, dtype=torch.float32, rows: int = 128):
    """The served answer of every query profile (CSR): (ids int64[q, k],
    sims float32[q, k])."""
    n_bits = ix.c2["n_bits"]
    bits, card = c2.fingerprints(items, offsets, n_bits, ix.c2["seed"])
    q_bytes = torch.from_numpy(np.packbits(bits, axis=1)).to(device)
    q_card = torch.from_numpy(card).to(device)
    seeds = torch.from_numpy(
        route(ix, items, offsets, qcfg["seeds_per_config"])).to(device)
    beam = max(qcfg["beam"], qcfg["k"])
    out_ids, out_sims = [], []
    for r0 in range(0, len(card), rows):
        i, s = descend(ix, q_bytes[r0:r0 + rows], q_card[r0:r0 + rows],
                       seeds[r0:r0 + rows], k=qcfg["k"], beam=beam,
                       hops=qcfg["hops"], dtype=dtype)
        out_ids.append(i.cpu())
        out_sims.append(s.cpu())
    return torch.cat(out_ids).numpy(), torch.cat(out_sims).numpy()
