"""FRH routing: place unseen profiles into the build-time clusters.

Host numpy port of ``repro.query.router`` (same seeds, same order).

A query profile is hashed with the *same* ``fmix32`` min-hash machinery
(and the same per-configuration seeds) the build used, yielding its
ascending distinct-hash sequence per configuration — exactly the values
that drove recursive splitting (repro_torch/core/splitting.py). A cluster's identity
is its split path (η₁..η_d) = the shared distinct-hash *prefix* of its
members, so routing is a longest-prefix match of the query's sequence
against the index's path table. Seed candidates are gathered from the
deepest matching cluster first, then its ancestors ("stayers" remain in
parent clusters per §II-D), up to a per-configuration cap.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import hashing
from repro_torch.query.index import KNNIndex
from repro_torch.sketch.goldfinger import GoldFinger, fingerprint_dataset
from repro_torch.types import PAD_ID, Dataset


def profiles_to_csr(profiles) -> tuple[np.ndarray, np.ndarray]:
    """List of item-id iterables → (items int32[nnz], offsets int64[q+1])."""
    rows = [np.unique(np.asarray(list(p), dtype=np.int32)) for p in profiles]
    sizes = np.array([len(r) for r in rows], dtype=np.int64)
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    items = (np.concatenate(rows) if rows
             else np.zeros((0,), np.int32)).astype(np.int32)
    return items, offsets


def fingerprint_profiles(items: np.ndarray, offsets: np.ndarray,
                         n_bits: int, seed: int) -> GoldFinger:
    """GoldFinger fingerprints for query profiles (same hash as the build)."""
    n_items = int(items.max()) + 1 if len(items) else 1
    ds = Dataset(name="queries", n_users=len(offsets) - 1, n_items=n_items,
                 items=items, offsets=offsets)
    return fingerprint_dataset(ds, n_bits=n_bits, seed=seed)


def routed_queries(index: KNNIndex, profiles,
                   seeds_per_config: int = 16):
    """Marshal raw profiles into a routed wave.

    Returns host arrays (q_words uint32[q, W], q_card int32[q],
    seeds int32[q, t·seeds_per_config]) — the unpadded inputs
    ``descent_init``/``descent_step`` take. The engine layers its own
    capacity padding on top; benchmarks drive the descent with these
    directly.
    """
    items, offsets = profiles_to_csr(profiles)
    qgf = fingerprint_profiles(items, offsets, index.n_bits, index.fp_seed)
    seeds = route(index, items, offsets, seeds_per_config)
    return np.asarray(qgf.words), np.asarray(qgf.card), seeds


def query_hash_tables(index: KNNIndex, items: np.ndarray,
                      offsets: np.ndarray) -> np.ndarray:
    """Ascending distinct FRH values per (config, query): int32[t, q, depth]."""
    item_h = hashing.item_hashes(items, index.hash_seeds, index.b)
    return hashing.user_distinct_hashes_np(item_h, offsets, index.split_depth)


def _matches_for(lut: dict, cfg: int, cands_row: np.ndarray) -> list[int]:
    """Cluster indices matching a query's hash prefix, deepest-first."""
    found: list[int] = []
    path: tuple[int, ...] = ()
    for h in cands_row:
        if h == hashing.NO_HASH:
            break
        path = path + (int(h),)
        ci = lut.get((cfg, path))
        if ci is not None:
            found.append(ci)
    found.reverse()
    return found


def placements(index: KNNIndex, items: np.ndarray,
               offsets: np.ndarray) -> list[list[list[int]]]:
    """Per query, per config: matched cluster indices (deepest-first)."""
    cands = query_hash_tables(index, items, offsets)  # [t, q, depth]
    lut = index.path_lut()
    q = len(offsets) - 1
    return [[_matches_for(lut, cfg, cands[cfg, qi])
             for cfg in range(index.t)] for qi in range(q)]


def route(index: KNNIndex, items: np.ndarray, offsets: np.ndarray,
          seeds_per_config: int = 16,
          placed: list[list[list[int]]] | None = None) -> np.ndarray:
    """Seed candidate ids per query: int32[q, t · seeds_per_config].

    Unmatched (config, query) slots are PAD_ID-padded; a query that no
    configuration can place (all its item hashes unseen at depth 1)
    falls back to an id-strided sample of the indexed users so descent
    always has a non-empty frontier. Pass ``placed`` (from
    :func:`placements`) to reuse already-computed hash placements.

    Tombstoned users never seed: dead members are filtered out of every
    candidate list, and the routing-miss fallback samples live rows only.
    """
    cap = seeds_per_config
    q = len(offsets) - 1
    tomb = index.tombstone
    out = np.full((q, index.t * cap), PAD_ID, dtype=np.int32)
    if placed is None:
        placed = placements(index, items, offsets)
    alive = None
    for qi, per_cfg in enumerate(placed):
        for cfg, matched in enumerate(per_cfg):
            col = cfg * cap
            room = cap
            for ci in matched:
                if room <= 0:
                    break
                mem = index.cluster_users(ci)
                mem = mem[~tomb[mem]][:room]
                out[qi, col:col + len(mem)] = mem
                col += len(mem)
                room -= len(mem)
        if (out[qi] == PAD_ID).all():  # total routing miss
            if alive is None:
                alive = index.alive_ids()
            take = np.linspace(0, len(alive) - 1,
                               num=min(cap, len(alive)), dtype=np.int64)
            fill = alive[take].astype(np.int32)
            out[qi, : len(fill)] = fill
    return out
