"""FastRandomHash (paper §II-D): the host numpy functions of
``repro.core.hashing`` and its device segment-min in torch.

A *generative* hash function h_i maps item ids onto the bounded interval
[0, b). The FastRandomHash of a user is the minimum hash over her profile::

    H_i(u) = min_{item ∈ P_u} h_i(item)                      (paper Eq. 3)

h is the murmur3 ``fmix32`` finalizer over uint32 (wrapping arithmetic).
Splitting support: ``H\\η(u) = min_{item ∈ P_u, h(item) > η} h(item)`` is
what recursive splitting (§II-D) evaluates; per-user *sorted distinct hash
values* let the split planner walk down each user's candidate sequence
without rehashing.
"""
from __future__ import annotations

import numpy as np
import torch

NO_HASH = np.int32(2**31 - 1)  # "H undefined" sentinel (empty masked min)


def fmix32(x: np.ndarray) -> np.ndarray:
    """Murmur3 finalizer on a numpy uint32 array (wrapping)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EB_CA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2_AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def item_hashes(items: np.ndarray, seeds, b: int) -> np.ndarray:
    """h_i(item) for every (hash function i, item): int32[t, nnz] in [0, b).

    ``items``: int32[nnz]; ``seeds``: int32[t].
    """
    items_u = items.astype(np.uint32)
    seeds_u = np.asarray(seeds).astype(np.uint32)
    # Distinct stream per hash function: mix(item ⊕ golden·(seed+1)).
    x = items_u[None, :] ^ ((seeds_u[:, None] + np.uint32(1))
                            * np.uint32(0x9E37_79B9))
    return (fmix32(x) % np.uint32(b)).astype(np.int32)


def user_min_hash_np(item_h: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """H_i(u) per (function, user): int32[t, n]. Host CSR segment-min."""
    t, _ = item_h.shape
    n = len(offsets) - 1
    out = np.full((t, n), NO_HASH, dtype=np.int32)
    nonempty = np.diff(offsets) > 0
    starts = offsets[:-1][nonempty]
    for i in range(t):
        mins = np.minimum.reduceat(item_h[i], starts)
        out[i, nonempty] = mins
    return out


def user_min_hash_torch(item_h: torch.Tensor, user_of: torch.Tensor,
                        n_users: int) -> torch.Tensor:
    """Device segment-min: item_h int32[t, nnz], user_of int[nnz] →
    int32[t, n_users], NO_HASH for a user with no items (the counterpart
    of ``repro.core.hashing.user_min_hash_jnp``)."""
    t = item_h.shape[0]
    out = torch.full((t, n_users), int(NO_HASH), dtype=torch.int32,
                     device=item_h.device)
    index = user_of.to(torch.int64)[None, :].expand(t, -1)
    return out.scatter_reduce(1, index, item_h.to(torch.int32), "amin")


def user_hash_above_np(item_h_row: np.ndarray, offsets: np.ndarray,
                       eta: int, user_ids: np.ndarray) -> np.ndarray:
    """H\\η for a subset of users under one hash function (host).

    Returns int32[len(user_ids)]; NO_HASH where no item hash exceeds η
    (the "single item" case of §II-D — those users remain in the cluster).
    """
    out = np.full(len(user_ids), NO_HASH, dtype=np.int32)
    for j, u in enumerate(user_ids):
        h = item_h_row[offsets[u]:offsets[u + 1]]
        h = h[h > eta]
        if len(h):
            out[j] = h.min()
    return out


def user_distinct_hashes_np(item_h: np.ndarray, offsets: np.ndarray,
                            depth: int) -> np.ndarray:
    """Per (function, user): the ``depth`` smallest *distinct* hash values,
    ascending, padded with NO_HASH — int32[t, n, depth].

    Recursive splitting only ever moves a user to its next distinct hash
    value above the current cluster index, so this table fully determines
    every split decision. ``depth`` passes of masked ``minimum.reduceat``:
    O(depth·nnz) with no sort.
    """
    t, _ = item_h.shape
    n = len(offsets) - 1
    out = np.full((t, n, depth), NO_HASH, dtype=np.int32)
    sizes = np.diff(offsets)
    nonempty = sizes > 0
    starts = offsets[:-1][nonempty]
    user_of = np.repeat(np.arange(n, dtype=np.int64), sizes)
    for i in range(t):
        h = item_h[i].copy()
        for d in range(depth):
            mins = np.minimum.reduceat(h, starts)
            out[i, nonempty, d] = mins
            if d + 1 == depth:
                break
            # Mask out the level-d minimum everywhere it occurs, so the
            # next pass yields the next *distinct* value.
            cur = out[i][user_of, d]
            h[h == cur] = NO_HASH
            if (out[i, nonempty, d] == NO_HASH).all():
                break
    return out
