"""LSH/MinHash baseline (paper §IV-B3), torch port of ``repro.knn.lsh``.

Each of t hash functions is a min-wise permutation of the item universe
(a random hash over item ids, the standard MinHash approximation); a
user's signature is the minimum hashed value over her profile, and each
function's buckets are formed by signature value — "each hash function
creates its own buckets", as the paper implements LSH for fairness.
Neighbors are then searched within buckets and merged through C²'s own
Step 2 (``core/local_knn``: the cluster-KNN kernel, and Hyrec for buckets
of ρk² users or more, which unbounded buckets reach) and Step 3.

The hash space is the item universe, b = max(|I|, 2), which is not a power
of two: the host reduces with ``% b`` where the FastRandomHash kernel
masks with ``& (b − 1)``. So signatures stay on the host hashing path
(``core/hashing``), never on that kernel.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.clustering import ClusterPlan
from repro_torch.core.local_knn import local_knn
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params
from repro_torch.device import resolve_device
from repro_torch.sketch.goldfinger import GoldFinger
from repro_torch.types import Dataset


def lsh_plan(ds: Dataset, t: int, seed: int = 0) -> ClusterPlan:
    """Bucket users by MinHash signature under t permutations."""
    seeds = np.arange(t, dtype=np.int32) + np.int32(seed * 7919 + 13)
    # Hash space = the item universe (MinHash permutation image).
    item_h = hashing.item_hashes(ds.items, seeds, max(ds.n_items, 2))
    sig = hashing.user_min_hash_np(item_h, ds.offsets)  # [t, n]
    members: list[np.ndarray] = []
    config_of: list[int] = []
    for i in range(t):
        s = sig[i]
        valid = s != hashing.NO_HASH
        users = np.arange(ds.n_users, dtype=np.int64)[valid]
        order = np.argsort(s[valid], kind="stable")
        su, sh = users[order], s[valid][order]
        bounds = np.flatnonzero(np.diff(sh, prepend=-1) != 0)
        for b0, b1 in zip(bounds, np.append(bounds[1:], len(su))):
            if b1 - b0 >= 2:
                members.append(su[b0:b1])
                config_of.append(i)
    return ClusterPlan(members=members,
                       config_of=np.array(config_of, dtype=np.int32),
                       n_users=ds.n_users, t=t)


def lsh_knn(ds: Dataset, gf: GoldFinger, k: int, t: int = 10, seed: int = 0,
            *, device="cuda"):
    """LSH KNN graph: buckets, per-bucket KNN and the merge on ``device``.
    Returns (graph, stats) with the reference's stats keys."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    plan = lsh_plan(ds, t, seed)
    ids, sims = local_knn(plan, gf, C2Params(k=k, t=t), device=dev)
    graph = merge_partial(ids, sims, k, device=dev)
    elapsed = time.perf_counter() - t0
    return graph, {
        "t_total": elapsed,
        "n_buckets": plan.n_clusters,
        "n_sims": plan.brute_force_sims(),
        "max_bucket": int(plan.sizes.max()) if plan.n_clusters else 0,
    }
