"""Distributed C² Step 2: one LPT bin of clusters per device (torch port of
``repro.core.distributed``).

The paper's thread pool and synchronised priority queue become a static
LPT (longest-processing-time) bin-packing of clusters onto devices: the
same straggler protection (a cluster's cost is capped by N, the paper's
own knob) with no synchronisation at run time. Each device brute-forces
the clusters of its bin through the cluster-KNN kernel, with nothing
exchanged between devices: the paper's "computed independently, without
any synchronization". The reference runs the bins under ``shard_map``;
here one process walks a list of devices, one entry a bin, and every
launch is queued before any result is read back, so bins on different
cards run at once. The merge (Step 3) is the reduce phase on the first
device.

Serving shards (``query/sharded.py``) place clusters with the same
:func:`lpt_assign` and weigh the shards with :func:`lpt_loads`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering import ClusterPlan, build_plan
from repro_torch.core.local_knn import batch_inputs, capacity_of
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params
from repro_torch.device import resolve_devices
from repro_torch.kernels.goldfinger_knn import ops as gk_ops
from repro_torch.sketch.goldfinger import (GoldFinger, fingerprint_dataset,
                                           words_tensor)
from repro_torch.types import NEG_INF, PAD_ID


def lpt_assign(costs: np.ndarray, n_bins: int) -> np.ndarray:
    """Longest-processing-time assignment: returns bin id per item."""
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(n_bins, dtype=np.float64)
    assign = np.zeros(len(costs), dtype=np.int64)
    for i in order:
        b = int(np.argmin(loads))
        assign[i] = b
        loads[b] += costs[i]
    return assign


def lpt_loads(costs: np.ndarray, assign: np.ndarray,
              n_bins: int) -> np.ndarray:
    """Per-bin load of an assignment (shared by build + serving shards)."""
    loads = np.zeros(n_bins, dtype=np.float64)
    np.add.at(loads, assign, np.asarray(costs, dtype=np.float64))
    return loads


@dataclasses.dataclass
class DistPlan:
    """Static per-capacity-group member tensors: [n_dev, m_max, cap]."""

    groups: list[np.ndarray]
    caps: list[int]
    cluster_of: list[np.ndarray]  # (dev, slot) → cluster index (−1 pad)
    imbalance: float              # max/mean device load


def build_dist_plan(plan: ClusterPlan, n_dev: int) -> DistPlan:
    sizes = plan.sizes
    costs = sizes.astype(np.float64) ** 2  # brute force is O(|C|²)
    assign = lpt_assign(costs, n_dev)
    loads = lpt_loads(costs, assign, n_dev)
    imbalance = float(loads.max() / max(loads.mean(), 1e-9))

    caps_all = np.array([capacity_of(int(s)) for s in sizes])
    groups, caps, cluster_of = [], [], []
    for cap in np.unique(caps_all):
        idx = np.flatnonzero(caps_all == cap)
        m_max = max(int(np.max(np.bincount(assign[idx], minlength=n_dev))), 1)
        mem = np.full((n_dev, m_max, cap), PAD_ID, dtype=np.int32)
        cof = np.full((n_dev, m_max), -1, dtype=np.int64)
        slot = np.zeros(n_dev, dtype=np.int64)
        for ci in idx:
            d = assign[ci]
            s = slot[d]
            mem[d, s, : sizes[ci]] = plan.members[ci]
            cof[d, s] = ci
            slot[d] += 1
        groups.append(mem)
        caps.append(int(cap))
        cluster_of.append(cof)
    return DistPlan(groups=groups, caps=caps, cluster_of=cluster_of,
                    imbalance=imbalance)


def distributed_local_knn(plan: ClusterPlan, gf: GoldFinger,
                          params: C2Params, devices):
    """Step 2 over a device list: entry d brute-forces LPT bin d.

    Every cluster goes through the cluster-KNN kernel (its plain version on
    a CPU entry), one call per (bin, capacity group) on the bin's device,
    as the reference's mesh does: unlike :func:`~repro_torch.core.
    local_knn.local_knn`, clusters of ρk² users or more are brute-forced
    too, with no Hyrec branch. The fingerprint table is copied once to
    each distinct device; an entry may repeat a device.

    Returns (ids int32[t, n, k], sims float32[t, n, k], DistPlan).
    """
    devs = resolve_devices(devices)
    with obs.span("step2.pack"):
        dp = build_dist_plan(plan, len(devs))
    k = params.k
    card_h = np.asarray(gf.card, dtype=np.int32)
    tables = {}
    with obs.span("step2.upload"):
        for dev in devs:
            if dev not in tables:
                w = words_tensor(gf.words, dev)
                c = torch.from_numpy(card_h).to(dev)
                tables[dev] = (w, c)
                obs.count("step2.h2d_bytes", w.nbytes + c.nbytes)
    # Queue every bin's launches before reading any result back.
    with obs.span("step2.launch"):
        results = [[gk_ops.cluster_knn(*batch_inputs(*tables[dev], mem[d]), k)
                    for d, dev in enumerate(devs)] for mem in dp.groups]
        obs.count("step2.h2d_bytes", sum(mem.nbytes for mem in dp.groups))

    t, n = plan.t, plan.n_users
    with obs.span("step2.alloc"):
        out_ids = np.full((t, n, k), PAD_ID, dtype=np.int32)
        out_sims = np.full((t, n, k), NEG_INF, dtype=np.float32)
    for per_dev, cof in zip(results, dp.cluster_of):
        for d, (nbr, sims) in enumerate(per_dev):
            with obs.span("step2.wait"):
                nbr, sims = nbr.cpu().numpy(), sims.cpu().numpy()
                obs.count("step2.d2h_bytes", nbr.nbytes + sims.nbytes)
            with obs.span("step2.scatter"):
                # All-PAD slots are skipped.
                for s in np.flatnonzero(cof[d] >= 0):
                    ci = cof[d, s]
                    users = plan.members[ci]
                    cfg = plan.config_of[ci]
                    out_ids[cfg, users] = nbr[s, : len(users)]
                    out_sims[cfg, users] = sims[s, : len(users)]
    return out_ids, out_sims, dp


def distributed_c2(ds, params: C2Params, devices,
                   gf: GoldFinger | None = None):
    """Full distributed pipeline: the plan (its distinct-hash table on
    ``devices[0]``) → Step 2 per device → merge on ``devices[0]``. Returns
    (graph, stats) with the reference's keys."""
    devs = resolve_devices(devices)
    t0 = time.perf_counter()
    if gf is None:
        gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
    plan = build_plan(ds, params, device=devs[0])
    t1 = time.perf_counter()
    ids, sims, dp = distributed_local_knn(plan, gf, params, devs)
    t2 = time.perf_counter()
    graph = merge_partial(ids, sims, params.k, device=devs[0])
    t3 = time.perf_counter()
    stats = {
        "t_cluster": t1 - t0, "t_local": t2 - t1, "t_merge": t3 - t2,
        "n_clusters": plan.n_clusters,
        "n_sims": plan.brute_force_sims(),
        "lpt_imbalance": dp.imbalance,
        "n_devices": len(devs),
    }
    return graph, stats
