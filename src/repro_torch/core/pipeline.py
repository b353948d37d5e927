"""Cluster-and-Conquer end-to-end pipeline (paper §II-C), torch port of
``repro.core.pipeline``.

Step 1 cluster (FastRandomHash's distinct-hash table, from the
FastRandomHash kernel on a card; the recursive split on the host) → Step 2
per-cluster partial KNNs (cluster-KNN kernel) → Step 3 merge. Returns the
approximate KNN graph plus a stats record.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.clustering import ClusterPlan, build_plan
from repro_torch.core.local_knn import local_knn
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params
from repro_torch.device import resolve_device
from repro_torch.sketch.goldfinger import GoldFinger, fingerprint_dataset
from repro_torch.types import Dataset, KNNGraph


@dataclasses.dataclass
class C2Stats:
    t_cluster: float
    t_local: float
    t_merge: float
    n_clusters: int
    n_sims: int            # Σ |C|(|C|−1)/2 — Step 2 similarity budget
    max_cluster: int
    cluster_sizes: np.ndarray

    @property
    def total(self) -> float:
        return self.t_cluster + self.t_local + self.t_merge


def cluster_and_conquer(
    ds: Dataset,
    params: C2Params | None = None,
    gf: GoldFinger | None = None,
    device="cuda",
) -> tuple[KNNGraph, C2Stats]:
    params = params or C2Params()
    dev = resolve_device(device)

    t0 = time.perf_counter()
    if gf is None:
        gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
    plan: ClusterPlan = build_plan(ds, params, device=dev)
    t1 = time.perf_counter()

    ids, sims = local_knn(plan, gf, params, device=dev)  # host arrays
    t2 = time.perf_counter()

    graph = merge_partial(ids, sims, params.k, device=dev)
    t3 = time.perf_counter()

    sizes = plan.sizes
    stats = C2Stats(
        t_cluster=t1 - t0,
        t_local=t2 - t1,
        t_merge=t3 - t2,
        n_clusters=plan.n_clusters,
        n_sims=plan.brute_force_sims(),
        max_cluster=int(sizes.max()) if len(sizes) else 0,
        cluster_sizes=sizes,
    )
    return graph, stats
