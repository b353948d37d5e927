"""Step 1 of C²: FastRandomHash clustering into t configurations (Alg. 1).

Numpy copy of ``repro.core.clustering``. Produces a :class:`ClusterPlan` —
a *static* description of every cluster (member lists, sizes, originating
hash configuration) that local KNN consumes. Hash values are computed
vectorized on the host; the recursive split is host-side bookkeeping.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core import hashing
from repro_torch.core.params import C2Params
from repro_torch.core.splitting import SplitResult, split_config
from repro_torch.types import Dataset


@dataclasses.dataclass
class ClusterPlan:
    """Static cluster plan: every cluster across all t configurations."""

    members: list[np.ndarray]    # user ids per cluster
    config_of: np.ndarray        # int32[n_clusters] — hash config index
    n_users: int
    t: int
    # Split path (η₁..η_d) per cluster, when retained by the builder.
    # The query router replays these paths to place an unseen profile in
    # its cluster per configuration (repro_torch/query/router.py).
    paths: list[tuple[int, ...]] | None = None

    @property
    def n_clusters(self) -> int:
        return len(self.members)

    @property
    def sizes(self) -> np.ndarray:
        return np.array([len(m) for m in self.members], dtype=np.int64)

    def brute_force_sims(self) -> int:
        """Σ |C|(|C|−1)/2 — the similarity budget of Step 2 (paper §II-F)."""
        s = self.sizes
        return int((s * (s - 1) // 2).sum())


def frh_seeds(params: C2Params) -> np.ndarray:
    """Per-configuration FastRandomHash seeds (shared with the query router)."""
    return np.arange(params.t, dtype=np.int32) + np.int32(params.seed * 1009)


def build_plan(ds: Dataset, params: C2Params) -> ClusterPlan:
    """Cluster all users under t FastRandomHash functions + recursive split."""
    with obs.span("clustering.hash"):
        seeds = frh_seeds(params)
        item_h = hashing.item_hashes(ds.items, seeds, params.b)  # [t, nnz]
        cands = hashing.user_distinct_hashes_np(item_h, ds.offsets,
                                                params.split_depth)
    with obs.span("clustering.split"):
        members: list[np.ndarray] = []
        config_of: list[int] = []
        paths: list[tuple[int, ...]] = []
        for i in range(params.t):
            res: SplitResult = split_config(cands[i], params.max_cluster)
            for mem, path in zip(res.members, res.paths):
                if len(mem) >= 2:  # singleton clusters yield no edges
                    members.append(mem)
                    config_of.append(i)
                    paths.append(path)
        return ClusterPlan(
            members=members,
            config_of=np.array(config_of, dtype=np.int32),
            n_users=ds.n_users,
            t=params.t,
            paths=paths,
        )
