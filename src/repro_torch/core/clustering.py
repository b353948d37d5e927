"""Step 1 of C²: FastRandomHash clustering into t configurations (Alg. 1).

Copy of ``repro.core.clustering``. Produces a :class:`ClusterPlan` — a
*static* description of every cluster (member lists, sizes, originating
hash configuration) that local KNN consumes. The users' distinct-hash
table comes from the FastRandomHash kernel's distinct entry when
:func:`build_plan` is given a CUDA device and the parameters fit the
kernel (``b`` a power of two, ``t`` and ``split_depth`` within its
bounds); otherwise it is computed vectorized on the host, as the
reference does. The two are bitwise equal. The recursive split is
host-side bookkeeping.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hashing
from repro_torch.core.params import C2Params
from repro_torch.core.splitting import SplitResult, split_config
from repro_torch.device import resolve_device
from repro_torch.kernels.frh_minhash import ops as frh_ops
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


def _fits_kernel(params: C2Params) -> bool:
    """The distinct entry computes this table: ``b`` a power of two (the
    kernel masks where the host takes the modulo), ``t`` and the depth
    within its compile-time bounds."""
    b = params.b
    return (1 <= b <= 2**31 and b & (b - 1) == 0
            and 1 <= params.t <= frh_ops.MAX_SEEDS
            and 1 <= params.split_depth <= frh_ops.MAX_DEPTH)


def _device_cands(ds: Dataset, seeds: np.ndarray, params: C2Params,
                  dev: torch.device) -> np.ndarray:
    """The distinct-hash table int32[t, n, depth] from the kernel: the CSR
    arrays up, one launch, the table back (its read-back synchronises)."""
    offsets = np.asarray(ds.offsets, np.int64)
    items = np.asarray(ds.items, np.int32)
    out = frh_ops.distinct_csr(torch.from_numpy(offsets).to(dev),
                               torch.from_numpy(items).to(dev), seeds,
                               params.b, params.split_depth).cpu().numpy()
    obs.count("clustering.h2d_bytes", offsets.nbytes + items.nbytes)
    obs.count("clustering.d2h_bytes", out.nbytes)
    obs.count("clustering.device_calls", 1)
    return out


def build_plan(ds: Dataset, params: C2Params, device=None) -> ClusterPlan:
    """Cluster all users under t FastRandomHash functions + recursive split.

    With a CUDA ``device`` and parameters that fit the kernel, the users'
    distinct hashes come from the FastRandomHash kernel on that device;
    otherwise (``None``, ``"cpu"``, or e.g. a ``b`` that is not a power of
    two) from the host, as the reference computes them. Either way the
    table, and so the plan, is the same.
    """
    dev = None if device is None else resolve_device(device)
    with obs.span("clustering.hash"):
        seeds = frh_seeds(params)
        if dev is not None and dev.type == "cuda" and _fits_kernel(params):
            cands = _device_cands(ds, seeds, params, dev)
        else:
            item_h = hashing.item_hashes(ds.items, seeds, params.b)
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
