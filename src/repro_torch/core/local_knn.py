"""Step 2 of C²: per-cluster partial KNN graphs (paper Alg. 2).

Torch port of ``repro.core.local_knn``. Clusters of similar size are
batched into padded capacity groups (powers of two ≥ 32) and each batch is
one call of :func:`repro_torch.kernels.goldfinger_knn.ops.cluster_knn` —
the CUDA kernel on a GPU, its plain version on the CPU. Batches are
bounded by the reference's memory budget, so the same clusters land in the
same batches.

The paper switches clusters with |C| ≥ ρk² to Hyrec. Hyrec is not ported
yet (ROADMAP queue 1 item 2), so such a cluster raises
NotImplementedError; the paper configurations never reach it (the
recursive split keeps clusters far below ρk² = 4500 at k = 30).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import ClusterPlan
from repro_torch.core.params import C2Params
from repro_torch.device import resolve_device
from repro_torch.kernels.goldfinger_knn import ops as gk_ops
from repro_torch.sketch.goldfinger import GoldFinger, words_tensor
from repro_torch.types import NEG_INF, PAD_ID

SIM_BUDGET = 256 << 20  # bytes: per-batch sims [m, cap, cap] f32 bound


def capacity_of(size: int, minimum: int = 32) -> int:
    c = minimum
    while c < size:
        c *= 2
    return c


def group_batches(plan: ClusterPlan, W: int):
    """Yield ``(cap, batch, members)`` per kernel call: ``batch`` the
    cluster indices, ``members`` int32[len(batch), cap] PAD_ID-padded.

    Capacity groups ascend; within a group, batches of at most
    ``SIM_BUDGET // max(cap²·4, cap·W·16)`` clusters (the reference's
    budget on the sims tile and the gathered fingerprints).
    """
    sizes = plan.sizes
    caps = np.array([capacity_of(int(s)) for s in sizes], dtype=np.int64)
    for cap in np.unique(caps):
        idx = np.flatnonzero(caps == cap)
        m_max = max(1, int(SIM_BUDGET // max(cap * cap * 4, cap * W * 4 * 4)))
        for s in range(0, len(idx), m_max):
            batch = idx[s:s + m_max]
            mem = np.full((len(batch), cap), PAD_ID, dtype=np.int32)
            for j, ci in enumerate(batch):
                mem[j, : sizes[ci]] = plan.members[ci]
            yield int(cap), batch, mem


def batch_inputs(words: torch.Tensor, card: torch.Tensor,
                 members: np.ndarray):
    """Device inputs of one cluster batch: (words [m, cap, W] bit-views,
    card [m, cap], ids [m, cap]) gathered from the resident tables."""
    ids = torch.from_numpy(members).to(words.device)
    pad = ids == PAD_ID
    safe = torch.where(pad, 0, ids).long()
    return words[safe], torch.where(pad, 0, card[safe]), ids


def local_knn(plan: ClusterPlan, gf: GoldFinger, params: C2Params,
              device="cuda"):
    """Compute partial KNNs for every cluster; scatter per configuration.

    Returns (ids int32[t, n, k], sims float32[t, n, k]) — for each hash
    configuration, each user's neighbors within its cluster (PAD_ID where
    the cluster was smaller than k+1 or the user was unclustered).
    """
    dev = resolve_device(device)
    t, n, k = plan.t, plan.n_users, params.k
    sizes = plan.sizes
    big = np.flatnonzero(sizes >= params.bf_threshold)
    if len(big):
        raise NotImplementedError(
            f"{len(big)} cluster(s) of size >= rho*k^2 = {params.bf_threshold} "
            f"(largest {int(sizes[big].max())}) need the Hyrec branch of "
            f"Alg. 2, which is not ported yet (ROADMAP queue 1 item 2)")
    out_ids = np.full((t, n, k), PAD_ID, dtype=np.int32)
    out_sims = np.full((t, n, k), NEG_INF, dtype=np.float32)
    words = words_tensor(gf.words, dev)
    card = torch.from_numpy(np.asarray(gf.card, dtype=np.int32)).to(dev)
    for _, batch, members in group_batches(plan, words.shape[1]):
        nbr, sims = gk_ops.cluster_knn(*batch_inputs(words, card, members), k)
        nbr, sims = nbr.cpu().numpy(), sims.cpu().numpy()
        # Scatter back per configuration (each user appears in exactly
        # one cluster per configuration).
        for j, ci in enumerate(batch):
            cfg = plan.config_of[ci]
            users = plan.members[ci]
            out_ids[cfg, users] = nbr[j, : len(users)]
            out_sims[cfg, users] = sims[j, : len(users)]
    return out_ids, out_sims
