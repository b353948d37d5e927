"""Step 2 of C²: per-cluster partial KNN graphs (paper Alg. 2).

Torch port of ``repro.core.local_knn``. Clusters of similar size are
batched into padded capacity groups (powers of two ≥ 32) and each batch is
one call of :func:`repro_torch.kernels.goldfinger_knn.ops.cluster_knn` —
the CUDA kernel on a GPU, its plain version on the CPU. Batches are
bounded by the reference's memory budget, so the same clusters land in the
same batches.

Alg. 2 switches clusters with |C| ≥ ρk² to Hyrec restricted to the cluster
(:func:`_hyrec_cluster`, ``knn/greedy.hyrec`` on ``device``, at most ρ
iterations). C²'s recursive split keeps the paper configurations' clusters
below ρk²; the unbounded buckets of LSH / MinHash plans (``knn/lsh``) reach
it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering import ClusterPlan
from repro_torch.core.params import C2Params
from repro_torch.device import resolve_device
from repro_torch.kernels.goldfinger_knn import ops as gk_ops
from repro_torch.knn.greedy import hyrec
from repro_torch.sketch.goldfinger import GoldFinger, words_tensor
from repro_torch.types import NEG_INF, PAD_ID

SIM_BUDGET = 256 << 20  # bytes: per-batch sims [m, cap, cap] f32 bound


def capacity_of(size: int, minimum: int = 32) -> int:
    c = minimum
    while c < size:
        c *= 2
    return c


def batch_groups(plan: ClusterPlan, W: int, greedy_from: int | None = None):
    """``(cap, batch)`` per kernel call, ``batch`` the cluster indices.

    Capacity groups ascend; within a group, batches of at most
    ``SIM_BUDGET // max(cap²·4, cap·W·16)`` clusters (the reference's
    budget on the sims tile and the gathered fingerprints). Clusters of
    ``greedy_from`` members or more (Alg. 2's ρk²) are left out: they take
    the Hyrec branch.
    """
    sizes = plan.sizes
    caps = np.array([capacity_of(int(s)) for s in sizes], dtype=np.int64)
    if greedy_from is not None:
        caps[sizes >= greedy_from] = -1
    out = []
    for cap in np.unique(caps[caps >= 0]):
        idx = np.flatnonzero(caps == cap)
        m_max = max(1, int(SIM_BUDGET // max(cap * cap * 4, cap * W * 4 * 4)))
        out += [(int(cap), idx[s:s + m_max])
                for s in range(0, len(idx), m_max)]
    return out


def member_matrix(plan: ClusterPlan, batch, cap: int) -> np.ndarray:
    """int32[len(batch), cap]: the members of each cluster of ``batch``,
    PAD_ID-padded."""
    mem = np.full((len(batch), cap), PAD_ID, dtype=np.int32)
    for j, ci in enumerate(batch):
        users = plan.members[ci]
        mem[j, : len(users)] = users
    return mem


def group_batches(plan: ClusterPlan, W: int, greedy_from: int | None = None):
    """Yield ``(cap, batch, members)`` per kernel call: the batches of
    :func:`batch_groups`, ``members`` their :func:`member_matrix`."""
    for cap, batch in batch_groups(plan, W, greedy_from):
        yield cap, batch, member_matrix(plan, batch, cap)


def batch_inputs(words: torch.Tensor, card: torch.Tensor,
                 members: np.ndarray):
    """Device inputs of one cluster batch: (words [m, cap, W] bit-views,
    card [m, cap], ids [m, cap]) gathered from the resident tables."""
    ids = torch.from_numpy(members).to(words.device)
    pad = ids == PAD_ID
    safe = torch.where(pad, 0, ids).long()
    return words[safe], torch.where(pad, 0, card[safe]), ids


def _hyrec_cluster(members: np.ndarray, gf: GoldFinger, k: int,
                   max_iters: int, device):
    """Alg. 2's greedy branch: Hyrec restricted to one (huge) cluster, its
    local ids mapped back to global ones and narrow lists padded to k."""
    sub = GoldFinger(words=np.asarray(gf.words)[members],
                     card=np.asarray(gf.card)[members])
    graph, _ = hyrec(sub, k=min(k, len(members) - 1), max_iters=max_iters,
                     device=device)
    nbr = np.where(graph.ids == PAD_ID, PAD_ID,
                   members[np.where(graph.ids == PAD_ID, 0, graph.ids)])
    sims = graph.sims
    if nbr.shape[1] < k:  # pad narrow neighborhoods up to k
        pad = k - nbr.shape[1]
        nbr = np.pad(nbr, ((0, 0), (0, pad)), constant_values=PAD_ID)
        sims = np.pad(sims, ((0, 0), (0, pad)), constant_values=NEG_INF)
    return nbr.astype(np.int32), sims.astype(np.float32)


def local_knn(plan: ClusterPlan, gf: GoldFinger, params: C2Params,
              device="cuda"):
    """Compute partial KNNs for every cluster; scatter per configuration.

    Implements Alg. 2's hybrid: clusters with |C| < ρk² go through the
    batched brute-force path (the cluster-KNN kernel); larger ones run
    Hyrec restricted to the cluster, for at most ρ iterations.

    Returns (ids int32[t, n, k], sims float32[t, n, k]) — for each hash
    configuration, each user's neighbors within its cluster (PAD_ID where
    the cluster was smaller than k+1 or the user was unclustered).
    """
    dev = resolve_device(device)
    t, n, k = plan.t, plan.n_users, params.k
    with obs.span("step2.alloc"):
        out_ids = np.full((t, n, k), PAD_ID, dtype=np.int32)
        out_sims = np.full((t, n, k), NEG_INF, dtype=np.float32)
    with obs.span("step2.hyrec"):
        for ci in np.flatnonzero(plan.sizes >= params.bf_threshold):
            users = plan.members[ci]
            nbr, sims = _hyrec_cluster(users, gf, k, params.rho, dev)
            out_ids[plan.config_of[ci], users] = nbr
            out_sims[plan.config_of[ci], users] = sims
    with obs.span("step2.upload"):
        words = words_tensor(gf.words, dev)
        card = torch.from_numpy(np.asarray(gf.card, dtype=np.int32)).to(dev)
        obs.count("step2.h2d_bytes", words.nbytes + card.nbytes)
    for cap, batch in batch_groups(plan, words.shape[1],
                                   params.bf_threshold):
        with obs.span("step2.pack"):
            members = member_matrix(plan, batch, cap)
            inputs = batch_inputs(words, card, members)
            obs.count("step2.h2d_bytes", members.nbytes)
        with obs.span("step2.wait"):
            nbr, sims = gk_ops.cluster_knn(*inputs, k)
            nbr, sims = nbr.cpu().numpy(), sims.cpu().numpy()
            obs.count("step2.d2h_bytes", nbr.nbytes + sims.nbytes)
        with obs.span("step2.scatter"):
            # Scatter back per configuration (each user appears in exactly
            # one cluster per configuration).
            for j, ci in enumerate(batch):
                cfg = plan.config_of[ci]
                users = plan.members[ci]
                out_ids[cfg, users] = nbr[j, : len(users)]
                out_sims[cfg, users] = sims[j, : len(users)]
    return out_ids, out_sims
