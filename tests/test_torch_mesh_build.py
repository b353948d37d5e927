"""The port's distributed Step 2 (one LPT bin per device) held bitwise
against the JAX reference's mesh path.

``build_dist_plan`` at 1, 3, 4 and 8 devices on synth@0.1's plan;
``distributed_local_knn`` and ``distributed_c2`` over ``["cpu"] * 4``
against the reference on a one-device mesh (its graph does not depend on
the mesh's size: every cluster's result is its own), including a plan
whose clusters reach ρk², which the reference's mesh brute-forces where
its ``local_knn`` takes Hyrec; ``knn_build.build(devices=)`` against
``build(mesh=)``. Every comparison is exact.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distributed as r_dist  # noqa: E402
from repro.core.clustering import ClusterPlan as RPlan  # noqa: E402
from repro.core.clustering import build_plan as r_build_plan  # noqa: E402
from repro.core.local_knn import local_knn as r_local_knn  # noqa: E402
from repro.core.params import C2Params as RParams  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.launch import knn_build as r_knn_build  # noqa: E402
from repro.sketch.goldfinger import GoldFinger as RGF  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core.clustering import ClusterPlan, build_plan  # noqa: E402
from repro_torch.core.params import C2Params  # noqa: E402
from repro_torch.core.pipeline import cluster_and_conquer  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_build  # noqa: E402
from repro_torch.sketch.goldfinger import fingerprint_dataset  # noqa: E402

PARAMS = dict(k=10, b=64, t=8, max_cluster=48)
CPUS = ["cpu"] * 4


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1,), ("data",))


@pytest.fixture(scope="module")
def synth():
    """synth@0.1, its 1,024-bit GoldFinger and both packages' cluster
    plans (equal: test_torch_build.py)."""
    ds = make_dataset("synth", scale=0.1, seed=3)
    r_ds = r_make_dataset("synth", scale=0.1, seed=3)
    gf = fingerprint_dataset(ds)
    return (ds, r_ds, gf, build_plan(ds, C2Params(**PARAMS)),
            r_build_plan(r_ds, RParams(**PARAMS)))


def _rgf(gf):
    return RGF(words=gf.words, card=gf.card)


@pytest.mark.parametrize("n_dev", [1, 3, 4, 8])
def test_dist_plan_matches_reference(synth, n_dev):
    plan, r_plan = synth[3], synth[4]
    dp, r_dp = dist.build_dist_plan(plan, n_dev), \
        r_dist.build_dist_plan(r_plan, n_dev)
    assert dp.caps == r_dp.caps and dp.imbalance == r_dp.imbalance
    for a, b, c, d in zip(dp.groups, r_dp.groups, dp.cluster_of,
                          r_dp.cluster_of):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(c, d)
    # Every cluster has exactly one (device, slot); the rest are PAD.
    placed = np.concatenate([c[c >= 0] for c in dp.cluster_of])
    assert np.array_equal(np.sort(placed), np.arange(plan.n_clusters))


def test_distributed_local_knn_matches_reference(synth, mesh):
    _, _, gf, plan, r_plan = synth
    ids, sims, dp = dist.distributed_local_knn(plan, gf, C2Params(**PARAMS),
                                               CPUS)
    r_ids, r_sims, _ = r_dist.distributed_local_knn(
        r_plan, _rgf(gf), RParams(**PARAMS), mesh)
    assert np.array_equal(ids, r_ids) and np.array_equal(sims, r_sims)
    assert (dp.cluster_of[0] == -1).any() or len(dp.groups) > 1


def test_distributed_c2_matches_reference_and_single_device(synth, mesh):
    ds, r_ds, gf, _, _ = synth
    g, st = dist.distributed_c2(ds, C2Params(**PARAMS), CPUS, gf=gf)
    r_g, r_st = r_dist.distributed_c2(r_ds, RParams(**PARAMS), mesh,
                                      gf=_rgf(gf))
    assert np.array_equal(g.ids, r_g.ids) and np.array_equal(g.sims, r_g.sims)
    assert set(st) == set(r_st)
    # The reference ran one bin; its imbalance over 4 is build_dist_plan's.
    assert (st["n_clusters"], st["n_sims"]) == (r_st["n_clusters"],
                                                r_st["n_sims"])
    assert st["lpt_imbalance"] == r_dist.build_dist_plan(
        r_build_plan(r_ds, RParams(**PARAMS)), 4).imbalance
    assert st["n_devices"] == 4
    # The paper's configurations stay below ρk²: the single-device
    # pipeline gives the same graph.
    single, _ = cluster_and_conquer(ds, C2Params(**PARAMS), gf=gf,
                                    device="cpu")
    assert np.array_equal(g.ids, single.ids)
    assert np.array_equal(g.sims, single.sims)


def _plan_pair(sizes, n_users, seed):
    rng = np.random.default_rng(seed)
    users = rng.permutation(n_users)
    members, at = [], 0
    for s in sizes:
        members.append(np.sort(users[at:at + s]).astype(np.int64))
        at += s
    config_of = (np.arange(len(sizes)) // 2).astype(np.int32)
    t = int(config_of.max()) + 1
    return (ClusterPlan(members=members, config_of=config_of,
                        n_users=n_users, t=t),
            RPlan(members=members, config_of=config_of, n_users=n_users,
                  t=t))


def test_clusters_above_rho_k2_follow_the_reference_mesh(synth, mesh):
    """ρk² = 25 at k = 5, ρ = 1: the 40- and 25-member clusters are
    brute-forced on the mesh (the reference's distributed output), not
    sent to Hyrec as ``local_knn`` sends them."""
    gf = synth[2]
    sizes = (40, 25, 24, 9, 3, 2)
    plan, r_plan = _plan_pair(sizes, gf.n, seed=6)
    params, r_params = C2Params(k=5, rho=1), RParams(k=5, rho=1)
    assert sum(s >= params.bf_threshold for s in sizes) == 2
    ids, sims, _ = dist.distributed_local_knn(plan, gf, params, CPUS[:3])
    r_ids, r_sims, _ = r_dist.distributed_local_knn(r_plan, _rgf(gf),
                                                    r_params, mesh)
    assert np.array_equal(ids, r_ids) and np.array_equal(sims, r_sims)
    h_ids, _ = r_local_knn(r_plan, _rgf(gf), r_params)
    assert not np.array_equal(ids, h_ids)  # the Hyrec branch differs


def test_build_with_devices_matches_reference_mesh(synth, mesh):
    """Two configurations (the reference compiles its mesh program per
    configuration)."""
    ds, r_ds, gf, _, _ = synth
    kw = dict(PARAMS, t=2)
    g, plan = knn_build.build(ds, C2Params(**kw), verbose=False, gf=gf,
                              devices=CPUS[:2])
    r_g, _ = r_knn_build.build(r_ds, RParams(**kw), mesh=mesh,
                               verbose=False, gf=_rgf(gf))
    assert np.array_equal(g.ids, r_g.ids) and np.array_equal(g.sims, r_g.sims)
    assert plan.n_clusters > 0
