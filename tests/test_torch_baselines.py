"""The paper's baselines, Alg. 2's Hyrec branch and Table V's raw mode,
held bitwise against the JAX reference on the CPU.

Hyrec and NNDescent (ids, sims and ``GreedyStats``), ``local_knn`` on a
plan whose clusters cross ρk², ``lsh_plan`` / ``lsh_knn`` with buckets
that take the Hyrec branch, ``incidence_fingerprint``, a raw-mode
``cluster_and_conquer`` wider than the reference's MXU switch (64 words),
and the plain cluster-KNN above the kernel's whole-row width (1,104
words). Every comparison feeds the same seeded numpy inputs to both
packages and compares with ``np.array_equal``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core.clustering import ClusterPlan as RPlan  # noqa: E402
from repro.core.local_knn import _group_knn as r_group_knn  # noqa: E402
from repro.core.local_knn import local_knn as r_local_knn  # noqa: E402
from repro.core.params import C2Params as RParams  # noqa: E402
from repro.core.params import params_for as r_params_for  # noqa: E402
from repro.core.pipeline import cluster_and_conquer as r_c2  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.knn import greedy as r_greedy  # noqa: E402
from repro.knn import lsh as r_lsh  # noqa: E402
from repro.sketch.goldfinger import GoldFinger as RGF  # noqa: E402
from repro.sketch.goldfinger import fingerprint_dataset as r_fp  # noqa: E402
from repro.sketch.goldfinger import (  # noqa: E402
    incidence_fingerprint as r_incidence)
from repro_torch.core.clustering import ClusterPlan  # noqa: E402
from repro_torch.core.local_knn import group_batches, local_knn  # noqa: E402
from repro_torch.bench.common import (BENCH_K, BENCH_SCALES,  # noqa: E402
                                      bench_params)
from repro_torch.core.params import C2Params, params_for  # noqa: E402
from repro_torch.core.pipeline import cluster_and_conquer  # noqa: E402
from repro_torch.data.synthetic import PAPER_DATASETS, make_dataset  # noqa: E402
from repro_torch.kernels.goldfinger_knn import ref as gk_ref  # noqa: E402
from repro_torch.knn import greedy, lsh  # noqa: E402
from repro_torch.sketch.goldfinger import (GoldFinger,  # noqa: E402
                                           fingerprint_dataset,
                                           incidence_fingerprint,
                                           popcount_rows, words_tensor)
from repro_torch.types import PAD_ID  # noqa: E402


@pytest.fixture(scope="module")
def synth():
    """synth@0.05 (200 users) and its 256-bit GoldFinger, both packages."""
    ds = make_dataset("synth", scale=0.05, seed=0)
    gf = fingerprint_dataset(ds, n_bits=256)
    r_gf = r_fp(r_make_dataset("synth", scale=0.05, seed=0), n_bits=256)
    assert np.array_equal(gf.words, r_gf.words)
    return ds, gf


def _same_graph(a, b):
    return np.array_equal(a.ids, b.ids) and np.array_equal(a.sims, b.sims)


def test_random_graph_is_the_reference():
    for n, k, seed in ((200, 5, 0), (31, 30, 7), (2, 1, 3)):
        ids = greedy.random_graph(n, k, seed)
        assert np.array_equal(ids, r_greedy.random_graph(n, k, seed))
        assert ids.dtype == np.int32
        assert not (ids == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("algo", ["hyrec", "nndescent"])
def test_greedy_matches_reference(synth, algo):
    """Graph and stats: iterations, per-iteration updates and n_sims; a
    second run from a given starting graph with a cut-off at 3 iterations."""
    _, gf = synth
    r_gf = RGF(words=gf.words, card=gf.card)
    fn, r_fn = getattr(greedy, algo), getattr(r_greedy, algo)
    ids0 = greedy.random_graph(gf.n, 4, 11)
    for kw in (dict(k=5), dict(k=4, ids0=ids0, max_iters=3, delta=0.0)):
        g, st = fn(gf, device="cpu", **kw)
        r_g, r_st = r_fn(r_gf, **kw)
        assert _same_graph(g, r_g)
        assert (st.iters, st.updates, st.n_sims) == \
            (r_st.iters, r_st.updates, r_st.n_sims)
    assert st.iters == 3 and len(st.updates) == 3


def _plan_pair(sizes, n_users, seed):
    """The same plan in both packages: clusters of the given sizes over
    disjoint random users, one configuration per two clusters."""
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


@pytest.mark.parametrize("k,rho,sizes", [
    (5, 1, (40, 25, 24, 9, 3, 2)),   # ρk² = 25: two clusters take Hyrec
    (3, 0, (12, 3, 2)),              # every cluster, narrow lists padded
])
def test_local_knn_hyrec_branch_matches_reference(synth, k, rho, sizes):
    _, gf = synth
    plan, r_plan = _plan_pair(sizes, gf.n, seed=k + rho)
    params = C2Params(k=k, rho=rho)
    ids, sims = local_knn(plan, gf, params, device="cpu")
    r_ids, r_sims = r_local_knn(r_plan, RGF(words=gf.words, card=gf.card),
                                RParams(k=k, rho=rho))
    assert np.array_equal(ids, r_ids) and np.array_equal(sims, r_sims)
    # The kernel's batches leave the Hyrec clusters out.
    batched = {int(ci) for _, batch, _ in group_batches(
        plan, gf.words.shape[1], params.bf_threshold) for ci in batch}
    assert batched == set(np.flatnonzero(plan.sizes < params.bf_threshold))


def test_lsh_plan_matches_reference():
    ds = make_dataset("synth", scale=0.1, seed=0)
    r_ds = r_make_dataset("synth", scale=0.1, seed=0)
    for t, seed in ((4, 0), (3, 2)):
        plan, r_plan = lsh.lsh_plan(ds, t, seed), r_lsh.lsh_plan(r_ds, t, seed)
        assert len(plan.members) == len(r_plan.members)
        assert all(np.array_equal(a, b)
                   for a, b in zip(plan.members, r_plan.members))
        assert np.array_equal(plan.config_of, r_plan.config_of)
        assert (plan.n_users, plan.t) == (r_plan.n_users, r_plan.t)


def test_lsh_knn_takes_hyrec_and_matches_reference():
    """synth@0.1 at t = 4, k = 3: buckets of 46 and 68 users cross
    ρk² = 45 and take the Hyrec branch."""
    ds = make_dataset("synth", scale=0.1, seed=0)
    r_ds = r_make_dataset("synth", scale=0.1, seed=0)
    gf = fingerprint_dataset(ds, n_bits=256)
    k, t = 3, 4
    plan = lsh.lsh_plan(ds, t)
    assert (plan.sizes >= C2Params(k=k).bf_threshold).sum() >= 1
    g, st = lsh.lsh_knn(ds, gf, k=k, t=t, device="cpu")
    r_g, r_st = r_lsh.lsh_knn(r_ds, RGF(words=gf.words, card=gf.card), k=k,
                              t=t)
    assert _same_graph(g, r_g)
    for key in ("n_buckets", "n_sims", "max_bucket"):
        assert st[key] == r_st[key], key
    assert st["max_bucket"] >= C2Params(k=k).bf_threshold


@pytest.mark.parametrize("name,scale", [("ml1M", 0.05), ("DBLP", 0.005)])
def test_incidence_fingerprint_matches_reference(name, scale):
    ds = make_dataset(name, scale=scale, seed=0)
    gf = incidence_fingerprint(ds)
    r_gf = r_incidence(r_make_dataset(name, scale=scale, seed=0))
    assert np.array_equal(gf.words, r_gf.words)
    assert np.array_equal(gf.card, r_gf.card)
    assert gf.words.shape[1] == -(-ds.n_items // 32)
    assert np.array_equal(gf.card, ds.profile_sizes)  # one bit per item


def test_raw_mode_c2_matches_reference_mxu_form():
    """ml1M@0.05 on incidence rows (W = 111 words, above the reference's
    64-word switch to its MXU bit-plane form) through ``_group_knn``."""
    ds = make_dataset("ml1M", scale=0.05, seed=0)
    r_ds = r_make_dataset("ml1M", scale=0.05, seed=0)
    gf, r_gf = incidence_fingerprint(ds), r_incidence(r_ds)
    assert gf.words.shape[1] == 111
    kw = dict(k=10, b=64, max_cluster=64)
    g, st = cluster_and_conquer(ds, params_for("ml1M", **kw), gf=gf,
                                device="cpu")
    r_g, r_st = r_c2(r_ds, r_params_for("ml1M", **kw), gf=r_gf)
    assert _same_graph(g, r_g)
    assert (st.n_clusters, st.n_sims, st.max_cluster) == \
        (r_st.n_clusters, r_st.n_sims, r_st.max_cluster)


def test_plain_cluster_knn_above_whole_row_width():
    """W = 1,200 words (the kernel streams such rows in chunks): the plain
    cluster-KNN against the reference's ``_group_knn``, with PAD tails and
    planted equal sims."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    m, cap, W, k = 2, 32, 1200, 10
    words = rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
    words &= rng.integers(0, 2**32, size=words.shape, dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:, 1::5] = words[:, :1]
    ids = rng.permutation(m * cap * 2)[: m * cap].astype(np.int32)
    ids = ids.reshape(m, cap)
    ids[1, 20:] = PAD_ID
    words[1, 20:] = 0
    card = popcount_rows(words.reshape(-1, W)).reshape(m, cap)
    p_ids, p_sims = gk_ref.cluster_knn_ref(
        words_tensor(words, "cpu"), torch.from_numpy(card),
        torch.from_numpy(ids), k)
    r_ids, r_sims = r_group_knn(jnp.asarray(words), jnp.asarray(card),
                                jnp.asarray(ids), k)
    assert np.array_equal(p_ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(p_sims.numpy(), np.asarray(r_sims))
    assert GoldFinger(words=words[0], card=card[0]).n_bits == 38400


def test_bench_params_are_the_benches():
    """The port's copy of the benches' scaling (``bench/common``) gives
    ``benchmarks/common.py``'s parameters at every bench scale."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "benchmarks" / "common.py"
    spec = importlib.util.spec_from_file_location("_bench_common", path)
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    assert BENCH_SCALES == common.BENCH_SCALES
    assert BENCH_K == common.K_DEFAULT
    for name, scale in BENCH_SCALES.items():
        n = max(64, int(round(PAPER_DATASETS[name].n_users * scale)))
        for n_users in (n, 6038, 64):
            ours = bench_params(name, n_users)
            theirs = common.bench_params(name, n_users)
            assert dataclasses.asdict(ours) == {
                f.name: getattr(theirs, f.name)
                for f in dataclasses.fields(theirs)}
