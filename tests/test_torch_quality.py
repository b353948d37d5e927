"""The port's build-quality metrics held bitwise against the JAX reference
on the CPU: exact-Jaccard edge sims (``sketch/exact``), the brute-force
KNN graph (``knn/brute_force``, through the cluster-KNN wrapper's plain
version), ``exact_avg_sim`` and ``quality`` (paper Eq. 1/2) compared as
equal floats, ``recommend`` and ``recall`` (paper §V-B), and
``union_graphs``. Every comparison is exact: ``np.array_equal`` or ``==``,
no tolerance.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.data.synthetic import train_test_split as r_split  # noqa: E402
from repro.eval import metrics as r_metrics  # noqa: E402
from repro.knn.brute_force import brute_force_knn as r_brute_force  # noqa: E402
from repro.knn.topk import union_graphs as r_union  # noqa: E402
from repro.sketch.exact import edge_jaccard as r_edge_jaccard  # noqa: E402
from repro.sketch.goldfinger import fingerprint_dataset as r_fingerprint  # noqa: E402
from repro.types import KNNGraph as RGraph  # noqa: E402
from repro.types import dataset_from_profiles as r_from_profiles  # noqa: E402
from repro_torch.core.params import params_for  # noqa: E402
from repro_torch.core.pipeline import cluster_and_conquer  # noqa: E402
from repro_torch.data.synthetic import make_dataset, train_test_split  # noqa: E402
from repro_torch.eval import metrics  # noqa: E402
from repro_torch.kernels.goldfinger_knn import ops as gk_ops  # noqa: E402
from repro_torch.knn.brute_force import brute_force_knn, n_similarities  # noqa: E402
from repro_torch.knn.topk import union_graphs  # noqa: E402
from repro_torch.sketch.exact import edge_jaccard  # noqa: E402
from repro_torch.sketch.goldfinger import fingerprint_dataset  # noqa: E402
from repro_torch.types import PAD_ID, KNNGraph, dataset_from_profiles  # noqa: E402

K = 10


@pytest.fixture(scope="module")
def ml1m():
    """ml1M@0.05 (302 users) in both packages, the port's C² graph at
    k = 10 (equal to the reference's: test_torch_build.py), and both
    packages' brute-force graphs."""
    ds = make_dataset("ml1M", scale=0.05, seed=0)
    rds = r_make_dataset("ml1M", scale=0.05, seed=0)
    c2, _ = cluster_and_conquer(ds, params_for("ml1M", k=K), device="cpu")
    bf = brute_force_knn(fingerprint_dataset(ds), K, block=128, device="cpu")
    rbf = r_brute_force(r_fingerprint(rds), K, block=128)
    return ds, rds, c2, bf, rbf


def test_brute_force_matches_reference(ml1m):
    ds, _, _, bf, rbf = ml1m
    assert bf.ids.shape == (ds.n_users, K)
    assert np.array_equal(bf.ids, rbf.ids)
    assert np.array_equal(bf.sims, rbf.sims)
    assert not (bf.ids == np.arange(ds.n_users)[:, None]).any()
    assert n_similarities(ds.n_users) == ds.n_users * (ds.n_users - 1) // 2


@pytest.mark.parametrize("block", [1, 97, 4096])
def test_brute_force_blocking_is_invisible(ml1m, block):
    """Row blocks that do not divide n, one row, and all rows at once give
    the same graph; every block goes through the cluster-KNN wrapper."""
    ds, _, _, bf, _ = ml1m
    before = gk_ops.launches
    g = brute_force_knn(fingerprint_dataset(ds), K, block=block,
                        device="cpu")
    assert gk_ops.launches == before  # CPU tensors take the plain version
    assert np.array_equal(g.ids, bf.ids) and np.array_equal(g.sims, bf.sims)


def test_edge_jaccard_pad_and_empty_profiles():
    """Edges to PAD, from and to empty profiles, self edges, disjoint and
    identical profiles, and a profile whose item ids reach past every
    other's: bitwise the reference's, float32, PAD → 0."""
    profiles = [[0, 3, 5, 9], [], [3, 5], [9, 1000], [0, 3, 5, 9], [],
                [7], [1, 2, 3, 4, 5, 6, 7, 8, 9]]
    ds = dataset_from_profiles("edge", profiles, n_items=1001)
    rds = r_from_profiles("edge", profiles, n_items=1001)
    n = len(profiles)
    src = np.repeat(np.arange(n, dtype=np.int32), n + 1)
    dst = np.tile(np.append(np.arange(n, dtype=np.int32), PAD_ID), n)
    got = edge_jaccard(ds, src, dst, chunk=5, device="cpu")
    ref = r_edge_jaccard(rds, src, dst)
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    assert (got[dst == PAD_ID] == 0).all()
    assert got[0 * (n + 1) + 4] == 1.0 and got[1 * (n + 1) + 1] == 0.0


def test_exact_avg_sim_and_quality_equal_floats(ml1m):
    ds, rds, c2, bf, rbf = ml1m
    rc2 = RGraph(ids=c2.ids, sims=c2.sims)
    a = metrics.exact_avg_sim(ds, c2, device="cpu")
    assert a == r_metrics.exact_avg_sim(rds, rc2)
    assert metrics.exact_avg_sim(ds, bf, device="cpu") == \
        r_metrics.exact_avg_sim(rds, rbf)
    q = metrics.quality(ds, c2, bf, device="cpu")
    assert q == r_metrics.quality(rds, rc2, rbf)
    assert 0 < q <= 1.05
    # A graph with no edges scores 0, and the quality of an empty exact
    # graph is 1 by definition.
    empty = KNNGraph(ids=np.full_like(c2.ids, PAD_ID),
                     sims=np.full_like(c2.sims, -np.inf))
    assert metrics.exact_avg_sim(ds, empty, device="cpu") == 0.0
    assert metrics.quality(ds, c2, empty, device="cpu") == 1.0 == \
        r_metrics.quality(rds, rc2, RGraph(ids=empty.ids, sims=empty.sims))


def test_recommend_and_recall(ml1m):
    ds, rds, c2, _, _ = ml1m
    train, test = train_test_split(ds, test_frac=0.2, seed=1)
    r_train, r_test = r_split(rds, test_frac=0.2, seed=1)
    g, _ = cluster_and_conquer(train, params_for("ml1M", k=K), device="cpu")
    recs = metrics.recommend(train, g, n_rec=15)
    r_recs = r_metrics.recommend(r_train, RGraph(ids=g.ids, sims=g.sims),
                                 n_rec=15)
    assert len(recs) == len(r_recs) == train.n_users
    assert all(a.dtype == np.int32 and np.array_equal(a, b)
               for a, b in zip(recs, r_recs))
    got = metrics.recall(recs, test)
    assert got == r_metrics.recall(r_recs, r_test) and 0 < got <= 1


def test_union_graphs_ties_and_duplicates():
    """Self edges, PAD lanes, ids in both graphs (the first occurrence
    wins, whatever its sim), equal sims across and within graphs, and
    fewer candidates than k."""
    rng = np.random.default_rng(4)
    n, ka, kb = 40, 6, 5
    a_ids = rng.integers(-1, n, size=(n, ka)).astype(np.int32)
    b_ids = rng.integers(-1, n, size=(n, kb)).astype(np.int32)
    a_ids[::3, 0] = np.arange(0, n, 3)  # self edges
    b_ids[:, 1] = a_ids[:, 2]            # duplicate ids across graphs
    a_sims = rng.choice([0.25, 0.5, 0.75], size=(n, ka)).astype(np.float32)
    b_sims = rng.choice([0.25, 0.5, 1.0], size=(n, kb)).astype(np.float32)
    a_sims[a_ids == PAD_ID] = -np.inf
    b_sims[b_ids == PAD_ID] = -np.inf
    for k in (None, 4, 16):
        got = union_graphs(KNNGraph(a_ids, a_sims), KNNGraph(b_ids, b_sims),
                           k, device="cpu")
        ref = r_union(RGraph(a_ids, a_sims), RGraph(b_ids, b_sims), k)
        assert np.array_equal(got.ids, np.asarray(ref.ids))
        assert np.array_equal(got.sims, np.asarray(ref.sims))
        assert got.ids.shape == (n, k or ka)
