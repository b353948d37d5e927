"""The port's serving path held bitwise against the JAX reference.

The plain descent hop (what the CUDA hop is checked against on the card)
against ``descent_hop_ref`` and the Pallas hop in interpret mode, scored
lane counts included; the index artifact crossing between packages; and
the query engine on synth@0.1 serving the reference's ids and sims.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.params import params_for as r_params_for  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.kernels.descent_score import ops as r_ds_ops  # noqa: E402
from repro.kernels.descent_score import ref as r_ds_ref  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.query.search import exact_knn as r_exact_knn  # noqa: E402
from repro_torch.core.params import params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.descent_score import ops as ds_ops  # noqa: E402
from repro_torch.kernels.descent_score import ref as ds_ref  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex, build_index  # noqa: E402
from repro_torch.query.plan import PlanSpec  # noqa: E402
from repro_torch.query.search import exact_knn  # noqa: E402
from repro_torch.sketch.goldfinger import words_tensor  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402

_ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids", "tombstone",
         "last_touch")
_TABLES = ("hash_seeds", "cluster_paths", "cluster_config",
           "cluster_members", "cluster_offsets")


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


def _words(rng, n, W):
    w = rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
    w &= rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
    return w.astype(np.uint32)


def _hop_inputs(seed, n=90, kg=5, kr=7, W=32, q=17, B=6):
    """Adjacency with PAD tails and duplicate ids, distinct-id beams
    (sim-descending, −inf under PAD; some fully PAD), a tombstone mask."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-1, n, size=(n, kg)).astype(np.int32)
    r = rng.integers(-1, n, size=(n, kr)).astype(np.int32)
    g[:6] = PAD_ID
    w = _words(rng, n, W)
    w[3] = 0
    c = np.unpackbits(w.view(np.uint8), axis=1).sum(1).astype(np.int32)
    qw = _words(rng, q, W)
    qc = np.unpackbits(qw.view(np.uint8), axis=1).sum(1).astype(np.int32)
    bi = np.full((q, B), PAD_ID, np.int32)
    for i in range(q):
        m = 0 if i % 6 == 0 else int(rng.integers(1, B + 1))
        bi[i, :m] = rng.choice(n, size=m, replace=False)
    bs = np.where(bi == PAD_ID, NEG_INF,
                  -np.sort(-rng.random((q, B)))).astype(np.float32)
    tomb = rng.random(n) < 0.15
    return g, r, w, c, qw, qc, bi, bs, tomb


@pytest.mark.parametrize("W", [4, 32, 64, 80])
@pytest.mark.parametrize("with_tomb", [False, True])
def test_plain_hop_matches_reference_and_pallas(W, with_tomb):
    g, r, w, c, qw, qc, bi, bs, tomb = _hop_inputs(W + with_tomb, W=W)
    tomb_j = jnp.asarray(tomb) if with_tomb else None
    jargs = tuple(jnp.asarray(x) for x in (g, r, w, c, qw, qc, bi, bs))
    ref_ids, ref_sims = r_ds_ref.descent_hop_ref(*jargs, tomb=tomb_j)
    k_ids, k_sims, k_scored, _, _ = r_ds_ops.descent_hop(
        *jargs, tomb=tomb_j, with_counts=True)
    targs = (torch.from_numpy(g), torch.from_numpy(r),
             words_tensor(w, "cpu"), torch.from_numpy(c),
             words_tensor(qw, "cpu"), torch.from_numpy(qc),
             torch.from_numpy(bi), torch.from_numpy(bs))
    tomb_t = torch.from_numpy(tomb) if with_tomb else None
    p_ids, p_sims = ds_ref.descent_hop_ref(*targs, tomb=tomb_t)
    o_ids, o_sims, o_scored, o_dma, o_saved = ds_ops.descent_hop(
        *targs, tomb=tomb_t, with_counts=True)
    for ids, sims in ((ref_ids, ref_sims), (k_ids, k_sims)):
        np.testing.assert_array_equal(np.asarray(ids), p_ids.numpy())
        np.testing.assert_array_equal(np.asarray(sims), p_sims.numpy())
    assert torch.equal(p_ids, o_ids) and torch.equal(p_sims, o_sims)
    np.testing.assert_array_equal(np.asarray(k_scored), o_scored.numpy())
    assert not o_dma.any() and not o_saved.any()


@pytest.fixture(scope="module")
def indexes():
    """synth@0.1 (400 users) built the way knn_serve builds, by both."""
    ds = r_make_dataset("synth", scale=0.1, seed=0)
    kw = dict(k=10, b=max(64, ds.n_users // 16),
              max_cluster=max(48, int(0.06 * ds.n_users)))
    ref = r_build_index(ds, r_params_for("synth", **kw))
    port = build_index(make_dataset("synth", scale=0.1, seed=0),
                       params_for("synth", **kw), device="cpu")
    return ref, port


def test_built_index_matches_reference(indexes):
    ref, port = indexes
    for name in _ROWS + _TABLES:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ref.b, ref.n_bits, ref.fp_seed, ref.split_depth) == \
        (port.b, port.n_bits, port.fp_seed, port.split_depth)


def test_index_npz_crosses_both_ways(indexes, tmp_path):
    ref, port = indexes
    ref.save(tmp_path / "ref.npz")
    port.save(tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    loaded = KNNIndex.load(tmp_path / "ref.npz")
    back = RIndex.load(tmp_path / "port.npz")
    for name in _ROWS + _TABLES:
        np.testing.assert_array_equal(getattr(ref, name),
                                      getattr(loaded, name))
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(back, name))
    # Journals round-trip through the port unchanged.
    loaded.save(tmp_path / "again.npz")
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "again.npz") as b:
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _serve(engine, request_cls, profiles):
    for rid, p in enumerate(profiles):
        engine.submit(request_cls(rid=rid, profile=p))
    stats = engine.run()
    done = sorted(engine.done, key=lambda r: r.rid)
    return (np.stack([r.ids for r in done]), np.stack([r.sims for r in done]),
            engine.recall_vs_brute_force(), stats)


def test_engine_serves_reference_results(indexes):
    ref, port = indexes
    qds = r_make_dataset("synth", scale=0.1, seed=1)
    profiles = [qds.profile(u) for u in range(64)]
    r_ids, r_sims, r_recall, _ = _serve(
        RQueryEngine(ref, RQueryConfig(max_wave=32)), RQueryRequest,
        profiles)
    for kernel in (False, True):
        t_ids, t_sims, t_recall, stats = _serve(
            QueryEngine(port, QueryConfig(max_wave=32, kernel=kernel),
                        device="cpu"), QueryRequest, profiles)
        np.testing.assert_array_equal(r_ids, t_ids)
        np.testing.assert_array_equal(r_sims, t_sims)
        assert t_recall == r_recall
        assert stats["requests"] == 64 and stats["waves"] == 2
        assert ("descent" in stats) == kernel
    assert stats["descent"]["scored_lanes"] > 0


def test_exact_knn_matches_reference(indexes):
    _, port = indexes
    rng = np.random.default_rng(4)
    qw = port.words[rng.choice(port.n, 40, replace=False)].copy()
    qw[::3] &= _words(rng, 14, qw.shape[1])
    qc = np.unpackbits(qw.view(np.uint8), axis=1).sum(1).astype(np.int32)
    tomb = rng.random(port.n) < 0.1
    r_ids, r_sims = r_exact_knn(port.words, port.card, qw, qc, 10,
                                tomb=tomb)
    t_ids, t_sims = exact_knn(port.words, port.card, qw, qc, 10, tomb=tomb,
                              device="cpu")
    np.testing.assert_array_equal(r_ids, t_ids)
    np.testing.assert_array_equal(r_sims, t_sims)


def test_knn_serve_cli_on_cpu(indexes, tmp_path, capsys):
    _, port = indexes
    port.save(tmp_path / "ix.npz")
    stats, recall, _ = knn_serve.main(
        ["--index", str(tmp_path / "ix.npz"), "--dataset", "synth",
         "--scale", "0.1", "--queries", "40", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "recall@10 vs brute force" in out and "lanes scored" in out
    assert stats["requests"] == 40 and 0.5 < recall <= 1.0


def test_plans_outside_slice_raise():
    # The sharded placement is ported: both batchings validate, and a
    # placement below one shard is refused, as the reference does.
    for kw in (dict(placement=2),
               dict(placement=2, batching="continuous")):
        assert PlanSpec(**kw).describe().startswith("sharded(2) x ")
    with pytest.raises(ValueError, match="placement"):
        PlanSpec(placement=0)
    with pytest.raises(ValueError):
        PlanSpec(scorer="nope")
    with pytest.raises(ValueError, match="kernel"):
        QueryConfig(dma=True).spec()


def test_cuda_without_card_raises(indexes, monkeypatch):
    _, port = indexes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        QueryEngine(port)  # default device is cuda
    with pytest.raises(RuntimeError, match="is_available"):
        knn_serve.main(["--dataset", "synth", "--scale", "0.05"])
