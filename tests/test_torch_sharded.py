"""The port's sharded placement held bitwise against the JAX reference's
sharded outputs.

* The sharded hop (``ops.descent_hop_sharded``, on the CPU its plain
  version: what both CUDA kernels' shard grid axis is held to on the
  card) against a per-shard loop of the single hop's plain version and
  against the reference's Pallas hops vmapped over the shard axis
  (interpret mode), tombstones and PAD beams included, counts too.
* ``ShardedDescent.descend`` at 2 and 4 shards under every scorer: ids,
  sims and the hop statistics of the reference's (its vmap path).
* Sharded continuous batching: equal to the sharded wave with
  per-request hop budgets, and to the reference tick by tick.
* ``knn_serve --shards`` against the reference CLI, with the mutation
  flags; no request is served an id dead when it was served.

The delta reshard is ``test_torch_sharded_reshard.py``'s, which shares
this file's fixtures and helpers. The reference runs its single-device
vmap path (``use_mesh=False``); the stated tolerance is exact equality of
ids and sims everywhere.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.kernels.descent_score import ops as r_ds_ops  # noqa: E402
from repro.launch import knn_serve as r_knn_serve  # noqa: E402
from repro.query import sharded as r_sharded  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.query.router import fingerprint_profiles as r_fp  # noqa: E402
from repro.query.router import profiles_to_csr as r_csr  # noqa: E402
from repro.query.router import route as r_route  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.kernels.descent_score import ops as ds_ops  # noqa: E402
from repro_torch.kernels.descent_score import ref as ds_ref  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query import sharded  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.sketch.goldfinger import words_tensor  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402

K, BEAM, HOPS = 10, 16, 3
SCORERS = {"jnp": {}, "pallas": {"kernel": True},
           "pallas_dma": {"kernel": True, "dma": True}}
TABLES = ("l_graph", "l_rev", "l_words", "l_card", "l2g", "l_tomb")


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.1 (400 users) with the reference's plan-test parameters,
    built by the reference and loaded by both packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.1, seed=3),
                       RC2Params(k=10, b=64, t=8, max_cluster=48))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.1, seed=77)
    return [qds.profile(u) for u in range(48)]


@pytest.fixture(scope="module")
def inserts():
    ids = make_dataset("synth", scale=0.1, seed=99)
    return [ids.profile(u) for u in range(80)]


def _engines(artifact, **kw):
    """(port engine, reference engine) over one artifact, same config."""
    return (QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                        device="cpu"),
            RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw)))


def _submit(engine, request_cls, profiles, hops=None, base=0):
    for i, p in enumerate(profiles):
        engine.submit(request_cls(rid=base + i, profile=p,
                                  hops=None if hops is None else hops[i]))


def _by_rid(engine):
    return {r.rid: (np.asarray(r.ids), np.asarray(r.sims))
            for r in engine.done}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid][0], b[rid][0], err_msg=str(rid))
        np.testing.assert_array_equal(a[rid][1], b[rid][1], err_msg=str(rid))


def _run_by_step(engine, on_tick=None):
    """Drain step by step; the sorted rids each step completed."""
    steps, tick = [], 0
    while engine.busy():
        if on_tick is not None:
            on_tick(engine, tick)
        before = len(engine.done)
        engine.step()
        steps.append(sorted(r.rid for r in engine.done[before:]))
        tick += 1
    return steps


def _watch_tombstones(engine):
    """Check every request as it completes against the tombstone mask of
    that moment (the plan's step runs before the engine's maintenance)."""
    plan_step = engine.plan.step

    def step(queue, done):
        before = len(done)
        n = plan_step(queue, done)
        for r in done[before:]:
            assert not engine.index.tombstone[r.ids[r.ids != PAD_ID]].any(), \
                f"rid {r.rid} got a dead id"
        return n

    engine.plan.step = step


# -- the sharded hop ----------------------------------------------------------


def _sharded_hop_inputs(rng, S, cap, W, kg, kr, q, B):
    """Stacked shard tables ([S, cap, ·], PAD adjacency lanes, ~10%
    tombstones, rows past each shard's residents empty) and per-shard
    beams [S, q, B] without repeated ids: sorted random sims, PAD tails,
    one all-PAD row per shard, beam lanes naming tombstoned rows."""
    graph = rng.integers(0, cap, (S, cap, kg)).astype(np.int32)
    rev = rng.integers(0, cap, (S, cap, kr)).astype(np.int32)
    graph[rng.random(graph.shape) < 0.1] = PAD_ID
    rev[rng.random(rev.shape) < 0.3] = PAD_ID
    words = (rng.integers(0, 2**32, (S, cap, W), dtype=np.uint64)
             & rng.integers(0, 2**32, (S, cap, W), dtype=np.uint64)
             ).astype(np.uint32)
    used = cap - 5
    graph[:, used:] = rev[:, used:] = PAD_ID
    words[:, used:] = 0
    card = np.unpackbits(words.view(np.uint8), axis=-1).sum(-1).astype(
        np.int32)
    tomb = rng.random((S, cap)) < 0.1
    beam = np.stack([[rng.choice(used, B, replace=False) for _ in range(q)]
                     for _ in range(S)]).astype(np.int32)
    beam[:, :, B - 3:] = PAD_ID
    beam[:, 1] = PAD_ID
    sims = -np.sort(-rng.random((S, q, B)).astype(np.float32), axis=-1)
    sims[beam == PAD_ID] = NEG_INF
    q_words = (rng.integers(0, 2**32, (q, W), dtype=np.uint64)
               & rng.integers(0, 2**32, (q, W), dtype=np.uint64)
               ).astype(np.uint32)
    q_card = np.unpackbits(q_words.view(np.uint8), axis=-1).sum(-1).astype(
        np.int32)
    return graph, rev, words, card, tomb, q_words, q_card, beam, sims


@pytest.mark.parametrize("dma", [False, True], ids=["fused", "dma"])
@pytest.mark.parametrize("W", [4, 9])
def test_sharded_hop_matches_per_shard_loop_and_reference(W, dma):
    rng = np.random.default_rng(W + 10 * dma)
    S, cap, kg, kr, q, B = 3, 40, 4, 3, 6, 8
    graph, rev, words, card, tomb, qw, qc, beam, sims = _sharded_hop_inputs(
        rng, S, cap, W, kg, kr, q, B)
    t = [torch.from_numpy(x) for x in (graph, rev)] + [
        words_tensor(words, "cpu"), torch.from_numpy(card),
        words_tensor(qw, "cpu"), torch.from_numpy(qc),
        torch.from_numpy(beam), torch.from_numpy(sims)]
    tomb_t = torch.from_numpy(tomb)
    out = ds_ops.descent_hop_sharded(*t, tomb=tomb_t, dma=dma,
                                     with_counts=True)
    assert all(o.shape[:2] == (S, q) for o in out)
    plain = ds_ref.descent_hop_sharded_ref(*t, tomb=tomb_t)
    C = B * (kg + kr)
    for s in range(S):
        ids, sm = ds_ref.descent_hop_ref(t[0][s], t[1][s], t[2][s], t[3][s],
                                         t[4], t[5], t[6][s], t[7][s],
                                         tomb=tomb_t[s])
        n_scored = ds_ref.scored_lanes(t[0][s], t[1][s], t[6][s],
                                       tomb=tomb_t[s])
        counts = (ds_ref.dma_counts(n_scored, W, C) if dma
                  else (torch.zeros_like(n_scored),) * 2)
        for got, want in zip(out, (ids, sm, n_scored) + tuple(counts)):
            assert torch.equal(got[s], want)
        for got, want in zip(plain, (ids, sm, n_scored)):
            assert torch.equal(got[s], want)
    # The reference's Pallas hop vmapped over the shard axis (its sharded
    # serving path), counts included.
    r_out = jax.vmap(lambda g, r, w, c, tb, b, bs: r_ds_ops.descent_hop(
        g, r, w, c, jnp.asarray(qw), jnp.asarray(qc), b, bs, tomb=tb,
        dma=dma, with_counts=True))(
        *(jnp.asarray(x) for x in (graph, rev, words, card, tomb, beam,
                                   sims)))
    for got, want in zip(out, r_out):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the sharded wave descent -------------------------------------------------


@pytest.fixture(scope="module")
def routed(artifact, profiles):
    """Fingerprints and routed seeds of the 48 queries (the reference's
    router: the port's is equal, test_torch_serve.py)."""
    ix = RIndex.load(artifact)
    items, offsets = r_csr(profiles)
    qgf = r_fp(items, offsets, ix.n_bits, ix.fp_seed)
    seeds = r_route(ix, items, offsets, 16)
    return np.asarray(qgf.words), np.asarray(qgf.card), np.asarray(seeds)


@pytest.mark.parametrize("scorer", sorted(SCORERS))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_descend_matches_reference(artifact, routed, n_shards, scorer):
    qw, qc, seeds = routed
    kw = SCORERS[scorer]
    sd = sharded.ShardedDescent(KNNIndex.load(artifact), n_shards,
                                device="cpu")
    r_sd = r_sharded.ShardedDescent(RIndex.load(artifact), n_shards,
                                    use_mesh=False)
    for a, b, name in zip(sd._dev, r_sd._dev, TABLES):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.view(np.int32) if name == "l_words" else b)
    np.testing.assert_array_equal(sd.shard_seeds(seeds),
                                  r_sd.shard_seeds(seeds))
    ids, sims = sd.descend(qw, qc, seeds, k=K, beam=BEAM, hops=HOPS, **kw)
    r_ids, r_sims = r_sd.descend(qw, qc, seeds, k=K, beam=BEAM, hops=HOPS,
                                 **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(sims.numpy(), np.asarray(r_sims))
    np.testing.assert_array_equal(sd.last_hop_stats,
                                  np.asarray(r_sd.last_hop_stats))
    assert sd.shard_beam(BEAM, K) == r_sd.shard_beam(BEAM, K)
    if scorer != "jnp":
        assert sd.last_hop_stats[:, 0].sum() > 0


# -- sharded continuous batching ----------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_continuous_equals_wave_with_budgets(artifact, profiles,
                                                     n_shards):
    """Per-request hop budgets (0, 3 and 6 hops) under sharded continuous
    batching, every scorer: each request equals the sharded wave at its
    own budget, bitwise."""
    deep = 2 * HOPS
    budgets = [deep if rid % 3 == 0 else (0 if rid % 5 == 0 else HOPS)
               for rid in range(len(profiles))]
    truth = {}
    for hops in (0, HOPS, deep):
        eng, _ = _engines(artifact, k=K, beam=BEAM, hops=hops, max_wave=64,
                          shards=n_shards)
        _submit(eng, QueryRequest, profiles)
        eng.run()
        truth[hops] = _by_rid(eng)
    for scorer, kw in SCORERS.items():
        cont, _ = _engines(artifact, k=K, beam=BEAM, hops=HOPS,
                           continuous=True, slots=7, shards=n_shards, **kw)
        _submit(cont, QueryRequest, profiles, hops=budgets)
        stats = cont.run()
        assert stats["plan"] == (f"sharded({n_shards}) x continuous(slots=7)"
                                 f" x {scorer}")
        assert stats["shards"] == n_shards
        got = _by_rid(cont)
        _assert_same(got, {rid: truth[budgets[rid]][rid] for rid in got})


@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_sharded_continuous_matches_reference_tick_by_tick(artifact,
                                                           profiles, scorer):
    port, ref = _engines(artifact, k=K, beam=BEAM, hops=HOPS,
                         continuous=True, slots=9, shards=2,
                         **SCORERS[scorer])
    _submit(port, QueryRequest, profiles)
    _submit(ref, RQueryRequest, profiles)
    assert _run_by_step(port) == _run_by_step(ref)
    assert port.n_ticks == ref.n_ticks
    _assert_same(_by_rid(port), _by_rid(ref))
    assert port.plan.descent_stats == ref.plan.descent_stats


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--shards", "2"],
    ["--shards", "2", "--continuous", "--slots", "8", "--kernel", "--dma",
     "--insert", "70", "--churn", "8", "--repair-every", "1"],
], ids=["wave", "mutations"])
def test_knn_serve_sharded_matches_reference(tmp_path, artifact, flags,
                                             monkeypatch, capsys):
    """``knn_serve --shards`` over one artifact: the reference CLI's
    ``sharded:`` numbers (resident rows, MB, imbalance), recall, counters
    and served ids and sims rid by rid; no request served a dead id."""
    common = ["--index", str(artifact), "--dataset", "synth", "--scale",
              "0.1", "--queries", "24", "--beam", "16"]
    captured = []

    class Capture(RQueryEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(r_knn_serve, "QueryEngine", Capture)
    # The reference's flags name the plain hop: the scorer never changes
    # a result.
    r_stats, r_recall = r_knn_serve.main(
        common + [f for f in flags if f not in ("--kernel", "--dma")])
    r_out = capsys.readouterr().out

    watched = []
    engine_cls = knn_serve.QueryEngine

    class Watched(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            _watch_tombstones(self)
            watched.append(self)

    monkeypatch.setattr(knn_serve, "QueryEngine", Watched)
    stats, recall, engine = knn_serve.main(common + flags
                                           + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert watched == [engine]
    ref = captured[0]

    def numbers(text):
        line = [x for x in text.splitlines() if "[serve] sharded:" in x]
        assert len(line) == 1
        return line[0].split("imbalance")[0] + line[0].split(
            "imbalance")[1][:6]

    assert numbers(out) == numbers(r_out)
    assert recall == r_recall
    for key in ("requests", "waves", "inserted", "refreshes", "shards"):
        assert stats[key] == r_stats[key], key
    assert stats["lifecycle"] == ref.lifecycle.stats()
    assert [x for x in out.splitlines() if "churned" in x] == \
        [x for x in r_out.splitlines() if "churned" in x]
    _assert_same(_by_rid(engine), _by_rid(ref))
    assert engine.index.version == ref.index.version


def test_sharded_state_is_built_once_and_synced(artifact):
    """The plan's sharded state is built once, then synced (its sync()
    results counted); the single placement has none."""
    port, _ = _engines(artifact, k=K, shards=2)
    sd = port.sharded_state()
    assert port.sharded_state() is sd and port.plan.sync() is sd
    assert port.plan.sync_stats == {"noop": 2, "delta": 0, "rebuild": 0}
    single, _ = _engines(artifact, k=K)
    assert single.sharded_state() is None
