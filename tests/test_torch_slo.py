"""The port's SLO admission and adaptive hop budgets held bitwise against
the JAX reference.

* ``shed_and_select`` and the SLO ``SlotScheduler`` on random streams:
  selections, sheds, what stays pending, slot assignments and the
  exactly-once invariant (hypothesis, derandomized).
* ``ManualClock`` engines under wave and continuous x slo: the same shed
  rids, served ids and sims and ``t_done`` by rid as the reference, with
  both expired and overflow requests shed; in waves no class-1 request
  completes before the last class-0 one.
* Adaptive budgets, single and 2-shard continuous serves: ids, sims,
  ticks and ``hop_queries`` of the reference; ``slot_prefix_stable`` on
  ``[n_slots, beam]`` and ``[S, n_slots, beam]`` beams.
* ``PlanSpec``'s new fields refuse what the reference refuses.
* ``knn_serve --admission slo --max-pending --priority-split --adaptive
  --cache`` against the reference CLI.

The reference runs its plain hop (scorers never change a result, which
``test_torch_continuous.py`` holds); the stated tolerance is exact
equality everywhere.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from collections import deque  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.launch import knn_serve as r_knn_serve  # noqa: E402
from repro.query import search as r_search  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.query.plan import PlanSpec as RPlanSpec  # noqa: E402
from repro.sched import ManualClock as RManualClock  # noqa: E402
from repro.sched import SlotScheduler as RSlotScheduler  # noqa: E402
from repro.sched import shed_and_select as r_shed_and_select  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query import search  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.query.plan import PlanSpec  # noqa: E402
from repro_torch.sched import ManualClock, SlotScheduler, shed_and_select  # noqa: E402

K, BEAM, HOPS = 8, 12, 3
SCORERS = {"jnp": {}, "pallas": {"kernel": True},
           "pallas_dma": {"kernel": True, "dma": True}}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users), built by the reference and loaded by both
    packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.05, seed=5),
                       RC2Params(k=8, b=64, t=4, max_cluster=32))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(40)]


class _Item:
    def __init__(self, rid, priority, deadline):
        self.rid, self.priority, self.deadline = rid, priority, deadline


def _stream(seed: int, n: int):
    """n items with random classes and deadlines (a third never expire)."""
    rng = np.random.default_rng(seed)
    return [_Item(i, int(rng.integers(0, 3)),
                  None if rng.random() < 0.3 else float(rng.integers(0, 20)))
            for i in range(n)]


def _rids(items):
    return [it.rid for it in items]


# -- shed_and_select and the SLO scheduler ----------------------------------


def test_shed_and_select_matches_reference():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=40, deadline=None, database=None,
              derandomize=True)
    @given(seed=st.integers(0, 2**31 - 1), n_items=st.integers(0, 30),
           n=st.integers(0, 12), now=st.integers(0, 20),
           max_pending=st.integers(0, 8))
    def battery(seed, n_items, n, now, max_pending):
        items = _stream(seed, n_items)
        mine, theirs = deque(items), deque(items)
        sel, shed = shed_and_select(mine, n, float(now), max_pending)
        r_sel, r_shed = r_shed_and_select(theirs, n, float(now), max_pending)
        assert _rids(sel) == _rids(r_sel)
        assert _rids(shed) == _rids(r_shed)
        assert _rids(mine) == _rids(theirs)
        assert sorted(_rids(sel) + _rids(shed) + _rids(mine)) == \
            list(range(n_items))

    battery()


def test_slo_scheduler_matches_reference():
    """Random submit / advance / admit / release interleavings through the
    port's and the reference's SLO schedulers, each on its own
    ManualClock: the same (slot, rid) admissions, drained sheds and
    invariants at every step, the exactly-once accounting included."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    ops = st.lists(st.sampled_from(("submit", "advance", "admit",
                                    "release")), min_size=1, max_size=60)

    @settings(max_examples=25, deadline=None, database=None,
              derandomize=True)
    @given(n_slots=st.integers(1, 6), max_pending=st.integers(0, 5),
           ops=ops, seed=st.integers(0, 2**31 - 1))
    def battery(n_slots, max_pending, ops, seed):
        clock, r_clock = ManualClock(), RManualClock()
        mine = SlotScheduler(n_slots, policy="slo", max_pending=max_pending,
                             clock=clock)
        theirs = RSlotScheduler(n_slots, policy="slo",
                                max_pending=max_pending, clock=r_clock)
        items = iter(_stream(seed, 200))
        rng = np.random.default_rng(seed)
        for op in ops + ["admit"]:
            if op == "submit":
                it = next(items)
                mine.submit(it)
                theirs.submit(it)
            elif op == "advance":
                dt = float(rng.integers(0, 4))
                clock.advance(dt)
                r_clock.advance(dt)
            elif op == "admit":
                a, b = mine.admit(), theirs.admit()
                assert [(s, i.rid) for s, i in a] == \
                    [(s, i.rid) for s, i in b]
                assert _rids(mine.drain_shed()) == _rids(theirs.drain_shed())
            elif mine.active_slots:
                slot = mine.active_slots[
                    int(rng.integers(0, len(mine.active_slots)))]
                assert mine.release(slot).rid == theirs.release(slot).rid
            np.testing.assert_array_equal(mine.active_mask(),
                                          theirs.active_mask())
            assert _rids(mine.pending) == _rids(theirs.pending)
            assert (mine.n_submitted, mine.n_admitted, mine.n_shed,
                    mine.n_completed) == (theirs.n_submitted,
                                          theirs.n_admitted, theirs.n_shed,
                                          theirs.n_completed)
            mine.check_invariants()
            theirs.check_invariants()

    battery()


def test_manual_clock():
    clock = ManualClock(2.0)
    assert clock() == 2.0 and clock.advance(0.5) == 2.5
    clock.advance(1.0)
    assert clock() == 3.5
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1.0)


# -- engines under slo admission --------------------------------------------


def _slo_serve(engine_cls, request_cls, clock, artifact, loader, profiles,
               **kw):
    """Submit every profile at t = 1 s: the first quarter class 0, the
    rest class 1; deadlines 1-4 steps away. Each step advances the clock
    by one 10 ms step."""
    eng = engine_cls(loader(artifact), **kw, clock=clock)
    for rid, p in enumerate(profiles):
        eng.submit(request_cls(rid=rid, profile=p,
                               priority=0 if rid < len(profiles) // 4 else 1,
                               deadline=clock() + 0.01 * (1 + rid % 4)))
    order = []
    while eng.busy():
        before = len(eng.done)
        eng.step()
        order.extend(r.rid for r in eng.done[before:])
        clock.advance(0.01)
    return eng, order


SLO_PATHS = {"wave x jnp": dict(max_wave=6),
             "wave x pallas": dict(max_wave=6, kernel=True),
             "continuous x pallas_dma": dict(continuous=True, slots=6,
                                             kernel=True, dma=True)}


@pytest.mark.parametrize("path", sorted(SLO_PATHS))
def test_engine_slo_matches_reference(artifact, profiles, path):
    kw = SLO_PATHS[path]
    cfg = dict(k=K, beam=BEAM, hops=HOPS, admission="slo", max_pending=8,
               **{k: v for k, v in kw.items() if k not in ("kernel", "dma")})
    eng, order = _slo_serve(
        QueryEngine, QueryRequest, ManualClock(1.0), artifact,
        KNNIndex.load, profiles, qc=QueryConfig(**cfg, **{
            k: v for k, v in kw.items() if k in ("kernel", "dma")}),
        device="cpu")
    ref, r_order = _slo_serve(RQueryEngine, RQueryRequest, RManualClock(1.0),
                              artifact, RIndex.load, profiles,
                              qc=RQueryConfig(**cfg))
    assert order == r_order
    shed = sorted(r.rid for r in eng.done if r.rejected)
    assert shed == sorted(r.rid for r in ref.done if r.rejected)
    # Both kinds of shedding happened: some requests expired, and the
    # bounded queue overflowed at the first admission.
    assert 0 < len(shed) < len(profiles)
    r_by = {r.rid: r for r in ref.done}
    for r in eng.done:
        b = r_by[r.rid]
        assert (r.status, r.t_done, r.latency) == (b.status, b.t_done,
                                                    b.latency)
        if r.rejected:
            assert r.ids is None and b.ids is None
        else:
            np.testing.assert_array_equal(r.ids, b.ids)
            np.testing.assert_array_equal(r.sims, b.sims)
    if path.startswith("wave"):
        done0 = [i for i, rid in enumerate(order) if rid < len(profiles) // 4
                 and not eng.done[i].rejected]
        done1 = [i for i, rid in enumerate(order) if rid >= len(profiles) // 4
                 and not eng.done[i].rejected]
        assert max(done0) < min(done1)


def test_slo_stats_and_served_results_equal_fifo(artifact, profiles):
    """``run()``'s SLO stats are the reference's (served, shed, latency
    over served requests only), and every served rid carries the FIFO
    serve's result."""
    qc = dict(k=K, beam=BEAM, hops=HOPS, continuous=True, slots=4,
              admission="slo", max_pending=6)
    stats = {}
    for name, cls, req, clock, loader in (
            ("port", QueryEngine, QueryRequest, ManualClock(1.0),
             KNNIndex.load),
            ("ref", RQueryEngine, RQueryRequest, RManualClock(1.0),
             RIndex.load)):
        kw = {"device": "cpu"} if name == "port" else {}
        eng = cls(loader(artifact),
                  (QueryConfig if name == "port" else RQueryConfig)(**qc),
                  clock=clock, **kw)
        for rid, p in enumerate(profiles[:20]):
            eng.submit(req(rid=rid, profile=p, priority=rid % 2))
        stats[name] = eng.run(on_tick=lambda e, t: e.clock.advance(0.005))
        stats[name + "_engine"] = eng
    for key in ("requests", "served", "shed", "waves", "qps",
                "mean_latency_s", "p50_latency_s", "p95_latency_s"):
        assert stats["port"][key] == stats["ref"][key], key
    assert stats["port"]["shed"] == 20 - 4 - 6
    fifo = QueryEngine(KNNIndex.load(artifact),
                       QueryConfig(k=K, beam=BEAM, hops=HOPS), device="cpu")
    for rid, p in enumerate(profiles[:20]):
        fifo.submit(QueryRequest(rid=rid, profile=p))
    fifo.run()
    truth = {r.rid: r for r in fifo.done}
    for r in stats["port_engine"].done:
        if not r.rejected:
            np.testing.assert_array_equal(r.ids, truth[r.rid].ids)
            np.testing.assert_array_equal(r.sims, truth[r.rid].sims)


# -- adaptive hop budgets -------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("adaptive", [1, 2])
def test_adaptive_matches_reference(artifact, profiles, shards, adaptive):
    """Adaptive continuous serves (8 slots, hop budget 6) under every
    scorer equal the reference's: ids, sims, ticks and hop_queries, and
    never cost slot hops against the non-adaptive serve."""
    cfg = dict(k=K, beam=BEAM, hops=6, continuous=True, slots=8,
               shards=shards, adaptive=adaptive)
    ref = RQueryEngine(RIndex.load(artifact), RQueryConfig(**cfg))
    for rid, p in enumerate(profiles):
        ref.submit(RQueryRequest(rid=rid, profile=p))
    ref.run()
    truth = {r.rid: (r.ids, r.sims) for r in ref.done}
    for scorer, kw in SCORERS.items():
        eng = QueryEngine(KNNIndex.load(artifact), QueryConfig(**cfg, **kw),
                          device="cpu")
        for rid, p in enumerate(profiles):
            eng.submit(QueryRequest(rid=rid, profile=p))
        eng.run()
        assert [r.rid for r in eng.done] == [r.rid for r in ref.done], scorer
        for r in eng.done:
            np.testing.assert_array_equal(r.ids, truth[r.rid][0])
            np.testing.assert_array_equal(r.sims, truth[r.rid][1])
        assert eng.n_ticks == ref.n_ticks, scorer
        assert eng.plan.descent_stats["hop_queries"] == \
            ref.plan.descent_stats["hop_queries"]
    full = QueryEngine(KNNIndex.load(artifact),
                       QueryConfig(**{**cfg, "adaptive": 0}), device="cpu")
    for rid, p in enumerate(profiles):
        full.submit(QueryRequest(rid=rid, profile=p))
    full.run()
    # At patience 2 the small index's beams reach their fixed points as
    # soon as their prefixes settle, so only patience 1 must save hops.
    saved = (full.plan.descent_stats["hop_queries"]
             - eng.plan.descent_stats["hop_queries"])
    assert saved > 0 if adaptive == 1 else saved >= 0


@pytest.mark.parametrize("shape", [(16, 12), (3, 16, 12)])
def test_slot_prefix_stable_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    beam = rng.integers(0, 5, size=shape).astype(np.int32)
    prev = beam[..., :4].copy()
    flip = rng.random(shape[:-1]) < 0.3
    prev[flip, 0] += 1
    stable, cur = search.slot_prefix_stable(torch.from_numpy(beam),
                                            torch.from_numpy(prev), k=4)
    r_stable, r_cur = r_search.slot_prefix_stable(
        jnp.asarray(beam), jnp.asarray(prev), k=4)
    np.testing.assert_array_equal(stable.numpy(), np.asarray(r_stable))
    np.testing.assert_array_equal(cur.numpy(), np.asarray(r_cur))
    assert not stable.all() and stable.any()


# -- PlanSpec ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(admission="edf"), dict(max_pending=-1), dict(max_pending=4),
    dict(adaptive=-1), dict(adaptive=2), dict(cache=-1),
    dict(resident_configs=-1), dict(resident_configs=2),
    dict(admission="slo", max_pending=4, batching="continuous", adaptive=2,
         cache=8, placement=2, resident_configs=2)])
def test_plan_spec_validates_as_reference(kw):
    try:
        want = RPlanSpec(**kw).describe()
    except ValueError:
        with pytest.raises(ValueError):
            PlanSpec(**kw)
    else:
        assert PlanSpec(**kw).describe() == want


# -- the CLI ----------------------------------------------------------------


def test_knn_serve_slo_cache_adaptive_matches_reference(artifact, capsys,
                                                        monkeypatch):
    """One SLO + cache + adaptive continuous serve through both CLIs: the
    same slo and cache lines, recall and counters, and the same served
    ids and sims rid by rid. Overflow shedding only: it does not depend
    on wall time."""
    flags = ["--index", str(artifact), "--dataset", "synth", "--scale",
             "0.05", "--queries", "24", "--k", "8", "--beam", "12",
             "--continuous", "--slots", "6", "--admission", "slo",
             "--max-pending", "10", "--priority-split", "0.25",
             "--adaptive", "1", "--cache", "16"]
    captured = []

    class Capture(RQueryEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(r_knn_serve, "QueryEngine", Capture)
    r_stats, r_recall = r_knn_serve.main(flags)
    r_out = capsys.readouterr().out
    stats, recall, engine = knn_serve.main(flags + ["--kernel", "--dma",
                                                    "--device", "cpu"])
    out = capsys.readouterr().out

    def lines(text, tag):
        return [x for x in text.splitlines() if x.startswith(tag)]

    for tag in ("[serve] slo:", "[serve] cache:"):
        assert lines(out, tag) == lines(r_out, tag) and lines(out, tag)
    assert "+ slo(max_pending=10), adaptive(1), cache(16)" in out
    assert recall == r_recall
    for key in ("requests", "served", "shed", "waves", "cache"):
        assert stats[key] == r_stats[key], key
    assert stats["shed"] == 24 - 6 - 10
    ref = captured[0]
    truth = {r.rid: r for r in ref.done}
    assert sorted(r.rid for r in engine.done) == sorted(truth)
    for r in engine.done:
        assert r.status == truth[r.rid].status
        if not r.rejected:
            np.testing.assert_array_equal(r.ids, truth[r.rid].ids)
            np.testing.assert_array_equal(r.sims, truth[r.rid].sims)
