"""The port's continuous batching held bitwise against the JAX reference.

Continuous == wave inside the port for every scorer (plain hop, fused
hop, DMA hop); the port's continuous engine against ``repro``'s tick by
tick (ids, sims, the requests each tick completes, and the descent
statistics, DMA byte counters included); streaming submission between
ticks; per-request hop budgets; slot recycling in FIFO order; the
``knn_serve --continuous --kernel --dma`` CLI; and the slot scheduler's
invariants under random interleavings.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro_torch.core.params import C2Params, params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import build_index  # noqa: E402
from repro_torch.sched import SlotScheduler  # noqa: E402

K, BEAM, HOPS = 10, 16, 3
SCORERS = {"jnp": {}, "pallas": {"kernel": True},
           "pallas_dma": {"kernel": True, "dma": True}}


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """synth@0.1 (400 users) built by the port the way knn_serve builds,
    and the same artifact loaded by the reference (the two packages'
    builds are equal bitwise: test_torch_serve.py)."""
    ds = make_dataset("synth", scale=0.1, seed=0)
    port = build_index(ds, params_for(
        "synth", k=10, b=max(64, ds.n_users // 16),
        max_cluster=max(48, int(0.06 * ds.n_users))), device="cpu")
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    port.save(path)
    return port, RIndex.load(path), path


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """synth@0.05 (200 users): small enough for the reference's DMA hop in
    interpret mode."""
    port = build_index(make_dataset("synth", scale=0.05, seed=3),
                       C2Params(k=8, b=64, t=4, max_cluster=48),
                       device="cpu")
    path = tmp_path_factory.mktemp("ix") / "small.npz"
    port.save(path)
    return port, RIndex.load(path)


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.1, seed=77)
    return [qds.profile(u) for u in range(48)]


def _submit_all(engine, request_cls, profiles, hops=None):
    for rid, p in enumerate(profiles):
        engine.submit(request_cls(rid=rid, profile=p,
                                  hops=None if hops is None else hops[rid]))


def _by_rid(engine):
    done = sorted(engine.done, key=lambda r: r.rid)
    return (np.stack([r.ids for r in done]), np.stack([r.sims for r in done]),
            [r.rid for r in done])


def _run_by_step(engine):
    """Drain step by step; the sorted rids each step completed."""
    steps = []
    while engine.busy():
        before = len(engine.done)
        engine.step()
        steps.append(sorted(r.rid for r in engine.done[before:]))
    return steps


@pytest.fixture(scope="module")
def wave_truth(indexes, profiles):
    """The reference's plain wave over the 48 queries."""
    _, ref, _ = indexes
    eng = RQueryEngine(ref, RQueryConfig(k=K, beam=BEAM, hops=HOPS,
                                         max_wave=64))
    _submit_all(eng, RQueryRequest, profiles)
    eng.run()
    return _by_rid(eng)


@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_continuous_matches_wave(indexes, profiles, wave_truth, scorer):
    """Streaming admission changes no result: the port's continuous run
    (7 slots, several admission generations) equals its wave run and the
    reference's wave, per request, for every scorer."""
    port, _, _ = indexes
    runs = {}
    for batching in ({"max_wave": 64}, {"continuous": True, "slots": 7}):
        eng = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=HOPS,
                                            **batching, **SCORERS[scorer]),
                          device="cpu")
        _submit_all(eng, QueryRequest, profiles)
        stats = eng.run()
        runs[stats["mode"]] = (stats, _by_rid(eng))
    c_stats, (c_ids, c_sims, c_rids) = runs["continuous"]
    w_stats, (w_ids, w_sims, _) = runs["wave"]
    assert c_rids == list(range(len(profiles)))
    assert c_stats["waves"] > HOPS and w_stats["waves"] == 1
    assert c_stats["plan"] == f"single x continuous(slots=7) x {scorer}"
    for ids, sims in ((w_ids, w_sims), wave_truth[:2]):
        np.testing.assert_array_equal(c_ids, ids)
        np.testing.assert_array_equal(c_sims, sims)
    if scorer != "jnp":
        W = port.words.shape[1]
        for d in (c_stats["descent"], w_stats["descent"]):
            assert d["scored_lanes"] > 0
            assert d["dma_bytes"] == (d["scored_lanes"] * W * 4
                                      if scorer == "pallas_dma" else 0)


@pytest.mark.parametrize("scorer", ["jnp", "pallas"])
def test_continuous_matches_reference_tick_by_tick(indexes, profiles, scorer):
    """The port's continuous engine against repro's: the same requests
    complete at each tick, with the same ids, sims and descent stats."""
    port, ref, _ = indexes
    kw = dict(k=K, beam=BEAM, hops=HOPS, continuous=True, slots=9,
              **SCORERS[scorer])
    r_eng = RQueryEngine(ref, RQueryConfig(**kw))
    t_eng = QueryEngine(port, QueryConfig(**kw), device="cpu")
    _submit_all(r_eng, RQueryRequest, profiles)
    _submit_all(t_eng, QueryRequest, profiles)
    r_steps, t_steps = _run_by_step(r_eng), _run_by_step(t_eng)
    assert t_steps == r_steps
    assert t_eng.n_ticks == r_eng.n_ticks
    for a, b in zip(_by_rid(r_eng), _by_rid(t_eng)):
        np.testing.assert_array_equal(a, b)
    assert t_eng.plan.descent_stats == r_eng.plan.descent_stats


@pytest.mark.parametrize("batching", [{"max_wave": 4},
                                      {"continuous": True, "slots": 3}],
                         ids=["wave", "continuous"])
def test_dma_serving_matches_reference(small, batching):
    """Scorer pallas_dma under both batchings against repro's (its DMA hop
    in interpret mode): ids, sims, the requests each step completes, and
    every descent counter, the byte counters included."""
    port, ref = small
    qds = make_dataset("synth", scale=0.05, seed=77)
    profiles = [qds.profile(u) for u in range(10)]
    kw = dict(k=8, beam=12, hops=2, kernel=True, dma=True, **batching)
    r_eng = RQueryEngine(ref, RQueryConfig(**kw))
    t_eng = QueryEngine(port, QueryConfig(**kw), device="cpu")
    _submit_all(r_eng, RQueryRequest, profiles)
    _submit_all(t_eng, QueryRequest, profiles)
    assert _run_by_step(t_eng) == _run_by_step(r_eng)
    for a, b in zip(_by_rid(r_eng), _by_rid(t_eng)):
        np.testing.assert_array_equal(a, b)
    d = t_eng.plan.descent_stats
    assert d == r_eng.plan.descent_stats
    assert d["bytes_saved"] > 0
    assert d["dma_bytes"] == d["scored_lanes"] * port.words.shape[1] * 4


def test_streaming_submission(indexes, profiles, wave_truth):
    """Requests submitted between ticks enter freed slots and get the
    wave's results."""
    port, _, _ = indexes
    eng = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=HOPS,
                                        continuous=True, slots=5,
                                        kernel=True, dma=True), device="cpu")
    pending = list(enumerate(profiles))

    def drip(engine, tick):
        for rid, p in pending[:2]:
            engine.submit(QueryRequest(rid=rid, profile=p))
        del pending[:2]

    rid, p = pending.pop(0)
    eng.submit(QueryRequest(rid=rid, profile=p))
    eng.run(on_tick=drip)
    assert not pending
    ids, sims, rids = _by_rid(eng)
    assert rids == list(range(len(profiles)))
    np.testing.assert_array_equal(ids, wave_truth[0])
    np.testing.assert_array_equal(sims, wave_truth[1])


def test_per_request_hop_budgets(indexes, profiles):
    """Each request is served at its own budget: it equals a uniform wave
    at that budget; a mixed wave runs to its deepest member's budget."""
    port, _, _ = indexes
    deep = 2 * HOPS
    budgets = [deep if rid % 3 == 0 else (0 if rid % 5 == 0 else HOPS)
               for rid in range(len(profiles))]
    truth = {}
    for hops in (0, HOPS, deep):
        eng = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=hops,
                                            max_wave=64), device="cpu")
        _submit_all(eng, QueryRequest, profiles)
        eng.run()
        truth[hops] = _by_rid(eng)
    cont = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=HOPS,
                                         continuous=True, slots=6,
                                         kernel=True), device="cpu")
    _submit_all(cont, QueryRequest, profiles, hops=budgets)
    cont.run()
    assert len(cont.done) == len(profiles)
    for r in cont.done:
        want = truth[budgets[r.rid]]
        np.testing.assert_array_equal(r.ids, want[0][r.rid])
        np.testing.assert_array_equal(r.sims, want[1][r.rid])
    mixed = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=HOPS,
                                          max_wave=64), device="cpu")
    _submit_all(mixed, QueryRequest, profiles, hops=budgets)
    mixed.run()
    ids, sims, _ = _by_rid(mixed)
    np.testing.assert_array_equal(ids, truth[deep][0])
    np.testing.assert_array_equal(sims, truth[deep][1])


def test_slot_recycling_in_fifo_order(indexes, profiles, monkeypatch):
    """Three slots serve eleven requests: slots free mid-stream and are
    reused lowest first, requests enter in submission order, and each
    completes exactly once."""
    port, _, _ = indexes
    admitted = []
    admit = SlotScheduler.admit

    def recording_admit(self):
        out = admit(self)
        admitted.extend((slot, req.rid) for slot, req in out)
        return out

    monkeypatch.setattr(SlotScheduler, "admit", recording_admit)
    eng = QueryEngine(port, QueryConfig(k=K, beam=BEAM, hops=HOPS,
                                        continuous=True, slots=3),
                      device="cpu")
    _submit_all(eng, QueryRequest, profiles[:11])
    while eng.busy():
        eng.tick()
    sched = eng.plan.scheduler
    sched.check_invariants()
    assert sched.n_submitted == sched.n_admitted == sched.n_completed == 11
    assert not sched.has_work()
    assert [rid for _, rid in admitted] == list(range(11))
    assert [slot for slot, _ in admitted[:3]] == [0, 1, 2]
    assert max(slot for slot, _ in admitted) == 2
    assert sorted(r.rid for r in eng.done) == list(range(11))
    with pytest.raises(ValueError, match="continuous"):
        QueryEngine(port, QueryConfig(), device="cpu").tick()


def test_knn_serve_continuous_dma_cli(indexes, capsys):
    _, _, path = indexes
    stats, recall, engine = knn_serve.main(
        ["--index", str(path), "--dataset", "synth", "--scale", "0.1",
         "--queries", "40", "--continuous", "--slots", "16", "--kernel",
         "--dma", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "single x continuous(slots=16) x pallas_dma" in out
    assert " ticks (continuous)" in out
    assert "MB moved" in out and "of gather traffic" in out
    assert stats["requests"] == 40 and stats["mode"] == "continuous"
    assert 0.5 < recall <= 1.0
    with pytest.raises(ValueError, match="kernel"):
        knn_serve.main(["--dma", "--device", "cpu"])


# -- the slot scheduler -------------------------------------------------------


def test_scheduler_outside_slice_raises():
    # SLO admission is ported (test_torch_slo.py holds it against the
    # reference); what stays refused is what the reference refuses.
    assert SlotScheduler(4, policy="slo", max_pending=8).policy == "slo"
    with pytest.raises(ValueError, match="policy"):
        SlotScheduler(4, policy="edf")
    with pytest.raises(ValueError, match="max_pending"):
        SlotScheduler(4, max_pending=-1)
    with pytest.raises(ValueError):
        SlotScheduler(0)


def test_scheduler_invariants_under_random_interleavings():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    ops = st.lists(st.one_of(st.tuples(st.just("submit")),
                             st.tuples(st.just("release"),
                                       st.integers(0, 63))),
                   min_size=1, max_size=120)

    @settings(max_examples=150, deadline=None, database=None)
    @given(n_slots=st.integers(1, 9), ops=ops, admit_every=st.integers(1, 4))
    def battery(n_slots, ops, admit_every):
        sched = SlotScheduler(n_slots)
        next_id = 0
        admitted_order, completed = [], []
        slot_of = {}

        def admit():
            for slot, item in sched.admit():
                assert slot not in slot_of.values()
                slot_of[item] = slot
                admitted_order.append(item)
            np.testing.assert_array_equal(
                sched.active_mask(),
                np.isin(np.arange(n_slots), list(slot_of.values())))

        for step, op in enumerate(ops):
            if op[0] == "submit":
                sched.submit(next_id)
                next_id += 1
            else:
                active = sched.active_slots
                if active:
                    slot = active[op[1] % len(active)]
                    item = sched.release(slot)
                    completed.append(item)
                    assert slot_of.pop(item) == slot
            if step % admit_every == 0:
                admit()
            sched.check_invariants()
        while sched.has_work():
            admit()
            done = sched.release_many(sched.active_slots)
            for item in done:
                slot_of.pop(item)
            completed.extend(done)
            sched.check_invariants()
        assert admitted_order == sorted(admitted_order)
        assert sorted(completed) == list(range(next_id))
        assert sched.n_submitted == sched.n_completed == next_id

    battery()
