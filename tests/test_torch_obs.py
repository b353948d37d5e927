"""The port's spans and counters (``repro_torch.obs``) on the CPU.

With no profiler recording, a span is the shared no-op context and a count
changes nothing. Under ``torch.profiler`` a small build emits every build
span nested under ``repro_torch.build``, one ``step2.pack`` / ``wait`` /
``scatter`` per batch that ``group_batches`` yields, and copy counters
equal to the bytes of the arrays recomputed here; a continuous
``QueryEngine`` on a ``ManualClock`` emits every serve span under
``serve.step`` and a queue wait equal to the clock's arithmetic. Graphs
and answers are bitwise the same with the profiler on and off, and
``knn_build`` / ``knn_serve --trace-out`` write a Chrome trace and the
counters.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.clustering import ClusterPlan  # noqa: E402
from repro_torch.core.local_knn import group_batches  # noqa: E402
from repro_torch.core.params import params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_build, knn_serve  # noqa: E402
from repro_torch.query.engine import (QueryConfig, QueryEngine,  # noqa: E402
                                      QueryRequest)
from repro_torch.query.index import build_index  # noqa: E402
from repro_torch.sched import ManualClock  # noqa: E402

BUILD_SPANS = {"build", "sketch.fingerprint", "clustering.hash",
               "clustering.split", "build.partials", "step2.alloc",
               "step2.hyrec", "step2.upload", "step2.pack",
               "step2.wait", "step2.scatter", "merge"}
SERVE_SPANS = {"serve.step", "serve.sync", "serve.schedule",
               "serve.admit.fingerprint", "sketch.fingerprint",
               "serve.admit.route", "serve.admit.scatter", "serve.hop",
               "serve.complete", "serve.maintain"}


def _params(ds, k=10):
    return params_for("synth", k=k, b=max(64, ds.n_users // 16),
                      max_cluster=max(48, int(0.06 * ds.n_users)))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("synth", scale=0.1, seed=0)


def _profiled(fn):
    """(fn's result, the program's events, the counters) of one call under
    the profiler."""
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.events() if e.name.startswith(obs.PREFIX)]
    return out, events, obs.counters()


def _name(e):
    return e.name[len(obs.PREFIX):]


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def test_without_a_profiler_nothing_is_recorded():
    obs.reset()
    obs.count("x", 3)
    assert obs.counters() == {}
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b")
    with obs.span("a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.enabled()
        with obs.span("a"):
            obs.count("x", 3)
        obs.count("x", 0.5)
    assert obs.counters() == {"x": 3.5}
    assert [e.name for e in prof.events()
            if e.name.startswith(obs.PREFIX)] == ["repro_torch.a"]
    snapshot = obs.counters()
    snapshot["x"] = 0
    assert obs.counters() == {"x": 3.5}
    obs.reset()
    assert obs.counters() == {}


def test_a_build_emits_its_spans_nested_and_one_per_batch(ds):
    params = _params(ds)
    (graph, plan), events, _ = _profiled(
        lambda: knn_build.build(ds, params, device="cpu", verbose=False))
    names = [_name(e) for e in events]
    assert set(names) == BUILD_SPANS
    assert names.count("build") == 1
    for e in events:
        if _name(e) != "build":
            assert "repro_torch.build" in [p.name for p in _ancestors(e)]
    # Step 2's per-batch spans, as group_batches yields the batches of each
    # configuration's sub-plan.
    W = params.n_bits // 32
    n_batches = 0
    for i in range(params.t):
        sub = ClusterPlan(
            members=[m for m, c in zip(plan.members, plan.config_of)
                     if c == i],
            config_of=np.zeros(0, np.int32), n_users=ds.n_users, t=1)
        n_batches += len(list(group_batches(sub, W, params.bf_threshold)))
    assert n_batches > params.t
    for name in ("step2.pack", "step2.wait", "step2.scatter"):
        assert names.count(name) == n_batches, name
    for name in ("step2.upload", "step2.alloc", "step2.hyrec"):
        assert names.count(name) == params.t, name
    for name in ("clustering.hash", "clustering.split", "merge"):
        assert names.count(name) == 1, name


def test_the_copy_counters_are_the_bytes_of_the_arrays(ds):
    params = _params(ds)
    (graph, plan), _, counts = _profiled(
        lambda: knn_build.build(ds, params, device="cpu", verbose=False))
    t, n, k, W = params.t, ds.n_users, params.k, params.n_bits // 32
    h2d = d2h = 0
    for i in range(t):
        sub = ClusterPlan(
            members=[m for m, c in zip(plan.members, plan.config_of)
                     if c == i],
            config_of=np.zeros(0, np.int32), n_users=n, t=1)
        h2d += n * W * 4 + n * 4          # the fingerprint table, each call
        for cap, batch, mem in group_batches(sub, W, params.bf_threshold):
            h2d += mem.nbytes
            d2h += 2 * len(batch) * cap * k * 4   # ids and sims
    assert counts == {"build.calls": 1,
                      "step2.h2d_bytes": h2d, "step2.d2h_bytes": d2h,
                      "merge.h2d_bytes": 2 * t * n * k * 4,
                      "merge.d2h_bytes": 2 * n * k * 4}


def test_the_graph_is_the_same_with_the_profiler_on_and_off(ds):
    params = _params(ds)
    off, _ = knn_build.build(ds, params, device="cpu", verbose=False)
    (on, _), events, _ = _profiled(
        lambda: knn_build.build(ds, params, device="cpu", verbose=False))
    assert events
    assert np.array_equal(on.ids, off.ids)
    assert np.array_equal(on.sims.view(np.int32), off.sims.view(np.int32))


@pytest.fixture(scope="module")
def index(ds):
    return build_index(ds, _params(ds), device="cpu")


def _serve(index, profiled: bool):
    """A continuous engine of 6 slots on a ManualClock: 20 requests, five
    submitted before each of the first four ticks, one clock second a
    tick. Returns (engine, the requests, the clock at each one's
    admission by rid, events, counters)."""
    clock = ManualClock()
    eng = QueryEngine(index, QueryConfig(k=5, beam=8, hops=3,
                                         seeds_per_config=4, continuous=True,
                                         slots=6),
                      device="cpu", clock=clock)
    qds = make_dataset("synth", scale=0.1, seed=1)
    reqs = [QueryRequest(rid=r, profile=qds.profile(r)) for r in range(20)]
    admitted_at: dict[int, float] = {}

    def loop():
        tick = 0
        while tick < 4 or eng.busy():
            if tick < 4:
                for r in reqs[5 * tick:5 * tick + 5]:
                    eng.submit(r)
            clock.advance(1.0)
            now = clock()
            eng.step()
            sched = eng.plan.scheduler
            seen = [sched.occupant(s) for s in range(sched.n_slots)]
            for r in [r for r in seen if r is not None] + eng.done:
                admitted_at.setdefault(r.rid, now)
            tick += 1

    if profiled:
        _, events, counts = _profiled(loop)
    else:
        loop()
        events, counts = [], {}
    return eng, reqs, admitted_at, events, counts


def test_a_continuous_engine_emits_its_spans_and_queue_wait(index):
    eng, reqs, admitted_at, events, counts = _serve(index, profiled=True)
    names = [_name(e) for e in events]
    assert set(names) == SERVE_SPANS
    n_steps = names.count("serve.step")
    assert n_steps == counts["serve.steps"] > 4
    for e in events:
        if _name(e) != "serve.step":
            assert "repro_torch.serve.step" in [p.name
                                                for p in _ancestors(e)]
    assert len(eng.done) == len(reqs) == len(admitted_at)
    assert counts["serve.admitted"] == len(reqs)
    # Each request's wait: the clock at the tick that admitted it, less
    # the clock at its submission.
    want = sum(admitted_at[r.rid] - r.t_submit for r in reqs)
    assert want > len(reqs)          # some waited past their first tick
    assert counts["serve.queue_wait_s"] == pytest.approx(want, abs=1e-12)
    assert all(r.t_admit == admitted_at[r.rid] for r in reqs)


def test_the_answers_are_the_same_with_the_profiler_on_and_off(index):
    off = {r.rid: r for r in _serve(index, profiled=False)[1]}
    on = {r.rid: r for r in _serve(index, profiled=True)[1]}
    assert sorted(off) == sorted(on)
    for rid, r in on.items():
        assert np.array_equal(r.ids, off[rid].ids)
        assert np.array_equal(r.sims.view(np.int32),
                              off[rid].sims.view(np.int32))
        assert (r.t_admit, r.t_done) == (off[rid].t_admit, off[rid].t_done)


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_knn_build_trace_out_writes_the_trace_and_counters(tmp_path):
    out = tmp_path / "build.json"
    knn_build.main(["--dataset", "synth", "--scale", "0.05", "--k", "5",
                    "--device", "cpu", "--trace-out", str(out)])
    assert {"repro_torch." + s for s in BUILD_SPANS} <= _trace_names(out)
    with open(f"{out}.counters.json") as f:
        counts = json.load(f)
    assert counts["build.calls"] == 1 and counts["merge.h2d_bytes"] > 0


def test_knn_serve_trace_out_writes_the_trace_and_counters(tmp_path):
    out = tmp_path / "serve.json"
    knn_serve.main(["--dataset", "synth", "--scale", "0.05", "--queries",
                    "24", "--continuous", "--slots", "8", "--device", "cpu",
                    "--trace-out", str(out)])
    assert {"repro_torch." + s for s in SERVE_SPANS} <= _trace_names(out)
    with open(f"{out}.counters.json") as f:
        counts = json.load(f)
    assert counts["serve.admitted"] == 24 and counts["serve.steps"] > 0
