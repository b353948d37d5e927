"""The readers of the program's own spans and counters
(``c2bench/program_spans.py`` and the metrics that use it) on planted
events and counters: values normalised per root span, None where a span,
a counter or ``repro_torch.obs`` itself is missing, device annotations
left out, and device idle given to the innermost program range."""
import sys

import pytest

from c2bench import harness, program_spans
from c2bench.tracing import Event, Trace

BUILD_METRICS = {"frh_hash_ms": "clustering.hash",
                 "frh_split_ms": "clustering.split",
                 "step2_pack_ms": "step2.pack",
                 "step2_wait_ms": "step2.wait",
                 "step2_scatter_ms": "step2.scatter"}
SERVE_METRICS = {"engine_step_ms": "serve.step",
                 "admit_fp_ms": "serve.admit.fingerprint",
                 "admit_route_ms": "serve.admit.route",
                 "hop_wait_ms": "serve.hop",
                 "complete_ms": "serve.complete"}
COUNTER_METRICS = ("build_copy_mb", "queue_wait_ms")


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"m_{name}")


def ev(name, start, end, on_device=False):
    return Event(name, start, end, on_device)


def trace_of(events):
    tr = Trace("cpu")
    tr.events = events
    tr.window_s = 1.0
    return tr


def build_events():
    """One build of 1,000 µs: hash 100, split 200, two Step-2 batches of
    pack 10 + wait 30 + scatter 5 each; each wait's kernel also shows as a
    device annotation spanning the kernel."""
    p = "repro_torch."
    out = [ev(p + "build", 0, 1000), ev(p + "clustering.hash", 0, 100),
           ev(p + "clustering.split", 100, 300)]
    for t in (400, 500):
        out += [ev(p + "step2.pack", t, t + 10),
                ev(p + "step2.wait", t + 10, t + 40),
                ev("knn_kernel", t + 12, t + 30, True),
                ev(p + "step2.wait", t + 12, t + 30),   # the annotation
                ev(p + "step2.scatter", t + 40, t + 45)]
    return out


def serve_events():
    """Two steps of 100 µs each (its spans 10, 20, 30 and 5 µs), and a
    stretch of the benchmark's own loop outside them."""
    p = "repro_torch."
    out = []
    for t in (0, 200):
        out += [ev(p + "serve.step", t, t + 100),
                ev(p + "serve.admit.fingerprint", t, t + 10),
                ev(p + "serve.admit.route", t + 10, t + 30),
                ev(p + "serve.hop", t + 30, t + 60),
                ev("descent_hop_dma_kernel", t + 35, t + 45, True),
                ev(p + "serve.hop", t + 35, t + 45),    # the annotation
                ev(p + "serve.complete", t + 60, t + 65)]
    return out + [ev("c2bench.tick.profiled", 100, 200)]


def test_ranges_leave_the_device_annotations_out():
    rs = program_spans.ranges(build_events())
    assert [r for r in rs if r[0] == "step2.wait"] == [
        ("step2.wait", 410, 440), ("step2.wait", 510, 540)]
    assert program_spans.ranges(None) == []


def test_span_readers_normalise_per_root_span():
    tr = trace_of(build_events())
    want = {"frh_hash_ms": 0.1, "frh_split_ms": 0.2, "step2_pack_ms": 0.02,
            "step2_wait_ms": 0.06, "step2_scatter_ms": 0.01}
    for name in BUILD_METRICS:
        assert reader(name).read(tr, None) == pytest.approx(want[name]), name
    # A second build halves every figure per build.
    tr = trace_of(build_events() + [ev("repro_torch.build", 2000, 3000)])
    assert reader("step2_wait_ms").read(tr, None) == pytest.approx(0.03)
    tr = trace_of(serve_events())
    want = {"engine_step_ms": 0.1, "admit_fp_ms": 0.01,
            "admit_route_ms": 0.02, "hop_wait_ms": 0.03,
            "complete_ms": 0.005}
    for name in SERVE_METRICS:
        assert reader(name).read(tr, None) == pytest.approx(want[name]), name


@pytest.mark.parametrize("name", sorted({**BUILD_METRICS, **SERVE_METRICS}))
def test_a_span_reader_reads_nothing_without_its_span_or_root(name):
    span = {**BUILD_METRICS, **SERVE_METRICS}[name]
    root = "build" if name in BUILD_METRICS else "serve.step"
    events = build_events() if name in BUILD_METRICS else serve_events()
    assert reader(name).read(trace_of(events), None) is not None
    for gone in {span, root}:
        left = [e for e in events if e.name != "repro_torch." + gone]
        assert reader(name).read(trace_of(left), None) is None, gone
    # The parent tree: no program ranges at all, or no capture.
    assert reader(name).read(trace_of(
        [e for e in events if not e.name.startswith("repro_torch.")]),
        None) is None
    assert reader(name).read(trace_of(None), None) is None


def test_counter_readers_normalise_per_build_and_per_admission(monkeypatch):
    from repro_torch import obs

    monkeypatch.setattr(obs, "_counts", {
        "build.calls": 2, "step2.h2d_bytes": 3e6, "step2.d2h_bytes": 1e6,
        "merge.h2d_bytes": 2e6, "merge.d2h_bytes": 2e6,
        "serve.admitted": 4, "serve.queue_wait_s": 0.2})
    tr = trace_of([])
    assert reader("build_copy_mb").read(tr, None) == pytest.approx(4.0)
    assert reader("queue_wait_ms").read(tr, None) == pytest.approx(50.0)


@pytest.mark.parametrize("name", COUNTER_METRICS)
def test_a_counter_reader_reads_nothing_without_its_counters(monkeypatch,
                                                              name):
    from repro_torch import obs

    tr = trace_of([])
    monkeypatch.setattr(obs, "_counts", {})
    assert reader(name).read(tr, None) is None
    monkeypatch.setattr(obs, "_counts", {"build.calls": 0,
                                         "step2.h2d_bytes": 5,
                                         "serve.admitted": 0,
                                         "serve.queue_wait_s": 1.0})
    assert reader(name).read(tr, None) is None
    # The parent tree: the program has no repro_torch.obs.
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert program_spans.counters() is None
    assert reader(name).read(tr, None) is None


def test_idle_goes_to_the_innermost_program_range():
    idle = program_spans.idle_by_span(build_events(), 1200e-6)
    # Device busy 412-430 and 512-530; the capture runs 0-1200 µs.
    assert idle == pytest.approx({
        "clustering.hash": 100e-6, "clustering.split": 200e-6,
        "build": 100e-6 + 55e-6 + 455e-6,
        "step2.pack": 20e-6, "step2.wait": 2 * (2e-6 + 10e-6),
        "step2.scatter": 10e-6, "outside": 200e-6})
    assert sum(idle.values()) == pytest.approx(1200e-6 - 36e-6)
    idle = program_spans.idle_by_span(serve_events(), 300e-6)
    assert idle == pytest.approx({
        "serve.admit.fingerprint": 20e-6, "serve.admit.route": 40e-6,
        "serve.hop": 2 * 20e-6, "serve.complete": 10e-6,
        "serve.step": 2 * 35e-6, "outside": 100e-6})
    assert program_spans.idle_by_span([], 1.0) == {}
