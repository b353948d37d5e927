"""The harness on the CPU at a tiny size: cells and metrics found by name,
no forbidden imports, the reference equal to the port's CPU path, and
``correct`` false under the control and under each planted fault."""
import ast
import json
import shutil
import time

import numpy as np
import pytest
import torch

from c2bench import harness
from c2bench.reference import c2 as ref_c2

TINY = {"name": "tiny",
        "dataset": {"n_users": 600, "n_items": 400, "mean_profile": 30.0},
        "generator": {"zipf_a": 1.1, "n_topics": 6, "topic_affinity": 0.75},
        "c2": {"k": 10, "b": 64, "t": 4, "max_cluster": 60, "rho": 5,
               "n_bits": 256, "seed": 0, "split_depth": 6}}
MIXES = {
    "build_loop": {"kind": "build_loop", "warmup_builds": 1},
    "closed_loop_serve": {
        "kind": "closed_loop_serve", "clients": 48, "pool": 96,
        "judged": 64, "warmup_s": 0.1,
        "query": {"k": 5, "beam": 8, "hops": 3, "seeds_per_config": 4,
                  "continuous": True, "slots": 48, "kernel": True,
                  "dma": True}}}
SEED = 2**31 + 17


def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def run(cell_name, trace=False, seconds=0.3, where=harness.BENCH, b=None):
    b = b or bench()
    cell = harness.find_cell(b, cell_name)
    torch.manual_seed(0)
    return harness.run_cell(b, cell, TINY, MIXES[cell["traffic"]], SEED,
                            seconds, trace, "cpu", time.perf_counter(),
                            where=where)


def values(res):
    return {c.name: c.value for c in res["checks"]}


# -- found by name ------------------------------------------------------------

def test_every_entry_of_the_benchmark_has_its_files():
    b = bench()
    for cfg in b["configs"]:
        assert (harness.ROOT / cfg["file"]).exists()
    for cell in b["workloads"]:
        mix = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
        assert (harness.BENCH / "traffic" / f"{mix['kind']}.py").exists()
        assert (harness.BENCH / "configs" / f"{cell['config']}.json").exists()
    for m in b["per_layer"]:
        reader = harness.load_module(
            harness.BENCH / "metrics" / f"{m['name']}.py", "r")
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])


def test_a_cell_and_a_metric_added_as_files_alone_are_run(tmp_path):
    where = tmp_path / "c2bench"
    shutil.copytree(harness.BENCH, where,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (where / "traffic" / "short_build.json").write_text(json.dumps(
        {"kind": "build_loop", "warmup_builds": 0}))
    (where / "metrics" / "builds_traced.py").write_text(
        'LAYER = "sketch"\nUNIT = "builds"\nMOVES = "build_s"\n\n\n'
        'def read(trace, ctx):\n    return float(trace.count("build"))\n')
    b = bench()
    b["workloads"].append({"name": "tiny.short", "config": "tiny",
                           "traffic": "short_build", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "builds_traced", "unit": "builds",
                           "better": "higher", "source": "program_span",
                           "layer": "sketch", "moves": "build_s",
                           "workloads": ["tiny.short"]})
    for m in b["end_to_end"]:
        if m["name"] == "build_s":
            m["workloads"].append("tiny.short")
    cell = harness.find_cell(b, "tiny.short")
    mix = harness.load_json(where / "traffic" / "short_build.json")
    res = harness.run_cell(b, cell, TINY, mix, SEED, 0.2, True, "cpu",
                           time.perf_counter(), where=where)
    assert res["correct"]
    assert res["metrics"]["builds_traced"]["value"] >= 1
    res = harness.run_cell(b, cell, TINY, mix, SEED, 0.2, False, "cpu",
                           time.perf_counter(), where=where)
    assert set(res["metrics"]) == {"build_s", "setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = list(harness.BENCH.rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path))
        assert not found & {"jax", "jaxlib", "flax", "repro"}, path
        if path.name != "test_c2bench_harness.py":
            assert "benchmarks/" not in path.read_text(), path
        if "reference" in path.parts:
            assert "repro_torch" not in found, path


# -- the reference against the port's CPU path -------------------------------

def test_the_reference_build_equals_the_port_and_splits_and_ties_occur():
    from repro_torch.core.params import C2Params
    from repro_torch.launch import knn_build
    from repro_torch.sketch.goldfinger import fingerprint_dataset
    from repro_torch.types import Dataset

    from c2bench import data

    d = data.make_data(TINY, 5, 5)
    ds = Dataset(name="tiny", n_users=d.n_users, n_items=d.n_items,
                 items=d.items, offsets=d.offsets)
    params = C2Params(**TINY["c2"])
    gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
    graph, plan = knn_build.build(ds, params, gf=gf, device="cpu",
                                  verbose=False)
    want = ref_c2.build(d.items, d.offsets, TINY["c2"], "cpu")
    assert np.array_equal(ref_c2.to_words(want.bits), gf.words)
    assert sorted(map(tuple, map(sorted, plan.members))) == sorted(
        map(tuple, map(sorted, want.plan.members)))
    assert np.array_equal(graph.ids, want.ids)
    assert np.array_equal(graph.sims.view(np.int32),
                          want.sims.view(np.int32))
    # The dataset exercises what the exact comparison has to hold.
    assert max(len(p) for p in want.plan.paths) > 1
    ties = (np.diff(want.sims, axis=1) == 0) & np.isfinite(want.sims[:, 1:])
    assert ties.any()


@pytest.mark.parametrize("cell", ["ml10M.build", "ml10M.serve"])
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], values(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(v == 0 for v in values(res).values())


@pytest.mark.parametrize("cell", ["ml10M.build", "ml10M.serve"])
def test_a_traced_run_reports_its_per_layer_metrics(cell):
    res = run(cell, trace=True, seconds=2.0)
    assert res["correct"]
    want = {m["name"] for m in harness.cell_metrics(bench(), cell,
                                                    "per_layer")}
    # The CPU has no device trace: the device readers give nothing.
    cpu_only = {m for m in want if "roofline" in m or "idle" in m}
    assert set(res["metrics"]) == want - cpu_only
    assert "breakdown" in res


@pytest.mark.parametrize("metric,span", [
    ("goldfinger_ms", "goldfinger"), ("frh_cluster_ms", "frh_cluster"),
    ("step2_ms", "step2"), ("merge_ms", "merge")])
def test_a_span_reader_reads_nothing_where_its_span_never_fired(metric,
                                                                span):
    from c2bench.tracing import Trace

    tr = Trace("cpu")
    tr.spans = {name: [0.5] for name in
                ("build", "goldfinger", "frh_cluster", "step2", "merge")}
    reader = harness.load_module(harness.BENCH / "metrics" / f"{metric}.py",
                                 f"m_{metric}")
    assert reader.read(tr, None) == pytest.approx(500.0)
    del tr.spans[span]
    assert reader.read(tr, None) is None


def test_a_layer_reached_under_another_name_is_left_out(monkeypatch):
    """Where the program reaches Step 2 without the name the harness
    wraps, ``step2_ms`` is left out of the line, not read as 0."""
    from repro_torch.launch import knn_build

    original_build, original_step2 = knn_build.build, knn_build.local_knn

    def build(*args, **kwargs):
        wrapped = knn_build.local_knn
        knn_build.local_knn = original_step2
        try:
            return original_build(*args, **kwargs)
        finally:
            knn_build.local_knn = wrapped

    monkeypatch.setattr(knn_build, "build", build)
    res = run("ml10M.build", trace=True, seconds=1.0)
    assert res["correct"]
    assert "step2_ms" not in res["metrics"]
    assert {"goldfinger_ms", "frh_cluster_ms", "merge_ms"} <= set(
        res["metrics"])


def test_profiled_ticks_are_kept_apart_and_the_judged_answers_sampled():
    c = harness.find_cell(bench(), "ml10M.serve")
    mix = dict(MIXES["closed_loop_serve"], judged=40)
    driver = harness.make_driver(c, TINY, mix, SEED, "cpu", trace=True)
    driver.setup()
    window = driver.window(1.0)
    driver.release()
    tr = driver.ctx.trace
    assert tr.events is not None
    assert tr.count("tick.profiled") > 0 and tr.count("tick") > 0
    assert len(driver.answers[0]) == 40 < window["attempted"]
    assert all(ch.ok for ch in driver.judge())


# -- the control and the faults -----------------------------------------------

@pytest.mark.parametrize("cell", ["ml10M.build", "ml10M.serve"])
def test_the_bfloat16_control_is_refused(cell):
    from c2bench import control

    b = bench()
    c = harness.find_cell(b, cell)
    driver = harness.make_driver(c, TINY, MIXES[c["traffic"]], SEED, "cpu")
    driver.setup()
    driver.window(0.3)
    driver.release()
    assert all(ch.ok for ch in driver.judge())
    control.put_in_place(driver, torch.bfloat16)
    checks = driver.judge()
    assert not all(ch.ok for ch in checks), checks


def _alter_one_sim(graph_fn):
    def altered(*args, **kwargs):
        g = graph_fn(*args, **kwargs)
        g.sims[3, 0] = np.nextafter(g.sims[3, 0], np.float32(2))
        return g
    return altered


def _half_batch(fn):
    def half(words, card, member_ids, k):
        ids, sims = fn(words, card, member_ids, k)
        m = ids.shape[0]
        ids[m // 2:] = -1
        sims[m // 2:] = float("-inf")
        return ids, sims
    return half


def _unchanged(fn):
    def same(graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
             beam_sims, active, **kw):
        _, _, changed, stats = fn(graph_ids, rev_ids, words, card, q_words,
                                  q_card, beam_ids, beam_sims, active, **kw)
        return beam_ids, beam_sims, changed & False, stats
    return same


def _half_slots(fn):
    def half(graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
             beam_sims, active, **kw):
        ids, sims, changed, stats = fn(graph_ids, rev_ids, words, card,
                                       q_words, q_card, beam_ids, beam_sims,
                                       active, **kw)
        h = ids.shape[0] // 2
        ids = torch.cat([ids[:h], beam_ids[h:]])
        sims = torch.cat([sims[:h], beam_sims[h:]])
        return ids, sims, changed, stats
    return half


def _altered_answer(fn):
    def altered(self, st):
        ids, sims = fn(self, st)
        sims = sims.copy()
        sims[:, 0] = sims[:, 0] * np.float32(0.5)
        return ids, sims
    return altered


def _faults():
    from repro_torch.core import local_knn
    from repro_torch.launch import knn_build
    from repro_torch.query import plan

    return {
        ("ml10M.build", "answer altered where produced"):
            (knn_build, "merge_partial", _alter_one_sim),
        ("ml10M.build", "half of each Step-2 batch left out"):
            (local_knn.gk_ops, "cluster_knn", _half_batch),
        ("ml10M.build", "Step 2 returns its state unchanged"):
            (knn_build, "local_knn",
             lambda fn: lambda plan_, gf, params, device="cuda": (
                 np.full((plan_.t, plan_.n_users, params.k), -1, np.int32),
                 np.full((plan_.t, plan_.n_users, params.k), -np.inf,
                         np.float32))),
        ("ml10M.serve", "a hop returns its state unchanged"):
            (plan, "slot_hop", _unchanged),
        ("ml10M.serve", "half of the slots left out of each hop"):
            (plan, "slot_hop", _half_slots),
        ("ml10M.serve", "answer altered where produced"):
            (plan.DescentPlan, "_slot_results", _altered_answer),
    }


FAULTS = [("ml10M.build", "answer altered where produced"),
          ("ml10M.build", "half of each Step-2 batch left out"),
          ("ml10M.build", "Step 2 returns its state unchanged"),
          ("ml10M.serve", "a hop returns its state unchanged"),
          ("ml10M.serve", "half of the slots left out of each hop"),
          ("ml10M.serve", "answer altered where produced")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_refused(monkeypatch, cell, fault):
    owner, attr, breaker = _faults()[(cell, fault)]
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    res = run(cell)
    assert not res["correct"], values(res)


# -- on the card --------------------------------------------------------------

@pytest.mark.card
def test_the_cli_runs_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "AM.build", "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_the_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "AM.build", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_trace_reductions():
    from c2bench.tracing import Event, busy_s, idle_gaps, kernel_s

    ev = [Event("c2bench.build", 0, 100, False),
          Event("c2bench.goldfinger", 0, 30, False),
          Event("c2bench.frh_cluster", 30, 80, False),
          Event("knn_kernel<8>", 80, 90, True),
          Event("copy", 85, 95, True)]
    assert busy_s(ev) == pytest.approx(15e-6)
    assert kernel_s(ev, "knn_kernel") == pytest.approx(10e-6)
    assert kernel_s(ev, "hop") is None
    gaps = dict(idle_gaps(ev, 100e-6))
    assert gaps == pytest.approx({"frh_cluster": 50e-6, "goldfinger": 30e-6,
                                  "build": 5e-6})
