"""One run of one cell: set up, measure a window, judge, report.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; ``configs/<config>.json`` holds the
deployment, ``traffic/<mix>.json`` the mix's parameters and its ``kind``,
``traffic/<kind>.py`` the driver of that kind, and ``metrics/<name>.py``
the reader of each per-layer metric. A driver module defines
``Driver(ctx)`` with ``setup()``, ``window(seconds)``, ``release()`` and
``judge()``; a reader module defines ``read(trace, ctx)``, which returns a
number or None where its cell gives it nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from c2bench import tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names a run must not have loaded (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold
    dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those listing it, or listing no cells at all."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, its configuration and mix, the
    run's seed, the device and, in a traced run, the trace."""
    cell: str
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    trace: tracing.Trace | None


@dataclasses.dataclass
class Check:
    """One number the judge compared, with its limit (passes at or below
    it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def make_driver(cell: dict, cfg: dict, mix: dict, seed: int, device,
                trace: bool = False, where: Path = BENCH):
    """The cell's driver, from ``<where>/traffic/<kind>.py``."""
    device = torch.device(device)
    ctx = Context(cell=cell["name"], cfg=cfg, mix=mix, seed=seed,
                  device=device,
                  trace=tracing.Trace(device) if trace else None)
    kind = mix["kind"]
    return load_module(where / "traffic" / f"{kind}.py",
                       f"c2bench_traffic_{kind}").Driver(ctx)


def run_cell(bench: dict, cell: dict, cfg: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             where: Path = BENCH) -> dict:
    """Set up, measure and judge one run; returns the result's fields.
    Drivers and readers are looked up under ``where``."""
    driver = make_driver(cell, cfg, mix, seed, device, trace, where)
    ctx, tr = driver.ctx, driver.ctx.trace
    device = ctx.device
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    window = driver.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    driver.release()
    t_judge = time.perf_counter()
    checks = driver.judge()
    t_judge = time.perf_counter() - t_judge
    metrics: dict[str, dict] = {}
    if tr is None:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            reader = load_module(where / "metrics" / f"{m['name']}.py",
                                 f"c2bench_metric_{m['name']}")
            value = reader.read(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(c.ok for c in checks),
           "attempted": window["attempted"], "failed": window["failed"],
           "metrics": metrics, "checks": checks, "memory_peak_bytes": peak,
           "notes": f"{window.get('notes', '')}; judged in {t_judge:.1f} s"}
    if tr is not None and tr.events is not None:
        out["busy_s"] = tracing.busy_s(tr.events)
        out["window_s"] = tr.window_s
        out["breakdown"] = {
            "device_ops": tracing.top_device_ops(tr.events),
            "idle_gaps": tracing.idle_gaps(tr.events, tr.window_s)}
    return out
