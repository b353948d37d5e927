#!/usr/bin/env python3
"""The benchmark of the port (``repro_torch``): one run of one cell.

    python3 c2bench/run.py --workload ml10M.build --seed 7 --seconds 51 \
        --trace 0

From the root of a checkout. Sets up the cell named in ``BENCHMARK.json``
from ``--seed``, measures ``--seconds``, checks what the timed path
produced against the plain reference in ``c2bench/reference/``, and
prints one JSON line last on standard output: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics from a traced run
(``--trace 1``). Each number the check compared is printed beside its
limit, as the last lines on standard error and as the line's last key.
Needs as many CUDA cards as the cell names; without them it exits 2 and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".c2bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Compiler caches at fixed paths inside the checkout. The port's own
    # kernels build under src/repro_torch/_build/, also inside it.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from c2bench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"c2bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg = harness.load_json(harness.BENCH / "configs"
                            / f"{cell['config']}.json")
    mix = harness.load_json(harness.BENCH / "traffic"
                            / f"{cell['traffic']}.json")
    res = harness.run_cell(bench, cell, cfg, mix, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"c2bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if "busy_s" in res:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in res["checks"]}
    print(f"c2bench: {args.workload}: {res['notes']}; setup "
          f"{time.perf_counter() - T_START:.1f} s into the run",
          file=sys.stderr)
    for c in res["checks"]:
        print(f"check {c.name}: {c.value} (limit {c.limit})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
