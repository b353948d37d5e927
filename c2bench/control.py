#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's, which the
judge has to refuse.

The configuration states float32 similarities (GoldFinger's ``inter /
union``); the control computes that epilogue in bfloat16. For each seed
this runs the cell as a run does (set-up from the seed, a short window at
the cell's own load) and judges the program (its readings are the lower
readings of each number compared). It then puts the control's output in
the place of what the window produced, the graph of every timed build or
the answer to every judged query, and judges that with the driver's own
judge (the upper readings), which has to come out as not correct.

    python3 c2bench/control.py --workload ml10M.build --seconds 5 \
        --seeds 11 12 13

Prints one JSON line per seed. Needs a CUDA card; the benchmark's own
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def put_in_place(driver, dtype) -> None:
    """Replace what the driver's window produced by the reference's output
    computed with its epilogue in ``dtype``."""
    from c2bench.reference import c2 as ref_c2
    from c2bench.reference import serve as ref_serve

    ctx, d = driver.ctx, driver.data
    low = ref_c2.build(d.items, d.offsets, ctx.cfg["c2"], ctx.device,
                       dtype=dtype)
    if hasattr(driver, "graphs"):
        driver.graphs = [(low.ids, low.sims)] * len(driver.graphs)
        return
    ids, sims = driver.reference_answers(
        ref_serve.index(low, ctx.cfg["c2"], ctx.device), dtype)
    driver.answers = (driver.answers[0], ids, sims)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from c2bench import harness

    if not torch.cuda.is_available():
        print("c2bench control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json(harness.BENCH / "configs"
                            / f"{cell['config']}.json")
    mix = harness.load_json(harness.BENCH / "traffic"
                            / f"{cell['traffic']}.json")
    for seed in args.seeds:
        driver = harness.make_driver(cell, cfg, mix, seed, "cuda")
        driver.setup()
        driver.window(args.seconds)
        driver.release()
        program = driver.judge()
        put_in_place(driver, torch.bfloat16)
        control = driver.judge()
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {c.name: c.value for c in program},
            "program_correct": all(c.ok for c in program),
            "control_bf16": {c.name: c.value for c in control},
            "control_correct": all(c.ok for c in control)}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
