"""Device time of the main path's Step-2 sweep on the card.

    PYTHONPATH=src python3 -m repro_torch.bench.step2_sweep [--label L]

Builds the ml1M@1.0 paper plan (k = 30), gathers its Step-2 batches as
the build does (one call of ``group_batches`` per hash configuration: 46
batches of W = 32 words), holds each kernel call bitwise against the
plain version, then times the whole sweep of cluster-KNN launches (a
sleep kernel holds the card while they are queued, so the events span
device time alone; median of 7) and prints one line.

``chip_smoke.py`` gathers the main path's batches with
:func:`main_path_batches`. The script uses only names every tree of the
port has had since its first slice, so another checkout runs it from its
own package: give that checkout's
``src`` on ``PYTHONPATH`` and run this file by path, e.g. the parent
commit unpacked by ``git archive`` into the git-ignored ``chip_tmp/``,
in turns with this tree: ``PYTHONPATH=chip_tmp/parent/src python3
src/repro_torch/bench/step2_sweep.py --label parent``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.core.clustering import ClusterPlan, build_plan
from repro_torch.core.local_knn import batch_inputs, group_batches
from repro_torch.core.params import params_for
from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build
from repro_torch.kernels.goldfinger_knn import ops, ref
from repro_torch.sketch.goldfinger import fingerprint_dataset, words_tensor

SLEEP_CYCLES = 50_000_000  # ~25 ms: longer than queueing the sweep takes
K = 30


def main_path_batches(plan, words, card):
    """The Step-2 batches of ``plan`` as ``knn_build`` gathers them: one
    ``group_batches`` call per hash configuration (one map task each).
    Yields ``(cap, members, (words, card, ids))`` per batch."""
    for i in range(plan.t):
        members = [m for m, c in zip(plan.members, plan.config_of) if c == i]
        sub = ClusterPlan(members=members,
                          config_of=np.zeros(len(members), np.int32),
                          n_users=plan.n_users, t=1)
        for cap, _, mem in group_batches(sub, words.shape[1]):
            yield cap, mem, batch_inputs(words, card, mem)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    build.build(("goldfinger_knn",))
    t_build = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    ds = make_dataset("ml1M", scale=1.0, seed=0)
    params = params_for("ml1M", k=K)
    gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
    plan = build_plan(ds, params)
    batches = [b for _, _, b in main_path_batches(
        plan, words_tensor(gf.words, dev), torch.from_numpy(gf.card).to(dev))]

    def sweep():
        return [ops.cluster_knn(w, c, i, K) for w, c, i in batches]

    for (ids, sims), (w, c, i) in zip(sweep(), batches):
        p_ids, p_sims = ref.cluster_knn_ref(w, c, i, K)
        if not (torch.equal(ids, p_ids) and torch.equal(sims, p_sims)):
            raise SystemExit("step2_sweep: a batch differs from the plain "
                             "version")
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sweep()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    print(f"[step2] {args.label}: {len(batches)} launches bitwise equal to "
          f"the plain version, device ms median "
          f"{statistics.median(times):.4f} (min {min(times):.4f}) on "
          f"{torch.cuda.get_device_name(0)}; build {t_build:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
