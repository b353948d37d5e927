"""KNN-graph construction CLI with per-hash-configuration checkpointing
(torch port of ``repro.launch.knn_build``): each configuration's partial
KNN graph is an independent map task, and a restart skips configurations
already checkpointed.

    PYTHONPATH=src python -m repro_torch.launch.knn_build --dataset ml1M \
        --scale 1.0 --k 30 --index-out /tmp/ml1m.npz

Step 2 runs through the cluster-KNN CUDA kernel on ``--device cuda`` (the
default); without a card that raises at once. ``--device cpu`` runs the
plain PyTorch version. The ``--index-out`` artifact has the reference's
npz layout: either package's ``knn_serve`` loads it. ``--trace-out PATH``
runs the build under ``torch.profiler`` and writes its Chrome trace, with
the program's spans (``repro_torch.obs``), to PATH and the program's
counters to ``PATH.counters.json``. :func:`build` takes
``devices`` (one device an LPT bin, ``core/distributed``), the
counterpart of the reference's ``mesh=``; the CLI has no flag for it, as
in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from repro_torch import obs
from repro_torch.core.clustering import ClusterPlan, build_plan
from repro_torch.core.distributed import distributed_local_knn
from repro_torch.core.local_knn import local_knn
from repro_torch.core.merge import merge_partial
from repro_torch.core.params import C2Params, params_for
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.sketch.goldfinger import fingerprint_dataset
from repro_torch.types import NEG_INF, PAD_ID


def build(ds, params: C2Params, ckpt_dir: str | None = None,
          verbose: bool = True, gf=None, device="cuda", devices=None):
    """Build the C² graph configuration by configuration; returns (graph,
    plan). With ``devices``, each configuration's Step 2 runs one LPT bin
    per entry (``distributed_local_knn``: every cluster brute-forced, as
    the reference's mesh) and the merge runs on ``devices[0]``."""
    with obs.span("build"):
        obs.count("build.calls", 1)
        dev = resolve_device(device if devices is None else devices[0])
        if gf is None:
            gf = fingerprint_dataset(ds, n_bits=params.n_bits,
                                     seed=params.seed)
        plan = build_plan(ds, params, device=dev)
        t, n, k = params.t, ds.n_users, params.k
        with obs.span("build.partials"):
            ids = np.full((t, n, k), PAD_ID, dtype=np.int32)
            sims = np.full((t, n, k), NEG_INF, dtype=np.float32)

        done = set()
        cdir = Path(ckpt_dir) if ckpt_dir else None
        if cdir and cdir.exists():
            with obs.span("build.ckpt"):
                for f in cdir.glob("config_*.npz"):
                    i = int(f.stem.split("_")[1])
                    with np.load(f) as z:
                        ids[i], sims[i] = z["ids"], z["sims"]
                    done.add(i)
            if done and verbose:
                print(f"[knn] resuming: configs {sorted(done)} already done")

        for i in range(t):
            if i in done:
                continue
            t0 = time.time()
            with obs.span("build.partials"):
                # Restrict the plan to configuration i (independent map
                # task).
                sub_members = [m for m, c in zip(plan.members,
                                                 plan.config_of) if c == i]
                sub = ClusterPlan(
                    members=sub_members,
                    config_of=np.zeros(len(sub_members), dtype=np.int32),
                    n_users=n, t=1)
            if devices is not None:
                i1, s1, _ = distributed_local_knn(sub, gf, params, devices)
            else:
                i1, s1 = local_knn(sub, gf, params, device=dev)
            with obs.span("build.partials"):
                ids[i], sims[i] = i1[0], s1[0]
            if cdir:
                with obs.span("build.ckpt"):
                    cdir.mkdir(parents=True, exist_ok=True)
                    tmp = cdir / f".tmp_config_{i:03d}.npz"
                    np.savez(tmp, ids=ids[i], sims=sims[i])
                    tmp.rename(cdir / f"config_{i:03d}.npz")
            if verbose:
                print(f"[knn] config {i}: {time.time() - t0:.2f}s")
        graph = merge_partial(ids, sims, k, device=dev)
    return graph, plan


def main(argv=None):
    """Run the CLI; returns ``{"graph", "plan", "seconds", "index"}``
    (``index`` is None without ``--index-out``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ml1M")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-after-config", type=int, default=None)
    ap.add_argument("--index-out", default=None,
                    help="save a servable KNNIndex (.npz) for knn_serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for Step 2 and the merge "
                         "(cuda: the CUDA kernel; cpu: the plain version)")
    ap.add_argument("--trace-out", default=None,
                    help="profile the build (torch.profiler) and write its "
                         "Chrome trace here, the program's counters to "
                         "PATH.counters.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_dataset(args.dataset, scale=args.scale, seed=args.seed)
    params = params_for(args.dataset, k=args.k)
    if args.fail_after_config is not None:
        # Simulate a failure: run only the first m configs then exit.
        build(ds, dataclasses.replace(params, t=args.fail_after_config),
              ckpt_dir=args.ckpt_dir, device=dev)
        print("[knn] simulated failure after "
              f"{args.fail_after_config} configs")
        raise SystemExit(42)
    with obs.capture(args.trace_out, dev):
        t0 = time.time()
        gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
        graph, plan = build(ds, params, ckpt_dir=args.ckpt_dir, gf=gf,
                            device=dev)
        seconds = time.time() - t0
    print(f"[knn] built KNN graph for {ds.n_users} users in "
          f"{seconds:.2f}s "
          f"({plan.n_clusters} clusters, {plan.brute_force_sims()} sims)")
    print(f"[knn] avg_sim = {graph.avg_sim():.4f}")
    index = None
    if args.index_out:
        from repro_torch.query.index import build_index

        index = build_index(ds, params, graph=graph, plan=plan, gf=gf)
        index.save(args.index_out)
        print(f"[knn] servable index saved to {args.index_out} "
              f"(serve with: python -m repro_torch.launch.knn_serve "
              f"--index {args.index_out})")
    return {"graph": graph, "plan": plan, "seconds": seconds, "index": index}


if __name__ == "__main__":
    main()
