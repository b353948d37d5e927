"""Traffic kind ``build_loop``: full C² builds of one dataset, back to back.

One build is the call chain of ``repro_torch.launch.knn_build.main``:
``sketch.goldfinger.fingerprint_dataset``, then ``launch.knn_build.build``
on the card, from the dataset in host memory to the merged graph. The
program memoises neither plan nor graph, so every build does all the work.

Set-up makes the dataset from the seed and runs ``warmup_builds`` builds
(the first compiles the kernels in a fresh checkout). The window runs
builds until ``seconds`` have passed and finishes the build in flight;
``build_s`` is the window's elapsed time over the builds completed. In a
traced run the layers are spans (GoldFinger, clustering, Step 2 ending
in a synchronise, merge) and the window's first build is profiled.

The judge holds every timed build's graph, ids and sims of every user,
to the plain reference's build of the same dataset: the number of rows
that differ in any bit.
"""
from __future__ import annotations

import time

import numpy as np

from c2bench import data, roofline
from c2bench.reference import c2 as ref


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.graphs: list = []

    def setup(self):
        from repro_torch.core.params import C2Params
        from repro_torch.types import Dataset

        cfg, seed = self.ctx.cfg, self.ctx.seed
        self.data = data.make_data(cfg, seed, seed)
        self.ds = Dataset(name=cfg["name"], n_users=self.data.n_users,
                          n_items=self.data.n_items, items=self.data.items,
                          offsets=self.data.offsets)
        self.params = C2Params(**cfg["c2"])
        for _ in range(self.ctx.mix["warmup_builds"]):
            self.build()
        if self.ctx.trace is not None:
            self.ctx.trace.warm_profiler()

    def build(self):
        from repro_torch.launch import knn_build
        from repro_torch.sketch.goldfinger import fingerprint_dataset

        gf = fingerprint_dataset(self.ds, n_bits=self.params.n_bits,
                                 seed=self.params.seed)
        graph, _ = knn_build.build(self.ds, self.params, gf=gf,
                                   device=self.ctx.device, verbose=False)
        return graph

    def _traced_build(self, tr, profile: bool):
        from repro_torch.launch import knn_build
        from repro_torch.sketch import goldfinger

        restore = [tr.wrap(knn_build, "build_plan", "frh_cluster"),
                   tr.wrap(knn_build, "local_knn", "step2", sync=True),
                   tr.wrap(knn_build, "merge_partial", "merge"),
                   tr.wrap(goldfinger, "fingerprint_dataset", "goldfinger")]
        try:
            if profile:
                with tr.profile(), tr.span("build", sync=True):
                    return self.build()
            with tr.span("build", sync=True):
                return self.build()
        finally:
            for undo in restore:
                undo()

    def window(self, seconds: float) -> dict:
        tr = self.ctx.trace
        t0 = time.perf_counter()
        ends = []
        while True:
            if tr is None:
                graph = self.build()
            else:
                graph = self._traced_build(tr, profile=not self.graphs)
            self.graphs.append((graph.ids, graph.sims))
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        n = len(self.graphs)
        each = np.diff(np.r_[0.0, ends])
        return {"metrics": {"build_s": ends[-1] / n},
                "attempted": n, "failed": 0,
                "notes": f"{n} builds, s each: "
                         + " ".join(f"{x:.3f}" for x in each)}

    def release(self):
        import torch

        self.ds = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """Checks of every timed build's graph against the reference's."""
        from c2bench.harness import Check

        want = ref.build(self.data.items, self.data.offsets,
                         self.ctx.cfg["c2"], self.ctx.device)
        tr = self.ctx.trace
        if tr is not None:
            c2 = self.ctx.cfg["c2"]
            ops, nbytes = roofline.cluster_knn_work(
                want.plan.sizes, c2["n_bits"], c2["k"])
            tr.counters.update(cluster_knn_ops=ops, cluster_knn_bytes=nbytes)
        return [Check("graph_rows_differing",
                      float(sum(rows_differing(ids, sims, want.ids,
                                               want.sims)
                                for ids, sims in self.graphs)), 0.0)]


def rows_differing(ids, sims, want_ids, want_sims) -> int:
    """Users whose neighbour ids or sims differ in any bit."""
    ids = np.asarray(ids, dtype=np.int64)
    sims = np.ascontiguousarray(sims, dtype=np.float32).view(np.int32)
    ws = np.ascontiguousarray(want_sims, dtype=np.float32).view(np.int32)
    bad = (ids != want_ids).any(axis=1) | (sims != ws).any(axis=1)
    return int(bad.sum())
