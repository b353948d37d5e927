"""Traffic kind ``closed_loop_serve``: unseen profiles served by
``repro_torch.query.engine.QueryEngine`` in continuous slots, from a closed
loop of ``clients`` clients, each sending its next query as soon as its
last one completes.

Set-up makes the dataset from the seed, builds its C² graph on the card
and packages the index in memory (``query.index.build_index``), makes a
pool of ``pool`` unseen profiles over the same item universe from a user
stream of their own, and runs the loop for ``warmup_s`` seconds, so the
slots are full when the window opens. Queries take the pool's profiles
in a seeded order, cycling through it: the pool is sized past the
queries a run sends, so no profile is asked twice in a run at today's
rates.

The window counts the queries submitted in it and completed in it:
``serve_qps`` is their number over the window's time; the 95th
percentile of their latencies, each from submission to completion, is a
per-layer metric of the traced run (its spread across runs would need a
bound above 0.25). In the traced run the profiler holds a stretch of
ticks; their spans go under ``tick.profiled``, and the queries in flight
during it are left out of that percentile. After the window the loop
stops submitting and serves until every query submitted in the window
has completed (at most a minute).

The judge holds ``judged`` answers of queries submitted in the window,
drawn from the seed once the window has closed, ids and sims, to the
plain reference's routing and descent over its own build and index of
the same dataset; every query submitted in the window has to have been
answered.
"""
from __future__ import annotations

import time

import numpy as np

from c2bench import data, roofline
from c2bench.reference import c2 as ref_c2
from c2bench.reference import serve as ref_serve

DRAIN_S = 60.0


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        from repro_torch.core.params import C2Params
        from repro_torch.launch import knn_build
        from repro_torch.query.engine import QueryConfig, QueryEngine
        from repro_torch.query.index import build_index
        from repro_torch.sketch.goldfinger import fingerprint_dataset
        from repro_torch.types import Dataset

        cfg, mix, seed = self.ctx.cfg, self.ctx.mix, self.ctx.seed
        self.data = data.make_data(cfg, seed, seed)
        ds = Dataset(name=cfg["name"], n_users=self.data.n_users,
                     n_items=self.data.n_items, items=self.data.items,
                     offsets=self.data.offsets)
        params = C2Params(**cfg["c2"])
        gf = fingerprint_dataset(ds, n_bits=params.n_bits, seed=params.seed)
        graph, plan = knn_build.build(ds, params, gf=gf,
                                      device=self.ctx.device, verbose=False)
        index = build_index(ds, params, gf=gf, plan=plan, graph=graph)
        # Unseen users: the same item universe, another user stream.
        self.pool = data.make_data(cfg, seed, seed + (1 << 40),
                                   n_users=mix["pool"])
        self.order = np.random.default_rng(
            data.sub_seed(seed, 3)).permutation(self.pool.n_users)
        self.engine = QueryEngine(index, QueryConfig(**mix["query"]),
                                  device=self.ctx.device)
        self.n_sent = 0
        self.records: list = []
        for _ in range(mix["clients"]):
            self.submit()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < mix["warmup_s"]:
            self.tick(resubmit=True)
        if self.ctx.trace is not None:
            self.ctx.trace.warm_profiler()

    def profile_of(self, rid):
        """Pool row of query ``rid`` (the pool in the seeded order)."""
        return self.order[np.asarray(rid) % len(self.order)]

    def submit(self):
        from repro_torch.query.engine import QueryRequest

        p = int(self.profile_of(self.n_sent))
        self.engine.submit(QueryRequest(rid=self.n_sent,
                                        profile=self.pool.profile(p)))
        self.n_sent += 1

    def tick(self, resubmit: bool) -> None:
        """One engine step. The completed requests are kept as arrays
        (rid, submitted, done, served, ids, sims), so the loop holds no
        request object past its step; with ``resubmit`` each one's client
        sends its next query."""
        self.engine.step()
        done = self.engine.done
        if not done:
            return
        k = self.ctx.mix["query"]["k"]
        none_ids, none_sims = np.full(k, -1, np.int32), np.zeros(k, np.float32)
        self.records.append((
            np.array([r.rid for r in done], dtype=np.int64),
            np.array([r.t_submit for r in done]),
            np.array([r.t_done for r in done]),
            np.array([r.status == "done" for r in done]),
            np.stack([none_ids if r.ids is None else r.ids for r in done]),
            np.stack([none_sims if r.sims is None else r.sims
                      for r in done])))
        n = len(done)
        done.clear()
        if resubmit:
            for _ in range(n):
                self.submit()

    def window(self, seconds: float) -> dict:
        tr = self.ctx.trace
        eng = self.engine
        first_rid = self.n_sent          # queries from here on count
        self.records = []
        restore = []
        if tr is not None:
            from repro_torch.query import plan as plan_mod
            restore.append(self._capture_hops(tr, plan_mod))
            tr.counters["dma_bytes_start"] = eng.plan.descent_stats[
                "dma_bytes"]
        prof_from, prof_for = 0.4 * seconds, min(2.0, 0.2 * seconds)
        profiled = (np.inf, -np.inf)     # host interval the profiler held
        t0 = time.perf_counter()
        t_end = None
        while t_end is None:
            if tr is None:
                self.tick(resubmit=True)
            elif tr.events is None and time.perf_counter() - t0 >= prof_from:
                p0 = time.perf_counter()
                with tr.profile():
                    self.capturing = True
                    t_p = time.perf_counter()
                    while time.perf_counter() - t_p < prof_for:
                        with tr.span("tick.profiled"):
                            self.tick(resubmit=True)
                    self.capturing = False
                profiled = (p0, time.perf_counter())
            else:
                with tr.span("tick"):
                    self.tick(resubmit=True)
            if time.perf_counter() - t0 >= seconds:
                t_end = time.perf_counter()
        if tr is not None:
            tr.counters["dma_bytes_end"] = eng.plan.descent_stats["dma_bytes"]
        # Serve out what the window sent, submitting nothing more.
        t_drain = time.perf_counter()
        while (eng.busy() and time.perf_counter() - t_drain < DRAIN_S):
            self.tick(resubmit=False)
        for undo in restore:
            undo()
        rid, t_sub, t_done, ok, ids, sims = (
            np.concatenate(col) for col in zip(*self.records))
        self.records = []
        mine = rid >= first_rid
        # Never answered, or answered with another status than "done".
        self.unanswered = ((self.n_sent - first_rid) - int(mine.sum())
                           + int((mine & ~ok).sum()))
        pick = np.flatnonzero(mine & ok)
        n_judged = min(self.ctx.mix["judged"], len(pick))
        pick = np.sort(np.random.default_rng(data.sub_seed(
            self.ctx.seed, 4)).choice(pick, size=n_judged, replace=False))
        self.answers = (rid[pick], ids[pick], sims[pick])
        timed = mine & ok & (t_done <= t_end)
        n_ok = int(timed.sum())
        window_s = t_end - t0
        half = t0 + window_s / 2
        halves = [int((timed & (t_done <= half)).sum()),
                  int((timed & (t_done > half)).sum())]
        # Queries in flight while the profiler ran are slower by its cost.
        clear = timed & ((t_done < profiled[0]) | (t_sub > profiled[1]))
        lats = (t_done - t_sub)[clear]
        notes = (f"{n_ok} queries in {window_s:.3f} s "
                 f"({halves[0]} + {halves[1]} by halves), "
                 f"{n_judged} judged, p50 "
                 f"{1e3 * float(np.median(lats)) if len(lats) else 0:.1f} "
                 f"ms, {eng.n_ticks} ticks in all, {self.n_sent} queries "
                 f"sent over a pool of {self.pool.n_users}")
        if tr is not None:
            tr.counters["window_queries"] = n_ok
            if len(lats):
                tr.counters["serve_p95_ms"] = 1e3 * float(
                    np.percentile(lats, 95))
        return {"metrics": {"serve_qps": n_ok / window_s},
                "attempted": self.n_sent - first_rid, "notes": notes,
                "failed": self.unanswered}

    def _capture_hops(self, tr, plan_mod):
        """Keep each profiled hop's beams and active rows (the DMA hop's
        inputs) for the roofline reader."""
        original = plan_mod.slot_hop
        self.capturing = False

        def slot_hop(graph_ids, rev_ids, words, card, q_words, q_card,
                     beam_ids, beam_sims, active, **kw):
            if self.capturing:
                tr.captures.append((beam_ids.clone(), active.clone()))
            return original(graph_ids, rev_ids, words, card, q_words,
                            q_card, beam_ids, beam_sims, active, **kw)

        plan_mod.slot_hop = slot_hop
        return lambda: setattr(plan_mod, "slot_hop", original)

    def release(self):
        import torch

        self.engine = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self):
        """Checks of the judged answers against the reference's."""
        from c2bench.harness import Check

        dev = self.ctx.device
        build = ref_c2.build(self.data.items, self.data.offsets,
                             self.ctx.cfg["c2"], dev)
        ix = ref_serve.index(build, self.ctx.cfg["c2"], dev)
        tr = self.ctx.trace
        if tr is not None and tr.captures:
            n_bits = self.ctx.cfg["c2"]["n_bits"]
            work = [roofline.hop_work(ix.ids, ix.rev, beam.to(dev),
                                      active.to(dev), n_bits)
                    for beam, active in tr.captures]
            tr.counters.update(hop_ops=sum(w[0] for w in work),
                               hop_bytes=sum(w[1] for w in work))
        rid, got_ids, got_sims = self.answers
        ids, sims = self.reference_answers(ix)
        bad = int(((got_ids != ids).any(axis=1)
                   | (got_sims.view(np.int32)
                      != sims.view(np.int32)).any(axis=1)).sum())
        return [Check("answers_differing", float(bad), 0.0),
                Check("unanswered", float(self.unanswered), 0.0)]

    def reference_answers(self, ix, dtype=None):
        """What the reference over index ``ix`` serves to each judged
        query (its epilogue in ``dtype``, float32 by default)."""
        import torch

        rows = self.profile_of(self.answers[0])
        asked = data.sorted_unique(rows)
        sub = subset(self.pool, asked)
        ids, sims = ref_serve.answer(ix, sub.items, sub.offsets,
                                     self.ctx.mix["query"], self.ctx.device,
                                     dtype=dtype or torch.float32)
        j = np.searchsorted(asked, rows)
        return ids[j], sims[j]


def subset(d: data.Data, users) -> data.Data:
    """The profiles of ``users``, in that order."""
    rows = [d.profile(u) for u in users]
    sizes = np.array([len(r) for r in rows], dtype=np.int64)
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    items = (np.concatenate(rows) if rows else np.zeros(0, np.int32))
    return data.Data(n_users=len(rows), n_items=d.n_items,
                     items=items.astype(np.int32), offsets=offsets)
