"""Online KNN query serving CLI (torch port of ``repro.launch.knn_serve``):
build (or load) an index, serve a wave of unseen query profiles, report
QPS / latency / recall vs brute force.

    PYTHONPATH=src python -m repro_torch.launch.knn_serve \
        --index /tmp/ml1m.npz --dataset ml1M --scale 1.0 \
        --queries 2048 --continuous --slots 256 --kernel --dma

``--index`` serves an artifact written by either package's ``knn_build
--index-out``; without it the index is built in-process with the
reference's serving parameters. ``--kernel`` selects the fused descent
hop (the CUDA kernel; identical results to the plain hop), ``--dma`` on
top the DMA hop (identical results; reports fingerprint bytes moved and
skipped). ``--continuous`` streams the requests through ``--slots``
in-flight slots instead of closed waves of ``--max-wave`` (identical
results). Everything runs on ``--device`` (default ``cuda``; without a
card that raises at once).

Mutation flags, driven as the reference drives them: ``--insert M``
inserts the last M profiles of the query dataset online before the
serve; ``--churn M`` then deletes M users and profile-updates M more,
picked id-strided over the live rows (the update profiles are the first
M query profiles), with one repair pass when ``--repair-every`` is set;
``--ttl T`` expires rows untouched for T scheduler steps and
``--repair-every R`` re-links delete-damaged rows every R steps, both
during the serve.

``--shards S`` serves the sharded placement (LPT cluster shards, all on
``--device`` with one hop launch for every shard; the per-device layout
is the library's opt-in ``QueryEngine(shard_devices=)``) and prints a
``[serve] sharded:`` line with the reference's numbers, the layout in the
place of the reference's ``mesh`` / ``vmap``.

SLO flags: ``--admission slo`` ranks pending requests by (priority class,
deadline) and sheds expired and overflow requests with a ``rejected``
marker (``--max-pending`` bounds the queue); ``--priority-split F`` submits
the first F of the queries as class 0 and the rest as class 1;
``--deadline-ms D`` gives every request a deadline D ms after its
submission; ``--adaptive P`` frees a continuous slot once its top-k prefix
held P hops; ``--cache N`` serves exact-fingerprint repeats from an
N-entry result cache flushed by index mutations. ``[serve] slo:`` and
``[serve] cache:`` lines report them.

Re-balance flags (with ``--shards``): ``--rebalance-every N`` measures the
shards' imbalance every N scheduler steps and swaps in a freshly derived
partition past ``--rebalance-threshold`` (rebuilt by merging the old shard
tables, in-flight beams remapped, the cache flushed; a ``[serve]
rebalance:`` line); ``--resident-configs M`` makes only clusters of the
first M hash configurations shard residents (tiered residency).

Fault flags (``repro_torch/faults/``): ``--fault-plan SPEC`` schedules
deterministic faults at the scheduler-step boundary (``kill:S@T``,
``fail:S@T+D``, ``slow:S@T+D:MS``, ``crash@T``, separated by ``;``);
killed shards are masked out and served around (a ``[serve] faults:`` line
with the degraded recall), then swapped back in under a fresh partition.
``--store DIR --snapshot-every N`` keeps periodic index snapshots and a
write-ahead journal of every mutation (a ``[serve] store:`` line); a
``crash@T`` plan stops the serve with ``[serve] CRASHED:``, and
``--recover DIR`` skips the build and restores the engine, bitwise, from
the last snapshot and the journal's replay (a store written by either
package).

``--trace-out PATH`` runs the timed serve (after the warm-up step) under
``torch.profiler`` and writes its Chrome trace, with the program's spans
(``repro_torch.obs``), to PATH and the program's counters to
``PATH.counters.json``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.params import params_for
from repro_torch.data.synthetic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.faults.plan import EngineCrash
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
from repro_torch.query.index import KNNIndex, build_index


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synth")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--beam", type=int, default=32)
    ap.add_argument("--hops", type=int, default=3)
    ap.add_argument("--max-wave", type=int, default=256)
    ap.add_argument("--shards", type=int, default=1,
                    help="LPT cluster shards (1 = single placement); all "
                         "on one device, one hop launch for every shard")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (slot scheduler, streaming "
                         "admission) instead of closed waves")
    ap.add_argument("--slots", type=int, default=32,
                    help="in-flight slot capacity in continuous mode")
    ap.add_argument("--kernel", action="store_true",
                    help="fused descent hop (CUDA kernel; identical results)")
    ap.add_argument("--dma", action="store_true",
                    help="with --kernel: the DMA hop (fingerprint rows "
                         "gathered through a shared-memory ring; identical "
                         "results, reports bytes moved/skipped)")
    ap.add_argument("--insert", type=int, default=0,
                    help="insert this many users online before querying")
    ap.add_argument("--churn", type=int, default=0,
                    help="delete this many users AND profile-update as "
                         "many more online before querying")
    ap.add_argument("--ttl", type=int, default=0,
                    help="expire rows untouched for this many scheduler "
                         "steps (0 = never)")
    ap.add_argument("--repair-every", type=int, default=0,
                    help="re-link churn-damaged rows every this many "
                         "scheduler steps (0 = off)")
    ap.add_argument("--admission", default="fifo", choices=["fifo", "slo"],
                    help="admission policy: fifo (arrival order) or slo "
                         "(priority class + earliest deadline, explicit "
                         "shedding)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="slo: bound on the pending queue; overflow is "
                         "shed with a rejected marker (0 = unbounded)")
    ap.add_argument("--priority-split", type=float, default=0.0,
                    help="fraction of the queries submitted as high "
                         "priority (class 0); the rest is class 1 (0 = "
                         "every request class 0)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline in ms from submission; "
                         "expired pending requests are shed under "
                         "--admission slo (0 = no deadline)")
    ap.add_argument("--adaptive", type=int, default=0,
                    help="continuous: free a slot once its top-k prefix "
                         "held this many hops (0 = run to budget)")
    ap.add_argument("--cache", type=int, default=0,
                    help="fingerprint result-cache capacity, flushed on "
                         "index mutation (0 = off)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="measure shard imbalance every this many "
                         "scheduler steps; swap the plan past the "
                         "threshold (0 = off; needs --shards)")
    ap.add_argument("--rebalance-threshold", type=float, default=1.25,
                    help="measured imbalance (max/mean resident cluster "
                         "mass) that triggers a re-balance swap")
    ap.add_argument("--resident-configs", type=int, default=0,
                    help="tiered residency: only clusters of the first M "
                         "hash configurations contribute shard residents "
                         "(0 = all t; needs --shards)")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault schedule: kill:S@T, "
                         "fail:S@T+D, slow:S@T+D:MS, crash@T "
                         "(';'-separated; steps count scheduler steps)")
    ap.add_argument("--store", default=None,
                    help="crash-store directory: snapshots + write-ahead "
                         "journal of every index mutation")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in scheduler steps (journal "
                         "compaction; 0 = snapshot only at startup)")
    ap.add_argument("--recover", default=None,
                    help="recover the engine from this crash-store "
                         "directory (skips the build; last snapshot + WAL "
                         "replay, bitwise)")
    ap.add_argument("--index", default=None, help="load a saved index")
    ap.add_argument("--save-index", default=None, help="save the built index")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the index and the descent live on")
    ap.add_argument("--trace-out", default=None,
                    help="profile the timed serve (torch.profiler) and "
                         "write its Chrome trace here, the program's "
                         "counters to PATH.counters.json")
    return ap


def main(argv=None):
    """Run the CLI; returns ``(stats, recall, engine)``."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    faults = None
    if args.fault_plan:
        from repro_torch.faults import FaultInjector, FaultPlan
        faults = FaultInjector(FaultPlan.parse(args.fault_plan))
        print(f"[serve] fault plan: {faults.plan.describe()}")
    store = None
    if args.store:
        from repro_torch.faults import CrashStore
        store = CrashStore(args.store, every=args.snapshot_every)
    qc = QueryConfig(k=args.k, beam=args.beam, hops=args.hops,
                     max_wave=args.max_wave, shards=args.shards,
                     continuous=args.continuous,
                     slots=args.slots, kernel=args.kernel, dma=args.dma,
                     ttl=args.ttl, repair_every=args.repair_every,
                     admission=args.admission, max_pending=args.max_pending,
                     adaptive=args.adaptive, cache=args.cache,
                     resident_configs=args.resident_configs,
                     rebalance_every=args.rebalance_every,
                     rebalance_threshold=args.rebalance_threshold)
    qc.spec()  # --dma without --kernel fails before any work

    if args.recover:
        engine = QueryEngine.recover(args.recover, qc, device=dev,
                                     faults=faults, store=store)
        index = engine.index
        print(f"[serve] recovered from {args.recover}: {index.n} users, "
              f"{index.n_clusters} clusters, version {index.version}")
        return _serve(args, engine, index, dev)

    if args.index:
        index = KNNIndex.load(args.index)
        print(f"[serve] loaded index: {index.n} users, k={index.k}, "
              f"t={index.t}, {index.n_clusters} clusters")
    else:
        ds = make_dataset(args.dataset, scale=args.scale, seed=args.seed)
        params = params_for(args.dataset, k=args.k,
                            b=max(64, ds.n_users // 16),
                            max_cluster=max(48, int(0.06 * ds.n_users)))
        t0 = time.perf_counter()
        index = build_index(ds, params, device=dev)
        print(f"[serve] built index: {ds.n_users} users, k={params.k} "
              f"({time.perf_counter() - t0:.2f}s, "
              f"{index.n_clusters} clusters)")
    if args.save_index:
        index.save(args.save_index)
        print(f"[serve] index saved to {args.save_index}")

    engine = QueryEngine(index, qc, device=dev, faults=faults, store=store)
    return _serve(args, engine, index, dev)


def _serve(args, engine, index, dev):
    print(f"[serve] plan: {engine.plan.describe()} on {dev}")

    # Unseen profiles: the dataset's generator with the next seed. That
    # draw has its own topics, so its users are far closer to each other
    # than to the index's: inserts and updates taken from it become the
    # queries' nearest neighbours.
    qds = make_dataset(args.dataset, scale=args.scale, seed=args.seed + 1)
    n_q = min(args.queries, qds.n_users)
    profiles = [qds.profile(u) for u in range(n_q)]

    for m in range(args.insert):
        engine.insert(qds.profile(qds.n_users - 1 - m))
    if args.insert:
        print(f"[serve] inserted {args.insert} users online "
              f"(index now {index.n} users)")

    if args.churn:
        # Id-strided picks over the live rows: deterministic across
        # reruns, and the delete and update sets never overlap.
        alive = index.alive_ids()
        take = np.linspace(0, len(alive) - 1,
                           num=min(2 * args.churn, len(alive)),
                           dtype=np.int64)
        victims = alive[take]
        for u in victims[0::2]:
            engine.remove_user(int(u))
        for m, u in enumerate(victims[1::2]):
            engine.update_user(int(u), qds.profile(m % qds.n_users))
        if args.repair_every:
            engine.lifecycle.repair()  # serve the wave on a healed graph
        print(f"[serve] churned: {len(victims[0::2])} deletes, "
              f"{len(victims[1::2])} updates "
              f"(index now {index.n_live} live rows) | "
              f"lifecycle {engine.lifecycle.stats()}")

    sd = engine.sharded_state()  # after the mutations: the serve reuses it
    if sd is not None:
        mb = [round(b / 1e6, 2) for b in sd.resident_bytes()]
        print(f"[serve] sharded: {sd.n_shards} shards, resident rows "
              f"{[len(r) for r in sd.plan.residents]} ({mb} MB"
              + (f", configs {sd.plan.resident_configs}/{index.t}"
                 if sd.plan.resident_configs else "")
              + f"), imbalance {sd.plan.imbalance:.2f}, {sd.layout} "
              + (f"execution (devices {[str(d) for d in sd.devices]})"
                 if sd.devices else
                 "execution (one hop launch for all shards)"))

    if not profiles:
        print("[serve] no queries requested")
        return {"requests": 0}, 0.0, engine

    # Warm-up step: first-use costs (kernel build and load, allocator)
    # stay out of the timed run.
    engine.submit(QueryRequest(rid=-1, profile=profiles[0]))
    engine.run()
    engine.done.clear()

    n_high = (int(round(args.priority_split * len(profiles)))
              if args.priority_split > 0 else len(profiles))
    for rid, p in enumerate(profiles):
        deadline = (engine.clock() + args.deadline_ms / 1e3
                    if args.deadline_ms > 0 else None)
        engine.submit(QueryRequest(
            rid=rid, profile=p,
            priority=0 if rid < n_high else 1, deadline=deadline))
    try:
        with obs.capture(args.trace_out, dev):
            stats = engine.run()
    except EngineCrash as e:
        # The injected crash lands between scheduler steps: every mutation
        # is journaled, the requests in flight are lost (clients retry).
        print(f"[serve] CRASHED: {e}")
        if engine.store is not None:
            print(f"[serve] recover with: --recover {args.store}  "
                  f"(store: {engine.store.stats()})")
        return {"requests": 0, "crashed": True}, 0.0, engine
    recall = engine.recall_vs_brute_force()
    unit = "ticks" if args.continuous else "waves"
    print(f"[serve] {stats['requests']} queries in {stats['waves']} {unit} "
          f"({stats['mode']}) | "
          f"QPS {stats['qps']:.0f} | "
          f"p50 {stats['p50_latency_s'] * 1e3:.1f}ms | "
          f"p95 {stats['p95_latency_s'] * 1e3:.1f}ms | "
          f"recall@{args.k} vs brute force {recall:.3f}")
    if "descent" in stats:
        d = stats["descent"]
        n_served = max(stats["served"], 1)
        line = (f"[serve] descent: {d['scored_lanes']} lanes scored "
                f"({d['scored_lanes'] / n_served:.0f}/query)")
        if d["dma_bytes"]:
            moved, saved = d["dma_bytes"], d["bytes_saved"]
            line += (f" | dma {moved / 1e6:.2f} MB moved "
                     f"({moved / n_served / 1e3:.1f} KB/query), "
                     f"{saved / 1e6:.2f} MB skipped "
                     f"({saved / (moved + saved):.0%} of gather traffic)")
        print(line)
    if args.admission == "slo":
        print(f"[serve] slo: served {stats['served']}, "
              f"shed {stats['shed']} "
              f"(priority split {n_high}/{len(profiles) - n_high}, "
              f"deadline {args.deadline_ms:.0f}ms)")
    if "cache" in stats:
        c = stats["cache"]
        print(f"[serve] cache: {c['hits']} hits / "
              f"{c['hits'] + c['misses']} lookups "
              f"(rate {c['hit_rate']:.2f}), {c['entries']}/{c['capacity']} "
              f"entries, {c['flushes']} flushes")
    if "rebalance" in stats:
        print(f"[serve] rebalance: {stats['rebalance']}")
    if "faults" in stats:
        f = stats["faults"]
        degraded = [r for r in engine.done if r.degraded]
        deg_recall = (engine.recall_vs_brute_force(degraded)
                      if degraded else None)
        print(f"[serve] faults: {f.get('shards_down', 0)} shards down, "
              f"{f.get('deaths', 0)} deaths, "
              f"{f.get('retries', 0)} retries, "
              f"{f.get('backoff_steps', 0)} backoff steps, "
              f"{f.get('failovers', 0)} failovers | "
              f"{len(degraded)} served degraded"
              + (f" (degraded recall@{args.k} {deg_recall:.3f})"
                 if deg_recall is not None else ""))
    if "store" in stats:
        s = stats["store"]
        print(f"[serve] store: {s['snapshots']} snapshots, "
              f"{s['wal_records']} WAL records since last "
              f"(cadence {s['every']})")
    return stats, recall, engine


if __name__ == "__main__":
    main()
