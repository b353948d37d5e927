"""End-to-end recommendation through the PyTorch port's serving stack
(paper §V-B): build a C² index, serve every user's profile through the
QueryEngine to get its neighbours, then user-based CF recall against
held-out items, compared with the exact brute-force graph.

    PYTHONPATH=src python examples/knn_recommend_torch.py

``--shards`` / ``--continuous`` / ``--kernel`` select the serving plan
(placement × batching × scorer, ``repro_torch/query/plan.py``).
Recommendation quality is plan-independent for a fixed placement
(batching and scorer give the same bits). The demo closes with the
lifecycle loop: a user deletion and a profile update served online, with
no rebuild.
"""
import argparse

import numpy as np

from repro_torch.core.params import C2Params
from repro_torch.data.synthetic import make_dataset, train_test_split
from repro_torch.eval.metrics import recall, recommend
from repro_torch.knn.brute_force import brute_force_knn
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
from repro_torch.query.index import build_index
from repro_torch.sketch.goldfinger import fingerprint_dataset
from repro_torch.types import KNNGraph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=1,
                    help="serve across this many LPT cluster shards")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching")
    ap.add_argument("--slots", type=int, default=32,
                    help="in-flight slot capacity in continuous mode")
    ap.add_argument("--kernel", action="store_true",
                    help="fused descent hop (the CUDA kernel on a card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    ds = make_dataset("ml1M", scale=0.2, seed=1)
    train, test_rows = train_test_split(ds, test_frac=0.2, seed=1)
    gf = fingerprint_dataset(train)

    # Build the servable index once (Steps 1–3 + routing tables).
    params = C2Params(k=10, b=256, t=8, max_cluster=120)
    index = build_index(train, params, gf=gf, device=dev)
    engine = QueryEngine(index, QueryConfig(
        k=11, beam=32, hops=3, shards=args.shards,
        continuous=args.continuous, slots=args.slots, kernel=args.kernel),
        device=dev)
    print(f"serving plan: {engine.plan.describe()}")

    # Serve every user's own profile; mask the self-match to recover its
    # neighbourhood, exactly what a live recommender would do.
    for u in range(train.n_users):
        engine.submit(QueryRequest(rid=u, profile=train.profile(u)))
    stats = engine.run()
    order = np.argsort([r.rid for r in engine.done])
    ids = np.stack([r.ids for r in engine.done])[order]
    sims = np.stack([r.sims for r in engine.done])[order]
    # Stable-sort the self-match (if any) to the end of each row, then
    # drop the last slot: non-self neighbours keep their sim-desc order.
    self_mask = ids == np.arange(train.n_users)[:, None]
    keep = np.argsort(self_mask, axis=1, kind="stable")[:, : ids.shape[1] - 1]
    served = KNNGraph(ids=np.take_along_axis(ids, keep, axis=1),
                      sims=np.take_along_axis(sims, keep, axis=1))

    exact = brute_force_knn(gf, k=10, device=dev)
    r_exact = recall(recommend(train, exact, n_rec=30), test_rows)
    r_served = recall(recommend(train, served, n_rec=30), test_rows)
    print(f"served {stats['requests']} queries at {stats['qps']:.0f} QPS "
          f"(p95 {stats['p95_latency_s'] * 1e3:.1f}ms)")
    print(f"recall@30 exact graph:   {r_exact:.3f}")
    print(f"recall@30 served (C²):   {r_served:.3f}  "
          f"(Δ {r_served - r_exact:+.3f})")

    # -- lifecycle: delete + update, then re-serve --------------------
    # Takedown: the most-recommended user must vanish from results.
    gone = int(np.bincount(served.ids.ravel(),
                           minlength=train.n_users).argmax())
    watchers = np.flatnonzero((served.ids == gone).any(axis=1))
    engine.remove_user(gone)
    # Taste change: re-link one of the watchers onto user 0's profile.
    moved = int(watchers[0]) if len(watchers) else 1
    engine.update_user(moved, train.profile(0))
    engine.lifecycle.repair()  # heal the delete-damaged rows now

    # Re-query the watchers' own profiles plus the NEW taste (user 0's
    # profile): the moved user must now surface as one of its neighbours.
    probes = [train.profile(int(u)) for u in watchers[:16]]
    probes.append(train.profile(0))
    re_ids, _ = engine.query_batch(probes, k=11)
    assert not (re_ids == gone).any(), "deleted user still served"
    print(f"lifecycle: removed user {gone} (was in {len(watchers)} "
          f"neighborhoods — now in 0 of {len(probes)} re-queries), "
          f"updated user {moved} "
          f"({'now' if moved in re_ids[-1] else 'NOT'} a neighbor of its "
          f"new taste), stats {engine.lifecycle.stats()}")
    return {"requests": stats["requests"], "qps": stats["qps"],
            "recall_exact": r_exact, "recall_served": r_served,
            "removed": gone, "updated": moved,
            "moved_found": bool(moved in re_ids[-1])}


if __name__ == "__main__":
    main()
