#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build — compiles the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. kernels — each kernel against its plain PyTorch version on the card,
   bitwise (ids, sims and the hop's scored-lane counts), over PAD rows,
   tombstones, planted equal sims and duplicate candidates, at W = 32
   and 64;
4. main path — ``knn_build`` on ml1M@1.0 with the paper's parameters
   (k=30) into a temporary index, then ``knn_serve`` of 2,048 unseen
   profiles (k=10, beam 32, 3 hops, waves of 256) with the fused hop;
   each kernel's launch count is read from this run and must be > 0.
   The same queries served with the plain hop must give bitwise-equal
   ids and sims, and a small build on the card must equal the CPU's;
5. timing — each kernel at the main path's shapes (all of Step 2's
   cluster batches; the first hop of a wave), held bitwise against its
   plain version there, and timed beside it and the least time the card
   could take (``bound_ms``).

Prints one ``{"kernels": [...]}`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8
# tensor-core operations/s. The bound counts the GoldFinger intersection
# as the int8 bit-plane product (2 operations per bit per pair), the
# cheapest form of the same work on this card.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

CLUSTER_KNN_SOURCE = "src/repro_torch/csrc/goldfinger_knn.cu"
HOP_SOURCE = "src/repro_torch/csrc/descent_hop.cu"
CLUSTER_KNN_REPLACES = ("src/repro/kernels/goldfinger_knn/goldfinger_knn.py"
                        ":96")
HOP_REPLACES = "src/repro/kernels/descent_score/descent_score.py:177"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` of the device time of ``inner`` calls / inner."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# -- phase 3: kernels against their plain versions -------------------------

def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries finite in both (sims are -inf exactly
    where a lane is empty; equality of those is checked with the ids)."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float((a[both] - b[both]).abs().max())


def random_words(rng, shape, density_rounds: int = 3):
    import numpy as np

    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
    for _ in range(density_rounds):
        w &= rng.integers(0, 2**32, size=shape, dtype=np.uint64)
    return w.astype(np.uint32)


def check_cluster_knn(dev) -> tuple[int, float]:
    import numpy as np
    import torch

    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor
    from repro_torch.types import PAD_ID

    cases = [(32, 32, 10, 6), (512, 32, 30, 4), (2048, 32, 30, 2),
             (32, 64, 30, 6), (512, 64, 10, 3), (2048, 64, 10, 2)]
    n_checked, err = 0, 0.0
    for cap, W, k, m in cases:
        rng = np.random.default_rng(cap * 100 + W + k)
        words = random_words(rng, (m, cap, W))
        # Planted equal sims: repeated fingerprints tie against everyone.
        words[:, 1::7] = words[:, :1]
        words[:, 2::11] = words[:, 3:4]
        card = popcount_rows(words.reshape(-1, W)).reshape(m, cap)
        ids = rng.permutation(m * cap * 4)[: m * cap].astype(
            np.int32).reshape(m, cap)
        sizes = rng.integers(2, cap + 1, size=m)
        sizes[0] = cap
        sizes[-1] = 1  # a lone member: every slot PAD
        for j, s in enumerate(sizes):
            ids[j, s:] = PAD_ID
            card[j, s:] = 0
            words[j, s:] = 0
        w = words_tensor(words, dev)
        c = torch.from_numpy(card).to(dev)
        i = torch.from_numpy(ids).to(dev)
        ki, ks = ops.cluster_knn(w, c, i, k)
        pi, ps = ref.cluster_knn_ref(w, c, i, k)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ks, ps))
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            bad = (ki != pi) | (ks != ps)
            fail(f"cluster-KNN cap={cap} W={W} k={k}: "
                 f"{int(bad.sum())} entries differ from the plain version")
        n_checked += 1
        log(f"[kernels] cluster_knn cap={cap} W={W} k={k} m={m}: bitwise ok")
    # Ragged query/database counts (not multiples of the tiles).
    rng = np.random.default_rng(5)
    qw, dw = random_words(rng, (200, 32)), random_words(rng, (300, 32))
    qc, dc = popcount_rows(qw), popcount_rows(dw)
    qi = np.arange(200, dtype=np.int32)
    di = np.arange(100, 400, dtype=np.int32)
    args = [words_tensor(qw, dev), torch.from_numpy(qc).to(dev),
            torch.from_numpy(qi).to(dev), words_tensor(dw, dev),
            torch.from_numpy(dc).to(dev), torch.from_numpy(di).to(dev)]
    ki, ks = ops.knn(*args, 30)
    pi, ps = ref.knn_ref(*args, 30)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(ks, ps))
    if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
        fail("knn 200x300 ragged: differs from the plain version")
    log("[kernels] knn nq=200 nd=300 k=30: bitwise ok")
    return n_checked + 1, err


def hop_inputs(rng, dev, n, W, kg, kr, q, B, tomb_frac=0.05):
    import numpy as np
    import torch

    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor
    from repro_torch.types import NEG_INF, PAD_ID

    graph = rng.integers(0, n, size=(n, kg)).astype(np.int32)
    rev = rng.integers(0, n, size=(n, kr)).astype(np.int32)
    # PAD tails, and rows with no edges at all.
    for a in (graph, rev):
        cut = rng.integers(0, a.shape[1] + 1, size=n)
        a[np.arange(a.shape[1])[None, :] >= cut[:, None]] = PAD_ID
    words = random_words(rng, (n, W))
    card = popcount_rows(words)
    tomb = rng.random(n) < tomb_frac
    qw = random_words(rng, (q, W))
    qc = popcount_rows(qw)
    beam = np.full((q, B), PAD_ID, np.int32)
    for i in range(q):
        m = B if i % 5 else int(rng.integers(0, B + 1))
        if i % 17 == 0:
            m = 0  # fully PAD beam
        beam[i, :m] = rng.choice(n, size=m, replace=False)
    sims = np.where(beam == PAD_ID, NEG_INF,
                    -np.sort(-rng.random((q, B)))).astype(np.float32)
    # Equal sims across beam lanes.
    sims[:, 4:8] = np.where(beam[:, 4:8] == PAD_ID, NEG_INF, sims[:, 4:5])
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(graph), t(rev), words_tensor(words, dev), t(card), t(qw.view(
        np.int32)), t(qc), t(beam), t(sims), t(tomb))


def hop_plain(graph, rev, words, card, qw, qc, beam, sims, tomb):
    from repro_torch.kernels.descent_score import ref

    ids, out = ref.descent_hop_ref(graph, rev, words, card, qw, qc, beam,
                                   sims, tomb=tomb)
    return ids, out, ref.scored_lanes(graph, rev, beam, tomb=tomb)


def hop_kernel(graph, rev, words, card, qw, qc, beam, sims, tomb):
    from repro_torch.kernels.descent_score import ops

    return ops.descent_hop(graph, rev, words, card, qw, qc, beam, sims,
                           tomb=tomb, with_counts=True)


def same_hop(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_hop(dev) -> tuple[int, float]:
    import numpy as np
    import torch

    n_checked, err = 0, 0.0
    for W in (32, 64):
        for n in (6038, 300):  # 300: dense duplication across lanes
            rng = np.random.default_rng(W * 7 + n)
            args = hop_inputs(rng, dev, n, W, 30, 30, 256, 32)
            k_out = hop_kernel(*args)
            p_out = hop_plain(*args)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(k_out[1], p_out[1]))
            if not same_hop(k_out, p_out):
                fail(f"descent hop n={n} W={W}: differs from the plain "
                     f"version (ids {torch.equal(k_out[0], p_out[0])}, sims "
                     f"{torch.equal(k_out[1], p_out[1])}, n_scored "
                     f"{torch.equal(k_out[2], p_out[2])})")
            n_checked += 1
            log(f"[kernels] descent_hop n={n} W={W} B=32 kg=kr=30 q=256: "
                f"bitwise ok (scored {int(k_out[2].sum())} of "
                f"{256 * 32 * 60} lanes)")
    return n_checked, err


# -- phase 4: the main path ------------------------------------------------

def main_path(dev, tmp: Path) -> dict:
    import numpy as np

    from repro_torch.kernels.descent_score import ops as ds_ops
    from repro_torch.kernels.goldfinger_knn import ops as gk_ops
    from repro_torch.launch import knn_build, knn_serve
    from repro_torch.types import PAD_ID

    index_path = str(tmp / "ml1m.npz")
    gk_ops.launches = 0
    ds_ops.launches = 0
    built = knn_build.main(["--dataset", "ml1M", "--scale", "1.0",
                            "--k", "30", "--seed", "0",
                            "--index-out", index_path, "--device", "cuda"])
    serve_args = ["--index", index_path, "--dataset", "ml1M",
                  "--scale", "1.0", "--queries", "2048", "--k", "10",
                  "--beam", "32", "--hops", "3", "--max-wave", "256",
                  "--seed", "0", "--device", "cuda"]
    stats, recall, engine = knn_serve.main(serve_args + ["--kernel"])
    launches = {"goldfinger_knn": gk_ops.launches,
                "descent_hop": ds_ops.launches}
    log(f"[main] launches on the main path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched the {name} kernel")

    graph, plan = built["graph"], built["plan"]
    if graph.ids.shape != (6038, 30):
        fail(f"graph shape {graph.ids.shape}, expected (6038, 30)")
    live = graph.ids != PAD_ID
    if (not np.isfinite(graph.sims[live]).all()
            or not (graph.sims[~live] == -np.inf).all()
            or (graph.sims[:, 1:] > graph.sims[:, :-1]).any()):
        fail("graph sims are not finite, descending rows with -inf gaps")
    if live.mean() < 0.5:
        fail(f"only {live.mean():.3f} of the graph's edges are present")
    log(f"[main] build: {plan.n_clusters} clusters, "
        f"{plan.brute_force_sims()} sims, avg_sim {graph.avg_sim():.4f}, "
        f"{live.mean():.4f} of edges present, {built['seconds']:.2f} s")

    done = sorted(engine.done, key=lambda r: r.rid)
    ids = np.stack([r.ids for r in done])
    sims = np.stack([r.sims for r in done])
    if ids.shape != (2048, 10) or stats["requests"] != 2048:
        fail(f"served {ids.shape}, expected (2048, 10)")
    ok = ids != PAD_ID
    if not np.isfinite(sims[ok]).all() or not (sims[~ok] == -np.inf).all():
        fail("served sims are not finite on present neighbours")
    if not 0.5 <= recall <= 1.0:
        fail(f"recall@10 {recall:.3f} outside [0.5, 1]")
    log(f"[main] serve (fused hop): QPS {stats['qps']:.1f}, "
        f"p50 {stats['p50_latency_s'] * 1e3:.2f} ms, "
        f"p95 {stats['p95_latency_s'] * 1e3:.2f} ms, "
        f"recall@10 {recall:.4f}")

    j_stats, j_recall, j_engine = knn_serve.main(serve_args)
    j_done = sorted(j_engine.done, key=lambda r: r.rid)
    if not (np.array_equal(ids, np.stack([r.ids for r in j_done]))
            and np.array_equal(sims, np.stack([r.sims for r in j_done]))):
        fail("fused-hop serving differs from plain-hop serving")
    log(f"[main] plain hop serves bitwise-equal ids and sims "
        f"(QPS {j_stats['qps']:.1f}, recall@10 {j_recall:.4f})")
    return {"launches": launches, "built": built, "engine": engine}


def build_stages() -> None:
    """Host clock per C² stage of the ml1M@1.0 paper build on the card."""
    from repro_torch.core.params import params_for
    from repro_torch.core.pipeline import cluster_and_conquer
    from repro_torch.data.synthetic import make_dataset

    ds = make_dataset("ml1M", scale=1.0, seed=0)
    _, st = cluster_and_conquer(ds, params_for("ml1M", k=30), device="cuda")
    log(f"[timing] ml1M@1.0 build stages, host clock: clustering "
        f"{st.t_cluster * 1e3:.1f} ms, Step 2 {st.t_local * 1e3:.1f} ms, "
        f"merge {st.t_merge * 1e3:.1f} ms")


def small_build_matches_cpu() -> None:
    import numpy as np

    from repro_torch.core.params import params_for
    from repro_torch.core.pipeline import cluster_and_conquer
    from repro_torch.data.synthetic import make_dataset

    ds = make_dataset("ml1M", scale=0.05, seed=3)
    params = params_for("ml1M", k=10)
    g_gpu, _ = cluster_and_conquer(ds, params, device="cuda")
    g_cpu, _ = cluster_and_conquer(ds, params, device="cpu")
    if not (np.array_equal(g_gpu.ids, g_cpu.ids)
            and np.array_equal(g_gpu.sims, g_cpu.sims)):
        fail("ml1M@0.05 graph built on the card differs from the CPU's")
    log("[main] ml1M@0.05 graph: card == CPU plain path, bitwise")


# -- phase 5: timing at the main path's shapes -----------------------------

def time_cluster_knn(dev, built, index, launches: int) -> tuple[dict, float]:
    import numpy as np
    import torch

    from repro_torch.core.clustering import ClusterPlan
    from repro_torch.core.local_knn import batch_inputs, group_batches
    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import words_tensor

    plan, k = built["plan"], index.k
    words = words_tensor(index.words, dev)
    card = torch.from_numpy(index.card).to(dev)
    W = words.shape[1]
    batches = []
    in_bytes = out_bytes = 0
    for i in range(plan.t):  # as knn_build: one map task per configuration
        members = [m for m, c in zip(plan.members, plan.config_of) if c == i]
        sub = ClusterPlan(members=members,
                          config_of=np.zeros(len(members), np.int32),
                          n_users=plan.n_users, t=1)
        for cap, _, mem in group_batches(sub, W):
            batches.append(batch_inputs(words, card, mem))
            m = mem.shape[0]
            in_bytes += m * cap * (4 * W + 8)
            out_bytes += m * cap * k * 8
    pairs = int(sum(s * (s - 1) for s in plan.sizes))
    if len(batches) != launches:
        fail(f"timing sweep has {len(batches)} batches but the main path "
             f"launched the kernel {launches} times")

    def sweep(fn):
        return lambda: [fn(w, c, i, k) for w, c, i in batches]

    # The main path's own Step-2 batches, kernel against plain, bitwise.
    k_out, p_out = sweep(ops.cluster_knn)(), sweep(ref.cluster_knn_ref)()
    err = 0.0
    for (k_ids, k_sims), (p_ids, p_sims) in zip(k_out, p_out):
        if not (torch.equal(k_ids, p_ids) and torch.equal(k_sims, p_sims)):
            fail("cluster-KNN over the main path's Step-2 batches differs "
                 "from the plain version")
        err = max(err, max_abs_err(k_sims, p_sims))
    log(f"[main] cluster-KNN over the main path's {len(batches)} Step-2 "
        f"batches: bitwise equal to the plain version")
    ms = cuda_ms(sweep(ops.cluster_knn), reps=5)
    plain_ms = cuda_ms(sweep(ref.cluster_knn_ref), reps=3)
    ops_count = 2 * pairs * W * 32
    bytes_count = in_bytes + out_bytes
    t_ops = ops_count / INT8_OPS_PER_S * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return {"name": "goldfinger_knn", "route": "cuda",
            "source": CLUSTER_KNN_SOURCE, "replaces": CLUSTER_KNN_REPLACES,
            "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "shape": f"Step-2 sweep of ml1M@1.0 k=30: {len(batches)} "
                     f"batches, {pairs} ordered pairs, W={W}"}, err


def time_hop(dev, engine, launches: int) -> tuple[dict, float]:
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.descent_score import ref
    from repro_torch.query.router import fingerprint_profiles, profiles_to_csr, route
    from repro_torch.query.search import descent_init
    from repro_torch.sketch.goldfinger import words_tensor

    plan = engine.plan
    graph, rev, words, card, tomb = plan.tables()
    qds = make_dataset("ml1M", scale=1.0, seed=1)
    profiles = [qds.profile(u) for u in range(plan.spec.max_wave)]
    # Where one wave's time goes: host fingerprinting and routing, then
    # the descent (uploads, init, hops, final merge, download).
    stages = {"fingerprint": [], "route": [], "descent": []}
    for _ in range(3):
        t0 = time.perf_counter()
        items, offsets = profiles_to_csr(profiles)
        qgf = fingerprint_profiles(items, offsets, engine.index.n_bits,
                                   engine.index.fp_seed)
        t1 = time.perf_counter()
        seeds = route(engine.index, items, offsets,
                      plan.spec.seeds_per_config)
        t2 = time.perf_counter()
        plan.descend_rows(qgf.words, qgf.card, seeds, plan.spec.k)
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    log("[timing] one 256-query wave, host clock, median of 3: "
        + ", ".join(f"{key} {statistics.median(v):.2f} ms"
                    for key, v in stages.items()))
    qw = words_tensor(qgf.words, dev)
    qc = torch.from_numpy(qgf.card).to(dev)
    beam_ids, beam_sims = descent_init(
        words, card, qw, qc, torch.from_numpy(seeds).to(dev),
        beam=plan.beam, tomb=tomb)
    args = (graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb)
    k_out = hop_kernel(*args)
    p_out = hop_plain(*args)
    if not same_hop(k_out, p_out):
        fail("descent hop at the main path's first wave differs from the "
             "plain version")
    err = max_abs_err(k_out[1], p_out[1])
    ms = cuda_ms(lambda: hop_kernel(*args), reps=7, inner=20)
    plain_ms = cuda_ms(lambda: hop_plain(*args), reps=5)

    q, B = beam_ids.shape
    kg, kr, W = graph.shape[1], rev.shape[1], words.shape[1]
    live_beam = beam_ids[beam_ids >= 0].unique().numel()
    cand = ref.gather_candidates(graph, rev, beam_ids, tomb)
    need = ref.survivors(cand, beam_ids)
    scored_rows = cand[need].unique().numel()
    cand_rows = cand[cand >= 0].unique().numel()
    n_scored = int(k_out[2].sum())
    bytes_count = (live_beam * (kg + kr) * 4      # adjacency rows
                   + (cand_rows + live_beam)       # tombstone flags
                   + scored_rows * (4 * W + 4)     # fingerprint rows + card
                   + q * (4 * W + 4 + B * 8)       # queries + beams in
                   + q * (B * 8 + 4))              # beams + counts out
    ops_count = 2 * n_scored * W * 32
    t_ops = ops_count / INT8_OPS_PER_S * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return {"name": "descent_hop", "route": "cuda", "source": HOP_SOURCE,
            "replaces": HOP_REPLACES, "launches": launches, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "shape": f"first hop of a 256-query ml1M@1.0 wave: n=6038 "
                     f"W={W} B={B} kg=kr={kg}, {n_scored} lanes scored"}, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    report = build.build()
    log(f"[build] {len(report)} kernels in {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k}: {v['seconds']:.1f} s" for k, v in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    n_ck, err_ck = check_cluster_knn(dev)
    n_hop, err_hop = check_hop(dev)
    log(f"[kernels] {n_ck} cluster-KNN and {n_hop} hop cases bitwise equal "
        f"to the plain versions")

    small_build_matches_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        run = main_path(dev, Path(tmp))
        ck_row, err_ck_main = time_cluster_knn(
            dev, run["built"], run["engine"].index,
            run["launches"]["goldfinger_knn"])
        hop_row, err_hop_main = time_hop(dev, run["engine"],
                                         run["launches"]["descent_hop"])
    build_stages()
    ck_row["max_abs_err"] = max(err_ck, err_ck_main)
    hop_row["max_abs_err"] = max(err_hop, err_hop_main)
    rows = [ck_row, hop_row]
    for row in rows:
        log(f"[timing] {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']}) over {row.pop('shape')}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
