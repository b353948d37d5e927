#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build — compiles the four CUDA kernels from ``src/repro_torch/csrc``
   and phase 5's probed copies of the two hops (one ``nvcc`` per source,
   all at once);
3. kernels — each kernel against its plain PyTorch version on the card,
   bitwise: cluster-KNN (ids, sims) at W 1-64, k 1-64 (lists in the
   warps' registers) and k 65, 100, 256 and 2,048 (lists merged in shared
   and in global memory; k above a cluster's size), caps 32-2048, PAD
   ids at cluster ends and scattered, lone members, equal sims in every
   database tile, one call of 70,000 two-member clusters (more than the
   65,535 of one launch), and ``knn`` at 17x1,000 and 1,000x17; cluster-KNN
   at rows wider than a block holds whole (chunked rows): W = 1,105,
   2,048, 4,236 (16-byte copies), 5,355 and 6,345 (4-byte copies), each at
   k = 10, 30 and 100, caps 32-256, PAD ids at cluster ends and scattered,
   planted equal sims, and ``knn`` at 17x1,000 with W = 5,355; the hop (ids,
   sims, scored lanes) over PAD rows, tombstones, planted equal sims and
   duplicate candidates at W = 32 and 64; the DMA hop against its plain
   version and against the hop kernel, with exact byte counters, at W =
   32, 64 and 33 (the 4-byte copy path), over tombstone-heavy tables,
   chunks that do not divide the lanes, rings 1 to 3 deep, several
   queries per block and chunks whose every lane is suppressed; both hops
   at W = 4, 8, 33, 64 and 65 (every row grouping and both copy paths),
   beams of 1, 64, 128 and 512 lanes, beams that are all PAD, candidates
   that all name one id, and equal sims across ids, where the column
   decides; both hops at beams of 128, 256 and 1,024 lanes over kg+kr =
   60, W = 32 (their state in global memory; 1,024 lanes through the radix
   select), with random and with tie-heavy beams (every row equal), and at
   640 lanes over kg+kr = 2 (the radix select with the state in shared
   memory), and 1,200 queries at 128 lanes, so that each block walks
   several queries (the DMA hop also in groups of 3); both hops' shard
   grid axis (``ops.descent_hop_sharded``: S shards in one launch) at 2-5
   shards, W = 32 and 33, one to 256 queries, shard beams of 12-192 lanes
   (state in shared and in global memory) and a DMA ring of 3 queries a
   block, against the plain sharded hop and against S single-shard
   launches; the same with whole shards all PAD, as a dead shard leaves
   them (S = 4 with shard 1, S = 3 with shards 0 and 2, S = 2 with both;
   W = 32 and 33, 256 queries, shard beams of 12 and 192), each dead
   shard giving PAD ids, -inf sims, no scored lane and no DMA byte;
   FastRandomHash's padded entry at the reference test's shapes and its
   CSR entry over empty, one-item and longest rows, row offsets of every
   residue mod 4 and an unaligned item array, t = 1, 8 and 32, b = 256,
   4,096 and 2^31 and items near 2^31 - 1, against its plain version and
   the padded entry; its distinct entry over the same rows, t = 1, 3, 8,
   12 and 32, b = 256 and 2^31, depth 1, 3, 6 and 8, against its plain
   version;
4. main path — ``knn_build`` on ml1M@1.0 with the paper's parameters
   (k=30) into a temporary index, then ``knn_serve`` of 2,048 unseen
   profiles (k=10, beam 32, 3 hops) in waves of 256 with the fused hop,
   then with ``--continuous --slots 256 --kernel --dma`` and with
   ``--kernel --dma`` in waves of 256: both must serve ids and sims
   bitwise equal, rid by rid, to the fused-hop waves, as must the plain
   hop; 256 of those profiles served with ``--beam 128`` by the plain hop,
   ``--kernel`` and ``--kernel --dma``, equal rid by rid; then
   ``dataset_minhash`` of ml1M@1.0 through the CSR entry, equal to the host
   hashing and the padded entry; then ``build_plan`` of ml1M@1.0 and of a
   c2-ml10M dataset (``c2bench/data.py``) on the card, one launch of the
   distinct entry each, plans equal to the host's and the table bitwise
   ``user_distinct_hashes_np``, with its device time. Each path is driven with the launch counts
   set to 0 just before it and read just after, and each kernel must have
   launched on its path. A small build on the card must equal the CPU's;
4b. mutable index — over the same paper index, ``knn_serve --insert 256
   --churn 128 --repair-every 1`` of the 2,048 profiles five ways (plain,
   fused and DMA hop in waves; DMA and plain hop through 256 continuous
   slots): equal served ids and sims rid by rid, equal mutated index
   (rows, cluster tables, version); ``--continuous --slots 256 --ttl 8``,
   plain against DMA hop, with rows expiring mid-serve; inserts past
   ``capacity_of(n, 64)`` on ml1M@0.05, in waves and between continuous
   ticks, plain against DMA hop. On every path the plan's journal-synced
   device tables equal a fresh upload, no request is served an id that
   was tombstoned when it was served, and each kernel path launched its
   hop. Then the scrub comparator through the plain, fused and DMA hops;
   the host clock of one insert, delete, update and repair pass; and the
   build's quality: ``brute_force_knn`` of ml1M@1.0 at k=30 through the
   cluster-KNN kernel, bitwise against its plain version and timed, the
   exact-Jaccard ``avg_sim`` of the C² and brute-force graphs (equal on
   the card and the CPU) and their ratio (paper Eq. 2), which must lie in
   (0, 1.05], beside the C² build's time;
4c. sharded placement — over the same paper index, ``knn_serve --shards
   4`` of the 2,048 profiles as wave x {plain, fused, DMA hop} and
   continuous (256 slots) x DMA hop, bitwise equal rid by rid, each kernel
   path launching its hop only through the sharded entry (one launch per
   hop for the 4 shards), and wave x fused hop at ``--shards 2``; the
   mutation serve ``--shards 4 --insert 256 --churn 128 --repair-every
   1`` three ways (plain and fused hop in waves, DMA hop in continuous
   slots), bitwise in served ids and sims and in the mutated index, no
   request served an id dead when served, the delta-synced shard tables
   equal to a rematerialisation, with the plans' sync() counts; both
   hops' shard grid axis at the main path's first hop on 4 shards (beam
   32: 12 lanes a shard) and on 2 shards at beam 256 (192 lanes a shard,
   state in global memory), 256 queries and one, against the plain
   sharded hop and S single-shard launches;
4d. SLO admission, adaptive budgets, the result cache, re-balance and
   tiered residency — over the same paper index, each path through
   ``QueryEngine`` with its launch counts from 0, each launching its hop:
   the 2,048 profiles then the first 1,024 again with a 4,096-entry cache
   and without, wave x fused hop and continuous (256 slots) x DMA hop,
   bitwise equal rid by rid with 1,024 hits, and a continuous cache-on
   serve with 64 inserts arriving eight a tick over its first eight
   ticks (flushed by each), serving hits after the last flush, equal to
   cache off; SLO admission on a ManualClock (a quarter class 0, every
   eighth class-1 deadline expiring before the first step, the queue
   bounded at 1,024) as wave x {plain, fused hop} and continuous x DMA
   hop: the same shed rids, every served rid the FIFO serve's, no class-1
   request completed before the last class-0 one in waves, and a
   host-clock serve for latency by class; ``--adaptive 1`` and ``2``
   continuous x {plain, fused, DMA hop}, bitwise across scorers, ticks,
   slot hops and recall beside the non-adaptive serve; ``--shards 4
   --insert 256 --rebalance-every 1 --rebalance-threshold 1.0`` as wave x
   fused and continuous x DMA hop (a swap forced if the first check does
   not fire), equal rid by rid, the shard tables after every swap equal
   to a fresh ``ShardedDescent``, with the swaps' host clock, imbalance
   and ``merge_coverage``; continuous x {plain, DMA hop} with 256 inserts
   before the first tick and a swap forced before the second, slots in
   flight, that moves rows between shards (beam lanes relabelled and
   evicted to PAD), equal rid by rid; a cache-on continuous serve with a
   swap forced before every tick on the fixed index, slots in flight,
   equal to the serve without swaps and flushed at each swap; ``--shards 4 --resident-configs 4`` and ``2``
   three ways each, bitwise, with resident rows, MB and recall; and a
   small synth serve with every knob on, equal on the card and the CPU;
4e. faults and crash recovery — over the same paper index at ``--shards
   4`` through ``QueryEngine``: ``kill:1@2`` (max_retries 2, backoff cap
   2, recover_after 2: the degraded window and the failover inside the
   serve of the 2,048 profiles) as wave (64 a wave) x {plain, fused, DMA
   hop} and continuous (256 slots) x {plain, DMA hop}, equal rid by rid
   within a batching with equal fault stats, each kernel path launching
   its hop through the sharded entry alone, the tables after the failover
   a fresh ``ShardedDescent``'s and a re-serve bitwise phase 4c's healthy
   ``--shards 4`` serve, with the degraded window's QPS and recall@10
   beside the healthy fleet's and the failover's host clock; ``fail:2@1+2``
   ending with no death and no failover; a cache-on serve across the kill
   (degraded results skipped, every repeat the healthy answer); a crash
   store (``--snapshot-every 2``) with 256 inserts and ``crash@5``,
   recovered as wave x {plain, DMA hop} to the index and the answers of a
   mirror that never crashed, with the snapshots' ms and bytes, the WAL's
   ms a record, the replay's and the recovery's ms; and a small synth
   serve with every fault knob on, then a crash, each store recovered on
   the other device, equal on the card and the CPU;
4f. baselines and raw mode — at k = 10 and the paper benches' scaling
   (``bench/common.bench_params``: b ≈ n/16, N ≈ 3% of n, t = 8, ρ = 5):
   one row of Table II on ml1M@1.0, brute force through the cluster-KNN
   kernel as the exact graph, then Hyrec and NNDescent (30 iterations at
   most, δ 0.001), LSH (t = 8; at least one bucket takes Alg. 2's Hyrec
   branch) and C², each with its host clock, quality (Eq. 2), iterations
   and updates, and C²'s speed-up over the best baseline; the same four
   on ml1M@0.35 on the card and on the CPU, bitwise (ids, sims and
   stats); Tables IV and V on AM@0.055 (171,356 items): C² with
   FastRandomHash on 1,024-bit GoldFinger, with the MinHash plan and on
   incidence rows (raw mode, W = 5,355), every Step-2 batch of the raw
   build bitwise against the plain version and its edge sims equal to the
   exact Jaccard, with the raw sweep's device time beside its bound;
4k. one device per shard (run after phase 4f; the device list is
   ``cuda:i mod the cards present``, so one card runs every entry and S
   cards place them truly) — (i) ``distributed_c2`` of ml1M@1.0
   (``params_for("ml1M", k=30)``) over 4 LPT bins, its ids and sims
   bitwise phase 4's single-card build, with the LPT imbalance and each
   bin's cluster-KNN launches; (ii) ``QueryEngine(shard_devices=...)`` at
   ``--shards 4`` serving the 2,048 profiles as wave x fused hop and
   continuous (256 slots) x DMA hop, one hop launch a shard, rid by rid
   bitwise phase 4c's one-launch serve; (iii) a forced re-balance swap
   (rebuilt from the host index, which holds the merge of the old
   shards' rows), its tables a fresh build's, its merge audit printed
   and a re-serve bitwise phase 4c's; (iv) ``kill:1@2`` in waves of 64
   x fused hop with its failover, rid by rid and in fault stats phase
   4e's stacked run; (v) one 4-shard x 256-query hop of each
   kernel as 4 per-device launches beside the one launch for all shards,
   device time in turns, bitwise equal outputs; (vi) each
   ``examples/*_torch.py`` once (``train_lm_torch --steps 20``,
   ``knn_recommend_torch --kernel``), each launching its kernels;
4g. LM serving (the dense family; no C² kernel runs, none may launch;
   run after phase 5, whose conditions stay as they were) —
   (a) Llama-3.2-1B at its full published config (16 layers, d 2,048,
   vocab 128,256, bf16 compute, f32 parameters, seed 0 on the card)
   through ``launch/serve``'s own ``build`` and ``run``: ``--requests 32
   --max-batch 8 --max-prompt 512 --max-new 64`` in waves, then the same
   requests with ``--continuous --slots 8``; every request completes with
   its budget of 2-64 tokens and every logit the engine reads is finite;
   (b) at full width, a B = 4, S = 512 prefill and one decode step
   against ``forward`` (the reference test's check, 0.15 bound); (c)
   Llama-3.2-1B's and Gemma-2B's full widths at 2 layers, weights made on
   the CPU and copied to the card: prefill and decode logits (1e-4) and
   engine tokens rid by rid in waves and in continuous slots at f32
   compute (a token may differ only at a near tie), and bf16 logits
   (0.15) with ``allow_bf16_reduced_precision_reduction`` as set and
   flipped; (d) one 8 x 512 prefill, a decode step at batch 8 and at 8
   slots (CUDA events, held and host-paced), tokens/s of both serves,
   peak memory and the decode step's bound (``roofline``: the dry-run's
   FLOPs by dtype at their peaks, the least bytes at the HBM rate);
4h. LM serving, the MoE and recurrent families (no C² kernel launches
   in the phase; one model on the card at a time) — (a) OLMoE-1B-7B at
   its full published config (16 layers, d 2,048, 16 heads of 128, 64
   experts top-8 of d_ff 1,024, vocab 50,304; f32 parameters, bf16
   compute, seed 0 on the card) through ``launch/serve``'s ``build`` and
   ``run`` with phase 4g's flags, in waves, then through 8 continuous
   slots: every request completes with its budget, every logit the
   engine reads is finite; tokens equal across modes are counted, not
   required (the expert capacity follows each call's token count), and
   each prefill's capacity drops are printed by layer; (b) RecurrentGemma-
   2B and xLSTM-125M at their full published configs served the same
   way, their tokens equal across modes (xLSTM's by phase 4g's near-tie rule); (c) the three models' full widths
   at 2 layers (one layer of each block kind), weights made on the CPU
   and copied to the card: prefill and 3 decode steps at f32 (1e-4; for
   OLMoE the (token, layer) expert choices compared first, a differing
   one allowed only where the CPU side's 8th/9th router probabilities lie
   within 1e-5, the logits held while every choice agrees), engine tokens
   rid by rid per mode (phase 4g's near-tie rule) and bf16 prefill
   logits (0.15); (d) for each model one 8 x 512 prefill (CUDA events and
   its kernels by ``torch.profiler``), a decode step at batch 8 and at 8
   slots (held and host-paced, kernels a step), tokens/s of both serves,
   peak memory serving and building, and the decode step's bound
   (phase 4g's ``roofline`` bound)
   (for OLMoE also the least: only the experts the step chose, with the
   distinct experts per layer);
4i. LM training (run after phase 4h; FastRandomHash is the one C² kernel
   on the path) — (a) one ``train_step`` (remat, AdamW from zero state)
   at the full published widths and 2 layers (one layer of each block
   kind) of Llama-3.2-1B, OLMoE-1B-7B, RecurrentGemma-2B and xLSTM-125M,
   weights drawn on the card and copied to the CPU, tokens and labels
   drawn apart: at f32 compute the loss, ce, aux loss and gradient norm
   (1e-5 relative; aux 1e-4), m and v leaf by leaf (1e-4 / 2e-4 of a
   leaf's largest entry) and every new parameter (1e-6 where the CPU's
   |m| >= 1e-7, AdamW's step range elsewhere), OLMoE's expert choices
   first (phase 4h's rule), the card's step run twice (bitwise or not,
   printed); at bf16 compute the card's step's loss against the CPU's
   ``loss_fn`` (1e-3 relative); (b) Llama-3.2-1B
   at its full published config through ``launch/train --batch 8 --seq
   512 --steps 8 --data-order c2`` (f32 parameters and AdamW state, bf16
   compute, remat): 8 finite losses, the last below the first; median
   step ms of the last 5, tokens/s, peak memory, the step's ``roofline``
   bound; one
   step under ``torch.profiler``: kernels, device ms by class, the
   device's idle share; FastRandomHash launched once (the c2 order,
   equal to the host hashing's) and no other C² kernel; the full
   (params, opt_state) saved and restored once, timed, bitwise; (c) the
   restart contract at 2 layers and full width, for Llama-3.2-1B and
   OLMoE-1B-7B: ``--fail-at-step 3`` exits 42, the resumed run's final
   loss within 1e-4 of a straight run's (bitwise printed), and Llama's
   card checkpoint restored on the CPU equal to the card's state;
4j. LM analysis tools (run after phase 4i; no C² kernel) — (a) the
   dry-run (``launch/dryrun``, meta tensors) of phase 4i's train step
   and of each family's batch-8 decode step over 576 slots (Llama-3.2-1B,
   OLMoE-1B-7B, RecurrentGemma-2B, xLSTM-125M at full depth), the counts
   phases 4g-4i took their bounds from, against the same steps built on
   the card and counted there by the same ``OpCounter``: FLOPs by dtype
   equal as integers, with kernels, eager bytes and peaks beside; (b) the
   dry-run's predicted peak of the train step within 25% of phase 4i's
   measured peak; (c) the mesh dry-run (``launch/dryrun --mesh``'s
   ``fake_world``, meta tensors) of phase 4l's train step per card on
   (1, 1), (2, 2), (1, 4) and (4, 1), counted on the CPU in a subprocess
   started before phase 4g: each mesh's predicted per-card peak and
   collective bytes by kind, logged;
4l. the mesh's LM half (run after phase 4j; FastRandomHash is the one C²
   kernel on the path) — a one-rank ``nccl`` process group in this
   process and ``make_host_mesh()``'s (1, 1) ("data", "model") mesh,
   every collective an identity, under ``torch.use_deterministic_
   algorithms`` (the backward's float atomics then add in a fixed order):
   (a) Llama-3.2-1B at its full published config, 3 ``train_step``s with
   ``ctx`` and ``grad_shardings`` (the parameters') on ``data/tokens``'
   c2-ordered 8 x 512 batches (FastRandomHash launched once), and the
   unsharded steps from the same init: losses, gradient norms, every
   parameter and moment bitwise, step ms and peak GB of both; (b)
   OLMoE-1B-7B at its full published config, 8 requests through
   ``Engine(ctx=)`` in a wave and through 8 slots (the expert-parallel
   branch at model size 1) and through the unsharded engine: tokens rid
   by rid and every MoE call's expert choices equal, every logit finite;
   (c) a 2-layer Llama-3.2-1B checkpoint (params and AdamW state) saved
   whole and read back by ``restore_sharded``, every leaf bitwise; (d)
   one sharded train step counted on the card by ``OpCounter`` against
   phase 4j's (1, 1) prediction: FLOPs by dtype equal as integers, no
   collective bytes on either side.
   ``lm_mesh_alone`` runs the phase alone and, on four cards, one process
   a card over meshes (2, 2), (1, 4) and (4, 1), held to the one-card
   results, with each card's peak memory; each rank also counts one
   train step on its card, held to the mesh dry-run's prediction for its
   mesh (FLOPs by dtype and collective bytes by kind equal as integers,
   the card's training peak within 25% of the predicted one);
5. timing — each kernel at the main path's shapes (all of Step 2's
   cluster batches; the first hop of a 256-query wave, fused and DMA;
   FastRandomHash of ml1M@1.0), held bitwise against its plain version
   there, and timed beside it and the least time the card could take
   (``bound_ms``); both hops' one-launch 4-shard hop of 256 queries
   beside 4 single-shard launches, its plain version and its bound, and
   the host clock of ``shard_seeds``; both hops' cycles per block by phase
   (``repro_torch.bench.hop_phases``) and resident warps per SM; the
   Step-2 sweep's device time per capacity group
   beside its host clock; the host clock per phase of a wave and of
   continuous ticks; both FastRandomHash entries' device time; where the
   ml1M@1.0 build's clustering (the distinct-hash table from the card,
   splits, the rest) and one wave's routing (item hashes and distinct
   hashes on the host, the rest) spend their host clock.

Prints one ``{"kernels": [...]}`` JSON line (every row also carries phase
4k's launches under ``phase_4k``; the hop rows also carry the
sharded placement's launches and 4-shard hop time under ``sharded``, and
phases 4d's and 4e's launches path by path under ``phase_4d`` and
``phase_4e``; the cluster-KNN row the raw build's sweep under ``raw``;
the FastRandomHash row phase 4i's launches under ``phase_4i`` and
phase 4l's under ``phase_4l``) after a
``{"phase_4e": ...}``, a ``{"phase_4f": ...}``, an ``{"lm_serve": ...}``
(phase 4g's figures and checks), an ``{"lm_serve_4h": ...}`` (phase
4h's), an ``{"lm_train": ...}`` (phase 4i's), an ``{"lm_analysis":
...}`` (phase 4j's), an ``{"lm_mesh": ...}`` (phase 4l's) and a
``{"phase_4k": ..., "phase_seconds": ...}``
line (phase 4k's figures, each phase's seconds); then the card's
name and power limit; then phase 4f's times, qualities and counts, the
cluster-KNN row's times, OLMoE's tokens/s, decode ms and bounds and
phase 4i's losses, step ms, tokens/s, idle share and checkpoint times
and phase 4j's FLOP agreement and peaks under short keys
(``tail_summary``), so that a short tail of the log
still holds them;
then as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The card's peaks (NVIDIA's H100 SXM data sheet, dense), one place for
# the port (``repro_torch.launch.mesh``): HBM3 bytes/s; int8 tensor-core
# operations/s (the bound counts the GoldFinger intersection as the int8
# bit-plane product, 2 operations per bit per pair, the cheapest form of
# the same work on this card); the CUDA-core rate (float32 outside the
# tensor cores; the card's int32 ALUs are no faster, so this under-states
# the least time of integer hashing); the bf16 tensor-core rate.
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_OPS_PER_S,
    PEAK_FLOPS_F32 as CUDA_CORE_OPS_PER_S, PEAK_OPS_INT8 as INT8_OPS_PER_S)
# Integer operations of one FastRandomHash (item, seed): the xor with the
# seed mix, fmix32's three shift-xors and two multiplies, the mask and
# the min.
MINHASH_OPS = 11
# A sleep of ~25 ms at the H100's clocks: longer than the host takes to
# queue a whole Step-2 sweep behind it.
SLEEP_CYCLES = 50_000_000

CLUSTER_KNN_SOURCE = "src/repro_torch/csrc/goldfinger_knn.cu"
HOP_WARPS = 16  # warps of a hop block (csrc/hop_common.cuh kThreads / 32)
HOP_SOURCE = "src/repro_torch/csrc/descent_hop.cu"
DMA_SOURCE = "src/repro_torch/csrc/descent_hop_dma.cu"
MINHASH_SOURCE = "src/repro_torch/csrc/frh_minhash.cu"
CLUSTER_KNN_REPLACES = ("src/repro/kernels/goldfinger_knn/goldfinger_knn.py"
                        ":96")
HOP_REPLACES = "src/repro/kernels/descent_score/descent_score.py:177"
DMA_REPLACES = "src/repro/kernels/descent_score/descent_score.py:407"
MINHASH_REPLACES = "src/repro/kernels/frh_minhash/frh_minhash.py:48"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, inner: int = 1, hold: bool = False) -> float:
    """Median over ``reps`` of the time between events around ``inner``
    calls, / inner. Without ``hold`` the events span the host's queueing
    too wherever it is slower than the device; with ``hold`` a sleep kernel
    holds the card until every call is queued, so they span device time
    alone."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_ms(fn, reps: int, flush) -> float:
    """Median device time of one call of ``fn`` with the L2 cache flushed
    before each (``flush``: a tensor larger than the 50 MB L2, rewritten
    outside the timed span); a sleep kernel after the flush holds the card
    while the call is queued, so the events span device time alone."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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


def same_knn(ki, ks, pi, ps) -> bool:
    """Kernel (ids, sims) [..., k] against the plain version's, which keeps
    only min(k, nd) columns: the rest must be PAD/-inf."""
    import torch

    from repro_torch.types import PAD_ID

    w = pi.shape[-1]
    return (torch.equal(ki[..., :w], pi) and torch.equal(ks[..., :w], ps)
            and bool((ki[..., w:] == PAD_ID).all())
            and bool((ks[..., w:] == float("-inf")).all()))


def check_cluster_knn(dev) -> tuple[int, float]:
    """The cluster-KNN kernel against its plain version, bitwise: W from 1
    to 64 words (16- and 4-byte copies), k from 1 to 64 (one and two keys
    per lane) and above (65, 100 and 256 merged in shared memory, 2,048 in
    global memory; k above a cluster's size), caps 32 to 2048 with a full
    cap-2048 cluster, PAD ids at the end of clusters and scattered through
    them (their rows keep garbage words, as ``batch_inputs`` gives them), a
    batch of lone members, and equal sims planted in every 32-row database
    tile, so that ties meet across the warps' slices; then one call of
    70,000 two-member clusters (two launches), and ``knn`` with nq != nd."""
    import numpy as np
    import torch

    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor
    from repro_torch.types import PAD_ID

    # (cap, W, k, clusters, how PAD ids are placed)
    cases = [(32, 32, 10, 6, "tail"), (32, 1, 1, 6, "scatter"),
             (64, 31, 64, 4, "scatter"), (128, 33, 30, 4, "tail"),
             (256, 64, 10, 3, "scatter"), (512, 32, 30, 4, "tail"),
             (512, 1, 64, 2, "tail"), (1024, 33, 64, 2, "scatter"),
             (1024, 32, 30, 2, "scatter"), (2048, 32, 30, 2, "tail"),
             (2048, 64, 10, 2, "scatter"), (2048, 31, 1, 1, "tail"),
             (64, 32, 30, 40, "lone"), (2048, 32, 64, 3, "lone"),
             (32, 32, 65, 6, "tail"), (64, 31, 100, 4, "scatter"),
             (256, 32, 256, 3, "tail"), (1024, 32, 100, 2, "scatter"),
             (128, 33, 256, 3, "lone"), (2048, 32, 2048, 2, "tail")]
    n_checked, err = 0, 0.0
    for cap, W, k, m, pad in cases:
        rng = np.random.default_rng(cap * 100 + W + k)
        words = random_words(rng, (m, cap, W))
        # Planted equal sims: repeated fingerprints tie against everyone,
        # and every 32-row tile holds a copy of row 0 and of row 3.
        words[:, 1::7] = words[:, :1]
        words[:, 2::11] = words[:, 3:4]
        words[:, 5::32] = words[:, :1]
        words[:, 17::32] = words[:, 3:4]
        card = popcount_rows(words.reshape(-1, W)).reshape(m, cap)
        ids = rng.permutation(m * cap * 4)[: m * cap].astype(
            np.int32).reshape(m, cap)
        if pad == "lone":
            ids[:, 1:] = PAD_ID  # every cluster a lone member
        else:
            sizes = rng.integers(2, cap + 1, size=m)
            sizes[0] = cap  # a full cluster
            sizes[-1] = 1  # a lone member: every slot PAD
            for j, size in enumerate(sizes):
                if pad == "tail":
                    ids[j, size:] = PAD_ID
                    card[j, size:] = 0
                    words[j, size:] = 0
                else:
                    ids[j, rng.permutation(cap)[: cap - size]] = PAD_ID
        w = words_tensor(words, dev)
        c = torch.from_numpy(card).to(dev)
        i = torch.from_numpy(ids).to(dev)
        ki, ks = ops.cluster_knn(w, c, i, k)
        pi, ps = ref.cluster_knn_ref(w, c, i, k)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ks[..., :pi.shape[-1]], ps))
        if not same_knn(ki, ks, pi, ps):
            bad = (ki[..., :pi.shape[-1]] != pi) | (ks[..., :pi.shape[-1]]
                                                    != ps)
            fail(f"cluster-KNN cap={cap} W={W} k={k} PAD {pad}: "
                 f"{int(bad.sum())} entries differ from the plain version")
        n_checked += 1
        log(f"[kernels] cluster_knn cap={cap} W={W} k={k} m={m} PAD {pad} "
            f"(lists {ops.launch_params(cap, cap, W, k).lists}): bitwise ok")
    # More clusters than one launch's grid takes (65,535): two launches.
    m, cap, W, k = 70_000, 32, 32, 30
    rng = np.random.default_rng(m)
    words = random_words(rng, (m, cap, W))
    ids = np.full((m, cap), PAD_ID, np.int32)
    ids[:, :2] = np.arange(2 * m, dtype=np.int32).reshape(m, 2)
    words[ids == PAD_ID] = 0
    card = popcount_rows(words.reshape(-1, W)).reshape(m, cap)
    w = words_tensor(words, dev)
    c = torch.from_numpy(card).to(dev)
    i = torch.from_numpy(ids).to(dev)
    before = ops.launches
    ki, ks = ops.cluster_knn(w, c, i, k)
    pi, ps = ref.cluster_knn_ref(w, c, i, k)
    torch.cuda.synchronize()
    if ops.launches - before != 2 or not same_knn(ki, ks, pi, ps):
        fail(f"cluster-KNN over {m} two-member clusters: "
             f"{ops.launches - before} launches, bitwise "
             f"{same_knn(ki, ks, pi, ps)}")
    err = max(err, max_abs_err(ks, ps))
    n_checked += 1
    log(f"[kernels] cluster_knn {m} two-member clusters (cap={cap} W={W} "
        f"k={k}) in 2 launches: bitwise ok")
    # knn with query and database counts that differ and are not multiples
    # of the tiles.
    for nq, nd, W, k in ((200, 300, 32, 30), (17, 1000, 32, 30),
                         (1000, 17, 32, 30), (1000, 17, 33, 10)):
        rng = np.random.default_rng(nq + nd + W)
        qw, dw = random_words(rng, (nq, W)), random_words(rng, (nd, W))
        qw[::5] = dw[0]
        qi = np.arange(nq, dtype=np.int32)
        di = np.arange(nd // 2, nd // 2 + nd, dtype=np.int32)
        di[rng.random(nd) < 0.1] = PAD_ID
        args = [words_tensor(qw, dev),
                torch.from_numpy(popcount_rows(qw)).to(dev),
                torch.from_numpy(qi).to(dev), words_tensor(dw, dev),
                torch.from_numpy(popcount_rows(dw)).to(dev),
                torch.from_numpy(di).to(dev)]
        ki, ks = ops.knn(*args, k)
        pi, ps = ref.knn_ref(*args, k)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ks[..., :pi.shape[-1]], ps))
        if not same_knn(ki, ks, pi, ps):
            fail(f"knn {nq}x{nd} W={W} k={k}: differs from the plain version")
        n_checked += 1
        log(f"[kernels] knn nq={nq} nd={nd} W={W} k={k}: bitwise ok")
    return n_checked, err


def check_cluster_knn_wide(dev) -> tuple[int, float]:
    """The cluster-KNN kernel at rows wider than a block holds whole (its
    chunked instances), bitwise against its plain version: W = 1,105 (just
    past the whole-row limit), 2,048 and 4,236 (16-byte copies; GW's raw
    width), 5,355 and 6,345 (4-byte copies; AM's and DBLP's raw widths),
    each at k = 10, 30 and 100, caps 32 to 256, PAD ids at cluster ends
    and scattered, equal sims planted in every database tile; then ``knn``
    at 17 x 1,000 rows of 5,355 words. Each case logs its launch
    parameters."""
    import numpy as np
    import torch

    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor
    from repro_torch.types import PAD_ID

    caps = (32, 64, 128, 256)
    n_checked, err = 0, 0.0
    for wi, W in enumerate((1105, 2048, 4236, 5355, 6345)):
        for ki, k in enumerate((10, 30, 100)):
            cap = caps[(wi + ki) % len(caps)]
            pad = ("tail", "scatter")[(wi + ki) % 2]
            m = 3
            rng = np.random.default_rng(W * 10 + k)
            words = random_words(rng, (m, cap, W), density_rounds=4)
            words[:, 1::7] = words[:, :1]
            words[:, 5::32] = words[:, :1]
            words[:, 17::32] = words[:, 3:4]
            card = popcount_rows(words.reshape(-1, W)).reshape(m, cap)
            ids = rng.permutation(m * cap * 4)[: m * cap].astype(
                np.int32).reshape(m, cap)
            for j, size in enumerate((cap, int(rng.integers(2, cap)), 1)):
                if pad == "tail":
                    ids[j, size:] = PAD_ID
                    card[j, size:] = 0
                    words[j, size:] = 0
                else:
                    ids[j, rng.permutation(cap)[: cap - size]] = PAD_ID
            w = words_tensor(words, dev)
            c = torch.from_numpy(card).to(dev)
            i = torch.from_numpy(ids).to(dev)
            ki_, ks = ops.cluster_knn(w, c, i, k)
            pi, ps = ref.cluster_knn_ref(w, c, i, k)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(ks[..., :pi.shape[-1]], ps))
            p = ops.launch_params(cap, cap, W, k)
            if not same_knn(ki_, ks, pi, ps):
                bad = ((ki_[..., :pi.shape[-1]] != pi)
                       | (ks[..., :pi.shape[-1]] != ps))
                fail(f"cluster-KNN cap={cap} W={W} k={k} PAD {pad} ({p}): "
                     f"{int(bad.sum())} entries differ from the plain "
                     f"version")
            n_checked += 1
            log(f"[kernels] cluster_knn cap={cap} W={W} k={k} m={m} PAD "
                f"{pad} ({'16' if W % 4 == 0 else '4'}-byte copies; {p}): "
                f"bitwise ok")
    nq, nd, W, k = 17, 1000, 5355, 30
    rng = np.random.default_rng(nq + nd + W)
    qw, dw = random_words(rng, (nq, W), 4), random_words(rng, (nd, W), 4)
    qw[::5] = dw[0]
    di = np.arange(nd // 2, nd // 2 + nd, dtype=np.int32)
    di[rng.random(nd) < 0.1] = PAD_ID
    args = [words_tensor(qw, dev), torch.from_numpy(popcount_rows(qw)).to(dev),
            torch.arange(nq, dtype=torch.int32, device=dev),
            words_tensor(dw, dev), torch.from_numpy(popcount_rows(dw)).to(dev),
            torch.from_numpy(di).to(dev)]
    ki_, ks = ops.knn(*args, k)
    pi, ps = ref.knn_ref(*args, k)
    torch.cuda.synchronize()
    err = max(err, max_abs_err(ks, ps))
    if not same_knn(ki_, ks, pi, ps):
        fail(f"knn {nq}x{nd} W={W} k={k}: differs from the plain version")
    log(f"[kernels] knn nq={nq} nd={nd} W={W} k={k} "
        f"({ops.launch_params(nq, nd, W, k)}): bitwise ok")
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
                           tomb=tomb, with_counts=True)[:3]


def dma_kernel(graph, rev, words, card, qw, qc, beam, sims, tomb, **kw):
    from repro_torch.kernels.descent_score import ops

    return ops.descent_hop(graph, rev, words, card, qw, qc, beam, sims,
                           tomb=tomb, dma=True, with_counts=True, **kw)


def dma_plain(graph, rev, words, card, qw, qc, beam, sims, tomb):
    from repro_torch.kernels.descent_score import ref

    ids, out, n_scored = hop_plain(graph, rev, words, card, qw, qc, beam,
                                   sims, tomb)
    C = beam.shape[1] * (graph.shape[1] + rev.shape[1])
    return (ids, out, n_scored) + ref.dma_counts(n_scored, words.shape[1], C)


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


def check_dma_counts(out, W: int, C: int) -> bool:
    """dma_bytes == n_scored·W·4 and bytes_saved == (C − n_scored)·W·4,
    exactly, with ``n_scored`` counted apart from the copies."""
    import torch

    n_scored, dma_bytes, saved = out[2:]
    return (torch.equal(dma_bytes, n_scored * (W * 4))
            and torch.equal(saved, (C - n_scored) * (W * 4)))


def check_dma_case(label, args, err, **kw) -> float:
    """The DMA hop against its plain version and the hop kernel."""
    import torch

    graph, rev, words = args[:3]
    W = words.shape[1]
    C = args[6].shape[1] * (graph.shape[1] + rev.shape[1])
    d_out = dma_kernel(*args, **kw)
    p_out = dma_plain(*args)
    v_out = hop_kernel(*args)
    torch.cuda.synchronize()
    if not same_hop(d_out, p_out):
        fail(f"DMA hop {label}: differs from the plain version ("
             + ", ".join(f"{name} {torch.equal(a, b)}" for name, a, b in zip(
                 ("ids", "sims", "n_scored", "dma_bytes", "bytes_saved"),
                 d_out, p_out)) + ")")
    if not same_hop(d_out[:3], v_out):
        fail(f"DMA hop {label}: differs from descent_hop.cu")
    if not check_dma_counts(d_out, W, C):
        fail(f"DMA hop {label}: byte counters disagree with n_scored")
    n_scored = int(d_out[2].sum())
    log(f"[kernels] descent_hop_dma {label}: bitwise ok (scored {n_scored} "
        f"of {args[6].shape[0] * C} lanes, counters {int(d_out[3].sum())} B "
        f"fetched, {int(d_out[4].sum())} B skipped; rows read "
        f"{distinct_rows(args)})")
    return max(err, max_abs_err(d_out[1], p_out[1]))


def distinct_rows(args) -> int:
    """Rows both hop kernels read: one per distinct surviving candidate id
    of each query (``n_scored`` counts lanes, duplicates included)."""
    import torch

    from repro_torch.kernels.descent_score import ref

    graph, rev, beam, tomb = args[0], args[1], args[6], args[8]
    beam = ref.mask_dead(tomb, beam)
    cand = ref.gather_candidates(graph, rev, beam, tomb)
    kept = torch.where(ref.survivors(cand, beam), cand, -1)
    ids = torch.sort(kept, dim=1).values
    new = torch.ones_like(ids, dtype=torch.bool)
    new[:, 1:] = ids[:, 1:] != ids[:, :-1]
    return int((new & (ids >= 0)).sum())


def all_suppressed_inputs(dev):
    """Beams that hold every reachable row: every lane is suppressed."""
    import numpy as np
    import torch

    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor

    rng = np.random.default_rng(3)
    n, B, W = 6, 6, 4
    graph = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n],
                     axis=1).astype(np.int32)
    rev = np.stack([(np.arange(n) - 1) % n], axis=1).astype(np.int32)
    words = random_words(rng, (n, W))
    qw = random_words(rng, (5, W))
    beam = np.tile(np.arange(n, dtype=np.int32), (5, 1))
    sims = -np.sort(-rng.random((5, B))).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(graph), t(rev), words_tensor(words, dev),
            t(popcount_rows(words)), words_tensor(qw, dev),
            t(popcount_rows(qw)), t(beam), t(sims),
            torch.zeros(n, dtype=torch.bool, device=dev))


def check_dma_hop(dev) -> tuple[int, float]:
    import numpy as np

    from repro_torch.kernels.descent_score import ops, tune
    from repro_torch.types import PAD_ID

    # tune.smem_bytes mirrors the kernel's layout; the heuristic's choices
    # fit one block at the widths the tests sweep.
    lib = ops._lib_dma()
    for W in (1, 32, 33, 64, 1024):
        p = tune._heuristic(6038, W, 32, 60)
        for bq, chunk, nb in ((p.block_q, p.score_chunk, p.n_buffers),
                              (3, 100, 3), (1, 7, 1)):
            got = lib.repro_descent_hop_dma_smem_bytes(W, 30, 30, 32, bq,
                                                       chunk, nb, 0)
            if got != tune.smem_bytes(W, 60, 32, bq, chunk, nb):
                fail(f"tune.smem_bytes differs from the kernel's layout at "
                     f"W={W} ({bq}, {chunk}, {nb})")
        if tune.smem_bytes(W, 60, 32, p.block_q, p.score_chunk,
                           p.n_buffers) > tune.SMEM_LIMIT:
            fail(f"the tuner's DMA hop params at W={W} overflow a block")
    # Wide beams: the state in global memory, the ring alone in shared.
    for B in (128, 256, 1024):
        p = tune._heuristic(6038, 32, B, 60)
        got = (lib.repro_descent_hop_dma_smem_bytes(
                   32, 30, 30, B, 1, p.score_chunk, p.n_buffers, 1),
               lib.repro_descent_hop_dma_workspace_stride(32, 30, 30, B),
               ops._lib().repro_descent_hop_smem_bytes(32, 30, 30, B, 1),
               ops._lib().repro_descent_hop_workspace_stride(32, 30, 30, B))
        want = (tune.smem_bytes(32, 60, B, 1, p.score_chunk, p.n_buffers,
                                "global"),
                tune.workspace_stride(32, 60, B),
                tune.state_bytes(32, 60, B, 0, "global"),
                tune.workspace_stride(32, 60, B))
        where = tune.state_placement(32, 60, B, p.score_chunk * p.n_buffers)
        if where != "global" or got != want:
            fail(f"wide-beam layout at B={B}: kernel {got}, tune {want} "
                 f"({where})")
    log("[kernels] DMA hop shared-memory layout: tune.smem_bytes == the "
        "kernel's at W = 1, 32, 33, 64, 1024; both hops' global-state "
        "layouts at B = 128, 256, 1024")

    n_checked, err = 0, 0.0
    cases = [  # (n, W, tomb_frac, launch params)
        (6038, 32, 0.05, {}),
        (6038, 64, 0.05, {}),
        (300, 33, 0.05, {}),                 # 4-byte copies
        (300, 32, 0.6, {}),                  # tombstone-heavy, duplicates
        (6038, 32, 0.05, {"score_chunk": 100, "n_buffers": 2}),
        (300, 33, 0.3, {"score_chunk": 7, "n_buffers": 1}),
        (6038, 64, 0.05, {"score_chunk": 64, "n_buffers": 3}),
        (300, 32, 0.05, {"block_q": 3, "score_chunk": 128}),
    ]
    for n, W, frac, kw in cases:
        rng = np.random.default_rng(W * 7 + n + int(frac * 100))
        args = hop_inputs(rng, dev, n, W, 30, 30, 256, 32, tomb_frac=frac)
        label = (f"n={n} W={W} tomb={frac:.0%} "
                 + " ".join(f"{k}={v}" for k, v in kw.items()))
        err = check_dma_case(label.strip(), args, err, **kw)
        n_checked += 1
    # Whole chunks with no surviving lane: the rows in every query's first
    # two beam lanes lose their forward edges, so chunks 0 and 1 (30 lanes
    # each) issue no copy at all.
    rng = np.random.default_rng(99)
    args = list(hop_inputs(rng, dev, 300, 32, 30, 30, 64, 32))
    first = args[6][:, :2]
    graph = args[0].clone()
    graph[first[first != PAD_ID].long()] = PAD_ID
    args[0] = graph
    err = check_dma_case("n=300 W=32 all-suppressed chunks 0-1 "
                         "score_chunk=30", tuple(args), err, score_chunk=30)
    err = check_dma_case("all lanes suppressed (n=6, W=4) score_chunk=5",
                         all_suppressed_inputs(dev), err, score_chunk=5)
    return n_checked + 2, err


def tied_inputs(rng, dev, n, W, kg, q, B):
    """Hop inputs with one fingerprint for every row: every candidate ties
    with every other, and a third of the beam lanes carry that same sim."""
    import numpy as np
    import torch

    from repro_torch.kernels.scoring import score_lanes
    from repro_torch.sketch.goldfinger import popcount_rows, words_tensor
    from repro_torch.types import NEG_INF, PAD_ID

    args = list(hop_inputs(rng, dev, n, W, kg, kg, q, B))
    words = np.repeat(random_words(rng, (1, W)), n, axis=0)
    args[2] = words_tensor(words, dev)
    args[3] = torch.from_numpy(popcount_rows(words)).to(dev)
    same = score_lanes(args[2], args[3], args[4], args[5],
                       torch.zeros_like(args[6][:, :1]))
    sims = args[7].clone()
    sims[:, 1::3] = torch.where(args[6][:, 1::3] == PAD_ID, NEG_INF, same)
    args[7] = sims
    return tuple(args)


def check_hop_shapes(dev) -> tuple[int, float]:
    """Both hops at the row groupings and list widths of the redesign, each
    against the plain version and each other with exact counters: W = 4, 8,
    33, 64, 65 (a row per 1, 2, 32, 16, 32 threads; 16-byte bulk copies at
    W % 4 == 0, 4-byte cp.async otherwise), beams of 1, 64, 128 and 512
    lanes (1, 2, 4 and 16 keys per lane) over few edges, so that their state
    fits a block, every beam PAD, every candidate naming one id, and every
    fingerprint equal, so that sims tie across ids and the column decides;
    then the beams the serving plan reaches over the paper index (kg+kr =
    60, W = 32): 128, 256 and 1,024 lanes, their state in global memory
    (1,024 through the radix select), random and tie-heavy; and 640 lanes
    over kg+kr = 2, the radix select with the state in shared memory;
    then 1,200 queries at 128 lanes, more than the card holds blocks, so
    that blocks walk queries (and groups of 3)."""
    import numpy as np
    import torch

    from repro_torch.kernels.descent_score import tune
    from repro_torch.types import NEG_INF, PAD_ID

    n_checked, err = 0, 0.0
    for n, W, B, kg in ((6038, 4, 32, 30), (6038, 8, 32, 30),
                        (300, 33, 32, 30), (6038, 64, 32, 30),
                        (300, 65, 32, 30), (6038, 32, 1, 30),
                        (300, 32, 1, 30), (6038, 32, 64, 30),
                        (300, 64, 64, 30), (6038, 32, 128, 15),
                        (6038, 32, 512, 2)):
        rng = np.random.default_rng(n + W * 11 + B * 101)
        args = hop_inputs(rng, dev, n, W, kg, kg, 256, B)
        err = check_dma_case(f"n={n} W={W} B={B} kg=kr={kg}", args, err)
        n_checked += 1
    rng = np.random.default_rng(5)
    args = list(hop_inputs(rng, dev, 6038, 32, 30, 30, 256, 32))
    args[6] = torch.full_like(args[6], PAD_ID)
    args[7] = torch.full_like(args[7], NEG_INF)
    err = check_dma_case("every beam PAD", tuple(args), err)
    # Every adjacency entry names row 7, which no beam holds.
    rng = np.random.default_rng(6)
    args = list(hop_inputs(rng, dev, 300, 32, 30, 30, 256, 32))
    args[0] = torch.full_like(args[0], 7)
    args[1] = torch.full_like(args[1], 7)
    beam = args[6].clone()
    beam[beam == 7] = PAD_ID
    args[6] = beam
    args[7] = torch.where(beam == PAD_ID, NEG_INF, args[7])
    args[8] = torch.zeros_like(args[8])
    err = check_dma_case("every candidate row 7", tuple(args), err)
    rng = np.random.default_rng(8)
    err = check_dma_case("every row equal: ties across ids",
                         tied_inputs(rng, dev, 6038, 32, 30, 256, 32), err)
    n_checked += 3
    for B, kg in ((128, 30), (256, 30), (1024, 30), (640, 1)):
        where = tune.state_placement(32, 2 * kg, B, 0)
        for tied in (False, True):
            rng = np.random.default_rng(B * 3 + kg + tied)
            args = (tied_inputs(rng, dev, 6038, 32, kg, 256, B) if tied
                    else hop_inputs(rng, dev, 6038, 32, kg, kg, 256, B))
            err = check_dma_case(
                f"n=6038 W=32 B={B} kg=kr={kg} ({where} state"
                + (", every row equal)" if tied else ")"), args, err)
            n_checked += 1
        ms = [cuda_ms(lambda: fn(*args), reps=3, inner=5, hold=True)
              for fn in (hop_kernel, dma_kernel)]
        log(f"[timing] hops at B={B} kg=kr={kg} ({where} state; every row "
            f"equal), 256 queries, device time: fused {ms[0]:.4f} ms, DMA "
            f"{ms[1]:.4f} ms")
    # More queries than resident blocks: each block walks several queries
    # (the DMA hop also in groups of 3) through its slice of the workspace.
    rng = np.random.default_rng(600)
    args = hop_inputs(rng, dev, 6038, 32, 30, 30, 1200, 128)
    err = check_dma_case("n=6038 W=32 B=128 kg=kr=30 q=1200 (global state, "
                         "blocks walk queries)", args, err)
    err = check_dma_case("n=6038 W=32 B=128 kg=kr=30 q=1200 block_q=3 "
                         "(global state, blocks walk groups)", args, err,
                         block_q=3)
    return n_checked + 2, err


def check_minhash(dev) -> tuple[int, float]:
    """FastRandomHash's padded entry at the reference test's shapes, then
    its CSR entry against its plain version and the padded entry: empty
    and one-item users, a user at ml1M@1.0's longest row (981 items), row
    offsets of every residue mod 4, the item array both 16-byte aligned
    and not (the 4-byte path), t = 1, 8 and 32, b = 256, 4,096 and 2^31,
    items near 2^31 - 1."""
    import numpy as np
    import torch

    from repro_torch.kernels.frh_minhash import ops, ref
    from repro_torch.types import PAD_ID

    n_checked = 0
    for n, P in ((8, 16), (100, 40), (256, 64), (300, 7)):
        for t in (1, 8):
            for b in (256, 4096):
                rng = np.random.default_rng(n + P + t + b)
                padded = rng.integers(0, 10**6, size=(n, P)).astype(np.int32)
                for i in range(n):
                    padded[i, int(rng.integers(1, P + 1)):] = PAD_ID
                padded[0] = PAD_ID
                seeds = np.arange(t, dtype=np.int32) * 7 + 1
                x = torch.from_numpy(padded).to(dev)
                got = ops.minhash(x, seeds, b)
                want = ref.minhash_ref(x, seeds, b)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"minhash n={n} P={P} t={t} b={b}: differs from "
                         f"the plain version")
                n_checked += 1
    log(f"[kernels] frh_minhash padded: {n_checked} shapes (n,P in (8,16), "
        f"(100,40), (256,64), (300,7); t 1/8; b 256/4096) bitwise ok")
    rng = np.random.default_rng(31)
    n = 3000
    sizes = rng.integers(0, 200, size=n)
    sizes[:6] = (0, 1, 0, 1, 981, 2)  # empty, one-item, the longest row
    sizes[rng.random(n) < 0.1] = 0
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    items = rng.integers(0, 2**31, size=int(offsets[-1]) + 1).astype(
        np.int32)
    near = rng.random(len(items)) < 0.2  # items near 2^31 - 1
    items[near] = 2**31 - 1 - rng.integers(0, 8, size=int(near.sum()))
    d_items = torch.from_numpy(items).to(dev)
    d_off = torch.from_numpy(offsets).to(dev)
    residues = np.bincount(offsets[:-1] % 4, minlength=4)
    n_csr = 0
    for aligned in (True, False):
        # items[1:] starts 4 bytes into the allocation: no 16-byte loads.
        it = d_items[:-1] if aligned else d_items[1:]
        host = items[:-1] if aligned else items[1:]
        padded = np.full((n, int(sizes.max())), PAD_ID, np.int32)
        for u in range(n):
            padded[u, :sizes[u]] = host[offsets[u]:offsets[u + 1]]
        x = torch.from_numpy(padded).to(dev)
        for t in (1, 8, 32):
            for b in (256, 4096, 1 << 31):
                seeds = (np.arange(t, dtype=np.int64) * 1_000_003 - 5).astype(
                    np.int32)
                got = ops.minhash_csr(d_off, it, seeds, b)
                want = ref.minhash_csr_ref(d_off, it, seeds, b)
                pad = ops.minhash(x, seeds, b)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(got, pad)):
                    fail(f"minhash_csr t={t} b={b} aligned={aligned}: "
                         f"plain {torch.equal(got, want)}, padded entry "
                         f"{torch.equal(got, pad)}")
                n_csr += 1
    log(f"[kernels] frh_minhash CSR: {n_csr} cases (n={n}, rows 0-981 items "
        f"with offsets = 0/1/2/3 mod 4 in {residues.tolist()} rows; items "
        f"16-byte aligned and not; t 1/8/32; b 256/4096/2^31) bitwise equal "
        f"to the plain version and to the padded entry")
    n_distinct = 0
    for aligned in (True, False):
        it = d_items[:-1] if aligned else d_items[1:]
        for t in (1, 3, 8, 12, 32):  # seed groups of 1, 4, 8, 8 + 4, 4 x 8
            seeds = (np.arange(t, dtype=np.int64) * 1_000_003 - 5).astype(
                np.int32)
            for b in (256, 1 << 31):
                for depth in (1, 3, 6, 8):
                    got = ops.distinct_csr(d_off, it, seeds, b, depth)
                    want = ref.distinct_csr_ref(d_off, it, seeds, b, depth)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        fail(f"distinct_csr t={t} b={b} depth={depth} "
                             f"aligned={aligned}: differs from the plain "
                             f"version")
                    n_distinct += 1
    log(f"[kernels] frh_minhash distinct: {n_distinct} cases (the CSR "
        f"rows above, aligned and not; t 1/3/8/12/32; b 256/2^31; depth "
        f"1/3/6/8) bitwise equal to the plain version")
    return n_checked + n_csr + n_distinct, 0.0


# -- datasets made once ----------------------------------------------------

@contextlib.contextmanager
def datasets_made_once(made: dict):
    """Within the block every ``make_dataset(name, scale, seed)`` — the
    script's own and those of ``launch/knn_build`` and ``launch/knn_serve``
    — draws its dataset once; a later call gets a copy of the first
    draw's arrays, which equal a fresh draw bitwise (the generator is a
    pure function of its arguments). ``made`` collects, per argument
    tuple, the calls and the seconds of the one draw."""
    import dataclasses

    from repro_torch.data import synthetic
    from repro_torch.launch import knn_build, knn_serve

    make = synthetic.make_dataset

    def once(name, scale=1.0, seed=0, min_profile=20):
        key = (name, float(scale), int(seed), int(min_profile))
        if key not in made:
            t0 = time.perf_counter()
            ds = make(name, scale=scale, seed=seed, min_profile=min_profile)
            made[key] = {"dataset": ds, "calls": 0,
                         "seconds": time.perf_counter() - t0}
        made[key]["calls"] += 1
        ds = made[key]["dataset"]
        return dataclasses.replace(ds, items=ds.items.copy(),
                                   offsets=ds.offsets.copy())

    modules = (synthetic, knn_build, knn_serve)
    for m in modules:
        m.make_dataset = once
    try:
        yield made
    finally:
        for m in modules:
            m.make_dataset = make


def datasets_line(made: dict) -> str:
    draws = sum(d["seconds"] for d in made.values())
    reused = sum(d["seconds"] * (d["calls"] - 1) for d in made.values())
    return (f"[datasets] {sum(d['calls'] for d in made.values())} "
            f"make_dataset calls, {len(made)} draws in {draws:.1f} s; the "
            f"reused calls would have drawn for ~{reused:.1f} s more: "
            + ", ".join(f"{k[0]}@{k[1]:g} seed {k[2]} x{d['calls']} "
                        f"({d['seconds']:.2f} s)" for k, d in made.items()))


# -- phase 4: the main path ------------------------------------------------

def reset_launches() -> None:
    from repro_torch.kernels.descent_score import ops as ds_ops
    from repro_torch.kernels.frh_minhash import ops as mh_ops
    from repro_torch.kernels.goldfinger_knn import ops as gk_ops

    gk_ops.launches = ds_ops.launches = ds_ops.launches_dma = 0
    ds_ops.launches_sharded = ds_ops.launches_dma_sharded = 0
    mh_ops.launches = mh_ops.launches_csr = mh_ops.launches_distinct = 0


def read_launches() -> dict:
    """Each kernel's launches; the hops' also as ``*_sharded``: those of
    them made through the sharded entry (``ops.descent_hop_sharded``);
    FastRandomHash's distinct entry (build Step 1's table on the card)
    apart from its min-hash entries, as ``frh_minhash_distinct``."""
    from repro_torch.kernels.descent_score import ops as ds_ops
    from repro_torch.kernels.frh_minhash import ops as mh_ops
    from repro_torch.kernels.goldfinger_knn import ops as gk_ops

    return {"goldfinger_knn": gk_ops.launches,
            "descent_hop": ds_ops.launches,
            "descent_hop_dma": ds_ops.launches_dma,
            "frh_minhash": mh_ops.launches + mh_ops.launches_csr,
            "frh_minhash_distinct": mh_ops.launches_distinct,
            "descent_hop_sharded": ds_ops.launches_sharded,
            "descent_hop_dma_sharded": ds_ops.launches_dma_sharded}


def served(engine):
    import numpy as np

    done = sorted(engine.done, key=lambda r: r.rid)
    return (np.stack([r.ids for r in done]), np.stack([r.sims for r in done]),
            [r.rid for r in done])


def serve_line(name: str, stats: dict, recall: float) -> str:
    return (f"{name}: QPS {stats['qps']:.1f}, "
            f"p50 {stats['p50_latency_s'] * 1e3:.2f} ms, "
            f"p95 {stats['p95_latency_s'] * 1e3:.2f} ms, "
            f"{stats['waves']} steps, recall@10 {recall:.4f}")


def main_path(dev, tmp: Path) -> dict:
    import numpy as np

    from repro_torch.launch import knn_build, knn_serve
    from repro_torch.types import PAD_ID

    index_path = str(tmp / "ml1m.npz")
    reset_launches()
    built = knn_build.main(["--dataset", "ml1M", "--scale", "1.0",
                            "--k", "30", "--seed", "0",
                            "--index-out", index_path, "--device", "cuda"])
    serve_args = ["--index", index_path, "--dataset", "ml1M",
                  "--scale", "1.0", "--queries", "2048", "--k", "10",
                  "--beam", "32", "--hops", "3", "--max-wave", "256",
                  "--seed", "0", "--device", "cuda"]
    stats, recall, engine = knn_serve.main(serve_args + ["--kernel"])
    path1 = read_launches()
    log(f"[main] launches on build + wave x pallas: {path1}")
    for name in ("goldfinger_knn", "descent_hop"):
        if path1[name] <= 0:
            fail(f"the main path never launched the {name} kernel")
    if path1["frh_minhash_distinct"] != 1:
        fail(f"the main path's build launched FastRandomHash's distinct "
             f"entry {path1['frh_minhash_distinct']} times, not once")
    launches = {name: path1[name]
                for name in ("goldfinger_knn", "descent_hop",
                             "frh_minhash_distinct")}

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
    log("[main] serve " + serve_line("wave x pallas", stats, recall))

    j_stats, j_recall, j_engine = knn_serve.main(serve_args)
    j_done = sorted(j_engine.done, key=lambda r: r.rid)
    if not (np.array_equal(ids, np.stack([r.ids for r in j_done]))
            and np.array_equal(sims, np.stack([r.sims for r in j_done]))):
        fail("fused-hop serving differs from plain-hop serving")
    log(f"[main] plain hop serves bitwise-equal ids and sims "
        f"(QPS {j_stats['qps']:.1f}, recall@10 {j_recall:.4f})")

    # This slice's paths: the DMA hop under continuous batching (256
    # slots) and in waves of 256; then FastRandomHash of the dataset.
    serves = {"wave x pallas": stats}
    for name, extra in (
            ("continuous x pallas_dma",
             ["--continuous", "--slots", "256", "--kernel", "--dma"]),
            ("wave x pallas_dma", ["--kernel", "--dma"])):
        reset_launches()
        d_stats, d_recall, d_engine = knn_serve.main(serve_args + extra)
        counts = read_launches()
        if counts["descent_hop_dma"] <= 0 or counts["descent_hop"] != 0:
            fail(f"{name} launched {counts}: not the DMA hop alone")
        d_ids, d_sims, d_rids = served(d_engine)
        if d_rids != list(range(2048)):
            fail(f"{name} served rids {d_rids[:5]}..., not 0..2047")
        if not (np.array_equal(ids, d_ids) and np.array_equal(sims, d_sims)):
            bad = int((~((ids == d_ids) & (sims == d_sims)).all(1)).sum())
            fail(f"{name} differs from wave x pallas in {bad} requests")
        desc = d_stats["descent"]
        W = d_engine.index.words.shape[1]
        if desc["dma_bytes"] != desc["scored_lanes"] * W * 4:
            fail(f"{name}: dma_bytes {desc['dma_bytes']} != scored lanes "
                 f"{desc['scored_lanes']} x {W * 4} B")
        log(f"[main] serve {serve_line(name, d_stats, d_recall)}; launches "
            f"{counts}; bitwise equal to wave x pallas; dma "
            f"{desc['dma_bytes'] / 1e6:.2f} MB moved, "
            f"{desc['bytes_saved'] / 1e6:.2f} MB skipped")
        serves[name] = d_stats
        if name.startswith("continuous"):
            launches["descent_hop_dma"] = counts["descent_hop_dma"]
            cont_engine = d_engine
    wide_beam_serves(serve_args)
    launches["frh_minhash"] = minhash_path()
    distinct = distinct_path()
    return {"launches": launches, "distinct": distinct, "built": built,
            "engine": engine,
            "cont_engine": cont_engine, "serves": serves,
            "serve_args": serve_args, "index_path": index_path}


def wide_beam_serves(serve_args) -> None:
    """256 of the main path's profiles served with a beam of 128 lanes
    (kg+kr = 60: the hops keep each query's state in global memory) by
    the plain hop, the fused hop and the DMA hop: equal rid by rid."""
    import numpy as np

    from repro_torch.launch import knn_serve

    args = list(serve_args)
    args[args.index("--queries") + 1] = "256"
    args[args.index("--beam") + 1] = "128"
    reset_launches()
    _, p_recall, p_engine = knn_serve.main(args)
    if any(read_launches().values()):
        fail(f"the plain hop's serve launched {read_launches()}")
    p_ids, p_sims, p_rids = served(p_engine)
    if p_rids != list(range(256)) or p_ids.shape != (256, 10):
        fail(f"beam 128 plain serve: rids {p_rids[:5]}..., {p_ids.shape}")
    for name, extra, kernel in (("--kernel", ["--kernel"], "descent_hop"),
                                ("--kernel --dma", ["--kernel", "--dma"],
                                 "descent_hop_dma")):
        reset_launches()
        stats, recall, engine = knn_serve.main(args + extra)
        counts = read_launches()
        if counts[kernel] <= 0:
            fail(f"beam 128 {name} never launched {kernel}: {counts}")
        ids, sims, rids = served(engine)
        if rids != p_rids or not (np.array_equal(ids, p_ids)
                                  and np.array_equal(sims, p_sims)):
            bad = int((~((ids == p_ids) & (sims == p_sims)).all(1)).sum())
            fail(f"beam 128 {name} differs from the plain hop in {bad} "
                 f"requests")
        log(f"[main] serve 256 queries --beam 128 {name}: launches "
            f"{counts}; bitwise equal to the plain hop rid by rid "
            f"(recall@10 {recall:.4f}, plain {p_recall:.4f}; QPS "
            f"{stats['qps']:.1f})")


def ml1m_minhash_inputs():
    from repro_torch.core.clustering import frh_seeds
    from repro_torch.core.params import params_for
    from repro_torch.data.synthetic import make_dataset

    params = params_for("ml1M", k=30)
    return (make_dataset("ml1M", scale=1.0, seed=0), frh_seeds(params),
            params.b)


def minhash_path() -> int:
    """``dataset_minhash`` of ml1M@1.0 with the paper build's seeds: one
    launch of the CSR entry (no padded matrix), equal bitwise to the host
    hashing of build Step 1 and to the padded entry."""
    import numpy as np
    import torch

    from repro_torch.core import hashing
    from repro_torch.kernels.frh_minhash import ops

    ds, seeds, b = ml1m_minhash_inputs()
    reset_launches()
    got = ops.dataset_minhash(ds, seeds, b, device="cuda")
    count, csr = read_launches()["frh_minhash"], ops.launches_csr
    if count != 1 or csr != 1:
        fail(f"dataset_minhash launched the kernel {count} times, the CSR "
             f"entry {csr} times: not once through the CSR entry")
    host = hashing.user_min_hash_np(hashing.item_hashes(ds.items, seeds, b),
                                    ds.offsets)
    if got.shape != (len(seeds), ds.n_users) or not np.array_equal(got, host):
        fail("dataset_minhash of ml1M@1.0 differs from the host hashing")
    padded, _ = ds.padded_profiles()
    pad = ops.minhash(torch.from_numpy(padded).cuda(), seeds, b)
    if not np.array_equal(got, pad.T.cpu().numpy()):
        fail("dataset_minhash of ml1M@1.0 differs from the padded entry")
    log(f"[main] dataset_minhash ml1M@1.0 (n={ds.n_users}, t={len(seeds)}, "
        f"b={b}): {count} launch of the CSR entry, bitwise equal to "
        f"user_min_hash_np and to the padded entry")
    return count


def distinct_path() -> dict:
    """Build Step 1's distinct-hash table on the card: ``build_plan`` of
    ml1M@1.0 (the paper build's parameters) and of a c2-ml10M dataset
    (``c2bench/data.py``, the benchmark's configuration, seed 0) on the
    card launches FastRandomHash's distinct entry once, nothing else, and
    gives the host path's plan; the entry's table is bitwise the host's
    ``user_distinct_hashes_np`` over ``item_hashes``; its device time
    (held, items warm in L2 after one call) beside its least time and its
    plain version's, and ``build_plan``'s host clock on the card and on
    the host."""
    import json

    import numpy as np
    import torch

    from c2bench import data as c2data
    from repro_torch.core import clustering, hashing
    from repro_torch.core.params import C2Params, params_for
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.frh_minhash import ops, ref
    from repro_torch.types import Dataset

    cfg = json.loads((ROOT / "c2bench" / "configs" / "c2-ml10M.json")
                     .read_text())
    d = c2data.make_data(cfg, 0, 0)
    cases = (("ml1M@1.0", make_dataset("ml1M", scale=1.0, seed=0),
              params_for("ml1M", k=30)),
             ("c2-ml10M", Dataset(name="c2-ml10M", n_users=d.n_users,
                                  n_items=d.n_items, items=d.items,
                                  offsets=d.offsets),
              C2Params(**cfg["c2"])))
    out = {}
    for label, ds, params in cases:
        seeds = clustering.frh_seeds(params)
        t, b, depth = params.t, params.b, params.split_depth
        reset_launches()
        t0 = time.perf_counter()
        plan = clustering.build_plan(ds, params, device="cuda")
        card_s = time.perf_counter() - t0
        counts = read_launches()
        if counts["frh_minhash_distinct"] != 1 or any(
                v for k, v in counts.items() if k != "frh_minhash_distinct"):
            fail(f"build_plan of {label} on the card launched {counts}; "
                 f"expected the distinct entry once and nothing else")
        t0 = time.perf_counter()
        host_plan = clustering.build_plan(ds, params)
        host_s = time.perf_counter() - t0
        if not (plan.paths == host_plan.paths
                and np.array_equal(plan.config_of, host_plan.config_of)
                and len(plan.members) == len(host_plan.members)
                and all(np.array_equal(a, c) for a, c in
                        zip(plan.members, host_plan.members))):
            fail(f"build_plan of {label} on the card differs from the "
                 f"host's plan")
        host = hashing.user_distinct_hashes_np(
            hashing.item_hashes(ds.items, seeds, b), ds.offsets, depth)
        offsets = torch.from_numpy(np.asarray(ds.offsets, np.int64)).cuda()
        items = torch.from_numpy(np.asarray(ds.items, np.int32)).cuda()
        got = ops.distinct_csr(offsets, items, seeds, b, depth)
        if not np.array_equal(got.cpu().numpy(), host):
            bad = int((got.cpu().numpy() != host).any(axis=2).sum())
            fail(f"distinct_csr of {label} differs from the host table in "
                 f"{bad} (seed, user) rows")
        ms = cuda_ms(lambda: ops.distinct_csr(offsets, items, seeds, b,
                                              depth), reps=7, inner=20,
                     hold=True)
        plain_ms = cuda_ms(lambda: ref.distinct_csr_ref(offsets, items,
                                                        seeds, b, depth),
                           reps=3)
        n, nnz = ds.n_users, len(ds.items)
        t_ops = nnz * t * MINHASH_OPS / CUDA_CORE_OPS_PER_S * 1e3
        t_bytes = (nnz * 4 + (n + 1) * 8 + t * n * depth * 4) \
            / HBM_BYTES_PER_S * 1e3
        out[label] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "card_s": card_s, "host_s": host_s}
        log(f"[main] build_plan {label} (n={n}, {nnz} items, t={t}, b={b}, "
            f"depth={depth}) on the card: 1 launch of the distinct entry, "
            f"plan equal to the host's, table bitwise "
            f"user_distinct_hashes_np; build_plan {card_s * 1e3:.1f} ms on "
            f"the card, {host_s * 1e3:.1f} ms on the host; distinct entry "
            f"device time {ms:.5f} ms held (warm L2), bound "
            f"{out[label]['bound_ms']:.5f} ms by {out[label]['bound_by']}, "
            f"plain version {plain_ms:.4f} ms")
    return out


def timed_calls(spent: dict, key: str, fn):
    """``fn`` wrapped to add its host clock to ``spent[key]``."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        spent[key] += time.perf_counter() - t0
        return out
    return wrapper


def build_stages(engine) -> None:
    """Host clock per C² stage of the ml1M@1.0 paper build on the card,
    with clustering split into the distinct-hash table from the card
    (``clustering._device_cands``: the CSR arrays up, FastRandomHash's
    distinct entry, the table back), ``split_config`` over the t
    configurations and the rest; then the router's hashing in one
    256-query wave, which stays on the host: item hashes, distinct hashes,
    and the rest (the prefix match and the seed lists)."""
    from repro_torch.core import clustering, hashing
    from repro_torch.core.params import params_for
    from repro_torch.core.pipeline import cluster_and_conquer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query import router

    saved = (hashing.item_hashes, hashing.user_distinct_hashes_np,
             clustering.split_config, clustering._device_cands)
    spent = dict.fromkeys(("item_hashes", "user_distinct_hashes_np",
                           "split_config", "_device_cands"), 0.0)
    hashing.item_hashes = timed_calls(spent, "item_hashes", saved[0])
    hashing.user_distinct_hashes_np = timed_calls(
        spent, "user_distinct_hashes_np", saved[1])
    clustering.split_config = timed_calls(spent, "split_config", saved[2])
    clustering._device_cands = timed_calls(spent, "_device_cands", saved[3])
    try:
        ds = make_dataset("ml1M", scale=1.0, seed=0)
        _, st = cluster_and_conquer(ds, params_for("ml1M", k=30),
                                    device="cuda")
        build = dict(spent)
        qds = make_dataset("ml1M", scale=1.0, seed=1)
        items, offsets = router.profiles_to_csr(
            [qds.profile(u) for u in range(256)])
        routes = []
        for _ in range(3):
            for key in spent:
                spent[key] = 0.0
            t0 = time.perf_counter()
            router.route(engine.index, items, offsets,
                         engine.plan.spec.seeds_per_config)
            routes.append((time.perf_counter() - t0, dict(spent)))
    finally:
        (hashing.item_hashes, hashing.user_distinct_hashes_np,
         clustering.split_config, clustering._device_cands) = saved
    if build["item_hashes"] or build["user_distinct_hashes_np"]:
        fail("the ml1M@1.0 build on the card hashed on the host")
    log(f"[timing] ml1M@1.0 build stages, host clock: clustering "
        f"{st.t_cluster * 1e3:.1f} ms, Step 2 {st.t_local * 1e3:.1f} ms, "
        f"merge {st.t_merge * 1e3:.1f} ms")
    log("[timing] ml1M@1.0 clustering, host clock: distinct-hash table "
        f"on the card {build['_device_cands'] * 1e3:.1f} ms, split_config "
        f"{build['split_config'] * 1e3:.1f} ms, rest "
        f"{(st.t_cluster - build['_device_cands'] - build['split_config']) * 1e3:.1f} ms")
    total, parts = sorted(routes, key=lambda r: r[0])[1]  # the median
    log("[timing] routing one 256-query wave, host clock (median of 3): "
        f"{total * 1e3:.2f} ms = item_hashes "
        f"{parts['item_hashes'] * 1e3:.2f} ms, user_distinct_hashes_np "
        f"{parts['user_distinct_hashes_np'] * 1e3:.2f} ms, rest (prefix "
        f"match, seed lists) "
        f"{(total - parts['item_hashes'] - parts['user_distinct_hashes_np']) * 1e3:.2f} ms")


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


# -- phase 4b: the mutable index -------------------------------------------

MUTATION_FLAGS = ["--insert", "256", "--churn", "128", "--repair-every", "1"]
# (name, knn_serve flags, the hop kernel the path must launch)
MUTATION_PATHS = (
    ("wave x jnp", [], None),
    ("wave x pallas", ["--kernel"], "descent_hop"),
    ("wave x pallas_dma", ["--kernel", "--dma"], "descent_hop_dma"),
    ("continuous x pallas_dma",
     ["--continuous", "--slots", "256", "--kernel", "--dma"],
     "descent_hop_dma"),
    ("continuous x jnp", ["--continuous", "--slots", "256"], None),
)
STATE = ("graph_ids", "graph_sims", "rev_ids", "words", "card", "tombstone",
         "cluster_paths", "cluster_config", "cluster_members",
         "cluster_offsets")


@contextlib.contextmanager
def served_watch(counter: dict):
    """Within the block, every request the plans' ``step`` completes is
    checked against its index's tombstone mask of that moment (the
    engine's between-step maintenance runs after the step): no served id
    may be dead when served. Adds the requests checked to
    ``counter["checked"]``."""
    from repro_torch.query import plan as plan_mod
    from repro_torch.types import PAD_ID

    plain_step = plan_mod.DescentPlan.step

    def step(plan, queue, done):
        before = len(done)
        n = plain_step(plan, queue, done)
        tomb = plan.index.tombstone
        for r in done[before:]:
            if tomb[r.ids[r.ids != PAD_ID]].any():
                fail(f"request {r.rid} was served an id tombstoned at the "
                     f"time it was served")
            counter["checked"] += 1
        return n

    plan_mod.DescentPlan.step = step
    try:
        yield
    finally:
        plan_mod.DescentPlan.step = plain_step


def index_state(index) -> dict:
    """The mutated index's rows, cluster tables (online members folded
    in) and version."""
    index.consolidate()
    state = {name: getattr(index, name).copy() for name in STATE}
    state["version"] = index.version
    return state


def same_state(a: dict, b: dict) -> list:
    """Names of the entries that differ."""
    import numpy as np

    return [k for k in a if not np.array_equal(a[k], b[k])]


def check_tables_fresh(engine, label: str) -> None:
    """The plan's journal-synced device tables equal a fresh padded upload
    of the same (mutated) index."""
    import torch

    from repro_torch.query.plan import DescentPlan

    synced = engine.plan.sync()
    fresh = DescentPlan(engine.index, engine.plan.spec,
                        device=engine.plan.device).sync()
    for name, a, b in zip(("graph_ids", "rev_ids", "words", "card",
                           "tombstone"), synced, fresh):
        if a.shape != b.shape or not torch.equal(a, b):
            fail(f"{label}: synced {name} differs from a fresh upload")


def check_path_launches(label: str, counts: dict, kernel) -> None:
    hops = ("descent_hop", "descent_hop_dma")
    if kernel is None:
        if any(counts[h] for h in hops):
            fail(f"{label} (plain hop) launched {counts}")
    elif counts[kernel] <= 0 or any(counts[h] for h in hops if h != kernel):
        fail(f"{label} launched {counts}: not the {kernel} kernel alone")


def mutation_serves(serve_args) -> dict:
    """``knn_serve --insert 256 --churn 128 --repair-every 1`` over the
    paper index, five ways: plain, fused and DMA hop in waves, DMA and
    plain hop under continuous batching (256 slots). All serve the same
    ids and sims rid by rid and leave the same mutated index; each plan's
    synced tables equal a fresh upload; no request is served an id dead
    when it was served; each kernel path launched its hop."""
    import numpy as np

    from repro_torch.launch import knn_serve

    base, engines, watched = None, {}, {"checked": 0}
    for name, extra, kernel in MUTATION_PATHS:
        reset_launches()
        t0 = time.perf_counter()
        with served_watch(watched):
            stats, recall, engine = knn_serve.main(
                serve_args + MUTATION_FLAGS + extra)
        seconds = time.perf_counter() - t0
        counts = read_launches()
        check_path_launches(name, counts, kernel)
        check_tables_fresh(engine, name)
        ids, sims, rids = served(engine)
        state = index_state(engine.index)
        if base is None:
            if rids != list(range(2048)) or ids.shape != (2048, 10):
                fail(f"mutation serve {name}: rids {rids[:5]}..., "
                     f"{ids.shape}")
            lc = stats["lifecycle"]
            if (stats["inserted"] != 256 or lc["removed"] != 128
                    or lc["updated"] != 128 or lc["repairs"] < 1
                    or stats["refreshes"] != 4):
                fail(f"mutation serve {name}: inserted "
                     f"{stats['inserted']}, refreshes {stats['refreshes']}, "
                     f"lifecycle {lc}")
            if not 0.5 <= recall <= 1.0:
                fail(f"mutation serve recall@10 {recall:.3f} outside "
                     f"[0.5, 1]")
            base = (ids, sims, state, name)
        else:
            if not (np.array_equal(ids, base[0])
                    and np.array_equal(sims, base[1])):
                bad = int((~((ids == base[0])
                             & (sims == base[1])).all(1)).sum())
                fail(f"mutation serve {name} differs from {base[3]} in "
                     f"{bad} requests")
            diff = same_state(state, base[2])
            if diff:
                fail(f"mutation serve {name}: mutated index differs from "
                     f"{base[3]} in {diff}")
        engines[name] = engine
        log(f"[mutable] {name}: {serve_line('serve', stats, recall)}; "
            f"launches {counts}; sync {engine.plan.sync_stats}; "
            f"{seconds:.1f} s in all"
            + ("" if base[3] == name else f"; bitwise equal to {base[3]} "
               f"(served ids, sims, index rows, cluster tables, version "
               f"{state['version']})"))
    nearest_sims(engines["wave x jnp"], serve_args)
    log(f"[mutable] lifecycle after the churn: "
        f"{engines['wave x jnp'].lifecycle.stats()}; "
        f"{watched['checked']} served requests checked against the "
        f"tombstones of their moment, synced tables equal a fresh upload "
        f"on every path")
    return engines


def nearest_sims(engine, serve_args) -> None:
    """Why the mutated index serves a higher recall: the mean exact top-1
    and top-10 GoldFinger sims of the 2,048 queries (the query set,
    ml1M@1.0 seed 1) over the paper index (seed 0) and over the mutated
    index, whose inserts and updates carry query-set profiles."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query.index import KNNIndex
    from repro_torch.query.router import fingerprint_profiles, profiles_to_csr
    from repro_torch.query.search import exact_knn

    qds = make_dataset("ml1M", scale=1.0, seed=1)
    items, offsets = profiles_to_csr([qds.profile(u) for u in range(2048)])
    line = []
    for name, ix in (("paper index", KNNIndex.load(
            serve_args[serve_args.index("--index") + 1])),
                     ("mutated index", engine.index)):
        qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
        _, sims = exact_knn(ix.words, ix.card, qgf.words, qgf.card, 10,
                            tomb=ix.tombstone, device=engine.plan.device)
        line.append(f"{name} {np.mean(sims[:, 0]):.4f} / "
                    f"{np.mean(sims[:, 9]):.4f}")
    log("[mutable] mean exact top-1 / top-10 sim of the 2,048 queries: "
        + ", ".join(line))


def ttl_serves(serve_args) -> None:
    """``--continuous --slots 256 --ttl 8``: rows untouched for 8 steps
    expire between ticks while requests are in flight; the plain hop and
    the DMA hop serve the same ids and sims and expire the same rows."""
    import numpy as np

    from repro_torch.launch import knn_serve

    extra = ["--continuous", "--slots", "256", "--ttl", "8"]
    runs, watched = [], {"checked": 0}
    for name, kernel_flags, kernel in (
            ("continuous x jnp", [], None),
            ("continuous x pallas_dma", ["--kernel", "--dma"],
             "descent_hop_dma")):
        reset_launches()
        with served_watch(watched):
            stats, _, engine = knn_serve.main(serve_args + extra
                                              + kernel_flags)
        counts = read_launches()
        check_path_launches(f"TTL {name}", counts, kernel)
        check_tables_fresh(engine, f"TTL {name}")
        runs.append((served(engine), index_state(engine.index),
                     stats["lifecycle"], name, counts))
    (a, sa, la, name_a, _), (b, sb, lb, name_b, counts) = runs
    if la["expired"] <= 0 or la != lb:
        fail(f"TTL serves expired {la['expired']} / {lb['expired']} rows")
    if a[2] != b[2] or not (np.array_equal(a[0], b[0])
                            and np.array_equal(a[1], b[1])):
        fail(f"TTL {name_b} serves differently from {name_a}")
    if same_state(sa, sb):
        fail(f"TTL {name_b} leaves another index: {same_state(sa, sb)}")
    log(f"[mutable] TTL 8 under continuous batching: {la['expired']} rows "
        f"expired mid-serve, {name_b} (launches {counts}) bitwise equal to "
        f"{name_a}, rid by rid, and the same expired index; "
        f"{watched['checked']} requests checked against the tombstones of "
        f"their moment")


def capacity_crossing(dev, tmp: Path) -> None:
    """Inserts that take a small index (ml1M@0.05, 302 users, k=10) past
    ``capacity_of(n, 64)`` = 512 rows: in waves (all inserts, then 256
    queries) and under continuous batching (64 slots, 40 inserts between
    ticks, so the crossing lands while slots are in flight), plain against
    DMA hop. The plan re-uploads in full at the crossing and its tables
    then equal a fresh upload; the answers after it agree bitwise."""
    import numpy as np

    from repro_torch.core.local_knn import capacity_of
    from repro_torch.core.params import params_for
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
    from repro_torch.query.index import KNNIndex, build_index

    path = tmp / "small.npz"
    build_index(make_dataset("ml1M", scale=0.05, seed=0),
                params_for("ml1M", k=10), device=dev).save(path)
    qds = make_dataset("ml1M", scale=1.0, seed=2)
    n0 = KNNIndex.load(path).n
    cap = capacity_of(n0, minimum=64)
    n_ins = cap - n0 + 8
    for batching, kw in (("wave", {}),
                         ("continuous", dict(continuous=True, slots=64))):
        out = []
        for scorer, skw in (("jnp", {}), ("pallas_dma",
                                          dict(kernel=True, dma=True))):
            eng = QueryEngine(KNNIndex.load(path),
                              QueryConfig(k=10, beam=32, hops=3, **kw,
                                          **skw), device=dev)
            crossed = []
            done_ins = [0]

            def insert_some(engine, tick, many=40):
                for _ in range(min(many, n_ins - done_ins[0])):
                    engine.insert(qds.profile(6000 - done_ins[0]))
                    done_ins[0] += 1
                    if engine.index.n > cap and not crossed:
                        crossed.append(engine.plan.busy())

            if batching == "wave":
                insert_some(eng, 0, many=n_ins)
            for rid in range(256):
                eng.submit(QueryRequest(rid=rid, profile=qds.profile(rid)))
            eng.run(on_tick=insert_some)
            if done_ins[0] != n_ins or eng.index.n != n0 + n_ins:
                fail(f"capacity crossing ({batching}): {done_ins[0]} "
                     f"inserts, n {eng.index.n}")
            if batching == "continuous" and crossed != [True]:
                fail("capacity crossing landed with no slot in flight")
            sync = eng.plan.sync_stats
            tables = eng.plan.sync()
            if sync["full_uploads"] < 2 or tables[0].shape[0] != 2 * cap:
                fail(f"capacity crossing ({batching} x {scorer}): sync "
                     f"{sync}, table rows {tables[0].shape[0]}")
            check_tables_fresh(eng, f"capacity crossing ({batching})")
            ids, sims, rids = served(eng)
            out.append((ids, sims, rids, index_state(eng.index), sync))
        (a_ids, a_sims, a_rids, a_st, a_sync), (b_ids, b_sims, b_rids, b_st,
                                                b_sync) = out
        if (a_rids != b_rids or not np.array_equal(a_ids, b_ids)
                or not np.array_equal(a_sims, b_sims) or same_state(a_st,
                                                                     b_st)):
            fail(f"capacity crossing ({batching}): the DMA hop serves or "
                 f"mutates differently from the plain hop")
        log(f"[mutable] capacity crossing ({batching}): {n_ins} inserts "
            f"take n {n0} -> {n0 + n_ins} past {cap} rows; sync plain "
            f"{a_sync}, DMA {b_sync}; tables {2 * cap} rows, equal to a "
            f"fresh upload; 256 queries bitwise equal, plain and DMA hop")


def time_mutations(engine) -> dict:
    """Host clock of one insert, one delete, one update and one repair
    pass on the paper index (``--kernel`` engine, after its serve), and
    the hop launches each makes."""
    import numpy as np

    from repro_torch.data.synthetic import make_dataset

    qds = make_dataset("ml1M", scale=1.0, seed=3)
    ix = engine.index
    spent, launched = {}, {}

    def timed(key, calls):
        reset_launches()
        times = []
        for call in calls:
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        spent[key] = statistics.median(times) * 1e3
        launched[key] = read_launches()["descent_hop"] / len(calls)

    # The inserts' host clock split by part: the module functions the
    # engine and the plan call, and the plan's and the index's methods.
    from repro_torch.query import engine as engine_mod
    from repro_torch.query import plan as plan_mod

    parts = dict.fromkeys(("fingerprint_profiles", "placements", "route",
                           "descend_rows", "append_user"), 0.0)
    saved = (engine_mod.fingerprint_profiles, engine_mod.placements,
             plan_mod.route)
    engine_mod.fingerprint_profiles = timed_calls(
        parts, "fingerprint_profiles", saved[0])
    engine_mod.placements = timed_calls(parts, "placements", saved[1])
    plan_mod.route = timed_calls(parts, "route", saved[2])
    engine.plan.descend_rows = timed_calls(parts, "descend_rows",
                                           engine.plan.descend_rows)
    ix.append_user = timed_calls(parts, "append_user", ix.append_user)
    try:
        t0 = time.perf_counter()
        timed("insert", [lambda m=m: engine.insert(qds.profile(m))
                         for m in range(17)])
        total = time.perf_counter() - t0
    finally:
        (engine_mod.fingerprint_profiles, engine_mod.placements,
         plan_mod.route) = saved
        del engine.plan.descend_rows, ix.append_user
    log("[mutable] 17 inserts, host clock per insert by part: "
        + ", ".join(f"{k} {v / 17 * 1e3:.2f} ms" for k, v in parts.items())
        + f", rest {(total - sum(parts.values())) / 17 * 1e3:.2f} ms")
    alive = ix.alive_ids()
    victims = alive[np.linspace(0, len(alive) - 1, 34, dtype=np.int64)]
    timed("delete", [lambda u=u: engine.remove_user(int(u))
                     for u in victims[0::2]])
    timed("update", [lambda m=m, u=u: engine.update_user(
        int(u), qds.profile(100 + m)) for m, u in enumerate(victims[1::2])])
    n_cohort = len(engine.lifecycle._touched)
    relinked = engine.lifecycle.n_relinked
    timed("repair", [engine.lifecycle.repair])
    log("[mutable] host clock on the ml1M@1.0 index (x pallas), median: "
        + ", ".join(f"{k} {v:.2f} ms ({launched[k]:.1f} hop launches)"
                    for k, v in spent.items())
        + f"; the repair pass re-linked "
        f"{engine.lifecycle.n_relinked - relinked} of the {n_cohort} rows "
        f"its cohort of 17 inserts, deletes and updates touched")
    return spent


def scrub_comparator(engine) -> None:
    """Descending 256 queries over ``scrub_dead_references(copy)`` with no
    mask equals descending the churned index under its tombstone mask:
    plain, fused and DMA hop."""
    import copy

    import torch

    from repro_torch.data.synthetic import make_dataset
    from repro_torch.lifecycle import scrub_dead_references
    from repro_torch.query.plan import DescentPlan
    from repro_torch.query.router import (fingerprint_profiles,
                                          profiles_to_csr, route)
    from repro_torch.query.search import batched_descent
    from repro_torch.sketch.goldfinger import words_tensor

    ix = engine.index
    scrubbed = copy.deepcopy(ix)
    lanes = scrub_dead_references(scrubbed)
    qds = make_dataset("ml1M", scale=1.0, seed=1)
    items, offsets = profiles_to_csr([qds.profile(u) for u in range(256)])
    qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
    dev = engine.plan.device
    seeds = torch.from_numpy(route(ix, items, offsets, 16)).to(dev)
    qw = words_tensor(qgf.words, dev)
    qc = torch.from_numpy(qgf.card).to(dev)
    masked = engine.plan.sync()
    clean = DescentPlan(scrubbed, engine.plan.spec, device=dev).sync()
    for name, kw, kernel in (("plain", {}, None),
                             ("fused", {"kernel": True}, "descent_hop"),
                             ("DMA", {"kernel": True, "dma": True},
                              "descent_hop_dma")):
        reset_launches()
        a = batched_descent(*masked[:4], qw, qc, seeds, k=10, beam=32,
                            hops=3, tomb=masked[4], **kw)
        b = batched_descent(*clean[:4], qw, qc, seeds, k=10, beam=32,
                            hops=3, tomb=None, **kw)
        check_path_launches(f"scrub comparator ({name})", read_launches(),
                            kernel)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"scrub comparator ({name} hop): masked descent differs "
                 f"from descent over the scrubbed copy")
    log(f"[mutable] scrub comparator: {int(ix.tombstone.sum())} dead rows, "
        f"{lanes} lanes scrubbed; 256 queries descend bitwise equal, masked "
        f"against scrubbed, through the plain, fused and DMA hops")


def brute_force_quality(dev, built, index_path: str) -> dict:
    """The ml1M@1.0 brute-force graph at k=30 through the cluster-KNN
    kernel (``knn/brute_force``), bitwise against its plain version on the
    card, with its launches counted and timed; then the exact-Jaccard
    ``avg_sim`` of the C² graph and of the brute-force graph, and the
    quality ratio (paper Eq. 2)."""
    import math

    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_dataset
    from repro_torch.eval.metrics import exact_avg_sim, quality
    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.knn.brute_force import brute_force_knn, n_similarities
    from repro_torch.query.index import KNNIndex
    from repro_torch.sketch.goldfinger import GoldFinger, words_tensor

    index = KNNIndex.load(index_path)
    gf = GoldFinger(words=index.words, card=index.card)
    k, n, block = 30, index.n, 512
    brute_force_knn(gf, k, device=dev)  # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf = brute_force_knn(gf, k, block=block, device=dev)
    host_s = time.perf_counter() - t0
    launches = read_launches()["goldfinger_knn"]
    if launches != -(-n // block):
        fail(f"brute force launched cluster-KNN {launches} times, expected "
             f"{-(-n // block)}")
    words = words_tensor(gf.words, dev)
    card = torch.from_numpy(gf.card).to(dev)
    all_ids = torch.arange(n, dtype=torch.int32, device=dev)
    blocks = [(words[s:s + block], card[s:s + block], all_ids[s:s + block])
              for s in range(0, n, block)]
    plain = [ref.knn_ref(w, c, i, words, card, all_ids, k)
             for w, c, i in blocks]
    p_ids = torch.cat([p[0] for p in plain]).cpu().numpy()
    p_sims = torch.cat([p[1] for p in plain]).cpu().numpy()
    if not (np.array_equal(bf.ids, p_ids) and np.array_equal(bf.sims,
                                                             p_sims)):
        fail("brute force through the cluster-KNN kernel differs from the "
             "plain version")
    err = max_abs_err(torch.from_numpy(bf.sims), torch.from_numpy(p_sims))
    dev_ms = cuda_ms(lambda: [ops.knn(w, c, i, words, card, all_ids, k)
                              for w, c, i in blocks], reps=5, hold=True)
    plain_ms = cuda_ms(lambda: [ref.knn_ref(w, c, i, words, card, all_ids, k)
                                for w, c, i in blocks], reps=3)
    ds = make_dataset("ml1M", scale=1.0, seed=0)
    c2 = built["graph"]
    t0 = time.perf_counter()
    a_c2 = exact_avg_sim(ds, c2, device=dev)
    avg_s = time.perf_counter() - t0
    a_bf = exact_avg_sim(ds, bf, device=dev)
    q = quality(ds, c2, bf, device=dev)
    if not (math.isfinite(q) and 0 < q <= 1.05):
        fail(f"quality {q} is not finite in (0, 1.05]")
    if exact_avg_sim(ds, c2, device="cpu") != a_c2:
        fail("exact avg_sim of the C2 graph on the card differs from the "
             "CPU's")
    log(f"[quality] brute force ml1M@1.0 k={k}: {launches} cluster-KNN "
        f"launches (blocks of {block} rows x {n}), bitwise equal to the "
        f"plain version; {dev_ms:.4f} ms of device time (plain "
        f"{plain_ms:.4f} ms), {host_s * 1e3:.1f} ms host clock in all; "
        f"{n_similarities(n)} similarities against the C2 build's "
        f"{built['plan'].brute_force_sims()}")
    log(f"[quality] exact avg_sim: C2 {a_c2!r}, brute force {a_bf!r}, "
        f"quality (Eq. 2) {q!r} (GoldFinger estimate of C2's "
        f"{c2.avg_sim():.4f}); one exact avg_sim {avg_s * 1e3:.1f} ms, "
        f"equal on the card and the CPU")
    log(f"[quality] speed-up of C2 over brute force: the C2 build "
        f"{built['seconds']:.3f} s (clustering, Step 2, merge), brute force "
        f"{host_s:.4f} s: {host_s / built['seconds']:.4f}x")
    return {"launches": launches, "ms": dev_ms, "err": err}


def mutable_index(dev, run: dict, tmp: Path) -> dict:
    """Phase 4b: the mutable index and the build's quality, on the paper
    index of phase 4."""
    t0 = time.perf_counter()
    serve_args = run["serve_args"]
    engines = mutation_serves(serve_args)
    ttl_serves(serve_args)
    capacity_crossing(dev, tmp)
    scrub_comparator(engines["wave x pallas_dma"])
    time_mutations(engines["wave x pallas"])
    out = brute_force_quality(dev, run["built"], run["index_path"])
    log(f"[mutable] phase 4b: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 3 / 4c: the sharded placement -----------------------------------

def sharded_inputs(rng, dev, S, cap, W, kg, kr, q, B, tomb_frac=0.05):
    """S shards' stacked tables [S, cap, ·] and beams [S, q, B], each shard
    drawn as ``hop_inputs`` draws one table, the queries every shard's
    (one query: ``hop_inputs``' second row, whose beam is full)."""
    import torch

    skip = int(q == 1)
    parts = [hop_inputs(rng, dev, cap, W, kg, kr, q + skip, B, tomb_frac)
             for _ in range(S)]
    stack = lambda i: torch.stack([p[i] for p in parts])  # noqa: E731
    return (stack(0), stack(1), stack(2), stack(3), parts[0][4][skip:],
            parts[0][5][skip:], stack(6)[:, skip:], stack(7)[:, skip:],
            stack(8))


def sharded_kernel(args, dma: bool, **kw):
    """One launch of either hop kernel for all shards (the sharded entry):
    ids, sims, n_scored (and the DMA hop's byte counters)."""
    from repro_torch.kernels.descent_score import ops

    graph, rev, words, card, qw, qc, beam, sims, tomb = args
    out = ops.descent_hop_sharded(graph, rev, words, card, qw, qc, beam,
                                  sims, tomb=tomb, dma=dma,
                                  with_counts=True, **kw)
    return out if dma else out[:3]


def sharded_plain(args, dma: bool):
    from repro_torch.kernels.descent_score import ref

    graph, rev, words, card, qw, qc, beam, sims, tomb = args
    out = ref.descent_hop_sharded_ref(graph, rev, words, card, qw, qc, beam,
                                      sims, tomb=tomb)
    if not dma:
        return out
    C = beam.shape[-1] * (graph.shape[-1] + rev.shape[-1])
    return out + ref.dma_counts(out[2], words.shape[-1], C)


def shard_by_shard(args, dma: bool, **kw):
    """The cross-check: S single-shard launches through ``descent_hop``,
    stacked."""
    import torch

    graph, rev, words, card, qw, qc, beam, sims, tomb = args
    fn = dma_kernel if dma else hop_kernel
    outs = [fn(graph[s], rev[s], words[s], card[s], qw, qc, beam[s], sims[s],
               tomb[s], **kw) for s in range(graph.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def check_sharded_case(label: str, args, err: float, **kw) -> float:
    """Both hop kernels' shard grid axis against the plain sharded hop and
    against S single-shard launches: ids, sims, n_scored and the DMA hop's
    byte counters, exactly."""
    import torch

    graph, rev, words = args[:3]
    C = args[6].shape[-1] * (graph.shape[-1] + rev.shape[-1])
    fused = None
    for dma in (False, True):
        dkw = kw if dma else {}
        k_out = sharded_kernel(args, dma, **dkw)
        p_out = sharded_plain(args, dma)
        l_out = shard_by_shard(args, dma, **dkw)
        torch.cuda.synchronize()
        name = "descent_hop_dma" if dma else "descent_hop"
        if not same_hop(k_out, p_out):
            fail(f"sharded {name} {label}: differs from the plain version ("
                 + ", ".join(f"{n} {torch.equal(a, b)}" for n, a, b in zip(
                     ("ids", "sims", "n_scored", "dma_bytes", "bytes_saved"),
                     k_out, p_out)) + ")")
        if not same_hop(k_out, l_out):
            fail(f"sharded {name} {label}: differs from S single-shard "
                 f"launches")
        if dma and not (check_dma_counts(k_out, words.shape[-1], C)
                        and same_hop(k_out[:3], fused)):
            fail(f"sharded DMA hop {label}: byte counters or results "
                 f"disagree with the fused hop")
        fused = k_out
        err = max(err, max_abs_err(k_out[1], p_out[1]))
    S, q, B = args[6].shape
    log(f"[kernels] sharded hops {label} (S={S} cap={graph.shape[1]} "
        f"W={words.shape[-1]} q={q} B={B}): both kernels bitwise equal to "
        f"the plain sharded hop and to {S} single-shard launches (scored "
        f"{int(fused[2].sum())} of {S * q * C} lanes)")
    return err


def check_sharded_hops(dev) -> tuple[int, float]:
    """Phase 3: the shard grid axis of both hops at random shapes: 2-5
    shards, table rows a power of 2 and not, W = 32 (16-byte rows) and 33
    (4-byte copies), one and many queries, beams with their state in
    shared memory and in global memory (192 lanes), tombstone-heavy
    shards, DMA rings of several queries per block."""
    import numpy as np

    cases = [  # (S, cap, W, q, B, tomb_frac, DMA launch params)
        (4, 2048, 32, 256, 12, 0.05, {}),
        (2, 4096, 32, 64, 32, 0.05, {}),
        (3, 300, 33, 17, 16, 0.05, {}),
        (5, 512, 32, 1, 24, 0.3, {}),
        (2, 4096, 32, 40, 192, 0.05, {}),
        (3, 1000, 32, 50, 16, 0.05, {"block_q": 3, "score_chunk": 100}),
    ]
    err = 0.0
    for S, cap, W, q, B, frac, kw in cases:
        rng = np.random.default_rng(S * 1000 + cap + W + q + B)
        args = sharded_inputs(rng, dev, S, cap, W, 30, 30, q, B, frac)
        label = (f"tomb={frac:.0%} "
                 + " ".join(f"{k}={v}" for k, v in kw.items())).strip()
        err = check_sharded_case(label, args, err, **kw)
    return len(cases), err


def check_dead_shard_hops(dev) -> tuple[int, float]:
    """Phase 3: both hops' shard grid axis with whole shards all PAD, as a
    dead shard's seeds leave them in the degraded window: S = 4 with shard
    1 all PAD, S = 3 with shards 0 and 2, S = 2 with both; W = 32 and 33,
    256 queries, shard beams of 12 (state in shared memory) and 192 (in
    global memory). Each against the plain sharded hop and S single-shard
    launches; an all-PAD shard gives PAD ids, -inf sims, no scored lane
    and (DMA hop) no byte moved."""
    import numpy as np
    import torch

    from repro_torch.types import NEG_INF, PAD_ID

    cases = [(S, dead, W, B) for W, B in ((32, 12), (33, 12), (32, 192))
             for S, dead in ((4, [1]), (3, [0, 2]), (2, [0, 1]))]
    err = 0.0
    for S, dead, W, B in cases:
        rng = np.random.default_rng(7 * S + W + B)
        args = list(sharded_inputs(rng, dev, S, 2048, W, 30, 30, 256, B))
        beam, sims = args[6].clone(), args[7].clone()
        beam[dead] = PAD_ID
        sims[dead] = NEG_INF
        args[6], args[7] = beam, sims
        err = check_sharded_case(f"shards {dead} of {S} all PAD", args, err)
        for dma in (False, True):
            out = sharded_kernel(args, dma)
            if not (bool((out[0][dead] == PAD_ID).all())
                    and bool(torch.isneginf(out[1][dead]).all())
                    and all(not bool(x[dead].any()) for x in out[2:4])):
                fail(f"{'DMA ' if dma else ''}hop, shards {dead} of {S} all "
                     f"PAD: their outputs are not PAD / -inf / 0")
    return len(cases), err


SHARDED_PATHS = (  # (name, knn_serve flags, the hop kernel it must launch)
    ("wave x jnp", [], None),
    ("wave x pallas", ["--kernel"], "descent_hop"),
    ("wave x pallas_dma", ["--kernel", "--dma"], "descent_hop_dma"),
    ("continuous x pallas_dma",
     ["--continuous", "--slots", "256", "--kernel", "--dma"],
     "descent_hop_dma"),
)
SHARDED_MUTATION_PATHS = (SHARDED_PATHS[0], SHARDED_PATHS[1],
                          SHARDED_PATHS[3])


def check_sharded_launches(label: str, counts: dict, kernel) -> None:
    """The path launched its hop (and no other) through the sharded entry
    alone: one launch per hop for all shards."""
    check_path_launches(label, counts, kernel)
    for hop in ("descent_hop", "descent_hop_dma"):
        if counts[hop] != counts[f"{hop}_sharded"]:
            fail(f"{label} launched {hop} outside the sharded entry: "
                 f"{counts}")


def sharded_line(engine) -> str:
    sd = engine.sharded_state()
    mb = [round(b / 1e6, 2) for b in sd.resident_bytes()]
    return (f"{sd.n_shards} shards, resident rows "
            f"{[len(r) for r in sd.plan.residents]} ({mb} MB), cap "
            f"{sd.cap}, imbalance {sd.plan.imbalance:.2f}, shard beam "
            f"{sd.shard_beam(engine.plan.beam, engine.plan.spec.k)}")


def check_shard_tables_fresh(engine, label: str) -> None:
    """The delta-synced shard tables equal a from-scratch rematerialisation
    under ``extend_plan`` of the frozen base plan, on the card."""
    import numpy as np
    import torch

    from repro_torch.query import sharded

    sd = engine.sharded_state()
    fresh = sharded.ShardedDescent(
        engine.index, sd.n_shards,
        plan=sharded.extend_plan(sd.base_plan, engine.index),
        device=engine.plan.device)
    if not np.array_equal(sd._g2l, fresh._g2l) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(sd._dev, fresh._dev)):
        fail(f"{label}: delta-synced shard tables differ from a "
             f"rematerialisation")


def sharded_serves(serve_args) -> dict:
    """``knn_serve --shards 4`` of the main path's 2,048 queries: wave x
    {jnp, pallas, pallas_dma} and continuous (256 slots) x pallas_dma, all
    bitwise equal rid by rid, each kernel path launching its hop through
    the sharded entry alone; then wave x pallas at ``--shards 2``."""
    import numpy as np

    from repro_torch.launch import knn_serve

    base, out = None, {"serves": {}, "launches": {}}
    for shards, paths in (("4", SHARDED_PATHS), ("2", SHARDED_PATHS[1:2])):
        for name, extra, kernel in paths:
            label = f"--shards {shards} {name}"
            reset_launches()
            stats, recall, engine = knn_serve.main(
                serve_args + ["--shards", shards] + extra)
            counts = read_launches()
            check_sharded_launches(label, counts, kernel)
            ids, sims, rids = served(engine)
            if rids != list(range(2048)) or ids.shape != (2048, 10):
                fail(f"{label}: rids {rids[:5]}..., {ids.shape}")
            ok = ids != -1
            if (not np.isfinite(sims[ok]).all()
                    or not 0.5 <= recall <= 1.0):
                fail(f"{label}: non-finite sims or recall@10 {recall:.4f}")
            same = ""
            if shards == "4":
                if base is None:
                    base = (ids, sims, label)
                elif not (np.array_equal(ids, base[0])
                          and np.array_equal(sims, base[1])):
                    bad = int((~((ids == base[0])
                                 & (sims == base[1])).all(1)).sum())
                    fail(f"{label} differs from {base[2]} in {bad} requests")
                else:
                    same = f"; bitwise equal to {base[2]}"
            log(f"[sharded] {serve_line(label, stats, recall)}; launches "
                f"{counts}; {sharded_line(engine)}{same}")
            out["serves"][label] = stats
            out["launches"][label] = counts
            if label == "--shards 4 wave x pallas":
                out["engine"] = engine
            if label == "--shards 2 wave x pallas":
                out["engine2"] = engine
    return out


def sharded_mutation_serves(serve_args) -> None:
    """``knn_serve --shards 4 --insert 256 --churn 128 --repair-every 1``
    three ways (wave x jnp, wave x pallas, continuous x pallas_dma): the
    same served ids and sims rid by rid and the same mutated index; no
    request served an id dead when it was served; the delta-synced shard
    tables equal a rematerialisation; the plans' sync() counts."""
    import numpy as np

    from repro_torch.launch import knn_serve

    base, watched = None, {"checked": 0}
    for name, extra, kernel in SHARDED_MUTATION_PATHS:
        label = f"--shards 4 mutation {name}"
        reset_launches()
        t0 = time.perf_counter()
        with served_watch(watched):
            stats, recall, engine = knn_serve.main(
                serve_args + ["--shards", "4"] + MUTATION_FLAGS + extra)
        seconds = time.perf_counter() - t0
        counts = read_launches()
        check_sharded_launches(label, counts, kernel)
        check_shard_tables_fresh(engine, label)
        ids, sims, rids = served(engine)
        state = index_state(engine.index)
        lc = stats["lifecycle"]
        if base is None:
            if (rids != list(range(2048)) or stats["inserted"] != 256
                    or lc["removed"] != 128 or lc["updated"] != 128
                    or lc["repairs"] < 1):
                fail(f"{label}: rids {rids[:5]}..., inserted "
                     f"{stats['inserted']}, lifecycle {lc}")
            base = (ids, sims, state, label)
        elif not (np.array_equal(ids, base[0])
                  and np.array_equal(sims, base[1])):
            bad = int((~((ids == base[0]) & (sims == base[1])).all(1)).sum())
            fail(f"{label} differs from {base[3]} in {bad} requests")
        elif same_state(state, base[2]):
            fail(f"{label}: mutated index differs from {base[3]} in "
                 f"{same_state(state, base[2])}")
        log(f"[sharded] {serve_line(label, stats, recall)}; launches "
            f"{counts}; sync() {engine.plan.sync_stats}; "
            f"{sharded_line(engine)}; {seconds:.1f} s in all"
            + ("" if base[3] == label else f"; bitwise equal to {base[3]} "
               f"(served ids, sims, index rows, cluster tables, version "
               f"{state['version']})"))
    log(f"[sharded] {watched['checked']} served requests checked against "
        f"the tombstones of their moment; delta-synced shard tables equal a "
        f"rematerialisation on every path")


@functools.lru_cache(maxsize=1)
def main_queries():
    """The main path's unseen query profiles (ml1M@1.0, seed 1), made
    once for every sharded hop check."""
    from repro_torch.data.synthetic import make_dataset

    return make_dataset("ml1M", scale=1.0, seed=1)


def first_sharded_hop(engine, n_shards: int, beam: int, q: int,
                      dead=None):
    """The first hop's inputs of a ``q``-query wave of the main path on a
    ``n_shards``-shard state of ``engine``'s index at fleet beam ``beam``:
    each shard's owned seeds scored into its initial beams. With a
    ``dead`` mask the dead shards' seeds are dropped, as in a degraded
    window: their beams are all PAD."""
    import numpy as np
    import torch

    from repro_torch.query import sharded
    from repro_torch.query.router import (fingerprint_profiles,
                                          profiles_to_csr, route)
    from repro_torch.query.search import descent_init_sharded
    from repro_torch.sketch.goldfinger import words_tensor

    dev = engine.plan.device
    ix = engine.index
    sd = sharded.ShardedDescent(ix, n_shards, device=dev)
    if dead is not None:
        sd.set_dead(dead)
    qds = main_queries()
    items, offsets = profiles_to_csr([qds.profile(u) for u in range(q)])
    qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
    seeds = route(ix, items, offsets, engine.plan.spec.seeds_per_config)
    l_seeds = torch.from_numpy(
        sd.shard_seeds(seeds).astype(np.int32)).to(dev)
    qw = words_tensor(qgf.words, dev)
    qc = torch.from_numpy(qgf.card).to(dev)
    graph, rev, words, card, _, tomb = sd._dev
    beam_ids, beam_sims = descent_init_sharded(
        words, card, qw, qc, l_seeds,
        beam=sd.shard_beam(beam, engine.plan.spec.k),
        l_tomb=tomb)
    return (graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb), \
        sd, seeds


def sharded_hops_at_main_shapes(engine) -> float:
    """Both kernels' shard grid axis at the main path's shapes: the first
    hop of a 256-query wave on 4 shards (beam 32: 12 lanes a shard, state
    in shared memory) and of one query; on 2 shards at beam 256 (192
    lanes a shard, state in global memory), 256 queries and one."""
    err = 0.0
    for S, beam, q in ((4, 32, 256), (4, 32, 1), (2, 256, 256), (2, 256, 1)):
        args, _, _ = first_sharded_hop(engine, S, beam, q)
        err = check_sharded_case(f"ml1M@1.0 first hop, fleet beam {beam}",
                                 args, err)
    return err


def sharded_placement(dev, run: dict) -> dict:
    """Phase 4c: the sharded placement on the paper index of phase 4."""
    t0 = time.perf_counter()
    out = sharded_serves(run["serve_args"])
    sharded_mutation_serves(run["serve_args"])
    out["err"] = sharded_hops_at_main_shapes(run["engine"])
    log(f"[sharded] phase 4c: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 4d: SLO admission, adaptive budgets, the cache, re-balance ------

# The serve's knobs (k=10, beam 32, 3 hops, waves of 256, 256 slots) and
# this phase's sizes: the 2,048 unseen profiles, the first 1,024 of them
# again for the cache, 256 inserts, 64 arrivals between ticks (eight a
# tick).
SERVE_QC = dict(k=10, beam=32, hops=3, max_wave=256, slots=256)
P4D = dict(queries=2048, repeats=1024, inserts=256, arrivals=64,
           arrivals_per_tick=8, max_pending=1024, shards=4, small=["--dataset", "synth",
                                              "--scale", "0.1"])
FUSED, DMA = "descent_hop", "descent_hop_dma"
WAVE_PALLAS = ("wave x pallas", FUSED, dict(kernel=True))
WAVE_JNP = ("wave x jnp", None, {})
CONT_JNP = ("continuous x jnp", None, dict(continuous=True))
CONT_DMA = ("continuous x pallas_dma", DMA,
            dict(continuous=True, kernel=True, dma=True))


def serve4d(ctx, label, kernel, qc, stream=None, requests=None,
            prepare=None, on_tick=None, clock=None, sharded=False):
    """One serve of this phase through ``QueryEngine`` on a freshly loaded
    copy of the paper index: ``prepare(engine)`` first (inserts, a forced
    swap), then the tables are uploaded and the routing table built (the
    serve's first-use costs), the launch counts set to 0, the requests
    (``stream``'s profiles as rids 0.., or ``requests(engine)``) served,
    and the counts read and checked: the path launched its hop (through
    the sharded entry alone when ``sharded``). With a ManualClock
    ``clock`` the loop advances it one unit before every step and ``run``'s
    stats are None. Returns (engine, stats, launches)."""
    from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
    from repro_torch.query.index import KNNIndex

    engine = QueryEngine(KNNIndex.load(ctx["index_path"]),
                         QueryConfig(**{**SERVE_QC, **qc}),
                         device=ctx["dev"], clock=clock)
    if prepare is not None:
        prepare(engine)
    engine.plan.sync()
    engine.index.path_lut()
    reset_launches()
    reqs = (requests(engine) if requests is not None else
            [QueryRequest(rid=i, profile=p) for i, p in enumerate(stream)])
    for r in reqs:
        engine.submit(r)
    stats = None
    if clock is None:
        stats = engine.run(on_tick=on_tick)
    else:
        while engine.busy():
            clock.advance(1.0)
            engine.step()
    counts = read_launches()
    (check_sharded_launches if sharded else check_path_launches)(
        label, counts, kernel)
    ctx["launches"][label] = counts
    return engine, stats, counts


def by_rid(engine) -> dict:
    """rid → (ids, sims) of the served requests; shed ones → None."""
    return {r.rid: None if r.rejected else (r.ids, r.sims)
            for r in engine.done}


def same_results(a: dict, b: dict, label: str, other: str) -> None:
    import numpy as np

    if sorted(a) != sorted(b):
        fail(f"{label} completed other rids than {other}")
    bad = [rid for rid in a
           if (a[rid] is None) != (b[rid] is None) or a[rid] is not None
           and not (np.array_equal(a[rid][0], b[rid][0])
                    and np.array_equal(a[rid][1], b[rid][1]))]
    if bad:
        fail(f"{label} differs from {other} in {len(bad)} requests "
             f"(rid {bad[0]})")


def cache_serves(ctx) -> None:
    """The 2,048 profiles then the first 1,024 again, ``--cache 4096`` and
    without, as wave x pallas and continuous (256 slots) x pallas_dma:
    equal rid by rid, 1,024 hits; served on, off, off, on for the QPS
    (the host clock drifts between serves). Then a continuous cache-on
    serve with 64 inserts arriving before its first eight ticks, eight a
    tick, flushed by each: the repeats are looked up after the last
    flush, so hits are served from entries stored after it; equal to the
    same serve without the cache rid by rid."""
    import numpy as np

    profiles, n_rep = ctx["profiles"], P4D["repeats"]
    stream = profiles + profiles[:n_rep]
    for name, kernel, qc in (WAVE_PALLAS, CONT_DMA):
        runs = {4096: [], 0: []}
        for cache in (4096, 0, 0, 4096):
            label = f"cache {cache} {name}"
            runs[cache].append(serve4d(ctx, label, kernel,
                                       {**qc, "cache": cache},
                                       stream=stream))
        on, off = runs[4096][0], runs[0][0]
        same_results(by_rid(on[0]), by_rid(off[0]), f"cache-on {name}",
                     "cache off")
        c = on[1]["cache"]
        if c["hits"] != n_rep or c["flushes"] != 0:
            fail(f"cache-on {name}: {c}, expected {n_rep} hits")
        qps = {cache: [r[1]["qps"] for r in rr] for cache, rr in runs.items()}
        ctx["numbers"][f"cache {name}"] = {"qps_on": qps[4096],
                                           "qps_off": qps[0]}
        log(f"[slo] repeated stream ({len(stream)} requests) {name}: QPS "
            f"cache on {qps[4096]}, off {qps[0]} (on, off, off, on: ratio of "
            f"the medians {np.median(qps[4096]) / np.median(qps[0]):.3f}); "
            f"steps {on[1]['waves']} on, {off[1]['waves']} off; cache {c}; "
            f"hop launches {on[2][kernel]} on, {off[2][kernel]} off; "
            f"bitwise equal rid by rid")
    inserts = ctx["inserts"][:P4D["arrivals"]]
    per = P4D["arrivals_per_tick"]

    def arrivals(engine, tick):
        for p in inserts[per * tick:per * (tick + 1)]:
            engine.insert(p)

    name, kernel, qc = CONT_DMA
    on = serve4d(ctx, f"cache 4096 {name} + arrivals", kernel,
                 {**qc, "cache": 4096}, stream=stream, on_tick=arrivals)
    off = serve4d(ctx, f"cache 0 {name} + arrivals", kernel, qc,
                  stream=stream, on_tick=arrivals)
    same_results(by_rid(on[0]), by_rid(off[0]),
                 f"cache-on {name} with arrivals", "cache off")
    c = on[1]["cache"]
    if (c["flushes"] < 1 or c["hits"] < 1
            or on[1]["inserted"] != len(inserts)):
        fail(f"cache-on serve with arrivals: {c}, inserted "
             f"{on[1]['inserted']}; expected flushes and hits after them")
    ctx["numbers"][f"cache {name} + arrivals"] = dict(c)
    log(f"[slo] {name} with {len(inserts)} inserts arriving {per} a tick "
        f"before its first {len(inserts) // per} ticks: cache {c}; bitwise "
        f"equal to cache off rid by rid")


def p95_by_class(done, n_high: int) -> dict:
    import numpy as np

    out = {}
    for cls, reqs in (("class 0", [r for r in done if r.rid < n_high]),
                      ("class 1", [r for r in done if r.rid >= n_high])):
        lats = [r.latency for r in reqs if not r.rejected]
        out[cls] = (float(np.percentile(lats, 95)) if lats else None,
                    len(lats), sum(1 for r in reqs if r.rejected))
    return out


def slo_serves(ctx, fifo: dict) -> None:
    """SLO admission on a ManualClock that the serve loop advances by one
    unit before every step: class 0 the first quarter of the 2,048
    profiles; every eighth class-1 request's deadline half a unit after
    submission (it expires while queued for the first step); the queue
    bounded at 1,024 (overflow shed at the first admission). Wave x {jnp,
    pallas} and continuous x pallas_dma shed the same rids and serve the
    same results, each the FIFO serve's; in waves no class-1 request
    completes before the last class-0 one. Then a wave x pallas serve on
    the host clock, overflow shedding only, for latency by class."""
    from repro_torch.query.engine import QueryRequest
    from repro_torch.sched import ManualClock

    profiles = ctx["profiles"]
    n_high = len(profiles) // 4

    def requests(engine):
        t0 = engine.clock()
        return [QueryRequest(rid=i, profile=p,
                             priority=0 if i < n_high else 1,
                             deadline=t0 + (0.5 if i >= n_high and i % 8 == 7
                                            else 1e6))
                for i, p in enumerate(profiles)]

    slo = dict(admission="slo", max_pending=P4D["max_pending"])
    base = None
    for name, kernel, qc in (WAVE_JNP, WAVE_PALLAS, CONT_DMA):
        label = f"slo {name}"
        engine, _, counts = serve4d(ctx, label, kernel, {**qc, **slo},
                                    requests=requests,
                                    clock=ManualClock(1.0))
        got = by_rid(engine)
        shed = sorted(rid for rid, v in got.items() if v is None)
        expired = sum(1 for rid in shed if rid >= n_high and rid % 8 == 7)
        if not 0 < expired < len(shed) or len(got) != len(profiles):
            fail(f"{label}: {len(shed)} shed, {expired} of them expired")
        same_results({rid: v for rid, v in got.items() if v is not None},
                     {rid: fifo[rid] for rid, v in got.items()
                      if v is not None}, label, "the FIFO serve")
        if base is None:
            base = (got, label)
        else:
            same_results(got, base[0], label, base[1])
        if name.startswith("wave"):
            order = [r.rid for r in engine.done if not r.rejected]
            last0 = max(i for i, rid in enumerate(order) if rid < n_high)
            first1 = min(i for i, rid in enumerate(order) if rid >= n_high)
            t = {r.rid: r.t_done for r in engine.done}
            if t[order[first1]] < t[order[last0]]:
                fail(f"{label}: a class-1 request completed before the "
                     f"last class-0 one")
        by_class = p95_by_class(engine.done, n_high)
        log(f"[slo] {label} (ManualClock, one unit a step): served "
            f"{len(got) - len(shed)}, shed {len(shed)} ({expired} expired, "
            f"{len(shed) - expired} overflow); p95 latency in steps, served, "
            f"shed by class {by_class}; launches {counts}; same shed rids "
            f"and results as {base[1]}, each the FIFO serve's")
    name, kernel, qc = WAVE_PALLAS

    def split(engine):
        return [QueryRequest(rid=i, profile=p,
                             priority=0 if i < n_high else 1)
                for i, p in enumerate(profiles)]

    engine, stats, _ = serve4d(ctx, f"slo host clock {name}", kernel,
                               {**qc, **slo}, requests=split)
    by_class = {cls: (None if v[0] is None else v[0] * 1e3, v[1], v[2])
                for cls, v in p95_by_class(engine.done, n_high).items()}
    ctx["numbers"]["slo host clock"] = {"served": stats["served"],
                                        "shed": stats["shed"],
                                        "by_class": by_class}
    log(f"[slo] slo host clock {name}, priority split {n_high}/"
        f"{len(profiles) - n_high}, max_pending {P4D['max_pending']}: "
        f"served {stats['served']}, shed {stats['shed']}, QPS "
        f"{stats['qps']:.1f}; p95 ms, served, shed by class {by_class}")


def adaptive_serves(ctx) -> None:
    """Continuous (256 slots) x {jnp, pallas, pallas_dma} at ``--adaptive
    1`` and ``2``: bitwise equal across scorers (ids, sims, ticks,
    hop_queries); ticks, slot hops, scored lanes and recall@10 beside the
    non-adaptive serve."""
    profiles = ctx["profiles"]
    paths = (CONT_JNP,
             ("continuous x pallas", FUSED,
              dict(continuous=True, kernel=True)), CONT_DMA)
    engine, _, _ = serve4d(ctx, "adaptive 0 continuous x pallas_dma", DMA,
                           CONT_DMA[2], stream=profiles)
    full = (engine.n_ticks, dict(engine.plan.descent_stats),
            engine.recall_vs_brute_force())
    log(f"[slo] adaptive 0: {full[0]} ticks, {full[1]['hop_queries']} slot "
        f"hops, {full[1]['scored_lanes']} lanes scored, recall@10 "
        f"{full[2]:.4f}")
    for patience in (1, 2):
        base = None
        for name, kernel, qc in paths:
            label = f"adaptive {patience} {name}"
            engine, _, _ = serve4d(ctx, label, kernel,
                                   {**qc, "adaptive": patience},
                                   stream=profiles)
            got = (by_rid(engine), engine.n_ticks,
                   engine.plan.descent_stats["hop_queries"])
            if base is None:
                base = (got, label)
            else:
                same_results(got[0], base[0][0], label, base[1])
                if got[1:] != base[0][1:]:
                    fail(f"{label}: ticks, slot hops {got[1:]} != "
                         f"{base[1]}'s {base[0][1:]}")
        d = engine.plan.descent_stats
        recall = engine.recall_vs_brute_force()
        ctx["numbers"][f"adaptive {patience}"] = {
            "ticks": engine.n_ticks, "hop_queries": d["hop_queries"],
            "recall": recall, "ticks_full": full[0],
            "hop_queries_full": full[1]["hop_queries"],
            "recall_full": full[2]}
        log(f"[slo] adaptive {patience}: {engine.n_ticks} ticks (non-adaptive "
            f"{full[0]}), {d['hop_queries']} slot hops "
            f"({full[1]['hop_queries']}), {d['scored_lanes']} lanes scored "
            f"({full[1]['scored_lanes']}), recall@10 {recall:.4f} (non-"
            f"adaptive {full[2]:.4f}); bitwise equal across the three "
            f"scorers")


def check_swaps(engine, label: str, record: list) -> None:
    """Wrap the engine's Rebalancer.swap: time each swap's host clock and,
    after it, hold the six shard tables and g2l against a fresh
    ShardedDescent on the swapped plan, bitwise."""
    import numpy as np
    import torch

    from repro_torch.query import rebalance, sharded

    reb = engine.rebalance
    plain_swap = reb.swap

    def swap(sd=None):
        sd = sd or engine.sharded_state()
        before = rebalance.measured_imbalance(sd.index, sd.plan)
        sync = (torch.cuda.synchronize if sd.device.type == "cuda"
                else lambda: None)
        sync()
        t0 = time.perf_counter()
        after = plain_swap(sd)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        fresh = sharded.ShardedDescent(sd.index, sd.n_shards, plan=sd.plan,
                                       device=sd.device)
        if not np.array_equal(fresh._g2l, sd._g2l) or not all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(fresh._dev, sd._dev)):
            fail(f"{label}: the tables after swap {sd.generation} differ "
                 f"from a fresh ShardedDescent on the same plan")
        record.append((ms, before, after, sd.generation,
                       dict(reb.merge_stats)))
        return after

    reb.swap = swap


def lanes_moved(engine) -> dict:
    """The in-flight beam lanes that the pending old → new local-id map
    (read before the next tick applies it) sends to another local id or
    to PAD."""
    import numpy as np

    from repro_torch.types import PAD_ID

    mp = engine.plan._sharded._beam_remap
    st = engine.plan._slots
    ids = st.beam_ids.cpu().numpy()  # [S, n_slots, shard beam]
    S = ids.shape[0]
    live = ids != PAD_ID
    new = np.take_along_axis(mp, np.where(live, ids, 0).reshape(S, -1),
                             axis=1).reshape(ids.shape)
    return {"slots": int(st.sched.active_mask().sum()),
            "lanes": int(live.sum()),
            "relabelled": int((live & (new != ids) & (new != PAD_ID)).sum()),
            "evicted": int((live & (new == PAD_ID)).sum())}


def rebalance_serves(ctx, shard_truth: dict) -> None:
    """``--shards 4 --insert 256 --rebalance-every 1
    --rebalance-threshold 1.0`` as wave x pallas and continuous x
    pallas_dma, a swap forced after the inserts if the first check does
    not fire, so that both serve on the same partition: equal rid by rid;
    after every swap the tables equal a fresh ShardedDescent. Then
    continuous x {jnp, pallas_dma} with the 256 inserts before the first
    tick and a swap forced before the second, slots in flight: the swap
    moves rows between shards, so the in-flight beams are relabelled and
    lanes evicted to PAD (at least one lane, else the check fails), and
    the two serves are equal rid by rid. Then swaps forced before every
    tick but the first of a cache-on continuous serve on the fixed index,
    slots in flight: the results of the serve without swaps, and a cache
    flush at each swap."""
    profiles, inserts = ctx["profiles"], ctx["inserts"][:P4D["inserts"]]
    S = P4D["shards"]
    reb_qc = dict(shards=S, rebalance_every=1, rebalance_threshold=1.0)
    base = None
    for name, kernel, qc in (WAVE_PALLAS, CONT_DMA):
        label = f"rebalance {name}"
        record: list = []

        def prepare(engine):
            check_swaps(engine, label, record)
            for p in inserts:
                engine.insert(p)
            if engine.rebalance.check() is None:
                engine.rebalance.swap()  # forced: the check did not fire

        engine, stats, counts = serve4d(ctx, label, kernel, {**qc, **reb_qc},
                                        stream=profiles, prepare=prepare,
                                        sharded=True)
        got = by_rid(engine)
        if base is None:
            base = (got, label)
        else:
            same_results(got, base[0], label, base[1])
        ms = sorted(r[0] for r in record)
        first = record[0]
        ctx["numbers"][label] = {
            "swaps": len(record), "swap_ms_first": first[0],
            "swap_ms_median": ms[len(ms) // 2],
            "imbalance_before": first[1], "imbalance_after": first[2],
            "merge": first[4], "generation": engine.sharded_state().generation}
        log(f"[rebalance] {label}: {len(record)} swaps (generation "
            f"{engine.sharded_state().generation}); first: imbalance "
            f"{first[1]:.4f} -> {first[2]:.4f}, {first[0]:.1f} ms host, merge "
            f"{first[4]}; swap host ms median {ms[len(ms) // 2]:.1f}, max "
            f"{ms[-1]:.1f}; stats {stats['rebalance']}; launches {counts}; "
            f"{sharded_line(engine)}; recall@10 "
            f"{engine.recall_vs_brute_force():.4f}"
            + (f"; bitwise equal to {base[1]}" if base[1] != label else ""))
    base = None
    for name, kernel, qc in (CONT_JNP, CONT_DMA):
        label = f"mid-flight swap {name}"
        record, moved = [], {}

        def schedule(engine, tick, label=label, record=record, moved=moved):
            if tick == 0:
                check_swaps(engine, label, record)
                for p in inserts:
                    engine.insert(p)
            elif tick == 1:
                engine.rebalance.swap()
                moved.update(lanes_moved(engine))

        engine, stats, counts = serve4d(ctx, label, kernel,
                                        {**qc, "shards": S},
                                        stream=profiles, on_tick=schedule,
                                        sharded=True)
        if len(record) != 1 or moved["relabelled"] + moved["evicted"] < 1:
            fail(f"{label}: {len(record)} swaps moved no in-flight lane "
                 f"({moved})")
        got = by_rid(engine)
        if base is None:
            base = (got, label)
        else:
            same_results(got, base[0], label, base[1])
        ms, before, after, generation, merge = record[0]
        ctx["numbers"][label] = {
            "swap_ms": ms, "imbalance_before": before,
            "imbalance_after": after, "merge": merge, **moved}
        log(f"[rebalance] {label}: {len(inserts)} inserts, then a swap with "
            f"{moved['slots']} slots in flight: imbalance {before:.4f} -> "
            f"{after:.4f}, {ms:.1f} ms host, merge {merge}; beam lanes "
            f"relabelled {moved['relabelled']}, evicted to PAD "
            f"{moved['evicted']} of {moved['lanes']}; generation "
            f"{generation}; launches {counts}; recall@10 "
            f"{engine.recall_vs_brute_force():.4f}"
            + (f"; bitwise equal to {base[1]}" if base[1] != label else ""))
    name, kernel, qc = CONT_DMA
    label = f"forced swaps {name}"
    record = []

    def every_tick(engine, tick):
        if tick == 0:
            check_swaps(engine, label, record)
        else:
            engine.rebalance.swap()

    engine, stats, counts = serve4d(ctx, label, kernel,
                                    {**qc, "shards": S, "cache": 4096},
                                    stream=profiles, on_tick=every_tick,
                                    sharded=True)
    same_results(by_rid(engine), shard_truth, label,
                 f"the --shards {S} serve without swaps")
    c = stats["cache"]
    if not record or c["flushes"] != len(record):
        fail(f"{label}: {len(record)} swaps, cache {c}")
    log(f"[rebalance] {label}: a swap before each of {len(record)} ticks "
        f"with slots in flight (generation "
        f"{engine.sharded_state().generation}), swap host ms median "
        f"{sorted(r[0] for r in record)[len(record) // 2]:.1f}; cache {c}; "
        f"bitwise equal to the serve without swaps")


def tiered_serves(ctx, full_line: str) -> None:
    """``--shards 4 --resident-configs 4`` and ``2`` as wave x {jnp,
    pallas} and continuous x pallas_dma: bitwise equal; resident rows, MB
    per shard and recall@10 beside full residency."""
    S = P4D["shards"]
    for rc in (4, 2):
        base = None
        for name, kernel, qc in (WAVE_JNP, WAVE_PALLAS, CONT_DMA):
            label = f"resident_configs {rc} {name}"
            engine, stats, counts = serve4d(
                ctx, label, kernel, {**qc, "shards": S,
                                     "resident_configs": rc},
                stream=ctx["profiles"], sharded=True)
            got = by_rid(engine)
            if base is None:
                base = (got, label)
            else:
                same_results(got, base[0], label, base[1])
        sd = engine.sharded_state()
        recall = engine.recall_vs_brute_force()
        ctx["numbers"][f"resident_configs {rc}"] = {
            "rows": [len(r) for r in sd.plan.residents],
            "mb": [b / 1e6 for b in sd.resident_bytes()], "recall": recall}
        log(f"[rebalance] resident_configs {rc}: {sharded_line(engine)}; "
            f"recall@10 {recall:.4f}; bitwise equal three ways (full "
            f"residency: {full_line})")


def cpu_equals_card(ctx) -> None:
    """A small synth serve with every knob of this phase on (shards,
    continuous slots, the DMA hop, slo admission with a bounded queue and
    a priority split, adaptive budgets, the cache, re-balance, tiered
    residency, inserts), on the card and on the CPU: equal results and
    counters."""
    from repro_torch.launch import knn_serve

    flags = P4D["small"] + [
        "--queries", "96", "--shards", "2", "--continuous", "--slots",
        "16", "--kernel", "--dma", "--admission", "slo", "--max-pending",
        "40", "--priority-split", "0.25", "--adaptive", "1", "--cache",
        "64", "--rebalance-every", "1", "--rebalance-threshold", "1.0",
        "--resident-configs", "2", "--insert", "20"]
    reset_launches()
    card = knn_serve.main(flags + ["--device", "cuda"])
    check_sharded_launches("the all-knobs synth serve", read_launches(), DMA)
    cpu = knn_serve.main(flags + ["--device", "cpu"])
    same_results(by_rid(card[2]), by_rid(cpu[2]),
                 "the all-knobs synth serve on the card", "the CPU's")
    keys = ("requests", "served", "shed", "waves", "cache", "rebalance")
    if any(card[0][k] != cpu[0][k] for k in keys) or card[1] != cpu[1]:
        fail(f"the all-knobs synth serve: card {[card[0][k] for k in keys]}"
             f" != CPU {[cpu[0][k] for k in keys]}")
    log(f"[slo] all-knobs synth serve: card equals CPU (served "
        f"{card[0]['served']}, shed {card[0]['shed']}, cache "
        f"{card[0]['cache']}, rebalance {card[0]['rebalance']}, recall@10 "
        f"{card[1]:.4f})")


def slo_cache_rebalance(dev, run: dict, shard: dict) -> dict:
    """Phase 4d on the paper index of phase 4."""
    qds = main_queries()
    ctx = {"dev": dev, "index_path": run["index_path"], "launches": {},
           "numbers": {},
           "profiles": [qds.profile(u) for u in range(P4D["queries"])],
           "inserts": [qds.profile(qds.n_users - 1 - m)
                       for m in range(P4D["inserts"])]}
    t0 = time.perf_counter()
    cache_serves(ctx)
    slo_serves(ctx, by_rid(run["engine"]))
    adaptive_serves(ctx)
    rebalance_serves(ctx, by_rid(shard["engine"]))
    tiered_serves(ctx, sharded_line(shard["engine"]))
    cpu_equals_card(ctx)
    ctx["seconds"] = time.perf_counter() - t0
    log(f"[slo] phase 4d: {ctx['seconds']:.1f} s")
    return ctx


# -- phase 4e: faults, degraded serving, failover, crash recovery ----------

# ``kill:1@2`` under this health config masks shard 1 from step 2, declares
# it dead at step 5 and swaps a fresh partition in at the end of step 7:
# the degraded window and the failover both fall inside the serve of the
# 2,048 profiles (32 waves of 64, or ~24 ticks of 256 slots).
P4E = dict(kill="kill:1@2", fail="fail:2@1+2", crash="crash@5",
           health=dict(max_retries=2, backoff_cap=2, recover_after=2),
           qc=dict(max_wave=64, shards=4), inserts=256, snapshot_every=2,
           crash_steps=6)
P4E_WAVES = (("wave x jnp", None, {}), ("wave x pallas", FUSED,
                                        dict(kernel=True)),
             ("wave x pallas_dma", DMA, dict(kernel=True, dma=True)))
P4E_CONT = (CONT_JNP, CONT_DMA)


def device_sync(dev):
    import torch

    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def injector(spec: str):
    from repro_torch.faults import FaultInjector, FaultPlan, HealthConfig

    return FaultInjector(FaultPlan.parse(spec),
                         health=HealthConfig(**P4E["health"]))


def serve4e(ctx, label, kernel, qc, spec, stream, shard_devices=None):
    """One serve of the ``stream`` (rids 0..) through ``QueryEngine`` on a
    fresh copy of the paper index at ``--shards 4``, with the fault plan
    ``spec``: each step's host clock and completions, and each failover
    swap's host clock, recorded; the launch counts from 0 and checked (the
    hop through the sharded entry alone). Returns (engine, stats, steps,
    failover ms) with steps [(seconds, requests completed, degraded)]."""
    from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
    from repro_torch.query.index import KNNIndex

    engine = QueryEngine(KNNIndex.load(ctx["index_path"]),
                         QueryConfig(**{**SERVE_QC, **P4E["qc"], **qc}),
                         device=ctx["dev"], faults=injector(spec),
                         shard_devices=shard_devices)
    engine.plan.sync()
    engine.index.path_lut()
    sync = device_sync(ctx["dev"])
    steps, swaps = [], []
    plain_step, plain_maintain = engine.step, engine.failover.maintain

    def step():
        base = len(engine.done)
        t0 = time.perf_counter()
        n = plain_step()
        sync()
        new = engine.done[base:]
        steps.append((time.perf_counter() - t0, len(new),
                      any(r.degraded for r in new) if new
                      else engine.degraded))
        return n

    def maintain():
        sync()
        t0 = time.perf_counter()
        out = plain_maintain()
        sync()
        if out is not None:
            swaps.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.step, engine.failover.maintain = step, maintain
    reset_launches()
    for i, p in enumerate(stream):
        engine.submit(QueryRequest(rid=i, profile=p))
    stats = engine.run()
    counts = read_launches()
    check_sharded_launches(label, counts, kernel)
    ctx["launches"][label] = counts
    return engine, stats, steps, swaps


def window_numbers(engine, steps, healthy_engine) -> dict:
    """QPS of the steps that served degraded and of the others, and the
    degraded requests' recall@10 beside the healthy fleet's on the same
    rids."""
    deg = [r for r in engine.done if r.degraded]
    rids = {r.rid for r in deg}
    same = [r for r in healthy_engine.done if r.rid in rids]
    n_deg = sum(n for _, n, d in steps if d)
    t_deg = sum(s for s, n, d in steps if d)
    n_ok = sum(n for _, n, d in steps if not d)
    t_ok = sum(s for s, n, d in steps if not d)
    return {"degraded": len(deg), "qps_degraded": n_deg / max(t_deg, 1e-9),
            "qps_healthy": n_ok / max(t_ok, 1e-9),
            "steps_degraded": sum(1 for *_, d in steps if d),
            "recall_degraded": engine.recall_vs_brute_force(deg),
            "recall_healthy_same_rids":
                healthy_engine.recall_vs_brute_force(same)}


def check_fresh_shard_tables(engine, label: str) -> None:
    """The shard tables equal a fresh ShardedDescent on the same plan."""
    import numpy as np
    import torch

    from repro_torch.query import sharded

    sd = engine.sharded_state()
    fresh = sharded.ShardedDescent(sd.index, sd.n_shards, plan=sd.plan,
                                   device=sd.device)
    if not np.array_equal(fresh._g2l, sd._g2l) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(fresh._dev, sd._dev)):
        fail(f"{label}: the tables after the failover differ from a fresh "
             f"ShardedDescent on the same plan")


def reserve(engine, profiles, label, healthy: dict) -> None:
    """Serve the profiles again (rids 0..) on the recovered fleet: bitwise
    the healthy fleet's answers, none degraded."""
    from repro_torch.query.engine import QueryRequest

    engine.done.clear()
    for i, p in enumerate(profiles):
        engine.submit(QueryRequest(rid=i, profile=p))
    engine.run()
    if any(r.degraded for r in engine.done):
        fail(f"{label}: a request after the failover served degraded")
    same_results(by_rid(engine), healthy, f"{label} after the failover",
                 "the healthy --shards 4 serve of phase 4c")


def kill_serves(ctx) -> None:
    """(a) ``kill:1@2`` as wave x {jnp, pallas, pallas_dma} and continuous
    x {jnp, pallas_dma}: equal rid by rid within a batching, with equal
    fault stats; the tables after the failover a fresh ShardedDescent's;
    a re-serve bitwise the healthy fleet's."""
    profiles, healthy = ctx["profiles"], ctx["healthy"]
    for paths in (P4E_WAVES, P4E_CONT):
        base = None
        for name, kernel, qc in paths:
            label = f"kill {name}"
            engine, stats, steps, swaps = serve4e(ctx, label, kernel, qc,
                                                  P4E["kill"], profiles)
            f = stats["faults"]
            if (stats["requests"] != len(profiles) or f["failovers"] != 1
                    or f["deaths"] != 1 or f["degraded_served"] < 1
                    or f["merge"]["excluded"] != [1]):
                fail(f"{label}: {stats['requests']} served, faults {f}")
            ctx["kill_results"][label] = (by_rid(engine), f)
            if base is None:
                base = (by_rid(engine), f, label)
            else:
                same_results(by_rid(engine), base[0], label, base[2])
                if f != base[1]:
                    fail(f"{label}: fault stats {f} != {base[2]}'s {base[1]}")
            check_fresh_shard_tables(engine, label)
            nums = window_numbers(engine, steps, ctx["healthy_engine"])
            nums["failover_ms"] = swaps
            ctx["numbers"][label] = nums
            reserve(engine, profiles, label, healthy)
            log(f"[faults] {label}: {stats['requests']} served in "
                f"{stats['waves']} steps, {nums['degraded']} degraded over "
                f"{nums['steps_degraded']} steps; QPS degraded "
                f"{nums['qps_degraded']:.1f}, healthy {nums['qps_healthy']:.1f}"
                f"; recall@10 degraded {nums['recall_degraded']:.4f} against "
                f"{nums['recall_healthy_same_rids']:.4f} for the healthy "
                f"fleet on the same rids; failover host ms "
                f"{[round(x, 3) for x in swaps]}; faults {f}; launches "
                f"{ctx['launches'][label]}"
                + ("" if base[2] == label else f"; bitwise equal to "
                   f"{base[2]}") + "; tables after the failover equal a "
                "fresh ShardedDescent; re-serve bitwise the healthy fleet's")


def transient_serve(ctx) -> None:
    """(b) ``fail:2@1+2``: the shard is masked while it fails and comes
    back without a death or a failover."""
    name, kernel, qc = WAVE_PALLAS
    label = f"fail {name}"
    engine, stats, _, _ = serve4e(ctx, label, kernel, qc, P4E["fail"],
                                  ctx["profiles"])
    f = stats["faults"]
    if (f["failovers"] != 0 or f["deaths"] != 0 or f["degraded_served"] < 1
            or f["states"] != ["healthy"] * 4):
        fail(f"{label}: faults {f}")
    ctx["numbers"][label] = dict(f)
    log(f"[faults] {label}: {f['degraded_served']} served degraded, "
        f"{f['retries']} retries, {f['backoff_steps']} backoff steps, 0 "
        f"deaths, 0 failovers; launches {ctx['launches'][label]}")


def cache_window_serve(ctx) -> None:
    """(c) A cache-on serve of the 2,048 profiles and the first 1,024 again
    across ``kill:1@2``: degraded results are skipped, never stored, and
    every repeat (hit or miss) is the healthy fleet's answer."""
    name, kernel, qc = WAVE_PALLAS
    label = f"kill cache 4096 {name}"
    profiles, healthy = ctx["profiles"], ctx["healthy"]
    n = len(profiles)
    engine, stats, _, _ = serve4e(ctx, label, kernel,
                                  {**qc, "cache": 4096}, P4E["kill"],
                                  profiles + profiles[:P4D["repeats"]])
    c, f = stats["cache"], stats["faults"]
    if not (0 < c["degraded_skips"] <= f["degraded_served"]
            and c["hits"] > 0 and f["failovers"] == 1):
        fail(f"{label}: cache {c}, faults {f}")
    first = {rid: v for rid, v in by_rid(engine).items() if rid < n}
    repeats = {rid - n: v for rid, v in by_rid(engine).items() if rid >= n}
    same_results(repeats, {rid: healthy[rid] for rid in repeats},
                 f"{label} repeats", "the healthy fleet's answers")
    ok = {r.rid for r in engine.done if r.rid < n and not r.degraded}
    same_results({rid: first[rid] for rid in ok},
                 {rid: healthy[rid] for rid in ok},
                 f"{label} requests served healthy", "the healthy fleet")
    ctx["numbers"][label] = dict(c)
    log(f"[faults] {label}: cache {c}; {f['degraded_served']} served "
        f"degraded, none stored; every repeat the healthy fleet's answer")


def crash_recovery(ctx, tmp: Path) -> None:
    """(d) ``--store DIR --snapshot-every 2`` with 256 inserts over the
    first six steps and ``crash@5`` (wave x pallas_dma), beside a mirror
    that never crashes (wave x jnp); ``QueryEngine.recover`` as wave x jnp
    and wave x pallas_dma: the mirror's index (rows, cluster tables,
    version) and its answers to the 2,048 profiles, bitwise. Times the
    snapshots, the WAL records, the replay and the recovery."""
    import numpy as np

    from repro_torch.faults import (CrashStore, EngineCrash, FaultInjector,
                                    FaultPlan, WriteAheadLog, replay)
    from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
    from repro_torch.query.index import KNNIndex

    dev, sync = ctx["dev"], device_sync(ctx["dev"])
    root = tmp / "crash_store"
    qc = {**SERVE_QC, **P4E["qc"]}
    store = CrashStore(root, every=P4E["snapshot_every"])
    snaps = []
    plain_snapshot = store.snapshot

    def snapshot(engine):
        sync()
        t0 = time.perf_counter()
        plain_snapshot(engine)
        ms = (time.perf_counter() - t0) * 1e3
        man = json.loads((root / "manifest.json").read_text())
        snaps.append((ms, sum((root / man[k]).stat().st_size
                              for k in ("snapshot", "plan") if man[k])))

    store.snapshot = snapshot
    spent = {"wal": 0.0}
    plain_record = WriteAheadLog.record
    WriteAheadLog.record = timed_calls(spent, "wal", plain_record)
    try:
        engine = QueryEngine(
            KNNIndex.load(ctx["index_path"]),
            QueryConfig(**qc, kernel=True, dma=True), device=dev,
            faults=FaultInjector(FaultPlan.parse(P4E["crash"])), store=store)
        mirror = QueryEngine(KNNIndex.load(ctx["index_path"]),
                             QueryConfig(**qc), device=dev)
        chunks = np.array_split(np.arange(P4E["inserts"]),
                                P4E["crash_steps"])
        crashed = None
        for t, chunk in enumerate(chunks):
            for e in (engine, mirror):
                for m in chunk:
                    e.insert(ctx["inserts"][m])
                for i in range(64):
                    e.submit(QueryRequest(rid=64 * t + i,
                                          profile=ctx["profiles"][64 * t + i]))
            try:
                engine.step()
            except EngineCrash as e:
                crashed = (t, str(e))
            mirror.step()  # the mirror also runs the step the crash ate
            if crashed:
                break
    finally:
        WriteAheadLog.record = plain_record
    n_records = sum(len(WriteAheadLog.read(w))
                    for w in sorted(root.glob("wal_*.jsonl")))
    if crashed is None or crashed[0] != P4E["crash_steps"] - 1:
        fail(f"crash recovery: the engine crashed at {crashed}")
    # The replay alone, then the whole recovery (snapshot load, replay,
    # the plan sidecar, the shard tables on the card) two ways.
    man = json.loads((root / "manifest.json").read_text())
    records = WriteAheadLog.read(root / man["wal"])
    index = KNNIndex.load(root / man["snapshot"])
    t0 = time.perf_counter()
    replay(index, records)
    replay_ms = (time.perf_counter() - t0) * 1e3
    recovered, recover_ms = {}, {}
    for name, kernel, extra in (WAVE_JNP, P4E_WAVES[2]):
        sync()
        t0 = time.perf_counter()
        rec = QueryEngine.recover(root, QueryConfig(**qc, **extra),
                                  device=dev)
        rec.sharded_state()
        sync()
        recover_ms[name] = (time.perf_counter() - t0) * 1e3
        recovered[name] = (rec, kernel)
    mirror.done.clear()
    for i, p in enumerate(ctx["profiles"]):
        mirror.submit(QueryRequest(rid=i, profile=p))
    mirror.run()
    for name, (rec, kernel) in recovered.items():
        label = f"recovered {name}"
        reset_launches()
        for i, p in enumerate(ctx["profiles"]):
            rec.submit(QueryRequest(rid=i, profile=p))
        rec.run()
        counts = read_launches()
        check_sharded_launches(label, counts, kernel)
        ctx["launches"][label] = counts
        same_results(by_rid(rec), by_rid(mirror), label,
                     "the mirror that never crashed")
    state = index_state(mirror.index)
    for name, (rec, _) in recovered.items():
        bad = same_state(index_state(rec.index), state)
        if bad:
            fail(f"recovered {name}: the index differs from the mirror's in "
                 f"{bad}")
    wal_ms = spent["wal"] * 1e3 / max(n_records, 1)
    ctx["numbers"]["crash"] = {
        "crashed_at": crashed[0], "snapshots": snaps,
        "wal_records": n_records, "wal_ms_per_record": wal_ms,
        "replayed": len(records), "replay_ms": replay_ms,
        "recover_ms": recover_ms, "version": state["version"]}
    log(f"[faults] crash at step {crashed[0]} ({crashed[1]}); "
        f"{len(snaps)} snapshots, ms {[round(s[0], 3) for s in snaps]}, "
        f"bytes {[s[1] for s in snaps]}; {n_records} WAL records at "
        f"{wal_ms:.4f} ms a record; replay of {len(records)} records "
        f"{replay_ms:.3f} ms; recover ms "
        f"{ {k: round(v, 3) for k, v in recover_ms.items()} }; the recovered "
        f"index equals the mirror's (rows, cluster tables, version "
        f"{state['version']}) and serves its {len(ctx['profiles'])} "
        f"answers bitwise as wave x jnp and wave x pallas_dma (launches "
        f"{ctx['launches']['recovered wave x pallas_dma']})")


def fault_knobs_cpu_equals_card(ctx, tmp: Path) -> None:
    """(e) A small synth serve with every fault knob on (a kill, a
    transient failure, a slow shard, the crash store), then a crash and
    its recovery, on the card and on the CPU, each store recovered on the
    other device: equal results and counters."""
    from repro_torch.launch import knn_serve

    common = P4D["small"] + ["--shards", "2", "--kernel", "--dma"]
    small = common + ["--insert", "20", "--snapshot-every", "2"]
    flags = small + ["--queries", "96", "--continuous", "--slots", "16",
                     "--cache", "64", "--fault-plan",
                     "kill:1@2;fail:0@6+2;slow:1@3+1:1"]
    runs = {}
    for device in ("cuda", "cpu"):
        reset_launches()
        runs[device] = knn_serve.main(flags + [
            "--store", str(tmp / f"knobs_{device}"), "--device", device])
        if device == "cuda":
            check_sharded_launches("the fault-knobs synth serve",
                                   read_launches(), DMA)
    card, cpu = runs["cuda"], runs["cpu"]
    same_results(by_rid(card[2]), by_rid(cpu[2]),
                 "the fault-knobs synth serve on the card", "the CPU's")
    keys = ("requests", "served", "waves", "cache", "faults", "store")
    if any(card[0][k] != cpu[0][k] for k in keys) or card[1] != cpu[1]:
        fail(f"the fault-knobs synth serve: card "
             f"{[card[0][k] for k in keys]} != CPU "
             f"{[cpu[0][k] for k in keys]}")
    crash = small + ["--queries", "64", "--max-wave", "8", "--fault-plan",
                     "crash@3"]
    for device in ("cuda", "cpu"):
        out = knn_serve.main(crash + ["--store", str(tmp / f"crash_{device}"),
                                      "--device", device])
        if out[0] != {"requests": 0, "crashed": True}:
            fail(f"the synth crash on {device}: {out[0]}")
    rec = {device: knn_serve.main(
        common + ["--queries", "64", "--recover",
                      str(tmp / f"crash_{other}"), "--device", device])
        for device, other in (("cuda", "cpu"), ("cpu", "cuda"))}
    same_results(by_rid(rec["cuda"][2]), by_rid(rec["cpu"][2]),
                 "the CPU's store recovered on the card",
                 "the card's store recovered on the CPU")
    if rec["cuda"][1] != rec["cpu"][1] or rec["cuda"][0]["requests"] != 64:
        fail(f"synth recovery: recall {rec['cuda'][1]} != {rec['cpu'][1]}")
    f = card[0]["faults"]
    log(f"[faults] fault-knobs synth serve: card equals CPU (served "
        f"{card[0]['served']}, faults {f}, cache {card[0]['cache']}, store "
        f"{card[0]['store']}, recall@10 {card[1]:.4f}); crash@3 on both, "
        f"each store recovered on the other device: equal (recall@10 "
        f"{rec['cuda'][1]:.4f})")


def faults_and_recovery(dev, run: dict, shard: dict, tmp: Path) -> dict:
    """Phase 4e on the paper index of phase 4."""
    qds = main_queries()
    ctx = {"dev": dev, "index_path": run["index_path"], "launches": {},
           "numbers": {}, "kill_results": {},
           "healthy": by_rid(shard["engine"]),
           "healthy_engine": shard["engine"],
           "profiles": [qds.profile(u) for u in range(P4D["queries"])],
           "inserts": [qds.profile(qds.n_users - 1 - m)
                       for m in range(P4E["inserts"])]}
    t0 = time.perf_counter()
    kill_serves(ctx)
    transient_serve(ctx)
    cache_window_serve(ctx)
    crash_recovery(ctx, tmp)
    fault_knobs_cpu_equals_card(ctx, tmp)
    ctx["seconds"] = time.perf_counter() - t0
    log(f"[faults] phase 4e: {ctx['seconds']:.1f} s")
    return ctx


# -- phase 4f: the paper's baselines and Table V's raw mode ----------------

def synced(fn):
    """(fn(), host seconds) between two synchronisations of the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def baseline_runs(ds, gf, params, device) -> dict:
    """Table II's four builds of ``ds`` at the benches' parameters on
    ``device``: Hyrec and NNDescent (30 iterations at most, δ 0.001), LSH
    (t hash functions) and C²; per algorithm its graph, stats, host
    seconds and cluster-KNN launches (counted from 0)."""
    import torch

    from repro_torch.core.pipeline import cluster_and_conquer
    from repro_torch.knn.greedy import hyrec, nndescent
    from repro_torch.knn.lsh import lsh_knn

    k = params.k
    builds = (
        ("Hyrec", lambda: hyrec(gf, k=k, max_iters=30, delta=0.001,
                                device=device)),
        ("NNDescent", lambda: nndescent(gf, k=k, max_iters=30, delta=0.001,
                                        device=device)),
        ("LSH", lambda: lsh_knn(ds, gf, k=k, t=params.t, device=device)),
        ("C2", lambda: cluster_and_conquer(ds, params, gf=gf,
                                           device=device)))
    runs = {}
    for name, fn in builds:
        reset_launches()
        (graph, stats), secs = synced(fn)
        counts = read_launches()
        step1 = int(name == "C2" and torch.device(device).type == "cuda")
        if counts["frh_minhash_distinct"] != step1 or any(
                v for key, v in counts.items()
                if key not in ("goldfinger_knn", "frh_minhash_distinct")):
            fail(f"{name} on {device} launched {counts}")
        runs[name] = {"graph": graph, "stats": stats, "seconds": secs,
                      "launches": counts["goldfinger_knn"]}
    return runs


def stats_key(name: str, stats) -> tuple:
    """What must agree between two runs of one algorithm."""
    if name in ("Hyrec", "NNDescent"):
        return stats.iters, stats.updates, stats.n_sims
    if name == "LSH":
        return stats["n_buckets"], stats["n_sims"], stats["max_bucket"]
    return stats.n_clusters, stats.n_sims, stats.max_cluster


def table2_row(dev, ds, gf, params, label: str) -> tuple[dict, dict]:
    """One row of Table II on the card: brute force through the
    cluster-KNN kernel as the exact graph, then the four builds with their
    quality (Eq. 2), iterations and updates; C²'s speed-up over the best
    baseline, as ``benchmarks/table2.py`` computes it."""
    import math

    from repro_torch.eval.metrics import quality
    from repro_torch.knn.brute_force import brute_force_knn
    from repro_torch.knn.lsh import lsh_plan

    k = params.k
    reset_launches()
    exact, t_bf = synced(lambda: brute_force_knn(gf, k, device=dev))
    bf_launches = read_launches()["goldfinger_knn"]
    runs = baseline_runs(ds, gf, params, dev)
    plan = lsh_plan(ds, params.t)
    n_hyrec = int((plan.sizes >= params.bf_threshold).sum())
    if n_hyrec < 1:
        fail(f"{label}: no LSH bucket reached rho*k^2 = "
             f"{params.bf_threshold}: the Hyrec branch was not exercised")
    row = {"n_users": ds.n_users, "k": k, "b": params.b,
           "N": params.max_cluster, "t": params.t,
           "BruteForce": {"seconds": t_bf, "launches": bf_launches}}
    for name, r in runs.items():
        q = quality(ds, r["graph"], exact, device=dev)
        if not (math.isfinite(q) and 0 < q <= 1.05):
            fail(f"{label} {name}: quality {q} not in (0, 1.05]")
        if name in ("LSH", "C2") and r["launches"] < 1:
            fail(f"{label} {name} never launched the cluster-KNN kernel")
        row[name] = {"seconds": r["seconds"], "quality": q,
                     "launches": r["launches"]}
        st = r["stats"]
        extra = ""
        if name in ("Hyrec", "NNDescent"):
            row[name].update(iters=st.iters, updates=st.updates,
                             n_sims=st.n_sims)
            extra = f", {st.iters} iterations, updates {st.updates}"
        elif name == "LSH":
            row[name].update(n_buckets=st["n_buckets"],
                             max_bucket=st["max_bucket"],
                             hyrec_buckets=n_hyrec, n_sims=st["n_sims"])
            extra = (f", {st['n_buckets']} buckets (largest "
                     f"{st['max_bucket']}; {n_hyrec} took Hyrec)")
        else:
            row[name].update(n_clusters=st.n_clusters, n_sims=st.n_sims,
                             t_cluster=st.t_cluster, t_local=st.t_local,
                             t_merge=st.t_merge)
            extra = (f", {st.n_clusters} clusters, {st.n_sims} sims; host "
                     f"clustering {st.t_cluster * 1e3:.1f} ms, Step 2 "
                     f"{st.t_local * 1e3:.1f} ms, merge "
                     f"{st.t_merge * 1e3:.1f} ms")
        log(f"[baselines] {label} {name}: {r['seconds']:.4f} s, quality "
            f"{q:.4f}, {r['launches']} cluster-KNN launches{extra}")
    best = min(runs[n]["seconds"] for n in ("Hyrec", "NNDescent", "LSH"))
    row["C2"]["speedup_vs_best_baseline"] = best / runs["C2"]["seconds"]
    log(f"[baselines] {label}: brute force {t_bf:.4f} s ({bf_launches} "
        f"launches); C2 {runs['C2']['seconds']:.4f} s against the best "
        f"baseline's {best:.4f} s: x{best / runs['C2']['seconds']:.2f}")
    return row, runs


def card_equals_cpu(ds, gf, params, card_runs: dict, label: str) -> dict:
    """The four builds on the CPU, bitwise the card's: ids, sims and
    stats."""
    import numpy as np

    cpu = baseline_runs(ds, gf, params, "cpu")
    for name, r in card_runs.items():
        c = cpu[name]
        if not (np.array_equal(r["graph"].ids, c["graph"].ids)
                and np.array_equal(r["graph"].sims, c["graph"].sims)):
            fail(f"{label} {name}: the card's graph differs from the CPU's")
        if stats_key(name, r["stats"]) != stats_key(name, c["stats"]):
            fail(f"{label} {name}: stats {stats_key(name, r['stats'])} on "
                 f"the card, {stats_key(name, c['stats'])} on the CPU")
    log(f"[baselines] {label}: Hyrec, NNDescent, LSH and C2 bitwise equal "
        f"on the card and the CPU, stats included (CPU "
        + ", ".join(f"{n} {c['seconds']:.2f} s" for n, c in cpu.items())
        + ")")
    return {n: c["seconds"] for n, c in cpu.items()}


def step2_bytes(mem, W: int, k: int) -> int:
    """Bytes one cluster-KNN call over the batch ``mem`` ([m, cap] member
    ids, PAD-padded) must move: each member's W words and card read once,
    every slot's id read once, the [m, cap, k] ids and sims written once.
    A PAD slot's words are never needed, so its row is not counted."""
    from repro_torch.types import PAD_ID

    live = int((mem != PAD_ID).sum())
    return live * (4 * W + 4) + mem.size * (4 + 8 * k)


def raw_sweep(dev, ds, gf_raw, params, launches: int) -> tuple[dict, float]:
    """The raw build's Step-2 batches (incidence rows, W = ceil(|I| / 32)),
    each held bitwise against the plain version on the card, then timed
    beside the plain version and the sweep's bound."""
    import torch

    from repro_torch.core.clustering import build_plan
    from repro_torch.core.local_knn import batch_inputs, group_batches
    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import words_tensor

    plan = build_plan(ds, params)
    words = words_tensor(gf_raw.words, dev)
    card = torch.from_numpy(gf_raw.card).to(dev)
    W, k = words.shape[1], params.k
    batches, pairs, nbytes = [], 0, 0
    for _, batch, mem in group_batches(plan, W, params.bf_threshold):
        batches.append(batch_inputs(words, card, mem))
        pairs += int(sum(s * (s - 1) for s in plan.sizes[batch]))
        nbytes += step2_bytes(mem, W, k)
    if len(batches) != launches:
        fail(f"raw build: {launches} cluster-KNN launches for "
             f"{len(batches)} Step-2 batches")
    err = 0.0
    for j, (w, c, i) in enumerate(batches):
        ki, ks = ops.cluster_knn(w, c, i, k)
        pi, ps = ref.cluster_knn_ref(w, c, i, k)
        if not (torch.equal(ki, pi) and torch.equal(ks, ps)):
            fail(f"raw build: Step-2 batch {j} (cap {w.shape[1]}, W={W}) "
                 f"differs from the plain version")
        err = max(err, max_abs_err(ks, ps))
    ms = cuda_ms(lambda: [ops.cluster_knn(w, c, i, k) for w, c, i in batches],
                 reps=5, hold=True)
    plain_ms = cuda_ms(lambda: [ref.cluster_knn_ref(w, c, i, k)
                                for w, c, i in batches], reps=1)
    t_ops = 2 * pairs * W * 32 / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    p = ops.launch_params(32, 32, W, k)
    log(f"[baselines] raw Step-2 sweep, W={W}: {len(batches)} batches "
        f"bitwise equal to the plain version; {ms:.4f} ms of device time "
        f"(plain {plain_ms:.4f} ms), bound {max(t_ops, t_bytes):.5f} ms "
        f"(operations {t_ops:.5f}, bytes {t_bytes:.5f}); {pairs} ordered "
        f"pairs; launch {p}")
    return {"W": W, "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": pairs, "chunk": p.chunk, "warps": p.warps}, err


def tables_4_and_5(dev) -> dict:
    """Tables IV and V on AM@0.055 (all 171,356 items), k = 10: C² with
    FastRandomHash on 1,024-bit GoldFinger, C² with the MinHash plan
    (``lsh_plan`` + ``local_knn`` + ``merge_partial``) and C² on
    incidence rows (raw mode, exact Jaccard)."""
    import numpy as np

    from repro_torch.core.local_knn import local_knn
    from repro_torch.core.merge import merge_partial
    from repro_torch.bench.common import BENCH_SCALES, bench_params
    from repro_torch.core.pipeline import cluster_and_conquer
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.eval.metrics import quality
    from repro_torch.knn.brute_force import brute_force_knn
    from repro_torch.knn.lsh import lsh_plan
    from repro_torch.sketch.exact import edge_jaccard
    from repro_torch.sketch.goldfinger import (fingerprint_dataset,
                                               incidence_fingerprint)
    from repro_torch.types import PAD_ID

    ds = make_dataset("AM", scale=BENCH_SCALES["AM"], seed=0)
    p = bench_params("AM", ds.n_users)
    gf = fingerprint_dataset(ds, n_bits=p.n_bits, seed=p.seed)
    exact = brute_force_knn(gf, p.k, device=dev)
    out = {"n_users": ds.n_users, "n_items": ds.n_items, "k": p.k, "b": p.b,
           "N": p.max_cluster, "t": p.t}

    def minhash():
        plan = lsh_plan(ds, t=p.t)
        ids, sims = local_knn(plan, gf, p, device=dev)
        return merge_partial(ids, sims, p.k, device=dev), plan

    gf_raw, t_fp = synced(lambda: incidence_fingerprint(ds))
    builds = (("FRH", lambda: cluster_and_conquer(ds, p, gf=gf, device=dev)),
              ("MinHash", minhash),
              ("raw", lambda: cluster_and_conquer(ds, p, gf=gf_raw,
                                                  device=dev)))
    for name, fn in builds:
        reset_launches()
        (graph, st), secs = synced(fn)
        launches = read_launches()["goldfinger_knn"]
        if launches < 1:
            fail(f"AM {name} never launched the cluster-KNN kernel")
        q = quality(ds, graph, exact, device=dev)
        if name == "MinHash":
            n_clusters, sims = st.n_clusters, st.brute_force_sims()
            hyrec = int((st.sizes >= p.bf_threshold).sum())
        else:
            n_clusters, sims, hyrec = st.n_clusters, st.n_sims, 0
        wpu = (gf_raw if name == "raw" else gf).words.shape[1]
        out[name] = {"seconds": secs, "quality": q, "n_clusters": n_clusters,
                     "sims": sims, "words_per_user": wpu,
                     "launches": launches, "hyrec_clusters": hyrec}
        log(f"[baselines] AM@0.055 C2 {name}: {secs:.4f} s, quality {q:.4f}, "
            f"{n_clusters} clusters ({hyrec} took Hyrec), {sims} Step-2 sims, "
            f"{wpu} words a user, {launches} cluster-KNN launches")
        if name == "raw":
            raw_graph = graph
    out["raw"]["incidence_seconds"] = t_fp
    # Raw mode is exact Jaccard: every edge's sim is edge_jaccard's.
    live = raw_graph.ids != PAD_ID
    n, k = raw_graph.ids.shape
    ej = edge_jaccard(ds, np.repeat(np.arange(n, dtype=np.int32), k),
                      raw_graph.ids.reshape(-1), device=dev).reshape(n, k)
    if not np.array_equal(raw_graph.sims[live], ej[live]):
        fail(f"raw build: {int((raw_graph.sims[live] != ej[live]).sum())} "
             f"edge sims differ from the exact Jaccard")
    log(f"[baselines] raw build: all {int(live.sum())} edge sims equal the "
        f"exact Jaccard (edge_jaccard); MinHash / FRH time "
        f"x{out['MinHash']['seconds'] / out['FRH']['seconds']:.2f}, raw / "
        f"FRH x{out['raw']['seconds'] / out['FRH']['seconds']:.2f}")
    out["raw_sweep"], out["raw_err"] = raw_sweep(
        dev, ds, gf_raw, p, out["raw"]["launches"])
    return out


def baselines_and_raw_mode(dev) -> dict:
    """Phase 4f: one row of Tables II (ml1M@1.0 on the card; ml1M@0.35 on
    the card and the CPU, bitwise), IV and V (AM@0.055)."""
    from repro_torch.bench.common import BENCH_SCALES, bench_params
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.sketch.goldfinger import fingerprint_dataset

    t0 = time.perf_counter()
    numbers = {}
    for scale in (1.0, BENCH_SCALES["ml1M"]):
        label = f"ml1M@{scale}"
        ds = make_dataset("ml1M", scale=scale, seed=0)
        p = bench_params("ml1M", ds.n_users)
        gf = fingerprint_dataset(ds, n_bits=p.n_bits, seed=p.seed)
        numbers[label], runs = table2_row(dev, ds, gf, p, label)
        if scale != 1.0:
            numbers[label]["cpu_seconds"] = card_equals_cpu(ds, gf, p, runs,
                                                            label)
    numbers["AM@0.055"] = tables_4_and_5(dev)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"[baselines] phase 4f: {numbers['seconds']:.1f} s")
    return numbers


# -- LM bounds: the dry-run's counts and the roofline ----------------------

# Each LM step's count by the dry-run (meta tensors: nothing allocated),
# by label; phases 4g-4i read their bounds from it and phase 4j holds it
# against the same step counted on the card.
META_COUNTS: dict = {}


def meta_count(label: str, cfg, shape):
    """The dry-run's ``OpCounter`` counts of one step of ``cfg`` at
    ``shape`` on meta tensors, once a label."""
    from repro_torch.launch import dryrun

    if label not in META_COUNTS:
        t0 = time.perf_counter()
        counts = dryrun.count_cell(dryrun.build_cell(
            cfg.name, label, cfg=cfg, shape=shape))
        META_COUNTS[label] = {"counts": counts,
                              "seconds": time.perf_counter() - t0}
    return META_COUNTS[label]["counts"]


def decode_label(cfg, B: int, alloc: int) -> str:
    return f"{cfg.name} {cfg.n_layers} layers decode B {B} over {alloc}"


def roofline_bound(counts, least: dict) -> dict:
    """The roofline's bound of one step: the larger of its counted FLOPs
    at their dtypes' peaks and its least bytes at the HBM rate."""
    from repro_torch.launch import roofline

    t = roofline.terms(counts.flops, least["total"])
    return {"ms": t["bound_s"] * 1e3, "compute_ms": t["compute_s"] * 1e3,
            "memory_ms": t["memory_s"] * 1e3,
            "bound_by": "bytes" if t["bottleneck"] == "memory"
            else "operations",
            "flops_by_dtype": counts.flops, "least_bytes": least}


def decode_bound(model, cache: dict, tok, S: int, alloc: int,
                 experts_read=None) -> dict:
    """A decode step's bound at ``tok``'s batch and position ``S`` over
    a cache of ``alloc``: FLOPs from the dry-run of the same step, least
    bytes from the live model and cache (``roofline.least_bytes``: the
    parameters as the serving copy holds them, the ``S + 1`` valid cache
    positions; ``experts_read`` the experts each MoE layer's tokens
    chose)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import roofline

    cfg = model.cfg
    B = tok.shape[0]
    counts = meta_count(decode_label(cfg, B, alloc), cfg,
                        ShapeSpec("decode", alloc, B, "decode"))
    least = roofline.least_bytes("decode", model, {"tokens": tok},
                                 cache=cache, cur_index=S,
                                 experts_read=experts_read)
    return roofline_bound(counts, least)


def bound_text(b: dict) -> str:
    return (f"{b['ms']:.4f} ms by {b['bound_by']} (compute "
            f"{b['compute_ms']:.4f}, memory {b['memory_ms']:.4f})")


# -- phase 4k: one device per shard (the reference's mesh) -----------------

# Shards (and Step-2 LPT bins) of the phase, and the examples it runs
# once each on the card: (file, argv, the kernels that must launch).
P4K_SHARDS = 4
P4K_BUILD = ("ml1M", 1.0, 0, 30)  # phase 4's build: dataset, scale, seed, k
P4K_EXAMPLES = (
    ("quickstart_torch", [], ("goldfinger_knn", "frh_minhash_distinct")),
    ("knn_recommend_torch", ["--kernel"],
     ("goldfinger_knn", "descent_hop", "frh_minhash_distinct")),
    ("serve_demo_torch", [], ()),
    ("train_lm_torch", ["--steps", "20"], ("frh_minhash",)),
    ("distributed_knn_torch", [], ("goldfinger_knn",
                                   "frh_minhash_distinct")),
)


def shard_devices(n: int) -> list:
    """Entry i of an ``n``-entry device list: ``cuda:i mod the cards
    present``, so one card runs every entry and n cards place them truly."""
    import torch

    return [torch.device("cuda", i % torch.cuda.device_count())
            for i in range(n)]


def distributed_build(run: dict, devices: list) -> dict:
    """(i) ``distributed_c2`` of ml1M@1.0 (``params_for("ml1M", k=30)``)
    over ``devices``, one LPT bin each: ids and sims bitwise phase 4's
    single-card build; the LPT imbalance and each bin's cluster-KNN
    launches (every cluster brute-forced: none reaches ρk² here)."""
    import numpy as np

    from repro_torch.core import distributed
    from repro_torch.core.params import params_for
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.goldfinger_knn import ops as gk_ops

    name, scale, seed, k = P4K_BUILD
    ds = make_dataset(name, scale=scale, seed=seed)
    params = params_for(name, k=k)
    per_bin = [0] * len(devices)
    calls = [0]
    plain = gk_ops.cluster_knn

    def counted(words, card, ids, k):
        # distributed_local_knn calls bin by bin within each group.
        before = gk_ops.launches
        out = plain(words, card, ids, k)
        per_bin[calls[0] % len(devices)] += gk_ops.launches - before
        calls[0] += 1
        return out

    reset_launches()
    gk_ops.cluster_knn = counted
    try:
        t0 = time.perf_counter()
        graph, stats = distributed.distributed_c2(ds, params, devices)
        seconds = time.perf_counter() - t0
    finally:
        gk_ops.cluster_knn = plain
    counts = read_launches()
    ref = run["built"]["graph"]
    if not (np.array_equal(graph.ids, ref.ids)
            and np.array_equal(graph.sims, ref.sims)):
        bad = int((~((graph.ids == ref.ids)
                     & (graph.sims == ref.sims)).all(1)).sum())
        fail(f"distributed_c2 over {len(devices)} bins differs from phase "
             f"4's build in {bad} rows")
    if (sum(per_bin) != counts["goldfinger_knn"] or min(per_bin) < 1
            or counts["frh_minhash_distinct"] != 1
            or any(v for k, v in counts.items()
                   if k not in ("goldfinger_knn", "frh_minhash_distinct"))):
        fail(f"distributed_c2 launched {counts}, per bin {per_bin}")
    if int((params.bf_threshold <= run["built"]["plan"].sizes).sum()):
        fail(f"a cluster of {name}@{scale} reaches rho k^2: the single-card "
             f"build took Hyrec where the bins brute-force")
    log(f"[mesh] (i) distributed_c2 of {name}@{scale} (k={k}) over "
        f"{[str(d) for d in devices]}: {stats['n_clusters']} clusters, "
        f"{stats['n_sims']} sims, LPT imbalance "
        f"{stats['lpt_imbalance']:.4f}, cluster-KNN launches per bin "
        f"{per_bin}; ids and sims bitwise phase 4's single-card build; "
        f"{seconds:.2f} s (cluster {stats['t_cluster']:.3f}, Step 2 "
        f"{stats['t_local']:.3f}, merge {stats['t_merge']:.3f})")
    return {"launches": counts["goldfinger_knn"], "per_bin": per_bin,
            "imbalance": stats["lpt_imbalance"], "seconds": seconds}


def qe_serve(ctx, qc, shard_devices=None):
    """The 2,048 profiles through ``QueryEngine`` at ``--shards 4`` after
    a one-request warm-up (as ``knn_serve`` warms up), the launches counted
    from 0 just before the timed serve: (engine, stats, launches)."""
    from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest
    from repro_torch.query.index import KNNIndex

    engine = QueryEngine(
        KNNIndex.load(ctx["index_path"]),
        QueryConfig(**{**SERVE_QC, "shards": P4K_SHARDS, **qc}),
        device=ctx["devices"][0], shard_devices=shard_devices)
    engine.submit(QueryRequest(rid=-1, profile=ctx["profiles"][0]))
    engine.run()
    engine.done.clear()
    reset_launches()
    for i, p in enumerate(ctx["profiles"]):
        engine.submit(QueryRequest(rid=i, profile=p))
    stats = engine.run()
    return engine, stats, read_launches()


def per_device_serve(ctx, label, kernel, qc) -> object:
    """(ii) The 2,048 profiles at ``--shards 4`` with one device per shard
    (one hop launch a shard, through the sharded entry alone), rid by rid
    bitwise phase 4c's one-launch serve; in turns with the stacked layout
    through the same ``QueryEngine`` path (stacked, per-device, per-device,
    stacked) for their QPS side by side."""
    qps = {"stacked": [], "per-device": []}
    engine = None
    for layout in ("stacked", "per-device", "per-device", "stacked"):
        # One device stacks the shards, whatever the cards present.
        devs = ctx["devices"] if layout == "per-device" \
            else ctx["devices"][:1]
        eng, stats, counts = qe_serve(ctx, qc, devs)
        sd = eng.sharded_state()
        if sd.layout != layout:
            fail(f"{label}: layout {sd.layout}, expected {layout}")
        check_sharded_launches(f"{label} ({layout})", counts, kernel)
        same_results(by_rid(eng), ctx["healthy"], f"{label} ({layout})",
                     "phase 4c's one-launch --shards 4 serve")
        qps[layout].append(stats["qps"])
        if layout == "per-device" and engine is None:
            engine = eng
            ctx["launches"][label] = counts
            if len(sd.tables.parts) != P4K_SHARDS:
                fail(f"{label}: {len(sd.tables.parts)} parts")
            log(f"[mesh] (ii) {label}: {stats['requests']} served in "
                f"{stats['waves']} steps, p95 "
                f"{stats['p95_latency_s'] * 1e3:.2f} ms; launches {counts}; "
                f"{sharded_line(eng)}; rid by rid bitwise phase 4c's "
                f"one-launch serve")
    ctx["numbers"][label] = qps
    log(f"[mesh] (ii) {label} QPS in turns: stacked "
        f"{qps['stacked'][0]:.1f}, per-device {qps['per-device'][0]:.1f}, "
        f"{qps['per-device'][1]:.1f}, stacked {qps['stacked'][1]:.1f} "
        f"(both layouts through QueryEngine after a warm-up request)")
    return engine


def per_device_swap(ctx, engine) -> dict:
    """(iii) A forced re-balance swap of the per-device engine (rebuilt
    from the host index): the tables after it a fresh build's, its merge
    audit printed, a re-serve still phase 4c's answers."""
    sync = device_sync(ctx["devices"][0])
    sync()
    t0 = time.perf_counter()
    engine.rebalance.swap()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    check_fresh_shard_tables(engine, "(iii) per-device swap")
    stats = dict(engine.rebalance.merge_stats)
    if stats.get("rows") != engine.index.n or \
            engine.sharded_state().generation != 1:
        fail(f"(iii) per-device swap: merge stats {stats}")
    reserve(engine, ctx["profiles"], "(iii) per-device swap", ctx["healthy"])
    log(f"[mesh] (iii) forced swap: "
        f"{ms:.1f} ms host clock, merge audit {stats}; tables equal a "
        f"fresh ShardedDescent; re-serve bitwise phase 4c's")
    return {"merge": stats, "swap_ms": ms}


def per_device_kill(ctx) -> dict:
    """(iv) ``kill:1@2`` in waves of 64 x fused hop with one device per
    shard: rid by rid and in fault stats phase 4e's stacked run; the
    tables after the failover a fresh build's."""
    label = "per-device kill wave x pallas"
    engine, stats, steps, swaps = serve4e(
        ctx, label, FUSED, dict(kernel=True), P4E["kill"], ctx["profiles"],
        shard_devices=ctx["devices"])
    base, f_base = ctx["kill_results"]["kill wave x pallas"]
    f = stats["faults"]
    same_results(by_rid(engine), base, label, "phase 4e's kill wave x pallas")
    if f != f_base:
        fail(f"{label}: fault stats {f} != phase 4e's {f_base}")
    check_fresh_shard_tables(engine, label)
    log(f"[mesh] (iv) {label}: {stats['requests']} served, faults {f}, "
        f"failover host ms {[round(x, 3) for x in swaps]}; launches "
        f"{ctx['launches'][label]}; rid by rid and in fault stats phase "
        f"4e's stacked run; tables after the failover a fresh build's")
    return {"faults": f, "failover_ms": swaps}


def cards_ms(fn, devices, reps: int = 7, inner: int = 20) -> float:
    """Median host ms of one ``fn()`` from its first launch to the last
    card's end (``inner`` calls, then every card synchronised): the time
    of launches spread over several cards, which one card's events do
    not span."""
    import torch

    def sync():
        for d in sorted(set(devices), key=str):
            torch.cuda.synchronize(d)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def per_device_hops(ctx, engine) -> dict:
    """(v) One 4-shard x 256-query hop of each kernel as 4 launches, one a
    shard (the per-device layout's: the sharded entry at S = 1 on each
    shard's device), beside the one launch for all shards, in turns in
    one run, device time with a sleep kernel holding the card (on
    several cards: host clock to the last card's end); bitwise the one
    launch's outputs."""
    import torch

    args, _, _ = first_sharded_hop(engine, P4K_SHARDS, 32, 256)
    parts = []
    for s, dev in enumerate(ctx["devices"]):
        a = [t[s:s + 1] for t in args[:4]] + list(args[4:6]) \
            + [t[s:s + 1] for t in args[6:]]
        parts.append(tuple(x.to(dev) for x in a))
    out = {}
    for name, dma in ((FUSED, False), (DMA, True)):
        one = sharded_kernel(args, dma)
        per = [sharded_kernel(p, dma) for p in parts]
        joined = tuple(torch.cat([o[i].to(one[i].device) for o in per])
                       for i in range(len(one)))
        if not all(torch.equal(a, b) for a, b in zip(one, joined)):
            fail(f"(v) {name}: 4 per-shard launches differ from one launch")
        ms = {"one_launch": [], "per_device": []}
        cards = len(set(ctx["devices"])) > 1
        for _ in range(2):
            ms["one_launch"].append(cuda_ms(lambda: sharded_kernel(args, dma),
                                            reps=7, inner=20, hold=True))
            every = lambda: [sharded_kernel(p, dma) for p in parts]  # noqa: E731
            ms["per_device"].append(cards_ms(every, ctx["devices"]) if cards
                                    else cuda_ms(every, reps=7, inner=20,
                                                 hold=True))
        out[name] = {k: statistics.median(v) for k, v in ms.items()}
        log(f"[mesh] (v) {name}, 4 shards x 256 queries (shard beam "
            f"{args[6].shape[-1]}): one launch {ms['one_launch'][0]:.4f} / "
            f"{ms['one_launch'][1]:.4f} ms, 4 per-device launches "
            f"{ms['per_device'][0]:.4f} / {ms['per_device'][1]:.4f} ms "
            f"{'host clock to the last card' if cards else 'device time'} "
            f"on {sorted({str(d) for d in ctx['devices']})}; bitwise equal "
            f"outputs")
    return out


def example_runs(ctx) -> dict:
    """(vi) Each ``examples/*_torch.py`` once on the card, its launches
    from 0."""
    import importlib.util

    out = {}
    for name, argv, kernels in P4K_EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_launches()
        t0 = time.perf_counter()
        res = mod.main(argv)
        seconds = time.perf_counter() - t0
        counts = read_launches()
        missing = [k for k in kernels if counts[k] <= 0]
        others = [k for k in ("goldfinger_knn", "descent_hop",
                              "descent_hop_dma", "frh_minhash",
                              "frh_minhash_distinct")
                  if k not in kernels and counts[k]]
        if missing or others:
            fail(f"(vi) {name} {argv}: launches {counts}")
        short = {k: v for k, v in res.items()
                 if isinstance(v, (int, float, bool))}
        out[name] = {"launches": counts, "seconds": seconds, **short}
        log(f"[mesh] (vi) examples/{name}.py {' '.join(argv)}: "
            f"{seconds:.1f} s, launches {counts}, {short}")
    if out["train_lm_torch"]["launches"]["frh_minhash"] != 1:
        fail("(vi) train_lm_torch launched FastRandomHash "
             f"{out['train_lm_torch']['launches']['frh_minhash']} times")
    return out


def one_device_per_shard(dev, run: dict, shard: dict, faults: dict) -> dict:
    """Phase 4k: the per-device layout of C² (distributed Step 2, serving
    with one device per shard, the swap and failover, the hop as one
    launch per shard) and the examples."""
    t0 = time.perf_counter()
    devices = shard_devices(P4K_SHARDS)
    qds = main_queries()
    ctx = {"dev": devices[0], "devices": devices,
           "index_path": run["index_path"], "launches": {}, "numbers": {},
           "healthy": by_rid(shard["engine"]),
           "healthy_engine": shard["engine"],
           "kill_results": faults["kill_results"],
           "profiles": [qds.profile(u) for u in range(P4D["queries"])]}
    out = {"devices": [str(d) for d in devices],
           "build": distributed_build(run, devices)}
    wave = per_device_serve(ctx, "per-device --shards 4 wave x pallas",
                            FUSED, dict(kernel=True))
    per_device_serve(ctx, "per-device --shards 4 continuous x pallas_dma",
                     DMA, dict(continuous=True, kernel=True, dma=True))
    out["swap"] = per_device_swap(ctx, wave)
    out["kill"] = per_device_kill(ctx)
    out["hops"] = per_device_hops(ctx, wave)
    out["examples"] = example_runs(ctx)
    out["launches"] = ctx["launches"]
    out["qps"] = ctx["numbers"]
    out["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase 4k: {out['seconds']:.1f} s")
    return out


def mesh_alone() -> dict:
    """Phase 4k with only what it reads from the earlier phases (the
    kernels built, phase 4's main path, phase 4c's ``--shards`` serves,
    phase 4e's kill wave x fused hop), on every card present: phases 4c
    and 4e stay stacked on the first card (the default layout), and phase
    4k's per-device serves, one card per shard when there are S cards, are
    held to them. Run through the
    tool as ``PYTHONPATH=src python3 -c "import chip_smoke as c;
    c.mesh_alone()"`` (``--chips 4`` places the four shards on four
    cards)."""
    import torch

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60).stdout.strip())
    build.build()
    log(f"[mesh] {torch.cuda.device_count()} cards; kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    made: dict = {}
    with datasets_made_once(made), tempfile.TemporaryDirectory() as tmp:
        run = main_path(dev, Path(tmp))
        shard = sharded_serves(run["serve_args"])
        qds = main_queries()
        ctx = {"dev": dev, "index_path": run["index_path"], "launches": {},
               "numbers": {}, "kill_results": {},
               "profiles": [qds.profile(u) for u in range(P4D["queries"])]}
        label = "kill wave x pallas"
        engine, stats, _, _ = serve4e(ctx, label, FUSED, dict(kernel=True),
                                      P4E["kill"], ctx["profiles"])
        log(f"[mesh] phase 4c's and 4e's layouts: "
            f"{shard['engine'].sharded_state().layout}, "
            f"{engine.sharded_state().layout}")
        mesh = one_device_per_shard(
            dev, run, shard,
            {"kill_results": {label: (by_rid(engine), stats["faults"])}})
    log(f"[mesh] alone: {time.perf_counter() - t0:.1f} s")
    return mesh


# -- phase 4g: LM serving (the dense family) -------------------------------

# Phase 4g's full-width serve: Llama-3.2-1B's published config (16 layers,
# d 2048, vocab 128,256, bf16 compute, f32 parameters), seed 0 on the card.
LM_SERVE_ARGV = ["--arch", "llama3.2-1b", "--requests", "32",
                 "--max-batch", "8", "--max-prompt", "512", "--max-new", "64",
                 "--seed", "0"]
# Card against the port's CPU path at f32 compute: logits of order 1 within
# 1e-4 absolute (cuBLAS and the CPU's BLAS sum in other orders; no TF32).
# bf16 logits within the reference's own bf16 bound (test_arch_smoke.py:96).
LM_F32_TOL = 1e-4
LM_BF16_TOL = 0.15
# A greedy token may differ only where the reference side's top-2 logit
# margin is under twice the tolerance (each side may move by it).


def watch_logits(engine) -> "torch.Tensor":
    """Wrap the engine's prefill and decode so the last-position logits
    ([B, V]) of every call are checked; returns the card-side count of non-finite
    values (read once, after the serve)."""
    import torch

    bad = torch.zeros((), dtype=torch.int64, device=engine.device)
    # The wrappers reach the engine through a weak reference: one to its
    # bound method would tie it into a reference cycle, and its model
    # would outlive the caller's last reference until the garbage
    # collector ran.
    ref = weakref.ref(engine)

    def wrap(name):
        method = getattr(type(engine), name)

        def call(*args):
            logits, cache = method(ref(), *args)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return call

    engine._prefill = wrap("_prefill")
    engine._decode = wrap("_decode")
    return bad


def lm_full_serves() -> dict:
    """(a) Full-width Llama-3.2-1B through ``launch/serve``: 32 requests in
    waves of 8, then the same requests through 8 continuous slots. Every
    request completes with its own budget (2-64 tokens), every logit the
    engine reads is finite, and no C² kernel launches."""
    import torch

    from repro_torch.launch import serve as serve_cli

    out = {}
    for label, extra in (("wave", []),
                         ("continuous", ["--continuous", "--slots", "8"])):
        torch.cuda.reset_peak_memory_stats()
        engine = serve_cli.build(LM_SERVE_ARGV + extra)
        if engine.device.type != "cuda":
            fail(f"LM {label} serve built on {engine.device}")
        bad = watch_logits(engine)
        budgets = {r.rid: r.max_new for r in engine.queue}
        reset_launches()
        t0 = time.perf_counter()
        stats = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        serve_cli.report(stats)
        done = {r.rid: r.output for r in engine.done}
        if sorted(done) != list(range(32)) or stats["completed"] != 32:
            fail(f"LM {label} serve completed {sorted(done)}")
        for rid, o in done.items():
            if not (1 <= len(o) <= 64 and len(o) == budgets[rid]
                    and (o >= 0).all() and (o < 128_256).all()):
                fail(f"LM {label} serve: request {rid} gave {o} "
                     f"(budget {budgets[rid]})")
        if int(bad):
            fail(f"LM {label} serve read {int(bad)} non-finite logits")
        if any(launches.values()):
            fail(f"LM {label} serve launched C² kernels: {launches}")
        out[label] = {key: stats[key] for key in (
            "requests", "waves", "tokens", "tokens_per_s", "decode_steps",
            "prefills", "mean_latency_s", "p95_latency_s")}
        out[label].update(wall_s=wall, outputs=done,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"[lm] {label}: {stats['tokens']} tokens, "
            f"{stats['tokens_per_s']:.1f} tok/s, {stats['decode_steps']} "
            f"decode steps, {stats['prefills']} prefills, {wall:.2f} s, "
            f"peak {out[label]['peak_gb']:.2f} GB")
        del engine
        torch.cuda.empty_cache()
    # Wave and continuous compute each row alike, but cuBLAS picks its
    # kernels by batch shape, so bf16 rounding may tip a near tie: counted,
    # not required.
    same = sum(bool(len(a) == len(out["continuous"]["outputs"][rid])
                    and (a == out["continuous"]["outputs"][rid]).all())
               for rid, a in out["wave"]["outputs"].items())
    for label in ("wave", "continuous"):
        out[label].pop("outputs")
    out["modes_equal_rids"] = same
    log(f"[lm] wave and continuous tokens equal in {same} of 32 requests "
        f"(bf16)")
    return out


def lm_decode_vs_forward(dev):
    """(b) Full width: prefill B = 4, S = 512, decode one token, against
    ``forward`` over 1,024 positions (the prompt, the token, then padding:
    causal, so position 512 sees only the first 513; a forward over 513
    would break the online softmax's 512-multiple rule). The reference
    test's check (test_arch_smoke.py:83-96) at its 0.15 bound. Returns the
    error and the serving model, reused by (d)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.steps import decode_step, prefill_step

    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(cfg, gen, dev).serving_copy()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 512)).astype(np.int32)).to(dev)
    _, cache = prefill_step(model, toks, s_alloc=514)
    lg, _ = decode_step(model, cache, toks[:, :1], 512)
    full = torch.zeros((4, 1024), dtype=torch.int32, device=dev)
    full[:, :512] = toks
    full[:, 512] = toks[:, 0]
    with torch.inference_mode():
        lf, _, _ = model(tokens=full)
    err = float((lg[:, 0] - lf[:, 512]).abs().max())
    if not (err <= LM_BF16_TOL and torch.isfinite(lf).all()):
        fail(f"LM decode against forward at full width: {err}")
    log(f"[lm] decode against forward, B 4, S 512, full width: max abs "
        f"err {err:.5f} (bound {LM_BF16_TOL})")
    return err, model


def lm_margins(model, prompts, outs, max_prompt: int, max_new: int):
    """Top-2 logit margin at every generated step of each request, from one
    forward over its left-padded prompt and its tokens."""
    import numpy as np
    import torch

    seq = np.zeros((len(prompts), max_prompt + max_new), np.int32)
    for j, (p, o) in enumerate(zip(prompts, outs)):
        seq[j, max_prompt - len(p):max_prompt] = p
        seq[j, max_prompt:max_prompt + len(o) - 1] = o[:-1]
    with torch.inference_mode():
        logits, _, _ = model(
            tokens=torch.from_numpy(seq).to(model.device))
    top2 = torch.topk(logits[:, max_prompt - 1:], 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def lm_compared_steps(margins, ref_outs, got_outs, label: str) -> int:
    """Greedy steps equal rid by rid before any divergence; a divergence is
    allowed only where the reference side's margin is under 2 tolerances."""
    import numpy as np

    compared = 0
    for j, (ref, got) in enumerate(zip(ref_outs, got_outs)):
        n = min(len(ref), len(got))
        diff = np.flatnonzero(ref[:n] != got[:n])
        stop = int(diff[0]) if len(diff) else n
        if stop < max(len(ref), len(got)) and \
                not margins[j, stop] < 2 * LM_F32_TOL:
            fail(f"{label}: request {j} diverges at step {stop} with "
                 f"margin {margins[j, stop]}: {ref} vs {got}")
        compared += stop
    return compared


def lm_engine_tokens(cpu, card, label: str) -> dict:
    """The same requests through the CPU and the card engines, in waves of
    3 and through 3 continuous slots, at f32 compute: equal tokens rid by
    rid (the margin rule above), equal stats."""
    import numpy as np

    from repro_torch.serve.engine import Engine, Request, ServeConfig

    S, N = 16, 8
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cpu.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, S + 1, 6)]
    budgets = [8, 3, 6, 1, 5, 8]
    probe = Engine(cpu, ServeConfig(max_batch=6, max_prompt=S, max_new=N))
    for rid, p in enumerate(prompts):
        probe.submit(Request(rid=rid, prompt=p, max_new=2))
    probe.run()
    eos = {r.rid: int(r.output[1]) for r in probe.done if r.rid in (2, 5)}
    out = {}
    for mode, kw in (("wave", {}), ("continuous", {"continuous": True,
                                                   "slots": 3})):
        runs = []
        for model in (cpu, card):
            eng = Engine(model, ServeConfig(max_batch=3, max_prompt=S,
                                            max_new=N, **kw))
            for rid, (p, mn) in enumerate(zip(prompts, budgets)):
                eng.submit(Request(rid=rid, prompt=p, max_new=mn,
                                   eos_id=eos.get(rid, -1)))
            stats = eng.run()
            runs.append((stats, [r.output for r in sorted(
                eng.done, key=lambda r: r.rid)]))
        (cs, co), (gs, go) = runs
        margins = lm_margins(cpu, prompts, co, S, N)
        compared = lm_compared_steps(margins, co, go, f"{label} {mode}")
        keys = ("requests", "waves", "tokens", "decode_steps", "prefills")
        if compared != cs["tokens"] or any(cs[k] != gs[k] for k in keys):
            log(f"[lm] {label} {mode}: compared {compared} of "
                f"{cs['tokens']} tokens; stats cpu {cs} card {gs}")
        out[mode] = {"compared": compared, "tokens": cs["tokens"],
                     "min_margin": float(min(
                         margins[j, :len(o)].min() for j, o in enumerate(co)))}
    return out


def lm_card_vs_cpu(dev) -> dict:
    """(c) Llama-3.2-1B's and Gemma-2B's full widths at 2 layers, weights
    made on the CPU and copied to the card: prefill and decode logits and
    engine tokens at f32 compute; prefill logits at bf16, with
    ``allow_bf16_reduced_precision_reduction`` as set and flipped."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM, init_params
    from repro_torch.serve.steps import decode_step, prefill_step

    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("f32 products must run in full f32 on the card (TF32 is on)")
    out = {}
    for arch in ("llama3.2-1b", "gemma-2b"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  dtype="float32")
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        state = cpu.state_dict()
        card = LM(cfg, {k: v.to(dev) for k, v in state.items()})
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab_size, (3, 2, 1)).astype(np.int32)
        errs = []
        caches = []
        for model in (cpu, card):
            lg, cache = prefill_step(
                model, torch.from_numpy(toks).to(model.device), s_alloc=20)
            steps = [lg.cpu()]
            for i in range(3):
                lg, cache = decode_step(model, cache, torch.from_numpy(
                    nxt[i]).to(model.device), 16 + i)
                steps.append(lg.cpu())
            caches.append(steps)
        errs = [float((a - b).abs().max()) for a, b in zip(*caches)]
        scale = float(caches[0][0].abs().max())
        if not max(errs) <= LM_F32_TOL:
            fail(f"{arch} 2 layers: card against CPU logits at f32 {errs}")
        tokens = lm_engine_tokens(cpu, card, f"{arch} 2 layers")
        bf16 = {}
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        ref16, _, _ = LM(cfg16, state)(tokens=torch.from_numpy(toks))
        card16 = LM(cfg16, {k: v.to(dev) for k, v in state.items()})
        default = matmul.allow_bf16_reduced_precision_reduction
        for flag in (default, not default):
            matmul.allow_bf16_reduced_precision_reduction = flag
            with torch.inference_mode():
                lg16, _, _ = card16(
                    tokens=torch.from_numpy(toks).to(dev))
            bf16[str(flag)] = float((lg16.cpu() - ref16).abs().max())
        matmul.allow_bf16_reduced_precision_reduction = default
        if not max(bf16.values()) <= LM_BF16_TOL:
            fail(f"{arch} 2 layers: card against CPU logits at bf16 {bf16}")
        out[arch] = {"f32_prefill_err": errs[0], "f32_decode_err": errs[1:],
                     "logit_scale": scale, "tokens": tokens,
                     "bf16_err_by_reduced_precision_reduction": bf16,
                     "seconds": time.perf_counter() - t0}
        log(f"[lm] {arch} 2 layers, card against CPU: f32 prefill err "
            f"{errs[0]:.2e}, decode {max(errs[1:]):.2e} (logits up to "
            f"{scale:.2f}); tokens {tokens}; bf16 err {bf16}; "
            f"{out[arch]['seconds']:.1f} s")
        del cpu, card, card16, state
        torch.cuda.empty_cache()
    return out


def lm_device_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn``: a sleep of ~8 x
    ``SLEEP_CYCLES`` (~0.2 s) holds the card while the call is queued (an
    LM step queues hundreds of small kernels, longer than ``cuda_ms``'s
    hold)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(8 * SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lm_profile(fn, steps: int = 3) -> dict:
    """Device kernels of ``fn`` per call from ``torch.profiler``: their
    count, summed duration and the six longest by name (ms per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Device activity alone: a host-side record of every op (tens of
    # thousands in xLSTM's prefill) would cost more than the call itself.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"kernels": n / steps, "kernel_ms": sum(by_name.values()),
            "top": [[name[:80], ms] for name, ms in top]}


def lm_numbers(model, serves: dict) -> dict:
    """(d) Full-width Llama-3.2-1B: one 8 x 512 prefill and a decode step
    at batch 8 (scalar position) and at 8 slots (per-row positions), by
    CUDA events (device time held by a sleep kernel; host-paced beside
    it) and their device kernels by ``torch.profiler``, tokens/s of both
    serves, peak memory, and the decode step's bytes bound."""
    import numpy as np
    import torch

    from repro_torch.serve.steps import decode_step, prefill_step

    cfg = model.cfg
    dev = model.device
    B, S, alloc = 8, 512, 576
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    prefill_ms = lm_device_ms(
        lambda: prefill_step(model, toks, s_alloc=alloc), reps=5)
    _, cache = prefill_step(model, toks, s_alloc=alloc)
    tok = toks[:, -1:].contiguous()
    ccache = {name: {"k": sub["k"].clone(), "v": sub["v"].clone(),
                     "pos": sub["pos"][:, None, :].expand(
                         -1, B, -1).clone()}
              for name, sub in cache.items()}
    rows = torch.full((B,), S, dtype=torch.int32, device=dev)
    def wave():
        return decode_step(model, cache, tok, S)

    def slots():
        return decode_step(model, ccache, tok, rows)

    wave_ms, slots_ms = lm_device_ms(wave, 7), lm_device_ms(slots, 7)
    wave_paced = cuda_ms(wave, reps=7, inner=5)
    slots_paced = cuda_ms(slots, reps=7, inner=5)
    profiles = {"decode_batch8": lm_profile(wave),
                "decode_slots8": lm_profile(slots)}
    return {"prefill_8x512_ms": prefill_ms,
            "decode_batch8_ms": wave_ms, "decode_batch8_paced_ms": wave_paced,
            "decode_slots8_ms": slots_ms,
            "decode_slots8_paced_ms": slots_paced,
            "tokens_per_s": {label: serves[label]["tokens_per_s"]
                             for label in ("wave", "continuous")},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_bound": decode_bound(model, cache, tok, S, alloc),
            "param_count": cfg.param_count(), "profile": profiles}


def lm_serving(dev, smi: str) -> dict:
    """Phase 4g: the LM stack's serving path (dense family) on the card."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serves = lm_full_serves()
    err, model = lm_decode_vs_forward(dev)
    numbers = lm_numbers(model, serves)
    del model
    torch.cuda.empty_cache()
    card_cpu = lm_card_vs_cpu(dev)
    numbers.update(serves=serves, decode_vs_forward_err=err,
                   card_vs_cpu=card_cpu, card=smi,
                   allow_bf16_reduced_precision_reduction=(
                       torch.backends.cuda.matmul.
                       allow_bf16_reduced_precision_reduction),
                   seconds=time.perf_counter() - t0)
    log(f"[lm] prefill 8 x 512 {numbers['prefill_8x512_ms']:.3f} ms; "
        f"decode batch 8 {numbers['decode_batch8_ms']:.3f} ms "
        f"(paced {numbers['decode_batch8_paced_ms']:.3f}), 8 slots "
        f"{numbers['decode_slots8_ms']:.3f} ms (paced "
        f"{numbers['decode_slots8_paced_ms']:.3f}); bound "
        f"{bound_text(numbers['decode_bound'])}; "
        f"peak {numbers['peak_gb']:.2f} GB; {smi}")
    for label, prof in numbers["profile"].items():
        log(f"[lm] {label} profile: {prof['kernels']:.0f} kernels, "
            f"{prof['kernel_ms']:.3f} ms of them a step; longest "
            + "; ".join(f"{name} {ms:.3f}" for name, ms in prof["top"]))
    log(f"[lm] phase 4g: {numbers['seconds']:.1f} s")
    return numbers


# -- phase 4h: LM serving (the MoE and recurrent families) -----------------

# Phase 4h's full-width models: the published configs (``configs/*.py``),
# f32 parameters, bf16 compute, seed 0 on the card, served with phase 4g's
# flags.
PHASE_4H_ARCHS = ("olmoe-1b-7b", "recurrentgemma-2b", "xlstm-125m")
# Card against CPU at full widths and 2 layers: one layer of each of the
# model's block kinds (RecurrentGemma's own period is 13 layers, xLSTM's 6).
PHASE_4H_CUTS = {
    "olmoe-1b-7b": {},
    "recurrentgemma-2b": {"block_pattern": (("rglru", "mlp"),
                                            ("local_attn", "mlp"))},
    "xlstm-125m": {"block_pattern": (("mlstm",), ("slstm",))},
}
# An expert choice may differ between the card and the CPU only where the
# CPU side's k-th and (k+1)-th router probabilities lie this close: at
# f32, where the router's input differs by sums in other orders; at bf16,
# where it also rounds to bf16 at other places (one bf16 step of a
# normalised activation moves a router logit by ~2e-3 and a probability
# by ~1e-4, so a tenth of this bound).
ROUTER_TIE = {"float32": 1e-5, "bfloat16": 1e-3}


@contextlib.contextmanager
def record_moe(calls: list, logits: bool = False, prefill_only=False):
    """Wrap ``layers.apply_moe`` (the model calls it through the module):
    each call appends its ``gate_e`` (and router logits with ``logits``),
    cloned on the card; with ``prefill_only`` only calls over more than
    one position a row."""
    from repro_torch.models import layers as L

    apply = L.apply_moe

    def recorded(p, x, cfg, ctx=None):
        y, (lg, gate_e) = apply(p, x, cfg, ctx)
        if not prefill_only or x.shape[1] > 1:
            calls.append((lg.detach().clone() if logits else None,
                          gate_e.clone(), x.shape[0] * x.shape[1]))
        return y, (lg, gate_e)

    L.apply_moe = recorded
    try:
        yield calls
    finally:
        L.apply_moe = apply


def moe_drops(cfg, calls: list) -> list:
    """Dropped (token, expert) choices of each recorded call, computed
    from its ``gate_e`` and the capacity of its token count."""
    from repro_torch.models import layers as L

    return [int((~L.moe_kept(gate_e, L.moe_capacity(T, cfg),
                             cfg.n_experts)).sum())
            for _, gate_e, T in calls]


def phase4h_serves(arch: str):
    """(a)/(b) ``arch`` at its published width through ``launch/serve``'s
    own ``build`` and ``run``: 32 requests in waves of 8, then the same
    requests through 8 continuous slots. Every request completes with its
    budget, every logit the engine reads is finite, no C² kernel
    launches. Returns (figures, the continuous engine, whose serving
    model (d) times)."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import layers as L

    argv = ["--arch", arch] + LM_SERVE_ARGV[2:]
    out, outputs = {}, {}
    engine = None
    for label, extra in (("wave", []),
                         ("continuous", ["--continuous", "--slots", "8"])):
        engine = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = serve_cli.build(argv + extra)
        cfg = engine.cfg
        if engine.device.type != "cuda":
            fail(f"{arch} {label} serve built on {engine.device}")
        # The build holds the f32 parameters and the serving copy at once.
        build_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        bad = watch_logits(engine)
        budgets = {r.rid: r.max_new for r in engine.queue}
        calls: list = []
        reset_launches()
        t0 = time.perf_counter()
        with record_moe(calls, prefill_only=True):
            stats = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        serve_cli.report(stats)
        done = {r.rid: r.output for r in engine.done}
        if sorted(done) != list(range(32)) or stats["completed"] != 32:
            fail(f"{arch} {label} serve completed {sorted(done)}")
        for rid, o in done.items():
            if not (len(o) == budgets[rid] and (o >= 0).all()
                    and (o < cfg.vocab_size).all()):
                fail(f"{arch} {label} serve: request {rid} gave {o} "
                     f"(budget {budgets[rid]})")
        if int(bad):
            fail(f"{arch} {label} serve read {int(bad)} non-finite logits")
        if any(launches.values()):
            fail(f"{arch} {label} serve launched C² kernels: {launches}")
        out[label] = {key: stats[key] for key in (
            "requests", "waves", "tokens", "tokens_per_s", "decode_steps",
            "prefills", "mean_latency_s", "p95_latency_s")}
        out[label].update(wall_s=wall, build_peak_gb=build_gb,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if calls:
            # Capacity drops of each prefill, layer by layer (a wave's 8 x
            # 512 tokens; a slot's 1 x 512).
            drops = np.array(moe_drops(cfg, calls)).reshape(
                -1, cfg.n_layers)
            out[label]["prefill_drops_by_layer"] = {
                "first": drops[0].tolist(), "sum": drops.sum(0).tolist(),
                "choices_per_prefill": int(calls[0][2]
                                           * cfg.experts_per_token),
                "capacity": L.moe_capacity(calls[0][2], cfg)}
        outputs[label] = done
        prompts = {r.rid: r.prompt for r in engine.done}
        log(f"[lm4h] {arch} {label}: {stats['tokens']} tokens, "
            f"{stats['tokens_per_s']:.1f} tok/s, {stats['decode_steps']} "
            f"decode steps, {stats['prefills']} prefills, {wall:.2f} s, "
            f"peak {out[label]['peak_gb']:.2f} GB serving, "
            f"{build_gb:.2f} GB building")
    wave, cont = outputs["wave"], outputs["continuous"]
    diverged = {}
    for rid, a in wave.items():
        diff = np.flatnonzero(a != cont[rid])
        if len(diff):
            diverged[rid] = int(diff[0])
    out["modes_equal_rids"] = same = 32 - len(diverged)
    if cfg.n_experts:
        # The expert capacity follows each call's token count, so the two
        # modes may drop different tokens: counted, not required.
        log(f"[lm4h] {arch}: wave and continuous tokens equal in {same} of "
            f"32 requests (bf16; capacity depends on the batch)")
        for label in ("wave", "continuous"):
            d = out[label]["prefill_drops_by_layer"]
            log(f"[lm4h] {arch} {label} prefill capacity drops by layer "
                f"(capacity {d['capacity']}, {d['choices_per_prefill']} "
                f"choices a prefill): first {d['first']}, all prefills "
                f"{d['sum']}")
    else:
        # Both modes compute each row alike, but cuBLAS picks its kernels
        # by batch shape (a wave prefills 8 rows, a slot one), so bf16
        # rounds at other places: a request may change tokens only from a
        # step whose top-2 logit margin lies under 2 x LM_BF16_TOL.
        margins = mode_margins(engine.model, prompts, wave, diverged)
        wide = {rid: m for rid, m in margins.items()
                if not m < 2 * LM_BF16_TOL}
        if wide:
            fail(f"{arch}: wave and continuous tokens part away from a "
                 f"near tie (request: margin) {wide}")
        out["mode_divergence_margins"] = margins
        log(f"[lm4h] {arch}: wave and continuous tokens equal in {same} of "
            f"32 requests (bf16); the others part at top-2 margins "
            f"{sorted(round(m, 4) for m in margins.values())}")
    return out, engine


def mode_margins(model, prompts: dict, outs: dict, steps: dict) -> dict:
    """Top-2 logit margin, by request, at the step where its tokens part
    between the modes: one forward (rows batched) over the prompt
    left-padded to 512, the tokens before that step, then padding to
    1,024 (causal, so the padding does not reach the step; a multiple of
    the attention's 512-position blocks)."""
    import numpy as np
    import torch

    margins = {}
    rids = sorted(steps)
    # As many rows a forward as keep its f32 logits near 4 GB.
    rows = max(1, int(4e9 // (1024 * model.cfg.vocab_size * 4)))
    for i in range(0, len(rids), rows):
        part = rids[i:i + rows]
        seq = np.zeros((len(part), 1024), np.int32)
        for j, rid in enumerate(part):
            seq[j, 512 - len(prompts[rid]):512] = prompts[rid]
            seq[j, 512:512 + steps[rid]] = outs[rid][:steps[rid]]
        with torch.inference_mode():
            logits, _, _ = model(
                tokens=torch.from_numpy(seq).to(model.device))
        for j, rid in enumerate(part):
            top2 = torch.topk(logits[j, 511 + steps[rid]], 2).values
            margins[rid] = float(top2[0] - top2[1])
        del logits
    return margins


def phase4h_numbers(model, serves: dict) -> dict:
    """(d) One 8 x 512 prefill (CUDA events; its kernels by
    ``torch.profiler``), a decode step at batch 8 (scalar position) and at
    8 slots (per-row positions), held and host-paced, with its kernels a
    step; tokens/s of both serves; the decode step's bytes bound; for MoE
    also the least bytes, only the experts the step's tokens chose."""
    import numpy as np
    import torch

    from repro_torch.serve.steps import decode_step, prefill_step

    cfg = model.cfg
    dev = model.device
    B, S, alloc = 8, 512, 576
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    prefill = functools.partial(prefill_step, model, toks, s_alloc=alloc)
    prefill_ms = lm_device_ms(prefill, reps=2)
    prefill_prof = lm_profile(prefill, steps=1)
    logits, cache = prefill()
    # The same rows prefilled alone: how far bf16 rounding moves the last
    # position's logits when only the batch shape changes.
    alone = [float((prefill_step(model, toks[j:j + 1], s_alloc=alloc)[0][
        0, -1] - logits[j, -1]).abs().max()) for j in range(2)]
    del logits
    tok = toks[:, -1:].contiguous()
    ccache = {name: {key: (leaf[:, None, :].expand(-1, B, -1).clone()
                           if key == "pos" else leaf.clone())
                     for key, leaf in sub.items()}
              for name, sub in cache.items()}
    rows = torch.full((B,), S, dtype=torch.int32, device=dev)

    def wave():
        return decode_step(model, cache, tok, S)

    def slots():
        return decode_step(model, ccache, tok, rows)

    out = {"prefill_8x512_ms": prefill_ms, "prefill_profile": prefill_prof,
           "prefill_batch8_vs_alone_logit_diff": alone,
           "decode_batch8_ms": lm_device_ms(wave, 5),
           "decode_slots8_ms": lm_device_ms(slots, 5),
           "decode_batch8_paced_ms": cuda_ms(wave, reps=5, inner=3),
           "decode_slots8_paced_ms": cuda_ms(slots, reps=5, inner=3),
           "profile": {"decode_batch8": lm_profile(wave),
                       "decode_slots8": lm_profile(slots)},
           "tokens_per_s": {label: serves[label]["tokens_per_s"]
                            for label in ("wave", "continuous")},
           "peak_gb": max(serves[label]["peak_gb"]
                          for label in ("wave", "continuous")),
           "build_peak_gb": serves["wave"]["build_peak_gb"],
           "param_count": cfg.param_count()}
    out["decode_bound"] = decode_bound(model, cache, tok, S, alloc)
    if cfg.n_experts:
        calls: list = []
        with record_moe(calls):
            wave()
        distinct = [int(gate_e.unique().numel()) for _, gate_e, _ in calls]
        out["decode_distinct_experts_by_layer"] = distinct
        out["decode_bound_chosen_experts"] = decode_bound(
            model, cache, tok, S, alloc, experts_read=distinct)
    return out


def phase4h_card_vs_cpu(dev, arch: str) -> dict:
    """(c) ``arch``'s full widths at 2 layers, weights made on the CPU and
    copied to the card: prefill and 3 decode steps at f32 compute (logits
    within ``LM_F32_TOL``; for MoE the expert choices compared first, a
    differing choice allowed only at a router near tie and the logits
    held while every choice agrees), engine tokens rid by rid per mode
    (phase 4g's near-tie rule), prefill logits at bf16."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM, init_params
    from repro_torch.serve.steps import decode_step, prefill_step

    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("f32 products must run in full f32 on the card (TF32 is on)")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              **PHASE_4H_CUTS[arch])
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = cpu.state_dict()
    card = LM(cfg, {k: v.to(dev) for k, v in state.items()})
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (3, 2, 1)).astype(np.int32)
    runs = []
    for model in (cpu, card):
        calls: list = []
        with record_moe(calls, logits=True):
            lg, cache = prefill_step(
                model, torch.from_numpy(toks).to(model.device), s_alloc=20)
            steps = [lg.cpu()]
            for i in range(3):
                lg, cache = decode_step(model, cache, torch.from_numpy(
                    nxt[i]).to(model.device), 16 + i)
                steps.append(lg.cpu())
        runs.append((steps, calls))
    (cpu_steps, cpu_calls), (card_steps, card_calls) = runs
    errs = [float((a - b).abs().max()) for a, b in zip(cpu_steps, card_steps)]
    out = {"f32_prefill_err": errs[0], "f32_decode_err": errs[1:],
           "logit_scale": float(cpu_steps[0].abs().max())}
    held = len(errs)
    if cfg.n_experts:
        agree, total, first_bad = routing_agreement(
            cfg, cpu_calls, card_calls, f"{arch} 2 layers at f32")
        if first_bad is not None:
            held = first_bad
        out["expert_choices_agree"] = [agree, total]
    if not max(errs[:held], default=0.0) <= LM_F32_TOL:
        fail(f"{arch} 2 layers: card against CPU logits at f32 {errs}")
    out["f32_steps_held"] = held
    out["tokens"] = lm_engine_tokens(cpu, card, f"{arch} 2 layers")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    runs16 = []
    for model in (LM(cfg16, state),
                  LM(cfg16, {k: v.to(dev) for k, v in state.items()})):
        calls = []
        with torch.inference_mode(), record_moe(calls, logits=True):
            lg16, _, _ = model(
                tokens=torch.from_numpy(toks).to(model.device))
        runs16.append((lg16.cpu(), calls))
    (ref16, cpu_calls), (lg16, card_calls) = runs16
    out["bf16_prefill_err"] = float((lg16 - ref16).abs().max())
    bf16_held = True
    if cfg.n_experts:
        agree, total, first_bad = routing_agreement(
            cfg16, cpu_calls, card_calls, f"{arch} 2 layers at bf16")
        out["bf16_expert_choices_agree"] = [agree, total]
        bf16_held = first_bad is None
    if bf16_held and not out["bf16_prefill_err"] <= LM_BF16_TOL:
        fail(f"{arch} 2 layers: card against CPU logits at bf16 "
             f"{out['bf16_prefill_err']}")
    out["bf16_held"] = bf16_held
    out["seconds"] = time.perf_counter() - t0
    log(f"[lm4h] {arch} 2 layers, card against CPU: f32 prefill err "
        f"{errs[0]:.2e}, decode {max(errs[1:]):.2e} (logits up to "
        f"{out['logit_scale']:.2f}; {held} of 4 steps held); tokens "
        f"{out['tokens']}; bf16 err {out['bf16_prefill_err']:.4f} "
        f"({'held' if bf16_held else 'not held: routing differs'}); "
        f"{out['seconds']:.1f} s")
    return out


def routing_agreement(cfg, cpu_calls: list, card_calls: list, label: str):
    """(token, layer) expert choices of the CPU and the card, call by
    call (layer by layer, step by step). A differing choice fails unless
    the CPU side's k-th and (k+1)-th router probabilities lie within
    ``ROUTER_TIE``. Returns (agreeing, compared, the first step with a
    difference or None)."""
    import torch

    k = cfg.experts_per_token
    agree = total = 0
    first_bad = None
    widest = 0.0
    for j, ((lg_c, ge_c, _), (_, ge_g, _)) in enumerate(
            zip(cpu_calls, card_calls, strict=True)):
        ge_c, ge_g = ge_c.cpu(), ge_g.cpu()
        same = (ge_c.sort(1).values == ge_g.sort(1).values).all(1)
        agree += int(same.sum())
        total += same.numel()
        if not same.all():
            probs = torch.softmax(lg_c.float(), dim=-1).sort(
                dim=-1, descending=True).values
            margin = (probs[:, k - 1] - probs[:, k])[~same]
            widest = max(widest, float(margin.max()))
            if not (margin < ROUTER_TIE[cfg.dtype]).all():
                fail(f"{label}: card and CPU choose other experts away "
                     f"from a router tie (margins {margin.tolist()})")
            if first_bad is None:
                first_bad = j // cfg.n_layers
    log(f"[lm4h] {label}: {agree} of {total} (token, layer) expert choices "
        f"agree, card against CPU"
        + (f" (widest margin where they differ {widest:.2e})"
           if agree < total else ""))
    return agree, total, first_bad


def lm_moe_recurrent(dev, smi: str) -> dict:
    """Phase 4h: the LM stack's serving path for the MoE and recurrent
    families on the card, one model at a time (each freed before the
    next loads)."""
    import torch

    t0 = time.perf_counter()
    reset_launches()
    out = {}
    for arch in PHASE_4H_ARCHS:
        ta = time.perf_counter()
        torch.cuda.empty_cache()
        serves, engine = phase4h_serves(arch)
        numbers = phase4h_numbers(engine.model, serves)
        numbers["serves"] = serves
        del engine
        torch.cuda.empty_cache()
        numbers["card_vs_cpu"] = phase4h_card_vs_cpu(dev, arch)
        numbers["seconds"] = time.perf_counter() - ta
        out[arch] = numbers
        bounds = bound_text(numbers["decode_bound"])
        if "decode_bound_chosen_experts" in numbers:
            bounds = (f"{bounds} with every expert read, " + bound_text(
                numbers["decode_bound_chosen_experts"])
                + " with the chosen experts")
        log(f"[lm4h] {arch}: prefill 8 x 512 "
            f"{numbers['prefill_8x512_ms']:.3f} ms "
            f"({numbers['prefill_profile']['kernels']:.0f} kernels, "
            f"{numbers['prefill_profile']['kernel_ms']:.3f} ms of them); "
            f"decode batch 8 {numbers['decode_batch8_ms']:.3f} ms (paced "
            f"{numbers['decode_batch8_paced_ms']:.3f}), 8 slots "
            f"{numbers['decode_slots8_ms']:.3f} ms (paced "
            f"{numbers['decode_slots8_paced_ms']:.3f}); bound {bounds}"
            + f"; peak {numbers['peak_gb']:.2f} GB serving, "
            f"{numbers['build_peak_gb']:.2f} GB building; {smi}")
        log(f"[lm4h] {arch}: last-position logits of a row prefilled in "
            f"the batch of 8 and alone differ by "
            f"{numbers['prefill_batch8_vs_alone_logit_diff']} (bf16)")
        if "decode_distinct_experts_by_layer" in numbers:
            log(f"[lm4h] {arch}: distinct experts a decode step chose, by "
                f"layer: {numbers['decode_distinct_experts_by_layer']}")
        for label, prof in numbers["profile"].items():
            log(f"[lm4h] {arch} {label} profile: {prof['kernels']:.0f} "
                f"kernels, {prof['kernel_ms']:.3f} ms of them a step; "
                "longest " + "; ".join(f"{name} {ms:.3f}"
                                       for name, ms in prof["top"]))
        log(f"[lm4h] {arch}: {numbers['seconds']:.1f} s")
    launches = read_launches()
    if any(launches.values()):
        fail(f"phase 4h launched C² kernels: {launches}")
    out.update(c2_launches=launches, card=smi,
               seconds=time.perf_counter() - t0)
    log(f"[lm4h] phase 4h: {out['seconds']:.1f} s; C² launches {launches}")
    return out


# -- phase 4i: LM training ------------------------------------------------

# Card against CPU: one train step at full published widths and 2 layers
# (one layer of each block kind, PHASE_4H_CUTS), f32 compute, B 2 x S 32.
PHASE_4I_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "recurrentgemma-2b",
                  "xlstm-125m")
# At f32: loss, ce and the gradient norm within 1e-5 relative, the aux
# loss within 1e-4 of its value (read from loss − ce, which cancels ~10
# of 11 digits' weight), m and v within 1e-4 and 2e-4 of a leaf's largest
# entry (m = 0.1·clip·g, v = 0.05·(clip·g)²: the gradients' sums run in
# other orders, over ~1,000x more terms than the CPU tests' widths); the
# new parameters within 1e-6 where the CPU's |m| >= 1e-7 (|g| >= ~1e-6:
# an AdamW first step g/(|g| + 1e-8) moves by under lr·1e-3 there), and
# elsewhere within the step's range, 2·lr·(1 + wd·|p|): a gradient within
# ~100 eps of 0 moves its parameter by a step its last bits decide.
TRAIN_F32_REL = 1e-5
TRAIN_AUX_REL = 1e-4
TRAIN_M_REL, TRAIN_V_REL = 1e-4, 2e-4
TRAIN_PARAM_TOL, TRAIN_M_FLOOR = 1e-6, 1e-7
# At bf16 compute the loss only: bf16 products round at other places on
# the card and the CPU (phase 4g's bf16 logits differ by up to ~0.035).
TRAIN_BF16_REL = 1e-3
# The restart contract of the reference's test (tests/test_infra.py).
RESTART_TOL = 1e-4
FULL_TRAIN_ARGV = ["--arch", "llama3.2-1b", "--batch", "8", "--seq", "512",
                   "--steps", "8", "--data-order", "c2", "--device", "cuda"]


def train_once(model, toks, labels, oc, calls=None):
    """One ``train_step`` of ``model`` (its own fresh AdamW state) on
    ``toks`` and ``labels``; returns (metrics on the host, opt_state)."""
    import torch

    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import train_step

    opt = init_opt_state(dict(model.named_parameters()), oc)
    batch = {"tokens": torch.from_numpy(toks).to(model.device),
             "labels": torch.from_numpy(labels).to(model.device)}
    with record_moe(calls if calls is not None else [], logits=True):
        _, _, m = train_step(model, opt, batch, oc)
    return {k: float(v) for k, v in m.items()}, opt


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare_train_state(card, cpu, card_opt, cpu_opt, oc) -> dict:
    """Leaf by leaf, the card's new parameters and moments against the
    CPU's (see TRAIN_*), each CPU leaf copied to the card for the
    comparison; returns the largest differences."""
    dev = card.device
    worst = {"m_rel": 0.0, "v_rel": 0.0, "param_live": 0.0,
             "param_off_floor": 0.0, "off_floor_entries": 0}
    card_sd, cpu_sd = card.state_dict(), cpu.state_dict()
    for k, ref_cpu in cpu_sd.items():
        m_ref = cpu_opt["m"][k].to(dev).float()
        for key, r in (("m", m_ref), ("v", cpu_opt["v"][k].to(dev).float())):
            d = float((card_opt[key][k].float() - r).abs().max())
            worst[f"{key}_rel"] = max(worst[f"{key}_rel"],
                                      d / max(float(r.abs().max()), 1e-30))
        ref = ref_cpu.to(dev).float()
        diff = (card_sd[k].float() - ref).abs()
        live = m_ref.abs() >= TRAIN_M_FLOOR
        worst["param_live"] = max(worst["param_live"], float(
            diff[live].max()) if live.any() else 0.0)
        if (~live).any():
            off = diff[~live]
            worst["param_off_floor"] = max(worst["param_off_floor"],
                                           float(off.max()))
            worst["off_floor_entries"] += int((~live).sum())
            step_range = 2 * oc.lr * (1 + oc.weight_decay * ref.abs()[~live])
            if not bool((off <= step_range).all()):
                fail(f"train step: parameter {k} moved outside AdamW's "
                     f"step range on the card")
    if not (worst["m_rel"] <= TRAIN_M_REL and worst["v_rel"] <= TRAIN_V_REL
            and worst["param_live"] <= TRAIN_PARAM_TOL):
        fail(f"train step: card against CPU state {worst}")
    return worst


def phase4i_card_vs_cpu(dev, arch: str) -> dict:
    """(a) ``arch``'s full widths at 2 layers, weights made on the CPU and
    copied to the card: one ``train_step`` at f32 compute on each, held
    (loss, ce, aux loss, gradient norm, every new parameter and moment;
    for MoE the expert choices first, phase 4h's rule), the card's step
    run twice (bitwise or not, reported); then one bf16-compute step a
    side (the CPU's by ``loss_fn`` alone) with its loss held."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM, init_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import AUX_WEIGHT, loss_fn

    t0 = time.perf_counter()
    spent = {}

    def lap(key):
        nonlocal t0
        spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()

    oc = OptConfig()
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              **PHASE_4H_CUTS.get(arch, {}))
    # Drawn on the card (the CPU's generator takes ~10 s a billion), then
    # copied to the host once.
    state = {k: v.cpu() for k, v in init_params(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dev).state_dict().items()}

    def fresh(c, device):
        return LM(c, {k: v.to(device, copy=True) for k, v in state.items()},
                  trainable=True)

    # Labels drawn apart from the tokens: with labels equal to the tokens
    # (the pipeline's), a scaled tied embedding (RecurrentGemma's) already
    # predicts them at initialisation, and the f32 loss is exactly 0.
    rng = np.random.default_rng(2)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
                    for _ in range(2))
    lap("init")
    cpu_calls, card_calls, again_calls = [], [], []
    cpu = fresh(cfg, "cpu")
    m_cpu, opt_cpu = train_once(cpu, toks, labels, oc, cpu_calls)
    lap("cpu_f32")
    card = fresh(cfg, dev)
    m_card, opt_card = train_once(card, toks, labels, oc, card_calls)
    lap("card_f32")
    out = {"loss_cpu": m_cpu["loss"], "grad_norm_cpu": m_cpu["grad_norm"]}
    if cfg.n_experts:
        agree, total, first_bad = routing_agreement(
            cfg, cpu_calls, card_calls, f"{arch} 2 layers, training at f32")
        out["expert_choices_agree"] = [agree, total]
        if first_bad is not None:
            fail(f"{arch}: expert choices differ at a near tie in the "
                 f"training step; the step is not held")
    aux = {name: (m["loss"] - m["ce"]) / AUX_WEIGHT
           for name, m in (("cpu", m_cpu), ("card", m_card))}
    out["f32"] = {"loss": rel_err(m_card["loss"], m_cpu["loss"]),
                  "ce": rel_err(m_card["ce"], m_cpu["ce"]),
                  "grad_norm": rel_err(m_card["grad_norm"],
                                       m_cpu["grad_norm"]),
                  "aux": abs(aux["card"] - aux["cpu"]),
                  "aux_cpu": aux["cpu"]}
    f = out["f32"]
    if not (max(f["loss"], f["ce"], f["grad_norm"]) <= TRAIN_F32_REL
            and f["aux"] <= TRAIN_AUX_REL * max(abs(aux["cpu"]), 1.0)):
        fail(f"{arch} 2 layers: card against CPU train step at f32 {f}")
    out["f32_state"] = compare_train_state(card, cpu, opt_card, opt_cpu, oc)
    lap("compare")
    again = fresh(cfg, dev)
    m_again, _ = train_once(again, toks, labels, oc, again_calls)
    out["card_repeat_bitwise"] = (m_again == m_card and all(
        torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                          card.state_dict().values())))
    del cpu, card, again, opt_cpu, opt_card
    torch.cuda.empty_cache()
    lap("card_repeat")
    # At bf16 the card runs a whole step and the CPU the step's loss
    # alone (``loss_fn`` before the update, no backward or AdamW: the
    # loss is what is held, and the CPU's AdamW over a billion
    # parameters would cost ~20 s a model).
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    calls16 = ([], [])
    cpu16 = fresh(cfg16, "cpu")
    with torch.no_grad(), record_moe(calls16[0], logits=True):
        t = torch.from_numpy(toks)
        loss16_cpu = float(loss_fn(cpu16, {"tokens": t, "labels":
                                           torch.from_numpy(labels)})[0])
    del cpu16
    lap("cpu_bf16")
    m16_card, _ = train_once(fresh(cfg16, dev), toks, labels, oc, calls16[1])
    lap("card_bf16")
    out["bf16"] = {"loss": rel_err(m16_card["loss"], loss16_cpu),
                   "loss_cpu": loss16_cpu}
    if cfg.n_experts:
        # The card's step routes again under remat: its first calls are
        # the forward pass the CPU's loss ran.
        agree, total, _ = routing_agreement(
            cfg16, calls16[0], calls16[1][:len(calls16[0])],
            f"{arch} 2 layers, training at bf16")
        out["bf16"]["expert_choices_agree"] = [agree, total]
    if not out["bf16"]["loss"] <= TRAIN_BF16_REL:
        fail(f"{arch} 2 layers: card against CPU loss at bf16 {out['bf16']}")
    torch.cuda.empty_cache()
    lap("rest")
    out["seconds_by_part"] = spent
    out["seconds"] = sum(spent.values())
    st = out["f32_state"]
    log(f"[lm4i] {arch} 2 layers, card against CPU, one train step: f32 "
        f"loss {m_card['loss']:.6f} / {m_cpu['loss']:.6f} ({f['loss']:.2e} "
        f"rel), ce {f['ce']:.2e}, aux {aux['card']:.6f} / {aux['cpu']:.6f}, "
        f"gradient norm {m_card['grad_norm']:.6f} / {m_cpu['grad_norm']:.6f} "
        f"({f['grad_norm']:.2e}); m {st['m_rel']:.2e}, v {st['v_rel']:.2e} "
        f"of a leaf's largest; parameters {st['param_live']:.2e} (|m| >= "
        f"1e-7), {st['param_off_floor']:.2e} over the "
        f"{st['off_floor_entries']} other entries; card run twice "
        f"{'bitwise' if out['card_repeat_bitwise'] else 'NOT bitwise'}; "
        f"bf16 loss {out['bf16']['loss']:.2e} rel; {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    return out


KERNEL_CLASSES = (("gemm", ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                            "sm90_", "sm80_")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce",)),
                  ("index, scatter, gather", ("index", "scatter", "gather",
                                              "embedding")),
                  ("copy, cast", ("copy",)),
                  ("elementwise", ("elementwise",)))


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile_train_step(fn) -> dict:
    """One call of ``fn`` (a train step ending in a host sync) under
    ``torch.profiler`` (device activity only): its kernels, their device
    ms by class, and the device's idle share of the step's host clock
    (1 − the union of the kernels' intervals over the host's span)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_class, by_name = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        label = kernel_class(e.name)
        by_class[label] = by_class.get(label, 0.0) + (end - start) / 1e3
        key = (label, e.name[:90])
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e3
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"kernels": len(spans), "kernel_ms": sum(by_class.values()),
            "busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / wall_ms),
            "ms_by_class": dict(sorted(by_class.items(),
                                       key=lambda kv: -kv[1])),
            "top": [[label, name, ms] for (label, name), ms in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]]}


TRAIN_LABEL = "llama3.2-1b 16 layers train 8 x 512"


def train_bound(model, opt_state, batch) -> dict:
    """The bound of one ``launch/train`` step of phase 4i (Llama-3.2-1B
    at its published config, batch 8 x 512, remat, f32 parameters and
    AdamW state): FLOPs from the dry-run of the same step, least bytes
    from the live model, state and batch (parameters and both moments
    read and written once)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import roofline

    B, S = batch["tokens"].shape
    counts = meta_count(TRAIN_LABEL, model.cfg,
                        ShapeSpec("train", S, B, "train"))
    least = roofline.least_bytes("train", model, batch, opt_state=opt_state)
    return roofline_bound(counts, least)


def host_c2_order(pipe):
    """The c2 order from the host's hashing (``core.hashing``, as the
    reference's ``_c2_order`` computes it)."""
    import numpy as np

    from repro_torch.core import hashing
    from repro_torch.data.tokens import C2_BUCKETS

    offsets, items = pipe.c2_profiles()
    h = hashing.item_hashes(items, np.array([pipe.dc.seed], np.int32),
                            C2_BUCKETS)
    return np.argsort(hashing.user_min_hash_np(h, offsets)[0],
                      kind="stable").astype(np.int64)


def save_restore_full(rec, tmp: Path) -> dict:
    """Save the full (params, opt_state) once, restore it into the live
    model and state, and check every leaf bitwise against a copy taken
    on the card before."""
    import shutil

    import torch

    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.launch import train as launch

    model, opt = rec["model"], rec["opt_state"]
    free_gb = shutil.disk_usage(tmp).free / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = launch.save_state(tmp, model, opt, 7)
    save_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in path.iterdir())
    before = [t.clone() for t in tree_leaves(launch.state_tree(model, opt))]
    t0 = time.perf_counter()
    step = launch.restore_state(tmp, model, opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    after = tree_leaves(launch.state_tree(model, opt))
    same = sum(torch.equal(a, b) for a, b in zip(before, after))
    if step != 7 or same != len(before):
        fail(f"full checkpoint: {same} of {len(before)} leaves restored "
             f"bitwise (step {step})")
    del before, after
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "leaves": same, "save_s": save_s,
            "restore_s": restore_s, "disk_free_gb_before": free_gb}


def phase4i_full(dev, tmp: Path, smi: str) -> dict:
    """(b) Llama-3.2-1B at its full published config trained through
    ``launch/train`` (c2 order through the FastRandomHash kernel), its
    launches counted from 0; one profiled step; a full save and
    restore."""
    import math
    import statistics as stats

    import numpy as np
    import torch

    from repro_torch.kernels.frh_minhash import ops as mh_ops
    from repro_torch.launch import train as launch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import train_step

    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("f32 products must run in full f32 on the card (TF32 is on)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rec = launch.run(FULL_TRAIN_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    csr = mh_ops.launches_csr
    others = {k: v for k, v in launches.items() if k != "frh_minhash" and v}
    if launches["frh_minhash"] != 1 or csr != 1 or others:
        fail(f"launch/train --data-order c2 launched {launches} (CSR entry "
             f"{csr}); expected FastRandomHash once and nothing else")
    pipe = rec["pipeline"]
    if not np.array_equal(pipe._order, host_c2_order(pipe)):
        fail("the c2 order from the FastRandomHash kernel differs from the "
             "host's hashing")
    losses = rec["losses"]
    if not (len(losses) == 8 and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"full-width training losses {losses}: 8 finite values with "
             f"the last below the first expected")
    cfg = rec["model"].cfg
    tokens = 8 * 512
    step_ms = stats.median(rec["step_ms"][-5:])
    out = {"losses": losses, "step_ms": rec["step_ms"],
           "step_ms_median_last5": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3,
           "peak_gb": rec["peak_gb"], "param_count": cfg.param_count(),
           "run_s": wall, "launches": launches,
           "c2_order_docs": len(pipe._order),
           "bound": train_bound(rec["model"], rec["opt_state"],
                                pipe.batch(0))}
    out["model_flops_share"] = (6 * cfg.param_count() * tokens
                                / (step_ms / 1e3) / BF16_OPS_PER_S)
    batch = pipe.batch(8)
    oc = OptConfig()

    def one_step():
        _, _, m = train_step(rec["model"], rec["opt_state"], batch, oc)
        float(m["loss"])

    out["profile"] = profile_train_step(one_step)
    out["checkpoint"] = save_restore_full(rec, tmp)
    del rec, pipe, batch
    torch.cuda.empty_cache()
    prof, ck, b = out["profile"], out["checkpoint"], out["bound"]
    log(f"[lm4i] Llama-3.2-1B full width ({cfg.param_count():,} "
        f"parameters), launch/train --batch 8 --seq 512 --steps 8 "
        f"--data-order c2: losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step {step_ms:.2f} ms (median of the last 5; all "
        + ", ".join(f"{x:.1f}" for x in out["step_ms"])
        + f"), {out['tokens_per_s']:.1f} tok/s, peak {out['peak_gb']:.2f} "
        f"GB, model FLOPs {out['model_flops_share'] * 100:.2f}% of the "
        f"bf16 peak; bound {bound_text(b)}; launches {launches}; {smi}")
    log(f"[lm4i] one profiled step: {prof['kernels']} kernels, "
        f"{prof['kernel_ms']:.1f} ms of them, busy {prof['busy_ms']:.1f} of "
        f"{prof['wall_ms']:.1f} ms (device idle "
        f"{prof['idle_share'] * 100:.1f}%); by class "
        + ", ".join(f"{k} {v:.1f}" for k, v in prof["ms_by_class"].items()))
    for label, name, ms in prof["top"]:
        log(f"[lm4i]   {ms:8.2f} ms  {label:12s} {name}")
    log(f"[lm4i] full (params, opt_state) checkpoint: {ck['bytes'] / 1e9:.2f}"
        f" GB, {ck['leaves']} leaves, save {ck['save_s']:.1f} s, restore "
        f"{ck['restore_s']:.1f} s, bitwise ({ck['disk_free_gb_before']:.0f} "
        f"GB free before)")
    return out


# The restart contract's models at 2 layers: Llama-3.2-1B (whose card
# checkpoint is also restored on the CPU) and OLMoE-1B-7B, whose backward
# sums through repeated-index gathers.
RESTART_ARCHS = ("llama3.2-1b", "olmoe-1b-7b")


def phase4i_restart(dev, tmp: Path, arch: str, cpu_check: bool) -> dict:
    """(c) The restart contract at 2 layers and full width: a straight
    6-step run, a run that fails at step 3 (exit 42), and its resume from
    the step-2 checkpoint; the final losses within RESTART_TOL (bitwise
    reported), and with ``cpu_check`` the card's last checkpoint restored
    on the CPU equal to the card's state."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    base = ["--arch", arch, "--batch", "8", "--seq", "512",
            "--steps", "6", "--data-order", "c2", "--device", "cuda"]
    ck = ["--ckpt-dir", str(tmp / "restart"), "--ckpt-every", "3"]
    straight = launch.run(base, cfg=cfg)
    try:
        launch.run(base + ck + ["--fail-at-step", "3"], cfg=cfg)
        code = 0
    except SystemExit as exc:
        code = exc.code
    resumed = launch.run(base + ck, cfg=cfg)
    diff = abs(resumed["final_loss"] - straight["final_loss"])
    if code != launch.FAILURE_EXIT or resumed["start_step"] != 3 or not (
            diff < RESTART_TOL):
        fail(f"{arch} restart at 2 layers: exit {code}, resumed at "
             f"{resumed['start_step']}, final losses "
             f"{straight['final_loss']} / {resumed['final_loss']}")
    sd_s, sd_r = straight["model"].state_dict(), resumed["model"].state_dict()
    opt_s, opt_r = straight["opt_state"], resumed["opt_state"]
    state_bitwise = all(torch.equal(sd_s[k], sd_r[k]) and all(
        torch.equal(opt_s[key][k], opt_r[key][k]) for key in ("m", "v"))
        for k in sd_s)
    out = {"loss_straight": straight["final_loss"],
           "loss_resumed": resumed["final_loss"], "final_loss_diff": diff,
           "bitwise_loss": diff == 0.0, "state_bitwise": state_bitwise,
           "exit_code": code}
    del straight, sd_s, opt_s
    same = None
    if cpu_check:
        cpu = init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                          trainable=True)
        cpu_opt = init_opt_state(dict(cpu.named_parameters()), OptConfig())
        step = launch.restore_state(tmp / "restart", cpu, cpu_opt)
        cpu_sd = cpu.state_dict()
        same = sum(torch.equal(cpu_sd[k], sd_r[k].cpu()) and all(
            torch.equal(cpu_opt[key][k], opt_r[key][k].cpu())
            for key in ("m", "v")) for k in sd_r)
        if step != 5 or same != len(sd_r) or int(cpu_opt["step"]) != 6:
            fail(f"the card's checkpoint restored on the CPU: {same} of "
                 f"{len(sd_r)} parameters (with their moments) equal, step "
                 f"{step}")
    out.update(cpu_restore_params_equal=same,
               seconds=time.perf_counter() - t0)
    del sd_r, opt_r
    del resumed
    torch.cuda.empty_cache()
    log(f"[lm4i] {arch} restart at 2 layers, full width: exit {code} at "
        f"step 3, resumed from step 2; final losses differ by {diff:.3e} "
        f"({'bitwise' if diff == 0.0 else 'not bitwise'}; parameters and "
        f"moments {'bitwise' if state_bitwise else 'NOT bitwise'})"
        + (f"; the card's checkpoint restored on the CPU: {same} "
           f"parameters and their moments equal" if cpu_check else "")
        + f"; {out['seconds']:.1f} s")
    return out


def lm_training(dev, smi: str) -> dict:
    """Phase 4i: LM training on the card."""
    import torch

    t0 = time.perf_counter()
    out = {"card_vs_cpu": {}}
    for arch in PHASE_4I_ARCHS:
        out["card_vs_cpu"][arch] = phase4i_card_vs_cpu(dev, arch)
    with tempfile.TemporaryDirectory() as tmp:
        out["full"] = phase4i_full(dev, Path(tmp), smi)
    reset_launches()
    out["restart"] = {}
    for arch in RESTART_ARCHS:
        with tempfile.TemporaryDirectory() as tmp:
            out["restart"][arch] = phase4i_restart(
                dev, Path(tmp), arch, cpu_check=arch == RESTART_ARCHS[0])
    launches = read_launches()
    runs = 3 * len(RESTART_ARCHS)
    if launches["frh_minhash"] != runs or any(
            v for k, v in launches.items() if k != "frh_minhash"):
        fail(f"the restarts' {runs} runs launched {launches}; expected "
             f"FastRandomHash once a run and nothing else")
    out["restart_launches"] = launches
    torch.cuda.empty_cache()
    out.update(card=smi, seconds=time.perf_counter() - t0)
    log(f"[lm4i] phase 4i: {out['seconds']:.1f} s")
    return out


# -- phase 4l: the mesh's LM half on the card ------------------------------

# (a) Llama-3.2-1B training: phase 4i's launch/train batches (8 x 512, the
# c2 order), 3 steps from one init. (b) OLMoE-1B-7B serving: 8 requests
# (prompts 4-128 tokens, budgets 2-16) in one wave of 8 and through 8
# slots. (c) A 2-layer Llama checkpoint, saved whole, read back sharded.
P4L_TRAIN_STEPS = 3
P4L_SERVE = {"max_batch": 8, "max_prompt": 128, "max_new": 16}
P4L_REQUESTS = 8
# The four-card entry's meshes, each held to the one-card results.
P4L_MESHES = ((2, 2), (1, 4), (4, 1))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def process_group(rank: int = 0, world: int = 1, port: int = 0):
    """An ``nccl`` process group over ``localhost``, destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{port or free_port()}", rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def p4l_train(dev, ctx, whole: bool) -> dict:
    """(a) 3 ``train_step``s of Llama-3.2-1B sharded under ``ctx``
    (``grad_shardings`` the parameters'); with ``whole`` also the
    unsharded steps from the same init, held bitwise: losses, gradient
    norms, and every parameter and moment."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.models.model import LM, init_params
    from repro_torch.models.sharding import to_shardings
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.steps import train_step

    cfg = get_config("llama3.2-1b")
    oc = OptConfig()
    pipe = TokenPipeline(cfg, DataConfig(seq_len=512, global_batch=8,
                                         seed=0, ordering="c2",
                                         n_docs=1024), dev)
    batches = [pipe.batch(s) for s in range(P4L_TRAIN_STEPS)]
    init = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = {k: v.detach() for k, v in init.state_dict().items()}
    del init

    def run(model, **kw):
        opt = init_opt_state(dict(model.named_parameters()), oc)
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rec = {"loss": [], "grad_norm": [], "step_ms": []}
        for b in batches:
            t0 = time.perf_counter()
            _, _, m = train_step(model, opt, b, oc, **kw)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        # Above what the card held before the steps (the parameters and
        # moments of this side, and the other side's with ``whole``), and
        # all the card held (this side's footprint without ``whole``).
        rec["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        rec["card_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        return model, opt, rec

    out = {}
    if whole:
        a, opt_a, out["unsharded"] = run(LM(cfg, {
            k: v.clone() for k, v in state.items()}, trainable=True))
    sharded = LM(cfg, state, trainable=True).shard(ctx)
    del state
    torch.cuda.empty_cache()
    b, opt_b, out["sharded"] = run(
        sharded, ctx=ctx, grad_shardings=to_shardings(sharded.specs,
                                                      ctx.mesh))
    if whole:
        sa, sb = a.state_dict(), b.state_dict()
        differ = [k for k in sa if not (torch.equal(sa[k], sb[k]) and all(
            torch.equal(opt_a[key][k], opt_b[key][k])
            for key in ("m", "v")))]
        same = len(sa) - len(differ)
        out["leaves_bitwise"] = [same, len(sa)]
        ua, ub = out["unsharded"], out["sharded"]
        if (same != len(sa) or ua["loss"] != ub["loss"]
                or ua["grad_norm"] != ub["grad_norm"]):
            fail(f"phase 4l (a): the one-rank mesh's train steps against "
                 f"the unsharded ones: losses {ub['loss']} / {ua['loss']}, "
                 f"norms {ub['grad_norm']} / {ua['grad_norm']}, {same} of "
                 f"{len(sa)} parameters (with m and v) bitwise; differ: "
                 f"{differ[:4]}")
        del a, opt_a
    del b, opt_b
    torch.cuda.empty_cache()
    return out


def p4l_requests(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(3)
    lens = rng.integers(4, P4L_SERVE["max_prompt"] + 1, P4L_REQUESTS)
    budgets = rng.integers(2, P4L_SERVE["max_new"] + 1, P4L_REQUESTS)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), int(b))
            for n, b in zip(lens, budgets)]


def p4l_serve(dev, ctx, whole: bool) -> dict:
    """(b) OLMoE-1B-7B's 8 requests through ``Engine(ctx=)`` in a wave
    and through 8 slots; with ``whole`` also through the unsharded
    engine, the tokens rid by rid and every MoE call's expert choices
    equal (at model size 1 the expert-parallel branch buckets every
    expert over the rank's tokens, as one device does)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    cfg = get_config("olmoe-1b-7b")
    built = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    served = built.serving_copy()
    del built
    if not whole:  # only this rank's shards stay on its card
        served = served.shard(ctx)
    torch.cuda.empty_cache()
    reqs = p4l_requests(cfg.vocab_size)
    out = {}
    for mode in ("wave", "continuous"):
        sc = ServeConfig(**P4L_SERVE, continuous=mode == "continuous",
                         slots=P4L_SERVE["max_batch"])
        sides = {}
        for side in (("unsharded", "sharded") if whole else ("sharded",)):
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            calls: list = []
            with record_moe(calls):
                eng = Engine(served, sc,
                             ctx=ctx if side == "sharded" else None)
                bad = watch_logits(eng)
                for rid, (prompt, budget) in enumerate(reqs):
                    eng.submit(Request(rid=rid, prompt=prompt,
                                       max_new=budget))
                t0 = time.perf_counter()
                stats = eng.run()
                secs = time.perf_counter() - t0
            if int(bad) or stats["completed"] != P4L_REQUESTS:
                fail(f"phase 4l (b) {mode} {side}: {int(bad)} non-finite "
                     f"logits, {stats['completed']} requests completed")
            sides[side] = {
                "tokens": {r.rid: r.output.tolist() for r in eng.done},
                "choices": [c[1] for c in calls],
                "record": {"tokens": stats["tokens"], "seconds": secs,
                           "tokens_per_s": stats["tokens"] / secs,
                           "decode_steps": stats["decode_steps"],
                           "peak_gb": (torch.cuda.max_memory_allocated(dev)
                                       - held) / 1e9,
                           "card_gb": torch.cuda.max_memory_allocated(dev)
                           / 1e9}}
            del eng
            torch.cuda.empty_cache()
        rec = {side: v["record"] for side, v in sides.items()}
        if whole:
            u, s_ = sides["unsharded"], sides["sharded"]
            same_calls = (len(u["choices"]) == len(s_["choices"]) and all(
                torch.equal(a, b) for a, b in zip(u["choices"],
                                                  s_["choices"])))
            rec["moe_calls_equal"] = [same_calls, len(s_["choices"])]
            if u["tokens"] != s_["tokens"] or not same_calls:
                fail(f"phase 4l (b) {mode}: the one-rank mesh's engine "
                     f"against the unsharded one: tokens equal "
                     f"{u['tokens'] == s_['tokens']}, expert choices of "
                     f"{len(s_['choices'])} MoE calls equal {same_calls}")
        rec["tokens_by_rid"] = sides["sharded"]["tokens"]
        out[mode] = rec
    del served
    torch.cuda.empty_cache()
    return out


def p4l_checkpoint(dev, ctx, tmp: Path) -> dict:
    """(c) A 2-layer Llama-3.2-1B (params and AdamW state after one
    step), saved whole by ``launch/train``'s ``save_state`` on rank 0,
    read back by ``restore_sharded`` under ``ctx``'s mesh: every leaf
    bitwise this rank's shard of the saved one."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_sharded
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models.model import full_shapes, init_params, \
        params_to_tree
    from repro_torch.models.sharding import param_pspecs, to_shardings
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.steps import train_step

    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    oc = OptConfig()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev,
                        trainable=True)
    opt = init_opt_state(dict(model.named_parameters()), oc)
    toks = torch.arange(2 * 64, device=dev).reshape(2, 64) % cfg.vocab_size
    train_step(model, opt, {"tokens": toks, "labels": toks}, oc)
    t0 = time.perf_counter()
    if ctx.mesh.rank == 0:
        launch.save_state(tmp, model, opt, 1)
    dist.barrier()
    save_s = time.perf_counter() - t0
    shapes = params_to_tree(full_shapes(cfg), cfg)
    psh = to_shardings(param_pspecs(cfg, shapes, ctx.mesh), ctx.mesh)
    like = (shapes, {"m": shapes, "step": torch.zeros((), device="meta"),
                     "v": shapes})
    shardings = (psh, {"m": psh, "step": None, "v": psh})
    t0 = time.perf_counter()
    tree, step = restore_sharded(tmp, like, shardings)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    from repro_torch.checkpoint.checkpoint import (_sharding_leaves,
                                                   tree_leaves)
    want = tree_leaves(launch.state_tree(model, opt))
    got = tree_leaves(tree)
    plan = _sharding_leaves(tree, shardings)
    same = sum(torch.equal(g.to(dev), w if sh is None else sh.shard(w))
               for g, w, sh in zip(got, want, plan))
    if step != 1 or same != len(want):
        fail(f"phase 4l (c): restore_sharded gave {same} of {len(want)} "
             f"leaves bitwise (step {step})")
    del model, opt, tree, want, got
    torch.cuda.empty_cache()
    return {"leaves": same, "save_s": save_s, "restore_s": restore_s}


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for a block: the backward
    of an index (the embedding lookup) and of ``repeat_interleave`` (kv
    heads) add with float atomics on the card, in the order the threads
    run, so two runs of one step may differ in the last bit; here they
    add in a fixed order. cuBLAS runs one stream, so its warning about a
    workspace for many is silenced."""
    import warnings

    import torch

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*[Dd]eterministic")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def p4l_drive(dev, ctx, whole: bool, tmp: Path) -> dict:
    """Phase 4l's main path under ``ctx``, its C² launches counted from
    0: FastRandomHash once (the training batches' c2 order), nothing
    else. Both sides run under ``deterministic()``, so that "bitwise"
    compares the paths and not the order of float atomics."""
    import torch

    torch.cuda.empty_cache()
    reset_launches()
    with deterministic():
        out = {"train": p4l_train(dev, ctx, whole),
               "serve": p4l_serve(dev, ctx, whole),
               "checkpoint": p4l_checkpoint(dev, ctx, tmp)}
    out["launches"] = read_launches()
    if out["launches"]["frh_minhash"] != 1 or any(
            v for k, v in out["launches"].items() if k != "frh_minhash"):
        fail(f"phase 4l launched {out['launches']}; expected "
             f"FastRandomHash once and nothing else")
    return out


def p4l_count(dev, ctx) -> dict:
    """One train step of phase 4l's (Llama-3.2-1B, 8 x 512,
    ``grad_shardings`` the parameters') built on this rank's card under
    ``ctx`` (random weights, seed 0, a zero batch: a dense step's counts
    do not depend on the data) and counted there by ``OpCounter``: FLOPs
    by dtype and the collectives by kind and axis set."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cell = dryrun.build_cell("llama3.2-1b", "p4l", cfg=get_config(
        "llama3.2-1b"), shape=ShapeSpec(*P4L_TRAIN_SHAPE), mesh=ctx.mesh)
    counts = dryrun.count_cell(cell)
    del cell
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return {"flops_by_dtype": counts.flops,
            "collectives": counts.collectives(),
            "seconds": time.perf_counter() - t0}


def same_as_predicted(counted: dict, predicted: dict) -> bool:
    """FLOPs by dtype and collective bytes by kind equal as integers."""
    return (counted["flops_by_dtype"] == predicted["flops_by_dtype"]
            and counted["collectives"]["per_op_bytes"]
            == predicted["collectives"]["per_op_bytes"])


def lm_mesh(dev, smi: str, predicted: dict) -> dict:
    """Phase 4l: the mesh's LM half on one card: a one-rank ``nccl``
    process group in this process, ``make_host_mesh()``'s (1, 1) mesh,
    every collective an identity; the sharded path held bitwise to the
    unsharded one, and one sharded train step counted on the card against
    the mesh dry-run's (1, 1) count (``predicted``, phase 4j's): FLOPs by
    dtype equal as integers, no collective bytes on either side."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import make_ctx

    t0 = time.perf_counter()
    with process_group(), tempfile.TemporaryDirectory() as tmp:
        ctx = make_ctx(make_host_mesh(dev))
        out = p4l_drive(dev, ctx, True, Path(tmp))
        out["counted"] = p4l_count(dev, ctx)
    c = out["counted"]
    log(f"[lm4l] one rank: a sharded train step counted on the card: FLOPs "
        f"by dtype {c['flops_by_dtype']}, collective bytes "
        f"{c['collectives']['total_bytes_per_device']}; the (1, 1) mesh "
        f"dry-run {predicted['flops_by_dtype']}, collective bytes "
        f"{predicted['collectives']['total_bytes_per_device']} "
        f"({c['seconds']:.1f} s)")
    if not same_as_predicted(c, predicted) or c["collectives"][
            "total_bytes_per_device"] or predicted["collectives"][
            "total_bytes_per_device"]:
        fail(f"phase 4l: the one-rank train step counted on the card {c} "
             f"against the (1, 1) mesh dry-run's {predicted}")
    tr, sv = out["train"], out["serve"]
    out.update(card=smi, seconds=time.perf_counter() - t0)
    for side in ("unsharded", "sharded"):
        t = tr[side]
        log(f"[lm4l] Llama-3.2-1B train 8 x 512, {side}: losses "
            + ", ".join(f"{x:.6f}" for x in t["loss"]) + "; step ms "
            + ", ".join(f"{x:.1f}" for x in t["step_ms"])
            + f"; peak {t['peak_gb']:.2f} GB; {smi}")
    for mode in ("wave", "continuous"):
        for side in ("unsharded", "sharded"):
            r = sv[mode][side]
            log(f"[lm4l] OLMoE-1B-7B {mode}, {side}: {r['tokens']} tokens, "
                f"{r['tokens_per_s']:.1f} tok/s, {r['decode_steps']} decode "
                f"steps, peak {r['peak_gb']:.2f} GB")
    ck = out["checkpoint"]
    log(f"[lm4l] one rank: train steps bitwise ({tr['leaves_bitwise'][0]} "
        f"leaves), engine tokens and expert choices equal "
        f"({sv['wave']['moe_calls_equal'][1]} + "
        f"{sv['continuous']['moe_calls_equal'][1]} MoE calls); "
        f"restore_sharded {ck['leaves']} leaves bitwise (save "
        f"{ck['save_s']:.1f} s, restore {ck['restore_s']:.1f} s); launches "
        f"{out['launches']}; phase 4l: {out['seconds']:.1f} s")
    return out


def lm_mesh_rank(rank: int, world: int, port: int, one_card: str,
                 out_dir: str) -> None:
    """One rank of the four-card entry (``lm_mesh_alone``): every mesh of
    ``P4L_MESHES`` in turn over one ``nccl`` group, each held to the
    one-card results (``one_card``, a JSON file): losses of step 1 within
    TRAIN_BF16_REL (bf16 sums in other orders), later steps printed; the
    engine's requests complete with finite logits (tokens equal to the
    one card's counted: the expert capacity follows each rank's batch
    shard); ``restore_sharded`` bitwise; then one train step counted on
    the card (``p4l_count``). Writes each mesh's figures, the counts and
    this card's peak memory over the training steps and over each serve
    to ``out_dir``."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import make_ctx

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    ref = json.loads(Path(one_card).read_text())
    res = {}
    with process_group(rank, world, port):
        for shape in P4L_MESHES:
            ctx = make_ctx(Mesh(shape, ("data", "model"), dev))
            t0 = time.perf_counter()
            tmp = Path(out_dir) / f"ckpt_{shape[0]}x{shape[1]}"
            out = p4l_drive(dev, ctx, False, tmp)
            counted = p4l_count(dev, ctx)
            loss, ref_loss = (out["train"]["sharded"]["loss"],
                              ref["train"]["sharded"]["loss"])
            if rel_err(loss[0], ref_loss[0]) > TRAIN_BF16_REL:
                fail(f"phase 4l {shape}: step-1 loss {loss[0]} against "
                     f"one card's {ref_loss[0]}")
            same = {mode: sum(out["serve"][mode]["tokens_by_rid"][r]
                              == ref["serve"][mode]["tokens_by_rid"][str(r)]
                              for r in out["serve"][mode]["tokens_by_rid"])
                    for mode in ("wave", "continuous")}
            res[f"{shape[0]}x{shape[1]}"] = {
                "loss": loss, "one_card_loss": ref_loss,
                "step_ms": out["train"]["sharded"]["step_ms"],
                "train_card_gb": out["train"]["sharded"]["card_gb"],
                "serve": {m: {k: v for k, v in out["serve"][m][
                    "sharded"].items()} for m in ("wave", "continuous")},
                "tokens_equal_one_card": same,
                "checkpoint": out["checkpoint"], "counted": counted,
                "seconds": time.perf_counter() - t0}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))


def lm_mesh_alone() -> dict:
    """Phase 4l alone, one ``nccl`` process a card: the one-rank run in
    this process on the first card, then, with more than one card, one
    process a card over every mesh of ``P4L_MESHES`` held to it, with
    each card's peak memory, and each rank's counted train step held to
    the mesh dry-run's prediction for its mesh (phase 4j's subprocess):
    FLOPs by dtype and collective bytes by kind equal as integers, each
    card's training peak within PEAK_TOL of the predicted per-rank peak.
    Run as ``PYTHONPATH=src python3 -c "import chip_smoke as c;
    c.lm_mesh_alone()"`` on a machine with one card, or with four for
    the meshes."""
    import torch

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    proc = start_mesh_predictions()
    build.build()
    predicted = read_mesh_predictions(proc)
    one = lm_mesh(dev, smi, predicted[mesh_key((1, 1))])
    n = torch.cuda.device_count()
    out = {"one_card": one, "mesh_predictions": predicted}
    if n >= 4:
        with tempfile.TemporaryDirectory() as tmp:
            ref = Path(tmp) / "one_card.json"
            ref.write_text(json.dumps(
                {"train": one["train"], "serve": one["serve"]}))
            port = free_port()
            procs = [subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke as c; "
                 f"c.lm_mesh_rank({r}, 4, {port}, {str(ref)!r}, "
                 f"{tmp!r})"], cwd=str(ROOT),
                env=dict(__import__("os").environ,
                         PYTHONPATH=str(ROOT / "src")))
                for r in range(4)]
            codes = [p.wait(timeout=900) for p in procs]
            if any(codes):
                fail(f"phase 4l on 4 cards: ranks exited {codes}")
            ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                     for r in range(4)]
        out["meshes"] = {}
        for key in ranks[0]:
            r0 = ranks[0][key]
            out["meshes"][key] = {
                **{k: r0[k] for k in ("loss", "one_card_loss", "step_ms",
                                      "tokens_equal_one_card",
                                      "checkpoint", "seconds")},
                "train_card_gb": [r[key]["train_card_gb"] for r in ranks],
                "serve_card_gb": [max(r[key]["serve"][m]["card_gb"]
                                      for m in ("wave", "continuous"))
                                  for r in ranks],
                "serve": r0["serve"],
                "counted_equal_predicted": [same_as_predicted(
                    r[key]["counted"], predicted[key]) for r in ranks],
                "predicted_peak_gb": predicted[key]["peak_gb"],
                "collective_bytes": r0["counted"]["collectives"]}
            m = out["meshes"][key]
            peak_ratio = [gb / m["predicted_peak_gb"]
                          for gb in m["train_card_gb"]]
            m["peak_ratio"] = peak_ratio
            log(f"[lm4l] mesh {key} on 4 cards: a train step counted on "
                f"each card against the mesh dry-run: FLOPs and collective "
                f"bytes equal {m['counted_equal_predicted']} (collective "
                f"bytes by kind {m['collective_bytes']['per_op_bytes']}); "
                f"training peak by card / predicted "
                f"{m['predicted_peak_gb']:.3f} GB: " + ", ".join(
                    f"{x:.4f}" for x in peak_ratio) + f"; {smi}")
            if not all(m["counted_equal_predicted"]):
                fail(f"phase 4l mesh {key}: the counted train steps "
                     f"{[r[key]['counted'] for r in ranks]} against the "
                     f"mesh dry-run's {predicted[key]}")
            if not all(abs(x - 1.0) <= PEAK_TOL for x in peak_ratio):
                fail(f"phase 4l mesh {key}: the cards' training peaks "
                     f"{m['train_card_gb']} GB not within {PEAK_TOL:.0%} "
                     f"of the predicted {m['predicted_peak_gb']:.3f} GB")
            log(f"[lm4l] mesh {key} on 4 cards: losses "
                + ", ".join(f"{x:.6f}" for x in m["loss"]) + " (one card "
                + ", ".join(f"{x:.6f}" for x in m["one_card_loss"])
                + "); step ms " + ", ".join(f"{x:.1f}" for x in m["step_ms"])
                + "; peak GB by card: training " + ", ".join(
                    f"{x:.2f}" for x in m["train_card_gb"])
                + ", serving " + ", ".join(
                    f"{x:.2f}" for x in m["serve_card_gb"])
                + f"; OLMoE tokens equal to one card's {m['tokens_equal_one_card']}"
                f"; restore_sharded {m['checkpoint']['leaves']} leaves bitwise"
                f"; {m['seconds']:.1f} s")
    log(f"[lm4l] alone: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"lm_mesh": out}, default=lambda o: o.tolist()))
    return out


# -- phase 4j: the LM analysis tools against the card ----------------------

# The decode steps phase 4j counts: each family's batch-8 step as phases
# 4g and 4h serve it (published configs, full depth, a 576-slot cache).
PHASE_4J_DECODES = ("llama3.2-1b", "olmoe-1b-7b", "recurrentgemma-2b",
                    "xlstm-125m")
# The dry-run's predicted peak against phase 4i's measured one.
PEAK_TOL = 0.25


def card_count(cfg, shape, dev):
    """The step of ``cfg`` at ``shape`` built on the card (random
    weights, seed 0) and counted there by the same ``OpCounter``; returns
    (counts, the allocator's peak over the step with the step's inputs
    and nothing else counted)."""
    import torch

    from repro_torch.launch import dryrun

    cell = dryrun.build_cell(cfg.name, "card", cfg=cfg, shape=shape,
                             device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = dryrun.count_cell(cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + counts.input_bytes
    del cell
    torch.cuda.empty_cache()
    return counts, peak


# Phase 4l's train step, as the mesh dry-run predicts it (ShapeSpec's
# name, seq_len, global batch, kind), and the meshes it is predicted on:
# the one-rank mesh and the four-card ones.
P4L_TRAIN_SHAPE = ("p4l", 512, 8, "train")
P4J_MESHES = ((1, 1),) + P4L_MESHES


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def mesh_predictions() -> None:
    """Print, as one JSON line, the mesh dry-run's count of rank 0's
    share of phase 4l's train step on each mesh of ``P4J_MESHES`` (meta
    tensors under ``launch.mesh.fake_world`` of the mesh's size): FLOPs by
    dtype, the collectives and the predicted per-rank peak. Runs on the
    CPU in a process of its own (``start_mesh_predictions``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, fake_world

    torch.set_num_threads(1)
    cfg = get_config("llama3.2-1b")
    out = {}
    for shape in P4J_MESHES:
        t0 = time.perf_counter()
        with fake_world(shape[0] * shape[1]):
            m = Mesh(shape, ("data", "model"), device="meta")
            c = dryrun.count_cell(dryrun.build_cell(
                cfg.name, "p4l", cfg=cfg, shape=ShapeSpec(*P4L_TRAIN_SHAPE),
                mesh=m))
        out[mesh_key(shape)] = {"flops_by_dtype": c.flops,
                                "collectives": c.collectives(),
                                "peak_gb": c.peak_bytes / 1e9,
                                "seconds": time.perf_counter() - t0}
    print(json.dumps(out))


def start_mesh_predictions():
    """``mesh_predictions`` in a CPU-only subprocess, started now and read
    by ``read_mesh_predictions``; killed at exit if still running."""
    import atexit
    import os

    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; "
         "c.mesh_predictions()"], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def read_mesh_predictions(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    if proc.returncode:
        fail(f"the mesh dry-run's predictions exited {proc.returncode}: "
             f"{err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def lm_analysis(dev, smi: str, lm4i: dict, mesh_proc=None) -> dict:
    """Phase 4j: (a) the dry-run of phase 4i's train step and of each
    family's batch-8 decode step on meta tensors (the counts phases 4g-4i
    took their bounds from) against the same steps counted on the card:
    FLOPs by dtype equal as integers; (b) the dry-run's predicted peak of
    the train step against phase 4i's measured peak, within PEAK_TOL; (c)
    the mesh dry-run's predictions of phase 4l's train step per card on
    (1, 1), (2, 2), (1, 4) and (4, 1) (``mesh_proc``, a
    ``start_mesh_predictions`` subprocess started earlier, or one started
    here): the peak and the collective bytes by kind, logged and handed
    to phase 4l."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import op_analysis as oa

    t0 = time.perf_counter()
    steps = [(TRAIN_LABEL, get_config("llama3.2-1b"),
              ShapeSpec("train", 512, 8, "train"))]
    for arch in PHASE_4J_DECODES:
        cfg = get_config(arch)
        steps.append((decode_label(cfg, 8, 576), cfg,
                      ShapeSpec("decode", 576, 8, "decode")))
    out = {"steps": {}}
    for label, cfg, shape in steps:
        ts = time.perf_counter()
        meta = meta_count(label, cfg, shape)
        card, alloc_peak = card_count(cfg, shape, dev)
        row = {"flops_by_dtype_meta": meta.flops,
               "flops_by_dtype_card": card.flops,
               "flops_equal": oa.same_flops(meta, card),
               "kernels_meta": meta.kernels, "kernels_card": card.kernels,
               "eager_bytes_meta": meta.bytes, "eager_bytes_card": card.bytes,
               "peak_gb_meta": meta.peak_bytes / 1e9,
               "peak_gb_card_counter": card.peak_bytes / 1e9,
               "peak_gb_card_allocator": alloc_peak / 1e9,
               "meta_seconds": META_COUNTS[label]["seconds"],
               "seconds": time.perf_counter() - ts}
        out["steps"][label] = row
        log(f"[lm4j] {label}: FLOPs by dtype meta {meta.flops}, card "
            f"{card.flops} ({'equal' if row['flops_equal'] else 'DIFFER'});"
            f" kernels {meta.kernels} / {card.kernels}; eager bytes "
            f"{meta.bytes:.4e} / {card.bytes:.4e}; peak GB predicted "
            f"{row['peak_gb_meta']:.3f}, counted on the card "
            f"{row['peak_gb_card_counter']:.3f}, allocator "
            f"{row['peak_gb_card_allocator']:.3f}; "
            f"{row['seconds']:.1f} s")
        if not row["flops_equal"]:
            fail(f"phase 4j {label}: FLOPs by dtype on meta tensors "
                 f"{meta.flops} and on the card {card.flops}")
    predicted = META_COUNTS[TRAIN_LABEL]["counts"].peak_bytes / 1e9
    measured = lm4i["full"]["peak_gb"]
    ratio = predicted / measured
    out["train_peak"] = {"predicted_gb": predicted, "measured_gb": measured,
                         "ratio": ratio}
    log(f"[lm4j] Llama-3.2-1B train step 8 x 512: predicted peak "
        f"{predicted:.3f} GB, phase 4i measured {measured:.3f} GB "
        f"(ratio {ratio:.4f}); {smi}")
    if not abs(ratio - 1.0) <= PEAK_TOL:
        fail(f"phase 4j: the predicted peak {predicted:.3f} GB is not "
             f"within {PEAK_TOL:.0%} of phase 4i's {measured:.3f} GB")
    ts = time.perf_counter()
    preds = read_mesh_predictions(mesh_proc or start_mesh_predictions())
    for key, p in preds.items():
        coll = p["collectives"]
        log(f"[lm4j] mesh {key}: Llama-3.2-1B train 8 x 512 predicted per "
            f"card: peak {p['peak_gb']:.3f} GB, collective bytes by kind "
            f"{coll['per_op_bytes']} (by axes {coll['per_axes_bytes']}), "
            f"FLOPs by dtype {p['flops_by_dtype']}; counted on the CPU in "
            f"{p['seconds']:.1f} s")
    out["mesh_predictions"] = preds
    out["mesh_wait_s"] = time.perf_counter() - ts
    torch.cuda.empty_cache()
    out.update(card=smi, seconds=time.perf_counter() - t0)
    log(f"[lm4j] phase 4j: {out['seconds']:.1f} s")
    return out


# -- phase 5: timing at the main path's shapes -----------------------------

def time_cluster_knn(dev, built, index, launches: int) -> tuple[dict, float]:
    import torch

    from repro_torch.bench.step2_sweep import main_path_batches
    from repro_torch.kernels.goldfinger_knn import ops, ref
    from repro_torch.sketch.goldfinger import words_tensor

    plan, k = built["plan"], index.k
    words = words_tensor(index.words, dev)
    card = torch.from_numpy(index.card).to(dev)
    W = words.shape[1]
    batches, caps = [], []
    bytes_count = 0
    for cap, mem, batch in main_path_batches(plan, words, card):
        batches.append(batch)
        caps.append(cap)
        bytes_count += step2_bytes(mem, W, k)
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
    launch_sum_ms = sweep_by_cap(batches, caps, k, ms)
    ops_count = 2 * pairs * W * 32
    t_ops = ops_count / INT8_OPS_PER_S * 1e3
    t_bytes = bytes_count / HBM_BYTES_PER_S * 1e3
    return {"name": "goldfinger_knn", "route": "cuda",
            "source": CLUSTER_KNN_SOURCE, "replaces": CLUSTER_KNN_REPLACES,
            "launches": launches, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "launch_sum_ms": launch_sum_ms,
            "shape": f"Step-2 sweep of ml1M@1.0 k=30: {len(batches)} "
                     f"batches, {pairs} ordered pairs, W={W}"}, err


def sweep_by_cap(batches, caps, k: int, sweep_ms: float) -> float:
    """Where the Step-2 sweep's time goes: the device time of each launch
    (CUDA events around it; median of 5 sweeps), summed per capacity
    group, beside the blocks each launch runs. A sleep kernel ahead of each
    sweep holds the card while the host queues every launch, so an event
    pair spans its launch's device time and none of the host's. The sum
    over all groups against the whole sweep's time leaves the host gap
    between launches. Returns that sum."""
    import torch

    from repro_torch.kernels.goldfinger_knn import ops

    per_launch = []
    for _ in range(5):
        torch.cuda._sleep(SLEEP_CYCLES)
        events = []
        for w, c, i in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ops.cluster_knn(w, c, i, k)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        per_launch.append([s.elapsed_time(e) for s, e in events])
    launch_ms = [statistics.median(t) for t in zip(*per_launch)]
    total = 0.0
    for cap in sorted(set(caps)):
        idx = [j for j, c in enumerate(caps) if c == cap]
        blocks = [ops.launch_params(cap, cap, batches[j][0].shape[2], k)
                  .blocks(batches[j][0].shape[0], cap) for j in idx]
        group_ms = sum(launch_ms[j] for j in idx)
        total += group_ms
        log(f"[timing] cluster-KNN cap {cap}: {len(idx)} launches, "
            f"{statistics.mean(blocks):.1f} blocks per launch "
            f"({min(blocks)}-{max(blocks)}), {group_ms:.4f} ms device")
    log(f"[timing] cluster-KNN launches sum to {total:.4f} ms of device time "
        f"against the sweep's {sweep_ms:.4f} ms: host gap "
        f"{sweep_ms - total:.4f} ms")
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w, c, i in batches:
            ops.cluster_knn(w, c, i, k)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    log(f"[timing] cluster-KNN host clock to queue the {len(batches)} launches: "
        f"{statistics.median(host):.4f} ms (median of 5)")
    return total


def hop_bound(args, n_scored: int, n_counts: int) -> tuple[float, str]:
    """Least time of one hop on this card, for this run's data: the bytes
    each input and output must move (``hop_bytes``) at HBM rate, or the
    scored lanes' intersections as int8 bit-plane products, whichever is
    larger."""
    W = args[2].shape[1]
    ops_count = 2 * n_scored * W * 32
    t_ops = ops_count / INT8_OPS_PER_S * 1e3
    t_bytes = hop_bytes(args, n_counts) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def hop_bytes(args, n_counts: int) -> int:
    """Bytes one hop must move at least: adjacency rows of live beam
    lanes, tombstone flags, one fingerprint row and card per distinct
    scored row, queries, beams, counts (``n_counts`` int32 per query)."""
    from repro_torch.kernels.descent_score import ref

    graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb = args
    q, B = beam_ids.shape
    kg, kr, W = graph.shape[1], rev.shape[1], words.shape[1]
    live_beam = beam_ids[beam_ids >= 0].unique().numel()
    cand = ref.gather_candidates(graph, rev, beam_ids, tomb)
    need = ref.survivors(cand, beam_ids)
    scored_rows = cand[need].unique().numel()
    cand_rows = cand[cand >= 0].unique().numel()
    return (live_beam * (kg + kr) * 4      # adjacency rows
            + (cand_rows + live_beam)       # tombstone flags
            + scored_rows * (4 * W + 4)     # fingerprint rows + card
            + q * (4 * W + 4 + B * 8)       # queries + beams in
            + q * (B * 8 + 4 * n_counts))   # beams + counts out


def time_sharded_hops(engine, launches: dict) -> tuple[dict, float]:
    """One 4-shard, 256-query hop of each kernel at the main path's first
    hop, held bitwise against the plain sharded hop, timed as device time
    (a sleep kernel holds the card while 20 calls queue) beside the plain
    version, S single-shard launches and the bound, and in turns with the
    same hop of a degraded window (shard 1 dead: its beams all PAD); and
    the host clock a wave spends in ``shard_seeds``."""
    args, sd, seeds = first_sharded_hop(engine, 4, 32, 256)
    dead_args, _, _ = first_sharded_hop(engine, 4, 32, 256,
                                        dead=[False, True, False, False])
    host = []
    for _ in range(7):
        t0 = time.perf_counter()
        sd.shard_seeds(seeds)
        host.append((time.perf_counter() - t0) * 1e3)
    err = check_sharded_case("timed: ml1M@1.0 first hop, fleet beam 32",
                             args, 0.0)
    err = check_sharded_case("timed: ml1M@1.0 first hop, fleet beam 32, "
                             "shard 1 dead", dead_args, err)
    graph, rev, words, card, qw, qc, beam, sims, tomb = args
    S, q = beam.shape[:2]
    W = words.shape[-1]
    n_scored = int(sharded_plain(args, False)[2].sum())
    shard_args = [(graph[s], rev[s], words[s], card[s], qw, qc, beam[s],
                   sims[s], tomb[s]) for s in range(S)]
    out = {}
    for name, dma, n_counts in (("descent_hop", False, 1),
                                ("descent_hop_dma", True, 3)):
        ms = [cuda_ms(lambda: sharded_kernel(args, dma), reps=7, inner=20,
                      hold=True)]
        loop = cuda_ms(lambda: shard_by_shard(args, dma), reps=7, inner=20,
                       hold=True)
        dead_ms = [cuda_ms(lambda: sharded_kernel(dead_args, dma), reps=7,
                           inner=20, hold=True) for _ in range(2)]
        ms.append(cuda_ms(lambda: sharded_kernel(args, dma), reps=7,
                          inner=20, hold=True))
        plain = cuda_ms(lambda: sharded_plain(args, dma), reps=5)
        # The queries are read once for all shards.
        nbytes = (sum(hop_bytes(a, n_counts) for a in shard_args)
                  - (S - 1) * q * (4 * W + 4))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n_scored * W * 32 / INT8_OPS_PER_S * 1e3
        out[name] = {"ms": statistics.median(ms), "shard_loop_ms": loop,
                     "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "launches": launches[name],
                     "one_dead_ms": statistics.median(dead_ms)}
        log(f"[timing] sharded {name}, one launch for 4 shards x 256 "
            f"queries (shard beam {beam.shape[-1]}, {n_scored} lanes "
            f"scored): {ms[0]:.4f} / {ms[1]:.4f} ms device time; 4 "
            f"single-shard launches {loop:.4f} ms; plain {plain:.4f} ms; "
            f"bound {out[name]['bound_ms']:.5f} ms by "
            f"{out[name]['bound_by']}; with shard 1 dead (its beams all PAD, "
            f"{int(sharded_plain(dead_args, False)[2].sum())} lanes scored) "
            f"{dead_ms[0]:.4f} / {dead_ms[1]:.4f} ms, timed between the two")
    log(f"[timing] shard_seeds of a 256-query wave (4 shards, "
        f"{seeds.shape[1]} seeds a query): {statistics.median(host):.3f} ms "
        f"host clock (median of 7)")
    return out, err


def time_hops(dev, engine, launches: dict) -> tuple[list, float]:
    """The fused hop and the DMA hop at the first hop of a 256-query wave
    of the main path, each against its plain version, in one call."""
    import torch

    from repro_torch.bench import hop_phases
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query.router import fingerprint_profiles, profiles_to_csr, route
    from repro_torch.query.search import descent_init
    from repro_torch.sketch.goldfinger import words_tensor

    plan = engine.plan
    graph, rev, words, card, tomb = plan.sync()
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
    log("[timing] one 256-query wave (x pallas), host clock, median of 3: "
        + ", ".join(f"{key} {statistics.median(v):.2f} ms"
                    for key, v in stages.items()))
    qw = words_tensor(qgf.words, dev)
    qc = torch.from_numpy(qgf.card).to(dev)
    beam_ids, beam_sims = descent_init(
        words, card, qw, qc, torch.from_numpy(seeds).to(dev),
        beam=plan.beam, tomb=tomb)
    args = (graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb)
    k_out, p_out = hop_kernel(*args), hop_plain(*args)
    d_out, dp_out = dma_kernel(*args), dma_plain(*args)
    if not same_hop(k_out, p_out):
        fail("descent hop at the main path's first wave differs from the "
             "plain version")
    if not (same_hop(d_out, dp_out) and same_hop(d_out[:3], k_out)):
        fail("DMA hop at the main path's first wave differs from the plain "
             "version or from the hop kernel")
    C = beam_ids.shape[1] * (graph.shape[1] + rev.shape[1])
    if not check_dma_counts(d_out, words.shape[1], C):
        fail("DMA hop byte counters disagree with n_scored at the main "
             "path's first wave")
    err = max(max_abs_err(k_out[1], p_out[1]), max_abs_err(d_out[1],
                                                           dp_out[1]))
    log(f"[timing] the main path's first hop: {int(k_out[2].sum())} lanes "
        f"scored, {distinct_rows(args)} rows read by either kernel (one per "
        f"distinct surviving id)")
    # Fused, DMA, DMA, fused: the two kernels in turns within one call,
    # device time (the card held while 20 calls are queued); then the same
    # calls paced by the host's queueing, as a serving loop sees them.
    k_ms = [cuda_ms(lambda: hop_kernel(*args), reps=7, inner=20, hold=True)]
    d_ms = [cuda_ms(lambda: dma_kernel(*args), reps=7, inner=20, hold=True)]
    d_ms.append(cuda_ms(lambda: dma_kernel(*args), reps=7, inner=20,
                        hold=True))
    k_ms.append(cuda_ms(lambda: hop_kernel(*args), reps=7, inner=20,
                        hold=True))
    paced = [cuda_ms(lambda: hop_kernel(*args), reps=7, inner=20),
             cuda_ms(lambda: dma_kernel(*args), reps=7, inner=20)]
    plain_ms = cuda_ms(lambda: hop_plain(*args), reps=5)
    dplain_ms = cuda_ms(lambda: dma_plain(*args), reps=5)
    log(f"[timing] hop kernels in turns (fused, DMA, DMA, fused), device "
        f"time: {k_ms[0]:.4f}, {d_ms[0]:.4f}, {d_ms[1]:.4f}, {k_ms[1]:.4f} "
        f"ms; paced by the host's queueing: fused {paced[0]:.4f}, DMA "
        f"{paced[1]:.4f} ms")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cold = [cold_ms(lambda: hop_kernel(*args), 9, flush),
            cold_ms(lambda: dma_kernel(*args), 9, flush)]
    log(f"[timing] the same hop with L2 flushed before each launch: fused "
        f"{cold[0]:.4f} ms, DMA {cold[1]:.4f} ms")
    hops_beyond_l2(dev, flush)
    ring_sweep(args, flush)
    hop_phases.run(args)

    n_scored = int(k_out[2].sum())
    kg, W = graph.shape[1], words.shape[1]
    shape = (f"first hop of a 256-query ml1M@1.0 wave: n={engine.index.n} "
             f"W={W} B={beam_ids.shape[1]} kg=kr={kg}, {n_scored} lanes "
             f"scored")
    rows = []
    for name, src, rep, count, ms, pms, n_counts in (
            ("descent_hop", HOP_SOURCE, HOP_REPLACES,
             launches["descent_hop"], statistics.median(k_ms), plain_ms, 1),
            ("descent_hop_dma", DMA_SOURCE, DMA_REPLACES,
             launches["descent_hop_dma"], statistics.median(d_ms),
             dplain_ms, 3)):
        bound, by = hop_bound(args, n_scored, n_counts)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": count, "ms": ms,
                     "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "shape": shape})
    return rows, err


def ring_sweep(args, flush) -> None:
    """The DMA hop at the main path's hop over a few ring shapes
    (score_chunk, n_buffers), warm and with the L2 flushed, beside the
    shared memory each block takes and the blocks an SM can hold."""
    from repro_torch.kernels.descent_score import ops, tune

    graph, rev, words = args[:3]
    W, kg, kr, B = (words.shape[1], graph.shape[1], rev.shape[1],
                    args[6].shape[1])
    per_sm = ops._lib().repro_descent_hop_blocks_per_sm(W, kg, kr, B, 0)
    log(f"[timing] fused hop: "
        f"{ops._lib().repro_descent_hop_smem_bytes(W, kg, kr, B, 0)} B/block, "
        f"{per_sm} blocks/SM ({per_sm * HOP_WARPS} warps/SM resident at "
        f"most; a 256-query wave: {256 / 132 * HOP_WARPS:.1f} warps/SM)")
    for chunk, nb in ((32, 2), (64, 2), (64, 3), (128, 1), (128, 2),
                      (256, 2)):
        kw = {"score_chunk": chunk, "n_buffers": nb}
        if not same_hop(dma_kernel(*args, **kw), dma_plain(*args)):
            fail(f"DMA hop with score_chunk={chunk} n_buffers={nb} "
                 f"differs from the plain version")
        smem = tune.smem_bytes(W, kg + kr, B, 1, chunk, nb)
        per_sm = ops._lib_dma().repro_descent_hop_dma_blocks_per_sm(
            W, kg, kr, B, 1, chunk, nb, 0)
        warm = cuda_ms(lambda: dma_kernel(*args, **kw), reps=7, inner=20,
                       hold=True)
        cold = cold_ms(lambda: dma_kernel(*args, **kw), 9, flush)
        log(f"[timing] DMA hop ring score_chunk={chunk} n_buffers={nb}: "
            f"{smem} B/block, {per_sm} blocks/SM ({per_sm * HOP_WARPS} "
            f"warps/SM), {warm:.4f} ms warm, {cold:.4f} ms L2 flushed")


def hops_beyond_l2(dev, flush) -> None:
    """Both hops over a table of 1,000,000 random rows (W=32: 128 MB of
    fingerprints, beyond the 50 MB L2), held bitwise against each other
    and the plain version, then timed in turns with the L2 flushed."""
    import numpy as np

    rng = np.random.default_rng(7)
    args = hop_inputs(rng, dev, 1_000_000, 32, 30, 30, 256, 32)
    d_out, p_out = dma_kernel(*args), dma_plain(*args)
    if not (same_hop(d_out, p_out) and same_hop(d_out[:3],
                                                hop_kernel(*args))):
        fail("hops over the 1,000,000-row table differ")
    ms = {"fused": [], "DMA": []}
    for name in ("fused", "DMA", "DMA", "fused"):
        fn = hop_kernel if name == "fused" else dma_kernel
        ms[name].append(cold_ms(lambda: fn(*args), 9, flush))
    log(f"[timing] both hops over 1,000,000 random rows (128 MB, L2 "
        f"flushed; {int(d_out[2].sum())} lanes scored, "
        f"{int(d_out[3].sum()) / 1e6:.1f} MB gathered), in turns: fused "
        f"{ms['fused'][0]:.4f} / {ms['fused'][1]:.4f} ms, DMA "
        f"{ms['DMA'][0]:.4f} / {ms['DMA'][1]:.4f} ms")


def time_minhash(dev, launches: int) -> tuple[dict, float]:
    """FastRandomHash of ml1M@1.0: the CSR entry (the main path's call)
    against its plain version, both entries on device time (held) and
    paced by the host's queueing, each beside its least time."""
    import numpy as np
    import torch

    from repro_torch.kernels.frh_minhash import ops, ref

    ds, seeds, b = ml1m_minhash_inputs()
    offsets = torch.from_numpy(ds.offsets.astype(np.int64)).to(dev)
    items = torch.from_numpy(ds.items).to(dev)
    padded, mask = ds.padded_profiles()
    x = torch.from_numpy(padded).to(dev)
    got = ops.minhash_csr(offsets, items, seeds, b)
    if not (torch.equal(got, ref.minhash_csr_ref(offsets, items, seeds, b))
            and torch.equal(got, ops.minhash(x, seeds, b))):
        fail("minhash at ml1M@1.0 differs from the plain version or the "
             "padded entry")
    csr = lambda: ops.minhash_csr(offsets, items, seeds, b)  # noqa: E731
    pad = lambda: ops.minhash(x, seeds, b)  # noqa: E731
    # CSR, padded, padded, CSR: held (device time), then host-paced.
    held = {"csr": [], "pad": []}
    for key in ("csr", "pad", "pad", "csr"):
        held[key].append(cuda_ms(csr if key == "csr" else pad, reps=7,
                                 inner=20, hold=True))
    paced = {"csr": cuda_ms(csr, reps=7, inner=20),
             "pad": cuda_ms(pad, reps=7, inner=20)}
    plain_ms = cuda_ms(lambda: ref.minhash_csr_ref(offsets, items, seeds, b),
                       reps=5)
    n, P = padded.shape
    t, nnz = len(seeds), len(ds.items)
    t_ops = nnz * t * MINHASH_OPS / CUDA_CORE_OPS_PER_S * 1e3
    bound = {}
    for key, nbytes in (("csr", nnz * 4 + (n + 1) * 8 + n * t * 4),
                        ("pad", n * P * 4 + n * t * 4)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound[key] = (max(t_bytes, t_ops),
                      "operations" if t_ops >= t_bytes else "bytes")
    log(f"[timing] frh_minhash padded entry (n={n} P={P}, {int(mask.sum())} "
        f"items, t={t}): device time {held['pad'][0]:.5f} / "
        f"{held['pad'][1]:.5f} ms held, {paced['pad']:.5f} ms paced; bound "
        f"{bound['pad'][0]:.5f} ms by {bound['pad'][1]}")
    log(f"[timing] frh_minhash CSR entry: device time {held['csr'][0]:.5f} / "
        f"{held['csr'][1]:.5f} ms held, {paced['csr']:.5f} ms paced; bound "
        f"{bound['csr'][0]:.5f} ms by {bound['csr'][1]}")
    return {"name": "frh_minhash", "route": "cuda", "source": MINHASH_SOURCE,
            "replaces": MINHASH_REPLACES, "launches": launches,
            "ms": statistics.median(held["csr"]), "plain_ms": plain_ms,
            "bound_ms": bound["csr"][0], "bound_by": bound["csr"][1],
            "library_ms": None,
            "shape": f"ml1M@1.0 CSR profiles n={n} ({nnz} items), t={t}, "
                     f"b={b}, device time"}, 0.0


def tick_breakdown(engine) -> None:
    """Host clock per phase of continuous ticks (256 slots, DMA hop) over
    512 queries: admission (fingerprints, routing, slot init), the hop,
    and the completion snapshot; the rest is scheduler bookkeeping."""
    import torch

    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query import plan as plan_mod
    from repro_torch.query.engine import QueryEngine, QueryRequest

    eng = QueryEngine(engine.index, engine.qc, device=engine.device)
    plan = eng.plan
    spent = {"admit": 0.0, "hop": 0.0, "snapshot": 0.0}

    def timed(key, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    plan._admit = timed("admit", plan._admit)
    plan._slot_results = timed("snapshot", plan._slot_results)
    slot_hop = plan_mod.slot_hop
    plan_mod.slot_hop = timed("hop", slot_hop)
    try:
        qds = make_dataset("ml1M", scale=1.0, seed=2)
        for rid in range(512):
            eng.submit(QueryRequest(rid=rid, profile=qds.profile(rid)))
        t0 = time.perf_counter()
        stats = eng.run()
        total = time.perf_counter() - t0
    finally:
        plan_mod.slot_hop = slot_hop
    ticks = stats["waves"]
    rest = total - sum(spent.values())
    log(f"[timing] continuous x pallas_dma, 256 slots, 512 queries in "
        f"{ticks} ticks, host clock per tick: "
        + ", ".join(f"{k} {v / ticks * 1e3:.2f} ms"
                    for k, v in spent.items())
        + f", other {rest / ticks * 1e3:.2f} ms")


# Phase 4f's figures under short keys, for the line printed just before
# the last, where the tail of a run's log keeps them.
TAIL_KEYS = {"seconds": "s", "quality": "q", "launches": "n", "iters": "it",
             "updates": "upd", "n_buckets": "buckets", "max_bucket": "max",
             "hyrec_buckets": "hyrec", "n_clusters": "clusters",
             "sims": "sims", "hyrec_clusters": "hyrec",
             "speedup_vs_best_baseline": "x", "incidence_seconds": "inc_s"}


def tail_summary(slice10: dict, ck_row: dict, lm: dict, lm4h: dict,
                 lm4i: dict, lm4j: dict, lm4l: dict) -> dict:
    """Phase 4f's times, qualities and counts, the cluster-KNN row's times
    (main-path sweep, its launches' device time, the raw sweep), phase
    4g's LM serving figures, phase 4h's OLMoE figures, phase 4i's
    training figures, phase 4j's agreement and peaks and phase 4l's
    step ms and peaks of both sides."""
    def r(x):
        return round(x, 4) if isinstance(x, float) else x

    out = {"s": r(slice10["seconds"])}
    for label in ("ml1M@1.0", "ml1M@0.35", "AM@0.055"):
        row = slice10[label]
        out[label] = {name: {TAIL_KEYS[key]: r(v) for key, v in d.items()
                             if key in TAIL_KEYS}
                      for name, d in row.items()
                      if isinstance(d, dict)
                      and name not in ("raw_sweep", "cpu_seconds")}
        if "cpu_seconds" in row:
            out[label]["cpu_s"] = {n: r(v)
                                   for n, v in row["cpu_seconds"].items()}
    raw = ck_row["raw"]
    lm_short = {key: r(lm[key]) for key in (
        "prefill_8x512_ms", "decode_batch8_ms", "decode_slots8_ms",
        "peak_gb")}
    lm_short["tok_s"] = {k: r(v) for k, v in lm["tokens_per_s"].items()}
    lm_short["bound_ms"] = r(lm["decode_bound"]["ms"])
    olmoe = lm4h["olmoe-1b-7b"]
    olmoe_short = {"tok_s": {k: r(v) for k, v in
                             olmoe["tokens_per_s"].items()},
                   "decode_ms": r(olmoe["decode_batch8_ms"]),
                   "decode_paced_ms": r(olmoe["decode_batch8_paced_ms"]),
                   "bound_ms": {
                       "all_experts": r(olmoe["decode_bound"]["ms"]),
                       "chosen_experts": r(olmoe[
                           "decode_bound_chosen_experts"]["ms"])},
                   "s": r(lm4h["seconds"])}
    ck_short = {"ms": r(ck_row["ms"]),
                "launch_sum_ms": r(ck_row["launch_sum_ms"]),
                "raw": {key: r(raw[key]) for key in (
                    "launches", "ms", "plain_ms", "bound_ms", "bound_by")}}
    full = lm4i["full"]
    train_short = {"losses": [r(x) for x in full["losses"]],
                   "step_ms": r(full["step_ms_median_last5"]),
                   "tok_s": r(full["tokens_per_s"]),
                   "peak_gb": r(full["peak_gb"]),
                   "idle": r(full["profile"]["idle_share"]),
                   "kernels": full["profile"]["kernels"],
                   "bound_ms": r(full["bound"]["ms"]),
                   "ckpt_gb": r(full["checkpoint"]["bytes"] / 1e9),
                   "save_s": r(full["checkpoint"]["save_s"]),
                   "restore_s": r(full["checkpoint"]["restore_s"]),
                   "restart_diff": {
                       arch: rs["final_loss_diff"]
                       for arch, rs in lm4i["restart"].items()},
                   "s": r(lm4i["seconds"])}
    analysis_short = {
        "flops_equal": all(r["flops_equal"] for r in lm4j["steps"].values()),
        "train_peak_gb": {k: r(v) for k, v in lm4j["train_peak"].items()},
        "mesh_peak_gb": {k: r(p["peak_gb"]) for k, p in
                         lm4j["mesh_predictions"].items()},
        "s": r(lm4j["seconds"])}
    mesh_short = {side: {"step_ms": [r(x) for x in t["step_ms"]],
                         "peak_gb": r(t["peak_gb"])}
                  for side, t in lm4l["train"].items()
                  if side in ("unsharded", "sharded")}
    mesh_short["bitwise_leaves"] = lm4l["train"]["leaves_bitwise"]
    mesh_short["s"] = r(lm4l["seconds"])
    return {"phase_4f": out, "lm_serve": lm_short, "olmoe": olmoe_short,
            "goldfinger_knn": ck_short, "lm_train": train_short,
            "lm_analysis": analysis_short, "lm_mesh": mesh_short}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.bench import hop_phases
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase_s = {}
    t0 = time.perf_counter()
    # Phase 5's probed hop copies (``bench.hop_phases``) compile beside the
    # kernels, one nvcc each, all at once.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        probes = pool.submit(hop_phases.prebuild)
        report = build.build()
        probes.result()
    log(f"[build] {len(report)} kernels and phase 5's "
        f"{len(hop_phases.copies())} hop copies in "
        f"{time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k}: {v['seconds']:.1f} s" for k, v in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    lap = time.perf_counter()
    phase_s["2"] = lap - t0

    def took(key):
        nonlocal lap
        now = time.perf_counter()
        phase_s[key] = now - lap
        lap = now

    n_ck, err_ck = check_cluster_knn(dev)
    n_wide, err_wide = check_cluster_knn_wide(dev)
    n_hop, err_hop = check_hop(dev)
    n_dma, err_dma = check_dma_hop(dev)
    n_shapes, err_shapes = check_hop_shapes(dev)
    n_shard, err_shard = check_sharded_hops(dev)
    n_dead, err_dead = check_dead_shard_hops(dev)
    n_mh, err_mh = check_minhash(dev)
    log(f"[kernels] {n_ck} cluster-KNN ({n_wide} more at chunked widths), "
        f"{n_hop} hop, {n_dma} DMA-hop, "
        f"{n_shapes} two-hop, {n_shard} sharded two-hop, {n_dead} all-PAD-"
        f"shard two-hop and {n_mh} minhash cases bitwise equal to the plain "
        f"versions")
    took("3")

    made: dict = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(datasets_made_once(made))
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        small_build_matches_cpu()
        run = main_path(dev, Path(tmp))
        took("4")
        bf = mutable_index(dev, run, Path(tmp))
        took("4b")
        shard = sharded_placement(dev, run)
        took("4c")
        slice8 = slo_cache_rebalance(dev, run, shard)
        took("4d")
        slice9 = faults_and_recovery(dev, run, shard, Path(tmp))
        took("4e")
        slice10 = baselines_and_raw_mode(dev)
        took("4f")
        mesh = one_device_per_shard(dev, run, shard, slice9)
        took("4k")
        launches = run["launches"]
        ck_row, err_ck_main = time_cluster_knn(
            dev, run["built"], run["engine"].index, launches["goldfinger_knn"])
        (hop_row, dma_row), err_hops = time_hops(dev, run["engine"],
                                                 launches)
        shard_launches = {
            "descent_hop": shard["launches"]["--shards 4 wave x pallas"][
                "descent_hop_sharded"],
            "descent_hop_dma": shard["launches"][
                "--shards 4 continuous x pallas_dma"][
                "descent_hop_dma_sharded"]}
        shard_rows, err_shard_main = time_sharded_hops(shard["engine"],
                                                       shard_launches)
        mh_row, err_mh_main = time_minhash(dev, launches["frh_minhash"])
        tick_breakdown(run["cont_engine"])
        build_stages(run["engine"])
        took("5")
    # Phase 4j's mesh predictions count on the CPU while 4g-4i run.
    mesh_proc = start_mesh_predictions()
    lm = lm_serving(dev, smi)
    took("4g")
    lm4h = lm_moe_recurrent(dev, smi)
    took("4h")
    lm4i = lm_training(dev, smi)
    took("4i")
    lm4j = lm_analysis(dev, smi, lm4i, mesh_proc)
    took("4j")
    lm4l = lm_mesh(dev, smi, lm4j["mesh_predictions"][mesh_key((1, 1))])
    took("4l")
    ck_row["max_abs_err"] = max(err_ck, err_wide, err_ck_main, bf["err"],
                                slice10["AM@0.055"].pop("raw_err"))
    # Phase 4f: the raw-mode build's Step-2 sweep (W = 5,355 on AM@0.055),
    # its launches counted from 0 on that build.
    ck_row["raw"] = slice10["AM@0.055"]["raw_sweep"]
    hop_row["max_abs_err"] = max(err_hop, err_shapes, err_hops, err_shard,
                                 err_dead, shard["err"], err_shard_main)
    dma_row["max_abs_err"] = max(err_dma, err_shapes, err_hops, err_shard,
                                 err_dead, shard["err"], err_shard_main)
    # The sharded placement's launches (its own path: --shards 4, wave x
    # pallas for the fused hop, continuous x pallas_dma for the DMA hop)
    # and its one-launch 4-shard hop's device time and bound.
    for row in (hop_row, dma_row):
        sh = shard_rows[row["name"]]
        row["sharded"] = {"launches": sh["launches"], "ms": sh["ms"],
                          "plain_ms": sh["plain_ms"],
                          "bound_ms": sh["bound_ms"],
                          "bound_by": sh["bound_by"],
                          "one_dead_ms": sh["one_dead_ms"]}
    # Phases 4d's and 4e's launches of each hop, path by path (each counted
    # from 0).
    for row in (hop_row, dma_row):
        for key, phase in (("phase_4d", slice8), ("phase_4e", slice9)):
            row[key] = {label: c[row["name"]] for label, c in
                        phase["launches"].items() if c[row["name"]]}
    mh_row["max_abs_err"] = max(err_mh, err_mh_main)
    # Build Step 1's table through the distinct entry: one launch a
    # build_plan on the card (phase 4's build included), device time and
    # bound at ml1M@1.0 and at c2-ml10M.
    mh_row["distinct"] = {
        "main path build": run["launches"]["frh_minhash_distinct"],
        **run["distinct"]}
    # Phase 4i: the training path's c2 order (one pipeline a run), its
    # launches counted from 0 (held bitwise to the host's order).
    mh_row["phase_4i"] = {
        "launch/train llama3.2-1b --data-order c2": lm4i["full"]["launches"][
            "frh_minhash"],
        "restarts at 2 layers (llama, olmoe), 6 runs": lm4i[
            "restart_launches"]["frh_minhash"]}
    # Phase 4k: the per-device layout's launches (each path counted from
    # 0; the hop one launch a shard a hop) and the examples'.
    ex = mesh["examples"]
    ck_row["phase_4k"] = {
        "distributed_c2 ml1M@1.0 over 4 bins": mesh["build"]["launches"],
        "per bin": mesh["build"]["per_bin"],
        **{f"examples/{n}.py": e["launches"]["goldfinger_knn"]
           for n, e in ex.items() if e["launches"]["goldfinger_knn"]}}
    for row in (hop_row, dma_row):
        row["phase_4k"] = {
            **{label: c[row["name"]] for label, c in
               mesh["launches"].items() if c[row["name"]]},
            **{f"examples/{n}.py": e["launches"][row["name"]]
               for n, e in ex.items() if e["launches"][row["name"]]},
            "4 per-device launches, one 256-query hop: ms":
                mesh["hops"][row["name"]]["per_device"],
            "one launch for the 4 shards: ms":
                mesh["hops"][row["name"]]["one_launch"]}
    mh_row["phase_4k"] = {"examples/train_lm_torch.py --steps 20":
                          ex["train_lm_torch"]["launches"]["frh_minhash"]}
    # Phase 4l: the one-rank mesh's path (train, serve, restore), its
    # launches counted from 0: the training batches' c2 order.
    mh_row["phase_4l"] = {
        "Llama-3.2-1B train_step(ctx, grad_shardings), c2 batches":
            lm4l["launches"]["frh_minhash"]}
    rows = [ck_row, hop_row, dma_row, mh_row]
    for name, st in list(run["serves"].items()) + list(
            shard["serves"].items()):
        log(f"[timing] serve 2,048 queries, {name}: QPS {st['qps']:.1f}, "
            f"p50 {st['p50_latency_s'] * 1e3:.2f} ms, "
            f"p95 {st['p95_latency_s'] * 1e3:.2f} ms")
    for row in rows:
        log(f"[timing] {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms by "
            f"{row['bound_by']}) over {row.pop('shape')}")
    log(datasets_line(made))
    phase_s["all"] = time.perf_counter() - t_start
    log(f"[done] {phase_s['all']:.1f} s; by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()
                    if k != "all") + " s")
    # Phase 4e's figures near the end, where the tail of a run's log keeps
    # them.
    print(json.dumps({"phase_4e": slice9["numbers"],
                      "phase_4e_seconds": slice9["seconds"]},
                     default=lambda o: o.tolist()))
    print(json.dumps({"phase_4f": slice10}, default=lambda o: o.tolist()))
    print(json.dumps({"lm_serve": lm}))
    print(json.dumps({"lm_serve_4h": lm4h}, default=lambda o: o.tolist()))
    print(json.dumps({"lm_train": lm4i}, default=lambda o: o.tolist()))
    print(json.dumps({"lm_analysis": lm4j}))
    print(json.dumps({"lm_mesh": {k: v for k, v in lm4l.items()}},
                     default=lambda o: o.tolist()))
    print(json.dumps({"phase_4k": {k: v for k, v in mesh.items()
                                   if k != "launches"},
                      "phase_seconds": phase_s},
                     default=lambda o: o.tolist()))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps(tail_summary(slice10, ck_row, lm, lm4h, lm4i, lm4j,
                                  lm4l),
                     separators=(",", ":"), default=lambda o: o.tolist()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
