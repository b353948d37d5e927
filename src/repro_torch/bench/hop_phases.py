"""Where a descent-hop block spends its cycles, on the card.

    PYTHONPATH=src python3 -m repro_torch.bench.hop_phases [--csrc DIR]

Copies ``csrc/descent_hop.cu`` and ``csrc/descent_hop_dma.cu`` with
``clock64()`` probes added at fixed places (each place must occur once, or
the script stops), builds each copy into ``repro_torch/_build/phases/``,
and launches it on the first hop of a 256-query wave of the main path
(ml1M@1.0 built with the paper's k = 30, beam 32, the first 256 unseen
profiles of seed 1 routed and scored into their initial beams). Prints,
per kernel, each block's mean cycles by phase: beam staging, candidate
ids, suppression, row loads + popcounts (for the DMA hop: its ring's copy
issue, waits and scoring) and selection. The shipped kernels
carry no probe. The probes cost a few cycles each, and a probe placed
after a load waits for it, so per-lane phases are charged their own
latency.

Each kernel is also built as it is (no probe) and timed on device time
(a sleep kernel holds the card while 20 launches are queued behind it).
``--csrc DIR`` (repeatable) probes and times the kernel sources of other
checkouts (their ``src/repro_torch/csrc``), e.g. the parent commit
unpacked by ``git archive``, in turns within one run; both the present
kernels' anchors and those of the kernels before their Hopper redesign
(one block per query, 32 selection rounds) are known, and a tree that
matches neither is timed only. Every output must equal the plain version
bit for bit. Needs a CUDA card; prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.descent_score import ref, tune

SLOTS = 16  # int64 counters per block

PRELUDE = r"""
__device__ unsigned long long* g_phases;
// The clock after `dep` is known: a probe placed after a load waits for it.
__device__ __forceinline__ unsigned long long probe_clock(unsigned dep) {
  unsigned long long t;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0xDEADBEEF;\n\t"
               "@p trap;\n\tmov.u64 %0, %%clock64;\n\t}"
               : "=l"(t) : "r"(dep) : "memory");
  return t;
}
"""

# Per probe set: the kernel's source file, the phases it reports (name,
# slot, and the slot of the thread count it is averaged over, or None for
# a block's own span), and (anchor, replacement) pairs applied in order;
# every anchor must occur exactly once. Slot 0 holds the block's thread
# count. The ROUNDS_* sets probe the kernels as they were before their
# Hopper redesign (one 256-thread block per query, a serial suppression
# loop, 32 block-wide selection rounds), the others the present ones.
ROUNDS_FUSED = {
    "file": "descent_hop.cu",
    "phases": (("beam staging", 1, None),
               ("candidate ids + tombstones", 3, 0),
               ("suppression", 4, 0),
               ("row loads + popcounts", 5, 0),
               ("[lane loop, block span]", 2, None),
               ("selection", 6, None)),
    "probes": (
        ('#include "hop_common.cuh"\n', '#include "hop_common.cuh"\n'
         + PRELUDE),
        ("  const float ninf = repro::neg_inf();\n",
         "  const float ninf = repro::neg_inf();\n"
         "  unsigned long long t0 = clock64(), c_cand = 0, c_supp = 0, "
         "c_score = 0;\n"),
        ("  // (2) gather candidate ids, suppress, score the survivors.\n",
         "  const unsigned long long t1 = clock64();\n"
         "  // (2) gather candidate ids, suppress, score the survivors.\n"),
        ("    const int id =\n        repro::hop::candidate_id(graph, rev, "
         "tomb, s_id, c, B, kg, kr);\n",
         "    const unsigned long long ta = clock64();\n"
         "    const int id =\n        repro::hop::candidate_id(graph, rev, "
         "tomb, s_id, c, B, kg, kr);\n"
         "    const unsigned long long tb = probe_clock(id);\n"
         "    c_cand += tb - ta;\n"),
        ("    if (repro::hop::survives(id, s_id, B)) {\n",
         "    const bool surv = repro::hop::survives(id, s_id, B);\n"
         "    const unsigned long long tc = probe_clock(surv);\n"
         "    c_supp += tc - tb;\n"
         "    if (surv) {\n"),
        ("      sim = repro::jaccard_sim(inter, qcard, card[id]);\n    }\n",
         "      sim = repro::jaccard_sim(inter, qcard, card[id]);\n    }\n"
         "    c_score += probe_clock(__float_as_uint(sim)) - tc;\n"),
        ("  // (3) B rounds of (max sim, min column) with winner-id "
         "retirement.\n",
         "  const unsigned long long t2 = clock64();\n"
         "  // (3) B rounds of (max sim, min column) with winner-id "
         "retirement.\n"),
        ("                          out_sims + q * B, scr);\n}\n",
         "                          out_sims + q * B, scr);\n"
         f"  unsigned long long* o = g_phases + blockIdx.x * {SLOTS};\n"
         "  atomicAdd(o + 3, c_cand);\n  atomicAdd(o + 4, c_supp);\n"
         "  atomicAdd(o + 5, c_score);\n"
         "  if (threadIdx.x == 0) {\n"
         "    o[0] = blockDim.x; o[1] = t1 - t0; o[2] = t2 - t1;\n"
         "    o[6] = clock64() - t2;\n  }\n}\n"),
    ),
}

ROUNDS_DMA = {
    "file": "descent_hop_dma.cu",
    "phases": (("beam staging", 1, None),
               ("candidate ids + tombstones", 4, 0),
               ("suppression", 5, 0),
               ("[id loop, block span]", 2, None),
               ("copy issue", 6, 0),
               ("copy wait", 7, 0),
               ("scoring", 8, 0),
               ("[ring, block span]", 3, None),
               ("selection", 9, None)),
    "probes": (
        ('#include "hop_common.cuh"\n', '#include "hop_common.cuh"\n'
         + PRELUDE),
        ("  const float ninf = repro::neg_inf();\n",
         "  const float ninf = repro::neg_inf();\n"
         "  unsigned long long t0 = clock64(), c_cand = 0, c_supp = 0, "
         "c_issue = 0, c_wait = 0, c_score = 0;\n"),
        ("  // (2) candidate ids and suppression flags; no fingerprint is "
         "read here.\n",
         "  const unsigned long long t1 = clock64();\n"
         "  // (2) candidate ids and suppression flags; no fingerprint is "
         "read here.\n"),
        ("    const int id =\n        repro::hop::candidate_id(graph, rev, "
         "tomb, beam, c, B, kg, kr);\n",
         "    const unsigned long long ta = clock64();\n"
         "    const int id =\n        repro::hop::candidate_id(graph, rev, "
         "tomb, beam, c, B, kg, kr);\n"
         "    const unsigned long long tb = probe_clock(id);\n"
         "    c_cand += tb - ta;\n"),
        ("    s_need[x] = repro::hop::survives(id, beam, B);\n",
         "    const bool surv = repro::hop::survives(id, beam, B);\n"
         "    c_supp += probe_clock(surv) - tb;\n"
         "    s_need[x] = surv;\n"),
        ("  // (3) chunked scoring through the ring.\n",
         "  const unsigned long long t2 = clock64();\n"
         "  // (3) chunked scoring through the ring.\n"),
        ("  for (int ci = 0; ci < n_buffers - 1; ++ci) {\n"
         "    if (ci < n_chunks) issue(ci);\n    cp_async_commit();\n  }\n",
         "  const unsigned long long tp = clock64();\n"
         "  for (int ci = 0; ci < n_buffers - 1; ++ci) {\n"
         "    if (ci < n_chunks) issue(ci);\n    cp_async_commit();\n  }\n"
         "  c_issue += clock64() - tp;\n"),
        ("    if (ci + n_buffers - 1 < n_chunks) issue(ci + n_buffers - 1);\n"
         "    cp_async_commit();\n    wait_ring(n_buffers);\n"
         "    __syncthreads();\n    score(ci);\n",
         "    const unsigned long long ta = clock64();\n"
         "    if (ci + n_buffers - 1 < n_chunks) issue(ci + n_buffers - 1);\n"
         "    cp_async_commit();\n"
         "    const unsigned long long tb = clock64();\n"
         "    c_issue += tb - ta;\n"
         "    wait_ring(n_buffers);\n    __syncthreads();\n"
         "    const unsigned long long tc = clock64();\n"
         "    c_wait += tc - tb;\n"
         "    score(ci);\n    c_score += clock64() - tc;\n"),
        ("  // (4) the new beams, one query at a time over the whole block.\n",
         "  const unsigned long long t3 = clock64();\n"
         "  // (4) the new beams, one query at a time over the whole block.\n"),
        ("                            scr);\n}\n",
         "                            scr);\n"
         f"  unsigned long long* o = g_phases + blockIdx.x * {SLOTS};\n"
         "  atomicAdd(o + 4, c_cand);\n  atomicAdd(o + 5, c_supp);\n"
         "  atomicAdd(o + 6, c_issue);\n  atomicAdd(o + 7, c_wait);\n"
         "  atomicAdd(o + 8, c_score);\n"
         "  if (threadIdx.x == 0) {\n"
         "    o[0] = blockDim.x; o[1] = t1 - t0; o[2] = t2 - t1;\n"
         "    o[3] = t3 - t2; o[9] = clock64() - t3;\n  }\n}\n"),
    ),
}

FUSED = {
    "file": "descent_hop.cu",
    "phases": (("beam staging", 1, None),
               ("candidate ids + hash inserts", 2, None),
               ("suppression + tombstones + dedup (table scan)", 3, None),
               ("row loads + popcounts", 4, None),
               ("selection", 5, None)),
    "probes": (
        ('#include "hop_common.cuh"\n', '#include "hop_common.cuh"\n'
         + PRELUDE),
        ("  // (1) beam staging.\n",
         "  const unsigned long long t0 = clock64();\n"
         "  // (1) beam staging.\n"),
        ("  // (2) candidate ids, into the hash table.\n",
         "  const unsigned long long t1 = clock64();\n"
         "  // (2) candidate ids, into the hash table.\n"),
        ("  // (3) suppression, tombstones and one owner lane per id.\n",
         "  const unsigned long long t2 = clock64();\n"
         "  // (3) suppression, tombstones and one owner lane per id.\n"),
        ("  // (4) row loads + popcounts of the owners",
         "  const unsigned long long t3 = clock64();\n"
         "  // (4) row loads + popcounts of the owners"),
        ("  // (5) selection.\n",
         "  const unsigned long long t4 = clock64();\n"
         "  // (5) selection.\n"),
        ("  repro::hop::select_beam<P>(B, s, out_ids + q * B, out_sims + q * B);"
         "\n}\n",
         "  repro::hop::select_beam<P>(B, s, out_ids + q * B, out_sims + q * B);"
         "\n  if (threadIdx.x == 0) {\n"
         f"    unsigned long long* o = g_phases + blockIdx.x * {SLOTS};\n"
         "    o[0] = blockDim.x; o[1] = t1 - t0; o[2] = t2 - t1;\n"
         "    o[3] = t3 - t2; o[4] = t4 - t3; o[5] = clock64() - t4;\n"
         "  }\n}\n"),
    ),
}

DMA = {
    "file": "descent_hop_dma.cu",
    "phases": (("beam staging", 1, None),
               ("candidate ids + hash inserts", 2, None),
               ("suppression + tombstones + dedup (table scan)", 3, None),
               ("ring: a producer waits for empty stages", 7, 11),
               ("ring: a producer issues copies", 6, 11),
               ("ring: consumers wait for full stages", 8, 10),
               ("ring: consumers score", 9, 10),
               ("[ring, block span]", 4, None),
               ("selection", 5, None)),
    "probes": (
        ('#include "hop_common.cuh"\n', '#include "hop_common.cuh"\n'
         + PRELUDE),
        ("  int used = 0;\n",
         "  int used = 0;\n"
         "  unsigned long long c_stage = 0, c_ids = 0, c_supp = 0, c_ring = 0,"
         " c_sel = 0, c_issue = 0, c_ewait = 0, c_fwait = 0, c_score = 0;\n"),
        ("    __syncthreads();\n    repro::hop::stage_beam(",
         "    __syncthreads();\n"
         "    const unsigned long long p0 = clock64();\n"
         "    repro::hop::stage_beam("),
        ("    // (2) candidate ids, into the hash table.\n",
         "    const unsigned long long p1 = clock64();\n    c_stage += p1 - p0;\n"
         "    // (2) candidate ids, into the hash table.\n"),
        ("    // (3) suppression, tombstones and one owner lane per id.\n",
         "    const unsigned long long p2 = clock64();\n    c_ids += p2 - p1;\n"
         "    // (3) suppression, tombstones and one owner lane per id.\n"),
        ("    // (4) the owners' rows through the ring;",
         "    const unsigned long long p3 = clock64();\n    c_supp += p3 - p2;\n"
         "    // (4) the owners' rows through the ring;"),
        ("        mbar_wait(empty + slot, ((used / n_buffers) & 1) ^ 1);\n",
         "        const unsigned long long ta = clock64();\n"
         "        mbar_wait(empty + slot, ((used / n_buffers) & 1) ^ 1);\n"
         "        const unsigned long long tb = clock64();\n"
         "        c_ewait += tb - ta;\n"),
        ("          cp_async_arrive(full + slot);\n        }\n",
         "          cp_async_arrive(full + slot);\n        }\n"
         "        c_issue += clock64() - tb;\n"),
        ("        mbar_wait(full + slot, (used / n_buffers) & 1);\n",
         "        const unsigned long long ta = clock64();\n"
         "        mbar_wait(full + slot, (used / n_buffers) & 1);\n"
         "        const unsigned long long tb = clock64();\n"
         "        c_fwait += tb - ta;\n"),
        ("        __syncwarp();\n        if (lane == 0) mbar_arrive(empty + slot);\n",
         "        c_score += clock64() - tb;\n"
         "        __syncwarp();\n        if (lane == 0) mbar_arrive(empty + slot);\n"),
        ("    // (5) selection.\n",
         "    const unsigned long long p4 = clock64();\n    c_ring += p4 - p3;\n"
         "    // (5) selection.\n"),
        ("    repro::hop::select_beam<P>(B, s, out_ids + qi * B, out_sims + qi * B);"
         "\n  }\n}\n",
         "    repro::hop::select_beam<P>(B, s, out_ids + qi * B, out_sims + qi * B);"
         "\n    c_sel += clock64() - p4;\n  }\n"
         f"  unsigned long long* o = g_phases + blockIdx.x * {SLOTS};\n"
         "  if (warp < kConsumers) {\n"
         "    atomicAdd(o + 8, c_fwait);\n    atomicAdd(o + 9, c_score);\n"
         "    atomicAdd(o + 10, 1ull);\n  } else if (lane == 0) {\n"
         "    atomicAdd(o + 6, c_issue);\n    atomicAdd(o + 7, c_ewait);\n"
         "    atomicAdd(o + 11, 1ull);\n  }\n"
         "  if (tid == 0) {\n"
         "    o[0] = blockDim.x; o[1] = c_stage; o[2] = c_ids; o[3] = c_supp;\n"
         "    o[4] = c_ring; o[5] = c_sel;\n  }\n}\n"),
    ),
}

PROBE_SETS = {"descent_hop": (FUSED, ROUNDS_FUSED),
              "descent_hop_dma": (DMA, ROUNDS_DMA)}


def probed_source(csrc: Path, kernel: str):
    """The kernel's source with the probes of the first probe set whose
    anchors all occur exactly once, and that set; (None, None) if none
    does."""
    src = (csrc / PROBE_SETS[kernel][0]["file"]).read_text()
    for pset in PROBE_SETS[kernel]:
        if all(src.count(a) == 1 for a, _ in pset["probes"]):
            for anchor, text in pset["probes"]:
                src = src.replace(anchor, text)
            return src + (
                "\nREPRO_EXPORT int repro_set_phases(void* p) {\n"
                "  return static_cast<int>(cudaMemcpyToSymbol(g_phases, &p, "
                "sizeof(p)));\n}\n"), pset
    return None, None


def compile_copy(csrc: Path, kernel: str, tag: str,
                 src: str | None = None) -> Path:
    """Compile ``src`` (default: the kernel's source in ``csrc``, as it is)
    into ``_build/phases/<tag>-<digest>/`` against the headers of ``csrc``.
    The digest hashes the flags, the text and the shared headers, as
    ``kernels/build.py`` does, so a copy already compiled from the same
    inputs is kept and any other change compiles anew. Returns the
    library's path."""
    text = src if src is not None else (csrc / f"{kernel}.cu").read_text()
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    h.update(text.encode())
    for name in build.HEADERS:
        header = csrc / name
        if header.exists():
            h.update(name.encode())
            h.update(header.read_bytes())
    out_dir = build.BUILD_DIR / "phases" / f"{tag}-{h.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{kernel}.cu"
    lib_path = out_dir / f"lib{kernel}.so"
    if lib_path.exists():
        return lib_path
    path.write_text(text)
    tmp = lib_path.with_name(lib_path.name + ".tmp")
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(csrc), "-o", str(tmp), str(path)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n"
                           f"{done.stdout}{done.stderr}")
    tmp.replace(lib_path)
    spills = {line.strip() for line in (done.stdout + done.stderr).splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes")}
    if spills:
        print(f"[phases] {path}: " + "; ".join(sorted(spills)), flush=True)
    return lib_path


def copies(csrcs=(None,)) -> list:
    """Every copy :func:`run` builds: (csrc, kernel, tag, source or None),
    the kernels as they are and their probed copies."""
    out = []
    for t, csrc in enumerate(csrcs):
        csrc = Path(csrc) if csrc is not None else build.CSRC
        for kernel in ("descent_hop", "descent_hop_dma"):
            out.append((csrc, kernel, f"t{t}", None))
            src, pset = probed_source(csrc, kernel)
            if pset is not None:
                out.append((csrc, kernel, f"t{t}p", src))
    return out


def prebuild(csrcs=(None,)) -> None:
    """Compile every copy of :func:`run` at once, one ``nvcc`` each (run
    beside the kernels' own build, it takes none of ``run``'s time)."""
    jobs = copies(csrcs)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(compile_copy, *job) for job in jobs]:
            f.result()


def build_copy(csrc: Path, kernel: str, tag: str, src: str | None = None):
    """:func:`compile_copy`, loaded."""
    lib = ctypes.CDLL(str(compile_copy(csrc, kernel, tag, src)))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def first_hop_args(engine, dev):
    """The first hop's inputs of a 256-query wave of ``engine`` (a
    ``QueryEngine`` over the ml1M@1.0 index): routed seeds of the first
    256 unseen profiles (seed 1), scored into their initial beams."""
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.query.router import (fingerprint_profiles,
                                          profiles_to_csr, route)
    from repro_torch.query.search import descent_init
    from repro_torch.sketch.goldfinger import words_tensor

    plan = engine.plan
    graph, rev, words, card, tomb = plan.sync()
    qds = make_dataset("ml1M", scale=1.0, seed=1)
    profiles = [qds.profile(u) for u in range(plan.spec.max_wave)]
    items, offsets = profiles_to_csr(profiles)
    qgf = fingerprint_profiles(items, offsets, engine.index.n_bits,
                               engine.index.fp_seed)
    seeds = route(engine.index, items, offsets, plan.spec.seeds_per_config)
    qw = words_tensor(qgf.words, dev)
    qc = torch.from_numpy(qgf.card).to(dev)
    beam_ids, beam_sims = descent_init(
        words, card, qw, qc, torch.from_numpy(seeds).to(dev),
        beam=plan.beam, tomb=tomb)
    return (graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb)


def device_ms(launch, reps: int = 7, inner: int = 20) -> float:
    """Median device time of one launch: a sleep kernel holds the card
    while ``inner`` launches are queued behind it, then events span them."""
    import statistics

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(inner):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def run(args, csrcs=(None,)) -> dict:
    """Probe both hop kernels of each source tree in ``csrcs`` (None: this
    checkout's) at the hop ``args`` (the wrapper's argument order: graph,
    rev, words, card, q_words, q_card, beam_ids, beam_sims, tomb): each
    kernel built as it is and timed on device time, then its probed copy
    launched where a probe set's anchors match. Every output must equal
    the plain version. Returns ``{(tree, kernel): {"ms": ..., phase: mean
    cycles per block}}`` and prints one line per kernel and tree."""
    graph, rev, words, card, qw, qc, beam_ids, beam_sims, tomb = args
    dev = beam_ids.device
    q, B = beam_ids.shape
    n, kg = graph.shape
    kr, W = rev.shape[1], words.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    want_ids, want_sims = ref.descent_hop_ref(graph, rev, words, card, qw, qc,
                                              beam_ids, beam_sims, tomb=tomb)
    want_scored = ref.scored_lanes(graph, rev, beam_ids, tomb=tomb)
    ins = [t.contiguous() for t in (graph, rev, words, card,
                                    tomb.view(torch.uint8), qw, qc, beam_ids,
                                    beam_sims)]
    out = {}
    for t, csrc in enumerate(csrcs):
        csrc = Path(csrc) if csrc is not None else build.CSRC
        for kernel in ("descent_hop", "descent_hop_dma"):
            ids = torch.empty((q, B), dtype=torch.int32, device=dev)
            sims = torch.empty((q, B), dtype=torch.float32, device=dev)
            counts = torch.empty((3, q), dtype=torch.int32, device=dev)
            if kernel == "descent_hop":
                name, n_ptr = "repro_descent_hop", 12
                extra = (q, W, kg, kr, B)
                outs = (ids, sims, counts[0])
                blocks = q
            else:
                p = tune.hop_params(n, W, B, kg + kr, q)
                name, n_ptr = "repro_descent_hop_dma", 14
                extra = (q, W, kg, kr, B, p.block_q, p.score_chunk,
                         p.n_buffers)
                outs = (ids, sims, counts[0], counts[1], counts[2])
                blocks = -(-q // p.block_q)
            ptrs = [x.data_ptr() for x in ins + list(outs)]

            def launch_of(lib, what):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_ptr \
                    + [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                return lambda: build.check(lib, fn(*ptrs, *extra, stream),
                                           what)

            def same() -> bool:
                torch.cuda.synchronize()
                return (torch.equal(ids, want_ids)
                        and torch.equal(sims, want_sims)
                        and torch.equal(counts[0], want_scored))

            launch = launch_of(build_copy(csrc, kernel, f"t{t}"), kernel)
            res = {"ms": device_ms(launch)}
            if not same():
                raise RuntimeError(f"{kernel} of {csrc} differs from the "
                                   f"plain version")
            src, pset = probed_source(csrc, kernel)
            if pset is None:
                if csrc == build.CSRC:
                    raise RuntimeError(f"no probe set's anchors occur once "
                                       f"each in {csrc}/{kernel}.cu")
            else:
                lib = build_copy(csrc, kernel, f"t{t}p", src)
                lib.repro_set_phases.argtypes = [ctypes.c_void_p]
                phases = torch.zeros(blocks * SLOTS, dtype=torch.int64,
                                     device=dev)
                build.check(lib, lib.repro_set_phases(phases.data_ptr()),
                            "phases")
                probed = launch_of(lib, f"probed {kernel}")
                for _ in range(2):  # the second launch runs warm
                    phases.zero_()
                    probed()
                if not same():
                    raise RuntimeError(f"probed {kernel} of {csrc} differs "
                                       f"from the plain version")
                v = phases.view(-1, SLOTS).cpu().numpy().astype(np.float64)
                v = v[v[:, 0] > 0]
                for label, slot, per in pset["phases"]:
                    col = v[:, slot] / v[:, per] if per is not None \
                        else v[:, slot]
                    res[label] = float(col.mean())
            out[(str(csrc), kernel)] = res
            print(f"[phases] {kernel} ({csrc}): {res['ms']:.4f} ms device "
                  f"time; mean cycles per block: "
                  + ("; ".join(f"{k} {x:.0f}" for k, x in res.items()
                               if k != "ms") or "no probe set matches"),
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=None,
                    help="kernel sources to probe, repeatable (default: "
                         "this checkout's src/repro_torch/csrc)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hop_phases: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.launch import knn_build
    from repro_torch.query.engine import QueryConfig, QueryEngine
    from repro_torch.query.index import KNNIndex

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ml1m.npz")
        knn_build.main(["--dataset", "ml1M", "--scale", "1.0", "--k", "30",
                        "--seed", "0", "--index-out", path,
                        "--device", "cuda"])
        index = KNNIndex.load(path)
    engine = QueryEngine(index, QueryConfig(k=10, beam=32, hops=3,
                                            max_wave=256, kernel=True),
                         device=dev)
    run(first_hop_args(engine, dev), a.csrc or (None,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
