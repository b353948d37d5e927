"""Where a cluster-KNN block spends its cycles, on the card.

    PYTHONPATH=src python3 -m repro_torch.bench.cluster_knn_phases

Copies ``csrc/goldfinger_knn.cu`` with ``clock64()`` probes added at fixed
places of the kernel (each place must occur once, or the script stops),
builds the copy into ``repro_torch/_build/phases/``, and launches it once
per shape on random clusters whose rows are 55% members and 45% PAD (the
main path's cap-2048 cluster holds 1,046 members), W = 32, k = 30. Prints,
per shape, each warp's mean cycles in the prologue (query tile, lists,
first copies), in the step loop split into copy issue, copy wait,
intersections + keys, the step barrier, buffer flushes (and their count)
and the rest (filtering and buffering), and in the end (last flushes and
output). The probes themselves cost a few cycles each. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.goldfinger_knn import ops
from repro_torch.sketch.goldfinger import popcount_rows, words_tensor

SHAPES = ((2048, 1), (1024, 2), (256, 10), (32, 90))
W, K = 32, 30
SLOTS = 16  # int64 counters per warp

# (anchor, text, before the anchor?) -- inserted in this order.
PROBES = (
    ('#include "common.cuh"\n', "__device__ unsigned long long* g_phases;\n",
     False),
    ("  const int row0 = blockIdx.x * kRows;\n",
     "  unsigned long long t0 = clock64(), t_w = 0, t_m = 0, t_s = 0;\n"
     "  unsigned long long c_issue = 0, c_wait = 0, c_mma = 0, c_sync = 0, "
     "c_flush = 0;\n  int n_flush = 0;\n", False),
    ("  repro::cp_async_wait<0>();  // the query tile (and the first tiles)\n"
     "  __syncthreads();\n", "  const unsigned long long t1 = clock64();\n",
     False),
    ("  for (int s = 0; s < nsteps; ++s) {\n",
     "    const unsigned long long t_i = clock64();\n", False),
    ("    if (stages == 1) {\n", "    t_w = clock64();\n    c_issue += t_w - t_i;\n",
     True),
    ("    __syncwarp();\n    Key* kt = keys",
     "    t_m = clock64();\n    c_wait += t_m - t_w;\n", True),
    ("    if (lane == 0) s_live[",
     "    t_s = clock64();\n    c_mma += t_s - t_m;\n", True),
    ("    // Row warp + i * NW's candidates", "    c_sync += clock64() - t_s;\n",
     True),
    ("          flush_rows<L, G>(list, buf, row, n, k, lane, t2);\n"
     "#pragma unroll\n          for (int i = 0; i < G; ++i) {\n"
     "            thr[q + i] = t2[i];",
     "          const unsigned long long t_q = clock64();\n          ++n_flush;\n",
     True),
    ("            surv[q + i] = __ballot_sync(kFull, key[q + i] > t2[i]);\n"
     "          }\n", "          c_flush += clock64() - t_q;\n", False),
    ("  // Flush the own rows' buffers and write the rows out.\n",
     "  const unsigned long long t_end = clock64();\n", True),
    ("}\n\n}  // namespace",
     "  if (lane == 0) {\n"
     f"    unsigned long long* o = g_phases + ((blockIdx.y * gridDim.x + "
     f"blockIdx.x) * NW + warp) * {SLOTS};\n"
     "    o[0] = 1; o[1] = t1 - t0; o[2] = t_end - t1; o[3] = clock64() - t_end;\n"
     "    o[4] = c_issue; o[5] = c_wait; o[6] = c_mma; o[7] = c_sync;\n"
     "    o[8] = c_flush; o[9] = n_flush;\n  }\n", True),
)


def probed_source() -> str:
    src = (build.CSRC / "goldfinger_knn.cu").read_text()
    for anchor, text, before in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)
    return src + ("\nREPRO_EXPORT int repro_set_phases(void* p) {\n"
                  "  return static_cast<int>(cudaMemcpyToSymbol(g_phases, &p, "
                  "sizeof(p)));\n}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_knn_phases: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "goldfinger_knn_phases.cu", out_dir / "lib.so"
    src.write_text(probed_source())
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.repro_goldfinger_knn
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 2
    lib.repro_set_phases.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cap, m in SHAPES:
        rng = np.random.default_rng(cap)
        w = rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
        w = (w & rng.integers(0, 2**32, size=w.shape, dtype=np.uint64)
             ).astype(np.uint32)
        card = popcount_rows(w.reshape(-1, W)).reshape(m, cap)
        ids = np.arange(m * cap, dtype=np.int32).reshape(m, cap)
        ids[:, int(cap * 0.55):] = -1
        t = [words_tensor(w, dev), torch.from_numpy(card).to(dev),
             torch.from_numpy(ids).to(dev)]
        p = ops.launch_params(cap, cap, W, K)
        phases = torch.zeros(p.blocks(m, cap) * p.warps * SLOTS,
                             dtype=torch.int64, device=dev)
        build.check(lib, lib.repro_set_phases(phases.data_ptr()), "phases")
        out = torch.empty((2, m, cap, K), dtype=torch.int32, device=dev)
        for _ in range(2):  # the second launch runs warm
            phases.zero_()
            build.check(lib, fn(*(x.data_ptr() for x in t + t),
                                out[0].data_ptr(), out[1].data_ptr(), m, cap,
                                cap, W, K, p.warps, p.stages, 1, None,
                                stream),
                        "phases")
            torch.cuda.synchronize()
        v = phases.view(-1, SLOTS).cpu().numpy()
        v = v[v[:, 0] == 1].mean(axis=0)  # warps of blocks with members
        rest = v[2] - v[4:9].sum()
        print(f"[phases] cap={cap} m={m} ({p.warps} warps, {p.stages} "
              f"stages), cycles per warp: prologue {v[1]:.0f}; steps "
              f"{v[2]:.0f} = copy issue {v[4]:.0f} + copy wait {v[5]:.0f} "
              f"+ intersections and keys {v[6]:.0f} + barrier {v[7]:.0f} "
              f"+ flushes {v[8]:.0f} ({v[9]:.1f}) + filter and buffer "
              f"{rest:.0f}; end {v[3]:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
