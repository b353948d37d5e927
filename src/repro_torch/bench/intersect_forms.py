"""Time three forms of the GoldFinger intersection on the card.

    PYTHONPATH=src python3 -m repro_torch.bench.intersect_forms

Builds ``csrc/intersect_forms.cu`` and runs, over all pairs of random
clusters at the capacities of build Step 2 (W = 32, the 1,024-bit
fingerprints of the paper's configurations), the intersection sweep in
each form: ``__popc`` on the CUDA cores, ``mma.sync`` m16n8k256 ``.b1``
AND-popc on the packed words, and ``mma.sync`` m16n8k32 ``.s8`` on
unpacked bit planes (the unpacking is timed apart). Every form's per-row
checksums must equal a float32 product of the bit planes (exact: the sums
stay below 2**24). Then times ``ops.cluster_knn`` at the same shapes, so
the sweep without its top-k can be read beside the whole kernel. Needs a
CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.goldfinger_knn import ops
from repro_torch.sketch.goldfinger import popcount_rows, words_tensor

FORMS = ("popc", "mma_b1", "mma_s8")
# (cap, clusters): one cluster at cap 2048 as on the main path; the others
# hold about as many pairs as that one.
SHAPES = ((2048, 1), (1024, 4), (256, 64), (32, 720))
W = 32


def cuda_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """int32 [..., W] bit-views → uint8 [..., 32 W] bit planes."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("intersect_forms: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    lib = build.load("intersect_forms")
    fn = lib.repro_intersect_forms
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cap, m in SHAPES:
        rng = np.random.default_rng(cap)
        w_np = rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
        w_np &= rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
        w_np = w_np.astype(np.uint32)
        words = words_tensor(w_np, dev)
        out = torch.zeros((m, cap), dtype=torch.int32, device=dev)
        unpack_ms = cuda_ms(lambda: unpack(words))
        bits = unpack(words)
        planes = bits.to(torch.float32)
        want = (planes @ planes.transpose(1, 2)).sum(-1).to(torch.int32)

        def run(form):
            out.zero_()
            build.check(lib, fn(form, words.data_ptr(), bits.data_ptr(),
                                out.data_ptr(), m, cap, W, stream),
                        "intersect_forms")

        times = {}
        for form, name in enumerate(FORMS):
            run(form)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print(f"intersect_forms: FAILED: {name} checksums differ at "
                      f"cap={cap}", file=sys.stderr)
                return 1
            times[name] = cuda_ms(lambda: run(form))
        card = torch.from_numpy(popcount_rows(
            w_np.reshape(-1, W)).reshape(m, cap)).to(dev)
        ids = torch.arange(m * cap, dtype=torch.int32,
                           device=dev).reshape(m, cap)
        knn_ms = cuda_ms(lambda: ops.cluster_knn(words, card, ids, 30))
        pairs = m * cap * cap
        print(f"[forms] cap={cap} m={m} W={W} ({pairs} pairs): "
              + ", ".join(f"{k} {v:.4f} ms ({pairs / v / 1e6:.2f} Gpairs/s)"
                          for k, v in times.items())
              + f"; unpack to planes {unpack_ms:.4f} ms; cluster_knn k=30 "
                f"{knn_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
