"""FastRandomHash on the card: the kernel's entries timed at ml1M@1.0.

    PYTHONPATH=src python3 -m repro_torch.bench.minhash_entries [--csrc DIR]

Hashes the ml1M@1.0 dataset (6,038 users, the paper build's t = 8 seeds
and b = 4,096) through ``csrc/frh_minhash.cu`` and prints, per entry, its
device time (a sleep kernel holds the card while 20 calls are queued, so
the events span device time alone) beside the same calls paced by the
host's queueing, and the least time the card could take. The padded
entry (``ops.minhash``) reads the profiles padded to the longest one; the
CSR entry (``ops.minhash_csr``, where the tree has it) reads the items and
offsets. Every output must equal the plain version bit for bit.

``--csrc DIR`` (repeatable) times the padded entry of another checkout's
``src/repro_torch/csrc`` too, built into ``_build/bench/``, in turns with
this one, e.g. the parent commit unpacked by ``git archive``. A tree
whose kernel takes its seeds from device memory (before they went by
value) is called that way. Needs a CUDA card; prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM CUDA cores (NVIDIA data sheet)
# Integer operations of one (item, seed): the xor with the seed's mix,
# fmix32's three shift-xors and two multiplies, the mask and the min.
MINHASH_OPS = 11
SLEEP_CYCLES = 50_000_000


def device_ms(fn, reps: int = 7, inner: int = 20, hold: bool = True):
    """Median over ``reps`` of the time between events around ``inner``
    calls, / inner; ``hold`` queues them behind a sleep kernel first."""
    fn()
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


def int32_floor_ms(ds, t: int) -> float:
    """The hashing's time at the int32 pipe's own rate: 64 operations per
    clock on each SM (compute capability 9.0, CUDA C++ Programming Guide's
    arithmetic-throughput table) at the card's highest SM clock, as
    ``nvidia-smi`` reports it. A quarter of the 67 T/s the bound uses."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return len(ds.items) * t * MINHASH_OPS / (64 * sms * mhz * 1e6) * 1e3


def lane_use(ds) -> tuple[int, int]:
    """(items, lane-item slots) of the CSR entry's warp per user: a row
    takes ceil(vectors / 32) rounds of 32 lanes x 4 items, its vectors
    the 16-byte ones that its items touch."""
    s, e = ds.offsets[:-1].astype(np.int64), ds.offsets[1:].astype(np.int64)
    vectors = (e + 3) // 4 - s // 4
    return int((e - s).sum()), int(-(-vectors // 32).sum() * 128)


def bounds_ms(ds, t: int) -> dict:
    """Least time of each entry for this data: its bytes (every input read
    once, the output written once) at HBM rate, or its hashing at the
    CUDA-core rate, whichever is larger."""
    n, nnz = ds.n_users, len(ds.items)
    P = int(np.diff(ds.offsets).max())
    t_ops = nnz * t * MINHASH_OPS / CUDA_CORE_OPS_PER_S * 1e3
    padded = (n * P * 4 + n * t * 4) / HBM_BYTES_PER_S * 1e3
    csr = (nnz * 4 + (n + 1) * 8 + n * t * 4) / HBM_BYTES_PER_S * 1e3
    return {"padded": max(padded, t_ops), "csr": max(csr, t_ops)}


def tree_padded_entry(csrc: Path, tag: str, x, seeds, b: int):
    """A call of another tree's padded entry on ``x``, built from its
    sources; returns (call, output tensor)."""
    out_dir = build.BUILD_DIR / "bench" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libfrh_minhash.so"
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(csrc), "-o", str(lib_path),
                           str(csrc / "frh_minhash.cu")],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{done.stdout}"
                           f"{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    n, P = x.shape
    t = len(seeds)
    out = torch.empty((n, t), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = lib.repro_frh_minhash
    fn.restype = ctypes.c_int
    if hasattr(lib, "repro_frh_minhash_csr"):  # seeds by value
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
        arr = (ctypes.c_int * t)(*(int(s) for s in seeds))
        args = (x.data_ptr(), ctypes.addressof(arr), out.data_ptr())
    else:  # seeds read from device memory
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_uint, ctypes.c_void_p]
        s_dev = torch.as_tensor(np.asarray(seeds, np.int32), device=x.device)
        arr = s_dev
        args = (x.data_ptr(), s_dev.data_ptr(), out.data_ptr())

    def call():
        err = fn(*args, n, P, t, b - 1, stream)
        if err:
            raise RuntimeError(f"frh_minhash of {csrc}: CUDA error {err}")

    call.keep = arr  # the seeds outlive every call
    return call, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[],
                    help="another checkout's src/repro_torch/csrc whose "
                         "padded entry is timed too (repeatable)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("minhash_entries: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.core.clustering import frh_seeds
    from repro_torch.core.params import params_for
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels.frh_minhash import ops, ref

    dev = torch.device("cuda", 0)
    params = params_for("ml1M", k=30)
    ds = make_dataset("ml1M", scale=1.0, seed=0)
    seeds, b = frh_seeds(params), params.b
    t = len(seeds)
    padded, _ = ds.padded_profiles()
    x = torch.from_numpy(padded).to(dev)
    want = ref.minhash_ref(x, seeds, b)
    bound = bounds_ms(ds, t)
    print(f"[minhash] ml1M@1.0: n={ds.n_users}, {len(ds.items)} items, "
          f"P={padded.shape[1]}, t={t}, b={b}; bound padded "
          f"{bound['padded']:.5f} ms, CSR {bound['csr']:.5f} ms; the "
          f"hashing at the int32 pipe's rate {int32_floor_ms(ds, t):.5f} ms",
          flush=True)
    used, slots = lane_use(ds)
    print(f"[minhash] CSR entry lanes: {used} items in {slots} lane-item "
          f"slots ({used / slots:.1%})", flush=True)
    entries = [("padded (this tree)", lambda: ops.minhash(x, seeds, b))]
    if hasattr(ops, "minhash_csr"):
        items = torch.from_numpy(ds.items).to(dev)
        offsets = torch.from_numpy(ds.offsets.astype(np.int64)).to(dev)
        entries.append(("CSR (this tree)",
                        lambda: ops.minhash_csr(offsets, items, seeds, b)))
    for i, csrc in enumerate(a.csrc):
        call, out = tree_padded_entry(Path(csrc), f"t{i}", x, seeds, b)

        def other(call=call, out=out):
            call()
            return out

        entries.append((f"padded ({csrc})", other))
    for name, fn in entries:
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"minhash entry {name} differs from the "
                               f"plain version")
    # In turns: every entry held, then every entry paced by the host.
    held = {name: [] for name, _ in entries}
    for order in (entries, entries[::-1]):
        for name, fn in order:
            held[name].append(device_ms(fn))
    for name, fn in entries:
        paced = device_ms(fn, hold=False)
        print(f"[minhash] {name}: device time {held[name][0]:.5f} / "
              f"{held[name][1]:.5f} ms (held), {paced:.5f} ms paced by the "
              f"host's queueing; bitwise equal to the plain version",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
