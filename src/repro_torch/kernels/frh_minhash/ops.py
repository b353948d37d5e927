"""Wrapper for the FastRandomHash kernel (``csrc/frh_minhash.cu``).

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. ``launches`` counts kernel launches (plain calls do not count).
Build Step 1 (``core/clustering``) hashes on the host, as the reference
does; :func:`dataset_minhash` is this kernel's entry point.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.frh_minhash import ref
from repro_torch.types import Dataset

KERNEL = "frh_minhash"

launches = 0


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_frh_minhash
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_frh_max_seeds.argtypes = []
        lib.repro_frh_max_seeds.restype = ctypes.c_int
    return lib


def _launch(padded_items: torch.Tensor, seeds: torch.Tensor, b: int):
    global launches
    if padded_items.dtype != torch.int32 or padded_items.dim() != 2:
        raise ValueError(f"minhash takes int32[n, P] padded profiles, got "
                         f"{padded_items.dtype}{list(padded_items.shape)}")
    n, P = padded_items.shape
    t = seeds.numel()
    dev = padded_items.device
    items = padded_items.contiguous()
    out = torch.empty((n, t), dtype=torch.int32, device=dev)
    if n == 0 or t == 0:
        return out
    lib = _lib()
    if t > lib.repro_frh_max_seeds():
        raise ValueError(f"the minhash kernel takes at most "
                         f"{lib.repro_frh_max_seeds()} seeds, got {t}")
    with torch.cuda.device(dev):
        err = lib.repro_frh_minhash(
            items.data_ptr(), seeds.data_ptr(), out.data_ptr(), n, P, t, b - 1,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches += 1
    return out


def minhash(padded_items: torch.Tensor, seeds, b: int) -> torch.Tensor:
    """int32[n, P] (PAD_ID padded) → int32[n, t] FastRandomHash values.

    ``b`` must be a power of two (the kernel masks where the plain version
    takes the modulo); ``seeds`` is int32[t], a tensor or a sequence.
    """
    if b < 1 or b & (b - 1) or b > 2**31:
        raise ValueError(f"b must be a power of two in [1, 2^31], got {b}")
    kind = padded_items.device.type
    if kind == "cpu":
        return ref.minhash_ref(padded_items, seeds, b)
    if kind != "cuda":
        raise ValueError(f"unsupported device {padded_items.device}")
    seeds = torch.as_tensor(seeds, dtype=torch.int32,
                            device=padded_items.device).reshape(-1)
    return _launch(padded_items, seeds.contiguous(), b)


def dataset_minhash(ds: Dataset, seeds, b: int,
                    device="cuda") -> np.ndarray:
    """Host entry: int32[t, n], like ``core.hashing.user_min_hash_np``."""
    dev = resolve_device(device)
    padded, _ = ds.padded_profiles()
    out = minhash(torch.from_numpy(padded).to(dev), seeds, b)
    return out.T.contiguous().cpu().numpy()
