"""Wrappers for the FastRandomHash kernel's three entries
(``csrc/frh_minhash.cu``): :func:`minhash` over padded profiles,
:func:`minhash_csr` over CSR profiles, and :func:`distinct_csr`, each
(seed, user)'s ``depth`` smallest distinct hashes over CSR profiles.

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. ``launches`` counts launches of the padded entry,
``launches_csr`` those of the CSR entry and ``launches_distinct`` those of
the distinct entry (plain calls count in none). Build Step 1
(``core/clustering.build_plan``) takes its distinct-hash table from
:func:`distinct_csr` on a card, where the reference hashes on the host;
:func:`dataset_minhash` is the min-hash's entry point, through the CSR
entry. Seeds go to the kernel by value: no call copies them to the card.
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

# The kernel's compile-time bounds (``repro_frh_max_seeds`` and
# ``repro_frh_max_depth``), which each launch checks against the library.
MAX_SEEDS = 32
MAX_DEPTH = 8

launches = 0
launches_csr = 0
launches_distinct = 0


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_frh_minhash
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_uint, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_frh_minhash_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint, ctypes.c_void_p]
        lib.repro_frh_minhash_csr.restype = ctypes.c_int
        lib.repro_frh_distinct_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        lib.repro_frh_distinct_csr.restype = ctypes.c_int
        for bound in (lib.repro_frh_max_seeds, lib.repro_frh_max_depth):
            bound.argtypes = []
            bound.restype = ctypes.c_int
    return lib


def _check_b(b: int) -> None:
    if b < 1 or b & (b - 1) or b > 2**31:
        raise ValueError(f"b must be a power of two in [1, 2^31], got {b}")


def _host_seeds(lib, seeds):
    """The seeds as a host int32 array for the kernel's parameters."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    arr = np.asarray(seeds, dtype=np.int64).reshape(-1).astype(np.int32)
    if not 1 <= len(arr) <= lib.repro_frh_max_seeds():
        raise ValueError(f"the minhash kernel takes 1 to "
                         f"{lib.repro_frh_max_seeds()} seeds, got {len(arr)}")
    return (ctypes.c_int * len(arr))(*arr.tolist())


def _launch(padded_items: torch.Tensor, seeds, b: int):
    global launches
    if padded_items.dtype != torch.int32 or padded_items.dim() != 2:
        raise ValueError(f"minhash takes int32[n, P] padded profiles, got "
                         f"{padded_items.dtype}{list(padded_items.shape)}")
    n, P = padded_items.shape
    lib = _lib()
    host = _host_seeds(lib, seeds)
    dev = padded_items.device
    items = padded_items.contiguous()
    out = torch.empty((n, len(host)), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.repro_frh_minhash(
            items.data_ptr(), host, out.data_ptr(), n, P, len(host), b - 1,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches += 1
    return out


def _check_csr(what: str, offsets: torch.Tensor, items: torch.Tensor):
    if (offsets.dtype != torch.int64 or offsets.dim() != 1
            or items.dtype != torch.int32 or items.dim() != 1
            or offsets.device != items.device or offsets.numel() < 1):
        raise ValueError(f"{what} takes int64[n + 1] offsets and "
                         f"int32[nnz] items on one device, got "
                         f"{offsets.dtype}{list(offsets.shape)} on "
                         f"{offsets.device}, {items.dtype}"
                         f"{list(items.shape)} on {items.device}")


def _launch_csr(offsets: torch.Tensor, items: torch.Tensor, seeds, b: int):
    global launches_csr
    dev = items.device
    _check_csr("minhash_csr", offsets, items)
    n = offsets.numel() - 1
    lib = _lib()
    host = _host_seeds(lib, seeds)
    offsets, items = offsets.contiguous(), items.contiguous()
    out = torch.empty((n, len(host)), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.repro_frh_minhash_csr(
            offsets.data_ptr(), items.data_ptr(), items.numel(), host,
            out.data_ptr(), n, len(host), b - 1,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches_csr += 1
    return out


def _launch_distinct(offsets: torch.Tensor, items: torch.Tensor, seeds,
                     b: int, depth: int):
    global launches_distinct
    dev = items.device
    _check_csr("distinct_csr", offsets, items)
    n = offsets.numel() - 1
    lib = _lib()
    host = _host_seeds(lib, seeds)
    if not 1 <= depth <= lib.repro_frh_max_depth():
        raise ValueError(f"the distinct-hash kernel takes a depth of 1 to "
                         f"{lib.repro_frh_max_depth()}, got {depth}")
    offsets, items = offsets.contiguous(), items.contiguous()
    out = torch.empty((len(host), n, depth), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.repro_frh_distinct_csr(
            offsets.data_ptr(), items.data_ptr(), items.numel(), host,
            out.data_ptr(), n, len(host), depth, b - 1,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches_distinct += 1
    return out


def minhash(padded_items: torch.Tensor, seeds, b: int) -> torch.Tensor:
    """int32[n, P] (PAD_ID padded) → int32[n, t] FastRandomHash values.

    ``b`` must be a power of two (the kernel masks where the plain version
    takes the modulo); ``seeds`` is int32[t], a tensor or a sequence.
    """
    _check_b(b)
    kind = padded_items.device.type
    if kind == "cpu":
        return ref.minhash_ref(padded_items, seeds, b)
    if kind != "cuda":
        raise ValueError(f"unsupported device {padded_items.device}")
    return _launch(padded_items, seeds, b)


def minhash_csr(offsets: torch.Tensor, items: torch.Tensor, seeds,
                b: int) -> torch.Tensor:
    """CSR profiles (offsets int64[n + 1], items int32[nnz], no PAD) →
    int32[n, t] FastRandomHash values; empty profiles give NO_HASH.

    Same ``seeds`` and ``b`` as :func:`minhash`; the items' device picks
    the implementation.
    """
    _check_b(b)
    kind = items.device.type
    if kind == "cpu":
        return ref.minhash_csr_ref(offsets, items, seeds, b)
    if kind != "cuda":
        raise ValueError(f"unsupported device {items.device}")
    return _launch_csr(offsets, items, seeds, b)


def distinct_csr(offsets: torch.Tensor, items: torch.Tensor, seeds, b: int,
                 depth: int) -> torch.Tensor:
    """CSR profiles (offsets int64[n + 1], items int32[nnz], no PAD) →
    int32[t, n, depth]: for each seed and user the ``depth`` smallest
    distinct FastRandomHash values of the user's items, ascending, padded
    with NO_HASH (an empty profile is NO_HASH throughout). Bitwise
    ``core.hashing.user_distinct_hashes_np(item_hashes(items, seeds, b),
    offsets, depth)``.

    Same ``seeds`` and ``b`` as :func:`minhash`; the items' device picks
    the implementation. The kernel takes up to ``MAX_SEEDS`` seeds and a
    ``depth`` up to ``MAX_DEPTH``.
    """
    _check_b(b)
    kind = items.device.type
    if kind == "cpu":
        return ref.distinct_csr_ref(offsets, items, seeds, b, depth)
    if kind != "cuda":
        raise ValueError(f"unsupported device {items.device}")
    return _launch_distinct(offsets, items, seeds, b, depth)


def dataset_minhash(ds: Dataset, seeds, b: int,
                    device="cuda") -> np.ndarray:
    """Host entry: int32[t, n], like ``core.hashing.user_min_hash_np``;
    the dataset's CSR arrays go to ``device`` as they are (no padded
    matrix is built)."""
    dev = resolve_device(device)
    offsets = torch.from_numpy(np.asarray(ds.offsets, np.int64)).to(dev)
    items = torch.from_numpy(np.asarray(ds.items, np.int32)).to(dev)
    out = minhash_csr(offsets, items, seeds, b)
    return out.T.contiguous().cpu().numpy()
