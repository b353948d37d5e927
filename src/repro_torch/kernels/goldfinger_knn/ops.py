"""Wrappers for the cluster-KNN kernel (``csrc/goldfinger_knn.cu``).

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. ``launches`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.goldfinger_knn import ref

KERNEL = "goldfinger_knn"
MAX_K = 64
MAX_BATCHES = 65535  # CUDA grid y limit
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

launches = 0


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_goldfinger_knn
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_goldfinger_knn_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.repro_goldfinger_knn_smem_bytes.restype = ctypes.c_size_t
    return lib


def _tile(rows: int) -> int:
    return 32 if rows <= 32 else 64


def _launch(q_words, q_card, q_ids, d_words, d_card, d_ids, k: int):
    """q_* [m, nq, ...], d_* [m, nd, ...] on one CUDA device."""
    global launches
    m, nq, W = q_words.shape
    nd = d_words.shape[1]
    dev = q_words.device
    tensors = (q_words, q_card, q_ids, d_words, d_card, d_ids)
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError("cluster-KNN inputs must be int32 tensors on one "
                             "CUDA device")
    if (q_card.shape != (m, nq) or q_ids.shape != (m, nq)
            or d_words.shape != (m, nd, W) or d_card.shape != (m, nd)
            or d_ids.shape != (m, nd)):
        raise ValueError("cluster-KNN shape mismatch")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"cluster-KNN supports 1 <= k <= {MAX_K}, got {k}")
    if m > MAX_BATCHES:
        raise ValueError(f"cluster-KNN takes at most {MAX_BATCHES} clusters "
                         f"per call, got {m}")
    tensors = tuple(t.contiguous() for t in tensors)
    out_ids = torch.empty((m, nq, k), dtype=torch.int32, device=dev)
    out_sims = torch.empty((m, nq, k), dtype=torch.float32, device=dev)
    if m == 0 or nq == 0:
        return out_ids, out_sims
    lib = _lib()
    tq, td = _tile(nq), _tile(nd)
    smem = lib.repro_goldfinger_knn_smem_bytes(W, k, tq, td)
    if smem > SMEM_LIMIT:
        raise ValueError(f"cluster-KNN needs {smem} B of shared memory at "
                         f"W={W}, k={k}; the limit is {SMEM_LIMIT}")
    with torch.cuda.device(dev):
        err = lib.repro_goldfinger_knn(
            *(t.data_ptr() for t in tensors), out_ids.data_ptr(),
            out_sims.data_ptr(), m, nq, nd, W, k, tq, td,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches += 1
    return out_ids, out_sims


def _dispatch(tensor: torch.Tensor) -> str:
    if tensor.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensor.device}")
    return tensor.device.type


def knn(q_words, q_card, q_ids, d_words, d_card, d_ids, k: int):
    """Top-k database neighbors of each query row (see ref.knn_ref).

    q_words int32[nq, W] bit-views, q_card / q_ids int32[nq]; d_* likewise.
    Returns (ids int32[nq, k], sims float32[nq, k]).
    """
    if _dispatch(q_words) == "cpu":
        return ref.knn_ref(q_words, q_card, q_ids, d_words, d_card, d_ids, k)
    ids, sims = _launch(q_words[None], q_card[None], q_ids[None],
                        d_words[None], d_card[None], d_ids[None], k)
    return ids[0], sims[0]


def cluster_knn(words, card, member_ids, k: int):
    """Batched per-cluster KNN: words int32[m, cap, W] bit-views, card and
    member_ids int32[m, cap] (PAD_ID padded) → ([m, cap, k] ids, sims).

    Same contract as ``repro.core.local_knn._group_knn``: PAD rows yield
    PAD/−inf, neighbors are global ids sorted by sim desc, ties to the
    earliest cluster column.
    """
    if _dispatch(words) == "cpu":
        return ref.cluster_knn_ref(words, card, member_ids, k)
    return _launch(words, card, member_ids, words, card, member_ids, k)
