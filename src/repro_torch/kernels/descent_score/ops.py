"""Wrapper for the fused descent-hop kernel (``csrc/descent_hop.cu``).

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. ``launches`` counts kernel launches (plain calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.descent_score import ref

KERNEL = "descent_hop"
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

launches = 0


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_descent_hop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_descent_hop_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.repro_descent_hop_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(graph_ids, rev_ids, words, card, tomb, q_words, q_card,
            beam_ids, beam_sims):
    global launches
    n, kg = graph_ids.shape
    kr = rev_ids.shape[1]
    W = words.shape[1]
    q, B = beam_ids.shape
    dev = beam_ids.device
    if tomb is None:
        tomb = torch.zeros(n, dtype=torch.bool, device=dev)
    typed = ((graph_ids, torch.int32, (n, kg)), (rev_ids, torch.int32, (n, kr)),
             (words, torch.int32, (n, W)), (card, torch.int32, (n,)),
             (tomb, torch.bool, (n,)), (q_words, torch.int32, (q, W)),
             (q_card, torch.int32, (q,)), (beam_ids, torch.int32, (q, B)),
             (beam_sims, torch.float32, (q, B)))
    for t, dtype, shape in typed:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"descent hop input must be {dtype}{list(shape)} on {dev}, "
                f"got {t.dtype}{list(t.shape)} on {t.device}")
    args = [t.contiguous() for t, _, _ in typed]
    args[4] = args[4].view(torch.uint8)
    out_ids = torch.empty((q, B), dtype=torch.int32, device=dev)
    out_sims = torch.empty((q, B), dtype=torch.float32, device=dev)
    n_scored = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out_ids, out_sims, n_scored
    lib = _lib()
    smem = lib.repro_descent_hop_smem_bytes(W, kg, kr, B)
    if smem > SMEM_LIMIT:
        raise ValueError(f"descent hop needs {smem} B of shared memory at "
                         f"B={B}, kg+kr={kg + kr}; the limit is {SMEM_LIMIT}")
    with torch.cuda.device(dev):
        err = lib.repro_descent_hop(
            *(a.data_ptr() for a in args), out_ids.data_ptr(),
            out_sims.data_ptr(), n_scored.data_ptr(), q, W, kg, kr, B,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, KERNEL)
    launches += 1
    return out_ids, out_sims, n_scored


def descent_hop(graph_ids, rev_ids, words, card, q_words, q_card,
                beam_ids, beam_sims, *, tomb=None, with_counts: bool = False):
    """One fused descent hop; same contract as ref.descent_hop_ref.

    ``tomb`` (bool[n] or None) marks tombstoned index rows; their lanes
    retire with the PAD/in-beam suppression, before the estimator. Beam
    rows must not repeat an id (every merge_topk output satisfies this).
    With ``with_counts`` also returns ``n_scored`` int32[q], the lanes
    that survived suppression and were scored.
    """
    kind = beam_ids.device.type
    if kind == "cpu":
        ids, sims = ref.descent_hop_ref(graph_ids, rev_ids, words, card,
                                        q_words, q_card, beam_ids,
                                        beam_sims, tomb=tomb)
        if not with_counts:
            return ids, sims
        return ids, sims, ref.scored_lanes(graph_ids, rev_ids, beam_ids,
                                           tomb=tomb)
    if kind != "cuda":
        raise ValueError(f"unsupported device {beam_ids.device}")
    ids, sims, n_scored = _launch(graph_ids, rev_ids, words, card, tomb,
                                  q_words, q_card, beam_ids, beam_sims)
    return (ids, sims, n_scored) if with_counts else (ids, sims)
