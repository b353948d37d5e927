"""Wrappers for the fused descent-hop kernels (``csrc/descent_hop.cu`` and
``csrc/descent_hop_dma.cu``).

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. :func:`descent_hop` takes one table set, :func:`descent_hop_sharded`
the sharded placement's S stacked shards in one launch (the shard is a
grid axis of both kernels). ``launches`` counts launches of the hop
kernel and ``launches_dma`` those of the DMA hop, either entry;
``launches_sharded`` and ``launches_dma_sharded`` count those made through
the sharded entry (plain calls count in none).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.descent_score import ref, tune

KERNEL = "descent_hop"
KERNEL_DMA = "descent_hop_dma"
SMEM_LIMIT = tune.SMEM_LIMIT
MAX_SHARDS = 65535  # a CUDA grid's y extent

launches = 0
launches_dma = 0
launches_sharded = 0
launches_dma_sharded = 0
_PREFIX = {False: "repro_descent_hop", True: "repro_descent_hop_dma"}


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_descent_hop_sharded
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_descent_hop_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.repro_descent_hop_smem_bytes.restype = ctypes.c_size_t
        lib.repro_descent_hop_workspace_stride.argtypes = [ctypes.c_int] * 4
        lib.repro_descent_hop_workspace_stride.restype = ctypes.c_size_t
        lib.repro_descent_hop_blocks_per_sm.argtypes = [ctypes.c_int] * 5
        lib.repro_descent_hop_blocks_per_sm.restype = ctypes.c_int
    return lib


def _lib_dma():
    lib = build.load(KERNEL_DMA)
    fn = lib.repro_descent_hop_dma_sharded
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_descent_hop_dma_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.repro_descent_hop_dma_smem_bytes.restype = ctypes.c_size_t
        lib.repro_descent_hop_dma_workspace_stride.argtypes = \
            [ctypes.c_int] * 4
        lib.repro_descent_hop_dma_workspace_stride.restype = ctypes.c_size_t
        lib.repro_descent_hop_dma_blocks_per_sm.argtypes = [ctypes.c_int] * 8
        lib.repro_descent_hop_dma_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(dma: bool, dev_index: int, *shape) -> int:
    """Blocks the card holds at once of a hop whose state is in global
    memory: the kernel's blocks per SM at ``shape`` (the arguments of its
    ``*_blocks_per_sm`` but the placement) times the SMs."""
    lib = _lib_dma() if dma else _lib()
    per_sm = getattr(lib, f"{_PREFIX[dma]}_blocks_per_sm")(*shape, 1)
    if per_sm <= 0:
        raise RuntimeError(f"{_PREFIX[dma]} fits no block on an SM at "
                           f"{shape} (occupancy query returned {per_sm})")
    return per_sm * torch.cuda.get_device_properties(
        dev_index).multi_processor_count


def _workspace(dma: bool, dev, S: int, q: int, block_q: int, W: int,
               kg: int, kr: int, B: int, *ring):
    """(workspace, grid) of a hop whose state is in global memory: per
    shard, one block per resident slot the card has for that shard (at
    most one per group of ``block_q`` queries), each block with its
    state's bytes of the workspace."""
    lib = _lib_dma() if dma else _lib()
    stride = getattr(lib, f"{_PREFIX[dma]}_workspace_stride")(W, kg, kr, B)
    if stride != tune.workspace_stride(W, kg + kr, B):
        raise RuntimeError(
            f"tune.workspace_stride disagrees with the hop kernel's layout "
            f"({stride} B) at W={W} kg+kr={kg + kr} B={B}")
    resident = _resident_blocks(dma, dev.index, W, kg, kr, B, *ring)
    grid = min(-(-q // block_q), max(1, resident // S))
    return torch.empty(S * grid * stride, dtype=torch.uint8,
                       device=dev), grid


def _checked_args(graph_ids, rev_ids, words, card, tomb, q_words, q_card,
                  beam_ids, beam_sims):
    """(S, cap, contiguous kernel arguments) after checking device, dtype
    and shape of every input. Tables are [n, ·] with beams [q, B] (S = 1),
    or carry a leading shard axis, [S, cap, ·] with beams [S, q, B];
    ``q_words`` [q, W] and ``q_card`` [q] are every shard's. tomb None →
    all live."""
    lead = tuple(graph_ids.shape[:-1])
    S, cap = (lead[0], lead[1]) if len(lead) == 2 else (1, lead[0])
    blead = lead[:1] if len(lead) == 2 else ()
    kg = graph_ids.shape[-1]
    kr, W = rev_ids.shape[-1], words.shape[-1]
    q, B = beam_ids.shape[-2:]
    dev = beam_ids.device
    if tomb is None:
        tomb = torch.zeros(lead, dtype=torch.bool, device=dev)
    typed = ((graph_ids, torch.int32, lead + (kg,)),
             (rev_ids, torch.int32, lead + (kr,)),
             (words, torch.int32, lead + (W,)), (card, torch.int32, lead),
             (tomb, torch.bool, lead), (q_words, torch.int32, (q, W)),
             (q_card, torch.int32, (q,)),
             (beam_ids, torch.int32, blead + (q, B)),
             (beam_sims, torch.float32, blead + (q, B)))
    for t, dtype, shape in typed:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"descent hop input must be {dtype}{list(shape)} on {dev}, "
                f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"sharded hop takes 1 to {MAX_SHARDS} shards, got "
                         f"{S}")
    args = [t.contiguous() for t, _, _ in typed]
    args[4] = args[4].view(torch.uint8)
    return S, cap, args


def _launch(graph_ids, rev_ids, words, card, tomb, q_words, q_card,
            beam_ids, beam_sims):
    global launches, launches_sharded
    S, cap, args = _checked_args(graph_ids, rev_ids, words, card, tomb,
                                 q_words, q_card, beam_ids, beam_sims)
    kg = graph_ids.shape[-1]
    kr, W = rev_ids.shape[-1], words.shape[-1]
    q, B = beam_ids.shape[-2:]
    dev = beam_ids.device
    lead = tuple(beam_ids.shape[:-2])
    out_ids = torch.empty(lead + (q, B), dtype=torch.int32, device=dev)
    out_sims = torch.empty(lead + (q, B), dtype=torch.float32, device=dev)
    n_scored = torch.empty(lead + (q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out_ids, out_sims, n_scored
    lib = _lib()
    placement = tune.state_placement(W, kg + kr, B, 0)
    glob = placement == "global"
    smem = lib.repro_descent_hop_smem_bytes(W, kg, kr, B, int(glob))
    if smem != tune.state_bytes(W, kg + kr, B, 0, placement):
        raise RuntimeError(
            f"tune.state_bytes disagrees with the hop kernel's layout "
            f"({smem} B) at W={W} kg+kr={kg + kr} B={B} ({placement})")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in args] + [
        out_ids.data_ptr(), out_sims.data_ptr(), n_scored.data_ptr()]
    with torch.cuda.device(dev):
        ws, grid = (_workspace(False, dev, S, q, 1, W, kg, kr, B) if glob
                    else (None, q))
        err = lib.repro_descent_hop_sharded(
            *ptrs, S, cap, q, W, kg, kr, B,
            None if ws is None else ws.data_ptr(), grid, stream)
    build.check(lib, err, KERNEL)
    launches += 1
    if graph_ids.dim() == 3:
        launches_sharded += 1
    return out_ids, out_sims, n_scored


def _launch_dma(graph_ids, rev_ids, words, card, tomb, q_words, q_card,
                beam_ids, beam_sims, block_q: int, chunk: int,
                n_buffers: int):
    global launches_dma, launches_dma_sharded
    S, cap, args = _checked_args(graph_ids, rev_ids, words, card, tomb,
                                 q_words, q_card, beam_ids, beam_sims)
    kg = graph_ids.shape[-1]
    kr, W = rev_ids.shape[-1], words.shape[-1]
    q, B = beam_ids.shape[-2:]
    dev = beam_ids.device
    lead = tuple(beam_ids.shape[:-2])
    outs = [torch.empty(lead + (q, B), dtype=torch.int32, device=dev),
            torch.empty(lead + (q, B), dtype=torch.float32, device=dev)]
    outs += [torch.empty(lead + (q,), dtype=torch.int32, device=dev)
             for _ in range(3)]
    if q == 0:
        return tuple(outs)
    if block_q < 1 or chunk < 1 or not 1 <= n_buffers <= tune.MAX_BUFFERS:
        raise ValueError(f"DMA hop needs block_q >= 1, score_chunk >= 1 and "
                         f"1 <= n_buffers <= {tune.MAX_BUFFERS}; got "
                         f"{block_q}, {chunk}, {n_buffers}")
    # As the reference: a chunk never exceeds the lanes, nor the ring the
    # chunks.
    C = B * (kg + kr)
    chunk = max(1, min(chunk, C))
    n_buffers = max(1, min(n_buffers, -(-C // chunk)))
    lib = _lib_dma()
    placement = tune.state_placement(W, kg + kr, B, chunk * n_buffers)
    glob = placement == "global"
    smem = lib.repro_descent_hop_dma_smem_bytes(W, kg, kr, B, block_q, chunk,
                                                n_buffers, int(glob))
    if smem != tune.smem_bytes(W, kg + kr, B, block_q, chunk, n_buffers,
                               placement):
        raise RuntimeError(
            f"tune.smem_bytes disagrees with the kernel's layout ({smem} B) "
            f"at W={W} kg+kr={kg + kr} B={B} block_q={block_q} "
            f"chunk={chunk} n_buffers={n_buffers} ({placement})")
    if smem > SMEM_LIMIT:  # the ring alone overflows a block
        raise ValueError(
            f"DMA hop needs {smem} B of shared memory for its ring at "
            f"W={W}, score_chunk={chunk}, n_buffers={n_buffers}; the limit "
            f"is {SMEM_LIMIT}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() for a in args] + [o.data_ptr() for o in outs]
    with torch.cuda.device(dev):
        ws, grid = (_workspace(True, dev, S, q, block_q, W, kg, kr, B,
                               block_q, chunk, n_buffers) if glob
                    else (None, -(-q // block_q)))
        err = lib.repro_descent_hop_dma_sharded(
            *ptrs, S, cap, q, W, kg, kr, B, block_q, chunk, n_buffers,
            None if ws is None else ws.data_ptr(), grid, stream)
    build.check(lib, err, KERNEL_DMA)
    launches_dma += 1
    if graph_ids.dim() == 3:
        launches_dma_sharded += 1
    return tuple(outs)


def descent_hop(graph_ids, rev_ids, words, card, q_words, q_card,
                beam_ids, beam_sims, *, tomb=None, dma: bool = False,
                block_q: int | None = None, score_chunk: int | None = None,
                n_buffers: int | None = None, with_counts: bool = False):
    """One fused descent hop; same contract as ref.descent_hop_ref.

    ``tomb`` (bool[n] or None) marks tombstoned index rows; their lanes
    retire with the PAD/in-beam suppression, before the estimator. Beam
    rows must not repeat an id (every merge_topk output satisfies this).

    ``dma=True`` selects the DMA hop (``csrc/descent_hop_dma.cu``): the
    surviving rows are gathered stage by stage into a shared-memory ring
    by bulk copies, with ``(block_q, score_chunk, n_buffers)`` from
    :func:`tune.hop_params` unless given. Results are bitwise those of the
    hop kernel and of the plain version either way. Both kernels take any
    beam: a query's state (``tune.state_bytes``) sits in a block's shared
    memory where it fits and otherwise in a workspace in global memory
    (``tune.state_placement``: at kg+kr = 60, beams above ~100 lanes),
    and beams above ``tune.MAX_BEAM`` lanes are selected by a radix
    select. Only a DMA ring that overflows a block raises ValueError.

    With ``with_counts`` returns ``(ids, sims, n_scored, dma_bytes,
    bytes_saved)``, each count int32[q]: lanes that survived suppression
    and were scored, fingerprint bytes gathered (``n_scored·W·4`` for the
    DMA hop, 0 for the hop kernel) and fingerprint bytes the suppression
    left unread (``(C − n_scored)·W·4`` with ``C = B·(kg+kr)``; 0 for the
    hop kernel). The counts keep the reference's meaning, lanes: both CUDA
    kernels read one row per distinct surviving id, so where lanes repeat
    an id they read fewer rows than ``n_scored`` (and the DMA hop moves
    fewer bytes than ``dma_bytes``).
    """
    kind = beam_ids.device.type
    if kind == "cpu":
        ids, sims = ref.descent_hop_ref(graph_ids, rev_ids, words, card,
                                        q_words, q_card, beam_ids,
                                        beam_sims, tomb=tomb)
        if not with_counts:
            return ids, sims
        n_scored = ref.scored_lanes(graph_ids, rev_ids, beam_ids, tomb=tomb)
        if dma:
            C = beam_ids.shape[1] * (graph_ids.shape[1] + rev_ids.shape[1])
            dma_bytes, saved = ref.dma_counts(n_scored, words.shape[1], C)
        else:
            dma_bytes = saved = torch.zeros_like(n_scored)
        return ids, sims, n_scored, dma_bytes, saved
    if kind != "cuda":
        raise ValueError(f"unsupported device {beam_ids.device}")
    if graph_ids.dim() != 2:
        raise ValueError(f"descent hop tables are [n, kg] (shards go "
                         f"through descent_hop_sharded), got "
                         f"{list(graph_ids.shape)}")
    out = _launch_hop(graph_ids, rev_ids, words, card, q_words, q_card,
                      beam_ids, beam_sims, tomb, dma, block_q, score_chunk,
                      n_buffers)
    return out if with_counts else out[:2]


def _launch_hop(graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
                beam_sims, tomb, dma, block_q, score_chunk, n_buffers):
    """Either kernel on CUDA tensors, single or sharded (tables [n, ·] or
    [S, cap, ·]): ``(ids, sims, n_scored, dma_bytes, bytes_saved)``. The
    DMA hop's launch parameters come from :func:`tune.hop_params` at the
    (per-shard) table rows unless given."""
    if dma:
        q, B = beam_ids.shape[-2:]
        p = tune.hop_params(words.shape[-2], words.shape[-1], B,
                            graph_ids.shape[-1] + rev_ids.shape[-1], q)
        return _launch_dma(
            graph_ids, rev_ids, words, card, tomb, q_words, q_card, beam_ids,
            beam_sims, p.block_q if block_q is None else block_q,
            p.score_chunk if score_chunk is None else score_chunk,
            p.n_buffers if n_buffers is None else n_buffers)
    ids, sims, n_scored = _launch(graph_ids, rev_ids, words, card, tomb,
                                  q_words, q_card, beam_ids, beam_sims)
    zero = torch.zeros_like(n_scored)
    return ids, sims, n_scored, zero, zero


def descent_hop_sharded(graph_ids, rev_ids, words, card, q_words, q_card,
                        beam_ids, beam_sims, *, tomb=None, dma: bool = False,
                        block_q: int | None = None,
                        score_chunk: int | None = None,
                        n_buffers: int | None = None,
                        with_counts: bool = False):
    """One hop of every shard of the sharded placement, in one launch.

    Tables carry a leading shard axis, graph_ids int32[S, cap, kg],
    rev_ids int32[S, cap, kr], words int32[S, cap, W], card int32[S, cap],
    tomb bool[S, cap] or None; beams int32/f32[S, q, B] in each shard's own
    row ids; q_words int32[q, W] and q_card int32[q] are every shard's.
    Returns ``[S, q, B]`` ids and sims, and with ``with_counts`` the three
    counts ``[S, q]``, each shard's as :func:`descent_hop` gives them: the
    contract of :func:`ref.descent_hop_sharded_ref`, which CPU tensors run.
    On CUDA either kernel takes the shard as its grid's y axis; the DMA
    hop's parameters come from the per-shard rows ``cap``.
    """
    kind = beam_ids.device.type
    if kind == "cpu":
        ids, sims, n_scored = ref.descent_hop_sharded_ref(
            graph_ids, rev_ids, words, card, q_words, q_card, beam_ids,
            beam_sims, tomb=tomb)
        if not with_counts:
            return ids, sims
        if dma:
            C = beam_ids.shape[-1] * (graph_ids.shape[-1]
                                      + rev_ids.shape[-1])
            dma_bytes, saved = ref.dma_counts(n_scored, words.shape[-1], C)
        else:
            dma_bytes = saved = torch.zeros_like(n_scored)
        return ids, sims, n_scored, dma_bytes, saved
    if kind != "cuda":
        raise ValueError(f"unsupported device {beam_ids.device}")
    if graph_ids.dim() != 3:
        raise ValueError(f"sharded hop tables are [S, cap, kg], got "
                         f"{list(graph_ids.shape)}")
    out = _launch_hop(graph_ids, rev_ids, words, card, q_words, q_card,
                      beam_ids, beam_sims, tomb, dma, block_q, score_chunk,
                      n_buffers)
    return out if with_counts else out[:2]
