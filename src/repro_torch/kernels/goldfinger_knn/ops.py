"""Wrappers for the cluster-KNN kernel (``csrc/goldfinger_knn.cu``).

The tensor's device selects the implementation: CPU tensors run the plain
version (:mod:`.ref`), CUDA tensors launch the kernel, and anything else
raises. ``launches`` counts kernel launches (plain calls do not count).
Launch parameters come from :func:`launch_params` alone.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.goldfinger_knn import ref

KERNEL = "goldfinger_knn"
REG_K = 64           # the widest top-k merged in registers (2 keys a lane)
MAX_BATCHES = 65535  # CUDA grid y limit: clusters per launch
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
ROWS = 16            # query rows per block: one mma M
TILE = 32            # database rows per warp tile: one per lane
MIN_WARPS = 4        # warps per block: a power of two, 4 to 8
MAX_WARPS = 8
STAGES = 2           # cp.async ring depth per warp: copy one tile ahead
CHUNK = 128          # words of a staged row chunk where whole rows fit no
                     # block (a multiple of 8: whole mma k-steps)

launches = 0


@dataclasses.dataclass(frozen=True)
class LaunchParams:
    """One launch's shape: ``rows`` query rows per block, ``warps`` warps
    each taking every ``warps``-th database tile and keeping the top-k of
    every ``warps``-th row, a ``stages``-deep copy ring per warp, and
    ``smem`` bytes of dynamic shared memory; ``lists`` says where the rows'
    top-k lists lie ("shared", or "global" for k > 64 lists that do not
    fit a block beside its tiles); ``chunk`` is 0 where whole rows are
    staged, else the words of a staged row chunk (rows too wide for a
    block stream through it chunk by chunk)."""
    rows: int
    warps: int
    stages: int
    smem: int
    lists: str = "shared"
    chunk: int = 0

    def blocks(self, m: int, nq: int) -> int:
        """Blocks of a launch over ``m`` batches of ``nq`` query rows."""
        return m * -(-nq // self.rows)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def list_width(k: int) -> int:
    """Keys of a row's top-k list: k rounded up to 32."""
    return -(-k // 32) * 32


def smem_bytes(W: int, k: int, warps: int, stages: int,
               lists: str = "shared", chunk: int = 0) -> int:
    """The block's dynamic shared memory, from the kernel's layout: the
    query tile (W padded to 8 words, plus 4, per row; with ``chunk``, one
    tile of ``chunk`` + 4 words a row per ring stage; ids and cards) and a
    flag per warp and step; two key tiles of 16 rows × (32 per warp + 8)
    keys; per query row a sorted list of k rounded up to 32 keys (unless
    ``lists`` is "global") and a 32-key buffer, keys 8 bytes; then per warp
    its copy ring of ``stages`` database tiles of 32 rows (their words, or
    ``chunk`` words of them, ids and cards).
    ``repro_goldfinger_knn_smem_bytes`` in the kernel computes the same."""
    ws = (chunk if chunk else (W + 7) & ~7) + 4
    ks = warps * TILE + 8
    kp = 0 if lists == "global" else list_width(k)
    q_tiles = stages if chunk else 1
    head = _align16(ROWS * ws * 4 * q_tiles + 2 * ROWS * 4 + 2 * warps * 4)
    tiles = 2 * ROWS * ks * 8 + ROWS * (kp + TILE) * 8
    ring = _align16(stages * TILE * (ws + 2) * 4)
    return head + tiles + warps * ring


@functools.lru_cache(maxsize=None)
def launch_params(nq: int, nd: int, W: int, k: int) -> LaunchParams:
    """Launch parameters for ``nq`` query rows against ``nd`` database rows
    of ``W`` words at top-``k``: a warp per database tile of a step, as a
    power of two from ``MIN_WARPS`` to ``MAX_WARPS`` (the warps also share
    the 16 rows' top-k, so a block has at least ``MIN_WARPS``), two ring
    stages; then fewer warps, and one stage, until the block fits
    ``SMEM_LIMIT``. Above k = 64, where even that does not fit, the rows'
    lists move to global memory and the search starts again. Where whole
    rows fit no block, the same search runs with rows staged ``CHUNK``
    words at a time, which fits any W: one warp, one stage and global lists
    take under 48 KB."""
    del nq  # every shape takes 16-row query tiles
    tiles = -(-nd // TILE)
    start = MIN_WARPS
    while start < MAX_WARPS and start < tiles:
        start *= 2
    for chunk in (0, CHUNK):
        for lists in ("shared", "global") if k > REG_K else ("shared",):
            warps, stages = start, STAGES
            while True:
                smem = smem_bytes(W, k, warps, stages, lists, chunk)
                if smem <= SMEM_LIMIT:
                    return LaunchParams(ROWS, warps, stages, smem, lists,
                                        chunk)
                if warps > 1:
                    warps //= 2
                elif stages > 1:
                    stages -= 1
                else:
                    break
    raise AssertionError("unreachable: chunked rows fit a block at any W")


def _lib():
    lib = build.load(KERNEL)
    fn = lib.repro_goldfinger_knn
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        lib.repro_goldfinger_knn_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.repro_goldfinger_knn_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(q_words, q_card, q_ids, d_words, d_card, d_ids, k: int):
    """q_* [m, nq, ...], d_* [m, nd, ...] on one CUDA device."""
    global launches
    m, nq, W = q_words.shape
    nd = d_words.shape[1]
    dev = q_words.device
    tensors = (q_words, q_card, q_ids, d_words, d_card, d_ids)
    if any(t.dtype != torch.int32 or t.get_device() != dev.index
           for t in tensors):
        raise ValueError("cluster-KNN inputs must be int32 tensors on one "
                         "CUDA device")
    if (q_card.shape != (m, nq) or q_ids.shape != (m, nq)
            or d_words.shape != (m, nd, W) or d_card.shape != (m, nd)
            or d_ids.shape != (m, nd)):
        raise ValueError("cluster-KNN shape mismatch")
    if k < 1:
        raise ValueError(f"cluster-KNN needs k >= 1, got {k}")
    tensors = tuple(t.contiguous() for t in tensors)
    # One allocation for both outputs: ids, then the sims' bit patterns.
    out = torch.empty((2, m, nq, k), dtype=torch.int32, device=dev)
    out_ids, out_sims = out[0], out[1].view(torch.float32)
    if m == 0 or nq == 0:
        return out_ids, out_sims
    lib = _lib()
    p = launch_params(nq, nd, W, k)
    glob = p.lists == "global"
    smem = lib.repro_goldfinger_knn_smem_bytes(W, k, p.warps, p.stages,
                                               int(glob), p.chunk)
    if smem != p.smem:
        raise RuntimeError(f"cluster-KNN layout mismatch at W={W}, k={k}: "
                           f"the kernel needs {smem} B, smem_bytes says "
                           f"{p.smem}")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    # At most MAX_BATCHES clusters a launch; the rows of a cluster never
    # meet another's, so the split does not enter any result.
    for b0 in range(0, m, MAX_BATCHES):
        part = [t[b0:b0 + MAX_BATCHES] for t in tensors]
        mb = part[0].shape[0]
        lists = (torch.empty(p.blocks(mb, nq) * ROWS * list_width(k),
                             dtype=torch.int64, device=dev) if glob else None)
        vec16 = int(W % 4 == 0 and part[0].data_ptr() % 16 == 0
                    and part[3].data_ptr() % 16 == 0)
        args = ([t.data_ptr() for t in part]
                + [out_ids[b0:].data_ptr(), out_sims[b0:].data_ptr(), mb, nq,
                   nd, W, k, p.warps, p.stages, vec16, p.chunk,
                   None if lists is None else lists.data_ptr(), stream])
        if dev.index == torch.cuda.current_device():
            err = lib.repro_goldfinger_knn(*args)
        else:
            with torch.cuda.device(dev):
                err = lib.repro_goldfinger_knn(*args)
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
