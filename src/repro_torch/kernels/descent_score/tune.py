"""Shape-keyed launch parameters for the DMA descent hop
(``csrc/descent_hop_dma.cu``).

The DMA hop has three launch knobs — ``block_q`` (queries per block),
``score_chunk`` (rows per ring stage) and ``n_buffers`` (ring depth) —
whose good values depend on the index shape ``(n, W, beam, kg+kr)``, not
on the call site. :func:`hop_params` resolves them in priority order:
in-process memo → on-disk cache (JSON at ``$REPRO_TORCH_TUNE_CACHE``, if
set) → measured table (entries recorded by :func:`record`) → the
shared-memory heuristic. Every resolution is memoized, so a serving plan
asks once per index shape. ``stats`` counts hits and misses.

How the kernel reads the knobs. A block takes its ``block_q`` queries one
after another through the same shared memory, so ``block_q`` sets how
many queries share a block, not how much memory it takes. A query's
candidate lanes are suppressed and deduplicated before any row moves, and
only its distinct surviving ids ("owners") are copied: ``score_chunk`` is
the owner rows of one ring stage (not candidate lanes, as in the
reference's VMEM tiling), each stage one ``mbarrier`` that its bulk
copies complete.

Where a query's state lives. The heuristic budgets the block's whole
dynamic shared memory, :func:`smem_bytes`: the ring,
``n_buffers·score_chunk·W·4`` bytes, and its barriers, then one query's
state (``csrc/hop_common.cuh`` ``Layout``: a hash table of ``1.5·L + 1``
12-byte slots over the ``L = B + C`` lanes with ``C = B·(kg+kr)``, each
slot an id, its lowest column and its lane count, which the lanes' keys
overwrite; the warps' top-B lists and buffers, the query fingerprint, the
lane ids, the beam sims and the owners' columns, ids and cards). An H100
block may use at most 232,448 bytes; the heuristic aims at half an SM's
shared memory so that two blocks share each SM, and falls back to the
whole limit when even one-row stages do not fit that. Where no ring fits
beside the state (at kg+kr = 60, beams above ~100 lanes), the state moves
to a per-block workspace in global memory (:func:`state_placement`
"global", :func:`workspace_stride` bytes a block) and the ring alone is
budgeted; the wrapper places the state by the same rule for the ring it
launches. The fused hop places its state by the same rule
with no ring. Beams wider than ``MAX_BEAM`` lanes, the most the warps'
register lists hold, are selected by a radix select instead, whose keys
take the lists' place in the state. It keeps ``block_q = 1``: a serving
hop has a few hundred query rows, and more queries per block would leave
some of the 132 SMs idle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"

SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
SM_SHARED = 233472           # bytes of shared memory on one H100 SM
BLOCK_RESERVED = 1024        # bytes the SM reserves for each resident block
TWO_PER_SM = SM_SHARED // 2 - BLOCK_RESERVED
MAX_BUFFERS = 4              # the kernel's deepest ring
MAX_CHUNK = 256
MAX_BEAM = 512               # hop_common.cuh kMaxBeam: the lists' widest
_WARPS = 16                  # hop_common.cuh kThreads / 32


@dataclasses.dataclass(frozen=True)
class HopParams:
    """Launch configuration for one (n, W, beam, kdeg) index shape."""
    block_q: int
    score_chunk: int
    n_buffers: int


stats = {"hits": 0, "misses": 0, "disk_hits": 0}

_lock = threading.Lock()
_memo: dict[tuple[int, int, int, int], HopParams] = {}
_measured: dict[tuple[int, int, int, int], HopParams] = {}
_disk_loaded = False


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _list_keys(beam: int) -> int:
    """Keys of the state's list: the warps' top-B lists of a power-of-2
    keys per lane, or the B selected keys of the radix select."""
    if beam > MAX_BEAM:
        return beam
    p = 1
    while 32 * p < beam:
        p *= 2
    return _WARPS * 32 * p


def _state_end(W: int, kdeg: int, beam: int, start: int) -> int:
    """End of one query's state laid out from byte ``start`` (a multiple
    of 16): ``Layout``'s offsets from its hash table on."""
    C = beam * kdeg
    L = beam + C
    slots = L + L // 2 + 1
    lists = start + _align(slots * 12, 8)
    buf = lists + _list_keys(beam) * 8
    qw = _align(buf + _WARPS * 32 * 8, 16)
    ids = qw + _align(W, 4) * 4
    bsim = ids + L * 4
    work = bsim + beam * 4
    misc = _align(work + 3 * C * 4, 8)  # owners' columns, ids, cards
    return misc + 16


def state_bytes(W: int, kdeg: int, beam: int, ring_rows: int,
                placement: str = "shared") -> int:
    """Shared memory of a hop block with ``ring_rows`` ring rows (0 for
    the fused hop): ``csrc/hop_common.cuh``'s ``Layout``, offset by
    offset. With ``placement`` "global" the state is in global memory and
    the block holds the ring and its barriers alone."""
    head = _align(ring_rows * W * 4, 16) + (2 * MAX_BUFFERS * 8
                                            if ring_rows > 0 else 0)
    if placement == "global":
        return head
    if placement != "shared":
        raise ValueError(f"placement must be 'shared' or 'global', got "
                         f"{placement!r}")
    return _state_end(W, kdeg, beam, head)


def workspace_stride(W: int, kdeg: int, beam: int) -> int:
    """Bytes of one block's state in global memory, 256-byte aligned
    (``hop_common.cuh`` ``workspace_stride``)."""
    return _align(_state_end(W, kdeg, beam, 0), 256)


def state_placement(W: int, kdeg: int, beam: int, ring_rows: int) -> str:
    """"shared" where the state fits one block's shared memory beside a
    ring of ``ring_rows`` rows, else "global"."""
    return ("shared" if state_bytes(W, kdeg, beam, ring_rows) <= SMEM_LIMIT
            else "global")


def smem_bytes(W: int, kdeg: int, beam: int, block_q: int, score_chunk: int,
               n_buffers: int, placement: str = "shared") -> int:
    """The DMA hop block's dynamic shared memory in bytes, at kg+kr =
    ``kdeg``, with the state in ``placement``. The exported
    ``repro_descent_hop_dma_smem_bytes`` of ``csrc/descent_hop_dma.cu``
    computes the same total from the kernel's own layout; the wrapper
    raises before any launch where they differ. ``block_q`` does not
    enter it: a block's queries reuse one state."""
    del block_q
    return state_bytes(W, kdeg, beam, n_buffers * score_chunk, placement)


def shape_key(n: int, W: int, beam: int, kdeg: int) -> tuple[int, int, int, int]:
    return (int(n), int(W), int(beam), int(kdeg))


def _heuristic(n: int, W: int, beam: int, kdeg: int) -> HopParams:
    C = max(1, beam * kdeg)
    for placement in ("shared", "global"):
        for budget in (TWO_PER_SM, SMEM_LIMIT):
            chunk = MAX_CHUNK
            while chunk > 1 and smem_bytes(W, kdeg, beam, 1, chunk, 2,
                                           placement) > budget:
                chunk //= 2
            chunk = min(chunk, C)
            n_buffers = 1 if C <= chunk else 2
            if smem_bytes(W, kdeg, beam, 1, chunk, n_buffers,
                          placement) <= budget:
                return HopParams(1, chunk, n_buffers)
    raise ValueError(f"the DMA hop's ring of one {W}-word row does not fit "
                     f"a block's shared memory")


def _cache_path() -> str | None:
    return os.environ.get(ENV_CACHE) or None


def _load_disk() -> None:
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    path = _cache_path()
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except (OSError, ValueError):
        return
    for skey, p in raw.items():
        try:
            key = tuple(int(x) for x in skey.split(","))
            if len(key) != 4:
                continue
            _measured[key] = HopParams(int(p["block_q"]),
                                       int(p["score_chunk"]),
                                       int(p["n_buffers"]))
        except (KeyError, TypeError, ValueError):
            continue


def _save_disk() -> None:
    path = _cache_path()
    if not path:
        return
    payload = {
        ",".join(str(x) for x in key): dataclasses.asdict(p)
        for key, p in sorted(_measured.items())
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def record(key: tuple[int, int, int, int], params: HopParams) -> None:
    """Record a measured winner for an index shape (and persist it)."""
    with _lock:
        _load_disk()
        _measured[key] = params
        _memo[key] = params
        _save_disk()


def hop_params(n: int, W: int, beam: int, kdeg: int,
               q: int | None = None) -> HopParams:
    """Resolve launch params for one index shape (memoized per process).

    ``n`` is the rows of one table: under the sharded placement a shard's
    ``cap``, not ``S·cap`` (each shard's blocks walk its own table).
    ``q`` (the rows of the hop) only clamps ``block_q``; it is not part of
    the key.
    """
    key = shape_key(n, W, beam, kdeg)
    with _lock:
        p = _memo.get(key)
        if p is None:
            _load_disk()
            p = _measured.get(key)
            if p is not None:
                stats["disk_hits"] += 1
            else:
                p = _heuristic(*key)
            stats["misses"] += 1
            _memo[key] = p
        else:
            stats["hits"] += 1
    if q is not None and q > 0 and p.block_q > q:
        p = dataclasses.replace(p, block_q=q)
    return p


def clear(reset_stats: bool = True) -> None:
    """Drop all in-process state (tests; does not touch the disk cache)."""
    global _disk_loaded
    with _lock:
        _memo.clear()
        _measured.clear()
        _disk_loaded = False
        if reset_stats:
            for k in stats:
                stats[k] = 0
