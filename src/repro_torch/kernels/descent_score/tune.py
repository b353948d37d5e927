"""Shape-keyed launch parameters for the DMA descent hop
(``csrc/descent_hop_dma.cu``).

The DMA hop has three launch knobs — ``block_q`` (queries per block),
``score_chunk`` (candidate lanes per query per ring stage) and
``n_buffers`` (ring depth) — whose good values depend on the index shape
``(n, W, beam, kg+kr)``, not on the call site. :func:`hop_params`
resolves them in priority order: in-process memo → on-disk cache (JSON at
``$REPRO_TORCH_TUNE_CACHE``, if set) → measured table (entries recorded by
:func:`record`) → the shared-memory heuristic. Every resolution is
memoized, so a serving plan asks once per index shape. ``stats`` counts
hits and misses.

The heuristic budgets the block's whole dynamic shared memory,
:func:`smem_bytes`: the ring, ``n_buffers·block_q·score_chunk·(W+1)·4``
bytes, plus per query the staged beam and candidate lanes (ids and sims,
``(B + C)·8`` bytes with ``C = B·(kg+kr)``), a suppression flag per lane,
the query fingerprint and two counters. An H100 block may use at most
232,448 bytes; the heuristic aims at half an SM's shared memory so that
two blocks share each SM, and falls back to the whole limit when even
one-lane chunks do not fit that. It keeps ``block_q = 1``: a serving hop
has a few hundred query rows, and more queries per block would leave
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
_WARPS = 8                   # hop_common.cuh kThreads / 32
_SELECT_SCRATCH = 8 * _WARPS + 8   # sizeof(SelectScratch)


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


def smem_bytes(W: int, kdeg: int, beam: int, block_q: int, score_chunk: int,
               n_buffers: int) -> int:
    """The DMA hop block's dynamic shared memory in bytes, at kg+kr =
    ``kdeg``. The exported ``repro_descent_hop_dma_smem_bytes`` of
    ``csrc/descent_hop_dma.cu`` computes the same total from the kernel's
    own layout; the wrapper raises before any launch where they differ."""
    C = beam * kdeg
    ring = n_buffers * block_q * score_chunk * (W + 1) * 4
    per_query = (beam + C) * 8 + W * 4 + 2 * 4 + C
    return ring + block_q * per_query + _SELECT_SCRATCH


def shape_key(n: int, W: int, beam: int, kdeg: int) -> tuple[int, int, int, int]:
    return (int(n), int(W), int(beam), int(kdeg))


def _heuristic(n: int, W: int, beam: int, kdeg: int) -> HopParams:
    C = max(1, beam * kdeg)
    for budget in (TWO_PER_SM, SMEM_LIMIT):
        chunk = MAX_CHUNK
        while chunk > 1 and smem_bytes(W, kdeg, beam, 1, chunk, 2) > budget:
            chunk //= 2
        chunk = min(chunk, C)
        n_buffers = 1 if C <= chunk else 2
        if smem_bytes(W, kdeg, beam, 1, chunk, n_buffers) <= budget:
            break
    return HopParams(block_q=1, score_chunk=chunk, n_buffers=n_buffers)


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
