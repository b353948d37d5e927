"""The port's DMA descent hop held bitwise against the JAX reference.

``descent_hop(dma=True, with_counts=True)`` of the port (its plain version
on the CPU: what the CUDA DMA hop is checked against on the card) against
``repro``'s Pallas DMA hop in interpret mode: ids, sims, ``n_scored``,
``dma_bytes`` and ``bytes_saved``, across sketch widths on both sides of
the 16-byte copy rule, score chunks that do not divide the lanes, one- and
two-deep rings, all-suppressed chunks and tombstone-heavy tables; the
serving ``descent_step`` statistics; and the launch-parameter tuner.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.kernels.descent_score import ops as r_ds_ops  # noqa: E402
from repro.query import search as r_search  # noqa: E402
from repro_torch.kernels.descent_score import ops as ds_ops  # noqa: E402
from repro_torch.kernels.descent_score import tune  # noqa: E402
from repro_torch.query import search  # noqa: E402
from repro_torch.sketch.goldfinger import words_tensor  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


def _random_words(rng, n, W):
    w = (rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
         & rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
         ).astype(np.uint32)
    card = np.unpackbits(w.view(np.uint8), axis=1).sum(1).astype(np.int32)
    return w, card


def _hop_inputs(rng, n, kg, kr, W, q, B, *, tomb_frac=0.0):
    g = rng.integers(-1, n, size=(n, kg)).astype(np.int32)
    r = rng.integers(-1, n, size=(n, kr)).astype(np.int32)
    w, c = _random_words(rng, n, W)
    qw, qc = _random_words(rng, q, W)
    bi = np.full((q, B), PAD_ID, np.int32)
    for i in range(q):
        m = int(rng.integers(0, min(n, B) + 1))
        bi[i, :m] = rng.choice(n, size=m, replace=False)
    bs = np.where(bi == PAD_ID, NEG_INF,
                  -np.sort(-rng.random((q, B)))).astype(np.float32)
    tomb = rng.random(n) < tomb_frac if tomb_frac > 0 else None
    return (g, r, w, c, qw, qc, bi, bs), tomb


def _torch_args(arrays):
    g, r, w, c, qw, qc, bi, bs = arrays
    return (torch.from_numpy(g), torch.from_numpy(r), words_tensor(w, "cpu"),
            torch.from_numpy(c), words_tensor(qw, "cpu"), torch.from_numpy(qc),
            torch.from_numpy(bi), torch.from_numpy(bs))


def _assert_dma_parity(arrays, tomb=None, **dma_kw):
    """The port's DMA hop against repro's, bitwise in every output, and
    the byte counters exact against the scored lanes."""
    B, W = arrays[6].shape[1], arrays[2].shape[1]
    C = B * (arrays[0].shape[1] + arrays[1].shape[1])
    r_out = r_ds_ops.descent_hop(
        *(jnp.asarray(x) for x in arrays),
        tomb=None if tomb is None else jnp.asarray(tomb), dma=True,
        with_counts=True, **dma_kw)
    t_out = ds_ops.descent_hop(
        *_torch_args(arrays),
        tomb=None if tomb is None else torch.from_numpy(tomb), dma=True,
        with_counts=True, **dma_kw)
    for name, a, b in zip(("ids", "sims", "n_scored", "dma_bytes",
                           "bytes_saved"), r_out, t_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    nsc, dmab, saved = (x.numpy() for x in t_out[2:])
    np.testing.assert_array_equal(dmab, nsc * W * 4)
    np.testing.assert_array_equal(saved, (C - nsc) * W * 4)
    # The hop kernel's placement moves no per-row bytes.
    v_out = ds_ops.descent_hop(
        *_torch_args(arrays),
        tomb=None if tomb is None else torch.from_numpy(tomb),
        with_counts=True)
    for a, b in zip(v_out[:3], t_out[:3]):
        assert torch.equal(a, b)
    assert not v_out[3].any() and not v_out[4].any()
    return nsc, dmab, saved


@pytest.mark.parametrize("W", [1, 2, 64, 65])
@pytest.mark.parametrize("chunk,n_buffers", [(3, 2), (7, 1), (None, 2)])
def test_dma_parity_sweep(W, chunk, n_buffers):
    rng = np.random.default_rng(W * 100 + (chunk or 0) * 10 + n_buffers)
    arrays, tomb = _hop_inputs(rng, 45, 4, 5, W, 6, 5, tomb_frac=0.4)
    kw = {"n_buffers": n_buffers}
    if chunk is not None:
        kw["score_chunk"] = chunk
    # The same launch fits one block on the card (the ring holds
    # n_buffers · score_chunk rows beside one query's state).
    p = tune.hop_params(45, W, 5, 9)
    assert tune.smem_bytes(W, 9, 5, p.block_q, chunk or p.score_chunk,
                           n_buffers) <= tune.SMEM_LIMIT
    _assert_dma_parity(arrays, tomb=tomb, **kw)


def test_dma_all_suppressed_chunks():
    """Beams that already hold every reachable neighbour: every lane is
    suppressed, nothing is fetched or scored, every byte is saved."""
    rng = np.random.default_rng(3)
    n, B, W = 6, 6, 4
    g = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n],
                 axis=1).astype(np.int32)
    r = np.stack([(np.arange(n) - 1) % n], axis=1).astype(np.int32)
    w, c = _random_words(rng, n, W)
    qw, qc = _random_words(rng, 5, W)
    bi = np.tile(np.arange(n, dtype=np.int32), (5, 1))
    bs = -np.sort(-rng.random((5, B))).astype(np.float32)
    C = B * (g.shape[1] + r.shape[1])
    nsc, dmab, saved = _assert_dma_parity((g, r, w, c, qw, qc, bi, bs),
                                          score_chunk=5)
    assert (nsc == 0).all() and (dmab == 0).all()
    assert (saved == C * W * 4).all()


def test_dma_tombstone_heavy():
    """Mostly dead tables: dead lanes are never fetched, so the traffic
    shrinks against the same hop on a live table."""
    rng = np.random.default_rng(17)
    arrays, _ = _hop_inputs(rng, 50, 5, 4, 4, 9, 6)
    tomb = rng.random(50) < 0.8
    _, live_bytes, _ = _assert_dma_parity(arrays)
    _, dead_bytes, dead_saved = _assert_dma_parity(arrays, tomb=tomb)
    assert dead_bytes.sum() < live_bytes.sum()
    assert dead_saved.sum() > 0


def test_dma_parity_wide_beam():
    """A beam of 128 lanes over kg+kr = 60 edges, the shape whose state
    the CUDA hops keep in global memory: the port's plain hops equal
    repro's Pallas hops, counters included."""
    rng = np.random.default_rng(128)
    arrays, tomb = _hop_inputs(rng, 400, 30, 30, 32, 2, 128, tomb_frac=0.1)
    assert tune.state_placement(32, 60, 128, 0) == "global"
    _assert_dma_parity(arrays, tomb=tomb)


@pytest.mark.parametrize("kernel,dma", [(False, False), (True, False),
                                        (True, True)])
def test_descent_step_stats_match_reference(kernel, dma):
    """``descent_step``'s int32[q, 3] hop statistics for each scorer."""
    rng = np.random.default_rng(11 + 2 * kernel + dma)
    arrays, tomb = _hop_inputs(rng, 60, 5, 6, 8, 7, 6, tomb_frac=0.2)
    r_out = r_search.descent_step(*(jnp.asarray(x) for x in arrays),
                                  kernel=kernel, dma=dma,
                                  tomb=jnp.asarray(tomb))
    t_out = search.descent_step(*_torch_args(arrays), kernel=kernel, dma=dma,
                                tomb=torch.from_numpy(tomb))
    for a, b in zip(r_out, t_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert t_out[2].shape == (7, 3) and t_out[2].dtype == torch.int32


# -- the launch-parameter tuner ---------------------------------------------


def test_tune_memoizes_per_shape():
    tune.clear()
    try:
        p1 = tune.hop_params(1000, 16, 32, 20)
        assert tune.stats["misses"] == 1
        assert tune.hop_params(1000, 16, 32, 20) == p1
        assert tune.stats["hits"] == 1
        tune.hop_params(1000, 64, 32, 20)
        assert tune.stats["misses"] == 2
        # The row count only clamps block_q, never forks the key.
        assert tune.hop_params(1000, 16, 32, 20, q=1).block_q == 1
        assert tune.stats["misses"] == 2
    finally:
        tune.clear()


# Shapes whose state overflows a block's shared memory beside any ring:
# the paper index (kg+kr = 60) served with beams of 128 and 1,024 lanes.
GLOBAL_STATE = {(32, 128, 60), (32, 1024, 60)}


@pytest.mark.parametrize("W,beam,kdeg", [(1, 32, 60), (32, 32, 60),
                                         (64, 32, 60), (1024, 32, 60),
                                         (32, 64, 64), (1, 4, 8),
                                         (32, 128, 60), (32, 1024, 60)])
def test_tune_heuristic_fits_shared_memory(W, beam, kdeg):
    """Every heuristic result fits one H100 block, and two blocks per SM
    wherever one-row stages allow it; (32, 32, 60) is the main path's
    ml1M@1.0 hop (k=30 forward and reverse edges, beam 32). A state that
    fits no block beside a ring goes to global memory, and the ring alone
    is budgeted; the fused hop (no ring) places its state by the same
    rule."""
    tune.clear()
    try:
        p = tune.hop_params(6038, W, beam, kdeg)
    finally:
        tune.clear()
    want = "global" if (W, beam, kdeg) in GLOBAL_STATE else "shared"
    placement = tune.state_placement(W, kdeg, beam,
                                     p.score_chunk * p.n_buffers)
    assert placement == want
    assert tune.state_placement(W, kdeg, beam, 0) == want
    assert p.block_q >= 1 and p.score_chunk >= 1
    assert 1 <= p.n_buffers <= tune.MAX_BUFFERS
    total = tune.smem_bytes(W, kdeg, beam, p.block_q, p.score_chunk,
                            p.n_buffers, placement)
    assert total <= tune.SMEM_LIMIT
    if tune.smem_bytes(W, kdeg, beam, 1, 1, 1, placement) <= tune.TWO_PER_SM:
        assert total <= tune.TWO_PER_SM
    if want == "global":  # the block holds the ring and its barriers alone
        assert total == (p.score_chunk * p.n_buffers * W * 4
                         + 2 * tune.MAX_BUFFERS * 8)
        assert tune.workspace_stride(W, kdeg, beam) % 256 == 0
        assert (tune.workspace_stride(W, kdeg, beam)
                >= tune.state_bytes(W, kdeg, beam, 0) > tune.SMEM_LIMIT)
    C = beam * kdeg
    assert p.score_chunk <= C
    assert p.n_buffers == (1 if C <= p.score_chunk else 2)


def test_tune_main_path_ring():
    """At the main path's shapes the ring is two stages of 128 rows: one
    query's state (~74 KB: the hash table the keys overwrite, the warps'
    lists, the lane ids, the owners) leaves room for two 107 KB blocks per
    SM. The reference's VMEM tiling (block_q 16, chunk 128) fits too, since
    a block's queries take turns in one state."""
    tune.clear()
    try:
        p = tune.hop_params(6038, 32, 32, 60, q=256)
    finally:
        tune.clear()
    assert p == tune.HopParams(block_q=1, score_chunk=128, n_buffers=2)
    assert tune.smem_bytes(32, 60, 32, 1, 128, 2) <= tune.TWO_PER_SM
    assert tune.smem_bytes(32, 60, 32, 1, 256, 2) > tune.TWO_PER_SM
    assert (tune.smem_bytes(32, 60, 32, 16, 128, 2)
            == tune.smem_bytes(32, 60, 32, 1, 128, 2) <= tune.SMEM_LIMIT)


@pytest.mark.parametrize("W", [1, 32, 33, 64])
def test_tune_knobs_read_as_the_kernel_reads_them(W):
    """block_q does not enter shared memory (a block's queries take turns
    in one state); each ring row is one fingerprint row of W words, no card
    word beside it; and the ring and its 8 mbarriers come on top of the
    fused hop's state (``state_bytes(..., 0)``)."""
    base = tune.smem_bytes(W, 60, 32, 1, 64, 2)
    for bq in (2, 3, 16):
        assert tune.smem_bytes(W, 60, 32, bq, 64, 2) == base
    ring = -(-(2 * 64 * W * 4) // 16) * 16
    assert base == tune.state_bytes(W, 60, 32, 0) + ring + 2 * 4 * 8
    if W % 4 == 0:
        assert (tune.smem_bytes(W, 60, 32, 1, 65, 2) - base) == 2 * W * 4


def test_tune_disk_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_CACHE, str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    tune.clear()
    try:
        key = tune.shape_key(512, 16, 24, 18)
        tune.record(key, tune.HopParams(2, 32, 2))
        tune.clear()  # drop the memo; force the disk path
        assert tune.hop_params(*key) == tune.HopParams(2, 32, 2)
        assert tune.stats["disk_hits"] == 1
    finally:
        tune.clear()
    assert tune.ENV_CACHE == "REPRO_TORCH_TUNE_CACHE"
