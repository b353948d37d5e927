"""The cluster-KNN kernel's launch shapes and the invariant its design
rests on, checked on the CPU.

The kernel (``csrc/goldfinger_knn.cu``) splits each query tile's database
axis across warps, keeps a top-k per warp ordered by one 64-bit key
(sim desc, column asc), and merges the warps' lists. That is bitwise the
plain version exactly when the top-k over column slices, merged in that
order, equals the top-k over the whole database: the property below. The
kernel itself runs only on the card (``chip_smoke.py`` holds it bitwise
against ``ref``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core.clustering import ClusterPlan, build_plan  # noqa: E402
from repro_torch.core.local_knn import group_batches  # noqa: E402
from repro_torch.core.params import params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.kernels.goldfinger_knn import ops, ref  # noqa: E402
from repro_torch.knn.topk import topk_desc  # noqa: E402
from repro_torch.sketch.goldfinger import popcount_rows, words_tensor  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402


def pack_keys(sims: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (sim desc, column asc) as the kernel's
    unsigned 64-bit keys: high half the sim's order-preserving bits (as a
    signed int, the kernel's ``bits | 0x80000000`` less 2**31), low half
    0xFFFFFFFF − column."""
    b = sims.contiguous().view(torch.int32).to(torch.int64)
    hi = b ^ ((b >> 31) & 0x7FFFFFFF)
    return hi * (1 << 32) + (0xFFFFFFFF - cols.to(torch.int64))


@pytest.mark.parametrize("W", [1, 31, 32, 33, 64])
def test_launch_params_fit_a_block(W):
    for cap in (32, 64, 128, 256, 512, 1024, 2048):
        for k in (1, 10, 30, 32, 33, 64, 65, 100, 256):
            p = ops.launch_params(cap, cap, W, k)
            assert p.smem == ops.smem_bytes(W, k, p.warps, p.stages, p.lists)
            assert p.smem <= ops.SMEM_LIMIT
            assert p.warps in (1, 2, 4, 8) and p.stages in (1, 2)
            assert p.rows == 16
            # Warps divide the 16 rows, and a list holds k keys: in the
            # warps' registers up to k = 64 (one or two keys a lane).
            assert 16 % p.warps == 0
            assert k <= ops.list_width(k) == (64 if k > 32 else 32) \
                or k > ops.REG_K
            assert p.lists == "shared"
            assert p.blocks(3, cap) == 3 * (cap // 16)
    assert ops.launch_params(17, 1000, W, 10).blocks(1, 17) == 2


@pytest.mark.parametrize("k,lists,warps", [(100, "shared", 8),
                                           (256, "shared", 8),
                                           (1000, "shared", 4),
                                           (2048, "global", 8)])
def test_launch_params_wide_k(k, lists, warps):
    """Above k = 64 a row's list is k rounded up to 32 keys, merged in
    memory: in shared memory beside the tiles where 16 of them fit (with
    fewer warps if need be), else in global memory. k = 30, the main
    path's, keeps its layout."""
    p = ops.launch_params(2048, 2048, 32, k)
    assert (p.lists, p.warps) == (lists, warps)
    assert p.smem == ops.smem_bytes(32, k, p.warps, p.stages, lists)
    assert p.smem <= ops.SMEM_LIMIT
    assert ops.list_width(k) == -(-k // 32) * 32
    assert ops.launch_params(2048, 2048, 32, 30) == ops.LaunchParams(
        16, 8, 2, ops.smem_bytes(32, 30, 8, 2))


def test_launch_params_raise_when_nothing_fits():
    """Rows too wide for a block (raw incidence rows: 4,236 words on GW,
    5,355 on AM, 6,345 on DBLP) stream through it in chunks, so every
    width fits; at 1,104 words and k = 30 whole rows still fit as before."""
    for W in (1105, 2000, 4236, 5355, 6345):
        for k in (10, 30, 100, 2048):
            for cap in (32, 256, 2048):
                p = ops.launch_params(cap, cap, W, k)
                assert p.smem == ops.smem_bytes(W, k, p.warps, p.stages,
                                                p.lists, p.chunk)
                assert p.smem <= ops.SMEM_LIMIT
                assert p.chunk in (0, ops.CHUNK) and ops.CHUNK % 8 == 0
                # Above k = 64 whole rows may still fit beside global lists.
                assert p.chunk == ops.CHUNK or (k > ops.REG_K
                                                and p.lists == "global")
    assert ops.launch_params(64, 64, 1104, 30).chunk == 0


# Step-2 batches of the ml1M@1.0 paper build (k = 30), per capacity:
# (launches, clusters), and so 16-row blocks per launch at least
# clusters / launches * cap / 16.
MAIN_PATH = {32: (8, 720), 64: (8, 89), 128: (8, 111), 256: (8, 77),
             512: (8, 22), 1024: (5, 8), 2048: (1, 1)}


def test_main_path_batches_fill_more_blocks():
    ds = make_dataset("ml1M", scale=1.0, seed=0)
    plan = build_plan(ds, params_for("ml1M", k=30))
    W = 32
    seen = {}
    for i in range(plan.t):  # as knn_build: one call per configuration
        members = [m for m, c in zip(plan.members, plan.config_of) if c == i]
        sub = ClusterPlan(members=members,
                          config_of=np.zeros(len(members), np.int32),
                          n_users=plan.n_users, t=1)
        for cap, batch, _ in group_batches(sub, W):
            p = ops.launch_params(cap, cap, W, 30)
            seen.setdefault(cap, []).append(p.blocks(len(batch), cap))
    assert {c: (len(b), sum(b) * 16 // c) for c, b in seen.items()} \
        == MAIN_PATH
    for cap, blocks in seen.items():
        launches, clusters = MAIN_PATH[cap]
        assert sum(blocks) / launches >= clusters / launches * cap / 16
        # A warp per database tile of a step, from 4 to 8.
        assert ops.launch_params(cap, cap, W, 30).warps == min(8, max(
            4, cap // 32))


def test_key_order_is_topk_desc_order():
    rng = np.random.default_rng(0)
    sims = rng.choice(np.float32([0.0, 0.125, 0.5, 0.5, 1 / 3, 0.9, 1.0,
                                  NEG_INF]), size=(40, 50))
    sims = torch.from_numpy(sims)
    cols = torch.arange(50).expand(40, 50)
    keys = pack_keys(sims, cols)
    order = torch.argsort(keys, dim=1, descending=True)
    _, pos = topk_desc(sims, 50)
    assert torch.equal(order, pos)
    assert len(torch.unique(keys[0])) == 50


def _inputs(rng, nq, nd, W, pad_frac):
    """Query and database rows with planted equal sims and scattered PAD
    ids; database ids are the columns, so a returned id is its column."""
    dw = rng.integers(0, 2**32, size=(nd, W), dtype=np.uint64)
    dw &= rng.integers(0, 2**32, size=(nd, W), dtype=np.uint64)
    dw = dw.astype(np.uint32)
    dw[1::3] = dw[0]  # repeated fingerprints tie against every query
    qw = dw[rng.integers(0, nd, size=nq)]
    qw[::2] = dw[0]
    d_ids = np.arange(nd, dtype=np.int32)
    d_ids[rng.random(nd) < pad_frac] = PAD_ID
    q_ids = rng.permutation(nd + nq)[:nq].astype(np.int32)  # some are columns
    q_ids[rng.random(nq) < pad_frac / 2] = PAD_ID
    t = torch.from_numpy
    return (words_tensor(qw, "cpu"), t(popcount_rows(qw)), t(q_ids),
            words_tensor(dw, "cpu"), t(popcount_rows(dw)), t(d_ids))


def _merged_slices(args, k, cuts):
    """Top-k of each database column slice, merged by (sim desc, column
    asc) through the packed keys."""
    qw, qc, qi, dw, dc, di = args
    keys = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        ids, sims = ref.knn_ref(qw, qc, qi, dw[a:b], dc[a:b], di[a:b], k)
        live = ids != PAD_ID
        keys.append(torch.where(live, pack_keys(sims, ids),
                                torch.iinfo(torch.int64).min))
    top = torch.sort(torch.cat(keys, 1), dim=1, descending=True).values
    nq = qw.shape[0]
    top = torch.cat([top, torch.full((nq, k), torch.iinfo(torch.int64).min)],
                    1)[:, :k]
    empty = top == torch.iinfo(torch.int64).min
    cols = (0xFFFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32)
    hi = (top >> 32).to(torch.int32)
    bits = hi ^ ((hi >> 31) & 0x7FFFFFFF)
    sims = torch.where(empty, NEG_INF, bits.view(torch.float32))
    return torch.where(empty, PAD_ID, cols), sims


def flush_in_memory(lst: list, buf: list, k: int) -> list:
    """``flush_row_mem`` of the kernel on packed keys: the list (descending,
    its keys only) and the buffer (any order, distinct keys) merged by
    placing every key at its rank, its index in its own sorted list plus
    the keys of the other above it; ranks from k on are dropped."""
    buf = sorted(buf, reverse=True)
    out = [None] * k
    for i, x in enumerate(lst):
        at = i + sum(b > x for b in buf)
        if at < k:
            out[at] = x
    for j, x in enumerate(buf):
        at = j + sum(y > x for y in lst)
        if at < k:
            out[at] = x
    return [x for x in out if x is not None]


def test_merge_in_memory_is_the_top_k():
    """Above k = 64 the kernel filters each 32-key tile against its row's
    k-th key, buffers the survivors and merges a full buffer into the list
    in memory by rank: the result is the top-k of the whole row, in
    order."""
    rng = np.random.default_rng(5)
    for _ in range(60):
        n, k = int(rng.integers(1, 700)), int(rng.integers(65, 300))
        sims = torch.from_numpy(rng.choice(
            np.float32([0.0, 0.125, 0.5, 1 / 3, 0.9, 1.0, NEG_INF]), size=n))
        keys = pack_keys(sims, torch.arange(n))
        keys = [int(x) for x, s in zip(keys, sims) if s != NEG_INF]
        lst, buf = [], []
        for t in range(0, len(keys), 32):
            thr = lst[k - 1] if len(lst) >= k else None
            keep = [x for x in keys[t:t + 32] if thr is None or x > thr]
            if len(buf) + len(keep) > 32:
                lst, buf = flush_in_memory(lst, buf, k), []
                thr = lst[k - 1] if len(lst) >= k else None
                keep = [x for x in keep if thr is None or x > thr]
            buf += keep
        lst = flush_in_memory(lst, buf, k)
        assert lst == sorted(keys, reverse=True)[:k]


@pytest.mark.parametrize("k", [65, 100])
def test_plain_cluster_knn_wide_k_matches_pallas(k):
    """k above 64 and above a cluster's size: the plain version (what the
    kernel is held to on the card) equals repro's Pallas kernel in
    interpret mode, slots past the cluster's members PAD/-inf."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import config as r_kernel_config
    from repro.kernels.goldfinger_knn import ops as r_gk_ops

    rng = np.random.default_rng(k)
    m, cap, W = 3, 64, 8
    w = rng.integers(0, 2**32, size=(m, cap, W), dtype=np.uint64)
    w = (w & rng.integers(0, 2**32, size=w.shape, dtype=np.uint64)).astype(
        np.uint32)
    w[:, 1::5] = w[:, :1]  # equal sims
    ids = rng.permutation(m * cap * 2)[: m * cap].astype(np.int32).reshape(
        m, cap)
    ids[1, 40:] = PAD_ID
    ids[2, 1:] = PAD_ID  # a lone member
    w[ids == PAD_ID] = 0
    card = popcount_rows(w.reshape(-1, W)).reshape(m, cap)
    r_kernel_config.set_interpret(True)
    try:
        r_ids, r_sims = r_gk_ops.cluster_knn(jnp.asarray(w), jnp.asarray(card),
                                             jnp.asarray(ids), k)
    finally:
        r_kernel_config.set_interpret(None)
    args = (words_tensor(w, "cpu"), torch.from_numpy(card),
            torch.from_numpy(ids))
    p_ids, p_sims = ops.cluster_knn(*args, k)  # CPU tensors: plain path
    assert p_ids.shape == (m, cap, k)
    np.testing.assert_array_equal(np.asarray(r_ids), p_ids.numpy())
    np.testing.assert_array_equal(np.asarray(r_sims), p_sims.numpy())
    assert (p_ids[:, :, cap - 1:] == PAD_ID).all()


def test_split_database_merges_to_the_whole():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None, database=None)
    @given(seed=st.integers(0, 2**31 - 1), nq=st.integers(1, 20),
           nd=st.integers(1, 300), W=st.integers(1, 4), k=st.integers(1, 130),
           slices=st.integers(1, 8), pad=st.sampled_from([0.0, 0.2, 0.6]))
    def battery(seed, nq, nd, W, k, slices, pad):
        rng = np.random.default_rng(seed)
        args = _inputs(rng, nq, nd, W, pad)
        cuts = np.unique(np.concatenate(
            [[0, nd], rng.integers(0, nd + 1, size=slices - 1)]))
        ids, sims = _merged_slices(args, k, cuts)
        w_ids, w_sims = ref.knn_ref(*args, k)
        width = w_ids.shape[1]  # the plain version keeps min(k, nd)
        assert torch.equal(ids[:, :width], w_ids)
        assert torch.equal(sims[:, :width], w_sims)
        assert (ids[:, width:] == PAD_ID).all()

    battery()
