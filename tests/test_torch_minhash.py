"""The port's FastRandomHash held bitwise against the JAX reference.

The plain versions (what the CUDA kernel's two entries are checked against
on the card) and the CPU dispatch of ``ops.minhash`` against ``repro``'s
``minhash_ref`` and its Pallas kernel in interpret mode;
``dataset_minhash`` (the CSR entry) against the host CSR segment-min and
``repro``'s ``dataset_minhash``; the CSR entry's plain version against the
padded one's; ``user_min_hash_torch`` against ``user_min_hash_jnp``; the
distinct entry's plain version (``ops.distinct_csr`` on the CPU) against
both packages' ``user_distinct_hashes_np``, and ``build_plan``'s choice
between the kernel and the host table against ``repro``'s plan.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hashing as r_hashing  # noqa: E402
from repro.core.clustering import build_plan as r_build_plan  # noqa: E402
from repro.core.params import C2Params as RParams  # noqa: E402
from repro.kernels import config as r_kernel_config  # noqa: E402
from repro.kernels.frh_minhash import ops as r_mh_ops  # noqa: E402
from repro.kernels.frh_minhash import ref as r_mh_ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import clustering, hashing  # noqa: E402
from repro_torch.core.params import C2Params  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.kernels.frh_minhash import ops as mh_ops  # noqa: E402
from repro_torch.kernels.frh_minhash import ref as mh_ref  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402


@pytest.fixture(autouse=True)
def _pallas_interpret():
    r_kernel_config.set_interpret(True)
    yield
    r_kernel_config.set_interpret(None)


@pytest.mark.parametrize("n,P", [(8, 16), (100, 40), (256, 64), (300, 7)])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("b", [256, 4096])
def test_minhash_matches_reference(n, P, t, b):
    rng = np.random.default_rng(n + P + t + b)
    padded = rng.integers(0, 10**6, size=(n, P)).astype(np.int32)
    for i in range(n):
        padded[i, int(rng.integers(1, P + 1)):] = PAD_ID
    padded[0] = PAD_ID  # an empty profile: NO_HASH
    seeds = np.arange(t, dtype=np.int32) * 7 + 1
    want_ref = np.asarray(r_mh_ref.minhash_ref(jnp.asarray(padded),
                                               jnp.asarray(seeds), b))
    want_kernel = np.asarray(r_mh_ops.minhash(jnp.asarray(padded), seeds, b))
    np.testing.assert_array_equal(want_ref, want_kernel)
    got_ref = mh_ref.minhash_ref(torch.from_numpy(padded),
                                 torch.from_numpy(seeds), b)
    got_ops = mh_ops.minhash(torch.from_numpy(padded), seeds, b)
    assert got_ref.dtype == got_ops.dtype == torch.int32
    np.testing.assert_array_equal(got_ref.numpy(), want_ref)
    np.testing.assert_array_equal(got_ops.numpy(), want_ref)
    assert (got_ref[0] == int(hashing.NO_HASH)).all()


def test_minhash_wraps_uint32_seeds_and_items():
    """Seeds and items near and past 2^31 wrap as uint32, as the
    reference's."""
    padded = np.array([[2**31 - 1, 0, 12345, PAD_ID],
                       [7, 2**30 + 3, PAD_ID, PAD_ID]], np.int32)
    seeds = np.array([-1, -3, 2**31 - 1, 0], np.int32)
    want = np.asarray(r_mh_ref.minhash_ref(jnp.asarray(padded),
                                           jnp.asarray(seeds), 1 << 20))
    got = mh_ops.minhash(torch.from_numpy(padded), seeds, 1 << 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dataset_minhash_matches_host_csr():
    _check_dataset_minhash(4, 1024)


@pytest.mark.parametrize("t,b", [(1, 256), (32, 1 << 31)])
def test_dataset_minhash_seeds_and_widths(t, b):
    _check_dataset_minhash(t, b)


def _planted(ds, empty=(0, 5), one=()):
    """``ds`` with the rows ``empty`` and the last emptied and the rows
    ``one`` cut to their first item."""
    sizes = np.diff(ds.offsets)
    keep = np.ones(len(ds.items), bool)
    for u in (*empty, ds.n_users - 1):
        keep[ds.offsets[u]:ds.offsets[u + 1]] = False
    for u in one:
        keep[ds.offsets[u] + 1:ds.offsets[u + 1]] = False
    sizes = np.add.reduceat(keep, ds.offsets[:-1]) * (sizes > 0)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return type(ds)(name=ds.name, n_users=ds.n_users, n_items=ds.n_items,
                    items=ds.items[keep], offsets=offsets)


def _check_dataset_minhash(t, b):
    """``dataset_minhash`` (the CSR entry's plain version on the CPU)
    against the host CSR segment-min of both packages and against
    ``repro``'s ``dataset_minhash`` (its Pallas kernel in interpret mode
    over the padded profiles), with empty users among them."""
    ds = _planted(make_dataset("ml1M", scale=0.08, seed=7))
    seeds = np.arange(t, dtype=np.int32) * 3 - 1
    host = hashing.user_min_hash_np(hashing.item_hashes(ds.items, seeds, b),
                                    ds.offsets)
    got = mh_ops.dataset_minhash(ds, seeds, b, device="cpu")
    assert got.dtype == np.int32 and got.shape == (t, ds.n_users)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, r_hashing.user_min_hash_np(
        r_hashing.item_hashes(ds.items, seeds, b), ds.offsets))
    np.testing.assert_array_equal(got, r_mh_ops.dataset_minhash(ds, seeds, b))
    assert (got[:, [0, 5, ds.n_users - 1]] == int(hashing.NO_HASH)).all()


def test_minhash_csr_ref_matches_padded():
    """The two entries' plain versions agree on CSR rows and their padded
    copies: items near 2^31 - 1, one-item and empty users, offsets of
    every residue mod 4."""
    rng = np.random.default_rng(12)
    sizes = rng.integers(0, 9, size=50)
    sizes[:4] = (0, 1, 1, 0)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    items = rng.integers(2**31 - 40, 2**31, size=int(offsets[-1])).astype(
        np.int32)
    padded = np.full((50, int(sizes.max())), PAD_ID, np.int32)
    for u in range(50):
        padded[u, :sizes[u]] = items[offsets[u]:offsets[u + 1]]
    for t, b in ((1, 256), (8, 4096), (32, 1 << 31)):
        seeds = np.arange(t, dtype=np.int32) + 7
        got = mh_ops.minhash_csr(torch.from_numpy(offsets),
                                 torch.from_numpy(items), seeds, b)
        want = mh_ref.minhash_ref(torch.from_numpy(padded), seeds, b)
        assert got.dtype == torch.int32 and got.shape == (50, t)
        assert torch.equal(got, want)
        assert torch.equal(got, mh_ref.minhash_csr_ref(
            torch.from_numpy(offsets), torch.from_numpy(items), seeds, b))


def test_user_min_hash_torch_matches_jnp():
    rng = np.random.default_rng(9)
    n_users, nnz, t = 37, 400, 5
    user_of = np.sort(rng.integers(0, n_users - 3, size=nnz)).astype(np.int32)
    item_h = rng.integers(0, 4096, size=(t, nnz)).astype(np.int32)
    want = np.asarray(r_hashing.user_min_hash_jnp(
        jnp.asarray(item_h), jnp.asarray(user_of), n_users))
    got = hashing.user_min_hash_torch(torch.from_numpy(item_h),
                                      torch.from_numpy(user_of), n_users)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Users without items (the last three) hold NO_HASH.
    assert (got[:, -3:] == int(hashing.NO_HASH)).all()


@pytest.mark.parametrize("b", [0, 1000, 3 << 10])
def test_minhash_needs_a_power_of_two(b):
    padded = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        mh_ops.minhash(padded, [1], b)


def test_dataset_minhash_on_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("ml1M", scale=0.01, seed=7)
    with pytest.raises(RuntimeError, match="is_available"):
        mh_ops.dataset_minhash(ds, [1, 2], 1024)


@pytest.mark.parametrize("depth", [1, 6])
@pytest.mark.parametrize("b", [256, 4096, 1 << 31])
@pytest.mark.parametrize("t", [1, 8, 32])
def test_distinct_csr_matches_host_tables(t, b, depth):
    """``distinct_csr`` (the distinct entry's plain version on the CPU) on
    ml1M@0.08 with empty and one-item rows planted, bitwise both packages'
    ``user_distinct_hashes_np`` over ``item_hashes``: at b = 256 rows
    repeat hash values, one-item rows have fewer than ``depth``."""
    ds = _planted(make_dataset("ml1M", scale=0.08, seed=7), one=(1, 7, 40))
    seeds = np.arange(t, dtype=np.int32) * 3 - 1
    got = mh_ops.distinct_csr(torch.from_numpy(ds.offsets),
                              torch.from_numpy(ds.items), seeds, b, depth)
    assert got.dtype == torch.int32 and got.shape == (t, ds.n_users, depth)
    got = got.numpy()
    np.testing.assert_array_equal(got, hashing.user_distinct_hashes_np(
        hashing.item_hashes(ds.items, seeds, b), ds.offsets, depth))
    np.testing.assert_array_equal(got, r_hashing.user_distinct_hashes_np(
        r_hashing.item_hashes(ds.items, seeds, b), ds.offsets, depth))
    assert (got[:, [0, 5, ds.n_users - 1]] == int(hashing.NO_HASH)).all()
    assert (got[:, [1, 7, 40], 1:] == int(hashing.NO_HASH)).all()


def _unmix(h: int, seed: int) -> int:
    """The item whose hash under ``seed`` is fmix32's value ``h`` (fmix32
    is a bijection on uint32; this is its inverse, then the seed's mix)."""
    m32 = 0xFFFF_FFFF
    h ^= h >> 16
    h = (h * pow(0xC2B2_AE35, -1, 1 << 32)) & m32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EB_CA6B, -1, 1 << 32)) & m32
    h ^= h >> 16
    return h ^ (((seed + 1) * 0x9E37_79B9) & m32)


def test_distinct_csr_edges():
    """Items and seeds near 2^31, a hash equal to NO_HASH at b = 2^31
    (it sits where the padding does), repeated and too few distinct
    values, empty rows first and last: bitwise the host table."""
    seeds = np.array([2**31 - 1, -1, 0], np.int32)
    top = [_unmix(v, int(seeds[0]) & 0xFFFF_FFFF)
           for v in (0x7FFF_FFFF, 0xFFFF_FFFF, 5)]
    rng = np.random.default_rng(3)
    rows = [[], [2**31 - 1], top, top[:2] * 3, [top[2], 9, 9, 9],
            list(rng.integers(2**31 - 200, 2**31, size=70)), [3, 3],
            list(rng.integers(0, 50, size=200)), []]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    items = np.array([x - (1 << 32) if x >= 1 << 31 else x
                      for r in rows for x in r], np.int64).astype(np.int32)
    for b in (8, 1 << 20, 1 << 31):
        for depth in (1, 3, 8):
            got = mh_ops.distinct_csr(torch.from_numpy(offsets),
                                      torch.from_numpy(items), seeds, b,
                                      depth)
            want = hashing.user_distinct_hashes_np(
                hashing.item_hashes(items, seeds, b), offsets, depth)
            np.testing.assert_array_equal(got.numpy(), want)
    want = hashing.item_hashes(items[offsets[2]:offsets[3]], seeds[:1],
                               1 << 31)
    assert list(want[0]) == [2**31 - 1, 2**31 - 1, 5]


def _plans_equal(tp, rp):
    assert tp.paths == rp.paths
    np.testing.assert_array_equal(tp.config_of, rp.config_of)
    assert len(tp.members) == len(rp.members)
    for a, b in zip(tp.members, rp.members):
        np.testing.assert_array_equal(a, b)


def _no_launch(monkeypatch):
    """Make the distinct entry's launch fail the test."""
    def launch(*a, **kw):
        raise AssertionError("the distinct-hash kernel was launched")
    monkeypatch.setattr(mh_ops, "_launch_distinct", launch)


PLAN = dict(k=10, b=512, t=4, max_cluster=60, split_depth=6)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_build_plan_on_the_host_launches_nothing(monkeypatch, device):
    ds = make_dataset("ml1M", scale=0.08, seed=7)
    _no_launch(monkeypatch)
    tp = clustering.build_plan(ds, C2Params(**PLAN), device=device)
    _plans_equal(tp, r_build_plan(ds, RParams(**PLAN)))


def test_build_plan_on_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("ml1M", scale=0.01, seed=7)
    with pytest.raises(RuntimeError, match="is_available"):
        clustering.build_plan(ds, C2Params(**PLAN), device="cuda")


@pytest.mark.parametrize("change", [dict(b=1000), dict(t=33),
                                    dict(split_depth=9)])
def test_build_plan_outside_the_kernel_takes_the_host(monkeypatch, change):
    """A CUDA device with a ``b`` that is not a power of two, or ``t`` or a
    depth past the kernel's bounds: the host table, no launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _no_launch(monkeypatch)
    ds = make_dataset("ml1M", scale=0.03, seed=7)
    params = {**PLAN, **change}
    tp = clustering.build_plan(ds, C2Params(**params), device="cuda")
    _plans_equal(tp, r_build_plan(ds, RParams(**params)))


def test_build_plan_on_cuda_takes_the_kernel(monkeypatch):
    """A CUDA device with parameters that fit: ``clustering.hash`` takes
    the table from ``_device_cands`` (run here on the CPU, through the
    distinct entry's plain version), counting its copies and one device
    call; the plan equals the reference's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, device_cands = [], clustering._device_cands

    def on_cpu(ds, seeds, params, dev):
        calls.append(dev)
        return device_cands(ds, seeds, params, torch.device("cpu"))

    monkeypatch.setattr(clustering, "_device_cands", on_cpu)
    ds = _planted(make_dataset("ml1M", scale=0.08, seed=7), one=(1,))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        obs.reset()
        tp = clustering.build_plan(ds, C2Params(**PLAN), device="cuda")
        counts = obs.counters()
    assert calls == [torch.device("cuda")]
    _plans_equal(tp, r_build_plan(ds, RParams(**PLAN)))
    assert counts == {
        "clustering.device_calls": 1,
        "clustering.h2d_bytes": ds.offsets.nbytes + ds.items.nbytes,
        "clustering.d2h_bytes": 4 * PLAN["t"] * ds.n_users * 6}
