"""Port foundations held bitwise against the JAX reference.

Hashing, fingerprints, popcount, the Jaccard estimator across sketch
widths, and the top-k selection helpers — including the tie-break and
stable-sort hazards ``torch.topk`` / ``torch.argsort`` would introduce.
Inputs are made with numpy from a seed and fed to both packages.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import clustering as r_clustering  # noqa: E402
from repro.core import hashing as r_hashing  # noqa: E402
from repro.core.params import params_for as r_params_for  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.eval.metrics import knn_recall as r_knn_recall  # noqa: E402
from repro.knn import topk as r_topk  # noqa: E402
from repro.knn.greedy import reverse_neighbors_np as r_reverse  # noqa: E402
from repro.sketch import goldfinger as r_gf  # noqa: E402
from repro_torch.core import clustering as t_clustering  # noqa: E402
from repro_torch.core import hashing as t_hashing  # noqa: E402
from repro_torch.core.params import params_for as t_params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset as t_make_dataset  # noqa: E402
from repro_torch.eval.metrics import knn_recall as t_knn_recall  # noqa: E402
from repro_torch.knn import topk as t_topk  # noqa: E402
from repro_torch.knn.greedy import reverse_neighbors_np as t_reverse  # noqa: E402
from repro_torch.sketch import goldfinger as t_gf  # noqa: E402
from repro_torch.types import NEG_INF, PAD_ID  # noqa: E402


def _words(rng, n, W):
    w = rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
    w &= rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
    return w.astype(np.uint32)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ds_pair():
    return (r_make_dataset("ml1M", scale=0.05, seed=3),
            t_make_dataset("ml1M", scale=0.05, seed=3))


def test_dataset_copy_is_identical(ds_pair):
    r, t = ds_pair
    assert (r.name, r.n_users, r.n_items) == (t.name, t.n_users, t.n_items)
    _eq(r.items, t.items)
    _eq(r.offsets, t.offsets)


@pytest.mark.parametrize("b", [64, 4096])
def test_fmix32_and_item_hashes(b):
    rng = np.random.default_rng(b)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    _eq(r_hashing.fmix32(x), t_hashing.fmix32(x))
    items = rng.integers(0, 200_000, size=3000).astype(np.int32)
    seeds = np.arange(8, dtype=np.int32) + 1009
    _eq(r_hashing.item_hashes(items, seeds, b),
        t_hashing.item_hashes(items, seeds, b))


def test_hash_tables_and_cluster_plan(ds_pair):
    r_ds, t_ds = ds_pair
    seeds = np.arange(4, dtype=np.int32)
    item_h = r_hashing.item_hashes(r_ds.items, seeds, 512)
    _eq(r_hashing.user_min_hash_np(item_h, r_ds.offsets),
        t_hashing.user_min_hash_np(item_h, t_ds.offsets))
    _eq(r_hashing.user_distinct_hashes_np(item_h, r_ds.offsets, 6),
        t_hashing.user_distinct_hashes_np(item_h, t_ds.offsets, 6))
    users = np.arange(0, r_ds.n_users, 7)
    _eq(r_hashing.user_hash_above_np(item_h[1], r_ds.offsets, 100, users),
        t_hashing.user_hash_above_np(item_h[1], t_ds.offsets, 100, users))
    rp = r_clustering.build_plan(r_ds, r_params_for("ml1M", k=10))
    tp = t_clustering.build_plan(t_ds, t_params_for("ml1M", k=10))
    assert rp.paths == tp.paths
    _eq(rp.config_of, tp.config_of)
    assert len(rp.members) == len(tp.members)
    for a, b in zip(rp.members, tp.members):
        _eq(a, b)


@pytest.mark.parametrize("n_bits", [256, 1024, 2048, 3072])
def test_fingerprints_and_popcount(ds_pair, n_bits):
    r_ds, t_ds = ds_pair
    r = r_gf.fingerprint_dataset(r_ds, n_bits=n_bits, seed=1)
    t = t_gf.fingerprint_dataset(t_ds, n_bits=n_bits, seed=1)
    _eq(r.words, t.words)
    _eq(r.card, t.card)
    words = t_gf.words_tensor(t.words, "cpu")
    _eq(r.card, t_gf.popcount32(words).sum(dim=1, dtype=torch.int32))
    _eq(t.words, words.numpy().view(np.uint32))


@pytest.mark.parametrize("W", [32, 64, 96])
def test_jaccard_pairwise_across_widths(W):
    """W on both sides of MXU_MIN_WORDS: the reference switches to the
    bit-plane matmul at 64 words; the port's popcount matches both."""
    rng = np.random.default_rng(W)
    wa, wb = _words(rng, 23, W), _words(rng, 31, W)
    wb[:4] = wa[:4]  # equal rows: sims of exact ties
    wa[5] = 0        # an empty sketch: union 0 against another empty one
    wb[6] = 0
    ca, cb = r_gf.popcount_rows(wa), r_gf.popcount_rows(wb)
    ref = r_gf.jaccard_pairwise_auto(jnp.asarray(wa), jnp.asarray(ca),
                                     jnp.asarray(wb), jnp.asarray(cb))
    _eq(r_gf.jaccard_pairwise(jnp.asarray(wa), jnp.asarray(ca),
                              jnp.asarray(wb), jnp.asarray(cb)), ref)
    got = t_gf.jaccard_pairwise(t_gf.words_tensor(wa, "cpu"),
                                torch.from_numpy(ca),
                                t_gf.words_tensor(wb, "cpu"),
                                torch.from_numpy(cb))
    assert got.dtype == torch.float32
    _eq(ref, got)
    _eq(r_gf.unpack_bits_int8(jnp.asarray(wa)),
        t_gf.unpack_bits_int8(t_gf.words_tensor(wa, "cpu")))
    assert t_gf.MXU_MIN_WORDS == r_gf.MXU_MIN_WORDS


def _candidates(seed, n=9, c=24, id_range=12):
    """Rows with duplicate ids (each duplicate carrying its id's sim, as
    real candidate lists do), PAD lanes, equal sims, one all-PAD row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, id_range, size=(n, c)).astype(np.int32)
    per_id = np.round(rng.random((n, id_range + 1)) * 4) / 4  # many ties
    sims = np.take_along_axis(per_id, ids + 1, axis=1).astype(np.float32)
    sims[ids == PAD_ID] = NEG_INF
    ids[-1] = PAD_ID
    sims[-1] = NEG_INF
    return ids, sims


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_mask(seed):
    ids, _ = _candidates(seed)
    _eq(r_topk.dedup_mask(jnp.asarray(ids)),
        t_topk.dedup_mask(torch.from_numpy(ids)))


@pytest.mark.parametrize("dedup_ids", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_select_topk(seed, dedup_ids):
    ids, sims = _candidates(seed)
    for k in (1, 5, 24):
        r_s, r_i = r_topk.select_topk(jnp.asarray(sims), jnp.asarray(ids), k,
                                      dedup_ids=dedup_ids)
        t_s, t_i = t_topk.select_topk(torch.from_numpy(sims),
                                      torch.from_numpy(ids), k,
                                      dedup_ids=dedup_ids)
        _eq(r_s, t_s)
        _eq(r_i, t_i)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_merge_topk(seed):
    ids, sims = _candidates(seed)
    self_ids = np.arange(ids.shape[0], dtype=np.int32)
    for k, with_self in ((4, False), (10, True), (30, True)):
        args_r = (jnp.asarray(ids), jnp.asarray(sims), k,
                  jnp.asarray(self_ids) if with_self else None)
        args_t = (torch.from_numpy(ids), torch.from_numpy(sims), k,
                  torch.from_numpy(self_ids) if with_self else None)
        r_i, r_s = r_topk.merge_topk(*args_r)
        t_i, t_s = t_topk.merge_topk(*args_t)
        _eq(r_i, t_i)
        _eq(r_s, t_s)


def test_merge_topk_equals_select_topk_dedup():
    """The two selection forms the port relies on agree: the plain paths'
    sort-based merge_topk and the kernels' rounds of select_topk."""
    ids, sims = _candidates(8, n=16, c=40)
    t_i, t_s = t_topk.merge_topk(torch.from_numpy(ids),
                                 torch.from_numpy(sims), 12)
    s_s, s_i = t_topk.select_topk(torch.from_numpy(sims),
                                  torch.from_numpy(ids), 12, dedup_ids=True)
    s_i = torch.where(s_s == NEG_INF, PAD_ID, s_i)
    _eq(t_i.numpy(), s_i)
    _eq(t_s.numpy(), s_s)


def test_tie_order_matches_lax_top_k():
    x = np.array([[1, 3, 3, 2, 3, 3, .5, 3]], dtype=np.float32)
    vals, pos = t_topk.topk_desc(torch.from_numpy(x), 3)
    assert pos.tolist() == [[1, 2, 4]]
    assert vals.tolist() == [[3.0, 3.0, 3.0]]
    ids = np.arange(8, dtype=np.int32)[None]
    t_i, _ = t_topk.merge_topk(torch.from_numpy(ids), torch.from_numpy(x), 3)
    r_i, _ = r_topk.merge_topk(jnp.asarray(ids), jnp.asarray(x), 3)
    assert t_i.tolist() == [[1, 2, 4]]
    _eq(r_i, t_i)


def test_knn_recall_and_reverse_neighbors():
    rng = np.random.default_rng(9)
    approx = rng.integers(-1, 50, size=(40, 10)).astype(np.int32)
    exact = rng.integers(-1, 50, size=(40, 10)).astype(np.int32)
    exact[3] = PAD_ID
    assert r_knn_recall(approx, exact) == t_knn_recall(approx, exact)
    ids = rng.integers(-1, 60, size=(60, 8)).astype(np.int32)
    _eq(r_reverse(ids, 5), t_reverse(ids, 5))
