"""The port's index mutations and journals held bitwise against the JAX
reference on the CPU: the same primitive sequence — ``append_user``,
``remove_user``, ``swap_profile``, ``relink_user``, ``touch_row``,
``refresh_cohort`` — applied to the port's ``KNNIndex`` and the
reference's, loaded from one artifact, leaves equal row arrays, cluster
tables, free lists and versions; ``rows_changed_since``,
``tombstones_since`` and ``members_added_since`` agree at every version,
past compactions and past a dropped journal base; and a mutated index
saved by either package loads in the other with its journals and serves
the same answers. Every comparison is exact (``np.array_equal`` / ``==``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro_torch.core.params import C2Params  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine  # noqa: E402
from repro_torch.query.index import KNNIndex, build_index  # noqa: E402
from repro_torch.query.router import fingerprint_profiles, profiles_to_csr  # noqa: E402
from repro_torch.query.search import exact_knn  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402

ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids", "tombstone",
        "last_touch")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users, k = 8) built by the port and saved."""
    ix = build_index(make_dataset("synth", scale=0.05, seed=5),
                     C2Params(k=8, b=64, t=4, max_cluster=32), device="cpu")
    path = tmp_path_factory.mktemp("ix") / "small.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(qds.n_users)]


def _sketch(ix, profile):
    items, offsets = profiles_to_csr([profile])
    gf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
    return gf.words[0], int(gf.card[0]), items


def _neighbours(ix, words, card, k):
    """Exact top-k live neighbours (the port's plain brute force)."""
    ids, sims = exact_knn(ix.words, ix.card, words[None], np.array([card]),
                          k, tomb=ix.tombstone, device="cpu")
    return ids[0], sims[0]


def _mutate(ixs, profiles, n_insert=70):
    """Apply one primitive sequence to every index of ``ixs`` (neighbour
    lists computed once, on the first); returns the versions seen."""
    first = ixs[0]
    versions = [first.version]
    cohort = []

    def apply(fn, *args):
        for ix in ixs:
            getattr(ix, fn)(*args)
        versions.append(first.version)

    def insert(p):
        words, card, items = _sketch(first, p)
        ids, sims = _neighbours(first, words, card, first.k)
        us = [ix.append_user(words, card, ids, sims) for ix in ixs]
        assert len(set(us)) == 1
        cohort.append((us[0], items))
        for ix in ixs:
            ix.add_cluster_member(us[0] % ix.n_clusters, us[0])
        versions.append(first.version)
        return us[0]

    for m in range(n_insert // 2):
        insert(profiles[m])
    for u in (3, 17, 4, 150, 200, 9):
        apply("remove_user", u)
    reused = [insert(profiles[40 + m]) for m in range(4)]
    assert reused == [3, 4, 9, 17]  # free rows, lowest id first
    for u, p in ((5, 60), (33, 61), (201, 62)):
        words, card, _ = _sketch(first, profiles[p])
        apply("swap_profile", u, words, card)
        ids, sims = _neighbours(first, words, card, first.k + 1)
        apply("relink_user", u, ids, sims)
    for u, clock in ((5, 7), (33, 9), (3, 11)):
        apply("touch_row", u, clock)
    for m in range(n_insert - n_insert // 2):
        insert(profiles[80 + m])
    uids = np.array([u for u, _ in cohort], np.int32)
    items, offsets = profiles_to_csr([p for _, p in cohort])
    apply("refresh_cohort", items, offsets, uids)
    apply("remove_user", first.n - 2)
    return versions


def _assert_same_index(a, b, same_history=True):
    """Equal rows, tables, free lists and versions; and, for two indexes
    that took the same mutations (not a saved copy: a load allocates n
    rows), equal capacity."""
    for name in ROWS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.n, a.n_live, a.version, a.n_clusters) == \
        (b.n, b.n_live, b.version, b.n_clusters)
    assert not same_history or a.capacity == b.capacity
    assert sorted(a._free_rows) == sorted(b._free_rows)
    assert np.array_equal(a.cluster_sizes(), b.cluster_sizes())
    for ci in range(a.n_clusters):
        assert np.array_equal(a.cluster_users(ci), b.cluster_users(ci))
    for name in ("cluster_paths", "cluster_config", "hash_seeds"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_primitives_match_reference(artifact, profiles):
    port, ref = KNNIndex.load(artifact), RIndex.load(artifact)
    n0, c0 = port.n, port.n_clusters
    _mutate([port, ref], profiles)
    _assert_same_index(port, ref)
    # 74 inserts, six of them into freed rows (150 and 200 freed too);
    # the last removal's row stays dead.
    dead = port.n - 2
    assert port.n == n0 + 74 - 6 and port.n_live == port.n - 1
    assert port.tombstone[dead] and not port.tombstone[[150, 200]].any()
    assert (port.graph_ids[dead] == PAD_ID).all() and port.card[dead] == 0
    assert not (port.graph_ids[port.alive_ids()] == dead).any()
    assert port.n_clusters >= c0 and port.members_added_since(0)
    with pytest.raises(ValueError):
        port.remove_user(dead)
    with pytest.raises(IndexError):
        port.touch_row(port.n, 1)


def test_capacity_doubles_and_free_rows_recycle(artifact, profiles):
    ix = KNNIndex.load(artifact)
    assert ix.capacity == ix.n == 200
    words, card, _ = _sketch(ix, profiles[0])
    ids, sims = _neighbours(ix, words, card, ix.k)
    assert ix.append_user(words, card, ids, sims) == 200
    assert ix.capacity == 400 and ix.graph_ids.shape == (201, ix.k)
    ix.remove_user(7)
    ix.remove_user(2)
    assert ix.append_user(words, card, ids, sims) == 2
    assert ix.append_user(words, card, ids, sims) == 7
    assert ix.append_user(words, card, ids, sims) == 201
    assert not ix.tombstone.any() and ix.n == 202


@pytest.mark.parametrize("merge_max", [4096, 6])
def test_journals_match_reference_at_every_version(artifact, profiles,
                                                   merge_max):
    """Small caps force compactions of all three journals; at
    ``merge_max`` 6 the merged entries overflow and the bases advance, so
    old readers get None (resync) from both packages alike."""
    port, ref = KNNIndex.load(artifact), RIndex.load(artifact)
    for ix in (port, ref):
        ix._ROW_LOG_CAP, ix._TOMB_LOG_CAP = 8, 4
        ix._MEMBER_LOG_CAP, ix._LOG_MERGE_MAX = 16, merge_max
    versions = _mutate([port, ref], profiles, n_insert=24)
    assert len(port._row_log) <= 8 and len(port._tomb_log) <= 4
    _assert_same_index(port, ref)
    nones = 0
    for v in range(versions[0] - 2, versions[-1] + 2):
        for fn in ("rows_changed_since", "tombstones_since",
                   "members_added_since"):
            got, want = getattr(port, fn)(v), getattr(ref, fn)(v)
            assert got == want, (fn, v)
            nones += got is None
    if merge_max == 6:
        assert nones > 0 and port._row_log_base > versions[0]
    else:
        assert port.rows_changed_since(versions[0]) is not None
    for key, arr in port._journal_arrays().items():
        assert np.array_equal(arr, ref._journal_arrays()[key]), key


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mutated_artifact_crosses_packages(artifact, profiles, tmp_path,
                                           writer):
    """A mutated index saved by one package loads in the other with its
    journals (equal ``jrn_*`` arrays and journal answers), and both
    packages' engines serve it the same ids and sims."""
    port, ref = KNNIndex.load(artifact), RIndex.load(artifact)
    versions = _mutate([port, ref], profiles, n_insert=20)
    path = tmp_path / "mutated.npz"
    (port if writer == "port" else ref).save(path)
    a, b = KNNIndex.load(path), RIndex.load(path)
    _assert_same_index(a, b)
    _assert_same_index(a, port, same_history=False)
    for key, arr in a._journal_arrays().items():
        assert np.array_equal(arr, b._journal_arrays()[key]), key
    for v in versions[::5]:
        assert a.rows_changed_since(v) == port.rows_changed_since(v)
        assert a.tombstones_since(v) == b.tombstones_since(v)
        assert a.members_added_since(v) == b.members_added_since(v)
    queries = profiles[150:166]
    ids, sims = QueryEngine(a, QueryConfig(k=8, beam=12, hops=2),
                            device="cpu").query_batch(queries)
    r_ids, r_sims = RQueryEngine(b, RQueryConfig(k=8, beam=12,
                                                 hops=2)).query_batch(queries)
    assert np.array_equal(ids, np.asarray(r_ids))
    assert np.array_equal(sims, np.asarray(r_sims))
    assert not a.tombstone[ids[ids != PAD_ID]].any()
