"""The port's result cache held bitwise against the JAX reference.

* ``ResultCache`` units, the port's and the reference's side by side over
  one artifact: exact keys, copies on ``get``, LRU eviction, the
  wholesale flush on a real mutation, the kept cache on a no-op version
  bump, the tombstone drop, the refusal of results that straddled a
  mutation, and ``stats``.
* Repeated queries in waves and through continuous slots under every
  scorer: hits served bitwise what a descent gives (cache-off by rid) and
  in the reference's cache-on completion order.
* Mutation interleavings with the cache on (hypothesis, derandomized,
  plus the reference battery's own falsifying example): the port's
  cache-on engine equals the REFERENCE's cache-on engine in completion
  order, equals the port's cache-off engine by rid, and counts the same
  hits, misses and flushes.

The reference's own cache battery
(``test_cache_properties.py::test_cache_is_results_invisible_under_any_interleaving``)
compares its cache-on engine with its cache-off engine in completion
order; a continuous hit completes at admission, before the slots of its
tick, so that order differs while every rid's result agrees. The port is
held to the reference's cache-on order, and to cache-off by rid. The
stated tolerance is exact equality everywhere.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.query.cache import ResultCache as RResultCache  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.query.router import fingerprint_profiles as r_fp  # noqa: E402
from repro.query.router import profiles_to_csr as r_csr  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.query.cache import ResultCache  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.query.router import fingerprint_profiles, profiles_to_csr  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402

SCORERS = {"jnp": {}, "pallas": {"kernel": True},
           "pallas_dma": {"kernel": True, "dma": True}}
OPS = ("insert", "remove", "update", "hot_query", "cold_query", "serve")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users) at the reference cache battery's
    parameters, built by the reference and loaded by both packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.05, seed=5),
                       RC2Params(k=8, b=64, t=4, max_cluster=32))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(24)]


def _fingerprints(index, fp, csr, profiles):
    items, offsets = csr(profiles)
    g = fp(items, offsets, index.n_bits, index.fp_seed)
    return np.asarray(g.words), np.asarray(g.card)


def _caches(artifact, profiles, capacity):
    """(port cache, reference cache, their indexes, fingerprints)."""
    ix, r_ix = KNNIndex.load(artifact), RIndex.load(artifact)
    words, card = _fingerprints(ix, fingerprint_profiles, profiles_to_csr,
                                profiles)
    r_words, r_card = _fingerprints(r_ix, r_fp, r_csr, profiles)
    np.testing.assert_array_equal(words, r_words)
    return (ResultCache(ix, capacity), RResultCache(r_ix, capacity), ix,
            r_ix, words, card)


def _fill(caches, words, card, rows):
    """Put the same fake result under each row's key in both caches."""
    for c in caches:
        for i in rows:
            ids = np.arange(i, i + 4, dtype=np.int32)
            c.put(c.key(words[i], card[i], 4, 3), ids,
                  np.linspace(1, 0, 4, dtype=np.float32))


# -- ResultCache units ------------------------------------------------------


def test_key_is_exact_fingerprint_plus_knobs(artifact, profiles):
    cache, r_cache, _, _, words, card = _caches(artifact, profiles, 4)
    key = cache.key(words[0], card[0], 8, 3)
    assert key == r_cache.key(words[0], card[0], 8, 3)
    assert key != cache.key(words[0], card[0], 8, 2)
    assert key != cache.key(words[0], card[0], 10, 3)
    assert key != cache.key(words[1], card[1], 8, 3)
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(KNNIndex.load(artifact), 0)


def test_get_copies_lru_and_stats(artifact, profiles):
    cache, r_cache, *_, words, card = _caches(artifact, profiles, 3)
    _fill((cache, r_cache), words, card, range(3))
    for c in (cache, r_cache):
        hit = c.get(c.key(words[0], card[0], 4, 3))  # 0 is now most recent
        hit[0][:] = PAD_ID                            # a copy, not the entry
        assert c.get(c.key(words[0], card[0], 4, 3))[0][0] == 0
    _fill((cache, r_cache), words, card, [3])  # evicts 1, the oldest
    for c in (cache, r_cache):
        assert c.get(c.key(words[1], card[1], 4, 3)) is None
        assert c.get(c.key(words[2], card[2], 4, 3)) is not None
    assert cache.stats() == r_cache.stats()
    assert cache.stats()["hits"] == 3 and cache.stats()["misses"] == 1


def test_flush_noop_bump_tombstone_and_straddle(artifact, profiles):
    cache, r_cache, ix, r_ix, words, card = _caches(artifact, profiles, 8)
    _fill((cache, r_cache), words, card, range(4))
    # A no-op version bump keeps the entries.
    for index in (ix, r_ix):
        index.version += 1
    cache.sync()
    r_cache.sync()
    assert len(cache) == len(r_cache) == 4 and cache.flushes == 0
    # A tombstoned id is dropped at get, never served (counted).
    for index in (ix, r_ix):
        index.tombstone[1] = True
    for c in (cache, r_cache):
        assert c.get(c.key(words[1], card[1], 4, 3)) is None
        assert c.get(c.key(words[0], card[0], 4, 3)) is None  # names id 1
        assert c.get(c.key(words[3], card[3], 4, 3)) is not None
    for index in (ix, r_ix):
        index.tombstone[1] = False
    assert cache.stats() == r_cache.stats()
    assert cache.stats()["stale_drops"] == 2
    # A real mutation flushes wholesale; a result computed before it and
    # put after it is refused until the cache syncs.
    for index in (ix, r_ix):
        index.remove_user(7)
    _fill((cache, r_cache), words, card, [5])
    assert len(cache) == len(r_cache) == 2
    cache.sync()
    r_cache.sync()
    assert len(cache) == len(r_cache) == 0
    assert cache.flushes == r_cache.flushes == 1
    _fill((cache, r_cache), words, card, [5])
    assert len(cache) == len(r_cache) == 1
    cache.invalidate()
    r_cache.invalidate()
    assert cache.stats() == r_cache.stats()
    assert cache.stats()["flushes"] == 2 and len(cache) == 0


# -- serving with the cache -------------------------------------------------


def _engines(artifact, cache, continuous, kw=None):
    cfg = dict(k=8, beam=12, hops=2, slots=8, continuous=continuous,
               refresh_every=10**9)
    port = QueryEngine(KNNIndex.load(artifact),
                       QueryConfig(**cfg, cache=cache, **(kw or {})),
                       device="cpu")
    ref = RQueryEngine(RIndex.load(artifact), RQueryConfig(**cfg,
                                                           cache=cache))
    return port, ref


def _done(engine):
    return [(r.rid, r.status, r.ids, r.sims) for r in engine.done]


def _assert_order_equal(a, b):
    assert [x[:2] for x in a] == [x[:2] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[2], y[2])
        np.testing.assert_array_equal(x[3], y[3])


def _assert_rid_equal(a, b):
    by = {x[0]: x for x in b}
    assert sorted(by) == sorted(x[0] for x in a)
    for x in a:
        np.testing.assert_array_equal(x[2], by[x[0]][2])
        np.testing.assert_array_equal(x[3], by[x[0]][3])


@pytest.mark.parametrize("continuous", [False, True], ids=["wave",
                                                           "continuous"])
@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_repeat_queries_hit_and_stay_bitwise(artifact, profiles, continuous,
                                             scorer):
    """16 profiles, then the first 8 again: the repeats are hits, served
    bitwise the cache-off results, in the reference's completion order."""
    runs = {}
    for name, cache in (("on", 64), ("off", 0)):
        port, ref = _engines(artifact, cache, continuous, SCORERS[scorer])
        for eng, req in ((port, QueryRequest), (ref, RQueryRequest)):
            for lo, hi in ((0, 16), (16, 24)):  # a wave looks up first
                for rid in range(lo, hi):
                    eng.submit(req(rid=rid, profile=profiles[rid % 16]))
                eng.run()
        runs[name] = (port, ref)
    port, ref = runs["on"]
    _assert_order_equal(_done(port), _done(ref))
    _assert_rid_equal(_done(port), _done(runs["off"][0]))
    assert port.plan.cache.stats() == ref.plan.cache.stats()
    assert port.plan.cache.hits == 8
    assert port.plan.descent_stats["hop_queries"] < \
        runs["off"][0].plan.descent_stats["hop_queries"]


def _drive(engine, request_cls, ops, profiles, seed):
    """The reference battery's op loop (test_cache_properties._drive),
    over either package: targets from a seeded rng over the engine's own
    live set; hot_query repeats 4 profiles, cold_query rotates."""
    rng = np.random.default_rng(seed)
    n_ins = n_cold = 0
    waves = []
    for op in ops:
        ix = engine.index
        if op == "insert":
            engine.insert(profiles[8 + (n_ins % 16)])
            n_ins += 1
        elif op == "remove":
            alive = ix.alive_ids()
            if len(alive) > ix.k + 2:
                engine.remove_user(int(rng.choice(alive)))
        elif op == "update":
            alive = ix.alive_ids()
            engine.update_user(int(rng.choice(alive)),
                               profiles[int(rng.integers(0, 8))])
        elif op == "hot_query":
            waves.append(engine.query_batch(profiles[:4]))
        elif op == "cold_query":
            lo = 4 + (n_cold % 4) * 4
            waves.append(engine.query_batch(profiles[lo:lo + 4]))
            n_cold += 1
        else:  # serve the hot set through the scheduler loop
            for i in range(3):
                engine.submit(request_cls(
                    rid=i, profile=np.asarray(profiles[i], np.int32)))
            engine.run()
    waves.append(engine.query_batch(profiles[:4]))  # final probe
    return waves


def _check_interleaving(artifact, profiles, ops, continuous, capacity,
                        seed):
    engines = {}
    for name, cache in (("on", capacity), ("off", 0)):
        port, ref = _engines(artifact, cache, continuous)
        engines[name] = port
        if name == "on":
            engines["ref"] = ref
    for eng in engines.values():
        eng.query_batch(profiles[:4])  # the battery's pre-fill
    waves = {name: _drive(eng, RQueryRequest if name == "ref"
                          else QueryRequest, ops, profiles, seed)
             for name, eng in engines.items()}
    for name in ("off", "ref"):
        assert len(waves["on"]) == len(waves[name])
        for (ids, sims), (r_ids, r_sims) in zip(waves["on"], waves[name]):
            np.testing.assert_array_equal(ids, r_ids)
            np.testing.assert_array_equal(sims, r_sims)
    on, off, ref = (_done(engines[n]) for n in ("on", "off", "ref"))
    _assert_order_equal(on, ref)
    # Requests carry repeated rids here: compare by (rid, occurrence).
    seq = [(x[0], [y[0] for y in on[:i]].count(x[0])) + x[2:]
           for i, x in enumerate(on)]
    seq_off = [(x[0], [y[0] for y in off[:i]].count(x[0])) + x[2:]
               for i, x in enumerate(off)]
    by_off = {x[:2]: x for x in seq_off}
    assert sorted(by_off) == sorted(x[:2] for x in seq)
    for x in seq:
        np.testing.assert_array_equal(x[2], by_off[x[:2]][2])
        np.testing.assert_array_equal(x[3], by_off[x[:2]][3])
    stats, r_stats = (engines[n].plan.cache.stats() for n in ("on", "ref"))
    for key in ("hits", "misses", "flushes", "entries"):
        assert stats[key] == r_stats[key], key
    tomb = engines["on"].index.tombstone
    assert not any(tomb[x[2][x[2] != PAD_ID]].any() for x in on)
    assert engines["on"].index.version == engines["ref"].index.version
    np.testing.assert_array_equal(engines["on"].index.graph_ids,
                                  engines["ref"].index.graph_ids)
    return stats["hits"]


def test_reference_battery_falsifying_example(artifact, profiles):
    """The example that fails the reference's own battery: a capacity-2
    cache keeps hot profiles 2 and 3 from the pre-fill, so rid 2 is a hit
    that completes at admission, before rids 0 and 1. The port completes
    in the reference's cache-on order and serves every rid the cache-off
    result."""
    hits = _check_interleaving(artifact, profiles, ["serve"], True, 2, 0)
    assert hits > 0


def test_cache_matches_reference_under_interleavings(artifact, profiles):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    seen = {"hits": 0}

    @settings(max_examples=5, deadline=None, database=None,
              derandomize=True)
    @given(ops=st.lists(st.sampled_from(OPS), min_size=3, max_size=7),
           continuous=st.booleans(), capacity=st.sampled_from([2, 64]),
           seed=st.integers(0, 2**31 - 1))
    def battery(ops, continuous, capacity, seed):
        seen["hits"] += _check_interleaving(artifact, profiles, ops,
                                            continuous, capacity, seed)

    battery()
    assert seen["hits"] > 0
