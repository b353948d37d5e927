"""The port's shard re-balance and tiered residency held bitwise against
the JAX reference.

* ``measured_imbalance`` and ``merge_audit`` after inserts, with and
  without tiered residency: the audit stats (``merge_coverage``) of the
  reference's ``merge_subgraph_rows`` over delta-synced shard tables,
  whose merged rows are the index's.
  Then ``adopt_plan``: the swapped tables, ``g2l``, ``cap``,
  ``generation`` and the old → new beam map (evicted rows to PAD) of the
  reference, and tables equal to a fresh ``ShardedDescent`` on the new
  plan.
* The engine's ``Rebalancer``: cadence and threshold counts, stats and
  served results of the reference under inserts; swaps forced between
  the ticks of a continuous serve with slots in flight (on a fixed
  index, results equal to the serve without swaps); a cache-on serve
  across swaps, flushed at each.
* Tiered residency: ``plan_shards`` / ``extend_plan`` and the delta sync
  under ``resident_configs``, with served results of the reference.
* ``knn_serve --rebalance-every --rebalance-threshold --resident-configs``
  against the reference CLI.

The stated tolerance is exact equality of ids, sims and tables.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.launch import knn_serve as r_knn_serve  # noqa: E402
from repro.query import rebalance as r_rebalance  # noqa: E402
from repro.query import sharded as r_sharded  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query import rebalance, sharded  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402

K, BEAM, HOPS = 8, 12, 3
TABLES = ("l_graph", "l_rev", "l_words", "l_card", "l2g", "l_tomb")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users), built by the reference and loaded by both
    packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.05, seed=5),
                       RC2Params(k=8, b=64, t=4, max_cluster=32))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(24)]


@pytest.fixture(scope="module")
def inserts():
    ids = make_dataset("synth", scale=0.05, seed=9)
    return [ids.profile(u) for u in range(40)]


def _engines(artifact, **kw):
    """(port engine, reference engine) over one artifact, same config."""
    kw = dict(k=K, beam=BEAM, hops=HOPS, refresh_every=8, **kw)
    return (QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                        device="cpu"),
            RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw)))


def _insert(engines, profiles):
    for p in profiles:
        for eng in engines:
            eng.insert(p)


def _serve(engines, profiles, on_tick=None):
    for eng, req in zip(engines, (QueryRequest, RQueryRequest)):
        for rid, p in enumerate(profiles):
            eng.submit(req(rid=rid, profile=p))
        eng.run(on_tick=on_tick)


def _done(engine):
    return [(r.rid, r.ids, r.sims) for r in engine.done]


def _assert_done(a, b):
    assert [x[0] for x in a] == [x[0] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[1], y[1], err_msg=str(x[0]))
        np.testing.assert_array_equal(x[2], y[2], err_msg=str(x[0]))


def _assert_tables(sd, r_sd):
    assert (sd.cap, sd.version, sd.generation) == (r_sd.cap, r_sd.version,
                                                   r_sd.generation)
    np.testing.assert_array_equal(sd._g2l, r_sd._g2l)
    for a, b, name in zip(sd._dev, r_sd._dev, TABLES):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.view(np.int32) if name == "l_words" else b,
            err_msg=name)
    for a, b in zip(sd.plan.residents, r_sd.plan.residents):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sd.plan.owner, r_sd.plan.owner)


def _assert_fresh(sd):
    """The tables equal a fresh ShardedDescent on the same plan."""
    fresh = sharded.ShardedDescent(sd.index, sd.n_shards, plan=sd.plan,
                                   device="cpu")
    np.testing.assert_array_equal(fresh._g2l, sd._g2l)
    for a, b, name in zip(fresh._dev, sd._dev, TABLES):
        assert torch.equal(a, b), name


def _mutated(artifact, profiles, inserts, shards, **kw):
    """Engines whose frozen base plan was extended by 12 inserts (a cohort
    refresh included), synced."""
    port, ref = _engines(artifact, shards=shards, **kw)
    port.query_batch(profiles[:4])  # freeze the base plan
    ref.query_batch(profiles[:4])
    _insert((port, ref), inserts[:12])
    return port, ref


# -- the pieces -------------------------------------------------------------


@pytest.mark.parametrize("resident_configs", [0, 2])
def test_imbalance_and_merge_match_reference(artifact, profiles, inserts,
                                             resident_configs):
    """After 12 inserts (a cohort refresh among them): the measured
    imbalance and the merge audit's stats of the reference; the audit
    counts the lanes whose endpoints share no shard (some under full
    residency here, many more under tiered residency). The reference's
    merged rows are the index's, so the port's swap, which rebuilds from
    the index, gives the reference's tables."""
    port, ref = _mutated(artifact, profiles, inserts, 3,
                         resident_configs=resident_configs)
    sd, r_sd = port.sharded_state(), ref.sharded_state()
    got = rebalance.measured_imbalance(port.index, sd.plan)
    assert got == r_rebalance.measured_imbalance(ref.index, r_sd.plan)
    assert got != sd.plan.imbalance  # the delta path leaves it stale
    stats = rebalance.merge_audit(sd)
    r_src, r_stats = r_rebalance.merge_subgraph_rows(r_sd)
    assert stats == r_stats
    assert stats["lanes_patched"] > 0 and 0 < stats["merge_coverage"] < 1
    # The reference's audited merge is the index's rows.
    for name in ("graph_ids", "rev_ids", "words", "card", "tombstone"):
        np.testing.assert_array_equal(getattr(r_src, name),
                                      getattr(port.index, name)[:port.index.n],
                                      err_msg=name)

    # The swap to a fresh partition: the port's rebuilt from the index,
    # the reference's from its merge.
    sd.take_beam_remap()
    r_sd.take_beam_remap()
    old_l2g = sd._dev[4].numpy().copy()
    sd.adopt_plan(sharded.plan_shards(port.index, 3,
                                      resident_configs=resident_configs))
    r_sd.adopt_plan(r_sharded.plan_shards(ref.index, 3,
                                          resident_configs=resident_configs),
                    src=r_src)
    _assert_tables(sd, r_sd)
    _assert_fresh(sd)
    assert sd.generation == 1
    mp, r_mp = sd.take_beam_remap(), r_sd.take_beam_remap()
    np.testing.assert_array_equal(mp, r_mp)
    assert mp.shape == old_l2g.shape
    # Rows evicted from a shard map to PAD there; kept rows to their new
    # local id.
    evicted = kept = 0
    for s in range(3):
        for lid, g in enumerate(old_l2g[s]):
            if g == PAD_ID:
                assert mp[s, lid] == PAD_ID
            elif sd._g2l[s, g] == PAD_ID:
                assert mp[s, lid] == PAD_ID
                evicted += 1
            else:
                assert sd._dev[4][s, mp[s, lid]] == g
                kept += 1
    assert evicted > 0 and kept > 0
    assert sd.take_beam_remap() is None


# -- the engine's Rebalancer ------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["wave", "continuous"])
def test_rebalancer_matches_reference(artifact, profiles, inserts,
                                      continuous):
    """Inserts between the steps of a 2-shard serve with a check every
    step: the same checks, swaps, imbalance and merge stats as the
    reference, the same results, tables equal to a fresh state after the
    swaps; a threshold out of reach measures and never swaps."""
    kw = dict(shards=2, continuous=continuous, slots=6, max_wave=6,
              rebalance_every=1, rebalance_threshold=1.0)
    port, ref = _engines(artifact, **kw)
    _serve((port, ref), profiles[:6])

    def arrivals(eng, tick):
        if tick < 6:
            eng.insert(inserts[tick])
    for eng, req in ((port, QueryRequest), (ref, RQueryRequest)):
        for rid, p in enumerate(profiles):
            eng.submit(req(rid=100 + rid, profile=p))
        if continuous:
            eng.run(on_tick=arrivals)
        else:
            for tick in range(4):  # waves take no on_tick: insert between
                arrivals(eng, tick)
                eng.step()
            eng.run()
    _assert_done(_done(port), _done(ref))
    stats = port.rebalance.stats()
    r_stats = ref.rebalance.stats()
    assert stats == r_stats
    assert stats["swaps"] > 0
    _assert_tables(port.sharded_state(), ref.sharded_state())
    _assert_fresh(port.sharded_state())

    high, _ = _engines(artifact, shards=2, max_wave=2, rebalance_every=2,
                       rebalance_threshold=10.0)
    for rid, p in enumerate(profiles[:8]):
        high.submit(QueryRequest(rid=rid, profile=p))
    stats = high.run()["rebalance"]
    assert stats["checks"] == 2 and stats["swaps"] == 0
    assert high.sharded_state().generation == 0
    with pytest.raises(ValueError, match="rebalance"):
        _engines(artifact, rebalance_every=4)


@pytest.mark.parametrize("mutated", [False, True], ids=["fixed", "mutated"])
def test_mid_flight_swaps_match_reference(artifact, profiles, inserts,
                                          mutated):
    """Swaps forced between the ticks of a 3-shard continuous serve (the
    DMA hop in the port), slots in flight: results equal the reference's;
    on a fixed index a swap re-derives the same partition, so they equal
    the serve without swaps; after inserts the swaps move rows between
    shards mid-flight (evicted beam lanes masked)."""
    kw = dict(shards=3, continuous=True, slots=6)
    port, ref = _engines(artifact, **kw)
    port = QueryEngine(KNNIndex.load(artifact), QueryConfig(
        k=K, beam=BEAM, hops=HOPS, refresh_every=8, kernel=True, dma=True,
        **kw), device="cpu")
    plain, _ = _engines(artifact, **kw)
    for eng in (port, ref, plain):
        eng.query_batch(profiles[:4])
    if mutated:
        _insert((port, ref, plain), inserts[:12])

    def swap(eng, tick):
        if tick in (1, 2, 4):
            eng.rebalance.swap()
    _serve((port, ref), profiles, on_tick=swap)
    _assert_done(_done(port), _done(ref))
    assert port.sharded_state().generation == 3
    _assert_tables(port.sharded_state(), ref.sharded_state())
    for rid, p in enumerate(profiles):
        plain.submit(QueryRequest(rid=rid, profile=p))
    plain.run()
    if mutated:
        assert any(not np.array_equal(a[1], b[1])
                   for a, b in zip(_done(port), _done(plain)))
    else:
        _assert_done(_done(port), _done(plain))


def test_cache_across_swaps_matches_reference(artifact, profiles, inserts):
    """A cache-on 2-shard serve across swaps: each swap flushes (a swap
    is invisible to the journals), no pre-swap entry is served after it,
    and results, hits and flushes equal the reference's."""
    port, ref = _engines(artifact, shards=2, continuous=True, slots=6,
                         cache=64)
    _insert((port, ref), inserts[:12])
    for round_ in range(3):
        _serve((port, ref), profiles[:12])
        _serve((port, ref), profiles[:12])  # hits, within one generation
        for eng in (port, ref):
            eng.rebalance.swap()
    _serve((port, ref), profiles[:12])
    _assert_done(_done(port), _done(ref))
    stats, r_stats = port.plan.cache.stats(), ref.plan.cache.stats()
    assert stats == r_stats
    assert stats["flushes"] >= 3 and stats["hits"] > 0


# -- tiered residency -------------------------------------------------------


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["wave", "continuous"])
def test_tiered_residency_matches_reference(artifact, profiles, inserts,
                                            continuous):
    """resident_configs=2 of t=4: fewer resident rows than full
    residency, the reference's plan, tables and served results, through
    the delta sync of 12 inserts (the tables then equal an extend_plan
    rematerialisation)."""
    kw = dict(shards=2, continuous=continuous, slots=6, max_wave=8,
              resident_configs=2)
    port, ref = _mutated(artifact, profiles, inserts, **kw)
    sd, r_sd = port.sharded_state(), ref.sharded_state()
    assert sd.plan.resident_configs == 2
    full = sharded.plan_shards(port.index, 2)
    assert sum(len(r) for r in sd.plan.residents) < \
        sum(len(r) for r in full.residents)
    _assert_tables(sd, r_sd)
    fresh = sharded.ShardedDescent(
        port.index, 2, plan=sharded.extend_plan(sd.base_plan, port.index),
        device="cpu")
    np.testing.assert_array_equal(fresh._g2l, sd._g2l)
    for a, b in zip(fresh._dev, sd._dev):
        assert torch.equal(a, b)
    _serve((port, ref), profiles)
    _assert_done(_done(port), _done(ref))
    assert port.recall_vs_brute_force() == ref.recall_vs_brute_force()


# -- the CLI ----------------------------------------------------------------


def test_knn_serve_rebalance_resident_configs_matches_reference(
        artifact, capsys, monkeypatch):
    """``--shards 2 --insert 20 --rebalance-every 1 --rebalance-threshold
    0.5 --resident-configs 2`` through both CLIs (a threshold below 1
    swaps at every check): the sharded line's numbers, recall, counters,
    the Rebalancer's stats and the served ids and sims rid by rid."""
    flags = ["--index", str(artifact), "--dataset", "synth", "--scale",
             "0.05", "--queries", "24", "--k", "8", "--beam", "12",
             "--shards", "2", "--insert", "20", "--rebalance-every", "1",
             "--rebalance-threshold", "0.5", "--resident-configs", "2",
             "--max-wave", "6"]
    captured = []

    class Capture(RQueryEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(r_knn_serve, "QueryEngine", Capture)
    r_stats, r_recall = r_knn_serve.main(flags)
    r_out = capsys.readouterr().out
    stats, recall, engine = knn_serve.main(flags + ["--kernel", "--device",
                                                    "cpu"])
    out = capsys.readouterr().out

    def numbers(text):
        line = [x for x in text.splitlines() if "[serve] sharded:" in x]
        assert len(line) == 1
        return line[0].split("imbalance")[0] + line[0].split(
            "imbalance")[1][:6]

    assert numbers(out) == numbers(r_out) and "configs 2/4" in out
    assert recall == r_recall
    for key in ("requests", "waves", "inserted", "refreshes", "shards"):
        assert stats[key] == r_stats[key], key
    r_reb = r_stats["rebalance"]
    assert stats["rebalance"] == r_reb and r_reb["swaps"] > 0
    assert f"[serve] rebalance: {stats['rebalance']}" in out
    ref = captured[0]
    _assert_done(sorted(_done(engine), key=lambda x: x[0]),
                 sorted(_done(ref), key=lambda x: x[0]))
