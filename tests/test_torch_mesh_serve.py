"""The port's per-device shard layout (``ShardedDescent(devices=[...])``,
one device per shard) held bitwise against the JAX reference's sharded
serving and against the port's own stacked layout.

The reference runs its single-device vmap path (``use_mesh=False``: its
mesh path gives the same numbers); the port's shards each sit on an entry
of ``["cpu"] * S``, each hop one call per shard, merged on the first
device. At 2-4 shards: waves under every scorer, continuous slots with
per-request hop budgets tick by tick, an insert burst across a cohort
refresh (the delta sync, its ``sync()`` kinds and tables), a re-balance
swap (``merge_audit``'s stats against the reference's
``merge_subgraph_rows``, with and without excluded shards; the tables
after it the reference's merged ones and a fresh build's), swaps with
slots in flight, a ``kill`` with its failover,
and the shard oversample knob at 1.25. Fixtures and helpers are
``test_torch_sharded.py``'s and ``test_torch_faults.py``'s. The stated
tolerance is exact equality of ids, sims, stats and tables.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.faults import FaultInjector as RFaultInjector  # noqa: E402
from repro.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro.faults import HealthConfig as RHealthConfig  # noqa: E402
from repro.query import rebalance as r_rebalance  # noqa: E402
from repro.query import sharded as r_sharded  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.sched import ManualClock as RManualClock  # noqa: E402
from repro_torch.faults import FaultInjector, FaultPlan, HealthConfig  # noqa: E402
from repro_torch.query import rebalance, sharded  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.sched import ManualClock  # noqa: E402
from test_torch_faults import _assert_done as assert_done  # noqa: E402
from test_torch_faults import _assert_tables as assert_tables  # noqa: E402
from test_torch_faults import _done as done  # noqa: E402
from test_torch_sharded import (_assert_same, _by_rid, _pallas_interpret,  # noqa: E402,F401
                                _run_by_step, _submit, artifact, inserts,
                                profiles)

ROWS = ("graph_ids", "rev_ids", "words", "card", "tombstone")
FAST_HEALTH = dict(max_retries=2, backoff_cap=2, recover_after=2)


def _trio(artifact, shards, spec=None, **kw):
    """(per-device port engine, stacked port engine, reference engine) over
    one artifact, one config, on ManualClocks; with ``spec`` one fault
    plan each (``FAST_HEALTH``)."""
    kw = dict(k=10, shards=shards, **kw)
    inj = [None] * 3
    if spec is not None:
        inj = [FaultInjector(FaultPlan.parse(spec),
                             health=HealthConfig(**FAST_HEALTH))
               for _ in range(2)]
        inj.append(RFaultInjector(RFaultPlan.parse(spec),
                                  health=RHealthConfig(**FAST_HEALTH)))
    per_dev = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                          device="cpu", clock=ManualClock(1.0),
                          faults=inj[0], shard_devices=["cpu"] * shards)
    stacked = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                          device="cpu", clock=ManualClock(1.0),
                          faults=inj[1])
    ref = RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw),
                       clock=RManualClock(1.0), faults=inj[2])
    return per_dev, stacked, ref


def _serve_all(engines, profiles, hops=None, base=0):
    for eng in engines:
        _submit(eng, RQueryRequest if isinstance(eng, RQueryEngine)
                else QueryRequest, profiles, hops=hops, base=base)
        eng.run()


def _assert_layouts(per_dev, stacked, ref):
    sd = per_dev.sharded_state()
    assert sd.layout == "per-device" and len(sd.tables.parts) == sd.n_shards
    assert stacked.sharded_state().layout == "stacked"
    _assert_same(_by_rid(per_dev), _by_rid(ref))
    _assert_same(_by_rid(per_dev), _by_rid(stacked))
    assert per_dev.plan.descent_stats == stacked.plan.descent_stats \
        == ref.plan.descent_stats


@pytest.mark.parametrize("shards,scorer", [(2, {}), (3, {"kernel": True}),
                                           (4, {"kernel": True, "dma": True})])
def test_per_device_waves_match_reference(artifact, profiles, shards, scorer):
    engines = _trio(artifact, shards, beam=16, max_wave=16, **scorer)
    _serve_all(engines, profiles)
    _assert_layouts(*engines)
    sd = engines[0].sharded_state()
    assert sd.devices == [torch.device("cpu")] * shards
    assert_tables(sd, engines[2].sharded_state())


@pytest.mark.parametrize("shards,scorer", [(2, {"kernel": True, "dma": True}),
                                           (3, {})])
def test_per_device_continuous_matches_reference_tick_by_tick(
        artifact, profiles, shards, scorer):
    engines = _trio(artifact, shards, beam=16, continuous=True, slots=8,
                    adaptive=1 if scorer else 0, **scorer)
    hops = [1 + i % 4 for i in range(len(profiles))]
    steps = []
    for eng in engines:
        _submit(eng, RQueryRequest if isinstance(eng, RQueryEngine)
                else QueryRequest, profiles, hops=hops)
        steps.append(_run_by_step(eng))
    assert steps[0] == steps[1] == steps[2]
    _assert_layouts(*engines)


def test_per_device_insert_burst_delta_sync(artifact, profiles, inserts):
    """12 inserts under a 3-shard wave engine, a cohort refresh among them
    (pre-existing users gain residency: a shard rematerialised): the
    sync() kinds and tables equal the reference's after every insert, and
    the wave served after the burst equals both."""
    engines = _trio(artifact, 3, refresh_every=8, beam=16)
    for eng in engines:
        eng.query_batch(profiles[:8])  # freeze the base plan
    sds = [eng.sharded_state() for eng in engines]
    kinds = [[], [], []]
    for p in inserts[:12]:
        for eng, sd, kk in zip(engines, sds, kinds):
            eng.insert(p)
            kk.append(sd.sync())
        assert_tables(sds[0], sds[2])
    assert kinds[0] == kinds[1] == kinds[2] and "delta" in kinds[0]
    assert engines[0].n_refreshes == 1
    _serve_all(engines, profiles[:24])
    _assert_layouts(*engines)


@pytest.mark.parametrize("exclude", [(), (1,)])
def test_merge_audit_and_swap_match_reference(artifact, profiles, inserts,
                                              exclude):
    """After 12 inserts at 3 shards (a cohort refresh among them): the
    merge audit's stats in both layouts equal the reference's
    ``merge_subgraph_rows`` stats, whose rows are the index's; the swap's
    tables, rebuilt from the index, equal the reference's (rebuilt from
    its merge) and a fresh build's, and the next wave equals both."""
    engines = _trio(artifact, 3, refresh_every=8, beam=16)
    for eng in engines:
        eng.query_batch(profiles[:4])
        for p in inserts[:12]:
            eng.insert(p)
    sds = [eng.sharded_state() for eng in engines]
    stats = rebalance.merge_audit(sds[0], exclude=exclude)
    s_stats = rebalance.merge_audit(sds[1], exclude=exclude)
    r_src, r_stats = r_rebalance.merge_subgraph_rows(sds[2], exclude=exclude)
    assert stats == s_stats == r_stats
    assert stats["lanes_patched"] > 0 or not exclude
    ix = engines[0].index
    for name in ROWS:
        np.testing.assert_array_equal(getattr(r_src, name),
                                      getattr(ix, name)[:ix.n], err_msg=name)
    plan = sharded.plan_shards(ix, 3)
    sds[0].adopt_plan(plan)
    sds[1].adopt_plan(sharded.plan_shards(engines[1].index, 3))
    sds[2].adopt_plan(r_sharded.plan_shards(engines[2].index, 3), src=r_src)
    assert_tables(sds[0], sds[2])
    fresh = sharded.ShardedDescent(ix, 3, plan=plan, device="cpu")
    for a, b in zip(fresh._dev, sds[0]._dev):
        assert torch.equal(a, b)
    _serve_all(engines, profiles[:24])
    _assert_layouts(*engines)


def test_per_device_swaps_with_slots_in_flight(artifact, profiles, inserts):
    """A continuous serve at 3 shards with 24 inserts before the first tick
    and a re-balance swap forced before every tick:
    slots in flight relabelled and evicted rows dropped on each shard's
    device; results, steps and the re-balancer's stats (merge stats
    included) equal the reference's and the stacked layout's."""
    engines = _trio(artifact, 3, refresh_every=8, beam=16, continuous=True,
                    slots=8, rebalance_every=1, rebalance_threshold=1.0)
    steps = []
    for eng in engines:
        for p in inserts[:24]:
            eng.insert(p)
        _submit(eng, RQueryRequest if isinstance(eng, RQueryEngine)
                else QueryRequest, profiles, hops=[3] * len(profiles))
        steps.append(_run_by_step(eng, lambda e, tick: e.rebalance.swap()))
    assert steps[0] == steps[1] == steps[2]
    _assert_layouts(*engines)
    stats = [eng.rebalance.stats() for eng in engines]
    assert stats[0] == stats[1] == stats[2] and stats[0]["swaps"] > 2
    assert "merge" in stats[0]
    assert_tables(engines[0].sharded_state(), engines[2].sharded_state())


@pytest.mark.parametrize("continuous", [False, True])
def test_per_device_kill_and_failover(artifact, profiles, continuous):
    """``kill:1@1`` at 2 shards: the degraded window (seeds and merge lanes
    of shard 1 dropped, its in-flight slot beams wiped on its device) and
    the failover swap (the survivors' merge audit): rid by rid, with the
    fault and failover stats, as the reference and the stacked layout."""
    engines = _trio(artifact, 2, "kill:1@1", max_wave=8, slots=8,
                    continuous=continuous)
    _serve_all(engines, profiles)
    for _ in range(8):
        for eng in engines:
            eng.step()
    _serve_all(engines, profiles, base=100)
    d = [done(eng) for eng in engines]
    assert_done(d[0], d[2])
    assert_done(d[0], d[1])
    f = [eng.failover.stats() for eng in engines]
    assert f[0] == f[1] == f[2]
    assert f[0]["failovers"] == 1 and f[0]["merge"]["excluded"] == [1]
    assert any(r[2] for r in d[0])  # degraded completions were served
    _assert_layouts(*engines)
    assert_tables(engines[0].sharded_state(), engines[2].sharded_state())


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3])
def test_shard_oversample_matches_reference(artifact, profiles, devices):
    """``shard_oversample`` 1.25 at 3 shards (a shard beam of 14 lanes,
    not 16), in both layouts."""
    kw = dict(k=10, shards=3, beam=32, shard_oversample=1.25)
    port = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                       device="cpu", shard_devices=devices)
    ref = RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw))
    assert port.plan.spec.shard_oversample == 1.25
    ids, sims = port.query_batch(profiles)
    r_ids, r_sims = ref.query_batch(profiles)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    np.testing.assert_array_equal(sims, np.asarray(r_sims))
    sd = port.sharded_state()
    assert sd.shard_beam(32, 10) == ref.sharded_state().shard_beam(32, 10) \
        == 14
    assert sd.layout == ("stacked" if devices is None else "per-device")


def test_per_device_needs_one_device_per_shard(artifact):
    """S devices place the shards one a device; one device stacks them
    (the reference's ``use_mesh=False``); any other count raises."""
    ix = KNNIndex.load(artifact)
    with pytest.raises(ValueError, match="3 shards need 3 devices"):
        sharded.ShardedDescent(ix, 3, devices=["cpu"] * 2)
    one = sharded.ShardedDescent(ix, 3, devices=["cpu"])
    assert one.layout == "stacked" and one.devices is None
    assert len(one.tables.parts) == 1
    stacked = sharded.ShardedDescent(ix, 3, device="cpu")
    for a, b in zip(one._dev, stacked._dev):
        assert torch.equal(a, b)
