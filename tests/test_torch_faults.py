"""The port's fault layer held bitwise against the JAX reference.

* The fault plan grammar (parse, describe, seeded random plans), the
  injector's windows, crash, arm and ``slow`` on a ``ManualClock``, and
  the health machine's backoff, cap and transient recovery: the same
  events, sequences and ``stats()`` as ``repro.faults``.
* Degraded serving on synth@0.1 at 2 shards: the dead-mask descent, wave
  and continuous serves (adaptive too) across a kill, its degraded
  window and the failover, the cache's ``degraded_skips``, lifecycle and
  re-balance deferral, and ``merge_audit(exclude=)``: ids, sims,
  ``degraded`` and fault, cache and re-balance stats rid by rid.
* Crash recovery: the WAL's JSON lines record for record, replay, the
  crash store, compaction, and stores written by either package
  recovered in the other.
* ``knn_serve --fault-plan/--store/--snapshot-every/--recover --device
  cpu`` against ``repro.launch.knn_serve``; without a card the fault
  flags raise.

The stated tolerance is exact equality of ids, sims, index state, JSON
lines and stats.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.faults import CrashStore as RCrashStore  # noqa: E402
from repro.faults import EngineCrash as REngineCrash  # noqa: E402
from repro.faults import FaultInjector as RFaultInjector  # noqa: E402
from repro.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro.faults import FleetHealth as RFleetHealth  # noqa: E402
from repro.faults import HealthConfig as RHealthConfig  # noqa: E402
from repro.faults import WriteAheadLog as RWriteAheadLog  # noqa: E402
from repro.faults import replay as r_replay  # noqa: E402
from repro.launch import knn_serve as r_knn_serve  # noqa: E402
from repro.query import rebalance as r_rebalance  # noqa: E402
from repro.query import sharded as r_sharded  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.query.router import fingerprint_profiles as r_fp  # noqa: E402
from repro.query.router import profiles_to_csr as r_csr  # noqa: E402
from repro.query.router import route as r_route  # noqa: E402
from repro.sched import ManualClock as RManualClock  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.faults import (CrashStore, EngineCrash, FaultInjector,  # noqa: E402
                                FaultPlan, FleetHealth, HealthConfig,
                                WriteAheadLog, replay)
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.query import rebalance, sharded  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.query.router import fingerprint_profiles, profiles_to_csr, route  # noqa: E402
from repro_torch.sched import ManualClock  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402

_ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids", "tombstone",
         "last_touch")
_TABLES = ("cluster_members", "cluster_offsets", "cluster_paths",
           "cluster_config")
DEV_TABLES = ("l_graph", "l_rev", "l_words", "l_card", "l2g", "l_tomb")
# A kill whose degraded window and failover fall inside a short serve.
FAST_HEALTH = dict(max_retries=2, backoff_cap=2, recover_after=2)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.1 (400 users) at the reference tests' parameters, built by
    the reference and loaded by both packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.1, seed=3),
                       RC2Params(k=10, b=64, t=8, max_cluster=48))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.1, seed=77)
    return [qds.profile(u) for u in range(32)]


@pytest.fixture(scope="module")
def inserts():
    ids = make_dataset("synth", scale=0.1, seed=99)
    return [ids.profile(u) for u in range(32)]


def _plans(spec, **health):
    """(port injector, reference injector) of one spec."""
    cfg = dict(health=HealthConfig(**health)) if health else {}
    r_cfg = dict(health=RHealthConfig(**health)) if health else {}
    return (FaultInjector(FaultPlan.parse(spec), **cfg),
            RFaultInjector(RFaultPlan.parse(spec), **r_cfg))


def _engines(artifact, spec=None, health=None, armed=True, stores=(None,
             None), **kw):
    """(port engine, reference engine) over one artifact, same config, on
    ManualClocks, with one fault plan each when ``spec`` is given."""
    kw = dict(k=10, **kw)
    faults = (None, None)
    if spec is not None:
        faults = _plans(spec, **(health or {}))
        for inj in faults:
            inj.armed = armed
    return (QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                        device="cpu", clock=ManualClock(1.0),
                        faults=faults[0], store=stores[0]),
            RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw),
                         clock=RManualClock(1.0), faults=faults[1],
                         store=stores[1]))


def _serve(engines, profiles, rid0=0):
    """Submit ``profiles`` to both engines and drain them; returns their
    ``run()`` stats."""
    out = []
    for eng, req in zip(engines, (QueryRequest, RQueryRequest)):
        for rid, p in enumerate(profiles):
            eng.submit(req(rid=rid0 + rid, profile=p))
        out.append(eng.run())
    return out


def _done(engine):
    return [(r.rid, r.status, r.degraded, r.ids, r.sims) for r in engine.done]


def _assert_done(a, b):
    assert [x[:3] for x in a] == [x[:3] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[3], y[3], err_msg=str(x[0]))
        np.testing.assert_array_equal(x[4], y[4], err_msg=str(x[0]))


def _by_rid(engine, rids):
    return {r.rid: (r.ids, r.sims) for r in engine.done if r.rid in rids}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid][0], b[rid][0], err_msg=str(rid))
        np.testing.assert_array_equal(a[rid][1], b[rid][1], err_msg=str(rid))


def _assert_tables(sd, r_sd):
    assert (sd.cap, sd.version, sd.generation) == (r_sd.cap, r_sd.version,
                                                   r_sd.generation)
    np.testing.assert_array_equal(sd.dead, r_sd.dead)
    np.testing.assert_array_equal(sd._g2l, r_sd._g2l)
    for a, b, name in zip(sd._dev, r_sd._dev, DEV_TABLES):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.view(np.int32) if name == "l_words" else b,
            err_msg=name)


def _assert_index(ix, r_ix):
    """Rows, version and (after consolidate) the cluster tables."""
    assert ix.version == r_ix.version and ix.n == r_ix.n
    for name in _ROWS:
        np.testing.assert_array_equal(getattr(ix, name), getattr(r_ix, name),
                                      err_msg=name)
    ix.consolidate()
    r_ix.consolidate()
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(ix, name), getattr(r_ix, name),
                                      err_msg=name)


# -- the fault plan grammar and the injector --------------------------------


def test_fault_plan_parse_roundtrip():
    spec = "kill:1@4;fail:0@2+3;slow:2@5+2:1.5,crash@9"
    plan, r_plan = FaultPlan.parse(spec), RFaultPlan.parse(spec)
    assert plan.describe() == r_plan.describe()
    assert [(e.kind, e.step, e.shard, e.duration, e.latency_s)
            for e in plan.events] == [
        (e.kind, e.step, e.shard, e.duration, e.latency_s)
        for e in r_plan.events]
    assert FaultPlan.parse(plan.describe()) == plan
    assert FaultPlan.parse("").describe() == RFaultPlan.parse("").describe()


@pytest.mark.parametrize("bad", [
    "kill:1", "fail:0@2", "slow:1@2+3", "crash@x", "boom:0@1", "kill:@3"])
def test_fault_plan_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        RFaultPlan.parse(bad)


@pytest.mark.parametrize("seed,kinds", [
    (11, ("kill", "fail", "slow")), (12, ("kill", "fail", "slow")),
    (5, ("kill", "fail", "slow", "crash"))])
def test_fault_plan_random_matches_reference(seed, kinds):
    plan = FaultPlan.random(4, 20, seed=seed, n_events=5, kinds=kinds)
    r_plan = RFaultPlan.random(4, 20, seed=seed, n_events=5, kinds=kinds)
    assert plan.describe() == r_plan.describe()
    assert plan == FaultPlan.random(4, 20, seed=seed, n_events=5, kinds=kinds)


def test_injector_windows_crash_and_arm():
    spec = "kill:0@2;fail:1@1+2;crash@6"
    inj, r_inj = _plans(spec)
    trace, r_trace = [], []
    for a, out in ((inj, trace), (r_inj, r_trace)):
        for _ in range(6):
            a.begin_step()
            out.append((a.shard_down(0), a.shard_down(1)))
        a.clear_shard(0)  # a failover cleared the kill that fired
        out.append(a.shard_down(0))
    assert trace == r_trace
    assert trace[:5] == [(False, False), (False, True), (True, True),
                         (True, False), (True, False)] and not trace[-1]
    with pytest.raises(EngineCrash):
        inj.begin_step()
    with pytest.raises(REngineCrash):
        r_inj.begin_step()
    assert inj.stats() == r_inj.stats()
    # Disarmed: nothing fires and the step stays frozen until arm().
    inj, r_inj = _plans("crash@1")
    for a in (inj, r_inj):
        a.armed = False
        for _ in range(4):
            a.begin_step()
        assert a.step == -1
        a.arm()
        a.begin_step()
    with pytest.raises(EngineCrash):
        inj.begin_step()
    with pytest.raises(REngineCrash):
        r_inj.begin_step()
    assert inj.stats() == r_inj.stats() and inj.n_crashes == 1


def test_injector_slow_advances_manual_clock():
    clock, r_clock = ManualClock(), RManualClock()
    inj = FaultInjector(FaultPlan.parse("slow:0@1+2:250;slow:1@2+1:5"),
                        clock=clock)
    r_inj = RFaultInjector(RFaultPlan.parse("slow:0@1+2:250;slow:1@2+1:5"),
                           clock=r_clock)
    t, r_t = [clock()], [r_clock()]
    for _ in range(4):
        inj.begin_step()
        r_inj.begin_step()
        t.append(clock())
        r_t.append(r_clock())
    assert t == r_t  # no time.sleep anywhere: the clocks moved alone
    np.testing.assert_allclose(np.diff(t), [0.0, 0.25, 0.255, 0.0])
    assert inj.stats() == r_inj.stats() and inj.n_slow_steps == 2


# -- the health machine --------------------------------------------------------


@pytest.mark.parametrize("cfg,downs", [
    # Backoff 1, 2, 4 between re-probes, dead at the third failure, then
    # the recovery dwell.
    (dict(max_retries=3, backoff_cap=8, recover_after=4),
     [[False]] + [[True]] * 14),
    # The backoff never exceeds its cap.
    (dict(max_retries=50, backoff_cap=4, recover_after=4), [[True]] * 41),
    # A transient failure clears at the next re-probe, with no death.
    (dict(max_retries=3), [[False, True], [False, False], [True, False],
                           [True, True], [False, False], [False, False]]),
])
def test_health_machine_matches_reference(cfg, downs):
    n = len(downs[0])
    h = FleetHealth(n, HealthConfig(**cfg))
    r_h = RFleetHealth(n, RHealthConfig(**cfg))
    for down in downs:
        h.observe(down)
        r_h.observe(down)
        assert h.state == r_h.state
        np.testing.assert_array_equal(h.backoff, r_h.backoff)
        np.testing.assert_array_equal(h.retries, r_h.retries)
        np.testing.assert_array_equal(h.serving_mask(), r_h.serving_mask())
        assert h.ready_for_recovery() == r_h.ready_for_recovery()
    assert h.stats() == r_h.stats()
    assert int(h.backoff.max()) <= cfg.get("backoff_cap", 8)


# -- degraded serving ------------------------------------------------------------


def test_masked_seed_descent_parity(artifact, profiles):
    """A dead shard is a shard never seeded: the dead-mask descent equals
    the reference's and a healthy fleet's on seeds without the dead
    shard's basins; the counts sum over the alive shards only."""
    ix, r_ix = KNNIndex.load(artifact), RIndex.load(artifact)
    items, offsets = profiles_to_csr(profiles)
    qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
    seeds = route(ix, items, offsets, 16)
    r_items, r_offsets = r_csr(profiles)
    r_qgf = r_fp(r_items, r_offsets, r_ix.n_bits, r_ix.fp_seed)
    np.testing.assert_array_equal(seeds,
                                  r_route(r_ix, r_items, r_offsets, 16))
    qw, qc = np.asarray(qgf.words), np.asarray(qgf.card)
    for dead in ([False, True], [True, False]):
        sd = sharded.ShardedDescent(ix, 2, device="cpu")
        r_sd = r_sharded.ShardedDescent(r_ix, 2)
        sd.set_dead(dead)
        r_sd.set_dead(dead)
        ids, sims = sd.descend(qw, qc, seeds, k=10, beam=32, hops=3)
        r_ids, r_sims = r_sd.descend(np.asarray(r_qgf.words),
                                     np.asarray(r_qgf.card), seeds, k=10,
                                     beam=32, hops=3)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
        np.testing.assert_array_equal(sims.numpy(), np.asarray(r_sims))
        np.testing.assert_array_equal(sd.last_hop_stats, r_sd.last_hop_stats)
        # The same seeds with the dead shard's basins filtered out, on a
        # healthy fleet.
        ok = sharded.ShardedDescent(ix, 2, device="cpu")
        safe = np.where(seeds == PAD_ID, 0, seeds)
        dropped = (seeds != PAD_ID) & np.asarray(dead)[ok.plan.owner[safe]]
        f_ids, f_sims = ok.descend(qw, qc, np.where(dropped, PAD_ID, seeds)
                                   .astype(np.int32), k=10, beam=32, hops=3)
        assert dropped.any()
        assert torch.equal(ids, f_ids) and torch.equal(sims, f_sims)
        np.testing.assert_array_equal(sd.last_hop_stats, ok.last_hop_stats)
        # A swap rebuilds every shard and clears the mask.
        sd.adopt_plan(sharded.plan_shards(ix, 2))
        assert not sd.dead.any()


@pytest.mark.parametrize("continuous,adaptive", [(False, 0), (True, 0),
                                                 (True, 1)])
def test_degraded_serving_and_failover_match_reference(
        artifact, profiles, continuous, adaptive):
    """``kill:1@1`` at 2 shards: suspect at step 1, dead at step 4, swapped
    back at step 6. Served across that window (in-flight continuous slots
    masked at the kill), then idle steps, then again: ids, sims,
    ``degraded``, the fault stats and the tables of the reference."""
    port, ref = _engines(artifact, "kill:1@1", FAST_HEALTH, shards=2,
                         max_wave=8, slots=8, continuous=continuous,
                         adaptive=adaptive)
    stats = _serve((port, ref), profiles)
    assert stats[0]["faults"] == stats[1]["faults"]
    assert stats[0]["faults"]["degraded_served"] > 0
    for _ in range(8):
        port.step()
        ref.step()
    stats = _serve((port, ref), profiles, rid0=100)
    assert stats[0]["faults"] == stats[1]["faults"]
    _assert_done(_done(port), _done(ref))
    f = port.failover.stats()
    assert f == ref.failover.stats()
    assert f["failovers"] == 1 and f["merge"]["excluded"] == [1]
    assert not port.degraded and stats[0]["faults"]["degraded_served"] == 0
    assert port.plan.descent_stats == ref.plan.descent_stats
    _assert_tables(port.sharded_state(), ref.sharded_state())


def test_failover_restores_answers(artifact, profiles):
    """The healthy fleet's answers, then the kill (armed after a clean
    serve), the degraded window and one failover swap: afterwards the
    answers are the healthy fleet's again and the tables a fresh
    ``ShardedDescent``'s."""
    port, ref = _engines(artifact, "kill:1@1", dict(
        max_retries=2, backoff_cap=2, recover_after=3), armed=False,
        shards=2, max_wave=16, cache=32)
    _serve((port, ref), profiles)
    pre = _by_rid(port, range(32))
    flushes = port.plan.cache.flushes
    for eng in (port, ref):
        eng.faults.arm()
    _serve((port, ref), profiles, rid0=100)
    for _ in range(24):
        port.step()
        ref.step()
    assert port.failover.stats() == ref.failover.stats()
    assert port.failover.n_failovers == 1 and not port.degraded
    assert port.failover.last_merge_stats["excluded"] == [1]
    sd = port.sharded_state()
    assert sd.generation == 1 and not sd.dead.any()
    assert port.plan.cache.flushes > flushes
    _serve((port, ref), profiles, rid0=200)
    _assert_done(_done(port), _done(ref))
    assert port.plan.cache.stats() == ref.plan.cache.stats()
    post = {rid - 200: v for rid, v in _by_rid(port, range(200, 232)).items()}
    _assert_same(pre, post)
    _assert_tables(sd, ref.sharded_state())
    fresh = sharded.ShardedDescent(sd.index, 2, plan=sd.plan, device="cpu")
    for a, b, name in zip(fresh._dev, sd._dev, DEV_TABLES):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("continuous", [False, True])
def test_degraded_results_never_cached(artifact, profiles, continuous):
    port, ref = _engines(artifact, "kill:1@0", dict(recover_after=10**6),
                         shards=2, max_wave=16, slots=8, cache=32,
                         continuous=continuous)
    for _ in range(2):  # exact repeats: they would hit if cached
        _serve((port, ref), profiles[:8])
    _assert_done(_done(port), _done(ref))
    cache = port.plan.cache
    assert cache.stats() == ref.plan.cache.stats()
    assert len(cache) == 0 and cache.hits == 0
    assert cache.degraded_skips == 16
    # The raw batch API skips the put as well.
    for eng in (port, ref):
        eng.query_batch(profiles[8:12])
    assert cache.stats() == ref.plan.cache.stats()
    assert cache.degraded_skips == 20


def test_maintenance_defers_while_degraded(artifact, profiles):
    """TTL expiry, churn repair and the re-balancer stand down while a
    shard is masked out."""
    port, ref = _engines(artifact, "kill:1@0", dict(recover_after=10**6),
                         shards=2, max_wave=16, ttl=1, rebalance_every=1)
    _serve((port, ref), profiles[:8])
    assert port.degraded and ref.degraded
    out = port.lifecycle.maintain()
    assert out == ref.lifecycle.maintain() and out["deferred"]
    assert port.lifecycle.n_expired == 0
    assert port.rebalance.stats() == ref.rebalance.stats()
    assert port.rebalance.n_deferred > 0 and port.rebalance.n_swaps == 0


@pytest.mark.parametrize("exclude", [[1], [0, 2]])
def test_merge_audit_excluding_shards(artifact, profiles, inserts, exclude):
    """``merge_audit(exclude=)`` gives ``merge_subgraph_rows(exclude)``'s
    stats (``excluded``, ``rows_unseen``, the lanes to patch) at 3 shards
    after 12 inserts (a cohort refresh among them)."""
    port, ref = _engines(artifact, shards=3, refresh_every=8)
    for eng in (port, ref):
        eng.query_batch(profiles[:4])  # freeze the base plan
        for p in inserts[:12]:
            eng.insert(p)
    sd, r_sd = port.sharded_state(), ref.sharded_state()
    stats = rebalance.merge_audit(sd, exclude=exclude)
    r_src, r_stats = r_rebalance.merge_subgraph_rows(r_sd, exclude=exclude)
    assert stats == r_stats
    assert stats["excluded"] == exclude and stats["lanes_patched"] > 0
    for name in ("graph_ids", "rev_ids", "words", "card", "tombstone"):
        np.testing.assert_array_equal(getattr(r_src, name),
                                      getattr(port.index, name),
                                      err_msg=name)


# -- write-ahead log and crash store --------------------------------------------


def _mutate(engines, inserts):
    """Ten inserts (a cohort refresh at 8), a delete, an update, a touch."""
    for eng in engines:
        for p in inserts[:10]:
            eng.insert(p)
        eng.remove_user(3)
        eng.update_user(7, inserts[10])
        eng.touch(11)


def test_wal_lines_and_replay_match_reference(artifact, inserts, tmp_path):
    port, ref = _engines(artifact, refresh_every=8)
    wal = WriteAheadLog(tmp_path / "port.jsonl")
    r_wal = RWriteAheadLog(tmp_path / "ref.jsonl", append=False)
    port.index.attach_wal(wal)
    ref.index.attach_wal(r_wal)
    _mutate((port, ref), inserts)
    assert port.index.detach_wal() is wal and ref.index.detach_wal() is r_wal
    wal.close()
    r_wal.close()
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert lines == (tmp_path / "ref.jsonl").read_text().splitlines()
    ops = [json.loads(x)["op"] for x in lines]
    assert {"append_user", "add_cluster_member", "refresh_cohort",
            "remove_user", "swap_profile", "relink_user",
            "touch_row"} <= set(ops)
    assert wal.n_records == r_wal.n_records == len(lines)
    # Replay onto a fresh copy, in each package and across them.
    records = WriteAheadLog.read(tmp_path / "port.jsonl")
    rec = KNNIndex.load(artifact)
    assert replay(rec, records) == len(lines)
    _assert_index(rec, port.index)
    r_rec = RIndex.load(artifact)
    r_replay(r_rec, records)
    _assert_index(rec, r_rec)
    _assert_index(port.index, ref.index)


def _crash_drive(engines, inserts, steps=10):
    """Insert every step (a delete every third), then step; returns the
    step of each engine's crash (None if it did not crash)."""
    out = []
    for eng, crash in zip(engines, (EngineCrash, REngineCrash)):
        at = None
        for t in range(steps):
            eng.insert(inserts[t])
            if t % 3 == 2:
                eng.remove_user(10 * t)
            try:
                eng.step()
            except crash:
                at = t
                break
        out.append(at)
    return out


@pytest.mark.parametrize("shards", [1, 2])
def test_crash_store_recovers_engine_bitwise(artifact, profiles, inserts,
                                             tmp_path, shards):
    """Crash at step 5 with snapshots every 3 steps: the recovered index
    and its served answers equal a never-crashed mirror's and the
    reference's recovered engine's."""
    qc = dict(shards=shards, max_wave=16)
    port, ref = _engines(artifact, "crash@5", stores=(
        CrashStore(tmp_path / "port", every=3),
        RCrashStore(tmp_path / "ref", every=3)), **qc)
    assert _crash_drive((port, ref), inserts) == [5, 5]
    mirror, _ = _engines(artifact, **qc)
    for t in range(6):  # the mirror runs the step the crash pre-empted
        mirror.insert(inserts[t])
        if t % 3 == 2:
            mirror.remove_user(10 * t)
        mirror.step()
    rec = QueryEngine.recover(tmp_path / "port", QueryConfig(k=10, **qc),
                              device="cpu", clock=ManualClock(1.0))
    r_rec = RQueryEngine.recover(tmp_path / "ref", RQueryConfig(k=10, **qc),
                                 clock=RManualClock(1.0))
    _serve((rec, r_rec), profiles)
    for rid, p in enumerate(profiles):
        mirror.submit(QueryRequest(rid=rid, profile=p))
    mirror.run()
    _assert_done(_done(rec), _done(r_rec))
    _assert_same(_by_rid(rec, range(32)), _by_rid(mirror, range(32)))
    assert rec.lifecycle.clock == r_rec.lifecycle.clock
    _assert_index(rec.index, mirror.index)
    _assert_index(rec.index, r_rec.index)


def test_crash_store_compaction_bounds_wal(artifact, inserts, tmp_path):
    port, ref = _engines(artifact, stores=(
        CrashStore(tmp_path / "port", every=2),
        RCrashStore(tmp_path / "ref", every=2)), max_wave=16)
    for t in range(9):
        for eng in (port, ref):
            eng.insert(inserts[t])
            eng.step()
    assert port.store.stats() == ref.store.stats()
    assert port.store.n_snapshots >= 4
    wals = sorted((tmp_path / "port").glob("wal_*.jsonl"))
    assert [w.name for w in wals] == [
        w.name for w in sorted((tmp_path / "ref").glob("wal_*.jsonl"))]
    for w in wals:
        assert w.read_text() == (tmp_path / "ref" / w.name).read_text()
    total = sum(len(WriteAheadLog.read(w)) for w in wals)
    assert 0 < port.store.wal.n_records <= total / 2
    for name in ("manifest.json",):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "ref" / name).read_text()))


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("shards", [1, 2])
def test_store_recovers_across_packages(artifact, profiles, inserts,
                                        tmp_path, writer, shards):
    """A store written by one package recovers in the other: the same
    index (rows, version, cluster tables) and the same served answers as
    the writer's own recovery."""
    qc = dict(shards=shards, max_wave=16, refresh_every=4)
    port, ref = _engines(artifact, "crash@6", stores=(
        CrashStore(tmp_path / "port", every=4),
        RCrashStore(tmp_path / "ref", every=4)), **qc)
    assert _crash_drive((port, ref), inserts) == [6, 6]
    root = tmp_path / ("port" if writer == "port" else "ref")
    rec = QueryEngine.recover(root, QueryConfig(k=10, **qc), device="cpu",
                              clock=ManualClock(1.0))
    r_rec = RQueryEngine.recover(root, RQueryConfig(k=10, **qc),
                                 clock=RManualClock(1.0))
    if shards > 1:
        np.testing.assert_array_equal(
            rec.sharded_state().plan.owner, r_rec.sharded_state().plan.owner)
    _serve((rec, r_rec), profiles)
    _assert_done(_done(rec), _done(r_rec))
    _assert_index(rec.index, r_rec.index)


# -- the CLI -----------------------------------------------------------------------


def _lines(text, tags):
    return [x for x in text.splitlines() if x.startswith(tags)]


@pytest.mark.parametrize("flags", [
    ["--shards", "2", "--max-wave", "16", "--fault-plan",
     "kill:1@2;fail:0@6+1;slow:1@3+1:2"],
    ["--shards", "2", "--continuous", "--slots", "16", "--fault-plan",
     "kill:0@1", "--cache", "32"],
    # Every fault knob at once: a kill, a transient failure, a slow shard
    # and the crash store, over inserts, the cache and the DMA hop's
    # plain version.
    ["--shards", "2", "--continuous", "--slots", "16", "--kernel", "--dma",
     "--insert", "20", "--cache", "64", "--snapshot-every", "2",
     "--fault-plan", "kill:1@2;fail:0@6+2;slow:1@3+1:1", "--store", "{}"],
])
def test_knn_serve_fault_plan_matches_reference(flags, tmp_path, capsys):
    base = ["--dataset", "synth", "--scale", "0.1", "--queries", "48"]
    stats, recall, engine = knn_serve.main(
        base + [x.format(tmp_path / "p") for x in flags]
        + ["--device", "cpu"])
    out = capsys.readouterr().out
    r_stats, r_recall = r_knn_serve.main(
        base + [x.format(tmp_path / "r") for x in flags])
    r_out = capsys.readouterr().out
    tags = ("[serve] fault plan:", "[serve] faults:", "[serve] cache:",
            "[serve] store:")
    assert _lines(out, tags) == _lines(r_out, tags)
    assert len(_lines(out, tags[:2])) == 2
    assert recall == r_recall
    for key in ("requests", "served", "waves", "faults", "cache", "store"):
        assert stats.get(key) == r_stats.get(key), key
    if "--store" in flags:
        assert engine.store.n_snapshots > 1
        for w in sorted((tmp_path / "p").glob("wal_*.jsonl")):
            assert w.read_text() == (tmp_path / "r" / w.name).read_text()


def test_knn_serve_crash_and_recover_match_reference(tmp_path, capsys):
    """``--store --snapshot-every 2`` with ``crash@3`` stops both CLIs;
    ``--recover`` restores each store, and the port also recovers the
    reference's: the same recovered index and the same serve."""
    base = ["--dataset", "synth", "--scale", "0.1", "--queries", "32",
            "--shards", "2", "--max-wave", "8"]
    crash = ["--insert", "20", "--snapshot-every", "2", "--fault-plan",
             "crash@3"]
    stats, recall, _ = knn_serve.main(
        base + crash + ["--store", str(tmp_path / "p"), "--device", "cpu"])
    out = capsys.readouterr().out
    r_stats, r_recall = r_knn_serve.main(
        base + crash + ["--store", str(tmp_path / "r")])
    r_out = capsys.readouterr().out
    assert stats == r_stats == {"requests": 0, "crashed": True}
    assert recall == r_recall == 0.0
    tag = ("[serve] CRASHED:",)
    assert _lines(out, tag) == _lines(r_out, tag) and _lines(out, tag)
    assert "--recover" in out
    runs = []
    for root, fn in ((tmp_path / "p", knn_serve.main),
                     (tmp_path / "r", knn_serve.main),
                     (tmp_path / "r", r_knn_serve.main)):
        flags = base + ["--recover", str(root), "--store",
                        str(root) + "_after"]
        if fn is knn_serve.main:
            flags += ["--device", "cpu"]
        result = fn(flags)
        text = capsys.readouterr().out.replace(str(root), "STORE")
        runs.append((result, _lines(text, ("[serve] recovered from",
                                           "[serve] store:"))))
    (p, p_lines), (x, x_lines), (r, r_lines) = runs
    assert p_lines == x_lines == r_lines and len(p_lines) == 2
    assert p[1] == x[1] == r[1] and p[0]["requests"] == 32
    for key in ("requests", "served", "waves", "store"):
        assert p[0][key] == x[0][key] == r[0][key], key
    _assert_done(_done(p[2]), _done(x[2]))


@pytest.mark.parametrize("flag", [["--fault-plan", "kill:1@40"],
                                  ["--store", "crash_store"],
                                  ["--snapshot-every", "3"],
                                  ["--fault-plan", "crash@3"],
                                  ["--recover", "crash_store"]])
def test_fault_flags_need_the_card(flag, monkeypatch, tmp_path):
    """The fault flags serve on ``--device cuda`` by default: without a
    card they raise before any work, with no silent CPU path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        knn_serve.main(flag + ["--dataset", "synth", "--scale", "0.05"])
    assert not (tmp_path / "crash_store").exists()
