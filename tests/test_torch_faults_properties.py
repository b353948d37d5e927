"""Hypothesis batteries of the fault layer, the port and the JAX reference
driven on the same schedule (the ports of ``test_faults_properties.py``):

* a crash at any step of any mutation schedule, under any plan shape (1
  or 2 shards, wave or continuous), recovers by snapshot and WAL replay to
  an index bitwise equal to a never-crashed engine's, in rows, cluster
  tables and served answers, and to the reference's recovered engine;
* any kill / recover interleaving under serving completes every request,
  never serves a user removed before the request was submitted, converges
  back to a healthy fleet that answers as a fresh engine does, and serves
  the reference's ids, sims and ``degraded`` flags rid by rid throughout.

The stated tolerance is exact equality.
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.params import C2Params as RC2Params  # noqa: E402
from repro.data.synthetic import make_dataset as r_make_dataset  # noqa: E402
from repro.faults import CrashStore as RCrashStore  # noqa: E402
from repro.faults import EngineCrash as REngineCrash  # noqa: E402
from repro.faults import FaultInjector as RFaultInjector  # noqa: E402
from repro.faults import FaultPlan as RFaultPlan  # noqa: E402
from repro.faults import HealthConfig as RHealthConfig  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro.query.index import build_index as r_build_index  # noqa: E402
from repro.sched import ManualClock as RManualClock  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.faults import (CrashStore, EngineCrash, FaultInjector,  # noqa: E402
                                FaultPlan, HealthConfig)
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex  # noqa: E402
from repro_torch.sched import ManualClock  # noqa: E402

_ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids", "tombstone",
         "last_touch")
_TABLES = ("cluster_members", "cluster_offsets", "cluster_paths",
           "cluster_config")
SETTINGS = settings(max_examples=6, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users), the reference battery's index, built by the
    reference and loaded by both packages."""
    ix = r_build_index(r_make_dataset("synth", scale=0.05, seed=5),
                       RC2Params(k=8, b=64, t=4, max_cluster=32))
    path = tmp_path_factory.mktemp("ix") / "synth.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(40)]


def _schedule(ops_seed: int, n_steps: int):
    """The reference battery's per-step mutation schedule: the same seed
    gives the same ops to every engine compared."""
    rng = np.random.default_rng(ops_seed)
    sched = []
    for _ in range(n_steps):
        ops = []
        if rng.random() < 0.7:
            ops.append(("insert", int(rng.integers(8, 40))))
        if rng.random() < 0.3:
            ops.append(("remove", int(rng.integers(0, 100))))
        if rng.random() < 0.2:
            ops.append(("touch", int(rng.integers(100, 180))))
        sched.append(ops)
    return sched


def _apply(eng, ops, profiles, removed):
    for op, a in ops:
        if op == "insert":
            eng.insert(profiles[a])
        elif op == "remove":
            if a not in removed and not eng.index.tombstone[a]:
                eng.remove_user(a)
            removed.add(a)
        elif op == "touch":
            if not eng.index.tombstone[a]:
                eng.touch(a)


def _wave(eng, req, profiles, n=8):
    base = len(eng.done)
    for rid, p in enumerate(profiles[:n]):
        eng.submit(req(rid=rid, profile=p))
    eng.run()
    return [(r.rid, r.degraded, np.asarray(r.ids), np.asarray(r.sims))
            for r in eng.done[base:]]


def _assert_waves(a, b):
    assert [x[:2] for x in a] == [x[:2] for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[2], y[2], err_msg=str(x[0]))
        np.testing.assert_array_equal(x[3], y[3], err_msg=str(x[0]))


def _assert_index(ix, other):
    assert ix.version == other.version
    for name in _ROWS:
        np.testing.assert_array_equal(getattr(ix, name), getattr(other, name),
                                      err_msg=name)
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(ix, name), getattr(other, name),
                                      err_msg=name)


@SETTINGS
@given(crash_step=st.integers(min_value=1, max_value=9),
       shards=st.integers(min_value=1, max_value=2),
       continuous=st.booleans(),
       ops_seed=st.integers(min_value=0, max_value=10**6))
def test_any_crash_point_recovers_bitwise(artifact, profiles, crash_step,
                                          shards, continuous, ops_seed):
    kw = dict(k=8, beam=12, hops=2, shards=shards, continuous=continuous,
              slots=8, max_wave=8, refresh_every=6)
    sched = _schedule(ops_seed, 12)
    spec = f"crash@{crash_step}"
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as r_tmp:
        _crash_and_recover(artifact, profiles, kw, sched, spec, tmp,
                           r_tmp)


def _crash_and_recover(artifact, profiles, kw, sched, spec, tmp, r_tmp):
    """Crash the port and the reference on one schedule, recover both
    from their stores, and hold them against a never-crashed mirror."""
    eng = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                      device="cpu", clock=ManualClock(),
                      faults=FaultInjector(FaultPlan.parse(spec)),
                      store=CrashStore(tmp, every=3))
    r_eng = RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw),
                         clock=RManualClock(),
                         faults=RFaultInjector(RFaultPlan.parse(spec)),
                         store=RCrashStore(r_tmp, every=3))
    mirror = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                         device="cpu", clock=ManualClock())
    rA, rB, rC = set(), set(), set()
    crashed = 0
    for ops in sched:
        _apply(eng, ops, profiles, rA)
        _apply(r_eng, ops, profiles, rC)
        for e, crash in ((eng, EngineCrash), (r_eng, REngineCrash)):
            try:
                e.step()
            except crash:
                crashed += 1
        if crashed:
            break
        _apply(mirror, ops, profiles, rB)
        mirror.step()
    assert crashed == 2 and eng.faults.step == r_eng.faults.step
    # The crash pre-empted the step after eng applied its ops: the mirror
    # applies them and runs the step the crash ate.
    _apply(mirror, sched[eng.faults.step], profiles, rB)
    mirror.step()

    rec = QueryEngine.recover(tmp, QueryConfig(**kw), device="cpu",
                              clock=ManualClock())
    r_rec = RQueryEngine.recover(r_tmp, RQueryConfig(**kw),
                                 clock=RManualClock())
    for ix in (rec.index, mirror.index, r_rec.index):
        ix.consolidate()
    _assert_index(rec.index, mirror.index)
    _assert_index(rec.index, r_rec.index)
    # Served answers, not only tables: a fresh wave answers the same on
    # all three (the mirror's leftover slots do not touch new requests).
    ours = _wave(rec, QueryRequest, profiles)
    _assert_waves(ours, _wave(mirror, QueryRequest, profiles))
    _assert_waves(ours, _wave(r_rec, RQueryRequest, profiles))


@SETTINGS
@given(kill_step=st.integers(min_value=0, max_value=6),
       kill_shard=st.integers(min_value=0, max_value=1),
       ops_seed=st.integers(min_value=0, max_value=10**6),
       continuous=st.booleans())
def test_any_kill_recover_interleaving_serves_and_converges(
        artifact, profiles, kill_step, kill_shard, ops_seed, continuous):
    kw = dict(k=8, beam=12, hops=2, shards=2, continuous=continuous,
              slots=8, max_wave=8)
    spec = f"kill:{kill_shard}@{kill_step}"
    health = dict(max_retries=1, backoff_cap=1, recover_after=2)
    eng = QueryEngine(KNNIndex.load(artifact), QueryConfig(**kw),
                      device="cpu", clock=ManualClock(),
                      faults=FaultInjector(FaultPlan.parse(spec),
                                           health=HealthConfig(**health)))
    r_eng = RQueryEngine(RIndex.load(artifact), RQueryConfig(**kw),
                         clock=RManualClock(),
                         faults=RFaultInjector(
                             RFaultPlan.parse(spec),
                             health=RHealthConfig(**health)))
    rng = np.random.default_rng(ops_seed)
    removed: set[int] = set()
    for t in range(10):
        removed_at_submit = set(removed)
        base = len(eng.done)
        for e, req in ((eng, QueryRequest), (r_eng, RQueryRequest)):
            for rid, p in enumerate(profiles[t:t + 4]):
                e.submit(req(rid=1000 * t + rid, profile=p))
        if rng.random() < 0.4:
            a = int(rng.integers(0, 100))
            if not eng.index.tombstone[a]:
                eng.remove_user(a)
                r_eng.remove_user(a)
                removed.add(a)
        eng.run()  # drain: every submitted request completes
        r_eng.run()
        for r in eng.done[base:]:
            assert r.status == "done"
            served = set(int(i) for i in r.ids if i >= 0)
            # Nothing removed before submission is served (later removes
            # may race a result legally).
            assert not (served & removed_at_submit), (t, r.rid)
    _assert_waves(*([(r.rid, r.degraded, r.ids, r.sims) for r in e.done]
                    for e in (eng, r_eng)))
    assert any(r.degraded for r in eng.done)
    # Idle steps walk the health machine from dead to recovered.
    for _ in range(20):
        eng.step()
        r_eng.step()
    assert not eng.degraded and eng.failover.n_failovers >= 1
    assert eng.failover.health.state == ["healthy", "healthy"]
    assert eng.failover.stats() == r_eng.failover.stats()
    # Converged: the recovered fleet answers as a fresh engine on the same
    # mutated index does.
    fresh = QueryEngine(eng.index, QueryConfig(**kw), device="cpu",
                        clock=ManualClock())
    _assert_waves(_wave(eng, QueryRequest, profiles),
                  _wave(fresh, QueryRequest, profiles))
