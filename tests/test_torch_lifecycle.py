"""The port's mutable index at the engine level, held bitwise against the
JAX reference on the CPU.

* Random interleavings of insert / remove / update / repair / query /
  serve, under wave and continuous batching and with TTL expiry and the
  repair cadence on or off: the port's engine (plain, fused and DMA hop;
  on the CPU the hop wrappers run their plain versions) against
  ``repro``'s engine with the same batching (plain hop) — every served
  request's ids and sims, the final probe wave, the index's row arrays,
  cluster tables, version and lifecycle counters.
* No request is served an id that was tombstoned when it was served (the
  check runs right after each serving step, before the maintenance that
  follows it).
* The plan's journal-synced device tables equal a fresh padded upload of
  the mutated index and the reference's own synced copies, across a
  capacity crossing.
* Mutations landing between continuous ticks reach in-flight slots.
* Masking equals excision: descending the scrubbed copy
  (``scrub_dead_references``) with no mask equals descending the original
  under its tombstone mask, through all three hops.
* ``knn_serve --insert/--churn/--ttl/--repair-every`` against the
  reference CLI.

Every comparison is exact (``np.array_equal`` / ``==``).
"""
import copy

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.launch import knn_serve as r_knn_serve  # noqa: E402
from repro.lifecycle import scrub_dead_references as r_scrub  # noqa: E402
from repro.query.engine import QueryConfig as RQueryConfig  # noqa: E402
from repro.query.engine import QueryEngine as RQueryEngine  # noqa: E402
from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro.query.index import KNNIndex as RIndex  # noqa: E402
from repro_torch.core.params import C2Params, params_for  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.launch import knn_serve  # noqa: E402
from repro_torch.lifecycle import scrub_dead_references  # noqa: E402
from repro_torch.query.engine import QueryConfig, QueryEngine, QueryRequest  # noqa: E402
from repro_torch.query.index import KNNIndex, build_index  # noqa: E402
from repro_torch.query.plan import DescentPlan  # noqa: E402
from repro_torch.query.router import (fingerprint_profiles,  # noqa: E402
                                      profiles_to_csr, route)
from repro_torch.query.search import batched_descent  # noqa: E402
from repro_torch.sketch.goldfinger import words_tensor  # noqa: E402
from repro_torch.types import PAD_ID  # noqa: E402

ROWS = ("graph_ids", "graph_sims", "words", "card", "rev_ids", "tombstone",
        "last_touch")
SCORERS = {"jnp": {}, "pallas": {"kernel": True},
           "pallas_dma": {"kernel": True, "dma": True}}
OPS = ("insert", "remove", "update", "repair", "query", "serve")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """synth@0.05 (200 users, k = 8), built by the port and saved: both
    packages load it (their builds are equal: test_torch_serve.py)."""
    ix = build_index(make_dataset("synth", scale=0.05, seed=5),
                     C2Params(k=8, b=64, t=4, max_cluster=32), device="cpu")
    path = tmp_path_factory.mktemp("ix") / "small.npz"
    ix.save(path)
    return path


@pytest.fixture(scope="module")
def profiles():
    qds = make_dataset("synth", scale=0.05, seed=7)
    return [qds.profile(u) for u in range(qds.n_users)]


def _engines(artifact, continuous, scorer, **kw):
    """(port engine with ``scorer``, reference engine with the plain hop),
    same batching and lifecycle settings, over one artifact."""
    common = dict(k=8, beam=12, hops=2, slots=8, continuous=continuous, **kw)
    port = QueryEngine(KNNIndex.load(artifact),
                       QueryConfig(**common, **SCORERS[scorer]),
                       device="cpu")
    ref = RQueryEngine(RIndex.load(artifact), RQueryConfig(**common))
    return port, ref


def _watch_tombstones(engine):
    """Check every request as it completes against the tombstone mask of
    that moment: wrap the plan's step, which runs before the engine's
    between-step maintenance."""
    plan_step = engine.plan.step

    def step(queue, done):
        before = len(done)
        n = plan_step(queue, done)
        tomb = engine.index.tombstone
        for r in done[before:]:
            served = r.ids[r.ids != PAD_ID]
            assert not tomb[served].any(), f"rid {r.rid} got a dead id"
        return n

    engine.plan.step = step


def _drive(engine, request_cls, ops, profiles, seed):
    """Apply an op sequence; targets come from a seeded rng over the
    engine's own live set, so engines with equal results walk equal
    index trajectories. Returns the final probe wave."""
    rng = np.random.default_rng(seed)
    n_ins = 0
    for op in ops:
        ix = engine.index
        alive = ix.alive_ids()
        if op == "insert":
            engine.insert(profiles[30 + n_ins])
            n_ins += 1
        elif op == "remove" and len(alive) > ix.k + 2:
            engine.remove_user(int(rng.choice(alive)))
        elif op == "update" and len(alive) > ix.k + 2:
            engine.update_user(int(rng.choice(alive)),
                               profiles[int(rng.integers(0, 8))])
        elif op == "repair":
            engine.lifecycle.repair()
        elif op == "query":
            engine.query_batch(profiles[:4])
        elif op == "serve":  # through the scheduler loop (maintain fires)
            for i in range(3):
                engine.submit(request_cls(
                    rid=i, profile=np.asarray(profiles[8 + i], np.int32)))
            engine.run()
    return engine.query_batch(profiles[:4])


def _assert_same_state(port, ref):
    for name in ROWS:
        assert np.array_equal(getattr(port.index, name),
                              getattr(ref.index, name)), name
    assert port.index.version == ref.index.version
    assert port.index.n_clusters == ref.index.n_clusters
    for ci in range(port.index.n_clusters):
        assert np.array_equal(port.index.cluster_users(ci),
                              ref.index.cluster_users(ci))
    assert port.lifecycle.stats() == ref.lifecycle.stats()
    assert (port.n_inserted, port.n_refreshes) == \
        (ref.n_inserted, ref.n_refreshes)
    assert len(port.done) == len(ref.done)
    for a, b in zip(port.done, ref.done):
        assert a.rid == b.rid
        assert np.array_equal(a.ids, np.asarray(b.ids))
        assert np.array_equal(a.sims, np.asarray(b.sims))


def _assert_tables_fresh(port, ref):
    """The port's journal-synced tables == a fresh padded upload of the
    same index == the reference's synced copies (words as bit-views)."""
    synced = port.plan.sync()
    fresh = DescentPlan(port.index, port.plan.spec, device="cpu").sync()
    theirs = ref.plan._sync_single()
    for name, a, b, c in zip(("graph", "rev", "words", "card", "tomb"),
                             synced, fresh, theirs):
        assert a.shape[0] >= port.index.n
        assert torch.equal(a, b), name
        c = np.asarray(c)
        if name == "words":
            c = c.view(np.int32)
        assert np.array_equal(a.numpy(), c), name


@settings(max_examples=8, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(ops=st.lists(st.sampled_from(OPS), min_size=1, max_size=8),
       continuous=st.booleans(),
       scorer=st.sampled_from(sorted(SCORERS)),
       ttl=st.sampled_from([0, 5]),
       repair_every=st.sampled_from([0, 2]),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_interleavings_match_reference(artifact, profiles, ops, continuous,
                                       scorer, ttl, repair_every, seed):
    port, ref = _engines(artifact, continuous, scorer, ttl=ttl,
                         repair_every=repair_every, refresh_every=3)
    _watch_tombstones(port)
    ids, sims = _drive(port, QueryRequest, ops, profiles, seed)
    r_ids, r_sims = _drive(ref, RQueryRequest, ops, profiles, seed)
    assert np.array_equal(ids, np.asarray(r_ids))
    assert np.array_equal(sims, np.asarray(r_sims))
    assert not port.index.tombstone[ids[ids != PAD_ID]].any()
    _assert_same_state(port, ref)
    _assert_tables_fresh(port, ref)


@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_capacity_crossing_reuploads(artifact, profiles, scorer):
    """60 inserts take n from 200 past ``capacity_of(n, 64)`` = 256: the
    plan re-uploads in full at the crossing (512 rows), scatters journal
    rows otherwise, and serves what the reference serves after it."""
    port, ref = _engines(artifact, False, scorer, refresh_every=64)
    port.query_batch(profiles[:4])
    ref.query_batch(profiles[:4])
    for m in range(60):
        for eng in (port, ref):
            eng.insert(profiles[30 + m])
        if port.index.n == 255:
            assert port.plan.sync()[0].shape[0] == 256
    st_ = port.plan.sync_stats
    assert st_["full_uploads"] == 2 and st_["scatters"] >= 50
    assert port.plan.sync()[0].shape[0] == 512
    for eng, req in ((port, QueryRequest), (ref, RQueryRequest)):
        for rid in range(6):
            eng.submit(req(rid=rid, profile=profiles[100 + rid]))
        eng.run()
    _assert_same_state(port, ref)
    _assert_tables_fresh(port, ref)


def _mid_flight(engine, tick):
    """Between continuous ticks: remove the best id of the first active
    slot's beam, then update a user, then insert one."""
    ix = engine.index
    profile = np.arange(ix.n % 7, 60, 3, dtype=np.int32)
    if tick == 1:
        st_ = engine.plan._slots
        slot = int(np.flatnonzero(st_.sched.active_mask())[0])
        engine.remove_user(int(np.asarray(st_.beam_ids)[slot, 0]))
    elif tick == 2:
        engine.update_user(int(ix.alive_ids()[11]), profile)
    elif tick == 3:
        engine.insert(profile)


@pytest.mark.parametrize("scorer", sorted(SCORERS))
def test_mid_serve_mutations_reach_in_flight_slots(artifact, profiles,
                                                   scorer):
    port, ref = _engines(artifact, True, scorer, repair_every=2)
    _watch_tombstones(port)
    for eng, req in ((port, QueryRequest), (ref, RQueryRequest)):
        for rid in range(12):
            eng.submit(req(rid=rid, profile=profiles[40 + rid]))
        eng.run(on_tick=_mid_flight)
    assert port.lifecycle.n_removed == 1 and port.lifecycle.n_updated == 1
    _assert_same_state(port, ref)
    _assert_tables_fresh(port, ref)


def test_masking_equals_excision(artifact, profiles):
    """Descending the scrubbed copy with no mask equals descending the
    original under its mask, bitwise, through all three hops; the port's
    scrub equals the reference's."""
    port, ref = _engines(artifact, False, "jnp")
    for u in (2, 7, 19, 33, 120):
        port.remove_user(u)
        ref.remove_user(u)
    ix = port.index
    scrubbed = copy.deepcopy(ix)
    r_scrubbed = copy.deepcopy(ref.index)
    n = scrub_dead_references(scrubbed)
    assert n == r_scrub(r_scrubbed) and n > 0
    for name in ROWS:
        assert np.array_equal(getattr(scrubbed, name),
                              getattr(r_scrubbed, name)), name
    assert scrubbed.version == ix.version + 1
    items, offsets = profiles_to_csr(profiles[:16])
    qgf = fingerprint_profiles(items, offsets, ix.n_bits, ix.fp_seed)
    seeds = torch.from_numpy(route(ix, items, offsets, 16))
    qw, qc = words_tensor(qgf.words, "cpu"), torch.from_numpy(qgf.card)
    spec = port.plan.spec
    masked = port.plan.sync()
    clean = DescentPlan(scrubbed, spec, device="cpu").sync()
    for kw in SCORERS.values():
        a = batched_descent(*masked[:4], qw, qc, seeds, k=8, beam=12, hops=3,
                            tomb=masked[4], **kw)
        b = batched_descent(*clean[:4], qw, qc, seeds, k=8, beam=12, hops=3,
                            tomb=None, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not np.isin(a[0].numpy(), [2, 7, 19, 33, 120]).any()


@pytest.mark.parametrize("flags", [
    ["--insert", "70", "--churn", "6", "--repair-every", "2"],
    ["--insert", "5", "--churn", "4", "--ttl", "4", "--continuous",
     "--slots", "8", "--kernel", "--dma"],
])
def test_knn_serve_mutation_flags_match_reference(tmp_path, flags,
                                                  monkeypatch, capsys):
    """``knn_serve`` with the mutation flags over one synth@0.1 artifact:
    the same served ids and sims rid by rid, recall, counters and
    mutated index as the reference CLI (whose flags name the plain hop:
    the scorer never changes a result)."""
    ds = make_dataset("synth", scale=0.1, seed=0)
    ix = build_index(ds, params_for("synth", k=10, b=max(64, ds.n_users // 16),
                                    max_cluster=max(48, int(0.06 * ds.n_users))),
                     device="cpu")
    path = str(tmp_path / "synth.npz")
    ix.save(path)
    common = ["--index", path, "--dataset", "synth", "--scale", "0.1",
              "--queries", "24", "--beam", "16"]
    captured = []

    class Capture(RQueryEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(r_knn_serve, "QueryEngine", Capture)
    r_flags = [f for f in flags if f not in ("--kernel", "--dma")]
    r_stats, r_recall = r_knn_serve.main(common + r_flags)
    r_out = capsys.readouterr().out
    stats, recall, engine = knn_serve.main(common + flags
                                           + ["--device", "cpu"])
    out = capsys.readouterr().out
    ref = captured[0]
    assert recall == r_recall
    for key in ("requests", "waves", "inserted", "refreshes"):
        assert stats[key] == r_stats[key], key
    assert stats["lifecycle"] == ref.lifecycle.stats()
    line = [x for x in out.splitlines() if "churned" in x]
    assert line and line == [x for x in r_out.splitlines()
                             if "churned" in x]
    by_rid = {r.rid: r for r in engine.done}
    assert sorted(by_rid) == sorted(r.rid for r in ref.done) == \
        list(range(24))
    for r in ref.done:
        assert np.array_equal(by_rid[r.rid].ids, np.asarray(r.ids))
        assert np.array_equal(by_rid[r.rid].sims, np.asarray(r.sims))
    for name in ROWS:
        assert np.array_equal(getattr(engine.index, name),
                              getattr(ref.index, name)), name
    assert engine.index.version == ref.index.version
    if "--ttl" in flags:
        assert stats["lifecycle"]["expired"] > 0
    else:
        assert stats["refreshes"] == 1 and stats["lifecycle"]["repairs"] > 0
