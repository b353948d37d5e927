"""The port's delta reshard held bitwise against the JAX reference's
sharded state.

* An insert burst across a cohort refresh under a 3-shard wave engine:
  the ``sync()`` sequence, the device tables and ``g2l`` equal to the
  reference's after every insert, then deletes and an update, and equal
  to a from-scratch rematerialisation under ``extend_plan``.
* Inserts between the ticks of a sharded continuous serve, with shards
  rematerialised while slots are in flight (the in-flight beam remap),
  against the reference tick by tick.
* TTL expiry and a delete, an update and an insert between the ticks of
  a sharded continuous serve; no request is served an id dead when it
  was served.

Fixtures and helpers are ``test_torch_sharded.py``'s. The stated
tolerance is exact equality of ids, sims and tables.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.query.engine import QueryRequest as RQueryRequest  # noqa: E402
from repro_torch.query import sharded  # noqa: E402
from repro_torch.query.engine import QueryRequest  # noqa: E402
from test_torch_sharded import (BEAM, HOPS, K, SCORERS, TABLES,  # noqa: E402,F401
                                _assert_same, _by_rid, _engines,
                                _pallas_interpret, _run_by_step, _submit,
                                _watch_tombstones, artifact, inserts,
                                profiles)


def _assert_tables(sd, r_sd):
    assert sd.cap == r_sd.cap and sd.version == r_sd.version
    np.testing.assert_array_equal(sd._g2l, r_sd._g2l)
    for a, b, name in zip(sd._dev, r_sd._dev, TABLES):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a.numpy(), b.view(np.int32) if name == "l_words" else b,
            err_msg=name)
    for a, b in zip(sd.plan.residents, r_sd.plan.residents):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sd.plan.owner, r_sd.plan.owner)


def test_delta_reshard_matches_reference_and_rebuild(artifact, profiles,
                                                     inserts):
    """70 inserts under a 3-shard wave engine (a cohort refresh at 64, so
    pre-existing users gain residency: a stale shard), syncing after each:
    the sync() results, tables and g2l equal the reference's at every
    step, and a from-scratch rematerialisation under extend_plan at the
    end; deletes and an update follow through the delta path."""
    port, ref = _engines(artifact, k=K, shards=3, refresh_every=64)
    port.query_batch(profiles[:8])  # freeze the base plan
    ref.query_batch(profiles[:8])
    sd, r_sd = port.sharded_state(), ref.sharded_state()
    kinds, r_kinds, remapped = [], [], False
    for p in inserts[:70]:
        port.insert(p)
        ref.insert(p)
        kinds.append(sd.sync())
        r_kinds.append(r_sd.sync())
        remapped |= sd._beam_remap is not None
        _assert_tables(sd, r_sd)
    assert kinds == r_kinds and "delta" in kinds
    assert port.n_refreshes == 1 and remapped
    for u in (3, 17, 250):
        port.remove_user(u)
        ref.remove_user(u)
    port.update_user(40, profiles[0])
    ref.update_user(40, profiles[0])
    assert sd.sync() == r_sd.sync() == "delta"
    _assert_tables(sd, r_sd)
    fresh = sharded.ShardedDescent(
        port.index, 3, plan=sharded.extend_plan(sd.base_plan, port.index),
        device="cpu")
    assert fresh.version == sd.version
    np.testing.assert_array_equal(fresh._g2l, sd._g2l)
    for a, b in zip(fresh._dev, sd._dev):
        assert torch.equal(a, b)
    assert port.plan._single is None  # no full-index device copy
    ids, sims = port.query_batch([inserts[0]])
    r_ids, r_sims = ref.query_batch([inserts[0]])
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    np.testing.assert_array_equal(sims, np.asarray(r_sims))


@pytest.mark.parametrize("scorer", ["jnp", "pallas_dma"])
def test_inserts_under_sharded_continuous_match_reference(artifact, profiles,
                                                          inserts, scorer):
    """An insert before each of the first 16 continuous ticks of a
    3-shard plan, cohort refreshes every 4 while slots are in flight, some
    of which rematerialise a shard and remap in-flight local ids: the same
    requests
    complete at each tick with the same ids and sims as the reference's,
    and the shard state ends equal."""
    port, ref = _engines(artifact, k=K, beam=BEAM, hops=HOPS,
                         continuous=True, slots=5, shards=3, refresh_every=4,
                         **SCORERS[scorer])

    def insert_some(engine, tick):
        if engine.n_inserted < 16:
            engine.insert(inserts[engine.n_inserted])

    remaps = []
    take = sharded.ShardedDescent.take_beam_remap

    def counting_take(self):
        mp = take(self)
        remaps.append(mp is not None)
        return mp

    _submit(port, QueryRequest, profiles)
    _submit(ref, RQueryRequest, profiles)
    sharded.ShardedDescent.take_beam_remap = counting_take
    try:
        steps = _run_by_step(port, insert_some)
    finally:
        sharded.ShardedDescent.take_beam_remap = take
    assert steps == _run_by_step(ref, insert_some)
    assert port.n_refreshes == ref.n_refreshes >= 1 and any(remaps)
    _assert_same(_by_rid(port), _by_rid(ref))
    _assert_tables(port.sharded_state(), ref.sharded_state())


def _mid_flight(engine, tick):
    """Between sharded continuous ticks: delete the global id at the head
    of the first active slot's beam on shard 0, then update a user, then
    insert one (either package's engine)."""
    ix = engine.index
    profile = np.arange(ix.n % 7, 60, 3, dtype=np.int32)
    if tick == 1:
        st = engine.plan._slots
        slot = int(np.flatnonzero(st.sched.active_mask())[0])
        local = int(np.asarray(st.beam_ids)[0, slot, 0])
        l2g = np.asarray(engine.sharded_state()._dev[4])
        engine.remove_user(int(l2g[0, local]))
    elif tick == 2:
        engine.update_user(int(ix.alive_ids()[11]), profile)
    elif tick == 3:
        engine.insert(profile)


def test_ttl_and_mid_serve_mutations_match_reference(artifact, profiles):
    """TTL expiry (from the eighth tick on) and a delete, an update and an
    insert between the ticks of a 2-shard continuous serve through the
    DMA hop (the repair cadence is the CLI test's): the requests each
    tick completes, their ids and sims, the lifecycle counters and the
    shard tables are the reference's; no request is served an id dead
    when it was served."""
    port, ref = _engines(artifact, k=K, beam=BEAM, hops=HOPS,
                         continuous=True, slots=9, shards=2, ttl=7,
                         **SCORERS["pallas_dma"])
    _watch_tombstones(port)
    _submit(port, QueryRequest, profiles[:20])
    _submit(ref, RQueryRequest, profiles[:20])
    assert _run_by_step(port, _mid_flight) == _run_by_step(ref, _mid_flight)
    lc = port.lifecycle.stats()
    assert lc == ref.lifecycle.stats()
    assert lc["expired"] > 0 and lc["removed"] >= 1 and lc["updated"] == 1
    _assert_same(_by_rid(port), _by_rid(ref))
    _assert_tables(port.sharded_state(), ref.sharded_state())
