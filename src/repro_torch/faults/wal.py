"""Crash consistency: snapshot + write-ahead journal replay (a copy of
``repro.faults.wal``, on the port's index and sharded plan).

The store's layout, manifest keys, snapshot ``.npz`` and JSON lines are
the reference's, so a store written by either package recovers in the
other.

The failure model is a process crash *between scheduler steps* (the
:class:`~repro_torch.faults.plan.FaultInjector`'s ``crash@T`` lands at the
step boundary, before any work of step T runs). Index
mutations are host-side and atomic with respect to that boundary, so
crash recovery reduces to: load the last snapshot, replay the journal
suffix. Two pieces make the replayed engine *bitwise*-equal — tensors
AND answers — to one that never crashed:

* **Record-before-apply** — every :class:`~repro_torch.query.index.KNNIndex`
  mutator writes its WAL record *before* touching state, and the crash
  only fires between steps, so the journal either contains a mutation
  in full or the mutation never happened. No torn writes to reason
  about.
* **Resolved arguments** — records carry the mutation's arguments
  RESOLVED, not as intents: ``refresh_cohort`` logs the concrete
  ``max_cluster`` it computed (the default depends on consolidation
  state, which differs between a freshly-loaded snapshot and the live
  index), and float sims round-trip exactly because float32 → Python
  float → JSON repr → float32 is lossless (the repr of a double that
  came from a float32 has enough digits to recover it bitwise).

What is deliberately NOT persisted: in-flight continuous slots and the
pending insert cohort. A crash loses requests that were in flight —
that is the documented contract (clients retry); what recovery
guarantees is that the *index* (and therefore every answer computed
after recovery) is bitwise-identical to the never-crashed engine's.

:class:`WriteAheadLog` is a JSON-lines file, one record per mutation,
flushed per record (the crash model is in-process — the injector raises
between steps — so a host ``fsync`` per record would buy durability
this model doesn't claim while costing real latency).
:class:`CrashStore` owns the snapshot cadence: each snapshot persists
the index (journals included — see ``KNNIndex.save``) plus a sidecar of
the sharded placement's frozen *base* plan, then starts a fresh WAL —
compaction is snapshotting, which bounds replay work by the cadence.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from repro_torch.sched import Cadence


def _jsonable(v):
    """Encode a record argument as JSON-representable, losslessly."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class WriteAheadLog:
    """Append-only JSON-lines journal of index mutations.

    Opening truncates: each snapshot starts a fresh journal.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "w")
        self.n_records = 0

    def record(self, op: str, **args):
        rec = {"op": op}
        rec.update({k: _jsonable(v) for k, v in args.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self.n_records += 1

    def close(self):
        if not self._fh.closed:
            self._fh.close()

    @staticmethod
    def read(path: str | Path) -> list[dict]:
        """All records of a journal file (missing file → empty journal:
        a crash can land before the first post-snapshot mutation)."""
        path = Path(path)
        if not path.exists():
            return []
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]


def _apply(index, rec: dict):
    """Replay ONE journal record onto ``index``.

    Arguments are coerced back to the exact dtypes the live mutators
    received — the mutators cast internally, but replay must not depend
    on that staying true.
    """
    op = rec["op"]
    if op == "append_user":
        index.append_user(
            np.asarray(rec["words_row"], dtype=np.uint32),
            int(rec["card_row"]),
            np.asarray(rec["nbr_ids"], dtype=np.int32),
            np.asarray(rec["nbr_sims"], dtype=np.float32))
    elif op == "remove_user":
        index.remove_user(int(rec["u"]))
    elif op == "swap_profile":
        index.swap_profile(int(rec["u"]),
                           np.asarray(rec["words_row"], dtype=np.uint32),
                           int(rec["card_row"]))
    elif op == "relink_user":
        index.relink_user(int(rec["u"]),
                          np.asarray(rec["nbr_ids"], dtype=np.int32),
                          np.asarray(rec["nbr_sims"], dtype=np.float32))
    elif op == "touch_row":
        index.touch_row(int(rec["u"]), int(rec["clock"]))
    elif op == "add_cluster_member":
        index.add_cluster_member(int(rec["ci"]), int(rec["user"]))
    elif op == "refresh_cohort":
        index.refresh_cohort(
            np.asarray(rec["items"], dtype=np.int32),
            np.asarray(rec["offsets"], dtype=np.int64),
            np.asarray(rec["user_ids"], dtype=np.int32),
            max_cluster=int(rec["max_cluster"]))
    else:
        raise ValueError(f"unknown WAL op {op!r}")


def replay(index, records) -> int:
    """Replay a journal suffix onto a snapshot-loaded index; returns the
    record count. The index must have NO WAL attached (replaying into a
    live journal would duplicate every record)."""
    assert index._wal is None, "detach the WAL before replaying into it"
    n = 0
    for rec in records:
        _apply(index, rec)
        n += 1
    return n


def _save_plan_sidecar(path: Path, plan):
    res = ([np.asarray(r, dtype=np.int64) for r in plan.residents]
           or [np.zeros(0, dtype=np.int64)])
    offsets = np.zeros(len(plan.residents) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in plan.residents], out=offsets[1:])
    np.savez(path,
             n_shards=np.int64(plan.n_shards),
             cluster_shard=np.asarray(plan.cluster_shard, dtype=np.int64),
             residents=np.concatenate(res),
             resident_offsets=offsets,
             owner=np.asarray(plan.owner, dtype=np.int64),
             imbalance=np.float64(plan.imbalance),
             version=np.int64(plan.version),
             resident_configs=np.int64(plan.resident_configs))


def _load_plan_sidecar(path: Path):
    from repro_torch.query.sharded import ShardPlan
    z = np.load(path)
    offsets = z["resident_offsets"]
    flat = z["residents"]
    residents = [flat[offsets[s]:offsets[s + 1]]
                 for s in range(int(z["n_shards"]))]
    return ShardPlan(n_shards=int(z["n_shards"]),
                     cluster_shard=z["cluster_shard"],
                     residents=residents,
                     owner=z["owner"],
                     imbalance=float(z["imbalance"]),
                     version=int(z["version"]),
                     resident_configs=int(z["resident_configs"]))


class CrashStore:
    """Periodic snapshots + the live WAL, rooted at one directory.

    ``every`` is the snapshot cadence in scheduler steps (0 = snapshot
    only at attach; the WAL then grows unboundedly — fine for tests,
    not for serving). A snapshot also fires whenever the sharded
    placement's generation moved (failover / re-balance swapped the
    base plan — the sidecar must track it, or recovery would restore a
    pre-swap partition and extend it divergently).

    Layout under ``root``::

        manifest.json         -> {snapshot, wal, plan, ...}   (atomic)
        snap_000000.npz       -> KNNIndex.save (journals included)
        snap_000000.plan.npz  -> frozen base ShardPlan (sharded only)
        wal_000000.jsonl      -> mutations since snap_000000
    """

    def __init__(self, root: str | Path, every: int = 0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.cadence = Cadence(every)
        self.every = every
        self.n_snapshots = 0
        self.wal: WriteAheadLog | None = None
        self._last_generation = -1

    # -- live side ---------------------------------------------------------

    def attach(self, engine):
        """Take the initial snapshot and start journaling ``engine``'s
        index. Called by ``QueryEngine.__init__`` / ``recover``."""
        self.snapshot(engine)

    def snapshot(self, engine):
        """Persist index + base plan, then start a fresh WAL (this IS
        journal compaction: replay work is bounded by the cadence)."""
        ix = engine.index
        ix.detach_wal()
        if self.wal is not None:
            self.wal.close()
        n = self.n_snapshots
        snap = f"snap_{n:06d}.npz"
        ix.save(self.root / snap)
        manifest = {
            "snapshot": snap,
            "wal": f"wal_{n:06d}.jsonl",
            "plan": None,
            "shards": engine.qc.shards,
            "lifecycle_clock": int(engine.lifecycle.clock),
            "n_snapshots": n + 1,
        }
        sd = engine.plan.sharded_state(build=False)
        if sd is not None:
            plan_name = f"snap_{n:06d}.plan.npz"
            _save_plan_sidecar(self.root / plan_name, sd.base_plan)
            manifest["plan"] = plan_name
            self._last_generation = sd.generation
        tmp = self.root / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=2))
        tmp.rename(self.root / "manifest.json")  # atomic publish
        self.wal = WriteAheadLog(self.root / manifest["wal"])
        ix.attach_wal(self.wal)
        self.n_snapshots = n + 1

    def maintain(self, engine):
        """Between-steps tick: snapshot on cadence, or immediately when
        the sharded generation moved (plan swap → sidecar is stale)."""
        sd = engine.plan.sharded_state(build=False)
        swapped = sd is not None and sd.generation != self._last_generation
        if self.cadence.tick() or swapped:
            self.snapshot(engine)

    def stats(self) -> dict:
        return {
            "every": self.every,
            "snapshots": self.n_snapshots,
            "wal_records": self.wal.n_records if self.wal else 0,
        }

    # -- recovery side -----------------------------------------------------

    @staticmethod
    def load(root: str | Path):
        """Recover ``(index, base_plan | None, manifest)`` from ``root``:
        load the last published snapshot, replay its WAL suffix."""
        from repro_torch.query.index import KNNIndex
        root = Path(root)
        manifest = json.loads((root / "manifest.json").read_text())
        index = KNNIndex.load(root / manifest["snapshot"])
        replay(index, WriteAheadLog.read(root / manifest["wal"]))
        base_plan = None
        if manifest.get("plan"):
            base_plan = _load_plan_sidecar(root / manifest["plan"])
        return index, base_plan, manifest
