"""Per-shard health state machine: healthy → suspect → dead → recovering
(a copy of ``repro.faults.health``).

Pure host bookkeeping, advanced once per scheduler step by
``FailoverManager.observe`` with a boolean down-vector from the fault
injector (in a multi-process deployment the same vector would come from
RPC probe timeouts — the machine doesn't care where probes come from).

Transitions:

* **healthy → suspect** on the first failed probe. Suspect shards are
  immediately masked out of serving (their seeds are dropped, their
  merge lanes neutralized) — answering from survivors with bounded
  recall loss beats blocking on a shard that may never come back.
* **suspect → healthy** when a re-probe at a backoff boundary succeeds
  (transient failure cleared itself; no rebuild needed).
* **suspect → dead** after ``max_retries`` consecutive failed
  re-probes. Re-probes happen at capped exponential backoff — 1, 2, 4,
  … ``backoff_cap`` steps apart — so a flapping shard doesn't burn a
  probe per step, and the time-to-declare-dead is a deterministic
  function of the config.
* **dead → recovering** once the shard has been dead
  ``recover_after`` steps: the failover manager rebuilds the shard
  tables under a fresh partition and blue/green-swaps them in.
* **recovering → healthy** when the swap lands.

Everything is counted (probes, retries, backoff steps, deaths,
recoveries) so the serving stats line can report the degraded window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RECOVERING = "recovering"
STATES = (HEALTHY, SUSPECT, DEAD, RECOVERING)


@dataclass(frozen=True)
class HealthConfig:
    """Knobs of the health machine (all in scheduler steps)."""
    max_retries: int = 3   # consecutive failed re-probes before dead
    backoff_cap: int = 8   # max steps between suspect re-probes
    recover_after: int = 4 # steps a shard stays dead before rebuild


class FleetHealth:
    """Health state for ``n_shards`` shards, one observe() per step."""

    def __init__(self, n_shards: int, cfg: HealthConfig = None):
        self.n_shards = n_shards
        self.cfg = cfg or HealthConfig()
        self.state = [HEALTHY] * n_shards
        self.retries = np.zeros(n_shards, dtype=np.int64)
        self.backoff = np.ones(n_shards, dtype=np.int64)
        self.next_probe = np.zeros(n_shards, dtype=np.int64)
        self.dead_since = np.full(n_shards, -1, dtype=np.int64)
        self.step = -1
        self.n_probes = 0
        self.n_retries = 0
        self.backoff_steps = 0   # steps spent waiting between re-probes
        self.n_deaths = 0
        self.n_recoveries = 0

    def observe(self, down) -> None:
        """Advance one step with this step's probe outcomes."""
        down = np.asarray(down, dtype=bool)
        assert down.shape == (self.n_shards,), down.shape
        self.step += 1
        cfg = self.cfg
        for s in range(self.n_shards):
            st = self.state[s]
            if st in (DEAD, RECOVERING):
                continue  # only a failover swap moves these on
            if st == HEALTHY:
                self.n_probes += 1
                if down[s]:
                    self.state[s] = SUSPECT
                    self.retries[s] = 0
                    self.backoff[s] = 1
                    self.next_probe[s] = self.step + 1
                continue
            # SUSPECT: re-probe only at the backoff boundary.
            if self.step < self.next_probe[s]:
                self.backoff_steps += 1
                continue
            self.n_probes += 1
            self.n_retries += 1
            if not down[s]:
                self._reset(s)  # transient failure cleared itself
                continue
            self.retries[s] += 1
            if self.retries[s] >= cfg.max_retries:
                self.state[s] = DEAD
                self.dead_since[s] = self.step
                self.n_deaths += 1
            else:
                self.backoff[s] = min(2 * self.backoff[s], cfg.backoff_cap)
                self.next_probe[s] = self.step + self.backoff[s]

    def _reset(self, s: int) -> None:
        self.state[s] = HEALTHY
        self.retries[s] = 0
        self.backoff[s] = 1
        self.next_probe[s] = 0
        self.dead_since[s] = -1

    # -- queries -----------------------------------------------------------

    def serving_mask(self) -> np.ndarray:
        """bool[n_shards]: True where the shard must NOT serve
        (suspect, dead or mid-recovery)."""
        return np.array([st != HEALTHY for st in self.state], dtype=bool)

    def ready_for_recovery(self) -> list[int]:
        """Dead shards whose grace period elapsed — rebuild these now."""
        return [s for s in range(self.n_shards)
                if self.state[s] == DEAD
                and self.step - self.dead_since[s] >= self.cfg.recover_after]

    # -- failover transitions ----------------------------------------------

    def mark_recovering(self, s: int) -> None:
        assert self.state[s] == DEAD, self.state[s]
        self.state[s] = RECOVERING

    def mark_healthy(self, s: int) -> None:
        if self.state[s] == RECOVERING:
            self.n_recoveries += 1
        self._reset(s)

    def stats(self) -> dict:
        return {
            "states": list(self.state),
            "shards_down": int(self.serving_mask().sum()),
            "probes": self.n_probes,
            "retries": self.n_retries,
            "backoff_steps": self.backoff_steps,
            "deaths": self.n_deaths,
            "recoveries": self.n_recoveries,
        }
