"""Descent plans: placement × batching × scorer (torch port of the single ×
wave corner of ``repro.query.plan``).

A :class:`PlanSpec` names the three serving axes of the reference. This
slice runs placement ``1`` (one device) × batching ``"wave"`` with scorer
``"jnp"`` (the plain unfused hop) or ``"pallas"`` (the fused CUDA hop; the
name is the reference's, so specs and CLI flags carry over). Both scorers
give bitwise-identical ids and sims. The other corners raise
NotImplementedError naming the ROADMAP item that ports them.

A :class:`DescentPlan` owns its device state — the index tables uploaded
once to the plan's device — and serves closed waves:
``step(queue, done)`` pops up to ``max_wave`` requests, routes them on the
host, runs one batched descent on the device, and stamps the results.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.query.index import KNNIndex
from repro_torch.query.router import fingerprint_profiles, profiles_to_csr, route
from repro_torch.query.search import batched_descent
from repro_torch.sketch.goldfinger import words_tensor

BATCHINGS = ("wave", "continuous")
SCORERS = ("jnp", "pallas", "pallas_dma")

_NOT_PORTED = {
    "placement": "sharded placement is ROADMAP queue 1 item 5",
    "continuous": "continuous batching is ROADMAP queue 1 item 4",
    "pallas_dma": "the DMA hop (scorer 'pallas_dma') is ROADMAP queue 2 "
                  "item 3",
}


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of a descent plan (hashable, validated)."""

    placement: int = 1          # shards (1 = single device)
    batching: str = "wave"      # "wave" | "continuous"
    scorer: str = "jnp"         # "jnp" | "pallas" | "pallas_dma"
    k: int = 10
    beam: int = 32
    hops: int = 3
    max_wave: int = 256         # wave batching: queries per descent
    seeds_per_config: int = 16

    def __post_init__(self):
        if self.placement < 1:
            raise ValueError(
                f"plan placement must be >= 1 shard, got {self.placement}")
        if self.batching not in BATCHINGS:
            raise ValueError(f"unknown batching {self.batching!r}; "
                             f"supported: {BATCHINGS}")
        if self.scorer not in SCORERS:
            raise ValueError(
                f"unknown scorer {self.scorer!r}; supported: {SCORERS}")
        if self.placement > 1:
            raise NotImplementedError(_NOT_PORTED["placement"])
        if self.batching == "continuous":
            raise NotImplementedError(_NOT_PORTED["continuous"])
        if self.scorer == "pallas_dma":
            raise NotImplementedError(_NOT_PORTED["pallas_dma"])
        if self.max_wave < 1:
            raise ValueError(f"wave plans need max_wave >= 1, "
                             f"got {self.max_wave}")
        if self.k < 1 or self.hops < 0:
            raise ValueError(f"invalid k={self.k} / hops={self.hops}")

    @property
    def kernel(self) -> bool:
        return self.scorer == "pallas"

    def describe(self) -> str:
        return f"single x wave x {self.scorer}"


class DescentPlan:
    """Single placement × wave batching, on one device."""

    def __init__(self, index: KNNIndex, spec: PlanSpec, device="cuda"):
        self.index = index
        self.spec = spec
        self.device = resolve_device(device)
        self.beam = max(spec.beam, spec.k)
        self._tables = None     # device copies of the index, built once
        # Candidate lanes the fused hop scored (real query rows only),
        # and how many (query, hop) pairs that covers.
        self.descent_stats = {"scored_lanes": 0, "hop_queries": 0}

    def describe(self) -> str:
        return self.spec.describe()

    def tables(self):
        """The index uploaded to the plan's device: (graph_ids, rev_ids,
        words bit-views, card, tombstone). The port's index is read-only
        (online mutation is a later slice), so one upload serves every
        wave."""
        if self._tables is None:
            ix, dev = self.index, self.device
            self._tables = (
                torch.from_numpy(ix.graph_ids).to(dev),
                torch.from_numpy(ix.rev_ids).to(dev),
                words_tensor(ix.words, dev),
                torch.from_numpy(ix.card).to(dev),
                torch.from_numpy(ix.tombstone).to(dev),
            )
        return self._tables

    # -- one closed wave -----------------------------------------------------

    def search(self, items, offsets, qgf, k: int):
        """Route + beam-descend already-fingerprinted query profiles."""
        seeds = route(self.index, items, offsets, self.spec.seeds_per_config)
        return self.descend_rows(qgf.words, qgf.card, seeds, k)

    def descend_rows(self, q_words, q_card, seeds, k: int):
        """Beam-descend from explicit seed rows; host arrays in and out."""
        hops = self.spec.hops
        dev = self.device
        graph_ids, rev_ids, words, card, tomb = self.tables()
        qn = len(q_card)
        ids, sims, scored = batched_descent(
            graph_ids, rev_ids, words, card, words_tensor(q_words, dev),
            torch.from_numpy(np.asarray(q_card, dtype=np.int32)).to(dev),
            torch.from_numpy(np.asarray(seeds, dtype=np.int32)).to(dev),
            k=k, beam=max(self.beam, k), hops=hops, kernel=self.spec.kernel,
            tomb=tomb)
        if self.spec.kernel:
            self.descent_stats["scored_lanes"] += int(scored.sum())
            self.descent_stats["hop_queries"] += qn * hops
        return ids.cpu().numpy(), sims.cpu().numpy()

    def query_batch(self, profiles, k: int | None = None):
        """Answer raw profiles: (ids int32[q, k], sims float32[q, k])."""
        items, offsets = profiles_to_csr(profiles)
        qgf = fingerprint_profiles(items, offsets, self.index.n_bits,
                                   self.index.fp_seed)
        return self.search(items, offsets, qgf, k or self.spec.k)

    # -- the serving loop ------------------------------------------------------

    def step(self, queue, done) -> int:
        """Close one wave from ``queue`` (a deque of requests), append the
        completed requests to ``done``; returns how many completed.
        """
        wave = []
        while queue and len(wave) < self.spec.max_wave:
            wave.append(queue.popleft())
        if not wave:
            return 0
        ids, sims = self.query_batch([r.profile for r in wave])
        now = time.perf_counter()
        for j, r in enumerate(wave):
            r.ids, r.sims = ids[j], sims[j]
            r.t_done = now
            r.status = "done"
            done.append(r)
        return len(wave)
