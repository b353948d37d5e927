"""Batched serving engine: request queue → prefill → batched decode, in
*wave* mode (static batching) or *continuous* mode (slot-based streaming
admission, ``ServeConfig.continuous``); torch port of
``repro.serve.engine``.

Wave mode groups up to ``max_batch`` left-padded prompts, runs one
prefill and one decode step per token, and streams tokens until
EOS/max_new; a row that finishes early keeps decoding as padding until
the whole wave closes.

Continuous mode runs a fixed array of ``slots`` decode rows through the
port's ``sched.SlotScheduler``: one decode tick advances every occupied
slot by one token with per-row cache positions (``models/layers.
apply_attn``'s per-row path); the moment a row emits EOS or exhausts its
budget, its slot is released, a queued request is prefilled alone, its
cache rows are copied into the shared decode cache (``_adopt_cache``)
and the slot rejoins the next tick. For dense and recurrent models both
modes compute every request alike, and give it the same tokens up to
rounding: on a GPU the libraries pick kernels by batch shape (a wave
prefills B rows, a slot one), so bf16 rounding may tip a near tie. For
MoE models they need not agree: the expert capacity comes from the token
count of each call (a wave's B × max_prompt prefill, a slot's 1 ×
max_prompt one, a decode step's rows), so the two modes can drop
different tokens.

The reference's jitted programs are plain calls here, under
``torch.inference_mode``. The engine serves ``model.serving_copy()``,
whose weights are cast once to the compute dtype (the values the
reference casts to on every call).

``Engine(model, sc, ctx=make_ctx(mesh))`` serves on a mesh, as the
reference's ``Engine(..., ctx=)``: every rank runs the engine on the same
requests (a whole model is cut to this rank's shards first), the caches
are sharded as ``cache_pspecs`` says, and each step's last logits are
gathered whole before the argmax, so every rank emits the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import LM, init_cache
from repro_torch.sched import SlotScheduler
from repro_torch.serve.steps import decode_step, prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32[prompt_len]
    max_new: int = 32
    eos_id: int = -1            # -1 → never stops early
    # Filled by the engine:
    output: Optional[np.ndarray] = None
    t_submit: float = 0.0
    t_done: float = 0.0

    @property
    def latency(self) -> Optional[float]:
        """Serve latency in seconds, or None until the request has both
        been submitted and completed."""
        if self.t_done == 0.0 or self.t_submit == 0.0:
            return None
        return self.t_done - self.t_submit


def _adopt_cache(cache: dict, fresh: dict, slot: int, ctx=None,
                 slots: int = 0) -> dict:
    """Copy a batch-1 prefill cache into row ``slot`` of the shared
    continuous decode cache, in place.

    Leaves: [n_groups, slots, ...] ← [n_groups, 1, ...]; the attention
    ``pos`` leaf has no batch axis in the prefill cache ([n_groups,
    alloc]) and gains one here. Every leaf of the row is overwritten, the
    recurrent states whole, so nothing of the slot's previous request
    survives. On a mesh a leaf split over the batch axes (``slots`` rows
    in all) holds the row on one batch rank only; ``pos`` is whole."""
    for name, sub in cache.items():
        for key, big in sub.items():
            small = fresh[name][key]
            row = slot
            if key == "pos":
                small = small[:, None, :]
            elif ctx is not None and big.shape[1] != slots:
                r0, n = ctx.row_range(slots)
                if not r0 <= slot < r0 + n:
                    continue
                row = slot - r0
            big[:, row:row + 1] = small
    return cache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_prompt: int = 128
    max_new: int = 64
    pad_id: int = 0
    continuous: bool = False   # slot-based streaming admission (sched/)
    slots: int = 0             # decode slots in continuous mode (0→max_batch)


class Engine:
    def __init__(self, model: LM, sc: ServeConfig, ctx=None):
        if ctx is not None and ctx.mesh is not None:
            if model.ctx is None:
                model = model.shard(ctx)
            elif model.ctx != ctx:
                raise ValueError("the model is sharded under another mesh")
        self.model = model.serving_copy()
        self.ctx = self.model.ctx
        self.cfg = model.cfg
        self.sc = sc
        self.device = model.device
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.n_decode_steps = 0   # decode calls (all modes)
        self.n_prefills = 0       # prefill calls

    def _prefill(self, toks: torch.Tensor):
        """(the last position's whole logits [B, V], cache)."""
        logits, cache = prefill_step(
            self.model, toks, s_alloc=self.sc.max_prompt + self.sc.max_new)
        return self.model.gather_logits(logits[:, -1], toks.shape[0]), cache

    def _decode(self, cache: dict, tok: torch.Tensor, cur_index):
        logits, cache = decode_step(self.model, cache, tok, cur_index)
        return self.model.gather_logits(logits[:, -1], tok.shape[0]), cache

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        if len(req.prompt) > self.sc.max_prompt:
            raise ValueError(f"prompt too long: {len(req.prompt)} tokens > "
                             f"max_prompt {self.sc.max_prompt}")
        self.queue.append(req)

    def _tokens(self, rows: list[np.ndarray]) -> torch.Tensor:
        """Prompts left-padded to ``max_prompt`` so the last position is
        real (pads are attended as tokens, at positions 0..S-1)."""
        S = self.sc.max_prompt
        toks = np.full((len(rows), S), self.sc.pad_id, dtype=np.int32)
        for j, p in enumerate(rows):
            toks[j, S - len(p):] = p
        return torch.from_numpy(toks).to(self.device)

    def _next_wave(self) -> list[Request]:
        wave = []
        while self.queue and len(wave) < self.sc.max_batch:
            wave.append(self.queue.popleft())
        return wave

    def _run_wave(self, wave: list[Request]) -> int:
        sc = self.sc
        S = sc.max_prompt
        logits, cache = self._prefill(self._tokens([r.prompt for r in wave]))
        self.n_prefills += 1
        tok = torch.argmax(logits[:, None], dim=-1).to(torch.int32)
        max_new = min(sc.max_new, max(r.max_new for r in wave))
        outs = [tok[:, 0].cpu().numpy()]
        # A row is done once it has emitted its eos_id or its own max_new
        # tokens; when every row is done the wave stops decoding.
        eos_ids = np.array([r.eos_id for r in wave], dtype=np.int64)
        max_per_row = np.array([r.max_new for r in wave], dtype=np.int64)
        row_done = ((outs[0] == eos_ids) & (eos_ids >= 0)) | (max_per_row <= 1)
        for i in range(max_new - 1):
            if row_done.all():
                break
            logits, cache = self._decode(cache, tok, S + i)
            self.n_decode_steps += 1
            tok = torch.argmax(logits[:, None], dim=-1).to(torch.int32)
            outs.append(tok[:, 0].cpu().numpy())
            row_done |= (outs[-1] == eos_ids) & (eos_ids >= 0)
            row_done |= max_per_row <= len(outs)
        gen = np.stack(outs, axis=1)  # [B, n_emitted]
        now = time.perf_counter()
        n_real = 0
        for j, r in enumerate(wave):
            seq = gen[j, : r.max_new]
            if r.eos_id >= 0:
                hits = np.flatnonzero(seq == r.eos_id)
                if len(hits):
                    seq = seq[: hits[0] + 1]
            r.output = seq
            r.t_done = now
            self.done.append(r)
            n_real += len(seq)
        # Delivered tokens, not decode-grid cells (rows already done keep
        # decoding as padding until the wave closes).
        return n_real

    # -- continuous (slot) serving -----------------------------------------

    def _continuous_cache(self, slots: int) -> dict:
        """A shared decode cache with PER-ROW positions: attention ``pos``
        leaves widen from [n_groups, alloc] to [n_groups, slots, alloc];
        the recurrent entries have no positions."""
        cache = init_cache(self.cfg, slots,
                           self.sc.max_prompt + self.sc.max_new, self.device,
                           self.ctx)
        for sub in cache.values():
            if "pos" not in sub:
                continue
            G, alloc = sub["pos"].shape
            sub["pos"] = sub["pos"][:, None, :].expand(
                G, slots, alloc).clone()
        return cache

    def _run_continuous(self) -> tuple[int, int]:
        """Slot-scheduled serving loop; returns (tokens, ticks)."""
        sc = self.sc
        slots = sc.slots or sc.max_batch
        sched = SlotScheduler(slots)
        cache = self._continuous_cache(slots)
        tok = np.zeros((slots, 1), np.int32)
        pos = np.zeros(slots, np.int32)       # next decode index per slot
        outs: list[list[int]] = [[] for _ in range(slots)]
        n_tokens = 0
        n_ticks = 0

        def emit(slot: int, token: int) -> bool:
            """Append one token; True when the slot's request is done."""
            r = sched.occupant(slot)
            outs[slot].append(token)
            budget = min(r.max_new, sc.max_new)
            return ((r.eos_id >= 0 and token == r.eos_id)
                    or len(outs[slot]) >= budget)

        def finish(slot: int):
            nonlocal n_tokens
            r = sched.release(slot)
            budget = max(0, min(r.max_new, sc.max_new))
            r.output = np.array(outs[slot][:budget], dtype=np.int32)
            r.t_done = time.perf_counter()
            n_tokens += len(outs[slot])
            outs[slot] = []
            self.done.append(r)

        while self.queue or sched.has_work():
            while self.queue:
                sched.submit(self.queue.popleft())
            # Admit until slots are full or the queue drains; a request
            # whose first (prefill) token already completes it frees its
            # slot for the next admission in the same tick.
            while True:
                admitted = sched.admit()
                if not admitted:
                    break
                for slot, r in admitted:
                    logits, c1 = self._prefill(self._tokens([r.prompt]))
                    self.n_prefills += 1
                    if self.ctx is None:
                        _adopt_cache(cache, c1, slot)
                    else:
                        _adopt_cache(cache, c1, slot, self.ctx, slots)
                    first = int(torch.argmax(logits[0]))
                    tok[slot, 0] = first
                    pos[slot] = sc.max_prompt
                    if emit(slot, first):
                        finish(slot)
            active = sched.active_mask()
            if not active.any():
                continue
            logits, cache = self._decode(
                cache, torch.from_numpy(tok).to(self.device),
                torch.from_numpy(pos).to(self.device))
            self.n_decode_steps += 1
            n_ticks += 1
            nxt = torch.argmax(logits, dim=-1).to(
                torch.int32).cpu().numpy()
            tok = nxt[:, None].copy()
            for slot in np.flatnonzero(active):
                pos[slot] += 1
                if emit(int(slot), int(nxt[slot])):
                    finish(int(slot))
        return n_tokens, n_ticks

    def run(self) -> dict:
        """Drain the queue; returns aggregate stats."""
        t0 = time.perf_counter()
        n_done0 = len(self.done)
        n_tokens = 0
        n_waves = 0
        with torch.inference_mode():
            if self.sc.continuous:
                n_tokens, n_waves = self._run_continuous()
            else:
                while self.queue:
                    n_tokens += self._run_wave(self._next_wave())
                    n_waves += 1
        dt = max(time.perf_counter() - t0, 1e-9)
        lats = [r.latency for r in self.done if r.latency is not None]
        return {
            "requests": len(self.done),
            "mode": "continuous" if self.sc.continuous else "wave",
            "waves": n_waves,
            "completed": len(self.done) - n_done0,
            "tokens": int(n_tokens),
            "tokens_per_s": n_tokens / dt,
            "decode_steps": self.n_decode_steps,
            "prefills": self.n_prefills,
            "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
            "p95_latency_s": float(np.percentile(lats, 95)) if lats else 0.0,
        }
