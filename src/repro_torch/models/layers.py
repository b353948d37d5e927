"""Decoder blocks: RMSNorm, RoPE, GQA/MQA attention (chunked online
softmax, one-token decode over a ring cache, sliding window), the gated /
plain MLPs, the sort-based capacity MoE, RG-LRU (RecurrentGemma) and
mLSTM / sLSTM (xLSTM) (torch port of ``repro.models.layers``).

Pure-function style, as the reference: ``init_*`` builds a dict of
tensors from a ``torch.Generator``, ``apply_*`` consumes a mapping of
tensors (a dict or the ``nn.ParameterDict`` of ``models/model.py``).
Compute dtype is ``cfg.dtype`` (bf16 by default); norms,
softmax and the products the reference accumulates into f32
(``preferred_element_type=jnp.float32``) run in f32: their bf16 operands
are upcast, which keeps every product exact, and the result stays f32.
The other products (q/k/v, ``wo``, the MLP) return ``cfg.dtype`` as the
reference's do. Masked scores are -1e30, not -inf, as in the reference.

Every ``apply_*`` takes the reference's ``ShardCtx`` as ``ctx``; None
(or a ctx without a mesh) is the one-device path. On a mesh
(``launch.mesh.Mesh``, one process a rank) a block gets its parameters
already gathered over the data axes (FSDP, ``models/model.py``) and still
sharded on "model" as ``models/sharding.py`` says; the activations hold
this rank's batch rows, whole over "model". Where the reference fixes a
layout with ``ctx.csp``, the port makes it real with collectives: heads,
``d_ff``, the RG-LRU width and the experts are split on "model" when the
axis divides them (column-parallel in, each rank's partial product
all-reduced over "model" out: the reference's ``"tp_out"``), and a block
whose dims do not divide runs whole on every model rank. The autograd
form is Megatron's: ``enter_tp`` is the identity forward and an
all-reduce of the gradient over "model", ``psum_model`` the converse.

Decode updates the cache tensors it is given IN PLACE (the reference
returns a new cache); callers that want to keep a cache clone it first.
Three parameters are read in f32 and unrounded, as the reference reads
them: the MoE ``router``, RG-LRU's ``lam`` and sLSTM's ``r_z``
(``F32_PARAMS``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.knn.topk import topk_desc
from repro_torch.models.config import ModelConfig

Params = Mapping[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MASKED = -1e30  # the reference's mask value and online-softmax start
# Parameters every block reads in f32, never rounded to the compute dtype.
F32_PARAMS = ("router", "lam", "r_z")


class _Gather(torch.autograd.Function):
    """All-gather over mesh axes; the backward sums the gradient over
    them and keeps this rank's shard (``reduce``: the ranks hold different
    rows, as the batch axes do) or only keeps the shard (the ranks ran the
    same computation on the whole tensor)."""

    @staticmethod
    def forward(fctx, t, mesh, axes, dim, reduce):
        fctx.args = (mesh, axes, dim, reduce)
        return mesh.all_gather(t, axes, dim)

    @staticmethod
    def backward(fctx, g):
        mesh, axes, dim, reduce = fctx.args
        if reduce:
            g = mesh.reduce_scatter(g, axes, dim)
        else:
            n = g.shape[dim] // mesh.count(axes)
            g = g.narrow(dim, mesh.index(axes) * n, n).contiguous()
        return g, None, None, None, None


class _Psum(torch.autograd.Function):
    """All-reduce (sum) over mesh axes forward, identity backward."""

    @staticmethod
    def forward(fctx, t, mesh, axes):
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _EnterTp(torch.autograd.Function):
    """Identity forward, gradient all-reduced over mesh axes backward."""

    @staticmethod
    def forward(fctx, t, mesh, axes):
        fctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(fctx, g):
        mesh, axes = fctx.args
        return mesh.all_reduce(g, axes), None, None


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Optional mesh context; None mesh → the one-device path.

    ``rows_local`` says whether the activations hold this rank's rows of
    the batch (the batch divides over the batch axes) or all of them
    (it does not: every batch rank computes every row, as the
    reference's ``cache_pspecs`` replicate such a batch)."""

    mesh: Any = None
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    rows_local: bool = True

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(self.model_axis)

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.index(self.model_axis)

    @property
    def n_batch(self) -> int:
        return 1 if self.mesh is None else self.mesh.count(self.batch_axes)

    def splits(self, n: int) -> bool:
        """True where the model axis divides ``n`` (on a mesh)."""
        return self.mesh is not None and n % self.model_size == 0

    def for_batch(self, batch: int) -> "ShardCtx":
        """This ctx for a global batch of ``batch`` rows."""
        return dataclasses.replace(self,
                                   rows_local=batch % self.n_batch == 0)

    def row_range(self, batch: int) -> tuple:
        """(first row, rows) of this rank in a global batch."""
        if self.mesh is None or batch % self.n_batch:
            return 0, batch
        n = batch // self.n_batch
        return self.mesh.index(self.batch_axes) * n, n

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global tensor (dim 0)."""
        r0, n = self.row_range(t.shape[0])
        return t if n == t.shape[0] else t[r0:r0 + n]

    # -- collectives (autograd-aware) --------------------------------------

    def gather(self, t, axes, dim: int, reduce: bool = True):
        return _Gather.apply(t, self.mesh, axes, dim, reduce)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """All rows from this rank's rows (identity when not split)."""
        if not self.rows_local:
            return t
        if t.is_floating_point():
            return self.gather(t, self.batch_axes, 0)
        return self.mesh.all_gather(t, self.batch_axes, 0)

    def fsdp(self, t: torch.Tensor, spec) -> torch.Tensor:
        """A parameter gathered over every axis but "model" that its spec
        shards (the data axis), its gradient summed back over them. A
        gather over one rank is the shard itself: no copy."""
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            axes = tuple(a for a in axes if a != self.model_axis)
            if axes and self.mesh.count(axes) > 1:
                t = self.gather(t, axes, d)
        return t

    def whole(self, t: torch.Tensor, full_shape) -> torch.Tensor:
        """A parameter gathered over "model" on every dim it is split on,
        for a block every model rank computes whole."""
        for d, n in enumerate(full_shape):
            if t.shape[d] != n:
                t = self.gather(t, self.model_axis, d, reduce=False)
        return t

    def enter_tp(self, t: torch.Tensor) -> torch.Tensor:
        return _EnterTp.apply(t, self.mesh, self.model_axis)

    def psum_model(self, t: torch.Tensor) -> torch.Tensor:
        return _Psum.apply(t, self.mesh, self.model_axis)


def _on(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def param_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """Normal(0, 1/in_axis_size) weights, drawn in f32 on ``device``."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ---------------------------------------------------------------- norms

def init_rmsnorm(cfg, device=None) -> dict:
    return {"scale": torch.ones(cfg.d_model, dtype=param_dtype(cfg),
                                device=device)}


def apply_rmsnorm(p: Params, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [B, S, H, hd], positions int[B, S] → rotated x (split-half),
    computed in f32 and returned in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, :, None, None].float() * freqs  # [B, S, 1, half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def init_attn(gen: torch.Generator, cfg, device=None) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    pd = param_dtype(cfg)
    return {
        "wq": dense_init(gen, (D, H, hd), D, pd, device),
        "wk": dense_init(gen, (D, KV, hd), D, pd, device),
        "wv": dense_init(gen, (D, KV, hd), D, pd, device),
        "wo": dense_init(gen, (H, hd, D), H * hd, pd, device),
    }


def _project(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """x [B, S, D] · w [D, *out] → [B, S, *out] in ``dt`` (the reference's
    ``einsum("bsd,dhk->bshk")`` without an f32 result)."""
    D = w.shape[0]
    return (x @ w.to(dt).reshape(D, -1)).reshape(*x.shape[:2], *w.shape[1:])


def _online_softmax_attn(q, k, v, qpos, kpos, window: int,
                         chunk_q: int, chunk_kv: int) -> torch.Tensor:
    """Chunked causal attention with online softmax (flash-style), the
    reference's blocking and arithmetic in plain torch.

    q, k, v [B, S, H, hd] (kv heads already broadcast to H); qpos [B, S];
    kpos [B, Skv] (-1 = empty slot). Returns f32 [B, S, H, hd]. Never
    materialises the full score matrix: the peak intermediate is
    [B, cq, H, ck].
    """
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    cq = min(chunk_q, S)
    ck = min(chunk_kv, Skv)
    if S % cq or Skv % ck:
        raise ValueError(
            f"sequence {S} (kv {Skv}) is not a multiple of its chunk "
            f"{cq} ({ck}): prompts longer than {chunk_q} must be "
            f"multiples of {chunk_q}")
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(B, S, H, hd, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, cq):
        qb = q[:, q0:q0 + cq].float()
        qpb = qpos[:, q0:q0 + cq]
        m = torch.full((B, cq, H), MASKED, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, cq, H), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, H, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, ck):
            kb, vb = k[:, k0:k0 + ck], v[:, k0:k0 + ck]
            kpb = kpos[:, k0:k0 + ck]
            s = torch.einsum("bqhd,bkhd->bqhk", qb, kb.float()) * scale
            mask = ((kpb[:, None, :] <= qpb[:, :, None])
                    & (kpb[:, None, :] >= 0))
            if window:
                mask &= kpb[:, None, :] > qpb[:, :, None] - window
            s = torch.where(mask[:, :, None, :], s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, q0:q0 + cq] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _build_cache(k, v, positions, alloc: int) -> dict:
    """Pack prefill k/v into a (ring) cache of ``alloc`` slots.

    Slot assignment is pos % alloc so subsequent decode steps extend it
    seamlessly (full cache: identity; sliding window: ring buffer)."""
    B, S, KV, hd = k.shape
    take = min(S, alloc)
    pt = positions[0, -take:].to(torch.int32)
    slots = (pt % alloc).long()
    ck = torch.zeros((B, alloc, KV, hd), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, alloc, KV, hd), dtype=v.dtype, device=v.device)
    ck[:, slots] = k[:, -take:]
    cv[:, slots] = v[:, -take:]
    cpos = torch.full((alloc,), -1, dtype=torch.int32, device=k.device)
    cpos[slots] = pt
    return {"k": ck, "v": cv, "pos": cpos}


def apply_attn(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               window: int = 0,
               cache: Optional[dict] = None,
               cur_index=None,
               positions: Optional[torch.Tensor] = None,
               want_cache: bool = False,
               s_alloc: int = 0,
               chunk_q: int = 512, chunk_kv: int = 1024,
               ctx: Optional[ShardCtx] = None):
    """GQA attention; returns (y [B, S, D], cache or None).

    Train/prefill when ``cache`` is None (``want_cache`` also returns a
    cache of ``s_alloc`` slots, ring-buffered to ``window`` for local
    attention). Otherwise one-token decode (S == 1) against ``cache``
    {"k", "v", "pos"}, written in place at ``cur_index``: a scalar with
    ``pos`` int32[S_alloc], or per row (continuous batching) with
    ``cur_index`` int[B] and ``pos`` int32[B, S_alloc], so every row masks
    by its own timeline.

    On a mesh the heads split on "model" when it divides them, and so do
    the kv heads and the cache's; kv heads that do not divide are
    computed whole on every model rank (``wk``/``wv`` gathered over
    "model" if their head dim was split) and cached whole, and each rank
    reads the ones its heads map to. Per-row ``pos`` is whole over the
    batch (``cache_pspecs``), ``cur_index`` global."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = compute_dtype(cfg)
    on = _on(ctx)
    par = on and ctx.splits(H)       # heads split on "model"
    kvp = on and ctx.splits(KV)      # kv heads (and the cache's) too
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    xi = ctx.enter_tp(x) if par else x

    q = rope(_project(xi, p["wq"], dt), positions, cfg.rope_theta)
    H_l = q.shape[2]                 # this rank's heads
    kv_idx = None
    if on and not kvp:
        # Whole kv heads on every model rank (the reference's replicated
        # k), then this rank's heads' kv heads.
        wk = ctx.whole(p["wk"], (D, KV, hd))
        wv = ctx.whole(p["wv"], (D, KV, hd))
        k = rope(_project(x, wk, dt), positions, cfg.rope_theta)
        v = _project(x, wv, dt)
        if par:
            k, v = ctx.enter_tp(k), ctx.enter_tp(v)
        kv_idx = ((ctx.model_rank * H_l if par else 0)
                  + torch.arange(H_l, device=x.device)) // (H // KV)
    else:
        k = rope(_project(xi, p["wk"], dt), positions, cfg.rope_theta)
        v = _project(xi, p["wv"], dt)

    if cache is None:
        if kv_idx is not None:
            k_rep, v_rep = k[:, :, kv_idx], v[:, :, kv_idx]
        else:
            G = H_l // k.shape[2]
            k_rep = k.repeat_interleave(G, dim=2) if G > 1 else k
            v_rep = v.repeat_interleave(G, dim=2) if G > 1 else v
        out = _online_softmax_attn(q, k_rep, v_rep, positions, positions,
                                   window, chunk_q, chunk_kv)
        new_cache = None
        if want_cache:
            alloc = min(s_alloc or S, window) if window else (s_alloc or S)
            new_cache = _build_cache(k, v, positions, alloc)
    else:
        S_alloc = cache["k"].shape[1]
        ck_, cv_, cpos = cache["k"], cache["v"], cache["pos"]
        if cpos.dim() == 2:
            ci = cur_index.to(x.device, torch.int32)
            r0 = ctx.row_range(ci.shape[0])[0] if on else 0
            slot = (ci % S_alloc).long()
            rows = torch.arange(B, device=x.device)
            ck_[rows, slot[r0:r0 + B]] = k[:, 0]
            cv_[rows, slot[r0:r0 + B]] = v[:, 0]
            cpos[torch.arange(ci.shape[0], device=x.device), slot] = ci
            kp = cpos[r0:r0 + B, None, :]
        else:
            slot = int(cur_index) % S_alloc
            ck_[:, slot:slot + 1] = k
            cv_[:, slot:slot + 1] = v
            # fill_, not item assignment: a Python scalar assigned to a CUDA
            # tensor goes through a host-to-device copy that waits for the
            # stream, once per layer per step.
            cpos[slot:slot + 1].fill_(int(cur_index))
            kp = cpos[None, None, :]
        new_cache = cache
        if kv_idx is not None:
            ck_, cv_ = ck_[:, :, kv_idx], cv_[:, :, kv_idx]
        KV_u = ck_.shape[2]
        qg = q.reshape(B, 1, KV_u, H_l // KV_u, hd).float()
        s = (torch.einsum("bqhgd,bkhd->bqhgk", qg, ck_.float())
             * (1.0 / math.sqrt(hd)))
        qp = positions[:, :, None]
        mask = (kp <= qp) & (kp >= 0)
        if window:
            mask = mask & (kp > qp - window)
        s = torch.where(mask[:, :, None, None, :], s, MASKED)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgk,bkhd->bqhgd", w.to(dt).float(),
                           cv_.float())

    out = out.reshape(B, -1, H_l * hd).to(dt)
    y = out @ p["wo"].to(dt).reshape(H_l * hd, D)
    if par:
        y = ctx.psum_model(y)
    return y, new_cache


def init_attn_cache(cfg, batch: int, s_alloc: int, window: int,
                    device=None) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    alloc = min(s_alloc, window) if window else s_alloc
    dt = compute_dtype(cfg)
    return {
        "k": torch.zeros((batch, alloc, KV, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, alloc, KV, hd), dtype=dt, device=device),
        "pos": torch.full((alloc,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------- MLP

MLP_TYPES = ("swiglu", "geglu", "gelu")


def init_mlp(gen: torch.Generator, cfg, device=None) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    pd = param_dtype(cfg)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (D, F_), D, pd, device),
            "w_up": dense_init(gen, (D, F_), D, pd, device),
            "w_down": dense_init(gen, (F_, D), F_, pd, device),
        }
    return {
        "w_up": dense_init(gen, (D, F_), D, pd, device),
        "w_down": dense_init(gen, (F_, D), F_, pd, device),
    }


def apply_mlp(p: Params, x: torch.Tensor, cfg,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """SwiGLU, GeGLU or plain GELU MLP. GELU is the tanh approximation,
    as ``jax.nn.gelu``'s default. On a mesh ``d_ff`` splits on "model"
    when it divides."""
    dt = compute_dtype(cfg)
    par = _on(ctx) and ctx.splits(cfg.d_ff)
    if par:
        x = ctx.enter_tp(x)
    up = x @ p["w_up"].to(dt)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh") * up
    elif cfg.mlp_type == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {cfg.mlp_type!r}; "
                         f"supported: {MLP_TYPES}")
    y = h @ p["w_down"].to(dt)
    return ctx.psum_model(y) if par else y


# ---------------------------------------------------------------- MoE

def init_moe(gen: torch.Generator, cfg, device=None) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd = param_dtype(cfg)
    return {
        "router": dense_init(gen, (D, E), D, pd, device),
        "w_gate": dense_init(gen, (E, D, F_), D, pd, device),
        "w_up": dense_init(gen, (E, D, F_), D, pd, device),
        "w_down": dense_init(gen, (E, F_, D), F_, pd, device),
    }


def moe_capacity(n_tokens: int, cfg) -> int:
    """Rows each expert computes in a call over ``n_tokens`` tokens, pads
    included: ceil(n·k·cf / E), at least 8, rounded up to a multiple of
    8. It depends on the batch a token is served in."""
    c = math.ceil(n_tokens * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def moe_route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Router of ``xt`` [T, D]: logits f32 [T, E] from the activations
    upcast and the f32 router, softmax, the top k (ties to the lowest
    expert, as ``lax.top_k``) and their weights renormalised by
    max(sum, 1e-9). Returns (logits, gate_w f32 [T, k], gate_e [T, k])."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = topk_desc(probs, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, gate_w, gate_e


def _moe_slots(gate_e: torch.Tensor, capacity: int, n_experts: int,
               e0: int = 0):
    """The reference's capacity buckets for experts [e0, e0 + n_experts):
    the flat expert ids sorted stably, each entry's position in its
    expert's run from a left searchsorted, slot (e - e0)·C + position,
    or the trash slot n_experts·C past capacity or outside the range.
    Returns (order, slot in sorted order, valid in sorted order)."""
    T, k = gate_e.shape
    flat_e = gate_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    run_start = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=gate_e.device) - run_start
    local_e = se - e0
    valid = (local_e >= 0) & (local_e < n_experts) & (pos < capacity)
    slot = torch.where(valid, local_e * capacity + pos,
                       n_experts * capacity)
    return order, slot, valid


def moe_kept(gate_e: torch.Tensor, capacity: int,
             n_experts: int) -> torch.Tensor:
    """bool [T, k]: True where a token's expert choice got a capacity
    slot, False where it was dropped."""
    order, _, valid = _moe_slots(gate_e, capacity, n_experts)
    kept = torch.empty_like(valid)
    kept[order] = valid
    return kept.reshape(gate_e.shape)


def _moe_bucketed(xt, gate_w, gate_e, wg, wu, wd, capacity: int, dt,
                  e0: int = 0):
    """Sort-based capacity-bucketed dispatch over experts [e0, e0 + E)
    (``wg``'s E; all of them from e0 = 0), the other experts' choices
    left to the ranks that hold them: every
    expert computes its ``capacity`` rows [E, C, D] (empty rows are zero),
    each row's output is scaled by its gate weight rounded to ``dt``, and
    each token sums its kept choices in ascending expert id, in ``dt`` —
    the order of the reference's scatter-add, but per token, so the card
    gives the same sum on every run (no atomics)."""
    T, k = gate_e.shape
    E = wg.shape[0]
    order, slot, valid = _moe_slots(gate_e, capacity, E, e0)
    tok = order // k
    gw = gate_w.reshape(-1)[order]
    n_slots = E * capacity + 1  # the last one is the trash
    slot_tok = torch.zeros(n_slots, dtype=torch.long, device=xt.device)
    slot_tok[slot] = tok
    slot_gw = torch.zeros(n_slots, dtype=gw.dtype, device=xt.device)
    slot_gw[slot] = torch.where(valid, gw, 0.0)
    slot_live = torch.zeros(n_slots, dtype=torch.bool, device=xt.device)
    slot_live[slot] = valid

    xin = xt[slot_tok[:-1]] * slot_live[:-1, None].to(xt.dtype)
    xin = xin.reshape(E, capacity, -1)                   # [E, C, D]
    g = F.silu(torch.bmm(xin, wg.to(dt)))
    u = torch.bmm(xin, wu.to(dt))
    y = torch.bmm(g * u, wd.to(dt)).reshape(E * capacity, -1)
    y = y * slot_gw[:-1, None].to(y.dtype)
    y = torch.where(slot_live[:-1, None], y, 0.0).to(xt.dtype)
    y = torch.cat([y, y.new_zeros(1, y.shape[1])])       # trash → 0

    # Each (token, choice)'s slot, the choices in ascending expert id.
    tk_slot = torch.empty_like(slot)
    tk_slot[order] = slot
    by_e = torch.argsort(gate_e, dim=1)
    tk_slot = torch.gather(tk_slot.reshape(T, k), 1, by_e)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + y[tk_slot[:, j]]
    return out


def apply_moe(p: Params, x: torch.Tensor, cfg,
              ctx: Optional[ShardCtx] = None):
    """Top-k MoE; returns (y [B, S, D], (router logits f32 [B·S, E],
    gate_e [B·S, k])). The capacity comes from this call's
    B·S tokens, pads included, so which tokens are dropped depends on the
    batch (waves and continuous slots can give different tokens).

    On a mesh whose model axis divides the experts (the reference's
    ``shard_map`` branch), each rank buckets its own experts [e0, e0 +
    E/m) over the tokens of its batch shard, with the capacity from those
    tokens, and the per-token partial sums are all-reduced over "model".
    A batch that does not divide over the batch axes is on every rank
    whole; it is then cut as the reference's ``shard_map`` cuts the
    flattened tokens, into n_batch runs of B·S / n_batch, each bucketed
    alone. Otherwise (experts that do not divide) every rank buckets all
    B·S tokens, gathered over the batch axes, with the capacity from all
    of them, as the reference's GSPMD program does, and keeps its rows."""
    B, S, D = x.shape
    dt = compute_dtype(cfg)
    xt = x.reshape(B * S, D)
    logits, gate_w, gate_e = moe_route(xt, p["router"],
                                       cfg.experts_per_token)
    if not _on(ctx):
        out = _moe_bucketed(xt, gate_w, gate_e, p["w_gate"], p["w_up"],
                            p["w_down"], moe_capacity(B * S, cfg), dt)
    elif ctx.splits(cfg.n_experts):
        T = B * S
        runs = 1 if ctx.rows_local else ctx.n_batch
        if T % runs:
            raise ValueError(f"{T} tokens do not split over the "
                             f"{runs} batch shards")
        t_local = T // runs
        cap = moe_capacity(t_local, cfg)
        e0 = ctx.model_rank * p["w_gate"].shape[0]
        xi, gw = ctx.enter_tp(xt), ctx.enter_tp(gate_w)
        out = torch.cat([
            _moe_bucketed(xi[i:i + t_local], gw[i:i + t_local],
                          gate_e[i:i + t_local], p["w_gate"], p["w_up"],
                          p["w_down"], cap, dt, e0)
            for i in range(0, T, t_local)])
        out = ctx.psum_model(out)
    else:
        xa, gwa, gea = (ctx.gather_batch(t) for t in (xt, gate_w, gate_e))
        out = _moe_bucketed(xa, gwa, gea, p["w_gate"], p["w_up"],
                            p["w_down"], moe_capacity(xa.shape[0], cfg), dt)
        if ctx.rows_local:
            n = B * S
            out = out[ctx.mesh.index(ctx.batch_axes) * n:][:n]
    return out.reshape(B, S, D), (logits, gate_e)


# ---------------------------------------------------------------- RG-LRU

RGLRU_C = 8.0  # the recurrence gate's exponent scale


def init_rglru(gen: torch.Generator, cfg, device=None) -> dict:
    D = cfg.d_model
    w = cfg.rglru_width or D
    cw = cfg.conv_width
    pd = param_dtype(cfg)
    return {
        "w_x": dense_init(gen, (D, w), D, pd, device),
        "w_gate": dense_init(gen, (D, w), D, pd, device),
        "conv_w": dense_init(gen, (cw, w), cw, pd, device),
        "w_rec_gate": dense_init(gen, (w, w), w, pd, device),
        "w_in_gate": dense_init(gen, (w, w), w, pd, device),
        # Uniform in [1, 4), f32 whatever the parameter dtype.
        "lam": 1.0 + 3.0 * torch.rand((w,), generator=gen,
                                      dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (w, D), w, pd, device),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of (a1, b1) ∘ (a2, b2) = (a1·a2,
    a2·b1 + b2), in ``lax.associative_scan``'s order: pairs combined,
    the half-length scan by recursion, then the even elements from the
    odd ones (log-depth; the same association as the reference)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _linear_scan(a1 * a2, a2 * b1 + b2)
    pa, pb = (odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0 else (odd_a, odd_b)
    na, nb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * na], dim=1)
    even_b = torch.cat([b[:, :1], na * pb + nb], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def _causal_conv(xc: torch.Tensor, conv_w: torch.Tensor, S: int):
    """Depthwise causal conv over ``xc`` [B, S + cw - 1, w]: products
    added in order j = 0 … cw-1, in the compute dtype."""
    out = xc[:, 0:S] * conv_w[0]
    for j in range(1, conv_w.shape[0]):
        out = out + xc[:, j:j + S] * conv_w[j]
    return out


def apply_rglru(p: Params, x: torch.Tensor, cfg, *, cache=None,
                want_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """Griffin recurrent block: conv1d → RG-LRU, GeGLU-style gating.
    Prefill (``cache`` None) runs the recurrence as a log-depth scan in
    f32 from h = 0, left pads included; ``want_cache`` returns {"h" f32
    [B, w], "conv" [B, cw-1, w]}. Decode (S == 1) steps ``cache`` in
    place. On a mesh the width w splits on "model" when it divides (the
    gates read the whole conv output, gathered over "model"), and so do
    the cache's."""
    B, S, D = x.shape
    dt = compute_dtype(cfg)
    w = cfg.rglru_width or D
    cw = cfg.conv_width
    par = _on(ctx) and ctx.splits(w)
    if par:
        x = ctx.enter_tp(x)
    xb = x @ p["w_x"].to(dt)                             # [B, S, w]
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    conv_w = p["conv_w"].to(dt)
    w_l = xb.shape[-1]
    if cache is None:
        pad = torch.zeros((B, cw - 1, w_l), dtype=xb.dtype, device=x.device)
        xc = torch.cat([pad, xb], dim=1)
        conv = _causal_conv(xc, conv_w, S)
        conv_state = xc[:, S:] if cw > 1 else None
    else:
        hist = torch.cat([cache["conv"].to(dt), xb], dim=1)
        conv = _causal_conv(hist, conv_w, 1)
        conv_state = hist[:, 1:]

    conv_all = ctx.gather(conv, ctx.model_axis, 2) if par else conv
    r = torch.sigmoid((conv_all @ p["w_rec_gate"].to(dt)).float())
    i = torch.sigmoid((conv_all @ p["w_in_gate"].to(dt)).float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    a = torch.exp(-RGLRU_C * softplus * r)               # [B, S, w]
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (i * conv.float())
    new_cache = None
    if cache is None:
        # From h0 = 0 the scan's b is h (the reference adds a_s · 0).
        _, h = _linear_scan(a, b)
        if want_cache and conv_state is not None:
            new_cache = {"h": h[:, -1], "conv": conv_state.to(dt)}
    else:
        h = a * cache["h"][:, None, :] + b
        cache["h"].copy_(h[:, -1])
        cache["conv"].copy_(conv_state.to(dt))
        new_cache = cache
    y = (h.to(dt) * gate) @ p["w_out"].to(dt)
    return (ctx.psum_model(y) if par else y), new_cache


def init_rglru_cache(cfg, batch: int, device=None) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=compute_dtype(cfg), device=device),
    }


# ---------------------------------------------------------------- xLSTM

def lstm_dims(cfg):
    """(up-projection width 2·D, heads, head width)."""
    w = 2 * cfg.d_model
    H = max(cfg.n_heads, 1)
    return w, H, w // H


def init_mlstm(gen: torch.Generator, cfg, device=None) -> dict:
    D = cfg.d_model
    w, H, _ = lstm_dims(cfg)
    pd = param_dtype(cfg)
    return {
        "w_up": dense_init(gen, (D, w), D, pd, device),
        "w_q": dense_init(gen, (w, w), w, pd, device),
        "w_k": dense_init(gen, (w, w), w, pd, device),
        "w_v": dense_init(gen, (w, w), w, pd, device),
        "w_i": dense_init(gen, (w, H), w, pd, device),
        "w_f": dense_init(gen, (w, H), w, pd, device),
        "w_o": dense_init(gen, (w, w), w, pd, device),
        "w_down": dense_init(gen, (w, D), w, pd, device),
    }


def _mlstm_chunkwise(q, k, v, i_g, f_g, C0, n0, chunk: int):
    """Chunkwise-parallel mLSTM: within a chunk of L steps the recurrence
    unrolls to a decay-masked attention (F_t = Π_{s≤t} f_s, in log space),

        num_t = F_t·(C0 q_t) + Σ_{s≤t} (F_t/F_s)·i_s·(k_s·q_t)·v_s
        den_t = F_t·(n0·q_t) + Σ_{s≤t} (F_t/F_s)·i_s·(k_s·q_t)
        C_L   = F_L·C0 + Σ_s (F_L/F_s)·i_s·v_s k_sᵀ   (and n_L alike),

    the reference's arithmetic chunk by chunk. Returns (h f32 [B, S, H,
    hd], C, n)."""
    B, S, H, hd = q.shape
    L_ = min(chunk, S)
    if S % L_:
        raise ValueError(f"sequence {S} is not a multiple of the mLSTM "
                         f"chunk {L_}")
    tri = torch.tril(torch.ones((L_, L_), dtype=torch.bool,
                                device=q.device))
    C, n = C0, n0
    hs = []
    for c0 in range(0, S, L_):
        qf = q[:, c0:c0 + L_].float()
        kf = k[:, c0:c0 + L_].float()
        vf = v[:, c0:c0 + L_].float()
        ib, fb = i_g[:, c0:c0 + L_], f_g[:, c0:c0 + L_]
        logf = torch.log(torch.clamp(fb.float(), 1e-9, 1.0))
        cum = torch.cumsum(logf, dim=1)                  # [B, L, H]
        Ft = torch.exp(cum)
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # [B, L, L, H]
        Dm = torch.where(tri[None, :, :, None],
                         torch.exp(diff) * ib[:, None, :, :], 0.0)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * Dm
        num = (torch.einsum("btsh,bshd->bthd", scores, vf)
               + Ft[..., None] * torch.einsum("bhvk,bthk->bthv", C, qf))
        den = (scores.sum(dim=2)
               + Ft * torch.einsum("bhk,bthk->bth", n, qf))
        hs.append(num / torch.clamp_min(den.abs(), 1.0)[..., None])
        FL = Ft[:, -1]                                   # [B, H]
        decay_s = torch.exp(cum[:, -1:, :] - cum) * ib   # [B, L, H]
        C = (FL[:, :, None, None] * C
             + torch.einsum("bsh,bshv,bshk->bhvk", decay_s, vf, kf))
        n = FL[..., None] * n + torch.einsum("bsh,bshk->bhk", decay_s, kf)
    return torch.cat(hs, dim=1), C, n


def _mlstm_scan(q, k, v, i_g, f_g, C, n):
    """The sequential recurrence, one step a token: C = f·C + i·v kᵀ,
    n = f·n + i·k, h = C q / max(|n·q|, 1), all in f32."""
    # Time-major copies: each step reads contiguous [B, H, ·] slices.
    qf, kf, vf, i_t, f_t = (a.transpose(0, 1).float().contiguous()
                            for a in (q, k, v, i_g, f_g))
    hs = []
    for t in range(q.shape[1]):
        qt, kt = qf[t], kf[t]
        it, ft = i_t[t], f_t[t]
        C = ft[..., None, None] * C + it[..., None, None] * (
            vf[t, :, :, :, None] * kt[..., None, :])
        n = ft[..., None] * n + it[..., None] * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.clamp_min((n * qt).sum(-1).abs(), 1.0)
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), C, n


def _lstm_params(p: Params, cfg, ctx, par: bool, names,
                 gate_width: int) -> dict:
    """An xLSTM block's parameters as its compute reads them: as given
    (one device, or split on "model" by heads), or gathered whole over
    "model" where the block runs whole on every model rank. The input
    and forget gates are ``gate_width`` wide."""
    if not _on(ctx) or par:
        return {n: p[n] for n in names}
    D = cfg.d_model
    w, H, hd = lstm_dims(cfg)
    full = {"w_up": (D, w), "w_i": (w, gate_width), "w_f": (w, gate_width),
            "w_down": (w, D), "r_z": (H, hd, hd)}
    return {n: ctx.whole(p[n], full.get(n, (w, w))) for n in names}


def apply_mlstm(p: Params, x: torch.Tensor, cfg, *, cache=None,
                want_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """mLSTM block (xLSTM): matrix memory C_t = f C_{t−1} + i v kᵀ per
    head, f32 [B, H, hd, hd]. The keys are f32: the reference divides
    the compute-dtype product by a numpy float64 scalar, which promotes
    it to f32. Prefill with ``cfg.mlstm_chunk`` > 0 and S ≥ the chunk
    runs chunkwise; otherwise (and in decode) one step a token. Decode
    steps ``cache`` {"C", "n"} in place. On a mesh the heads split on
    "model" when it divides them (the projections read the whole
    up-projection, gathered over "model"), and so do the cache's."""
    B, S, D = x.shape
    dt = compute_dtype(cfg)
    w, H, hd = lstm_dims(cfg)
    par = _on(ctx) and ctx.splits(H)
    p = _lstm_params(p, cfg, ctx, par, ("w_up", "w_q", "w_k", "w_v", "w_i",
                                         "w_f", "w_o", "w_down"), H)
    if par:
        x = ctx.enter_tp(x)
    up = x @ p["w_up"].to(dt)                            # [B, S, w]
    if par:
        up = ctx.gather(up, ctx.model_axis, 2)
    H_l = p["w_i"].shape[1]
    w_l = H_l * hd
    q = (up @ p["w_q"].to(dt)).reshape(B, S, H_l, hd)
    inv = float(torch.tensor(math.sqrt(hd), dtype=torch.float32))
    k = (up @ p["w_k"].to(dt)).reshape(B, S, H_l, hd).float() / inv
    v = (up @ p["w_v"].to(dt)).reshape(B, S, H_l, hd)
    i_g = torch.sigmoid((up @ p["w_i"].to(dt)).float())
    f_g = torch.sigmoid((up @ p["w_f"].to(dt)).float())
    if cache is not None:
        C0, n0 = cache["C"], cache["n"]
    else:
        C0 = torch.zeros((B, H_l, hd, hd), dtype=torch.float32,
                         device=x.device)
        n0 = torch.zeros((B, H_l, hd), dtype=torch.float32, device=x.device)
    if cache is None and cfg.mlstm_chunk and S >= cfg.mlstm_chunk:
        hmat, C, n = _mlstm_chunkwise(q, k, v, i_g, f_g, C0, n0,
                                      cfg.mlstm_chunk)
    else:
        hmat, C, n = _mlstm_scan(q, k, v, i_g, f_g, C0, n0)
    h = hmat.reshape(B, S, w_l).to(dt)
    o = torch.sigmoid(up @ p["w_o"].to(dt))
    y = (o * h) @ p["w_down"].to(dt)
    if par:
        y = ctx.psum_model(y)
    new_cache = None
    if cache is not None:
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        new_cache = cache
    elif want_cache:
        new_cache = {"C": C, "n": n}
    return y, new_cache


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    _, H, hd = lstm_dims(cfg)
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32,
                             device=device)}


def init_slstm(gen: torch.Generator, cfg, device=None) -> dict:
    D = cfg.d_model
    w, H, hd = lstm_dims(cfg)
    pd = param_dtype(cfg)
    return {
        "w_up": dense_init(gen, (D, w), D, pd, device),
        "w_z": dense_init(gen, (w, w), w, pd, device),
        "w_i": dense_init(gen, (w, w), w, pd, device),
        "w_f": dense_init(gen, (w, w), w, pd, device),
        "w_o": dense_init(gen, (w, w), w, pd, device),
        "r_z": dense_init(gen, (H, hd, hd), hd, pd, device),
        "w_down": dense_init(gen, (w, D), w, pd, device),
    }


def apply_slstm(p: Params, x: torch.Tensor, cfg, *, cache=None,
                want_cache: bool = False, ctx: Optional[ShardCtx] = None):
    """sLSTM block (xLSTM): scalar memory with head-wise recurrent mixing
    through the f32 ``r_z``, one step a token in f32. Decode steps
    ``cache`` {"c", "n", "h"} in place. On a mesh the heads split on
    "model" when it divides them (each rank mixes its heads through its
    rows of ``r_z``); the cache splits its width w when "model" divides
    w, so a block run whole with a split cache gathers it and writes
    back its part."""
    B, S, D = x.shape
    dt = compute_dtype(cfg)
    w, H, hd = lstm_dims(cfg)
    par = _on(ctx) and ctx.splits(H)
    p = _lstm_params(p, cfg, ctx, par, ("w_up", "w_z", "w_i", "w_f", "w_o",
                                         "r_z", "w_down"), w)
    if par:
        x = ctx.enter_tp(x)
    up = x @ p["w_up"].to(dt)
    if par:
        up = ctx.gather(up, ctx.model_axis, 2)
    z_in = (up @ p["w_z"].to(dt)).float()
    i_in = (up @ p["w_i"].to(dt)).float()
    f_in = (up @ p["w_f"].to(dt)).float()
    o_g = torch.sigmoid(up @ p["w_o"].to(dt))
    r_z = p["r_z"].float()
    w_l = z_in.shape[-1]
    H_l = w_l // hd
    if par:
        h0 = ctx.model_rank * H_l
        r_z = ctx.enter_tp(r_z)[h0:h0 + H_l]
    split_cache = (cache is not None and not par
                   and cache["c"].shape[-1] != w_l)
    if cache is not None:
        c, n, h = cache["c"], cache["n"], cache["h"]
        if split_cache:
            c, n, h = (ctx.mesh.all_gather(t, ctx.model_axis, 1)
                       for t in (c, n, h))
    else:
        c = n = h = torch.zeros((B, w_l), dtype=torch.float32,
                                device=x.device)
    # The gates do not depend on the state: one sigmoid each for all t.
    i_all, f_all = torch.sigmoid(i_in), torch.sigmoid(f_in)
    hs = []
    for t in range(S):
        mix = torch.einsum("bhk,hkj->bhj", h.reshape(B, H_l, hd), r_z)
        z = torch.tanh(z_in[:, t] + mix.reshape(B, w_l))
        i, f = i_all[:, t], f_all[:, t]
        c = f * c + i * z
        n = f * n + i
        h = c / torch.clamp_min(n, 1.0)
        hs.append(h)
    hseq = torch.stack(hs, dim=1).to(dt)
    y = (o_g * hseq) @ p["w_down"].to(dt)
    if par:
        y = ctx.psum_model(y)
    new_cache = None
    if cache is not None:
        for key, t in (("c", c), ("n", n), ("h", h)):
            if split_cache:
                m = cache[key].shape[-1]
                t = t[:, ctx.model_rank * m:(ctx.model_rank + 1) * m]
            cache[key].copy_(t)
        new_cache = cache
    elif want_cache:
        new_cache = {"c": c, "n": n, "h": h}
        if _on(ctx) and not par and ctx.splits(w):
            m = w // ctx.model_size
            new_cache = {key: t[:, ctx.model_rank * m:
                                (ctx.model_rank + 1) * m].clone()
                         for key, t in new_cache.items()}
    return y, new_cache


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    w, _, _ = lstm_dims(cfg)
    return {key: torch.zeros((batch, w), dtype=torch.float32,
                             device=device) for key in ("c", "n", "h")}
