"""Decoder blocks of the dense family: RMSNorm, RoPE, GQA/MQA attention
(chunked online softmax, one-token decode over a ring cache, sliding
window) and the gated / plain MLPs (torch port of the dense part of
``repro.models.layers``).

Pure-function style, as the reference: ``init_*`` builds a dict of
tensors from a ``torch.Generator``, ``apply_*`` consumes a mapping of
tensors (a dict or the ``nn.ParameterDict`` of ``models/model.py``).
There is no mesh on one card, so nothing takes the reference's
``ShardCtx``. Compute dtype is ``cfg.dtype`` (bf16 by default); norms,
softmax and the products the reference accumulates into f32
(``preferred_element_type=jnp.float32``) run in f32: their bf16 operands
are upcast, which keeps every product exact, and the result stays f32.
The other products (q/k/v, ``wo``, the MLP) return ``cfg.dtype`` as the
reference's do. Masked scores are -1e30, not -inf, as in the reference.

Decode updates the cache tensors it is given IN PLACE (the reference
returns a new cache); callers that want to keep a cache clone it first.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = Mapping[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MASKED = -1e30  # the reference's mask value and online-softmax start


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
               chunk_q: int = 512, chunk_kv: int = 1024):
    """GQA attention; returns (y [B, S, D], cache or None).

    Train/prefill when ``cache`` is None (``want_cache`` also returns a
    cache of ``s_alloc`` slots, ring-buffered to ``window`` for local
    attention). Otherwise one-token decode (S == 1) against ``cache``
    {"k", "v", "pos"}, written in place at ``cur_index``: a scalar with
    ``pos`` int32[S_alloc], or per row (continuous batching) with
    ``cur_index`` int[B] and ``pos`` int32[B, S_alloc], so every row masks
    by its own timeline."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KV
    dt = compute_dtype(cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)

    q = rope(_project(x, p["wq"], dt), positions, cfg.rope_theta)
    k = rope(_project(x, p["wk"], dt), positions, cfg.rope_theta)
    v = _project(x, p["wv"], dt)

    if cache is None:
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
            slot = (ci % S_alloc).long()
            rows = torch.arange(B, device=x.device)
            ck_[rows, slot] = k[:, 0]
            cv_[rows, slot] = v[:, 0]
            cpos[rows, slot] = ci
            kp = cpos[:, None, :]
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
        qg = q.reshape(B, 1, KV, G, hd).float()
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

    out = out.reshape(B, -1, H * hd).to(dt)
    y = out @ p["wo"].to(dt).reshape(H * hd, D)
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


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU, GeGLU or plain GELU MLP. GELU is the tanh approximation,
    as ``jax.nn.gelu``'s default."""
    dt = compute_dtype(cfg)
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
    return h @ p["w_down"].to(dt)
