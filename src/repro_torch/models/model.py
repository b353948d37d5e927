"""Decoder-only LM assembly: init / forward / prefill / decode (torch port
of ``repro.models.model``).

``LM`` is one ``nn.Module``: ``embed``, ``final_norm``, ``lm_head`` when
embeddings are untied, and ``layers``, a ``ModuleList`` over pattern
groups (one group is one layer for the dense family) whose entries hold
each block's ``norm`` and ``block`` parameters under the reference's keys
(``_flat_pattern``). ``forward`` loops over the groups where the
reference scans them. Its state-dict keys are ``embed``,
``final_norm.scale``, ``lm_head`` and ``layers.{g}.{key}.{norm|block}.{w}``;
``params_from_jax`` maps the reference's group-stacked pytree onto them.

Caches keep the reference's layout, stacked over groups: attention
``{key: {"k": [G, B, alloc, KV, hd], "v": ..., "pos": int32[G, alloc]}}``
(``pos`` [G, B, alloc] for per-row decode), RG-LRU ``{"h": f32 [G, B,
w], "conv": [G, B, cw-1, w]}``, mLSTM ``{"C": f32 [G, B, H, hd, hd],
"n": f32 [G, B, H, hd]}``, sLSTM ``{"c", "n", "h": f32 [G, B, w]}``, so
``cache_from_jax`` and ``cache_to_numpy`` move a cache between the
packages unchanged. Decode writes into the cache in place.

Every block kind of the reference is served and trained. ``forward``
returns the MoE load-balance loss beside the logits; ``remat`` runs each
group (``True``) or each block (``"save_tp"``) under
``torch.utils.checkpoint``, and ``forward_trunk`` stops before the head,
for the chunked loss of ``train/steps.py``. ``LM(cfg, state,
trainable=True)`` makes the parameters trainable; the serving copy stays
frozen. ``params_to_tree`` / ``params_to_jax`` give the reference's
group-stacked pytree back, ``opt_state_to_tree`` / ``opt_state_from_tree``
the optimizer state's, and ``jax_leaves`` the reference's leaves in its order.

On a mesh (``LM(..., ctx=make_ctx(mesh))``, or ``model.shard(ctx)``)
the state dict holds this rank's shards (``models/sharding.py``'s
``state_pspecs``, kept in ``specs``); each block gathers its parameters
over the data axes as it runs (FSDP) and leaves the model axis to the
layers. ``forward`` takes the global batch and returns this rank's part
of the result: its batch rows (all of them when the batch does not
divide over the batch axes), logits split on the vocabulary when "model"
divides it, the cache as ``cache_pspecs`` shards it, and this rank's
share of the aux loss (the shares sum to the batch's).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
# torch wraps ``checkpoint`` in ``torch._disable_dynamo``, which imports
# ``torch._dynamo`` on its first call; that import runs ``torch.fx.wrap``,
# whose frame holds itself and, through ``f_back``, its callers' frames,
# so a process's first remat step (its activations, gradients, model and
# optimizer state) would live until the garbage collector runs. Import
# it here, before any step.
import torch._dynamo  # noqa: F401
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig

BLOCK_INIT = {
    "attn": L.init_attn,
    "local_attn": L.init_attn,
    "mlp": L.init_mlp,
    "moe": L.init_moe,
    "rglru": L.init_rglru,
    "mlstm": L.init_mlstm,
    "slstm": L.init_slstm,
}

ATTN_KINDS = ("attn", "local_attn")
# The recurrent blocks: (apply, init_cache), each carrying O(1) state.
RECURRENT = {
    "rglru": (L.apply_rglru, L.init_rglru_cache),
    "mlstm": (L.apply_mlstm, L.init_mlstm_cache),
    "slstm": (L.apply_slstm, L.init_slstm_cache),
}
# Cache leaves held in the compute dtype; ``pos`` is int32, the rest f32.
CACHE_DTYPE_KEYS = ("k", "v", "conv")


def _flat_pattern(cfg: ModelConfig):
    """[(key, kind), ...] across one pattern period; key is unique."""
    out = []
    for li, grp in enumerate(cfg.block_pattern):
        for bi, kind in enumerate(grp):
            out.append((f"l{li}b{bi}_{kind}", kind))
    return out


def _params(tensors: Mapping[str, torch.Tensor],
            trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=trainable)
                             for k, t in tensors.items()})


class Block(nn.Module):
    """One block's parameters: ``norm`` (RMSNorm scale) and ``block``."""

    def __init__(self, norm: Mapping[str, torch.Tensor],
                 block: Mapping[str, torch.Tensor], trainable: bool = False):
        super().__init__()
        self.norm = _params(norm, trainable)
        self.block = _params(block, trainable)
        self.specs: dict = {}  # the block parameters' specs on a mesh


def moe_aux_loss(logits: torch.Tensor, gate_e: torch.Tensor,
                 n_experts: int, ctx=None) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_e f_e·P_e of one MoE call:
    P_e the mean router probability, f_e the share of the choices that
    went to expert e, counted by adding 1/n once a choice as the
    reference's scatter-add does (equal addends: any order, one sum).
    With this rank's rows of a batch split over the batch axes, f_e is
    the whole batch's (summed over the batch axes) and the result this
    rank's share: P_e is its rows' mean weighted by their part of the
    batch."""
    split = L._on(ctx) and ctx.rows_local
    n = ctx.n_batch if split else 1
    probs = torch.softmax(logits, dim=-1)
    P_e = probs.mean(dim=0)
    if split:
        P_e = P_e * (1.0 / n)
    flat = gate_e.reshape(-1)
    f_e = torch.zeros(n_experts, dtype=torch.float32,
                      device=logits.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (flat.numel() * n),
                            dtype=torch.float32, device=logits.device))
    if split:
        f_e = ctx.mesh.all_reduce(f_e, ctx.batch_axes)
    return n_experts * torch.sum(f_e * P_e)


def _apply_block(kind: str, bp: Block, x: torch.Tensor, cfg: ModelConfig,
                 *, cache, cur_index, positions, want_cache, s_alloc,
                 ctx=None):
    """Pre-norm + residual around one block; returns (x, cache, aux):
    aux is an MoE block's load-balance loss in the training form (no
    cache), else None (prefill and decode callers discard it, and it
    would cost a step a few kernels an MoE layer). On a mesh the block's
    parameters are gathered over the data axes first (FSDP)."""
    h = L.apply_rmsnorm(bp.norm, x)
    p = bp.block
    if L._on(ctx):
        p = {w: ctx.fsdp(t, bp.specs[w]) for w, t in p.items()}
    new_cache = None
    aux = None
    if kind in ATTN_KINDS:
        window = cfg.window if kind == "local_attn" else 0
        y, new_cache = L.apply_attn(
            p, h, cfg, window=window, cache=cache,
            cur_index=cur_index, positions=positions,
            want_cache=want_cache, s_alloc=s_alloc, ctx=ctx)
    elif kind == "mlp":
        y = L.apply_mlp(p, h, cfg, ctx)
    elif kind == "moe":
        y, (logits, gate_e) = L.apply_moe(p, h, cfg, ctx)
        if cache is None and not want_cache:
            aux = moe_aux_loss(logits, gate_e, cfg.n_experts, ctx)
    elif kind in RECURRENT:
        y, new_cache = RECURRENT[kind][0](p, h, cfg, cache=cache,
                                          want_cache=want_cache, ctx=ctx)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x + y, new_cache, aux


REMAT = (False, True, "full", "save_tp")


def _check_remat(remat) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


class LM(nn.Module):
    """A decoder-only LM built from a state dict (see the module doc).

    ``serving`` marks a copy made by :meth:`serving_copy`, whose weights
    already hold the values the forward pass computes with."""

    def __init__(self, cfg: ModelConfig, state: Mapping[str, torch.Tensor],
                 trainable: bool = False, ctx: Optional[L.ShardCtx] = None):
        super().__init__()
        self.cfg = cfg
        self.serving = False
        self.ctx = ctx if L._on(ctx) else None
        self.embed = nn.Parameter(state["embed"], requires_grad=trainable)
        self.final_norm = _params({"scale": state["final_norm.scale"]},
                                  trainable)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(state["lm_head"],
                                        requires_grad=trainable)
        groups = []
        for g in range(cfg.n_groups):
            blocks = {}
            for name, _ in _flat_pattern(cfg):
                parts = {}
                for part in ("norm", "block"):
                    prefix = f"layers.{g}.{name}.{part}."
                    parts[part] = {key[len(prefix):]: t
                                   for key, t in state.items()
                                   if key.startswith(prefix)}
                blocks[name] = Block(parts["norm"], parts["block"],
                                     trainable)
            groups.append(nn.ModuleDict(blocks))
        self.layers = nn.ModuleList(groups)
        have, given = set(self.state_dict()), set(state)
        if have != given:
            raise KeyError(f"state dict does not fit {cfg.name}: missing "
                           f"{sorted(have - given)}, unexpected "
                           f"{sorted(given - have)}")
        self.specs = None
        if self.ctx is not None:
            mesh = self.ctx.mesh
            full = full_shapes(cfg)
            self.specs = sharding.state_pspecs(cfg, full, mesh)
            for key, t in state.items():
                want = _local_shape(full[key].shape, self.specs[key], mesh)
                if tuple(t.shape) != want:
                    raise ValueError(
                        f"{key} is {tuple(t.shape)}; this rank's shard of "
                        f"{tuple(full[key].shape)} under "
                        f"{self.specs[key]} is {want}")
            for g, group in enumerate(self.layers):
                for name, blk in group.items():
                    prefix = f"layers.{g}.{name}.block."
                    blk.specs = {w: self.specs[prefix + w]
                                 for w in blk.block}

    @property
    def trainable(self) -> bool:
        return self.embed.requires_grad

    def shard(self, ctx: L.ShardCtx) -> "LM":
        """This (whole) model's shards under ``ctx``'s mesh, on the
        mesh's device: a new ``LM`` for this rank."""
        if self.ctx is not None:
            raise ValueError("the model is sharded already")
        specs = sharding.state_pspecs(self.cfg, self.state_dict(), ctx.mesh)
        state = sharding.shard_state(
            {k: t.detach() for k, t in self.state_dict().items()}, specs,
            ctx.mesh)
        lm = LM(self.cfg, state, self.trainable, ctx=ctx)
        lm.serving = self.serving
        return lm

    def full_state(self) -> dict:
        """The whole state dict, gathered from every rank's shards
        (collective on a mesh)."""
        state = {k: t.detach() for k, t in self.state_dict().items()}
        if self.ctx is None:
            return state
        return sharding.gather_state(state, self.specs, self.ctx.mesh)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def serving_copy(self) -> "LM":
        """The weights cast once to the values the forward pass reads.

        The reference casts its f32 parameters to ``cfg.dtype`` on each
        call; a cast is deterministic, so casting once gives identical
        values. Block matrices and the embedding are stored in
        ``cfg.dtype``; the unembedding head (``embed`` when tied, else
        ``lm_head``) in f32 holding the ``cfg.dtype``-rounded values, since
        its product accumulates into f32. Norm scales, which the norm
        reads in f32, and the parameters the reference reads in f32 and
        unrounded (``layers.F32_PARAMS``: the MoE router, RG-LRU's
        ``lam``, sLSTM's ``r_z``) stay as they are. Costs the copy's
        bytes beside the original: 3.0 GB for Llama-3.2-1B in bf16 (its
        embedding, the tied head, at 4 bytes)."""
        if self.serving:
            return self
        dt = L.compute_dtype(self.cfg)
        head = "embed" if self.cfg.tie_embeddings else "lm_head"
        state = {}
        for key, t in self.state_dict().items():
            if (key.endswith("norm.scale")
                    or key.rsplit(".", 1)[-1] in L.F32_PARAMS):
                state[key] = t
            elif key == head:
                state[key] = t.to(dt).float()
            else:
                state[key] = t.to(dt)
        lm = LM(self.cfg, state, ctx=self.ctx)
        lm.serving = True
        return lm

    def _param(self, key: str) -> torch.Tensor:
        """A top-level parameter gathered over the data axes (FSDP)."""
        t = getattr(self, key)
        return t if self.ctx is None else self.ctx.fsdp(t, self.specs[key])

    def embed_inputs(self, tokens: Optional[torch.Tensor] = None,
                     input_embeds: Optional[torch.Tensor] = None):
        """The residual stream's input [B, S, D] in the compute dtype:
        embedded ``tokens``, or ``input_embeds`` from a stub frontend."""
        cfg = self.cfg
        dt = L.compute_dtype(cfg)
        if input_embeds is not None:
            x = input_embeds.to(dt)
        elif self.ctx is not None:
            table = self.ctx.whole(self._param("embed"),
                                   (cfg.vocab_size, cfg.d_model))
            x = table[tokens].to(dt)
        else:
            x = self.embed[tokens].to(dt)
        if cfg.scale_embed:
            # The reference rounds sqrt(d) to the compute dtype first; a
            # Python scalar keeps the multiply free of a host-to-device copy.
            x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dt))
        return x

    def forward(self, tokens: Optional[torch.Tensor] = None,
                input_embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None, cur_index=None,
                want_cache: bool = False, s_alloc: int = 0,
                remat=False):
        """Returns (logits f32[B, S, V], cache, aux f32 scalar).

        Train: ``tokens`` [B, S] (or ``input_embeds`` [B, S, D] for stub
        frontends), no cache; ``remat`` (``True``/``"full"`` or
        ``"save_tp"``) recomputes activations in the backward pass.
        Prefill: ``want_cache=True``, ``s_alloc`` = cache allocation.
        Decode: ``cache`` (updated in place) and ``cur_index`` (a scalar,
        or int[B] per row); ``tokens`` [B, 1]. ``aux`` sums the MoE
        blocks' load-balance losses."""
        cfg = self.cfg
        dt = L.compute_dtype(cfg)
        ctx = self._batch_ctx(tokens, input_embeds)
        inp = tokens if tokens is not None else input_embeds
        B, S = inp.shape[:2]
        if positions is None:
            if cur_index is None:
                positions = torch.arange(S, dtype=torch.int32,
                                         device=inp.device).expand(B, S)
            elif torch.is_tensor(cur_index) and cur_index.dim() == 1:
                positions = cur_index.to(inp.device, torch.int32)[
                    :, None].expand(B, S)
            else:  # a scalar: filled on the device, no host-to-device copy
                positions = torch.full((B, S), int(cur_index),
                                       dtype=torch.int32, device=inp.device)
        if ctx is not None:
            tokens, input_embeds, positions = (
                None if t is None else ctx.rows(t)
                for t in (tokens, input_embeds, positions))
        x = self.embed_inputs(tokens, input_embeds)
        x, new_cache, aux = self._trunk(
            x, positions, cache=cache, cur_index=cur_index,
            want_cache=want_cache, s_alloc=s_alloc, remat=remat, ctx=ctx)
        x = L.apply_rmsnorm(self.final_norm, x)
        return self.head_logits(x), new_cache, aux

    def _batch_ctx(self, tokens, input_embeds):
        if self.ctx is None:
            return None
        inp = tokens if tokens is not None else input_embeds
        return self.ctx.for_batch(inp.shape[0])

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final-norm output ``x``; on a mesh split on
        the vocabulary when "model" divides it."""
        cfg = self.cfg
        head = (self._param("embed").T if cfg.tie_embeddings
                else self._param("lm_head"))
        if not self.serving:
            head = head.to(L.compute_dtype(cfg))
        if self.ctx is not None and self.ctx.splits(cfg.vocab_size):
            x = self.ctx.enter_tp(x)
        return x.float() @ head.float()

    def gather_logits(self, logits: torch.Tensor,
                      batch: int) -> torch.Tensor:
        """The whole ``batch``'s whole-vocabulary logits from this rank's
        part (no gradient; on one device, ``logits`` itself)."""
        ctx = self.ctx
        if ctx is None:
            return logits
        if ctx.splits(self.cfg.vocab_size):
            logits = ctx.mesh.all_gather(logits, ctx.model_axis,
                                         logits.dim() - 1)
        if ctx.for_batch(batch).rows_local:
            logits = ctx.mesh.all_gather(logits, ctx.batch_axes, 0)
        return logits

    def forward_trunk(self, tokens: Optional[torch.Tensor] = None,
                      input_embeds: Optional[torch.Tensor] = None,
                      remat=False):
        """Forward without the unembedding head: (x after the final norm
        [B, S, D] in the compute dtype, aux), for the chunked loss."""
        ctx = self._batch_ctx(tokens, input_embeds)
        if ctx is not None:
            tokens, input_embeds = (None if t is None else ctx.rows(t)
                                    for t in (tokens, input_embeds))
        x = self.embed_inputs(tokens, input_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        x, _, aux = self._trunk(x, positions, cache=None, cur_index=None,
                                want_cache=False, s_alloc=0, remat=remat,
                                ctx=ctx)
        return L.apply_rmsnorm(self.final_norm, x), aux

    def _trunk(self, x, positions, *, cache, cur_index, want_cache,
               s_alloc, remat, ctx=None):
        """The groups in order; returns (x, cache, aux). Under ``remat``
        (training: no cache) each group runs under
        ``torch.utils.checkpoint`` and only its input is kept for the
        backward pass, as the reference's ``jax.checkpoint`` of its scan
        body; ``"save_tp"`` checkpoints each block instead, so the block
        outputs the reference names ``tp_out`` (attention and MLP) are
        kept, inside the residual sum that follows them."""
        cfg = self.cfg
        _check_remat(remat)
        entries = _flat_pattern(cfg)
        train = cache is None and not want_cache
        auxes: list = []  # the MoE blocks' losses, summed in block order
        built: dict[str, list] = {}

        def block_fn(group, name, kind):
            def run(x):
                x, _, a = _apply_block(
                    kind, group[name], x, cfg, cache=None, cur_index=None,
                    positions=positions, want_cache=False, s_alloc=0,
                    ctx=ctx)
                return x, a
            return run

        def group_fn(group):
            def run(x):
                out = []
                for name, kind in entries:
                    x, a = block_fn(group, name, kind)(x)
                    out.append(a)
                return x, [a for a in out if a is not None]
            return run

        for g, group in enumerate(self.layers):
            if train and remat == "save_tp":
                for name, kind in entries:
                    x, a = checkpoint(block_fn(group, name, kind), x,
                                      use_reentrant=False)
                    auxes.append(a)
                continue
            if train and remat:
                x, a = checkpoint(group_fn(group), x, use_reentrant=False)
                auxes.extend(a)
                continue
            for name, kind in entries:
                bc = None
                if cache is not None and name in cache:
                    bc = {key: leaf[g] for key, leaf in cache[name].items()}
                x, nc, a = _apply_block(
                    kind, group[name], x, cfg, cache=bc, cur_index=cur_index,
                    positions=positions, want_cache=want_cache,
                    s_alloc=s_alloc, ctx=ctx)
                auxes.append(a)
                if want_cache and nc is not None:
                    built.setdefault(name, []).append(nc)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in auxes:
            if a is not None:
                aux = aux + a
        new_cache = cache
        if want_cache:
            new_cache = {name: {key: torch.stack([c[key] for c in per])
                                for key in per[0]}
                         for name, per in built.items()}
        return x, new_cache, aux


# ------------------------------------------------------------------ init

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, trainable: bool = False) -> LM:
    """Random parameters drawn from ``generator`` on ``device`` (the
    generator must live there), trainable or frozen. Its draws are not
    the reference's ``jax.random`` bits; ``params_from_jax`` carries
    those across."""
    D, V = cfg.d_model, cfg.vocab_size
    pd = L.param_dtype(cfg)
    state = {"embed": (torch.randn((V, D), generator=generator,
                                   dtype=torch.float32, device=device)
                       * 0.02).to(pd),
             "final_norm.scale": L.init_rmsnorm(cfg, device)["scale"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = L.dense_init(generator, (D, V), D, pd, device)
    for g in range(cfg.n_groups):
        for name, kind in _flat_pattern(cfg):
            for part, tensors in (
                    ("norm", L.init_rmsnorm(cfg, device)),
                    ("block", BLOCK_INIT[kind](generator, cfg, device))):
                for w, t in tensors.items():
                    state[f"layers.{g}.{name}.{part}.{w}"] = t
    return LM(cfg, state, trainable)


def full_shapes(cfg: ModelConfig) -> dict:
    """The whole state dict's keys and shapes, as meta tensors."""
    return init_params(cfg, torch.Generator(), device="meta").state_dict()


def _local_shape(shape, spec, mesh) -> tuple:
    return tuple(n // mesh.count(sharding.spec_axes(e)) if e else n
                 for n, e in zip(shape, spec))


def init_cache(cfg: ModelConfig, batch: int, s_alloc: int,
               device=None, ctx: Optional[L.ShardCtx] = None) -> dict:
    """Decode cache, leaves stacked over groups: [n_groups, ...]. On a
    mesh, this rank's shards as ``cache_pspecs`` cut them."""
    if L._on(ctx):
        meta = init_cache(cfg, batch, s_alloc, device="meta")
        specs = sharding.cache_pspecs(cfg, meta, ctx.mesh)
        return {name: {key: torch.full(
            _local_shape(leaf.shape, specs[name][key], ctx.mesh),
            -1 if key == "pos" else 0, dtype=leaf.dtype, device=device)
            for key, leaf in sub.items()} for name, sub in meta.items()}
    cache = {}
    for name, kind in _flat_pattern(cfg):
        if kind in ATTN_KINDS:
            window = cfg.window if kind == "local_attn" else 0
            one = L.init_attn_cache(cfg, batch, s_alloc, window, device)
        elif kind in RECURRENT:
            one = RECURRENT[kind][1](cfg, batch, device)
        else:
            continue
        cache[name] = {key: leaf.expand(cfg.n_groups, *leaf.shape).clone()
                       for key, leaf in one.items()}
    return cache


# ------------------------------------------------------ crossing packages

def _tensor(x) -> torch.Tensor:
    """A numpy array (any float dtype, bfloat16 included) or a tensor as
    a tensor of its own (a copy)."""
    if torch.is_tensor(x):
        return x.detach().clone()
    x = np.asarray(x)
    if x.dtype.kind == "V" or x.dtype.name == "bfloat16":
        x = x.astype(np.float32)
    return torch.from_numpy(np.array(x))  # a writable copy


def _unstack(groups: Mapping[str, Any], cfg: ModelConfig,
             dtype_of=None) -> dict:
    """The ``groups`` subtree (leaves ``[n_groups, ...]``) as per-group
    state-dict entries; ``dtype_of(w)`` picks a leaf's dtype (None keeps
    it)."""
    state = {}
    for name, _ in _flat_pattern(cfg):
        for part in ("norm", "block"):
            for w, stacked in groups[name][part].items():
                arr = _tensor(stacked)
                if dtype_of is not None:
                    arr = arr.to(dtype_of(w))
                for g in range(cfg.n_groups):
                    state[f"layers.{g}.{name}.{part}.{w}"] = arr[g].clone()
    return state


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """The reference's parameter pytree (numpy leaves, or tensors as
    ``checkpoint.restore`` gives them; group-stacked ``[n_groups, ...]``
    under ``groups``) as the port's state dict, in ``cfg.param_dtype`` on
    the CPU: ``LM(cfg, params_from_jax(tree, cfg))``. RG-LRU's ``lam``
    stays f32, as the reference makes it."""
    pd = L.param_dtype(cfg)
    state = {"embed": _tensor(tree["embed"]).to(pd),
             "final_norm.scale": _tensor(tree["final_norm"]["scale"]).to(pd)}
    if not cfg.tie_embeddings:
        state["lm_head"] = _tensor(tree["lm_head"]).to(pd)
    state.update(_unstack(tree["groups"], cfg, lambda w: (
        torch.float32 if w == "lam" else pd)))
    return state


def params_to_tree(state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   device=None) -> dict:
    """The inverse of ``params_from_jax``: a state dict (or a dict of
    moments keyed like it) as the reference's pytree of tensors, each
    block leaf stacked over groups, on ``device`` (None: where it is).
    Dtypes are kept."""
    def to(t):
        return t.detach().to(device) if device is not None else t.detach()

    def stack(ts):
        # Each group copied once, straight into its slice.
        out = torch.empty((len(ts),) + tuple(ts[0].shape),
                          dtype=ts[0].dtype,
                          device=device if device is not None
                          else ts[0].device)
        for g, t in enumerate(ts):
            out[g].copy_(t.detach())
        return out

    tree: dict = {"embed": to(state["embed"]),
                  "final_norm": {"scale": to(state["final_norm.scale"])}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = to(state["lm_head"])
    groups: dict = {}
    for name, _ in _flat_pattern(cfg):
        for part in ("norm", "block"):
            first = f"layers.0.{name}.{part}."
            leaves = [k[len(first):] for k in state if k.startswith(first)]
            groups.setdefault(name, {})[part] = {
                w: stack([state[f"layers.{g}.{name}.{part}.{w}"]
                          for g in range(cfg.n_groups)])
                for w in leaves}
    tree["groups"] = groups
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    """numpy has no bfloat16: a bf16 leaf comes out as float32 holding
    the same values."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_to_jax(state: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> dict:
    """``params_to_tree`` with numpy leaves (bf16 as float32 of equal
    values): what the reference's functions take as ``params``."""
    return _map(_numpy, params_to_tree(state, cfg, "cpu"))


def opt_state_to_tree(state: Mapping[str, Any], cfg: ModelConfig,
                      device=None) -> dict:
    """The optimizer state (``train.optimizer``) in the reference's
    layout: ``{"step", "m", "v"[, "err"]}``, moments group-stacked."""
    out = {"step": state["step"].detach().to(device or state["step"].device)}
    for key in ("m", "v", "err"):
        if key in state:
            out[key] = params_to_tree(state[key], cfg, device)
    return out


def opt_state_to_jax(state: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """``opt_state_to_tree`` with numpy leaves (bf16 as float32)."""
    return _map(_numpy, opt_state_to_tree(state, cfg, "cpu"))


def opt_state_from_tree(tree: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """The reference's optimizer-state pytree (numpy leaves or tensors)
    as the port's, on the CPU, each leaf in its own dtype (numpy float32
    stands for bf16 only where the caller converts it)."""
    def moments(sub):
        state = {"embed": _tensor(sub["embed"]),
                 "final_norm.scale": _tensor(sub["final_norm"]["scale"])}
        if "lm_head" in sub:
            state["lm_head"] = _tensor(sub["lm_head"])
        state.update(_unstack(sub["groups"], cfg))
        return state

    out = {"step": _tensor(tree["step"]).to(torch.int32)}
    for key in ("m", "v", "err"):
        if key in tree:
            out[key] = moments(tree[key])
    return out


def load_tree_(state: Mapping[str, torch.Tensor], tree: Mapping[str, Any]):
    """Copy a group-stacked tree (the reference's layout, tensor leaves)
    into the tensors of a state dict (or moments keyed like it) in
    place, each group's slice once, cast to the tensor's dtype: what
    ``params_from_jax`` and ``load_state_dict`` do, without the host
    copies between."""
    with torch.no_grad():
        for key, t in state.items():
            path = _jax_path(key)
            node = tree
            for p in path[:4] if path[0] == "groups" else path:
                node = node[p]
            src = node[path[4]] if path[0] == "groups" else node
            t.copy_(src if torch.is_tensor(src) else _tensor(src))


def _jax_path(key: str) -> tuple:
    """The reference pytree path of a state-dict key, the group last:
    ``layers.{g}.{name}.{part}.{w}`` → ("groups", name, part, w, g)."""
    parts = key.split(".")
    if parts[0] == "layers" and len(parts) == 5:
        return ("groups", parts[2], parts[3], parts[4], int(parts[1]))
    return tuple(parts)


def jax_leaves(keys) -> list[list[str]]:
    """The reference's leaves in its order (``jax.tree.leaves``: dict
    keys sorted), each as the state-dict keys it stacks, in group order
    (one key for a leaf outside the groups)."""
    leaves: dict[tuple, list] = {}
    for k in sorted(keys, key=_jax_path):
        path = _jax_path(k)
        leaves.setdefault(path[:4] if path[0] == "groups" else path,
                          []).append(k)
    return list(leaves.values())


def cache_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                   device=None) -> dict:
    """A cache pytree written by the reference (numpy leaves) as the
    port's cache: k/v and RG-LRU's conv in ``cfg.dtype`` (exact: the
    reference stores them in that dtype), ``pos`` int32, the recurrent
    states f32."""
    dt = L.compute_dtype(cfg)

    def leaf_dtype(key):
        if key == "pos":
            return torch.int32
        return dt if key in CACHE_DTYPE_KEYS else torch.float32

    return {name: {key: _tensor(leaf).to(leaf_dtype(key)).to(device)
                   for key, leaf in sub.items()}
            for name, sub in tree.items()}


def cache_to_numpy(cache: Mapping[str, Any]) -> dict:
    """The port's cache as numpy leaves in the reference's layout. numpy
    has no bfloat16: bf16 k/v/conv come out as float32 holding the same
    values (``jnp.asarray(x, jnp.bfloat16)`` restores them exactly).
    Every leaf is a copy: decode steps the port's cache in place, and the
    arrays returned must not move with it."""
    return {name: {key: np.array((leaf if key == "pos" else leaf.float())
                                 .cpu().numpy())
                   for key, leaf in sub.items()}
            for name, sub in cache.items()}
