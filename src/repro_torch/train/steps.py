"""train_step / loss: cross-entropy LM training with microbatch gradient
accumulation, remat and the MoE aux loss (torch port of
``repro.train.steps``).

The model is an ``LM`` built with ``trainable=True``; gradients come
from autograd through the port's layers (the reference's LM stack has no
Pallas kernel, so neither pass has a kernel of its own). ``train_step``
updates the model's parameters and the optimizer state in place and
returns them with the step's metrics.

On a mesh (a model sharded with ``LM.shard`` or built with ``ctx``) every
rank takes the same global batch and computes on its rows: the loss it
differentiates is its share (its rows' cross-entropy sum over the
batch's label count, plus its share of the aux loss), the cross-entropy
runs over logits split on the vocabulary when "model" divides it
(max, sum of exponentials and the target logit reduced over "model"),
and the gradients come out reduced over the batch axes and sharded like
the parameters (``grad_shardings``) before the clip reads them.
"""
from __future__ import annotations

import functools
from typing import Mapping

import torch

from repro_torch.models.model import LM
from repro_torch.models.sharding import sharded_axes
from repro_torch.train.optimizer import OptConfig, adamw_step

AUX_WEIGHT = 0.01


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    ctx=None, vocab: int = 0):
    """(summed negative log-likelihood, count) over labels >= 0. A
    negative label indexes from the end, as ``take_along_axis`` does, and
    is then masked. ``ctx`` with ``vocab`` split over a model axis of
    more than one rank: ``logits`` is this rank's slice of the
    vocabulary."""
    logits = logits.float()
    mask = (labels >= 0).float()
    if ctx is not None and ctx.model_size > 1 and ctx.splits(vocab):
        V_l = logits.shape[-1]
        v0 = ctx.model_rank * V_l
        top = ctx.mesh.all_reduce(logits.detach().amax(-1, keepdim=True),
                                  ctx.model_axis, "max")
        lse = top[..., 0] + torch.log(ctx.psum_model(
            torch.exp(logits - top).sum(-1)))
        idx = labels.long()
        idx = torch.where(idx < 0, idx + vocab, idx) - v0
        inside = (idx >= 0) & (idx < V_l)
        pick = torch.gather(logits, -1, idx.clamp(0, V_l - 1)[..., None])
        ll = ctx.psum_model(torch.where(inside, pick[..., 0], 0.0)) - lse
        return -(ll * mask).sum(), mask.sum()
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long()
    idx = torch.where(idx < 0, idx + logits.shape[-1], idx)
    ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def _ratio(ce_sum: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return ce_sum / torch.clamp_min(n, 1.0)


def loss_fn(model: LM, batch: Mapping[str, torch.Tensor], remat=True,
            loss_chunk: int = 0):
    """(loss, ce): cross-entropy plus ``AUX_WEIGHT`` x the MoE aux loss.

    ``loss_chunk`` > 0 runs the trunk without the head, then the head
    and the softmax over ``S // loss_chunk`` sequence chunks, so the f32
    [B, S, V] logits are never whole; the sums add chunk by chunk in
    order, as the reference's scan."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeddings")
    labels = batch["labels"]
    cfg = model.cfg
    ctx = model.ctx
    if ctx is not None:
        ctx = ctx.for_batch(labels.shape[0])
        if not ctx.rows_local:
            raise ValueError(f"a batch of {labels.shape[0]} rows does not "
                             f"split over the {ctx.n_batch} batch shards")
        labels = ctx.rows(labels)

    def ratio(ce_sum, n):
        if ctx is not None:
            n = ctx.mesh.all_reduce(n, ctx.batch_axes)
        return _ratio(ce_sum, n)

    if not loss_chunk:
        logits, _, aux = model(tokens=tokens, input_embeds=embeds,
                               remat=remat)
        ce = ratio(*_ce_from_logits(logits, labels, ctx, cfg.vocab_size))
        return ce + AUX_WEIGHT * aux, ce

    x, aux = model.forward_trunk(tokens=tokens, input_embeds=embeds,
                                 remat=remat)
    head = (model._param("embed").T if cfg.tie_embeddings
            else model._param("lm_head"))
    if ctx is not None and ctx.splits(cfg.vocab_size):
        x = ctx.enter_tp(x)
    head = head.to(x.dtype).float()
    B, S, _ = x.shape
    nc = max(S // loss_chunk, 1)
    if S % nc:
        raise ValueError(f"sequence {S} does not split into {nc} chunks")
    L_ = S // nc
    ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        xb = x[:, c * L_:(c + 1) * L_]
        s, m = _ce_from_logits(xb.float() @ head,
                               labels[:, c * L_:(c + 1) * L_], ctx,
                               cfg.vocab_size)
        ce_sum, n = ce_sum + s, n + m
    ce = ratio(ce_sum, n)
    return ce + AUX_WEIGHT * aux, ce


def _grads_of(model: LM, names, params, mb, remat, loss_chunk):
    loss, ce = loss_fn(model, mb, remat, loss_chunk)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads)), loss.detach(), ce.detach()


def _check_grad_shardings(model: LM, grad_shardings) -> None:
    """The reference pins the gradients to the parameters' shardings;
    the port's gradients always come out so, and any other layout is
    refused."""
    if model.ctx is None:
        raise ValueError("grad_shardings needs a model sharded on a mesh")
    for key, spec in model.specs.items():
        got = grad_shardings.get(key) if hasattr(grad_shardings, "get") \
            else None
        got = getattr(got, "spec", got)
        if got != spec:
            raise ValueError(f"grad_shardings[{key!r}] is {got}; the "
                             f"parameter's spec is {spec}")


def _reduce_grads(grads: dict, model: LM) -> None:
    """Sum each gradient over the batch axes its parameter is not split
    on (the data axis's share came back reduce-scattered from the FSDP
    gather's backward), in place."""
    ctx = model.ctx
    for key, g in grads.items():
        split = sharded_axes(model.specs[key])
        axes = tuple(a for a in ctx.batch_axes if a not in split)
        if axes:
            grads[key] = ctx.mesh.all_reduce(g, axes)


def train_step(model: LM, opt_state: dict, batch: Mapping[str, torch.Tensor],
               oc: OptConfig, *, n_microbatches: int = 1, remat=True,
               loss_chunk: int = 0, ctx=None, grad_shardings=None):
    """One optimizer step; with ``n_microbatches`` > 1 the batch splits
    on its leading dim, the microbatches' gradients are summed from f32
    zeros and averaged, as the reference's scan does. Updates ``model``
    and ``opt_state`` in place; returns (model, opt_state, metrics) with
    ``loss``, ``ce`` and ``step`` as device scalars, as the reference's,
    and the ``grad_norm`` the clip read.

    On a mesh ``ctx`` is the model's (``model.ctx``; None takes it) and
    each microbatch must split over the batch axes; the metrics are the
    whole batch's. ``grad_shardings`` ({state key: sharding or spec},
    e.g. ``to_shardings(model.specs, mesh)``) must be the parameters'."""
    if ctx is not None and ctx.mesh is not None and ctx != model.ctx:
        raise ValueError("ctx is not the model's: shard the model under "
                         "it first (LM.shard)")
    if grad_shardings is not None:
        _check_grad_shardings(model, grad_shardings)
    named = dict(model.named_parameters())
    names = list(named)
    params = [named[k] for k in names]
    if n_microbatches <= 1:
        grads, loss, ce = _grads_of(model, names, params, batch, remat,
                                    loss_chunk)
    else:
        b = next(iter(batch.values())).shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches")
        per = b // n_microbatches
        dev = params[0].device
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for k, p in named.items()}
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        ce = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            g, l_, c_ = _grads_of(model, names, params, mb, remat,
                                  loss_chunk)
            for k in names:
                grads[k] = grads[k] + g[k]
            loss, ce = loss + l_, ce + c_
            del g
        # A device tensor divisor: true division, as the reference's.
        nmb = torch.full((), float(n_microbatches), device=dev)
        grads = {k: g / nmb for k, g in grads.items()}
        loss, ce = loss / nmb, ce / nmb

    mesh = None
    if model.ctx is not None:
        mesh = model.ctx.mesh
        _reduce_grads(grads, model)
        loss, ce = (model.ctx.mesh.all_reduce(t, model.ctx.batch_axes)
                    for t in (loss, ce))
    with torch.no_grad():
        gnorm = adamw_step({k: p.data for k, p in named.items()}, grads,
                           opt_state, oc, model.specs, mesh)
    metrics = {"loss": loss, "ce": ce, "step": opt_state["step"],
               "grad_norm": gnorm}
    return model, opt_state, metrics


def make_train_step(oc: OptConfig, n_microbatches: int = 1, remat=True):
    return functools.partial(train_step, oc=oc,
                             n_microbatches=n_microbatches, remat=remat)
