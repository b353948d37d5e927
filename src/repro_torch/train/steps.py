"""train_step / loss: cross-entropy LM training with microbatch gradient
accumulation, remat and the MoE aux loss (torch port of
``repro.train.steps``).

The model is an ``LM`` built with ``trainable=True``; gradients come
from autograd through the port's layers (the reference's LM stack has no
Pallas kernel, so neither pass has a kernel of its own). ``train_step``
updates the model's parameters and the optimizer state in place and
returns them with the step's metrics.
"""
from __future__ import annotations

import functools
from typing import Mapping

import torch

from repro_torch.models.model import LM
from repro_torch.train.optimizer import OptConfig, adamw_step

AUX_WEIGHT = 0.01


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor):
    """(summed negative log-likelihood, count) over labels >= 0. A
    negative label indexes from the end, as ``take_along_axis`` does, and
    is then masked."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.long()
    idx = torch.where(idx < 0, idx + logits.shape[-1], idx)
    ll = torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
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
    if not loss_chunk:
        logits, _, aux = model(tokens=tokens, input_embeds=embeds,
                               remat=remat)
        ce = _ratio(*_ce_from_logits(logits, labels))
        return ce + AUX_WEIGHT * aux, ce

    cfg = model.cfg
    x, aux = model.forward_trunk(tokens=tokens, input_embeds=embeds,
                                 remat=remat)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
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
                               labels[:, c * L_:(c + 1) * L_])
        ce_sum, n = ce_sum + s, n + m
    ce = _ratio(ce_sum, n)
    return ce + AUX_WEIGHT * aux, ce


def _grads_of(model: LM, names, params, mb, remat, loss_chunk):
    loss, ce = loss_fn(model, mb, remat, loss_chunk)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads)), loss.detach(), ce.detach()


def train_step(model: LM, opt_state: dict, batch: Mapping[str, torch.Tensor],
               oc: OptConfig, *, n_microbatches: int = 1, remat=True,
               loss_chunk: int = 0, grad_shardings=None):
    """One optimizer step; with ``n_microbatches`` > 1 the batch splits
    on its leading dim, the microbatches' gradients are summed from f32
    zeros and averaged, as the reference's scan does. Updates ``model``
    and ``opt_state`` in place; returns (model, opt_state, metrics) with
    ``loss``, ``ce`` and ``step`` as device scalars, as the reference's,
    and the ``grad_norm`` the clip read."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings pins FSDP gradient shardings over a device "
            "mesh, which waits for ROADMAP item 5 (rest); one card takes "
            "grad_shardings=None")
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

    with torch.no_grad():
        gnorm = adamw_step({k: p.data for k, p in named.items()}, grads,
                           opt_state, oc)
    metrics = {"loss": loss, "ce": ce, "step": opt_state["step"],
               "grad_norm": gnorm}
    return model, opt_state, metrics


def make_train_step(oc: OptConfig, n_microbatches: int = 1, remat=True):
    return functools.partial(train_step, oc=oc,
                             n_microbatches=n_microbatches, remat=remat)
