"""AdamW, written out by hand, with optional int8 gradient compression
(torch port of ``repro.train.optimizer``).

Parameters, gradients and the moments are dicts keyed like the port's
state dict (``LM.state_dict()``). The state mirrors the reference's
pytree: ``{"step": int32 scalar, "m": {...}, "v": {...}}`` and, with
``grad_compress="int8"``, ``"err"``: the bf16 error-feedback residual
of each leaf. ``models.model.opt_state_to_tree`` / ``opt_state_from_tree``
move it to and from the reference's group-stacked layout.

The step writes its results into the tensors it is given (the reference
returns new trees; the values are the same). The update is the
reference's expression in the reference's order of operations, in f32:
``p - lr·(m̂/(√v̂ + eps) + wd·p)``. ``torch.optim.AdamW``
would decay first as ``p·(1 − lr·wd)``, which rounds otherwise. Python
scalars enter each product as f32, as JAX's weakly typed scalars do;
the bias corrections ``b ** step`` are computed in f32 tensors.

On a mesh the dicts hold this rank's shards and ``specs`` (``LM.specs``)
says how each is cut: the step is elementwise, the global norm adds every
element once (a leaf's sum of squares is summed over the axes it is split
on, not over those it is replicated on) and int8 compression's scale is
the max over the whole leaf, every shard of every group.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from repro_torch.models.model import jax_leaves
from repro_torch.models.sharding import sharded_axes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    grad_compress: Optional[str] = None  # None | "int8"


def init_opt_state(params: Mapping[str, torch.Tensor], oc: OptConfig) -> dict:
    """Zero moments in ``oc.state_dtype`` (and a bf16 residual for int8
    compression) beside each parameter, on its device."""
    sd = DTYPES[oc.state_dtype]
    device = next(iter(params.values())).device
    zeros = lambda dt: {k: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                       device=p.device)
                        for k, p in params.items()}
    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": zeros(sd), "v": zeros(sd)}
    if oc.grad_compress == "int8":
        state["err"] = zeros(torch.bfloat16)
    return state


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA and CUDA give it.
    torch's vectorised CPU sqrt is 1 ulp off for ~0.7% of f32 inputs; on
    the CPU the f64 root rounded once to f32 is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _axes(specs, mesh, key) -> tuple:
    """The mesh axes leaf ``key`` is split over (none off a mesh)."""
    return () if mesh is None else sharded_axes(specs[key])


def _global_norm(tree: Mapping[str, torch.Tensor], specs=None,
                 mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares, leaf sums added in the reference's
    leaf order (``jax_leaves``; a group-stacked leaf's groups summed
    first). On a mesh each shard's sum is first summed over the axes its
    leaf is split on, one all-reduce for the leaves split alike."""
    order = [k for keys in jax_leaves(tree) for k in keys]
    sums = {}
    for k in order:
        x = tree[k].float()
        sums[k] = torch.sum(x * x)
    split: dict = {}
    for k in order:
        axes = _axes(specs, mesh, k)
        if axes:
            split.setdefault(axes, []).append(k)
    for axes, keys in split.items():
        total = mesh.all_reduce(torch.stack([sums[k] for k in keys]), axes)
        sums.update(zip(keys, total))
    total = None
    for k in order:
        total = sums[k] if total is None else total + sums[k]
    return _sqrt(total)


def quantize_int8(g: torch.Tensor, err: torch.Tensor, amax=None):
    """Error-feedback int8 quantization of one gradient leaf: returns the
    dequantized f32 gradient and the bf16 residual it left behind.
    ``amax`` (a leaf split over a mesh) reduces the shard's max |g| to
    the leaf's."""
    g = g.float() + err.float()
    top = torch.max(torch.abs(g))
    if amax is not None:
        top = amax(top)
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds otherwise than JAX's division.
    scale = torch.clamp_min(top, 1e-12) / torch.full(
        (), 127.0, device=g.device)
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, (g - deq).to(torch.bfloat16)


def _quantize_leaves(grads, err, specs=None, mesh=None):
    """``quantize_int8`` per reference leaf: the groups of a stacked leaf
    share one scale, as the reference quantizes the stacked array."""
    deq, res = {}, {}
    for keys in jax_leaves(grads):
        axes = _axes(specs, mesh, keys[0])
        amax = ((lambda t, axes=axes: mesh.all_reduce(t, axes, "max"))
                if axes else None)
        if len(keys) == 1:
            deq[keys[0]], res[keys[0]] = quantize_int8(grads[keys[0]],
                                                       err[keys[0]], amax)
            continue
        d, r = quantize_int8(torch.stack([grads[k] for k in keys]),
                             torch.stack([err[k] for k in keys]), amax)
        for i, k in enumerate(keys):
            deq[k], res[k] = d[i], r[i]
    return deq, res


def adamw_step(params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: Mapping,
               oc: OptConfig, specs=None, mesh=None) -> torch.Tensor:
    """One AdamW step written into the tensors of ``params`` and
    ``state`` (so a step holds no second copy of the parameters and
    moments); returns the gradient norm the clip read. On a mesh the
    tensors are this rank's shards, cut as ``specs`` says."""
    if oc.grad_compress == "int8":
        grads, err = _quantize_leaves(grads, state["err"], specs, mesh)
        for k, e in err.items():
            state["err"][k].copy_(e)

    gnorm = _global_norm(grads, specs, mesh)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    clip = torch.minimum(one, (one * oc.grad_clip)
                         / torch.clamp_min(gnorm, 1e-12))
    step = state["step"] + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(one * oc.b1, stepf)
    bc2 = 1.0 - torch.pow(one * oc.b2, stepf)

    for k, p in params.items():
        g = grads[k].float() * clip
        m32 = oc.b1 * state["m"][k].float() + (1 - oc.b1) * g
        v32 = oc.b2 * state["v"][k].float() + (1 - oc.b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (_sqrt(vh) + oc.eps) + oc.weight_decay * p.float()
        # copy_ rounds to the tensor's dtype as the reference's astype.
        p.copy_(p.float() - oc.lr * delta)
        state["m"][k].copy_(m32)
        state["v"][k].copy_(v32)
    state["step"].copy_(step)
    return gnorm


def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: Mapping,
                  oc: OptConfig):
    """One AdamW step, the reference's signature: returns (params,
    state), the same dicts, their tensors updated in place."""
    adamw_step(params, grads, state, oc)
    return params, state
