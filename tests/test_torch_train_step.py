"""The port's loss, gradients and train step held against the JAX
reference (``repro.train.steps``) on the CPU.

* ``loss_fn``, its gradients (every leaf) and their global norm (within
  1e-6 relative) for scaled-down llama3.2-1b
  (dense), olmoe-1b-7b (MoE, with the aux loss), recurrentgemma-2b
  (RG-LRU + local attention) and xlstm-125m (mLSTM + sLSTM): remat off
  with the whole logits, remat on with ``loss_chunk=8``; and ``"save_tp"``
  and ``True`` against no remat in the port, bitwise.
* ``train_step`` for the four: one microbatch with remat (the launcher's
  call), and two microbatches with ``"save_tp"`` and ``loss_chunk=8``:
  loss, ce, step, the new parameters and both moments.
* ``forward`` and ``forward_trunk``'s (x, aux), the MoE aux loss.

recurrentgemma-2b and xlstm-125m are cut to one group of their two block
kinds (2 layers), as the card-against-CPU runs cut them, so each jit of
the reference's step stays a few seconds. Weights come from the
reference's ``init_params(jax.random.key(0), ...)`` (jitted) through
``params_from_jax``; tokens from numpy seeds. All at f32 compute.

Tolerances: loss and ce within 2e-6 absolute (measured <= 9.6e-7 on
losses of 5-6: sums in other orders); each gradient leaf within 1e-5 of
its largest entry (measured <= 1.7e-6); the moments within 1e-5 (m) and
2e-5 (v) of the leaf's largest entry (m = 0.1·clip·g, v = 0.05·(clip·g)²).
The new parameters within 1e-7 wherever the reference's |m| >= 1e-7
(|g| >= ~1e-6): there an AdamW step g/(|g| + 1e-8) moves by < 1e-5 of
lr for the gradients' differences; where a gradient is within ~100 eps
of 0 its step depends on its last bits, and is held only to the step's
range, lr·(1 + wd·|p|) (measured: 5.5e-5 at most, recurrentgemma).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.model import forward as r_forward  # noqa: E402
from repro.models.model import forward_trunk as r_forward_trunk  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro.train.optimizer import OptConfig as ROptConfig  # noqa: E402
from repro.train.optimizer import _global_norm as r_global_norm  # noqa: E402
from repro.train.optimizer import init_opt_state as r_init_opt  # noqa: E402
from repro.train.steps import loss_fn as r_loss_fn  # noqa: E402
from repro.train.steps import train_step as r_train_step  # noqa: E402
from repro_torch.models.model import (LM, opt_state_to_jax,  # noqa: E402
                                      params_from_jax, params_to_jax)
from repro_torch.train.optimizer import (OptConfig,  # noqa: E402
                                         _global_norm, init_opt_state)
from repro_torch.train.steps import (AUX_WEIGHT, loss_fn,  # noqa: E402
                                     make_train_step, train_step)
from test_torch_lm_layers import CTX, _cfgs, _np_tree, _t  # noqa: E402

ARCHS = ["llama3_2-1b", "olmoe-1b-7b", "recurrentgemma-2b", "xlstm-125m"]
CUTS = {
    "recurrentgemma-2b": dict(n_layers=2, block_pattern=(
        ("rglru", "mlp"), ("local_attn", "mlp"))),
    "xlstm-125m": dict(n_layers=2, block_pattern=(("mlstm",), ("slstm",))),
}
LOSS_TOL = 2e-6
GRAD_REL = 1e-5
M_REL, V_REL = 1e-5, 2e-5
PARAM_TOL = 1e-7
M_FLOOR = 1e-7


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        rc, pc = _cfgs(arch, dtype="float32", **CUTS.get(arch, {}))
        params = jax.jit(r_init_params, static_argnums=1)(
            jax.random.key(0), rc)
        out[arch] = (rc, pc, params, params_from_jax(_np_tree(params), pc))
    return out


def _lm(pc, state):
    """A trainable model on a copy of ``state``: a step updates its
    parameters in place."""
    return LM(pc, {k: v.clone() for k, v in state.items()}, trainable=True)


def _tokens(rc, seed=3, shape=(4, 32)):
    toks = np.random.default_rng(seed).integers(
        0, rc.vocab_size, shape).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": _t(toks), "labels": _t(toks)})


def _leaves(tree):
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in jax.tree.leaves(tree)]


def _rel_close(got_tree, ref_tree, rel, what):
    got, ref = _leaves(got_tree), _leaves(ref_tree)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= rel * scale, (what, i)


def _port_grads(lm, batch, remat, chunk):
    named = dict(lm.named_parameters())
    loss, ce = loss_fn(lm, batch, remat, chunk)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), ce.detach(), dict(zip(named, grads))


@pytest.mark.parametrize("remat,chunk", [(False, 0), (True, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch, remat, chunk):
    rc, pc, params, state = models[arch]
    rb, pb = _tokens(rc)
    (r_loss, r_ce), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_loss_fn(p, b, rc, CTX, remat, chunk),
        has_aux=True))(params, rb)
    lm = _lm(pc, state)
    loss, ce, grads = _port_grads(lm, pb, remat, chunk)
    assert abs(float(loss) - float(r_loss)) <= LOSS_TOL
    assert abs(float(ce) - float(r_ce)) <= LOSS_TOL
    if pc.n_experts:
        assert float(loss) - float(ce) > 0  # the aux loss takes part
    _rel_close(params_to_jax(grads, pc), r_grads, GRAD_REL, "grad")
    # The clip's norm, leaf sums added in the reference's leaf order.
    r_norm = float(r_global_norm(r_grads))
    assert abs(float(_global_norm(grads)) - r_norm) <= 1e-6 * r_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(models, arch):
    """Remat (per group, or per block for ``"save_tp"``) recomputes
    activations and nothing else: loss and gradients bitwise."""
    rc, pc, _, state = models[arch]
    _, pb = _tokens(rc)
    runs = [_port_grads(_lm(pc, state), pb, remat, 0)
            for remat in (False, True, "save_tp")]
    for loss, ce, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(ce, runs[0][1])
        for k, g in grads.items():
            assert torch.equal(g, runs[0][2][k]), k


def _check_step(pc, lm, opt, metrics, r_new, r_opt, r_metrics, oc):
    assert abs(float(metrics["loss"]) - float(r_metrics["loss"])) <= LOSS_TOL
    assert abs(float(metrics["ce"]) - float(r_metrics["ce"])) <= LOSS_TOL
    assert int(metrics["step"]) == int(r_metrics["step"]) == 1
    assert float(metrics["grad_norm"]) > 0
    got_opt = opt_state_to_jax(opt, pc)
    _rel_close(got_opt["m"], r_opt["m"], M_REL, "m")
    _rel_close(got_opt["v"], r_opt["v"], V_REL, "v")
    got_p = _leaves(params_to_jax(lm.state_dict(), pc))
    ref_p, ref_m = _leaves(r_new), _leaves(r_opt["m"])
    for i, (g, r, m) in enumerate(zip(got_p, ref_p, ref_m)):
        diff = np.abs(g - r)
        live = np.abs(m) >= M_FLOOR
        assert float(diff[live].max(initial=0.0)) <= PARAM_TOL, i
        step_range = oc.lr * (1 + oc.weight_decay * np.abs(r)) * 2
        assert (diff <= step_range).all(), i


@pytest.mark.parametrize("nmb,remat,chunk", [(1, True, 0), (2, "save_tp", 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(models, arch, nmb, remat, chunk):
    rc, pc, params, state = models[arch]
    rb, pb = _tokens(rc, seed=4)
    roc, oc = ROptConfig(), OptConfig()
    r_new, r_opt, r_metrics = jax.jit(
        lambda p, o, b: r_train_step(p, o, b, rc, CTX, roc,
                                     n_microbatches=nmb, remat=remat,
                                     loss_chunk=chunk))(
        params, r_init_opt(params, roc), rb)
    lm = _lm(pc, state)
    opt = init_opt_state(dict(lm.named_parameters()), oc)
    same, opt2, metrics = train_step(lm, opt, pb, oc, n_microbatches=nmb,
                                     remat=remat, loss_chunk=chunk)
    assert same is lm and opt2 is opt
    _check_step(pc, lm, opt, metrics, r_new, r_opt, r_metrics, oc)


def test_make_train_step_and_grad_shardings(models, tmp_path):
    """``grad_shardings`` on a one-rank mesh (``gloo``, this process):
    the parameters' shardings give the unsharded step bitwise; another
    layout, or shardings without a mesh, raise."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import make_ctx, to_shardings

    rc, pc, _, state = models["llama3_2-1b"]
    _, pb = _tokens(rc)
    lm = _lm(pc, state)
    opt = init_opt_state(dict(lm.named_parameters()), OptConfig())
    step = make_train_step(OptConfig(), n_microbatches=2, remat="save_tp")
    _, _, metrics = step(lm, opt, pb)
    assert int(metrics["step"]) == 1 and torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="needs a model sharded"):
        train_step(_lm(pc, state), opt, pb, OptConfig(), grad_shardings={})
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ctx = make_ctx(make_host_mesh("cpu"))
        sharded = _lm(pc, state).shard(ctx)
        opt2 = init_opt_state(dict(sharded.named_parameters()), OptConfig())
        shardings = to_shardings(sharded.specs, ctx.mesh)
        _, _, m2 = step(sharded, opt2, pb, ctx=ctx, grad_shardings=shardings)
        for k in ("loss", "ce", "grad_norm"):
            assert torch.equal(m2[k], metrics[k]), k
        for k, p in lm.state_dict().items():
            assert torch.equal(sharded.state_dict()[k], p), k
            assert torch.equal(opt2["m"][k], opt["m"][k]), k
        wrong = dict(shardings, embed=(None, None))
        with pytest.raises(ValueError, match="parameter's spec"):
            train_step(sharded, opt2, pb, OptConfig(), grad_shardings=wrong)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama3_2-1b", "olmoe-1b-7b"])
def test_forward_and_trunk_match_reference(models, arch):
    """``forward``'s (logits, aux) and ``forward_trunk``'s (x, aux) under
    remat; olmoe's aux is the load-balance loss of its MoE layers."""
    rc, pc, params, state = models[arch]
    rb, pb = _tokens(rc, seed=5, shape=(2, 16))
    r_logits, _, r_aux = jax.jit(lambda p, t: r_forward(
        p, rc, CTX, tokens=t, remat=True))(params, rb["tokens"])
    r_x, r_aux2 = jax.jit(lambda p, t: r_forward_trunk(
        p, rc, CTX, tokens=t, remat=True))(params, rb["tokens"])
    lm = _lm(pc, state)
    with torch.no_grad():
        logits, cache, aux = lm(tokens=pb["tokens"], remat=True)
        x, aux2 = lm.forward_trunk(tokens=pb["tokens"], remat=True)
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(r_x),
                               rtol=0, atol=1e-5)
    for got, ref in ((aux, r_aux), (aux2, r_aux2)):
        assert abs(float(got) - float(ref)) <= 1e-6
    if pc.n_experts:
        assert float(aux) > 0
        # The loss adds it with the reference's weight.
        with torch.no_grad():
            loss, ce = loss_fn(lm, pb, remat=False)
        assert torch.allclose(loss - ce, AUX_WEIGHT * aux, atol=1e-6)
    else:
        assert float(aux) == 0.0
