"""The port's MoE block and MoE serving held against the JAX reference.

* ``moe_capacity`` equal to the reference's ``_moe_capacity`` over a grid
  of token counts, at the published and the reduced configs.
* ``apply_moe`` of the scaled-down olmoe-1b-7b and kimi-k2-1t-a32b: equal
  router choices (``gate_e``) and router logits, outputs at f32 and bf16.
* A call that forces capacity drops (48 identical rows routed to the same
  two experts, capacity 24): the choices each package drops are equal
  (the reference's read from its own ``_moe_bucketed`` with one-hot gate
  weights), fully dropped tokens give zero rows, the outputs agree.
* The engine's tokens rid by rid against ``repro.serve.engine.Engine`` in
  waves of 4 and through 3 continuous slots, per mode: the capacity comes
  from each call's token count, so the two modes may give different
  tokens, and each is held to the reference's same mode.

Weights come from the reference's initialisers, carried across; inputs
from numpy seeds. Tolerances: at f32 compute, 1e-5 absolute on outputs
and logits of order 1 (measured <= 4.8e-7: the packages sum in other
orders); at bf16, 2^-6 relative + 0.02 absolute (measured 0.0156, one
bf16 step at 2.47: bf16 rounds at other places in the two frameworks).
Engine tokens at f32 equal exactly, rid by rid.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro.serve import engine as r_engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import LM, params_from_jax  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from test_torch_lm_layers import CTX, F32_TOL, _cfgs, _f32, _np_tree  # noqa: E402

MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
STAT_KEYS = ("requests", "mode", "waves", "completed", "tokens",
             "decode_steps", "prefills")


def _moe_setup(arch, dtype):
    rc, pc = _cfgs(arch, dtype=dtype)
    p = RL.init_moe(jax.random.key(3), rc)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in _np_tree(p).items()}
    return rc, pc, p, pt


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_matches_reference(arch):
    for rc, pc in ((r_get_config(arch), get_config(arch)), _cfgs(arch)):
        for n in (1, 2, 7, 8, 9, 12, 31, 64, 100, 511, 512, 4096, 4097,
                  65_536):
            assert L.moe_capacity(n, pc) == RL._moe_capacity(n, rc), n
    # OLMoE's wave prefill (8 x 512 tokens) and a decode step at 8 rows.
    olmoe = get_config("olmoe-1b-7b")
    assert L.moe_capacity(8 * 512, olmoe) == 640
    assert L.moe_capacity(8, olmoe) == 8


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_reference(arch, dtype):
    rc, pc, p, pt = _moe_setup(arch, dtype)
    x = np.random.default_rng(4).standard_normal((2, 32, 64)).astype(
        np.float32)
    ref_y, (ref_logits, ref_e) = RL.apply_moe(
        p, jnp.asarray(x, rc.dtype), rc, CTX)
    y, (logits, gate_e) = L.apply_moe(
        pt, torch.from_numpy(x).to(L.DTYPES[dtype]), pc)
    assert y.dtype == L.DTYPES[dtype] and logits.dtype == torch.float32
    np.testing.assert_array_equal(gate_e.numpy(), np.asarray(ref_e))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0,
                                   atol=F32_TOL)
    else:
        np.testing.assert_allclose(y.float().numpy(), _f32(ref_y),
                                   rtol=2.0 ** -6, atol=2e-2)


def _reference_kept(p, xt, gate_w, gate_e, cap, rc):
    """The reference's own kept choices: its ``_moe_bucketed`` with all
    gate weight on one choice gives a nonzero row exactly where that
    choice holds a capacity slot."""
    kept = np.zeros(gate_e.shape, bool)
    for j in range(gate_e.shape[1]):
        onehot = jnp.zeros_like(gate_w).at[:, j].set(1.0)
        out = RL._moe_bucketed(xt, onehot, gate_e, p["w_gate"], p["w_up"],
                               p["w_down"], cap, 0, jnp.float32)
        kept[:, j] = np.abs(np.asarray(out)).sum(-1) > 0
    return kept


def test_moe_forced_drops_match_reference():
    """48 identical rows all choose the same two experts, whose capacity
    for 64 tokens is 24: the later 24 identical rows lose both."""
    rc, pc, p, pt = _moe_setup("olmoe-1b-7b", "float32")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    x[8:56] = x[8]
    cap = L.moe_capacity(64, pc)
    assert cap == RL._moe_capacity(64, rc) == 24
    xt = jnp.asarray(x)
    logits = xt @ p["router"]
    gw, ge = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    gw = gw / jnp.maximum(gw.sum(-1, keepdims=True), 1e-9)
    ref_kept = _reference_kept(p, xt, gw, ge, cap, rc)

    _, _, gate_e = L.moe_route(torch.from_numpy(x), pt["router"], 2)
    np.testing.assert_array_equal(gate_e.numpy(), np.asarray(ge))
    kept = L.moe_kept(gate_e, cap, pc.n_experts).numpy()
    np.testing.assert_array_equal(kept, ref_kept)
    assert (~kept).sum() >= 48 and (~kept[32:56]).all()

    ref_y, _ = RL.apply_moe(p, xt[None], rc, CTX)
    y, _ = L.apply_moe(pt, torch.from_numpy(x)[None], pc)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(ref_y)[0], rtol=0,
                               atol=F32_TOL)
    gone = ~kept.any(axis=1)
    assert gone.sum() >= 24
    assert (y[0].numpy()[gone] == 0).all()
    assert (np.asarray(ref_y)[0][gone] == 0).all()


@pytest.fixture(scope="module")
def f32_moe():
    out = {}
    for arch in MOE_ARCHS:
        rc, pc = _cfgs(arch, dtype="float32")
        params = r_init_params(jax.random.key(0), rc)
        out[arch] = rc, params, LM(pc, params_from_jax(_np_tree(params), pc))
    return out


def _requests(vocab):
    """(prompt, max_new) per rid: mixed prompt lengths and budgets."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(3, 13, 8)]
    return list(zip(prompts, [9, 2, 5, 1, 7, 3, 6, 10]))


def serve_both(rc, params, lm, requests, **kw):
    """The same requests through the reference's and the port's engine;
    returns (reference stats, outputs by rid), (port stats, outputs)."""
    sc = dict(max_batch=4, max_prompt=12, max_new=10, **kw)
    ref = r_engine.Engine(params, rc, r_engine.ServeConfig(**sc))
    got = Engine(lm, ServeConfig(**sc))
    for rid, (p, mn) in enumerate(requests):
        ref.submit(r_engine.Request(rid=rid, prompt=p, max_new=mn))
        got.submit(Request(rid=rid, prompt=p, max_new=mn))
    rs, gs = ref.run(), got.run()
    return ((rs, {r.rid: r.output for r in ref.done}),
            (gs, {r.rid: r.output for r in got.done}))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_tokens_per_mode(f32_moe, arch):
    """Waves against the reference's waves, slots against its slots. The
    reference's own two modes disagree on some requests here, and the
    port's disagree on the same ones."""
    rc, params, lm = f32_moe[arch]
    requests = _requests(rc.vocab_size)
    outs = {}
    for mode, kw in (("wave", {}),
                     ("continuous", {"continuous": True, "slots": 3})):
        (rs, ro), (gs, go) = serve_both(rc, params, lm, requests, **kw)
        assert {k: gs[k] for k in STAT_KEYS} == {k: rs[k] for k in STAT_KEYS}
        assert sorted(go) == sorted(ro) == list(range(8))
        for rid in ro:
            np.testing.assert_array_equal(go[rid], ro[rid], err_msg=(
                f"{arch} {mode} request {rid}"))
        outs[mode] = go
    same = [rid for rid in range(8)
            if np.array_equal(outs["wave"][rid], outs["continuous"][rid])]
    assert len(same) < 8
