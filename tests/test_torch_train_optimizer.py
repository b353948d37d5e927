"""The port's AdamW, int8 gradient compression and router histogram held
against the JAX reference (``repro.train.optimizer``,
``repro.train.router_stats``) on the CPU.

* ``apply_updates`` over 3 consecutive steps with f32 state, bf16 state,
  int8 compression with error feedback, and int8 with bf16 state and a
  clip of 0.3, on a tree with a group-stacked leaf (two groups) and
  leaves outside the groups: bitwise (parameters, m, v, err, step) while
  the gradients' norm stays under the clip. With clipped gradients the
  global norm sums in another order, so the clip factor may differ in
  its last bit: with f32 state, parameters (|p| < 0.5) within 6e-8 (two
  f32 ulps; measured 3.7e-9) and m / v within 1e-6 / 2e-6 of a leaf's
  largest entry (measured 7.5e-9 on m); with bf16 state, a moment may
  round one bf16 step apart, so m and v within 2^-8 of the leaf's
  largest entry and parameters within lr·2^-7 (one such step of an
  update; measured 3.0e-8).
* ``quantize_int8`` bitwise, half-way cases rounded to even; a
  group-stacked leaf quantized with one scale over its groups.
* ``_global_norm`` within 1e-6 relative (sums in other orders; measured
  2.2e-7 over 1,552 entries).
* The state's layout: ``opt_state_to_jax`` has the reference's pytree
  structure, and it crosses back (``opt_state_from_tree``) unchanged.
* The reference's own optimizer tests (bf16 state dtype, error feedback
  converging), and ``router_stats`` equal to the reference's.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.models.config import scaled_down as r_scaled_down  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro.train import optimizer as R  # noqa: E402
from repro.train.router_stats import router_stats as r_router_stats  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import (jax_leaves,  # noqa: E402
                                      opt_state_from_tree, opt_state_to_jax,
                                      opt_state_to_tree, params_from_jax,
                                      params_to_jax)
from repro_torch.train import optimizer as P  # noqa: E402
from repro_torch.train.router_stats import router_stats  # noqa: E402

SHAPES = {"embed": (64, 16), "final_norm.scale": (16,),
          "layers.0.l0b0_attn.block.wq": (16, 2, 8),
          "layers.1.l0b0_attn.block.wq": (16, 2, 8),
          "layers.0.l0b0_attn.norm.scale": (16,),
          "layers.1.l0b0_attn.norm.scale": (16,),
          "lm_head": (16, 64)}
CASES = {
    "f32": {},
    "bf16_state": {"state_dtype": "bfloat16"},
    "int8": {"grad_compress": "int8"},
    "int8_bf16_clip": {"grad_compress": "int8", "state_dtype": "bfloat16",
                       "grad_clip": 0.3},
}
# Clipped steps: (parameters absolute, m and v relative to a leaf's
# largest entry), by state dtype.
CLIPPED = {"float32": (6e-8, 1e-6, 2e-6),
           "bfloat16": (3e-4 * 2 ** -7, 2 ** -8, 2 ** -8)}


def _tree(d: dict) -> dict:
    """A flat dict keyed like the port's state dict as the reference's
    pytree, the two groups stacked."""
    def stack(w, part):
        return np.stack([d[f"layers.{g}.l0b0_attn.{part}.{w}"]
                         for g in (0, 1)])

    return {"embed": d["embed"], "final_norm": {"scale": d["final_norm.scale"]},
            "lm_head": d["lm_head"],
            "groups": {"l0b0_attn": {"block": {"wq": stack("wq", "block")},
                                     "norm": {"scale": stack("scale",
                                                             "norm")}}}}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _compare(got: dict, ref, atol=0.0, rel=None):
    for g, r in zip(jax.tree.leaves(_tree({k: _np(v) for k, v in got.items()})),
                    jax.tree.leaves(ref), strict=True):
        r = _f32(r)
        tol = atol if rel is None else rel * float(np.abs(r).max())
        if tol == 0.0:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=tol)


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_updates_matches_reference(case, clipped):
    kw = CASES[case]
    rng = np.random.default_rng(len(case) + 10 * clipped)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in SHAPES.items()}
    roc, oc = R.OptConfig(**kw), P.OptConfig(**kw)
    rp = jax.tree.map(jnp.asarray, _tree(p))
    rs = R.init_opt_state(rp, roc)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = P.init_opt_state(tp, oc)
    for _ in range(3):
        # Magnitudes over nine decades; under the clip's norm, or far above.
        scale = 1.0 if clipped else 1e-3
        g = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-9, 0, s)
                 * scale).astype(np.float32) for k, s in SHAPES.items()}
        rg = jax.tree.map(jnp.asarray, _tree(g))
        assert (float(R._global_norm(rg)) > oc.grad_clip) == clipped
        rp, rs = R.apply_updates(rp, rg, rs, roc)
        tp, ts = P.apply_updates(tp, {k: torch.from_numpy(v)
                                      for k, v in g.items()}, ts, oc)
        assert int(ts["step"]) == int(rs["step"])
        assert ts["m"]["embed"].dtype == P.DTYPES[oc.state_dtype]
        if clipped:
            tol_p, tol_m, tol_v = CLIPPED[oc.state_dtype]
            _compare(tp, rp, atol=tol_p)
            _compare(ts["m"], rs["m"], rel=tol_m)
            _compare(ts["v"], rs["v"], rel=tol_v)
        else:
            for key in ("m", "v"):
                _compare(ts[key], rs[key])
            _compare(tp, rp)
        if "err" in rs:
            assert ts["err"]["embed"].dtype == torch.bfloat16
            _compare(ts["err"], rs["err"], rel=0.0 if not clipped else 1e-6)


def test_apply_updates_in_place():
    """The step writes into the tensors it is given and returns them;
    ``adamw_step`` returns the norm the clip read."""
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(
        np.float32)) for k, s in SHAPES.items()}
    g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in SHAPES.items()}
    oc = P.OptConfig(grad_compress="int8")
    before = {k: v.clone() for k, v in p.items()}
    st = P.init_opt_state(p, oc)
    tensors = {key: dict(st[key]) for key in ("m", "v", "err")}
    out_p, out_s = P.apply_updates(p, g, st, oc)
    assert out_p is p and out_s is st and int(st["step"]) == 1
    for k in p:
        assert not torch.equal(p[k], before[k])
        for key in ("m", "v", "err"):
            assert st[key][k] is tensors[key][k]
    st2 = P.init_opt_state(p, P.OptConfig())
    gnorm = P.adamw_step(p, g, st2, P.OptConfig())
    assert torch.equal(gnorm, P._global_norm(g))


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(1)
    # |g|max = 127 makes the scale 1, so the half-way cases stay exact.
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.49], np.float32)
    for g in (ties, rng.standard_normal((33, 7)).astype(np.float32) * 1e-3):
        err = (rng.standard_normal(g.shape) * 1e-5).astype(np.float32)
        r_deq, r_err = R.quantize_int8(jnp.asarray(g),
                                       jnp.asarray(err, jnp.bfloat16))
        deq, res = P.quantize_int8(torch.from_numpy(g),
                                   torch.from_numpy(err).to(torch.bfloat16))
        np.testing.assert_array_equal(deq.numpy(), np.asarray(r_deq))
        np.testing.assert_array_equal(_np(res), _f32(r_err))
    # A stacked leaf shares one scale over its groups.
    big = {"layers.0.l0b0_attn.block.wq": torch.full((2,), 0.5),
           "layers.1.l0b0_attn.block.wq": torch.full((2,), 127.0)}
    zeros = {k: torch.zeros(2, dtype=torch.bfloat16) for k in big}
    deq, _ = P._quantize_leaves(big, zeros)
    assert deq["layers.0.l0b0_attn.block.wq"].tolist() == [0.0, 0.0]
    assert jax_leaves(big) == [sorted(big)]


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    ref = float(R._global_norm(jax.tree.map(jnp.asarray, _tree(g))))
    got = float(P._global_norm({k: torch.from_numpy(v)
                                for k, v in g.items()}))
    assert abs(got - ref) <= 1e-6 * ref


@pytest.mark.parametrize("kw", [{}, {"grad_compress": "int8",
                                     "state_dtype": "bfloat16"}])
def test_opt_state_layout_and_crossing(kw):
    rc = r_scaled_down(r_get_config("recurrentgemma-2b"))
    pc = scaled_down(get_config("recurrentgemma-2b"))
    params = r_init_params(jax.random.key(0), rc)
    r_state = R.init_opt_state(params, R.OptConfig(**kw))
    state = params_from_jax(jax.tree.map(np.asarray, params), pc)
    back = params_to_jax(state, pc)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    opt = P.init_opt_state(state, P.OptConfig(**kw))
    assert (jax.tree.structure(opt_state_to_jax(opt, pc))
            == jax.tree.structure(r_state))
    for a, b in zip(jax.tree.leaves(opt_state_to_tree(opt, pc)),
                    jax.tree.leaves(r_state)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    # Crossing back keeps every leaf, its dtype included.
    opt["err" if "err" in opt else "m"]["embed"].fill_(0.3)
    again = opt_state_from_tree(opt_state_to_tree(opt, pc), pc)
    for key in opt:
        if key == "step":
            assert torch.equal(again[key], opt[key])
            continue
        assert set(again[key]) == set(opt[key])
        for k, t in opt[key].items():
            assert again[key][k].dtype == t.dtype and torch.equal(
                again[key][k], t)


def test_adamw_state_dtype_bf16():
    """The reference's ``test_adamw_state_dtype_bf16``, ported (the step
    updates ``params`` in place, so the start is kept apart)."""
    params = {"w": torch.ones((8, 8))}
    oc = P.OptConfig(state_dtype="bfloat16")
    st = P.init_opt_state(params, oc)
    assert st["m"]["w"].dtype == torch.bfloat16
    p2, st2 = P.apply_updates(params, {"w": torch.full((8, 8), 0.1)}, st, oc)
    assert st2["m"]["w"].dtype == torch.bfloat16
    assert float((p2["w"] - torch.ones((8, 8))).abs().sum()) > 0


def test_int8_grad_compression_error_feedback():
    """The reference's error-feedback test, ported: the residual carries
    what quantization lost, and the running mean converges."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)) * 1e-3)
    deq1, err1 = P.quantize_int8(g, torch.zeros(64, dtype=torch.bfloat16))
    np.testing.assert_allclose((deq1 + err1.float()).numpy(), g.numpy(),
                               atol=1e-5)
    acc = torch.zeros(64)
    err = torch.zeros(64, dtype=torch.bfloat16)
    for _ in range(32):
        deq, err = P.quantize_int8(g, err)
        acc += deq
    np.testing.assert_allclose((acc / 32).numpy(), g.numpy(),
                               atol=float(g.abs().max()) * 0.05)


@pytest.mark.parametrize("capacity", [None, 5])
def test_router_stats_matches_reference(capacity):
    rc = r_scaled_down(r_get_config("olmoe-1b-7b"))
    pc = scaled_down(get_config("olmoe-1b-7b"))
    gate_e = np.random.default_rng(3).integers(
        0, pc.n_experts, (40, pc.experts_per_token)).astype(np.int32)
    got = router_stats(gate_e, pc, capacity)
    ref = r_router_stats(gate_e, rc, capacity)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got.pop("loads"), ref.pop("loads"))
    assert got == ref
