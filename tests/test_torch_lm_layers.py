"""The port's LM configs and dense layers held against the JAX reference.

* Configs: every ``ARCH_IDS`` entry equal field by field, with equal
  ``param_count`` / ``active_param_count``; ``shapes`` equal.
* Layers: RMSNorm, RoPE, the three MLP types, and attention under GQA
  (llama), MQA (gemma) and MHA: prefill with and without a window and a
  cache, several online-softmax blocks, scalar decode, per-row decode and
  the sliding-window ring.

The whole model is ``test_torch_lm_model.py``'s. Inputs and weights come
from numpy seeds and the reference's initialisers. Tolerances: at f32,
1e-5 absolute on values of order 1 (the two packages sum in other
orders; RoPE 2e-5, its sin/cos of angles up to 600 rad differing by
ulps); at bf16, the MLP and attention outputs within 2^-6 relative +
0.02 absolute of the reference's (bf16 rounds at other places in the two
frameworks), RMSNorm and RoPE within one bf16 step (2^-7); caches and
positions at f32 within 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as R_ARCH_IDS  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import shapes as r_shapes  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.config import scaled_down as r_scaled_down  # noqa: E402
from repro_torch.configs import ALIASES, ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402

CTX = RL.ShardCtx()
F32_TOL = 1e-5


def _cfgs(arch, **kw):
    return (r_scaled_down(r_get_config(arch), **kw),
            scaled_down(get_config(arch), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", R_ARCH_IDS)
def test_configs_equal(arch):
    r, p = r_get_config(arch), get_config(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert p.param_count() == r.param_count()
    assert p.active_param_count() == r.active_param_count()
    rs, ps = r_scaled_down(r), scaled_down(p)
    assert dataclasses.asdict(rs) == dataclasses.asdict(ps)
    assert ps.param_count() == rs.param_count()
    for name in r_shapes.SHAPES:
        assert shapes.applicable(p, name) == r_shapes.applicable(r, name)


def test_registry_and_shapes():
    assert ARCH_IDS == R_ARCH_IDS
    for alias, arch in ALIASES.items():
        assert get_config(alias) == get_config(arch)
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_shapes.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-5")


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    xr = jnp.asarray(x, dtype)
    xt = _t(x).to(L.DTYPES[dtype])
    ref = RL.apply_rmsnorm({"scale": jnp.asarray(scale)}, xr)
    got = L.apply_rmsnorm({"scale": _t(scale)}, xt)
    assert got.dtype == L.DTYPES[dtype]
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), rtol=rel,
                               atol=rel)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        ref = RL.rope(xr, jnp.asarray(pos), theta)
        got = L.rope(xt, _t(pos), theta)
        # sin/cos of angles up to 600 rad differ by ulps between the two
        # libraries: 2e-5 absolute at f32.
        tol = 2e-5 if dtype == "float32" else 2.0 ** -7
        np.testing.assert_allclose(got.float().numpy(), _f32(ref),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,mlp_type", [("llama3_2-1b", "swiglu"),
                                           ("gemma-2b", "geglu"),
                                           ("granite-20b", "gelu")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(arch, mlp_type, dtype):
    rc, pc = _cfgs(arch, dtype=dtype)
    assert pc.mlp_type == mlp_type
    p = _np_tree(RL.init_mlp(jax.random.key(3), rc))
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(
        np.float32)
    ref = _f32(RL.apply_mlp(p, jnp.asarray(x, dtype), rc, CTX))
    got = L.apply_mlp({k: _t(v) for k, v in p.items()},
                      _t(x).to(L.DTYPES[dtype]), pc).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -6, atol=2e-2)


ATTN_CASES = {
    "gqa": ("llama3_2-1b", {}),             # 4 query heads, 2 kv heads
    "mqa": ("gemma-2b", {}),                # 4 query heads, 1 kv head
    "mha": ("musicgen-medium", {"n_kv_heads": 4}),
}


def _attn_setup(case, dtype="float32", **kw):
    arch, over = ATTN_CASES[case]
    rc, pc = _cfgs(arch, dtype=dtype, **over, **kw)
    p = _np_tree(RL.init_attn(jax.random.key(5), rc))
    return rc, pc, p, {k: _t(v) for k, v in p.items()}


def _same_cache(got: dict, ref: dict):
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(
            got[key].float().numpy() if key != "pos" else got[key].numpy(),
            _f32(ref[key]) if key != "pos" else np.asarray(ref[key]),
            rtol=F32_TOL, atol=F32_TOL, err_msg=key)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("window", [0, 8])
def test_attn_prefill(case, window):
    rc, pc, p, pt = _attn_setup(case)
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(
        np.float32)
    for want_cache, s_alloc in ((False, 0), (True, 40)):
        ref_y, ref_c = RL.apply_attn(p, jnp.asarray(x), rc, CTX,
                                     window=window, want_cache=want_cache,
                                     s_alloc=s_alloc)
        y, c = L.apply_attn(pt, _t(x), pc, window=window,
                            want_cache=want_cache, s_alloc=s_alloc)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                   rtol=F32_TOL, atol=F32_TOL)
        if want_cache:
            # window 8 keeps a ring of 8 slots; otherwise s_alloc slots
            assert c["k"].shape[1] == (8 if window else 40)
            _same_cache(c, ref_c)
        else:
            assert c is None and ref_c is None


@pytest.mark.parametrize("window", [0, 8])
def test_attn_online_softmax_blocks(window):
    """Several q and kv blocks (chunks of 8 and 16 over 32 positions)
    against the reference at the same chunks and at one block."""
    rc, pc, p, pt = _attn_setup("gqa")
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    ref_y, _ = RL.apply_attn(p, jnp.asarray(x), rc, CTX, window=window,
                             chunk_q=8, chunk_kv=16)
    y, _ = L.apply_attn(pt, _t(x), pc, window=window, chunk_q=8,
                        chunk_kv=16)
    one, _ = L.apply_attn(pt, _t(x), pc, window=window)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), one.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


def test_attn_rejects_ragged_long_prompt():
    """Prompts above 512 must be multiples of 512, as the reference
    asserts."""
    rc, pc, p, pt = _attn_setup("gqa")
    x = torch.zeros((1, 600, 64))
    with pytest.raises(ValueError, match="multiple"):
        L.apply_attn(pt, x, pc)
    with pytest.raises(AssertionError):
        RL.apply_attn(p, jnp.zeros((1, 600, 64)), rc, CTX)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_decode_scalar(case, dtype):
    """Three decode steps at scalar cur_index from a prefill cache the
    reference wrote: outputs and the updated cache."""
    rc, pc, p, pt = _attn_setup(case, dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    _, ref_c = RL.apply_attn(p, jnp.asarray(x, dtype), rc, CTX,
                             want_cache=True, s_alloc=16)
    cache = {k: _t(np.asarray(jnp.asarray(v, jnp.float32))).to(
        L.DTYPES[dtype]) if k != "pos" else _t(v) for k, v in ref_c.items()}
    for i in range(3):
        xt = rng.standard_normal((2, 1, 64)).astype(np.float32)
        pos = np.full((2, 1), 12 + i, np.int32)
        ref_y, ref_c = RL.apply_attn(
            p, jnp.asarray(xt, dtype), rc, CTX, cache=ref_c,
            cur_index=jnp.int32(12 + i), positions=jnp.asarray(pos))
        y, cache = L.apply_attn(pt, _t(xt).to(L.DTYPES[dtype]), pc,
                                cache=cache, cur_index=12 + i,
                                positions=_t(pos))
        if dtype == "float32":
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                       rtol=F32_TOL, atol=F32_TOL)
            _same_cache(cache, ref_c)
        else:
            np.testing.assert_allclose(y.float().numpy(), _f32(ref_y),
                                       rtol=2.0 ** -6, atol=2e-2)
            np.testing.assert_array_equal(cache["pos"].numpy(),
                                          np.asarray(ref_c["pos"]))


@pytest.mark.parametrize("window", [0, 6])
def test_attn_decode_per_row(window):
    """Per-row decode (pos [B, alloc], cur_index [B]): rows at different
    timelines, each writing its own ring slot; with a window of 6 over 6
    slots the ring wraps."""
    rc, pc, p, pt = _attn_setup("gqa", window=window)
    rng = np.random.default_rng(5)
    B, alloc = 3, 6 if window else 20
    kv = rc.n_kv_heads
    ck = rng.standard_normal((B, alloc, kv, 16)).astype(np.float32)
    cv = rng.standard_normal((B, alloc, kv, 16)).astype(np.float32)
    cpos = np.full((B, alloc), -1, np.int32)
    ci = np.array([3, 9, 14], np.int32)
    for b, n in enumerate(ci):           # row b holds positions < ci[b]
        for t in range(max(0, n - alloc), n):
            cpos[b, t % alloc] = t
    ref_c = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
             "pos": jnp.asarray(cpos)}
    cache = {"k": _t(ck), "v": _t(cv), "pos": _t(cpos)}
    for step in range(4):
        xt = rng.standard_normal((B, 1, 64)).astype(np.float32)
        pos = (ci + step)[:, None]
        ref_y, ref_c = RL.apply_attn(
            p, jnp.asarray(xt), rc, CTX, window=window, cache=ref_c,
            cur_index=jnp.asarray(ci + step), positions=jnp.asarray(pos))
        y, cache = L.apply_attn(pt, _t(xt), pc, window=window, cache=cache,
                                cur_index=_t(ci + step), positions=_t(pos))
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                   rtol=F32_TOL, atol=F32_TOL)
        _same_cache(cache, ref_c)


def test_init_attn_cache_and_shapes():
    rc, pc = _cfgs("gemma-2b")
    for window in (0, 8):
        ref = RL.init_attn_cache(rc, 3, 20, window)
        got = L.init_attn_cache(pc, 3, 20, window)
        for key in ("k", "v", "pos"):
            assert tuple(got[key].shape) == ref[key].shape
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          _f32(ref[key]))
    gen = torch.Generator().manual_seed(0)
    for name, fn, rfn in (("attn", L.init_attn, RL.init_attn),
                          ("mlp", L.init_mlp, RL.init_mlp)):
        got = fn(gen, pc)
        ref = rfn(jax.random.key(0), rc)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in ref.items()}, name
