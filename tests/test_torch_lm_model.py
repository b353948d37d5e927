"""The port's LM model (dense family) held against the JAX reference.

* ``forward`` logits of the scaled-down llama3.2-1b, gemma-2b and
  granite-20b at f32 and bf16 compute, and of the serving copy (weights
  cast once), phi-3-vision through ``input_embeds``; gemma's sqrt(d)
  embedding scale rounded to bf16 first.
* Prefill caches (k, v, pos), and caches crossing between the packages
  both ways: a reference prefill cache decoded by the port, a port cache
  decoded by the reference, bf16 caches exactly.
* Decode against forward (the reference's own check), ``init_params`` /
  ``init_cache`` shapes.
* The MoE and recurrent models (scaled-down olmoe-1b-7b, kimi-k2,
  recurrentgemma-2b, xlstm-125m): state dicts and caches of the
  reference's layout, the serving copy keeping the router, ``lam`` and
  ``r_z`` in f32, and prefill + 3 decode steps at f32 (logits and every
  cache leaf), with caches crossing both ways.

Weights come from the reference's ``init_params(jax.random.key(0),
...)``, carried across by ``params_from_jax``; inputs from numpy seeds.
Tolerances: at f32 compute, 1e-5 absolute on logits of order 1 (measured
<= 2.3e-6: the packages sum in other orders); at bf16, 0.06 absolute on
logits of order 1-4 (measured <= 0.028: bf16 rounds at other places in
the two frameworks; the reference's own bf16 bound for decode against
forward is 0.15, ``tests/test_arch_smoke.py``); caches at f32 within
1e-5, bf16 caches crossing exactly. The MoE and recurrent models' prefill
+ 3 decode steps: logits and states within 3e-5 (``STEPS_F32_TOL``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.model import abstract_cache as r_abstract_cache  # noqa: E402
from repro.models.model import abstract_params as r_abstract_params  # noqa: E402
from repro.models.model import forward as r_forward  # noqa: E402
from repro.models.model import init_cache as r_init_cache  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro.serve.steps import decode_step as r_decode_step  # noqa: E402
from repro.serve.steps import prefill_step as r_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import (LM, cache_from_jax,  # noqa: E402
                                      cache_to_numpy, init_cache,
                                      init_params, params_from_jax)
from repro_torch.serve.steps import decode_step, prefill_step  # noqa: E402
from test_torch_lm_layers import (CTX, F32_TOL, _cfgs, _f32,  # noqa: E402
                                  _np_tree, _same_cache, _t)

BF16_LOGIT_TOL = 0.06
# Logits and states after a prefill and 3 decode steps through 2-13 MoE or
# recurrent layers at f32: 3e-5 absolute on logits up to 3.9 (measured
# <= 1.14e-5, xlstm-125m's 6 layers at the third step: the recurrences'
# multiply-adds and sums round at other places in the two frameworks, and
# the differences compound over layers and steps).
STEPS_F32_TOL = 3e-5


def _models(arch, **kw):
    rc, pc = _cfgs(arch, **kw)
    params = r_init_params(jax.random.key(0), rc)
    return rc, pc, params, LM(pc, params_from_jax(_np_tree(params), pc))


@pytest.fixture(scope="module")
def dense_models():
    out = {}
    for arch in ("llama3_2-1b", "gemma-2b", "granite-20b"):
        for dtype in ("float32", "bfloat16"):
            out[arch, dtype] = _models(arch, dtype=dtype)
    return out


@pytest.mark.parametrize("arch", ["llama3_2-1b", "gemma-2b", "granite-20b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits(dense_models, arch, dtype):
    rc, pc, params, lm = dense_models[arch, dtype]
    toks = np.random.default_rng(6).integers(
        0, rc.vocab_size, (2, 32)).astype(np.int32)
    ref, _, _ = jax.jit(lambda p, t: r_forward(p, rc, CTX, tokens=t))(
        params, jnp.asarray(toks))
    with torch.inference_mode():
        got, cache, _ = lm(tokens=_t(toks))
        served, _, _ = lm.serving_copy()(tokens=_t(toks))
    assert cache is None and got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)
    # The serving copy holds the values the forward pass casts to.
    np.testing.assert_array_equal(served.numpy(), got.numpy())


def test_forward_input_embeds_vision():
    """phi-3-vision's stub frontend: precomputed patch embeddings."""
    rc, pc, params, lm = _models("phi-3-vision-4_2b")
    assert pc.frontend == "vision"
    emb = np.random.default_rng(7).standard_normal((2, 16, 64)).astype(
        np.float32)
    ref, _, _ = r_forward(params, rc, CTX,
                          input_embeds=jnp.asarray(emb, rc.dtype))
    with torch.inference_mode():
        got, _, _ = lm(input_embeds=_t(emb).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=BF16_LOGIT_TOL)


def test_embed_scale_rounds_to_compute_dtype():
    """gemma's sqrt(d) scale is rounded to bf16 before the multiply: at
    d = 2048, sqrt(d) = 45.2548... is 45.25 in bf16, and the embedded
    tokens equal the reference's expression bit for bit."""
    pc = scaled_down(get_config("gemma-2b"), d_model=2048, vocab_size=64)
    assert pc.scale_embed
    lm = init_params(pc, torch.Generator().manual_seed(0))
    toks = np.arange(64, dtype=np.int32).reshape(2, 32)
    embed = jnp.asarray(lm.embed.numpy())
    ref = embed[jnp.asarray(toks)].astype(jnp.bfloat16) * jnp.asarray(
        np.sqrt(2048), jnp.bfloat16)
    with torch.inference_mode():
        got = lm.embed_inputs(tokens=_t(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
    assert float(torch.tensor(2048 ** 0.5, dtype=torch.bfloat16)) == 45.25
    unrounded = (lm.embed[_t(toks)].to(torch.bfloat16).float()
                 * 2048 ** 0.5).to(torch.bfloat16)
    assert not torch.equal(unrounded, got)


@pytest.mark.parametrize("arch", ["llama3_2-1b", "gemma-2b"])
def test_prefill_caches_and_crossing(dense_models, arch):
    """Prefill caches (k, v, pos) equal; a reference prefill cache decoded
    by the port equals the reference's decode, and a port prefill cache
    decoded by the reference equals the port's."""
    rc, pc, params, lm = dense_models[arch, "float32"]
    rng = np.random.default_rng(8)
    toks = rng.integers(0, rc.vocab_size, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, rc.vocab_size, (2, 1)).astype(np.int32)
    r_logits, r_cache = r_prefill_step(params, jnp.asarray(toks), rc, CTX,
                                       s_alloc=28)
    logits, cache = prefill_step(lm, _t(toks), s_alloc=28)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=0, atol=F32_TOL)
    assert set(cache) == set(r_cache)
    for name in cache:
        assert tuple(cache[name]["pos"].shape) == (pc.n_groups, 28)
        _same_cache(cache[name], r_cache[name])
    port_np = cache_to_numpy(cache)
    # reference cache → port decode
    lg_pr, c_pr = decode_step(lm, cache_from_jax(_np_tree(r_cache), pc),
                              _t(nxt), 24)
    lg_rr, c_rr = r_decode_step(params, r_cache, jnp.asarray(nxt), 24, rc,
                                CTX)
    np.testing.assert_allclose(lg_pr.numpy(), np.asarray(lg_rr), rtol=0,
                               atol=F32_TOL)
    # port cache → reference decode
    lg_rp, c_rp = r_decode_step(
        params, jax.tree.map(jnp.asarray, port_np), jnp.asarray(nxt), 24,
        rc, CTX)
    lg_pp, c_pp = decode_step(lm, cache_from_jax(port_np, pc), _t(nxt), 24)
    np.testing.assert_allclose(np.asarray(lg_rp), lg_pp.numpy(), rtol=0,
                               atol=F32_TOL)
    for name in c_pp:
        _same_cache(c_pp[name], c_rp[name])
        _same_cache(c_pr[name], c_rr[name])


def test_bf16_cache_crossing():
    """A bf16 cache crosses exactly: numpy holds it as f32 values."""
    rc, pc, params, lm = _models("llama3_2-1b")
    toks = np.random.default_rng(9).integers(
        0, rc.vocab_size, (2, 8)).astype(np.int32)
    _, r_cache = r_prefill_step(params, jnp.asarray(toks), rc, CTX,
                                s_alloc=10)
    got = cache_from_jax(_np_tree(r_cache), pc)
    back = cache_to_numpy(got)
    for name, sub in r_cache.items():
        assert got[name]["k"].dtype == torch.bfloat16
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(back[name][key], _f32(sub[key])
                                          if key != "pos"
                                          else np.asarray(sub[key]))
            assert np.array_equal(
                np.asarray(jnp.asarray(back[name][key], sub[key].dtype)),
                np.asarray(sub[key]))


def test_decode_matches_forward(dense_models):
    """The reference's own check (test_arch_smoke.py): decode after a
    prefill against forward over S + 1, at its 0.15 bf16 bound."""
    rc, pc, params, lm = dense_models["gemma-2b", "bfloat16"]
    toks = np.random.default_rng(10).integers(
        0, rc.vocab_size, (2, 32)).astype(np.int32)
    _, cache = prefill_step(lm, _t(toks), s_alloc=34)
    lg, _ = decode_step(lm, cache, _t(toks[:, :1]), 32)
    full = np.concatenate([toks, toks[:, :1]], axis=1)
    with torch.inference_mode():
        lf, _, _ = lm(tokens=_t(full))
    np.testing.assert_allclose(lg[:, 0].numpy(), lf[:, -1].numpy(),
                               atol=0.15)


def test_init_params_and_cache_shapes():
    rc, pc = _cfgs("granite-20b")
    gen = torch.Generator().manual_seed(0)
    lm = init_params(pc, gen)
    ref = _np_tree(r_init_params(jax.random.key(0), rc))
    assert set(lm.state_dict()) == set(params_from_jax(ref, pc))
    for key, t in params_from_jax(ref, pc).items():
        assert lm.state_dict()[key].shape == t.shape, key
        assert lm.state_dict()[key].dtype == torch.float32
    again = init_params(pc, torch.Generator().manual_seed(0))
    for key, t in lm.state_dict().items():
        assert torch.equal(t, again.state_dict()[key])
    cache = init_cache(pc, 3, 12)
    r_cache = r_init_cache(rc, 3, 12)
    for name in r_cache:
        for key in ("k", "v", "pos"):
            assert tuple(cache[name][key].shape) == r_cache[name][key].shape


NEW_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "recurrentgemma-2b",
             "xlstm-125m")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_moe_and_recurrent_params_caches_serving_copy(arch):
    """The MoE and recurrent models' state dicts and caches have the
    reference's keys, shapes and dtypes; the serving copy keeps the MoE
    router, RG-LRU's ``lam`` and sLSTM's ``r_z`` bit-equal to the f32
    parameters (the reference reads them unrounded) and casts the rest."""
    rc, pc = _cfgs(arch)
    lm = init_params(pc, torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                       r_abstract_params(rc))
    want = params_from_jax(ref, pc)
    assert set(lm.state_dict()) == set(want)
    for key, t in want.items():
        assert lm.state_dict()[key].shape == t.shape, key
        assert lm.state_dict()[key].dtype == torch.float32, key
    cache = init_cache(pc, 3, 12)
    r_cache = r_abstract_cache(rc, 3, 12)
    assert {n: set(sub) for n, sub in cache.items()} == \
        {n: set(sub) for n, sub in r_cache.items()}
    for name, sub in r_cache.items():
        for key, leaf in sub.items():
            got = cache[name][key]
            assert tuple(got.shape) == leaf.shape, (name, key)
            assert str(got.dtype).split(".")[-1] == str(leaf.dtype), key
    served = lm.serving_copy().state_dict()
    f32_keys = [k for k in served if k.rsplit(".", 1)[-1] in
                ("router", "lam", "r_z")]
    assert f32_keys, "no f32 parameter in this model"
    for key, t in lm.state_dict().items():
        if key in f32_keys or key.endswith("norm.scale"):
            assert served[key].dtype == torch.float32
            assert torch.equal(served[key], t), key
        elif key.startswith("layers."):
            assert served[key].dtype == torch.bfloat16, key


@pytest.fixture(scope="module")
def new_models():
    return {arch: _models(arch, dtype="float32") for arch in NEW_ARCHS}


def _close_cache(got: dict, ref: dict):
    assert set(got) == set(ref)
    for name, sub in ref.items():
        assert set(got[name]) == set(sub)
        for key, leaf in sub.items():
            np.testing.assert_allclose(
                got[name][key].float().numpy(), _f32(leaf), rtol=0,
                atol=STEPS_F32_TOL, err_msg=f"{name}.{key}")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_moe_and_recurrent_prefill_decode_and_crossing(new_models, arch):
    """Prefill and 3 decode steps at f32 against the reference (logits
    and every cache leaf); a reference cache decoded by the port and a
    port cache decoded by the reference give the other's logits."""
    rc, pc, params, lm = new_models[arch]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    nxt = rng.integers(0, rc.vocab_size, (3, 2, 1)).astype(np.int32)
    r_prefill = jax.jit(lambda p, t: r_prefill_step(p, t, rc, CTX,
                                                    s_alloc=20))
    r_decode = jax.jit(lambda p, c, t, i: r_decode_step(p, c, t, i, rc, CTX))
    r_logits, r_cache = r_prefill(params, jnp.asarray(toks))
    logits, cache = prefill_step(lm, _t(toks), s_alloc=20)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=0, atol=STEPS_F32_TOL)
    _close_cache(cache, r_cache)
    crossed = cache_from_jax(_np_tree(r_cache), pc)
    port_np = cache_to_numpy(cache)
    for i in range(3):
        step = jnp.asarray(nxt[i]), jnp.int32(16 + i)
        lg_r, r_cache = r_decode(params, r_cache, *step)
        lg, cache = decode_step(lm, cache, _t(nxt[i]), 16 + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), rtol=0,
                                   atol=STEPS_F32_TOL)
        _close_cache(cache, r_cache)
    # reference cache → port decode; port cache → reference decode
    lg_pr, _ = decode_step(lm, crossed, _t(nxt[0]), 16)
    lg_rp, _ = r_decode(params, jax.tree.map(jnp.asarray, port_np),
                        jnp.asarray(nxt[0]), jnp.int32(16))
    lg_rr, _ = r_decode(params, r_prefill(params, jnp.asarray(toks))[1],
                        jnp.asarray(nxt[0]), jnp.int32(16))
    np.testing.assert_allclose(lg_pr.numpy(), np.asarray(lg_rr), rtol=0,
                               atol=STEPS_F32_TOL)
    np.testing.assert_allclose(np.asarray(lg_rp), np.asarray(lg_rr), rtol=0,
                               atol=STEPS_F32_TOL)
