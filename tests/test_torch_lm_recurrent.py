"""The port's recurrent blocks and recurrent serving held against the JAX
reference.

* RG-LRU (recurrentgemma-2b), mLSTM sequential and chunkwise
  (``mlstm_chunk=16``) and sLSTM (xlstm-125m), scaled down: a prefill
  that returns its cache, then a decode step from that cache, outputs and
  every cache leaf (RG-LRU ``h``/``conv``, mLSTM ``C``/``n``, sLSTM
  ``c``/``n``/``h``) at f32 and bf16 compute. The prefill scan of RG-LRU
  keeps ``lax.associative_scan``'s association; mLSTM's keys are f32.
* The engine's tokens rid by rid against ``repro.serve.engine.Engine`` in
  waves of 4 and through 3 continuous slots, and the two modes equal to
  each other (left pads pass through the recurrence in both).
* A slot re-used after a recurrent request: every adoption leaves the
  slot's rows equal to the new request's own prefill cache, and each
  request's tokens equal those of a request served alone.

Weights come from the reference's initialisers, carried across; inputs
from numpy seeds. Tolerances: at f32 compute, 1e-5 absolute on outputs
of order 1 and on the states (measured <= 7.2e-7: the packages sum in
other orders); at bf16, outputs within 2^-6 relative + 0.02 absolute
(measured 0.0078, one bf16 step at 1.93), the f32 states within 1e-5
and the bf16 conv state within one bf16 step (2^-7 relative). Engine
tokens at f32 equal exactly, rid by rid.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as RL  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import LM, params_from_jax  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from test_torch_lm_layers import CTX, F32_TOL, _cfgs, _f32, _np_tree  # noqa: E402
from test_torch_lm_moe import STAT_KEYS, _requests, serve_both  # noqa: E402

RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-125m")
# (case, arch, block kind, config overrides)
BLOCK_CASES = {
    "rglru": ("recurrentgemma-2b", "rglru", {}),
    "mlstm": ("xlstm-125m", "mlstm", {}),
    "mlstm-chunk16": ("xlstm-125m", "mlstm", {"mlstm_chunk": 16}),
    "slstm": ("xlstm-125m", "slstm", {}),
}


def _close(got: torch.Tensor, ref, dtype, key=""):
    if dtype == "bfloat16" and got.dtype == torch.bfloat16:
        tol = dict(rtol=2.0 ** -6, atol=2e-2) if key == "y" else dict(
            rtol=2.0 ** -7, atol=0)
    else:
        tol = dict(rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got.float().numpy(), _f32(ref), err_msg=key,
                               **tol)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_prefill_and_decode(case, dtype):
    arch, kind, kw = BLOCK_CASES[case]
    rc, pc = _cfgs(arch, dtype=dtype, **kw)
    p = getattr(RL, f"init_{kind}")(jax.random.key(5), rc)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in _np_tree(p).items()}
    r_apply, apply = getattr(RL, f"apply_{kind}"), getattr(L, f"apply_{kind}")
    dt = L.DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)

    ref_y, ref_c = r_apply(p, jnp.asarray(x, rc.dtype), rc, CTX,
                           want_cache=True)
    y, cache = apply(pt, torch.from_numpy(x).to(dt), pc, want_cache=True)
    assert y.dtype == dt
    _close(y, ref_y, dtype, "y")
    assert set(cache) == set(ref_c)
    for key in cache:
        assert cache[key].dtype == (dt if key == "conv" else torch.float32)
        assert tuple(cache[key].shape) == ref_c[key].shape
        _close(cache[key], ref_c[key], dtype, key)
    # Without want_cache a prefill returns no cache, as the reference's.
    assert apply(pt, torch.from_numpy(x).to(dt), pc)[1] is None

    # Decode one token from the reference's own prefill cache.
    start = {k: torch.from_numpy(np.array(_f32(v))).to(cache[k].dtype)
             for k, v in ref_c.items()}
    ref_y1, ref_c1 = r_apply(p, jnp.asarray(x1, rc.dtype), rc, CTX,
                             cache=ref_c)
    y1, c1 = apply(pt, torch.from_numpy(x1).to(dt), pc, cache=start)
    assert c1 is start  # stepped in place
    _close(y1, ref_y1, dtype, "y")
    for key in c1:
        _close(c1[key], ref_c1[key], dtype, key)


def test_rglru_scan_keeps_reference_association():
    """The log-depth scan of h_t = a_t h_{t-1} + b_t against
    ``lax.associative_scan`` of the same combine at odd and even lengths,
    and against the sequential recurrence."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 8, 13):
        a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        ra, rb = jax.lax.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        ga, gb = L._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(ga.numpy(), np.asarray(ra), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0,
                                   atol=1e-6)
        h = np.zeros((2, 3), np.float32)
        for t in range(n):
            h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(gb[:, -1].numpy(), h, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def f32_recurrent():
    out = {}
    for arch in RECURRENT_ARCHS:
        rc, pc = _cfgs(arch, dtype="float32")
        params = r_init_params(jax.random.key(0), rc)
        out[arch] = rc, params, LM(pc, params_from_jax(_np_tree(params), pc))
    return out


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_engine_tokens(f32_recurrent, arch):
    """Each mode against the reference's same mode, and the two modes
    equal to each other."""
    rc, params, lm = f32_recurrent[arch]
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
    for rid in range(8):
        np.testing.assert_array_equal(outs["wave"][rid],
                                      outs["continuous"][rid])


def test_reused_slot_starts_from_adopted_state(f32_recurrent, monkeypatch):
    """One slot serves four xLSTM requests in turn: at every adoption the
    slot's C, n, c, h rows become the new request's prefill cache exactly
    (the previous request's state is gone), and each request's tokens
    equal those it gets served alone."""
    rc, params, lm = f32_recurrent["xlstm-125m"]
    requests = _requests(rc.vocab_size)[:4]
    adopted = []
    adopt = engine_mod._adopt_cache

    def checked(cache, fresh, slot):
        before = {name: {k: v[:, slot].clone() for k, v in sub.items()}
                  for name, sub in cache.items()}
        out = adopt(cache, fresh, slot)
        for name, sub in out.items():
            for key, leaf in sub.items():
                assert torch.equal(leaf[:, slot], fresh[name][key][:, 0])
        adopted.append(any(not torch.equal(before[n][k], fresh[n][k][:, 0])
                           for n in fresh for k in fresh[n]))
        return out

    monkeypatch.setattr(engine_mod, "_adopt_cache", checked)
    sc = dict(max_batch=1, max_prompt=12, max_new=10)
    shared = Engine(lm, ServeConfig(continuous=True, slots=1, **sc))
    for rid, (p, mn) in enumerate(requests):
        shared.submit(Request(rid=rid, prompt=p, max_new=mn))
    shared.run()
    assert len(adopted) == 4 and all(adopted[1:])
    got = {r.rid: r.output for r in shared.done}
    for rid, (p, mn) in enumerate(requests):
        alone = Engine(lm, ServeConfig(continuous=True, slots=1, **sc))
        alone.submit(Request(rid=rid, prompt=p, max_new=mn))
        alone.run()
        np.testing.assert_array_equal(got[rid], alone.done[0].output)
