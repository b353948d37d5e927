"""The port's LM serving path held against the JAX reference's engine.

* The same ``Request``s (prompts of mixed lengths, mixed ``max_new``, some
  with an ``eos_id`` that truncates them) through ``repro.serve.engine.
  Engine`` and the port's ``Engine``, in wave mode (3 rows) and in
  continuous mode (2 and 3 slots), at f32 compute: equal tokens rid by
  rid and equal stats (waves or ticks, tokens, decode steps, prefills).
  A token may differ only at a step where the reference's top-2 logit
  margin is under twice the logit tolerance (each side may move by it);
  the comparison stops there, and the test asserts how many steps it
  compared. ``greedy_generate`` against the reference's the same way.
* The reference tests' behaviours (``tests/test_serving.py``,
  ``tests/test_continuous.py``) on the port at bf16: 7 requests at
  ``max_batch=3`` give 3 waves, EOS truncation, an overlong prompt
  raises, ``greedy_generate`` equals a lone engine request, continuous
  equals wave token streams, and EOS recycles slots into new decodes.
* ``SlotScheduler.occupant`` against the reference's.
* ``launch/serve --smoke --device cpu`` against the reference launcher
  (the same requests, waves and tokens), for llama3.2-1b and for the MoE
  and recurrent ``--arch`` values; without ``--device`` it raises
  on a machine without a card instead of falling back to the CPU.

Tolerance: f32 logits within 1e-5 absolute (measured <= 2.3e-6,
``test_torch_lm_model.py``).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.launch import serve as r_serve_cli  # noqa: E402
from repro.models.config import scaled_down as r_scaled_down  # noqa: E402
from repro.models.layers import ShardCtx  # noqa: E402
from repro.models.model import forward as r_forward  # noqa: E402
from repro.models.model import init_params as r_init_params  # noqa: E402
from repro.sched import SlotScheduler as RSlotScheduler  # noqa: E402
from repro.serve import engine as r_engine  # noqa: E402
from repro.serve.steps import greedy_generate as r_greedy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import LM, init_params, params_from_jax  # noqa: E402
from repro_torch.sched import SlotScheduler  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.serve.steps import greedy_generate  # noqa: E402

CTX = ShardCtx()
LOGIT_TOL = 1e-5
MAX_PROMPT, MAX_NEW = 12, 10
STAT_KEYS = ("requests", "mode", "waves", "completed", "tokens",
             "decode_steps", "prefills")


@pytest.fixture(scope="module")
def f32_llama():
    rc = r_scaled_down(r_get_config("llama3_2-1b"), dtype="float32")
    pc = scaled_down(get_config("llama3_2-1b"), dtype="float32")
    params = r_init_params(jax.random.key(0), rc)
    lm = LM(pc, params_from_jax(jax.tree.map(np.asarray, params), pc))
    return rc, params, lm


@pytest.fixture(scope="module")
def requests(f32_llama):
    """(prompt, max_new, eos_id) per rid: mixed lengths and budgets; rids
    1, 4 and 6 stop at the token the model emits third for them."""
    rc, params, _ = f32_llama
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, rc.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(3, MAX_PROMPT + 1, 8)]
    budgets = [9, 2, 5, 1, 7, 3, 6, 10]
    probe = r_engine.Engine(params, rc, r_engine.ServeConfig(
        max_batch=8, max_prompt=MAX_PROMPT, max_new=MAX_NEW))
    for rid, p in enumerate(prompts):
        probe.submit(r_engine.Request(rid=rid, prompt=p, max_new=3))
    probe.run()
    third = {r.rid: int(r.output[2]) for r in probe.done}
    return [(p, mn, third[rid] if rid in (1, 4, 6) else -1)
            for rid, (p, mn) in enumerate(zip(prompts, budgets))]


def _margins(params, rc, prompts, outs):
    """The reference's top-2 logit margin at every generated step: one
    forward over each left-padded prompt and its tokens (causal, so the
    trailing pad does not enter the steps compared)."""
    n = len(prompts)
    seq = np.zeros((n, MAX_PROMPT + MAX_NEW), np.int32)
    for j, (p, out) in enumerate(zip(prompts, outs)):
        seq[j, MAX_PROMPT - len(p):MAX_PROMPT] = p
        seq[j, MAX_PROMPT:MAX_PROMPT + len(out) - 1] = out[:-1]
    logits, _, _ = jax.jit(lambda p, t: r_forward(p, rc, CTX, tokens=t))(
        params, jnp.asarray(seq))
    top2 = np.sort(np.asarray(logits)[:, MAX_PROMPT - 1:, :], axis=-1)
    return top2[..., -1] - top2[..., -2]      # [n, MAX_NEW + 1]


def _compared_steps(params, rc, prompts, ref_outs, got_outs) -> int:
    """Steps compared, rid by rid, before any divergence; a divergence
    (or a different length) is allowed only where the reference's margin
    is under 2 * LOGIT_TOL."""
    margins = _margins(params, rc, prompts, ref_outs)
    compared = 0
    for j, (ref, got) in enumerate(zip(ref_outs, got_outs)):
        n = min(len(ref), len(got))
        diff = np.flatnonzero(ref[:n] != got[:n])
        stop = int(diff[0]) if len(diff) else n
        if stop < max(len(ref), len(got)):
            assert margins[j, stop] < 2 * LOGIT_TOL, (
                f"request {j} diverges at step {stop} with margin "
                f"{margins[j, stop]}: {ref} vs {got}")
        compared += stop
    return compared


def _serve_both(f32_llama, requests, **kw):
    rc, params, lm = f32_llama
    sc = dict(max_batch=3, max_prompt=MAX_PROMPT, max_new=MAX_NEW, **kw)
    ref = r_engine.Engine(params, rc, r_engine.ServeConfig(**sc))
    got = Engine(lm, ServeConfig(**sc))
    for rid, (p, mn, eos) in enumerate(requests):
        ref.submit(r_engine.Request(rid=rid, prompt=p, max_new=mn,
                                    eos_id=eos))
        got.submit(Request(rid=rid, prompt=p, max_new=mn, eos_id=eos))
    return ref, ref.run(), got, got.run()


@pytest.mark.parametrize("mode", ["wave", "continuous-2", "continuous-3"])
def test_engine_tokens_match_reference(f32_llama, requests, mode):
    kw = {}
    if mode != "wave":
        kw = {"continuous": True, "slots": int(mode[-1])}
    ref, rs, got, gs = _serve_both(f32_llama, requests, **kw)
    assert set(gs) == set(rs)
    assert {k: gs[k] for k in STAT_KEYS} == {k: rs[k] for k in STAT_KEYS}
    r_out = {r.rid: r.output for r in ref.done}
    g_out = {r.rid: r.output for r in got.done}
    assert sorted(g_out) == list(range(len(requests)))
    rids = sorted(r_out)
    rc, params, _ = f32_llama
    compared = _compared_steps(params, rc, [requests[i][0] for i in rids],
                               [r_out[i] for i in rids],
                               [g_out[i] for i in rids])
    # Budgets 9, 2, 5, 1, 7, 3, 6, 10; EOS cuts rids 1, 4 and 6 at the
    # first emission of their third token (rid 1's first token, rid 4's
    # second): every step compared, none near a tie.
    assert compared == sum(len(r_out[i]) for i in rids) == 34
    assert [len(g_out[i]) for i in rids] == [9, 1, 5, 1, 2, 3, 3, 10]
    for i in rids:
        assert g_out[i].dtype == r_out[i].dtype


def test_greedy_generate_matches_reference(f32_llama):
    rc, params, lm = f32_llama
    prompt = (np.arange(1, 13, dtype=np.int32) % rc.vocab_size)[None]
    prompt = np.concatenate([prompt, prompt[:, ::-1]], axis=0)
    ref = np.asarray(r_greedy(params, jnp.asarray(prompt), rc, CTX,
                              max_new=6, s_alloc=18))
    got = greedy_generate(lm, torch.from_numpy(prompt), max_new=6,
                          s_alloc=18).numpy()
    compared = 0
    for j in range(2):
        seq = np.zeros((1, 18), np.int32)
        seq[0, :12] = prompt[j]
        seq[0, 12:17] = ref[j, :-1]
        logits, _, _ = r_forward(params, rc, CTX, tokens=jnp.asarray(seq))
        top2 = np.sort(np.asarray(logits)[0, 11:17], axis=-1)
        diff = np.flatnonzero(ref[j] != got[j])
        stop = int(diff[0]) if len(diff) else 6
        if stop < 6:
            assert top2[stop, -1] - top2[stop, -2] < 2 * LOGIT_TOL
        compared += stop
    assert compared == 12


# -- the reference tests' behaviours, on the port at bf16 --------------------

@pytest.fixture(scope="module")
def gemma():
    cfg = scaled_down(get_config("gemma-2b"))
    return init_params(cfg, torch.Generator().manual_seed(0))


def _engine(model, **kw):
    return Engine(model, ServeConfig(**kw))


def test_engine_drains_queue_in_waves(gemma):
    eng = _engine(gemma, max_batch=3, max_prompt=16, max_new=8)
    rng = np.random.default_rng(1)
    for rid in range(7):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, 200, 8).astype(
            np.int32), max_new=4))
    stats = eng.run()
    assert stats["requests"] == 7
    assert stats["waves"] == 3  # 3 + 3 + 1
    assert all(r.output is not None and len(r.output) == 4
               for r in eng.done)
    assert stats["tokens_per_s"] > 0
    assert stats["p95_latency_s"] >= stats["mean_latency_s"] > 0


def test_engine_eos_truncation_and_overlong_prompt(gemma):
    eng = _engine(gemma, max_batch=3, max_prompt=16, max_new=8)
    prompt = np.random.default_rng(2).integers(0, 200, 8).astype(np.int32)
    eng.submit(Request(rid=100, prompt=prompt, max_new=8))
    eng.run()
    first_tok = int(eng.done[-1].output[0])
    eng.submit(Request(rid=101, prompt=prompt, max_new=8, eos_id=first_tok))
    eng.run()
    assert len(eng.done[-1].output) == 1
    with pytest.raises(ValueError, match="prompt too long"):
        eng.submit(Request(rid=0, prompt=np.zeros(99, np.int32), max_new=2))


def test_greedy_generate_matches_engine_single():
    cfg = scaled_down(get_config("llama3_2-1b"))
    model = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = np.arange(1, 13, dtype=np.int32) % cfg.vocab_size
    eng = _engine(model, max_batch=1, max_prompt=12, max_new=6)
    eng.submit(Request(rid=0, prompt=prompt, max_new=6))
    eng.run()
    direct = greedy_generate(model, torch.from_numpy(prompt[None]),
                             max_new=6, s_alloc=12 + 6)
    np.testing.assert_array_equal(eng.done[0].output, direct[0].numpy())


def test_continuous_matches_wave_token_streams(gemma):
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 200, int(n)).astype(np.int32), int(mn))
            for n, mn in zip(rng.integers(3, 12, 7), [9, 2, 5, 1, 7, 3, 2])]
    outs = {}
    for kw in ({}, {"continuous": True, "slots": 3}):
        eng = _engine(gemma, max_batch=3, max_prompt=12, max_new=10, **kw)
        for rid, (p, mn) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=p, max_new=mn))
        assert eng.run()["requests"] == len(reqs)
        outs[bool(kw)] = {r.rid: r.output for r in eng.done}
    for rid in outs[False]:
        np.testing.assert_array_equal(outs[False][rid], outs[True][rid])


def test_eos_recycles_slots_into_new_decodes(gemma):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 200, 6).astype(np.int32) for _ in range(6)]
    probe = _engine(gemma, max_batch=2, max_prompt=8, max_new=14)
    for rid, p in enumerate(prompts):
        probe.submit(Request(rid=rid, prompt=p, max_new=1))
    probe.run()
    first_tok = {r.rid: int(r.output[0]) for r in probe.done}

    def build(rid, p):
        if rid in (0, 3):
            return Request(rid=rid, prompt=p, max_new=12)
        return Request(rid=rid, prompt=p, max_new=12, eos_id=first_tok[rid])

    runs = {}
    for kw in ({}, {"continuous": True, "slots": 2}):
        eng = _engine(gemma, max_batch=2, max_prompt=8, max_new=14, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(build(rid, p))
        runs[bool(kw)] = (eng.run(), {r.rid: r.output for r in eng.done})
    (ws, w), (cs, c) = runs[False], runs[True]
    for rid in w:
        np.testing.assert_array_equal(w[rid], c[rid])
    for rid in range(6):
        if rid not in (0, 3):
            assert len(c[rid]) == 1
    assert cs["decode_steps"] < ws["decode_steps"]


# -- the scheduler's occupant, and the launcher -------------------------------

def test_slot_scheduler_occupant_matches_reference():
    ref, got = RSlotScheduler(2), SlotScheduler(2)
    for s in (ref, got):
        for item in "abc":
            s.submit(item)
    assert got.admit() == ref.admit() == [(0, "a"), (1, "b")]
    assert [got.occupant(i) for i in range(2)] == \
        [ref.occupant(i) for i in range(2)] == ["a", "b"]
    assert got.release(0) == ref.release(0) == "a"
    assert got.occupant(0) is ref.occupant(0) is None
    assert got.admit() == ref.admit() == [(0, "c")]
    assert [got.occupant(i) for i in range(2)] == ["c", "b"]
    got.check_invariants()


@pytest.mark.parametrize("continuous", [False, True])
def test_launch_serve_smoke_matches_reference(continuous, capsys):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--requests", "5",
            "--max-batch", "2", "--max-prompt", "16", "--max-new", "6"]
    ours = serve_cli.main(argv + ["--device", "cpu"]
                          + (["--continuous", "--slots", "2"]
                             if continuous else []))
    out = capsys.readouterr().out
    assert "[serve] 5 requests in" in out
    ref = r_serve_cli.main(argv)
    # The reference launcher has no --continuous: its waves are the
    # reference for the token count; budgets alone decide it (no EOS).
    assert ours["requests"] == ref["requests"] == 5
    assert ours["tokens"] == ref["tokens"]
    assert ours["mode"] == ("continuous" if continuous else "wave")
    if not continuous:
        assert {k: ours[k] for k in STAT_KEYS} == \
            {k: ref[k] for k in STAT_KEYS}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-125m"])
def test_launch_serve_moe_and_recurrent_smoke(arch, capsys):
    """``--arch`` of the MoE and recurrent families through the launcher:
    waves give the reference launcher's stats (budgets alone decide the
    token count), slots serve every request its budget, and for the
    recurrent model both modes give the same tokens (recurrentgemma-2b's
    engine is held in ``test_torch_lm_recurrent.py``)."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--max-batch",
            "2", "--max-prompt", "8", "--max-new", "4"]
    runs = {}
    for mode, extra in (("wave", []),
                        ("continuous", ["--continuous", "--slots", "2"])):
        engine = serve_cli.build(argv + ["--device", "cpu"] + extra)
        budgets = {r.rid: r.max_new for r in engine.queue}
        stats = engine.run()
        serve_cli.report(stats)
        runs[mode] = stats, {r.rid: r.output for r in engine.done}
        assert {rid: len(o) for rid, o in runs[mode][1].items()} == budgets
    assert "[serve] 3 requests in" in capsys.readouterr().out
    ref = r_serve_cli.main(argv)
    ours = runs["wave"][0]
    assert {k: ours[k] for k in STAT_KEYS} == {k: ref[k] for k in STAT_KEYS}
    assert runs["continuous"][0]["tokens"] == ref["tokens"]
    if arch != "olmoe-1b-7b":
        for rid, out in runs["wave"][1].items():
            np.testing.assert_array_equal(out, runs["continuous"][1][rid])


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        serve_cli.main(["--arch", "llama3.2-1b", "--smoke", "--requests",
                        "1"])
