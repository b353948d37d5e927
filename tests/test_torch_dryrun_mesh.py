"""The mesh dry-run (``repro_torch.launch.dryrun --mesh pod|multipod``,
``launch.mesh.fake_world``, the collectives of ``launch.op_analysis`` and
``launch.roofline``'s collective term) held against one card's counts,
against real ``gloo`` ranks and against the reference's committed records
(``artifacts/dryrun/*_{pod,multipod}.json``), on the CPU.

* One rank: a (1, 1) mesh under ``fake_world(1)`` counts as one card
  (FLOPs by dtype, input bytes and the peak; the mesh path adds views and
  the optimizer's stacked norm sums, so op counts and eager bytes may
  differ) and issues no collective; ``--donate`` changes no count.
* The fake group against real ranks: the meta count under
  ``fake_world(4)`` equals, as integers, the counts of 4 ``gloo`` CPU
  ranks (``torch_mesh_ranks.py``'s ``count`` task) of the same step, rank
  0's and rank 3's alike: FLOPs by dtype, collective bytes and calls by
  kind and bytes by axis set.
* By hand: one dense block's forward on (1, 2) all-reduces 2·B·S·D bf16
  values; an FSDP gather on (2, 1) moves the gathered leaves' bytes.
* Llama-3.2-1B ``train_4k`` on (2, 2): per-rank FLOPs by dtype × 4 equal
  the one-card record.
* The fits: the polynomial through counts at 1 and 2 groups, or at
  S = 4, 8, 12, gives a direct count's collectives.
* A 512-rank cell (xLSTM-125M ``decode_32k`` on the multipod mesh, the
  counterpart of the reference's ``test_dryrun_cell_compiles_on_512_
  devices``) runs in a fresh process.
* The committed records: 80, 64 ok and 16 skipped; each ok record's FLOPs
  and collective bytes held against the reference's by a named term or a
  pinned ratio (``EXACT`` / ``FLOP_RATIO`` / ``COLL_RATIO``).
* ``--grad-scatter``: recorded, and no count changes (the gradients are
  reduce-scattered with or without it).
* A process's first counts leave no tensor for the garbage collector.
* The mesh roofline's rows: the collective term is Σ bytes / link rate,
  and the rows equal the committed ``roofline_{pod,multipod}_h100.json``.
"""
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_reference as R  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: E402
                                        applicable)
from repro_torch.launch import dryrun, mesh, roofline  # noqa: E402
from repro_torch.launch import op_analysis as oa  # noqa: E402
from repro_torch.launch.mesh import Mesh, fake_world  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("pod", "multipod")
CELLS = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in MESHES]
OK_CELLS = [c for c in CELLS if applicable(get_config(c[0]), c[1])]
CUTS = {
    "recurrentgemma-2b": dict(n_layers=2, block_pattern=(
        ("rglru", "mlp"), ("local_attn", "mlp"))),
    "xlstm-125m": dict(n_layers=2, block_pattern=(("mlstm",), ("slstm",))),
}
FAMILIES = ("llama3_2-1b", "olmoe-1b-7b", "recurrentgemma-2b", "xlstm-125m")


def small(arch: str, **kw):
    return scaled_down(get_config(arch), **{**CUTS.get(arch, {}), **kw})


def meta_count(arch, cfg, shape, shape_axes=None, **kw) -> oa.Counts:
    """The dry-run's count of one step on meta tensors: one card, or rank
    0 of a mesh ``(shape, axes)`` under a fake group."""
    if shape_axes is None:
        return dryrun.count_cell(dryrun.build_cell(
            arch, "small", cfg=cfg, shape=shape, **kw))
    dims, axes = shape_axes
    with fake_world(math.prod(dims)):
        m = Mesh(dims, axes, device="meta")
        return dryrun.count_cell(dryrun.build_cell(
            arch, "small", cfg=cfg, shape=shape, mesh=m, **kw))


def _no_collectives(c: oa.Counts) -> bool:
    return not (c.coll_bytes or c.coll_counts or c.axes_bytes)


# -- 1. one rank --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_mesh_counts_as_one_card(arch, kind):
    cfg, shape = small(arch), ShapeSpec("small", 16, 2, kind)
    one = meta_count(arch, cfg, shape)
    got = meta_count(arch, cfg, shape, ((1, 1), ("data", "model")))
    assert oa.same_flops(one, got)
    assert (got.peak_bytes, got.input_bytes) == (one.peak_bytes,
                                                 one.input_bytes)
    assert _no_collectives(got) and _no_collectives(one)
    assert got.collectives()["total_bytes_per_device"] == 0


@pytest.mark.parametrize("mesh_name", ["h100", "pod"])
def test_donate_is_recorded_and_changes_no_count(tmp_path, monkeypatch,
                                                 mesh_name):
    """The reference's command line with ``--donate`` runs unchanged: the
    record says so under ``knobs`` and every count equals the committed
    record's."""
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--mesh", mesh_name, "--donate",
                        "--tag", "_donate"]) == 0
    name = "h100" if mesh_name == "h100" else f"{mesh_name}_h100"
    got = json.loads((tmp_path / f"xlstm-125m_decode_32k_{name}_donate"
                      ".json").read_text())
    ref = json.loads((ROOT / "artifacts" / "dryrun_torch" /
                      f"xlstm-125m_decode_32k_{name}.json").read_text())
    assert got["knobs"]["donate"] is True
    keys = ["flops_by_dtype", "eager_bytes", "kernels", "peak_bytes",
            "input_bytes", "ops", "least_bytes"]
    if mesh_name != "h100":
        keys.append("collectives")
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}


FREED = """
import gc, sys
import torch
from repro_torch.configs import get_config
from repro_torch.models.config import scaled_down
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.steps import train_step
torch.set_num_threads(1)
cfg = scaled_down(get_config("llama3_2-1b"))


def left_to_the_collector():
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    n = sum(isinstance(o, torch.Tensor) for o in gc.garbage)
    gc.garbage.clear()
    gc.set_debug(0)
    return n


def plain_step():
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"), trainable=True)
    opt = init_opt_state(dict(model.named_parameters()), OptConfig())
    batch = {k: torch.zeros(2, 16, dtype=torch.int32)
             for k in ("tokens", "labels")}
    train_step(model, opt, batch, OptConfig(), remat="full")


gc.collect()
gc.disable()
plain_step()
print("plain", left_to_the_collector())
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_world
for kind in ("train", "decode"):
    dryrun.count_cell(dryrun.build_cell(
        "llama3_2-1b", "small", cfg=cfg,
        shape=ShapeSpec("small", 16, 2, kind), device="cpu"))
with fake_world(4):
    m = Mesh((2, 2), ("data", "model"), device="meta")
    dryrun.count_cell(dryrun.build_cell(
        "llama3_2-1b", "small", cfg=cfg,
        shape=ShapeSpec("small", 16, 4, "train"), mesh=m))
print("counted", left_to_the_collector())
"""


def test_counted_step_is_freed_without_the_collector():
    """A process's first steps leave no tensor for the garbage collector:
    a plain remat train step on the CPU, then the first counts (one
    card's train and decode steps on the CPU, a (2, 2) rank's train
    step). Each step's storages die by reference counts when it returns,
    so neither a step nor its count holds its memory into the next
    (``models/model.py``'s and ``op_analysis``'s ``torch._dynamo``
    import)."""
    out = subprocess.run([sys.executable, "-c", FREED], check=True,
                         timeout=300, cwd=ROOT, env=R._env(),
                         capture_output=True, text=True)
    assert out.stdout.split()[-4:] == ["plain", "0", "counted", "0"], \
        out.stdout


def test_watched_engine_is_freed_without_the_collector():
    """``chip_smoke.watch_logits`` (the card runs' check of every logit an
    engine reads) ties the engine into no reference cycle: it and the
    model it serves die by reference counts when the caller drops them,
    so a card's next peak does not hold the last serving copy, as a
    four-card run's did."""
    import gc
    import importlib.util
    import weakref

    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    served = init_params(small("olmoe-1b-7b"), torch.Generator().manual_seed(
        0), torch.device("cpu")).serving_copy()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        eng = Engine(served, ServeConfig(max_batch=2, max_prompt=8,
                                         max_new=4))
        bad = chip_smoke.watch_logits(eng)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=torch.arange(1, 5).numpy(),
                               max_new=3))
        assert eng.run()["completed"] == 3 and int(bad) == 0
        engine, model = weakref.ref(eng), weakref.ref(served)
        del eng, served
        assert engine() is None and model() is None
    finally:
        if was_enabled:
            gc.enable()


# -- 2. the fake group against real ranks -------------------------------------

RANK_MESHES = {"2x2": [[2, 2], ["data", "model"]],
               "2x1x2": [[2, 1, 2], ["pod", "data", "model"]]}
RANK_TASKS = [{"arch": a, "kind": k, "seq": 16, "batch": 4}
              for a in ("llama3_2-1b", "olmoe-1b-7b")
              for k in ("train", "decode")]


def _task_name(mesh_key: str, task: dict) -> str:
    return f"{mesh_key}_{task['arch']}_{task['kind']}"


@pytest.fixture(scope="module")
def rank_counts(tmp_path_factory):
    """Every task of ``RANK_TASKS`` counted on 4 ``gloo`` ranks for each
    mesh of ``RANK_MESHES`` (both meshes at once): {(mesh, arch, kind):
    [rank 0's counts, ..., rank 3's]}."""
    job_dir = tmp_path_factory.mktemp("mesh_counts")
    procs = []
    for key, m in RANK_MESHES.items():
        tasks = [dict(t, kind="count", step=t["kind"],
                      name=_task_name(key, t)) for t in RANK_TASKS]
        procs += R.launch_port(job_dir, key, m, tasks)[0]
    R.wait(procs, timeout=300)
    out = {}
    for key in RANK_MESHES:
        for t in RANK_TASKS:
            out[(key, t["arch"], t["kind"])] = [json.loads(
                (job_dir / f"count_{_task_name(key, t)}_rank{r}.json")
                .read_text()) for r in range(4)]
    return out


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["llama3_2-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("mesh_key", list(RANK_MESHES))
def test_fake_group_counts_equal_gloo_ranks(rank_counts, mesh_key, arch,
                                            kind):
    ranks = rank_counts[(mesh_key, arch, kind)]
    shape_axes = tuple(tuple(x) for x in RANK_MESHES[mesh_key])
    meta = meta_count(arch, small(arch), ShapeSpec("small", 16, 4, kind),
                      shape_axes)
    want = {"flops": meta.flops, "collectives": meta.collectives()}
    assert want["collectives"]["total_bytes_per_device"] > 0
    for r in (0, 3):
        got = ranks[r]
        assert {k: got[k] for k in want} == json.loads(json.dumps(want))


# -- 3. by hand ---------------------------------------------------------------

def test_dense_block_all_reduce_by_hand():
    """Scaled-down Llama at one layer, its forward (no grad) on (1, 2):
    the attention's and the MLP's outputs [B, S, D] are summed over
    "model" once each, in bf16; the only gather is the embedding table's
    (its vocabulary is split on "model"), the table's bytes."""
    cfg = small("llama3_2-1b", n_layers=1)
    B, S, D = 2, 8, cfg.d_model
    with fake_world(2):
        m = Mesh((1, 2), ("data", "model"), device="meta")
        lm = dryrun._model(cfg, dryrun.META, dryrun.make_ctx(m))
        toks = torch.zeros((B, S), dtype=torch.long, device="meta")
        with torch.no_grad(), oa.OpCounter(mesh=m) as oc:
            lm(tokens=toks)
    c = oc.counts()
    assert c.coll_counts == {"all-reduce": 2, "all-gather": 1}
    assert c.coll_bytes["all-reduce"] == 2 * B * S * D * 2
    assert c.coll_bytes["all-gather"] == cfg.vocab_size * D * 4
    assert c.axes_bytes == {"model": sum(c.coll_bytes.values())}


def test_fsdp_gather_bytes_by_hand():
    """The same forward on (2, 1): every parameter the rules split on
    "data" is gathered whole over "data" when read, the tied embedding
    twice (the lookup and the head); nothing else is gathered and nothing
    summed (model size 1)."""
    cfg = small("llama3_2-1b", n_layers=1)
    with fake_world(2):
        m = Mesh((2, 1), ("data", "model"), device="meta")
        lm = dryrun._model(cfg, dryrun.META, dryrun.make_ctx(m))
        toks = torch.zeros((2, 8), dtype=torch.long, device="meta")
        with torch.no_grad(), oa.OpCounter(mesh=m) as oc:
            lm(tokens=toks)
    c = oc.counts()
    full = {k: v.numel() * v.element_size() * 2  # whole = 2 shards
            for k, v in lm.state_dict().items()
            if "data" in [a for e in lm.specs[k] for a in
                          ((e,) if isinstance(e, str) else (e or ()))]}
    assert cfg.tie_embeddings and "embed" in full
    assert c.coll_counts == {"all-gather": len(full) + 1}
    assert c.coll_bytes == {"all-gather": sum(full.values())
                            + full["embed"]}
    assert c.axes_bytes == {"data": c.coll_bytes["all-gather"]}


# -- 4. the even split --------------------------------------------------------

def test_llama_train_4k_splits_evenly_over_four_ranks():
    rec = json.loads((ROOT / "artifacts" / "dryrun_torch"
                      / "llama3_2-1b_train_4k_h100.json").read_text())
    got = meta_count("llama3_2-1b", get_config("llama3_2-1b"),
                     SHAPES["train_4k"], ((2, 2), ("data", "model")))
    assert {k: 4 * v for k, v in got.flops.items()} == rec["flops_by_dtype"]


# -- 5. the fits --------------------------------------------------------------

def _same_collectives(a: oa.Counts, b: oa.Counts):
    assert (a.coll_bytes, a.coll_counts, a.axes_bytes) == (
        b.coll_bytes, b.coll_counts, b.axes_bytes)
    assert a.coll_bytes


MESH_22 = ((2, 2), ("data", "model"))


def test_group_fit_collectives_equal_direct_count():
    shape = ShapeSpec("small", 64, 2, "prefill")

    def at(g):
        return meta_count("llama3_2-1b", small("llama3_2-1b", n_layers=g),
                          shape, MESH_22)

    fit = oa.extend([at(1), at(2)], (1, 2), 3)
    direct = at(3)
    _same_collectives(fit, direct)
    assert oa.same_flops(fit, direct)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_sequence_fit_collectives_equal_direct_count(block):
    cfg = scaled_down(get_config("xlstm-125m"), n_layers=1,
                      block_pattern=((block,),))

    def at(S):
        return meta_count("xlstm-125m", cfg,
                          ShapeSpec("small", S, 2, "train"), MESH_22)

    xs = (4, 8, 12)
    fit = oa.extend([at(s) for s in xs], xs, 16)
    direct = at(16)
    _same_collectives(fit, direct)
    assert oa.same_flops(fit, direct)


# -- 6. a 512-rank cell -------------------------------------------------------

def test_512_rank_cell_in_a_fresh_process(tmp_path):
    """The counterpart of the reference's 512-device dry-run test."""
    code = ("import sys; from pathlib import Path; "
            "from repro_torch.launch import dryrun; "
            "dryrun.ART = Path(sys.argv[1]); "
            "dryrun.run_cell('xlstm-125m', 'decode_32k', mesh='multipod', "
            "tag='_citest')")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True,
                   timeout=300, cwd=ROOT, env=R._env())
    rec = json.loads((tmp_path / "xlstm-125m_decode_32k_multipod_h100"
                      "_citest.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 512 and rec["mesh"] == "multipod"
    assert rec["flops"] > 0 and rec["peak_bytes"] > 0
    assert rec["collectives"]["total_bytes_per_device"] >= 0


# -- 7. the committed records -------------------------------------------------

def _record(arch, shape, mesh_name) -> dict:
    """The committed record (wherever ``dryrun.ART`` points)."""
    name = roofline.record_name(arch, shape, mesh_name)
    return json.loads((ROOT / "artifacts" / "dryrun_torch" / name)
                      .read_text())


def _reference(arch, shape, mesh_name) -> dict:
    return json.loads((ROOT / "artifacts" / "dryrun"
                       / f"{arch}_{shape}_{mesh_name}.json").read_text())


def test_committed_mesh_records_complete():
    status = []
    for a, s, m in CELLS:
        r = _record(a, s, m)
        status.append(r["status"])
        assert (r["arch"], r["shape"], r["mesh"]) == (a, s, m)
        if r["status"] != "ok":
            continue
        n = 256 if m == "pod" else 512
        assert r["n_devices"] == n == _reference(a, s, m)["n_devices"]
        assert r["flops"] == sum(r["flops_by_dtype"].values()) > 0
        assert r["fits"] == (r["peak_bytes"] <= mesh.HBM_BYTES)
        coll = r["collectives"]
        assert coll["total_bytes_per_device"] == sum(
            coll["per_op_bytes"].values()) == sum(
            coll["per_axes_bytes"].values())
        assert r["knobs"]["grad_scatter"] is False
        parts = dict(r["least_bytes"])
        assert parts.pop("total") == sum(parts.values())
    assert status.count("ok") == 64 and status.count("skipped") == 16


# FLOPs: the port's per-rank count × n_devices against the reference's
# ``flops_per_device`` × ``n_devices``. The reference's records split
# every cell of these archs as its one-device count (test_torch_dryrun's
# EXACT_POD), so each gap below is the port's mesh path. Exact, as
# integers, by these terms:
# EQUAL: every width the rules look at divides the model axis;
# KV_WHOLE: kv heads that the 16-way model axis does not divide (8, or
#   MQA's 1) are projected whole on every model rank (``apply_attn``),
#   15 more copies of the k and v projections: forward, remat's recompute
#   and the backward's two products in a train step, once in serving.
# Pinned, within RATIO_TOL of the stated ratio, with their terms:
# WHOLE_ATTN: attention whose heads 16 does not divide (gemma's 8 with
#   one kv head, musicgen's 24, recurrentgemma's 10) runs whole on every
#   model rank, where GSPMD splits its other dims;
# WHOLE_XLSTM: xLSTM's mLSTM and sLSTM blocks (4 heads) run whole on every
#   model rank, beside the one-device gap's n.q and outer terms;
# ROUTER: the MoE router (f32, replicated on "model") runs on every model
#   rank, and OLMoE's and Kimi's capacities follow each rank's tokens;
# BATCH1: long_500k's batch of 1 is computed whole on every rank.
EQUAL, KV_WHOLE = "equal", "kv projections whole"
WHOLE_ATTN = "attention whole on every model rank"
WHOLE_XLSTM = "xLSTM blocks whole on every model rank, n.q, outer"
ROUTER = "router on every model rank, capacity per rank"
BATCH1 = "; batch of 1 on every rank"
EXACT = {
    **{(a, s, m): (EQUAL,) for m in MESHES for a, s in (
        ("phi-3-vision-4_2b", "train_4k"), ("phi-3-vision-4_2b",
                                            "prefill_32k"),
        ("phi-3-vision-4_2b", "decode_32k"), ("olmoe-1b-7b",
                                              "prefill_32k"))},
    **{(a, s, m): (KV_WHOLE,) for m in MESHES
       for a in ("llama3_2-1b", "granite-20b", "granite-34b")
       for s in ("train_4k", "prefill_32k", "decode_32k")},
    **{("kimi-k2-1t-a32b", "prefill_32k", m): (KV_WHOLE,) for m in MESHES},
}
KV_ROUTER = KV_WHOLE + ", " + ROUTER
FLOP_RATIO = {
    ("olmoe-1b-7b", "train_4k", "pod"): (1.00478, ROUTER),
    ("olmoe-1b-7b", "train_4k", "multipod"): (1.00478, ROUTER),
    ("olmoe-1b-7b", "decode_32k", "pod"): (1.00351, ROUTER),
    ("olmoe-1b-7b", "decode_32k", "multipod"): (1.00204, ROUTER),
    ("kimi-k2-1t-a32b", "train_4k", "pod"): (1.3056, KV_ROUTER),
    ("kimi-k2-1t-a32b", "train_4k", "multipod"): (1.3056, KV_ROUTER),
    ("kimi-k2-1t-a32b", "decode_32k", "pod"): (1.01335, KV_ROUTER),
    ("kimi-k2-1t-a32b", "decode_32k", "multipod"): (1.0068, KV_ROUTER),
    ("musicgen-medium", "train_4k", "pod"): (8.17241, WHOLE_ATTN),
    ("musicgen-medium", "train_4k", "multipod"): (8.17241, WHOLE_ATTN),
    ("musicgen-medium", "prefill_32k", "pod"): (10.7942, WHOLE_ATTN),
    ("musicgen-medium", "prefill_32k", "multipod"): (10.7942, WHOLE_ATTN),
    ("musicgen-medium", "decode_32k", "pod"): (12.1453, WHOLE_ATTN),
    ("musicgen-medium", "decode_32k", "multipod"): (12.1453, WHOLE_ATTN),
    ("gemma-2b", "train_4k", "pod"): (3.22386, WHOLE_ATTN),
    ("gemma-2b", "train_4k", "multipod"): (3.22386, WHOLE_ATTN),
    ("gemma-2b", "prefill_32k", "pod"): (5.83646, WHOLE_ATTN),
    ("gemma-2b", "prefill_32k", "multipod"): (5.83646, WHOLE_ATTN),
    ("gemma-2b", "decode_32k", "pod"): (7.0436, WHOLE_ATTN),
    ("gemma-2b", "decode_32k", "multipod"): (7.0436, WHOLE_ATTN),
    ("recurrentgemma-2b", "train_4k", "pod"): (2.33797, WHOLE_ATTN),
    ("recurrentgemma-2b", "train_4k", "multipod"): (2.33797, WHOLE_ATTN),
    ("recurrentgemma-2b", "prefill_32k", "pod"): (5.11298, WHOLE_ATTN),
    ("recurrentgemma-2b", "prefill_32k", "multipod"): (5.11298, WHOLE_ATTN),
    ("recurrentgemma-2b", "decode_32k", "pod"): (1.96614, WHOLE_ATTN),
    ("recurrentgemma-2b", "decode_32k", "multipod"): (1.96614, WHOLE_ATTN),
    ("recurrentgemma-2b", "long_500k", "pod"): (1.96614, WHOLE_ATTN + BATCH1),
    ("recurrentgemma-2b", "long_500k", "multipod"): (1.96614,
                                                    WHOLE_ATTN + BATCH1),
    ("xlstm-125m", "train_4k", "pod"): (13.6596, WHOLE_XLSTM),
    ("xlstm-125m", "train_4k", "multipod"): (11.1511, WHOLE_XLSTM),
    ("xlstm-125m", "prefill_32k", "pod"): (12.9065, WHOLE_XLSTM),
    ("xlstm-125m", "prefill_32k", "multipod"): (12.9065, WHOLE_XLSTM),
    ("xlstm-125m", "decode_32k", "pod"): (12.9065, WHOLE_XLSTM),
    ("xlstm-125m", "decode_32k", "multipod"): (12.9065, WHOLE_XLSTM),
    ("xlstm-125m", "long_500k", "pod"): (12.9065, WHOLE_XLSTM + BATCH1),
    ("xlstm-125m", "long_500k", "multipod"): (12.9065, WHOLE_XLSTM + BATCH1),
}
# Collective bytes: the port's per-rank total against the reference's
# ``analysis.collective_bytes_per_device`` (its trip-count-aware count:
# the flat ``collectives`` block counts a loop body once). XLA's
# collective-permute and GSPMD's layouts have no one-to-one counterpart,
# so every cell is pinned, with why it is far from 1:
# LAYOUT (train, prefill but xLSTM's; 0.12-1.30): the port moves what
#   Megatron's layout moves, each block's output all-reduced over "model"
#   in the compute dtype (forward, remat's recompute, backward), the FSDP
#   gathers over "data" and the gradients' reduce-scatters; most of the
#   reference's bytes are GSPMD's all-reduces, which it places and types
#   itself;
# XLSTM_WEIGHTS (xLSTM's train and prefill; 0.011-0.24): its mLSTM and
#   sLSTM blocks (4 heads) run whole on every model rank, so the port
#   all-gathers their weights over "model" and issues no all-reduce or
#   all-to-all inside them (the pod's prefill: 283.1 MB of block weights
#   and 77.3 MB of embedding table over "model", 32.4 MB of FSDP gathers
#   over "data", no all-reduce), where GSPMD splits the recurrence over
#   "model" and moves its activations (the pod's train step: 48.7 GB of
#   all-to-all, 19.6 GB of all-gather, 13.4 GB of all-reduce a device);
# DECODE_GATHER (decode; 1.47-64): the port gathers every block's weights
#   over "data" each step, as training does, where GSPMD keeps decode's
#   weights sharded and moves the few rows' activations instead;
# CACHE (decode of llama, musicgen, kimi; 0.05-0.39): kv heads that
#   "model" does not divide; the reference all-gathers and all-to-alls
#   the KV cache over "model" each step, the port keeps those heads whole
#   on every model rank and moves no cache.
LAYOUT = "Megatron's layout against GSPMD's"
XLSTM_WEIGHTS = "xLSTM blocks whole: weights gathered, no activations moved"
DECODE_GATHER = "decode gathers weights over data"
CACHE = "kv cache whole on every model rank"
COLL_RATIO = {
    ("olmoe-1b-7b", "train_4k", "pod"): (0.40883, LAYOUT),
    ("olmoe-1b-7b", "train_4k", "multipod"): (0.453398, LAYOUT),
    ("olmoe-1b-7b", "prefill_32k", "pod"): (0.534036, LAYOUT),
    ("olmoe-1b-7b", "prefill_32k", "multipod"): (0.590653, LAYOUT),
    ("olmoe-1b-7b", "decode_32k", "pod"): (9.99516, DECODE_GATHER),
    ("olmoe-1b-7b", "decode_32k", "multipod"): (10.0963, DECODE_GATHER),
    ("kimi-k2-1t-a32b", "train_4k", "pod"): (0.692303, LAYOUT),
    ("kimi-k2-1t-a32b", "train_4k", "multipod"): (0.931104, LAYOUT),
    ("kimi-k2-1t-a32b", "prefill_32k", "pod"): (0.878436, LAYOUT),
    ("kimi-k2-1t-a32b", "prefill_32k", "multipod"): (1.29508, LAYOUT),
    ("kimi-k2-1t-a32b", "decode_32k", "pod"): (0.197599, CACHE),
    ("kimi-k2-1t-a32b", "decode_32k", "multipod"): (0.385965, CACHE),
    ("musicgen-medium", "train_4k", "pod"): (0.124859, LAYOUT),
    ("musicgen-medium", "train_4k", "multipod"): (0.147532, LAYOUT),
    ("musicgen-medium", "prefill_32k", "pod"): (0.163558, LAYOUT),
    ("musicgen-medium", "prefill_32k", "multipod"): (0.179399, LAYOUT),
    ("musicgen-medium", "decode_32k", "pod"): (0.0591797, CACHE),
    ("musicgen-medium", "decode_32k", "multipod"): (0.118148, CACHE),
    ("granite-34b", "train_4k", "pod"): (0.362648, LAYOUT),
    ("granite-34b", "train_4k", "multipod"): (0.378701, LAYOUT),
    ("granite-34b", "prefill_32k", "pod"): (0.494714, LAYOUT),
    ("granite-34b", "prefill_32k", "multipod"): (0.511182, LAYOUT),
    ("granite-34b", "decode_32k", "pod"): (1.47433, DECODE_GATHER),
    ("granite-34b", "decode_32k", "multipod"): (2.5604, DECODE_GATHER),
    ("llama3_2-1b", "train_4k", "pod"): (0.319369, LAYOUT),
    ("llama3_2-1b", "train_4k", "multipod"): (0.348811, LAYOUT),
    ("llama3_2-1b", "prefill_32k", "pod"): (0.459055, LAYOUT),
    ("llama3_2-1b", "prefill_32k", "multipod"): (0.547588, LAYOUT),
    ("llama3_2-1b", "decode_32k", "pod"): (0.0500615, CACHE),
    ("llama3_2-1b", "decode_32k", "multipod"): (0.100014, CACHE),
    ("gemma-2b", "train_4k", "pod"): (0.16483, LAYOUT),
    ("gemma-2b", "train_4k", "multipod"): (0.220704, LAYOUT),
    ("gemma-2b", "prefill_32k", "pod"): (0.333281, LAYOUT),
    ("gemma-2b", "prefill_32k", "multipod"): (0.47891, LAYOUT),
    ("gemma-2b", "decode_32k", "pod"): (2.66232, DECODE_GATHER),
    ("gemma-2b", "decode_32k", "multipod"): (5.13547, DECODE_GATHER),
    ("granite-20b", "train_4k", "pod"): (0.363636, LAYOUT),
    ("granite-20b", "train_4k", "multipod"): (0.380524, LAYOUT),
    ("granite-20b", "prefill_32k", "pod"): (0.496249, LAYOUT),
    ("granite-20b", "prefill_32k", "multipod"): (0.514361, LAYOUT),
    ("granite-20b", "decode_32k", "pod"): (1.614, DECODE_GATHER),
    ("granite-20b", "decode_32k", "multipod"): (2.80138, DECODE_GATHER),
    ("recurrentgemma-2b", "train_4k", "pod"): (0.332284, LAYOUT),
    ("recurrentgemma-2b", "train_4k", "multipod"): (0.361782, LAYOUT),
    ("recurrentgemma-2b", "prefill_32k", "pod"): (0.633672, LAYOUT),
    ("recurrentgemma-2b", "prefill_32k", "multipod"): (0.747434, LAYOUT),
    ("recurrentgemma-2b", "decode_32k", "pod"): (45.3818, DECODE_GATHER),
    ("recurrentgemma-2b", "decode_32k", "multipod"): (56.6168, DECODE_GATHER),
    ("recurrentgemma-2b", "long_500k", "pod"): (63.8835, DECODE_GATHER),
    ("recurrentgemma-2b", "long_500k", "multipod"): (63.8964, DECODE_GATHER),
    ("phi-3-vision-4_2b", "train_4k", "pod"): (0.313485, LAYOUT),
    ("phi-3-vision-4_2b", "train_4k", "multipod"): (0.321195, LAYOUT),
    ("phi-3-vision-4_2b", "prefill_32k", "pod"): (0.493293, LAYOUT),
    ("phi-3-vision-4_2b", "prefill_32k", "multipod"): (0.50172, LAYOUT),
    ("phi-3-vision-4_2b", "decode_32k", "pod"): (10.6415, DECODE_GATHER),
    ("phi-3-vision-4_2b", "decode_32k", "multipod"): (11.1764, DECODE_GATHER),
    ("xlstm-125m", "train_4k", "pod"): (0.0112465, XLSTM_WEIGHTS),
    ("xlstm-125m", "train_4k", "multipod"): (0.0193007, XLSTM_WEIGHTS),
    ("xlstm-125m", "prefill_32k", "pod"): (0.117897, XLSTM_WEIGHTS),
    ("xlstm-125m", "prefill_32k", "multipod"): (0.235507, XLSTM_WEIGHTS),
    ("xlstm-125m", "decode_32k", "pod"): (6.2963, DECODE_GATHER),
    ("xlstm-125m", "decode_32k", "multipod"): (12.0345, DECODE_GATHER),
    ("xlstm-125m", "long_500k", "pod"): (20.4819, DECODE_GATHER),
    ("xlstm-125m", "long_500k", "multipod"): (20.4848, DECODE_GATHER),
}
RATIO_TOL = 1e-4


def test_mesh_tables_cover_every_cell():
    ok = set(OK_CELLS)
    assert set(EXACT) | set(FLOP_RATIO) == ok
    assert not set(EXACT) & set(FLOP_RATIO)
    assert set(COLL_RATIO) == ok


def _kv_flops(cfg, shape) -> int:
    """One pass of the k and v projections over the cell's tokens."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return (2 * tokens * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim_
            * cfg.n_layers)


@pytest.mark.parametrize("arch,shape,mesh_name", sorted(EXACT))
def test_mesh_records_flops_equal_reference_by_term(arch, shape, mesh_name):
    rec, ref = _record(arch, shape, mesh_name), _reference(arch, shape,
                                                           mesh_name)
    got = rec["flops"] * rec["n_devices"]
    if EXACT[(arch, shape, mesh_name)] != (EQUAL,):
        spec = SHAPES[shape]
        passes = 4 if spec.kind == "train" else 1
        got -= 15 * passes * _kv_flops(get_config(arch), spec)
    want = ref["analysis"]["flops_per_device"] * ref["n_devices"]
    assert got == int(want)


@pytest.mark.parametrize("arch,shape,mesh_name", sorted(FLOP_RATIO))
def test_mesh_records_flops_against_reference(arch, shape, mesh_name):
    rec, ref = _record(arch, shape, mesh_name), _reference(arch, shape,
                                                           mesh_name)
    ratio = (rec["flops"] * rec["n_devices"]
             / (ref["analysis"]["flops_per_device"] * ref["n_devices"]))
    expected, _term = FLOP_RATIO[(arch, shape, mesh_name)]
    assert abs(ratio / expected - 1) <= RATIO_TOL


@pytest.mark.parametrize("arch,shape,mesh_name", sorted(COLL_RATIO))
def test_mesh_records_collective_bytes_against_reference(arch, shape,
                                                         mesh_name):
    rec, ref = _record(arch, shape, mesh_name), _reference(arch, shape,
                                                           mesh_name)
    ratio = (rec["collectives"]["total_bytes_per_device"]
             / ref["analysis"]["collective_bytes_per_device"])
    expected, _term = COLL_RATIO[(arch, shape, mesh_name)]
    assert abs(ratio / expected - 1) <= RATIO_TOL


# -- 8. --grad-scatter --------------------------------------------------------

def test_grad_scatter_moves_the_gradients_reduction(tmp_path, monkeypatch):
    """Llama-3.2-1B ``train_4k`` on the pod mesh with ``--grad-scatter``
    against the committed record without it: the port's gradients always
    come out sharded like the parameters, each FSDP gather's backward
    reduce-scattering its gradient over "data", so the flag is recorded
    and changes no count (the port has no counterpart of GSPMD's
    whole-gradient all-reduce of an unpinned gradient)."""
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    got = dryrun.run_cell("llama3_2-1b", "train_4k", mesh="pod",
                          grad_scatter=True, tag="_gs")
    ref = _record("llama3_2-1b", "train_4k", "pod")
    assert got["knobs"]["grad_scatter"] is True
    keys = ["flops_by_dtype", "eager_bytes", "kernels", "peak_bytes",
            "input_bytes", "ops", "least_bytes", "collectives"]
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
    assert ref["collectives"]["per_op_bytes"]["reduce-scatter"] > 0


# -- 9. the mesh roofline -----------------------------------------------------

@pytest.mark.parametrize("mesh_name", MESHES)
def test_mesh_roofline_rows(mesh_name):
    rows = roofline.load_cells(mesh=mesh_name)
    assert len(rows) == 40
    committed = json.loads(roofline.out_file(mesh_name).read_text())
    assert json.loads(json.dumps(rows)) == committed
    for row in rows:
        if row["status"] != "ok":
            continue
        rec = _record(row["arch"], row["shape"], mesh_name)
        # Every axis of both production meshes crosses nodes: 50 GB/s.
        coll = rec["collectives"]["total_bytes_per_device"] / 50e9
        assert row["collective_s"] == pytest.approx(coll, rel=1e-12)
        assert row["bound_s"] == max(row["compute_s"], row["memory_s"],
                                     row["collective_s"])
        assert row["mfu_bound"] == pytest.approx(
            row["model_flops_global"] / rec["n_devices"] / 989e12
            / row["bound_s"])
    assert roofline.render(rows).count("\n| ") == 41


def test_links_of_the_meshes():
    """Row-major ranks, eight to a node: a sub-group inside one node is
    NVLink's, any other the network's; every axis set of both production
    meshes crosses nodes."""
    for name in MESHES:
        shape = mesh.production_shape(name)
        for k in range(1, len(shape.axis_names) + 1):
            for axes in itertools.combinations(shape.axis_names, k):
                assert mesh.axis_link(shape, axes) == "network"
    two = mesh.MeshShape(("data", "model"), (2, 2))
    assert {mesh.axis_link(two, a) for a in ("data", "model")} == {"nvlink"}
    wide = mesh.MeshShape(("data", "model"), (2, 8))
    assert mesh.axis_link(wide, "model") == "nvlink"
    assert mesh.axis_link(wide, "data") == "network"
    assert roofline.collective_s({"data": 50e9, "model": 450e9}, wide) == 2.0
