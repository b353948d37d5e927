"""One rank of the port's LM stack on a CPU mesh, for the mesh tests.

Run as ``python tests/torch_mesh_ranks.py JOB.json RANK`` once per rank
(``gloo``, a ``FileStore`` named in the job); the job names the mesh and a
list of tasks, each on one scaled-down config whose reference parameters
and inputs ``torch_mesh_reference.save_inputs`` wrote. Every rank runs
every task; rank 0 gathers the results whole and writes them to the job's
``out`` file (``torch.save``): logits, MoE choices per layer, train steps
(loss, ce, grad norm, parameters and moments) and engine tokens rid by rid.
A ``count`` task reads no inputs: each rank counts one dry-run step
(``launch.dryrun.build_cell`` on its CPU shards, random weights) and
writes its own counts as JSON.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

import torch_mesh_reference as R  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.model import LM, jax_leaves, params_from_jax  # noqa: E402
from repro_torch.models.sharding import (gather_tensor, make_ctx,  # noqa: E402
                                         to_shardings)
from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.steps import train_step  # noqa: E402


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def load_inputs(job_dir: Path, task: dict):
    with np.load(job_dir / R.inputs_name(task)) as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten({k[len("params/"):]: v for k, v in flat.items()
                        if k.startswith("params/")})
    extra = {k: v for k, v in flat.items() if not k.startswith("params/")}
    return params, extra


def config(task: dict):
    return R.config(get_config, scaled_down, task)


def whole_state(lm: LM) -> dict:
    return {k: v.cpu() for k, v in lm.full_state().items()}


def whole_moments(tree: dict, lm: LM) -> dict:
    return {k: gather_tensor(t, lm.specs[k], lm.ctx.mesh).cpu()
            for k, t in tree.items()}


def run_forward(task, ctx, job_dir):
    cfg = config(task)
    params, extra = load_inputs(job_dir, task)
    lm = LM(cfg, params_from_jax(params, cfg)).shard(ctx)
    taps = []
    apply_moe = L.apply_moe

    def tap(p, x, cfg_, c=None):
        y, (logits, gate_e) = apply_moe(p, x, cfg_, c)
        B = task["tokens_shape"][0]
        c2 = ctx.for_batch(B)
        ge = gate_e
        if c2.rows_local:
            ge = ctx.mesh.all_gather(gate_e, ctx.batch_axes, 0)
        taps.append(ge.cpu())
        return y, (logits, gate_e)

    L.apply_moe = tap
    try:
        with torch.no_grad():
            toks = torch.from_numpy(extra["tokens"]).long()
            logits, _, aux = lm(tokens=toks)
            logits = lm.gather_logits(logits, toks.shape[0])
            if ctx.for_batch(toks.shape[0]).rows_local:  # rank shares
                aux = ctx.mesh.all_reduce(aux, ctx.batch_axes)
    finally:
        L.apply_moe = apply_moe
    return {"logits": logits.cpu(), "aux": aux.cpu(),
            "gate_e": [t.long() for t in taps]}


def run_train(task, ctx, job_dir):
    cfg = config(task)
    params, extra = load_inputs(job_dir, task)
    lm = LM(cfg, params_from_jax(params, cfg), trainable=True).shard(ctx)
    oc = OptConfig(grad_compress=task.get("compress"))
    opt = init_opt_state(dict(lm.named_parameters()), oc)
    batch = {"tokens": torch.from_numpy(extra["tokens"]).long(),
             "labels": torch.from_numpy(extra["labels"]).long()}
    out = {"loss": [], "ce": [], "grad_norm": []}
    for _ in range(task.get("steps", 1)):
        _, _, m = train_step(lm, opt, batch, oc,
                             n_microbatches=task.get("nmb", 1),
                             remat=task.get("remat", True),
                             loss_chunk=task.get("loss_chunk", 0),
                             ctx=ctx,
                             grad_shardings=to_shardings(lm.specs,
                                                         ctx.mesh))
        for k in out:
            out[k].append(float(m[k]))
    out["params"] = whole_state(lm)
    out["m"] = whole_moments(opt["m"], lm)
    out["v"] = whole_moments(opt["v"], lm)
    out["leaves"] = jax_leaves(out["params"])
    return out


def run_engine(task, ctx, job_dir):
    cfg = config(task)
    params, extra = load_inputs(job_dir, task)
    lm = LM(cfg, params_from_jax(params, cfg))
    sc = ServeConfig(max_batch=task["max_batch"],
                     max_prompt=task["max_prompt"], max_new=task["max_new"],
                     continuous=task.get("continuous", False),
                     slots=task.get("slots", 0))
    eng = Engine(lm, sc, ctx=ctx)
    for rid, (n, budget) in enumerate(zip(extra["prompt_lens"],
                                          extra["budgets"])):
        eng.submit(Request(rid=rid, prompt=extra["prompts"][rid, :n],
                           max_new=int(budget)))
    stats = eng.run()
    return {"tokens": {r.rid: np.asarray(r.output) for r in eng.done},
            "stats": {k: stats[k] for k in ("waves", "tokens",
                                            "decode_steps", "prefills")}}


def run_ckpt(task, ctx, job_dir):
    """``restore_sharded`` of the reference's save (params, m, v) under
    this mesh, gathered whole again; then ``save`` of the shards."""
    from repro_torch.checkpoint import restore_sharded, save
    from repro_torch.models.model import full_shapes, params_to_tree
    from repro_torch.models.sharding import param_pspecs

    cfg = config(task)
    shapes = params_to_tree(full_shapes(cfg), cfg)
    like = (shapes, {"m": shapes, "step": torch.zeros((), device="meta"),
                     "v": shapes})
    psh = to_shardings(param_pspecs(cfg, shapes, ctx.mesh), ctx.mesh)
    shardings = (psh, {"m": psh, "step": None, "v": psh})
    tree, step = restore_sharded(task["ckpt_in"], like, shardings)

    def whole(node, sh):
        if isinstance(node, dict):
            return {k: whole(v, None if sh is None else sh[k])
                    for k, v in node.items()}
        return (node if sh is None else sh.gather(node)).cpu()

    out = {"step": step,
           "tree": [whole(t, sh) for t, sh in zip(tree, shardings)],
           "local_shape": tuple(tree[0]["groups"]["l0b0_attn"]["block"]
                                ["wq"].shape)}
    if task.get("ckpt_out"):
        save(task["ckpt_out"], tree, step, shardings)
    return out


def run_world1(task, ctx, job_dir):
    """On a one-rank mesh the sharded path against the unsharded one:
    forward (logits, aux), a train step (loss, ce, grad norm, parameters,
    moments) and the engine's tokens, each compared bitwise."""
    cfg = config(task)
    params, extra = load_inputs(job_dir, task)
    state = params_from_jax(params, cfg)
    toks = torch.from_numpy(extra["tokens"]).long()
    out = {}
    with torch.no_grad():
        a = LM(cfg, state)(tokens=toks)
        b = LM(cfg, state).shard(ctx)(tokens=toks)
    out["forward"] = (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2]))
    batch = {"tokens": toks, "labels": torch.from_numpy(extra["labels"])
             .long()}
    oc = OptConfig(grad_compress=task.get("compress"))
    runs = []
    for sharded in (False, True):
        # A step updates the parameters in place: each run its own copy.
        lm = LM(cfg, {k: t.clone() for k, t in state.items()},
                trainable=True)
        if sharded:
            lm = lm.shard(ctx)
        opt = init_opt_state(dict(lm.named_parameters()), oc)
        _, _, m = train_step(lm, opt, batch, oc, n_microbatches=2,
                             ctx=lm.ctx)
        runs.append((m, lm.state_dict(), opt))
    (m0, p0, o0), (m1, p1, o1) = runs
    out["train"] = (all(torch.equal(m0[k], m1[k])
                        for k in ("loss", "ce", "grad_norm"))
                    and all(torch.equal(p0[k], p1[k]) for k in p0)
                    and all(torch.equal(o0[s][k], o1[s][k])
                            for s in ("m", "v") for k in p0))
    for cont in (False, True):
        toks_by = []
        for use in (None, ctx):
            sc = ServeConfig(max_batch=4, max_prompt=8, max_new=5,
                             continuous=cont, slots=2)
            eng = Engine(LM(cfg, state), sc, ctx=use)
            for rid, (n, budget) in enumerate(zip(extra["prompt_lens"],
                                                  extra["budgets"])):
                eng.submit(Request(rid=rid,
                                   prompt=extra["prompts"][rid, :n],
                                   max_new=int(budget)))
            eng.run()
            toks_by.append({r.rid: r.output.tolist() for r in eng.done})
        out["slots" if cont else "waves"] = toks_by[0] == toks_by[1]
    return out


def run_count(task, ctx, job_dir):
    """The dry-run's step of ``task["arch"]``'s scaled-down config at
    (``step``: its kind, ``seq``, ``batch``) built on this rank's CPU and
    counted by ``OpCounter`` here; writes ``count_{name}_rank{r}.json``:
    FLOPs by dtype, the collectives (``Counts.collectives``) and the
    peak."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    cfg = scaled_down(get_config(task["arch"]))
    shape = ShapeSpec("small", task["seq"], task["batch"], task["step"])
    counts = dryrun.count_cell(dryrun.build_cell(
        task["arch"], "small", cfg=cfg, shape=shape, mesh=ctx.mesh))
    out = {"flops": counts.flops, "collectives": counts.collectives(),
           "peak_bytes": counts.peak_bytes}
    (job_dir / f"count_{task['name']}_rank{ctx.mesh.rank}.json").write_text(
        json.dumps(out))
    return out


RUN = {"forward": run_forward, "train": run_train, "engine": run_engine,
       "ckpt": run_ckpt, "world1": run_world1, "count": run_count}


def main(job_path: str, rank: int) -> None:
    job = json.loads(Path(job_path).read_text())
    job_dir = Path(job["dir"])
    shape, axes = job["mesh"]
    world = int(np.prod(shape))
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], world),
                            rank=rank, world_size=world)
    try:
        mesh = Mesh(shape, axes, device="cpu")
        ctx = make_ctx(mesh)
        results = [RUN[t["kind"]](t, ctx, job_dir) for t in job["tasks"]]
        if rank == 0:
            torch.save(results, job["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
