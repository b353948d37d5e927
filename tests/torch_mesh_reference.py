"""The JAX reference's LM stack on emulated host-device meshes, for the
mesh tests: the counterpart of ``torch_mesh_ranks.py``.

``save_inputs`` (imported by the tests) writes one scaled-down config's
reference parameters and inputs, and ``run_job`` runs a job on both
sides; ``python tests/torch_mesh_reference.py JOB.json`` runs every mesh
of the job in one process (or, for a job with ``ckpt``, saves a
training state sharded over the job's mesh), with
``--xla_force_host_platform_device_count`` set before JAX starts, on an
``Auto`` ``jax.sharding.Mesh`` built from the device array (``jax.make_mesh``
gives ``Explicit`` axes, on which the reference's sharded forward does not
trace), and pickles the results to the job's ``ref_out``.
"""
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# The unsharded train-step tests' cut of the recurrent configs to one
# group of their two block kinds (test_torch_train_step.py's CUTS), which
# their tolerances were measured on; a task with "cut" uses it.
CUTS = {
    "recurrentgemma-2b": dict(n_layers=2, block_pattern=(
        ("rglru", "mlp"), ("local_attn", "mlp"))),
    "xlstm-125m": dict(n_layers=2, block_pattern=(("mlstm",), ("slstm",))),
}


def config(get_config, scaled_down, task: dict):
    """The task's f32 scaled-down config (either package's functions)."""
    cut = CUTS[task["arch"]] if task.get("cut") else {}
    return scaled_down(get_config(task["arch"]), dtype="float32", **cut)


def inputs_name(task: dict) -> str:
    return f"inputs_{task['arch']}{'_cut' if task.get('cut') else ''}.npz"


def save_inputs(job_dir: Path, task: dict, *, seed: int = 0, batch: int = 4,
                seq: int = 8, n_requests: int = 8, max_prompt: int = 8):
    """The reference's ``init_params`` of the task's config and the
    inputs every task on it reads, to ``inputs_name(task)``."""
    import jax

    from repro.configs import get_config
    from repro.models.config import scaled_down
    from repro.models.model import init_params

    cfg = config(get_config, scaled_down, task)
    params = jax.tree.map(np.asarray, init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    prompt_lens = rng.integers(2, max_prompt + 1, n_requests)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_requests, max_prompt)).astype(np.int32)
    budgets = rng.integers(1, 6, n_requests)
    np.savez(Path(job_dir) / inputs_name(task), tokens=toks,
             labels=labels, prompts=prompts, prompt_lens=prompt_lens,
             budgets=budgets,
             **{f"params/{k}": v for k, v in flatten(params).items()})


def _load(job_dir: Path, task: dict):
    with np.load(job_dir / inputs_name(task)) as z:
        flat = {k: z[k] for k in z.files}
    params: dict = {}
    for key, arr in flat.items():
        if not key.startswith("params/"):
            continue
        node = params
        *path, leaf = key[len("params/"):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return params, {k: v for k, v in flat.items()
                    if not k.startswith("params/")}


def run(job: dict) -> list:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.models import layers as L
    from repro.models.config import scaled_down
    from repro.models.model import _apply_block, _flat_pattern, forward
    from repro.models.sharding import make_ctx, param_pspecs, to_shardings
    from repro.serve import engine as E
    from repro.train.optimizer import (OptConfig, _global_norm,
                                       init_opt_state, quantize_int8)
    from repro.train.steps import loss_fn, train_step

    job_dir = Path(job["dir"])
    out = []
    for mesh_job in job["meshes"]:
        shape, axes = mesh_job["mesh"]
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
        results = []
        for task in mesh_job["tasks"]:
            cfg = config(get_config, scaled_down, task)
            host, extra = _load(job_dir, task)
            if task.get("ref_mesh", True):
                ctx = make_ctx(mesh)
                sh = to_shardings(param_pspecs(cfg, host, mesh), mesh)
                params = jax.device_put(jax.tree.map(jnp.asarray, host), sh)
            else:  # the reference's one-device program
                ctx, sh = make_ctx(None), None
                params = jax.tree.map(jnp.asarray, host)
            if task["kind"] == "forward":
                toks = jnp.asarray(extra["tokens"])
                logits, _, aux = jax.jit(lambda p, t: forward(
                    p, cfg, ctx, tokens=t))(params, toks)
                res = {"logits": np.asarray(logits), "aux": np.asarray(aux)}
                if cfg.n_experts:
                    res["gate_e"] = [np.asarray(g) for g in jax.jit(
                        lambda p, t: _moe_taps(p, t, cfg, ctx, L,
                                               _apply_block, _flat_pattern))(
                        params, toks)]
            elif task["kind"] == "train":
                oc = OptConfig(grad_compress=task.get("compress"))
                opt = init_opt_state(params, oc)
                batch = {"tokens": jnp.asarray(extra["tokens"]),
                         "labels": jnp.asarray(extra["labels"])}
                nmb = task.get("nmb", 1)
                remat = task.get("remat", True)
                chunk = task.get("loss_chunk", 0)

                def gnorm(p, b, o):
                    def g_of(mb):
                        return jax.grad(lambda q: loss_fn(
                            q, mb, cfg, ctx, remat, chunk)[0])(p)
                    if nmb <= 1:
                        g = g_of(b)
                    else:
                        mbs = [jax.tree.map(
                            lambda x: x.reshape((nmb, -1) + x.shape[1:])[i],
                            b) for i in range(nmb)]
                        gs = [g_of(mb) for mb in mbs]
                        g = jax.tree.map(lambda *xs: sum(xs) / nmb, *gs)
                    if oc.grad_compress == "int8":
                        g = jax.tree.map(lambda a, e: quantize_int8(a, e)[0],
                                         g, o["err"])
                    return _global_norm(g)

                gn = float(jax.jit(gnorm)(params, batch, opt))
                new_p, new_o, m = jax.jit(lambda p, o, b: train_step(
                    p, o, b, cfg, ctx, oc, n_microbatches=nmb, remat=remat,
                    loss_chunk=chunk, grad_shardings=sh))(params, opt, batch)
                res = {"loss": [float(m["loss"])], "ce": [float(m["ce"])],
                       "grad_norm": [gn],
                       "params": flatten(jax.tree.map(np.asarray, new_p)),
                       "m": flatten(jax.tree.map(np.asarray, new_o["m"])),
                       "v": flatten(jax.tree.map(np.asarray, new_o["v"]))}
            else:
                sc = E.ServeConfig(max_batch=task["max_batch"],
                                   max_prompt=task["max_prompt"],
                                   max_new=task["max_new"],
                                   continuous=task.get("continuous", False),
                                   slots=task.get("slots", 0))
                eng = E.Engine(params, cfg, sc, ctx=ctx)
                for rid, (ln, b) in enumerate(zip(extra["prompt_lens"],
                                                  extra["budgets"])):
                    eng.submit(E.Request(rid=rid,
                                         prompt=extra["prompts"][rid, :ln],
                                         max_new=int(b)))
                stats = eng.run()
                res = {"tokens": {r.rid: np.asarray(r.output)
                                  for r in eng.done},
                       "stats": {k: stats[k] for k in (
                           "waves", "tokens", "decode_steps", "prefills")}}
            results.append(res)
        out.append(results)
    return out


def _moe_taps(params, toks, cfg, ctx, L, apply_block, flat_pattern):
    """Every MoE layer's expert choices: the reference's forward unrolled
    over groups, the MoE blocks called through ``apply_moe``."""
    import jax
    import jax.numpy as jnp

    x = params["embed"][toks].astype(jnp.dtype(cfg.dtype))
    if cfg.scale_embed:
        x = x * jnp.asarray(np.sqrt(cfg.d_model), x.dtype)
    B, S, _ = x.shape
    x = ctx.csp(x, ctx.batch_axes, None, None)
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    taps = []
    for g in range(cfg.n_groups):
        gp = jax.tree.map(lambda a: a[g], params["groups"])
        for name, kind in flat_pattern(cfg):
            if kind == "moe":
                h = L.apply_rmsnorm(gp[name]["norm"], x)
                y, (_, gate_e) = L.apply_moe(gp[name]["block"], h, cfg, ctx)
                x = x + y
                taps.append(gate_e)
            else:
                x, _, _ = apply_block(kind, gp[name], x, cfg, ctx,
                                      cache=None, cur_index=None,
                                      positions=positions, want_cache=False,
                                      s_alloc=0)
    return taps


def save_sharded(job: dict) -> None:
    """The reference's ``checkpoint.save`` of (params, {"step", "m",
    "v"}) from the job's npz, each leaf placed under the job's mesh
    first, as a sharded training state is saved."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.checkpoint import save
    from repro.configs import get_config
    from repro.models.config import scaled_down
    from repro.models.sharding import param_pspecs, to_shardings

    shape, axes = job["mesh"]
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(axes))
    cfg = scaled_down(get_config(job["arch"]), dtype="float32")
    with np.load(job["tree"]) as z:
        flat = {k: z[k] for k in z.files}
    trees = {}
    for part in ("params", "m", "v"):
        node_all: dict = {}
        for key, arr in flat.items():
            if key.startswith(part + "/"):
                node = node_all
                *path, leaf = key[len(part) + 1:].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = arr
        sh = to_shardings(param_pspecs(cfg, node_all, mesh), mesh)
        trees[part] = jax.device_put(jax.tree.map(jnp.asarray, node_all), sh)
    opt = {"step": jnp.asarray(job["step"], jnp.int32), "m": trees["m"],
           "v": trees["v"]}
    save(job["ckpt"], (trees["params"], opt), job["step"])


if __name__ == "__main__":
    job = json.loads(Path(sys.argv[1]).read_text())
    n = (int(np.prod(job["mesh"][0])) if "ckpt" in job else
         max(int(np.prod(m["mesh"][0])) for m in job["meshes"]))
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               f"--xla_force_host_platform_device_count={n}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "ckpt" in job:
        save_sharded(job)
    else:
        with open(job["ref_out"], "wb") as f:
            pickle.dump(run(job), f)


def _env() -> dict:
    here = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=str(here.parent / "src"),
                JAX_PLATFORMS="cpu")


def launch_port(job_dir: Path, name: str, mesh, tasks) -> tuple:
    """Start one process a rank of ``torch_mesh_ranks.py`` on ``mesh``
    ([shape, axes]); returns (processes, the results file)."""
    import subprocess

    here = Path(__file__).resolve().parent
    job = {"dir": str(job_dir), "mesh": mesh, "tasks": tasks,
           "store": str(job_dir / f"store_{name}"),
           "out": str(job_dir / f"port_{name}.pt")}
    (job_dir / f"port_{name}.json").write_text(json.dumps(job))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_mesh_ranks.py"),
         str(job_dir / f"port_{name}.json"), str(r)],
        env=_env(), stderr=subprocess.PIPE, text=True)
        for r in range(int(np.prod(mesh[0])))]
    return procs, job["out"]


def launch_reference(job_dir: Path, name: str, job: dict):
    """Start this script on ``job`` (its ``ref_out`` set here)."""
    import subprocess

    job = dict(job, ref_out=str(job_dir / f"ref_{name}.pkl"))
    path = job_dir / f"ref_{name}.json"
    path.write_text(json.dumps(job))
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(path)],
        env=_env(), stderr=subprocess.PIPE, text=True), job["ref_out"]


def wait(procs, timeout: int = 600) -> None:
    errs = [p.communicate(timeout=timeout)[1] for p in procs]
    for p, err in zip(procs, errs):
        if p.returncode:
            raise RuntimeError(f"{p.args[1:]} exited {p.returncode}:\n"
                               f"{err[-4000:]}")


def load_port(path):
    import torch
    return torch.load(path, weights_only=False)


def load_reference(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_job(job_dir: Path, meshes: list, *, timeout: int = 600):
    """Write the inputs of every arch the ``meshes`` tasks name, then run
    the reference (one process, every mesh) and the port (one process a
    rank, a ``FileStore`` under ``job_dir``, every mesh at once) side by
    side. ``meshes``: [{"mesh": [shape, axes], "tasks": [...]}, ...].
    Returns (reference results, port results), one list of task results
    a mesh."""
    job_dir = Path(job_dir)
    seen = {}
    for m in meshes:
        for t in m["tasks"]:
            seen.setdefault(inputs_name(t), t)
    for t in seen.values():
        save_inputs(job_dir, t)
    ref, ref_out = launch_reference(job_dir, "all", {
        "dir": str(job_dir), "meshes": meshes})
    procs, outs = [ref], []
    for i, m in enumerate(meshes):
        ps, out = launch_port(job_dir, str(i), m["mesh"], m["tasks"])
        procs += ps
        outs.append(out)
    wait(procs, timeout)
    return load_reference(ref_out), [load_port(o) for o in outs]
