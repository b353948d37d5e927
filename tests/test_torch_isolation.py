"""The port imports neither JAX nor the reference package.

In a fresh interpreter, ``jax`` and ``repro`` are blocked
(``sys.modules[name] = None`` makes any import of them raise), then every
module of ``repro_torch`` found by ``pkgutil.walk_packages`` is imported;
so is each of the port's examples, ``examples/*_torch.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = ("quickstart_torch", "knn_recommend_torch", "serve_demo_torch",
            "train_lm_torch", "distributed_knn_torch")

PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import repro_torch
failed = []
seen = []
def onerror(name):
    failed.append((name, repr(sys.exc_info()[1])))
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.",
                                  onerror=onerror):
    seen.append(info.name)
    try:
        importlib.import_module(info.name)
    except Exception as exc:
        failed.append((info.name, repr(exc)))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(json.dumps([seen, failed, leaked]))
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(SRC.parent))
    assert out.returncode == 0, out.stderr
    seen, failed, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert failed == [], failed
    assert leaked == [], leaked
    # Every module of the port was walked, the LM stack's (its sharding
    # rules included), training's and the analysis tools' included.
    on_disk = {p.relative_to(SRC).with_suffix("").as_posix()
               .replace("/", ".").removesuffix(".__init__")
               for p in (SRC / "repro_torch").rglob("*.py")}
    assert set(seen) | {"repro_torch"} == on_disk
    for name in ("repro_torch.models.model", "repro_torch.models.sharding",
                 "repro_torch.configs.shapes",
                 "repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.train.optimizer", "repro_torch.train.steps",
                 "repro_torch.train.router_stats",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.data.tokens", "repro_torch.launch.train",
                 "repro_torch.launch.mesh", "repro_torch.launch.specs",
                 "repro_torch.launch.op_analysis",
                 "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                 "repro_torch.core.distributed", "repro_torch.query.sharded"):
        assert name in seen


EXAMPLE_PROBE = r"""
import importlib.util, json, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
failed = []
for name in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(name, f"examples/{name}.py")
    try:
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    except Exception as exc:
        failed.append((name, repr(exc)))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
print(json.dumps([failed, leaked]))
"""


def test_port_examples_import_neither_jax_nor_repro():
    root = SRC.parent
    on_disk = {p.stem for p in (root / "examples").glob("*_torch.py")}
    assert on_disk == set(EXAMPLES)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", EXAMPLE_PROBE, *EXAMPLES],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(root))
    assert out.returncode == 0, out.stderr
    failed, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert failed == [], failed
    assert leaked == [], leaked
