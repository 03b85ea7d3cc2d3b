"""The port imports no JAX, and its chip smoke refuses to run without a GPU.

Every module of hashgan_tpu_torch, chip_smoke.py and the port's scripts
load in a fresh
interpreter in which the JAX package ``hashgan_tpu`` cannot be imported,
without jax, flax or optax entering sys.modules. Subprocesses are needed
because this pytest process has imported jax already (tests/conftest.py).
Imports inside functions do not run on loading, so the sources are also
scanned for import statements."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("hashgan_tpu", "jax", "jaxlib", "flax", "optax")

_PROBE = """
import importlib, importlib.abc, json, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "hashgan_tpu":
            raise ImportError(f"the port imported the JAX package: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import hashgan_tpu_torch
names = ["hashgan_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(hashgan_tpu_torch.__path__,
                                          "hashgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import scripts.bench_scan_variants_torch
import scripts.bench_large_k_select_torch
print(json.dumps({"modules": names, "jax": sorted(
    m for m in ("jax", "jaxlib", "flax", "optax") if m in sys.modules)}))
"""


def _run(args, cwd, pythonpath):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    out = _run(["-c", _PROBE], cwd=REPO, pythonpath=REPO)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("index.server", "ops.mxu_large_k", "ops.slab_scan",
                 "ops.groupmin", "ops.mxu_scan", "ops.scan_variants",
                 "bench", "bench_scan", "bench_serve", "entry",
                 "models.alexnet", "models.layers", "models.gan",
                 "losses.wgan_gp", "train.gan_step", "eval.sample_quality",
                 "utils.images", "data.cifar10", "data.lists",
                 "data.loader", "parallel", "parallel.mesh",
                 "parallel.sharded_scan", "parallel.data_parallel",
                 "eval.sharded", "ops.ref_numpy", "ops.native",
                 "utils.profiling"):
        assert f"hashgan_tpu_torch.{name}" in got["modules"]
    assert len(got["modules"]) >= 40
    assert got["jax"] == [], f"JAX modules imported by the port: {got['jax']}"


PORT_SCRIPTS = sorted(
    os.path.relpath(f, REPO) for pattern in ("*_torch.py", "profile_torch_*.py")
    for f in glob.glob(os.path.join(REPO, "scripts", pattern)))


@pytest.mark.parametrize("where", ["chip_smoke.py", "hashgan_tpu_torch",
                                   *PORT_SCRIPTS])
def test_no_import_statement_reaches_jax(where):
    path = os.path.join(REPO, where)
    files = ([path] if path.endswith(".py") else
             glob.glob(os.path.join(path, "**", "*.py"), recursive=True))
    assert files
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN, (
                    f"{os.path.relpath(f, REPO)}:{node.lineno} imports {m}")
        assert "spec_from_file_location" not in ast.unparse(tree), f


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    # Here there is no GPU: the script must stop at require_cuda().
    out = _run(["chip_smoke.py"], cwd=REPO, pythonpath=None)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout
    # Alone in a directory, without the package, it fails as well.
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=str(tmp_path), pythonpath=None)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
