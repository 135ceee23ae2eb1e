"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` imports in a process where importing ``jax`` or
``repro`` raises, and no import statement in them or in the
``examples/*_torch.py`` twins (lazy ones included) names either."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
BANNED = ("jax", "jaxlib", "repro")

GUARD = f"""
import importlib, pkgutil, sys

class Banned:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ImportError("banned import: " + name)

sys.meta_path.insert(0, Banned())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {ROOT!r})
import chip_smoke
print(" ".join(names))
"""


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", GUARD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(out.stdout.split())
    for pkg in ("train", "data", "launch", "sharding"):
        assert f"repro_torch.{pkg}" in names
    assert {"repro_torch.train.optimizer", "repro_torch.train.train_step",
            "repro_torch.train.checkpoint", "repro_torch.train.elastic",
            "repro_torch.data.pipeline", "repro_torch.launch.train"} <= names
    assert {"repro_torch.sharding.rules", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.dryrun",
            "repro_torch.launch.sweep", "repro_torch.launch.report",
            "repro_torch.launch.roofline", "repro_torch.launch.census_dryrun",
            "repro_torch.configs.triad_census"} <= names


def _sources():
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    examples = os.path.join(ROOT, "examples")
    for f in sorted(os.listdir(examples)):
        if f.endswith("_torch.py"):
            yield os.path.join(examples, f)


def test_no_import_statement_names_jax_or_repro():
    found = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [(path, m) for m in mods if m.split(".")[0] in BANNED]
    assert not found
