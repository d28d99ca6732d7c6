"""The port imports nothing of the JAX package and nothing of JAX.

Every module of ``pfann_tpu_torch`` is imported in a fresh interpreter
whose ``sys.meta_path`` refuses ``pfann_tpu`` and ``jax`` (and their
submodules), and the syntax trees of ``chip_smoke.py`` and
``tools/torch_kernel_sweep.py`` name neither.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("pfann_tpu", "jax")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import pfann_tpu_torch
names = ["pfann_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(pfann_tpu_torch.__path__, "pfann_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print("\n".join(names))
"""


def _module_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_modules_import_without_pfann_tpu_or_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD % (FORBIDDEN,)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    for expected in ("pfann_tpu_torch.builder", "pfann_tpu_torch.matcher",
                     "pfann_tpu_torch.index.screen", "pfann_tpu_torch.data.musicdata",
                     "pfann_tpu_torch.audio.stream", "pfann_tpu_torch.utils.logging",
                     "pfann_tpu_torch.extractemb", "pfann_tpu_torch.matchemb",
                     "pfann_tpu_torch.matchfromgt", "pfann_tpu_torch.rebuild",
                     "pfann_tpu_torch.cppmatcher", "pfann_tpu_torch.genquery",
                     "pfann_tpu_torch.index.search", "pfann_tpu_torch.index.native",
                     "pfann_tpu_torch.index.saliency", "pfann_tpu_torch.data.noise",
                     "pfann_tpu_torch.data.ir", "pfann_tpu_torch.data.querygen"):
        assert expected in names


def test_chip_smoke_imports_neither():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = list(_module_names(tree))
    assert "pfann_tpu_torch.builder" in names or "pfann_tpu_torch" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_kernel_sweep_imports_neither():
    """The port's tuning script lives outside the package, so the import
    walk above does not reach it."""
    with open(os.path.join(REPO, "tools", "torch_kernel_sweep.py")) as f:
        names = list(_module_names(ast.parse(f.read())))
    assert "pfann_tpu_torch.index.align_kernel" in names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]
