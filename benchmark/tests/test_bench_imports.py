"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``modkit_tpu_torch`` is not ``modkit_tpu``); the
generator, the reference and the control import nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import run
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
SOURCES = sorted(glob.glob(os.path.join(BENCH, "*.py"))
                 + glob.glob(os.path.join(BENCH, "metrics", "*.py")))
PLAIN = ("gen.py", "bamio.py", "reference.py", "control.py", "estimate.py")


def _imports(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=os.path.basename)
def test_no_jax(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("name", PLAIN)
def test_plain_modules_import_nothing_of_the_program(name):
    assert not _imports(os.path.join(BENCH, name)) & {"modkit_tpu_torch", "torch"}


def test_loaded_modules():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.gen, benchmark.reference, benchmark.control, benchmark.estimate; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'modkit_tpu', 'modkit_tpu_torch', 'torch'}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole():
    assert "modkit_tpu_torch" not in run.FORBIDDEN
    sys.modules.setdefault("modkit_tpu_torch_probe", sys)
    try:
        assert "modkit_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["modkit_tpu_torch_probe"]
