"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program: by the top-level name of every
import in the sources, and of every module loaded in a fresh process."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "flacenc_tpu"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not FORBIDDEN & set(_imported(path)), path


def test_reference_and_check_import_nothing_of_the_program():
    paths = list(_sources("reference")) + [os.path.join(HERE, "check.py"),
                                           os.path.join(HERE, "control.py")]
    for path in paths:
        assert "flacenc_tpu_torch" not in set(_imported(path)), path


@pytest.mark.parametrize("module,banned", [
    ("benchmark.reference.encoder", FORBIDDEN | {"flacenc_tpu_torch", "torch"}),
    ("benchmark.check", FORBIDDEN | {"flacenc_tpu_torch", "torch"}),
    ("benchmark.run", FORBIDDEN),
])
def test_loaded_modules(module, banned):
    code = ("import importlib, sys; importlib.import_module(%r); "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % module)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, check=True, timeout=120).stdout.split()
    assert not banned & set(out)
