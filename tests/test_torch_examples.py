"""The port's single-rank examples (``examples_torch/``: ex00 start/stop,
ex01 hello world, ex02, ex04, ex05 and ex06 (PTG), ex07 (DTD POTRF),
ex11 (graph capture) and ex16 (redistribution)) run green on a CPU context, each in its own
interpreter, and none of them imports JAX or the reference package."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

EX_DIR = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"
EXAMPLES = ["ex00", "ex01", "ex02", "ex04", "ex05", "ex06", "ex07",
            "ex11", "ex16"]


def _script(ex: str) -> pathlib.Path:
    return next(p for p in sorted(EX_DIR.glob(f"{ex}_*.py")))


@pytest.mark.parametrize("ex", EXAMPLES)
def test_port_example_runs_on_the_cpu(ex):
    env = dict(os.environ, EXAMPLES_CPU="1")
    out = subprocess.run([sys.executable, _script(ex).name], cwd=EX_DIR,
                         env=env, capture_output=True, text=True,
                         timeout=110)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "expect" in out.stdout or "max err" in out.stdout


@pytest.mark.parametrize("ex", EXAMPLES)
def test_port_example_imports_neither_jax_nor_the_reference(ex):
    roots = set()
    for node in ast.walk(ast.parse(_script(ex).read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "jax" not in roots and "parsec_tpu" not in roots
    assert "parsec_tpu_torch" in roots
