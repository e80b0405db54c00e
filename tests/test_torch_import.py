"""Import hygiene of the port and its data bridge to the reference package.

The port stands alone: importing it pulls in neither JAX nor the reference
package, and no source file under ``parsec_tpu_torch/`` names either.
``collection_from_numpy`` / ``to_dense`` carry a reference collection's
matrix into the port bit for bit.
"""

import ast
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefMatrix
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import collection_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "parsec_tpu_torch"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, parsec_tpu_torch\n"
        "for m in pkgutil.walk_packages(parsec_tpu_torch.__path__, "
        "'parsec_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'parsec_tpu' or n.startswith('parsec_tpu.')]\n"
        "print(len([n for n in sys.modules if n.startswith('parsec_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15     # every module imported


def test_no_port_source_names_jax_or_the_reference():
    pattern = re.compile(r"\bjax\b|\bparsec_tpu\b(?!_torch)", re.IGNORECASE)
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")]
    assert len(files) >= 20
    assert {p.name for p in files} >= {"ptdtd.cpp", "ptsched.cpp",
                                       "ptsched.h"}
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []


def _import_roots(script: str) -> set:
    names = set()
    for node in ast.walk(ast.parse((ROOT / script).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    roots = _import_roots("chip_smoke.py")
    assert "jax" not in roots and "parsec_tpu" not in roots
    assert "parsec_tpu_torch" in roots


@pytest.mark.parametrize("script", ["chain_variants.py", "flash_variants.py"])
def test_variant_scripts_import_neither_jax_nor_the_reference(script):
    roots = _import_roots(script)
    assert "jax" not in roots and "parsec_tpu" not in roots
    assert "parsec_tpu_torch" in roots


def test_context_runs_on_cuda_by_default_or_raises():
    if torch.cuda.is_available():
        ctx = Context(nb_cores=1)
        try:
            assert ctx.device.type == "cuda"
        finally:
            ctx.fini()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Context(nb_cores=1)
    ctx = Context(nb_cores=1, device="cpu")
    ctx.fini()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collection_round_trip_is_bit_exact(dtype):
    """A reference collection's dense matrix goes into the port tile for
    tile (same tiling, same values) and comes back unchanged."""
    rng = np.random.default_rng(21)
    dense = rng.standard_normal((96, 80)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = RefMatrix("R", 96, 80, 32, 16, P=1, Q=1, dtype=jdt)
    ref.fill(lambda m, n: dense[m * 32:(m + 1) * 32, n * 16:(n + 1) * 16])
    ref_dense = ref.to_dense()
    port = collection_from_numpy("R", ref_dense, 32, 16)
    assert (port.mt, port.nt, port.mb, port.nb) == (ref.mt, ref.nt, 32, 16)
    assert port.dtype == getattr(torch, dtype)
    for m in range(ref.mt):
        for n in range(ref.nt):
            want = np.asarray(ref.data_of(m, n).newest_copy().payload,
                              np.float32)
            got = port.data_of(m, n).newest_copy().payload.float().numpy()
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.to_dense(),
                                  ref_dense.astype(np.float32))
