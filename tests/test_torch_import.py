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


#: the modules of the single-rank substrate slice
SUBSTRATE_MODULES = (
    "parsec_tpu_torch.core.compound", "parsec_tpu_torch.device.recursive",
    "parsec_tpu_torch.device.probe", "parsec_tpu_torch.data.subtile",
    "parsec_tpu_torch.data.ops", "parsec_tpu_torch.data.redistribute",
    "parsec_tpu_torch.data.arena", "parsec_tpu_torch.utils.checkpoint")


def test_substrate_modules_load_neither_jax_nor_the_reference():
    code = ("import sys\n"
            f"for m in {SUBSTRATE_MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = [n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'parsec_tpu' or "
            "n.startswith('parsec_tpu.')]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_top_level_exports_resolve():
    """The user surface is importable from the package root; checkpoint,
    compile_ptg and NamedDatatype resolve lazily (PEP 562), as in the
    reference."""
    import parsec_tpu_torch as pt
    assert pt.DTDTaskpool.__name__ == "DTDTaskpool"
    assert callable(pt.compile_ptg) and callable(pt.compose)
    assert pt.TwoDimBlockCyclic and pt.TiledMatrix and pt.NamedDatatype
    assert pt.SymTwoDimBlockCyclic and pt.SymTwoDimBlockCyclicBand
    assert pt.SBCDistribution and pt.VectorTwoDimCyclic
    assert callable(pt.checkpoint.save) and callable(pt.checkpoint.restore)
    assert pt.READ | pt.RW | pt.AFFINITY
    assert {"checkpoint", "compile_ptg", "compose"} <= set(dir(pt))
    with pytest.raises(AttributeError):
        pt.no_such_symbol


def test_no_port_source_names_jax_or_the_reference():
    pattern = re.compile(r"\bjax\b|\bparsec_tpu\b(?!_torch)", re.IGNORECASE)
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")]
    assert len(files) >= 20
    assert {p.name for p in files} >= {"ptdtd.cpp", "ptsched.cpp",
                                       "ptsched.h", "ptexec.cpp",
                                       "ptcore.cpp", "compiler.py",
                                       "parser.py", "cli.py"}
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


def test_ptg_sources_name_neither_jax_nor_the_reference():
    """The PTG frontend and the lane it drives stand alone too: no line of
    ``dsl/ptg/`` or of the engine sources names JAX or the reference
    package, and the extension's type is the port's own."""
    pattern = re.compile(r"\bjax\b|\bjnp\b|\bparsec_tpu\b(?!_torch)")
    files = sorted((PORT / "dsl" / "ptg").glob("*.py")) + [
        PORT / "csrc" / "ptexec.cpp", PORT / "csrc" / "ptcore.cpp"]
    assert len(files) >= 6
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []
    src = (PORT / "csrc" / "ptexec.cpp").read_text()
    assert '"parsec_tpu_torch._ptexec.Graph"' in src


def test_ptg_cli_runs_without_jax():
    """``python -m parsec_tpu_torch.dsl.ptg.cli`` checks a source, counts
    its task space and rejects a bad one, importing neither JAX nor the
    reference."""
    import tempfile
    good = ("%global NT\nT(k)\n  k = 0 .. NT-1\n"
            "  CTL S <- (k > 0) ? S T(k-1)\n"
            "        -> (k < NT-1) ? S T(k+1)\nBODY\n  pass\nEND\n")
    code = ("import runpy, sys\n"
            "sys.argv = ['cli'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('parsec_tpu_torch.dsl.ptg.cli',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [n for n in sys.modules if n.split('.')[0] in"
            " ('jax', 'parsec_tpu')]\n"
            "    sys.exit(99 if bad else e.code)\n")
    with tempfile.TemporaryDirectory() as d:
        ok = pathlib.Path(d) / "ok.ptg"
        ok.write_text(good)
        bad = pathlib.Path(d) / "bad.ptg"
        bad.write_text(good.replace("BODY\n  pass\nEND\n", ""))
        r = subprocess.run([sys.executable, "-c", code, str(ok),
                            "--globals", "NT=5"], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "T(k)" in r.stdout and "5 task(s)" in r.stdout
        r = subprocess.run([sys.executable, "-c", code, str(bad)], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 1 and "BODY" in r.stderr


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


#: the observability substrate's modules
OBS_MODULES = (
    "utils.info", "utils.trace", "utils.trace_ptf2", "utils.trace_otf2",
    "utils.perf_event", "utils.grapher", "utils.native_trace", "utils.hist",
    "utils.counters", "core.pins_modules", "core.watchdog",
    "tools.trace_reader", "tools.mem_view", "tools.metrics_server",
    "tools.flight", "tools.live_view")


def test_observability_modules_import_neither_jax_nor_the_reference():
    """Each module of the observability substrate imports (in this order,
    in a fresh interpreter) with neither JAX nor the reference package in
    ``sys.modules`` after it, and none of them pulls in pandas (the card's
    host may lack it: ``to_dataframe`` imports it lazily)."""
    code = (
        "import sys\n"
        f"mods = {OBS_MODULES!r}\n"
        "for m in mods:\n"
        "    __import__('parsec_tpu_torch.' + m)\n"
        "    bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'parsec_tpu', 'pandas')]\n"
        "    if bad:\n"
        "        print(m, bad[:3]); sys.exit(1)\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) == 16
    assert all((PORT / (m.replace(".", "/") + ".py")).exists()
               for m in OBS_MODULES)


def test_trace_reader_cli_runs_without_jax(tmp_path):
    """``python -m parsec_tpu_torch.tools.trace_reader`` summarizes a trace
    and writes its chrome JSON, importing neither JAX nor the reference."""
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_END, Profiling
    prof = Profiling()
    kb, ke = prof.add_dictionary_keyword("unit::work")
    st = prof.stream("worker-0")
    for i in range(3):
        st.trace(kb, i, 1, 0)
        st.trace(ke, i, 1, EVENT_FLAG_END)
    path = prof.dump(str(tmp_path / "t.pbp"))
    out = str(tmp_path / "t.json")
    code = ("import runpy, sys\n"
            "sys.argv = ['trace_reader'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('parsec_tpu_torch.tools.trace_reader',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [n for n in sys.modules if n.split('.')[0] in"
            " ('jax', 'parsec_tpu')]\n"
            "    sys.exit(99 if bad else e.code)\n")
    r = subprocess.run([sys.executable, "-c", code, path, "--ctf", out],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 keywords, 1 streams, 6 events" in r.stdout
    import json
    assert len([e for e in json.load(open(out))["traceEvents"]
                if e.get("ph") == "X"]) == 3
