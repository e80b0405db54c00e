"""The port's examples (``examples_torch/``: ex00 start/stop, ex01 hello
world, ex02, ex04, ex05 and ex06 (PTG), ex07 (DTD POTRF), ex11 (graph
capture), ex16 (redistribution), and the distributed ex03 (a chain across
ranks), ex08 (PTG GEMM on 4 ranks), ex09 (the TCP launcher), ex14
(device payloads across processes), ex17 (the serving fabric) and the
mesh examples ex10 (the five parallelism modes), ex12 (mesh capture and
the data bridge), ex13 (LM training over dp x tp with a checkpoint) and
ex15 (two "hosts" of four ranks)) run
green on the CPU, each in its own interpreter (ex09 and ex14 as 2
processes through ``python -m parsec_tpu_torch.launch --cpu``, ex17 as
the 2 processes it starts, ex10, ex12 and ex13 as the 8-rank group they
start,
ex15 as its 8 rank interpreters), and none of them imports JAX or the
reference package."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

EX_DIR = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"
EXAMPLES = ["ex00", "ex01", "ex02", "ex03", "ex04", "ex05", "ex06", "ex07",
            "ex08", "ex11", "ex16"]
#: the examples a user starts through the launcher, with its options
LAUNCHED = {"ex09": [], "ex14": ["--mca", "comm_device_mem", "1"]}
#: the examples that start their own ranks (``run_distributed_procs``)
SELF_LAUNCHED = ["ex17"]
#: the examples that start a rank group of their own (a ``RankPool`` of 8
#: ranks, or ``run_multicontroller``'s 2 x 4 rank interpreters)
MESHES = ["ex10", "ex12", "ex13", "ex15"]


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


@pytest.mark.parametrize("ex", sorted(LAUNCHED))
def test_port_example_runs_through_the_launcher_on_the_cpu(ex):
    """Two OS ranks on the TCP mesh, under the port's job lock."""
    import time

    from parsec_tpu_torch.launch import multiproc_lock as port_lock
    # the port's lock is taken before the launcher starts, which then runs
    # inside it instead of queueing on it within the subprocess's limit
    with port_lock():
        env = dict(os.environ, EXAMPLES_CPU="1")
        out = subprocess.run(
            [sys.executable, "-m", "parsec_tpu_torch.launch", "-n", "2",
             "--cpu", *LAUNCHED[ex], str(_script(ex))],
            cwd=EX_DIR.parent, env=env, capture_output=True, text=True,
            timeout=200)
    time.sleep(0.5)   # the lock is not fair: let a waiting job in
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.count("rank") >= 2


@pytest.mark.parametrize("ex", MESHES)
def test_port_mesh_example_runs_its_rank_group_on_the_cpu(ex):
    """Eight CPU ranks the example starts itself, under the port's job
    lock (its own jobs then run inside the held lock)."""
    import time

    from parsec_tpu_torch.launch import multiproc_lock as port_lock
    with port_lock():
        env = dict(os.environ, EXAMPLES_CPU="1")
        out = subprocess.run([sys.executable, _script(ex).name],
                             cwd=EX_DIR, env=env, capture_output=True,
                             text=True, timeout=200)
    time.sleep(0.5)   # the lock is not fair: let a waiting job in
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"{ex} OK" in out.stdout


@pytest.mark.parametrize("ex", SELF_LAUNCHED)
def test_port_example_starts_its_own_ranks_on_the_cpu(ex):
    """Two OS ranks the example starts itself, under the port's job lock
    (its own ranks then run inside the held lock)."""
    import time

    from parsec_tpu_torch.launch import multiproc_lock as port_lock
    with port_lock():
        env = dict(os.environ, EXAMPLES_CPU="1")
        out = subprocess.run([sys.executable, _script(ex).name],
                             cwd=EX_DIR, env=env, capture_output=True,
                             text=True, timeout=200)
    time.sleep(0.5)   # the lock is not fair: let a waiting job in
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"{ex} OK" in out.stdout


def test_launcher_without_a_card_raises_unless_asked_for_the_cpu():
    """Without ``--cpu`` a job needs a card: where the probe finds none
    (here: the probe is told so), the launcher raises with the probe's
    reason and starts no rank, rather than moving the job to the CPU."""
    env = dict(os.environ, PARSEC_TPU_TORCH_FORCE_CPU="1")
    out = subprocess.run(
        [sys.executable, "-m", "parsec_tpu_torch.launch", "-n", "2",
         str(_script("ex09"))],
        cwd=EX_DIR.parent, env=env, capture_output=True, text=True,
        timeout=100)
    assert out.returncode != 0
    assert "no CUDA card for the job: PARSEC_TPU_TORCH_FORCE_CPU=1" \
        in out.stderr, out.stderr[-2000:]
    assert "rank" not in out.stdout


@pytest.mark.parametrize("ex", EXAMPLES + sorted(LAUNCHED) + SELF_LAUNCHED +
                         MESHES)
def test_port_example_imports_neither_jax_nor_the_reference(ex):
    roots = set()
    for node in ast.walk(ast.parse(_script(ex).read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "jax" not in roots and "parsec_tpu" not in roots
    assert "parsec_tpu_torch" in roots
