"""The port's distributed runtime over the cross-process TCP backend.

The reference's ``tests/test_tcp_distributed.py`` on the port
(``parsec_tpu_torch/comm/tcp.py``, ``launch.py``, ``comm/xhost.py``): the
same GEMM/POTRF flows as ``test_torch_distributed.py`` (ranks as threads in
one process) with N REAL OS processes joined by the TCP mesh, forked from a
forkserver that never touches CUDA. The CUDA IPC plane (``--mca comm_device_mem 1``) moves
CUDA tensors, so its cases run on the card (``cuda`` marker); the
shared-memory half of the plane is tested in ``test_torch_xhost.py``.

Program functions live at module top level so a forkserver rank can
import them. Every multiprocess job holds the port's job lock; none takes
the reference package's, whose own jobs wait for it inside their time
limits.
"""

import os

import numpy as np
import pytest
import torch

from parsec_tpu_torch.comm.tcp import run_distributed_procs as _run_procs

N, TS = 32, 16
_SEED = 11

#: the CUDA IPC plane moves CUDA tensors: these cases need the card
_needs_card = [pytest.mark.cuda,
               pytest.mark.skipif(not torch.cuda.is_available(),
                                  reason="needs a CUDA card (CUDA IPC)")]


def _card(fn):
    for m in _needs_card:
        fn = m(fn)
    return fn


def run_distributed_procs(*args, **kw):
    """The port's process launcher, which takes the port's job lock. The
    lock is not fair: a pause after each job lets a job waiting on it (it
    polls every 0.2 s) in before this file's next job."""
    import time

    try:
        return _run_procs(*args, **kw)
    finally:
        time.sleep(0.5)


def _force_cpu():
    """The ranks run on the CPU (every context below asks for it)."""


# -------------------------------------------------- failure attribution unit

def test_transport_error_classification():
    """Typed checks first; transfer-plane markers attribute outright; weak
    markers (words ordinary local errors also use) are at most ambiguous
    (substring matching alone would let a local RuntimeError containing
    'RESET' mark a live peer dead)."""
    from parsec_tpu_torch.comm.tcp import classify_transport_error as cls

    assert cls(ConnectionResetError("peer went away")) == "transport"
    assert cls(TimeoutError("recv timed out")) == "transport"
    assert cls(EOFError()) == "transport"
    assert cls(RuntimeError(
        "UNAVAILABLE: failed to connect to all addresses")) == "transport"
    assert cls(RuntimeError("transfer server handshake lost")) == "transport"
    # weak markers in a backend RuntimeError: ambiguous, never outright
    assert cls(RuntimeError("buffer RESET while tracing")) == "ambiguous"
    assert cls(RuntimeError("stream CLOSED mid-collective")) == "ambiguous"
    # non-RuntimeError non-socket exceptions are this rank's own fault
    assert cls(ValueError("connection reset by peer")) == "local"
    # the consumer's own OOM is never the wire
    assert cls(RuntimeError("RESOURCE_EXHAUSTED: out of memory "
                            "while UNAVAILABLE")) == "local"
    assert cls(RuntimeError("shape mismatch in reduction")) == "local"


def test_attributed_pull_retry_semantics():
    """Ambiguous failures retry once: transient hiccups recover, spoofed
    local messages raise locally, and only genuine transport verdicts
    mark the peer."""
    from parsec_tpu_torch.comm.tcp import _attributed_pull

    calls = []

    def flaky(ref):
        calls.append(ref)
        if len(calls) == 1:
            raise RuntimeError("stream CLOSED unexpectedly")
        return "payload"

    assert _attributed_pull(flaky, 1) == ("ok", "payload")
    assert len(calls) == 2

    # deterministic LOCAL error with a spoofed weak marker: raises; a live
    # peer is never blamed for it
    def spoofed(ref):
        raise RuntimeError("tensor RESET in local op")

    with pytest.raises(RuntimeError, match="tensor RESET"):
        _attributed_pull(spoofed, 1)

    def gone(ref):
        raise RuntimeError("UNAVAILABLE: transfer server unreachable")

    status, exc = _attributed_pull(gone, 1)
    assert status == "transport"

    def oom(ref):
        raise RuntimeError("RESOURCE_EXHAUSTED: device OOM")

    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        _attributed_pull(oom, 1)


def _mkctx(rank, ce):
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.core.context import Context
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    return ctx


def _am_program(rank, ce):
    """Raw CE: AM ring + barrier, no jax involved."""
    got = []
    from parsec_tpu_torch.comm.engine import TAG_DSL_BASE
    ce.tag_register(TAG_DSL_BASE,
                    lambda _ce, src, hdr, pl: got.append((src, hdr, pl)))
    ce.sync()
    dst = (rank + 1) % ce.nb_ranks
    ce.send_am(TAG_DSL_BASE, dst, {"from": rank},
               np.full((8,), rank, np.int32))
    import time
    t0 = time.time()
    while not got and time.time() - t0 < 20:
        ce.progress()
        time.sleep(0.001)
    ce.sync()
    ce.fini()
    src, hdr, pl = got[0]
    return (src, hdr["from"], int(pl[0]))


def test_tcp_am_roundtrip_and_barrier():
    res = run_distributed_procs(3, _am_program, timeout=90)
    for rank, (src, hdr_from, val) in enumerate(res):
        expect = (rank - 1) % 3
        assert src == expect and hdr_from == expect and val == expect


def _quiet_lull_program(rank, ce):
    """A >2s traffic lull, then a normal AM exchange: the dialed socket
    must survive the silence. Regression — create_connection's 2s dial
    timeout used to persist on the socket, so the dialed end's reader
    misread any compile-length lull as peer death (the symmetric
    'connection lost without clean shutdown' full-suite flake)."""
    import time
    got = []
    from parsec_tpu_torch.comm.engine import TAG_DSL_BASE
    ce.tag_register(TAG_DSL_BASE,
                    lambda _ce, src, hdr, pl: got.append(src))
    ce.sync()
    time.sleep(2.6)               # longer than the dial timeout
    assert not ce.dead_peers, f"lull killed peers: {ce.dead_peers}"
    ce.send_am(TAG_DSL_BASE, (rank + 1) % ce.nb_ranks, {}, None)
    t0 = time.time()
    while not got and time.time() - t0 < 20:
        ce.progress()
        time.sleep(0.001)
    ce.sync()
    ce.fini()
    return got[0]


def test_tcp_mesh_survives_quiet_lull():
    res = run_distributed_procs(2, _quiet_lull_program, timeout=90)
    assert res == [1, 0]


def _gemm_program(rank, ce):
    _force_cpu()
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks

    rng = np.random.default_rng(_SEED)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    ctx = _mkctx(rank, ce)
    kw = dict(nodes=ce.nb_ranks, myrank=rank, P=ce.nb_ranks, Q=1)
    A = TwoDimBlockCyclic("A", N, N, TS, TS, **kw)
    B = TwoDimBlockCyclic("B", N, N, TS, TS, **kw)
    C = TwoDimBlockCyclic("C", N, N, TS, TS, **kw)
    A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
    tp = DTDTaskpool(ctx, "tcpgemm")
    insert_gemm_tasks(tp, A, B, C)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()
    ce.fini()
    return {(m, n): np.asarray(C.data_of(m, n).newest_copy().payload)
            for m in range(C.mt) for n in range(C.nt)
            if C.rank_of(m, n) == rank}


def test_tcp_distributed_dtd_gemm():
    results = run_distributed_procs(2, _gemm_program, timeout=180)
    rng = np.random.default_rng(_SEED)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    ref = a @ b
    full = {}
    for out in results:
        for k, v in out.items():
            assert k not in full
            full[k] = v
    assert len(full) == (N // TS) ** 2
    for (m, n), tile in full.items():
        np.testing.assert_allclose(
            tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS], rtol=1e-3, atol=1e-3)


def _gemm_device_program(rank, ce):
    """The production shape: process per rank, one device per process. Each
    rank is bound to device #rank through the launcher's env contract
    (``PARSEC_TPU_TORCH_LOCAL_DEVICE``) and runs its tile bodies through
    the CUDA device module's async pipeline (over the CPU here)."""
    from parsec_tpu_torch.comm.xhost import ENV_LOCAL_DEVICE
    os.environ[ENV_LOCAL_DEVICE] = str(rank)
    from parsec_tpu_torch.utils import mca
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks

    rng = np.random.default_rng(_SEED)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    ctx = _mkctx(rank, ce)
    devs = [d for d in ctx.devices.devices if isinstance(d, CUDADevice)]
    kw = dict(nodes=ce.nb_ranks, myrank=rank, P=ce.nb_ranks, Q=1)
    A = TwoDimBlockCyclic("A", N, N, TS, TS, **kw)
    B = TwoDimBlockCyclic("B", N, N, TS, TS, **kw)
    C = TwoDimBlockCyclic("C", N, N, TS, TS, **kw)
    A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
    tp = DTDTaskpool(ctx, "tcpdevgemm")
    insert_gemm_tasks(tp, A, B, C)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()
    ce.fini()
    out = {(m, n): np.asarray(C.data_of(m, n).newest_copy().payload)
           for m in range(C.mt) for n in range(C.nt)
           if C.rank_of(m, n) == rank}
    return (out, [int(os.environ[ENV_LOCAL_DEVICE]) for _ in devs],
            sum(d.executed_tasks for d in devs))


def test_tcp_distributed_device_module_gemm():
    """DTD GEMM through per-process CUDA device modules over the TCP mesh:
    every rank bound to a DISTINCT device, bodies executed through the
    device module."""
    results = run_distributed_procs(2, _gemm_device_program, timeout=240)
    rng = np.random.default_rng(_SEED)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    ref = a @ b
    full = {}
    bound = []
    for out, dev_ids, executed in results:
        assert len(dev_ids) == 1, "each rank must bind exactly one device"
        bound.extend(dev_ids)
        assert executed > 0, "tile bodies must run through the device module"
        full.update(out)
    assert len(set(bound)) == 2, f"ranks share a device: {bound}"
    assert len(full) == (N // TS) ** 2
    for (m, n), tile in full.items():
        np.testing.assert_allclose(
            tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS], rtol=1e-3, atol=1e-3)


def test_launcher_virtual_device_binding():
    """The launcher CLI maps rank i -> device i (--virtual-devices): each
    spawned process binds a distinct device, executes its tile bodies
    through the CUDA device module (over the CPU, under --cpu) and moves a
    tensor to its peer through the xhost plane (a named shared-memory
    segment on the CPU), its pin retired by the peer's ACK."""
    import re
    import subprocess
    import sys as _sys
    from parsec_tpu_torch.launch import multiproc_lock as port_lock
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import time
    # the port's job lock is taken HERE, before the launcher starts: the
    # launcher runs inside it (ENV_LOCK_HELD) instead of queueing on it
    # within the subprocess's time limit
    with port_lock():
        out = subprocess.run(
            [_sys.executable, "-m", "parsec_tpu_torch.launch", "-n", "2",
             "--cpu", "--virtual-devices", "2",
             os.path.join("tests", "_torch_launch_device_probe.py")],
            cwd=repo, capture_output=True, text=True, timeout=240)
    time.sleep(0.5)   # the lock is not fair: let a waiting job in
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    lines = re.findall(r"PROBE rank=(\d+) devices=\[(\d+)\] executed=(\d+)",
                       out.stdout)
    assert len(lines) == 2, out.stdout
    by_rank = {int(r): (int(d), int(e)) for r, d, e in lines}
    assert set(by_rank) == {0, 1}
    assert by_rank[0][0] != by_rank[1][0], f"ranks share a device: {by_rank}"
    assert all(e > 0 for _, e in by_rank.values())


def test_ep_scaling_rates_on_cpu_ranks():
    """The EP scaling row (``launch.ep_scaling_rates``) with CPU rank
    contexts: P OS processes of ``parsec_tpu_torch._bench_ep_worker``
    under the port's job lock, each reporting its wall, the aggregate =
    P·ntasks / max(wall), and the host's CPU budget beside it."""
    import time

    from parsec_tpu_torch.launch import cpu_budget, ep_scaling_rates
    detail = {}
    try:
        rates = ep_scaling_rates((1, 2), ntasks=2000, device="cpu",
                                 detail=detail)
    finally:
        time.sleep(0.5)   # the lock is not fair: let a waiting job in
    assert sorted(rates) == [1, 2]
    for p in (1, 2):
        walls = detail[p]["walls_s"]
        assert len(walls) == p and all(w > 0 for w in walls)
        assert rates[p] == detail[p]["aggregate_tasks_per_sec"] > 0
        assert abs(rates[p] - p * 2000 / max(walls)) <= \
            0.01 * rates[p] + 1
    assert detail["cpu_budget"] == cpu_budget()
    assert detail["cpu_budget"]["cpus_allowed"] >= 1
    with pytest.raises(ValueError):
        ep_scaling_rates((1,), device="tpu")


_JOB_SCRIPT = """
import multiprocessing.forkserver as fs
import multiprocessing.resource_tracker as rt
import sys
sys.path.insert(0, {repo!r})
from parsec_tpu_torch.comm.tcp import run_distributed_procs


def prog(rank, ce):
    ce.fini()
    return rank


if __name__ == "__main__":
    assert run_distributed_procs(2, prog) == [0, 1]
    print(fs._forkserver._forkserver_pid, rt._resource_tracker._pid)
"""


def test_a_program_that_ran_a_job_leaves_no_process_behind(tmp_path):
    """The forkserver the ranks fork from, and multiprocessing's resource
    tracker, are stopped and waited for when the program exits: neither
    outlives it (each would notice its parent's exit only after it)."""
    import subprocess
    import sys as _sys
    import time

    from parsec_tpu_torch.launch import multiproc_lock as port_lock
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "job.py"
    script.write_text(_JOB_SCRIPT.format(repo=repo))
    out_path = tmp_path / "out.txt"
    # the output goes to a file: a pipe would also wait for every process
    # that inherited it; the job runs inside the port's lock taken here
    with port_lock(), open(out_path, "w") as out:
        rc = subprocess.run([_sys.executable, str(script)], cwd=tmp_path,
                            stdout=out, stderr=subprocess.STDOUT,
                            timeout=120).returncode
    time.sleep(0.5)   # the lock is not fair: let a waiting job in
    text = out_path.read_text()
    assert rc == 0, text[-2000:]
    pids = [int(w) for w in text.split()[-2:]]
    assert [p for p in pids if os.path.exists(f"/proc/{p}")] == []


def test_chip_smoke_stops_the_processes_it_leaves():
    """``chip_smoke.stop_children`` stops what the script started, the
    orphan of a child that exited first among them (the script is their
    subreaper), and waits for each; a second sweep finds nothing."""
    import subprocess
    import sys as _sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import subprocess, sys, time\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import chip_smoke as CS\n"
        "CS.become_subreaper()\n"
        "sh = subprocess.Popen(\n"
        "    ['sh', '-c', 'sleep 60 >/dev/null 2>&1 & echo $!'],\n"
        "    stdout=subprocess.PIPE, text=True)\n"
        "orphan = int(sh.stdout.readline())\n"
        "sh.wait()\n"
        "while open(f'/proc/{orphan}/comm').read() != 'sleep\\n':\n"
        "    time.sleep(0.01)   # the forked shell has not run exec yet\n"
        "print(orphan, CS.stop_children(), CS.stop_children())\n")
    out = subprocess.run([_sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    orphan, rest = out.stdout.split(" ", 1)
    alive = os.path.exists(f"/proc/{orphan}")
    if alive:
        os.kill(int(orphan), 9)
    assert rest.strip() == "['sleep'] []"
    assert not alive


def _potrf_program(rank, ce):
    _force_cpu()
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd

    spd = make_spd(N, seed=_SEED)
    ctx = _mkctx(rank, ce)
    A = TwoDimBlockCyclic("A", N, N, TS, TS, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    tp = DTDTaskpool(ctx, "tcppotrf")
    insert_potrf_tasks(tp, A)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()
    ce.fini()
    return {(m, n): np.asarray(A.data_of(m, n).newest_copy().payload)
            for m in range(A.mt) for n in range(A.nt)
            if A.rank_of(m, n) == rank and m >= n}


def test_tcp_distributed_dtd_potrf():
    results = run_distributed_procs(2, _potrf_program, timeout=180)
    from parsec_tpu_torch.ops.potrf import make_spd
    spd = make_spd(N, seed=_SEED)
    L = np.zeros((N, N), np.float32)
    for out in results:
        for (m, n), tile in out.items():
            L[m*TS:(m+1)*TS, n*TS:(n+1)*TS] = tile
    L = np.tril(L)
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)


def _crash_program(rank, ce):
    ce.fini()
    if rank == 1:
        import os
        os._exit(17)   # die without reporting (simulates segfault/OOM-kill)
    return "ok"


def test_tcp_dead_child_raises():
    """A rank that dies without reporting must raise, not yield None results."""
    with pytest.raises(RuntimeError, match="died without reporting"):
        run_distributed_procs(2, _crash_program, timeout=60)


def _arena_recv_program(rank, ce):
    _force_cpu()
    from parsec_tpu_torch.data.arena import arena_for
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW

    ctx = _mkctx(rank, ce)
    A = TwoDimBlockCyclic("AR", 32, 16, 16, 16, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: np.full((16, 16), float(m + 1), np.float32))
    tp = DTDTaskpool(ctx, "arenarecv")
    src = tp.tile_of(A, 0, 0)   # rank 0
    dst = tp.tile_of(A, 1, 0)   # rank 1
    tp.insert_task(lambda x: x + 1.0, (src, RW), name="w")
    tp.insert_task(lambda y, x: y + x, (dst, RW), (src, READ), name="r")
    tp.wait(timeout=60); tp.close(); ctx.wait(timeout=60); ctx.fini()
    ce.fini()
    stats = arena_for((16, 16), np.float32).stats()
    val = float(np.asarray(A.data_of(1, 0).newest_copy().payload)[0, 0]) \
        if rank == 1 else None
    return (stats, val)


def test_tcp_receives_land_in_arena_buffers():
    """Wire payloads are read into arena-allocated buffers on the receiver
    (ref: remote copies allocated from the dep's arena,
    remote_dep_mpi.c:2120) — the arena high-water mark must show use."""
    results = run_distributed_procs(2, _arena_recv_program, timeout=180)
    stats1, val = results[1]
    assert val == 4.0                       # 2 + (1+1)
    assert stats1["hwm"] >= 1, f"receiver arena never used: {stats1}"


def _counter_program(rank, ce):
    _force_cpu()
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.utils.counters import counters

    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=ce.nb_ranks)
    eng = RemoteDepEngine(ctx, ce)
    counters.register("test.widgets")
    counters.add("test.widgets", 10 * (rank + 1))   # genuinely per-process
    ce.sync()
    table = eng.aggregate_counters(timeout=30)
    ce.sync()
    ctx.fini()
    ce.fini()
    return table


def test_tcp_counter_aggregation():
    """Cross-rank counter aggregation: rank 0 merges every process's
    snapshot into per-rank columns + a sum (aggregator_visu role, run on
    REAL processes so the per-rank values are genuinely distinct)."""
    results = run_distributed_procs(2, _counter_program, timeout=120)
    table = results[0]
    assert results[1] is None          # only rank 0 gets the merged table
    assert table["per_rank"][0]["test.widgets"] == 10
    assert table["per_rank"][1]["test.widgets"] == 20
    assert table["sum"]["test.widgets"] == 30


def _victim_or_survivor(rank, ce):
    _force_cpu()
    import socket as _socket
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW

    ctx = _mkctx(rank, ce)
    A = TwoDimBlockCyclic("FD", 32, 16, 16, 16, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    tp = DTDTaskpool(ctx, "faildet")
    src = tp.tile_of(A, 0, 0)   # rank 0 (the victim) produces
    dst = tp.tile_of(A, 1, 0)   # rank 1 (the survivor) consumes
    tp.insert_task(lambda x: x + 1.0, (src, RW), jit=False, name="w")
    tp.insert_task(lambda y, x: y + x, (dst, RW), (src, READ),
                   jit=False, name="r")
    if rank == 0:
        # simulate a crash: sever every connection WITHOUT the BYE
        # handshake (the process itself stays alive to report to the
        # parent, so the survivor's observation can be asserted directly)
        for s in ce._peers.values():
            try:
                s.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        return "victim-done"
    try:
        tp.wait(timeout=60)
        return "no-error"
    except RuntimeError as e:
        return "attributed" if "FAILED" in str(e) and "0" in str(e) \
            else f"other: {e}"


def test_tcp_rank_failure_is_attributed():
    """A peer dying mid-job (no clean shutdown) surfaces as a prompt,
    attributed fatal on the survivor instead of a silent hang (failure
    detection, which the C reference does not have)."""
    results = run_distributed_procs(2, _victim_or_survivor, timeout=120)
    assert results[0] == "victim-done"
    assert results[1] == "attributed", results[1]


def _divergent_sync(rank, ce):
    """Rank 1 skips the barrier and exits cleanly; the others must see an
    attributed collective-divergence error, not a bare barrier timeout."""
    if rank == 1:
        import time
        time.sleep(0.3)       # let the others enter the barrier first
        ce.fini()             # clean BYE without ever calling sync()
        return "skipped"
    try:
        ce.sync(timeout=20)
        return "no-error"
    except RuntimeError as e:
        return "attributed" if "divergence" in str(e) and "1" in str(e) \
            else f"other: {e}"
    except TimeoutError:
        return "timeout"


def test_tcp_clean_exit_mid_barrier_is_attributed():
    """A peer departing cleanly (BYE) while others wait in a barrier is a
    collective divergence surfaced as an attributed error on every waiter
    (rank 0 observes it directly; non-roots via the failed-list release)."""
    results = run_distributed_procs(3, _divergent_sync, timeout=60)
    assert results[1] == "skipped"
    assert results[0] == "attributed", results[0]
    assert results[2] == "attributed", results[2]


# ------------------------------------------- cross-process device payloads

def _xhost_program(rank, ce, device_mem=False):
    """Two OS ranks on the card: a CUDA tensor crosses by a CUDA IPC pull
    (rendezvous descriptor in the AM frame, bytes copied card to card) when
    ``device_mem``, a host tensor rides the wire as before, and with the
    flag OFF the CUDA tensor host-bounces and is COUNTED."""
    import time

    from parsec_tpu_torch.comm.engine import CAP_ACCELERATOR_MEM, \
        TAG_DSL_BASE
    from parsec_tpu_torch.comm.xhost import XHostTransfer
    from parsec_tpu_torch.utils import mca
    from parsec_tpu_torch.utils.counters import counters

    if device_mem:
        mca.set("comm_device_mem", True)
        # the CE was built before the flag was set (run_distributed_procs
        # constructs it); build the plane the way __init__ would
        ce._xhost = ce._xpull = XHostTransfer()
        ce.capabilities |= CAP_ACCELERATOR_MEM
    got = []
    ce.tag_register(TAG_DSL_BASE,
                    lambda _ce, src, hdr, pl: got.append((hdr, pl)))
    ce.sync()

    def exchange(tagval, payload):
        got.clear()
        dst = (rank + 1) % ce.nb_ranks
        ce.send_am(TAG_DSL_BASE, dst, {"k": tagval}, payload)
        t0 = time.time()
        while not got and time.time() - t0 < 30:
            ce.progress()
            time.sleep(0.001)
        assert got, f"no payload for {tagval}"
        return got[0]

    peer = (rank - 1) % ce.nb_ranks
    dev = torch.device("cuda", 0)
    hdr, pl = exchange("dev", torch.full((16, 16), float(rank + 1),
                                         device=dev))
    ce.sync()
    if ce._xhost is not None:
        # the pulled payload arrives resident on the consumer's card
        assert pl.device.type == "cuda", pl.device
        hdrb, plb = exchange("bf16", torch.full((8, 8), float(rank + 2),
                                                dtype=torch.bfloat16,
                                                device=dev))
        ce.sync()
        assert plb.dtype == torch.bfloat16, plb.dtype
        assert float(plb.float()[0, 0]) == float(peer + 2)
    assert float(pl.float().cpu()[0, 0]) == float(peer + 1)

    # host tensor payload: unaffected by the device-mem plane
    hdr2, pl2 = exchange("host", torch.full((4,), rank, dtype=torch.int32))
    ce.sync()
    assert int(pl2[0]) == peer

    # wait for the peer's ACK to retire our pin (reader-thread async)
    t0 = time.time()
    while ce._xhost is not None and ce._xhost.pending() \
            and time.time() - t0 < 20:
        ce.progress()
        time.sleep(0.002)
    stats = {
        "d2d": counters.read("comm.xhost_d2d_msgs"),
        "offered": counters.read("comm.xhost_offered_msgs"),
        "bounced": counters.read("comm.host_materialized_msgs"),
        "pins": ce._xhost.pending() if ce._xhost is not None else -1,
    }
    ce.sync()
    ce.fini()
    return stats


def _xhost_program_enabled(rank, ce):
    return _xhost_program(rank, ce, device_mem=True)


@_card
def test_tcp_xhost_device_payload_pull():
    """comm_device_mem=1: CUDA tensors cross OS ranks on one card by CUDA
    IPC pulls whose bytes equal the source — zero host materializations,
    pins retired by the ACK."""
    results = run_distributed_procs(2, _xhost_program_enabled, timeout=120)
    for s in results:
        assert s["offered"] == 2, s       # f32 + bf16 payloads offered
        assert s["d2d"] == 2, s           # both pulled card to card
        assert s["bounced"] == 0, s       # never host-materialized
        assert s["pins"] == 0, s          # ACKs retired the pins


@_card
def test_tcp_xhost_disabled_bounces_and_counts():
    """Flag off (the default): the same CUDA tensor host-bounces into the
    wire frame and the bounce is COUNTED."""
    results = run_distributed_procs(2, _xhost_program, timeout=120)
    for s in results:
        assert s["offered"] == 0, s
        assert s["d2d"] == 0, s
        assert s["bounced"] == 1, s       # counted fallback
        assert s["pins"] == -1, s         # no xhost plane was built


def _potrf_device_xhost_program(rank, ce):
    """The full stack with the device-native cross-rank plane ON: DTD
    POTRF over the TCP mesh with comm_device_mem=1, both ranks on the one
    card, each with its own tile budget. POTRF's panels are PRODUCED by
    tasks on the card and consumed remotely, so the protocol's sends carry
    CUDA tensors — which must ride CUDA IPC pulls, not wire bytes."""
    from parsec_tpu_torch.comm.engine import CAP_ACCELERATOR_MEM
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.xhost import XHostTransfer
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
    from parsec_tpu_torch.utils import mca
    from parsec_tpu_torch.utils.counters import counters
    mca.set("comm_device_mem", True)
    mca.set("device_cuda_max_bytes", 1 << 28)
    mca.set("device_load_balance_allow_cpu", False)
    ce._xhost = ce._xpull = XHostTransfer()
    ce.capabilities |= CAP_ACCELERATOR_MEM

    spd = make_spd(N, seed=_SEED)
    ctx = Context(nb_cores=1, device="cuda", my_rank=rank,
                  nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    A = TwoDimBlockCyclic("A", N, N, TS, TS, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    tp = DTDTaskpool(ctx, "xhostpotrf")
    insert_potrf_tasks(tp, A)
    tp.wait(timeout=90)
    tp.close()
    ctx.wait(timeout=60)
    stats = {
        "offered": int(counters.read("comm.xhost_offered_msgs")),
        "pulled": int(counters.read("comm.xhost_d2d_msgs")),
        "bounced": int(counters.read("comm.host_materialized_msgs")),
    }
    L = np.linalg.cholesky(spd.astype(np.float64))
    err = 0.0
    for m in range(A.mt):
        for n in range(A.nt):
            if A.rank_of(m, n) == rank and m >= n:
                got = A.data_of(m, n).newest_copy().payload.double().cpu()
                err = max(err, float(np.abs(
                    got.numpy() - L[m*TS:(m+1)*TS, n*TS:(n+1)*TS]).max()))
    ctx.fini()
    # every pull ACKed: the ledger empties once the peer's ACKs land
    import time
    t0 = time.time()
    while ce._xhost.pending() and time.time() - t0 < 20:
        ce.progress()
        time.sleep(0.002)
    stats["pins"] = ce._xhost.pending()
    ce.sync()
    ce.fini()
    return dict(stats, err=err)


@_card
def test_tcp_distributed_potrf_device_payloads_via_xhost():
    """End-to-end on one card: the remote-dep protocol's PRODUCED tile
    payloads (CUDA tensors) cross OS ranks by CUDA IPC pulls; results
    correct, zero host materializations, all pins retired."""
    results = run_distributed_procs(2, _potrf_device_xhost_program,
                                    timeout=240)
    for s in results:
        assert s["err"] < 1e-2, s
        assert s["bounced"] == 0, s        # nothing host-materialized
        assert s["pins"] == 0, s           # every ACK arrived
    total_offered = sum(s["offered"] for s in results)
    total_pulled = sum(s["pulled"] for s in results)
    assert total_offered == total_pulled > 0, results
