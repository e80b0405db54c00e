"""``python -m parsec_tpu_torch.launch -n N script.py [args...]`` — the mpiexec.

Spawns N copies of ``script.py`` as real OS processes, each with
``PARSEC_TPU_TORCH_RANK`` / ``PARSEC_TPU_TORCH_NPROCS`` /
``PARSEC_TPU_TORCH_RDV`` set; the script calls
:func:`parsec_tpu_torch.comm.tcp.init_from_env` to join the TCP mesh (its
`MPI_Init` moment). Stands where ``mpiexec -n N`` stands in the reference's
workflow (tests/CMakeLists.txt:1032-1042 oversubscribed-host test mode).

Device binding: ``--virtual-devices N`` binds rank i to device i mod N
(``PARSEC_TPU_TORCH_LOCAL_DEVICE``), which lands on CUDA device i mod N mod
the card count — with one card every rank shares ``cuda:0``. ``--cpu`` runs
every rank on the CPU; with ``--virtual-devices`` too, each rank runs the
CUDA device module over the CPU (``device_cuda_over_cpu``), a rehearsal of
the card-per-process shape. Without ``--cpu`` the job needs a card: the
launcher asks :func:`parsec_tpu_torch.device.probe.decide_backend` (a
subprocess probe; the launcher itself never initializes CUDA) and raises
with the probe's reason when there is none.

:func:`ep_scaling_rates` runs the EP scaling row the same way: P OS
processes of :mod:`parsec_tpu_torch._bench_ep_worker` under the job lock,
aggregate tasks/s = P·ntasks / max(rank wall), beside :func:`cpu_budget`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

from .comm.tcp import ENV_NPROCS, ENV_RANK, ENV_RDV, _free_port
from .comm.xhost import ENV_LOCAL_DEVICE
from .device import probe
from .device.probe import ENV_FORCE_CPU

_MULTIPROC_LOCK_PATH = os.path.join(tempfile.gettempdir(),
                                    "parsec_tpu_torch_multiproc.lock")
#: set in the environment while a process holds the job lock: the
#: processes it starts (a launcher it runs, that launcher's ranks) are part
#: of its job and run inside the held lock instead of queueing behind it
ENV_LOCK_HELD = "PARSEC_TPU_TORCH_JOB_LOCK_HELD"


@contextlib.contextmanager
def multiproc_lock(timeout: float = 300.0):
    """Serialize multiprocess jobs across sessions on one host (a lock file).

    Spawned-rank jobs cannot tolerate a busy host: every rank pays a full
    interpreter and torch import before it can rendezvous, so two
    concurrent multiprocess jobs push each other past their deadlines and
    flap. Taking this advisory flock around each job makes the host run
    them one at a time; a holder that outlives ``timeout`` degrades to
    running unserialized (never deadlocks on a dead peer's stale lock —
    flock dies with its process anyway).

    Ranks themselves (``PARSEC_TPU_TORCH_RANK`` set) skip the lock: the
    parent job already holds it, and a child blocking on it would
    self-deadlock. So does every process started while the lock is held
    (:data:`ENV_LOCK_HELD`, set by the holder): a job that runs the
    launcher as a subprocess takes the lock first, and its time limit
    then covers the job alone, not a wait behind other jobs.
    """
    if os.environ.get(ENV_RANK) is not None or \
            os.environ.get(ENV_LOCK_HELD):
        yield
        return
    try:
        f = open(_MULTIPROC_LOCK_PATH, "a+b")
    except OSError:
        yield                     # unwritable tmp: run unserialized
        return
    try:
        import fcntl
        deadline = time.monotonic() + timeout
        held = False
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                held = True
                break
            except OSError:
                if time.monotonic() > deadline:
                    break         # degrade rather than queue forever
                time.sleep(0.2)
        if held:
            os.environ[ENV_LOCK_HELD] = str(os.getpid())
        yield
    finally:
        os.environ.pop(ENV_LOCK_HELD, None)
        try:
            import fcntl
            fcntl.flock(f, fcntl.LOCK_UN)
        except OSError:
            pass
        f.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parsec_tpu_torch.launch",
                                 description="run a script on N TCP-mesh ranks")
    ap.add_argument("-n", "--np", type=int, default=2, dest="nprocs")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run every rank on the CPU "
                         f"({ENV_FORCE_CPU}=1)")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="bind rank i to device i%%N "
                         f"({ENV_LOCAL_DEVICE}; CUDA device i%%N mod the "
                         "card count, or with --cpu the CUDA device "
                         "module over the CPU)")
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("PARAM", "VALUE"),
                    help="set an MCA parameter in every rank (exported as "
                         "PARSEC_MCA_<param>; the mpirun --mca role)")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    opts = ap.parse_args(argv)
    with multiproc_lock():
        return _run_job(opts)


def _require_card() -> None:
    """Raise unless this host has a card (the job runs on it)."""
    platform, _count = probe.decide_backend()
    if platform != "cuda":
        raise RuntimeError(f"no CUDA card for the job: {probe.reason()} "
                           "(pass --cpu to run the ranks on the CPU)")


def _run_job(opts) -> int:
    rdv = f"127.0.0.1:{_free_port()}"
    if not opts.cpu:
        _require_card()
    procs = []
    for rank in range(opts.nprocs):
        env = dict(os.environ)
        env[ENV_RANK] = str(rank)
        env[ENV_NPROCS] = str(opts.nprocs)
        env[ENV_RDV] = rdv
        for pname, pval in opts.mca:
            env["PARSEC_MCA_" + pname] = pval
        if opts.virtual_devices:
            env[ENV_LOCAL_DEVICE] = str(rank % opts.virtual_devices)
        if opts.cpu:
            env[ENV_FORCE_CPU] = "1"
            if opts.virtual_devices:
                # rehearse the card-per-process shape on the CPU
                env["PARSEC_MCA_device_cuda_over_cpu"] = "1"
        # each rank leads its own process group so cleanup can reach
        # grandchildren even if the launcher itself is killed mid-wait
        procs.append(subprocess.Popen(
            [sys.executable, opts.script, *opts.args], env=env,
            start_new_session=True))
    rc = 0
    deadline = time.monotonic() + opts.timeout   # one job-wide deadline
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
                rc = rc or p.returncode
            except subprocess.TimeoutExpired:
                rc = 124
                break
    finally:
        for p in procs:
            if p.poll() is None:
                _kill_group(p, signal.SIGTERM)
        t0 = time.monotonic()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, 5.0 - (time.monotonic() - t0)))
                except subprocess.TimeoutExpired:
                    _kill_group(p, signal.SIGKILL)
    return rc


def cpu_budget() -> dict:
    """The host's real CPU allowance — cgroup quota + affinity mask — so
    scaling rows are reproducible from logged inputs (an aggregate above
    the nominal core count must be explainable)."""
    quota = None
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            raw = f.read().split()
        if raw and raw[0] != "max":
            quota = float(raw[0]) / float(raw[1])
    except OSError:
        try:
            with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as f:
                q = int(f.read())
            with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as f:
                p = int(f.read())
            if q > 0:
                quota = q / p
        except OSError:
            pass
    try:
        allowed = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        allowed = os.cpu_count()
    return {"cgroup_cpu_quota_cores": quota, "cpus_allowed": allowed,
            "nproc": os.cpu_count()}


def ep_scaling_rates(proc_counts=(1, 2, 4), ntasks: int = 20000,
                     timeout: float = 240.0, device: str = "cuda",
                     detail: Optional[dict] = None) -> dict:
    """Aggregate EP task throughput at P OS processes — the framework's
    scaling row.

    Process-per-card is the architecture (one host process drives one
    card's task graph; ranks mesh over TCP — the reference's one-MPI-rank-
    per-GPU shape). Thread counts beyond one measure only the GIL, so
    scale-out is measured the way it is deployed: real OS processes
    (:mod:`parsec_tpu_torch._bench_ep_worker`), barrier-aligned, aggregate
    = P·ntasks / max(rank wall). Each rank's context is a card context;
    ``device="cpu"`` runs them on the CPU (``PARSEC_TPU_TORCH_FORCE_CPU``).
    The job holds :func:`multiproc_lock`, as the launcher's jobs do.

    Returns {P: aggregate tasks/s}; ``detail`` gets each P's rank walls and
    aggregate, and the host's :func:`cpu_budget`.
    """
    import re

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rates = {}
    with multiproc_lock():
        if device == "cuda":
            _require_card()
        for nprocs in proc_counts:
            rdv = f"127.0.0.1:{_free_port()}"
            procs = []
            for rank in range(nprocs):
                env = dict(os.environ)
                env[ENV_RANK] = str(rank)
                env[ENV_NPROCS] = str(nprocs)
                env[ENV_RDV] = rdv
                if device == "cpu":
                    env[ENV_FORCE_CPU] = "1"
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "parsec_tpu_torch._bench_ep_worker",
                     str(ntasks)],
                    env=env, cwd=pkg_parent, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                    start_new_session=True))
            walls = []
            try:
                deadline = time.monotonic() + timeout
                for p in procs:
                    out, err = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                    m = re.search(r"wall=([0-9.]+)", out or "")
                    if p.returncode != 0 or not m:
                        raise RuntimeError(
                            f"EP worker failed (rc={p.returncode}): "
                            f"{(out or '').strip()[-200:]} "
                            f"{(err or '').strip()[-400:]}")
                    walls.append(float(m.group(1)))
            finally:
                for p in procs:
                    if p.poll() is None:
                        _kill_group(p, signal.SIGKILL)
                        p.wait()
            rates[nprocs] = round(nprocs * ntasks / max(walls))
            if detail is not None:
                detail[nprocs] = {"walls_s": [round(w, 6) for w in walls],
                                  "aggregate_tasks_per_sec": rates[nprocs]}
    if detail is not None:
        detail["cpu_budget"] = cpu_budget()
    return rates


def _kill_group(p: subprocess.Popen, sig) -> None:
    try:
        os.killpg(p.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            p.send_signal(sig)
        except Exception:  # noqa: BLE001 - already gone
            pass


if __name__ == "__main__":
    sys.exit(main())
