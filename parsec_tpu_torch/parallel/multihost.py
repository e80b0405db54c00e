"""Rank groups: a device is a rank, and a mesh spans the ranks of one
``torch.distributed`` group.

The reference's mesh is a list of devices inside one process, eight
virtual CPU devices in its tests (``tests/conftest.py:12-14``), and its
multi-controller layer (``parallel/multihost.py:36-214``) joins
processes into one job of the reference's compiler. Here every device is
an OS process that joins one gloo group
(:data:`~parsec_tpu_torch.parallel.compat.BACKEND`: NCCL refuses two
ranks on one card, and the host has one), and a
``DeviceMesh`` with the reference's axis names sits over that group
(:func:`device_mesh`). On the card every rank runs on ``cuda:0`` and the
ranks time-share it.

* :class:`RankPool` — N ranks forked from the port's forkserver
  (:data:`~parsec_tpu_torch.comm.tcp.FORKSERVER_PRELOAD`: torch imported,
  never CUDA), joined once, kept, and handed jobs: ``pool.run(fn,
  *args)`` runs the picklable ``fn`` on every rank and returns their
  results. Each job runs under the port's
  :func:`~parsec_tpu_torch.launch.multiproc_lock`. A rank that dies (a
  c10d check abort included) or raises fails the job at once with every
  rank's exit status and the tail of its output, and the pool starts anew
  at the next job; a job past its deadline does the same.
* :func:`init_multihost` — a rank's bring-up from its environment
  (``torchrun``'s variables, or :data:`ENV_COORD`/:data:`ENV_PROC`/
  :data:`ENV_NPROC`); :func:`global_mesh`, :func:`host_local_to_global`
  (``DTensor.from_local``), :func:`fetch_replicated`,
  :func:`cpu_collectives_available`.
* :func:`run_multicontroller` — ``nprocs`` "hosts" of ``devices_per_proc``
  ranks each, every rank its own interpreter running a script with
  torchrun's local-rank environment, under one job-wide deadline; whole
  process groups are killed at the end.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import compat

ENV_COORD = "PARSEC_TPU_TORCH_COORDINATOR"
ENV_PROC = "PARSEC_TPU_TORCH_PROCESS_ID"
ENV_NPROC = "PARSEC_TPU_TORCH_NUM_PROCESSES"
#: the "host" a rank of :func:`run_multicontroller` belongs to
ENV_HOST = "PARSEC_TPU_TORCH_HOST_ID"

#: bytes of a rank's output kept in a failure's report
TAIL = 1500


def _need_card(device_type: str) -> str:
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: meshes run on the card unless "
                           "they are given device_type='cpu'")
    return device_type


def cpu_collectives_available() -> bool:
    """True when this torch can join ranks in a gloo group (the backend of
    every mesh here, for CPU and CUDA tensors)."""
    return dist.is_available() and dist.is_gloo_available()


# ---------------------------------------------------------------------------
# meshes over the group
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                device_type: str = "cuda"):
    """A ``DeviceMesh`` of the group's first prod(shape) ranks, row-major
    in ``shape``, with ``axis_names``. Every rank of the group calls it
    together (it makes the axes' sub-groups); a rank outside the mesh gets
    it too, with no coordinate. Kept per (device type, shape, names), as
    the reference keys its compiled programs by mesh."""
    _need_card(device_type)
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a torch.distributed "
                           "group: run inside a RankPool job, or call "
                           "init_multihost first")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"requested {n} ranks for mesh {shape}, the group "
                         f"has {world}")
    key = (device_type, shape, tuple(axis_names))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = compat.DeviceMesh(device_type,
                                 torch.arange(n).reshape(shape),
                                 mesh_dim_names=tuple(axis_names))
        _MESHES[key] = mesh
    return mesh


def global_mesh(axis_names: Sequence[str],
                shape: Optional[Sequence[int]] = None,
                device_type: str = "cuda"):
    """A mesh over EVERY rank of the group. With no ``shape``, one axis
    spans them all; otherwise ``shape`` must multiply to the group size."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) if len(axis_names) == 1 else None
    if shape is None or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks in the group")
    return device_mesh(shape, axis_names, device_type)


def host_local_to_global(mesh, pspec, host_data):
    """Assemble per-rank data into one global DTensor: every rank passes
    ITS shard of the global value under ``pspec`` (ranks along an axis the
    spec does not name pass the same data) — the multi-host input idiom."""
    t = host_data if isinstance(host_data, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(host_data))
    return compat.from_local(t.to(compat.mesh_device(mesh)), mesh,
                             compat.PartitionSpec(*pspec))


def fetch_replicated(x):
    """The host value of a replicated DTensor (or tensor) on this rank."""
    if isinstance(x, compat.DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device_type: Optional[str] = None) -> int:
    """Join this rank to the job's gloo group (env fallbacks:
    :data:`ENV_COORD` or ``MASTER_ADDR:MASTER_PORT``, :data:`ENV_PROC` or
    ``RANK``, :data:`ENV_NPROC` or ``WORLD_SIZE``), probe the collectives
    (:func:`compat.probe_collectives`; CUDA tensors too when the rank
    runs on the card) and return the rank. ``device_type`` defaults to
    the card, or the CPU under ``PARSEC_TPU_TORCH_FORCE_CPU=1``; on the
    card the rank takes device ``LOCAL_RANK`` mod the card count."""
    from ..device.probe import ENV_FORCE_CPU
    env = os.environ
    coordinator = coordinator or env.get(ENV_COORD) or (
        f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT')}"
        if env.get("MASTER_PORT") else None)
    num_processes = int(num_processes if num_processes is not None else
                        env.get(ENV_NPROC, env.get("WORLD_SIZE", "1")))
    process_id = int(process_id if process_id is not None else
                     env.get(ENV_PROC, env.get("RANK", "0")))
    if device_type is None:
        device_type = "cpu" if env.get(ENV_FORCE_CPU) == "1" else "cuda"
    _need_card(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        if coordinator is None:
            if num_processes > 1:
                raise RuntimeError("init_multihost: no coordinator "
                                   f"({ENV_COORD} or MASTER_PORT)")
            from ..comm.tcp import _free_port
            coordinator = f"127.0.0.1:{_free_port()}"
        dist.init_process_group(
            compat.BACKEND, init_method=f"tcp://{coordinator}",
            rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=120))
    compat.probe_collectives("cpu", log=_quiet)
    if device_type == "cuda":
        compat.probe_collectives("cuda", log=_quiet)
    return process_id


def _quiet(*_a, **_k) -> None:
    pass


# ---------------------------------------------------------------------------
# the rank pool
# ---------------------------------------------------------------------------

#: what a probing rank prints before each collective (a rank a collective
#: aborts leaves it last in its output)
_PROBE_MARK = "compat probe "


def _rank_main(rank: int, n: int, port: int, device_type: str, conn,
               log_path: str, env: dict, known: dict, threads: int) -> None:
    os.environ.clear()
    os.environ.update(env)
    os.environ["PARSEC_TPU_TORCH_RANK"] = str(rank)   # inside the job lock
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    import faulthandler
    faulthandler.enable()
    torch.set_num_threads(threads)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            compat.BACKEND, init_method=f"tcp://127.0.0.1:{port}",
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=300))
        table = {"cpu": compat.probe_collectives("cpu", known.get("cpu"),
                                                 log=_quiet)}
        if device_type == "cuda":
            table["cuda"] = compat.probe_collectives("cuda",
                                                     known.get("cuda"))
        conn.send(("ok", table))
    except BaseException:  # noqa: BLE001 - shipped to the parent
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        path, payload = msg
        try:
            sys.path[:] = path
            fn, args, kw = pickle.loads(payload)
            out = ("ok", fn(*args, **kw))
            conn.send(out)
        except BaseException:  # noqa: BLE001 - shipped to the parent
            sys.stdout.flush()
            conn.send(("err", traceback.format_exc()))
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - leaving anyway
        pass


class RankFailure(RuntimeError):
    """A rank of a :class:`RankPool` job raised or died."""


class RankPool:
    """``nb_ranks`` ranks in one gloo group, forked once and reused.

    ``device_type="cuda"`` (the default) puts every rank on ``cuda:0`` and
    raises without a card; tests pass ``"cpu"``. At start every rank
    probes the collectives on CPU tensors, and on CUDA tensors on the
    card (:func:`compat.probe_collectives`); a rank that a probed
    collective aborts (torch 2.11's gloo on CUDA send/recv) is restarted,
    with every other, with that collective marked refused. :attr:`native`
    holds the tables. ``pool.run(fn, *args, **kw)`` runs
    ``fn`` (picklable: a module-level function of a module a rank can
    import without loading the reference) on every rank and returns the
    list of results in rank order. ``timeout`` bounds every job (its
    ``timeout=`` keyword overrides it)."""

    def __init__(self, nb_ranks: int = 8, device_type: str = "cuda",
                 timeout: float = 120.0):
        if device_type == "cuda":
            from ..device import probe
            platform, _ = probe.decide_backend()
            if platform != "cuda":
                raise RuntimeError(f"no CUDA device for the ranks: "
                                   f"{probe.reason()} (pass "
                                   "device_type='cpu')")
        else:
            _need_card(device_type)
        self.nb_ranks = int(nb_ranks)
        self.device_type = device_type
        self.timeout = float(timeout)
        self.native: dict = {}
        self._procs: list = []
        self._conns: list = []
        self._dir: Optional[str] = None
        self.starts = 0
        self.start_s = 0.0
        atexit.register(self.close)

    # -- life cycle -----------------------------------------------------
    def _spawn(self) -> None:
        import multiprocessing as mp
        from ..comm.tcp import FORKSERVER_PRELOAD, _free_port, \
            stop_forkserver
        atexit.unregister(stop_forkserver)
        atexit.register(stop_forkserver)
        # the ranks leave before the forkserver stops (atexit runs last in,
        # first out): a forkserver child is joined through its server
        atexit.unregister(self.close)
        atexit.register(self.close)
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD) +
                                   ["parsec_tpu_torch.parallel.multihost"])
        self._dir = tempfile.mkdtemp(prefix="parsec-ranks-")
        port = _free_port()
        env = dict(os.environ)
        threads = max(1, (os.cpu_count() or 1) // self.nb_ranks)
        self._procs, self._conns = [], []
        for r in range(self.nb_ranks):
            a, b = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            name=f"parsec-mesh-rank-{r}",
                            args=(r, self.nb_ranks, port, self.device_type,
                                  b, self._log(r), env, self.native,
                                  threads))
            p.start()
            b.close()
            self._procs.append(p)
            self._conns.append(a)

    def _log(self, r: int) -> str:
        return os.path.join(self._dir, f"rank{r}.log")

    def start(self) -> "RankPool":
        """Fork and join the ranks (done by the first job when needed)."""
        if self._procs:
            return self
        t = time.perf_counter()
        for _attempt in range(len(compat.OPS) + 1):
            self._spawn()
            try:
                tables = self._collect(time.monotonic() + self.timeout)
            except RankFailure:
                op = self._probing()
                self._kill()
                if op is None:
                    raise
                dt, name = op
                self.native.setdefault(dt, {})[name] = False
                continue
            self.native = tables[0]
            self.starts += 1
            self.start_s = time.perf_counter() - t
            return self
        raise RankFailure("the ranks kept dying in the collectives' probe")

    def _probing(self):
        """(device type, op) a rank announced last in the probe, or None."""
        last = None
        for r in range(self.nb_ranks):
            try:
                with open(self._log(r)) as f:
                    for line in f:
                        if line.startswith(_PROBE_MARK):
                            dt, op = line[len(_PROBE_MARK):].split()[:2]
                            last = (dt, op)
            except OSError:
                continue
        return last

    def tail(self, r: int) -> str:
        try:
            with open(self._log(r), errors="replace") as f:
                return f.read()[-TAIL:]
        except (OSError, TypeError):
            return ""

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=5.0)
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []

    def close(self) -> None:
        """Let the ranks leave the group and exit (killed after 10 s)."""
        for c in self._conns:
            try:
                c.send(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10.0)
        self._kill()
        if self._dir is not None:
            import shutil
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "RankPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- jobs -------------------------------------------------------------
    def _report(self, what: str, status: dict, errors: dict) -> str:
        lines = [what]
        # the ranks that raised or died first: the root cause is theirs
        order = sorted(range(len(self._procs)),
                       key=lambda r: (r not in errors, r))
        for r in order:
            p = self._procs[r]
            code = p.exitcode
            st = status.get(r) or ("exit " + str(code) if code is not None
                                   else "no answer")
            lines.append(f"--- rank {r}: {st}")
            if r in errors:
                lines.append(errors[r][-TAIL:])
            tail = self.tail(r)
            if tail:
                lines.append(f"output tail:\n{tail}")
        return "\n".join(lines)

    def _collect(self, deadline: float) -> list:
        from multiprocessing.connection import wait
        n = self.nb_ranks
        results: List[Any] = [None] * n
        status, errors = {}, {}
        pending = set(range(n))
        grace = None
        while pending:
            now = time.monotonic()
            limit = deadline if grace is None else min(deadline, grace)
            if now >= limit:
                break
            waitables = {}
            for r in pending:
                waitables[self._conns[r]] = r
                waitables[self._procs[r].sentinel] = r
            ready = wait(list(waitables), timeout=min(0.5, limit - now))
            for w in ready:
                r = waitables[w]
                if r not in pending:
                    continue
                conn = self._conns[r]
                if conn.poll():
                    try:
                        kind, val = conn.recv()
                    except (EOFError, OSError):
                        kind, val = "died", None
                else:
                    kind, val = "died", None
                pending.discard(r)
                if kind == "ok":
                    results[r] = val
                    status[r] = "ok"
                elif kind == "err":
                    errors[r] = val
                    status[r] = "raised"
                else:
                    self._procs[r].join(timeout=1.0)
                    status[r] = f"died, exit {self._procs[r].exitcode}"
                    errors[r] = ""
                if kind != "ok" and grace is None:
                    # the others may be blocked in a collective with it
                    grace = time.monotonic() + 3.0
        if not pending and not errors:
            return results
        for r in pending:
            status[r] = "hung" if grace is None else "stuck after a failure"
        timed_out = grace is None
        report = self._report(
            "rank job timed out" if timed_out else "rank job failed",
            status, errors)
        self._kill()
        if timed_out:
            raise TimeoutError(report)
        raise RankFailure(report)

    def run(self, fn: Callable, *args, timeout: Optional[float] = None,
            **kw) -> list:
        """``fn(*args, **kw)`` on every rank; the results in rank order."""
        from ..launch import multiproc_lock
        payload = pickle.dumps((fn, args, kw))
        with multiproc_lock():
            self.start()
            try:
                for c in self._conns:
                    c.send((list(sys.path), payload))
            except (OSError, ValueError):
                self._kill()
                raise
            return self._collect(time.monotonic() +
                                 (timeout or self.timeout))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def run_multicontroller(nprocs: int, script: str,
                        devices_per_proc: int = 4,
                        timeout: float = 240.0,
                        extra_env: Optional[dict] = None,
                        device_type: str = "cuda") -> List[str]:
    """Run ``script`` on ``nprocs`` x ``devices_per_proc`` ranks, one OS
    process (its own interpreter) per device, as torchrun would: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``
    (the "host"), ``MASTER_ADDR``/``MASTER_PORT``, and the port's
    :data:`ENV_COORD`/:data:`ENV_PROC`/:data:`ENV_NPROC`/:data:`ENV_HOST`.
    ``device_type="cpu"`` runs every rank on the CPU
    (``PARSEC_TPU_TORCH_FORCE_CPU=1``); the card is the default and
    raises without one. Returns each rank's output, in rank order.

    One job-wide deadline; a rank that exits with an error fails the job
    at once with every rank's exit status and output tail (a rank blocked
    in a collective with it is not waited out); whole process groups are
    killed at the end. The job runs under the port's job lock."""
    from ..comm.tcp import _free_port
    from ..device.probe import ENV_FORCE_CPU
    from ..launch import _kill_group, multiproc_lock
    if device_type == "cuda":
        from ..device import probe
        if probe.decide_backend()[0] != "cuda":
            raise RuntimeError(f"no CUDA device for the ranks: "
                               f"{probe.reason()} (pass device_type='cpu')")
    else:
        _need_card(device_type)
    world = nprocs * devices_per_proc
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix="parsec-mc-")
    with multiproc_lock():
        procs, files = [], []
        try:
            for rank in range(world):
                env = dict(os.environ)
                env.update({
                    "RANK": str(rank), "WORLD_SIZE": str(world),
                    "LOCAL_RANK": str(rank % devices_per_proc),
                    "LOCAL_WORLD_SIZE": str(devices_per_proc),
                    "GROUP_RANK": str(rank // devices_per_proc),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    ENV_COORD: f"127.0.0.1:{port}", ENV_PROC: str(rank),
                    ENV_NPROC: str(world),
                    ENV_HOST: str(rank // devices_per_proc)})
                if device_type == "cpu":
                    env[ENV_FORCE_CPU] = "1"
                if extra_env:
                    env.update(extra_env)
                f = open(os.path.join(outdir, f"rank{rank}.out"), "w+")
                files.append(f)
                procs.append(subprocess.Popen(
                    [sys.executable, script], env=env, stdout=f,
                    stderr=subprocess.STDOUT, text=True,
                    start_new_session=True))
            deadline = time.monotonic() + timeout
            failed = None
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank(s) {bad} failed"
                    break
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.1)
            else:
                failed = f"job timed out after {timeout:.0f} s"
        finally:
            for p in procs:
                if p.poll() is None:
                    _kill_group(p, signal.SIGKILL)
            for p in procs:
                p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    import shutil
    shutil.rmtree(outdir, ignore_errors=True)
    if failed is not None:
        # EVERY rank's tail rides along: the root cause often lives in the
        # rank that died first, not in the one that reported first
        raise RuntimeError(failed + "\n" + "\n---\n".join(
            f"rank {r} exit {p.returncode}:\n{o[-TAIL:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs
