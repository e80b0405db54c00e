"""Cross-process CE backend: N OS processes joined by a full TCP mesh.

The production-transport analogue of the reference's funnelled MPI backend
(parsec/parsec_mpi_funnelled.c: init :642, pre-posted AM recv slots :823,
progress :1427). Design mapping:

* **bootstrap** — `mpi_funnelled_init`'s communicator dup becomes a
  rendezvous: every rank opens a listen socket; ranks 1..N-1 dial rank 0 and
  exchange (rank, addr); rank 0 broadcasts the address map; higher ranks
  then dial lower ranks, yielding one socket per pair (the "communicator").
* **pre-posted recv slots** — one reader thread per peer socket plays the
  persistent `MPI_Irecv` slots: frames are decoded off the wire eagerly and
  parked in an inbound deque.
* **funnelled progress** — AM callbacks fire only from :meth:`progress`
  (the caller's progress path / comm thread), never from reader threads,
  preserving the reference's single-threaded AM discipline.
* **one-sided put/get** — emulated over the two-sided stream with internal
  handshake tags, exactly like the reference emulates RDMA over MPI.

Wire format: a pickled frame header, then the tensor payload's raw bytes
(``CommEngine.encode_payload``: a CUDA tensor materializes host bytes here,
counted, unless ``--mca comm_device_mem 1`` moves it by CUDA IPC,
``comm/xhost.py``); the receiver reads them into a buffer of the
receive-buffer arena (``data/arena.py``).

The launcher (:func:`run_distributed_procs`) stands where ``mpiexec -n N``
stands in the reference's test harness — N real processes on one host,
forked from a forkserver that never touches CUDA (a CUDA process cannot
fork) — and
:func:`init_from_env` supports the ``python -m parsec_tpu_torch.launch``
CLI for standalone scripts.
"""

from __future__ import annotations

import collections
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils import mca, output
from .engine import (CommEngine, CAP_ACCELERATOR_MEM, CAP_MULTITHREADED,
                     CAP_STREAMING)
# module-level: registers the comm_device_mem MCA param so the
# PARSEC_MCA_comm_device_mem env layer resolves (an unregistered param
# ignores the environment), and keeps XHostRef out of the progress hot path
from .engine import dtype_of
from .xhost import XHostRef, XHostTransfer

_LEN = struct.Struct("!I")

# frame kinds
_KIND_AM = 0
_KIND_BAR = 1        # barrier arrival (sent to rank 0)
_KIND_BAR_REL = 2    # barrier release (rank 0 -> all)
_KIND_XACK = 4       # IPC pull complete: producer may retire the pin
_KIND_BYE = 3        # clean shutdown notice (fini) — EOF after this is
                     # a normal departure, EOF without it is a FAILURE


#: markers that only a transfer plane emits (status words of a peer that is
#: gone) — strong enough to attribute on sight
_TRANSPORT_STRONG = ("TRANSFER SERVER", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                     "FAILED TO CONNECT", "CONNECTION REFUSED",
                     "UNREACHABLE", "SOCKET")
#: words that ALSO occur in ordinary local errors ("buffer reset",
#: "stream closed", ...) — ambiguous, never trusted on a single failure
_TRANSPORT_WEAK = ("CONNECT", "PEER", "CLOSED", "RESET", "REFUSED",
                   "DEADLINE")


def classify_transport_error(exc: Exception) -> str:
    """Attribute a failure: ``"transport"`` (the PEER's connection/transfer
    plane), ``"local"`` (this rank's own fault), or ``"ambiguous"``.

    Typed checks first: the socket family (OSError covers ConnectionError
    and timeouts) IS the transport. Transfer-plane failures surface as
    RuntimeErrors; only messages carrying markers unique to that plane are
    attributed outright — a local RuntimeError that merely *mentions*
    RESET is ambiguous at most, and callers must retry once before acting
    on it (substring matching alone would let a local error mark a live
    peer dead)."""
    if isinstance(exc, (OSError, TimeoutError, EOFError)):
        return "transport"
    msg = str(exc).upper()
    if "RESOURCE_EXHAUSTED" in msg or "OUT OF MEMORY" in msg:
        return "local"       # the consumer's own OOM, never the wire
    if not isinstance(exc, RuntimeError):
        return "local"       # transfer faults surface as RuntimeError
    if any(m in msg for m in _TRANSPORT_STRONG):
        return "transport"
    if any(m in msg for m in _TRANSPORT_WEAK):
        return "ambiguous"
    return "local"


def _attributed_pull(pull_fn, ref):
    """Run ``pull_fn(ref)`` with failure attribution. Returns
    ``("ok", payload)`` or ``("transport", exc)``; local faults raise.

    Ambiguous failures retry ONCE: a transient wire hiccup succeeds the
    second time; a deterministic local error that happens to contain a
    weak marker raises (the peer stays alive — real peer death is also
    caught by the socket EOF/BYE paths, so under-attributing here is
    safe while over-attributing silently drops a payload)."""
    try:
        return "ok", pull_fn(ref)
    except Exception as exc:  # noqa: BLE001 — classified below
        verdict = classify_transport_error(exc)
        if verdict == "local":
            raise
        if verdict == "transport":
            return "transport", exc
        output.debug_verbose(1, "tcp",
                             f"ambiguous pull failure "
                             f"({type(exc).__name__}: {exc}); retrying once")
        try:
            return "ok", pull_fn(ref)
        except Exception as exc2:  # noqa: BLE001
            if classify_transport_error(exc2) == "transport":
                return "transport", exc2
            raise               # twice-ambiguous/local: this rank's problem


def _send_frame(sock: socket.socket, lock: threading.Lock, obj,
                raw: Optional[memoryview] = None) -> None:
    """Frame = [u32 pickle_len][pickle][u32 raw_len][raw bytes].

    Tensor payloads travel in the raw part straight from the host buffer
    (no pickle copy); the receiver reads them into an arena-allocated
    buffer (the reference allocates remote copies from the dep's arena,
    remote_dep_mpi.c:2120)."""
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    rl = 0 if raw is None else len(raw)
    with lock:
        sock.sendall(_LEN.pack(len(blob)) + blob + _LEN.pack(rl))
        if rl:
            sock.sendall(raw)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_exact_into(sock: socket.socket, mv: memoryview) -> bool:
    off, n = 0, len(mv)
    while off < n:
        r = sock.recv_into(mv[off:])
        if r == 0:
            return False
        off += r
    return True


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    blob = _recv_exact(sock, _LEN.unpack(hdr)[0])
    if blob is None:
        return None
    obj = pickle.loads(blob)
    rhdr = _recv_exact(sock, _LEN.size)
    if rhdr is None:
        return None
    rl = _LEN.unpack(rhdr)[0]
    if isinstance(obj, tuple) and obj and obj[0] == _KIND_AM:
        kind, tag, src, header, inline, meta = obj
        if rl or meta is not None:
            # land the tensor in an arena recv buffer of its size class;
            # a capped-out arena degrades to a plain allocation rather
            # than killing the reader
            from ..data.arena import arena_for, attach_chunk
            shape, dtype_str = meta
            dt = dtype_of(dtype_str)
            chunk = None
            try:
                chunk = arena_for(shape, dt).allocate()
                buf = chunk.buffer
            except MemoryError:
                buf = torch.empty(shape, dtype=dt)
            if rl and not _recv_exact_into(
                    sock, memoryview(buf.reshape(-1).view(torch.uint8)
                                     .numpy()).cast("B")):
                if chunk is not None:
                    chunk.free()
                return None
            if chunk is not None:
                attach_chunk(buf, chunk)
            return (kind, tag, src, header, buf)
        return (kind, tag, src, header, inline)
    if rl and _recv_exact(sock, rl) is None:   # non-AM frames carry no raw
        return None
    return obj


class TCPCE(CommEngine):
    """CE backend over a full TCP mesh between processes."""

    capabilities = CAP_MULTITHREADED | CAP_STREAMING

    def __init__(self, my_rank: int, nb_ranks: int,
                 rendezvous: Tuple[str, int], timeout: float = 60.0) -> None:
        super().__init__(my_rank, nb_ranks)
        self._peers: Dict[int, socket.socket] = {}
        self._peer_locks: Dict[int, threading.Lock] = {}
        self._inbound: "collections.deque" = collections.deque()
        self._readers: List[threading.Thread] = []
        self._closing = False
        #: ranks whose connection died while the job was still live
        #: (failure detection: surfaced by the protocol layer's progress)
        self.dead_peers: set = set()
        self._departed: set = set()   # ranks that said BYE (clean exits)
        self.sent_msgs = 0
        self.recv_msgs = 0
        # cross-process device-payload plane (CUDA IPC), gated by
        # --mca comm_device_mem like the reference's GPU-comms flag
        # (parsec_internal.h:504). _xhost gates the SEND side (None =
        # host-bounce, counted); _xpull services incoming refs regardless,
        # so a flag-off rank can pull from an enabled peer WITHOUT flipping
        # its own sends to the device-mem path
        self._xhost = None
        self._xpull = None
        if mca.get("comm_device_mem", False):
            if XHostTransfer.available():
                self._xhost = self._xpull = XHostTransfer()
                self.capabilities |= CAP_ACCELERATOR_MEM
            else:
                output.warning("comm_device_mem requested but the IPC "
                               "plane is unavailable; device payloads will "
                               "host-bounce (counted)")
        # barrier state
        self._bar_lock = threading.Lock()
        self._bar_cv = threading.Condition(self._bar_lock)
        self._bar_epoch = 0
        # epoch -> set of ranks whose arrival frame was seen (a set, not a
        # count: a cleanly-departed rank that already arrived must not be
        # mistaken for one blocking the barrier)
        self._bar_arrivals: Dict[int, set] = {}
        # epoch -> (dead_ranks, exited_ranks) rank 0 observed
        # (([], []) = clean release)
        self._bar_released: Dict[int, Tuple[List[int], List[int]]] = {}
        if nb_ranks > 1:
            self._bootstrap(rendezvous, timeout)
            for rank, sock in self._peers.items():
                t = threading.Thread(target=self._reader_main,
                                     args=(rank, sock), daemon=True,
                                     name=f"tcpce-r{self.my_rank}-from{rank}")
                t.start()
                self._readers.append(t)

    # ------------------------------------------------------------ bootstrap
    def _bootstrap(self, rendezvous: Tuple[str, int], timeout: float) -> None:
        """Full-mesh setup (the `mpi_funnelled_init` analogue)."""
        deadline = time.monotonic() + timeout
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.my_rank == 0:
            listener.bind(rendezvous)
        else:
            listener.bind(("127.0.0.1", 0))
        listener.listen(self.nb_ranks)
        my_addr = listener.getsockname()

        def _accept() -> socket.socket:
            listener.settimeout(max(0.1, deadline - time.monotonic()))
            conn, _ = listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return conn

        def _recv_expect(conn: socket.socket, kind: str):
            """Receive one handshake frame, attributing EOF and wrong-kind
            frames (checked before unpack — arity varies by kind)."""
            frame = _recv_frame(conn)
            if frame is None:
                raise RuntimeError(f"bootstrap: peer EOF before {kind}")
            if frame[0] != kind:
                raise RuntimeError(
                    f"bootstrap: expected {kind}, got {frame[0]!r}")
            return frame[1:]

        if self.my_rank == 0:
            # collect hellos, then broadcast the address map
            addrs: Dict[int, Tuple[str, int]] = {0: my_addr}
            for _ in range(self.nb_ranks - 1):
                conn = _accept()
                rank, addr = _recv_expect(conn, "hello")
                addrs[rank] = tuple(addr)
                self._peers[rank] = conn
            for rank, conn in self._peers.items():
                lock = self._peer_locks.setdefault(rank, threading.Lock())
                _send_frame(conn, lock, ("map", addrs))
        else:
            # dial rank 0, announce, receive the map
            conn0 = self._dial(tuple(rendezvous), deadline)
            lock0 = self._peer_locks.setdefault(0, threading.Lock())
            _send_frame(conn0, lock0, ("hello", self.my_rank, my_addr))
            (addrs,) = _recv_expect(conn0, "map")
            self._peers[0] = conn0
            # dial every lower non-zero rank, accept from every higher one
            for rank in range(1, self.my_rank):
                conn = self._dial(tuple(addrs[rank]), deadline)
                lock = self._peer_locks.setdefault(rank, threading.Lock())
                _send_frame(conn, lock, ("peer", self.my_rank))
                self._peers[rank] = conn
            for _ in range(self.my_rank + 1, self.nb_ranks):
                conn = _accept()
                (rank,) = _recv_expect(conn, "peer")
                self._peers[rank] = conn
                self._peer_locks.setdefault(rank, threading.Lock())
        listener.close()
        for rank in self._peers:
            self._peer_locks.setdefault(rank, threading.Lock())
        # mesh complete: clear the dial timeout before the readers take
        # over. create_connection's 2s timeout PERSISTS on the socket, so
        # a dialed end's blocking recv would raise socket.timeout (an
        # OSError) after any >2s traffic lull — which _reader_main must
        # treat as peer death. Under full-suite load (multi-second
        # stalls between frames) that misdeclared live peers dead and
        # was the root of the long-standing symmetric "connection lost
        # without clean shutdown" multiproc flaps. Steady-state death
        # detection wants EOF/ECONNRESET only; the handshake above keeps
        # the bounded timeout.
        for sock in self._peers.values():
            sock.settimeout(None)

    @staticmethod
    def _dial(addr: Tuple[str, int], deadline: float) -> socket.socket:
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection(addr, timeout=2.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return s
            except OSError as e:   # peer not listening yet
                last = e
                time.sleep(0.05)
        raise TimeoutError(f"could not reach {addr}: {last}")

    # ------------------------------------------------------------ readers
    def _reader_main(self, rank: int, sock: socket.socket) -> None:
        """Per-peer pre-posted recv slot: decode frames, park AMs for the
        progress path, handle barrier control inline."""
        while not self._closing:
            try:
                frame = _recv_frame(sock)
            except OSError:
                frame = None
            except Exception as e:  # noqa: BLE001 - corrupt frame/meta must
                # not silently kill the reader: the rank would stop receiving
                # from this peer with no attribution
                output.warning(f"rank {self.my_rank}: reader from {rank} "
                               f"died on {type(e).__name__}: {e}")
                frame = None
            if frame is None:
                if not self._closing and rank not in self._departed:
                    # the peer died mid-job: a clean shutdown says BYE
                    # first — record it (and wake any barrier waiter) so
                    # the failure is attributed instead of hanging to a
                    # timeout
                    with self._bar_cv:
                        self.dead_peers.add(rank)
                        self._bar_cv.notify_all()
                    if self._xhost is not None:
                        self._xhost.retire_peer(rank)   # its pulls never come
                return
            kind = frame[0]
            if kind == _KIND_BYE:
                # wake barrier waiters: a clean exit while peers still sit
                # in a barrier is a collective divergence they must see
                # attributed, not hang to a timeout
                with self._bar_cv:
                    self._departed.add(rank)
                    self._bar_cv.notify_all()
                if self._xhost is not None:
                    self._xhost.retire_peer(rank)   # clean exit: same deal
                return
            if kind == _KIND_AM:
                self._inbound.append(frame[1:])
            elif kind == _KIND_BAR:
                with self._bar_cv:
                    self._bar_arrivals.setdefault(frame[1], set()).add(rank)
                    self._bar_cv.notify_all()
            elif kind == _KIND_BAR_REL:
                with self._bar_cv:
                    # (epoch, dead_ranks, cleanly_exited_ranks)
                    self._bar_released[frame[1]] = \
                        (frame[2], frame[3]) if len(frame) > 3 else ([], [])
                    self._bar_cv.notify_all()
            elif kind == _KIND_XACK:
                if self._xhost is not None:
                    self._xhost.retire(frame[1])

    # ------------------------------------------------------------ AM path
    def send_am(self, tag: int, dst: int, header: Any, payload: Any = None) -> None:
        self.sent_msgs += 1
        if dst == self.my_rank:
            self._inbound.append((tag, dst, header, payload))
            return
        meta, raw, inline = None, None, payload
        if isinstance(payload, torch.Tensor):
            is_device = payload.device.type == "cuda"
            if is_device and self._xhost is not None:
                # device-native cross-rank path: export for a CUDA IPC
                # pull, ship only the rendezvous descriptor in the wire
                # frame — the consumer copies card to card on its pull
                # (parsec_mpi_funnelled.c:642 role)
                ref = self._xhost.offer(payload, dst=dst)
                _send_frame(self._peers[dst], self._peer_locks[dst],
                            (_KIND_AM, tag, self.my_rank, header, ref,
                             None), None)
                return
            # CUDA tensors materialize host bytes HERE, at the wire
            # boundary — the protocol layer above never forces them.
            # Counted so the d2d plane's "zero host materializations"
            # property is assertable against this stream transport
            # (comm/d2d.py docstring).
            if is_device:
                from ..utils.counters import counters
                counters.add("comm.host_materialized_msgs")
            # shared codec (CommEngine.encode_payload): the tensor's host
            # bytes ship straight from its buffer, bf16 as raw words
            meta, raw, inline = self.encode_payload(payload)
        _send_frame(self._peers[dst], self._peer_locks[dst],
                    (_KIND_AM, tag, self.my_rank, header, inline, meta), raw)

    # one-sided put/get + handle table inherited from CommEngine

    # ------------------------------------------------------------ progress
    def progress(self, max_msgs: int = 64) -> int:
        n = 0
        while n < max_msgs:
            try:
                tag, src, header, payload = self._inbound.popleft()
            except IndexError:
                break
            self.recv_msgs += 1
            if isinstance(payload, XHostRef):
                # rendezvous envelope: pull the device buffer onto this
                # rank's card through CUDA IPC, then tell the producer to
                # retire its pin
                ref = payload
                if self._xpull is None:     # pull-only handle: servicing a
                    self._xpull = XHostTransfer()   # peer does NOT enable
                # only TRANSPORT-attributed failures mean the producer is
                # gone (crashed before the pull) — those are attributed
                # like the BYE/EOF paths. A local fault (consumer OOM, bad
                # ref) must not blame a live peer; it propagates as this
                # rank's error, and ambiguous failures get one retry before
                # either (typed classification + retry)
                status, got = _attributed_pull(self._xpull.pull, ref)
                if status == "ok":
                    payload = got
                else:
                    exc = got
                    output.warning(
                        f"tcp: xhost pull from rank {src} failed "
                        f"({type(exc).__name__}: {exc}); marking peer dead")
                    with self._bar_cv:
                        self.dead_peers.add(src)
                        self._bar_cv.notify_all()
                    if self._xhost is not None:
                        self._xhost.retire_peer(src)
                    n += 1
                    continue
                try:
                    _send_frame(self._peers[src], self._peer_locks[src],
                                (_KIND_XACK, ref.uuid))
                except OSError:
                    # producer already gone (fini/crash): the payload is
                    # ours; its pin dies with the producer's process or
                    # its dead-peer retirement
                    pass
            if not self._deliver(tag, src, header, payload):
                output.debug_verbose(1, "tcp", f"dropped AM tag {tag}")
            n += 1
        return n

    def sync(self, timeout: float = 60.0) -> None:
        """Collective barrier: arrivals funnel to rank 0, release fans out."""
        if self.nb_ranks == 1:
            return
        with self._bar_cv:
            self._bar_epoch += 1
            epoch = self._bar_epoch
        def _dead_check():
            if self.dead_peers:
                raise RuntimeError(
                    f"rank(s) {sorted(self.dead_peers)} FAILED while rank "
                    f"{self.my_rank} was in a barrier (epoch {epoch})")
        if self.my_rank == 0:
            def _blocking_exits():
                # cleanly-departed ranks that never arrived can block the
                # barrier forever: a collective divergence, attributed
                arrived = self._bar_arrivals.get(epoch, set())
                return sorted(self._departed - arrived)
            with self._bar_cv:
                ok = self._bar_cv.wait_for(
                    lambda: self.dead_peers or _blocking_exits() or
                    len(self._bar_arrivals.get(epoch, ()))
                    >= self.nb_ranks - 1,
                    timeout=timeout)
                dead = sorted(self.dead_peers)
                gone = _blocking_exits()
                self._bar_arrivals.pop(epoch, None)
            if ok or dead or gone:
                # fan out the release even on failure (carrying the failed
                # list): an asymmetric link break only rank 0 observed must
                # not strand healthy peers into a misleading barrier
                # timeout — they raise attributed instead
                for rank in self._peers:
                    try:
                        _send_frame(self._peers[rank],
                                    self._peer_locks[rank],
                                    (_KIND_BAR_REL, epoch, dead, gone))
                    except OSError:
                        # a dead socket must not abort releases to the
                        # healthy ranks; readers attribute the death
                        pass
            # a dead peer is a job failure even if its arrival was counted
            # before it died
            _dead_check()
            if gone:
                raise RuntimeError(
                    f"rank(s) {gone} exited cleanly while rank 0 was in a "
                    f"barrier (epoch {epoch}): collective divergence")
            if not ok:
                raise TimeoutError(f"barrier epoch {epoch} timed out")
        else:
            try:
                _send_frame(self._peers[0], self._peer_locks[0],
                            (_KIND_BAR, epoch))
            except OSError:
                # rank 0 already gone (e.g. it raised on another rank's
                # death and exited): fall through to the wait, where the
                # already-delivered release/dead-list attributes the
                # failure instead of a raw BrokenPipeError
                pass
            with self._bar_cv:
                ok = self._bar_cv.wait_for(
                    lambda: self.dead_peers or 0 in self._departed or
                    epoch in self._bar_released,
                    timeout=timeout)
                rel = self._bar_released.pop(epoch, None)
                root_gone = rel is None and 0 in self._departed
                _dead_check()   # our own observation of a death wins
            if rel is not None and rel[0]:
                raise RuntimeError(
                    f"rank(s) {rel[0]} FAILED while rank {self.my_rank} "
                    f"was in a barrier (epoch {epoch}, reported by rank 0)")
            if rel is not None and rel[1]:
                raise RuntimeError(
                    f"rank(s) {rel[1]} exited cleanly while rank "
                    f"{self.my_rank} was in a barrier (epoch {epoch}): "
                    f"collective divergence (reported by rank 0)")
            if root_gone:
                raise RuntimeError(
                    f"rank 0 exited cleanly while rank {self.my_rank} was "
                    f"in a barrier (epoch {epoch}): collective divergence")
            if not ok:
                raise TimeoutError(f"barrier epoch {epoch} timed out")

    def fini(self) -> None:
        self._closing = True
        for rank, sock in self._peers.items():
            try:   # best-effort goodbye so peers see a departure, not a death
                _send_frame(sock, self._peer_locks[rank], (_KIND_BYE,))
            except OSError:
                pass
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        for t in self._readers:
            t.join(timeout=2.0)
        self._peers.clear()
        if self._xhost is not None:
            self._xhost.clear()        # nothing will pull after goodbye


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------
ENV_RANK = "PARSEC_TPU_TORCH_RANK"
ENV_NPROCS = "PARSEC_TPU_TORCH_NPROCS"
ENV_RDV = "PARSEC_TPU_TORCH_RDV"       # host:port of rank 0's listener


def init_from_env(timeout: float = 60.0) -> TCPCE:
    """Build the CE from launcher-provided env vars (the `MPI_Init` moment
    for scripts started via ``python -m parsec_tpu_torch.launch -n N
    script.py``)."""
    rank = int(os.environ.get(ENV_RANK, "0"))
    nprocs = int(os.environ.get(ENV_NPROCS, "1"))
    host, _, port = os.environ.get(ENV_RDV, "127.0.0.1:0").rpartition(":")
    return TCPCE(rank, nprocs, (host, int(port)), timeout=timeout)


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _proc_main(program: Callable, rank: int, nb_ranks: int,
               rdv: Tuple[str, int], q, env: Dict[str, str]) -> None:
    # a forked rank holds the forkserver's environment: take the job's
    os.environ.clear()
    os.environ.update(env)
    try:
        ce = TCPCE(rank, nb_ranks, rdv)
        q.put((rank, "ok", program(rank, ce)))
    except BaseException as e:  # noqa: BLE001 - shipped to the parent
        import traceback
        q.put((rank, "err", f"{e}\n{traceback.format_exc()}"))


def run_distributed_procs(nb_ranks: int,
                          program: Callable[[int, TCPCE], Any],
                          timeout: float = 120.0) -> List[Any]:
    """Run ``program(rank, ce)`` on N real OS processes joined by TCP.

    The process analogue of
    :func:`parsec_tpu_torch.comm.threads.run_distributed` (which runs
    ranks as threads): same signature shape, a real process boundary.
    ``program`` must be picklable (module-level). A process that has
    touched CUDA cannot fork, so the ranks start with the ``forkserver``
    method: each forks from a server process that was itself started as a
    new interpreter and imported torch and this package once
    (:data:`FORKSERVER_PRELOAD`), never CUDA, so a job's ranks pay no
    interpreter start and torch import each. A rank runs with the
    environment of the job's start, as a spawned one would.

    Jobs serialize behind the host-wide
    :func:`parsec_tpu_torch.launch.multiproc_lock` (concurrent sessions
    push each other past their rendezvous deadlines). A job whose ranks
    hang to the deadline raises ``TimeoutError`` (it is never rerun, so a
    hang shows); a program error or a rank that died without reporting
    raises ``RuntimeError``.
    """
    from ..launch import multiproc_lock
    with multiproc_lock():
        return _run_distributed_procs_once(nb_ranks, program, timeout)


def stop_forkserver() -> None:
    """Stop the forkserver the ranks fork from, and multiprocessing's
    resource tracker, and wait for both to exit. Left alone, each notices
    that its parent is gone only after the parent has exited, so a program
    would end with them still running. Registered to run at exit by the
    first job; a later job starts a new server."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


#: what the forkserver imports before it forks a rank: none of these
#: touches CUDA at import
FORKSERVER_PRELOAD = ("numpy", "torch", "parsec_tpu_torch.comm.tcp",
                      "parsec_tpu_torch.comm.remote_dep",
                      "parsec_tpu_torch.core.context",
                      "parsec_tpu_torch.dsl.dtd",
                      "parsec_tpu_torch.dsl.ptg.compiler")


def _run_distributed_procs_once(nb_ranks: int,
                                program: Callable[[int, TCPCE], Any],
                                timeout: float) -> List[Any]:
    import atexit
    import multiprocessing as mp
    atexit.unregister(stop_forkserver)
    atexit.register(stop_forkserver)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
    rdv = ("127.0.0.1", _free_port())
    q = ctx.Queue()
    env = dict(os.environ)
    procs = [ctx.Process(target=_proc_main,
                         args=(program, r, nb_ranks, rdv, q, env),
                         daemon=True, name=f"parsec-rank-{r}")
             for r in range(nb_ranks)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * nb_ranks
    errors: List[Optional[str]] = [None] * nb_ranks
    reported = [False] * nb_ranks
    got = 0
    deadline = time.monotonic() + timeout
    import queue as _q
    while got < nb_ranks and time.monotonic() < deadline:
        try:
            rank, status, value = q.get(timeout=0.2)
        except _q.Empty:
            # a child that died without reporting (segfault, OOM-kill) will
            # never feed the queue — stop waiting as soon as one is seen
            if any(not reported[i] and not p.is_alive() and p.exitcode is not None
                   for i, p in enumerate(procs)):
                time.sleep(0.2)   # drain any result racing the exit
                while True:
                    try:
                        rank, status, value = q.get_nowait()
                    except _q.Empty:
                        break
                    reported[rank] = True
                    (results if status == "ok" else errors)[rank] = value
                    got += 1
                break
            continue
        reported[rank] = True
        if status == "ok":
            results[rank] = value
        else:
            errors[rank] = value
        got += 1
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
    # hung = alive AND never reported: a rank that reported but lingers
    # past the join budget is slow teardown, not a hang — it must neither
    # discard a complete result set nor shadow a dead rank's exitcode
    hung = [i for i, p in enumerate(procs)
            if p.is_alive() and not reported[i]]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
    first = next((e for e in errors if e is not None), None)
    if hung:
        # an unreported rank hung to the deadline: that hang is the root
        # cause and outranks any reported error — terminating the hung
        # rank tears its transport down, so peers report collateral
        # Broken pipe / reset errors (their text rides along).
        raise TimeoutError(
            f"ranks {hung} did not finish within {timeout}s"
            + (f"; peer error (likely collateral):\n{first}" if first else ""))
    if first is not None:
        raise RuntimeError(f"distributed rank failed:\n{first}")
    if got < nb_ranks:
        dead = [i for i in range(nb_ranks) if not reported[i]]
        raise RuntimeError(
            f"ranks {dead} died without reporting "
            f"(exitcodes {[procs[i].exitcode for i in dead]})")
    return results
