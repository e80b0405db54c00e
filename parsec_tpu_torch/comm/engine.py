"""Communication-engine abstraction (CE).

Re-design of parsec/parsec_comm_engine.h:14-176: a backend-neutral vtable —
active-message tags with fixed max sizes (``tag_register``), memory
registration, one-sided ``put/get`` with remote completion AMs, ``send_am``,
``progress``, ``pack/unpack``, ``sync`` and capability flags. The reference
ships one production backend (single-threaded "funnelled" MPI,
parsec_mpi_funnelled.c); here the backends are:

* :class:`parsec_tpu_torch.comm.threads.ThreadsCE` — N in-process ranks
  joined by queues (the test fabric, where oversubscribed localhost MPI
  stood in the reference's test strategy, tests/CMakeLists.txt:1032-1042),
  and :class:`parsec_tpu_torch.comm.d2d.D2DCE` over it, whose data plane
  moves CUDA tensors device to device;
* :class:`parsec_tpu_torch.comm.tcp.TCPCE` — N processes joined by a TCP
  mesh, with CUDA IPC for device payloads (``comm/xhost.py``).

Tag space mirrors the reference (parsec_comm_engine.h:29-40): internal
GET/PUT handshake tags, remote-dep activate, termdet, DSL-reserved tags.
The numbers are fixed: frames and tests name them.

Payloads are torch tensors. A tensor is mutable, so the value a send ships
is a snapshot taken at the send boundary (:func:`snapshot`): a copy that
no later write of the producer reaches. A CUDA snapshot is made on a side
stream after the producing streams' work and carries the event that marks
it done (:func:`ready_event`); every reader on another stream or thread
waits on it (:func:`wait_ready`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch

MAX_REGISTERED_TAGS = 16  # ref: PARSEC_MAX_REGISTERED_TAGS (12 there;
                          # widened for the runtime-internal tags below)

# predefined tags (ref: parsec_comm_engine.h:29-40 enumeration)
TAG_INTERNAL_GET = 0
TAG_INTERNAL_PUT = 1
TAG_REMOTE_DEP_ACTIVATE = 2
TAG_TERMDET = 3
TAG_DSL_BASE = 4          # DSL reservations start here
TAG_PTCOMM_BOOT = 8       # native comm lane bootstrap (comm/native.py)
TAG_CLOCKSYNC = 9         # rank-0 clock-offset ping-pong (remote_dep.py)
TAG_CNT_AGG = 10          # cross-rank counter aggregation at fini
TAG_DTD_AUDIT = 11        # DTD replay-consistency auditor exchange
TAG_PTFAB = 12            # serving-fabric control plane (serving/):
                          # gateway-routed inserts + reconciliation
                          # weight nudges; admission credits themselves
                          # ride the native wire (ptcomm K_CRED)
TAG_PTTEL = 13            # mesh telemetry plane (comm/pttel.py):
                          # counter deltas + sparse histogram buckets
                          # pushed up the fanout reduction tree every
                          # --mca tel_interval_ms; rank 0 serves /mesh

# capability flags (ref: parsec_comm_engine capabilities)
CAP_ONESIDED = 0x1
CAP_MULTITHREADED = 0x2
CAP_ACCELERATOR_MEM = 0x4   # can move device-resident buffers directly
CAP_STREAMING = 0x8         # AM payloads ride the same ordered stream as
                            # headers: rendezvous buys no registration or
                            # one-sidedness, so eager (PUT-with-activate)
                            # is the right default at ANY size


@dataclass
class AMRegistration:
    tag: int
    msg_size: int
    callback: Callable[["CommEngine", int, bytes, Any], None]  # (ce, src, hdr, payload)


# ------------------------------------------------------------- payloads
_side_streams: Dict[Any, Any] = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device):
    """The stream snapshots of ``device``'s tensors are copied on."""
    s = _side_streams.get(device)
    if s is None:
        with _side_lock:
            s = _side_streams.get(device)
            if s is None:
                s = _side_streams[device] = torch.cuda.Stream(device)
    return s


def ready_event(payload) -> Optional[Any]:
    """The CUDA event that marks ``payload`` written (set by
    :func:`snapshot` and by the device planes), or None."""
    return getattr(payload, "_pt_ready", None)


def wait_ready(payload, stream=None) -> None:
    """Order ``stream`` (default: the current stream of the payload's
    device) after the work that wrote ``payload``."""
    ev = ready_event(payload)
    if ev is None:
        return
    if stream is None:
        stream = torch.cuda.current_stream(payload.device)
    stream.wait_event(ev)
    payload.record_stream(stream)


def snapshot(payload, after: Iterable[Any] = ()) -> Any:
    """The value a send ships: a copy of ``payload`` that no later write of
    the producer reaches (torch tensors are mutable, so nothing aliases the
    producer's tile). A CUDA tensor is copied on a side stream that first
    waits for the current stream and the ``after`` streams (the device
    module's stream that produced or staged it); the copy carries its ready
    event. Anything not a tensor becomes one."""
    if not isinstance(payload, torch.Tensor):
        return torch.as_tensor(payload)
    if payload.device.type != "cuda":
        return payload.detach().clone()
    side = _side_stream(payload.device)
    side.wait_stream(torch.cuda.current_stream(payload.device))
    for s in after:
        side.wait_stream(s)
    ev0 = ready_event(payload)
    if ev0 is not None:
        side.wait_event(ev0)
    with torch.cuda.stream(side):
        snap = payload.detach().clone(memory_format=torch.contiguous_format)
        ev = torch.cuda.Event(interprocess=False)
        ev.record(side)
    payload.record_stream(side)
    snap._pt_ready = ev
    return snap


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the wire's dtype tag)."""
    return str(dtype).replace("torch.", "")


def dtype_of(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype tag {name!r}")
    return dt


def host_bytes(t: torch.Tensor) -> memoryview:
    """A CPU tensor's bytes as a flat memoryview (no copy for a
    contiguous tensor; any dtype, bf16 included, as raw words)."""
    t = t.detach().contiguous().reshape(-1)
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.view(torch.uint8).numpy()).cast("B")


class CommEngine:
    """The CE vtable (ref: parsec_comm_engine.h:43-176)."""

    capabilities = 0

    def __init__(self, my_rank: int = 0, nb_ranks: int = 1) -> None:
        self.my_rank = my_rank
        self.nb_ranks = nb_ranks
        self._tags: Dict[int, AMRegistration] = {}
        self._lock = threading.Lock()
        self._handles: Dict[int, Any] = {}
        self._next_handle = 0

    # --- active messages ----------------------------------------------------
    def tag_register(self, tag: int, callback, msg_size: int = 4096) -> None:
        if len(self._tags) >= MAX_REGISTERED_TAGS:
            raise RuntimeError("out of AM tags (MAX_REGISTERED_TAGS)")
        self._tags[tag] = AMRegistration(tag, msg_size, callback)

    def tag_unregister(self, tag: int) -> None:
        self._tags.pop(tag, None)

    def send_am(self, tag: int, dst: int, header: Any,
                payload: Any = None) -> None:
        raise NotImplementedError

    # --- one-sided (emulated over two-sided AMs with internal handshake
    # tags, as the reference emulates RDMA over MPI; parsec_mpi_funnelled.c)
    # — shared by every two-sided backend -----------------------------------
    def mem_register(self, buf) -> Any:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._handles[h] = buf
        return h

    def mem_unregister(self, handle) -> None:
        with self._lock:
            self._handles.pop(handle, None)

    def resolve(self, handle):
        return self._handles.get(handle)

    def put(self, dst: int, local_buf, remote_handle, on_complete=None) -> None:
        self.send_am(TAG_INTERNAL_PUT, dst, {"handle": remote_handle}, local_buf)
        if on_complete is not None:
            on_complete()

    def get(self, src: int, remote_handle, on_complete=None) -> None:
        """Request the remote buffer; data arrives as the matching PUT.

        ``on_complete`` CANNOT fire here — the GET is only a request, and
        completion is observable solely through the PUT delivery on the
        registered tag — so passing one is rejected."""
        if on_complete is not None:
            raise ValueError(
                "CommEngine.get() cannot invoke on_complete: completion "
                "arrives as the matching PUT on the registered tag — hook "
                "the PUT delivery instead")
        self.send_am(TAG_INTERNAL_GET, src,
                     {"handle": remote_handle, "requester": self.my_rank}, None)

    # --- progress / sync ----------------------------------------------------
    def progress(self) -> int:
        """Drain incoming messages; returns #messages handled."""
        raise NotImplementedError

    def sync(self) -> None:
        """Collective barrier over all ranks."""
        raise NotImplementedError

    def enable(self) -> None:
        pass

    def fini(self) -> None:
        pass

    # --- pack/unpack --------------------------------------------------------
    #: prefix marking a raw-bytes packed blob: no pickle frame at all.
    #: Pickle streams (protocol >= 2) always begin with b"\x80", so the
    #: NUL-led magic can never collide with a pickled message.
    _RAW_MAGIC = b"\x00PTB1"

    def pack(self, obj: Any) -> bytes:
        """Serialize ``obj`` for the wire. Bytes-like payloads skip pickle
        entirely — one prefix concat instead of a pickle scan+copy."""
        if isinstance(obj, (bytes, bytearray, memoryview)):
            return self._RAW_MAGIC + bytes(obj)
        import pickle
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def unpack(self, data) -> Any:
        """Inverse of :meth:`pack`. Raw-packed blobs come back as a
        zero-copy ``memoryview`` into ``data`` (no pickle, no copy)."""
        view = memoryview(data)
        n = len(self._RAW_MAGIC)
        if len(view) >= n and bytes(view[:n]) == self._RAW_MAGIC:
            return view[n:]
        import pickle
        return pickle.loads(data)

    # --- shared payload codec ----------------------------------------------
    @staticmethod
    def encode_payload(payload):
        """Split a tensor payload for a zero-copy send:
        ``(meta, raw, inline)`` — ``raw`` is a memoryview over the host
        tensor's bytes with ``meta = (shape, dtype tag)`` describing it
        (bf16 rides as its raw 2-byte words, tagged ``"bfloat16"``);
        payloads that are not tensors come back as ``inline`` (the
        transport pickles them). A CUDA tensor materializes host bytes
        HERE, at the wire boundary, after its ready event. Shared by the
        TCP frames and the native lane's eager/rendezvous data path."""
        if not isinstance(payload, torch.Tensor):
            return None, None, payload
        t = payload.detach()
        if t.device.type == "cuda":
            wait_ready(t)
            t = t.cpu()
        return (tuple(t.shape), dtype_name(t.dtype)), host_bytes(t), None

    @staticmethod
    def decode_raw(meta, buf) -> torch.Tensor:
        """Materialize a raw payload: a CPU tensor over the received buffer
        (zero-copy where the buffer is writable; the transport owns its
        lifetime)."""
        shape, dtype_str = meta
        dt = dtype_of(dtype_str)
        view = memoryview(buf).cast("B")
        if view.nbytes == 0:
            return torch.empty(tuple(shape), dtype=dt)
        if view.readonly:
            view = memoryview(bytearray(view))
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            flat = torch.frombuffer(view, dtype=torch.uint8)
        return flat.view(dt).reshape(tuple(shape))

    def _deliver(self, tag: int, src: int, header: Any, payload: Any) -> bool:
        reg = self._tags.get(tag)
        if reg is None:
            return False
        reg.callback(self, src, header, payload)
        return True
