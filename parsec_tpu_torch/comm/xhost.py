"""Cross-process device-payload plane: CUDA IPC pulls between OS ranks.

The half of the device-memory comms story that :mod:`comm/d2d.py` cannot
cover: when a device-resident payload must cross OS ranks on one host, the
reference moves GPU buffers directly through the funnelled CE when allowed
(``parsec_mpi_allow_gpu_memory_communications``,
parsec/parsec_internal.h:504, send path parsec_mpi_funnelled.c:642). Here
that is CUDA IPC, through torch's own CUDA-IPC tensor reduction
(``torch.multiprocessing.reductions``): the owner exports the payload's
allocation handle and its offset in the caching allocator's segment,
together with an IPC event recorded after the payload's ready event, and
ships a small :class:`XHostRef` over the host fabric; the consumer opens
the handle (its stream waits on the event), copies into a tensor of its
own on its device, drops the mapping and ACKs.

Flow control mirrors an RDMA rendezvous: ``offer()`` pins the tensor in a
ledger until the consumer's transport-level ACK retires it (TCPCE sends
``_KIND_XACK`` after a successful pull), so the buffer outlives the
in-flight pull without an unbounded leak; ``retire_peer`` drops a dead or
departed peer's pins.

A handle cannot be opened in the process that made it, so a pull of this
process's own offer copies from the ledger. CPU tensors (the tests run
without a card) move through a named shared-memory segment instead: the
owner copies the bytes in and keeps the segment until the ACK, the
consumer copies them out.

Gating: ``--mca comm_device_mem 1`` (default off, like the reference's
GPU-comms flag). The host-bounce fallback — CUDA tensors materialized into
wire bytes — stays COUNTED via ``comm.host_materialized_msgs``; successful
pulls count ``comm.xhost_d2d_msgs/bytes`` on the consumer and
``comm.xhost_offered_msgs`` on the producer.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils import mca
from ..utils.counters import counters
from .engine import dtype_name, dtype_of, host_bytes, ready_event, wait_ready

mca.register("comm_device_mem", False,
             "Move device-resident payloads across OS ranks via CUDA IPC "
             "pulls instead of host-materializing them into the wire frame "
             "(ref: parsec_mpi_allow_gpu_memory_communications)",
             type=bool)

CTR_OFFERED = "comm.xhost_offered_msgs"
CTR_D2D_MSGS = "comm.xhost_d2d_msgs"
CTR_D2D_BYTES = "comm.xhost_d2d_bytes"

#: the launcher's binding of this OS rank to a card (``--virtual-devices``)
ENV_LOCAL_DEVICE = "PARSEC_TPU_TORCH_LOCAL_DEVICE"


@dataclass(frozen=True)
class XHostRef:
    """Picklable pull descriptor that rides the host AM frame in place of
    the tensor payload (the rendezvous envelope)."""
    uuid: int
    address: str        # the owner: "<host>:<pid>"
    shape: Tuple[int, ...]
    dtype: str          # dtype name ("bfloat16", "float32")
    kind: str           # "cuda" (an IPC handle) or "shm" (a segment name)
    handle: Any         # the CUDA-IPC rebuild arguments, or the segment name


def local_device() -> torch.device:
    """The device this OS rank is bound to (the launcher's binding rule:
    rank i drives card i mod the card count). Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("this rank has no CUDA card to be bound to")
    bind = os.environ.get(ENV_LOCAL_DEVICE)
    idx = int(bind) % torch.cuda.device_count() if bind is not None \
        else torch.cuda.current_device()
    return torch.device("cuda", idx)


def _attach_shm(name: str):
    """Open an existing segment without handing it to this process's
    resource tracker (which would unlink the owner's segment at exit)."""
    from multiprocessing import resource_tracker, shared_memory
    shm = shared_memory.SharedMemory(name=name)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 - not tracked on this platform
        pass
    return shm


class XHostTransfer:
    """One per OS rank: the offer ledger and the pull side.

    ``offer(payload) -> XHostRef`` exports a tensor for pull and pins it;
    ``pull(ref) -> torch.Tensor`` copies a peer's offer onto this rank's
    device; ``retire(uuid)`` drops the pin once the peer ACKs.
    """

    @staticmethod
    def available() -> bool:
        """True: torch's CUDA-IPC reduction and named shared memory are
        always there (TCPCE keeps the counted host bounce for a plane
        that is not)."""
        return True

    def __init__(self) -> None:
        self._ledger: Dict[int, Tuple[Any, Optional[int]]] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._rank_salt = (os.getpid() & 0xFFFFF) << 40
        import socket
        self._address = f"{socket.gethostname()}:{os.getpid()}"

    @property
    def address(self) -> str:
        return self._address

    # ------------------------------------------------------------- producer
    def offer(self, payload: torch.Tensor, dst: Optional[int] = None
              ) -> XHostRef:
        t = payload.detach()
        if not t.is_contiguous():
            t = t.contiguous()
        with self._lock:
            self._seq += 1
            uuid = self._rank_salt | self._seq
        if t.device.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor
            # the IPC event torch records rides the current stream: order
            # it after the work that wrote the payload
            with torch.cuda.device(t.device):
                wait_ready(t)
                _rebuild, args = reduce_tensor(t)
            kind, handle, pin = "cuda", args, t
        else:
            from multiprocessing import shared_memory
            raw = host_bytes(t)
            shm = shared_memory.SharedMemory(create=True,
                                             size=max(1, raw.nbytes))
            shm.buf[:raw.nbytes] = raw
            kind, handle, pin = "shm", shm.name, shm
        with self._lock:
            self._ledger[uuid] = (pin, dst)    # pinned until ACK
        counters.add(CTR_OFFERED)
        return XHostRef(uuid, self._address, tuple(t.shape),
                        dtype_name(t.dtype), kind, handle)

    def _drop(self, pin) -> None:
        if not isinstance(pin, torch.Tensor):
            try:
                pin.close()
                pin.unlink()
            except Exception:  # noqa: BLE001 - already gone is fine
                pass

    def retire(self, uuid: int) -> None:
        with self._lock:
            ent = self._ledger.pop(uuid, None)
        if ent is not None:
            self._drop(ent[0])

    def retire_peer(self, dst: int) -> None:
        """Drop every pin offered to a rank that died or departed — its
        pulls will never come, and the pinned buffers must not outlive the
        failure (the 'unbounded leak' guard)."""
        with self._lock:
            gone = [u for u, (_, d) in self._ledger.items() if d == dst]
            ents = [self._ledger.pop(u) for u in gone]
        for pin, _ in ents:
            self._drop(pin)

    def clear(self) -> None:
        with self._lock:
            ents = list(self._ledger.values())
            self._ledger.clear()
        for pin, _ in ents:
            self._drop(pin)

    def pending(self) -> int:
        with self._lock:
            return len(self._ledger)

    # ------------------------------------------------------------- consumer
    def pull(self, ref: XHostRef) -> torch.Tensor:
        """A tensor of this rank's own holding ``ref``'s bytes: on this
        rank's card for a CUDA offer (its ready event marks the copy), on
        the host for a shared-memory one."""
        dt = dtype_of(ref.dtype)
        if ref.kind == "cuda":
            dev = local_device()
            with self._lock:
                ent = self._ledger.get(ref.uuid) \
                    if ref.address == self._address else None
            with torch.cuda.device(dev):
                if ent is not None:
                    # this process's own offer: a handle cannot be opened
                    # where it was made, so copy from the ledger's tensor
                    src = ent[0]
                    wait_ready(src)
                    own = src.to(dev, copy=True)
                else:
                    from torch.multiprocessing.reductions import \
                        rebuild_cuda_tensor
                    # the rebuild opens the handle and orders the current
                    # stream after the owner's IPC event
                    shared = rebuild_cuda_tensor(*ref.handle)
                    own = shared.to(dev, copy=True)
                    del shared
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
            own._pt_ready = ev
        else:
            with self._lock:
                ent = self._ledger.get(ref.uuid) \
                    if ref.address == self._address else None
            # this process's own segment is read as it is (attaching it
            # again would hand it to the resource tracker twice)
            shm = ent[0] if ent is not None else _attach_shm(ref.handle)
            try:
                n = 1
                for s in ref.shape:
                    n *= int(s)
                nbytes = n * torch.empty((), dtype=dt).element_size()
                flat = torch.empty(nbytes, dtype=torch.uint8)
                if nbytes:
                    flat.numpy()[:] = memoryview(shm.buf)[:nbytes]
                own = flat.view(dt).reshape(ref.shape)
            finally:
                if ent is None:
                    shm.close()
        counters.add(CTR_D2D_MSGS)
        counters.add(CTR_D2D_BYTES, int(own.nbytes))
        return own


__all__ = ["XHostRef", "XHostTransfer", "local_device", "ready_event"]
