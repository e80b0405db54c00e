"""Device-to-device comm-engine backend: tiles move card to card.

The reference's comm engine can move accelerator-resident buffers directly
when the backend advertises the capability (PARSEC_PROP_DEVICE_MEM_COMMS,
parsec/parsec_internal.h:504) and lands received copies on the consumer's
preferred device (parsec/remote_dep_mpi.c:2120). This backend is that
design over in-process ranks (the thread fabric):

* **control plane** — activate/get/put headers, termdet tokens, audit and
  counter exchanges are small host-side dicts; they ride the thread fabric
  like the funnelled MPI backend's active messages.
* **data plane** — a payload that is a CUDA tensor is relocated at the send
  boundary onto ``device_map[dst]``, the card the consumer rank's runtime
  drives (:attr:`D2DCE.relocate`: a copy on a side stream ordered after
  the payload's ready event, with its own event). With one card every rank
  drives ``cuda:0`` and the payload — already this message's own snapshot,
  taken by the protocol layer at the send boundary — crosses as it is.
  Host payloads pass unchanged (host content: shipping them is the initial
  distribution, not a device round trip).
* **landing** — the protocol layer (``remote_dep._land_on_devices``) sees
  that the arrived payload already lives on the consumer's card and makes
  it that card's copy at the new version, so the consumer's stage-in takes
  the version-match fast path: zero transfers on the consume side.

Across OS ranks the device-native path is :mod:`comm/xhost.py` (CUDA IPC
behind ``--mca comm_device_mem 1``). In the CPU test mode
(``device_cuda_over_cpu``) the map's devices are the CPU, so every tensor
counts as device-resident there.

Counters (process-wide, :mod:`parsec_tpu_torch.utils.counters`; the names
are the reference's, so the counter cross-checks and ``/metrics`` read the
same):

* ``comm.ici_d2d_msgs`` / ``comm.ici_d2d_bytes`` — payloads moved device
  to device at the send boundary.
* ``comm.ici_host_msgs`` — host-resident tensor payloads that crossed (the
  initial-distribution case; NOT a device round trip).
* ``comm.host_materialized_msgs`` — device payloads forced to host bytes by
  a wire transport (TCPCE counts here; D2DCE never does).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils.counters import counters
from .engine import (CAP_ACCELERATOR_MEM, CAP_MULTITHREADED, CAP_STREAMING,
                     _side_stream, ready_event)
from .threads import ThreadFabric, ThreadsCE

CTR_D2D_MSGS = "comm.ici_d2d_msgs"
CTR_D2D_BYTES = "comm.ici_d2d_bytes"
CTR_HOST_MSGS = "comm.ici_host_msgs"
CTR_HOST_MATERIALIZED = "comm.host_materialized_msgs"


class D2DCE(ThreadsCE):
    """CE backend whose data plane relocates tensors device to device.

    ``device_map[rank]`` is the ``torch.device`` rank *rank*'s runtime
    drives. A tensor payload on a device of the map is relocated onto
    ``device_map[dst]`` before entering the fabric, so it arrives resident
    on the consumer's card.
    """

    capabilities = CAP_MULTITHREADED | CAP_ACCELERATOR_MEM | CAP_STREAMING

    def __init__(self, fabric: ThreadFabric, my_rank: int,
                 device_map: Sequence) -> None:
        super().__init__(fabric, my_rank)
        if len(device_map) < fabric.nb_ranks:
            raise ValueError(
                f"device_map covers {len(device_map)} ranks, fabric has "
                f"{fabric.nb_ranks}")
        self.device_map = [torch.device(d) for d in device_map]
        self._devices = set(self.device_map)

    @staticmethod
    def relocate(payload: torch.Tensor, device: torch.device):
        """``payload`` on ``device``: the seam a multi-card host crosses
        with a peer copy (ordered after the payload's ready event, marked
        by an event of its own); a payload already there is returned as
        it is."""
        if payload.device == device:
            return payload
        if device.type != "cuda":
            return payload.to(device)
        side = _side_stream(device)
        ev0 = ready_event(payload)
        if ev0 is not None:
            side.wait_event(ev0)
        elif payload.device.type == "cuda":
            side.wait_stream(torch.cuda.current_stream(payload.device))
        with torch.cuda.stream(side):
            moved = payload.to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        if payload.device.type == "cuda":
            payload.record_stream(side)
        moved._pt_ready = ev
        return moved

    def send_am(self, tag: int, dst: int, header, payload=None) -> None:
        if isinstance(payload, torch.Tensor):
            if payload.device in self._devices:
                target = self.device_map[dst]
                if target is not None and payload.device != target:
                    payload = self.relocate(payload, target)
                counters.add(CTR_D2D_MSGS)
                counters.add(CTR_D2D_BYTES, int(payload.nbytes))
            else:
                counters.add(CTR_HOST_MSGS)
        super().send_am(tag, dst, header, payload)


def default_device_map(nb_ranks: int) -> List[torch.device]:
    """rank -> this host's card, round robin (the launcher's binding rule:
    rank i drives card i mod the card count). Raises without a card: a CPU
    world passes its ``device_map`` itself."""
    if not torch.cuda.is_available():
        raise RuntimeError("the d2d plane's default device map needs a CUDA "
                           "card; pass device_map for another placement")
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(nb_ranks)]


def make_d2d_engines(nb_ranks: int,
                     device_map: Optional[Sequence] = None) -> List[D2DCE]:
    """One fabric and one D2DCE per rank (the in-process world)."""
    if device_map is None:
        device_map = default_device_map(nb_ranks)
    fabric = ThreadFabric(nb_ranks)
    return [D2DCE(fabric, r, device_map) for r in range(nb_ranks)]
