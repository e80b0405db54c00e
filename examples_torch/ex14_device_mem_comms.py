"""Ex14: cross-process device payloads — run with

    python -m parsec_tpu_torch.launch -n 2 [--cpu] --mca comm_device_mem 1 \\
        examples_torch/ex14_device_mem_comms.py

With ``comm_device_mem`` on (the reference's
``parsec_mpi_allow_gpu_memory_communications`` gate,
parsec/parsec_internal.h:504), a tensor crossing OS ranks never enters the
host wire frame: the producer offers it on its xhost plane
(``comm/xhost.py``: a CUDA IPC handle on the card, a named shared-memory
segment on the CPU) and ships only a pull descriptor; the consumer copies
it into a tensor of its own, and the transport-level ACK retires the
producer's pin. Counters tell the story: ``comm.xhost_d2d_msgs`` moves,
``comm.host_materialized_msgs`` stays zero.

Each rank computes a tile, sends it to its neighbor, and checks what
arrived (on its card, on the card) with zero host materializations.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def main():
    import torch

    from parsec_tpu_torch.comm.engine import TAG_DSL_BASE
    from parsec_tpu_torch.comm.tcp import init_from_env
    from parsec_tpu_torch.comm.xhost import local_device
    from parsec_tpu_torch.utils.counters import counters

    dev = local_device() if device() == "cuda" else torch.device("cpu")
    ce = init_from_env()
    got = []
    ce.tag_register(TAG_DSL_BASE, lambda _c, src, hdr, pl: got.append(pl))
    ce.sync()

    # a computed payload: on the card a CUDA tensor, never fetched
    payload = torch.linalg.cholesky(
        torch.eye(64, device=dev) * (4.0 + ce.my_rank)) * (ce.my_rank + 1)
    dst = (ce.my_rank + 1) % ce.nb_ranks
    if ce._xhost is not None and dev.type == "cpu":
        # a CPU tensor rides the wire as bytes unless it is offered on the
        # plane explicitly (the CPU rehearsal of the device path)
        ce.send_am(TAG_DSL_BASE, dst, {"from": ce.my_rank},
                   ce._xhost.offer(payload, dst=dst))
    else:
        ce.send_am(TAG_DSL_BASE, dst, {"from": ce.my_rank}, payload)
    deadline = time.time() + 30
    while (not got or (ce._xhost is not None and ce._xhost.pending())) \
            and time.time() < deadline:
        ce.progress()
        time.sleep(0.001)

    peer = (ce.my_rank - 1) % ce.nb_ranks
    assert got, "no payload arrived"
    arrived = got[0]
    expect = float((4.0 + peer) ** 0.5 * (peer + 1))
    assert abs(float(arrived.cpu()[0, 0]) - expect) < 1e-5
    d2d = int(counters.read("comm.xhost_d2d_msgs"))
    bounced = int(counters.read("comm.host_materialized_msgs"))
    print(f"rank {ce.my_rank}: got peer {peer}'s tile on {arrived.device} "
          f"(xhost_d2d={d2d}, host_bounces={bounced})", flush=True)
    if os.environ.get("PARSEC_MCA_comm_device_mem") == "1":
        assert arrived.device.type == dev.type and d2d == 1 and bounced == 0
    ce.sync()
    ce.fini()


if __name__ == "__main__":
    main()
