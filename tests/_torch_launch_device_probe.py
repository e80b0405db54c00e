"""Child script of the launcher test (``test_torch_tcp_distributed.py``):
joins the TCP mesh, reports the device it is bound to, runs a tiny DTD GEMM
through the CUDA device module (over the CPU under ``--cpu``), then
moves a tensor to its peer through the xhost plane (CUDA IPC on a card, a
named shared-memory segment on the CPU). Started as

    python -m parsec_tpu_torch.launch -n 2 [--cpu] --virtual-devices 2 \
        tests/_torch_launch_device_probe.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import numpy as np
    import torch

    from parsec_tpu_torch.comm.engine import CAP_ACCELERATOR_MEM, TAG_DSL_BASE
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.tcp import init_from_env
    from parsec_tpu_torch.comm.xhost import (ENV_LOCAL_DEVICE, XHostTransfer,
                                             local_device)
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.device.probe import ENV_FORCE_CPU
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.utils import mca
    from parsec_tpu_torch.utils.counters import counters

    card = os.environ.get(ENV_FORCE_CPU) != "1"
    mca.set("device_load_balance_allow_cpu", False)
    if card:
        mca.set("device_cuda_max_bytes", 1 << 28)
    ce = init_from_env()
    ctx = Context(nb_cores=1, device=local_device() if card else "cpu",
                  my_rank=ce.my_rank, nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    devs = [d for d in ctx.devices.devices if isinstance(d, CUDADevice)]

    n, ts = 32, 16
    rng = np.random.default_rng(2)
    a = rng.standard_normal((n, n)).astype(np.float32)
    kw = dict(nodes=ce.nb_ranks, myrank=ce.my_rank, P=ce.nb_ranks, Q=1)
    A = TwoDimBlockCyclic("A", n, n, ts, ts, **kw)
    B = TwoDimBlockCyclic("B", n, n, ts, ts, **kw)
    C = TwoDimBlockCyclic("C", n, n, ts, ts, **kw)
    A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    B.fill(lambda m, k: np.eye(ts, dtype=np.float32) if m == k
           else np.zeros((ts, ts), np.float32))
    C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
    tp = DTDTaskpool(ctx, "probe-gemm")
    insert_gemm_tasks(tp, A, B, C)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()

    err = max((float(np.abs(
        C.data_of(m, k).newest_copy().payload.float().cpu().numpy()
        - a[m*ts:(m+1)*ts, k*ts:(k+1)*ts]).max())
        for m in range(n//ts) for k in range(n//ts)
        if C.rank_of(m, k) == ce.my_rank), default=0.0)
    executed = sum(d.executed_tasks for d in devs)

    # the xhost leg: a tensor crosses the OS ranks as a pull descriptor in
    # the AM frame, its bytes pulled by the peer, the pin retired by the
    # transport ACK
    xgot = []
    ce.tag_register(TAG_DSL_BASE, lambda _c, src, hdr, pl: xgot.append(pl))
    ce.sync()
    ce._xhost = ce._xpull = XHostTransfer()
    ce.capabilities |= CAP_ACCELERATOR_MEM
    peer_dst = (ce.my_rank + 1) % ce.nb_ranks
    value = torch.full((8, 8), float(ce.my_rank + 1))
    if card:
        # a CUDA tensor takes the IPC plane inside send_am
        ce.send_am(TAG_DSL_BASE, peer_dst, {}, value.to(local_device()))
    else:
        ce.send_am(TAG_DSL_BASE, peer_dst, {},
                   ce._xhost.offer(value, dst=peer_dst))
    t0 = time.time()
    while (not xgot or ce._xhost.pending()) and time.time() - t0 < 30:
        ce.progress()
        time.sleep(0.001)
    peer = (ce.my_rank - 1) % ce.nb_ranks
    assert xgot and isinstance(xgot[0], torch.Tensor), xgot
    assert float(xgot[0].float().cpu()[0, 0]) == float(peer + 1)
    assert ce._xhost.pending() == 0          # ACK retired the pin
    xd2d = int(counters.read("comm.xhost_d2d_msgs"))

    bound = int(os.environ.get(ENV_LOCAL_DEVICE, "0"))
    print(f"PROBE rank={ce.my_rank} devices={[bound for _ in devs]} "
          f"executed={executed} err={err:.2e} xhost_d2d={xd2d}", flush=True)
    ce.sync()
    ce.fini()
    assert err < 1e-3
    assert len(devs) == 1 and executed > 0
    assert xd2d == 1


if __name__ == "__main__":
    main()
