"""Ex09: real multi-process launch — run with

    python -m parsec_tpu_torch.launch -n 2 [--cpu] examples_torch/ex09_tcp_launch.py

Each process joins the TCP mesh (init_from_env = the MPI_Init moment),
builds its rank's slice of a block-cyclic matrix, and runs a distributed
DTD Cholesky with cross-process activate/put dataflow — the program Ex07
runs on one rank, now with a real process boundary (ref workflow: mpiexec
-n N over parsec_mpi_funnelled). On the card every rank drives it with a
tile budget of its own.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def main():
    import numpy as np

    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.tcp import init_from_env
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
    from parsec_tpu_torch.utils import mca

    dev = device()
    if dev == "cuda":
        mca.set("device_cuda_max_bytes", 1 << 28)
    ce = init_from_env()
    ctx = Context(nb_cores=1, device=dev, my_rank=ce.my_rank,
                  nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)

    n, ts = 64, 16
    spd = make_spd(n, seed=7)
    A = TwoDimBlockCyclic("A", n, n, ts, ts, P=ce.nb_ranks, Q=1,
                          nodes=ce.nb_ranks, myrank=ce.my_rank)
    A.fill(lambda m, k: spd[m*ts:(m+1)*ts, k*ts:(k+1)*ts])

    tp = DTDTaskpool(ctx, "ex09-potrf")
    insert_potrf_tasks(tp, A)
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=120)
    ctx.fini()

    # every rank checks its own tiles against a reference factor
    L = np.tril(np.linalg.cholesky(spd.astype(np.float64)))
    err = max((float(np.abs(
        A.data_of(m, k).newest_copy().payload.double().cpu().numpy()
        - L[m*ts:(m+1)*ts, k*ts:(k+1)*ts]).max())
        for m in range(n//ts) for k in range(n//ts)
        if A.rank_of(m, k) == ce.my_rank and m >= k), default=0.0)
    print(f"[rank {ce.my_rank}/{ce.nb_ranks}] ex09 distributed POTRF "
          f"max err {err:.2e}")
    ce.sync()
    ce.fini()
    assert err < 1e-2


if __name__ == "__main__":
    main()
