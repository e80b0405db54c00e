"""Ex08: distributed PTG GEMM — owner-computes placement, panel-broadcast
READ tasks, cross-rank dataflow over multicast trees, fourcounter
termination: the DPLASMA idiom on in-process ranks.

    python ex08_distributed_gemm_ptg.py [--cpu]
"""
from _common import device

SRC = """
%global MT
%global NT
%global KT
%global descA
%global descB
%global descC

RA(m, k)
  m = 0 .. MT-1
  k = 0 .. KT-1
  : descA(m, k)
  READ A <- descA(m, k)
       -> A GEMM(m, 0 .. NT-1, k)
BODY
  A = A
END

RB(k, n)
  k = 0 .. KT-1
  n = 0 .. NT-1
  : descB(k, n)
  READ B <- descB(k, n)
       -> B GEMM(0 .. MT-1, n, k)
BODY
  B = B
END

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : descC(m, n)
  priority = KT - k
  READ A <- A RA(m, k)
  READ B <- B RB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY [type=CUDA]
  C = C + torch.matmul(A, B)
END
"""


def main():
    import numpy as np
    import torch

    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.utils import mca

    NB_RANKS, MT, TS = 4, 4, 16
    dev = device()
    if dev == "cuda":
        mca.set("device_cuda_max_bytes", 1 << 28)   # a budget each rank
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    a = rng.standard_normal((MT*TS, MT*TS)).astype(np.float32)
    b = rng.standard_normal((MT*TS, MT*TS)).astype(np.float32)
    prog = compile_ptg(SRC, "ex08")

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device=dev, my_rank=rank,
                      nb_ranks=NB_RANKS)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        kw = dict(nodes=NB_RANKS, myrank=rank, P=2, Q=2)
        A = TwoDimBlockCyclic("eA", MT*TS, MT*TS, TS, TS, **kw)
        B = TwoDimBlockCyclic("eB", MT*TS, MT*TS, TS, TS, **kw)
        C = TwoDimBlockCyclic("eC", MT*TS, MT*TS, TS, TS, **kw)
        A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
        B.fill(lambda k, n: b[k*TS:(k+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = prog.instantiate(ctx, globals={"MT": MT, "NT": MT, "KT": MT},
                              collections={"descA": A, "descB": B,
                                           "descC": C},
                              name="ex08")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        ctx.fini()
        return max((float(np.abs(
            C.data_of(m, n).newest_copy().payload.cpu().numpy()
            - (a @ b)[m*TS:(m+1)*TS, n*TS:(n+1)*TS]).max())
            for m in range(MT) for n in range(MT)
            if C.rank_of(m, n) == rank), default=0.0)

    errs = run_distributed(NB_RANKS, program, timeout=180)
    print(f"ex08 distributed PTG GEMM on {NB_RANKS} ranks: "
          f"max err {max(errs):.2e}")
    assert max(errs) < 1e-3


if __name__ == "__main__":
    main()
