"""Ex06: tiled GEMM as a PTG with a device body (``BODY [type=CUDA]``: on
the card its products run on the CUDA device module's stream; on a CPU
context its CPU twin runs them on the host).

Run: ``python examples_torch/ex06_gemm_ptg.py [--cpu]``.
"""
from _common import device

SRC = """
%global MT
%global NT
%global KT
%global descA
%global descB
%global descC

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : descC(m, n)
  priority = KT - k
  READ A <- descA(m, k)
  READ B <- descB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY [type=CUDA]
  C = C + torch.matmul(A, B)
END
"""


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    MT = NT = KT = 4
    TS = 64
    rng = np.random.default_rng(0)
    a = rng.standard_normal((MT*TS, KT*TS)).astype(np.float32)
    b = rng.standard_normal((KT*TS, NT*TS)).astype(np.float32)
    ctx = ptt.init(nb_cores=1, device=device())
    A = ptt.TiledMatrix("A", MT*TS, KT*TS, TS, TS)
    B = ptt.TiledMatrix("B", KT*TS, NT*TS, TS, TS)
    C = ptt.TiledMatrix("C", MT*TS, NT*TS, TS, TS)
    A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
    B.fill(lambda k, n: b[k*TS:(k+1)*TS, n*TS:(n+1)*TS])
    C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
    tp = compile_ptg(SRC, "gemm").instantiate(
        ctx, globals={"MT": MT, "NT": NT, "KT": KT},
        collections={"descA": A, "descB": B, "descC": C})
    ctx.add_taskpool(tp)
    ctx.wait()
    err = np.abs(C.to_dense() - a @ b).max()
    print("ex06 PTG GEMM max err:", err)
    ptt.fini()
    assert err < 1e-3


if __name__ == "__main__":
    main()
