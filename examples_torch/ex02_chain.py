"""Ex02: a PTG chain — tasks ordered purely by dataflow.

(Reference analogue: examples/Ex02_Chain.c + chain.jdf)
Run: ``python examples_torch/ex02_chain.py [--cpu]``.
"""
from _common import device

SRC = """
%global NT
%global A

T(k)
  k = 0 .. NT-1
  : A(0, 0)
  RW X <- (k == 0) ? A(0, 0) : X T(k-1)
     -> (k < NT-1) ? X T(k+1) : A(0, 0)
BODY
  X = X + 1.0
END
"""


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    ctx = ptt.init(nb_cores=1, device=device())
    A = ptt.TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = compile_ptg(SRC, "chain").instantiate(
        ctx, globals={"NT": 20}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    got = A.to_dense()[0, 0]
    print("ex02 chain result (expect 20):", got)
    ptt.fini()
    assert got == 20.0


if __name__ == "__main__":
    main()
