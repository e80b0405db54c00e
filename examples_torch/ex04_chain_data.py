"""Ex04: chain with per-step data from memory (reference analogue
examples/Ex04_ChainData.jdf). Each T(k) reads its own tile A(k) and
accumulates into the flowing X.

Run: ``python examples_torch/ex04_chain_data.py [--cpu]``.
"""
from _common import device

SRC = """
%global NT
%global A
%global S

T(k)
  k = 0 .. NT-1
  : A(k, 0)
  READ D <- A(k, 0)
  RW   X <- (k == 0) ? S(0, 0) : X T(k-1)
       -> (k < NT-1) ? X T(k+1) : S(0, 0)
BODY
  X = X + D
END
"""


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    NT = 8
    ctx = ptt.init(nb_cores=1, device=device())
    A = ptt.TiledMatrix("A", 4 * NT, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), float(m), np.float32))
    S = ptt.TiledMatrix("S", 4, 4, 4, 4)
    S.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = compile_ptg(SRC, "chaindata").instantiate(
        ctx, globals={"NT": NT}, collections={"A": A, "S": S})
    ctx.add_taskpool(tp)
    ctx.wait()
    got = S.to_dense()[0, 0]
    print("ex04 sum of 0..7 (expect 28):", got)
    ptt.fini()
    assert got == 28.0


if __name__ == "__main__":
    main()
