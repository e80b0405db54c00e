"""Ex05: range broadcast + CTL gather (fork/join in PTG).

(Reference analogue: examples/Ex05_Broadcast.c — one datum multicast to W
workers.) Run: ``python examples_torch/ex05_broadcast.py [--cpu]``.
"""
from _common import device

SRC = """
%global W
%global A

ROOT(z)
  z = 0 .. 0
  : A(0, 0)
  RW X <- A(0, 0)
     -> Y WORK(0 .. W-1)
BODY
  X = X * 1.0
END

WORK(i)
  i = 0 .. W-1
  : A(0, 0)
  RW Y <- X ROOT(0)
     -> (i == 0) ? Y SINK(0)
  CTL c -> (i > 0) ? c SINK(0)
BODY
  Y = Y + i
END

SINK(z)
  z = 0 .. 0
  : A(0, 0)
  RW Y <- Y WORK(0)
     -> A(0, 0)
  CTL c <- c WORK(1 .. W-1)
BODY
  Y = Y
END
"""


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    ctx = ptt.init(nb_cores=1, device=device())
    A = ptt.TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), 3.0, np.float32))
    tp = compile_ptg(SRC, "bcast").instantiate(
        ctx, globals={"W": 6}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    got = A.to_dense()[0, 0]
    print("ex05 broadcast/join (expect 3):", got)
    ptt.fini()
    assert got == 3.0


if __name__ == "__main__":
    main()
