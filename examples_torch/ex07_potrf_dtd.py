"""Ex07: tiled Cholesky through the dynamic interface (DTD).

(Reference analogue: the dpotrf test of PaRSEC's DTD interface)
Run: ``python examples_torch/ex07_potrf_dtd.py [--cpu]``.
"""
from _common import device


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import TiledMatrix
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd

    n, ts = 256, 64
    spd = make_spd(n, seed=1)
    ctx = ptt.init(nb_cores=1, device=device())
    A = TiledMatrix("A", n, n, ts, ts)
    A.fill(lambda m, k: spd[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    tp = DTDTaskpool(ctx, "potrf")
    ntasks = insert_potrf_tasks(tp, A)
    tp.wait(); tp.close(); ctx.wait()
    L = np.tril(A.to_dense().astype(np.float64))
    err = float(np.abs(L @ L.T - spd).max())
    print(f"ex07 DTD POTRF: {ntasks} tasks, max err |L L^T - A| {err:.2e} "
          f"(expect < 1e-2)")
    ptt.fini()
    assert err < 1e-2


if __name__ == "__main__":
    main()
