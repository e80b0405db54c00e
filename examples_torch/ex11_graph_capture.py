"""Ex11: whole-DAG graph capture — one program per taskpool.

The same tiled Cholesky as Ex07, but the taskpool is CAPTURED: the
insert_task sequence records instead of scheduling, and wait() runs the
whole DAG as one program (``dsl/capture.py``): on a card a CUDA graph,
captured at the first execution of the DAG's shape; on the CPU an eager
replay. Running the same DAG shape again reuses the cached program (watch
the second run's time and its cache hit).

Run: ``python examples_torch/ex11_graph_capture.py [--cpu]``.
"""
import time

from _common import device


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd

    n, ts = 256, 64
    spd = make_spd(n, seed=4)
    ctx = ptt.Context(nb_cores=1, device=device())
    A = TwoDimBlockCyclic("A", n, n, ts, ts, P=1, Q=1)

    def factorize() -> bool:
        A.fill(lambda m, k: spd[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        tp = DTDTaskpool(ctx, "potrf-cap", capture=True)
        t0 = time.perf_counter()
        insert_potrf_tasks(tp, A)
        tp.wait()           # capture (first time) + run as ONE program
        tp.close()
        dt = time.perf_counter() - t0
        hit = tp._capture.cache_hit
        print(f"  {tp.inserted} tasks as one program: {dt*1e3:.1f} ms "
              f"(cache {'hit' if hit else 'miss'})")
        return hit

    print("first run (captures the whole DAG):")
    factorize()
    print("second run (the program is cached):")
    hit = factorize()
    ctx.wait()

    L = np.tril(A.to_dense().astype(np.float64))
    err = float(np.abs(L @ L.T - spd).max())
    print(f"ex11 max err ||L L^T - A||_max = {err:.2e} (expect < 1e-2)")
    ctx.fini()
    assert err < 1e-2 and hit


if __name__ == "__main__":
    main()
