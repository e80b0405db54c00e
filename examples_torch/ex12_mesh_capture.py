"""Ex12: a taskpool over a rank mesh — mesh capture and the data bridge.

Eight ranks join one gloo group (a ``RankPool``: on the card every rank
runs on it, time-sharing it) and each holds the same collections on its own
single-rank context:

1. A tiled GEMM taskpool is captured and run over a 2x4 mesh of the ranks
   (``tp.wait_mesh``): each rank runs the tasks whose C tile it owns, reads
   the tiles it does not own as transfers from their owners, and every
   rank ends with the whole C.
2. The result hands off to the SPMD world through the mesh data bridge
   (``to_global`` / ``from_global``) for a sharded post-step, then back to
   a regular taskpool — both worlds on the same matrices.

    python examples_torch/ex12_mesh_capture.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def mesh_capture(dev):
    """Every rank runs this; rank 0 returns the report."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data.mesh_bridge import from_global, to_global
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.parallel import compat
    from parsec_tpu_torch.parallel.multihost import device_mesh

    mesh = device_mesh((2, 4), ("x", "y"), dev)
    lines = [f"mesh: {tuple(mesh.shape)} over {dist.get_world_size()} ranks "
             f"on {dev}"]

    n, ts = 64, 16
    rng = np.random.default_rng(7)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)

    if dev == "cuda":
        ptt.mca.set("device_cuda_max_bytes", 1 << 28)
    ctx = ptt.Context(nb_cores=1) if dev == "cuda" else \
        ptt.Context(nb_cores=1, device="cpu")
    A = TwoDimBlockCyclic("A", n, n, ts, ts)
    B = TwoDimBlockCyclic("B", n, n, ts, ts)
    C = TwoDimBlockCyclic("C", n, n, ts, ts)
    A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    C.fill(lambda m, k: np.zeros((ts, ts), np.float32))

    # 1. the whole DAG as one owner-computes program over the mesh
    tp = DTDTaskpool(ctx, "mesh-gemm", capture=True)
    insert_gemm_tasks(tp, A, B, C, batch_k=True)
    tp.wait_mesh(mesh)
    plan = tp._capture.mesh_plan()
    tp.close()
    err = float(np.abs(C.to_dense() - a @ b).max())
    lines.append(f"mesh-captured GEMM ({tp.inserted} tasks, "
                 f"{len(plan['ops'][dist.get_rank()])} on rank 0, "
                 f"{len(plan['transfers'])} tile transfers): max err "
                 f"{err:.2e}")

    # 2. hand the result to the SPMD world and back: the post-step needs
    # other ranks' blocks (the transpose), so it gathers, then keeps its own
    g = to_global(C, mesh)
    spec = compat.P("x", "y")
    full = compat.full_tensor(g)
    sym = 0.5 * (full + full.T)
    from_global(C, compat.from_local(
        compat.local_slice(sym, mesh, spec).contiguous(), mesh, spec))

    tp2 = DTDTaskpool(ctx, "post")
    for m in range(C.mt):
        tp2.insert_task(lambda x: x * 2.0, (tp2.tile_of(C, m, m), RW))
    tp2.wait()
    tp2.close()
    ctx.wait()
    ref = 0.5 * (a @ b + (a @ b).T)
    for m in range(C.mt):
        ref[m*ts:(m+1)*ts, m*ts:(m+1)*ts] *= 2.0
    err2 = float(np.abs(C.to_dense() - ref).max())
    lines.append(f"SPMD handoff + second taskpool: max err {err2:.2e}")
    ctx.fini()
    assert err < 1e-3 and err2 < 1e-3
    return lines if dist.get_rank() == 0 else None


def main():
    from parsec_tpu_torch.parallel.multihost import RankPool
    dev = device()
    with RankPool(8, dev, timeout=300) as pool:
        for line in pool.run(mesh_capture, dev)[0]:
            print(line)
    print("ex12 OK: the mesh-captured GEMM and the SPMD handoff each match "
          "numpy")


if __name__ == "__main__":
    main()
