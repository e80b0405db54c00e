"""Rank-side bodies of ``tests/test_torch_capture_mesh.py``: each runs on
every rank of a CPU :class:`RankPool`, on the rank's own single-rank
context, over the 2 x 4 mesh ``("x", "y")`` of the group, and returns numpy
values and plain data for the test to hold against the reference. This
module imports neither JAX nor the reference package."""

import numpy as np
import torch
import torch.distributed as dist

import parsec_tpu_torch as ptt
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks
from parsec_tpu_torch.parallel import compat
from parsec_tpu_torch.parallel.multihost import device_mesh

CPU = "cpu"


def _mesh():
    return device_mesh((2, 4), ("x", "y"), CPU)


def _matrix(name, dense, ts):
    M = TwoDimBlockCyclic(name, dense.shape[0], dense.shape[1], ts, ts,
                          P=1, Q=1)
    M.fill(lambda m, k: dense[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
    return M


def gemm(n, ts, a, b, windows=1, name="mg"):
    """The batch_k GEMM captured and run over the mesh ``windows`` times
    into one C (zero at the start): C, each window's ``cache_hit``, the
    last window's plan, this rank's ``compat.STATS`` over the last window,
    the ops a window records and the executions."""
    mesh = _mesh()
    ctx = ptt.Context(nb_cores=1, device=CPU)
    try:
        A, B = _matrix(name + "A", a, ts), _matrix(name + "B", b, ts)
        C = _matrix(name + "C", np.zeros((n, n), np.float32), ts)
        tp = DTDTaskpool(ctx, name, capture=True)
        hits = []
        for _ in range(windows):
            nops = insert_gemm_tasks(tp, A, B, C, batch_k=True)
            compat.reset_stats()
            tp.wait_mesh(mesh)
            hits.append(tp._capture.cache_hit)
        out = {"C": C.to_dense(), "hits": hits,
               "plan": tp._capture.mesh_plan(),
               "stats": compat.stats_summary(), "nops": nops,
               "executions": tp._capture.executions, "rank": dist.get_rank()}
        tp.close()
        ctx.wait(timeout=30)
        return out
    finally:
        ctx.fini(timeout=30)


def potrf(n, ts, spd):
    """POTRF captured over the mesh; rank 0 also captures it on its one
    device (``capture=True``, no mesh) from the same matrix."""
    mesh = _mesh()
    ctx = ptt.Context(nb_cores=1, device=CPU)
    try:
        out = {}
        if dist.get_rank() == 0:
            P1 = _matrix("mp1", spd, ts)
            cap1 = DTDTaskpool(ctx, "mp-single", capture=True)
            insert_potrf_tasks(cap1, P1)
            cap1.wait()
            cap1.close()
            out["single"] = P1.to_dense()
        P2 = _matrix("mp2", spd, ts)
        cap2 = DTDTaskpool(ctx, "mp-mesh", capture=True)
        insert_potrf_tasks(cap2, P2)
        cap2.wait_mesh(mesh)
        cap2.close()
        ctx.wait(timeout=30)
        out["mesh"] = P2.to_dense()
        return out
    finally:
        ctx.fini(timeout=30)


def scratch_and_guards():
    """A scratch tile rides replicated (every rank runs its op); a
    collection that the mesh does not divide is refused, and the refused
    batch is discarded."""
    mesh = _mesh()
    ctx = ptt.Context(nb_cores=1, device=CPU)
    try:
        cap = DTDTaskpool(ctx, "mesh-scratch", capture=True)
        t = cap.tile_new((8, 8))
        t.data.create_copy(0, torch.ones(8, 8))
        cap.insert_task(lambda x: x * 3.0, (t, RW))
        cap.wait_mesh(mesh)
        cap.close()
        ctx.wait(timeout=30)
        plan = cap._capture.mesh_plan()
        out = {"scratch": t.data.newest_copy().payload.numpy(),
               "scratch_ops": {r: len(v) for r, v in plan["ops"].items()},
               "scratch_transfers": len(plan["transfers"])}
        bad = TwoDimBlockCyclic("meshbad", 10, 10, 5, 5, P=1, Q=1)
        bad.fill(lambda m, n: np.zeros((5, 5), np.float32))
        cap2 = DTDTaskpool(ctx, "mesh-bad", capture=True)
        try:
            cap2.insert_task(lambda x: x + 1.0, (cap2.tile_of(bad, 0, 0), RW))
            try:
                cap2.wait_mesh(mesh)
                out["refused"] = None
            except RuntimeError as e:
                out["refused"] = str(e)
            out["ops_left"] = len(cap2._capture.ops)
        finally:
            cap2.close()
        ctx.wait(timeout=30)
        out["executions"] = cap2._capture.executions
        out["bad"] = np.asarray(bad.data_of(0, 0).newest_copy().payload)
        return out
    finally:
        ctx.fini(timeout=30)


def cuda_gemm(n, ts, a, b):
    """On CUDA ranks (every one on the card, each its own card context):
    the bf16 batch_k GEMM window over the mesh, C's digest, the rank's
    chain launches and ops, ``compat.STATS``; rank 0 also runs the same
    window captured inline on the card alone and returns its C's digest."""
    import hashlib

    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.ops import cuda_kernels as K

    def digest(M):
        parts = [torch.as_tensor(M.data_of(m, k).newest_copy().payload)
                 .cpu().contiguous().view(torch.uint8).numpy().tobytes()
                 for m in range(M.mt) for k in range(M.nt)]
        return hashlib.sha256(b"".join(parts)).hexdigest()

    def gemm_collections(prefix):
        return [collection_from_numpy(prefix + s, v, ts, ts,
                                      dtype=torch.bfloat16)
                for s, v in (("A", a), ("B", b),
                             ("C", np.zeros((n, n), np.float32)))]

    ptt.mca.set("device_cuda_max_bytes", 1 << 30)
    ptt.mca.set("device_load_balance_allow_cpu", False)
    mesh = device_mesh((2, 4), ("x", "y"), "cuda")
    ctx = ptt.Context(nb_cores=1)
    try:
        A, B, C = gemm_collections("cm")
        tp = DTDTaskpool(ctx, "cuda-mesh-gemm", capture=True)
        insert_gemm_tasks(tp, A, B, C, batch_k=True)
        compat.reset_stats()
        l0 = K.gemm_chain.launches
        tp.wait_mesh(mesh)
        torch.cuda.synchronize()
        out = {"launches": K.gemm_chain.launches - l0,
               "ops": len(tp._capture.mesh_plan()["ops"][dist.get_rank()]),
               "stats": compat.stats_summary(), "C": digest(C)}
        tp.close()
        if dist.get_rank() == 0:
            A1, B1, C1 = gemm_collections("ci")
            tp1 = DTDTaskpool(ctx, "cuda-inline-gemm", capture="inline")
            insert_gemm_tasks(tp1, A1, B1, C1, batch_k=True)
            tp1.wait()
            tp1.close()
            out["inline"] = digest(C1)
        ctx.wait(timeout=60)
        return out
    finally:
        ctx.fini(timeout=60)
        ptt.mca.params.unset("device_cuda_max_bytes")
        ptt.mca.params.unset("device_load_balance_allow_cpu")
