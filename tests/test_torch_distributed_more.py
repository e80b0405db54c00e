"""The distributed cases of the port's other modules, over the in-process
multi-rank fabric: the reference's 2- and 4-rank tests of the apps (the
stencils in 1D, 2D and 3D, the generalized reduction, ``posv``), the PTG
frontend (NULL forwarding, write_check, the control gather, the remote
reshape scenarios s11–s13 and s15), the random-DAG fuzzer, checkpointing,
the collection variants, redistribution, multi-worker ranks, owner-computes
placement, and the native DTD lanes (off when distributed; the replay
auditor's digest), each on the port with the reference's sizes and
tolerances.
"""

import numpy as np
import pytest
import torch

import parsec_tpu_torch as pt
from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.task import HOOK_DONE
from parsec_tpu_torch.data.matrix import (SBCDistribution, TiledMatrix,
                                          TwoDimBlockCyclic)
from parsec_tpu_torch.data.ops import diag_band_to_rect
from parsec_tpu_torch.data.redistribute import redistribute
from parsec_tpu_torch.data.reshape import (NamedDatatype, lower_tile,
                                           upper_tile)
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW
from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import checkpoint
from parsec_tpu_torch.ops.stencil import (insert_stencil1d_tasks,
                                          reference_stencil1d)
from parsec_tpu_torch.utils import mca


def _mkctx(rank, fabric):
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank,
                  nb_ranks=fabric.nb_ranks)
    RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
    return ctx


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


# ------------------------------------------------------------------ apps
def test_stencil1d_distributed():
    """Halo exchange across ranks: boundary tile reads cross the fabric."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed

    NT, TS, ITERS = 4, 8, 3
    rng = np.random.default_rng(21)
    dense = rng.standard_normal((1, NT * TS)).astype(np.float32)

    def program(rank, fabric):
        c = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(c, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("SA", 1, NT * TS, 1, TS, P=1, Q=2,
                              nodes=2, myrank=rank)
        B = TwoDimBlockCyclic("SB", 1, NT * TS, 1, TS, P=1, Q=2,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: dense[:, n*TS:(n+1)*TS])
        B.fill(lambda m, n: np.zeros((1, TS), np.float32))
        tp = DTDTaskpool(c, "dstencil")
        insert_stencil1d_tasks(tp, A, B, ITERS)
        tp.wait(timeout=30); tp.close(); c.wait(timeout=30); c.fini()
        out = B if ITERS % 2 else A
        return {n: np.asarray(out.data_of(0, n).newest_copy().payload)
                for n in range(NT) if out.rank_of(0, n) == rank}

    results = run_distributed(2, program, timeout=120)
    ref = reference_stencil1d(dense, ITERS)
    for out in results:
        for n, tile in out.items():
            np.testing.assert_allclose(tile, ref[:, n*8:(n+1)*8],
                                       rtol=1e-4, atol=1e-4)


def test_stencil2d_distributed():
    """2D halo exchange across a 2x2 rank grid."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.ops.stencil import (insert_stencil2d_tasks,
                                        reference_stencil2d)

    MT, TS, ITERS = 4, 8, 3
    rng = np.random.default_rng(71)
    dense = rng.standard_normal((MT * TS, MT * TS)).astype(np.float32)

    def program(rank, fabric):
        c = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=4)
        RemoteDepEngine(c, ThreadsCE(fabric, rank))
        kw = dict(nodes=4, myrank=rank, P=2, Q=2)
        A = TwoDimBlockCyclic("D2A", MT*TS, MT*TS, TS, TS, **kw)
        B = TwoDimBlockCyclic("D2B", MT*TS, MT*TS, TS, TS, **kw)
        A.fill(lambda m, n: dense[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(c, "dst2d")
        insert_stencil2d_tasks(tp, A, B, ITERS)
        tp.wait(timeout=60); tp.close(); c.wait(timeout=60); c.fini()
        out = B if ITERS % 2 else A
        return {(m, n): np.asarray(out.data_of(m, n).newest_copy().payload)
                for m in range(MT) for n in range(MT)
                if out.rank_of(m, n) == rank}

    results = run_distributed(4, program, timeout=180)
    ref = reference_stencil2d(dense, ITERS)
    full = {}
    for o in results:
        full.update(o)
    assert len(full) == MT * MT
    for (m, n), tile in full.items():
        np.testing.assert_allclose(tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS],
                                   rtol=1e-4, atol=1e-4)


def test_stencil3d_distributed():
    """Z-slab halo exchange across 2 ranks: boundary planes become remote
    deps (tile_new is rank-local, so slabs ride a block-row collection)."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.ops.stencil import (insert_stencil3d_tasks,
                                        reference_stencil3d)

    NZ, SZ, N, ITERS = 4, 2, 8, 2
    rng = np.random.default_rng(78)
    dense = rng.standard_normal((NZ * SZ, N, N)).astype(np.float32)

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        # slabs as rows of a block-cyclic collection with 3D payloads
        from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
        A = TwoDimBlockCyclic("S3A", NZ * SZ, N, SZ, N, P=2, Q=1,
                              nodes=2, myrank=rank)
        B = TwoDimBlockCyclic("S3B", NZ * SZ, N, SZ, N, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda z, _n: dense[z*SZ:(z+1)*SZ])
        B.fill(lambda z, _n: np.zeros((SZ, N, N), np.float32))
        tp = DTDTaskpool(ctx, "st3dd")
        bricks_a = [tp.tile_of(A, z, 0) for z in range(NZ)]
        bricks_b = [tp.tile_of(B, z, 0) for z in range(NZ)]
        insert_stencil3d_tasks(tp, bricks_a, bricks_b, ITERS)
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30); ctx.fini()
        src = B if ITERS % 2 else A
        return {z: np.asarray(src.data_of(z, 0).newest_copy().payload)
                for z in range(NZ) if src.rank_of(z, 0) == rank}

    results = run_distributed(2, program, timeout=60)
    full = {}
    for r in results:
        full.update(r)
    out = np.concatenate([full[z] for z in range(NZ)], axis=0)
    np.testing.assert_allclose(out, reference_stencil3d(dense, ITERS),
                               rtol=1e-4, atol=1e-4)


def _genred_distributed(rank, fabric):
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.apps import generalized_reduction
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
    RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
    nt = 11             # 0b1011: trees of 1 + 2 + 8
    A = TwoDimBlockCyclic("GR", 4 * nt, 4, 4, 4, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: np.full((4, 4), float(m + 1), np.float32))
    tp = DTDTaskpool(ctx, "genred2")
    tiles = [tp.tile_of(A, m, 0) for m in range(nt)]
    root = generalized_reduction(tp, tiles)
    tp.wait(timeout=60); tp.close(); ctx.wait(timeout=60)
    out = None
    if root.rank == rank:
        out = float(np.asarray(root.data.newest_copy().payload)[0, 0])
    ctx.fini()
    return out


def test_generalized_reduction_distributed():
    """2-rank BT_reduction: tree edges cross ranks (row-cyclic tiles)."""
    from parsec_tpu_torch.comm.threads import run_distributed
    results = run_distributed(2, _genred_distributed, timeout=90)
    got = [r for r in results if r is not None]
    assert got and got[0] == sum(range(1, 12))   # 1+2+...+11 = 66


def test_posv_2rank():
    """Distributed dposv across 2 ranks through the remote-dep protocol."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops.potrf import insert_posv_tasks, make_spd

    n, ts, nrhs = 64, 16, 4
    spd = make_spd(n, seed=8)
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal((n, nrhs)).astype(np.float32)

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        kw = dict(nodes=2, myrank=rank)
        A = TwoDimBlockCyclic("pvA", n, n, ts, ts, P=2, Q=1, **kw)
        B = TwoDimBlockCyclic("pvB", n, nrhs, ts, nrhs, P=2, Q=1, **kw)
        A.fill(lambda m, k: spd[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        B.fill(lambda m, k: rhs[m*ts:(m+1)*ts, :])
        tp = DTDTaskpool(ctx, "posv2")
        insert_posv_tasks(tp, A, B)
        tp.wait(timeout=90)
        tp.close()
        ctx.wait(timeout=60)
        ctx.fini()
        return {m: np.asarray(B.data_of(m, 0).newest_copy().payload)
                for m in range(B.mt) if B.rank_of(m, 0) == rank}

    results = run_distributed(2, program, timeout=150)
    ref = np.linalg.solve(spd.astype(np.float64), rhs.astype(np.float64))
    seen = {}
    for out in results:
        seen.update(out)
    assert len(seen) == n // ts
    for m, x in seen.items():
        np.testing.assert_allclose(x.astype(np.float64),
                                   ref[m*ts:(m+1)*ts, :], rtol=0, atol=5e-3)


# ------------------------------------------------------------------ PTG
FORWARD_NULL_SRC = """
%global A
%global NB
Task(k)
  k = 0 .. NB
  : A(k, 0)
  {ACCESS} X <- (k == 0) ? NULL : X Task(k-1)
       -> (k < NB) ? X Task(k+1)
BODY
  pass
END
"""


WRITE_CHECK_SRC = """
%global A
%global NT
%global BLOCK

STARTUP(k)
  k = 0 .. NT
  : A(0, k)
  WRITE A1 -> A2 TASK1(k)
BODY
  A1 = (torch.arange(BLOCK * BLOCK, dtype=torch.float32) + k * BLOCK).reshape(BLOCK, BLOCK)
END

TASK1(k)
  k = 0 .. NT
  : A(0, k)
  WRITE A3 -> A1 TASK2(k)
  RW    A1 <- A(0, k)
           -> A2 TASK2(k)
  READ  A2 <- A1 STARTUP(k)
BODY
  A1 = A1 + 1.0
  A3 = A2
END

TASK2(k)
  k = 0 .. NT
  : A(0, k)
  READ A1 <- A3 TASK1(k)
  RW   A2 <- A1 TASK1(k)
          -> A(0, k)
BODY
  A2 = A2 + A1
END
"""


def _write_check_run(ctx, A, NT, BLOCK):
    prog = compile_ptg(WRITE_CHECK_SRC, "write_check")
    tp = prog.instantiate(ctx, globals={"NT": NT, "BLOCK": BLOCK},
                          collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    return tp


def test_forward_null_fatals_2rank():
    """The same NULL-forward abort fires on the source rank of a
    distributed chain (ref: forward_RW_NULL:mp)."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    NB = 3

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("Afn2", 16, 4, 4, 4, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.ones((4, 4), np.float32))
        prog = compile_ptg(FORWARD_NULL_SRC.replace("{ACCESS}", "RW"),
                           "fwdnull2")
        tp = prog.instantiate(ctx, globals={"NB": NB}, collections={"A": A})
        try:
            ctx.add_taskpool(tp)
            ctx.wait(timeout=10)
            return "completed"
        except Exception as e:  # noqa: BLE001 - the fatal (rank 0) or the
            # starvation timeout it causes downstream (rank 1)
            return f"{type(e).__name__}: {e}"
        finally:
            try:
                ctx.fini(timeout=5)
            except Exception:
                pass

    results = run_distributed(2, program, timeout=60)
    # rank 0 owns Task(0) (the NULL source): the fatal fires there
    assert "A NULL is forwarded" in results[0]


def test_write_check_2rank():
    """write_check across 2 ranks (ref: write_check:mp): the WRITE relay
    and RW chains cross the wire via the remote-dep protocol."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic

    NT, BLOCK = 3, 4

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("Awc2", BLOCK, (NT + 1) * BLOCK, BLOCK, BLOCK,
                              P=1, Q=2, nodes=2, myrank=rank)
        A.fill(lambda m, n: np.ones((BLOCK, BLOCK), np.float32))
        _write_check_run(ctx, A, NT, BLOCK)
        out = {}
        for k in range(NT + 1):
            if A.rank_of(0, k) == rank:
                out[k] = np.asarray(A.data_of(0, k).newest_copy().payload)
        ctx.fini()
        return out

    results = run_distributed(2, program, timeout=90)
    seen = {}
    for out in results:
        seen.update(out)
    assert len(seen) == NT + 1
    for k, got in seen.items():
        expect = (np.arange(BLOCK * BLOCK, dtype=np.float32) + k * BLOCK
                  ).reshape(BLOCK, BLOCK) + 2.0
        np.testing.assert_allclose(got, expect)


def test_control_gather_across_ranks():
    """CTL range gather: TC(0) collects a control from EVERY TA(k) and
    TB(k) across ranks before it may run (ctlgat.jdf). Execution counting
    rides per-execution evaluate probes (bodies are jitted: Python side
    effects in BODY fire once per trace, not per task)."""
    NT = 6
    src = """
%global NT
%global descA
%global probe_a
%global probe_b
%global probe_c

TA(k)
  k = 0 .. NT-1
  : descA(k, 0)
  CTL X -> X TC(0)
BODY [evaluate = probe_a]
  pass
END

TB(k)
  k = 0 .. NT-1
  : descA(k, 0)
  CTL X -> Y TC(0)
BODY [evaluate = probe_b]
  pass
END

TC(j)
  j = 0 .. 0
  : descA(0, 0)
  CTL X <- X TA(0 .. NT-1)
  CTL Y <- X TB(0 .. NT-1)
BODY [evaluate = probe_c]
  pass
END
"""
    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("descA", NT * 4, 4, 4, 4, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.zeros((4, 4), np.float32))
        order = []

        def probe(tag):
            def ev(stream, task):
                order.append(tag)
                return HOOK_DONE
            return ev

        tp = compile_ptg(src, "ctlgat").instantiate(
            ctx, globals={"NT": NT, "probe_a": probe("A"),
                          "probe_b": probe("B"), "probe_c": probe("C")},
            collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
        return order

    results = run_distributed(2, program, timeout=60)
    merged = results[0] + results[1]
    # every TA/TB ran exactly once somewhere; TC ran ONCE, on rank 0 (owner
    # of descA(0,0)), strictly after all 2*NT controls reached it
    assert merged.count("A") == NT and merged.count("B") == NT, merged
    assert results[0].count("C") == 1 and results[1].count("C") == 0
    assert results[0][-1] == "C"


# ------------------------------------------------------ remote reshapes
M, TS = 8, 4
def _counting(base: NamedDatatype):
    calls = {"extract": 0}

    def ex(a, _b=base):
        calls["extract"] += 1
        return _b.extract(a)

    return NamedDatatype(base.name, extract=ex, insert=base.insert), calls


_REMOTE_SRC = """
%global descA
%global descB

P(m)
  m = 0 .. 1
  : descA(m, 0)
  RW A <- descA(m, 0)
       -> A C(m)           [type = LOWER_TILE]
BODY
  A = A
END

C(m)
  m = 0 .. 1
  : descB(m, 0)
  RW B <- descB(m, 0)
       -> descB(m, 0)
  READ A <- A P(m)         [type = LOWER_TILE]
BODY
  B = B + A
END
"""


def _remote_program(dtt_factory):
    """2 ranks: producers own descA (rank 0), consumers own descB (rank 1)."""
    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("descA", M, TS, TS, TS, P=1, Q=1,
                              nodes=2, myrank=rank)       # all rank 0
        B = TwoDimBlockCyclic("descB", M, TS, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)
        # force descB tiles onto rank 1 (rows 0,1 -> ranks 0,1; row 1 only?)
        A.fill(lambda m, n: np.full((TS, TS), 1.0, np.float32))
        B.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        dtt, calls = dtt_factory()
        tp = compile_ptg(_REMOTE_SRC, "rrr").instantiate(
            ctx, collections={"descA": A, "descB": B},
            datatypes={"LOWER_TILE": dtt})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
        mine = {m: np.asarray(B.data_of(m, 0).newest_copy().payload)
                for m in range(2) if B.rank_of(m, 0) == rank}
        return mine, calls["extract"]
    return program


def test_s11_remote_presend_reshape_no_re_reshape():
    """Distributed: the payload is reshaped BEFORE the wire on the producer
    rank; the consumer (same [type]) does NOT re-reshape
    (remote_read_reshape.jdf + remote_no_re_reshape.jdf)."""
    results = run_distributed(2, _remote_program(
        lambda: _counting(lower_tile())), timeout=60)
    tiles = {}
    for mine, _ in results:
        tiles.update(mine)
    expect = np.tril(np.ones((TS, TS), np.float32))
    for m in range(2):
        np.testing.assert_array_equal(tiles[m], expect)
    # rank 0 (producer side) converts once per cross-rank tile; rank 1
    # (consumer side) must not convert at all for its remote input
    extracts = [c for _, c in results]
    assert extracts[0] >= 1
    # rank 1 owns descB(1,0); its consumer C(1) is remote-fed and must not
    # re-extract. C(0) runs on rank 0 (local path, may extract there).
    assert extracts[1] == 0, extracts


_MULTI_SRC = """
%global descA
%global descB
%global descC

P(m)
  m = 0 .. 0
  : descA(0, 0)
  RW A <- descA(0, 0)
       -> A CL(m)          [type = LOWER_TILE]
       -> A CU(m)          [type = UPPER_TILE]
BODY
  A = A
END

CL(m)
  m = 0 .. 0
  : descB(1, 0)
  RW B <- descB(1, 0)
       -> descB(1, 0)
  READ A <- A P(m)         [type = LOWER_TILE]
BODY
  B = B + A
END

CU(m)
  m = 0 .. 0
  : descC(1, 0)
  RW C <- descC(1, 0)
       -> descC(1, 0)
  READ A <- A P(m)         [type = UPPER_TILE]
BODY
  C = C + A
END
"""


def test_s12_s13_remote_multiple_outs_same_pred_flow():
    """One producer flow fans out to remote consumers under TWO different
    datatypes: each consumer receives its own shape, each type is packed/
    sent once (remote_multiple_outs_same_pred_flow*.jdf)."""
    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("descA", TS, TS, TS, TS, P=1, Q=1,
                              nodes=2, myrank=rank)       # rank 0
        B = TwoDimBlockCyclic("descB", M, TS, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)       # row 1 -> rank 1
        C = TwoDimBlockCyclic("descC", M, TS, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.full((TS, TS), 1.0, np.float32))
        B.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = compile_ptg(_MULTI_SRC, "multi").instantiate(
            ctx, collections={"descA": A, "descB": B, "descC": C},
            datatypes={"LOWER_TILE": lower_tile(),
                       "UPPER_TILE": upper_tile()})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
        if rank == 1:
            return (np.asarray(B.data_of(1, 0).newest_copy().payload),
                    np.asarray(C.data_of(1, 0).newest_copy().payload))
        return None

    results = run_distributed(2, program, timeout=60)
    lower_got, upper_got = results[1]
    np.testing.assert_array_equal(lower_got,
                                  np.tril(np.ones((TS, TS), np.float32)))
    np.testing.assert_array_equal(upper_got,
                                  np.triu(np.ones((TS, TS), np.float32)))


def test_s15_type_remote_applies_on_wire_only():
    """[type_remote]: the LOCAL successor keeps the full original copy
    while the REMOTE successor receives the wire-typed payload
    (local_no_reshape.jdf's type_remote semantics)."""
    src = """
%global descA
%global descB
%global descC

P(m)
  m = 0 .. 0
  : descA(0, 0)
  RW A <- descA(0, 0)
       -> A CL(m)            [type_remote = LOWER_TILE]
       -> A CR(m)            [type_remote = LOWER_TILE]
BODY
  A = A
END

CL(m)
  m = 0 .. 0
  : descB(0, 0)
  RW B <- descB(0, 0)
       -> descB(0, 0)
  READ A <- A P(m)
BODY
  B = B + A
END

CR(m)
  m = 0 .. 0
  : descC(1, 0)
  RW C <- descC(1, 0)
       -> descC(1, 0)
  READ A <- A P(m)
BODY
  C = C + A
END
"""
    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("descA", TS, TS, TS, TS, P=1, Q=1,
                              nodes=2, myrank=rank)       # rank 0
        B = TwoDimBlockCyclic("descB", TS, TS, TS, TS, P=1, Q=1,
                              nodes=2, myrank=rank)       # rank 0 (local)
        C = TwoDimBlockCyclic("descC", M, TS, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)       # row 1 -> rank 1
        A.fill(lambda m, n: np.full((TS, TS), 1.0, np.float32))
        B.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = compile_ptg(src, "trem").instantiate(
            ctx, collections={"descA": A, "descB": B, "descC": C},
            datatypes={"LOWER_TILE": lower_tile()})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ctx.fini()
        if rank == 0:
            return np.asarray(B.data_of(0, 0).newest_copy().payload)
        return np.asarray(C.data_of(1, 0).newest_copy().payload)

    results = run_distributed(2, program, timeout=60)
    # local successor saw the FULL tile; remote got the wire-typed payload
    np.testing.assert_array_equal(results[0], np.ones((TS, TS), np.float32))
    np.testing.assert_array_equal(results[1],
                                  np.tril(np.ones((TS, TS), np.float32)))


# ------------------------------------------------------- fuzzed DAGs
NT, NTASKS = 6, 60   # the fuzzer's tiles in play (TS = 4 above)
def _body1(w, c0, c1):
    return w * c0 + c1


def _body2(w, r1, c0, c1):
    return w * c0 + r1 + c1


def _body3(w, r1, r2, c0, c1):
    return w * c0 + r1 - r2 + c1


def _reader(r1, c0, c1):
    return None


_BODIES = {1: _body1, 2: _body2, 3: _body3}


def random_dag(seed: int):
    """[(kind, write_ix, read_ixs, c0, c1)] with deterministic constants."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(NTASKS):
        if rng.random() < 0.15:
            tasks.append(("read", None, [int(rng.integers(NT))],
                          0.0, 0.0))
            continue
        w = int(rng.integers(NT))
        n_reads = int(rng.integers(0, 3))
        reads = [int(v) for v in rng.choice(
            [i for i in range(NT) if i != w], size=n_reads, replace=False)]
        c0 = round(float(rng.uniform(0.5, 1.5)), 3)
        c1 = round(float(rng.uniform(-1.0, 1.0)), 3)
        tasks.append(("write", w, reads, c0, c1))
    return tasks


def numpy_replay(tasks, init):
    """Sequential ground truth: DTD semantics == insertion-order replay."""
    tiles = [init(i).copy() for i in range(NT)]
    for kind, w, reads, c0, c1 in tasks:
        if kind == "read":
            continue
        acc = tiles[w] * c0 + c1
        if len(reads) >= 1:
            acc = acc + tiles[reads[0]]
        if len(reads) >= 2:
            acc = acc - tiles[reads[1]]
        tiles[w] = acc
    return tiles


def _init(i):
    return np.full((TS, TS), float(i + 1), np.float32)


def _insert_all(tp, tiles, tasks):
    for kind, w, reads, c0, c1 in tasks:
        if kind == "read":
            tp.insert_task(_reader, (tiles[reads[0]], READ), c0, c1,
                           name="RD")
            continue
        args = [(tiles[w], RW)] + [(tiles[r], READ) for r in reads]
        tp.insert_task(_BODIES[1 + len(reads)], *args, c0, c1,
                       name=f"W{1 + len(reads)}")


@pytest.mark.parametrize("seed", [0, 3])
def test_fuzz_distributed_2rank(seed):
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.utils import mca

    tasks = random_dag(seed)
    ref = numpy_replay(tasks, _init)
    mca.set("dtd_audit", True)
    try:
        def program(rank, fabric):
            ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
            RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
            A = TwoDimBlockCyclic(f"Fd{seed}", NT * TS, TS, TS, TS,
                                  P=2, Q=1, nodes=2, myrank=rank)
            A.fill(lambda m, n: _init(m))
            tp = DTDTaskpool(ctx, f"fuzz-dist-{seed}")
            tiles = [tp.tile_of(A, i, 0) for i in range(NT)]
            _insert_all(tp, tiles, tasks)
            tp.wait(timeout=120)
            tp.close()
            ctx.wait(timeout=120)
            out = {i: np.asarray(A.data_of(i, 0).newest_copy().payload)
                   for i in range(NT) if A.rank_of(i, 0) == rank}
            ctx.fini()
            return out

        results = run_distributed(2, program, timeout=240)
        merged = {}
        for r in results:
            merged.update(r)
        assert sorted(merged) == list(range(NT))
        for i in range(NT):
            np.testing.assert_allclose(merged[i], ref[i], rtol=1e-4,
                                       atol=1e-4,
                                       err_msg=f"tile {i} (dist, {seed})")
    finally:
        mca.params.unset("dtd_audit")


# ------------------------------------------------------- checkpoint
def _mk(name, n=32, ts=8, **kw):
    dc = TwoDimBlockCyclic(name, n, n, ts, ts, P=kw.pop("P", 1), Q=1, **kw)
    return dc


def _dist_life1(rank, fabric, init, path):
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
    RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
    A = _mk("DCK", P=2, nodes=2, myrank=rank)
    A.fill(lambda m, n: init[m*8:(m+1)*8, n*8:(n+1)*8])
    tp = DTDTaskpool(ctx, "p1")
    # cross-rank dataflow before the checkpoint: every tile reads its
    # vertical neighbor's (0, col) anchor on rank 0
    anchors = [tp.tile_of(A, 0, n) for n in range(A.nt)]
    for m in range(1, A.mt):
        for n in range(A.nt):
            tp.insert_task(lambda x, a: x + a[0, 0], (tp.tile_of(A, m, n), RW),
                           (anchors[n], READ), jit=False)
    tp.data_flush_all(A)
    tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
    out = checkpoint.save(path, {"DCK": A}, rank=rank)
    ctx.fini()
    return out


def _dist_life2(rank, fabric, path):
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
    RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
    A = _mk("DCK", P=2, nodes=2, myrank=rank)
    A.fill(lambda m, n: np.zeros((8, 8), np.float32))
    checkpoint.restore(path, {"DCK": A}, rank=rank)
    tp = DTDTaskpool(ctx, "p2")
    for m in range(A.mt):
        for n in range(A.nt):
            tp.insert_task(lambda x: x * 10.0, (tp.tile_of(A, m, n), RW),
                           jit=False)
    tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
    mine = {(m, n): np.asarray(A.data_of(m, n).newest_copy().payload)
            for m in range(A.mt) for n in range(A.nt)
            if A.rank_of(m, n) == rank}
    ctx.fini()
    return mine


def test_checkpoint_resume_distributed(tmp_path):
    """2-rank run checkpoints per-rank shards at quiescence; a brand-new
    2-rank run restores and continues."""
    rng = np.random.default_rng(9)
    init = rng.standard_normal((32, 32)).astype(np.float32)
    path = str(tmp_path / "dck")

    run_distributed(2, lambda r, f: _dist_life1(r, f, init, path), timeout=60)
    results = run_distributed(2, lambda r, f: _dist_life2(r, f, path),
                              timeout=60)
    full = {}
    for mine in results:
        full.update(mine)

    expect = init.copy()
    for m in range(1, 4):
        for n in range(4):
            expect[m*8:(m+1)*8, n*8:(n+1)*8] += init[0, n*8]
    expect *= 10.0
    for (m, n), tile in full.items():
        np.testing.assert_allclose(tile, expect[m*8:(m+1)*8, n*8:(n+1)*8],
                                   rtol=1e-5)


# ------------------------------------------------ collection variants
def test_sbc_potrf_2rank():
    """DTD Cholesky over a basic SBC(r=2) layout across 2 real protocol
    ranks — the workload the distribution was designed for."""
    N, TS = 64, 16
    spd = make_spd(N, seed=5)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = SBCDistribution("SBC_A", N, N, TS, TS, r=2, extended=False,
                            nodes=2, myrank=rank)
        A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        tp = DTDTaskpool(ctx, "sbc_potrf")
        insert_potrf_tasks(tp, A)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        out = {}
        for m in range(A.mt):
            for n in range(m + 1):
                if A.rank_of(m, n) == rank:
                    out[(m, n)] = np.asarray(A.data_of(m, n).newest_copy().payload)
        return out

    results = run_distributed(2, program, timeout=120)
    ref = np.linalg.cholesky(spd.astype(np.float64))
    full = np.zeros((N, N))
    for out in results:
        for (m, n), tile in out.items():
            full[m*TS:(m+1)*TS, n*TS:(n+1)*TS] = tile
    np.testing.assert_allclose(np.tril(full), np.tril(ref), rtol=0, atol=2e-2)


def _band_pack_reference(dense, mb, nt):
    """Direct numpy construction of the packed band storage."""
    out = np.zeros((mb + 1, nt * (mb + 2)), np.float32)
    n = nt * mb
    for j in range(n):
        k, jj = divmod(j, mb)
        col = k * (mb + 2) + jj
        for i in range(mb + 1):
            if j + i < n:
                out[i, col] = dense[j + i, j]
    return out


def test_diag_band_to_rect_2rank():
    """Band tiles distributed over 2 ranks flow to the packed tiles' owners
    through the remote-dep protocol."""
    TS, NT = 8, 4
    N = TS * NT
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((N, N)).astype(np.float32)
    dense = np.tril(dense) + np.tril(dense, -1).T

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        kw = dict(nodes=2, myrank=rank)
        A = TwoDimBlockCyclic("dbA", N, N, TS, TS, P=2, Q=1, **kw)
        B = TwoDimBlockCyclic("dbB", TS + 1, NT * (TS + 2), TS + 1, TS + 2,
                              P=1, Q=2, **kw)
        A.fill(lambda m, n: dense[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: np.zeros((TS + 1, TS + 2), np.float32))
        tp = DTDTaskpool(ctx, "band2rect2")
        diag_band_to_rect(tp, A, B)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        out = {}
        for n in range(B.nt):
            if B.rank_of(0, n) == rank:
                out[n] = np.asarray(B.data_of(0, n).newest_copy().payload)
        return out

    results = run_distributed(2, program, timeout=120)
    ref = _band_pack_reference(dense, TS, NT)
    for out in results:
        for n, tile in out.items():
            np.testing.assert_allclose(
                tile, ref[:, n*(TS+2):(n+1)*(TS+2)], rtol=0, atol=1e-6)


# ------------------------------------------------------ redistribute
def _redist_4rank(rank, fabric):
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE

    rng = np.random.default_rng(77)
    src = rng.standard_normal((48, 48)).astype(np.float32)
    dst = rng.standard_normal((48, 48)).astype(np.float32)
    ctx = pt.Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=4)
    RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
    kw = dict(P=2, Q=2, nodes=4, myrank=rank)
    S = TwoDimBlockCyclic("d4S", 48, 48, 8, 8, **kw)
    T = TwoDimBlockCyclic("d4T", 48, 48, 12, 12, **kw)
    S.fill(lambda m, k: src[m * 8:(m + 1) * 8, k * 8:(k + 1) * 8])
    T.fill(lambda m, k: dst[m * 12:(m + 1) * 12, k * 12:(k + 1) * 12])
    tp = DTDTaskpool(ctx, "d4")
    redistribute(tp, S, T, m=30, n=26, si=5, sj=9, ti=11, tj=3)
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=120)
    expect = dst.copy()
    expect[11:41, 3:29] = src[5:35, 9:35]
    out = {}
    for tm in range(4):
        for tn in range(4):
            if T.rank_of(tm, tn) == rank:
                out[(tm, tn)] = np.asarray(
                    T.data_of(tm, tn).newest_copy().payload)
    ctx.fini()
    errs = [float(np.abs(out[(tm, tn)]
                         - expect[tm * 12:(tm + 1) * 12,
                                  tn * 12:(tn + 1) * 12]).max())
            for (tm, tn) in out]
    return max(errs) if errs else 0.0


def test_random_offsets_four_ranks():
    """Unaligned cross-geometry redistribution across a 2x2 rank grid:
    owner-computes placement + remote source reads."""
    from parsec_tpu_torch.comm.threads import run_distributed
    errs = run_distributed(4, _redist_4rank, timeout=240)
    assert max(errs) == 0.0, errs


# ------------------------------------------------------ concurrency
def test_distributed_two_workers_each():
    """2 ranks x 2 worker threads: comm progress (master only) under
    concurrent execution."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed

    N, TS = 64, 16
    rng = np.random.default_rng(62)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)

    def program(rank, fabric):
        ctx = Context(nb_cores=2, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        kw = dict(nodes=2, myrank=rank, P=2, Q=1)
        A = TwoDimBlockCyclic("A2w", N, N, TS, TS, **kw)
        B = TwoDimBlockCyclic("B2w", N, N, TS, TS, **kw)
        C = TwoDimBlockCyclic("C2w", N, N, TS, TS, **kw)
        A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
        B.fill(lambda k, j: b[k*TS:(k+1)*TS, j*TS:(j+1)*TS])
        C.fill(lambda m, j: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(ctx, "gemm2w")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=60)
        ctx.fini()
        return {(m, j): np.asarray(C.data_of(m, j).newest_copy().payload)
                for m in range(C.mt) for j in range(C.nt)
                if C.rank_of(m, j) == rank}

    results = run_distributed(2, program, timeout=180)
    ref = a @ b
    full = {}
    for o in results:
        full.update(o)
    for (m, j), tile in full.items():
        np.testing.assert_allclose(tile, ref[m*TS:(m+1)*TS, j*TS:(j+1)*TS],
                                   rtol=1e-3, atol=1e-3)


# ------------------------------------------- DTD placement and lanes
def test_notrack_does_not_steer_placement(ctx):
    """Owner-computes fallback must skip NOTRACK flows: a task whose only
    tracked flow is a READ on a collection tile takes THAT tile's rank,
    even when an untracked scratch tile comes first."""
    from parsec_tpu_torch.dsl.dtd import NOTRACK
    A = TiledMatrix("Antp", 8, 8, 8, 8)
    A.fill(lambda m, n: np.zeros((8, 8), np.float32))
    tp = DTDTaskpool(ctx, "notrack-place")
    scratch = tp.tile_new((8, 8))
    # single-rank contexts make every tile rank 0; a sentinel rank on the
    # scratch tile makes the assertion discriminating (the old fallback
    # picked tiles[0] = scratch and would yield rank 7 here)
    scratch.rank = 7
    t = tp.tile_of(A, 0, 0)
    task = tp.insert_task(lambda s, a: None, (scratch, RW | NOTRACK),
                          (t, READ), jit=False, name="P")
    assert task.rank == t.rank == 0
    scratch.rank = ctx.my_rank
    tp.wait(); tp.close(); ctx.wait()


def test_native_lane_off_when_distributed():
    """Comm-attached contexts stay on the Python engine (the protocol
    bookkeeping lives there)."""
    from parsec_tpu_torch.comm.threads import run_distributed

    def program(rank, fabric):
        from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
        from parsec_tpu_torch.comm.threads import ThreadsCE
        ctx = pt.Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        tp = DTDTaskpool(ctx, "off")
        used = tp._native_engine()
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        return used is None

    assert all(run_distributed(2, program, timeout=60))


def _inc(a):
    return a + 1.0


def test_audit_digest_deterministic_and_unperturbed():
    """The replay auditor (pure-Python lane) digests the same program to
    the same crc32 on repeated runs — covering the zlib-hoist/bytes-path
    refactor — and collection-backed keys take the fast byte path."""
    from parsec_tpu_torch.data.matrix import TiledMatrix

    def run():
        mca.set("dtd_audit", True)
        try:
            c = pt.Context(nb_cores=1, device="cpu")
            try:
                m = TiledMatrix("pm", 4, 4, 2, 2)
                m.fill(lambda i, j: np.zeros((2, 2), np.float32))
                tp = DTDTaskpool(c, "aud")
                for k in range(40):
                    t = tp.tile_of(m, k % 2, (k // 2) % 2)
                    tp.insert_task(_inc, (t, RW), jit=False)
                tp.wait(timeout=60)
                tp.close()
                c.wait(timeout=30)
                assert tp._audit_count == 40
                return tp._audit_digest
            finally:
                c.fini()
        finally:
            mca.params.unset("dtd_audit")

    d1 = run()
    d2 = run()
    assert d1 == d2 and d1 != 0




# ------------------------------------------- chip_smoke's phase 12, rehearsed
def test_chip_smoke_distribution_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 12 of ``chip_smoke.py`` (the 2-rank DTD GEMM over the d2d
    backend held bit for bit to the single-rank C with no host
    materialization, the 2-process POTRF over TCP with the device-memory
    plane on and off and the same factor, the PTG legs through the native
    comm lane and remote_dep.py with the lane engaged on both ranks, the
    2-rank PTG GEMM) with every gate that does not need the card, on CPU
    contexts, at sizes cut to a few tiles. Its multiprocess steps take the
    port's job lock."""
    import chip_smoke as CS

    from parsec_tpu_torch.ops import cuda_kernels as K
    monkeypatch.setattr(CS, "DIST_GEMM_N", 64)
    monkeypatch.setattr(CS, "DIST_GEMM_TS", 16)
    monkeypatch.setattr(CS, "DIST_POTRF_N", 64)
    monkeypatch.setattr(CS, "DIST_POTRF_TS", 16)
    monkeypatch.setattr(CS, "DIST_CHAIN_NT", 4)
    monkeypatch.setattr(CS, "DIST_CHAIN_DEPTH", 8)
    monkeypatch.setattr(CS, "DIST_DATA_NT", 4)
    monkeypatch.setattr(CS, "DIST_DATA_DEPTH", 4)
    monkeypatch.setattr(CS, "DIST_DATA_TS", 4)
    monkeypatch.setattr(CS, "DIST_REPS", 1)
    monkeypatch.setattr(CS, "DIST_TURNS", (True, False))
    monkeypatch.setattr(CS, "DIST_PTG_T", 2)
    monkeypatch.setattr(CS, "DIST_PTG_TS", 8)
    out = CS.distribution(pt, K, torch, "cpu", device="cpu")
    assert out["launches"] == 0            # the CPU runs the plain chain
    assert len(out["walls"]) == 4
