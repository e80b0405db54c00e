"""The port's distributed runtime over the in-process multi-rank fabric.

The reference's ``tests/test_distributed.py`` on the port
(``parsec_tpu_torch.comm``): each rank is a thread with its own CPU Context
and comm engine; every protocol message really flows (activate/get/put,
multicast forwarding, termdet waves), under the DTD replay auditor. Plus
cross-checks that run one program through both packages on seeded numpy
inputs: the tiles at the reference test's tolerance and each rank's
protocol counters (activations, payloads and bytes sent and received,
forwards) equal to the reference's rank by rank; the audit digest of one
insert sequence equal across packages; and the send-boundary snapshot (a
tile the producer writes in place after the send reaches the consumer as
it was sent).
"""

import time

import numpy as np
import pytest
import torch

from parsec_tpu_torch.comm.engine import (TAG_DSL_BASE,
                                          TAG_REMOTE_DEP_ACTIVATE)
from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine, bcast_children
from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca


@pytest.fixture(autouse=True)
def _dtd_audit_everywhere():
    """Every distributed DTD test runs under the replay auditor — silent
    on consistent replays, fatal on divergence."""
    mca.set("dtd_audit", True)
    yield
    mca.params.unset("dtd_audit")


def _mkctx(rank, fabric, ce_cls=ThreadsCE):
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank,
                  nb_ranks=fabric.nb_ranks)
    RemoteDepEngine(ctx, ce_cls(fabric, rank))
    return ctx


def _local_tiles(M, rank, lower=False):
    return {(m, n): np.asarray(M.data_of(m, n).newest_copy().payload)
            for m in range(M.mt) for n in range(M.nt)
            if M.rank_of(m, n) == rank and (not lower or m >= n)}


def test_bcast_children_algorithms():
    ranks = [1, 2, 3, 4, 5]
    star = bcast_children(ranks, 0, "star")
    assert [c for c, _ in star] == ranks and all(not s for _, s in star)
    chain = bcast_children(ranks, 0, "chain")
    assert chain == [(1, [2, 3, 4, 5])]
    bino = bcast_children(ranks, 0, "binomial")
    covered = set()
    for child, sub in bino:
        covered.add(child)
        covered.update(sub)
    assert covered == set(ranks)


def test_am_roundtrip():
    """Raw CE: AM send/recv."""
    def program(rank, fabric):
        ce = ThreadsCE(fabric, rank)
        got = []
        ce.tag_register(TAG_DSL_BASE,
                        lambda _ce, src, hdr, pl: got.append((src, hdr, pl)))
        fabric.barrier()
        ce.send_am(TAG_DSL_BASE, (rank + 1) % fabric.nb_ranks,
                   {"from": rank}, b"hi")
        t0 = time.time()
        while not got and time.time() - t0 < 5:
            ce.progress()
        fabric.barrier()
        return got[0]

    results = run_distributed(2, program)
    assert results[0][0] == 1 and results[1][0] == 0
    assert results[0][2] == b"hi"


def _gemm_program(nb_ranks, a, b, N, TS):
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        P = 2 if nb_ranks > 1 else 1
        kw = dict(nodes=nb_ranks, myrank=rank, P=P, Q=nb_ranks // P)
        A = TwoDimBlockCyclic("A", N, N, TS, TS, **kw)
        B = TwoDimBlockCyclic("B", N, N, TS, TS, **kw)
        C = TwoDimBlockCyclic("C", N, N, TS, TS, **kw)
        A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(ctx, "dgemm")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=30)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        return _local_tiles(C, rank)
    return program


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_distributed_dtd_gemm(nb_ranks):
    """Tiled GEMM with tiles spread block-cyclically over N ranks: remote
    reads of A/B panels must flow through activate/put messages."""
    N, TS = 64, 16
    rng = np.random.default_rng(8)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    results = run_distributed(nb_ranks, _gemm_program(nb_ranks, a, b, N, TS),
                              timeout=120)
    ref = a @ b
    full = {}
    for out in results:
        for k, v in out.items():
            assert k not in full, "tile owned by two ranks"
            full[k] = v
    assert len(full) == (N // TS) ** 2
    for (m, n), tile in full.items():
        np.testing.assert_allclose(
            tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS], rtol=1e-3, atol=1e-3)


def test_distributed_dtd_potrf():
    """DTD Cholesky across 2 ranks (dpotrf via remote deps)."""
    N, TS = 64, 16
    spd = make_spd(N, seed=9)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("A", N, N, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        tp = DTDTaskpool(ctx, "dpotrf")
        insert_potrf_tasks(tp, A)
        tp.wait(timeout=30)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        return _local_tiles(A, rank, lower=True)

    results = run_distributed(2, program, timeout=120)
    L = np.zeros((N, N), np.float32)
    for out in results:
        for (m, n), tile in out.items():
            L[m*TS:(m+1)*TS, n*TS:(n+1)*TS] = tile
    L = np.tril(L)
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)


def test_fourcounter_termination_empty_pool():
    """Global termination fires on an empty distributed taskpool."""
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        tp = DTDTaskpool(ctx, "empty")
        if rank == 0:
            t = tp.tile_new((4, 4))
            tp.insert_task(lambda x: x + 1.0, (t, RW))
        tp.wait(timeout=20)
        tp.close()
        ok = ctx.wait(timeout=20) == 0 and tp.completed
        ctx.fini()
        return ok

    assert all(run_distributed(3, program, timeout=60))


def test_rendezvous_large_payload():
    """Payloads over the eager limit take the GET/PUT rendezvous path
    (ref: remote_dep_mpi_get_start / put_start)."""
    mca.set("comm_eager_limit", 128)   # force rendezvous for 16x16 tiles
    try:
        N, TS = 32, 16
        rng = np.random.default_rng(10)
        a = rng.standard_normal((N, N)).astype(np.float32)

        def program(rank, fabric):
            ctx = _mkctx(rank, fabric)
            A = TwoDimBlockCyclic("A", N, N, TS, TS, P=2, Q=1,
                                  nodes=2, myrank=rank)
            A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
            tp = DTDTaskpool(ctx, "rdv")
            # row-sum chain: every tile of row 1 is added into tile (0,0),
            # forcing cross-rank transfers (row 1 lives on rank 1)
            acc = tp.tile_of(A, 0, 0)
            for n in range(A.nt):
                tp.insert_task(lambda x, y: x + y, (acc, RW | AFFINITY),
                               (tp.tile_of(A, 1, n), READ))
            tp.wait(timeout=30)
            tp.close()
            ctx.wait(timeout=30)
            ctx.fini()
            if rank == 0:
                return np.asarray(A.data_of(0, 0).newest_copy().payload)
            return None

        results = run_distributed(2, program, timeout=60)
        expect = a[:TS, :TS] + a[TS:2*TS, :TS] + a[TS:2*TS, TS:2*TS]
        np.testing.assert_allclose(results[0], expect, rtol=1e-4, atol=1e-4)
    finally:
        mca.params.unset("comm_eager_limit")


DISTRIBUTED_GEMM_PTG = """
// DPLASMA-style distributed GEMM: READ tasks at the data owners broadcast
// panels to the GEMM tasks (memory reads stay rank-local; cross-rank
// movement is task->task dataflow riding the multicast trees)
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


def _ptg_gemm_program(nb_ranks, a, b, MT, NT, KT, TS, ctx_of):
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    prog = compile_ptg(DISTRIBUTED_GEMM_PTG, "dgemm_ptg")

    def program(rank, fabric):
        ctx = ctx_of(rank, fabric)
        kw = dict(nodes=nb_ranks, myrank=rank, P=2, Q=nb_ranks // 2)
        A = TwoDimBlockCyclic("dA", MT*TS, KT*TS, TS, TS, **kw)
        B = TwoDimBlockCyclic("dB", KT*TS, NT*TS, TS, TS, **kw)
        C = TwoDimBlockCyclic("dC", MT*TS, NT*TS, TS, TS, **kw)
        A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
        B.fill(lambda k, n: b[k*TS:(k+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = prog.instantiate(ctx, globals={"MT": MT, "NT": NT, "KT": KT},
                              collections={"descA": A, "descB": B,
                                           "descC": C},
                              name="dgemm_ptg")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        ok = tp.completed
        ctx.fini()
        return ok, _local_tiles(C, rank)
    return program


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_distributed_ptg_gemm(nb_ranks):
    """Distributed PTG (the reference's primary mode): owner-computes task
    placement, cross-rank dataflow with multicast, fourcounter
    termination."""
    MT = NT = KT = 4
    TS = 8
    rng = np.random.default_rng(50)
    a = rng.standard_normal((MT*TS, KT*TS)).astype(np.float32)
    b = rng.standard_normal((KT*TS, NT*TS)).astype(np.float32)
    results = run_distributed(
        nb_ranks, _ptg_gemm_program(nb_ranks, a, b, MT, NT, KT, TS, _mkctx),
        timeout=180)
    ref = a @ b
    assert all(ok for ok, _ in results)
    full = {}
    for _, out in results:
        full.update(out)
    assert len(full) == MT * NT
    for (m, n), tile in full.items():
        np.testing.assert_allclose(tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS],
                                   rtol=1e-3, atol=1e-3)


def _bump_anchor(x, anchor):
    return x + 1.0


def test_alternating_rank_write_chain():
    """A single tile written by a chain of tasks that alternates ranks:
    each hop ships the PRODUCER's output, not whatever the tile held at
    insertion time."""
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("ALT", 16, 4, 4, 4, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.zeros((4, 4), np.float32))
        tp = DTDTaskpool(ctx, "altchain")
        t = tp.tile_of(A, 0, 0)
        anchors = [tp.tile_of(A, 2, 0), tp.tile_of(A, 1, 0)]  # rank0, rank1
        for i in range(8):
            tp.insert_task(_bump_anchor, (t, RW),
                           (anchors[i % 2], READ | AFFINITY),
                           jit=False, name="bump")
        tp.data_flush_all(A)
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30); ctx.fini()
        if rank == 0:
            return float(np.asarray(
                A.data_of(0, 0).newest_copy().payload)[0, 0])
        return None

    results = run_distributed(2, program, timeout=60)
    assert results[0] == 8.0


def test_distributed_geqrf_row_cyclic():
    """Tile QR across 2 ranks with ROW-cyclic tiles: TSQRT/TSMQR write
    tiles owned by other ranks (flush writes them home) and Q factors ship
    across the fabric."""
    from parsec_tpu_torch.ops.geqrf import insert_geqrf_tasks
    n, ts = 64, 16
    rng = np.random.default_rng(92)
    a = rng.standard_normal((n, n)).astype(np.float32)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("QRD", n, n, ts, ts, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        tp = DTDTaskpool(ctx, "dgeqrf")
        insert_geqrf_tasks(tp, A)
        tp.data_flush_all(A)
        tp.wait(timeout=60); tp.close(); ctx.wait(timeout=60); ctx.fini()
        return _local_tiles(A, rank)

    results = run_distributed(2, program, timeout=180)
    M = np.zeros((n, n), np.float32)
    for o in results:
        for (m, k), tile in o.items():
            M[m*ts:(m+1)*ts, k*ts:(k+1)*ts] = tile
    R = np.triu(M)
    ref = a.T @ a
    np.testing.assert_allclose(R.T @ R, ref, atol=0.05 * np.abs(ref).max())


def test_distributed_getrf():
    """Tiled LU (no pivoting) across 2 ranks."""
    from parsec_tpu_torch.ops.getrf import insert_getrf_tasks, make_dd, \
        unpack_lu
    n, ts = 64, 16
    a = make_dd(n, seed=93)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("LUD", n, n, ts, ts, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        tp = DTDTaskpool(ctx, "dgetrf")
        insert_getrf_tasks(tp, A)
        tp.wait(timeout=60); tp.close(); ctx.wait(timeout=60); ctx.fini()
        return _local_tiles(A, rank)

    results = run_distributed(2, program, timeout=180)
    M = np.zeros((n, n), np.float32)
    for o in results:
        for (m, k), tile in o.items():
            M[m*ts:(m+1)*ts, k*ts:(k+1)*ts] = tile
    L, U = unpack_lu(M)
    np.testing.assert_allclose(np.asarray(L) @ np.asarray(U), a,
                               rtol=2e-2, atol=2e-2)


def _bump(x):
    return x + 1.0


def test_early_activate_parked_until_registration():
    """A data activate that lands before the receiving rank has registered
    the taskpool is parked and replayed at registration — not dropped —
    and rank 1 FORWARDS the parked payload down the chain to rank 2 after
    it registers."""
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("EARLY", 12, 4, 4, 4, P=3, Q=1,
                              nodes=3, myrank=rank)
        A.fill(lambda m, n: np.full((4, 4), float(m), np.float32))
        if rank > 0:
            time.sleep(0.3 * rank)   # let rank 0's sends land first
        tp = DTDTaskpool(ctx, "early")
        src = tp.tile_of(A, 0, 0)          # owned by rank 0
        outs = [tp.tile_of(A, m, 0) for m in range(3)]
        tp.insert_task(_bump, (src, RW), jit=False, name="w")
        for m in (1, 2):
            tp.insert_task(lambda x, s: x + s[0, 0], (outs[m], RW),
                           (src, READ), jit=False, name=f"r{m}")
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30); ctx.fini()
        if rank > 0:
            return float(np.asarray(
                A.data_of(rank, 0).newest_copy().payload)[0, 0])
        return None

    results = run_distributed(3, program, timeout=60)
    assert results[1] == 2.0 and results[2] == 3.0


def test_dtd_taskpool_names_unique_per_context():
    """Two concurrently-constructible pools with the same base name get
    distinct registry names."""
    ctx = Context(nb_cores=1, device="cpu")
    tp1 = DTDTaskpool(ctx, "samename")
    tp2 = DTDTaskpool(ctx, "samename")
    assert tp1.name != tp2.name
    tp1.wait(); tp1.close()
    tp2.wait(); tp2.close()
    ctx.wait(); ctx.fini()


def test_comm_state_gc_after_termination():
    """Per-payload bookkeeping (_received/_sent/applied versions) is dropped
    once the taskpool's global termination is declared."""
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        kw = dict(P=2, Q=1, nodes=2, myrank=rank)
        A = TwoDimBlockCyclic("GC", 32, 32, 16, 16, **kw)
        A.fill(lambda m, n: np.ones((16, 16), np.float32))
        B = TwoDimBlockCyclic("GCB", 32, 32, 16, 16, **kw)
        B.fill(lambda m, n: np.ones((16, 16), np.float32))
        C = TwoDimBlockCyclic("GCC", 32, 32, 16, 16, **kw)
        C.fill(lambda m, n: np.zeros((16, 16), np.float32))
        tp = DTDTaskpool(ctx, "gcpool")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
        eng = ctx.comm
        leftovers = (len(eng._received), len(eng._sent),
                     len(eng._applied_version), len(eng._tp_keys))
        ctx.fini()
        return leftovers

    for leftovers in run_distributed(2, program, timeout=60):
        assert leftovers == (0, 0, 0, 0), leftovers


def _produce_consume(rank, fabric):
    """Rank 0's device module writes a tile; rank 1 consumes it
    remotely."""
    ctx = _mkctx(rank, fabric)
    A = TwoDimBlockCyclic("DD", 8, 8, 4, 4, P=2, Q=1, nodes=2, myrank=rank)
    A.fill(lambda m, n: np.full((4, 4), 1.0, np.float32))
    tp = DTDTaskpool(ctx, "devdirect")
    src = tp.tile_of(A, 0, 0)   # rank 0
    dst = tp.tile_of(A, 1, 0)   # rank 1
    tp.insert_task(lambda x: x * 3.0, (src, RW), name="w")          # on dev
    tp.insert_task(lambda y, x: y + x[0, 0], (dst, RW), (src, READ),
                   name="r")
    tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
    out = None
    if rank == 1:
        got = src.data.get_copy(0).payload
        out = (type(got).__name__, isinstance(got, np.ndarray),
               isinstance(got, torch.Tensor),
               float(np.asarray(A.data_of(1, 0).newest_copy().payload)[0, 0]))
    ctx.fini()
    return out


def test_device_payload_ships_without_host_roundtrip():
    """A producer tile made by the CUDA device module (here over the CPU)
    crosses rank boundaries as a tensor — the protocol layer never turns a
    payload into numpy on sends."""
    mca.set("device_cuda_over_cpu", True)
    try:
        results = run_distributed(2, _produce_consume, timeout=60)
    finally:
        mca.params.unset("device_cuda_over_cpu")
    tname, is_np, is_tensor, val = results[1]
    assert val == 4.0                      # 1 + 3*1
    assert is_tensor and not is_np, \
        f"payload crossed as {tname}; expected a tensor"


def _audited_gemm(rank, fabric):
    ctx = _mkctx(rank, fabric)
    a = np.full((32, 32), 2.0, np.float32)
    kw = dict(P=2, Q=1, nodes=2, myrank=rank)
    A = TwoDimBlockCyclic("AUD", 32, 32, 16, 16, **kw)
    B = TwoDimBlockCyclic("AUDB", 32, 32, 16, 16, **kw)
    C = TwoDimBlockCyclic("AUDC", 32, 32, 16, 16, **kw)
    for M in (A, B):
        M.fill(lambda m, n: a[m*16:(m+1)*16, n*16:(n+1)*16])
    C.fill(lambda m, n: np.zeros((16, 16), np.float32))
    tp = DTDTaskpool(ctx, "audgemm")
    insert_gemm_tasks(tp, A, B, C)
    ok = tp.wait(timeout=30)
    tp.close(); ctx.wait(timeout=30); ctx.fini()
    return ok and tp._audit_count > 0


def test_dtd_audit_consistent_replay_passes():
    """The replay auditor is silent on a correct distributed run."""
    assert all(run_distributed(2, _audited_gemm, timeout=60))


def _divergent_program(rank, fabric):
    ctx = _mkctx(rank, fabric)
    A = TwoDimBlockCyclic("DIV", 16, 4, 4, 4, P=2, Q=1,
                          nodes=2, myrank=rank)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = DTDTaskpool(ctx, "divergent")
    t0, t1 = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
    tp.insert_task(lambda x: x + 1.0, (t0, RW), jit=False, name="w0")
    if rank == 1:
        # the bug under test: rank 1 replays an extra insert the other
        # rank never saw
        tp.insert_task(lambda x: x + 1.0, (t1, RW), jit=False, name="rogue")
    try:
        tp.wait(timeout=20)
        caught = False
    except RuntimeError as e:
        caught = "replay audit FAILED" in str(e)
    try:
        tp.close(); ctx.fini()
    except Exception:  # noqa: BLE001 - the pool is broken on purpose
        pass
    return caught


def test_dtd_audit_catches_divergent_insert():
    """A deliberately-seeded divergent insert is caught at wait() by the
    auditor on every rank."""
    results = run_distributed(2, _divergent_program, timeout=60)
    assert all(results), results


def test_streaming_transport_skips_rendezvous(tmp_path):
    """On CAP_STREAMING transports the default eager limit is unbounded:
    tiles far beyond 64KiB ship PUT-with-activate, no GET/PUT round trip,
    proven from the comm trace."""
    from parsec_tpu_torch.tools.trace_reader import comm_events, read_pbp
    from parsec_tpu_torch.utils.trace import Profiling

    N, TS = 320, 160               # 160x160 f32 = 100KiB > 64KiB default
    rng = np.random.default_rng(9)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        ctx.profiling = Profiling()
        kw = dict(nodes=2, myrank=rank, P=2, Q=1)
        A = TwoDimBlockCyclic("seA", N, N, TS, TS, **kw)
        B = TwoDimBlockCyclic("seB", N, N, TS, TS, **kw)
        C = TwoDimBlockCyclic("seC", N, N, TS, TS, **kw)
        A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(ctx, "eagergemm")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        path = str(tmp_path / f"stream.r{rank}.pbp")
        ctx.profiling.dump(path)
        return path, _local_tiles(C, rank)

    results = run_distributed(2, program, timeout=120)
    full = {}
    big_total = 0
    for path, out in results:
        evs = comm_events(read_pbp(path))
        kinds = {e["kind"] for e in evs}
        assert not kinds & {"get_snd", "get_rcv", "put_snd", "put_rcv"}, \
            f"rendezvous legs on a streaming transport: {kinds}"
        big_total += sum(1 for e in evs if e["kind"] == "activate_snd"
                         and e["bytes"] > 65536)
        full.update(out)
    assert big_total > 0, "no above-limit eager activate recorded on any rank"
    ref = a @ b
    for (m, n), tile in full.items():
        np.testing.assert_allclose(tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS],
                                   rtol=1e-3, atol=1e-2)


# ------------------------------------------------ the send-boundary snapshot
def _inplace_times_100(x):
    """A body that writes its tile IN PLACE (a torch tensor is mutable)."""
    return x.mul_(100.0)


def test_sent_tile_written_in_place_after_the_send_reaches_the_consumer_unchanged():
    """Rank 0 writes A(0,0) (x3), ships that version to rank 1, then writes
    the same tile again IN PLACE (x100). Rank 1 registers late, so the
    in-place write has run before its reader does: the consumer must read
    the version it was sent (3), which only a snapshot at the send boundary
    guarantees — the producer's tile tensor no longer holds it."""
    def program(rank, fabric):
        ctx = _mkctx(rank, fabric)
        A = TwoDimBlockCyclic("SNAP", 8, 4, 4, 4, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.full((4, 4), 1.0, np.float32))
        if rank == 1:
            time.sleep(0.4)            # rank 0 runs ahead
        tp = DTDTaskpool(ctx, "snapshot")
        src, dst = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
        tp.insert_task(lambda x: x * 3.0, (src, RW), jit=False, name="w")
        tp.insert_task(lambda y, x: y + x, (dst, RW), (src, READ),
                       jit=False, name="r")
        tp.insert_task(_inplace_times_100, (src, RW), jit=False,
                       name="inplace")
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
        out = float(np.asarray(
            (A.data_of(rank, 0)).newest_copy().payload)[0, 0])
        ctx.fini()
        return out

    results = run_distributed(2, program, timeout=60)
    assert results[0] == 300.0          # the producer's own tile moved on
    assert results[1] == 4.0            # 1 + 3: the version that was sent


# ------------------------------------------------ cross-checks, both packages
class _Counted:
    """Per-rank protocol counters of a CE: activations, payloads and bytes
    sent and received, and forwards (received activations that name ranks
    further down the multicast tree)."""

    @staticmethod
    def wrap(base, nbytes):
        class CountingCE(base):
            def __init__(self, fabric, rank):
                super().__init__(fabric, rank)
                self.stats = dict.fromkeys(
                    ("act_tx", "act_rx", "pl_tx", "pl_rx", "bytes_tx",
                     "bytes_rx", "forwards"), 0)

            def send_am(self, tag, dst, header, payload=None):
                if tag == 2:                   # TAG_REMOTE_DEP_ACTIVATE
                    self.stats["act_tx"] += 1
                if payload is not None and tag in (1, 2):
                    self.stats["pl_tx"] += 1
                    self.stats["bytes_tx"] += nbytes(payload)
                super().send_am(tag, dst, header, payload)

            def _deliver(self, tag, src, header, payload):
                if tag == 2:
                    self.stats["act_rx"] += 1
                    if isinstance(header, dict) and header.get("forward"):
                        self.stats["forwards"] += 1
                if payload is not None and tag in (1, 2):
                    self.stats["pl_rx"] += 1
                    self.stats["bytes_rx"] += nbytes(payload)
                return super()._deliver(tag, src, header, payload)
        return CountingCE


def _run_both(nb_ranks, make_program):
    """``make_program(pkg)`` for the reference (``pkg`` the parsec_tpu
    modules) and the port; returns (reference results, port results), each
    a per-rank list of (program result, protocol counters)."""
    import parsec_tpu.comm.remote_dep as R_rd
    import parsec_tpu.comm.threads as R_th
    import parsec_tpu.core.context as R_ctx
    from parsec_tpu.utils import mca as R_mca
    assert TAG_REMOTE_DEP_ACTIVATE == 2
    out = []
    for ref in (True, False):
        if ref:
            CE = _Counted.wrap(R_th.ThreadsCE, lambda p: int(
                np.asarray(p).nbytes))

            def ctx_of(rank, fabric, CE=CE):
                ctx = R_ctx.Context(nb_cores=1, my_rank=rank,
                                    nb_ranks=fabric.nb_ranks)
                R_rd.RemoteDepEngine(ctx, CE(fabric, rank))
                return ctx
            run = R_th.run_distributed
        else:
            CE = _Counted.wrap(ThreadsCE, lambda p: int(p.nbytes))

            def ctx_of(rank, fabric, CE=CE):
                ctx = Context(nb_cores=1, device="cpu", my_rank=rank,
                              nb_ranks=fabric.nb_ranks)
                RemoteDepEngine(ctx, CE(fabric, rank))
                return ctx
            run = run_distributed
        program = make_program(ref, ctx_of)

        def wrapped(rank, fabric, program=program):
            res, ctx = program(rank, fabric)
            return res, dict(ctx.comm.ce.stats)
        R_mca.set("dtd_audit", True)
        try:
            out.append(run(nb_ranks, wrapped, timeout=180))
        finally:
            R_mca.params.unset("dtd_audit")
    return out[0], out[1]


def _dtd_program(kind, nb_ranks, N, TS, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    spd = make_spd(N, seed=seed)

    def make(ref, ctx_of):
        if ref:
            from parsec_tpu.data.matrix import TwoDimBlockCyclic as TM
            from parsec_tpu.dsl.dtd import DTDTaskpool as DP
            from parsec_tpu.ops.gemm import insert_gemm_tasks as gemm
            from parsec_tpu.ops.potrf import insert_potrf_tasks as potrf
        else:
            TM, DP, gemm, potrf = (TwoDimBlockCyclic, DTDTaskpool,
                                   insert_gemm_tasks, insert_potrf_tasks)

        def program(rank, fabric):
            ctx = ctx_of(rank, fabric)
            P = 2
            kw = dict(nodes=nb_ranks, myrank=rank, P=P, Q=nb_ranks // P)
            if kind == "gemm":
                A, B, C = (TM(x, N, N, TS, TS, **kw) for x in "ABC")
                A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
                B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
                C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
                tp = DP(ctx, "xgemm")
                gemm(tp, A, B, C)
                out_m, lower = C, False
            else:
                A = TM("A", N, N, TS, TS, **kw)
                A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
                tp = DP(ctx, "xpotrf")
                potrf(tp, A)
                out_m, lower = A, True
            tp.wait(timeout=60)
            tp.close()
            ctx.wait(timeout=60)
            ctx.fini()
            return (_local_tiles(out_m, rank, lower=lower),
                    (tp._audit_digest, tp._audit_count)), ctx
        return program
    return make


@pytest.mark.parametrize("kind,nb_ranks", [("gemm", 2), ("gemm", 4),
                                           ("potrf", 2)])
def test_cross_check_dtd_tiles_and_protocol_counters(kind, nb_ranks):
    """One DAG and grid through both packages on seeded numpy inputs: every
    rank's tiles agree at the reference test's 1e-3, its protocol counters
    (activations, payloads and bytes sent and received, forwards) are the
    reference's exactly, and so is its audit digest of the insert
    sequence."""
    ref, port = _run_both(nb_ranks, _dtd_program(kind, nb_ranks, 64, 16,
                                                 seed=31))
    for rank, ((r_res, r_st), (p_res, p_st)) in enumerate(zip(ref, port)):
        (r_tiles, r_audit), (p_tiles, p_audit) = r_res, p_res
        assert set(r_tiles) == set(p_tiles) and r_tiles
        for k in r_tiles:
            np.testing.assert_allclose(p_tiles[k], r_tiles[k], rtol=1e-3,
                                       atol=1e-3)
        assert p_st == r_st, (rank, p_st, r_st)
        assert p_st["act_rx"] > 0 and p_st["bytes_rx"] > 0
        assert p_audit == r_audit, (rank, p_audit, r_audit)


def test_cross_check_ptg_gemm_tiles_and_protocol_counters():
    """The 2-rank PTG GEMM through both packages: tiles at 1e-3 and every
    rank's protocol counters equal to the reference's."""
    MT = NT = KT = 4
    TS = 8
    rng = np.random.default_rng(51)
    a = rng.standard_normal((MT*TS, KT*TS)).astype(np.float32)
    b = rng.standard_normal((KT*TS, NT*TS)).astype(np.float32)

    def make(ref, ctx_of):
        if ref:
            from parsec_tpu.data.matrix import TwoDimBlockCyclic as TM
            from parsec_tpu.dsl.ptg.compiler import compile_ptg
            src = DISTRIBUTED_GEMM_PTG.replace(
                "[type=CUDA]", "[type=TPU]").replace(
                "torch.matmul(A, B)",
                "jnp.dot(A, B, preferred_element_type=jnp.float32)")
        else:
            from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
            TM, src = TwoDimBlockCyclic, DISTRIBUTED_GEMM_PTG
        prog = compile_ptg(src, "xgemm_ptg")

        def program(rank, fabric):
            ctx = ctx_of(rank, fabric)
            kw = dict(nodes=2, myrank=rank, P=2, Q=1)
            A = TM("dA", MT*TS, KT*TS, TS, TS, **kw)
            B = TM("dB", KT*TS, NT*TS, TS, TS, **kw)
            C = TM("dC", MT*TS, NT*TS, TS, TS, **kw)
            A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
            B.fill(lambda k, n: b[k*TS:(k+1)*TS, n*TS:(n+1)*TS])
            C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
            tp = prog.instantiate(ctx, globals={"MT": MT, "NT": NT,
                                                "KT": KT},
                                  collections={"descA": A, "descB": B,
                                               "descC": C},
                                  name="xgemm_ptg")
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            ctx.fini()
            return _local_tiles(C, rank), ctx
        return program

    ref, port = _run_both(2, make)
    for rank, ((r_tiles, r_st), (p_tiles, p_st)) in enumerate(zip(ref, port)):
        assert set(r_tiles) == set(p_tiles) and r_tiles
        for k in r_tiles:
            np.testing.assert_allclose(p_tiles[k], r_tiles[k], rtol=1e-3,
                                       atol=1e-3)
        assert p_st == r_st, (rank, p_st, r_st)
        assert p_st["act_tx"] > 0
