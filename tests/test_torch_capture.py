"""Graph capture of DTD taskpools through both runtimes.

The reference's capture tests (tests/test_capture.py, without its mesh and
PTG-replay tests) on the port: the same numpy inputs go through the
reference's capture (its CPU backend, as its own tests run it) and through
the port's (``Context(device="cpu")``, where capture replays eagerly). The
reference's tolerance holds between the packages: rtol/atol 1e-5 against
the scheduler. Inside the port the scheduler, inline and scan results are
bit-identical. The dposv solve runs under both execution modes, as the
reference's ``test_posv_solver_both_modes`` drives it.
"""

import time

import numpy as np
import pytest
import torch

import parsec_tpu as pt
from parsec_tpu.data.matrix import TiledMatrix as RefTiled
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops.gemm import insert_gemm_tasks as ref_insert_gemm
from parsec_tpu.ops.potrf import insert_posv_tasks as ref_insert_posv
from parsec_tpu.ops.potrf import insert_potrf_tasks as ref_insert_potrf
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl import capture as CAP
from parsec_tpu_torch.dsl.dtd import PTDTD_STATS, DTDTaskpool, READ, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import (insert_posv_tasks, insert_potrf_tasks,
                                        make_spd)
from parsec_tpu_torch.utils import mca

#: the port's execution modes: the scheduler and the two strategies
MODES = (False, "inline", "scan")


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini(timeout=30)     # a failed test's open pool must not hang


@pytest.fixture()
def ref_ctx():
    c = pt.Context(nb_cores=1)
    yield c
    c.fini(timeout=30)
    # the reference's program cache is process-wide: leave it cold, as a
    # fresh process has it, so that a reference test run later in the same
    # worker and asserting a first-shape compile
    # (tests/test_capture.py::test_capture_program_cache) sees a miss
    from parsec_tpu.dsl import capture as ref_capture
    ref_capture._program_cache.clear()


def _tiles(dense, ts):
    def fill(m, k):
        return dense[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts]
    return fill


def _ref_matrix(name, dense, ts):
    M = RefMatrix(name, dense.shape[0], dense.shape[1], ts, ts, P=1, Q=1)
    M.fill(_tiles(dense, ts))
    return M


def _matrix(name, dense, ts):
    M = TiledMatrix(name, dense.shape[0], dense.shape[1], ts, ts)
    M.fill(_tiles(dense, ts))
    return M


def _run(ctx, pool_cls, name, capture, insert, *mats, **kw):
    tp = pool_cls(ctx, name, capture=capture)
    n = insert(tp, *mats, **kw)
    tp.wait()
    tp.close()
    ctx.wait()
    return n, tp


def _port_modes(ctx, name, insert, dense_of, ts, **kw):
    """Run ``insert`` over fresh tilings of ``dense_of`` (a dict name ->
    array) under every port mode; returns {mode: {name: dense result}} and
    asserts the three modes bit-identical."""
    out = {}
    for mode in MODES:
        mats = {k: _matrix(f"{name}{k}{mode}", v, ts)
                for k, v in dense_of.items()}
        _, tp = _run(ctx, DTDTaskpool, f"{name}{mode}", mode, insert,
                     *mats.values(), **kw)
        if mode:
            assert tp._capture.last_mode == mode
            assert tp._capture.executions == 1
        out[mode] = {k: M.to_dense() for k, M in mats.items()}
    for mode in MODES[1:]:
        for k in dense_of:
            np.testing.assert_array_equal(out[mode][k], out[False][k],
                                          err_msg=f"{mode} vs scheduler")
    return out


def _gemm_dense(n, seed):
    rng = np.random.default_rng(seed)
    return {"A": rng.standard_normal((n, n)).astype(np.float32),
            "B": rng.standard_normal((n, n)).astype(np.float32),
            "C": np.zeros((n, n), np.float32)}


@pytest.mark.parametrize("batch_k", [False, True])
def test_capture_gemm_matches_scheduler(ctx, ref_ctx, batch_k):
    n, ts = 64, 16
    d = _gemm_dense(n, 3)
    got = _port_modes(ctx, "g", insert_gemm_tasks, d, ts,
                      batch_k=batch_k)[False]["C"]
    ref = [_ref_matrix(f"rg{k}", v, ts) for k, v in d.items()]
    n_ref, rtp = _run(ref_ctx, RefPool, "rcap-gemm", True, ref_insert_gemm,
                      *ref, batch_k=batch_k)
    assert rtp._capture.executions == 1
    np.testing.assert_allclose(got, np.asarray(ref[2].to_dense()), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, d["A"] @ d["B"], rtol=1e-3, atol=1e-3)


def test_capture_gemm_auto_picks_the_reference_strategy(ctx, ref_ctx):
    """capture=True on the 64-task GEMM DAG (at the threshold) takes scan
    in both packages, and the 16-task chained one inline."""
    n, ts = 64, 16
    d = _gemm_dense(n, 4)
    for batch_k, want in ((False, "scan"), (True, "inline")):
        mats = [_matrix(f"au{k}{batch_k}", v, ts) for k, v in d.items()]
        _, tp = _run(ctx, DTDTaskpool, "auto", True, insert_gemm_tasks, *mats,
                     batch_k=batch_k)
        ref = [_ref_matrix(f"rau{k}{batch_k}", v, ts) for k, v in d.items()]
        _, rtp = _run(ref_ctx, RefPool, "rauto", True, ref_insert_gemm, *ref,
                      batch_k=batch_k)
        assert tp._capture.last_mode == rtp._capture.last_mode == want
        np.testing.assert_allclose(mats[2].to_dense(),
                                   np.asarray(ref[2].to_dense()), rtol=1e-5,
                                   atol=1e-5)


def _ref_potrf(ref_ctx, spd, ts, name, capture):
    P = _ref_matrix(name, spd, ts)
    _run(ref_ctx, RefPool, name, capture, ref_insert_potrf, P)
    return np.tril(np.asarray(P.to_dense(), np.float64))


def test_capture_potrf_matches_scheduler(ctx, ref_ctx):
    """The serial-critical-path DAG: POTRF's panel chain as one program."""
    n, ts = 64, 16
    spd = make_spd(n, seed=9)
    got = np.tril(_port_modes(ctx, "p", insert_potrf_tasks, {"P": spd},
                              ts)[False]["P"].astype(np.float64))
    ref = _ref_potrf(ref_ctx, spd, ts, "rp", True)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.linalg.cholesky(spd.astype(np.float64)),
                               rtol=0, atol=2e-2)


def test_capture_program_cache(ctx, ref_ctx):
    """Identical DAG shapes reuse the program; a changed shape misses."""
    n, ts = 32, 16
    d = _gemm_dense(n, 5)
    results = {}
    for pkg, (c, pool, insert, mk) in {
            "port": (ctx, DTDTaskpool, insert_gemm_tasks, _matrix),
            "ref": (ref_ctx, RefPool, ref_insert_gemm, _ref_matrix)}.items():
        A, B, C = (mk(f"h{pkg}{k}", v, ts) for k, v in d.items())
        cap = pool(c, f"cache-gemm-{pkg}", capture=True)
        insert(cap, A, B, C, batch_k=True)
        cap.wait()
        assert not cap._capture.cache_hit        # first shape: capture
        insert(cap, A, B, C, batch_k=True)
        cap.wait()
        assert cap._capture.cache_hit            # same shape: cached
        assert cap._capture.executions == 2
        # a shape no other test runs (the program cache is process-wide)
        A2, B2, C2 = (mk(f"h2{pkg}{k}", np.ones((5 * ts, 5 * ts), np.float32),
                         ts) for k in "ABC")
        insert(cap, A2, B2, C2, batch_k=True)
        cap.wait()
        assert not cap._capture.cache_hit        # changed shape: a miss
        cap.close()
        c.wait()
        results[pkg] = np.asarray(C.to_dense())
    # C accumulated the product twice
    np.testing.assert_allclose(results["port"], results["ref"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(results["port"], 2 * (d["A"] @ d["B"]),
                               rtol=1e-3, atol=1e-3)


def test_capture_program_cache_across_pools(ctx):
    """A second pool with other tiles of the same DAG shape replays the
    first pool's program, and each pool's collections keep their own
    results (the port's cached programs own their tile buffers). The
    shape (kt = 3) is this test's own: the program cache is process-wide."""
    n, ts = 48, 16
    outs = []
    for seed in (6, 7):
        d = _gemm_dense(n, seed)
        mats = [_matrix(f"x{seed}{k}", v, ts) for k, v in d.items()]
        _, tp = _run(ctx, DTDTaskpool, "xpool", "inline", insert_gemm_tasks,
                     *mats, batch_k=True)
        outs.append((tp._capture.cache_hit, mats[2], d["A"] @ d["B"]))
    assert [hit for hit, _, _ in outs] == [False, True]
    for _, C, want in outs:
        np.testing.assert_allclose(C.to_dense(), want, rtol=1e-5, atol=1e-5)


def _rejects_nonjit(ctx, ref_ctx):
    import parsec_tpu.utils.mca as ref_mca
    mca.set("capture_auto_defer", False)
    ref_mca.set("capture_auto_defer", False)
    try:
        for c, pool, dtype in ((ctx, DTDTaskpool, torch.float32),
                               (ref_ctx, RefPool, np.float32)):
            cap = pool(c, "cap-neg", capture=True)
            t = cap.tile_new((4, 4), dtype)
            with pytest.raises(RuntimeError, match="jit-traceable"):
                cap.insert_task(lambda x: x, (t, RW), jit=False)
            cap.close()
    finally:
        mca.unset("capture_auto_defer")
        ref_mca.params.unset("capture_auto_defer")


def test_capture_rejects_nonjit(ctx, ref_ctx):
    """With auto-defer off, a jit=False insert is a hard error in both."""
    _rejects_nonjit(ctx, ref_ctx)


def test_capture_rejects_nonjit_and_multirank(ctx, ref_ctx):
    """The reference's test whole: the jit=False refusal, and a captured
    pool on a context of two ranks (in-process ranks over the threads comm
    engine) refused as single-rank in both."""
    _rejects_nonjit(ctx, ref_ctx)
    from parsec_tpu.comm.remote_dep import RemoteDepEngine as RefRDE
    from parsec_tpu.comm.threads import ThreadsCE as RefCE
    from parsec_tpu.comm.threads import run_distributed as ref_run
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed

    def program(make_ctx, rde, ce, pool):
        def run(rank, fabric):
            c = make_ctx(rank)
            rde(c, ce(fabric, rank))
            try:
                pool(c, "cap2", capture=True)
                return "accepted"
            except RuntimeError as e:
                return str(e)
            finally:
                c.fini(timeout=5)
        return run

    port = run_distributed(2, program(
        lambda r: Context(nb_cores=1, device="cpu", my_rank=r, nb_ranks=2),
        RemoteDepEngine, ThreadsCE, DTDTaskpool), timeout=30)
    ref = ref_run(2, program(
        lambda r: pt.Context(nb_cores=1, my_rank=r, nb_ranks=2),
        RefRDE, RefCE, RefPool), timeout=30)
    assert all("single-rank" in r for r in port + ref), (port, ref)


def test_capture_close_executes_pending(ctx):
    """close() without wait() executes the recorded DAG."""
    cap = DTDTaskpool(ctx, "cap-close", capture=True)
    t = cap.tile_new((4, 4))
    t.data.create_copy(0, torch.ones(4, 4))
    cap.insert_task(lambda x: x + 1.0, (t, RW))
    cap.close()                     # no wait()
    ctx.wait()
    np.testing.assert_allclose(t.data.newest_copy().payload.numpy(), 2.0)
    assert cap._capture.executions == 1


def _mixed_value_args(c, pool, ones, zeros):
    cap = pool(c, "cap-mixed", capture=True)
    t = cap.tile_new((4, 4), np.float32)
    host = cap.tile_new((4, 4), np.float32)
    t.data.create_copy(0, ones((4, 4)))
    host.data.create_copy(0, zeros((4, 4)))
    bias = np.full((4, 4), 0.5, np.float32)

    def scale_add(x, alpha, b):
        return x * alpha + b

    cap.insert_task(scale_add, (t, RW), 3.0, bias)
    cap.insert_task(lambda dst, s: dst + s, (host, RW), (t, READ))
    cap.wait()
    cap.close()
    c.wait()
    return [np.asarray(x.data.newest_copy().payload) for x in (host, t)]


def test_capture_mixed_value_args(ctx, ref_ctx):
    """Scalar params bake into the program; ndarray params ride as
    inputs."""
    got = _mixed_value_args(ctx, DTDTaskpool, torch.ones, torch.zeros)
    want = _mixed_value_args(ref_ctx, RefPool,
                             lambda s: np.ones(s, np.float32),
                             lambda s: np.zeros(s, np.float32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, 3.0 + 0.5)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", ["getrf", "geqrf"])
def test_capture_lu_qr_match_scheduler(ctx, ref_ctx, which):
    """The LU and QR tile DAGs (solves, householder panels) run whole and
    match the scheduler; against the reference, LU element by element and
    QR's R up to the sign of each row (LAPACK builds may flip one)."""
    n, ts = 48, 16
    if which == "getrf":
        from parsec_tpu.ops.getrf import insert_getrf_tasks as ref_ins
        from parsec_tpu_torch.ops.getrf import insert_getrf_tasks as ins
        from parsec_tpu_torch.ops.getrf import make_dd
        src = make_dd(n, seed=3)
    else:
        from parsec_tpu.ops.geqrf import insert_geqrf_tasks as ref_ins
        from parsec_tpu_torch.ops.geqrf import insert_geqrf_tasks as ins
        rng = np.random.default_rng(3)
        src = rng.standard_normal((n, n)).astype(np.float32)
    got = _port_modes(ctx, which, ins, {"M": src}, ts)[False]["M"]
    R = _ref_matrix(f"r{which}", src, ts)
    _run(ref_ctx, RefPool, f"r{which}", True, ref_ins, R)
    want = np.asarray(R.to_dense(), np.float64)
    got = got.astype(np.float64)
    if which == "geqrf":
        got, want = np.abs(np.triu(got)), np.abs(np.triu(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_capture_stencil_matches_scheduler(ctx, ref_ctx):
    """The iterative halo-exchange DAG: ping-pong buffers and neighbour
    reads replay whole."""
    from parsec_tpu.ops.stencil import insert_stencil1d_tasks as ref_ins
    from parsec_tpu_torch.ops.stencil import insert_stencil1d_tasks as ins

    cols, ts, iters = 64, 16, 4
    rng = np.random.default_rng(2)
    init = rng.standard_normal((8, cols)).astype(np.float32)
    out = {}
    for mode in MODES:
        A = TiledMatrix(f"stA{mode}", 8, cols, 8, ts)
        B = TiledMatrix(f"stB{mode}", 8, cols, 8, ts)
        A.fill(lambda m, n: init[:, n * ts:(n + 1) * ts])
        B.fill(lambda m, n: np.zeros((8, ts), np.float32))
        _run(ctx, DTDTaskpool, f"st{mode}", mode, ins, A, B, iters)
        out[mode] = A.to_dense()               # iters even -> result in A
    for mode in MODES[1:]:
        np.testing.assert_array_equal(out[mode], out[False])
    A = RefTiled("rstA", 8, cols, 8, ts)
    B = RefTiled("rstB", 8, cols, 8, ts)
    A.fill(lambda m, n: init[:, n * ts:(n + 1) * ts])
    B.fill(lambda m, n: np.zeros((8, ts), np.float32))
    _run(ref_ctx, RefPool, "rst", True, ref_ins, A, B, iters)
    np.testing.assert_allclose(out[False], np.asarray(A.to_dense()),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------- scan-interpreter capture

def test_scan_capture_gemm_matches_scheduler(ctx, ref_ctx):
    """The scanned task interpreter on the tiled-GEMM DAG."""
    n, ts = 64, 16
    d = _gemm_dense(n, 31)
    mats = [_matrix(f"zc{k}", v, ts) for k, v in d.items()]
    _, tp = _run(ctx, DTDTaskpool, "zscan", "scan", insert_gemm_tasks, *mats)
    assert tp._capture.last_mode == "scan"
    sched = [_matrix(f"zs{k}", v, ts) for k, v in d.items()]
    _run(ctx, DTDTaskpool, "zsched", False, insert_gemm_tasks, *sched)
    np.testing.assert_array_equal(mats[2].to_dense(), sched[2].to_dense())
    ref = [_ref_matrix(f"rz{k}", v, ts) for k, v in d.items()]
    _, rtp = _run(ref_ctx, RefPool, "rzscan", "scan", ref_insert_gemm, *ref)
    assert rtp._capture.last_mode == "scan"
    np.testing.assert_allclose(mats[2].to_dense(),
                               np.asarray(ref[2].to_dense()), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mats[2].to_dense(), d["A"] @ d["B"],
                               rtol=1e-3, atol=1e-3)


def test_scan_capture_potrf_matches_scheduler(ctx, ref_ctx):
    """The DAG the scan mode exists for: POTRF's decompose-heavy bodies."""
    n, ts = 64, 16
    spd = make_spd(n, seed=29)
    P = _matrix("zp2", spd, ts)
    _, tp = _run(ctx, DTDTaskpool, "zp-scan", "scan", insert_potrf_tasks, P)
    assert tp._capture.last_mode == "scan"
    S = _matrix("zp1", spd, ts)
    _run(ctx, DTDTaskpool, "zp-sched", False, insert_potrf_tasks, S)
    np.testing.assert_array_equal(P.to_dense(), S.to_dense())
    ref = _ref_potrf(ref_ctx, spd, ts, "rzp", "scan")
    np.testing.assert_allclose(np.tril(P.to_dense().astype(np.float64)), ref,
                               rtol=1e-5, atol=1e-5)


def _axpy(y, x):
    return y + 2.0 * x


def _reuse(c, pool, perm, name, full):
    ts = 8
    cap = pool(c, name, capture="scan")
    tiles = [cap.tile_new((ts, ts), np.float32) for _ in range(4)]
    for i, t in enumerate(tiles):
        t.data.create_copy(0, full((ts, ts), float(i)))
    for dst, src in perm:                     # same class, different rows
        cap.insert_task(_axpy, (tiles[dst], RW), (tiles[src], READ))
    cap.wait()
    hit = cap._capture.cache_hit
    cap.close()
    c.wait()
    return hit, [float(np.asarray(t.data.newest_copy().payload)[0, 0])
                 for t in tiles]


def test_scan_capture_program_reuse_across_different_dags(ctx, ref_ctx):
    """Descriptor rows are runtime DATA: two DIFFERENT DAGs with the same
    task-class sequence, op count and store geometry share one program."""
    p1, p2 = [(0, 1), (2, 3), (0, 2), (1, 3)], [(3, 0), (1, 2), (3, 1), (2, 0)]
    for c, pool, full in ((ctx, DTDTaskpool, torch.full),
                          (ref_ctx, RefPool,
                           lambda s, v: np.full(s, v, np.float32))):
        hit1, v1 = _reuse(c, pool, p1, "zr1", full)
        hit2, v2 = _reuse(c, pool, p2, "zr2", full)
        assert not hit1 and hit2       # the second DAG reuses the program
        assert v1 == [0 + 2 * 1 + 2 * (2 + 2 * 3), 1 + 2 * 3, 2 + 2 * 3, 3.0]
        assert v2 == [0.0, 1 + 2 * 2, 2 + 2 * 0, 3 + 2 * 0 + 2 * (1 + 2 * 2)]


def test_scan_capture_scalar_args_split_classes(ctx):
    """Scalar args are baked per class: ops differing only in a scalar are
    distinct classes and produce distinct results."""
    cap = DTDTaskpool(ctx, "zsc", capture="scan")
    t1 = cap.tile_new((4, 4))
    t2 = cap.tile_new((4, 4))
    t1.data.create_copy(0, torch.ones(4, 4))
    t2.data.create_copy(0, torch.ones(4, 4))

    def scale(x, alpha):
        return x * alpha

    cap.insert_task(scale, (t1, RW), 3.0)
    cap.insert_task(scale, (t2, RW), 5.0)
    cap.wait()
    cap.close()
    ctx.wait()
    np.testing.assert_allclose(t1.data.newest_copy().payload.numpy(), 3.0)
    np.testing.assert_allclose(t2.data.newest_copy().payload.numpy(), 5.0)


def test_scan_capture_rejects_raw_array_args(ctx):
    """Raw array args are not scannable: explicit scan fails loudly."""
    cap = DTDTaskpool(ctx, "zneg", capture="scan")
    t = cap.tile_new((4, 4))
    t.data.create_copy(0, torch.ones(4, 4))
    cap.insert_task(lambda x, b: x + b, (t, RW),
                    np.zeros((4, 4), np.float32))
    with pytest.raises(Exception, match="scan"):
        cap.wait()
    assert cap._capture.ops == []   # the rejected recording is consumed
    cap.close()


def test_auto_capture_picks_scan_above_threshold(ctx):
    """capture=True (auto) stays inline below the MCA threshold and
    switches to the scan interpreter at it."""
    mca.set("capture_scan_threshold", 8)
    try:
        def bump(x):
            return x + 1.0

        def run(nops, name):
            cap = DTDTaskpool(ctx, name, capture=True)
            t = cap.tile_new((4, 4))
            for _ in range(nops):
                cap.insert_task(bump, (t, RW))
            cap.wait()
            mode = cap._capture.last_mode
            cap.close()
            ctx.wait()
            return mode, float(t.data.newest_copy().payload[0, 0])

        assert run(4, "zat-s") == ("inline", 4.0)
        assert run(16, "zat-b") == ("scan", 16.0)
    finally:
        mca.unset("capture_scan_threshold")


def test_scan_capture_scales_to_hundreds_of_tasks(ctx, ref_ctx):
    """An 816-task POTRF DAG under the scan strategy runs in seconds, and
    a second DAG of the same geometry reuses the program."""
    NT, ts = 16, 32
    n = NT * ts
    spd = make_spd(n, seed=3)
    P = _matrix("scS", spd, ts)
    tp = DTDTaskpool(ctx, "scan-scale", capture="scan")
    assert insert_potrf_tasks(tp, P) == 816
    t0 = time.perf_counter()
    tp.wait()
    first_s = time.perf_counter() - t0
    assert not tp._capture.cache_hit
    assert first_s < 60, f"replay took {first_s:.1f}s"
    first = P.to_dense()
    P.fill(_tiles(spd, ts))
    insert_potrf_tasks(tp, P)
    tp.wait()
    assert tp._capture.cache_hit        # same classes/geometry: cached
    tp.close()
    ctx.wait()
    np.testing.assert_array_equal(P.to_dense(), first)
    L = np.tril(P.to_dense().astype(np.float64))
    np.testing.assert_allclose(
        L, np.linalg.cholesky(spd.astype(np.float64)), rtol=0, atol=1e-4)
    ref = _ref_potrf(ref_ctx, spd, ts, "rscS", "scan")
    np.testing.assert_allclose(L, ref, rtol=1e-5, atol=1e-5)


def test_scan_capture_multi_write_flows(ctx):
    """A body with TWO write flows under the scan interpreter: both outputs
    land in their stores in argument order."""
    def swapscale(a, b):
        return b * 2.0, a * 3.0             # writes (a_new, b_new)

    cap = DTDTaskpool(ctx, "zmw", capture="scan")
    ta = cap.tile_new((4, 4))
    tb = cap.tile_new((4, 4))
    ta.data.create_copy(0, torch.full((4, 4), 1.0))
    tb.data.create_copy(0, torch.full((4, 4), 10.0))
    cap.insert_task(swapscale, (ta, RW), (tb, RW))
    cap.insert_task(swapscale, (ta, RW), (tb, RW))
    cap.wait()
    cap.close()
    ctx.wait()
    # step1: a=20, b=3; step2: a=6, b=60
    np.testing.assert_allclose(ta.data.newest_copy().payload.numpy(), 6.0)
    np.testing.assert_allclose(tb.data.newest_copy().payload.numpy(), 60.0)


def test_scan_rejects_dtype_mismatch_auto_falls_back_to_inline(ctx):
    """A body upcasting its f16 tile to f32 must land f32 under EVERY
    strategy: the gate (the body on meta tensors) rejects scan and auto
    takes inline."""
    def upcast(a):
        return a.float() * 1.5

    mca.set("capture_scan_threshold", 2)   # force auto into scan territory
    try:
        cap = DTDTaskpool(ctx, "zdt", capture="auto")
        t = cap.tile_new((4, 4), torch.float16)
        t.data.create_copy(0, torch.full((4, 4), 2.0, dtype=torch.float16))
        for _ in range(4):
            cap.insert_task(upcast, (t, RW))
        cap.wait()
        assert cap._capture.last_mode == "inline"
        cap.close()
        ctx.wait()
        out = t.data.newest_copy().payload
        assert out.dtype == torch.float32          # inline semantics kept
        np.testing.assert_allclose(out.numpy(), 2.0 * 1.5 ** 4)
    finally:
        mca.unset("capture_scan_threshold")


def test_scan_explicit_mode_rejects_dtype_mismatch(ctx):
    """Explicit capture='scan' with a dtype-changing body is an error."""
    cap = DTDTaskpool(ctx, "zdx", capture="scan")
    t = cap.tile_new((4, 4), torch.float16)
    cap.insert_task(lambda a: a.float(), (t, RW))
    with pytest.raises(Exception, match="scan capture rejected.*float32"):
        cap.wait()
    cap.close()


def test_scan_rejects_a_body_meta_tensors_cannot_run(ctx):
    """A body that cannot run on meta tensors (here it reads a value on the
    host) is rejected for scan, as the reference rejects a body it cannot
    evaluate abstractly; auto takes inline."""
    def host_read(a):
        return a * float(a.sum())

    mca.set("capture_scan_threshold", 2)
    try:
        cap = DTDTaskpool(ctx, "zmeta", capture=True)
        t = cap.tile_new((2, 2))
        t.data.create_copy(0, torch.full((2, 2), 0.5))
        for _ in range(2):
            cap.insert_task(host_read, (t, RW))
        cap.wait()
        assert cap._capture.last_mode == "inline"
        cap.close()
        ctx.wait()
        # 0.5 * (4 * 0.5) = 1, then 1 * (4 * 1) = 4
        np.testing.assert_allclose(t.data.newest_copy().payload.numpy(), 4.0)
    finally:
        mca.unset("capture_scan_threshold")


def test_scan_matching_dtypes_still_scans(ctx):
    """The dtype gate must not regress the scannable case."""
    def scale(a):
        return a * 2.0

    cap = DTDTaskpool(ctx, "zok", capture="scan")
    t = cap.tile_new((4, 4))
    t.data.create_copy(0, torch.ones(4, 4))
    for _ in range(3):
        cap.insert_task(scale, (t, RW))
    cap.wait()
    assert cap._capture.last_mode == "scan"
    cap.close()
    ctx.wait()
    np.testing.assert_allclose(t.data.newest_copy().payload.numpy(), 8.0)


def test_capture_auto_defers_noncapturable_window(ctx):
    """Per-window auto-defer: a window poisoned by a jit=False insert
    replays through the scheduler in program order — results match — and
    the NEXT window captures again."""
    cap = DTDTaskpool(ctx, "cap-defer", capture=True)
    t = cap.tile_new((4, 4))
    t.data.create_copy(0, torch.ones(4, 4))
    snap = PTDTD_STATS.snapshot()
    # window 1: two capturable inserts, then one that defeats capture
    cap.insert_task(lambda x: x * 2.0, (t, RW))
    cap.insert_task(lambda x: x + 1.0, (t, RW))

    def host_body(x):
        return np.asarray(x) + 0.5          # numpy: not a tensor function

    cap.insert_task(host_body, (t, RW), jit=False)
    assert cap._capture_deferred
    delta = PTDTD_STATS.delta(snap)
    assert delta["capture_windows_deferred"] == 1
    # the two recorded inserts went back as ONE fused region
    assert delta["capture_regions_fused"] == 1
    assert delta["capture_tasks_fused"] == 2
    assert cap._capture.ops == []           # prefix handed to the scheduler
    cap.wait()
    np.testing.assert_allclose(t.data.newest_copy().payload.numpy(),
                               1.0 * 2.0 + 1.0 + 0.5)
    # window 2: capture re-armed — a capturable window runs whole
    assert not cap._capture_deferred
    cap.insert_task(lambda x: x * 3.0, (t, RW))
    assert len(cap._capture.ops) == 1
    cap.wait()
    cap.close()
    ctx.wait()
    np.testing.assert_allclose(t.data.newest_copy().payload.numpy(),
                               3.5 * 3.0)
    assert cap._capture.executions == 1


def test_capture_modes_validated(ctx):
    with pytest.raises(RuntimeError, match="auto|inline|scan"):
        DTDTaskpool(ctx, "bad", capture="fast")
    for mode in (True, "auto", "inline", "scan"):
        tp = DTDTaskpool(ctx, f"ok{mode}", capture=mode)
        assert tp._capture.mode == ("auto" if mode is True else mode)
        tp.close()


# ------------------------------------------------------------- SPD solve

def test_posv_solver_both_modes(ctx, ref_ctx):
    """dposv shape: factorization + forward/backward substitution in one
    taskpool, under the scheduler and under capture (inline and scan),
    against numpy's solve (atol 5e-3, the reference test's) and against the
    reference's captured run (rtol/atol 1e-5); the port's modes agree bit
    for bit."""
    n, ts, nrhs = 64, 16, 8
    spd = make_spd(n, seed=12)
    rng = np.random.default_rng(12)
    rhs = rng.standard_normal((n, nrhs)).astype(np.float32)
    want = np.linalg.solve(spd.astype(np.float64), rhs.astype(np.float64))
    got = {}
    for mode in MODES:
        A = TiledMatrix(f"posvA{mode}", n, n, ts, ts)
        B = TiledMatrix(f"posvB{mode}", n, nrhs, ts, nrhs)
        A.fill(_tiles(spd, ts))
        B.fill(lambda m, k: rhs[m * ts:(m + 1) * ts, :])
        cnt, tp = _run(ctx, DTDTaskpool, f"posv{mode}", mode,
                       insert_posv_tasks, A, B)
        assert cnt > 0
        if mode:
            assert tp._capture.last_mode == mode
        got[mode] = B.to_dense()
        np.testing.assert_allclose(got[mode].astype(np.float64), want,
                                   rtol=0, atol=5e-3)
    for mode in MODES[1:]:
        np.testing.assert_array_equal(got[mode], got[False])
    A = RefMatrix("rposvA", n, n, ts, ts, P=1, Q=1)
    B = RefMatrix("rposvB", n, nrhs, ts, nrhs, P=1, Q=1)
    A.fill(_tiles(spd, ts))
    B.fill(lambda m, k: rhs[m * ts:(m + 1) * ts, :])
    n_ref, _ = _run(ref_ctx, RefPool, "rposv", True, ref_insert_posv, A, B)
    assert n_ref == cnt
    np.testing.assert_allclose(got[False], np.asarray(B.to_dense()),
                               rtol=1e-5, atol=1e-5)


def test_posv_rejects_a_mismatched_right_hand_side(ctx):
    A = TiledMatrix("pA", 32, 32, 16, 16)
    B = TiledMatrix("pB", 48, 4, 16, 4)
    tp = DTDTaskpool(ctx, "posv-bad")
    with pytest.raises(ValueError, match="posv"):
        insert_posv_tasks(tp, A, B)
    tp.close()


def test_dtype_gate_runs_bodies_on_meta_tensors():
    """The kernel wrappers on the capture paths answer meta tensors with
    an empty result of the right shape and dtype (no launch), so the gate
    accepts the GEMM chain and stencil bodies."""
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.ops.gemm import _gemm_chain_body
    from parsec_tpu_torch.ops.stencil import stencil1d_body
    meta = {"device": "meta"}
    launches = K.gemm_chain.launches, K.stencil1d.launches
    c = torch.empty(8, 8, dtype=torch.bfloat16, **meta)
    tiles = [torch.empty(8, 8, dtype=torch.bfloat16, **meta)] * 34
    out = _gemm_chain_body(17)(c, *tiles)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    x = torch.empty(1, 16, **meta)
    assert stencil1d_body(x, x, None).shape == (1, 16)
    assert (K.gemm_chain.launches, K.stencil1d.launches) == launches
    slots = (("flow", 0, 0, RW),) + tuple(("flow", i, 0, READ)
                                          for i in range(1, 35))
    assert CAP.GraphCapture._dtype_gate(
        _gemm_chain_body(17), slots, [((8, 8), torch.bfloat16)]) is None


# ------------------------------------------- randomized-DAG differential fuzz
# The single-rank half of the reference's tests/test_fuzz_dag.py: random
# tile DAGs (RW chains, fan-in reads, pure readers), the same generator and
# seeds, through the port's scheduler (1 and 4 workers) and both capture
# strategies, each against the sequential numpy replay of the insertion
# order (DTD's sequential-consistency ground truth) at rtol/atol 1e-4.

FUZZ_TS, FUZZ_NT, FUZZ_NTASKS = 4, 6, 60


def _body1(w, c0, c1):
    return w * c0 + c1


def _body2(w, r1, c0, c1):
    return w * c0 + r1 + c1


def _body3(w, r1, r2, c0, c1):
    return w * c0 + r1 - r2 + c1


def _reader(r1, c0, c1):
    return None


_FUZZ_BODIES = {1: _body1, 2: _body2, 3: _body3}


def random_dag(seed: int):
    """[(kind, write_ix, read_ixs, c0, c1)] with deterministic constants
    (the reference test's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(FUZZ_NTASKS):
        if rng.random() < 0.15:
            tasks.append(("read", None, [int(rng.integers(FUZZ_NT))],
                          0.0, 0.0))
            continue
        w = int(rng.integers(FUZZ_NT))
        n_reads = int(rng.integers(0, 3))
        reads = [int(v) for v in rng.choice(
            [i for i in range(FUZZ_NT) if i != w], size=n_reads,
            replace=False)]
        c0 = round(float(rng.uniform(0.5, 1.5)), 3)
        c1 = round(float(rng.uniform(-1.0, 1.0)), 3)
        tasks.append(("write", w, reads, c0, c1))
    return tasks


def _fuzz_init(i):
    return np.full((FUZZ_TS, FUZZ_TS), float(i + 1), np.float32)


def numpy_replay(tasks):
    """Sequential ground truth: DTD semantics == insertion-order replay."""
    tiles = [_fuzz_init(i).copy() for i in range(FUZZ_NT)]
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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["sched1", "sched4", "capture", "scan"])
def test_fuzz_single_rank(seed, mode):
    """``scan`` is the task-class interpreter's worst case: random per-op
    scalar constants make nearly every op its own class."""
    tasks = random_dag(seed)
    ref = numpy_replay(tasks)
    ctx = Context(nb_cores=4 if mode == "sched4" else 1, device="cpu")
    try:
        A = TiledMatrix(f"F{mode}{seed}", FUZZ_NT * FUZZ_TS, FUZZ_TS,
                        FUZZ_TS, FUZZ_TS)
        A.fill(lambda m, n: _fuzz_init(m))
        tp = DTDTaskpool(ctx, f"fuzz-{mode}-{seed}",
                         capture=(mode if mode == "scan"
                                  else mode == "capture"))
        tiles = [tp.tile_of(A, i, 0) for i in range(FUZZ_NT)]
        for kind, w, reads, c0, c1 in tasks:
            if kind == "read":
                tp.insert_task(_reader, (tiles[reads[0]], READ), c0, c1,
                               name="RD")
                continue
            args = [(tiles[w], RW)] + [(tiles[r], READ) for r in reads]
            tp.insert_task(_FUZZ_BODIES[1 + len(reads)], *args, c0, c1,
                           name=f"W{1 + len(reads)}")
        tp.wait()
        tp.close()
        ctx.wait()
        if mode == "scan":
            assert tp._capture.last_mode == "scan"
        for i in range(FUZZ_NT):
            got = A.data_of(i, 0).newest_copy().payload.numpy()
            np.testing.assert_allclose(got, ref[i], rtol=1e-4, atol=1e-4,
                                       err_msg=f"tile {i} ({mode}, {seed})")
    finally:
        ctx.fini(timeout=30)


class _Held(CAP._Program):
    """A stand-in program holding ``nbytes`` of buffers (no graph)."""

    def __init__(self, nbytes):
        super().__init__()
        self.buf = torch.zeros(nbytes, dtype=torch.uint8)

    def _drop(self):
        self.buf = None


def test_programs_charge_their_card_evict_over_budget_and_go_at_fini():
    """The card's budget counts what cached programs hold; a card over it
    drops its least recently used programs (the newest stays); the device
    module's fini releases the rest; a program that left the cache while
    it ran is not charged. The device module runs over the CPU here."""
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.dsl.fusion import CAPTURE_CACHE_STATS
    dev = CUDADevice(torch.device("cpu"))
    dev.set_budget(1000)
    evicted0 = CAPTURE_CACHE_STATS["cache_evictions"]
    progs = []
    for i in range(3):
        p, hit = CAP._program_cache.get_or_build(("held", i, id(dev)),
                                                 lambda: _Held(400))
        assert not hit
        p._charge(dev, 400)
        CAP._fit(dev, p)
        progs.append(p)
    # 1200 bytes charged against 1000: the oldest went, buffers and charge
    assert progs[0].released and progs[0].buf is None
    assert not progs[1].released and not progs[2].released
    assert dev.program_bytes == 800
    assert CAPTURE_CACHE_STATS["cache_evictions"] == evicted0 + 1
    # resident tiles count as well: with 300 resident, 800 + 300 > 1000
    dev._resident_bytes = 300
    CAP._fit(dev, progs[2])
    assert progs[1].released and dev.program_bytes == 400
    dev._resident_bytes = 0
    # a program released while it ran charges nothing afterwards
    late = _Held(100)
    late.release()
    late._charge(dev, 100)
    assert dev.program_bytes == 400 and late.dev is None
    dev.fini()
    assert progs[2].released and dev.program_bytes == 0
    assert not any(getattr(p, "dev", None) is dev
                   for _, p in CAP._program_cache.oldest_first())


_CAP_GEMM_PTG = """
%global MT
%global KT
%global descA
%global descB
%global descC

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. MT-1
  k = 0 .. KT-1
  : descC(m, n)
  READ A <- descA(m, k)
  READ B <- descB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY
  C = C + BODYDOT
END
"""


def test_capture_ptg_via_replay(ctx, ref_ctx):
    """A PTG program — static task space — run as ONE captured DAG through
    the cross-DSL replay (ptg_to_dtd + capture): tile GEMM results match
    the PTG scheduler execution, and the reference's own captured replay
    of the same program on the same inputs."""
    from parsec_tpu.core.pins_modules import ptg_to_dtd_replay as ref_replay
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    from parsec_tpu_torch.core.pins_modules import ptg_to_dtd_replay
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    MT = KT = 2
    TS = 8
    rng = np.random.default_rng(13)
    a = rng.standard_normal((MT * TS, KT * TS)).astype(np.float32)
    b = rng.standard_normal((KT * TS, MT * TS)).astype(np.float32)

    def mats(prefix, tiled):
        A = tiled(prefix + "A", MT * TS, KT * TS, TS, TS)
        B = tiled(prefix + "B", KT * TS, MT * TS, TS, TS)
        Cm = tiled(prefix + "C", MT * TS, MT * TS, TS, TS)
        A.fill(lambda m, k: a[m * TS:(m + 1) * TS, k * TS:(k + 1) * TS])
        B.fill(lambda k, n: b[k * TS:(k + 1) * TS, n * TS:(n + 1) * TS])
        Cm.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        return {"descA": A, "descB": B, "descC": Cm}

    src = _CAP_GEMM_PTG.replace("BODYDOT", "torch.matmul(A, B)")
    # scheduler PTG execution
    prog = compile_ptg(src, "capgemm")
    m1 = mats("rs", TiledMatrix)
    ptp = prog.instantiate(ctx, globals={"MT": MT, "KT": KT}, collections=m1)
    ctx.add_taskpool(ptp)
    ctx.wait(timeout=60)

    # captured replay of the same program
    m2 = mats("rc", TiledMatrix)
    ptp2 = prog.instantiate(ctx, globals={"MT": MT, "KT": KT},
                            collections=m2, name="capgemm2")
    dtp = ptg_to_dtd_replay(ptp2, ctx, capture=True)
    assert dtp._capture is not None
    dtp.wait()
    dtp.close()
    ctx.wait(timeout=60)
    assert dtp._capture.executions == 1

    # the reference's captured replay on the same inputs
    ref_src = _CAP_GEMM_PTG.replace(
        "BODYDOT", "jnp.dot(A, B, preferred_element_type=jnp.float32)")
    m3 = mats("rr", RefTiled)
    rtp = ref_compile(ref_src, "capgemm").instantiate(
        ref_ctx, globals={"MT": MT, "KT": KT}, collections=m3)
    rdtp = ref_replay(rtp, ref_ctx, capture=True)
    rdtp.wait()
    rdtp.close()
    ref_ctx.wait(timeout=60)

    # replay writes through the same C tiles the PTG version wrote
    c1, c2 = m1["descC"].to_dense(), m2["descC"].to_dense()
    np.testing.assert_allclose(c2, c1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c2, np.asarray(m3["descC"].to_dense()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c2, a @ b, rtol=1e-4, atol=1e-4)
