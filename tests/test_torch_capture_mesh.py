"""The reference's mesh-capture tests (``tests/test_capture.py``: the GEMM,
POTRF against the single-device capture, scratch and the guards, the
program cache, the halo bound on communication, ``wait_mesh`` without
capture) on the port. The same seeded numpy inputs go through the
reference's ``wait_mesh`` on its 8-device CPU mesh and through the port's
on a 2 x 4 mesh over an 8-rank gloo group of CPU ranks (one
:class:`RankPool` for the file), each rank on its own single-rank context.
Both are held to the reference tests' bounds, and the port to the
reference's result at 1e-4. The rank bodies are in
``tests/_torch_capture_mesh_jobs.py``; the port's communication is read
from its plan (``mesh_plan()``, the counterpart of ``mesh_hlo``) and from
``compat.STATS``."""

import numpy as np
import pytest

import _torch_capture_mesh_jobs as J
import parsec_tpu as pt
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.dsl.dtd import RW as REF_RW
from parsec_tpu.ops.gemm import insert_gemm_tasks as ref_insert_gemm
from parsec_tpu.ops.potrf import insert_potrf_tasks as ref_insert_potrf
from parsec_tpu.ops.potrf import make_spd
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.parallel.multihost import RankPool

#: one job's deadline (a hung transfer fails the test well inside the
#: suite's limit)
JOB_S = 120.0


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8, "cpu", timeout=JOB_S)
    yield p
    p.close()


@pytest.fixture()
def ref_ctx():
    c = pt.Context(nb_cores=1)
    yield c
    c.fini(timeout=30)
    # the reference's program cache is process-wide: leave it cold, as a
    # fresh process has it, so that the reference's own mesh tests run
    # later in the same worker (tests/test_capture.py) see their misses
    from parsec_tpu.dsl import capture as ref_capture
    ref_capture._program_cache.clear()


def _mesh2d():
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    assert len(devs) >= 8, "tests/conftest.py gives the reference 8 devices"
    return Mesh(np.array(devs[:8]).reshape(2, 4), ("x", "y"))


def _ref_matrix(name, dense, ts):
    M = RefMatrix(name, dense.shape[0], dense.shape[1], ts, ts, P=1, Q=1)
    M.fill(lambda m, k: dense[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
    return M


def _ref_gemm(ctx, name, n, ts, a, b, windows=1):
    """The reference's captured GEMM over its mesh, ``windows`` times. Its
    program cache keys hold the collections' names, so ``name`` is one
    that the reference's own tests do not use."""
    A, B = _ref_matrix(name + "A", a, ts), _ref_matrix(name + "B", b, ts)
    C = _ref_matrix(name + "C", np.zeros((n, n), np.float32), ts)
    cap = RefPool(ctx, name, capture=True)
    hits = []
    for _ in range(windows):
        ref_insert_gemm(cap, A, B, C, batch_k=True)
        cap.wait_mesh(_mesh2d())
        hits.append(cap._capture.cache_hit)
    hlo = cap._capture.mesh_hlo()
    cap.close()
    ctx.wait(timeout=30)
    return np.asarray(C.to_dense()), hits, hlo


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])


def test_mesh_capture_gemm(pool, ref_ctx):
    """The whole tiled-GEMM DAG over a 2x4 mesh; results match numpy and
    the reference's, and every rank lands the whole C."""
    n, ts = 64, 16
    a, b = _inputs(n, 21)
    res = pool.run(J.gemm, n, ts, a, b, 1, "pm")
    ref, _, _ = _ref_gemm(ref_ctx, "pm", n, ts, a, b)
    _same_on_every_rank(res, "C")
    got = res[0]["C"]
    np.testing.assert_allclose(got, a @ b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ref, a @ b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert [r["executions"] for r in res] == [1] * 8


def test_mesh_capture_potrf_matches_single(pool, ref_ctx):
    """Mesh capture on the factorization DAG (serial dependencies across
    owners) matches the single-device captured result, in both packages."""
    n, ts = 64, 16
    spd = make_spd(n, seed=17)
    res = pool.run(J.potrf, n, ts, spd)
    _same_on_every_rank(res, "mesh")
    got = np.tril(np.asarray(res[0]["mesh"], np.float64))
    single = np.tril(np.asarray(res[0]["single"], np.float64))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)

    P1 = _ref_matrix("pmp1", spd, ts)
    cap1 = RefPool(ref_ctx, "pmp-single", capture=True)
    ref_insert_potrf(cap1, P1)
    cap1.wait()
    cap1.close()
    P2 = _ref_matrix("pmp2", spd, ts)
    cap2 = RefPool(ref_ctx, "pmp-mesh", capture=True)
    ref_insert_potrf(cap2, P2)
    cap2.wait_mesh(_mesh2d())
    cap2.close()
    ref_ctx.wait(timeout=30)
    ref = np.tril(np.asarray(P2.to_dense(), np.float64))
    np.testing.assert_allclose(
        ref, np.tril(np.asarray(P1.to_dense(), np.float64)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_mesh_capture_scratch_and_guards(pool, ref_ctx):
    """Scratch tiles ride replicated; indivisible globals are rejected and
    the rejected batch is discarded (no execution, the tile untouched)."""
    for r in pool.run(J.scratch_and_guards):
        np.testing.assert_allclose(r["scratch"], 3.0)
        # the scratch-only op ran on every rank, with nothing to move
        assert r["scratch_ops"] == {q: 1 for q in range(8)}
        assert r["scratch_transfers"] == 0
        assert "divisible" in r["refused"]
        assert r["ops_left"] == 0
        assert r["executions"] == 0
        np.testing.assert_allclose(r["bad"], 0.0)

    mesh = _mesh2d()
    cap = RefPool(ref_ctx, "mesh-scratch", capture=True)
    t = cap.tile_new((8, 8), np.float32)
    t.data.create_copy(0, np.ones((8, 8), np.float32))
    cap.insert_task(lambda x: x * 3.0, (t, REF_RW))
    cap.wait_mesh(mesh)
    cap.close()
    ref_ctx.wait(timeout=30)
    np.testing.assert_allclose(np.asarray(t.data.newest_copy().payload), 3.0)
    bad = RefMatrix("pmeshbad", 10, 10, 5, 5, P=1, Q=1)
    bad.fill(lambda m, n: np.zeros((5, 5), np.float32))
    cap2 = RefPool(ref_ctx, "mesh-bad", capture=True)
    try:
        cap2.insert_task(lambda x: x + 1.0, (cap2.tile_of(bad, 0, 0), REF_RW))
        with pytest.raises(RuntimeError, match="divisible"):
            cap2.wait_mesh(mesh)
        assert cap2._capture.ops == []
    finally:
        cap2.close()
    assert cap2._capture.executions == 0


def test_mesh_capture_program_cache(pool, ref_ctx):
    """An identical window over the same mesh reuses the cached plan (the
    reference: the compiled GSPMD executable)."""
    n, ts = 32, 8
    a, b = _inputs(n, 23)
    res = pool.run(J.gemm, n, ts, a, b, 2, "pmc")
    ref, ref_hits, _ = _ref_gemm(ref_ctx, "pmc", n, ts, a, b, windows=2)
    assert ref_hits == [False, True]
    for r in res:
        assert r["hits"] == [False, True]
        assert r["executions"] == 2
    _same_on_every_rank(res, "C")
    np.testing.assert_allclose(res[0]["C"], 2 * (a @ b), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(ref, 2 * (a @ b), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res[0]["C"], ref, rtol=1e-4, atol=1e-4)


def _collective_ops(hlo: str):
    """(op kind, result bytes) for every collective in compiled HLO text
    (the reference test's reading of ``mesh_hlo``)."""
    import re
    bytes_of = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1}
    out = []
    for line in hlo.splitlines():
        m = re.search(
            r"=\s+(\w+)\[([\d,]*)\][^ ]*\s+"
            r"(all-gather|all-reduce|collective-permute|all-to-all|"
            r"reduce-scatter)", line)
        if m:
            el = 1
            for d in m.group(2).split(","):
                if d:
                    el *= int(d)
            out.append((m.group(3), el * bytes_of.get(m.group(1), 4)))
    return out


@pytest.mark.parametrize("n", [64, 128])
def test_mesh_capture_collectives_scale_with_halo(pool, ref_ctx, n):
    """Every transfer of the plan moves one tile: no transfer carries a
    whole matrix, and the largest stays at tile granularity as the matrix
    grows (communication scales with the halo). The plan's transfers are
    the ``send_recv`` entries of ``compat.STATS`` (the landing counts
    apart), which hold the same bounds; the reference's GSPMD program
    holds them on its collectives."""
    ts = 16
    a, b = _inputs(n, 25)
    res = pool.run(J.gemm, n, ts, a, b, 1, f"phq{n}")
    ref, _, hlo = _ref_gemm(ref_ctx, f"phq{n}", n, ts, a, b)
    got = res[0]["C"]
    np.testing.assert_allclose(got, a @ b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    tile_bytes = ts * ts * 4
    matrix_bytes = n * n * 4
    transfers = res[0]["plan"]["transfers"]
    assert transfers, "the plan of a 2x4-sharded GEMM moves no tile"
    worst = max(t[4] for t in transfers)
    assert worst <= 2 * tile_bytes, worst
    assert worst < matrix_bytes / 4, worst
    # a rank reads a tile it does not own only through a transfer, once
    # per (tile, rank), from its owner (A and B are only read)
    seen = {(t[1], t[3]) for t in transfers}
    assert len(seen) == len(transfers)
    # the counted sends are the plan's transfers, rank by rank
    calls = bytes_ = 0
    for r in res:
        sr = r["stats"]["send_recv/gloo"]
        mine = [t for t in transfers if t[2] == r["rank"]]
        assert (sr["calls"], sr["bytes"]) == (len(mine),
                                              sum(t[4] for t in mine))
        assert sr["bytes"] <= 2 * tile_bytes * sr["calls"]
        calls, bytes_ = calls + sr["calls"], bytes_ + sr["bytes"]
        assert set(r["stats"]) == {"send_recv/gloo", "mesh_land/gloo"}
    assert calls == len(transfers)

    colls = _collective_ops(hlo)
    assert colls
    ref_worst = max(by for _, by in colls)
    assert ref_worst <= 2 * tile_bytes and ref_worst < matrix_bytes / 4


def test_wait_mesh_requires_capture(ref_ctx):
    ctx = Context(nb_cores=1, device="cpu")
    try:
        for c, pool_cls in ((ctx, DTDTaskpool), (ref_ctx, RefPool)):
            tp = pool_cls(c, "nomesh")
            with pytest.raises(RuntimeError, match="capture"):
                tp.wait_mesh(None)
            tp.close()
    finally:
        ctx.fini(timeout=30)


def test_mesh_capture_gemm_straddles_blocks(pool, ref_ctx):
    """n = 272, ts = 16: 68 columns a y-block, so column tiles straddle the
    blocks (a tile belongs to the block of its first element), and kt = 17
    takes the chain body. Held to numpy and to the reference's
    ``wait_mesh``; the ranks' op counts sum to the window's ops (no
    scratch-only op, so none runs on more than one rank)."""
    n, ts = 272, 16
    a, b = _inputs(n, 27)
    res = pool.run(J.gemm, n, ts, a, b, 1, "pst")
    ref, _, _ = _ref_gemm(ref_ctx, "pst", n, ts, a, b)
    _same_on_every_rank(res, "C")
    got = res[0]["C"]
    np.testing.assert_allclose(got, a @ b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    plan = res[0]["plan"]
    counts = {r: len(v) for r, v in plan["ops"].items()}
    assert sum(counts.values()) == res[0]["nops"] == (n // ts) ** 2
    # rows 0-8 of the 17 tile rows start in the first x-block (136 rows),
    # tile columns 0-4, 5-8, 9-12 and 13-16 in the four y-blocks
    rows, cols = (9, 8), (5, 4, 4, 4)
    assert counts == {x * 4 + y: rows[x] * cols[y]
                      for x in range(2) for y in range(4)}


def test_chip_smoke_mesh_capture_phase_rehearses_on_the_cpu(pool, monkeypatch,
                                                            capsys):
    """Phase 17 of ``chip_smoke.py`` on this file's 8 CPU ranks at cut sizes
    (kt = 17 with tiles that straddle the y-blocks; POTRF on 8 x 8 tiles):
    every check of (a) and (b) holds; the CPU takes the chain's plain
    version, so no launch is counted."""
    import torch
    import chip_smoke as CS
    from parsec_tpu_torch.ops import cuda_kernels as K
    for k, v in dict(n=1088, ts=64, potrf_n=256, potrf_ts=32,
                     rank_bytes=1 << 28).items():
        monkeypatch.setitem(CS.MCAP, k, v)
    out = CS.mesh_capture(K, torch, "cpu rehearsal", pool, device="cpu")
    text = capsys.readouterr().out
    assert out["launches"] == 0
    assert "bit for bit the inline single-card DAG's" in text
    assert "cache_hit [True]" in text
    assert "no figure here is a scaling figure" in text
