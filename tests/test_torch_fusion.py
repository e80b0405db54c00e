"""Region fusion and the persistent program cache on the port
(``parsec_tpu_torch/dsl/fusion.py`` + the PTG lane's fusion pass): the
reference's tests/test_fusion.py on the port, on the CPU.

Layers:

* the fusion pass itself (``partition_regions``): unit shapes plus a
  randomized soundness harness — regions must be kind-homogeneous,
  size-bounded, and the condensed graph (regions + seams) must stay a DAG
  (a condensed cycle is a runtime deadlock);
* the C region support (``ptexec.cpp region_bind``): weighted
  completed/pending/done accounting, reset replay, misuse refusals;
* the randomized mixed fusable/un-fusable PTG parity harness, fusion on vs
  off (``--mca region_fusion 0/1``): identical completion sets, payloads
  bit-checked against a numpy replay, data versions, engagement counters;
* persistence: cold vs warm double instantiation hits the program cache
  (``cache_hits``) with identical results, and the flatten cache key
  separates placements;
* device regions: a ``[type=CUDA]`` GEMM fuses its k-chains into
  region-sized dispatches on the device lane (test mode over the CPU);
* DTD capture-defer fusion: a deferred window replays fused runs + seams
  with exact values and engagement counters.

Cross-checks run one program through both packages: the fused device GEMM
and one seed of the mixed DAG. (The reference's two tests of region events
in the native trace wait for the port's tracing.)
"""

import random

import numpy as np
import pytest

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core import costmodel
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.fusion import (CAPTURE_CACHE_STATS, ExecCache,
                                         partition_regions, topo_order)
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
from parsec_tpu_torch.utils import mca


@pytest.fixture(autouse=True)
def _fresh_cost_model():
    """The online cost model is process-global by design; every test here
    starts from a cold one (the reference resets its model per test in its
    conftest)."""
    costmodel.model.reset()
    yield
    costmodel.model.reset()


class pt:
    """The reference tests' ``pt.Context`` spelled for the port: a CPU
    context (the tests run without a card)."""

    @staticmethod
    def Context(nb_cores=1):
        return Context(nb_cores=nb_cores, device="cpu")


def _graph(*args):
    return native_mod.load_ptexec().Graph(*args)


# ------------------------------------------------------------ fusion pass

def _csr(n, edges):
    off = [0] * (n + 1)
    for u, _v in edges:
        off[u + 1] += 1
    for i in range(n):
        off[i + 1] += off[i]
    succs = [0] * len(edges)
    pos = list(off)
    for u, v in sorted(edges):
        succs[pos[u]] = v
        pos[u] += 1
    return off, succs


def test_partition_seam_splits_region():
    # A(cap) -> B(seam) -> C(cap), plus A -> C: fusing {A, C} would create
    # a condensed cycle region -> B -> region; the seam depth argument must
    # keep them apart (and singletons are not regions)
    off, succs = _csr(3, [(0, 1), (1, 2), (0, 2)])
    assert partition_regions(3, off, succs, ["cpu", None, "cpu"]) == []


def test_partition_chain_and_min_size():
    off, succs = _csr(4, [(0, 1), (1, 2), (2, 3)])
    assert partition_regions(4, off, succs, ["cpu"] * 4) == [[0, 1, 2, 3]]
    assert partition_regions(4, off, succs, ["cpu"] * 4, min_size=5) == []


def test_partition_kinds_never_mix():
    # interleaved kinds at the same depth stay separate (a dev->cpu->dev
    # sandwich fused by depth alone would deadlock)
    off, succs = _csr(4, [(0, 1), (1, 2), (2, 3)])
    regs = partition_regions(4, off, succs, ["cpu", "cpu", "dev", "dev"])
    assert sorted(map(sorted, regs)) == [[0, 1], [2, 3]]


def test_partition_max_size_chunks_are_contiguous():
    n = 10
    off, succs = _csr(n, [(i, i + 1) for i in range(n - 1)])
    regs = partition_regions(n, off, succs, ["cpu"] * n, max_size=4)
    assert [len(r) for r in regs] == [4, 4, 2]
    flat = [t for r in regs for t in r]
    assert flat == list(range(n))        # topo-contiguous chunks
    # a sub-min tail folds into its predecessor ONLY within max_size (the
    # hard program-size bound); otherwise it stays per-task
    regs = partition_regions(9, *_csr(9, [(i, i + 1) for i in range(8)]),
                             ["cpu"] * 9, max_size=4)
    assert [len(r) for r in regs] == [4, 4]      # tail of 1 left unfused
    regs = partition_regions(7, *_csr(7, [(i, i + 1) for i in range(6)]),
                             ["cpu"] * 7, min_size=3, max_size=4)
    assert all(len(r) <= 4 for r in regs)


def _condensed_is_dag(n, off, succs, regions):
    reg_of = {}
    for ri, members in enumerate(regions):
        for m in members:
            reg_of[m] = ri

    def node_of(t):
        return ("r", reg_of[t]) if t in reg_of else ("t", t)

    cedges = set()
    cnodes = {node_of(t) for t in range(n)}
    for u in range(n):
        for k in range(off[u], off[u + 1]):
            a, b = node_of(u), node_of(succs[k])
            if a != b:
                cedges.add((a, b))
    indeg = {c: 0 for c in cnodes}
    for _a, b in cedges:
        indeg[b] += 1
    from collections import deque
    q = deque(c for c, d in indeg.items() if d == 0)
    seen = 0
    adj = {}
    for a, b in cedges:
        adj.setdefault(a, []).append(b)
    while q:
        c = q.popleft()
        seen += 1
        for b in adj.get(c, ()):
            indeg[b] -= 1
            if indeg[b] == 0:
                q.append(b)
    return seen == len(cnodes)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_partition_randomized_soundness(seed):
    """Random DAGs x random kind assignments: every region is kind-
    homogeneous and size-bounded, members cover no seam, and the condensed
    graph stays acyclic (the deadlock-freedom invariant)."""
    rng = random.Random(seed)
    n = rng.randrange(20, 120)
    edges = []
    for v in range(1, n):
        for _ in range(rng.randrange(0, 4)):
            edges.append((rng.randrange(0, v), v))
    off, succs = _csr(n, edges)
    kind = [rng.choice(["cpu", "dev", None, "cpu"]) for _ in range(n)]
    mx = rng.choice([4, 16, 128])
    regions = partition_regions(n, off, succs, kind, min_size=2,
                                max_size=mx)
    seen = set()
    t_ix = {t: i for i, t in enumerate(topo_order(n, off, succs))}
    for members in regions:
        assert 2 <= len(members) <= mx      # max_size is a HARD bound
        kinds = {kind[m] for m in members}
        assert len(kinds) == 1 and None not in kinds
        assert not (seen & set(members))
        seen |= set(members)
        # members arrive in topological order (a valid serialization)
        assert [t_ix[m] for m in members] == sorted(t_ix[m]
                                                    for m in members)
    assert _condensed_is_dag(n, off, succs, regions)


# ----------------------------------------------------- C region support

def test_region_bind_weighted_accounting():
    # diamond 0 -> {1, 2} -> 3 where node 1 stands for 3 fused tasks
    g = _graph([0, 1, 1, 2], [0, 2, 3, 4, 4], [1, 2, 3, 3])
    assert g.region_bind([1, 3, 1, 1]) == 6
    for _ in range(2):                    # reset replays weighted
        order = []
        assert g.run(order.extend, 256, 0) == 6
        assert g.done() and g.pending() == 0
        pos = {t: i for i, t in enumerate(order)}
        assert pos[0] < pos[1] and pos[0] < pos[2] and \
            pos[1] < pos[3] and pos[2] < pos[3]
        rs = g.region_stats()
        assert rs["fused_regions"] == 1 and rs["fused_tasks"] == 3 \
            and rs["weighted_total"] == 6
        g.reset()


def test_region_bind_validation():
    g = _graph([0, 1], [0, 1, 1], [1])
    with pytest.raises(ValueError):
        g.region_bind([1])                # wrong length
    with pytest.raises(ValueError):
        g.region_bind([1, 0])             # weight < 1
    g.run(None, 256, 0)
    with pytest.raises(RuntimeError):
        g.region_bind([1, 2])             # already ran


# ------------------------------------- randomized mixed-DAG PTG parity

_MIX_SRC = """%global N
%global DA
%global DB
%global C
%global E
%global M
%global IC
%global descX
%global descY
A(i, l)
  i = 0 .. N-1
  l = 0 .. DA-1
  RW X <- (l == 0) ? descX(0, i) : X A(i, l-1)
       -> (l < DA-1) ? X A(i, l+1) : X B(i, 0)
       -> (l < DA-1 and i % M == 0) ? Y A(((C*i+E) % N), l+1)
  READ Y <- (l > 0 and ((IC*(i-E)) % N) % M == 0) ? X A(((IC*(i-E)) % N), l-1)
  CTL S -> (l == DA-1) ? S SEAM(i)
BODY
  X = (X * 2.0 + 1.0) if Y is None else (X * 2.0 + Y)
END

SEAM(i)
  i = 0 .. N-1
  CTL S <- S A(i, DA-1)
        -> S B(i, 0)
BODY
  j = i * 2
END

B(i, l)
  i = 0 .. N-1
  l = 0 .. DB-1
  RW X <- (l == 0) ? X A(i, DA-1) : X B(i, l-1)
       -> (l < DB-1) ? X B(i, l+1) : descY(0, i)
  CTL S <- (l == 0) ? S SEAM(i)
BODY
  X = X + 3.0
END
"""


def _mix_params(seed):
    import math
    rng = random.Random(seed)
    N = rng.choice([4, 6, 8])
    C = rng.choice([c for c in range(1, N) if math.gcd(c, N) == 1])
    return dict(N=N, DA=rng.randrange(2, 5), DB=rng.randrange(2, 4),
                C=C, E=rng.randrange(N), M=rng.randrange(2, 4),
                IC=pow(C, -1, N))


def _mix_expected(p, init):
    """Pure-numpy replay of _MIX_SRC (exact in f32: small integers)."""
    N, DA, DB, E, M, IC = (p[k] for k in ("N", "DA", "DB", "E", "M",
                                          "IC"))
    a = [[0.0] * DA for _ in range(N)]
    for l in range(DA):
        for i in range(N):
            xin = init[i] if l == 0 else a[i][l - 1]
            j = (IC * (i - E)) % N
            y = a[j][l - 1] if (l > 0 and j % M == 0) else None
            a[i][l] = xin * 2.0 + 1.0 if y is None else xin * 2.0 + y
    return [a[i][DA - 1] + 3.0 * DB for i in range(N)]


def _run_mix(params, fusion: bool):
    mca.set("region_fusion", bool(fusion))
    ctx = pt.Context(nb_cores=1)
    try:
        N = params["N"]
        X = TiledMatrix("descX", 1, N, 1, 1)
        X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
        Y = TiledMatrix("descY", 1, N, 1, 1)
        prog = compile_ptg(_MIX_SRC, "mix")
        snap = PTEXEC_STATS.snapshot()
        tp = prog.instantiate(ctx, globals=dict(params),
                              collections={"descX": X, "descY": Y})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        assert tp._ptexec_state is not None, "lane should have engaged"
        assert tp._ptexec_state["graph"].done()
        d = PTEXEC_STATS.delta(snap)
        return {
            "executed": sum(s.nb_executed for s in ctx.streams),
            "finals": [float(np.asarray(
                Y.data_of(0, i).newest_copy().payload)[0, 0])
                for i in range(N)],
            "versions": [Y.data_of(0, i).version for i in range(N)],
            "delta": d,
        }
    finally:
        mca.params.unset("region_fusion")
        ctx.fini()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixed_dag_fusion_parity(seed):
    """The randomized mixed fusable/un-fusable harness: fusion on vs off
    produce the identical completion count, bit-exact payloads (checked
    against a numpy replay, tolerance 0), and identical data versions; with
    fusion ON the engagement counters prove regions actually fused and the
    seams still ran per task."""
    params = _mix_params(seed)
    N = params["N"]
    ntasks = N * (params["DA"] + params["DB"] + 1)
    on = _run_mix(params, fusion=True)
    off = _run_mix(params, fusion=False)
    assert on["executed"] == off["executed"] == ntasks
    assert on["finals"] == off["finals"]
    assert on["versions"] == off["versions"]
    expect = _mix_expected(params, [float(i) for i in range(N)])
    assert on["finals"] == pytest.approx(expect, rel=0, abs=0)
    d_on, d_off = on["delta"], off["delta"]
    assert d_on["fused_regions"] >= 1
    assert d_on["fused_tasks"] >= 2
    assert d_on["fused_tasks"] + d_on["seam_tasks"] == ntasks
    assert d_on["seam_tasks"] >= N            # every SEAM stays per-task
    assert d_on["pools_fallback"] == 0
    assert d_off["fused_regions"] == 0 and d_off["fused_tasks"] == 0


def test_cold_vs_warm_double_instantiation():
    """Persistence: the SAME program object instantiated twice — the second
    instantiation hits the program cache (no region program built again)
    and produces identical results."""
    params = _mix_params(11)
    N = params["N"]
    prog = compile_ptg(_MIX_SRC, "mix-warm")
    expect = _mix_expected(params, [float(i) for i in range(N)])
    hits = []
    for _rep in range(2):
        ctx = pt.Context(nb_cores=1)
        try:
            X = TiledMatrix("descX", 1, N, 1, 1)
            X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
            Y = TiledMatrix("descY", 1, N, 1, 1)
            snap = CAPTURE_CACHE_STATS.snapshot()
            tp = prog.instantiate(ctx, globals=dict(params),
                                  collections={"descX": X, "descY": Y})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
            assert tp._ptexec_state is not None
            d = CAPTURE_CACHE_STATS.delta(snap)
            hits.append((d["cache_hits"], d["cache_misses"]))
            finals = [float(np.asarray(
                Y.data_of(0, i).newest_copy().payload)[0, 0])
                for i in range(N)]
            assert finals == pytest.approx(expect, rel=0, abs=0)
        finally:
            ctx.fini()
    cold, warm = hits
    assert cold[0] == 0 and cold[1] >= 1, hits      # cold: misses only
    assert warm[0] >= 1 and warm[1] == 0, hits      # warm: all hits


def test_flatten_cache_key_separates_placements():
    """The flatten/CSR cache key includes the device placement —
    re-instantiating the same program under a different placement (device
    lane on vs off) must not replay the cached fused CSR against the wrong
    layout."""
    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, 0) : X T(k-1)\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, 1)\n"
           "BODY [type=CUDA]\n  X = X + 1.0\nEND\n")
    prog = compile_ptg(src, "place")

    def run(over_cpu: bool):
        if over_cpu:
            mca.set("device_cuda_over_cpu", True)
        ctx = pt.Context(nb_cores=1)
        try:
            A = TiledMatrix("descA", 1, 2, 1, 1)
            A.fill(lambda m, k: np.zeros((1, 1), np.float32))
            tp = prog.instantiate(ctx, globals={"NT": 4},
                                  collections={"descA": A})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            assert tp._ptexec_state is not None
            dev_bound = tp._ptexec_state.get("dev_pool") is not None
            out = float(np.asarray(
                A.data_of(0, 1).newest_copy().payload)[0, 0])
            return out, dev_bound
        finally:
            ctx.fini()
            mca.params.unset("device_cuda_over_cpu")

    out_cpu, dev_cpu = run(over_cpu=False)
    assert out_cpu == 4.0 and not dev_cpu
    out_dev, dev_dev = run(over_cpu=True)
    assert out_dev == 4.0 and dev_dev
    # two placements, two cache entries — never one reused unsafely
    assert len(prog._ptexec_cache) == 2
    keys = list(prog._ptexec_cache)
    assert keys[0] != keys[1]


_GEMM_SRC = ("%global MT\n%global KT\n%global descA\n%global descB\n"
             "%global descC\n"
             "GEMM(m, n, k)\n  m = 0 .. MT-1\n  n = 0 .. MT-1\n"
             "  k = 0 .. KT-1\n  : descC(m, n)\n"
             "  READ A <- descA(m, k)\n  READ B <- descB(k, n)\n"
             "  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)\n"
             "       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)\n"
             "BODY [type=CUDA]\n"
             "  C = C + torch.matmul(A, B)\nEND\n")


def _fused_gemm(a, b, n, ts):
    """The fused device GEMM on the port, over the CPU test mode: (C, the
    PTEXEC_STATS delta, the graph's dev_stats and region_stats)."""
    mca.set("device_cuda_over_cpu", True)
    ctx = pt.Context(nb_cores=1)
    try:
        A = TiledMatrix("frA", n, n, ts, ts)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        B = TiledMatrix("frB", n, n, ts, ts)
        B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        C = TiledMatrix("frC", n, n, ts, ts)
        C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
        snap = PTEXEC_STATS.snapshot()
        tp = compile_ptg(_GEMM_SRC, "fr-gemm").instantiate(
            ctx, globals={"MT": n // ts, "KT": n // ts},
            collections={"descA": A, "descB": B, "descC": C})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        assert tp._ptexec_state is not None and \
            tp._ptexec_state.get("dev_pool") is not None
        assert ctx._ptdev.failed() is None
        g = tp._ptexec_state["graph"]
        return (C.to_dense(), PTEXEC_STATS.delta(snap), g.dev_stats(),
                g.region_stats())
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")


def test_device_region_fusion_parity():
    """Device regions: a ``[type=CUDA]`` GEMM pool fuses its k-chains into
    region-sized ptdev dispatches — right against numpy (max abs error <
    1e-2, the reference's tolerance), task-denominated device accounting,
    and engagement counters."""
    n, ts = 64, 16
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    c, d, gs, rs = _fused_gemm(a, b, n, ts)
    nt = (n // ts) ** 3
    err = float(np.abs(c - a @ b).max())
    assert err < 1e-2, f"fused device GEMM wrong: {err}"
    assert d["fused_regions"] >= 1 and d["pools_fallback"] == 0
    assert gs["dev_tx"] == gs["dev_done"] == nt and gs["dev_bad"] == 0, gs
    assert rs["fused_tasks"] >= 2 and rs["weighted_total"] == nt


# -------------------------------------------------- DTD capture fusion

def test_dtd_defer_fusion_values_and_counters():
    """A deferred capture window replays its capturable prefix as fused
    super-task inserts: exact values, one region per maximal run, and the
    seam (the non-capturable trigger) still runs on its own."""
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, PTDTD_STATS, RW
    ctx = pt.Context(nb_cores=1)
    try:
        tp = DTDTaskpool(ctx, "defer-fuse", capture=True)
        t = tp.tile_new(np.zeros((4, 4), np.float32), key="t")

        def add1(x):
            return x + 1.0

        def mul2(x):
            return x * 2.0

        side = []

        def tricky(x):
            side.append(1)
            return x + 3.0

        snap = PTDTD_STATS.snapshot()
        for _ in range(6):
            tp.insert_task(add1, (t, RW))
            tp.insert_task(mul2, (t, RW))
        tp.insert_task(tricky, (t, RW), jit=False)   # defers the window
        tp.wait()
        tp.close()
        ctx.wait(timeout=30)
        d = PTDTD_STATS.delta(snap)
        x = 0.0
        for _ in range(6):
            x = (x + 1.0) * 2.0
        x += 3.0
        assert float(np.asarray(t.data.newest_copy().payload)[0, 0]) == x
        assert d["capture_windows_deferred"] == 1, d
        assert d["capture_regions_fused"] == 1, d
        assert d["capture_tasks_fused"] == 12, d
        assert side == [1]
    finally:
        ctx.fini()


def test_dtd_defer_fusion_splits_on_priority_and_where():
    """Fusable runs break on non-default placement/priority: those inserts
    keep their own task so the scheduler still honors them."""
    from parsec_tpu_torch.core.task import DEV_CPU
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, PTDTD_STATS, RW
    ctx = pt.Context(nb_cores=1)
    try:
        tp = DTDTaskpool(ctx, "defer-split", capture=True)
        t = tp.tile_new(np.zeros((2, 2), np.float32), key="t")

        def add1(x):
            return x + 1.0

        snap = PTDTD_STATS.snapshot()
        for _ in range(3):
            tp.insert_task(add1, (t, RW))
        tp.insert_task(add1, (t, RW), where=DEV_CPU)      # splits the run
        for _ in range(3):
            tp.insert_task(add1, (t, RW))
        tp.insert_task(lambda x: x * 1.0, (t, RW), jit=False)
        tp.wait()
        tp.close()
        ctx.wait(timeout=30)
        d = PTDTD_STATS.delta(snap)
        assert float(np.asarray(t.data.newest_copy().payload)[0, 0]) == 7.0
        assert d["capture_regions_fused"] == 2, d
        assert d["capture_tasks_fused"] == 6, d
    finally:
        ctx.fini()


def test_dtd_defer_fusion_off():
    """--mca region_fusion 0 restores the pure per-task defer replay."""
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, PTDTD_STATS, RW
    mca.set("region_fusion", False)
    ctx = pt.Context(nb_cores=1)
    try:
        tp = DTDTaskpool(ctx, "defer-off", capture=True)
        t = tp.tile_new(np.zeros((2, 2), np.float32), key="t")

        def add1(x):
            return x + 1.0

        snap = PTDTD_STATS.snapshot()
        for _ in range(4):
            tp.insert_task(add1, (t, RW))
        tp.insert_task(lambda x: x * 1.0, (t, RW), jit=False)
        tp.wait()
        tp.close()
        ctx.wait(timeout=30)
        d = PTDTD_STATS.delta(snap)
        assert float(np.asarray(t.data.newest_copy().payload)[0, 0]) == 4.0
        assert d["capture_regions_fused"] == 0 and \
            d["capture_tasks_fused"] == 0, d
    finally:
        mca.params.unset("region_fusion")
        ctx.fini()


def test_capture_cache_counters_warm_pool():
    """Two captured pools of the same DAG shape: the second hits the
    persistent program cache (``cache_hits``) — the warm-pool contract."""
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
    ctx = pt.Context(nb_cores=1)
    try:
        def body(x):
            return x * 2.0 + 1.0

        hits = []
        for rep in range(2):
            snap = CAPTURE_CACHE_STATS.snapshot()
            tp = DTDTaskpool(ctx, f"warm-{rep}", capture=True)
            t = tp.tile_new(np.full((4, 4), 1.0, np.float32),
                            key=f"t{rep}")
            for _ in range(5):
                tp.insert_task(body, (t, RW))
            tp.wait()
            tp.close()
            ctx.wait(timeout=30)
            d = CAPTURE_CACHE_STATS.delta(snap)
            hits.append((d["cache_hits"], d["cache_misses"]))
            x = 1.0
            for _ in range(5):
                x = x * 2.0 + 1.0
            assert float(np.asarray(
                t.data.newest_copy().payload)[0, 0]) == x
        assert hits[0] == (0, 1), hits       # cold: one program built
        assert hits[1] == (1, 0), hits       # warm: the cached program
    finally:
        ctx.fini()


def test_exec_cache_lru_eviction_counted():
    stats = {"cache_hits": 0, "cache_misses": 0, "cache_evictions": 0}
    c = ExecCache(2, stats=stats)
    for k in ("a", "b", "c"):
        v, hit = c.get_or_build(k, lambda k=k: k.upper())
        assert v == k.upper() and not hit
    assert stats["cache_evictions"] == 1 and len(c._d) == 2
    _v, hit = c.get_or_build("c", lambda: "X")
    assert hit and _v == "C"
    # None key: uncacheable — builds fresh, counted as a miss
    v, hit = c.get_or_build(None, lambda: "fresh")
    assert v == "fresh" and not hit
    assert stats["cache_misses"] == 4


# ------------------------------------------- cross-checks: both packages

def test_cross_check_fused_device_gemm_against_reference():
    """The fused device GEMM of the reference's
    ``test_device_region_fusion_parity`` (n = 64, ts = 16) through both
    packages: the reference over its CPU test device
    (``device_tpu_over_cpu``, jitted region programs), the port over its
    (``device_cuda_over_cpu``, eager region programs on the device lane).
    Both fuse, and the port's C is held to the reference's at the
    reference test's tolerance (max abs difference < 1e-2)."""
    import parsec_tpu as ref
    from parsec_tpu.data.matrix import TiledMatrix as RefTiled
    from parsec_tpu.dsl.ptg.compiler import PTEXEC_STATS as REF_STATS
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    from parsec_tpu.utils import mca as ref_mca
    n, ts = 64, 16
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref_src = _GEMM_SRC.replace("type=CUDA", "type=TPU").replace(
        "torch.matmul(A, B)",
        "jnp.dot(A, B, preferred_element_type=jnp.float32)")
    ref_mca.set("device_tpu_over_cpu", True)
    rctx = ref.Context(nb_cores=1)
    try:
        A = RefTiled("frA", n, n, ts, ts)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        B = RefTiled("frB", n, n, ts, ts)
        B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        C = RefTiled("frC", n, n, ts, ts)
        C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
        snap = REF_STATS.snapshot()
        tp = ref_compile(ref_src, "fr-gemm").instantiate(
            rctx, globals={"MT": n // ts, "KT": n // ts},
            collections={"descA": A, "descB": B, "descC": C})
        rctx.add_taskpool(tp)
        rctx.wait(timeout=120)
        assert REF_STATS.delta(snap)["fused_regions"] >= 1
        want = np.asarray(C.to_dense())
    finally:
        rctx.fini()
        ref_mca.params.unset("device_tpu_over_cpu")
    got, d, _gs, rs = _fused_gemm(a, b, n, ts)
    assert d["fused_regions"] >= 1 and rs["weighted_total"] == (n // ts) ** 3
    err = float(np.abs(got - want).max())
    assert err < 1e-2, f"port vs reference fused GEMM: {err}"


def test_cross_check_mixed_dag_fusion_against_reference():
    """``test_mixed_dag_fusion_parity``'s DAG for one seed through both
    packages with fusion on: bit-identical payloads and data versions
    (small integers: exact in f32), the same task and fused-task counts."""
    import parsec_tpu as ref
    from parsec_tpu.data.matrix import TiledMatrix as RefTiled
    from parsec_tpu.dsl.ptg.compiler import PTEXEC_STATS as REF_STATS
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    params = _mix_params(2)
    N = params["N"]
    rctx = ref.Context(nb_cores=1)
    try:
        X = RefTiled("descX", 1, N, 1, 1)
        X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
        Y = RefTiled("descY", 1, N, 1, 1)
        snap = REF_STATS.snapshot()
        tp = ref_compile(_MIX_SRC, "mix").instantiate(
            rctx, globals=dict(params), collections={"descX": X, "descY": Y})
        rctx.add_taskpool(tp)
        rctx.wait(timeout=120)
        rd = REF_STATS.delta(snap)
        finals = [float(np.asarray(Y.data_of(0, i).newest_copy().payload)
                        [0, 0]) for i in range(N)]
        versions = [Y.data_of(0, i).version for i in range(N)]
        executed = sum(s.nb_executed for s in rctx.streams)
    finally:
        rctx.fini()
    on = _run_mix(params, fusion=True)
    assert on["finals"] == finals and on["versions"] == versions
    assert on["executed"] == executed
    for k in ("fused_regions", "fused_tasks", "seam_tasks"):
        assert on["delta"][k] == rd[k], k
