"""The port's native PTG execution lane (``parsec_tpu_torch/csrc/
ptexec.cpp`` + the compiler's flatten/classify wiring): the reference's
``tests/test_ptexec.py`` on the port, plus cross-checks against the
reference and the port's own gates (the device decline, the MCA knobs
that are not ported yet, the cache key, the plane binding).

Three layers:

* raw Graph semantics on the C extension (release edges, replay reset,
  budget bursts, callback-error poisoning);
* randomized-DAG parity: the SAME PTG program runs with the lane on and
  off, and both executions must produce the identical completion set with
  every release edge respected in the observed body order (the
  "bit-identical release semantics" contract of the lane);
* runtime integration: eligibility fallbacks, multi-worker chain drain.
"""

import math
import random

import numpy as np
import pytest

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
from parsec_tpu_torch.utils import mca


class pt:
    """The reference tests' ``pt.Context`` spelled for the port: a CPU
    context (the tests run without a card)."""

    @staticmethod
    def Context(nb_cores=1):
        return Context(nb_cores=nb_cores, device="cpu")


def _graph(*args):
    return native_mod.load_ptexec().Graph(*args)


# ------------------------------------------------------------------ raw graph

def test_graph_diamond_order_and_replay():
    # 0 -> {1, 2} -> 3
    g = _graph([0, 1, 1, 2], [0, 2, 3, 4, 4], [1, 2, 3, 3])
    for _ in range(3):                     # replay via reset()
        order = []
        assert g.run(order.extend, 256, 0) == 4
        assert g.done() and g.pending() == 0
        pos = {t: i for i, t in enumerate(order)}
        assert pos[0] < pos[1] and pos[0] < pos[2]
        assert pos[1] < pos[3] and pos[2] < pos[3]
        g.reset()


def test_graph_budget_bursts():
    """budget>0 returns mid-graph; repeated calls finish the walk — the
    burst handoff the hot loop relies on to interleave other work."""
    n = 100
    goals = [0] + [1] * (n - 1)            # one long chain
    off = list(range(n)) + [n - 1]
    succs = list(range(1, n))
    g = _graph(goals, off, succs)
    total = 0
    calls = 0
    while not g.done():
        total += g.run(None, 8, 10)
        calls += 1
        assert calls < 1000
    assert total == n and calls > 1


def test_graph_callback_error_poisons():
    g = _graph([0, 1], [0, 1, 1], [1])

    def boom(ids):
        raise ValueError("body failed")

    with pytest.raises(ValueError):
        g.run(boom, 256, 0)
    assert g.failed() and not g.done()
    g.reset()                              # reset clears the poison
    assert g.run(None, 256, 0) == 2 and g.done()


def test_graph_structural_validation():
    with pytest.raises(ValueError):
        _graph([0, 0], [0, 1], [1])        # succ_off must have n+1 entries
    with pytest.raises(ValueError):
        _graph([0, 0], [0, 1, 1], [7])     # successor id out of range
    with pytest.raises(ValueError):
        _graph([0, -1], [0, 0, 0], [])     # negative goal
    with pytest.raises(ValueError):
        _graph([0, 0], [0, 0, 0], [], [1])          # prio must have n entries
    with pytest.raises(TypeError):
        _graph([0], [0, 0], [], None, [0, 0])       # in_off needs slots/uses
    with pytest.raises(ValueError):
        _graph([0], [0, 0], [], None, [0, 1], [5], [1])  # slot id range


def test_graph_priority_heap_pops_highest_first():
    """Independent ready tasks pop in priority order (the ready heap): a
    maximal-priority ready task always dispatches first."""
    g = _graph([0, 0, 0, 0], [0, 0, 0, 0, 0], [], [1, 5, 3, 9])
    order = []
    assert g.run(order.extend, 256, 0) == 4 and g.done()
    assert order == [3, 1, 2, 0]
    # released work re-enters the heap: 0 releases {1(p1), 2(p9)}; 2 first
    g2 = _graph([0, 1, 1], [0, 2, 2, 2], [1, 2], [0, 1, 9])
    order2 = []
    g2.run(order2.extend, 1, 0)            # batch=1: strict pop order
    assert order2 == [0, 2, 1]


def test_graph_data_mode_slot_retire_protocol():
    """The usagelmt/usagecnt protocol in the lane: a slot retires after
    its LAST consumer's callback returned, and the retired ids are handed
    to the next dispatch; slot_stats() counts the retires; reset()
    rewinds the counters."""
    # chain 0 -> 1 -> 2; slot per task; task i+1 consumes slot i
    calls = []

    def cb(ids, retired):
        calls.append((list(ids), list(retired)))

    g = _graph([0, 1, 1], [0, 1, 2, 2], [1, 2],
               None, [0, 0, 1, 2], [0, 1], [1, 1, 0])
    for _ in range(2):                     # and once more after reset()
        calls.clear()
        assert g.run(cb, 1, 0) == 3 and g.done()
        # slot 0 retires after task 1 ran; delivered with task 2's batch
        assert calls == [([0], []), ([1], []), ([2], [0])]
        assert g.slot_stats() == (3, 2)    # slot 2 is terminal (0 uses)
        g.reset()


def test_graph_data_mode_requires_callback():
    g = _graph([0], [0, 0], [], None, [0, 0], [], [0, 0])
    with pytest.raises(TypeError):
        g.run(None, 256, 0)


# -------------------------------------------------------- randomized parity

_RND_SRC = """%global N
%global D
%global A
%global B
%global C
%global E
%global M
%global IA
%global IC
%global rec
SRC(i)
  i = 0 .. N-1
  CTL S -> X T(((A*i+B) % N), 0)
BODY
  rec(('SRC', i))
END

T(i, l)
  i = 0 .. N-1
  l = 0 .. D-1
  CTL X <- (l == 0) ? S SRC(((IA*(i-B)) % N)) : X T(i, l-1)
        -> (l < D-1) ? X T(i, l+1)
  CTL Y <- (l > 0 and ((IC*(i-E)) % N) % M == 0) ? Y T(((IC*(i-E)) % N), l-1)
        -> (l < D-1 and i % M == 0) ? Y T(((C*i+E) % N), l+1)
BODY
  rec(('T', i, l))
END
"""


def _rand_shape(seed):
    rng = random.Random(seed)
    N = rng.choice([8, 12, 16, 20])
    D = rng.randrange(3, 7)
    coprimes = [c for c in range(1, N) if math.gcd(c, N) == 1]
    A, C = rng.choice(coprimes), rng.choice(coprimes)
    B, E = rng.randrange(N), rng.randrange(N)
    M = rng.randrange(2, 5)
    return dict(N=N, D=D, A=A, B=B, C=C, E=E, M=M,
                IA=pow(A, -1, N), IC=pow(C, -1, N))


def _expected_edges(p):
    N, D, A, B, C, E, M = (p[k] for k in "NDABCEM")
    edges = [(("SRC", i), ("T", (A * i + B) % N, 0)) for i in range(N)]
    for i in range(N):
        for l in range(D - 1):
            edges.append((("T", i, l), ("T", i, l + 1)))
            if i % M == 0:
                edges.append((("T", i, l), ("T", (C * i + E) % N, l + 1)))
    return edges


def _run_dag(params, native: bool, nb_cores: int = 1):
    order = []
    ctx = pt.Context(nb_cores=nb_cores)
    try:
        if not native:
            mca.set("ptg_native_exec", False)
        prog = compile_ptg(_RND_SRC, "rnd")
        tp = prog.instantiate(ctx, globals=dict(params, rec=order.append),
                              collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        if native:
            assert tp._ptexec_state is not None, "lane should have engaged"
            assert tp._ptexec_state["graph"].done()
        else:
            assert tp._ptexec_state is None, "lane should have been off"
    finally:
        if not native:
            mca.params.unset("ptg_native_exec")
        ctx.fini()
    return order


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_randomized_dag_parity(seed):
    """Native lane vs Python FSM on the same randomized DAG: identical
    completion sets, no duplicates, and every release edge respected in
    the observed body execution order — in BOTH modes."""
    params = _rand_shape(seed)
    expected = {("SRC", i) for i in range(params["N"])} | \
        {("T", i, l) for i in range(params["N"]) for l in range(params["D"])}
    edges = _expected_edges(params)
    orders = {m: _run_dag(params, native=m) for m in (True, False)}
    for mode, order in orders.items():
        assert len(order) == len(expected), f"mode={mode}: dup/lost tasks"
        assert set(order) == expected, f"mode={mode}: wrong completion set"
        pos = {t: i for i, t in enumerate(order)}
        for pred, succ in edges:
            assert pos[pred] < pos[succ], \
                f"mode={mode}: release edge {pred}->{succ} violated"


def test_flatten_cache_replay_parity():
    """Same program object, same globals, three instantiations: the cached
    flattened graph replays (reset) with full parity every time."""
    params = _rand_shape(99)
    expected_n = params["N"] * (1 + params["D"])
    prog = compile_ptg(_RND_SRC, "rnd-cache")
    ctx = pt.Context(nb_cores=1)
    try:
        for rep in range(3):
            order = []
            tp = prog.instantiate(ctx, globals=dict(params,
                                                    rec=order.append),
                                  collections={})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
            assert tp._ptexec_state is not None
            assert len(order) == expected_n and len(set(order)) == expected_n
    finally:
        ctx.fini()


# ---------------------------------------------- randomized DATA-flow parity

_RND_DATA_SRC = """%global N
%global D
%global A
%global B
%global C
%global E
%global M
%global IA
%global IC
%global descX
%global descY
SRC(i)
  i = 0 .. N-1
  RW X <- descX(0, i)
       -> X T(((A*i+B) % N), 0)
BODY
  X = X + 1.0
END

T(i, l)
  i = 0 .. N-1
  l = 0 .. D-1
  priority = i + 3*l
  RW X <- (l == 0) ? X SRC(((IA*(i-B)) % N)) : X T(i, l-1)
       -> (l < D-1) ? X T(i, l+1) : descY(0, i)
       -> (l < D-1 and i % M == 0) ? Y T(((C*i+E) % N), l+1)
  READ Y <- (l > 0 and ((IC*(i-E)) % N) % M == 0) ? X T(((IC*(i-E)) % N), l-1)
BODY
  X = (X * 2.0 + 1.0) if Y is None else (X * 2.0 + Y)
END
"""
# NOTE: write-backs land in descY, not descX — SRC(i)'s memory read and a
# same-tile write-back would have NO ordering edge, so execution order
# (which the lane's priority heap legitimately changes) would become
# value-visible: a program race, not a runtime property.


def _expected_data_values(p, init):
    """Pure-numpy replay of _RND_DATA_SRC (exact in f32: small integers)."""
    N, D, A, B, C, E, M = (p[k] for k in "NDABCEM")
    IA, IC = p["IA"], p["IC"]
    xs = [init[i] + 1.0 for i in range(N)]          # SRC outputs
    x = [[0.0] * D for _ in range(N)]
    for l in range(D):
        for i in range(N):
            xin = xs[(IA * (i - B)) % N] if l == 0 else x[i][l - 1]
            j = (IC * (i - E)) % N
            y = x[j][l - 1] if (l > 0 and j % M == 0) else None
            x[i][l] = xin * 2.0 + 1.0 if y is None else xin * 2.0 + y
    return [x[i][D - 1] for i in range(N)]          # written back to descY


def _run_data_dag(params, native: bool):
    ctx = pt.Context(nb_cores=1)
    stats = {}
    try:
        if not native:
            mca.set("ptg_native_exec", False)
        else:
            # region fusion pinned OFF here, as in the reference: this
            # harness asserts the PER-TASK slot-retire protocol, which
            # fusion legitimately changes (internal consumption never hits
            # the protocol); the fused variant is in test_torch_fusion.py
            mca.set("region_fusion", False)
        X = TiledMatrix("descX", 1, params["N"], 1, 1)
        X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
        Y = TiledMatrix("descY", 1, params["N"], 1, 1)
        prog = compile_ptg(_RND_DATA_SRC, "rnd-data")
        tp = prog.instantiate(ctx, globals=dict(params),
                              collections={"descX": X, "descY": Y})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=120)
        if native:
            assert tp._ptexec_state is not None, "lane should have engaged"
            g = tp._ptexec_state["graph"]
            assert g.done()
            stats["slot_stats"] = g.slot_stats()
        else:
            assert tp._ptexec_state is None, "lane should have been off"
        stats["executed"] = sum(s.nb_executed for s in ctx.streams)
        stats["finals"] = [float(np.asarray(
            Y.data_of(0, i).newest_copy().payload)[0, 0])
            for i in range(params["N"])]
        stats["versions"] = [Y.data_of(0, i).version
                             for i in range(params["N"])]
        stats["repos"] = {tp._classes[n].task_class_id: (
            len(tp.repos[tp._classes[n].task_class_id]),
            tp.repos[tp._classes[n].task_class_id].retired)
            for n in ("SRC", "T")}
    finally:
        mca.params.unset("ptg_native_exec")
        mca.params.unset("region_fusion")
        ctx.fini()
    return stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_data_dag_parity(seed):
    """The SAME randomized DATA-flow PTG program (RW/READ flows, guarded
    cross-chain reads, memory reads + write-backs, priority-annotated
    classes) with the lane forced on vs off: identical completion counts,
    identical final payloads and data versions, and matching repo-retire
    accounting — lane-off retires its repo entries, lane-on retires the
    same count of data slots while leaving every repo untouched."""
    params = _rand_shape(seed)
    n, d = params["N"], params["D"]
    on = _run_data_dag(params, native=True)
    off = _run_data_dag(params, native=False)
    ntasks = n + n * d
    assert on["executed"] == off["executed"] == ntasks
    assert on["finals"] == off["finals"], "payload divergence lane on/off"
    assert on["versions"] == off["versions"]
    # numpy replay cross-check (exact in f32)
    expect = _expected_data_values(params,
                                   [float(i) for i in range(n)])
    assert on["finals"] == pytest.approx(expect, rel=0, abs=0)
    # repo accounting: the Python FSM retires every consumed entry (only
    # terminal T(i, D-1) entries, which no task consumes, stay resident);
    # the lane keeps all repos untouched and retires the same number of
    # data slots in C instead
    for _tcid, (live, retired) in on["repos"].items():
        assert live == 0 and retired == 0, "lane must bypass the repos"
    off_retired = sum(r for (_l, r) in off["repos"].values())
    assert off_retired == n + n * (d - 1)
    n_slots, slots_retired = on["slot_stats"]
    assert n_slots == n + 2 * n * d            # one per (task, data flow)
    assert slots_retired == off_retired


# --------------------------------------------------------------- integration

def test_lane_multiworker_chain_smoke():
    """nb_cores=4 drains one empty-body chain DAG through the lane with
    every stream eligible to join the GIL-free walk; the graph completes
    and the per-stream execution counts add up."""
    src = ("%global NT\n%global DEPTH\n"
           "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. DEPTH-1\n"
           "  CTL S <- (l > 0) ? S T(i, l-1)\n"
           "        -> (l < DEPTH-1) ? S T(i, l+1)\nBODY\n  pass\nEND\n")
    nt, depth = 512, 32
    ctx = pt.Context(nb_cores=4)
    try:
        prog = compile_ptg(src, "mt-chain")
        tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                              collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None
        assert tp._ptexec_state["graph"].done()
    finally:
        ctx.fini()
    # read after fini: a worker whose run() walked the last task may add
    # its count after another stream finalized the pool (and wait()
    # returned); fini joins the workers
    assert sum(s.nb_executed for s in ctx.streams) == nt * depth


def test_lane_body_error_surfaces():
    src = ("%global NT\n%global boom\n"
           "T(i)\n  i = 0 .. NT-1\n"
           "  CTL S -> (i < NT-1) ? S T(i+1)\nBODY\n  boom(i)\nEND\n")

    def boom(i):
        if i == 3:
            raise ValueError("intentional body failure")

    ctx = pt.Context(nb_cores=1)
    try:
        prog = compile_ptg(src, "err")
        tp = prog.instantiate(ctx, globals={"NT": 8, "boom": boom},
                              collections={})
        with pytest.raises(ValueError):
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
    finally:
        ctx.fini()


def test_lane_body_error_surfaces_with_workers():
    """Multi-worker error path: whichever stream's callback raises, the
    error must poison the graph, retire every other worker from it, and
    surface at the master's wait() — never hang (the non-master branch of
    _ptexec_drain and the graph.failed() peer-retire branch)."""
    src = ("%global NT\n%global boom\n"
           "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. 3\n"
           "  CTL S <- (l > 0) ? S T(i, l-1)\n"
           "        -> (l < 3) ? S T(i, l+1)\nBODY\n  boom(i, l)\nEND\n")

    def boom(i, l):
        if i == 37 and l == 2:
            raise ValueError("intentional multiworker body failure")

    ctx = pt.Context(nb_cores=4)
    try:
        prog = compile_ptg(src, "mt-err")
        tp = prog.instantiate(ctx, globals={"NT": 256, "boom": boom},
                              collections={})
        with pytest.raises(ValueError, match="multiworker body failure"):
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        assert tp._ptexec_state["graph"].failed()
    finally:
        ctx.fini()


def test_lane_data_flow_chain_engages():
    """A data-flow RW chain (memory read, versioned slot hand-off, memory
    write-back) runs ENTIRELY on the native lane: the FSM, the slot
    retire protocol, and the ready ordering live in C; bodies dispatch
    through the batched data callback; repos are bypassed."""
    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
           "BODY\n  X = X + 1.0\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        # per-task protocol under test, as in the reference: region fusion
        # (which folds the whole chain into one super-task and retires no
        # interior slot) is exercised by test_torch_fusion.py instead
        mca.set("region_fusion", False)
        A = TiledMatrix("laneA", 1, 4, 1, 1)
        A.fill(lambda m, k: np.zeros((1, 1), np.float32))
        prog = compile_ptg(src, "data")
        tp = prog.instantiate(ctx, globals={"NT": 4},
                              collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None, \
            "data flows are lane-eligible now"
        g = tp._ptexec_state["graph"]
        assert g.done()
        assert g.slot_stats() == (4, 3)    # 3 interior slots retired
        np.testing.assert_allclose(
            np.asarray(A.data_of(0, 3).newest_copy().payload), 4.0)
        tc = tp._classes["T"]
        assert len(tp.repos[tc.task_class_id]) == 0
        assert tp.repos[tc.task_class_id].retired == 0
    finally:
        mca.params.unset("region_fusion")
        ctx.fini()


def test_lane_priority_class_engages_with_heap():
    """``priority`` no longer disqualifies a pool: the lane orders its
    ready pops with a native max-heap. Independent seeds with distinct
    priorities must execute highest-priority-first on a single stream."""
    order = []
    src = ("%global NT\n%global rec\n"
           "T(i)\n  i = 0 .. NT-1\n  priority = i\n"
           "  CTL S\nBODY\n  rec(i)\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        prog = compile_ptg(src, "prio-heap")
        tp = prog.instantiate(ctx, globals={"NT": 16, "rec": order.append},
                              collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        assert tp._ptexec_state is not None, "priority pool must engage"
        assert order == list(range(15, -1, -1)), order
    finally:
        ctx.fini()


def test_lane_read_only_sink_class():
    """A class whose ONLY data flow is READ returns an EMPTY written
    tuple from its body — the dispatch must forward the input unchanged
    instead of indexing the body's outputs (regression: the single-flow
    fast path crashed with IndexError on exactly this shape)."""
    src = ("%global NT\n%global descA\n%global descB\n"
           "S(k)\n  k = 0 .. NT-1\n"
           "  RW X <- descA(0, k)\n"
           "       -> X C(k)\n"
           "BODY\n  X = X + 1.0\nEND\n\n"
           "C(k)\n  k = 0 .. NT-1\n"
           "  READ X <- X S(k)\n"
           "       -> descB(0, k)\n"
           "BODY\n  _probe = X * 2.0\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        A = TiledMatrix("srcA", 1, 4, 1, 1)
        A.fill(lambda m, k: np.full((1, 1), float(k), np.float32))
        B = TiledMatrix("dstB", 1, 4, 1, 1)
        prog = compile_ptg(src, "ro-sink")
        tp = prog.instantiate(ctx, globals={"NT": 4},
                              collections={"descA": A, "descB": B})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None
        assert tp._ptexec_state["graph"].done()
        for k in range(4):      # READ flow forwards S's output unchanged
            np.testing.assert_allclose(
                np.asarray(B.data_of(0, k).newest_copy().payload), k + 1.0)
    finally:
        ctx.fini()


def test_lane_error_drops_data_slots():
    """After a body error poisons a data-mode graph, the last stream out
    clears the lane's slot payload list — an errored pool must not pin
    every produced payload for its remaining lifetime. The raising body
    lives in a CTL class riding the same pool (CTL bodies get only their
    params, so they can branch on them); the LIFO
    pop order drains the data chain first, so slots hold real payloads
    when the poison lands."""
    src = ("%global NT\n%global boom\n%global descA\n"
           "B(k)\n  k = 0 .. NT-1\n"
           "  CTL S <- (k > 0) ? S B(k-1)\n"
           "        -> (k < NT-1) ? S B(k+1)\n"
           "BODY\n  boom(k)\nEND\n\n"
           "D(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, k) : X D(k-1)\n"
           "       -> (k < NT-1) ? X D(k+1) : descA(0, k)\n"
           "BODY\n  X = X + 1.0\nEND\n")

    def boom(k):
        if k == 5:
            raise ValueError("intentional data-pool failure")

    ctx = pt.Context(nb_cores=1)
    try:
        A = TiledMatrix("errA", 1, 8, 1, 1)
        A.fill(lambda m, k: np.zeros((1, 1), np.float32))
        prog = compile_ptg(src, "data-err")
        tp = prog.instantiate(ctx, globals={"NT": 8, "boom": boom},
                              collections={"descA": A})
        with pytest.raises(ValueError, match="data-pool failure"):
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
        lane = tp._ptexec_state
        assert lane["graph"].failed()
        assert lane["slots"] == [], "errored lane must drop its payloads"
    finally:
        ctx.fini()


def test_lane_fallback_one_sided_deps():
    """Out-deps with no matching in-dep declarations: the flatten's
    goals-vs-edges cross-check refuses (the Python FSM masks one-sided
    declarations differently, so the lane must not guess)."""
    src = ("%global NT\n"
           "T(i)\n  i = 0 .. NT-1\n  priority = NT - i\n"
           "  CTL S -> (i < NT-1) ? S T(i+1)\nBODY\n  pass\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        prog = compile_ptg(src, "oneside")
        tp = prog.instantiate(ctx, globals={"NT": 4}, collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        assert tp._ptexec_state is None
    finally:
        ctx.fini()


def test_lane_fallback_typed_deps():
    """A named dep datatype means reshape promises — state the lane does
    not model; the pool stays on the Python FSM."""
    from parsec_tpu_torch.data.reshape import lower_tile

    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, k) : X T(k-1) [type = LOWER_TILE]\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
           "BODY\n  X = X + 1.0\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        A = TiledMatrix("laneA", 2, 8, 2, 2)
        A.fill(lambda m, k: np.zeros((2, 2), np.float32))
        prog = compile_ptg(src, "typed")
        tp = prog.instantiate(ctx, globals={"NT": 4},
                              collections={"descA": A},
                              datatypes={"LOWER_TILE": lower_tile()})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is None, "typed deps must not take the lane"
    finally:
        ctx.fini()


def test_lane_admits_tpu_body_class():
    """A device body (``[type=TPU]``, read as CUDA) does not eject the
    pool from the lane on a context without a CUDA device: its CPU-twin
    chore runs through the ordinary lane dispatch — the same choice the
    interpreted FSM's device selection would make."""
    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
           "BODY [type=TPU]\n  X = X + 1.0\nEND\n")
    ctx = pt.Context(nb_cores=1)
    try:
        from parsec_tpu_torch.core.task import DEV_CUDA
        assert not any(d.type & DEV_CUDA for d in ctx.devices.devices), \
            "this test expects a CPU-only context (no over_cpu device)"
        A = TiledMatrix("laneA", 1, 4, 1, 1)
        A.fill(lambda m, k: np.zeros((1, 1), np.float32))
        prog = compile_ptg(src, "tpu-body")
        snap = PTEXEC_STATS.snapshot()
        tp = prog.instantiate(ctx, globals={"NT": 4},
                              collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None, \
            "TPU-bodied pool fell off the lane on a CPU-only host"
        delta = PTEXEC_STATS.delta(snap)
        assert delta["pools_engaged"] == 1 and delta["pools_device"] == 0
        np.testing.assert_allclose(
            np.asarray(A.data_of(0, 3).newest_copy().payload), 4.0)
    finally:
        ctx.fini()


def test_lane_off_by_mca():
    src = ("%global NT\n"
           "T(i)\n  i = 0 .. NT-1\n"
           "  CTL S -> (i < NT-1) ? S T(i+1)\nBODY\n  pass\nEND\n")
    mca.set("ptg_native_exec", False)
    ctx = pt.Context(nb_cores=1)
    try:
        prog = compile_ptg(src, "off")
        tp = prog.instantiate(ctx, globals={"NT": 4}, collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        assert tp._ptexec_state is None
    finally:
        mca.params.unset("ptg_native_exec")
        ctx.fini()


# ------------------------------------------------ the port's own additions

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cross_check_data_dag_against_reference(seed):
    """The randomized DATA-flow program through both packages' lanes
    (the reference with region fusion off, the mode the port implements):
    identical final payloads and data versions."""
    import parsec_tpu as ref
    from parsec_tpu.data.matrix import TiledMatrix as RefTiled
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    from parsec_tpu.utils import mca as ref_mca
    params = _rand_shape(seed)
    n = params["N"]
    ref_mca.set("region_fusion", False)
    rctx = ref.Context(nb_cores=1)
    try:
        X = RefTiled("descX", 1, n, 1, 1)
        X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
        Y = RefTiled("descY", 1, n, 1, 1)
        tp = ref_compile(_RND_DATA_SRC, "rnd-data").instantiate(
            rctx, globals=dict(params), collections={"descX": X, "descY": Y})
        rctx.add_taskpool(tp)
        rctx.wait(timeout=120)
        assert tp._ptexec_state is not None
        finals = [float(np.asarray(Y.data_of(0, i).newest_copy().payload)
                        [0, 0]) for i in range(n)]
        versions = [Y.data_of(0, i).version for i in range(n)]
    finally:
        rctx.fini()
        ref_mca.params.unset("region_fusion")
    on = _run_data_dag(params, native=True)
    assert on["finals"] == finals and on["versions"] == versions


def test_lane_data_chain_multiworker():
    """A data-flow chain pool drained by four workers: each stream joins
    the GIL-free walk and hands the GIL back for the batched body
    callbacks; every chain's value is exact."""
    nt, depth = 64, 16
    src = ("%global DEPTH\n%global descA\n"
           "T(i, l)\n  i = 0 .. 63\n  l = 0 .. DEPTH-1\n"
           "  RW X <- (l == 0) ? descA(0, i) : X T(i, l-1)\n"
           "       -> (l < DEPTH-1) ? X T(i, l+1) : descA(0, i)\n"
           "BODY\n  X = X + 1.0\nEND\n")
    ctx = pt.Context(nb_cores=4)
    try:
        A = TiledMatrix("mwA", 1, nt, 1, 1)
        A.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
        tp = compile_ptg(src, "mw-data").instantiate(
            ctx, globals={"DEPTH": depth}, collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        assert tp._ptexec_state is not None
        assert tp._ptexec_state["graph"].done()
        np.testing.assert_array_equal(
            A.to_dense()[0], np.arange(nt, dtype=np.float32) + depth)
    finally:
        ctx.fini()
    assert sum(s.nb_executed for s in ctx.streams) == nt * depth


_DEV_CHAIN_SRC = ("%global NT\n%global descA\n"
                  "T(k)\n  k = 0 .. NT-1\n"
                  "  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\n"
                  "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
                  "BODY [type=CUDA]\n  X = X + 1.0\nEND\n")


def test_device_pool_on_a_cuda_context_declines_counted():
    """No decline: a device-bodied pool on a CUDA context engages the native
    device lane (the name dates from when such a pool declined the lane).
    On a context with a CUDA device module (the test mode over CPU tensors)
    its tasks surface onto the native device lane (``PTDEV_STATS`` engaged,
    ``pools_device`` counted, nothing ineligible or fallen back), they run
    on the device module's card (its ``executed_tasks``), and the result is
    the interpreted FSM's."""
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.device.native import PTDEV_STATS
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    try:
        ctx = pt.Context(nb_cores=1)
        try:
            dev = [d for d in ctx.devices.devices
                   if isinstance(d, CUDADevice)][0]
            A = TiledMatrix("devA", 1, 4, 1, 1)
            A.fill(lambda m, k: np.zeros((1, 1), np.float32))
            snap = PTEXEC_STATS.snapshot()
            dsnap = PTDEV_STATS.snapshot()
            tp = compile_ptg(_DEV_CHAIN_SRC, "dev-chain").instantiate(
                ctx, globals={"NT": 4}, collections={"descA": A})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=60)
            d = PTEXEC_STATS.delta(snap)
            dd = PTDEV_STATS.delta(dsnap)
            assert d["pools_engaged"] == 1 and d["pools_device"] == 1
            assert d["pools_ineligible"] == 0 and d["pools_fallback"] == 0
            assert dd["pools_engaged"] == 1 and dd["tasks_engaged"] == 4
            assert dd["pools_fallback"] == 0 and dd["pools_ineligible"] == 0
            assert tp._ptexec_state is not None
            assert tp._ptexec_state.get("dev_pool") is not None
            assert dev.executed_tasks == 4
            np.testing.assert_allclose(
                np.asarray(A.data_of(0, 3).newest_copy().payload), 4.0)
        finally:
            ctx.fini()
    finally:
        mca.params.unset("device_load_balance_allow_cpu")
        mca.params.unset("device_cuda_over_cpu")


def test_device_native_raises_on_a_cuda_context():
    """Nothing raises: ``--mca device_native`` 1 engages the device lane and
    0 is counted ineligible (the name dates from when 1 raised). On a
    context with a CUDA device: 1 (the reference's default) binds the device pool to the native device lane
    and raises nothing; 0 keeps it on the interpreted FSM and the device
    module, counted ineligible by design (``PTDEV_STATS`` and
    ``PTEXEC_STATS``), never as a fallback. Both give the same tile."""
    from parsec_tpu_torch.device.native import PTDEV_STATS
    mca.set("device_cuda_over_cpu", True)
    try:
        for native in (True, False):
            mca.set("device_native", native)
            ctx = pt.Context(nb_cores=1)
            try:
                A = TiledMatrix("dnA", 1, 4, 1, 1)
                A.fill(lambda m, k: np.zeros((1, 1), np.float32))
                snap = PTEXEC_STATS.snapshot()
                dsnap = PTDEV_STATS.snapshot()
                tp = compile_ptg(_DEV_CHAIN_SRC, "dev-native").instantiate(
                    ctx, globals={"NT": 4}, collections={"descA": A})
                ctx.add_taskpool(tp)
                ctx.wait(timeout=60)
                d = PTEXEC_STATS.delta(snap)
                dd = PTDEV_STATS.delta(dsnap)
                if native:
                    assert tp._ptexec_state.get("dev_pool") is not None
                    assert dd["pools_engaged"] == 1
                    assert dd["pools_ineligible"] == 0
                else:
                    assert tp._ptexec_state is None
                    assert dd["pools_ineligible"] == 1
                    assert d["pools_ineligible"] == 1
                    assert dd["pools_engaged"] == 0
                assert d["pools_fallback"] == 0 and dd["pools_fallback"] == 0
                np.testing.assert_allclose(
                    np.asarray(A.data_of(0, 3).newest_copy().payload), 4.0)
            finally:
                ctx.fini(timeout=5)
    finally:
        mca.params.unset("device_native")
        mca.params.unset("device_cuda_over_cpu")


def test_region_fusion_raises_on_a_data_pool_only():
    """Nothing raises: ``--mca region_fusion`` fuses a PTG data pool (the
    name dates from when an explicit 1 raised there). Explicit 1 and the
    default both fuse a data pool's chain into one region (no interior slot goes
    through the retire protocol, ``fused_regions`` counted) and leave a CTL
    pool per-task on the lane; 0 keeps the data pool per-task. Every
    setting gives the same tile."""
    data_src = ("%global NT\n%global descA\n"
                "T(k)\n  k = 0 .. NT-1\n"
                "  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\n"
                "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
                "BODY\n  X = X + 1.0\nEND\n")
    ctl_src = ("%global NT\n"
               "T(i)\n  i = 0 .. NT-1\n"
               "  CTL S <- (i > 0) ? S T(i-1)\n"
               "        -> (i < NT-1) ? S T(i+1)\nBODY\n  pass\nEND\n")
    for setting in (True, None, False):
        if setting is not None:
            mca.set("region_fusion", setting)
        ctx = pt.Context(nb_cores=1)
        try:
            snap = PTEXEC_STATS.snapshot()
            tp = compile_ptg(ctl_src, "fuse-ctl").instantiate(
                ctx, globals={"NT": 8}, collections={})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
            assert tp._ptexec_state is not None
            assert PTEXEC_STATS.delta(snap)["fused_regions"] == 0
            A = TiledMatrix("fuA", 1, 4, 1, 1)
            A.fill(lambda m, k: np.zeros((1, 1), np.float32))
            tp = compile_ptg(data_src, "fuse-data").instantiate(
                ctx, globals={"NT": 4}, collections={"descA": A})
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
            assert tp._ptexec_state is not None
            g = tp._ptexec_state["graph"]
            d = PTEXEC_STATS.delta(snap)
            if setting is False:
                assert g.slot_stats() == (4, 3)
                assert d["fused_regions"] == 0
            else:
                # the chain's first task reads memory but has a body, so
                # all four fuse: no slot is consumed outside the region
                assert g.slot_stats() == (4, 0)
                assert d["fused_regions"] == 1 and d["fused_tasks"] == 4
                assert g.region_stats()["weighted_total"] == 4
            np.testing.assert_allclose(
                np.asarray(A.data_of(0, 3).newest_copy().payload), 4.0)
        finally:
            mca.params.unset("region_fusion")
            ctx.fini(timeout=5)
    assert mca.is_default("region_fusion") and mca.get("region_fusion")


def test_flatten_cache_key_tells_card_from_cpu_contexts():
    """One program instantiated on a plain CPU context and on a context
    with a CUDA device module: two cache entries, each pool on the lane."""
    src = ("%global NT\n"
           "T(i)\n  i = 0 .. NT-1\n"
           "  CTL S <- (i > 0) ? S T(i-1)\n"
           "        -> (i < NT-1) ? S T(i+1)\nBODY\n  pass\nEND\n")
    prog = compile_ptg(src, "cache-place")
    for over_cpu in (False, True, False):
        if over_cpu:
            mca.set("device_cuda_over_cpu", True)
        try:
            ctx = pt.Context(nb_cores=1)
            try:
                tp = prog.instantiate(ctx, globals={"NT": 8}, collections={})
                ctx.add_taskpool(tp)
                ctx.wait(timeout=30)
                assert tp._ptexec_state is not None
            finally:
                ctx.fini()
        finally:
            mca.params.unset("device_cuda_over_cpu")
    assert len(prog._ptexec_cache) == 2


def test_second_concurrent_pool_binds_the_plane():
    """Two lane pools live at once on a CPU context: the second enqueue
    binds both graphs to the context's scheduler plane (``sched_bind``),
    the drain arbitrates between them, and both complete."""
    from parsec_tpu_torch.core.sched_plane import SCHED_STATS
    src = ("%global NT\n%global rec\n"
           "T(i)\n  i = 0 .. NT-1\n"
           "  CTL S <- (i > 0) ? S T(i-1)\n"
           "        -> (i < NT-1) ? S T(i+1)\nBODY\n  rec(i)\nEND\n")
    ctx = pt.Context(nb_cores=2)
    try:
        assert ctx.sched_plane is not None
        s0 = SCHED_STATS.snapshot()
        runs = ([], [])
        tps = [compile_ptg(src, f"plane{j}").instantiate(
            ctx, globals={"NT": 200, "rec": runs[j].append},
            collections={}, name=f"plane{j}") for j in range(2)]
        for tp in tps:
            ctx.add_taskpool(tp)
        assert all(tp._ptexec_state.get("sched_pool") is not None
                   for tp in tps if not tp.completed)
        ctx.wait(timeout=60)
        # both graphs bound (their slots are freed by sched_unbind, or by
        # the graph's dealloc when a peer stream was still mid-batch)
        assert SCHED_STATS.delta(s0)["pools_engaged"] == 2
        assert runs[0] == list(range(200)) and runs[1] == list(range(200))
    finally:
        ctx.fini()


def test_graph_binds_the_ports_plane_and_refuses_the_references():
    """The port's Graph binds the port's scheduler plane; the reference's
    plane capsule (another capsule name) is refused, and the reference's
    Graph refuses the port's — two packages, one process, no crossing."""
    from parsec_tpu import native as ref_native
    port_sched = native_mod.load_ptsched()
    ref_sched = ref_native.load_ptsched()
    ref_exec = ref_native.load_ptexec()
    assert ref_exec is not None and ref_sched is not None
    pplane = port_sched.Plane(nworkers=1, policy=port_sched.POLICY_WDRR,
                              quantum=64)
    rplane = ref_sched.Plane(nworkers=1, policy=ref_sched.POLICY_WDRR,
                             quantum=64)
    g = _graph([0, 1], [0, 1, 1], [1])
    assert type(g).__module__ == "parsec_tpu_torch._ptexec"
    with pytest.raises((TypeError, ValueError)):
        g.sched_bind(rplane.plane_capsule(), 0)
    h = pplane.register_pool(ext_id=1, kind=port_sched.KIND_PTEXEC,
                             weight=1, window=0)
    g.sched_bind(pplane.plane_capsule(), h)
    assert g.run(None, 256, 0) == 2 and g.done()
    g.sched_unbind()
    rg = ref_exec.Graph([0], [0, 0], [])
    with pytest.raises((TypeError, ValueError)):
        rg.sched_bind(pplane.plane_capsule(), 0)
