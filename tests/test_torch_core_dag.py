"""Core runtime tests of the port: hand-built task classes through the
generic engines.

The reference's tests/test_core_dag.py on the port's CPU context (the role
of PaRSEC's tests/api + tests/runtime suites, e.g. multichain.jdf): chains,
fork-join, priorities, per-task dep goals, a body's exception, ``--mca``
argv, DTD and PTG together, scheduler policy separation and the paranoid
tier, and ``python -m parsec_tpu_torch --help-mca``.
"""

import threading

import pytest
import torch

from parsec_tpu_torch.core.context import Context as _Context
from parsec_tpu_torch.core.task import (
    Chore, DEV_CPU, Dep, Flow, FLOW_ACCESS_CTL, HOOK_DONE, Task, TaskClass,
    Taskpool,
)
from parsec_tpu_torch.core import termdet as termdet_mod


def Context(**kw):
    """A port context on the CPU (the card is the port's default)."""
    return _Context(device="cpu", **kw)


@pytest.fixture()
def context():
    ctx = Context(nb_cores=1)
    yield ctx
    ctx.fini()


def _ctl_class(tp, name, body, goal=0, count_mode=True):
    tc = TaskClass(name)
    tc.add_flow(Flow("ctl", FLOW_ACCESS_CTL))
    tc.count_mode = count_mode
    tc.dependencies_goal = goal
    tc.add_chore(Chore(DEV_CPU, body))
    tp.add_task_class(tc)
    return tc


def test_chain(context):
    """T(0) -> T(1) -> ... -> T(N-1), strictly ordered."""
    N = 64
    tp = Taskpool("chain")
    order = []

    def body(stream, task):
        order.append(task.locals["k"])
        return HOOK_DONE

    tc = _ctl_class(tp, "T", body, goal=1)
    tc.flows[0].deps_out.append(Dep(
        task_class=tc, flow_index=0, dep_index=0,
        cond=lambda l: l["k"] < N - 1,
        target_locals=lambda l: [{"k": l["k"] + 1}],
    ))

    def startup(stream, pool):
        pool.set_nb_tasks(N)
        return [Task(pool, tc, {"k": 0})]

    tp.startup_hook = startup
    context.add_taskpool(tp)
    context.wait()
    assert order == list(range(N))
    assert tp.completed


def test_fork_join(context):
    """A -> B(i) for i<W -> C; C must see all W contributions."""
    W = 16
    tp = Taskpool("forkjoin")
    hits = []

    def body_a(stream, task):
        hits.append("A")
        return HOOK_DONE

    def body_b(stream, task):
        hits.append(("B", task.locals["i"]))
        return HOOK_DONE

    def body_c(stream, task):
        hits.append("C")
        return HOOK_DONE

    tc_c = _ctl_class(tp, "C", body_c, goal=W)
    tc_b = _ctl_class(tp, "B", body_b, goal=1)
    tc_a = _ctl_class(tp, "A", body_a)
    tc_a.flows[0].deps_out.append(Dep(
        task_class=tc_b, flow_index=0, dep_index=0,
        target_locals=lambda l: [{"i": i} for i in range(W)],
    ))
    tc_b.flows[0].deps_out.append(Dep(
        task_class=tc_c, flow_index=0, dep_index=0,
        target_locals=lambda l: [{}],
    ))

    def startup(stream, pool):
        pool.set_nb_tasks(1 + W + 1)
        return [Task(pool, tc_a, {})]

    tp.startup_hook = startup
    context.add_taskpool(tp)
    context.wait()
    assert hits[0] == "A"
    assert hits[-1] == "C"
    assert sorted(h[1] for h in hits[1:-1]) == list(range(W))


@pytest.mark.parametrize("sched", ["lfq", "gd", "ap", "ll", "llp", "rnd", "spq",
                                   "pbq", "ip", "ltq", "lhq"])
def test_all_schedulers_run_dag(sched):
    """Every scheduler module executes a diamond DAG correctly
    (the reference compares schedulers on the ep.jdf microbenchmark)."""
    ctx = Context(nb_cores=2, scheduler=sched)
    tp = Taskpool("diamond")
    done = []

    def body(stream, task):
        done.append((task.task_class.name, dict(task.locals)))
        return HOOK_DONE

    W = 8
    tc_top = _ctl_class(tp, "TOP", body)
    tc_mid = _ctl_class(tp, "MID", body, goal=1)
    tc_bot = _ctl_class(tp, "BOT", body, goal=W)
    tc_top.flows[0].deps_out.append(Dep(
        task_class=tc_mid, flow_index=0, dep_index=0,
        target_locals=lambda l: [{"i": i} for i in range(W)],
    ))
    tc_mid.flows[0].deps_out.append(Dep(
        task_class=tc_bot, flow_index=0, dep_index=0,
        target_locals=lambda l: [{}],
    ))

    def startup(stream, pool):
        pool.set_nb_tasks(W + 2)
        return [Task(pool, tc_top, {})]

    tp.startup_hook = startup
    ctx.add_taskpool(tp)
    ctx.wait()
    ctx.fini()
    assert len(done) == W + 2
    assert done[0][0] == "TOP"
    assert done[-1][0] == "BOT"


def test_priority_ordering():
    """With the absolute-priority scheduler and one worker, ready tasks run
    highest-priority-first (ref: sched_ap)."""
    ctx = Context(nb_cores=1, scheduler="ap")
    tp = Taskpool("prio")
    ran = []

    def body(stream, task):
        ran.append(task.locals["i"])
        return HOOK_DONE

    tc = _ctl_class(tp, "P", body)

    def startup(stream, pool):
        pool.set_nb_tasks(10)
        tasks = []
        for i in range(10):
            t = Task(pool, tc, {"i": i}, priority=i)
            tasks.append(t)
        return tasks

    tp.startup_hook = startup
    ctx.add_taskpool(tp)
    ctx.wait()
    ctx.fini()
    # first selected may race with scheduling order; the tail must be sorted
    assert ran == sorted(ran, reverse=True)


def test_user_trigger_termdet(context):
    """user_trigger termdet: pool ends when the designated task says so
    (ref: parsec/mca/termdet/user_trigger/)."""
    tp = Taskpool("trigger")
    td = termdet_mod.UserTriggerTermdet()
    td.monitor_taskpool(tp)
    ran = []

    def body(stream, task):
        ran.append(task.locals["k"])
        if task.locals["k"] == 5:
            td.trigger(tp)
        return HOOK_DONE

    tc = _ctl_class(tp, "T", body, goal=1)
    tc.flows[0].deps_out.append(Dep(
        task_class=tc, flow_index=0, dep_index=0,
        cond=lambda l: l["k"] < 5,
        target_locals=lambda l: [{"k": l["k"] + 1}],
    ))

    def startup(stream, pool):
        pool.set_nb_tasks(Taskpool.UNDETERMINED_NB_TASKS)
        return [Task(pool, tc, {"k": 0})]

    tp.startup_hook = startup
    context.add_taskpool(tp)
    context.wait()
    assert ran == list(range(6))


def test_taskpool_wait_two_pools(context):
    """Two taskpools in flight; taskpool_wait isolates one."""
    tps = []
    for name in ("one", "two"):
        tp = Taskpool(name)
        tc = _ctl_class(tp, f"T{name}", lambda s, t: HOOK_DONE)

        def startup(stream, pool, tc=tc):
            pool.set_nb_tasks(4)
            return [Task(pool, tc, {"i": i}) for i in range(4)]

        tp.startup_hook = startup
        tps.append(tp)
    for tp in tps:
        context.add_taskpool(tp)
    assert tps[0].wait(timeout=10)
    context.wait()
    assert all(tp.completed for tp in tps)


def test_body_exception_propagates():
    """A raising task body surfaces from wait() instead of deadlocking
    (workers record the error; the master re-raises)."""
    ctx = Context(nb_cores=2)
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
    import numpy as np
    tp = DTDTaskpool(ctx, "boom")
    t = tp.tile_new((2, 2), torch.float32)

    def bad(x):
        raise ValueError("intentional body failure")

    tp.insert_task(bad, (t, RW), jit=False)
    with pytest.raises((ValueError, RuntimeError)):
        tp.wait(timeout=10)
        tp.close()
        ctx.wait(timeout=10)
    ctx.fini()   # poisoned context still shuts down cleanly


def test_cli_help_mca():
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "parsec_tpu_torch",
                          "--help-mca"], capture_output=True, text=True,
                         timeout=110, cwd=root)
    assert out.returncode == 0
    assert "--mca sched" in out.stdout
    assert "dtd_window_size" in out.stdout
    assert "tel_interval_ms" in out.stdout and "tel_fanout" in out.stdout


def test_dtd_and_ptg_concurrently():
    """Both frontends share one context and run interleaved."""
    import numpy as np
    from parsec_tpu_torch.data.matrix import TiledMatrix
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    ctx = Context(nb_cores=1)
    A = TiledMatrix("mixA", 4, 4, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    ptg = compile_ptg("""
%global NT
%global A
T(k)
  k = 0 .. NT-1
  : A(0, 0)
  RW X <- (k == 0) ? A(0, 0) : X T(k-1)
     -> (k < NT-1) ? X T(k+1) : A(0, 0)
BODY
  X = X + 1.0
END
""", "mixptg").instantiate(ctx, globals={"NT": 5}, collections={"A": A})
    ctx.add_taskpool(ptg)
    dtp = DTDTaskpool(ctx, "mixdtd")
    t = dtp.tile_new((2, 2), np.float32)
    for _ in range(5):
        dtp.insert_task(lambda x: x + 2.0, (t, RW))
    dtp.wait(); dtp.close()
    ctx.wait()
    ctx.fini()
    assert ptg.completed and dtp.completed
    assert np.allclose(A.to_dense(), 5.0)
    assert np.allclose(np.asarray(t.data.newest_copy().payload), 10.0)


def test_context_argv_mca():
    """parsec_init-style cmdline: --mca pairs consumed at context creation."""
    from parsec_tpu_torch.utils import mca
    ctx = Context(nb_cores=1, argv=["prog", "--mca", "sched", "ap", "x"])
    try:
        assert ctx.sched.name == "ap"
    finally:
        ctx.fini()
        mca.params._params["sched"].has_cmdline = False  # restore default


@pytest.mark.parametrize("sched,chain_early", [("pbq", True), ("ap", True),
                                               ("ltq", True), ("gd", False),
                                               ("rnd", False)])
def test_scheduler_policy_separation(sched, chain_early):
    """Policy probe (behavioral, order-based): a high-priority serial chain
    races a gated backlog of low-priority fillers. Priority-aware modules
    must finish the chain before most fillers run; FIFO/random must not
    (the structural distinctness the reference gets from hbbuffer/maxheap
    designs — sched_bench.py reports the timing version)."""
    import threading
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW

    ctx = Context(nb_cores=1, scheduler=sched)
    tp = DTDTaskpool(ctx, f"sep-{sched}")
    fill_tiles = [tp.tile_new((2, 2)) for _ in range(16)]
    chain_tile = tp.tile_new((2, 2))
    gate_tile = tp.tile_new((2, 2))
    nfill, chain_len = 400, 40
    fills_done = [0]
    fills_at_chain_end = [None]
    release = threading.Event()

    def gate(g):
        release.wait(30)
        return g

    def filler(x, g):
        fills_done[0] += 1

    def link(x, g):
        return x

    def last(x, g):
        fills_at_chain_end[0] = fills_done[0]
        return x

    tp.insert_task(gate, (gate_tile, RW), jit=False, name="GATE")
    for i in range(nfill):
        tp.insert_task(filler, (fill_tiles[i % 16], READ), (gate_tile, READ),
                       jit=False, name="FILL", priority=0)
    for i in range(chain_len):
        tp.insert_task(last if i == chain_len - 1 else link,
                       (chain_tile, RW), (gate_tile, READ),
                       jit=False, name="CHAIN", priority=1000)
    release.set()
    tp.wait(); tp.close(); ctx.wait(); ctx.fini()
    assert fills_at_chain_end[0] is not None
    frac = fills_at_chain_end[0] / nfill
    if chain_early:
        assert frac < 0.5, f"{sched}: chain finished after {frac:.0%} of fillers"
    else:
        assert frac > 0.5, f"{sched}: chain finished after only {frac:.0%}"


def test_paranoid_tier_catches_premature_schedule():
    """--mca debug_paranoid 1: scheduling a task with unmet deps (or
    re-scheduling a completed one) is an immediate attributed fatal — the
    PARSEC_DEBUG_PARANOID assertion tier."""
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
    from parsec_tpu_torch.utils import mca

    mca.set("debug_paranoid", 1)
    ctx = None
    try:
        ctx = Context(nb_cores=1)
        tp = DTDTaskpool(ctx, "paranoid")
        t = tp.tile_new((2, 2))
        task = tp.insert_task(lambda x: x + 1.0, (t, RW), jit=False)
        tp.wait(); tp.close(); ctx.wait()
        # seeded bug 1: re-schedule the completed task
        with pytest.raises(RuntimeError, match="PARANOID.*re-scheduled"):
            ctx.schedule([task])
        # seeded bug 2: a task with unmet deps enters the queues
        task.status = 0
        task.deps_remaining = 3
        with pytest.raises(RuntimeError, match="PARANOID.*unmet"):
            ctx.schedule([task])
    finally:
        if ctx is not None:
            ctx.fini()
        mca.params.unset("debug_paranoid")


def test_paranoid_ptg_clean_run():
    """PTG taskpools (base Task, no deps_remaining field) run clean under
    the paranoid tier (regression: the check crashed on the missing
    attribute instead of passing valid DAGs)."""
    import numpy as np
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.data.matrix import TiledMatrix
    from parsec_tpu_torch.utils import mca

    src = """
%global descA
T(k)
  k = 0 .. 3
  : descA(0, k)
  RW X <- descA(0, k)
     -> descA(0, k)
BODY
  X = X + 1.0
END
"""
    mca.set("debug_paranoid", 1)
    ctx = None
    try:
        ctx = Context(nb_cores=1)
        A = TiledMatrix("PARG", 4, 16, 4, 4)
        A.fill(lambda m, n: np.zeros((4, 4), np.float32))
        tp = compile_ptg(src, "par").instantiate(ctx, collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        np.testing.assert_allclose(A.to_dense(), 1.0)
    finally:
        if ctx is not None:
            ctx.fini()
        mca.params.unset("debug_paranoid")


def test_paranoid_off_by_default(context):
    """The hot path carries no paranoid cost unless asked for."""
    assert context.paranoid == 0
