"""Composition, the recursive device and subtile collections through both
runtimes.

The reference's own tests (tests/test_aux.py's compose and subtile tests,
tests/test_apps.py::test_recursive_device) run on the port's CPU context,
and a cross-check factors the same SPD tiles, made with numpy from a seed,
through the reference's recursive device and the port's: each coarse tile
is Cholesky-factored by a nested taskpool over its subtile view, held to the
reference test's tolerance (rtol/atol 1e-2 on L·Lᵀ against A).
"""

import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.core.task import (Chore as RefChore, DEV_RECURSIVE as
                                  REF_DEV_RECURSIVE, Flow as RefFlow,
                                  FLOW_ACCESS_CTL as REF_CTL, Task as RefTask,
                                  TaskClass as RefTaskClass,
                                  Taskpool as RefTaskpool)
from parsec_tpu.data.matrix import TiledMatrix as RefMatrix
from parsec_tpu.data.subtile import SubtileCollection as RefSubtile
from parsec_tpu.device.recursive import \
    make_recursive_hook as ref_recursive_hook
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops.potrf import insert_potrf_tasks as ref_potrf
from parsec_tpu_torch.core.compound import compose
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.task import (Chore, DEV_CPU, DEV_CUDA,
                                        DEV_RECURSIVE, FLOW_ACCESS_CTL,
                                        HOOK_DONE, Flow, Task, TaskClass,
                                        Taskpool)
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.data.subtile import SubtileCollection
from parsec_tpu_torch.device.recursive import (RecursiveDevice,
                                               make_recursive_hook)
from parsec_tpu_torch.dsl.dtd import RW, DTDTaskpool
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


def _simple_pool(name, log):
    tp = Taskpool(name)
    tc = TaskClass(f"T{name}")
    tc.add_flow(Flow("ctl", FLOW_ACCESS_CTL))
    tc.count_mode = True

    def body(stream, task):
        log.append(name)
        return HOOK_DONE

    tc.add_chore(Chore(DEV_CPU, body))
    tp.add_task_class(tc)

    def startup(stream, pool):
        pool.set_nb_tasks(2)
        return [Task(pool, tc, {"i": i}) for i in range(2)]

    tp.startup_hook = startup
    return tp


def test_compose_sequential(ctx):
    """Stages run strictly one after another (ref: tests/api/compose.c)."""
    log = []
    comp = compose(ctx, _simple_pool("a", log), _simple_pool("b", log),
                   _simple_pool("c", log))
    ctx.wait()
    assert comp.completed
    assert log == ["a", "a", "b", "b", "c", "c"]


def test_compose_lazy_stage(ctx):
    log = []
    comp = compose(ctx, _simple_pool("x", log))
    comp.add(lambda: _simple_pool("y", log))
    ctx.wait()
    assert log[:2] == ["x", "x"] and log[2:] == ["y", "y"]


def test_compose_dtd_stages_see_the_previous_stage(ctx):
    """A DTD pool already made (a DTD pool enqueues itself), then a DTD
    stage built when its turn comes: it reads what the first one wrote."""
    A = TiledMatrix("cA", 8, 8, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), 1.0, np.float32))

    def stage(fn, name):
        def build():
            tp = DTDTaskpool(ctx, name)
            for m in range(2):
                for n in range(2):
                    tp.insert_task(fn, (tp.tile_of(A, m, n), RW))
            tp.close()
            return tp
        return build

    first = DTDTaskpool(ctx, "s1")
    for m in range(2):
        for n in range(2):
            first.insert_task(lambda x: x + 1.0, (first.tile_of(A, m, n), RW))
    comp = compose(ctx, first, stage(lambda x: x * 10.0, "s2"))
    first.close()
    ctx.wait()
    assert comp.completed
    assert np.array_equal(A.to_dense(), np.full((8, 8), 20.0, np.float32))


def test_recursive_device(ctx):
    """A recursive-device task spawns a sub-taskpool; the parent completes
    only after the nested DAG does (ref: PARSEC_DEV_RECURSIVE)."""
    done = []

    def builder(task):
        sub = DTDTaskpool(ctx, f"sub{task.locals['k']}")
        t = sub.tile_new((2, 2), torch.float32)
        for _ in range(3):
            sub.insert_task(lambda x: x + 1.0, (t, RW))

        def record(x):
            done.append(task.locals["k"])
            return None
        sub.insert_task(record, (t, 0x1), jit=False)
        sub.close()
        return sub

    tp = Taskpool("outer")
    tc = TaskClass("R")
    tc.add_flow(Flow("ctl", FLOW_ACCESS_CTL))
    tc.count_mode = True
    tc.add_chore(Chore(DEV_RECURSIVE, make_recursive_hook(builder)))
    tp.add_task_class(tc)

    def startup(stream, pool):
        pool.set_nb_tasks(3)
        return [Task(pool, tc, {"k": k}) for k in range(3)]

    tp.startup_hook = startup
    ctx.add_taskpool(tp)
    ctx.wait()
    assert sorted(done) == [0, 1, 2]
    assert tp.completed


@pytest.mark.parametrize("recursive,over_cpu,names", [
    (True, False, ["cpu", "recursive"]),
    (False, False, ["cpu"]),
    (True, True, ["cpu", "recursive", "cuda-over-cpu"]),
    (False, True, ["cpu", "cuda-over-cpu"]),
])
def test_device_numbering_follows_the_registry(recursive, over_cpu, names):
    """CPU 0, recursive 1 (behind ``device_recursive_enabled``), the CUDA
    module after them; every module's index is its place in the registry,
    and the CUDA module writes its copies under its own index."""
    mca.set("device_recursive_enabled", recursive)
    mca.set("device_cuda_over_cpu", over_cpu)
    try:
        c = Context(nb_cores=1, device="cpu")
        try:
            devs = c.devices.devices
            assert [d.name for d in devs] == names
            assert [d.device_index for d in devs] == list(range(len(names)))
            assert any(isinstance(d, RecursiveDevice)
                       for d in devs) == recursive
            assert [d.type for d in devs] == \
                [DEV_CPU] + [DEV_RECURSIVE] * recursive + [DEV_CUDA] * over_cpu
            if over_cpu:
                cuda = c.devices.by_type(DEV_CUDA)[0]
                A = TiledMatrix("numA", 4, 4, 4, 4)
                A.fill(lambda m, n: np.ones((4, 4), np.float32))
                tp = DTDTaskpool(c, "num")
                tp.insert_task(lambda x: x + 1.0, (tp.tile_of(A, 0, 0), RW))
                tp.wait(); tp.close(); c.wait()
                d = A.data_of(0, 0)
                assert d.newest_copy().device_index == cuda.device_index
                assert d.get_copy(cuda.device_index) is d.newest_copy()
                assert np.array_equal(A.to_dense(), np.full((4, 4), 2.0))
        finally:
            c.fini()
    finally:
        mca.params.unset("device_recursive_enabled")
        mca.params.unset("device_cuda_over_cpu")


def test_subtile_recursive_potrf(ctx):
    """A coarse tile factored by a nested taskpool over its subtile view
    (ref: subtile.c + PARSEC_DEV_RECURSIVE composition)."""
    n = 64
    spd = make_spd(n, seed=15)
    A = TiledMatrix("big", n, n, n, n)     # ONE coarse tile
    A.fill(lambda m, k: spd)
    parent = A.data_of(0, 0)

    sub = SubtileCollection(parent, 16, 16, name="sub")
    tp = DTDTaskpool(ctx, "subpotrf")
    insert_potrf_tasks(tp, sub)
    tp.wait(); tp.close(); ctx.wait()
    sub.flush()
    L = np.tril(parent.newest_copy().payload.numpy())
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)


def test_subtile_blocks_are_views_and_flush_makes_the_written_copy_newest():
    """On a context with the CUDA module (over CPU tensors), the nested
    tasks write device copies; flush gathers them and the parent copy it
    writes becomes the newest, so a later task reads the factor and not
    the tile the nested pool started from."""
    mca.set("device_cuda_over_cpu", True)
    try:
        c = Context(nb_cores=1, device="cpu")
        try:
            cuda = c.devices.by_type(DEV_CUDA)[0]
            spd = make_spd(32, seed=4)
            A = TiledMatrix("vA", 32, 32, 32, 32)
            A.fill(lambda m, k: spd)
            parent = A.data_of(0, 0)
            # stage the parent onto the device module: its newest copy is
            # the device's when the subtile view is taken
            tp = DTDTaskpool(c, "stage")
            tp.insert_task(lambda x: x * 1.0, (tp.tile_of(A, 0, 0), RW))
            tp.wait(); tp.close(); c.wait()
            assert parent.newest_copy().device_index == cuda.device_index
            sub = SubtileCollection(parent, 8, 8, name="vsub")
            assert sub.parent_index == cuda.device_index
            blk = sub.data_of(1, 1).get_copy(0).payload
            assert blk.untyped_storage().data_ptr() == \
                sub._buffer.untyped_storage().data_ptr()
            v0 = parent.version
            tp = DTDTaskpool(c, "nested")
            insert_potrf_tasks(tp, sub)
            tp.wait(); tp.close(); c.wait()
            sub.flush()
            newest = parent.newest_copy()
            assert newest.device_index == cuda.device_index
            assert parent.version == v0 + 1
            L = np.tril(newest.payload.numpy())
            np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)
            tp = DTDTaskpool(c, "after")
            tp.insert_task(lambda x: torch.tril(x), (tp.tile_of(A, 0, 0), RW))
            tp.wait(); tp.close(); c.wait()
            assert np.array_equal(A.to_dense(), L)
        finally:
            c.fini()
    finally:
        mca.params.unset("device_cuda_over_cpu")


def _recursive_potrf(pkg, ctx, dense, ts, sub_ts):
    """Each coarse tile of ``dense`` (one per DEV_RECURSIVE task) factored by
    a nested POTRF pool over its subtile view; returns the factored tiles
    and the order in which parents and nested pools finished."""
    if pkg == "ref":
        Matrix, Subtile, Pool, potrf = RefMatrix, RefSubtile, RefPool, ref_potrf
        TP, TC, FL, CH, TK = (RefTaskpool, RefTaskClass, RefFlow, RefChore,
                              RefTask)
        ctl, rec, hook = REF_CTL, REF_DEV_RECURSIVE, ref_recursive_hook
    else:
        Matrix, Subtile, Pool, potrf = (TiledMatrix, SubtileCollection,
                                        DTDTaskpool, insert_potrf_tasks)
        TP, TC, FL, CH, TK = Taskpool, TaskClass, Flow, Chore, Task
        ctl, rec, hook = FLOW_ACCESS_CTL, DEV_RECURSIVE, make_recursive_hook
    nt = dense.shape[0] // ts
    A = Matrix("rA", nt * ts, ts, ts, ts)
    A.fill(lambda m, k: dense[m * ts:(m + 1) * ts])
    order = []

    def builder(task):
        k = task.locals["k"]
        sub = Subtile(A.data_of(k, 0), sub_ts, sub_ts, name=f"rs{k}")
        tp = Pool(ctx, f"rp{k}")
        potrf(tp, sub)
        tp.close()

        def flushed(_tp):
            sub.flush()
            order.append(("nested", k))
        tp.on_complete = flushed
        return tp

    outer = TP("router")
    tc = TC("R")
    tc.add_flow(FL("ctl", ctl))
    tc.count_mode = True
    tc.add_chore(CH(rec, hook(builder)))
    outer.add_task_class(tc)

    def startup(stream, pool):
        pool.set_nb_tasks(nt)
        tasks = [TK(pool, tc, {"k": k}) for k in range(nt)]
        for t in tasks:
            t.on_complete = lambda t_: order.append(("parent",
                                                     t_.locals["k"]))
        return tasks

    outer.startup_hook = startup
    ctx.add_taskpool(outer)
    ctx.wait()
    assert outer.completed
    tiles = [np.asarray(torch.as_tensor(
        A.data_of(k, 0).newest_copy().payload)) for k in range(nt)]
    return tiles, order


def test_recursive_subtile_potrf_against_the_reference(ctx):
    """Four SPD tiles, each factored by a nested POTRF (4 x 4 subtiles)
    spawned from a DEV_RECURSIVE task, in both runtimes: every factor
    within the reference test's tolerance of its matrix and of the
    reference's factor, and every parent completing after its nested pool
    (ref: parsec_recursive_callback)."""
    ts, sub_ts, nt = 32, 8, 4
    dense = np.concatenate([make_spd(ts, seed=40 + k) for k in range(nt)])
    ref_ctx = RefContext(nb_cores=1)
    try:
        want, _ = _recursive_potrf("ref", ref_ctx, dense, ts, sub_ts)
    finally:
        ref_ctx.fini()
    got, order = _recursive_potrf("port", ctx, dense, ts, sub_ts)
    for k in range(nt):
        a = dense[k * ts:(k + 1) * ts]
        L = np.tril(got[k])
        np.testing.assert_allclose(L @ L.T, a, rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(L, np.tril(want[k]), rtol=1e-2, atol=1e-2)
        assert order.index(("nested", k)) < order.index(("parent", k))


def test_chip_smoke_substrate_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 11 of ``chip_smoke.py`` ((a)-(e): compose, redistribution,
    the recursive subtile POTRF, the collection helpers, checkpoint) with
    every gate, on a CPU context with the CUDA module over CPU tensors, at
    sizes cut to a few tiles."""
    import chip_smoke as CS
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.ops import cuda_kernels as K
    monkeypatch.setattr(CS, "SUB_N", 256)
    monkeypatch.setattr(CS, "SUB_S_TS", 64)
    monkeypatch.setattr(CS, "SUB_T_TS", 32)
    monkeypatch.setattr(CS, "SUB_V_TS", 48)
    monkeypatch.setattr(CS, "SUB_REGION",
                        dict(m=200, n=180, si=7, sj=13, ti=21, tj=5))
    monkeypatch.setattr(CS, "SUB_REC_N", 128)
    mca.set("device_load_balance_allow_cpu", False)
    try:
        assert CS.substrate(ptt, K, torch, "cpu", {}, device="cpu") is None
    finally:
        mca.params.unset("device_load_balance_allow_cpu")
