"""The port's PTG advanced dependency features — user-defined functions,
multisize broadcast, time_estimate (the analogues of the reference's
tests/dsl/ptg/user-defined-functions (udf.jdf) and multisize_bcast suites,
plus parsec_internal.h:431-458 time_estimate feeding best-device
selection): the reference's ``tests/test_ptg_udf.py`` on one rank. The
control gather across ranks waits for the distributed half of the port.
"""

import numpy as np

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.task import HOOK_DONE, HOOK_NEXT
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.data.reshape import NamedDatatype
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg


def _mk(name, n=8, ts=4, val=1.0, **kw):
    dc = TwoDimBlockCyclic(name, n, n, ts, ts, P=kw.pop("P", 1), Q=1, **kw)
    dc.fill(lambda m, k: np.full((ts, ts), val, np.float32))
    return dc


def test_user_defined_make_key():
    """[make_key_fn = f]: the task key comes from the user function, which
    feeds the dep repo and hash tables (udf.jdf UD_MAKE_KEY)."""
    calls = []

    def my_key(tp, loc):
        calls.append(dict(loc))
        return ("udk", loc["m"] * 100 + loc["n"])

    src = """
%global descA
%global my_key

P(m, n) [ make_key_fn = my_key ]
  m = 0 .. 1
  n = 0 .. 1
  : descA(m, n)
  RW A <- descA(m, n)
       -> A C(m, n)
BODY
  A = A + 1.0
END

C(m, n)
  m = 0 .. 1
  n = 0 .. 1
  : descA(m, n)
  RW A <- A P(m, n)
       -> descA(m, n)
BODY
  A = A + 1.0
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    tp = compile_ptg(src, "udk").instantiate(
        ctx, globals={"my_key": my_key}, collections={"descA": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    np.testing.assert_array_equal(A.to_dense(),
                                  np.full((8, 8), 3.0, np.float32))
    assert len(calls) >= 4      # every P task keyed through the user fn
    keys = {my_key(tp, c) for c in list(calls)}
    assert ("udk", 101) in keys


def test_user_defined_startup_fn():
    """[startup_fn = f]: the class's initial ready tasks come from the user
    enumerator instead of the goal==0 scan (udf.jdf UD_STARTUP1/2)."""
    seeded = []

    def my_startup(tp, tc):
        for m in range(2):
            for n in range(2):
                seeded.append((m, n))
                yield {"m": m, "n": n}

    src = """
%global descA
%global my_startup

P(m, n) [ startup_fn = my_startup ]
  m = 0 .. 1
  n = 0 .. 1
  : descA(m, n)
  RW A <- descA(m, n)
       -> descA(m, n)
BODY
  A = A * 2.0
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    tp = compile_ptg(src, "uds").instantiate(
        ctx, globals={"my_startup": my_startup}, collections={"descA": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    assert seeded == [(0, 0), (0, 1), (1, 0), (1, 1)]
    np.testing.assert_array_equal(A.to_dense(),
                                  np.full((8, 8), 2.0, np.float32))


def test_body_evaluate_selects_incarnation():
    """[evaluate = fn]: a chore whose evaluate returns HOOK_NEXT is skipped
    and the next incarnation runs (udf.jdf UD_HASH_STRUCT's never_here /
    always_here bodies)."""
    hits = {"never": 0, "always": 0}

    def never_here(stream, task):
        hits["never"] += 1
        return HOOK_NEXT

    def always_here(stream, task):
        hits["always"] += 1
        return HOOK_DONE

    src = """
%global descA
%global never_here
%global always_here

P(m, n)
  m = 0 .. 1
  n = 0 .. 1
  : descA(m, n)
  RW A <- descA(m, n)
       -> descA(m, n)
BODY [evaluate = never_here]
  A = A * 100.0
END
BODY [evaluate = always_here]
  A = A + 1.0
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    tp = compile_ptg(src, "udev").instantiate(
        ctx, globals={"never_here": never_here, "always_here": always_here},
        collections={"descA": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    # the gated first body never ran; the second did, on every task
    np.testing.assert_array_equal(A.to_dense(),
                                  np.full((8, 8), 2.0, np.float32))
    assert hits["never"] == 4 and hits["always"] == 4


def test_time_estimate_feeds_best_device():
    """[time_estimate = f]: the class property is consumed by the device
    layer's load estimate (parsec_internal.h:431-458; DeviceRegistry
    select_best_device min-ETA)."""
    est_calls = []

    def my_estimate(task, device):
        est_calls.append((task.locals["m"], type(device).__name__))
        return 123.0

    src = """
%global descA
%global my_estimate

P(m, n) [ time_estimate = my_estimate ]
  m = 0 .. 1
  n = 0 .. 1
  : descA(m, n)
  RW A <- descA(m, n)
       -> descA(m, n)
BODY [type=TPU]
  A = A + 1.0
END
"""
    from parsec_tpu_torch.utils import mca
    mca.set("device_cuda_over_cpu", True)
    try:
        ctx = Context(nb_cores=1, device="cpu")
        from parsec_tpu_torch.device.cuda import CUDADevice
        dev = [d for d in ctx.devices.devices if isinstance(d, CUDADevice)][0]
        A = _mk("descA")
        s0 = PTEXEC_STATS.snapshot()
        tp = compile_ptg(src, "udte").instantiate(
            ctx, globals={"my_estimate": my_estimate},
            collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        ctx.fini()
    finally:
        mca.params.unset("device_cuda_over_cpu")
    # a device pool on a context with a CUDA device module rides the
    # native device lane; the hook is consulted as the cost model's
    # cold-start prior at the instantiation boundary
    d = PTEXEC_STATS.delta(s0)
    assert d["pools_engaged"] == 1 and d["pools_device"] == 1
    assert dev.executed_tasks + ctx.devices.cpu.executed_tasks == 4
    np.testing.assert_array_equal(A.to_dense(),
                                  np.full((8, 8), 2.0, np.float32))
    assert est_calls, "time_estimate was never consulted"


def test_multisize_broadcast():
    """One producer flow broadcast to successor groups under DIFFERENT
    payload sizes (the [count = N] multisize broadcast of
    check_multisize_bcast.jdf, expressed as named datatypes): each group
    receives its own size."""
    rows2 = NamedDatatype("ROWS2", extract=lambda a: a[:2].clone())
    rows3 = NamedDatatype("ROWS3", extract=lambda a: a[:3].clone())
    got = {}

    def shape_probe(name):
        def ev(stream, task):
            v = task.data[0].data_in
            p = getattr(v, "payload", v)
            got.setdefault(name, set()).add(tuple(np.asarray(p).shape))
            return HOOK_DONE
        return ev

    src = """
%global descA
%global probe2
%global probe3

P(j)
  j = 0 .. 0
  : descA(0, 0)
  RW A <- descA(0, 0)
       -> A C2(0 .. 1)     [type = ROWS2]
       -> A C3(0 .. 1)     [type = ROWS3]
BODY
  A = A
END

C2(i)
  i = 0 .. 1
  : descA(i, 1)
  READ A <- A P(0)         [type = ROWS2]
BODY [evaluate = probe2]
  pass
END

C3(i)
  i = 0 .. 1
  : descA(i, 1)
  READ A <- A P(0)         [type = ROWS3]
BODY [evaluate = probe3]
  pass
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    tp = compile_ptg(src, "msb").instantiate(
        ctx, globals={"probe2": shape_probe("c2"), "probe3": shape_probe("c3")},
        collections={"descA": A},
        datatypes={"ROWS2": rows2, "ROWS3": rows3})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    assert got["c2"] == {(2, 4)} and got["c3"] == {(3, 4)}, got
