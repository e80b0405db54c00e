"""The port's class-level primitives and auxiliary subsystems: futures,
vpmap, the zone allocator, the mempool, reshape promises, the datatype
shim, the datarepo's pooling and the MCA registry.

These are the reference's own tests (tests/test_futures_info.py's futures
tests, tests/test_aux.py's tests of these modules, tests/test_mca.py) run
on the port's modules, and a cross-check drives the reference's MCA
registry and the port's through the same parameter file, environment and
command line and requires the same answers at every step.
"""

import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu.utils.mca import ParamRegistry as RefParamRegistry
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.futures import (CountdownFuture, DataCopyFuture,
                                           Future)
from parsec_tpu_torch.core.vpmap import VPMap, available_cores
from parsec_tpu_torch.data.data import DataCopy, data_from_array
from parsec_tpu_torch.data.reshape import (ReshapeCache, ReshapeSpec,
                                           needs_reshape)
from parsec_tpu_torch.utils.mca import ParamRegistry
from parsec_tpu_torch.utils.zone_malloc import ZoneMalloc


# ------------------------------------------------------------------ Future

def test_future_basic():
    f = Future()
    got = []
    f.on_ready(got.append)
    f.set(42)
    assert f.get() == 42 and got == [42]
    with pytest.raises(RuntimeError):
        f.set(1)
    late = []
    f.on_ready(late.append)
    assert late == [42]


def test_future_single_assignment_and_callbacks():
    f = Future()
    seen = []
    f.on_ready(seen.append)            # registered before completion
    assert not f.ready
    f.set(42)
    assert f.ready and f.get() == 42
    f.on_ready(seen.append)            # registered after completion
    assert seen == [42, 42]
    with pytest.raises(RuntimeError, match="already completed"):
        f.set(43)


def test_future_get_blocks_until_set_across_threads():
    f = Future()
    vals = []

    def consumer():
        vals.append(f.get(timeout=10))

    ts = [threading.Thread(target=consumer) for _ in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.02)
    f.set("payload")
    for t in ts:
        t.join(timeout=10)
    assert vals == ["payload"] * 4


def test_future_timeout_and_progress_pump():
    f = Future()
    with pytest.raises(TimeoutError):
        f.get(timeout=0.05)
    # the progress callable is pumped while waiting, so a single-threaded
    # runtime can fulfil its own future from inside the wait loop
    pumps = []

    def progress():
        pumps.append(1)
        if len(pumps) == 3:
            f.set("pumped")

    assert f.get(timeout=5, progress=progress) == "pumped"
    assert len(pumps) == 3


def test_countdown_future():
    f = CountdownFuture(3, combine=lambda a, b: a + b)
    f.contribute(1)
    f.contribute(2)
    assert not f.ready
    f.contribute(3)
    assert f.get() == 6


def test_countdown_future_combines_contributions():
    f = CountdownFuture(3, combine=lambda a, b: a + b)
    f.contribute(5)
    f.contribute(7)
    assert not f.ready
    f.contribute(30)
    assert f.ready and f.get() == 42


def test_countdown_future_threaded_contributions():
    n = 32
    f = CountdownFuture(n, combine=lambda a, b: a + b)
    ts = [threading.Thread(target=f.contribute, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert f.ready and f.get() == sum(range(n))


class _FakeCopy:
    def __init__(self, payload):
        self.payload = payload
        self.released = 0

    def release(self):
        self.released += 1


def test_datacopy_future_triggers_once():
    calls = []

    def trig(src, spec):
        calls.append(1)
        return DataCopy(None, 0, torch.as_tensor(src.payload) * 2)

    src = DataCopy(None, 0, torch.ones(2, 2))
    f = DataCopyFuture(src, None, trig)
    a = f.request()
    b = f.request()
    assert a is b and len(calls) == 1
    assert torch.equal(a.payload, torch.full((2, 2), 2.0))


def test_datacopy_future_trigger_runs_exactly_once_under_contention():
    """The reshape-promise contract (ref future_datacopy.c): many consumers
    race request(); the conversion trigger runs once and every consumer
    observes the SAME converted copy."""
    src = _FakeCopy(torch.arange(16, dtype=torch.float32))
    calls = []

    def trigger(src_copy, spec):
        calls.append(spec)
        time.sleep(0.01)               # widen the race window
        return _FakeCopy(src_copy.payload.reshape(spec))

    fut = DataCopyFuture(src, (4, 4), trigger)
    got = []

    def consumer():
        got.append(fut.request())

    ts = [threading.Thread(target=consumer) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert len(calls) == 1             # trigger ran exactly once
    assert all(g is got[0] for g in got)
    assert tuple(got[0].payload.shape) == (4, 4)


def test_datacopy_future_release_drops_reference():
    src = _FakeCopy(torch.zeros(4))
    fut = DataCopyFuture(src, None, lambda c, s: _FakeCopy(c.payload))
    fut.release()                      # before trigger: nothing to drop
    out = fut.request()
    fut.release()
    fut.release()
    assert out.released == 2


# ------------------------------------------------------------ aux modules

def test_vpmap_modes(tmp_path):
    flat = VPMap("flat")
    assert flat.nb_vps == 1 and flat.nb_threads == len(available_cores())
    rr = VPMap("rr")
    assert rr.nb_vps == len(available_cores())
    nb = VPMap("nb:2:3")
    assert nb.nb_vps == 2 and nb.nb_threads == 6
    assert nb.thread_to_vp(0) == 0 and nb.thread_to_vp(5) == 1
    p = tmp_path / "vp.map"
    p.write_text("0\n0,0  # two threads on core 0\n")
    fm = VPMap(f"file:{p}")
    assert fm.nb_vps == 2 and fm.vps[1].nb_threads == 2


def test_zone_malloc_first_fit_and_coalesce():
    z = ZoneMalloc(16 << 20, unit=1 << 20)  # 16 units
    a = z.allocate(4 << 20)
    b = z.allocate(4 << 20)
    c = z.allocate(8 << 20)
    assert z.allocate(1) is None          # full
    b.free()
    assert z.stats()["holes"] == 1
    d = z.allocate(2 << 20)               # first fit into b's hole
    assert d.offset == b.offset
    a.free(); c.free(); d.free()
    st = z.stats()
    assert st["holes"] == 1 and st["free_bytes"] == 16 << 20
    assert st["hwm_bytes"] == 16 << 20


def test_reshape_promise_shared():
    cache = ReshapeCache()
    d = data_from_array(torch.arange(12, dtype=torch.float32).reshape(3, 4))
    copy = d.get_copy(0)
    spec = ReshapeSpec(dtype="float64", transpose=True)
    assert needs_reshape(copy, spec)
    r1 = cache.get_reshaped(copy, spec)
    r2 = cache.get_reshaped(copy, spec)
    assert r1 is r2
    assert tuple(r1.payload.shape) == (4, 3)
    assert r1.payload.dtype == torch.float64
    noop = ReshapeSpec()
    assert cache.get_reshaped(copy, noop) is copy


def test_datatype_shim():
    """Layout descriptors + pack/unpack (ref: parsec/datatype.h)."""
    from parsec_tpu_torch.data.datatype import (create_contiguous,
                                                create_resized,
                                                create_vector, pack, unpack)
    c = create_contiguous(10, "float32")
    assert c.size == 40 and c.extent == 10
    # a column of a 4x6 row-major matrix: 4 blocks of 1, stride 6
    v = create_vector(4, 1, 6, "float32")
    assert v.size == 16 and v.extent == 19
    mat = np.arange(24, dtype=np.float32).reshape(4, 6)
    col2 = pack(mat, create_resized(v, 2, 24))
    np.testing.assert_array_equal(col2, mat[:, 2])
    out = unpack(col2, create_resized(v, 2, 24)).reshape(4, 6)
    np.testing.assert_array_equal(out[:, 2], mat[:, 2])
    assert out[:, 0].sum() == 0


def test_mempool_thread_affine_roundtrip():
    """utils/mempool.py (ref parsec/mempool.c): construct-once,
    reset-on-return, owner-thread freelists; cross-thread release returns
    the element to its OWNER's list."""
    from parsec_tpu_torch.utils.mempool import Mempool

    class Shell:
        __slots__ = ("v", "_mp_owner")

        def __init__(self):
            self.v = 0

    resets = []
    mp = Mempool(Shell, reset=lambda o: resets.append(o) or setattr(o, "v", 0))
    a = mp.alloc()
    a.v = 41
    mp.release(a)
    b = mp.alloc()
    assert b is a and b.v == 0          # recycled + scrubbed
    assert mp.stats()["constructed"] == 1

    done = threading.Event()

    def releaser(obj):
        mp.release(obj)
        done.set()
    c = mp.alloc()
    t = threading.Thread(target=releaser, args=(c,)); t.start(); t.join()
    assert done.wait(5)
    d = mp.alloc()
    assert d is c                       # back on the owner's freelist

    box = []
    t2 = threading.Thread(target=lambda: box.append(mp.alloc()))
    t2.start(); t2.join()
    mp.release(d)                       # main's shell back on main's list
    mp.release(box[0])                  # owner thread is dead -> re-homed
    got = {mp.alloc(), mp.alloc()}
    assert box[0] in got                # recycled despite the dead owner


def test_datarepo_entries_are_pooled():
    """Repo entries recycle through the mempool WITHIN a run (repos — and
    their pools — are per-taskpool, so each run exercises a fresh pool).
    Lane OFF: this exercises the Python FSM's repo machinery."""
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.utils import mca
    src = ("%global N\nS(i)\n  i = 0 .. N-1\n  WRITE X -> X C(i)\n"
           "BODY\n  X = torch.ones((2, 2)) * i\nEND\n\n"
           "C(i)\n  i = 0 .. N-1\n  RW X <- X S(i)\nBODY\n  X = X + 1\nEND\n")
    prog = compile_ptg(src, "pool")
    mca.set("ptg_native_exec", False)
    ctx = Context(nb_cores=1, device="cpu")
    try:
        for r in range(3):
            tp = prog.instantiate(ctx, globals={"N": 8}, collections={},
                                  name=f"pool{r}")
            ctx.add_taskpool(tp)
            ctx.wait(timeout=30)
            repo = tp.repos[tp._classes["S"].task_class_id]
            assert len(repo) == 0                       # all retired
            assert repo.retired == 8
            st = repo.pool_stats()
            assert st["constructed"] <= 8 and st["free"] >= 1
    finally:
        ctx.fini()
        mca.params.unset("ptg_native_exec")


# ------------------------------------------------------------------- MCA

def test_register_default():
    r = ParamRegistry()
    r.register("x", 42, "answer", type=int)
    assert r.get("x") == 42


def test_priority_order(tmp_path, monkeypatch):
    r = ParamRegistry()
    r.register("sched_q", "lfq", "queue")
    # file < env < cmdline < explicit
    f = tmp_path / "params.conf"
    f.write_text("sched_q = fromfile  # comment\n\n# full comment\n")
    r.read_paramfile(str(f))
    assert r.get("sched_q") == "fromfile"
    monkeypatch.setenv("PARSEC_MCA_sched_q", "fromenv")
    assert r.get("sched_q") == "fromenv"
    rest = r.parse_cmdline(["prog", "--mca", "sched_q", "fromcli", "arg"])
    assert rest == ["prog", "arg"]
    assert r.get("sched_q") == "fromcli"
    r.set("sched_q", "explicit")
    assert r.get("sched_q") == "explicit"
    r.unset("sched_q")
    assert r.get("sched_q") == "fromcli"


def test_type_coercion(monkeypatch):
    r = ParamRegistry()
    r.register("flag", False, type=bool)
    monkeypatch.setenv("PARSEC_MCA_flag", "true")
    assert r.get("flag") is True
    monkeypatch.setenv("PARSEC_MCA_flag", "0")
    assert r.get("flag") is False
    r.register("n", 1, type=int)
    monkeypatch.setenv("PARSEC_MCA_n", "7")
    assert r.get("n") == 7


def test_on_change_and_help():
    r = ParamRegistry()
    r.register("watched", 1, "help me", type=int)
    seen = []
    r.on_change("watched", seen.append)
    r.set("watched", 5)
    assert seen == [5]
    assert "watched" in r.help_text()
    assert "help me" in r.help_text()


def test_numa_topology_parse(tmp_path):
    """sysfs NUMA discovery: cpulist + SLIT distance rows (the hwloc
    distance-matrix role)."""
    from parsec_tpu_torch.core.vpmap import (_parse_cpulist,
                                             core_distance_fn,
                                             numa_topology)

    assert _parse_cpulist("0-3,7,9-10") == [0, 1, 2, 3, 7, 9, 10]
    base = tmp_path / "node"
    for node, (cpus, dist) in enumerate([("0-1", "10 21"), ("2-3", "21 10")]):
        d = base / f"node{node}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpus + "\n")
        (d / "distance").write_text(dist + "\n")
    core_node, dists = numa_topology(str(base))
    assert core_node == {0: 0, 1: 0, 2: 1, 3: 1}
    assert dists == {0: [10, 21], 1: [21, 10]}
    f = core_distance_fn(str(base))
    assert f(0, 1) == 10       # same node
    assert f(0, 2) == 21       # cross node
    assert f(3, 2) == 10
    assert f(2, 0) == 21


def test_numa_topology_fallback_single_node():
    """A host without sysfs NUMA data degrades to one node at distance 10."""
    from parsec_tpu_torch.core.vpmap import core_distance_fn, numa_topology
    core_node, dists = numa_topology("/nonexistent-sysfs-path")
    assert set(dists) == {0} and dists[0] == [10]
    f = core_distance_fn("/nonexistent-sysfs-path")
    assert f(0, 1) == 10


def test_steal_order_prefers_near_cores():
    """The scheduler's steal walk sorts victims by (same VP, NUMA core
    distance, ring order) — the hwloc-distance walk of the reference's
    flow_init."""
    ctx = Context(nb_cores=4, device="cpu")
    try:
        order = ctx.sched._steal_order(ctx.streams[0])
        assert sorted(order) == [1, 2, 3]
        # on this host all cores share a node: pure ring order survives
        assert order == [1, 2, 3]
    finally:
        ctx.fini()


def test_mca_registries_agree_with_the_reference(tmp_path, monkeypatch):
    """The same registrations, parameter file, environment, command line,
    explicit sets and unsets through the reference's registry and the
    port's: the same value and default-ness of every parameter at every
    step, and the same command-line remainder."""
    regs = [RefParamRegistry(), ParamRegistry()]
    specs = [("a_int", 3, int), ("b_bool", True, bool), ("c_str", "x", str),
             ("d_float", 0.5, float)]
    for r in regs:
        for name, default, ty in specs:
            r.register(name, default, f"param {name}", type=ty)
    f = tmp_path / "p.conf"
    f.write_text("a_int = 7\nc_str = fromfile # c\n")

    def snapshot():
        return [[(r.get(n), r.is_default(n)) for n, _, _ in specs]
                for r in regs]

    steps = [lambda r: r.read_paramfile(str(f)),
             lambda r: monkeypatch.setenv("PARSEC_MCA_b_bool", "off"),
             lambda r: monkeypatch.setenv("PARSEC_MCA_d_float", "2.25"),
             lambda r: r.parse_cmdline(["p", "--mca", "a_int", "11", "rest"]),
             lambda r: r.set("c_str", "explicit"),
             lambda r: r.unset("c_str"),
             lambda r: monkeypatch.delenv("PARSEC_MCA_b_bool", raising=False)]
    for step in steps:
        for r in regs:
            step(r)
        ref, port = snapshot()
        assert port == ref
    assert [r.parse_cmdline(["p", "--mca", "b_bool", "1", "q"])
            for r in regs] == [["p", "q"], ["p", "q"]]
