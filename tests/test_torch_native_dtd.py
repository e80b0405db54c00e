"""The port's native DTD engine (``parsec_tpu_torch/csrc/ptdtd.cpp``) and the
runtime paths around it, on CPU contexts.

* the reference's ``tests/test_native_dtd.py`` on the port's engine (the
  chain semantics of the C extension, the per-task lane, the ready buffer,
  concurrent inserters, window pressure);
* an engine-level cross-check: one seeded sequence of inserts, activations
  and completions fed to the reference's engine and to the port's, every
  returned value equal;
* the per-task lane with the CUDA chore (``device_cuda_over_cpu``);
* the GEMM (kt = 20) and POTRF DAGs through the native lane against the
  port's Python engine (``--mca native_enabled 0``), bit for bit;
* the build: the port's extensions come from its own sources into its own
  build directory, are distinct from the reference's in one process, and a
  failed build raises while the engine is enabled.
"""

import threading

import numpy as np
import pytest
import torch

from parsec_tpu import native as ref_native
from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import collection_from_numpy
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import (
    DTDTaskpool, NOTRACK, PTDTD_STATS, READ, RW, WRITE,
)
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


def _engine():
    return native_mod.load_ptdtd().Engine()


def _zeros(tp, shape=(2, 2)):
    t = tp.tile_new(shape, torch.float32)
    t.data.create_copy(0, torch.zeros(shape))
    return t


def _val(t) -> float:
    return float(t.data.newest_copy().payload.reshape(-1)[0])


# ---------------------------------------------------------------- C engine

def _ins(e, tiles, accs):
    """insert + activate (the count-then-activate protocol): returns
    (task_id, deps_remaining_after_guard_drop)."""
    tid, held = e.insert(tiles, accs)
    assert held >= 1                         # insertion guard still held
    return tid, e.activate(tid)


def test_engine_raw_chain_semantics():
    """w0 -> {r1, r2} -> w3: RAW, WAR, and retire-once."""
    e = _engine()
    t = e.tile()
    tid, nd = _ins(e, (t,), (WRITE,))
    assert nd == 0
    r1, nd1 = _ins(e, (t,), (READ,))
    r2, nd2 = _ins(e, (t,), (READ,))
    assert nd1 == nd2 == 1                   # RAW on w0
    w3, nd3 = _ins(e, (t,), (RW,))
    assert nd3 == 3                          # WAR on r1,r2 + WAW on w0
    assert e.complete(tid) == (r1, r2)
    assert e.complete(r1) == ()
    assert e.complete(r2) == (w3,)
    assert e.complete(w3) == ()
    assert e.pending() == 0


def test_engine_guard_held_until_activate():
    """Between insert() and activate(), a completing predecessor must NOT
    surface the new task as ready (the activation race): the guard keeps
    its count above zero until the inserter publishes it."""
    e = _engine()
    t = e.tile()
    w, ndw = _ins(e, (t,), (WRITE,))
    assert ndw == 0
    r, held = e.insert((t,), (READ,))        # RAW on w; guard held
    assert held == 2                         # guard + RAW
    assert e.complete(w) == ()               # NOT released: guard holds it
    assert e.activate(r) == 0                # inserter drops guard: ready
    assert e.complete(r) == ()
    assert e.pending() == 0


def test_engine_write_resets_readers():
    e = _engine()
    t = e.tile()
    w0, _ = _ins(e, (t,), (WRITE,))
    r, _ = _ins(e, (t,), (READ,))
    w1, ndw = _ins(e, (t,), (WRITE,))        # WAR on r, WAW on w0
    assert ndw == 2
    r2, ndr = _ins(e, (t,), (READ,))         # RAW on w1 ONLY (readers reset)
    assert ndr == 1
    e.complete(w0)
    e.complete(r)
    assert e.complete(w1) == (r2,)


def test_engine_dedup_multi_flow():
    """A task reading the same writer through TWO tiles counts ONE dep."""
    e = _engine()
    ta, tb = e.tile(), e.tile()
    w, _ = _ins(e, (ta, tb), (WRITE, WRITE))
    r, nd = _ins(e, (ta, tb), (READ, READ))
    assert nd == 1
    assert e.complete(w) == (r,)


def test_engine_completed_twice_raises():
    e = _engine()
    t = e.tile()
    tid, _ = _ins(e, (t,), (WRITE,))
    e.complete(tid)
    with pytest.raises(RuntimeError):
        e.complete(tid)


def test_engine_reader_compaction():
    """Hundreds of retired readers between writes must not leak into the
    WAR count of the next write."""
    e = _engine()
    t = e.tile()
    w0, _ = _ins(e, (t,), (WRITE,))
    e.complete(w0)
    for _ in range(300):
        rid, nd = _ins(e, (t,), (READ,))
        assert nd == 0                       # writer completed
        e.complete(rid)
    w1, nd = _ins(e, (t,), (WRITE,))
    assert nd == 0                           # every reader already retired
    tasks_ever, tiles_ever = e.sizes()
    assert tasks_ever == 302 and tiles_ever == 1


@pytest.mark.parametrize("seed", [3, 29])
def test_engine_matches_reference_engine(seed):
    """One seeded sequence of about 200 inserts over 16 tiles (one to
    three distinct tiles each, READ/WRITE/RW), with activations and
    completions interleaved, fed to the reference's engine and to the
    port's: every returned value is equal — ids, held guards, dependency
    counts after activate, ready tuples, successor lists — and both end
    with nothing pending."""
    ref_mod = ref_native.load_ptdtd()
    assert ref_mod is not None, "the reference's engine did not load"
    engines = (ref_mod.Engine(), _engine())

    def both(method, *args):
        out = [getattr(e, method)(*args) for e in engines]
        assert out[0] == out[1], (method, args, out)
        return out[0]

    rng = np.random.default_rng(seed)
    tiles = [both("tile") for _ in range(16)]
    ready, inserted = [], 0
    while inserted < 200 or ready:
        if inserted < 200 and (not ready or rng.random() < 0.6):
            k = int(rng.integers(1, 4))
            pick = rng.choice(16, size=k, replace=False)
            accs = [int(a) for a in rng.choice([READ, WRITE, RW], size=k)]
            tid, _held = both("insert", [tiles[i] for i in pick], accs)
            inserted += 1
            if both("activate", tid) == 0:
                ready.append(tid)
            both("deps_remaining", tid)
        else:
            tid = ready.pop(int(rng.integers(len(ready))))
            both("successors", tid)
            ready.extend(both("complete", tid))
        both("pending")
    assert both("pending") == 0
    both("sizes")


# ------------------------------------------------------------- runtime lane

def test_native_lane_chain_correctness(ctx):
    tp = DTDTaskpool(ctx, "nl")
    assert tp._native_engine() is not None, "native lane should engage"
    t = _zeros(tp, (4, 4))
    for _ in range(200):
        tp.insert_task(lambda a: a + 1.0, (t, RW), jit=False)
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    np.testing.assert_allclose(t.data.newest_copy().payload.numpy(), 200.0)


def test_native_lane_mixed_dag(ctx):
    """Diamond: w -> {r, r} -> w with real value checks through the lane."""
    tp = DTDTaskpool(ctx, "nd")
    a = tp.tile_new((2, 2), torch.float32)
    b = _zeros(tp)
    a.data.create_copy(0, torch.ones(2, 2))
    tp.insert_task(lambda x: x * 3.0, (a, RW), jit=False)          # a=3
    tp.insert_task(lambda x, y: y + x, (a, READ), (b, RW), jit=False)  # b=3
    tp.insert_task(lambda x, y: y + x, (a, READ), (b, RW), jit=False)  # b=6
    tp.insert_task(lambda x: x * 10.0, (a, RW), jit=False)         # a=30
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    np.testing.assert_allclose(a.data.newest_copy().payload.numpy(), 30.0)
    np.testing.assert_allclose(b.data.newest_copy().payload.numpy(), 6.0)


def test_native_lane_tile_mirror_introspection(ctx):
    """The Python-side chain mirror keeps last_writer/readers meaningful."""
    tp = DTDTaskpool(ctx, "nm")
    t = _zeros(tp)
    w = tp.insert_task(lambda a: a + 1.0, (t, RW), jit=False, name="W")
    r = tp.insert_task(lambda a: None, (t, READ), jit=False, name="R")
    u = tp.insert_task(lambda a: None, (t, READ | NOTRACK), jit=False,
                       name="U")
    assert w.nid >= 0 and r.nid >= 0
    assert t.last_writer is w
    assert r in t.readers and u not in t.readers
    assert u.deps_remaining == 0
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)


def test_native_lane_error_surfaces_at_wait(ctx):
    tp = DTDTaskpool(ctx, "ne")
    t = _zeros(tp)

    def bad(x):
        raise ValueError("intentional")

    tp.insert_task(bad, (t, RW), jit=False)
    with pytest.raises((ValueError, RuntimeError)):
        tp.wait(timeout=10)
        tp.close()
        ctx.wait(timeout=10)
    ctx.fini()


def test_ready_buffer_visible_to_direct_progress_loop(ctx):
    """Drain hooks: a user driving ctx._progress_loop directly (no
    tp.wait()) still sees buffered ready tasks."""
    tp = DTDTaskpool(ctx, "nb")
    hits = []
    tiles = [_zeros(tp) for _ in range(4)]
    for i, t in enumerate(tiles):
        tp.insert_task(lambda a, i=i: hits.append(i), (t, READ), jit=False)
    ctx._progress_loop(ctx.streams[0], until=lambda: len(hits) == 4,
                       timeout=10)
    assert sorted(hits) == [0, 1, 2, 3]
    tp.wait()
    tp.close()
    ctx.wait(timeout=10)


def test_native_lane_concurrent_inserters(ctx):
    """TWO user threads insert into one native-lane pool concurrently
    (disjoint tiles): the ready-buffer lock must not lose tasks and every
    body must run exactly once."""
    tp = DTDTaskpool(ctx, "nc")
    per_thread, nthreads = 2000, 2
    tiles = {t: [_zeros(tp) for _ in range(8)] for t in range(nthreads)}

    def inserter(tid):
        for i in range(per_thread):
            tp.insert_task(lambda a: a + 1.0, (tiles[tid][i % 8], RW),
                           jit=False, name=f"T{tid}")

    threads = [threading.Thread(target=inserter, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=60)
    total = sum(_val(t) for tls in tiles.values() for t in tls)
    assert total == nthreads * per_thread, total


def test_native_lane_concurrent_inserters_shared_tiles(ctx):
    """THREE user threads insert RW tasks on the SAME tiles concurrently:
    the taskpool insert lock must serialize tile chain linking (one engine
    chain per tile) and keep the inserted/local_inserted counters exact."""
    tp = DTDTaskpool(ctx, "ncs")
    per_thread, nthreads = 1500, 3
    shared = [_zeros(tp) for _ in range(4)]
    barrier = threading.Barrier(nthreads)

    def inserter(tid):
        barrier.wait()          # maximize interleaving on the same chains
        for i in range(per_thread):
            tp.insert_task(lambda a: a + 1.0, (shared[(tid + i) % 4], RW),
                           jit=False, name=f"S{tid}")

    threads = [threading.Thread(target=inserter, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tp.inserted == tp.local_inserted == nthreads * per_thread
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=60)
    assert sum(_val(t) for t in shared) == nthreads * per_thread
    assert tp.executed == nthreads * per_thread


def test_native_lane_activation_race_with_live_workers():
    """With worker threads LIVE during insertion, a fast predecessor
    completing between Engine.insert() and the id->task map store must not
    surface the unpublished id: the insertion guard is held inside the
    engine until activate(tid) runs after the map is populated."""
    c = Context(nb_cores=2, device="cpu")
    try:
        tp = DTDTaskpool(c, "race")
        assert tp._native_engine() is not None, "native lane should engage"
        c.start()            # workers live BEFORE the insert storm
        tiles = [_zeros(tp) for _ in range(4)]
        n = 20000
        for i in range(n):
            # WAW chains per tile: every insert's predecessor is a task
            # the workers are racing to complete right now
            tp.insert_task(lambda a: a + 1.0, (tiles[i % 4], RW), jit=False)
        tp.wait(timeout=120)
        tp.close()
        c.wait(timeout=60)
        assert sum(_val(t) for t in tiles) == n
    finally:
        c.fini()


def test_insert_from_worker_body_under_window_pressure():
    """A task BODY that itself inserts while a user thread is
    window-stalled must not deadlock."""
    mca.set("dtd_window_size", 16)
    mca.set("dtd_threshold_size", 8)
    c = Context(nb_cores=2, device="cpu")
    try:
        tp = DTDTaskpool(c, "rec")
        c.start()                    # workers live: bodies run on them too
        parent_t, child_t = _zeros(tp), _zeros(tp)
        n = 200

        def parent(a):
            tp.insert_task(lambda b: b + 1.0, (child_t, RW), jit=False,
                           name="child")
            return a + 1.0

        for _ in range(n):
            tp.insert_task(parent, (parent_t, RW), jit=False, name="parent")
        assert tp.wait(timeout=120), "pool wedged (stall deadlock?)"
        tp.close()
        c.wait(timeout=60)
        assert _val(parent_t) == n and _val(child_t) == n
        assert tp.executed == 2 * n
    finally:
        mca.params.unset("dtd_window_size")
        mca.params.unset("dtd_threshold_size")
        c.fini()


def test_in_progress_loop_is_thread_local(ctx):
    """The mid-body marker that bypasses window flow control is
    per-THREAD."""
    inside = []
    done = threading.Event()

    def spinner():
        ctx._tls.loop_depth = 1       # this thread "is" inside a loop
        inside.append(ctx.in_progress_loop())
        done.wait(5)

    t = threading.Thread(target=spinner)
    t.start()
    try:
        for _ in range(100):
            assert not ctx.in_progress_loop()   # main thread unaffected
    finally:
        done.set()
        t.join()
    assert inside == [True]


def test_native_lane_window_pressure(ctx):
    """Tiny insert window: the inserter stalls and drains its own tasks
    through the lean cycle mid-insertion; counts and results stay exact."""
    mca.set("dtd_window_size", 16)
    mca.set("dtd_threshold_size", 8)
    try:
        tp = DTDTaskpool(ctx, "nw")
        t = _zeros(tp)
        n = 500
        for _ in range(n):
            tp.insert_task(lambda a: a + 1.0, (t, RW), jit=False)
        assert tp.window_stalls > 0, "window never engaged"
        tp.wait()
        tp.close()
        ctx.wait(timeout=60)
        assert _val(t) == float(n)
        assert tp.executed == n
    finally:
        mca.params.unset("dtd_window_size")
        mca.params.unset("dtd_threshold_size")


def test_pins_paranoid_selects_the_python_engine():
    """``--mca pins_paranoid 1`` with a PINS callback registered keeps the
    pool on the Python engine (every task pays the full FSM); PINS alone
    keeps the native lane."""
    from parsec_tpu_torch.core import pins as pins_mod

    for paranoid in (False, True):
        mca.set("pins_paranoid", paranoid)
        c = Context(nb_cores=1, device="cpu")
        try:
            seen = []
            c.pins.register(pins_mod.EXEC_BEGIN,
                            lambda s, t, x: seen.append(t))
            tp = DTDTaskpool(c, "pp")
            t = _zeros(tp)
            for _ in range(5):
                tp.insert_task(lambda a: a + 1.0, (t, RW), jit=False)
            tp.wait()
            tp.close()
            c.wait(timeout=30)
            assert (tp._neng is None) == paranoid
            assert len(seen) == 5 and _val(t) == 5.0
        finally:
            mca.params.unset("pins_paranoid")
            c.fini()


# -------------------------------------------- the CUDA chore on the lane

def test_native_lane_with_cuda_chore_over_cpu():
    """A CUDA device on a CPU context (``device_cuda_over_cpu``) turns the
    batched lane off; the GEMM DAG then runs through the per-task native
    lane, every task on the device module, its result the reference
    product's."""
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1, device="cpu")
    try:
        dev = next(d for d in c.devices.devices if isinstance(d, CUDADevice))
        rng = np.random.default_rng(5)
        a = rng.standard_normal((64, 640)).astype(np.float32)
        b = rng.standard_normal((640, 64)).astype(np.float32)
        mats = [collection_from_numpy(n, d, 32, 32) for n, d in
                (("A", a), ("B", b), ("C", np.zeros((64, 64), np.float32)))]
        before = PTDTD_STATS.snapshot()
        tp = DTDTaskpool(c, "cc")
        n = insert_gemm_tasks(tp, *mats, batch_k=True)
        assert tp._neng is not None and not tp._batch_on
        assert len(c._dtd_ntasks) == n        # every task on the lane
        ex0 = dev.executed_tasks
        tp.wait()
        tp.close()
        c.wait(timeout=60)
        assert dev.executed_tasks - ex0 == n == 4
        assert c._dtd_ntasks == {}
        assert PTDTD_STATS.delta(before)["pools_batch"] == 0
        np.testing.assert_allclose(mats[2].to_dense(),
                                   a.astype(np.float64) @ b,
                                   rtol=1e-4, atol=1e-3)
    finally:
        c.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")


# ------------------------------------------- native lane vs Python engine

def _gemm_dag(kt: int):
    rng = np.random.default_rng(17)
    a, b, c0 = (rng.standard_normal(sh).astype(np.float32)
                for sh in ((64, 32 * kt), (32 * kt, 64), (64, 64)))
    A, B, C = (collection_from_numpy(n, d, 32, 32) for n, d in
               (("A", a), ("B", b), ("C", c0)))
    return lambda tp: insert_gemm_tasks(tp, A, B, C, batch_k=True), C


def _potrf_dag():
    P = collection_from_numpy("P", make_spd(256, seed=4), 64, 64)
    return lambda tp: insert_potrf_tasks(tp, P), P


def _run_dag(make, native: bool, over_cuda: bool):
    """One DAG of ``make()`` on a fresh CPU context: (its output matrix,
    whether the pool took the native engine)."""
    if not native:
        mca.set("native_enabled", False)
    if over_cuda:
        mca.set("device_cuda_over_cpu", True)
        mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1, device="cpu")
    try:
        insert, out = make()
        tp = DTDTaskpool(c, "x")
        n = insert(tp)
        tp.wait()
        tp.close()
        c.wait(timeout=120)
        assert tp.executed == n and c._dtd_ntasks == {}
        return out.to_dense(), tp._neng is not None
    finally:
        c.fini()
        mca.params.unset("native_enabled")
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")


@pytest.mark.parametrize("over_cuda", [False, True])
@pytest.mark.parametrize("dag", ["gemm_kt20", "gemm_kt32", "potrf_256"])
def test_native_lane_equals_python_engine_bit_for_bit(dag, over_cuda):
    """The GEMM (64 x 32kt by 32kt x 64 in 32^2 tiles; kt = 20, and kt = 32,
    whose GEMM_K tasks carry the main path's 65 flows) and POTRF 256 in
    64^2 tiles: the native lane's result equals the Python engine's bit
    for bit — the same bodies in the same per-tile chain order — on the
    CPU chore and on the CUDA chore."""
    make = _potrf_dag if dag == "potrf_256" else \
        (lambda: _gemm_dag(int(dag[len("gemm_kt"):])))
    got, lane = _run_dag(make, True, over_cuda)
    want, py_lane = _run_dag(make, False, over_cuda)
    assert lane and not py_lane
    np.testing.assert_array_equal(got, want)


def test_engine_takes_the_main_paths_65_flow_tasks():
    """The GEMM_K body of a k-chain of 32 carries 65 flows. The reference's
    engine refuses a task of more than 64; the port's copy takes up to
    1024 and links a 65-flow reader of 65 tiles written before it with one
    dependency a writer, like any other task."""
    ref_e = ref_native.load_ptdtd().Engine()
    with pytest.raises(ValueError, match="max 64"):
        ref_e.insert([ref_e.tile() for _ in range(65)], [READ] * 65)
    e = _engine()
    tiles = [e.tile() for _ in range(65)]
    writers = [_ins(e, (t,), (WRITE,))[0] for t in tiles]
    reader, nd = _ins(e, tiles, [READ] * 65)
    assert nd == 65
    for w in writers[:-1]:
        assert e.complete(w) == ()
    assert e.complete(writers[-1]) == (reader,)
    with pytest.raises(ValueError, match="max 1024"):
        e.insert([e.tile() for _ in range(1025)], [READ] * 1025)


# ------------------------------------------------------------------ build

def test_extensions_are_the_ports_own():
    """The port's _ptdtd and _ptsched are built from its csrc/ into its
    build/ and are other module objects than the reference's; a plane of
    one package cannot bind into the other's engine."""
    import os

    ref_dtd, ref_sched = ref_native.load_ptdtd(), ref_native.load_ptsched()
    dtd, sched = native_mod.load_ptdtd(), native_mod.load_ptsched()
    assert dtd.__name__ == "parsec_tpu_torch._ptdtd"
    assert sched.__name__ == "parsec_tpu_torch._ptsched"
    for mod in (dtd, sched):
        assert os.path.dirname(mod.__file__) == native_mod.BUILD_DIR
    assert dtd is not ref_dtd and dtd.Engine is not ref_dtd.Engine
    assert sched is not ref_sched and sched.Plane is not ref_sched.Plane
    port_plane = sched.Plane(nworkers=1).plane_capsule()
    ref_plane = ref_sched.Plane(nworkers=1).plane_capsule()
    assert "parsec_tpu_torch.ptsched.plane" in repr(port_plane)
    with pytest.raises(ValueError):
        ref_dtd.Engine().sched_bind(port_plane)
    with pytest.raises(ValueError):
        dtd.Engine().sched_bind(ref_plane)
    dtd.Engine().sched_bind(port_plane)


def test_failed_build_raises_while_enabled(monkeypatch):
    """With the engine enabled, a compiler that fails raises (with its
    messages) instead of running the Python engine; with
    ``--mca native_enabled 0`` the same context runs the Python engine and
    builds nothing."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native_mod, "_mods", {})
    with pytest.raises(RuntimeError, match="building ptsched failed"):
        Context(nb_cores=1, device="cpu")
    with pytest.raises(RuntimeError, match="building ptdtd failed"):
        native_mod.load_ptdtd()
    mca.set("native_enabled", False)
    try:
        c = Context(nb_cores=1, device="cpu")
        try:
            assert c.sched_plane is None
            tp = DTDTaskpool(c, "py")
            t = _zeros(tp)
            for _ in range(3):
                tp.insert_task(lambda a: a + 1.0, (t, RW), jit=False)
            tp.wait()
            tp.close()
            c.wait(timeout=30)
            assert tp._neng is None and _val(t) == 3.0
        finally:
            c.fini()
    finally:
        mca.params.unset("native_enabled")
