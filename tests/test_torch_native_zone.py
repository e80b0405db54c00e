"""The port's native core (``csrc/ptcore.cpp``) and the arenas.

The reference's tests of its native core (tests/test_native.py: the
dependency table in mask and counter mode, under growth and under threads,
the zone allocator, a taskpool's native table) run on the port's copy, and
a cross-check drives the port's ``NativeZone`` and the reference's with the
same seeded sequence of allocations and frees: the same offsets, the same
failures and the same statistics. The arena (``data/arena.py``, host torch
buffers) has no caller until the distributed slice; its test is its user.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from parsec_tpu import native as ref_native
from parsec_tpu_torch import native
from parsec_tpu_torch.data import arena as A
from parsec_tpu_torch.data.data import Data
from parsec_tpu_torch.utils import mca
from parsec_tpu_torch.utils.zone_malloc import ZoneMalloc


def test_dep_table_mask_mode():
    t = native.NativeDepTable(1 << 10)
    # three dep bits; ready exactly when all three arrive
    assert not t.update((3, 7), 0b001, 0b111, False)
    assert not t.update((3, 7), 0b010, 0b111, False)
    assert t.get((3, 7)) == 0b011
    assert t.update((3, 7), 0b100, 0b111, False)
    # entry retired: same key restarts from scratch
    assert t.get((3, 7)) == 0
    assert not t.update((3, 7), 0b001, 0b111, False)


def test_dep_table_counter_mode_and_single_dep():
    t = native.NativeDepTable()
    assert not t.update((1,), 1, 3, True)
    assert not t.update((1,), 1, 3, True)
    assert t.update((1,), 1, 3, True)
    # goal reached on first contribution -> never stored
    assert t.update((9, 9, 9), 1, 1, True)
    assert len(t) == 0


def test_dep_table_many_keys():
    t = native.NativeDepTable(1 << 8)  # force probing/growth pressure
    n = 500
    for i in range(n):
        assert not t.update((i, i * 31), 1, 2, True)
    assert len(t) == n
    for i in range(n):
        assert t.update((i, i * 31), 1, 2, True)
    assert len(t) == 0


def test_dep_table_concurrent():
    t = native.NativeDepTable(1 << 12)
    ready = []
    lock = threading.Lock()
    GOAL = 8

    def worker(wid):
        local = []
        for i in range(200):
            if t.update((i,), 1, GOAL, True):
                local.append(i)
        with lock:
            ready.extend(local)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(GOAL)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    # each key becomes ready exactly once
    assert sorted(ready) == list(range(200))


def test_native_zone_matches_python_semantics():
    z = native.NativeZone(16 << 20, unit=1 << 20)
    a = z.alloc(4 << 20)
    b = z.alloc(4 << 20)
    c = z.alloc(8 << 20)
    assert z.alloc(1) is None
    z.free(b, 4 << 20)
    d = z.alloc(2 << 20)
    assert d == b
    z.free(a, 4 << 20); z.free(c, 8 << 20); z.free(d, 2 << 20)
    st = z.stats()
    assert st["free_bytes"] == 16 << 20
    assert st["largest_hole_bytes"] == 16 << 20


def test_taskpool_uses_native_for_int_keys():
    """PTG-style int-tuple keys ride the native dep engine."""
    from parsec_tpu_torch.core.task import TaskClass, Taskpool
    tp = Taskpool("nat")
    tc = TaskClass("T")
    tc.count_mode = True
    tc.make_key = lambda _tp, loc: (loc["k"],)
    tp.add_task_class(tc)
    assert not tp.update_deps(tc, (5,), 1, goal=2)
    assert tp.update_deps(tc, (5,), 1, goal=2)
    assert not isinstance(tp._deps[tc.task_class_id], dict)


def test_native_zone_off_raises():
    mca.set("native_enabled", False)
    try:
        with pytest.raises(RuntimeError, match="native core is off"):
            native.NativeZone(1 << 20)
    finally:
        mca.params.unset("native_enabled")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_zone_matches_the_reference_and_zone_malloc(seed):
    """A seeded run of allocations and frees through the port's zone, the
    reference's zone and the Python ZoneMalloc: the same offsets (None
    where no hole fits) and, at every step, the same statistics."""
    rng = np.random.default_rng(seed)
    unit = 1 << 16
    port = native.NativeZone(64 * unit, unit=unit)
    ref = ref_native.NativeZone(64 * unit, unit=unit)
    py = ZoneMalloc(64 * unit, unit=unit)
    live = []
    for _ in range(300):
        if live and rng.random() < 0.45:
            off, nbytes, seg = live.pop(int(rng.integers(len(live))))
            port.free(off, nbytes)
            ref.free(off, nbytes)
            seg.free()
        else:
            nbytes = int(rng.integers(1, 12 * unit))
            got, want = port.alloc(nbytes), ref.alloc(nbytes)
            seg = py.allocate(nbytes)
            assert got == want == (None if seg is None else seg.offset)
            if got is not None:
                live.append((got, nbytes, seg))
        assert port.stats() == ref.stats()
        assert port.stats()["free_bytes"] == py.stats()["free_bytes"]


# ------------------------------------------------------------- arenas

def test_arena_allocate_cache_and_caps():
    a = A.Arena((4, 8), torch.float32, max_cached=2, max_used=3)
    assert a.elem_size == 4 * 8 * 4
    chunks = [a.allocate() for _ in range(3)]
    assert all(c.buffer.shape == (4, 8) and c.buffer.dtype == torch.float32
               and c.buffer.device.type == "cpu" for c in chunks)
    with pytest.raises(MemoryError):
        a.allocate()
    bufs = [c.buffer for c in chunks]
    for c in chunks:
        c.free()
    st = a.stats()
    assert st == {"used": 0, "cached": 2, "hwm": 3, "elem_size": 128}
    again = a.allocate()                 # LIFO: the last freed comes back
    assert again.buffer is bufs[1]


def test_arena_registry_and_new_copy():
    a1 = A.arena_for((2, 2), torch.bfloat16)
    assert A.arena_for((2, 2), "bfloat16") is a1
    assert A.arena_for((2, 2), torch.float32) is not a1
    assert a1.elem_size == 8
    d = Data(key=0, shape=(2, 2), dtype=torch.bfloat16)
    c = a1.new_copy(d, device_index=0)
    assert d.get_copy(0) is c and c.arena_chunk.arena is a1
    assert c.payload.dtype == torch.bfloat16
    c.arena_chunk.free()
    dt = A.ArenaDatatype(a1)
    assert dt.dtt == ((2, 2), torch.bfloat16)


def test_arena_mca_defaults():
    a = A.Arena((1,), torch.float64)
    assert a.max_cached == mca.get("arena_max_cached", 256) == 256
    assert a.max_used == mca.get("arena_max_used", 0) == 0


def test_arena_buffers_return_when_released_or_dropped():
    """A receive buffer handed out of an arena goes back to its cache by
    release_buffer(), or gives its slot back when it dies unreleased."""
    a = A.Arena((3,), torch.float32)
    c = a.allocate()
    buf = c.buffer
    A.attach_chunk(buf, c)
    A.release_buffer(buf)
    assert a.stats()["used"] == 0 and a.stats()["cached"] == 1
    A.release_buffer(torch.zeros(3))     # not an arena buffer: no-op
    c2 = a.allocate()
    buf2 = c2.buffer
    assert buf2 is buf                   # the cached buffer, reused
    A.attach_chunk(buf2, c2)
    assert a.stats()["used"] == 1 and a.stats()["cached"] == 0
    del buf, buf2, c2
    gc.collect()
    assert a.stats()["used"] == 0
