"""Multi-worker stress of the port: the same DAGs under real thread
concurrency.

The reference's single-rank tests (tests/test_concurrency.py) on the
port's CPU context, with 4 worker threads (2 for the untied test) to shake
out races in the scheduler, tile chains, dep counters and the free-
threading deque. Its 2-rank test waits for the distributed slice."""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context as _Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd


def Context(**kw):
    """A port context on the CPU (the card is the port's default)."""
    return _Context(device="cpu", **kw)


@pytest.mark.parametrize("sched", ["lfq", "ap"])
def test_gemm_four_workers(sched):
    ctx = Context(nb_cores=4, scheduler=sched)
    n, ts = 128, 32
    rng = np.random.default_rng(60)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = TiledMatrix("A4", n, n, ts, ts)
    B = TiledMatrix("B4", n, n, ts, ts)
    C = TiledMatrix("C4", n, n, ts, ts)
    A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    B.fill(lambda k, j: b[k*ts:(k+1)*ts, j*ts:(j+1)*ts])
    C.fill(lambda m, j: np.zeros((ts, ts), np.float32))
    tp = DTDTaskpool(ctx, "gemm4")
    insert_gemm_tasks(tp, A, B, C)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()
    np.testing.assert_allclose(C.to_dense(), a @ b, rtol=1e-3, atol=1e-3)


def test_potrf_four_workers():
    ctx = Context(nb_cores=4)
    n, ts = 128, 32
    spd = make_spd(n, seed=61)
    A = TiledMatrix("P4", n, n, ts, ts)
    A.fill(lambda m, k: spd[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    tp = DTDTaskpool(ctx, "potrf4")
    insert_potrf_tasks(tp, A)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=60)
    ctx.fini()
    L = np.tril(A.to_dense())
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)


def test_untied_tasks_insert_from_body():
    """A task body inserting more tasks into its own taskpool (the untied
    tasks-inserting-tasks pattern of the reference's DTD tests)."""
    ctx = Context(nb_cores=2)
    tp = DTDTaskpool(ctx, "untied")
    t = tp.tile_new((2, 2), torch.float32)
    spawned = []

    def child(x):
        spawned.append(1)
        return x + 1.0

    def parent(x):
        for _ in range(3):
            tp.insert_task(child, (t, RW), jit=False)
        return x + 1.0

    tp.insert_task(parent, (t, RW), jit=False)
    tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=30)
    ctx.fini()
    assert len(spawned) == 3
    assert np.allclose(np.asarray(t.data.newest_copy().payload), 4.0)


def test_explicit_locked_deque_multithreaded():
    """The free-threading fallback deque (_ExplicitLockedDeque, selected
    automatically when the GIL is off) keeps every element exactly once
    under concurrent push/pop from both ends."""
    import threading

    from parsec_tpu_torch.core.scheduler import _ExplicitLockedDeque, _LockedDeque

    # same surface as the GIL-atomic variant
    assert {m for m in dir(_LockedDeque) if not m.startswith("__")} <= \
        set(dir(_ExplicitLockedDeque))

    dq = _ExplicitLockedDeque()
    N, W = 2000, 4
    popped = [[] for _ in range(W)]

    def producer(base):
        for i in range(N):
            (dq.push_front if i % 2 else dq.push_back)([base + i])

    def consumer(out):
        misses = 0
        while misses < 3:
            item = dq.pop_front() if len(out) % 2 else dq.pop_back()
            if item is None:
                misses += 1
                continue
            out.append(item)

    prods = [threading.Thread(target=producer, args=(w * N,))
             for w in range(W)]
    cons = [threading.Thread(target=consumer, args=(popped[w],))
            for w in range(W)]
    for t in prods + cons:
        t.start()
    for t in prods:
        t.join(timeout=30)
    for t in cons:
        t.join(timeout=30)
    while True:            # drain anything the consumers gave up on
        item = dq.pop_front()
        if item is None:
            break
        popped[0].append(item)
    got = sorted(x for out in popped for x in out)
    assert got == list(range(W * N))
