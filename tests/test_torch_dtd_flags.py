"""The port's DTD insert-task interface: the reference's tests that had no
port yet (tests/test_dtd.py: the tiled GEMM, a block-cyclic collection,
``data_flush_all`` and three NOTRACK tests) on the port's CPU context.
The fourth NOTRACK test, ``test_notrack_does_not_steer_placement``, checks
owner-computes placement by tile rank, which comes with the distributed
half of the DTD engine.
"""

import numpy as np
import pytest

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix, TwoDimBlockCyclic
from parsec_tpu_torch.dsl.dtd import AFFINITY, DTDTaskpool, READ, RW


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


def test_tiled_gemm_dtd(ctx):
    """Tiled GEMM through insert_task vs numpy (the reference's
    dtd_test_simple_gemm.c correctness check)."""
    MT = NT = KT = 3
    TS = 16
    rng = np.random.default_rng(0)
    A = TiledMatrix("A", MT * TS, KT * TS, TS, TS)
    B = TiledMatrix("B", KT * TS, NT * TS, TS, TS)
    C = TiledMatrix("C", MT * TS, NT * TS, TS, TS)
    A.fill(lambda m, n: rng.standard_normal((TS, TS)).astype(np.float32))
    B.fill(lambda m, n: rng.standard_normal((TS, TS)).astype(np.float32))
    C.fill(lambda m, n: np.zeros((TS, TS), np.float32))

    tp = DTDTaskpool(ctx, "gemm")

    def gemm(c, a, b):
        return c + a @ b

    for m in range(MT):
        for n in range(NT):
            tc = tp.tile_of(C, m, n)
            for k in range(KT):
                tp.insert_task(gemm, (tc, RW | AFFINITY),
                               (tp.tile_of(A, m, k), READ),
                               (tp.tile_of(B, k, n), READ))
    tp.wait()
    tp.close()
    ctx.wait()
    ref = A.to_dense() @ B.to_dense()
    assert np.allclose(C.to_dense(), ref, atol=1e-3)


def test_two_collections_block_cyclic(ctx):
    """tile_of over a 2D block-cyclic collection on 1 rank behaves densely."""
    A = TwoDimBlockCyclic("A", 64, 64, 16, 16, P=1, Q=1)
    A.fill(lambda m, n: np.full((16, 16), m * 10.0 + n, np.float32))
    tp = DTDTaskpool(ctx, "bc")
    for m in range(A.mt):
        for n in range(A.nt):
            tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, m, n), RW))
    tp.wait()
    tp.close()
    ctx.wait()
    for m in range(A.mt):
        for n in range(A.nt):
            assert np.allclose(
                np.asarray(A.data_of(m, n).newest_copy().payload),
                2 * (m * 10.0 + n))


def test_flush_all(ctx):
    """data_flush_all writes tiles home in dependency order."""
    A = TiledMatrix("A", 8, 8, 4, 4)
    A.fill(lambda m, n: np.ones((4, 4), np.float32))
    tp = DTDTaskpool(ctx, "flush")
    for m in range(2):
        for n in range(2):
            tp.insert_task(lambda x: x + 41.0, (tp.tile_of(A, m, n), RW))
    tp.data_flush_all(A)
    tp.wait()
    tp.close()
    ctx.wait()
    assert np.allclose(A.to_dense(), 42.0)


def test_notrack_flag_skips_dependency_chaining(ctx):
    """NOTRACK (ref PARSEC_DONT_TRACK, dtd_test_flag_dont_track.c): the
    value flows to the body but the access creates no RAW/WAR/WAW edges."""
    from parsec_tpu_torch.dsl.dtd import NOTRACK
    A = TiledMatrix("Ant", 8, 8, 8, 8)
    A.fill(lambda m, n: np.full((8, 8), 5.0, np.float32))
    tp = DTDTaskpool(ctx, "notrack")
    t = tp.tile_of(A, 0, 0)

    writer = tp.insert_task(lambda a: a + 1.0, (t, RW), name="W")
    # a TRACKED read chains on the writer; an UNTRACKED read does not
    # (deps_remaining == 0 means ready; reading it does not consume deps)
    tracked = tp.insert_task(lambda a: None, (t, READ), jit=False, name="R")
    untracked = tp.insert_task(lambda a: None, (t, READ | NOTRACK),
                               jit=False, name="U")
    assert tracked.deps_remaining == 1 or writer.completed
    assert untracked.deps_remaining == 0
    assert untracked not in t.readers
    # an untracked WRITE neither joins nor resets the chain
    uw = tp.insert_task(lambda a: a * 2.0, (t, RW | NOTRACK), name="UW")
    assert uw.deps_remaining == 0
    assert t.last_writer is writer
    tp.wait()
    tp.close()
    ctx.wait()
    # both writes landed, in an UNDEFINED order (that is the NOTRACK
    # contract). UW's input is snapshotted at INSERT time (ref
    # insert_function.c:3038): 5 if W hadn't executed yet, 6 if it had —
    # so the final value is 5*2=10 or 5+1=6-overwritten orders: {10, 11, 12}
    val = float(np.asarray(A.data_of(0, 0).newest_copy().payload)[0, 0])
    assert val in (10.0, 11.0, 12.0), val


def test_notrack_value_reaches_body(ctx):
    """The untracked tile's CURRENT value is what the body sees."""
    from parsec_tpu_torch.dsl.dtd import NOTRACK
    A = TiledMatrix("Antv", 8, 8, 8, 8)
    A.fill(lambda m, n: np.full((8, 8), 3.0, np.float32))
    B = TiledMatrix("Bntv", 8, 8, 8, 8)
    B.fill(lambda m, n: np.zeros((8, 8), np.float32))
    tp = DTDTaskpool(ctx, "notrack-val")
    ta, tb = tp.tile_of(A, 0, 0), tp.tile_of(B, 0, 0)
    tp.insert_task(lambda scratch, out: out + scratch,
                   (ta, READ | NOTRACK), (tb, RW), name="ADD")
    tp.wait()
    tp.close()
    ctx.wait()
    assert np.allclose(B.to_dense(), 3.0)


def test_notrack_snapshots_value_at_insert(ctx):
    """ref insert_function.c:3038: the untracked flow's value is captured at
    insert_task time, not at execution — a tracked write that lands between
    insertion and execution is invisible to the untracked reader."""
    from parsec_tpu_torch.dsl.dtd import NOTRACK
    A = TiledMatrix("Ants", 8, 8, 8, 8)
    A.fill(lambda m, n: np.full((8, 8), 5.0, np.float32))
    seen = []
    tp = DTDTaskpool(ctx, "notrack-snap")
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(lambda a: a + 1.0, (t, RW), name="W")
    tp.insert_task(lambda a: seen.append(float(np.asarray(a)[0, 0])),
                   (t, READ | NOTRACK), jit=False, name="U")
    tp.wait()
    tp.close()
    ctx.wait()
    assert seen == [5.0], seen     # pre-W snapshot, even if W ran first
