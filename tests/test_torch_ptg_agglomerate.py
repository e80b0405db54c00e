"""The port's PTG static-independence agglomeration + the chain-EP graph
(the reference scheduler microbench shape, tests/runtime/scheduling/ep.jdf):
the reference's ``tests/test_ptg_agglomerate.py`` on the port, plus a
cross-check of the chain-EP counts against the reference.
"""

import pytest

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
from parsec_tpu_torch.utils import mca


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


FLAT = "%global NT\n%global hit\nEP(i)\n  i = 0 .. NT-1\nBODY\n  hit(i)\nEND\n"

CHAIN = """
%global NT
%global DEPTH
INIT(z)
  z = 0 .. 0
  CTL S -> (DEPTH >= 1) ? S T(1 .. NT, 1)
BODY
  pass
END

T(i, l)
  i = 1 .. NT
  l = 1 .. DEPTH
  CTL S <- (l == 1) ? S INIT(0) : S T(i, l-1)
        -> (l < DEPTH) ? S T(i, l+1)
BODY
  pass
END
"""


def test_agglomerated_body_side_effects(ctx):
    """A flowless depless class runs as one fused sweep — every instance's
    body still executes exactly once."""
    hits = []
    tp = compile_ptg(FLAT, "ep").instantiate(
        ctx, globals={"NT": 500, "hit": hits.append}, collections={},
        name="agg")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    assert sorted(hits) == list(range(500))
    assert tp._agglomerated == 500
    assert tp.nb_tasks == 0


def test_agglomeration_disabled_by_mca(ctx):
    hits = []
    mca.set("ptg_agglomerate", False)
    try:
        tp = compile_ptg(FLAT, "ep").instantiate(
            ctx, globals={"NT": 100, "hit": hits.append}, collections={},
            name="noagg")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)
        assert sorted(hits) == list(range(100))
        assert tp._agglomerated == 0         # per-task scheduling path
    finally:
        mca.params.unset("ptg_agglomerate")


def test_triangular_space_agglomerates_via_dict_walk(ctx):
    """Param-dependent bounds (j <= i) can't take the product fast path
    but still agglomerate through the enumerator."""
    hits = []
    src = ("%global N\n%global hit\nTRI(i, j)\n  i = 0 .. N-1\n"
           "  j = 0 .. i\nBODY\n  hit((i, j))\nEND\n")
    tp = compile_ptg(src, "tri").instantiate(
        ctx, globals={"N": 10, "hit": hits.append}, collections={},
        name="tri")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    assert len(hits) == 55                   # 10*11/2
    assert sorted(hits) == [(i, j) for i in range(10) for j in range(i + 1)]


def test_chain_ep_completes_and_orders(ctx):
    """The reference ep.jdf DAG shape: INIT gates NT CTL chains of DEPTH
    levels; every task runs, chains stay ordered (regression for the
    burst-batch task-loss bug)."""
    nt, depth = 24, 5
    prog = compile_ptg(CHAIN, "chain_ep")
    tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                          collections={}, name="chain")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    assert tp.nb_tasks == 0
    # nothing agglomerated: every class has CTL flows
    assert getattr(tp, "_agglomerated", 0) == 0


def test_ctl_classes_not_agglomerated(ctx):
    """A class with any flow (even pure CTL) must keep per-task
    scheduling — its completions release successors."""
    prog = compile_ptg(CHAIN, "chain_ep")
    tp = prog.instantiate(ctx, globals={"NT": 2, "DEPTH": 2},
                          collections={}, name="gate")
    for name in ("INIT", "T"):
        assert not tp._agglomerable(tp._classes[name])
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)


def test_cross_check_chain_ep_counts():
    """The chain-EP shape through both packages: the same task space, the
    same agglomeration verdicts, and the port's pool on the native lane."""
    import parsec_tpu as pt
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    nt, depth = 24, 5
    rctx = pt.Context(nb_cores=1)
    try:
        rtp = ref_compile(CHAIN, "chain_ep").instantiate(
            rctx, globals={"NT": nt, "DEPTH": depth}, collections={})
        ref_space = sum(1 for _ in rtp._enumerate())
        ref_agg = {n: rtp._agglomerable(c) for n, c in rtp._classes.items()}
        rctx.add_taskpool(rtp)
        rctx.wait(timeout=60)
    finally:
        rctx.fini()
    ctx = Context(nb_cores=1, device="cpu")
    try:
        tp = compile_ptg(CHAIN, "chain_ep").instantiate(
            ctx, globals={"NT": nt, "DEPTH": depth}, collections={})
        assert sum(1 for _ in tp._enumerate()) == ref_space == 1 + nt * depth
        assert {n: tp._agglomerable(c) for n, c in tp._classes.items()} \
            == ref_agg
        s0 = PTEXEC_STATS.snapshot()
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        d = PTEXEC_STATS.delta(s0)
        assert d["pools_engaged"] == 1 and d["tasks_engaged"] == ref_space
        assert tp.nb_tasks == 0
    finally:
        ctx.fini()
