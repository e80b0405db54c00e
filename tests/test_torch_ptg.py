"""The port's PTG frontend (``parsec_tpu_torch/dsl/ptg/``): the reference's
``tests/test_ptg.py`` on one rank — parser, compiler, execution, and the
negative battery (the ptgpp compile-error tests) — with every PTG source as
the reference has it and only the BODY text written in torch; plus
cross-checks that run one program through both packages. The two-rank
tests wait for the distributed half of the port.
"""

import numpy as np
import pytest

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.ptg import parser as P
from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
from parsec_tpu_torch.utils import mca


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


CHAIN_SRC = """
// Ex04_ChainData-style chain: T(0) reads A(0), each T(k) passes X onward,
// the last task writes back to memory (BASELINE config 1)
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
"""


def test_parse_chain():
    prog = P.parse(CHAIN_SRC)
    assert [tc.name for tc in prog.task_classes] == ["T"]
    tc = prog.task_classes[0]
    assert tc.params == ["k"]
    assert tc.affinity.name == "A"
    assert len(tc.affinity.index_exprs) == 2
    assert len(tc.flows) == 1
    f = tc.flows[0]
    assert f.access == P.FLOW_RW
    assert [d.direction for d in f.deps] == ["in", "out"]
    assert f.deps[0].guard == "k == 0"
    assert f.deps[0].endpoint.kind == "memory"
    assert f.deps[0].else_endpoint.kind == "task"
    assert tc.bodies[0].device == "CPU"


def test_chain_executes(ctx):
    NT = 16
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    prog = compile_ptg(CHAIN_SRC, "chain")
    tp = prog.instantiate(ctx, globals={"NT": NT},
                          collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    assert tp.completed
    # NT increments flowed through the chain and back to memory
    assert np.allclose(A.to_dense(), NT)


FORK_JOIN_SRC = """
%global W
%global A

SPLIT(z)
  z = 0 .. 0
  : A(0, 0)
  RW X <- A(0, 0)
     -> Y WORK(0 .. W-1)
BODY
  X = X * 1.0
END

WORK(i)
  i = 0 .. W-1
  : A(0, 0)
  RW Y <- X SPLIT(0)
     -> (i == 0) ? Y JOIN(0)
  CTL c -> (i > 0) ? c JOIN(0)
BODY
  Y = Y + i + 1
END

JOIN(z)
  z = 0 .. 0
  : A(0, 0)
  RW Y <- Y WORK(0)
     -> A(0, 0)
  CTL c <- c WORK(1 .. W-1)
BODY
  Y = Y * 2.0
END
"""


def test_fork_join_with_range_deps(ctx):
    """Broadcast out-dep (X -> Y WORK(0..W-1)) + CTL range gather
    (c <- c WORK(1..W-1)): JDF's multicast/join constructs."""
    W = 4
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), 5.0, np.float32))
    prog = compile_ptg(FORK_JOIN_SRC, "forkjoin")
    tp = prog.instantiate(ctx, globals={"W": W}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    assert tp.completed
    # JOIN doubles WORK(0)'s result: (5 + 0 + 1) * 2
    assert np.allclose(A.to_dense(), 12.0)


def test_range_gather_on_data_flow_rejected():
    """A data flow with a range gather input is a compile error (only CTL
    flows may gather; a data flow has exactly one input)."""
    src = """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k, 0)
     -> X U(0)

U(z)
  z = 0 .. 0
  RW X <- X T(0 .. 3)
     -> A(0, 0)
BODY
  X = X
END
"""
    # note: T lacks BODY too, but the range-gather check must fire on U
    src = src.replace("-> X U(0)\n", "-> X U(0)\nBODY\n  X = X\nEND\n")
    with pytest.raises(P.PTGSyntaxError):
        ctx = Context(nb_cores=1, device="cpu")
        try:
            compile_ptg(src).instantiate(ctx, globals={}, collections={"A": None})
        finally:
            ctx.fini()


GEMM_SRC = """
// Tiled GEMM as PTG (BASELINE config 2): C[m,n] += sum_k A[m,k]B[k,n]
%global MT
%global NT
%global KT
%global descA
%global descB
%global descC

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : descC(m, n)
  priority = KT - k
  READ A <- descA(m, k)
  READ B <- descB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY [type=TPU]
  C = C + torch.matmul(A, B)
END
"""


def test_ptg_gemm(ctx):
    MT = NT = KT = 3
    TS = 16
    rng = np.random.default_rng(11)
    a = rng.standard_normal((MT*TS, KT*TS)).astype(np.float32)
    b = rng.standard_normal((KT*TS, NT*TS)).astype(np.float32)
    A = TiledMatrix("A", MT*TS, KT*TS, TS, TS)
    B = TiledMatrix("B", KT*TS, NT*TS, TS, TS)
    Cm = TiledMatrix("C", MT*TS, NT*TS, TS, TS)
    A.fill(lambda m, k: a[m*TS:(m+1)*TS, k*TS:(k+1)*TS])
    B.fill(lambda k, n: b[k*TS:(k+1)*TS, n*TS:(n+1)*TS])
    Cm.fill(lambda m, n: np.zeros((TS, TS), np.float32))
    prog = compile_ptg(GEMM_SRC, "gemm")
    tp = prog.instantiate(ctx, globals={"MT": MT, "NT": NT, "KT": KT},
                          collections={"descA": A, "descB": B, "descC": Cm})
    ctx.add_taskpool(tp)
    ctx.wait()
    np.testing.assert_allclose(Cm.to_dense(), a @ b, rtol=1e-3, atol=1e-3)


def test_two_classes_pipeline(ctx):
    """Producer/consumer across classes with a CTL dependency."""
    src = """
%global N
%global A

PROD(k)
  k = 0 .. N-1
  : A(k, 0)
  RW X <- A(k, 0)
     -> X CONS(k)
BODY
  X = X + 10.0
END

CONS(k)
  k = 0 .. N-1
  : A(k, 0)
  RW X <- X PROD(k)
     -> A(k, 0)
BODY
  X = X * 2.0
END
"""
    N = 4
    A = TiledMatrix("A", 4 * N, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), float(m), np.float32))
    prog = compile_ptg(src, "pipe")
    tp = prog.instantiate(ctx, globals={"N": N}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    for k in range(N):
        got = np.asarray(A.data_of(k, 0).newest_copy().payload)
        assert np.allclose(got, (k + 10.0) * 2.0), k


# ---------------------------------------------------------------------------
# negative battery (ref: tests/dsl/ptg/ptgpp — 17 must-fail JDFs)
# ---------------------------------------------------------------------------

NEGATIVE_SOURCES = {
    "no_body": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
""",
    "param_without_range": """
%global A
T(k, m)
  k = 0 .. 3
  RW X <- A(k)
BODY
  X = X
END
""",
    "duplicate_params": """
%global A
T(k, k)
  k = 0 .. 3
  RW X <- A(k)
BODY
  X = X
END
""",
    "duplicate_flow": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
  READ X <- A(k)
BODY
  X = X
END
""",
    "unknown_peer_class": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
     -> X U(k+1)
BODY
  X = X
END
""",
    "unknown_peer_flow": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
     -> Y T(k+1)
BODY
  X = X
END
""",
    "wrong_arity": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
     -> X T(k+1, 0)
BODY
  X = X
END
""",
    "flow_without_input": """
%global A
T(k)
  k = 0 .. 3
  RW X -> A(k)
BODY
  X = X
END
""",
    "body_with_return": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
BODY
  return X
END
""",
    "bad_expression": """
%global A
T(k)
  k = 0 .. )(
  RW X <- A(k)
BODY
  X = X
END
""",
    "too_many_flows": "%global A\nT(k)\n  k = 0 .. 3\n" + "".join(
        f"  READ F{i} <- A(k)\n" for i in range(20)) + "BODY\n  pass\nEND\n",
    "duplicate_class": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
BODY
  X = X
END

T(m)
  m = 0 .. 3
  RW X <- A(m)
BODY
  X = X
END
""",
    "unknown_body_device": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
BODY [type=FPGA]
  X = X
END
""",
    "body_without_end": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
BODY
  X = X
""",
    "dep_outside_flow": """
%global A
T(k)
  k = 0 .. 3
  <- A(k)
BODY
  pass
END
""",
    "garbage_line": """
%global A
T(k)
  k = 0 .. 3
  this is not a valid construct !!!
  RW X <- A(k)
BODY
  X = X
END
""",
    "no_task_classes": """
%global A
""",
    # NULL / NEW are input-only (ref: ptgpp output_NULL*, output_NEW* —
    # "NULL data only supported in IN dependencies." / "Automatic data
    # allocation with NEW only supported in IN dependencies.")
    "output_NULL": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
       -> NULL
BODY
  X = X
END
""",
    "output_NULL_true": """
%global A
T(k)
  k = 0 .. 10
  RW X <- A(k)
       -> (k < 5) ? NULL : A(k)
BODY
  X = X
END
""",
    "output_NULL_false": """
%global A
T(k)
  k = 0 .. 10
  RW X <- A(k)
       -> (k < 5) ? A(k) : NULL
BODY
  X = X
END
""",
    "output_NEW": """
%global A
T(k)
  k = 0 .. 3
  RW X <- A(k)
       -> NEW
BODY
  X = X
END
""",
    "output_NEW_true": """
%global A
T(k)
  k = 0 .. 10
  RW X <- A(k)
       -> (k < 5) ? NEW : A(k)
BODY
  X = X
END
""",
    "output_NEW_false": """
%global A
T(k)
  k = 0 .. 10
  RW X <- A(k)
       -> (k < 5) ? A(k) : NEW
BODY
  X = X
END
""",
}


@pytest.mark.parametrize("case", sorted(NEGATIVE_SOURCES))
def test_negative(case):
    src = NEGATIVE_SOURCES[case]
    with pytest.raises((P.PTGSyntaxError, SyntaxError)):
        prog = compile_ptg(src, case)
        # some cases only fail at class-build time
        ctx = Context(nb_cores=1, device="cpu")
        try:
            prog.instantiate(ctx, globals={}, collections={"A": None})
        finally:
            ctx.fini()


def test_descending_range(ctx):
    """Negative-step ranges include both endpoints (countdown chains)."""
    src = """
%global A
T(k)
  k = 3 .. 0 .. -1
  : A(0, 0)
  RW X <- (k == 3) ? A(0, 0) : X T(k+1)
     -> (k > 0) ? X T(k-1) : A(0, 0)
BODY
  X = X + 1.0
END
"""
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = compile_ptg(src, "down").instantiate(ctx, globals={}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    assert tp.completed
    assert np.allclose(A.to_dense(), 4.0)   # k = 3,2,1,0 all ran


# ---------------------------------------------------------------------------
# NULL forwarding, write_check, %prologue (ref: tests/dsl/ptg/ptgpp)
# ---------------------------------------------------------------------------

FORWARD_NULL_SRC = """
%global A
%global NB
Task(k)
  k = 0 .. NB
  : A(k, 0)
  {ACCESS} X <- (k == 0) ? NULL : X Task(k-1)
       -> (k < NB) ? X Task(k+1)
BODY
  pass
END
"""


@pytest.mark.parametrize("access", ["RW", "READ"])
def test_forward_null_fatals(ctx, access):
    """Forwarding a NULL on a data flow aborts with attribution at the
    source (ref: parsec.c:1879 'A NULL is forwarded';
    ptgpp forward_RW_NULL / forward_READ_NULL)."""
    NB = 3
    A = TiledMatrix("Afn" + access, 16, 4, 4, 4)
    A.fill(lambda m, n: np.ones((4, 4), np.float32))
    prog = compile_ptg(FORWARD_NULL_SRC.replace("{ACCESS}", access),
                       "fwdnull" + access)
    tp = prog.instantiate(ctx, globals={"NB": NB}, collections={"A": A})
    with pytest.raises(RuntimeError, match="A NULL is forwarded"):
        ctx.add_taskpool(tp)
        ctx.wait(timeout=30)


WRITE_CHECK_SRC = """
%global A
%global NT
%global BLOCK

STARTUP(k)
  k = 0 .. NT
  : A(0, k)
  WRITE A1 -> A2 TASK1(k)
BODY
  A1 = (torch.arange(BLOCK * BLOCK, dtype=torch.float32) + k * BLOCK).reshape(BLOCK, BLOCK)
END

TASK1(k)
  k = 0 .. NT
  : A(0, k)
  WRITE A3 -> A1 TASK2(k)
  RW    A1 <- A(0, k)
           -> A2 TASK2(k)
  READ  A2 <- A1 STARTUP(k)
BODY
  A1 = A1 + 1.0
  A3 = A2
END

TASK2(k)
  k = 0 .. NT
  : A(0, k)
  READ A1 <- A3 TASK1(k)
  RW   A2 <- A1 TASK1(k)
          -> A(0, k)
BODY
  A2 = A2 + A1
END
"""


def _write_check_run(ctx, A, NT, BLOCK):
    prog = compile_ptg(WRITE_CHECK_SRC, "write_check")
    tp = prog.instantiate(ctx, globals={"NT": NT, "BLOCK": BLOCK},
                          collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    return tp


def test_write_check(ctx):
    """WRITE-only scratch flows forwarded through a 3-task pipeline: the
    final tile content proves every write propagated (ref: write_check.jdf
    — WRITE A1/A3 relay chains, RW chains, memory write-back)."""
    NT, BLOCK = 3, 4
    A = TiledMatrix("Awc", BLOCK, (NT + 1) * BLOCK, BLOCK, BLOCK)
    A.fill(lambda m, n: np.ones((BLOCK, BLOCK), np.float32))
    tp = _write_check_run(ctx, A, NT, BLOCK)
    assert tp.completed
    for k in range(NT + 1):
        # A(0,k) = (ones + 1) + startup_index = 2 + k*BLOCK + arange
        expect = (np.arange(BLOCK * BLOCK, dtype=np.float32) + k * BLOCK
                  ).reshape(BLOCK, BLOCK) + 2.0
        got = np.asarray(A.data_of(0, k).newest_copy().payload)
        np.testing.assert_allclose(got, expect)


PROLOGUE_SRC = """
%{
import math
NT = 7
def weight(k):
    return (k + 1) ** 0.5     # a plain float: bodies run as written
def last(nt):
    return nt - int(math.copysign(1, nt))   # host-side helpers may use math
%}
%global A

T(k)
  k = 0 .. last(NT)
  : A(0, k)
  RW X <- A(0, k)
       -> A(0, k)
BODY
  X = X + weight(k)
END
"""


def test_prologue_block(ctx):
    """A %{...%} prologue carries helpers + constants the ranges and bodies
    use — the file is self-contained like a JDF with an inline-C prologue
    (ref: extern "C" %{...%} escapes, jdf2c.c:54)."""
    prog = compile_ptg(PROLOGUE_SRC, "prologue")
    assert "def weight" in prog.spec.prologue
    A = TiledMatrix("Apl", 4, 7 * 4, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    # no globals= needed: NT, weight, last all come from the prologue
    tp = prog.instantiate(ctx, globals={}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    assert tp.completed
    for k in range(7):
        np.testing.assert_allclose(
            np.asarray(A.data_of(0, k).newest_copy().payload),
            np.sqrt(k + 1), rtol=1e-6)


def test_prologue_unterminated_rejected():
    with pytest.raises(P.PTGSyntaxError, match="unterminated"):
        P.parse("%{\nx = 1\n")


# ---------------------------------------------------------------------------
# the port's additions: the device body types, and cross-checks that run
# one program through both packages on the same numpy inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["CUDA", "TPU", "cuda"])
def test_device_body_types_parse_as_cuda(kind):
    """``BODY [type=CUDA]`` is the port's device body; ``type=TPU`` is read
    as the same, so the reference's sources parse unchanged."""
    spec = P.parse(GEMM_SRC.replace("[type=TPU]", f"[type={kind}]"))
    assert spec.task_classes[0].bodies[0].device == "CUDA"


def _ref_context():
    """A reference context with region fusion off: the mode the port
    implements (the same graph, task by task)."""
    from parsec_tpu.core.context import Context as RefContext
    from parsec_tpu.utils import mca as ref_mca
    ref_mca.set("region_fusion", False)
    return RefContext(nb_cores=1), ref_mca


def _ref_tiles(name, dense, ts):
    from parsec_tpu.data.matrix import TiledMatrix as RefTiled
    M = RefTiled(name, dense.shape[0], dense.shape[1], ts, ts)
    M.fill(lambda m, n: dense[m*ts:(m+1)*ts, n*ts:(n+1)*ts])
    return M


def _port_tiles(name, dense, ts):
    M = TiledMatrix(name, dense.shape[0], dense.shape[1], ts, ts)
    M.fill(lambda m, n: dense[m*ts:(m+1)*ts, n*ts:(n+1)*ts])
    return M


REF_GEMM_SRC = GEMM_SRC.replace(
    "C = C + torch.matmul(A, B)",
    "C = C + jnp.dot(A, B, preferred_element_type=jnp.float32)")


@pytest.mark.parametrize("native", [True, False])
def test_cross_check_gemm(native):
    """The PTG GEMM through both packages: the port's torch body on the
    native lane or the Python FSM against the reference's jnp body, at the
    reference test's rtol = atol = 1e-3 (and each against numpy)."""
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    MT = NT = KT = 3
    TS = 16
    rng = np.random.default_rng(11)
    a = rng.standard_normal((MT*TS, KT*TS)).astype(np.float32)
    b = rng.standard_normal((KT*TS, NT*TS)).astype(np.float32)
    c0 = rng.standard_normal((MT*TS, NT*TS)).astype(np.float32)
    g = {"MT": MT, "NT": NT, "KT": KT}

    rctx, ref_mca = _ref_context()
    try:
        rC = _ref_tiles("C", c0, TS)
        tp = ref_compile(REF_GEMM_SRC, "gemm").instantiate(
            rctx, globals=g, collections={"descA": _ref_tiles("A", a, TS),
                                          "descB": _ref_tiles("B", b, TS),
                                          "descC": rC})
        rctx.add_taskpool(tp)
        rctx.wait()
        ref = rC.to_dense()
    finally:
        rctx.fini()
        ref_mca.params.unset("region_fusion")

    mca.set("ptg_native_exec", native)
    ctx = Context(nb_cores=1, device="cpu")
    try:
        pC = _port_tiles("C", c0, TS)
        s0 = PTEXEC_STATS.snapshot()
        tp = compile_ptg(GEMM_SRC, "gemm").instantiate(
            ctx, globals=g, collections={"descA": _port_tiles("A", a, TS),
                                         "descB": _port_tiles("B", b, TS),
                                         "descC": pC})
        ctx.add_taskpool(tp)
        ctx.wait()
        got = pC.to_dense()
        assert PTEXEC_STATS.delta(s0)["pools_engaged"] == int(native)
    finally:
        ctx.fini()
        mca.set("ptg_native_exec", True)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, c0 + a @ b, rtol=1e-3, atol=1e-3)


CHAIN2_SRC = """
%global N
%global A

PROD(k)
  k = 0 .. N-1
  : A(k, 0)
  RW X <- A(k, 0)
     -> X CONS(k)
BODY
  X = X * (1.0 + 0.25 * k)
END

CONS(k)
  k = 0 .. N-1
  : A(k, 0)
  RW X <- X PROD(k)
     -> (k < N-1) ? X CONS(k+1) : A(k, 0)
  READ Y <- (k > 0) ? X CONS(k-1) : A(k, 0)
BODY
  X = X - Y
END
"""


def test_cross_check_data_flow_chain_bit_for_bit():
    """A data-flow chain of elementwise f32 bodies through both packages:
    the port's lane, the port's Python FSM and the reference equal each
    other bit for bit. Each body is one rounding a element (a product, or
    a difference), so no compiler may contract two into one FMA."""
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    N, TS = 6, 8
    rng = np.random.default_rng(5)
    a = rng.standard_normal((N * TS, TS)).astype(np.float32)

    rctx, ref_mca = _ref_context()
    try:
        rA = _ref_tiles("A", a, TS)
        tp = ref_compile(CHAIN2_SRC, "chain2").instantiate(
            rctx, globals={"N": N}, collections={"A": rA})
        rctx.add_taskpool(tp)
        rctx.wait()
        ref = rA.to_dense()
    finally:
        rctx.fini()
        ref_mca.params.unset("region_fusion")

    outs = []
    for native in (True, False):
        mca.set("ptg_native_exec", native)
        ctx = Context(nb_cores=1, device="cpu")
        try:
            pA = _port_tiles("A", a, TS)
            tp = compile_ptg(CHAIN2_SRC, "chain2").instantiate(
                ctx, globals={"N": N}, collections={"A": pA})
            ctx.add_taskpool(tp)
            ctx.wait()
            outs.append(pA.to_dense())
        finally:
            ctx.fini()
            mca.set("ptg_native_exec", True)
    assert not np.array_equal(ref, a)
    np.testing.assert_array_equal(outs[0], ref)
    np.testing.assert_array_equal(outs[1], ref)


@pytest.mark.parametrize("native", [True, False])
def test_scalar_and_0d_outputs_flow(native):
    """A body that makes a written flow a 0-d tensor or a Python scalar:
    the value flows to the successor and writes back, on the lane and on
    the Python FSM."""
    src = """
%global A
T(k)
  k = 0 .. 2
  : A(0, 0)
  RW X <- (k == 0) ? A(0, 0) : X T(k-1)
     -> (k < 2) ? X T(k+1) : A(0, 0)
BODY
  X = X.sum() if k == 0 else (X.item() + 1.0 if k == 1 else X * 2)
END
"""
    mca.set("ptg_native_exec", native)
    ctx = Context(nb_cores=1, device="cpu")
    try:
        A = TiledMatrix("As", 2, 2, 2, 2)
        A.fill(lambda m, n: np.ones((2, 2), np.float32))
        s0 = PTEXEC_STATS.snapshot()
        tp = compile_ptg(src, "scalar").instantiate(ctx, globals={},
                                                    collections={"A": A})
        ctx.add_taskpool(tp)
        ctx.wait()
        assert PTEXEC_STATS.delta(s0)["pools_engaged"] == int(native)
        assert float(A.data_of(0, 0).newest_copy().payload) == 10.0
    finally:
        ctx.fini()
        mca.set("ptg_native_exec", True)


def test_cross_check_task_owner_ranks():
    """Owner-computes placement of every task of the GEMM program over a
    2 x 2 block-cyclic process grid: the port's ``task_rank_of`` (the
    class's affinity against the collection's ``rank_of``) names the rank
    the reference names, for every task of the space. Nothing runs: one
    rank executes until the distributed half of the port lands."""
    from parsec_tpu.core.context import Context as RefContext
    from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefBC
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    g = {"MT": 3, "NT": 4, "KT": 2}

    def owners(compile_, ctx, BC, src):
        C = BC("C", 48, 64, 16, 16, P=2, Q=2, nodes=4, myrank=0)
        tp = compile_(src, "gemm").instantiate(
            ctx, globals=g, collections={"descA": None, "descB": None,
                                         "descC": C})
        return [tp.task_rank_of(tc, loc) for tc, loc in tp._enumerate()]
    rctx = RefContext(nb_cores=1)
    try:
        want = owners(ref_compile, rctx, RefBC, REF_GEMM_SRC)
    finally:
        rctx.fini()
    ctx = Context(nb_cores=1, device="cpu")
    try:
        got = owners(compile_ptg, ctx, TwoDimBlockCyclic, GEMM_SRC)
    finally:
        ctx.fini()
    assert got == want and len(got) == 3 * 4 * 2
    assert set(got) == {0, 1, 2, 3}
