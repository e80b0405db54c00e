"""The reshape scenario battery on the port: the reference's
``tests/test_reshape_scenarios.py`` on one rank (s1–s10 and s14), named dep
datatypes ([type = NAME]) driving read/input/output reshapes through the
shared reshape-promise engine (``data/reshape.py`` + ``DataCopyFuture``),
typed memory write-back merging only the datatype's region; plus the
converters on tensors and arrays, and a cross-check of every local
scenario against the reference. The remote scenarios (s11–s13, s15) wait
for the distributed half of the port.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.data import DataCopy
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.data.reshape import (
    NamedDatatype, ReshapeCache, ReshapeSpec, default_convert, lower_tile,
    needs_reshape, upper_tile,
)
from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

M, TS = 8, 4   # 2x2 tiles of 4x4, like the reference's 8x8/4x4 default


def _mk(name, val=1.0, nodes=1, rank=0, P=1):
    dc = TwoDimBlockCyclic(name, M, M, TS, TS, P=P, Q=1,
                           nodes=nodes, myrank=rank)
    dc.fill(lambda m, n: np.full((TS, TS), val, np.float32))
    return dc


def _counting(base: NamedDatatype):
    calls = {"extract": 0}

    def ex(a, _b=base):
        calls["extract"] += 1
        return _b.extract(a)

    return NamedDatatype(base.name, extract=ex, insert=base.insert), calls


# the reference's 3-task chain: READ -> ZERO -> WRITE (local_*.jdf)
def _chain_src(read_attr="", out_attr="", zero_in_attr="", write_attr=""):
    return f"""
%global descA

READ_A(m, k)
  m = 0 .. 1
  k = 0 .. 1
  : descA(m, k)
  RW A <- descA(m, k)   {read_attr}
       -> A SET_ZEROS(m, k)   {out_attr}
BODY
  A = A
END

SET_ZEROS(m, k)
  m = 0 .. 1
  k = 0 .. 1
  : descA(m, k)
  RW A <- A READ_A(m, k)   {zero_in_attr}
       -> A WRITE_A(m, k)
BODY
  A = A * 0.0
END

WRITE_A(m, k)
  m = 0 .. 1
  k = 0 .. 1
  : descA(m, k)
  RW A <- A SET_ZEROS(m, k)
       -> descA(m, k)   {write_attr}
BODY
  A = A
END
"""


def _run_chain(src, datatypes=None):
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    tp = compile_ptg(src, "chain").instantiate(
        ctx, collections={"descA": A}, datatypes=datatypes)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    return A.to_dense(), tp


def test_s1_local_no_reshape():
    """No [type]: successors see the full tile; everything is zeroed
    (local_no_reshape.jdf)."""
    out, _ = _run_chain(_chain_src())
    np.testing.assert_array_equal(out, np.zeros((M, M), np.float32))


def test_s2_local_read_reshape():
    """[type] when reading from the matrix: the zeroing hits a NEW lower
    datacopy; typed write-back replaces only the lower region — the upper
    part of the original survives (local_read_reshape.jdf)."""
    out, _ = _run_chain(
        _chain_src(read_attr="[type = LOWER_TILE]",
                   write_attr="[type = LOWER_TILE]"),
        datatypes={"LOWER_TILE": lower_tile()})
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.triu(np.ones((TS, TS), np.float32), 1))
    np.testing.assert_array_equal(out, expect)


def test_s3_local_output_reshape():
    """[type] on an output dep: the successor receives the reshaped copy
    (local_output_reshape.jdf)."""
    out, _ = _run_chain(
        _chain_src(out_attr="[type = LOWER_TILE]",
                   write_attr="[type = LOWER_TILE]"),
        datatypes={"LOWER_TILE": lower_tile()})
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.triu(np.ones((TS, TS), np.float32), 1))
    np.testing.assert_array_equal(out, expect)


def test_s4_local_input_reshape():
    """[type] on an input dep: same result through the consumer-side
    conversion (local_input_reshape.jdf)."""
    out, _ = _run_chain(
        _chain_src(zero_in_attr="[type = LOWER_TILE]",
                   write_attr="[type = LOWER_TILE]"),
        datatypes={"LOWER_TILE": lower_tile()})
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.triu(np.ones((TS, TS), np.float32), 1))
    np.testing.assert_array_equal(out, expect)


def test_s5_typed_writeback_preserves_complement():
    """Typed memory write-back merges ONLY the datatype's region; an
    UPPER write leaves the strictly-lower region untouched."""
    out, _ = _run_chain(
        _chain_src(write_attr="[type = UPPER_TILE]"),
        datatypes={"UPPER_TILE": upper_tile()})
    # zeros written through UPPER: upper becomes 0, strict lower stays 1
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.tril(np.ones((TS, TS), np.float32), -1))
    np.testing.assert_array_equal(out, expect)


def test_s6_avoidable_reshape_same_type_converts_once():
    """Producer [type] == consumer [type]: ONE conversion, not two
    (avoidable_reshape.jdf)."""
    dtt, calls = _counting(lower_tile())
    out, tp = _run_chain(
        _chain_src(out_attr="[type = LOWER_TILE]",
                   zero_in_attr="[type = LOWER_TILE]",
                   write_attr="[type = LOWER_TILE]"),
        datatypes={"LOWER_TILE": dtt})
    # 4 tiles, one READ_A->SET_ZEROS conversion each + 0 re-conversions
    assert calls["extract"] == 4, calls
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.triu(np.ones((TS, TS), np.float32), 1))
    np.testing.assert_array_equal(out, expect)


def test_s7_default_type_is_identity():
    """[type = DEFAULT] never converts: registered implicitly, identity
    semantics (the adt_default of the reference harness)."""
    out, tp = _run_chain(_chain_src(out_attr="[type = DEFAULT]",
                                    write_attr="[type = DEFAULT]"))
    np.testing.assert_array_equal(out, np.zeros((M, M), np.float32))
    assert len(tp._typed_cache) == 0


def test_s8_unknown_datatype_is_fatal():
    """A dep referencing an unregistered datatype fails loudly."""
    with pytest.raises(RuntimeError, match="unknown .*datatype"):
        _run_chain(_chain_src(read_attr="[type = NO_SUCH]"))


def test_s9_input_dep_single_copy():
    """Two consumer tasks reading the same tile with the same [type] share
    ONE converted copy (input_dep_single_copy_reshape.jdf)."""
    dtt, calls = _counting(lower_tile())
    src = """
%global descA
%global descB

C(i, j)
  i = 0 .. 1
  j = 0 .. 1
  : descB(i, j)
  READ A <- descA(0, 0)    [type = LOWER_TILE]
  RW   B <- descB(i, j)
       -> descB(i, j)
BODY
  B = B + A
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    B = _mk("descB", val=0.0)
    tp = compile_ptg(src, "single").instantiate(
        ctx, collections={"descA": A, "descB": B},
        datatypes={"LOWER_TILE": dtt})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    assert calls["extract"] == 1, calls     # 4 consumers, ONE conversion
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.tril(np.ones((TS, TS), np.float32)))
    np.testing.assert_array_equal(B.to_dense(), expect)


def test_s10_local_LU_LL_two_types():
    """Producer ships LOWER, consumer asks UPPER: the conversions CHAIN
    (local_input_LU_LL.jdf's two-datatype path). tril then triu leaves the
    diagonal only."""
    src = """
%global descA
%global descB

P(m, k)
  m = 0 .. 1
  k = 0 .. 1
  : descA(m, k)
  RW A <- descA(m, k)
       -> A C(m, k)        [type = LOWER_TILE]
BODY
  A = A
END

C(m, k)
  m = 0 .. 1
  k = 0 .. 1
  : descB(m, k)
  RW A <- A P(m, k)        [type = UPPER_TILE]
       -> descB(m, k)
BODY
  A = A
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    B = _mk("descB", val=0.0)
    tp = compile_ptg(src, "lull").instantiate(
        ctx, collections={"descA": A, "descB": B},
        datatypes={"LOWER_TILE": lower_tile(), "UPPER_TILE": upper_tile()})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    expect = np.kron(np.ones((2, 2), np.float32),
                     np.eye(TS, dtype=np.float32))
    np.testing.assert_array_equal(B.to_dense(), expect)


def test_s14_guarded_typed_edges_resolve_exactly():
    """Two guarded out-deps to the same (class, flow), only one typed: the
    datatype attaches to the edge that actually FIRES for each task
    (regression: name-only matching reshaped C(1)'s input too)."""
    src = """
%global descA
%global descB

P(m)
  m = 0 .. 1
  : descA(m, 0)
  RW A <- descA(m, 0)
       -> (m == 0) ? A C(m)   [type = LOWER_TILE]
       -> (m == 1) ? A C(m)
BODY
  A = A
END

C(m)
  m = 0 .. 1
  : descB(m, 0)
  RW B <- descB(m, 0)
       -> descB(m, 0)
  READ A <- A P(m)
BODY
  B = B + A
END
"""
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("descA")
    B = _mk("descB", val=0.0)
    tp = compile_ptg(src, "guarded").instantiate(
        ctx, collections={"descA": A, "descB": B},
        datatypes={"LOWER_TILE": lower_tile()})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    got = B.to_dense()
    ones, tril = np.ones((TS, TS), np.float32), \
        np.tril(np.ones((TS, TS), np.float32))
    np.testing.assert_array_equal(got[:TS, :TS], tril)   # C(0): typed edge
    np.testing.assert_array_equal(got[TS:, :TS], ones)   # C(1): untyped edge


# ------------------------------------------------ the port's own additions

def test_converters_keep_tensors_tensors_and_arrays_arrays():
    """The converter picks torch for a tensor (which keeps its device and
    dtype rules) and numpy for an array; the triangle datatypes do too."""
    t = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    a = t.numpy().copy()
    spec = ReshapeSpec(dtype="float64", transpose=True)
    ct = default_convert(DataCopy(None, 0, t), spec).payload
    ca = default_convert(DataCopy(None, 0, a), spec).payload
    assert isinstance(ct, torch.Tensor) and ct.dtype == torch.float64
    assert isinstance(ca, np.ndarray) and ca.dtype == np.float64
    np.testing.assert_array_equal(ct.numpy(), ca)
    np.testing.assert_array_equal(ca, a.T)
    assert needs_reshape(DataCopy(None, 0, t), ReshapeSpec(dtype="float32")) \
        is False
    assert needs_reshape(DataCopy(None, 0, a), ReshapeSpec(shape=(2, 8)))
    cache = ReshapeCache()
    c = DataCopy(None, 0, t)
    r1 = cache.get_reshaped(c, ReshapeSpec(shape=(2, 8)))
    r2 = cache.get_reshaped(c, ReshapeSpec(shape=(2, 8)))
    assert r1 is r2 and tuple(r1.payload.shape) == (2, 8)
    lo, up = lower_tile(), upper_tile()
    assert isinstance(lo.extract(t), torch.Tensor)
    assert isinstance(lo.extract(a), np.ndarray)
    np.testing.assert_array_equal(lo.extract(t).numpy(), np.tril(a))
    np.testing.assert_array_equal(up.insert(t, t * 0).numpy(), np.tril(a, -1))


_LOCAL = {
    "s1": ({}, None),
    "s2": ({"read_attr": "[type = LOWER_TILE]",
            "write_attr": "[type = LOWER_TILE]"}, "LOWER_TILE"),
    "s3": ({"out_attr": "[type = LOWER_TILE]",
            "write_attr": "[type = LOWER_TILE]"}, "LOWER_TILE"),
    "s4": ({"zero_in_attr": "[type = LOWER_TILE]",
            "write_attr": "[type = LOWER_TILE]"}, "LOWER_TILE"),
    "s5": ({"write_attr": "[type = UPPER_TILE]"}, "UPPER_TILE"),
    "s6": ({"out_attr": "[type = LOWER_TILE]",
            "zero_in_attr": "[type = LOWER_TILE]",
            "write_attr": "[type = LOWER_TILE]"}, "LOWER_TILE"),
}


@pytest.mark.parametrize("case", sorted(_LOCAL))
def test_cross_check_local_scenarios(case):
    """Each local chain scenario through both packages on the same tiles:
    the same dense result, element for element."""
    from parsec_tpu.core.context import Context as RefContext
    from parsec_tpu.data import reshape as ref_reshape
    from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefBC
    from parsec_tpu.dsl.ptg.compiler import compile_ptg as ref_compile
    attrs, dtt = _LOCAL[case]
    src = _chain_src(**attrs)
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((M, M)).astype(np.float32)
    fill = (lambda m, n: dense[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    ref_dtts = port_dtts = None
    if dtt is not None:
        mk = {"LOWER_TILE": "lower_tile", "UPPER_TILE": "upper_tile"}[dtt]
        ref_dtts = {dtt: getattr(ref_reshape, mk)()}
        port_dtts = {dtt: {"lower_tile": lower_tile,
                           "upper_tile": upper_tile}[mk]()}
    rctx = RefContext(nb_cores=1)
    RA = RefBC("descA", M, M, TS, TS, P=1, Q=1)
    RA.fill(fill)
    tp = ref_compile(src, "chain").instantiate(
        rctx, collections={"descA": RA}, datatypes=ref_dtts)
    rctx.add_taskpool(tp)
    rctx.wait(timeout=30)
    rctx.fini()
    ctx = Context(nb_cores=1, device="cpu")
    PA = TwoDimBlockCyclic("descA", M, M, TS, TS, P=1, Q=1)
    PA.fill(fill)
    tp = compile_ptg(src, "chain").instantiate(
        ctx, collections={"descA": PA}, datatypes=port_dtts)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=30)
    ctx.fini()
    np.testing.assert_array_equal(PA.to_dense(), RA.to_dense())
