"""The distribution variants through both runtimes: SBC, symmetric band,
band, vector 1D cyclic and tabular.

The reference's single-rank tests (tests/test_collections_variants.py) run
on the port's collections, and a cross-check builds each layout in both
packages over a sweep of (r, extended, nranks) and grid shapes and requires
equal rank tables. The 2-rank runs wait for the distributed slice.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.data import matrix as RM
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import (
    SBCDistribution,
    SymTwoDimBlockCyclic,
    SymTwoDimBlockCyclicBand,
    TabularDistribution,
    TwoDimBlockCyclic,
    TwoDimBlockCyclicBand,
    VectorTwoDimCyclic,
    VECTOR_DISTRIB_COL,
    VECTOR_DISTRIB_DIAG,
    VECTOR_DISTRIB_ROW,
)
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd


def A_ranks(r, extended):
    return r * (r - 1) // 2 if extended else r * (r - 1) // 2 + r // 2


# ---------------------------------------------------------------- SBC

@pytest.mark.parametrize("r,extended,nranks", [
    (2, False, 2), (3, True, 3), (4, True, 6), (4, False, 8), (5, True, 10),
])
def test_sbc_rank_range_and_count(r, extended, nranks):
    A = SBCDistribution("S", 16 * r, 16 * r, 16, 16, r=r, extended=extended,
                        nodes=nranks, myrank=0)
    assert A.num_ranks == nranks
    seen = set()
    for m in range(A.mt):
        for n in range(m + 1):  # lower triangle
            rk = A.rank_of(m, n)
            assert 0 <= rk < nranks
            seen.add(rk)
    assert seen == set(range(nranks)), "every rank owns at least one tile"


@pytest.mark.parametrize("r,extended", [(3, True), (4, True), (4, False),
                                        (5, True)])
def test_sbc_symmetric_pairs(r, extended):
    """The defining property: off-diagonal pattern positions (a,b) and (b,a)
    have the same owner (the packed pair index)."""
    n_tiles = 4 * r
    A = SBCDistribution("S", 16 * n_tiles, 16 * n_tiles, 16, 16, r=r,
                        extended=extended, nodes=A_ranks(r, extended))
    for m in range(n_tiles):
        for n in range(m):          # strictly lower
            if m % r == n % r:
                continue            # diagonal pattern position
            rk = A.rank_of(m, n)
            # a lower-triangle tile whose pattern position is (b, a)
            mm, nn = n + r * ((m // r) + 1), m
            assert A.rank_of(mm, nn) == rk


@pytest.mark.parametrize("r,extended", [(3, True), (4, True), (5, True)])
def test_sbc_extended_diagonal_borrows_pair_ranks(r, extended):
    """Extended SBC serves diagonal tiles from off-diagonal pair ranks and
    rotates the pattern every r tile columns."""
    nr = A_ranks(r, True)
    n_tiles = r * nr  # several rotations
    A = SBCDistribution("S", 16 * n_tiles, 16 * n_tiles, 16, 16, r=r,
                        extended=True, nodes=nr)
    diag_ranks = set()
    for k in range(n_tiles):
        rk = A.rank_of(k, k)
        assert 0 <= rk < nr
        diag_ranks.add(rk)
    assert len(diag_ranks) > 1


def test_sbc_basic_requires_even_r():
    with pytest.raises(ValueError):
        SBCDistribution("S", 64, 64, 16, 16, r=3, extended=False)


def test_sbc_off_triangle_raises():
    A = SBCDistribution("S", 64, 64, 16, 16, r=2, extended=False, nodes=2)
    with pytest.raises(KeyError):
        A.rank_of(0, 1)
    with pytest.raises(KeyError):
        A.data_of(0, 1)


# ------------------------------------------- symmetric band composition

def test_sym_band_delegation():
    nodes = 4
    off = SymTwoDimBlockCyclic("off", 128, 128, 16, 16, P=2, Q=2, nodes=nodes)
    band = TwoDimBlockCyclic("band", 2 * 16, 128, 16, 16, P=1, Q=nodes,
                             nodes=nodes)
    A = SymTwoDimBlockCyclicBand("symband", off, band, band_size=2)
    for m in range(A.mt):
        for n in range(m + 1):
            if abs(m - n) < 2:
                assert A.rank_of(m, n) == band.rank_of(abs(m - n), n)
            else:
                assert A.rank_of(m, n) == off.rank_of(m, n)
            assert A.rank_of_key(A.data_key(m, n)) == A.rank_of(m, n)


def test_sym_band_data_of_routes_to_subcollection():
    off = SymTwoDimBlockCyclic("off2", 64, 64, 16, 16, P=1, Q=1, nodes=1)
    band = TwoDimBlockCyclic("band2", 16, 64, 16, 16, P=1, Q=1, nodes=1)
    A = SymTwoDimBlockCyclicBand("symband2", off, band, band_size=1)
    d_diag = A.data_of(2, 2)       # in band -> band collection, key (0, 2)
    assert d_diag is band.data_of(0, 2)
    d_off = A.data_of(3, 0)        # off band -> sym collection
    assert d_off is off.data_of(3, 0)


def test_sym_band_fill_and_mirror_rejection():
    """fill()/to_dense() skip the unstored triangle, and accessing a mirror
    tile raises instead of silently aliasing a band tile."""
    off = SymTwoDimBlockCyclic("off4", 64, 64, 16, 16, P=1, Q=1, nodes=1)
    band = TwoDimBlockCyclic("band4", 32, 64, 16, 16, P=1, Q=1, nodes=1)
    A = SymTwoDimBlockCyclicBand("symband4", off, band, band_size=2)
    A.fill(lambda m, n: np.full((16, 16), m * 10 + n, np.float32))
    dense = A.to_dense()
    assert dense[16, 0] == 10  # tile (1, 0)
    assert dense[0, 16] == 0   # mirror not stored
    with pytest.raises(KeyError):
        A.data_of(0, 1)  # upper in-band would alias band tile (1, 1)


def test_sym_band_requires_big_enough_band_collection():
    """The reference asserts; the port raises ValueError (it survives
    ``python -O``)."""
    off = SymTwoDimBlockCyclic("off3", 64, 64, 16, 16, P=1, Q=1, nodes=1)
    band = TwoDimBlockCyclic("band3", 16, 64, 16, 16, P=1, Q=1, nodes=1)
    with pytest.raises(ValueError):
        SymTwoDimBlockCyclicBand("bad", off, band, band_size=3)


def test_sym_lower_potrf_on_the_stored_triangle():
    """A symmetric lower collection holds only the lower tiles; POTRF runs
    on them alone and factors the matrix."""
    N, TS = 64, 16
    spd = make_spd(N, seed=9)
    A = SymTwoDimBlockCyclic("symP", N, N, TS, TS, uplo=0)
    A.fill(lambda m, n: spd[m * TS:(m + 1) * TS, n * TS:(n + 1) * TS])
    assert len(A._datas) == 10           # 4 x 5 / 2 lower tiles
    ctx = Context(nb_cores=1, device="cpu")
    try:
        tp = DTDTaskpool(ctx, "symp")
        assert insert_potrf_tasks(tp, A) == 4 + 6 + 6 + 4
        tp.wait(); tp.close(); ctx.wait()
    finally:
        ctx.fini()
    L = np.tril(A.to_dense())
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)
    with pytest.raises(KeyError):
        A.data_of(0, 1)


# ------------------------------------------------- vector 1D cyclic

def test_vector_distrib_modes():
    P, Q = 2, 3
    nodes = P * Q
    lmt = 24
    row = VectorTwoDimCyclic("vr", lmt * 8, 8, P=P, Q=Q,
                             distrib=VECTOR_DISTRIB_ROW, nodes=nodes)
    col = VectorTwoDimCyclic("vc", lmt * 8, 8, P=P, Q=Q,
                             distrib=VECTOR_DISTRIB_COL, nodes=nodes)
    diag = VectorTwoDimCyclic("vd", lmt * 8, 8, P=P, Q=Q,
                              distrib=VECTOR_DISTRIB_DIAG, nodes=nodes)
    assert row.period == P and col.period == Q and diag.period == 6
    for m in range(lmt):
        assert row.rank_of(m) == (m % P) * Q            # col 0 of grid
        assert col.rank_of(m) == m % Q                  # row 0 of grid
        assert diag.rank_of(m) == (m % P) * Q + (m % Q)  # grid diagonal


def test_vector_alignment_with_matrix_diagonal():
    """The point of the 'diag' mode: vector segment k is co-located with
    diagonal tile (k, k) of a matching 2D block-cyclic matrix."""
    P, Q = 2, 2
    M = TwoDimBlockCyclic("M", 128, 128, 16, 16, P=P, Q=Q, nodes=P * Q)
    v = VectorTwoDimCyclic("v", 128, 16, P=P, Q=Q,
                           distrib=VECTOR_DISTRIB_DIAG, nodes=P * Q)
    for k in range(M.mt):
        assert v.rank_of(k) == M.rank_of(k, k)


def test_vector_local_tiles_and_data():
    v = VectorTwoDimCyclic("vl", 40, 8, P=2, Q=1,
                           distrib=VECTOR_DISTRIB_ROW, nodes=2, myrank=1)
    assert v.lmt == 5
    assert v.nb_local_tiles() == 2  # segments 1, 3 of 5
    d = v.data_of(1)
    assert d.shape == (8, 1)
    assert torch.equal(d.get_copy(0).payload, torch.zeros(8, 1))
    assert v.rank_of_key(v.data_key(3)) == 1


def test_vector_rejects_unknown_distrib():
    with pytest.raises(ValueError):
        VectorTwoDimCyclic("bad", 64, 8, distrib="spiral")


# ------------------------------------------------- band and tabular

def test_band_and_tabular_rank_maps():
    full = TwoDimBlockCyclic("bf", 96, 96, 16, 16, P=2, Q=2, nodes=4)
    B = TwoDimBlockCyclicBand("bb", full, band_size=2)
    for m in range(B.mt):
        for n in range(B.nt):
            want = m % 4 if abs(m - n) < 2 else full.rank_of(m, n)
            assert B.rank_of(m, n) == want
    T = TabularDistribution("tt", 64, 64, 16, 16,
                            rank_fn=lambda m, n: (m + 2 * n) % 3, nodes=3)
    T.set_rank(1, 1, 2)
    assert T.rank_of(1, 1) == 2 and T.rank_of(2, 1) == (2 + 2) % 3
    assert TabularDistribution("t0", 32, 32, 16, 16).rank_of(1, 0) == 0


# ------------------------------------------- the cross-check's rank tables

def _table(dc, cells):
    return [dc.rank_of(*c) for c in cells]


def _lower(mt):
    return [(m, n) for m in range(mt) for n in range(m + 1)]


SBC_SWEEP = [(r, ext) for r in (2, 3, 4, 5, 6, 7) for ext in (True, False)
             if ext or r % 2 == 0]


@pytest.mark.parametrize("r,extended", SBC_SWEEP)
def test_sbc_rank_table_matches_the_reference(r, extended):
    nodes = A_ranks(r, extended)
    mt = 3 * r + 1
    kw = dict(r=r, extended=extended, nodes=nodes)
    cells = _lower(mt)
    ref = RM.SBCDistribution("S", 16 * mt, 16 * mt, 16, 16, **kw)
    port = SBCDistribution("S", 16 * mt, 16 * mt, 16, 16, **kw)
    assert _table(port, cells) == _table(ref, cells)
    assert port.num_ranks == ref.num_ranks
    assert port.diag_patterns == ref.diag_patterns


@pytest.mark.parametrize("P,Q,band_size", [(1, 1, 1), (2, 2, 2), (1, 4, 3),
                                           (3, 2, 2)])
def test_band_rank_tables_match_the_reference(P, Q, band_size):
    nodes, mt = P * Q, 9
    cells = [(m, n) for m in range(mt) for n in range(mt)]
    full_r = RM.TwoDimBlockCyclic("f", 16 * mt, 16 * mt, 16, 16, P=P, Q=Q,
                                  nodes=nodes)
    full_p = TwoDimBlockCyclic("f", 16 * mt, 16 * mt, 16, 16, P=P, Q=Q,
                               nodes=nodes)
    ref = RM.TwoDimBlockCyclicBand("b", full_r, band_size)
    port = TwoDimBlockCyclicBand("b", full_p, band_size)
    assert _table(port, cells) == _table(ref, cells)
    off_r = RM.SymTwoDimBlockCyclic("o", 16 * mt, 16 * mt, 16, 16, P=P,
                                    Q=Q, nodes=nodes)
    off_p = SymTwoDimBlockCyclic("o", 16 * mt, 16 * mt, 16, 16, P=P, Q=Q,
                                 nodes=nodes)
    band_r = RM.TwoDimBlockCyclic("bd", 16 * band_size, 16 * mt, 16, 16,
                                  P=1, Q=nodes, nodes=nodes)
    band_p = TwoDimBlockCyclic("bd", 16 * band_size, 16 * mt, 16, 16, P=1,
                               Q=nodes, nodes=nodes)
    sref = RM.SymTwoDimBlockCyclicBand("sb", off_r, band_r, band_size)
    sport = SymTwoDimBlockCyclicBand("sb", off_p, band_p, band_size)
    assert _table(sport, _lower(mt)) == _table(sref, _lower(mt))


@pytest.mark.parametrize("P,Q", [(1, 1), (2, 3), (3, 2), (4, 4), (2, 5)])
def test_vector_rank_tables_match_the_reference(P, Q):
    for distrib in (VECTOR_DISTRIB_DIAG, VECTOR_DISTRIB_ROW,
                    VECTOR_DISTRIB_COL):
        kw = dict(P=P, Q=Q, distrib=distrib, nodes=P * Q)
        ref = RM.VectorTwoDimCyclic("v", 37 * 8, 8, **kw)
        port = VectorTwoDimCyclic("v", 37 * 8, 8, **kw)
        assert [port.rank_of(m) for m in range(port.lmt)] == \
            [ref.rank_of(m) for m in range(ref.lmt)]
        assert (port.period, port.lmt, port.nb_local_tiles()) == \
            (ref.period, ref.lmt, ref.nb_local_tiles())
