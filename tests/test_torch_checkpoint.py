"""Checkpoint / resume through both runtimes (the single-rank half).

The reference's single-rank tests (tests/test_checkpoint.py) run on the
port's CPU context, and a cross-check writes a checkpoint with one package
and restores it with the other, both ways, in float32, float64 and bfloat16:
the restored tiles hold the saved bits. The 2-rank resume waits for the
distributed slice.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from parsec_tpu.data.matrix import MATRIX_BFLOAT16
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefBC
from parsec_tpu.utils import checkpoint as ref_checkpoint
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import (SymTwoDimBlockCyclic,
                                          TwoDimBlockCyclic)
from parsec_tpu_torch.dsl.dtd import RW, DTDTaskpool
from parsec_tpu_torch.utils import checkpoint


def _mk(name, n=32, ts=8, **kw):
    return TwoDimBlockCyclic(name, n, n, ts, ts, P=kw.pop("P", 1), Q=1, **kw)


def _phase(ctx, A, fn, name):
    tp = DTDTaskpool(ctx, name)
    for m in range(A.mt):
        for n in range(A.nt):
            tp.insert_task(fn, (tp.tile_of(A, m, n), RW), jit=False)
    tp.wait(timeout=30); tp.close()


def test_checkpoint_resume_single(tmp_path):
    rng = np.random.default_rng(5)
    init = rng.standard_normal((32, 32)).astype(np.float32)
    path = str(tmp_path / "ckpt")

    # life 1: phase 1, checkpoint at quiescence
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("CK")
    A.fill(lambda m, n: init[m*8:(m+1)*8, n*8:(n+1)*8])
    _phase(ctx, A, lambda x: x * 2.0, "p1")
    ctx.wait(timeout=30)
    checkpoint.save(path, {"CK": A})
    ctx.fini()

    # life 2: FRESH context + collection, restore, phase 2
    ctx2 = Context(nb_cores=1, device="cpu")
    A2 = _mk("CK")
    A2.fill(lambda m, n: np.zeros((8, 8), np.float32))   # junk pre-state
    n_restored = checkpoint.restore(path, {"CK": A2})
    assert n_restored == A2.mt * A2.nt
    _phase(ctx2, A2, lambda x: x + 1.0, "p2")
    ctx2.wait(timeout=30)
    ctx2.fini()

    np.testing.assert_allclose(A2.to_dense(), init * 2.0 + 1.0, rtol=1e-6)


def test_checkpoint_grid_mismatch_is_fatal(tmp_path):
    path = str(tmp_path / "ck2")
    ctx = Context(nb_cores=1, device="cpu")
    A = _mk("G")
    A.fill(lambda m, n: np.ones((8, 8), np.float32))
    checkpoint.save(path, {"G": A})
    B = TwoDimBlockCyclic("G", 32, 32, 16, 16, P=1, Q=1)   # different tiling
    B.fill(lambda m, n: np.ones((16, 16), np.float32))
    with pytest.raises(RuntimeError, match="grid mismatch"):
        checkpoint.restore(path, {"G": B})
    ctx.fini()


def test_checkpoint_of_a_symmetric_collection_holds_its_triangle(tmp_path):
    """A lower symmetric collection saves and restores its stored tiles
    only (the other triangle has no tile to save)."""
    path = str(tmp_path / "sym")
    rng = np.random.default_rng(6)
    dense = rng.standard_normal((24, 24)).astype(np.float32)
    A = SymTwoDimBlockCyclic("SY", 24, 24, 8, 8, uplo=0)
    A.fill(lambda m, n: dense[m*8:(m+1)*8, n*8:(n+1)*8])
    checkpoint.save(path, {"SY": A})
    B = SymTwoDimBlockCyclic("SY", 24, 24, 8, 8, uplo=0)
    assert checkpoint.restore(path, {"SY": B}) == 6
    assert np.array_equal(B.to_dense(), A.to_dense())
    with np.load(path + ".npz") as z:
        assert sorted(k for k in z.files if not k.startswith("__")) == [
            f"SY/{m}_{n}" for m in range(3) for n in range(m + 1)]


def _bits(a):
    """The raw bits of a tile: bf16 (numpy's raw 2-byte words, ml_dtypes'
    type or a torch tensor) as uint16, else the array itself."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


DTYPES = [(np.float32, torch.float32, np.float32),
          (np.float64, torch.float64, np.float64),
          (MATRIX_BFLOAT16, torch.bfloat16, ml_dtypes.bfloat16)]


@pytest.mark.parametrize("ref_dtype,port_dtype,np_dtype", DTYPES)
def test_checkpoint_files_interchange_with_the_reference(tmp_path, ref_dtype,
                                                         port_dtype,
                                                         np_dtype):
    """A reference checkpoint restores into the port with every tile's
    bits, and a port checkpoint restores into the reference the same way;
    both packages write the same manifest and the same array names, and a
    bf16 tile is stored as its raw 2-byte words (numpy ``|V2``, manifest
    ``<V2``), which is what the reference writes for an ml_dtypes bf16
    array."""
    rng = np.random.default_rng(12)
    dense = rng.standard_normal((32, 24)).astype(np.float64).astype(np_dtype)
    ref = RefBC("X", 32, 24, 8, 8, dtype=ref_dtype)
    ref.fill(lambda m, n: dense[m*8:(m+1)*8, n*8:(n+1)*8])
    port = TwoDimBlockCyclic("X", 32, 24, 8, 8, dtype=port_dtype)
    port.fill(lambda m, n: torch.from_numpy(
        dense[m*8:(m+1)*8, n*8:(n+1)*8].astype(np.float64)).to(port_dtype))

    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_checkpoint.save(ref_path, {"X": ref})
    checkpoint.save(port_path, {"X": port})
    man = [json.load(open(p + ".manifest.json")) for p in (ref_path,
                                                           port_path)]
    assert man[0] == man[1]
    with np.load(ref_path + ".npz") as a, np.load(port_path + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if not k.startswith("__"):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(_bits(a[k]), _bits(b[k]))

    # reference file -> port collection
    into_port = TwoDimBlockCyclic("X", 32, 24, 8, 8, dtype=port_dtype)
    assert checkpoint.restore(ref_path, {"X": into_port}) == 12
    # port file -> reference collection
    into_ref = RefBC("X", 32, 24, 8, 8, dtype=ref_dtype)
    assert ref_checkpoint.restore(port_path, {"X": into_ref}) == 12
    for m in range(4):
        for n in range(3):
            want = _bits(dense[m*8:(m+1)*8, n*8:(n+1)*8])
            got_p = into_port.data_of(m, n).newest_copy().payload
            assert got_p.dtype == port_dtype
            assert np.array_equal(_bits(got_p), want)
            got_r = into_ref.data_of(m, n).newest_copy().payload
            assert np.array_equal(_bits(got_r), want)
