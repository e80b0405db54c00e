"""The port's input pipeline (``data/loader.py``) against the reference's.

The reference's ``test_loader`` tests, ported: the prefetch loader's order,
overlap, workers, errors, re-iteration and early exit, the device stage
(here onto the CPU; the card's side-stream copies are held in
tests/test_torch_train_cuda.py), and ``token_batches``, which must give the
reference's windows for the same corpus and seed, element for element.
"""

import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu.data import loader as JL
from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import optim as O


def test_prefetch_preserves_order_single_worker():
    items = list(range(50))
    out = list(PrefetchLoader(lambda: iter(items), fn=lambda x: x * 2))
    assert out == [x * 2 for x in items]


def test_prefetch_overlaps_work():
    """Batch assembly must run ahead of (slow) consumption."""
    produced = []

    def fn(i):
        produced.append(i)
        return i

    it = iter(PrefetchLoader(lambda: iter(range(10)), fn=fn, prefetch=4))
    first = next(it)
    time.sleep(0.15)          # consumer stalls; workers should run ahead
    assert first == 0
    assert len(produced) >= 4, produced
    assert list(it) == list(range(1, 10))


def test_prefetch_multiworker_completes():
    out = sorted(PrefetchLoader(lambda: iter(range(40)),
                                fn=lambda x: x + 100, workers=4))
    assert out == [x + 100 for x in range(40)]


def test_prefetch_propagates_errors():
    def fn(i):
        if i == 3:
            raise ValueError("boom at 3")
        return i

    with pytest.raises(ValueError, match="boom at 3"):
        list(PrefetchLoader(lambda: iter(range(10)), fn=fn))


def test_prefetch_reiterable_and_len():
    ld = PrefetchLoader(lambda: [1, 2, 3])
    assert list(ld) == [1, 2, 3]
    assert list(ld) == [1, 2, 3]
    assert len(ld) == 3


@pytest.fixture(scope="module")
def pool():
    """A 4-rank gloo group over CPU tensors for the mesh tests here."""
    from parsec_tpu_torch.parallel.multihost import RankPool
    p = RankPool(4, "cpu", timeout=150.0)
    yield p
    p.close()


def test_device_staging_yields_device_arrays(pool):
    """The device stage on the CPU device: tensors, in order, ``ahead``
    batches early, the tuple structure kept; a plain list of more than one
    device raises, and a NamedSharding over a rank group's mesh places
    every leaf as a DTensor split over dp."""
    ld = PrefetchLoader(
        lambda: iter([(np.ones((4, 4), np.float32) * i, np.int32(i))
                      for i in range(6)]),
        device="cpu", ahead=2)
    got = list(ld)
    assert len(got) == 6
    assert all(isinstance(g, tuple) and isinstance(g[0], torch.Tensor)
               and g[0].device.type == "cpu" for g in got)
    np.testing.assert_allclose(got[3][0].numpy(), 3.0)
    assert int(got[5][1]) == 5
    with pytest.raises(ValueError, match="DeviceMesh"):
        PrefetchLoader([1], sharding=[torch.device("cpu")] * 2)
    import _torch_mesh_jobs as J
    corpus = np.arange(200) % 50
    want = list(token_batches(corpus, batch=4, seq_len=8, seed=1,
                              n_batches=3))
    for got in pool.run(J.loader_batches, corpus, 3):
        assert len(got) == 3
        for (x, local, spec), (wx, _) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            assert local == (2, 8) and spec == ("dp", None)


def test_token_batches_shapes_and_determinism():
    corpus = np.arange(1000) % 50
    a = list(token_batches(corpus, batch=4, seq_len=16, seed=7,
                           n_batches=3))
    b = list(token_batches(corpus, batch=4, seq_len=16, seed=7,
                           n_batches=3))
    assert len(a) == 3
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.shape == (4, 16) and ya.shape == (4, 16)
        np.testing.assert_array_equal(xa, xb)
        # targets are the next-token shift of tokens
        np.testing.assert_array_equal(xa[:, 1:], ya[:, :-1])
    with pytest.raises(ValueError, match="shorter"):
        next(token_batches(np.arange(4), batch=1, seq_len=16))


@pytest.mark.parametrize("seed,batch,seq_len", [(7, 4, 16), (0, 3, 5),
                                                (123, 8, 63)])
def test_token_batches_match_reference(seed, batch, seq_len):
    """The same windows as the reference's for the same corpus and seed,
    element for element (and the same dtype)."""
    corpus = np.random.default_rng(seed).integers(0, 97, size=500)
    ref = list(JL.token_batches(corpus, batch, seq_len, seed=seed,
                                n_batches=5))
    got = list(token_batches(corpus, batch, seq_len, seed=seed,
                             n_batches=5))
    assert len(got) == len(ref) == 5
    for (rx, ry), (x, y) in zip(ref, got):
        assert x.dtype == rx.dtype and y.dtype == ry.dtype
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_loader_feeds_lm_training():
    """End to end on the CPU: corpus -> token_batches -> PrefetchLoader
    (device stage) -> the AdamW LM step; the loss falls by half (the
    reference's 8-device test, on one device)."""
    cfg = TM.ModelConfig(vocab_size=16, d_model=32, d_ff=64, n_heads=4,
                         n_layers=1, max_seq=16)
    params = TM.init_lm_params(0, cfg)
    corpus = np.tile(np.array([3, 1, 4, 1, 5, 9, 2, 6]), 64)
    step, opt, place_p, _ = TM.make_lm_opt_train_step(
        "cpu", O.adamw(1e-2), params)
    sp = place_p(params)
    ld = PrefetchLoader(
        lambda: token_batches(corpus, batch=4, seq_len=16, seed=1,
                              n_batches=30),
        device="cpu", ahead=2)
    losses = []
    for x, y in ld:
        sp, opt, loss = step(sp, opt, x, y)
        losses.append(float(loss))
    assert len(losses) == 30
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_loader_feeds_lm_training_on_a_mesh(pool):
    """The reference's test in its mesh form: corpus -> token_batches ->
    PrefetchLoader (staged as DTensors split over dp) -> the AdamW LM step
    over a (dp 2, tp 2) mesh of 4 ranks; the loss falls by half, and every
    step's loss is the one-device run's."""
    import _torch_mesh_jobs as J
    cfg = TM.ModelConfig(vocab_size=16, d_model=32, d_ff=64, n_heads=4,
                         n_layers=1, max_seq=16)
    params = TM.init_lm_params(0, cfg)
    corpus = np.tile(np.array([3, 1, 4, 1, 5, 9, 2, 6]), 64)
    got = pool.run(J.loader_trains, params, corpus, 30)
    losses = got[0]
    assert all(g == losses for g in got)
    assert len(losses) == 30
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    step, opt, place_p, _ = TM.make_lm_opt_train_step(
        "cpu", O.adamw(1e-2), params)
    sp, one = place_p(params), []
    for x, y in token_batches(corpus, batch=4, seq_len=16, seed=1,
                              n_batches=30):
        sp, opt, loss = step(sp, opt, x, y)
        one.append(float(loss))
    np.testing.assert_allclose(losses, one, rtol=1e-3, atol=1e-3)


def test_prefetch_early_exit_terminates_workers():
    """Breaking out of iteration must not leak blocked worker threads."""
    base = threading.active_count()
    it = iter(PrefetchLoader(lambda: iter(range(1000)), workers=4,
                             prefetch=4))
    assert next(it) == 0
    it.close()                  # early consumer exit (generator finalizer)
    deadline = time.time() + 3.0
    while threading.active_count() > base and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= base, \
        f"{threading.active_count() - base} worker thread(s) leaked"


def test_token_batches_exact_fit_corpus():
    """A corpus of exactly seq_len + 1 tokens has ONE valid window."""
    corpus = np.arange(9)
    x, y = next(token_batches(corpus, batch=2, seq_len=8, seed=0))
    np.testing.assert_array_equal(x[0], corpus[:8])
    np.testing.assert_array_equal(y[0], corpus[1:])
