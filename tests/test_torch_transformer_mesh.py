"""The reference's sharded, sequence-parallel and tp-mesh transformer tests
(``tests/test_transformer.py``) on the port: one block trained over the
(dp, tp) mesh (Megatron shards, the tp collectives, the dp gradient
all-reduce) and over the 8-rank sequence mesh (ring attention inside the
block, gradients riding the reverse ring), on a gloo group over CPU
tensors, held against the reference's single-device step (JAX) at the
reference tests' tolerances."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_mesh_jobs as J
from parsec_tpu.parallel import transformer as JT
from parsec_tpu_torch.parallel import transformer as T
from parsec_tpu_torch.parallel.multihost import RankPool

JOB_S = 120.0



@pytest.fixture(scope="module")
def pool():
    p = RankPool(8, "cpu", timeout=JOB_S)
    yield p
    p.close()


def _data(B=4, S=8, D=16, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    y = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, y


@jax.jit
def _ref_step(p, x, y, lr):
    def loss_fn(p):
        return jnp.mean((JT.block_apply(p, jnp.asarray(x)) - y) ** 2)
    loss, g = jax.value_and_grad(loss_fn)(p)
    return jax.tree_util.tree_map(lambda a, b: a - lr * b, p, g), loss


def test_sharded_step_matches_single_device(pool):
    params = T.init_block_params(0, d_model=16, d_ff=32, n_heads=4)
    x, y = _data()
    losses, first, specs = pool.run(J.block_steps, params, x, y, 1e-2, 1)[0]
    p_ref, loss_ref = _ref_step({k: jnp.asarray(v)
                                 for k, v in params.items()}, x, y, 1e-2)
    np.testing.assert_allclose(losses[0], float(loss_ref), rtol=1e-5,
                               atol=1e-6)
    for k in params:
        np.testing.assert_allclose(first[k], np.asarray(p_ref[k]),
                                   rtol=2e-4, atol=2e-5)
    # the Megatron placements: heads and ff over tp, the rest replicated
    assert specs["wqkv"] == (None, "tp", None, None)
    assert specs["w2"] == ("tp", None) and specs["b2"] == (None,)


def test_training_reduces_loss(pool):
    params = T.init_block_params(3, d_model=16, d_ff=32, n_heads=4)
    x, y = _data(seed=4)
    losses = pool.run(J.block_steps, params, x, y, 5e-2, 8)[0][0]
    assert losses[-1] < losses[0] * 0.9, losses


def test_tp_mesh_shapes(pool):
    shape, names = pool.run(J.tp_mesh)[0]
    assert names == ("dp", "tp")
    assert int(np.prod(shape)) >= 2
    assert shape == tuple(JT.make_tp_mesh().devices.shape)


@pytest.mark.parametrize("n", [2, 3, 5, 6, 7, 8])
def test_tp_mesh_respects_divisibility(pool, n):
    """tp is chosen among divisors of n_heads so Megatron shardings always
    place, whatever the rank count."""
    (dp, tp), _ = pool.run(J.tp_mesh, n, None, 4)[0]
    assert dp * tp == n and 4 % tp == 0
    assert (dp, tp) == tuple(JT.make_tp_mesh(n, tp_must_divide=4)
                             .devices.shape)


def test_sp_train_step_matches_single_device(pool):
    """Long-context training: the sequence-sharded step (ring attention
    inside the block, gradients through the reverse ring) matches the
    single-device dense step."""
    params = T.init_block_params(0, d_model=16, d_ff=32, n_heads=4)
    S = 8 * 8
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    y = rng.standard_normal((2, S, 16)).astype(np.float32)
    losses, first, specs = pool.run(J.block_steps, params, x, y, 1e-2, 1,
                                    True)[0]
    p_ref, loss_ref = _ref_step({k: jnp.asarray(v)
                                 for k, v in params.items()}, x, y, 1e-2)
    np.testing.assert_allclose(losses[0], float(loss_ref), rtol=1e-5,
                               atol=1e-6)
    for k in params:
        np.testing.assert_allclose(first[k], np.asarray(p_ref[k]),
                                   rtol=5e-4, atol=5e-5)
    assert all(s == (None,) * len(s) for s in specs.values())


def test_sp_training_reduces_loss_long_seq(pool):
    params = T.init_block_params(2, d_model=16, d_ff=32, n_heads=4)
    S = 32 * 8
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, S, 16)).astype(np.float32)
    y = rng.standard_normal((1, S, 16)).astype(np.float32)
    losses = pool.run(J.block_steps, params, x, y, 5e-2, 6, True)[0][0]
    assert losses[-1] < losses[0] * 0.95, losses
