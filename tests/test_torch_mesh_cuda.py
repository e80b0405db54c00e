"""Card-only tests of the mesh slice: a group of CUDA ranks, every one on
the one card, joined in gloo. The collectives on CUDA tensors (each op on
the route the group's probe chose) give the CPU's answers; Ulysses
launches the flash kernel's wgmma route on every rank and holds its plain
version; the LM's AdamW step over (dp 2, tp 2) and the MoE-LM's steps over
a 4-rank ep mesh hold their one-device steps on the card; the loader
stages each rank's shard of a batch on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA card.
The file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_cuda.py
"""

import numpy as np
import pytest
import torch

import _torch_mesh_jobs as J
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.parallel.multihost import RankPool

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def pool():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks run on it")
    p = RankPool(4, "cuda", timeout=300.0)
    yield p
    p.close()


def test_collectives_on_cuda_tensors_match_the_cpus(pool):
    for same, routes in pool.run(J.cuda_collectives):
        assert all(same.values()), same
        assert set(routes.values()) <= {"gloo", "staged"}
    assert set(pool.native["cuda"]) == set(routes)


def test_ulysses_launches_flash_on_every_cuda_rank(pool):
    for launches, excess in pool.run(J.cuda_ulysses, (2, 4, 256, 64), 3):
        assert launches["wgmma"] == 1 and sum(launches.values()) == 1
        assert excess <= 0


def test_lm_mesh_step_on_cuda_ranks_matches_one_card(pool):
    cfg = TM.ModelConfig(vocab_size=97, d_model=64, d_ff=128, n_heads=4,
                         n_layers=2, max_seq=32)
    tree = TM.init_lm_params(1, cfg)
    toks = np.random.default_rng(1).integers(0, 97, size=(4, 33)).astype(
        np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    res = pool.run(J.cuda_lm_steps, tree, x, y)
    losses, got, where = res[0]
    assert where.startswith("cuda")
    assert all(r[0] == losses for r in res)
    assert losses[1] < losses[0]
    from parsec_tpu_torch.ops import cuda_kernels as K
    K.dot_precision()
    tx = O.chain(O.clip_by_global_norm(0.5), O.adamw(1e-3))
    step, opt, place_p, place_t = TM.make_lm_opt_train_step("cuda", tx, tree)
    p, opt, loss = step(place_p(tree), opt, place_t(x), place_t(y))
    assert abs(losses[0] - float(loss)) < 1e-4
    for a, b in zip(O.tree_leaves(got), O.tree_leaves(p)):
        np.testing.assert_allclose(a, b.cpu().numpy(), rtol=2e-4, atol=2e-4)


def test_sharded_loader_stages_shards_on_cuda_ranks(pool):
    """``PrefetchLoader(sharding=...)`` over (dp 2, tp 2) CUDA ranks: each
    rank's shard of each batch reaches the card through the loader's
    side-stream copy, and the DTensors hold the host batches."""
    from parsec_tpu_torch.data.loader import token_batches
    corpus = np.arange(200) % 50
    want = list(token_batches(corpus, batch=4, seq_len=8, seed=1,
                              n_batches=3))
    for got in pool.run(J.cuda_loader_batches, corpus, 3):
        assert len(got) == 3
        for (x, y, local, dev, spec), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert local == (2, 8) and dev.startswith("cuda")
            assert spec == ("dp", None)


def _route_gaps(tree, toks, steps):
    """The smallest gap between a token's router probabilities ranked 1st,
    2nd and 3rd, at each of ``steps`` dense SGD steps, in float64 on the
    CPU: a gap near f32 resolution lets two f32 paths route a token to
    different experts, and then their losses part by whole routes."""
    import torch.nn.functional as F
    from parsec_tpu_torch.parallel.transformer import block_apply
    p = TM.params_from_numpy(tree, device="cpu", dtype=torch.float64)
    step = TM.make_lm_moe_train_step(mesh=None, k=2, lr=0.1)
    out = []
    for _ in range(steps):
        seen = {}

        def ffn(h, mp=p["blocks"][0]["moe"]):
            s = torch.softmax(h.reshape(-1, h.shape[-1]) @ mp["router"],
                              -1).sort(-1, descending=True).values
            seen["gap"] = float(torch.minimum(s[:, 0] - s[:, 1],
                                              s[:, 1] - s[:, 2]).min())
            return torch.zeros_like(h)
        with torch.no_grad():
            x = F.embedding(torch.as_tensor(toks[:, :-1]).long(), p["embed"])
            block_apply(p["blocks"][0], x + p["pos"][:x.shape[1]][None],
                        ffn=ffn)
        out.append(seen["gap"])
        p, _ = step(p, toks[:, :-1], toks[:, 1:])
    return out


def test_moe_lm_trains_over_cuda_ep_ranks(pool):
    """The MoE-LM's SGD steps over a 4-rank ep mesh of CUDA ranks track
    the one-card dense steps. The data routes every token with a margin
    (its smallest gap between ranked router probabilities, float64, above
    1e-4 at each step), so both f32 paths take the same routes: at a
    near-tie the card's one-card dense f32 step can route a token
    differently from the CPU's f32 step and from the ep ranks."""
    cfg = TM.ModelConfig(vocab_size=32, d_model=16, d_ff=32, n_heads=2,
                         n_layers=1, max_seq=8)
    tree = TM.init_lm_moe_params(6, cfg, n_experts=4)
    toks = np.random.default_rng(6).integers(0, 32, size=(4, 8)).astype(
        np.int32)
    assert min(_route_gaps(tree, toks, 3)) > 1e-4
    res = pool.run(J.cuda_moe_train, tree, toks, 3)
    step = TM.make_lm_moe_train_step(mesh=None, k=2, lr=0.1)
    p, dense = TM.params_from_numpy(tree, device="cuda"), []
    for _ in range(3):
        p, loss = step(p, toks[:, :-1], toks[:, 1:])
        dense.append(float(loss))
    for ep in res:
        np.testing.assert_allclose(ep, dense, rtol=2e-4, atol=2e-4)
    assert dense[-1] < dense[0]
