"""The port's training-state checkpoint (``utils/model_ckpt.py``): the
parameters, the optimizer state and the step saved and restored bit for
bit, and a resumed run continuing exactly as the saved one (the CPU half
of the reference's ``test_lm_opt_train_step_adamw_and_checkpoint``, whose
mesh half waits for the mesh slice)."""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                               save_train_state)

CFG = TM.ModelConfig(vocab_size=64, d_model=32, d_ff=64, n_heads=4,
                     n_layers=2, max_seq=32)


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 64, size=(4, 33)
                                                ).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _equal_trees(a, b):
    la, lb = O.tree_leaves(a), O.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_adamw_checkpoint_resumes_bit_exact(tmp_path):
    x, y = _batch(7)
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(3e-3))
    step, opt, place_p, place_t = TM.make_lm_opt_train_step(
        "cpu", tx, TM.init_lm_params(7, CFG))
    sp = place_p(TM.init_lm_params(7, CFG))
    xt, yt = place_t(x), place_t(y)
    losses = []
    for _ in range(6):
        sp, opt, loss = step(sp, opt, xt, yt)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses

    path = str(tmp_path / "ckpt")
    assert save_train_state(path, sp, opt, step=6) == path
    rp, ro, rstep = restore_train_state(path, like=(sp, opt))
    assert rstep == 6 and int(ro["count"]) == 6
    _equal_trees(rp, sp)
    _equal_trees(ro, opt)
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(O.tree_leaves(rp), O.tree_leaves(sp)))
    # resuming from the restored state continues identically
    a1, _, l1 = step(sp, opt, xt, yt)
    b1, _, l2 = step(rp, ro, xt, yt)
    assert float(l1) == float(l2)
    _equal_trees(a1, b1)


def test_restore_without_like_and_bf16_leaves(tmp_path):
    tree = TM.params_from_numpy(TM.init_lm_params(1, CFG), device="cpu",
                                dtype=torch.bfloat16)
    path = save_train_state(str(tmp_path / "c"), tree, None, step=3)
    p, o, s = restore_train_state(path)
    assert o is None and s == 3
    _equal_trees(p, tree)
    assert isinstance(p["blocks"], list) and len(p["blocks"]) == 2
    with pytest.raises(FileExistsError):
        save_train_state(path, tree, force=False)
    # a newer save replaces the directory
    save_train_state(path, tree, None, step=4)
    assert restore_train_state(path)[2] == 4


def test_sgd_resume_matches_uninterrupted_run(tmp_path):
    """Five SGD steps straight through equal three, a save and restore,
    and two more, bit for bit."""
    x, y = _batch(3)
    step, place_p, place_t = TM.make_lm_train_step(
        "cpu", lr=0.2, params=TM.init_lm_params(3, CFG))
    straight = place_p(TM.init_lm_params(3, CFG))
    for _ in range(5):
        straight, _ = step(straight, place_t(x), place_t(y))
    p = place_p(TM.init_lm_params(3, CFG))
    for _ in range(3):
        p, _ = step(p, place_t(x), place_t(y))
    path = save_train_state(str(tmp_path / "s"), p, step=3)
    p, _, n = restore_train_state(path, like=(p, None))
    for _ in range(5 - n):
        p, _ = step(p, place_t(x), place_t(y))
    _equal_trees(p, straight)
