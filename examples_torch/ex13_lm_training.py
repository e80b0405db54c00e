"""Ex13: the LM trained end to end over a mesh of ranks.

Eight ranks join one gloo group (a ``RankPool``; on the card every rank
runs on it) and:

1. train a GPT-class LM (``parallel/model.py``) over a (dp, tp) mesh with
   clipped AdamW: batch over dp, Megatron blocks and the vocab-parallel
   tied embedding and head over tp, the optimizer moments placed like
   their parameters (DTensors);
2. checkpoint the whole training state (``utils/model_ckpt``: DCP, each
   rank its shards) and RESUME bit-exact from the restore;
3. gather the trained parameters and reproduce the memorized token stream
   by KV-cached greedy generation (``lm_generate``), and check the flash
   core's forward logits against the dense core's.

    python examples_torch/ex13_lm_training.py [--cpu]
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402

PATTERN = [3, 1, 4, 1, 5, 9, 2, 6]


def train(dev, path):
    """Every rank runs this; rank 0 returns the report."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from parsec_tpu_torch.parallel import compat
    from parsec_tpu_torch.parallel.model import (ModelConfig, init_lm_params,
                                                 lm_apply, lm_generate,
                                                 make_lm_opt_train_step)
    from parsec_tpu_torch.parallel.optim import (adamw, chain,
                                                 clip_by_global_norm,
                                                 tree_map)
    from parsec_tpu_torch.parallel.spmd import make_mesh
    from parsec_tpu_torch.parallel.transformer import flash_attention_core
    from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                                   save_train_state)

    lines = []
    mesh = make_mesh(8, axis_names=("dp", "tp"), device_type=dev)
    lines.append(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    cfg = ModelConfig(vocab_size=16, d_model=64, d_ff=128, n_heads=4,
                      n_layers=2, max_seq=32)
    params = init_lm_params(0, cfg)
    # the corpus: a periodic token stream the model must memorize
    seq = np.tile(np.array(PATTERN, np.int32), 8)[:33]
    toks = np.broadcast_to(seq, (4, 33)).copy()       # dp batch of 4
    x, y = toks[:, :-1], toks[:, 1:]
    tx = chain(clip_by_global_norm(1.0), adamw(1e-2))
    step, opt, place_p, place_t = make_lm_opt_train_step(mesh, tx, params)
    sp = place_p(params)
    xt, yt = place_t(x), place_t(y)
    for i in range(60):
        sp, opt, loss = step(sp, opt, xt, yt)
        if i % 20 == 0:
            lines.append(f"  step {i:3d}  loss {float(loss):.4f}")
    # checkpoint mid-training, then resume from the restore
    save_train_state(path, sp, opt, step=60)
    rp, ro, rstep = restore_train_state(path, like=(sp, opt))
    lines.append(f"checkpoint saved+restored at step {rstep}")
    for _ in range(30):
        rp, ro, loss = step(rp, ro, xt, yt)
    lines.append(f"final loss after resume: {float(loss):.5f}")
    # the trained parameters, whole on every rank
    full = tree_map(compat.full_tensor, rp)
    out = lm_generate(full, seq[None, :8], 16)
    decoded = [int(v) for v in out[0, 8:]]
    expected = [int(v) for v in np.tile(PATTERN, 3)[:16]]
    lines.append(f"greedy decode: {decoded}")
    assert decoded == expected, f"decode mismatch: {decoded} != {expected}"
    with torch.no_grad():
        flash = lm_apply(full, out, attention=flash_attention_core)
        dense = lm_apply(full, out)
    assert float((flash - dense).abs().max()) < 2e-3
    dist.barrier()
    return lines if dist.get_rank() == 0 else None


def main():
    from parsec_tpu_torch.parallel.multihost import RankPool
    dev = device()
    with tempfile.TemporaryDirectory() as d, \
            RankPool(8, dev, timeout=600) as pool:
        for line in pool.run(train, dev, os.path.join(d, "ckpt"))[0]:
            print(line)
    print("ex13 OK: LM trained (dp x tp + AdamW), checkpoint/resume, "
          "KV-cached generation reproduces the stream, flash core matches")


if __name__ == "__main__":
    main()
