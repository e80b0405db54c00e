"""Ex10: the five parallelism modes on one rank group.

Eight ranks join one gloo group (a ``RankPool``: on the card every rank
runs on it, time-sharing it) and run each of dp/tp (a transformer block's
training step), pp (the GPipe pipeline), ep (the routed MoE) and sp (ring
attention) against its single-device reference: pick a mesh, place the
shardings, let each rank's body run its shards with the collectives.

    python examples_torch/ex10_parallelism_modes.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def modes(dev):
    """Every rank runs this; rank 0 returns the report."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from parsec_tpu_torch.parallel.moe import (dense_reference,
                                               init_moe_params,
                                               make_ep_mesh, moe_forward)
    from parsec_tpu_torch.parallel.pipeline import (init_pipeline_params,
                                                    make_pp_mesh,
                                                    pipeline_forward,
                                                    reference_forward)
    from parsec_tpu_torch.parallel.ring_attention import (
        _seq_mesh, dense_attention_reference, ring_attention)
    from parsec_tpu_torch.parallel.transformer import (
        init_block_params, make_tp_mesh, make_train_step)

    n = dist.get_world_size()
    rank = dist.get_rank()
    rng = np.random.default_rng(0)
    lines = []

    # dp x tp: train a transformer block
    mesh = make_tp_mesh(tp_must_divide=4, device_type=dev)
    dpn, tpn = mesh.shape
    step, place_p, place_x = make_train_step(mesh, lr=5e-2)
    p = place_p(init_block_params(0, d_model=16, d_ff=32, n_heads=4))
    x = place_x(rng.standard_normal((2 * dpn, 8, 16)).astype(np.float32))
    y = place_x(rng.standard_normal((2 * dpn, 8, 16)).astype(np.float32))
    losses = []
    for _ in range(5):
        p, loss = step(p, x, y)
        losses.append(float(loss))
    lines.append(f"dp{dpn} x tp{tpn} train step: loss {losses[0]:.3f} -> "
                 f"{losses[-1]:.3f}")
    assert losses[-1] < losses[0]

    # pp: GPipe pipeline, one stage a rank
    pparams = init_pipeline_params(0, n, 8)
    px = rng.standard_normal((4, 2, 8)).astype(np.float32)
    pout = pipeline_forward(pparams, px, mesh=make_pp_mesh(n, dev))
    pref = np.stack([reference_forward(pparams, px[i]).numpy()
                     for i in range(4)])
    err = float(np.abs(pout.to_local().cpu().numpy() - pref).max())
    lines.append(f"pp: {n}-stage pipeline == sequential (max err {err:.1e})")
    assert err < 2e-5

    # ep: top-2 routed MoE with the Switch aux load-balance loss
    mp = init_moe_params(0, n, 8, 16)
    mx = rng.standard_normal((4 * n, 8)).astype(np.float32)
    mout, maux = moe_forward(mp, mx, mesh=make_ep_mesh(n, dev), k=2,
                             return_aux=True)
    mref = dense_reference({k: torch.from_numpy(v) for k, v in mp.items()},
                           torch.from_numpy(mx), k=2)
    mine = mref[rank * 4:(rank + 1) * 4]
    err = float((mout.to_local().cpu() - mine).abs().max())
    lines.append(f"ep: {n} experts over {n} ranks, top-2 == dense routing "
                 f"(aux={float(maux['aux_loss']):.2f}, "
                 f"dropped={int(float(maux['dropped']))}, max err "
                 f"{err:.1e})")
    assert err < 1e-4

    # sp: causal ring attention
    q, k, v = (rng.standard_normal((1, 2, 8 * n, 8)).astype(np.float32)
               for _ in range(3))
    r = ring_attention(q, k, v, mesh=_seq_mesh(n, dev), causal=True)
    ref = dense_attention_reference(q, k, v, causal=True)
    err = float((r.to_local().cpu() - ref[:, :, 8 * rank:8 * rank + 8]
                 ).abs().max())
    lines.append(f"sp: causal ring attention seq={8 * n} over {n} ranks == "
                 f"dense (max err {err:.1e})")
    assert err < 2e-4
    return lines if rank == 0 else None


def main():
    from parsec_tpu_torch.parallel.multihost import RankPool
    dev = device()
    with RankPool(8, dev, timeout=300) as pool:
        for line in pool.run(modes, dev)[0]:
            print(line)
    print("ex10 OK: dp x tp, pp, ep and sp each match their single-device "
          "reference")


if __name__ == "__main__":
    main()
