"""Rank script for the port's multi-controller test: every rank joins the
job's gloo group (``init_multihost``; 2 "hosts" x 4 ranks, or 1 x 8 — the
same 8-rank mesh), runs the LM train step over the GLOBAL (dp, tp) mesh and
the other legs across the ranks, and prints its lines. Launched by
``parsec_tpu_torch.parallel.multihost.run_multicontroller``."""
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import numpy as np
    import torch

    from parsec_tpu_torch.parallel.multihost import (
        ENV_COORD, ENV_HOST, fetch_replicated, global_mesh,
        host_local_to_global, init_multihost)
    from parsec_tpu_torch.parallel.model import (ModelConfig, init_lm_params,
                                                 make_lm_train_step)
    torch.set_num_threads(1)
    pid = init_multihost()
    dev = "cpu"
    n = torch.distributed.get_world_size()
    assert n >= 4 and n % 2 == 0, f"need an even mesh, got {n} ranks"
    tp = n // 2
    mesh = global_mesh(("dp", "tp"), (2, tp), dev)
    host = os.environ.get(ENV_HOST)
    local = os.environ.get("LOCAL_RANK")

    cfg = ModelConfig(vocab_size=64, d_model=32, d_ff=64,
                      n_heads=max(4, tp), n_layers=2, max_seq=16)
    params = init_lm_params(0, cfg)          # identical on every rank
    step, place_p, place_t = make_lm_train_step(mesh, params=params, lr=0.1)
    sp = place_p(params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 64, size=(8, 8)).astype(np.int32)
    tokens, targets = place_t(toks[:, :-1]), place_t(toks[:, 1:])
    losses = []
    for _ in range(3):
        sp, loss = step(sp, tokens, targets)
        losses.append(float(fetch_replicated(loss)))
    print(f"MHLOSS pid={pid} host={host} local={local} "
          f"losses={','.join(f'{l:.6f}' for l in losses)}", flush=True)
    assert losses[-1] < losses[0]

    # input-feeding leg: each rank contributes only ITS dp shard of the
    # global batch; the assembled batch reproduces the placed loss
    dp_i = mesh.get_local_rank("dp")
    rows = toks.shape[0] // 2
    mine = toks[dp_i * rows:(dp_i + 1) * rows]
    g_tok = host_local_to_global(mesh, ("dp", None), mine[:, :-1])
    g_tgt = host_local_to_global(mesh, ("dp", None), mine[:, 1:])
    _, loss_fed = step(place_p(init_lm_params(0, cfg)), g_tok, g_tgt)
    _, loss_ref = step(place_p(init_lm_params(0, cfg)), tokens, targets)
    df = abs(float(fetch_replicated(loss_fed)) -
             float(fetch_replicated(loss_ref)))
    print(f"MHFEED pid={pid} diff={df:.2e}", flush=True)
    assert df < 1e-6

    # checkpoint leg: a coordinated DCP save of the sharded train state
    # across every rank, restored onto the same placements
    import tempfile
    from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                                   save_train_state)
    job = os.environ.get(ENV_COORD, "solo").replace(":", "_").replace(
        ".", "-")
    ckdir = os.path.join(tempfile.gettempdir(), f"ptt_mh_ckpt_{job}")
    save_train_state(ckdir, sp, None, step=3)
    p2, _, got_step = restore_train_state(ckdir, like=(sp, None))
    assert got_step == 3
    from parsec_tpu_torch.parallel.optim import tree_leaves
    for a, b in zip(tree_leaves(sp), tree_leaves(p2)):
        assert torch.equal(a.to_local(), b.to_local())
    torch.distributed.barrier()
    if pid == 0:
        import shutil
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"MHCKPT pid={pid} step={got_step} ok=1", flush=True)

    # expert-parallel leg: top-2 MoE with the EXPERTS spread over every
    # rank; the dispatch/combine all-to-all crosses the hosts
    from parsec_tpu_torch.parallel.moe import (dense_reference,
                                               init_moe_params, make_ep_mesh,
                                               moe_forward)
    emesh = make_ep_mesh(n, dev)
    eE, eD, eT = n, 16, 4 * n
    mo = init_moe_params(0, eE, eD, 32)
    mx = np.random.default_rng(7).standard_normal((eT, eD)).astype(
        np.float32)
    mout = moe_forward(mo, mx, mesh=emesh, k=2)
    mref = dense_reference({k: torch.from_numpy(v) for k, v in mo.items()},
                           torch.from_numpy(mx), k=2)
    lo = pid * (eT // n)
    mo_err = float((mout.to_local() - mref[lo:lo + eT // n]).abs().max())
    print(f"MHMOE pid={pid} err={mo_err:.2e}", flush=True)
    assert mo_err < 1e-4

    # pipeline leg: GPipe microbatches over ALL ranks, one stage each
    from parsec_tpu_torch.parallel.pipeline import (
        _mlp_stage, init_pipeline_params, make_pp_mesh,
        pipeline_forward_stages, reference_forward)
    pp = init_pipeline_params(3, n, 16)
    px = np.random.default_rng(8).standard_normal((n, 2, 16)).astype(
        np.float32)
    p_out = pipeline_forward_stages({"w": pp["w"], "b": pp["b"]}, px,
                                    _mlp_stage, mesh=make_pp_mesh(n, dev))
    p_ref = reference_forward(pp, px.reshape(-1, 16)).reshape(px.shape)
    pp_err = float((p_out.to_local() - p_ref).abs().max())
    print(f"MHPP pid={pid} err={pp_err:.2e} stages={n}", flush=True)
    assert pp_err < 1e-4

    # long-context leg: causal ring attention with the SEQUENCE axis over
    # every rank
    from parsec_tpu_torch.parallel.ring_attention import (
        _seq_mesh, dense_attention_reference, ring_attention)
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((1, 2, 64, 8)).astype(np.float32)
               for _ in range(3))
    out = ring_attention(q, k, v, mesh=_seq_mesh(n, dev), causal=True)
    ref = dense_attention_reference(q, k, v, causal=True)
    blk = 64 // n
    lo, hi = pid * blk, (pid + 1) * blk
    err = float((out.to_local() - ref[:, :, lo:hi]).abs().max())
    print(f"MHRING pid={pid} err={err:.2e} span={lo}:{hi}", flush=True)
    assert err < 1e-4
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
