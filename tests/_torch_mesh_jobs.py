"""Rank-side bodies of the port's mesh tests (``tests/test_torch_*`` mesh
files): each runs on every rank of a CPU :class:`RankPool` and returns
numpy values for the test to hold against the reference. This module
imports neither JAX nor the reference package, so a rank that unpickles a
job never loads them."""

import numpy as np
import torch
import torch.distributed as dist

from parsec_tpu_torch.parallel import compat
from parsec_tpu_torch.parallel import model as M
from parsec_tpu_torch.parallel import moe as MoE
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.parallel import pipeline as PP
from parsec_tpu_torch.parallel import ring_attention as RA
from parsec_tpu_torch.parallel import spmd
from parsec_tpu_torch.parallel import transformer as T

CPU = "cpu"


def _np(x):
    """A DTensor's whole value (gathered on every rank of its mesh) or a
    tensor, as numpy; None stays None."""
    if x is None:
        return None
    if isinstance(x, compat.DTensor):
        x = compat.full_tensor(x)
    return x.detach().cpu().float().numpy() if x.is_floating_point() \
        else x.detach().cpu().numpy()


def rank() -> int:
    return dist.get_rank()


# ------------------------------------------------------------------- spmd

def mesh_shape(n, names=("p", "q")):
    m = spmd.make_mesh(n, names, device_type=CPU)
    return tuple(m.shape), tuple(m.mesh_dim_names), m.get_coordinate()


def gemm(kind, n, A, B):
    mesh = spmd.make_mesh(n, device_type=CPU)
    fn = {"cannon": spmd.distributed_gemm,
          "allgather": spmd.distributed_gemm_allgather}[kind]
    compat.reset_stats()
    C = fn(A, B, mesh)
    if C is None:
        return None
    return {"C": _np(C), "spec": tuple(compat.spec_of(C)),
            "local": tuple(C.to_local().shape),
            "stats": compat.stats_summary()}


def potrf(n, A, block):
    mesh = spmd.make_mesh(n, device_type=CPU)
    L = spmd.distributed_potrf(A, mesh, block=block)
    return None if L is None else _np(L)


def training_step(n, A, B, C):
    mesh = spmd.make_mesh(n, device_type=CPU)
    C2, L = spmd.training_step(A, B, C, mesh)
    return _np(C2), _np(L)


def bridge_roundtrip(a, b, n, ts):
    """The DTD GEMM writes C; to_global shards it over the mesh; a mesh
    program scales it; from_global hands it to a second taskpool."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data.mesh_bridge import from_global, to_global
    from parsec_tpu_torch.dsl.dtd import RW
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.parallel.multihost import device_mesh
    mesh = device_mesh((2, 4), ("x", "y"), CPU)
    ctx = ptt.Context(nb_cores=1, device="cpu")
    try:
        A = TwoDimBlockCyclic("mbA", n, n, ts, ts, P=1, Q=1)
        B = TwoDimBlockCyclic("mbB", n, n, ts, ts, P=1, Q=1)
        C = TwoDimBlockCyclic("mbC", n, n, ts, ts, P=1, Q=1)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
        tp = ptt.DTDTaskpool(ctx, "bridge-gemm")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        g = to_global(C, mesh)
        spec = tuple(compat.spec_of(g))
        g2 = compat.shard_map(lambda x: 2.0 * x, mesh, (compat.P("x", "y"),),
                              compat.P("x", "y"))(g)
        from_global(C, g2)
        tp2 = ptt.DTDTaskpool(ctx, "bridge-post")
        for m in range(C.mt):
            tp2.insert_task(lambda x: x + 1.0, (tp2.tile_of(C, m, 0), RW))
        tp2.wait(timeout=30)
        tp2.close()
        ctx.wait(timeout=30)
        return spec, C.to_dense()
    finally:
        ctx.fini()


def bridge_redistribute(src_v):
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data.mesh_bridge import redistribute_mesh
    from parsec_tpu_torch.parallel.multihost import device_mesh
    mesh = device_mesh((2, 4), ("x", "y"), CPU)
    n = src_v.shape[0]
    src = TwoDimBlockCyclic("rsrc", n, n, 16, 16, P=1, Q=1)
    dst = TwoDimBlockCyclic("rdst", n, n, 8, 8, P=1, Q=1)
    src.fill(lambda m, k: src_v[m*16:(m+1)*16, k*16:(k+1)*16])
    redistribute_mesh(src, dst, mesh)
    bad = TwoDimBlockCyclic("rbad", 32, 32, 8, 8, P=1, Q=1)
    try:
        redistribute_mesh(src, bad, mesh)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    return dst.to_dense(), refused


# --------------------------------------------------------- ring / ulysses

def attention(kind, n, q, k, v, causal):
    mesh = RA._seq_mesh(n, CPU)
    fn = {"ring": RA.ring_attention, "ulysses": RA.ulysses_attention}[kind]
    from parsec_tpu_torch.ops import cuda_kernels as K
    before = K.flash_attention.launches
    out = fn(q, k, v, mesh=mesh, causal=causal)
    if out is None:
        return None
    return {"out": _np(out), "spec": tuple(compat.spec_of(out)),
            "local": tuple(out.to_local().shape),
            "kernel_launches": K.flash_attention.launches - before}


# --------------------------------------------------------- pipeline / moe

def pipeline(n, params, x, n_micro=None):
    mesh = PP.make_pp_mesh(n, CPU)
    return _np(PP.pipeline_forward(params, x, mesh=mesh, n_micro=n_micro))


def moe(n, params, x, kw):
    mesh = MoE.make_ep_mesh(n, CPU)
    out = MoE.moe_forward(params, x, mesh=mesh, **kw)
    if out is None:
        return None
    if isinstance(out, tuple):
        y, aux = out
        return (_np(y), float(aux["aux_loss"]), float(aux["dropped"]),
                tuple(compat.spec_of(y)))
    return _np(out), tuple(compat.spec_of(out))


# ------------------------------------------------------------ transformer

def tp_mesh(n=None, dp_size=None, tp_must_divide=None):
    m = T.make_tp_mesh(n, dp_size=dp_size, tp_must_divide=tp_must_divide,
                       device_type=CPU)
    return tuple(m.shape), tuple(m.mesh_dim_names)


def block_steps(params, x, y, lr, steps, sp=False):
    """``steps`` SGD steps of one block over the (dp, tp) mesh (or, with
    ``sp``, the 8-rank sequence mesh): the losses, the parameters after
    the first step and their placements."""
    if sp:
        mesh = RA._seq_mesh(None, CPU)
        step, place_p, place_x = T.make_sp_train_step(mesh, lr=lr)
    else:
        mesh = T.make_tp_mesh(device_type=CPU)
        step, place_p, place_x = T.make_train_step(mesh, lr=lr)
    p = place_p(params)
    xd, yd = place_x(x), place_x(y)
    losses, first = [], None
    for i in range(steps):
        p, loss = step(p, xd, yd)
        losses.append(float(loss))
        if i == 0:
            first = {k: _np(v) for k, v in p.items()}
    specs = {k: tuple(compat.spec_of(v)) for k, v in p.items()}
    return losses, first, specs


# ------------------------------------------------------------------- LM

def _dp_tp(dp_size=None):
    if dp_size is None:
        return spmd.make_mesh(8, ("dp", "tp"), device_type=CPU)
    return T.make_tp_mesh(8, dp_size=dp_size, device_type=CPU)


def lm_sgd(tree, x, y, lr, steps, dp_size=None, causal=True):
    """``steps`` SGD steps of the LM over (dp, tp): the losses, block 0's
    w1 and the embedding after the first step, the embedding's local
    shape."""
    mesh = _dp_tp(dp_size)
    step, place_p, place_t = M.make_lm_train_step(mesh, lr=lr, params=tree,
                                                  causal=causal)
    sp = place_p(tree)
    xt, yt = place_t(x), place_t(y)
    losses, w1, emb = [], None, None
    for i in range(steps):
        sp, loss = step(sp, xt, yt)
        losses.append(float(loss))
        if i == 0:
            w1 = _np(sp["blocks"][0]["w1"])
            emb = _np(sp["embed"])
    return {"losses": losses, "w1": w1, "embed": emb,
            "embed_local": tuple(sp["embed"].to_local().shape),
            "embed_spec": tuple(compat.spec_of(sp["embed"]))}


def lm_causal_pair(tree, x, y):
    mesh = _dp_tp()
    s_c, place_p, place_t = M.make_lm_train_step(mesh, lr=0.1, params=tree,
                                                 causal=True)
    s_nc, _, _ = M.make_lm_train_step(mesh, lr=0.1, params=tree,
                                      causal=False)
    _, lc = s_c(place_p(tree), place_t(x), place_t(y))
    _, lnc = s_nc(place_p(tree), place_t(x), place_t(y))
    return float(lc), float(lnc)


def lm_adamw_ckpt(tree, x, y, path):
    """Six clipped AdamW steps over (dp, tp), the moments' placements, a
    checkpoint and the resumed step against the live one."""
    from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                                   save_train_state)
    mesh = _dp_tp()
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(3e-3))
    step, opt, place_p, place_t = M.make_lm_opt_train_step(mesh, tx, tree)
    sp = place_p(tree)
    xt, yt = place_t(x), place_t(y)
    losses = []
    for _ in range(6):
        sp, opt, loss = step(sp, opt, xt, yt)
        losses.append(float(loss))
    mu_spec = tuple(compat.spec_of(opt["mu"]["embed"]))
    w1_spec = tuple(compat.spec_of(opt["nu"]["blocks"][0]["w1"]))
    save_train_state(path, sp, opt, step=6)
    rp, ro, rstep = restore_train_state(path, like=(sp, opt))
    same = bool(np.array_equal(_np(rp["embed"]), _np(sp["embed"])) and
                np.array_equal(_np(ro["mu"]["embed"]),
                               _np(opt["mu"]["embed"])) and
                int(ro["count"]) == int(opt["count"]))
    count = int(opt["count"])
    a1, _, l1 = step(sp, opt, xt, yt)
    b1, _, l2 = step(rp, ro, xt, yt)
    return {"losses": losses, "mu_spec": mu_spec, "nu_w1_spec": w1_spec,
            "step": rstep, "restored": same,
            "resumed": (float(l1), float(l2)),
            "w1": (_np(a1["blocks"][0]["w1"]), _np(b1["blocks"][0]["w1"])),
            "count": count}


def lm_opt_first_step(tree, x, y, max_norm, lr):
    """One (clipped) AdamW step over (dp, tp): the loss and the whole
    parameter tree after it."""
    mesh = _dp_tp()
    tx = O.adamw(lr) if max_norm is None else \
        O.chain(O.clip_by_global_norm(max_norm), O.adamw(lr))
    step, opt, place_p, place_t = M.make_lm_opt_train_step(mesh, tx, tree)
    sp, opt, loss = step(place_p(tree), opt, place_t(x), place_t(y))
    return float(loss), O.tree_map(_np, sp)


def state_specs(tree):
    mesh = _dp_tp()
    pspec = M._lm_param_spec(mesh, "dp", "tp", len(tree["blocks"]))
    ospec = M._state_spec_like(mesh, pspec, tree, O.adamw(1e-3).init(tree))
    return (tuple(ospec["mu"]["embed"].spec), tuple(ospec["mu"]["pos"].spec),
            tuple(ospec["count"].spec), tuple(ospec["nu"]["embed"].spec))


def lm_bf16_remat(tree, x, y, steps):
    mesh = _dp_tp()
    step, opt, pp, pt_ = M.make_lm_opt_train_step(
        mesh, O.adamw(3e-3), tree, remat=True, compute_dtype=torch.bfloat16)
    sp = pp(tree)
    losses = []
    for _ in range(steps):
        sp, opt, loss = step(sp, opt, pt_(x), pt_(y))
        losses.append(float(loss))
    return losses, str(sp["embed"].dtype)


def lm_ring(tree, x):
    mesh = RA._seq_mesh(8, CPU)
    p = M.params_from_numpy(tree, device="cpu")
    return M.lm_apply(p, x, attention=T.ring_attention_core(mesh)).numpy()


def lm_pp(tree, toks, nP, m):
    from parsec_tpu_torch.parallel.pipeline import make_pp_mesh
    mesh = make_pp_mesh(nP, CPU)
    try:
        out = M.lm_pp_forward(tree, toks, mesh=mesh, n_micro=m)
    except ValueError as e:
        return "ValueError: " + str(e)
    return _np(out)


def lm_moe_ep(tree, toks, k, steps=0, lr=0.1):
    """The MoE-LM over the 8-rank ep mesh: the forward and its aux (and
    with ``steps``, that many train steps' losses)."""
    mesh = MoE.make_ep_mesh(8, CPU)
    p = M.params_from_numpy(tree, device="cpu")
    if steps:
        step = M.make_lm_moe_train_step(mesh=mesh, k=k, lr=lr)
        out = []
        for _ in range(steps):
            p, loss = step(p, toks[:, :-1], toks[:, 1:])
            out.append(float(loss))
        return out
    logits, aux = M.lm_moe_apply(p, toks, k=k, mesh=mesh, return_aux=True)
    return logits.numpy(), float(aux["aux_loss"]), float(aux["dropped"])


def lm_moe_ep_grad(tree, toks):
    """Gradients of the ep MoE-LM's loss reach the experts through the
    all-to-alls; one SGD step lowers the loss."""
    mesh = MoE.make_ep_mesh(8, CPU)
    p = M.params_from_numpy(tree, device="cpu")
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def loss_fn(q):
        return M._xent(M.lm_moe_apply(q, tokens, k=2, mesh=mesh), targets)
    l0, leaves, grads = O.value_and_grad(loss_fn, p)
    w1_grad = next(float(g.abs().max()) for (path, _), g in
                   zip(M._paths(p), grads)
                   if path == ("blocks", "0", "moe", "w1"))
    gsum = float(sum(g.abs().sum() for g in grads))
    O.sgd(leaves, grads, 0.2)
    return float(l0), float(loss_fn(p)), gsum, w1_grad


# ------------------------------------------------------------- the pool

def misbehave(how):
    """Rank 1 raises, aborts or hangs; the others wait for it in a
    collective."""
    import os
    import time
    if rank() == 1:
        if how == "raise":
            raise ValueError("rank 1 says no")
        if how == "abort":
            os.abort()
        time.sleep(600)
    dist.barrier()


def default_mesh():
    try:
        spmd.make_mesh()
    except RuntimeError as e:
        return str(e)
    return "no error"


# ------------------------------------- the entry points on a rank group

def entry_points(tree, moe_tree, block, x, y, toks):
    """One step of each training entry point on a 4-rank group: the LM's
    SGD and AdamW steps and the block's step over (dp 2, tp 2), the
    MoE-LM's step over a 4-rank ep mesh. Their pre-step losses."""
    mesh = spmd.make_mesh(4, ("dp", "tp"), device_type=CPU)
    out = {}
    step, pp, pt_ = M.make_lm_train_step(mesh, params=tree)
    out["lm"] = float(step(pp(tree), pt_(x), pt_(y))[1])
    step, opt, pp, pt_ = M.make_lm_opt_train_step(mesh, O.adamw(1e-3), tree)
    out["lm_opt"] = float(step(pp(tree), opt, pt_(x), pt_(y))[2])
    step, pp, px = T.make_train_step(mesh, lr=0.05)
    bp, bx, by = block
    out["block"] = float(step(pp(bp), px(bx), px(by))[1])
    step = M.make_lm_moe_train_step(mesh=MoE.make_ep_mesh(4, CPU))
    p = M.params_from_numpy(moe_tree, device="cpu")
    out["moe"] = float(step(p, toks[:, :-1], toks[:, 1:])[1])
    return out


def moe_layer(params, x, k):
    mesh = MoE.make_ep_mesh(4, CPU)
    y = MoE.moe_forward(params, x, mesh=mesh, k=k)
    return _np(y), tuple(compat.spec_of(y)), tuple(y.to_local().shape)


def loader_batches(corpus, n_batches):
    """The loader's batches placed over (dp 2, tp 2): each leaf a DTensor
    split over dp."""
    from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
    mesh = spmd.make_mesh(4, ("dp", "tp"), device_type=CPU)
    ld = PrefetchLoader(
        lambda: token_batches(corpus, batch=4, seq_len=8, seed=1,
                              n_batches=n_batches),
        sharding=compat.NamedSharding(mesh, compat.P("dp", None)), ahead=2)
    out = []
    for x, y in ld:
        assert isinstance(x, compat.DTensor) and isinstance(y,
                                                            compat.DTensor)
        out.append((_np(x), tuple(x.to_local().shape),
                    tuple(compat.spec_of(y))))
    return out


def loader_trains(tree, corpus, n_batches):
    """corpus -> token_batches -> PrefetchLoader (sharded staging) -> the
    AdamW LM step over (dp 2, tp 2): the losses."""
    from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
    mesh = spmd.make_mesh(4, ("dp", "tp"), device_type=CPU)
    step, opt, place_p, _ = M.make_lm_opt_train_step(mesh, O.adamw(1e-2),
                                                     tree)
    sp = place_p(tree)
    ld = PrefetchLoader(
        lambda: token_batches(corpus, batch=4, seq_len=16, seed=1,
                              n_batches=n_batches),
        sharding=compat.NamedSharding(mesh, compat.P("dp", None)), ahead=2)
    losses = []
    for x, y in ld:
        sp, opt, loss = step(sp, opt, x, y)
        losses.append(float(loss))
    return losses


def lm_moe_ep4(tree, toks):
    """The MoE-LM forward over a 4-rank ep mesh (4 experts)."""
    mesh = MoE.make_ep_mesh(4, CPU)
    p = M.params_from_numpy(tree, device="cpu")
    logits, aux = M.lm_moe_apply(p, toks, k=2, mesh=mesh, return_aux=True)
    return logits.numpy(), float(aux["aux_loss"]), float(aux["dropped"])


# ------------------------------------------------------- card rank groups

def cuda_collectives():
    """On every CUDA rank: each compat collective on CUDA tensors against
    the same collective on CPU tensors, and the routes taken."""
    n, r = dist.get_world_size(), rank()
    g = dist.group.WORLD
    out = {}
    for dev in ("cpu", "cuda"):
        base = torch.arange(n * 4, dtype=torch.float32, device=dev) + 100 * r
        res = {
            "all_reduce": compat.all_reduce_(base.clone(), g),
            "all_gather": compat.all_gather(base[:4].contiguous(), g),
            "reduce_scatter": compat.reduce_scatter(base, g),
            "all_to_all": compat.all_to_all(base.reshape(n, 4), g, 0, 1),
            "send_recv": compat.ring_shift(base, g)}
        out[dev] = {k: v.cpu().numpy() for k, v in res.items()}
    same = {k: bool(np.array_equal(out["cpu"][k], out["cuda"][k]))
            for k in out["cpu"]}
    return same, compat.routes("cuda")


def cuda_ulysses(shape, seed):
    """Ulysses bf16 causal on 4 CUDA ranks: the flash launches by route in
    the call and the worst excess over the bf16 bound."""
    from parsec_tpu_torch.ops import cuda_kernels as K
    B, H, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    mesh = RA._seq_mesh(4, "cuda")
    K.flash_attention.launches_by_route = dict.fromkeys(K.FLASH_ROUTES, 0)
    o = RA.ulysses_attention(q, k, v, mesh=mesh, causal=True)
    launches = dict(K.flash_attention.launches_by_route)
    blk = S // 4
    r = mesh.get_local_rank("sp")
    plain = K.flash_attention_plain(q, k, v, True, 1.0 / D ** 0.5)
    tol = K.flash_attention_bf16_tolerance(q, k, v, causal=True)
    err = (o.to_local().float() - plain[:, :, r * blk:(r + 1) * blk].float()
           ).abs()
    return launches, float((err - tol[:, :, r * blk:(r + 1) * blk]).max())


def cuda_lm_steps(tree, x, y):
    """Two clipped AdamW steps of a small LM over (dp 2, tp 2) CUDA ranks:
    the losses and the whole tree after the first."""
    from parsec_tpu_torch.ops import cuda_kernels as K
    K.dot_precision()
    mesh = spmd.make_mesh(4, ("dp", "tp"), device_type="cuda")
    tx = O.chain(O.clip_by_global_norm(0.5), O.adamw(1e-3))
    step, opt, place_p, place_t = M.make_lm_opt_train_step(mesh, tx, tree)
    p, xt, yt = place_p(tree), place_t(x), place_t(y)
    p, opt, l0 = step(p, opt, xt, yt)
    first = O.tree_map(_np, p)
    p, opt, l1 = step(p, opt, xt, yt)
    return [float(l0), float(l1)], first, str(p["embed"].device)


def cuda_loader_batches(corpus, n_batches):
    """The loader's batches staged over (dp 2, tp 2) CUDA ranks: each
    leaf's whole value, its local shard's shape and device, and its
    spec."""
    from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
    mesh = spmd.make_mesh(4, ("dp", "tp"), device_type="cuda")
    ld = PrefetchLoader(
        lambda: token_batches(corpus, batch=4, seq_len=8, seed=1,
                              n_batches=n_batches),
        sharding=compat.NamedSharding(mesh, compat.P("dp", None)), ahead=2)
    out = []
    for x, y in ld:
        out.append((_np(x), _np(y), tuple(x.to_local().shape),
                    str(x.to_local().device), tuple(compat.spec_of(y))))
    return out


def cuda_moe_train(tree, toks, steps):
    """The MoE-LM's SGD steps over a 4-rank ep mesh of CUDA ranks."""
    mesh = MoE.make_ep_mesh(4, "cuda")
    p = M.params_from_numpy(tree, device="cuda")
    step = M.make_lm_moe_train_step(mesh=mesh, k=2, lr=0.1)
    out = []
    for _ in range(steps):
        p, loss = step(p, toks[:, :-1], toks[:, 1:])
        out.append(float(loss))
    return out

