"""The port's device-to-device comm backend (``parsec_tpu_torch/comm/d2d.py``):
the reference's ``tests/test_ici.py`` on the port.

Task payloads move device to device through the comm engine: remote tiles
land in the consumer's device memory and no device payload is ever
materialized to host bytes on the way (ref: the accelerator-memory comms
capability, parsec/parsec_internal.h:504, and the consumer-device landing,
remote_dep_mpi.c:2120). On the CPU every rank's CUDA device module runs
over the CPU (``device_cuda_over_cpu``) and the device map's devices are
the CPU; the ``cuda`` cases run the same checks on the card, every rank
driving ``cuda:0``.
"""

import threading

import numpy as np
import pytest
import torch

from parsec_tpu_torch.comm.d2d import (CTR_D2D_BYTES, CTR_D2D_MSGS,
                                       CTR_HOST_MATERIALIZED, D2DCE,
                                       default_device_map)
from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
from parsec_tpu_torch.comm.threads import run_distributed
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca
from parsec_tpu_torch.utils.counters import counters

_setup_lock = threading.Lock()


def _device_map(nb_ranks, card=False):
    return [torch.device("cuda", 0) if card else torch.device("cpu")] \
        * nb_ranks


def _mkctx(rank, fabric, device_map, card=False):
    """Per-rank context whose CUDA device module drives device_map[rank]
    (the card, or the CPU in the test mode)."""
    with _setup_lock:   # mca is process-global; serialize the binding
        if not card:
            mca.set("device_cuda_over_cpu", True)
        mca.set("device_load_balance_allow_cpu", False)
        if card:
            mca.set("device_cuda_max_bytes", 1 << 28)   # a budget a rank
        ctx = Context(nb_cores=1, device="cuda" if card else "cpu",
                      my_rank=rank, nb_ranks=fabric.nb_ranks)
    RemoteDepEngine(ctx, D2DCE(fabric, rank, device_map))
    return ctx


@pytest.fixture(autouse=True)
def _over_cpu_cleanup():
    yield
    for p in ("device_cuda_over_cpu", "device_load_balance_allow_cpu",
              "device_cuda_max_bytes", "comm_eager_limit"):
        mca.params.unset(p)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _host(t):
    return t.float().cpu().numpy()


def _gemm_d2d(nb_ranks, card):
    N, TS = 64, 16
    rng = np.random.default_rng(21)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    dmap = _device_map(nb_ranks, card)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap, card)
        kw = dict(nodes=nb_ranks, myrank=rank, P=2, Q=nb_ranks // 2)
        A = TwoDimBlockCyclic("iA", N, N, TS, TS, **kw)
        B = TwoDimBlockCyclic("iB", N, N, TS, TS, **kw)
        C = TwoDimBlockCyclic("iC", N, N, TS, TS, **kw)
        A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(ctx, "d2d-gemm")
        # warm A/B on the device at their owners first (a producing task
        # per tile): the panels that cross ranks are then DEVICE-resident
        # outputs, so the d2d counter measures produced-tile movement, not
        # the initial host-data distribution
        for M in (A, B):
            for m in range(M.mt):
                for n in range(M.nt):
                    tp.insert_task(lambda x: x * 1.0,
                                   (tp.tile_of(M, m, n), RW), name="warm")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=60)
        ctx.fini()
        return {(m, n): _host(C.data_of(m, n).newest_copy().payload)
                for m in range(C.mt) for n in range(C.nt)
                if C.rank_of(m, n) == rank}

    d2d0 = counters.read(CTR_D2D_MSGS)
    mat0 = counters.read(CTR_HOST_MATERIALIZED)
    bytes0 = counters.read(CTR_D2D_BYTES)
    results = run_distributed(nb_ranks, program, timeout=120)
    assert counters.read(CTR_D2D_MSGS) > d2d0, \
        "no payload moved device-to-device"
    assert counters.read(CTR_D2D_BYTES) > bytes0
    assert counters.read(CTR_HOST_MATERIALIZED) == mat0, \
        "a device payload was materialized to host on the remote path"
    ref = a @ b
    full = {}
    for out in results:
        full.update(out)
    assert len(full) == (N // TS) ** 2
    for (m, n), tile in full.items():
        np.testing.assert_allclose(
            tile, ref[m*TS:(m+1)*TS, n*TS:(n+1)*TS], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("nb_ranks", [2, 4])
def test_ici_dtd_gemm_device_to_device(nb_ranks):
    """Distributed DTD GEMM over the d2d backend: correctness AND the
    device-native property — produced tiles cross rank boundaries device
    to device (the d2d counter advances) with ZERO host materializations
    of device payloads on the remote path."""
    _gemm_d2d(nb_ranks, card=False)


def test_ici_dtd_potrf():
    """Distributed DTD Cholesky over the d2d backend: factor panels cross
    device to device."""
    N, TS = 64, 16
    spd = make_spd(N, seed=23)
    dmap = _device_map(2)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap)
        A = TwoDimBlockCyclic("iP", N, N, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: spd[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        tp = DTDTaskpool(ctx, "d2d-potrf")
        insert_potrf_tasks(tp, A)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=60)
        ctx.fini()
        return {(m, n): _host(A.data_of(m, n).newest_copy().payload)
                for m in range(A.mt) for n in range(A.nt)
                if A.rank_of(m, n) == rank and m >= n}

    d2d0 = counters.read(CTR_D2D_MSGS)
    mat0 = counters.read(CTR_HOST_MATERIALIZED)
    results = run_distributed(2, program, timeout=120)
    assert counters.read(CTR_D2D_MSGS) > d2d0
    assert counters.read(CTR_HOST_MATERIALIZED) == mat0
    L = np.zeros((N, N), np.float32)
    for out in results:
        for (m, n), tile in out.items():
            L[m*TS:(m+1)*TS, n*TS:(n+1)*TS] = tile
    L = np.tril(L)
    np.testing.assert_allclose(L @ L.T, spd, rtol=1e-2, atol=1e-2)


def _landing(card):
    """A produced tile consumed remotely arrives ALREADY RESIDENT on the
    consumer's device and becomes that device's copy at the new version
    (ref remote_dep_mpi.c:2120): the consumer's stage-in moves only the
    tile it owns (its own host tile), never the landed one."""
    dmap = _device_map(2, card)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap, card)
        A = TwoDimBlockCyclic("iL", 8, 8, 4, 4, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: np.full((4, 4), 1.0, np.float32))
        dev = next(d for d in ctx.devices.devices
                   if isinstance(d, CUDADevice))
        tp = DTDTaskpool(ctx, "d2d-landing")
        src = tp.tile_of(A, 0, 0)   # rank 0 produces
        dst = tp.tile_of(A, 1, 0)   # rank 1 consumes
        tp.insert_task(lambda x: x * 5.0, (src, RW), name="w")
        tp.wait(timeout=30)
        moved0 = dev.transfer_in_bytes
        tp.insert_task(lambda y, x: y + x[0, 0], (dst, RW), (src, READ),
                       name="r")
        tp.wait(timeout=30)
        tp.close()
        ctx.wait(timeout=30)
        out = None
        if rank == 1:
            dcopy = src.data.get_copy(dev.device_index)
            host = src.data.get_copy(0)
            out = {
                "has_device_copy": dcopy is not None,
                "on_my_device": dcopy is not None
                and isinstance(dcopy.payload, torch.Tensor)
                and dcopy.payload.device == dev.torch_device,
                "version_current": dcopy is not None and host is not None
                and dcopy.version == host.version,
                "moved": dev.transfer_in_bytes - moved0,
                "value": float(_host(
                    A.data_of(1, 0).newest_copy().payload)[0, 0]),
            }
        ctx.fini()
        return out

    res = run_distributed(2, program, timeout=60)[1]
    assert res["value"] == 6.0            # 1 + 5*1
    assert res["has_device_copy"], "payload did not land as a device copy"
    assert res["on_my_device"], "landed copy is not on the consumer's device"
    assert res["version_current"], "landed device copy has a stale version"
    # the reader staged in only its own 4x4 f32 tile: the landed one took
    # the version-match fast path
    assert res["moved"] == 4 * 4 * 4, res


def test_ici_consumer_device_landing():
    _landing(card=False)


def test_default_device_map_is_the_card_or_raises():
    """The default map binds rank r to card r mod the card count; without a
    card it raises instead of placing the ranks on the CPU."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert default_device_map(3) == [torch.device("cuda", r % n)
                                         for r in range(3)]
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            default_device_map(2)


def test_ici_rendezvous_path_stays_device_native():
    """Payloads over the eager limit take GET/PUT rendezvous — the PUT
    payload must still relocate device to device."""
    mca.set("comm_eager_limit", 64)   # force rendezvous for 16x16 tiles
    N, TS = 32, 16
    rng = np.random.default_rng(29)
    a = rng.standard_normal((N, N)).astype(np.float32)
    dmap = _device_map(2)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap)
        A = TwoDimBlockCyclic("iR", N, N, TS, TS, P=2, Q=1,
                              nodes=2, myrank=rank)
        A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        tp = DTDTaskpool(ctx, "d2d-rdv")
        acc = tp.tile_of(A, 0, 0)
        for n in range(A.nt):
            src = tp.tile_of(A, 1, n)
            # produce on rank 1's device so the rendezvous PUT carries a
            # device-resident payload
            tp.insert_task(lambda x: x * 1.0, (src, RW), name="warm")
            tp.insert_task(lambda x, y: x + y, (acc, RW), (src, READ))
        tp.wait(timeout=30)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        if rank == 0:
            return _host(A.data_of(0, 0).newest_copy().payload)
        return None

    d2d0 = counters.read(CTR_D2D_MSGS)
    mat0 = counters.read(CTR_HOST_MATERIALIZED)
    results = run_distributed(2, program, timeout=60)
    assert counters.read(CTR_D2D_MSGS) > d2d0
    assert counters.read(CTR_HOST_MATERIALIZED) == mat0
    expect = a[:TS, :TS] + a[TS:2*TS, :TS] + a[TS:2*TS, TS:2*TS]
    np.testing.assert_allclose(results[0], expect, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_d2d_gemm_on_the_card():
    """The 2-rank GEMM with both ranks' device modules on ``cuda:0``:
    produced tiles cross as CUDA tensors, none host-materialized."""
    _need_card()
    _gemm_d2d(2, card=True)


@pytest.mark.cuda
def test_d2d_consumer_device_landing_on_the_card():
    """The landing on the card: the consumer's stage-in moves only its own
    tile; the landed CUDA tensor is its device copy at the new version."""
    _need_card()
    _landing(card=True)


@pytest.mark.cuda
def test_d2d_send_waits_for_a_long_producer_kernel():
    """Stream order across threads: a long kernel writes a tile on the
    device module's stream and the send follows at once; the snapshot the
    send ships is ordered after the kernel, so the consumer receives the
    produced tile bit for bit."""
    _need_card()
    dmap = _device_map(2, True)
    n = 2048

    def long_body(x):
        y = x
        for _ in range(40):          # a few ms of matmuls on the stream
            y = torch.tanh(y @ x * 1e-3)
        return y

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap, True)
        A = TwoDimBlockCyclic("iS", 2 * n, n, n, n, P=2, Q=1, nodes=2,
                              myrank=rank)
        A.fill(lambda m, k: np.eye(n, dtype=np.float32) * (m + 1))
        tp = DTDTaskpool(ctx, "d2d-order")
        src, dst = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
        tp.insert_task(long_body, (src, RW), name="long")
        tp.insert_task(lambda y, x: x.clone(), (dst, RW), (src, READ),
                       name="take")
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=60)
        out = A.data_of(rank, 0).newest_copy().payload.cpu()
        ctx.fini()
        return out

    got = run_distributed(2, program, timeout=120)
    want = torch.eye(n)
    for _ in range(40):
        want = torch.tanh(want.cuda() @ torch.eye(n).cuda() * 1e-3).cpu()
    assert torch.equal(got[0], got[1]), "the consumer got another value"
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)


def _inplace_times_100(x):
    """A body that writes its tile IN PLACE (a torch tensor is mutable)."""
    return x.mul_(100.0)


@pytest.mark.cuda
def test_d2d_tile_written_in_place_after_the_send_on_the_card():
    """The send-boundary snapshot on CUDA tensors: rank 0 writes a tile
    (x3) on the card, ships that version to rank 1, then writes it again IN
    PLACE (x100) before rank 1's reader runs; rank 1 reads the version it
    was sent."""
    _need_card()
    import time
    dmap = _device_map(2, True)

    def program(rank, fabric):
        ctx = _mkctx(rank, fabric, dmap, True)
        A = TwoDimBlockCyclic("iI", 8, 4, 4, 4, P=2, Q=1, nodes=2,
                              myrank=rank)
        A.fill(lambda m, n: np.full((4, 4), 1.0, np.float32))
        if rank == 1:
            time.sleep(0.4)            # rank 0 runs ahead
        tp = DTDTaskpool(ctx, "d2d-inplace")
        src, dst = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
        tp.insert_task(lambda x: x * 3.0, (src, RW), name="w")
        tp.insert_task(lambda y, x: y + x, (dst, RW), (src, READ), name="r")
        tp.insert_task(_inplace_times_100, (src, RW), name="inplace")
        tp.wait(timeout=30); tp.close(); ctx.wait(timeout=30)
        out = float(_host(A.data_of(rank, 0).newest_copy().payload)[0, 0])
        ctx.fini()
        return out

    results = run_distributed(2, program, timeout=60)
    assert results == [300.0, 4.0], results
