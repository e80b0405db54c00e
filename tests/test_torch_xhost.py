"""The port's cross-process payload plane (``parsec_tpu_torch/comm/xhost.py``):
the reference's ``tests/test_xhost.py`` on the port. On the CPU the plane
moves CPU tensors through named shared-memory segments, so every case runs
here: the loopback offer/pull with its pin lifecycle, bf16 by name, the
dead-peer retirement, concurrent first offers, and the TCPCE's counted
fallbacks. The CUDA IPC half runs on the card
(``test_torch_tcp_distributed.py``'s ``cuda`` cases and
``test_torch_cuda.py``)."""

import threading

import pytest
import torch

from parsec_tpu_torch.comm.xhost import (ENV_LOCAL_DEVICE, XHostRef,
                                         XHostTransfer, local_device)


def test_local_device_is_the_bound_card_or_raises(monkeypatch):
    """A rank's binding is card i mod the card count; without a card it
    raises instead of binding the rank to the CPU."""
    monkeypatch.setenv(ENV_LOCAL_DEVICE, "3")
    if torch.cuda.is_available():
        assert local_device() == torch.device(
            "cuda", 3 % torch.cuda.device_count())
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            local_device()


@pytest.fixture(scope="module")
def xh():
    return XHostTransfer()


def test_offer_pull_loopback_and_pin_lifecycle(xh):
    x = torch.arange(64.0).reshape(8, 8)
    ref = xh.offer(x, dst=3)
    assert isinstance(ref, XHostRef)
    assert ref.shape == (8, 8) and ref.dtype == "float32"
    assert xh.pending() == 1                  # pinned until ACK
    got = xh.pull(ref)
    assert torch.equal(got, x)
    xh.retire(ref.uuid)
    assert xh.pending() == 0


def test_bfloat16_round_trip(xh):
    x = torch.full((4, 4), 2.5, dtype=torch.bfloat16)
    ref = xh.offer(x)
    assert ref.dtype == "bfloat16"            # the NAME, not raw words
    got = xh.pull(ref)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.full((4, 4), 2.5))
    xh.retire(ref.uuid)


def test_retire_peer_and_clear(xh):
    for dst in (1, 1, 2):
        xh.offer(torch.zeros((2, 2)), dst=dst)
    assert xh.pending() == 3
    xh.retire_peer(1)                         # dead peer: its pulls never come
    assert xh.pending() == 1
    xh.clear()
    assert xh.pending() == 0


def test_concurrent_first_offers_share_one_server():
    """Two threads race the first offers of a fresh plane: both refs name
    the SAME owner address and both are pullable."""
    fresh = XHostTransfer()
    refs = [None, None]
    barrier = threading.Barrier(2)

    def offerer(i):
        barrier.wait()
        refs[i] = fresh.offer(torch.full((4,), float(i + 1)))

    ts = [threading.Thread(target=offerer, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert refs[0] is not None and refs[1] is not None
    assert refs[0].uuid != refs[1].uuid
    assert refs[0].address == refs[1].address == fresh.address
    for i, ref in enumerate(refs):
        got = fresh.pull(ref)
        assert torch.equal(got, torch.full((4,), float(i + 1)))
        fresh.retire(ref.uuid)
    assert fresh.pending() == 0


def test_tcpce_flag_on_but_transfer_unavailable_warns_and_bounces(monkeypatch):
    """comm_device_mem=1 where the plane is unavailable must warn and leave
    the counted host-bounce path in place, not crash."""
    from parsec_tpu_torch.comm import tcp as tcp_mod
    from parsec_tpu_torch.comm.engine import CAP_ACCELERATOR_MEM
    from parsec_tpu_torch.utils import mca

    monkeypatch.setattr(tcp_mod.XHostTransfer, "available",
                        staticmethod(lambda: False))
    mca.set("comm_device_mem", True)
    try:
        ce = tcp_mod.TCPCE(0, 1, ("127.0.0.1", 0))   # single rank: no mesh
        assert ce._xhost is None and ce._xpull is None
        assert not (ce.capabilities & CAP_ACCELERATOR_MEM)
        ce.fini()
    finally:
        mca.params.unset("comm_device_mem")


def test_tcpce_pull_failure_attributes_peer_not_crash():
    """A rendezvous pull that raises (the producer crashed before the
    pull) is attributed as a dead peer — mirroring the BYE/EOF paths — not
    a crash of the progress driver."""
    from parsec_tpu_torch.comm import tcp as tcp_mod
    from parsec_tpu_torch.comm.engine import TAG_DSL_BASE

    ce = tcp_mod.TCPCE(0, 1, ("127.0.0.1", 0))   # single rank: no mesh
    try:
        class _BoomPull:
            def pull(self, ref):
                raise ConnectionRefusedError("owner gone")
        ce._xpull = _BoomPull()
        delivered = []
        ce.tag_register(TAG_DSL_BASE,
                        lambda _ce, src, hdr, pl: delivered.append(pl))
        ref = XHostRef(uuid=7, address="host:1", shape=(2,),
                       dtype="float32", kind="shm", handle="gone")
        ce._inbound.append((TAG_DSL_BASE, 3, {"h": 1}, ref))
        n = ce.progress()                         # must NOT raise
        assert n == 1
        assert 3 in ce.dead_peers                 # failure attributed
        assert delivered == []                    # message dead-lettered
    finally:
        ce.fini()
