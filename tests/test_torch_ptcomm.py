"""The port's native communication lane (``csrc/ptcomm.cpp``,
``parsec_tpu_torch/comm/native.py``): the reference's ``tests/test_ptcomm.py``
on the port.

Three layers, mirroring how the lane is built:

* **in-process protocol units** — two ``_ptcomm.Comm`` objects joined by
  a socketpair (or a shared-memory ring pair), pumped synchronously:
  the AM frame codec (including truncated / oversized / unknown-tag
  frames, which must be counted and contained, never hang the progress
  path), the eager/rendezvous data protocol, and the GIL-free ingest
  entry points of both native engines;
* **multi-rank parity** — the same randomized PTG programs as
  ``test_ptexec.py``, distributed over 2–3 REAL OS ranks with the native
  comm lane on vs off (interpreted ``remote_dep.py``): identical
  completion sets, payloads, and data versions, with engagement counters
  proving which path carried the run;
* **satellites** — the comm-thread idle backoff regression and the
  shared zero-copy payload codec.

Program functions live at module top level so a forkserver rank can
import them. Every multiprocess job holds the port's job lock; none takes
the reference package's, whose own jobs wait for it inside their time
limits.
"""

import functools
import math
import random
import socket
import struct
import time

import numpy as np
import pytest

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.comm.tcp import run_distributed_procs as _run_procs
from parsec_tpu_torch.utils import mca


def run_distributed_procs(*args, **kw):
    """The port's process launcher, which takes the port's job lock. The
    lock is not fair: a pause after each job lets a job waiting on it (it
    polls every 0.2 s) in before this file's next job."""
    import time

    try:
        return _run_procs(*args, **kw)
    finally:
        time.sleep(0.5)

_ptcomm = native_mod.load_ptcomm()
_ptexec = native_mod.load_ptexec()
_ptdtd = native_mod.load_ptdtd()

pytestmark = pytest.mark.skipif(
    _ptcomm is None or _ptexec is None or _ptdtd is None,
    reason="native extensions unavailable")

#: wire header layout (ptcomm.cpp WireHdr): body_len, kind, flags, src,
#: pool, arg, aux
_HDR = struct.Struct("<IBBHIIQ")
_HELLO_MAGIC = 0x7074636F6D6D0001
_K_HELLO, _K_ACTS, _K_DATA = 1, 2, 3


def _pair():
    """Two Comm endpoints joined by a socketpair, pumped synchronously."""
    a, b = socket.socketpair()
    c0 = _ptcomm.Comm(0, 2)
    c1 = _ptcomm.Comm(1, 2)
    c0.add_peer_fd(1, a.fileno())
    c1.add_peer_fd(0, b.fileno())
    return c0, c1, a, b


def _chain_graph(n, owners_rank, comm, pool):
    """A 2-rank alternating chain bound to ``comm`` as ``owners_rank``."""
    goals = [0] + [1] * (n - 1)
    off = list(range(n)) + [n - 1]
    succs = list(range(1, n))
    owners = [i % 2 for i in range(n)]
    g = _ptexec.Graph(goals, off, succs)
    g.comm_bind(comm.send_capsule(), pool, owners_rank, owners)
    comm.register_pool(pool, g, g.ingest_capsule())
    return g


# ------------------------------------------------------------ protocol units

def test_cross_rank_chain_over_socketpair():
    """The full C path in one process: release sweeps surface remote
    successors as activation frames, the peer ingests them GIL-free, and
    a strictly alternating chain completes on both 'ranks'."""
    c0, c1, a, b = _pair()
    done = {0: [], 1: []}
    graphs = {0: _chain_graph(10, 0, c0, 7), 1: _chain_graph(10, 1, c1, 7)}
    for _ in range(80):
        for rank, c in ((0, c0), (1, c1)):
            graphs[rank].run(lambda ids, r=rank: done[r].extend(ids), 256, 0)
            c.pump(2)
        if graphs[0].done() and graphs[1].done():
            break
    assert graphs[0].done() and graphs[1].done()
    assert done[0] == [0, 2, 4, 6, 8] and done[1] == [1, 3, 5, 7, 9]
    s0, s1 = c0.stats(), c1.stats()
    assert s0["frame_errors"] == s1["frame_errors"] == 0
    assert s0["acts_tx"] == 5 and s0["acts_rx"] == 4
    cs = graphs[0].comm_stats()
    assert cs["acts_tx"] == 5 and cs["acts_rx"] == 4 and cs["ingest_bad"] == 0
    c0.stop(); c1.stop()
    a.close(); b.close()


def test_frame_codec_malformed_frames_contained():
    """Truncated, oversized, and unknown-kind frames are counted and
    contained: an unknown kind is skipped by its (trusted) length, an
    oversized length poisons only that one link, a mid-frame EOF is a
    counted truncation — and the progress path keeps serving."""
    # -- unknown kind: skipped by length, traffic continues
    c1 = _ptcomm.Comm(1, 2)
    a, b = socket.socketpair()
    c1.add_peer_fd(0, b.fileno())
    g = _ptexec.Graph([1], [0, 0], [])        # one task, one remote dep
    g.comm_bind(c1.send_capsule(), 9, 1, [1])
    c1.register_pool(9, g, g.ingest_capsule())
    a.sendall(_HDR.pack(0, _K_HELLO, 0, 0, 0, 0, _HELLO_MAGIC))
    a.sendall(_HDR.pack(5, 77, 0, 0, 0, 0, 0) + b"junk!")   # unknown kind
    a.sendall(_HDR.pack(4, _K_ACTS, 0, 0, 9, 0, 0) +
              struct.pack("<i", 0))                          # then a real ACT
    time.sleep(0.05)
    c1.pump(4)
    s = c1.stats()
    assert s["frame_errors"] == 1
    assert s["acts_rx"] == 1 and g.comm_stats()["acts_rx"] == 1
    assert not s["broken_peers"]

    # -- bad ACT body length (not a multiple of 4): counted, link lives
    a.sendall(_HDR.pack(3, _K_ACTS, 0, 0, 9, 0, 0) + b"xyz")
    time.sleep(0.05)
    c1.pump(2)
    assert c1.stats()["frame_errors"] == 2
    assert not c1.stats()["broken_peers"]
    c1.stop(); a.close(); b.close()

    # -- oversized length: the link is unrecoverable, the process is not
    c1 = _ptcomm.Comm(1, 2)
    a, b = socket.socketpair()
    c1.add_peer_fd(0, b.fileno())
    a.sendall(_HDR.pack(0, _K_HELLO, 0, 0, 0, 0, _HELLO_MAGIC))
    a.sendall(_HDR.pack((1 << 26) + 1, _K_ACTS, 0, 0, 9, 0, 0))
    time.sleep(0.05)
    c1.pump(2)
    s = c1.stats()
    assert s["frame_errors"] == 1 and s["broken_peers"] == [0]
    c1.stop(); a.close(); b.close()

    # -- wrong HELLO magic: protocol mismatch, link poisoned immediately
    c1 = _ptcomm.Comm(1, 2)
    a, b = socket.socketpair()
    c1.add_peer_fd(0, b.fileno())
    a.sendall(_HDR.pack(0, _K_HELLO, 0, 0, 0, 0, 0xBAD))
    time.sleep(0.05)
    c1.pump(2)
    assert c1.stats()["broken_peers"] == [0]
    c1.stop(); a.close(); b.close()

    # -- truncated frame (EOF mid-frame): counted as an error
    c1 = _ptcomm.Comm(1, 2)
    a, b = socket.socketpair()
    c1.add_peer_fd(0, b.fileno())
    a.sendall(_HDR.pack(0, _K_HELLO, 0, 0, 0, 0, _HELLO_MAGIC))
    a.sendall(_HDR.pack(100, _K_DATA, 0, 0, 9, 0, 0) + b"only-ten")
    a.shutdown(socket.SHUT_WR)        # EOF mid-frame, reverse path alive
    time.sleep(0.05)
    c1.pump(2)
    s = c1.stats()
    assert s["frame_errors"] == 1 and s["broken_peers"] == [0]
    c1.stop(); a.close(); b.close()


def test_malformed_frames_do_not_hang_progress_thread():
    """Same malformed input against the LIVE progress thread: the thread
    survives (loops keep advancing) and healthy peers keep flowing."""
    c1 = _ptcomm.Comm(1, 3)
    bad_a, bad_b = socket.socketpair()
    good_a, good_b = socket.socketpair()
    c1.add_peer_fd(0, bad_b.fileno())
    c1.add_peer_fd(2, good_b.fileno())
    g = _ptexec.Graph([1], [0, 0], [])
    g.comm_bind(c1.send_capsule(), 4, 1, [1])
    c1.register_pool(4, g, g.ingest_capsule())
    c1.start()
    try:
        bad_a.sendall(_HDR.pack(0, _K_HELLO, 0, 0, 0, 0, _HELLO_MAGIC))
        bad_a.sendall(_HDR.pack(1 << 27, _K_ACTS, 0, 0, 4, 0, 0))
        good_a.sendall(_HDR.pack(0, _K_HELLO, 0, 2, 0, 0, _HELLO_MAGIC))
        good_a.sendall(_HDR.pack(4, _K_ACTS, 0, 2, 4, 0, 0) +
                       struct.pack("<i", 0))
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            s = c1.stats()
            if s["acts_rx"] == 1 and s["broken_peers"] == [0]:
                break
            time.sleep(0.005)
        s = c1.stats()
        assert s["acts_rx"] == 1, s          # healthy peer still served
        assert s["broken_peers"] == [0], s   # only the bad link died
        loops0 = c1.stats()["loops"]
        time.sleep(0.05)
        assert c1.stats()["loops"] > loops0  # the thread is alive
    finally:
        c1.stop()
        for s_ in (bad_a, bad_b, good_a, good_b):
            s_.close()


def test_early_frames_park_until_pool_registers():
    """Activations racing ahead of the consumer's pool registration park
    per pool and replay at register time (the AM analogue of
    remote_dep's _early_ams)."""
    c0, c1, a, b = _pair()
    c0.send_act(1, 12, 0)
    c0.pump(2)
    time.sleep(0.02)
    c1.pump(2)
    assert c1.stats()["early_parked"] == 1
    g = _ptexec.Graph([1], [0, 0], [])
    g.comm_bind(c1.send_capsule(), 12, 1, [1])
    c1.register_pool(12, g, g.ingest_capsule())   # replays the parked ACT
    assert g.comm_stats()["acts_rx"] == 1
    g.run(None, 256, 0)
    assert g.done()
    c0.stop(); c1.stop(); a.close(); b.close()


def test_rendezvous_gates_consumer_until_pull_lands():
    """An activation that beats its rendezvous payload parks the consumer
    in the engine (rdv_begin) and releases it when the pull lands —
    verified through the Python mirrors of the C entry points."""
    g = _ptexec.Graph([0, 1], [0, 1, 1], [1], None, [0, 0, 1], [0], [1, 0])
    comm = _ptcomm.Comm(1, 2)
    g.comm_bind(comm.send_capsule(), 1, 1, [0, 1])
    got = []
    g.rdv_begin(0)          # payload for slot 0 is mid-pull
    g.ingest(1)             # the activation arrives first
    assert g.comm_stats()["parked"] == 1
    g.run(lambda ids, retired: got.extend(ids), 256, 0)
    assert got == []        # gated: must not dispatch without its input
    g.rdv_land(0)
    assert g.comm_stats()["parked"] == 0
    g.run(lambda ids, retired: got.extend(ids), 256, 0)
    assert got == [1] and g.done()


def test_ingest_rejects_remote_owned_tid():
    """An in-range tid owned by ANOTHER rank is as untrusted as an
    out-of-range one: trusting it would locally execute a task this rank
    does not own and wedge done() accounting."""
    comm = _ptcomm.Comm(1, 2)
    g = _ptexec.Graph([1, 1], [0, 0, 0], [])
    g.comm_bind(comm.send_capsule(), 2, 1, [0, 1])   # tid 0 is rank 0's
    g.ingest(0)
    g.ingest(-3)
    g.ingest(99)
    cs = g.comm_stats()
    assert cs["ingest_bad"] == 3 and cs["acts_rx"] == 0
    g.ingest(1)                                      # the legitimate one
    assert g.comm_stats()["acts_rx"] == 1
    g.run(None, 256, 0)
    assert g.done()


def test_dtd_engine_ingest_entry():
    """The ptdtd ingest entry point: a remote dep-release drops straight
    into the engine; per-task-lane tasks surface through drain_ready,
    batch-lane tasks join the internal ready structure."""
    eng = _ptdtd.Engine()
    tile = eng.tile()
    tid, held = eng.insert((tile,), (0x3,))
    assert held == 1                      # the insertion guard
    eng.ingest(tid)                       # remote dep satisfied the guard
    nexec, surfaced = eng.drain_ready(256, 0)
    assert nexec == 0 and surfaced == (tid,)
    st = eng.comm_stats()
    assert st["acts_rx"] == 1 and st["ingest_bad"] == 0
    # bad ids from the wire are counted, never trusted
    eng.ingest(999)
    assert eng.comm_stats()["ingest_bad"] == 1

    # through the comm lane: a peer's activation frame reaches the engine
    c0, c1, a, b = _pair()
    tid2, _ = eng.insert((tile,), (0x3,))
    c1.register_pool(2, eng, eng.ingest_capsule())
    c0.send_act(1, 2, tid2)
    c0.pump(2)
    time.sleep(0.02)
    c1.pump(2)
    # tid2 had a WAR/WAW dep on tid (still live) plus the guard: one
    # ingest clears the guard; completing tid frees the rest
    assert eng.comm_stats()["acts_rx"] == 2
    c0.stop(); c1.stop(); a.close(); b.close()


def test_payload_eager_and_rendezvous_roundtrip():
    """send_payload picks eager under the limit and rendezvous above it;
    both deliver (meta, bytes) intact and release every pin."""
    c0, c1, a, b = _pair()
    # data frames route per pool: the consumer must have it registered
    g = _ptexec.Graph([0], [0, 0], [])
    g.comm_bind(c1.send_capsule(), 5, 1, [1])
    c1.register_pool(5, g, g.ingest_capsule())
    small = np.arange(16, dtype=np.int32)
    big = np.arange(100000, dtype=np.float32)
    assert c0.send_payload(1, 5, 0, b"s", memoryview(small), 4096) == "eager"
    assert c0.send_payload(1, 5, 1, b"b", memoryview(big), 4096) == "rdv"
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        c0.pump(2); c1.pump(2)
        if c1.payload_ready(5, 0) and c1.payload_ready(5, 1):
            break
        time.sleep(0.002)
    meta0, data0 = c1.take_payload(5, 0)
    meta1, data1 = c1.take_payload(5, 1)
    assert meta0 == b"s" and np.array_equal(
        np.frombuffer(data0, np.int32), small)
    assert meta1 == b"b" and np.array_equal(
        np.frombuffer(data1, np.float32), big)
    assert c0.pins_pending() == 0
    assert c0.reap() == 1                  # the served pin releases
    with pytest.raises(KeyError):
        c1.take_payload(5, 0)              # consumed: gone
    c0.stop(); c1.stop(); a.close(); b.close()


def test_comm_trace_events_round_trip():
    """EV_COMM_* points recorded by the progress path land in the
    rings, drain through the NativeTraceBridge into a per-rank
    ``ptcomm-w*`` PBP stream, and round-trip through trace_reader's
    dataframe and chrome-JSON exports."""
    import os
    import tempfile

    from parsec_tpu_torch.tools.trace_reader import (read_pbp, to_chrome_trace,
                                               to_dataframe)
    from parsec_tpu_torch.utils.native_trace import NativeTraceBridge
    from parsec_tpu_torch.utils.trace import Profiling

    c0, c1, a, b = _pair()
    prof = Profiling()
    bridge = NativeTraceBridge(prof)
    assert bridge.attach("ptcomm", c1)
    assert bridge.attach("ptcomm", c0)
    g = _ptexec.Graph([1, 1], [0, 0, 0], [])
    g.comm_bind(c1.send_capsule(), 3, 1, [1, 1])
    c1.register_pool(3, g, g.ingest_capsule())
    c0.send_act(1, 3, 0)
    c0.send_act(1, 3, 1)
    c0.send_payload(1, 3, 0, b"m",
                    memoryview(np.arange(4, dtype=np.int64)), 4096)
    for _ in range(5):
        c0.pump(2); c1.pump(2)
    assert c1.stats()["acts_rx"] == 2 and c1.stats()["data_rx"] == 1
    n = bridge.drain_all(wait=True)
    assert n >= 3, f"only {n} comm events landed"
    assert bridge.dropped() == 0
    path = os.path.join(tempfile.mkdtemp(), "comm.pbp")
    prof.dump(path)
    trace = read_pbp(path)
    assert any(s["name"].startswith("ptcomm-w") for s in trace.streams)
    df = to_dataframe(trace)
    names = set(df["name"])
    assert "ptcomm::act_rx" in names and "ptcomm::act_tx" in names, names
    assert "ptcomm::data_rx" in names, names
    chrome = to_chrome_trace(trace)
    assert any(e.get("name", "").startswith("ptcomm::")
               for e in chrome["traceEvents"])
    c0.stop(); c1.stop(); a.close(); b.close()


def test_ptcomm_counters_in_unified_registry():
    """ptcomm.* registers in the unified counter registry (the live_view
    default set): engagement LaneStats keys and the C-side wire counters
    both resolve."""
    from parsec_tpu_torch.utils.counters import counters, install_native_counters
    install_native_counters()
    for key in ("ptcomm.pools_engaged", "ptcomm.pools_fallback",
                "ptcomm.pools_ineligible", "ptcomm.lanes_up",
                "ptcomm.acts_tx", "ptcomm.acts_rx", "ptcomm.frame_errors"):
        v = counters.read(key)
        assert isinstance(v, (int, float)), key
    snap = counters.snapshot()
    assert "ptcomm.acts_rx" in snap


# ------------------------------------------------------- satellite: codec

def test_pack_unpack_bytes_fast_path():
    """CommEngine.pack/unpack: bytes-like payloads skip pickle entirely
    and unpack as a zero-copy view; everything else still pickles."""
    from parsec_tpu_torch.comm.engine import CommEngine
    ce = CommEngine()
    blob = b"x" * 1024
    packed = ce.pack(blob)
    assert not packed.startswith(b"\x80")      # no pickle frame
    out = ce.unpack(packed)
    assert isinstance(out, memoryview) and bytes(out) == blob
    # pickled fallback unchanged
    obj = {"a": [1, 2, 3]}
    assert ce.unpack(ce.pack(obj)) == obj


def test_encode_payload_zero_copy_split():
    """The shared codec: a CPU tensor ships a memoryview over the SOURCE
    buffer (no serialization copy) and decode_raw rebuilds a zero-copy
    view; bf16 rides as raw 2-byte words under its dtype tag; payloads
    that are not tensors stay inline."""
    import torch

    from parsec_tpu_torch.comm.engine import CommEngine
    a = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    meta, raw, inline = CommEngine.encode_payload(a)
    assert inline is None and meta == ((3, 4), "float64")
    back = CommEngine.decode_raw(meta, raw)
    assert back.data_ptr() == a.data_ptr()     # zero copies end to end
    assert torch.equal(back, a)
    h = torch.full((2, 3), 2.5, dtype=torch.bfloat16)
    meta_h, raw_h, _ = CommEngine.encode_payload(h)
    assert meta_h == ((2, 3), "bfloat16") and raw_h.nbytes == 12
    assert torch.equal(CommEngine.decode_raw(meta_h, bytes(raw_h)), h)
    obj = [{1: 2}]
    meta2, raw2, inline2 = CommEngine.encode_payload(obj)
    assert raw2 is None and inline2 is obj


# ------------------------------------------- satellite: comm idle backoff

def test_comm_thread_idle_backoff():
    """An idle multi-rank comm thread must park, not poll at the fixed
    50µs cadence (~20k iterations/s): after a second of silence the loop
    count stays far below the old cadence."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadFabric, ThreadsCE
    from parsec_tpu_torch.core.context import Context

    fabric = ThreadFabric(2)
    ctx = Context(nb_cores=1, device="cpu", my_rank=0, nb_ranks=2)
    rde = RemoteDepEngine(ctx, ThreadsCE(fabric, 0))
    mca.set("comm_thread", True)
    try:
        rde.enable()
        time.sleep(0.2)                     # settle into the parked regime
        before = rde._comm_polls
        time.sleep(1.0)
        idle_polls = rde._comm_polls - before
        # old behavior: ~20000; parked: ~50/s (20ms caps) plus slack
        assert idle_polls < 2000, f"comm thread still spinning: {idle_polls}"
    finally:
        mca.params.unset("comm_thread")
        rde.fini()
        ctx.fini()


# ----------------------------------------------- multi-rank parity harness

def _force_cpu():
    """The ranks run on the CPU (every context below asks for it)."""


def _mkctx(rank, ce):
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.core.context import Context
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    return ctx


_CHAIN_SRC = """%global NT
%global DEPTH
%global descA
%global rec
T(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(l, i)
  CTL S <- (l > 0) ? S T(i, l-1)
        -> (l < DEPTH-1) ? S T(i, l+1)
BODY
  rec(('T', i, l))
END
"""


def _chain_program(rank, ce, native=True, nt=6, depth=8, off_ranks=()):
    """NT chains of DEPTH levels, level l owned by rank l % nb_ranks —
    every chain edge crosses ranks. ``wall``: the rank's seconds from its
    mesh standing to its chain's end (the lane bootstrap included, the
    process start and the job lock's queue not)."""
    _force_cpu()
    t0 = time.monotonic()
    if not native or rank in off_ranks:
        mca.set("comm_native", False)
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    ctx = _mkctx(rank, ce)
    A = TwoDimBlockCyclic("descA", depth, nt, 1, 1, P=ce.nb_ranks, Q=1,
                          nodes=ce.nb_ranks, myrank=rank)
    order = []
    prog = compile_ptg(_CHAIN_SRC, "ptcomm-chain")
    tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth,
                                        "rec": order.append},
                          collections={"descA": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=90)
    engaged = tp._ptexec_state is not None and \
        tp._ptexec_state.get("pool_id") is not None
    stats = ctx.comm.native.comm.stats() if ctx.comm.native else None
    cs = tp._ptexec_state["graph"].comm_stats() if engaged else None
    ce.sync()
    ctx.fini()
    ce.fini()
    if stats is not None:
        stats = {k: v for k, v in stats.items() if k != "broken_peers"} | \
            {"broken_peers": list(stats["broken_peers"])}
    return {"order": order, "engaged": engaged, "stats": stats, "cs": cs,
            "wall": time.monotonic() - t0}


@pytest.mark.parametrize("nranks", [2, 3])
def test_chain_parity_native_vs_interpreted(nranks):
    """The multi-rank chain with the native lane on vs off: identical
    per-rank completion sets, local release-edge order respected, and the
    engagement counters prove the native run rode the lane (every
    cross-rank edge an activation frame, zero frame errors) while the
    interpreted run never built one."""
    nt, depth = 4, 6
    on = run_distributed_procs(nranks, functools.partial(
        _chain_program, nt=nt, depth=depth), timeout=180)
    off = run_distributed_procs(nranks, functools.partial(
        _chain_program, native=False, nt=nt, depth=depth), timeout=180)
    expected = {("T", i, l) for i in range(nt) for l in range(depth)}
    for res in (on, off):
        allt = [t for r in res for t in r["order"]]
        assert len(allt) == len(expected) and set(allt) == expected
        for r in res:
            pos = {t: k for k, t in enumerate(r["order"])}
            for (_, i, l) in r["order"]:
                later = ("T", i, l + nranks)
                if later in pos:        # next LOCAL task of the chain
                    assert pos[("T", i, l)] < pos[later]
    for rank, r in enumerate(on):
        assert r["engaged"], f"rank {rank} fell off the native lane"
        assert r["stats"]["frame_errors"] == 0
        assert r["stats"]["broken_peers"] == []
        # every local task except the terminal level releases one remote
        # successor; every non-seed local task ingested one activation
        n_local = r["cs"]["n_local"]
        assert r["cs"]["acts_tx"] > 0 and r["cs"]["acts_rx"] > 0
        assert r["cs"]["ingest_bad"] == 0
        assert r["stats"]["acts_rx"] == r["cs"]["acts_rx"]
        assert n_local == sum(1 for i in range(nt) for l in range(depth)
                              if l % nranks == rank)
    for r in off:
        assert not r["engaged"] and r["stats"] is None


_RND_DATA_SRC = """%global N
%global D
%global A
%global B
%global C
%global E
%global M
%global IA
%global IC
%global descX
%global descY
%global descM
SRC(i)
  i = 0 .. N-1
  : descX(0, i)
  RW X <- descX(0, i)
       -> X T(((A*i+B) % N), 0)
BODY
  X = X + 1.0
END

T(i, l)
  i = 0 .. N-1
  l = 0 .. D-1
  priority = i + 3*l
  : descM(l, i)
  RW X <- (l == 0) ? X SRC(((IA*(i-B)) % N)) : X T(i, l-1)
       -> (l < D-1) ? X T(i, l+1) : descY(0, i)
       -> (l < D-1 and i % M == 0) ? Y T(((C*i+E) % N), l+1)
  READ Y <- (l > 0 and ((IC*(i-E)) % N) % M == 0) ? X T(((IC*(i-E)) % N), l-1)
BODY
  X = (X * 2.0 + 1.0) if Y is None else (X * 2.0 + Y)
END
"""


def _rand_shape(seed):
    rng = random.Random(seed)
    N = rng.choice([8, 12, 16])
    D = rng.randrange(3, 6)
    coprimes = [c for c in range(1, N) if math.gcd(c, N) == 1]
    A, C = rng.choice(coprimes), rng.choice(coprimes)
    B, E = rng.randrange(N), rng.randrange(N)
    M = rng.randrange(2, 5)
    return dict(N=N, D=D, A=A, B=B, C=C, E=E, M=M,
                IA=pow(A, -1, N), IC=pow(C, -1, N))


def _expected_data_values(p, init):
    """Pure-numpy replay of _RND_DATA_SRC (exact in f32: small ints)."""
    N, D, M = p["N"], p["D"], p["M"]
    IA, IC, B, E = p["IA"], p["IC"], p["B"], p["E"]
    xs = [init[i] + 1.0 for i in range(N)]
    x = [[0.0] * D for _ in range(N)]
    for l in range(D):
        for i in range(N):
            xin = xs[(IA * (i - B)) % N] if l == 0 else x[i][l - 1]
            j = (IC * (i - E)) % N
            y = x[j][l - 1] if (l > 0 and j % M == 0) else None
            x[i][l] = xin * 2.0 + 1.0 if y is None else xin * 2.0 + y
    return [x[i][D - 1] for i in range(N)]


def _data_program(rank, ce, params=None, native=True, eager_limit=None,
                  nb_cores=1):
    """Randomized DATA-flow DAG (RW chains, guarded cross-chain READ,
    priorities, memory reads + write-backs) with level l of T owned by
    rank l % nb_ranks; SRC pinned to rank 0. Returns per-rank results."""
    _force_cpu()
    if not native:
        mca.set("comm_native", False)
    if eager_limit is not None:
        mca.set("comm_native_eager_limit", eager_limit)
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TiledMatrix, TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    ctx = Context(nb_cores=nb_cores, device="cpu", my_rank=rank,
                  nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    n, d = params["N"], params["D"]
    X = TiledMatrix("descX", 1, n, 1, 1)
    X.fill(lambda m, i: np.full((1, 1), float(i), np.float32))
    Y = TiledMatrix("descY", 1, n, 1, 1)
    M = TwoDimBlockCyclic("descM", d, n, 1, 1, P=ce.nb_ranks, Q=1,
                          nodes=ce.nb_ranks, myrank=rank)
    prog = compile_ptg(_RND_DATA_SRC, "ptcomm-data")
    tp = prog.instantiate(ctx, globals=dict(params),
                          collections={"descX": X, "descY": Y, "descM": M})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    engaged = tp._ptexec_state is not None and \
        tp._ptexec_state.get("pool_id") is not None
    lane_stats = None
    if ctx.comm.native is not None:
        s = ctx.comm.native.comm.stats()
        lane_stats = {k: v for k, v in s.items() if k != "broken_peers"}
    finals = {}
    versions = {}
    for i in range(n):
        dref = Y.data_of(0, i)
        c = dref.get_copy(0)
        # data_of lazily mints a version-0 zero copy; only write-backs
        # bump the version, so version > 0 == "this rank produced it"
        if c is not None and c.payload is not None and dref.version > 0:
            finals[i] = float(np.asarray(c.payload)[0, 0])
            versions[i] = dref.version
    executed = sum(s.nb_executed for s in ctx.streams)
    ce.sync()
    ctx.fini()
    ce.fini()
    return {"engaged": engaged, "finals": finals, "versions": versions,
            "executed": executed, "stats": lane_stats}


@pytest.mark.parametrize("seed", [0, 1])
def test_data_dag_parity_native_vs_interpreted(seed):
    """Randomized multi-rank DATA DAG, native comm lane on vs off:
    identical per-rank completion counts, write-back payloads, and data
    versions — and the native run matches the exact numpy replay."""
    params = _rand_shape(seed)
    on = run_distributed_procs(2, functools.partial(
        _data_program, params=params), timeout=240)
    off = run_distributed_procs(2, functools.partial(
        _data_program, params=params, native=False), timeout=240)
    n, d = params["N"], params["D"]
    for rank in range(2):
        assert on[rank]["engaged"], f"rank {rank} fell off the lane"
        assert not off[rank]["engaged"]
        assert on[rank]["executed"] == off[rank]["executed"]
        assert on[rank]["finals"] == off[rank]["finals"]
        assert on[rank]["versions"] == off[rank]["versions"]
        assert on[rank]["stats"]["frame_errors"] == 0
    # every write-back landed exactly once, on the terminal level's rank
    merged = {}
    for r in on:
        merged.update(r["finals"])
    assert len(merged) == n
    expect = _expected_data_values(params, [float(i) for i in range(n)])
    assert [merged[i] for i in range(n)] == pytest.approx(expect, rel=0,
                                                          abs=0)
    assert sum(r["executed"] for r in on) == n + n * d


def test_data_dag_parity_multiworker():
    """nb_cores=2 per rank: concurrent batched dispatches can race on a
    shared remote input slot — results must still match the exact numpy
    replay (the serialized take_payload path)."""
    params = _rand_shape(0)
    res = run_distributed_procs(2, functools.partial(
        _data_program, params=params, nb_cores=2), timeout=240)
    merged = {}
    for r in res:
        assert r["engaged"]
        assert r["stats"]["frame_errors"] == 0
        merged.update(r["finals"])
    n = params["N"]
    expect = _expected_data_values(params, [float(i) for i in range(n)])
    assert [merged[i] for i in range(n)] == pytest.approx(expect, rel=0,
                                                          abs=0)


def test_data_dag_rendezvous_path():
    """A tiny eager limit forces every cross-rank payload through the
    rendezvous GET protocol; results stay exact and every pin retires."""
    params = dict(N=6, D=4, A=1, B=0, C=1, E=0, M=2, IA=1, IC=1)
    res = run_distributed_procs(2, functools.partial(
        _data_program, params=params, eager_limit=1), timeout=240)
    merged = {}
    for r in res:
        assert r["engaged"]
        assert r["stats"]["frame_errors"] == 0
        merged.update(r["finals"])
    assert sum(r["stats"]["rdv_tx"] for r in res) > 0, \
        "nothing took the rendezvous path"
    expect = _expected_data_values(params,
                                   [float(i) for i in range(params["N"])])
    assert [merged[i] for i in range(params["N"])] == pytest.approx(
        expect, rel=0, abs=0)


def test_asymmetric_decline_falls_back_fast():
    """One rank declining the lane (--mca comm_native 0) must not hang
    its peers to the bootstrap timeout: the decline hello aborts every
    bootstrap promptly and BOTH ranks fall back to the interpreted path
    with identical results. The time is each rank's own, from its mesh to
    its chain's end: the queue behind the host-wide job lock is no part of
    a bootstrap."""
    nt, depth = 2, 4
    res = run_distributed_procs(2, functools.partial(
        _chain_program, nt=nt, depth=depth, off_ranks=(1,)), timeout=120)
    elapsed = max(r["wall"] for r in res)
    for r in res:
        assert not r["engaged"]
        assert r["stats"] is None          # no lane was built anywhere
    allt = [t for r in res for t in r["order"]]
    assert set(allt) == {("T", i, l) for i in range(nt)
                         for l in range(depth)}
    assert elapsed < 30, \
        f"asymmetric decline took {elapsed:.0f}s (bootstrap-timeout hang?)"


def _threads_fallback_program(rank, fabric):
    """In-process fabric: the native lane must decline (no peer sockets)
    and the distributed pool must fall back to the interpreted path,
    still correct."""
    from parsec_tpu_torch.comm.threads import ThreadsCE
    ce = ThreadsCE(fabric, rank)
    ctx = _mkctx(rank, ce)
    assert ctx.comm.native is None
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    A = TwoDimBlockCyclic("descA", 4, 2, 1, 1, P=2, Q=1, nodes=2,
                          myrank=rank)
    order = []
    prog = compile_ptg(_CHAIN_SRC, "threads-chain")
    tp = prog.instantiate(ctx, globals={"NT": 2, "DEPTH": 4,
                                        "rec": order.append},
                          collections={"descA": A})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    assert tp._ptexec_state is None
    ce.sync()
    ctx.fini()
    return order


def test_threads_fabric_declines_lane_and_falls_back():
    from parsec_tpu_torch.comm.threads import run_distributed
    res = run_distributed(2, _threads_fallback_program, timeout=90)
    allt = [t for r in res for t in r]
    assert set(allt) == {("T", i, l) for i in range(2) for l in range(4)}
