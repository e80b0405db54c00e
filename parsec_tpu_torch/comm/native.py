"""Native communication lane (ptcomm): the Python half of L3-in-C.

``csrc/ptcomm.cpp`` owns the cross-rank hot path — a funneled C
progress thread multiplexing the mesh (TCP sockets handed over as fds,
same-host shared-memory rings for co-located ranks), a fixed binary AM
protocol (activation / eager-data / rendezvous GET frames; no pickle),
and GIL-free ingest straight into the native engines' ready structures
(``ptcomm_iface.h``). This module is everything around it:

* **bootstrap** — a secondary mesh negotiated over the EXISTING comm
  engine's AM plane (``TAG_PTCOMM_BOOT``): every rank advertises
  availability + a host token + a listener address; co-located pairs get
  a shared-memory ring pair (created by the lower rank), remote pairs a
  dedicated TCP connection (dialed by the higher rank). The exchange
  ends with an all-ranks ``up`` confirmation so the lane engages
  EVERYWHERE or NOWHERE — an asymmetric decision would strand frames;
* **pool registry** — rank-consistent pool ids (pools must be
  instantiated in the same order on every rank, the invariant
  ``remote_dep.register_taskpool`` already imposes on names);
* **payload codec** — binary meta (dtype tag/shape) over the shared
  :meth:`CommEngine.encode_payload` split (a tensor's host bytes, bf16 as
  raw 2-byte words; a CUDA tensor materializes host bytes here, after its
  ready event); payloads that are not tensors pickle, counted;
* **lifecycle** — rendezvous Py_buffer pins are released via ``reap()``
  from the runtime's drain hooks (the progress thread cannot DECREF),
  and fini tears the thread + shm segments down.

The lane is the FAST path, not the only path: ``remote_dep.py`` stays
as the fallback/paranoid route, and pools that are ineligible for the
native execution lane (typed datatypes/reshapes, DTD audit, capture,
multi-chore bodies) keep using it — counted in ``PTCOMM_STATS`` so a
silent fallback is a CI failure, not a mystery slowdown.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..utils import mca, output
from ..utils.counters import LaneStats
from .engine import CommEngine, TAG_PTCOMM_BOOT

mca.register("comm_native", True,
             "Drive cross-rank activations and data through the native "
             "communication lane (csrc/ptcomm.cpp): funneled C "
             "progress thread, binary AM frames, GIL-free ingest into "
             "the native engines. Ineligible transports/pools fall back "
             "to the interpreted remote_dep.py path (counted)",
             type=bool)
mca.register("comm_native_shm", True,
             "Short-circuit co-located ranks through shared-memory rings "
             "instead of loopback TCP", type=bool)
mca.register("comm_native_eager_limit", 65536,
             "Native-lane payloads up to this many bytes ride inline in "
             "the eager DATA frame; larger ones rendezvous (receiver-"
             "pulled GET)", type=int)
mca.register("comm_native_ring_bytes", 1 << 22,
             "Per-direction shared-memory ring capacity (bytes)", type=int)
mca.register("comm_native_boot_timeout", 45.0,
             "Seconds to wait for every rank to join the native comm "
             "lane bootstrap before falling back to the interpreted "
             "path", type=float)

#: lane engagement accounting, same template as PTEXEC_STATS /
#: PTDTD_STATS (LaneStats snapshot()/delta()): ``pools_engaged``/
#: ``tasks_engaged`` prove the lane carried a
#: run; ``pools_ineligible`` counts by-design fallbacks (DTD pools,
#: typed datatypes, audit/capture, non-TCP transports);
#: ``pools_fallback`` counts pools that were ELIGIBLE yet declined
#: (flatten refusal, lane missing) — the silent-regression signal.
PTCOMM_STATS = LaneStats(lanes_up=0, pools_engaged=0, tasks_engaged=0,
                         pools_fallback=0, pools_ineligible=0,
                         payloads_tx=0, payloads_pickled=0)

#: live lanes, for the process-wide ``ptcomm.*`` counter samplers
_lanes: "weakref.WeakSet[NativeCommLane]" = weakref.WeakSet()

#: C-side counters exported into the unified registry (ptcomm.<name>)
COMM_COUNTER_KEYS = ("acts_tx", "acts_rx", "data_tx", "data_rx", "rdv_tx",
                     "rdv_rx", "bytes_tx", "bytes_rx", "frame_errors",
                     "early_parked", "dropped_sends")


def comm_counter_sampler(key: str):
    """Sampler summing one C-side counter across every live lane (the
    short-TTL snapshot means one registry sweep costs one stats() call
    per lane, not one per counter key)."""
    def sample():
        total = 0
        for lane in list(_lanes):
            try:
                total += lane.stats_cached()[key]
            except Exception:  # noqa: BLE001 - a torn-down lane samples 0
                pass
        return total
    return sample


# --------------------------------------------------------------- wire meta
#: payload meta layout: u8 kind (0 = raw tensor, 1 = pickle), u8 len(dtype
#: tag), u8 ndim, dtype tag bytes, ndim * i64 dims. Binary — the data
#: frames carry no pickle unless the payload is not a tensor.
_META_RAW = 0
_META_PICKLE = 1


def encode_payload(payload) -> Tuple[bytes, Any]:
    """(meta, buffer) for a native-lane data frame. A tensor ships its
    host bytes (the C side copies once into the frame / pins the buffer
    for rendezvous); anything else pickles, counted."""
    meta_t, raw, inline = CommEngine.encode_payload(payload)
    if raw is not None:
        shape, dtype_str = meta_t
        ds = dtype_str.encode()
        meta = struct.pack("<BBB", _META_RAW, len(ds), len(shape)) + ds + \
            struct.pack(f"<{len(shape)}q", *shape)
        return meta, raw
    PTCOMM_STATS["payloads_pickled"] += 1
    return struct.pack("<BBB", _META_PICKLE, 0, 0), \
        pickle.dumps(inline, protocol=5)


def decode_payload(meta: bytes, data) -> Any:
    """Inverse of :func:`encode_payload`: a CPU tensor over the frame's
    bytes."""
    kind, dlen, ndim = struct.unpack_from("<BBB", meta, 0)
    if kind == _META_PICKLE:
        return pickle.loads(data)
    ds = meta[3:3 + dlen].decode()
    shape = struct.unpack_from(f"<{ndim}q", meta, 3 + dlen)
    return CommEngine.decode_raw((shape, ds), data)


# ------------------------------------------------------------- shm helpers

def _make_ring(size: int):
    """Create + header-init one shared-memory ring (the C side maps it by
    name; layout documented in ptcomm.cpp)."""
    from multiprocessing import shared_memory
    from .. import native as native_mod
    mod = native_mod.load_ptcomm()
    shm = shared_memory.SharedMemory(create=True,
                                     size=mod.SHM_DATA_OFF + size)
    struct.pack_into("<II", shm.buf, 0, mod.SHM_MAGIC, size)
    struct.pack_into("<Q", shm.buf, 64, 0)
    struct.pack_into("<Q", shm.buf, 128, 0)
    return shm


def _host_token() -> str:
    """Co-location token: ranks sharing it talk through shm. Hostname
    plus the boot id separates containers that share a hostname but not
    /dev/shm."""
    boot = ""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        pass
    return f"{socket.gethostname()}|{boot}"


class NativeCommLane:
    """One rank's native comm lane: the C ``Comm`` object plus bootstrap,
    pool registry, and lifecycle. Built by ``RemoteDepEngine`` at
    construction when every rank can join (see :meth:`available`)."""

    @staticmethod
    def available(ce) -> Optional[str]:
        """None when the lane can engage on this transport, else the
        reason it cannot (ineligible-by-design, counted by the caller)."""
        if ce.nb_ranks < 2:
            return "single rank"
        if not mca.get("comm_native", True):
            return "disabled by --mca comm_native 0"
        peers = getattr(ce, "_peers", None)
        if not isinstance(peers, dict) or not all(
                hasattr(s, "fileno") for s in peers.values()):
            return "transport has no peer sockets (in-process fabric)"
        from .. import native as native_mod
        if native_mod.load_ptcomm() is None or \
                native_mod.load_ptexec() is None:
            return "native modules unavailable"
        return None

    def __init__(self, rde, ce, timeout: Optional[float] = None) -> None:
        self.rde = rde
        self.ce = ce
        self.ctx = rde.ctx
        from .. import native as native_mod
        self._mod = native_mod.load_ptcomm()
        self.comm = self._mod.Comm(ce.my_rank, ce.nb_ranks)
        self._segments: List = []          # SharedMemory I created
        self._pools: Dict[int, Any] = {}   # pool_id -> engine object
        self._stats_cache = (0.0, None)    # (stamp, snapshot) for samplers
        self._up = False
        timeout = timeout if timeout is not None else \
            mca.get("comm_native_boot_timeout", 45.0)
        try:
            self._bootstrap(timeout)
        except Exception:
            self._teardown_segments()
            raise
        self.comm.start()
        self._up = True
        PTCOMM_STATS["lanes_up"] += 1
        _lanes.add(self)
        # rendezvous pins release under the GIL from the hot loops
        self.ctx.register_drain_hook(self.reap)
        output.debug_verbose(1, "ptcomm",
                             f"native comm lane up on rank {ce.my_rank} "
                             f"({ce.nb_ranks} ranks)")

    # ------------------------------------------------------------ bootstrap
    def _bootstrap(self, timeout: float) -> None:
        """Build the secondary mesh. Control messages ride the existing
        CE AM plane (TAG_PTCOMM_BOOT, parked into ``rde._ptcomm_box`` by
        the handler registered at RemoteDepEngine construction)."""
        ce, me = self.ce, self.ce.my_rank
        deadline = time.monotonic() + timeout
        box = self.rde._ptcomm_box
        token = _host_token()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(ce.nb_ranks)
        listener.settimeout(0.05)
        port = listener.getsockname()[1]
        try:
            self._bootstrap_inner(deadline, box, token, listener, port)
        finally:
            listener.close()

    def _pump(self, deadline: float, what: str, cond) -> None:
        while not cond():
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ptcomm bootstrap: timed out waiting for {what}")
            self.ce.progress()
            time.sleep(2e-4)

    def _bootstrap_inner(self, deadline, box, token, listener, port) -> None:
        ce, me = self.ce, self.ce.my_rank
        peers = [r for r in range(ce.nb_ranks) if r != me]
        use_shm = mca.get("comm_native_shm", True)
        for r in peers:
            ce.send_am(TAG_PTCOMM_BOOT, r,
                       {"k": "hello", "avail": True, "host": token,
                        "port": port, "shm_ok": use_shm}, None)

        def hello_of(r):
            hs = [h for h in box.get(r, []) if h.get("k") == "hello"]
            for h in hs:
                if not h.get("avail"):
                    return h   # a decline outranks an earlier offer (the
                               # peer may have failed mid-bootstrap)
            return hs[0] if hs else None

        self._pump(deadline, "peer hellos",
                   lambda: all(hello_of(r) is not None for r in peers))
        hellos = {r: hello_of(r) for r in peers}
        if not all(h["avail"] for h in hellos.values()):
            bad = [r for r, h in hellos.items() if not h["avail"]]
            raise RuntimeError(f"ranks {bad} cannot join the native lane")

        ring_bytes = mca.get("comm_native_ring_bytes", 1 << 22)
        shm_wait = []
        dial = []
        accept_from = set()
        for r in peers:
            co = use_shm and hellos[r].get("shm_ok") and \
                hellos[r]["host"] == token
            if co:
                if me < r:
                    # lower rank creates the ring pair and advertises it
                    a, b = _make_ring(ring_bytes), _make_ring(ring_bytes)
                    self._segments += [a, b]
                    self.comm.add_peer_shm(r, "/" + a.name, "/" + b.name)
                    ce.send_am(TAG_PTCOMM_BOOT, r,
                               {"k": "shm", "tx": "/" + b.name,
                                "rx": "/" + a.name}, None)
                else:
                    shm_wait.append(r)
            else:
                # cross-host (or shm off): dedicated TCP link, dialed by
                # the higher rank toward the lower rank's listener; the
                # reachable address comes from the existing mesh socket
                if me > r:
                    ip = ce._peers[r].getpeername()[0]
                    dial.append((r, (ip, hellos[r]["port"])))
                else:
                    accept_from.add(r)

        def shm_of(r):
            for h in box.get(r, []):
                if h.get("k") == "shm":
                    return h
            return None

        def check_declines():
            # a peer that failed MID-bootstrap (after its avail=True
            # hello) broadcasts a decline; abort promptly instead of
            # waiting for its links until the timeout
            bad = [r for r in peers
                   if any(h.get("k") == "hello" and not h.get("avail")
                          for h in box.get(r, []))]
            if bad:
                raise RuntimeError(
                    f"ranks {bad} left the native lane bootstrap")

        pending_dial = dict(dial)
        while shm_wait or pending_dial or accept_from:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ptcomm bootstrap: links outstanding (shm={shm_wait}, "
                    f"dial={list(pending_dial)}, accept={accept_from})")
            check_declines()
            self.ce.progress()
            for r in list(shm_wait):
                h = shm_of(r)
                if h is not None:
                    self.comm.add_peer_shm(r, h["tx"], h["rx"])
                    shm_wait.remove(r)
            for r, addr in list(pending_dial.items()):
                try:
                    s = socket.create_connection(addr, timeout=0.2)
                except OSError:
                    continue
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.sendall(struct.pack("<I", me))
                self.comm.add_peer_fd(r, s.fileno())
                s.close()                      # the C side holds a dup
                del pending_dial[r]
            if accept_from:
                try:
                    conn, _ = listener.accept()
                except OSError:
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                try:
                    who = struct.unpack(
                        "<I", self._recv_exact(conn, 4))[0]
                except OSError:
                    conn.close()
                    continue
                if who in accept_from:
                    self.comm.add_peer_fd(who, conn.fileno())
                    accept_from.discard(who)
                conn.close()

        # all-or-nothing confirmation: the lane engages only once every
        # rank reports its links up — an asymmetric engage would strand
        # activation frames on a pool the peer never registers
        for r in peers:
            ce.send_am(TAG_PTCOMM_BOOT, r, {"k": "up", "ok": True}, None)

        def up_of(r):
            return any(h.get("k") == "up" and h.get("ok")
                       for h in box.get(r, []))

        while not all(up_of(r) for r in peers):
            if time.monotonic() >= deadline:
                raise TimeoutError("ptcomm bootstrap: timed out waiting "
                                   "for the all-ranks up confirmation")
            check_declines()
            self.ce.progress()
            time.sleep(2e-4)

    @staticmethod
    def _recv_exact(conn, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise OSError("EOF during ptcomm link handshake")
            buf += chunk
        return buf

    # --------------------------------------------------------- pool registry
    @staticmethod
    def pool_id_for(name: str) -> int:
        """Rank-consistent pool ids derived from the TASKPOOL NAME (which
        remote_dep already requires to be unique among live distributed
        pools and identical across ranks) — a per-rank counter would
        silently desynchronize the id spaces after any rank-local lane
        refusal, routing one pool's frames into another's graph."""
        import zlib
        return zlib.crc32(name.encode()) & 0x7FFFFFFF

    def register_engine(self, pool_id: int, engine) -> None:
        """Route ``pool_id``'s frames into ``engine`` (a ptexec Graph or
        ptdtd Engine); frames that raced ahead replay immediately. A
        stale registration under the same id (a TERMINATED same-name pool
        that owned zero local tasks, so no finalize ever unregistered it)
        is replaced — truly-live name collisions were already fatal'd by
        remote_dep.register_taskpool before this point."""
        try:
            self.comm.register_pool(pool_id, engine,
                                    engine.ingest_capsule())
        except ValueError:
            self.comm.unregister_pool(pool_id)
            self.comm.register_pool(pool_id, engine,
                                    engine.ingest_capsule())
        self._pools[pool_id] = engine

    def unregister_engine(self, pool_id: int) -> None:
        self.comm.unregister_pool(pool_id)
        self._pools.pop(pool_id, None)
        self.reap()

    # ------------------------------------------------------------- data path
    def send_payload(self, dst: int, pool_id: int, slot: int,
                     payload) -> str:
        """Ship one produced slot payload to ``dst`` (eager under the
        limit, rendezvous above it). Returns the mode used."""
        meta, buf = encode_payload(payload)
        PTCOMM_STATS["payloads_tx"] += 1
        return self.comm.send_payload(
            dst, pool_id, slot, meta, buf,
            mca.get("comm_native_eager_limit", 65536))

    def take_payload(self, pool_id: int, slot: int):
        """Materialize an arrived payload (consumes the C-side buffer)."""
        meta, data = self.comm.take_payload(pool_id, slot)
        return decode_payload(meta, data)

    def reap(self) -> None:
        """Release rendezvous Py_buffer pins whose replies streamed out
        (registered as a context drain hook; the progress thread cannot
        DECREF)."""
        try:
            self.comm.reap()
        except Exception:  # noqa: BLE001 - teardown races are benign
            pass

    # -------------------------------------------------------------- teardown
    def _teardown_segments(self) -> None:
        for shm in self._segments:
            try:
                shm.close()
                shm.unlink()
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
        self._segments = []

    def fini(self, flush_timeout: float = 10.0) -> None:
        if not self._up:
            return
        self._up = False
        # a rank whose pools completed may still owe peers bytes: queued
        # frames not yet on a wire, and rendezvous pins a slower consumer
        # has not pulled. Stopping before they drain would strand the
        # peer's parked tasks — wait (bounded; a dead peer times out and
        # is reported by the primary mesh's failure detection).
        deadline = time.monotonic() + flush_timeout
        while time.monotonic() < deadline:
            s = self.comm.stats()
            if not s["out_pending"] and not self.comm.pins_pending():
                break
            self.reap()
            time.sleep(1e-3)
        for pool_id in list(self._pools):
            try:
                self.comm.unregister_pool(pool_id)
            except Exception:  # noqa: BLE001
                pass
        self._pools.clear()
        try:
            self.ctx._ntrace_detach(self.comm)
        except Exception:  # noqa: BLE001 — no bridge attached
            pass
        try:
            self.ctx._hist_detach(self.comm)
        except Exception:  # noqa: BLE001 — no histograms armed
            pass
        self.comm.stop()
        self.reap()
        self._teardown_segments()
        output.debug_verbose(1, "ptcomm",
                             f"native comm lane down on rank "
                             f"{self.ce.my_rank}: {self.stats_brief()}")

    def stats_cached(self, ttl: float = 0.05) -> Dict[str, Any]:
        """stats() memoized for ``ttl`` seconds: the counter registry
        samples many ptcomm.* keys per snapshot sweep."""
        now = time.monotonic()
        stamp, snap = self._stats_cache
        if snap is None or now - stamp > ttl:
            snap = self.comm.stats()
            self._stats_cache = (now, snap)
        return snap

    def stats_brief(self) -> Dict[str, Any]:
        s = self.comm.stats()
        return {k: s[k] for k in ("acts_tx", "acts_rx", "data_tx",
                                  "data_rx", "rdv_tx", "rdv_rx",
                                  "frame_errors", "broken_peers")}
