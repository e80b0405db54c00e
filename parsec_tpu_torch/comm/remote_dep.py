"""Remote dependency engine: rank-to-rank dataflow over a comm engine.

Re-design of parsec/remote_dep.c + parsec/remote_dep_mpi.c:

* **activate / get / put protocol** (remote_dep_mpi.c:1347-2245): when a
  local producer completes, an *activate* AM travels to each consumer rank;
  small payloads ride inline (the eager short-circuit), large ones trigger a
  GET from the receiver answered by a PUT (one-sided emulation).
* **command pump** (remote_dep_dequeue_main, remote_dep_mpi.c:423;
  nothread_progress :1143-1271): worker threads never touch the network —
  they enqueue commands into a dequeue drained by the progress path (the
  master thread inline, or a dedicated comm thread when
  ``--mca comm_thread 1``, mirroring the funnelled model).
* **collective propagation** (remote_dep.c:40-46,322-411): one output
  multicast to many ranks via rank lists + re-rooted virtual trees —
  chain-pipeline (default), binomial, or star, selected by
  ``--mca comm_coll_bcast``; non-root ranks rebuild the tree and forward.
* **DTD remote edges** (rank_sent_to bitmaps + delayed release,
  remote_dep_mpi.c:2046,2100): payloads arriving before the local reader
  task is inserted park in ``_received`` until the expectation shows up.
* **termination detection**: the fourcounter module's wave protocol
  (Dijkstra/Mattern, ref parsec/mca/termdet/fourcounter/) rides the termdet
  tag: a token circulates the ring accumulating (sent, received, idle);
  two consecutive consistent waves ⇒ broadcast TERMINATE.

The engine is transport-agnostic through the CE vtable: control messages
ride the host fabric, and tensor payloads are snapshotted at the send
boundary (``engine.snapshot``: a torch tensor is mutable, so what a send
ships is a copy no later write of the producer reaches) and move through
whatever data plane the CE has (objects in-process, device to device with
``comm/d2d.py``, bytes or CUDA IPC between processes).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..core import termdet as termdet_mod
from ..utils import mca, output
from .engine import (CAP_STREAMING, CommEngine, TAG_CLOCKSYNC, TAG_CNT_AGG,
                     TAG_DTD_AUDIT, TAG_INTERNAL_GET, TAG_INTERNAL_PUT,
                     TAG_PTCOMM_BOOT, TAG_PTFAB, TAG_PTTEL,
                     TAG_REMOTE_DEP_ACTIVATE,
                     TAG_TERMDET, ready_event, snapshot)

mca.register("comm_eager_limit", 65536,
             "Payloads up to this many bytes ride inside the activate AM", type=int)
mca.register("comm_coll_bcast", "chain",
             "Multicast tree algorithm (chain|binomial|star)")
mca.register("comm_thread", False,
             "Dedicated communication progress thread (funnelled model)", type=bool)
mca.register("counter_aggregate", False,
             "Gather every rank's counter snapshot at fini and print a "
             "merged per-rank + sum table on rank 0 (aggregator_visu role)",
             type=bool)
mca.register("clock_sync_samples", 16,
             "Ping-pong exchanges per rank for the rank-0 clock-offset "
             "estimate (min-RTT sample wins; the estimate's error is "
             "bounded by that sample's RTT/2). The offset rebases this "
             "rank's trace timestamps in the multi-rank merge", type=int)


def bcast_children(ranks: Sequence[int], me: int, algo: str) -> List[Tuple[int, List[int]]]:
    """Split a destination list into (child, subtree) pairs as seen from
    ``me`` (the current forwarder). Every rank rebuilds the same tree
    (ref: parsec_remote_dep_propagate, remote_dep.c:411)."""
    rest = [r for r in ranks if r != me]
    if not rest:
        return []
    if algo == "star":
        return [(r, []) for r in rest]
    if algo == "binomial":
        out: List[Tuple[int, List[int]]] = []
        lst = rest
        while lst:
            half = (len(lst) + 1) // 2
            child, subtree = lst[0], lst[1:half]
            out.append((child, subtree))
            lst = lst[half:]
        return out
    # chain-pipeline (default, ref remote_dep.c:40)
    return [(rest[0], rest[1:])]


class RemoteDepEngine:
    """Per-rank protocol engine bound to one Context + CE."""

    def __init__(self, ctx, ce: CommEngine) -> None:
        self.ctx = ctx
        self.ce = ce
        ctx.comm = self
        ctx._need_wake = True   # comm progress waits on the work event
        ctx.my_rank = ce.my_rank
        ctx.nb_ranks = ce.nb_ranks
        self._cmds: "collections.deque" = collections.deque()  # the dequeue
        self._lock = threading.Lock()
        # (tile_key, version) -> list of (taskpool, task, flow_index)
        self._expected: Dict[Tuple, List[Tuple]] = {}
        # (tile_key, version) -> payload (parked until expectation arrives)
        self._received: Dict[Tuple, Any] = {}
        self._applied_version: Dict[Any, int] = {}
        self._tiles: Dict[Any, Any] = {}          # tile_key -> DTDTile
        self._sent: Set[Tuple] = set()            # (key, version, dst) dedup
        self._taskpools: Dict[str, Any] = {}      # name -> taskpool
        # AMs that arrived before their taskpool registered locally: parked
        # per taskpool name and replayed at registration (the data analogue
        # of requeue_token — dropping them would desync fourcounter sent/recv
        # and starve downstream multicast-tree ranks)
        self._early_ams: Dict[str, List[Tuple]] = {}
        # tile keys touched on behalf of each taskpool, so termination can
        # garbage-collect _received/_sent/_applied_version (unbounded
        # otherwise in long-running jobs)
        self._tp_keys: Dict[str, Set[Any]] = {}
        self.fourcounter = termdet_mod.FourCounterTermdet(self)
        self._td_state: Dict[str, Dict[str, Any]] = {}
        self._enabled = False
        self._comm_thread: Optional[threading.Thread] = None
        self._comm_polls = 0   # loop iterations (idle-backoff regression)
        self._comm_event = threading.Event()   # send-side wake for the park
        ce.tag_register(TAG_REMOTE_DEP_ACTIVATE, self._on_activate)
        ce.tag_register(TAG_INTERNAL_GET, self._on_get)
        ce.tag_register(TAG_INTERNAL_PUT, self._on_put)
        ce.tag_register(TAG_TERMDET, self._on_termdet)
        ce.tag_register(TAG_DTD_AUDIT, self._on_audit)
        self._audit_state: Dict[str, Dict[str, Any]] = {}
        ce.tag_register(TAG_CNT_AGG, self._on_counter_snap)
        self._cnt_snaps: Dict[int, Dict[int, Dict[str, Any]]] = {}  # epoch->rank->snap
        self._cnt_epoch = 0
        self._cnt_closed = -1   # highest epoch already merged/abandoned
        #: the serving fabric (serving/fabric.py), attached by the app or
        #: harness via fab_attach; control AMs arriving earlier park.
        #: _fab_lock closes the park-vs-attach race: without it the comm
        #: thread could read fabric=None, lose the CPU, and append to a
        #: box fab_attach already swapped out — dropping a routed insert
        #: whose credit was already spent (a leaked window reservation)
        self.fabric = None
        self._fab_lock = threading.Lock()
        self._fab_box: List[Tuple[int, Any, Any]] = []
        ce.tag_register(TAG_PTFAB, self._on_fab)
        #: the mesh telemetry plane (comm/pttel.py): built here when --mca
        #: tel_interval_ms > 0 (the whole mesh shares mca, so every rank
        #: decides the same way); the handler registers unconditionally and
        #: PARKS early frames — a child's first push racing this rank's
        #: construction must fold, not drop (the dropped deltas would be
        #: missing from the rollup forever)
        self.telemetry = None
        self._tel_lock = threading.Lock()
        self._tel_box: List[Tuple[int, Any]] = []
        ce.tag_register(TAG_PTTEL, self._on_tel)
        try:
            from .pttel import TelemetryPlane
            if TelemetryPlane.configured():
                self.tel_attach(TelemetryPlane(self))
        except Exception as e:  # noqa: BLE001 — telemetry is advisory
            output.debug_verbose(1, "pttel", f"telemetry plane off: {e}")
        #: the native communication lane (comm/native.py): built HERE —
        #: at protocol-engine construction, when every rank is known to
        #: be standing up its mesh symmetrically — so taskpools created
        #: before start() already see it. The boot handler registers
        #: unconditionally: a peer's bootstrap AM must park, not drop,
        #: even while this rank is still deciding
        self.native = None
        self._ptcomm_box: Dict[int, List[Dict[str, Any]]] = {}
        ce.tag_register(TAG_PTCOMM_BOOT, self._on_ptcomm_boot)
        reason = None
        try:
            from .native import NativeCommLane
            reason = NativeCommLane.available(ce)
            if reason is None:
                self.native = NativeCommLane(self, ce)
        except Exception as e:  # noqa: BLE001 — the lane is an optimization
            reason = f"bootstrap failed: {e}"
        if reason is not None and ce.nb_ranks > 1:
            output.debug_verbose(1, "ptcomm",
                                 f"native comm lane off: {reason}")
            # tell every peer we are NOT joining, so their bootstraps
            # abort immediately instead of pumping to the 45 s timeout
            # (a decline outranks any hello this rank sent before a
            # mid-bootstrap failure)
            try:
                for r in range(ce.nb_ranks):
                    if r != ce.my_rank:
                        ce.send_am(TAG_PTCOMM_BOOT, r,
                                   {"k": "hello", "avail": False}, None)
            except Exception:  # noqa: BLE001 — peers fall back on timeout
                pass
        # comm-stream tracing (ref: the comm thread's own profiling stream
        # with typed activate/put/get events + info dictionary,
        # remote_dep_mpi.c:1286-1302); bound lazily to ctx.profiling
        self._pprof = None
        self._pstream = None
        self._pkeys: Dict[str, int] = {}
        self._pev = 0
        # rank-0 clock offset: a non-blocking ping-pong state
        # machine over the AM plane — each rank r>0 measures
        # ``local_clock - rank0_clock`` (perf_counter_ns, the SAME clock
        # the PBP traces record) by min-RTT midpoint; the multi-rank
        # trace merge rebases every rank onto rank 0's clock with it.
        # Rank 0 (and single-rank contexts) are trivially offset 0
        self._clk_lock = threading.Lock()
        self._clk_samples: List[Tuple[int, int]] = []   # (offset_ns, rtt_ns)
        self._clk_done = ce.my_rank == 0 or ce.nb_ranks < 2
        self._clk_offset_ns: Optional[int] = 0 if self._clk_done else None
        self._clk_rtt_ns: Optional[int] = 0 if self._clk_done else None
        self._clk_peers_done: Set[int] = set()   # rank 0: peers that finished
        self._clk_stream = None                  # per-tracer meta stream
        self._clk_stream_prof = None
        ce.tag_register(TAG_CLOCKSYNC, self._on_clocksync)
        self._install_clock_counters()

    # ------------------------------------------------------- comm tracing
    COMM_EVENTS = ("activate_snd", "activate_rcv", "get_snd", "get_rcv",
                   "put_snd", "put_rcv")
    COMM_INFO_DESC = "src{i};dst{i};bytes{q};eager{i}"

    def _comm_prof(self):
        """The comm machinery's own profiling stream, one per rank
        (ref: MPI_Activate/MPI_Data_* keywords with src/dst/size info
        blobs, remote_dep_mpi.c:1286-1302)."""
        prof = getattr(self.ctx, "profiling", None)
        if prof is None:
            return None
        if self._pstream is None or self._pprof is not prof:
            self._pprof = prof
            self._pstream = prof.stream(f"comm(rank {self.ce.my_rank})")
            self._pkeys = {}
            for name in self.COMM_EVENTS:
                start, _ = prof.add_dictionary_keyword(
                    f"comm::{name}", info_desc=self.COMM_INFO_DESC)
                self._pkeys[name] = start
        return self._pstream

    @staticmethod
    def _payload_nbytes(p) -> int:
        if p is None:
            return 0
        n = getattr(p, "nbytes", None)
        if n is not None:
            return int(n)
        try:
            return len(p)
        except TypeError:
            return 0

    def _trace_comm(self, kind: str, src: int, dst: int, payload,
                    eager: bool = True) -> None:
        s = self._comm_prof()
        if s is None:
            return
        from ..utils.trace import EVENT_FLAG_POINT
        self._pev += 1
        info = self._pprof.pack_info(f"comm::{kind}", src=src, dst=dst,
                                     bytes=self._payload_nbytes(payload),
                                     eager=int(eager))
        s.trace(self._pkeys[kind], self._pev, 0, EVENT_FLAG_POINT, info)

    # ------------------------------------------------------------ clock sync
    def _install_clock_counters(self) -> None:
        """``comm.clock_offset_ns`` / ``comm.clock_rtt_ns`` in the
        unified registry (weakly bound: a registry sampler must never
        pin a dead engine alive)."""
        import weakref

        from ..utils.counters import counters
        wself = weakref.ref(self)

        def _sample(attr):
            def sample():
                s = wself()
                v = getattr(s, attr, None) if s is not None else None
                return float("nan") if v is None else v
            return sample

        counters.register("comm.clock_offset_ns",
                          sampler=_sample("_clk_offset_ns"))
        counters.register("comm.clock_rtt_ns", sampler=_sample("_clk_rtt_ns"))

    def _clk_ping(self) -> None:
        """Issue one ping toward rank 0 (non-blocking; the pong handler
        chains the next one until enough samples landed)."""
        if self._clk_done:
            return
        self.ce.send_am(TAG_CLOCKSYNC, 0,
                        {"k": "ping", "t0": time.perf_counter_ns()}, None)

    def _on_clocksync(self, ce, src, hdr, payload) -> None:
        kind = hdr.get("k")
        if kind == "ping":
            # answer with our clock reading; the requester brackets it
            ce.send_am(TAG_CLOCKSYNC, src,
                       {"k": "pong", "t0": hdr["t0"],
                        "ts": time.perf_counter_ns()}, None)
            return
        if kind == "done":      # a peer's estimate landed (rank 0 only)
            self._clk_peers_done.add(src)
            return
        t1 = time.perf_counter_ns()
        with self._clk_lock:
            if self._clk_done:
                return          # late/duplicate pong after finalize
            rtt = t1 - hdr["t0"]
            # symmetric-delay midpoint: rank 0 read its clock at ~our
            # (t0+t1)/2, so offset = local - rank0; error <= rtt/2
            self._clk_samples.append(
                ((hdr["t0"] + t1) // 2 - hdr["ts"], rtt))
            if len(self._clk_samples) >= \
                    max(2, mca.get("clock_sync_samples", 16)):
                off, rtt = min(self._clk_samples, key=lambda s: s[1])
                self._clk_offset_ns = off
                self._clk_rtt_ns = rtt
                self._clk_done = True
        if self._clk_done:
            self.stamp_clock_meta()
            # let rank 0 stop pumping on our behalf (clock_sync_wait)
            self.ce.send_am(TAG_CLOCKSYNC, 0, {"k": "done"}, None)
        else:
            self._clk_ping()

    def clock_sync_wait(self, timeout: float = 5.0) -> bool:
        """Pump until the offset estimate lands. On rank 0 — whose own
        offset is trivially 0 — this instead pumps until every PEER
        reported its estimate done: the ladder only advances while rank
        0 answers pings, so a rank-0 caller that stopped progressing
        (post-run barriers don't pump AMs) would strand the peers'
        remaining round trips. Collective in spirit: call it on every
        rank (the gates/tests do) before relying on the metadata."""
        self._clk_ping()
        if self.ce.my_rank == 0 and self.ce.nb_ranks > 1:
            want = self.ce.nb_ranks - 1
            return self._pump_until(
                lambda: len(self._clk_peers_done) >= want, timeout)
        return self._pump_until(lambda: self._clk_done, timeout)

    def clock_sync_finalize(self, timeout: float = 2.0) -> None:
        """Context.fini hook, called BEFORE the trace is stamped and
        dumped: give an unfinished ladder one bounded collective pump.
        Rank 0 participates too (its own estimate is trivially done, but
        the peers' ladders only advance while it answers pings — without
        this, every peer would burn its full timeout against a silent
        rank 0). No-op once everything already completed, which is the
        common case: the ladder usually finishes during the run."""
        if self.ce.nb_ranks < 2 or not self._enabled:
            return
        self.clock_sync_wait(timeout)

    def stamp_clock_meta(self) -> None:
        """Land one ``meta::clock`` POINT event (rank, offset, min-RTT)
        into the attached tracer — the per-rank metadata the multi-rank
        merge (tools/trace_reader.merge_traces) reads to rebase this
        rank's timestamps onto rank 0's clock. Called when the estimate
        lands and again defensively before any dump. Idempotent per
        tracer once the estimate is COMPLETE; an incomplete (ok=0) stamp
        does NOT latch, so a ladder that finishes later still lands its
        real offset — trace_reader.clock_meta prefers the ok=1 record."""
        prof = getattr(self.ctx, "profiling", None)
        if prof is None or not getattr(prof, "enabled", True):
            return
        if getattr(prof, "_clk_stamped", False):
            return
        from ..utils.trace import EVENT_FLAG_POINT
        start, _ = prof.add_dictionary_keyword(
            "meta::clock", info_desc="rank{i};peer{i};offset_ns{q};"
                                     "rtt_ns{q};ok{i}")
        # one stream per tracer (Profiling.stream always appends): an
        # ok=0 stamp followed by the completed one re-uses it instead of
        # minting duplicate identically-named streams in the dump
        if self._clk_stream is None or self._clk_stream_prof is not prof:
            self._clk_stream = prof.stream(f"clock(rank {self.ce.my_rank})")
            self._clk_stream_prof = prof
        info = prof.pack_info(
            "meta::clock", rank=self.ce.my_rank, peer=0,
            offset_ns=self._clk_offset_ns or 0,
            rtt_ns=self._clk_rtt_ns or 0, ok=int(self._clk_done))
        self._clk_stream.trace(start, 0, 0, EVENT_FLAG_POINT, info)
        if self._clk_done:
            prof._clk_stamped = True

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        """parsec_remote_dep_on: wake the comm machinery."""
        if self._enabled:
            return
        self._enabled = True
        self._clk_ping()        # kick the clock-offset estimate
        if self.telemetry is not None:
            self.telemetry.start()
        if mca.get("comm_thread", False):
            self._comm_thread = threading.Thread(
                target=self._comm_main, name="parsec-comm", daemon=True)
            self._comm_thread.start()

    def _comm_main(self) -> None:
        """Dedicated progress thread (ref: remote_dep_dequeue_main).

        Adaptive idle backoff: a fixed 50µs cadence burned a visible
        slice of a core on a fully idle multi-rank context (20k wakeups/s
        doing nothing). The loop now spins tight only while traffic
        flows, escalates its sleep while idle, and finally parks on a
        dedicated send-side event (set by every command enqueue, cleared
        here before the re-check so a wakeup can never be missed);
        inbound frames land via the transport reader threads, which
        cannot signal the event, so the park is capped at 20ms to stay
        responsive to pure-receive traffic."""
        import time
        idle = 0
        while self._enabled:
            self._comm_polls += 1
            if self.progress():
                idle = 0
                continue
            idle += 1
            if idle <= 20:
                time.sleep(50e-6)           # tight: mid-burst lulls
            elif idle <= 200:
                time.sleep(min(2e-3, 50e-6 * idle))   # escalate
            else:
                self._comm_event.clear()
                if not self._cmds:          # re-check: no missed wakeup
                    self._comm_event.wait(timeout=0.02)

    def _on_ptcomm_boot(self, ce, src, hdr, payload) -> None:
        """Park native-lane bootstrap AMs (consumed by comm/native.py)."""
        self._ptcomm_box.setdefault(src, []).append(hdr)

    def _on_fab(self, ce, src, hdr, payload) -> None:
        """Serving-fabric control AMs: dispatch to the attached fabric,
        or park until one attaches (a gateway insert racing the serving
        rank's fabric construction must not drop — the spent credit
        would leak a window reservation)."""
        with self._fab_lock:
            fab = self.fabric
            if fab is None:
                self._fab_box.append((src, hdr, payload))
                return
        fab.on_fab(src, hdr, payload)

    def fab_attach(self, fabric) -> None:
        """Attach the serving fabric and replay parked control AMs."""
        with self._fab_lock:
            self.fabric = fabric
            box, self._fab_box = self._fab_box, []
        for src, hdr, payload in box:
            fabric.on_fab(src, hdr, payload)

    def _on_tel(self, ce, src, hdr, payload) -> None:
        """Telemetry frames: fold into the plane, or park until one
        attaches (the _on_fab pattern; the box is bounded — an unarmed
        rank in an armed mesh is a config error, counted not grown)."""
        with self._tel_lock:
            tel = self.telemetry
            if tel is None:
                from .pttel import TEL_STATS
                if len(self._tel_box) < 256:
                    self._tel_box.append((src, hdr))
                    TEL_STATS["parked"] += 1
                else:
                    TEL_STATS["late_drops"] += 1
                return
        tel.on_frame(src, hdr)

    def tel_attach(self, tel) -> None:
        """Attach the telemetry plane and replay parked frames."""
        with self._tel_lock:
            self.telemetry = tel
            box, self._tel_box = self._tel_box, []
        for src, hdr in box:
            tel.on_frame(src, hdr)

    def fini(self) -> None:
        # clock-sync finalization (the bounded collective pump) already
        # ran from Context.fini BEFORE the trace was stamped/dumped;
        # here only the defensive stamp remains, for direct rde.fini
        # users whose tracer never got one (no-op once latched)
        self.stamp_clock_meta()
        if mca.get("counter_aggregate", False):
            try:
                table = self.aggregate_counters()
                if table is not None:
                    self._print_counter_table(table)
            except Exception as e:  # noqa: BLE001 - teardown must proceed
                output.warning(f"counter aggregation at fini failed: {e}")
        if self.telemetry is not None:
            # final flush BEFORE the progress machinery stops: the last
            # deltas ride one more hop while peers still pump AMs
            self.telemetry.stop(flush=True)
        self._enabled = False
        if self._comm_thread is not None:
            self._comm_event.set()       # unpark for a prompt exit
            self._comm_thread.join(timeout=2.0)
        if self.native is not None:
            self.native.fini()

    def _pump_until(self, cond, timeout: float) -> bool:
        """Progress-pump until ``cond()`` or timeout (the rank-0 gather
        loop shared by the audit and counter exchanges)."""
        import time
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() >= deadline:
                return False
            self.progress()
            time.sleep(1e-4)
        return True

    def register_taskpool(self, tp) -> None:
        # publish under _lock: AM handlers park-or-dispatch under the same
        # lock, so an activate can never fall between "not registered yet"
        # and "early list already drained"
        with self._lock:
            prev = self._taskpools.get(tp.name)
            if prev is not None and prev is not tp:
                st = self._td_state.get(tp.name)
                if st is not None and st.get("terminated"):
                    # a terminated pool never unregisters itself — recycle
                    # its slot (same program run again in one process)
                    self._td_state.pop(tp.name, None)
                else:
                    output.fatal(
                        f"taskpool name collision: {tp.name!r} already "
                        f"registered and live; concurrently-live distributed "
                        f"taskpools must have unique names (DTDTaskpool "
                        f"assigns a per-rank sequence number — construct "
                        f"pools in the same order on every rank)")
            self._taskpools[tp.name] = tp
            self._td_state.setdefault(tp.name, {
                "wave": 0, "token_out": False, "held": None,
                "last": None, "terminated": False,
            })
            early = self._early_ams.pop(tp.name, [])
        # replay AMs that raced ahead of this registration
        for kind, src, hdr, payload in early:
            if kind == "put":
                self._on_put(self.ce, src, hdr, payload)
            else:
                self._on_activate(self.ce, src, hdr, payload)

    # ------------------------------------------------------------ DTD API
    def register_tile(self, tile) -> None:
        self._tiles.setdefault(tile.key, tile)

    def expect(self, tp, task, tile, version: int, src_rank: int,
               flow_index: int) -> None:
        """A local task needs (tile, version) produced on ``src_rank``.

        If the payload already arrived (delayed-release case,
        remote_dep_mpi.c:2100) it is consumed immediately; otherwise the task
        gains one dependency satisfied at arrival time.
        """
        self.register_tile(tile)
        key = (tile.key, version)
        with self._lock:
            self._tp_keys.setdefault(tp.name, set()).add(tile.key)
            payload = self._received.get(key)
            if payload is None:
                with task.lock:
                    task.deps_remaining += 1
                self._expected.setdefault(key, []).append((tp, task, flow_index))
                return
        if task.pending_inputs is None:
            task.pending_inputs = {}
        task.pending_inputs[flow_index] = payload

    def note_send(self, tp, tile, version: int, dst_rank: int,
                  writer=None) -> None:
        """A remote task on ``dst_rank`` will need (tile, version).

        ``writer`` is the local task producing that version (captured by the
        caller BEFORE any same-call chain mutation); a pending writer gets
        the send attached (rank_sent_to bitmap), a finished/absent writer
        means the payload is already the tile's newest local content."""
        self.register_tile(tile)
        with self._lock:
            if (tile.key, version, dst_rank) in self._sent:
                return
        if writer is not None and writer.rank == self.ce.my_rank:
            # attach under the writer's lock and re-check completed there:
            # completion sets the flag and drains remote_sends under the
            # same lock, so an attach can never be lost in between
            with writer.lock:
                if not writer.completed:
                    if writer.remote_sends is None:
                        writer.remote_sends = {}
                    writer.remote_sends.setdefault(id(tile),
                                                   (tile, version, set()))
                    writer.remote_sends[id(tile)][2].add(dst_rank)
                    return
        # data already available locally: send right away (device arrays ship
        # as-is — the transport decides if/when to materialize host bytes,
        # ref parsec_mpi_allow_gpu_memory_communications)
        copy = tile.data.newest_copy()
        if copy is None:
            output.fatal(f"no data to send for {tile!r} v{version}")
        self.send_data(tp, tile, version, [dst_rank], copy.payload)

    def dtd_task_completed(self, tp, task) -> None:
        """Local writer finished: fire queued remote sends (the remote
        activation fork of parsec_release_dep_fct). The payload is this
        task's OWN output for the tile (a later local writer may already
        have advanced the tile's newest copy)."""
        sends = getattr(task, "remote_sends", None)
        if not sends:
            return
        with task.lock:   # excludes concurrent note_send attaches
            entries = list(sends.values())
            sends.clear()
        accesses = getattr(task.task_class, "flow_accesses", ())
        for tile, version, ranks in entries:
            payload = None
            for i, t in enumerate(getattr(task, "tiles", [])):
                # only a WRITE flow's slot holds the produced version (the
                # same tile may also appear as a READ flow holding the old
                # copy)
                if t is tile and i < len(accesses) and (accesses[i] & 0x2):
                    slot = task.data[i]
                    out = slot.data_out if slot.data_out is not None else slot.data_in
                    if out is not None:
                        payload = out.payload if hasattr(out, "payload") else out
                    break
            if payload is None:
                copy = tile.data.newest_copy()
                payload = copy.payload
            self.send_data(tp, tile, version, sorted(ranks), payload)

    def dtd_remote_task(self, tp, task) -> None:
        """Shadow of a task executing elsewhere — nothing to run locally;
        bookkeeping happened during linking."""

    # ------------------------------------------------------------ PTG path
    def ptg_send(self, tp, tc, pkey, flow_index: int, payload,
                 ranks: Sequence[int], dtt: Optional[str] = None) -> None:
        """Ship a PTG task's output flow to the ranks hosting its remote
        successors (the remote activation of parsec_release_dep_fct); the
        receiver re-derives which local tasks it feeds from the replicated
        program (the phantom-task trick of remote_dep_get_datatypes,
        remote_dep_mpi.c:861). ``dtt`` names the datatype the payload was
        pre-send reshaped to (one send per (flow, datatype) group)."""
        key = ("ptg", tp.name, tc.name, tuple(pkey) if isinstance(pkey, (list, tuple)) else pkey,
               flow_index, dtt)
        with self._lock:
            ranks = [r for r in ranks if (key, 0, r) not in self._sent]
            for r in ranks:
                self._sent.add((key, 0, r))
        if not ranks:
            return
        if payload is not None:
            payload = self._snapshot(payload)
        tp.addto_nb_pending_actions(1)
        self._cmds.append(("ptg_send", tp, key, ranks, payload))
        self._comm_event.set()
        self.ctx._work_event.set()

    def _own_copies(self, children, payload):
        """``(child, subtree, payload)`` a child: each child of the tree
        gets a copy of its own (the first the snapshot itself), so no two
        ranks ever share a mutable tensor."""
        for i, (child, subtree) in enumerate(children):
            yield child, subtree, payload if i == 0 or payload is None \
                else self._snapshot(payload)

    def _do_ptg_send(self, tp, key, ranks, payload) -> None:
        algo = mca.get("comm_coll_bcast", "chain")
        for child, subtree, payload in self._own_copies(
                bcast_children(ranks, self.ce.my_rank, algo), payload):
            hdr = {"ptg": True, "tp": key[1], "tc": key[2], "pkey": key[3],
                   "flow": key[4], "dtt": key[5], "forward": subtree,
                   "eager": True, "key": key, "version": 0}
            self.ce.send_am(TAG_REMOTE_DEP_ACTIVATE, child, hdr, payload)
            self._trace_comm("activate_snd", self.ce.my_rank, child, payload)
            self.fourcounter.message_sent(tp)

    # ------------------------------------------------------------ data path
    def _device_streams(self, device) -> List[Any]:
        """The streams of this context's device modules on ``device``
        (the streams that write and stage its tiles)."""
        return [d.stream for d in self.ctx.devices.devices
                if getattr(d, "stream", None) is not None
                and getattr(d, "torch_device", None) == device]

    def _snapshot(self, payload):
        """The value a send ships (``engine.snapshot``): a copy made after
        the work of the device module streams that may still write or stage
        a CUDA payload."""
        if isinstance(payload, torch.Tensor) and payload.device.type == "cuda":
            return snapshot(payload, self._device_streams(payload.device))
        return snapshot(payload)

    def send_data(self, tp, tile, version: int, ranks: Sequence[int],
                  payload: Any) -> None:
        """Multicast (tile, version) to ``ranks`` through the selected tree.
        ``payload`` may be a host or a CUDA tensor — CUDA tensors cross
        in-process rank boundaries without a host round-trip; wire
        transports materialize bytes (or export CUDA IPC handles) at the
        frame boundary.

        Enqueues a command; the network is only touched from the progress
        path (the funnelled discipline)."""
        ranks = [r for r in ranks if r != self.ce.my_rank]
        if not ranks:
            return
        with self._lock:
            if tp is not None:
                self._tp_keys.setdefault(tp.name, set()).add(tile.key)
            ranks = [r for r in ranks
                     if (tile.key, version, r) not in self._sent]
            for r in ranks:
                self._sent.add((tile.key, version, r))
        if not ranks:
            return
        # the send boundary: what ships is a snapshot (scalar/list body
        # outputs become tensors), taken NOW, before any later writer of
        # the tile can run on this rank
        payload = self._snapshot(payload)
        tp.addto_nb_pending_actions(1)
        self._cmds.append(("send", tp, tile.key, version, ranks, payload))
        self._comm_event.set()
        self.ctx._work_event.set()

    def _do_send(self, tp, tile_key, version, ranks, payload) -> None:
        algo = mca.get("comm_coll_bcast", "chain")
        eager_limit = mca.get("comm_eager_limit", 65536)
        if (self.ce.capabilities & CAP_STREAMING) and \
                mca.is_default("comm_eager_limit"):
            # ordered-stream transport: the payload crosses the same pipe
            # either way, so rendezvous only adds a GET/PUT round trip —
            # PUT-with-activate at any size. An
            # explicit --mca comm_eager_limit still forces the 3-hop path
            # (memory-pressure posture: payloads wait at the sender).
            eager_limit = float("inf")
        for child, subtree, payload in self._own_copies(
                bcast_children(ranks, self.ce.my_rank, algo), payload):
            hdr = {
                "tp": tp.name if tp is not None else None,
                "key": tile_key,
                "version": version,
                "forward": subtree,            # re-rooted tree remainder
                "shape": tuple(payload.shape),
                "dtype": str(payload.dtype),
            }
            if payload.nbytes <= eager_limit:
                hdr["eager"] = True
                self.ce.send_am(TAG_REMOTE_DEP_ACTIVATE, child, hdr, payload)
                self._trace_comm("activate_snd", self.ce.my_rank, child,
                                 payload)
            else:
                hdr["eager"] = False
                hdr["handle"] = self.ce.mem_register(payload)
                self.ce.send_am(TAG_REMOTE_DEP_ACTIVATE, child, hdr, None)
                self._trace_comm("activate_snd", self.ce.my_rank, child,
                                 None, eager=False)
            if tp is not None:
                self.fourcounter.message_sent(tp)

    # ------------------------------------------------------------ AM handlers
    def _on_activate(self, ce, src, hdr, payload) -> None:
        name = hdr.get("tp")
        tp, parked = self._taskpool_or_park(name, "activate", src, hdr, payload)
        if parked:
            return
        self._trace_comm("activate_rcv", src, ce.my_rank, payload,
                         eager=bool(hdr.get("eager", True)))
        if tp is not None:
            self.fourcounter.message_received(tp)
        if hdr.get("ptg"):
            self._ptg_arrived(tp, hdr, payload)
            return
        if hdr.get("eager"):
            self._data_arrived(tp, hdr, payload, src)
        else:
            # rendezvous: pull the payload (ref: remote_dep_mpi_get_start)
            ce.send_am(TAG_INTERNAL_GET, src,
                       {"handle": hdr["handle"], "requester": ce.my_rank,
                        "origin": hdr}, None)
            self._trace_comm("get_snd", ce.my_rank, src, None, eager=False)

    def _on_get(self, ce, src, hdr, payload) -> None:
        self._trace_comm("get_rcv", src, ce.my_rank, None, eager=False)
        buf = ce.resolve(hdr["handle"]) if hasattr(ce, "resolve") else None
        ce.send_am(TAG_INTERNAL_PUT, hdr["requester"],
                   {"origin": hdr.get("origin")}, buf)
        self._trace_comm("put_snd", ce.my_rank, hdr["requester"], buf,
                         eager=False)
        ce.mem_unregister(hdr["handle"])

    def _on_put(self, ce, src, hdr, payload) -> None:
        origin = hdr.get("origin") or {}
        tp, parked = self._taskpool_or_park(origin.get("tp"), "put",
                                            src, hdr, payload)
        if parked:
            return
        self._trace_comm("put_rcv", src, ce.my_rank, payload, eager=False)
        self._data_arrived(tp, origin, payload, src)

    def _taskpool_or_park(self, name, kind, src, hdr, payload):
        """Resolve a taskpool by name, or park the AM for replay when the
        name is known but not registered yet (the AM raced ahead of local
        registration — counting/forwarding it now would lose it). Returns
        (taskpool, parked). The re-check happens under _lock: registration
        publishes there, so either we see the pool or our parked AM is
        visible to its replay."""
        tp = self._taskpools.get(name)
        if tp is None and name is not None:
            with self._lock:
                tp = self._taskpools.get(name)
                if tp is None:
                    self._early_ams.setdefault(name, []).append(
                        (kind, src, hdr, payload))
                    return None, True
        return tp, False

    def _data_arrived(self, tp, hdr, payload, src) -> None:
        key = hdr["key"]
        version = hdr["version"]
        # forward to the rest of the multicast tree first (pipeline)
        fwd = hdr.get("forward") or []
        if fwd and tp is not None:
            # re-send from here: we are an interior tree node
            with self._lock:
                fwd = [r for r in fwd if (key, version, r) not in self._sent]
                for r in fwd:
                    self._sent.add((key, version, r))
            if fwd:
                # the forwarded value is this rank's own copy of what it
                # received: a later write here must not reach the subtree
                tp.addto_nb_pending_actions(1)
                self._cmds.append(("send", tp, key, version, fwd,
                                   self._snapshot(payload)))
        waiters: List[Tuple] = []
        with self._lock:
            if hdr.get("tp") is not None:
                self._tp_keys.setdefault(hdr["tp"], set()).add(key)
            self._received[(key, version)] = payload
            waiters = self._expected.pop((key, version), [])
            applied = self._applied_version.get(key, -1)
            tile = self._tiles.get(key)
            apply_tile = tile is not None and version > applied
            if apply_tile:
                self._applied_version[key] = version
        if apply_tile:
            from ..data.data import COHERENCY_SHARED
            host = tile.data.get_copy(0)
            if host is None:
                host = tile.data.create_copy(0, payload, COHERENCY_SHARED)
            else:
                # NOTE: the superseded payload is NOT released here — parked
                # _received entries, queued forwards, and waiter
                # pending_inputs may still alias it; arena recycling happens
                # at taskpool-termination GC (_gc_taskpool)
                host.payload = payload
            tile.data.bump_version(0)
            self._land_on_devices(tile, host, payload)
        ready = []
        for wtp, task, flow_index in waiters:
            if task.pending_inputs is None:
                task.pending_inputs = {}
            task.pending_inputs[flow_index] = payload
            if task.dep_satisfied():
                ready.append(task)
        if ready:
            self.ctx.schedule(ready)

    def _land_on_devices(self, tile, host, payload) -> None:
        """Preferred-device landing (ref: remote_dep_mpi_get_start
        allocating target copies on the consumer's device,
        remote_dep_mpi.c:2120): a tile that was device-resident stays
        device-resident — its CUDA copy is refreshed at the new version, so
        the consumer's stage-in sees a version-valid device copy instead of
        forcing a host-to-device transfer. A payload that ALREADY lives on
        this rank's card (the d2d plane, an IPC pull) becomes the device
        copy as it is, created if absent: zero transfers on the consume
        side. Either way the module's stream waits for the payload's ready
        event before anything of its own reads the copy."""
        from ..data.data import COHERENCY_SHARED
        pdev = payload.device if isinstance(payload, torch.Tensor) else None
        for dev in self.ctx.devices.devices:
            td = getattr(dev, "torch_device", None)
            if td is None:
                continue
            dev_index = dev.device_index
            dcopy = tile.data.get_copy(dev_index)
            already_here = pdev is not None and pdev == td
            if dcopy is None and not already_here:
                continue   # no resident copy to refresh, payload elsewhere
            if dev.stream is not None and ready_event(payload) is not None:
                dev.stream.wait_event(ready_event(payload))
                payload.record_stream(dev.stream)
            if dcopy is None:
                dcopy = tile.data.create_copy(dev_index, payload,
                                              COHERENCY_SHARED)
            else:
                if already_here:
                    dcopy.payload = payload
                else:
                    with dev._on_stream():
                        dcopy.payload = payload.to(td, non_blocking=True)
                dcopy.coherency_state = COHERENCY_SHARED
            dcopy.version = host.version
            dev.adopt_copy(tile.data, dcopy)

    def _ptg_arrived(self, tp, hdr, payload) -> None:
        key = tuple(hdr["key"]) if isinstance(hdr["key"], list) else hdr["key"]
        # forward down the multicast tree
        fwd = hdr.get("forward") or []
        if fwd and tp is not None:
            with self._lock:
                fwd = [r for r in fwd if (key, 0, r) not in self._sent]
                for r in fwd:
                    self._sent.add((key, 0, r))
            if fwd:
                tp.addto_nb_pending_actions(1)
                self._cmds.append(("ptg_send", tp, key, fwd,
                                   None if payload is None
                                   else self._snapshot(payload)))
        if tp is None:
            output.warning(f"PTG payload for unknown taskpool {hdr.get('tp')!r}")
            return
        tp._ptg_data_arrived(hdr["tc"], hdr["pkey"], hdr["flow"], payload,
                             wire_dtt=hdr.get("dtt"))

    # ------------------------------------------------------------ progress
    def progress(self) -> int:
        n = 0
        while self._cmds:
            try:
                cmd = self._cmds.popleft()
            except IndexError:
                break
            if cmd[0] == "send":
                _, tp, key, version, ranks, payload = cmd
                self._do_send(tp, key, version, ranks, payload)
                if tp is not None:
                    tp.addto_nb_pending_actions(-1)
                n += 1
            elif cmd[0] == "ptg_send":
                _, tp, key, ranks, payload = cmd
                self._do_ptg_send(tp, key, ranks, payload)
                tp.addto_nb_pending_actions(-1)
                n += 1
            elif cmd[0] == "requeue_token":
                token = cmd[1]
                if token.get("tp") in self._taskpools:
                    self._on_termdet(self.ce, -1, token, None)
                    n += 1
                else:
                    # still unregistered: park again and yield this round
                    self._cmds.append(cmd)
                    break
        n += self.ce.progress()
        n += self._termdet_progress()
        if n == 0:
            # failure detection (the C reference has
            # none): only after a FRUITLESS drain — frames the dead peer
            # sent before dying were queued ahead of the EOF and may still
            # terminate the taskpool cleanly — a dead peer with live
            # taskpools is an attributed fatal, not a hang until timeout
            dead = getattr(self.ce, "dead_peers", None)
            if dead:
                live = [name for name, st in self._td_state.items()
                        if not st["terminated"]]
                if live:
                    output.fatal(
                        f"rank(s) {sorted(dead)} FAILED (connection lost "
                        f"without clean shutdown) while taskpool(s) {live} "
                        f"are still running on rank {self.ce.my_rank}")
        return n

    # ------------------------------------------------------------ audit
    def _on_audit(self, ce, src, hdr, payload) -> None:
        # exchanges are keyed by (taskpool, epoch): every rank audits at
        # the same wait() count, so epochs align and round N+1 reports can
        # never contaminate round N
        st = self._audit_state.setdefault(
            (hdr["tp"], hdr["epoch"]), {"got": {}, "verdict": None})
        if hdr["kind"] == "report":
            st["got"][hdr["rank"]] = (hdr["digest"], hdr["count"])
        else:   # verdict broadcast from rank 0
            st["verdict"] = hdr["ok"]

    def audit_check(self, tp, digest: int, count: int,
                    timeout: float = 30.0) -> None:
        """DTD replay auditor exchange (the DTD analogue of the PTG
        iterators_checker, ref parsec/mca/pins/iterators_checker/): every
        rank reports a deterministic digest of its (tile, version, rank)
        link decisions; rank 0 compares — any divergence between the
        replayed insert sequences is fatal BEFORE the run can hang or
        silently corrupt data. An exchange that cannot complete within
        ``timeout`` is itself fatal on every rank (a silent pass would
        re-open the silent-hang hole the auditor exists to close)."""
        me = self.ce.my_rank
        epoch = getattr(tp, "_audit_epoch", 0)
        tp._audit_epoch = epoch + 1
        key = (tp.name, epoch)
        st = self._audit_state.setdefault(key, {"got": {}, "verdict": None})
        if me == 0:
            st["got"][0] = (digest, count)
            self._pump_until(lambda: len(st["got"]) >= self.ce.nb_ranks,
                             timeout)
            ok = len(st["got"]) == self.ce.nb_ranks and \
                len(set(st["got"].values())) == 1
            for r in range(1, self.ce.nb_ranks):
                self.ce.send_am(TAG_DTD_AUDIT, r,
                                {"tp": tp.name, "epoch": epoch,
                                 "kind": "verdict", "ok": ok}, None)
            got = dict(sorted(st["got"].items()))
            self._audit_state.pop(key, None)
            if not ok:
                output.fatal(
                    f"DTD replay audit FAILED for {tp.name!r} (epoch "
                    f"{epoch}): per-rank (digest, count) = {got} — the "
                    f"ranks did not replay the same insert sequence")
        else:
            self.ce.send_am(TAG_DTD_AUDIT, 0,
                            {"tp": tp.name, "epoch": epoch, "kind": "report",
                             "rank": me, "digest": digest, "count": count},
                            None)
            self._pump_until(lambda: st["verdict"] is not None, timeout)
            verdict = st["verdict"]
            self._audit_state.pop(key, None)
            if verdict is not True:
                why = "no verdict arrived (exchange timed out)" \
                    if verdict is None else "the ranks did not replay the " \
                    "same insert sequence"
                output.fatal(
                    f"DTD replay audit FAILED for {tp.name!r} (epoch "
                    f"{epoch}, rank {me}: digest={digest:#x} "
                    f"count={count}) — {why}")

    # ------------------------------------------------------- counter agg
    def _on_counter_snap(self, ce, src, hdr, payload) -> None:
        # epoch-keyed like the audit exchange: a late round-N snapshot can
        # never satisfy (or contaminate) round N+1; stragglers for an
        # already-merged/abandoned epoch are dropped, not parked forever
        if hdr["epoch"] <= self._cnt_closed:
            return
        self._cnt_snaps.setdefault(hdr["epoch"], {})[hdr["rank"]] = hdr["snap"]

    def aggregate_counters(self, timeout: float = 15.0
                           ) -> Optional[Dict[str, Any]]:
        """Cross-rank counter aggregation (ref:
        tools/aggregator_visu/aggregator.py + papi_sde.c export): every
        rank ships its counters.py snapshot to rank 0, which merges them
        into per-rank columns + a SUM row. Returns the merged table on
        rank 0 (None elsewhere). Enabled at fini via --mca
        counter_aggregate 1.

        Lane-aware: a ptcomm-engaged run largely bypasses this
        module, so the rollup would silently miss the native wire unless
        the lanes' samplers (``ptcomm.*`` C-side counters, ``ptexec.*``/
        ``ptdtd.*`` engagement, latency percentiles) are installed in the
        registry before the snapshot — done here, idempotently, so the
        fini table covers whichever path carried the run. The exchange
        itself stays on the CE AM plane, which outlives the native lane
        (NativeCommLane.fini runs after this in RemoteDepEngine.fini)."""
        from ..utils.counters import counters, install_native_counters
        try:
            install_native_counters()
        except Exception:  # noqa: BLE001 — partial native: keep the rest
            pass
        snap = counters.snapshot()
        epoch = self._cnt_epoch
        self._cnt_epoch += 1
        if self.ce.nb_ranks == 1:
            return {"per_rank": {0: snap}, "sum": dict(snap)}
        if self.ce.my_rank != 0:
            self.ce.send_am(TAG_CNT_AGG, 0,
                            {"epoch": epoch, "rank": self.ce.my_rank,
                             "snap": snap}, None)
            return None
        got = self._cnt_snaps.setdefault(epoch, {})
        got[0] = snap
        self._pump_until(lambda: len(got) >= self.ce.nb_ranks, timeout)
        missing = [r for r in range(self.ce.nb_ranks) if r not in got]
        if missing:
            output.warning(f"counter aggregation: no snapshot from ranks "
                           f"{missing}")
        import math

        def gauge(k: str) -> bool:
            # per-rank gauges (latency percentiles, clock offsets) have
            # no meaningful cross-rank SUM — adding four ranks' p99s
            # prints a number that LOOKS like a latency but isn't; they
            # stay in the per-rank columns only
            return (".hist." in k and not k.endswith(".count")) or \
                k.startswith("comm.clock_")

        per_rank = dict(sorted(got.items()))
        total: Dict[str, Any] = {}
        for s in per_rank.values():
            for k, v in s.items():
                # a NaN sampler (clock offset not yet measured, failing
                # sampler) must not poison the whole SUM cell
                if isinstance(v, (int, float)) and math.isfinite(v) \
                        and not gauge(k):
                    total[k] = total.get(k, 0) + v
        self._cnt_snaps.pop(epoch, None)
        self._cnt_closed = max(self._cnt_closed, epoch)
        return {"per_rank": per_rank, "sum": total}

    def _print_counter_table(self, table: Dict[str, Any]) -> None:
        names = sorted({k for s in table["per_rank"].values() for k in s})
        if not names:
            return
        ranks = list(table["per_rank"])
        cols = [("counter", [n for n in names])]
        for r in ranks:
            cols.append((f"r{r}", [str(table["per_rank"][r].get(n, ""))
                                   for n in names]))
        cols.append(("sum", [str(table["sum"].get(n, "")) for n in names]))
        widths = [max(len(h), max((len(c) for c in body), default=0))
                  for h, body in cols]
        def row(cells):
            return " | ".join(c.ljust(w) for c, w in zip(cells, widths))
        lines = [row([h for h, _ in cols])]
        for i in range(len(names)):
            lines.append(row([body[i] for _, body in cols]))
        output.inform("cross-rank counters at fini:\n" + "\n".join(lines))

    # ------------------------------------------------------------ termdet
    def termdet_local_idle(self, tp) -> None:
        """Fourcounter: this rank became locally idle for ``tp``."""
        # waves advance from the progress path; nothing to do eagerly

    def _termdet_progress(self) -> int:
        n = 0
        for name, st in list(self._td_state.items()):
            tp = self._taskpools.get(name)
            if tp is None or st["terminated"]:
                continue
            idle = self.fourcounter.locally_idle(tp)
            held = st["held"]
            if held is not None and idle:
                st["held"] = None
                self._forward_token(tp, st, held)
                n += 1
            elif self.ce.my_rank == 0 and idle and not st["token_out"] \
                    and held is None:
                # initiate a wave
                st["token_out"] = True
                st["wave"] += 1
                s, r = self.fourcounter.counters(tp)
                token = {"type": "wave", "tp": name, "wave": st["wave"],
                         "sent": s, "recv": r, "idle": True, "hops": 1}
                if self.ce.nb_ranks == 1:
                    self._wave_done(tp, st, token)
                else:
                    self.ce.send_am(TAG_TERMDET, 1, token, None)
                n += 1
        return n

    def _forward_token(self, tp, st, token) -> None:
        s, r = self.fourcounter.counters(tp)
        token["sent"] += s
        token["recv"] += r
        token["idle"] = token["idle"] and self.fourcounter.locally_idle(tp)
        token["hops"] += 1
        nxt = (self.ce.my_rank + 1) % self.ce.nb_ranks
        if nxt == 0:
            self.ce.send_am(TAG_TERMDET, 0, token, None)
        else:
            self.ce.send_am(TAG_TERMDET, nxt, token, None)

    def _on_termdet(self, ce, src, token, payload) -> None:
        name = token.get("tp")
        tp = self._taskpools.get(name)
        st = self._td_state.get(name)
        if token.get("type") == "terminate":
            if tp is not None and st is not None and not st["terminated"]:
                st["terminated"] = True
                # forward the termination broadcast down the ring first
                nxt = (ce.my_rank + 1) % ce.nb_ranks
                if nxt != 0:
                    ce.send_am(TAG_TERMDET, nxt, token, None)
                self.fourcounter.declare_terminated(tp)
                self._gc_taskpool(name)
            return
        if tp is None or st is None:
            # taskpool not registered yet: park the token until it is
            self._cmds.append(("requeue_token", token))
            return
        if ce.my_rank == 0:
            self._wave_done(tp, st, token)
        else:
            if self.fourcounter.locally_idle(tp):
                self._forward_token(tp, st, token)
            else:
                st["held"] = token   # hold until idle (Dijkstra-style)

    def _wave_done(self, tp, st, token) -> None:
        st["token_out"] = False
        consistent = token["idle"] and token["sent"] == token["recv"]
        if consistent and st["last"] == (token["sent"], token["recv"]):
            st["terminated"] = True
            if self.ce.nb_ranks > 1:
                self.ce.send_am(TAG_TERMDET, 1,
                                {"type": "terminate", "tp": tp.name}, None)
            self.fourcounter.declare_terminated(tp)
            self._gc_taskpool(tp.name)
            return
        st["last"] = (token["sent"], token["recv"]) if consistent else None

    def _gc_taskpool(self, name: str) -> None:
        """Drop per-payload bookkeeping for a terminated taskpool: every
        reader has run, so parked payloads / send-dedup / applied-version
        entries for its tiles can never be consumed again."""
        from ..data.arena import release_buffer
        dropped: List[Any] = []
        with self._lock:
            keys = self._tp_keys.pop(name, set())
            # a tile key shared with a still-live pool stays accounted to it
            # (remaining _tp_keys entries all belong to live pools)
            for other in self._tp_keys.values():
                keys -= other
                if not keys:
                    break
            # buffers that became live tile content must not be recycled
            live = set()
            for k in keys:
                t = self._tiles.get(k)
                c = t.data.get_copy(0) if t is not None else None
                if c is not None and c.payload is not None:
                    live.add(id(c.payload))
            for k in keys:
                self._applied_version.pop(k, None)
                self._tiles.pop(k, None)
            if keys:
                for kv, p in self._received.items():
                    if kv[0] in keys and id(p) not in live:
                        dropped.append(p)
                self._received = {kv: p for kv, p in self._received.items()
                                  if kv[0] not in keys}
            # tile-key entries + PTG send-dedup entries (which embed the
            # taskpool name in the key) in one pass
            self._sent = {s for s in self._sent
                          if s[0] not in keys
                          and not (isinstance(s[0], tuple) and len(s[0]) >= 5
                                   and s[0][0] == "ptg" and s[0][1] == name)}
        # recycle arena recv buffers outside the lock: termination guarantees
        # no consumer, forward, or late expect can still reference them
        for p in dropped:
            release_buffer(p)
