"""Whole-taskpool graph capture: one CUDA graph per DTD DAG.

Where the scheduler dispatches every task through the host (per-task
dependency bookkeeping, stage-in, a kernel launch, an event poll), a captured
taskpool RECORDS the insert_task sequence and runs it as one program. DTD's
sequential-consistency semantics make this sound: insertion order is a valid
serialization of the DAG, so replaying the bodies in insertion order computes
exactly what the scheduler computes.

On a CUDA context the program is a ``torch.cuda.CUDAGraph``: the first
execution of a DAG shape runs the replay once eagerly on a side stream (the
warm-up, which builds the kernels, creates library handles and sets kernel
attributes before any capture, and whose results are the execution's), then
records the same replay into a graph; every later execution of the shape
replays that graph, one launch for the whole DAG. On a CPU context the same
replay runs eagerly (how the tests run it).

Semantics and limits (checked, not assumed):

* single-rank only;
* bodies must be tensor functions (``jit=True`` inserts; by-value arguments
  are numbers or arrays) that neither synchronise with the card nor
  allocate outside the caching allocator;
* execution happens at ``tp.wait()`` (or ``tp.close()``); tile versions bump
  exactly as if the tasks had run through the scheduler, so collections read
  back normally. On the card the results land as the CUDA device's copies,
  the way the device module lands a task.

Usage::

    tp = DTDTaskpool(ctx, "gemm", capture=True)
    insert_gemm_tasks(tp, A, B, C, batch_k=True)
    tp.wait()          # captures (first time) + executes the whole DAG
    tp.close()
"""

from __future__ import annotations

import collections
import os
import re
import tempfile
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.data import COHERENCY_OWNED
from ..utils import mca, output
from .fusion import ExecCache, device_fingerprint

mca.register("capture_scan_threshold", 64,
             help="op count at which capture='auto' switches from inline "
                  "replay to the scanned task interpreter", type=int)
mca.register("capture_auto_defer", True,
             "Per-window capture deferral: a wait()-delimited insert window "
             "that turns out not to be capturable (a jit=False insert, an "
             "argument that is neither a tile, a number nor an array) "
             "replays through the scheduler instead of aborting the run; "
             "capturable windows still run as one program. 0 restores the "
             "hard reject", type=bool)


class CaptureDeferred(Exception):
    """Raised by :meth:`GraphCapture.record` when the current insert window
    cannot be captured and ``--mca capture_auto_defer`` is on: the taskpool
    replays the recorded prefix as ordinary scheduler inserts and runs the
    rest of the window through the scheduler too (capture re-arms at the
    next window)."""


#: process-wide program cache: the same DAG shape (op sequence, tile shapes
#: and dtypes, scalar params, device) is captured exactly once, shared
#: ACROSS pool instantiations, so repeated DAGs replay a warm graph. Keys
#: hold the body function OBJECTS (identity equality: two closures over
#: different constants never share a program), so the cache is LRU-bounded.
#: A cached CUDA program holds its graph, the graph's memory pool and its
#: static buffers; their bytes count against its card's tile budget (the
#: device module's ``program_bytes``), the cache drops the least recently
#: used programs of a card that runs over it, and the context's ``fini()``
#: releases all of its card's programs. ``_program_cache.clear()`` releases
#: every program.
_PROGRAM_CACHE_MAX = 64
_program_cache = ExecCache(_PROGRAM_CACHE_MAX)
_cache_lock = threading.Lock()
#: the device modules whose ``fini()`` releases their programs
_hooked: "weakref.WeakSet[Any]" = weakref.WeakSet()

#: memoized dtype-gate verdicts (None = compatible, str = reject reason),
#: keyed like the program cache (body identity + slots + store geometry)
_dtype_gate_cache: "collections.OrderedDict[Any, Optional[str]]" = \
    collections.OrderedDict()

#: the side stream of each card on which warm-ups run and graphs are captured
_side_streams: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    with _cache_lock:
        s = _side_streams.get(device.index)
        if s is None:
            s = _side_streams[device.index] = torch.cuda.Stream(device)
        return s


def _outputs(outs) -> Tuple:
    if outs is None:
        return ()
    if not isinstance(outs, (tuple, list)):
        return (outs,)
    return tuple(outs)


def _body_name(fn) -> str:
    return getattr(fn, "__name__", None) or type(fn).__name__


class CaptureFailed(RuntimeError):
    """A DAG that ran (as its warm-up) but could not be captured into a CUDA
    graph; the message names the body at fault when one raised."""


def _naming(fn):
    """``fn`` with its exceptions re-raised naming it (capture failures)."""
    def call(*args):
        try:
            return fn(*args)
        except Exception as e:
            raise CaptureFailed(f"body {_body_name(fn)!r} cannot be captured "
                                f"({type(e).__name__}: {e})") from e
    return call


def _capture(stream, replay) -> Tuple["torch.cuda.CUDAGraph", float, int]:
    """Record ``replay()`` into a new graph on ``stream`` (stream capture,
    thread-local: other threads may use the card meanwhile) and instantiate
    it; returns the graph, the seconds of capture + instantiation and the
    bytes the card's caching allocator reserved meanwhile (the graph's
    private pool; an estimate, since another thread may allocate at the
    same time). The graph keeps its ``cudaGraph_t``, so ``debug_dump``
    can list its nodes. Raises :class:`CaptureFailed`.

    Capture begins and ends on the graph itself, not through
    ``torch.cuda.graph``, whose entry synchronizes the card and empties the
    caching allocator: returning every cached block to the driver can cost
    more than the capture, and the blocks are allocated again after it."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    failed: List[BaseException] = []
    reserved = torch.cuda.memory_reserved(stream.device)
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                replay()
            except BaseException as e:
                failed.append(e)
                raise
            finally:
                graph.capture_end()
    except Exception as e:
        cause = failed[0] if failed else e
        if isinstance(cause, CaptureFailed):
            raise CaptureFailed(str(cause)) from e
        raise CaptureFailed(f"graph capture failed ({type(cause).__name__}: "
                            f"{cause})") from e
    graph.instantiate()
    return (graph, time.perf_counter() - t0,
            max(0, torch.cuda.memory_reserved(stream.device) - reserved))


def _nbytes(tensors) -> int:
    """Bytes of ``tensors``, each storage counted once."""
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class _Program:
    """What the two strategies' programs share: the card they were captured
    on, the bytes they charge to its budget, and :meth:`release`."""

    def __init__(self) -> None:
        self.graph = None
        self.capture_s: Optional[float] = None
        self.lock = threading.Lock()
        self.dev = None
        self.charged = 0
        self.released = False

    def _charge(self, dev, nbytes: int) -> None:
        """Count ``nbytes`` against ``dev``'s budget (not for a program that
        left the cache while it ran: nothing would release it)."""
        if self.released:
            return
        self.dev, self.charged = dev, nbytes
        with dev._heap_lock:
            dev.program_bytes += nbytes
        with _cache_lock:
            if dev not in _hooked:
                _hooked.add(dev)
                dev.fini_hooks.append(lambda: _release_programs_of(dev))

    def release(self) -> None:
        """Drop the graph and the buffers (the program left the cache)."""
        with self.lock:
            self.released = True
            if self.dev is not None:
                with self.dev._heap_lock:
                    self.dev.program_bytes -= self.charged
            self.charged = 0
            self.graph = None
            self._drop()

    def _drop(self) -> None:
        raise NotImplementedError

    def kernel_nodes(self) -> Dict[str, int]:
        """The kernel nodes of the captured graph by (mangled) function
        name: what one replay launches. Read from the graph's DOT print
        (``cudaGraphDebugDotPrint``); {} before a capture."""
        if self.graph is None:
            return {}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "graph.dot")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                self.graph.debug_dump(path)
            with open(path) as f:
                dot = f.read()
        return dict(collections.Counter(_KERNEL_NODE.findall(dot)))


#: a kernel node's function name in a graph's DOT print
_KERNEL_NODE = re.compile(r'label="\{KERNEL\s*\|\s*\{ID \|[^|]*\|\s*([^\\<|}]+)')


def _release_programs_of(dev) -> None:
    """Release every cached program captured on ``dev`` (its ``fini()``)."""
    for key, prog in _program_cache.oldest_first():
        if getattr(prog, "dev", None) is dev:
            _program_cache.discard(key)
    with _cache_lock:
        _hooked.discard(dev)


def _fit(dev, keep) -> None:
    """Evict ``dev``'s least recently used programs, ``keep`` aside, while
    its resident tiles and programs exceed its budget."""
    for key, prog in _program_cache.oldest_first():
        if dev._resident_bytes + dev.program_bytes <= dev._budget:
            return
        if prog is not keep and getattr(prog, "dev", None) is dev:
            _program_cache.evict(key)


class _InlineProgram(_Program):
    """The inline strategy's program for one signature: the op fold.

    On the CPU it runs eagerly and functionally. On a card it is a CUDA
    graph whose static buffers are the tiles' own device tensors: each
    written tile is landed in place (``copy_`` of the body's output, in
    program order), so a replay reads and writes the collections
    themselves. A later execution whose tiles are other tensors of the same
    signature hands the static buffers over: the previous owner of each
    buffer first gets a private copy of its value, then the new tile's value
    is copied in and the new tile adopts the buffer (one copy per tile each
    way, on the device module's stream, before the replay, so no replay ever
    reads a buffer it has already written). The owners are held weakly: a
    cached program does not keep a collection alive."""

    def __init__(self, ops, written) -> None:
        super().__init__()
        self.ops = ops
        self.written = written
        self.static: List[torch.Tensor] = []
        self.arrs: List[torch.Tensor] = []
        self.owners: List["weakref.ref[Any]"] = []

    def _drop(self) -> None:
        self.static, self.arrs, self.owners = [], [], []

    def run_eager(self, tile_vals, arr_vals) -> List[torch.Tensor]:
        env = list(tile_vals)
        GraphCapture._replay(self.ops, env.__getitem__, env.__setitem__,
                             arr_vals)
        return [env[i] for i in self.written]

    def _in_place(self, ops) -> None:
        static = self.static

        def write(i, v):
            static[i].copy_(v)
        GraphCapture._replay(ops, static.__getitem__, write, self.arrs)

    def run_cuda(self, copies, arr_vals, dev) -> List[torch.Tensor]:
        """On ``dev.stream`` (the caller's current stream)."""
        if self.graph is None:
            self._first(copies, arr_vals, dev)
        else:
            self._bind(copies, arr_vals)
            self.graph.replay()
        return [self.static[i] for i in self.written]

    def _first(self, copies, arr_vals, dev) -> None:
        seen = set()
        for c in copies:
            # two tiles on one buffer would share a static buffer: the
            # later one gets its own
            if c.payload.data_ptr() in seen:
                c.payload = c.payload.clone()
            seen.add(c.payload.data_ptr())
        self.static = [c.payload for c in copies]
        self.owners = [weakref.ref(c) for c in copies]
        self.arrs = [torch.as_tensor(a).to(dev.torch_device, copy=True)
                     for a in arr_vals]
        side = _side_stream(dev.torch_device)
        side.wait_stream(dev.stream)
        with torch.cuda.stream(side):
            self._in_place(self.ops)                 # the warm-up
        dev.stream.wait_stream(side)
        named = [(_naming(fn), spec) for fn, spec in self.ops]
        self.graph, self.capture_s, pool = _capture(
            side, lambda: self._in_place(named))
        self._charge(dev, _nbytes(self.static + self.arrs) + pool)

    def _bind(self, copies, arr_vals) -> None:
        stale = [i for i, c in enumerate(copies)
                 if c is not self.owners[i]() or c.payload is not self.static[i]]
        for i in stale:
            old = self.owners[i]()
            if old is not None and old.payload is self.static[i]:
                old.payload = self.static[i].clone()
        ptrs = {t.data_ptr() for t in self.static}
        for i in stale:
            c = copies[i]
            if c.payload.data_ptr() in ptrs:
                c.payload = c.payload.clone()
        for i in stale:
            self.static[i].copy_(copies[i].payload)
            copies[i].payload = self.static[i]
            self.owners[i] = weakref.ref(copies[i])
        for buf, a in zip(self.arrs, arr_vals):
            buf.copy_(torch.as_tensor(a))


def _row_layout(slots) -> List[Tuple[int, List[int]]]:
    """Where a class's flows sit in its descriptor row: grouped by store,
    ``[(store_id, [flow_pos, ...]), ...]`` in row order, so that each
    store's flows of one step are one contiguous slice of the row, one
    gather."""
    groups: Dict[int, List[int]] = {}
    for sd in slots:
        if sd[0] == "flow":
            groups.setdefault(sd[2], []).append(sd[1])
    return sorted(groups.items())


class _ScanProgram(_Program):
    """The scan strategy's program for one signature: the task-class
    interpreter over per-(shape, dtype) stacked stores, its descriptor rows
    (the store slot of every flow of every op, each op's flows grouped by
    store) in an int64 tensor on the stores' device. A step gathers its
    flows with one ``index_select`` per store it reads and scatters each
    write with ``index_copy_``, all indexed by that tensor.

    On a card it is a CUDA graph: the stores and the row tensor are its
    static buffers, so a DAG with the same class sequence and store
    geometry but other flow slots replays the same graph (the rows are
    data). Each execution stacks the tiles into the stores before the
    replay and lands the written slots after it. On the CPU the stores are
    made anew at each execution and not kept."""

    def __init__(self, classes, class_seq) -> None:
        super().__init__()
        from .dtd import WRITE
        self.steps = []
        for fn, slots in classes:
            gathers, at = [], {}       # (sid, row lo, row hi); fp -> (g, j)
            lo = 0
            for sid, fps in _row_layout(slots):
                for j, fp in enumerate(fps):
                    at[fp] = (len(gathers), j, lo + j)
                gathers.append((sid, lo, lo + len(fps)))
                lo += len(fps)
            reads, writes = [], []
            for sd in slots:
                if sd[0] == "flow":
                    _, fp, sid, acc = sd
                    g, j, pos = at[fp]
                    reads.append((g, j))
                    if acc & WRITE:
                        writes.append((pos, sid))
                else:
                    reads.append((None, sd[1]))
            self.steps.append((fn, gathers, reads, writes))
        self.class_seq = class_seq
        self.stores: List[torch.Tensor] = []
        self.rows: Optional[torch.Tensor] = None

    def _drop(self) -> None:
        self.stores, self.rows = [], None

    def fold(self, stores, rows, steps=None) -> None:
        steps = self.steps if steps is None else steps
        for r, cid in enumerate(self.class_seq):
            fn, gathers, reads, writes = steps[cid]
            row = rows[r]
            got = [stores[sid].index_select(0, row[lo:hi])
                   for sid, lo, hi in gathers]
            ins = [v if g is None else got[g][v] for g, v in reads]
            for (pos, sid), out in zip(writes, _outputs(fn(*ins))):
                stores[sid].index_copy_(
                    0, row[pos:pos + 1],
                    out.to(stores[sid].dtype).unsqueeze(0))

    def run(self, tile_vals, store_ixs, flow_idx, dev) -> List[torch.Tensor]:
        """The stores after the DAG; on ``dev.stream`` when ``dev``."""
        groups = [[tile_vals[i] for i in ixs] for ixs in store_ixs]
        if dev is None:
            stores = [torch.stack(g) for g in groups]
            self.fold(stores, torch.from_numpy(flow_idx))
            return stores
        if self.graph is None:
            self.stores = [torch.stack(g) for g in groups]
            self.rows = torch.from_numpy(flow_idx).to(dev.torch_device)
            side = _side_stream(dev.torch_device)
            side.wait_stream(dev.stream)
            with torch.cuda.stream(side):
                self.fold(self.stores, self.rows)    # the warm-up
            dev.stream.wait_stream(side)
            named = [(_naming(fn), *rest) for fn, *rest in self.steps]
            self.graph, self.capture_s, pool = _capture(
                side, lambda: self.fold(self.stores, self.rows, named))
            self._charge(dev, _nbytes(self.stores + [self.rows]) + pool)
            return self.stores
        for store, g in zip(self.stores, groups):
            torch.stack(g, out=store)
        self.rows.copy_(torch.from_numpy(flow_idx))
        self.graph.replay()
        return self.stores


class GraphCapture:
    """Recorder + executor for a captured DTD taskpool.

    Two strategies:

    * ``inline`` — replay every body in insertion order; on a card that
      replay is captured into one CUDA graph. Program size is O(tasks): one
      graph node per kernel each body launches.
    * ``scan`` — the DAG as a TASK INTERPRETER: tiles live in
      per-(shape, dtype) stacked stores, ops become descriptor rows (class
      id + store slots), and each step gathers its flows from the stores,
      runs its class's body and scatters its writes back. The rows are
      runtime DATA read from a device tensor, so any DAG with the same
      class sequence, op count and store geometry reuses the program. A
      CUDA graph bakes which body runs at each step, so the program key
      holds the class-id sequence as well (the reference's scan program is
      keyed on the classes alone, since its ``lax.switch`` picks the body
      from the row at run time); graph size stays O(tasks), each step's
      gathers and scatter added.

    ``auto`` picks inline below ``--mca capture_scan_threshold`` ops
    (default 64) and scan above it when the recording is scannable (no
    raw-array args; every write lands its store's dtype; scalar args are
    baked per class).
    """

    def __init__(self, tp, mode: Any = "auto") -> None:
        self.tp = tp
        if mode is True:
            mode = "auto"
        if mode not in ("auto", "inline", "scan"):
            output.fatal(f"capture mode {mode!r} not in auto|inline|scan")
        self.mode = mode
        #: per op: (fn, spec); spec entries are
        #: ("flow", tile_index, access) | ("scalar", value) | ("array", arr)
        self.ops: List[Tuple[Any, List[Tuple]]] = []
        #: per op, parallel to ``ops``: what a DEFER replay must restore —
        #: (priority, where, name, raw per-flow accesses incl. AFFINITY)
        self.op_extras: List[Tuple] = []
        self._tiles: List[Any] = []          # DTDTile, first-use order
        self._tile_ix: Dict[int, int] = {}   # id(tile) -> index
        self.cache_hit = False
        self.executions = 0
        self.last_mode: Optional[str] = None   # strategy of the last execute
        #: seconds that the last execution spent capturing and instantiating
        #: its CUDA graph (None: no capture — a cache hit, or the CPU)
        self.last_capture_s: Optional[float] = None
        #: the program of the last execution (its ``graph`` on a card)
        self.last_program: Optional[_Program] = None

    def _clear_recording(self) -> None:
        """Consume the recorded batch (execute, take_ops)."""
        self.ops = []
        self.op_extras = []
        self._tiles = []
        self._tile_ix = {}

    # ------------------------------------------------------------ recording
    def record(self, fn, args: Sequence[Any], jit: bool, name: str,
               priority: int = 0, where: Optional[int] = None) -> None:
        from .dtd import AFFINITY, DTDTile, RW
        defer = mca.get("capture_auto_defer", True)
        if not jit:
            if defer:
                raise CaptureDeferred(
                    f"insert of {name or fn!r} passed jit=False")
            output.fatal(f"graph capture requires jit-traceable bodies "
                         f"(insert of {name or fn!r} passed jit=False)")
        spec: List[Tuple] = []
        raw_accs: List[int] = []     # original access bits incl. AFFINITY:
        for a in args:               # a defer replay must restore them
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], DTDTile):
                tile, acc = a
                raw_accs.append(acc)
                acc &= ~AFFINITY           # placement is moot on one card
                spec.append(("flow", self._tile_index(tile), acc))
            elif isinstance(a, DTDTile):
                raw_accs.append(RW)
                spec.append(("flow", self._tile_index(a), RW))
            elif isinstance(a, (int, float, np.number)):
                spec.append(("scalar", a))
            elif isinstance(a, (np.ndarray, torch.Tensor)):
                spec.append(("array", a))
            else:
                if defer:
                    raise CaptureDeferred(
                        f"argument {a!r} of {name or fn!r} is not traceable")
                output.fatal(f"graph capture: argument {a!r} of "
                             f"{name or fn!r} is not traceable")
        self.ops.append((fn, spec))
        self.op_extras.append((priority, where, name, tuple(raw_accs)))

    def take_ops(self, fuse: bool = False) -> List[Tuple]:
        """Hand the recorded region back as replayable ``(fn, args,
        priority, where, name)`` inserts and reset the recording — the
        auto-defer hand-off: the deferring taskpool re-inserts them through
        the scheduler in the original program order (DTD sequential
        consistency makes that a valid serialization) with their original
        priorities, device masks and access bits, so nothing recorded
        before the non-capturable insert is lost or reordered.

        With ``fuse=True`` (``--mca region_fusion``), maximal runs of
        *fusable* recorded ops — default placement (no custom ``where``),
        no AFFINITY/NOTRACK bits, uniform priority — collapse into ONE
        super-task insert each: a single tensor function replaying the run
        in insertion order over the run's tiles with UNION accesses (one
        version bump per written tile per region, as capture lands). Each
        fused function carries ``_ptdtd_fused`` = the member count."""
        from ..core.task import DEV_ALL
        from .dtd import RW, WRITE
        ops, extras, tiles = self.ops, self.op_extras, self._tiles
        self._clear_recording()

        def per_task(i: int) -> Tuple:
            fn, spec = ops[i]
            prio, where, name, raw_accs = extras[i]
            args: List[Any] = []
            fi = 0
            for e in spec:
                if e[0] == "flow":
                    args.append((tiles[e[1]], raw_accs[fi]))
                    fi += 1
                else:
                    args.append(e[1])
            return (fn, args, prio, where, name)

        if not fuse:
            return [per_task(i) for i in range(len(ops))]

        def fusable(i: int) -> bool:
            # default placement only: a custom device mask, AFFINITY, or
            # NOTRACK bit must keep its own insert
            _prio, where, _name, raw_accs = extras[i]
            return where in (None, DEV_ALL) and \
                all((acc & ~RW) == 0 for acc in raw_accs)

        def fuse_run(lo: int, hi: int) -> Tuple:
            run = ops[lo:hi]
            t_ix: Dict[int, int] = {}     # recording tile ix -> local
            t_list: List[int] = []
            accs: List[int] = []
            for _fn, spec in run:
                for e in spec:
                    if e[0] == "flow":
                        li = t_ix.get(e[1])
                        if li is None:
                            li = t_ix[e[1]] = len(t_list)
                            t_list.append(e[1])
                            accs.append(0)
                        accs[li] |= e[2]
            written_l = [li for li in range(len(t_list)) if accs[li] & WRITE]
            arr_vals = [e[1] for _fn, spec in run for e in spec
                        if e[0] == "array"]

            def region_fn(*vals, _run=run, _t_ix=t_ix,
                          _written=tuple(written_l), _arrs=arr_vals):
                env = list(vals)
                GraphCapture._replay(
                    _run, lambda gi: env[_t_ix[gi]],
                    lambda gi, v: env.__setitem__(_t_ix[gi], v), _arrs)
                return tuple(env[li] for li in _written)

            region_fn._ptdtd_fused = hi - lo
            args = [(tiles[gi], accs[li]) for li, gi in enumerate(t_list)]
            prio, _w, name, _a = extras[lo]
            return (region_fn, args, prio, None,
                    f"fused[{hi - lo}]" + (f":{name}" if name else ""))

        rmin = int(mca.get("region_fusion_min", 2))
        rmax = int(mca.get("region_fusion_max", 128))
        out: List[Tuple] = []
        i, n = 0, len(ops)
        while i < n:
            if not fusable(i):
                out.append(per_task(i))
                i += 1
                continue
            j = i + 1
            while j < n and j - i < rmax and fusable(j) \
                    and extras[j][0] == extras[i][0]:   # uniform priority
                j += 1
            if j - i >= rmin:
                out.append(fuse_run(i, j))
            else:
                out.extend(per_task(k) for k in range(i, j))
            i = j
        return out

    def _tile_index(self, tile) -> int:
        ix = self._tile_ix.get(id(tile))
        if ix is None:
            ix = len(self._tiles)
            self._tile_ix[id(tile)] = ix
            self._tiles.append(tile)
        return ix

    # ------------------------------------------------------------ programs
    def _signature(self, tile_vals: List[Any], device) -> Tuple:
        op_sig = []
        for fn, spec in self.ops:
            entries = []
            for e in spec:
                if e[0] == "flow":
                    entries.append(e)                      # (kind, ix, acc)
                elif e[0] == "scalar":
                    entries.append(("scalar", e[1]))       # baked into trace
                else:
                    a = e[1]
                    entries.append(("array", tuple(a.shape), str(a.dtype)))
            op_sig.append((fn, tuple(entries)))
        tiles_sig = tuple((tuple(v.shape), str(v.dtype)) for v in tile_vals)
        # the device: a program never runs against another device than the
        # one it was made for
        return (tuple(op_sig), tiles_sig, str(device), device_fingerprint())

    def _written(self) -> List[int]:
        from .dtd import WRITE
        return sorted({e[1] for _, spec in self.ops for e in spec
                       if e[0] == "flow" and e[2] & WRITE})

    @staticmethod
    def _replay(ops, read, write, arr_vals) -> None:
        """The shared op fold: replay bodies in insertion order against tile
        read/write primitives (an env list for the eager replay; the static
        tiles, written in place, for a CUDA graph; a region's tiles for a
        fused super-task)."""
        from .dtd import WRITE
        ai = 0
        for fn, spec in ops:
            ins, wixs = [], []
            for e in spec:
                if e[0] == "flow":
                    ins.append(read(e[1]))
                    if e[2] & WRITE:
                        wixs.append(e[1])
                elif e[0] == "scalar":
                    ins.append(e[1])
                else:
                    ins.append(arr_vals[ai])
                    ai += 1
            for wi, out in zip(wixs, _outputs(fn(*ins))):
                write(wi, out)

    # ------------------------------------------------------ scan interpreter
    def _scan_plan(self, tile_vals: List[Any]):
        """Lower the recording to task-class form for the scan interpreter.

        Returns ``(stores, tile_loc, classes, rows)`` or None when the
        recording is not scannable:

        * ``stores``   — list of [tile_index...] per (shape, dtype) group;
        * ``tile_loc`` — tile_index -> (store_id, slot);
        * ``classes``  — list of (fn, slots) in first-appearance order,
          where slots is a tuple of ("flow", flow_pos, store_id, acc) |
          ("scalar", value) per body argument — scalar values are BAKED
          into the class (two ops differing in a scalar are two classes);
        * ``rows``     — per op: (class_id, [store slot per flow]).
        """
        self._scan_reject: Optional[str] = None
        store_ix: Dict[Tuple, int] = {}
        stores: List[List[int]] = []
        store_meta: List[Tuple[Tuple, Any]] = []   # sid -> (shape, dtype)
        tile_loc: List[Tuple[int, int]] = []
        for i, v in enumerate(tile_vals):
            key = (tuple(v.shape), v.dtype)
            sid = store_ix.get(key)
            if sid is None:
                sid = store_ix[key] = len(stores)
                stores.append([])
                store_meta.append(key)
            tile_loc.append((sid, len(stores[sid])))
            stores[sid].append(i)

        class_ix: Dict[Tuple, int] = {}
        classes: List[Tuple[Any, Tuple]] = []
        rows: List[Tuple[int, List[int]]] = []
        for fn, spec in self.ops:
            slots: List[Tuple] = []
            flow_slots: List[int] = []
            fp = 0
            for e in spec:
                if e[0] == "flow":
                    sid, slot = tile_loc[e[1]]
                    slots.append(("flow", fp, sid, e[2]))
                    flow_slots.append(slot)
                    fp += 1
                elif e[0] == "scalar":
                    slots.append(("scalar", e[1]))
                else:
                    self._scan_reject = "raw-array arguments"
                    return None          # raw-array args: not scannable
            ckey = (fn, tuple(slots))
            cid = class_ix.get(ckey)
            if cid is None:
                cid = class_ix[ckey] = len(classes)
                classes.append((fn, tuple(slots)))
            rows.append((cid, flow_slots))

        # dtype-compatibility gate: inline lands whatever dtype the body
        # RETURNS; the scan interpreter lands into the store, whose dtype is
        # the tile's INPUT dtype. A body that upcasts (f16 tiles -> f32
        # result) would silently round-trip intermediates through f16 every
        # step under scan — a precision change that must not depend on which
        # strategy 'auto' picks. Detect it on meta tensors (no FLOPs, no
        # launch) per class and reject scan so auto falls back to inline.
        for fn, slots in classes:
            reject = self._dtype_gate(fn, slots, store_meta)
            if reject is not None:
                self._scan_reject = reject
                return None
        return stores, tile_loc, classes, rows

    @staticmethod
    def _dtype_gate(fn, slots, store_meta) -> Optional[str]:
        """None if ``fn``'s written outputs land their stores' dtypes;
        otherwise the reject reason. ``fn`` runs on ``meta`` tensors of the
        stores' shapes and dtypes (every kernel wrapper answers those
        without a launch). Memoized: the verdict depends only on (fn,
        slots, store geometry), not on this flush's values."""
        key = (fn, slots,
               tuple(store_meta[sd[2]] for sd in slots if sd[0] == "flow"))
        with _cache_lock:
            if key in _dtype_gate_cache:
                _dtype_gate_cache.move_to_end(key)
                return _dtype_gate_cache[key]

        from .dtd import WRITE
        args, wstores = [], []
        for sd in slots:
            if sd[0] == "flow":
                _, fp, sid, acc = sd
                shape, dt = store_meta[sid]
                args.append(torch.empty(shape, dtype=dt, device="meta"))
                if acc & WRITE:
                    wstores.append(sid)
            else:
                args.append(sd[1])
        reject: Optional[str] = None
        try:
            outs = _outputs(fn(*args))
            for sid, o in zip(wstores, outs):
                if o.dtype != store_meta[sid][1]:
                    reject = (
                        f"body {_body_name(fn)!r} returns {o.dtype} into a "
                        f"{store_meta[sid][1]} store — scan would silently "
                        f"cast; use inline")
                    break
        except Exception as e:  # noqa: BLE001 — conservative: inline can
            reject = (f"body {fn!r} not abstractly "
                      f"evaluable ({type(e).__name__})")
        with _cache_lock:
            _dtype_gate_cache[key] = reject
            while len(_dtype_gate_cache) > _PROGRAM_CACHE_MAX:
                _dtype_gate_cache.popitem(last=False)
        return reject

    def _execute_scan(self, tile_vals, plan, dev, device):
        """Run the scan interpreter; returns (written tile indices, their
        values) for landing, the program key and the program."""
        stores, tile_loc, classes, rows = plan
        n_flows_max = max((len(fs) for _, fs in rows), default=0)
        class_seq = tuple(cid for cid, _ in rows)
        flow_idx = np.zeros((len(rows), max(n_flows_max, 1)), np.int64)
        order = [[fp for _, fps in _row_layout(slots) for fp in fps]
                 for _, slots in classes]
        for i, (cid, fs) in enumerate(rows):
            flow_idx[i, :len(fs)] = [fs[fp] for fp in order[cid]]
        sig = ("scan",
               tuple((fn, slots) for fn, slots in classes), class_seq,
               tuple((len(ixs),) + tuple(tile_vals[ixs[0]].shape)
                     + (str(tile_vals[ixs[0]].dtype),) for ixs in stores),
               len(rows), flow_idx.shape[1], str(device),
               device_fingerprint())
        prog, self.cache_hit = _program_cache.get_or_build(
            sig, lambda: _ScanProgram(classes, class_seq))
        written = self._written()
        by_store: Dict[int, List[int]] = collections.defaultdict(list)
        for ix in written:
            by_store[tile_loc[ix][0]].append(ix)
        vals: Dict[int, torch.Tensor] = {}
        try:
            with prog.lock:
                out_stores = self._run_program(
                    prog, lambda: prog.run(tile_vals, stores, flow_idx, dev))
                for sid, ixs in by_store.items():
                    slots = torch.tensor([tile_loc[ix][1] for ix in ixs],
                                         device=device)
                    landed = out_stores[sid].index_select(0, slots)
                    for k, ix in enumerate(ixs):
                        vals[ix] = landed[k]
        except BaseException:
            _program_cache.discard(sig)      # a program that failed goes
            raise
        return written, [vals[ix] for ix in written], sig, prog

    def _execute_inline(self, tile_vals, arr_vals, copies, dev, device):
        """Run the inline fold; the same returns as :meth:`_execute_scan`."""
        sig = self._signature(tile_vals, device)
        written = self._written()
        prog, self.cache_hit = _program_cache.get_or_build(
            sig, lambda: _InlineProgram(self.ops, written))
        try:
            with prog.lock:
                if dev is None:
                    results = prog.run_eager(tile_vals, arr_vals)
                else:
                    results = self._run_program(
                        prog, lambda: prog.run_cuda(copies, arr_vals, dev))
        except BaseException:
            _program_cache.discard(sig)      # a program that failed goes
            raise
        return written, results, sig, prog

    def _run_program(self, prog, run):
        """``run()``, recording the capture time of a first execution. A
        failed capture is kept in ``_capture_error`` and raised after the
        warm-up's results landed (see :meth:`execute`)."""
        self.last_capture_s = None
        try:
            out = run()
        except CaptureFailed as e:
            self._capture_error = e
            return [prog.static[i] for i in prog.written] \
                if isinstance(prog, _InlineProgram) else prog.stores
        if not self.cache_hit:
            self.last_capture_s = prog.capture_s
        return out

    # ------------------------------------------------------------ execution
    def _cuda_device(self):
        """The context's CUDA device module on a card context, else None."""
        ctx = self.tp.ctx
        if ctx.device.type != "cuda":
            return None
        from ..device.cuda import CUDADevice
        return next(d for d in ctx.devices.devices
                    if isinstance(d, CUDADevice))

    def _stage(self, dev) -> List[Any]:
        """The copy each tile executes on: its host copy (a CPU context;
        array payloads become tensors, persisted), or its CUDA device copy,
        staged from the newest copy where that is not it (persisted: the
        tile crosses to the card once across repeated executions) and
        pinned against eviction until :meth:`execute` unpins it."""
        from .dtd import RW
        copies = []
        try:
            for t in self._tiles:
                newest = t.data.newest_copy()
                if newest is None or newest.payload is None:
                    output.fatal(f"graph capture: tile {t!r} has no data")
                if dev is not None:
                    copies.append(dev._stage_in_copy(t.data, RW, pin=True))
                    continue
                if not isinstance(newest.payload, torch.Tensor):
                    newest.payload = torch.as_tensor(newest.payload)
                copies.append(newest)
        except BaseException:
            if dev is not None:
                for c in copies:
                    dev.unpin_copy(c)
            raise
        return copies

    def execute(self) -> None:
        if not self.ops:
            return
        dev = self._cuda_device()
        self._capture_error: Optional[CaptureFailed] = None
        if dev is None:
            self._execute(None)
            return
        # ordering: the capture's work runs on the device module's stream,
        # after everything queued there (the scheduler's writes of these
        # tiles) and on the caller's stream (tiles it filled on the card);
        # what follows on either (the next scheduled task, the caller's
        # reads) comes after the landing
        caller = torch.cuda.current_stream(dev.torch_device)
        dev.stream.wait_stream(caller)
        with dev._on_stream():
            self._execute(dev)
        caller.wait_stream(dev.stream)

    def _execute(self, dev) -> None:
        copies = self._stage(dev)
        try:
            prog = self._execute_staged(copies, dev)
        finally:
            if dev is not None:
                for c in copies:
                    dev.unpin_copy(c)
        if dev is not None and self._capture_error is None \
                and not self.cache_hit:
            _fit(dev, prog)
        if self._capture_error is not None:
            raise CaptureFailed(
                f"{self.tp.name}: the DAG ran once (its warm-up, whose "
                f"results landed) but could not be captured into a CUDA "
                f"graph: {self._capture_error}") from self._capture_error

    def _execute_staged(self, copies, dev):
        """Run the recording on the staged ``copies`` and land it; returns
        the program that ran."""
        tile_vals = [c.payload if dev is not None else
                     (c.payload if c.payload.device.type == "cpu"
                      else c.payload.cpu()) for c in copies]
        arr_vals = [e[1] for _, spec in self.ops for e in spec
                    if e[0] == "array"]
        if dev is None:
            arr_vals = [torch.as_tensor(a) for a in arr_vals]

        mode, plan = self.mode, None
        if mode == "auto":
            if len(self.ops) >= mca.get("capture_scan_threshold", 64):
                plan = self._scan_plan(tile_vals)
                if plan is None:
                    output.debug_verbose(
                        1, "capture", "auto: scan rejected ("
                        + (getattr(self, "_scan_reject", None) or "?")
                        + "); falling back to inline replay")
            mode = "scan" if plan is not None else "inline"
        elif mode == "scan":
            plan = self._scan_plan(tile_vals)
            if plan is None:
                # deterministic config error: consume the batch FIRST so
                # close()/fini() don't re-raise on the open action
                self._clear_recording()
                output.fatal("scan capture rejected: "
                             + (getattr(self, "_scan_reject", None)
                                or "recording is not scannable"))
        self.last_mode = mode
        device = dev.torch_device if dev is not None else torch.device("cpu")
        if mode == "scan":
            written, results, sig, prog = self._execute_scan(
                tile_vals, plan, dev, device)
        else:
            written, results, sig, prog = self._execute_inline(
                tile_vals, arr_vals, copies, dev, device)
        self.last_program = prog
        self._land(written, results, copies, dev)
        if self._capture_error is not None:
            _program_cache.discard(sig)
        self.executions += 1
        # consume: a later insert batch into the same pool starts a fresh
        # capture (wait() executes each batch exactly once)
        self._clear_recording()
        return prog

    def _land(self, written, results, copies, dev) -> None:
        """Land results exactly like task completions: the host copy on a
        CPU context (the CPU chore's tail), the CUDA device copy on a card
        (the device module's epilog), one version bump per written tile."""
        for ix, val in zip(written, results):
            data = self._tiles[ix].data
            if dev is None:
                host = data.get_copy(0)
                if host is None:
                    data.create_copy(0, val, COHERENCY_OWNED)
                else:
                    host.payload = val
                data.bump_version(0)
                continue
            copy = copies[ix]
            copy.payload = val
            data.bump_version(dev.device_index)
            dev._lru_touch(dev.res_key(data), copy)
