"""Input pipeline: background host prefetch + device staging.

The training-loop feed layer: batch assembly happens on CPU threads while
the device computes, and the NEXT batch's host→device copy overlaps the
CURRENT step.

* :class:`PrefetchLoader` — wraps any batch iterable; N worker threads
  run the (user) batch function ahead of consumption into a bounded
  queue (backpressure), then an optional device stage keeps ``ahead``
  batches already in flight to the device: on a card, pinned host tensors
  copied ``non_blocking`` on a side stream, each batch handed over with
  its ready event, which the consumer's stream waits for.
* :func:`token_batches` — the LM-side batch source: an infinite
  shuffled stream of (tokens, targets) windows from a corpus array, the
  same windows as the reference's for the same seed.

No torch DataLoader: plain threads + queues, torch copies. Deterministic
per seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel import compat
from ..parallel.moe import mesh_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(a, pin: bool) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.pin_memory() if pin and not t.is_pinned() else t


class PrefetchLoader:
    """Iterate ``source`` with background prefetch and device staging.

    ``source``: any iterable (or a zero-arg factory returning one, so the
    loader can be re-iterated). Worker threads pull items and apply
    ``fn`` (batch assembly — decode, augment, collate) off the consumer
    thread. With ``device`` (or ``sharding`` naming one device), the
    leaves of each finished batch (numpy arrays or tensors, in tuples,
    lists or dicts) become tensors on that device, ``ahead`` batches
    early. With ``sharding`` a
    :class:`~parsec_tpu_torch.parallel.compat.NamedSharding` over a rank
    mesh (every rank iterating the same source), each leaf becomes a
    DTensor on that sharding (``P("dp", None)`` splits the batch over
    ``dp``; a leaf with fewer dims than the spec takes its leading names):
    only the rank's local shard takes the device copy. On a card the workers pin
    the host tensors and, for a device stage, the copies run
    ``non_blocking`` on a side stream, and a batch is handed over only
    after the consumer's current stream has been made to wait for its
    copy's event (and its tensors recorded on that stream, so the caching
    allocator keeps them until the consumer is done): the consumer reads
    a batch in stream order with no host synchronisation.

    Ordering: with ``workers == 1`` (default) the stream order is
    preserved; with more workers, batches arrive in completion order.
    """

    def __init__(self, source, fn: Optional[Callable] = None,
                 workers: int = 1, prefetch: int = 4,
                 sharding=None, device=None, ahead: int = 2):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._factory = source if callable(source) else (lambda: source)
        self.fn = fn
        self.workers = workers
        self.prefetch = max(prefetch, workers)
        place = sharding if sharding is not None else device
        self.sharding = sharding if isinstance(
            sharding, compat.NamedSharding) else None
        if self.sharding is not None:
            self.place = compat.mesh_device(sharding.mesh)
        else:
            self.place = None if place is None else mesh_device(place)
        self.ahead = max(1, ahead)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        src = iter(self._factory())
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        src_lock = threading.Lock()
        stop = threading.Event()
        END = object()
        pin = self.place is not None and self.place.type == "cuda"

        def safe_put(msg) -> bool:
            """Bounded put that aborts when the consumer is gone: a plain
            q.put would block forever after an early consumer exit (the
            finally drains once, workers refill, then everyone hangs in
            the end-sentinel put) — one leaked thread per worker."""
            while not stop.is_set():
                try:
                    q.put(msg, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                err = None
                with src_lock:
                    try:
                        item = next(src)
                    except StopIteration:
                        break
                    except Exception as e:      # noqa: BLE001
                        err = e
                # puts happen OUTSIDE src_lock: blocking on a full queue
                # while holding the lock would stall every other worker
                if err is not None:
                    safe_put(("error", err))
                    return
                try:
                    out = self.fn(item) if self.fn is not None else item
                    if pin:
                        out = _tree_map(lambda a: _host_tensor(a, True), out)
                except Exception as e:          # noqa: BLE001
                    safe_put(("error", e))
                    return
                if not safe_put(("item", out)):
                    return
            safe_put(("end", END))

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"prefetch-{i}")
                   for i in range(self.workers)]
        for t in threads:
            t.start()

        def raw():
            ended = 0
            try:
                while ended < self.workers:
                    kind, val = q.get()
                    if kind == "end":
                        ended += 1
                        continue
                    if kind == "error":
                        stop.set()
                        raise val
                    yield val
            finally:
                stop.set()
                # drain so blocked workers can observe stop and exit
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break

        if self.place is None:
            yield from raw()
            return
        put, hand = self._device_stage()
        pending = []
        for batch in raw():
            pending.append(put(batch))
            if len(pending) > self.ahead:
                yield hand(*pending.pop(0))
        for staged in pending:
            yield hand(*staged)

    def _device_stage(self):
        """(put, hand): ``put(batch)`` starts the batch's copy and returns
        (batch on the device, its ready event or None); ``hand`` makes the
        consumer's stream wait for the event and returns the batch."""
        place = self.place
        if place.type != "cuda":
            def put(b):
                return _tree_map(lambda a: _host_tensor(a, False).to(place),
                                 b), None

            def hand(b, _ev):
                return b
        else:
            side = torch.cuda.Stream(place)

            def put(b):
                # no wait for the consumer's stream: the copy overlaps the
                # step it is running (the side stream's blocks are recorded
                # on the consumer's stream at the hand-over, and a pinned
                # source block is held by the host allocator until its copy
                # is done)
                with torch.cuda.stream(side):
                    out = _tree_map(lambda t: t.to(place, non_blocking=True),
                                    b)
                    ready = torch.cuda.Event()
                    ready.record(side)
                return out, ready

            def hand(b, ready):
                cur = torch.cuda.current_stream(place)
                cur.wait_event(ready)
                _tree_map(lambda t: t.record_stream(cur), b)
                return b

        if self.sharding is None:
            return put, hand
        mesh, spec = self.sharding.mesh, self.sharding.spec

        def put_shards(b):
            # only this rank's shard of each leaf takes the copy above; the
            # global shapes ride along, in the leaves' order
            shapes = []

            def cut(a):
                t = _host_tensor(a, False)
                shapes.append((t.shape, spec[:t.ndim]))
                return compat.local_slice(t, mesh, spec[:t.ndim]).contiguous()
            out, ready = put(_tree_map(cut, b))
            return (out, shapes), ready

        def hand_shards(b, ready):
            local, shapes = b
            it = iter(shapes)

            def wrap(t):
                shape, s = next(it)
                return compat.from_local(t, mesh, s, shape)
            return _tree_map(wrap, hand(local, ready))

        return put_shards, hand_shards

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        src = self._factory()
        try:
            return len(src)
        except TypeError:
            raise TypeError("underlying source has no length") from None


def token_batches(corpus, batch: int, seq_len: int, seed: int = 0,
                  n_batches: Optional[int] = None):
    """An infinite (or ``n_batches``-bounded) stream of LM training pairs
    ``(tokens, targets)`` — random ``seq_len + 1`` windows of ``corpus``
    (1D int array), shuffled deterministically per ``seed`` (numpy int32
    arrays, the reference's windows for the same corpus and seed). Feed
    it to :class:`PrefetchLoader` and a ``make_lm_*_train_step`` step."""
    corpus = np.asarray(corpus)
    if corpus.ndim != 1:
        raise ValueError("corpus must be a 1D token array")
    # valid starts: s + seq_len + 1 <= size, i.e. s in [0, size - seq_len)
    hi = corpus.size - seq_len
    if hi <= 0:
        raise ValueError(f"corpus of {corpus.size} tokens is shorter than "
                         f"seq_len + 1 = {seq_len + 1}")
    rng = np.random.default_rng(seed)

    def gen():
        i = 0
        while n_batches is None or i < n_batches:
            starts = rng.integers(0, hi, size=batch)
            win = np.stack([corpus[s:s + seq_len + 1] for s in starts])
            yield win[:, :-1].astype(np.int32), win[:, 1:].astype(np.int32)
            i += 1

    return gen()
