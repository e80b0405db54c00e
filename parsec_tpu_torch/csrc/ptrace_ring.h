// In-lane event tracing for the native execution engines (ptexec, ptdtd).
//
// The observability half of the lane contract: the reference
// instruments its ACTUAL hot path (parsec/profiling.c per-ES buffers,
// PINS callback chains); once our task FSMs moved into C, enabling the
// Python profilers silently ejected pools back onto a ~100x-slower
// interpreted machine — the recorded trace described a machine that never
// runs in production. These rings record events INSIDE the lane instead:
//
//  * per-WORKER fixed-capacity rings: one engine call (Graph.run /
//    Engine.drain_ready / Engine.insert_many) claims a ring for its
//    duration, so each ring has exactly ONE producer at a time and the
//    drain (Python, GIL held) is the single consumer — a classic SPSC
//    hand-off on two atomic cursors, no locks on the record path;
//  * events are (key, id, flags, monotonic-ns) — 24 bytes, one relaxed
//    store each; the whole facility is gated by a single relaxed-atomic
//    enabled flag (a null `Writer.st` — one predictable branch per event
//    site when tracing is off, zero allocations);
//  * overflow NEVER blocks the lane: a full ring drops the event and
//    bumps the ring's drop counter (drop accounting is part of the trace
//    contract — `trace.events_dropped` in the counter registry);
//  * the drain hands each ring's pending span to Python as one packed
//    bytes object (struct layout "<qqII": t_ns, id, key, flags) which
//    the Python trace bridge lands into the PBP dictionary/streams.
//
// Timestamps are steady_clock ns — CLOCK_MONOTONIC on glibc, the same
// clock CPython's time.perf_counter() reads on Linux; the Python bridge
// still calibrates an offset at attach so the epoch assumption is not
// load-bearing.

#ifndef PARSEC_TPU_PTRACE_RING_H
#define PARSEC_TPU_PTRACE_RING_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>

namespace ptrace_ring {

constexpr uint32_t FLAG_START = 0x1;   // mirror the trace module's EVENT_FLAG_*
constexpr uint32_t FLAG_END = 0x2;
constexpr uint32_t FLAG_POINT = 0x4;

constexpr int MAX_RINGS = 64;
constexpr int DEFAULT_RINGS = 16;
constexpr uint32_t DEFAULT_CAP = 1 << 16;

inline int64_t now_ns() {
    return (int64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

struct Event {          // 24 bytes, packed struct fmt "<qqII"
    int64_t t_ns;
    int64_t id;
    uint32_t key;
    uint32_t flags;
};

struct Ring {
    Event *buf = nullptr;
    uint32_t cap = 0;
    std::atomic<uint64_t> head{0};     // producer cursor (claimed caller)
    std::atomic<uint64_t> tail{0};     // consumer cursor (Python drain)
    std::atomic<uint64_t> dropped{0};  // events lost to overflow (cumulative)
    std::atomic<int> busy{0};          // claimed by a running engine call
};

struct State {
    std::atomic<bool> enabled{false};
    Ring *rings = nullptr;
    int nrings = 0;
    // engine calls that found every ring claimed record nothing; their
    // would-be events count here so the drop accounting stays honest
    std::atomic<uint64_t> unclaimed{0};

    bool enable(int n, uint32_t cap) {
        if (rings) {                   // idempotent: keep the first config
            enabled.store(true, std::memory_order_release);
            return true;
        }
        if (n <= 0) n = DEFAULT_RINGS;
        if (n > MAX_RINGS) n = MAX_RINGS;
        if (cap < 16) cap = 16;
        Ring *r = new (std::nothrow) Ring[(size_t)n];
        if (!r) return false;
        for (int i = 0; i < n; i++) {
            r[i].buf = new (std::nothrow) Event[cap];
            if (!r[i].buf) {
                for (int j = 0; j < i; j++) delete[] r[j].buf;
                delete[] r;
                return false;
            }
            r[i].cap = cap;
        }
        rings = r;
        nrings = n;
        enabled.store(true, std::memory_order_release);
        return true;
    }

    void disable() { enabled.store(false, std::memory_order_release); }

    uint64_t total_dropped() const {
        uint64_t d = unclaimed.load(std::memory_order_relaxed);
        for (int i = 0; i < nrings; i++)
            d += rings[i].dropped.load(std::memory_order_relaxed);
        return d;
    }

    ~State() {
        for (int i = 0; i < nrings; i++) delete[] rings[i].buf;
        delete[] rings;
    }
};

// One engine call's claim on a ring. open() scans for a free ring with a
// CAS (bounded: MAX_RINGS tries). Event sites gate on `st` (null iff
// tracing is off — one predictable branch); with tracing ON but every
// ring claimed, `r` stays null and rec() counts the lost events into
// State::unclaimed so the drop accounting stays honest. Destructor
// releases the claim, so early returns / error paths cannot leak a busy
// ring.
struct Writer {
    Ring *r = nullptr;
    State *st = nullptr;

    void open(State *state) {
        // acquire pairs with enable()'s release store: a worker that sees
        // enabled==true also sees the fully-built rings/nrings (the
        // engines likewise load their State pointer with acquire)
        if (!state || !state->enabled.load(std::memory_order_acquire))
            return;
        for (int i = 0; i < state->nrings; i++) {
            int expect = 0;
            if (state->rings[i].busy.compare_exchange_strong(
                    expect, 1, std::memory_order_acquire)) {
                r = &state->rings[i];
                st = state;
                return;
            }
        }
        st = state;   // all claimed: record() counts into unclaimed
    }

    inline void rec(uint32_t key, int64_t id, uint32_t flags) {
        if (!r) {
            if (st) st->unclaimed.fetch_add(1, std::memory_order_relaxed);
            return;
        }
        uint64_t h = r->head.load(std::memory_order_relaxed);
        uint64_t t = r->tail.load(std::memory_order_acquire);
        if (h - t >= r->cap) {         // full: drop, never block the lane
            r->dropped.fetch_add(1, std::memory_order_relaxed);
            return;
        }
        Event &e = r->buf[h % r->cap];
        e.t_ns = now_ns();
        e.id = id;
        e.key = key;
        e.flags = flags;
        r->head.store(h + 1, std::memory_order_release);
    }

    void close() {
        if (r) {
            r->busy.store(0, std::memory_order_release);
            r = nullptr;
        }
        st = nullptr;
    }

    ~Writer() { close(); }
};

// ------------------------------------------------------------ Python API
// The method bodies shared by both extensions. Each embeds a
// `std::atomic<State *> trace` in its object struct: engine calls run
// with the GIL dropped while trace_enable (GIL held) publishes the
// State, so the pointer itself needs release/acquire ordering.

// trace_enable(nrings=DEFAULT_RINGS, capacity=DEFAULT_CAP) -> (nrings, cap)
inline PyObject *py_trace_enable(std::atomic<State *> &slot, PyObject *args) {
    int nrings = DEFAULT_RINGS;
    unsigned int cap = DEFAULT_CAP;
    if (!PyArg_ParseTuple(args, "|iI", &nrings, &cap)) return nullptr;
    State *st = slot.load(std::memory_order_acquire);
    if (!st) {                         // trace_enable holds the GIL: no
        st = new (std::nothrow) State();   // competing creator
        if (!st) return PyErr_NoMemory();
        if (!st->enable(nrings, (uint32_t)cap)) {
            delete st;
            return PyErr_NoMemory();
        }
        slot.store(st, std::memory_order_release);
    } else if (!st->enable(nrings, (uint32_t)cap)) {
        return PyErr_NoMemory();
    }
    return Py_BuildValue("(iI)", st->nrings,
                         (unsigned int)st->rings[0].cap);
}

inline PyObject *py_trace_disable(State *slot) {
    if (slot) slot->disable();
    Py_RETURN_NONE;
}

// trace_drain() -> list[(ring_id, bytes)] — consumes each ring's pending
// span. Safe against concurrent producers (SPSC cursors); called with the
// GIL held from the Python bridge.
inline PyObject *py_trace_drain(State *slot) {
    PyObject *out = PyList_New(0);
    if (!out || !slot) return out;
    for (int i = 0; i < slot->nrings; i++) {
        Ring &ring = slot->rings[i];
        uint64_t t = ring.tail.load(std::memory_order_relaxed);
        uint64_t h = ring.head.load(std::memory_order_acquire);
        if (h == t) continue;
        uint64_t n = h - t;
        PyObject *b = PyBytes_FromStringAndSize(nullptr,
                                                (Py_ssize_t)(n * sizeof(Event)));
        if (!b) { Py_DECREF(out); return nullptr; }
        char *dst = PyBytes_AS_STRING(b);
        for (uint64_t k = 0; k < n; k++) {
            std::memcpy(dst + k * sizeof(Event),
                        &ring.buf[(t + k) % ring.cap], sizeof(Event));
        }
        ring.tail.store(h, std::memory_order_release);
        PyObject *pair = Py_BuildValue("(iN)", i, b);
        if (!pair || PyList_Append(out, pair) < 0) {
            Py_XDECREF(pair);
            Py_DECREF(out);
            return nullptr;
        }
        Py_DECREF(pair);
    }
    return out;
}

inline PyObject *py_trace_dropped(State *slot) {
    return PyLong_FromUnsignedLongLong(slot ? slot->total_dropped() : 0);
}

}  // namespace ptrace_ring

#endif  // PARSEC_TPU_PTRACE_RING_H
