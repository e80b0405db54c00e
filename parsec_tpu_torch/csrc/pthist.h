// Native task-latency histograms for the execution/communication lanes.
//
// The latency half of the lane observability contract: the
// ROADMAP's serving north star is "bounded p99 task latency", which no
// counter can express — counters sum, distributions don't. These are
// fixed-bucket log2 histograms in the HdrHistogram style: the bucket
// index is (exponent, sub-bucket) where SUB_BITS sub-buckets split each
// power of two, giving ~12.5% relative resolution at any magnitude with
// a FIXED 496-entry array — no allocation ever happens on the record
// path, and a bump is one relaxed fetch_add (plus two for count/sum).
//
// Gating mirrors ptrace_ring.h: each engine object embeds a
// `std::atomic<State<NH> *>` published with release/acquire; an engine
// call loads it once and event sites pay one predictable null branch
// when histograms are off. The hot execution lanes additionally
// AMORTIZE: per-task execute latency is recorded per batch
// (duration/batch_size bumped batch_size times in one call) and
// ready-queue wait is sampled 1-in-8 by task id, so the armed cost on
// the 10M tasks/s chain walk stays inside the same <2% envelope as the
// trace rings.
//
// The Python histogram reader mirrors the bucket math, sums snapshots across
// live lanes, and summarizes p50/p99/p999 for the counter registry and
// the /metrics endpoint.

#ifndef PARSEC_TPU_PTHIST_H
#define PARSEC_TPU_PTHIST_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace pthist {

constexpr int SUB_BITS = 3;                 // 8 sub-buckets per power of 2
constexpr int SUBS = 1 << SUB_BITS;
constexpr int NBUCKETS = (64 - SUB_BITS + 1) * SUBS;   // 496

// bucket index for a nanosecond value (negative values clamp to 0).
// u < SUBS maps exactly; above that (exp, top-SUB_BITS-mantissa) — the
// sequence is continuous at u == SUBS (the Python reader mirrors this).
inline int bucket_of(int64_t v) {
    uint64_t u = v > 0 ? (uint64_t)v : 0;
    if (u < (uint64_t)SUBS) return (int)u;
    int e = 63 - __builtin_clzll(u);
    int idx = ((e - SUB_BITS + 1) << SUB_BITS) |
              (int)((u >> (e - SUB_BITS)) & (uint64_t)(SUBS - 1));
    return idx < NBUCKETS ? idx : NBUCKETS - 1;
}

struct Hist {
    std::atomic<uint64_t> b[NBUCKETS];
    std::atomic<uint64_t> count;
    std::atomic<uint64_t> sum;      // total ns across all recorded values

    Hist() : count(0), sum(0) {
        for (int i = 0; i < NBUCKETS; i++)
            b[i].store(0, std::memory_order_relaxed);
    }

    // record `n` occurrences of value `v` ns (the batch-amortized form:
    // one call per dispatch batch, n = batch size, v = duration/n)
    inline void add(int64_t v, uint64_t n = 1) {
        b[bucket_of(v)].fetch_add(n, std::memory_order_relaxed);
        count.fetch_add(n, std::memory_order_relaxed);
        sum.fetch_add((uint64_t)(v > 0 ? v : 0) * n,
                      std::memory_order_relaxed);
    }
};

template <int NH>
struct State {
    std::atomic<bool> enabled{true};
    Hist h[NH];
};

// ------------------------------------------------------------ Python API
// Shared method bodies, mirroring ptrace_ring.h's py_trace_* helpers.

// hist_enable(): allocate + publish the zeroed State (idempotent — a
// re-enable after disable keeps the accumulated buckets).
template <int NH>
inline PyObject *py_hist_enable(std::atomic<State<NH> *> &slot) {
    State<NH> *st = slot.load(std::memory_order_acquire);
    if (!st) {                     // GIL held: no competing creator
        st = new (std::nothrow) State<NH>();
        if (!st) return PyErr_NoMemory();
        slot.store(st, std::memory_order_release);
    } else {
        st->enabled.store(true, std::memory_order_release);
    }
    Py_RETURN_NONE;
}

template <int NH>
inline PyObject *py_hist_disable(State<NH> *st) {
    if (st) st->enabled.store(false, std::memory_order_release);
    Py_RETURN_NONE;
}

// hist_snapshot() -> {name: (count, sum_ns, buckets_bytes)} where
// buckets_bytes packs NBUCKETS little-endian u64 counts ("<496Q").
template <int NH>
inline PyObject *py_hist_snapshot(State<NH> *st,
                                  const char *const names[NH]) {
    PyObject *out = PyDict_New();
    if (!out || !st) return out;
    for (int i = 0; i < NH; i++) {
        Hist &h = st->h[i];
        PyObject *b = PyBytes_FromStringAndSize(
            nullptr, (Py_ssize_t)(NBUCKETS * sizeof(uint64_t)));
        if (!b) { Py_DECREF(out); return nullptr; }
        uint64_t *dst = reinterpret_cast<uint64_t *>(PyBytes_AS_STRING(b));
        for (int j = 0; j < NBUCKETS; j++)
            dst[j] = h.b[j].load(std::memory_order_relaxed);
        PyObject *tup = Py_BuildValue(
            "(KKN)",
            (unsigned long long)h.count.load(std::memory_order_relaxed),
            (unsigned long long)h.sum.load(std::memory_order_relaxed), b);
        if (!tup || PyDict_SetItemString(out, names[i], tup) < 0) {
            Py_XDECREF(tup);
            Py_DECREF(out);
            return nullptr;
        }
        Py_DECREF(tup);
    }
    return out;
}

}  // namespace pthist

#endif  // PARSEC_TPU_PTHIST_H
