// parsec_tpu_torch._ptdtd — the DTD dependency engine as a CPython extension.
//
// Stands where the reference's C insert path stands
// (parsec/interfaces/dtd/insert_function.c:3617 parsec_dtd_insert_task ->
// parsec_dtd_set_params_of_task insert_function.c:2896 and the release walk
// parsec_dtd_ordering_correctly, insert_function_internal.h:277): runtime
// dependency discovery over per-tile last-writer/reader chains, the
// insertion-guard count-then-activate protocol, and the successor release
// that collects newly-ready tasks.
//
// Why a CPython extension and not ctypes: this is called ONCE PER TASK on
// the insert and completion hot paths; a ctypes boundary costs ~2 us while
// a C-extension method call costs ~0.2 us (on one x86 host core; the
// package's native.py builds this file with the host C++ compiler).
//
// TWO LANES share the chain state:
//
//  * the per-task lane (insert/activate/complete) — one C call per task,
//    ids surfaced to Python, which owns the task objects and runs bodies
//    through the ordinary scheduling FSM. v1 of this engine.
//  * the BATCHED lane (register_class/insert_many/drain_ready) — the
//    whole insert->link->ready->execute->release cycle stays inside the
//    engine in batches. insert_many() links N tasks under ONE GIL drop
//    (the count-then-activate protocol per task is preserved: the guard
//    is held across the link and dropped only once the task is fully
//    recorded — with the engine mutex held for the whole batch, a
//    concurrent complete() can never observe a half-linked task).
//    Ready batch-lane tasks never surface to Python as ids: drain_ready()
//    pops them, gathers their flow payloads from the per-tile payload
//    slots (Python owns the VALUES, C owns the slot lifetimes — the
//    ptexec data-mode split), invokes the class's batched callback once
//    per (class, batch), lands the written payloads back into the tile
//    slots, and feeds the release walk directly back into the ready
//    structure. Only per-task-lane successors released by a batch
//    completion come back to Python (the `surfaced` tuple).
//
// Scope: the SINGLE-RANK engine. Distributed inserts, the replay auditor,
// and remote version bookkeeping stay in the Python engine (dsl/dtd.py
// _link_tile) — they are protocol-bound, not insert-rate-bound. The Python
// side gates which engine (and which lane) a taskpool uses.
//
// Concurrency: chain/task/tile/ready state is guarded by an internal
// mutex (v1 relied on the GIL; insert_many drops the GIL for the link
// walk, so concurrent inserter threads now scale on real cores and every
// entry point locks). Python OBJECT references (tile payload slots, task
// value tuples, class callbacks) are only created/destroyed while the
// GIL is held; INCREFs may happen under the mutex but DECREFs (which can
// run arbitrary __del__) and allocations are always deferred until the
// mutex is released, so a finalizer can never re-enter the engine under
// its own lock. Task/tile records live in growing arrays; ids are
// indices and are never recycled (a completed task id may persist as a
// tile's last_writer).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <new>
#include <vector>

#include "ptcomm_iface.h"
#include "ptdev_iface.h"
#include "pthist.h"
#include "ptrace_ring.h"
#include "ptsched.h"

namespace {

constexpr int32_t ACC_READ = 0x1;    // mirrors dsl/dtd.py READ
constexpr int32_t ACC_WRITE = 0x2;   // mirrors dsl/dtd.py WRITE

// in-lane trace event keys (registered in the PBP dictionary by
// the native trace bridge; ring contract in ptrace_ring.h)
// ids: EV_LINK — the batch size linked; EV_TASK/EV_PT_DONE — the task id;
// EV_PT_LINK — 1 (one task linked). The per-task lane's events carry keys
// of their own: its tasks also fire the Python PINS events, which the
// trace bridge's coarse drain markers must not count a second time.
constexpr uint32_t EV_LINK = 1;     // one interval per insert_many link batch
constexpr uint32_t EV_EXEC = 2;     // one interval per (class, batch) dispatch
constexpr uint32_t EV_TASK = 3;     // one point per batch-lane task completion
constexpr uint32_t EV_PT_LINK = 4;  // one interval per per-task insert
constexpr uint32_t EV_PT_DONE = 5;  // one point per per-task completion

// latency histogram slots (pthist.h; names mirrored by the histogram reader)
constexpr int H_EXEC = 0;     // per-task (class,batch) latency, amortized
constexpr int H_READY = 1;    // batch-lane ready-push -> drain-pop wait
// per-task lane: ready (activate() or a predecessor's complete()) ->
// complete(), the task's whole stay in the Python scheduler and the
// device module — a queue wait plus its execution, not an exec time
constexpr int H_PT_DONE = 2;
constexpr int N_HISTS = 3;
const char *const HIST_NAMES[N_HISTS] = {"exec_ns", "ready_wait_ns",
                                         "pt_ready_to_done_ns"};

// flows a task may carry. The engine this file was copied from took 64,
// which refused the GEMM_K body of a k-chain of 32 tiles (2 * 32 + 1 = 65
// flows: the main path's DTD GEMM at N = 16384, TS = 512). Three places
// read it: the per-task insert (which sizes its stack arrays by it),
// register_class and insert_many. So a class of 65 to 1024 flows also
// rides the batched lane here, where the 64-flow engine refused it.
constexpr Py_ssize_t PT_FLOWS_MAX = 1024;

struct TaskRec {
    int32_t deps_remaining = 1;   // the insertion-in-progress guard
    bool completed = false;
    uint32_t stamp = 0;           // pred-dedup visit stamp
    int32_t cls = -1;             // batch-lane class id (-1: per-task lane)
    int64_t ready_ns = 0;         // ready-push stamp (histograms; under mu)
    int64_t flow_off = 0;         // into the flow arena (batch lane only)
    int32_t flow_n = 0;
    PyObject *vals = nullptr;     // by-value args tuple (batch lane, owned)
    std::vector<int64_t> succs;
};

struct TileRec {
    int64_t last_writer = -1;
    int32_t compact_at = 32;      // reader-list compaction watermark
    std::vector<int64_t> readers;
    PyObject *payload = nullptr;  // batch-lane payload slot (owned)
    int64_t writes = 0;           // batch-lane writes since last slot_sync
};

struct ClassRec {
    PyObject *cb = nullptr;            // batched callback (owned)
    PyObject *retire = nullptr;        // post-landing accounting cb (owned)
    std::vector<int32_t> argmap;       // body arg -> flow index, -1 = value
    std::vector<int32_t> accs;         // per-flow access bits
    int32_t nvals = 0;                 // count of -1 entries in argmap
    int32_t nwrites = 0;               // count of WRITE flows
    int32_t pool = -1;                 // scheduler-plane pool handle (the
                                       // QoS identity of the owning
                                       // taskpool; -1 = private ready)
    int32_t device = 0;                // 1 = device-bodied: ready tasks
                                       // surface onto the ptdev lane
                                       // (dev_bind) instead of `ready`
};

struct Engine {
    PyObject_HEAD
    std::mutex *mu;               // guards everything below except refcounts
    std::vector<TaskRec> *tasks;
    std::vector<TileRec> *tiles;
    std::vector<ClassRec> *classes;
    std::vector<int64_t> *flow_tile;   // batch-lane flow arena
    std::vector<int64_t> *flow_acc;
    std::vector<int64_t> *ready;       // ready batch-lane task ids (LIFO)
    uint32_t stamp;
    int64_t live;                 // inserted - completed
    int64_t batch_done;           // batch-lane tasks executed (diagnostics)
    bool poisoned;                // a batch callback raised
    // remote-ingest surfacing (the comm lane's ptdtd entry point): ready
    // PER-TASK-LANE tasks released by an arrived remote dep park here
    // until the next drain_ready() hands them to Python for scheduling
    std::vector<int64_t> *rsurf;
    std::atomic<int64_t> acts_rx;      // remote decrements ingested
    std::atomic<int64_t> ingest_bad;   // out-of-range/completed ids
    // in-lane event rings (null until trace_enable)
    std::atomic<ptrace_ring::State *> trace;
    // latency histograms (null until hist_enable)
    std::atomic<pthist::State<N_HISTS> *> hist;
    // scheduler plane (sched_bind): ready batch-lane tasks of
    // pool-bound classes enter the shared plane instead of `ready`, so N
    // concurrent DTD taskpools drain by DRR weight; classes without a
    // pool (plane off, pre-plane pools) keep the private vector
    ptsched::Plane *splane;
    PyObject *sched_cap;
    // device lane (dev_bind): ready tasks of device-marked
    // classes surface onto the ptdev lane's MPSC queue (GIL-free) and
    // come back through dev_retire() — wired at the engine level; the
    // Python DTD front end keeps device pools on the interpreted device
    // module this PR (counted ineligible), the ptcomm precedent
    bool dev_bound;
    uint32_t dev_pool;
    PtDevSubmitVtbl dsend;
    std::atomic<int64_t> dev_tx;
    std::atomic<int64_t> dev_done;
    std::atomic<int64_t> dev_bad;
};

PyObject *engine_new(PyTypeObject *type, PyObject *, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    self->mu = new (std::nothrow) std::mutex();
    self->tasks = new (std::nothrow) std::vector<TaskRec>();
    self->tiles = new (std::nothrow) std::vector<TileRec>();
    self->classes = new (std::nothrow) std::vector<ClassRec>();
    self->flow_tile = new (std::nothrow) std::vector<int64_t>();
    self->flow_acc = new (std::nothrow) std::vector<int64_t>();
    self->ready = new (std::nothrow) std::vector<int64_t>();
    self->rsurf = new (std::nothrow) std::vector<int64_t>();
    self->stamp = 0;
    self->live = 0;
    self->batch_done = 0;
    self->poisoned = false;
    new (&self->acts_rx) std::atomic<int64_t>(0);
    new (&self->ingest_bad) std::atomic<int64_t>(0);
    new (&self->trace) std::atomic<ptrace_ring::State *>(nullptr);
    new (&self->hist) std::atomic<pthist::State<N_HISTS> *>(nullptr);
    self->splane = nullptr;
    self->sched_cap = nullptr;
    self->dev_bound = false;
    self->dev_pool = 0;
    self->dsend = PtDevSubmitVtbl{0, nullptr, nullptr};
    new (&self->dev_tx) std::atomic<int64_t>(0);
    new (&self->dev_done) std::atomic<int64_t>(0);
    new (&self->dev_bad) std::atomic<int64_t>(0);
    if (!self->mu || !self->tasks || !self->tiles || !self->classes ||
        !self->flow_tile || !self->flow_acc || !self->ready ||
        !self->rsurf) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    return reinterpret_cast<PyObject *>(self);
}

void engine_dealloc(PyObject *obj) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    if (self->tasks)
        for (auto &t : *self->tasks) Py_XDECREF(t.vals);
    if (self->tiles)
        for (auto &t : *self->tiles) Py_XDECREF(t.payload);
    if (self->classes)
        for (auto &c : *self->classes) {
            Py_XDECREF(c.cb);
            Py_XDECREF(c.retire);
        }
    delete self->mu;
    delete self->tasks;
    delete self->tiles;
    delete self->classes;
    delete self->flow_tile;
    delete self->flow_acc;
    delete self->ready;
    delete self->rsurf;
    delete self->trace.load(std::memory_order_acquire);
    delete self->hist.load(std::memory_order_acquire);
    Py_CLEAR(self->sched_cap);   // pool handles are owned by the Python
    Py_TYPE(obj)->tp_free(obj);  // side (core/sched_plane.py unregisters)
}

// tile() -> int : register a new tile chain (payload slot starts empty)
PyObject *engine_tile(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    Py_ssize_t nid;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        self->tiles->emplace_back();
        nid = (Py_ssize_t)self->tiles->size() - 1;
    }
    return PyLong_FromSsize_t(nid);
}

// The chain-link walk shared by both lanes. MUST be called with mu held.
// Links one task's flows into the tile chains and returns its id with the
// insertion guard STILL HELD (deps_remaining = 1 + discovered preds).
//
// Replicates dsl/dtd.py _link_tile single-rank semantics exactly:
//   READ (or access without WRITE): RAW pred on the live last writer;
//     the task joins the tile's reader list (amortized compaction of
//     completed readers past the doubling watermark).
//   WRITE: WAR preds on live readers, WAW pred on the live last writer;
//     the tile chain then points at this task and the reader list resets.
// Preds are deduplicated (visit stamps) and self-edges skipped; each live
// pred gains a successor edge and bumps this task's dep count.
int64_t link_locked(Engine *self, const int64_t *tixs, const int64_t *laccs,
                    Py_ssize_t nflows) {
    std::vector<TaskRec> &tasks = *self->tasks;
    std::vector<TileRec> &tiles = *self->tiles;
    const int64_t tid = (int64_t)tasks.size();
    tasks.emplace_back();
    self->live++;
    if (++self->stamp == 0) {     // stamp wrapped: clear all (rare)
        for (auto &t : tasks) t.stamp = 0;
        self->stamp = 1;
    }
    const uint32_t stamp = self->stamp;
    int32_t new_deps = 0;

    for (Py_ssize_t i = 0; i < nflows; i++) {
        int64_t tix = tixs[i];
        int64_t acc = laccs[i];
        TileRec &tile = tiles[(size_t)tix];
        const bool is_read = (acc & ACC_READ) || !(acc & ACC_WRITE);
        if (is_read) {
            int64_t lw = tile.last_writer;
            if (lw >= 0 && !tasks[(size_t)lw].completed &&
                lw != tid && tasks[(size_t)lw].stamp != stamp) {
                tasks[(size_t)lw].stamp = stamp;
                tasks[(size_t)lw].succs.push_back(tid);
                new_deps++;
            }
            if (!(acc & ACC_WRITE)) {   // pure READ joins the reader list
                if ((int32_t)tile.readers.size() >= tile.compact_at) {
                    size_t w = 0;       // prune completed readers in place
                    for (size_t r = 0; r < tile.readers.size(); r++)
                        if (!tasks[(size_t)tile.readers[r]].completed)
                            tile.readers[w++] = tile.readers[r];
                    tile.readers.resize(w);
                    int32_t dbl = 2 * (int32_t)(w + 1);
                    tile.compact_at = dbl > 32 ? dbl : 32;
                }
                tile.readers.push_back(tid);
            }
        }
        if (acc & ACC_WRITE) {
            for (int64_t r : tile.readers) {
                if (r == tid) continue;
                TaskRec &rr = tasks[(size_t)r];
                if (!rr.completed && rr.stamp != stamp) {
                    rr.stamp = stamp;
                    rr.succs.push_back(tid);
                    new_deps++;
                }
            }
            int64_t lw = tile.last_writer;
            if (lw >= 0 && lw != tid) {
                TaskRec &lwr = tasks[(size_t)lw];
                if (!lwr.completed && lwr.stamp != stamp) {
                    lwr.stamp = stamp;
                    lwr.succs.push_back(tid);
                    new_deps++;
                }
            }
            tile.last_writer = tid;
            tile.readers.clear();
            tile.compact_at = 32;
        }
    }
    tasks[(size_t)tid].deps_remaining += new_deps;   // guard still held
    return tid;
}

// Push collected (pool, tid) ready pairs into the scheduler plane,
// contiguous same-pool runs in one plane call each — shared by the
// insert_many link batch and the drain_ready release walk. Call with
// NO engine mutex held (the plane has its own locks). ``scratch`` is a
// caller-owned reusable buffer: this runs on the GIL-dropped hot paths,
// which must not pay a malloc per pool run.
void flush_planeq(ptsched::Plane *spl,
                  std::vector<std::pair<int32_t, int32_t>> &planeq,
                  int wid, std::vector<int32_t> &scratch) {
    for (size_t i = 0; i < planeq.size();) {
        size_t j = i;
        int32_t ph = planeq[i].first;
        scratch.clear();
        while (j < planeq.size() && planeq[j].first == ph)
            scratch.push_back(planeq[j++].second);
        spl->push(ph, wid, scratch.data(), nullptr, (int)scratch.size());
        i = j;
    }
    planeq.clear();
}

// mu held (or GIL for readers: every classes mutator runs under mu AND
// the GIL). The scheduler-plane pool a batch class drains through, or -1.
// Plane ids are int32 — an id past 2^31 (weeks of sustained serving on
// one engine) falls back to the private ready vector rather than wrap.
inline int32_t plane_pool_of(Engine *self, int32_t cls, int64_t tid) {
    if (!self->splane || cls < 0 || tid > INT32_MAX) return -1;
    return (*self->classes)[(size_t)cls].pool;
}

// The release walk shared by both lanes. MUST be called with mu held.
// Marks `tid` completed and decrements its successors; newly-ready
// batch-lane successors go straight onto the internal ready structure —
// or, for plane-bound classes, into `planeq` (pool, tid32) pairs the
// caller pushes into the scheduler plane AFTER mu drops (null: pushed
// inline, the comm-ingest path) — and newly-ready per-task-lane
// successors are appended to `surfaced` for Python to schedule. ``now``
// (0 = histograms off) stamps ready pushes for the ready-wait histogram
// — captured once per caller batch.
void complete_locked(Engine *self, int64_t tid,
                     std::vector<int64_t> &surfaced, int64_t now = 0,
                     std::vector<std::pair<int32_t, int32_t>> *planeq =
                         nullptr) {
    std::vector<TaskRec> &tasks = *self->tasks;
    TaskRec &rec = tasks[(size_t)tid];
    rec.completed = true;
    self->live--;
    // admission accounting: the completing task leaves its pool's
    // in-flight window (one relaxed atomic; safe under mu)
    int32_t myp = plane_pool_of(self, rec.cls, tid);
    if (myp >= 0) self->splane->retired(myp, 1);
    // move out the successor list so the record sheds its heap storage
    std::vector<int64_t> succs;
    succs.swap(rec.succs);
    for (int64_t s : succs) {
        TaskRec &sr = tasks[(size_t)s];
        if (--sr.deps_remaining == 0) {
            if (sr.cls >= 0) {
                sr.ready_ns = now;
                if (self->dev_bound &&
                    (*self->classes)[(size_t)sr.cls].device &&
                    s <= INT32_MAX) {
                    // device-bodied class: surface onto the ptdev lane
                    // (lock-free submit; mu-held is fine, never blocks)
                    self->dsend.submit(self->dsend.dev, self->dev_pool,
                                       (int32_t)s);
                    self->dev_tx.fetch_add(1, std::memory_order_relaxed);
                    continue;
                }
                int32_t ph = plane_pool_of(self, sr.cls, s);
                if (ph >= 0) {
                    if (planeq) {
                        planeq->emplace_back(ph, (int32_t)s);
                    } else {
                        int32_t t32 = (int32_t)s;
                        self->splane->push(ph, -1, &t32, nullptr, 1);
                    }
                } else {
                    self->ready->push_back(s);
                }
            } else {
                sr.ready_ns = now;      // per-task lane: ready from here
                surfaced.push_back(s);
            }
        }
    }
}

// one acquire load per engine entry point; disabled degrades to null
inline pthist::State<N_HISTS> *hist_of(Engine *self) {
    pthist::State<N_HISTS> *hs = self->hist.load(std::memory_order_acquire);
    if (hs && !hs->enabled.load(std::memory_order_relaxed)) hs = nullptr;
    return hs;
}

// insert(tile_ids: list|tuple[int], accs: list|tuple[int])
//   -> (task_id, deps_remaining)   — the insertion guard is STILL HELD
//
// The per-task lane. The insertion guard (count starts at 1) is NOT
// dropped here: the caller must publish its id->task bookkeeping and then
// call activate(task_id), which drops the guard — the count-then-activate
// protocol of parsec_dtd_schedule_task_if_ready (insert_function.c:2963).
// Dropping the guard inside insert() would let a fast predecessor
// completing on a worker thread surface this id from complete() BEFORE
// the inserting thread has mapped it (the activation race).
PyObject *engine_insert(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *tile_ids, *accs;
    if (!PyArg_ParseTuple(args, "OO", &tile_ids, &accs))
        return nullptr;
    // lists are what the hot caller builds; accept tuples too
    const bool til = PyList_Check(tile_ids), acl = PyList_Check(accs);
    if ((!til && !PyTuple_Check(tile_ids)) ||
        (!acl && !PyTuple_Check(accs))) {
        PyErr_SetString(PyExc_TypeError, "tile_ids/accs: list or tuple");
        return nullptr;
    }
    Py_ssize_t nflows = til ? PyList_GET_SIZE(tile_ids)
                            : PyTuple_GET_SIZE(tile_ids);
    if ((acl ? PyList_GET_SIZE(accs) : PyTuple_GET_SIZE(accs)) != nflows) {
        PyErr_SetString(PyExc_ValueError, "tile_ids/accs length mismatch");
        return nullptr;
    }

    // validate EVERYTHING before mutating any chain state: a mid-loop
    // failure after linking flow 0 would leave successor edges (and
    // possibly tile.last_writer) pointing at a popped — soon reused — id
    if (nflows > PT_FLOWS_MAX) {
        PyErr_SetString(PyExc_ValueError, "too many flows (max 1024)");
        return nullptr;
    }
    int64_t tixs[PT_FLOWS_MAX];
    int64_t laccs[PT_FLOWS_MAX];
    // tiles->size() is read under the GIL without mu: tile ids only grow,
    // and a tile referenced here was necessarily created before this call
    size_t ntiles = self->tiles->size();
    for (Py_ssize_t i = 0; i < nflows; i++) {
        tixs[i] = PyLong_AsLongLong(
            til ? PyList_GET_ITEM(tile_ids, i)
                : PyTuple_GET_ITEM(tile_ids, i));
        laccs[i] = PyLong_AsLong(acl ? PyList_GET_ITEM(accs, i)
                                     : PyTuple_GET_ITEM(accs, i));
        if (!PyErr_Occurred() &&
            (tixs[i] < 0 || (size_t)tixs[i] >= ntiles))
            PyErr_SetString(PyExc_IndexError, "bad tile id");
        if (PyErr_Occurred()) return nullptr;
    }

    int64_t tid;
    int32_t held;
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    if (tw.st) tw.rec(EV_PT_LINK, 1, ptrace_ring::FLAG_START);
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        tid = link_locked(self, tixs, laccs, nflows);
        held = (*self->tasks)[(size_t)tid].deps_remaining;
    }
    if (tw.st) tw.rec(EV_PT_LINK, 1, ptrace_ring::FLAG_END);
    return Py_BuildValue("(Li)", (long long)tid, (int)held);
}

// activate(task_id) -> deps_remaining after dropping the insertion guard
// (0 == ready NOW and the caller owns scheduling it; a concurrent
// complete() can never have reported it). Call exactly once per insert,
// AFTER the id->task map is populated.
PyObject *engine_activate(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int64_t tid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    int32_t left;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        std::vector<TaskRec> &tasks = *self->tasks;
        if (tid < 0 || (size_t)tid >= tasks.size()) {
            PyErr_SetString(PyExc_IndexError, "bad task id");
            return nullptr;
        }
        TaskRec &rec = tasks[(size_t)tid];
        if (rec.completed || rec.cls >= 0) {
            PyErr_SetString(PyExc_RuntimeError,
                            rec.completed ? "activate after completion"
                                          : "activate on a batch-lane task");
            return nullptr;
        }
        left = --rec.deps_remaining;
        if (left == 0 && hist_of(self))
            rec.ready_ns = ptrace_ring::now_ns();   // ready from here
    }
    return PyLong_FromLong(left);
}

// complete(task_id) -> tuple of newly-ready PER-TASK-LANE task ids (often
// empty). Newly-ready batch-lane successors are NOT surfaced: they join
// the engine's internal ready structure for the next drain_ready().
PyObject *engine_complete(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int64_t tid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::vector<int64_t> surfaced;
    pthist::State<N_HISTS> *hs = hist_of(self);
    const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        std::vector<TaskRec> &tasks = *self->tasks;
        if (tid < 0 || (size_t)tid >= tasks.size()) {
            PyErr_SetString(PyExc_IndexError, "bad task id");
            return nullptr;
        }
        TaskRec &rec = tasks[(size_t)tid];
        if (rec.completed) {
            PyErr_SetString(PyExc_RuntimeError, "task completed twice");
            return nullptr;
        }
        if (rec.cls >= 0) {
            PyErr_SetString(PyExc_RuntimeError,
                            "complete() on a batch-lane task");
            return nullptr;
        }
        if (hs && rec.ready_ns > 0)
            hs->h[H_PT_DONE].add(h_now - rec.ready_ns);
        complete_locked(self, tid, surfaced, h_now);
    }
    {
        ptrace_ring::Writer tw;
        tw.open(self->trace.load(std::memory_order_acquire));
        if (tw.st) tw.rec(EV_PT_DONE, tid, ptrace_ring::FLAG_POINT);
    }
    PyObject *tup = PyTuple_New((Py_ssize_t)surfaced.size());
    if (!tup) return nullptr;
    for (size_t i = 0; i < surfaced.size(); i++) {
        PyObject *v = PyLong_FromLongLong(surfaced[i]);
        if (!v) { Py_DECREF(tup); return nullptr; }
        PyTuple_SET_ITEM(tup, (Py_ssize_t)i, v);
    }
    return tup;
}

// ------------------------------------------------------------ batched lane

// register_class(callback, argmap, accs[, retire]) -> class id
//   callback(args_list) -> outs_list|None: runs the bodies for one batch.
//     args_list[i] is the i-th task's body-args tuple (payloads gathered
//     from the tile slots per argmap). For classes with WRITE flows the
//     callback must return a list whose i-th entry is a tuple with one
//     output per WRITE flow, in flow order (the Python side normalizes).
//   argmap: per body arg, the flow index it reads, or -1 for the next
//     entry of the task's by-value tuple.
//   accs: per-flow access bits (WRITE flows receive landed outputs).
//   retire(n): optional; called AFTER the batch's outputs have landed in
//     the tile slots and its release walk has run (drain_ready phase 3),
//     so execution-count consumers (wait()'s done predicate) can never
//     observe the counters ahead of the payloads.
PyObject *engine_register_class(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *cb, *argmap_o, *accs_o, *retire = Py_None;
    int pool = -1;     // scheduler-plane pool handle of the owning
                       // taskpool (QoS routing; -1 = private ready)
    int device = 0;    // 1 = device-bodied (ready tasks surface onto the
                       // ptdev lane once dev_bind armed it)
    if (!PyArg_ParseTuple(args, "OOO|Oii", &cb, &argmap_o, &accs_o, &retire,
                          &pool, &device))
        return nullptr;
    if (!PyCallable_Check(cb)) {
        PyErr_SetString(PyExc_TypeError, "callback must be callable");
        return nullptr;
    }
    if (retire != Py_None && !PyCallable_Check(retire)) {
        PyErr_SetString(PyExc_TypeError, "retire must be callable or None");
        return nullptr;
    }
    ClassRec cr;
    PyObject *fast = PySequence_Fast(argmap_o, "argmap: sequence of ints");
    if (!fast) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
        if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return nullptr; }
        cr.argmap.push_back((int32_t)v);
        if (v < 0) cr.nvals++;
    }
    Py_DECREF(fast);
    fast = PySequence_Fast(accs_o, "accs: sequence of ints");
    if (!fast) return nullptr;
    n = PySequence_Fast_GET_SIZE(fast);
    if (n > PT_FLOWS_MAX) {
        Py_DECREF(fast);
        PyErr_SetString(PyExc_ValueError, "too many flows (max 1024)");
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
        if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return nullptr; }
        cr.accs.push_back((int32_t)v);
        if (v & ACC_WRITE) cr.nwrites++;
    }
    Py_DECREF(fast);
    for (int32_t a : cr.argmap) {
        if (a >= (int32_t)cr.accs.size()) {
            PyErr_SetString(PyExc_ValueError, "argmap flow index out of range");
            return nullptr;
        }
    }
    Py_INCREF(cb);
    cr.cb = cb;
    if (retire != Py_None) {
        Py_INCREF(retire);
        cr.retire = retire;
    }
    cr.pool = (pool >= 0 && pool < ptsched::MAX_POOLS) ? pool : -1;
    cr.device = device ? 1 : 0;
    Py_ssize_t cls;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        self->classes->push_back(cr);     // vector owns the cb reference now
        cls = (Py_ssize_t)self->classes->size() - 1;
    }
    return PyLong_FromSsize_t(cls);
}

// insert_many(specs) -> count
//   specs: list of per-task tuples (cls, vals_or_None, t0, a0, t1, a1, …).
//   Parses and validates everything under the GIL, then links the whole
//   batch with the GIL DROPPED (engine mutex held): concurrent inserter
//   threads overlap their link walks with body execution. Each task keeps
//   the count-then-activate protocol — the guard drops only after the
//   task's class/flow/value record is fully stored, inside the same
//   locked region, so a racing complete() can never surface a
//   half-inserted task.
PyObject *engine_insert_many(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *fast = PySequence_Fast(arg, "specs: sequence");
    if (!fast) return nullptr;
    Py_ssize_t ntask = PySequence_Fast_GET_SIZE(fast);
    struct Spec { int32_t cls; int32_t nflows; int64_t foff; PyObject *vals; };
    std::vector<Spec> specs;
    specs.reserve((size_t)ntask);
    std::vector<int64_t> ftile, facc;   // local flow staging
    // tiles/classes sizes read under the GIL: ids only grow, and anything
    // referenced here was created before this call
    const size_t ntiles = self->tiles->size();
    const std::vector<ClassRec> &classes = *self->classes;
    bool bad = false;
    for (Py_ssize_t i = 0; i < ntask && !bad; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(fast, i);
        if (!PyTuple_Check(it)) { bad = true; break; }
        Py_ssize_t sz = PyTuple_GET_SIZE(it);
        if (sz < 2 || ((sz - 2) & 1)) { bad = true; break; }
        Py_ssize_t nf = (sz - 2) / 2;
        if (nf > PT_FLOWS_MAX) { bad = true; break; }
        long cls = PyLong_AsLong(PyTuple_GET_ITEM(it, 0));
        if (PyErr_Occurred() || cls < 0 ||
            (size_t)cls >= classes.size()) { bad = true; break; }
        PyObject *vals = PyTuple_GET_ITEM(it, 1);
        const ClassRec &cr = classes[(size_t)cls];
        if (vals == Py_None) {
            if (cr.nvals != 0) { bad = true; break; }
            vals = nullptr;
        } else {
            if (!PyTuple_Check(vals) ||
                PyTuple_GET_SIZE(vals) != cr.nvals) { bad = true; break; }
        }
        if ((Py_ssize_t)cr.accs.size() != nf) { bad = true; break; }
        Spec sp{(int32_t)cls, (int32_t)nf, (int64_t)ftile.size(), vals};
        for (Py_ssize_t k = 0; k < nf; k++) {
            int64_t tix = PyLong_AsLongLong(PyTuple_GET_ITEM(it, 2 + 2 * k));
            int64_t acc = PyLong_AsLong(PyTuple_GET_ITEM(it, 3 + 2 * k));
            if (PyErr_Occurred() || tix < 0 || (size_t)tix >= ntiles) {
                bad = true; break;
            }
            ftile.push_back(tix);
            facc.push_back(acc);
        }
        if (!bad) specs.push_back(sp);
    }
    if (bad) {
        Py_DECREF(fast);
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "malformed insert_many spec");
        return nullptr;
    }
    for (auto &sp : specs) Py_XINCREF(sp.vals);   // own across the link
    Py_DECREF(fast);   // specs' vals survive via the INCREF above

    // the whole batch links under ONE GIL drop
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    pthist::State<N_HISTS> *hs = hist_of(self);
    // plane-bound classes: ready pushes and admission bumps collect here
    // and land AFTER mu drops (the plane has its own locks); admitted
    // counts group per pool so a batch costs one admit() per pool
    std::vector<std::pair<int32_t, int32_t>> planeq;
    std::vector<std::pair<int32_t, int64_t>> admitted;
    std::vector<int32_t> pscratch;
    PyThreadState *ts = PyEval_SaveThread();
    if (tw.st) tw.rec(EV_LINK, (int64_t)ntask, ptrace_ring::FLAG_START);
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        std::vector<TaskRec> &tasks = *self->tasks;
        // ready-wait stamp, one clock read for the whole link batch
        const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
        const int64_t base = (int64_t)self->flow_tile->size();
        self->flow_tile->insert(self->flow_tile->end(), ftile.begin(),
                                ftile.end());
        self->flow_acc->insert(self->flow_acc->end(), facc.begin(),
                               facc.end());
        for (auto &sp : specs) {
            int64_t tid = link_locked(self, ftile.data() + sp.foff,
                                      facc.data() + sp.foff, sp.nflows);
            TaskRec &rec = tasks[(size_t)tid];
            rec.cls = sp.cls;
            rec.flow_off = base + sp.foff;
            rec.flow_n = sp.nflows;
            rec.vals = sp.vals;           // ownership moves to the record
            int32_t ph = plane_pool_of(self, sp.cls, tid);
            if (ph >= 0) {
                bool seen = false;
                for (auto &a : admitted)
                    if (a.first == ph) { a.second++; seen = true; break; }
                if (!seen) admitted.emplace_back(ph, 1);
            }
            // count-then-activate: the record is fully stored; drop the
            // guard. 0 deps -> straight onto the internal ready structure
            if (--rec.deps_remaining == 0) {
                rec.ready_ns = h_now;
                if (self->dev_bound &&
                    (*self->classes)[(size_t)sp.cls].device &&
                    tid <= INT32_MAX) {
                    self->dsend.submit(self->dsend.dev, self->dev_pool,
                                       (int32_t)tid);
                    self->dev_tx.fetch_add(1, std::memory_order_relaxed);
                } else if (ph >= 0) {
                    planeq.emplace_back(ph, (int32_t)tid);
                } else {
                    self->ready->push_back(tid);
                }
            }
        }
    }
    for (auto &a : admitted) self->splane->admit(a.first, a.second);
    if (!planeq.empty()) flush_planeq(self->splane, planeq, -1, pscratch);
    if (tw.st) tw.rec(EV_LINK, (int64_t)ntask, ptrace_ring::FLAG_END);
    PyEval_RestoreThread(ts);
    return PyLong_FromSsize_t(ntask);
}

// drain_ready(max_batch=256, budget=4096) -> (n_executed, surfaced)
//
// The in-lane ready-drain: pops ready batch-lane tasks, groups them by
// class, gathers each task's body args from the tile payload slots,
// invokes the class callback ONCE per (class, batch), lands written
// payloads back into the slots, and feeds the release walk straight back
// into the ready structure — intermediate ids never surface to Python.
// Newly-ready per-task-lane successors are returned in `surfaced` for
// the caller to schedule. Returns promptly when no batch-lane work is
// ready. Called with the GIL held; the callback runs with the GIL held
// and the engine mutex RELEASED (bodies may re-enter insert paths).
PyObject *engine_drain_ready(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int max_batch = 256;
    long long budget = 4096;
    int wid = 0;    // worker id — scheduler-plane hot-queue affinity
    if (!PyArg_ParseTuple(args, "|iLi", &max_batch, &budget, &wid))
        return nullptr;
    if (max_batch <= 0) max_batch = 256;
    long long total = 0;
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    pthist::State<N_HISTS> *hs = hist_of(self);
    std::vector<int64_t> surfaced;
    // (cls, tid) pairs: cls is snapshotted while the pops hold the mutex —
    // a concurrent insert_many links with the GIL DROPPED (mutex held) and
    // may reallocate the tasks vector, so the sort below must never
    // dereference it unlocked
    std::vector<std::pair<int32_t, int64_t>> local;
    std::vector<PyObject *> argrefs, defer_decref;
    std::vector<int32_t> accs_snap, argmap_snap;
    // scheduler plane: mixed-pool pops (hot queue -> weighted-DRR refill
    // -> steal), arbitrating across every registered DTD taskpool; the
    // per-class grouping below then batches them regardless of pool.
    // Releases push back with this worker's identity after mu drops.
    ptsched::Plane *const spl = self->splane;
    std::vector<ptsched::Item> pitems;
    std::vector<std::pair<int32_t, int32_t>> planeq;
    std::vector<int32_t> pscratch;
    if (spl) pitems.resize((size_t)max_batch);
    for (;;) {
        local.clear();
        int pgot = 0;
        if (spl)
            pgot = spl->pop(wid, ptsched::KIND_PTDTD, -1, pitems.data(),
                            max_batch);
        {
            std::lock_guard<std::mutex> lk(*self->mu);
            if (self->poisoned) break;   // popped ids die with the engine
            const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
            if (pgot) {
                for (int k = 0; k < pgot; k++) {
                    int64_t tid = (int64_t)pitems[(size_t)k].tid;
                    TaskRec &rec = (*self->tasks)[(size_t)tid];
                    if (h_now && rec.ready_ns > 0)
                        hs->h[H_READY].add(h_now - rec.ready_ns);
                    local.emplace_back(rec.cls, tid);
                }
            } else {
                if (self->ready->empty()) break;
                size_t take =
                    std::min((size_t)max_batch, self->ready->size());
                for (size_t k = self->ready->size() - take;
                     k < self->ready->size(); k++) {
                    int64_t tid = (*self->ready)[k];
                    TaskRec &rec = (*self->tasks)[(size_t)tid];
                    if (h_now && rec.ready_ns > 0)
                        hs->h[H_READY].add(h_now - rec.ready_ns);
                    local.emplace_back(rec.cls, tid);
                }
                self->ready->resize(self->ready->size() - take);
            }
        }
        // group by class so each callback sees one homogeneous batch; the
        // snapshot pairs keep the comparator off the live tasks vector
        std::stable_sort(local.begin(), local.end(),
                         [](const std::pair<int32_t, int64_t> &a,
                            const std::pair<int32_t, int64_t> &b) {
                             return a.first < b.first;
                         });
        size_t gi = 0;
        while (gi < local.size()) {
            size_t gj = gi;
            const int32_t cls = local[gi].first;
            while (gj < local.size() && local[gj].first == cls)
                gj++;
            const size_t gn = gj - gi;
            // snapshot the class record: the callback releases the GIL, so
            // a concurrent register_class may reallocate the vector —
            // references into it must not be held across the dispatch
            // (reading it GIL-held needs no mutex: every classes mutator
            // runs under the GIL and never drops it)
            PyObject *cb, *retire;
            int32_t nwrites;
            {
                const ClassRec &cr = (*self->classes)[(size_t)cls];
                cb = cr.cb;
                if (!cb) {
                    // release_pool() already dropped this class: its pool
                    // completed, so no task of it can be ready — seeing one
                    // means the caller broke the hand-off contract
                    PyErr_SetString(PyExc_RuntimeError,
                                    "batch class released with tasks "
                                    "still outstanding");
                    std::lock_guard<std::mutex> lk(*self->mu);
                    self->poisoned = true;
                    return nullptr;
                }
                Py_INCREF(cb);
                retire = cr.retire;
                Py_XINCREF(retire);
                nwrites = cr.nwrites;
                accs_snap = cr.accs;
                argmap_snap = cr.argmap;
            }
            const size_t nargs = argmap_snap.size();
            // phase 1 (mutex held): snapshot payload/value references with
            // bare INCREFs — no allocation, no arbitrary code under mu
            argrefs.clear();
            argrefs.reserve(gn * nargs);
            {
                std::lock_guard<std::mutex> lk(*self->mu);
                for (size_t t = gi; t < gj; t++) {
                    TaskRec &rec = (*self->tasks)[(size_t)local[t].second];
                    int32_t vi = 0;
                    for (size_t a = 0; a < nargs; a++) {
                        PyObject *v;
                        int32_t f = argmap_snap[a];
                        if (f < 0) {
                            v = rec.vals
                                ? PyTuple_GET_ITEM(rec.vals, vi) : Py_None;
                            vi++;
                        } else {
                            int64_t tix =
                                (*self->flow_tile)[(size_t)(rec.flow_off + f)];
                            v = (*self->tiles)[(size_t)tix].payload;
                            if (!v) v = Py_None;
                        }
                        Py_INCREF(v);
                        argrefs.push_back(v);
                    }
                }
            }
            // phase 2 (mutex released): build the args list and dispatch
            const int64_t h_t0 = hs ? ptrace_ring::now_ns() : 0;
            if (tw.st) tw.rec(EV_EXEC, cls, ptrace_ring::FLAG_START);
            PyObject *args_list = PyList_New((Py_ssize_t)gn);
            PyObject *outs = nullptr;
            size_t consumed = 0;       // argref rows moved into tuples
            if (args_list) {
                bool ok = true;
                for (size_t t = 0; t < gn; t++) {
                    PyObject *tp = PyTuple_New((Py_ssize_t)nargs);
                    if (!tp) { ok = false; break; }
                    for (size_t a = 0; a < nargs; a++)
                        PyTuple_SET_ITEM(tp, (Py_ssize_t)a,
                                         argrefs[t * nargs + a]);
                    consumed = t + 1;
                    PyList_SET_ITEM(args_list, (Py_ssize_t)t, tp);
                }
                if (ok)
                    outs = PyObject_CallFunctionObjArgs(cb, args_list,
                                                        nullptr);
            }
            // drop any refs a failed allocation left unconsumed
            for (size_t r = consumed * nargs; r < argrefs.size(); r++)
                Py_DECREF(argrefs[r]);
            Py_DECREF(cb);
            if (!outs) {
                Py_XDECREF(retire);
                // the callback raised (or allocation failed): poison the
                // lane so peers stop draining and propagate the exception
                Py_XDECREF(args_list);
                std::lock_guard<std::mutex> lk(*self->mu);
                self->poisoned = true;
                return nullptr;
            }
            if (nwrites) {
                bool shape_ok = PyList_Check(outs) &&
                                PyList_GET_SIZE(outs) == (Py_ssize_t)gn;
                for (Py_ssize_t t = 0; shape_ok && t < (Py_ssize_t)gn; t++) {
                    PyObject *o = PyList_GET_ITEM(outs, t);
                    shape_ok = PyTuple_Check(o) &&
                               PyTuple_GET_SIZE(o) >= (Py_ssize_t)nwrites;
                }
                if (!shape_ok) {
                    Py_XDECREF(retire);
                    Py_DECREF(args_list);
                    Py_DECREF(outs);
                    PyErr_SetString(PyExc_TypeError,
                                    "batch callback must return one output "
                                    "tuple per task (one item per WRITE "
                                    "flow)");
                    std::lock_guard<std::mutex> lk(*self->mu);
                    self->poisoned = true;
                    return nullptr;
                }
            }
            // phase 3 (mutex held): land written payloads into the tile
            // slots and run the release walk; DECREFs are deferred
            defer_decref.clear();
            {
                std::lock_guard<std::mutex> lk(*self->mu);
                const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
                for (size_t t = gi; t < gj; t++) {
                    TaskRec &rec = (*self->tasks)[(size_t)local[t].second];
                    if (nwrites) {
                        PyObject *out_t =
                            PyList_GET_ITEM(outs, (Py_ssize_t)(t - gi));
                        Py_ssize_t oi = 0;
                        for (size_t f = 0; f < accs_snap.size(); f++) {
                            if (!(accs_snap[f] & ACC_WRITE)) continue;
                            PyObject *nv = PyTuple_GET_ITEM(out_t, oi++);
                            int64_t tix = (*self->flow_tile)
                                [(size_t)(rec.flow_off + (int64_t)f)];
                            TileRec &tile = (*self->tiles)[(size_t)tix];
                            Py_INCREF(nv);
                            if (tile.payload)
                                defer_decref.push_back(tile.payload);
                            tile.payload = nv;
                            tile.writes++;
                        }
                    }
                    if (rec.vals) {
                        defer_decref.push_back(rec.vals);
                        rec.vals = nullptr;
                    }
                    if (tw.st)
                        tw.rec(EV_TASK, local[t].second,
                               ptrace_ring::FLAG_POINT);
                    complete_locked(self, local[t].second, surfaced, h_now,
                                    spl ? &planeq : nullptr);
                }
                self->batch_done += (int64_t)gn;
            }
            if (!planeq.empty())
                // newly-ready plane tasks from this batch's release walk
                // enter with this worker's hot-queue affinity
                flush_planeq(spl, planeq, wid, pscratch);
            if (hs) {
                // per-task (class, batch) latency: gather + dispatch +
                // landing + release amortized over the batch
                int64_t per =
                    (ptrace_ring::now_ns() - h_t0) / (int64_t)gn;
                hs->h[H_EXEC].add(per, gn);
            }
            if (tw.st) tw.rec(EV_EXEC, cls, ptrace_ring::FLAG_END);
            for (PyObject *p : defer_decref) Py_DECREF(p);
            Py_DECREF(args_list);
            Py_DECREF(outs);
            // retire AFTER phase 3: the pool's execution counters must
            // trail the payload landing, or a waiter observing
            // "executed == target" could sync stale slots
            if (retire) {
                PyObject *rr =
                    PyObject_CallFunction(retire, "n", (Py_ssize_t)gn);
                Py_DECREF(retire);
                if (!rr) {
                    std::lock_guard<std::mutex> lk(*self->mu);
                    self->poisoned = true;
                    return nullptr;
                }
                Py_DECREF(rr);
            }
            total += (long long)gn;
            gi = gj;
        }
        if (budget > 0 && total >= budget) break;
    }
    {
        // hand over per-task-lane tasks a remote ingest released since
        // the last drain (ingest_act runs on the comm progress thread
        // and cannot schedule Python tasks itself)
        std::lock_guard<std::mutex> lk(*self->mu);
        if (!self->rsurf->empty()) {
            surfaced.insert(surfaced.end(), self->rsurf->begin(),
                            self->rsurf->end());
            self->rsurf->clear();
        }
    }
    PyObject *sur = PyTuple_New((Py_ssize_t)surfaced.size());
    if (!sur) return nullptr;
    for (size_t i = 0; i < surfaced.size(); i++) {
        PyObject *v = PyLong_FromLongLong(surfaced[i]);
        if (!v) { Py_DECREF(sur); return nullptr; }
        PyTuple_SET_ITEM(sur, (Py_ssize_t)i, v);
    }
    PyObject *res = Py_BuildValue("(LN)", total, sur);
    if (!res) Py_DECREF(sur);
    return res;
}

// ------------------------------------------------------ tile payload slots

// slot_set(tile_id, payload) — seed/refresh a tile's payload slot (does
// NOT count as a batch-lane write: the per-task lane bumps its own
// versions Python-side and mirrors the value here for batch readers)
PyObject *engine_slot_set(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *payload;
    long long nid;
    if (!PyArg_ParseTuple(args, "LO", &nid, &payload))
        return nullptr;
    PyObject *old;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (nid < 0 || (size_t)nid >= self->tiles->size()) {
            PyErr_SetString(PyExc_IndexError, "bad tile id");
            return nullptr;
        }
        TileRec &tile = (*self->tiles)[(size_t)nid];
        Py_INCREF(payload);
        old = tile.payload;
        tile.payload = payload;
    }
    Py_XDECREF(old);
    Py_RETURN_NONE;
}

// slot_get(tile_id) -> payload or None (no bookkeeping side effects)
PyObject *engine_slot_get(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    long long nid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    PyObject *p;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (nid < 0 || (size_t)nid >= self->tiles->size()) {
            PyErr_SetString(PyExc_IndexError, "bad tile id");
            return nullptr;
        }
        p = (*self->tiles)[(size_t)nid].payload;
        if (!p) p = Py_None;
        Py_INCREF(p);
    }
    return p;
}

// slot_sync(tile_id) -> (payload_or_None, writes_since_last_sync)
// Resets the write counter AND empties the slot (payload ownership moves
// to the returned tuple): after a sync the tile's HOST copy is
// authoritative again, so user updates to tile.data between quiescence
// points are honored — the flush path re-seeds empty slots from
// tile.data before the next batch links (dtd.py _flush_batch_locked).
// A retained slot here would silently outrank a post-wait() reseed.
PyObject *engine_slot_sync(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    long long nid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    PyObject *p;
    long long w;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (nid < 0 || (size_t)nid >= self->tiles->size()) {
            PyErr_SetString(PyExc_IndexError, "bad tile id");
            return nullptr;
        }
        TileRec &tile = (*self->tiles)[(size_t)nid];
        p = tile.payload;            // ownership moves to the result
        tile.payload = nullptr;
        if (!p) { p = Py_None; Py_INCREF(p); }
        w = tile.writes;
        tile.writes = 0;
    }
    PyObject *res = Py_BuildValue("(NL)", p, w);
    if (!res) Py_DECREF(p);
    return res;
}

// release_pool(tile_ids, class_ids) — drop the engine-side references a
// completed pool pinned: tile payload slots and class callbacks. The
// Engine is per-CONTEXT while pools come and go, so without this every
// dead pool's payloads (and, through the callback closures, the pool
// object itself) would live until context teardown. Only legal once the
// pool is fully drained: a released class's tasks must never be ready.
PyObject *engine_release_pool(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *tiles_o, *classes_o;
    if (!PyArg_ParseTuple(args, "OO", &tiles_o, &classes_o))
        return nullptr;
    // parse ids BEFORE taking the mutex (no Python calls under mu)
    std::vector<int64_t> tids, cids;
    for (int pass = 0; pass < 2; pass++) {
        PyObject *src = pass ? classes_o : tiles_o;
        std::vector<int64_t> &dst = pass ? cids : tids;
        PyObject *fast = PySequence_Fast(src, "release_pool: sequence of ids");
        if (!fast) return nullptr;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
        for (Py_ssize_t i = 0; i < n; i++) {
            int64_t v =
                PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fast, i));
            if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return nullptr; }
            dst.push_back(v);
        }
        Py_DECREF(fast);
    }
    std::vector<PyObject *> defer_decref;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        for (int64_t nid : tids) {
            if (nid < 0 || (size_t)nid >= self->tiles->size()) {
                PyErr_SetString(PyExc_IndexError, "bad tile id");
                goto fail;
            }
            TileRec &tile = (*self->tiles)[(size_t)nid];
            if (tile.payload) {
                defer_decref.push_back(tile.payload);
                tile.payload = nullptr;
            }
            tile.writes = 0;
        }
        for (int64_t cid : cids) {
            if (cid < 0 || (size_t)cid >= self->classes->size()) {
                PyErr_SetString(PyExc_IndexError, "bad class id");
                goto fail;
            }
            ClassRec &cr = (*self->classes)[(size_t)cid];
            if (cr.cb) {
                defer_decref.push_back(cr.cb);
                cr.cb = nullptr;
            }
            if (cr.retire) {
                defer_decref.push_back(cr.retire);
                cr.retire = nullptr;
            }
            // the plane pool slot may be reused after the Python side
            // unregisters it — a dead class must never route there
            cr.pool = -1;
        }
    }
    for (PyObject *p : defer_decref) Py_DECREF(p);
    Py_RETURN_NONE;
fail:
    for (PyObject *p : defer_decref) Py_DECREF(p);
    return nullptr;
}

// ------------------------------------------------------------- diagnostics

// successors(task_id) -> tuple of successor ids discovered so far.
// Complete BEFORE calling complete() on the task: the release walk moves
// the list out. Instrumentation consumers (the DOT grapher's PINS hook)
// mirror these onto the Python task so the native lane's DAG stays
// observable without re-running the discovery in Python.
PyObject *engine_successors(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int64_t tid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::vector<int64_t> succs;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (tid < 0 || (size_t)tid >= self->tasks->size()) {
            PyErr_SetString(PyExc_IndexError, "bad task id");
            return nullptr;
        }
        succs = (*self->tasks)[(size_t)tid].succs;
    }
    PyObject *tup = PyTuple_New((Py_ssize_t)succs.size());
    if (!tup) return nullptr;
    for (size_t i = 0; i < succs.size(); i++) {
        PyObject *v = PyLong_FromLongLong(succs[i]);
        if (!v) { Py_DECREF(tup); return nullptr; }
        PyTuple_SET_ITEM(tup, (Py_ssize_t)i, v);
    }
    return tup;
}

// ------------------------------------------------------- in-lane tracing

PyObject *engine_trace_enable(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    return ptrace_ring::py_trace_enable(self->trace, args);
}

PyObject *engine_trace_disable(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_disable(
        reinterpret_cast<Engine *>(obj)->trace.load(
            std::memory_order_acquire));
}

PyObject *engine_trace_drain(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_drain(
        reinterpret_cast<Engine *>(obj)->trace.load(
            std::memory_order_acquire));
}

PyObject *engine_trace_dropped(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_dropped(
        reinterpret_cast<Engine *>(obj)->trace.load(
            std::memory_order_acquire));
}

PyObject *engine_monotonic_ns(PyObject *, PyObject *) {
    return PyLong_FromLongLong(ptrace_ring::now_ns());
}

// --------------------------------------------------- latency histograms

PyObject *engine_hist_enable(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *r = pthist::py_hist_enable<N_HISTS>(self->hist);
    if (!r) return nullptr;
    // tasks already awaiting drain get a real push stamp
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        int64_t now = ptrace_ring::now_ns();
        for (int64_t t : *self->ready)
            (*self->tasks)[(size_t)t].ready_ns = now;
    }
    return r;
}

PyObject *engine_hist_snapshot(PyObject *obj, PyObject *) {
    return pthist::py_hist_snapshot<N_HISTS>(
        reinterpret_cast<Engine *>(obj)->hist.load(
            std::memory_order_acquire),
        HIST_NAMES);
}

// deps_remaining(task_id) -> int  (diagnostics / paranoid checks)
PyObject *engine_deps_remaining(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int64_t tid = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    if (tid < 0 || (size_t)tid >= self->tasks->size()) {
        PyErr_SetString(PyExc_IndexError, "bad task id");
        return nullptr;
    }
    return PyLong_FromLong((*self->tasks)[(size_t)tid].deps_remaining);
}

PyObject *engine_pending(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return PyLong_FromLongLong(self->live);
}

PyObject *engine_ready_count(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    int64_t plane_q = self->splane
        ? self->splane->queued_kind(ptsched::KIND_PTDTD) : 0;
    std::lock_guard<std::mutex> lk(*self->mu);
    return PyLong_FromLongLong((long long)self->ready->size() + plane_q);
}

PyObject *engine_batch_executed(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return PyLong_FromLongLong(self->batch_done);
}

PyObject *engine_sizes(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return Py_BuildValue("(nn)", (Py_ssize_t)self->tasks->size(),
                         (Py_ssize_t)self->tiles->size());
}

// ------------------------------------------------------- comm lane ingest

// GIL-free entry the comm progress thread calls through the
// PtCommIngestVtbl capsule: one arrived remote dep-release for task
// `tid`. A newly-ready batch-lane task joins the internal ready
// structure (next drain_ready executes it); a per-task-lane task parks
// in `rsurf` until drain_ready surfaces it for Python scheduling.
void dtd_ingest_act_c(void *obj, int32_t tid) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (tid < 0 || (size_t)tid >= self->tasks->size()) {
        self->ingest_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    TaskRec &rec = (*self->tasks)[(size_t)tid];
    if (rec.completed) {
        self->ingest_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    self->acts_rx.fetch_add(1, std::memory_order_relaxed);
    if (--rec.deps_remaining == 0) {
        if (rec.cls >= 0) {
            rec.ready_ns = hist_of(self) ? ptrace_ring::now_ns() : 0;
            int32_t ph = plane_pool_of(self, rec.cls, tid);
            if (ph >= 0) {
                int32_t t32 = (int32_t)tid;
                self->splane->push(ph, -1, &t32, nullptr, 1);
            } else {
                self->ready->push_back(tid);
            }
        } else {
            self->rsurf->push_back(tid);
        }
    }
}

void dtd_ingest_capsule_free(PyObject *cap) {
    std::free(PyCapsule_GetPointer(cap, PTCOMM_INGEST_CAPSULE));
}

PyObject *engine_ingest_capsule(PyObject *obj, PyObject *) {
    PtCommIngestVtbl *v =
        static_cast<PtCommIngestVtbl *>(std::malloc(sizeof(PtCommIngestVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTCOMM_ABI;
    v->obj = obj;
    v->act = dtd_ingest_act_c;
    v->rdv_begin = nullptr;   // DTD payloads land through the tile/slot
    v->rdv_land = nullptr;    // machinery, not per-slot gates
    PyObject *cap = PyCapsule_New(v, PTCOMM_INGEST_CAPSULE,
                                  dtd_ingest_capsule_free);
    if (!cap) std::free(v);
    return cap;
}

PyObject *engine_ingest(PyObject *obj, PyObject *arg) {
    long long tid = PyLong_AsLongLong(arg);
    if (tid == -1 && PyErr_Occurred()) return nullptr;
    dtd_ingest_act_c(obj, (int32_t)tid);
    Py_RETURN_NONE;
}

// ------------------------------------------------------- device lane bind

// GIL-free entry the ptdev manager thread calls through the
// PtDevRetireVtbl capsule: device task `tid` completed (its outputs were
// already landed into the tile payload slots by the manager's poll
// callback, under the GIL, BEFORE this call). Runs the release walk:
// newly-ready device-class successors surface back onto the lane inside
// complete_locked, batch-lane successors join the internal ready
// structure, and per-task-lane successors park in rsurf for the next
// drain_ready — the same three-way routing a batch completion does.
void dtd_dev_retire_c(void *obj, int32_t tid) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (tid < 0 || (size_t)tid >= self->tasks->size() || !self->dev_bound) {
        self->dev_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    TaskRec &rec = (*self->tasks)[(size_t)tid];
    if (rec.completed || rec.cls < 0 ||
        !(*self->classes)[(size_t)rec.cls].device) {
        self->dev_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    complete_locked(self, tid, *self->rsurf,
                    hist_of(self) ? ptrace_ring::now_ns() : 0);
    self->batch_done++;
    self->dev_done.fetch_add(1, std::memory_order_relaxed);
}

void dtd_dev_retire_capsule_free(PyObject *cap) {
    std::free(PyCapsule_GetPointer(cap, PTDEV_RETIRE_CAPSULE));
}

PyObject *engine_dev_retire_capsule(PyObject *obj, PyObject *) {
    PtDevRetireVtbl *v =
        static_cast<PtDevRetireVtbl *>(std::malloc(sizeof(PtDevRetireVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTDEV_ABI;
    v->obj = obj;
    v->retire = dtd_dev_retire_c;
    PyObject *cap = PyCapsule_New(v, PTDEV_RETIRE_CAPSULE,
                                  dtd_dev_retire_capsule_free);
    if (!cap) std::free(v);
    return cap;
}

// dev_bind(submit_capsule, dev_pool) — arm the device lane: ready tasks
// of device-marked classes (register_class(..., device=1)) surface onto
// the ptdev lane from this point on. Bind BEFORE inserting any task of a
// device class — an already-ready device task would otherwise sit in the
// internal ready structure and run through drain_ready's CPU callback.
PyObject *engine_dev_bind(PyObject *obj, PyObject *args) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    PyObject *cap;
    unsigned int pool;
    if (!PyArg_ParseTuple(args, "OI", &cap, &pool)) return nullptr;
    PtDevSubmitVtbl *sv = static_cast<PtDevSubmitVtbl *>(
        PyCapsule_GetPointer(cap, PTDEV_SUBMIT_CAPSULE));
    if (!sv) return nullptr;
    if (sv->abi != PTDEV_ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptdev ABI mismatch");
        return nullptr;
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->dev_bound) {
        PyErr_SetString(PyExc_RuntimeError, "engine already dev-bound");
        return nullptr;
    }
    self->dsend = *sv;
    self->dev_pool = pool;
    self->dev_bound = true;
    Py_RETURN_NONE;
}

PyObject *engine_dev_retire(PyObject *obj, PyObject *arg) {
    long long tid = PyLong_AsLongLong(arg);
    if (tid == -1 && PyErr_Occurred()) return nullptr;
    dtd_dev_retire_c(obj, (int32_t)tid);
    Py_RETURN_NONE;
}

PyObject *engine_dev_stats(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    return Py_BuildValue(
        "{s:L,s:L,s:L}",
        "dev_tx", (long long)self->dev_tx.load(std::memory_order_relaxed),
        "dev_done",
        (long long)self->dev_done.load(std::memory_order_relaxed),
        "dev_bad", (long long)self->dev_bad.load(std::memory_order_relaxed));
}

// --------------------------------------------------- scheduler plane bind

// sched_bind(plane_capsule) — attach the shared scheduler plane: classes
// registered with a pool handle then route their ready tasks through it
// (drain_ready pops arbitrate across pools by DRR weight). Idempotent
// for the same plane; the engine is per-context and the plane per-context
// too, so a second different plane is a caller bug.
PyObject *engine_sched_bind(PyObject *obj, PyObject *arg) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    ptsched::Plane *pl = ptsched::plane_from_capsule(arg);
    if (!pl) return nullptr;
    if (self->splane && self->splane != pl) {
        PyErr_SetString(PyExc_RuntimeError,
                        "engine already bound to another scheduler plane");
        return nullptr;
    }
    if (!self->splane) {
        Py_INCREF(arg);
        self->sched_cap = arg;
        self->splane = pl;
    }
    Py_RETURN_NONE;
}

PyObject *engine_sched_bound(PyObject *obj, PyObject *) {
    return PyBool_FromLong(
        reinterpret_cast<Engine *>(obj)->splane != nullptr ? 1 : 0);
}

PyObject *engine_comm_stats(PyObject *obj, PyObject *) {
    Engine *self = reinterpret_cast<Engine *>(obj);
    long long rs;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        rs = (long long)self->rsurf->size();
    }
    return Py_BuildValue(
        "{s:L,s:L,s:L}",
        "acts_rx", (long long)self->acts_rx.load(std::memory_order_relaxed),
        "ingest_bad",
        (long long)self->ingest_bad.load(std::memory_order_relaxed),
        "rsurf_pending", rs);
}

PyMethodDef engine_methods[] = {
    {"tile", engine_tile, METH_NOARGS,
     "register a tile chain; returns its id"},
    {"insert", engine_insert, METH_VARARGS,
     "insert(tile_ids, accs) -> (task_id, deps_remaining); the insertion "
     "guard stays held until activate(task_id)"},
    {"activate", engine_activate, METH_O,
     "drop the insertion guard; returns deps remaining (0 = ready now)"},
    {"complete", engine_complete, METH_O,
     "complete(task_id) -> tuple of newly-ready per-task-lane ids"},
    {"register_class", engine_register_class, METH_VARARGS,
     "register_class(callback, argmap, accs[, retire[, pool[, device]]]) "
     "-> batch-lane class id; retire(n) fires after each batch's outputs "
     "land; pool routes ready tasks through the bound scheduler plane; "
     "device=1 surfaces ready tasks onto the ptdev lane once dev-bound"},
    {"insert_many", engine_insert_many, METH_O,
     "insert_many(specs) -> count; links the whole batch under one GIL "
     "drop (count-then-activate per task)"},
    {"drain_ready", engine_drain_ready, METH_VARARGS,
     "drain_ready(max_batch=256, budget=4096, wid=0) -> (n_executed, "
     "surfaced); runs ready batch-lane tasks via per-class batched "
     "callbacks (wid = scheduler-plane hot-queue affinity)"},
    {"sched_bind", engine_sched_bind, METH_O,
     "sched_bind(plane_capsule): attach the shared scheduler plane "
     "(see csrc/ptsched.h); idempotent for the same plane"},
    {"sched_bound", engine_sched_bound, METH_NOARGS,
     "True when a scheduler plane is attached"},
    {"slot_set", engine_slot_set, METH_VARARGS,
     "slot_set(tile_id, payload): seed/refresh a tile's payload slot"},
    {"slot_get", engine_slot_get, METH_O,
     "slot_get(tile_id) -> payload or None"},
    {"slot_sync", engine_slot_sync, METH_O,
     "slot_sync(tile_id) -> (payload, writes-since-last-sync); resets the "
     "write counter"},
    {"release_pool", engine_release_pool, METH_VARARGS,
     "release_pool(tile_ids, class_ids): drop a completed pool's slot "
     "payloads and class callbacks"},
    {"successors", engine_successors, METH_O,
     "successors(task_id) -> tuple of successor ids (query BEFORE "
     "complete(); instrumentation mirror for PINS consumers)"},
    {"trace_enable", engine_trace_enable, METH_VARARGS,
     "trace_enable(nrings=16, capacity=65536) -> (nrings, cap): arm the "
     "in-lane event rings (idempotent; see ptrace_ring.h)"},
    {"trace_disable", engine_trace_disable, METH_NOARGS,
     "stop recording (the rings stay allocated; trace_enable re-arms)"},
    {"trace_drain", engine_trace_drain, METH_NOARGS,
     "trace_drain() -> [(ring_id, packed_events_bytes)]; event layout "
     "'<qqII' = (t_ns, id, key, flags)"},
    {"trace_dropped", engine_trace_dropped, METH_NOARGS,
     "cumulative events lost to ring overflow (never reset)"},
    {"monotonic_ns", engine_monotonic_ns, METH_NOARGS,
     "the trace clock (steady_clock ns) — for epoch calibration"},
    {"hist_enable", engine_hist_enable, METH_NOARGS,
     "arm the latency histograms (exec_ns amortized per (class,batch), "
     "ready_wait_ns push->pop, pt_ready_to_done_ns per-task lane ready->"
     "complete; see pthist.h)"},
    {"hist_snapshot", engine_hist_snapshot, METH_NOARGS,
     "{name: (count, sum_ns, buckets_bytes)} — buckets pack '<496Q'"},
    {"deps_remaining", engine_deps_remaining, METH_O,
     "deps_remaining(task_id) -> int"},
    {"pending", engine_pending, METH_NOARGS,
     "live (incomplete) task count"},
    {"ready_count", engine_ready_count, METH_NOARGS,
     "ready batch-lane tasks awaiting drain"},
    {"batch_executed", engine_batch_executed, METH_NOARGS,
     "total batch-lane tasks executed by drain_ready"},
    {"sizes", engine_sizes, METH_NOARGS,
     "(total tasks ever, total tiles) — memory diagnostics"},
    {"ingest", engine_ingest, METH_O,
     "ingest(tid): one remote dep-release arrived for task tid"},
    {"ingest_capsule", engine_ingest_capsule, METH_NOARGS,
     "PyCapsule(PtCommIngestVtbl) for Comm.register_pool (GIL-free ingest)"},
    {"comm_stats", engine_comm_stats, METH_NOARGS,
     "{acts_rx, ingest_bad, rsurf_pending}"},
    {"dev_bind", engine_dev_bind, METH_VARARGS,
     "dev_bind(submit_capsule, dev_pool): ready tasks of device-marked "
     "classes surface onto the ptdev lane (bind before inserting them)"},
    {"dev_retire_capsule", engine_dev_retire_capsule, METH_NOARGS,
     "PyCapsule(PtDevRetireVtbl) for Lane.bind_pool (GIL-free retirement)"},
    {"dev_retire", engine_dev_retire, METH_O,
     "dev_retire(tid): one device task completed; run its release walk"},
    {"dev_stats", engine_dev_stats, METH_NOARGS,
     "{dev_tx, dev_done, dev_bad}"},
    {nullptr, nullptr, 0, nullptr}};

// ----------------------------------------------------- insert fast path

// Interned attribute names + the small-int singletons the fast path
// compares against, created once at module init: the per-call
// GetAttrString/PyLong_AsLong round-trips were ~40% of try_buffer's cost
// at the measured ~600ns/call.
PyObject *s_nid = nullptr;      // "nid"
PyObject *s_zero = nullptr;     // int 0   (default priority)
PyObject *s_devall = nullptr;   // int 255 (DEV_ALL)

// try_buffer(fstate, fn, args, priority, where, jit, batch) -> int
//
// The MODULE-LEVEL insert_task fast path: validates one insert call
// against the pool's one-entry fast cache and appends its batch spec to
// the insert buffer — the ~30 interpreter bytecodes the Python fast path
// would spend per insert collapse into one C call (METH_FASTCALL: no
// argument tuple is ever materialized). Touches NO engine state (the
// buffer is a plain Python list; append is GIL-atomic), so it is a free
// function, not a method.
//
//   fstate: (fn, jit, batch, kinds, cls, buf, flush_n, tile_type)
//       kinds: bare acc int for the single-flow shape, else a tuple with
//       one entry per arg — the acc int for flow positions, None for
//       by-value positions. tile_type: the DTDTile class (exact match).
//   returns 0 = take the slow path, 1 = buffered,
//           2 = buffered and the flush threshold was reached
PyObject *ptdtd_try_buffer(PyObject *, PyObject *const *fc,
                           Py_ssize_t nfc) {
    if (nfc != 7) {
        PyErr_SetString(PyExc_TypeError, "try_buffer takes 7 arguments");
        return nullptr;
    }
    PyObject *fstate = fc[0], *fn = fc[1], *args = fc[2], *priority = fc[3],
             *where = fc[4], *jit = fc[5], *batch = fc[6];
    if (!PyTuple_Check(fstate) || PyTuple_GET_SIZE(fstate) != 8 ||
        !PyTuple_Check(args))
        return PyLong_FromLong(0);
    // gate: same fn object, same jit/batch flags (canonical bools compare
    // by identity), priority 0, no device restriction. Small ints are
    // singletons in CPython, so the common literals hit the pointer
    // compare; anything else takes the boxed-value check once.
    if (PyTuple_GET_ITEM(fstate, 0) != fn ||
        PyTuple_GET_ITEM(fstate, 1) != jit ||
        PyTuple_GET_ITEM(fstate, 2) != batch)
        return PyLong_FromLong(0);
    if (priority != s_zero &&
        (!PyLong_CheckExact(priority) || PyLong_AsLong(priority) != 0)) {
        if (PyErr_Occurred()) PyErr_Clear();
        return PyLong_FromLong(0);
    }
    if (where != s_devall &&
        (!PyLong_CheckExact(where) || PyLong_AsLong(where) != 0xFF)) {
        if (PyErr_Occurred()) PyErr_Clear();
        return PyLong_FromLong(0);
    }
    PyObject *kinds = PyTuple_GET_ITEM(fstate, 3);
    PyObject *cls = PyTuple_GET_ITEM(fstate, 4);
    PyObject *buf = PyTuple_GET_ITEM(fstate, 5);
    PyObject *flushn_o = PyTuple_GET_ITEM(fstate, 6);
    PyObject *tile_type = PyTuple_GET_ITEM(fstate, 7);
    if (!PyList_Check(buf)) return PyLong_FromLong(0);
    PyObject *spec = nullptr;
    if (PyLong_CheckExact(kinds)) {
        // single-flow shape: args == ((tile, acc),) with acc == kinds
        if (PyTuple_GET_SIZE(args) != 1) return PyLong_FromLong(0);
        PyObject *a = PyTuple_GET_ITEM(args, 0);
        if (!PyTuple_CheckExact(a) || PyTuple_GET_SIZE(a) != 2)
            return PyLong_FromLong(0);
        PyObject *acc = PyTuple_GET_ITEM(a, 1);
        int eq = PyObject_RichCompareBool(acc, kinds, Py_EQ);
        if (eq < 0) { PyErr_Clear(); return PyLong_FromLong(0); }
        if (!eq) return PyLong_FromLong(0);
        PyObject *tile = PyTuple_GET_ITEM(a, 0);
        if ((PyObject *)Py_TYPE(tile) != tile_type)
            return PyLong_FromLong(0);
        PyObject *nid = PyObject_GetAttr(tile, s_nid);
        if (!nid) { PyErr_Clear(); return PyLong_FromLong(0); }
        if (nid == Py_None) {    // first native touch: slow path seeds it
            Py_DECREF(nid);
            return PyLong_FromLong(0);
        }
        spec = PyTuple_New(4);
        if (!spec) { Py_DECREF(nid); return nullptr; }
        Py_INCREF(cls);
        Py_INCREF(Py_None);
        Py_INCREF(kinds);
        PyTuple_SET_ITEM(spec, 0, cls);
        PyTuple_SET_ITEM(spec, 1, Py_None);
        PyTuple_SET_ITEM(spec, 2, nid);
        PyTuple_SET_ITEM(spec, 3, kinds);
    } else {
        // general shape: walk the kinds pattern
        if (!PyTuple_CheckExact(kinds) ||
            PyTuple_GET_SIZE(args) != PyTuple_GET_SIZE(kinds))
            return PyLong_FromLong(0);
        Py_ssize_t na = PyTuple_GET_SIZE(kinds);
        PyObject *vals = nullptr;   // lazily built list of by-value args
        std::vector<PyObject *> flows;   // borrowed (nid, acc) pairs...
        std::vector<PyObject *> owned;   // nid refs to release on bail
        bool ok = true;
        for (Py_ssize_t i = 0; i < na && ok; i++) {
            PyObject *k = PyTuple_GET_ITEM(kinds, i);
            PyObject *a = PyTuple_GET_ITEM(args, i);
            if (k == Py_None) {
                // by-value position: a flow-shaped arg changes the spec
                if ((PyObject *)Py_TYPE(a) == tile_type) { ok = false; break; }
                if (PyTuple_CheckExact(a) && PyTuple_GET_SIZE(a) == 2 &&
                    (PyObject *)Py_TYPE(PyTuple_GET_ITEM(a, 0)) ==
                        tile_type) { ok = false; break; }
                if (!vals) {
                    vals = PyList_New(0);
                    if (!vals) { ok = false; break; }
                }
                if (PyList_Append(vals, a) < 0) { ok = false; break; }
            } else {
                if (!PyTuple_CheckExact(a) || PyTuple_GET_SIZE(a) != 2) {
                    ok = false; break;
                }
                int eq = PyObject_RichCompareBool(PyTuple_GET_ITEM(a, 1),
                                                  k, Py_EQ);
                if (eq <= 0) { ok = false; break; }
                PyObject *tile = PyTuple_GET_ITEM(a, 0);
                if ((PyObject *)Py_TYPE(tile) != tile_type) {
                    ok = false; break;
                }
                PyObject *nid = PyObject_GetAttr(tile, s_nid);
                if (!nid || nid == Py_None) {
                    if (!nid) PyErr_Clear();
                    Py_XDECREF(nid); ok = false; break;
                }
                owned.push_back(nid);
                flows.push_back(nid);
                flows.push_back(k);
            }
        }
        if (!ok) {
            if (PyErr_Occurred()) PyErr_Clear();
            for (PyObject *o : owned) Py_DECREF(o);
            Py_XDECREF(vals);
            return PyLong_FromLong(0);
        }
        spec = PyTuple_New(2 + (Py_ssize_t)flows.size());
        if (!spec) {
            for (PyObject *o : owned) Py_DECREF(o);
            Py_XDECREF(vals);
            return nullptr;
        }
        Py_INCREF(cls);
        PyTuple_SET_ITEM(spec, 0, cls);
        if (vals) {
            PyObject *vt = PyList_AsTuple(vals);
            Py_DECREF(vals);
            if (!vt) {
                for (PyObject *o : owned) Py_DECREF(o);
                Py_DECREF(spec);
                return nullptr;
            }
            PyTuple_SET_ITEM(spec, 1, vt);
        } else {
            Py_INCREF(Py_None);
            PyTuple_SET_ITEM(spec, 1, Py_None);
        }
        for (size_t i = 0; i < flows.size(); i += 2) {
            PyTuple_SET_ITEM(spec, 2 + (Py_ssize_t)i, flows[i]); // owned nid
            Py_INCREF(flows[i + 1]);
            PyTuple_SET_ITEM(spec, 3 + (Py_ssize_t)i, flows[i + 1]);
        }
    }
    int rc = PyList_Append(buf, spec);
    Py_DECREF(spec);
    if (rc < 0) return nullptr;
    long flushn = PyLong_AsLong(flushn_o);
    if (flushn > 0 && PyList_GET_SIZE(buf) >= flushn)
        return PyLong_FromLong(2);
    return PyLong_FromLong(1);
}

PyMethodDef ptdtd_functions[] = {
    {"try_buffer",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)(void)>(ptdtd_try_buffer)),
     METH_FASTCALL,
     "insert_task fast path: validate one call against the pool's fast "
     "cache and append its batch spec (0=slow path, 1=buffered, "
     "2=buffered+flush)"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject EngineType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptdtd.Engine";
    t.tp_basicsize = sizeof(Engine);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "single-rank DTD dependency engine (native hot path)";
    t.tp_new = engine_new;
    t.tp_dealloc = engine_dealloc;
    t.tp_methods = engine_methods;
    return t;
}();

PyModuleDef ptdtd_module = {
    PyModuleDef_HEAD_INIT, "_ptdtd",
    "native DTD dependency engine (see csrc/ptdtd.cpp)", -1,
    ptdtd_functions, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__ptdtd(void) {
    if (PyType_Ready(&EngineType) < 0) return nullptr;
    s_nid = PyUnicode_InternFromString("nid");
    s_zero = PyLong_FromLong(0);
    s_devall = PyLong_FromLong(0xFF);
    if (!s_nid || !s_zero || !s_devall) return nullptr;
    PyObject *m = PyModule_Create(&ptdtd_module);
    if (!m) return nullptr;
    Py_INCREF(&EngineType);
    if (PyModule_AddObject(m, "Engine",
                           reinterpret_cast<PyObject *>(&EngineType)) < 0) {
        Py_DECREF(&EngineType);
        Py_DECREF(m);
        return nullptr;
    }
    if (PyModule_AddIntConstant(m, "EV_LINK", EV_LINK) < 0 ||
        PyModule_AddIntConstant(m, "EV_EXEC", EV_EXEC) < 0 ||
        PyModule_AddIntConstant(m, "EV_TASK", EV_TASK) < 0 ||
        PyModule_AddIntConstant(m, "EV_PT_LINK", EV_PT_LINK) < 0 ||
        PyModule_AddIntConstant(m, "EV_PT_DONE", EV_PT_DONE) < 0 ||
        PyModule_AddIntConstant(m, "HIST_BUCKETS", pthist::NBUCKETS) < 0 ||
        PyModule_AddIntConstant(m, "HIST_SUB_BITS", pthist::SUB_BITS) < 0) {
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
