// parsec_tpu_torch._ptexec — the generic task FSM as a CPython extension.
//
// Stands where the reference's generated-C PTG execute path stands
// (the task FSM of parsec/scheduling.c:507-569 driven by generated
// release_deps/iterate_successors, parsec/parsec.c:1837): dependency-count
// decrement, ready-detect, dispatch, and successor release run inside ONE
// C call per *batch* of tasks. The lesson applied here is the same one the
// ahead-of-time compilation line of work draws (arXiv:1810.09868):
// lowering the whole CONTROL STRUCTURE out of the interpreted host
// language — not just the task bodies — is where the order of magnitude
// lives. The Python side (dsl/ptg/compiler.py) plays jdf2c: it flattens a
// PTG taskpool's dependency structure into the CSR successor table this
// engine consumes, once per (program, globals) shape.
//
// DATA-FLOW MODE (the second lowering): a graph may additionally carry
//   * per-task priorities — the ready structure becomes a max-heap, so a
//     pop always dispatches a maximal-priority ready task;
//   * an input-slot CSR + per-slot usage limits — the datarepo retire
//     protocol (core/datarepo.py usagelmt/usagecnt) moves HERE: every
//     data flow of every task owns one slot id; consuming tasks list
//     their input slots; the release sweep decrements the slot's atomic
//     remaining-use counter and reports fully-consumed slot ids back to
//     Python, which clears the payload reference. The payloads themselves
//     never cross into C — Python owns the slot *values* (a flat list),
//     C owns the slot *lifetimes*.
// In data mode the batch callback takes TWO arguments,
// (ready_ids, retired_slot_ids); without slots it keeps the historic
// one-argument form.
//
// Concurrency contract: run() may be called from MANY Python threads on
// the same Graph. The GIL is dropped for the whole FSM walk (ready-pop,
// decrement, release) and re-acquired only to dispatch a batch of
// non-empty task bodies through the Python callback — so for empty/CTL
// task classes the walk is GIL-free end to end and Context(nb_cores>1)
// in-process workers scale on real cores. Shared state is a small mutex
// around the ready structure plus per-task (and per-slot) atomic
// counters; the release decrement uses fetch_sub so two workers
// releasing into the same successor (or retiring the same slot) can
// never double-fire it.
//
// run() never blocks waiting for work: a starved worker returns to the
// Python hot loop (which has its own backoff and other task sources) and
// comes back — the "burst handoff into/out of the lane".

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
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

// in-lane trace event keys (registered in the PBP dictionary by
// the native trace bridge; see ptrace_ring.h for the ring contract)
constexpr uint32_t EV_TASK = 1;      // one interval per task's retire step
constexpr uint32_t EV_DISPATCH = 2;  // one interval per batched body dispatch
constexpr uint32_t EV_REGION = 3;    // one interval per fused-region body
                                     // (recorded via trace_mark from the
                                     // region dispatch wrapper)

// latency histogram slots (pthist.h; names mirrored by the histogram reader)
constexpr int H_EXEC = 0;        // per-task execute latency (batch-amortized)
constexpr int H_READY = 1;       // ready-push -> pop wait (sampled 1-in-8)
constexpr int N_HISTS = 2;
const char *const HIST_NAMES[N_HISTS] = {"exec_ns", "ready_wait_ns"};
// deterministic 1-in-8 sample by task id: the armed per-task cost of the
// ready-wait histogram is one predictable branch on 7/8 of the tasks
inline bool hist_sampled(int32_t tid) { return (tid & 7) == 0; }

struct Graph {
    PyObject_HEAD
    int64_t n;
    std::vector<int32_t> *goals;     // initial dep count per task
    std::vector<int32_t> *succ_off;  // CSR offsets, n+1 entries
    std::vector<int32_t> *succs;     // flattened successor ids
    std::vector<int32_t> *seeds;     // ids with goal 0
    std::atomic<int32_t> *counts;    // remaining deps per task
    std::mutex *mu;                  // guards ready/completed/running/error
    std::vector<int32_t> *ready;     // LIFO stack, or max-heap when prio set
    int64_t completed;
    int32_t running;                 // workers mid-batch
    bool error;                      // a callback raised somewhere
    // priority mode (empty prio, use_heap=false -> plain LIFO stack)
    std::vector<int32_t> *prio;      // per-task priority
    bool use_heap;
    // data-flow mode (empty in_off -> pure control graph)
    std::vector<int32_t> *in_off;    // CSR n+1: consumed slots per task
    std::vector<int32_t> *in_slots;  // flattened input slot ids
    std::vector<int32_t> *slot_uses; // usage limit per slot (the usagelmt)
    std::atomic<int32_t> *slot_cnt;  // remaining uses (usagelmt - usagecnt)
    std::vector<int32_t> *retired;   // fully-consumed slots awaiting Python
    int64_t n_slots;
    int64_t nb_slots_retired;        // total retired (guarded by mu)
    // in-lane event rings (null until trace_enable; one relaxed check per
    // run() call when tracing never was enabled)
    std::atomic<ptrace_ring::State *> trace;
    // latency histograms (null until hist_enable; same gating discipline)
    std::atomic<pthist::State<N_HISTS> *> hist;
    // per-task ready-push timestamp for the ready-wait histogram: written
    // only when histograms are armed AND the id is sampled; atomics
    // because the comm progress thread stamps ingested tasks GIL-free
    std::atomic<int64_t> *ready_stamp;
    // distributed mode (comm_bind): per-task owner ranks; edges into a
    // non-local successor surface as activation frames on the comm lane's
    // send queue instead of local decrements, and ingest_act() lets the
    // comm progress thread drop arrived decrements straight into the
    // ready structure — both directions GIL-free (ptcomm_iface.h)
    std::vector<int32_t> *owners;     // empty = single-rank graph
    int32_t my_rank;
    uint32_t pool_id;
    bool comm_bound;
    PtCommSendVtbl send;
    int64_t n_local;                  // tasks this rank executes
    // rendezvous gates: a slot whose payload is still being pulled parks
    // would-be-ready consumers until rdv_land() (guarded by mu)
    std::vector<uint8_t> *rdv_pending;  // per input slot, 1 = pulling
    std::vector<int32_t> *parked;       // ready tasks waiting on a pull
    std::atomic<int64_t> acts_tx;       // remote releases surfaced
    std::atomic<int64_t> acts_rx;       // remote decrements ingested
    std::atomic<int64_t> ingest_bad;    // out-of-range ids from the wire
    // device lane binding (dev_bind): tasks whose class carries
    // a device body never enter the ready structure — the moment they
    // become ready (release sweep, ingest, seeding) they surface onto the
    // ptdev lane's MPSC pending queue through the submit vtable, still
    // GIL-free (ptdev_iface.h). The lane's manager thread dispatches them
    // asynchronously and lands completions back through dev_retire(),
    // which runs the release walk exactly like a local CPU retire.
    bool dev_bound;
    uint32_t dev_pool;
    PtDevSubmitVtbl dsend;
    std::vector<uint8_t> *dev_mask;   // per task: 1 = device-bodied
    std::vector<uint8_t> *dev_ret;    // per task: 1 = already retired (a
                                      // duplicate/stale retire would
                                      // double-run the release walk and
                                      // underflow successor counters)
    std::atomic<int64_t> dev_tx;      // tasks surfaced onto the lane
    std::atomic<int64_t> dev_done;    // tasks retired by the lane
    std::atomic<int64_t> dev_bad;     // out-of-range/unmasked retire ids
    // region fusion (region_bind): a fused super-task node
    // stands for `weight[i]` original tasks — the CSR already carries
    // the union of the region's external in/out edges (built by the
    // compiler's fusion pass), so the release walk crosses the seam
    // correctly by construction; the weights make the task ACCOUNTING
    // cross it too: completed/pending/done and run()'s return value
    // count original tasks, not fused nodes.
    std::vector<int32_t> *weight;     // per node; empty = all 1
    bool weighted;
    int64_t w_total;                  // sum(weight) — the done() target
    // cost-model rows (cost_bind): per-node row ids into a
    // (count, sum_ns) accumulator pair. The rows ride the SAME batch-
    // amortized clock reads as the exec_ns histogram bump — when bound,
    // each executed task adds the per-task batch cost into its row with
    // two relaxed atomics; nothing new touches the clock. Rows group
    // tasks by (class, shape bucket, device flavor); the Python side
    // keeps the row -> key metadata and folds snapshots into the online
    // cost model at the histogram registry's detach points. -1 = node
    // not attributed (no extra cost for it beyond the row load).
    std::vector<int32_t> *cost_rows;  // per node row id; empty = unbound
    std::atomic<uint64_t> *cost_cnt;  // per row: tasks accumulated
    std::atomic<uint64_t> *cost_sum;  // per row: summed amortized ns
    int32_t n_cost_rows;
    // scheduler plane binding (sched_bind): when set, the ready
    // structure lives in the shared multi-pool plane (pool `spool`) — N
    // concurrent lane graphs then share the workers by DRR weight instead
    // of whoever sits at the front of the context's lane queue. The
    // capsule ref keeps the plane alive for the binding window.
    ptsched::Plane *splane;
    int32_t spool;
    PyObject *sched_cap;
};

bool parse_i32_list(PyObject *obj, std::vector<int32_t> &out,
                    const char *what) {
    PyObject *fast = PySequence_Fast(obj, what);
    if (!fast) return false;
    Py_ssize_t k = PySequence_Fast_GET_SIZE(fast);
    out.resize((size_t)k);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < k; i++) {
        long v = PyLong_AsLong(items[i]);
        if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return false; }
        out[(size_t)i] = (int32_t)v;
    }
    Py_DECREF(fast);
    return true;
}

// max-heap ordering on (priority, id): a pop yields a maximal-priority
// ready task; among equal priorities the higher id wins (deterministic,
// roughly LIFO for sequentially-released work).
struct PrioLess {
    const int32_t *p;
    bool operator()(int32_t a, int32_t b) const {
        return p[a] < p[b] || (p[a] == p[b] && a < b);
    }
};

// mu held. True when any of task `t`'s input slots is mid-rendezvous.
bool slots_pending_locked(Graph *g, int32_t t) {
    if (g->rdv_pending->empty() || g->in_off->empty()) return false;
    const int32_t *ioff = g->in_off->data();
    const int32_t *islot = g->in_slots->data();
    const uint8_t *pend = g->rdv_pending->data();
    for (int32_t k = ioff[t]; k < ioff[t + 1]; k++)
        if (pend[islot[k]]) return true;
    return false;
}

// mu held. Enter the ready structure (heap-aware) unless an input slot's
// rendezvous is still in flight — then park until rdv_land(). With a
// scheduler plane bound the item enters the plane instead (anonymous
// producer: the callers here — ingest, rdv_land, seeding — have no worker
// identity; the run() release sweep pushes batched with its worker id).
// Device-bodied tasks take neither path: they surface straight onto the
// ptdev lane (lock-free submit; mu-held is fine, it never blocks).
void push_ready_locked(Graph *g, int32_t s) {
    if (g->dev_bound && (*g->dev_mask)[(size_t)s]) {
        g->dsend.submit(g->dsend.dev, g->dev_pool, s);
        // dev_tx/dev_done stay ORIGINAL-task denominated: a fused
        // region node surfaces once but counts its whole region
        g->dev_tx.fetch_add(
            g->weighted ? (*g->weight)[(size_t)s] : 1,
            std::memory_order_relaxed);
        return;
    }
    if (g->comm_bound && slots_pending_locked(g, s)) {
        g->parked->push_back(s);
        return;
    }
    if (g->splane) {
        int32_t prio = g->use_heap ? (*g->prio)[(size_t)s] : 0;
        g->splane->push(g->spool, -1, &s, g->use_heap ? &prio : nullptr, 1);
        return;
    }
    g->ready->push_back(s);
    if (g->use_heap)
        std::push_heap(g->ready->begin(), g->ready->end(),
                       PrioLess{g->prio->data()});
}

// fill `prios` with the per-task priorities of `ids` for a plane push
// (heap pools only); returns the array to pass, or null for non-heap.
// Shared by seeding (reset), the bind-time migration, and the release
// sweep so the priority-stamping rule lives in one place.
const int32_t *gather_prios(Graph *g, const std::vector<int32_t> &ids,
                            std::vector<int32_t> &prios) {
    if (!g->use_heap) return nullptr;
    prios.clear();
    prios.reserve(ids.size());
    for (int32_t s : ids) prios.push_back((*g->prio)[(size_t)s]);
    return prios.data();
}

// mu held. Sweep device-bodied ids out of the private ready structure and
// surface them onto the ptdev lane — the hand-off moment of dev_bind (and
// of a reset on a bound graph): seeds landed in `ready` before the lane
// existed. Returns the count surfaced.
int64_t dev_sweep_ready_locked(Graph *g) {
    if (!g->dev_bound || g->ready->empty()) return 0;
    const uint8_t *dmask = g->dev_mask->data();
    int64_t sent = 0;
    size_t w = 0;
    std::vector<int32_t> &rd = *g->ready;
    for (size_t i = 0; i < rd.size(); i++) {
        int32_t s = rd[i];
        if (dmask[s]) {
            g->dsend.submit(g->dsend.dev, g->dev_pool, s);
            sent += g->weighted ? (*g->weight)[(size_t)s] : 1;
        } else {
            rd[w++] = s;
        }
    }
    rd.resize(w);
    if (sent) {
        g->dev_tx.fetch_add(sent, std::memory_order_relaxed);
        if (g->use_heap)
            std::make_heap(rd.begin(), rd.end(), PrioLess{g->prio->data()});
    }
    return sent;
}

// recompute the seed list: with owners bound, only LOCAL zero-goal tasks
// may ever enter the ready structure (remote tasks run on their rank)
void graph_rebuild_seeds(Graph *self) {
    self->seeds->clear();
    self->n_local = 0;
    const bool bound = self->comm_bound;
    for (int64_t i = 0; i < self->n; i++) {
        if (bound && (*self->owners)[(size_t)i] != self->my_rank) continue;
        self->n_local++;
        if ((*self->goals)[(size_t)i] == 0)
            self->seeds->push_back((int32_t)i);
    }
}

void graph_reset_state(Graph *self) {
    for (int64_t i = 0; i < self->n; i++)
        self->counts[i].store((*self->goals)[(size_t)i],
                              std::memory_order_relaxed);
    if (self->splane) {
        // plane-resident ready structure: flush stale items of an
        // abandoned run, then seed the pool afresh (device-bodied seeds
        // surface onto the ptdev lane, never the plane)
        self->splane->pool_clear(self->spool);
        *self->ready = *self->seeds;
        dev_sweep_ready_locked(self);
        if (!self->ready->empty()) {
            std::vector<int32_t> prios;
            self->splane->push(self->spool, -1, self->ready->data(),
                               gather_prios(self, *self->ready, prios),
                               (int)self->ready->size());
        }
        self->ready->clear();
    } else {
        *self->ready = *self->seeds;
        if (self->use_heap)
            std::make_heap(self->ready->begin(), self->ready->end(),
                           PrioLess{self->prio->data()});
        dev_sweep_ready_locked(self);   // device seeds surface to the lane
    }
    std::fill(self->rdv_pending->begin(), self->rdv_pending->end(),
              (uint8_t)0);
    std::fill(self->dev_ret->begin(), self->dev_ret->end(), (uint8_t)0);
    self->parked->clear();
    for (int64_t j = 0; j < self->n_slots; j++)
        self->slot_cnt[j].store((*self->slot_uses)[(size_t)j],
                                std::memory_order_relaxed);
    self->retired->clear();
    self->nb_slots_retired = 0;
    self->completed = 0;
    self->running = 0;
    self->error = false;
    if (self->ready_stamp)
        for (int64_t i = 0; i < self->n; i++)
            self->ready_stamp[i].store(0, std::memory_order_relaxed);
}

PyObject *graph_new(PyTypeObject *type, PyObject *args, PyObject *) {
    PyObject *goals_o, *off_o, *succs_o;
    PyObject *prio_o = Py_None, *in_off_o = Py_None, *in_slots_o = Py_None,
             *uses_o = Py_None;
    if (!PyArg_ParseTuple(args, "OOO|OOOO", &goals_o, &off_o, &succs_o,
                          &prio_o, &in_off_o, &in_slots_o, &uses_o))
        return nullptr;
    Graph *self = reinterpret_cast<Graph *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    self->goals = new (std::nothrow) std::vector<int32_t>();
    self->succ_off = new (std::nothrow) std::vector<int32_t>();
    self->succs = new (std::nothrow) std::vector<int32_t>();
    self->seeds = new (std::nothrow) std::vector<int32_t>();
    self->ready = new (std::nothrow) std::vector<int32_t>();
    self->mu = new (std::nothrow) std::mutex();
    self->prio = new (std::nothrow) std::vector<int32_t>();
    self->in_off = new (std::nothrow) std::vector<int32_t>();
    self->in_slots = new (std::nothrow) std::vector<int32_t>();
    self->slot_uses = new (std::nothrow) std::vector<int32_t>();
    self->retired = new (std::nothrow) std::vector<int32_t>();
    self->counts = nullptr;
    self->slot_cnt = nullptr;
    self->use_heap = false;
    self->n_slots = 0;
    new (&self->trace) std::atomic<ptrace_ring::State *>(nullptr);
    new (&self->hist) std::atomic<pthist::State<N_HISTS> *>(nullptr);
    self->ready_stamp = nullptr;
    self->owners = new (std::nothrow) std::vector<int32_t>();
    self->rdv_pending = new (std::nothrow) std::vector<uint8_t>();
    self->parked = new (std::nothrow) std::vector<int32_t>();
    self->my_rank = 0;
    self->pool_id = 0;
    self->comm_bound = false;
    self->send = PtCommSendVtbl{0, nullptr, nullptr};
    self->n_local = 0;
    new (&self->acts_tx) std::atomic<int64_t>(0);
    new (&self->acts_rx) std::atomic<int64_t>(0);
    new (&self->ingest_bad) std::atomic<int64_t>(0);
    self->dev_bound = false;
    self->dev_pool = 0;
    self->dsend = PtDevSubmitVtbl{0, nullptr, nullptr};
    self->dev_mask = new (std::nothrow) std::vector<uint8_t>();
    self->dev_ret = new (std::nothrow) std::vector<uint8_t>();
    new (&self->dev_tx) std::atomic<int64_t>(0);
    new (&self->dev_done) std::atomic<int64_t>(0);
    new (&self->dev_bad) std::atomic<int64_t>(0);
    self->weight = new (std::nothrow) std::vector<int32_t>();
    self->weighted = false;
    self->w_total = 0;
    self->cost_rows = new (std::nothrow) std::vector<int32_t>();
    self->cost_cnt = nullptr;
    self->cost_sum = nullptr;
    self->n_cost_rows = 0;
    self->splane = nullptr;
    self->spool = -1;
    self->sched_cap = nullptr;
    if (!self->goals || !self->succ_off || !self->succs || !self->seeds ||
        !self->ready || !self->mu || !self->prio || !self->in_off ||
        !self->in_slots || !self->slot_uses || !self->retired ||
        !self->owners || !self->rdv_pending || !self->parked ||
        !self->dev_mask || !self->dev_ret || !self->weight ||
        !self->cost_rows) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    if (!parse_i32_list(goals_o, *self->goals, "goals: sequence of ints") ||
        !parse_i32_list(off_o, *self->succ_off, "succ_off: sequence of ints") ||
        !parse_i32_list(succs_o, *self->succs, "succs: sequence of ints")) {
        Py_DECREF(self);
        return nullptr;
    }
    if (prio_o != Py_None &&
        !parse_i32_list(prio_o, *self->prio, "prio: sequence of ints")) {
        Py_DECREF(self);
        return nullptr;
    }
    if (in_off_o != Py_None) {
        if (in_slots_o == Py_None || uses_o == Py_None) {
            PyErr_SetString(PyExc_TypeError,
                            "in_off requires in_slots and slot_uses");
            Py_DECREF(self);
            return nullptr;
        }
        if (!parse_i32_list(in_off_o, *self->in_off,
                            "in_off: sequence of ints") ||
            !parse_i32_list(in_slots_o, *self->in_slots,
                            "in_slots: sequence of ints") ||
            !parse_i32_list(uses_o, *self->slot_uses,
                            "slot_uses: sequence of ints")) {
            Py_DECREF(self);
            return nullptr;
        }
    }
    self->n = (int64_t)self->goals->size();
    // structural validation once at build: run() then needs no bounds checks
    if ((int64_t)self->succ_off->size() != self->n + 1) {
        PyErr_SetString(PyExc_ValueError, "succ_off must have n+1 entries");
        Py_DECREF(self);
        return nullptr;
    }
    int32_t prev = 0;
    for (int32_t o : *self->succ_off) {
        if (o < prev || (size_t)o > self->succs->size()) {
            PyErr_SetString(PyExc_ValueError, "succ_off not monotone in-range");
            Py_DECREF(self);
            return nullptr;
        }
        prev = o;
    }
    if (!self->succ_off->empty() &&
        (size_t)self->succ_off->back() != self->succs->size()) {
        PyErr_SetString(PyExc_ValueError, "succ_off must end at len(succs)");
        Py_DECREF(self);
        return nullptr;
    }
    for (int32_t s : *self->succs) {
        if (s < 0 || (int64_t)s >= self->n) {
            PyErr_SetString(PyExc_ValueError, "successor id out of range");
            Py_DECREF(self);
            return nullptr;
        }
    }
    if (!self->prio->empty()) {
        if ((int64_t)self->prio->size() != self->n) {
            PyErr_SetString(PyExc_ValueError, "prio must have n entries");
            Py_DECREF(self);
            return nullptr;
        }
        for (int32_t p : *self->prio)
            if (p != 0) { self->use_heap = true; break; }
        if (!self->use_heap) self->prio->clear();   // all-zero: plain stack
    }
    if (!self->in_off->empty()) {
        self->n_slots = (int64_t)self->slot_uses->size();
        if ((int64_t)self->in_off->size() != self->n + 1) {
            PyErr_SetString(PyExc_ValueError, "in_off must have n+1 entries");
            Py_DECREF(self);
            return nullptr;
        }
        prev = 0;
        for (int32_t o : *self->in_off) {
            if (o < prev || (size_t)o > self->in_slots->size()) {
                PyErr_SetString(PyExc_ValueError,
                                "in_off not monotone in-range");
                Py_DECREF(self);
                return nullptr;
            }
            prev = o;
        }
        if ((size_t)self->in_off->back() != self->in_slots->size()) {
            PyErr_SetString(PyExc_ValueError,
                            "in_off must end at len(in_slots)");
            Py_DECREF(self);
            return nullptr;
        }
        for (int32_t j : *self->in_slots) {
            if (j < 0 || (int64_t)j >= self->n_slots) {
                PyErr_SetString(PyExc_ValueError, "input slot id out of range");
                Py_DECREF(self);
                return nullptr;
            }
        }
        for (int32_t u : *self->slot_uses) {
            if (u < 0) {
                PyErr_SetString(PyExc_ValueError, "negative slot usage limit");
                Py_DECREF(self);
                return nullptr;
            }
        }
    }
    for (int64_t i = 0; i < self->n; i++) {
        if ((*self->goals)[(size_t)i] < 0) {
            PyErr_SetString(PyExc_ValueError, "negative goal");
            Py_DECREF(self);
            return nullptr;
        }
    }
    graph_rebuild_seeds(self);
    if (self->n_slots)
        self->rdv_pending->assign((size_t)self->n_slots, 0);
    self->counts = new (std::nothrow) std::atomic<int32_t>[(size_t)self->n];
    if (self->n && !self->counts) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    self->slot_cnt = new (std::nothrow)
        std::atomic<int32_t>[(size_t)self->n_slots];
    if (self->n_slots && !self->slot_cnt) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    // allocated at build (8 bytes/task) so hist_enable mid-run never
    // races a GIL-free worker against a growing buffer; written only
    // when histograms are armed
    self->ready_stamp = new (std::nothrow)
        std::atomic<int64_t>[(size_t)self->n];
    if (self->n && !self->ready_stamp) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    graph_reset_state(self);
    return reinterpret_cast<PyObject *>(self);
}

void graph_dealloc(PyObject *obj) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    if (self->splane) {
        // a graph dying while bound owns its pool slot: free it so the
        // plane never serves stale ids from a dead graph
        self->splane->pool_unregister(self->spool);
        self->splane = nullptr;
    }
    Py_CLEAR(self->sched_cap);
    delete self->goals;
    delete self->succ_off;
    delete self->succs;
    delete self->seeds;
    delete self->ready;
    delete self->mu;
    delete self->prio;
    delete self->in_off;
    delete self->in_slots;
    delete self->slot_uses;
    delete self->retired;
    delete self->owners;
    delete self->rdv_pending;
    delete self->parked;
    delete self->dev_mask;
    delete self->dev_ret;
    delete self->weight;
    delete self->cost_rows;
    delete[] self->cost_cnt;
    delete[] self->cost_sum;
    delete[] self->counts;
    delete[] self->slot_cnt;
    delete[] self->ready_stamp;
    delete self->trace.load(std::memory_order_acquire);
    delete self->hist.load(std::memory_order_acquire);
    Py_TYPE(obj)->tp_free(obj);
}

// reset() — rewind for replay of the same DAG shape (the cached-graph
// reuse that makes a repeated instantiation cost a memcpy, not a rebuild).
// Refused while any worker is mid-run.
PyObject *graph_reset(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (self->running > 0) {
            PyErr_SetString(PyExc_RuntimeError,
                            "reset() while workers are running");
            return nullptr;
        }
    }
    graph_reset_state(self);
    Py_RETURN_NONE;
}

// run(callback, batch, budget) -> number of tasks this caller executed.
//
//   callback: None for empty bodies (pure C walk), else a callable taking
//             one list of ready task ids — or, on a data-mode graph, TWO
//             arguments (ready_ids, retired_slot_ids) — it must run every
//             body; the engine releases those tasks' successors only
//             AFTER it returns (so an observer ordering recorded inside
//             bodies always respects every release edge).
//   batch:    max ids per callback call / per release sweep.
//   budget:   return after executing >= budget tasks even if the graph is
//             not finished (0 = run until starved or done). The caller's
//             hot loop interleaves other work and re-enters.
//
// Returns promptly (never blocks) when the ready structure is empty; check
// done() to distinguish "finished" from "starved while peers run".
PyObject *graph_run(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *callback = Py_None;
    int batch = 256;
    long long budget = 0;
    int wid = 0;    // worker id — the scheduler plane's hot-queue affinity
    if (!PyArg_ParseTuple(args, "|OiLi", &callback, &batch, &budget, &wid))
        return nullptr;
    if (batch <= 0) batch = 256;
    if (callback != Py_None && !PyCallable_Check(callback)) {
        PyErr_SetString(PyExc_TypeError, "callback must be callable or None");
        return nullptr;
    }
    const bool data_mode = !self->in_off->empty();
    if (data_mode && callback == Py_None && self->n_slots > 0) {
        // slot values live in Python; a data walk without the dispatcher
        // would retire slots nobody ever clears or reads
        PyErr_SetString(PyExc_TypeError,
                        "data-mode graph requires a callback");
        return nullptr;
    }
    const int32_t *off = self->succ_off->data();
    const int32_t *succ = self->succs->data();
    const int32_t *ioff = data_mode ? self->in_off->data() : nullptr;
    const int32_t *islot = data_mode ? self->in_slots->data() : nullptr;
    const PrioLess cmp{self->use_heap ? self->prio->data() : nullptr};
    std::vector<int32_t> local, fresh, freed, fprio;
    local.reserve((size_t)batch);
    // plane-resident ready structure: pops come out of the shared
    // scheduler plane (hot queue -> pool overflow -> steal) instead of
    // the private vector; pushes go back with this worker's identity
    ptsched::Plane *const spl = self->splane;
    int64_t mine = 0;
    // in-lane tracing: claim a per-worker ring for this call's duration
    // (tw.st stays null when tracing is off — one predictable branch per
    // event site; when tracing is on but every ring is claimed, rec()
    // counts the lost events into State::unclaimed so the drop accounting
    // stays honest, see ptrace_ring.h); the destructor releases the claim
    // on every exit path including a raising callback
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    const bool tr = tw.st != nullptr;
    // latency histograms: one acquire load per run() call; a disabled
    // state degrades to the same null branch as never-enabled
    pthist::State<N_HISTS> *hs = self->hist.load(std::memory_order_acquire);
    if (hs && !hs->enabled.load(std::memory_order_relaxed)) hs = nullptr;
    // cost-model rows: when bound, the exec bump's amortized per-task
    // cost also lands in the per-row accumulators (cost_bind precedes
    // run() on the enqueue path, so no mid-run race on the vector)
    const int32_t *crow =
        self->cost_rows->empty() ? nullptr : self->cost_rows->data();
    int64_t h_t0 = 0;
    PyThreadState *ts = PyEval_SaveThread();   // GIL dropped for the walk
    for (;;) {
        bool stop = false;
        if (spl) {
            local.resize((size_t)batch);
            int got = spl->pop_pool(self->spool, wid, local.data(), batch);
            local.resize((size_t)got);
            if (got == 0) {
                // drain private-vector leftovers: a graph bound to the
                // plane MID-RUN (lazy arming on the second concurrent
                // pool) may have peers with a pre-bind snapshot still
                // pushing releases into the old structure
                std::lock_guard<std::mutex> lk(*self->mu);
                if (!self->error && !self->ready->empty()) {
                    size_t take =
                        std::min((size_t)batch, self->ready->size());
                    if (self->use_heap) {
                        local.clear();
                        for (size_t i = 0; i < take; i++) {
                            std::pop_heap(self->ready->begin(),
                                          self->ready->end(), cmp);
                            local.push_back(self->ready->back());
                            self->ready->pop_back();
                        }
                    } else {
                        local.assign(self->ready->end() - (ptrdiff_t)take,
                                     self->ready->end());
                        self->ready->resize(self->ready->size() - take);
                    }
                    self->running++;
                } else {
                    local.clear();
                    stop = true;   // starved (or done) — caller decides
                }
            } else {
                std::lock_guard<std::mutex> lk(*self->mu);
                if (self->error) {
                    // poisoned while we popped: drop the claim (the graph
                    // never completes once poisoned, ids need no return)
                    local.clear();
                    stop = true;
                } else {
                    self->running++;
                }
            }
        } else {
            std::lock_guard<std::mutex> lk(*self->mu);
            if (self->error || self->ready->empty()) {
                stop = true;   // done, starved, or poisoned — caller decides
            } else {
                size_t take = std::min((size_t)batch, self->ready->size());
                if (self->use_heap) {
                    // priority pops: the batch comes out highest-first
                    for (size_t i = 0; i < take; i++) {
                        std::pop_heap(self->ready->begin(),
                                      self->ready->end(), cmp);
                        local.push_back(self->ready->back());
                        self->ready->pop_back();
                    }
                } else {
                    local.assign(self->ready->end() - (ptrdiff_t)take,
                                 self->ready->end());
                    self->ready->resize(self->ready->size() - take);
                }
                self->running++;
            }
        }
        if (stop) break;
        if (hs || crow) {
            // ready-queue wait (sampled): pop time minus the stamped
            // push time; unstamped ids (armed mid-flight) are skipped.
            // One clock read per batch — reused as the exec-latency
            // start, and as the cost-row batch start: the
            // cost model rides the histogram's clock reads, it never
            // adds its own
            int64_t now = ptrace_ring::now_ns();
            if (hs) {
                for (int32_t t : local) {
                    if (!hist_sampled(t)) continue;
                    int64_t s0 =
                        self->ready_stamp[t].load(std::memory_order_relaxed);
                    if (s0 > 0) hs->h[H_READY].add(now - s0);
                }
            }
            h_t0 = now;
        }
        if (callback != Py_None) {
            PyEval_RestoreThread(ts);
            ts = nullptr;
            if (tr)
                tw.rec(EV_DISPATCH, (int64_t)local.size(),
                       ptrace_ring::FLAG_START);
            PyObject *ids = PyList_New((Py_ssize_t)local.size());
            PyObject *r = nullptr;
            if (ids) {
                for (size_t i = 0; i < local.size(); i++)
                    PyList_SET_ITEM(ids, (Py_ssize_t)i,
                                    PyLong_FromLong(local[i]));
                if (data_mode) {
                    // hand over every slot retired since the last dispatch
                    // (by ANY worker): the consumer bodies that used them
                    // have all returned, so Python may drop the payloads
                    std::vector<int32_t> ret;
                    {
                        std::lock_guard<std::mutex> lk(*self->mu);
                        ret.swap(*self->retired);
                    }
                    PyObject *rl = PyList_New((Py_ssize_t)ret.size());
                    if (rl) {
                        for (size_t i = 0; i < ret.size(); i++)
                            PyList_SET_ITEM(rl, (Py_ssize_t)i,
                                            PyLong_FromLong(ret[i]));
                        r = PyObject_CallFunctionObjArgs(callback, ids, rl,
                                                         nullptr);
                        Py_DECREF(rl);
                    }
                } else {
                    r = PyObject_CallFunctionObjArgs(callback, ids, nullptr);
                }
                Py_DECREF(ids);
                Py_XDECREF(r);
            }
            if (!r) {
                // a body raised: poison the graph so peers stop pulling
                // work, undo our in-flight claim, propagate the exception
                std::lock_guard<std::mutex> lk(*self->mu);
                self->error = true;
                self->running--;
                return nullptr;
            }
            if (tr)
                tw.rec(EV_DISPATCH, (int64_t)local.size(),
                       ptrace_ring::FLAG_END);
            ts = PyEval_SaveThread();
        }
        fresh.clear();
        freed.clear();
        const bool bound = self->comm_bound;
        const int32_t *own = bound ? self->owners->data() : nullptr;
        const bool devb = self->dev_bound;
        const uint8_t *dmask = devb ? self->dev_mask->data() : nullptr;
        int64_t sent = 0, dsent = 0;
        for (int32_t t : local) {
            if (tr) tw.rec(EV_TASK, t, ptrace_ring::FLAG_START);
            for (int32_t k = off[t]; k < off[t + 1]; k++) {
                int32_t s = succ[k];
                if (bound && own[s] != self->my_rank) {
                    // remote successor: the dep-release crosses ranks as
                    // an activation frame — enqueue onto the comm lane's
                    // lock-free send queue, still GIL-free (the funneled
                    // progress thread does the wire work)
                    self->send.send_act(self->send.comm, own[s],
                                        self->pool_id, s);
                    sent++;
                    continue;
                }
                if (self->counts[s].fetch_sub(
                        1, std::memory_order_acq_rel) == 1) {
                    if (devb && dmask[s]) {
                        // device-bodied successor: surfaces onto the
                        // ptdev lane's pending queue instead of the
                        // ready structure — still GIL-free, never blocks
                        self->dsend.submit(self->dsend.dev, self->dev_pool,
                                           s);
                        dsent += self->weighted
                                     ? (*self->weight)[(size_t)s] : 1;
                    } else {
                        fresh.push_back(s);
                    }
                }
            }
            if (data_mode) {
                // the datarepo retire protocol: this task's bodies have
                // run, so each input slot records one completed use; the
                // LAST use retires the slot (usagecnt meets usagelmt)
                for (int32_t k = ioff[t]; k < ioff[t + 1]; k++) {
                    int32_t j = islot[k];
                    if (self->slot_cnt[j].fetch_sub(
                            1, std::memory_order_acq_rel) == 1)
                        freed.push_back(j);
                }
            }
            if (tr) tw.rec(EV_TASK, t, ptrace_ring::FLAG_END);
        }
        if (sent)
            self->acts_tx.fetch_add(sent, std::memory_order_relaxed);
        if (dsent)
            self->dev_tx.fetch_add(dsent, std::memory_order_relaxed);
        if (hs && !fresh.empty()) {
            // stamp sampled newly-ready ids before they enter the ready
            // structure (one clock read per release batch; plain stores)
            int64_t now = ptrace_ring::now_ns();
            for (int32_t s : fresh)
                if (hist_sampled(s))
                    self->ready_stamp[s].store(now,
                                               std::memory_order_relaxed);
        }
        // weighted accounting (region fusion): a fused node retires as
        // `weight` original tasks — completed/mine stay task-denominated
        int64_t batch_w = (int64_t)local.size();
        if (self->weighted) {
            batch_w = 0;
            const int32_t *wts = self->weight->data();
            for (int32_t t : local) batch_w += wts[t];
        }
        // plane-bound graphs push releases AFTER the bookkeeping lock
        // drops (the plane has its own locks; rdv-gated distributed data
        // pools keep the per-item mu-held path, which is plane-aware)
        const bool plane_batch = spl && !(bound && !self->in_off->empty());
        {
            std::lock_guard<std::mutex> lk(*self->mu);
            self->completed += batch_w;
            self->running--;
            if (!fresh.empty() && !plane_batch) {
                if (bound && !self->in_off->empty()) {
                    // distributed data pool: gate on in-flight rendezvous
                    for (int32_t s : fresh) push_ready_locked(self, s);
                } else if (self->use_heap) {
                    for (int32_t s : fresh) {
                        self->ready->push_back(s);
                        std::push_heap(self->ready->begin(),
                                       self->ready->end(), cmp);
                    }
                } else {
                    self->ready->insert(self->ready->end(), fresh.begin(),
                                        fresh.end());
                }
            }
            if (!freed.empty()) {
                self->retired->insert(self->retired->end(), freed.begin(),
                                      freed.end());
                self->nb_slots_retired += (int64_t)freed.size();
            }
        }
        if (plane_batch && !fresh.empty())
            spl->push(self->spool, wid, fresh.data(),
                      gather_prios(self, fresh, fprio),
                      (int)fresh.size());
        if ((hs || crow) && !local.empty()) {
            // per-task execute latency, batch-amortized: the whole
            // dispatch + release sweep cost divided across the batch,
            // bumped once with the batch count — two clock reads and
            // three atomics per ~256 tasks keeps the armed overhead
            // inside the <2% contract. batch_w keeps the denominator
            // ORIGINAL-task denominated on fused pools, like every
            // other counter in this sweep
            int64_t per = (ptrace_ring::now_ns() - h_t0) / batch_w;
            if (hs) hs->h[H_EXEC].add(per, (uint64_t)batch_w);
            if (crow) {
                // cost rows: the same amortized cost, split
                // by the compiler's (class, bucket, device) rows — two
                // relaxed atomics per task, no extra clock reads. The
                // weight keeps fused nodes original-task denominated,
                // matching the histogram and w_total accounting.
                const int32_t *wts =
                    self->weighted ? self->weight->data() : nullptr;
                for (int32_t t : local) {
                    int32_t r = crow[t];
                    if (r < 0) continue;
                    uint64_t w = wts ? (uint64_t)wts[t] : 1;
                    self->cost_cnt[r].fetch_add(w,
                                                std::memory_order_relaxed);
                    self->cost_sum[r].fetch_add((uint64_t)per * w,
                                                std::memory_order_relaxed);
                }
            }
        }
        mine += batch_w;
        local.clear();
        if (budget > 0 && mine >= budget) break;
    }
    if (ts) PyEval_RestoreThread(ts);
    return PyLong_FromLongLong(mine);
}

// the completion target: original-task denominated once regions are
// bound (w_total = sum of node weights), node count otherwise
inline int64_t done_target(const Graph *g) {
    return g->weighted ? g->w_total : g->n_local;
}

PyObject *graph_done(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    bool ready_empty =
        self->ready->empty() &&
        (!self->splane || self->splane->queued_of(self->spool) == 0);
    if (!self->error && self->completed == done_target(self) &&
        ready_empty && self->running == 0)
        Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

PyObject *graph_failed(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->error) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

PyObject *graph_idle(PyObject *obj, PyObject *) {
    // True when no worker holds a claimed batch. After a poison (error
    // set) no worker can claim a NEW batch, so idle==True is then stable
    // — the safe moment for Python to drop the slot payloads of an
    // abandoned data-mode graph (a mid-callback peer still reads them).
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->running == 0) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

PyObject *graph_pending(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return PyLong_FromLongLong(done_target(self) - self->completed);
}

// ------------------------------------------------------- comm lane binding

// The GIL-free entry points the comm progress thread calls through the
// PtCommIngestVtbl capsule (ptcomm_iface.h). Out-of-range ids from the
// wire are counted, never trusted.
void graph_ingest_act_c(void *obj, int32_t tid) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    if (tid < 0 || (int64_t)tid >= self->n ||
        (self->comm_bound &&
         (*self->owners)[(size_t)tid] != self->my_rank)) {
        // in-range but REMOTE-owned ids are just as untrusted as
        // out-of-range ones: decrementing them could locally execute a
        // task this rank does not own and wedge done() accounting
        self->ingest_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    self->acts_rx.fetch_add(1, std::memory_order_relaxed);
    if (self->counts[tid].fetch_sub(1, std::memory_order_acq_rel) == 1) {
        pthist::State<N_HISTS> *hs =
            self->hist.load(std::memory_order_acquire);
        if (hs && hs->enabled.load(std::memory_order_relaxed) &&
            hist_sampled(tid))
            self->ready_stamp[tid].store(ptrace_ring::now_ns(),
                                         std::memory_order_relaxed);
        std::lock_guard<std::mutex> lk(*self->mu);
        push_ready_locked(self, tid);
    }
}

void graph_rdv_begin_c(void *obj, int32_t slot) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (slot < 0 || (int64_t)slot >= self->n_slots) {
        self->ingest_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    (*self->rdv_pending)[(size_t)slot] = 1;
}

void graph_rdv_land_c(void *obj, int32_t slot) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (slot < 0 || (int64_t)slot >= self->n_slots) {
        self->ingest_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    (*self->rdv_pending)[(size_t)slot] = 0;
    if (self->parked->empty()) return;
    // re-examine parked consumers: any with no remaining in-flight pulls
    // becomes ready (others stay parked for their other slots)
    size_t w = 0;
    std::vector<int32_t> &pk = *self->parked;
    for (size_t i = 0; i < pk.size(); i++) {
        int32_t t = pk[i];
        if (slots_pending_locked(self, t)) {
            pk[w++] = t;
        } else {
            self->ready->push_back(t);
            if (self->use_heap)
                std::push_heap(self->ready->begin(), self->ready->end(),
                               PrioLess{self->prio->data()});
        }
    }
    pk.resize(w);
}

void ingest_capsule_free(PyObject *cap) {
    std::free(PyCapsule_GetPointer(cap, PTCOMM_INGEST_CAPSULE));
}

// ingest_capsule() -> PyCapsule(PtCommIngestVtbl) for Comm.register_pool.
// The capsule borrows `self`: the Python comm lane holds a strong ref to
// the graph for the registration window (ptcomm_iface.h lifetime rules).
PyObject *graph_ingest_capsule(PyObject *obj, PyObject *) {
    PtCommIngestVtbl *v =
        static_cast<PtCommIngestVtbl *>(std::malloc(sizeof(PtCommIngestVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTCOMM_ABI;
    v->obj = obj;
    v->act = graph_ingest_act_c;
    v->rdv_begin = graph_rdv_begin_c;
    v->rdv_land = graph_rdv_land_c;
    PyObject *cap = PyCapsule_New(v, PTCOMM_INGEST_CAPSULE,
                                  ingest_capsule_free);
    if (!cap) std::free(v);
    return cap;
}

// comm_bind(send_capsule, pool_id, my_rank, owners) — enter distributed
// mode: `owners[i]` names the rank executing task i; local release sweeps
// surface non-local successors through the send vtable. Must be called
// before any run() (the seed list is rebuilt rank-local).
PyObject *graph_comm_bind(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *cap, *owners_o;
    unsigned int pool;
    int my_rank;
    if (!PyArg_ParseTuple(args, "OIiO", &cap, &pool, &my_rank, &owners_o))
        return nullptr;
    PtCommSendVtbl *sv = static_cast<PtCommSendVtbl *>(
        PyCapsule_GetPointer(cap, PTCOMM_SEND_CAPSULE));
    if (!sv) return nullptr;
    if (sv->abi != PTCOMM_ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptcomm ABI mismatch");
        return nullptr;
    }
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (self->running > 0 || self->completed > 0) {
            PyErr_SetString(PyExc_RuntimeError,
                            "comm_bind() on a graph already running");
            return nullptr;
        }
        if (self->weighted) {
            PyErr_SetString(PyExc_RuntimeError,
                            "comm_bind() on a region-fused graph (fusion "
                            "is single-rank)");
            return nullptr;
        }
    }
    std::vector<int32_t> owners;
    if (!parse_i32_list(owners_o, owners, "owners: sequence of ints"))
        return nullptr;
    if ((int64_t)owners.size() != self->n) {
        PyErr_SetString(PyExc_ValueError, "owners must have n entries");
        return nullptr;
    }
    *self->owners = std::move(owners);
    self->send = *sv;
    self->pool_id = pool;
    self->my_rank = my_rank;
    self->comm_bound = true;
    if (!self->rdv_pending->size() && self->n_slots)
        self->rdv_pending->assign((size_t)self->n_slots, 0);
    graph_rebuild_seeds(self);
    graph_reset_state(self);
    return Py_BuildValue("L", (long long)self->n_local);
}

// ------------------------------------------------------- device lane bind

// The GIL-free retire entry the ptdev manager thread calls through the
// PtDevRetireVtbl capsule once a dispatched task's completion events
// fired (its outputs already landed in the Python-owned slots): run the
// release walk — successor decrements (more device tasks surface back
// onto the lane; CPU successors enter the ready structure/plane), slot
// retires, completion accounting — exactly the run() sweep, per task.
void graph_dev_retire_c(void *obj, int32_t t) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    if (t < 0 || (int64_t)t >= self->n || !self->dev_bound ||
        !(*self->dev_mask)[(size_t)t]) {
        // ids the lane was never handed are as untrusted as wire ids
        self->dev_bad.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    {
        // duplicate/stale retires (a buggy poll closure, a retire racing
        // a reset) must not double-run the release walk — successor
        // counters would underflow and fire twice or wrap dead
        std::lock_guard<std::mutex> lk(*self->mu);
        if ((*self->dev_ret)[(size_t)t]) {
            self->dev_bad.fetch_add(1, std::memory_order_relaxed);
            return;
        }
        (*self->dev_ret)[(size_t)t] = 1;
    }
    const int32_t *off = self->succ_off->data();
    const int32_t *succ = self->succs->data();
    const bool data_mode = !self->in_off->empty();
    const bool bound = self->comm_bound;
    const int32_t *own = bound ? self->owners->data() : nullptr;
    std::vector<int32_t> fresh, freed;
    for (int32_t k = off[t]; k < off[t + 1]; k++) {
        int32_t s = succ[k];
        if (bound && own[s] != self->my_rank) {
            self->send.send_act(self->send.comm, own[s], self->pool_id, s);
            self->acts_tx.fetch_add(1, std::memory_order_relaxed);
            continue;
        }
        if (self->counts[s].fetch_sub(1, std::memory_order_acq_rel) == 1)
            fresh.push_back(s);
    }
    if (data_mode) {
        const int32_t *ioff = self->in_off->data();
        const int32_t *islot = self->in_slots->data();
        for (int32_t k = ioff[t]; k < ioff[t + 1]; k++) {
            int32_t j = islot[k];
            if (self->slot_cnt[j].fetch_sub(
                    1, std::memory_order_acq_rel) == 1)
                freed.push_back(j);
        }
    }
    pthist::State<N_HISTS> *hs = self->hist.load(std::memory_order_acquire);
    if (hs && hs->enabled.load(std::memory_order_relaxed) &&
        !fresh.empty()) {
        int64_t now = ptrace_ring::now_ns();
        for (int32_t s : fresh)
            if (hist_sampled(s))
                self->ready_stamp[s].store(now, std::memory_order_relaxed);
    }
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        self->completed += self->weighted ? (*self->weight)[(size_t)t] : 1;
        // push_ready_locked routes each successor: device-bodied back to
        // the lane, plane-bound to the plane, the rest to the vector
        for (int32_t s : fresh) push_ready_locked(self, s);
        if (!freed.empty()) {
            self->retired->insert(self->retired->end(), freed.begin(),
                                  freed.end());
            self->nb_slots_retired += (int64_t)freed.size();
        }
    }
    self->dev_done.fetch_add(
        self->weighted ? (*self->weight)[(size_t)t] : 1,
        std::memory_order_relaxed);
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    if (tw.st) {
        // the device task's retire step as a (tiny) EV_TASK interval so
        // merged traces pair every lane task exactly like CPU retires;
        // fused-region nodes additionally mark EV_REGION so the merged
        // timeline separates regions from seams on the retire side too
        if (self->weighted && (*self->weight)[(size_t)t] > 1) {
            tw.rec(EV_REGION, t, ptrace_ring::FLAG_START);
            tw.rec(EV_REGION, t, ptrace_ring::FLAG_END);
        }
        tw.rec(EV_TASK, t, ptrace_ring::FLAG_START);
        tw.rec(EV_TASK, t, ptrace_ring::FLAG_END);
    }
}

void dev_retire_capsule_free(PyObject *cap) {
    std::free(PyCapsule_GetPointer(cap, PTDEV_RETIRE_CAPSULE));
}

// dev_retire_capsule() -> PyCapsule(PtDevRetireVtbl) for Lane.bind_pool.
// The capsule borrows `self`: the device lane holds a strong ref to the
// graph for the bind window (ptdev_iface.h lifetime rules).
PyObject *graph_dev_retire_capsule(PyObject *obj, PyObject *) {
    PtDevRetireVtbl *v =
        static_cast<PtDevRetireVtbl *>(std::malloc(sizeof(PtDevRetireVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTDEV_ABI;
    v->obj = obj;
    v->retire = graph_dev_retire_c;
    PyObject *cap = PyCapsule_New(v, PTDEV_RETIRE_CAPSULE,
                                  dev_retire_capsule_free);
    if (!cap) std::free(v);
    return cap;
}

// dev_bind(submit_capsule, dev_pool, mask) -> n_seeded — enter device
// mode: `mask[i]` flags task i as device-bodied. Ready device tasks
// already seeded into the private structure surface onto the lane NOW
// (the hand-off of dev_sweep_ready_locked); everything after routes at
// the release sites. Bind BEFORE the context enqueues the graph (and
// before any sched_bind) so no device id ever reaches the plane.
PyObject *graph_dev_bind(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *cap, *mask_o;
    unsigned int pool;
    if (!PyArg_ParseTuple(args, "OIO", &cap, &pool, &mask_o))
        return nullptr;
    PtDevSubmitVtbl *sv = static_cast<PtDevSubmitVtbl *>(
        PyCapsule_GetPointer(cap, PTDEV_SUBMIT_CAPSULE));
    if (!sv) return nullptr;
    if (sv->abi != PTDEV_ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptdev ABI mismatch");
        return nullptr;
    }
    std::vector<int32_t> mask32;
    if (!parse_i32_list(mask_o, mask32, "mask: sequence of ints"))
        return nullptr;
    if ((int64_t)mask32.size() != self->n) {
        PyErr_SetString(PyExc_ValueError, "mask must have n entries");
        return nullptr;
    }
    int64_t seeded;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        if (self->dev_bound) {
            PyErr_SetString(PyExc_RuntimeError, "graph already dev-bound");
            return nullptr;
        }
        if (self->running > 0 || self->completed > 0) {
            PyErr_SetString(PyExc_RuntimeError,
                            "dev_bind() on a graph already running");
            return nullptr;
        }
        self->dev_mask->resize((size_t)self->n);
        self->dev_ret->assign((size_t)self->n, 0);
        for (int64_t i = 0; i < self->n; i++)
            (*self->dev_mask)[(size_t)i] = mask32[(size_t)i] ? 1 : 0;
        self->dsend = *sv;
        self->dev_pool = pool;
        self->dev_bound = true;
        seeded = dev_sweep_ready_locked(self);
    }
    return PyLong_FromLongLong(seeded);
}

// Python mirror of the C retire entry (tests + non-native callers)
PyObject *graph_dev_retire(PyObject *obj, PyObject *arg) {
    long tid = PyLong_AsLong(arg);
    if (tid == -1 && PyErr_Occurred()) return nullptr;
    graph_dev_retire_c(obj, (int32_t)tid);
    Py_RETURN_NONE;
}

PyObject *graph_dev_stats(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    int64_t ndev = 0;
    for (size_t i = 0; i < self->dev_mask->size(); i++)
        if ((*self->dev_mask)[i])
            ndev += self->weighted ? (*self->weight)[i] : 1;
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L}",
        "dev_tx", (long long)self->dev_tx.load(std::memory_order_relaxed),
        "dev_done",
        (long long)self->dev_done.load(std::memory_order_relaxed),
        "dev_bad", (long long)self->dev_bad.load(std::memory_order_relaxed),
        "n_dev", (long long)ndev);
}

// ------------------------------------------------------ region fusion bind

// region_bind(weights) — declare fused super-task nodes. The
// compiler's fusion pass already rebuilt the CSR so each fused node
// carries the union of its region's external in/out edges and in-slot
// list; `weights[i]` says how many ORIGINAL tasks node i stands for
// (1 for seams and unfused tasks, the region size for a fused node).
// From here completed/pending/done and run()'s return value are
// original-task denominated, so pool accounting and engagement counters
// never under-report a fused pool. Single-rank only (fusion declines
// distributed pools: a fused region must not hide a cross-rank edge).
PyObject *graph_region_bind(PyObject *obj, PyObject *arg) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::vector<int32_t> w;
    if (!parse_i32_list(arg, w, "weights: sequence of ints"))
        return nullptr;
    if ((int64_t)w.size() != self->n) {
        PyErr_SetString(PyExc_ValueError, "weights must have n entries");
        return nullptr;
    }
    int64_t total = 0;
    for (int32_t v : w) {
        if (v < 1) {
            PyErr_SetString(PyExc_ValueError, "region weight must be >= 1");
            return nullptr;
        }
        total += v;
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->running > 0 || self->completed > 0) {
        PyErr_SetString(PyExc_RuntimeError,
                        "region_bind() on a graph already running");
        return nullptr;
    }
    if (self->comm_bound) {
        PyErr_SetString(PyExc_RuntimeError,
                        "region_bind() on a comm-bound graph (fusion is "
                        "single-rank)");
        return nullptr;
    }
    *self->weight = std::move(w);
    self->w_total = total;
    self->weighted = true;
    return Py_BuildValue("L", (long long)total);
}

PyObject *graph_region_stats(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    int64_t regions = 0, fused = 0;
    for (int32_t v : *self->weight) {
        if (v > 1) {
            regions++;
            fused += v;
        }
    }
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L}",
        "fused_regions", (long long)regions,
        "fused_tasks", (long long)fused,
        "nodes", (long long)self->n,
        "weighted_total", (long long)(self->weighted ? self->w_total
                                                     : self->n_local));
}

// cost_bind(rows) — attach cost-model rows: rows[i] is the
// accumulator row task i reports into (-1 = unattributed). The compiler
// assigns one row per (class, shape bucket, device flavor) and keeps the
// row -> key metadata Python-side; run()'s exec bump then splits its
// batch-amortized per-task cost across the rows at two relaxed atomics
// per task. Bind before enqueue (the lane does) — run() snapshots the
// row pointer once per call.
PyObject *graph_cost_bind(PyObject *obj, PyObject *arg) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::vector<int32_t> rows;
    if (!parse_i32_list(arg, rows, "rows: sequence of ints"))
        return nullptr;
    if ((int64_t)rows.size() != self->n) {
        PyErr_SetString(PyExc_ValueError, "rows must have n entries");
        return nullptr;
    }
    int32_t nrows = 0;
    for (int32_t r : rows) {
        if (r < -1) {
            PyErr_SetString(PyExc_ValueError, "row ids must be >= -1");
            return nullptr;
        }
        if (r >= nrows) nrows = r + 1;
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->running > 0) {
        PyErr_SetString(PyExc_RuntimeError,
                        "cost_bind() on a graph already running");
        return nullptr;
    }
    delete[] self->cost_cnt;
    delete[] self->cost_sum;
    self->cost_cnt = nullptr;
    self->cost_sum = nullptr;
    if (nrows > 0) {
        self->cost_cnt = new (std::nothrow) std::atomic<uint64_t>[nrows];
        self->cost_sum = new (std::nothrow) std::atomic<uint64_t>[nrows];
        if (!self->cost_cnt || !self->cost_sum) {
            delete[] self->cost_cnt;
            delete[] self->cost_sum;
            self->cost_cnt = nullptr;
            self->cost_sum = nullptr;
            PyErr_NoMemory();
            return nullptr;
        }
        for (int32_t r = 0; r < nrows; r++) {
            self->cost_cnt[r].store(0, std::memory_order_relaxed);
            self->cost_sum[r].store(0, std::memory_order_relaxed);
        }
    }
    *self->cost_rows = std::move(rows);
    self->n_cost_rows = nrows;
    return PyLong_FromLong((long)nrows);
}

// cost_snapshot() -> [(count, sum_ns)] per row — drained by the Python
// fold at the histogram registry's detach points. Relaxed reads: a
// concurrent bump may straddle the snapshot, but folds only run once
// the lane's graph is done (or abandoned), so the pairs are settled.
PyObject *graph_cost_snapshot(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *out = PyList_New((Py_ssize_t)self->n_cost_rows);
    if (!out) return nullptr;
    for (int32_t r = 0; r < self->n_cost_rows; r++) {
        PyObject *pair = Py_BuildValue(
            "(KK)",
            (unsigned long long)self->cost_cnt[r].load(
                std::memory_order_relaxed),
            (unsigned long long)self->cost_sum[r].load(
                std::memory_order_relaxed));
        if (!pair) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, (Py_ssize_t)r, pair);
    }
    return out;
}

// trace_mark(key, id, flags) — record one event into this graph's rings
// from Python (GIL held). The region dispatch wrappers bracket each
// fused-region body with EV_REGION START/END so merged Perfetto
// timelines show regions vs seams; a disarmed tracer costs one null
// branch (Writer.open on a null state).
PyObject *graph_trace_mark(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    unsigned int key, flags;
    long long id;
    if (!PyArg_ParseTuple(args, "ILI", &key, &id, &flags))
        return nullptr;
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    if (tw.st) tw.rec(key, (int64_t)id, flags);
    Py_RETURN_NONE;
}

// --------------------------------------------------- scheduler plane bind

// sched_bind(plane_capsule, pool_handle) — move this graph's ready
// structure into the shared scheduler plane: pushes enter the
// plane (per-worker hot queues / per-pool heaps), pops come back through
// run()'s plane path, and the Context arbitrates ACROSS bound graphs by
// DRR weight. Items already ready (seeds, a reset graph) migrate now.
// The graph owns the pool slot: sched_unbind()/dealloc frees it.
PyObject *graph_sched_bind(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *cap;
    int h;
    if (!PyArg_ParseTuple(args, "Oi", &cap, &h))
        return nullptr;
    ptsched::Plane *pl = ptsched::plane_from_capsule(cap);
    if (!pl) return nullptr;
    if (h < 0 || h >= ptsched::MAX_POOLS) {
        PyErr_SetString(PyExc_IndexError, "bad pool handle");
        return nullptr;
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    if (self->splane) {
        PyErr_SetString(PyExc_RuntimeError, "graph already sched-bound");
        return nullptr;
    }
    // binding MID-RUN is legal (lazy arming on the second concurrent
    // pool): the ready vector migrates under mu here; a worker holding a
    // pre-bind snapshot keeps pushing/popping the private vector, whose
    // leftovers plane-era pops drain under the same mu — nothing is lost
    // or duplicated, only the heap ordering mixes transiently
    Py_INCREF(cap);
    self->sched_cap = cap;
    self->splane = pl;
    self->spool = h;
    if (self->use_heap) {
        // a priority graph's plane pool must keep heap order from the
        // first push — per-batch all-zero priorities must not slip into
        // the FIFO-ish hot queues ahead of heaped higher priorities
        std::lock_guard<std::mutex> pm(pl->pools[h].mu);
        pl->pools[h].heap = true;
    }
    if (!self->ready->empty()) {
        std::vector<int32_t> prios;
        pl->push(h, -1, self->ready->data(),
                 gather_prios(self, *self->ready, prios),
                 (int)self->ready->size());
        self->ready->clear();
    }
    Py_RETURN_NONE;
}

// sched_unbind() — leave the plane: straggler items are swept, the pool
// slot freed, the capsule ref dropped. Any already-ready items migrate
// back into the private vector first (an errored/finished graph has
// none that matter; a live rebind path must not lose work).
PyObject *graph_sched_unbind(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (!self->splane) Py_RETURN_NONE;
    if (self->running > 0) {
        // a mid-batch worker's release sweep would push into a freed
        // (possibly reused) pool slot; callers unbind at idle points
        // (finalize, abandon-after-poison)
        PyErr_SetString(PyExc_RuntimeError,
                        "sched_unbind() while workers are running");
        return nullptr;
    }
    ptsched::Plane *pl = self->splane;
    int h = self->spool;
    // migrate EVERY queued item back into the private structure before
    // the slot frees (pool_drain_all takes blocking locks — the regular
    // pop's try_lock steal would skip a contended victim's hot queue and
    // the unregister sweep would then silently drop its items)
    std::vector<int32_t> left;
    pl->pool_drain_all(h, left);
    for (int32_t t : left) {
        self->ready->push_back(t);
        if (self->use_heap)
            std::push_heap(self->ready->begin(), self->ready->end(),
                           PrioLess{self->prio->data()});
    }
    pl->pool_unregister(h);
    self->splane = nullptr;
    self->spool = -1;
    Py_CLEAR(self->sched_cap);
    Py_RETURN_NONE;
}

PyObject *graph_sched_stats(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    if (!self->splane) Py_RETURN_NONE;
    ptsched::Pool &p = self->splane->pools[self->spool];
    return Py_BuildValue(
        "{s:i,s:L,s:L,s:L,s:L}",
        "pool", (int)self->spool,
        "queued", (long long)p.queued.load(std::memory_order_relaxed),
        "served", (long long)p.served.load(std::memory_order_relaxed),
        "spills", (long long)p.spills.load(std::memory_order_relaxed),
        "inflight", (long long)p.inflight.load(std::memory_order_relaxed));
}

// Python-side mirrors of the C ingest entries (tests + non-native callers)
PyObject *graph_ingest(PyObject *obj, PyObject *arg) {
    long tid = PyLong_AsLong(arg);
    if (tid == -1 && PyErr_Occurred()) return nullptr;
    graph_ingest_act_c(obj, (int32_t)tid);
    Py_RETURN_NONE;
}

PyObject *graph_rdv_begin(PyObject *obj, PyObject *arg) {
    long slot = PyLong_AsLong(arg);
    if (slot == -1 && PyErr_Occurred()) return nullptr;
    graph_rdv_begin_c(obj, (int32_t)slot);
    Py_RETURN_NONE;
}

PyObject *graph_rdv_land(PyObject *obj, PyObject *arg) {
    long slot = PyLong_AsLong(arg);
    if (slot == -1 && PyErr_Occurred()) return nullptr;
    graph_rdv_land_c(obj, (int32_t)slot);
    Py_RETURN_NONE;
}

PyObject *graph_comm_stats(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    int64_t parked;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        parked = (int64_t)self->parked->size();
    }
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:L}",
        "acts_tx", (long long)self->acts_tx.load(std::memory_order_relaxed),
        "acts_rx", (long long)self->acts_rx.load(std::memory_order_relaxed),
        "ingest_bad",
        (long long)self->ingest_bad.load(std::memory_order_relaxed),
        "n_local", (long long)self->n_local, "parked", (long long)parked);
}

PyObject *graph_size(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    return Py_BuildValue("(Ln)", (long long)self->n,
                         (Py_ssize_t)self->succs->size());
}

PyObject *graph_slot_stats(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return Py_BuildValue("(LL)", (long long)self->n_slots,
                         (long long)self->nb_slots_retired);
}

// take_retired() -> the slot ids fully consumed since the last hand-over
// (the list a data-mode dispatch callback receives). The device lane's
// dispatch takes them here: a pool whose tasks all ride the device lane
// runs no CPU dispatch, and would otherwise hold every slot's payload
// until the pool ends
PyObject *graph_take_retired(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    std::vector<int32_t> ret;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        ret.swap(*self->retired);
    }
    PyObject *rl = PyList_New((Py_ssize_t)ret.size());
    if (!rl)
        return nullptr;
    for (size_t i = 0; i < ret.size(); i++)
        PyList_SET_ITEM(rl, (Py_ssize_t)i, PyLong_FromLong(ret[i]));
    return rl;
}

// ------------------------------------------------------- in-lane tracing

PyObject *graph_trace_enable(PyObject *obj, PyObject *args) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    return ptrace_ring::py_trace_enable(self->trace, args);
}

PyObject *graph_trace_drain(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_drain(reinterpret_cast<Graph *>(obj)->trace.load(
            std::memory_order_acquire));
}

PyObject *graph_trace_dropped(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_dropped(
        reinterpret_cast<Graph *>(obj)->trace.load(
            std::memory_order_acquire));
}

PyObject *graph_monotonic_ns(PyObject *, PyObject *) {
    return PyLong_FromLongLong(ptrace_ring::now_ns());
}

// --------------------------------------------------- latency histograms

PyObject *graph_hist_enable(PyObject *obj, PyObject *) {
    Graph *self = reinterpret_cast<Graph *>(obj);
    PyObject *r = pthist::py_hist_enable<N_HISTS>(self->hist);
    if (!r) return nullptr;
    // stamp sampled tasks ALREADY awaiting pop (seeds, mid-run arming)
    // so their eventual pop reads a real push time, not zero
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        int64_t now = ptrace_ring::now_ns();
        for (int32_t t : *self->ready)
            if (hist_sampled(t))
                self->ready_stamp[t].store(now, std::memory_order_relaxed);
        for (int32_t t : *self->parked)
            if (hist_sampled(t))
                self->ready_stamp[t].store(now, std::memory_order_relaxed);
    }
    return r;
}

PyObject *graph_hist_snapshot(PyObject *obj, PyObject *) {
    return pthist::py_hist_snapshot<N_HISTS>(
        reinterpret_cast<Graph *>(obj)->hist.load(
            std::memory_order_acquire),
        HIST_NAMES);
}

PyMethodDef graph_methods[] = {
    {"run", graph_run, METH_VARARGS,
     "run(callback=None, batch=256, budget=0, wid=0) -> tasks executed by "
     "this call (wid = scheduler-plane hot-queue affinity when bound)"},
    {"sched_bind", graph_sched_bind, METH_VARARGS,
     "sched_bind(plane_capsule, pool_handle): move the ready structure "
     "into the shared scheduler plane (see csrc/ptsched.h)"},
    {"sched_unbind", graph_sched_unbind, METH_NOARGS,
     "leave the scheduler plane (frees the pool slot; queued items "
     "migrate back to the private ready structure)"},
    {"sched_stats", graph_sched_stats, METH_NOARGS,
     "{pool, queued, served, spills, inflight} of the bound plane pool, "
     "or None when unbound"},
    {"reset", graph_reset, METH_NOARGS,
     "rewind dependency counters, slots, and the ready structure for replay"},
    {"done", graph_done, METH_NOARGS,
     "True when every task executed (and no error poisoned the run)"},
    {"failed", graph_failed, METH_NOARGS,
     "True when a body callback raised and poisoned the run"},
    {"idle", graph_idle, METH_NOARGS,
     "True when no worker holds a claimed batch (stable once poisoned)"},
    {"pending", graph_pending, METH_NOARGS,
     "tasks not yet executed"},
    {"size", graph_size, METH_NOARGS,
     "(n_tasks, n_edges)"},
    {"slot_stats", graph_slot_stats, METH_NOARGS,
     "(n_slots, n_slots_retired) — the lane-side datarepo retire counters"},
    {"take_retired", graph_take_retired, METH_NOARGS,
     "take_retired() -> slot ids fully consumed since the last hand-over"},
    {"comm_bind", graph_comm_bind, METH_VARARGS,
     "comm_bind(send_capsule, pool_id, my_rank, owners) -> n_local: enter "
     "distributed mode (remote successors surface on the comm lane)"},
    {"ingest_capsule", graph_ingest_capsule, METH_NOARGS,
     "PyCapsule(PtCommIngestVtbl) for Comm.register_pool (GIL-free ingest)"},
    {"ingest", graph_ingest, METH_O,
     "ingest(tid): one remote dep-release arrived for task tid"},
    {"rdv_begin", graph_rdv_begin, METH_O,
     "rdv_begin(slot): gate consumers of slot until its pull lands"},
    {"rdv_land", graph_rdv_land, METH_O,
     "rdv_land(slot): pull landed; release parked consumers"},
    {"comm_stats", graph_comm_stats, METH_NOARGS,
     "{acts_tx, acts_rx, ingest_bad, n_local, parked}"},
    {"dev_bind", graph_dev_bind, METH_VARARGS,
     "dev_bind(submit_capsule, dev_pool, mask) -> n_seeded: enter device "
     "mode (masked tasks surface onto the ptdev lane when ready)"},
    {"dev_retire_capsule", graph_dev_retire_capsule, METH_NOARGS,
     "PyCapsule(PtDevRetireVtbl) for Lane.bind_pool (GIL-free retirement)"},
    {"dev_retire", graph_dev_retire, METH_O,
     "dev_retire(tid): one device task completed; run its release walk"},
    {"dev_stats", graph_dev_stats, METH_NOARGS,
     "{dev_tx, dev_done, dev_bad, n_dev}"},
    {"region_bind", graph_region_bind, METH_O,
     "region_bind(weights) -> weighted total: declare fused super-task "
     "nodes (weight = original tasks per node); completed/pending/done "
     "and run() become original-task denominated"},
    {"region_stats", graph_region_stats, METH_NOARGS,
     "{fused_regions, fused_tasks, nodes, weighted_total}"},
    {"cost_bind", graph_cost_bind, METH_O,
     "cost_bind(rows) -> n_rows: attach per-(class, bucket, device) "
     "cost-model rows (-1 = unattributed); run()'s batch-amortized exec "
     "bump splits its cost across the rows"},
    {"cost_snapshot", graph_cost_snapshot, METH_NOARGS,
     "cost_snapshot() -> [(count, sum_ns)] per row — folded into the "
     "online cost model at lane detach"},
    {"trace_mark", graph_trace_mark, METH_VARARGS,
     "trace_mark(key, id, flags): record one ring event from Python "
     "(EV_REGION dispatch intervals of the fused-region wrappers)"},
    {"trace_enable", graph_trace_enable, METH_VARARGS,
     "trace_enable(nrings=16, capacity=65536) -> (nrings, cap): arm the "
     "in-lane event rings (idempotent; see ptrace_ring.h)"},
    {"trace_drain", graph_trace_drain, METH_NOARGS,
     "trace_drain() -> [(ring_id, packed_events_bytes)]; event layout "
     "'<qqII' = (t_ns, id, key, flags)"},
    {"trace_dropped", graph_trace_dropped, METH_NOARGS,
     "cumulative events lost to ring overflow (never reset)"},
    {"monotonic_ns", graph_monotonic_ns, METH_NOARGS,
     "the trace clock (steady_clock ns) — for epoch calibration"},
    {"hist_enable", graph_hist_enable, METH_NOARGS,
     "arm the in-lane latency histograms (exec_ns batch-amortized, "
     "ready_wait_ns sampled 1-in-8 by task id; see pthist.h)"},
    {"hist_snapshot", graph_hist_snapshot, METH_NOARGS,
     "{name: (count, sum_ns, buckets_bytes)} — buckets pack '<496Q'"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject GraphType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptexec.Graph";
    t.tp_basicsize = sizeof(Graph);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "flattened task graph executed by the native FSM lane";
    t.tp_new = graph_new;
    t.tp_dealloc = graph_dealloc;
    t.tp_methods = graph_methods;
    return t;
}();

PyModuleDef ptexec_module = {
    PyModuleDef_HEAD_INIT, "_ptexec",
    "native PTG execution lane (see csrc/ptexec.cpp)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__ptexec(void) {
    if (PyType_Ready(&GraphType) < 0) return nullptr;
    PyObject *m = PyModule_Create(&ptexec_module);
    if (!m) return nullptr;
    Py_INCREF(&GraphType);
    if (PyModule_AddObject(m, "Graph",
                           reinterpret_cast<PyObject *>(&GraphType)) < 0) {
        Py_DECREF(&GraphType);
        Py_DECREF(m);
        return nullptr;
    }
    if (PyModule_AddIntConstant(m, "EV_TASK", EV_TASK) < 0 ||
        PyModule_AddIntConstant(m, "EV_DISPATCH", EV_DISPATCH) < 0 ||
        PyModule_AddIntConstant(m, "EV_REGION", EV_REGION) < 0 ||
        PyModule_AddIntConstant(m, "FLAG_START",
                                ptrace_ring::FLAG_START) < 0 ||
        PyModule_AddIntConstant(m, "FLAG_END", ptrace_ring::FLAG_END) < 0 ||
        PyModule_AddIntConstant(m, "HIST_BUCKETS", pthist::NBUCKETS) < 0 ||
        PyModule_AddIntConstant(m, "HIST_SUB_BITS", pthist::SUB_BITS) < 0 ||
        PyModule_AddIntConstant(m, "HIST_READY_SAMPLE", 8) < 0) {
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
