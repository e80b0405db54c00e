// parsec_tpu_torch._ptdev — the native device lane (the fourth extension).
//
// Stands where the reference's GPU device plane stands
// (parsec/mca/device/device_gpu.c: parsec_device_kernel_scheduler:3376,
// the push/exec/pop stream pipeline :3438-3515 and the event-driven
// completion polls :2593), treating the device plane as its OWN
// subsystem rather than a hook inside the CPU scheduler:
//
//  * a per-device LANE owns a lock-free MPSC pending queue fed STRAIGHT
//    from the GIL-free release sweeps of the execution engines
//    (ptdev_iface.h PtDevSubmitVtbl — a ready device-bodied task never
//    enters the engine's ready vector, it surfaces here; the ptcomm
//    remote-successor surfacing pattern applied to the device plane);
//  * ONE manager thread per lane (the CAS owner/manager model of
//    device_gpu.c:3398-3424, made a real thread) drains the queue, takes
//    the GIL only to issue the CUDA launches and host-to-device copies
//    through a Python callback (launches are asynchronous — issuing IS
//    the push+exec phase), then polls completion through a poll callback
//    (a CUDA event's query() is the cudaEventQuery) and lands each finished
//    task back into its engine through the GIL-FREE retire entry
//    (PtDevRetireVtbl — the ingest_act shape of the comm lane);
//  * the COHERENCY TABLE (CohTable) moves the L1 substrate native: a
//    C-side owner/shared/invalid copy table (the MOESI tracking of
//    the Data.transfer_ownership of the Python side) consulted at stage-in so
//    version-checked transfers are only issued when the device copy is
//    stale, plus zone-heap byte accounting and LRU eviction DECISIONS
//    (parsec_device_data_reserve_space, device_gpu.c:1210). Python owns
//    the payloads and performs the write-backs; C owns residency and
//    eviction policy — the ptexec slot-ownership split.
//
// Concurrency contract: submit() is wait-free from any thread (Treiber
// push + counter); the manager thread is the only consumer. The pool
// table and lifecycle are guarded by `mu`; the manager NEVER holds `mu`
// while acquiring the GIL (bind/unbind take the GIL first, then mu — one
// global order, no inversion). stop() releases the GIL around the join
// so a manager blocked in PyGILState_Ensure can finish its iteration.
//
// Overlap accounting: a dispatch issued while earlier work is still in
// flight means the new batch's H2D transfers overlap the in-flight
// compute — counted per batch (overlap_hits / dispatch_batches is the
// bench's device_overlap_pct_native).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <mutex>
#include <new>
#include <thread>
#include <unordered_map>
#include <vector>

#include "ptdev_iface.h"
#include "pthist.h"
#include "ptrace_ring.h"

namespace {

// in-lane trace event keys (for the native trace bridge, under "ptdev")
constexpr uint32_t EV_DEV_DISPATCH = 1;  // interval per dispatch batch
constexpr uint32_t EV_DEV_RETIRE = 2;    // point per retired task

// latency histogram (pthist.h; name mirrored by the histogram reader):
// per task, its dispatch call -> its retire into the engine — the stay on
// the card's stream plus the poll that saw its batch's event complete
const char *const HIST_NAMES[1] = {"retire_ns"};

// ---------------------------------------------------------------------------
// CohTable — C-side coherency + residency table (one per device)
// ---------------------------------------------------------------------------

// coherency states mirror the package's data/data.py (ref: parsec/data.h:28)
constexpr uint8_t COH_INVALID = 0;
constexpr uint8_t COH_OWNED = 1;
constexpr uint8_t COH_SHARED = 3;

struct CohEntry {
    uint32_t version = 0;
    uint8_t state = COH_INVALID;
    int32_t pins = 0;               // readers guard (device_gpu.c:1210)
    int64_t nbytes = 0;
    std::list<uint64_t>::iterator lru_it;
};

struct CohTable {
    PyObject_HEAD
    std::mutex *mu;
    std::unordered_map<uint64_t, CohEntry> *map;
    std::list<uint64_t> *lru;       // front = LRU victim, back = MRU
    int64_t budget;
    int64_t resident;
    int64_t hwm;
    int64_t evictions;
    int64_t pinned_skips;
    int64_t hits;                   // stage-in version checks that matched
    int64_t misses;                 // stage-ins that needed a transfer
    int64_t stage_in_bytes;
    int64_t stage_out_bytes;        // write-backs Python reported
};

// mu held. Evict LRU unpinned entries until `need` bytes fit (or only
// pinned entries remain — then stop, the caching allocator is the backstop,
// exactly the Python _reserve discipline). Victims append (key, owned).
// `exclude` (with has_exclude) protects the key currently being
// re-staged: evicting it would both under-account the reserve (its old
// bytes were already subtracted from `need`) and hand Python a spurious
// victim for the very copy it is refreshing.
void coh_make_room_locked(CohTable *self, int64_t need,
                          std::vector<std::pair<uint64_t, int>> &victims,
                          bool has_exclude = false, uint64_t exclude = 0) {
    auto it = self->lru->begin();
    while (self->resident + need > self->budget && it != self->lru->end()) {
        uint64_t key = *it;
        if (has_exclude && key == exclude) {
            ++it;
            continue;
        }
        CohEntry &e = (*self->map)[key];
        if (e.pins > 0) {
            self->pinned_skips++;
            ++it;
            continue;
        }
        victims.emplace_back(key, e.state == COH_OWNED ? 1 : 0);
        self->resident -= e.nbytes;
        self->evictions++;
        it = self->lru->erase(it);
        self->map->erase(key);
    }
}

PyObject *coh_victims_py(const std::vector<std::pair<uint64_t, int>> &v) {
    PyObject *out = PyList_New((Py_ssize_t)v.size());
    if (!out) return nullptr;
    for (size_t i = 0; i < v.size(); i++) {
        PyObject *pair = Py_BuildValue("(Ki)", (unsigned long long)v[i].first,
                                       v[i].second);
        if (!pair) { Py_DECREF(out); return nullptr; }
        PyList_SET_ITEM(out, (Py_ssize_t)i, pair);
    }
    return out;
}

PyObject *coh_new(PyTypeObject *type, PyObject *args, PyObject *) {
    long long budget = 0;
    if (!PyArg_ParseTuple(args, "L", &budget)) return nullptr;
    if (budget <= 0) {
        PyErr_SetString(PyExc_ValueError, "budget must be positive");
        return nullptr;
    }
    CohTable *self = reinterpret_cast<CohTable *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    self->mu = new (std::nothrow) std::mutex();
    self->map = new (std::nothrow) std::unordered_map<uint64_t, CohEntry>();
    self->lru = new (std::nothrow) std::list<uint64_t>();
    self->budget = budget;
    self->resident = self->hwm = 0;
    self->evictions = self->pinned_skips = 0;
    self->hits = self->misses = 0;
    self->stage_in_bytes = self->stage_out_bytes = 0;
    if (!self->mu || !self->map || !self->lru) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    return reinterpret_cast<PyObject *>(self);
}

void coh_dealloc(PyObject *obj) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    delete self->mu;
    delete self->map;
    delete self->lru;
    Py_TYPE(obj)->tp_free(obj);
}

// stage_in(key, nbytes, version, write=0, pin=0) -> (need_transfer, victims)
//
// The parsec_device_data_stage_in version check (device_gpu.c:1800) as a
// table decision: need_transfer==0 means a valid copy of exactly this
// version is resident (LRU touched); ==1 means the caller must issue the
// transfer — room was reserved first (the push-phase early reserve), and
// `victims` lists the (key, was_owned) entries the LRU policy evicted to
// make it fit. Python writes OWNED victims back before dropping payloads.
// `pin=1` takes the eviction pin INSIDE the same critical section as the
// reserve — without it, a concurrent stage-in on another thread could
// evict this entry between the reserve and the caller's pin.
PyObject *coh_stage_in(PyObject *obj, PyObject *args) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key;
    long long nbytes;
    unsigned int version;
    int write = 0, pin = 0;
    if (!PyArg_ParseTuple(args, "KLI|ii", &key, &nbytes, &version, &write,
                          &pin))
        return nullptr;
    int need = 0;
    std::vector<std::pair<uint64_t, int>> victims;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        auto it = self->map->find(key);
        if (it != self->map->end() && it->second.state != COH_INVALID &&
            it->second.version == version) {
            self->hits++;
            // MRU touch
            self->lru->erase(it->second.lru_it);
            self->lru->push_back(key);
            it->second.lru_it = std::prev(self->lru->end());
            if (write) it->second.state = COH_OWNED;
        } else {
            need = 1;
            self->misses++;
            self->stage_in_bytes += nbytes;
            int64_t old = it != self->map->end() ? it->second.nbytes : 0;
            coh_make_room_locked(self, nbytes - old, victims,
                                 it != self->map->end(), key);
            it = self->map->find(key);
            if (it != self->map->end()) {
                self->resident += nbytes - it->second.nbytes;
                it->second.nbytes = nbytes;
                self->lru->erase(it->second.lru_it);
            } else {
                CohEntry e;
                e.nbytes = nbytes;
                it = self->map->emplace(key, e).first;
                self->resident += nbytes;
            }
            self->lru->push_back(key);
            it->second.lru_it = std::prev(self->lru->end());
            it->second.version = version;
            it->second.state = write ? COH_OWNED : COH_SHARED;
            if (self->resident > self->hwm) self->hwm = self->resident;
        }
        if (pin) it->second.pins++;
    }
    PyObject *vl = coh_victims_py(victims);
    if (!vl) return nullptr;
    return Py_BuildValue("(iN)", need, vl);
}

// mark_owned(key, version, nbytes) -> victims — a writer completed on the
// device: the copy becomes the OWNER at `version` (the epilog version
// bump, device_gpu.c:3180). The size may change (a body may rebind the
// payload); growth past the budget evicts like stage_in.
PyObject *coh_mark_owned(PyObject *obj, PyObject *args) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key;
    unsigned int version;
    long long nbytes;
    if (!PyArg_ParseTuple(args, "KIL", &key, &version, &nbytes))
        return nullptr;
    std::vector<std::pair<uint64_t, int>> victims;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        auto it = self->map->find(key);
        if (it == self->map->end()) {
            coh_make_room_locked(self, nbytes, victims);
            CohEntry e;
            e.nbytes = nbytes;
            it = self->map->emplace(key, e).first;
            self->resident += nbytes;
            self->lru->push_back(key);
            it->second.lru_it = std::prev(self->lru->end());
        } else {
            int64_t delta = nbytes - it->second.nbytes;
            // exclude the key being marked: evicting it here would hand
            // Python a victim for the copy it is CURRENTLY producing
            // while re-creating the entry resident — table/mirror desync
            if (delta > 0)
                coh_make_room_locked(self, delta, victims, true, key);
            self->resident += nbytes - it->second.nbytes;
            it->second.nbytes = nbytes;
            self->lru->erase(it->second.lru_it);
            self->lru->push_back(key);
            it->second.lru_it = std::prev(self->lru->end());
        }
        it->second.version = version;
        it->second.state = COH_OWNED;
        if (self->resident > self->hwm) self->hwm = self->resident;
    }
    PyObject *vl = coh_victims_py(victims);
    if (!vl) return nullptr;
    return vl;
}

PyObject *coh_pin(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key = PyLong_AsUnsignedLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    auto it = self->map->find(key);
    if (it != self->map->end()) it->second.pins++;
    Py_RETURN_NONE;
}

PyObject *coh_unpin(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key = PyLong_AsUnsignedLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    auto it = self->map->find(key);
    if (it != self->map->end() && it->second.pins > 0) it->second.pins--;
    Py_RETURN_NONE;
}

// drop(key) -> bool — the payload left the device (Python evicted or the
// data died); the entry leaves residency accounting.
PyObject *coh_drop(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key = PyLong_AsUnsignedLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    auto it = self->map->find(key);
    if (it == self->map->end()) Py_RETURN_FALSE;
    self->resident -= it->second.nbytes;
    self->lru->erase(it->second.lru_it);
    self->map->erase(it);
    Py_RETURN_TRUE;
}

// evict(nbytes) -> (victims, pinned_skips) — force ~nbytes of unpinned
// residency out (the explicit half of the OOM retry path, evict_bytes in
// device/cuda.py). The skip count is measured INSIDE the critical section
// so a concurrent stage-in's skips are never attributed to this call.
PyObject *coh_evict(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    long long nbytes = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::vector<std::pair<uint64_t, int>> victims;
    int64_t skips;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        int64_t target = self->resident - nbytes;
        if (target < 0) target = 0;
        // make_room against a virtual budget of `target`
        int64_t save = self->budget;
        int64_t skips0 = self->pinned_skips;
        self->budget = target;
        coh_make_room_locked(self, 0, victims);
        self->budget = save;
        skips = self->pinned_skips - skips0;
    }
    PyObject *vl = coh_victims_py(victims);
    if (!vl) return nullptr;
    return Py_BuildValue("(NL)", vl, (long long)skips);
}

PyObject *coh_set_budget(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    long long budget = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::vector<std::pair<uint64_t, int>> victims;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        self->budget = budget;
        coh_make_room_locked(self, 0, victims);
    }
    PyObject *vl = coh_victims_py(victims);
    if (!vl) return nullptr;
    return vl;
}

// state(key) -> (state, version, nbytes, pins) | None
PyObject *coh_state(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    unsigned long long key = PyLong_AsUnsignedLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    auto it = self->map->find(key);
    if (it == self->map->end()) Py_RETURN_NONE;
    return Py_BuildValue("(iILi)", (int)it->second.state,
                         (unsigned int)it->second.version,
                         (long long)it->second.nbytes,
                         (int)it->second.pins);
}

PyObject *coh_count_writeback(PyObject *obj, PyObject *arg) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    long long nbytes = PyLong_AsLongLong(arg);
    if (PyErr_Occurred()) return nullptr;
    std::lock_guard<std::mutex> lk(*self->mu);
    self->stage_out_bytes += nbytes;
    Py_RETURN_NONE;
}

PyObject *coh_stats(PyObject *obj, PyObject *) {
    CohTable *self = reinterpret_cast<CohTable *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:n,s:L,s:L,s:L,s:L,s:L,s:L}",
        "budget", (long long)self->budget,
        "resident_bytes", (long long)self->resident,
        "hwm_bytes", (long long)self->hwm,
        "entries", (Py_ssize_t)self->map->size(),
        "evictions", (long long)self->evictions,
        "pinned_skips", (long long)self->pinned_skips,
        "coh_hits", (long long)self->hits,
        "coh_misses", (long long)self->misses,
        "stage_in_bytes", (long long)self->stage_in_bytes,
        "stage_out_bytes", (long long)self->stage_out_bytes);
}

PyMethodDef coh_methods[] = {
    {"stage_in", coh_stage_in, METH_VARARGS,
     "stage_in(key, nbytes, version, write=0) -> (need_transfer, "
     "[(victim_key, was_owned)]) — the version-checked residency decision"},
    {"mark_owned", coh_mark_owned, METH_VARARGS,
     "mark_owned(key, version, nbytes) -> victims: writer completed, the "
     "device copy owns `version` now"},
    {"pin", coh_pin, METH_O, "pin(key): protect from eviction walks"},
    {"unpin", coh_unpin, METH_O, "unpin(key)"},
    {"drop", coh_drop, METH_O,
     "drop(key) -> bool: remove from residency accounting"},
    {"evict", coh_evict, METH_O,
     "evict(nbytes) -> (victims, pinned_skips): force ~nbytes of "
     "unpinned residency out"},
    {"set_budget", coh_set_budget, METH_O,
     "set_budget(nbytes) -> victims evicted to fit the new budget"},
    {"state", coh_state, METH_O,
     "state(key) -> (state, version, nbytes, pins) | None"},
    {"count_writeback", coh_count_writeback, METH_O,
     "count_writeback(nbytes): Python performed a D2H write-back"},
    {"stats", coh_stats, METH_NOARGS, "residency/coherency counters"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject CohTableType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptdev.CohTable";
    t.tp_basicsize = sizeof(CohTable);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "C-side device coherency + LRU residency table (one per "
               "device); Python owns payloads, this owns policy";
    t.tp_new = coh_new;
    t.tp_dealloc = coh_dealloc;
    t.tp_methods = coh_methods;
    return t;
}();

// ---------------------------------------------------------------------------
// Lane — the per-device dispatch/retire plane
// ---------------------------------------------------------------------------

struct PendNode {
    PendNode *next;
    uint32_t pool;
    int32_t tid;
};

constexpr int DEV_MAX_POOLS = 64;

struct PoolEnt {
    bool used = false;
    uint32_t pool_id = 0;
    PtDevRetireVtbl ret{};
    PyObject *engine = nullptr;     // strong ref: pins the retire target
};

struct Lane {
    PyObject_HEAD
    std::atomic<PendNode *> head;   // Treiber MPSC (engines push GIL-free)
    std::mutex *mu;                 // pools + lifecycle + cv
    std::condition_variable *cv;
    std::thread *mgr;
    std::atomic<bool> running;
    PoolEnt *pools;
    PyObject *dispatch_cb;          // dispatch_cb(pool, [tids]) -> issued
    PyObject *poll_cb;              // poll_cb() -> [(pool, tid), ...]
    int poll_us;
    std::atomic<int64_t> inflight;  // dispatched - retired
    // counters
    std::atomic<int64_t> submitted, dispatched, retired, dispatch_batches,
        overlap_hits, late_submits, late_retires, cb_errors;
    bool failed;                    // a callback raised (mu)
    char errmsg[512];               // formatted exception text (mu)
    std::atomic<ptrace_ring::State *> trace;
    std::atomic<pthist::State<1> *> hist;   // "retire_ns" (null: off)
};

// The GIL-free engine entry (PtDevSubmitVtbl). Wait-free push; the
// condvar notify is lock-free (a sleeping manager's wait_for timeout
// bounds the rare missed-notify window).
void lane_submit_c(void *dev, uint32_t pool, int32_t tid) {
    Lane *self = reinterpret_cast<Lane *>(dev);
    if (!self->running.load(std::memory_order_acquire)) {
        self->late_submits.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    PendNode *n = static_cast<PendNode *>(std::malloc(sizeof(PendNode)));
    if (!n) {       // allocation failure on a GIL-free path: count, drop
        self->late_submits.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    n->pool = pool;
    n->tid = tid;
    n->next = self->head.load(std::memory_order_relaxed);
    while (!self->head.compare_exchange_weak(n->next, n,
                                             std::memory_order_release,
                                             std::memory_order_relaxed)) {
    }
    self->submitted.fetch_add(1, std::memory_order_relaxed);
    self->cv->notify_one();
}

// mu held (or single-threaded init). -1 when not found.
int lane_pool_slot_locked(Lane *self, uint32_t pool) {
    for (int i = 0; i < DEV_MAX_POOLS; i++)
        if (self->pools[i].used && self->pools[i].pool_id == pool) return i;
    return -1;
}

// GIL held. Record a raised Python exception as the lane failure and
// clear it (the manager thread has no caller to propagate to; the
// runtime's drain loops read failed() and surface it).
void lane_record_error(Lane *self) {
    PyObject *type = nullptr, *val = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &val, &tb);
    PyErr_NormalizeException(&type, &val, &tb);
    char buf[512] = "device lane callback failed";
    if (val) {
        PyObject *s = PyObject_Str(val);
        if (s) {
            const char *c = PyUnicode_AsUTF8(s);
            if (c) std::snprintf(buf, sizeof(buf), "%s", c);
            Py_DECREF(s);
        }
    }
    PyErr_Clear();
    Py_XDECREF(type);
    Py_XDECREF(val);
    Py_XDECREF(tb);
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        self->failed = true;
        std::snprintf(self->errmsg, sizeof(self->errmsg), "%s", buf);
    }
    self->cb_errors.fetch_add(1, std::memory_order_relaxed);
}

// The manager thread (one per lane — the funneled device driver).
void lane_mgr_main(Lane *self) {
    std::vector<std::pair<uint32_t, int32_t>> batch, done;
    std::vector<PtDevRetireVtbl> rets;
    // dispatch stamps of the tasks in flight, (pool << 32 | tid) -> ns,
    // kept while the histogram is armed (this thread alone touches it)
    std::unordered_map<uint64_t, int64_t> stamps;
    auto skey = [](uint32_t pool, int32_t tid) {
        return ((uint64_t)pool << 32) | (uint32_t)tid;
    };
    while (self->running.load(std::memory_order_acquire)) {
        // ---- drain the pending MPSC (Treiber pop-all, reverse for FIFO)
        batch.clear();
        PendNode *n = self->head.exchange(nullptr, std::memory_order_acq_rel);
        while (n) {
            batch.emplace_back(n->pool, n->tid);
            PendNode *next = n->next;
            std::free(n);
            n = next;
        }
        std::reverse(batch.begin(), batch.end());
        bool did = false;

        // ---- dispatch phase: GIL taken only to issue the async work
        if (!batch.empty()) {
            ptrace_ring::Writer tw;
            tw.open(self->trace.load(std::memory_order_acquire));
            PyGILState_STATE g = PyGILState_Ensure();
            // every id of this batch ends up either DISPATCHED or counted
            // into late_submits (dropped: stop race, unbound pool, a
            // raising callback) — the fini drain invariant
            // submitted == dispatched + late_submits stays satisfiable
            size_t handled = 0;
            if (self->running.load(std::memory_order_acquire) &&
                self->dispatch_cb) {
                // group contiguous same-pool runs into one callback each
                size_t i = 0;
                while (i < batch.size()) {
                    size_t j = i;
                    uint32_t pool = batch[i].first;
                    while (j < batch.size() && batch[j].first == pool) j++;
                    PyObject *ids = PyList_New((Py_ssize_t)(j - i));
                    if (!ids) { lane_record_error(self); break; }
                    for (size_t k = i; k < j; k++)
                        PyList_SET_ITEM(ids, (Py_ssize_t)(k - i),
                                        PyLong_FromLong(batch[k].second));
                    if (tw.st)
                        tw.rec(EV_DEV_DISPATCH, (int64_t)(j - i),
                               ptrace_ring::FLAG_START);
                    if (self->inflight.load(std::memory_order_relaxed) > 0)
                        self->overlap_hits.fetch_add(
                            1, std::memory_order_relaxed);
                    if (self->hist.load(std::memory_order_acquire)) {
                        const int64_t now = ptrace_ring::now_ns();
                        for (size_t k = i; k < j; k++)
                            stamps[skey(pool, batch[k].second)] = now;
                    }
                    PyObject *r = PyObject_CallFunction(
                        self->dispatch_cb, "IO", (unsigned int)pool, ids);
                    Py_DECREF(ids);
                    long issued = 0;
                    if (!r) {
                        lane_record_error(self);
                    } else {
                        issued = PyLong_Check(r) ? PyLong_AsLong(r)
                                                 : (long)(j - i);
                        Py_DECREF(r);
                        if (issued < 0) issued = 0;
                        if (issued > (long)(j - i)) issued = (long)(j - i);
                        self->dispatched.fetch_add(
                            issued, std::memory_order_relaxed);
                        self->inflight.fetch_add(issued,
                                                 std::memory_order_relaxed);
                        self->dispatch_batches.fetch_add(
                            1, std::memory_order_relaxed);
                    }
                    if (issued < (long)(j - i))
                        self->late_submits.fetch_add(
                            (long)(j - i) - issued,
                            std::memory_order_relaxed);
                    if (tw.st)
                        tw.rec(EV_DEV_DISPATCH, (int64_t)(j - i),
                               ptrace_ring::FLAG_END);
                    handled = i = j;
                }
            }
            if (handled < batch.size())
                self->late_submits.fetch_add(
                    (int64_t)(batch.size() - handled),
                    std::memory_order_relaxed);
            PyGILState_Release(g);
            did = true;
        }

        // ---- poll phase: ask Python which events completed, then RETIRE
        // them GIL-free into the engines
        if (self->inflight.load(std::memory_order_relaxed) > 0) {
            done.clear();
            rets.clear();
            PyGILState_STATE g = PyGILState_Ensure();
            if (self->running.load(std::memory_order_acquire) &&
                self->poll_cb) {
                PyObject *r = PyObject_CallNoArgs(self->poll_cb);
                if (!r) {
                    lane_record_error(self);
                } else {
                    if (r != Py_None) {
                        PyObject *fast = PySequence_Fast(
                            r, "poll_cb must return a sequence");
                        if (!fast) {
                            lane_record_error(self);
                        } else {
                            Py_ssize_t nd = PySequence_Fast_GET_SIZE(fast);
                            for (Py_ssize_t k = 0; k < nd; k++) {
                                PyObject *it =
                                    PySequence_Fast_GET_ITEM(fast, k);
                                if (!PyTuple_Check(it) ||
                                    PyTuple_GET_SIZE(it) != 2)
                                    continue;
                                long p = PyLong_AsLong(
                                    PyTuple_GET_ITEM(it, 0));
                                long t = PyLong_AsLong(
                                    PyTuple_GET_ITEM(it, 1));
                                if (PyErr_Occurred()) {
                                    PyErr_Clear();
                                    continue;
                                }
                                done.emplace_back((uint32_t)p, (int32_t)t);
                            }
                            Py_DECREF(fast);
                        }
                    }
                    Py_DECREF(r);
                }
            }
            // snapshot the retire vtbls under mu while the GIL pins the
            // pool table against unbinds (bind/unbind hold the GIL)
            {
                std::lock_guard<std::mutex> lk(*self->mu);
                for (auto &pt : done) {
                    int s = lane_pool_slot_locked(self, pt.first);
                    rets.push_back(s >= 0 ? self->pools[s].ret
                                          : PtDevRetireVtbl{0, nullptr,
                                                            nullptr});
                }
            }
            PyGILState_Release(g);
            if (!done.empty()) {
                ptrace_ring::Writer tw;
                tw.open(self->trace.load(std::memory_order_acquire));
                pthist::State<1> *hs =
                    self->hist.load(std::memory_order_acquire);
                const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
                for (size_t k = 0; k < done.size(); k++) {
                    if (hs) {
                        auto it = stamps.find(skey(done[k].first,
                                                   done[k].second));
                        if (it != stamps.end()) {
                            hs->h[0].add(h_now - it->second);
                            stamps.erase(it);
                        }
                    }
                    self->inflight.fetch_sub(1, std::memory_order_relaxed);
                    if (!rets[k].retire) {
                        self->late_retires.fetch_add(
                            1, std::memory_order_relaxed);
                        continue;
                    }
                    // the point first: once the engine has seen a pool's
                    // last retire, the pool's events are all in the ring
                    if (tw.st)
                        tw.rec(EV_DEV_RETIRE, done[k].second,
                               ptrace_ring::FLAG_POINT);
                    // the GIL-free landing into the engine's release walk
                    rets[k].retire(rets[k].obj, done[k].second);
                    self->retired.fetch_add(1, std::memory_order_relaxed);
                }
                did = true;
            }
        }

        if (!did) {
            std::unique_lock<std::mutex> lk(*self->mu);
            if (self->head.load(std::memory_order_acquire) == nullptr &&
                self->running.load(std::memory_order_acquire)) {
                // in-flight work: short event-poll cadence; idle: park
                // (a submit's lock-free notify — or the timeout — wakes us)
                auto dt = self->inflight.load(std::memory_order_relaxed) > 0
                              ? std::chrono::microseconds(self->poll_us)
                              : std::chrono::milliseconds(2);
                self->cv->wait_for(lk, dt);
            }
        }
    }
}

PyObject *lane_new(PyTypeObject *type, PyObject *, PyObject *) {
    Lane *self = reinterpret_cast<Lane *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    new (&self->head) std::atomic<PendNode *>(nullptr);
    self->mu = new (std::nothrow) std::mutex();
    self->cv = new (std::nothrow) std::condition_variable();
    self->mgr = nullptr;
    new (&self->running) std::atomic<bool>(false);
    self->pools = new (std::nothrow) PoolEnt[DEV_MAX_POOLS];
    self->dispatch_cb = self->poll_cb = nullptr;
    self->poll_us = 100;
    new (&self->inflight) std::atomic<int64_t>(0);
    new (&self->submitted) std::atomic<int64_t>(0);
    new (&self->dispatched) std::atomic<int64_t>(0);
    new (&self->retired) std::atomic<int64_t>(0);
    new (&self->dispatch_batches) std::atomic<int64_t>(0);
    new (&self->overlap_hits) std::atomic<int64_t>(0);
    new (&self->late_submits) std::atomic<int64_t>(0);
    new (&self->late_retires) std::atomic<int64_t>(0);
    new (&self->cb_errors) std::atomic<int64_t>(0);
    self->failed = false;
    self->errmsg[0] = '\0';
    new (&self->trace) std::atomic<ptrace_ring::State *>(nullptr);
    new (&self->hist) std::atomic<pthist::State<1> *>(nullptr);
    if (!self->mu || !self->cv || !self->pools) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    return reinterpret_cast<PyObject *>(self);
}

void lane_stop_impl(Lane *self) {
    if (!self->running.exchange(false, std::memory_order_acq_rel)) return;
    self->cv->notify_all();
    if (self->mgr) {
        // the manager may be blocked in PyGILState_Ensure: release the
        // GIL around the join so it can finish its iteration and exit
        Py_BEGIN_ALLOW_THREADS;
        self->mgr->join();
        Py_END_ALLOW_THREADS;
        delete self->mgr;
        self->mgr = nullptr;
    }
    // drop callbacks (GIL held) and the stranded pending queue
    Py_CLEAR(self->dispatch_cb);
    Py_CLEAR(self->poll_cb);
    PendNode *n = self->head.exchange(nullptr, std::memory_order_acq_rel);
    while (n) {
        PendNode *next = n->next;
        std::free(n);
        self->late_submits.fetch_add(1, std::memory_order_relaxed);
        n = next;
    }
}

void lane_dealloc(PyObject *obj) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    lane_stop_impl(self);
    if (self->pools)
        for (int i = 0; i < DEV_MAX_POOLS; i++)
            Py_CLEAR(self->pools[i].engine);
    delete[] self->pools;
    delete self->mu;
    delete self->cv;
    delete self->trace.load(std::memory_order_acquire);
    delete self->hist.load(std::memory_order_acquire);
    Py_TYPE(obj)->tp_free(obj);
}

// start(dispatch_cb, poll_cb, poll_us=100) — spawn the manager thread.
PyObject *lane_start(PyObject *obj, PyObject *args) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    PyObject *dcb, *pcb;
    int poll_us = 100;
    if (!PyArg_ParseTuple(args, "OO|i", &dcb, &pcb, &poll_us))
        return nullptr;
    if (!PyCallable_Check(dcb) || !PyCallable_Check(pcb)) {
        PyErr_SetString(PyExc_TypeError, "callbacks must be callable");
        return nullptr;
    }
    if (self->running.load(std::memory_order_acquire)) {
        PyErr_SetString(PyExc_RuntimeError, "lane already started");
        return nullptr;
    }
    Py_INCREF(dcb);
    Py_INCREF(pcb);
    self->dispatch_cb = dcb;
    self->poll_cb = pcb;
    self->poll_us = poll_us > 0 ? poll_us : 100;
    self->running.store(true, std::memory_order_release);
    self->mgr = new (std::nothrow) std::thread(lane_mgr_main, self);
    if (!self->mgr) {
        self->running.store(false, std::memory_order_release);
        Py_CLEAR(self->dispatch_cb);
        Py_CLEAR(self->poll_cb);
        return PyErr_NoMemory();
    }
    Py_RETURN_NONE;
}

PyObject *lane_stop(PyObject *obj, PyObject *) {
    lane_stop_impl(reinterpret_cast<Lane *>(obj));
    Py_RETURN_NONE;
}

// bind_pool(pool_id, retire_capsule, engine) — route pool's completions
// into `engine` through its retire vtable; the engine object is pinned
// for the bind window.
PyObject *lane_bind_pool(PyObject *obj, PyObject *args) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    unsigned int pool;
    PyObject *cap, *engine;
    if (!PyArg_ParseTuple(args, "IOO", &pool, &cap, &engine))
        return nullptr;
    PtDevRetireVtbl *rv = static_cast<PtDevRetireVtbl *>(
        PyCapsule_GetPointer(cap, PTDEV_RETIRE_CAPSULE));
    if (!rv) return nullptr;
    if (rv->abi != PTDEV_ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptdev ABI mismatch");
        return nullptr;
    }
    std::lock_guard<std::mutex> lk(*self->mu);
    if (lane_pool_slot_locked(self, pool) >= 0) {
        PyErr_SetString(PyExc_ValueError, "pool id already bound");
        return nullptr;
    }
    for (int i = 0; i < DEV_MAX_POOLS; i++) {
        if (!self->pools[i].used) {
            self->pools[i].used = true;
            self->pools[i].pool_id = pool;
            self->pools[i].ret = *rv;
            Py_INCREF(engine);
            self->pools[i].engine = engine;
            Py_RETURN_NONE;
        }
    }
    PyErr_SetString(PyExc_RuntimeError, "device lane pool table full");
    return nullptr;
}

PyObject *lane_unbind_pool(PyObject *obj, PyObject *arg) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    unsigned long pool = PyLong_AsUnsignedLong(arg);
    if (PyErr_Occurred()) return nullptr;
    PyObject *drop = nullptr;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        int s = lane_pool_slot_locked(self, (uint32_t)pool);
        if (s < 0) Py_RETURN_FALSE;
        self->pools[s].used = false;
        self->pools[s].ret = PtDevRetireVtbl{0, nullptr, nullptr};
        drop = self->pools[s].engine;
        self->pools[s].engine = nullptr;
    }
    Py_XDECREF(drop);     // outside mu: __del__ may re-enter the lane
    Py_RETURN_TRUE;
}

void submit_capsule_free(PyObject *cap) {
    std::free(PyCapsule_GetPointer(cap, PTDEV_SUBMIT_CAPSULE));
}

// submit_capsule() -> PyCapsule(PtDevSubmitVtbl) for Graph.dev_bind /
// Engine.dev_bind. Borrows `self`: the Python device lane keeps the Lane
// alive for every bound graph's lifetime (ptdev_iface.h lifetime rules).
PyObject *lane_submit_capsule(PyObject *obj, PyObject *) {
    PtDevSubmitVtbl *v =
        static_cast<PtDevSubmitVtbl *>(std::malloc(sizeof(PtDevSubmitVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTDEV_ABI;
    v->dev = obj;
    v->submit = lane_submit_c;
    PyObject *cap = PyCapsule_New(v, PTDEV_SUBMIT_CAPSULE,
                                  submit_capsule_free);
    if (!cap) std::free(v);
    return cap;
}

// submit(pool, tid) — Python mirror of the C entry (tests, seeding)
PyObject *lane_submit(PyObject *obj, PyObject *args) {
    unsigned int pool;
    int tid;
    if (!PyArg_ParseTuple(args, "Ii", &pool, &tid)) return nullptr;
    lane_submit_c(obj, pool, (int32_t)tid);
    Py_RETURN_NONE;
}

PyObject *lane_notify(PyObject *obj, PyObject *) {
    reinterpret_cast<Lane *>(obj)->cv->notify_one();
    Py_RETURN_NONE;
}

PyObject *lane_failed(PyObject *obj, PyObject *) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    std::lock_guard<std::mutex> lk(*self->mu);
    if (!self->failed) Py_RETURN_NONE;
    return PyUnicode_FromString(self->errmsg);
}

PyObject *lane_stats(PyObject *obj, PyObject *) {
    Lane *self = reinterpret_cast<Lane *>(obj);
    int npools = 0;
    {
        std::lock_guard<std::mutex> lk(*self->mu);
        for (int i = 0; i < DEV_MAX_POOLS; i++)
            if (self->pools[i].used) npools++;
    }
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:i}",
        "submitted", (long long)self->submitted.load(),
        "dispatched", (long long)self->dispatched.load(),
        "retired", (long long)self->retired.load(),
        "dispatch_batches", (long long)self->dispatch_batches.load(),
        "overlap_hits", (long long)self->overlap_hits.load(),
        "late_submits", (long long)self->late_submits.load(),
        "late_retires", (long long)self->late_retires.load(),
        "cb_errors", (long long)self->cb_errors.load(),
        "inflight", (long long)self->inflight.load(),
        "pools", npools);
}

// ------------------------------------------------------- in-lane tracing
PyObject *lane_trace_enable(PyObject *obj, PyObject *args) {
    return ptrace_ring::py_trace_enable(
        reinterpret_cast<Lane *>(obj)->trace, args);
}

PyObject *lane_trace_disable(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_disable(
        reinterpret_cast<Lane *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *lane_hist_enable(PyObject *obj, PyObject *) {
    return pthist::py_hist_enable<1>(reinterpret_cast<Lane *>(obj)->hist);
}

PyObject *lane_hist_snapshot(PyObject *obj, PyObject *) {
    return pthist::py_hist_snapshot<1>(
        reinterpret_cast<Lane *>(obj)->hist.load(std::memory_order_acquire),
        HIST_NAMES);
}

PyObject *lane_trace_drain(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_drain(
        reinterpret_cast<Lane *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *lane_trace_dropped(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_dropped(
        reinterpret_cast<Lane *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *lane_monotonic_ns(PyObject *, PyObject *) {
    return PyLong_FromLongLong(ptrace_ring::now_ns());
}

PyMethodDef lane_methods[] = {
    {"start", lane_start, METH_VARARGS,
     "start(dispatch_cb, poll_cb, poll_us=100): spawn the manager thread"},
    {"stop", lane_stop, METH_NOARGS,
     "stop the manager thread (idempotent; joins with the GIL released)"},
    {"bind_pool", lane_bind_pool, METH_VARARGS,
     "bind_pool(pool_id, retire_capsule, engine): route completions into "
     "the engine's GIL-free retire entry"},
    {"unbind_pool", lane_unbind_pool, METH_O,
     "unbind_pool(pool_id) -> bool: stop routing (straggler retires are "
     "counted late_retires, never trusted)"},
    {"submit_capsule", lane_submit_capsule, METH_NOARGS,
     "PyCapsule(PtDevSubmitVtbl) for the engines' dev_bind"},
    {"submit", lane_submit, METH_VARARGS,
     "submit(pool, tid): Python mirror of the GIL-free submit entry"},
    {"notify", lane_notify, METH_NOARGS, "wake a parked manager thread"},
    {"failed", lane_failed, METH_NOARGS,
     "None, or the message of the callback exception that poisoned the "
     "lane"},
    {"stats", lane_stats, METH_NOARGS, "lane counters"},
    {"trace_enable", lane_trace_enable, METH_VARARGS,
     "arm the in-lane event rings (EV_DEV_DISPATCH/EV_DEV_RETIRE)"},
    {"trace_disable", lane_trace_disable, METH_NOARGS, "stop recording"},
    {"hist_enable", lane_hist_enable, METH_NOARGS,
     "arm the retire_ns histogram (dispatch -> retire, per task)"},
    {"hist_snapshot", lane_hist_snapshot, METH_NOARGS,
     "hist_snapshot() -> {name: (count, sum_ns, buckets_bytes)}"},
    {"trace_drain", lane_trace_drain, METH_NOARGS,
     "trace_drain() -> [(ring_id, packed_events_bytes)]"},
    {"trace_dropped", lane_trace_dropped, METH_NOARGS,
     "cumulative events lost to ring overflow"},
    {"monotonic_ns", lane_monotonic_ns, METH_NOARGS,
     "the trace clock (steady_clock ns)"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject LaneType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptdev.Lane";
    t.tp_basicsize = sizeof(Lane);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "per-device async dispatch/retire plane (manager thread + "
               "MPSC pending queue + GIL-free retirement)";
    t.tp_new = lane_new;
    t.tp_dealloc = lane_dealloc;
    t.tp_methods = lane_methods;
    return t;
}();

PyModuleDef ptdev_module = {
    PyModuleDef_HEAD_INIT, "_ptdev",
    "native device lane (see csrc/ptdev.cpp)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__ptdev(void) {
    if (PyType_Ready(&LaneType) < 0 || PyType_Ready(&CohTableType) < 0)
        return nullptr;
    PyObject *m = PyModule_Create(&ptdev_module);
    if (!m) return nullptr;
    Py_INCREF(&LaneType);
    if (PyModule_AddObject(m, "Lane",
                           reinterpret_cast<PyObject *>(&LaneType)) < 0) {
        Py_DECREF(&LaneType);
        Py_DECREF(m);
        return nullptr;
    }
    Py_INCREF(&CohTableType);
    if (PyModule_AddObject(m, "CohTable",
                           reinterpret_cast<PyObject *>(&CohTableType)) < 0) {
        Py_DECREF(&CohTableType);
        Py_DECREF(m);
        return nullptr;
    }
    if (PyModule_AddIntConstant(m, "EV_DEV_DISPATCH", EV_DEV_DISPATCH) < 0 ||
        PyModule_AddIntConstant(m, "EV_DEV_RETIRE", EV_DEV_RETIRE) < 0 ||
        PyModule_AddIntConstant(m, "HIST_BUCKETS", pthist::NBUCKETS) < 0 ||
        PyModule_AddIntConstant(m, "COH_INVALID", COH_INVALID) < 0 ||
        PyModule_AddIntConstant(m, "COH_OWNED", COH_OWNED) < 0 ||
        PyModule_AddIntConstant(m, "COH_SHARED", COH_SHARED) < 0 ||
        PyModule_AddIntConstant(m, "MAX_POOLS", DEV_MAX_POOLS) < 0) {
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
