// parsec_tpu_torch._ptsched — the multi-pool scheduler plane as a CPython
// extension (see ptsched.h for the machinery; this file is
// only the Python surface + the capsule that hands the live plane to the
// execution engines).
//
// One Plane per Context (core/sched_plane.py owns the lifecycle): pools
// register with a QoS weight and an admission window, the engines bind
// through plane_capsule(), and every counter the plane keeps (steals,
// spills, per-pool served/deficit, admission stalls) is readable here for
// the unified registry (`sched.*`). The `queue_ns` histogram (push ->
// pop wait, sampled 1-in-8 by task id) snapshots through the same
// pthist.h surface as the lanes' histograms.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <new>
#include <vector>

#include "pthist.h"
#include "ptsched.h"

namespace {

using ptsched::Item;
using ptsched::Plane;

const char *const HIST_NAMES[1] = {"queue_ns"};

struct PyPlane {
    PyObject_HEAD
    Plane *plane;
};

PyObject *plane_new(PyTypeObject *type, PyObject *args, PyObject *kw) {
    static const char *kws[] = {"nworkers", "policy", "quantum", nullptr};
    int nworkers = 1, policy = ptsched::POLICY_WDRR;
    long long quantum = 256;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "|iiL",
                                     const_cast<char **>(kws), &nworkers,
                                     &policy, &quantum))
        return nullptr;
    if (policy < ptsched::POLICY_FIFO || policy > ptsched::POLICY_RNDSTEAL) {
        PyErr_SetString(PyExc_ValueError, "unknown policy");
        return nullptr;
    }
    PyPlane *self = reinterpret_cast<PyPlane *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    self->plane = new (std::nothrow) Plane(nworkers, policy, quantum);
    if (!self->plane) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    return reinterpret_cast<PyObject *>(self);
}

void plane_dealloc(PyObject *obj) {
    delete reinterpret_cast<PyPlane *>(obj)->plane;
    Py_TYPE(obj)->tp_free(obj);
}

inline Plane *P(PyObject *obj) {
    return reinterpret_cast<PyPlane *>(obj)->plane;
}

bool check_handle(Plane *pl, long h) {
    (void)pl;
    if (h < 0 || h >= ptsched::MAX_POOLS) {
        PyErr_SetString(PyExc_IndexError, "bad pool handle");
        return false;
    }
    return true;
}

// register_pool(ext_id, kind, weight=1, window=0) -> handle
PyObject *plane_register_pool(PyObject *obj, PyObject *args, PyObject *kw) {
    static const char *kws[] = {"ext_id", "kind", "weight", "window",
                                nullptr};
    unsigned int ext_id = 0;
    int kind = ptsched::KIND_EXT, weight = 1;
    long long window = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "|IiiL",
                                     const_cast<char **>(kws), &ext_id,
                                     &kind, &weight, &window))
        return nullptr;
    int h = P(obj)->pool_register(ext_id, kind, weight, window);
    if (h < 0) {
        PyErr_SetString(PyExc_RuntimeError, "scheduler pool table full");
        return nullptr;
    }
    return PyLong_FromLong(h);
}

PyObject *plane_unregister_pool(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->pool_unregister((int)h);
    Py_RETURN_NONE;
}

// push(h, tids, prios=None, worker=-1) -> bool (over admission window)
PyObject *plane_push(PyObject *obj, PyObject *args, PyObject *kw) {
    static const char *kws[] = {"h", "tids", "prios", "worker", nullptr};
    long h;
    PyObject *tids_o, *prios_o = Py_None;
    int worker = -1;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "lO|Oi",
                                     const_cast<char **>(kws), &h, &tids_o,
                                     &prios_o, &worker))
        return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    std::vector<int32_t> tids, prios;
    PyObject *fast = PySequence_Fast(tids_o, "tids: sequence of ints");
    if (!fast) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    tids.reserve((size_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
        long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
        if (v == -1 && PyErr_Occurred()) { Py_DECREF(fast); return nullptr; }
        tids.push_back((int32_t)v);
    }
    Py_DECREF(fast);
    if (prios_o != Py_None) {
        fast = PySequence_Fast(prios_o, "prios: sequence of ints");
        if (!fast) return nullptr;
        if (PySequence_Fast_GET_SIZE(fast) != n) {
            Py_DECREF(fast);
            PyErr_SetString(PyExc_ValueError, "tids/prios length mismatch");
            return nullptr;
        }
        prios.reserve((size_t)n);
        for (Py_ssize_t i = 0; i < n; i++) {
            long v = PyLong_AsLong(PySequence_Fast_GET_ITEM(fast, i));
            if (v == -1 && PyErr_Occurred()) {
                Py_DECREF(fast);
                return nullptr;
            }
            prios.push_back((int32_t)v);
        }
        Py_DECREF(fast);
    }
    bool over = P(obj)->push((int)h, worker, tids.data(),
                             prios.empty() ? nullptr : prios.data(),
                             (int)n);
    return PyBool_FromLong(over ? 1 : 0);
}

// pop(worker=0, kind=-1, pool=-1, cap=256) -> [(pool, tid), ...]
PyObject *plane_pop(PyObject *obj, PyObject *args, PyObject *kw) {
    static const char *kws[] = {"worker", "kind", "pool", "cap", nullptr};
    int worker = 0, kind = ptsched::KIND_ANY, pool = -1, cap = 256;
    if (!PyArg_ParseTupleAndKeywords(args, kw, "|iiii",
                                     const_cast<char **>(kws), &worker,
                                     &kind, &pool, &cap))
        return nullptr;
    if (cap <= 0) cap = 256;
    std::vector<Item> out((size_t)cap);
    int n;
    Py_BEGIN_ALLOW_THREADS
    n = P(obj)->pop(worker, kind, pool, out.data(), cap);
    Py_END_ALLOW_THREADS
    PyObject *lst = PyList_New((Py_ssize_t)n);
    if (!lst) return nullptr;
    for (int i = 0; i < n; i++) {
        PyObject *t = Py_BuildValue("(ii)", (int)out[(size_t)i].pool,
                                    (int)out[(size_t)i].tid);
        if (!t) { Py_DECREF(lst); return nullptr; }
        PyList_SET_ITEM(lst, (Py_ssize_t)i, t);
    }
    return lst;
}

PyObject *plane_admit(PyObject *obj, PyObject *args) {
    long h;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "l|L", &h, &n)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->admit((int)h, n);
    Py_RETURN_NONE;
}

PyObject *plane_retired(PyObject *obj, PyObject *args) {
    long h;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "l|L", &h, &n)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->retired((int)h, n);
    Py_RETURN_NONE;
}

PyObject *plane_inflight(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyLong_FromLongLong(P(obj)->inflight_of((int)h));
}

PyObject *plane_over_window(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyBool_FromLong(P(obj)->over_window((int)h) ? 1 : 0);
}

PyObject *plane_remote_grant(PyObject *obj, PyObject *args) {
    long h;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "l|L", &h, &n)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->remote_grant((int)h, n);
    Py_RETURN_NONE;
}

PyObject *plane_remote_release(PyObject *obj, PyObject *args) {
    long h;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "l|L", &h, &n)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->remote_release((int)h, n);
    Py_RETURN_NONE;
}

PyObject *plane_remote_granted(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyLong_FromLongLong(P(obj)->remote_granted_of((int)h));
}

PyObject *plane_headroom(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyLong_FromLongLong(P(obj)->headroom_of((int)h));
}

PyObject *plane_set_weight(PyObject *obj, PyObject *args) {
    long h;
    int w;
    if (!PyArg_ParseTuple(args, "li", &h, &w)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->set_weight((int)h, (int32_t)w);
    Py_RETURN_NONE;
}

PyObject *plane_stall(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    Plane *pl = P(obj);
    pl->pools[h].stalls.fetch_add(1, std::memory_order_relaxed);
    pl->admission_stalls.fetch_add(1, std::memory_order_relaxed);
    Py_RETURN_NONE;
}

PyObject *plane_queued(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyLong_FromLongLong(P(obj)->queued_of((int)h));
}

PyObject *plane_queued_kind(PyObject *obj, PyObject *args) {
    int kind = ptsched::KIND_ANY;
    if (!PyArg_ParseTuple(args, "|i", &kind)) return nullptr;
    return PyLong_FromLongLong(P(obj)->queued_kind(kind));
}

// next_pool(kind=-1) -> (handle, quantum) or None
PyObject *plane_next_pool(PyObject *obj, PyObject *args) {
    int kind = ptsched::KIND_ANY;
    if (!PyArg_ParseTuple(args, "|i", &kind)) return nullptr;
    int64_t q = 0;
    int h = P(obj)->next_pool(kind, &q);
    if (h < 0) Py_RETURN_NONE;
    return Py_BuildValue("(iL)", h, (long long)q);
}

PyObject *plane_charge(PyObject *obj, PyObject *args) {
    long h;
    long long n;
    if (!PyArg_ParseTuple(args, "lL", &h, &n)) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    P(obj)->charge((int)h, n);
    Py_RETURN_NONE;
}

PyObject *plane_deficit(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    return PyLong_FromLongLong(P(obj)->deficit_of((int)h));
}

PyObject *plane_stats(PyObject *obj, PyObject *) {
    Plane *pl = P(obj);
    int64_t steals = 0;
    for (int w = 0; w < pl->nworkers; w++)
        steals += pl->steals[w].load(std::memory_order_relaxed);
    int64_t queued = 0;
    for (int i = 0; i < ptsched::MAX_POOLS; i++) {
        ptsched::Pool &p = pl->pools[i];
        if (p.live) queued += p.queued.load(std::memory_order_relaxed);
    }
    // served/spills/stalls come from the plane-LIFETIME accumulators:
    // per-pool counters reset when a freed slot is re-registered, so
    // summing them would make these metrics go BACKWARDS (found by the
    // verify drive: a second wave of pools wiped the first wave's served)
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:i,s:i}",
        "steals", (long long)steals,
        "steal_visits",
        (long long)pl->steal_visits.load(std::memory_order_relaxed),
        "spills",
        (long long)pl->spills_total.load(std::memory_order_relaxed),
        "served",
        (long long)pl->served_total.load(std::memory_order_relaxed),
        "admission_stalls",
        (long long)pl->admission_stalls.load(std::memory_order_relaxed),
        "weight_adjusts",
        (long long)pl->weight_adjusts.load(std::memory_order_relaxed),
        "queued", (long long)queued,
        "pools_registered",
        (long long)pl->pools_registered.load(std::memory_order_relaxed),
        "pools_live",
        (long long)pl->pools_live.load(std::memory_order_relaxed),
        "policy", pl->policy, "nworkers", pl->nworkers);
}

PyObject *plane_worker_steals(PyObject *obj, PyObject *arg) {
    long w = PyLong_AsLong(arg);
    if (w == -1 && PyErr_Occurred()) return nullptr;
    Plane *pl = P(obj);
    if (w < 0 || w >= pl->nworkers) {
        PyErr_SetString(PyExc_IndexError, "bad worker id");
        return nullptr;
    }
    return PyLong_FromLongLong(
        pl->steals[w].load(std::memory_order_relaxed));
}

PyObject *plane_pool_stats(PyObject *obj, PyObject *arg) {
    long h = PyLong_AsLong(arg);
    if (h == -1 && PyErr_Occurred()) return nullptr;
    if (!check_handle(P(obj), h)) return nullptr;
    ptsched::Pool &p = P(obj)->pools[h];
    return Py_BuildValue(
        "{s:O,s:i,s:i,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:I}",
        "live", p.live ? Py_True : Py_False,
        "kind", p.kind,
        "weight", (int)p.weight.load(std::memory_order_relaxed),
        "window", (long long)p.window,
        "queued", (long long)p.queued.load(std::memory_order_relaxed),
        "inflight", (long long)p.inflight.load(std::memory_order_relaxed),
        "remote_granted",
        (long long)p.remote_granted.load(std::memory_order_relaxed),
        "served", (long long)p.served.load(std::memory_order_relaxed),
        "spills", (long long)p.spills.load(std::memory_order_relaxed),
        "stalls", (long long)p.stalls.load(std::memory_order_relaxed),
        "ext_id", (unsigned int)p.ext_id);
}

// ------------------------------------------------------------- the capsule
// plane_capsule() -> PyCapsule(Plane*). The capsule owns one strong
// reference to this Plane OBJECT (its context pointer): an engine that
// stores the capsule keeps the plane alive for the binding window, the
// ptcomm_iface.h lifetime discipline without a second Python object.
void plane_capsule_free(PyObject *cap) {
    PyObject *owner =
        static_cast<PyObject *>(PyCapsule_GetContext(cap));
    Py_XDECREF(owner);
}

PyObject *plane_capsule(PyObject *obj, PyObject *) {
    PyObject *cap = PyCapsule_New(P(obj), PTSCHED_PLANE_CAPSULE,
                                  plane_capsule_free);
    if (!cap) return nullptr;
    Py_INCREF(obj);
    if (PyCapsule_SetContext(cap, obj) < 0) {
        Py_DECREF(obj);
        Py_DECREF(cap);
        return nullptr;
    }
    return cap;
}

// --------------------------------------------------- latency histograms
PyObject *plane_hist_enable(PyObject *obj, PyObject *) {
    return pthist::py_hist_enable<1>(P(obj)->hist);
}

PyObject *plane_hist_disable(PyObject *obj, PyObject *) {
    return pthist::py_hist_disable<1>(
        P(obj)->hist.load(std::memory_order_acquire));
}

PyObject *plane_hist_snapshot(PyObject *obj, PyObject *) {
    return pthist::py_hist_snapshot<1>(
        P(obj)->hist.load(std::memory_order_acquire), HIST_NAMES);
}

PyMethodDef plane_methods[] = {
    {"register_pool", reinterpret_cast<PyCFunction>(plane_register_pool),
     METH_VARARGS | METH_KEYWORDS,
     "register_pool(ext_id=0, kind=KIND_EXT, weight=1, window=0) -> "
     "handle: admit a pool to the plane (weight = DRR share, window = "
     "admission soft limit, 0 = unlimited)"},
    {"unregister_pool", plane_unregister_pool, METH_O,
     "drop a pool: sweep its items out of every queue, free the slot"},
    {"push", reinterpret_cast<PyCFunction>(plane_push),
     METH_VARARGS | METH_KEYWORDS,
     "push(h, tids, prios=None, worker=-1) -> over_window: enqueue ready "
     "items (worker >= 0 routes via that worker's hot queue)"},
    {"pop", reinterpret_cast<PyCFunction>(plane_pop),
     METH_VARARGS | METH_KEYWORDS,
     "pop(worker=0, kind=-1, pool=-1, cap=256) -> [(pool, tid)]: hot "
     "queue, then DRR overflow refill, then steal-half"},
    {"admit", plane_admit, METH_VARARGS,
     "admit(h, n=1): n tasks entered the pool (admission accounting)"},
    {"retired", plane_retired, METH_VARARGS,
     "retired(h, n=1): n tasks completed (admission accounting)"},
    {"inflight", plane_inflight, METH_O,
     "admitted-minus-retired tasks of pool h"},
    {"over_window", plane_over_window, METH_O,
     "True when pool h is past its admission window (local inflight + "
     "remote grants share the budget)"},
    {"remote_grant", plane_remote_grant, METH_VARARGS,
     "remote_grant(h, n=1): reserve window room for credits granted to "
     "remote inserters (ptfab)"},
    {"remote_release", plane_remote_release, METH_VARARGS,
     "remote_release(h, n=1): release reserved remote window room "
     "(arrival/return/reclaim; floors at 0)"},
    {"remote_granted", plane_remote_granted, METH_O,
     "window room currently reserved for remote inserters of pool h"},
    {"headroom", plane_headroom, METH_O,
     "grantable window room of pool h (window - inflight - "
     "remote_granted), -1 = unlimited"},
    {"set_weight", plane_set_weight, METH_VARARGS,
     "set_weight(h, w): mid-run QoS weight nudge (the ptfab "
     "reconciliation entry; binds at the next DRR round top-up)"},
    {"stall", plane_stall, METH_O,
     "count one admission stall against pool h"},
    {"queued", plane_queued, METH_O,
     "ready items of pool h currently in the plane"},
    {"queued_kind", plane_queued_kind, METH_VARARGS,
     "queued_kind(kind=-1) -> total ready items across live pools"},
    {"next_pool", plane_next_pool, METH_VARARGS,
     "next_pool(kind=-1) -> (handle, quantum) | None: DRR pick among "
     "pools with queued work"},
    {"charge", plane_charge, METH_VARARGS,
     "charge(h, n): spend n DRR credits of pool h"},
    {"deficit", plane_deficit, METH_O,
     "current DRR deficit (unspent credits) of pool h"},
    {"stats", plane_stats, METH_NOARGS,
     "{steals, steal_visits, spills, served, admission_stalls, queued, "
     "pools_registered, pools_live, policy, nworkers}"},
    {"worker_steals", plane_worker_steals, METH_O,
     "items stolen BY worker w"},
    {"pool_stats", plane_pool_stats, METH_O,
     "per-pool counters {live, kind, weight, window, queued, inflight, "
     "served, spills, stalls, ext_id}"},
    {"plane_capsule", plane_capsule, METH_NOARGS,
     "PyCapsule(Plane*) for Graph.sched_bind / Engine.sched_bind; the "
     "capsule keeps this plane alive"},
    {"hist_enable", plane_hist_enable, METH_NOARGS,
     "arm the sched.queue_ns histogram (push->pop wait, sampled 1-in-8)"},
    {"hist_disable", plane_hist_disable, METH_NOARGS,
     "stop recording (buckets are kept)"},
    {"hist_snapshot", plane_hist_snapshot, METH_NOARGS,
     "{name: (count, sum_ns, buckets_bytes)} — buckets pack '<496Q'"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PlaneType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptsched.Plane";
    t.tp_basicsize = sizeof(PyPlane);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "native multi-pool scheduler plane (see csrc/ptsched.h)";
    t.tp_new = plane_new;
    t.tp_dealloc = plane_dealloc;
    t.tp_methods = plane_methods;
    return t;
}();

PyModuleDef ptsched_module = {
    PyModuleDef_HEAD_INIT, "_ptsched",
    "native multi-pool scheduler plane (see csrc/ptsched.h)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__ptsched(void) {
    if (PyType_Ready(&PlaneType) < 0) return nullptr;
    PyObject *m = PyModule_Create(&ptsched_module);
    if (!m) return nullptr;
    Py_INCREF(&PlaneType);
    if (PyModule_AddObject(m, "Plane",
                           reinterpret_cast<PyObject *>(&PlaneType)) < 0) {
        Py_DECREF(&PlaneType);
        Py_DECREF(m);
        return nullptr;
    }
    if (PyModule_AddIntConstant(m, "POLICY_FIFO", ptsched::POLICY_FIFO) < 0 ||
        PyModule_AddIntConstant(m, "POLICY_PRIO", ptsched::POLICY_PRIO) < 0 ||
        PyModule_AddIntConstant(m, "POLICY_WDRR", ptsched::POLICY_WDRR) < 0 ||
        PyModule_AddIntConstant(m, "POLICY_RNDSTEAL",
                                ptsched::POLICY_RNDSTEAL) < 0 ||
        PyModule_AddIntConstant(m, "KIND_ANY", ptsched::KIND_ANY) < 0 ||
        PyModule_AddIntConstant(m, "KIND_PTEXEC", ptsched::KIND_PTEXEC) < 0 ||
        PyModule_AddIntConstant(m, "KIND_PTDTD", ptsched::KIND_PTDTD) < 0 ||
        PyModule_AddIntConstant(m, "KIND_EXT", ptsched::KIND_EXT) < 0 ||
        PyModule_AddIntConstant(m, "MAX_WORKERS", ptsched::MAX_WORKERS) < 0 ||
        PyModule_AddIntConstant(m, "MAX_POOLS", ptsched::MAX_POOLS) < 0 ||
        PyModule_AddIntConstant(m, "HOTQ_CAP", ptsched::HOTQ_CAP) < 0) {
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
