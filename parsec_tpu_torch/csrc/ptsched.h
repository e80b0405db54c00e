// ptsched — the native multi-pool scheduler plane.
//
// Stands where the reference's MCA scheduler family stands
// (parsec/mca/sched/sched.h:210-335, LFQ/LTQ/AP/PBQ/RND): a SHARED ready
// plane both native engines (_ptexec graphs, the _ptdtd batch lane) drain
// through instead of their private ready vectors, so N concurrent
// taskpools share the execution lanes by configurable QoS weight instead
// of whoever-inserted-last winning. Structure mirrors the reference's
// local-queues shape (hbbuffer.c + sched_local_queues_utils.h):
//
//   * per-WORKER bounded hot queues (the HBBUFF role): the owner pushes
//     and pops the back (hot/LIFO end); overflow spills to the owning
//     pool's cold structure, counted per pool;
//   * per-POOL overflow queues — a plain LIFO vector, or a max-heap once
//     any nonzero priority is pushed (the ptexec use_heap contract);
//   * cross-worker STEALING: a starved worker visits victims' hot queues
//     with try_lock only (a contended victim is skipped, never waited on)
//     and carries HALF the matching items home from the COLD end —
//     heap_split_and_steal's "related work migrates together", counted
//     per thief;
//   * weighted DEFICIT-ROUND-ROBIN arbitration across registered pools:
//     mixed pops (the DTD drain) refill from pool overflow in DRR order,
//     and next_pool()/charge() drive the same deficits for consumers that
//     must drain one pool at a time (the ptexec lane queue in
//     core/context.py) — every pool with queued work is visited within
//     one cursor cycle, so the starvation bound is structural;
//   * ADMISSION window per pool: admit()/retired() track in-flight
//     (inserted-not-completed) tasks; past the window, push/insert paths
//     report a soft-limit signal the Python side turns into a
//     bounded-blocking (or nowait-erroring) insert_task.
//
// SHARING ACROSS EXTENSIONS: _ptexec/_ptdtd/_ptsched are separate .so's
// built from this one header by the package's native.py build,
// so the struct layout is identical in all of them; the live Plane is
// allocated by _ptsched and handed to the engines as a PyCapsule carrying
// the raw pointer (abi field checked first, the ptcomm_iface.h pattern).
// All plane entry points are GIL-agnostic: engines call them with the GIL
// dropped mid-walk, the comm progress thread calls push() from ingest.
//
// SINGLE-POOL FAST PATH: with one live pool and no contention a push or a
// batched pop costs one uncontended mutex acquire and vector ops on
// preallocated storage — no allocation, no arbitration walk — keeping the
// bound chain bench inside a <2% overhead budget.
//
// Policies (selected by --mca sched through SchedulerModule.native_policy,
// core/scheduler.py):
//   FIFO      pool overflow drains oldest-first, round-robin across pools
//   PRIO      strict priority: hot queues bypassed, per-pool max-heaps,
//             the pool with the best top priority is served first
//   WDRR      (default, lfq) hot queues + steal + weighted DRR refill
//   RNDSTEAL  WDRR structure with randomized victim/pool visit order

#ifndef PARSEC_TPU_PTSCHED_H
#define PARSEC_TPU_PTSCHED_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <mutex>
#include <new>
#include <vector>

#include "pthist.h"
#include "ptrace_ring.h"

// capsule name (PyCapsule_New contract; holder keeps the plane alive via
// the capsule's context ref — see ptsched.cpp plane_capsule)
#define PTSCHED_PLANE_CAPSULE "parsec_tpu_torch.ptsched.plane"

namespace ptsched {

constexpr int ABI = 2;          // bump on any layout/semantics change
                                // (2: atomic weight + remote windows)

constexpr int MAX_WORKERS = 64;
constexpr int MAX_POOLS = 1024;
constexpr int HOTQ_CAP = 256;   // per-worker bounded hot queue (HBBUFF cap)

constexpr int POLICY_FIFO = 0;
constexpr int POLICY_PRIO = 1;
constexpr int POLICY_WDRR = 2;
constexpr int POLICY_RNDSTEAL = 3;

// pool kinds: consumers pop only their own kind (the DTD engine must
// never receive a ptexec graph's task id and vice versa)
constexpr int KIND_ANY = -1;
constexpr int KIND_PTEXEC = 0;
constexpr int KIND_PTDTD = 1;
constexpr int KIND_EXT = 2;     // plane-only harnesses (tests)

// queue-wait histogram: sampled 1-in-8 by task id, the ptexec discipline
inline bool queue_sampled(int32_t tid) { return (tid & 7) == 0; }

struct Item {
    int32_t tid;
    int32_t pool;    // plane pool handle (slot index)
    int32_t prio;
    int32_t pad_;
    int64_t t_push;  // push stamp (ns) for sched.queue_ns; 0 = unsampled
};

// max-heap on (prio, tid): among equal priorities the higher id wins —
// the exact PrioLess contract of ptexec.cpp so heap pools keep the lane's
// ordering guarantee when their ready storage moves here
struct ItemPrioLess {
    bool operator()(const Item &a, const Item &b) const {
        return a.prio < b.prio || (a.prio == b.prio && a.tid < b.tid);
    }
};

struct Pool {
    std::mutex mu;                 // guards overflow/heap/live transitions
    std::vector<Item> overflow;    // LIFO vector, max-heap once `heap`
    bool heap = false;             // sticky: set by the first nonzero prio
    bool live = false;
    int kind = KIND_EXT;
    // weight is ATOMIC: the serving fabric's reconciliation
    // loop nudges it mid-run (set_weight) while DRR refills read it
    std::atomic<int32_t> weight{1};
    int64_t window = 0;            // admission window, 0 = unlimited
    uint32_t ext_id = 0;           // caller's pool identity (diagnostics)
    int64_t deficit = 0;           // DRR credits (guarded by arb_mu)
    std::atomic<int64_t> queued{0};    // items in hot queues + overflow
    std::atomic<int64_t> inflight{0};  // admit() - retired()
    // window room RESERVED for remote inserters: credits
    // granted on the wire and not yet consumed/returned/reclaimed.
    // over_window charges it alongside inflight, so local and remote
    // admission share ONE budget per pool
    std::atomic<int64_t> remote_granted{0};
    std::atomic<int64_t> served{0};    // items popped for execution
    std::atomic<int64_t> spills{0};    // hot-queue overflow -> pool cold
    std::atomic<int64_t> stalls{0};    // admission stalls (python bumps)
};

struct HotQ {
    std::mutex mu;
    std::vector<Item> buf;         // back = hot end, front = cold end
};

struct Plane {
    int abi = ABI;
    int nworkers = 1;
    int policy = POLICY_WDRR;
    int64_t quantum = 256;         // DRR credit unit per weight point
    Pool pools[MAX_POOLS];
    HotQ hot[MAX_WORKERS];
    std::mutex reg_mu;             // registration/unregistration
    std::mutex arb_mu;             // DRR cursors + deficits
    int cursor[3] = {0, 0, 0};     // per-kind DRR cursor (ptexec/ptdtd/ext)
    std::atomic<int64_t> steals[MAX_WORKERS];   // items stolen BY worker w
    std::atomic<int64_t> steal_visits{0};       // victim queues examined
    std::atomic<int64_t> pools_registered{0};   // lifetime registrations
    std::atomic<int64_t> pools_live{0};
    std::atomic<int64_t> admission_stalls{0};
    std::atomic<int64_t> weight_adjusts{0};   // set_weight calls (ptfab)
    // plane-LIFETIME accumulators: per-pool counters reset when a freed
    // slot is re-registered, so summing them is non-monotonic — a
    // metrics counter must never go backwards
    std::atomic<int64_t> served_total{0};
    std::atomic<int64_t> spills_total{0};
    std::atomic<pthist::State<1> *> hist{nullptr};  // "queue_ns"
    std::atomic<uint32_t> rng{0x9E3779B9u};

    Plane(int nw, int pol, int64_t q) {
        nworkers = nw < 1 ? 1 : (nw > MAX_WORKERS ? MAX_WORKERS : nw);
        policy = pol;
        quantum = q > 0 ? q : 256;
        for (int w = 0; w < MAX_WORKERS; w++)
            steals[w].store(0, std::memory_order_relaxed);
        for (int w = 0; w < nworkers; w++)
            hot[w].buf.reserve(HOTQ_CAP);
    }
    ~Plane() { delete hist.load(std::memory_order_acquire); }

    inline uint32_t xrand() {
        // xorshift32 — victim/pool visit order for RNDSTEAL; collisions
        // are harmless (it only biases the walk order)
        uint32_t x = rng.load(std::memory_order_relaxed);
        x ^= x << 13; x ^= x >> 17; x ^= x << 5;
        rng.store(x, std::memory_order_relaxed);
        return x;
    }

    inline pthist::State<1> *hist_armed() {
        pthist::State<1> *hs = hist.load(std::memory_order_acquire);
        if (hs && !hs->enabled.load(std::memory_order_relaxed)) hs = nullptr;
        return hs;
    }

    // --------------------------------------------------------- registration
    // -> pool handle (slot index), or -1 when the table is full. Slots are
    // static storage and reusable after unregister; a handle never dangles.
    int pool_register(uint32_t ext_id, int kind, int32_t weight,
                      int64_t window) {
        std::lock_guard<std::mutex> rl(reg_mu);
        for (int i = 0; i < MAX_POOLS; i++) {
            Pool &p = pools[i];
            bool claimed = false;
            {
                std::lock_guard<std::mutex> pl(p.mu);
                if (!p.live) {
                    p.overflow.clear();
                    p.heap = (policy == POLICY_PRIO);
                    p.kind = kind;
                    p.weight.store(weight > 0 ? weight : 1,
                                   std::memory_order_relaxed);
                    p.window = window > 0 ? window : 0;
                    p.ext_id = ext_id;
                    p.queued.store(0, std::memory_order_relaxed);
                    p.inflight.store(0, std::memory_order_relaxed);
                    p.remote_granted.store(0, std::memory_order_relaxed);
                    p.served.store(0, std::memory_order_relaxed);
                    p.spills.store(0, std::memory_order_relaxed);
                    p.stalls.store(0, std::memory_order_relaxed);
                    p.live = true;
                    claimed = true;
                }
            }
            if (!claimed) continue;
            {
                // deficit reset AFTER p.mu drops: the arbitration lock
                // nests INSIDE p.mu's scope here while refill_drr holds
                // arb_mu across take_overflow's p.mu — taking them in
                // both orders was an ABBA deadlock a register racing a
                // mixed-kind pop could hit (found by the churn test
                // wedging the full suite under load; whichever thread
                // deadlocked held the GIL, freezing the process). A pop
                // reading the pre-reset deficit in the window costs one
                // WDRR credit blip on a just-registered pool, nothing
                // more — deficit is advisory fairness state.
                std::lock_guard<std::mutex> al(arb_mu);
                p.deficit = 0;
            }
            pools_registered.fetch_add(1, std::memory_order_relaxed);
            pools_live.fetch_add(1, std::memory_order_relaxed);
            return i;
        }
        return -1;
    }

    // Drop a pool: sweep its straggler items out of every hot queue, clear
    // its overflow, free the slot. Safe mid-run: slots are static storage,
    // so a pop racing the sweep at worst returns an item for a pool that
    // just died — the consumer side (engine/harness) tolerates that the
    // same way ptcomm tolerates late frames. Normal flow unregisters only
    // after the pool quiesced (queued == 0, inflight == 0).
    void pool_unregister(int h) {
        if (h < 0 || h >= MAX_POOLS) return;
        pool_clear(h);           // ONE home for the zombie-item sweep
        Pool &p = pools[h];
        std::lock_guard<std::mutex> pl(p.mu);
        if (p.live) {
            p.live = false;
            pools_live.fetch_sub(1, std::memory_order_relaxed);
        }
    }

    // Drain EVERY queued item of pool h into `out` with BLOCKING locks —
    // the unbind migration path: the regular pop's steal uses try_lock
    // and skips contended victims, which would silently drop their items
    // to the unregister sweep. Cold path; correctness over latency.
    void pool_drain_all(int h, std::vector<int32_t> &out) {
        if (h < 0 || h >= MAX_POOLS) return;
        for (int w = 0; w < nworkers; w++) {
            std::lock_guard<std::mutex> hl(hot[w].mu);
            std::vector<Item> &b = hot[w].buf;
            size_t o = 0;
            for (size_t i = 0; i < b.size(); i++) {
                if (b[i].pool == h)
                    out.push_back(b[i].tid);
                else
                    b[o++] = b[i];
            }
            b.resize(o);
        }
        Pool &p = pools[h];
        std::lock_guard<std::mutex> pl(p.mu);
        for (const Item &it : p.overflow) out.push_back(it.tid);
        p.overflow.clear();
        p.queued.store(0, std::memory_order_relaxed);
    }

    // Flush a pool's queued items (hot queues + overflow) without freeing
    // the slot — the graph replay (reset) path: stale items from an
    // abandoned run must not resurface in the rewound graph.
    void pool_clear(int h) {
        if (h < 0 || h >= MAX_POOLS) return;
        Pool &p = pools[h];
        for (int w = 0; w < nworkers; w++) {
            std::lock_guard<std::mutex> hl(hot[w].mu);
            std::vector<Item> &b = hot[w].buf;
            size_t o = 0;
            for (size_t i = 0; i < b.size(); i++)
                if (b[i].pool != h) b[o++] = b[i];
            b.resize(o);
        }
        std::lock_guard<std::mutex> pl(p.mu);
        p.overflow.clear();
        p.queued.store(0, std::memory_order_relaxed);
        p.inflight.store(0, std::memory_order_relaxed);
    }

    // ------------------------------------------------------------ admission
    inline void admit(int h, int64_t n) {
        if (h >= 0) pools[h].inflight.fetch_add(n, std::memory_order_relaxed);
    }
    inline void retired(int h, int64_t n) {
        if (h >= 0) pools[h].inflight.fetch_sub(n, std::memory_order_relaxed);
    }
    inline int64_t inflight_of(int h) {
        return h < 0 ? 0 : pools[h].inflight.load(std::memory_order_relaxed);
    }
    inline int64_t charge_of(Pool &p) {
        // total window charge: local in-flight + room reserved for
        // remote inserters (the shared-budget contract)
        return p.inflight.load(std::memory_order_relaxed) +
               p.remote_granted.load(std::memory_order_relaxed);
    }
    inline bool over_window(int h) {
        if (h < 0) return false;
        Pool &p = pools[h];
        return p.window > 0 && charge_of(p) > p.window;
    }

    // ---------------------------------------------------- remote windows
    // reserve/release window room for credits granted to remote
    // inserters. The fabric reserves BEFORE a wire grant and
    // releases as granted work arrives (admit() then carries it as
    // inflight), as unspent credits return, or at peer-death reclaim —
    // the reservation can therefore never leak past those three paths.
    inline void remote_grant(int h, int64_t n) {
        if (h >= 0)
            pools[h].remote_granted.fetch_add(n, std::memory_order_relaxed);
    }
    inline void remote_release(int h, int64_t n) {
        if (h < 0) return;
        // floor at 0: a release racing a reclaim must not go negative
        // (advisory accounting, same discipline as the DRR deficit)
        Pool &p = pools[h];
        int64_t cur = p.remote_granted.load(std::memory_order_relaxed);
        while (cur > 0) {
            int64_t next = cur > n ? cur - n : 0;
            if (p.remote_granted.compare_exchange_weak(
                    cur, next, std::memory_order_relaxed,
                    std::memory_order_relaxed))
                break;
        }
    }
    inline int64_t remote_granted_of(int h) {
        return h < 0 ? 0
                     : pools[h].remote_granted.load(
                           std::memory_order_relaxed);
    }
    // window room still grantable: window - inflight - remote_granted,
    // or -1 for an unlimited pool (window == 0)
    inline int64_t headroom_of(int h) {
        if (h < 0) return 0;
        Pool &p = pools[h];
        if (p.window <= 0) return -1;
        int64_t room = p.window - charge_of(p);
        return room > 0 ? room : 0;
    }

    // mid-run QoS nudge: the reconciliation loop's capsule
    // entry. Weight binds at the NEXT DRR round top-up; the in-flight
    // deficit is untouched (advisory fairness state, like register's)
    void set_weight(int h, int32_t w) {
        if (h < 0 || h >= MAX_POOLS) return;
        pools[h].weight.store(w > 0 ? w : 1, std::memory_order_relaxed);
        weight_adjusts.fetch_add(1, std::memory_order_relaxed);
    }

    // ----------------------------------------------------------------- push
    // Push n ready items for pool h. `worker` >= 0 routes through that
    // worker's hot queue (overflow spills to the pool, counted); heap
    // pools and anonymous producers (worker < 0: the comm ingest thread,
    // Python harnesses) go straight to the pool's cold structure.
    // Returns true when the pool is over its admission window (the soft
    // backpressure signal — purely advisory, the push always lands).
    bool push(int h, int worker, const int32_t *tids, const int32_t *prios,
              int n) {
        if (h < 0 || n <= 0) return false;
        Pool &p = pools[h];
        pthist::State<1> *hs = hist_armed();
        int64_t now = hs ? ptrace_ring::now_ns() : 0;
        bool to_heap = p.heap;
        if (!to_heap && prios) {
            for (int i = 0; i < n; i++)
                if (prios[i] != 0) { to_heap = true; break; }
            if (to_heap) {
                // first prioritized push: migrate the pool to heap order
                std::lock_guard<std::mutex> pl(p.mu);
                if (!p.heap) {
                    std::make_heap(p.overflow.begin(), p.overflow.end(),
                                   ItemPrioLess{});
                    p.heap = true;
                }
            }
        }
        int taken = 0;
        bool tried_hot = false;
        if (!to_heap && worker >= 0 && worker < nworkers) {
            tried_hot = true;
            HotQ &q = hot[worker];
            std::lock_guard<std::mutex> hl(q.mu);
            int room = HOTQ_CAP - (int)q.buf.size();
            taken = room < n ? (room > 0 ? room : 0) : n;
            for (int i = 0; i < taken; i++)
                q.buf.push_back(Item{
                    tids[i], h, prios ? prios[i] : 0, 0,
                    (now && queue_sampled(tids[i])) ? now : 0});
        }
        if (taken < n) {
            std::lock_guard<std::mutex> pl(p.mu);
            for (int i = taken; i < n; i++) {
                p.overflow.push_back(Item{
                    tids[i], h, prios ? prios[i] : 0, 0,
                    (now && queue_sampled(tids[i])) ? now : 0});
                if (p.heap)
                    std::push_heap(p.overflow.begin(), p.overflow.end(),
                                   ItemPrioLess{});
            }
            if (tried_hot) { // a hot-queue push that spilled — including
                             // the fully-saturated case (taken == 0),
                             // exactly the regime the counter signals
                p.spills.fetch_add(n - taken, std::memory_order_relaxed);
                spills_total.fetch_add(n - taken,
                                       std::memory_order_relaxed);
            }
        }
        p.queued.fetch_add(n, std::memory_order_relaxed);
        return p.window > 0 &&
               p.inflight.load(std::memory_order_relaxed) > p.window;
    }

    // ------------------------------------------------------------ pop
    // Pop up to cap items for `worker`: own hot queue first (hot end),
    // then pool overflow (DRR across pools for kind-filtered pops, the
    // named pool for pool-filtered ones), then steal-half from victims'
    // cold ends. `pool_filter` >= 0 restricts to one pool (the ptexec
    // graph's view); otherwise `kind` restricts to that engine's pools.
    int pop(int worker, int kind, int pool_filter, Item *out, int cap) {
        if (cap <= 0) return 0;
        int n = 0;
        int w = (worker >= 0 && worker < nworkers) ? worker : 0;
        // 1. own hot queue, hot end first: the matching tail comes off as
        // ONE block (the single-pool common case never pays per-item
        // erases); deeper non-contiguous matches take the slow scan
        {
            HotQ &q = hot[w];
            std::lock_guard<std::mutex> hl(q.mu);
            std::vector<Item> &b = q.buf;
            size_t sz = b.size();
            size_t take = 0;
            while (take < sz && n + (int)take < cap &&
                   match(b[sz - 1 - take], kind, pool_filter))
                take++;
            for (size_t t = 0; t < take; t++) out[n++] = b[sz - 1 - t];
            b.resize(sz - take);
            if (n < cap && !b.empty()) {
                for (size_t i = b.size(); i-- > 0 && n < cap;) {
                    if (!match(b[i], kind, pool_filter)) continue;
                    out[n++] = b[i];
                    b.erase(b.begin() + (ptrdiff_t)i);
                }
            }
        }
        // 2. pool overflow refill
        if (n < cap) {
            if (pool_filter >= 0)
                n += take_overflow(pools[pool_filter], pool_filter,
                                   out + n, cap - n);
            else if (n == 0)
                n += refill_drr(kind, out, cap);
        }
        // 3. steal from peers' cold ends
        if (n == 0 && nworkers > 1)
            n = steal(w, kind, pool_filter, out, cap);
        if (n) account_pops(out, n);
        return n;
    }

    // Specialized single-pool pop (the ptexec lane's view): emits RAW
    // task ids straight into the caller's buffer — no Item copies, no
    // second extraction pass, accounting batched to 2 atomics per call.
    // This is the other half of the single-pool <2% overhead contract:
    // the plane-bound chain walk pays (bulk tail take + one push) per
    // ~256 tasks, the same order of work as the private vector did.
    int pop_pool(int h, int worker, int32_t *tids, int cap) {
        if (cap <= 0 || h < 0) return 0;
        Pool &p = pools[h];
        pthist::State<1> *hs = hist_armed();
        int64_t now = hs ? ptrace_ring::now_ns() : 0;
        int n = 0;
        int w = (worker >= 0 && worker < nworkers) ? worker : 0;
        {
            HotQ &q = hot[w];
            std::lock_guard<std::mutex> hl(q.mu);
            std::vector<Item> &b = q.buf;
            size_t sz = b.size();
            size_t take = 0;
            while (take < sz && (int)take < cap &&
                   b[sz - 1 - take].pool == h)
                take++;
            for (size_t t = 0; t < take; t++) {
                const Item &it = b[sz - 1 - t];
                if (now && it.t_push > 0) hs->h[0].add(now - it.t_push);
                tids[n++] = it.tid;
            }
            b.resize(sz - take);
            if (n < cap && !b.empty()) {
                for (size_t i = b.size(); i-- > 0 && n < cap;) {
                    if (b[i].pool != h) continue;
                    if (now && b[i].t_push > 0)
                        hs->h[0].add(now - b[i].t_push);
                    tids[n++] = b[i].tid;
                    b.erase(b.begin() + (ptrdiff_t)i);
                }
            }
        }
        if (n < cap) {
            std::lock_guard<std::mutex> pl(p.mu);
            while (n < cap && !p.overflow.empty()) {
                if (p.heap)
                    std::pop_heap(p.overflow.begin(), p.overflow.end(),
                                  ItemPrioLess{});
                else if (policy == POLICY_FIFO) {
                    const Item &it = p.overflow.front();
                    if (now && it.t_push > 0)
                        hs->h[0].add(now - it.t_push);
                    tids[n++] = it.tid;
                    p.overflow.erase(p.overflow.begin());
                    continue;
                }
                const Item &it = p.overflow.back();
                if (now && it.t_push > 0) hs->h[0].add(now - it.t_push);
                tids[n++] = it.tid;
                p.overflow.pop_back();
            }
        }
        if (n == 0 && nworkers > 1) {
            Item loot[HOTQ_CAP];
            int got = steal(w, KIND_ANY, h, loot,
                            cap < HOTQ_CAP ? cap : HOTQ_CAP);
            for (int i = 0; i < got; i++) {
                if (now && loot[i].t_push > 0)
                    hs->h[0].add(now - loot[i].t_push);
                tids[n++] = loot[i].tid;
            }
        }
        if (n) {
            p.queued.fetch_sub(n, std::memory_order_relaxed);
            p.served.fetch_add(n, std::memory_order_relaxed);
            served_total.fetch_add(n, std::memory_order_relaxed);
        }
        return n;
    }

    // ----------------------------------------------------- DRR arbitration
    // Pick the next pool of `kind` holding queued work, topping up its
    // deficit (weight * quantum per visit); *quantum_out receives the
    // credits the caller may spend before charge()-ing back. -1 = no
    // queued pool. The cursor advances every call, so every queued pool
    // is visited within one cycle — the starvation bound.
    int next_pool(int kind, int64_t *quantum_out) {
        int k = kind_slot(kind);
        std::lock_guard<std::mutex> al(arb_mu);
        int start = cursor[k];
        for (int step = 0; step < MAX_POOLS; step++) {
            int i = (start + step) % MAX_POOLS;
            Pool &p = pools[i];
            if (!p.live || (kind != KIND_ANY && p.kind != kind)) continue;
            if (p.queued.load(std::memory_order_relaxed) <= 0) {
                p.deficit = 0;    // an empty pool carries no credit over
                continue;
            }
            cursor[k] = (i + 1) % MAX_POOLS;
            p.deficit += (int64_t)p.weight.load(std::memory_order_relaxed) *
                         quantum;
            if (quantum_out) *quantum_out = p.deficit;
            return i;
        }
        return -1;
    }

    void charge(int h, int64_t n) {
        if (h < 0 || h >= MAX_POOLS) return;
        std::lock_guard<std::mutex> al(arb_mu);
        Pool &p = pools[h];
        p.deficit -= n;
        if (p.deficit < 0 ||
            p.queued.load(std::memory_order_relaxed) <= 0)
            p.deficit = 0;
    }

    int64_t deficit_of(int h) {
        if (h < 0 || h >= MAX_POOLS) return 0;
        std::lock_guard<std::mutex> al(arb_mu);
        return pools[h].deficit;
    }

    // ------------------------------------------------------------- queries
    inline int64_t queued_of(int h) {
        return h < 0 ? 0 : pools[h].queued.load(std::memory_order_relaxed);
    }
    int64_t queued_kind(int kind) {
        int64_t total = 0;
        for (int i = 0; i < MAX_POOLS; i++) {
            Pool &p = pools[i];
            if (!p.live || (kind != KIND_ANY && p.kind != kind)) continue;
            total += p.queued.load(std::memory_order_relaxed);
        }
        return total;
    }

  private:
    static inline int kind_slot(int kind) {
        return kind == KIND_PTEXEC ? 0 : (kind == KIND_PTDTD ? 1 : 2);
    }
    inline bool match(const Item &it, int kind, int pool_filter) const {
        if (pool_filter >= 0) return it.pool == pool_filter;
        if (kind == KIND_ANY) return true;
        return pools[it.pool].kind == kind && pools[it.pool].live;
    }

    // take up to cap items from one pool's overflow (heap top; LIFO back;
    // or the FRONT under FIFO policy — oldest-first, batch-amortized)
    int take_overflow(Pool &p, int h, Item *out, int cap) {
        (void)h;
        std::lock_guard<std::mutex> pl(p.mu);
        int n = 0;
        if (policy == POLICY_FIFO && !p.heap) {
            int k = (int)p.overflow.size() < cap ? (int)p.overflow.size()
                                                 : cap;
            for (; n < k; n++) out[n] = p.overflow[(size_t)n];
            p.overflow.erase(p.overflow.begin(),
                             p.overflow.begin() + (ptrdiff_t)n);
            return n;
        }
        while (n < cap && !p.overflow.empty()) {
            if (p.heap)
                std::pop_heap(p.overflow.begin(), p.overflow.end(),
                              ItemPrioLess{});
            out[n++] = p.overflow.back();
            p.overflow.pop_back();
        }
        return n;
    }

    // mixed refill honoring the policy: WDRR spends deficits, FIFO/RND
    // round-robin with unit weight, PRIO serves the best top priority.
    // WDRR is CLASSIC deficit-round-robin across pop calls: the cursor
    // STAYS on a pool until its per-round credit (weight * quantum) is
    // spent or its queue drains — a weight-2 pool is served ~2x a
    // weight-1 pool even though each pop call fills from one pool
    // (advancing every call would degrade to unweighted alternation).
    int refill_drr(int kind, Item *out, int cap) {
        if (policy == POLICY_PRIO) return refill_prio(kind, out, cap);
        const bool wdrr = policy == POLICY_WDRR;
        int k = kind_slot(kind);
        int n = 0;
        std::unique_lock<std::mutex> al(arb_mu);
        if (policy == POLICY_RNDSTEAL)
            cursor[k] = (int)(xrand() % MAX_POOLS);
        int i = cursor[k] % MAX_POOLS;
        for (int step = 0; step < MAX_POOLS && n < cap;) {
            Pool &p = pools[i];
            if (!p.live || (kind != KIND_ANY && p.kind != kind) ||
                p.queued.load(std::memory_order_relaxed) <= 0) {
                if (p.live) p.deficit = 0;   // no credit carries while idle
                i = (i + 1) % MAX_POOLS;
                step++;
                continue;
            }
            if (wdrr && p.deficit <= 0)      // round top-up, once per visit
                p.deficit +=
                    (int64_t)p.weight.load(std::memory_order_relaxed) *
                    quantum;
            int64_t credit = wdrr ? p.deficit : quantum;
            int want = (int)((int64_t)(cap - n) < credit
                                 ? (int64_t)(cap - n) : credit);
            int got = take_overflow(p, i, out + n, want);
            n += got;
            if (wdrr) {
                p.deficit -= got;
                if (got < want) p.deficit = 0;   // overflow drained
            }
            if (wdrr && p.deficit > 0 && got == want && n >= cap)
                break;                       // credit left: STAY for the
                                             // next pop call
            i = (i + 1) % MAX_POOLS;
            step++;
        }
        cursor[k] = i;
        return n;
    }

    int refill_prio(int kind, Item *out, int cap) {
        // serve the pool whose top priority is best (ties by slot
        // order), re-picking until the batch fills or every pool drains
        int n = 0;
        while (n < cap) {
            int best = -1;
            int32_t best_prio = 0;
            for (int i = 0; i < MAX_POOLS; i++) {
                Pool &p = pools[i];
                if (!p.live || (kind != KIND_ANY && p.kind != kind))
                    continue;
                if (p.queued.load(std::memory_order_relaxed) <= 0) continue;
                std::lock_guard<std::mutex> pl(p.mu);
                if (p.overflow.empty()) continue;
                int32_t top = p.heap ? p.overflow.front().prio
                                     : p.overflow.back().prio;
                if (best < 0 || top > best_prio) {
                    best = i;
                    best_prio = top;
                }
            }
            if (best < 0) break;
            int got = take_overflow(pools[best], best, out + n, cap - n);
            if (!got) break;
            n += got;
        }
        return n;
    }

    // steal-half from victims' cold ends; try_lock only (a busy victim is
    // skipped); surplus beyond cap lands in the thief's own hot queue
    int steal(int thief, int kind, int pool_filter, Item *out, int cap) {
        std::vector<Item> loot;
        uint32_t start = (policy == POLICY_RNDSTEAL)
                             ? xrand() % (uint32_t)nworkers
                             : (uint32_t)(thief + 1);
        for (int d = 0; d < nworkers && loot.empty(); d++) {
            int v = (int)((start + (uint32_t)d) % (uint32_t)nworkers);
            if (v == thief) continue;
            HotQ &q = hot[v];
            if (!q.mu.try_lock()) continue;
            steal_visits.fetch_add(1, std::memory_order_relaxed);
            std::vector<Item> &b = q.buf;
            int nmatch = 0;
            for (const Item &it : b)
                if (match(it, kind, pool_filter)) nmatch++;
            int want = (nmatch + 1) / 2;    // steal-half, at least 1
            size_t o = 0;
            for (size_t i = 0; i < b.size(); i++) {
                // cold end = front: the first `want` matches are carried off
                if ((int)loot.size() < want &&
                    match(b[i], kind, pool_filter)) {
                    loot.push_back(b[i]);
                } else {
                    b[o++] = b[i];
                }
            }
            b.resize(o);
            q.mu.unlock();
        }
        if (loot.empty()) return 0;
        steals[thief].fetch_add((int64_t)loot.size(),
                                std::memory_order_relaxed);
        int n = (int)loot.size() < cap ? (int)loot.size() : cap;
        for (int i = 0; i < n; i++) out[i] = loot[(size_t)i];
        if ((int)loot.size() > n) {
            std::lock_guard<std::mutex> hl(hot[thief].mu);
            for (size_t i = (size_t)n; i < loot.size(); i++)
                hot[thief].buf.push_back(loot[i]);
        }
        return n;
    }

    void account_pops(const Item *out, int n) {
        pthist::State<1> *hs = hist_armed();
        int64_t now = hs ? ptrace_ring::now_ns() : 0;
        // same-pool runs account with ONE pair of atomics (a batch is
        // almost always one pool): 2 RMWs per ~256 tasks, not per task —
        // the single-pool fast path's half of the <2% overhead contract
        int i = 0;
        while (i < n) {
            int j = i;
            const int32_t p = out[i].pool;
            while (j < n && out[j].pool == p) {
                if (now && out[j].t_push > 0)
                    hs->h[0].add(now - out[j].t_push);
                j++;
            }
            pools[p].queued.fetch_sub(j - i, std::memory_order_relaxed);
            pools[p].served.fetch_add(j - i, std::memory_order_relaxed);
            served_total.fetch_add(j - i, std::memory_order_relaxed);
            i = j;
        }
    }
};

// resolve + abi-check a plane capsule; sets a Python error on failure
inline Plane *plane_from_capsule(PyObject *cap) {
    Plane *pl = static_cast<Plane *>(
        PyCapsule_GetPointer(cap, PTSCHED_PLANE_CAPSULE));
    if (!pl) return nullptr;
    if (pl->abi != ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptsched ABI mismatch");
        return nullptr;
    }
    return pl;
}

}  // namespace ptsched

#endif  // PARSEC_TPU_PTSCHED_H
