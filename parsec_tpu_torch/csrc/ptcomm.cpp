// parsec_tpu_torch._ptcomm — the native communication lane (L3 in C).
//
// Stands where the reference's funneled MPI backend stands
// (parsec/remote_dep_mpi.c + parsec_comm_engine.h): ONE progress thread
// owns every wire — it multiplexes the cross-process mesh (TCP sockets
// handed over as fds, plus a same-host shared-memory ring short-circuit
// for co-located ranks), speaks a fixed binary active-message protocol
// (tagged activation / eager-data / rendezvous GET-request / GET-reply
// frames — no pickle on the hot path), and drains incoming activations
// STRAIGHT into the native engines' ready structures through the
// PtCommIngestVtbl (ptcomm_iface.h) without ever taking the GIL. A
// remote dep-release therefore costs the same as a local one: an atomic
// decrement plus a ready-push on the consumer rank.
//
// Outbound, the engines' GIL-free release sweeps enqueue activations
// onto a lock-free MPSC send queue (Treiber push + consumer-side
// reversal keeps per-producer FIFO order); Python enqueues data payloads
// the same way (eager payloads are copied into the frame at enqueue
// under the GIL, large ones register a Py_buffer and travel
// receiver-pulled: RDV -> GETREQ -> GETREP). Frame order per peer link is
// FIFO, which the data protocol relies on: a producer's eager DATA frame
// always precedes the ACT frames of the tasks consuming it, so eager
// payloads never need gating; rendezvous payloads gate consumer
// readiness inside the engine (rdv_begin/rdv_land) because the pull
// completes after the activation arrives.
//
// Threading/GIL contract:
//   * Python-called methods (register/send_payload/take_payload/reap/...)
//     hold the GIL and only touch mutex-guarded maps + the send queue.
//   * the progress thread NEVER touches Python objects except reading
//     pinned Py_buffer memory (legal without the GIL); releasing those
//     buffers is deferred to reap(), called under the GIL from the
//     runtime's drain hooks.
//   * peers are registered before start() and immutable afterwards.
//
// Malformed input from the wire (truncated frames, oversized lengths,
// unknown kinds, bad ids) is COUNTED and contained — an unknown kind is
// skipped by length, an untrusted length marks the one peer link broken
// — the progress thread itself never dies and never hangs.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "ptcomm_iface.h"
#include "pthist.h"
#include "ptrace_ring.h"

namespace {

// in-lane trace keys (the Python trace bridge registers the matching
// "ptcomm::*" PBP keywords)
constexpr uint32_t EV_COMM_ACT_TX = 1;   // POINT, id = tids in the frame
constexpr uint32_t EV_COMM_ACT_RX = 2;   // POINT, id = tids ingested
constexpr uint32_t EV_COMM_DATA_TX = 3;  // POINT, id = payload bytes
constexpr uint32_t EV_COMM_DATA_RX = 4;  // POINT, id = payload bytes
constexpr uint32_t EV_COMM_RDV = 5;      // POINT, id = handle (GET issued)
constexpr uint32_t EV_COMM_REP = 6;      // POINT, id = payload bytes served
// cross-rank flow identity: every K_ACTS frame carries a
// per-link sequence number in hdr.aux; both ends record a POINT whose id
// encodes (peer_rank << 40) | seq, so the offline multi-rank trace merge
// (tools/trace_reader.merge_traces) can pair each send with the peer's
// ingest and draw one causal flow arrow per cross-rank activation frame
constexpr uint32_t EV_COMM_FRAME_TX = 7;
constexpr uint32_t EV_COMM_FRAME_RX = 8;
// serving-fabric credit flow: one POINT per K_CRED frame on
// each end, id = credit count (grants positive, returns negative), so
// merged Perfetto timelines pair admission-control traffic with the
// ACT/DATA frames it gates
constexpr uint32_t EV_FAB_CRED_TX = 9;
constexpr uint32_t EV_FAB_CRED_RX = 10;
constexpr uint64_t FRAME_SEQ_MASK = (1ull << 40) - 1;

inline int64_t frame_flow_id(int peer, uint64_t seq) {
    return (int64_t)(((uint64_t)peer << 40) | (seq & FRAME_SEQ_MASK));
}

// latency histogram slots (pthist.h; names mirrored by the histogram reader)
constexpr int H_RDV = 0;      // rendezvous GETREQ -> GETREP round trip
constexpr int H_QUEUE = 1;    // activation enqueue -> wire (send-queue lag)
constexpr int N_HISTS = 2;
const char *const HIST_NAMES[N_HISTS] = {"rdv_rtt_ns", "act_queue_ns"};

constexpr uint64_t HELLO_MAGIC = 0x7074636f6d6d0001ull;  // "ptcomm" v1
constexpr uint32_t SHM_MAGIC = 0x50434d52;               // "PCMR"
constexpr uint32_t MAX_BODY = 1u << 26;                  // 64 MiB sanity cap

// wire kinds
constexpr uint8_t K_HELLO = 1;
constexpr uint8_t K_ACTS = 2;    // body = int32 tids[]
constexpr uint8_t K_DATA = 3;    // body = u32 meta_len + meta + payload
constexpr uint8_t K_RDV = 4;     // body = meta; aux = sender handle
constexpr uint8_t K_GETREQ = 5;  // aux = handle (pool/arg echoed)
constexpr uint8_t K_GETREP = 6;  // body = payload; aux = handle
constexpr uint8_t K_BYE = 7;
constexpr uint8_t K_CRED = 8;    // admission credits; layout/flags in
                                 // ptcomm_iface.h (serving fabric)
// queue-internal only (batched into K_ACTS at drain):
constexpr uint8_t K_ACT_ONE = 100;

struct WireHdr {
    uint32_t body_len;
    uint8_t kind;
    uint8_t flags;
    uint16_t src;
    uint32_t pool;
    uint32_t arg;
    uint64_t aux;
};
static_assert(sizeof(WireHdr) == 24, "wire header must be 24 bytes");

// shared-memory ring layout (created+zeroed by the Python side):
//   [0]   u32 magic, u32 cap
//   [64]  u64 head (producer cursor, bytes written)
//   [128] u64 tail (consumer cursor, bytes read)
//   [192] data[cap]
constexpr size_t SHM_HEAD_OFF = 64;
constexpr size_t SHM_TAIL_OFF = 128;
constexpr size_t SHM_DATA_OFF = 192;

struct ShmView {
    uint8_t *base = nullptr;
    size_t map_len = 0;
    std::atomic<uint64_t> *head = nullptr;
    std::atomic<uint64_t> *tail = nullptr;
    uint8_t *data = nullptr;
    uint64_t cap = 0;
};

struct Peer {
    int rank = -1;
    int fd = -1;  // >= 0: TCP transport
    bool is_shm = false;
    ShmView tx, rx;
    std::string inbuf;
    size_t in_off = 0;
    std::string outbuf;
    size_t out_off = 0;
    bool hello_seen = false;
    bool hello_sent = false;
    bool bye = false;
    bool broken = false;
};

struct SendOp {
    SendOp *next = nullptr;
    int32_t dst = 0;
    uint8_t kind = 0;
    uint8_t flags = 0;         // K_CRED: PTCOMM_CRED_GRANT / _RETURN
    uint32_t pool = 0, arg = 0;
    uint64_t aux = 0;
    int64_t t_enq = 0;         // enqueue stamp (act_queue_ns histogram)
    std::string meta;
    std::string inl;           // eager payload / inline body
    uint64_t rdv_handle = 0;   // K_GETREP: body streams from registration
};

struct PoolReg {
    PyObject *obj = nullptr;  // strong ref (taken under the GIL)
    PtCommIngestVtbl v{};
};

struct EarlyFrame {
    WireHdr h;
    std::string body;
};

struct PayloadEntry {
    std::string meta;
    std::string data;
    bool complete = false;
    uint16_t src = 0;
    uint64_t handle = 0;
    int64_t t_req = 0;   // rendezvous pull-issued stamp (rdv_rtt_ns)
};

struct RdvReg {
    Py_buffer buf{};
};

struct Comm {
    PyObject_HEAD
    int my_rank;
    int nb_ranks;
    std::vector<Peer *> *peers;  // index = rank (nullptr for self/absent)
    std::thread *thread;
    std::atomic<bool> running;
    std::atomic<bool> parked;
    int wake_pipe[2];

    std::atomic<SendOp *> sq;  // MPSC Treiber stack

    std::mutex *pools_mu;
    std::unordered_map<uint32_t, PoolReg> *pools;
    std::unordered_map<uint32_t, std::vector<EarlyFrame>> *early;
    // pools already unregistered: their straggler frames DROP (counted),
    // they must not re-park in `early` for a registration that never comes
    std::unordered_set<uint32_t> *retired;

    std::mutex *pay_mu;
    std::unordered_map<uint64_t, PayloadEntry> *payloads;

    std::mutex *rdv_mu;
    std::unordered_map<uint64_t, RdvReg *> *rdv;
    std::vector<RdvReg *> *rdv_release;  // reaped under the GIL
    uint64_t next_handle;

    // serving-fabric credit ledgers, keyed (pool << 32 |
    // tenant) per peer rank. `cred_avail[r]`: credits THIS rank may
    // spend toward rank r (inserter side; cred_take debits locally —
    // the zero-round-trip hot path). `cred_out[r]`: credits this rank
    // GRANTED to rank r and not yet returned/reclaimed (target side;
    // the pool's admission headroom reserves them). Both touched under
    // cred_mu by Python calls AND the progress thread's K_CRED dispatch.
    std::mutex *cred_mu;
    std::vector<std::unordered_map<uint64_t, int64_t>> *cred_avail;
    std::vector<std::unordered_map<uint64_t, int64_t>> *cred_out;

    // stats (relaxed atomics, sampled by stats())
    std::atomic<int64_t> acts_tx, acts_rx, act_frames_tx, act_frames_rx;
    std::atomic<int64_t> data_tx, data_rx, rdv_tx, rdv_rx;
    std::atomic<int64_t> getreq_rx, getrep_rx;
    std::atomic<int64_t> bytes_tx, bytes_rx;
    std::atomic<int64_t> frame_errors, early_parked, dropped_sends;
    std::atomic<int64_t> late_frames;   // frames for retired pools, dropped
    std::atomic<int64_t> creds_granted_tx, creds_granted_rx;
    std::atomic<int64_t> creds_spent, creds_reclaimed;
    std::atomic<int64_t> creds_returned_tx, creds_returned_rx;
    std::atomic<int64_t> cred_frames_tx, cred_frames_rx;
    std::atomic<int64_t> wakeups, loops;
    std::atomic<int64_t> out_pending;  // bytes queued but not yet on a wire

    std::atomic<ptrace_ring::State *> trace;
    std::atomic<pthist::State<N_HISTS> *> hist;
    // per-destination K_ACTS frame sequence (flow pairing); touched only
    // by the frame-building side (progress thread or pump), no atomics
    std::vector<uint64_t> *act_seq;
};

inline pthist::State<N_HISTS> *hist_of(Comm *self) {
    pthist::State<N_HISTS> *hs = self->hist.load(std::memory_order_acquire);
    if (hs && !hs->enabled.load(std::memory_order_relaxed)) hs = nullptr;
    return hs;
}

// ---------------------------------------------------------------- helpers

uint64_t pay_key(uint32_t pool, uint32_t slot) {
    return ((uint64_t)pool << 32) | slot;
}

uint64_t cred_key(uint32_t pool, uint32_t tenant) {
    return ((uint64_t)pool << 32) | tenant;
}

void sq_push(Comm *self, SendOp *op) {
    SendOp *h = self->sq.load(std::memory_order_relaxed);
    do {
        op->next = h;
    } while (!self->sq.compare_exchange_weak(h, op, std::memory_order_release,
                                             std::memory_order_relaxed));
    if (self->parked.load(std::memory_order_acquire)) {
        char c = 1;
        ssize_t r = write(self->wake_pipe[1], &c, 1);
        (void)r;  // pipe full == already waking
        self->wakeups.fetch_add(1, std::memory_order_relaxed);
    }
}

// the C entry the engines call from their GIL-free release sweeps
extern "C" void comm_send_act_c(void *comm, int32_t dst, uint32_t pool,
                                int32_t tid) {
    Comm *self = static_cast<Comm *>(comm);
    if (dst < 0 || dst >= self->nb_ranks || dst == self->my_rank ||
        !(*self->peers)[(size_t)dst]) {
        self->dropped_sends.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    SendOp *op = new (std::nothrow) SendOp();
    if (!op) {
        self->dropped_sends.fetch_add(1, std::memory_order_relaxed);
        return;
    }
    op->dst = dst;
    op->kind = K_ACT_ONE;
    op->pool = pool;
    op->arg = (uint32_t)tid;
    if (hist_of(self)) op->t_enq = ptrace_ring::now_ns();
    sq_push(self, op);
}

void put_frame(Comm *self, Peer *p, uint8_t kind, uint32_t pool,
               uint32_t arg, uint64_t aux, const void *b1, size_t l1,
               const void *b2 = nullptr, size_t l2 = 0,
               uint8_t flags = 0) {
    WireHdr h;
    h.body_len = (uint32_t)(l1 + l2);
    h.kind = kind;
    h.flags = flags;
    h.src = (uint16_t)self->my_rank;
    h.pool = pool;
    h.arg = arg;
    h.aux = aux;
    p->outbuf.append(reinterpret_cast<const char *>(&h), sizeof(h));
    if (l1) p->outbuf.append(static_cast<const char *>(b1), l1);
    if (l2) p->outbuf.append(static_cast<const char *>(b2), l2);
    self->out_pending.fetch_add((int64_t)(sizeof(h) + l1 + l2),
                                std::memory_order_relaxed);
}

// ----------------------------------------------------------- progress: tx

int drain_sendq(Comm *self, ptrace_ring::Writer &tw) {
    SendOp *head = self->sq.exchange(nullptr, std::memory_order_acquire);
    if (!head) return 0;
    // the sq exchange (acquire) pairs with the enqueuer's release push:
    // a trace/hist enable sequenced before that push is visible NOW even
    // if the loop-top open ran before the enable landed — re-check here
    // so the first frames after an attach are never silently unrecorded
    if (!tw.st) tw.open(self->trace.load(std::memory_order_acquire));
    pthist::State<N_HISTS> *hs = hist_of(self);
    // reverse the Treiber stack: per-producer FIFO order restored
    SendOp *rev = nullptr;
    while (head) {
        SendOp *nx = head->next;
        head->next = rev;
        rev = head;
        head = nx;
    }
    int n = 0;
    while (rev) {
        SendOp *op = rev;
        Peer *p = (op->dst >= 0 && op->dst < self->nb_ranks)
                      ? (*self->peers)[(size_t)op->dst]
                      : nullptr;
        if (!p || p->broken) {
            if (op->kind == K_GETREP && op->rdv_handle) {
                // the reply will never go out: release the pinned
                // Py_buffer (via reap) instead of leaking it — and
                // letting fini() spin on pins_pending forever
                std::lock_guard<std::mutex> lk(*self->rdv_mu);
                auto it = self->rdv->find(op->rdv_handle);
                if (it != self->rdv->end()) {
                    self->rdv_release->push_back(it->second);
                    self->rdv->erase(it);
                }
            }
            self->dropped_sends.fetch_add(1, std::memory_order_relaxed);
            rev = op->next;
            delete op;
            continue;
        }
        if (op->kind == K_ACT_ONE) {
            // coalesce consecutive activations for the same (dst, pool)
            // into one K_ACTS frame: 4 bytes per tid instead of a frame
            const int64_t h_now = hs ? ptrace_ring::now_ns() : 0;
            std::string ids;
            ids.append(reinterpret_cast<const char *>(&op->arg), 4);
            int32_t dst = op->dst;
            uint32_t pool = op->pool;
            if (h_now && op->t_enq > 0)
                hs->h[H_QUEUE].add(h_now - op->t_enq);
            SendOp *nx = op->next;
            delete op;
            while (nx && nx->kind == K_ACT_ONE && nx->dst == dst &&
                   nx->pool == pool) {
                ids.append(reinterpret_cast<const char *>(&nx->arg), 4);
                if (h_now && nx->t_enq > 0)
                    hs->h[H_QUEUE].add(h_now - nx->t_enq);
                SendOp *nn = nx->next;
                delete nx;
                nx = nn;
            }
            rev = nx;
            // per-link frame sequence rides hdr.aux so the receiver's
            // ingest pairs with this send in the merged timeline
            uint64_t seq = ++(*self->act_seq)[(size_t)dst];
            put_frame(self, p, K_ACTS, pool, 0, seq, ids.data(),
                      ids.size());
            int64_t cnt = (int64_t)(ids.size() / 4);
            self->acts_tx.fetch_add(cnt, std::memory_order_relaxed);
            self->act_frames_tx.fetch_add(1, std::memory_order_relaxed);
            if (tw.st) {
                tw.rec(EV_COMM_ACT_TX, cnt, ptrace_ring::FLAG_POINT);
                tw.rec(EV_COMM_FRAME_TX, frame_flow_id(dst, seq),
                       ptrace_ring::FLAG_POINT);
            }
            n++;
            continue;
        }
        rev = op->next;
        switch (op->kind) {
            case K_DATA: {
                uint32_t ml = (uint32_t)op->meta.size();
                std::string head4(reinterpret_cast<const char *>(&ml), 4);
                head4 += op->meta;
                put_frame(self, p, K_DATA, op->pool, op->arg, 0,
                          head4.data(), head4.size(), op->inl.data(),
                          op->inl.size());
                self->data_tx.fetch_add(1, std::memory_order_relaxed);
                if (tw.st)
                    tw.rec(EV_COMM_DATA_TX, (int64_t)op->inl.size(),
                           ptrace_ring::FLAG_POINT);
                break;
            }
            case K_RDV:
                put_frame(self, p, K_RDV, op->pool, op->arg, op->aux,
                          op->meta.data(), op->meta.size());
                self->rdv_tx.fetch_add(1, std::memory_order_relaxed);
                break;
            case K_GETREQ:
                put_frame(self, p, K_GETREQ, op->pool, op->arg, op->aux,
                          nullptr, 0);
                if (tw.st)
                    tw.rec(EV_COMM_RDV, (int64_t)op->aux,
                           ptrace_ring::FLAG_POINT);
                break;
            case K_GETREP: {
                // the payload streams straight out of the producer's
                // pinned Py_buffer — no GIL, no copy into the op
                RdvReg *reg = nullptr;
                {
                    std::lock_guard<std::mutex> lk(*self->rdv_mu);
                    auto it = self->rdv->find(op->rdv_handle);
                    if (it != self->rdv->end()) {
                        reg = it->second;
                        self->rdv->erase(it);
                    }
                }
                if (!reg) {
                    self->frame_errors.fetch_add(1,
                                                 std::memory_order_relaxed);
                    break;
                }
                put_frame(self, p, K_GETREP, op->pool, op->arg,
                          op->rdv_handle, reg->buf.buf,
                          (size_t)reg->buf.len);
                if (tw.st)
                    tw.rec(EV_COMM_REP, (int64_t)reg->buf.len,
                           ptrace_ring::FLAG_POINT);
                {
                    // the Py_buffer release needs the GIL: defer to reap()
                    std::lock_guard<std::mutex> lk(*self->rdv_mu);
                    self->rdv_release->push_back(reg);
                }
                break;
            }
            case K_CRED:
                put_frame(self, p, K_CRED, op->pool, op->arg, op->aux,
                          nullptr, 0, nullptr, 0, op->flags);
                self->cred_frames_tx.fetch_add(1, std::memory_order_relaxed);
                if (tw.st)
                    tw.rec(EV_FAB_CRED_TX,
                           op->flags == PTCOMM_CRED_RETURN
                               ? -(int64_t)op->aux : (int64_t)op->aux,
                           ptrace_ring::FLAG_POINT);
                break;
            case K_BYE:
                put_frame(self, p, K_BYE, 0, 0, 0, nullptr, 0);
                break;
            default:
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
        }
        delete op;
        n++;
    }
    return n;
}

int shm_write(ShmView &v, const char *buf, size_t len) {
    uint64_t head = v.head->load(std::memory_order_relaxed);
    uint64_t tail = v.tail->load(std::memory_order_acquire);
    uint64_t space = v.cap - (head - tail);
    if (space == 0) return 0;
    size_t w = len < space ? len : (size_t)space;
    size_t pos = (size_t)(head % v.cap);
    size_t first = (size_t)(v.cap - pos) < w ? (size_t)(v.cap - pos) : w;
    memcpy(v.data + pos, buf, first);
    if (w > first) memcpy(v.data, buf + first, w - first);
    v.head->store(head + w, std::memory_order_release);
    return (int)w;
}

int shm_read(ShmView &v, std::string &out) {
    uint64_t head = v.head->load(std::memory_order_acquire);
    uint64_t tail = v.tail->load(std::memory_order_relaxed);
    uint64_t avail = head - tail;
    if (avail == 0) return 0;
    size_t pos = (size_t)(tail % v.cap);
    size_t first =
        (size_t)(v.cap - pos) < avail ? (size_t)(v.cap - pos) : (size_t)avail;
    out.append(reinterpret_cast<const char *>(v.data + pos), first);
    if (avail > first)
        out.append(reinterpret_cast<const char *>(v.data),
                   (size_t)avail - first);
    v.tail->store(head, std::memory_order_release);
    return (int)avail;
}

int flush_peer(Comm *self, Peer *p) {
    if (p->broken) return 0;
    if (!p->hello_sent) {
        WireHdr h{0, K_HELLO, 0, (uint16_t)self->my_rank, 0, 0, HELLO_MAGIC};
        p->outbuf.insert(0, reinterpret_cast<const char *>(&h), sizeof(h));
        p->hello_sent = true;
        self->out_pending.fetch_add((int64_t)sizeof(h),
                                    std::memory_order_relaxed);
    }
    size_t avail = p->outbuf.size() - p->out_off;
    if (!avail) return 0;
    int n = 0;
    if (p->is_shm) {
        int w = shm_write(p->tx, p->outbuf.data() + p->out_off, avail);
        if (w > 0) {
            p->out_off += (size_t)w;
            self->bytes_tx.fetch_add(w, std::memory_order_relaxed);
            self->out_pending.fetch_sub(w, std::memory_order_relaxed);
            n = 1;
        }
    } else {
        while (avail) {
            ssize_t w = send(p->fd, p->outbuf.data() + p->out_off, avail,
                             MSG_NOSIGNAL);
            if (w > 0) {
                p->out_off += (size_t)w;
                avail -= (size_t)w;
                self->bytes_tx.fetch_add(w, std::memory_order_relaxed);
                self->out_pending.fetch_sub(w, std::memory_order_relaxed);
                n = 1;
                continue;
            }
            if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
            if (w < 0 && errno == EINTR) continue;
            p->broken = true;
            self->out_pending.fetch_sub(
                (int64_t)(p->outbuf.size() - p->out_off),
                std::memory_order_relaxed);
            break;
        }
    }
    if (p->out_off == p->outbuf.size()) {
        p->outbuf.clear();
        p->out_off = 0;
    } else if (p->out_off > (1u << 20)) {
        p->outbuf.erase(0, p->out_off);
        p->out_off = 0;
    }
    return n;
}

// ----------------------------------------------------------- progress: rx

void dispatch_frame(Comm *self, Peer *p, const WireHdr &h, const char *body,
                    ptrace_ring::Writer &tw);

void parse_frames(Comm *self, Peer *p, ptrace_ring::Writer &tw) {
    for (;;) {
        size_t avail = p->inbuf.size() - p->in_off;
        if (avail < sizeof(WireHdr)) break;
        WireHdr h;
        memcpy(&h, p->inbuf.data() + p->in_off, sizeof(h));
        if (!p->hello_seen) {
            if (h.kind != K_HELLO || h.aux != HELLO_MAGIC ||
                h.body_len != 0) {
                // wrong protocol/version on this link: poison it, never
                // guess at frame boundaries
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
                p->broken = true;
                return;
            }
            p->hello_seen = true;
            p->in_off += sizeof(WireHdr);
            continue;
        }
        if (h.body_len > MAX_BODY) {
            // an untrusted length would desync every later frame: the
            // link is unrecoverable, the process is not
            self->frame_errors.fetch_add(1, std::memory_order_relaxed);
            p->broken = true;
            return;
        }
        if (avail < sizeof(WireHdr) + h.body_len) break;  // partial: wait
        dispatch_frame(self, p, h, p->inbuf.data() + p->in_off + sizeof(h),
                       tw);
        p->in_off += sizeof(WireHdr) + h.body_len;
    }
    if (p->in_off > (1u << 20) || p->in_off == p->inbuf.size()) {
        p->inbuf.erase(0, p->in_off);
        p->in_off = 0;
    }
}

void dispatch_frame(Comm *self, Peer *p, const WireHdr &h, const char *body,
                    ptrace_ring::Writer &tw) {
    switch (h.kind) {
        case K_BYE:
            p->bye = true;
            return;
        case K_ACTS: {
            if (h.body_len % 4) {
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            int64_t cnt = h.body_len / 4;
            std::lock_guard<std::mutex> lk(*self->pools_mu);
            auto it = self->pools->find(h.pool);
            if (it == self->pools->end()) {
                if (self->retired->count(h.pool)) {
                    self->late_frames.fetch_add(1, std::memory_order_relaxed);
                    return;   // straggler for a finished pool: drop
                }
                (*self->early)[h.pool].push_back(
                    EarlyFrame{h, std::string(body, h.body_len)});
                self->early_parked.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            const PtCommIngestVtbl &v = it->second.v;
            for (uint32_t i = 0; i < h.body_len; i += 4) {
                int32_t tid;
                memcpy(&tid, body + i, 4);
                v.act(v.obj, tid);
            }
            self->acts_rx.fetch_add(cnt, std::memory_order_relaxed);
            self->act_frames_rx.fetch_add(1, std::memory_order_relaxed);
            if (tw.st) {
                tw.rec(EV_COMM_ACT_RX, cnt, ptrace_ring::FLAG_POINT);
                if (h.aux)
                    tw.rec(EV_COMM_FRAME_RX, frame_flow_id(h.src, h.aux),
                           ptrace_ring::FLAG_POINT);
            }
            return;
        }
        case K_DATA: {
            if (h.body_len < 4) {
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            uint32_t ml;
            memcpy(&ml, body, 4);
            if (4 + (uint64_t)ml > h.body_len) {
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            std::lock_guard<std::mutex> lk(*self->pools_mu);
            if (self->pools->find(h.pool) == self->pools->end()) {
                if (self->retired->count(h.pool)) {
                    self->late_frames.fetch_add(1, std::memory_order_relaxed);
                    return;
                }
                (*self->early)[h.pool].push_back(
                    EarlyFrame{h, std::string(body, h.body_len)});
                self->early_parked.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            {
                std::lock_guard<std::mutex> pl(*self->pay_mu);
                PayloadEntry &e = (*self->payloads)[pay_key(h.pool, h.arg)];
                e.meta.assign(body + 4, ml);
                e.data.assign(body + 4 + ml, h.body_len - 4 - ml);
                e.complete = true;
                e.src = h.src;
            }
            self->data_rx.fetch_add(1, std::memory_order_relaxed);
            if (tw.st)
                tw.rec(EV_COMM_DATA_RX, (int64_t)(h.body_len - 4 - ml),
                       ptrace_ring::FLAG_POINT);
            return;
        }
        case K_RDV: {
            std::lock_guard<std::mutex> lk(*self->pools_mu);
            auto it = self->pools->find(h.pool);
            if (it == self->pools->end()) {
                if (self->retired->count(h.pool)) {
                    self->late_frames.fetch_add(1, std::memory_order_relaxed);
                    return;
                }
                (*self->early)[h.pool].push_back(
                    EarlyFrame{h, std::string(body, h.body_len)});
                self->early_parked.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            {
                std::lock_guard<std::mutex> pl(*self->pay_mu);
                PayloadEntry &e = (*self->payloads)[pay_key(h.pool, h.arg)];
                e.meta.assign(body, h.body_len);
                e.complete = false;
                e.src = h.src;
                e.handle = h.aux;
                e.t_req = hist_of(self) ? ptrace_ring::now_ns() : 0;
            }
            const PtCommIngestVtbl &v = it->second.v;
            if (v.rdv_begin) v.rdv_begin(v.obj, (int32_t)h.arg);
            // pull: ask the producer to stream the payload
            SendOp *op = new (std::nothrow) SendOp();
            if (op) {
                op->dst = h.src;
                op->kind = K_GETREQ;
                op->pool = h.pool;
                op->arg = h.arg;
                op->aux = h.aux;
                sq_push(self, op);
            }
            self->rdv_rx.fetch_add(1, std::memory_order_relaxed);
            return;
        }
        case K_GETREQ: {
            SendOp *op = new (std::nothrow) SendOp();
            if (!op) return;
            op->dst = h.src;
            op->kind = K_GETREP;
            op->pool = h.pool;
            op->arg = h.arg;
            op->rdv_handle = h.aux;
            sq_push(self, op);
            self->getreq_rx.fetch_add(1, std::memory_order_relaxed);
            return;
        }
        case K_GETREP: {
            // pools_mu held across the rdv_land call: unregister_pool
            // DECREFs the engine only once no dispatch can be inside it
            std::lock_guard<std::mutex> lk(*self->pools_mu);
            auto it = self->pools->find(h.pool);
            if (it == self->pools->end()) {
                // the pool finished (or never registered): do not mint an
                // orphan payload entry nobody will ever take
                self->late_frames.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            {
                std::lock_guard<std::mutex> pl(*self->pay_mu);
                PayloadEntry &e = (*self->payloads)[pay_key(h.pool, h.arg)];
                e.data.assign(body, h.body_len);
                e.complete = true;
                pthist::State<N_HISTS> *hs = hist_of(self);
                if (hs && e.t_req > 0) {
                    // the wire round trip of the rendezvous pull
                    hs->h[H_RDV].add(ptrace_ring::now_ns() - e.t_req);
                    e.t_req = 0;
                }
            }
            if (it->second.v.rdv_land)
                it->second.v.rdv_land(it->second.v.obj, (int32_t)h.arg);
            self->getrep_rx.fetch_add(1, std::memory_order_relaxed);
            if (tw.st)
                tw.rec(EV_COMM_DATA_RX, (int64_t)h.body_len,
                       ptrace_ring::FLAG_POINT);
            return;
        }
        case K_CRED: {
            // admission credits are comm-level (they gate INSERTION, not
            // the engines), so no pool registration is consulted: the
            // ledgers update straight from the progress thread. h.src is
            // wire-supplied and indexes the per-rank ledger vectors, so
            // an out-of-range src is a malformed frame, not an index
            if (h.body_len != 0 || h.aux == 0 ||
                (int)h.src >= self->nb_ranks) {
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
                return;
            }
            int64_t n = (int64_t)h.aux;
            uint64_t key = cred_key(h.pool, h.arg);
            {
                std::lock_guard<std::mutex> lk(*self->cred_mu);
                if (h.flags == PTCOMM_CRED_RETURN) {
                    // an inserter handed unspent credits back: shrink the
                    // outstanding ledger (floor 0: a return racing a
                    // reclaim must not go negative)
                    int64_t &o = (*self->cred_out)[(size_t)h.src][key];
                    o = o > n ? o - n : 0;
                } else {
                    (*self->cred_avail)[(size_t)h.src][key] += n;
                }
            }
            if (h.flags == PTCOMM_CRED_RETURN)
                self->creds_returned_rx.fetch_add(n,
                                                  std::memory_order_relaxed);
            else
                self->creds_granted_rx.fetch_add(n,
                                                 std::memory_order_relaxed);
            self->cred_frames_rx.fetch_add(1, std::memory_order_relaxed);
            if (tw.st)
                tw.rec(EV_FAB_CRED_RX,
                       h.flags == PTCOMM_CRED_RETURN ? -n : n,
                       ptrace_ring::FLAG_POINT);
            return;
        }
        case K_HELLO:
            return;  // duplicate hello: harmless
        default:
            // unknown kind but trusted length: skip the body, count it —
            // a newer peer speaking an extended protocol must not kill us
            self->frame_errors.fetch_add(1, std::memory_order_relaxed);
            return;
    }
}

// replay frames that arrived before their pool registered (called from
// register_pool, GIL held; pools_mu held by the caller)
void replay_early_locked(Comm *self, uint32_t pool,
                         std::vector<EarlyFrame> &frames) {
    auto it = self->pools->find(pool);
    if (it == self->pools->end()) return;
    const PtCommIngestVtbl &v = it->second.v;
    // replays are the receiver's ingest for frames that raced the pool
    // registration: they must record the same flow points as the live
    // dispatch path, or the merged timeline would report unmatched sends
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    for (EarlyFrame &f : frames) {
        switch (f.h.kind) {
            case K_ACTS:
                for (uint32_t i = 0; i + 4 <= f.h.body_len; i += 4) {
                    int32_t tid;
                    memcpy(&tid, f.body.data() + i, 4);
                    v.act(v.obj, tid);
                }
                self->acts_rx.fetch_add(f.h.body_len / 4,
                                        std::memory_order_relaxed);
                self->act_frames_rx.fetch_add(1, std::memory_order_relaxed);
                if (tw.st) {
                    tw.rec(EV_COMM_ACT_RX, f.h.body_len / 4,
                           ptrace_ring::FLAG_POINT);
                    if (f.h.aux)
                        tw.rec(EV_COMM_FRAME_RX,
                               frame_flow_id(f.h.src, f.h.aux),
                               ptrace_ring::FLAG_POINT);
                }
                break;
            case K_DATA: {
                if (f.h.body_len < 4) break;
                uint32_t ml;
                memcpy(&ml, f.body.data(), 4);
                if (4 + (uint64_t)ml > f.h.body_len) break;
                std::lock_guard<std::mutex> pl(*self->pay_mu);
                PayloadEntry &e =
                    (*self->payloads)[pay_key(f.h.pool, f.h.arg)];
                e.meta.assign(f.body.data() + 4, ml);
                e.data.assign(f.body.data() + 4 + ml,
                              f.h.body_len - 4 - ml);
                e.complete = true;
                e.src = f.h.src;
                self->data_rx.fetch_add(1, std::memory_order_relaxed);
                break;
            }
            case K_RDV: {
                {
                    std::lock_guard<std::mutex> pl(*self->pay_mu);
                    PayloadEntry &e =
                        (*self->payloads)[pay_key(f.h.pool, f.h.arg)];
                    e.meta.assign(f.body.data(), f.h.body_len);
                    e.complete = false;
                    e.src = f.h.src;
                    e.handle = f.h.aux;
                    e.t_req = hist_of(self) ? ptrace_ring::now_ns() : 0;
                }
                if (v.rdv_begin) v.rdv_begin(v.obj, (int32_t)f.h.arg);
                SendOp *op = new (std::nothrow) SendOp();
                if (op) {
                    op->dst = f.h.src;
                    op->kind = K_GETREQ;
                    op->pool = f.h.pool;
                    op->arg = f.h.arg;
                    op->aux = f.h.aux;
                    sq_push(self, op);
                }
                self->rdv_rx.fetch_add(1, std::memory_order_relaxed);
                break;
            }
            default:
                self->frame_errors.fetch_add(1, std::memory_order_relaxed);
        }
    }
}

int pump_recv(Comm *self, ptrace_ring::Writer &tw) {
    // late-attach visibility: see the matching re-open in drain_sendq
    if (!tw.st) tw.open(self->trace.load(std::memory_order_acquire));
    int n = 0;
    char tmp[65536];
    for (Peer *p : *self->peers) {
        if (!p || p->broken || p->bye) continue;
        if (p->is_shm) {
            int r = shm_read(p->rx, p->inbuf);
            if (r > 0) {
                self->bytes_rx.fetch_add(r, std::memory_order_relaxed);
                n++;
            }
        } else {
            for (;;) {
                ssize_t r = recv(p->fd, tmp, sizeof(tmp), 0);
                if (r > 0) {
                    p->inbuf.append(tmp, (size_t)r);
                    self->bytes_rx.fetch_add(r, std::memory_order_relaxed);
                    n++;
                    if ((size_t)r < sizeof(tmp)) break;
                    continue;
                }
                if (r == 0) {
                    // EOF: a clean peer said BYE first; mid-frame EOF is a
                    // truncated stream (counted, link dropped)
                    if (!p->bye) {
                        if (p->inbuf.size() != p->in_off)
                            self->frame_errors.fetch_add(
                                1, std::memory_order_relaxed);
                        p->broken = true;
                    }
                    break;
                }
                if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                if (errno == EINTR) continue;
                if (!p->bye) p->broken = true;
                break;
            }
        }
        if (p->inbuf.size() - p->in_off >= sizeof(WireHdr))
            parse_frames(self, p, tw);
    }
    return n;
}

// ----------------------------------------------------------- thread main

void progress_main(Comm *self) {
    ptrace_ring::Writer tw;
    int idle = 0;
    std::vector<pollfd> pfds;
    while (self->running.load(std::memory_order_relaxed)) {
        if (!tw.st)
            tw.open(self->trace.load(std::memory_order_acquire));
        else if (tw.st && !tw.st->enabled.load(std::memory_order_relaxed)) {
            tw.close();
        }
        self->loops.fetch_add(1, std::memory_order_relaxed);
        int n = 0;
        n += drain_sendq(self, tw);
        bool fl = false;
        for (Peer *p : *self->peers)
            if (p) fl |= flush_peer(self, p) > 0;
        if (fl) n++;
        n += pump_recv(self, tw);
        if (n) {
            idle = 0;
            continue;
        }
        idle++;
        if (idle < 512) continue;  // pure spin: ~tens of µs of latency
        bool has_shm = false;
        for (Peer *p : *self->peers)
            if (p && p->is_shm && !p->broken && !p->bye) has_shm = true;
        if (has_shm && idle < 4096) {
            // shm traffic cannot rouse a poll(): stay in short naps for
            // a while (a mid-DAG lull is µs–ms scale) so ring latency
            // remains tens of µs, not a poll timeout
            usleep(20);
            continue;
        }
        // park: sockets + the wake pipe rouse us via poll; with shm
        // peers the timeout is the latency floor after a LONG idle
        // (~hundreds of ms of naps above), a wakeup-rate/latency tradeoff
        pfds.clear();
        pfds.push_back(pollfd{self->wake_pipe[0], POLLIN, 0});
        for (Peer *p : *self->peers) {
            if (!p || p->broken || p->bye) continue;
            if (!p->is_shm) pfds.push_back(pollfd{p->fd, POLLIN, 0});
        }
        self->parked.store(true, std::memory_order_release);
        int timeout_ms = has_shm ? 1 : (idle > 8192 ? 20 : 2);
        poll(pfds.data(), (nfds_t)pfds.size(), timeout_ms);
        self->parked.store(false, std::memory_order_release);
        if (pfds[0].revents & POLLIN) {
            char buf[64];
            while (read(self->wake_pipe[0], buf, sizeof(buf)) > 0) {
            }
        }
    }
    tw.close();
}

// ------------------------------------------------------------- Python API

PyObject *comm_new(PyTypeObject *type, PyObject *args, PyObject *) {
    int my_rank, nb_ranks;
    if (!PyArg_ParseTuple(args, "ii", &my_rank, &nb_ranks)) return nullptr;
    if (nb_ranks < 1 || my_rank < 0 || my_rank >= nb_ranks) {
        PyErr_SetString(PyExc_ValueError, "bad rank/nb_ranks");
        return nullptr;
    }
    Comm *self = reinterpret_cast<Comm *>(type->tp_alloc(type, 0));
    if (!self) return nullptr;
    self->my_rank = my_rank;
    self->nb_ranks = nb_ranks;
    self->peers = new (std::nothrow) std::vector<Peer *>((size_t)nb_ranks,
                                                         nullptr);
    self->thread = nullptr;
    new (&self->running) std::atomic<bool>(false);
    new (&self->parked) std::atomic<bool>(false);
    self->wake_pipe[0] = self->wake_pipe[1] = -1;
    new (&self->sq) std::atomic<SendOp *>(nullptr);
    self->pools_mu = new (std::nothrow) std::mutex();
    self->pools = new (std::nothrow) std::unordered_map<uint32_t, PoolReg>();
    self->early = new (std::nothrow)
        std::unordered_map<uint32_t, std::vector<EarlyFrame>>();
    self->retired = new (std::nothrow) std::unordered_set<uint32_t>();
    self->pay_mu = new (std::nothrow) std::mutex();
    self->payloads =
        new (std::nothrow) std::unordered_map<uint64_t, PayloadEntry>();
    self->rdv_mu = new (std::nothrow) std::mutex();
    self->rdv = new (std::nothrow) std::unordered_map<uint64_t, RdvReg *>();
    self->rdv_release = new (std::nothrow) std::vector<RdvReg *>();
    self->next_handle = 1;
    self->cred_mu = new (std::nothrow) std::mutex();
    self->cred_avail = new (std::nothrow)
        std::vector<std::unordered_map<uint64_t, int64_t>>(
            (size_t)nb_ranks);
    self->cred_out = new (std::nothrow)
        std::vector<std::unordered_map<uint64_t, int64_t>>(
            (size_t)nb_ranks);
    for (std::atomic<int64_t> *c :
         {&self->acts_tx, &self->acts_rx, &self->act_frames_tx,
          &self->act_frames_rx, &self->data_tx, &self->data_rx,
          &self->rdv_tx, &self->rdv_rx, &self->getreq_rx, &self->getrep_rx,
          &self->bytes_tx, &self->bytes_rx, &self->frame_errors,
          &self->early_parked, &self->dropped_sends,
          &self->creds_granted_tx, &self->creds_granted_rx,
          &self->creds_spent, &self->creds_reclaimed,
          &self->creds_returned_tx, &self->creds_returned_rx,
          &self->cred_frames_tx, &self->cred_frames_rx, &self->wakeups,
          &self->loops})
        new (c) std::atomic<int64_t>(0);
    new (&self->trace) std::atomic<ptrace_ring::State *>(nullptr);
    new (&self->hist) std::atomic<pthist::State<N_HISTS> *>(nullptr);
    self->act_seq = new (std::nothrow)
        std::vector<uint64_t>((size_t)nb_ranks, 0);
    if (!self->peers || !self->pools_mu || !self->pools || !self->early ||
        !self->retired || !self->pay_mu || !self->payloads ||
        !self->rdv_mu || !self->rdv || !self->rdv_release ||
        !self->cred_mu || !self->cred_avail || !self->cred_out ||
        !self->act_seq) {
        Py_DECREF(self);
        PyErr_NoMemory();
        return nullptr;
    }
    if (pipe(self->wake_pipe) == 0) {
        fcntl(self->wake_pipe[0], F_SETFL, O_NONBLOCK);
        fcntl(self->wake_pipe[1], F_SETFL, O_NONBLOCK);
    }
    return reinterpret_cast<PyObject *>(self);
}

void comm_stop_locked(Comm *self) {
    if (self->running.load(std::memory_order_relaxed)) {
        self->running.store(false, std::memory_order_relaxed);
        char c = 1;
        ssize_t r = write(self->wake_pipe[1], &c, 1);
        (void)r;
        if (self->thread) {
            self->thread->join();
            delete self->thread;
            self->thread = nullptr;
        }
    }
}

void free_sendq(Comm *self) {
    SendOp *head = self->sq.exchange(nullptr, std::memory_order_acquire);
    while (head) {
        SendOp *nx = head->next;
        delete head;
        head = nx;
    }
}

void close_peer(Peer *p) {
    if (p->fd >= 0) close(p->fd);
    if (p->tx.base) munmap(p->tx.base, p->tx.map_len);
    if (p->rx.base) munmap(p->rx.base, p->rx.map_len);
    delete p;
}

void comm_dealloc(PyObject *obj) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    comm_stop_locked(self);
    free_sendq(self);
    if (self->pools)
        for (auto &kv : *self->pools) Py_XDECREF(kv.second.obj);
    if (self->rdv) {
        for (auto &kv : *self->rdv) {
            PyBuffer_Release(&kv.second->buf);
            delete kv.second;
        }
    }
    if (self->rdv_release) {
        for (RdvReg *r : *self->rdv_release) {
            PyBuffer_Release(&r->buf);
            delete r;
        }
    }
    if (self->peers)
        for (Peer *p : *self->peers)
            if (p) close_peer(p);
    if (self->wake_pipe[0] >= 0) close(self->wake_pipe[0]);
    if (self->wake_pipe[1] >= 0) close(self->wake_pipe[1]);
    delete self->peers;
    delete self->pools_mu;
    delete self->pools;
    delete self->early;
    delete self->retired;
    delete self->pay_mu;
    delete self->payloads;
    delete self->rdv_mu;
    delete self->rdv;
    delete self->rdv_release;
    delete self->cred_mu;
    delete self->cred_avail;
    delete self->cred_out;
    delete self->act_seq;
    delete self->trace.load(std::memory_order_acquire);
    delete self->hist.load(std::memory_order_acquire);
    Py_TYPE(obj)->tp_free(obj);
}

bool check_not_started(Comm *self) {
    if (self->running.load(std::memory_order_relaxed)) {
        PyErr_SetString(PyExc_RuntimeError,
                        "peer registration after start()");
        return false;
    }
    return true;
}

bool check_peer_slot(Comm *self, int rank) {
    if (rank < 0 || rank >= self->nb_ranks || rank == self->my_rank) {
        PyErr_SetString(PyExc_ValueError, "bad peer rank");
        return false;
    }
    if ((*self->peers)[(size_t)rank]) {
        PyErr_SetString(PyExc_ValueError, "peer already registered");
        return false;
    }
    return true;
}

PyObject *comm_add_peer_fd(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int rank, fd;
    if (!PyArg_ParseTuple(args, "ii", &rank, &fd)) return nullptr;
    if (!check_not_started(self) || !check_peer_slot(self, rank))
        return nullptr;
    int nfd = dup(fd);
    if (nfd < 0) {
        PyErr_SetFromErrno(PyExc_OSError);
        return nullptr;
    }
    fcntl(nfd, F_SETFL, fcntl(nfd, F_GETFL, 0) | O_NONBLOCK);
    Peer *p = new (std::nothrow) Peer();
    if (!p) {
        close(nfd);
        return PyErr_NoMemory();
    }
    p->rank = rank;
    p->fd = nfd;
    (*self->peers)[(size_t)rank] = p;
    Py_RETURN_NONE;
}

bool map_shm(const char *name, size_t min_len, ShmView &v) {
    int fd = shm_open(name, O_RDWR, 0);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < min_len) {
        close(fd);
        return false;
    }
    void *base =
        mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
             MAP_SHARED, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return false;
    uint32_t magic, cap;
    memcpy(&magic, base, 4);
    memcpy(&cap, static_cast<char *>(base) + 4, 4);
    if (magic != SHM_MAGIC || cap == 0 ||
        SHM_DATA_OFF + cap > (size_t)st.st_size) {
        munmap(base, (size_t)st.st_size);
        return false;
    }
    v.base = static_cast<uint8_t *>(base);
    v.map_len = (size_t)st.st_size;
    v.head = reinterpret_cast<std::atomic<uint64_t> *>(v.base + SHM_HEAD_OFF);
    v.tail = reinterpret_cast<std::atomic<uint64_t> *>(v.base + SHM_TAIL_OFF);
    v.data = v.base + SHM_DATA_OFF;
    v.cap = cap;
    return true;
}

PyObject *comm_add_peer_shm(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int rank;
    const char *tx_name, *rx_name;
    if (!PyArg_ParseTuple(args, "iss", &rank, &tx_name, &rx_name))
        return nullptr;
    if (!check_not_started(self) || !check_peer_slot(self, rank))
        return nullptr;
    Peer *p = new (std::nothrow) Peer();
    if (!p) return PyErr_NoMemory();
    p->rank = rank;
    p->is_shm = true;
    if (!map_shm(tx_name, SHM_DATA_OFF + 16, p->tx) ||
        !map_shm(rx_name, SHM_DATA_OFF + 16, p->rx)) {
        close_peer(p);
        PyErr_Format(PyExc_OSError, "cannot map shm rings %s/%s", tx_name,
                     rx_name);
        return nullptr;
    }
    (*self->peers)[(size_t)rank] = p;
    Py_RETURN_NONE;
}

PyObject *comm_start(PyObject *obj, PyObject *) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    if (self->running.load(std::memory_order_relaxed)) Py_RETURN_NONE;
    if (self->wake_pipe[0] < 0) {
        PyErr_SetString(PyExc_OSError, "wake pipe unavailable");
        return nullptr;
    }
    self->running.store(true, std::memory_order_relaxed);
    self->thread = new (std::nothrow) std::thread(progress_main, self);
    if (!self->thread) {
        self->running.store(false, std::memory_order_relaxed);
        return PyErr_NoMemory();
    }
    Py_RETURN_NONE;
}

// pump(max_iters=1) — synchronous single-threaded progress, for tests
// and single-process loopback use; refuses while the thread runs.
PyObject *comm_pump(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int iters = 1;
    if (!PyArg_ParseTuple(args, "|i", &iters)) return nullptr;
    if (self->running.load(std::memory_order_relaxed)) {
        PyErr_SetString(PyExc_RuntimeError, "pump() while thread running");
        return nullptr;
    }
    ptrace_ring::Writer tw;
    tw.open(self->trace.load(std::memory_order_acquire));
    int n = 0;
    for (int i = 0; i < iters; i++) {
        n += drain_sendq(self, tw);
        for (Peer *p : *self->peers)
            if (p) n += flush_peer(self, p);
        n += pump_recv(self, tw);
    }
    return PyLong_FromLong(n);
}

PyObject *comm_stop(PyObject *obj, PyObject *) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    // best-effort goodbye so peers see a departure, not a death
    for (Peer *p : *self->peers) {
        if (!p || p->broken) continue;
        SendOp *op = new (std::nothrow) SendOp();
        if (op) {
            op->dst = p->rank;
            op->kind = K_BYE;
            sq_push(self, op);
        }
    }
    if (self->running.load(std::memory_order_relaxed)) {
        // give the thread one chance to flush the BYEs
        usleep(2000);
        comm_stop_locked(self);
    } else {
        ptrace_ring::Writer tw;
        drain_sendq(self, tw);
        for (Peer *p : *self->peers)
            if (p) flush_peer(self, p);
    }
    Py_RETURN_NONE;
}

PyObject *comm_register_pool(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    unsigned int pool;
    PyObject *engine, *cap;
    if (!PyArg_ParseTuple(args, "IOO", &pool, &engine, &cap)) return nullptr;
    PtCommIngestVtbl *v = static_cast<PtCommIngestVtbl *>(
        PyCapsule_GetPointer(cap, PTCOMM_INGEST_CAPSULE));
    if (!v) return nullptr;
    if (v->abi != PTCOMM_ABI) {
        PyErr_SetString(PyExc_RuntimeError, "ptcomm ABI mismatch");
        return nullptr;
    }
    std::vector<EarlyFrame> frames;
    {
        std::lock_guard<std::mutex> lk(*self->pools_mu);
        if (self->pools->count(pool)) {
            PyErr_Format(PyExc_ValueError, "pool %u already registered",
                         pool);
            return nullptr;
        }
        Py_INCREF(engine);
        (*self->pools)[pool] = PoolReg{engine, *v};
        self->retired->erase(pool);
        auto it = self->early->find(pool);
        if (it != self->early->end()) {
            frames.swap(it->second);
            self->early->erase(it);
        }
        if (!frames.empty()) replay_early_locked(self, pool, frames);
    }
    Py_RETURN_NONE;
}

PyObject *comm_unregister_pool(PyObject *obj, PyObject *arg) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    unsigned long pool = PyLong_AsUnsignedLong(arg);
    if (PyErr_Occurred()) return nullptr;
    PyObject *engine = nullptr;
    {
        std::lock_guard<std::mutex> lk(*self->pools_mu);
        auto it = self->pools->find((uint32_t)pool);
        if (it != self->pools->end()) {
            engine = it->second.obj;
            self->pools->erase(it);
        }
        self->retired->insert((uint32_t)pool);
        self->early->erase((uint32_t)pool);
    }
    {
        // drop parked payloads of the retired pool
        std::lock_guard<std::mutex> pl(*self->pay_mu);
        for (auto it = self->payloads->begin();
             it != self->payloads->end();) {
            if ((it->first >> 32) == pool)
                it = self->payloads->erase(it);
            else
                ++it;
        }
    }
    Py_XDECREF(engine);
    Py_RETURN_NONE;
}

PyObject *comm_send_capsule(PyObject *obj, PyObject *) {
    PtCommSendVtbl *v =
        static_cast<PtCommSendVtbl *>(std::malloc(sizeof(PtCommSendVtbl)));
    if (!v) return PyErr_NoMemory();
    v->abi = PTCOMM_ABI;
    v->comm = obj;
    v->send_act = comm_send_act_c;
    PyObject *cap = PyCapsule_New(v, PTCOMM_SEND_CAPSULE, [](PyObject *c) {
        std::free(PyCapsule_GetPointer(c, PTCOMM_SEND_CAPSULE));
    });
    if (!cap) std::free(v);
    return cap;
}

PyObject *comm_send_act(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool;
    int tid;
    if (!PyArg_ParseTuple(args, "iIi", &dst, &pool, &tid)) return nullptr;
    comm_send_act_c(self, dst, pool, tid);
    Py_RETURN_NONE;
}

// send_payload(dst, pool, slot, meta: bytes, data: buffer, eager_limit)
//   -> "eager" | "rdv"
PyObject *comm_send_payload(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, slot;
    Py_buffer meta, data;
    long long eager_limit = 65536;
    if (!PyArg_ParseTuple(args, "iIIy*y*|L", &dst, &pool, &slot, &meta,
                          &data, &eager_limit))
        return nullptr;
    if (dst < 0 || dst >= self->nb_ranks || dst == self->my_rank ||
        !(*self->peers)[(size_t)dst]) {
        PyBuffer_Release(&meta);
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "bad destination rank");
        return nullptr;
    }
    if ((uint64_t)data.len + (uint64_t)meta.len + 16 > MAX_BODY) {
        // a reply/frame larger than the receiver's untrusted-length cap
        // would poison the link (and a >4 GiB body would wrap the u32
        // length): refuse LOUDLY at the source instead
        PyBuffer_Release(&meta);
        PyBuffer_Release(&data);
        PyErr_Format(PyExc_ValueError,
                     "payload of %lld bytes exceeds the native comm "
                     "lane's %u-byte frame cap",
                     (long long)data.len, (unsigned)MAX_BODY);
        return nullptr;
    }
    const char *mode;
    if (data.len <= eager_limit) {
        SendOp *op = new (std::nothrow) SendOp();
        if (!op) {
            PyBuffer_Release(&meta);
            PyBuffer_Release(&data);
            return PyErr_NoMemory();
        }
        op->dst = dst;
        op->kind = K_DATA;
        op->pool = pool;
        op->arg = slot;
        op->meta.assign(static_cast<const char *>(meta.buf),
                        (size_t)meta.len);
        op->inl.assign(static_cast<const char *>(data.buf),
                       (size_t)data.len);
        PyBuffer_Release(&data);
        sq_push(self, op);
        mode = "eager";
    } else {
        // rendezvous: pin the buffer (the Py_buffer keeps the exporter
        // alive), ship only the descriptor; the receiver pulls
        RdvReg *reg = new (std::nothrow) RdvReg();
        if (!reg) {
            PyBuffer_Release(&meta);
            PyBuffer_Release(&data);
            return PyErr_NoMemory();
        }
        reg->buf = data;  // ownership moves (no release here)
        uint64_t handle;
        {
            std::lock_guard<std::mutex> lk(*self->rdv_mu);
            handle = self->next_handle++;
            (*self->rdv)[handle] = reg;
        }
        SendOp *op = new (std::nothrow) SendOp();
        if (!op) {
            PyBuffer_Release(&meta);
            return PyErr_NoMemory();  // reg stays until fini (leak-safe)
        }
        op->dst = dst;
        op->kind = K_RDV;
        op->pool = pool;
        op->arg = slot;
        op->aux = handle;
        op->meta.assign(static_cast<const char *>(meta.buf),
                        (size_t)meta.len);
        sq_push(self, op);
        mode = "rdv";
    }
    PyBuffer_Release(&meta);
    return PyUnicode_FromString(mode);
}

// take_payload(pool, slot) -> (meta: bytes, data: bytes); KeyError when
// absent or still mid-pull. Consumes (and frees) the stored entry.
PyObject *comm_take_payload(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    unsigned int pool, slot;
    if (!PyArg_ParseTuple(args, "II", &pool, &slot)) return nullptr;
    std::string meta, data;
    {
        std::lock_guard<std::mutex> lk(*self->pay_mu);
        auto it = self->payloads->find(pay_key(pool, slot));
        if (it == self->payloads->end() || !it->second.complete) {
            PyErr_Format(PyExc_KeyError,
                         "no complete payload for pool %u slot %u", pool,
                         slot);
            return nullptr;
        }
        meta.swap(it->second.meta);
        data.swap(it->second.data);
        self->payloads->erase(it);
    }
    return Py_BuildValue("(y#y#)", meta.data(), (Py_ssize_t)meta.size(),
                         data.data(), (Py_ssize_t)data.size());
}

PyObject *comm_payload_ready(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    unsigned int pool, slot;
    if (!PyArg_ParseTuple(args, "II", &pool, &slot)) return nullptr;
    std::lock_guard<std::mutex> lk(*self->pay_mu);
    auto it = self->payloads->find(pay_key(pool, slot));
    if (it != self->payloads->end() && it->second.complete) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

// reap() -> released pin count; releases Py_buffers whose rendezvous
// replies already streamed out (the progress thread cannot DECREF)
PyObject *comm_reap(PyObject *obj, PyObject *) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    std::vector<RdvReg *> rel;
    {
        std::lock_guard<std::mutex> lk(*self->rdv_mu);
        rel.swap(*self->rdv_release);
    }
    for (RdvReg *r : rel) {
        PyBuffer_Release(&r->buf);
        delete r;
    }
    return PyLong_FromSize_t(rel.size());
}

PyObject *comm_pins_pending(PyObject *obj, PyObject *) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    std::lock_guard<std::mutex> lk(*self->rdv_mu);
    return PyLong_FromSize_t(self->rdv->size());
}

// ----------------------------------------------------- serving credits
// (frame layout + flag contract in ptcomm_iface.h)

bool check_cred_args(Comm *self, int rank, long long n, bool want_n) {
    if (rank < 0 || rank >= self->nb_ranks || rank == self->my_rank) {
        PyErr_SetString(PyExc_ValueError, "bad peer rank");
        return false;
    }
    if (want_n && n <= 0) {
        PyErr_SetString(PyExc_ValueError, "credit count must be positive");
        return false;
    }
    return true;
}

// cred_grant(dst, pool, tenant, n): grant n admission credits to rank
// `dst` for (pool, tenant) — bumps the outstanding ledger and ships a
// K_CRED frame. The caller (the fabric) reserves matching window
// headroom on the scheduler plane FIRST.
PyObject *comm_cred_grant(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, tenant;
    long long n;
    if (!PyArg_ParseTuple(args, "iIIL", &dst, &pool, &tenant, &n))
        return nullptr;
    if (!check_cred_args(self, dst, n, true)) return nullptr;
    if (!(*self->peers)[(size_t)dst]) {
        PyErr_SetString(PyExc_ValueError, "no such peer");
        return nullptr;
    }
    SendOp *op = new (std::nothrow) SendOp();
    if (!op) return PyErr_NoMemory();
    {
        std::lock_guard<std::mutex> lk(*self->cred_mu);
        (*self->cred_out)[(size_t)dst][cred_key(pool, tenant)] += n;
    }
    self->creds_granted_tx.fetch_add(n, std::memory_order_relaxed);
    op->dst = dst;
    op->kind = K_CRED;
    op->flags = PTCOMM_CRED_GRANT;
    op->pool = pool;
    op->arg = tenant;
    op->aux = (uint64_t)n;
    sq_push(self, op);
    Py_RETURN_NONE;
}

// cred_take(dst, pool, tenant, n=1) -> bool: spend n credits toward
// rank `dst` LOCALLY — one mutex-guarded map op, no wire traffic. False
// = balance exhausted (the remote-admission backpressure signal).
PyObject *comm_cred_take(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, tenant;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "iII|L", &dst, &pool, &tenant, &n))
        return nullptr;
    if (!check_cred_args(self, dst, n, true)) return nullptr;
    bool ok = false;
    {
        std::lock_guard<std::mutex> lk(*self->cred_mu);
        auto &m = (*self->cred_avail)[(size_t)dst];
        auto it = m.find(cred_key(pool, tenant));
        if (it != m.end() && it->second >= n) {
            it->second -= n;
            ok = true;
        }
    }
    if (ok) self->creds_spent.fetch_add(n, std::memory_order_relaxed);
    return PyBool_FromLong(ok ? 1 : 0);
}

// cred_return(dst, pool, tenant, n) -> returned: hand up to n unspent
// credits back to the granting rank (a K_CRED return frame); returns
// how many were actually held and returned.
PyObject *comm_cred_return(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, tenant;
    long long n;
    if (!PyArg_ParseTuple(args, "iIIL", &dst, &pool, &tenant, &n))
        return nullptr;
    if (!check_cred_args(self, dst, n, true)) return nullptr;
    int64_t take = 0;
    {
        std::lock_guard<std::mutex> lk(*self->cred_mu);
        auto &m = (*self->cred_avail)[(size_t)dst];
        auto it = m.find(cred_key(pool, tenant));
        if (it != m.end() && it->second > 0) {
            take = it->second < n ? it->second : n;
            it->second -= take;
        }
    }
    if (take > 0) {
        SendOp *op = new (std::nothrow) SendOp();
        if (op) {
            op->dst = dst;
            op->kind = K_CRED;
            op->flags = PTCOMM_CRED_RETURN;
            op->pool = pool;
            op->arg = tenant;
            op->aux = (uint64_t)take;
            sq_push(self, op);
            self->creds_returned_tx.fetch_add(take,
                                              std::memory_order_relaxed);
        }
    }
    return PyLong_FromLongLong(take);
}

// cred_consume(src, pool, tenant, n=1) -> consumed: a credited insert
// ARRIVED from rank `src` — shrink the outstanding ledger by the spent
// credit (the target-side half of the local-spend contract; floors at
// 0 so an uncredited or post-reclaim arrival cannot go negative).
PyObject *comm_cred_consume(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int src;
    unsigned int pool, tenant;
    long long n = 1;
    if (!PyArg_ParseTuple(args, "iII|L", &src, &pool, &tenant, &n))
        return nullptr;
    if (!check_cred_args(self, src, n, true)) return nullptr;
    int64_t took = 0;
    {
        std::lock_guard<std::mutex> lk(*self->cred_mu);
        auto &m = (*self->cred_out)[(size_t)src];
        auto it = m.find(cred_key(pool, tenant));
        if (it != m.end() && it->second > 0) {
            took = it->second < n ? it->second : n;
            it->second -= took;
        }
    }
    return PyLong_FromLongLong(took);
}

PyObject *comm_cred_avail(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, tenant;
    if (!PyArg_ParseTuple(args, "iII", &dst, &pool, &tenant))
        return nullptr;
    if (!check_cred_args(self, dst, 1, false)) return nullptr;
    std::lock_guard<std::mutex> lk(*self->cred_mu);
    auto &m = (*self->cred_avail)[(size_t)dst];
    auto it = m.find(cred_key(pool, tenant));
    return PyLong_FromLongLong(it == m.end() ? 0 : it->second);
}

PyObject *comm_cred_outstanding(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    int dst;
    unsigned int pool, tenant;
    if (!PyArg_ParseTuple(args, "iII", &dst, &pool, &tenant))
        return nullptr;
    if (!check_cred_args(self, dst, 1, false)) return nullptr;
    std::lock_guard<std::mutex> lk(*self->cred_mu);
    auto &m = (*self->cred_out)[(size_t)dst];
    auto it = m.find(cred_key(pool, tenant));
    return PyLong_FromLongLong(it == m.end() ? 0 : it->second);
}

// cred_reclaim(rank) -> ([(pool, tenant, outstanding), ...], dropped):
// peer-death containment. Zeroes BOTH ledgers for `rank`: the per-key
// outstanding grants are handed back to the caller so it can release
// the matching scheduler-plane window reservations (no leaked window),
// and `dropped` is the now-unspendable balance this rank held toward
// the dead peer. Idempotent: a second call returns empty.
PyObject *comm_cred_reclaim(PyObject *obj, PyObject *arg) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    long rank = PyLong_AsLong(arg);
    if (rank == -1 && PyErr_Occurred()) return nullptr;
    if (rank < 0 || rank >= self->nb_ranks || rank == self->my_rank) {
        PyErr_SetString(PyExc_ValueError, "bad peer rank");
        return nullptr;
    }
    std::vector<std::pair<uint64_t, int64_t>> out;
    int64_t dropped = 0, reclaimed = 0;
    {
        std::lock_guard<std::mutex> lk(*self->cred_mu);
        for (auto &kv : (*self->cred_out)[(size_t)rank]) {
            if (kv.second > 0) {
                out.emplace_back(kv.first, kv.second);
                reclaimed += kv.second;
            }
        }
        (*self->cred_out)[(size_t)rank].clear();
        for (auto &kv : (*self->cred_avail)[(size_t)rank])
            if (kv.second > 0) dropped += kv.second;
        (*self->cred_avail)[(size_t)rank].clear();
    }
    if (reclaimed)
        self->creds_reclaimed.fetch_add(reclaimed,
                                        std::memory_order_relaxed);
    PyObject *lst = PyList_New((Py_ssize_t)out.size());
    if (!lst) return nullptr;
    for (size_t i = 0; i < out.size(); i++) {
        PyObject *t = Py_BuildValue(
            "(IIL)", (unsigned int)(out[i].first >> 32),
            (unsigned int)(out[i].first & 0xFFFFFFFFu),
            (long long)out[i].second);
        if (!t) { Py_DECREF(lst); return nullptr; }
        PyList_SET_ITEM(lst, (Py_ssize_t)i, t);
    }
    return Py_BuildValue("(NL)", lst, (long long)dropped);
}

PyObject *comm_stats(PyObject *obj, PyObject *) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    size_t npay, nearly;
    {
        std::lock_guard<std::mutex> lk(*self->pay_mu);
        npay = self->payloads->size();
    }
    {
        std::lock_guard<std::mutex> lk(*self->pools_mu);
        nearly = 0;
        for (auto &kv : *self->early) nearly += kv.second.size();
    }
    std::vector<int> broken;
    for (Peer *p : *self->peers)
        if (p && p->broken) broken.push_back(p->rank);
    PyObject *bl = PyList_New((Py_ssize_t)broken.size());
    if (!bl) return nullptr;
    for (size_t i = 0; i < broken.size(); i++)
        PyList_SET_ITEM(bl, (Py_ssize_t)i, PyLong_FromLong(broken[i]));
#define C(name) (long long)self->name.load(std::memory_order_relaxed)
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,"
        "s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:n,s:n,s:N}",
        "out_pending", C(out_pending),
        "acts_tx", C(acts_tx), "acts_rx", C(acts_rx), "act_frames_tx",
        C(act_frames_tx), "act_frames_rx", C(act_frames_rx), "data_tx",
        C(data_tx), "data_rx", C(data_rx), "rdv_tx", C(rdv_tx), "rdv_rx",
        C(rdv_rx), "getreq_rx", C(getreq_rx), "getrep_rx", C(getrep_rx),
        "bytes_tx", C(bytes_tx), "bytes_rx", C(bytes_rx), "frame_errors",
        C(frame_errors), "early_parked", C(early_parked), "late_frames",
        C(late_frames), "dropped_sends",
        C(dropped_sends),
        "creds_granted_tx", C(creds_granted_tx), "creds_granted_rx",
        C(creds_granted_rx), "creds_spent", C(creds_spent),
        "creds_returned_tx", C(creds_returned_tx), "creds_returned_rx",
        C(creds_returned_rx), "creds_reclaimed", C(creds_reclaimed),
        "cred_frames_tx", C(cred_frames_tx), "cred_frames_rx",
        C(cred_frames_rx),
        "wakeups", C(wakeups), "loops", C(loops),
        "payloads_pending", (Py_ssize_t)npay, "early_pending",
        (Py_ssize_t)nearly, "broken_peers", bl);
#undef C
}

// ------------------------------------------------------------- trace glue

PyObject *comm_trace_enable(PyObject *obj, PyObject *args) {
    Comm *self = reinterpret_cast<Comm *>(obj);
    return ptrace_ring::py_trace_enable(self->trace, args);
}

PyObject *comm_trace_disable(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_disable(
        reinterpret_cast<Comm *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *comm_trace_drain(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_drain(
        reinterpret_cast<Comm *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *comm_trace_dropped(PyObject *obj, PyObject *) {
    return ptrace_ring::py_trace_dropped(
        reinterpret_cast<Comm *>(obj)->trace.load(std::memory_order_acquire));
}

PyObject *comm_monotonic_ns(PyObject *, PyObject *) {
    return PyLong_FromLongLong(ptrace_ring::now_ns());
}

PyObject *comm_hist_enable(PyObject *obj, PyObject *) {
    return pthist::py_hist_enable<N_HISTS>(
        reinterpret_cast<Comm *>(obj)->hist);
}

PyObject *comm_hist_snapshot(PyObject *obj, PyObject *) {
    return pthist::py_hist_snapshot<N_HISTS>(
        reinterpret_cast<Comm *>(obj)->hist.load(std::memory_order_acquire),
        HIST_NAMES);
}

PyMethodDef comm_methods[] = {
    {"add_peer_fd", comm_add_peer_fd, METH_VARARGS,
     "add_peer_fd(rank, fd): adopt (dup) a connected stream socket"},
    {"add_peer_shm", comm_add_peer_shm, METH_VARARGS,
     "add_peer_shm(rank, tx_name, rx_name): map a same-host ring pair"},
    {"start", comm_start, METH_NOARGS,
     "launch the funneled progress thread"},
    {"stop", comm_stop, METH_NOARGS,
     "say BYE, flush, stop the progress thread"},
    {"pump", comm_pump, METH_VARARGS,
     "pump(iters=1) -> n: synchronous progress (tests; thread must be off)"},
    {"register_pool", comm_register_pool, METH_VARARGS,
     "register_pool(pool_id, engine, ingest_capsule): route this pool's "
     "frames into the engine (replays early-arrived frames)"},
    {"unregister_pool", comm_unregister_pool, METH_O,
     "unregister_pool(pool_id): drop routing + parked payloads"},
    {"send_capsule", comm_send_capsule, METH_NOARGS,
     "PyCapsule(PtCommSendVtbl) for Graph.comm_bind"},
    {"send_act", comm_send_act, METH_VARARGS,
     "send_act(dst, pool, tid): enqueue one activation (tests/fallback)"},
    {"send_payload", comm_send_payload, METH_VARARGS,
     "send_payload(dst, pool, slot, meta, data, eager_limit=65536) -> "
     "'eager'|'rdv'"},
    {"take_payload", comm_take_payload, METH_VARARGS,
     "take_payload(pool, slot) -> (meta, data); consumes the entry"},
    {"payload_ready", comm_payload_ready, METH_VARARGS,
     "payload_ready(pool, slot) -> bool"},
    {"cred_grant", comm_cred_grant, METH_VARARGS,
     "cred_grant(dst, pool, tenant, n): grant n admission credits to a "
     "remote inserter (K_CRED frame; outstanding ledger bumped)"},
    {"cred_take", comm_cred_take, METH_VARARGS,
     "cred_take(dst, pool, tenant, n=1) -> bool: spend credits LOCALLY "
     "(no wire traffic); False = exhausted (backpressure)"},
    {"cred_return", comm_cred_return, METH_VARARGS,
     "cred_return(dst, pool, tenant, n) -> returned: hand unspent "
     "credits back to the granting rank"},
    {"cred_consume", comm_cred_consume, METH_VARARGS,
     "cred_consume(src, pool, tenant, n=1) -> consumed: a credited "
     "insert arrived — shrink src's outstanding ledger (floors at 0)"},
    {"cred_avail", comm_cred_avail, METH_VARARGS,
     "cred_avail(dst, pool, tenant) -> spendable balance toward dst"},
    {"cred_outstanding", comm_cred_outstanding, METH_VARARGS,
     "cred_outstanding(dst, pool, tenant) -> credits granted to dst and "
     "not yet returned/reclaimed"},
    {"cred_reclaim", comm_cred_reclaim, METH_O,
     "cred_reclaim(rank) -> ([(pool, tenant, n)], dropped): peer-death "
     "containment — zero both ledgers for rank, hand back per-key "
     "outstanding grants so window reservations can be released"},
    {"reap", comm_reap, METH_NOARGS,
     "release Py_buffer pins whose rendezvous replies were served"},
    {"pins_pending", comm_pins_pending, METH_NOARGS,
     "rendezvous registrations not yet pulled"},
    {"stats", comm_stats, METH_NOARGS, "counter snapshot dict"},
    {"trace_enable", comm_trace_enable, METH_VARARGS,
     "arm the in-lane event rings (EV_COMM_*)"},
    {"trace_disable", comm_trace_disable, METH_NOARGS, "stop recording"},
    {"trace_drain", comm_trace_drain, METH_NOARGS,
     "[(ring_id, packed_events_bytes)]"},
    {"trace_dropped", comm_trace_dropped, METH_NOARGS,
     "events lost to ring overflow"},
    {"monotonic_ns", comm_monotonic_ns, METH_NOARGS, "the trace clock"},
    {"hist_enable", comm_hist_enable, METH_NOARGS,
     "arm the wire latency histograms (rdv_rtt_ns, act_queue_ns)"},
    {"hist_snapshot", comm_hist_snapshot, METH_NOARGS,
     "{name: (count, sum_ns, buckets_bytes)} — buckets pack '<496Q'"},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject CommType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "parsec_tpu_torch._ptcomm.Comm";
    t.tp_basicsize = sizeof(Comm);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = "native communication lane (funneled progress thread)";
    t.tp_new = comm_new;
    t.tp_dealloc = comm_dealloc;
    t.tp_methods = comm_methods;
    return t;
}();

PyModuleDef ptcomm_module = {
    PyModuleDef_HEAD_INIT, "_ptcomm",
    "native communication lane (see csrc/ptcomm.cpp)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__ptcomm(void) {
    if (PyType_Ready(&CommType) < 0) return nullptr;
    PyObject *m = PyModule_Create(&ptcomm_module);
    if (!m) return nullptr;
    Py_INCREF(&CommType);
    if (PyModule_AddObject(m, "Comm",
                           reinterpret_cast<PyObject *>(&CommType)) < 0) {
        Py_DECREF(&CommType);
        Py_DECREF(m);
        return nullptr;
    }
    if (PyModule_AddIntConstant(m, "EV_COMM_ACT_TX", EV_COMM_ACT_TX) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_ACT_RX", EV_COMM_ACT_RX) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_DATA_TX", EV_COMM_DATA_TX) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_DATA_RX", EV_COMM_DATA_RX) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_RDV", EV_COMM_RDV) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_REP", EV_COMM_REP) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_FRAME_TX", EV_COMM_FRAME_TX) < 0 ||
        PyModule_AddIntConstant(m, "EV_COMM_FRAME_RX", EV_COMM_FRAME_RX) < 0 ||
        PyModule_AddIntConstant(m, "EV_FAB_CRED_TX", EV_FAB_CRED_TX) < 0 ||
        PyModule_AddIntConstant(m, "EV_FAB_CRED_RX", EV_FAB_CRED_RX) < 0 ||
        PyModule_AddIntConstant(m, "CRED_GRANT", PTCOMM_CRED_GRANT) < 0 ||
        PyModule_AddIntConstant(m, "CRED_RETURN", PTCOMM_CRED_RETURN) < 0 ||
        PyModule_AddIntConstant(m, "HIST_BUCKETS", pthist::NBUCKETS) < 0 ||
        PyModule_AddIntConstant(m, "SHM_MAGIC", (long)SHM_MAGIC) < 0 ||
        PyModule_AddIntConstant(m, "SHM_DATA_OFF", (long)SHM_DATA_OFF) < 0) {
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
