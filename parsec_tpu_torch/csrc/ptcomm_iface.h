// C-level contract between the native engines (_ptexec, _ptdtd) and the
// native communication lane (_ptcomm).
//
// The three artifacts are SEPARATE CPython extensions (native.py builds)
// that share no symbols; they link at runtime through PyCapsules carrying
// these plain-C vtables — the same pattern numpy uses for its C API. Both
// directions of the hot path are GIL-free:
//
//   engine -> comm  (PtCommSendVtbl): a task retiring inside the lane
//     walk discovers a remote successor and enqueues an activation onto
//     the comm lane's lock-free send queue — one function call, no GIL,
//     never blocks (the funneled progress thread does the wire work).
//
//   comm -> engine  (PtCommIngestVtbl): the progress thread decodes an
//     incoming activation frame and drops the dependency decrement
//     straight into the engine's ready structures — a remote dep-release
//     costs the same as a local one (the reference's remote_dep_mpi.c
//     release path funneled into parsec_release_local_OUT_dependencies).
//
// Lifetime rules (enforced by the comm lane's Python owner, which owns
// both ends): the Comm object registers a pool with Py-level references to
// the engine object (INCREF under the GIL at register, DECREF at
// unregister), and a bound engine must be unbound/finished before the
// Comm object is destroyed. The vtables themselves are POD copied by
// value; `obj`/`comm` are borrowed pointers whose validity is exactly the
// registration window.

#ifndef PARSEC_TPU_PTCOMM_IFACE_H
#define PARSEC_TPU_PTCOMM_IFACE_H

#include <stdint.h>

// bump on any layout/semantics change; both sides check before use
#define PTCOMM_ABI 1

// capsule names (PyCapsule_New/Import contract)
#define PTCOMM_INGEST_CAPSULE "parsec_tpu_torch.ptcomm.ingest_vtbl"
#define PTCOMM_SEND_CAPSULE "parsec_tpu_torch.ptcomm.send_vtbl"

extern "C" {

// engine-side entry points the comm progress thread calls (NO GIL):
typedef struct PtCommIngestVtbl {
    int abi;
    void *obj;  // the engine object (ptexec Graph / ptdtd Engine)
    // one arrived activation == one dependency decrement on task `tid`;
    // a task reaching zero enters the engine's ready structure directly
    void (*act)(void *obj, int32_t tid);
    // rendezvous data lifecycle for input slot `slot` (null for engines
    // without data slots): begin gates readiness of consumers, land
    // releases parked consumers once the pulled payload is available
    void (*rdv_begin)(void *obj, int32_t slot);
    void (*rdv_land)(void *obj, int32_t slot);
} PtCommIngestVtbl;

// comm-side entry point the engine release sweep calls (NO GIL):
typedef struct PtCommSendVtbl {
    int abi;
    void *comm;  // the Comm object
    // enqueue one activation for task `tid` of pool `pool` to rank `dst`
    // onto the lock-free send queue; never blocks, never takes the GIL
    void (*send_act)(void *comm, int32_t dst, uint32_t pool, int32_t tid);
} PtCommSendVtbl;

// ---------------------------------------------------------------- ptfab
// Credit frames of the cross-rank serving fabric. The frame
// kind K_CRED rides the same wire as ACTS/DATA so admission control and
// work share one FIFO per link; it is comm-internal (no engine vtable
// entry — credits gate INSERTION, which happens above the engines), but
// the flag values are part of the wire contract both ends of a mesh
// must agree on, so they live in this shared header:
//
//   hdr.pool  = comm pool id of the serving taskpool
//   hdr.arg   = tenant id (crc32 of the tenant name, 0 = the pool itself)
//   hdr.aux   = credit count (u64, > 0)
//   hdr.flags = PTCOMM_CRED_GRANT: target -> inserter, adds to the
//               inserter's locally-spendable balance for (dst,pool,tenant);
//               PTCOMM_CRED_RETURN: inserter -> target, hands unspent
//               credits back so the target's outstanding ledger (and with
//               it the pool's admission headroom) shrinks.
//
// Spends are NOT on the wire: an inserter debits its local balance
// (Comm.cred_take, one mutex-guarded map op) and the spent credit is
// implicitly consumed at the target by the arriving insert's normal
// admission accounting — the zero-round-trip hot-path contract.
#define PTCOMM_CRED_GRANT 0
#define PTCOMM_CRED_RETURN 1

}  // extern "C"

#endif  // PARSEC_TPU_PTCOMM_IFACE_H
