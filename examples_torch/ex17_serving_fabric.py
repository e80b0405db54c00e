"""Ex17: the cross-rank serving fabric (ptfab) — an adversarial tenant
flooding EVERY rank cannot move another tenant's p99, and the fabric
serves card work.

Two OS ranks each serve two tenants from plane-bound DTD pools. The
gateway routes each insert to the rank with the most ADVERTISED
admission headroom — the credit balance the serving ranks granted over
the native wire (ptcomm K_CRED frames), spent locally with zero
round trips. Phase 1 measures the victim tenant's p99 alone; phase 2
lets the antagonist flood both ranks through the same gateway: its tiny
admission window turns the flood into AdmissionBackpressure rejections
instead of backlog. Phase 3 floods two equal-cost tenants while the
rank-0 reconciliation loop scrapes both ranks' /metrics and nudges
their local DRR weights until measured CROSS-RANK shares match the
global 2:1 weights. Those ranks serve CPU work on CPU contexts.

Then rank 0 serves a tenant from a card context: each request the other
rank sends through the gateway inserts one bf16 GEMM_K task (the
gemm_chain kernel) there, and is retired through the fabric.

Run it directly (it starts its own 2-rank mesh; ``--cpu`` runs the card
leg with the CUDA device module over the CPU, at a cut size):

    python examples_torch/ex17_serving_fabric.py [--cpu]
"""
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import device  # noqa: E402


def main():
    import numpy as np

    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import (card_serving_2rank_program,
                                                  fabric_2rank_program)

    dev = device()
    res = run_distributed_procs(
        2, functools.partial(fabric_2rank_program, isolation_s=1.2,
                             loaded_s=1.5, shares_s=2.5), timeout=300)
    assert all(r.get("fabric") for r in res), \
        [r.get("reason") for r in res]

    base = [x for r in res for x in r["victim_lats_base_ns"]]
    load = [x for r in res for x in r["victim_lats_load_ns"]]
    p99b = float(np.percentile(base, 99)) / 1e6
    p99l = float(np.percentile(load, 99)) / 1e6
    rejects = sum(r["antagonist_rejects"] for r in res)
    served = sum(r["antagonist_served"] for r in res)
    sv = sum(r["shares_window"]["sv"] for r in res)
    sa = sum(r["shares_window"]["sa"] for r in res)
    wire = {k: sum(r["wire"][k] for r in res) for k in res[0]["wire"]}

    print(f"victim p99 unloaded : {p99b:8.2f} ms ({len(base)} probes)")
    print(f"victim p99 flooded  : {p99l:8.2f} ms ({len(load)} probes, "
          f"antagonist served {served}, REJECTED {rejects})")
    print(f"isolation           : {p99l / max(p99b, 1e-9):8.2f}x "
          f"(acceptance bound: 2x)")
    print(f"cross-rank shares   : {sv}:{sa} = {sv / max(1, sa):.2f} "
          f"(global weights 2:1, {res[0]['reconcile_rounds']} "
          f"reconcile rounds)")
    print(f"credit wire         : {wire['creds_granted_tx']} granted, "
          f"{wire['creds_spent']} spent LOCALLY over "
          f"{wire['cred_frames_tx']} frames, "
          f"{wire['creds_reclaimed']} reclaimed, "
          f"{wire['frame_errors']} frame errors")
    assert wire["frame_errors"] == 0
    assert rejects > 0, "the antagonist never saw backpressure"

    size = {"ts": 512} if dev == "cuda" else {"ts": 128, "requests": 16}
    server, client = run_distributed_procs(
        2, functools.partial(card_serving_2rank_program, device=dev,
                             **size), timeout=300)
    print(f"card leg ({dev})      : {server['served']} requests served "
          f"through a KIND_EXT pool on a card context "
          f"({server['served_per_s']} /s), {server['launches']} "
          f"gemm_chain launches, {client['wire']['creds_spent']} credits "
          f"spent, {client['fab_stats']['remote_stalls']} stalls; every "
          f"C tile the plain chain's bit for bit: "
          f"{server['tiles_equal_plain']}; against torch.matmul in f32 "
          f"max err / max |ref| {server['max_err_rel']:.2e}, norm-wise "
          f"{server['norm_err_rel']:.2e}")
    assert server["card_context"] and server["plane"]
    assert server["served"] == client["wire"]["creds_spent"]
    assert server["tiles_equal_plain"] and server["norm_err_rel"] < 1e-2
    if dev == "cuda":
        assert server["launches"] == server["served"]
    print("ex17 OK: backpressure spans the mesh; the victim's p99 is "
          "admission-protected, not luck; the fabric serves card work")


if __name__ == "__main__":
    main()
