"""Per-rank EP throughput worker for the process-per-card scaling row.

Launched by :func:`parsec_tpu_torch.launch.ep_scaling_rates` as ``python -m
parsec_tpu_torch._bench_ep_worker NTASKS``: joins the TCP mesh (the job
shape a real deployment has — one OS process per card), warms the PTG EP
program, barriers so every rank starts together, then drives NTASKS trivial
tasks through generate→schedule→execute→release and reports its wall time.

Mirrors the reference's scheduling micro-benchmark run under ``mpiexec -n
N`` (tests/runtime/scheduling/ep.jdf + main.c): the EP graph is rank-local
by construction, so aggregate throughput measures pure runtime machinery
scale-out, not communication. A rank's context is a card context unless
``PARSEC_TPU_TORCH_FORCE_CPU=1`` asks for the CPU.
"""

import os
import sys
import time

EP_SOURCE = "%global NT\nEP(i)\n  i = 0 .. NT-1\nBODY\n  pass\nEND\n"


def main() -> None:
    ntasks = int(sys.argv[1]) if len(sys.argv) > 1 else 20000

    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.tcp import init_from_env
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.device.probe import ENV_FORCE_CPU
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.utils import mca

    # the row measures SCHEDULED machinery scale-out (generate->schedule->
    # execute->release per task); the agglomerated sweep would reduce it to
    # a function-call loop and hide the runtime entirely
    mca.set("ptg_agglomerate", False)
    device = "cpu" if os.environ.get(ENV_FORCE_CPU) == "1" else "cuda"
    if device == "cuda":
        # every rank's context on the one card: a tile budget of its own
        mca.set("device_cuda_max_bytes", 1 << 28)

    ce = init_from_env()
    ctx = Context(nb_cores=1, device=device, my_rank=ce.my_rank,
                  nb_ranks=ce.nb_ranks)
    if ce.nb_ranks > 1:
        RemoteDepEngine(ctx, ce)
    prog = compile_ptg(EP_SOURCE, "ep")

    def run(nt: int, name: str) -> float:
        etp = prog.instantiate(ctx, globals={"NT": nt}, collections={},
                               name=name)
        t0 = time.perf_counter()
        ctx.add_taskpool(etp)
        ctx.wait()
        return time.perf_counter() - t0

    run(2000, "warm")                      # compile + first-touch costs
    ce.sync()                              # aligned start across ranks
    wall = min(run(ntasks, f"ep-{r}") for r in range(2))
    print(f"EPRATE rank={ce.my_rank} wall={wall:.6f} "
          f"rate={ntasks / wall:.1f} device={device}", flush=True)
    ce.sync()                              # no rank departs mid-measurement
    ctx.fini()
    ce.fini()


if __name__ == "__main__":
    main()
