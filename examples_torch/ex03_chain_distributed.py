"""Ex03: the chain across ranks — remote deps carry the tile between ranks.

(Reference analogue: examples/Ex03_ChainMPI.c; the ranks here are threads in
one process joined by the in-process fabric, the CE vtable the TCP mesh of
Ex09 also backs.)

    python ex03_chain_distributed.py [--cpu]
"""
from _common import device


def main():
    import numpy as np

    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.core.context import Context
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import AFFINITY, READ, RW, DTDTaskpool
    from parsec_tpu_torch.utils import mca

    NB_RANKS, NT = 2, 16
    dev = device()
    if dev == "cuda":
        mca.set("device_cuda_max_bytes", 1 << 28)   # a budget each rank

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device=dev, my_rank=rank,
                      nb_ranks=NB_RANKS)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        A = TwoDimBlockCyclic("A", NT * 4, 4, 4, 4, P=NB_RANKS, Q=1,
                              nodes=NB_RANKS, myrank=rank)
        A.fill(lambda m, n: np.zeros((4, 4), np.float32))
        tp = DTDTaskpool(ctx, "chain")
        # each step owns a different tile -> the chain hops between ranks
        prev = None
        for k in range(NT):
            t = tp.tile_of(A, k, 0)
            if prev is None:
                tp.insert_task(lambda x: x + 1.0, (t, RW | AFFINITY))
            else:
                tp.insert_task(lambda x, p: p + 1.0, (t, RW | AFFINITY),
                               (prev, READ))
            prev = t
        tp.wait(); tp.close(); ctx.wait(); ctx.fini()
        if A.rank_of(NT - 1, 0) == rank:
            return float(A.data_of(NT - 1, 0).newest_copy().payload
                         .cpu()[0, 0])
        return None

    results = run_distributed(NB_RANKS, program)
    print("ex03 distributed chain result (expect 16):",
          [r for r in results if r is not None][0])


if __name__ == "__main__":
    main()
