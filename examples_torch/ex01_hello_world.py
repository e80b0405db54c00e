"""Ex01: one dynamic task (insert_task hello world).

(Reference analogue: examples/Ex01_HelloWorld.c)
Run: ``python examples_torch/ex01_hello_world.py [--cpu]``.
"""
from _common import device


def main():
    import numpy as np
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW

    ctx = ptt.init(nb_cores=1, device=device())
    tp = DTDTaskpool(ctx, "hello")
    t = tp.tile_new(np.zeros((2, 2), np.float32))

    def hello(x):
        print("hello from a task!")
        return x + 1.0

    tp.insert_task(hello, (t, RW), jit=False)
    tp.wait(); tp.close(); ctx.wait()
    got = float(t.data.newest_copy().payload[0, 0])
    print("ex01 result (expect 1.0):", got)
    ptt.fini()
    assert got == 1.0


if __name__ == "__main__":
    main()
