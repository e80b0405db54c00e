"""Ex00: runtime lifecycle — init, start, wait, fini.

(Reference analogue: examples/Ex00_StartStop.c)
Run: ``python examples_torch/ex00_start_stop.py [--cpu]``.
"""
from _common import device


def main():
    import parsec_tpu_torch as ptt
    ctx = ptt.init(nb_cores=1, device=device())
    ctx.start()
    ctx.wait()           # no taskpools: returns at once
    ptt.fini()
    print("ex00: context lifecycle OK (expect: no error)")


if __name__ == "__main__":
    main()
