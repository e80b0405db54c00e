"""CLI: runtime info and MCA help (the --parsec-help role).

Usage::

    python -m parsec_tpu_torch --help-mca      # all registered parameters
    python -m parsec_tpu_torch --devices       # device registry (the card)
    python -m parsec_tpu_torch --devices --cpu # device registry of a CPU context
    python -m parsec_tpu_torch --version
"""

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    from . import __version__
    from .utils import mca
    if "--version" in argv or not argv:
        print(f"parsec_tpu_torch {__version__}")
        if not argv:
            print(__doc__)
        return 0
    if "--help-mca" in argv:
        # import the modules that register parameters so help is complete
        from . import native  # noqa: F401
        from .comm import pttel, remote_dep  # noqa: F401
        from .core import context, scheduler, termdet, vpmap  # noqa: F401
        from .data import arena  # noqa: F401
        from .device import cuda, device  # noqa: F401
        from .dsl import dtd  # noqa: F401
        from .utils import trace, xla_trace, zone_malloc  # noqa: F401
        print(mca.params.help_text())
        return 0
    if "--devices" in argv:
        from .core.context import Context
        ctx = Context(nb_cores=1, device="cpu" if "--cpu" in argv else "cuda")
        for d in ctx.devices.devices:
            where = getattr(d, "torch_device", None)
            print(f"{d.device_index}: {d.name} type={d.type:#x}"
                  + (f" on {where}" if where is not None else ""))
        ctx.fini()
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
