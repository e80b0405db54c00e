"""The ptgpp-role CLI (ref: tools/ptgpp), run as
``python -m parsec_tpu_torch.dsl.ptg.cli``.

The reference's ptgpp translates a .jdf file to C; here PTG sources are
host-language strings compiled at runtime, so the CLI's job is the
*front-half* of that role: parse + class-build a ``.ptg`` file, report its
task classes, parameter spaces, flows and dependency structure, and fail
with ptgpp-style diagnostics on bad input — the compile gate a build
system can run without executing the program.

Usage::

    python -m parsec_tpu_torch.dsl.ptg.cli program.ptg    # check + summary
    python -m parsec_tpu_torch.dsl.ptg.cli program.ptg --globals N=4
                                                 # also count the task space
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parsec_tpu_torch.dsl.ptg.cli",
        description="compile-check a PTG source file (the ptgpp role)")
    ap.add_argument("source", help=".ptg source file")
    ap.add_argument("--globals", nargs="*", default=[], metavar="NAME=INT",
                    help="global values; enables task-space enumeration")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="exit status only")
    opts = ap.parse_args(argv)

    from . import parser as P

    try:
        src = open(opts.source).read()
    except OSError as e:
        print(f"ptgc: {e}", file=sys.stderr)
        return 2
    try:
        spec = P.parse(src, opts.source)
    except P.PTGSyntaxError as e:
        print(f"ptgc: {e}", file=sys.stderr)
        return 1

    if not opts.quiet:
        print(f"{opts.source}: {len(spec.task_classes)} task class(es)")
        for tcs in spec.task_classes:
            flows = ", ".join(f"{f.access} {f.name}" for f in tcs.flows)
            print(f"  {tcs.name}({', '.join(tcs.params)})"
                  + (f"  [{flows}]" if flows else "  [flowless]"))

    if opts.globals:
        from ...core.context import Context
        from .compiler import PTGProgram
        g = {}
        for item in opts.globals:
            name, _, val = item.partition("=")
            g[name] = int(val)
        ctx = Context(nb_cores=1, device="cpu")   # counts, runs nothing
        try:
            tp = PTGProgram(spec).instantiate(ctx, globals=g, collections={},
                                              name="ptgc-check")
            total = sum(1 for _ in tp._enumerate())
            if not opts.quiet:
                print(f"  task space under {g}: {total} task(s)")
        finally:
            ctx.fini(timeout=10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
