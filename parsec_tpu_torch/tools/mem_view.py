"""Memory-over-time from a trace: the dbp2mem role.

Re-design of the reference's dbp2mem (tools/profiling/dbp2mem.c): read a
PBP/PTF2 trace, extract the ``*::mem`` residency POINT events the device
LRU emits (``resident{q};delta{q}`` — post-change occupancy in bytes), and
render memory occupancy over time — as rows, CSV (the reference emits a
gnuplot-ready table), or a standalone step-line SVG per device stream.

CLI::

    python -m parsec_tpu_torch.tools.mem_view trace.pbp            # summary
    python -m parsec_tpu_torch.tools.mem_view trace.pbp --csv m.csv
    python -m parsec_tpu_torch.tools.mem_view trace.pbp --svg m.svg
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

from .trace_reader import TraceData, read_trace


def memory_timeline(trace: TraceData) -> List[Dict[str, Any]]:
    """All residency-change events, time-ordered: one row per ``*::mem``
    POINT event with {t, stream, resident, delta} (t relative to trace
    start, bytes)."""
    mem_keys = {}
    for d in trace.dictionary:
        if d["name"].endswith("::mem") and d["fields"]:
            mem_keys[d["key"]] = d
    rows: List[Dict[str, Any]] = []
    for stream in trace.streams:
        for key, eid, tpid, t, flags, info in stream["events"]:
            d = mem_keys.get(key >> 1)
            if d is None or not info:
                continue
            vals = dict(zip((n for n, _ in d["fields"]),
                            struct.unpack(d["fmt"], info)))
            rows.append({"t": t - trace.t0, "stream": stream["name"],
                         "resident": vals.get("resident", 0),
                         "delta": vals.get("delta", 0)})
    rows.sort(key=lambda r: r["t"])
    return rows


def summarize(trace: TraceData) -> Dict[str, Dict[str, int]]:
    """Per-stream occupancy stats: events, peak/final residency, total
    allocated/freed bytes."""
    out: Dict[str, Dict[str, int]] = {}
    for r in memory_timeline(trace):
        s = out.setdefault(r["stream"], {"events": 0, "peak": 0, "final": 0,
                                         "allocated": 0, "freed": 0})
        s["events"] += 1
        s["peak"] = max(s["peak"], r["resident"])
        s["final"] = r["resident"]
        if r["delta"] >= 0:
            s["allocated"] += r["delta"]
        else:
            s["freed"] -= r["delta"]
    return out


def to_csv(trace: TraceData) -> str:
    lines = ["t_seconds,stream,resident_bytes,delta_bytes"]
    for r in memory_timeline(trace):
        lines.append(f"{r['t']:.9f},{r['stream']},{r['resident']},"
                     f"{r['delta']}")
    return "\n".join(lines) + "\n"


def to_svg(trace: TraceData, width: int = 900, height: int = 300) -> str:
    """Standalone step-line SVG: one polyline per stream, residency (bytes)
    over time."""
    rows = memory_timeline(trace)
    if not rows:
        return ("<svg xmlns='http://www.w3.org/2000/svg' width='300' "
                "height='40'><text x='8' y='24'>no memory events</text></svg>")
    t_max = max(r["t"] for r in rows) or 1e-9
    y_max = max(r["resident"] for r in rows) or 1
    pad, pw, ph = 45, width - 90, height - 90
    colors = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
              "#8c564b", "#e377c2", "#7f7f7f"]
    by_stream: Dict[str, List] = {}
    for r in rows:
        by_stream.setdefault(r["stream"], []).append(r)
    parts = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
             f"height='{height}' font-family='monospace' font-size='11'>",
             f"<rect width='{width}' height='{height}' fill='white'/>",
             f"<line x1='{pad}' y1='{pad + ph}' x2='{pad + pw}' "
             f"y2='{pad + ph}' stroke='black'/>",
             f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{pad + ph}' "
             f"stroke='black'/>",
             f"<text x='{pad}' y='{pad - 18}' font-size='13'>device memory "
             f"residency (peak {y_max:,} B, {t_max * 1e3:.1f} ms)</text>"]

    def x(t):
        return pad + t / t_max * pw

    def y(v):
        return pad + ph - v / y_max * ph

    for i, (sname, srows) in enumerate(sorted(by_stream.items())):
        c = colors[i % len(colors)]
        pts, last = [], 0
        pts.append(f"{x(0):.1f},{y(0):.1f}")
        for r in srows:
            pts.append(f"{x(r['t']):.1f},{y(last):.1f}")      # step
            pts.append(f"{x(r['t']):.1f},{y(r['resident']):.1f}")
            last = r["resident"]
        pts.append(f"{x(t_max):.1f},{y(last):.1f}")
        parts.append(f"<polyline points='{' '.join(pts)}' fill='none' "
                     f"stroke='{c}' stroke-width='1.5'/>")
        parts.append(f"<text x='{pad + pw - 150}' y='{pad + 14 + 14 * i}' "
                     f"fill='{c}'>{sname}</text>")
    parts.append("</svg>")
    return "\n".join(parts)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Render device-memory occupancy over time from a trace "
                    "(the dbp2mem role)")
    ap.add_argument("trace", help="PBP file or PTF2 archive directory")
    ap.add_argument("--csv", metavar="PATH",
                    help="write a gnuplot/pandas-ready CSV")
    ap.add_argument("--svg", metavar="PATH", help="write a step-line SVG")
    args = ap.parse_args(argv)

    trace = read_trace(args.trace)
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(to_csv(trace))
        print(f"wrote {args.csv}")
    if args.svg:
        with open(args.svg, "w") as f:
            f.write(to_svg(trace))
        print(f"wrote {args.svg}")
    for sname, s in sorted(summarize(trace).items()):
        print(f"{sname}: {s['events']} events, peak {s['peak']:,} B, "
              f"final {s['final']:,} B, allocated {s['allocated']:,} B, "
              f"freed {s['freed']:,} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
