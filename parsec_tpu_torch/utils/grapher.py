"""DAG grapher: emit DOT of the executed task graph.

Re-design of parsec/parsec_prof_grapher.c (enabled by ``--mca profile_dot``
in the reference, parsec.c:618): a PINS-driven recorder capturing every
task execution and every released dependency edge, dumped as GraphViz DOT.
Enable one on a context (``DotGrapher().enable(ctx)``); no MCA parameter
turns it on.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple

from ..core import pins as P

_COLORS = ["#4c72b0", "#dd8452", "#55a868", "#c44e52", "#8172b3",
           "#937860", "#da8bc3", "#8c8c8c", "#ccb974", "#64b5cd"]


class DotGrapher:
    """Record executed tasks + dataflow edges; render DOT."""

    def __init__(self) -> None:
        self._nodes: Dict[str, Tuple[str, int]] = {}   # label -> (class, th)
        self._edges: Set[Tuple[str, str, str]] = set()
        self._lock = threading.Lock()

    def enable(self, context) -> None:
        self.context = context
        context.pins.register(P.EXEC_BEGIN, self._on_exec)
        context.pins.register(P.RELEASE_DEPS_BEGIN, self._on_release)

    def disable(self, context) -> None:
        context.pins.unregister(P.EXEC_BEGIN, self._on_exec)
        context.pins.unregister(P.RELEASE_DEPS_BEGIN, self._on_release)

    @staticmethod
    def _label(task) -> str:
        loc = "_".join(str(v) for v in task.locals.values())
        if not loc:
            # DTD tasks carry no named locals; their identity is the
            # insertion index
            ident = getattr(task, "ident", None)
            loc = str(ident) if ident is not None else ""
        return f"{task.task_class.name}_{loc}" if loc else task.task_class.name

    def _on_exec(self, stream, task, extra) -> None:
        with self._lock:
            self._nodes[self._label(task)] = (task.task_class.name,
                                              getattr(stream, "th_id", 0))

    def _on_release(self, stream, task, extra) -> None:
        src = self._label(task)
        tc = task.task_class
        # DTD tasks carry explicit successor lists; PTG tasks declarative deps
        succs = getattr(task, "successors", None)
        with self._lock:
            if succs:
                for s in succs:
                    self._edges.add((src, self._label(s), ""))
                return
            for flow in tc.flows:
                for dep in flow.deps_out:
                    if dep.task_class is None:
                        continue
                    if dep.cond is not None and not dep.cond(task.locals):
                        continue
                    targets = dep.target_locals(task.locals) if dep.target_locals \
                        else [task.locals]
                    if isinstance(targets, dict):
                        targets = [targets]
                    for tl in targets:
                        loc = "_".join(str(v) for v in tl.values())
                        dst = f"{dep.task_class.name}_{loc}" if loc else dep.task_class.name
                        self._edges.add((src, dst, flow.name))

    def to_dot(self, name: str = "parsec_tpu_torch") -> str:
        with self._lock:
            classes = sorted({c for c, _ in self._nodes.values()})
            color = {c: _COLORS[i % len(_COLORS)] for i, c in enumerate(classes)}
            lines = [f"digraph {name} {{", "  rankdir=TB;",
                     "  node [style=filled, fontname=monospace];"]
            for label, (cls, th) in sorted(self._nodes.items()):
                lines.append(f'  "{label}" [fillcolor="{color[cls]}", '
                             f'tooltip="thread {th}"];')
            for src, dst, flow in sorted(self._edges):
                attr = f' [label="{flow}"]' if flow else ""
                lines.append(f'  "{src}" -> "{dst}"{attr};')
            lines.append("}")
            return "\n".join(lines)

    def dump(self, path: str) -> str:
        dot = self.to_dot()
        with open(path, "w") as f:
            f.write(dot)
        return path

    # -------------------------------------------------------- image render
    def _layers(self) -> List[List[str]]:
        """Longest-path layering of the recorded DAG (topological rows)."""
        with self._lock:
            nodes = set(self._nodes)
            preds: Dict[str, List[str]] = {n: [] for n in nodes}
            succs: Dict[str, List[str]] = {n: [] for n in nodes}
            for s, d, _ in self._edges:
                if s in nodes and d in nodes:
                    preds[d].append(s)
                    succs[s].append(d)
        depth: Dict[str, int] = {}
        remaining = dict((n, len(preds[n])) for n in nodes)
        frontier = [n for n, c in remaining.items() if c == 0]
        while frontier:
            nxt = []
            for n in frontier:
                depth.setdefault(n, 0)
                for m in succs[n]:
                    depth[m] = max(depth.get(m, 0), depth[n] + 1)
                    remaining[m] -= 1
                    if remaining[m] == 0:
                        nxt.append(m)
            frontier = nxt
        for n in nodes:           # cycles/unreached degrade to layer 0
            depth.setdefault(n, 0)
        by_layer: Dict[int, List[str]] = {}
        for n, d in depth.items():
            by_layer.setdefault(d, []).append(n)
        return [sorted(by_layer[d]) for d in sorted(by_layer)]

    def to_svg(self, name: str = "parsec_tpu_torch") -> str:
        """Self-contained SVG of the executed DAG: layered layout, one color
        per task class, straight dependency edges — the dbp-dot2png role
        (ref: tools/profiling dbp-dot2png) without an external graphviz."""
        layers = self._layers()
        with self._lock:
            nodes = dict(self._nodes)
            edges = sorted(self._edges)
        classes = sorted({c for c, _ in nodes.values()})
        color = {c: _COLORS[i % len(_COLORS)] for i, c in enumerate(classes)}
        bw, bh, hgap, vgap, pad = 130, 28, 24, 56, 20
        pos: Dict[str, Tuple[float, float]] = {}
        width = pad * 2 + max((len(l) for l in layers), default=1) * (bw + hgap)
        for li, layer in enumerate(layers):
            row_w = len(layer) * (bw + hgap) - hgap
            x0 = (width - row_w) / 2
            for ni, n in enumerate(layer):
                pos[n] = (x0 + ni * (bw + hgap), pad + li * (bh + vgap))
        height = pad * 2 + len(layers) * (bh + vgap) - vgap if layers else pad * 2
        out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
               f'height="{height}" font-family="monospace" font-size="11">',
               f'<title>{name}</title>',
               '<defs><marker id="arr" markerWidth="8" markerHeight="8" '
               'refX="7" refY="3" orient="auto"><path d="M0,0 L7,3 L0,6 z" '
               'fill="#555"/></marker></defs>']
        for s, d, flow in edges:
            if s not in pos or d not in pos:
                continue
            x1, y1 = pos[s][0] + bw / 2, pos[s][1] + bh
            x2, y2 = pos[d][0] + bw / 2, pos[d][1]
            out.append(f'<line x1="{x1:.0f}" y1="{y1:.0f}" x2="{x2:.0f}" '
                       f'y2="{y2:.0f}" stroke="#555" stroke-width="1" '
                       f'marker-end="url(#arr)"/>')
            if flow:
                out.append(f'<text x="{(x1+x2)/2:.0f}" y="{(y1+y2)/2:.0f}" '
                           f'fill="#555">{flow}</text>')
        for n, (x, y) in pos.items():
            cls, th = nodes[n]
            out.append(f'<rect x="{x:.0f}" y="{y:.0f}" width="{bw}" '
                       f'height="{bh}" rx="6" fill="{color[cls]}" '
                       f'stroke="#333"><title>thread {th}</title></rect>')
            label = n if len(n) <= 18 else n[:17] + "…"
            out.append(f'<text x="{x + bw/2:.0f}" y="{y + bh/2 + 4:.0f}" '
                       f'text-anchor="middle" fill="#fff">{label}</text>')
        out.append("</svg>")
        return "\n".join(out)

    def dump_svg(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_svg())
        return path
