"""Trace analysis pipeline: PBP binary traces → tables / Chrome trace.

Re-design of the reference's profiling toolchain (tools/profiling):
``dbpreader`` + the Cython PBT→PTT pandas pipeline (pbt2ptt.pyx,
parsec_trace_tables.py) and the Chrome-trace converter (h5toctf.py):

* :func:`read_pbp` — parse the binary trace into dictionary + event records.
* :func:`to_dataframe` — pandas "trace tables": one row per matched
  begin/end interval with stream, taskpool, duration, unpacked info fields.
* :func:`to_chrome_trace` — chrome://tracing / Perfetto JSON.
* CLI: ``python -m parsec_tpu_torch.tools.trace_reader trace.pbp [--ctf out.json]``.
"""

from __future__ import annotations

import json
import struct
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..utils.trace import EVENT_FLAG_POINT, MAGIC, parse_info_desc


@dataclass
class TraceData:
    t0: float
    dictionary: List[Dict[str, Any]]
    streams: List[Dict[str, Any]]   # {name, events: [(key,eid,tp,t,flags,info)]}


def read_pbp(path: str) -> TraceData:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != MAGIC:
        raise ValueError(f"{path}: not a PBP trace (magic {raw[:8]!r})")
    off = 8
    t0, ndict, nstreams = struct.unpack_from("<dII", raw, off)
    off += struct.calcsize("<dII")

    def read_str() -> str:
        nonlocal off
        (n,) = struct.unpack_from("<I", raw, off)
        off += 4
        s = raw[off:off + n].decode()
        off += n
        return s

    dictionary = []
    for key in range(ndict):
        name, attr, info_desc = read_str(), read_str(), read_str()
        fields, fmt = parse_info_desc(info_desc)
        dictionary.append({"key": key, "name": name, "attr": attr,
                           "info_desc": info_desc, "fields": fields,
                           "fmt": fmt})
    streams = []
    for _ in range(nstreams):
        name = read_str()
        (nev,) = struct.unpack_from("<I", raw, off)
        off += 4
        events = []
        for _ in range(nev):
            key, eid, tpid, t, flags, ilen = struct.unpack_from("<IqIdII", raw, off)
            off += struct.calcsize("<IqIdII")
            info = raw[off:off + ilen]
            off += ilen
            events.append((key, eid, tpid, t, flags, info))
        streams.append({"name": name, "events": events})
    return TraceData(t0, dictionary, streams)


def _intervals(trace: TraceData):
    """Match begin/end pairs per (stream, base key, event id); POINT
    events (e.g. the native lanes' ``ptdtd::task`` completion marks)
    yield as zero-duration intervals."""
    for si, stream in enumerate(trace.streams):
        open_ev: Dict[Tuple[int, int], Tuple[float, bytes, int]] = {}
        for key, eid, tpid, t, flags, info in stream["events"]:
            base, is_end = key >> 1, key & 1
            if flags & EVENT_FLAG_POINT:
                yield si, stream["name"], base, eid, tpid, t, t, info
            elif not is_end:
                open_ev[(base, eid)] = (t, info, tpid)
            else:
                start = open_ev.pop((base, eid), None)
                if start is None:
                    continue
                t_s, info_s, tpid_s = start
                yield si, stream["name"], base, eid, tpid_s, t_s, t, info_s


def to_dataframe(trace: TraceData):
    """The PTT role: one pandas row per begin/end interval."""
    import pandas as pd
    rows = []
    for si, sname, base, eid, tpid, t_s, t_e, info in _intervals(trace):
        d = trace.dictionary[base]
        row = {
            "stream": sname,
            "stream_id": si,
            "name": d["name"],
            "event_id": eid,
            "taskpool_id": tpid,
            "begin": t_s - trace.t0,
            "end": t_e - trace.t0,
            "duration": t_e - t_s,
        }
        if d["fields"] and info:
            vals = struct.unpack(d["fmt"], info)
            row.update({fname: v for (fname, _), v in zip(d["fields"], vals)})
        rows.append(row)
    return pd.DataFrame(rows)


def to_chrome_trace(trace: TraceData) -> Dict[str, Any]:
    """Chrome trace-event JSON (the h5toctf.py role): load into Perfetto."""
    events = []
    for si, sname, base, eid, tpid, t_s, t_e, info in _intervals(trace):
        d = trace.dictionary[base]
        if t_e == t_s:          # POINT events render as thread instants
            events.append({
                "name": d["name"],
                "cat": f"taskpool{tpid}",
                "ph": "i",
                "s": "t",
                "ts": (t_s - trace.t0) * 1e6,
                "pid": 0,
                "tid": si,
                "args": {"event_id": eid},
            })
            continue
        events.append({
            "name": d["name"],
            "cat": f"taskpool{tpid}",
            "ph": "X",
            "ts": (t_s - trace.t0) * 1e6,
            "dur": (t_e - t_s) * 1e6,
            "pid": 0,
            "tid": si,
            "args": {"event_id": eid},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": si,
             "args": {"name": s["name"]}}
            for si, s in enumerate(trace.streams)]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


_SVG_COLORS = ["#4c72b0", "#dd8452", "#55a868", "#c44e52", "#8172b3",
               "#937860", "#da8bc3", "#8c8c8c", "#ccb974", "#64b5cd"]


def to_animated_svg(trace: TraceData, playback_s: float = 5.0) -> str:
    """Self-contained animated SVG: a Gantt of the execution that draws
    itself in playback order (SMIL timing) — the role of the reference's
    trace animation tool (tools/profiling/animation.c), with no external
    renderer. One lane per stream, one color per keyword; each task
    interval fades in at its (scaled) begin time."""
    ivs = list(_intervals(trace))
    if not ivs:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"
    t0 = min(iv[5] for iv in ivs)
    t1 = max(iv[6] for iv in ivs)
    span = max(t1 - t0, 1e-9)
    lane_h, pad, width = 26, 30, 960
    lanes = len(trace.streams)
    height = pad * 2 + lanes * lane_h
    color = {d["key"]: _SVG_COLORS[i % len(_SVG_COLORS)]
             for i, d in enumerate(trace.dictionary)}
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" font-family="monospace" font-size="10">']
    for si, s in enumerate(trace.streams):
        y = pad + si * lane_h
        out.append(f'<text x="2" y="{y + lane_h - 10}" '
                   f'fill="#333">{s["name"][:14]}</text>')
        out.append(f'<line x1="{pad + 90}" y1="{y + lane_h - 4}" '
                   f'x2="{width - 10}" y2="{y + lane_h - 4}" '
                   f'stroke="#ddd"/>')
    x0, x1 = pad + 90, width - 10
    for si, sname, base, eid, tpid, tb, te, info in ivs:
        bx = x0 + (tb - t0) / span * (x1 - x0)
        w = max((te - tb) / span * (x1 - x0), 1.0)
        y = pad + si * lane_h
        begin = (tb - t0) / span * playback_s
        name = trace.dictionary[base]["name"]
        out.append(
            f'<rect x="{bx:.1f}" y="{y + 4}" width="{w:.1f}" '
            f'height="{lane_h - 10}" fill="{color[base]}" opacity="0">'
            f'<title>{name} #{eid} [{(tb - t0)*1e3:.2f}..'
            f'{(te - t0)*1e3:.2f} ms]</title>'
            f'<set attributeName="opacity" to="0.9" '
            f'begin="{begin:.3f}s" fill="freeze"/></rect>')
    out.append("</svg>")
    return "\n".join(out)


def read_ptf2(path: str) -> TraceData:
    """Read a PTF2 archive (the OTF2-class backend) into the same model as
    PBP files, so the whole analysis pipeline is format-agnostic."""
    from ..utils.trace_ptf2 import read_archive
    d = read_archive(path)
    dictionary = []
    for e in d["dictionary"]:
        fields, fmt = parse_info_desc(e["info_desc"])
        dictionary.append({**e, "fields": fields, "fmt": fmt})
    return TraceData(d["t0"], dictionary, d["streams"])


def read_trace(path: str) -> TraceData:
    """Format dispatch: PTF2 archives are directories, PBP traces files."""
    import os
    if os.path.isdir(path):
        return read_ptf2(path)
    return read_pbp(path)


# ------------------------------------------------- multi-rank trace merge

#: the per-rank clock metadata keyword (stamped by
#: comm/remote_dep.py stamp_clock_meta): one POINT event per rank
#: carrying (rank, offset_ns to rank 0, min-RTT of the estimate)
CLOCK_KEYWORD = "meta::clock"
#: the ptcomm flow-identity keywords (csrc/ptcomm.cpp): POINT
#: events whose id encodes (peer_rank << 40) | frame_seq
FRAME_TX = "ptcomm::frame_tx"
FRAME_RX = "ptcomm::frame_rx"
_FRAME_SEQ_MASK = (1 << 40) - 1


def clock_meta(trace: TraceData) -> Optional[Dict[str, Any]]:
    """This trace's clock metadata, or None (pre-merge single-rank
    traces, or a run without a comm engine). A trace may carry several
    stamps (an incomplete ok=0 one from an early dump plus the completed
    estimate): the ok=1 record wins, else the last seen."""
    entry = next((d for d in trace.dictionary
                  if d["name"] == CLOCK_KEYWORD), None)
    if entry is None:
        return None
    best: Optional[Dict[str, Any]] = None
    for stream in trace.streams:
        for key, eid, tpid, t, flags, info in stream["events"]:
            if key >> 1 != entry["key"] or not info:
                continue
            vals = struct.unpack(entry["fmt"], info)
            meta = {name: v for (name, _), v in zip(entry["fields"], vals)}
            if meta.get("ok"):
                return meta
            best = meta
    return best


def merge_traces(paths: List[str], rebase: bool = True) -> TraceData:
    """Load N per-rank traces and merge them into ONE TraceData whose
    timestamps all live on rank 0's clock (the reference's offline
    profile merge, ``profiling-tools dbp`` merging per-rank .prof files).

    Each rank's ``meta::clock`` event supplies its rank id and its
    measured ``local - rank0`` offset (min-RTT ping-pong estimate, error
    bounded by RTT/2); ``rebase=True`` subtracts it from every timestamp.
    Traces without metadata fall back to positional rank (``paths[i]`` =
    rank i) and offset 0. Stream names gain an ``r<rank>:`` prefix and
    dictionaries are unified by keyword name, so the merged trace flows
    through the whole existing pipeline (dataframe, chrome JSON, SVG)
    unchanged."""
    traces = [read_trace(p) for p in paths]
    merged_dict: List[Dict[str, Any]] = []
    by_name: Dict[str, int] = {}
    streams: List[Dict[str, Any]] = []
    t0 = None
    for pos, trace in enumerate(traces):
        meta = clock_meta(trace)
        rank = int(meta["rank"]) if meta is not None else pos
        off = (meta["offset_ns"] * 1e-9
               if rebase and meta is not None else 0.0)
        keymap: Dict[int, int] = {}
        for d in trace.dictionary:
            nk = by_name.get(d["name"])
            if nk is None:
                nk = len(merged_dict)
                by_name[d["name"]] = nk
                merged_dict.append(dict(d, key=nk))
            keymap[d["key"]] = nk
        rt0 = trace.t0 - off
        t0 = rt0 if t0 is None else min(t0, rt0)
        for s in trace.streams:
            events = [((keymap[key >> 1] << 1) | (key & 1), eid, tpid,
                       t - off, flags, info)
                      for key, eid, tpid, t, flags, info in s["events"]]
            streams.append({"name": f"r{rank}:{s['name']}",
                            "events": events})
    return TraceData(t0 or 0.0, merged_dict, streams)


def _frame_events(trace: TraceData, keyword: str):
    """(src_rank_of_stream, peer, seq, t) for every flow-identity point.
    Rank comes from the merged ``r<rank>:`` stream-name prefix."""
    entry = next((d for d in trace.dictionary if d["name"] == keyword), None)
    if entry is None:
        return
    for stream in trace.streams:
        name = stream["name"]
        if not name.startswith("r") or ":" not in name:
            continue
        try:
            rank = int(name[1:name.index(":")])
        except ValueError:
            continue
        for key, eid, tpid, t, flags, info in stream["events"]:
            if key >> 1 != entry["key"]:
                continue
            yield rank, eid >> 40, eid & _FRAME_SEQ_MASK, t


def act_flows(trace: TraceData) -> Dict[str, Any]:
    """Pair every cross-rank activation frame's send with the peer's
    ingest in a MERGED trace: frame_tx on rank a toward peer b with
    sequence s matches frame_rx on rank b from peer a with the same s.
    Returns ``{"pairs": [(src, dst, seq, t_tx, t_rx)], "unmatched_tx",
    "unmatched_rx"}`` — the ci gate requires both unmatched lists empty
    (every cross-rank activation reads as one causal edge)."""
    tx: Dict[Tuple[int, int, int], float] = {}
    for rank, peer, seq, t in _frame_events(trace, FRAME_TX):
        tx[(rank, peer, seq)] = t
    pairs: List[Tuple[int, int, int, float, float]] = []
    unmatched_rx: List[Tuple[int, int, int]] = []
    for rank, peer, seq, t in _frame_events(trace, FRAME_RX):
        t_tx = tx.pop((peer, rank, seq), None)
        if t_tx is None:
            unmatched_rx.append((peer, rank, seq))
        else:
            pairs.append((peer, rank, seq, t_tx, t))
    return {"pairs": sorted(pairs, key=lambda p: p[3]),
            "unmatched_tx": sorted(tx),
            "unmatched_rx": sorted(unmatched_rx)}


def flow_chrome_events(trace: TraceData,
                       flows: Optional[Dict[str, Any]] = None
                       ) -> List[Dict[str, Any]]:
    """Chrome trace-event flow records ("s"/"f" phases) for the paired
    cross-rank activations, ready to extend a merged trace's
    ``traceEvents`` — Perfetto draws one arrow per frame from the
    sender's progress-thread track to the receiver's. Pass an
    :func:`act_flows` result to avoid re-scanning the events."""
    sid = {s["name"]: i for i, s in enumerate(trace.streams)}

    def tid_of(rank: int) -> int:
        # the frame points live on the ptcomm progress-thread streams
        for name, i in sid.items():
            if name.startswith(f"r{rank}:ptcomm-"):
                return i
        return 0

    if flows is None:
        flows = act_flows(trace)
    out: List[Dict[str, Any]] = []
    for src, dst, seq, t_tx, t_rx in flows["pairs"]:
        fid = f"act:{src}>{dst}#{seq}"
        out.append({"name": "xrank-activate", "cat": "ptcomm", "ph": "s",
                    "id": fid, "ts": (t_tx - trace.t0) * 1e6, "pid": 0,
                    "tid": tid_of(src)})
        out.append({"name": "xrank-activate", "cat": "ptcomm", "ph": "f",
                    "bp": "e", "id": fid, "ts": (t_rx - trace.t0) * 1e6,
                    "pid": 0, "tid": tid_of(dst)})
    return out


def merge_to_chrome(paths: List[str]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One-call merge recipe — THE home of the merge+flow invariant
    (the CLI and the ci gate both call it): N per-rank .pbp files ->
    ``(chrome_json_with_flow_arrows, act_flows_result)``."""
    merged = merge_traces(paths)
    flows = act_flows(merged)
    out = to_chrome_trace(merged)
    out["traceEvents"].extend(flow_chrome_events(merged, flows))
    return out, flows


def comm_events(trace: TraceData) -> List[Dict[str, Any]]:
    """Extract typed comm-stream events (``comm::*`` keywords) with their
    decoded src/dst/bytes info blobs (ref: the comm-thread stream written
    by remote_dep_mpi.c:1286-1302)."""
    by_key = {d["key"]: d for d in trace.dictionary}
    out: List[Dict[str, Any]] = []
    for stream in trace.streams:
        for key, eid, tpid, t, flags, info in stream["events"]:
            entry = by_key.get(key >> 1)
            if entry is None or not entry["name"].startswith("comm::"):
                continue
            ev = {"kind": entry["name"][len("comm::"):], "t": t,
                  "stream": stream["name"], "event_id": eid}
            if entry["fields"] and info:
                vals = struct.unpack(entry["fmt"], info)
                ev.update({n: v for (n, _), v in zip(entry["fields"], vals)})
            out.append(ev)
    return out


def check_comms(paths: List[str]) -> Dict[str, Any]:
    """Cross-rank validation of the comm streams (the check-comms.py role,
    ref: tests/profiling/check-comms.py): every send event recorded by one
    rank must have a matching receive on the destination rank with the
    same (src, dst, bytes), for each protocol leg (activate/get/put).

    ``paths[i]`` is rank i's PBP file. Returns a summary dict with an
    ``errors`` list (empty = consistent).
    """
    pairs = [("activate_snd", "activate_rcv"), ("get_snd", "get_rcv"),
             ("put_snd", "put_rcv")]
    per_rank = [comm_events(read_trace(p)) for p in paths]
    errors: List[str] = []
    counts: Dict[str, int] = {}
    for snd_kind, rcv_kind in pairs:
        # multiset of (src, dst, bytes) on each side
        snd: Dict[Tuple, int] = {}
        rcv: Dict[Tuple, int] = {}
        for rank, evs in enumerate(per_rank):
            for ev in evs:
                if ev["kind"] == snd_kind:
                    if ev.get("src") != rank:
                        errors.append(f"{snd_kind} recorded on rank {rank} "
                                      f"but src={ev.get('src')}")
                    k = (ev.get("src"), ev.get("dst"), ev.get("bytes"))
                    snd[k] = snd.get(k, 0) + 1
                elif ev["kind"] == rcv_kind:
                    if ev.get("dst") != rank:
                        errors.append(f"{rcv_kind} recorded on rank {rank} "
                                      f"but dst={ev.get('dst')}")
                    k = (ev.get("src"), ev.get("dst"), ev.get("bytes"))
                    rcv[k] = rcv.get(k, 0) + 1
        counts[snd_kind] = sum(snd.values())
        counts[rcv_kind] = sum(rcv.values())
        for k, n in snd.items():
            if rcv.get(k, 0) != n:
                errors.append(f"{snd_kind} {k} sent {n}x but received "
                              f"{rcv.get(k, 0)}x")
        for k, n in rcv.items():
            if k not in snd:
                errors.append(f"{rcv_kind} {k} received with no matching send")
    # protocol shape: every rendezvous put pairs with exactly one get
    if counts.get("put_snd", 0) != counts.get("get_rcv", 0):
        errors.append(f"put_snd={counts.get('put_snd')} != "
                      f"get_rcv={counts.get('get_rcv')}")
    return {"ranks": len(paths), "counts": counts, "errors": errors}


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: trace_reader <trace.pbp|archive.ptf2> "
              "[--ctf out.json] [--csv out.csv] [--svg out.svg]\n"
              "       trace_reader --check-comms <rank0.pbp> <rank1.pbp> ...\n"
              "       trace_reader --merge out.json <rank0.pbp> "
              "<rank1.pbp> ...  (clock-aligned Perfetto timeline with "
              "cross-rank flow arrows)",
              file=sys.stderr)
        return 2
    if argv[0] == "--check-comms":
        summary = check_comms(argv[1:])
        print(json.dumps(summary))
        return 1 if summary["errors"] else 0
    if argv[0] == "--merge":
        out_path, paths = argv[1], argv[2:]
        ctf, flows = merge_to_chrome(paths)
        with open(out_path, "w") as f:
            json.dump(ctf, f)
        print(f"merged {len(paths)} rank traces -> {out_path}: "
              f"{len(flows['pairs'])} cross-rank flow pairs, "
              f"{len(flows['unmatched_tx'])} unmatched tx, "
              f"{len(flows['unmatched_rx'])} unmatched rx")
        return 1 if flows["unmatched_tx"] or flows["unmatched_rx"] else 0
    trace = read_trace(argv[0])
    print(f"trace: {len(trace.dictionary)} keywords, "
          f"{len(trace.streams)} streams, "
          f"{sum(len(s['events']) for s in trace.streams)} events")
    if "--ctf" in argv:
        out = argv[argv.index("--ctf") + 1]
        with open(out, "w") as f:
            json.dump(to_chrome_trace(trace), f)
        print(f"chrome trace -> {out}")
    if "--csv" in argv:
        out = argv[argv.index("--csv") + 1]
        to_dataframe(trace).to_csv(out, index=False)
        print(f"trace tables -> {out}")
    if "--svg" in argv:
        out = argv[argv.index("--svg") + 1]
        with open(out, "w") as f:
            f.write(to_animated_svg(trace))
        print(f"animated gantt -> {out}")
    if not any(f in argv for f in ("--ctf", "--csv", "--svg")):
        df = to_dataframe(trace)
        if len(df):
            print(df.groupby("name")["duration"].describe())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
