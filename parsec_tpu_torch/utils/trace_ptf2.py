"""PTF2: the second trace backend — an archive of definitions +
per-location event files.

NAMING IS DELIBERATE AND HONEST: PTF2 is a PRIVATE format that follows
OTF2's *architecture* (anchor + global defs + per-location event files,
varint/delta encodings) but is NOT the OTF2 interchange format — neither
``otf2-print`` nor Vampir can read it. Interop with external tooling goes
through ``tools/trace_reader`` (pandas tables, Chrome ``chrome://tracing``
JSON). The reference's profiling_otf2.c (1316 LoC) emits real OTF2 by
linking the OTF2 library; no such library exists in this stack, and
hand-emitting the full interchange format is out of scope — so the feature
is named for what it is.

Re-design of the reference's second profiling backend (parsec/profiling_otf2.c):
the SAME tracer API (dictionary keywords, per-stream buffers,
:class:`parsec_tpu_torch.utils.trace.Profiling`) can be written out in a second,
structurally different format. Where PBP is a single flat file of
fixed-width records, the PTF2 archive follows OTF2's architecture:

* ``<name>.ptf2/`` — an archive **directory** (OTF2 archives are directories)
* ``anchor.json`` — the anchor file: format/version, clock properties,
  definition and location counts (OTF2's anchor file role)
* ``global.defs`` — global definitions: a string table, region definitions
  (one per dictionary keyword, referencing strings by index, carrying the
  info-struct descriptor), and location definitions (one per stream)
* ``loc_<i>.evt`` — one event file per location (stream), records carrying
  **varint-encoded fields and delta-encoded integer timestamps** in
  nanosecond ticks (OTF2 encodes event time as integer ticks with a clock
  resolution from the anchor; PBP stores absolute float seconds)

Select with ``--mca profile_backend otf2`` — :meth:`Profiling.dump` then
writes an archive instead of a PBP file. ``tools/trace_reader.read_trace``
reads either format into the same in-memory model, so the whole analysis
pipeline (pandas tables, Chrome trace, check-comms) is format-agnostic —
the property the reference gets from OTF2 tooling interop.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, List, Tuple

MAGIC_DEFS = b"PTF2DEF1"
MAGIC_EVT = b"PTF2EVT1"
TICKS_PER_SECOND = 1_000_000_000       # ns resolution, like OTF2 archives


# ------------------------------------------------------------- varints

def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_varint(buf: io.BytesIO, n: int) -> None:
    """LEB128 unsigned varint (OTF2 uses the same compression idea)."""
    if n < 0:
        raise ValueError("unsigned varint")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes((b | 0x80,)))
        else:
            buf.write(bytes((b,)))
            return


def write_svarint(buf: io.BytesIO, n: int) -> None:
    write_varint(buf, _zigzag(n))


def read_varint(raw: bytes, off: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = raw[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def read_svarint(raw: bytes, off: int) -> Tuple[int, int]:
    n, off = read_varint(raw, off)
    return _unzigzag(n), off


# ------------------------------------------------------------- writing

def _write_string_table(buf: io.BytesIO, strings: List[str]) -> None:
    write_varint(buf, len(strings))
    for s in strings:
        raw = s.encode()
        write_varint(buf, len(raw))
        buf.write(raw)


def write_archive(prof, path: str) -> str:
    """Write ``prof`` (a :class:`Profiling`) as a PTF2 archive directory.

    The layout mirrors OTF2: anchor + global defs + per-location events
    (ref: profiling_otf2.c's archive/def-writer/evt-writer structure).
    """
    if path.endswith(".pbp"):
        path = path[:-4]
    if not path.endswith(".ptf2"):
        path = path + ".ptf2"
    os.makedirs(path, exist_ok=True)

    with prof._lock:
        entries = sorted(prof._dict.values(), key=lambda e: e.key)
        streams = list(prof._streams)

        # ---- global definitions: strings, regions, locations ----
        strings: List[str] = []
        sidx: Dict[str, int] = {}

        def intern(s: str) -> int:
            if s not in sidx:
                sidx[s] = len(strings)
                strings.append(s)
            return sidx[s]

        regions = [(e.key, intern(e.name), intern(e.attr),
                    intern(e.info_desc)) for e in entries]
        locations = [(s.stream_id, intern(s.name), len(s.events))
                     for s in streams]

        defs = io.BytesIO()
        defs.write(MAGIC_DEFS)
        _write_string_table(defs, strings)
        write_varint(defs, len(regions))
        for key, name_i, attr_i, desc_i in regions:
            for v in (key, name_i, attr_i, desc_i):
                write_varint(defs, v)
        write_varint(defs, len(locations))
        for loc_id, name_i, nev in locations:
            for v in (loc_id, name_i, nev):
                write_varint(defs, v)
        with open(os.path.join(path, "global.defs"), "wb") as f:
            f.write(defs.getvalue())

        # ---- per-location event files: delta-encoded tick timestamps ----
        for s in streams:
            evt = io.BytesIO()
            evt.write(MAGIC_EVT)
            write_varint(evt, s.stream_id)
            write_varint(evt, len(s.events))
            last_ticks = 0
            for key, eid, tpid, t, flags, info in s.events:
                ticks = int(round((t - prof.t0) * TICKS_PER_SECOND))
                write_varint(evt, key)
                write_svarint(evt, eid)
                write_varint(evt, tpid)
                write_svarint(evt, ticks - last_ticks)
                last_ticks = ticks
                write_varint(evt, flags)
                write_varint(evt, len(info))
                evt.write(info)
            with open(os.path.join(path, f"loc_{s.stream_id}.evt"), "wb") as f:
                f.write(evt.getvalue())

        anchor = {
            "format": "PTF2",
            "version": 1,
            "clock": {"t0": prof.t0, "ticks_per_second": TICKS_PER_SECOND},
            "num_definitions": len(entries),
            "num_locations": len(streams),
        }
        with open(os.path.join(path, "anchor.json"), "w") as f:
            json.dump(anchor, f, indent=1)
    return path


# ------------------------------------------------------------- reading

def read_archive(path: str) -> Dict[str, Any]:
    """Read a PTF2 archive back into the {t0, dictionary, streams} model
    (the same shape tools.trace_reader builds from PBP files)."""
    with open(os.path.join(path, "anchor.json")) as f:
        anchor = json.load(f)
    if anchor.get("format") != "PTF2":
        raise ValueError(f"{path}: not a PTF2 archive")
    tps = anchor["clock"]["ticks_per_second"]
    t0 = anchor["clock"]["t0"]

    raw = open(os.path.join(path, "global.defs"), "rb").read()
    if raw[:8] != MAGIC_DEFS:
        raise ValueError(f"{path}: bad defs magic {raw[:8]!r}")
    off = 8
    nstr, off = read_varint(raw, off)
    strings: List[str] = []
    for _ in range(nstr):
        n, off = read_varint(raw, off)
        strings.append(raw[off:off + n].decode())
        off += n
    nreg, off = read_varint(raw, off)
    dictionary: List[Dict[str, Any]] = []
    for _ in range(nreg):
        key, off = read_varint(raw, off)
        name_i, off = read_varint(raw, off)
        attr_i, off = read_varint(raw, off)
        desc_i, off = read_varint(raw, off)
        dictionary.append({"key": key, "name": strings[name_i],
                           "attr": strings[attr_i],
                           "info_desc": strings[desc_i]})
    nloc, off = read_varint(raw, off)
    loc_meta: List[Tuple[int, str, int]] = []
    for _ in range(nloc):
        loc_id, off = read_varint(raw, off)
        name_i, off = read_varint(raw, off)
        nev, off = read_varint(raw, off)
        loc_meta.append((loc_id, strings[name_i], nev))

    streams: List[Dict[str, Any]] = []
    for loc_id, name, nev in loc_meta:
        raw = open(os.path.join(path, f"loc_{loc_id}.evt"), "rb").read()
        if raw[:8] != MAGIC_EVT:
            raise ValueError(f"{path}/loc_{loc_id}.evt: bad magic")
        off = 8
        got_id, off = read_varint(raw, off)
        if got_id != loc_id:
            raise ValueError(f"loc_{loc_id}.evt claims location {got_id}")
        n, off = read_varint(raw, off)
        if n != nev:
            raise ValueError(f"loc_{loc_id}.evt holds {n} events, "
                             f"defs say {nev}")
        events = []
        ticks = 0
        for _ in range(n):
            key, off = read_varint(raw, off)
            eid, off = read_svarint(raw, off)
            tpid, off = read_varint(raw, off)
            dticks, off = read_svarint(raw, off)
            ticks += dticks
            flags, off = read_varint(raw, off)
            ilen, off = read_varint(raw, off)
            info = raw[off:off + ilen]
            off += ilen
            events.append((key, eid, tpid, t0 + ticks / tps, flags, info))
        streams.append({"name": name, "events": events})
    return {"t0": t0, "dictionary": dictionary, "streams": streams}
