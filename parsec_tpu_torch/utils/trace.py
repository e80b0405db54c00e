"""Profiling: per-stream event buffers → binary trace files.

Re-design of parsec/profiling.{c,h} + the dbp binary format
(parsec/parsec_binary_profile.h): events are (key, event_id, taskpool_id,
timestamp, flags, optional typed info blob) recorded into per-stream buffers
with a process-wide **dictionary** of keywords; begin/end pairs share a key
with the low bit distinguishing START/END (ref: KEY_START/KEY_END macros).
Files carry a header, the dictionary, then per-stream event blocks — the
"PBP" (parsec binary profile) format, read back by
:mod:`parsec_tpu_torch.tools.trace_reader` (the PBT→PTT pandas pipeline role).

Info blobs are described by a struct-format string in the dictionary entry
(e.g. ``"src{i};dst{i};size{q}"`` — the reference uses the same idea with C
type names, remote_dep_mpi.c:1286-1302).

Device note: the CUDA device module gets its own profiling stream like the
reference's per-GPU-stream profiling (profiling.h:146-440); kernel-level
timing on the card belongs to torch.profiler — this module covers the
runtime-event layer.
"""

from __future__ import annotations

import io
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import mca, output

mca.register("profile_enabled", False, "Record runtime events", type=bool)
mca.register("profile_filename", "parsec_tpu_torch.pbp", "Trace output path")
mca.register("profile_backend", "pbp",
             "Trace output format: 'pbp' (flat binary file) or 'ptf2' "
             "(archive directory following OTF2's architecture: anchor + "
             "global defs + per-location event files — a PRIVATE format, "
             "not OTF2 interchange; the profiling_otf2.c role). 'otf2' is "
             "accepted as a deprecated alias and warns.", type=str)

MAGIC = b"PTPBP001"

EVENT_FLAG_START = 0x1
EVENT_FLAG_END = 0x2
EVENT_FLAG_POINT = 0x4

_INFO_TYPES = {"i": "i", "q": "q", "d": "d", "f": "f"}


def parse_info_desc(desc: str) -> Tuple[List[Tuple[str, str]], str]:
    """``"src{i};dst{i};size{q}"`` -> ([(name, code)...], struct_fmt)."""
    fields: List[Tuple[str, str]] = []
    fmt = "<"
    if desc:
        for part in desc.split(";"):
            part = part.strip()
            if not part:
                continue
            name, _, ty = part.partition("{")
            ty = ty.rstrip("}")
            if ty not in _INFO_TYPES:
                raise ValueError(f"unsupported info type {ty!r} in {desc!r}")
            fields.append((name, ty))
            fmt += _INFO_TYPES[ty]
    return fields, fmt


@dataclass
class DictEntry:
    """One dictionary keyword (ref: dbp dictionary entries)."""
    key: int
    name: str
    attr: str = ""          # color attribute in the reference
    info_desc: str = ""     # struct descriptor for the info blob
    fields: List[Tuple[str, str]] = field(default_factory=list)
    fmt: str = "<"


class ProfilingStream:
    """Per-thread/per-device-stream event buffer (ref: per-ES buffers)."""

    __slots__ = ("name", "stream_id", "events")

    def __init__(self, name: str, stream_id: int) -> None:
        self.name = name
        self.stream_id = stream_id
        self.events: List[Tuple[int, int, int, float, int, bytes]] = []

    def trace(self, key: int, event_id: int, taskpool_id: int,
              flags: int, info: bytes = b"") -> None:
        """parsec_profiling_trace_flags equivalent."""
        self.events.append((key, event_id, taskpool_id,
                            time.perf_counter(), flags, info))


class Profiling:
    """Process-wide tracer (ref: parsec_profiling_init / dbp_start)."""

    def __init__(self) -> None:
        self._dict: Dict[str, DictEntry] = {}
        self._streams: List[ProfilingStream] = []
        self._lock = threading.Lock()
        self._next_key = 0
        self.t0 = time.perf_counter()
        self.enabled = True

    # -- dictionary -----------------------------------------------------------
    def add_dictionary_keyword(self, name: str, attr: str = "",
                               info_desc: str = "") -> Tuple[int, int]:
        """Returns (start_key, end_key) like the reference
        (parsec_profiling_add_dictionary_keyword)."""
        with self._lock:
            e = self._dict.get(name)
            if e is None:
                fields, fmt = parse_info_desc(info_desc)
                e = DictEntry(self._next_key, name, attr, info_desc, fields, fmt)
                self._dict[name] = e
                self._next_key += 1
        return (e.key << 1) | 0, (e.key << 1) | 1

    def keyword(self, name: str) -> Optional[DictEntry]:
        return self._dict.get(name)

    # -- streams ---------------------------------------------------------------
    def stream(self, name: str) -> ProfilingStream:
        """parsec_profiling_stream_init: one buffer per thread/device stream."""
        with self._lock:
            s = ProfilingStream(name, len(self._streams))
            self._streams.append(s)
            return s

    def pack_info(self, keyword: str, **kw) -> bytes:
        e = self._dict[keyword]
        if not e.fields:
            return b""
        return struct.pack(e.fmt, *[kw.get(n, 0) for n, _ in e.fields])

    # -- output ------------------------------------------------------------------
    def dump(self, path: Optional[str] = None,
             backend: Optional[str] = None) -> str:
        """Write the trace (ref: dbp file writing at parsec_fini). The
        backend — flat PBP file or PTF2 archive (OTF2-architecture,
        private format) — is chosen by
        ``backend`` / ``--mca profile_backend`` (profiling_otf2.c role)."""
        path = path or mca.get("profile_filename", "parsec_tpu_torch.pbp")
        backend = backend or mca.get("profile_backend", "pbp")
        if backend == "otf2":
            output.warning(
                "profile_backend 'otf2' is a deprecated alias for 'ptf2' — "
                "the archive follows OTF2's architecture but is NOT "
                "readable by OTF2 tools (use tools/trace_reader)")
            backend = "ptf2"
        if backend == "ptf2":
            from .trace_ptf2 import write_archive
            return write_archive(self, path)
        if backend != "pbp":
            raise ValueError(f"unknown profile_backend {backend!r}")
        with self._lock:
            buf = io.BytesIO()
            buf.write(MAGIC)
            buf.write(struct.pack("<dII", self.t0, len(self._dict),
                                  len(self._streams)))
            for e in sorted(self._dict.values(), key=lambda e: e.key):
                for text in (e.name, e.attr, e.info_desc):
                    raw = text.encode()
                    buf.write(struct.pack("<I", len(raw)))
                    buf.write(raw)
            for s in self._streams:
                raw = s.name.encode()
                buf.write(struct.pack("<I", len(raw)))
                buf.write(raw)
                buf.write(struct.pack("<I", len(s.events)))
                for key, eid, tpid, t, flags, info in s.events:
                    buf.write(struct.pack("<IqIdII", key, eid, tpid, t, flags,
                                          len(info)))
                    buf.write(info)
            data = buf.getvalue()
        with open(path, "wb") as f:
            f.write(data)
        output.debug_verbose(1, "profiling", f"trace written to {path}")
        return path

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "streams": len(self._streams),
                "keywords": len(self._dict),
                "events": sum(len(s.events) for s in self._streams),
            }
