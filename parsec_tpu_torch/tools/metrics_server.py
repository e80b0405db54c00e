"""Per-rank metrics endpoint: the counter registry over HTTP/UDS JSON.

The cross-process half of the observability plane (the counter registry
over a local endpoint, so live_view works cross-process like an ops
dashboard) — the role the reference's PINS/PAPI-SDE export plus
``tools/aggregator_visu`` demo server play: every rank runs a tiny stdlib
HTTP server (TCP on 127.0.0.1, or a unix-domain socket) serving

* ``GET /metrics``     — ``{"rank", "nb_ranks", "pid", "ts",
  "counters": {...unified registry snapshot...},
  "percentiles": {...native latency histogram summaries...}}``
* ``GET /health``      — liveness probe (``{"ok": true, "rank": r}``);
  when a stall watchdog is armed (``--mca watchdog_stall_ms``) a latched
  stall degrades it to ``ok: false`` with the attributed stall list
* ``GET /histograms``  — raw log2 bucket arrays (non-zero entries), for
  consumers that want to merge distributions instead of percentiles
* ``GET /mesh``        — rank 0 only in practice: the telemetry plane's
  tree-aggregated mesh rollup (``comm/pttel.py``) — summed counters,
  merged histogram buckets, per-rank gauges and per-rank staleness —
  with zero per-request cross-rank traffic (the data was pushed here)

Started from ``Context`` init via ``--mca metrics_port <base>`` (rank r
binds ``base + r``, loopback only) or ``--mca metrics_uds <path>``
(rank r binds ``<path>.r<r>``), torn down at fini. ``live_view`` polls
one or many rank endpoints through :func:`fetch`, which speaks plain
HTTP/1.0 over either transport, so a 2-rank run reads as one dashboard.

Everything here is stdlib-only and off the hot path: a scrape costs one
registry snapshot (the samplers are TTL-cached where they are
expensive) on a daemon thread.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, List, Optional

from ..utils import mca, output

mca.register("metrics_port", 0,
             "Serve the unified counter registry + latency percentiles "
             "as JSON on 127.0.0.1:<metrics_port + my_rank> "
             "(/metrics, /health, /histograms). 0 = disabled. Implies "
             "hist_enabled", type=int)
mca.register("metrics_uds", "",
             "Serve the metrics endpoint on a unix-domain socket at "
             "<path>.r<rank> instead of TCP. Empty = disabled", type=str)


def _json_safe(v):
    """Replace non-finite floats with None, recursively (RFC 8259 JSON
    has no NaN/Infinity)."""
    if isinstance(v, float):
        return v if v == v and v not in (float("inf"), float("-inf")) \
            else None
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


class _Handler(BaseHTTPRequestHandler):
    server_version = "parsec-metrics/1.0"

    def log_message(self, *args) -> None:  # silence per-request stderr
        pass

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        srv: "MetricsServer" = self.server.metrics   # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
        try:
            if path == "/health":
                body = srv.health_body()
            elif path == "/metrics":
                body = srv.metrics_body()
            elif path == "/histograms":
                body = srv.histograms_body()
            elif path == "/mesh":
                body = srv.mesh_body()
            else:
                self.send_error(404, "unknown path (try /metrics)")
                return
        except Exception as e:  # noqa: BLE001 — a scrape must not 500-loop
            self.send_error(500, f"snapshot failed: {e}")
            return
        # strict JSON: a NaN counter (e.g. a clock offset not yet
        # measured, or a failing sampler — CounterRegistry maps those to
        # float('nan')) must serialize as null, not the bare `NaN` token
        # Python emits by default, or `curl | jq` and every RFC-8259
        # parser choke on the scrape
        raw = json.dumps(_json_safe(body)).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


class _TCPServer(socketserver.ThreadingMixIn, HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class _UDSServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True

    def get_request(self):
        # BaseHTTPRequestHandler expects a (host, port)-shaped address
        request, _ = super().get_request()
        return request, ("uds", 0)


class MetricsServer:
    """One rank's metrics endpoint. ``port`` > 0 binds TCP
    ``127.0.0.1:port + rank``; ``port`` == 0 with no ``uds`` binds an
    ephemeral TCP port (tests); a non-empty ``uds`` binds
    ``<uds>.r<rank>`` instead."""

    def __init__(self, rank: int = 0, nb_ranks: int = 1, port: int = 0,
                 uds: str = "", registry=None) -> None:
        self.rank = rank
        self.nb_ranks = nb_ranks
        self._uds_path: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from ..utils.counters import counters as registry  # noqa: PLW0127
        self.registry = registry
        # make the native lanes + latency percentiles visible to scrapes
        # (idempotent; tolerate partial native availability)
        try:
            from ..utils.counters import install_native_counters
            install_native_counters()
        except Exception:  # noqa: BLE001 — registry still serves the rest
            pass
        if uds:
            self._uds_path = f"{uds}.r{rank}"
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
            self._srv = _UDSServer(self._uds_path, _Handler)
            self.endpoint = f"unix:{self._uds_path}"
        else:
            bind_port = port + rank if port else 0
            self._srv = _TCPServer(("127.0.0.1", bind_port), _Handler)
            self.endpoint = f"http://127.0.0.1:{self._srv.server_address[1]}"
        self._srv.metrics = self   # type: ignore[attr-defined]

    # ------------------------------------------------------------- bodies
    def health_body(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {"ok": True, "rank": self.rank,
                                "pid": os.getpid()}
        try:
            from ..core.watchdog import health_report
            wd = health_report()
        except Exception:  # noqa: BLE001 — health must still answer
            wd = None
        if wd is not None:
            body["watchdog"] = wd
            if wd["degraded"]:
                body["ok"] = False
        return body

    def mesh_body(self) -> Dict[str, Any]:
        """The telemetry plane's mesh rollup — only meaningful where the
        tree's frames land (rank 0), but any rank answers with whatever
        subtree it has folded, attributed when the plane is off."""
        from ..comm.pttel import current_plane
        tel = current_plane()
        if tel is None:
            return {"rank": self.rank, "ts": time.time(), "mesh": None,
                    "reason": "telemetry plane not running "
                              "(--mca tel_interval_ms 0)"}
        body = tel.rollup()
        body["ts"] = time.time()
        return body

    def metrics_body(self) -> Dict[str, Any]:
        from ..utils.hist import histograms
        return {
            "rank": self.rank,
            "nb_ranks": self.nb_ranks,
            "pid": os.getpid(),
            "ts": time.time(),
            "counters": self.registry.snapshot(),
            "percentiles": histograms.summaries(),
        }

    def histograms_body(self) -> Dict[str, Any]:
        from ..utils.hist import histograms
        out = {}
        for name, d in histograms.snapshot().items():
            out[name] = {
                "count": d["count"],
                "sum_ns": d["sum_ns"],
                # sparse form: log2 buckets are mostly empty
                "buckets": [[i, c] for i, c in enumerate(d["buckets"]) if c],
            }
        return {"rank": self.rank, "ts": time.time(), "histograms": out}

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._srv.serve_forever, daemon=True,
                name=f"parsec-metrics-r{self.rank}")
            self._thread.start()
            output.debug_verbose(1, "metrics",
                                 f"rank {self.rank} metrics endpoint up "
                                 f"at {self.endpoint}")
        return self

    def stop(self) -> None:
        """Shut down cleanly: no leaked thread, socket, or UDS inode —
        the test-isolation contract (a later bind of the same port/path
        must succeed)."""
        if self._thread is None:
            return
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2.0)
        self._thread = None
        if self._uds_path:
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass

    @classmethod
    def maybe_start(cls, rank: int, nb_ranks: int) -> Optional["MetricsServer"]:
        """Context-init hook: build from the mca params, or None when the
        endpoint is not configured. A bind failure warns and disables
        (observability must never kill the runtime)."""
        port = mca.get("metrics_port", 0)
        uds = mca.get("metrics_uds", "")
        if not port and not uds:
            return None
        try:
            return cls(rank=rank, nb_ranks=nb_ranks, port=port,
                       uds=uds).start()
        except OSError as e:
            output.warning(f"metrics endpoint disabled: cannot bind "
                           f"(port={port} uds={uds!r} rank={rank}): {e}")
            return None


# ------------------------------------------------------------------ client

def fetch(endpoint: str, path: str = "/metrics",
          timeout: float = 2.0) -> Dict[str, Any]:
    """Minimal HTTP/1.0 GET over TCP (``http://host:port``) or UDS
    (``unix:/path``), returning the decoded JSON body. stdlib-socket on
    purpose: urllib cannot speak unix-domain sockets, and the poller
    (live_view cross-process mode, the ci gate) needs both."""
    if endpoint.startswith("unix:"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(endpoint[len("unix:"):])
        host = "localhost"
    else:
        hostport = endpoint.split("//", 1)[-1].rstrip("/")
        host, _, port_s = hostport.partition(":")
        s = socket.create_connection((host, int(port_s)), timeout=timeout)
    try:
        s.sendall(f"GET {path} HTTP/1.0\r\nHost: {host}\r\n\r\n".encode())
        chunks: List[bytes] = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    finally:
        s.close()
    raw = b"".join(chunks)
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0].split()
    if len(status_line) < 2 or status_line[1] != b"200":
        raise RuntimeError(f"{endpoint}{path}: {head[:200]!r}")
    return json.loads(body)
