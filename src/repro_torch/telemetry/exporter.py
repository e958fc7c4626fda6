"""Prometheus scrape endpoint + snapshot-to-file export.

Two delivery modes over the same rendered registry:

    MetricsExporter(port=9477).start()   stdlib ThreadingHTTPServer on a
                                         daemon thread serving GET
                                         /metrics (port=0 -> ephemeral,
                                         read back via .port)
    write_snapshot(path)                 one deterministic text file —
                                         what tests and --metrics-snapshot
                                         CI runs diff

No third-party dependencies: the scrape path must never be the thing
that takes the server down, and the stress harness scrapes its own
in-process exporter over real HTTP each epoch (the same bytes an
operator's Prometheus would pull).
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry, default_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set per-server via type()

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path not in ("/metrics", "/"):
            self.send_error(404, "only /metrics is served here")
            return
        body = self.registry.render().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not log events
        pass


class MetricsExporter:
    """Background /metrics HTTP server over a registry."""

    def __init__(self, port: int = 9477, *, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else default_registry()
        self._requested_port = int(port)
        self.host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        """The bound port (resolves port=0 after start())."""
        if self._server is not None:
            return self._server.server_address[1]
        return self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        handler = type("BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry to ``path`` (parents created).  Rendering is
    deterministic — metrics sorted by name, series by label values — so
    two snapshots of identical state are byte-identical."""
    reg = registry if registry is not None else default_registry()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    text = reg.render()
    with open(path, "w") as f:
        f.write(text)
    return text


def scrape(url: str, timeout: float = 5.0) -> str:
    """HTTP-GET a /metrics URL and return the body text (the stress
    harness's curl-equivalent)."""
    from urllib.request import urlopen
    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


# -- launcher plumbing (train.py / serve.py / dryrun / stress share it) -----

def add_metrics_args(parser) -> None:
    parser.add_argument("--metrics-port", type=int, default=None,
                        metavar="PORT",
                        help="serve Prometheus text exposition at "
                             "http://127.0.0.1:PORT/metrics for the "
                             "lifetime of the run (0 = ephemeral port)")
    parser.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                        help="write a final /metrics snapshot to PATH on "
                             "exit (the scrapeless CI/test mode)")


def start_exporter_from_args(args) -> Optional[MetricsExporter]:
    """Start the /metrics endpoint when --metrics-port was given."""
    port = getattr(args, "metrics_port", None)
    if port is None:
        return None
    exporter = MetricsExporter(port).start()
    print(f"metrics: serving Prometheus exposition at {exporter.url}")
    return exporter


def finish_exporter_from_args(args, exporter: Optional[MetricsExporter]
                              = None) -> None:
    """End-of-run half: write --metrics-snapshot, stop the endpoint."""
    path = getattr(args, "metrics_snapshot", None)
    if path:
        write_snapshot(path)
        print(f"metrics: snapshot written to {path}")
    if exporter is not None:
        exporter.stop()
