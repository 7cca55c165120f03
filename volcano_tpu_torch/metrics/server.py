"""HTTP exposition: /metrics, /healthz, /debug/stacks.

The reference serves promhttp plus net/http/pprof on --listen-address
(cmd/scheduler/app/server.go:76-77, cmd/scheduler/main.go:25). The Python
equivalent of the pprof goroutine dump is a live thread-stack dump.
"""

from __future__ import annotations

import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import registry as default_registry

DEFAULT_LISTEN_PORT = 8080


def _dump_stacks() -> str:
    import sys
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


class MetricsServer:
    """Serves the metric registry on a daemon thread."""

    def __init__(self, port: int = DEFAULT_LISTEN_PORT, registry=None,
                 host: str = "127.0.0.1"):
        self.registry = registry or default_registry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/metrics":
                    body = outer.registry.expose().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                elif self.path == "/debug/stacks":
                    body, ctype = _dump_stacks().encode(), "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence request logging
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]  # resolved if port=0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-server",
            daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
