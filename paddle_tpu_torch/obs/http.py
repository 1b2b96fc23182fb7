"""Optional stdlib HTTP exposer: GET /metrics (Prometheus text exposition)
and GET /healthz (JSON) on a daemon thread — the scrape endpoint a balancer
or a Prometheus instance points at.

    from paddle_tpu_torch import obs
    srv = obs.http.start_exposer(port=9464, healthz=session.healthz)
    ... srv.url ...
    srv.stop()

``routes`` mounts extra endpoints on the SAME server — ``{(method, path):
callable(body) -> (status, content_type, body)}`` — so a serving process
(fleet worker, fleet front) exposes its traffic port and its observability
on one listener and a single scrape sees everything.

Deliberately http.server, not a framework: the container bakes in no web
stack, and a metrics endpoint that can fail in interesting ways defeats its
purpose.  One ThreadingHTTPServer, silent request logging, port=0 for an
ephemeral port (tests).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import metrics as _metrics

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

Route = Callable[[bytes], Tuple[int, str, bytes]]


class MetricsServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 healthz: Optional[Callable[[], Dict]] = None,
                 registry: Optional[_metrics.Registry] = None,
                 routes: Optional[Dict[Tuple[str, str], Route]] = None):
        self._healthz = healthz
        self._registry = registry or _metrics.default_registry()
        self._routes = dict(routes or {})
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stdout chatter per scrape
                pass

            def _dispatch_route(self, method):
                path = self.path.split("?", 1)[0]
                fn = server._routes.get((method, path))
                if fn is None:
                    return False
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                try:
                    code, ctype, payload = fn(body)
                except Exception as e:  # route handlers map their own errors;
                    # anything that still escapes must not kill the listener
                    code, ctype = 500, "application/json"
                    payload = json.dumps({"error": repr(e),
                                          "kind": "internal",
                                          "transient": True}).encode()
                self._reply(code, ctype, payload)
                return True

            def do_POST(self):
                if not self._dispatch_route("POST"):
                    self._reply(404, "text/plain", b"not found\n")

            def do_GET(self):
                if self._dispatch_route("GET"):
                    return
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server._registry.prometheus().encode()
                    self._reply(200, PROM_CONTENT_TYPE, body)
                elif path == "/healthz":
                    try:
                        hz = server._healthz() if server._healthz else {"ok": True}
                        code = 200 if hz.get("ok", True) else 503
                    except Exception as e:  # health probe itself broke
                        hz, code = {"ok": False, "error": repr(e)}, 503
                    self._reply(code, "application/json",
                                json.dumps(hz, default=str).encode())
                else:
                    self._reply(404, "text/plain", b"not found\n")

            def _reply(self, code, ctype, body):
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionError):
                    # the client hung up first (expired deadline, closed
                    # scrape, load-test churn): its reply has nowhere to
                    # go — not worth a handler-thread traceback per
                    # disconnect on a saturated server
                    pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="paddle_tpu-metrics-http")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_exposer(port: int = 0, host: str = "127.0.0.1",
                  healthz: Optional[Callable[[], Dict]] = None) -> MetricsServer:
    return MetricsServer(port=port, host=host, healthz=healthz)
