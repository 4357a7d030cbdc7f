"""Opt-in stdlib exposition endpoint: ``/metrics`` (Prometheus text)
and ``/healthz`` (JSON); the port of ``gymfx_tpu/telemetry/http.py``.

A daemon-threaded ``http.server.ThreadingHTTPServer`` — no new
dependencies, no framework — bound to localhost by default.  Serving
fast paths never touch it: scrapes read the registry under its own
per-family locks.  ``port=0`` binds an ephemeral port (tests); the bound
port is exposed as :attr:`port`.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from gymfx_tpu_torch.telemetry import prometheus


class TelemetryServer:
    """``TelemetryServer(registry, health_fn=..., port=0)`` then
    :meth:`close` (or use as a context manager)."""

    def __init__(
        self,
        registry: Any,
        *,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self.registry = registry
        self.health_fn = health_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # keep scrapes off stderr
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib handler API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = prometheus.render(outer.registry).encode()
                        self._send(200, body, prometheus.CONTENT_TYPE)
                    elif path == "/healthz":
                        payload = (
                            outer.health_fn()
                            if outer.health_fn is not None
                            else {"status": "ok"}
                        )
                        body = json.dumps(
                            payload, default=_coerce
                        ).encode()
                        self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as exc:  # a scrape bug must not wedge the server
                    try:
                        self._send(
                            500, f"error: {exc}\n".encode(), "text/plain"
                        )
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="gymfx-telemetry-http",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass

    def __enter__(self) -> "TelemetryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _coerce(value: Any):
    try:
        return float(value)
    except (TypeError, ValueError):
        return repr(value)


def scrape(url: str, timeout: float = 5.0) -> str:
    """GET one exposition page from a loopback ``url`` (the tests' one-
    liner; no retry machinery)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")
