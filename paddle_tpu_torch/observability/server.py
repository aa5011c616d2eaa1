"""Loopback-only HTTP `/metrics` endpoint (copied from
paddle_tpu/observability/server.py).

Pull-based exposition on an ephemeral port (the Prometheus model): the
scraper initiates, the process never pushes. Deliberately restricted to
loopback binds — the registry can carry prompt lengths, pool sizes and
rank topology, and the FL/elastic tiers already established the rule
that unauthenticated plaintext services in this repo never leave the
host (DESIGN_DECISIONS.md). A production scrape path fronts this with
the pod's service mesh, not a 0.0.0.0 bind.
"""
from __future__ import annotations

import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .exposition import CONTENT_TYPE, render_prometheus
from .metrics import json_sanitize

__all__ = ["MetricsServer"]

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


class _V6Server(ThreadingHTTPServer):
    address_family = socket.AF_INET6


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        snapshot = self.server._snapshot  # type: ignore[attr-defined]
        path = self.path.partition("?")[0]   # scrape params are legal
        if path in ("/metrics", "/"):
            body = render_prometheus(snapshot()).encode()
            ctype = CONTENT_TYPE
        elif path == "/metrics.json":
            body = json.dumps(json_sanitize(snapshot()),
                              sort_keys=True).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):          # scrapes are not stdout news
        pass


class MetricsServer:
    """Serve a registry's exposition on loopback.

        srv = MetricsServer(registry)      # ephemeral port, started
        requests.get(srv.url)              # text exposition
        requests.get(srv.url + '.json')    # JSON snapshot
        srv.close()

    `snapshot_fn` overrides the data source — e.g. rank 0 serving a
    job-level snapshot refreshed by periodic `aggregate()` calls:

        merged = {}                        # refreshed by the job loop:
        ...  merged.update(aggregate())    # (collective — call it from
        srv = MetricsServer(snapshot_fn=lambda: merged)   # the loop,
                                           # NEVER from the scrape path)
    """

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 snapshot_fn=None):
        if host not in _LOOPBACK:
            raise ValueError(
                f"metrics endpoint is loopback-only (got {host!r}); "
                "front it with a proxy to expose it off-host")
        if snapshot_fn is None:
            if registry is None:
                from .metrics import get_registry

                registry = get_registry()
            snapshot_fn = registry.snapshot
        self.registry = registry
        cls = _V6Server if ":" in host else ThreadingHTTPServer
        self._srv = cls((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv._snapshot = snapshot_fn  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host = self._srv.server_address[0]
        if ":" in host:
            host = f"[{host}]"               # bracketed IPv6 authority
        return f"http://{host}:{self.port}/metrics"

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
