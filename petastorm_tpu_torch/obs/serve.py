"""Live metrics scrape endpoint: stdlib HTTP, opt-in, loopback by default.

Port of ``petastorm_tpu.obs.serve``. :class:`MetricsServer` is a small stdlib
``ThreadingHTTPServer`` (daemon threads, bounded shutdown) exposing:

- ``GET /metrics``: the Prometheus text exposition;
- ``GET /timelines``: the fleet-export JSON document
  (:func:`petastorm_tpu_torch.obs.timeseries.export_document`): the last snapshot, the
  windowed series and the (wall, perf) clock anchor of this source;
- ``GET /alerts``: the attached SLO engine's alerts (empty without one);
- ``GET /healthz``: liveness (200 and the uptime);
- any caller-provided ``routes``: ``{path: zero-arg callable}`` served as JSON.

The server binds ``127.0.0.1`` by default (metrics name dataset paths and hosts), and
port 0 picks a free port (read ``.port`` after :meth:`MetricsServer.start`). There is no
TLS and no authentication: this is a loopback or sidecar seam.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger("petastorm_tpu_torch.obs")


class MetricsServer:
    """Serve one registry's metrics + timelines over loopback HTTP.

    ``port=0`` (default) picks a free port — read it back from ``.port``
    after :meth:`start`. Use as a context manager around the serving loop::

        registry = MetricsRegistry()
        with MetricsServer(registry) as srv:
            print("scrape me at http://127.0.0.1:%d/metrics" % srv.port)
            ...

    The handler reads the registry/engine per request (pull model — zero cost
    when nobody scrapes), and request handling runs on daemon threads so a
    wedged scraper cannot block pipeline teardown.
    """

    def __init__(self, registry=None, host="127.0.0.1", port=0,
                 slo_engine=None, routes=None):
        from petastorm_tpu_torch.obs.metrics import default_registry

        self._registry = registry or default_registry()
        self._slo_engine = slo_engine
        #: extra GET paths: {"/fleet": zero-arg callable -> JSON-able dict}
        self._routes = dict(routes or {})
        self._host = host
        self._requested_port = int(port)
        self._httpd = None
        self._thread = None
        self._started = time.time()
        self.port = None

    def start(self):
        if self._httpd is not None:
            return self
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # stdlib default prints to stderr
                logger.debug("metrics-server: " + fmt, *args)

            def _send(self, body, content_type, status=200):
                if isinstance(body, str):
                    body = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(server._registry.to_prometheus(),
                                   "text/plain; version=0.0.4")
                    elif path == "/timelines":
                        from petastorm_tpu_torch.obs.timeseries import export_document

                        self._send(json.dumps(export_document(
                            server._registry)), "application/json")
                    elif path == "/alerts":
                        engine = server._slo_engine
                        alerts = [a.to_dict() for a in engine.alerts()] \
                            if engine is not None else []
                        self._send(json.dumps({"alerts": alerts}),
                                   "application/json")
                    elif path == "/healthz":
                        self._send(json.dumps(
                            {"ok": True,
                             "uptime_s": round(time.time() - server._started,
                                               3)}), "application/json")
                    elif path in server._routes:
                        self._send(json.dumps(server._routes[path]()),
                                   "application/json")
                    else:
                        self._send(json.dumps(
                            {"error": "unknown path %s" % path,
                             "paths": ["/metrics", "/timelines", "/alerts",
                                       "/healthz"]
                             + sorted(server._routes)}),
                            "application/json", status=404)
                except BrokenPipeError:
                    pass  # scraper went away mid-response: its problem
                except Exception as e:  # noqa: BLE001 — a render bug must 500, not kill the thread
                    try:
                        self._send(json.dumps({"error": str(e)}),
                                   "application/json", status=500)
                    except OSError:
                        pass

        httpd = ThreadingHTTPServer((self._host, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="ptpu-metrics-server", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    @property
    def url(self):
        return None if self.port is None \
            else "http://%s:%d" % (self._host, self.port)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
