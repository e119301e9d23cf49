"""Scrape endpoint: a stdlib http.server serving /metrics and /healthz
(counterpart of paddle_tpu/monitor/server.py).

Prometheus-compatible without the prometheus_client dependency: text
exposition 0.0.4 on /metrics, the JSON snapshot on /metrics.json, a tiny
JSON liveness body on /healthz, readiness on /readyz and the tracer's
finished-span ring on /debug/traces (?format=chrome for a
Perfetto-loadable body), 404 elsewhere. HEAD is answered on every route
(load-balancer probes use it and must not see http.server's default
501). Ephemeral-port by default so tests and multi-engine processes never
collide; `.port`/`.url` report the bound address.

The reference's /fleet and /alerts routes wait for monitor/federation.py
and monitor/alerts.py, and its /requests (the wide-event log, filtered)
for a caller in the port.
"""
import http.server
import json
import threading
import time

from . import export
from .registry import default_registry

__all__ = ['MetricsServer']

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'


class _Handler(http.server.BaseHTTPRequestHandler):
    # one scrape per connection is fine; keep-alive complicates shutdown
    protocol_version = 'HTTP/1.0'

    def _route(self):
        """(code, content-type, body) for the request path — shared by
        GET and HEAD so probe responses carry the real headers."""
        path, _, query = self.path.partition('?')
        if path == '/metrics':
            return (200, CONTENT_TYPE,
                    export.to_prometheus(self.server.registry).encode())
        if path in ('/healthz', '/health'):
            # liveness only: the process is up and serving scrapes. A
            # draining replica stays live (kubelet must not restart it)
            # even though /readyz says to stop routing to it.
            body = json.dumps({
                'status': 'ok',
                'uptime_s': round(time.monotonic() - self.server.started,
                                  3)}).encode()
            return 200, 'application/json', body
        if path == '/readyz':
            check = getattr(self.server, 'readiness', None)
            ready = True if check is None else bool(check())
            body = json.dumps({
                'status': 'ready' if ready else 'draining'}).encode()
            return (200 if ready else 503), 'application/json', body
        if path == '/metrics.json':
            return (200, 'application/json',
                    export.to_json(self.server.registry).encode())
        if path == '/debug/traces':
            tracer = getattr(self.server, 'tracer', None)
            if tracer is None:
                return (404, 'text/plain; charset=utf-8',
                        b'no tracer attached\n')
            if 'format=chrome' in query:
                body = json.dumps(tracer.to_chrome()).encode()
            else:
                body = json.dumps({'enabled': tracer.enabled,
                                   'capacity': tracer.capacity,
                                   'dropped': tracer.dropped,
                                   'spans': tracer.spans()}).encode()
            return 200, 'application/json', body
        return 404, 'text/plain; charset=utf-8', b'not found\n'

    def do_GET(self):
        self._reply(*self._route())

    def do_HEAD(self):
        self._reply(*self._route(), head=True)

    def _reply(self, code, ctype, body, head=False):
        self.send_response(code)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        if not head:
            self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass  # scrapes every few seconds must not spam stderr


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Background scrape server over one registry.

        srv = MetricsServer()            # default registry, ephemeral port
        srv.start()
        ... curl http://127.0.0.1:<srv.port>/metrics ...
        srv.stop()

    Also a context manager. Serving runs on a daemon thread, so a process
    exit never hangs on an open scrape socket.
    """

    def __init__(self, registry=None, host='127.0.0.1', port=0,
                 tracer=None, readiness=None):
        self.registry = registry if registry is not None \
            else default_registry()
        if tracer is None:
            from .tracing import default_tracer
            tracer = default_tracer()
        self.tracer = tracer
        # /readyz: liveness (/healthz) says "don't restart me", readiness
        # says "route to me". None = always ready; otherwise a zero-arg
        # callable — e.g. a gateway replica's `.ready` — evaluated per
        # probe so a drain flips the route to 503 without a restart.
        self.readiness = readiness
        self._host = host
        self._port = int(port)
        self._srv = None
        self._thread = None

    def start(self):
        if self._srv is not None:
            return self
        self._srv = _HTTPServer((self._host, self._port), _Handler)
        self._srv.registry = self.registry
        self._srv.tracer = self.tracer
        self._srv.readiness = self.readiness
        self._srv.started = time.monotonic()
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name='metrics-server', daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._srv is None:
            return
        self._srv.shutdown()
        self._srv.server_close()
        self._srv = None
        self._thread = None

    @property
    def port(self):
        if self._srv is None:
            raise RuntimeError('server not started')
        return self._srv.server_address[1]

    @property
    def url(self):
        return 'http://%s:%d' % (self._host, self.port)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
