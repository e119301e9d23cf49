"""Scrape endpoint: a stdlib http.server serving /metrics and /healthz
(counterpart of paddle_tpu/monitor/server.py).

Prometheus-compatible without the prometheus_client dependency: text
exposition 0.0.4 on /metrics, the JSON snapshot on /metrics.json, a tiny
JSON liveness body on /healthz, readiness on /readyz, the tracer's
flight-recorder ring on /debug/traces (?format=chrome for a
Perfetto-loadable body), the federated fleet view on /fleet (?scrape=1 to
force a cycle, ?format=prom for text exposition of the merge), alert state
on /alerts (?evaluate=1 to evaluate first) when a FleetCollector /
AlertManager is attached, and the wide-event request log on /requests
(?tenant= / ?model= / ?outcome= / ?min_failovers= / ?since_ts= /
?until_ts= / ?limit= filters) when a RequestLog is attached, 404
elsewhere. HEAD is answered on every route (load-balancer probes use it
and must not see http.server's default 501). Ephemeral-port by default so
tests and multi-engine processes never collide; `.port`/`.url` report the
bound address.
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
        if path == '/fleet':
            coll = getattr(self.server, 'collector', None)
            if coll is None:
                return (404, 'text/plain; charset=utf-8',
                        b'no fleet collector attached\n')
            # pull-based federation: ?scrape=1 forces a cycle before
            # answering (the offline CLI's freshness knob); the default
            # serves the collector's last merged view
            if 'scrape=1' in query:
                coll.scrape()
            if 'format=prom' in query:
                return (200, CONTENT_TYPE,
                        export.snapshot_to_prometheus(
                            coll.merged()).encode())
            return (200, 'application/json',
                    json.dumps(coll.fleet_status()).encode())
        if path == '/alerts':
            mgr = getattr(self.server, 'alerts', None)
            if mgr is None:
                return (404, 'text/plain; charset=utf-8',
                        b'no alert manager attached\n')
            if 'evaluate=1' in query:
                mgr.evaluate()
            return (200, 'application/json',
                    json.dumps({'firing': mgr.firing(),
                                'alerts': mgr.state()}).encode())
        if path == '/requests':
            log = getattr(self.server, 'events', None)
            if log is None:
                return (404, 'text/plain; charset=utf-8',
                        b'no request log attached\n')
            import urllib.parse
            q = urllib.parse.parse_qs(query)

            def _one(name, conv=str):
                vals = q.get(name)
                return None if not vals else conv(vals[0])

            try:
                evs = log.events(tenant=_one('tenant'),
                                 model=_one('model'),
                                 outcome=_one('outcome'),
                                 min_failovers=_one('min_failovers', int),
                                 since_ts=_one('since_ts', float),
                                 until_ts=_one('until_ts', float),
                                 limit=_one('limit', int))
            except ValueError:
                return (400, 'text/plain; charset=utf-8',
                        b'min_failovers/limit must be integers and '
                        b'since_ts/until_ts floats\n')
            body = json.dumps({'count': len(evs),
                               'dropped': log.dropped,
                               'events': evs}).encode()
            return 200, 'application/json', body
        if path == '/debug/traces':
            tracer = getattr(self.server, 'tracer', None)
            if tracer is None:
                return (404, 'text/plain; charset=utf-8',
                        b'no tracer attached\n')
            rec = tracer.recorder
            if 'format=chrome' in query:
                body = json.dumps(rec.to_chrome()).encode()
            else:
                body = json.dumps({'enabled': tracer.enabled,
                                   'capacity': rec.capacity,
                                   'dropped': rec.dropped,
                                   'spans': rec.spans()}).encode()
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
                 tracer=None, readiness=None, collector=None,
                 alerts=None, events=None):
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
        # /fleet: a monitor.federation.FleetCollector (merged fleet
        # snapshot + per-target liveness); /alerts: a
        # monitor.alerts.AlertManager; /requests: a monitor.events
        # RequestLog. All optional — an unattached route answers 404 like
        # any unknown path.
        self.collector = collector
        self.alerts = alerts
        self.events = events
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
        self._srv.collector = self.collector
        self._srv.alerts = self.alerts
        self._srv.events = self.events
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
