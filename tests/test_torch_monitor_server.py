"""The port's exporters, scrape server, Chrome-trace export and metric
schemas (paddle_tpu_torch/monitor/) against the JAX package's, on the CPU.

- The same families and samples, recorded in a registry of each package
  under the same clock, give byte-identical Prometheus text and equal
  JSON snapshots (tolerance: exact equality).
- The gateway, QoS, RPC and capacity schemas declare the reference's
  family names, kinds, help, label names in the same order, and buckets.
- The MetricsServer's endpoints answer on loopback as the reference's do.
"""
import json
import math
import urllib.error
import urllib.request

import pytest

from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor import telemetry as jtel
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu_torch.monitor import MetricsServer
from paddle_tpu_torch.monitor import events as tevents
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor import telemetry as ttel
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.monitor.registry import MetricRegistry


def _record(reg):
    """One fixed set of families and samples: every kind, labels that
    need escaping, infinities, integral and fractional floats,
    exemplars."""
    c = reg.counter('req_total', 'requests\nserved \\ total',
                    ('route', 'code'))
    c.labels('/a', '200').inc(3)
    c.labels('/b"q"', '500').inc(0.5)
    c.labels(route='x\ny', code='404').inc()
    g = reg.gauge('temp', 'a gauge')
    g.set(float('inf'))
    reg.gauge('depth', 'queue depth', ('q',)).labels('z').set(-2.25)
    reg.gauge('big', 'a large value').set(1e16)
    h = reg.histogram('lat_seconds', 'latency', ('op',),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.labels('get').observe(v)
    h.labels('put').observe(0.2, exemplar='abc123')
    reg.histogram('empty_seconds', 'no samples', buckets=(1.0, 2.0))
    reg.counter('unset_total', 'labeled, no children', ('k',))
    return reg


def _clock():
    return 1234.5


def test_prometheus_text_and_snapshot_match_jax():
    j = _record(JRegistry(clock=_clock))
    t = _record(MetricRegistry(clock=_clock))
    assert texport.to_prometheus(t) == jexport.to_prometheus(j)
    assert texport.to_dict(t) == jexport.to_dict(j)
    assert texport.to_dict(t, buckets=False) == \
        jexport.to_dict(j, buckets=False)
    assert texport.to_json(t) == jexport.to_json(j)
    snap = texport.to_dict(t)
    assert texport.schema_of(snap) == jexport.schema_of(snap)
    assert texport.snapshot_to_prometheus(snap) == \
        jexport.snapshot_to_prometheus(snap)
    text = texport.to_prometheus(t)
    assert 'temp +Inf' in text
    assert 'req_total{route="/b\\"q\\"",code="500"} 0.5' in text
    assert 'lat_seconds_bucket{op="get",le="+Inf"} 5' in text
    assert snap['lat_seconds']['samples'][1]['exemplars'] == {
        '1': {'trace_id': 'abc123', 'value': 0.2, 'ts': 1234.5}}


SCHEMAS = ('record_gateway_schema', 'record_qos_schema', 'record_rpc_schema',
           'record_capacity_schema', 'record_tenant_schema',
           'record_serving_request_schema', 'record_request_event_schema',
           'record_tracing_schema', 'record_fleet_schema',
           'record_alert_schema')


@pytest.mark.parametrize('fn', SCHEMAS)
def test_schema_matches_jax(fn):
    """Family names, kinds, help, label names in order and histogram
    buckets of each schema the port registers are the reference's — all
    but serving_trace_count (the eager engines trace no program)."""
    jfams = getattr(jtel, fn)(JRegistry())
    tfams = getattr(ttel, fn)(MetricRegistry())
    skip = {'serving_trace_count'}
    assert sorted(tfams) == sorted(set(jfams) - skip)
    for name, tf in tfams.items():
        jf = jfams[name]
        assert (tf.kind, tf.help, tf.labelnames) == \
            (jf.kind, jf.help, jf.labelnames), name
        assert getattr(tf, 'buckets', None) == getattr(jf, 'buckets', None)
    if fn in ('record_gateway_schema', 'record_qos_schema'):
        # graftlint and the snapshot gate read the gateway's label
        # declarations sorted
        for f in tfams.values():
            assert list(f.labelnames) == sorted(f.labelnames), f.name


def test_chrome_trace_matches_jax(tmp_path):
    reg = MetricRegistry()
    tracer = ttracing.Tracer(registry=reg, clock=_clock,
                             recorder=ttracing.FlightRecorder(
                                 capacity=2, registry=reg, clock=_clock))
    with tracer.start_span('outer', tags={'k': 1}) as outer:
        outer.add_event('ev', n=2)
        with tracer.start_span('inner'):
            pass
        try:
            with tracer.start_span('failing'):
                raise KeyError('x')
        except KeyError:
            pass
    spans = tracer.recorder.spans()
    assert [s['name'] for s in spans] == ['failing', 'outer']
    assert tracer.recorder.dropped == 1 and tracer.recorder.capacity == 2
    assert ttracing.spans_to_chrome(spans, pid=7, process_name='p') == \
        jtracing.spans_to_chrome(spans, pid=7, process_name='p')
    path = tracer.recorder.export_chrome(str(tmp_path / 'sub' / 'trace.json'))
    with open(path) as f:
        body = json.load(f)
    assert [e['name'] for e in body['traceEvents'] if e['ph'] == 'X'] == \
        ['failing', 'outer']


def _get(url, method='GET'):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.headers.get('Content-Type'), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get('Content-Type'), e.read()


def test_metrics_server_endpoints():
    reg = _record(MetricRegistry(clock=_clock))
    tracer = ttracing.Tracer(registry=MetricRegistry())
    with tracer.start_span('served', tags={'request_id': 5}):
        pass
    ready = {'v': True}
    srv = MetricsServer(registry=reg, tracer=tracer,
                        readiness=lambda: ready['v'])
    with srv:
        base = srv.url
        code, ctype, body = _get(base + '/metrics')
        assert code == 200 and ctype.startswith('text/plain; version=0.0.4')
        assert body.decode() == texport.to_prometheus(reg)
        code, _, body = _get(base + '/metrics.json')
        assert json.loads(body) == json.loads(texport.to_json(reg))
        for path in ('/healthz', '/health'):
            code, _, body = _get(base + path)
            assert code == 200 and json.loads(body)['status'] == 'ok'
        assert _get(base + '/readyz')[0] == 200
        ready['v'] = False
        code, _, body = _get(base + '/readyz')
        assert code == 503 and json.loads(body)['status'] == 'draining'
        assert _get(base + '/healthz')[0] == 200
        code, _, body = _get(base + '/debug/traces')
        traces = json.loads(body)
        assert traces['enabled'] and traces['dropped'] == 0
        assert [s['name'] for s in traces['spans']] == ['served']
        code, _, body = _get(base + '/debug/traces?format=chrome')
        assert any(e.get('name') == 'served'
                   for e in json.loads(body)['traceEvents'])
        code, ctype, body = _get(base + '/metrics', method='HEAD')
        assert code == 200 and body == b''
        for path in ('/nope', '/fleet', '/alerts', '/requests'):
            assert _get(base + path)[0] == 404
    with pytest.raises(RuntimeError, match='not started'):
        srv.port


def test_metrics_server_defaults_to_ready_and_the_default_tracer():
    with MetricsServer(registry=MetricRegistry()) as srv:
        assert srv.tracer is ttracing.default_tracer()
        assert _get(srv.url + '/readyz')[0] == 200
        assert _get(srv.url + '/debug/traces')[0] == 200


def test_request_log_since_ts_slices_a_run():
    log = tevents.RequestLog(capacity=8, registry=MetricRegistry())
    for i, t in enumerate((1.0, 2.0, None, 3.0)):
        log.emit(request_id=i, arrival_t=t, outcome='ok')
    assert [e['request_id'] for e in log.events(since_ts=2.0)] == [1, 3]
    assert len(log.events()) == 4


def test_histogram_cumulative_view():
    reg = MetricRegistry()
    h = reg.histogram('h_seconds', 'h', buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 1.5, 9.0):
        h.observe(v)
    cum = h.cumulative()
    assert cum['cumulative'] == [1, 3, 4] and cum['count'] == 4
    assert cum['bounds'][-1] == math.inf and cum['sum'] == 12.5
    assert [f.name for f in reg.collect()] == ['h_seconds']
