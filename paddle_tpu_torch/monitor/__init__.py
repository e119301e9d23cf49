"""Observability of the port's serving path (counterpart of
paddle_tpu/monitor/): the metric registry, the span tracer, the wide-event
request log, the step timeline, the metric-family schemas they register
through, the Prometheus / JSON exporters and the scrape server
(`MetricsServer`: /metrics, /metrics.json, /healthz, /readyz,
/debug/traces). Federation, alerts, the runtime sampler and
the compile watchdog are not ported."""
from . import events, export, perf, telemetry, tracing
from .events import RequestLog, TenantLabeler, default_request_log
from .export import to_dict, to_json, to_prometheus
from .registry import (Counter, Gauge, Histogram, MetricRegistry,
                       default_registry, set_default_registry)
from .server import MetricsServer
from .tracing import Span, Tracer, default_tracer

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricRegistry',
           'default_registry', 'set_default_registry', 'RequestLog',
           'TenantLabeler', 'default_request_log', 'Span', 'Tracer',
           'default_tracer', 'MetricsServer', 'to_prometheus', 'to_dict',
           'to_json', 'events', 'export', 'perf', 'telemetry', 'tracing']
