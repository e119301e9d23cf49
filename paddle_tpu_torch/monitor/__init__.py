"""Observability of the port's serving path (counterpart of
paddle_tpu/monitor/): the metric registry, the span tracer, the wide-event
request log, the step timeline and the metric-family schemas they register
through. The metrics server, exporters, federation, alerts, the runtime
sampler and the compile watchdog are not ported."""
from . import events, perf, telemetry, tracing
from .events import RequestLog, TenantLabeler, default_request_log
from .registry import (Counter, Gauge, Histogram, MetricRegistry,
                       default_registry, set_default_registry)
from .tracing import Span, Tracer, default_tracer

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricRegistry',
           'default_registry', 'set_default_registry', 'RequestLog',
           'TenantLabeler', 'default_request_log', 'Span', 'Tracer',
           'default_tracer', 'events', 'perf', 'telemetry', 'tracing']
