"""Observability of the port (counterpart of paddle_tpu/monitor/).

Layers, each usable alone:

- ``registry``  — thread-safe Counter/Gauge/Histogram families with
  labels, get-or-create semantics, and a near-zero-cost disabled path;
- ``export``    — Prometheus text exposition + JSON snapshots;
- ``server``    — MetricsServer: stdlib http.server on /metrics,
  /metrics.json, /healthz, /readyz, /debug/traces, /fleet, /alerts and
  /requests;
- ``runtime``   — RuntimeSampler: host RSS and the card's allocator
  figures on a background thread;
- ``tracing``   — span tracer (trace_id/span_id/parent, contextvars
  propagation, cross-process context injection) with a flight-recorder
  ring (dumps on faults, alerts and recompiles) served at
  /debug/traces, tail-based trace retention, and Chrome-trace export for
  profiler.merge_traces;
- ``perf``      — CompileWatchdog (recompile attribution + warmup
  barrier on TorchDynamo's compile callbacks), StepTimeline (step phase
  split + straggler detection), and the cost-model roofline/MFU
  estimator;
- ``federation``— FleetCollector: pull-based cross-process metric
  federation (in-proc registries + HTTP /metrics.json targets, merged
  counters/gauges/histograms, staleness + fleet_target_up liveness)
  served at /fleet;
- ``alerts``    — AlertManager: declarative threshold + multi-window
  SLO burn-rate rules with a pending→firing→resolved lifecycle,
  flight dumps on firing edges, served at /alerts;
- ``events``    — RequestLog: ONE canonical wide event per serving
  request in a bounded ring + rotating JSONL sink, served at
  /requests; TenantLabeler bounds per-tenant metric cardinality;
- ``telemetry`` — the metric-family schemas every site registers
  through, and the dryrun snapshot lines.
"""
from .registry import (Counter, Gauge, Histogram, MetricRegistry,
                       default_registry, exponential_buckets,
                       set_default_registry)
from .export import schema_of, to_dict, to_json, to_prometheus
from .server import MetricsServer
from .runtime import RuntimeSampler
from .tracing import (FlightRecorder, Span, TraceRetention, Tracer,
                      default_tracer, set_default_tracer,
                      spans_to_chrome)
from .events import (REQUEST_EVENT_FIELDS, RequestLog, TenantLabeler,
                     default_request_log, set_default_request_log)
from . import events
from .federation import FleetCollector, ScrapeTarget, merge_snapshots
from .alerts import (AlertManager, AlertRule, BurnRateRule,
                     ThresholdRule)
from . import alerts
from . import export
from . import federation
from . import perf
from . import runtime
from . import telemetry
from . import tracing
from .perf import CompileWatchdog, RecompileError, StepTimeline

__all__ = ['MetricRegistry', 'Counter', 'Gauge', 'Histogram',
           'exponential_buckets', 'default_registry',
           'set_default_registry', 'to_prometheus', 'to_dict', 'to_json',
           'schema_of', 'MetricsServer', 'RuntimeSampler', 'telemetry',
           'Tracer', 'Span', 'FlightRecorder', 'default_tracer',
           'set_default_tracer', 'spans_to_chrome', 'tracing', 'perf',
           'CompileWatchdog', 'RecompileError', 'StepTimeline',
           'FleetCollector', 'ScrapeTarget', 'merge_snapshots',
           'AlertManager', 'AlertRule', 'ThresholdRule', 'BurnRateRule',
           'federation', 'alerts', 'TraceRetention', 'RequestLog',
           'TenantLabeler', 'REQUEST_EVENT_FIELDS', 'default_request_log',
           'set_default_request_log', 'events', 'export', 'runtime']
