"""Metric-family schemas and the dryrun snapshot lines (counterpart of
paddle_tpu/monitor/telemetry.py): the `record_*_schema` functions that
the port's serving metrics, request log, tracer, compile watchdog, step
timeline, cost model, gateway, circuit breakers and RPC channels, model
hosts, trace replay and fleet simulator, fleet collector, alert manager,
training callbacks, training supervisor and ingestion pipeline register
through, each with the reference's family names, label names and label
order; `dryrun_registry` holds them all, and `snapshot_line` /
`parse_snapshot_lines` write and read the one-line
`telemetry_snapshot(N)[tag]: {json}` form that tools/check_metrics_snapshot.py
and tools/perf_report.py parse.
"""
import json
import re

from . import export
from .registry import MetricRegistry

__all__ = ['record_dryrun_step', 'record_tracing_schema',
           'record_fleet_schema', 'record_alert_schema', 'dryrun_registry',
           'snapshot_line', 'parse_snapshot_lines', 'LINE_RE',
           'FLEET_FAMILIES', 'ALERT_FAMILIES',
           'record_serving_schema', 'record_serving_request_schema',
           'record_perf_schema', 'record_request_event_schema',
           'record_tenant_schema', 'record_qos_schema',
           'record_gateway_schema', 'record_rpc_schema',
           'record_client_op_schema', 'record_registry_schema',
           'record_capacity_schema', 'record_train_loop_schema',
           'record_supervisor_schema', 'record_ingest_schema',
           'SERVING_PAGED_FAMILIES',
           'PERF_FAMILIES', 'SERVING_REQUEST_FAMILIES',
           'REQUEST_EVENT_FAMILIES', 'TENANT_FAMILIES', 'QOS_FAMILIES',
           'GATEWAY_FAMILIES', 'RPC_FAMILIES', 'CLIENT_OP_FAMILIES',
           'REGISTRY_FAMILIES', 'CAPACITY_FAMILIES', 'TRAIN_LOOP_FAMILIES',
           'SUPERVISOR_FAMILIES', 'INGEST_FAMILIES']


LINE_RE = re.compile(r'telemetry_snapshot\((?P<n>\d+)\)'
                     r'\[(?P<tag>[^\]]*)\]:\s*(?P<json>\{.*\})\s*$')


def record_dryrun_step(registry, step_seconds, loss, batch=None):
    """The per-config training gauges a dryrun line embeds. Kept in one
    place so a driver and the schema-baseline gate register the exact
    same families."""
    registry.gauge('train_step_seconds',
                   'wall time of the measured train step').set(step_seconds)
    registry.gauge('train_loss', 'loss of the measured step').set(loss)
    registry.counter('train_steps_total', 'train steps run').inc()
    if batch:
        registry.counter('train_examples_total',
                         'examples consumed').inc(batch)
        if step_seconds > 0:
            registry.gauge('train_examples_per_second',
                           'examples/s of the measured step').set(
                               batch / step_seconds)


# the paged-serving families: (kind, name, help) with no labels, so
# registration alone creates the unlabeled child.
SERVING_PAGED_FAMILIES = (
    ('gauge', 'serving_kv_pages_in_use',
     'physical KV pages currently referenced (sequences + prefix cache)'),
    ('counter', 'serving_prefix_cache_hits_total',
     'full prompt blocks served from the prefix cache'),
    ('counter', 'serving_prefix_cache_misses_total',
     'full prompt blocks that had to prefill'),
    ('counter', 'serving_spec_tokens_proposed_total',
     'draft tokens proposed for speculative verification'),
    ('counter', 'serving_spec_tokens_accepted_total',
     'draft tokens accepted by the verify pass'),
)


def record_serving_schema(registry):
    """Register the paged-serving metric families on `registry` and
    return {name: family}. Used by ServingMetrics at construction."""
    out = {}
    for kind, name, doc in SERVING_PAGED_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc)
    return out


# the performance-introspection families (monitor/perf/): the compile
# watchdog, the step timeline and the cost model's gauges. Label budgets:
# kind is the three compile stages (trace = TorchDynamo's bytecode
# tracing, lower = AOTAutograd, compile = Inductor), phase the four
# step-timeline phases — both closed sets. The persistent-cache pair
# counts Inductor FX-graph-cache hits and misses.
PERF_FAMILIES = (
    ('counter', 'perf_compiles_total',
     'compile stage events seen by the CompileWatchdog', ('kind',)),
    ('histogram', 'perf_compile_seconds',
     'duration of trace/lower/compile stage events', ('kind',)),
    ('counter', 'perf_recompiles_total',
     'compiles after a declared warmup barrier '
     '(steady state must stay 0)', ()),
    ('histogram', 'perf_step_phase_seconds',
     'per-step phase durations '
     '(data_wait/host_dispatch/device_block/other)', ('phase',)),
    ('counter', 'perf_steps_total',
     'steps finalized by a StepTimeline', ()),
    ('counter', 'perf_stragglers_total',
     'steps slower than straggler_factor x the rolling median', ()),
    ('gauge', 'perf_mfu_est',
     'cost-model MFU estimate of the measured step', ()),
    ('gauge', 'perf_arithmetic_intensity',
     'analytic flops per byte accessed of the priced step', ()),
    ('gauge', 'perf_roofline_bound',
     'roofline classification of the priced step '
     '(0=bandwidth 1=compute)', ()),
    ('counter', 'perf_persistent_cache_hits_total',
     'compiles served from the Inductor FX graph cache', ()),
    ('counter', 'perf_persistent_cache_misses_total',
     'compiles that missed the Inductor FX graph cache', ()),
)


def record_perf_schema(registry):
    """Register the perf-introspection families on `registry` and return
    {name: family}. Used by CompileWatchdog / StepTimeline at
    construction and by the cost model's record()."""
    from .registry import exponential_buckets
    buckets = {
        # compile stages span ~1ms (a CPU toy) to minutes
        'perf_compile_seconds': exponential_buckets(0.001, 2.0, 18),
        # step phases span ~0.1ms (decode dispatch) to tens of seconds
        'perf_step_phase_seconds': exponential_buckets(1e-4, 2.0, 20),
    }
    out = {}
    for kind, name, doc, labels in PERF_FAMILIES:
        kw = {}
        if kind == 'histogram':
            kw['buckets'] = buckets[name]
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


def record_tracing_schema(registry):
    """Register the span-tracer health families (spans started /
    finished / dropped, flight dumps, exemplars, retention) on
    `registry`; tracers and the schema gate both go through
    tracing.register_metrics."""
    from . import tracing
    return tracing.register_metrics(registry)


# the per-request serving families (serving/metrics.py).
SERVING_REQUEST_FAMILIES = (
    ('counter', 'serving_requests_total',
     'requests submitted to the engine', ()),
    ('counter', 'serving_requests_admitted_total',
     'requests bound to a KV slot', ()),
    ('counter', 'serving_requests_retired_total',
     'requests finished and released', ()),
    ('counter', 'serving_tokens_total',
     'tokens emitted to consumers', ()),
    ('histogram', 'serving_ttft_seconds',
     'arrival to first visible token', ()),
    ('histogram', 'serving_inter_token_seconds',
     'per-token gap (burst spread over its tokens)', ()),
    ('gauge', 'serving_queue_depth',
     'requests waiting for a slot', ()),
    ('gauge', 'serving_occupancy',
     'occupied-slot fraction, last step', ()),
    ('counter', 'serving_prefill_tokens_total',
     'prompt tokens actually prefilled (prefix-cache hits excluded)', ()),
)


def record_serving_request_schema(registry):
    """Register the per-request serving families on `registry` and
    return {name: family}. Used by ServingMetrics at construction."""
    from .registry import exponential_buckets
    buckets = {
        # inter-token gaps live around 1-100 ms on hardware, seconds on
        # CPU CI; TTFT adds prefill, so its ladder starts higher
        'serving_ttft_seconds': exponential_buckets(0.002, 2.0, 16),
        'serving_inter_token_seconds': exponential_buckets(0.0005, 2.0,
                                                           16),
    }
    out = {}
    for kind, name, doc, labels in SERVING_REQUEST_FAMILIES:
        kw = {}
        if kind == 'histogram':
            kw['buckets'] = buckets[name]
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the wide-event request log's health families (monitor/events.py).
# Unlabeled — per-request detail lives in the events, never in labels.
REQUEST_EVENT_FAMILIES = (
    ('counter', 'request_events_total',
     'wide request events emitted (one per completed serving request)'),
    ('counter', 'request_events_dropped_total',
     'wide events evicted from the bounded in-memory ring'),
    ('counter', 'request_sink_rotations_total',
     'request-log JSONL sink files rotated at the size cap'),
)


def record_request_event_schema(registry):
    """Register the wide-event request-log families on `registry` and
    return {name: family}. Used by RequestLog at construction."""
    out = {}
    for kind, name, doc in REQUEST_EVENT_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc)
    return out


# the per-tenant attribution families. Label budget: tenant is BOUNDED
# by construction — events.TenantLabeler interns the
# first cap (default 16) distinct tenants and folds the rest into a
# fixed set of hashed overflow_<n> buckets, so worst-case cardinality is
# cap + overflow buckets + the 'default' label, independent of traffic.
TENANT_FAMILIES = (
    ('counter', 'tenant_requests_total',
     'requests completed per tenant', ('tenant',)),
    ('counter', 'tenant_tokens_total',
     'generated tokens delivered per tenant', ('tenant',)),
    ('histogram', 'tenant_ttft_seconds',
     'time to first token per tenant', ('tenant',)),
    ('counter', 'tenant_kv_byte_seconds_total',
     'KV-cache bytes held x seconds, attributed per tenant', ('tenant',)),
)


def record_tenant_schema(registry):
    """Register the per-tenant attribution families on `registry` and
    return {name: family}. Used by ServingMetrics at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in TENANT_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # same ladder as the unlabeled TTFT families
            kw['buckets'] = exponential_buckets(0.002, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the QoS enforcement families: the gateway's admission layer drives
# admitted / rejected / bucket level / per-priority TTFT, the engines
# drive preempt / resume. Label budgets: tenant is bounded by
# TenantLabeler as in TENANT_FAMILIES; reason is capacity.qos
# REJECT_REASONS (4 values); priority is the small set of configured
# tenant-class priorities. Label names are declared sorted.
QOS_FAMILIES = (
    ('counter', 'qos_admitted_total',
     'requests passed by the admission layer per tenant', ('tenant',)),
    ('counter', 'qos_rejected_total',
     'requests shed by the admission layer per reason and tenant',
     ('reason', 'tenant')),
    ('counter', 'qos_preempted_total',
     'KV-page preemptions of low-priority residents per tenant',
     ('tenant',)),
    ('counter', 'qos_resumed_total',
     'previously preempted requests re-admitted per tenant', ('tenant',)),
    ('gauge', 'qos_token_bucket_level',
     'remaining token-bucket credit per tenant at the last admission '
     'decision', ('tenant',)),
    ('histogram', 'qos_ttft_seconds',
     'time to first token per priority class (premium vs background)',
     ('priority',)),
)


def record_qos_schema(registry):
    """Register the QoS enforcement families on `registry` and return
    {name: family}. Used by the gateway and by ServingMetrics at
    construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in QOS_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # same ladder as the unlabeled TTFT families
            kw['buckets'] = exponential_buckets(0.002, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the gateway families (serving/gateway/gateway.py). Label budgets:
# replica is bounded by the pool size, direction is {up, down}.
GATEWAY_FAMILIES = (
    ('counter', 'gateway_requests_total',
     'requests accepted at the gateway front door', ()),
    ('counter', 'gateway_requests_completed_total',
     'requests fully delivered to the caller', ()),
    ('counter', 'gateway_tokens_total',
     'tokens delivered to callers across all replicas', ()),
    ('counter', 'gateway_route_total',
     'routing decisions per replica', ('replica',)),
    ('counter', 'gateway_retries_total',
     'submissions retried on another replica after a transport error',
     ()),
    ('counter', 'gateway_failover_total',
     'in-flight requests re-admitted after a replica loss', ()),
    ('counter', 'gateway_scale_events_total',
     'autoscaler actions taken', ('direction',)),
    ('gauge', 'gateway_replicas',
     'replicas currently alive (ready or draining)', ()),
    ('gauge', 'gateway_replica_state',
     'per-replica state (0=ready 1=draining 2=dead 3=stopped)',
     ('replica',)),
    ('gauge', 'gateway_queue_depth',
     'requests parked at the gateway awaiting a routable replica', ()),
    ('gauge', 'gateway_slo_burn_rate',
     'fraction of windowed TTFT samples over the SLO', ()),
    ('histogram', 'gateway_ttft_seconds',
     'time from gateway submission to first delivered token', ()),
)


def record_gateway_schema(registry):
    """Register the gateway metric families on `registry` and return
    {name: family}. Used by ServingGateway at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in GATEWAY_FAMILIES:
        kw = {}
        if kind == 'histogram':
            kw['buckets'] = exponential_buckets(0.002, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the RPC resilience families (distributed/resilience.py). Label
# budgets: endpoint is the bounded replica/server set; `to` is the three
# breaker states.
RPC_FAMILIES = (
    ('counter', 'rpc_attempts_total',
     'RPC attempts begun (first tries + retries)', ('endpoint',)),
    ('counter', 'rpc_attempt_failures_total',
     'retryable transport failures (each feeds the circuit breaker)',
     ('endpoint',)),
    ('counter', 'rpc_backoff_seconds_total',
     'seconds slept between retries', ('endpoint',)),
    ('counter', 'rpc_deadline_expired_total',
     'calls that died on their deadline', ('endpoint',)),
    ('counter', 'rpc_circuit_open_total',
     'calls fast-failed by an open breaker', ('endpoint',)),
    ('counter', 'rpc_breaker_transitions_total',
     'circuit-breaker state transitions', ('endpoint', 'to')),
    ('gauge', 'rpc_breaker_state',
     'current breaker state: 0 closed, 1 open, 2 half-open',
     ('endpoint',)),
)


def record_rpc_schema(registry):
    """Register the RPC resilience families on `registry` and return
    {name: family}."""
    out = {}
    for kind, name, doc, labels in RPC_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc, labels)
    return out


# the per-op client counters of the two socket services. Label budget:
# op is each service's closed OP_SEMANTICS vocabulary.
CLIENT_OP_FAMILIES = (
    ('counter', 'ps_client_calls_total',
     'embedding-service client RPCs by op', ('op',)),
    ('counter', 'ps_client_call_errors_total',
     'embedding-service client RPCs that raised', ('op',)),
    ('counter', 'graph_client_calls_total',
     'graph-service client RPCs by op', ('op',)),
    ('counter', 'graph_client_call_errors_total',
     'graph-service client RPCs that raised', ('op',)),
)


def record_client_op_schema(registry):
    """Register the service-client per-op counters on `registry` and
    return {name: family}."""
    out = {}
    for kind, name, doc, labels in CLIENT_OP_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc, labels)
    return out


# the multi-model serving registry/weight-paging families
# (serving/registry/). Single-source rule: ModelHost registers
# through record_registry_schema. Label
# budget (docs/observability.md): `model` is bounded by ModelLabeler —
# the TenantLabeler discipline applied to model names, so a caller
# spraying model ids can never explode cardinality.
REGISTRY_FAMILIES = (
    ('gauge', 'registry_resident_bytes',
     'artifact bytes of models currently paged in on this host', ()),
    ('gauge', 'registry_models_resident',
     'model versions currently resident on this host', ()),
    ('counter', 'registry_loads_total',
     'model loads (weight page-ins) per model', ('model',)),
    ('counter', 'registry_evictions_total',
     'model evictions (weight page-outs) per model', ('model',)),
    ('counter', 'registry_evictions_deferred_total',
     'evictions deferred because in-flight requests still referenced '
     'the weights', ()),
    ('histogram', 'registry_load_seconds',
     'wall seconds to bring a model resident (artifact load + engine '
     'build, warmup included when performed)', ()),
    ('counter', 'registry_warm_load_cache_hits_total',
     'persistent-compile-cache hits observed during warm model '
     'bring-ups (rollout warmups)', ()),
    ('counter', 'registry_warm_load_cache_misses_total',
     'persistent-compile-cache misses observed during warm model '
     'bring-ups (a rollout that recompiled)', ()),
    ('counter', 'registry_rollouts_total',
     'version rollouts completed per model', ('model',)),
)


def record_registry_schema(registry):
    """Register the model-registry/weight-paging families on `registry`
    and return {name: family}. Used by ModelHost at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in REGISTRY_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # spans a stub-engine reload (~ms) through a cold multi-GB
            # artifact load + compile (~minutes)
            kw['buckets'] = exponential_buckets(0.001, 2.0, 18)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw) \
            if labels else getattr(registry, kind)(name, doc, **kw)
    return out


# the capacity-planning families (capacity/): trace replay against the
# real gateway plus the discrete-event fleet simulator. Unlabeled —
# per-request and per-tenant detail lives in the wide events the runs
# emit, never in labels.
CAPACITY_FAMILIES = (
    ('counter', 'capacity_requests_replayed_total',
     'trace requests submitted by the open-loop replay harness'),
    ('counter', 'capacity_replay_runs_total',
     'completed open-loop trace replays'),
    ('histogram', 'capacity_replay_lag_seconds',
     'worst submit-behind-schedule lag per replay run'),
    ('counter', 'sim_requests_total',
     'requests pushed through the discrete-event fleet simulator'),
    ('counter', 'sim_runs_total',
     'completed fleet-simulator runs'),
    ('gauge', 'sim_last_p99_ttft_seconds',
     'p99 simulated TTFT of the most recent simulator run'),
)


def record_capacity_schema(registry):
    """Register the capacity-planning families on `registry` and return
    {name: family}. Used by capacity.replay when handed a registry."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc in CAPACITY_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # replay lag spans scheduler jitter (~ms) to a saturated
            # submitter falling a full trace behind (~minutes)
            kw['buckets'] = exponential_buckets(0.001, 2.0, 18)
        out[name] = getattr(registry, kind)(name, doc, **kw)
    return out


# the fleet-federation collector's health families (monitor/
# federation.py). Label budget: instance is the bounded set of registered
# scrape targets (replica indices / shard endpoints) — never per-request,
# never per-scrape.
FLEET_FAMILIES = (
    ('gauge', 'fleet_target_up',
     '1 when the last scrape of the target succeeded, else 0',
     ('instance',)),
    ('gauge', 'fleet_target_staleness_seconds',
     'seconds since the target last scraped successfully '
     '(-1 = never scraped)', ('instance',)),
    ('gauge', 'fleet_targets',
     'scrape targets registered with the collector', ()),
    ('counter', 'fleet_scrapes_total',
     'federation scrape cycles completed', ()),
    ('counter', 'fleet_scrape_errors_total',
     'failed target scrapes (target kept stale, never dropped)',
     ('instance',)),
    ('histogram', 'fleet_scrape_seconds',
     'wall time of one federation scrape cycle', ()),
    ('counter', 'fleet_merge_conflicts_total',
     'families dropped from a merge for type/label/bucket mismatch',
     ()),
)


def record_fleet_schema(registry):
    """Register the federation families on `registry` and return
    {name: family}. Used by FleetCollector at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in FLEET_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # a cycle spans sub-ms (in-proc) to seconds (slow HTTP peer)
            kw['buckets'] = exponential_buckets(0.0005, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the SLO alerting families (monitor/alerts.py). Label budgets: rule is
# the declared rule set; `to` is the closed lifecycle vocabulary
# {pending, firing, resolved, inactive}.
ALERT_FAMILIES = (
    ('gauge', 'alerts_firing',
     '1 while the rule is firing', ('rule',)),
    ('gauge', 'alerts_pending',
     '1 while the rule is pending (condition true, for_duration not '
     'yet met)', ('rule',)),
    ('counter', 'alerts_transitions_total',
     'alert lifecycle transitions taken', ('rule', 'to')),
    ('counter', 'alerts_evaluations_total',
     'alert evaluation passes', ()),
)


def record_alert_schema(registry):
    """Register the alerting families on `registry` and return
    {name: family}. Used by AlertManager at construction."""
    out = {}
    for kind, name, doc, labels in ALERT_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc, labels)
    return out

# the training-loop families hapi.callbacks adds beyond the dryrun step
# gauges.
TRAIN_LOOP_FAMILIES = (
    ('histogram', 'train_step_duration_seconds',
     'train step wall time', ()),
    ('gauge', 'train_epoch', 'current epoch index', ()),
)


def record_train_loop_schema(registry):
    """Register the TelemetryCallback-only training families on
    `registry` and return {name: family}."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in TRAIN_LOOP_FAMILIES:
        kw = {}
        if kind == 'histogram':
            kw['buckets'] = exponential_buckets(0.001, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the elastic-supervisor families (distributed/supervisor.py). Label
# budgets: role is the closed shard vocabulary {trainer, ps, graph};
# kind is {periodic, urgent}; stage is the escalation ladder
# {restart, restore, abort}. The shard families stay registered for the
# schema's sake; the port's supervisor has no shards yet.
SUPERVISOR_FAMILIES = (
    ('counter', 'supervisor_restarts_total',
     'shard restarts driven by the supervisor', ('role',)),
    ('histogram', 'supervisor_recover_seconds',
     'MTTR: liveness-miss detection to shard recovered', ()),
    ('counter', 'supervisor_checkpoints_total',
     'training checkpoints written by the supervisor', ('kind',)),
    ('counter', 'supervisor_preemptions_total',
     'preemption notices honored with an urgent checkpoint', ()),
    ('counter', 'supervisor_journal_replays_total',
     'journaled push entries replayed after a shard recovery', ()),
    ('counter', 'supervisor_journal_dedup_hits_total',
     'replayed/retried journaled pushes the server deduplicated', ()),
    ('counter', 'supervisor_escalations_total',
     'recovery escalation stages entered', ('stage',)),
    ('gauge', 'supervisor_shards_alive',
     'shards passing liveness at the last heartbeat round', ()),
)


def record_supervisor_schema(registry):
    """Register the elastic-supervisor families on `registry` and return
    {name: family}. Used by the supervisor at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in SUPERVISOR_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # recovery spans ~10ms (in-proc restart) to minutes (pod
            # reschedule + snapshot restore + journal replay)
            kw['buckets'] = exponential_buckets(0.01, 2.0, 16)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


# the streaming ingestion plane's families (data/). Unlabeled: a pipeline
# is a per-process object; per-shard and per-epoch detail lives in the
# cursor, never in labels.
INGEST_FAMILIES = (
    ('counter', 'ingest_records_total',
     'records emitted downstream by the ingestion pipeline'),
    ('counter', 'ingest_batches_total',
     'collated batches delivered to the consumer'),
    ('counter', 'ingest_bytes_read_total',
     'shard payload bytes read off disk'),
    ('gauge', 'ingest_queue_depth',
     'prefetched batches parked in the bounded hand-off queue'),
    ('counter', 'ingest_backpressure_seconds_total',
     'producer seconds blocked on a full prefetch queue '
     '(consumer is the bottleneck)'),
    ('counter', 'ingest_wait_seconds_total',
     'consumer seconds blocked waiting for a batch '
     '(the data_wait the StepTimeline charges to input)'),
    ('gauge', 'ingest_examples_per_second',
     'examples/s over the last completed epoch'),
    ('counter', 'ingest_epochs_total',
     'epochs fully streamed by the pipeline'),
    ('counter', 'ingest_resumes_total',
     'mid-epoch cursor restores (seek, not drain)'),
)


def record_ingest_schema(registry):
    """Register the streaming-ingestion families on `registry` and
    return {name: family}. Used by IngestPipeline at construction."""
    out = {}
    for kind, name, doc in INGEST_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc)
    return out


def dryrun_registry(step_seconds, loss, batch=None, registry=None):
    """Fresh per-config registry holding the full telemetry schema:
    training gauges + every subsystem's families + one runtime sample.
    Pass `registry` to fold live instrumentation into the snapshot
    (families already present are reused via get-or-create)."""
    from .runtime import RuntimeSampler
    reg = registry if registry is not None else MetricRegistry()
    record_dryrun_step(reg, step_seconds, loss, batch=batch)
    record_serving_schema(reg)
    record_serving_request_schema(reg)
    record_gateway_schema(reg)
    record_tracing_schema(reg)
    record_perf_schema(reg)
    record_rpc_schema(reg)
    record_client_op_schema(reg)
    record_train_loop_schema(reg)
    record_fleet_schema(reg)
    record_alert_schema(reg)
    record_supervisor_schema(reg)
    record_request_event_schema(reg)
    record_tenant_schema(reg)
    record_qos_schema(reg)
    record_capacity_schema(reg)
    record_ingest_schema(reg)
    record_registry_schema(reg)
    RuntimeSampler(registry=reg).sample_once()
    return reg


def snapshot_line(registry, n_devices, tag):
    """One parseable line embedding the registry snapshot (no per-bucket
    detail — schema + scalar values only, keeps the line short).

    `tag` is the driver's config label INCLUDING its brackets (e.g.
    '[dp/mp]')."""
    snap = export.to_dict(registry, buckets=False)
    return 'telemetry_snapshot(%d)%s: %s' % (
        n_devices, tag, json.dumps(snap, sort_keys=True,
                                   separators=(',', ':')))


def parse_snapshot_lines(text):
    """{tag: snapshot dict} from captured driver output (tolerates
    interleaved non-telemetry lines; later duplicates of a tag win)."""
    out = {}
    for line in (text or '').splitlines():
        m = LINE_RE.search(line)
        if not m:
            continue
        try:
            out[m.group('tag')] = json.loads(m.group('json'))
        except ValueError:
            continue
    return out
