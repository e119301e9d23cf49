"""Metric-family schemas of the serving path (counterpart of
paddle_tpu/monitor/telemetry.py): the `record_*_schema` functions that the
port's serving metrics, request log, step timeline, gateway, circuit
breakers and RPC channels, model hosts and trace replay register through, each with the reference's
family names, label names and label order. The dryrun snapshot lines, the
schema baseline gate and the families of subsystems the port does not
have (the compile watchdog, the cost model, the request log's file sink)
are not ported.
"""
__all__ = ['record_serving_schema', 'record_serving_request_schema',
           'record_perf_schema', 'record_request_event_schema',
           'record_tenant_schema', 'record_qos_schema',
           'record_gateway_schema', 'record_rpc_schema',
           'record_client_op_schema', 'record_registry_schema',
           'record_capacity_schema', 'SERVING_PAGED_FAMILIES',
           'PERF_FAMILIES', 'SERVING_REQUEST_FAMILIES',
           'REQUEST_EVENT_FAMILIES', 'TENANT_FAMILIES', 'QOS_FAMILIES',
           'GATEWAY_FAMILIES', 'RPC_FAMILIES', 'CLIENT_OP_FAMILIES',
           'REGISTRY_FAMILIES', 'CAPACITY_FAMILIES']


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


# the step-timeline families (monitor/perf/timeline.py). Label budget:
# phase is the four step-timeline phases, a closed set.
PERF_FAMILIES = (
    ('histogram', 'perf_step_phase_seconds',
     'per-step phase durations '
     '(data_wait/host_dispatch/device_block/other)', ('phase',)),
    ('counter', 'perf_steps_total',
     'steps finalized by a StepTimeline', ()),
    ('counter', 'perf_stragglers_total',
     'steps slower than straggler_factor x the rolling median', ()),
)


def record_perf_schema(registry):
    """Register the step-timeline families on `registry` and return
    {name: family}. Used by StepTimeline at construction."""
    from .registry import exponential_buckets
    out = {}
    for kind, name, doc, labels in PERF_FAMILIES:
        kw = {}
        if kind == 'histogram':
            # step phases span ~0.1ms (decode dispatch) to tens of seconds
            kw['buckets'] = exponential_buckets(1e-4, 2.0, 20)
        out[name] = getattr(registry, kind)(name, doc, labels, **kw)
    return out


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
# real gateway plus the fleet simulator's (the simulator is not ported;
# its families keep the reference's table whole). Unlabeled —
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
