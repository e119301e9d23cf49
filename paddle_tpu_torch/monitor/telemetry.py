"""Metric-family schemas of the serving path (counterpart of
paddle_tpu/monitor/telemetry.py): the `record_*_schema` functions that the
port's serving metrics, request log and step timeline register through,
each with the reference's names for the families the port drives. The
dryrun snapshot lines, the schema baseline gate and the families of
subsystems the port does not have (the compile watchdog, the cost model,
the gateway's admission layer, the request log's file sink) are not
ported.
"""
__all__ = ['record_serving_schema', 'record_serving_request_schema',
           'record_perf_schema', 'record_request_event_schema',
           'record_tenant_schema', 'record_qos_schema',
           'SERVING_PAGED_FAMILIES', 'PERF_FAMILIES',
           'SERVING_REQUEST_FAMILIES', 'REQUEST_EVENT_FAMILIES',
           'TENANT_FAMILIES', 'QOS_FAMILIES']


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


# the QoS families the engines drive: preempt / resume traffic per
# tenant (the reference's admission-layer members are the gateway's).
# Label budget: tenant is bounded by TenantLabeler as in TENANT_FAMILIES.
QOS_FAMILIES = (
    ('counter', 'qos_preempted_total',
     'KV-page preemptions of low-priority residents per tenant',
     ('tenant',)),
    ('counter', 'qos_resumed_total',
     'previously preempted requests re-admitted per tenant', ('tenant',)),
)


def record_qos_schema(registry):
    """Register the QoS families on `registry` and return
    {name: family}. Used by ServingMetrics at construction."""
    return {name: getattr(registry, kind)(name, doc, labels)
            for kind, name, doc, labels in QOS_FAMILIES}
