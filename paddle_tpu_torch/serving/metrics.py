"""Serving metrics: throughput, per-token latency percentiles, occupancy
(counterpart of paddle_tpu/serving/metrics.py, copied; report() adds
ttft_p99_ms).

Fed by the engine with wall-clock timestamps (injectable clock for
deterministic tests). The latency distribution that matters for serving
is PER-TOKEN (inter-token gap) plus time-to-first-token — a mean hides
exactly the tail that continuous batching is supposed to fix, hence
p50/p99.

Two outputs from the same events:

- ``report()`` — the in-process dict the benches and tests consume
  (unchanged public API);
- the shared monitor registry (paddle_tpu_torch/monitor) — labeled
  counters / gauges / histograms under the reference's family names.
"""
import time

from ..monitor import tracing as _tracing
from ..monitor.events import ModelLabeler, TenantLabeler
from ..monitor.registry import default_registry
from ..monitor.telemetry import (record_qos_schema,
                                 record_serving_schema,
                                 record_serving_request_schema,
                                 record_tenant_schema)

__all__ = ['ServingMetrics', 'percentile']


def percentile(values, q):
    """Linear-interpolation percentile (q in [0, 100]) without numpy —
    interpolates between the two closest ranks, matching numpy's default
    ('linear') method, NOT nearest-rank."""
    if not values:
        return None
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class ServingMetrics:
    def __init__(self, clock=None, registry=None):
        self._clock = clock or time.monotonic
        self.registry = registry if registry is not None \
            else default_registry()
        self._start = None
        self._end = None
        self._arrival = {}        # rid -> t
        self._first_token = {}    # rid -> t
        self._last_token = {}     # rid -> t of the latest token
        self._gaps = []           # inter-token gaps (incl. arrival->first)
        self._tokens = 0
        self._occupancy = []      # per-step occupied-slot fractions
        r = self.registry
        # per-request families come from the single-source schema table
        # (monitor/telemetry.py SERVING_REQUEST_FAMILIES)
        req = record_serving_request_schema(r)
        self._m_requests = req['serving_requests_total']
        self._m_admitted = req['serving_requests_admitted_total']
        self._m_retired = req['serving_requests_retired_total']
        self._m_tokens = req['serving_tokens_total']
        self._m_ttft = req['serving_ttft_seconds']
        self._m_gap = req['serving_inter_token_seconds']
        self._m_queue = req['serving_queue_depth']
        self._m_occupancy = req['serving_occupancy']
        self._m_prefill = req['serving_prefill_tokens_total']
        # paged-engine families; registered unconditionally (zeros for
        # the slot engine) so the scrape schema does not depend on which
        # engine a process happens to run
        paged = record_serving_schema(r)
        self._m_pages = paged['serving_kv_pages_in_use']
        self._m_prefix_hits = paged['serving_prefix_cache_hits_total']
        self._m_prefix_misses = paged['serving_prefix_cache_misses_total']
        self._m_spec_proposed = paged['serving_spec_tokens_proposed_total']
        self._m_spec_accepted = paged['serving_spec_tokens_accepted_total']
        self._m_exemplars = _tracing.register_metrics(
            r)['trace_exemplars_total']
        # per-tenant attribution families (bounded cardinality: the
        # labeler interns a capped tenant set + hashed overflow buckets)
        tenant = record_tenant_schema(r)
        self._m_tenant_requests = tenant['tenant_requests_total']
        self._m_tenant_tokens = tenant['tenant_tokens_total']
        self._m_tenant_ttft = tenant['tenant_ttft_seconds']
        self._m_tenant_kv = tenant['tenant_kv_byte_seconds_total']
        # QoS families (preempt/resume counters)
        qos = record_qos_schema(r)
        self._m_qos_preempted = qos['qos_preempted_total']
        self._m_qos_resumed = qos['qos_resumed_total']
        self._labeler = TenantLabeler()
        self._model_labeler = ModelLabeler()
        self._prefill_tokens = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._pages_in_use = 0

    def now(self):
        return self._clock()

    def on_arrival(self, rid, t=None):
        t = self.now() if t is None else t
        self._arrival[rid] = t
        if self._start is None:
            self._start = t
        self._m_requests.inc()

    def on_admitted(self, rid, t=None):
        self._m_admitted.inc()

    def on_retired(self, rid, t=None):
        self._m_retired.inc()

    def on_queue_depth(self, depth):
        self._m_queue.set(depth)

    def on_tokens(self, rid, count, t=None, trace_id=None):
        """`count` tokens became visible for request rid at time t.

        Decode runs in bursts of K steps per dispatch, so K tokens land
        at once; the burst's gap is spread over its tokens — the honest
        accounting, since a consumer reading the stream experiences the
        burst wait once per K tokens.

        A non-None trace_id rides the TTFT / inter-token histogram
        observations as an exemplar, so an outlier bucket in a scrape
        links back to the trace that produced it.
        """
        if count <= 0:
            return
        t = self.now() if t is None else t
        prev = self._last_token.get(rid)
        if rid not in self._first_token:
            self._first_token[rid] = t
            prev = self._arrival.get(rid, t)
            if rid in self._arrival:
                self._m_ttft.observe(t - self._arrival[rid],
                                     exemplar=trace_id)
                if trace_id is not None:
                    self._m_exemplars.inc()
        if prev is not None:
            gap = (t - prev) / count
            self._gaps.extend([gap] * count)
            for _ in range(count):
                self._m_gap.observe(gap, exemplar=trace_id)
            if trace_id is not None:
                self._m_exemplars.inc(count)
        self._last_token[rid] = t
        self._tokens += count
        self._m_tokens.inc(count)
        self._end = t

    def on_step(self, occupied, num_slots):
        frac = occupied / float(num_slots)
        self._occupancy.append(frac)
        self._m_occupancy.set(frac)

    def on_prefill_tokens(self, count):
        """`count` prompt tokens were actually forwarded through the
        model (prefix-cache hits never reach here — the win IS the
        missing increments)."""
        self._prefill_tokens += count
        self._m_prefill.inc(count)

    def on_pages_in_use(self, pages):
        self._pages_in_use = pages
        self._m_pages.set(pages)

    def on_prefix_lookup(self, hits, misses):
        """Deltas: `hits` full blocks served from the prefix cache,
        `misses` full blocks that had to prefill, since last call."""
        if hits:
            self._prefix_hits += hits
            self._m_prefix_hits.inc(hits)
        if misses:
            self._prefix_misses += misses
            self._m_prefix_misses.inc(misses)

    def tenant_label(self, tenant):
        """The bounded metric label for `tenant` (None -> 'default')."""
        return self._labeler.label(tenant)

    def model_label(self, model):
        """The bounded metric label for `model` (None stays None — a
        request without a named model is unattributed, not 'default')."""
        return self._model_labeler.label(model)

    def on_tenant_tokens(self, label, count):
        """`count` generated tokens attributed to tenant `label` (a
        value from tenant_label, never a raw caller string)."""
        if count > 0:
            self._m_tenant_tokens.labels(label).inc(count)

    def on_tenant_ttft(self, label, seconds):
        self._m_tenant_ttft.labels(label).observe(seconds)

    def on_tenant_retired(self, label, kv_byte_seconds):
        """One request of tenant `label` finished having integrated
        `kv_byte_seconds` of KV-cache residency."""
        self._m_tenant_requests.labels(label).inc()
        if kv_byte_seconds > 0:
            self._m_tenant_kv.labels(label).inc(kv_byte_seconds)

    def on_preempted(self, label):
        """One resident of tenant `label` had its KV pages evicted to
        make room for a higher-priority request."""
        self._m_qos_preempted.labels(label).inc()

    def on_resumed(self, label):
        """One previously preempted request of tenant `label` was
        re-admitted (fast-forwarded through the prefix cache)."""
        self._m_qos_resumed.labels(label).inc()

    def on_spec(self, proposed, accepted):
        """One speculative verify pass: `proposed` draft tokens went in,
        `accepted` matched the model's own picks."""
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._m_spec_proposed.inc(proposed)
        if accepted:
            self._m_spec_accepted.inc(accepted)

    def report(self):
        elapsed = ((self._end - self._start)
                   if self._start is not None and self._end is not None
                   else 0.0)
        ttft = [self._first_token[r] - self._arrival[r]
                for r in self._first_token if r in self._arrival]
        lookups = self._prefix_hits + self._prefix_misses
        return {
            'tokens': self._tokens,
            'elapsed_s': elapsed,
            'tok_per_s': self._tokens / elapsed if elapsed > 0 else 0.0,
            'latency_p50_ms': _ms(percentile(self._gaps, 50)),
            'latency_p99_ms': _ms(percentile(self._gaps, 99)),
            'ttft_p50_ms': _ms(percentile(ttft, 50)),
            'ttft_p99_ms': _ms(percentile(ttft, 99)),
            'occupancy_mean': (sum(self._occupancy) / len(self._occupancy)
                               if self._occupancy else 0.0),
            'prefill_tokens': self._prefill_tokens,
            'pages_in_use': self._pages_in_use,
            'prefix_hits': self._prefix_hits,
            'prefix_misses': self._prefix_misses,
            'prefix_hit_rate': (self._prefix_hits / lookups
                                if lookups else 0.0),
            'spec_proposed': self._spec_proposed,
            'spec_accepted': self._spec_accepted,
            'spec_accept_rate': (self._spec_accepted / self._spec_proposed
                                 if self._spec_proposed else 0.0),
        }


def _ms(x):
    return None if x is None else x * 1e3
