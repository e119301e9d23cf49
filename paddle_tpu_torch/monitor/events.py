"""Wide-event request log of the port's serving engines (counterpart of
paddle_tpu/monitor/events.py, cut to what the engines call): ONE
canonical structured record per serving request.

Every request emits exactly one wide event at completion carrying its
whole lifecycle: identity (request_id, tenant, trace_id), the four
lifecycle timestamps, queue wait, prefill shape, token counts,
prefix-cache and speculation outcomes, the integrated KV page·seconds
the request held, and the terminal outcome. The trace_id links the event
to the request's spans in the tracer's ring (tracing.py).

- the disabled fast path is one attribute load + one branch (`enabled`
  is a plain attribute; disabled ``emit`` returns immediately);
- the in-memory ring is bounded and evictions are counted;
- the schema is single-source: REQUEST_EVENT_FIELDS below is the only
  place field names are declared, and emission validates against it.

The reference's JSONL sink and dryrun event lines feed its gateway and
report tools, which the port does not have yet.

Tenant labels are BOUNDED by construction: TenantLabeler interns the
first `cap` distinct tenants it sees and folds everything else into a
fixed set of hashed ``overflow_<n>`` buckets, so per-tenant metric
families can never explode cardinality no matter what callers send.
"""
import collections
import threading
import zlib

from .registry import default_registry
from .telemetry import record_request_event_schema

__all__ = ['REQUEST_EVENT_FIELDS', 'FIELD_NAMES', 'RequestLog',
           'TenantLabeler', 'ModelLabeler', 'default_request_log',
           'set_default_request_log']

# The canonical wide-event schema: (field, help), the reference's own,
# so one request's record reads the same from either package.
REQUEST_EVENT_FIELDS = (
    ('request_id', 'engine- or gateway-level request id'),
    ('tenant', 'normalized tenant label (bounded cardinality)'),
    ('model', 'normalized model label (bounded cardinality; None when '
     'the request did not target a named model)'),
    ('priority', 'scheduling priority (int, higher preempts lower)'),
    ('trace_id', 'trace id of the span tree that completed the request'),
    ('arrival_t', 'wall-clock submission time'),
    ('admit_t', 'wall-clock KV-slot admission time (None: never admitted)'),
    ('first_token_t', 'wall-clock time of the first generated token'),
    ('finish_t', 'wall-clock completion time'),
    ('queue_wait_s', 'admit_t - arrival_t'),
    ('prefill_chunks', 'chunked-prefill steps the prompt took'),
    ('prompt_tokens', 'prompt length in tokens'),
    ('output_tokens', 'generated tokens delivered'),
    ('prefix_hit_tokens', 'prompt tokens served from the prefix cache'),
    ('spec_proposed', 'speculative draft tokens proposed'),
    ('spec_accepted', 'speculative draft tokens accepted'),
    ('kv_page_seconds', 'integral of KV pages (slots) held x seconds'),
    ('failovers', 'times the request was re-placed after a replica loss'),
    ('replicas', 'replica endpoints traversed, in placement order'),
    ('outcome',
     "terminal outcome: 'ok' | 'error' | 'rejected' | 'preempted'"),
)

FIELD_NAMES = tuple(name for name, _ in REQUEST_EVENT_FIELDS)
_FIELD_SET = frozenset(FIELD_NAMES)

class RequestLog:
    """Bounded ring of wide request events.

    ``enabled`` is a plain attribute so the hot path pays one load + one
    branch when the log is off. The ring is mutated under one private
    lock: ``emit`` is called from whichever thread drives an engine."""

    def __init__(self, capacity=2048, registry=None, enabled=True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        reg = registry if registry is not None else default_registry()
        fams = record_request_event_schema(reg)
        self._m_emitted = fams['request_events_total']
        self._m_dropped = fams['request_events_dropped_total']

    def enable(self):
        self.enabled = True

    def disable(self):
        """Freeze the log: ``emit`` becomes a branch; the ring keeps
        whatever it already holds."""
        self.enabled = False

    def emit(self, **fields):
        """Record one wide event. Unknown field names raise — emission
        sites must speak the canonical REQUEST_EVENT_FIELDS schema.
        Missing fields are recorded as None. Returns the canonical dict,
        or None when disabled."""
        if not self.enabled:
            return None
        unknown = [k for k in fields if k not in _FIELD_SET]
        if unknown:
            raise ValueError('unknown wide-event field(s) %s; the schema '
                             'is events.REQUEST_EVENT_FIELDS'
                             % sorted(unknown))
        event = {name: fields.get(name) for name in FIELD_NAMES}
        with self._lock:
            if len(self._ring) == self.capacity:
                self._m_dropped.inc()
            self._ring.append(event)
            self._m_emitted.inc()
        return event

    def events(self):
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    @property
    def dropped(self):
        """Events evicted from the ring since construction."""
        return int(self._m_dropped.value())

    def clear(self):
        with self._lock:
            self._ring.clear()

    def __len__(self):
        with self._lock:
            return len(self._ring)


class TenantLabeler:
    """Bounded-cardinality tenant → metric-label mapping.

    The first `cap` distinct tenants keep their own label; everything
    after that folds into one of `buckets` stable hashed
    ``overflow_<n>`` labels (crc32, not Python's randomized hash, so
    the bucket is the same across processes and restarts). None maps to
    'default'. Worst-case label cardinality: cap + buckets + 1."""

    def __init__(self, cap=16, buckets=4):
        self.cap = int(cap)
        self.buckets = int(buckets)
        self._seen = set()
        self._lock = threading.Lock()

    def label(self, tenant):
        if tenant is None:
            return 'default'
        t = str(tenant)
        with self._lock:
            if t in self._seen:
                return t
            if len(self._seen) < self.cap:
                self._seen.add(t)
                return t
        return 'overflow_%d' % (zlib.crc32(t.encode('utf-8'))
                                % self.buckets)


class ModelLabeler(TenantLabeler):
    """TenantLabeler's bounded-cardinality discipline applied to model
    names, with one semantic difference: None stays None — a request
    that never targeted a named model (every single-model deployment)
    records a null `model` field rather than inventing a default, so
    per-model rollups only ever contain models callers actually named.
    """

    def label(self, model):
        if model is None:
            return None
        return super().label(model)


_default = RequestLog()
_default_lock = threading.Lock()


def default_request_log():
    """The process-wide request log every built-in emission site uses
    unless handed an explicit one."""
    return _default


def set_default_request_log(log):
    """Swap the process default (tests/benches); returns the previous
    one. Objects that cached the old log at construction keep it —
    swap BEFORE constructing the engines under test."""
    global _default
    with _default_lock:
        prev, _default = _default, log
        return prev
