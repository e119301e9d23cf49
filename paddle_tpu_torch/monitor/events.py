"""Wide-event request log (counterpart of paddle_tpu/monitor/events.py,
copied: it needs nothing but the standard library): ONE canonical
structured record per serving request.

Metrics answer "what is the fleet's p99"; this module answers "why was
request X slow" and "which tenant held the KV pool". Every serving
request — engine-direct or gateway-fronted — emits exactly one wide
event at completion carrying the whole request lifecycle: identity
(request_id, tenant, trace_id), the four lifecycle timestamps, queue
wait, prefill shape, token counts, prefix-cache and speculation
outcomes, the integrated KV page·seconds the request held, the failover
history, and the terminal outcome. The trace_id links the event to the
tail-retained span tree (tracing.TraceRetention).

Discipline (matching registry/tracing):
- the disabled fast path is one attribute load + one branch (`enabled`
  is a plain attribute; disabled ``emit`` returns immediately);
- the in-memory ring is bounded and evictions are counted, never
  silent; the optional JSONL sink (`sink_path`, or the
  PADDLE_TPU_REQUEST_LOG environment variable) rotates at a size cap,
  in the JAX package's line format, so tools/request_report.py,
  tools/registry_report.py and tools/capacity_report.py read either
  package's sink;
- the schema is single-source: REQUEST_EVENT_FIELDS below is the only
  place field names are declared, and emission validates against it at
  runtime. PADDLE_TPU_REQUEST_EVENTS=0 turns the default log off.

Tenant labels are BOUNDED by construction: TenantLabeler interns the
first `cap` distinct tenants it sees and folds everything else into a
fixed set of hashed ``overflow_<n>`` buckets, so per-tenant metric
families can never explode cardinality no matter what callers send.
"""
import collections
import json
import os
import re
import threading
import zlib

from .registry import default_registry
from .telemetry import record_request_event_schema

__all__ = ['REQUEST_EVENT_FIELDS', 'FIELD_NAMES', 'RequestLog',
           'TenantLabeler', 'ModelLabeler', 'default_request_log',
           'set_default_request_log', 'event_line', 'parse_event_lines',
           'EVENT_LINE_RE']

# The canonical wide-event schema: (field, help), the reference's own, so
# one request's record reads the same from either package. The runtime
# validator, the /requests route and the report tools key off it.
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

# parseable dryrun surface, the telemetry_snapshot pattern applied to
# wide events: `request_event(N)[tag]: {json}`
EVENT_LINE_RE = re.compile(r'request_event\((?P<n>\d+)\)'
                           r'\[(?P<tag>[^\]]*)\]:\s*(?P<json>\{.*\})\s*$')


class RequestLog:
    """Bounded ring + rotating JSONL sink of wide request events.

    ``enabled`` is a plain attribute so the hot path pays one load + one
    branch when the log is off (the registry's ~90 ns discipline). All
    ring/sink mutation happens under one private lock — ``emit`` is
    called from engine driver threads and the gateway collector thread
    concurrently."""

    def __init__(self, capacity=2048, sink_path=None,
                 max_sink_bytes=4 << 20, sink_backups=2,
                 registry=None, enabled=True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.sink_path = sink_path if sink_path is not None \
            else os.environ.get('PADDLE_TPU_REQUEST_LOG') or None
        self.max_sink_bytes = int(max_sink_bytes)
        self.sink_backups = int(sink_backups)
        self._sink_bytes = None  # lazily sized on first write
        reg = registry if registry is not None else default_registry()
        fams = record_request_event_schema(reg)
        self._m_emitted = fams['request_events_total']
        self._m_dropped = fams['request_events_dropped_total']
        self._m_rotations = fams['request_sink_rotations_total']

    def enable(self):
        self.enabled = True

    def disable(self):
        """Freeze the log: ``emit`` becomes a branch; the ring keeps
        whatever it already holds."""
        self.enabled = False

    def emit(self, **fields):
        """Record one wide event. Unknown field names raise — emission
        sites must speak the canonical REQUEST_EVENT_FIELDS schema. Missing
        fields are recorded as None. Returns the canonical dict, or
        None when disabled."""
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
            if self.sink_path:
                self._sink_write_locked(event)
        return event

    def _sink_write_locked(self, event):
        line = json.dumps(event, sort_keys=True) + '\n'
        data = line.encode('utf-8')
        if self._sink_bytes is None:
            try:
                self._sink_bytes = os.path.getsize(self.sink_path)
            except OSError:
                self._sink_bytes = 0
        if self._sink_bytes and \
                self._sink_bytes + len(data) > self.max_sink_bytes:
            self._rotate_locked()
        with open(self.sink_path, 'ab') as f:
            f.write(data)
        self._sink_bytes += len(data)

    def _rotate_locked(self):
        """path.(n-1) -> path.n ... path -> path.1; the oldest backup
        falls off the end."""
        for i in range(self.sink_backups, 0, -1):
            src = self.sink_path if i == 1 else \
                '%s.%d' % (self.sink_path, i - 1)
            dst = '%s.%d' % (self.sink_path, i)
            if os.path.exists(src):
                os.replace(src, dst)
        self._sink_bytes = 0
        self._m_rotations.inc()

    def events(self, tenant=None, model=None, outcome=None,
               min_failovers=None, since_ts=None, until_ts=None,
               limit=None):
        """Snapshot of the ring (oldest first), optionally filtered.
        ``since_ts``/``until_ts`` select the half-open arrival-time
        window [since, until) in the log's own clock (the gateway's
        monotonic timestamps) — how the capacity replay loader slices
        one run out of a longer recording. ``limit`` keeps the newest N
        after filtering."""
        with self._lock:
            out = list(self._ring)
        if tenant is not None:
            out = [e for e in out if e['tenant'] == tenant]
        if model is not None:
            out = [e for e in out if e.get('model') == model]
        if outcome is not None:
            out = [e for e in out if e['outcome'] == outcome]
        if min_failovers is not None:
            out = [e for e in out
                   if (e['failovers'] or 0) >= min_failovers]
        if since_ts is not None:
            since_ts = float(since_ts)
            out = [e for e in out
                   if e['arrival_t'] is not None
                   and e['arrival_t'] >= since_ts]
        if until_ts is not None:
            until_ts = float(until_ts)
            out = [e for e in out
                   if e['arrival_t'] is not None
                   and e['arrival_t'] < until_ts]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

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


def _env_enabled():
    v = os.environ.get('PADDLE_TPU_REQUEST_EVENTS', '1').strip().lower()
    return v not in ('0', 'false', 'off', 'no', '')


_default = RequestLog(enabled=_env_enabled())
_default_lock = threading.Lock()


def default_request_log():
    """The process-wide request log every built-in emission site uses
    unless handed an explicit one."""
    return _default


def set_default_request_log(log):
    """Swap the process default (tests/benches); returns the previous
    one. Objects that cached the old log at construction keep it —
    swap BEFORE constructing the engines/gateway under test."""
    global _default
    with _default_lock:
        prev, _default = _default, log
        return prev


def event_line(event, n_devices, tag):
    """One parseable line embedding a wide event — the
    telemetry_snapshot convention applied to the request log, so driver
    captures carry a schema-complete event for offline joins
    (tools/request_report.py parses these alongside JSONL sinks)."""
    return 'request_event(%d)%s: %s' % (
        n_devices, tag, json.dumps(event, sort_keys=True,
                                   separators=(',', ':')))


def parse_event_lines(text):
    """[(tag, event dict)] from captured driver output (tolerates
    interleaved non-event lines)."""
    out = []
    for line in (text or '').splitlines():
        m = EVENT_LINE_RE.search(line)
        if not m:
            continue
        try:
            out.append((m.group('tag'), json.loads(m.group('json'))))
        except ValueError:
            continue
    return out
