"""Distributed request tracing (counterpart of
paddle_tpu/monitor/tracing.py, copied: it needs nothing but the standard
library).

The metrics registry (registry.py) says HOW MUCH; this module says WHERE
TIME WENT for one request. Three consumers ride on it:

- **Cross-process propagation** — an RPC client
  (distributed/resilience.py's ResilientChannel) injects each attempt
  span's context into its message under ``TRACE_KEY``; a server (the
  fabric's worker and artifact server, the PS and graph servers) pops it
  with ``Tracer.server_span`` and continues the trace.
- **Serving lifecycle** — the slot/paged engines emit
  queued→admit→prefill→decode→retire spans with prefix-cache-hit and
  spec-accept events, and TTFT/inter-token histogram observations carry
  trace_id exemplars so an outlier bucket links back to its trace.
- **Flight recorder + export** — every finished span lands in a bounded
  ring (``FlightRecorder``); circuit-open, deadline-expiry, chaos faults,
  supervisor recoveries, alert firing edges and recompiles trigger JSON
  dumps in the JAX package's format (``tools/perf_report.py`` and
  ``tools/fleet_status.py`` read either package's); ``/debug/traces`` on
  MetricsServer serves the ring live; and ``spans_to_chrome`` emits
  Chrome-trace JSON that ``profiler.merge_traces`` folds into one
  Perfetto timeline next to torch.profiler device traces.
  ``TraceRetention`` keeps whole span trees after they complete (errored,
  slow, sampled, or marked: the gateway marks failed-over requests).

Cost discipline matches the registry: a disabled tracer's
``start_span`` is one attribute load + branch returning the shared
``NULL_SPAN`` — no allocation, no clock read, no contextvar touch.
Span timestamps use ``time.time`` (epoch) by default so spans from
different processes align on one timeline without clock negotiation.
"""
import collections
import contextvars
import json
import os
import random
import threading
import time

from .registry import default_registry

__all__ = ['Span', 'Tracer', 'FlightRecorder', 'TraceRetention',
           'NULL_SPAN', 'TRACE_KEY',
           'default_tracer', 'set_default_tracer', 'current_span',
           'register_metrics', 'spans_to_chrome', 'note_fault',
           'TRACING_FAMILIES']

# message-metadata key carrying {'trace_id', 'span_id'} across processes
# (a str->str dict, representable by the ps/wire typed codec)
TRACE_KEY = '_trace'

# the tracer's own health families — unlabeled counters except the dump
# counter, whose 'reason' label is a closed vocabulary (circuit_open /
# deadline_expired / chaos_fault / manual). Single-source rule: the
# telemetry schema baseline and every tracer register through here.
TRACING_FAMILIES = (
    ('counter', 'trace_spans_started_total', 'spans begun'),
    ('counter', 'trace_spans_finished_total',
     'spans finished and offered to the flight recorder'),
    ('counter', 'trace_spans_dropped_total',
     'finished spans evicted from the flight-recorder ring'),
    ('counter', 'trace_exemplars_total',
     'histogram observations annotated with a trace_id exemplar'),
    ('counter', 'trace_retention_discarded_total',
     'completed span trees the tail sampler decided not to keep'),
    ('counter', 'trace_retention_evicted_total',
     'kept or pending span trees evicted at the retention caps'),
)


def register_metrics(registry):
    """Get-or-create the tracing metric families on `registry`;
    returns {name: family} (plus the reason-labeled dump counter)."""
    out = {}
    for kind, name, doc in TRACING_FAMILIES:
        out[name] = getattr(registry, kind)(name, doc)
    out['trace_flight_dumps_total'] = registry.counter(
        'trace_flight_dumps_total',
        'flight-recorder dumps written, by trigger reason', ('reason',))
    out['trace_retained_total'] = registry.counter(
        'trace_retained_total',
        'complete span trees kept by tail-based retention, by reason',
        ('reason',))
    return out


_current = contextvars.ContextVar('paddle_tpu_torch_trace_span', default=None)


def _new_id(bits):
    return '%0*x' % (bits // 4, random.getrandbits(bits))


class _NullSpan:
    """Shared do-nothing span: the disabled tracer's return value.
    Falsy, so call sites can guard optional work with ``if span:``."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = None

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_tag(self, key, value):
        return self

    def add_event(self, name, **attrs):
        return self

    def set_error(self, exc):
        return self

    def ctx(self):
        return None

    def finish(self):
        pass

    def to_dict(self):
        return {}

    def __repr__(self):
        return 'NULL_SPAN'


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation in a trace tree.

    Mutations (set_tag / add_event / set_error) are expected from the
    span's owning thread; use as a context manager to also publish the
    span to the thread's contextvar so children (and cross-process
    injection) pick it up as parent. ``finish()`` is idempotent."""

    __slots__ = ('name', 'trace_id', 'span_id', 'parent_id', 'start',
                 'end', 'tags', 'events', 'status', 'error', 'tid',
                 '_tracer', '_token')

    def __init__(self, tracer, name, trace_id, parent_id, tags):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id(64)
        self.parent_id = parent_id
        self.start = tracer.clock()
        self.end = None
        self.tags = dict(tags) if tags else {}
        self.events = []          # [(ts, name, attrs)]
        self.status = 'ok'
        self.error = None
        self.tid = threading.get_ident()
        self._token = None

    def __bool__(self):
        return True

    def set_tag(self, key, value):
        self.tags[key] = value
        return self

    def add_event(self, name, **attrs):
        self.events.append((self._tracer.clock(), name, attrs))
        return self

    def set_error(self, exc):
        self.status = 'error'
        self.error = repr(exc)
        return self

    def ctx(self):
        """The wire form: what a client injects under TRACE_KEY."""
        return {'trace_id': self.trace_id, 'span_id': self.span_id}

    def finish(self):
        if self.end is not None:
            return
        self.end = self._tracer.clock()
        self._tracer._on_finish(self)

    def __enter__(self):
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None and self.status == 'ok':
            self.set_error(exc if exc is not None else exc_type)
        self.finish()
        return False

    def to_dict(self):
        return {'name': self.name, 'trace_id': self.trace_id,
                'span_id': self.span_id, 'parent_id': self.parent_id,
                'start': self.start,
                'end': self.end if self.end is not None else self.start,
                'tid': self.tid, 'status': self.status,
                'error': self.error, 'tags': dict(self.tags),
                'events': [{'ts': ts, 'name': n, 'args': dict(a)}
                           for ts, n, a in self.events]}

    def __repr__(self):
        return ('Span(%s, trace=%s, span=%s, parent=%s, status=%s)'
                % (self.name, self.trace_id, self.span_id,
                   self.parent_id, self.status))


class FlightRecorder:
    """Bounded ring of completed spans + throttled crash-dump writer.

    ``record`` keeps the newest `capacity` span dicts (evictions are
    counted, never silent). ``maybe_dump(reason)`` writes the ring to
    ``dump_dir/flight_<reason>_<seq>.json`` at most once per `cooldown`
    seconds per reason — the automatic triggers (circuit-open, deadline
    expiry, chaos faults) can fire in bursts and must not grind the hot
    path into disk I/O. With no dump_dir (the default, unless
    PADDLE_TPU_FLIGHT_DIR is set) maybe_dump is a no-op and the ring is
    inspection-only (``/debug/traces``, ``dump(path=...)``).
    """

    def __init__(self, capacity=4096, dump_dir=None, cooldown=60.0,
                 registry=None, clock=None):
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        self.capacity = int(capacity)
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get('PADDLE_TPU_FLIGHT_DIR'))
        self.cooldown = float(cooldown)
        self._clock = clock or time.time
        self._ring = collections.deque()
        self._lock = threading.Lock()
        self._dropped = 0
        self._seq = 0
        self._last_dump = {}      # reason -> last dump time
        reg = registry if registry is not None else default_registry()
        fams = register_metrics(reg)
        self._m_dropped = fams['trace_spans_dropped_total']
        self._m_dumps = fams['trace_flight_dumps_total']

    def __len__(self):
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self):
        with self._lock:
            return self._dropped

    def record(self, span_dict):
        with self._lock:
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self._dropped += 1
                self._m_dropped.inc()
            self._ring.append(span_dict)

    def spans(self):
        """Oldest-first copy of the ring."""
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    def dump(self, reason='manual', path=None):
        """Write the ring as JSON and return the path. With path=None a
        sequenced file lands under dump_dir (which must be set)."""
        spans = self.spans()
        if path is None:
            if not self.dump_dir:
                raise ValueError('FlightRecorder has no dump_dir; pass '
                                 'an explicit path')
            with self._lock:
                self._seq += 1
                seq = self._seq
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                'flight_%s_%04d.json' % (reason, seq))
        payload = {'reason': reason, 'time': self._clock(),
                   'dropped': self.dropped, 'span_count': len(spans),
                   'spans': spans}
        with open(path, 'w') as fh:
            json.dump(payload, fh)
        self._m_dumps.labels(reason).inc()
        return path

    def maybe_dump(self, reason):
        """Throttled automatic dump: None when no dump_dir is configured
        or the reason is still inside its cooldown window."""
        if not self.dump_dir:
            return None
        now = self._clock()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.cooldown:
                return None
            self._last_dump[reason] = now
        return self.dump(reason)

    def to_chrome(self, process_name=None):
        return spans_to_chrome(self.spans(), process_name=process_name)

    def export_chrome(self, path, process_name=None):
        """Write the ring in Chrome-trace format; drop the file in a
        directory handed to profiler.merge_traces and host spans join
        the per-rank device traces on one Perfetto timeline."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, 'w') as fh:
            json.dump(self.to_chrome(process_name=process_name), fh)
        return path


def spans_to_chrome(spans, pid=None, process_name=None):
    """Span dicts -> Chrome-trace JSON dict ({'traceEvents': [...]}).

    Spans become 'X' complete events (ts/dur in microseconds — epoch-
    based, so traces from different processes align without offset
    bookkeeping), span events become 'i' instants, and a process_name
    metadata record labels the lane (merge_traces prefixes it with
    'rank N:')."""
    pid = os.getpid() if pid is None else int(pid)
    events = [{'ph': 'M', 'name': 'process_name', 'pid': pid, 'tid': 0,
               'args': {'name': process_name
                        or 'paddle_tpu host %d' % pid}}]
    for s in spans:
        tid = s.get('tid') or 0
        start = float(s.get('start') or 0.0)
        end = float(s.get('end') or start)
        args = dict(s.get('tags') or {})
        args['trace_id'] = s.get('trace_id')
        args['span_id'] = s.get('span_id')
        if s.get('parent_id'):
            args['parent_id'] = s['parent_id']
        if s.get('status') not in (None, 'ok'):
            args['status'] = s['status']
            if s.get('error'):
                args['error'] = s['error']
        events.append({'ph': 'X', 'cat': 'span',
                       'name': s.get('name') or '?', 'pid': pid,
                       'tid': tid, 'ts': start * 1e6,
                       'dur': max(end - start, 0.0) * 1e6, 'args': args})
        for ev in s.get('events') or ():
            events.append({'ph': 'i', 's': 't', 'cat': 'span',
                           'name': ev.get('name') or 'event', 'pid': pid,
                           'tid': tid,
                           'ts': float(ev.get('ts') or start) * 1e6,
                           'args': dict(ev.get('args') or {})})
    return {'traceEvents': events, 'displayTimeUnit': 'ms'}


class TraceRetention:
    """Tail-based trace retention: decide AFTER a trace completes.

    Head sampling (keep 1%) throws away exactly the traces worth
    reading; tail sampling buffers each trace's finished spans until its
    ROOT span (parent_id None) completes, then keeps the whole tree when
    the request was interesting — errored (any span with status
    'error'), slow (root duration over `slow_threshold_s`, typically the
    serving SLO), or force-marked by an outside observer (the gateway
    marks failed-over requests via ``mark``) — plus a probabilistic
    `keep_probability` sample of healthy traffic as a baseline. Wide
    events (monitor/events.py) carry the trace_id, so ``get(trace_id)``
    closes the event → full-span-tree join.

    Everything is bounded: at most `capacity` kept trees (FIFO
    eviction), at most `pending_capacity` incomplete trees, and a
    bounded memory of recent decisions/marks; evictions and discards
    are counted, never silent. Attach to a tracer via
    ``Tracer(retention=...)`` or ``tracer.retention = ...``; a detached
    store costs the hot path nothing (one load + branch in
    ``_on_finish``, which only runs when tracing is enabled anyway)."""

    def __init__(self, capacity=256, slow_threshold_s=None,
                 keep_probability=0.0, pending_capacity=1024,
                 registry=None, rng=None):
        if capacity < 1 or pending_capacity < 1:
            raise ValueError('capacities must be >= 1')
        self.capacity = int(capacity)
        self.slow_threshold_s = slow_threshold_s
        self.keep_probability = float(keep_probability)
        self.pending_capacity = int(pending_capacity)
        self._rng = rng or random.random
        self._lock = threading.Lock()
        self._pending = collections.OrderedDict()   # trace_id -> [span]
        self._kept = collections.OrderedDict()      # trace_id -> entry
        self._marked = collections.OrderedDict()    # trace_id -> reason
        self._decided = collections.OrderedDict()   # trace_id -> True
        reg = registry if registry is not None else default_registry()
        fams = register_metrics(reg)
        self._m_retained = fams['trace_retained_total']
        self._m_discarded = fams['trace_retention_discarded_total']
        self._m_evicted = fams['trace_retention_evicted_total']

    def mark(self, trace_id, reason='forced'):
        """Force-keep `trace_id` when its tree completes (or
        immediately, if it already has). The gateway calls this with
        reason 'failover' for every re-placed request."""
        if not trace_id:
            return
        with self._lock:
            entry = self._kept.get(trace_id)
            if entry is not None:
                if reason not in entry['reasons']:
                    entry['reasons'].append(reason)
                return
            self._marked[trace_id] = reason
            while len(self._marked) > self.pending_capacity:
                self._marked.popitem(last=False)

    def offer(self, span_dict):
        """Feed one finished span (called by Tracer._on_finish)."""
        tid = span_dict.get('trace_id')
        if not tid:
            return
        with self._lock:
            entry = self._kept.get(tid)
            if entry is not None:
                # straggler span of an already-kept tree
                entry['spans'].append(span_dict)
                return
            if tid in self._decided:
                return
            spans = self._pending.get(tid)
            if spans is None:
                while len(self._pending) >= self.pending_capacity:
                    self._pending.popitem(last=False)
                    self._m_evicted.inc()
                spans = self._pending[tid] = []
            spans.append(span_dict)
            if span_dict.get('parent_id') is None:
                self._decide_locked(tid, span_dict)

    def _decide_locked(self, tid, root):
        spans = self._pending.pop(tid, [])
        reasons = []
        forced = self._marked.pop(tid, None)
        if forced is not None:
            reasons.append(forced)
        if any(s.get('status') == 'error' for s in spans):
            reasons.append('error')
        duration = float(root.get('end') or 0.0) \
            - float(root.get('start') or 0.0)
        if self.slow_threshold_s is not None \
                and duration > self.slow_threshold_s:
            reasons.append('slow')
        if not reasons and self.keep_probability > 0.0 \
                and self._rng() < self.keep_probability:
            reasons.append('sampled')
        self._decided[tid] = True
        while len(self._decided) > 4 * self.pending_capacity:
            self._decided.popitem(last=False)
        if not reasons:
            self._m_discarded.inc()
            return
        while len(self._kept) >= self.capacity:
            self._kept.popitem(last=False)
            self._m_evicted.inc()
        self._kept[tid] = {'trace_id': tid, 'reasons': reasons,
                           'root': root.get('name'),
                           'duration_s': duration,
                           'end': root.get('end'), 'spans': spans}
        self._m_retained.labels(reasons[0]).inc()

    def get(self, trace_id):
        """The full retained span tree for `trace_id` (list of span
        dicts, finish order), or None if it was not kept."""
        with self._lock:
            entry = self._kept.get(trace_id)
            return list(entry['spans']) if entry is not None else None

    def traces(self, reason=None):
        """Summaries of the kept trees, oldest first: trace_id, reasons,
        root span name, duration."""
        with self._lock:
            entries = list(self._kept.values())
        out = []
        for e in entries:
            if reason is not None and reason not in e['reasons']:
                continue
            out.append({'trace_id': e['trace_id'],
                        'reasons': list(e['reasons']),
                        'root': e['root'],
                        'duration_s': e['duration_s'],
                        'end': e['end'],
                        'span_count': len(e['spans'])})
        return out

    def __len__(self):
        with self._lock:
            return len(self._kept)

    def clear(self):
        with self._lock:
            self._pending.clear()
            self._kept.clear()
            self._marked.clear()
            self._decided.clear()


class Tracer:
    """Span factory + the enabled/disabled switch.

    ``enabled`` is a plain attribute so hot paths pay one load + branch
    when tracing is off (the registry's ~90 ns discipline); disabled
    ``start_span`` returns the shared NULL_SPAN. The injectable clock
    stamps span start/end/events — keep it epoch-based (time.time) in
    production so cross-process spans share a timeline."""

    def __init__(self, enabled=True, clock=None, recorder=None,
                 registry=None, retention=None):
        self.enabled = bool(enabled)
        self.clock = clock or time.time
        self.registry = registry if registry is not None \
            else default_registry()
        fams = register_metrics(self.registry)
        self._m_started = fams['trace_spans_started_total']
        self._m_finished = fams['trace_spans_finished_total']
        self.recorder = recorder if recorder is not None else \
            FlightRecorder(registry=self.registry, clock=self.clock)
        # tail-based retention is opt-in: None costs one load + branch
        # per finished span (attach with tracer.retention = TraceRetention())
        self.retention = retention

    def enable(self):
        self.enabled = True

    def disable(self):
        """Freeze tracing: start_span becomes a branch returning
        NULL_SPAN; in-flight real spans still finish and record."""
        self.enabled = False

    def current(self):
        """The calling thread/context's innermost entered span."""
        return _current.get()

    def start_span(self, name, parent=None, ctx=None, tags=None,
                   root=False):
        """Begin a span. Parent resolution: explicit `ctx` (a wire dict
        from a remote client) > explicit `parent` span > the contextvar
        current span > a fresh root. `root=True` skips the contextvar
        lookup and always opens a NEW trace — request-identity spans
        (the engines' serving.request) use it so a request re-submitted
        inside a gateway routing/failover span still owns its own trace
        (tail retention decides per request, and the wide event's
        trace_id resolves to exactly that request's tree). The returned
        span is NOT current until entered (``with``) — lifecycle spans
        held across calls (a serving request) just ``finish()``
        manually."""
        if not self.enabled:
            return NULL_SPAN
        if root:
            trace_id, parent_id = _new_id(128), None
        elif ctx is not None:
            trace_id = str(ctx.get('trace_id') or _new_id(128))
            parent_id = ctx.get('span_id')
        elif parent:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            cur = _current.get()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_id(128), None
        self._m_started.inc()
        return Span(self, name, trace_id, parent_id, tags)

    def server_span(self, msg, prefix):
        """Server-side continuation: pop TRACE_KEY from an incoming
        message dict and open a span parented on the remote caller.
        ALWAYS pops (even disabled / untraced) so op handlers never see
        transport metadata; returns NULL_SPAN when there is nothing to
        continue."""
        ctx = msg.pop(TRACE_KEY, None) if isinstance(msg, dict) else None
        if not self.enabled or not isinstance(ctx, dict):
            return NULL_SPAN
        name = prefix
        if isinstance(msg, dict) and 'op' in msg:
            name = '%s.%s' % (prefix, msg['op'])
        return self.start_span(name, ctx=ctx)

    def _on_finish(self, span):
        self._m_finished.inc()
        d = span.to_dict()
        self.recorder.record(d)
        ret = self.retention
        if ret is not None:
            ret.offer(d)


def _env_enabled():
    v = os.environ.get('PADDLE_TPU_TRACING', '1').strip().lower()
    return v not in ('0', 'false', 'off', 'no', '')


_default = Tracer(enabled=_env_enabled())
_default_lock = threading.Lock()


def default_tracer():
    """The process-wide tracer every built-in instrumentation site uses
    unless handed an explicit one."""
    return _default


def set_default_tracer(tracer):
    """Swap the process default (tests); returns the previous one.
    Objects that cached the old tracer at construction keep it — swap
    BEFORE constructing the engines/channels under test."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
        return prev


def current_span():
    """Module-level convenience for the calling context's span."""
    return _current.get()


def note_fault(point, endpoint):
    """Chaos hook (testing/chaos.py): annotate the current span with the
    injected fault and request a throttled flight dump. No-op when
    tracing is disabled."""
    tr = _default
    if not tr.enabled:
        return
    sp = _current.get()
    if sp is not None:
        sp.add_event('chaos.fault', point=point, endpoint=endpoint)
    tr.recorder.maybe_dump('chaos_fault')
