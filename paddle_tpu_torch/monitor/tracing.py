"""Request tracing of the port's serving engines (counterpart of
paddle_tpu/monitor/tracing.py, cut to what the engines and the step
timeline call).

The metrics registry (registry.py) says HOW MUCH; this module says WHERE
TIME WENT for one request. The slot and paged engines emit
queued→admit→prefill→decode→retire spans with prefix-cache-hit and
spec-accept events; TTFT / inter-token histogram observations and the
wide request event (events.py) carry the request span's trace_id, and
every finished span lands in the tracer's bounded ring (``spans()``).

The reference's cross-process propagation, flight-recorder dumps,
Chrome-trace export and tail-based retention serve the RPC layer and the
gateway, which the port does not have yet.

A disabled tracer's ``start_span`` is one attribute load + branch
returning the shared ``NULL_SPAN``: no allocation, no clock read, no
contextvar touch.
"""
import collections
import contextvars
import random
import threading
import time

from .registry import default_registry

__all__ = ['Span', 'Tracer', 'NULL_SPAN', 'default_tracer',
           'set_default_tracer', 'register_metrics', 'TRACING_FAMILIES']

# the tracer's own health families (unlabeled counters)
TRACING_FAMILIES = (
    ('counter', 'trace_spans_started_total', 'spans begun'),
    ('counter', 'trace_spans_finished_total',
     'spans finished and kept in the tracer ring'),
    ('counter', 'trace_spans_dropped_total',
     'finished spans evicted from the tracer ring'),
    ('counter', 'trace_exemplars_total',
     'histogram observations annotated with a trace_id exemplar'),
)


def register_metrics(registry):
    """Get-or-create the tracing metric families on `registry`;
    returns {name: family}."""
    return {name: getattr(registry, kind)(name, doc)
            for kind, name, doc in TRACING_FAMILIES}


_current = contextvars.ContextVar('paddle_tpu_torch_trace_span',
                                  default=None)


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
    span to the thread's contextvar so children pick it up as parent.
    ``finish()`` is idempotent."""

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


class Tracer:
    """Span factory, the enabled/disabled switch, and a bounded ring of
    the newest `capacity` finished spans (evictions are counted).

    ``enabled`` is a plain attribute so hot paths pay one load + branch
    when tracing is off; disabled ``start_span`` returns the shared
    NULL_SPAN. The injectable clock stamps span start/end/events."""

    def __init__(self, enabled=True, clock=None, registry=None,
                 capacity=4096):
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        self.enabled = bool(enabled)
        self.clock = clock or time.time
        self.registry = registry if registry is not None \
            else default_registry()
        fams = register_metrics(self.registry)
        self._m_started = fams['trace_spans_started_total']
        self._m_finished = fams['trace_spans_finished_total']
        self._m_dropped = fams['trace_spans_dropped_total']
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def enable(self):
        self.enabled = True

    def disable(self):
        """Freeze tracing: start_span becomes a branch returning
        NULL_SPAN; in-flight real spans still finish and record."""
        self.enabled = False

    def current(self):
        """The calling thread/context's innermost entered span."""
        return _current.get()

    def start_span(self, name, parent=None, tags=None, root=False):
        """Begin a span. Parent resolution: explicit `parent` span > the
        contextvar current span > a fresh root. `root=True` always opens
        a NEW trace (the engines' per-request serving.request span). The
        returned span is NOT current until entered (``with``) —
        lifecycle spans held across calls (a serving request) just
        ``finish()`` manually."""
        if not self.enabled:
            return NULL_SPAN
        if root:
            trace_id, parent_id = _new_id(128), None
        elif parent:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            cur = _current.get()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_id(128), None
        self._m_started.inc()
        return Span(self, name, trace_id, parent_id, tags)

    def spans(self):
        """Oldest-first copy of the finished-span ring (span dicts)."""
        with self._lock:
            return list(self._ring)

    def _on_finish(self, span):
        self._m_finished.inc()
        d = span.to_dict()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._m_dropped.inc()
            self._ring.append(d)


_default = Tracer()
_default_lock = threading.Lock()


def default_tracer():
    """The process-wide tracer the engines and the step timeline use
    unless handed an explicit one."""
    return _default


def set_default_tracer(tracer):
    """Swap the process default (tests); returns the previous one.
    Objects that cached the old tracer at construction keep it — swap
    BEFORE constructing the engines under test."""
    global _default
    with _default_lock:
        prev, _default = _default, tracer
        return prev
