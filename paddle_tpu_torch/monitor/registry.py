"""(Counterpart of paddle_tpu/monitor/registry.py, copied: it needs
nothing but the standard library.)

Thread-safe metric registry (reference: paddle/fluid/platform/monitor.h
StatRegistry + STAT_ADD, grown into the three Prometheus metric kinds).

Design constraints, in order:

1. **Near-zero cost when disabled.** Every hot-path instrumentation site
   (the serving decode loop) goes through a bound child whose update is
   ONE attribute load + branch when the owning registry is disabled — no
   lock, no dict lookup, no allocation.
2. **Exact under concurrency.** Python's ``+=`` on an int is a
   read-modify-write across bytecodes; a per-child lock keeps totals
   exact so tests can use counters as a correctness oracle.
3. **Get-or-create families.** Two engines (or a re-imported module)
   asking for the same (name, type, labelnames) share one family; a
   conflicting redeclaration raises instead of silently forking series.

Label values are positional-or-keyword; children are interned per value
tuple so call sites can cache them once (``self._m = fam.labels(ep)``)
and pay only the child update per event.
"""
import bisect
import threading
import time

__all__ = ['MetricRegistry', 'Counter', 'Gauge', 'Histogram',
           'exponential_buckets', 'default_registry', 'set_default_registry']

# Prometheus-conventional default histogram buckets (seconds)
DEFAULT_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0)


def exponential_buckets(start, factor, count):
    """`count` bucket upper bounds: start, start*factor, ... (the
    reference monitor.h stats are plain sums; exponential bounds are what
    latency distributions need)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError('need start > 0, factor > 1, count >= 1')
    out = []
    b = float(start)
    for _ in range(int(count)):
        out.append(b)
        b *= factor
    return tuple(out)


def _check_name(name):
    if not name or not all(c.isalnum() or c in '_:' for c in name):
        raise ValueError('invalid metric name %r' % (name,))


class _Child:
    """One labeled series. Updates check the registry's enabled flag
    FIRST (the disabled fast path), then mutate under the family lock."""

    __slots__ = ('_reg', '_lock', '_value')

    def __init__(self, reg, lock):
        self._reg = reg
        self._lock = lock
        self._value = 0.0

    def value(self):
        with self._lock:
            return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount=1.0):
        if not self._reg._enabled:
            return
        if amount < 0:
            raise ValueError('counters only go up')
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value):
        if not self._reg._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        if not self._reg._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ('_reg', '_lock', '_bounds', '_counts', '_sum', '_count',
                 '_exemplars')

    def __init__(self, reg, lock, bounds):
        self._reg = reg
        self._lock = lock
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # trailing +Inf bucket
        self._sum = 0.0
        self._count = 0
        # bucket index -> (exemplar id, value, t): the LAST annotated
        # observation per bucket, so an outlier bucket links back to a
        # concrete trace (monitor/tracing.py exemplars)
        self._exemplars = {}

    def observe(self, value, exemplar=None):
        if not self._reg._enabled:
            return
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), float(value),
                                      self._reg.clock())

    def value(self):
        """(count, sum) — the scalar view used by tests/snapshots."""
        with self._lock:
            return self._count, self._sum

    def snapshot(self):
        with self._lock:
            return {'count': self._count, 'sum': self._sum,
                    'buckets': list(self._counts),
                    'exemplars': dict(self._exemplars)}

    def cumulative(self):
        """Mergeable fixed-boundary view: Prometheus `le` semantics,
        one cumulative count per upper bound with +Inf last, so
        cumulative[-1] == count always. Two children with the same
        bounds merge by element-wise sum (monitor/federation.py); the
        `_bucket` exposition lines print exactly these numbers."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for n in counts:
            acc += n
            cum.append(acc)
        return {'bounds': list(self._bounds) + [float('inf')],
                'cumulative': cum, 'count': total, 'sum': s}


class _Family:
    """One metric family: a name, a type, label names, and children."""

    kind = None

    def __init__(self, reg, name, help, labelnames):
        _check_name(name)
        self.name = name
        self.help = help or ''
        self.labelnames = tuple(labelnames or ())
        self._reg = reg
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kwvalues):
        if kwvalues:
            if values:
                raise ValueError('pass labels positionally OR by name')
            try:
                values = tuple(kwvalues[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError('missing label %s' % e)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError('%s expects labels %r, got %r'
                             % (self.name, self.labelnames, values))
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    # unlabeled convenience: fam.inc() == fam.labels().inc()
    def __getattr__(self, attr):
        if attr in ('inc', 'dec', 'set', 'observe', 'value',
                    'cumulative') and not self.labelnames:
            return getattr(self._children[()], attr)
        raise AttributeError(attr)

    def samples(self):
        """[(label_values_tuple, child)] — a consistent point-in-time
        listing for exporters."""
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    kind = 'counter'

    def _make_child(self):
        return _CounterChild(self._reg, self._lock)


class Gauge(_Family):
    kind = 'gauge'

    def _make_child(self):
        return _GaugeChild(self._reg, self._lock)


class Histogram(_Family):
    kind = 'histogram'

    def __init__(self, reg, name, help, labelnames, buckets=None):
        bounds = tuple(sorted(float(b) for b in (buckets or
                                                 DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError('need at least one bucket bound')
        self.buckets = bounds
        super().__init__(reg, name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._reg, self._lock, self.buckets)


class MetricRegistry:
    """Get-or-create home for metric families, with a global on/off
    switch (monitor.h's StatRegistry::Instance() analog is
    ``default_registry()``)."""

    def __init__(self, enabled=True, clock=None):
        self._enabled = bool(enabled)
        self.clock = clock or time.monotonic
        self._families = {}
        self._lock = threading.Lock()

    # -- enable/disable ------------------------------------------------------
    @property
    def enabled(self):
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        """Freeze all instrumentation fed by this registry: every child
        update becomes a flag check and nothing else."""
        self._enabled = False

    # -- family constructors -------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames or ())
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != cls.kind or fam.labelnames != labelnames:
                    raise ValueError(
                        'metric %r already registered as %s%r, requested '
                        '%s%r' % (name, fam.kind, fam.labelnames,
                                  cls.kind, labelnames))
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help='', labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help='', labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help='', labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -- introspection -------------------------------------------------------
    def collect(self):
        """Families sorted by name (stable exporter order)."""
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def unregister(self, name):
        with self._lock:
            self._families.pop(name, None)


_default = MetricRegistry(enabled=True)
_default_lock = threading.Lock()


def default_registry():
    """The process-wide registry every built-in instrumentation site
    feeds unless handed an explicit one."""
    return _default


def set_default_registry(reg):
    """Swap the process default (tests); returns the previous one.

    Already-bound children keep feeding the registry they were created
    from — swap BEFORE constructing the objects under test.
    """
    global _default
    with _default_lock:
        prev, _default = _default, reg
        return prev
