"""Declarative SLO alerting over (federated) metric snapshots
(counterpart of paddle_tpu/monitor/alerts.py, copied: it needs nothing
but the standard library).

The collector (monitor/federation.py) answers "what is the fleet
doing"; this module answers "is that OK" — without a human watching a
dashboard. Rules are pure declarations evaluated against a snapshot
under an **injectable clock**, so every lifecycle edge is unit-testable
at analytically exact ticks (the autoscaler discipline):

- ``ThresholdRule`` — scalar comparison (counter/gauge sample vs a
  threshold) that must hold for ``for_duration`` seconds before firing;
- ``BurnRateRule`` — multi-window SLO burn over a latency histogram
  (the Google-SRE pattern): from cumulative bucket counts it derives
  the fraction of observations over the SLO bound per trailing window,
  divides by the error budget (1 - objective), and fires when BOTH the
  long and the short window of any (long_s, short_s, factor) pair
  exceed `factor` — the long window proves the burn is real, the short
  window proves it is still happening, so recovered incidents resolve
  fast and blips never page.

Lifecycle per rule: inactive → pending (condition true, waiting out
``for_duration``) → firing → resolved (condition false for
``resolve_after`` — the hysteresis that stops a sawtoothing signal
from flapping). Every firing edge writes EXACTLY ONE flight-recorder
dump (reason ``alert_firing``) so the spans around the regression are
preserved the moment it is detected, and state is exported three ways:
``alerts_firing{rule}`` / ``alerts_pending{rule}`` gauges, an
``alerts_transitions_total{rule,to}`` counter, and the ``/alerts``
endpoint (monitor/server.py).

Stdlib-only, zero cost off the evaluate() path: nothing here hooks the
RPC or decode loops.
"""
import bisect
import collections
import math
import threading
import time

from .registry import default_registry

__all__ = ['AlertRule', 'ThresholdRule', 'BurnRateRule', 'AlertManager',
           'HistogramWindow', 'find_sample', 'federated_burn_source',
           'INACTIVE', 'PENDING', 'FIRING']

INACTIVE = 'inactive'
PENDING = 'pending'
FIRING = 'firing'

_OPS = {
    '>': lambda a, b: a > b,
    '>=': lambda a, b: a >= b,
    '<': lambda a, b: a < b,
    '<=': lambda a, b: a <= b,
    '==': lambda a, b: a == b,
}


def find_sample(snapshot, metric, labels=None):
    """The first sample of `metric` whose labels are a superset of
    `labels` (None/{} matches the first sample); None when absent."""
    fam = snapshot.get(metric)
    if not fam:
        return None
    want = dict(labels or {})
    for s in fam.get('samples', ()):
        have = s.get('labels') or {}
        if all(have.get(k) == str(v) for k, v in want.items()):
            return s
    return None


class AlertRule:
    """Base rule: a name plus lifecycle timings. Subclasses implement
    ``condition(snapshot, now) -> (active, value)``; value is whatever
    scalar best explains the decision (shown in /alerts)."""

    def __init__(self, name, for_duration=0.0, resolve_after=0.0):
        if not name:
            raise ValueError('rules need a name')
        self.name = str(name)
        self.for_duration = float(for_duration)
        self.resolve_after = float(resolve_after)

    def condition(self, snapshot, now):
        raise NotImplementedError

    def describe(self):
        return {'name': self.name, 'kind': type(self).__name__,
                'for_duration': self.for_duration,
                'resolve_after': self.resolve_after}


class ThresholdRule(AlertRule):
    """`metric <op> threshold`, sustained for `for_duration` seconds.

    The metric sample is a counter/gauge value (or a histogram's count
    when `field='count'`). A missing metric or sample is NOT active —
    absence alerts belong to `fleet_target_up` threshold rules, which
    this composes with: ThresholdRule('ps-down', 'fleet_target_up',
    0.5, op='<', labels={'instance': 'ps:0'}).
    """

    def __init__(self, name, metric, threshold, op='>', labels=None,
                 field='value', **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError('op must be one of %s' % sorted(_OPS))
        self.metric = str(metric)
        self.threshold = float(threshold)
        self.op = op
        self.labels = dict(labels or {})
        self.field = field

    def condition(self, snapshot, now):
        s = find_sample(snapshot, self.metric, self.labels)
        if s is None:
            return False, None
        value = s.get(self.field)
        if value is None:
            return False, None
        value = float(value)
        return _OPS[self.op](value, self.threshold), value

    def describe(self):
        d = super().describe()
        d.update(metric=self.metric, op=self.op,
                 threshold=self.threshold, labels=self.labels)
        return d


class HistogramWindow:
    """Windowed rates from a cumulative histogram sample.

    Histograms are cumulative-since-birth; SLO burn needs trailing
    windows. This ring keeps (t, count, over_count) at each update and
    answers `fraction(window_s, now)` = share of observations over the
    SLO bound within the window, by differencing against the newest
    sample at or before the window start (partial windows fall back to
    the oldest retained sample — conservative, never fabricated).

    `slo_le` must be one of the histogram's fixed bucket bounds: the
    over-count is then exact (count - cumulative count at le=slo_le),
    not interpolated. A mismatched bound raises at update time — an
    alert that silently measured the wrong SLO is the worst outcome.
    """

    def __init__(self, slo_le, horizon_s=3600.0):
        self.slo_le = float(slo_le)
        self.horizon_s = float(horizon_s)
        self._ring = collections.deque()      # (t, count, over)

    def update(self, sample, now):
        """Fold one histogram sample (to_dict shape with buckets)."""
        count = int(sample.get('count') or 0)
        buckets = sample.get('buckets')
        if buckets is None:
            raise ValueError('histogram sample carries no buckets '
                             '(snapshot taken with buckets=False?)')
        good = 0
        matched = False
        for b, n in buckets.items():
            bound = math.inf if b == '+Inf' else float(b)
            if bound <= self.slo_le:
                good += int(n)
                if bound == self.slo_le:
                    matched = True
        if not matched:
            raise ValueError('slo_le=%g is not a bucket bound of the '
                             'histogram (bounds must be fixed and '
                             'shared)' % self.slo_le)
        over = count - good
        self._ring.append((float(now), count, over))
        while self._ring and now - self._ring[0][0] > self.horizon_s:
            self._ring.popleft()

    def _at(self, t):
        """Newest ring entry with timestamp <= t (oldest as fallback)."""
        times = [e[0] for e in self._ring]
        i = bisect.bisect_right(times, t) - 1
        return self._ring[max(i, 0)]

    def fraction(self, window_s, now):
        """Over-SLO fraction of observations inside the window; 0.0 on
        no evidence (empty ring or no new observations)."""
        if not self._ring:
            return 0.0
        t0, c0, o0 = self._at(now - window_s)
        _, c1, o1 = self._ring[-1]
        dc = c1 - c0
        if dc <= 0:
            return 0.0
        return (o1 - o0) / float(dc)


class BurnRateRule(AlertRule):
    """Multi-window error-budget burn over a latency histogram.

    objective: the SLO (e.g. 0.95 = 95% of requests under slo_le
    seconds); budget = 1 - objective. windows: ((long_s, short_s,
    factor), ...) — active when, for ANY pair, burn(long) >= factor AND
    burn(short) >= factor, where burn(w) = over-fraction(w) / budget.
    Defaults follow the SRE workbook two-pair setup scaled to minutes
    (the injectable clock makes the absolute scale a test choice).
    """

    def __init__(self, name, metric, slo_le, objective=0.95,
                 windows=((300.0, 60.0, 14.4), (3600.0, 300.0, 6.0)),
                 labels=None, horizon_s=None, **kw):
        super().__init__(name, **kw)
        if not 0.0 < objective < 1.0:
            raise ValueError('objective must be in (0, 1)')
        self.metric = str(metric)
        self.slo_le = float(slo_le)
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows = tuple((float(l), float(s), float(f))
                             for l, s, f in windows)
        if not self.windows:
            raise ValueError('need at least one (long, short, factor)')
        self.labels = dict(labels or {})
        horizon = horizon_s if horizon_s is not None \
            else 2.0 * max(l for l, _, _ in self.windows)
        self._window = HistogramWindow(self.slo_le, horizon_s=horizon)

    def condition(self, snapshot, now):
        s = find_sample(snapshot, self.metric, self.labels)
        if s is not None:
            self._window.update(s, now)
        burns = [(self._window.fraction(l, now) / self.budget,
                  self._window.fraction(sh, now) / self.budget, f)
                 for l, sh, f in self.windows]
        active = any(bl >= f and bs >= f for bl, bs, f in burns)
        worst = max((min(bl, bs) for bl, bs, _ in burns), default=0.0)
        return active, worst

    def describe(self):
        d = super().describe()
        d.update(metric=self.metric, slo_le=self.slo_le,
                 objective=self.objective,
                 windows=[list(w) for w in self.windows],
                 labels=self.labels)
        return d


class _RuleState:
    __slots__ = ('state', 'pending_since', 'firing_since', 'clear_since',
                 'fired_count', 'resolved_count', 'last_value',
                 'last_transition_t')

    def __init__(self):
        self.state = INACTIVE
        self.pending_since = None
        self.firing_since = None
        self.clear_since = None
        self.fired_count = 0
        self.resolved_count = 0
        self.last_value = None
        self.last_transition_t = None


class AlertManager:
    """Evaluates rules against a snapshot source on demand.

        mgr = AlertManager([rule, ...], source=collector.merged)
        mgr.evaluate()        # call on the scrape cadence / fake clock
        mgr.state()           # /alerts body
        mgr.firing()          # rule names currently firing

    `source` is any zero-arg callable returning a to_dict-shaped
    snapshot — a FleetCollector's merged(), a bare registry via
    ``lambda: export.to_dict(reg)``, or a parsed fleet_snapshot line.
    The flight `recorder` (default: the tracer's) receives exactly one
    dump per pending→firing edge, bypassing the cooldown throttle — the
    rule's own for_duration/resolve_after hysteresis IS the throttle.
    """

    def __init__(self, rules, source, registry=None, recorder=None,
                 clock=None):
        from .telemetry import record_alert_schema
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError('duplicate rule names: %r' % (names,))
        self.rules = list(rules)
        self._source = source
        self.clock = clock or time.time
        self.registry = registry if registry is not None \
            else default_registry()
        if recorder is None:
            from .tracing import default_tracer
            recorder = default_tracer().recorder
        self.recorder = recorder
        fams = record_alert_schema(self.registry)
        self._m_firing = fams['alerts_firing']
        self._m_pending = fams['alerts_pending']
        self._m_transitions = fams['alerts_transitions_total']
        self._m_evals = fams['alerts_evaluations_total']
        self._lock = threading.Lock()
        self._states = {r.name: _RuleState() for r in self.rules}
        for r in self.rules:          # zero-init so /metrics shows all
            self._m_firing.labels(r.name).set(0)
            self._m_pending.labels(r.name).set(0)

    # ---- lifecycle -----------------------------------------------------

    def _transition(self, rule, st, to, now):
        st.state = to if to in (PENDING, FIRING) else INACTIVE
        st.last_transition_t = now
        self._m_transitions.labels(rule.name, to).inc()
        self._m_pending.labels(rule.name).set(
            1 if st.state == PENDING else 0)
        self._m_firing.labels(rule.name).set(
            1 if st.state == FIRING else 0)

    def _on_firing_edge(self, rule):
        """Exactly one flight dump per edge (when a dump dir exists)."""
        rec = self.recorder
        if rec is None or not getattr(rec, 'dump_dir', None):
            return None
        try:
            return rec.dump('alert_firing')
        except OSError:
            return None

    def evaluate(self, now=None):
        """One pass over every rule; returns [(rule_name, transition)]
        for the edges taken this pass ('pending', 'firing', 'resolved',
        'inactive')."""
        now = self.clock() if now is None else now
        snapshot = self._source()
        edges = []
        with self._lock:
            self._m_evals.inc()
            for rule in self.rules:
                st = self._states[rule.name]
                active, value = rule.condition(snapshot, now)
                st.last_value = value
                if st.state == INACTIVE:
                    if active:
                        st.pending_since = now
                        if rule.for_duration <= 0.0:
                            st.firing_since = now
                            st.fired_count += 1
                            self._transition(rule, st, FIRING, now)
                            self._on_firing_edge(rule)
                            edges.append((rule.name, FIRING))
                        else:
                            self._transition(rule, st, PENDING, now)
                            edges.append((rule.name, PENDING))
                elif st.state == PENDING:
                    if not active:
                        st.pending_since = None
                        self._transition(rule, st, INACTIVE, now)
                        edges.append((rule.name, INACTIVE))
                    elif now - st.pending_since >= rule.for_duration:
                        st.firing_since = now
                        st.fired_count += 1
                        self._transition(rule, st, FIRING, now)
                        self._on_firing_edge(rule)
                        edges.append((rule.name, FIRING))
                elif st.state == FIRING:
                    if active:
                        st.clear_since = None       # hysteresis reset
                    else:
                        if st.clear_since is None:
                            st.clear_since = now
                        if now - st.clear_since >= rule.resolve_after:
                            st.clear_since = None
                            st.firing_since = None
                            st.pending_since = None
                            st.resolved_count += 1
                            self._transition(rule, st, 'resolved', now)
                            edges.append((rule.name, 'resolved'))
        return edges

    # ---- export --------------------------------------------------------

    def state(self):
        """The /alerts body: one entry per rule, JSON-able."""
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._states[rule.name]
                out.append({
                    'rule': rule.describe(),
                    'state': st.state,
                    'value': st.last_value,
                    'pending_since': st.pending_since,
                    'firing_since': st.firing_since,
                    'fired_count': st.fired_count,
                    'resolved_count': st.resolved_count,
                    'last_transition_t': st.last_transition_t,
                })
            return out

    def firing(self):
        with self._lock:
            return sorted(name for name, st in self._states.items()
                          if st.state == FIRING)


def federated_burn_source(collector, slo_ttft_s,
                          metric='gateway_ttft_seconds', window_s=30.0,
                          labels=None):
    """A burn-rate reader over the FEDERATED view, shaped for
    ServingGateway.autoscale_tick's burn override: `fn(now) -> fraction
    of windowed observations over the SLO`. Lets one autoscaler act on
    TTFT aggregated across every gateway process in the fleet instead
    of only its own in-process samples. `slo_ttft_s` must be a bucket
    bound of the TTFT histogram (it is: the gateway buckets are fixed
    exponential)."""
    window = HistogramWindow(slo_ttft_s, horizon_s=4.0 * window_s)

    def burn(now):
        s = find_sample(collector.merged(), metric, labels)
        if s is not None:
            window.update(s, now)
        return window.fraction(window_s, now)
    return burn
