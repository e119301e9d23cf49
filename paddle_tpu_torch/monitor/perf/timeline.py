"""(Counterpart of paddle_tpu/monitor/perf/timeline.py, copied: it needs
nothing but the standard library.)

StepTimeline: split train/serve steps into host-visible phases.

A step's wall time decomposes into what the host can measure without a
profiler:

  data_wait      — blocked on the input pipeline (loader ``next()``);
  host_dispatch  — Python + async enqueue of the step's kernels
                   (returns before the device runs);
  device_block   — blocked on device results (``.cpu()`` — the
                   dispatch-to-ready gap, which IS the device time once
                   dispatch is async);
  other          — the remainder when an explicit wall time is given.

Each phase lands in the ``perf_step_phase_seconds`` histogram (labeled,
with trace-exemplar links into the active tracer span) and a rolling
window that serves percentiles and straggler detection: a step slower
than ``straggler_factor`` x the rolling median bumps
``perf_stragglers_total`` and drops a ``perf.straggler`` span into the
tracer's ring.

The clock is injectable (tests drive a fake), and ``enabled=False``
reduces every call to one attribute load + branch — the registry's
disabled-path discipline.
"""
import collections
import contextlib
import time

from ..registry import default_registry
from ..telemetry import record_perf_schema
from .. import tracing as _tracing

__all__ = ['StepTimeline', 'PHASES', 'percentile']

PHASES = ('data_wait', 'host_dispatch', 'device_block', 'other')


def percentile(sorted_vals, p):
    """Linear-interpolation percentile over an ascending list (the
    serving metrics convention); None on empty input."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


class StepTimeline:
    """Per-step phase profiler over one registry.

        tl = StepTimeline()
        with tl.phase('data_wait'):
            batch = next(loader)
        with tl.phase('host_dispatch'):
            out = step(batch)           # async dispatch
        with tl.phase('device_block'):
            loss = out.numpy()          # block until ready
        tl.end_step()                   # finalize + histograms

    ``record(phase, seconds)`` is the low-level door for callers with
    their own timing. Phases accumulate until ``end_step``, which
    observes the histograms, updates the rolling window, and runs
    straggler detection against the median of the PREVIOUS steps.
    """

    def __init__(self, registry=None, tracer=None, clock=None,
                 window=128, straggler_factor=2.0, min_history=8):
        self.registry = registry if registry is not None \
            else default_registry()
        fams = record_perf_schema(self.registry)
        hist = fams['perf_step_phase_seconds']
        self._h = {p: hist.labels(p) for p in PHASES}
        self._m_steps = fams['perf_steps_total']
        self._m_stragglers = fams['perf_stragglers_total']
        self._clock = clock or time.monotonic
        self._tracer = tracer       # None -> default_tracer() at use
        self.window = int(window)
        self.straggler_factor = float(straggler_factor)
        self.min_history = int(min_history)
        self.enabled = True
        self.steps = 0
        self.stragglers = 0
        self._cur = {}
        self._win = {p: collections.deque(maxlen=self.window)
                     for p in PHASES}
        self._totals = collections.deque(maxlen=self.window)

    # ---- recording ----------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name):
        """Time a with-block into phase `name` of the current step."""
        if not self.enabled:
            yield self
            return
        t0 = self._clock()
        try:
            yield self
        finally:
            self.record(name, self._clock() - t0)

    def record(self, phase, seconds):
        """Add `seconds` to `phase` of the step being assembled."""
        if not self.enabled:
            return
        if phase not in self._h:
            raise ValueError('unknown phase %r (one of %s)'
                             % (phase, ', '.join(PHASES)))
        self._cur[phase] = self._cur.get(phase, 0.0) + float(seconds)

    def discard(self):
        """Drop the partially-assembled step without observing it —
        e.g. the loader's final StopIteration data_wait at epoch end,
        which belongs to no step."""
        self._cur = {}

    def end_step(self, wall_seconds=None, exemplar=None):
        """Finalize the step. With `wall_seconds`, the gap between the
        recorded phases and the wall lands in 'other'. Returns the
        per-phase dict (plus 'total'/'straggler') or None when nothing
        was recorded."""
        if not self.enabled:
            return None
        cur, self._cur = self._cur, {}
        if not cur and wall_seconds is None:
            return None
        total = sum(cur.values())
        if wall_seconds is not None and wall_seconds > total:
            cur['other'] = cur.get('other', 0.0) + (wall_seconds - total)
            total = float(wall_seconds)
        # straggler check against the PREVIOUS steps' median, before
        # this step pollutes the window
        straggler = False
        median = None
        if len(self._totals) >= self.min_history:
            median = percentile(sorted(self._totals), 50)
            straggler = bool(median) and \
                total > self.straggler_factor * median
        tracer = self._tracer if self._tracer is not None \
            else _tracing.default_tracer()
        if exemplar is None and tracer.enabled:
            span = tracer.current()
            if span is not None:
                exemplar = getattr(span, 'trace_id', None)
        for p, s in cur.items():
            self._win[p].append(s)
            self._h[p].observe(s, exemplar=exemplar)
        self._totals.append(total)
        self.steps += 1
        self._m_steps.inc()
        if straggler:
            self.stragglers += 1
            self._m_stragglers.inc()
            if tracer.enabled:
                tracer.start_span('perf.straggler',
                                  tags={'total_s': round(total, 6),
                                        'median_s': round(median, 6),
                                        'step': self.steps}).finish()
        out = dict(cur)
        out['total'] = total
        out['straggler'] = straggler
        return out

    # ---- rolling statistics -------------------------------------------

    def percentile(self, p, phase=None):
        """Rolling percentile of step totals (or one phase) over the
        window; None with no history."""
        data = self._totals if phase is None else self._win[phase]
        return percentile(sorted(data), p)

    def summary(self):
        """{phase: {count, mean, p50, p90}} over the rolling window,
        plus step/straggler totals."""
        out = {'steps': self.steps, 'stragglers': self.stragglers}
        for p in PHASES:
            vals = sorted(self._win[p])
            if not vals:
                continue
            out[p] = {'count': len(vals),
                      'mean': sum(vals) / len(vals),
                      'p50': percentile(vals, 50),
                      'p90': percentile(vals, 90)}
        if self._totals:
            tot = sorted(self._totals)
            out['total'] = {'count': len(tot),
                            'mean': sum(tot) / len(tot),
                            'p50': percentile(tot, 50),
                            'p90': percentile(tot, 90)}
        return out
