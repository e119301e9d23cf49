"""Cross-process metric federation: one merged view of a fleet
(counterpart of paddle_tpu/monitor/federation.py, copied: it needs
nothing but the standard library).

Every process in the reference deployment — PS shards, graph shards,
gateway replicas — owns a private MetricRegistry;
until now nothing could answer "how many tokens did the FLEET serve".
The FleetCollector closes that gap Prometheus-style: **pull-based**
scraping of registered targets, either

- **in-process registries** (gateway replicas, in-proc PS shards) read
  directly through ``export.to_dict``, or
- **HTTP targets** — any peer running a MetricsServer — fetched from
  its ``/metrics.json`` endpoint,

then merged into one snapshot with fixed semantics per metric kind:

==========  ===========================================================
counter     summed across targets per label set (totals stay EXACT:
            every target's last-known value participates, so a dead
            target's already-counted work is never lost and the merged
            total is monotone)
gauge       kept per target with an added ``instance`` label (summing
            occupancies across replicas would manufacture nonsense;
            pass-through when the family already carries ``instance`` —
            federation-of-federations)
histogram   merged bucket-wise per label set — requires the fixed
            shared boundaries ``registry.Histogram`` guarantees; sums
            and counts add, so fleet-level percentiles come from the
            merged buckets
==========  ===========================================================

Failure is data, not absence: a target whose scrape fails keeps its
last-known snapshot (marked **stale**) in the merge and flips
``fleet_target_up{instance}`` to 0 — consumers see exact totals plus an
explicit liveness signal, never silently shrinking sums. Each scrape
cycle runs under a ``fleet.scrape`` span with one child span per target
riding the existing tracer, so a slow shard shows up in the flight
ring like any other laggard.

Transport ops fire the resilience fault hooks ('send'/'recv' scoped to
the target's endpoint), so ``chaos.partition`` black-holes a scrape
target exactly as it does a socket peer — the chaos federation test
kills a target mid-cycle this way.

Everything here is stdlib-only: the resilience hook import is lazy and
optional.
"""
import json
import re
import threading
import time
import urllib.request

from . import export
from .registry import default_registry

__all__ = ['ScrapeTarget', 'FleetCollector', 'merge_snapshots',
           'fleet_snapshot_line', 'FLEET_LINE_RE']

FLEET_LINE_RE = re.compile(r'fleet_snapshot\((?P<n>\d+)\)'
                           r'\[(?P<tag>[^\]]*)\]:\s*(?P<json>\{.*\})\s*$')

_fire_fault_points = None


def _fire(point, endpoint):
    """Resilience chaos hooks, imported lazily so monitor/ stays loadable
    without the distributed package."""
    global _fire_fault_points
    if _fire_fault_points is None:
        try:
            from ..distributed.resilience import fire_fault_points
        except Exception:
            def fire_fault_points(point, endpoint):
                return None
        _fire_fault_points = fire_fault_points
    _fire_fault_points(point, endpoint)


class ScrapeTarget:
    """One scrapeable peer: an in-process registry OR a /metrics.json
    URL. `instance` is the merge label value — keep it bounded and
    stable (replica index, shard endpoint), never per-request."""

    def __init__(self, instance, registry=None, url=None, timeout=2.0):
        if (registry is None) == (url is None):
            raise ValueError('pass exactly one of registry= or url=')
        self.instance = str(instance)
        self.registry = registry
        self.url = None
        if url is not None:
            url = url.rstrip('/')
            self.url = url if url.endswith('.json') \
                else url + '/metrics.json'
        self.timeout = float(timeout)
        self.endpoint = self.url or ('inproc://%s' % self.instance)

    def fetch(self):
        """One scrape: the target's full to_dict snapshot. Raises on an
        unreachable/dead target; the chaos hooks fire around the fetch
        so an injected partition surfaces as the same failure."""
        _fire('send', self.endpoint)
        if self.registry is not None:
            snap = export.to_dict(self.registry)
        else:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout) as resp:
                snap = json.loads(resp.read().decode('utf-8'))
        _fire('recv', self.endpoint)
        if not isinstance(snap, dict):
            raise ValueError('target %s returned non-dict snapshot'
                             % self.instance)
        return snap

    def __repr__(self):
        return 'ScrapeTarget(%s, %s)' % (self.instance, self.endpoint)


def _sample_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def merge_snapshots(named_snaps, conflicts=None):
    """Merge [(instance, to_dict snapshot)] into one snapshot dict.

    Pure function — the collector calls it with last-known snapshots,
    tests call it directly. Families that disagree across targets on
    type, label keys, or histogram bucket boundaries are dropped from
    the merge and reported in `conflicts` (a list, appended in place):
    a wrong answer is worse than a missing one.
    """
    merged = {}                  # name -> {'type','labels',samples dict}
    skipped = set()
    for instance, snap in named_snaps:
        for name, fam in snap.items():
            if name in skipped:
                continue
            kind = fam.get('type')
            labels = list(fam.get('labels') or ())
            gauge_passthrough = kind == 'gauge' and 'instance' in labels
            out_labels = labels if kind != 'gauge' or gauge_passthrough \
                else labels + ['instance']
            cur = merged.get(name)
            if cur is None:
                cur = merged[name] = {'type': kind,
                                      'labels': out_labels,
                                      '_samples': {}}
            elif cur['type'] != kind or cur['labels'] != out_labels:
                if conflicts is not None:
                    conflicts.append({'family': name,
                                      'instance': instance,
                                      'problem': 'type_or_labels'})
                skipped.add(name)
                del merged[name]
                continue
            for s in fam.get('samples', ()):
                slabels = dict(s.get('labels') or {})
                if kind == 'gauge':
                    if not gauge_passthrough:
                        slabels['instance'] = instance
                    cur['_samples'][_sample_key(slabels)] = {
                        'labels': slabels,
                        'value': float(s.get('value') or 0.0)}
                elif kind == 'histogram':
                    key = _sample_key(slabels)
                    acc = cur['_samples'].get(key)
                    if acc is None:
                        acc = cur['_samples'][key] = {
                            'labels': slabels, 'count': 0, 'sum': 0.0}
                    acc['count'] += int(s.get('count') or 0)
                    acc['sum'] += float(s.get('sum') or 0.0)
                    buckets = s.get('buckets')
                    if buckets is not None:
                        mine = acc.setdefault('buckets', {})
                        if mine and set(mine) != set(buckets):
                            if conflicts is not None:
                                conflicts.append({
                                    'family': name,
                                    'instance': instance,
                                    'problem': 'bucket_bounds'})
                            skipped.add(name)
                            del merged[name]
                            break
                        for b, n in buckets.items():
                            mine[b] = mine.get(b, 0) + int(n)
                else:                     # counter
                    key = _sample_key(slabels)
                    acc = cur['_samples'].get(key)
                    if acc is None:
                        acc = cur['_samples'][key] = {
                            'labels': slabels, 'value': 0.0}
                    acc['value'] += float(s.get('value') or 0.0)
    out = {}
    for name, fam in merged.items():
        out[name] = {'type': fam['type'], 'labels': fam['labels'],
                     'samples': [fam['_samples'][k]
                                 for k in sorted(fam['_samples'])]}
    return out


class _TargetState:
    """Per-target scrape bookkeeping (guarded by the collector lock)."""

    __slots__ = ('target', 'snapshot', 'up', 'stale', 'last_ok',
                 'last_error', 'scrapes', 'errors')

    def __init__(self, target):
        self.target = target
        self.snapshot = None
        self.up = False
        self.stale = False
        self.last_ok = None
        self.last_error = None
        self.scrapes = 0
        self.errors = 0

    def status(self, now):
        return {
            'endpoint': self.target.endpoint,
            'up': bool(self.up),
            'stale': bool(self.stale),
            'scrapes': self.scrapes,
            'errors': self.errors,
            'staleness_s': (None if self.last_ok is None
                            else round(now - self.last_ok, 3)),
            'last_error': self.last_error,
        }


class FleetCollector:
    """Pull-based scraper + merger over a set of ScrapeTargets.

        fc = FleetCollector()
        fc.add_target('replica-0', registry=rep0.registry)
        fc.add_target('ps-shard-1', url=shard_metrics_server.url)
        fc.scrape()                     # one cycle (or start(interval))
        fc.merged()                     # fleet-wide snapshot
        fc.fleet_status()               # /fleet body: targets + merged

    The collector's own health families (fleet_target_up,
    fleet_scrapes_total, ...) live on `registry` — single-sourced in
    telemetry.FLEET_FAMILIES like every other subsystem. Disabled
    (`enabled=False` or disable()) the collector scrapes nothing and
    merged() serves the last view: zero cost outside scrape calls, and
    nothing here ever touches the RPC or decode hot paths.
    """

    def __init__(self, registry=None, tracer=None, clock=None,
                 timeout=2.0, enabled=True):
        from .telemetry import record_fleet_schema
        self.registry = registry if registry is not None \
            else default_registry()
        if tracer is None:
            from .tracing import default_tracer
            tracer = default_tracer()
        self.tracer = tracer
        self.clock = clock or time.time
        self.timeout = float(timeout)
        self.enabled = bool(enabled)
        fams = record_fleet_schema(self.registry)
        self._m_up = fams['fleet_target_up']
        self._m_staleness = fams['fleet_target_staleness_seconds']
        self._m_targets = fams['fleet_targets']
        self._m_scrapes = fams['fleet_scrapes_total']
        self._m_errors = fams['fleet_scrape_errors_total']
        self._m_cycle = fams['fleet_scrape_seconds']
        self._m_conflicts = fams['fleet_merge_conflicts_total']
        self._lock = threading.Lock()
        self._targets = {}            # instance -> _TargetState
        self._thread = None
        self._stop = threading.Event()

    # ---- membership ----------------------------------------------------

    def add_target(self, instance, registry=None, url=None, timeout=None):
        """Register a scrape target; returns it. Re-registering an
        instance name replaces the target but keeps no old data."""
        t = ScrapeTarget(instance, registry=registry, url=url,
                         timeout=self.timeout if timeout is None
                         else timeout)
        with self._lock:
            self._targets[t.instance] = _TargetState(t)
            self._m_targets.set(len(self._targets))
        return t

    def remove_target(self, instance):
        with self._lock:
            st = self._targets.pop(str(instance), None)
            self._m_targets.set(len(self._targets))
        return None if st is None else st.target

    def targets(self):
        with self._lock:
            return [st.target for st in self._targets.values()]

    # ---- scraping ------------------------------------------------------

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def scrape(self):
        """One federation cycle: fetch every target, update liveness and
        staleness, keep last-known snapshots for the merge. Returns
        {'ok': n, 'down': n}. A failing target never fails the cycle."""
        if not self.enabled:
            return {'ok': 0, 'down': 0, 'skipped': True}
        t0 = self.clock()
        with self._lock:
            states = list(self._targets.values())
        ok = down = 0
        with self.tracer.start_span('fleet.scrape',
                                    tags={'targets': len(states)}) as cyc:
            for st in states:
                with self.tracer.start_span(
                        'fleet.scrape.target',
                        tags={'instance': st.target.instance}) as span:
                    try:
                        snap = st.target.fetch()
                    except Exception as exc:  # noqa: BLE001 — transport
                        span.set_error(exc)
                        with self._lock:
                            st.up = False
                            st.stale = st.snapshot is not None
                            st.last_error = repr(exc)
                            st.errors += 1
                        self._m_errors.labels(st.target.instance).inc()
                        down += 1
                        continue
                    with self._lock:
                        st.snapshot = snap
                        st.up = True
                        st.stale = False
                        st.last_ok = self.clock()
                        st.last_error = None
                        st.scrapes += 1
                    ok += 1
            now = self.clock()
            for st in states:
                inst = st.target.instance
                self._m_up.labels(inst).set(1.0 if st.up else 0.0)
                self._m_staleness.labels(inst).set(
                    -1.0 if st.last_ok is None else now - st.last_ok)
            cyc.set_tag('ok', ok)
            cyc.set_tag('down', down)
        self._m_scrapes.inc()
        self._m_cycle.observe(self.clock() - t0)
        return {'ok': ok, 'down': down}

    # ---- the merged view -----------------------------------------------

    def merged(self, buckets=True):
        """The fleet-wide snapshot (to_dict shape) over every target's
        last-known data — stale targets included, so counter totals are
        monotone across target death. `buckets=False` trims per-bucket
        histogram detail (the fleet_snapshot dryrun line)."""
        with self._lock:
            named = [(st.target.instance, st.snapshot)
                     for st in self._targets.values()
                     if st.snapshot is not None]
        conflicts = []
        out = merge_snapshots(named, conflicts=conflicts)
        if conflicts:
            self._m_conflicts.inc(len(conflicts))
        if not buckets:
            for fam in out.values():
                if fam['type'] == 'histogram':
                    for s in fam['samples']:
                        s.pop('buckets', None)
        return out

    def fleet_status(self):
        """The /fleet body: per-target liveness + the merged snapshot."""
        now = self.clock()
        with self._lock:
            targets = {inst: st.status(now)
                       for inst, st in self._targets.items()}
        return {'ts': now, 'targets': targets,
                'up': sum(1 for t in targets.values() if t['up']),
                'merged': self.merged()}

    # ---- background loop (production cadence) --------------------------

    def start(self, interval_s=10.0):
        """Scrape on a daemon thread every `interval_s` until stop()."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(interval_s):
                try:
                    self.scrape()
                except Exception:   # noqa: BLE001 — keep the loop alive
                    pass

        self._thread = threading.Thread(target=_run,
                                        name='fleet-collector',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def fleet_snapshot_line(collector, n_devices, tag):
    """One parseable dryrun line embedding the fleet status (bucket
    detail trimmed — same discipline as telemetry.snapshot_line).
    Parsed back by tools/fleet_status.py via FLEET_LINE_RE."""
    status = collector.fleet_status()
    status['merged'] = collector.merged(buckets=False)
    return 'fleet_snapshot(%d)%s: %s' % (
        n_devices, tag, json.dumps(status, sort_keys=True,
                                   separators=(',', ':')))
