"""Exporters: Prometheus text exposition (format 0.0.4) and JSON
snapshots of a MetricRegistry (counterpart of paddle_tpu/monitor/export.py,
copied whole: it needs nothing but the standard library).

The text format is what `curl :port/metrics` and every Prometheus scraper
consume; the JSON snapshot is the machine-diffable form the dryrun
telemetry line and tools/check_metrics_snapshot.py work from (schema =
metric names + label keys, the part a silent de-instrumentation breaks).
"""
import json
import math

__all__ = ['to_prometheus', 'to_dict', 'to_json', 'schema_of',
           'snapshot_to_prometheus']


def _esc_help(s):
    return s.replace('\\', '\\\\').replace('\n', '\\n')


def _esc_label(s):
    return (s.replace('\\', '\\\\').replace('\n', '\\n')
            .replace('"', '\\"'))


def _fmt_value(v):
    if isinstance(v, float) and math.isinf(v):
        return '+Inf' if v > 0 else '-Inf'
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return repr(int(v))
    return repr(float(v))


def _labels_text(names, values, extra=()):
    pairs = ['%s="%s"' % (n, _esc_label(v))
             for n, v in zip(names, values)]
    pairs.extend('%s="%s"' % (n, _esc_label(str(v))) for n, v in extra)
    return '{%s}' % ','.join(pairs) if pairs else ''


def to_prometheus(registry):
    """The registry as Prometheus text exposition (one scrape body)."""
    out = []
    for fam in registry.collect():
        out.append('# HELP %s %s' % (fam.name, _esc_help(fam.help)))
        out.append('# TYPE %s %s' % (fam.name, fam.kind))
        for values, child in fam.samples():
            if fam.kind == 'histogram':
                # the child's mergeable cumulative view IS the `le`
                # semantics of the _bucket lines: one shared source for
                # scrapes and federation merges
                cum = child.cumulative()
                for bound, n in zip(cum['bounds'], cum['cumulative']):
                    out.append('%s_bucket%s %s' % (
                        fam.name,
                        _labels_text(fam.labelnames, values,
                                     [('le', _fmt_value(float(bound)))]),
                        n))
                lbl = _labels_text(fam.labelnames, values)
                out.append('%s_sum%s %s' % (fam.name, lbl,
                                            _fmt_value(cum['sum'])))
                out.append('%s_count%s %d' % (fam.name, lbl, cum['count']))
            else:
                out.append('%s%s %s' % (
                    fam.name, _labels_text(fam.labelnames, values),
                    _fmt_value(child.value())))
    return '\n'.join(out) + '\n'


def to_dict(registry, buckets=True):
    """JSON-able snapshot: {name: {type, labels, samples: [...]}}.

    Each sample is {'labels': {...}} plus either {'value': v} (counter /
    gauge) or {'count': n, 'sum': s[, 'buckets': {...}]} (histogram).
    `buckets=False` trims per-bucket counts — what the one-line dryrun
    telemetry snapshot wants.
    """
    out = {}
    for fam in registry.collect():
        samples = []
        for values, child in fam.samples():
            s = {'labels': dict(zip(fam.labelnames, values))}
            if fam.kind == 'histogram':
                snap = child.snapshot()
                s['count'] = snap['count']
                s['sum'] = snap['sum']
                if buckets:
                    s['buckets'] = {
                        _fmt_value(float(b)): n
                        for b, n in zip(fam.buckets, snap['buckets'])}
                    s['buckets']['+Inf'] = snap['buckets'][-1]
                    ex = snap.get('exemplars')
                    if ex:
                        # text exposition 0.0.4 has no exemplar syntax,
                        # so trace links ride the JSON snapshot only
                        def _bound(i):
                            return (_fmt_value(float(fam.buckets[i]))
                                    if i < len(fam.buckets) else '+Inf')
                        s['exemplars'] = {
                            _bound(i): {'trace_id': t, 'value': v,
                                        'ts': ts}
                            for i, (t, v, ts) in sorted(ex.items())}
            else:
                s['value'] = child.value()
            samples.append(s)
        out[fam.name] = {'type': fam.kind,
                         'labels': list(fam.labelnames),
                         'samples': samples}
    return out


def to_json(registry, **kw):
    return json.dumps(to_dict(registry, **kw), sort_keys=True,
                      separators=(',', ':'))


def _bound_key(text):
    """Sort key for formatted bucket bounds ('+Inf' sorts last)."""
    return math.inf if text == '+Inf' else float(text)


def snapshot_to_prometheus(snapshot):
    """Render a to_dict()-shaped snapshot dict as text exposition.

    Registries render through to_prometheus directly; this path exists
    for snapshots that no longer have a live registry behind them — the
    federation merge (monitor/federation.py) and archived dryrun lines —
    so `/fleet?format=prom` can serve the merged fleet view to a
    standard scraper. Histogram samples without per-bucket detail
    (buckets=False snapshots) emit sum/count only.
    """
    out = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        kind = fam.get('type', 'gauge')
        names = list(fam.get('labels') or ())
        out.append('# TYPE %s %s' % (name, kind))
        for s in fam.get('samples', ()):
            labels = dict(s.get('labels') or {})
            ordered = [n for n in names if n in labels] + \
                [n for n in sorted(labels) if n not in names]
            pairs = [(n, labels[n]) for n in ordered]
            if kind == 'histogram':
                lbl = _labels_text((), (), pairs)
                buckets = s.get('buckets')
                if buckets:
                    acc = 0
                    for b in sorted(buckets, key=_bound_key):
                        acc += int(buckets[b])
                        out.append('%s_bucket%s %d' % (
                            name, _labels_text((), (),
                                               pairs + [('le', b)]), acc))
                out.append('%s_sum%s %s'
                           % (name, lbl, _fmt_value(float(s.get('sum')
                                                          or 0.0))))
                out.append('%s_count%s %d' % (name, lbl,
                                              int(s.get('count') or 0)))
            else:
                out.append('%s%s %s' % (
                    name, _labels_text((), (), pairs),
                    _fmt_value(s.get('value') or 0.0)))
    return '\n'.join(out) + '\n'


def schema_of(snapshot):
    """{metric name: {'type': kind, 'labels': sorted label keys}} from a
    to_dict() snapshot — the identity the regression gate diffs; values
    and label VALUES are deliberately excluded."""
    return {name: {'type': fam['type'],
                   'labels': sorted(fam['labels'])}
            for name, fam in snapshot.items()}
