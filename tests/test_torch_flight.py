"""The port's flight recorder and tail-based trace retention
(paddle_tpu_torch/monitor/tracing.py) against the JAX package's, on the
CPU: the same span dicts through both packages' FlightRecorder and
TraceRetention on one fake clock give dumps equal as JSON and the same
keep / drop decisions (exact); tools/perf_report.py reads the port's
dumps as it reads the JAX package's; the port's RPC channel and shard
supervisor dump on the reference's triggers; the tracer's ring keeps its
accessors.
"""
import glob
import json
import os
import subprocess
import sys

import pytest

from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor import tracing as jtracing
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.monitor.registry import MetricRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _span(i, trace, parent=None, status='ok', start=None, end=None):
    start = float(i) if start is None else start
    return {'name': 'op%d' % i, 'trace_id': trace, 'span_id': 's%02d' % i,
            'parent_id': parent, 'start': start,
            'end': start + 0.5 if end is None else end, 'tid': 7,
            'status': status, 'error': None if status == 'ok' else 'boom',
            'tags': {'k': i}, 'events': [{'ts': start, 'name': 'e',
                                          'args': {'i': i}}]}


SPANS = ([_span(i, 't%d' % (i % 3), parent='p') for i in range(7)] +
         [_span(7, 't0', status='error'), _span(8, 't0'),
          _span(9, 't1', start=20.0, end=23.5), _span(10, 't2'),
          _span(11, 't3'), _span(12, 't4', start=30.0, end=30.1)])


def _drive_recorder(mod, reg_cls, dump_dir, reg=None):
    t = [0.0]
    rec = mod.FlightRecorder(capacity=5, dump_dir=dump_dir, cooldown=10.0,
                             registry=reg if reg is not None else reg_cls(),
                             clock=lambda: t[0])
    paths = []
    for i, s in enumerate(SPANS):
        t[0] = float(i)
        rec.record(dict(s))
        if i in (3, 6, 9, 12):
            paths.append(rec.maybe_dump('chaos_fault' if i % 2 else
                                        'circuit_open'))
    paths.append(rec.dump('manual'))
    return rec, paths


def test_flight_recorder_dumps_equal_jax(tmp_path):
    """The same spans on the same fake clock: equal rings, drop counts,
    dump paths (modulo the directory), payloads and dump counters."""
    jreg, treg = JRegistry(), MetricRegistry()
    jrec, jpaths = _drive_recorder(jtracing, JRegistry,
                                   str(tmp_path / 'jax'), jreg)
    trec, tpaths = _drive_recorder(ttracing, MetricRegistry,
                                   str(tmp_path / 'port'), treg)
    assert [None if p is None else os.path.basename(p) for p in tpaths] == \
        [None if p is None else os.path.basename(p) for p in jpaths]
    assert trec.spans() == jrec.spans() and trec.dropped == jrec.dropped
    for jp, tp in zip(jpaths, tpaths):
        if jp is not None:
            assert json.load(open(tp)) == json.load(open(jp))
    assert trec.to_chrome('x') == jrec.to_chrome('x')
    for name in ('trace_flight_dumps_total', 'trace_spans_dropped_total'):
        assert texport.to_dict(treg)[name] == jexport.to_dict(jreg)[name]


@pytest.mark.parametrize('cfg', [
    dict(capacity=2, slow_threshold_s=1.0),
    dict(capacity=8, slow_threshold_s=None, keep_probability=0.5),
    dict(capacity=8, pending_capacity=2, slow_threshold_s=3.0),
])
def test_trace_retention_decisions_equal_jax(cfg):
    """Roots close each trace (parent_id None); marks, errors, slow roots,
    the sampled baseline (one seeded rng sequence), the pending and kept
    caps and straggler spans: equal kept trees and counters."""
    roots = [_span(20 + i, 't%d' % i, start=float(i), end=float(i) + d)
             for i, d in enumerate((0.2, 4.0, 0.5, 2.0, 0.1))]
    runs = []
    for mod, reg_cls, exp in ((jtracing, JRegistry, jexport),
                              (ttracing, MetricRegistry, texport)):
        draws = iter([0.1, 0.9, 0.3, 0.7, 0.2, 0.8] * 4)
        reg = reg_cls()
        ret = mod.TraceRetention(registry=reg, rng=lambda: next(draws),
                                 **cfg)
        ret.mark('t2', 'failover')
        for s in SPANS:
            ret.offer(dict(s))
        for r in roots:
            ret.offer(dict(r))
        ret.offer(_span(40, 't1'))          # straggler of a kept tree
        ret.mark('t1', 'late')
        fams = exp.to_dict(reg)
        runs.append((ret.traces(), [ret.get('t%d' % i) for i in range(5)],
                     ret.traces(reason='failover'), len(ret),
                     {n: fams[n] for n in fams if n.startswith('trace_')}))
    assert runs[1] == runs[0]
    assert runs[1][0]                       # something was kept


def test_perf_report_reads_port_flight_dumps(tmp_path):
    """tools/perf_report.py --flight-dir, run as a subprocess, prints the
    same report over the port's dumps as over the JAX package's."""
    _drive_recorder(jtracing, JRegistry, str(tmp_path / 'jax'))
    _drive_recorder(ttracing, MetricRegistry, str(tmp_path / 'port'))
    rec = ttracing.FlightRecorder(dump_dir=str(tmp_path / 'port'),
                                  registry=MetricRegistry())
    jrec = jtracing.FlightRecorder(dump_dir=str(tmp_path / 'jax'),
                                   registry=JRegistry())
    for r in (rec, jrec):
        r.record({'name': 'perf.recompile', 'start': 1.0, 'duration': 2.0,
                  'tags': {'callsite': 'a.py:3:f', 'signature': 'f32[2]'}})
        r.dump('recompile')
    outs = []
    for sub in ('jax', 'port'):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, 'tools', 'perf_report.py'),
             '--flight-dir', str(tmp_path / sub)],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.replace(str(tmp_path / sub), 'DIR'))
    assert outs[1] == outs[0]
    assert 'a.py:3:f' in outs[1]


def test_tracer_feeds_recorder_and_retention():
    """A finished span lands in the recorder's ring and is offered to the
    retention store."""
    reg = MetricRegistry()
    tr = ttracing.Tracer(registry=reg,
                         recorder=ttracing.FlightRecorder(capacity=3,
                                                          registry=reg),
                         retention=ttracing.TraceRetention(registry=reg))
    with tr.start_span('root') as root:
        with tr.start_span('child'):
            pass
    tr.retention.mark(root.trace_id, 'forced')
    assert [s['name'] for s in tr.recorder.spans()] == ['child', 'root']
    assert tr.recorder.capacity == 3
    with tr.start_span('r2') as r2:
        r2.set_error(ValueError('x'))
    for _ in range(2):
        tr.start_span('x').finish()
    assert tr.recorder.dropped == 2 and len(tr.recorder.spans()) == 3
    assert [t['reasons'] for t in tr.retention.traces()] == [['error']]
    assert tr.retention.get(r2.trace_id)[0]['name'] == 'r2'


def _dead_channel():
    from paddle_tpu_torch.distributed.resilience import (
        CircuitBreaker, ResilientChannel, RetryPolicy)
    return ResilientChannel(
        '127.0.0.1:1',
        retry_policy=RetryPolicy(max_attempts=6, base_delay=0.001,
                                 max_delay=0.002),
        breaker=CircuitBreaker(failure_threshold=3, reset_timeout=60.0))


def test_resilience_dumps_circuit_open_and_deadline(tmp_path):
    """The port's ResilientChannel dumps once when its breaker opens, with
    the failing attempts in the ring, and once on an expired deadline —
    the JAX channel's triggers."""
    from paddle_tpu_torch.distributed.resilience import (CircuitOpenError,
                                                         Deadline,
                                                         DeadlineExceeded)
    reg = MetricRegistry()
    tr = ttracing.Tracer(registry=reg, recorder=ttracing.FlightRecorder(
        dump_dir=str(tmp_path), registry=reg))
    prev = ttracing.set_default_tracer(tr)
    try:
        ch = _dead_channel()
        for _ in range(2):
            with pytest.raises(CircuitOpenError):
                ch.call({'op': 'stats'})
        dumps = glob.glob(str(tmp_path / 'flight_circuit_open_*.json'))
        assert len(dumps) == 1
        att = [s for s in json.load(open(dumps[0]))['spans']
               if s['name'] == 'rpc.attempt']
        assert att and all(s['status'] == 'error' for s in att)
        ch.close()
        ch = _dead_channel()
        with pytest.raises(DeadlineExceeded):
            ch.call({'op': 'stats'}, deadline=Deadline(0.0))
        assert len(glob.glob(str(tmp_path /
                                 'flight_deadline_expired_*.json'))) == 1
        ch.close()
    finally:
        ttracing.set_default_tracer(prev)


def test_supervisor_dumps_on_recover_and_abort(tmp_path):
    """ShardSupervisor.recover dumps 'supervisor_recover' after a restart
    and 'supervisor_abort' when the ladder runs out."""
    from paddle_tpu_torch.distributed.resilience import RetryPolicy
    from paddle_tpu_torch.distributed.supervisor import (ShardSpec,
                                                         ShardSupervisor,
                                                         SupervisorAbort)
    reg = MetricRegistry()
    tr = ttracing.Tracer(registry=reg, recorder=ttracing.FlightRecorder(
        dump_dir=str(tmp_path), registry=reg, cooldown=0.0))
    prev = ttracing.set_default_tracer(tr)
    try:
        alive = {'ok': True}
        sup = ShardSupervisor(restart_budget=1, registry=reg,
                              backoff=RetryPolicy(base_delay=0.0,
                                                  max_delay=0.0, jitter=0.0))
        sup.add_shard(ShardSpec('s0', '127.0.0.1:1', role='ps',
                                restart=lambda: None))
        sup._ping = lambda spec: alive['ok']
        sup.recover('s0')
        assert glob.glob(str(tmp_path / 'flight_supervisor_recover_*'))
        alive['ok'] = False
        with pytest.raises(SupervisorAbort):
            sup.recover('s0')
        assert glob.glob(str(tmp_path / 'flight_supervisor_abort_*'))
    finally:
        ttracing.set_default_tracer(prev)
