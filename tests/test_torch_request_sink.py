"""The port's wide-event request log sink and filters
(paddle_tpu_torch/monitor/events.py) against the JAX package's, on the
CPU: the same emits into both packages' RequestLog give byte-equal JSONL
sinks through size-capped rotation, equal filtered views and equal
event lines; tools/request_report.py, tools/registry_report.py and
tools/capacity_report.py, run as subprocesses, give the same verdict and
report on the port's sink as on the JAX package's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.monitor import events as jevents
from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu_torch.monitor import events as tevents
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor.registry import MetricRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_events(n=40, seed=0):
    """A seeded serving run's wide events: Poisson arrivals, two tenants,
    two models, a few failovers and rejections."""
    rng = np.random.RandomState(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.exponential(0.05))
        prompt = int(rng.randint(4, 64))
        new = int(rng.randint(9, 33))
        rejected = rng.rand() < 0.1
        admit = None if rejected else t + float(rng.exponential(0.01))
        chunks = -(-prompt // 16)
        first = None if rejected else admit + 0.004 * chunks + 0.006
        finish = t + 0.001 if rejected else \
            first + 0.006 * (-(-new // 4) - 1)
        out.append(dict(
            request_id=i, tenant=('premium', 'bg')[i % 2],
            model=('m1', 'm2')[(i // 3) % 2], priority=i % 2,
            trace_id='%032x' % i, arrival_t=t, admit_t=admit,
            first_token_t=first, finish_t=finish,
            queue_wait_s=None if admit is None else admit - t,
            prefill_chunks=0 if rejected else chunks, prompt_tokens=prompt,
            output_tokens=0 if rejected else new, prefix_hit_tokens=0,
            spec_proposed=0, spec_accepted=0,
            kv_page_seconds=0.0 if rejected else (finish - admit) * 2,
            failovers=int(i % 7 == 3), replicas=[i % 2],
            outcome='rejected' if rejected else 'ok'))
    return out


def _logs(tmp_path, cap=4096):
    """Both packages' logs fed the same run; returns the two, with their
    registries and sink paths."""
    out = {}
    for name, mod, reg_cls in (('jax', jevents, JRegistry),
                               ('port', tevents, MetricRegistry)):
        reg = reg_cls()
        path = str(tmp_path / name / 'requests.jsonl')
        os.makedirs(os.path.dirname(path))
        log = mod.RequestLog(capacity=32, sink_path=path,
                             max_sink_bytes=cap, sink_backups=2,
                             registry=reg)
        for ev in _run_events():
            log.emit(**ev)
        out[name] = (log, reg, path)
    return out


def test_sink_rotation_byte_equal(tmp_path):
    """Rotation at the size cap, the backups shifted, the oldest dropped:
    byte-equal files, equal ring, drop and rotation counters."""
    logs = _logs(tmp_path)
    (jlog, jreg, jpath), (tlog, treg, tpath) = logs['jax'], logs['port']
    rotated = 0
    for suffix in ('', '.1', '.2', '.3'):
        assert os.path.exists(tpath + suffix) == \
            os.path.exists(jpath + suffix), suffix
        if os.path.exists(tpath + suffix):
            rotated += 1
            assert open(tpath + suffix, 'rb').read() == \
                open(jpath + suffix, 'rb').read(), suffix
    assert rotated == 3
    fams = ('request_events_total', 'request_events_dropped_total',
            'request_sink_rotations_total')
    for f in fams:
        assert texport.to_dict(treg)[f] == jexport.to_dict(jreg)[f], f
    assert treg.get('request_sink_rotations_total').value() >= 2
    assert tlog.dropped == jlog.dropped == 8 and len(tlog) == 32


FILTERS = [dict(), dict(tenant='bg'), dict(model='m2'),
           dict(outcome='rejected'), dict(min_failovers=1),
           dict(since_ts=0.4, until_ts=1.2), dict(limit=5),
           dict(tenant='premium', model='m1', limit=3),
           dict(until_ts=0.9, limit=0)]


@pytest.mark.parametrize('kw', FILTERS)
def test_events_filters_equal_jax(tmp_path, kw):
    logs = _logs(tmp_path)
    assert logs['port'][0].events(**kw) == logs['jax'][0].events(**kw)


def test_event_line_and_env_switch(tmp_path, monkeypatch):
    """event_line writes the JAX line byte for byte and parse_event_lines
    reads it back; PADDLE_TPU_REQUEST_LOG names the default sink path."""
    ev = _run_events(3)[2]
    line = tevents.event_line(ev, 8, '[serving]')
    assert line == jevents.event_line(ev, 8, '[serving]')
    assert tevents.parse_event_lines('x\n' + line + '\n') == \
        jevents.parse_event_lines('x\n' + line + '\n') == [('serving', ev)]
    path = str(tmp_path / 'env.jsonl')
    monkeypatch.setenv('PADDLE_TPU_REQUEST_LOG', path)
    log = tevents.RequestLog(registry=MetricRegistry())
    log.emit(request_id=1, outcome='ok')
    assert log.sink_path == path and json.loads(
        open(path).read())['request_id'] == 1


def _tool(script, args, tmp_path, sub):
    out = subprocess.run([sys.executable, os.path.join(REPO, 'tools', script)]
                         + args, capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    return out.returncode, out.stdout.replace(str(tmp_path / sub), 'DIR')


@pytest.mark.parametrize('script,args', [
    ('request_report.py', ['--jsonl', '{sink}', '--jsonl', '{sink}.1',
                           '--slo-ms', '40', '--top', '3']),
    ('registry_report.py', ['--jsonl', '{sink}', '--jsonl', '{sink}.1',
                            '--model', 'm2']),
    ('capacity_report.py', ['--trace', '{sink}', '--real', '{sink}',
                            '--calibrate', '--decode-block', '4',
                            '--prefill-chunk', '16', '--num-slots', '4',
                            '--sweep', '1,2']),
])
def test_report_tools_same_verdict(tmp_path, script, args):
    """Each report tool over the port's sink: the JAX sink's exit code
    (the verdict) and report."""
    logs = _logs(tmp_path)
    runs = [_tool(script, [a.format(sink=logs[sub][2]) for a in args],
                  tmp_path, sub) for sub in ('jax', 'port')]
    assert runs[1] == runs[0]
    assert runs[1][1].strip()
