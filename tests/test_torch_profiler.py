"""The port's profiler (paddle_tpu_torch/profiler/) on the CPU:
RecordEvent gives both a tracer span and a torch.profiler trace event;
the Profiler writes a Chrome trace into its log dir (redirected by
export_chrome_tracing), stops idempotently, refuses a GPU target without
CUDA; merge_traces of two ranks' directories (a profiler trace and a
flight recorder's export) equals the JAX package's merge of the same
directories, lanes and pid ranges included."""
import json
import os

import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu import profiler as jprofiler
from paddle_tpu_torch import profiler
from paddle_tpu_torch.monitor import tracing
from paddle_tpu_torch.monitor.registry import MetricRegistry


@pytest.fixture
def tracer():
    tr = tracing.Tracer(registry=MetricRegistry())
    prev = tracing.set_default_tracer(tr)
    yield tr
    tracing.set_default_tracer(prev)


def test_record_event_is_dual_sink(tracer, tmp_path):
    prof = profiler.Profiler(
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path / 'r0'),
                                                      worker_name='w'))
    with prof:
        with profiler.RecordEvent('region'):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        ev = profiler.RecordEvent('manual')
        ev.begin()
        ev.end()
        prof.step()
    assert prof.log_dir == str(tmp_path / 'r0')
    assert os.path.basename(prof.trace_path).startswith('w.')
    names = [e['name'] for e in json.load(open(prof.trace_path))[
        'traceEvents']]
    assert 'region' in names and 'manual' in names
    assert any(e.key == 'region' for e in prof.key_averages())
    spans = [s['name'] for s in tracer.recorder.spans()]
    assert spans == ['region', 'manual']
    assert profiler.load_profiler_result(str(tmp_path / 'r0')) == \
        [prof.trace_path]
    prof.stop()                                   # idempotent
    profiler.Profiler().stop()                    # stop without start


def test_scheduler_records_the_step_range(tracer, tmp_path):
    """scheduler=(1, 3): step 0 is traced as a warm-up and dropped, steps
    1 and 2 are recorded; the tracer keeps all three spans."""
    prof = profiler.Profiler(log_dir=str(tmp_path), scheduler=(1, 3))
    with prof:
        for i in range(3):
            with profiler.RecordEvent('step%d' % i):
                torch.randn(32, 32).sum()
            prof.step()
    names = {e['name'] for e in json.load(open(prof.trace_path))[
        'traceEvents']}
    assert {'step1', 'step2'} <= names and 'step0' not in names
    assert [s['name'] for s in tracer.recorder.spans()] == \
        ['step0', 'step1', 'step2']
    with pytest.raises(ValueError):
        profiler.Profiler(scheduler=(3, 3)).start()


@pytest.mark.parametrize('scheduler,pad_at', [(None, 0), ((1, 3), 1),
                                               ((2, 4), 2)])
def test_cuda_window_opens_on_a_pad(tmp_path, monkeypatch, scheduler,
                                    pad_at):
    """With CUDA activity on, the recording window opens on PAD_LAUNCHES
    device sleeps, once: at start without a schedule, else on the step()
    that enters the first recorded step. (The trace itself records the
    CPU here.)"""
    acts = torch.profiler.ProfilerActivity
    profile = torch.profiler.profile
    monkeypatch.setattr(profiler, '_activities',
                        lambda targets: [acts.CPU, acts.CUDA])
    monkeypatch.setattr(torch.profiler, 'profile',
                        lambda activities, **kw: profile(
                            activities=[acts.CPU], **kw))
    at, pads = [0], []
    monkeypatch.setattr(torch.cuda, '_sleep',
                        lambda cycles: pads.append((at[0], cycles)))
    prof = profiler.Profiler(log_dir=str(tmp_path), scheduler=scheduler)
    prof.start()
    for i in range(1, 4):
        torch.randn(8).sum()
        at[0] = i
        prof.step()
    prof._prof.__exit__(None, None, None)
    assert pads == [(pad_at, profiler.PAD_CYCLES)] * profiler.PAD_LAUNCHES


def test_module_level_profiler_and_targets(tmp_path):
    assert tpt.profiler is profiler
    with profiler.profiler('CPU', profile_path=str(tmp_path / 'p')):
        torch.randn(8).sum()
    assert profiler.load_profiler_result(str(tmp_path / 'p'))
    assert profiler.stop_profiler() is None       # nothing running
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            profiler.Profiler(targets=[profiler.ProfilerTarget.GPU]).start()
    with pytest.raises(ValueError):
        profiler.Profiler(targets=[profiler.ProfilerTarget.TPU]).start()


def test_merge_traces_equals_jax(tracer, tmp_path):
    r0, r1 = str(tmp_path / 'rank0'), str(tmp_path / 'rank1')
    with profiler.Profiler(log_dir=r0):
        with profiler.RecordEvent('step'):
            torch.randn(16, 16).sum()
    tracer.recorder.export_chrome(os.path.join(r1, 'host.trace.json'),
                                  process_name='host')
    outs = []
    for mod, name in ((jprofiler, 'jax.json'), (profiler, 'port.json')):
        path = mod.merge_traces([r0, r1], str(tmp_path / 'm' / name),
                                rank_names=['trainer 0', 'trainer 1'])
        outs.append(json.load(open(path)))
    assert outs[1] == outs[0]
    lanes = {e['args']['name'] for e in outs[1]['traceEvents']
             if e.get('name') == 'process_name'}
    assert 'trainer 1: host' in lanes
    assert any(n.startswith('trainer 0: ') for n in lanes)
    assert outs[1]['metadata']['merged_ranks'] == 2
