"""The port's CompileWatchdog (paddle_tpu_torch/monitor/perf/watchdog.py)
on jit.to_static functions, on the CPU (Inductor compiles them here):
after the warmup barrier the same shape counts 0 recompiles and a new one
counts 1, attributed to the calling line of this file with the call's
signature; strict mode raises RecompileError from the call;
suspended() and the owner filter hold; a program served from Inductor's
FX graph cache is not a recompile; the stage counters and the flight
ring carry the record. (The JAX package's watchdog listens to
jax.monitoring and is not compared: the two packages compile different
programs.)
"""
import glob
import inspect
import os

import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch.monitor import export, tracing
from paddle_tpu_torch.monitor.perf import watchdog as wdmod
from paddle_tpu_torch.monitor.perf import CompileWatchdog, RecompileError
from paddle_tpu_torch.monitor.registry import MetricRegistry


@pytest.fixture(autouse=True)
def fresh_inductor_cache(tmp_path, monkeypatch):
    """Each test compiles into a cache directory of its own, one compile
    thread; Inductor's FX graph and AOTAutograd caches start empty."""
    monkeypatch.setenv('TORCHINDUCTOR_CACHE_DIR', str(tmp_path / 'inductor'))
    monkeypatch.setattr(torch._inductor.config, 'compile_threads', 1)
    yield


def _fn(x, w):
    return torch.tanh(x @ w).sum(dim=-1)


W = torch.randn(8, 8)


def _watchdog(tmp_path=None, **kw):
    reg = MetricRegistry()
    rec = tracing.FlightRecorder(
        registry=reg, dump_dir=None if tmp_path is None else str(tmp_path))
    tr = tracing.Tracer(registry=reg, recorder=rec)
    return CompileWatchdog(registry=reg, tracer=tr, **kw), reg, tr


def _line_of(marker):
    src, start = inspect.getsourcelines(inspect.currentframe().f_back.f_code)
    return start + next(i for i, l in enumerate(src) if marker in l)


def test_recompile_counted_and_attributed(tmp_path):
    wd, reg, tr = _watchdog(tmp_path, name='t')
    try:
        sf = tpt.jit.to_static(_fn)
        sf(torch.randn(4, 8), W)
        assert wd.compile_events == 1 and wd.recompiles == 0
        assert wd.counts['trace'] >= 1 and wd.counts['compile'] >= 1
        wd.declare_warmup('warm')
        for _ in range(3):
            sf(torch.randn(4, 8), W)
        assert wd.recompiles == 0
        sf(torch.randn(6, 8), W)  # the new shape
        line = _line_of('# the new shape')
        assert wd.recompiles == 1
        rec = wd.records[-1]
        assert rec['callsite'] == '%s:%d:%s' % (
            os.path.abspath(__file__), line,
            'test_recompile_counted_and_attributed')
        assert rec['signature'].startswith('float32[6, 8], float32[8, 8]')
        assert rec['after_warmup'] == 'warm' and rec['watchdog'] == 't'
        snap = export.to_dict(reg)
        assert snap['perf_recompiles_total']['samples'][0]['value'] == 1.0
        kinds = {s['labels']['kind']: s['value']
                 for s in snap['perf_compiles_total']['samples']}
        assert kinds == {k: float(v) for k, v in wd.counts.items()}
        ring = [s for s in tr.recorder.spans()
                if s['name'] == 'perf.recompile']
        assert len(ring) == 1 and ring[0]['tags']['callsite'] == \
            rec['callsite']
        assert glob.glob(str(tmp_path / 'flight_recompile_*.json'))
    finally:
        wd.close()
    assert not wd.active


def test_strict_raises_from_the_call(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_COMPILE_STRICT', '1')
    wd, _, _ = _watchdog()
    try:
        assert wd.strict
        sf = tpt.jit.to_static(_fn)
        sf(torch.randn(3, 8), W)
        wd.declare_warmup()
        with pytest.raises(RecompileError, match='float32\\[5, 8\\]'):
            sf(torch.randn(5, 8), W)
        # the program compiled all the same: the next call runs it
        sf(torch.randn(5, 8), W)
        assert wd.recompiles == 1
        wdmod.raise_pending()                      # nothing left
    finally:
        wd.close()


def test_suspended_and_owner_filter():
    """suspended() disarms for deliberate compiles; a watchdog owned by
    another object is not charged, one owned by the to_static layer
    is."""
    net = torch.nn.Linear(8, 4)
    other = object()
    mine, _, _ = _watchdog(owner=net)
    theirs, _, _ = _watchdog(owner=other)
    try:
        static = tpt.jit.to_static(net)
        static(torch.randn(2, 8))
        for wd in (mine, theirs):
            wd.declare_warmup()
        with mine.suspended(), theirs.suspended():
            static(torch.randn(3, 8))
        assert mine.recompiles == theirs.recompiles == 0
        assert mine.armed and theirs.armed
        static(torch.randn(5, 8))
        assert mine.recompiles == 1 and theirs.recompiles == 0
    finally:
        mine.close()
        theirs.close()


def test_fx_graph_cache_hit_is_not_a_recompile():
    """A second to_static of the same function compiles again in Dynamo,
    but Inductor serves the graph from its FX graph cache: exempt, and
    counted as a persistent-cache hit."""
    wd, reg, _ = _watchdog()
    try:
        tpt.jit.to_static(_fn)(torch.randn(4, 8), W)
        misses = reg.get('perf_persistent_cache_misses_total').value()
        assert misses >= 1
        wd.declare_warmup()
        tpt.jit.to_static(_fn)(torch.randn(4, 8), W)
        assert wd.compile_events == 2 and wd.recompiles == 0
        assert reg.get('perf_persistent_cache_hits_total').value() >= 1
    finally:
        wd.close()


def test_missing_dynamo_callbacks_raise(monkeypatch):
    import torch._dynamo.callback as cb
    monkeypatch.setattr(cb, 'callback_handler', object())
    with pytest.raises(RuntimeError, match='compile callbacks'):
        CompileWatchdog(registry=MetricRegistry())


@pytest.mark.parametrize('what', ['stage_source', 'stage_table'])
def test_missing_compile_accounting_raises(monkeypatch, what):
    """A torch whose stage timers or stage-time table moved raises at
    construction instead of counting nothing."""
    wdmod._check_compile_sources.cache_clear()
    if what == 'stage_source':
        monkeypatch.setitem(wdmod._STAGE_SOURCES, 'compile_fx_inner',
                            ('torch._dynamo.callback',))
    else:
        import torch._dynamo.utils as du
        monkeypatch.setattr(du, 'compilation_time_metrics', None)
    try:
        with pytest.raises(RuntimeError, match='compile accounting'):
            CompileWatchdog(registry=MetricRegistry())
    finally:
        wdmod._check_compile_sources.cache_clear()


def test_failing_callback_raises_from_the_call(monkeypatch):
    """A callback that fails keeps its exception in errors / report()
    and the compiling call raises it, strict or not."""
    wd, _, _ = _watchdog(name='w')
    try:
        assert not wd.strict

        def broken():
            raise KeyError('fxgraph_cache_hit')
        monkeypatch.setattr(wdmod, '_cache_marks', broken)
        sf = tpt.jit.to_static(_fn)
        with pytest.raises(RuntimeError, match='compile-start callback'):
            sf(torch.randn(4, 8), W)
        assert len(wd.errors) == 1 and wd.compile_events == 0
        assert 'fxgraph_cache_hit' in wd.report()['errors'][0]
        wdmod.raise_pending()                      # nothing left
    finally:
        wd.close()


def test_jit_pays_nothing_without_a_watchdog():
    """An open watchdog registers one after-call hook in jit, and close()
    takes it out; with none, current_signature() stays None in a call."""
    seen = []

    def probe(x):
        seen.append(tpt.jit.current_signature())
        return x + 1
    hooks = tpt.jit._after_call_hooks
    assert hooks == []
    sf = tpt.jit.to_static(probe)
    sf(torch.ones(2))
    assert seen == [None]
    wd, _, _ = _watchdog()
    assert hooks == [wdmod.raise_pending]
    try:
        seen.clear()
        tpt.jit.to_static(probe)(torch.ones(3))
        assert seen and seen[0].startswith('float32[3]')
    finally:
        wd.close()
    wd.close()
    assert hooks == []


def test_fit_runs_a_watchdog_owned_by_the_model():
    """Model.fit wires a CompileWatchdog(owner=model) beside its
    StepTimeline and closes it: the eager step compiles nothing."""
    net = torch.nn.Linear(4, 2)
    model = tpt.Model(net)
    model.prepare(optimizer=tpt.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters()),
        loss=torch.nn.functional.mse_loss)
    data = tpt.io.TensorDataset([torch.randn(8, 4), torch.randn(8, 2)])
    model.fit(data, batch_size=4, epochs=2, verbose=0, shuffle=False)
    wd = model.last_watchdog
    assert wd.owner is model and wd.name == 'Model.fit'
    assert wd.armed and not wd.active and wd.recompiles == 0
