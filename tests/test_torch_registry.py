"""The port's model registry and weight pager (paddle_tpu_torch/serving/
registry/) and ServingGateway.rollout() against the JAX package's, on the
CPU.

- ModelRegistry: content-addressed fingerprints and the serving pointer.
- ModelHost: the JAX host and the port's run the same stub engine factory
  through one scripted sequence of loads, acquires, releases, pins,
  evictions and parked submits. They must keep identical residency, the
  same eviction order (the LRU oracle of tests/test_model_registry.py),
  the same errors and identical registry_* samples.
- rollout(): on a tiny GPT whose weights are carried from the JAX model,
  the port's gateway and the JAX gateway over 2 ModelHost replicas give
  the same placements, tokens and summary. The summary's cache_hits /
  cache_misses carry each package's own meaning (XLA's persistent cache
  there, the port's kernel builds here), so they are checked apart.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import io_save as jio_save
from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu.serving import ContinuousBatchingEngine as JSlotEngine
from paddle_tpu.serving import ServingGateway as JGateway
from paddle_tpu.serving.gateway.router import \
    ModelAffinityRouter as JAffinityRouter
from paddle_tpu.serving.metrics import ServingMetrics as JServingMetrics
from paddle_tpu.serving.registry import ModelHost as JModelHost
from paddle_tpu.serving.registry import ModelRegistry as JModelRegistry
from paddle_tpu.serving.scheduler import DONE as JDONE
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.framework import compile_cache
from paddle_tpu_torch.framework import io_save
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, ModelHost,
                                      ModelRegistry, ServingGateway)
from paddle_tpu_torch.serving.gateway import ModelAffinityRouter
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.registry.registry import artifact_fingerprint
from paddle_tpu_torch.serving.scheduler import DONE as TDONE
from paddle_tpu_torch.text.models import gpt as tgpt


# ---- the two packages, side by side ------------------------------------


PKGS = {
    'jax': dict(Registry=JModelRegistry, Host=JModelHost,
                Metrics=JServingMetrics, MetricRegistry=JRegistry,
                export=jexport, DONE=JDONE),
    'port': dict(Registry=ModelRegistry, Host=ModelHost,
                 Metrics=ServingMetrics, MetricRegistry=MetricRegistry,
                 export=texport, DONE=TDONE),
}


def _stub_engine_class(pkg):
    """The engine contract of tests/test_model_registry.py's stub: every
    queued request completes on step() with `max_new_tokens` copies of
    the version digit, so a test can tell which weights served it."""
    p = PKGS[pkg]

    class StubEngine:
        max_len = 128
        num_slots = 4
        spec_k = 0
        trace_counts = {'prefill': 1, 'decode': 1}   # read by the JAX host

        def __init__(self, entry):
            self.entry = entry
            self.metrics = p['Metrics'](registry=p['MetricRegistry']())
            self._reqs = []

        class _Sched:
            def __init__(self, eng):
                self.eng = eng

            @property
            def pending(self):
                return sum(1 for r in self.eng._reqs if not r.done)

            @property
            def queue(self):
                return tuple(r for r in self.eng._reqs if not r.done)

        @property
        def scheduler(self):
            return StubEngine._Sched(self)

        def enqueue(self, req):
            if req._arrival_t is None:
                req._arrival_t = self.metrics.now()
            self._reqs.append(req)
            return req

        def step(self):
            for r in self._reqs:
                if not r.done:
                    r.tokens.extend([int(self.entry.version[-1])]
                                    * r.max_new_tokens)
                    r.state = p['DONE']
                    r.outcome = 'ok'
                    r._finished.set()
            return self.scheduler.pending

        def generate(self, prompts, max_new_tokens=2, emit_event=True):
            return [[1] * max_new_tokens for _ in prompts]

        def shutdown(self):
            pass

        def rebind_perf(self, registry):
            pass
    return StubEngine


class _Clock:
    """One fake monotonic clock per host: both hosts read it the same
    number of times, so load seconds and histogram sums agree."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


MODELS = [('alpha', 'v1', 1.0), ('alpha', 'v2', 2.0), ('beta', 'v1', 3.0),
          ('gamma', 'v1', 4.0)]


def _zoo(pkg, root):
    reg = PKGS[pkg]['Registry'](root=str(root))
    for m, v, scale in MODELS:
        reg.publish(m, v, {'w': [scale] * 64})
    return reg


def _host(pkg, root, budget_models=None):
    p = PKGS[pkg]
    reg = _zoo(pkg, root)
    nbytes = reg.entry('alpha', 'v1').nbytes
    budget = None if budget_models is None \
        else int(budget_models * nbytes)
    clock = _Clock()
    host = p['Host'](reg, _stub_engine_class(pkg), byte_budget=budget,
                     clock=clock)
    host.metrics = p['Metrics'](registry=p['MetricRegistry'](), clock=clock)
    return host


def _registry_samples(pkg, host):
    snap = PKGS[pkg]['export'].to_dict(host.metrics.registry)
    return {k: v for k, v in snap.items() if k.startswith('registry_')}


# the scripted sequence: (op, args); every op runs on both hosts
SCRIPT = [
    ('load', 'alpha', 'v1'), ('load', 'beta', 'v1'), ('load', 'gamma', 'v1'),
    ('load', 'alpha', 'v1'), ('load', 'alpha', 'v2'), ('load', 'beta', 'v1'),
    ('acquire', 'beta', 'v1'), ('evict', 'beta', 'v1'),
    ('hosts', 'beta', 'v1'), ('load', 'gamma', 'v1'),
    ('release', 'beta', 'v1'), ('release', 'beta', 'v1'),
    ('load', 'alpha', 'v2'), ('pin', 'alpha', 'v2'),
    ('evict', 'alpha', 'v2'), ('load', 'beta', 'v1'),
    ('load', 'gamma', 'v1'), ('prepare_rollout', 'alpha', 'v1'),
    ('finish_rollout', 'alpha', 'v2'),
    ('submit', 'alpha', None), ('submit', 'gamma', None),
    ('submit', 'beta', 'v1'), ('step',), ('step',), ('step',),
    ('unpin', 'alpha', 'v2'), ('evict', 'alpha', 'v2'),
    ('submit', 'nosuch', None), ('load', 'alpha', 'v1'),
    ('refcount', 'alpha', 'v1'), ('step',),
]


def _run_script(pkg, root, budget_models):
    host = _host(pkg, root, budget_models)
    trace, reqs = [], []
    for op, *args in SCRIPT:
        try:
            if op == 'load':
                info = host.load(*args)
                out = {k: info[k] for k in ('loaded', 'model', 'version',
                                            'fingerprint', 'cache_hits',
                                            'cache_misses')}
            elif op == 'submit':
                model, version = args
                req = host.add_request([1, 2, 3], max_new_tokens=3,
                                       model=model, version=version,
                                       emit_event=False)
                reqs.append(req)
                out = req.done
            elif op == 'step':
                out = host.step()
            elif op == 'hosts':
                out = host.hosts_model(*args)
            else:
                out = getattr(host, op)(*args)
        except Exception as e:      # noqa: BLE001 — the type is the result
            out = type(e).__name__
        trace.append((op, tuple(args), out, host.resident_models(),
                      host.resident_bytes,
                      {k: host.refcount(*k)
                       for k in host.resident_models()}))
    finished = [(r.done, r.outcome, list(r.tokens)) for r in reqs]
    return trace, finished, _registry_samples(pkg, host)


@pytest.mark.parametrize('budget_models', [None, 2.5, 3.5])
def test_model_host_bookkeeping_matches_jax(tmp_path, budget_models):
    jtrace, jdone, jsamples = _run_script('jax', tmp_path / 'j',
                                          budget_models)
    ttrace, tdone, tsamples = _run_script('port', tmp_path / 't',
                                          budget_models)
    for j, t in zip(jtrace, ttrace):
        assert t == j, t[:2]
    assert tdone == jdone
    assert sorted(tsamples) == sorted(jsamples)
    for name in jsamples:
        assert tsamples[name] == jsamples[name], name
    # the walk reached every branch it is there for
    outs = [x[2] for x in ttrace]
    assert 'ValueError' in outs and 'KeyError' in outs
    assert any(d == (True, 'ok', [1, 1, 1]) for d in tdone)


def test_lru_eviction_order_and_budget_match_the_oracle(tmp_path):
    """tests/test_model_registry.py's LRU oracle, run on both hosts."""
    order = [('alpha', 'v1'), ('beta', 'v1'), ('gamma', 'v1'),
             ('alpha', 'v1'), ('alpha', 'v2'), ('beta', 'v1')]
    runs = {}
    for pkg in PKGS:
        host = _host(pkg, tmp_path / pkg, budget_models=2.5)
        resident, evicted, seen = [], [], []
        for key in order:
            host.load(*key)
            if key in resident:
                resident.remove(key)
            while len(resident) >= 2:
                evicted.append(resident.pop(0))
            resident.append(key)
            assert host.resident_bytes <= host.byte_budget
            assert sorted(host.resident_models()) == sorted(resident)
            seen.append(host.resident_models())
        counts = {m: int(host._m_evictions.labels(m).value())
                  for m in ('alpha', 'beta', 'gamma')}
        assert counts == {m: sum(1 for k in evicted if k[0] == m)
                          for m in ('alpha', 'beta', 'gamma')}
        runs[pkg] = seen
    assert runs['port'] == runs['jax']


def test_deferred_eviction_and_double_release(tmp_path):
    host = _host('port', tmp_path, budget_models=4)
    nbytes = host.registry.entry('alpha', 'v1').nbytes
    host.load('alpha', 'v1')
    host.acquire('alpha', 'v1')
    assert host.evict('alpha', 'v1') is False          # deferred
    assert host.resident_bytes == nbytes
    assert not host.hosts_model('alpha', 'v1')
    assert host._m_deferred.value() == 1
    assert host.release('alpha', 'v1') == 0            # completes it
    assert host.resident_models() == []
    with pytest.raises(ValueError, match='double-release'):
        host.release('alpha', 'v1')
    host.load('beta', 'v1', pin=True)
    with pytest.raises(ValueError, match='pinned'):
        host.evict('beta', 'v1')
    with pytest.raises(RuntimeError, match='budget'):
        _host('port', tmp_path / 'small', budget_models=0.5).load(
            'alpha', 'v1')


def test_parked_submit_loads_asynchronously_and_unknown_refused(tmp_path):
    host = _host('port', tmp_path)
    req = host.add_request([1, 2, 3], max_new_tokens=4, model='beta',
                           emit_event=False)
    assert not req.done and host.resident_models() == []
    assert host.scheduler.pending == 1
    for _ in range(10):
        if req.done:
            break
        host.step()
    assert req.done and req.tokens == [1, 1, 1, 1]
    assert host.refcount('beta', 'v1') == 0
    with pytest.raises(KeyError):
        host.add_request([1], max_new_tokens=2, model='nosuch',
                         emit_event=False)
    capped = ModelHost(host.registry, _stub_engine_class('port'),
                       max_len=4)
    with pytest.raises(ValueError, match='cannot ever be admitted'):
        capped.add_request([1, 2, 3], max_new_tokens=3, model='beta')
    with pytest.raises(NotImplementedError, match='CUDA-graph'):
        host.program_trace_counts()


def test_fingerprints_are_content_addressed(tmp_path):
    reg = ModelRegistry(root=str(tmp_path / 'a'))
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    e1 = reg.publish('m', 'v1', {'w': w, 'b': w.bfloat16()})
    other = ModelRegistry(root=str(tmp_path / 'b'))
    e2 = other.publish('n', 'v9', {'w': w.clone(), 'b': w.bfloat16()})
    assert e1.fingerprint == e2.fingerprint
    e3 = reg.publish('m', 'v2', {'w': w + 1, 'b': w.bfloat16()})
    assert e3.fingerprint != e1.fingerprint
    assert artifact_fingerprint(e1.path) == e1.fingerprint
    assert reg.resolve('m').version == 'v1'
    assert reg.set_serving('m', 'v2') == 'v1'
    assert reg.resolve('m').version == 'v2'
    with pytest.raises(KeyError):
        reg.set_serving('m', 'v7')
    back = reg.load('m', 'v1')
    assert torch.equal(back['b'].view(torch.int16),
                       w.bfloat16().view(torch.int16))
    # the same plain-python content gives the JAX registry's fingerprint:
    # only tensor payloads differ between the packages
    plain = {'w': [1.0] * 64}
    jreg = JModelRegistry(root=str(tmp_path / 'j'))
    assert reg.publish('p', 'v1', plain).fingerprint == \
        jreg.publish('p', 'v1', plain).fingerprint


# ---- rollout on a tiny GPT ----------------------------------------------


CFG = dict(vocab_size=97, hidden_size=32, num_layers=1, num_heads=2,
           max_position_embeddings=64, dropout=0.0)
ENGINE_KW = dict(num_slots=2, max_len=32, prefill_chunk=8, decode_block=2)


class _GwClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _rollout_run(pkg, tmp_path, states):
    """Two ModelHost replicas behind a sync gateway: requests before the
    swap, rollout('m', 'v2'), requests after it."""
    if pkg == 'jax':
        reg = JModelRegistry(root=str(tmp_path / 'jax'))
        for version, (jstate, _) in states.items():
            reg.publish('m', version, jstate)

        def engine_for(entry):
            m = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
            m.set_state_dict(jio_save.load(entry.path))
            m.eval()
            return JSlotEngine(m, **ENGINE_KW)
        gw = JGateway(lambda: JModelHost(reg, engine_for, max_len=32),
                      replicas=2, router=JAffinityRouter(),
                      registry=JRegistry(), clock=_GwClock())
    else:
        reg = ModelRegistry(root=str(tmp_path / 'port'))
        for version, (_, tstate) in states.items():
            reg.publish('m', version, tstate)

        def engine_for(entry):
            m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
            m.load_state_dict(io_save.load(entry.path))
            return ContinuousBatchingEngine(m.eval(), **ENGINE_KW)
        gw = ServingGateway(lambda: ModelHost(reg, engine_for, max_len=32),
                            replicas=2, router=ModelAffinityRouter(),
                            registry=MetricRegistry(), clock=_GwClock())
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(0, 97, n)]
               for n in (3, 9, 5, 12, 4, 7)]
    before = [gw.submit(p, max_new_tokens=5, model='m') for p in prompts]
    gw.run()
    summary = gw.rollout('m', 'v2')
    after = [gw.submit(p, max_new_tokens=5, model='m') for p in prompts]
    gw.run()
    gw.shutdown()
    reqs = before + after
    return ([r.tokens for r in reqs], [r.replica_history for r in reqs],
            [r.error for r in reqs], summary,
            [r.engine.registry.serving_version('m') for r in gw.pool])


def test_rollout_matches_jax_on_carried_weights(tmp_path):
    states = {}
    for version, seed in (('v1', 21), ('v2', 22)):
        paddle.seed(seed)
        jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
        arrays = {k: np.asarray(v.numpy())
                  for k, v in jm.state_dict().items()}
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
        tgpt.load_paddle_tpu_state(tm, arrays)
        states[version] = (jm.state_dict(), tm.state_dict())
    compile_cache.reset_stats()
    jt, jh, je, js, jv = _rollout_run('jax', tmp_path, states)
    tt, th, te, ts, tv = _rollout_run('port', tmp_path, states)
    assert te == je == [None] * len(je)
    assert tt == jt
    assert th == jh
    assert tv == jv == ['v2', 'v2']
    assert tt[:6] != tt[6:]          # v2's weights answered after the flip
    for key in ('model', 'from_version', 'to_version', 'replicas'):
        assert ts[key] == js[key], key
    assert (ts['model'], ts['from_version'], ts['to_version'],
            ts['replicas']) == ('m', 'v1', 'v2', [0, 1])
    assert ts['load_s'] > 0 and js['load_s'] > 0
    # cache_*: the JAX package counts XLA's persistent cache; the port
    # counts kernel builds, and its engines build none
    assert (ts['cache_hits'], ts['cache_misses']) == (0, 0)
    assert compile_cache.stats() == {'hits': 0, 'misses': 0}


def test_compile_cache_counts_kernel_builds(tmp_path, monkeypatch):
    """The port's compile cache is the kernel build directory: an
    up-to-date library is a hit, an nvcc run a miss."""
    from paddle_tpu_torch import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    assert compile_cache.configure(str(tmp_path)) == str(tmp_path)
    compile_cache.reset_stats()
    assert compile_cache.hit_rate() is None
    lib = _build._target('flash_fwd')[1]
    assert lib.startswith(str(tmp_path))
    open(lib, 'wb').close()                 # an up-to-date library
    assert _build.build(['flash_fwd']) == {'flash_fwd': ''}
    os.unlink(lib)

    def no_nvcc():
        raise RuntimeError('nvcc not found')
    monkeypatch.setattr(_build, 'nvcc_path', no_nvcc)
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build(['flash_fwd'])         # a miss: it would compile
    assert compile_cache.stats() == {'hits': 1, 'misses': 1}
    assert compile_cache.hit_rate() == 0.5
    assert compile_cache.configure() == _build.DEFAULT_BUILD_DIR
    compile_cache.reset_stats()
