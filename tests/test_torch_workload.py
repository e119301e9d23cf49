"""The port's workload language (paddle_tpu_torch/capacity/workload.py)
against the JAX package's, on the CPU.

The serving rungs key their rows on a spec's hash, so the same spec must
give the same trace in both packages: arrays, tenant and model names,
prompt token ids, the canonical JSONL and the hash, all bit for bit
(tolerance: exact equality). The specs are the ones bench_extra.py builds
(`_serving_workload`: Poisson arrivals, a prompt-length ladder, a fixed
output; its tenant mixes; the shared-prefix burst; the prefix-affinity
spec; the capacity sweep's diurnal / zipf / lognormal mix) plus the
generator's remaining knobs.
"""
import numpy as np
import pytest

from paddle_tpu.capacity import workload as jwl
from paddle_tpu.monitor import events as jevents
from paddle_tpu_torch.capacity import workload as twl
from paddle_tpu_torch.monitor import events as tevents
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving import ContinuousBatchingEngine, ServingGateway
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM


def _serving(n_req, lens, mnt, mean_gap, vocab, tenants=None):
    """bench_extra._serving_workload's spec, as a dict."""
    return dict(requests=n_req, seed=0, vocab_size=vocab,
                arrival={'process': 'poisson', 'mean_gap_s': mean_gap},
                lengths={'dist': 'ladder', 'lens': list(lens)},
                output={'dist': 'fixed', 'len': mnt}, tenants=tenants)


LENS = (32, 64, 96, 128)
SPECS = {
    # the serving rungs' on-TPU configuration
    'serving': _serving(32, LENS, 64, 0.02, 30528),
    # the QoS rung: premium + bg round robin, and the bg-only burst
    'qos': _serving(32, LENS, 64, 0.02, 30528, tenants={
        'mode': 'round_robin',
        'tenants': [{'name': 'premium'}, {'name': 'bg'}]}),
    'qos_burst': _serving(16, LENS, 64, 0.02, 30528, tenants={
        'mode': 'round_robin', 'tenants': [{'name': 'bg'}]}),
    # the tenant rung: per-tenant length ladders
    'tenant_ladders': _serving(32, LENS, 64, 0.02, 30528, tenants={
        'mode': 'round_robin', 'tenants': [
            {'name': 'premium',
             'lengths': {'dist': 'ladder', 'lens': [32, 64]}},
            {'name': 'batch',
             'lengths': {'dist': 'ladder', 'lens': [96, 128]}}]}),
    # the multi-model rung
    'models': dict(_serving(24, (8, 16, 24, 32), 32, 0.002, 512),
                   models={'mode': 'zipf', 'count': 3}),
    # the paged rung's shared system prompt, everything at t = 0
    'shared_prefix': dict(requests=16, seed=0, vocab_size=512,
                          arrival={'process': 'burst'},
                          lengths={'dist': 'ladder', 'lens': [8, 16]},
                          output={'dist': 'fixed', 'len': 16},
                          prefix={'len': 32, 'groups': 1, 'prob': 1.0}),
    # the fabric rung's prefix groups
    'prefix_groups': dict(requests=24, seed=1, vocab_size=512,
                          arrival={'process': 'poisson',
                                   'mean_gap_s': 0.002},
                          lengths={'dist': 'ladder', 'lens': [4, 8]},
                          output={'dist': 'fixed', 'len': 8},
                          prefix={'len': 24, 'groups': 4, 'prob': 0.9}),
    # the capacity sweep's mix, cut to 2000 requests
    'diurnal_zipf': dict(requests=2000, seed=0,
                         arrival={'process': 'diurnal',
                                  'mean_gap_s': 0.0005, 'period_s': 120.0,
                                  'peak_to_trough': 4.0},
                         lengths={'dist': 'zipf', 'a': 1.8, 'min': 8,
                                  'max': 256},
                         output={'dist': 'lognormal', 'median': 12,
                                 'sigma': 0.5, 'min': 1, 'max': 64},
                         tenants={'mode': 'zipf', 'count': 20, 'a': 1.5}),
    # correlated bursts, weighted tenants and models
    'bursty_weighted': dict(requests=200, seed=5,
                            arrival={'process': 'poisson',
                                     'mean_gap_s': 0.01,
                                     'burst': {'prob': 0.3, 'size': 4,
                                               'jitter_s': 0.001}},
                            lengths={'dist': 'lognormal', 'median': 40,
                                     'sigma': 0.8, 'min': 2, 'max': 300},
                            tenants={'mode': 'weighted', 'tenants': [
                                {'name': 'a', 'weight': 3.0},
                                {'name': 'b', 'weight': 1.0}]},
                            models={'mode': 'weighted', 'models': [
                                {'name': 'm0', 'weight': 1.0},
                                {'name': 'm1', 'weight': 2.0}]}),
}

ARRAYS = ('arrival', 'prompt_len', 'new_tokens', 'tenant_id',
          'prefix_group', 'prefix_len', 'model_id')


def _assert_same_trace(jt, tt):
    for name in ARRAYS:
        a, b = getattr(jt, name), getattr(tt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jt.tenant_names == tt.tenant_names
    assert jt.model_names == tt.model_names
    assert jt.meta == tt.meta


@pytest.mark.parametrize('name', sorted(SPECS))
def test_generate_matches_jax(name):
    d = SPECS[name]
    js, ts = jwl.WorkloadSpec(**d), twl.WorkloadSpec(**d)
    assert ts.canonical_json() == js.canonical_json()
    assert ts.hash == js.hash
    jt, tt = js.generate(), ts.generate()
    _assert_same_trace(jt, tt)
    assert tt.to_jsonl() == jt.to_jsonl()
    if len(tt) <= 200:
        assert tt.prompts() == jt.prompts()
    # the spec round-trips through its dict form in either package
    assert twl.WorkloadSpec.from_dict(js.to_dict()).hash == js.hash


def test_poisson_arrivals_match_jax():
    np.testing.assert_array_equal(twl.poisson_arrivals(64, 0.02, seed=3),
                                  jwl.poisson_arrivals(64, 0.02, seed=3))


def test_trace_jsonl_roundtrip():
    tt = twl.WorkloadSpec(**SPECS['bursty_weighted']).generate()
    back = twl.Trace.from_jsonl(tt.to_jsonl())
    # a loaded trace numbers tenants and models by first appearance
    for name in ('arrival', 'prompt_len', 'new_tokens', 'prefix_group',
                 'prefix_len'):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(tt, name), err_msg=name)
    assert back.tenants() == tt.tenants()
    assert back.models() == tt.models()
    assert back.meta == tt.meta
    # the reference reads the port's JSONL to the same trace
    _assert_same_trace(jwl.Trace.from_jsonl(tt.to_jsonl()), back)


def test_unknown_knobs_raise():
    with pytest.raises(ValueError, match='arrival process'):
        twl.WorkloadSpec(4, arrival={'process': 'gamma'}).generate()
    with pytest.raises(ValueError, match='length dist'):
        twl.WorkloadSpec(4, lengths={'dist': 'pareto'}).generate()
    with pytest.raises(ValueError, match='requests'):
        twl.WorkloadSpec(0)


@pytest.fixture(scope='module')
def gateway_events():
    """The wide events of a small replay-shaped run through the port's
    gateway: two tenants, one request shed by admission."""
    from paddle_tpu_torch.capacity import QosPolicy, TenantClass
    cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=1,
                    num_heads=2, max_position_embeddings=64, dropout=0.0)
    model = GPTForCausalLM(cfg, device='cpu', seed=3).eval()
    log = tevents.RequestLog(capacity=64, registry=MetricRegistry())
    prev = tevents.set_default_request_log(log)
    try:
        clock = {'t': 10.0}
        gw = ServingGateway(
            lambda: ContinuousBatchingEngine(model, num_slots=2, max_len=32,
                                             prefill_chunk=8,
                                             decode_block=2),
            replicas=1, registry=MetricRegistry(),
            clock=lambda: clock['t'],
            admission=QosPolicy(classes=[TenantClass('bg', rate=1.0,
                                                     burst=1.0)]))
        trace = twl.WorkloadSpec(**_serving(
            6, (3, 5, 7), 4, 0.1, 97, tenants={
                'mode': 'round_robin',
                'tenants': [{'name': 'premium'}, {'name': 'bg'}]})
        ).generate()
        for i, (p, t) in enumerate(zip(trace.prompts(), trace.tenants())):
            clock['t'] = 10.0 + float(trace.arrival[i])
            gw.submit(p, max_new_tokens=4, tenant=t)
        gw.run()
    finally:
        tevents.set_default_request_log(prev)
    return trace, log.events()


def test_trace_from_port_events_matches_jax(gateway_events):
    trace, events = gateway_events
    assert len(events) == len(trace)
    assert sum(e['outcome'] == 'rejected' for e in events) >= 1
    tt = twl.trace_from_events(events)
    _assert_same_trace(jwl.trace_from_events(events), tt)
    # arrivals rebase to 0 and keep their gaps; shed requests stay in
    np.testing.assert_allclose(tt.arrival, trace.arrival, rtol=0,
                               atol=1e-9)
    assert tt.tenants() == trace.tenants()
    assert list(tt.prompt_len) == list(trace.prompt_len)


def test_load_trace_reads_event_lines_and_sinks(gateway_events, tmp_path):
    trace, events = gateway_events
    text = '\n'.join(['noise'] + [jevents.event_line(e, 1, '[gw]')
                                  for e in events] + ['more noise'])
    parsed = tevents.parse_event_lines(text)
    assert [tag for tag, _ in parsed] == ['gw'] * len(events)
    assert [ev for _, ev in parsed] == events
    _assert_same_trace(jwl.load_trace(text=text), twl.load_trace(text=text))
    # a trace file written by the port loads back in both packages
    path = tmp_path / 'trace.jsonl'
    path.write_text(trace.to_jsonl())
    _assert_same_trace(jwl.load_trace(path=str(path)),
                       twl.load_trace(path=str(path)))
    with pytest.raises(ValueError, match='path or text'):
        twl.load_trace(text='')
