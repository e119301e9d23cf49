"""The port's multi-replica serving gateway (paddle_tpu_torch/serving/
gateway/) on the CPU: the cases of the JAX package's
tests/test_serving_gateway.py, and the JAX gateway and the port's driven
side by side.

The load-bearing assertions are the reference's:
  1. routing/failover/drain never buy availability with output drift —
     delivered tokens are IDENTICAL to a single engine's greedy run;
  2. chaos-oracle failover: a replica partitioned mid-burst yields
     EXACTLY as many gateway_failover_total increments as it had
     in-flight non-finished requests, and every request completes;
  3. the autoscaler is a pure function of (clock, observations).
And the port's own: on the same carried-over weights, prompts, partition
step and fake clock, the port's sync gateway places, fails over and
counts exactly as the JAX gateway does (tokens, each request's
replica_history, failover_log, every gateway_* / qos_* / tenant_*
sample: exact equality).
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.capacity import qos as jqos
from paddle_tpu.monitor import export as jexport
from paddle_tpu.monitor.registry import MetricRegistry as JRegistry
from paddle_tpu.serving import ContinuousBatchingEngine as JSlotEngine
from paddle_tpu.serving import ServingGateway as JGateway
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.capacity import QosPolicy, TenantClass
from paddle_tpu_torch.capacity import qos as tqos
from paddle_tpu_torch.monitor import export as texport
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedContinuousBatchingEngine,
                                      ServingGateway)
from paddle_tpu_torch.serving.gateway import (AutoscalePolicy,
                                              RoundRobinRouter,
                                              slo_burn_rate)
from paddle_tpu_torch.serving.gateway.replica import DEAD, DRAINING, STOPPED
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.text.models import gpt as tgpt

CFG = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dropout=0.0)
MNT = 8          # max_new_tokens everywhere: keeps the suite fast


@pytest.fixture(scope='module')
def pair():
    """The JAX model and the port's, on the same weights."""
    paddle.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig(**CFG))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu', seed=1)
    tgpt.load_paddle_tpu_state(tm, state)
    return jm, tm.eval()


@pytest.fixture(scope='module')
def model(pair):
    return pair[1]


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(0, 211, n)]
            for n in (3, 17, 7, 12, 5, 21, 9, 4, 14, 6)]


@pytest.fixture(scope='module')
def reference(model, prompts):
    """Single-engine greedy outputs — the parity oracle."""
    eng = ContinuousBatchingEngine(model, num_slots=2, max_len=32,
                                   prefill_chunk=8, decode_block=2)
    return eng.generate(prompts, max_new_tokens=MNT)


ENGINE_KW = dict(max_len=32, prefill_chunk=8, decode_block=2)


def _slot_factory(model):
    return lambda: ContinuousBatchingEngine(model, num_slots=2, **ENGINE_KW)


def _paged_factory(model):
    return lambda: PagedContinuousBatchingEngine(
        model, num_seqs=2, page_size=8, **ENGINE_KW)


def _gw(model, factory=None, **kw):
    kw.setdefault('registry', MetricRegistry())
    return ServingGateway(factory or _slot_factory(model), **kw)


def _counter(gw, name, labels=None):
    fam = gw.registry.get(name)
    if labels is None:
        return fam.value()
    return fam.labels(*labels).value()


# ---- routing ----------------------------------------------------------


def test_least_loaded_spreads_and_parity(model, prompts, reference):
    """Sync drive: the router spreads a burst across both replicas on
    their live queue/occupancy gauges, and delivered tokens match the
    single-engine run exactly."""
    gw = _gw(model, replicas=2)
    out = gw.generate(prompts, max_new_tokens=MNT)
    assert out == reference
    routed = [_counter(gw, 'gateway_route_total', (str(i),))
              for i in range(2)]
    assert sum(routed) == len(prompts)
    assert all(v > 0 for v in routed), routed
    assert _counter(gw, 'gateway_requests_completed_total') == len(prompts)
    assert _counter(gw, 'gateway_failover_total') == 0
    assert gw.report()['pending'] == 0


def test_round_robin_router(model, prompts, reference):
    gw = _gw(model, replicas=2, router=RoundRobinRouter())
    out = gw.generate(prompts[:4], max_new_tokens=MNT)
    assert out == reference[:4]
    routed = [_counter(gw, 'gateway_route_total', (str(i),))
              for i in range(2)]
    assert routed == [2.0, 2.0]


def test_paged_replicas_parity(model, prompts, reference):
    """The gateway fronts paged engines through the same contract."""
    gw = _gw(model, factory=_paged_factory(model), replicas=2)
    assert gw.generate(prompts[:6], max_new_tokens=MNT) == reference[:6]


def test_inadmissible_request_raises_not_failover(model):
    """The engines' front-door guard propagates to the submit() caller;
    it must never be mistaken for a transport failure."""
    gw = _gw(model, replicas=2)
    with pytest.raises(ValueError, match='max_len'):
        gw.submit(list(range(1, 30)), max_new_tokens=MNT)  # 29+8-1 > 32
    assert _counter(gw, 'gateway_requests_total') == 0
    assert _counter(gw, 'gateway_failover_total') == 0
    assert all(r.routable() for r in gw.pool)


def test_replica_engines_report_on_private_registries(model, prompts):
    """rebind_perf moved each replica engine's serving metrics and step
    timeline onto its replica's registry: the gauges the router reads
    are per replica, and the gateway registry holds none of them."""
    gw = _gw(model, replicas=2)
    gw.generate(prompts[:4], max_new_tokens=MNT)
    for rep in gw.pool:
        assert rep.engine.metrics.registry is rep.registry
        assert rep.engine.timeline.registry is rep.registry
        assert rep.registry.get('serving_tokens_total').value() == \
            MNT * _counter(gw, 'gateway_route_total', (str(rep.index),))
        assert rep.registry.get('perf_steps_total').value() > 0
    assert gw.registry.get('serving_tokens_total') is None


# ---- failover ---------------------------------------------------------


def _partition_drive(gw, prompts, partition, kill_at, step_fn=None):
    """Submit `prompts` on a seeded Poisson schedule quantised to gateway
    steps; at request `kill_at` partition replica 1. Returns (handles,
    the oracle's in-flight count, the fault)."""
    gaps = np.random.RandomState(5).exponential(1.0, size=len(prompts))
    arrival_step = np.floor(np.cumsum(gaps) / 1.5).astype(int)
    reqs, expected, fault, ctx = [], None, None, None
    try:
        i = k = 0
        while i < len(prompts) or any(not r.done for r in reqs):
            while i < len(prompts) and arrival_step[i] <= k:
                if i == kill_at:
                    ctx = partition(gw.pool[1].endpoint)
                    fault = ctx.__enter__()
                    # the oracle: in-flight non-finished on replica 1
                    # the instant the partition lands
                    expected = len([g for g in gw.pool[1].assigned
                                    if len(g.tokens) < MNT])
                reqs.append(gw.submit(prompts[i], max_new_tokens=MNT,
                                      tenant=('premium', 'bg')[i % 2]))
                i += 1
            if step_fn is not None:
                step_fn(k)
            gw.step()
            k += 1
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return reqs, expected, fault


@pytest.mark.chaos
def test_partition_failover_exact_oracle(model, prompts, reference):
    """THE acceptance test: a Poisson-arrival burst over 2 replicas,
    one partitioned mid-burst. Every request completes, outputs are
    token-identical to the single-engine run, and the failover counter
    equals EXACTLY the partitioned replica's in-flight non-finished
    count at the moment of loss (chaos-oracle style)."""
    gw = _gw(model, replicas=2)
    reqs, expected, fault = _partition_drive(gw, prompts, chaos.partition,
                                             len(prompts) // 2)
    assert expected is not None and expected > 0
    assert all(r.done for r in reqs)                    # 100% complete
    assert [r.tokens for r in reqs] == reference        # exact parity
    assert _counter(gw, 'gateway_failover_total') == expected
    # every failover is a re-placement in some request's history
    assert sum(len(r.replica_history) - 1 for r in reqs) == expected
    assert fault.fired >= 1
    assert len(gw.failover_log) == 1
    assert gw.failover_log[0]['replica'] == 1
    assert len(gw.failover_log[0]['requests']) == expected
    # the dead replica is fenced: breaker open, never routable again
    rep = gw.pool[1]
    assert rep.state == DEAD
    assert not rep.routable()
    assert rep.breaker.state == rep.breaker.OPEN
    assert gw.registry.get('gateway_replica_state').labels('1').value() \
        == 2.0
    assert _counter(gw, 'gateway_replicas') == 1
    # no chaos leaked into the next test
    assert chaos.active_faults() == 0


@pytest.mark.chaos
def test_partition_at_submission_retries_elsewhere(model, prompts,
                                                   reference):
    """A partition hit at submit time (no in-flight work yet) is a
    retry, not a failover: the walk places the request on the live
    replica in the same call."""
    gw = _gw(model, replicas=2)
    with chaos.partition(gw.pool[1].endpoint):
        reqs = [gw.submit(p, max_new_tokens=MNT) for p in prompts[:4]]
        gw.run()
    assert [r.tokens for r in reqs] == reference[:4]
    assert _counter(gw, 'gateway_retries_total') == 1.0
    assert _counter(gw, 'gateway_failover_total') == 0
    assert all(r.replica_history == [0] for r in reqs)
    assert gw.pool[1].state == DEAD


def test_kill_replica_threaded_parity(model, prompts, reference):
    """Driver-thread mode: kill a replica while its driver is mid-
    flight; every request completes with exact parity."""
    gw = _gw(model, replicas=2).start()
    try:
        reqs = [gw.submit(p, max_new_tokens=MNT) for p in prompts]
        gw.kill_replica(1)
        for r in reqs:
            assert r.wait(120), r
        assert [r.tokens for r in reqs] == reference
        assert len(gw.failover_log) == 1
        assert gw.failover_log[0]['replica'] == 1
    finally:
        gw.shutdown()
    assert gw.report()['completed'] == len(prompts)


# ---- drain ------------------------------------------------------------


def test_drain_finishes_in_flight_without_failover(model, prompts,
                                                   reference):
    """Graceful drain: the draining replica stops taking NEW work but
    its in-flight requests finish in place (no re-admission)."""
    gw = _gw(model, replicas=2)
    first = [gw.submit(p, max_new_tokens=MNT) for p in prompts[:4]]
    gw.step()
    drained = gw.drain_replica(1)
    assert drained.state == DRAINING
    assert not drained.ready()
    later = [gw.submit(p, max_new_tokens=MNT) for p in prompts[4:]]
    gw.run()
    assert [r.tokens for r in first + later] == reference
    assert _counter(gw, 'gateway_failover_total') == 0
    # nothing submitted after the drain landed on replica 1
    assert all(r.replica_history == [0] for r in later)
    # the drained replica ran dry and stopped
    assert drained.state == STOPPED


def test_replica_readyz_flips_on_drain(model):
    """A replica's MetricsServer serves 200 on /readyz while READY and
    503 once draining — with /healthz at 200 throughout (drain must not
    look like death to the kubelet)."""
    gw = _gw(model, replicas=1)
    rep = gw.pool[0]
    with rep.metrics_server() as srv:
        ok = urllib.request.urlopen(srv.url + '/readyz', timeout=5)
        assert ok.status == 200
        assert json.loads(ok.read().decode())['status'] == 'ready'
        gw.drain_replica(0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + '/readyz', timeout=5)
        assert ei.value.code == 503
        assert json.loads(ei.value.read().decode())['status'] == 'draining'
        assert urllib.request.urlopen(srv.url + '/healthz',
                                      timeout=5).status == 200
        # the replica's own serving gauges are on this scrape endpoint
        body = urllib.request.urlopen(srv.url + '/metrics',
                                      timeout=5).read().decode()
        assert 'serving_queue_depth' in body


def test_gateway_shutdown_drains_all(model, prompts, reference):
    gw = _gw(model, replicas=2).start()
    reqs = [gw.submit(p, max_new_tokens=MNT) for p in prompts[:6]]
    gw.shutdown()
    assert all(r.done for r in reqs)
    assert [r.tokens for r in reqs] == reference[:6]
    assert all(r.state == STOPPED for r in gw.pool)
    with pytest.raises(RuntimeError, match='shut down'):
        # drained engines refuse new work end to end
        gw.pool[0].engine.add_request([1, 2], max_new_tokens=2)


def test_streaming_through_gateway(model, prompts, reference):
    gw = _gw(model, replicas=2).start()
    try:
        req = gw.submit(prompts[0], max_new_tokens=MNT, stream=True)
        got = list(req.stream())
    finally:
        gw.shutdown()
    assert got == reference[0]
    assert req.done
    with pytest.raises(ValueError, match='stream=True'):
        next(_gw(model, replicas=1).submit(
            prompts[1], max_new_tokens=MNT).stream())


# ---- autoscaler: pure policy with an injectable clock -----------------


def test_slo_burn_rate_windows():
    samples = [(0.0, 0.1), (5.0, 0.9), (10.0, 0.9), (15.0, 0.1)]
    assert slo_burn_rate(samples, 15.0, 0.5, 30.0) == 0.5
    assert slo_burn_rate(samples, 15.0, 0.5, 6.0) == \
        pytest.approx(1.0 / 2.0)      # only t=10,15 in window
    assert slo_burn_rate([], 0.0, 0.5, 30.0) == 0.0
    assert slo_burn_rate(samples, 100.0, 0.5, 10.0) == 0.0


def test_policy_sustained_burn_scales_up():
    pol = AutoscalePolicy(slo_ttft_s=0.5, sustain_s=3.0, cooldown_s=10.0)
    assert pol.decide(0.0, 0.9, 0.9, 4, 2).delta == 0    # just started
    assert pol.decide(1.0, 0.9, 0.9, 4, 2).delta == 0
    d = pol.decide(3.0, 0.9, 0.9, 4, 2)
    assert d.delta == +1 and 'burn' in d.reason
    # immediately after acting: sustain restarts, then cooldown holds
    assert pol.decide(4.0, 0.9, 0.9, 4, 3).delta == 0
    d2 = pol.decide(7.0, 0.9, 0.9, 4, 3)
    assert d2.delta == 0 and 'cooling' in d2.reason
    # cooldown elapsed + still burning -> acts again
    assert pol.decide(13.0, 0.9, 0.9, 4, 3).delta == +1


def test_policy_sustained_idle_scales_down_to_min():
    pol = AutoscalePolicy(slo_ttft_s=0.5, min_replicas=1, sustain_s=2.0,
                          cooldown_s=0.0)
    assert pol.decide(0.0, 0.0, 0.0, 0, 2).delta == 0
    d = pol.decide(2.0, 0.0, 0.0, 0, 2)
    assert d.delta == -1 and 'idle' in d.reason
    # at the floor: idle forever never goes below min_replicas
    assert pol.decide(4.0, 0.0, 0.0, 0, 1).delta == 0
    assert pol.decide(9.0, 0.0, 0.0, 0, 1).delta == 0


def test_policy_flapping_suppressed_by_hysteresis():
    """A burn signal that toggles faster than sustain_s never acts; a
    pool oscillating hot/idle around an action is pinned by cooldown."""
    pol = AutoscalePolicy(slo_ttft_s=0.5, sustain_s=3.0, cooldown_s=20.0)
    for t in range(0, 12, 2):
        burn = 0.9 if (t // 2) % 2 == 0 else 0.0   # toggles every 2 s
        assert pol.decide(float(t), burn, 0.5, 1, 2).delta == 0
    # sustained burn finally acts...
    for t in (12.0, 14.0, 15.0):
        d = pol.decide(t, 0.9, 0.9, 4, 2)
    assert d.delta == +1
    # ...then a hard swing to idle within cooldown cannot flap it back
    for t in (16.0, 17.0, 18.0, 19.0, 20.0):
        assert pol.decide(t, 0.0, 0.0, 0, 3).delta == 0
    assert pol.decide(35.0, 0.0, 0.0, 0, 3).delta == -1


def test_policy_respects_max_replicas():
    pol = AutoscalePolicy(slo_ttft_s=0.5, max_replicas=2, sustain_s=0.0,
                          cooldown_s=0.0)
    d = pol.decide(0.0, 1.0, 1.0, 9, 2)
    assert d.delta == 0 and 'max_replicas' in d.reason


def test_policy_premium_tenant_burn_scales_up():
    """A premium tenant's private burn scales the pool up while the
    aggregate burn stays under the threshold."""
    pol = AutoscalePolicy(slo_ttft_s=0.5, sustain_s=0.0, cooldown_s=0.0,
                          premium_tenants=('premium',))
    d = pol.decide(0.0, 0.1, 0.5, 1, 2,
                   tenant_burns={'premium': 0.8, 'bg': 0.0})
    assert d.delta == +1 and 'premium' in d.reason


def test_policy_validates_bounds():
    with pytest.raises(ValueError, match='min_replicas'):
        AutoscalePolicy(slo_ttft_s=0.5, min_replicas=0)
    with pytest.raises(ValueError, match='min_replicas'):
        AutoscalePolicy(slo_ttft_s=0.5, min_replicas=4, max_replicas=2)


def test_autoscale_tick_grows_and_drains_pool(model):
    """Gateway integration on a fake clock: sustained burn builds a new
    replica from the factory; sustained idle drains the least-loaded
    one (never kills it)."""
    clock = {'t': 0.0}
    gw = _gw(model, replicas=1, clock=lambda: clock['t'],
             autoscaler=AutoscalePolicy(slo_ttft_s=0.5, sustain_s=2.0,
                                        cooldown_s=5.0, window_s=60.0,
                                        max_replicas=2))
    # synthetic TTFT samples breaching the SLO
    for t in (1.0, 2.0, 3.0):
        gw._ttfts.append((t, 2.0))
    clock['t'] = 4.0
    assert gw.autoscale_tick().delta == 0        # burn timer starts
    clock['t'] = 6.5
    d = gw.autoscale_tick()
    assert d.delta == +1
    assert len(gw.pool) == 2
    assert gw.pool[1].routable()                 # new replica takes work
    assert gw.registry.get('gateway_scale_events_total') \
        .labels('up').value() == 1.0
    assert _counter(gw, 'gateway_slo_burn_rate') == 1.0
    # burn clears, samples age out of the window -> sustained idle
    gw._ttfts.clear()
    clock['t'] = 20.0
    assert gw.autoscale_tick().delta == 0        # idle timer starts
    clock['t'] = 23.0
    d = gw.autoscale_tick()
    assert d.delta == -1
    assert gw.registry.get('gateway_scale_events_total') \
        .labels('down').value() == 1.0
    states = sorted(r.state for r in gw.pool)
    assert DRAINING in states                    # drained, not killed
    gw.run()                                     # runs dry -> stopped
    assert sorted(r.state for r in gw.pool)[-1] == STOPPED
    assert _gw(model, replicas=1).autoscale_tick().delta == 0


# ---- threaded soak ----------------------------------------------------


def test_threaded_concurrent_submitters(model, prompts, reference):
    """Several caller threads submit concurrently against driver
    threads; everything completes with exact parity, and the callers'
    grad mode (thread-local in torch) is left as it was."""
    gw = _gw(model, replicas=2).start()
    results = {}
    grad_modes = []
    try:
        def client(base):
            grad_modes.append(torch.is_grad_enabled())
            for j, p in enumerate(prompts[base::2]):
                r = gw.submit(p, max_new_tokens=MNT)
                assert r.wait(120)
                results[base + 2 * j] = r.tokens
            grad_modes.append(torch.is_grad_enabled())
        ts = [threading.Thread(target=client, args=(b,)) for b in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(180)
        assert not any(t.is_alive() for t in ts)
    finally:
        gw.shutdown()
    assert [results[i] for i in range(len(prompts))] == reference
    assert grad_modes == [True] * 4


# ---- QoS shedding through the gateway ---------------------------------


def test_qos_shedding_fake_clock(model, prompts):
    """A bg token bucket of 2 under a fake clock: bg's third and later
    arrivals in the same instant shed (rate), premium never does, and
    qos_rejected_total carries (reason, tenant) in sorted label order."""
    clock = {'t': 0.0}
    gw = _gw(model, replicas=2, clock=lambda: clock['t'],
             admission=QosPolicy(classes=[
                 TenantClass('premium', priority=1),
                 TenantClass('bg', rate=1.0, burst=2.0)]))
    hs = [gw.submit(p, max_new_tokens=MNT,
                    tenant='premium' if i % 2 == 0 else 'bg')
          for i, p in enumerate(prompts)]
    clock['t'] = 1.0
    late = gw.submit(prompts[1], max_new_tokens=MNT, tenant='bg')
    gw.run()
    shed = [h for h in hs if h.error is not None]
    assert len(shed) == 3 and late.error is None
    assert all(h.sampling['tenant'] == 'bg' for h in shed)
    assert gw.registry.get('qos_rejected_total').labelnames == \
        ('reason', 'tenant')
    assert _counter(gw, 'qos_rejected_total', ('rate', 'bg')) == 3
    assert _counter(gw, 'qos_admitted_total', ('premium',)) == 5
    assert _counter(gw, 'qos_admitted_total', ('bg',)) == 3
    text = texport.to_prometheus(gw.registry)
    assert 'qos_rejected_total{reason="rate",tenant="bg"} 3' in text
    assert gw.report()['rejected'] == 3


# ---- the port's gateway against the JAX gateway -----------------------


def _jax_gateway(jm, clock, admission):
    return JGateway(lambda: JSlotEngine(jm, num_slots=2, **ENGINE_KW),
                    replicas=2, registry=JRegistry(), clock=clock,
                    admission=admission)


def _policy(mod):
    return mod.QosPolicy(classes=[mod.TenantClass('premium', priority=1),
                                  mod.TenantClass('bg', rate=2.0,
                                                  burst=3.0)])


@pytest.mark.chaos
def test_gateway_matches_jax_gateway(pair, prompts):
    """The JAX gateway and the port's sync gateway on the same weights,
    prompts, partition step and fake clock (0.05 s a step): equal
    tokens, replica_history, failover_log and every sample of the
    gateway registries (gateway_*, qos_*, tenant_*)."""
    jm, tm = pair
    runs = {}
    for name, gw_of, part in (
            ('jax', lambda c: _jax_gateway(jm, c, _policy(jqos)),
             jchaos.partition),
            ('port', lambda c: _gw(tm, clock=c, replicas=2,
                                   admission=_policy(tqos)),
             chaos.partition)):
        clock = {'t': 0.0}
        gw = gw_of(lambda: clock['t'])

        def tick(k):
            clock['t'] = 0.05 * k
        reqs, expected, _ = _partition_drive(gw, prompts, part,
                                             len(prompts) // 2, tick)
        ids = {r.id: i for i, r in enumerate(reqs)}
        runs[name] = dict(
            tokens=[r.tokens for r in reqs],
            errors=[None if r.error is None else str(r.error)
                    for r in reqs],
            history=[r.replica_history for r in reqs],
            failovers=[r.failovers for r in reqs],
            expected=expected,
            failover_log=[dict(e, requests=[ids[i] for i in e['requests']])
                          for e in gw.failover_log],
            report=gw.report(),
            metrics=(jexport if name == 'jax' else texport).to_dict(
                gw.registry))
    jax_run, port_run = runs['jax'], runs['port']
    assert port_run['expected'] > 0
    assert any(e is not None for e in port_run['errors'])   # bg shed
    assert any(len(h) > 1 for h in port_run['history'])     # failed over
    for key in ('tokens', 'errors', 'history', 'failovers', 'expected',
                'failover_log', 'report'):
        assert port_run[key] == jax_run[key], key
    fams = sorted(n for n in jax_run['metrics']
                  if n.startswith(('gateway_', 'qos_', 'tenant_')))
    assert sorted(port_run['metrics']) == sorted(jax_run['metrics'])
    for name in fams:
        assert port_run['metrics'][name] == jax_run['metrics'][name], name


# ---- rollout without hosts; fleet not ported --------------------------


def test_rollout_and_attach_fleet_name_their_modules(model):
    # rollout() is ported (tests/test_torch_registry.py); over plain
    # engines, as the JAX gateway does, it refuses to run
    gw = _gw(model, replicas=1)
    with pytest.raises(ValueError, match='ModelHost-backed'):
        gw.rollout('m', 'v2')
    # attach_fleet registers each replica's registry with the collector
    from paddle_tpu_torch.monitor.federation import FleetCollector
    fc = FleetCollector(registry=MetricRegistry())
    assert gw.attach_fleet(fc) is fc
    (target,) = fc.targets()
    assert target.instance == 'gw-replica-0'
    assert target.registry is gw.pool[0].registry


# ---- trace replay -----------------------------------------------------


def test_replay_and_measure_through_started_gateway(model):
    """capacity.replay drives a started gateway open-loop from a Trace:
    every request completes with its token budget, the replay counters
    land on the given registry, and measure() hands back exactly the
    replay's wide events (warm-up excluded)."""
    from paddle_tpu_torch.capacity import WorkloadSpec, measure, replay
    spec = WorkloadSpec(requests=6, seed=0, vocab_size=211,
                        arrival={'process': 'poisson', 'mean_gap_s': 0.01},
                        lengths={'dist': 'ladder', 'lens': [3, 7, 11]},
                        output={'dist': 'fixed', 'len': 5},
                        tenants={'mode': 'round_robin', 'tenants': [
                            {'name': 'premium'}, {'name': 'bg'}]})
    trace = spec.generate()
    reg = MetricRegistry()
    gw = _gw(model, replicas=2).start()
    try:
        res = replay(gw, trace, speed=4.0, max_new_tokens=MNT, timeout=60,
                     registry=reg)
    finally:
        gw.shutdown()
    assert res.requests == res.completed == len(trace)
    assert res.completed_ratio == 1.0
    assert res.tokens == MNT * len(trace) and res.tokens_per_sec > 0
    assert [h.sampling['tenant'] for h in res.handles] == trace.tenants()
    assert reg.get('capacity_requests_replayed_total').value() == 6
    assert reg.get('capacity_replay_runs_total').value() == 1
    assert set(res.to_dict()) >= {'requests', 'completed', 'wall_s',
                                  'tokens_per_sec', 'max_lag_s'}
    with pytest.raises(ValueError, match='speed'):
        replay(gw, trace, speed=0)

    events, res = measure(_slot_factory(model), trace, replicas=2,
                          speed=4.0, timeout=60,
                          registry=MetricRegistry())
    assert res.completed == len(trace)
    assert len(events) == len(trace)
    assert all(e['tenant'] in ('premium', 'bg') and e['outcome'] == 'ok'
               for e in events)
    assert sorted(e['output_tokens'] for e in events) == [5] * 6


def test_threaded_stress_keeps_counters_exact(model, prompts, reference):
    """More submitter threads than cores against two driver threads, the
    interpreter switching threads every 10 us: every request completes
    with its exact tokens and the gateway's shared counters lose no
    update."""
    import os
    import sys
    n_threads = (os.cpu_count() or 4) + 2
    gw = _gw(model, replicas=2,
             admission=QosPolicy(classes=[TenantClass('t', priority=1)]))
    gw.start()
    results, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(k):
            try:
                i = k % len(prompts)
                r = gw.submit(prompts[i], max_new_tokens=MNT, tenant='t')
                assert r.wait(120)
                results[k] = (i, r.tokens)
            except Exception as exc:       # noqa: BLE001 — reported below
                errors.append(exc)
        ts = [threading.Thread(target=client, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(180)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        gw.shutdown()
    assert not errors, errors
    assert len(results) == n_threads
    assert all(tokens == reference[i] for i, tokens in results.values())
    assert _counter(gw, 'gateway_requests_completed_total') == n_threads
    assert _counter(gw, 'gateway_tokens_total') == n_threads * MNT
    assert _counter(gw, 'qos_admitted_total', ('t',)) == n_threads
    assert _counter(gw, 'tenant_requests_total', ('t',)) == n_threads
    assert gw.admission.inflight('t') == 0


SLICE5_MODULES = ('capacity', 'capacity.qos', 'capacity.workload',
                  'capacity.replay', 'monitor.export', 'monitor.server',
                  'distributed', 'distributed.resilience', 'testing',
                  'testing.chaos', 'serving.fabric',
                  'serving.fabric.transport', 'serving.gateway',
                  'serving.gateway.admission', 'serving.gateway.router',
                  'serving.gateway.autoscaler', 'serving.gateway.replica',
                  'serving.gateway.gateway')


def test_slice5_modules_import_neither_jax_nor_paddle_tpu():
    """Each module of the gateway slice imports in a fresh interpreter
    without loading jax or any paddle_tpu module (importing any
    paddle_tpu submodule would run paddle_tpu/__init__.py and load jax);
    tests/test_torch_gpt.py's walk and AST scan cover the whole port."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ('import importlib, sys\n'
            'for m in %r:\n'
            '    importlib.import_module("paddle_tpu_torch." + m)\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "paddle_tpu"))\n'
            'assert not bad, bad\n' % (SLICE5_MODULES,))
    res = subprocess.run([sys.executable, '-c', code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for mod in SLICE5_MODULES:
        path = os.path.join(repo, 'paddle_tpu_torch', *mod.split('.'))
        assert os.path.exists(path + '.py') or \
            os.path.exists(os.path.join(path, '__init__.py')), mod
