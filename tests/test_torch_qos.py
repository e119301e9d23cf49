"""The port's QoS admission policy (paddle_tpu_torch/capacity/qos.py) and
the gateway's enforcement of it, on the CPU.

The policy is a plain copy of the JAX package's, so the two are held to
exact equality: the same seeded stream of admission and finish calls
gives the same decisions, reject reasons, bucket levels and in-flight
counts, and `to_dict` / `from_dict` read each other's output. The gateway
cases are the JAX package's (tests/test_qos.py) that need no simulator,
driven through the port's gateway with a fake clock.
"""
import numpy as np
import pytest

from paddle_tpu.capacity import qos as jqos
from paddle_tpu_torch.capacity import qos as tqos
from paddle_tpu_torch.capacity.qos import (REJECT_REASONS, QosPolicy,
                                           TenantClass, TokenBucket)
from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving import ContinuousBatchingEngine, ServingGateway
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

MNT = 8


@pytest.fixture(scope='module')
def model():
    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=128, dropout=0.0)
    return GPTForCausalLM(cfg, device='cpu', seed=7).eval()


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(0, 211, n)]
            for n in (5, 9, 7, 12, 4, 11, 6, 8)]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _capture_log():
    """Fresh RequestLog installed as default; caller must restore."""
    log = _events.RequestLog(capacity=256, registry=MetricRegistry())
    prev = _events.set_default_request_log(log)
    return log, prev


def _events_for(log, req_id):
    return [e for e in log.events() if e['request_id'] == req_id]


# ---- the policy against the JAX package's -----------------------------


POLICIES = {
    'rate_quota': dict(classes=[
        dict(name='premium', priority=1),
        dict(name='bg', rate=30.0, burst=8.0, priority=0),
        dict(name='capped', rate=5.0, max_concurrent=2)]),
    'default_limited': dict(
        classes=[dict(name='gold', max_concurrent=3, priority=2)],
        default=dict(name='default', rate=2.5), max_pending=4,
        max_queue_wait_s=0.25),
}


def _build(mod, spec):
    return mod.QosPolicy(
        classes=[mod.TenantClass(**c) for c in spec['classes']],
        default=(mod.TenantClass(**spec['default'])
                 if 'default' in spec else None),
        max_pending=spec.get('max_pending'),
        max_queue_wait_s=spec.get('max_queue_wait_s'))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('name', sorted(POLICIES))
def test_admission_stream_matches_jax(name, seed):
    """A seeded stream of (now, tenant) admissions with finishes mixed
    in: every decision, reason, bucket level and in-flight count is the
    JAX policy's."""
    jp, tp = _build(jqos, POLICIES[name]), _build(tqos, POLICIES[name])
    rng = np.random.RandomState(seed)
    tenants = ['premium', 'bg', 'capped', 'gold', 'other', None]
    now = 0.0
    held = []
    reasons = set()
    for _ in range(600):
        now += float(rng.exponential(0.02))
        if held and rng.rand() < 0.35:
            t = held.pop(int(rng.randint(len(held))))
            jp.finish(t)
            tp.finish(t)
            continue
        t = tenants[rng.randint(len(tenants))]
        got, want = tp.admit(now, t), jp.admit(now, t)
        assert got == want, (now, t)
        if got[0]:
            held.append(t)
        else:
            reasons.add(got[1])
        assert tp.inflight(t) == jp.inflight(t)
        assert tp.bucket_level(t, now) == jp.bucket_level(t, now)
        assert tp.priority_of(t) == jp.priority_of(t)
    assert reasons and reasons <= set(REJECT_REASONS)


@pytest.mark.parametrize('name', sorted(POLICIES))
def test_policy_dict_matches_jax(name):
    jp, tp = _build(jqos, POLICIES[name]), _build(tqos, POLICIES[name])
    assert tp.to_dict() == jp.to_dict()
    # each package reads the other's dict back to the same policy
    assert jqos.QosPolicy.from_dict(tp.to_dict()).to_dict() == jp.to_dict()
    assert QosPolicy.from_dict(jp.to_dict()).to_dict() == tp.to_dict()
    assert tuple(REJECT_REASONS) == tuple(jqos.REJECT_REASONS)


# ---- pure policy units (fake clock), as the JAX package's -------------


def test_token_bucket_fake_clock():
    b = TokenBucket(rate=2.0, burst=4.0)
    assert all(b.take(0.0) for _ in range(4))
    assert not b.take(0.0)             # empty; reject leaves level alone
    assert b.level(0.0) == pytest.approx(0.0)
    assert b.take(0.5)                 # 0.5s * 2/s == 1 token refilled
    assert not b.take(0.5)
    assert b.level(10.0) == pytest.approx(4.0)   # capped at burst
    with pytest.raises(ValueError, match='rate'):
        TokenBucket(rate=0.0, burst=1.0)
    with pytest.raises(ValueError, match='burst'):
        TokenBucket(rate=1.0, burst=0.0)


def test_policy_quota_checked_before_rate():
    pol = QosPolicy(classes=[
        TenantClass('bg', rate=100.0, burst=1.0, max_concurrent=1)])
    ok, reason = pol.admit(0.0, 'bg')
    assert ok and reason is None
    # in-flight cap hit: quota rejection must NOT spend a bucket token
    lvl = pol.bucket_level('bg', 0.0)
    ok, reason = pol.admit(0.0, 'bg')
    assert (ok, reason) == (False, 'quota')
    assert pol.bucket_level('bg', 0.0) == pytest.approx(lvl)
    pol.finish('bg')
    assert pol.inflight('bg') == 0
    ok, reason = pol.admit(0.0, 'bg')  # slot free again, bucket empty
    assert (ok, reason) == (False, 'rate')
    assert reason in REJECT_REASONS


def test_policy_roundtrip_and_priorities():
    pol = QosPolicy(
        classes=[TenantClass('premium', priority=2),
                 TenantClass('bg', rate=5.0, burst=8.0,
                             max_concurrent=3)],
        max_pending=16, max_queue_wait_s=1.5)
    clone = QosPolicy.from_dict(pol.to_dict())
    assert clone.to_dict() == pol.to_dict()
    assert clone.priority_of('premium') == 2
    assert clone.priority_of('bg') == 0
    assert clone.priority_of('unknown') == 0      # default class
    assert clone.max_pending == 16
    assert clone.max_queue_wait_s == pytest.approx(1.5)
    # fresh state: the clone starts with a full bucket
    assert clone.bucket_level('bg', 0.0) == pytest.approx(8.0)
    # burst defaults to one second of rate (at least 1)
    assert TenantClass('x', rate=2.5).burst == 3.0
    assert TenantClass('y', rate=0.2).burst == 1.0


# ---- gateway admission ------------------------------------------------


def _slot_factory(model):
    return lambda: ContinuousBatchingEngine(
        model, num_slots=2, max_len=32, prefill_chunk=8, decode_block=2)


def test_gateway_rate_and_quota_rejections(model, prompts):
    log, prev = _capture_log()
    try:
        clock = FakeClock()
        gw = ServingGateway(
            _slot_factory(model), replicas=1, clock=clock,
            registry=MetricRegistry(),
            admission=QosPolicy(classes=[
                TenantClass('premium', priority=1),
                TenantClass('bg', rate=1.0, burst=1.0),
                TenantClass('q', max_concurrent=1)]))
        ok_h = gw.submit(prompts[0], max_new_tokens=MNT, tenant='bg')
        shed = gw.submit(prompts[1], max_new_tokens=MNT, tenant='bg')
        q1 = gw.submit(prompts[2], max_new_tokens=MNT, tenant='q')
        q2 = gw.submit(prompts[3], max_new_tokens=MNT, tenant='q')
        prem = gw.submit(prompts[4], max_new_tokens=MNT, tenant='premium')

        # bucket empty at the same instant: shed, instantly final
        assert shed.done and 'rate' in str(shed.error)
        assert not shed.tokens
        # concurrency quota: q2 shed while q1 is in flight
        assert q2.done and 'quota' in str(q2.error)
        assert not ok_h.done and not q1.done and not prem.done

        gw.run()
        assert ok_h.done and ok_h.error is None and len(ok_h.tokens) == MNT
        assert q1.error is None and prem.error is None

        rep = gw.report()
        assert rep['rejected'] == 2
        # shed requests never became engine traffic
        assert rep['requests'] == 3 and rep['completed'] == 3
        reg = gw.registry
        assert reg.get('qos_rejected_total').labels('rate', 'bg') \
                  .value() == 1
        assert reg.get('qos_rejected_total').labels('quota', 'q') \
                  .value() == 1
        assert reg.get('qos_admitted_total').labels('premium').value() == 1
        assert reg.get('qos_token_bucket_level').labels('bg').value() == 0

        # exactly one wide event per request, correct outcome + priority
        for h, outcome in ((ok_h, 'ok'), (shed, 'rejected'),
                           (q1, 'ok'), (q2, 'rejected'), (prem, 'ok')):
            evs = _events_for(log, h.id)
            assert len(evs) == 1, (h.id, evs)
            assert evs[0]['outcome'] == outcome
        assert _events_for(log, prem.id)[0]['priority'] == 1
        assert _events_for(log, shed.id)[0]['first_token_t'] is None
        # admission slots all released: the policy holds no in-flight
        for t in ('bg', 'q', 'premium'):
            assert gw.admission.inflight(t) == 0
    finally:
        _events.set_default_request_log(prev)


def test_gateway_bounded_queue_and_deadline_shed(model, prompts):
    log, prev = _capture_log()
    try:
        clock = FakeClock()
        gw = ServingGateway(
            _slot_factory(model), replicas=1, clock=clock,
            registry=MetricRegistry(),
            admission=QosPolicy(
                classes=[TenantClass('hi', priority=1),
                         TenantClass('lo', priority=0)],
                max_pending=1, max_queue_wait_s=0.5))
        gw.kill_replica(0)       # nothing routable: everything parks
        lo1 = gw.submit(prompts[0], max_new_tokens=MNT, tenant='lo')
        assert not lo1.done      # parked
        # same class at capacity: the NEWCOMER sheds (queue_full)
        lo2 = gw.submit(prompts[1], max_new_tokens=MNT, tenant='lo')
        assert lo2.done and 'queue_full' in str(lo2.error)
        # higher class at capacity: the parked low request is the victim
        hi = gw.submit(prompts[2], max_new_tokens=MNT, tenant='hi')
        assert lo1.done and 'queue_full' in str(lo1.error)
        assert not hi.done
        # parked past the deadline: shed on the next drain
        clock.t = 1.0
        assert gw.step() == 0
        assert hi.done and 'deadline' in str(hi.error)
        for h in (lo1, lo2, hi):
            evs = _events_for(log, h.id)
            assert len(evs) == 1 and evs[0]['outcome'] == 'rejected'
        assert gw.report()['rejected'] == 3
        assert gw.registry.get('qos_rejected_total').labels(
            'queue_full', 'lo').value() == 2
    finally:
        _events.set_default_request_log(prev)


def test_gateway_fifo_within_priority_class(model, prompts):
    """Parked work drains best-class-first, FIFO inside a class."""
    gw = ServingGateway(
        _slot_factory(model), replicas=1, registry=MetricRegistry(),
        admission=QosPolicy(classes=[TenantClass('hi', priority=1),
                                     TenantClass('lo', priority=0)]))
    gw.kill_replica(0)
    handles = [gw.submit(prompts[i], max_new_tokens=MNT, tenant=t)
               for i, t in enumerate(('lo', 'lo', 'hi', 'lo', 'hi'))]
    with gw._lock:
        gw._add_replica_locked()     # capacity returns; next step drains
    while gw.step():
        pass
    for h in handles:
        assert h.error is None and len(h.tokens) == MNT
    # admission order onto the replica == drain order
    order = sorted(range(5), key=lambda i: handles[i]._eng_req._admit_t)
    assert order == [2, 4, 0, 1, 3]


def test_engine_priority_admission_fifo_within_class(model, prompts):
    eng = ContinuousBatchingEngine(model, num_slots=1, max_len=32,
                                   prefill_chunk=8, decode_block=2)
    reqs = [eng.add_request(prompts[i], max_new_tokens=4, priority=p)
            for i, p in enumerate((0, 0, 1, 0))]
    while eng.scheduler.pending:
        eng.step()
    order = sorted(range(4), key=lambda i: reqs[i]._admit_t)
    assert order == [2, 0, 1, 3]


def test_kill_replica_mid_burst_with_active_shedding(model, prompts):
    """A replica dies while the admission layer is actively shedding:
    failover victims are re-placed and complete (outcome 'ok', counted
    once), shed requests stay shed (outcome 'rejected', counted once) —
    the two outcomes never double-count a request."""
    log, prev = _capture_log()
    try:
        gw = ServingGateway(
            _slot_factory(model), replicas=2, registry=MetricRegistry(),
            admission=QosPolicy(classes=[
                TenantClass('premium', priority=1),
                TenantClass('bg', rate=1.0, burst=2.0)]))
        handles = []
        for i, p in enumerate(prompts):
            handles.append(gw.submit(
                p, max_new_tokens=MNT,
                tenant='premium' if i % 2 == 0 else 'bg'))
        gw.step()
        gw.kill_replica(0)
        while gw.step():
            pass
        shed = [h for h in handles if h.error is not None]
        done_ok = [h for h in handles if h.error is None]
        assert len(shed) == 2      # bg burst 2.0 admits 2 of 4
        assert all('rejected: rate' in str(h.error) for h in shed)
        assert all(h.failovers == 0 for h in shed)
        assert all(len(h.tokens) == MNT for h in done_ok)
        assert any(h.failovers for h in done_ok)   # the kill was real
        rep = gw.report()
        assert rep['rejected'] == len(shed)
        assert rep['completed'] == len(done_ok)
        # one event per request; outcomes partition the burst exactly
        outcomes = {}
        for h in handles:
            evs = _events_for(log, h.id)
            assert len(evs) == 1
            outcomes[h.id] = evs[0]['outcome']
        assert sum(1 for o in outcomes.values() if o == 'rejected') \
            == len(shed)
        assert sum(1 for o in outcomes.values() if o == 'ok') \
            == len(done_ok)
    finally:
        _events.set_default_request_log(prev)
