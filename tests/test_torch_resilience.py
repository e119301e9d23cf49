"""The port's resilience layer (paddle_tpu_torch/distributed/resilience.py)
and chaos injectors (paddle_tpu_torch/testing/chaos.py) against the JAX
package's, on the CPU.

- CircuitBreaker walks the JAX breaker's state sequence under the same
  fake clock and failure stream, with the same rpc_breaker_* samples.
- RetryPolicy classifies and backs off as the JAX policy does; Deadline
  clamps and expires on the same clock.
- The chaos injectors fire at their hook points with exact counts, and
  scope to their endpoint and points.
"""
import errno
import random
import socket
import time

import numpy as np
import pytest

from paddle_tpu.distributed import resilience as jres
from paddle_tpu.monitor import default_registry as jdefault_registry
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.monitor import default_registry as tdefault_registry
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.testing import chaos


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """time.monotonic replaced for both packages (each module reads it
    through the shared `time` module)."""
    c = FakeClock()
    monkeypatch.setattr(time, 'monotonic', c)
    return c


def _breaker_samples(reg, name):
    trans = reg.get('rpc_breaker_transitions_total')
    out = {to: trans.labels(name, to).value()
           for to in ('closed', 'open', 'half_open')}
    out['state'] = reg.get('rpc_breaker_state').labels(name).value()
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_circuit_breaker_walks_jax_states(clock, seed):
    name = 'inproc://breaker-parity-%d' % seed
    jb = jres.CircuitBreaker(failure_threshold=3, reset_timeout=2.0,
                             name=name)
    tb = tres.CircuitBreaker(failure_threshold=3, reset_timeout=2.0,
                             name=name)
    rng = np.random.RandomState(seed)
    seen = set()
    for _ in range(400):
        clock.t += float(rng.choice([0.0, 0.1, 0.7, 2.5]))
        op = rng.choice(['allow', 'success', 'failure'], p=[0.5, 0.2, 0.3])
        if op == 'allow':
            got, want = tb.allow(), jb.allow()
        elif op == 'success':
            got, want = tb.record_success(), jb.record_success()
        else:
            got, want = tb.record_failure(), jb.record_failure()
        assert got == want, op
        assert tb.state == jb.state
        seen.add(tb.state)
    assert seen == {'closed', 'open', 'half_open'}
    assert _breaker_samples(tdefault_registry(), name) == \
        _breaker_samples(jdefault_registry(), name)


def test_breaker_half_open_admits_one_probe(clock):
    b = tres.CircuitBreaker(failure_threshold=1, reset_timeout=1.0)
    assert b.record_failure() is True        # the opening edge
    assert b.record_failure() is False       # already open
    assert b.state == b.OPEN and not b.allow()
    clock.t += 1.0
    assert b.state == b.HALF_OPEN
    assert b.allow() and not b.allow()       # one probe only
    b.record_success()
    assert b.state == b.CLOSED and b.allow()
    # unnamed breakers stay off the metric families
    assert b.name is None


def test_retry_policy_matches_jax():
    kw = dict(max_attempts=5, base_delay=0.05, max_delay=0.3,
              multiplier=3.0, jitter=0.5)
    jp, tp = jres.RetryPolicy(**kw), tres.RetryPolicy(**kw)
    excs = [socket.timeout(), TimeoutError(), ConnectionResetError(),
            BrokenPipeError(), EOFError(), OSError(errno.ECONNREFUSED, 'x'),
            OSError(errno.EACCES, 'x'), OSError('no errno'), ValueError(),
            RuntimeError(), KeyError()]
    assert [tp.is_retryable(e) for e in excs] == \
        [jp.is_retryable(e) for e in excs]
    assert tp.is_retryable(ConnectionResetError())
    assert not tp.is_retryable(ValueError())
    for attempt in range(1, 7):
        random.seed(attempt)
        want = jp.backoff(attempt)
        random.seed(attempt)
        assert tp.backoff(attempt) == want
    extra = tres.RetryPolicy(retryable_exceptions=(KeyError,))
    assert extra.is_retryable(KeyError())
    with pytest.raises(ValueError, match='max_attempts'):
        tres.RetryPolicy(max_attempts=0)


def test_deadline_clamps_and_expires(clock):
    d = tres.Deadline.after(2.0)
    assert d.remaining() == 2.0 and not d.expired()
    assert d.clamp(5.0) == 2.0 and d.clamp(0.5) == 0.5
    assert d.clamp(None) == 2.0
    clock.t += 2.0
    assert d.expired()
    with pytest.raises(tres.DeadlineExceeded, match='deadline'):
        d.clamp(1.0)


def test_error_taxonomy_matches_jax():
    names = ('RpcError', 'RetryableError', 'DeadlineExceeded',
             'CircuitOpenError', 'FrameError', 'FrameTooLargeError',
             'FrameDecodeError')
    for a in names:
        for b in names:
            assert issubclass(getattr(tres, a), getattr(tres, b)) == \
                issubclass(getattr(jres, a), getattr(jres, b)), (a, b)
    e = tres.CircuitOpenError('open', endpoint='ep', attempts=3)
    assert (e.endpoint, e.attempts) == ('ep', 3)
    assert not issubclass(tres.FrameError, tres.RetryableError)


# ---- chaos injectors ----------------------------------------------------


def _fire(point, endpoint):
    """1 if the hook point raised a ConnectionError, else 0."""
    try:
        tres.fire_fault_points(point, endpoint)
    except ConnectionError:
        return 1
    return 0


def test_drop_connections_fires_exact_count():
    with chaos.drop_connections(endpoint='ep-a', point='send',
                                times=3) as fault:
        drops = sum(_fire('send', 'inproc://ep-a') for _ in range(10))
        assert _fire('recv', 'inproc://ep-a') == 0     # other point
        assert _fire('send', 'inproc://ep-b') == 0     # other endpoint
        assert chaos.active_faults() == 1
    assert drops == 3 and fault.fired == 3
    assert chaos.active_faults() == 0
    assert _fire('send', 'inproc://ep-a') == 0         # uninstalled


def test_partition_black_holes_send_and_recv_only():
    with chaos.partition('gw-replica-1') as fault:
        assert _fire('send', 'inproc://gw-replica-1') == 1
        assert _fire('recv', 'inproc://gw-replica-1') == 1
        assert _fire('connect', 'inproc://gw-replica-1') == 0
        assert _fire('send', 'inproc://gw-replica-0') == 0
    assert fault.fired == 2
    with chaos.partition('gw-replica-1', times=1) as fault:
        assert [_fire('send', 'inproc://gw-replica-1')
                for _ in range(3)] == [1, 0, 0]
    assert fault.fired == 1 and chaos.active_faults() == 0


def test_fail_after_and_nested_faults():
    with chaos.fail_after(2, endpoint='ep', point='send'):
        with chaos.drop_connections(endpoint='ep', point='recv',
                                    times=1) as inner:
            got = [_fire('send', 'ep') for _ in range(4)]
            assert _fire('recv', 'ep') == 1 and _fire('recv', 'ep') == 0
            assert chaos.active_faults() == 2
    assert got == [0, 0, 1, 1] and inner.fired == 1
    assert chaos.active_faults() == 0


def test_delay_connections_and_raw_inject(monkeypatch):
    slept = []
    monkeypatch.setattr(time, 'sleep', slept.append)
    with chaos.delay_connections(0.25, endpoint='ep', times=2) as fault:
        for _ in range(3):
            tres.fire_fault_points('connect', 'ep')
        tres.fire_fault_points('send', 'ep')
    assert slept == [0.25, 0.25] and fault.fired == 2
    calls = []
    with chaos.inject(lambda p, ep: calls.append((p, ep))):
        tres.fire_fault_points('recv', 'x')
    tres.fire_fault_points('recv', 'y')
    assert calls == [('recv', 'x')]


def test_fault_annotates_the_current_span():
    tracer = ttracing.Tracer(registry=MetricRegistry())
    prev = ttracing.set_default_tracer(tracer)
    try:
        with chaos.partition('ep'):
            with tracer.start_span('attempt') as span:
                assert ttracing.current_span() is span
                assert _fire('send', 'ep') == 1
        assert ttracing.current_span() is None
    finally:
        ttracing.set_default_tracer(prev)
    (done,) = tracer.spans()
    assert [(e['name'], e['args']) for e in done['events']] == [
        ('chaos.fault', {'point': 'send', 'endpoint': 'ep'})]
