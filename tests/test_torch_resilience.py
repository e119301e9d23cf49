"""The port's resilience layer (paddle_tpu_torch/distributed/resilience.py)
and chaos injectors (paddle_tpu_torch/testing/chaos.py) against the JAX
package's, on the CPU.

- CircuitBreaker walks the JAX breaker's state sequence under the same
  fake clock and failure stream, with the same rpc_breaker_* samples.
- RetryPolicy classifies and backs off as the JAX policy does; Deadline
  clamps and expires on the same clock.
- The chaos injectors fire at their hook points with exact counts, and
  scope to their endpoint and points.
- ResilientChannel and call_once walk the JAX channel's retry, deadline
  and breaker sequence against one loopback server under the same chaos
  hooks, with the same outcomes and rpc_* samples; the attempt spans'
  context reaches the server's handler span (TRACE_KEY, server_span).
- kill_server, crash_io_save and truncate_file (the rest of chaos.py) are
  covered with the fabric's servers and io_save in test_torch_fabric.py
  and test_torch_io_save.py.
"""
import errno
import random
import socket
import socketserver
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import resilience as jres
from paddle_tpu.monitor import default_registry as jdefault_registry
from paddle_tpu.serving.fabric import protocol as jprotocol
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.monitor import default_registry as tdefault_registry
from paddle_tpu_torch.monitor import tracing as ttracing
from paddle_tpu_torch.monitor.registry import MetricRegistry
from paddle_tpu_torch.serving.fabric import protocol as tprotocol
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
    (done,) = tracer.recorder.spans()
    assert [(e['name'], e['args']) for e in done['events']] == [
        ('chaos.fault', {'point': 'send', 'endpoint': 'ep'})]


# ---- the channel against one loopback server ----------------------------


class _EchoHandler(socketserver.BaseRequestHandler):
    """Answers each frame in the codec it came in: the fabric's JSON
    (a payload starting with '{') or the PS wire format (call_once's)."""

    def handle(self):
        from paddle_tpu_torch.distributed.ps import wire
        while True:
            try:
                hdr = self.request.recv(8, socket.MSG_WAITALL)
                if len(hdr) < 8:
                    return
                n = int.from_bytes(hdr, 'big')
                buf = self.request.recv(n, socket.MSG_WAITALL)
            except (ConnectionError, OSError):
                return
            codec = tprotocol.JSON_CODEC if buf[:1] == b'{' \
                else (wire.encode, wire.decode)
            msg = codec[1](buf)
            traced = ttracing.TRACE_KEY in msg
            with self.server.tracer.server_span(msg, 'echo'):
                tres._send_frame(self.request, {
                    'ok': True, 'n': msg.get('n'), 'traced': traced,
                    'clean': ttracing.TRACE_KEY not in msg}, codec)


class _EchoServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


@pytest.fixture
def echo_server():
    srv = _EchoServer(('127.0.0.1', 0), _EchoHandler)
    srv.tracer = ttracing.Tracer(registry=MetricRegistry())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, '127.0.0.1:%d' % srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _channel_walk(res, chaos_mod, codec, registry, endpoint):
    """One scripted walk of a channel: clean call, retried drops, a
    non-idempotent drop, a refused oversized frame, an expired deadline,
    failures up to an open breaker, and call_once. Returns each step's
    outcome and the endpoint's rpc_* samples after it."""
    policy = res.RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0)
    ch = res.ResilientChannel(
        endpoint, retry_policy=policy, codec=codec, max_frame=4096,
        breaker=res.CircuitBreaker(failure_threshold=4, reset_timeout=60.0))
    names = ('rpc_attempts_total', 'rpc_attempt_failures_total',
             'rpc_backoff_seconds_total', 'rpc_deadline_expired_total',
             'rpc_circuit_open_total')
    out = []

    def step(label, fn):
        try:
            got = fn()
            got = (got['ok'], got['n'], got['clean'])
        except Exception as e:     # noqa: BLE001 — the type is the result
            got = type(e).__name__
        out.append((label, got, ch.breaker.state,
                    [round(registry.get(n).labels(endpoint).value(), 6)
                     for n in names]))

    step('clean', lambda: ch.call({'op': 'echo', 'n': 1}))
    with chaos_mod.drop_connections(endpoint=endpoint, point='send',
                                    times=2):
        step('two drops', lambda: ch.call({'op': 'echo', 'n': 2}))
    with chaos_mod.drop_connections(endpoint=endpoint, point='recv',
                                    times=1):
        step('non-idempotent', lambda: ch.call({'op': 'echo', 'n': 3},
                                               idempotent=False))
    step('oversized', lambda: ch.call({'op': 'echo', 'blob': 'x' * 5000}))
    step('expired', lambda: ch.call({'op': 'echo', 'n': 4},
                                    deadline=res.Deadline(-1.0)))
    with chaos_mod.drop_connections(endpoint=endpoint, point='connect'):
        step('all dropped', lambda: ch.call({'op': 'echo', 'n': 5}))
        step('breaker open', lambda: ch.call({'op': 'echo', 'n': 6}))
    ch.close()
    try:
        once = res.call_once(endpoint, {'op': 'echo', 'n': 7})
        out.append(('call_once', once['n'], once['clean']))
    except Exception as e:         # noqa: BLE001
        out.append(('call_once', type(e).__name__))
    return out


def test_resilient_channel_walk_matches_jax(echo_server):
    _, endpoint = echo_server
    from paddle_tpu.distributed import resilience as jres_
    jwalk = _channel_walk(jres_, jchaos, jprotocol.JSON_CODEC,
                          jdefault_registry(), endpoint)
    twalk = _channel_walk(tres, chaos, tprotocol.JSON_CODEC,
                          tdefault_registry(), endpoint)
    assert twalk == jwalk
    outcomes = [x[1] for x in twalk]
    assert outcomes[:3] == [(True, 1, True), (True, 2, True),
                            'RetryableError']
    assert outcomes[3:7] == ['FrameTooLargeError', 'DeadlineExceeded',
                             'RetryableError', 'CircuitOpenError']
    assert twalk[-1] == ('call_once', 7, True)
    assert chaos.active_faults() == 0


def test_channel_attempt_spans_reach_the_server_span(echo_server):
    srv, endpoint = echo_server
    tracer = ttracing.Tracer(registry=MetricRegistry())
    prev = ttracing.set_default_tracer(tracer)
    try:
        ch = tres.ResilientChannel(
            endpoint, codec=tprotocol.JSON_CODEC,
            retry_policy=tres.RetryPolicy(max_attempts=4, base_delay=0.001,
                                          jitter=0))
        with chaos.drop_connections(endpoint=endpoint, point='send',
                                    times=2):
            reply = ch.call({'op': 'pull', 'n': 9})
        ch.close()
    finally:
        ttracing.set_default_tracer(prev)
    assert reply == {'ok': True, 'n': 9, 'traced': True, 'clean': True}
    spans = tracer.recorder.spans()
    (call,) = [sp for sp in spans if sp['name'] == 'rpc.call']
    attempts = [sp for sp in spans if sp['name'] == 'rpc.attempt']
    assert len(attempts) == 3
    assert all(a['parent_id'] == call['span_id'] and
               a['trace_id'] == call['trace_id'] for a in attempts)
    assert [a['status'] for a in attempts] == ['error', 'error', 'ok']
    deadline = time.monotonic() + 5
    while not srv.tracer.recorder.spans() and time.monotonic() < deadline:
        time.sleep(0.01)
    (handler,) = srv.tracer.recorder.spans()
    assert handler['name'] == 'echo.pull'
    assert handler['trace_id'] == call['trace_id']
    assert handler['parent_id'] == attempts[-1]['span_id']
