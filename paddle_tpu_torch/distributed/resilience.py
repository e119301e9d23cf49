"""Shared RPC resilience layer (counterpart of
paddle_tpu/distributed/resilience.py).

- ``RetryPolicy``: exponential backoff with jitter, a max-attempt cap,
  and retryable-exception classification (connection resets / timeouts
  retry; protocol and application errors never do).
- ``Deadline``: an absolute wall-clock budget shared across every
  attempt of a call (and across a multi-shard fan-out) — retries must
  tighten, never extend, the caller's wait.
- ``CircuitBreaker``: a half-open breaker per endpoint, with its
  transitions and state on the ``rpc_*`` metric families of the port's
  default registry. The gateway's replicas each hold one.
- ``ResilientChannel``: one endpoint's framed-message connection with
  socket timeouts, transparent reconnect-and-retry for idempotent ops,
  and the breaker, so a dead peer fails fast instead of burning a full
  backoff ladder per call; ``call_once`` is its one-shot form. The
  serving fabric's socket replicas and artifact client ride it.
- the frame functions (8-byte big-endian length + payload) with a
  pluggable codec: the parameter server's wire format
  (distributed/ps/wire.py) by default, the fabric's JSON codec when
  passed.
- the error taxonomy (``RpcError`` and its subclasses).

With tracing on, a call runs under an ``rpc.call`` span with one
``rpc.attempt`` child per wire attempt, whose context rides the message
under ``tracing.TRACE_KEY``. A deadline that expires and a breaker that
opens each request a throttled flight dump of the tracer's ring
(``maybe_dump('deadline_expired')`` / ``maybe_dump('circuit_open')``).

Fault injection for tests rides through ``_fire()``: the hooks list is
empty (zero cost) until paddle_tpu_torch.testing.chaos installs
injectors. Channels fire 'connect', 'send' and 'recv'; the gateway's
in-proc replicas fire 'send' and 'recv' around every submission and
engine step (``fire_fault_points``).
"""
import errno
import random
import socket
import struct
import threading
import time

from ..monitor import default_registry as _monitor_registry
from ..monitor import tracing as _tracing
from ..monitor.telemetry import record_rpc_schema as _record_rpc_schema

__all__ = ['RetryPolicy', 'Deadline', 'CircuitBreaker', 'ResilientChannel',
           'RpcError', 'RetryableError', 'DeadlineExceeded',
           'CircuitOpenError', 'FrameError', 'FrameTooLargeError',
           'FrameDecodeError', 'fire_fault_points', 'call_once',
           'DEFAULT_CALL_TIMEOUT', 'DEFAULT_CONNECT_TIMEOUT']

DEFAULT_CALL_TIMEOUT = 30.0      # per-attempt send+recv budget (seconds)
DEFAULT_CONNECT_TIMEOUT = 5.0


# -- observability (paddle_tpu_torch/monitor) -------------------------------
# Families bind once at import via the single-source schema table
# (monitor/telemetry.py RPC_FAMILIES); channels and breakers cache their
# labeled children at construction, so the per-event cost is one
# enabled-flag check (and nothing at all for events that don't happen).
_FAMS = _record_rpc_schema(_monitor_registry())
_M_ATTEMPTS = _FAMS['rpc_attempts_total']
_M_FAILURES = _FAMS['rpc_attempt_failures_total']
_M_BACKOFF = _FAMS['rpc_backoff_seconds_total']
_M_DEADLINE = _FAMS['rpc_deadline_expired_total']
_M_CIRCUIT_REJECT = _FAMS['rpc_circuit_open_total']
_M_TRANSITIONS = _FAMS['rpc_breaker_transitions_total']
_M_BREAKER_STATE = _FAMS['rpc_breaker_state']
_STATE_CODES = {'closed': 0, 'open': 1, 'half_open': 2}


# -- fault-injection hook points (see testing/chaos.py) ---------------------
# Each hook is `fn(point, endpoint)` where point is one of 'connect',
# 'send', 'recv'. Hooks may sleep (delay faults) or raise (drop faults).
_FAULT_HOOKS = []


def _fire(point, endpoint):
    for hook in list(_FAULT_HOOKS):
        hook(point, endpoint)


def fire_fault_points(point, endpoint):
    """Public hook-point trigger for subsystems that are not socket
    channels but still carry requests worth chaos-testing. The serving
    gateway's in-proc replicas fire 'send' before a submission and
    'recv' after each engine step, so chaos injectors (partition /
    drop_connections scoped to the replica's endpoint string) apply to
    them exactly as they do to a ResilientChannel: a partitioned replica
    can neither accept new work nor deliver tokens."""
    _fire(point, endpoint)


# -- error taxonomy ---------------------------------------------------------
class RpcError(Exception):
    """Base for transport-level RPC failures (application-level errors —
    the server's {'error': ...} replies — stay plain RuntimeError)."""


class RetryableError(RpcError):
    """Transport failure that a fresh connection may fix; raised once the
    retry budget (attempts or deadline) is exhausted."""

    def __init__(self, msg, endpoint=None, attempts=0):
        super().__init__(msg)
        self.endpoint = endpoint
        self.attempts = attempts


class DeadlineExceeded(RetryableError):
    """The caller's deadline lapsed before any attempt succeeded."""


class CircuitOpenError(RetryableError):
    """Fast-fail: the endpoint's breaker is open (recent failures, the
    reset window has not elapsed). Callers should back off or re-shard."""


class FrameError(RpcError):
    """Malformed or oversized frame. Deliberately NOT retryable:
    resending the same bytes reproduces the same corruption, and a
    peer speaking a different protocol should fail loud, not retry
    until the deadline burns down."""


class FrameTooLargeError(FrameError):
    """Declared frame length exceeds the codec's max_frame bound —
    refuse before allocating, so a corrupted length header cannot OOM
    the receiver."""


class FrameDecodeError(FrameError):
    """Frame arrived whole but the payload failed to decode."""


# transient socket errnos worth a reconnect (vs e.g. EACCES/EBADF bugs)
_RETRYABLE_ERRNOS = frozenset({
    errno.ECONNREFUSED, errno.ECONNRESET, errno.ECONNABORTED,
    errno.EPIPE, errno.ETIMEDOUT, errno.EHOSTUNREACH, errno.ENETUNREACH,
    errno.ENETRESET, errno.EAGAIN,
})


class RetryPolicy:
    """Exponential backoff + full jitter, capped attempts, and the
    retryable/terminal classification used by ResilientChannel."""

    def __init__(self, max_attempts=4, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, retryable_exceptions=None):
        if max_attempts < 1:
            raise ValueError('max_attempts must be >= 1')
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self._extra_retryable = tuple(retryable_exceptions or ())

    def is_retryable(self, exc):
        if isinstance(exc, self._extra_retryable):
            return True
        if isinstance(exc, (socket.timeout, TimeoutError, ConnectionError,
                            BrokenPipeError, EOFError)):
            return True
        if isinstance(exc, OSError):
            return exc.errno in _RETRYABLE_ERRNOS or exc.errno is None
        return False

    def backoff(self, attempt):
        """Delay before retry number `attempt` (1-based), jittered."""
        d = min(self.base_delay * (self.multiplier ** (attempt - 1)),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * random.random()
        return d


class Deadline:
    """Absolute time budget. All attempts of a call (and all shards of a
    fan-out) share one Deadline so the total wait stays bounded."""

    def __init__(self, seconds):
        self._t_end = time.monotonic() + float(seconds)

    @classmethod
    def after(cls, seconds):
        return cls(seconds)

    def remaining(self):
        return self._t_end - time.monotonic()

    def expired(self):
        return self.remaining() <= 0.0

    def clamp(self, timeout):
        """Per-attempt socket timeout: never longer than what's left."""
        rem = self.remaining()
        if rem <= 0.0:
            raise DeadlineExceeded('deadline expired')
        return rem if timeout is None else min(timeout, rem)


class CircuitBreaker:
    """Half-open circuit breaker for one endpoint.

    closed -> (failure_threshold consecutive failures) -> open;
    open -> (reset_timeout elapsed) -> half-open: ONE probe call goes
    through; its success closes the breaker, its failure re-opens.
    """

    CLOSED, OPEN, HALF_OPEN = 'closed', 'open', 'half_open'

    def __init__(self, failure_threshold=5, reset_timeout=5.0, name=None):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._failures = 0
        self._opened_at = None
        self._probing = False
        self._lock = threading.Lock()
        self._m_state = None
        self.name = None
        if name is not None:
            self.bind_name(name)

    def bind_name(self, name):
        """Label this breaker's metrics with `name` (its endpoint).
        Unnamed breakers stay un-instrumented — standalone unit-test
        breakers don't pollute the endpoint label space."""
        self.name = name
        self._m_state = _M_BREAKER_STATE.labels(name)
        self._m_state.set(_STATE_CODES[self.CLOSED])

    def _note_transition(self, to_state):
        if self._m_state is not None:
            _M_TRANSITIONS.labels(self.name, to_state).inc()
            self._m_state.set(_STATE_CODES[to_state])

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if self._opened_at is None:
            return self.CLOSED
        if time.monotonic() - self._opened_at >= self.reset_timeout:
            return self.HALF_OPEN
        return self.OPEN

    def allow(self):
        """True if a call may proceed (claims the half-open probe slot)."""
        with self._lock:
            st = self._state_locked()
            if st == self.CLOSED:
                return True
            if st == self.HALF_OPEN and not self._probing:
                self._probing = True
                # the observable open -> half_open moment: a probe claim
                self._note_transition(self.HALF_OPEN)
                return True
            return False

    def record_success(self):
        with self._lock:
            was = self._state_locked()
            self._failures = 0
            self._opened_at = None
            self._probing = False
            if was != self.CLOSED:
                self._note_transition(self.CLOSED)

    def record_failure(self):
        """Count one failure; returns True exactly when this failure
        (re)opened the breaker — the edge the flight recorder dumps on,
        so a failure storm yields one dump, not one per call."""
        with self._lock:
            was = self._state_locked()
            self._failures += 1
            self._probing = False
            if self._failures >= self.failure_threshold:
                # (re)open and restart the reset window
                self._opened_at = time.monotonic()
                if was != self.OPEN:
                    self._note_transition(self.OPEN)
                    return True
        return False


# -- framed messages, codec-pluggable ---------------------------------------
# Same frame as ps/embedding_service (8-byte big-endian length + payload
# bytes); lives here so the channel owns its transport end-to-end and the
# ps module can keep its server-side helpers without an import cycle.
# `codec` is an (encode, decode) pair; None means the PS binary wire
# codec (the historical default — existing PS/graph clients unchanged).
# The serving fabric passes its length-prefixed JSON codec instead
# (serving/fabric/protocol.py), riding the identical retry/breaker/
# deadline/trace machinery over a different payload encoding.

def _send_frame(sock, obj, codec=None, max_frame=None):
    if codec is None:
        from .ps import wire
        payload = wire.encode(obj)
    else:
        payload = codec[0](obj)
    if max_frame is not None and len(payload) > max_frame:
        raise FrameTooLargeError(
            'refusing to send %d-byte frame (max_frame=%d)'
            % (len(payload), max_frame))
    sock.sendall(struct.pack('>Q', len(payload)) + payload)


def _recv_frame(sock, codec=None, max_frame=None):
    hdr = b''
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError('peer closed')
        hdr += chunk
    n = struct.unpack('>Q', hdr)[0]
    if max_frame is not None and n > max_frame:
        raise FrameTooLargeError(
            'peer declared %d-byte frame (max_frame=%d)' % (n, max_frame))
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError('peer closed')
        buf.extend(chunk)
    if codec is None:
        from .ps import wire
        return wire.decode(bytes(buf))
    return codec[1](bytes(buf))


class ResilientChannel:
    """One endpoint's connection with timeouts, reconnect-and-retry for
    idempotent ops, and a circuit breaker.

    Connection is lazy: construction never blocks on a dead server, the
    first call (or the first call after a failure) reconnects. One
    in-flight call at a time per channel (the frame protocol has no
    request ids); the internal lock serializes callers.
    """

    def __init__(self, endpoint, retry_policy=None,
                 call_timeout=DEFAULT_CALL_TIMEOUT,
                 connect_timeout=DEFAULT_CONNECT_TIMEOUT,
                 breaker=None, codec=None, max_frame=None):
        host, port = endpoint.rsplit(':', 1)
        self.endpoint = endpoint
        self._addr = (host, int(port))
        self.policy = retry_policy or RetryPolicy()
        self.codec = codec
        self.max_frame = max_frame
        self.call_timeout = call_timeout
        self.connect_timeout = connect_timeout
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker(name=endpoint)
        if self.breaker.name is None:
            self.breaker.bind_name(endpoint)
        # labeled children cached once: per-event cost is a flag check
        self._m_attempts = _M_ATTEMPTS.labels(endpoint)
        self._m_failures = _M_FAILURES.labels(endpoint)
        self._m_backoff = _M_BACKOFF.labels(endpoint)
        self._m_deadline = _M_DEADLINE.labels(endpoint)
        self._m_circuit = _M_CIRCUIT_REJECT.labels(endpoint)
        self._sock = None
        self._lock = threading.Lock()

    # -- connection management ----------------------------------------------
    def _connect(self, deadline=None):
        _fire('connect', self.endpoint)
        timeout = self.connect_timeout
        if deadline is not None:
            timeout = deadline.clamp(timeout)
        sock = socket.create_connection(self._addr, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _drop_connection(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self._drop_connection()

    @property
    def connected(self):
        return self._sock is not None

    # -- the call path -------------------------------------------------------
    def _attempt(self, msg, timeout, deadline):
        if self._sock is None:
            self._sock = self._connect(deadline)
        sock = self._sock
        per_try = timeout if deadline is None else deadline.clamp(timeout)
        sock.settimeout(per_try)
        _fire('send', self.endpoint)
        _send_frame(sock, msg, self.codec, self.max_frame)
        _fire('recv', self.endpoint)
        return _recv_frame(sock, self.codec, self.max_frame)

    def call(self, msg, idempotent=True, timeout=None, deadline=None):
        """Send one request, return the decoded reply.

        idempotent=False disables the retry loop: after a transport
        failure the server may or may not have applied the op, so a
        blind resend could double-apply (grad pushes). The connection is
        still timed out and reconnected for the NEXT call.

        With tracing enabled the call runs under an 'rpc.call' span with
        one 'rpc.attempt' child per wire attempt; each attempt's trace
        context rides the message under TRACE_KEY so the server-side
        handler span parents on the exact attempt that reached it.
        """
        if timeout is None:
            timeout = self.call_timeout
        attempts = self.policy.max_attempts if idempotent else 1
        tr = _tracing.default_tracer()
        if not tr.enabled:
            with self._lock:
                return self._call_locked(msg, timeout, deadline, attempts,
                                         tr, _tracing.NULL_SPAN)
        with tr.start_span('rpc.call',
                           tags={'endpoint': self.endpoint,
                                 'idempotent': bool(idempotent)}) as span:
            with self._lock:
                return self._call_locked(msg, timeout, deadline, attempts,
                                         tr, span)

    def _call_locked(self, msg, timeout, deadline, attempts, tr, span):
        last_exc = None
        for attempt in range(1, attempts + 1):
            if deadline is not None and deadline.expired():
                self._m_deadline.inc()
                if span:
                    span.set_tag('deadline_expired', True)
                    tr.recorder.maybe_dump('deadline_expired')
                raise DeadlineExceeded(
                    'deadline expired before attempt %d to %s'
                    % (attempt, self.endpoint),
                    endpoint=self.endpoint, attempts=attempt - 1) \
                    from last_exc
            if not self.breaker.allow():
                self._m_circuit.inc()
                span.set_tag('circuit_open_fast_fail', True)
                raise CircuitOpenError(
                    'circuit open for %s (%d consecutive failures)'
                    % (self.endpoint, self.breaker._failures),
                    endpoint=self.endpoint, attempts=attempt - 1) \
                    from last_exc
            if span:
                att = tr.start_span('rpc.attempt', parent=span,
                                    tags={'attempt': attempt,
                                          'retries': attempt - 1,
                                          'breaker': self.breaker.state})
                wire = dict(msg)
                wire[_tracing.TRACE_KEY] = att.ctx()
            else:
                att = _tracing.NULL_SPAN
                wire = msg
            try:
                self._m_attempts.inc()
                out = self._attempt(wire, timeout, deadline)
                self.breaker.record_success()
                att.finish()
                return out
            except DeadlineExceeded as e:
                self._drop_connection()
                self._m_deadline.inc()
                att.set_error(e)
                att.finish()
                if span:
                    tr.recorder.maybe_dump('deadline_expired')
                raise
            except Exception as e:
                self._drop_connection()
                att.set_error(e)
                att.finish()
                if not self.policy.is_retryable(e):
                    raise
                opened = self.breaker.record_failure()
                self._m_failures.inc()
                if opened and span:
                    # the failing attempt span is already in the ring
                    tr.recorder.maybe_dump('circuit_open')
                last_exc = e
                if attempt < attempts:
                    delay = self.policy.backoff(attempt)
                    if deadline is not None:
                        rem = deadline.remaining()
                        if rem <= 0:
                            break
                        delay = min(delay, rem)
                    span.add_event('backoff', attempt=attempt,
                                   seconds=round(delay, 6))
                    self._m_backoff.inc(delay)
                    time.sleep(delay)
        if deadline is not None and deadline.expired():
            self._m_deadline.inc()
            if span:
                span.set_tag('deadline_expired', True)
                tr.recorder.maybe_dump('deadline_expired')
            raise DeadlineExceeded(
                'deadline expired after %d attempts to %s: %r'
                % (attempts, self.endpoint, last_exc),
                endpoint=self.endpoint, attempts=attempts) from last_exc
        raise RetryableError(
            '%d attempts to %s failed: %r'
            % (attempts, self.endpoint, last_exc),
            endpoint=self.endpoint, attempts=attempts) from last_exc


def call_once(endpoint, msg, timeout=DEFAULT_CALL_TIMEOUT,
              connect_timeout=DEFAULT_CONNECT_TIMEOUT):
    """One-shot request over a fresh ephemeral connection (blocking ops
    like barriers that must not pin a shared channel). No retries — the
    caller owns retry semantics for these — but fully timed out."""
    ch = ResilientChannel(endpoint,
                          retry_policy=RetryPolicy(max_attempts=1),
                          call_timeout=timeout,
                          connect_timeout=connect_timeout,
                          breaker=CircuitBreaker(failure_threshold=1 << 30))
    try:
        return ch.call(msg, idempotent=False)
    finally:
        ch.close()
