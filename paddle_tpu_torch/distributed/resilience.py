"""Shared RPC resilience layer (counterpart of
paddle_tpu/distributed/resilience.py, cut to the part the serving gateway
uses).

- ``RetryPolicy``: exponential backoff with jitter, a max-attempt cap,
  and retryable-exception classification (connection resets / timeouts
  retry; protocol and application errors never do).
- ``Deadline``: an absolute wall-clock budget shared across every
  attempt of a call (and across a multi-shard fan-out) — retries must
  tighten, never extend, the caller's wait.
- ``CircuitBreaker``: a half-open breaker per endpoint, with its
  transitions and state on the ``rpc_*`` metric families of the port's
  default registry. The gateway's replicas each hold one.
- the error taxonomy (``RpcError`` and its subclasses).

Fault injection for tests rides through ``_fire()``: the hooks list is
empty (zero cost) until paddle_tpu_torch.testing.chaos installs
injectors. The gateway's in-proc replicas fire it around every
submission and engine step (``fire_fault_points``).

``ResilientChannel``, ``call_once`` and the framed-message functions
wait for the serving fabric's slice: their default codec is the
parameter server's wire format (distributed/ps/wire.py).
"""
import errno
import random
import socket
import threading
import time

from ..monitor import default_registry as _monitor_registry
from ..monitor.telemetry import record_rpc_schema as _record_rpc_schema

__all__ = ['RetryPolicy', 'Deadline', 'CircuitBreaker', 'RpcError',
           'RetryableError', 'DeadlineExceeded', 'CircuitOpenError',
           'FrameError', 'FrameTooLargeError', 'FrameDecodeError',
           'fire_fault_points']


# -- observability (paddle_tpu_torch/monitor) -------------------------------
# Families bind once at import via the single-source schema table
# (monitor/telemetry.py RPC_FAMILIES); breakers cache their labeled
# children at construction, so the per-event cost is one enabled-flag
# check (and nothing at all for events that don't happen).
_FAMS = _record_rpc_schema(_monitor_registry())
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
        (re)opened the breaker — one edge per failure storm, not one per
        call (the gateway tags its failover span with it)."""
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
