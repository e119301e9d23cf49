"""Fault-injection harness for failure-path tests (counterpart of
paddle_tpu/testing/chaos.py, cut to the hook-point injectors).

The resilience layer (distributed/resilience.py) exposes hook points —
'connect', 'send', 'recv', each fired with the endpoint string — and this
module installs injectors into them. Everything is context-managed so a
failing test can never leak a fault into the next one.

    with chaos.partition(gw.pool[1].endpoint):
        ...                           # replica 1 black-holes send + recv

Faults compose (nested context managers fire in install order) and can be
scoped to an endpoint substring, a hook point, and a max fire count.

`kill_server`, `crash_io_save` and `truncate_file` wait for the serving
fabric's servers and the checkpoint writer (`io_save`), which the port
does not have yet.
"""
import contextlib
import threading

from ..distributed import resilience
from ..monitor import tracing as _tracing

__all__ = ['inject', 'drop_connections', 'delay_connections', 'partition',
           'fail_after', 'active_faults']


def active_faults():
    """Number of currently installed injectors (leak canary for tests)."""
    return len(resilience._FAULT_HOOKS)


@contextlib.contextmanager
def inject(hook):
    """Install a raw `fn(point, endpoint)` injector for the duration."""
    resilience._FAULT_HOOKS.append(hook)
    try:
        yield hook
    finally:
        try:
            resilience._FAULT_HOOKS.remove(hook)
        except ValueError:
            pass


class _Fault:
    """Counted, endpoint/point-scoped injector."""

    def __init__(self, action, points, endpoint_substr, times):
        self._action = action
        self._points = points
        self._match = endpoint_substr
        self._times = times
        self._lock = threading.Lock()
        self.fired = 0

    def __call__(self, point, endpoint):
        if self._points is not None and point not in self._points:
            return
        if self._match is not None and self._match not in endpoint:
            return
        with self._lock:
            if self._times is not None and self.fired >= self._times:
                return
            self.fired += 1
        # annotate the current span BEFORE the action fires — the action
        # usually raises
        _tracing.note_fault(point, endpoint)
        self._action(point, endpoint)


def _as_points(point):
    if point is None:
        return None
    if isinstance(point, str):
        return (point,)
    return tuple(point)


def drop_connections(endpoint=None, point=None, times=None):
    """Make matching transport ops raise ConnectionError.

    point: 'connect' | 'send' | 'recv' | tuple | None (= all three);
    times: stop firing after N drops (None = for the whole scope).
    Returns a context manager yielding the fault (inspect `.fired`).
    """
    def action(p, ep):
        raise ConnectionError('chaos: dropped %s to %s' % (p, ep))
    return inject(_Fault(action, _as_points(point), endpoint, times))


def partition(endpoint, times=None):
    """Network-partition a single endpoint: both send AND recv raise until
    the context exits (or `times` ops have been dropped). Unlike
    drop_connections(point=None) this never touches 'connect', so a
    partitioned peer looks *reachable* but black-holes traffic — the
    failure mode that forces a gateway to fail requests over rather than
    simply re-dial. Returns the fault (inspect `.fired`)."""
    def action(p, ep):
        raise ConnectionError('chaos: partitioned %s at %s' % (ep, p))
    return inject(_Fault(action, ('send', 'recv'), endpoint, times))


def delay_connections(seconds, endpoint=None, point='connect', times=None):
    """Sleep `seconds` at matching hook points (latency injection)."""
    import time

    def action(p, ep):
        time.sleep(seconds)
    return inject(_Fault(action, _as_points(point), endpoint, times))


def fail_after(n, endpoint=None, point='send', exc=ConnectionResetError):
    """Let the first n matching ops through, then fail every later one —
    a server that dies mid-batch from the client's point of view."""
    state = {'seen': 0}
    lock = threading.Lock()

    def hook(p, ep):
        if p != point:
            return
        if endpoint is not None and endpoint not in ep:
            return
        with lock:
            state['seen'] += 1
            if state['seen'] > n:
                raise exc('chaos: %s to %s failed after %d ops'
                          % (p, ep, n))
    return inject(hook)
