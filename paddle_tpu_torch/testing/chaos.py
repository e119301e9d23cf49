"""Fault-injection harness for failure-path tests (counterpart of
paddle_tpu/testing/chaos.py).

The resilience layer (distributed/resilience.py) exposes hook points —
'connect', 'send', 'recv', each fired with the endpoint string — and this
module installs injectors into them. Everything is context-managed so a
failing test can never leak a fault into the next one.

    with chaos.partition(gw.pool[1].endpoint):
        ...                           # replica 1 black-holes send + recv

Faults compose (nested context managers fire in install order) and can be
scoped to an endpoint substring, a hook point, and a max fire count.

Beyond the hook points: `kill_server` hard-kills a socket server (the
fabric's ReplicaWorker or ArtifactServer) like a SIGKILLed pod,
`crash_io_save` kills the checkpoint writer (framework/io_save.py) at a
named point of its atomic write, and `truncate_file` tears a file on
disk.
"""
import contextlib
import os
import socket
import threading

from ..distributed import resilience
from ..framework import io_save as _io_save
from ..monitor import tracing as _tracing

__all__ = ['inject', 'drop_connections', 'delay_connections', 'partition',
           'fail_after', 'active_faults', 'kill_server', 'WriterKilled',
           'crash_io_save', 'truncate_file']


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


def kill_server(server):
    """Hard-kill a socket server (anything holding a socketserver in
    `_srv`, as the fabric's ReplicaWorker and ArtifactServer do): stop
    the listener AND sever every established connection, like a
    SIGKILLed pod. In-flight
    client calls see a reset; later calls see refused connections (until
    something rebinds the port)."""
    srv = getattr(server, '_srv', server)
    try:
        srv.shutdown()
    except Exception:
        pass
    for conn in list(getattr(srv, 'live_connections', ())):
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass
    try:
        srv.server_close()
    except Exception:
        pass


class WriterKilled(BaseException):
    """Raised by crash_io_save to simulate a writer dying mid-save.

    Deliberately NOT an Exception: a preempted pod doesn't run except
    handlers, and deriving from BaseException keeps broad `except
    Exception` recovery paths in the code under test from swallowing the
    simulated death."""


def crash_io_save(point, path_substr=None, times=1):
    """Kill the io_save atomic writer at a named point for the scope.

    point: 'pre_rename' (payload still in the temp file — the target
    path is untouched) or 'pre_manifest' (payload renamed into place,
    manifest sidecar missing/stale). path_substr scopes the crash to
    matching destination paths; times bounds how many saves die.
    Returns a context manager yielding the fault (inspect `.fired`).
    """
    def action(p, target):
        raise WriterKilled('chaos: writer killed at %s of %s'
                           % (p, target))
    fault = _Fault(action, _as_points(point), path_substr, times)

    @contextlib.contextmanager
    def _scope():
        _io_save._FAULT_HOOKS.append(fault)
        try:
            yield fault
        finally:
            try:
                _io_save._FAULT_HOOKS.remove(fault)
            except ValueError:
                pass
    return _scope()


def truncate_file(path, keep_bytes=None, drop_bytes=16):
    """Truncate a file in place (a preempted writer / torn disk write).
    keep_bytes wins if given; otherwise the final drop_bytes are cut."""
    size = os.path.getsize(path)
    if keep_bytes is None:
        keep_bytes = max(size - drop_bytes, 0)
    with open(path, 'r+b') as f:
        f.truncate(keep_bytes)
    return keep_bytes
