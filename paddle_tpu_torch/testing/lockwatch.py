"""Runtime lock-order witness (counterpart of
paddle_tpu/testing/lockwatch.py, copied: it needs nothing but the standard
library) — the dynamic half of graftlint's lock checker.

The static checker (tools/graftlint/checkers/locks.py) derives a
lock-acquisition-order graph lexically: an edge A -> B means some code
path acquires B while holding A.  That analysis is conservative and
blind to locks passed through indirection, so threaded tests wrap their
locks in a :class:`LockWatch` and assert the ORDER OBSERVED AT RUNTIME
stays consistent — both internally (no thread ever acquires in an order
that inverts another thread's) and against the static graph (the union
of runtime and static edges must stay acyclic).

Usage::

    watch = LockWatch()
    replica._cv = watch.wrap('replica._cv', replica._cv)
    ... drive threads ...
    watch.assert_acyclic()                    # runtime-only check
    watch.assert_acyclic(static_edges)        # cross-check vs graftlint

Wrapped locks proxy every other attribute (``wait``, ``notify_all``,
``locked`` ...) to the underlying object, so a wrapped ``Condition``
still behaves like one.
"""
import threading

__all__ = ['LockWatch', 'LockOrderError']


class LockOrderError(AssertionError):
    """Two code paths acquire the same locks in conflicting order."""


class _WatchedLock:
    """Proxy that reports acquire/release to its LockWatch."""

    def __init__(self, watch, name, lock):
        self._watch = watch
        self._name = name
        self._lock = lock

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self._watch._on_acquire(self._name)
        return got

    def release(self):
        self._watch._on_release(self._name)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition.wait releases and re-acquires the underlying lock; the
    # held-stack position does not change, so plain passthrough is right.
    def __getattr__(self, attr):
        return getattr(self._lock, attr)


class LockWatch:
    """Records the lock-acquisition-order graph actually exercised.

    ``strict=True`` raises at the acquisition that first inverts an
    already-observed edge (best for pinpointing the offending stack);
    the default defers to :meth:`assert_acyclic` so a test can drive
    all its threads first.
    """

    def __init__(self, strict=False):
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._edges = {}        # (held, acquired) -> observation count
        self._strict = strict

    def wrap(self, name, lock):
        return _WatchedLock(self, name, lock)

    def _held(self):
        st = getattr(self._tls, 'stack', None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _on_acquire(self, name):
        held = self._held()
        with self._mu:
            for h in held:
                if h != name:   # re-entrant re-acquire adds no edge
                    self._edges[(h, name)] = \
                        self._edges.get((h, name), 0) + 1
                    if self._strict and (name, h) in self._edges:
                        raise LockOrderError(
                            'lock order inversion: acquiring %r while '
                            'holding %r, but the opposite order was '
                            'already observed' % (name, h))
        held.append(name)

    def _on_release(self, name):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def edges(self):
        with self._mu:
            return dict(self._edges)

    def assert_acyclic(self, extra_edges=()):
        """Raise LockOrderError if observed edges (unioned with
        ``extra_edges``, e.g. graftlint's static acquisition_order)
        contain a cycle."""
        graph = {}
        for a, b in list(self.edges()) + [tuple(e) for e in extra_edges]:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        stack = []

        def visit(n):
            color[n] = GREY
            stack.append(n)
            for m in sorted(graph[n]):
                if color[m] == GREY:
                    cyc = stack[stack.index(m):] + [m]
                    raise LockOrderError(
                        'lock acquisition-order cycle: %s'
                        % ' -> '.join(cyc))
                if color[m] == WHITE:
                    visit(m)
            stack.pop()
            color[n] = BLACK

        for n in sorted(graph):
            if color[n] == WHITE:
                visit(n)
