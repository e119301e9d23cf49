"""CompileWatchdog: count, time, and attribute every torch.compile compile
(counterpart of paddle_tpu/monitor/perf/watchdog.py).

The JAX watchdog listens to jax.monitoring's three compile-duration
events. Here TorchDynamo's compile callbacks
(``torch._dynamo.callback.callback_handler``) bracket every frame compile,
and the stage times it recorded in between
(``torch._dynamo.utils.compilation_time_metrics``) map onto the same
closed stage set: ``trace`` (Dynamo's bytecode tracing), ``lower``
(AOTAutograd) and ``compile`` (Inductor). They land in the
``perf_compiles_total`` counter and ``perf_compile_seconds`` histogram,
labeled by stage. A torch without the callbacks, the stage-time table,
the modules that time the three stages or Inductor's cache counters
raises at construction: a watchdog that silently counts nothing would
read as a clean run. A callback that fails later keeps its exception
(``errors``, ``report()['errors']``) and the call that compiled raises
it through ``raise_pending``, strict or not.

After the owner declares a warmup barrier (``declare_warmup``), ANY
further compile is a recompile: the watchdog walks the live stack to
attribute it to the first frame outside torch and outside this package
(the user's line that called a to_static function, a Predictor or
Model.fit), with the call's input signature (jit.to_static
publishes the signature it keys its programs by; a bare torch.compile'd
function is described by its tensor arguments), bumps
``perf_recompiles_total``, pushes a ``perf.recompile`` record into the
tracer's flight ring and fires a throttled flight dump. Under
``PADDLE_TPU_COMPILE_STRICT=1`` (or ``strict=True``) the call raises
:class:`RecompileError`: to_static raises it as the compiled call
returns (``raise_pending``, which an open watchdog hooks into jit's
after-call hooks; a callback that raised would leave Dynamo's callback
bookkeeping half-done), and code that calls a torch.compile'd function
itself calls ``raise_pending()`` after it.

The callbacks are process-global: every watchdog sees every compile in
the process. The optional ``owner`` filter keeps multi-engine processes
honest — a recompile is only charged to a watchdog whose owner object
appears on the compiling stack (as ``self`` of a frame outside torch, or
as the layer a to_static function is bound to). With no owner, every
post-warmup compile counts.

Persistent-cache composition: a compile whose Inductor graph came out of
the FX graph cache (``counters['inductor']['fxgraph_cache_hit']`` moved
and ``fxgraph_cache_miss`` did not) plays the part of the JAX
persistent-cache hit: it is exported as
``perf_persistent_cache_hits_total`` and exempt from the recompile path;
a miss stays a violation. Each watchdog keeps its own per-thread marks.
"""
import contextlib
import functools
import importlib
import inspect
import os
import sys
import threading
import time

import torch

from ..registry import default_registry
from ..telemetry import record_perf_schema
from .. import tracing as _tracing

__all__ = ['CompileWatchdog', 'RecompileError', 'COMPILE_EVENTS',
           'raise_pending']

# compilation_time_metrics key -> stage label (closed set)
COMPILE_EVENTS = {
    'bytecode_tracing': 'trace',
    'create_aot_dispatcher_function': 'lower',
    'compile_fx_inner': 'compile',
}

# the modules whose source times each stage under its key
_STAGE_SOURCES = {
    'bytecode_tracing': ('torch._dynamo.output_graph',
                         'torch._dynamo.convert_frame'),
    'create_aot_dispatcher_function': ('torch._functorch.aot_autograd',),
    'compile_fx_inner': ('torch._inductor.compile_fx',),
}

_KINDS = ('trace', 'lower', 'compile')

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_PORT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_INTERNAL_DIRS = (_TORCH_DIR + os.sep, _PORT_DIR + os.sep)

# strict-mode errors waiting for their call to return, per thread
_pending = threading.local()


class RecompileError(RuntimeError):
    """A recompile happened after a declared warmup barrier while the
    watchdog ran in strict mode."""


def raise_pending():
    """Raise the first strict-mode RecompileError recorded on this thread
    since the last call (and forget the rest); no-op when none."""
    errs = getattr(_pending, 'errors', None)
    if errs:
        _pending.errors = []
        raise errs[0]


def _push_pending(err):
    errs = getattr(_pending, 'errors', None)
    if errs is None:
        errs = _pending.errors = []
    errs.append(err)


def _callback_handler():
    """TorchDynamo's compile-callback registry; raises when the installed
    torch has none."""
    try:
        from torch._dynamo.callback import callback_handler
        callback_handler.register_start_callback
        callback_handler.register_end_callback
        callback_handler.remove_start_callback
        callback_handler.remove_end_callback
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            'CompileWatchdog needs TorchDynamo\'s compile callbacks '
            '(torch._dynamo.callback.callback_handler), which torch %s '
            'lacks' % torch.__version__) from e
    return callback_handler


@functools.lru_cache(maxsize=None)
def _check_compile_sources():
    """Raise unless the stage-time table, the modules that time each
    COMPILE_EVENTS key and Inductor's FX-cache counters are where the
    callbacks read them."""
    missing = []
    try:
        from torch._dynamo.utils import compilation_time_metrics, counters
        if not isinstance(compilation_time_metrics, dict):
            missing.append('torch._dynamo.utils.compilation_time_metrics')
        counters['inductor']['fxgraph_cache_hit']
        counters['inductor']['fxgraph_cache_miss']
    except (ImportError, AttributeError, KeyError, TypeError):
        missing.append('torch._dynamo.utils.compilation_time_metrics / '
                       "counters['inductor']")
    for key, modules in _STAGE_SOURCES.items():
        found = False
        for name in modules:
            try:
                src = inspect.getsource(importlib.import_module(name))
            except (ImportError, OSError, TypeError):
                continue
            if '"%s"' % key in src or "'%s'" % key in src:
                found = True
                break
        if not found:
            missing.append('the %r stage timer (%s)'
                           % (key, ' / '.join(modules)))
    if missing:
        raise RuntimeError(
            'CompileWatchdog cannot read torch %s\'s compile accounting: '
            'missing %s' % (torch.__version__, '; '.join(missing)))


def _stage_marks():
    from torch._dynamo.utils import compilation_time_metrics as ctm
    return {key: len(ctm.get(key, ())) for key in COMPILE_EVENTS}


def _cache_marks():
    from torch._dynamo.utils import counters
    ind = counters['inductor']
    return ind['fxgraph_cache_hit'], ind['fxgraph_cache_miss']


def _is_internal_frame(filename):
    """Frames that can never be the *triggering* callsite: torch's own
    machinery, this package, contextlib and threading plumbing."""
    f = os.path.abspath(filename)
    return (f.startswith(_INTERNAL_DIRS) or f.endswith('contextlib.py')
            or f.endswith('threading.py'))


def _describe(args):
    """'dtype[d0, d1]' for each tensor in a flat argument tuple."""
    out = []
    for a in args:
        if torch.is_tensor(a):
            out.append('%s[%s]' % (str(a.dtype).replace('torch.', ''),
                                   ', '.join(str(s) for s in a.shape)))
        elif isinstance(a, (list, tuple)):
            out.append('(%s)' % _describe(a))
    return ', '.join(out)


def _walk_attribution(max_depth=160):
    """(callsite, signature, owner_candidates) from the live stack.

    Called from Dynamo's end-of-compile callback, so the stack below holds
    torch's compile machinery, then the port's frames (jit, a Predictor,
    Model.fit), then the caller. The signature is the one to_static
    keyed this program by, else the tensor arguments of torch's
    compiled-call wrapper. Owner candidates are the `self` of every
    frame outside torch (and the layer a to_static function is bound
    to)."""
    from ...jit import current_signature
    callsite = None
    signature = current_signature()
    owners = []
    try:
        f = sys._getframe(2)
    except Exception:
        return callsite, signature, owners
    depth = 0
    while f is not None and depth < max_depth:
        code = f.f_code
        internal = _is_internal_frame(code.co_filename)
        if signature is None and internal and \
                code.co_filename.endswith('eval_frame.py'):
            args = f.f_locals.get('args')
            if isinstance(args, tuple) and args:
                signature = _describe(args)[:400] or None
        if not code.co_filename.startswith(_TORCH_DIR):
            slf = f.f_locals.get('self')
            if slf is not None:
                owners.append(slf)
                layer = getattr(slf, '_bound_layer', None)
                if layer is not None:
                    owners.append(layer)
        if not internal and callsite is None:
            callsite = '%s:%d:%s' % (code.co_filename, f.f_lineno,
                                     code.co_name)
        f = f.f_back
        depth += 1
    return callsite, signature, owners


class CompileWatchdog:
    """Per-registry torch.compile accountant with a warmup barrier.

        wd = CompileWatchdog()           # default registry + tracer
        ... compile everything once ...
        wd.declare_warmup('serving steady state')
        # any compile from here on is a counted, attributed recompile

    ``enabled`` is a plain attribute checked first in the callbacks (the
    registry's one-load+branch discipline); ``close()`` removes the
    callbacks — always pair construction with close() in tests.
    """

    def __init__(self, registry=None, tracer=None, strict=None,
                 owner=None, name='', clock=None, max_records=64):
        self._handler = _callback_handler()
        _check_compile_sources()
        self.registry = registry if registry is not None \
            else default_registry()
        fams = record_perf_schema(self.registry)
        self._m_compiles = {k: fams['perf_compiles_total'].labels(k)
                            for k in _KINDS}
        self._h_seconds = {k: fams['perf_compile_seconds'].labels(k)
                           for k in _KINDS}
        self._m_recompiles = fams['perf_recompiles_total']
        self._m_cache_hits = fams['perf_persistent_cache_hits_total']
        self._m_cache_misses = fams['perf_persistent_cache_misses_total']
        self._marks = threading.local()   # this watchdog's own marks
        self.enabled = True
        self.armed = False
        self.warmup_label = None
        self.name = name
        self.owner = owner
        if strict is None:
            strict = os.environ.get('PADDLE_TPU_COMPILE_STRICT') == '1'
        self.strict = bool(strict)
        self.max_records = int(max_records)
        self.counts = {k: 0 for k in _KINDS}
        self.compile_events = 0     # Dynamo frame compiles seen
        self.recompile_count = 0    # this watchdog's own violations
        self.records = []           # recompile attributions, oldest first
        self.errors = []            # callback failures, oldest first
        self._tracer = tracer       # None -> default_tracer() at use
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._start_cb = self._end_cb = None
        self._install()

    # ---- callback lifecycle -------------------------------------------

    def _install(self):
        # a callback must not raise into Dynamo (its bookkeeping would be
        # left half-done): a failure is kept and raised as the call returns
        def _start(*args):
            if self.enabled:
                try:
                    self._on_start()
                except Exception as e:
                    self._callback_failed('start', e)

        def _end(*args):
            if self.enabled:
                try:
                    self._on_end()
                except Exception as e:
                    self._callback_failed('end', e)

        from ... import jit
        self._handler.register_start_callback(_start)
        self._handler.register_end_callback(_end)
        jit.add_after_call_hook(raise_pending)
        self._start_cb, self._end_cb = _start, _end

    def _callback_failed(self, which, exc):
        err = RuntimeError('CompileWatchdog %r: the compile-%s callback '
                           'failed: %r' % (self.name, which, exc))
        err.__cause__ = exc
        with self._lock:
            self.errors.append(err)
            del self.errors[:-self.max_records]
        _push_pending(err)

    @property
    def active(self):
        """True while the Dynamo callbacks are registered."""
        return self._end_cb is not None

    def close(self):
        """Stop counting and remove the callbacks (idempotent)."""
        self.enabled = False
        start, end = self._start_cb, self._end_cb
        self._start_cb = self._end_cb = None
        if end is None:
            return
        from ... import jit
        jit.remove_after_call_hook(raise_pending)
        for cb, remove in ((start, self._handler.remove_start_callback),
                           (end, self._handler.remove_end_callback)):
            try:
                remove(cb)
            except ValueError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- warmup barrier -----------------------------------------------

    def declare_warmup(self, label='warmup'):
        """Arm recompile accounting: every compile from now on is a
        steady-state violation."""
        self.warmup_label = label
        self.armed = True
        return self

    def disarm(self):
        self.armed = False

    @contextlib.contextmanager
    def suspended(self):
        """Temporarily disarm — for deliberate compiles inside a warm
        window."""
        was = self.armed
        self.armed = False
        try:
            yield self
        finally:
            self.armed = was

    # ---- event path ---------------------------------------------------

    def _on_start(self):
        stack = getattr(self._marks, 'stack', None)
        if stack is None:
            stack = self._marks.stack = []
        stack.append((time.perf_counter(), _stage_marks(), _cache_marks()))

    def _on_end(self):
        stack = getattr(self._marks, 'stack', None)
        if not stack:
            return              # began before this watchdog existed
        t0, stages0, (hit0, miss0) = stack.pop()
        duration = time.perf_counter() - t0
        from torch._dynamo.utils import compilation_time_metrics as ctm
        with self._lock:
            self.compile_events += 1
        for key, kind in COMPILE_EVENTS.items():
            for secs in list(ctm.get(key, ()))[stages0[key]:]:
                with self._lock:
                    self.counts[kind] += 1
                self._m_compiles[kind].inc()
                self._h_seconds[kind].observe(float(secs))
        hit1, miss1 = _cache_marks()
        dh, dm = hit1 - hit0, miss1 - miss0
        if dh > 0:
            self._m_cache_hits.inc(dh)
        if dm > 0:
            self._m_cache_misses.inc(dm)
        if self.armed and not (dh > 0 and dm == 0):
            self._on_recompile(duration)

    def _on_recompile(self, duration):
        callsite, signature, owners = _walk_attribution()
        if self.owner is not None and not any(o is self.owner
                                              for o in owners):
            return              # someone else's compile, not a violation
        rec = {'time': self._clock(), 'duration_s': duration,
               'after_warmup': self.warmup_label, 'callsite': callsite,
               'signature': signature, 'watchdog': self.name}
        with self._lock:
            self.recompile_count += 1
            self.records.append(rec)
            del self.records[:-self.max_records]
        self._m_recompiles.inc()
        tracer = self._tracer if self._tracer is not None \
            else _tracing.default_tracer()
        # drop the attribution into the flight ring so the dump that
        # follows carries WHO retraced, not just that one did
        tracer.recorder.record({'name': 'perf.recompile',
                                'start': rec['time'], 'duration': duration,
                                'tags': dict(rec)})
        tracer.recorder.maybe_dump('recompile')
        if self.strict:
            _push_pending(RecompileError(
                'recompile after warmup barrier %r: callsite=%s '
                'signature=%s (set PADDLE_TPU_COMPILE_STRICT=0 or fix '
                'the retrace)' % (self.warmup_label, callsite, signature)))

    # ---- inspection ---------------------------------------------------

    @property
    def recompiles(self):
        """Violations charged to THIS watchdog (the registry counter is
        shared when several watchdogs publish to one registry)."""
        return self.recompile_count

    def report(self):
        """Plain-dict summary for logs / bench rows."""
        with self._lock:
            return {'counts': dict(self.counts),
                    'recompiles': self.recompiles,
                    'armed': self.armed,
                    'warmup_label': self.warmup_label,
                    'records': [dict(r) for r in self.records],
                    'errors': [repr(e) for e in self.errors]}
