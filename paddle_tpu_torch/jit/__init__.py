"""paddle.jit: to_static and save / load (counterpart of
paddle_tpu/jit/__init__.py; reference: python/paddle/fluid/dygraph/jit.py
declarative, dygraph_to_static/program_translator.py).

torch.compile stands where the JAX package uses jax.jit: TorchDynamo
traces the Python, Inductor compiles the graph, and the hand-written
kernels run inside the compiled program as the custom ops of
ops/flash_attention.py. A StaticFunction keeps one compiled program per
input signature (shapes, dtypes, devices and requires_grad of the tensor
arguments, the other arguments, `training`, grad mode and the auto_cast
state), each on a code object of its own, compiled with dynamic=False and
fullgraph=True: a graph break raises (ToStaticError, naming the user's
line) instead of running in pieces, unless the caller asks for pieces with
`to_static(..., full_graph=False)`. A signature compiles once; TorchDynamo's
recompile limit counts per code object, so no later signature runs
eagerly, and hitting it raises. While an after-call hook is registered
(`add_after_call_hook`; an open CompileWatchdog registers one),
`current_signature()` names the running program's signature, which the
watchdog attributes a recompile to, and the hooks run as each call
returns, where a strict watchdog raises its RecompileError.

jit.save writes `.pdiparams` (the parameters and buffers through the
port's io_save) and `.pdmodel` (the meta, the eval forward exported by
torch.export at the input spec's shapes, in the place of the JAX
package's StableHLO text, and the pickled architecture). jit.load returns
a TranslatedLayer that runs the loaded layer. Neither package reads the
other's artifacts.
"""
import collections
import contextlib
import copy
import functools
import io
import os
import pickle
import threading
import types
import warnings
import weakref

import torch

from ..framework import device as device_mod
from ..framework import dtype as dtype_mod
from ..framework import io_save, op_version
from ..static.input_spec import InputSpec
from .error import ToStaticError, trace_error_scope  # noqa: F401

__all__ = ['to_static', 'save', 'load', 'TranslatedLayer', 'not_to_static',
           'current_signature', 'add_after_call_hook',
           'remove_after_call_hook',
           'ignore_module', 'StaticFunction', 'ProgramTranslator',
           'TracedLayer', 'InputSpec', 'declarative', 'set_verbosity',
           'set_code_level']

# bump the MAJOR on breaking artifact-layout changes; loads refuse a
# newer major and warn on an older one (forward-compat contract)
_FORMAT_VERSION = (1, 0)


def _amp_key():
    from ..amp.auto_cast import amp_state
    s = amp_state()
    return (s['enabled'], s['dtype'], s['level'],
            tuple(sorted(s['custom_white'])),
            tuple(sorted(s['custom_black'])))


def _arg_key(a):
    if torch.is_tensor(a):
        return ('tensor', tuple(a.shape), str(a.dtype), str(a.device),
                a.requires_grad)
    if isinstance(a, (list, tuple)):
        return (type(a).__name__,) + tuple(_arg_key(x) for x in a)
    if isinstance(a, dict):
        return ('dict',) + tuple((k, _arg_key(a[k])) for k in sorted(a))
    try:
        hash(a)
    except TypeError:
        return ('object', type(a).__name__, id(a))
    return ('value', a)


# the signature key of the to_static call running on this thread, kept
# only while an after-call hook is registered
_calling = threading.local()

# callables run, on the calling thread, as each to_static call returns
_after_call_hooks = []


def add_after_call_hook(fn):
    """Run fn() as every to_static call returns; while any hook is
    registered, current_signature() names the running call's signature."""
    _after_call_hooks.append(fn)


def remove_after_call_hook(fn):
    """Unregister one registration of fn."""
    _after_call_hooks.remove(fn)


def _sig_text(key):
    """'float32[2, 512] (grad), int64[2, 512]' for a signature key's
    positional arguments, plus training / grad mode."""
    def one(k):
        if k[0] == 'tensor':
            return '%s[%s]%s' % (k[2].replace('torch.', ''),
                                 ', '.join(str(d) for d in k[1]),
                                 ' (grad)' if k[4] else '')
        if k[0] in ('list', 'tuple'):
            return '(%s)' % ', '.join(one(x) for x in k[1:])
        return repr(k[-1]) if k[0] == 'value' else k[0]
    args, _, training, grad, _ = key
    return '%s; training=%s grad=%s' % (', '.join(one(k) for k in args),
                                        training, grad)


def current_signature():
    """The input signature of the to_static program compiling or running
    on this thread, as text; None outside one."""
    key = getattr(_calling, 'key', None)
    return None if key is None else _sig_text(key)


def _fresh_entry(fn):
    """A function that calls fn, on a code object of its own: TorchDynamo
    keeps compiled programs, and counts recompiles, per code object."""
    def entry(*args, **kwargs):
        return fn(*args, **kwargs)
    return types.FunctionType(entry.__code__.replace(), entry.__globals__,
                              'to_static_program', None, entry.__closure__)


def _counting_backend(counter, key):
    """Inductor, counting each graph it compiles under `key`."""
    def backend(gm, example_inputs):
        counter[key] += 1
        from torch._inductor.compile_fx import compile_fx
        return compile_fx(gm, example_inputs)
    return backend


def _fail_on_recompile_limit():
    import torch._dynamo.config as cfg
    for name in ('fail_on_recompile_limit_hit', 'fail_on_cache_limit_hit'):
        if hasattr(cfg, name):
            return cfg.patch(**{name: True})
    return contextlib.nullcontext()


def _raised_by_user(exc):
    """True when TorchDynamo stopped at an exception that the traced code
    itself raises (an "observed exception")."""
    import torch._dynamo.exc as dexc
    observed = getattr(dexc, 'ObservedException', None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if observed is not None and isinstance(exc, observed):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


class StaticFunction:
    """Wraps a function or a Layer's forward: the first call of a signature
    compiles it, later calls run the compiled program. `compiles` counts
    the graphs compiled for each signature (1 each with full_graph)."""

    def __init__(self, fn, input_spec=None, layer=None, full_graph=True):
        self._fn = fn
        self._input_spec = input_spec
        self._layer = layer
        self._full_graph = full_graph
        self._programs = {}
        self.compiles = collections.Counter()
        functools.update_wrapper(self, fn)

    @property
    def _bound_layer(self):
        if self._layer is not None:
            return self._layer
        return getattr(self._fn, '__self__', None)

    def _sig(self, args, kwargs):
        layer = self._bound_layer
        training = getattr(layer, 'training', None)
        return (tuple(_arg_key(a) for a in args),
                tuple((k, _arg_key(kwargs[k])) for k in sorted(kwargs)),
                training, torch.is_grad_enabled(), _amp_key())

    def __call__(self, *args, **kwargs):
        # inside another to_static program, or switched off: the plain call
        # (the outer program traces it into its own graph)
        if torch.compiler.is_compiling() or not ProgramTranslator._enabled:
            return self._fn(*args, **kwargs)
        with trace_error_scope(self._fn):
            return self._call_impl(*args, **kwargs)

    def _call_impl(self, *args, **kwargs):
        key = self._sig(args, kwargs)
        program = self._programs.get(key)
        first = program is None
        if first:
            program = self._programs[key] = torch.compile(
                _fresh_entry(self._fn), fullgraph=self._full_graph,
                dynamic=False,
                backend=_counting_backend(self.compiles, key))
        watched = bool(_after_call_hooks)
        if watched:
            outer, _calling.key = getattr(_calling, 'key', None), key
        try:
            with _fail_on_recompile_limit():
                out = program(*args, **kwargs)
        except Exception as e:
            if _raised_by_user(e):
                # the user's code raises its own exception, which
                # TorchDynamo reports as a graph break: run the code to
                # raise it as it is (a call that returns after all gets the
                # compile error)
                self._fn(*args, **kwargs)
            raise
        finally:
            if watched:
                _calling.key = outer
        if _after_call_hooks:
            for hook in list(_after_call_hooks):
                hook()
        if first and not self.compiles[key]:
            raise RuntimeError(
                'to_static: %r ran without compiling a program'
                % getattr(self._fn, '__name__', self._fn))
        return out

    def program_count(self):
        """The signatures compiled so far."""
        return len(self._programs)

    def compile_count(self):
        """The graphs compiled so far, over every signature."""
        return sum(self.compiles.values())

    @property
    def concrete_program(self):
        return self

    def rollback(self):
        return self._fn


class _StaticMethod(StaticFunction):
    """A StaticFunction that binds as a method: to_static used as a
    decorator in a class body. Each instance gets its own bound
    StaticFunction (and its own programs). A Layer's to_static forward is
    a plain StaticFunction, an instance attribute with no binding."""

    def __init__(self, fn, input_spec=None, layer=None, full_graph=True):
        super().__init__(fn, input_spec, layer, full_graph)
        self._bound = weakref.WeakKeyDictionary()

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = self._bound.get(instance)
        if bound is None:
            bound = StaticFunction(self._fn.__get__(instance, owner),
                                   self._input_spec, layer=instance,
                                   full_graph=self._full_graph)
            self._bound[instance] = bound
        return bound


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Compile a Layer's forward (in place; the Layer is returned) or a
    function. full_graph=False lets TorchDynamo split the program at the
    constructs it cannot trace (graph breaks) instead of raising."""
    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            if not isinstance(fn.__dict__.get('forward'), StaticFunction):
                fn.forward = StaticFunction(fn.forward, input_spec,
                                            layer=fn, full_graph=full_graph)
            return fn
        return _StaticMethod(fn, input_spec, full_graph=full_graph)
    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    """Marks fn, as the JAX package does. TorchDynamo traces whatever a
    compiled function calls, marked or not."""
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    """Accepted for the reference's API; TorchDynamo decides what it
    traces."""


# ---------------------------------------------------------------------------
# save / load (reference: jit.py jit.save -> pdmodel + pdiparams;
# dygraph/io.py TranslatedLayer)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _plain_eval(layer):
    """The layer in eval mode, its forward the class's (not a to_static
    wrapper), for the duration."""
    was_training = layer.training
    static = {m: m.__dict__.pop('forward') for m in layer.modules()
              if isinstance(m.__dict__.get('forward'), StaticFunction)}
    layer.eval()
    try:
        yield
    finally:
        layer.train(was_training)
        for m, fwd in static.items():
            m.forward = fwd


class _Pure(torch.nn.Module):
    """layer's forward over (params, buffers, *inputs): the program takes
    the weights as arguments, as the JAX package lowers pure(params,
    buffers, *arrays), so the export holds no copy of them."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, 'layer', layer)  # not a submodule

    def forward(self, params, buffers, *inputs):
        return torch.func.functional_call(self.layer, (params, buffers),
                                          inputs)


def _export(layer, specs, params, buffers):
    """torch.export of the eval forward at the specs' shapes (unknown dims
    become 1), serialized; it runs as
    `program.module()(params, buffers, *inputs)`."""
    dev = next(iter(params.values())).device if params \
        else device_mod.resolve()
    examples = [torch.zeros(tuple(d if d and d > 0 else 1 for d in s.shape),
                            dtype=dtype_mod.torch_dtype(s.dtype), device=dev)
                for s in specs]
    with _plain_eval(layer), torch.no_grad():
        program = torch.export.export(_Pure(layer),
                                      (params, buffers, *examples),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save(layer, path, input_spec=None, **configs):
    """Export the weights, buffers and the eval forward of `layer`."""
    if not isinstance(layer, torch.nn.Module):
        raise TypeError('jit.save expects a Layer')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    params = {k: v.detach() for k, v in layer.named_parameters()}
    buffers = {k: v.detach() for k, v in layer.named_buffers()}
    io_save.save({'params': params, 'buffers': buffers},
                 path + '.pdiparams')

    # artifact versioning (reference: framework/op_version_registry.h +
    # framework/version.cc: saved programs carry versions and loads check
    # compatibility)
    from .. import __version__ as fw_version
    meta = {'input_spec': None, 'exported_program': None,
            'format_version': _FORMAT_VERSION,
            'framework_version': fw_version,
            'torch_version': torch.__version__,
            'op_versions': op_version.snapshot()}
    if input_spec:
        specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
                 for s in input_spec]
        meta['input_spec'] = [(tuple(s.shape), s.dtype,
                               s.name or 'input_%d' % i)
                              for i, s in enumerate(specs)]
        meta['exported_program'] = _export(layer, specs, params, buffers)

    # the architecture: the pickled layer without its weights (the class
    # must be importable where it loads, as with paddle.save of a Layer)
    try:
        arch = pickle.dumps(_strip_for_pickle(layer), protocol=4)
    except Exception:
        arch = None
    io_save.write_bytes_atomic(
        path + '.pdmodel',
        pickle.dumps({'meta': meta, 'arch': arch}, protocol=4))


def _strip_for_pickle(layer):
    """A copy of `layer` that pickles: every parameter and buffer a meta
    tensor of its shape and dtype (the weights travel in .pdiparams), no
    hooks, no to_static wrapper. The port's generate() keeps no compiled
    caches on the model, so there are none to drop."""
    memo = {}
    for t in list(layer.parameters()) + list(layer.buffers()):
        if id(t) in memo:
            continue
        m = torch.empty_like(t, device='meta')
        if isinstance(t, torch.nn.Parameter):
            m = torch.nn.Parameter(m, requires_grad=t.requires_grad)
            m.__dict__.update(t.__dict__)
        memo[id(t)] = m
    for mod in layer.modules():
        for name, value in vars(mod).items():
            if name.endswith('hooks') or 'hooks_' in name:
                memo[id(value)] = type(value)()
        fwd = mod.__dict__.get('forward')
        if isinstance(fwd, StaticFunction):
            memo[id(fwd)] = None
    copied = copy.deepcopy(layer, memo)
    for mod in copied.modules():
        if 'forward' in mod.__dict__ and mod.__dict__['forward'] is None:
            del mod.__dict__['forward']
    return copied


def _materialize(layer, params, buffers, device):
    """Put the saved tensors, on `device`, in the place of the meta tensors
    of an unpickled architecture (tied parameters stay tied, parameter
    attributes are kept)."""
    done = {}
    for mname, mod in layer.named_modules(remove_duplicate=False):
        for table, saved in ((mod._parameters, params),
                             (mod._buffers, buffers)):
            for name, t in list(table.items()):
                if t is None:
                    continue
                if id(t) not in done:
                    full = '%s.%s' % (mname, name) if mname else name
                    value = saved[full].detach().to(device)
                    if isinstance(t, torch.nn.Parameter):
                        value = torch.nn.Parameter(
                            value, requires_grad=t.requires_grad)
                        value.__dict__.update(t.__dict__)
                    done[id(t)] = value
                table[name] = done[id(t)]


class TranslatedLayer:
    """Runs a loaded layer (reference: dygraph/io.py TranslatedLayer)."""

    def __init__(self, layer, meta=None):
        self._layer = layer
        self._meta = meta or {}

    def __call__(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def eval(self):
        self._layer.eval()
        return self

    def train(self):
        self._layer.train()
        return self

    def parameters(self, *a, **k):
        return self._layer.parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layer.state_dict(*a, **k)

    def forward(self, *args, **kwargs):
        return self.__call__(*args, **kwargs)

    def exported_program(self):
        """The saved torch.export program (an input spec was given to
        save); it takes (params, buffers, *inputs)."""
        data = self._meta.get('exported_program')
        if data is None:
            raise ValueError('the artifact was saved without an input_spec: '
                             'it holds no exported program')
        return torch.export.load(io.BytesIO(data))

    def run_exported(self, *inputs):
        """The exported program on the loaded weights and `inputs`."""
        params = {k: v.detach() for k, v in self._layer.named_parameters()}
        buffers = {k: v.detach() for k, v in self._layer.named_buffers()}
        with torch.no_grad():
            return self.exported_program().module()(params, buffers, *inputs)


def load(path, device=None, **configs):
    """Load a jit.save artifact onto `device` (the current device when
    None: the card unless set_device('cpu'))."""
    with open(path + '.pdmodel', 'rb') as f:
        payload = pickle.load(f)
    meta = payload.get('meta') or {}
    fmt = meta.get('format_version')
    if fmt is not None and tuple(fmt)[0] > _FORMAT_VERSION[0]:
        raise RuntimeError(
            'artifact %s was saved by a NEWER framework (format %s, this '
            'build reads %s): upgrade paddle_tpu_torch to load it'
            % (path, tuple(fmt), _FORMAT_VERSION))
    if fmt is not None and tuple(fmt)[0] < _FORMAT_VERSION[0]:
        warnings.warn('artifact %s uses the older format %s (current %s); '
                      'loading with best-effort compatibility'
                      % (path, tuple(fmt), _FORMAT_VERSION))
    # per-op semantic versions (framework/op_version.py): refuse ops saved
    # at newer semantics
    op_version.check_compatible(meta.get('op_versions'), artifact=path)
    state = io_save.load(path + '.pdiparams')
    layer = None
    if payload.get('arch') is not None:
        layer = pickle.loads(payload['arch'])
        _materialize(layer, state['params'], state['buffers'],
                     device_mod.resolve(device))
    return TranslatedLayer(layer, meta=meta)


class ProgramTranslator:
    """Singleton facade (reference program_translator.py):
    `enable(False)` makes every to_static function run eagerly."""
    _instance = None
    _enabled = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static=True):
        ProgramTranslator._enabled = bool(enable_to_static)


def set_verbosity(level=0, also_to_stdout=False):
    """Transpiler diagnostics have no counterpart: TorchDynamo traces the
    Python itself (torch._logging sets its own logs)."""


def set_code_level(level=100, also_to_stdout=False):
    """As set_verbosity."""


class TracedLayer:
    """reference dygraph/jit.py TracedLayer: trace once, replay compiled."""

    def __init__(self, layer, inputs):
        self._layer = layer
        self._fn = to_static(layer.forward)
        self._example = inputs

    @staticmethod
    def trace(layer, inputs):
        t = TracedLayer(layer, inputs)
        return t._fn(*inputs), t

    def __call__(self, *args):
        return self._fn(*args)

    def save_inference_model(self, path, feed=None, fetch=None, **kw):
        save(self._layer, path, input_spec=self._example)
