"""The static graph's recorder (counterpart of the hooks `_fwd_recorder` /
`_param_recorder` in paddle_tpu/framework/core.py, which run_op calls).

The JAX package records each run_op. The port's layers are plain torch
modules, so the recorder sits on torch itself: a TorchFunctionMode sees
every torch call that Python code makes (torch functions, Tensor methods
and properties, torch.nn.functional, the custom ops such as
paddle_tpu_torch::flash_fwd) and runs it; a call the mode's handler makes
runs with the mode off, so the calls inside a recorded call (a custom op's
body, a functional's own torch calls) are not recorded again. Each call
that returns a tensor, or writes one in place, is kept as a `Call`
(function, args, kwargs, output).

`Recording.graph_module(inputs, outputs)` turns the calls into a
torch.fx.GraphModule that recomputes `outputs` from new values of
`inputs`:
- Only the calls that `outputs` need run: a call is needed when a needed
  tensor is one of its outputs, or when it writes in place into the
  storage of a needed tensor (views share their base's storage).
- Every tensor that no needed call produced is a constant of the module:
  nn.Parameters always (the module holds the parameter itself, so later
  in-place updates of its values show), other tensors as their values.
  A constant that a needed call writes in place is cloned first, so the
  replay never writes into a build-time tensor or a module's buffer.
- Writes into a parameter (its initialisation, an optimiser step) are
  never replayed, and neither is a write into a parameter's storage.
- Python values taken from tensors while the graph was built (`.item()`,
  shapes, a branch on a tensor's value) stay as they were, as in the JAX
  package. Factory calls (torch.arange, torch.zeros) replay as calls with
  no tensor input.
- The recording keeps every tensor it saw, so no tensor id is reused.
"""
import contextlib
import operator
import threading
import types

import torch
import torch.fx as fx
from torch.overrides import TorchFunctionMode

__all__ = ['Call', 'Recording', 'recording', 'paused', 'is_recording',
           'record', 'same_device']

# in-place operator methods; any other in-place call is named with a
# trailing underscore, writes `out=`, or passes inplace=True
_INPLACE_DUNDERS = frozenset(
    '__i%s__' % op for op in ('add', 'sub', 'mul', 'truediv', 'floordiv',
                              'mod', 'pow', 'and', 'or', 'xor', 'lshift',
                              'rshift', 'matmul'))
# calls that return a tensor but belong to autograd's or the host's
# bookkeeping, not to the computation
_NOT_RECORDED = frozenset(('requires_grad_', 'retain_grad', 'register_hook',
                           'backward', 'grad', 'detach_', 'share_memory_',
                           'record_stream', '__deepcopy__', '__reduce_ex__'))
# tensors made from host data: without a tensor argument their result is a
# constant of the graph, as the data it was made from is
_DATA_CONSTRUCTORS = frozenset(('tensor', 'as_tensor', 'asarray',
                                'from_numpy'))
# leaves an FX graph can spell as source text
_LITERALS = (bool, int, float, complex, str, torch.dtype, torch.layout,
             torch.memory_format)


def _name(func):
    """The call's name: a Tensor property's getter is named after the
    property."""
    if _property_getter(func):
        return func.__self__.__name__
    return getattr(func, '__name__', '') or ''


def _property_getter(func):
    return (isinstance(func, types.MethodWrapperType)
            and func.__name__ == '__get__'
            and isinstance(func.__self__, types.GetSetDescriptorType))


def _tensor_method(func, name):
    return any(getattr(cls, name, None) is func
               for cls in (torch.Tensor, torch._C.TensorBase))


def _leaves(x, out):
    """The tensors in a (nested) argument or result, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    return out


def _written(func, name, args, kwargs):
    """The tensors a call writes in place."""
    if kwargs.get('out') is not None:
        return _leaves(kwargs['out'], [])
    if isinstance(func, torch._ops.OpOverload):
        return [a for a, spec in zip(args, func._schema.arguments)
                if isinstance(a, torch.Tensor) and spec.alias_info is not None
                and spec.alias_info.is_write]
    first = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if first is None:
        return []
    if (name == '__setitem__' or name in _INPLACE_DUNDERS
            or kwargs.get('inplace') is True
            or (name.endswith('_') and not name.startswith('_'))):
        return [first]
    return []


def same_device(a, b):
    """True when device `a` is `b`, or `b` names a's type without an
    index (torch.device('cuda') for a tensor on cuda:0)."""
    return a.type == b.type and (b.index is None or a.index == b.index)


def _storage_key(t):
    """An id of t's storage (views share their base's), or None for a
    tensor without one (empty, or a tensor subclass without storage)."""
    try:
        if t.numel() == 0:
            return None
        return (t.device, t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):
        return None


class Call:
    """One recorded torch call and the tensors it read, made and wrote."""
    __slots__ = ('func', 'args', 'kwargs', 'out', 'ins', 'outs', 'written')

    def __init__(self, func, args, kwargs, out, written):
        self.func = func
        self.args = args
        self.kwargs = kwargs
        self.out = out
        self.ins = _leaves(args, _leaves(kwargs, []))
        self.outs = _leaves(out, [])
        self.written = written


class Recording:
    """An ordered list of recorded calls."""

    def __init__(self):
        self.calls = []

    def add(self, func, args, kwargs, out):
        name = _name(func)
        if name in _NOT_RECORDED or (name in _DATA_CONSTRUCTORS and
                                     not _leaves((args, kwargs), [])):
            return
        written = _written(func, name, args, kwargs)
        if any(isinstance(t, torch.nn.Parameter)
               or isinstance(t._base, torch.nn.Parameter) for t in written):
            return  # initialisation or an update of a parameter
        if not written and not isinstance(out, (torch.Tensor, list, tuple)):
            return
        call = Call(func, tuple(args), dict(kwargs), out, written)
        if call.outs or written:
            self.calls.append(call)

    def parameters(self):
        """The nn.Parameters that recorded calls read, in first-use order."""
        seen, out = set(), []
        for c in self.calls:
            for t in c.ins:
                if isinstance(t, torch.nn.Parameter) and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def _needed(self, inputs, outputs):
        """Indices of the calls that recompute `outputs` from `inputs`."""
        param_storage = {_storage_key(t) for c in self.calls
                         for t in c.ins + c.outs
                         if isinstance(t, torch.nn.Parameter)}
        fresh = {id(t) for t in inputs}
        live = {id(t) for t in outputs}
        storages = {_storage_key(t) for t in outputs} - param_storage
        storages.discard(None)
        needed = []
        for i in range(len(self.calls) - 1, -1, -1):
            c = self.calls[i]
            makes = any(id(t) in live and id(t) not in fresh
                        and not isinstance(t, torch.nn.Parameter)
                        for t in c.outs)
            writes = any(_storage_key(t) in storages for t in c.written)
            if not (makes or writes):
                continue
            needed.append(i)
            for t in c.ins:
                if isinstance(t, torch.nn.Parameter) or id(t) in fresh:
                    continue
                live.add(id(t))
                key = _storage_key(t)
                if key is not None and key not in param_storage:
                    storages.add(key)
        return needed[::-1]

    def graph_module(self, inputs, outputs, device=None):
        """An fx.GraphModule computing `outputs` (a tuple) from `inputs`,
        its constants on `device` (where they are when None). Raises when
        an output is neither an input nor made by a recorded call."""
        needed = self._needed(inputs, outputs)
        return _Builder(self.calls, needed, device).build(inputs, outputs)


class _Builder:
    def __init__(self, calls, needed, device):
        self.calls = [calls[i] for i in needed]
        self.device = device
        self.graph = fx.Graph()
        self.root = torch.nn.Module()
        self.env = {}
        self.consts = {}
        self.objects = {}
        self.written = {_storage_key(t) for c in self.calls
                        for t in c.written} - {None}

    def _register(self, value):
        name = '_const%d' % (len(self.consts) + len(self.objects))
        if isinstance(value, torch.nn.Parameter):
            self.root.register_parameter(name, value)
        elif isinstance(value, torch.Tensor):
            self.root.register_buffer(name, value)
        elif isinstance(value, torch.nn.Module):
            self.root.add_module(name, value)
        else:
            setattr(self.root, name, value)
        return name

    def _const(self, t):
        node = self.consts.get(id(t))
        if node is None:
            value = t
            if self.device is not None and \
                    not same_device(t.device, self.device):
                value = t.detach().to(self.device)
                if isinstance(t, torch.nn.Parameter):
                    value = torch.nn.Parameter(value, t.requires_grad)
            elif not isinstance(t, torch.nn.Parameter):
                value = t.detach()
            node = self.graph.get_attr(self._register(value))
            if _storage_key(t) in self.written:
                node = self.graph.call_function(torch.clone, (node,))
            self.consts[id(t)] = node
        return node

    def _object(self, obj):
        """The name of a non-tensor object the graph refers to (a branch's
        module, a generator), registered on the module once."""
        name = self.objects.get(id(obj))
        if name is None:
            name = self.objects[id(obj)] = self._register(obj)
        return name

    def _arg(self, x):
        if isinstance(x, torch.Tensor):
            node = self.env.get(id(x))
            return node if node is not None else self._const(x)
        if type(x) in (list, tuple):
            return type(x)(self._arg(v) for v in x)
        if isinstance(x, torch.Size):
            return x
        if type(x) is dict:
            return {k: self._arg(v) for k, v in x.items()}
        if isinstance(x, slice):
            return slice(self._arg(x.start), self._arg(x.stop),
                         self._arg(x.step))
        if isinstance(x, torch.device):
            if self.device is None or same_device(x, self.device):
                return x
            return self.device
        if x is None or x is Ellipsis or isinstance(x, _LITERALS):
            return x
        return self.graph.get_attr(self._object(x))

    def _node(self, call):
        func, name = call.func, _name(call.func)
        args = self._arg(call.args)
        kwargs = self._arg(call.kwargs)
        g = self.graph
        if isinstance(func, torch.nn.Module):
            return g.call_module(self._object(func), args, kwargs)
        if _property_getter(func):
            return g.call_function(getattr, (args[0], name))
        if name == '__getitem__' and _tensor_method(func, name):
            return g.call_function(operator.getitem, args, kwargs)
        if name == '__setitem__' and _tensor_method(func, name):
            return g.call_function(operator.setitem, args, kwargs)
        if name and _tensor_method(func, name):
            return g.call_method(name, args, kwargs)
        return g.call_function(func, args, kwargs)

    def _bind(self, out, node):
        """Map each tensor of a call's result to its node."""
        if isinstance(out, torch.Tensor):
            self.env[id(out)] = node
        elif isinstance(out, (list, tuple)):
            for i, v in enumerate(out):
                if _leaves(v, []):
                    self._bind(v, self.graph.call_function(operator.getitem,
                                                           (node, i)))

    def build(self, inputs, outputs):
        for i, t in enumerate(inputs):
            self.env[id(t)] = self.graph.placeholder('feed_%d' % i)
        for call in self.calls:
            self._bind(call.out, self._node(call))
        missing = [i for i, t in enumerate(outputs) if id(t) not in self.env]
        if missing:
            raise RuntimeError(
                'fetch target(s) %s were not produced by any recorded op of '
                'this Program — fetch tensors must be built inside the '
                'program_guard scope' % missing)
        self.graph.output(tuple(self.env[id(t)] for t in outputs))
        return fx.GraphModule(self.root, self.graph)


# -- the mode -----------------------------------------------------------------

_local = threading.local()


def _sinks():
    sinks = getattr(_local, 'sinks', None)
    if sinks is None:
        sinks = _local.sinks = []
        _local.depth = 0
    return sinks


class _RecordMode(TorchFunctionMode):
    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        sinks = _sinks()
        if sinks and sinks[-1] is not None:
            sinks[-1].add(func, args, kwargs, out)
        return out


def is_recording():
    sinks = _sinks()
    return bool(sinks) and sinks[-1] is not None


def record(func, args, kwargs, out):
    """Record one call by hand (a call that ran with the recorder paused,
    such as static.nn's control flow over its recorded branches)."""
    if is_recording():
        _sinks()[-1].add(func, args, kwargs, out)


@contextlib.contextmanager
def recording(sink):
    """Record the torch calls of this thread into `sink` (an object with
    add(func, args, kwargs, out)) until the block ends; an inner
    recording takes the calls of its block from the outer one."""
    sinks = _sinks()
    sinks.append(sink)
    mode = None
    if _local.depth == 0:
        mode = _RecordMode()
        mode.__enter__()
    _local.depth += 1
    try:
        yield sink
    finally:
        _local.depth -= 1
        if mode is not None:
            mode.__exit__(None, None, None)
        sinks.pop()


@contextlib.contextmanager
def paused():
    """Record nothing until the block ends; the mode itself steps off the
    stack when it is on top, so a compiler tracing the block never sees
    it."""
    sinks = _sinks()
    sinks.append(None)
    try:
        stack = torch.overrides._get_current_function_mode_stack()
        if stack and isinstance(stack[-1], _RecordMode):
            with torch.overrides._pop_mode_temporarily():
                yield
        else:
            yield
    finally:
        sinks.pop()
