"""Autograd public API (counterpart of paddle_tpu/autograd/; reference:
python/paddle/autograd/).

`backward` and `grad` run torch's autograd; `PyLayer` is a
torch.autograd.Function built for each subclass. `grad` leaves every
`.grad` as it found it, which is where the JAX package's stash and restore
of its inputs' `.grad` ends. Higher-order gradients (create_graph=True)
raise NotImplementedError, as in the JAX package.
"""
import torch

__all__ = ['backward', 'grad', 'no_grad', 'enable_grad', 'PyLayer',
           'PyLayerContext', 'is_grad_enabled', 'set_grad_enabled']

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
set_grad_enabled = torch.set_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of `tensors` into the leaves' `.grad`."""
    tensors = _as_list(tensors)
    grads = None if grad_tensors is None else _as_list(grad_tensors)
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    without touching any `.grad`. An input that `outputs` do not depend on
    gets zeros, or None with allow_unused=True (the JAX package's
    contract). The graph is kept unless retain_graph=False."""
    if create_graph:
        raise NotImplementedError(
            'create_graph=True (higher-order gradients) is not supported, '
            'as in paddle_tpu.autograd.grad')
    outs = _as_list(outputs)
    ins = _as_list(inputs)
    gouts = None if grad_outputs is None else _as_list(grad_outputs)
    retain = True if retain_graph is None else retain_graph
    got = torch.autograd.grad(outs, ins, grad_outputs=gouts,
                              retain_graph=retain, allow_unused=True)
    if allow_unused:
        return list(got)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(ins, got)]


class PyLayerContext:
    """What a PyLayer's forward hands its backward: `save_for_backward` /
    `saved_tensor()`, and `container` for anything else."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = []
        self.container = None

    def save_for_backward(self, *tensors):
        if self._ctx is not None:
            self._ctx.save_for_backward(*tensors)
        else:
            self._saved = list(tensors)

    def saved_tensor(self):
        if self._ctx is not None:
            return list(self._ctx.saved_tensors)
        return self._saved


def _function_for(cls):
    """The torch.autograd.Function that runs PyLayer subclass `cls`."""
    fn = cls.__dict__.get('_torch_function')
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        ctx.pylayer = PyLayerContext(ctx)
        ctx.tensor_pos = [i for i, a in enumerate(args)
                          if torch.is_tensor(a)]
        ctx.nargs = len(args)
        return cls.forward(ctx.pylayer, *args, **kwargs)

    def backward(ctx, *grads):
        got = cls.backward(ctx.pylayer, *grads)
        got = _as_list(got)
        if len(got) != len(ctx.tensor_pos):
            raise ValueError(
                '%s.backward returned %d gradients for %d tensor inputs'
                % (cls.__name__, len(got), len(ctx.tensor_pos)))
        out = [None] * ctx.nargs
        for pos, g in zip(ctx.tensor_pos, got):
            out[pos] = g
        return (None, *out)

    fn = type(cls.__name__ + 'Function', (torch.autograd.Function,),
              {'forward': staticmethod(forward),
               'backward': staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """A custom op with a user-written forward and backward (reference:
    python/paddle/autograd/py_layer.py). The forward runs without
    recording; the backward returns one gradient per tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_for(cls).apply(kwargs, *args)


class LegacyPyLayer(PyLayer):
    pass


class backward_mode:
    """reference autograd/backward_mode.py: backward(tensors, grads)."""

    @staticmethod
    def backward(tensors, grad_tensors=None, retain_graph=False):
        tensors = _as_list(tensors)
        grads = grad_tensors or [None] * len(tensors)
        for t, g in zip(tensors, grads):
            t.backward(g, retain_graph=retain_graph)
