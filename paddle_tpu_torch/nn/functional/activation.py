"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

Each casts its tensor inputs under auto_cast at its entry, by the JAX
package's op name. The draws of `rrelu` in training and of
`gumbel_softmax` come from `generator` (keyword-only; torch's default
generator of the input's device when None): JAX's threefry bits cannot be
reproduced, so they are compared with the JAX package's by distribution.
The in-place forms `relu_` / `tanh_` use torch's in-place ops.
"""
import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast as amp_cast
from ...framework.dtype import to_torch_dtype

__all__ = [
    'relu', 'relu6', 'relu_', 'elu', 'selu', 'celu', 'gelu', 'leaky_relu',
    'prelu', 'rrelu', 'sigmoid', 'hardsigmoid', 'hardswish', 'hardtanh',
    'hardshrink', 'softshrink', 'tanhshrink', 'softsign', 'softplus',
    'swish', 'silu', 'mish', 'tanh', 'tanh_', 'thresholded_relu',
    'log_sigmoid', 'maxout', 'softmax', 'log_softmax', 'gumbel_softmax',
    'glu',
]


def _generator(generator, device):
    if generator is not None:
        return generator
    if device.type == 'cuda':
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def _unary(op_name, fn):
    def op(x, name=None):
        x, = amp_cast(op_name, x)
        return fn(x)
    op.__name__ = op.__qualname__ = op_name
    return op


relu = _unary('relu', torch.relu)
relu6 = _unary('relu6', TF.relu6)
sigmoid = _unary('sigmoid', torch.sigmoid)
tanh = _unary('tanh', torch.tanh)
softsign = _unary('softsign', TF.softsign)
silu = _unary('silu', TF.silu)
log_sigmoid = _unary('log_sigmoid', TF.logsigmoid)
mish = _unary('mish', lambda x: x * torch.tanh(TF.softplus(x)))
tanhshrink = _unary('tanhshrink', lambda x: x - torch.tanh(x))


def relu_(x, name=None):
    return x.relu_()


def tanh_(x, name=None):
    return x.tanh_()


def elu(x, alpha=1.0, name=None):
    x, = amp_cast('elu', x)
    return TF.elu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x, = amp_cast('selu', x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x, = amp_cast('celu', x)
    return TF.celu(x, alpha)


def gelu(x, approximate=False, name=None):
    """The erf form by default; approximate=True is the tanh form that
    GPT's MLP uses."""
    x, = amp_cast('gelu', x)
    return TF.gelu(x, approximate='tanh' if approximate else 'none')


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = amp_cast('leaky_relu', x)
    return TF.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format='NCHW', name=None):
    """max(0, x) + weight * min(0, x), one weight or one a channel (axis 1
    for NCHW, the last axis otherwise)."""
    x, weight = amp_cast('prelu', x, weight)
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format == 'NCHW' else x.dim() - 1] = -1
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None, *, generator=None):
    """Negative inputs scaled by a slope drawn from U[lower, upper] for
    each element in training, by (lower + upper) / 2 in eval."""
    x, = amp_cast('rrelu', x)
    if training:
        r = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
            lower, upper, generator=_generator(generator, x.device))
        return torch.where(x > 0, x, r * x)
    return torch.where(x > 0, x, (lower + upper) / 2.0 * x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x, = amp_cast('hardsigmoid', x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x, = amp_cast('hardswish', x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = amp_cast('hardtanh', x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    x, = amp_cast('hardshrink', x)
    return torch.where(torch.abs(x) > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    x, = amp_cast('softshrink', x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def softplus(x, beta=1, threshold=20, name=None):
    x, = amp_cast('softplus', x)
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def swish(x, name=None):
    return silu(x)


def thresholded_relu(x, threshold=1.0, name=None):
    x, = amp_cast('thresholded_relu', x)
    return torch.where(x > threshold, x, 0.0)


def maxout(x, groups, axis=1, name=None):
    """The max over each run of `groups` channels along `axis`."""
    x, = amp_cast('maxout', x)
    ax = axis if axis >= 0 else x.dim() + axis
    shape = list(x.shape[:ax]) + [x.shape[ax] // groups, groups] + \
        list(x.shape[ax + 1:])
    return torch.amax(x.reshape(shape), dim=ax + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    """softmax over `axis`, in `dtype` when given."""
    x, = amp_cast('softmax', x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


softmax_ = softmax


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast('log_softmax', x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None, *,
                   generator=None):
    """softmax((x + g) / temperature) with Gumbel noise g; hard=True gives
    the one-hot of its argmax forward and the soft gradient backward."""
    x, = amp_cast('gumbel_softmax', x)
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        generator=_generator(generator, x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, dim=axis, keepdim=True), 1.0)
        y = (onehot - y).detach() + y
    return y


def glu(x, axis=-1, name=None):
    x, = amp_cast('glu', x)
    return TF.glu(x, axis)
