"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py).
Each holds its arguments and calls its functional; PReLU holds a weight
(keyword-only `device`, `dtype`, as the other layers)."""
from torch import nn

from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter

__all__ = ['ReLU', 'ReLU6', 'ELU', 'SELU', 'CELU', 'GELU', 'LeakyReLU',
           'PReLU', 'RReLU', 'Sigmoid', 'Hardsigmoid', 'Hardswish',
           'Hardtanh', 'Hardshrink', 'Softshrink', 'Tanhshrink', 'Softsign',
           'Softplus', 'Swish', 'Silu', 'Mish', 'Tanh', 'ThresholdedReLU',
           'LogSigmoid', 'Maxout', 'Softmax', 'LogSoftmax', 'GLU']


def _simple(cls_name, fn_name):
    """A layer with no arguments but `name` over F.<fn_name>."""
    def __init__(self, name=None):
        nn.Module.__init__(self)

    def forward(self, x):
        return getattr(F, fn_name)(x)
    return type(cls_name, (nn.Module,), {
        '__init__': __init__, 'forward': forward,
        '__doc__': 'F.%s as a layer.' % fn_name})


ReLU = _simple('ReLU', 'relu')
ReLU6 = _simple('ReLU6', 'relu6')
Sigmoid = _simple('Sigmoid', 'sigmoid')
Tanh = _simple('Tanh', 'tanh')
Softsign = _simple('Softsign', 'softsign')
Silu = _simple('Silu', 'silu')
Swish = _simple('Swish', 'swish')
Mish = _simple('Mish', 'mish')
LogSigmoid = _simple('LogSigmoid', 'log_sigmoid')
Tanhshrink = _simple('Tanhshrink', 'tanhshrink')
Hardswish = _simple('Hardswish', 'hardswish')
Hardsigmoid = _simple('Hardsigmoid', 'hardsigmoid')


class _Args(nn.Module):
    """A layer over F.<_fn> with the arguments it was built with."""
    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, x):
        return getattr(F, self._fn)(x, *self._args)

    def extra_repr(self):
        return ', '.join(repr(a) for a in self._args)


class ELU(_Args):
    _fn = 'elu'

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class SELU(_Args):
    _fn = 'selu'

    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__(scale, alpha)


class CELU(_Args):
    _fn = 'celu'

    def __init__(self, alpha=1.0, name=None):
        super().__init__(alpha)


class GELU(_Args):
    _fn = 'gelu'

    def __init__(self, approximate=False, name=None):
        super().__init__(approximate)


class LeakyReLU(_Args):
    _fn = 'leaky_relu'

    def __init__(self, negative_slope=0.01, name=None):
        super().__init__(negative_slope)


class Hardtanh(_Args):
    _fn = 'hardtanh'

    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__(min, max)


class Hardshrink(_Args):
    _fn = 'hardshrink'

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Softshrink(_Args):
    _fn = 'softshrink'

    def __init__(self, threshold=0.5, name=None):
        super().__init__(threshold)


class Softplus(_Args):
    _fn = 'softplus'

    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__(beta, threshold)


class ThresholdedReLU(_Args):
    _fn = 'thresholded_relu'

    def __init__(self, threshold=1.0, name=None):
        super().__init__(threshold)


class Maxout(_Args):
    _fn = 'maxout'

    def __init__(self, groups, axis=1, name=None):
        super().__init__(groups, axis)


class Softmax(_Args):
    _fn = 'softmax'

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class LogSoftmax(_Args):
    _fn = 'log_softmax'

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class GLU(_Args):
    _fn = 'glu'

    def __init__(self, axis=-1, name=None):
        super().__init__(axis)


class PReLU(nn.Module):
    """F.prelu with a learned weight of `num_parameters` slopes, all
    `init` at the start."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None, *, device=None,
                 dtype='float32'):
        super().__init__()
        self._data_format = data_format
        self.weight = create_parameter(
            [num_parameters], weight_attr, dtype, I.Constant(init), None,
            device_mod.resolve(device))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(nn.Module):
    """F.rrelu: slopes drawn from `generator` in training."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator=None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training,
                       generator=self.generator)
