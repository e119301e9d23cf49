"""In-place function forms and the LoDTensorArray functions (counterpart of
paddle_tpu/tensor/inplace.py).

`add_(x, y)` and the rest update x with torch's in-place op and return it.
As in the JAX package, a leaf tensor that requires grad refuses (torch
raises). The arrays are Python lists, as in the JAX package.
"""
import torch

from . import manipulation as _manip
from . import math as _math
from ._helpers import ensure_tensor, promote

__all__ = ['add_', 'subtract_', 'clip_', 'ceil_', 'exp_', 'floor_',
           'reciprocal_', 'round_', 'rsqrt_', 'scale_', 'sqrt_',
           'flatten_', 'create_array', 'array_write', 'array_read',
           'array_length']


def add_(x, y, name=None):
    return x.add_(promote(x, y)[1])


def subtract_(x, y, name=None):
    return x.sub_(promote(x, y)[1])


def clip_(x, min=None, max=None, name=None):
    return x.clamp_(min, max)


def ceil_(x, name=None):
    return x.ceil_()


def exp_(x, name=None):
    return x.exp_()


def floor_(x, name=None):
    return x.floor_()


def reciprocal_(x, name=None):
    return x.reciprocal_()


def round_(x, name=None):
    return x.round_()


def rsqrt_(x, name=None):
    return x.rsqrt_()


def sqrt_(x, name=None):
    return x.sqrt_()


def scale_(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    """x rescaled in place (scale's arithmetic); returns x."""
    out = _math.scale(x, scale, bias, bias_after_scale, act)
    return x.copy_(out)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return _manip.reshape_(x, _manip.flatten(x.detach(), start_axis,
                                             stop_axis).shape)


def create_array(dtype='float32', initialized_list=None):
    return list(initialized_list or [])


def array_write(x, i, array=None):
    i = int(i.item()) if isinstance(i, torch.Tensor) else int(i)
    if array is None:
        array = create_array()
    while len(array) <= i:
        array.append(None)
    array[i] = ensure_tensor(x)
    return array


def array_read(array, i):
    i = int(i.item()) if isinstance(i, torch.Tensor) else int(i)
    return array[i]


def array_length(array):
    return ensure_tensor(len(array))
