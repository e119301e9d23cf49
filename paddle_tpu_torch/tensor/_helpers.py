"""Shared helpers of the tensor functions (counterpart of
paddle_tpu/tensor/_helpers.py).

The functions take and return torch tensors. Values that are not tensors
(Python scalars, lists, numpy arrays) become tensors on the device of the
tensor beside them, or on the current device (framework/device.py) when
there is none. The promotion rules are the JAX package's where torch's
differ: a Python scalar takes the dtype of the tensor it meets (so an int
tensor plus 2.5 stays int, as `jnp.asarray(2.5, int32)` truncates), and
`divide` of two integer tensors divides in float32.
"""
import numpy as np
import torch

from ..framework import device as device_mod
from ..framework import dtype as dtype_mod


def tdt(dtype):
    """The torch dtype of a Paddle dtype name, a numpy or a torch dtype."""
    return dtype_mod.torch_dtype(dtype)


def default_float():
    return tdt(dtype_mod.get_default_dtype())


def as_tensor(x, dtype=None, device=None):
    """`x` as a tensor: a tensor as it is (cast to `dtype` when given),
    else a new one on `device` (the current device when None). Python
    floats take the default floating dtype, Python ints int64, numpy
    arrays their own dtype."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(tdt(dtype))
    arr = np.asarray(x)
    t = torch.as_tensor(arr, device=device_mod.resolve(device))
    if dtype is not None:
        return t.to(tdt(dtype))
    if arr.dtype == np.float64 and not isinstance(x, (np.ndarray,
                                                      np.floating)):
        t = t.to(default_float())
    return t


def ensure_tensor(x, like=None):
    """`x` as a tensor, on `like`'s device when it is not one."""
    return as_tensor(x, device=like.device if isinstance(
        like, torch.Tensor) else None)


def promote(x, y):
    """The two operands of a binary function as tensors: a Python scalar
    beside a tensor becomes a 0-d tensor of that tensor's dtype and
    device (the JAX package's _promote)."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and not yt and not hasattr(y, 'shape'):
        y = torch.tensor(y, device=x.device).to(x.dtype)
    elif yt and not xt and not hasattr(x, 'shape'):
        x = torch.tensor(x, device=y.device).to(y.dtype)
    like = x if isinstance(x, torch.Tensor) else y
    return ensure_tensor(x, like), ensure_tensor(y, like)


def is_float(t):
    return t.is_floating_point() or t.is_complex()


def unary_op(name, fn, float_out=False):
    """A function of one tensor. float_out: an integer or bool input is
    taken as float32 first (the JAX functions that promote to inexact)."""
    def op(x, name=None):
        x = ensure_tensor(x)
        if float_out and not is_float(x):
            x = x.to(torch.float32)
        return fn(x)
    op.__name__ = op.__qualname__ = name
    return op


def binary_op(name, fn, int_to_float=False):
    """A function of two operands under `promote`. int_to_float: two
    integer operands are divided in float32 (the JAX package's divide)."""
    def op(x, y, name=None):
        xt, yt = promote(x, y)
        if int_to_float and not is_float(xt) and not is_float(yt):
            xt = xt.to(torch.float32)
        return fn(xt, yt)
    op.__name__ = op.__qualname__ = name
    return op


def as_int(v):
    """A Python int from an int or a one-element tensor."""
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def axes_arg(axis):
    """A Paddle axis argument (None, an int, a list or a tensor) as None,
    an int or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        vals = axis.flatten().tolist()
        return int(vals[0]) if axis.dim() == 0 else tuple(int(v)
                                                          for v in vals)
    if isinstance(axis, (list, tuple)):
        return tuple(as_int(v) for v in axis)
    return int(axis)


def dims(axis, ndim):
    """axes_arg for torch's reductions: every dim when None."""
    ax = axes_arg(axis)
    if ax is None:
        return tuple(range(ndim))
    return (ax,) if isinstance(ax, int) else ax


def shape_arg(shape):
    """A Paddle shape argument (a list of ints or tensors, a tensor, an int)
    as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.flatten().tolist())
    if isinstance(shape, (list, tuple)):
        return tuple(as_int(s) for s in shape)
    return (int(shape),)
