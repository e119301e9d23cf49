"""Creation functions (counterpart of paddle_tpu/tensor/creation.py).

New tensors go to `device` (keyword-only; the current device when None).
A floating result without a dtype takes the default floating dtype
(framework/dtype.py); `arange` over ints gives int64.
"""
import numpy as np
import torch

from ._helpers import as_int, default_float, ensure_tensor, shape_arg, tdt
from ._helpers import as_tensor as _as_tensor
from ..framework import device as device_mod

__all__ = [
    'to_tensor', 'zeros', 'ones', 'full', 'zeros_like', 'ones_like',
    'full_like', 'arange', 'linspace', 'logspace', 'eye', 'empty',
    'empty_like', 'meshgrid', 'diag', 'diagflat', 'tril', 'triu', 'assign',
    'clone', 'numel', 'tril_indices', 'triu_indices', 'complex', 'as_tensor',
]


def _dtype(dtype):
    return tdt(dtype) if dtype is not None else default_float()


def _dev(device):
    return device_mod.resolve(device)


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A tensor of `data` on `place` (a device name, a torch.device or a
    CPUPlace / CUDAPlace; the current device when None). A tensor is
    copied. stop_gradient=False makes a floating result require grad."""
    dev = device_mod.resolve(getattr(place, 'device', place))
    if isinstance(data, torch.Tensor):
        t = data.detach().to(dev, copy=True)
        if dtype is not None:
            t = t.to(tdt(dtype))
    else:
        t = _as_tensor(data, dtype=dtype, device=dev)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def as_tensor(data, dtype=None):
    return to_tensor(data, dtype=dtype)


def zeros(shape, dtype=None, name=None, *, device=None):
    return torch.zeros(shape_arg(shape), dtype=_dtype(dtype),
                       device=_dev(device))


def ones(shape, dtype=None, name=None, *, device=None):
    return torch.ones(shape_arg(shape), dtype=_dtype(dtype),
                      device=_dev(device))


def full(shape, fill_value, dtype=None, name=None, *, device=None):
    return torch.full(shape_arg(shape), _value(fill_value),
                      dtype=_dtype(dtype), device=_dev(device))


def zeros_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.zeros_like(x, dtype=tdt(dtype) if dtype else None)


def ones_like(x, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.ones_like(x, dtype=tdt(dtype) if dtype else None)


def full_like(x, fill_value, dtype=None, name=None):
    x = ensure_tensor(x)
    return torch.full_like(x, _value(fill_value),
                           dtype=tdt(dtype) if dtype else None)


def empty(shape, dtype=None, name=None, *, device=None):
    """zeros, as in the JAX package (its arrays cannot be uninitialised)."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, *, device=None):
    start, end, step = _value(start), _value(end), _value(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, end, step))
        dtype = 'int64' if ints else None
    return torch.arange(start, end, step, dtype=_dtype(dtype),
                        device=_dev(device))


def linspace(start, stop, num, dtype=None, name=None, *, device=None):
    return torch.linspace(_value(start), _value(stop), as_int(num),
                          dtype=_dtype(dtype), device=_dev(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None, *,
             device=None):
    return torch.logspace(_value(start), _value(stop), as_int(num),
                          base=_value(base), dtype=_dtype(dtype),
                          device=_dev(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, *, device=None):
    n = as_int(num_rows)
    m = as_int(num_columns) if num_columns is not None else n
    return torch.eye(n, m, dtype=_dtype(dtype), device=_dev(device))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[ensure_tensor(a) for a in args],
                               indexing='ij'))


def diag(x, offset=0, padding_value=0, name=None):
    """A vector's diagonal matrix (off-diagonal `padding_value`) or a
    matrix's diagonal."""
    x = ensure_tensor(x)
    if padding_value == 0 or x.dim() == 2:
        return torch.diag(x, offset)
    n = x.shape[0] + abs(offset)
    out = torch.full((n, n), padding_value, dtype=x.dtype, device=x.device)
    return out + torch.diag(x, offset) - torch.diag(
        torch.full_like(x, padding_value), offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(ensure_tensor(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(ensure_tensor(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(ensure_tensor(x), diagonal)


def tril_indices(row, col=None, offset=0, dtype='int64', *, device=None):
    return torch.tril_indices(row, row if col is None else col, offset,
                              dtype=tdt(dtype), device=_dev(device))


def triu_indices(row, col=None, offset=0, dtype='int64', *, device=None):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=tdt(dtype), device=_dev(device))


def assign(x, output=None):
    """A copy of `x` (a tensor, a list or an array); with `output`, its
    values are written there (no grad flows into `output`'s old value)."""
    out = ensure_tensor(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return ensure_tensor(x).clone()


def numel(x, name=None):
    x = ensure_tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def complex(real, imag, name=None):
    real = ensure_tensor(real)
    return torch.complex(real, ensure_tensor(imag, real))
