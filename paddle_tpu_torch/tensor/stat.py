"""Statistics (counterpart of paddle_tpu/tensor/stat.py). Integer inputs
are taken as float32, as jnp takes them."""
import torch

from ._helpers import axes_arg, ensure_tensor, is_float
from .creation import numel
from .math import mean, sum  # noqa: F401

__all__ = ['mean', 'std', 'var', 'median', 'nanmedian', 'quantile',
           'nanquantile', 'numel']


def _float(x):
    x = ensure_tensor(x)
    return x if is_float(x) else x.to(torch.float32)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(x)
    return torch.var(x, dim=axes_arg(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(x)
    return torch.std(x, dim=axes_arg(axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    x = _float(x)
    ax = axes_arg(axis)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if ax is None:
        out = fn(x.reshape(-1), qt, dim=0)
        return out.reshape(qt.shape + (1,) * x.dim()) if keepdim else out
    if isinstance(ax, tuple):
        # the named axes moved to the end and flattened into one
        keep = [i for i in range(x.dim()) if i not in
                {a % x.dim() for a in ax}]
        moved = x.permute(*keep, *[a % x.dim() for a in ax])
        flat = moved.reshape(*[x.shape[i] for i in keep], -1)
        out = fn(flat, qt, dim=-1)
        if keepdim:
            for a in sorted(a % x.dim() for a in ax):
                out = out.unsqueeze(a + (qt.dim() > 0))
        return out
    return fn(x, qt, dim=ax, keepdim=keepdim)


# jnp.median averages the two middle values of an even count, as quantile
# 0.5 does; torch.median takes the lower one
def median(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)
