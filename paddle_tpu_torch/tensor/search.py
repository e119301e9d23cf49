"""Search and sort functions (counterpart of paddle_tpu/tensor/search.py).
Indices are int64 and carry no grad; values keep theirs."""
import torch

from ._helpers import as_int, ensure_tensor, tdt
from .manipulation import (index_sample, index_select,  # noqa: F401
                           masked_select)

__all__ = [
    'argmax', 'argmin', 'argsort', 'sort', 'topk', 'where', 'nonzero',
    'index_select', 'masked_select', 'searchsorted', 'kthvalue', 'mode',
    'index_sample',
]


def _arg(fn, x, axis, keepdim, dtype):
    x = ensure_tensor(x)
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(tdt(dtype))


def argmax(x, axis=None, keepdim=False, dtype='int64', name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype='int64', name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    x = ensure_tensor(x)
    # stable, and descending as the ascending order of -x (the JAX
    # package's rule: ties keep their order both ways)
    return torch.argsort(-x if descending else x, dim=axis, stable=True)


def sort(x, axis=-1, descending=False, name=None):
    x = ensure_tensor(x)
    return torch.gather(x, axis, argsort(x, axis, descending))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    vals, idx = torch.topk(x, as_int(k), dim=-1 if axis is None
                           else int(axis), largest=largest, sorted=True)
    return vals, idx


def where(condition, x=None, y=None, name=None):
    cond = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(cond, as_tuple=True)
    like = x if isinstance(x, torch.Tensor) else y
    return torch.where(cond.bool(), ensure_tensor(x, like),
                       ensure_tensor(y, like))


def nonzero(x, as_tuple=False):
    x = ensure_tensor(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = ensure_tensor(sorted_sequence)
    return torch.searchsorted(s, ensure_tensor(values, s),
                              out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)
    idx = torch.argsort(x, dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.gather(x, axis, idx)
    if keepdim:
        return vals, idx
    return vals.squeeze(axis), idx.squeeze(axis)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest of equally
    frequent ones) and the first index where it occurs."""
    x = ensure_tensor(x)
    moved = torch.movedim(x, axis, -1)
    srt = torch.sort(moved, dim=-1).values
    # how often each sorted value occurs; argmax takes the first (the
    # smallest value) of the most frequent
    eq = (srt.unsqueeze(-1) == srt.unsqueeze(-2)).sum(-1)
    best = torch.argmax(eq, dim=-1, keepdim=True)
    vals = torch.gather(srt, -1, best)
    first = torch.argmax((moved == vals).to(torch.int8), dim=-1,
                         keepdim=True)
    vals, first = vals.squeeze(-1), first.squeeze(-1)
    if keepdim:
        vals, first = vals.unsqueeze(axis), first.unsqueeze(axis)
    return vals, first
