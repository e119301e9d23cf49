"""Comparison and logical functions (counterpart of
paddle_tpu/tensor/logic.py). Their outputs are bool and carry no grad."""
import torch

from ._helpers import ensure_tensor, promote

__all__ = [
    'equal', 'not_equal', 'less_than', 'less_equal', 'greater_than',
    'greater_equal', 'logical_and', 'logical_or', 'logical_xor', 'logical_not',
    'bitwise_and', 'bitwise_or', 'bitwise_xor', 'bitwise_not', 'is_empty',
    'is_tensor', 'allclose', 'isclose', 'equal_all',
]


def _cmp(op_name, fn):
    def op(x, y, name=None):
        return fn(*promote(x, y))
    op.__name__ = op.__qualname__ = op_name
    return op


equal = _cmp('equal', torch.eq)
not_equal = _cmp('not_equal', torch.ne)
less_than = _cmp('less_than', torch.lt)
less_equal = _cmp('less_equal', torch.le)
greater_than = _cmp('greater_than', torch.gt)
greater_equal = _cmp('greater_equal', torch.ge)
logical_and = _cmp('logical_and', torch.logical_and)
logical_or = _cmp('logical_or', torch.logical_or)
logical_xor = _cmp('logical_xor', torch.logical_xor)
bitwise_and = _cmp('bitwise_and', torch.bitwise_and)
bitwise_or = _cmp('bitwise_or', torch.bitwise_or)
bitwise_xor = _cmp('bitwise_xor', torch.bitwise_xor)


def logical_not(x, out=None, name=None):
    return torch.logical_not(ensure_tensor(x))


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(ensure_tensor(x))


def is_empty(x, name=None):
    x = ensure_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = promote(x, y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), float(rtol),
                                       float(atol), equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = promote(x, y)
    return torch.isclose(x, y.to(x.dtype), float(rtol), float(atol),
                         equal_nan)


def equal_all(x, y, name=None):
    x, y = promote(x, y)
    if tuple(x.shape) != tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return torch.all(torch.eq(x, y))
