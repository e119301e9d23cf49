"""Attribute functions (counterpart of paddle_tpu/tensor/attribute.py)."""
import torch

from ._helpers import ensure_tensor

__all__ = ['shape', 'rank', 'is_floating_point', 'is_integer', 'is_complex',
           'real', 'imag']


def shape(input):
    """The shape as an int32 tensor."""
    x = ensure_tensor(input)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(input):
    x = ensure_tensor(input)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def is_floating_point(x):
    return ensure_tensor(x).is_floating_point()


def is_integer(x):
    x = ensure_tensor(x)
    return not x.is_floating_point() and not x.is_complex() and \
        x.dtype != torch.bool


def is_complex(x):
    return ensure_tensor(x).is_complex()


def real(x, name=None):
    x = ensure_tensor(x)
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    x = ensure_tensor(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)
