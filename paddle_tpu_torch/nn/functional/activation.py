"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
import torch

from ...amp.auto_cast import cast as amp_cast
from ...framework.dtype import to_torch_dtype


def gelu(x, approximate=False):
    """approximate=True is the tanh form that GPT's MLP uses."""
    x, = amp_cast('gelu', x)
    return torch.nn.functional.gelu(
        x, approximate='tanh' if approximate else 'none')


def softmax(x, axis=-1, dtype=None):
    """softmax over `axis`, in `dtype` when given."""
    x, = amp_cast('softmax', x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)
