"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py, the two
that Linear, Embedding and the norms default to).

An initializer is a callable (shape, dtype, generator) -> CPU tensor. It
draws from the explicit torch.Generator it is given (torch's default CPU
generator when None); layers move the result to their device.
"""
import math

import torch

from ..framework.dtype import to_torch_dtype


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype='float32', generator=None):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype))


class XavierNormal:
    """Normal with std sqrt(2 / (fan_in + fan_out)) for a 2-D [in, out]
    weight."""

    def __call__(self, shape, dtype='float32', generator=None):
        fan_in, fan_out = shape
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        return (w * std).to(to_torch_dtype(dtype))
