"""einsum (counterpart of paddle_tpu/tensor/einsum.py)."""
import torch

from ._helpers import ensure_tensor

__all__ = ['einsum']


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return torch.einsum(equation, *[ensure_tensor(t) for t in operands])
