"""Weight regularizers (counterpart of paddle_tpu/regularizer.py).

`_append(grad, param)` adds the regularizer's term to a gradient. The
coefficient is a Python float, applied as the JAX package applies a weakly
typed scalar: rounded to the gradient's dtype first."""
import torch

__all__ = ['L1Decay', 'L2Decay']


def _weak(x, dtype):
    return float(torch.tensor(x, dtype=dtype))


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def _append(self, grad, param):
        return grad + _weak(self._coeff, grad.dtype) * torch.sign(param)


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def _append(self, grad, param):
        return grad + _weak(self._coeff, grad.dtype) * param


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
