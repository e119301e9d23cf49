"""Normalisation layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from torch import nn

from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, device='cuda',
                 dtype='float32'):
        super().__init__()
        dev = device_mod.resolve(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            I.Constant(1.0)(self.normalized_shape, dtype).to(dev))
        self.bias = nn.Parameter(
            I.Constant(0.0)(self.normalized_shape, dtype).to(dev))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return 'normalized_shape=%s, epsilon=%s' % (self.normalized_shape,
                                                    self.epsilon)


class RMSNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-6, device='cuda',
                 dtype='float32'):
        super().__init__()
        dev = device_mod.resolve(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            I.Constant(1.0)(self.normalized_shape, dtype).to(dev))

    def forward(self, x):
        return F.rms_norm(x, self.normalized_shape, self.weight, self.epsilon)
