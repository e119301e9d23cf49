"""Normalisation layers (counterpart of paddle_tpu/nn/layer/norm.py).
`weight_attr` / `bias_attr` take a ParamAttr (layers.py); False builds no
weight or bias, as in the JAX package's LayerNorm."""
from torch import nn

from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, device='cuda',
                 dtype='float32', weight_attr=None, bias_attr=None):
        super().__init__()
        dev = device_mod.resolve(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = create_parameter(self.normalized_shape, weight_attr,
                                       dtype, I.Constant(1.0), None, dev)
        self.bias = create_parameter(self.normalized_shape, bias_attr,
                                     dtype, I.Constant(0.0), None, dev)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return 'normalized_shape=%s, epsilon=%s' % (self.normalized_shape,
                                                    self.epsilon)


class RMSNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-6, device='cuda',
                 dtype='float32', weight_attr=None):
        super().__init__()
        dev = device_mod.resolve(device)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = create_parameter(self.normalized_shape, weight_attr,
                                       dtype, I.Constant(1.0), None, dev)

    def forward(self, x):
        return F.rms_norm(x, self.normalized_shape, self.weight, self.epsilon)
