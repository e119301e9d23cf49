"""Common layers (counterpart of paddle_tpu/nn/layer/common.py).

Parameters keep the JAX package's names and layouts (Linear.weight is
[in, out]), so a state dict carries across without transposes. Weights are
drawn on the CPU from the given generator and then moved to `device`.
`weight_attr` / `bias_attr` take a ParamAttr (layers.py) as in the JAX
package; bias_attr=False, like bias=False, builds no bias.
"""
from torch import nn

from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I
from .layers import create_parameter


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, device='cuda',
                 dtype='float32', generator=None, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        dev = device_mod.resolve(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter([in_features, out_features],
                                       weight_attr, dtype, I.XavierNormal(),
                                       generator, dev)
        self.bias = create_parameter(
            [out_features], bias_attr if bias else False, dtype,
            I.Constant(0.0), generator, dev)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return 'in_features=%d, out_features=%d' % (self.in_features,
                                                    self.out_features)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, device='cuda',
                 dtype='float32', generator=None, weight_attr=None):
        super().__init__()
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr, dtype,
            I.XavierNormal(), generator, device_mod.resolve(device))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self):
        return '%d, %d' % tuple(self.weight.shape)


class Dropout(nn.Module):
    """Dropout with its mask drawn from `generator` (torch's default
    generator for the input's device when None)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return 'p=%s' % self.p
