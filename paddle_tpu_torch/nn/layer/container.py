"""Container layers (counterpart of paddle_tpu/nn/layer/container.py):
Paddle's names and constructors over torch's containers, whose methods
(append, insert, extend, keys, items, values, update, pop, clear,
slicing) are the same."""
import collections

from torch import nn

__all__ = ['Sequential', 'LayerList', 'LayerDict', 'ParameterList']


class Sequential(nn.Sequential):
    """Sequential(*layers), Sequential(OrderedDict) or
    Sequential(*(name, layer) pairs)."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
        elif layers and all(isinstance(item, tuple) for item in layers):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)


class LayerList(nn.ModuleList):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    def __init__(self, parameters=None):
        super().__init__(parameters)
