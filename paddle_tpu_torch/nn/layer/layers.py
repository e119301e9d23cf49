"""Parameter attributes (counterpart of ParamAttr and Layer.create_parameter
in paddle_tpu/nn/layer/layers.py, and of the Parameter fields of
paddle_tpu/framework/core.py).

A parameter is a torch nn.Parameter carrying the JAX package's metadata as
attributes: `optimize_attr` ({'learning_rate': multiplier of the
optimizer's rate}), `regularizer` (an L1Decay / L2Decay or None),
`need_clip` (whether gradient clipping sees it), `trainable` (False:
requires_grad is off) and `param_name` (ParamAttr's name, or None; torch
reserves `Tensor.name`). The optimizers read them with the JAX package's
defaults, so a parameter built without a ParamAttr behaves as one built
with the default attribute.
"""
import copy

from torch import nn

__all__ = ['ParamAttr', 'create_parameter', 'param_meta', 'copy_layer']

# the attributes a parameter carries beside its value: the metadata above,
# and the tensor-parallel placement hint (distributed/strategy.py)
_META = ('param_name', 'trainable', 'optimize_attr', 'regularizer',
         'need_clip', 'placement')


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the default; a ParamAttr as is; a str -> its name; an
        initializer -> its initializer; False -> False (no parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        if callable(attr):
            return ParamAttr(initializer=attr)
        return ParamAttr()


def create_parameter(shape, attr, dtype, default_initializer, generator,
                     device):
    """An nn.Parameter of `shape` drawn on the CPU by the attribute's
    initializer (else `default_initializer`) from `generator` and moved to
    `device`, with the attribute's metadata; None when attr is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer
    p = nn.Parameter(init(shape, dtype, generator).to(device),
                     requires_grad=bool(attr.trainable))
    p.param_name = attr.name
    p.trainable = bool(attr.trainable)
    p.optimize_attr = {'learning_rate': attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


def param_meta(p):
    """(learning-rate multiplier, regularizer, need_clip) of a parameter,
    with the defaults for a tensor that carries no metadata."""
    return (getattr(p, 'optimize_attr', {}).get('learning_rate', 1.0),
            getattr(p, 'regularizer', None), getattr(p, 'need_clip', True))


def copy_layer(layer):
    """A deep copy of `layer` whose parameters keep their metadata: torch's
    deep copy of an nn.Parameter drops its Python attributes, where the
    JAX package's copy of a Parameter keeps them."""
    out = copy.deepcopy(layer)
    for (_, src), (_, dst) in zip(layer.named_parameters(),
                                  out.named_parameters()):
        for key in _META:
            if hasattr(src, key):
                setattr(dst, key, copy.deepcopy(getattr(src, key)))
    return out
