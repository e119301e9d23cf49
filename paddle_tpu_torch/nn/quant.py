"""paddle.nn.quant (counterpart of paddle_tpu/nn/quant.py; reference:
python/paddle/nn/quant/quant_layers.py): the fake-quant layer family,
whose implementations live in slim.quant_layers (one source of truth for
QAT, PTQ and this namespace).
"""
from ..slim import quant_layers  # noqa: F401
from ..slim.quant_layers import *  # noqa: F401,F403
from ..slim.quant_layers import QUANT_LAYER_MAP  # noqa: F401
