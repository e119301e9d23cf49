"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and never jax or paddle_tpu. Entry points run on the card
(device='cuda') unless the caller passes device='cpu'. Kernels are built
from csrc/ by nvcc at first use (see _build.py).
"""
from . import amp, framework, nn, ops, optimizer, text  # noqa: F401
from . import regularizer  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
