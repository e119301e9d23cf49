"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and never jax or paddle_tpu. Entry points run on the card
(device='cuda') unless the caller passes device='cpu' or set_device('cpu')
changed the default. Kernels are built from csrc/ by nvcc at first use
(see _build.py).
"""
__version__ = '0.1.0'

from . import amp, framework, nn, ops, optimizer, text  # noqa: F401
from . import data, hapi, io, metric, regularizer  # noqa: F401
from . import autograd, inference, jit, static  # noqa: F401
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                       no_grad, set_grad_enabled)
from .framework.device import (device_count, get_device,  # noqa: F401
                               set_device)
from .framework.random import get_rng_state, set_rng_state  # noqa: F401
from .hapi import Model  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
