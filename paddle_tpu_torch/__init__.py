"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and never jax or paddle_tpu. Entry points run on the card
(device='cuda') unless the caller passes device='cpu' or set_device('cpu')
changed the default. Kernels are built from csrc/ by nvcc at first use
(see _build.py).

The top-level names are the JAX package's (`import paddle_tpu_torch as
paddle`): the tensor functions, `to_tensor`, the dtypes (as torch dtypes),
`seed`, `save` / `load`, the flags and the rest. A tensor is a
torch.Tensor and a parameter an nn.Parameter. Every public top-level name
of the JAX package is here: the XPU / NPU places are place classes of
devices the port does not run on (placing a tensor on one raises), and
the Tensor-method patching functions are no-ops, as in the JAX package
(the port's tensors are torch's and already have their methods; nothing
in torch.Tensor changes).
"""
import sys as _sys

import torch as _torch

__version__ = '0.1.0'

from . import amp, framework, nn, ops, optimizer, text  # noqa: F401,E402
from . import data, hapi, io, metric, regularizer  # noqa: F401,E402
from . import autograd, inference, jit, static  # noqa: F401,E402
from . import distributed, monitor, profiler, tensor  # noqa: F401,E402
from . import incubate, slim, vision  # noqa: F401,E402
from . import dataset, distribution, hub, sysconfig, utils  # noqa: F401,E402
from . import onnx  # noqa: F401,E402
from .tensor import *  # noqa: F401,F403,E402
from .tensor import einsum  # noqa: F401,E402
from .tensor.creation import to_tensor  # noqa: F401,E402
from .tensor.logic import is_tensor  # noqa: F401,E402
from .batch import batch  # noqa: F401,E402
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401,E402
                       no_grad, set_grad_enabled)
from .distributed import DataParallel  # noqa: F401,E402
from .framework import device  # noqa: F401,E402
from .framework.device import (CPUPlace, CUDAPinnedPlace,  # noqa: F401,E402
                               CUDAPlace, NPUPlace, XPUPlace, device_count,
                               get_cudnn_version, get_device,
                               is_compiled_with_cuda, is_compiled_with_npu,
                               is_compiled_with_rocm, is_compiled_with_xpu,
                               set_device)
from .framework.dtype import (get_default_dtype,  # noqa: F401,E402
                              set_default_dtype)
from .framework.flags import get_flags, set_flags  # noqa: F401,E402
from .framework.io_save import load, save  # noqa: F401,E402
from .framework.random import get_rng_state, set_rng_state  # noqa: F401,E402
from .framework.random import manual_seed as seed  # noqa: F401,E402
from .hapi import Model, callbacks, flops, summary  # noqa: F401,E402
from .nn.layer.layers import ParamAttr  # noqa: F401,E402
from .static import (disable_static, enable_static,  # noqa: F401,E402
                     in_dynamic_mode)
from .static import create_parameter  # noqa: F401,E402

get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state

# `import paddle_tpu_torch.callbacks` / `.device` work as statements too
_sys.modules[__name__ + '.callbacks'] = callbacks
_sys.modules[__name__ + '.device'] = device

# the dtypes, as torch dtypes
float16 = _torch.float16
bfloat16 = _torch.bfloat16
float32 = _torch.float32
float64 = _torch.float64
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
uint8 = _torch.uint8
bool = _torch.bool
complex64 = _torch.complex64
complex128 = _torch.complex128
dtype = _torch.dtype

Tensor = _torch.Tensor
VarBase = _torch.Tensor
Parameter = _torch.nn.Parameter


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     linewidth=None, sci_mode=None):
    """torch.set_printoptions with the reference's arguments."""
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


class version:
    full_version = __version__
    major, minor, patch = 0, 1, 0
    rc = 0
    istaged = True
    commit = 'cuda-port'

    @staticmethod
    def show():
        print('paddle_tpu_torch', version.full_version)


# dygraph is the only mode of execution; the reference's switches are
# constants, as in the JAX package
def in_dygraph_mode():
    return True


def enable_dygraph(place=None):
    pass


def disable_dygraph():
    pass


enable_imperative = enable_dygraph
disable_imperative = disable_dygraph


def crop_tensor(x, shape=None, offsets=None, name=None):
    return tensor.manipulation.crop(x, shape=shape, offsets=offsets)


def monkey_patch_variable():
    """No-op, as in the JAX package: static Variables are recorded torch
    tensors, which already have their methods."""


def monkey_patch_math_varbase():
    """No-op, as in the JAX package: the port's tensors are torch tensors
    with torch's methods; torch.Tensor is left as it is."""
