"""The tensor functions (counterpart of paddle_tpu/tensor/): plain functions
on torch tensors, under the JAX package's names and arguments.

The JAX package attaches these functions to its Tensor as methods and
operators (`x.sum()`, `x + y`). The port's tensors are torch tensors, whose
methods are torch's; patching torch.Tensor would change every torch
program in the process, so the port attaches nothing: call the functions
(`tensor.sum(x)`) or torch's own methods.
"""
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .inplace import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from . import (attribute, creation, linalg, logic, manipulation,  # noqa: F401
               math, random, search, stat)
from . import inplace as _inplace

__all__ = sorted(set(attribute.__all__ + creation.__all__ + ['einsum'] +
                     _inplace.__all__ + linalg.__all__ + logic.__all__ +
                     manipulation.__all__ + math.__all__ + random.__all__ +
                     search.__all__ + stat.__all__))
