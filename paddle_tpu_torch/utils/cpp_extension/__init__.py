"""C++ custom-op extensions: JIT compile, load, and register (counterpart
of paddle_tpu/utils/cpp_extension/).

Parity: python/paddle/utils/cpp_extension/ (load(), CppExtension,
BuildExtension over setuptools) + framework/custom_operator.cc:511,867
(LoadOpMetaInfoAndRegisterOp). The sources build with g++ against the
port's copy of include/pd_extension.h, whose C ABI is the JAX package's,
so one source builds for either package. Each host C++ kernel becomes a
torch.library custom op (traceable by torch.compile through its fake
implementation) and an optional grad kernel its autograd formula: the
port's counterpart of the JAX package's pure_callback inside custom_vjp.
"""
from .extension_utils import (CppExtension, CUDAExtension, BuildExtension,
                              get_include_dir, load, load_op_library, setup)

__all__ = ['load', 'load_op_library', 'setup', 'CppExtension',
           'CUDAExtension', 'BuildExtension', 'get_include_dir']
