"""paddle.sysconfig parity (counterpart of paddle_tpu/sysconfig.py).

get_include() is the directory that holds the port's pd_extension.h, the
header custom C++ ops build against (utils.cpp_extension). The JAX
package's points at a paddle_tpu/include that does not exist.
"""
import os


def get_include():
    from .utils.cpp_extension import get_include_dir
    return get_include_dir()


def get_lib():
    return os.path.join(os.path.dirname(__file__), 'lib')
