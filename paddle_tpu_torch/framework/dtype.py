"""Paddle-style dtype names over torch dtypes (counterpart of
paddle_tpu/framework/dtype.py, for the floating types the port uses)."""
import torch

_NAME2DTYPE = {
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
}


def to_torch_dtype(dtype):
    """The torch dtype of a name ('float32', 'bfloat16', 'float16') or of a
    torch dtype among them."""
    if isinstance(dtype, torch.dtype) and dtype in _NAME2DTYPE.values():
        return dtype
    if dtype in _NAME2DTYPE:
        return _NAME2DTYPE[dtype]
    raise TypeError('unsupported dtype: %r' % (dtype,))


# every Paddle dtype name (the JAX package's registry) and its torch dtype
_ALL_NAMES = {
    'bool': torch.bool, 'uint8': torch.uint8, 'int8': torch.int8,
    'int16': torch.int16, 'int32': torch.int32, 'int64': torch.int64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'float64': torch.float64,
    'complex64': torch.complex64, 'complex128': torch.complex128,
}
_ALIASES = {
    'float': 'float32', 'double': 'float64', 'half': 'float16',
    'int': 'int32', 'long': 'int64', 'bf16': 'bfloat16', 'fp16': 'float16',
    'fp32': 'float32', 'fp64': 'float64',
}


def convert_dtype(dtype):
    """The canonical Paddle name of a dtype given as a name, an alias, a
    torch dtype or a numpy dtype (the JAX package's convert_dtype); None
    stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        name = str(dtype).split('.')[-1]
    elif isinstance(dtype, str):
        name = dtype
    else:
        import numpy as np
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, '__name__', str(dtype))
    name = _ALIASES.get(name, name)
    if name not in _ALL_NAMES:
        raise TypeError('unsupported dtype: %r' % (dtype,))
    return name


def torch_dtype(dtype):
    """The torch dtype of any dtype convert_dtype takes."""
    return _ALL_NAMES[convert_dtype(dtype)]


# the floating dtype that creation functions and to_tensor give Python
# floats when no dtype is named (the JAX package's get_default_dtype);
# torch's own default dtype is left alone
_DEFAULT = {'dtype': 'float32'}


def set_default_dtype(d):
    """Make `d` (float16, bfloat16, float32 or float64, any spelling
    convert_dtype takes) the default floating dtype."""
    name = convert_dtype(d)
    if name not in ('float16', 'bfloat16', 'float32', 'float64'):
        raise TypeError('set_default_dtype only supports floating dtypes, '
                        'got %r' % (d,))
    _DEFAULT['dtype'] = name


def get_default_dtype():
    """The default floating dtype's name."""
    return _DEFAULT['dtype']
