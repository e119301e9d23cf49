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
