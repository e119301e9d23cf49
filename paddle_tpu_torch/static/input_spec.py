"""InputSpec (counterpart of paddle_tpu/static/input_spec.py; reference:
python/paddle/static/input.py). The dtype is kept as its Paddle name."""
from ..framework import dtype as dtype_mod

__all__ = ['InputSpec']


class InputSpec:
    def __init__(self, shape, dtype='float32', name=None):
        self.shape = tuple(shape)
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return 'InputSpec(shape=%s, dtype=%s, name=%s)' % (
            self.shape, self.dtype, self.name)

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, 'name', None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)
