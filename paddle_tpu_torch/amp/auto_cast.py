"""auto_cast (counterpart of paddle_tpu/amp/auto_cast.py): Paddle's
allow / block lists, not torch.autocast's.

The JAX package casts in its op runner: every op passes its name and input
arrays through `amp_cast_inputs`. The port has no op runner, so each port
functional casts its tensor inputs at its entry, under the op name the JAX
functional passes to its runner (`cast(name, *tensors)`). Under O1 the
white-listed ops take floating inputs in the AMP dtype and every other op
takes 16-bit inputs in f32; under O2 every op but the black-listed ones
takes the AMP dtype. The casts are differentiable: gradients return in
each input's own dtype.
"""
import contextlib

import torch

__all__ = ['auto_cast', 'amp_guard', 'white_list', 'black_list',
           'amp_cast_inputs', 'cast']

# the JAX package's lists (its amp/auto_cast.py, from Paddle's
# imperative/amp_auto_cast.cc)
WHITE_LIST = {'conv2d', 'matmul', 'matmul_v2', 'mul', 'linear', 'conv1d',
              'conv3d', 'einsum', 'bmm', 'mm'}
BLACK_LIST = {'exp', 'square', 'log', 'mean', 'sum', 'cos_sim',
              'softmax_with_cross_entropy', 'cross_entropy',
              'layer_norm', 'batch_norm', 'softmax', 'log_softmax'}

_STATE = {'enabled': False, 'dtype': 'float16', 'level': 'O1',
          'custom_white': set(), 'custom_black': set()}

_LOW = (torch.float16, torch.bfloat16)
_DTYPES = {'float16': torch.float16, 'bfloat16': torch.bfloat16,
           'float32': torch.float32}


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).split('.')[-1]
    if dtype not in _DTYPES:
        raise TypeError('unsupported AMP dtype: %r' % (dtype,))
    return dtype


def white_list():
    return (WHITE_LIST | _STATE['custom_white']) - _STATE['custom_black']


def black_list():
    return (BLACK_LIST | _STATE['custom_black']) - _STATE['custom_white']


def amp_state():
    return _STATE


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level='O1', dtype='float16'):
    name = _dtype_name(dtype)  # before any change: a bad dtype raises
    prev = dict(_STATE)
    _STATE['enabled'] = enable
    _STATE['dtype'] = name
    _STATE['level'] = level
    _STATE['custom_white'] = set(custom_white_list or ())
    _STATE['custom_black'] = set(custom_black_list or ())
    try:
        yield
    finally:
        _STATE.update(prev)


amp_guard = auto_cast


@contextlib.contextmanager
def restore_state(state):
    """Run under a copy of the state `amp_state()` gave earlier: a
    recompute in the backward replays its forward under the casts the
    forward had (the JAX package's checkpoint keeps them in its trace)."""
    prev = dict(_STATE)
    _STATE.update(state)
    try:
        yield
    finally:
        _STATE.update(prev)


def amp_cast_inputs(op_name, tensors):
    """The inputs of op `op_name` as the JAX package's runner casts them
    (None and non-floating entries pass through)."""
    if not _STATE['enabled']:
        return list(tensors)
    if _STATE['level'] == 'O2':
        cast_it = op_name not in black_list()
    else:
        cast_it = op_name in white_list()
    if not cast_it:
        # every op off the cast list computes in f32
        return [t.float() if t is not None and t.dtype in _LOW else t
                for t in tensors]
    target = _DTYPES[_STATE['dtype']]
    return [t.to(target) if t is not None and t.is_floating_point() else t
            for t in tensors]


def cast(op_name, *tensors):
    """A functional's entry: its inputs, cast when auto_cast is on."""
    if _STATE['enabled']:
        return amp_cast_inputs(op_name, tensors)
    return tensors
