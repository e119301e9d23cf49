"""paddle.incubate (counterpart of paddle_tpu/incubate/): the Mixture-of-
Experts layers (moe.py). The JAX package's other incubate names are not
ported yet and raise an AttributeError naming their ROADMAP item."""
from . import moe  # noqa: F401
from .moe import GShardMoE, SwitchMoE  # noqa: F401

_ABSENT = ('asp', 'auto_checkpoint', 'optimizer', 'LookAhead',
           'ModelAverage', 'recompute', 'segment_sum', 'segment_mean',
           'segment_max', 'segment_min', 'nn', 'autograd',
           'softmax_mask_fuse_upper_triangle')


def __getattr__(name):
    if name in _ABSENT:
        raise AttributeError(
            'paddle_tpu_torch.incubate.%s is not ported yet (ROADMAP Queue '
            '1 item 5, breadth: the rest of incubate/)' % name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
