"""paddle.incubate (counterpart of paddle_tpu/incubate/): the
Mixture-of-Experts layers (moe.py), structured sparsity (asp.py), the
optimizer wrappers (optimizer.py), epoch-level auto-checkpoint
(auto_checkpoint.py), `recompute`, the segment ops, the `nn` and
`autograd` namespaces and `softmax_mask_fuse_upper_triangle`."""
import torch

from ..distributed.fleet.utils import recompute  # noqa: F401
from . import asp  # noqa: F401
from . import auto_checkpoint  # noqa: F401
from . import moe  # noqa: F401
from . import optimizer  # noqa: F401
from .moe import GShardMoE, SwitchMoE  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401


def _segment(op_name, data, segment_ids):
    """Shared body of segment_{sum,mean,max,min} (reference segment_pool
    op, paddle/fluid/operators/segment_pool_op.cc). segment_ids must be
    sorted non-negative ints; the segment count is read off the ids (a
    read back to the host, as in the JAX package), and an empty segment
    gives 0."""
    a = torch.as_tensor(data)
    ids = torch.as_tensor(segment_ids, device=a.device).long()
    num = int(ids.max().item()) + 1 if ids.shape[0] else 0
    shape = (num,) + tuple(a.shape[1:])
    if op_name in ('sum', 'mean'):
        s = a.new_zeros(shape).index_add(0, ids, a)
        if op_name == 'sum':
            return s
        cnt = a.new_zeros((num,)).index_add(0, ids, a.new_ones(a.shape[0]))
        cnt = torch.clamp_min(cnt, 1).reshape((-1,) + (1,) * (a.dim() - 1))
        return s / cnt
    index = ids.reshape((-1,) + (1,) * (a.dim() - 1)).expand_as(a)
    # include_self=False leaves an empty segment at its initial 0
    return a.new_zeros(shape).scatter_reduce(
        0, index, a, 'amax' if op_name == 'max' else 'amin',
        include_self=False)


def segment_sum(data, segment_ids, name=None):
    return _segment('sum', data, segment_ids)


def segment_mean(data, segment_ids, name=None):
    return _segment('mean', data, segment_ids)


def segment_max(data, segment_ids, name=None):
    return _segment('max', data, segment_ids)


def segment_min(data, segment_ids, name=None):
    return _segment('min', data, segment_ids)


class nn:
    """incubate.nn namespace: the fused layers are the framework's own
    layers (their attention already routes to the flash kernels)."""
    from ..nn.layer.transformer import (TransformerEncoderLayer as  # noqa: F401
                                        FusedTransformerEncoderLayer,
                                        MultiHeadAttention as
                                        FusedMultiHeadAttention)


def _inputs(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


class autograd:
    """incubate.autograd namespace, on torch.func."""

    @staticmethod
    def vjp(func, xs, v=None):
        """(func(*xs), [the vector-Jacobian product with v for each
        input]); v defaults to ones shaped as the output."""
        out, vjp_fn = torch.func.vjp(func, *_inputs(xs))
        grads = vjp_fn(torch.ones_like(out) if v is None else v)
        return out, list(grads)

    @staticmethod
    def jvp(func, xs, v=None):
        """(func(*xs), the Jacobian-vector product); every input takes
        the same tangent v (ones shaped as each input when None), as in
        the JAX package."""
        arrays = _inputs(xs)
        tangents = [v if v is not None else torch.ones_like(a)
                    for a in arrays]
        return torch.func.jvp(func, tuple(arrays), tuple(tangents))


def softmax_mask_fuse_upper_triangle(x):
    """Causal-masked softmax over the last dim in f32 (reference incubate
    op softmax_mask_fuse_upper_triangle). x: [B, H, N, N] attention
    scores."""
    n = x.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    s = torch.where(mask, x, -1e30)
    return torch.softmax(s.float(), dim=-1).to(x.dtype)
