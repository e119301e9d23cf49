"""Shape and layout functions (counterpart of
paddle_tpu/tensor/manipulation.py).

The trailing-underscore forms change their input in place with torch's
in-place ops and return it.
"""
import builtins

import numpy as np
import torch

from ._helpers import (as_int, axes_arg, ensure_tensor, shape_arg, tdt)

__all__ = [
    'reshape_', 'squeeze_', 'unsqueeze_', 'scatter_',
    'reshape', 'transpose', 'concat', 'stack', 'unstack', 'split', 'chunk',
    'squeeze', 'unsqueeze', 'flatten', 'gather', 'gather_nd', 'scatter',
    'scatter_nd', 'scatter_nd_add', 'tile', 'expand', 'expand_as',
    'broadcast_to', 'broadcast_tensors', 'flip', 'roll', 'cast', 'slice',
    'strided_slice', 'unique', 'unique_consecutive', 'masked_select',
    'index_select', 'index_sample', 'take_along_axis', 'put_along_axis',
    'tensordot', 'moveaxis', 'rot90', 'as_complex', 'as_real',
    'repeat_interleave', 'tolist', 'crop', 'fill_diagonal_', 'unbind',
    'atleast_1d', 'atleast_2d', 'atleast_3d', 'shard_index',
]

builtin_slice = builtins.slice


def cast(x, dtype):
    return ensure_tensor(x).to(tdt(dtype))


def reshape(x, shape, name=None):
    return torch.reshape(ensure_tensor(x), shape_arg(shape))


def transpose(x, perm=None, name=None):
    x = ensure_tensor(x)
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*[int(p) for p in perm])


def t(x, name=None):
    x = ensure_tensor(x)
    if x.dim() > 2:
        raise ValueError('paddle.t only supports ndim<=2')
    return x.t() if x.dim() == 2 else x


def moveaxis(x, source, destination, name=None):
    return torch.movedim(ensure_tensor(x), source, destination)


def concat(x, axis=0, name=None):
    ts = list(x)
    like = next((a for a in ts if isinstance(a, torch.Tensor)), None)
    return torch.cat([ensure_tensor(a, like) for a in ts], dim=as_int(axis))


def stack(x, axis=0, name=None):
    ts = list(x)
    like = next((a for a in ts if isinstance(a, torch.Tensor)), None)
    return torch.stack([ensure_tensor(a, like) for a in ts], dim=axis)


def unstack(x, axis=0, num=None):
    return list(torch.unbind(ensure_tensor(x), dim=axis))


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    """num_or_sections: a count of equal parts, or the sizes of the parts
    (one may be -1: the rest)."""
    x = ensure_tensor(x)
    ax = as_int(axis)
    if isinstance(num_or_sections, int):
        if x.shape[ax] % num_or_sections:
            raise ValueError('split: axis of size %d into %d equal parts'
                             % (x.shape[ax], num_or_sections))
        return list(torch.split(x, x.shape[ax] // num_or_sections, dim=ax))
    secs = [as_int(s) for s in num_or_sections]
    known = builtins.sum(s for s in secs if s != -1)
    secs = [s if s != -1 else x.shape[ax] - known for s in secs]
    return list(torch.split(x, secs, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def squeeze(x, axis=None, name=None):
    """Drop the named axes of size 1 (others named are kept), or every
    axis of size 1."""
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if ax is None:
        return torch.squeeze(x)
    ax = (ax,) if isinstance(ax, int) else ax
    real = tuple(i for i in ax if x.shape[i] == 1)
    return torch.squeeze(x, real) if real else x


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    for i in sorted((ax,) if isinstance(ax, int) else ax):
        x = torch.unsqueeze(x, i)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def gather(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index, x).long()
    ax = 0 if axis is None else as_int(axis)
    return torch.index_select(x, ax, idx.reshape(-1))


def gather_nd(x, index, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index, x).long()
    return x[tuple(torch.movedim(idx, -1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of x set to `updates` (overwrite) or to the sum of the
    updates that name them."""
    x = ensure_tensor(x)
    up = ensure_tensor(updates, x).to(x.dtype)
    idx = ensure_tensor(index, x).long().reshape(-1)
    if overwrite:
        return x.index_put((idx,), up)
    return x.index_put((idx,), torch.zeros_like(up)).index_put(
        (idx,), up, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index, x).long()
    return x.index_put(tuple(torch.movedim(idx, -1, 0)),
                       ensure_tensor(updates, x).to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    up = ensure_tensor(updates)
    return scatter_nd_add(torch.zeros(shape_arg(shape), dtype=up.dtype,
                                      device=up.device), index, up)


def tile(x, repeat_times, name=None):
    return torch.tile(ensure_tensor(x), shape_arg(repeat_times))


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    shp = list(shape_arg(shape))
    off = len(shp) - x.dim()
    for i in range(len(shp)):
        if shp[i] == -1:
            shp[i] = x.shape[i - off] if i >= off else 1
    return x.expand(*shp)


def expand_as(x, y, name=None):
    return expand(x, ensure_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(input, name=None):
    return list(torch.broadcast_tensors(*[ensure_tensor(t) for t in input]))


def flip(x, axis, name=None):
    ax = axes_arg(axis)
    return torch.flip(ensure_tensor(x), (ax,) if isinstance(ax, int) else ax)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(ensure_tensor(x), k, list(axes))


def roll(x, shifts, axis=None, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    sh = shifts if isinstance(shifts, int) else tuple(int(s) for s in shifts)
    if ax is None:
        return torch.roll(x, sh)
    return torch.roll(x, sh, ax)


def slice(input, axes, starts, ends, name=None):
    x = ensure_tensor(input)
    idx = [builtin_slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[as_int(ax)] = builtin_slice(as_int(s), as_int(e))
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing along each named axis; a negative stride takes the
    elements numpy's slice takes (torch slices step forward only)."""
    x = ensure_tensor(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax, st = as_int(ax), as_int(st)
        sel = np.arange(x.shape[ax])[builtin_slice(as_int(s), as_int(e), st)]
        x = torch.index_select(x, ax, torch.as_tensor(sel.copy(),
                                                      device=x.device))
    return x


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype='int64', name=None):
    """The sorted unique values (of the flattened x, or slices along
    `axis`), with the first index of each, the inverse map and the
    counts, as asked."""
    x = ensure_tensor(x)
    if axis is None:
        x = x.reshape(-1)
    vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        n = inv.shape[0]
        first = torch.full((cnt.shape[0],), n, dtype=torch.long,
                           device=x.device).scatter_reduce(
            0, inv, torch.arange(n, device=x.device), 'amin')
        outs.append(first.to(tdt(dtype)))
    if return_inverse:
        outs.append(inv.to(tdt(dtype)))
    if return_counts:
        outs.append(cnt.to(tdt(dtype)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype='int64', name=None):
    x = ensure_tensor(x)
    if axis is None:
        x = x.reshape(-1)
    vals, inv, cnt = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(tdt(dtype)))
    if return_counts:
        outs.append(cnt.to(tdt(dtype)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def masked_select(x, mask, name=None):
    x = ensure_tensor(x)
    return torch.masked_select(x, ensure_tensor(mask, x).bool())


def index_select(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    return torch.index_select(x, axis, ensure_tensor(index, x).long())


def index_sample(x, index):
    x = ensure_tensor(x)
    return torch.gather(x, 1, ensure_tensor(index, x).long())


def take_along_axis(arr, indices, axis, name=None):
    x = ensure_tensor(arr)
    idx = ensure_tensor(indices, x).long()
    shape = list(torch.broadcast_shapes(
        tuple(s for i, s in enumerate(x.shape) if i != axis % x.dim()),
        tuple(s for i, s in enumerate(idx.shape) if i != axis % x.dim())))
    ax = axis % x.dim()
    shape.insert(ax, idx.shape[ax])
    xs = list(shape)
    xs[ax] = x.shape[ax]
    return torch.gather(x.expand(xs), ax, idx.expand(shape))


def put_along_axis(arr, indices, values, axis, reduce='assign', name=None):
    x = ensure_tensor(arr)
    idx = ensure_tensor(indices, x).long()
    val = torch.broadcast_to(ensure_tensor(values, x).to(x.dtype), idx.shape)
    if reduce == 'add':
        return x.scatter_add(axis, idx, val)
    if reduce in ('multiply', 'mul'):
        return x.scatter_reduce(axis, idx, val, 'prod')
    return x.scatter(axis, idx, val)


def tensordot(x, y, axes=2, name=None):
    x = ensure_tensor(x)
    y = ensure_tensor(y, x)
    ax = axes
    if isinstance(ax, torch.Tensor):
        ax = ax.tolist()
    if isinstance(ax, (list, tuple)):
        ax = [list(a) if isinstance(a, (list, tuple)) else [a] for a in ax]
    return torch.tensordot(x, y, dims=ax)


def as_complex(x, name=None):
    return torch.view_as_complex(ensure_tensor(x).contiguous())


def as_real(x, name=None):
    return torch.view_as_real(ensure_tensor(x))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    r = ensure_tensor(repeats, x) if not isinstance(repeats, int) \
        else repeats
    return torch.repeat_interleave(x, r, dim=axis)


def tolist(x):
    return ensure_tensor(x).tolist()


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    offs = [as_int(o) for o in offsets] if offsets is not None \
        else [0] * x.dim()
    shp = [s if s != -1 else x.shape[i] - offs[i]
           for i, s in enumerate(shape_arg(shape))]
    return x[tuple(builtin_slice(o, o + s) for o, s in zip(offs, shp))]


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """The diagonal of the last two axes set to `value` in place (numpy's
    fill_diagonal with wrap for a tall matrix at offset 0); returns x."""
    rows, cols = x.shape[-2], x.shape[-1]
    n = builtins.min(rows, cols)
    i = torch.arange(n - (offset if offset > 0 else 0), device=x.device)
    r = i + (-offset if offset < 0 else 0)
    c = i + (offset if offset > 0 else 0)
    keep = (r < rows) & (c < cols)
    r, c = r[keep], c[keep]
    if wrap and rows > cols and offset == 0:
        start = cols + 1
        while start < rows:
            m = builtins.min(cols, rows - start)
            r = torch.cat([r, torch.arange(m, device=x.device) + start])
            c = torch.cat([c, torch.arange(m, device=x.device)])
            start += cols + 1
    x[..., r, c] = value
    return x


def atleast_1d(*inputs, name=None):
    outs = [torch.atleast_1d(ensure_tensor(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [torch.atleast_2d(ensure_tensor(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [torch.atleast_3d(ensure_tensor(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Ids owned by shard `shard_id` of a table of `index_num` rows cut
    into `nshards` map to their row in the shard; every other id (ids
    outside [0, index_num) included) becomes `ignore_value`."""
    x = ensure_tensor(input)
    if not (0 <= shard_id < nshards):
        raise ValueError('shard_id %d out of range [0, %d)'
                         % (shard_id, nshards))
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    mine = (x >= lo) & (x < lo + size) & (x >= 0) & (x < index_num)
    return torch.where(mine, x - lo, ignore_value)


def reshape_(x, shape, name=None):
    """reshape in place (a contiguous x takes the new shape); returns x."""
    shp = list(shape_arg(shape))
    if -1 in shp:
        known = int(np.prod([d for d in shp if d != -1]))
        shp[shp.index(-1)] = x.numel() // known
    stride = [int(np.prod(shp[i + 1:])) for i in range(len(shp))]
    return x.as_strided_(shp, stride)


def squeeze_(x, axis=None, name=None):
    """squeeze in place; returns x."""
    ax = axes_arg(axis)
    if ax is None:
        return x.squeeze_()
    real = tuple(i for i in ((ax,) if isinstance(ax, int) else ax)
                 if x.shape[i] == 1)
    return x.squeeze_(real) if real else x


def unsqueeze_(x, axis, name=None):
    """unsqueeze in place; returns x."""
    ax = axes_arg(axis)
    for i in sorted((ax,) if isinstance(ax, int) else ax):
        x.unsqueeze_(i)
    return x


def scatter_(x, index, updates, overwrite=True, name=None):
    """scatter in place; returns x."""
    idx = ensure_tensor(index, x).long().reshape(-1)
    up = ensure_tensor(updates, x).to(x.dtype)
    if not overwrite:
        x.index_put_((idx,), torch.zeros_like(up))
    return x.index_put_((idx,), up, accumulate=not overwrite)
