"""Extension functionals (counterpart of paddle_tpu/nn/functional/
extension.py): gather_tree, temporal_shift, sequence_mask, diag_embed,
affine_grid, grid_sample and hsigmoid_loss.

The JAX package's behaviours are kept: grid_sample treats every
padding_mode but 'border' as 'zeros' ('reflection' included) and its
'nearest' rounds half to even; hsigmoid_loss returns the batch mean with
shape [1], its default tree built on the host and cut at ceil(log2 C)
levels; sequence_mask with maxlen=None reads the longest length on the
host; temporal_shift takes NCHW only."""
import numpy as np
import torch

from ...amp.auto_cast import cast as amp_cast
from ...framework.dtype import torch_dtype

__all__ = ['sequence_mask', 'diag_embed', 'affine_grid', 'grid_sample',
           'hsigmoid_loss', 'gather_tree', 'temporal_shift']


def gather_tree(ids, parents):
    """Beam-search backtrace (reference gather_tree op): from the last step
    back, follow each final beam's parent pointers and re-link its token
    ids into a full path. ids, parents: [max_time, batch, beam_width]."""
    beam_sel = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(ids[t].gather(1, beam_sel))
        beam_sel = parents[t].gather(1, beam_sel).long()
    return torch.stack(out[::-1])


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format='NCHW',
                   name=None):
    """TSM temporal shift: fold the batch into (N // seg_num, seg_num)
    segments; the first `shift_ratio` of the channels read the previous
    time step, the next as many read the next one, the rest stay."""
    if data_format != 'NCHW':
        raise ValueError('temporal_shift supports NCHW only')
    x, = amp_cast('temporal_shift', x)
    nt, c, h, w = x.shape
    if nt % seg_num:
        raise ValueError('batch %d not divisible by seg_num %d'
                         % (nt, seg_num))
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    from_past = torch.cat([torch.zeros_like(v[:, :1, :c1]),
                           v[:, :-1, :c1]], dim=1)
    from_future = torch.cat([v[:, 1:, c1:c2],
                             torch.zeros_like(v[:, :1, c1:c2])], dim=1)
    out = torch.cat([from_past, from_future, v[:, :, c2:]], dim=2)
    return out.reshape(nt, c, h, w)


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    """lengths [...] -> mask [..., maxlen]: 1 where the position is below
    the length. maxlen=None takes the longest length (read on the host)."""
    m = int(maxlen) if maxlen is not None else int(x.max())
    rng = torch.arange(m, dtype=x.dtype, device=x.device)
    return (rng < x[..., None]).to(torch_dtype(dtype))


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last dim as the `offset` diagonal of a new pair of dims, placed
    at dim1 (rows) and dim2 (columns)."""
    input, = amp_cast('diag_embed', input)
    return torch.diag_embed(input, offset, dim1, dim2)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> sampling grid [N, H, W, 2]."""
    theta, = amp_cast('affine_grid', theta)
    if torch.is_tensor(out_shape):
        out_shape = out_shape.tolist()
    n, c, h, w = [int(v) for v in out_shape]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
    gx, gy = torch.meshgrid(xs, ys, indexing='xy')     # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum('hwk,njk->nhwj', base.to(theta.dtype), theta)


def grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
                align_corners=True, name=None):
    """Bilinear or nearest sampling of x [N, C, H, W] at grid [N, Hg, Wg,
    2] (normalised x, y in [-1, 1]) -> [N, C, Hg, Wg]."""
    x, grid = amp_cast('grid_sample', x, grid)
    n, c, h, w = x.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    fx = unnorm(grid[..., 0], w)                      # [N, Hg, Wg]
    fy = unnorm(grid[..., 1], h)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == 'border':
            return vals                               # [N, Hg, Wg, C]
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return vals * inb[..., None].to(x.dtype)

    if mode == 'nearest':
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0 = torch.floor(fx).long()
        y0 = torch.floor(fy).long()
        x1, y1 = x0 + 1, y0 + 1
        wx = (fx - x0).to(x.dtype)[..., None]
        wy = (fy - y0).to(x.dtype)[..., None]
        out = (sample(x0, y0) * (1 - wx) * (1 - wy) +
               sample(x1, y0) * wx * (1 - wy) +
               sample(x0, y1) * (1 - wx) * wy +
               sample(x1, y1) * wx * wy)
    return out.movedim(-1, 1)


def _default_tree(num_classes):
    """Each class's path (internal node ids and codes, -1 padded) in the
    complete binary tree over num_classes leaves, cut at ceil(log2 C)
    levels."""
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    tables = np.full((num_classes, depth), -1, np.int64)
    codes = np.full((num_classes, depth), -1, np.int64)
    for cls in range(num_classes):
        node = cls + num_classes  # leaves occupy [num_classes, 2N)
        path = []
        while node > 1:
            parent = node // 2
            path.append((parent - 1, node % 2))
            node = parent
        for li, (nid, code) in enumerate(reversed(path)):
            if li < depth:
                tables[cls, li] = nid
                codes[cls, li] = code
    return tables, codes


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss over the default complete tree, or over
    custom path_table / path_code [*, L] (-1 padded), whose rows are picked
    by label as in the JAX package. Returns the batch mean, shape [1]."""
    input, weight, bias = amp_cast('hsigmoid_loss', input, weight, bias)
    if path_table is None:
        tables, codes = _default_tree(num_classes)
    else:
        tables = np.asarray(path_table.cpu().numpy() if
                            torch.is_tensor(path_table) else path_table,
                            np.int64)
        codes = np.asarray(path_code.cpu().numpy() if
                           torch.is_tensor(path_code) else path_code,
                           np.int64)
    dev = weight.device
    lab = label.reshape(-1).long().to(dev)
    t = torch.as_tensor(tables, device=dev)[lab]                  # [N, L]
    code = torch.as_tensor(codes, device=dev)[lab].to(input.dtype)
    valid = t >= 0
    t_safe = t.clamp(0, weight.shape[0] - 1)
    logits = torch.einsum('nd,nld->nl', input.to(weight.dtype),
                          weight[t_safe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[t_safe]
    # code 1 takes sigmoid(logit), code 0 takes 1 - sigmoid(logit)
    zls = torch.clamp_min(logits, 0) - logits * code + \
        torch.log1p(torch.exp(-logits.abs()))
    return torch.where(valid, zls, 0.0).sum(1).mean()[None]
