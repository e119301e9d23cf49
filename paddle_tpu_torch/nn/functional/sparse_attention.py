"""Block-sparse attention (reference: paddle.nn.functional.sparse_attention,
operators/sparse_attention_op; counterpart of
paddle_tpu/nn/functional/sparse_attention.py).

The JAX package's dense masked computation in torch ops: the CSR layout
becomes a dense [N, M] mask, masked scores are filled with -1e30 before
the softmax and masked probabilities are zeroed after it, so a row with
every key masked gives 0 (scaled_dot_product_attention gives NaN there).
As in the JAX function, the layout of the first (batch, head),
`sparse_csr_offset[0, 0]` / `sparse_csr_columns[0, 0]`, serves every
(batch, head). Gradients come from autograd. A kernel that skips the
masked blocks would be a feature the JAX package lacks.
"""
import math

import torch

from ...tensor._helpers import ensure_tensor

__all__ = ['sparse_attention']


def _csr_mask(offs, cols, n, m):
    """The dense [n, m] bool mask of one CSR layout: row i attends to
    cols[offs[i]:offs[i + 1]]. Entries of `cols` past offs[-1] land on
    the last row, as jnp.repeat(..., total_repeat_length) places them;
    negative columns wrap and columns past m are dropped, as the JAX
    package's scatter does."""
    nnz = cols.shape[-1]
    bounds = torch.cumsum(torch.diff(offs.to(torch.int64)), 0)
    j = torch.arange(nnz, device=cols.device)
    rows = torch.searchsorted(bounds, j, right=True).clamp_max(n - 1)
    cols = cols.to(torch.int64)
    keep = (cols >= -m) & (cols < m)
    mask = torch.zeros(n, m, dtype=torch.bool, device=cols.device)
    mask[rows[keep], cols[keep] % m] = True
    return mask


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    q = ensure_tensor(query)
    k = ensure_tensor(key, like=q)
    v = ensure_tensor(value, like=q)
    offs = ensure_tensor(sparse_csr_offset, like=q).to(q.device)
    cols = ensure_tensor(sparse_csr_columns, like=q).to(q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum('bhqd,bhkd->bhqk', q, k) * scale
    n, m = s.shape[-2:]
    mask = _csr_mask(offs[0, 0], cols[0, 0], n, m)[None, None]
    if key_padding_mask is not None:
        # reference contract: 0 marks a masked-out key position
        kpm = ensure_tensor(key_padding_mask, like=q).to(q.device)
        mask = mask & (kpm != 0)[:, None, None, :]
    if attn_mask is not None:
        am = ensure_tensor(attn_mask, like=q).to(q.device)
        mask = mask & (am != 0)[None, None]
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    return torch.einsum('bhqk,bhkd->bhqd', p, v)
