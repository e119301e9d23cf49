"""Attention (counterpart of paddle_tpu/nn/functional/attention.py).

Routing as in the JAX package: the flash forward (ops/flash_attention.py)
for sequences of 512 or more with head_dim <= 256, no mask and no dropout;
otherwise the plain quadratic path `_sdpa_ref`. The JAX package's
blockwise path for long masked-free sequences is not ported yet, so what
would reach it takes `_sdpa_ref`, which computes the same function.
"""
import math

import torch

from ...ops import flash_attention as fa


def _sdpa_ref(q, k, v, mask, causal, scale):
    """q, k, v [B, N, H, D]. Scores in the input dtype, bottom-right causal
    (query i sits at absolute position m - n + i, so a decode step sees the
    whole cache), an additive mask, softmax in f32 cast back to q's dtype,
    then p @ v."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        if n > m:
            raise ValueError(
                'causal attention with more queries (%d) than keys (%d): '
                'the leading query rows would have no visible key' % (n, m))
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril(m - n)
        s = s.masked_fill(~keep, max(-1e30, torch.finfo(s.dtype).min))
    if mask is not None:
        s = s + mask
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.matmul(p, vt)
    return o.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Inputs [batch, seq, heads, head_dim] (paddle layout). Attention
    dropout in training mode is not ported yet."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if training and dropout_p:
        raise NotImplementedError(
            'attention dropout in training mode is not ported yet')
    use_flash = (query.dim() == 4 and query.shape[1] >= 512
                 and query.shape[-1] <= 256)
    if use_flash and attn_mask is None:
        return fa.flash_attention_bnhd(query, key, value, causal=is_causal,
                                       scale=scale)
    return _sdpa_ref(query, key, value, attn_mask, is_causal, scale)
