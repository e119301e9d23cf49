"""Attention (counterpart of paddle_tpu/nn/functional/attention.py).

Routing as in the JAX package: flash attention (ops/flash_attention.py)
for sequences of 512 or more with head_dim <= 256, no mask and no dropout;
otherwise the plain quadratic path `_sdpa_ref`, which also applies
attention-probability dropout in training mode. The flash entry sends a
sequence of LONG_SEQ (4096) or more to the long route and causal
attention with n != m to the blockwise attention
(ops/blockwise_attention.py). The JAX package also takes blockwise here
when its flash kernel is unavailable (no TPU) or head_dim > 256 at 1024 or
more; the port's flash kernels are always available, and the head_dim >
256 case takes `_sdpa_ref`, which computes the same function.
"""
import math

import torch

from ...ops import flash_attention as fa
from .common import dropout


def _sdpa_ref(q, k, v, mask, causal, scale, dropout_p=0.0, generator=None):
    """q, k, v [B, N, H, D]. Scores in the input dtype, bottom-right causal
    (query i sits at absolute position m - n + i, so a decode step sees the
    whole cache), an additive mask, softmax in f32 cast back to q's dtype,
    dropout on the probabilities (upscale in train, mask from `generator`),
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
    if dropout_p:
        p = dropout(p, dropout_p, training=True, generator=generator)
    o = torch.matmul(p, vt)
    return o.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Inputs [batch, seq, heads, head_dim] (paddle layout). Dropout on the
    attention probabilities in training mode keeps the call off flash, as
    in the JAX package; its mask comes from `generator`."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if not training:
        dropout_p = 0.0
    use_flash = (query.dim() == 4 and query.shape[1] >= 512
                 and query.shape[-1] <= 256)
    if use_flash and attn_mask is None and dropout_p == 0.0:
        return fa.flash_attention_bnhd(query, key, value, causal=is_causal,
                                       scale=scale)
    return _sdpa_ref(query, key, value, attn_mask, is_causal, scale,
                     dropout_p, generator)
