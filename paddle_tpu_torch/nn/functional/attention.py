"""Attention (counterpart of paddle_tpu/nn/functional/attention.py).

Routing as in the JAX package: under an active sequence-parallel state
(distributed/sp.py) ring or Ulysses attention over the sp group; else
flash attention (ops/flash_attention.py)
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
from torch.utils.checkpoint import checkpoint

from ...amp.auto_cast import cast as amp_cast
from ...ops import flash_attention as fa
from ...ops import ring_attention as ra
from .common import dropout


def _default_generator(device):
    if device.type == 'cuda':
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def _sdpa_body(q, k, v, mask, causal, scale, dropout_p, rng_state, drawn):
    """_sdpa_ref's arithmetic. The dropout mask comes from a generator set
    to `rng_state`, so the recompute in the backward draws the same one;
    the first draw appends the generator's state after it to `drawn`."""
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
        gen = torch.Generator(device=q.device)
        gen.set_state(rng_state)
        p = dropout(p, dropout_p, training=True, generator=gen)
        if not drawn:
            drawn.append(gen.get_state())
    o = torch.matmul(p, vt)
    return o.transpose(1, 2)


def _sdpa_ref(q, k, v, mask, causal, scale, dropout_p=0.0, generator=None):
    """q, k, v [B, N, H, D]. Scores in the input dtype, bottom-right causal
    (query i sits at absolute position m - n + i, so a decode step sees the
    whole cache), an additive mask, softmax in f32 cast back to q's dtype,
    dropout on the probabilities (upscale in train, mask from `generator`,
    torch's default generator of q's device when None), then p @ v.

    Under autograd the body is recomputed in the backward, as the JAX
    package's jax.checkpoint does: the [B, H, N, M] scores, probabilities
    and dropout mask are not kept. The mask is drawn from a copy of the
    generator's state taken here, outside the recomputed body (the
    counterpart of the JAX package's key, drawn outside its checkpoint), so
    both passes draw the same mask; `generator` then advances as one draw
    of the mask would advance it. Calls without grad (every serving call)
    run the body once, unwrapped."""
    rng_state, gen = None, None
    if dropout_p:
        gen = generator if generator is not None \
            else _default_generator(q.device)
        rng_state = gen.get_state()
    drawn = []
    args = (q, k, v, mask, causal, scale, dropout_p, rng_state, drawn)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, mask)):
        out = checkpoint(_sdpa_body, *args, use_reentrant=False,
                         preserve_rng_state=False)
    else:
        out = _sdpa_body(*args)
    if dropout_p:
        gen.set_state(drawn[0])
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Inputs [batch, seq, heads, head_dim] (paddle layout). Dropout on the
    attention probabilities in training mode keeps the call off flash, as
    in the JAX package; its mask comes from `generator`."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if not training:
        dropout_p = 0.0
    # sequence-parallel routing: when a TrainStep's sp state is active,
    # attention is the one op that mixes tokens across the sequence
    # shards; it runs as ring / Ulysses over the sp group
    sp_state = ra.SP_STATE['active']
    if sp_state is not None and query.dim() == 4:
        from ...distributed.sp import sp_attention
        if attn_mask is not None:
            raise ValueError('sequence-parallel attention supports causal/'
                             'full masks only (attn_mask must be None)')
        query, key, value = amp_cast('sp_attention', query, key, value)
        return sp_attention(query, key, value, causal=is_causal, scale=scale,
                            state=sp_state, dropout_p=dropout_p,
                            generator=generator)
    use_flash = (query.dim() == 4 and query.shape[1] >= 512
                 and query.shape[-1] <= 256)
    if use_flash and attn_mask is None and dropout_p == 0.0:
        query, key, value = amp_cast('flash_attention', query, key, value)
        return fa.flash_attention_bnhd(query, key, value, causal=is_causal,
                                       scale=scale)
    query, key, value = amp_cast('sdpa', query, key, value)
    return _sdpa_ref(query, key, value, attn_mask, is_causal, scale,
                     dropout_p, generator)
