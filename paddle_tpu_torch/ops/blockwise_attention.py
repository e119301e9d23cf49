"""Blockwise (chunked) attention in plain torch (counterpart of
paddle_tpu/ops/blockwise_attention.py).

Online softmax over K/V blocks (Dao et al.; Liu et al., "Blockwise Parallel
Transformer"). Every block step runs under `torch.utils.checkpoint`, so the
backward keeps only the per-step running (max, sum, accumulator) carries
and recomputes each step's scores: neither direction holds the [n, m] score
matrix, and memory is O(seq * head_dim) per step, as the JAX version's
`lax.scan` over a `jax.checkpoint`ed body keeps it. The JAX version is XLA,
not a Pallas kernel, so this module has no CUDA kernel: its products go to
torch.matmul.

Causal masking is bottom-right aligned: query i sits at absolute key
position m - n + i, so a chunk of queries over a longer cache sees the
whole prefix. `ops.flash_attention` routes causal attention with n != m
here before any kernel.
"""
import math

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30

# The chunk size (the JAX package's PADDLE_TPU_BLOCKWISE_BLOCK default; the
# port has no knob for it).
BLOCK_SIZE = 512


def _pick_block(n, target):
    """Largest power-of-two-ish divisor of n that is <= target."""
    b = min(target, n)
    while b > 1 and n % b:
        b //= 2
    return max(b, 1)


def _online_init(b, h, rows, d, device):
    return (torch.full((b, h, rows), _NEG_INF, dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, rows), dtype=torch.float32, device=device),
            torch.zeros((b, h, rows, d), dtype=torch.float32, device=device))


def _online_step(m_prev, l_prev, acc, qn, kj, vj, scale, keep=None):
    """One online-softmax accumulation step over a single K/V block.

    The carries are f32. q, k, v stay in their dtype until the products,
    which are taken in f32 (a bf16 or fp16 product is exact in f32, so this
    is the JAX version's native product with f32 accumulation); p is
    rounded to v's dtype before p @ v. `keep` is an optional [rows, bk]
    visibility mask."""
    s = torch.matmul(qn.float(), kj.float().transpose(-1, -2)) * scale
    if keep is not None:
        s = s.masked_fill(~keep, _NEG_INF)
    m_cur = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_cur[..., None])
    if keep is not None:
        # a row with no visible key in this block has s == m_cur == -1e30,
        # so exp gives 1 there: zero it
        p = p.masked_fill(~keep, 0.0)
    corr = torch.exp(m_prev - m_cur)
    l_cur = l_prev * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.matmul(p.to(vj.dtype).float(),
                                               vj.float())
    return m_cur, l_cur, acc


def _step(carry, qn, kj, vj, scale, keep=None):
    """_online_step under activation checkpointing when autograd records."""
    if torch.is_grad_enabled():
        return checkpoint(_online_step, *carry, qn, kj, vj, scale, keep,
                          use_reentrant=False)
    return _online_step(*carry, qn, kj, vj, scale, keep)


def _finish(carry, dtype):
    _, l_f, acc = carry
    return (acc / l_f.clamp_min(1e-30)[..., None]).to(dtype)


def blockwise_attention_bnhd(q, k, v, causal=False, scale=None,
                             block_q=BLOCK_SIZE, block_k=BLOCK_SIZE):
    """Attention over [batch, heads, seq, head_dim] tensors.

    Matches softmax(q k^T * scale) v with f32 accumulation, bottom-right
    causal. Causal self-attention (n == m, equal blocks, at most 64 of
    them) walks only the lower triangle of blocks (_causal_skip); every
    other call walks all K/V blocks with the mask applied."""
    b, h, n, d = q.shape
    m = k.shape[2]
    if causal and n > m:
        raise ValueError(
            'causal attention with more queries (%d) than keys (%d)'
            % (n, m))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bq = _pick_block(n, block_q)
    bk = _pick_block(m, block_k)
    tq, tk = n // bq, m // bk
    if causal and n == m and bq == bk and tq <= 64:
        return _causal_skip(q.reshape(b, h, tq, bq, d),
                            k.reshape(b, h, tk, bk, d).movedim(2, 0),
                            v.reshape(b, h, tk, bk, d).movedim(2, 0),
                            scale, q.dtype)
    # every query block at once (the JAX version vmaps over them)
    carry = _online_init(b, h, n, d, q.device)
    qpos = (m - n) + torch.arange(n, device=q.device)
    for j in range(tk):
        keep = None
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)
            keep = qpos[:, None] >= kpos[None, :]
        carry = _step(carry, q, k[:, :, j * bk:(j + 1) * bk],
                      v[:, :, j * bk:(j + 1) * bk], scale, keep)
    return _finish(carry, q.dtype)


def _causal_skip(qb, kb, vb, scale, out_dtype):
    """Lower-triangle-only causal blockwise attention.

    qb: [b, h, tq, bq, d]; kb / vb: [tk, b, h, bk, d] with tq == tk and
    bq == bk. Query block i takes K/V blocks 0..i-1 unmasked, then the
    diagonal block with the in-block triangle mask; no block above the
    diagonal is computed. Every step, the diagonal included, is
    checkpointed."""
    b, h, tq, bq, d = qb.shape
    rows = torch.arange(bq, device=qb.device)
    tri = rows[:, None] >= rows[None, :]
    outs = []
    for i in range(tq):
        qn = qb[:, :, i]
        carry = _online_init(b, h, bq, d, qb.device)
        for j in range(i):
            carry = _step(carry, qn, kb[j], vb[j], scale)
        carry = _step(carry, qn, kb[i], vb[i], scale, tri)
        outs.append(_finish(carry, out_dtype))
    return torch.stack(outs, dim=2).reshape(b, h, tq * bq, d)


def blockwise_attention(q, k, v, causal=False, scale=None,
                        block_q=BLOCK_SIZE, block_k=BLOCK_SIZE):
    """Paddle-layout entry: [batch, seq, heads, head_dim]."""
    o = blockwise_attention_bnhd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 scale=scale, block_q=block_q,
                                 block_k=block_k)
    return o.transpose(1, 2)
