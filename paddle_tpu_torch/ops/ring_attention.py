"""Ring attention: sequence-parallel exact attention over the sp ranks
(counterpart of paddle_tpu/ops/ring_attention.py; Liu et al. ring
attention, blockwise softmax after Dao et al.).

The JAX functions run inside shard_map with a mesh axis bound and rotate
K/V with lax.ppermute. Here each rank is a process holding its sequence
shard [B, N_local, H, D]; `axis_name` is a Group, a ProcessGroup or the
name of an axis of the current HybridCommunicateGroup ('sp'), and the
rotation is collective.p2p_shift (batch_isend_irecv on the group). On a
one-rank group nothing is sent.

- `ring_attention`: the plain ring in torch ops, with attention-prob
  dropout; autograd runs through it (the shift's backward shifts back).
- `zigzag_ring_attention`: the load-balanced causal ring over the zigzag
  layout (rank r holds chunks r and 2P-1-r); rank and source are known
  on the host, so each step computes only the visible quadrants.
- `ulysses_attention`: all_to_all from a sequence shard to a head shard,
  full-sequence attention on H / P heads through the flash entry (the
  kernels on the card, their plain versions on the CPU; the JAX package
  computes that attention in jnp), all_to_all back.
- `ring_flash_attention`: an autograd Function on the flash custom ops
  (paddle_tpu_torch::flash_fwd / flash_bwd). Its forward runs the
  diagonal block causally and every other visible block non-causally with
  lse, merging through the lse (`ring_flash_fwd_block`); its backward runs
  the kernels on each block with the GLOBAL o and lse
  (`ring_flash_bwd_block`), rotating dk / dv with their k / v blocks and
  rotating them home at the end. A block a causal rank cannot see is
  skipped (the JAX program computes it and weights it 0; its kv still
  passes on). Which kernel a block reaches follows its length: the fused
  backward up to 512, the two-pass pair below 4096, the long entries
  from 4096. On CUDA tensors a shape the kernels do not take raises, as
  every flash entry does; the plain ring runs only for dropout and for
  CPU tensors of mixed dtypes.
- `*_sharded`: host entries taking GLOBAL [B, N, H, D] tensors on every
  rank; each rank runs its shard and the outputs are all-gathered.
"""
import math

import numpy as np
import torch
import torch.distributed as dist

from . import flash_attention as fa

# The active sequence-parallel state (distributed/sp.py reads and sets it
# through sp_scope); here so that attention routing reads it without
# importing the distributed package.
SP_STATE = {'active': None}

__all__ = ['ring_attention', 'ulysses_attention', 'ring_attention_sharded',
           'ulysses_attention_sharded', 'ring_flash_attention',
           'ring_flash_attention_sharded', 'zigzag_ring_attention',
           'zigzag_layout_indices', 'ring_flash_fwd_block',
           'ring_flash_bwd_block']


def _group(axis_name):
    """(Group or None, this rank's index, ranks) of axis_name."""
    from ..distributed.collective import axis_group
    g = axis_group(axis_name)
    if g is None or g.pg is None or g.nranks == 1:
        return g, max(getattr(g, 'rank', 0), 0), 1
    return g, g.rank, g.nranks


def _shift(x, group):
    from ..distributed.collective import p2p_shift
    return p2p_shift(x, group, 1)


def _shift_raw(x, group):
    from ..distributed.collective import _shift as shift
    return shift(x, group, 1)


def _block_attn(q, k, v, scale, mask, drop_p=0.0, generator=None):
    """One blockwise attention step in f32 accumulators.

    q [B, Nq, H, D]; k / v [B, Nk, H, D]; mask [Nq, Nk] bool or None.
    Returns (scores' max [B, H, Nq], exp-sum [B, H, Nq], acc
    [B, Nq, H, D]). With dropout the exp-sum keeps the undropped weights
    (dropout follows the normalisation), so only the value sum sees the
    mask, drawn from `generator`."""
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    p_v = p
    if drop_p:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) >= drop_p
        p_v = torch.where(keep, p / (1.0 - drop_p), 0.0)
    acc = torch.einsum('bhqk,bkhd->bqhd', p_v.to(v.dtype).float(),
                       v.float())
    return m, l, acc


def _merge_blocks(carry, blk):
    """Online-softmax merge of two (m, l, acc) streaming-attention states
    (an empty carry: m = -inf, l = 0, acc = 0)."""
    m_prev, l_prev, acc_prev = carry
    m_blk, l_blk, acc_blk = blk
    m_new = torch.maximum(m_prev, m_blk)
    alpha = torch.exp(m_prev - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = alpha * l_prev + beta * l_blk
    acc_new = acc_prev * alpha.transpose(1, 2)[..., None] + \
        acc_blk * beta.transpose(1, 2)[..., None]
    return m_new, l_new, acc_new


def _finish(carry, dtype):
    _, l, acc = carry
    l = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (acc / l).to(dtype)


def ring_attention(q, k, v, axis_name='sp', causal=False, scale=None,
                   dropout_p=0.0, generator=None):
    """Exact attention with K/V rotating around the ring. q, k, v are this
    rank's sequence shard [B, N_local, H, D] (rank r holds rows r * N_local
    onwards); returns its shard of the output. Dropout masks come from
    `generator` (the sp attention gives each rank its own), one block
    after another in ring order."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group, my, n_dev = _group(axis_name)
    b, n_loc, h, d = q.shape
    q_pos = my * n_loc + torch.arange(n_loc, device=q.device)
    carry = (torch.full((b, h, n_loc), -math.inf, device=q.device),
             torch.zeros((b, h, n_loc), device=q.device),
             torch.zeros((b, n_loc, h, d), device=q.device))
    k_cur, v_cur = k, v
    for r in range(n_dev):
        # the kv block held now came from rank (my - r) mod n_dev
        src = (my - r) % n_dev
        mask = None
        if causal:
            k_pos = src * n_loc + torch.arange(n_loc, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
        carry = _merge_blocks(carry, _block_attn(q, k_cur, v_cur, scale,
                                                 mask, dropout_p, generator))
        if r + 1 < n_dev:
            k_cur, v_cur = _shift(k_cur, group), _shift(v_cur, group)
    return _finish(carry, q.dtype)


def zigzag_ring_attention(q, k, v, axis_name='sp', scale=None,
                          dropout_p=0.0, generator=None, causal=True):
    """Load-balanced CAUSAL ring attention over the zigzag layout: with P
    ranks the sequence is cut into 2P chunks of c rows and rank r holds
    [chunk r ; chunk 2P-1-r] (TrainStep lays the batch out so under the
    zigzag mode; sp._zigzag_sp permutes contiguous shards). The local step
    computes lo-lo (triangular), hi-lo (full) and hi-hi (triangular);
    every other step exactly two full c x c quadrants: hi-q with the
    source's lo chunk, and lo-q with it when r > src, else hi-q with its hi
    chunk (Brandon et al. striped attention / zigzag ring). Requires an
    even local row count."""
    assert causal, 'zigzag_ring_attention is causal-only; use ring_attention'
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group, r, n_dev = _group(axis_name)
    b, n_loc, h, d = q.shape
    assert n_loc % 2 == 0, 'zigzag needs an even local row count'
    c = n_loc // 2
    q_lo, q_hi = q[:, :c], q[:, c:]
    tri = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()

    def blk(qq, kk, vv, mask):
        return _block_attn(qq, kk, vv, scale, mask, dropout_p, generator)

    k_lo, k_hi, v_lo, v_hi = k[:, :c], k[:, c:], v[:, :c], v[:, c:]
    lo_c = blk(q_lo, k_lo, v_lo, tri)
    hi_c = _merge_blocks(blk(q_hi, k_lo, v_lo, None),
                         blk(q_hi, k_hi, v_hi, tri))
    k_cur, v_cur = k, v
    for t in range(1, n_dev):
        k_cur, v_cur = _shift(k_cur, group), _shift(v_cur, group)
        src = (r - t) % n_dev
        kl, kh = k_cur[:, :c], k_cur[:, c:]
        vl, vh = v_cur[:, :c], v_cur[:, c:]
        # quadrant A: hi-q sees every lo chunk
        hi_c = _merge_blocks(hi_c, blk(q_hi, kl, vl, None))
        # quadrant B: lo-q vs the source's lo chunk, or hi-q vs its hi one
        if r > src:
            lo_c = _merge_blocks(lo_c, blk(q_lo, kl, vl, None))
        else:
            hi_c = _merge_blocks(hi_c, blk(q_hi, kh, vh, None))
    return torch.cat([_finish(lo_c, q.dtype), _finish(hi_c, q.dtype)],
                     dim=1)


def zigzag_layout_indices(n, n_dev):
    """Global gather indices taking a contiguous sequence to the zigzag
    layout (rank r <- chunks r and 2P-1-r), and the inverse."""
    c = n // (2 * n_dev)
    idx = np.concatenate([
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * n_dev - 1 - r) * c,
                                  (2 * n_dev - r) * c)])
        for r in range(n_dev)])
    inv = np.argsort(idx)
    return idx, inv


class _AllToAll(torch.autograd.Function):
    """all_to_all_single over dim 0 in equal splits; its own transpose."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_to_all(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.pg), None


def _all_to_all(x, pg):
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=pg)
    return out


def ulysses_attention(q, k, v, axis_name='sp', causal=False, scale=None,
                      attn_fn=None, dropout_p=0.0, generator=None):
    """Ulysses (DeepSpeed) sequence parallelism: all_to_all swaps the
    sequence shard for a head shard, full-sequence attention runs on
    H / P heads locally, and a second all_to_all swaps back. Heads must
    divide the axis size; head index = rank * (H / P) + local on both
    sides."""
    group, _, n_dev = _group(axis_name)
    b, n_loc, h, d = q.shape
    assert h % n_dev == 0, 'ulysses needs heads %% sp == 0'
    hl = h // n_dev

    def seq2head(x):
        if n_dev == 1:
            return x
        # [B, n, P, H/P, D] -> [P, B, n, H/P, D]: part j goes to rank j
        parts = x.reshape(b, n_loc, n_dev, hl, d).permute(2, 0, 1, 3, 4)
        got = _AllToAll.apply(parts.contiguous(), group.pg)
        return got.permute(1, 0, 2, 3, 4).reshape(b, n_dev * n_loc, hl, d)

    def head2seq(x):
        if n_dev == 1:
            return x
        parts = x.reshape(b, n_dev, n_loc, hl, d).permute(1, 0, 2, 3, 4)
        got = _AllToAll.apply(parts.contiguous(), group.pg)
        return got.permute(1, 2, 0, 3, 4).reshape(b, n_loc, h, d)

    qf, kf, vf = seq2head(q), seq2head(k), seq2head(v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if attn_fn is not None:
        of = attn_fn(qf, kf, vf)
    elif dropout_p:
        from ..nn.functional.attention import _sdpa_ref
        of = _sdpa_ref(qf, kf, vf, None, causal, scale, dropout_p, generator)
    else:
        of = fa.flash_attention_bnhd(qf, kf, vf, causal=causal, scale=scale)
    return head2seq(of.to(q.dtype))


# -- ring FLASH attention -----------------------------------------------------

def _lse_merge(o1, lse1, o2, lse2):
    """Merge normalised flash outputs (o [B, H, N, D] f32, lse [B, H, N, 1])."""
    m = torch.maximum(lse1, lse2)
    a1 = torch.exp(lse1 - m)
    a2 = torch.exp(lse2 - m)
    denom = (a1 + a2).clamp_min(1e-30)
    return (o1 * a1 + o2 * a2) / denom, m + torch.log(denom)


def ring_flash_fwd_block(q, k, v, o, lse, causal, scale):
    """A forward block step: the flash forward of q [b, h, n, d] against
    one k / v block (with lse), merged into the running (o f32, lse)
    through the lse; o None starts the merge. Returns (o, lse)."""
    o_b, lse_b = fa.flash_fwd_op(q, k, v, causal, scale)
    if o is None:
        return o_b.float(), lse_b
    return _lse_merge(o, lse, o_b.float(), lse_b)


def ring_flash_bwd_block(q, k, v, o, lse, do, causal, scale, dq, dk, dv):
    """A backward block step: the flash backward of one block given the
    GLOBAL o (in q's dtype) and lse, its dq added to `dq` and its dk / dv
    to this block's `dk` / `dv` (f32, [b, rows, h, d]; None starts them).
    Returns (dq, dk, dv)."""
    dq_b, dk_b, dv_b = fa.flash_bwd_op(q, k, v, o, lse, do, causal, scale)
    grads = []
    for acc, g in ((dq, dq_b), (dk, dk_b), (dv, dv_b)):
        g = g.transpose(1, 2).float()
        grads.append(g if acc is None else acc.add_(g))
    return tuple(grads)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, my, n_dev, causal, scale):
        def bhnd(t):
            return t.transpose(1, 2)
        qt = bhnd(q)
        # step 0: the diagonal block (causal inside the kernel)
        o, lse = ring_flash_fwd_block(qt, bhnd(k), bhnd(v), None, None,
                                      causal, scale)
        k_c, v_c = k, v
        for r in range(1, n_dev):
            k_c, v_c = _shift_raw(k_c, group), _shift_raw(v_c, group)
            src = (my - r) % n_dev
            if not causal or src < my:
                o, lse = ring_flash_fwd_block(qt, bhnd(k_c), bhnd(v_c), o,
                                              lse, False, scale)
        # o keeps the kernels' [b, n, h, d] memory layout
        out = o.transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, my, n_dev, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, my, n_dev, causal, scale = ctx.ring

        def bhnd(t):
            return t.transpose(1, 2)
        qt, ot, dot = bhnd(q), bhnd(out), bhnd(do.to(q.dtype))
        dq, dk, dv = ring_flash_bwd_block(qt, bhnd(k), bhnd(v), ot, lse,
                                          dot, causal, scale, None, None,
                                          None)
        k_c, v_c = k, v
        for r in range(1, n_dev):
            # the kv block and its grad accumulators rotate together
            k_c, v_c = _shift_raw(k_c, group), _shift_raw(v_c, group)
            dk, dv = _shift_raw(dk, group), _shift_raw(dv, group)
            src = (my - r) % n_dev
            if not causal or src < my:
                dq, dk, dv = ring_flash_bwd_block(
                    qt, bhnd(k_c), bhnd(v_c), ot, lse, dot, False, scale,
                    dq, dk, dv)
        if n_dev > 1:
            # one final rotation brings each block's grads home
            dk, dv = _shift_raw(dk, group), _shift_raw(dv, group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_flash_attention(q, k, v, axis_name='sp', causal=False, scale=None,
                         dropout_p=0.0, generator=None):
    """ring_attention's contract ([B, N_local, H, D] shards) on the flash
    kernels, block by block. Attention-prob dropout takes the plain ring
    (the kernels are dropout-free), as do CPU tensors of mixed dtypes; on
    CUDA tensors a shape the kernels do not take raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_p:
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                              scale=scale, dropout_p=dropout_p,
                              generator=generator)
    if not q.is_cuda and not (q.dtype == k.dtype == v.dtype):
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                              scale=scale)
    group, my, n_dev = _group(axis_name)
    return _RingFlash.apply(q, k, v, group, my, n_dev, bool(causal),
                            float(scale))


def _sharded(fn, mesh, axis_name, q, k, v, **kw):
    """Each rank takes its sequence shard of the global q, k, v over the
    mesh axis, runs fn on it and the outputs are all-gathered: every rank
    returns the global output, and the global inputs' grads (each rank
    computing the same loss of it) are whole on every rank."""
    from ..distributed.meta_parallel.mp_layers import (
        MPGroup, gather_replicated, scatter_to_mp)
    from ..distributed.topology import Group
    pg = mesh.get_group(axis_name)
    ranks = dist.get_process_group_ranks(pg)
    group = Group(axis_name, len(ranks), ranks=ranks, pg=pg)
    g = MPGroup(pg, group.rank, group.nranks, None)
    out = fn(*(scatter_to_mp(t, 1, g) for t in (q, k, v)), axis_name=group,
             **kw)
    return gather_replicated(out, 1, g)


def ring_attention_sharded(q, k, v, mesh, axis_name='sp', causal=False):
    """Host-level entry: q / k / v GLOBAL [B, N, H, D] on every rank; the
    sequence splits over the mesh axis and runs the ring."""
    return _sharded(ring_attention, mesh, axis_name, q, k, v, causal=causal)


def ulysses_attention_sharded(q, k, v, mesh, axis_name='sp', causal=False):
    return _sharded(ulysses_attention, mesh, axis_name, q, k, v,
                    causal=causal)


def ring_flash_attention_sharded(q, k, v, mesh, axis_name='sp',
                                 causal=False):
    return _sharded(ring_flash_attention, mesh, axis_name, q, k, v,
                    causal=causal)
