"""Fused LM head + softmax cross-entropy, chunked over rows (counterpart of
paddle_tpu/ops/fused_ce.py).

Mean softmax-CE of `x @ w (+ bias)` against integer labels without the
full [rows, vocab] logits: the forward keeps only each row's logsumexp,
and the backward recomputes each chunk's logits and forms
(softmax - onehot) * g / denom on the fly, summing dw in f32 across
chunks. The JAX package writes it in jnp; here it is two torch.library
custom operators over torch ops (the backward registered as the forward's
autograd), and its products are cuBLAS matmuls on the card.

Chunks are contiguous row ranges. The JAX package takes strided chunks
(rows i, i + n, ...) so that every chunk spans all data-parallel shards;
the port's data-parallel ranks each hold their own rows, and contiguous
chunks are views, with no copy and no padding. Rows are independent, so
only the order of the f32 sums differs.

Under tensor parallelism the head weight is sharded on the vocabulary
(`linear_cross_entropy_vocab_parallel`): each rank takes its columns'
logits chunk by chunk, and the rows' logsumexp and picked logits come
from a max and two sums over the mp ranks of [rows] vectors (the
reference's c_softmax_with_cross_entropy); the [rows, vocab] logits are
never gathered. Its backward sums dx over the ranks and keeps dw local.
"""
from typing import Optional

import torch

__all__ = ['linear_cross_entropy_arrays', 'DEFAULT_CHUNK_ROWS',
           'linear_cross_entropy_vocab_parallel', 'logits_sharding',
           'active_logits_sharding']

DEFAULT_CHUNK_ROWS = 4096
_MAX_CHUNKS = 64


def _chunk_plan(rows, chunk):
    """(chunk, n_chunks) with the number of chunks bounded."""
    chunk = max(1, min(int(chunk), rows))
    n = -(-rows // chunk)
    if n > _MAX_CHUNKS:
        chunk = -(-rows // _MAX_CHUNKS)
        n = -(-rows // chunk)
    return chunk, n


def _mm_f32(a, b):
    """a @ b summed and returned in f32 (the JAX package's
    preferred_element_type=f32): cuBLAS with an f32 output for 16-bit
    operands on the card, f32 operands elsewhere."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _tile_logits(xc, w, bias):
    logits = torch.matmul(xc, w)
    if bias is not None:
        logits = logits + bias
    return logits.float()


def _forward(x, w, labels, bias, ignore_index, chunk):
    """(mean CE in x's dtype, each row's logsumexp, the valid-row count)."""
    rows = x.shape[0]
    valid = labels != ignore_index
    safe = labels.clamp(0, w.shape[1] - 1)
    lse_parts, picked_parts = [], []
    for c0 in range(0, rows, chunk):
        af = _tile_logits(x[c0:c0 + chunk], w, bias)
        lse_parts.append(torch.logsumexp(af, dim=-1))
        picked_parts.append(af.gather(1, safe[c0:c0 + chunk, None])[:, 0])
    lse = torch.cat(lse_parts)
    per_row = torch.where(valid, lse - torch.cat(picked_parts), 0.0)
    denom = valid.sum().float().clamp_min(1.0)
    return (per_row.sum() / denom).to(x.dtype), lse, denom


def _backward(g, x, w, labels, bias, lse, denom, ignore_index, chunk):
    """(dx, dw, db) of the mean CE given its output gradient g; db is
    empty without a bias."""
    rows = x.shape[0]
    gg = g.float() / denom
    scale = gg * (labels != ignore_index).float()
    safe = labels.clamp(0, w.shape[1] - 1)
    dx = torch.empty_like(x)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    db = (torch.zeros(bias.shape, dtype=torch.float32, device=w.device)
          if bias is not None else None)
    for c0 in range(0, rows, chunk):
        sl = slice(c0, c0 + chunk)
        xc = x[sl]
        p = torch.exp(_tile_logits(xc, w, bias) - lse[sl, None])
        # d(CE)/d(logits) = softmax - onehot, zeroed on ignored rows
        p.scatter_add_(1, safe[sl, None], torch.full_like(p[:, :1], -1.0))
        p.mul_(scale[sl, None])
        pc = p.to(w.dtype)
        dx[sl] = torch.matmul(pc, w.t())
        dw += _mm_f32(xc.t(), pc)
        if db is not None:
            db += p.sum(dim=0)
    db = x.new_empty((0,)) if db is None else db.to(bias.dtype)
    return dx, dw.to(w.dtype), db


# The loss as two custom operators, as the flash kernels are: a compiled
# program (jit.to_static) calls them as they are, and their chunked loops
# run eagerly inside it, in the order and with the memory of the eager
# path.
@torch.library.custom_op('paddle_tpu_torch::linear_ce_fwd', mutates_args=())
def linear_ce_fwd_op(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     bias: Optional[torch.Tensor], ignore_index: int,
                     chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean CE, each row's logsumexp f32 [rows], the valid count f32)."""
    return _forward(x, w, labels, bias, ignore_index, chunk)


@linear_ce_fwd_op.register_fake
def _linear_ce_fwd_fake(x, w, labels, bias, ignore_index, chunk):
    return (x.new_empty(()), x.new_empty((x.shape[0],), dtype=torch.float32),
            x.new_empty((), dtype=torch.float32))


@torch.library.custom_op('paddle_tpu_torch::linear_ce_bwd', mutates_args=())
def linear_ce_bwd_op(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     labels: torch.Tensor, bias: Optional[torch.Tensor],
                     lse: torch.Tensor, denom: torch.Tensor,
                     ignore_index: int, chunk: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx like x, dw contiguous in w's dtype, db or an empty tensor)."""
    return _backward(g, x, w, labels, bias, lse, denom, ignore_index, chunk)


@linear_ce_bwd_op.register_fake
def _linear_ce_bwd_fake(g, x, w, labels, bias, lse, denom, ignore_index,
                        chunk):
    db = x.new_empty((0,)) if bias is None else torch.empty_like(bias)
    return (torch.empty_like(x), w.new_empty(w.shape), db)


def _ce_setup_context(ctx, inputs, output):
    x, w, labels, bias, ignore_index, chunk = inputs
    _, lse, denom = output
    ctx.save_for_backward(x, w, labels, bias, lse, denom)
    ctx.ignore_index, ctx.chunk = ignore_index, chunk
    ctx.mark_non_differentiable(lse, denom)


def _ce_backward(ctx, g, dlse, ddenom):
    x, w, labels, bias, lse, denom = ctx.saved_tensors
    dx, dw, db = linear_ce_bwd_op(g, x, w, labels, bias, lse, denom,
                                  ctx.ignore_index, ctx.chunk)
    return dx, dw, None, (db if bias is not None else None), None, None


linear_ce_fwd_op.register_autograd(_ce_backward,
                                   setup_context=_ce_setup_context)


def linear_cross_entropy_arrays(x, w, labels, bias=None, ignore_index=-100,
                                chunk=DEFAULT_CHUNK_ROWS):
    """Mean softmax-CE of (x @ w + bias) vs labels over valid rows.

    x: [rows, d] float; w: [d, vocab] (a transposed view of a [vocab, d]
    embedding is fine); labels: [rows] int; bias: [vocab] or None. Rows
    whose label == ignore_index contribute nothing; the mean divides by the
    valid count. Returns a scalar in x's dtype."""
    chunk, _ = _chunk_plan(x.shape[0], chunk)
    return linear_ce_fwd_op(x, w, labels.long(), bias, int(ignore_index),
                            chunk)[0]


def _mp_sum(t, group, op=None):
    import torch.distributed as dist
    if group.size > 1:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group.pg)
    return t


class _VocabParallelCE(torch.autograd.Function):
    """The mean CE of x @ w_local (+ bias_local) with w_local this rank's
    vocabulary columns [vocab_start, vocab_start + cols) of the head."""

    @staticmethod
    def forward(ctx, x, w, labels, bias, ignore_index, chunk, start, group):
        import torch.distributed as dist
        rows, cols = x.shape[0], w.shape[1]
        valid = labels != ignore_index
        inside = (labels >= start) & (labels < start + cols)
        local = torch.where(inside, labels - start, 0)
        lse_parts, picked_parts = [], []
        for c0 in range(0, rows, chunk):
            af = _tile_logits(x[c0:c0 + chunk], w, bias)
            lse_parts.append(torch.logsumexp(af, dim=-1))
            picked_parts.append(af.gather(1, local[c0:c0 + chunk, None])[:, 0])
        local_lse = torch.cat(lse_parts)
        top = _mp_sum(local_lse.clone(), group, dist.ReduceOp.MAX)
        total = _mp_sum(torch.exp(local_lse - top), group)
        lse = top + torch.log(total)
        picked = _mp_sum(torch.where(inside, torch.cat(picked_parts), 0.0),
                         group)
        per_row = torch.where(valid, lse - picked, 0.0)
        denom = valid.sum().float().clamp_min(1.0)
        ctx.save_for_backward(x, w, local, inside, valid, bias, lse, denom)
        ctx.chunk, ctx.group = chunk, group
        return (per_row.sum() / denom).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, local, inside, valid, bias, lse, denom = ctx.saved_tensors
        chunk, group = ctx.chunk, ctx.group
        scale = g.float() / denom * valid.float()
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (torch.zeros(bias.shape, dtype=torch.float32, device=w.device)
              if bias is not None else None)
        for c0 in range(0, x.shape[0], chunk):
            sl = slice(c0, c0 + chunk)
            xc = x[sl]
            p = torch.exp(_tile_logits(xc, w, bias) - lse[sl, None])
            p.scatter_add_(1, local[sl, None],
                           -inside[sl, None].to(p.dtype))
            p.mul_(scale[sl, None])
            pc = p.to(w.dtype)
            dx[sl] = torch.matmul(pc, w.t())
            dw += _mm_f32(xc.t(), pc)
            if db is not None:
                db += p.sum(dim=0)
        dx = _mp_sum(dx, group)
        return (dx, dw.to(w.dtype), None,
                None if db is None else db.to(bias.dtype), None, None, None,
                None)


def linear_cross_entropy_vocab_parallel(x, w_local, labels, vocab_start,
                                        group, bias=None, ignore_index=-100,
                                        chunk=DEFAULT_CHUNK_ROWS):
    """linear_cross_entropy_arrays with the head's vocabulary split over
    the ranks of `group` (an MPGroup): w_local [d, cols] holds this rank's
    columns from vocab_start, bias its entries. Every rank returns the
    whole mean CE."""
    chunk, _ = _chunk_plan(x.shape[0], chunk)
    return _VocabParallelCE.apply(x, w_local, labels.long(), bias,
                                  int(ignore_index), chunk, int(vocab_start),
                                  group)


_LOGITS = {'sharding': None}


class logits_sharding:
    """Context in which a vocabulary-sharded head takes the vocab-parallel
    loss (TrainStep's fce_sharding, as the JAX package's context
    constrains its logits tiles); outside it such a head is gathered and
    the plain loss runs."""

    def __init__(self, sharding):
        self._sharding = sharding

    def __enter__(self):
        self._saved = _LOGITS['sharding']
        _LOGITS['sharding'] = self._sharding
        return self

    def __exit__(self, *exc):
        _LOGITS['sharding'] = self._saved
        return False


def active_logits_sharding():
    return _LOGITS['sharding']
