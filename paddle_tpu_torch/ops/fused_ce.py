"""Fused LM head + softmax cross-entropy, chunked over rows (counterpart of
paddle_tpu/ops/fused_ce.py).

Mean softmax-CE of `x @ w (+ bias)` against integer labels without the
full [rows, vocab] logits: the forward keeps only each row's logsumexp,
and the backward recomputes each chunk's logits and forms
(softmax - onehot) * g / denom on the fly, summing dw in f32 across
chunks. The JAX package writes it in jnp; here it is an autograd Function
over torch ops, and its products are cuBLAS matmuls on the card.

Chunks are contiguous row ranges. The JAX package takes strided chunks
(rows i, i + n, ...) so that every chunk spans all data-parallel shards;
the port has no data parallelism yet, and contiguous chunks are views,
with no copy and no padding. Rows are independent, so only the order of
the f32 sums differs.
"""
import torch

__all__ = ['linear_cross_entropy_arrays', 'DEFAULT_CHUNK_ROWS']

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


class _LinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, bias, ignore_index, chunk):
        rows = x.shape[0]
        chunk, _ = _chunk_plan(rows, chunk)
        valid = labels != ignore_index
        safe = labels.clamp(0, w.shape[1] - 1)
        lse_parts, picked_parts = [], []
        for c0 in range(0, rows, chunk):
            af = _tile_logits(x[c0:c0 + chunk], w, bias)
            lse_parts.append(torch.logsumexp(af, dim=-1))
            picked_parts.append(
                af.gather(1, safe[c0:c0 + chunk, None])[:, 0])
        lse = torch.cat(lse_parts)
        per_row = torch.where(valid, lse - torch.cat(picked_parts), 0.0)
        denom = valid.sum().float().clamp_min(1.0)
        ctx.save_for_backward(x, w, labels, bias, lse, denom)
        ctx.ignore_index, ctx.chunk = ignore_index, chunk
        return (per_row.sum() / denom).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, labels, bias, lse, denom = ctx.saved_tensors
        rows = x.shape[0]
        chunk = ctx.chunk
        gg = g.float() / denom
        scale = gg * (labels != ctx.ignore_index).float()
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
            p.scatter_add_(1, safe[sl, None],
                           torch.full_like(p[:, :1], -1.0))
            p.mul_(scale[sl, None])
            pc = p.to(w.dtype)
            dx[sl] = torch.matmul(pc, w.t())
            dw += _mm_f32(xc.t(), pc)
            if db is not None:
                db += p.sum(dim=0)
        return (dx, dw.to(w.dtype), None,
                None if bias is None else db.to(bias.dtype), None, None)


def linear_cross_entropy_arrays(x, w, labels, bias=None, ignore_index=-100,
                                chunk=DEFAULT_CHUNK_ROWS):
    """Mean softmax-CE of (x @ w + bias) vs labels over valid rows.

    x: [rows, d] float; w: [d, vocab] (a transposed view of a [vocab, d]
    embedding is fine); labels: [rows] int; bias: [vocab] or None. Rows
    whose label == ignore_index contribute nothing; the mean divides by the
    valid count. Returns a scalar in x's dtype."""
    return _LinearCE.apply(x, w, labels.long(), bias, int(ignore_index),
                           int(chunk))
