"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py): the
hard-label softmax cross-entropy and the fused LM-head cross-entropy that
GPT training uses. Soft labels and class weights come in a later slice."""
import torch

from ...ops import fused_ce as _fce

__all__ = ['cross_entropy', 'linear_cross_entropy']


class _CEWithLogits(torch.autograd.Function):
    """Per-row softmax CE in f32, 0 on ignored rows. Saves the logits in
    their own dtype and recomputes the softmax in the backward, whose
    gradient is (softmax - onehot) * g, cast to the logits' dtype — the
    JAX package's memory-lean custom VJP."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index):
        af = logits.float()
        safe = label.clamp(0, logits.shape[-1] - 1)
        picked = af.gather(-1, safe[..., None])[..., 0]
        out = torch.where(label != ignore_index,
                          torch.logsumexp(af, dim=-1) - picked, 0.0)
        ctx.save_for_backward(logits, label)
        ctx.ignore_index = ignore_index
        return out

    @staticmethod
    def backward(ctx, g):
        logits, label = ctx.saved_tensors
        p = torch.softmax(logits.float(), dim=-1)
        safe = label.clamp(0, logits.shape[-1] - 1)
        p.scatter_add_(-1, safe[..., None], torch.full_like(p[..., :1], -1.0))
        valid = (label != ctx.ignore_index).float()
        return (p * (g * valid)[..., None]).to(logits.dtype), None, None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross-entropy of logits `input` [..., C] against integer
    labels (a trailing label dim of 1 is squeezed). reduction 'mean'
    divides by the count of rows whose label != ignore_index."""
    if soft_label or weight is not None:
        raise NotImplementedError(
            'cross_entropy with soft labels or class weights is not ported '
            'yet (the training slice takes hard labels)')
    if not use_softmax or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            'cross_entropy over logits on the last axis only (the training '
            'slice); use_softmax=False / another axis are not ported yet')
    if reduction not in ('mean', 'sum', 'none'):
        raise ValueError('reduction must be mean, sum or none, got %r'
                         % (reduction,))
    lab = label
    if lab.dim() == input.dim() and lab.shape[-1] == 1:
        lab = lab[..., 0]
    lab = lab.long()
    out = _CEWithLogits.apply(input, lab, int(ignore_index)).to(input.dtype)
    if reduction == 'mean':
        denom = (lab != ignore_index).sum().to(input.dtype).clamp_min(1)
        return out.sum() / denom
    if reduction == 'sum':
        return out.sum()
    return out


def linear_cross_entropy(input, weight, label, bias=None, ignore_index=-100,
                         transpose_weight=False, chunk_rows=None):
    """Fused linear head + mean softmax cross-entropy (hard labels):
    cross_entropy(input @ weight + bias, label) without the [rows, vocab]
    logits (ops/fused_ce.py). input [..., d]; weight [d, vocab], or
    [vocab, d] with transpose_weight=True (the tied-embedding layout);
    label matches input's leading dims. chunk_rows defaults to 4096."""
    d = input.shape[-1]
    w = weight.t() if transpose_weight else weight
    chunk = _fce.DEFAULT_CHUNK_ROWS if chunk_rows is None else chunk_rows
    return _fce.linear_cross_entropy_arrays(
        input.reshape(-1, d), w, label.reshape(-1), bias, ignore_index, chunk)
