"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py): the
softmax cross-entropy (hard or soft labels, class weights, any axis,
use_softmax=False) and the fused LM-head cross-entropy that GPT training
uses. Both cast their inputs under auto_cast by the JAX package's op
names."""
import torch

from ...amp.auto_cast import cast as amp_cast
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


def _reduce(out, reduction):
    if reduction == 'mean':
        return out.mean()
    if reduction == 'sum':
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction='mean', soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross-entropy of `input` along `axis` (probabilities when
    use_softmax=False: their log is taken as is).

    Hard labels are integers (a label dim of 1 at `axis` is squeezed);
    rows whose label == ignore_index give 0, and reduction 'mean' divides by
    their count, or with class weights `weight` [C] by the summed weights of
    the valid rows. Soft labels are distributions along `axis`: the loss is
    -sum(label * log p), 'mean' averages over every row, and `weight` is not
    used (as in the JAX package)."""
    if reduction not in ('mean', 'sum', 'none'):
        raise ValueError('reduction must be mean, sum or none, got %r'
                         % (reduction,))
    if soft_label:
        input, label, weight = amp_cast('cross_entropy', input, label,
                                         weight)
        logp = (torch.log_softmax(input, dim=axis) if use_softmax
                else torch.log(input))
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    input, weight = amp_cast('cross_entropy', input, weight)
    dim = axis % input.dim()
    lab = label
    if lab.dim() == input.dim() and lab.shape[dim] == 1:
        lab = lab.squeeze(dim)
    lab = lab.long()
    valid = lab != ignore_index
    if use_softmax and dim == input.dim() - 1:
        out = _CEWithLogits.apply(input, lab, int(ignore_index)).to(
            input.dtype)
    else:
        logp = (torch.log_softmax(input, dim=dim) if use_softmax
                else torch.log(input))
        safe = lab.clamp(0, input.shape[dim] - 1)
        out = -logp.gather(dim, safe.unsqueeze(dim)).squeeze(dim)
        out = torch.where(valid, out, 0.0)
    if weight is not None:
        cw = weight[lab.clamp(0, weight.shape[0] - 1)]
        out = out * cw
        if reduction == 'mean':
            denom = torch.where(valid, cw, 0.0).sum()
            return out.sum() / denom.clamp_min(1e-12)
    if reduction == 'mean':
        denom = valid.sum().to(input.dtype).clamp_min(1)
        return out.sum() / denom
    return _reduce(out, reduction)


def linear_cross_entropy(input, weight, label, bias=None, ignore_index=-100,
                         transpose_weight=False, chunk_rows=None):
    """Fused linear head + mean softmax cross-entropy (hard labels):
    cross_entropy(input @ weight + bias, label) without the [rows, vocab]
    logits (ops/fused_ce.py). input [..., d]; weight [d, vocab], or
    [vocab, d] with transpose_weight=True (the tied-embedding layout);
    label matches input's leading dims. chunk_rows defaults to 4096."""
    input, weight, bias = amp_cast('linear_cross_entropy', input, weight,
                                    bias)
    d = input.shape[-1]
    chunk = _fce.DEFAULT_CHUNK_ROWS if chunk_rows is None else chunk_rows
    from ...distributed.meta_parallel import mp_layers
    group = mp_layers.mp_group_of(weight)
    if group is not None:
        # a head sharded over 'mp' (tensor parallelism)
        return mp_layers.parallel_linear_cross_entropy(
            input.reshape(-1, d), weight, label.reshape(-1), bias,
            ignore_index, transpose_weight, chunk)
    w = weight.t() if transpose_weight else weight
    return _fce.linear_cross_entropy_arrays(
        input.reshape(-1, d), w, label.reshape(-1), bias, ignore_index, chunk)
