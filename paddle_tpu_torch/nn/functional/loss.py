"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py): the
softmax cross-entropy (hard or soft labels, class weights, any axis,
use_softmax=False), the fused LM-head cross-entropy that GPT training
uses, the rest of the reference's losses and CTC. Each casts its inputs
under auto_cast by the JAX package's op name.

The JAX package's quirks are kept: binary_cross_entropy clips its input
to [1e-12, 1 - 1e-7] in the input's dtype, kl_div takes log(max(label,
1e-12)) (not torch's xlogy), nll_loss's weighted 'mean' divides by the
summed weights of the valid rows. ctc_loss is the JAX package's function,
not torch's F.ctc_loss: see its docstring."""
import torch

from ...amp.auto_cast import cast as amp_cast
from ...ops import fused_ce as _fce

__all__ = [
    'cross_entropy', 'linear_cross_entropy',
    'softmax_with_cross_entropy', 'binary_cross_entropy',
    'binary_cross_entropy_with_logits', 'nll_loss', 'mse_loss', 'l1_loss',
    'smooth_l1_loss', 'kl_div', 'margin_ranking_loss', 'hinge_embedding_loss',
    'cosine_embedding_loss', 'ctc_loss', 'log_loss', 'square_error_cost',
    'triplet_margin_loss', 'sigmoid_focal_loss', 'dice_loss',
    'npair_loss', 'multi_label_soft_margin_loss', 'soft_margin_loss',
]


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
    return _picked_nll(out, lab, valid, weight, reduction, input.dtype)


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """cross_entropy with reduction 'none', the class axis kept as size 1;
    with return_softmax also softmax(logits) along `axis`."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction='none',
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction='mean',
                         name=None):
    input, label, weight = amp_cast('bce', input, label, weight)
    a = input.clamp(1e-12, 1.0 - 1e-7)
    out = -(label * torch.log(a) + (1 - label) * torch.log(1 - a))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction='mean', pos_weight=None,
                                     name=None):
    logit, label, weight = amp_cast('bce_logits', logit, label, weight)
    maxv = torch.clamp_min(-logit, 0.0)
    softplus = torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        out = (1 - label) * logit + log_w * (softplus + maxv)
    else:
        out = (1 - label) * logit + softplus + maxv
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def _picked_nll(out, lab, valid, weight, reduction, dtype):
    """The weighted / masked reduction nll_loss and cross_entropy share."""
    if weight is not None:
        cw = weight[lab.clamp(0, weight.shape[0] - 1)]
        out = out * cw
        if reduction == 'mean':
            return out.sum() / torch.where(valid, cw, 0.0).sum().clamp_min(
                1e-12)
    if reduction == 'mean':
        return out.sum() / valid.sum().to(dtype).clamp_min(1.0)
    return _reduce(out, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction='mean',
             name=None):
    """-input[n, label[n], ...] over log-probabilities `input` [N, C, ...];
    rows whose label == ignore_index give 0."""
    input, weight = amp_cast('nll_loss', input, weight)
    lab = label.long()
    valid = lab != ignore_index
    safe = lab.clamp(0, input.shape[1] - 1)
    out = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    out = torch.where(valid, out, 0.0)
    return _picked_nll(out, lab, valid, weight, reduction, input.dtype)


def mse_loss(input, label, reduction='mean', name=None):
    input, label = amp_cast('mse_loss', input, label)
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):
    input, label = amp_cast('square_error_cost', input, label)
    return torch.square(input - label)


def l1_loss(input, label, reduction='mean', name=None):
    input, label = amp_cast('l1_loss', input, label)
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction='mean', delta=1.0, name=None):
    input, label = amp_cast('smooth_l1', input, label)
    d = input - label
    absd = d.abs()
    out = torch.where(absd < delta, 0.5 * d * d / delta, absd - 0.5 * delta)
    return _reduce(out, reduction)


def kl_div(input, label, reduction='mean', name=None):
    """label * (log(max(label, 1e-12)) - input); 'batchmean' divides the
    sum by the batch."""
    input, label = amp_cast('kl_div', input, label)
    out = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == 'batchmean':
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction='mean',
                        name=None):
    input, other, label = amp_cast('margin_ranking', input, other, label)
    out = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(out, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction='mean',
                         name=None):
    input, label = amp_cast('hinge_embedding', input, label)
    out = torch.where(label == 1.0, input,
                      torch.clamp_min(margin - input, 0.0))
    return _reduce(out, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction='mean', name=None):
    input1, input2, label = amp_cast('cosine_embedding', input1, input2,
                                     label)
    norms = torch.linalg.vector_norm(input1, dim=-1) * \
        torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(-1) / torch.clamp_min(norms, 1e-12)
    out = torch.where(label == 1, 1.0 - cos, torch.clamp_min(cos - margin,
                                                             0.0))
    return _reduce(out, reduction)


def log_loss(input, label, epsilon=0.0001, name=None):
    input, label = amp_cast('log_loss', input, label)
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction='sum', name=None):
    logit, label, normalizer = amp_cast('sigmoid_focal', logit, label,
                                        normalizer)
    p = torch.sigmoid(logit)
    ce = (1 - label) * logit + torch.log1p(torch.exp(-logit.abs())) + \
        torch.clamp_min(-logit, 0.0)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


def dice_loss(input, label, epsilon=1e-05, name=None):
    """1 - (2 |X n Y| + eps) / (|X| + |Y| + eps) per sample, averaged;
    label [..., 1] holds class indices along input's last dim."""
    input, = amp_cast('dice_loss', input)
    onehot = torch.nn.functional.one_hot(
        label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = 2 * (input * onehot).sum(dims)
    union = input.sum(dims) + onehot.sum(dims)
    return (1.0 - (inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    anchor, positive = amp_cast('npair_loss', anchor, positive)
    sim = anchor @ positive.t()
    lab = labels.reshape(-1, 1)
    tgt = (lab == lab.t()).to(anchor.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(1)
    reg = l2_reg * (torch.square(anchor).sum() +
                    torch.square(positive).sum()) / (2.0 * anchor.shape[0])
    return ce.mean() + reg


def _pdist(a, b, p, epsilon):
    return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1), 1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction='mean',
                        name=None):
    input, positive, negative = amp_cast('triplet_margin', input, positive,
                                         negative)
    dp = _pdist(input, positive, p, epsilon)
    dn = _pdist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(positive, negative, p, epsilon))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction='mean', name=None):
    input, label, weight = amp_cast('ml_soft_margin', input, label, weight)
    logsig = torch.nn.functional.logsigmoid
    out = -(label * logsig(input) + (1 - label) * logsig(-input))
    if weight is not None:
        out = out * weight
    return _reduce(out.mean(-1), reduction)


def soft_margin_loss(input, label, reduction='mean', name=None):
    input, label = amp_cast('soft_margin', input, label)
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


CTC_NEG_INF = -1e30


class _LogAddExp(torch.autograd.Function):
    """logaddexp with JAX's derivative, exp(x - out) for each input. With
    -1e30 standing for minus infinity, -1e30 + log 2 rounds to -1e30, so
    two equal inputs each get 1 where torch's rule gives 1/2: an
    infeasible CTC row's gradient follows JAX's."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction='mean', norm_by_times=False):
    """CTC as the JAX package computes it: the alpha recursion in log space
    over the time axis, one vectorised [B, 2L + 1] step a time step.

    log_probs [T, B, C] are logits: they are log-softmaxed first. labels
    [B, L]. Where it differs from torch's F.ctc_loss:
    - its minus infinity is the finite -1e30, so a row whose label cannot
      fit its input length gives a loss near 1e30 (torch: inf);
    - 'mean' divides each row's loss by its label length (at least 1)
      before averaging;
    - norm_by_times scales only the gradient, by 1 / input length;
    - the gradient reaches the logits through the log-softmax (torch's
      CTC backward is right only for normalised input).
    The state past a row's input length is frozen, as in the JAX scan."""
    logits, = amp_cast('ctc_loss', log_probs)
    lab = labels.long()
    il = input_lengths.to(device=logits.device, dtype=torch.long)
    ll = label_lengths.to(device=logits.device, dtype=torch.long)
    logp = torch.log_softmax(logits, dim=-1)
    T, B, _ = logp.shape
    S = 2 * lab.shape[1] + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=logp.device)
    ext[:, 1::2] = lab
    neg = torch.full((), CTC_NEG_INF, dtype=logp.dtype, device=logp.device)
    rows = torch.arange(B, device=logp.device)
    alpha = torch.cat([
        logp[0, rows, blank][:, None],
        torch.where(ll > 0, logp[0, rows, ext[:, 1]], neg)[:, None],
        neg.expand(B, S - 2)], dim=1)
    same2 = torch.cat([torch.ones(B, 2, dtype=torch.bool,
                                  device=logp.device),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, T):
        shift1 = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
        shift2 = torch.where(same2, neg, torch.cat(
            [neg.expand(B, 2), alpha[:, :-2]], dim=1))
        merged = _LogAddExp.apply(_LogAddExp.apply(alpha, shift1), shift2)
        new = merged + logp[t].gather(1, ext)
        alpha = torch.where((t < il)[:, None], new, alpha)
    end1 = alpha[rows, 2 * ll]
    end2 = torch.where(ll > 0, alpha[rows, (2 * ll - 1).clamp_min(0)], neg)
    loss = -_LogAddExp.apply(end1, end2)
    if norm_by_times:
        t_inv = loss / il.to(loss.dtype).clamp_min(1.0)
        loss = t_inv + (loss - t_inv).detach()
    if reduction == 'mean':
        return (loss / ll.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)
