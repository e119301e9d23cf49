"""paddle.static.nn (counterpart of paddle_tpu/static/nn.py; reference:
python/paddle/static/nn/__init__.py — static layer builders and the
control-flow ops of fluid/layers/control_flow.py).

Control flow, as in the JAX package, builds its branches once eagerly
(the reference builds both sub-blocks too) while framework/recorder.py
records them; each branch becomes an fx.GraphModule over the tensors it
reads, and the op runs on torch's control-flow operators, so a Program
that records it replays it inside one compiled graph:
- `cond` is torch.cond over the two branches; `case` is a chain of conds;
  `switch_case` is a chain of torch.cond over the branch index. Gradients
  flow to every tensor a branch reads.
- `while_loop` is torch's while_loop operator over the condition and the
  body recorded once on the loop variables. Its outputs stop the
  gradient, as in the JAX package (XLA's while has no reverse).

The builders whose layers the port has are here: fc, embedding, the
norms (batch_norm, layer_norm, instance_norm, group_norm), prelu, the
convolutions (conv2d, conv2d_transpose, conv3d, conv3d_transpose),
create_parameter, py_func and the fluid-era aliases lrn, cos_sim,
space_to_depth and reverse. Each builds a fresh layer on the input's
device, its weights drawn from torch's default generator; the arguments
the JAX package's builder ignores (in **kw) are ignored here too.

The fluid-era builders are here too: data_norm, bilinear_tensor_product,
rank_loss, bpr_loss, center_loss (its eager update of the centres), cvm,
pad_constant_like, im2sequence, row_conv, sample_logits, and the CRF's
linear_chain_crf and crf_decoding (the forward recursion and Viterbi over
masked lengths). Where the JAX builder draws a default from numpy
(bilinear_tensor_product's weight, linear_chain_crf's transition,
sample_logits' negatives), the port draws the same values.

spectral_norm, nce and sparse_embedding refuse as the JAX package's do
(nn.utils.spectral_norm works on the layer); the LoD sequence ops raise
NotImplementedError naming their ROADMAP item. deform_conv2d passes
through to vision.ops.deform_conv2d, as the JAX builder does.
"""
import operator

import numpy as np
import torch
import torch.fx as fx
from torch.utils import _pytree as pytree

from ..framework import recorder

__all__ = ['fc', 'cond', 'case', 'switch_case', 'while_loop', 'embedding',
           'batch_norm', 'layer_norm', 'instance_norm', 'group_norm',
           'prelu', 'conv2d', 'conv2d_transpose', 'conv3d', 'spectral_norm',
           'create_parameter', 'py_func', 'data_norm', 'nce',
           'conv3d_transpose',
           'sparse_embedding', 'bilinear_tensor_product', 'deform_conv2d']


# -- control flow ------------------------------------------------------------

def _record_branch(fn):
    """Run a branch builder eagerly, recording its torch calls apart from
    any enclosing Program's."""
    rec = recorder.Recording()
    with recorder.recording(rec):
        out = fn()
    return out, rec


def _reads(rec, outs):
    """The tensors a recorded branch reads (or returns) that it did not
    make: the operands its gradients flow to."""
    made, reads, seen = set(), [], set()
    for c in rec.calls:
        for t in c.ins:
            if id(t) not in made and id(t) not in seen:
                seen.add(id(t))
                reads.append(t)
        made.update(id(t) for t in c.outs)
    for t in outs:
        if id(t) not in made and id(t) not in seen:
            seen.add(id(t))
            reads.append(t)
    return reads


def _union(*groups):
    out, seen = [], set()
    for group in groups:
        for t in group:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _flat(out, what):
    """The tensors of a branch's output; [] when it returns nothing."""
    leaves = pytree.tree_leaves(out)
    if all(t is None for t in leaves):
        return []
    if any(not isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError('%s branches must return tensors (or nested lists '
                        'of them), got %r' % (what, out))
    return leaves


def _branch_module(rec, inputs, outputs, single=False):
    """The recorded branch as a GraphModule from `inputs` to the tuple of
    `outputs` (to the one output with single=True); an output that is an
    input leaves as a copy (a control-flow operator's branch may not
    return an alias of its operands)."""
    gm = rec.graph_module(inputs, outputs)
    out = next(n for n in gm.graph.nodes if n.op == 'output')
    with gm.graph.inserting_before(out):
        values = tuple(gm.graph.call_function(torch.clone, (v,))
                       if v.op in ('placeholder', 'get_attr') else v
                       for v in out.args[0])
    out.args = (values[0] if single else values,)
    gm.recompile()
    return gm


def _run_recorded(func, args):
    """Run a control-flow operator eagerly with the recorder paused, then
    record it as one call of the enclosing Program."""
    with recorder.paused():
        out = func(*args)
    recorder.record(func, args, {}, out)
    return out


def _scalar(value, dtype):
    """A predicate or an index as a 0-d tensor of `dtype` (recorded calls
    under a program_guard)."""
    return torch.as_tensor(value).reshape(()).to(dtype)


def cond(pred, true_fn=None, false_fn=None, name=None):
    """torch.cond (reference control_flow.py cond / conditional_block op).
    Both branches are built once eagerly and run through torch.cond on the
    tensors they read, so gradients flow to the leaves of both. Branch
    outputs may be a tensor or nested lists / tuples of them; both must
    have the same structure."""
    t_out, t_rec = _record_branch(true_fn)
    f_out, f_rec = _record_branch(false_fn)
    t_spec = pytree.tree_flatten(t_out)[1]
    f_spec = pytree.tree_flatten(f_out)[1]
    if t_spec != f_spec:
        raise TypeError('cond branches must return the same structure: '
                        '%s vs %s' % (t_spec, f_spec))
    t_leaves = _flat(t_out, 'cond')
    f_leaves = _flat(f_out, 'cond')
    if not t_leaves:
        return t_out  # e.g. both branches return None (side-effect build)
    operands = _union(_reads(t_rec, t_leaves), _reads(f_rec, f_leaves))
    branches = (_branch_module(t_rec, operands, t_leaves),
                _branch_module(f_rec, operands, f_leaves))
    out = _run_recorded(torch.cond, (_scalar(pred, torch.bool), *branches,
                                     tuple(operands)))
    return pytree.tree_unflatten(list(out), t_spec)


def case(pred_fn_pairs, default=None, name=None):
    """First-true-wins chain of conds (reference control_flow.case)."""
    if not pred_fn_pairs:
        raise ValueError('case needs at least one (pred, fn) pair')

    def build(pairs):
        (p, fn) = pairs[0]
        if len(pairs) == 1:
            if default is None:
                return fn()
            return cond(p, fn, default)
        return cond(p, fn, lambda: build(pairs[1:]))
    return build(list(pred_fn_pairs))


def _switch_module(index, branches, operands):
    """A GraphModule over (index, *operands): torch.cond(index == 0,
    branch 0, the same over branches 1...), the last branch taken when no
    earlier index matched."""
    if len(branches) == 1:
        return branches[0]
    rest = _switch_module(index + 1, branches[1:], operands)
    root = torch.nn.Module()
    root.branch = branches[0]
    root.rest = rest
    g = fx.Graph()
    args = [g.placeholder('index')] + [g.placeholder('operand_%d' % i)
                                       for i in range(len(operands))]
    pred = g.call_function(operator.eq, (args[0], index))
    out = g.call_function(torch.cond, (pred, g.get_attr('branch'),
                                       g.get_attr('rest'), tuple(args)))
    n = len(next(n for n in branches[0].graph.nodes
                  if n.op == 'output').args[0])
    g.output(tuple(g.call_function(operator.getitem, (out, i))
                   for i in range(n)))
    return fx.GraphModule(root, g)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """A chain of torch.cond over the branch index (reference
    control_flow.switch_case). branch_fns: {index: fn} or [(index, fn)] or
    [fn, ...]. An index outside the table takes `default`, else the branch
    of the largest index. Branches are recorded once each and gradients
    flow to the tensors they read, as in cond."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((int(i), f) for i, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    if not items:
        raise ValueError('switch_case needs at least one branch')
    if items[0][0] < 0:
        raise ValueError('switch_case branch indices must be non-negative, '
                         'got %r' % (items[0][0],))
    max_idx = items[-1][0]
    table = {int(i): f for i, f in items}
    fallback = default or items[-1][1]
    fns = [table.get(i, fallback) for i in range(max_idx + 1)] + [fallback]

    # record each distinct builder once; gaps and out-of-range share one
    recorded = {}
    for f in fns:
        if id(f) not in recorded:
            recorded[id(f)] = _record_branch(f)
    first_out = recorded[id(fns[0])][0]
    first_spec = pytree.tree_flatten(first_out)[1]
    for out_i, _rec in recorded.values():
        if pytree.tree_flatten(out_i)[1] != first_spec:
            raise TypeError('switch_case branches must return the same '
                            'structure')
    if not _flat(first_out, 'switch_case'):
        return first_out
    flats = {k: _flat(out, 'switch_case')
             for k, (out, _rec) in recorded.items()}
    operands = _union(*[_reads(rec, flats[k])
                        for k, (_out, rec) in recorded.items()])
    # every branch takes (index, *operands) and reads only the operands
    with recorder.paused():
        dummy = torch.zeros((), dtype=torch.int32)
    modules = {k: _branch_module(rec, [dummy] + operands, flats[k])
               for k, (_out, rec) in recorded.items()}
    flat_idx = _scalar(branch_index, torch.int32)
    in_table = torch.isin(flat_idx, torch.tensor(sorted(table),
                                                 device=flat_idx.device))
    idx = torch.where(in_table, flat_idx.clamp(0, max_idx + 1),
                      max_idx + 1).to(torch.int32)
    switch = _switch_module(0, [modules[id(f)] for f in fns], operands)
    out = _run_recorded(switch, (idx, *operands))
    return pytree.tree_unflatten(list(out), first_spec)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """torch's while_loop operator (reference control_flow.while_loop /
    while op) over the condition and the body, each recorded once on the
    loop variables. Forward-only: the outputs stop the gradient."""
    from torch._higher_order_ops.while_loop import while_loop_op
    init = list(loop_vars)

    def body():
        out = body_fn(*init)
        return list(out) if isinstance(out, (list, tuple)) else [out]
    c_out, c_rec = _record_branch(
        lambda: _scalar(cond_fn(*init), torch.bool))
    b_out, b_rec = _record_branch(body)
    if len(b_out) != len(init):
        raise ValueError('while_loop body returned %d values for %d loop '
                         'variables' % (len(b_out), len(init)))
    extra = [t for t in _union(_reads(c_rec, [c_out]), _reads(b_rec, b_out))
             if not any(t is v for v in init)]
    cond_gm = _branch_module(c_rec, init + extra, [c_out], single=True)
    body_gm = _branch_module(b_rec, init + extra, b_out)
    with torch.no_grad():
        out = _run_recorded(while_loop_op, (cond_gm, body_gm, tuple(init),
                                            tuple(extra)))
    return [t.detach() for t in out]


# -- layer builders over the port's functionals ------------------------------

def _activation(out, name):
    from ..nn import functional as F
    fn = getattr(F, name, None) or getattr(torch.nn.functional, name)
    return fn(out)


def fc(x, size, num_flatten_dims=1, activation=None, name=None, **kw):
    """A fresh Linear over x (flattened from `num_flatten_dims` on when it
    is not 1, as the JAX package's builder does)."""
    from .. import nn as _nn
    xf = torch.flatten(x, start_dim=num_flatten_dims) \
        if num_flatten_dims != 1 else x
    lin = _nn.Linear(xf.shape[-1], size, device=x.device)
    out = lin(xf)
    if activation:
        out = _activation(out, activation)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype='float32'):
    from .. import nn as _nn
    emb = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                        device=input.device)
    return emb(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, **kw):
    from ..nn import functional as F
    shape = list(input.shape[begin_norm_axis:])
    w = torch.ones(shape, dtype=torch.float32, device=input.device) \
        if scale else None
    b = torch.zeros(shape, dtype=torch.float32, device=input.device) \
        if shift else None
    return F.layer_norm(input, shape, weight=w, bias=b)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, **kw):
    """A fresh BatchNorm2D in training mode: the batch's statistics."""
    from .. import nn as _nn
    bn = _nn.BatchNorm2D(input.shape[1], momentum=momentum, epsilon=epsilon,
                         device=input.device)
    out = bn(input)
    if act:
        out = _activation(out, act)
    return out


def instance_norm(input, epsilon=1e-5, **kw):
    from .. import nn as _nn
    return _nn.InstanceNorm2D(input.shape[1], epsilon=epsilon,
                              device=input.device)(input)


def group_norm(input, groups, epsilon=1e-5, **kw):
    from .. import nn as _nn
    return _nn.GroupNorm(groups, input.shape[1], epsilon=epsilon,
                         device=input.device)(input)


def prelu(x, mode='all', param_attr=None, **kw):
    """PReLU with slope 0.25: one slope ('all') or one a channel."""
    from ..nn import functional as F
    n = 1 if mode == 'all' else x.shape[1]
    return F.prelu(x, torch.full((n,), 0.25, dtype=torch.float32,
                                 device=x.device))


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, act=None, **kw):
    from .. import nn as _nn
    conv = _nn.Conv2D(input.shape[1], num_filters, filter_size,
                      stride=stride, padding=padding, dilation=dilation,
                      groups=groups, device=input.device)
    out = conv(input)
    if act:
        out = _activation(out, act)
    return out


def conv2d_transpose(input, num_filters, filter_size=None, stride=1,
                     padding=0, **kw):
    from .. import nn as _nn
    conv = _nn.Conv2DTranspose(input.shape[1], num_filters,
                               filter_size or 3, stride=stride,
                               padding=padding, device=input.device)
    return conv(input)


def conv3d(input, num_filters, filter_size, **kw):
    from .. import nn as _nn
    return _nn.Conv3D(input.shape[1], num_filters, filter_size,
                      device=input.device)(input)


def conv3d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, **kw):
    from .. import nn as _nn
    return _nn.Conv3DTranspose(input.shape[1], num_filters,
                               filter_size or 4, stride=stride,
                               padding=padding,
                               device=input.device)(input, output_size)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, **kw):
    raise NotImplementedError(
        'spectral_norm: use nn.utils.spectral_norm on the Layer instead')


def deform_conv2d(*args, **kwargs):
    from ..vision.ops import deform_conv2d as _dc
    return _dc(*args, **kwargs)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format='NCHW'):
    from ..nn import functional as F
    return F.local_response_norm(input, size=n, alpha=alpha, beta=beta,
                                 k=k, data_format=data_format)


def cos_sim(X, Y, name=None):
    from ..nn import functional as F
    return F.cosine_similarity(X, Y, axis=1).reshape(-1, 1)


def space_to_depth(x, blocksize, name=None):
    from ..nn import functional as F
    return F.pixel_unshuffle(x, blocksize)


def reverse(x, axis, name=None):
    from ..tensor.manipulation import flip
    return flip(x, axis)


def create_parameter(*args, **kwargs):
    from . import create_parameter as _cp
    return _cp(*args, **kwargs)


def py_func(*args, **kwargs):
    from . import py_func as _pf
    return _pf(*args, **kwargs)


def _not_ported(name, needs):
    def fn(*a, **k):
        raise NotImplementedError(
            'static.nn.%s is not ported: it needs %s (ROADMAP Queue 1 '
            'item 5, slice 19)' % (name, needs))
    fn.__name__ = name
    return fn


# -- fluid-era builders (batch layout, masks for lengths) --------------------

def data_norm(input, **kw):
    """Normalise by the batch's statistics (no learned scale or shift)."""
    mu = input.mean(0, keepdim=True)
    var = input.var(0, unbiased=False, keepdim=True)
    return (input - mu) / torch.sqrt(var + 1e-5)


def nce(input, label, num_total_classes, **kw):
    raise NotImplementedError(
        'nce: use nn.functional.hsigmoid_loss or sampled softmax via '
        'paddle_tpu ops — the NCE op family is superseded')


def sparse_embedding(input, size, **kw):
    raise NotImplementedError(
        'sparse_embedding (PS-backed): construct distributed.ps.'
        'HeterEmbedding(client, table_id, dim) with an embedding service '
        'client — the 100B-feature path needs the explicit service handle')


def bilinear_tensor_product(x, y, size, **kw):
    """out[b, k] = x[b] W[k] y[b] with a fresh W [size, X, Y] drawn, as in
    the JAX package, from numpy's RandomState(0) times 0.01."""
    w = torch.nn.Parameter(torch.from_numpy((np.random.RandomState(0).randn(
        size, x.shape[-1], y.shape[-1]) * 0.01).astype(np.float32)).to(
            x.device))
    return torch.einsum('bi,kij,bj->bk', x, w, y)


def rank_loss(label, left, right, name=None):
    """RankNet pairwise loss: o = left - right, log(1 + e^o) - label * o."""
    o = left - right
    return torch.logaddexp(torch.zeros_like(o), o) - label * o


def bpr_loss(input, label, name=None):
    """Bayesian personalised ranking: per row, -mean over j != y of
    log(sigmoid(x_y - x_j)); [N, 1]."""
    n, c = input.shape
    y = label.reshape(n, 1).long()
    lsig = torch.nn.functional.logsigmoid(input.gather(1, y) - input)
    mask = torch.ones_like(input).scatter(1, y, 0.0)
    return (-(lsig * mask).sum(1) / mask.sum(1).clamp_min(1.0)).reshape(n, 1)


def center_loss(input, label, num_classes, alpha, centers=None,
                update_center=True, name=None):
    """Center loss 0.5 * ||x - c_y||^2 per sample ([N, 1]), then each
    class's centre moves toward its members by alpha * sum(x - c) /
    (1 + count), in place outside autograd (the reference's in-op update).
    Returns (loss, centers)."""
    if centers is None:
        centers = torch.zeros((num_classes, input.shape[-1]),
                              dtype=input.dtype, device=input.device)
    y = label.reshape(-1).long()
    diff = input - centers[y]
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    if update_center:
        with torch.no_grad():
            moved = centers[y] - input
            num = torch.zeros_like(centers).index_add_(0, y, moved)
            cnt = torch.zeros(num_classes, dtype=input.dtype,
                              device=input.device).index_add_(
                                  0, y, torch.ones_like(y, dtype=input.dtype))
            centers.sub_(alpha * num / (1.0 + cnt).reshape(-1, 1))
    return loss, centers


def cvm(input, cvm_input, use_cvm=True, name=None):
    """CTR show / click columns: with use_cvm the first two columns become
    (log(show + 1), log(click + 1) - log(show + 1)), else they go."""
    if not use_cvm:
        return input[:, 2:]
    show = torch.log(cvm_input[:, :1] + 1.0)
    ctr = torch.log(cvm_input[:, 1:2] + 1.0) - show
    return torch.cat([show, ctr, input[:, 2:]], dim=1)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """y padded at the end of each dim up to x's shape."""
    pads = []
    for sx, sy in zip(reversed(x.shape), reversed(y.shape)):
        pads += [0, int(sx - sy)]
    return torch.nn.functional.pad(y, pads, value=pad_value)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None,
                **kw):
    """Patches as sequence rows: [N, C, H, W] -> [N * oh * ow, C * fh *
    fw], each row channel-major, as XLA's conv_general_dilated_patches
    orders it. padding: an int, [ph, pw], or [up, left, down, right]."""
    fh, fw = (filter_size, filter_size) if isinstance(filter_size, int) \
        else filter_size
    sh, sw = (stride, stride) if isinstance(stride, int) else stride[:2]
    if isinstance(padding, int):
        up = down = left = right = padding
    elif len(padding) == 4:
        up, left, down, right = padding
    else:
        up = down = padding[0]
        left = right = padding[1]
    x = torch.nn.functional.pad(input, [left, right, up, down])
    cols = torch.nn.functional.unfold(x, (fh, fw), stride=(sh, sw))
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead row convolution over [B, L, D]: out[t] = sum over i <=
    future_context_size of w[i] * x[t + i], with a fresh trainable filter
    of 1 / (future_context_size + 1)."""
    b, l, d = input.shape
    w = torch.nn.Parameter(torch.full((future_context_size + 1, d),
                                      1.0 / (future_context_size + 1),
                                      dtype=input.dtype,
                                      device=input.device))
    out = torch.zeros_like(input)
    for i in range(future_context_size + 1):
        shifted = torch.nn.functional.pad(input, [0, 0, 0, i])[:, i:i + l]
        out = out + shifted * w[i]
    if act:
        out = _activation(out, act)
    return out


def sample_logits(logits, label, num_samples, num_true=1, seed=0,
                  remove_accidental_hits=True, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None,
                  name=None):
    """Sampled softmax's inputs: the true classes' logits and num_samples
    log-uniform negatives (numpy's RandomState(seed or None), as in the
    JAX package), each less log(Q); accidental hits of a true class get
    -1e20. Returns (sampled_logits [N, T + S], sampled_labels [N, T])."""
    n, k = logits.shape
    dev = logits.device
    if use_customized_samples:
        samples = torch.as_tensor(customized_samples, device=dev)
        probs = torch.as_tensor(customized_probabilities, device=dev)
    else:
        u = np.random.RandomState(seed or None).uniform(size=(num_samples,))
        s = np.clip((np.exp(u * np.log(k + 1.0)) - 1.0).astype(np.int64),
                    0, k - 1)
        samples = torch.as_tensor(s, device=dev)
        probs = torch.as_tensor((np.log((s + 2.0) / (s + 1.0)) /
                                 np.log(k + 1.0)).astype(np.float32),
                                device=dev)
    y = label.reshape(n, num_true).long()
    true_logit = logits.gather(1, y)
    true_q = (torch.log((y + 2.0) / (y + 1.0)) /
              torch.log(torch.tensor(k + 1.0))).to(logits.dtype)
    samp_logit = logits[:, samples.long()]
    if remove_accidental_hits:
        hit = (samples[None, None, :] == y[:, :, None]).any(1)
        samp_logit = samp_logit - hit.to(logits.dtype) * 1e20
    out = torch.cat([true_logit - torch.log(true_q),
                     samp_logit - torch.log(probs)[None, :].to(
                         logits.dtype)], dim=1)
    labels = torch.arange(num_true, dtype=torch.int32,
                          device=dev).repeat(n, 1)
    return out, labels


# -- linear-chain CRF (reference linear_chain_crf_op / crf_decoding_op) ------

def _lengths(length, b, l, device):
    if length is None:
        return torch.full((b,), l, dtype=torch.long, device=device)
    return torch.as_tensor(length, device=device).long()


def _crf_nll(emission, transition, label, length):
    """Negative log-likelihood per sequence [B, 1]. emission [B, L, K];
    transition [K + 2, K] (row 0 start, row 1 stop, rows 2.. the K x K
    transitions); label [B, L]; length [B]."""
    b, l, k = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    mask = (torch.arange(l, device=emission.device)[None, :] <
            length[:, None]).to(emission.dtype)                   # [B, L]
    alpha = start[None] + emission[:, 0]
    for t in range(1, l):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            emission[:, t]
        alpha = torch.where(mask[:, t:t + 1] > 0, nxt, alpha)
    log_z = torch.logsumexp(alpha + stop[None], dim=1)
    lb = label.long()
    em_score = (emission.gather(2, lb[:, :, None])[..., 0] * mask).sum(1)
    tr_score = (trans[lb[:, :-1], lb[:, 1:]] * mask[:, 1:]).sum(1)
    last = lb.gather(1, (length - 1).clamp_min(0)[:, None])[:, 0]
    gold = em_score + tr_score + start[lb[:, 0]] + stop[last]
    return (log_z - gold).reshape(b, 1)


def linear_chain_crf(input, label, param_attr=None, length=None,
                     transition=None, name=None):
    """Linear-chain CRF cost over input [B, L, K] emissions, label [B, L]
    and length [B] (the full L when None). A missing transition is a fresh
    Parameter [K + 2, K] drawn, as in the JAX package, from numpy's
    RandomState(0) in [-0.1, 0.1). Returns (cost [B, 1], transition)."""
    b, l, k = input.shape
    if transition is None:
        transition = torch.nn.Parameter(torch.from_numpy(
            np.random.RandomState(0).uniform(-0.1, 0.1, (k + 2, k))
            .astype(np.float32)).to(input.device))
    cost = _crf_nll(input, transition, label,
                    _lengths(length, b, l, input.device))
    return cost, transition


def crf_decoding(input, transition, length=None, label=None, name=None):
    """Viterbi path [B, L] (int32, 0 past each length) under the CRF; with
    `label`, 1 where the decoded tag equals the label, else 0."""
    b, l, k = input.shape
    lens = _lengths(length, b, l, input.device)
    start, stop, trans = transition[0], transition[1], transition[2:]
    mask = torch.arange(l, device=input.device)[None, :] < lens[:, None]
    score = start[None] + input[:, 0]
    backs = []
    for t in range(1, l):
        cand = score[:, :, None] + trans[None]                    # [B, K, K]
        best, back = cand.max(1)
        backs.append(back)
        score = torch.where(mask[:, t:t + 1], best + input[:, t], score)
    cur = (score + stop[None]).argmax(1)
    path = [cur]
    for t in range(l - 1, 0, -1):
        prev = backs[t - 1].gather(1, cur[:, None])[:, 0]
        cur = torch.where(mask[:, t], prev, cur)
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)
    path = torch.where(mask, path, 0).to(torch.int32)
    if label is not None:
        return (path == label.to(path.dtype)).to(torch.int32)
    return path


for _n in ('sequence_conv', 'sequence_softmax', 'sequence_pool',
           'sequence_concat', 'sequence_first_step', 'sequence_last_step',
           'sequence_slice', 'sequence_expand', 'sequence_expand_as',
           'sequence_pad', 'sequence_unpad', 'sequence_reshape',
           'sequence_scatter', 'sequence_enumerate', 'sequence_reverse',
           'multi_box_head'):
    globals()[_n] = _not_ported(_n, 'the LoD sequence ops (the JAX package '
                                    'refuses them too)')
    __all__.append(_n)

__all__ += ['rank_loss', 'bpr_loss', 'center_loss', 'cvm',
            'pad_constant_like', 'im2sequence', 'row_conv', 'sample_logits',
            'linear_chain_crf', 'crf_decoding', 'lrn', 'cos_sim',
            'space_to_depth', 'reverse']
