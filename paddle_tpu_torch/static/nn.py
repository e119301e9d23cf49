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

The builders whose functionals the port has are here (fc, embedding,
layer_norm, create_parameter, py_func). The conv, norm, sequence and
fluid-era loss builders wait for the conv and vision layers (ROADMAP Queue
1 item 5) and raise NotImplementedError naming it.
"""
import operator

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


def create_parameter(*args, **kwargs):
    from . import create_parameter as _cp
    return _cp(*args, **kwargs)


def py_func(*args, **kwargs):
    from . import py_func as _pf
    return _pf(*args, **kwargs)


def _not_ported(name, needs):
    def fn(*a, **k):
        raise NotImplementedError(
            'static.nn.%s is not ported: it needs %s, which comes with the '
            'conv and vision layers (ROADMAP Queue 1 item 5)' % (name, needs))
    fn.__name__ = name
    return fn


for _n, _needs in (
        ('batch_norm', 'nn.BatchNorm2D'), ('instance_norm',
                                           'nn.InstanceNorm2D'),
        ('group_norm', 'nn.GroupNorm'), ('prelu', 'F.prelu'),
        ('conv2d', 'nn.Conv2D'), ('conv2d_transpose', 'nn.Conv2DTranspose'),
        ('conv3d', 'nn.Conv3D'), ('conv3d_transpose', 'nn.Conv3DTranspose'),
        ('deform_conv2d', 'vision.ops.deform_conv2d'),
        ('spectral_norm', 'nn.utils.spectral_norm'),
        ('data_norm', 'the fluid-era norm layers'),
        ('nce', 'the fluid-era sampled losses'),
        ('sparse_embedding', 'distributed.ps.HeterEmbedding'),
        ('bilinear_tensor_product', 'the fluid-era layers'),
        ('rank_loss', 'the fluid-era losses'),
        ('bpr_loss', 'the fluid-era losses'),
        ('center_loss', 'the fluid-era losses'),
        ('cvm', 'the fluid-era CTR ops'),
        ('pad_constant_like', 'the pads'),
        ('im2sequence', 'the conv patches'),
        ('row_conv', 'the conv layers'),
        ('sample_logits', 'the fluid-era sampled losses'),
        ('linear_chain_crf', 'the fluid-era CRF ops'),
        ('crf_decoding', 'the fluid-era CRF ops'),
        ('lrn', 'F.local_response_norm'),
        ('cos_sim', 'F.cosine_similarity'),
        ('space_to_depth', 'F.pixel_unshuffle'),
        ('reverse', 'the tensor API (flip)')):
    globals()[_n] = _not_ported(_n, _needs)

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
