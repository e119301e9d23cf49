"""Tensor-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py; reference:
fleet/meta_parallel/parallel_layers/mp_layers.py:30,97,170,249 —
VocabParallelEmbedding / ColumnParallelLinear / RowParallelLinear /
ParallelCrossEntropy).

The JAX package's TP layer is an ordinary layer whose parameters carry
'mp' placement hints; XLA's SPMD partitioner inserts the all-gathers and
reduce-scatters. Here a TP parameter is a DTensor with a Shard placement
on the mesh's 'mp' axis and the layer computes on its local shard with
the reference's explicit collectives (Megatron's f / g):
`copy_to_mp` (identity forward, all-reduce of the grad) in front of a
column-parallel product, `reduce_from_mp` (all-reduce forward, identity
backward) after a row-parallel one. Every collective is skipped on a
one-rank mp axis, where the same code runs.

The GPT's fused QKV weight [hidden, 3 * hidden] is (None, 'mp'): a column
shard does not fall on head boundaries, so the attention gathers the
weight (a [hidden, 3 * hidden] all-gather a layer; its grad returns as a
sum over the ranks, each rank's own columns kept) and takes its heads'
columns; the activations are never gathered. The vocab-parallel loss
takes a local max and sum and all-reduces [rows] vectors
(ops/fused_ce.py, ParallelCrossEntropy below); the [rows, vocab] logits
are never gathered.
"""
import collections

import torch
import torch.distributed as dist
from torch import nn

from ...nn import functional as F

__all__ = ['VocabParallelEmbedding', 'ColumnParallelLinear',
           'RowParallelLinear', 'ParallelCrossEntropy', 'mp_group_of',
           'copy_to_mp', 'reduce_from_mp', 'local_of']

MPGroup = collections.namedtuple('MPGroup', 'pg rank size dim')


def mp_group_of(param):
    """MPGroup(pg, rank, size, dim) when `param` is a DTensor sharded on
    dim `dim` over a mesh axis named 'mp', else None."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(param, DTensor):
        return None
    mesh = param.device_mesh
    names = mesh.mesh_dim_names or ()
    if 'mp' not in names:
        return None
    place = param.placements[names.index('mp')]
    if not isinstance(place, Shard):
        return None
    return MPGroup(mesh.get_group('mp'), mesh.get_local_rank('mp'),
                   mesh.size(names.index('mp')), place.dim)


def local_of(param):
    """A DTensor parameter's local shard (differentiable), else itself."""
    from torch.distributed.tensor import DTensor
    return param.to_local() if isinstance(param, DTensor) else param


def _all_reduce(x, group):
    if group.size > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=group.pg)
    return x


def _all_gather(x, dim, group):
    if group.size == 1:
        return x
    parts = [torch.empty_like(x.contiguous()) for _ in range(group.size)]
    dist.all_gather(parts, x.contiguous(), group=group.pg)
    return torch.cat(parts, dim=dim)


def _chunk(x, dim, group):
    if group.size == 1:
        return x
    return x.chunk(group.size, dim=dim)[group.rank].contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherPartial(torch.autograd.Function):
    """All-gather of shards along dim; the ranks use different parts of
    the result, so its grad is summed over the ranks and each keeps its
    own shard."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(_all_reduce(g.clone(), ctx.group), ctx.dim,
                      ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather of shards along dim for a use every rank makes alike:
    the grad is the same on every rank, and each keeps its own shard."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def copy_to_mp(x, group):
    return x if group.size == 1 else _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return x if group.size == 1 else _ReduceFromMP.apply(x, group)


def gather_partial(x, dim, group):
    return x if group.size == 1 else _GatherPartial.apply(x, dim, group)


def gather_replicated(x, dim, group):
    return x if group.size == 1 else _GatherReplicated.apply(x, dim, group)


def scatter_to_mp(x, dim, group):
    return x if group.size == 1 else _ScatterToMP.apply(x, dim, group)


def vocab_parallel_embedding(ids, weight):
    """Embedding lookup of `ids` in a [vocab, dim] weight sharded on the
    vocab over 'mp': each rank looks up the ids of its rows (the others
    read 0) and the rows are summed over the ranks."""
    group = mp_group_of(weight)
    local = local_of(weight)
    if group.size == 1:
        return F.embedding(ids, local)
    rows = local.shape[0]
    start = group.rank * rows
    inside = (ids >= start) & (ids < start + rows)
    out = F.embedding(torch.where(inside, ids - start, 0), local)
    out = out * inside.unsqueeze(-1).to(out.dtype)
    return reduce_from_mp(out, group)


def qkv_head_columns(weight, bias, num_heads):
    """The columns (and bias entries) of this rank's heads from a fused
    [hidden, 3 * hidden] QKV weight sharded (None, 'mp'): the weight and
    the bias are gathered, and [hidden, 3, heads, d] is cut to the rank's
    heads. Returns (w [hidden, 3 * local * d], b, local heads)."""
    group = mp_group_of(weight)
    w = gather_partial(local_of(weight), 1, group)
    hidden = w.shape[0]
    d = w.shape[1] // (3 * num_heads)
    if num_heads % group.size:
        raise ValueError('%d heads do not split over %d mp ranks'
                         % (num_heads, group.size))
    per = num_heads // group.size
    h0 = group.rank * per
    w = w.view(hidden, 3, num_heads, d)[:, :, h0:h0 + per].reshape(
        hidden, 3 * per * d)
    b = None
    if bias is not None:
        bgroup = mp_group_of(bias)
        b = local_of(bias) if bgroup is None else \
            gather_partial(local_of(bias), 0, bgroup)
        b = b.view(3, num_heads, d)[:, h0:h0 + per].reshape(3 * per * d)
    return w, b, per


def column_linear(x, weight, bias=None):
    """x (alike on every rank) @ a weight sharded (None, 'mp') + its
    ('mp',) bias: this rank's output columns."""
    group = mp_group_of(weight)
    out = torch.matmul(copy_to_mp(x, group), local_of(weight))
    if bias is not None:
        out = out + local_of(bias)
    return out


def row_linear(x_local, weight, bias=None):
    """This rank's input columns @ a weight sharded ('mp', None), summed
    over the ranks, + a replicated bias."""
    group = mp_group_of(weight)
    out = reduce_from_mp(torch.matmul(x_local, local_of(weight)), group)
    if bias is not None:
        out = out + local_of(bias)
    return out


def _distribute(layer, name, placement):
    """Lay layer.<name> out on the current mesh's 'mp' axis (rank 0's
    values) with the placement hint; stays plain without a mesh."""
    from ..strategy import NamedSharding, P
    from ..topology import get_hybrid_communicate_group
    from torch.distributed.tensor import distribute_tensor
    p = getattr(layer, name)
    p.placement = placement
    p.is_distributed = True
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return
    mesh = hcg.mesh
    spec = P(*[ax if ax is None or p.shape[i] % mesh.size(
        mesh.mesh_dim_names.index(ax)) == 0 else None
        for i, ax in enumerate(placement)])
    sh = NamedSharding(mesh, spec)
    sub = sh.submesh()
    new = nn.Parameter(distribute_tensor(p.detach(), sub,
                                         sh.placements(sub)),
                       requires_grad=p.requires_grad)
    new.placement, new.is_distributed = placement, True
    setattr(layer, name, new)


def _xavier(shape, device, generator=None):
    """The JAX layers' default initializer, drawn on the CPU."""
    from ...nn.initializer import XavierNormal
    return XavierNormal()(shape, generator=generator).to(device)


class VocabParallelEmbedding(nn.Module):
    """[num_embeddings, dim] weight sharded ('mp', None)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, generator=None):
        super().__init__()
        from ...framework import device as device_mod
        dev = device_mod.resolve(device)
        self._num_embeddings = num_embeddings
        self.weight = nn.Parameter(_xavier((num_embeddings, embedding_dim),
                                           dev, generator))
        _distribute(self, 'weight', ('mp', None))

    def forward(self, x):
        if mp_group_of(self.weight) is None:
            return F.embedding(x, self.weight)
        return vocab_parallel_embedding(x, self.weight)


class ColumnParallelLinear(nn.Module):
    """[in, out] weight sharded (None, 'mp') and its bias ('mp',); the
    output is this rank's columns, gathered when gather_output."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, generator=None):
        super().__init__()
        from ...framework import device as device_mod
        dev = device_mod.resolve(device)
        self.weight = nn.Parameter(_xavier((in_features, out_features), dev,
                                           generator))
        _distribute(self, 'weight', (None, 'mp'))
        self.gather_output = gather_output
        if has_bias is None or has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev))
            _distribute(self, 'bias', ('mp',))
        else:
            self.bias = None

    def forward(self, x):
        group = mp_group_of(self.weight)
        if group is None:
            return F.linear(x, self.weight, self.bias)
        out = column_linear(x, self.weight, self.bias)
        if self.gather_output:
            out = gather_replicated(out, out.dim() - 1, group)
        return out


class RowParallelLinear(nn.Module):
    """[in, out] weight sharded ('mp', None), replicated bias; the input is
    this rank's columns when input_is_parallel, else the whole input (its
    columns are taken here); the output is summed over the ranks."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        from ...framework import device as device_mod
        dev = device_mod.resolve(device)
        self.weight = nn.Parameter(_xavier((in_features, out_features), dev,
                                           generator))
        _distribute(self, 'weight', ('mp', None))
        self.input_is_parallel = input_is_parallel
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev)) \
            if has_bias else None

    def forward(self, x):
        group = mp_group_of(self.weight)
        if group is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_mp(x, x.dim() - 1, group)
        return row_linear(x, self.weight, self.bias)


def parallel_linear_cross_entropy(x, weight, labels, bias, ignore_index,
                                  transpose_weight, chunk):
    """The fused head + mean CE for a head weight sharded over 'mp'
    ([vocab, d] with transpose_weight, else [d, vocab]). Under
    ops.fused_ce.logits_sharding (TrainStep's fce_sharding) a vocabulary
    shard takes the vocab-parallel loss; otherwise the weight (and bias)
    are gathered and every rank runs the whole loss."""
    from ...ops import fused_ce
    group = mp_group_of(weight)
    vocab_dim = 0 if transpose_weight else 1
    local = local_of(weight)
    if group.dim == vocab_dim and \
            fused_ce.active_logits_sharding() is not None:
        w = local.t() if transpose_weight else local
        b = local_of(bias) if bias is not None else None
        return fused_ce.linear_cross_entropy_vocab_parallel(
            x, w, labels, group.rank * w.shape[1], group, b, ignore_index,
            chunk)
    full = gather_replicated(local, group.dim, group)
    w = full.t() if transpose_weight else full
    if bias is not None:
        bgroup = mp_group_of(bias)
        bias = local_of(bias) if bgroup is None else \
            gather_replicated(local_of(bias), 0, bgroup)
    return fused_ce.linear_cross_entropy_arrays(x, w, labels, bias,
                                                ignore_index, chunk)


class _VocabParallelSoftmaxCE(torch.autograd.Function):
    """Per-row softmax CE of logits whose last dim is this rank's vocab
    shard: a local max and sum, all-reduced over [rows] vectors."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index, group):
        x = logits.float()
        vocab = x.shape[-1]
        start = group.rank * vocab
        mx = x.amax(dim=-1)
        _all_reduce_op(mx, group, dist.ReduceOp.MAX)
        e = torch.exp(x - mx.unsqueeze(-1))
        s = _all_reduce(e.sum(dim=-1), group)
        inside = (label >= start) & (label < start + vocab)
        local = torch.where(inside, label - start, 0)
        picked = torch.where(inside, x.gather(-1, local.unsqueeze(-1))[..., 0],
                             0.0)
        picked = _all_reduce(picked, group)
        valid = label != ignore_index
        loss = torch.where(valid, torch.log(s) + mx - picked, 0.0)
        ctx.save_for_backward(e, s, local, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside, valid = ctx.saved_tensors
        p = e / s.unsqueeze(-1)
        onehot = torch.zeros_like(p).scatter_(-1, local.unsqueeze(-1), 1.0)
        p = p - onehot * inside.unsqueeze(-1).to(p.dtype)
        grad = p * (g * valid.to(g.dtype)).unsqueeze(-1)
        return grad.to(ctx.dtype), None, None, None


def _all_reduce_op(x, group, op):
    if group.size > 1:
        dist.all_reduce(x, op=op, group=group.pg)
    return x


class ParallelCrossEntropy(nn.Module):
    """Vocab-parallel softmax CE (reference: mp_layers.py:249, backed by
    c_softmax_with_cross_entropy_op.cu): `input` is this rank's vocab
    shard of the logits when the current mesh's mp degree is above 1, the
    whole logits otherwise; returns the per-row loss ('none')."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def _mp(self):
        from ..topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is None or hcg.get_model_parallel_world_size() == 1:
            return None
        mesh = hcg.mesh
        return MPGroup(mesh.get_group('mp'), mesh.get_local_rank('mp'),
                       hcg.get_model_parallel_world_size(), None)

    def forward(self, input, label):
        group = self._mp()
        if group is None:
            return F.cross_entropy(input, label, reduction='none',
                                   ignore_index=self.ignore_index)
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        loss = _VocabParallelSoftmaxCE.apply(input, label.long(),
                                             self.ignore_index, group)
        return loss.to(input.dtype)

