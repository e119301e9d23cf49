"""Collective API (counterpart of paddle_tpu/distributed/collective.py;
reference: python/paddle/distributed/collective.py:348-1578 and the
operators/collective/ c_* op family).

The JAX package is single-controller: inside a shard_map trace a
collective lowers to an XLA collective over a mesh axis, and outside one
it is the identity at world size 1. The port runs one process a rank, so
every collective here is a real torch.distributed call on the group's
ProcessGroup (NCCL on the card, gloo on the CPU). Without a process group
(one rank, nothing initialised) each acts as over a world of one, which
is what the JAX package's eager calls do. `group` is a Group (a mesh
axis of the HybridCommunicateGroup, or new_group's), a torch
ProcessGroup, or None for every rank; src / dst are global ranks, as in
Paddle and torch.

`p2p_shift` is the ring's rotation (lax.ppermute in the JAX package):
batch_isend_irecv on the group, differentiable (its backward shifts the
gradient the other way).
"""
import torch
import torch.distributed as dist

from .env import get_rank, get_world_size
from .topology import Group, get_hybrid_communicate_group

__all__ = ['ReduceOp', 'new_group', 'all_reduce', 'all_gather', 'broadcast',
           'reduce', 'scatter', 'alltoall', 'send', 'recv', 'barrier',
           'split', 'wait', 'get_group', 'p2p_shift', 'axis_group']


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}

_GROUPS = {}
_GROUP_COUNTER = [0]


def new_group(ranks=None, backend=None, timeout=None):
    """A Group over `ranks` (global ranks; every rank by default). Every
    rank of the job calls it, members or not (torch's new_group is
    collective)."""
    _GROUP_COUNTER[0] += 1
    gid = _GROUP_COUNTER[0]
    ranks = list(ranks) if ranks else list(range(get_world_size()))
    pg = dist.new_group(ranks, backend=backend) if dist.is_initialized() \
        else None
    g = Group(None, len(ranks), ranks=ranks, gid=gid, pg=pg)
    _GROUPS[gid] = g
    return g


def get_group(gid=0):
    """The Group new_group returned as `gid`; 0 is every rank."""
    if gid == 0 and gid not in _GROUPS:
        return Group(None, get_world_size(),
                     pg=dist.group.WORLD if dist.is_initialized() else None)
    return _GROUPS.get(gid)


def axis_group(axis_name):
    """A Group for `axis_name`: a Group or ProcessGroup as it is, or the
    name of an axis of the current HybridCommunicateGroup's mesh ('sp',
    'dp', ...). None when there is no such group (a world of one)."""
    if axis_name is None or isinstance(axis_name, Group):
        return axis_name
    if isinstance(axis_name, dist.ProcessGroup):
        return Group(None, dist.get_world_size(axis_name),
                     ranks=dist.get_process_group_ranks(axis_name),
                     pg=axis_name)
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError('axis %r: no HybridCommunicateGroup is set '
                             '(fleet.init builds one)' % (axis_name,))
        return None
    return hcg._group(axis_name)


def _pg(group):
    """(ProcessGroup, size) of `group`; (None, 1) for a world of one."""
    if not dist.is_initialized():
        return None, 1
    if group is None:
        return dist.group.WORLD, dist.get_world_size()
    if isinstance(group, Group):
        if group.pg is None:
            return None, 1
        return group.pg, group.nranks
    return group, dist.get_world_size(group)


def _backend(pg):
    return dist.get_backend(pg)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce `tensor` over the group in place (AVG divides the sum on
    backends without an average)."""
    pg, n = _pg(group)
    if pg is None:
        return tensor
    if op == ReduceOp.AVG:
        if _backend(pg) == 'nccl':
            work = dist.all_reduce(tensor, dist.ReduceOp.AVG, group=pg,
                                   async_op=not sync_op)
            return tensor if sync_op else work
        dist.all_reduce(tensor, dist.ReduceOp.SUM, group=pg)
        tensor.div_(n)
        return tensor
    work = dist.all_reduce(tensor, _TORCH_OPS[op], group=pg,
                           async_op=not sync_op)
    return tensor if sync_op else work


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's `tensor`, in group order, appended to tensor_list."""
    pg, n = _pg(group)
    if pg is None:
        tensor_list.append(tensor)
        return [tensor]
    parts = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(parts, tensor.contiguous(), group=pg)
    tensor_list.extend(parts)
    return parts


def broadcast(tensor, src=0, group=None, sync_op=True):
    pg, _ = _pg(group)
    if pg is not None:
        dist.broadcast(tensor, src, group=pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce into `tensor` on rank dst (the others' are left as torch
    leaves them)."""
    pg, n = _pg(group)
    if pg is None:
        return tensor
    if op == ReduceOp.AVG:
        dist.reduce(tensor, dst, dist.ReduceOp.SUM, group=pg)
        if get_rank() == dst:
            tensor.div_(n)
        return tensor
    dist.reduce(tensor, dst, _TORCH_OPS[op], group=pg)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank src's tensor_list[i] into group rank i's `tensor`."""
    pg, _ = _pg(group)
    if pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    parts = [t.contiguous() for t in tensor_list] \
        if get_rank() == src else None
    dist.scatter(tensor, parts, src=src, group=pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """in_tensor_list[j] goes to group rank j; returns (and appends to
    out_tensor_list) what each rank sent here, in group order. The
    tensors share one shape (sent as one all_to_all_single)."""
    pg, n = _pg(group)
    if pg is None:
        parts = list(in_tensor_list)
    else:
        stacked = torch.stack(list(in_tensor_list))
        out = torch.empty_like(stacked)
        dist.all_to_all_single(out, stacked, group=pg)
        parts = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(parts)
    return parts


def send(tensor, dst=0, group=None, sync_op=True):
    pg, _ = _pg(group)
    if pg is not None:
        dist.send(tensor.contiguous(), dst, group=pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    pg, _ = _pg(group)
    if pg is not None:
        dist.recv(tensor, src, group=pg)
    return tensor


def _shift(x, group, shift):
    pg, n = _pg(group)
    if pg is None or n == 1 or shift % n == 0:
        return x
    ranks = group.ranks if isinstance(group, Group) else \
        dist.get_process_group_ranks(pg)
    me = ranks.index(get_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + shift) % n], group=pg),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], group=pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def p2p_shift(x, axis_name='sp', shift=1):
    """x from the rank `shift` places before this one on the ring of
    `axis_name` (a Group, a ProcessGroup or an axis of the current mesh):
    rank i sends to i + shift and receives from i - shift."""
    return _Shift.apply(x, axis_group(axis_name), shift)


def barrier(group=None):
    pg, _ = _pg(group)
    if pg is not None:
        dist.barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    """The collectives here return when their result is ready on the
    tensor's stream; on the card this also waits for the stream."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference distributed.split (collective.py:748): a tensor-parallel
    layer of fleet.meta_parallel built over the model-parallel group and
    applied to x."""
    from .meta_parallel.mp_layers import (ColumnParallelLinear,
                                          RowParallelLinear,
                                          VocabParallelEmbedding)
    if operation == 'linear':
        if axis == 1:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=x.device)
        else:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=x.device)
        return layer(x)
    if operation == 'embedding':
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr,
                                       device=x.device)
        return layer(x)
    raise ValueError("unsupported split operation %r" % operation)
