"""Mixture-of-Experts layers with expert parallelism (counterpart of
paddle_tpu/incubate/moe.py).

Switch-Transformer routing as in the JAX package: a gate Linear, an f32
softmax over the experts, top-k (the raw top-1 probability for Switch,
the chosen gates renormalised for k > 1), a capacity of
max(1, int(capacity_factor * T / E)) slots an expert filled top-1
choices first, then top-2, ..., each in token order; a token past its
expert's capacity gets 0 from it (the block's residual carries it). The
experts are a GELU (tanh) FFN on stacked [E, H, F] / [E, F, H] weights.
The Switch load-balancing loss E * sum_e(frac_e * mean_prob_e) is kept
as `aux_loss`.

The JAX package dispatches and combines through a dense [T, E, C] one-hot
(two einsums). That tensor is T * E * C floats (335 MB at T = 8192, E = 8,
C = 1280), so the port computes each token's slot from the same cumulative
sums over the [T, E] one-hot, gathers the kept tokens into an [E, C, H]
buffer (each slot holds one token), runs the two expert products as
torch.bmm, and scatters the outputs back weighted by the gates: the same
function.

Data parallelism: the JAX model sees the global batch, so T, the
capacity, the slot positions and the aux loss's frac and mean_prob are
global. Under a TrainStep whose batch spreads over ranks (token_scope),
a rank takes the capacity from the global T, offsets its slot positions
by the lower ranks' per-round expert counts (one all_gather of a [K, E]
count a layer), and sums frac and mean_prob over the ranks before their
product (the sum's backward is a sum too: every rank's loss carries the
one global aux term, and TrainStep averages the grads). A rank's expert
buffer spans the global capacity, the other ranks' slots empty. Two
designs that drop those rows ran no faster on 4 H100s at dp 2 x ep 2
(PERF.md, fleet_probe.py runs P4, P5): a buffer sized on the host (its
read stalls every layer), and the data ranks splitting each expert's
slots (a sum and a gather of the buffer a layer), so it stays.

Expert parallelism: the expert weights carry the placement ('ep', None,
...); under ep > 1 (distributed/strategy.py) each is a DTensor Shard(0)
over 'ep' and a rank runs its E / ep experts. The ep ranks of a data
group see the same tokens and route them alike; each computes its
experts' share of the output, all-reduced over 'ep' (identity backward),
and the input and the gates enter through copy_to_mp over 'ep' (identity
forward, all-reduced grads): the tensor-parallel layers' pair of
functions (distributed/meta_parallel/mp_layers.py).
"""
import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn

from ..framework import device as device_mod
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.common import Linear
from ..nn.layer.layers import create_parameter

__all__ = ['SwitchMoE', 'GShardMoE', 'token_scope']

_TOKENS = {'group': None}


@contextlib.contextmanager
def token_scope(group):
    """Route the MoE layers over the global batch of `group` (a topology
    Group of the ranks that hold different tokens) inside the block."""
    saved = _TOKENS['group']
    _TOKENS['group'] = group if group is not None and group.nranks > 1 \
        else None
    try:
        yield
    finally:
        _TOKENS['group'] = saved


class _SumOver(torch.autograd.Function):
    """All-reduce sum over a group, whose backward is an all-reduce sum."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        x = x.clone()
        dist.all_reduce(x, group=pg)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def _ep_group(param):
    """MPGroup of the 'ep' axis when `param` is a DTensor sharded over it
    on dim 0, else None."""
    from torch.distributed.tensor import DTensor, Shard
    from ..distributed.meta_parallel.mp_layers import MPGroup
    if not isinstance(param, DTensor):
        return None
    mesh = param.device_mesh
    names = mesh.mesh_dim_names or ()
    if 'ep' not in names:
        return None
    place = param.placements[names.index('ep')]
    if not isinstance(place, Shard):
        return None
    return MPGroup(mesh.get_group('ep'), mesh.get_local_rank('ep'),
                   mesh.size(names.index('ep')), place.dim)


def _gather_counts(counts, group):
    """[ranks, K, E]: every rank's counts, in the group's rank order."""
    parts = [torch.empty_like(counts) for _ in range(group.nranks)]
    dist.all_gather(parts, counts.contiguous(), group=group.pg)
    by_rank = dict(zip(sorted(group.ranks), parts))
    return torch.stack([by_rank[r] for r in group.ranks])


class SwitchMoE(nn.Module):
    """Top-k routed MoE FFN block: y = combine(expert_ffn(dispatch(x))).
    top_k=1 is Switch; top_k=2 the GShard configuration (GShardMoE).
    hidden_size -> ffn_size -> hidden_size per expert. After a forward,
    `aux_loss` holds the load-balancing term and `last_dropped` the share
    of this rank's tokens whose first choice was past capacity (a tensor
    on the input's device, read without a sync)."""

    def __init__(self, hidden_size, ffn_size=None, num_experts=4,
                 capacity_factor=1.5, aux_loss_weight=0.01, top_k=1,
                 name=None, device=None, generator=None):
        super().__init__()
        if int(top_k) != top_k or not 1 <= int(top_k) <= num_experts:
            raise ValueError('top_k must be an integer in '
                             '[1, num_experts], got %r' % (top_k,))
        self.top_k = int(top_k)
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size or 4 * hidden_size
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.aux_loss_weight = float(aux_loss_weight)
        dev = device_mod.resolve(device)
        self.gate = Linear(hidden_size, num_experts, device=dev,
                           generator=generator)
        e, h, f = num_experts, hidden_size, self.ffn_size

        def param(shape, init):
            return create_parameter(shape, None, 'float32', init, generator,
                                    dev)
        self.w1 = param([e, h, f], I.Normal(std=1.0 / math.sqrt(h)))
        self.b1 = param([e, f], I.Constant(0.0))
        self.w2 = param([e, f, h], I.Normal(std=1.0 / math.sqrt(f)))
        self.b2 = param([e, h], I.Constant(0.0))
        # the expert dim rides the 'ep' mesh axis (distributed/strategy.py)
        self.w1.placement = ('ep', None, None)
        self.b1.placement = ('ep', None)
        self.w2.placement = ('ep', None, None)
        self.b2.placement = ('ep', None)
        self.aux_loss = None
        self.last_dropped = None

    def forward(self, x):
        """x [B, S, H] (or [T, H]) -> the same shape."""
        from ..distributed.meta_parallel.mp_layers import (copy_to_mp,
                                                           local_of,
                                                           reduce_from_mp)
        e, k_top = self.num_experts, self.top_k
        shape = x.shape
        xt = x.reshape(-1, shape[-1])                          # [T, H]
        t = xt.shape[0]
        probs = torch.softmax(self.gate(xt).float(), dim=-1)  # [T, E]
        topv, topi = probs.topk(k_top, dim=-1)                 # [T, K]
        gates = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9) \
            if k_top > 1 else topv

        group = _TOKENS['group']
        t_global = t * (group.nranks if group is not None else 1)
        cap = max(1, int(self.capacity_factor * t_global / e))
        with torch.no_grad():
            onehot = torch.nn.functional.one_hot(topi, e).float()  # [T,K,E]
            counts = onehot.sum(0)                                   # [K, E]
            if group is not None:
                every = _gather_counts(counts, group)
                below = every[:group.rank].sum(0)
                total = every.sum(0)
            else:
                below = torch.zeros_like(counts)
                total = counts
            # a round's slots start after every earlier round's tokens
            # (kept or not, as the JAX package counts them), a rank's after
            # the lower ranks' of its own round
            start = total.cumsum(0) - total + below                 # [K, E]
            # the running count over tokens, scanned along the last dim
            # (CUDA's scan over a leading dim of a [T, K, E] tensor with a
            # short trailing extent is several times slower)
            run = onehot.permute(1, 2, 0).cumsum(-1).permute(2, 0, 1)
            pos = (run - 1.0 + start[None]) * onehot
            slot = pos.sum(-1)                                       # [T, K]
            keep = slot < cap
            self.last_dropped = 1.0 - keep[:, 0].float().mean()

        ep = _ep_group(self.w1)
        w1, b1, w2, b2 = (local_of(p) for p in (self.w1, self.b1, self.w2,
                                                 self.b2))
        e_local = w1.shape[0]
        e0 = ep.rank * e_local if ep is not None else 0
        if ep is not None:
            xt_in = copy_to_mp(xt, ep)
            gates = copy_to_mp(gates, ep)
        else:
            xt_in = xt
        # each kept (token, choice) of this rank's experts to its slot row;
        # the rest to one scratch row past the buffer
        local = keep & (topi >= e0) & (topi < e0 + e_local)
        dest = torch.where(local, (topi - e0) * cap + slot.long(),
                           e_local * cap).reshape(-1)               # [T*K]
        cdt = xt.dtype
        src = xt_in[:, None, :].expand(t, k_top, shape[-1]).reshape(
            t * k_top, shape[-1])
        xin = torch.zeros(e_local * cap + 1, shape[-1], dtype=cdt,
                          device=xt.device).index_add(0, dest, src)
        xin = xin[:-1].view(e_local, cap, shape[-1])
        h1 = F.gelu(torch.bmm(xin, w1).float() + b1.float()[:, None],
                    approximate=True)
        out_e = torch.bmm(h1.to(cdt), w2).float() + b2.float()[:, None]
        rows = torch.cat([out_e.to(cdt).reshape(e_local * cap, -1),
                          out_e.new_zeros(1, shape[-1]).to(cdt)])
        weight = (gates * local).to(cdt).float().reshape(-1, 1)
        # index_select's backward is an index_add (each kept slot is one
        # row's), where indexing's sorts its indices first
        y = (rows.index_select(0, dest).float() * weight).view(
            t, k_top, -1).sum(1)
        if ep is not None:
            y = reduce_from_mp(y, ep)

        # Switch aux loss over the global batch: E * sum frac * mean_p
        frac = total[0] / t_global
        p_sum = probs.sum(0)
        if group is not None:
            p_sum = _SumOver.apply(p_sum, group.pg)
        self.aux_loss = e * torch.sum(frac * (p_sum / t_global))
        return y.reshape(shape).to(x.dtype)


class GShardMoE(SwitchMoE):
    """Top-2 routed MoE (GShard configuration): renormalised two-expert
    gates, capacity filled in top-1-first priority order."""

    def __init__(self, hidden_size, ffn_size=None, num_experts=4,
                 capacity_factor=2.0, aux_loss_weight=0.01, name=None,
                 device=None, generator=None):
        super().__init__(hidden_size, ffn_size, num_experts,
                         capacity_factor, aux_loss_weight, top_k=2,
                         name=name, device=device, generator=generator)
