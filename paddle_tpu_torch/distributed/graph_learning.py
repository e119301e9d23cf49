"""GNN training bridge over the distributed graph engine (counterpart of
paddle_tpu/distributed/graph_learning.py).

The reference fork's marquee feature is a brpc-sharded graph store feeding
GNN trainers (reference: paddle/fluid/distributed/table/
common_graph_table.cc + graph_py_service.cc; consumed there by PGL-style
samplers). This module is the consumption path: sample fixed fan-out
neighborhoods through GraphPyClient on the host, pad to static shapes (no
masks), copy the batch's features to the card once, and aggregate there
with a GraphSAGE layer.
"""
import numpy as np
import torch
from torch import nn

from ..nn.layer.common import Linear

__all__ = ['neighbor_sample', 'gather_features', 'GraphSageLayer',
           'sample_and_gather']


def neighbor_sample(client, etype, ids, fanout):
    """Fixed fan-out neighbor sample with self-fallback padding.

    Returns int64 [len(ids), fanout]: the engine pads missing neighbors
    with -1 (isolated node or fanout > degree); those slots are replaced
    by the node itself so downstream gathers stay in-bounds and the mean
    aggregator degrades to self-features — static shapes, no masks.
    """
    ids = np.asarray(ids, np.int64)
    neigh = client.sample_neighbors(etype, ids, fanout)
    self_col = np.broadcast_to(ids[:, None], neigh.shape)
    return np.where(neigh < 0, self_col, neigh)


def gather_features(client, etype, ids, dim):
    """Features for a (possibly shaped) id array: [*, dim] float32."""
    ids = np.asarray(ids, np.int64)
    flat = client.get_node_feat(etype, ids.reshape(-1), dim)
    return flat.reshape(ids.shape + (dim,))


def sample_and_gather(client, etype, batch_ids, fanouts, dim):
    """Multi-hop subgraph batch: returns (self_feat, [hop1_feat, ...])
    where hop k has shape [B, fanout_1, ..., fanout_k, dim], host numpy
    arrays. The sampling rides the service (host side); move the arrays
    to the card in one copy each (`torch.from_numpy(a).to(device)`)."""
    ids = np.asarray(batch_ids, np.int64)
    feats = [gather_features(client, etype, ids, dim)]
    frontier = ids
    for f in fanouts:
        frontier = neighbor_sample(client, etype, frontier.reshape(-1),
                                   f).reshape(frontier.shape + (f,))
        feats.append(gather_features(client, etype, frontier, dim))
    return feats[0], feats[1:]


class GraphSageLayer(nn.Module):
    """GraphSAGE mean aggregator (Hamilton et al.; the PGL layer the
    reference's graph engine feeds): h = act(W [self || mean(neigh)]).
    `act` names a torch.nn.functional activation, or None. Its state_dict
    is the JAX layer's (linear.weight [2 in, out], linear.bias)."""

    def __init__(self, in_dim, out_dim, act='relu', *, device=None,
                 dtype='float32', generator=None):
        super().__init__()
        self.linear = Linear(2 * in_dim, out_dim, device=device,
                             dtype=dtype, generator=generator)
        self._act = act

    def forward(self, self_feat, neigh_feat):
        agg = torch.mean(neigh_feat, dim=-2)
        h = self.linear(torch.cat([self_feat, agg], dim=-1))
        if self._act:
            h = getattr(torch.nn.functional, self._act)(h)
        return h
