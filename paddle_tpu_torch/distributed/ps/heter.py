"""Heterogeneous embedding: host-resident table + card-resident dense half
(counterpart of paddle_tpu/distributed/ps/heter.py; reference:
framework/fleet/heter_ps/heter_comm.h:50, ps_gpu_wrapper.h:50, trainer.h:180
HeterXpuTrainer — the CPU<->accelerator split that backs the "100 billion
features" capability; on a GPU this is Paddle's PSGPU / HeterPS).

The table lives in the embedding service (host RAM, optionally SSD-tiered
via tables.SsdSparseTable) and never enters device memory; each step
exchanges only the batch's rows:

  forward : pull the rows for the ids, copy them to the card  (host -> card)
  backward: copy the rows' gradients back and push them      (card -> host)

so device memory is O(batch x dim) whatever the table's size. The server
applies its optimizer to pushed grads, so the layer exposes no trainable
row Parameters to the device optimizer — only the scalar `push_token`
Parameter, kept so the layer's state_dict is the JAX package's (there it
anchors the lookup into reverse-mode AD; here it makes the lookup's output
require grad, so the backward runs even when nothing upstream does). Its
gradient is always zero.

Differences from the JAX layer: the ids are an int64 input that takes no
gradient (the JAX layer bitcasts them to float32 to satisfy its custom
VJP), and the lookup is a torch.autograd.Function whose forward runs a
host pull, so `jit.to_static` cannot trace through it (the JAX lookup runs
inside `jit` through host callbacks).
"""
import numpy as np
import torch
from torch import nn

from ...framework import device as device_mod

__all__ = ['HeterEmbedding', 'PassCachedEmbedding']


class _HeterLookup(torch.autograd.Function):
    """forward pulls, backward pushes. The push runs on the autograd
    engine's thread, inline (client) or queued in order (communicator):
    pushes leave in backward order, and only host arrays leave."""

    @staticmethod
    def forward(ctx, token, ids, layer):
        flat = ids.detach().reshape(-1).cpu().numpy().astype(np.int64)
        rows = layer.client.pull(layer.table_id, flat)
        ctx.layer = layer
        ctx.ids = flat
        out = torch.from_numpy(np.asarray(rows, np.float32)).to(
            token.device)
        return out.reshape(tuple(ids.shape) + (layer.dim,))

    @staticmethod
    def backward(ctx, grad):
        layer = ctx.layer
        grads = grad.detach().float().reshape(len(ctx.ids), layer.dim) \
            .cpu().numpy()
        if layer.comm is not None:
            layer.comm.push_sparse_grad(layer.table_id, ctx.ids, grads)
        else:
            layer.client.push(layer.table_id, ctx.ids, grads)
        return torch.zeros_like(layer.push_token), None, None


class HeterEmbedding(nn.Module):
    """Embedding lookup whose table lives host-side in the embedding
    service. Drop-in for nn.Embedding in training steps on the card."""

    def __init__(self, client, table_id, embedding_dim, communicator=None,
                 name=None, *, device=None):
        super().__init__()
        self.client = client
        self.table_id = int(table_id)
        self.dim = int(embedding_dim)
        self.comm = communicator
        self.push_token = nn.Parameter(
            torch.zeros(1, device=device_mod.resolve(device)))

    def forward(self, ids):
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids, np.int64))
        return _HeterLookup.apply(self.push_token, ids, self)


class PassCachedEmbedding(nn.Module):
    """PSGPU/HeterPs analog (reference: framework/fleet/ps_gpu_wrapper.h:50
    BuildPull/EndPass, heter_ps/heter_comm.h:50): per training PASS, the
    pass's unique ids' rows are pulled ONCE into a table on the card that
    trains at device speed as an ordinary nn.Parameter (the port's
    optimizers update it — the on-accelerator optimizer of
    heter_ps/optimizer.cuh.h); end_pass() pushes the accumulated deltas
    back to the host service. Data feeding remaps global ids to pass-local
    slots host-side (lookup_slots), mirroring the reference's pass build
    converting keys to local indices.

    Use when the working set per pass fits device memory but the full
    table does not — the complement of HeterEmbedding's per-step
    exchange. lookup_slots returns int64 slots (the JAX layer's are
    int32)."""

    def __init__(self, client, table_id, embedding_dim, name=None, *,
                 device=None):
        super().__init__()
        self.client = client
        self.table_id = int(table_id)
        self.dim = int(embedding_dim)
        self.device = device_mod.resolve(device)
        self.register_parameter('table', None)   # set during a pass
        self._ids = None
        self._base = None

    def begin_pass(self, ids):
        """Pull the pass working set onto the card."""
        ids = np.unique(np.asarray(ids).reshape(-1).astype(np.int64))
        rows = np.asarray(self.client.pull(self.table_id, ids), np.float32)
        self._ids = ids
        self._base = rows.copy()
        self.table = nn.Parameter(torch.tensor(rows, device=self.device))
        return len(ids)

    def lookup_slots(self, ids):
        """Global ids -> pass-local slot ids (host-side feed remap)."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1).astype(np.int64)
        pos = np.searchsorted(self._ids, flat)
        pos_c = np.minimum(pos, len(self._ids) - 1)
        missing = self._ids[pos_c] != flat
        if missing.any():
            raise KeyError('id %d not in the current pass working set '
                           '(call begin_pass with every id the pass '
                           'will touch)' % int(flat[missing][0]))
        return pos_c.reshape(ids.shape)

    def forward(self, slot_ids):
        """slot_ids from lookup_slots -> rows [..., dim]."""
        if self.table is None:
            raise RuntimeError('begin_pass() before training')
        if not isinstance(slot_ids, torch.Tensor):
            slot_ids = torch.as_tensor(np.asarray(slot_ids, np.int64))
        return self.table[slot_ids.to(self.table.device)]

    def end_pass(self):
        """Push the pass's training deltas back to the host table."""
        if self.table is None:
            return 0
        new = self.table.detach().cpu().numpy()
        delta = new - self._base
        touched = np.abs(delta).sum(axis=1) > 0
        if touched.any():
            self.client.push_delta(self.table_id, self._ids[touched],
                                   delta[touched])
        n = int(touched.sum())
        self.table = None
        self._ids = self._base = None
        return n
