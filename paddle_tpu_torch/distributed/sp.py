"""Sequence-parallel execution context (counterpart of
paddle_tpu/distributed/sp.py; beyond the reference, SURVEY.md §5.7).

fleet_train_step builds an sp state when `strategy.sequence_parallel` is
set (at any sp degree: at 1 the ring is one block, ordinary attention,
where the JAX package routes only above 1), and TrainStep activates it
only around its
own forward and backward (`sp_scope`), so an eval or generation call
between steps keeps ordinary attention. While it is active every
F.scaled_dot_product_attention call runs ring attention (K/V rotating
over the sp group, ops/ring_attention.py) or Ulysses all_to_all, and the
GPT takes its position ids from `local_positions`: the model code does
not change between sp = 1 and sp > 1.

The JAX package calls sp_attention with global arrays and shard_map
splits the sequence. Here each rank already holds its sequence shard:
TrainStep's batch sharding splits dim 1 over 'sp' (rank r holds rows
r * n onwards), or under the zigzag mode lays it out zigzag (rank r holds
chunks r and 2P-1-r of 2P, `state['layout'] = 'zigzag'`), so the
balanced causal ring runs without a permutation. `_zigzag_sp` serves
contiguous shards under the zigzag mode: it gathers the sequence, runs
the zigzag ring on its chunks and gathers the output back (the JAX
package pays the same two permutations on the global array).

Attention dropout draws from a generator of each rank's own: a seed drawn
from the caller's generator (torch's default one, alike on every rank),
mixed with the sp rank (the JAX package folds the rank into its key).
"""
import torch

from ..ops import ring_attention as _ra

__all__ = ['enable_sequence_parallel', 'disable_sequence_parallel',
           'sequence_parallel_state', 'sp_attention', 'make_sp_state',
           'sp_scope', 'local_positions']

_STATE = _ra.SP_STATE


def make_sp_state(mesh, axis='sp', mode='ring', batch_axes=(),
                  head_axis=None):
    """Build (without activating) an sp routing state over `mesh`'s
    `axis`. batch_axes / head_axis record how the other dims of q / k / v
    are laid out (dp or sharding on the batch, mp on the heads)."""
    assert mode in ('ring', 'ulysses', 'zigzag'), mode
    return {'mesh': mesh, 'axis': axis, 'mode': mode,
            'batch_axes': tuple(batch_axes), 'head_axis': head_axis,
            'layout': 'contiguous'}


def enable_sequence_parallel(mesh, axis='sp', mode='ring', batch_axes=(),
                             head_axis=None):
    _STATE['active'] = make_sp_state(mesh, axis, mode, batch_axes, head_axis)


def disable_sequence_parallel():
    _STATE['active'] = None


class sp_scope:
    """Context manager activating an sp state only around a step's forward
    and backward."""

    def __init__(self, state):
        self._state = state

    def __enter__(self):
        self._saved = _STATE['active']
        if self._state is not None:
            _STATE['active'] = self._state
        return self

    def __exit__(self, *exc):
        _STATE['active'] = self._saved
        return False


def sequence_parallel_state():
    return _STATE['active']


def _group(state):
    if 'group' not in state:
        from .topology import _axis_group
        state['group'] = _axis_group(state['mesh'], state['axis'])
    return state['group']


def zigzag_chunks(tensor, dim, idx, total):
    """Rank idx's rows of `tensor` along dim in the zigzag layout: chunks
    idx and 2 * total - 1 - idx of 2 * total."""
    c = tensor.shape[dim] // (2 * total)
    return torch.cat([tensor.narrow(dim, idx * c, c),
                      tensor.narrow(dim, (2 * total - 1 - idx) * c, c)],
                     dim=dim)


def local_positions(state, n_loc, device):
    """The global positions of this rank's n_loc sequence rows."""
    group = _group(state)
    r, p = max(group.rank, 0), group.nranks
    if state.get('layout') == 'zigzag':
        c = n_loc // 2
        return torch.cat([torch.arange(r * c, (r + 1) * c, device=device),
                          torch.arange((2 * p - 1 - r) * c,
                                       (2 * p - r) * c, device=device)])
    return torch.arange(r * n_loc, (r + 1) * n_loc, device=device)


def _rank_generator(generator, rank, device):
    """A generator of this rank's own for attention dropout."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device if generator is not None
                             else 'cpu'))
    return torch.Generator(device=device).manual_seed(
        seed * 1000003 + rank)


def sp_attention(q, k, v, causal, scale, state=None, dropout_p=0.0,
                 generator=None):
    """Attention over this rank's sequence shard [B, N_local, H, D] under
    the sp state: ring (on the flash kernels), Ulysses, or the zigzag ring
    for causal attention under the zigzag mode (the plain ring when the
    sequence does not cut into 2P chunks or the attention is not causal,
    as in the JAX package)."""
    st = state or _STATE['active']
    group = _group(st)
    mode = st['mode']
    gen = None
    if dropout_p:
        gen = _rank_generator(generator, max(group.rank, 0), q.device)
    if mode == 'zigzag':
        n_dev = group.nranks
        n = q.shape[1] * n_dev
        if causal and n % (2 * n_dev) == 0:
            if st.get('layout') == 'zigzag':
                return _ra.zigzag_ring_attention(
                    q, k, v, axis_name=group, scale=scale,
                    dropout_p=dropout_p, generator=gen)
            return _zigzag_sp(q, k, v, scale, group, n_dev, dropout_p, gen)
        # zigzag's balance argument is causality; non-causal (or a
        # sequence that does not cut into 2P chunks) takes the plain ring
        mode = 'ring'
    fn = _ra.ring_flash_attention if mode == 'ring' \
        else _ra.ulysses_attention
    return fn(q, k, v, axis_name=group, causal=causal, scale=scale,
              dropout_p=dropout_p, generator=gen)


def _zigzag_sp(q, k, v, scale, group, n_dev, dropout_p, generator):
    """The zigzag ring over contiguous shards: gather the sequence, take
    this rank's zigzag chunks, run the balanced ring, gather the output
    and keep this rank's contiguous rows."""
    from .meta_parallel.mp_layers import MPGroup, gather_partial
    g = MPGroup(group.pg, max(group.rank, 0), n_dev, None)
    r = g.rank

    def to_zigzag(t):
        return zigzag_chunks(gather_partial(t, 1, g), 1, r, n_dev)
    out = _ra.zigzag_ring_attention(to_zigzag(q), to_zigzag(k), to_zigzag(v),
                                   axis_name=group, scale=scale,
                                   dropout_p=dropout_p, generator=generator)
    full = gather_partial(out, 1, g)
    idx, inv = _ra.zigzag_layout_indices(full.shape[1], n_dev)
    n_loc = q.shape[1]
    rows = torch.as_tensor(inv[r * n_loc:(r + 1) * n_loc],
                           device=full.device)
    return full.index_select(1, rows)
