"""RNN layers (counterpart of paddle_tpu/nn/layer/rnn.py): the cells,
RNN / BiRNN over a cell, and the stacked SimpleRNN / LSTM / GRU.

Parameters keep the JAX package's names: each cell's weight_ih,
weight_hh, bias_ih and bias_hh (Uniform(+-1/sqrt(hidden))), and the
stacked layers' `_cells.{i}` (layer by layer, the forward cell before the
backward one), so a JAX state dict loads unchanged. The gate orders are
torch's: LSTM i, f, g, o; GRU r, z, n with n = tanh(in + r * hn) and
h' = (1 - z) * n + z * h.

Two routes compute the same function:
- the stacked layers call torch's fused RNN op (`torch._VF.lstm` / `gru`
  / `rnn_tanh` / `rnn_relu`, what nn.LSTM calls; cuDNN on the card) on
  the cells' weights; with `sequence_length` they pack the rows
  (`pack_padded_sequence`, which reads the lengths on the host) and leave
  rows of length 0 out of the op: they give zeros and the zero state;
- the per-step cell loop `_run_rnn` (the JAX package's scan as a Python
  loop) is the plain version: RNN and BiRNN run it, and
  `_StackedRNNBase.forward_loop` runs the stacked layers through it.

Kept from the JAX package: the stacked layers ignore `initial_states`
and start from zeros; the loop's initial carry is f32 whatever the
input's dtype (so a 16-bit input gives f32 outputs), and the fused route
runs a 16-bit input in f32 for the same reason (its input and weights
cast up; the JAX step computes x @ W_ih in 16 bits before the f32 add);
RNN(cell) never calls cell.forward but runs the built-in step of the
cell's kind on its four weights, so any other cell runs as a SimpleRNN;
dropout goes between the stacked layers only. Steps past a row's
`sequence_length` emit zeros and leave its state alone, and a reverse
direction runs over each row's valid prefix only.
"""
import math

import torch
from torch import _VF, nn
from torch.nn.utils import rnn as rnn_utils

from ...amp.auto_cast import cast as amp_cast
from ...framework import device as device_mod
from .. import functional as F
from .. import initializer as I
from .container import LayerList
from .layers import create_parameter

__all__ = ['RNNCellBase', 'SimpleRNNCell', 'LSTMCell', 'GRUCell', 'RNN',
           'BiRNN', 'SimpleRNN', 'LSTM', 'GRU']

_LOW = (torch.float16, torch.bfloat16)


def _cell_params(cell):
    return [cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh]


def _simple_step(x, h, wi, wh, bi, bh, activation):
    act = torch.tanh if activation == 'tanh' else torch.relu
    return act(x @ wi.t() + bi + h @ wh.t() + bh)


def _lstm_step(x, h, c, wi, wh, bi, bh):
    gates = x @ wi.t() + bi + h @ wh.t() + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(x, h, wi, wh, bi, bh):
    ir, iz, in_ = (x @ wi.t() + bi).chunk(3, dim=-1)
    hr, hz, hn = (h @ wh.t() + bh).chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1 - z) * n + z * h


class RNNCellBase(nn.Module):
    def _init_weights(self, input_size, hidden_size, gates, attrs, device,
                      dtype, generator):
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        dev = device_mod.resolve(device)
        wi_attr, wh_attr, bi_attr, bh_attr = attrs
        self.weight_ih = create_parameter([gates * hidden_size, input_size],
                                          wi_attr, dtype, u, generator, dev)
        self.weight_hh = create_parameter([gates * hidden_size, hidden_size],
                                          wh_attr, dtype, u, generator, dev)
        self.bias_ih = create_parameter([gates * hidden_size], bi_attr,
                                        dtype, u, generator, dev)
        self.bias_hh = create_parameter([gates * hidden_size], bh_attr,
                                        dtype, u, generator, dev)

    def get_initial_states(self, batch_ref, shape=None, dtype='float32',
                           init_value=0.0, batch_dim_idx=0):
        """f32 [batch, hidden] filled with init_value (`shape` and `dtype`
        unused, as in the JAX package)."""
        return torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size),
                          init_value, dtype=torch.float32,
                          device=batch_ref.device)



class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation='tanh',
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype='float32', generator=None):
        super().__init__()
        self.activation = activation
        self._init_weights(input_size, hidden_size, 1,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), device, dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        args = amp_cast('simple_rnn_cell', inputs, states,
                        *_cell_params(self))
        h = _simple_step(*args, self.activation)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype='float32', generator=None):
        super().__init__()
        self._init_weights(input_size, hidden_size, 4,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), device, dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            z = inputs.new_zeros((inputs.shape[0], self.hidden_size),
                                 dtype=torch.float32)
            states = (z, z)
        h, c = _lstm_step(*amp_cast('lstm_cell', inputs, states[0],
                                    states[1], *_cell_params(self)))
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype='float32', generator=None):
        super().__init__()
        self._init_weights(input_size, hidden_size, 3,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), device, dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_step(*amp_cast('gru_cell', inputs, states,
                                *_cell_params(self)))
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(nn.Module):
    """Runs a cell over time (the per-step loop)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _run_rnn(self.cell, inputs, initial_states, self.is_reverse,
                        self.time_major, sequence_length)


class BiRNN(nn.Module):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_st, bw_st = (None, None) if initial_states is None \
            else initial_states
        out_f, st_f = _run_rnn(self.cell_fw, inputs, fw_st, False,
                               self.time_major, sequence_length)
        out_b, st_b = _run_rnn(self.cell_bw, inputs, bw_st, True,
                               self.time_major, sequence_length)
        return torch.cat([out_f, out_b], dim=-1), (st_f, st_b)


def _rev_within(seq, lens):
    """Reverse each row's valid prefix along time (dim 0, rows on dim 1);
    its own inverse, so it also restores the outputs' order."""
    t = torch.arange(seq.shape[0], device=seq.device)[:, None]   # [T, 1]
    idx = torch.where(t < lens[None, :], lens[None, :] - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (seq.dim() - 2))
    return seq.gather(0, idx.expand(seq.shape))


def _run_rnn(cell, inputs, initial_states, is_reverse, time_major,
             sequence_length=None):
    """Step `cell`'s built-in step of its kind over the time axis (the
    JAX package's scan, one step a loop turn)."""
    x, wi, wh, bi, bh = amp_cast('rnn_scan', inputs, *_cell_params(cell))
    batch = x.shape[1 if time_major else 0]
    is_lstm = isinstance(cell, LSTMCell)
    if initial_states is None:
        z = x.new_zeros((batch, cell.hidden_size), dtype=torch.float32)
        carry = (z, z) if is_lstm else z
    elif is_lstm:
        carry = (initial_states[0], initial_states[1])
    elif isinstance(initial_states, (tuple, list)):
        carry = initial_states[0]
    else:
        carry = initial_states

    if is_lstm:
        def step(c, x_t):
            h, cc = _lstm_step(x_t, c[0], c[1], wi, wh, bi, bh)
            return (h, cc), h
    elif isinstance(cell, GRUCell):
        def step(c, x_t):
            h = _gru_step(x_t, c, wi, wh, bi, bh)
            return h, h
    else:
        act = getattr(cell, 'activation', 'tanh')

        def step(c, x_t):
            h = _simple_step(x_t, c, wi, wh, bi, bh, act)
            return h, h

    xs = x if time_major else x.transpose(0, 1)
    lens = None if sequence_length is None else \
        torch.as_tensor(sequence_length, device=x.device).long()
    if is_reverse:
        xs = xs.flip(0) if lens is None else _rev_within(xs, lens)
    ys = []
    for t in range(xs.shape[0]):
        new, y = step(carry, xs[t])
        if lens is not None:
            alive = (t < lens)[:, None]
            if is_lstm:
                new = (torch.where(alive, new[0], carry[0]),
                       torch.where(alive, new[1], carry[1]))
            else:
                new = torch.where(alive, new, carry)
            y = torch.where(alive, y, 0.0)
        carry = new
        ys.append(y)
    ys = torch.stack(ys)
    if is_reverse:
        ys = ys.flip(0) if lens is None else _rev_within(ys, lens)
    return (ys if time_major else ys.transpose(0, 1)), carry


_FUSED = {'LSTM': _VF.lstm, 'GRU': _VF.gru, 'RNN_TANH': _VF.rnn_tanh,
          'RNN_RELU': _VF.rnn_relu}


class _StackedRNNBase(nn.Module):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 activation='tanh', weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype='float32', generator=None):
        super().__init__()
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        bidirect = direction in ('bidirect', 'bidirectional')
        self.num_directions = 2 if bidirect else 1
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        kw = dict(device=device, dtype=dtype, generator=generator)

        def make_cell(in_sz):
            if mode == 'LSTM':
                return LSTMCell(in_sz, hidden_size, *attrs, **kw)
            if mode == 'GRU':
                return GRUCell(in_sz, hidden_size, *attrs, **kw)
            return SimpleRNNCell(in_sz, hidden_size, activation, *attrs,
                                 **kw)

        self._cells = LayerList()
        for layer_i in range(num_layers):
            in_sz = input_size if layer_i == 0 \
                else hidden_size * self.num_directions
            for _ in range(self.num_directions):
                self._cells.append(make_cell(in_sz))

    def _fused_op(self):
        if self.mode != 'RNN':
            return _FUSED[self.mode]
        return _FUSED['RNN_TANH' if self.activation == 'tanh'
                      else 'RNN_RELU']

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """(outputs, h) or, for LSTM, (outputs, (h, c)); h and c are
        [num_layers * num_directions, batch, hidden]. `initial_states` is
        ignored: every run starts from zeros, as in the JAX package."""
        weights = [w for cell in self._cells for w in _cell_params(cell)]
        x, *weights = amp_cast('rnn_scan', inputs, *weights)
        if x.dtype in _LOW:
            x = x.float()
            weights = [w.float() for w in weights]
        tm = self.time_major
        batch, steps = (x.shape[1], x.shape[0]) if tm else x.shape[:2]
        lstm = self.mode == 'LSTM'
        op = self._fused_op()
        opts = (True, self.num_layers, float(self.dropout), self.training,
                self.num_directions == 2)

        def zeros(rows):
            hx = x.new_zeros(self.num_layers * self.num_directions, rows,
                             self.hidden_size)
            return (hx, hx) if lstm else hx

        if sequence_length is None:
            res = op(x, zeros(batch), weights, *opts, not tm)
            return res[0], ((res[1], res[2]) if lstm else res[1])
        # packed rows, their lengths on the host; rows of length 0 stay
        # out of the op (pack_padded_sequence refuses them)
        lens = torch.as_tensor(sequence_length).to('cpu', torch.int64)
        rows = torch.nonzero(lens > 0).flatten()
        bdim = 1 if tm else 0
        out_shape = list(x.shape[:2]) + \
            [self.hidden_size * self.num_directions]
        out = x.new_zeros(out_shape)
        states = list(zeros(batch)) if lstm else [zeros(batch)]
        if rows.numel():
            sel = rows.to(x.device)
            packed = rnn_utils.pack_padded_sequence(
                x.index_select(bdim, sel), lens[rows], batch_first=not tm,
                enforce_sorted=False)
            res = op(packed.data, packed.batch_sizes, zeros(rows.numel()),
                     weights, *opts)
            out_sel, _ = rnn_utils.pad_packed_sequence(
                rnn_utils.PackedSequence(res[0], packed.batch_sizes,
                                         packed.sorted_indices,
                                         packed.unsorted_indices),
                batch_first=not tm, total_length=steps)
            out = out.index_copy(bdim, sel, out_sel)
            states = [s.index_copy(1, sel, r.index_select(
                1, packed.unsorted_indices)) for s, r in zip(states, res[1:])]
        return out, (tuple(states) if lstm else states[0])

    def forward_loop(self, inputs, initial_states=None, sequence_length=None):
        """The same function through the per-step cell loop, layer by layer
        and direction by direction, as the JAX package computes it (the
        plain version the fused route is held to); dropout between the
        layers is F.dropout's."""
        out = inputs
        hs, cs = [], []
        for layer_i in range(self.num_layers):
            runs = [_run_rnn(self._cells[layer_i * self.num_directions + d],
                             out, None, d == 1, self.time_major,
                             sequence_length)
                    for d in range(self.num_directions)]
            out = torch.cat([o for o, _ in runs], dim=-1)
            for _, st in runs:
                if self.mode == 'LSTM':
                    hs.append(st[0])
                    cs.append(st[1])
                else:
                    hs.append(st)
            if self.dropout > 0 and layer_i < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        if self.mode == 'LSTM':
            return out, (torch.stack(hs), torch.stack(cs))
        return out, torch.stack(hs)

    def extra_repr(self):
        return '%d, %d, num_layers=%d, direction=%s' % (
            self.input_size, self.hidden_size, self.num_layers,
            self.direction)


class SimpleRNN(_StackedRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 activation='tanh', **kwargs):
        super().__init__('RNN', input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kwargs)


class LSTM(_StackedRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__('LSTM', input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_StackedRNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction='forward', time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__('GRU', input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
