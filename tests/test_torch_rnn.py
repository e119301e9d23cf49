"""The port's RNN layers (paddle_tpu_torch/nn/layer/rnn.py) against the
JAX package's, weights carried across with load_paddle_tpu_state, at
input 8, hidden 16, 7 steps, batch 3.

The stacked SimpleRNN / LSTM / GRU run torch's fused RNN op; RNN, BiRNN
and the cells run the per-step loop, the plain version. Each JAX case
is one jitted program (functional_call under jax.grad): outputs, final
states and the grads of the input and of every weight within 1e-5 (f32,
16-wide products, 7 steps). The fused route is held to the loop in every
mode, direction, layout and sequence_length (a row of length 0, a full
one) within 1e-5, forward and backward.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework import functional as jfm

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

from jax_numpy_init import numpy_init  # noqa: F401
from test_torch_loss_functions import _close, _f32

IN, HID, T, B = 8, 16, 7, 3
LENS = np.array([4, 0, 7], np.int64)
TOL = 1e-5


def _state(jl):
    return {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}


def _pair(name, *args, **kw):
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, device='cpu', **kw)
    load_paddle_tpu_state(tl, _state(jl))
    return jl, tl


def _flat(out):
    """The tensors of an RNN's (outputs, states) in order."""
    leaves = []

    def walk(v):
        if isinstance(v, (tuple, list)):
            for u in v:
                walk(u)
        else:
            leaves.append(v)
    walk(out)
    return leaves


def _jax_run(jl, x, kwargs, seed=0):
    """The JAX layer's outputs and the grads of sum(leaf * cot) over every
    output leaf, by its parameters and its input, in one jitted program."""
    cots = []

    def f(p, xa):
        def post(out):
            leaves = [t._data for t in _flat(out)]
            if not cots:
                rng = np.random.RandomState(seed)
                cots.extend(_f32(rng.randn(*v.shape)) for v in leaves)
            return sum(jnp.sum(v * c) for v, c in zip(leaves, cots)), leaves
        (loss, leaves), _ = jfm.functional_call(jl, p, {}, args=(xa,),
                                                kwargs=kwargs,
                                                training=True, post_fn=post)
        return loss, leaves
    (gp, gx), leaves = jax.jit(jax.grad(f, argnums=(0, 1), has_aux=True))(
        jfm.extract_params(jl), jnp.asarray(x))
    return [np.asarray(v) for v in leaves], \
        {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx), cots


def _torch_run(tl, x, cots, **kw):
    xt = torch.tensor(x, requires_grad=True)
    leaves = _flat(tl(xt, **kw))
    sum((v * torch.tensor(c)).sum() for v, c in zip(leaves, cots)).backward()
    return leaves, xt.grad


def _x(time_major, seed=0):
    shape = (T, B, IN) if time_major else (B, T, IN)
    return _f32(np.random.RandomState(seed).randn(*shape))


# (layer, extra args): the JAX cases, each a jitted forward + grad
STACKED_CASES = [
    ('LSTM', dict(num_layers=2, direction='bidirect'), False, True),
    ('LSTM', dict(), True, False),
    ('GRU', dict(direction='bidirect', time_major=True), True, True),
    ('GRU', dict(num_layers=2), False, False),
    ('SimpleRNN', dict(num_layers=2, activation='relu'), False, True),
    ('SimpleRNN', dict(direction='bidirectional'), True, False),
]


@pytest.mark.parametrize('name,kw,time_major,lens', STACKED_CASES,
                         ids=['%s-%s-%s-%s' % (c[0], '-'.join(
                             '%s=%s' % i for i in sorted(c[1].items())),
                             'tm' if c[2] else 'bm', 'lens' if c[3] else
                             'full') for c in STACKED_CASES])
def test_stacked_matches_jax(numpy_init, name, kw, time_major, lens):
    kw = dict(kw, time_major=time_major)
    jl, tl = _pair(name, IN, HID, **kw)
    x = _x(time_major)
    jkw = {'sequence_length': paddle.to_tensor(LENS)} if lens else {}
    want, gp, gx, cots = _jax_run(jl, x, jkw)
    tkw = {'sequence_length': torch.tensor(LENS)} if lens else {}
    got, tgx = _torch_run(tl, x, cots, **tkw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    _close(tgx, gx, msg='input grad')
    for k, p in tl.named_parameters():
        _close(p.grad, gp[k], msg=k)


def test_cells_and_wrappers_match_jax(numpy_init):
    rng = np.random.RandomState(4)
    x = _x(False, 5)
    h0 = _f32(rng.randn(B, HID))
    c0 = _f32(rng.randn(B, HID))
    cells = [('SimpleRNNCell', (IN, HID, 'relu')), ('LSTMCell', (IN, HID)),
             ('GRUCell', (IN, HID))]
    for name, args in cells:
        jc, tc = _pair(name, *args)
        st = (h0, c0) if name == 'LSTMCell' else h0
        jst = tuple(paddle.to_tensor(s) for s in st) if name == 'LSTMCell' \
            else paddle.to_tensor(st)
        tst = tuple(torch.tensor(s) for s in st) if name == 'LSTMCell' \
            else torch.tensor(st)
        for a, b in zip(_flat(tc(torch.tensor(x[:, 0]), tst)),
                        _flat(jc(paddle.to_tensor(x[:, 0]), jst))):
            _close(a, b.numpy(), msg=name)
        # without states: zeros
        _close(_flat(tc(torch.tensor(x[:, 0])))[0],
               _flat(jc(paddle.to_tensor(x[:, 0])))[0].numpy())
        # RNN(cell) reversed over each row's prefix, from given states, and
        # BiRNN over a copy of the cell
        for rev in (False, True):
            want = jnn.RNN(jc, is_reverse=rev)(
                paddle.to_tensor(x), jst,
                sequence_length=paddle.to_tensor(LENS))
            got = tnn.RNN(tc, is_reverse=rev)(
                torch.tensor(x), tst, sequence_length=torch.tensor(LENS))
            for a, b in zip(_flat(got), _flat(want)):
                _close(a, b.numpy(), msg='%s reverse=%s' % (name, rev))
        want = jnn.BiRNN(jc, jc, time_major=True)(
            paddle.to_tensor(x.transpose(1, 0, 2)))
        got = tnn.BiRNN(tc, tc, time_major=True)(
            torch.tensor(x.transpose(1, 0, 2)))
        for a, b in zip(_flat(got), _flat(want)):
            _close(a, b.numpy(), msg='%s BiRNN' % name)


LOOP_CASES = [(name, nl, d, tm, lens) for name in ('LSTM', 'GRU',
                                                   'SimpleRNN')
              for nl, d in ((1, 'forward'), (2, 'bidirect'))
              for tm in (False, True) for lens in (False, True)]


@pytest.mark.parametrize('name,layers,direction,time_major,lens',
                         LOOP_CASES)
def test_fused_route_matches_cell_loop(name, layers, direction, time_major,
                                       lens):
    gen = torch.Generator().manual_seed(layers)
    layer = getattr(tnn, name)(IN, HID, layers, direction, time_major,
                               device='cpu', generator=gen)
    kw = {'sequence_length': torch.tensor(LENS)} if lens else {}
    x = _x(time_major, 2)
    cots = None
    grads = []
    for run in (layer.forward, layer.forward_loop):
        layer.zero_grad()
        xt = torch.tensor(x, requires_grad=True)
        leaves = _flat(run(xt, **kw))
        if cots is None:
            rng = np.random.RandomState(3)
            cots = [torch.tensor(_f32(rng.randn(*v.shape))) for v in leaves]
        sum((v * c).sum() for v, c in zip(leaves, cots)).backward()
        grads.append([v.detach() for v in leaves] + [xt.grad] +
                     [p.grad.clone() for p in layer.parameters()])
    for a, b in zip(*grads):
        _close(a, b)
    if lens:  # past a row's length: zeros; a row of length 0 is all zeros
        out = grads[0][0] if time_major else grads[0][0].transpose(0, 1)
        assert (out[4:, 0] == 0).all() and (out[:, 1] == 0).all()


def test_stacked_layer_keeps_jax_behaviours():
    lstm = tnn.LSTM(IN, HID, 2, device='cpu')
    x = torch.tensor(_x(False))
    h = torch.ones(2, B, HID)
    # initial_states is ignored: every run starts from zeros
    for a, b in zip(_flat(lstm(x, (h, h))), _flat(lstm(x))):
        assert torch.equal(a, b)
    # a 16-bit input runs in f32 and gives f32, as the JAX f32 carry does
    out, (hn, cn) = lstm.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert out.dtype == hn.dtype == torch.float32
    assert [k for k, _ in lstm.named_parameters()][:4] == [
        '_cells.0.weight_ih', '_cells.0.weight_hh', '_cells.0.bias_ih',
        '_cells.0.bias_hh']


def test_state_dicts_carry_across(numpy_init):
    """A 2-layer bidirectional LSTM, a GRU and an HSigmoidLoss: the JAX
    state dict loads unchanged and the forwards agree."""
    x = _x(False, 7)
    for name, args, kw in (('LSTM', (IN, HID, 2), dict(direction='bidirect')),
                           ('GRU', (IN, HID), {})):
        jl, tl = _pair(name, *args, **kw)
        assert set(_state(jl)) == set(tl.state_dict())
        for a, b in zip(_flat(tl(torch.tensor(x))),
                        _flat(jl(paddle.to_tensor(x)))):
            _close(a, b.numpy(), msg=name)
    jh = jnn.HSigmoidLoss(IN, 5)
    th = tnn.HSigmoidLoss(IN, 5, device='cpu')
    load_paddle_tpu_state(th, _state(jh))
    lab = np.array([1, 4, 0])
    _close(th(torch.tensor(x[:, 0]), torch.tensor(lab)),
           jh(paddle.to_tensor(x[:, 0]), paddle.to_tensor(lab)).numpy())
