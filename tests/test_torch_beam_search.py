"""The port's BeamSearchDecoder and dynamic_decode (paddle_tpu_torch/nn/
decode.py) against the JAX package's decoder and against brute-force
enumeration, as tests/test_beam_search.py checks the JAX one.

Over a carried-across LSTMCell with an embedding and a projection, the
predicted ids, lengths, the scores of every step and the final states
match the JAX decoder's (ids and parents exactly, scores within 1e-5). On
a cell whose logits depend only on the previous token (a Markov table)
the best beam is the enumerated optimum. With a vocabulary smaller than
the beam, the -1e9 scores of the beams not yet live tie exactly: the
port's stable sort keeps the lowest index first, as jax.lax.top_k does,
so the parents match too.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
from itertools import product

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.framework.core import Tensor as JTensor

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

from jax_numpy_init import numpy_init  # noqa: F401
from test_torch_loss_functions import _close, _f32


class _JaxTableCell(jnn.Layer):
    """logits = table[previous token] (tests/test_beam_search.py)."""

    def __init__(self, table):
        super().__init__()
        self._table = np.asarray(table, np.float32)

    def forward(self, inputs, states):
        return JTensor(self._table[np.asarray(inputs.numpy()).astype(
            np.int64)]), states


class _TableCell(torch.nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = torch.tensor(np.asarray(table, np.float32))

    def forward(self, inputs, states):
        return self.table[inputs], states


def _brute_force_best(table, start, end, steps):
    """The top sequence by total log-probability over every token path."""
    logp = np.log(np.exp(table) / np.exp(table).sum(-1, keepdims=True))
    best, best_s = None, -np.inf
    for path in product(range(table.shape[1]), repeat=steps):
        s, prev, alive = 0.0, start, True
        for t in path:
            if not alive:
                if t != end:
                    s = -np.inf
                    break
                continue
            s += logp[prev, t]
            prev = t
            alive = t != end
        if s > best_s:
            best_s, best = s, path
    return list(best)


def _decode_both(jcell, tcell, jinit, tinit, steps, **kw):
    jdec = jnn.BeamSearchDecoder(jcell, **kw)
    tdec = tnn.BeamSearchDecoder(tcell, **kw)
    jp, jst, jlen = jnn.dynamic_decode(jdec, inits=jinit,
                                       max_step_num=steps,
                                       return_length=True)
    tp, tst, tlen = tnn.dynamic_decode(tdec, inits=tinit,
                                       max_step_num=steps,
                                       return_length=True)
    np.testing.assert_array_equal(tp.numpy(), jp.numpy())
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    _close(tst['log_probs'], jst['log_probs'].numpy())
    np.testing.assert_array_equal(tst['finished'].numpy(),
                                  jst['finished'].numpy())
    return tp, tst


@pytest.mark.parametrize('vocab,beam,steps', [(5, 25, 4), (3, 4, 5),
                                              (4, 2, 6)])
def test_markov_table_matches_jax_and_enumeration(vocab, beam, steps):
    table = np.random.RandomState(vocab).randn(vocab, vocab).astype(
        np.float32)
    kw = dict(start_token=0, end_token=vocab - 1, beam_size=beam)
    init = np.zeros((2, 2), np.float32)
    preds, _ = _decode_both(_JaxTableCell(table), _TableCell(table),
                            JTensor(init), torch.tensor(init), steps, **kw)
    if beam >= vocab * vocab:  # wide enough to be exact
        want = _brute_force_best(table, 0, vocab - 1, steps)
        if vocab - 1 in want:
            want = want[:want.index(vocab - 1) + 1]
        assert preds[0, :len(want), 0].tolist() == want


def test_ties_at_minus_1e9_keep_the_lowest_index():
    """Beam 4 over 3 tokens: at t = 0 the top 4 need one of the not-yet-live
    beams, whose scores are all exactly -1e9: parent 1, token 0 first."""
    table = np.zeros((3, 3), np.float32)
    dec = tnn.BeamSearchDecoder(_TableCell(table), 0, 2, 4)
    inputs, states, _ = dec.initialize(torch.zeros(1, 1))
    out, _, _, _ = dec.step(0, inputs, states)
    assert out['parent'].tolist() == [[0, 0, 0, 1]]
    assert out['token'].tolist() == [[0, 1, 2, 0]]
    assert out['scores'][0, 3].item() == -1e9


def test_lstm_cell_decoder_matches_jax(numpy_init):
    hidden, vocab, beam, batch = 16, 12, 3, 2
    jcell, jproj, jemb = (jnn.LSTMCell(8, hidden), jnn.Linear(hidden, vocab),
                          jnn.Embedding(vocab, 8))
    tcell = tnn.LSTMCell(8, hidden, device='cpu')
    tproj = tnn.Linear(hidden, vocab, device='cpu')
    temb = tnn.Embedding(vocab, 8, device='cpu')
    for j, t in ((jcell, tcell), (jproj, tproj), (jemb, temb)):
        load_paddle_tpu_state(t, {k: np.asarray(v.numpy())
                                  for k, v in j.state_dict().items()})
    rng = np.random.RandomState(1)
    h, c = _f32(rng.randn(batch, hidden)), _f32(rng.randn(batch, hidden))
    kw = dict(start_token=1, end_token=2, beam_size=beam)
    jdec = jnn.BeamSearchDecoder(jcell, embedding_fn=jemb, output_fn=jproj,
                                 **kw)
    tdec = tnn.BeamSearchDecoder(tcell, embedding_fn=temb, output_fn=tproj,
                                 **kw)
    jp, jst = jnn.dynamic_decode(jdec, inits=(JTensor(h), JTensor(c)),
                                 max_step_num=6, output_time_major=True)
    with torch.no_grad():
        tp, tst = tnn.dynamic_decode(tdec, inits=(torch.tensor(h),
                                                  torch.tensor(c)),
                                     max_step_num=6, output_time_major=True)
    assert tuple(tp.shape) == tuple(jp.shape) and tp.shape[1:] == (batch, beam)
    np.testing.assert_array_equal(tp.numpy(), jp.numpy())
    _close(tst['log_probs'], jst['log_probs'].numpy())
    for a, b in zip(tst['cell'], jst['cell']):
        _close(a, b.numpy())


def test_dynamic_decode_guards_and_early_exit():
    table = np.full((4, 4), -5.0, np.float32)
    table[0, 1] = table[1, 2] = table[2, 3] = table[3, 3] = 5.0
    dec = tnn.BeamSearchDecoder(_TableCell(table), 0, 3, 2)
    with pytest.raises(ValueError, match='max_step_num'):
        tnn.dynamic_decode(dec, inits=torch.zeros(1, 2), max_step_num=0)
    with pytest.raises(NotImplementedError, match='impute_finished'):
        tnn.dynamic_decode(dec, inits=torch.zeros(1, 2),
                           impute_finished=True)
    preds, _, lengths = tnn.dynamic_decode(dec, inits=torch.zeros(3, 2),
                                           return_length=True)
    assert preds.shape[0] == 3 and preds.shape[2] == 2
    assert preds.shape[1] < 10000   # stopped once every beam finished
    assert (preds[:, :3, 0] == torch.tensor([1, 2, 3])).all()
    assert (lengths[:, 0] == 3).all()
    assert tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.tensor([[1], [2]]), 3).flatten().tolist() == [1, 1, 1, 2, 2, 2]
