"""Beam-search decoding (counterpart of paddle_tpu/nn/decode.py; reference
fluid/layers/rnn.py BeamSearchDecoder / dynamic_decode).

Every per-beam state rides a merged [batch * beam, ...] leading dim, so a
step is one batched cell call. A step scores in f32 whatever the cell's
dtype; only beam 0 is live at t = 0 (the others start at -1e9); a
finished beam may extend only with end_token, at probability 1. The top
W of the [batch, W * V] scores come from a stable descending sort: equal
scores (the -1e9 constants tie whenever the vocabulary is small) keep the
lowest index first, as jax.lax.top_k does, where torch.topk leaves the
order unspecified on CUDA. dynamic_decode's loop reads `finished` on the
host each step (one sync a step) and stops once every beam has finished,
or at max_step_num; an unbounded decode stops at
PADDLE_TPU_MAX_DECODE_STEPS (10000 when unset), as in the JAX package.
"""
import os

import torch
from torch.utils import _pytree as pytree

__all__ = ['Decoder', 'BeamSearchDecoder', 'dynamic_decode']

_END_MASK = -1e9


class Decoder:
    """Abstract decoder contract (initialize / step / finalize)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over an RNN cell. embedding_fn maps token ids to cell
    inputs; output_fn maps cell outputs to vocabulary logits (the cell's
    output is taken as the logits without it)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam, ...], each row repeated."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _split(self, a):
        return a.reshape((-1, self.beam_size) + tuple(a.shape[1:]))

    def _merge(self, a):
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def _embed(self, token):
        return self.embedding_fn(token) if self.embedding_fn else token

    def initialize(self, initial_cell_states):
        states = pytree.tree_map(
            lambda s: self.tile_beam_merge_with_batch(s, self.beam_size),
            initial_cell_states)
        first = pytree.tree_leaves(states)[0]
        nbw, dev = first.shape[0], first.device
        batch = nbw // self.beam_size
        log_probs = torch.tensor(
            [0.0] + [_END_MASK] * (self.beam_size - 1),
            dtype=torch.float32, device=dev).repeat(batch, 1)      # [B, W]
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int64,
                              device=dev)
        token = torch.full((nbw,), self.start_token, dtype=torch.int64,
                           device=dev)
        beam_state = {'cell': states, 'log_probs': log_probs,
                      'finished': finished, 'lengths': lengths}
        return self._embed(token), beam_state, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell = self.cell(inputs, states['cell'], **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        vocab = cell_out.shape[-1]
        w = self.beam_size
        fin = states['finished']
        step_logp = self._split(torch.log_softmax(cell_out.float(), dim=-1))
        end_row = torch.full((vocab,), _END_MASK, dtype=torch.float32,
                             device=step_logp.device)
        end_row[self.end_token] = 0.0
        step_logp = torch.where(fin[:, :, None], end_row, step_logp)
        total = states['log_probs'][:, :, None] + step_logp    # [B, W, V]
        flat = total.reshape(total.shape[0], w * vocab)
        top_val, top_idx = torch.sort(flat, dim=1, descending=True,
                                      stable=True)
        top_val, top_idx = top_val[:, :w], top_idx[:, :w]
        parent = top_idx // vocab
        token = top_idx % vocab
        fin_parent = fin.gather(1, parent)
        new_fin = fin_parent | (token == self.end_token)
        new_lens = states['lengths'].gather(1, parent) + \
            (~fin_parent).long()

        def regather(s):
            # every cell-state row follows its beam's parent
            sp = self._split(s)                                  # [B, W, ...]
            idx = parent.reshape(parent.shape + (1,) * (sp.dim() - 2))
            return self._merge(sp.gather(1, idx.expand(
                parent.shape + sp.shape[2:])))

        beam_state = {'cell': pytree.tree_map(regather, next_cell),
                      'log_probs': top_val, 'finished': new_fin,
                      'lengths': new_lens}
        outputs = {'token': token, 'parent': parent, 'scores': top_val}
        return outputs, beam_state, self._embed(self._merge(token)), new_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """Backtrack the parent pointers into whole sequences (gather_tree):
        predicted ids [T, B, W], time-major."""
        from .functional import gather_tree
        return gather_tree(outputs['token'], outputs['parent']), final_states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Drive decoder.initialize / step until every beam has finished or
    max_step_num steps; the predictions are [B, T, W] unless
    output_time_major."""
    if impute_finished:
        raise NotImplementedError(
            'impute_finished=True: finished beams are already frozen by '
            'BeamSearchDecoder.step (end-token-only extension), so their '
            'outputs need no imputation; file an issue if a custom Decoder '
            'needs it')
    if max_step_num is not None and max_step_num <= 0:
        raise ValueError('max_step_num must be >= 1, got %r' % max_step_num)
    cap = max_step_num if max_step_num is not None else \
        int(os.environ.get('PADDLE_TPU_MAX_DECODE_STEPS', 10000))
    inputs, states, finished = decoder.initialize(inits)
    tokens, parents, scores = [], [], []
    while len(tokens) < cap:
        outputs, states, inputs, finished = decoder.step(
            len(tokens), inputs, states, **kwargs)
        tokens.append(outputs['token'])
        parents.append(outputs['parent'])
        scores.append(outputs['scores'])
        if bool(finished.all()):
            break
    stacked = {'token': torch.stack(tokens), 'parent': torch.stack(parents),
               'scores': torch.stack(scores)}
    lengths = states.get('lengths') if isinstance(states, dict) else None
    preds, final_states = decoder.finalize(stacked, states, lengths)
    if not output_time_major:
        preds = preds.transpose(0, 1)
    if return_length:
        return preds, final_states, lengths
    return preds, final_states
