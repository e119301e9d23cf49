"""BERT / ERNIE encoders (counterpart of paddle_tpu/text/models/bert.py): the
embeddings, nn.TransformerEncoder, the pooler, and the classification and
pretraining (MLM + NSP) heads.

`BertModel` builds the additive pad mask itself when none is given, f32
[B, 1, 1, N] of 0 / -1e9 from `input_ids != pad_token_id`, as the JAX
model does, even when no token is padding: a masked call takes the plain
attention path `_sdpa_ref`, never the flash kernels, in both packages.
Parameter names are the JAX package's; `load_bert_state` carries a JAX
BERT's state_dict() across. Weights are drawn on the CPU from a generator
seeded with `seed` and moved to `device` (the current device when None).
"""
import torch
from torch import nn

from ...framework import device as device_mod
from ...framework import random as random_mod
from ... import nn as pnn
from ...nn import functional as F
from ...tensor import manipulation as M
from .gpt import load_paddle_tpu_state

__all__ = ['BertModel', 'BertForSequenceClassification',
           'BertForPretraining', 'ErnieModel',
           'ErnieForSequenceClassification', 'ErnieForPretraining',
           'ernie_1_0', 'load_bert_state']


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embeddings = pnn.Embedding(vocab_size, hidden_size, **kw)
        self.position_embeddings = pnn.Embedding(max_position_embeddings,
                                                 hidden_size, **kw)
        self.token_type_embeddings = pnn.Embedding(type_vocab_size,
                                                   hidden_size, **kw)
        self.layer_norm = pnn.LayerNorm(hidden_size, device=device)
        self.dropout = pnn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids) + \
            self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, hidden_size, *, device=None, generator=None):
        super().__init__()
        self.dense = pnn.Linear(hidden_size, hidden_size, device=device,
                                generator=generator)
        self.activation = pnn.Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


def _setup(device, seed):
    return device_mod.resolve(device), random_mod.seed(seed)


class BertModel(nn.Module):
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act='gelu',
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0, *, device=None,
                 seed=0, generator=None):
        super().__init__()
        dev, gen = _setup(device, seed)
        gen = generator or gen
        self.pad_token_id = pad_token_id
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, hidden_dropout_prob, device=dev, generator=gen)
        enc_layer = pnn.TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation=hidden_act,
            attn_dropout=attention_probs_dropout_prob, act_dropout=0.0,
            device=dev, generator=gen)
        self.encoder = pnn.TransformerEncoder(enc_layer, num_hidden_layers)
        self.pooler = BertPooler(hidden_size, device=dev, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        """(encoded [B, N, H], pooled [B, H])."""
        if attention_mask is None:
            attention_mask = torch.where(
                input_ids != self.pad_token_id, 0.0,
                -1e9)[:, None, None, :].to(torch.float32)
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        encoded = self.encoder(emb, attention_mask)
        return encoded, self.pooler(encoded)


def _hidden(bert):
    return bert.pooler.dense.weight.shape[1]


class BertForSequenceClassification(nn.Module):
    def __init__(self, bert=None, num_classes=2, dropout=0.1, *, device=None,
                 seed=0, **bert_kwargs):
        super().__init__()
        dev, gen = _setup(device, seed)
        self.bert = bert or BertModel(device=dev, generator=gen,
                                      **bert_kwargs)
        self.dropout = pnn.Dropout(dropout)
        self.classifier = pnn.Linear(
            _hidden(self.bert), num_classes,
            device=self.bert.pooler.dense.weight.device, generator=gen)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(nn.Module):
    """The MLM and NSP heads. With fused_mlm=True the training forward
    returns the transformed hidden states in the place of the MLM logits,
    and loss() fuses the decoder matmul into F.linear_cross_entropy, which
    never forms the [rows, vocab] logits (the contract of GPTConfig's
    fused_loss); vocab and hidden must then differ."""

    def __init__(self, bert=None, fused_mlm=False, *, device=None, seed=0,
                 **bert_kwargs):
        super().__init__()
        dev, gen = _setup(device, seed)
        self.bert = bert or BertModel(device=dev, generator=gen,
                                      **bert_kwargs)
        hidden = _hidden(self.bert)
        vocab = self.bert.embeddings.word_embeddings.weight.shape[0]
        dev = self.bert.pooler.dense.weight.device
        kw = dict(device=dev, generator=gen)
        self.transform = pnn.Linear(hidden, hidden, **kw)
        self.act = pnn.GELU()
        self.layer_norm = pnn.LayerNorm(hidden, device=dev)
        self.decoder = pnn.Linear(hidden, vocab, **kw)
        self.seq_relationship = pnn.Linear(hidden, 2, **kw)
        if fused_mlm and vocab == hidden:
            raise ValueError(
                'fused_mlm=True requires vocab_size != hidden_size '
                '(loss() distinguishes hidden states from logits by '
                'their trailing dimension); got both = %d' % vocab)
        self.fused_mlm = fused_mlm

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        encoded, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                    attention_mask)
        h = self.layer_norm(self.act(self.transform(encoded)))
        nsp = self.seq_relationship(pooled)
        if self.fused_mlm and self.training:
            return h, nsp
        return self.decoder(h), nsp

    def loss(self, mlm_out, nsp_out, mlm_labels, nsp_labels,
             ignore_index=-100):
        """The mean MLM cross-entropy over positions whose label is not
        ignore_index, plus the NSP cross-entropy."""
        if self.fused_mlm and self.training and \
                mlm_out.shape[-1] == self.transform.weight.shape[0]:
            mlm = F.linear_cross_entropy(
                mlm_out, self.decoder.weight, mlm_labels,
                bias=self.decoder.bias, ignore_index=ignore_index)
        else:
            b, n, v = mlm_out.shape
            mlm = F.cross_entropy(M.reshape(mlm_out, [b * n, v]),
                                  M.reshape(mlm_labels, [b * n]),
                                  ignore_index=ignore_index)
        return mlm + F.cross_entropy(nsp_out, nsp_labels)

    def flops_per_token(self, seq_len):
        """Forward + backward FLOPs a token of a training step at
        `seq_len`: 6 x the multiply-adds of every matmul a token runs (the
        encoder's projections and MLP, the MLM transform and the decoder
        over every row, as the fused CE computes them all), plus the
        non-causal attention's q k^T and p v over all seq_len keys. The
        pooler and NSP head run once a sequence, the embeddings gather."""
        h = _hidden(self.bert)
        enc = self.bert.encoder
        layers = len(enc.layers)
        inter = enc.layers[0].linear1.weight.shape[1]
        vocab = self.decoder.weight.shape[1]
        per_layer = 4 * h * h + 2 * h * inter
        matmul = layers * per_layer + h * h + h * vocab
        attention = layers * 2 * h * int(seq_len)
        return 6 * matmul + 6 * attention


# ERNIE 1.0 shares BERT's network; its differences were the pretraining
# objectives (phrase and entity masking), not the encoder.
ErnieModel = BertModel
ErnieForSequenceClassification = BertForSequenceClassification
ErnieForPretraining = BertForPretraining


def ernie_1_0(vocab_size=18000, hidden_size=768, **kwargs):
    """ERNIE-1.0-base: BertModel with vocab 18000, hidden 768 (12 layers,
    12 heads)."""
    return ErnieModel(vocab_size=vocab_size, hidden_size=hidden_size,
                      **kwargs)


def load_bert_state(model, arrays):
    """Fill a BERT model from {name: np.ndarray} as the JAX model's
    state_dict() gives it (keys like 'bert.encoder.layers.0.linear1.weight');
    raises on a missing or extra key or a shape mismatch before anything is
    copied (load_paddle_tpu_state)."""
    return load_paddle_tpu_state(model, arrays)
