"""Transformer layers (counterpart of paddle_tpu/nn/layer/transformer.py).

Attention goes through nn.functional.scaled_dot_product_attention, so its
routing is the JAX package's: the flash kernels at 512 tokens or more with
no mask and no attention dropout (so an unmasked encoder with
attn_dropout=0 trains on them, non-causal), the plain path `_sdpa_ref`
otherwise, ring / Ulysses under a sequence-parallel state. Parameter names
are the JAX package's, so a state dict carries across as it is.
`TransformerEncoder` / `TransformerDecoder` build layers 1..n-1 as copies
of the given layer (copy_layer: their parameters keep their ParamAttr
metadata). Layers take `device`, `dtype` and `generator` keyword-only.
"""
import torch
from torch import nn

from ...framework import device as device_mod
from ...tensor import manipulation as M
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import copy_layer
from .norm import LayerNorm

__all__ = ['MultiHeadAttention', 'TransformerEncoderLayer',
           'TransformerEncoder', 'TransformerDecoderLayer',
           'TransformerDecoder', 'Transformer']


def _convert_attention_mask(attn_mask):
    """A bool mask (True: attend) as the f32 additive mask 0 / -1e9; any
    other mask as it is."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return torch.where(attn_mask, 0.0, -1e9).to(torch.float32)


class _MHACache:
    """The growing self-attention cache: k, v [B, L, H, D]."""

    def __init__(self, k, v):
        self.k, self.v = k, v


class _MHAStaticCache:
    """The memory's k, v, projected once."""

    def __init__(self, k, v):
        self.k, self.v = k, v


class MultiHeadAttention(nn.Module):
    Cache = _MHACache
    StaticCache = _MHAStaticCache

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype='float32',
                 generator=None):
        super().__init__()
        dev = device_mod.resolve(device)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _shape(self, x):
        # [B, L, E] -> [B, L, H, D]
        return M.reshape(x, [x.shape[0], x.shape[1], self.num_heads,
                             self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """The attention output [B, L, E]; with a cache, (output, the
        cache after this call)."""
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, _MHAStaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if cache is not None:
                k = M.concat([cache.k, k], axis=1)
                v = M.concat([cache.v, v], axis=1)
                new_cache = _MHACache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(M.reshape(out, [out.shape[0], out.shape[1],
                                            self.embed_dim]))
        if cache is not None:
            return out, new_cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """StaticCache: the memory `key` (and `value`) projected once.
        With `value` alone: a growing cache seeded with key / value
        [B, L, H, D]. Else an empty growing cache [B, 0, H, D] on the
        layer's device and in its dtype."""
        if type is _MHAStaticCache:
            v_src = value if value is not None else key
            return _MHAStaticCache(self._shape(self.k_proj(key)),
                                   self._shape(self.v_proj(v_src)))
        if value is not None:
            return _MHACache(key, value)
        w = self.q_proj.weight
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=w.dtype, device=w.device)
        return _MHACache(empty, empty.clone())


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype='float32', generator=None):
        super().__init__()
        dev = device_mod.resolve(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy_layer(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, nc = mod(output, src_mask, cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype='float32', generator=None):
        super().__init__()
        dev = device_mod.resolve(device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=dev, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, sa_cache = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is not None and len(cache) > 1:
            tgt, _ = self.cross_attn(tgt, memory, memory, memory_mask,
                                     cache[1])
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (sa_cache,) + tuple(cache[1:])

    def gen_cache(self, memory):
        """(an empty growing self-attention cache, the memory's static
        cross-attention cache)."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory,
                                          type=_MHAStaticCache))


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy_layer(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, nc = mod(output, memory, tgt_mask, memory_mask,
                                 cache[i])
                new_caches.append(nc)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation='relu', attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype='float32', generator=None):
        super().__init__()
        dev = device_mod.resolve(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=dev, dtype=dtype) \
                if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=dev, dtype=dtype) \
                if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead
        self._device = dev

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The causal additive mask [length, length]: 0 on and below the
        diagonal, -1e9 above it (f32, on the model's device)."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=self._device).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
