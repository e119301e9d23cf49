"""GPT decoder-only LM (counterpart of paddle_tpu/text/models/gpt.py): the
no-cache forward, cached greedy or sampled `generate()`, and the training
contract (`loss()`, the fused-loss forward, `flops_per_token`).

Causal attention goes through nn.functional.scaled_dot_product_attention,
which sends a sequence of 512 tokens or more to the flash kernels.
Parameter names match the JAX package's state_dict, so
`load_paddle_tpu_state` carries its weights across as they are. MoE
blocks, activation recompute and pipeline stages are not ported yet.
"""
import numpy as np
import torch
from torch import nn

from ...framework import device as device_mod
from ...framework import random as random_mod
from ...framework.dtype import to_torch_dtype
from ... import nn as pnn
from ...nn import functional as F

__all__ = ['GPTConfig', 'GPTStaticCache', 'GPTModel', 'GPTForCausalLM',
           'load_paddle_tpu_state']


class GPTConfig:
    """The JAX package's GPTConfig."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, dropout=0.1,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_rmsnorm=False, tie_word_embeddings=True,
                 recompute=False, num_experts=0, moe_capacity_factor=1.5,
                 fused_loss=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        # kept for parity; the JAX package's GPT does not read it either
        self.initializer_range = initializer_range
        self.use_rmsnorm = use_rmsnorm
        self.tie_word_embeddings = tie_word_embeddings
        self.recompute = recompute
        self.num_experts = num_experts
        self.moe_capacity_factor = moe_capacity_factor
        # fused_loss=True: in training, forward() returns the final hidden
        # state and loss() fuses the head matmul with the CE. loss() tells
        # hidden states from logits by the trailing dim, so vocab and hidden
        # must differ.
        if fused_loss and vocab_size == hidden_size:
            raise ValueError(
                'fused_loss=True requires vocab_size != hidden_size '
                '(loss() distinguishes hidden states from logits by '
                'their trailing dimension); got both = %d' % vocab_size)
        self.fused_loss = fused_loss

    @staticmethod
    def gpt2_small():
        return GPTConfig()

    @staticmethod
    def bert_base_equiv():
        return GPTConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                         num_heads=12, max_position_embeddings=512)


class GPTStaticCache:
    """Preallocated [B, max_len, H, Dh] K/V buffers plus the valid length.

    Unlike the JAX package's immutable buffers, the port writes each step's
    K/V into the buffers in place, which saves a copy of the whole cache per
    layer and token. A cache is therefore consumed by the step that takes
    it: use the one that step returns. `fresh` marks a cache no write has
    touched, whose multi-token prefill may take the plain causal path."""

    def __init__(self, k_buf, v_buf, length, fresh=False):
        self.k = k_buf
        self.v = v_buf
        self.length = length
        self.fresh = fresh

    @staticmethod
    def empty(batch, max_len, num_heads, head_dim, dtype='float32',
              device='cuda'):
        shape = (batch, max_len, num_heads, head_dim)
        dev = device_mod.resolve(device)
        dt = to_torch_dtype(dtype)
        return GPTStaticCache(torch.zeros(shape, dtype=dt, device=dev),
                              torch.zeros(shape, dtype=dt, device=dev), 0,
                              fresh=True)


class GPTAttention(nn.Module):
    def __init__(self, config, device='cuda', generator=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = pnn.Linear(config.hidden_size, 3 * config.hidden_size,
                                   device=device, generator=generator)
        self.out_proj = pnn.Linear(config.hidden_size, config.hidden_size,
                                   device=device, generator=generator)
        self.dropout = config.dropout

    def forward(self, x, cache=None):
        b, n = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.dropout if self.training else 0.0,
                training=self.training)
            return self.out_proj(out.reshape(b, n, self.hidden_size))
        if not isinstance(cache, GPTStaticCache):
            raise TypeError('the port supports GPTStaticCache only, got %s'
                            % type(cache).__name__)
        if self.training and torch.is_grad_enabled():
            # the buffer writes are in place: training through them would
            # lose the k/v gradients
            raise RuntimeError(
                'GPTStaticCache is an inference-only decode path — '
                'call model.eval() / torch.no_grad() / generate()')
        max_len = cache.k.shape[1]
        t = cache.length
        if t + n > max_len:
            raise ValueError(
                'static cache overflow: length %d + %d new tokens > '
                'capacity %d' % (t, n, max_len))
        cache.k[:, t:t + n] = k
        cache.v[:, t:t + n] = v
        new_cache = GPTStaticCache(cache.k, cache.v, t + n)
        if cache.fresh and n > 1:
            # prefill on an untouched cache: plain causal attention over the
            # chunk itself (flash-eligible), not masked attention over the
            # max_len - n empty slots
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 dropout_p=0.0)
        else:
            # validity mask over the fixed buffer: query row i (absolute
            # position t + i) sees buffer slots j <= t + i
            qpos = t + torch.arange(n, device=x.device)
            kpos = torch.arange(max_len, device=x.device)
            mask = torch.zeros((n, max_len), dtype=torch.float32,
                               device=x.device)
            mask.masked_fill_(qpos[:, None] < kpos[None, :], -1e9)
            out = F.scaled_dot_product_attention(
                q, cache.k, cache.v, attn_mask=mask[None, None],
                is_causal=False, dropout_p=0.0)
        return self.out_proj(out.reshape(b, n, self.hidden_size)), new_cache


class GPTMLP(nn.Module):
    def __init__(self, config, device='cuda', generator=None):
        super().__init__()
        self.fc_in = pnn.Linear(config.hidden_size, config.intermediate_size,
                                device=device, generator=generator)
        self.fc_out = pnn.Linear(config.intermediate_size, config.hidden_size,
                                 device=device, generator=generator)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x):
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))


def _norm(config, device):
    norm = pnn.RMSNorm if config.use_rmsnorm else pnn.LayerNorm
    return norm(config.hidden_size, config.layer_norm_epsilon, device=device)


class GPTBlock(nn.Module):
    def __init__(self, config, device='cuda', generator=None):
        super().__init__()
        self.ln_1 = _norm(config, device)
        self.attn = GPTAttention(config, device=device, generator=generator)
        self.ln_2 = _norm(config, device)
        self.mlp = GPTMLP(config, device=device, generator=generator)

    def forward(self, x, cache=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln_1(x), cache=cache)
            x = x + a
            x = x + self.mlp(self.ln_2(x))
            return x, new_cache
        x = x + self.attn(self.ln_1(x))
        x = x + self.mlp(self.ln_2(x))
        return x


class GPTModel(nn.Module):
    def __init__(self, config, device='cuda', generator=None):
        super().__init__()
        if config.num_experts:
            raise NotImplementedError(
                'MoE blocks (num_experts > 0) are not ported yet; they come '
                'with the distributed slice')
        if config.recompute:
            raise NotImplementedError(
                'activation recompute is not ported yet (a later training '
                'slice)')
        self.config = config
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size,
                                 device=device, generator=generator)
        self.wpe = pnn.Embedding(config.max_position_embeddings,
                                 config.hidden_size, device=device,
                                 generator=generator)
        self.drop = pnn.Dropout(config.dropout)
        self.h = nn.ModuleList([GPTBlock(config, device=device,
                                         generator=generator)
                                for _ in range(config.num_layers)])
        self.ln_f = _norm(config, device)

    def forward(self, input_ids, caches=None):
        n = input_ids.shape[1]
        # decode: positions continue from the cached length
        start = caches[0].length if caches is not None else 0
        position_ids = torch.arange(start, start + n,
                                    device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        if caches is not None:
            new_caches = []
            for block, c in zip(self.h, caches):
                x, nc = block(x, cache=c)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with a language-model head, tied to the token embedding unless
    config.tie_word_embeddings is False. Weights are drawn from a CPU
    generator seeded with `seed` and moved to `device`, so one seed gives
    one model on every device."""

    def __init__(self, config, device='cuda', seed=0):
        super().__init__()
        dev = device_mod.resolve(device)
        self.config = config
        gen = random_mod.seed(seed)
        self.gpt = GPTModel(config, device=dev, generator=gen)
        self.lm_head = None if config.tie_word_embeddings else pnn.Linear(
            config.hidden_size, config.vocab_size, bias=False, device=dev,
            generator=gen)

    def _logits(self, hidden):
        if self.lm_head is None:
            return F.linear(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)

    def forward(self, input_ids, caches=None):
        """Logits, or with caches (logits, new caches). In training with
        config.fused_loss the no-cache forward returns the final hidden
        state instead: loss() then fuses the head matmul with the CE."""
        if caches is not None:
            hidden, new_caches = self.gpt(input_ids, caches=caches)
            return self._logits(hidden), new_caches
        hidden = self.gpt(input_ids)
        if self.config.fused_loss and self.training:
            return hidden
        return self._logits(hidden)

    def loss(self, logits, labels):
        """Mean token CE. Under the fused training contract `logits` is the
        final hidden state and the head matmul runs inside
        F.linear_cross_entropy, which never forms the [rows, vocab]
        logits."""
        if self.config.fused_loss and self.training and \
                logits.shape[-1] == self.config.hidden_size:
            if self.lm_head is None:
                return F.linear_cross_entropy(
                    logits, self.gpt.wte.weight, labels,
                    transpose_weight=True)
            return F.linear_cross_entropy(logits, self.lm_head.weight,
                                          labels)
        b, n, v = logits.shape
        return F.cross_entropy(logits.reshape(b * n, v),
                               labels.reshape(b * n))

    def enable_recompute(self, flag=True):
        if flag:
            raise NotImplementedError(
                'activation recompute is not ported yet (a later training '
                'slice)')

    def pp_decompose(self, loss_fn=None):
        raise NotImplementedError(
            'pipeline stages are not ported yet; they come with the '
            'distributed slice')

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, do_sample=False, seed=0):
        """Prefill the prompt into fresh static caches, then decode one token
        per step. Greedy by default; do_sample=True draws from
        softmax(logits / temperature) restricted to top_k (0 = the whole
        vocabulary), from a torch.Generator seeded with `seed`. Returns the
        prompt followed by the new tokens, [B, n0 + max_new_tokens]."""
        was_training = self.training
        self.eval()
        try:
            dev = self.gpt.wte.weight.device
            ids = torch.as_tensor(input_ids, device=dev).long()
            if max_new_tokens <= 0:
                return ids
            b, n0 = ids.shape
            max_len = n0 + max_new_tokens
            if max_len > self.config.max_position_embeddings:
                raise ValueError(
                    'prompt %d + max_new_tokens %d exceeds '
                    'max_position_embeddings %d' %
                    (n0, max_new_tokens, self.config.max_position_embeddings))
            c = self.config
            caches = [GPTStaticCache.empty(
                b, max_len, c.num_heads, c.hidden_size // c.num_heads,
                dtype=self.gpt.wte.weight.dtype, device=dev)
                for _ in self.gpt.h]
            gen = torch.Generator(device=dev).manual_seed(int(seed))

            def pick(hidden):
                # only the last position's logits are needed
                lg = self._logits(hidden[:, -1]).float()
                if not do_sample:
                    return lg.argmax(dim=-1)
                lg = lg / max(float(temperature), 1e-6)
                if top_k:
                    kth = lg.sort(dim=-1).values[:, -int(top_k)][:, None]
                    lg = torch.where(lg >= kth, lg, -1e30)
                return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                         generator=gen)[:, 0]

            hidden, caches = self.gpt(ids, caches=caches)
            out = [ids, pick(hidden)[:, None]]
            for _ in range(max_new_tokens - 1):
                hidden, caches = self.gpt(out[-1], caches=caches)
                out.append(pick(hidden)[:, None])
            return torch.cat(out, dim=1)
        finally:
            if was_training:
                self.train()

    def num_params(self):
        return int(sum(p.numel() for p in self.parameters()))

    def flops_per_token(self, seq_len=None):
        """Approximate forward + backward FLOPs per token: 6 N plus the
        attention term, which scales with the sequence length actually
        run (max_position_embeddings when None)."""
        c = self.config
        if seq_len is None:
            seq_len = c.max_position_embeddings
        return (6 * self.num_params() +
                12 * c.num_layers * c.hidden_size * int(seq_len))


def load_paddle_tpu_state(model, arrays):
    """Fill `model` from {name: np.ndarray} as the JAX package's
    state_dict() gives it (keys like 'gpt.h.0.attn.qkv_proj.weight', and
    'lm_head.weight' for an untied head).
    Raises on a missing key, an extra key or a shape mismatch, before
    anything is copied."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError('state does not match the model: missing %s, extra %s'
                       % (missing, extra))
    host = {}
    for key, target in own.items():
        arr = np.asarray(arrays[key])
        if arr.shape != tuple(target.shape):
            raise ValueError('%s: shape %s does not match the model\'s %s'
                             % (key, arr.shape, tuple(target.shape)))
        if arr.dtype.name == 'bfloat16':  # numpy has no torch bridge for it
            arr = arr.astype(np.float32)
        host[key] = torch.tensor(arr)
    with torch.no_grad():
        for key, target in own.items():
            target.copy_(host[key])
    return model
