"""GPT decoder-only LM (counterpart of paddle_tpu/text/models/gpt.py): the
no-cache forward, cached greedy or sampled `generate()`, the serving caches
(`GPTSlotCache`, `GPTPagedCache`) the continuous-batching engines drive, and
the training contract (`loss()`, the fused-loss forward,
`flops_per_token`).

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

__all__ = ['GPTConfig', 'GPTStaticCache', 'GPTSlotCache', 'GPTPagedCache',
           'GPTModel', 'GPTForCausalLM', 'load_paddle_tpu_state']


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


def _on_device(x, device):
    """Per-row lengths or block tables as an int64 tensor on `device` (a
    host array is copied over)."""
    return torch.as_tensor(x, device=device).long()


def _check_capacity(kind, lengths, n, capacity):
    """Overflow check for lengths given as a host array. Lengths given as
    a tensor are not read back: the serving engine hands tensors and
    guards capacity at admission, as the JAX package's jitted path does
    (its frozen rows may run past the capacity: their writes are clipped
    to the slot or sent to the scratch page)."""
    if isinstance(lengths, torch.Tensor):
        return
    top = int(np.max(np.asarray(lengths)))
    if top + n > capacity:
        raise ValueError('%s cache overflow: max row length %d + %d new '
                         'tokens > capacity %d' % (kind, top, n, capacity))


def _validity_mask(lengths, n, width):
    """The additive validity mask [rows, 1, n, width] of a forward over
    slot or paged caches: query i of row s sits at absolute position
    lengths[s] + i and sees logical positions <= it (0), the rest at -1e9
    (exp underflows to exact 0 in the f32 softmax)."""
    qpos = lengths[:, None] + torch.arange(n, device=lengths.device)
    kpos = torch.arange(width, device=lengths.device)
    allow = qpos[:, :, None] >= kpos[None, None, :]
    return torch.where(allow, 0.0, -1e9)[:, None].float()


class SharedIndex:
    """The index tensors of one forward over slot or paged caches: the
    rows each layer writes this step's K/V to, the paged gather view and
    the validity mask. They depend only on the lengths and block tables,
    which every layer of a forward shares, so handed to every layer's
    cache of one forward (the serving engines do so) they are built once
    for all of them; a cache given none builds its own at each call."""

    def __init__(self):
        self._built = {}

    def get(self, key, build):
        out = self._built.get(key)
        if out is None:
            out = self._built[key] = build()
        return out


class GPTSlotCache:
    """Slot-batched K/V cache for continuous batching (the serving engine):
    per layer, [num_slots, max_len] rows of K and V and a per-slot valid
    length. Each slot advances on its own, so a step takes the same shapes
    whatever requests occupy which slots.

    The buffers are stored [num_slots, H, max_len, Dh], so the masked
    attention reads each slot's keys as a view; `k` and `v` give them in
    the JAX package's [num_slots, max_len, H, Dh] layout (views, no copy).
    Construct with buffers in the stored layout, or with `empty`.

    Invariants (the engine owns them, as in the JAX package):
      - attention writes this step's K/V at each slot's length in place
        but does not advance `lengths`; the engine advances them after the
        whole forward (padded prefill tails by the valid count);
      - rows at or past a slot's length are garbage and never attended:
        the validity mask admits positions <= the query's own;
      - capacity is guarded at admission; writes are clipped to the
        buffer, so a frozen slot's garbage write stays inside it.
    `lengths` is an int tensor [num_slots] (the serving engine hands one on
    the card per step) or a host array, which is checked for overflow;
    `index` an optional SharedIndex of the forward the cache serves.
    """

    def __init__(self, k_buf, v_buf, lengths, index=None):
        self.kt = k_buf
        self.vt = v_buf
        self.lengths = lengths
        self.index = index

    @property
    def k(self):
        return self.kt.transpose(1, 2)

    @property
    def v(self):
        return self.vt.transpose(1, 2)

    @staticmethod
    def empty(num_slots, max_len, num_heads, head_dim, dtype='float32',
              device='cuda'):
        dev = device_mod.resolve(device)
        shape = (num_slots, num_heads, max_len, head_dim)
        dt = to_torch_dtype(dtype)
        return GPTSlotCache(torch.zeros(shape, dtype=dt, device=dev),
                            torch.zeros(shape, dtype=dt, device=dev),
                            torch.zeros(num_slots, dtype=torch.long,
                                        device=dev))


class GPTPagedCache:
    """Page-granular K/V cache for the paged serving engine: per layer, a
    pool of num_pages pages of page_size rows, a block table [B,
    max_blocks] of page ids per sequence and per-sequence valid lengths
    [B]. Logical row j of sequence s lives in page
    block_tables[s, j // page_size] at row j % page_size, so sequences
    hold only the pages they need and may share leading pages (prefix
    sharing).

    The pools are stored [num_pages, H, page_size, Dh]; `k` and `v` give
    the JAX package's [num_pages, page_size, H, Dh] layout as views. Each
    forward gathers every sequence's logical rows straight into the [B, H,
    L, Dh] layout the attention reads.

    Invariants (the engine and PagedScheduler own them):
      - block-table entry 0 is the scratch page, never handed to a real
        block: writes from frozen rows land there or on the row's own
        dead rows, both unreachable; shared pages are full, immutable
        blocks below every writer's length;
      - attention writes at each row's length without advancing
        `lengths`; rows at or past a length are never attended;
      - capacity is guarded at admission; a write past a row's logical
        capacity lands on the scratch page.
    `block_tables` and `lengths` are int tensors or host arrays (host
    lengths are checked for overflow); `index` an optional SharedIndex of
    the forward the cache serves.
    """

    def __init__(self, k_pool, v_pool, block_tables, lengths, index=None):
        self.kt = k_pool
        self.vt = v_pool
        self.block_tables = block_tables
        self.lengths = lengths
        self.index = index

    @property
    def k(self):
        return self.kt.transpose(1, 2)

    @property
    def v(self):
        return self.vt.transpose(1, 2)

    @staticmethod
    def empty(num_pages, page_size, max_blocks, batch, num_heads, head_dim,
              dtype='float32', device='cuda'):
        dev = device_mod.resolve(device)
        shape = (num_pages, num_heads, page_size, head_dim)
        dt = to_torch_dtype(dtype)
        return GPTPagedCache(torch.zeros(shape, dtype=dt, device=dev),
                             torch.zeros(shape, dtype=dt, device=dev),
                             torch.zeros((batch, max_blocks),
                                         dtype=torch.long, device=dev),
                             torch.zeros(batch, dtype=torch.long,
                                         device=dev))


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
        if isinstance(cache, tuple):
            # the growing cache: past (k, v) [B, t, H, Dh] in, the
            # concatenated (k, v) out; bottom-right causal attention
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.dropout if self.training else 0.0,
                training=self.training)
            return self.out_proj(out.reshape(b, n, self.hidden_size)), (k, v)
        if self.training and torch.is_grad_enabled():
            # the buffer writes are in place: training through them would
            # lose the k/v gradients
            raise RuntimeError(
                '%s is an inference-only decode path — call model.eval() / '
                'torch.no_grad() / generate()' % type(cache).__name__)
        if isinstance(cache, GPTPagedCache):
            out = self._paged(q, k, v, cache)
        elif isinstance(cache, GPTSlotCache):
            out = self._slot(q, k, v, cache)
        elif isinstance(cache, GPTStaticCache):
            out, cache = self._static(q, k, v, cache)
        else:
            raise TypeError('unknown cache type %s' % type(cache).__name__)
        return self.out_proj(out.reshape(b, n, self.hidden_size)), cache

    def _static(self, q, k, v, cache):
        n = q.shape[1]
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
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  dropout_p=0.0), new_cache
        # validity mask over the fixed buffer: query row i (absolute
        # position t + i) sees buffer slots j <= t + i
        qpos = t + torch.arange(n, device=q.device)
        kpos = torch.arange(max_len, device=q.device)
        mask = torch.zeros((n, max_len), dtype=torch.float32, device=q.device)
        mask.masked_fill_(qpos[:, None] < kpos[None, :], -1e9)
        out = F.scaled_dot_product_attention(
            q, cache.k, cache.v, attn_mask=mask[None, None], is_causal=False,
            dropout_p=0.0)
        return out, new_cache

    def _slot(self, q, k, v, cache):
        """Write at each slot's length, then masked attention over each
        slot's whole buffer (read as a view of the [S, H, L, Dh] store)."""
        s, n = q.shape[0], q.shape[1]
        max_len = cache.kt.shape[2]
        dev = q.device

        def build():
            _check_capacity('slot', cache.lengths, n, max_len)
            t = _on_device(cache.lengths, dev)
            pos = (t[:, None] + torch.arange(n, device=dev)).clamp_(
                max=max_len - 1)                                   # [S, n]
            rows = torch.arange(s, device=dev)[:, None, None]
            heads = torch.arange(self.num_heads, device=dev)[None, None, :]
            return ((rows, heads, pos[:, :, None]),
                    _validity_mask(t, n, max_len))               # [S,1,n,L]

        idx, mask = (cache.index or SharedIndex()).get(
            ('slot', s, n, max_len), build)
        cache.kt[idx] = k.to(cache.kt.dtype)
        cache.vt[idx] = v.to(cache.vt.dtype)
        return F.scaled_dot_product_attention(
            q, cache.k, cache.v, attn_mask=mask, is_causal=False,
            dropout_p=0.0)

    def _paged(self, q, k, v, cache):
        """One scatter of this step's K/V through the block tables
        (positions past a row's logical capacity go to the scratch page),
        then each row's logical view gathered into [B, H, L, Dh] and the
        slot path's masked attention."""
        b, n = q.shape[0], q.shape[1]
        page = cache.kt.shape[2]
        dev = q.device

        def build():
            bt = _on_device(cache.block_tables, dev)              # [B, nb]
            cap = bt.shape[1] * page             # logical capacity of a row
            _check_capacity('paged', cache.lengths, n, cap)
            t = _on_device(cache.lengths, dev)
            heads = torch.arange(self.num_heads, device=dev)
            pos = t[:, None] + torch.arange(n, device=dev)        # [B, n]
            # a position past the row's capacity (a frozen row, or the
            # tail of a verify pass) writes to the scratch page
            pages = torch.gather(bt, 1, pos.clamp(max=cap - 1) // page)
            pages.masked_fill_(pos >= cap, 0)
            write = (pages[:, :, None], heads[None, None, :],
                     (pos % page)[:, :, None])
            logical = torch.arange(cap, device=dev)
            view = (bt[:, logical // page][:, None, :],
                    heads[None, :, None], (logical % page)[None, None, :])
            return write, view, _validity_mask(t, n, cap)        # [B,1,n,L]

        write, view, mask = (cache.index or SharedIndex()).get(
            ('paged', b, n, page), build)
        cache.kt[write] = k.to(cache.kt.dtype)
        cache.vt[write] = v.to(cache.vt.dtype)
        kg = cache.kt[view]                                    # [B, H, L, Dh]
        vg = cache.vt[view]
        return F.scaled_dot_product_attention(
            q, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask,
            is_causal=False, dropout_p=0.0)


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
    """The decoder stack. `GPTModel(config)` or `GPTModel(**config_kwargs)`,
    as in the JAX package."""

    def __init__(self, config=None, device='cuda', generator=None, **kwargs):
        super().__init__()
        config = config or GPTConfig(**kwargs)
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

    def forward(self, input_ids, position_ids=None, caches=None):
        """Final hidden states, or with caches (hidden, new caches).
        Positions default as in the JAX package: each row continues from
        its own length for slot and paged caches, from the cached length
        for the static cache (and the past keys' length for the (k, v)
        tuple cache, where the JAX package needs them passed), else
        0..n-1."""
        n = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            c0 = caches[0] if caches is not None else None
            if isinstance(c0, (GPTSlotCache, GPTPagedCache)):
                # clamped: a frozen row's positions may run past the table
                # (its rows are garbage the mask never admits), where the
                # JAX package's gather clamps them
                position_ids = (_on_device(c0.lengths, dev)[:, None] +
                                torch.arange(n, device=dev)[None, :]).clamp_(
                    max=self.config.max_position_embeddings - 1)
            else:
                if isinstance(c0, GPTStaticCache):
                    start = c0.length
                elif isinstance(c0, tuple):
                    start = c0[0].shape[1]
                else:
                    start = 0
                position_ids = torch.arange(start, start + n,
                                            device=dev)[None, :]
        else:
            position_ids = torch.as_tensor(position_ids, device=dev).long()
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
    config.tie_word_embeddings is False. `GPTForCausalLM(config)` or
    `GPTForCausalLM(**config_kwargs)`, as in the JAX package. Weights are
    drawn from a CPU generator seeded with `seed` and moved to `device`, so
    one seed gives one model on every device."""

    def __init__(self, config=None, device='cuda', seed=0, **kwargs):
        super().__init__()
        config = config or GPTConfig(**kwargs)
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

    def forward(self, input_ids, position_ids=None, caches=None):
        """Logits, or with caches (logits, new caches). In training with
        config.fused_loss the no-cache forward returns the final hidden
        state instead: loss() then fuses the head matmul with the CE."""
        if caches is not None:
            hidden, new_caches = self.gpt(input_ids, position_ids,
                                          caches=caches)
            return self._logits(hidden), new_caches
        hidden = self.gpt(input_ids, position_ids)
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
        prompt followed by the new tokens, [B, n0 + max_new_tokens], int32
        as in the JAX package."""
        was_training = self.training
        self.eval()
        try:
            dev = self.gpt.wte.weight.device
            ids = torch.as_tensor(input_ids, device=dev).long()
            if max_new_tokens <= 0:
                return ids.int()
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
            return torch.cat(out, dim=1).int()
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
