"""GPT decoder-only LM (counterpart of paddle_tpu/text/models/gpt.py): the
no-cache forward, cached greedy or sampled `generate()`, the serving caches
(`GPTSlotCache`, `GPTPagedCache`) the continuous-batching engines drive, and
the training contract (`loss()`, the fused-loss forward,
`flops_per_token`), with per-block activation recompute
(`GPTConfig.recompute`, `enable_recompute()`).

Causal attention goes through nn.functional.scaled_dot_product_attention,
which sends a sequence of 512 tokens or more to the flash kernels.
Parameter names match the JAX package's state_dict, so
`load_paddle_tpu_state` carries its weights across as they are. The
parameters carry the JAX package's tensor-parallel placement hints; once
distributed/strategy.py has laid them out as DTensors over 'mp', the
attention, the MLP, the embedding and the head run on their shards
(distributed/meta_parallel/mp_layers.py). Under an active sequence-
parallel state the positions are the rank's shard's (distributed/sp.py).

GPTConfig.num_experts > 0 swaps each block's MLP for a SwitchMoE
(incubate/moe.py); in training the blocks' load-balancing terms, weighted
by aux_loss_weight, are summed and consumed once by loss(). MoE under a
pipeline or recompute raises, as in the JAX package.

Pipeline parallelism: the schedules (distributed/pipeline.py,
pipeline_1f1b.py) enter the GPT through pp_decompose(), which gives the
(pre, blocks, post) split they run, so forward() has no pipeline branch
(the JAX package's runs its shard_map pipeline there); it only refuses
MoE under an active pp state. pp_keep_stage() keeps one stage's layers
under their global names, so load_paddle_tpu_state takes that stage's
slice of a whole state.
"""
import numpy as np
import torch
from torch import nn

from ...framework import device as device_mod
from ...framework import random as random_mod
from ...framework.dtype import to_torch_dtype
from ... import nn as pnn
from ...distributed.fleet.utils import recompute as _recompute
from ...distributed.meta_parallel import mp_layers
from ...ops import ring_attention
from ...nn import functional as F

__all__ = ['GPTConfig', 'GPTStaticCache', 'GPTSlotCache', 'GPTPagedCache',
           'GPTModel', 'GPTForCausalLM', 'cache_heads', 'load_paddle_tpu_state']


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

    @staticmethod
    def gpt3_13b():
        """GPT-3 13B (Brown et al. 2020): hidden 5120, 40 layers of 40
        heads (d = 128), 2048 positions. A full-size step needs sharding
        across cards."""
        return GPTConfig(vocab_size=50304, hidden_size=5120, num_layers=40,
                         num_heads=40, max_position_embeddings=2048)


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
              device=None):
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
              device=None):
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
              dtype='float32', device=None):
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
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = pnn.Linear(config.hidden_size, 3 * config.hidden_size,
                                   device=device, generator=generator)
        self.out_proj = pnn.Linear(config.hidden_size, config.hidden_size,
                                   device=device, generator=generator)
        self.dropout = config.dropout
        # tensor-parallel placement hints (distributed/strategy.py)
        self.qkv_proj.weight.placement = (None, 'mp')
        self.qkv_proj.bias.placement = ('mp',)
        self.out_proj.weight.placement = ('mp', None)

    def _attend(self, q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)

    def _project_qkv(self, x):
        """(q, k, v) [B, n, H', Dh] and the output projection, H' the heads
        this rank computes: all of them; or, with the projections sharded
        over 'mp' (DTensors), its num_heads / mp heads from its columns of
        the gathered QKV weight (an all-gather of the [hidden, 3 * hidden]
        weight a call, and so a token and layer in decode), the output
        projection row-parallel."""
        b, n = x.shape[0], x.shape[1]
        # a projection swapped for slim's WeightOnlyLinear has no weight
        group = mp_layers.mp_group_of(getattr(self.qkv_proj, 'weight', None))
        if group is None:
            qkv = self.qkv_proj(x).reshape(b, n, 3, self.num_heads,
                                           self.head_dim)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.out_proj
        w, bias, heads = mp_layers.qkv_head_columns(
            self.qkv_proj.weight, self.qkv_proj.bias, self.num_heads)
        qkv = torch.matmul(mp_layers.copy_to_mp(x, group), w)
        if bias is not None:
            qkv = qkv + bias
        qkv = qkv.reshape(b, n, 3, heads, self.head_dim)

        def out_proj(o):
            return mp_layers.row_linear(o, self.out_proj.weight,
                                        self.out_proj.bias)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], out_proj

    def forward(self, x, cache=None):
        b, n = x.shape[0], x.shape[1]
        q, k, v, out_proj = self._project_qkv(x)
        width = q.shape[2] * self.head_dim
        if cache is None:
            out = self._attend(q, k, v)
            return out_proj(out.reshape(b, n, width))
        if isinstance(cache, tuple):
            # the growing cache: past (k, v) [B, t, H, Dh] in, the
            # concatenated (k, v) out; bottom-right causal attention
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.dropout if self.training else 0.0,
                training=self.training)
            return out_proj(out.reshape(b, n, width)), (k, v)
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
        return out_proj(out.reshape(b, n, width)), cache

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
            heads = torch.arange(q.shape[2], device=dev)[None, None, :]
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
            heads = torch.arange(q.shape[2], device=dev)
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
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        self.fc_in = pnn.Linear(config.hidden_size, config.intermediate_size,
                                device=device, generator=generator)
        self.fc_out = pnn.Linear(config.intermediate_size, config.hidden_size,
                                 device=device, generator=generator)
        self.dropout = pnn.Dropout(config.dropout)
        self.fc_in.weight.placement = (None, 'mp')
        self.fc_in.bias.placement = ('mp',)
        self.fc_out.weight.placement = ('mp', None)

    def forward(self, x):
        if mp_layers.mp_group_of(getattr(self.fc_in, 'weight', None)) \
                is not None:
            # column-parallel fc_in, row-parallel fc_out
            h = F.gelu(mp_layers.column_linear(x, self.fc_in.weight,
                                               self.fc_in.bias),
                       approximate=True)
            return self.dropout(mp_layers.row_linear(
                h, self.fc_out.weight, self.fc_out.bias))
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate=True)))


def _norm(config, device):
    norm = pnn.RMSNorm if config.use_rmsnorm else pnn.LayerNorm
    return norm(config.hidden_size, config.layer_norm_epsilon, device=device)


class GPTBlock(nn.Module):
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        self.ln_1 = _norm(config, device)
        self.attn = GPTAttention(config, device=device, generator=generator)
        self.ln_2 = _norm(config, device)
        if config.num_experts:
            from ...incubate.moe import SwitchMoE
            self.mlp = SwitchMoE(
                config.hidden_size, config.intermediate_size,
                num_experts=config.num_experts,
                capacity_factor=config.moe_capacity_factor, device=device,
                generator=generator)
        else:
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


_MOE_REFUSAL = ('MoE blocks do not compose with recompute or pipeline '
                'parallelism yet (aux-loss routing) - disable one of them')


class StageBlocks(nn.Module):
    """The blocks one pipeline stage holds, registered under their global
    indices (so their parameters keep the whole model's names); iterates
    and counts like the ModuleList it replaces."""

    def __init__(self, blocks):
        super().__init__()
        for i, block in blocks:
            self.add_module(str(i), block)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


class GPTModel(nn.Module):
    """The decoder stack. `GPTModel(config)` or `GPTModel(**config_kwargs)`,
    as in the JAX package."""

    def __init__(self, config=None, device=None, generator=None, **kwargs):
        super().__init__()
        config = config or GPTConfig(**kwargs)
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
        self.wte.weight.placement = ('mp', None)
        self._recompute = config.recompute

    def _embed(self, input_ids):
        if mp_layers.mp_group_of(self.wte.weight) is not None:
            return mp_layers.vocab_parallel_embedding(input_ids,
                                                      self.wte.weight)
        return self.wte(input_ids)

    def enable_recompute(self, flag=True):
        """Per-block activation recompute in training: each block's
        activations are rebuilt in the backward instead of kept."""
        self._recompute = flag

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
            elif caches is None and ring_attention.SP_STATE['active']:
                # this rank's sequence shard under sequence parallelism
                from ...distributed.sp import local_positions
                position_ids = local_positions(
                    ring_attention.SP_STATE['active'], n, dev)[None, :]
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
        x = self.drop(self._embed(input_ids) + self.wpe(position_ids))
        if caches is not None:
            new_caches = []
            for block, c in zip(self.h, caches):
                x, nc = block(x, cache=c)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        from ...distributed import pipeline as pp_mod
        pp_state = pp_mod.pipeline_state()
        moe = self.config.num_experts > 0
        if moe and self.training and (pp_state is not None or
                                      self._recompute):
            raise NotImplementedError(_MOE_REFUSAL)
        if self._recompute and self.training:
            for block in self.h:
                x = _recompute(block, x)
        else:
            for block in self.h:
                x = block(x)
        # the MoE load-balancing terms for GPTForCausalLM.loss (training
        # only: an eval loss carries no balance term)
        self._moe_aux = None
        if moe and self.training:
            for block in self.h:
                term = block.mlp.aux_loss * block.mlp.aux_loss_weight
                self._moe_aux = term if self._moe_aux is None \
                    else self._moe_aux + term
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with a language-model head, tied to the token embedding unless
    config.tie_word_embeddings is False. `GPTForCausalLM(config)` or
    `GPTForCausalLM(**config_kwargs)`, as in the JAX package. Weights are
    drawn from a CPU generator seeded with `seed` and moved to `device`, so
    one seed gives one model on every device."""

    def __init__(self, config=None, device=None, seed=0, **kwargs):
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
            w = self.gpt.wte.weight
            group = mp_layers.mp_group_of(w)
            if group is not None:
                # this rank's vocabulary columns, gathered
                local = torch.matmul(mp_layers.copy_to_mp(hidden, group),
                                     mp_layers.local_of(w).t())
                return mp_layers.gather_replicated(local, local.dim() - 1,
                                                   group)
            return F.linear(hidden, w.t())
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
            w = self.gpt.wte.weight if self.lm_head is None \
                else self.lm_head.weight
            ce = F.linear_cross_entropy(logits, w, labels,
                                        transpose_weight=self.lm_head is None)
        else:
            b, n, v = logits.shape
            ce = F.cross_entropy(logits.reshape(b * n, v),
                                 labels.reshape(b * n))
        aux = getattr(self.gpt, '_moe_aux', None)
        self.gpt._moe_aux = None  # consumed once, never stale across calls
        return ce if aux is None else ce + aux

    def enable_recompute(self, flag=True):
        self.gpt.enable_recompute(flag)

    def pp_decompose(self, loss_fn=None):
        """(pre, blocks, post) for the pipeline schedules: pre(ids) = the
        embeddings (first stage), blocks = the transformer stack (the
        blocks this model holds), post(x, labels) = ln_f, the tied or
        untied head and loss_fn (self.loss by default; last stage). Under
        config.fused_loss post hands loss_fn the final hidden state, the
        non-pipelined training forward's contract. The tied wte is used
        by pre and post."""
        if self.config.num_experts:
            raise NotImplementedError(_MOE_REFUSAL)
        gpt = self.gpt
        loss_fn = loss_fn or self.loss

        def pre(ids):
            n = ids.shape[1]
            pos = torch.arange(n, device=ids.device)[None, :]
            return gpt.drop(gpt._embed(ids) + gpt.wpe(pos))

        def post(x, labels):
            h = gpt.ln_f(x)
            if self.config.fused_loss:
                return loss_fn(h, labels)
            return loss_fn(self._logits(h), labels)

        return pre, gpt.h, post

    def pp_keep_stage(self, stage, n_stages):
        """Keep only stage `stage`'s part of a pipeline of n_stages: its
        blocks (ceil(n / pp) a stage, distributed.pipeline.stage_bounds),
        the embeddings on the first stage, ln_f and the head on the last
        (the tied wte on both). Returns [(module, attribute)] of the
        weights the first and last stage share."""
        from ...distributed.pipeline import stage_bounds
        gpt = self.gpt
        lo, hi = stage_bounds(len(gpt.h), n_stages, stage)
        gpt.h = StageBlocks([(i, gpt.h[i]) for i in range(lo, hi)])
        first, last = stage == 0, stage == n_stages - 1
        tied = self.lm_head is None
        if not first:
            gpt.wpe = None
            if not (last and tied):
                gpt.wte = None
        if not last:
            gpt.ln_f = None
            self.lm_head = None
        return [(gpt.wte, 'weight')] if tied and n_stages > 1 and \
            gpt.wte is not None else []

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
                b, max_len, cache_heads(self), c.hidden_size // c.num_heads,
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


def cache_heads(model):
    """The heads a rank's KV caches hold for `model` (a GPTForCausalLM):
    config.num_heads, or num_heads / mp when its attention weights are
    sharded over 'mp' (each rank attends over its own heads)."""
    heads = model.config.num_heads
    for block in model.gpt.h:
        group = mp_layers.mp_group_of(
            getattr(block.attn.qkv_proj, 'weight', None))
        return heads if group is None else heads // group.size
    return heads


def load_paddle_tpu_state(model, arrays):
    """Fill `model` from {name: np.ndarray} as the JAX package's
    state_dict() gives it (keys like 'gpt.h.0.attn.qkv_proj.weight', and
    'lm_head.weight' for an untied head).
    Raises on a missing key, an extra key or a shape mismatch, before
    anything is copied. A parameter laid out over a device mesh (a
    DTensor) takes this rank's shard of the value. A pipeline stage's model
    (pp_keep_stage) takes its own slice of a whole model's state: the
    other stages' keys are skipped."""
    own = model.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = [] if getattr(model, '_pp_kept', None) is not None else \
        sorted(set(arrays) - set(own))
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
    from torch.distributed.tensor import DTensor, distribute_tensor
    with torch.no_grad():
        for key, target in own.items():
            if isinstance(target, DTensor):
                # a parameter laid out over a mesh (tensor or ZeRO-3
                # parallelism) takes this rank's shard of the value
                target.to_local().copy_(distribute_tensor(
                    host[key].to(target.dtype), target.device_mesh,
                    target.placements).to_local())
            else:
                target.copy_(host[key])
    return model
