"""Paged continuous batching (counterpart of
paddle_tpu/serving/paged_engine.py): block-granular KV, prefix reuse and
speculative decoding over the slot engine's front door.

The slot engine (engine.py) reserves `max_len` KV rows per slot, so
memory density scales with the WORST-CASE sequence and identical system
prompts re-prefill on every request. This engine keeps one physical pool
of fixed-size pages per layer and maps sequences onto it through host
numpy block tables (vLLM's PagedAttention layout):

  - a sequence holds only the pages its actual length needs (reserved
    up front at admission: residents can never fail mid-flight);
  - requests sharing a prompt prefix map their leading block-table
    entries to the SAME already-filled pages (PrefixCache, chain-hashed
    full blocks) and skip that part of prefill entirely;
  - optionally, an n-gram proposer drafts K tokens per decode step and
    ONE batched verify forward accepts the longest prefix matching the
    model's own greedy picks: up to K+1 tokens per forward, output
    token-identical to sequential generate() by construction (every
    accepted token equals the greedy pick the model would have made).

Three kinds of step: a prefill chunk ([1, C] prompt tokens through one
sequence's block-table row), a decode burst (K cached steps for ALL
sequences, spec off) and a verify pass ([S, K+1] draft tokens for ALL
sequences, spec on). Only the page pools live on the card; block tables
and lengths are host numpy, copied over once a burst.
"""
import numpy as np
import torch

from ..text.models.gpt import GPTPagedCache, SharedIndex
from .engine import _EngineBase, _kv_row_bytes
from .kv_cache import (PageAllocator, PrefixCache, SlotAllocator,
                       build_paged_pools)
from .scheduler import PagedScheduler

__all__ = ['PagedContinuousBatchingEngine', 'NGramProposer']


class NGramProposer:
    """Prompt-lookup drafting: find the most recent earlier occurrence
    of the sequence's trailing n-gram and propose whatever followed it.

    Free (no draft model, no device work) and surprisingly effective on
    serving traffic, where outputs quote their prompts — exactly the
    regime prefix sharing also targets. Wrong drafts cost only their
    share of one verify pass; the accept rule keeps output exact.
    """

    def __init__(self, n=2):
        if n < 1:
            raise ValueError('n-gram size must be >= 1')
        self.n = int(n)

    def propose(self, history, k):
        """k draft ids continuing `history` (prompt + generated so far).
        Falls back to repeating the last token when the n-gram has no
        earlier occurrence — a cheap guess beats proposing nothing,
        since the verify pass runs at [S, K+1] either way."""
        n = min(self.n, len(history) - 1)
        draft = []
        if n > 0:
            tail = history[-n:]
            for i in range(len(history) - n - 1, -1, -1):
                if history[i:i + n] == tail:
                    draft = list(history[i + n:i + n + k])
                    break
        last = history[-1]
        while len(draft) < k:
            draft.append(draft[-1] if draft else last)
        return draft[:k]


class PagedContinuousBatchingEngine(_EngineBase):
    """Page-granular continuous batching over a GPTForCausalLM.

    Same front door and scheduling policy as ContinuousBatchingEngine;
    differs in the KV layout (page pool + block tables), prefix-cache
    admission, and the optional speculative decode path. `spec_k > 0`
    replaces the decode burst with draft-and-verify and is greedy-only:
    sampled requests are rejected at add_request, because the accept
    rule compares drafts against argmax picks.
    """

    def __init__(self, model, num_seqs=8, max_len=None, page_size=16,
                 num_pages=None, prefill_chunk=16, decode_block=4,
                 spec_k=0, ngram=2, prefix_cache=True, preempt=False,
                 max_preempts=None):
        super().__init__(model, num_seqs, max_len)
        if self.max_len > model.config.max_position_embeddings:
            raise ValueError(
                'max_len %d exceeds max_position_embeddings %d'
                % (self.max_len, model.config.max_position_embeddings))
        self.page_size = int(page_size)
        self.num_blocks = -(-self.max_len // self.page_size)
        if num_pages is None:
            # parity default: enough for every sequence at max_len plus
            # scratch — same footprint as the slot engine. Real
            # deployments size the pool to ACTUAL length distributions
            # (the density win); the scheduler's up-front reservation
            # keeps a small pool safe, just slower to admit.
            num_pages = self.num_slots * self.num_blocks + 1
        self.num_pages = int(num_pages)
        self.decode_block = int(decode_block)
        if self.decode_block < 1:
            raise ValueError('decode_block must be >= 1')
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError('spec_k must be >= 0')
        self._proposer = NGramProposer(ngram) if self.spec_k else None
        self._pools = build_paged_pools(model, self.num_pages,
                                        self.page_size)
        self.pages = PageAllocator(self.num_pages)
        self.prefix = (PrefixCache(self.page_size, self.pages)
                       if prefix_cache else None)
        self.allocator = SlotAllocator(self.num_slots)
        self.scheduler = PagedScheduler(self.allocator, self.pages,
                                        self.max_len, prefill_chunk,
                                        self.page_size, self.prefix)
        # priority preemption: a page-blocked high-priority arrival may
        # evict strictly-lower-priority residents (scheduler policy);
        # this engine's hook clears the freed lane and accounts the
        # eviction. max_preempts bounds how often one request may lose
        # its pages before it is finished terminally (outcome
        # 'preempted') instead of requeued.
        self.scheduler.preempt_enabled = bool(preempt)
        self.scheduler.max_preempts = (None if max_preempts is None
                                       else int(max_preempts))
        self.scheduler.on_preempt = self._on_preempt
        # billing unit for kv_byte_seconds: one physical page
        self._kv_page_bytes = _kv_row_bytes(model) * self.page_size
        # the base class's _lens is each row's KV length (rows written);
        # mid-prefill rows track consumed so garbage writes from frozen
        # lanes land on rows the next real pass overwrites anyway
        self._prefix_seen = [0, 0]    # hit/miss totals already reported

    @property
    def num_seqs(self):
        return self.num_slots

    def _validate(self, req):
        if self.spec_k and req.do_sample:
            raise ValueError(
                'speculative decoding (spec_k=%d) is greedy-only: the '
                'accept rule compares drafts against argmax picks. '
                'Submit with do_sample=False or run spec_k=0.'
                % self.spec_k)

    def _bind(self, slot, req):
        # a prefix hit means rows [0, hit) are already valid shared
        # pages: the row's length starts there, not at zero (the base
        # class set _lens[slot] = req._consumed)
        if req._prefix_hit and req._span is not None:
            req._span.add_event('prefix_cache_hit',
                                tokens=req._prefix_hit)

    def _on_step_metrics(self):
        self.metrics.on_pages_in_use(self.pages.in_use)
        if self.prefix is not None:
            h, m = self.prefix.hits, self.prefix.misses
            self.metrics.on_prefix_lookup(h - self._prefix_seen[0],
                                          m - self._prefix_seen[1])
            self._prefix_seen = [h, m]

    def _retire(self, req, outcome='ok'):
        slot = req.slot
        super()._retire(req, outcome)
        self._lens[slot] = 0

    def _on_preempt(self, slot, req, dropped):
        """PagedScheduler eviction hook (lock held): the victim's pages
        and slot are already released — freeze the lane so the next
        decode burst cannot advance it (the freed pages may belong to
        someone else by then) and close the victim's phase span. A
        `dropped` victim burned its preemption budget: retire it here
        with outcome='preempted' (the scheduler already closed its
        billing window and sets the finished flag after this returns)."""
        self._active[slot] = False
        self._lens[slot] = 0
        self._requests.pop(slot, None)
        self.metrics.on_preempted(req._tenant_label)
        if req._phase is not None:
            req._phase.finish()
            req._phase = None
        if req._span is not None:
            req._span.add_event('preempted', count=req._preempts,
                                dropped=dropped)
        if not dropped:
            return
        req.outcome = 'preempted'
        req._finish_t = self.metrics.now()
        self.metrics.on_retired(req.id)
        self.metrics.on_tenant_retired(
            req._tenant_label, req.kv_page_seconds * self._kv_page_bytes)
        if req._span is not None:
            req._span.set_tag('tokens', len(req.tokens))
            req._span.add_event('retired')
            req._span.finish()
        self._emit_wide_event(req, 'preempted')

    # ---- device work (lock held) --------------------------------------

    def _caches(self, bt, lens):
        index = SharedIndex()
        return [GPTPagedCache(k, v, bt, lens, index)
                for k, v in self._pools]

    def _block_tables(self, rows=slice(None)):
        return torch.from_numpy(
            self.scheduler.block_tables[rows].astype(np.int64)).to(
                self._device)

    def _prefill_chunk(self, req, start, ids, valid):
        """One [1, C] prompt chunk through block-table row `slot` at offset
        `start`; padded-tail writes are garbage the next pass overwrites."""
        slot = req.slot
        dev = self._device
        caches = self._caches(self._block_tables(slice(slot, slot + 1)),
                              torch.tensor([start], device=dev))
        hidden, _ = self._model.gpt(torch.tensor([ids], device=dev),
                                    caches=caches)
        return hidden[:, valid - 1]

    def _decode_step(self):
        slots = self.scheduler.decode_slots()
        if not slots:
            return
        if self.spec_k:
            return self._spec_step(slots)
        # block tables do not change within a burst: one copy for all of
        # its steps
        bt = self._block_tables()

        def forward(tok, lens):
            return self._model.gpt(tok, caches=self._caches(bt, lens))[0]

        self._burst(slots, forward)

    def _spec_step(self, slots):
        """Draft K tokens per decoding row, verify all rows in ONE
        [S, K+1] forward, accept each row's longest draft prefix that
        matches the model's own greedy picks, plus the pick after it
        (the 'bonus' token: free, since the verify forward already
        computed it). Worst case (0 accepted) this emits 1 token per
        row, exactly a decode step; best case K+1. Writes land at
        lens..lens+K; rows past what acceptance advances are garbage the
        next pass overwrites (or scratch-mapped, past the reservation)."""
        K = self.spec_k
        toks = np.zeros((self.num_slots, K + 1), np.int64)
        drafts = {}
        for slot in slots:
            req = self._requests[slot]
            d = self._proposer.propose(req.prompt + req.tokens, K)
            drafts[slot] = d
            toks[slot, 0] = self._last[slot, 0]
            toks[slot, 1:] = d
        dev = self._device
        with self._tracer.start_span('serving.decode_burst',
                                     tags={'rows': len(slots),
                                           'spec_k': K}):
            with self.timeline.phase('host_dispatch'):
                caches = self._caches(self._block_tables(),
                                      torch.from_numpy(self._lens).to(dev))
                hidden, _ = self._model.gpt(torch.from_numpy(toks).to(dev),
                                            caches=caches)
                picks = self._model._logits(hidden).float().argmax(dim=-1)
            with self.timeline.phase('device_block'):
                picks = picks.cpu().numpy()
        self.timeline.end_step()
        for slot in slots:
            req = self._requests[slot]
            d, g = drafts[slot], picks[slot]
            a = 0
            while a < K and d[a] == int(g[a]):
                a += 1
            # accepted drafts + the bonus pick, clipped to budget; a
            # decoding row always has budget left (it would have retired
            # otherwise), so at least one token emits and lens advances
            left = int(self._budgets[slot]) - int(self._gen[slot])
            emit = [int(x) for x in g[:min(a + 1, left)]]
            self.metrics.on_spec(K, max(len(emit) - 1, 0))
            req._spec_proposed += K
            req._spec_accepted += max(len(emit) - 1, 0)
            if req._span is not None:
                req._span.add_event('spec_accept', proposed=K,
                                    accepted=max(len(emit) - 1, 0))
            self._lens[slot] += len(emit)
            self._gen[slot] += len(emit)
            self._last[slot, 0] = emit[-1]
            self._emit(req, emit)
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(req)
