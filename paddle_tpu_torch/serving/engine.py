"""Continuous-batching engine (counterpart of paddle_tpu/serving/engine.py):
a thread-safe front door over a GPTForCausalLM and two kinds of step.

  prefill chunk  - [1, C] prompt tokens into ONE slot's rows, written in
                   place through a view of that slot's buffers;
  decode burst   - `decode_block` cached decode steps for ALL slots, the
                   tokens read back once per burst. Which slots step in
                   each of the burst's steps is known on the host (a slot
                   that steps emits exactly one token), so finished or
                   still-prefilling slots are frozen without reading
                   anything back: their lengths, generation counts and
                   generators do not advance and their fed token repeats.

The JAX package compiles each kind of step once; PyTorch runs them
eagerly. Slot lengths, budgets and counts live on the host as numpy and
reach the card as one small copy a burst (and one a prefill chunk).

Correctness relies on the GPTSlotCache invariants (text/models/gpt.py):
rows at or beyond a slot's length are unreachable garbage, attention
writes at the pre-step offsets and the ENGINE advances lengths: a prefill
chunk to `start + valid` (padding rows stay invalid), a decode step by
one for each slot that stepped.

Greedy output is token-identical to sequential generate(): the masked
slot attention gives exact zeros to invalid rows (scores at -1e9 underflow
to 0.0 in the f32 softmax). Sampling follows generate()'s stream: each
request has its own torch.Generator seeded from its seed, drawn once by
the final prefill chunk and once per decode step it takes.

`_EngineBase` holds what is not about the cache layout (the front door,
scheduler glue, metrics, shutdown), shared with the paged engine
(serving/paged_engine.py).

Not ported, each raising NotImplementedError: `trace_counts`,
`compiled_sizes()` and the compile watchdog (eager PyTorch compiles
nothing; their counterpart comes with a CUDA-graph decode step) and
`perf_estimate()` (it reads XLA's cost analysis).
"""
import queue as _queue
import threading

import numpy as np
import torch

from ..monitor import events as _events
from ..monitor import tracing as _tracing
from ..monitor.perf import StepTimeline
from ..text.models.gpt import GPTSlotCache, SharedIndex
from .kv_cache import SlotAllocator, build_slot_caches
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler

__all__ = ['ContinuousBatchingEngine']


def _kv_row_bytes(model):
    """Bytes one KV-cache row (all layers, K+V) costs for `model`: the
    conversion factor between page·seconds and byte·seconds for per-tenant
    billing."""
    config = model.config
    head_dim = config.hidden_size // config.num_heads
    itemsize = model.gpt.wte.weight.element_size()
    return 2 * len(model.gpt.h) * config.num_heads * head_dim * itemsize


def _pick_token(lg, gen, temp, topk, sample):
    """Next token for ONE row of logits [V]: generate()'s pick. Greedy
    argmax, or a draw from softmax(lg / temp) restricted to the top_k
    (0 = the whole vocabulary) from `gen`. A 0-d tensor on lg's device."""
    lg = lg.float()
    if not sample:
        return lg.argmax(dim=-1)
    lt = lg / max(float(temp), 1e-6)
    if topk:
        v = lt.shape[-1]
        kth = lt.sort(dim=-1).values[max(v - int(topk), 0)]
        lt = torch.where(lt >= kth, lt, -1e30)
    return torch.multinomial(torch.softmax(lt, dim=-1), 1,
                             generator=gen)[0]


class _EngineBase:
    """Cache-layout-agnostic half of a continuous-batching engine.

    Front door (`add_request` / `step` / `run` / `stream` / `generate`) is
    thread-safe: any number of threads may submit and drive; an RLock
    serializes scheduler state and device work while `Request.wait` and
    stream consumption stay lock-free. Subclasses set `self.allocator` /
    `self.scheduler` and implement `_prefill_step` / `_decode_step` (and
    may hook `_bind` / `_on_step_metrics`).
    """

    def __init__(self, model, num_slots, max_len):
        model.eval()
        self._model = model
        self._device = model.gpt.wte.weight.device
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or model.config.max_position_embeddings)
        self.metrics = ServingMetrics()
        # per-slot control state lives on the host as numpy: admission and
        # retirement mutate it in place, and a burst hands the card one
        # copy of what it needs
        s = self.num_slots
        self._last = np.zeros((s, 1), np.int64)       # token fed next step
        self._gen = np.zeros((s,), np.int64)          # tokens generated
        self._budgets = np.zeros((s,), np.int64)      # max_new_tokens
        self._active = np.zeros((s,), bool)           # slot decodes?
        self._lens = np.zeros((s,), np.int64)         # rows written
        self._temps = np.ones((s,), np.float32)
        self._topks = np.zeros((s,), np.int64)
        self._sample = np.zeros((s,), bool)
        self._requests = {}                           # slot -> Request
        self._lock = threading.RLock()
        self._closed = False
        # cached at construction (like the registry): swap the default
        # tracer BEFORE building the engine under test
        self._tracer = _tracing.default_tracer()
        # wide-event request log, same caching rule; subclasses set the
        # page->bytes factor once their cache layout is known
        self.events = _events.default_request_log()
        self._kv_page_bytes = 0
        # splits each decode burst into host dispatch (the Python loop
        # that enqueues the burst's kernels) and the wait for its tokens
        self.timeline = StepTimeline(registry=self.metrics.registry,
                                     tracer=self._tracer)

    # ---- front door ---------------------------------------------------

    def add_request(self, prompt, max_new_tokens=32, temperature=1.0,
                    top_k=0, do_sample=False, seed=0, stream=False,
                    tenant=None, priority=0, model=None, emit_event=True):
        """Queue a generation request; returns the Request handle.

        `tenant` and `model` are attribution dimensions (metrics and the
        wide event); `priority` (int, higher wins) orders admission and,
        on the paged engine with preempt=True, marks lower-priority
        residents evictable. `emit_event=False` suppresses this engine's
        wide event."""
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k,
                      do_sample=do_sample, seed=seed, tenant=tenant,
                      priority=priority, model=model)
        req._emit_event = bool(emit_event)
        if stream:
            req._stream_q = _queue.Queue()
        return self.enqueue(req)

    def enqueue(self, req):
        """Admit a pre-built scheduler.Request through the front door
        (validation, metrics and tracing of add_request happen here)."""
        req._emit_event = getattr(req, '_emit_event', True)
        req._tenant_label = self.metrics.tenant_label(req.tenant)
        req._model_label = self.metrics.model_label(
            getattr(req, 'model', None))
        # a request whose worst case (prompt plus every generated token
        # but the last) cannot fit the cache would sit at the queue head
        # forever, wedging admission for everyone behind it
        worst = len(req.prompt) + req.max_new_tokens - 1
        if len(req.prompt) and worst > self.max_len:
            raise ValueError(
                'request cannot ever be admitted: prompt of %d tokens + '
                'max_new_tokens=%d needs %d cache rows but max_len=%d'
                % (len(req.prompt), req.max_new_tokens, worst,
                   self.max_len))
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    'engine is shut down — it no longer admits requests')
            self._validate(req)
            self.scheduler.submit(req)
            t = self.metrics.now()
            if req._arrival_t is None:
                req._arrival_t = t
            self.metrics.on_arrival(req.id, req._arrival_t)
            tr = self._tracer
            if tr.enabled:
                tags = {'request_id': req.id,
                        'prompt_len': len(req.prompt),
                        'max_new_tokens': req.max_new_tokens}
                if req.tenant is not None:
                    tags['tenant'] = req._tenant_label
                if getattr(req, 'model', None) is not None:
                    tags['model'] = req._model_label
                req._span = tr.start_span('serving.request', tags=tags,
                                          root=True)
                req._span.add_event('queued',
                                    queue_depth=len(self.scheduler.queue))
        return req

    def _validate(self, req):
        """Subclass hook: extra front-door checks (lock held)."""

    def shutdown(self):
        """Refuse all future add_request calls. In-flight requests may
        still be driven to completion with step()/run(); shutdown only
        closes the front door."""
        with self._lock:
            self._closed = True

    def step(self):
        """One scheduler iteration: admit -> prefill chunks -> decode
        burst -> retire. Returns the number of requests still pending."""
        with self._lock, torch.no_grad():
            self._admit()
            self._prefill_step()
            self._decode_step()
            self.metrics.on_step(self.allocator.in_use, self.num_slots)
            self.metrics.on_queue_depth(len(self.scheduler.queue))
            self._on_step_metrics()
            return self.scheduler.pending

    def run(self):
        """Drive until every submitted request has finished."""
        while True:
            with self._lock:
                if not self.scheduler.pending:
                    return
                self.step()

    def generate(self, prompts, **sampling):
        """Blocking batch door: submit all, drive to completion, return
        generated ids per prompt (prompt not included) in order."""
        reqs = [self.add_request(p, **sampling) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]

    def stream(self, req):
        """Yield req's tokens as they are produced. Cooperative: if no
        other thread is driving the engine, this one steps it."""
        q = req._stream_q
        if q is None:
            raise ValueError('request was not added with stream=True')
        while True:
            try:
                tok = q.get_nowait()
            except _queue.Empty:
                if req.done:
                    return         # sentinel already consumed
                self.step()
                continue
            if tok is None:
                return
            yield tok

    @property
    def trace_counts(self):
        raise NotImplementedError(
            'trace_counts is not ported: the eager engine traces and '
            'compiles no program (its counterpart comes with a CUDA-graph '
            'decode step)')

    def compiled_sizes(self):
        raise NotImplementedError(
            'compiled_sizes() is not ported: the eager engine compiles no '
            'program (its counterpart comes with a CUDA-graph decode step)')

    @property
    def perf(self):
        raise NotImplementedError(
            'the CompileWatchdog (engine.perf) is not ported: the eager '
            'engine compiles nothing to watch')

    def perf_estimate(self, bursts=None, wall_seconds=None):
        raise NotImplementedError(
            'perf_estimate() is not ported: it reads the cost analysis of '
            'a compiled XLA program (monitor/perf/costmodel.py)')

    @property
    def occupancy(self):
        return self.allocator.occupancy

    # ---- scheduler glue (lock held) -----------------------------------

    def _admit(self):
        for slot, req in self.scheduler.admit():
            req._admit_t = self.metrics.now()
            self.metrics.on_admitted(req.id)
            if req._preempts:
                # a previously preempted request coming back: the
                # regenerated prefix is swallowed via req._replay, so
                # the caller-visible stream resumes where it stopped
                self.metrics.on_resumed(req._tenant_label)
                if req._span is not None:
                    req._span.add_event('resumed', preempts=req._preempts)
            if req._span is not None:
                req._span.add_event('admitted', slot=slot)
                req._phase = self._tracer.start_span(
                    'serving.prefill', parent=req._span,
                    tags={'slot': slot})
            self._requests[slot] = req
            self._budgets[slot] = req.max_new_tokens
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            self._sample[slot] = req.do_sample
            # generate()'s stream: a generator seeded with the request's
            # seed, first drawn by the final prefill chunk (made anew on a
            # re-admission, so a preempted request regenerates the same
            # tokens)
            req._key = torch.Generator(device=self._device).manual_seed(
                req.seed)
            # no cache reset needed: the first prefill chunk writes from
            # the occupant's own offset and its length unreaches the
            # previous occupant's rows
            self._lens[slot] = req._consumed
            self._bind(slot, req)

    def _bind(self, slot, req):
        """Subclass hook: extra per-admission state (lock held)."""

    def _on_step_metrics(self):
        """Subclass hook: extra per-step gauges (lock held)."""

    def _trace_prefill(self, req, start, valid, final):
        """Annotate the request's prefill phase span with one chunk; the
        final chunk closes it and opens the decode phase (lock held)."""
        if req._phase is None:
            return
        req._phase.add_event('prefill_chunk', start=start, valid=valid)
        if final:
            req._phase.finish()
            req._phase = self._tracer.start_span(
                'serving.decode', parent=req._span,
                tags={'slot': req.slot})

    def _prefill_chunk(self, req, start, ids, valid):
        """Forward one [1, C] chunk of `req` at row `start`; returns the
        hidden state of its last valid token [1, hidden]."""
        raise NotImplementedError

    def _prefill_step(self):
        """One chunk per prefilling request; the picks of the requests
        whose prompt this step finished are read back together."""
        finals = []
        for req, start, ids, valid, final in self.scheduler.prefill_plan():
            last = self._prefill_chunk(req, start, ids, valid)
            self.metrics.on_prefill_tokens(valid)
            self._lens[req.slot] = start + valid
            self.scheduler.mark_prefilled(req, start + valid)
            self._trace_prefill(req, start, valid, final)
            if final:
                # only the final chunk picks (and draws from the request's
                # generator)
                finals.append((req, self._pick_final(req, last)))
        if not finals:
            return
        toks = torch.stack([t for _, t in finals]).cpu().tolist()
        for (req, _), tok in zip(finals, toks):
            slot = req.slot
            self._last[slot, 0] = tok
            self._gen[slot] = 1
            self._active[slot] = True
            self._emit(req, [tok])
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(req)

    def _pick_final(self, req, hidden_row):
        """The pick after a final prefill chunk, from the hidden state of
        its last valid token [1, hidden]."""
        lg = self._model._logits(hidden_row)[0]
        return _pick_token(lg, req._key, req.temperature, req.top_k,
                           req.do_sample)

    def _burst_plan(self):
        """Which slots step in each of the burst's steps, and each slot's
        length at each step: [K, S] bool and int64, from host state alone
        (a slot that steps emits one token). Returns (steps, lens, gen
        after the burst, lens after the burst)."""
        k = self.decode_block
        steps = np.zeros((k, self.num_slots), bool)
        lens = np.zeros((k, self.num_slots), np.int64)
        gen, cur = self._gen.copy(), self._lens.copy()
        for i in range(k):
            st = self._active & (gen < self._budgets)
            steps[i], lens[i] = st, cur
            gen += st
            cur += st
        return steps, lens, gen, cur

    def _pick_rows(self, lg, stepping):
        """Next tokens for every slot from logits [S, V]: the greedy pick,
        replaced for each stepping sampled slot by a draw from its own
        generator (the other slots' generators are not touched)."""
        nxt = lg.float().argmax(dim=-1)
        for slot in np.flatnonzero(stepping & self._sample):
            nxt[slot] = _pick_token(lg[slot], self._requests[slot]._key,
                                    self._temps[slot], self._topks[slot],
                                    True)
        return nxt

    def _burst(self, slots, forward):
        """Run a decode burst: `forward(tok [S, 1], lens [S] on the card)`
        returns the hidden states of one step. Reads the tokens back once,
        then emits and retires on the host."""
        steps, lens, gen, cur = self._burst_plan()
        with self._tracer.start_span('serving.decode_burst',
                                     tags={'rows': len(slots),
                                           'block': self.decode_block}):
            with self.timeline.phase('host_dispatch'):
                plan = torch.from_numpy(np.stack(
                    [lens, steps.astype(np.int64)])).to(self._device)
                tok = torch.from_numpy(self._last[:, 0]).to(self._device)
                out = []
                for i in range(self.decode_block):
                    hidden = forward(tok[:, None], plan[0, i])
                    lg = self._model._logits(hidden[:, -1])
                    nxt = self._pick_rows(lg, steps[i])
                    tok = torch.where(plan[1, i].bool(), nxt, tok)
                    out.append(tok)
                toks = torch.stack(out)
            with self.timeline.phase('device_block'):
                toks = toks.cpu().numpy()
        self.timeline.end_step()
        self._gen, self._lens = gen, cur
        self._last[:, 0] = toks[-1]
        for slot in slots:
            req = self._requests[slot]
            new = [int(toks[i, slot]) for i in range(toks.shape[0])
                   if steps[i, slot]]
            self._emit(req, new)
            if len(req.tokens) >= req.max_new_tokens:
                self._retire(req)

    def _emit(self, req, tokens):
        if req._replay:
            # post-preemption regeneration: the first _replay tokens were
            # already delivered before the eviction; determinism (same
            # prompt, sampling, seed) makes the regenerated ones identical,
            # so swallow them
            drop = min(req._replay, len(tokens))
            req._replay -= drop
            tokens = tokens[drop:]
        if not tokens:
            return
        req.tokens.extend(tokens)
        if req._stream_q is not None:
            for t in tokens:
                req._stream_q.put(t)
        if req._first_token_t is None:
            req._first_token_t = self.metrics.now()
            if req._arrival_t is not None:
                self.metrics.on_tenant_ttft(
                    req._tenant_label, req._first_token_t - req._arrival_t)
        self.metrics.on_tenant_tokens(req._tenant_label, len(tokens))
        self.metrics.on_tokens(
            req.id, len(tokens),
            trace_id=None if req._span is None else req._span.trace_id)

    def _retire(self, req, outcome='ok'):
        req.outcome = outcome
        slot = req.slot
        self._active[slot] = False
        del self._requests[slot]
        self.scheduler.retire(req)     # sets req.kv_page_seconds
        req._finish_t = self.metrics.now()
        self.metrics.on_retired(req.id)
        self.metrics.on_tenant_retired(
            req._tenant_label, req.kv_page_seconds * self._kv_page_bytes)
        if req._phase is not None:
            req._phase.finish()
            req._phase = None
        if req._span is not None:
            req._span.set_tag('tokens', len(req.tokens))
            req._span.add_event('retired')
            req._span.finish()
        self._emit_wide_event(req, outcome)

    def _emit_wide_event(self, req, outcome):
        """The canonical per-request record (monitor/events.py)."""
        log = self.events
        if not log.enabled or not req._emit_event:
            return
        wait = (req._admit_t - req._arrival_t) \
            if req._admit_t is not None and req._arrival_t is not None \
            else None
        log.emit(
            request_id=req.id,
            tenant=req._tenant_label,
            model=getattr(req, '_model_label', None),
            priority=req.priority,
            trace_id=None if req._span is None else req._span.trace_id,
            arrival_t=req._arrival_t,
            admit_t=req._admit_t,
            first_token_t=req._first_token_t,
            finish_t=req._finish_t,
            queue_wait_s=wait,
            prefill_chunks=req._prefill_chunks,
            prompt_tokens=len(req.prompt),
            output_tokens=len(req.tokens),
            prefix_hit_tokens=req._prefix_hit,
            spec_proposed=req._spec_proposed,
            spec_accepted=req._spec_accepted,
            kv_page_seconds=req.kv_page_seconds,
            failovers=0,
            replicas=[],
            outcome=outcome)


class ContinuousBatchingEngine(_EngineBase):
    """Slot-based continuous batching over a GPTForCausalLM.

    Every slot reserves `max_len` KV rows (GPTSlotCache); see
    PagedContinuousBatchingEngine for the page-granular variant with
    prefix sharing and speculative decoding.
    """

    def __init__(self, model, num_slots=8, max_len=None, prefill_chunk=16,
                 decode_block=4):
        super().__init__(model, num_slots, max_len)
        self.decode_block = int(decode_block)
        if self.decode_block < 1:
            raise ValueError('decode_block must be >= 1')
        self._caches = build_slot_caches(model, self.num_slots, self.max_len)
        self.allocator = SlotAllocator(self.num_slots)
        self.scheduler = Scheduler(self.allocator, self.max_len,
                                   prefill_chunk)
        # billing unit for kv_byte_seconds: a slot reserves max_len rows
        self._kv_page_bytes = _kv_row_bytes(model) * self.max_len

    def _prefill_chunk(self, req, start, ids, valid):
        """The chunk through a one-slot view of every layer's buffers: the
        writes land in the slot's rows in place, nothing is copied back."""
        slot = req.slot
        dev = self._device
        t = torch.tensor([start], device=dev)
        index = SharedIndex()
        caches = [GPTSlotCache(c.kt[slot:slot + 1], c.vt[slot:slot + 1], t,
                               index) for c in self._caches]
        hidden, _ = self._model.gpt(
            torch.tensor([ids], device=dev), caches=caches)
        return hidden[:, valid - 1]

    def _decode_step(self):
        slots = self.scheduler.decode_slots()
        if not slots:
            return

        def forward(tok, lens):
            index = SharedIndex()
            caches = [GPTSlotCache(c.kt, c.vt, lens, index)
                      for c in self._caches]
            return self._model.gpt(tok, caches=caches)[0]

        self._burst(slots, forward)
