"""(Counterpart of paddle_tpu/serving/scheduler.py, copied: it needs
nothing but the standard library and numpy.)

Request queue + admission/prefill policy for continuous batching.

Policy (Orca-style iteration-level scheduling, FIFO within a step):

  1. ADMIT:  while a slot is free and a request is queued, bind the
     oldest request to the lowest free slot (deterministic layout).
  2. PREFILL: every resident request still consuming its prompt advances
     by exactly ONE fixed-size chunk per step — chunking bounds the
     latency bubble a long prompt injects between decode steps, the
     reason Sarathi/vLLM interleave prefill rather than running it to
     completion on arrival.
  3. DECODE: all slots whose prompt is fully consumed take one decode
     burst together (engine-side); finished sequences retire and their
     slots return to the free list the same step.

Everything here is host-side bookkeeping with plain Python ints (plus
host numpy block tables for the paged variant) — the scheduler never
touches device arrays, so it cannot cause a retrace.
"""
import itertools
import threading
from collections import deque

import numpy as np

from .kv_cache import SCRATCH_PAGE

__all__ = ['Request', 'Scheduler', 'PagedScheduler']

_req_ids = itertools.count()

# request lifecycle states
QUEUED, PREFILL, DECODE, DONE = 'queued', 'prefill', 'decode', 'done'


class Request:
    """One generation request plus its accumulated output.

    Sampling params mirror GPTForCausalLM.generate() exactly — same
    greedy/temperature/top-k semantics, same per-request PRNG stream
    seeded from `seed` — so engine output is comparable token-for-token
    against a sequential generate() of the same prompt.
    """

    def __init__(self, prompt, max_new_tokens=32, temperature=1.0,
                 top_k=0, do_sample=False, seed=0, tenant=None,
                 priority=0, model=None):
        self.id = next(_req_ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.do_sample = bool(do_sample)
        self.seed = int(seed)
        self.tenant = tenant      # attribution dimension (opaque string)
        self.model = model        # target model name (multi-model hosts)
        self.priority = int(priority)   # higher preempts lower; FIFO ties
        self.outcome = None       # terminal outcome, set at retirement
        self.tokens = []          # generated ids (prompt NOT included)
        self.state = QUEUED
        # wide-event lifecycle fields (monitor/events.py): the engine
        # stamps the timestamps on its metrics clock; the scheduler owns
        # the KV holding window on the allocator's integral clock
        self.kv_page_seconds = 0.0
        self._arrival_t = None
        self._admit_t = None
        self._first_token_t = None
        self._finish_t = None
        self._prefill_chunks = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._kv_hold_t = None    # allocator timestamp at reservation
        self.slot = None          # bound while resident
        self._key = None          # PRNG key, set at admission
        self._consumed = 0        # prompt tokens already prefilled
        self._prefix_hit = 0      # prompt tokens served by the prefix
        #                           cache (paged engine; 0 elsewhere)
        self._published = 0       # prompt blocks already in the cache
        self._seq = None          # submission order, set by the scheduler
        self._preempts = 0        # times this request lost its KV pages
        self._replay = 0          # already-delivered tokens to swallow
        #                           while regenerating after a preemption
        self._kv_acc = 0.0        # page·seconds from closed-out holding
        #                           windows (accumulated at preemption)
        self._span = None         # 'serving.request' lifecycle span
        self._phase = None        # current prefill/decode child span
        self._finished = threading.Event()
        # engine.stream() consumers read tokens from here; None until the
        # first stream() call so non-streamed requests pay nothing
        self._stream_q = None

    @property
    def done(self):
        return self.state == DONE

    def wait(self, timeout=None):
        """Block until the request finishes (thread-safe front door)."""
        return self._finished.wait(timeout)

    def __repr__(self):
        return ('Request(id=%d, state=%s, prompt_len=%d, generated=%d/%d)'
                % (self.id, self.state, len(self.prompt), len(self.tokens),
                   self.max_new_tokens))


class Scheduler:
    """Admission + chunked-prefill planner over a SlotAllocator."""

    def __init__(self, allocator, max_len, prefill_chunk):
        if prefill_chunk < 1:
            raise ValueError('prefill_chunk must be >= 1')
        self.allocator = allocator
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.queue = deque()
        self.resident = {}        # slot -> Request (PREFILL or DECODE)
        self._submit_seq = itertools.count()

    def submit(self, req):
        """Validate capacity and enqueue. Raises on impossible requests —
        a request that can never fit must fail at the front door, not
        wedge the queue forever."""
        n0 = len(req.prompt)
        if n0 < 1:
            raise ValueError('empty prompt')
        if req.max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1')
        c = self.prefill_chunk
        padded = ((n0 + c - 1) // c) * c
        # two capacity constraints: the final sequence must fit, and the
        # PADDED last prefill chunk must land inside the buffer (a
        # clamped dynamic_update_slice would silently shift the write)
        need = max(n0 + req.max_new_tokens - 1, padded)
        if need > self.max_len:
            raise ValueError(
                'request needs %d cache rows (prompt %d + %d new tokens, '
                'prefill padding to %d) but slots hold %d'
                % (need, n0, req.max_new_tokens, padded, self.max_len))
        req._seq = next(self._submit_seq)
        self.queue.append(req)

    def _pick_index(self):
        """Index of the next request to admit: highest priority first,
        submission order (_seq) within a class — so with uniform
        priorities this is index 0, the exact historical FIFO, and a
        preempted request (which keeps its original _seq) resumes ahead
        of later arrivals of its own class."""
        best = 0
        for i in range(1, len(self.queue)):
            r, b = self.queue[i], self.queue[best]
            if (r.priority, -r._seq) > (b.priority, -b._seq):
                best = i
        return best

    def admit(self):
        """Bind queued requests to free slots; returns [(slot, req)]."""
        admitted = []
        while self.queue and self.allocator.available:
            i = self._pick_index()
            req = self.queue[i]
            del self.queue[i]
            slot = self.allocator.alloc(req.id)
            req.slot = slot
            req.state = PREFILL
            req._consumed = 0
            # holding window opens on the allocator's own advance
            # timestamp, so per-request durations sum exactly to the
            # pool-occupancy integral
            req._kv_hold_t = self.allocator.held_since(slot)
            self.resident[slot] = req
            admitted.append((slot, req))
        return admitted

    def prefill_plan(self):
        """One chunk per prefilling request: [(req, start, ids, valid,
        final)] where ids is exactly prefill_chunk tokens (zero-padded
        past `valid`) so the jitted chunk program has one shape."""
        plan = []
        c = self.prefill_chunk
        for slot in sorted(self.resident):
            req = self.resident[slot]
            if req.state != PREFILL:
                continue
            start = req._consumed
            valid = min(c, len(req.prompt) - start)
            ids = req.prompt[start:start + valid] + [0] * (c - valid)
            plan.append((req, start, ids, valid,
                         start + valid >= len(req.prompt)))
        return plan

    def mark_prefilled(self, req, consumed):
        req._consumed = consumed
        req._prefill_chunks += 1
        if req._consumed >= len(req.prompt):
            req.state = DECODE

    def decode_slots(self):
        return [s for s in sorted(self.resident)
                if self.resident[s].state == DECODE]

    def retire(self, req):
        """Release a finished request's slot and wake any waiters."""
        slot = req.slot
        del self.resident[slot]
        # one slot is the allocation granule: page·seconds == slot·seconds
        req.kv_page_seconds = self.allocator.free(slot)
        req.state = DONE
        req.slot = None
        if req._stream_q is not None:
            req._stream_q.put(None)   # stream sentinel: end of tokens
        req._finished.set()

    @property
    def pending(self):
        """Requests not yet DONE anywhere in the system."""
        return len(self.queue) + len(self.resident)


class PagedScheduler(Scheduler):
    """Page-aware admission over a PageAllocator + optional PrefixCache.

    Same FIFO iteration-level policy as Scheduler, with two additions:

    - ADMIT reserves the request's ENTIRE page need up front (prefix-hit
      blocks are shared via incref, the rest freshly allocated). Because
      every resident request already holds everything it will ever
      write, residents always run to completion — no mid-flight
      allocation failure, no deadlock. When the HEAD request cannot get
      its pages (even after evicting idle prefix-cache entries)
      admission stops for the step rather than skipping ahead: FIFO
      order is what makes waiting bounded.
    - A prefix-cache hit fast-forwards `_consumed` to the shared length,
      so prefill work is paid only for the unshared tail.
    - With `preempt_enabled` (the engine's `preempt=True`), a blocked
      head may EVICT a strictly-lower-priority resident: the victim's
      pages decref back to the pool, its slot frees, and it requeues
      with its original submission order. Its run-to-completion
      guarantee is deliberately traded away — that is the QoS deal for
      low priority. Resumption re-admits it like any queued request;
      its own published prompt blocks usually fast-forward the
      re-prefill through the prefix cache, and the engine regenerates
      the already-delivered tokens deterministically (same prompt,
      sampling, seed — the gateway-failover invariant), swallowing them
      via Request._replay so the caller-visible stream has no duplicate
      and no gap.

    Block tables live here as one host numpy array [num_slots,
    max_blocks] (int32 page ids, SCRATCH_PAGE where unmapped); the
    engine hands rows of it to the jitted programs verbatim.
    """

    def __init__(self, allocator, pages, max_len, prefill_chunk,
                 page_size, prefix_cache=None):
        super().__init__(allocator, max_len, prefill_chunk)
        if page_size < 1:
            raise ValueError('page_size must be >= 1')
        self.pages = pages
        self.page_size = int(page_size)
        self.prefix = prefix_cache
        self.num_blocks = -(-self.max_len // self.page_size)
        self.block_tables = np.full(
            (allocator.num_slots, self.num_blocks), SCRATCH_PAGE, np.int32)
        self._nblocks = {}        # slot -> mapped block count
        self.preempt_enabled = False
        self.max_preempts = None  # per-request eviction budget (None: ∞)
        # engine hook, called with (slot, req, dropped) after the pages
        # and slot are released: clears per-slot engine state; `dropped`
        # means the request burned its preemption budget and is terminal
        self.on_preempt = None
        self.preempted = 0        # evictions (monotonic, for reports)

    def submit(self, req):
        """Front-door capacity check, page-aware: the worst padded
        prefill end over any possible prefix-hit length is n0 + chunk -
        1 (a hit mid-chunk shifts the chunk grid right), and the cache
        contents at admission time are unknowable here — so validate
        against that bound, not today's cache."""
        n0 = len(req.prompt)
        if n0 < 1:
            raise ValueError('empty prompt')
        if req.max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1')
        need = max(n0 + req.max_new_tokens - 1,
                   n0 + self.prefill_chunk - 1)
        if need > self.max_len:
            raise ValueError(
                'request needs up to %d cache rows (prompt %d + %d new '
                'tokens, worst-case prefill padding) but sequences hold '
                '%d' % (need, n0, req.max_new_tokens, self.max_len))
        total = self.pages.num_pages - 1       # minus the scratch page
        if -(-need // self.page_size) > total:
            raise ValueError(
                'request needs %d pages but the pool only has %d'
                % (-(-need // self.page_size), total))
        req._seq = next(self._submit_seq)
        self.queue.append(req)

    def admit(self):
        admitted = []
        while self.queue:
            i = self._pick_index()
            req = self.queue[i]
            if not self.allocator.available:
                # every SLOT is held: a high-priority head may still
                # enter by evicting a strictly-lower-priority resident
                # (which also returns its pages); otherwise stop
                if not (self.preempt_enabled and self._preempt_for(req)):
                    break
            plan = self._reserve(req)
            if plan is None and self.preempt_enabled:
                # the head is blocked on PAGES: evict strictly-lower-
                # priority residents until it fits or none are left
                while plan is None and self._preempt_for(req):
                    plan = self._reserve(req)
            if plan is None:
                break                          # head blocked => stop: FIFO
            del self.queue[i]
            pages, hit_len = plan
            # the request's page-holding window opens here (shared
            # prefix pages were increfed inside _reserve moments ago)
            req._kv_hold_t = self.pages.touch()
            slot = self.allocator.alloc(req.id)
            row = self.block_tables[slot]
            row[:] = SCRATCH_PAGE
            row[:len(pages)] = pages
            self._nblocks[slot] = len(pages)
            req.slot = slot
            req.state = PREFILL
            req._consumed = hit_len            # shared prefix: already
            req._prefix_hit = hit_len          # prefilled, skip it
            req._published = hit_len // self.page_size
            self.resident[slot] = req
            admitted.append((slot, req))
        return admitted

    def _reserve(self, req):
        """All pages for `req` up front: [pages], hit_len — or None when
        the pool cannot cover it this step."""
        P, c, n0 = self.page_size, self.prefill_chunk, len(req.prompt)
        # (`is not None`, not truthiness — an empty PrefixCache has
        # __len__ 0 and still must count its misses)
        hit_pages = (self.prefix.match(req.prompt)
                     if self.prefix is not None else [])
        # hold the hits BEFORE any eviction: a matched page at cache-
        # refcount 1 must not be evicted out from under this reservation
        for p in hit_pages:
            self.pages.incref(p)
        hit_len = len(hit_pages) * P
        need = max(n0 + req.max_new_tokens - 1,
                   hit_len + -(-(n0 - hit_len) // c) * c)
        want = -(-need // P) - len(hit_pages)
        short = want - self.pages.available
        if short > 0 and self.prefix is not None:
            self.prefix.evict(short)
        if want > self.pages.available:
            for p in hit_pages:
                self.pages.decref(p)
            return None
        return hit_pages + [self.pages.alloc() for _ in range(want)], \
            hit_len

    def _preempt_for(self, req):
        """Evict ONE resident strictly below req's priority; False when
        none exists. Victim choice: lowest priority first, and within a
        class the most recently admitted (largest holding-window start)
        — the resident with the least sunk work."""
        victim = None
        for r in self.resident.values():
            if r.priority >= req.priority:
                continue
            if victim is None or \
                    (r.priority, -(r._kv_hold_t or 0.0)) < \
                    (victim.priority, -(victim._kv_hold_t or 0.0)):
                victim = r
        if victim is None:
            return False
        self.preempt(victim)
        return True

    def preempt(self, req):
        """Evict a resident request: close its page·seconds billing
        window, decref every mapped page back to the pool (its own
        published prompt blocks survive under the prefix cache's ref —
        the fast-forward on resume), free the slot, and requeue it with
        its original submission order — or, past `max_preempts`, finish
        it terminally (the engine hook emits outcome='preempted').
        Returns True when requeued, False when dropped."""
        slot = req.slot
        row = self.block_tables[slot]
        nblocks = self._nblocks.pop(slot, 0)
        now = self.pages.touch()
        held = (now - req._kv_hold_t) if req._kv_hold_t is not None \
            else 0.0
        req._kv_acc += nblocks * held
        for b in range(nblocks):
            if row[b] != SCRATCH_PAGE:
                self.pages.decref(int(row[b]))
        row[:] = SCRATCH_PAGE
        del self.resident[slot]
        self.allocator.free(slot)
        req.slot = None
        req._kv_hold_t = None
        req._preempts += 1
        self.preempted += 1
        dropped = self.max_preempts is not None and \
            req._preempts > self.max_preempts
        if dropped:
            req.kv_page_seconds = req._kv_acc
            req.state = DONE
        else:
            # regeneration restarts from the prompt; the ledger
            # (req.tokens) is what the caller already saw, so exactly
            # that many regenerated tokens get swallowed on resume
            req.state = QUEUED
            req._consumed = 0
            req._prefix_hit = 0
            req._published = 0
            req._replay = len(req.tokens)
            self.queue.append(req)
        if self.on_preempt is not None:
            self.on_preempt(slot, req, dropped)
        if dropped:
            if req._stream_q is not None:
                req._stream_q.put(None)
            req._finished.set()
        return not dropped

    def mark_prefilled(self, req, consumed):
        super().mark_prefilled(req, consumed)
        if self.prefix is None:
            return
        # publish every prompt block this chunk completed: its page now
        # holds final, immutable K/V that any later request may share
        P = self.page_size
        row = self.block_tables[req.slot]
        done = min(consumed, len(req.prompt)) // P
        for b in range(req._published, done):
            self.prefix.publish(req.prompt, b, int(row[b]))
        req._published = max(req._published, done)

    def retire(self, req):
        slot = req.slot
        row = self.block_tables[slot]
        nblocks = self._nblocks.pop(slot, 0)
        now = self.pages.touch()
        held = (now - req._kv_hold_t) if req._kv_hold_t is not None \
            else 0.0
        for b in range(nblocks):
            if row[b] != SCRATCH_PAGE:
                self.pages.decref(int(row[b]))
        row[:] = SCRATCH_PAGE
        super().retire(req)
        # super() set the SLOT holding time; this engine bills PAGES:
        # every reserved page, shared prefix hits included (the tenant
        # pinned them for its whole residency even if another tenant
        # also mapped them — see PageAllocator._advance for why the
        # per-request sum can exceed the pool integral under sharing).
        # _kv_acc carries windows closed out by earlier preemptions.
        req.kv_page_seconds = req._kv_acc + nblocks * held
