"""Slot and page bookkeeping for the serving KV caches (counterpart of
paddle_tpu/serving/kv_cache.py: the allocators and the prefix cache are
pure Python, copied as they are; build_slot_caches and build_paged_pools
allocate torch buffers).

Two device layouts share this host module:

- `GPTSlotCache` (text/models/gpt.py): per layer, fixed
  [num_slots, max_len] K/V rows (stored [num_slots, H, max_len, Dh])
  plus a per-slot valid-length vector — every slot reserves `max_len`
  rows. `SlotAllocator` owns
  which slots are free and who holds them.
- `GPTPagedCache`: per layer, a pool of num_pages pages of page_size
  rows (stored [num_pages, H, page_size, Dh]) addressed through per-sequence block tables — a sequence only
  holds the pages it needs, and sequences sharing a prompt prefix map
  their leading block-table entries to the SAME physical page.
  `PageAllocator` (refcounted free list) and `PrefixCache` (block-hash
  -> page, LRU) own the host side.

Neither layout needs buffer clearing on reuse: a new occupant's prefill
writes from its own offset 0 and the validity mask never lets a query
see rows at/beyond the owning sequence's current length, so a previous
occupant's rows are unreachable the moment the length resets (the
engine's first prefill chunk writes back the new occupant's own length).
"""
import heapq
import time
from collections import OrderedDict

import torch

__all__ = ['SlotAllocator', 'build_slot_caches', 'PageAllocator',
           'PrefixCache', 'build_paged_pools', 'SCRATCH_PAGE']


class SlotAllocator:
    """Free-list over a fixed number of KV-cache slots.

    Lowest-index-first allocation (a heap, not a LIFO stack) keeps slot
    assignment deterministic for a given arrival order — parity tests
    replay the same workload and must see the same slot layout.
    """

    def __init__(self, num_slots, clock=None):
        if num_slots < 1:
            raise ValueError('num_slots must be >= 1, got %d' % num_slots)
        self.num_slots = num_slots
        self.clock = clock or time.monotonic
        self._free = list(range(num_slots))
        heapq.heapify(self._free)
        self._owner = {}  # slot -> opaque owner (request id)
        self._held_since = {}  # slot -> advance timestamp at alloc
        self._integral = 0.0   # integral of in_use over time (slot*s)
        self._last_t = self.clock()

    def _advance(self):
        """Accrue the occupancy integral up to now; returns now. Every
        state change routes through here, so per-request holding times
        measured from the SAME timestamps sum exactly to the pool
        integral (the billing cross-check in bench/request_report)."""
        now = self.clock()
        self._integral += len(self._owner) * (now - self._last_t)
        self._last_t = now
        return now

    def touch(self):
        """Public advance: accrue the integral and return the shared
        timestamp (schedulers stamp request holding windows with it)."""
        return self._advance()

    def page_seconds(self):
        """The pool-occupancy integral: sum over time of slots held, in
        slot·seconds (one slot == the allocation granule == one 'page'
        for attribution purposes)."""
        self._advance()
        return self._integral

    def alloc(self, owner):
        """Claim the lowest free slot for `owner`; None when full."""
        if not self._free:
            return None
        now = self._advance()
        slot = heapq.heappop(self._free)
        self._owner[slot] = owner
        self._held_since[slot] = now
        return slot

    def held_since(self, slot):
        """The integral timestamp at which `slot` was allocated."""
        return self._held_since.get(slot)

    def free(self, slot):
        """Release `slot` back to the free list; returns the seconds it
        was held (measured on the integral's own timestamps).

        Freeing a slot that is not currently allocated — including a
        second free of the same slot — raises: a silent double-free here
        would put one slot on the free list twice and hand the SAME KV
        rows to two requests, which corrupts outputs rather than
        crashing. The page allocator below enforces the same rule.
        """
        if slot not in self._owner:
            raise ValueError(
                'slot %r is not allocated (double-free, or never '
                'allocated)' % (slot,))
        now = self._advance()
        del self._owner[slot]
        heapq.heappush(self._free, slot)
        return now - self._held_since.pop(slot)

    def owner_of(self, slot):
        return self._owner.get(slot)

    @property
    def in_use(self):
        return len(self._owner)

    @property
    def available(self):
        return len(self._free)

    @property
    def occupancy(self):
        """Fraction of slots occupied, the per-step utilization metric."""
        return len(self._owner) / float(self.num_slots)


# physical page 0 is never handed out: frozen/retired sequence rows keep
# their block-table entries pointed here so in-program garbage writes
# (padded prefill tails, masked decode lanes) land on rows nobody reads
SCRATCH_PAGE = 0


class PageAllocator:
    """Refcounted free list over the physical pages of a paged KV pool.

    Lowest-index-first allocation (heap) keeps page layout deterministic
    for a given workload, like SlotAllocator. Refcounts exist because a
    page can be held by several owners at once — every sequence whose
    block table maps to it, plus the prefix cache itself. `alloc` hands
    out a page at refcount 1; `incref`/`decref` move it up and down;
    the page returns to the free list only at refcount 0.
    """

    def __init__(self, num_pages, clock=None):
        if num_pages < 2:
            raise ValueError('num_pages must be >= 2 (page 0 is the '
                             'reserved scratch page), got %d' % num_pages)
        self.num_pages = num_pages
        self.clock = clock or time.monotonic
        self._free = list(range(1, num_pages))
        heapq.heapify(self._free)
        self._refs = {}  # page -> refcount (> 0)
        self._integral = 0.0  # integral of in_use over time (page*s)
        self._last_t = self.clock()

    def _advance(self):
        """Accrue the occupancy integral (distinct pages referenced x
        elapsed time) up to now; returns now. Shared pages count ONCE
        here no matter how many sequences map them — per-request
        attribution can therefore exceed the pool integral exactly when
        prefix sharing saves pool space."""
        now = self.clock()
        self._integral += len(self._refs) * (now - self._last_t)
        self._last_t = now
        return now

    def touch(self):
        """Public advance: accrue the integral and return the shared
        timestamp (schedulers stamp request holding windows with it)."""
        return self._advance()

    def page_seconds(self):
        """The pool-occupancy integral in page·seconds."""
        self._advance()
        return self._integral

    def alloc(self):
        """Claim the lowest free page at refcount 1; None when empty."""
        if not self._free:
            return None
        self._advance()
        page = heapq.heappop(self._free)
        self._refs[page] = 1
        return page

    def incref(self, page):
        if page not in self._refs:
            raise ValueError('page %r is not allocated' % (page,))
        self._refs[page] += 1

    def decref(self, page):
        """Drop one reference; frees the page at zero. Mirrors
        SlotAllocator.free's strictness: decref of an unallocated page
        (double-free included) raises instead of silently re-listing a
        page two owners would then share."""
        if page == SCRATCH_PAGE:
            raise ValueError('page 0 is the reserved scratch page')
        if page not in self._refs:
            raise ValueError(
                'page %r is not allocated (double-free, or never '
                'allocated)' % (page,))
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._advance()
            del self._refs[page]
            heapq.heappush(self._free, page)
            return True
        return False

    # free == "I was the only owner and I'm done" — intent-revealing
    # alias used by non-sharing call sites
    free = decref

    def refcount(self, page):
        return self._refs.get(page, 0)

    @property
    def in_use(self):
        return len(self._refs)

    @property
    def available(self):
        return len(self._free)

    @property
    def occupancy(self):
        """Fraction of allocatable pages currently referenced."""
        return len(self._refs) / float(self.num_pages - 1)


class PrefixCache:
    """Block-aligned prompt-prefix cache: chain-hash of token blocks ->
    the physical page already holding that block's K/V.

    Hashing is a CHAIN (each block's key folds in the previous block's
    key), so a hit on block b proves the entire prefix [0, (b+1)*P)
    matches — not just block b's own tokens. Only FULL blocks are ever
    cached, and `match` never covers a whole prompt (at least one token
    must remain to prefill, because the final chunk's logits seed the
    first generated token). Divergence inside a block therefore needs no
    page copy: the shared pages are immutable full blocks, and the
    divergent tail is prefilled into the requester's own private pages —
    copy-on-write degenerates to fill-on-write.

    The cache holds one allocator reference per entry, so published
    pages survive their publisher's retirement. `evict` drops
    least-recently-matched entries whose page nobody else references.
    """

    def __init__(self, page_size, allocator):
        if page_size < 1:
            raise ValueError('page_size must be >= 1')
        self.page_size = int(page_size)
        self.allocator = allocator
        self._pages = OrderedDict()   # chain hash -> page (LRU order)
        self.hits = 0                 # full blocks served from cache
        self.misses = 0               # full blocks that had to prefill

    @staticmethod
    def _chain(prev, block_tokens):
        return hash((prev, tuple(block_tokens)))

    def match(self, prompt):
        """Longest cached chain of full blocks covering at most
        len(prompt)-1 tokens: returns the page list (no refs taken —
        the caller increfs what it keeps)."""
        P = self.page_size
        nfull = (len(prompt) - 1) // P
        pages, h = [], None
        for b in range(nfull):
            h = self._chain(h, prompt[b * P:(b + 1) * P])
            page = self._pages.get(h)
            if page is None:
                self.misses += nfull - b
                break
            self._pages.move_to_end(h)
            pages.append(page)
            self.hits += 1
        return pages

    def publish(self, prompt, block_idx, page):
        """Register `page` as holding prompt block `block_idx` (all of
        whose tokens must already be prefilled into it). Takes one
        allocator reference. No-op (False) when the chain is already
        cached — the existing entry wins and the duplicate page stays
        private to its sequence."""
        P = self.page_size
        h = None
        for b in range(block_idx + 1):
            h = self._chain(h, prompt[b * P:(b + 1) * P])
        if h in self._pages:
            return False
        self.allocator.incref(page)
        self._pages[h] = page
        return True

    def evict(self, need):
        """Drop least-recently-matched entries whose page only the
        cache still references, until `need` pages were freed (or the
        candidates run out). Returns pages freed. Entries whose page a
        resident sequence still maps are skipped — eviction must never
        pull a page out from under a live block table."""
        freed = 0
        for h in list(self._pages):
            if freed >= need:
                break
            page = self._pages[h]
            if self.allocator.refcount(page) == 1:
                del self._pages[h]
                self.allocator.decref(page)
                freed += 1
        return freed

    def clear(self):
        """Drop every entry (each releases its cache reference)."""
        for h, page in list(self._pages.items()):
            del self._pages[h]
            self.allocator.decref(page)

    def __len__(self):
        return len(self._pages)


def build_paged_pools(model, num_pages, page_size):
    """One (k_pool, v_pool) pair per transformer layer, zeroed, in the
    stored layout [num_pages, H, page_size, Dh] of GPTPagedCache, on the
    model's device and in its embedding's dtype. Block tables and lengths
    stay host-side (the engine hands them over per step); only the pools
    are persistent device state."""
    config = model.config
    weight = model.gpt.wte.weight
    head_dim = config.hidden_size // config.num_heads
    shape = (num_pages, config.num_heads, page_size, head_dim)
    return [(torch.zeros(shape, dtype=weight.dtype, device=weight.device),
             torch.zeros(shape, dtype=weight.dtype, device=weight.device))
            for _ in model.gpt.h]


def build_slot_caches(model, num_slots, max_len):
    """One GPTSlotCache per transformer layer of a GPTForCausalLM, on the
    model's device and in its embedding's dtype, as generate() builds its
    static cache."""
    from ..text.models.gpt import GPTSlotCache
    config = model.config
    if max_len > config.max_position_embeddings:
        raise ValueError(
            'slot capacity %d exceeds max_position_embeddings %d'
            % (max_len, config.max_position_embeddings))
    weight = model.gpt.wte.weight
    head_dim = config.hidden_size // config.num_heads
    return [GPTSlotCache.empty(num_slots, max_len, config.num_heads,
                               head_dim, dtype=weight.dtype,
                               device=weight.device)
            for _ in model.gpt.h]
