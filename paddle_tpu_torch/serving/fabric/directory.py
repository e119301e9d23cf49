"""Gateway-level prefix-cache directory + prefix-affinity routing
(counterpart of paddle_tpu/serving/fabric/directory.py).

Each paged replica owns a PrefixCache (serving/kv_cache.py) keyed by
the chain hash of full prompt blocks. Those caches are per-engine: a
request routed by load alone lands wherever the pool is idlest, and a
90%-shared system prompt re-prefills on every replica that has not
seen it. The directory is the gateway's cheap global view: every
successful placement records the prompt's chain hashes -> replica
index, and the PrefixAffinityRouter ranks replicas by how deep a chain
for THIS prompt they have already served.

It is a HINT table, not a coherence protocol: entries go stale when a
replica evicts or dies, and the cost of a stale hint is one prefix
miss — the engine re-prefills exactly as it would have without the
directory. That is why the directory can be an LRU map updated on
placement only, with no invalidation traffic over the fabric.

The chain function is PrefixCache._chain itself, so a directory depth
of b blocks corresponds exactly to the pages a replica's own cache
would match (same block alignment, same never-cover-the-whole-prompt
rule).
"""
from collections import OrderedDict

from ..gateway.router import LeastLoadedRouter
from ..kv_cache import PrefixCache

__all__ = ['PrefixDirectory', 'PrefixAffinityRouter']


class PrefixDirectory:
    """LRU map: chain hash of a full prompt block -> replica index that
    most recently prefilled it."""

    def __init__(self, page_size, capacity=4096):
        if page_size < 1:
            raise ValueError('page_size must be >= 1')
        self.page_size = int(page_size)
        self.capacity = int(capacity)
        self._dir = OrderedDict()

    def chain_hashes(self, prompt):
        """Chain hash per full block, matching PrefixCache.match's
        coverage rule (at most len(prompt)-1 tokens — the last token
        always prefills)."""
        P = self.page_size
        nfull = (len(prompt) - 1) // P
        out, h = [], None
        for b in range(nfull):
            h = PrefixCache._chain(h, prompt[b * P:(b + 1) * P])
            out.append(h)
        return out

    def observe(self, prompt, replica_index):
        """Record a placement: every full block of `prompt` now (very
        likely) has its pages on `replica_index`. Latest writer wins —
        the most recent placement is the warmest cache."""
        for h in self.chain_hashes(prompt):
            if h in self._dir:
                self._dir.move_to_end(h)
            self._dir[h] = int(replica_index)
        while len(self._dir) > self.capacity:
            self._dir.popitem(last=False)

    def depths(self, prompt):
        """{replica_index: matched chain depth in blocks} for `prompt`.
        The walk stops at the first unknown hash — beyond it no
        replica's cache can chain-match either."""
        depths = {}
        for b, h in enumerate(self.chain_hashes(prompt)):
            owner = self._dir.get(h)
            if owner is None:
                break
            self._dir.move_to_end(h)
            depths[owner] = b + 1
        return depths

    def __len__(self):
        return len(self._dir)


class PrefixAffinityRouter(LeastLoadedRouter):
    """LeastLoaded with a prefix-depth tier in front: replicas holding
    a deeper cached chain for the request's prompt rank first,
    least-loaded among equals.

    The gateway calls `candidates_for_request(pool, gw)` when the
    router has one (it sees the PROMPT, which `candidates(pool)` never
    does) and `note_placement(prompt, index)` after every successful
    placement — including failover re-placements, so the directory
    tracks where the tokens actually went."""

    name = 'prefix_affinity'

    def __init__(self, page_size, capacity=4096):
        self.directory = PrefixDirectory(page_size, capacity=capacity)

    def candidates_for_request(self, pool, gw):
        depths = self.directory.depths(gw.prompt)
        rs = [r for r in pool if r.routable()]
        rs.sort(key=lambda r: (-depths.get(r.index, 0), r.load(),
                               r.index))
        return rs

    def note_placement(self, prompt, replica_index):
        self.directory.observe(prompt, replica_index)
