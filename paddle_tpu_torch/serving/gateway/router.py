"""Routing policies: order the replica pool for one placement attempt
(counterpart of paddle_tpu/serving/gateway/router.py, copied whole).

A router never *commits* a placement — it ranks. The gateway walks the
ranked candidates and submits to the first one whose transport accepts,
so a policy stays a pure function of observable replica state and the
failover path (try the next candidate) needs no policy cooperation.

Load is read from the live serving gauges each replica already exports
(`serving_queue_depth`, `serving_occupancy` — serving/metrics.py), not
from gateway-side shadow accounting: whatever a scrape of the replica
would show is exactly what the router balances on.
"""

__all__ = ['LeastLoadedRouter', 'ModelAffinityRouter', 'RoundRobinRouter']


class LeastLoadedRouter:
    """Rank routable replicas by live load, ties broken by index.

    load = queue_depth + occupancy * num_slots: queued requests and
    occupied slots cost the same one unit, so an idle replica beats a
    full one even when nothing is queued anywhere.
    """

    name = 'least_loaded'

    def candidates(self, pool):
        rs = [r for r in pool if r.routable()]
        rs.sort(key=lambda r: (r.load(), r.index))
        return rs


class ModelAffinityRouter(LeastLoadedRouter):
    """LeastLoaded with a model-residency tier in front: replicas whose
    engine already hosts the requested model's weights rank before ones
    that would have to page them in, least-loaded within each tier.

    The gateway calls `candidates_for(pool, model)` when a request names
    a model; requests without one (and single-model pools) fall through
    to the plain least-loaded ranking. Residency is read through the
    engine's `hosts_model` when it exists (the reference's
    registry.ModelHost, not ported yet); an ordinary engine has no
    residency notion and ranks in the cold tier — harmless, since a
    single-model pool never names models.
    """

    name = 'model_affinity'

    def candidates_for(self, pool, model):
        def hosts(r):
            fn = getattr(r.engine, 'hosts_model', None)
            return bool(fn(model)) if fn is not None else False
        rs = [r for r in pool if r.routable()]
        rs.sort(key=lambda r: (0 if hosts(r) else 1, r.load(), r.index))
        return rs


class RoundRobinRouter:
    """Rotate over routable replicas, blind to load — the baseline
    policy benches compare against (and the fallback when a deployment
    scrapes gauges too coarsely to trust them)."""

    name = 'round_robin'

    def __init__(self):
        self._next = 0

    def candidates(self, pool):
        rs = [r for r in pool if r.routable()]
        if not rs:
            return rs
        k = self._next % len(rs)
        self._next += 1
        return rs[k:] + rs[:k]
