"""Pure multi-tenant QoS admission policy: token buckets, concurrency
quotas, priorities (counterpart of paddle_tpu/capacity/qos.py, copied: it
needs nothing but the standard library).

This module is the policy half of the QoS enforcement plane. It is
deliberately free of clocks, locks and serving imports — every decision
takes `now` as an argument (the AutoscalePolicy discipline: the caller
owns time, tests drive a fake clock), and the caller serializes access
(the gateway calls under its one lock; the simulator is single-
threaded). The same `QosPolicy` object therefore drives three
consumers without adaptation:

- `ServingGateway(admission=policy)` — real traffic, real clock;
- `capacity.simulator.simulate(trace, ..., qos=policy)` — the same
  admission decisions at million-request scale in virtual time;
- `tools/capacity_report.py --qos-policy` — policy sweeps from JSON.

Vocabulary (closed sets — metrics label budgets depend on this):

- rejection reasons: ``'rate'`` (token bucket empty), ``'quota'``
  (per-tenant concurrency cap), ``'queue_full'`` (bounded pending
  queue overflowed), ``'deadline'`` (parked past max_queue_wait_s).
  `admit` itself only produces the first two; the queue-shaped reasons
  belong to the queue owner (gateway / simulator).
- priority: plain int, higher wins. Ties are FIFO.
"""
import math

__all__ = ['REJECT_REASONS', 'TokenBucket', 'TenantClass', 'QosPolicy']

REJECT_REASONS = ('rate', 'quota', 'queue_full', 'deadline')


class TokenBucket:
    """Classic token bucket in continuous time: `rate` tokens/s refill,
    `burst` capacity. No clock inside — `take`/`level` are functions of
    the caller's `now`, so virtual (simulator) and real time both
    work, and tests never sleep."""

    def __init__(self, rate, burst):
        if rate <= 0:
            raise ValueError('rate must be positive')
        if burst <= 0:
            raise ValueError('burst must be positive')
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        self._t = None                  # time of the last refill

    def _refill(self, now):
        if self._t is None:
            self._t = now
        elif now > self._t:
            self._level = min(self.burst,
                              self._level + (now - self._t) * self.rate)
            self._t = now

    def take(self, now, n=1):
        """Spend `n` tokens if available; False leaves the level
        untouched (a rejected request must not consume credit)."""
        self._refill(now)
        if self._level + 1e-9 < n:
            return False
        self._level -= n
        return True

    def level(self, now):
        self._refill(now)
        return self._level


class TenantClass:
    """One tenant class's limits: requests/s (`rate` + `burst`),
    concurrent in-flight cap (`max_concurrent`), scheduling `priority`.
    None for a limit means unlimited."""

    def __init__(self, name='default', rate=None, burst=None,
                 max_concurrent=None, priority=0):
        self.name = str(name)
        self.rate = None if rate is None else float(rate)
        # burst defaults to one second of rate (min 1) — the smallest
        # bucket that still admits a steady stream at exactly `rate`
        self.burst = (float(burst) if burst is not None
                      else None if rate is None
                      else max(1.0, math.ceil(rate)))
        self.max_concurrent = (None if max_concurrent is None
                               else int(max_concurrent))
        self.priority = int(priority)

    def to_dict(self):
        d = {'name': self.name, 'priority': self.priority}
        if self.rate is not None:
            d['rate'] = self.rate
            d['burst'] = self.burst
        if self.max_concurrent is not None:
            d['max_concurrent'] = self.max_concurrent
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(name=d.get('name', 'default'), rate=d.get('rate'),
                   burst=d.get('burst'),
                   max_concurrent=d.get('max_concurrent'),
                   priority=d.get('priority', 0))


class QosPolicy:
    """Admission policy over a set of tenant classes.

    `classes`: {tenant name: TenantClass} (or an iterable of
    TenantClass, keyed by their names). Tenants without a class fall
    back to `default` (an unlimited priority-0 TenantClass unless
    given). `max_pending` bounds the owner's pending queue;
    `max_queue_wait_s` is the parked-request deadline — both are
    advisory numbers the queue owner enforces, carried here so one JSON
    blob describes the whole policy.

    Mutable per-tenant state (bucket level, in-flight count) lives on
    the policy, keyed by the tenant name the caller passes — gateways
    pass bounded TenantLabeler labels, so state cardinality is bounded
    too. Call `admit` once per arriving request and `finish` exactly
    once per admitted request that terminates.
    """

    def __init__(self, classes=None, default=None, max_pending=None,
                 max_queue_wait_s=None):
        self.classes = {}
        if classes:
            it = classes.values() if isinstance(classes, dict) \
                else classes
            for c in it:
                self.classes[c.name] = c
        self.default = default if default is not None else TenantClass()
        self.max_pending = None if max_pending is None else int(max_pending)
        self.max_queue_wait_s = (None if max_queue_wait_s is None
                                 else float(max_queue_wait_s))
        self._buckets = {}              # tenant -> TokenBucket
        self._inflight = {}             # tenant -> admitted, unfinished

    def class_of(self, tenant):
        key = 'default' if tenant is None else str(tenant)
        return self.classes.get(key, self.default)

    def priority_of(self, tenant):
        return self.class_of(tenant).priority

    def _bucket(self, tenant, cls):
        if cls.rate is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(cls.rate, cls.burst)
        return b

    def admit(self, now, tenant):
        """One admission decision: (True, None) or (False, reason) with
        reason in {'rate', 'quota'}. Admission takes one bucket token
        and one in-flight slot; rejection takes neither."""
        key = 'default' if tenant is None else str(tenant)
        cls = self.class_of(key)
        if cls.max_concurrent is not None and \
                self._inflight.get(key, 0) >= cls.max_concurrent:
            return False, 'quota'
        b = self._bucket(key, cls)
        if b is not None and not b.take(now):
            return False, 'rate'
        self._inflight[key] = self._inflight.get(key, 0) + 1
        return True, None

    def finish(self, tenant):
        """Release the in-flight slot `admit` took. Exactly once per
        admitted request, at any terminal outcome."""
        key = 'default' if tenant is None else str(tenant)
        n = self._inflight.get(key, 0)
        if n > 0:
            self._inflight[key] = n - 1

    def inflight(self, tenant):
        key = 'default' if tenant is None else str(tenant)
        return self._inflight.get(key, 0)

    def bucket_level(self, tenant, now):
        """Remaining credit for the tenant's bucket (None: unlimited)."""
        key = 'default' if tenant is None else str(tenant)
        b = self._bucket(key, self.class_of(key))
        return None if b is None else b.level(now)

    def to_dict(self):
        d = {'classes': [c.to_dict() for _, c in
                         sorted(self.classes.items())],
             'default': self.default.to_dict()}
        if self.max_pending is not None:
            d['max_pending'] = self.max_pending
        if self.max_queue_wait_s is not None:
            d['max_queue_wait_s'] = self.max_queue_wait_s
        return d

    @classmethod
    def from_dict(cls, d):
        return cls(
            classes=[TenantClass.from_dict(c)
                     for c in d.get('classes', ())],
            default=(TenantClass.from_dict(d['default'])
                     if 'default' in d else None),
            max_pending=d.get('max_pending'),
            max_queue_wait_s=d.get('max_queue_wait_s'))
