"""Elastic autoscaling policy: pure functions of (clock, observations)
(counterpart of paddle_tpu/serving/gateway/autoscaler.py, copied whole).

The policy owns NO threads and reads NO globals — the gateway feeds it
`now` plus the current burn rate / occupancy / queue depth and applies
whatever Decision comes back. That makes every scaling behaviour (scale
up under sustained SLO burn, scale down when idle, hysteresis against
flapping) unit-testable with a fake clock and hand-picked observations,
the same injectable-clock discipline as monitor/registry.py.

Burn rate is computed from the gateway's TTFT samples, not from means:
the SLO is "p(TTFT > slo_ttft_s) stays low", so the signal is the
fraction of windowed requests over the target — a direct read of the
`gateway_ttft_seconds` histogram's tail.
"""
import collections

__all__ = ['Decision', 'AutoscalePolicy', 'slo_burn_rate']

Decision = collections.namedtuple('Decision', 'delta reason')


def slo_burn_rate(samples, now, slo_ttft_s, window_s):
    """Fraction of TTFT samples in the trailing window over the SLO.

    `samples` is an iterable of (t, ttft_seconds). No samples in the
    window means no evidence of burn — 0.0, never NaN.

    The snapshot below is load-bearing: the gateway hands its live
    `_ttfts` deque here, and driver threads append to it concurrently.
    Appends on a maxlen deque evict from the left, and iterating a
    deque while another thread mutates it raises RuntimeError — so
    iterate a tuple copy, never the live object.
    """
    samples = tuple(samples)
    recent = [ttft for (t, ttft) in samples if now - t <= window_s]
    if not recent:
        return 0.0
    over = sum(1 for ttft in recent if ttft > slo_ttft_s)
    return over / float(len(recent))


class AutoscalePolicy:
    """Hysteretic scale-up/down policy over SLO burn rate.

    Scale up when burn_rate >= burn_threshold has held for sustain_s;
    scale down when the pool has been demonstrably idle (zero burn,
    occupancy <= idle_occupancy, empty queue) for sustain_s. Both edges
    are suppressed by a shared cooldown_s after any action, and a signal
    that flaps resets its sustain timer — two mechanisms, one goal: a
    noisy burn series near the threshold must not saw the pool.
    """

    def __init__(self, slo_ttft_s, min_replicas=1, max_replicas=8,
                 burn_threshold=0.5, idle_occupancy=0.25, sustain_s=3.0,
                 cooldown_s=15.0, window_s=30.0, premium_tenants=()):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError('need 1 <= min_replicas <= max_replicas')
        self.slo_ttft_s = float(slo_ttft_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_threshold = float(burn_threshold)
        self.idle_occupancy = float(idle_occupancy)
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self.window_s = float(window_s)
        # tenants whose PRIVATE burn triggers scale-up even while the
        # aggregate looks healthy: a small premium tenant drowned by a
        # large batch tenant's fast requests never moves the pool-wide
        # burn fraction, so the aggregate alone under-scales exactly
        # when the highest-value SLO is burning
        self.premium_tenants = tuple(premium_tenants)
        self._burn_since = None
        self._idle_since = None
        self._last_action_t = None

    def decide(self, now, burn_rate, occupancy, queue_depth, replicas,
               tenant_burns=None):
        """One policy evaluation; returns Decision(delta in {-1, 0, +1},
        reason). The caller applies the delta (and may refuse — the
        policy's own min/max clamp already makes refusal rare).
        `tenant_burns` (label -> burn fraction, optional) feeds the
        premium_tenants early trigger; the gateway passes it only when
        premium tenants are configured."""
        hot = burn_rate >= self.burn_threshold
        hot_tenant = None
        if tenant_burns and self.premium_tenants:
            for t in self.premium_tenants:
                if tenant_burns.get(t, 0.0) >= self.burn_threshold:
                    hot_tenant = t
                    hot = True
                    break
        idle = (not hot and burn_rate == 0.0
                and occupancy <= self.idle_occupancy
                and queue_depth == 0)
        if hot:
            if self._burn_since is None:
                self._burn_since = now
        else:
            self._burn_since = None
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self.cooldown_s)
        if hot and now - self._burn_since >= self.sustain_s:
            if cooling:
                return Decision(0, 'hot but cooling down')
            if replicas >= self.max_replicas:
                return Decision(0, 'hot but at max_replicas=%d'
                                % self.max_replicas)
            self._last_action_t = now
            self._burn_since = None
            if hot_tenant is not None:
                return Decision(+1, 'premium tenant %r burn %.2f >= '
                                '%.2f for %.1fs'
                                % (hot_tenant,
                                   tenant_burns.get(hot_tenant, 0.0),
                                   self.burn_threshold, self.sustain_s))
            return Decision(+1, 'burn %.2f >= %.2f for %.1fs'
                            % (burn_rate, self.burn_threshold,
                               self.sustain_s))
        if idle and now - self._idle_since >= self.sustain_s:
            if cooling:
                return Decision(0, 'idle but cooling down')
            if replicas <= self.min_replicas:
                return Decision(0, 'idle but at min_replicas=%d'
                                % self.min_replicas)
            self._last_action_t = now
            self._idle_since = None
            return Decision(-1, 'idle (occupancy %.2f, empty queue) '
                            'for %.1fs' % (occupancy, self.sustain_s))
        return Decision(0, 'hold')
