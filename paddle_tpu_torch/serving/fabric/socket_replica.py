"""SocketReplica: the gateway-side proxy for a ReplicaWorker process
(counterpart of paddle_tpu/serving/fabric/socket_replica.py).

Implements the ReplicaTransport contract over a ResilientChannel with
the fabric JSON codec, so the gateway's failover, QoS shedding and
rollout() machinery work unchanged across the process boundary:

- submit() journals every send with a (client, seq) pair; the worker
  dedups on it, so the channel's retry of a timed-out submit admits
  exactly once (idempotent= is COMPUTED from the journal pair — the
  lint-enforced discipline for conditional ops);
- step() is one 'poll': it pulls newly generated tokens into local
  RemoteRequest shadows that quack like engine requests (.tokens /
  .done / .outcome plus the wide-event stat fields, stamped from the
  worker's final record), which is all _collect_locked ever reads;
- a step/submit failure after the channel's retry budget raises — the
  driver's on_lost fires and the gateway fails the work over exactly
  as it would for a dead in-proc replica. The breaker is SHARED
  between the channel and the replica (threshold 2: one reconnect
  retry is a blip, two consecutive failures is a dead worker);
- rollout() sees a multi-model worker through _EngineProxy, which
  forwards prepare_rollout/finish_rollout and exposes a per-worker
  registry proxy — the gateway's identity-dedup then flips EVERY
  worker's serving pointer, which is precisely correct: each process
  has its own registry;
- scrape_kwargs() hands the worker's /metrics.json URL to a fleet
  collector (monitor/federation.py's FleetCollector), so federation
  scrapes the worker PROCESS.
"""
import os
import threading
import time

from ...distributed.resilience import (CircuitBreaker, ResilientChannel,
                                       RetryPolicy)
from .protocol import JSON_CODEC, MAX_FRAME
from .transport import ReplicaTransport

__all__ = ['SocketReplica', 'RemoteRequest']


class RemoteRequest:
    """Local shadow of a worker-side engine request. Carries exactly
    what the gateway reads off an engine request: the delivered-token
    ledger, terminal state, and the wide-event instrumentation attrs
    (stamped from the worker's final poll record)."""

    __slots__ = ('id', 'tokens', 'done', 'outcome', '_span', '_admit_t',
                 '_arrival_t', '_prefill_chunks', '_prefix_hit',
                 '_spec_proposed', '_spec_accepted', 'kv_page_seconds')

    def __init__(self, rid):
        self.id = rid
        self.tokens = []
        self.done = False
        self.outcome = None
        self._span = None
        self._admit_t = None
        self._arrival_t = None
        self._prefill_chunks = 0
        self._prefix_hit = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self.kv_page_seconds = 0.0

    def finish(self, rec):
        self.outcome = rec.get('outcome')
        self._admit_t = rec.get('admit_t')
        self._arrival_t = rec.get('arrival_t')
        self._prefill_chunks = rec.get('prefill_chunks', 0)
        self._prefix_hit = rec.get('prefix_hit', 0)
        self._spec_proposed = rec.get('spec_proposed', 0)
        self._spec_accepted = rec.get('spec_accepted', 0)
        self.kv_page_seconds = rec.get('kv_page_seconds', 0.0)
        self.done = True


class _SchedulerProxy:
    """The two scheduler attrs the gateway reads, answered locally —
    sync step() holds the gateway lock, so these must never hit the
    wire."""

    def __init__(self, replica):
        self._r = replica

    @property
    def pending(self):
        return self._r._n_unfinished()

    @property
    def queue(self):
        return [rr for rr in self._r._shadow_list() if not rr.done]


class _RegistryProxy:
    """The registry surface rollout() touches, forwarded to the
    worker's own ModelRegistry. One proxy per replica: the gateway's
    identity-dedup treats each worker as the distinct registry it is."""

    def __init__(self, replica):
        self._r = replica

    def serving_version(self, model):
        out = self._r._call({'op': 'serving_version', 'model': model})
        return out['version']

    def set_serving(self, model, version):
        out = self._r._call({'op': 'set_serving', 'model': model,
                             'version': version})
        return out['prev']


_ROLLOUT_ATTRS = ('prepare_rollout', 'finish_rollout', 'hosts_model',
                  'registry')


class _EngineProxy:
    """Duck-types the slice of the engine surface the gateway touches
    on `rep.engine`. The rollout attrs exist only when the remote
    engine is a ModelHost — `hasattr(engine, 'prepare_rollout')` is the
    gateway's feature probe, and lying about a single-model worker
    would crash rollout() mid-flight."""

    def __init__(self, replica):
        self._r = replica
        self.scheduler = _SchedulerProxy(replica)

    @property
    def num_slots(self):
        return self._r._load['num_slots']

    def __getattr__(self, name):
        if name in _ROLLOUT_ATTRS and self._r.multi_model:
            if name == 'registry':
                return self._r._registry_proxy
            return getattr(self._r, '_' + name)
        raise AttributeError(name)


class SocketReplica(ReplicaTransport):

    def __init__(self, endpoint, index=-1, metrics_url=None,
                 client_id=None, breaker=None, registry=None,
                 call_timeout=None, poll_interval=0.004):
        if breaker is None:
            # threshold 2, not the in-proc 1: a socket can blip without
            # the worker being dead — one reconnect retry is allowed,
            # two consecutive failures opens the breaker and the
            # gateway fails over. No auto-heal (reset far in the
            # future): a dead worker is replaced, not probed.
            breaker = CircuitBreaker(failure_threshold=2,
                                     reset_timeout=3600.0)
        super().__init__(index, endpoint, breaker=breaker,
                         registry=registry)
        kwargs = {} if call_timeout is None else \
            {'call_timeout': call_timeout}
        self._channel = ResilientChannel(
            endpoint, codec=JSON_CODEC, max_frame=MAX_FRAME,
            retry_policy=RetryPolicy(max_attempts=2, base_delay=0.02),
            breaker=self.breaker, **kwargs)
        self.metrics_url = metrics_url
        self._client_id = client_id or 'gw-%d-%x' % (os.getpid(),
                                                     id(self) & 0xffffff)
        self._seq = 0
        self._poll_interval = poll_interval
        self._slock = threading.Lock()
        self._shadows = {}   # wire req id (str) -> RemoteRequest
        self._load = {'state': 'ready', 'queue_depth': 0.0,
                      'occupancy': 0.0, 'num_slots': 1, 'pending': 0}
        self._multi_model = None
        self._registry_proxy = _RegistryProxy(self)
        self.engine = _EngineProxy(self)

    # ---- wire plumbing ------------------------------------------------

    def _call(self, msg, **kw):
        out = self._channel.call(msg, **kw)
        if isinstance(out, dict) and 'error' in out:
            if out.get('error_type') == 'ValueError':
                raise ValueError(out['error'])
            raise RuntimeError('worker %s: %s'
                               % (self.endpoint, out['error']))
        return out

    def _apply_load(self, load):
        if load:
            self._load = load

    def connect(self):
        """Eagerly probe the worker (status): caches multi_model and
        the first load snapshot. Call before adopting into a gateway so
        rollout()'s feature probe never does a wire call under the
        gateway lock."""
        out = self._call({'op': 'status'})
        self._multi_model = bool(out.get('multi_model'))
        self._apply_load(out.get('load'))
        return self

    @property
    def multi_model(self):
        if self._multi_model is None:
            try:
                self.connect()
            except Exception:    # noqa: BLE001 — probe, don't cache
                return False
        return self._multi_model

    # ---- transport ----------------------------------------------------

    def submit(self, prompt, **sampling):
        self._seq += 1
        seq = self._seq
        msg = {'op': 'submit', 'client': self._client_id, 'seq': seq,
               'prompt': [int(t) for t in prompt], 'sampling': sampling}
        # journaled send: retry safety comes from the worker's
        # (client, seq) dedup, so idempotent= is computed, not asserted
        out = self._call(msg, idempotent=seq is not None)
        rid = out['req_id']
        with self._slock:
            rr = self._shadows.get(rid)
            if rr is None:
                rr = self._shadows[rid] = RemoteRequest(rid)
            self._apply_load(out.get('load'))
        return rr

    def step(self):
        """One poll round-trip: pull new tokens into the shadows, ack
        consumed terminals, refresh load gauges. Raises on transport
        failure or a dead remote engine — the failover trigger."""
        with self._slock:
            live = {rid: len(rr.tokens)
                    for rid, rr in self._shadows.items() if not rr.done}
            acks = [rid for rid, rr in self._shadows.items() if rr.done]
        if not live and not acks:
            return 0
        out = self._call({'op': 'poll', 'reqs': live, 'ack': acks})
        delivered = 0
        with self._slock:
            for rid in acks:
                self._shadows.pop(rid, None)
            for rid, entry in out.get('reqs', {}).items():
                rr = self._shadows.get(rid)
                if rr is None:
                    continue
                new = entry.get('tokens') or ()
                if new:
                    rr.tokens.extend(int(t) for t in new)
                    delivered += len(new)
                if entry.get('done'):
                    rr.finish(entry)
            self._apply_load(out.get('load'))
        if self._load.get('state') == 'dead':
            raise RuntimeError('worker %s reports engine death'
                               % self.endpoint)
        if not delivered and live:
            # decode step in flight remotely: back off one interval
            # instead of hammering the socket
            time.sleep(self._poll_interval)
        return delivered

    def has_pending(self):
        with self._slock:
            # done-but-unacked shadows count: one more poll acks them
            return bool(self._shadows)

    def _n_unfinished(self):
        with self._slock:
            return sum(1 for rr in self._shadows.values() if not rr.done)

    def _shadow_list(self):
        with self._slock:
            return list(self._shadows.values())

    # ---- observability -------------------------------------------------

    def queue_depth(self):
        return float(self._load.get('queue_depth', 0.0))

    def occupancy(self):
        return float(self._load.get('occupancy', 0.0))

    def load(self):
        return (self.queue_depth()
                + self.occupancy() * self._load.get('num_slots', 1))

    def scrape_kwargs(self):
        """Federate the worker PROCESS: an HTTP target on its
        /metrics.json. A SIGKILL'd worker then shows stale-not-wrong
        (fleet_target_up -> 0, last snapshot retained)."""
        if self.metrics_url:
            return {'url': self.metrics_url}
        return {'registry': self.registry}

    # ---- lifecycle -----------------------------------------------------

    def drain(self):
        super().drain()
        try:
            self._call({'op': 'drain'})
        except Exception:   # noqa: BLE001 — draining a dead worker is moot
            pass

    # ---- rollout forwarding (reached via _EngineProxy) ------------------

    def _prepare_rollout(self, model, version):
        return self._call({'op': 'rollout_prepare', 'model': model,
                           'version': version})

    def _finish_rollout(self, model, old_version):
        self._call({'op': 'rollout_finish', 'model': model,
                    'old_version': old_version})

    def _hosts_model(self, model, version=None):
        out = self._call({'op': 'hosts_model', 'model': model,
                          'version': version})
        return out['hosts']

    def close(self):
        self._channel.close()
