"""The gateway: one front door over a pool of engine replicas
(counterpart of paddle_tpu/serving/gateway/gateway.py).

    gw = ServingGateway(lambda: ContinuousBatchingEngine(model, ...),
                        replicas=2)
    req = gw.submit(prompt, max_new_tokens=32)
    gw.run()                       # or gw.start() for driver threads
    req.tokens                     # identical to a single engine's output

Four jobs, one lock:

- **Admission.** With `admission=QosPolicy(...)` configured, submit()
  first runs the per-tenant token bucket + concurrency quota; a shed
  request finishes immediately with outcome='rejected' (one wide
  event, `error` set — overload is data, not an exception). The
  pending queue becomes bounded (`max_pending`: overflow sheds the
  lowest-priority parked request) and deadline-aware
  (`max_queue_wait_s`: parked past the deadline sheds on the next
  drain). See admission.py for the contract.
- **Routing.** submit() walks the router's ranked candidates and places
  the request on the first replica whose transport accepts; when none is
  routable the request parks in the gateway queue and is drained on the
  next step (highest priority first, FIFO within a class). Routing
  emits a `gateway.route` span and per-replica `gateway_route_total`
  counts.
- **Failover.** A replica lost mid-flight (chaos partition, driver
  exception, kill_replica) has every non-finished assigned request
  re-submitted elsewhere — full prompt, same seed. Engines are
  deterministic for a fixed (prompt, sampling, seed), so the new replica
  regenerates the identical token stream, and the gateway's
  delivered-token ledger (`GatewayRequest.tokens`) forwards only the
  suffix the caller has not seen: exactly-once delivery with
  exact-token parity, no idempotency tokens needed. The breaker opens
  on the loss, so the router never offers the dead replica again.
- **Autoscaling.** autoscale_tick() feeds the pure AutoscalePolicy the
  windowed TTFT SLO burn rate plus pool occupancy/queue depth and
  applies the Decision: +1 builds a replica from the engine factory,
  -1 drains the least-loaded READY replica (drain, never kill — its
  in-flight work finishes).

Locking: one gateway RLock guards pool membership, assignment maps,
the pending queue, and delivery; replica driver threads call back into
_collect/_on_lost which take it. Order is strictly gateway lock ->
engine lock (replica.submit/step run under the gateway lock only in
sync mode; drivers call them lock-free and only take the gateway lock
inside the callbacks), and the replica condvar is never held across a
callback. Model code runs only inside an engine's step(), which enters
torch.no_grad itself: grad mode is thread-local, and a driver thread
starts with it on.

Fleet telemetry: `attach_fleet(collector)` registers every replica (and
every later one) as a scrape target of a monitor.federation
FleetCollector, `burn_source` (e.g. alerts.federated_burn_source) feeds
autoscale_tick the fleet-wide TTFT burn, and a failed-over request's
trace is force-kept by the tracer's TraceRetention (reason 'failover').
"""
import collections
import itertools
import queue as _queue
import threading
import time

from ...monitor import events as _events
from ...monitor import tracing as _tracing
from ...monitor.registry import default_registry
from ...monitor.telemetry import (record_gateway_schema, record_qos_schema,
                                  record_tenant_schema)
from .autoscaler import Decision, slo_burn_rate
from .replica import DRAINING, READY, STATE_CODES, InprocReplica
from .router import LeastLoadedRouter

__all__ = ['ServingGateway', 'GatewayRequest']

_gw_ids = itertools.count()


class GatewayRequest:
    """Caller-facing handle: the delivered-token ledger.

    `tokens` holds only what the gateway has handed to the caller —
    after a failover the replacement replica regenerates from scratch
    and the gateway forwards `engine_tokens[len(self.tokens):]`, so the
    caller never sees a duplicate or a gap. `replica_history` records
    every placement (length > 1 == the request survived a failover).
    """

    def __init__(self, prompt, sampling, stream=False):
        self.id = next(_gw_ids)
        self.prompt = [int(t) for t in prompt]
        self.sampling = dict(sampling)
        self.tokens = []
        self.replica_history = []
        self.failovers = 0       # replica losses survived
        self.arrival_t = None
        self.first_token_t = None
        self.error = None        # set iff rejected/shed/failed
        self._eng_req = None     # current engine-side Request
        self._qos_label = None   # admission slot held, iff admitted
        self._stream_q = _queue.Queue() if stream else None
        self._finished = threading.Event()

    @property
    def done(self):
        return self._finished.is_set()

    def wait(self, timeout=None):
        return self._finished.wait(timeout)

    def stream(self):
        """Yield tokens as the gateway delivers them (requires
        submit(..., stream=True) and a start()ed gateway)."""
        if self._stream_q is None:
            raise ValueError('request was not submitted with stream=True')
        while True:
            tok = self._stream_q.get()
            if tok is None:
                return
            yield tok

    def __repr__(self):
        return ('GatewayRequest(id=%d, delivered=%d/%d, replicas=%s)'
                % (self.id, len(self.tokens),
                   self.sampling.get('max_new_tokens', 0),
                   self.replica_history))


class ServingGateway:

    def __init__(self, engine_factory, replicas=2, router=None,
                 autoscaler=None, admission=None, registry=None,
                 clock=None):
        if engine_factory is None:
            # fabric mode: the pool is populated by adopt_replica()
            # (e.g. SocketReplicas proxying worker processes), so there
            # is nothing to build locally
            if replicas:
                raise ValueError('engine_factory=None requires replicas=0 '
                                 '(populate the pool via adopt_replica)')
        elif replicas < 1:
            raise ValueError('need at least one replica')
        self._factory = engine_factory
        self._clock = clock or time.monotonic
        self.registry = registry if registry is not None \
            else default_registry()
        self.router = router if router is not None else LeastLoadedRouter()
        self.policy = autoscaler
        self.admission = admission      # capacity.qos.QosPolicy or None
        self._lock = threading.RLock()
        self._tracer = _tracing.default_tracer()
        fams = record_gateway_schema(self.registry)
        self._m_requests = fams['gateway_requests_total']
        self._m_completed = fams['gateway_requests_completed_total']
        self._m_tokens = fams['gateway_tokens_total']
        self._m_route = fams['gateway_route_total']
        self._m_retries = fams['gateway_retries_total']
        self._m_failover = fams['gateway_failover_total']
        self._m_scale = fams['gateway_scale_events_total']
        self._m_replicas = fams['gateway_replicas']
        self._m_state = fams['gateway_replica_state']
        self._m_queue = fams['gateway_queue_depth']
        self._m_burn = fams['gateway_slo_burn_rate']
        self._m_ttft = fams['gateway_ttft_seconds']
        # tenant attribution at the FRONT DOOR (replicas keep their own
        # engine-level tenant families on private registries): requests
        # and TTFT are observed here where failovers are invisible to
        # the caller, so a tenant's TTFT includes failover stalls
        tfams = record_tenant_schema(self.registry)
        self._m_tenant_requests = tfams['tenant_requests_total']
        self._m_tenant_ttft = tfams['tenant_ttft_seconds']
        qfams = record_qos_schema(self.registry)
        self._m_qos_admitted = qfams['qos_admitted_total']
        self._m_qos_rejected = qfams['qos_rejected_total']
        self._m_qos_bucket = qfams['qos_token_bucket_level']
        self._m_qos_ttft = qfams['qos_ttft_seconds']
        self._n_rejected = 0
        self._labeler = _events.TenantLabeler()
        self._model_labeler = _events.ModelLabeler()
        # wide-event log, cached at construction like the tracer
        self.events = _events.default_request_log()
        self.pool = []                      # never shrinks; index == id
        self._pending = collections.deque()
        self._ttfts = collections.deque(maxlen=4096)   # (t, ttft_s)
        # per-tenant TTFT windows for premium-burn autoscaling (bounded:
        # labeler caps tenant cardinality, deque caps window length)
        self._tenant_ttfts = {}             # label -> deque of (t, ttft_s)
        self.failover_log = []
        self._started = False
        # fleet telemetry (attach_fleet): replicas self-register as
        # in-proc scrape targets; burn_source, when set, replaces the
        # local TTFT window in autoscale_tick so the policy can act on
        # the FEDERATED burn (e.g. alerts.federated_burn_source) —
        # a gateway that only sees its own TTFTs under-scales when the
        # SLO is burning elsewhere in the fleet.
        self._fleet = None
        self.burn_source = None
        with self._lock:
            for _ in range(int(replicas)):
                self._add_replica_locked()

    # ---- front door ---------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, stream=False, tenant=None,
               priority=None, model=None, **sampling):
        """Accept one request; returns the GatewayRequest handle.
        Raises ValueError for requests no replica could EVER admit (the
        engines' front-door guard) — those must fail the caller, not
        trip failover.

        `tenant` and `priority` fold into the sampling dict so a
        failover re-submit carries them: attribution and scheduling
        class survive replica loss by construction. `priority` defaults
        from the admission policy's tenant class (0 without one).
        `model` rides the same way (routed like tenant: the router
        prefers replicas already hosting it, the wide event records it);
        None means the deployment's single/default model.

        With an admission policy, a shed request comes back as an
        already-finished handle (`error` set, outcome='rejected' in the
        wide event) — never an exception: overload is data."""
        adm = self.admission
        if priority is None:
            priority = adm.priority_of(tenant) if adm is not None else 0
        sampling = dict(sampling, max_new_tokens=max_new_tokens,
                        tenant=tenant, priority=int(priority))
        if model is not None:
            sampling['model'] = model
        gw = GatewayRequest(prompt, sampling, stream=stream)
        with self._lock:
            gw.arrival_t = self._clock()
            if adm is not None:
                label = self._labeler.label(tenant)
                ok, reason = adm.admit(gw.arrival_t, label)
                lvl = adm.bucket_level(label, gw.arrival_t)
                if lvl is not None:
                    self._m_qos_bucket.labels(label).set(lvl)
                if not ok:
                    self._reject_locked(gw, reason)
                    return gw
                gw._qos_label = label
                self._m_qos_admitted.labels(label).inc()
            try:
                routed = self._route_locked(gw)  # ValueError: inadmissible
            except ValueError:
                self._qos_finish_locked(gw)
                raise
            self._m_requests.inc()
            if not routed:
                self._park_locked(gw)
            self._m_queue.set(len(self._pending))
        return gw

    def _park_locked(self, gw):
        """Queue gw for the next drain. With a bounded queue
        (admission.max_pending) an overflow sheds the lowest-priority
        request — the newest of the lowest class already parked if one
        sits strictly below gw, else gw itself."""
        adm = self.admission
        cap = None if adm is None else adm.max_pending
        if cap is not None and len(self._pending) >= cap:
            p_new = gw.sampling.get('priority') or 0
            victim = None
            for g in self._pending:      # keep the newest among equals
                pg = g.sampling.get('priority') or 0
                if pg < p_new and (victim is None or pg <=
                                   (victim.sampling.get('priority') or 0)):
                    victim = g
            if victim is None:
                self._reject_locked(gw, 'queue_full')
                return
            self._pending.remove(victim)
            self._reject_locked(victim, 'queue_full')
        self._pending.append(gw)

    def _reject_locked(self, gw, reason):
        """Finish gw as shed: exactly one wide event (outcome
        'rejected'), error set, stream closed, admission slot (if one
        was taken — queue sheds were admitted) released."""
        self._m_qos_rejected.labels(
            reason, self._labeler.label(gw.sampling.get('tenant'))).inc()
        self._n_rejected += 1
        self._qos_finish_locked(gw)
        gw.error = RuntimeError('rejected: %s' % reason)
        if gw._stream_q is not None:
            gw._stream_q.put(None)
        self._emit_wide_event_locked(gw, 'rejected')
        gw._finished.set()

    def _qos_finish_locked(self, gw):
        """Release gw's admission concurrency slot, exactly once."""
        if gw._qos_label is not None and self.admission is not None:
            self.admission.finish(gw._qos_label)
            gw._qos_label = None

    def generate(self, prompts, **sampling):
        """Blocking batch door, mirroring the engines' generate()."""
        reqs = [self.submit(p, **sampling) for p in prompts]
        if self._started:
            for r in reqs:
                r.wait()
        else:
            self.run()
        return [r.tokens for r in reqs]

    # ---- routing ------------------------------------------------------

    def _route_locked(self, gw):
        """Place gw on the first accepting candidate; False if none.
        A transport failure during placement counts as a retry AND a
        replica loss (in-proc transports don't blip — see replica.py),
        so one walk both fails over the dead replica's in-flight work
        and still places gw if anyone is left."""
        model = gw.sampling.get('model')
        if hasattr(self.router, 'candidates_for_request'):
            # request-aware routing (e.g. fabric.PrefixAffinityRouter):
            # the router sees the PROMPT, which candidates() never does
            candidates = self.router.candidates_for_request(self.pool, gw)
        elif model is not None and hasattr(self.router, 'candidates_for'):
            candidates = self.router.candidates_for(self.pool, model)
        else:
            candidates = self.router.candidates(self.pool)
        with self._tracer.start_span(
                'gateway.route', tags={'request_id': gw.id}) as span:
            for rep in candidates:
                if not rep.routable():     # lost earlier in this walk
                    continue
                try:
                    eng_req = rep.submit(gw.prompt, **gw.sampling)
                except ValueError:
                    raise                  # inadmissible — caller's error
                except Exception as exc:   # noqa: BLE001 — transport
                    self._m_retries.inc()
                    self._lost_locked(rep, exc)
                    continue
                rep.breaker.record_success()
                rep.assigned[gw] = eng_req
                gw._eng_req = eng_req
                gw.replica_history.append(rep.index)
                self._m_route.labels(str(rep.index)).inc()
                note = getattr(self.router, 'note_placement', None)
                if note is not None:
                    # feed the prefix directory on EVERY placement,
                    # failover re-placements included — the hint table
                    # tracks where the tokens actually went
                    note(gw.prompt, rep.index)
                span.set_tag('replica', rep.index)
                if gw.failovers and eng_req._span is not None:
                    # force-retain the replacement trace: a failed-over
                    # request's span tree must be retrievable from the
                    # wide event's trace_id no matter how fast it ran
                    ret = self._tracer.retention
                    if ret is not None:
                        ret.mark(eng_req._span.trace_id, 'failover')
                rep.wake()
                return True
            span.set_tag('replica', -1)
            return False

    def _drain_pending_locked(self):
        adm = self.admission
        if adm is not None and self._pending:
            if adm.max_queue_wait_s is not None:
                # deadline-aware shedding: a request parked past the
                # deadline will blow its SLO anyway — shed it now and
                # spend the capacity on fresher work
                now = self._clock()
                keep = collections.deque()
                while self._pending:
                    gw = self._pending.popleft()
                    if now - gw.arrival_t > adm.max_queue_wait_s:
                        self._reject_locked(gw, 'deadline')
                    else:
                        keep.append(gw)
                self._pending = keep
            if len(self._pending) > 1:
                # drain best-first; sorted() is stable, so FIFO holds
                # within a priority class
                self._pending = collections.deque(sorted(
                    self._pending,
                    key=lambda g: -(g.sampling.get('priority') or 0)))
        while self._pending:
            gw = self._pending.popleft()
            try:
                routed = self._route_locked(gw)
            except ValueError as exc:
                # a request parked while NO replica was routable turns
                # out inadmissible once one is: fail it out-of-band (the
                # submit() caller is long gone) instead of crashing the
                # driver thread that happened to drain the queue
                gw.error = exc
                if gw._stream_q is not None:
                    gw._stream_q.put(None)
                self._emit_wide_event_locked(gw, 'error')
                gw._finished.set()
                continue
            if not routed:
                self._pending.appendleft(gw)
                break
        self._m_queue.set(len(self._pending))

    # ---- failover -----------------------------------------------------

    def _lost_locked(self, rep, exc):
        """rep's transport failed: open its breaker, mark it dead, and
        re-admit every in-flight request elsewhere. Idempotent per
        replica (drivers and routing walks may both observe the loss)."""
        if not rep.alive:
            return
        opened = rep.breaker.record_failure()
        rep.mark_dead()
        victims = []
        for gw in list(rep.assigned):
            if len(gw.tokens) >= gw.sampling['max_new_tokens']:
                self._complete_locked(gw)   # fully delivered already
            else:
                victims.append(gw)
        rep.assigned.clear()
        self.failover_log.append({
            'replica': rep.index, 'error': repr(exc),
            'requests': [g.id for g in victims]})
        with self._tracer.start_span(
                'gateway.failover',
                tags={'from_replica': rep.index,
                      'requests': len(victims),
                      'breaker_opened': bool(opened)}):
            for gw in victims:
                self._m_failover.inc()
                gw.failovers += 1    # before routing: the replacement
                gw._eng_req = None   # trace gets the failover mark
                if not self._route_locked(gw):
                    self._pending.append(gw)
        self._m_queue.set(len(self._pending))
        self._refresh_gauges_locked()

    def kill_replica(self, index):
        """Declare replica `index` lost (the non-chaos failover door —
        tests and operators; chaos.partition exercises the same path
        through the transport hooks)."""
        with self._lock:
            rep = self.pool[index]
            self._lost_locked(rep, RuntimeError('replica killed'))
            return rep

    def drain_replica(self, index):
        """Gracefully drain replica `index`: no new admissions, its
        in-flight requests finish and deliver."""
        with self._lock:
            rep = self.pool[index]
            if rep.state == READY:
                rep.drain()
                self._refresh_gauges_locked()
            return rep

    # ---- hot-swap -----------------------------------------------------

    def rollout(self, model, new_version):
        """Zero-downtime version swap for `model` across the pool.

        Three phases, ordered so no request is ever lost:

        1. **Warm.** Every routable multi-model replica (its engine is a
           registry.ModelHost) loads + pins the new version NEXT TO the
           old one — a warm bring-up that must hit the compile cache
           (same program shapes, new weights; in the port a cache miss is
           a kernel build, and the engines build none). In-flight requests
           on the old version keep their weights: they hold refcounts.
        2. **Flip.** Each distinct ModelRegistry's serving pointer moves
           to `new_version` atomically — from this instant every new
           submit(model=...) resolves to the new version.
        3. **Drain.** The old version is unpinned and evicted ONCE its
           refcount drops to zero (deferred eviction — the
           drain-never-kill discipline applied to weights instead of
           replicas). Nothing is cancelled.

        Returns a summary dict; `cache_hits`/`cache_misses` are the
        compile-cache delta across all warm loads (a correct rollout
        warms entirely from cache). Raises ValueError when no replica
        hosts models (the pool is single-model) or the version is
        unknown."""
        with self._lock:
            hosts = [r for r in self.pool if r.routable()
                     and hasattr(r.engine, 'prepare_rollout')]
        if not hosts:
            raise ValueError('no routable replica hosts models — '
                             'rollout needs ModelHost-backed replicas')
        with self._tracer.start_span(
                'gateway.rollout',
                tags={'model': model, 'version': new_version,
                      'replicas': len(hosts)}):
            registries = []
            for r in hosts:
                reg = r.engine.registry
                if all(reg is not g for g in registries):
                    registries.append(reg)
            old = registries[0].serving_version(model)
            infos = [r.engine.prepare_rollout(model, new_version)
                     for r in hosts]
            for reg in registries:
                reg.set_serving(model, new_version)
            for r in hosts:
                r.engine.finish_rollout(model, old)
        return {
            'model': model,
            'from_version': old,
            'to_version': new_version,
            'replicas': [r.index for r in hosts],
            'cache_hits': sum(i.get('cache_hits', 0) for i in infos),
            'cache_misses': sum(i.get('cache_misses', 0) for i in infos),
            'load_s': sum(i.get('load_s', 0.0) for i in infos),
        }

    # ---- delivery -----------------------------------------------------

    def _collect(self, rep):
        """Driver/step callback: forward newly generated tokens."""
        with self._lock:
            self._collect_locked(rep)
            self._drain_pending_locked()

    def _collect_locked(self, rep):
        now = self._clock()
        for gw, er in list(rep.assigned.items()):
            new = er.tokens[len(gw.tokens):]
            if new:
                if not gw.tokens:
                    gw.first_token_t = now
                    ttft = now - gw.arrival_t
                    self._m_ttft.observe(ttft)
                    label = self._labeler.label(
                        gw.sampling.get('tenant'))
                    self._m_tenant_ttft.labels(label).observe(ttft)
                    self._m_qos_ttft.labels(
                        str(gw.sampling.get('priority') or 0)).observe(
                            ttft)
                    self._ttfts.append((now, ttft))
                    win = self._tenant_ttfts.get(label)
                    if win is None:
                        win = self._tenant_ttfts[label] = \
                            collections.deque(maxlen=1024)
                    win.append((now, ttft))
                gw.tokens.extend(new)
                if gw._stream_q is not None:
                    for t in new:
                        gw._stream_q.put(t)
                self._m_tokens.inc(len(new))
            if er.done and len(gw.tokens) >= len(er.tokens):
                del rep.assigned[gw]
                # a terminal engine-side outcome (e.g. 'preempted' when
                # max_preempts ran out) surfaces through the gateway's
                # canonical event
                self._complete_locked(
                    gw, getattr(er, 'outcome', None) or 'ok')

    def _complete_locked(self, gw, outcome='ok'):
        self._qos_finish_locked(gw)
        if gw._stream_q is not None:
            gw._stream_q.put(None)
        self._m_tenant_requests.labels(self._labeler.label(
            gw.sampling.get('tenant'))).inc()
        self._emit_wide_event_locked(gw, outcome)
        gw._finished.set()
        self._m_completed.inc()

    def _emit_wide_event_locked(self, gw, outcome):
        """THE canonical record for a gateway-managed request. Engine
        events are suppressed at replica.submit (emit_event=False), so
        exactly one event per submitted request exists no matter how
        many replicas it traversed; failovers/replicas carry the part
        only the gateway knows. Per-request fields (prefill chunks, KV
        page-seconds, spec counts) come from the FINAL engine request —
        a dead replica's partial window is gone with the replica.

        Instrumentation attrs are read with getattr defaults: the
        replica contract only requires tokens/done on engine requests,
        so a duck-typed engine without the serving internals still gets
        a (sparser) event rather than an AttributeError."""
        log = self.events
        if not log.enabled:
            return
        er = gw._eng_req
        span = getattr(er, '_span', None)
        trace_id = None if span is None else span.trace_id
        admit_t = getattr(er, '_admit_t', None)
        wait = None
        if admit_t is not None:
            # both clocks default to time.monotonic; with an injected
            # gateway clock this degrades to engine-side wait only
            wait = admit_t - (gw.arrival_t if self._clock
                              is time.monotonic
                              else getattr(er, '_arrival_t', admit_t))
        log.emit(
            request_id=gw.id,
            tenant=self._labeler.label(gw.sampling.get('tenant')),
            model=self._model_labeler.label(gw.sampling.get('model')),
            priority=gw.sampling.get('priority', 0),
            trace_id=trace_id,
            arrival_t=gw.arrival_t,
            admit_t=admit_t,
            first_token_t=gw.first_token_t,
            finish_t=self._clock(),
            queue_wait_s=wait,
            prefill_chunks=getattr(er, '_prefill_chunks', 0),
            prompt_tokens=len(gw.prompt),
            output_tokens=len(gw.tokens),
            prefix_hit_tokens=getattr(er, '_prefix_hit', 0),
            spec_proposed=getattr(er, '_spec_proposed', 0),
            spec_accepted=getattr(er, '_spec_accepted', 0),
            kv_page_seconds=getattr(er, 'kv_page_seconds', 0.0),
            failovers=gw.failovers,
            replicas=list(gw.replica_history),
            outcome=outcome)

    # ---- drive: sync mode ---------------------------------------------

    def step(self):
        """One synchronous pass (no driver threads): step every replica
        with work, collect, drain the parked queue. Returns the number
        of gateway requests still outstanding — the deterministic drive
        loop tests and benches use."""
        if self._started:
            raise RuntimeError('gateway is running driver threads; '
                               'sync step() would race them')
        with self._lock:
            reps = [r for r in self.pool if r.alive]
        for rep in reps:
            with self._lock:
                has_work = bool(rep.assigned) \
                    or bool(rep.engine.scheduler.pending)
            if not has_work:
                continue
            try:
                rep.step()
            except Exception as exc:   # noqa: BLE001 — transport
                with self._lock:
                    self._lost_locked(rep, exc)
                continue
            self._collect(rep)
        with self._lock:
            for rep in reps:
                if rep.state == DRAINING and not rep.assigned \
                        and not rep.engine.scheduler.pending:
                    rep.mark_stopped()
            self._refresh_gauges_locked()
            self._drain_pending_locked()
            return len(self._pending) + sum(
                len(r.assigned) for r in self.pool)

    def run(self):
        """Drive synchronously until every accepted request finished."""
        while self.step():
            pass

    # ---- drive: threaded mode -----------------------------------------

    def start(self):
        """Spawn one driver thread per live replica; submit() callers
        then just wait() on their handles."""
        with self._lock:
            if self._started:
                return self
            self._started = True
            for rep in self.pool:
                if rep.alive:
                    rep.start_driver(self._collect, self._on_lost)
        return self

    def _on_lost(self, rep, exc):
        with self._lock:
            self._lost_locked(rep, exc)

    def shutdown(self, timeout=10.0):
        """Graceful stop: drain every replica, join the drivers."""
        with self._lock:
            reps = list(self.pool)
            for rep in reps:
                if rep.state == READY:
                    rep.drain()
            self._refresh_gauges_locked()
        for rep in reps:
            rep.join(timeout)
        with self._lock:
            self._started = False
            self._refresh_gauges_locked()

    # ---- autoscaling --------------------------------------------------

    def autoscale_tick(self, now=None):
        """One policy evaluation + application. Call it on whatever
        cadence fits (a scrape loop, a timer thread, a test's fake
        clock); the policy's own hysteresis makes the cadence safe."""
        if self.policy is None:
            return Decision(0, 'no autoscaler policy configured')
        now = self._clock() if now is None else now
        with self._lock:
            if self.burn_source is not None:
                burn = float(self.burn_source(now))
            else:
                burn = slo_burn_rate(self._ttfts, now,
                                     self.policy.slo_ttft_s,
                                     self.policy.window_s)
            self._m_burn.set(burn)
            ready = [r for r in self.pool if r.state == READY]
            occ = (sum(r.occupancy() for r in ready) / len(ready)
                   if ready else 0.0)
            depth = len(self._pending) + sum(
                int(r.queue_depth()) for r in ready)
            if getattr(self.policy, 'premium_tenants', None):
                # per-tenant burn: the policy scales up when a premium
                # tenant is burning even while the aggregate looks fine.
                # Passed as a kwarg only when configured, so policies
                # with the positional-only decide() keep working.
                tenant_burns = {
                    label: slo_burn_rate(win, now,
                                         self.policy.slo_ttft_s,
                                         self.policy.window_s)
                    for label, win in self._tenant_ttfts.items()}
                decision = self.policy.decide(now, burn, occ, depth,
                                              len(ready),
                                              tenant_burns=tenant_burns)
            else:
                decision = self.policy.decide(now, burn, occ, depth,
                                              len(ready))
            if decision.delta > 0:
                self._add_replica_locked()
                self._m_scale.labels('up').inc()
            elif decision.delta < 0 and ready:
                victim = min(ready, key=lambda r: (r.load(), r.index))
                victim.drain()
                self._m_scale.labels('down').inc()
                self._refresh_gauges_locked()
            return decision

    # ---- fleet telemetry ----------------------------------------------

    def attach_fleet(self, collector):
        """Register every replica's private registry as an in-proc
        scrape target on `collector` (a monitor.federation
        FleetCollector); replicas added later by the autoscaler
        self-register. The collector's merged view then carries every
        replica's serving_* families with an `instance` label — the
        cross-replica occupancy/queue picture one registry per replica
        was built to preserve (see replica.py)."""
        with self._lock:
            self._fleet = collector
            for rep in self.pool:
                self._fleet_register_locked(rep)
        return collector

    def _fleet_register_locked(self, rep):
        if self._fleet is None:
            return
        # idempotent: re-attach / re-add keeps the same instance name.
        # The transport picks HOW it is scraped: in-proc replicas hand
        # over their private registry, SocketReplicas hand over the
        # worker process's /metrics.json URL (stale-not-wrong on kill).
        self._fleet.add_target('gw-replica-%d' % rep.index,
                               **rep.scrape_kwargs())

    # ---- pool management ----------------------------------------------

    def adopt_replica(self, rep):
        """Add an externally built ReplicaTransport (e.g. a fabric
        SocketReplica proxying a worker process) to the pool. The
        gateway assigns the pool index; everything downstream —
        routing, failover, QoS, rollout, fleet registration — treats
        it exactly like a factory-built replica."""
        with self._lock:
            rep.index = len(self.pool)
            self.pool.append(rep)
            self._fleet_register_locked(rep)
            if self._started:
                rep.start_driver(self._collect, self._on_lost)
            self._refresh_gauges_locked()
            return rep

    def _add_replica_locked(self):
        if self._factory is None:
            raise RuntimeError('gateway has no engine_factory — scale '
                               'fabric pools by adopting new workers, '
                               'not by local replica construction')
        rep = InprocReplica(len(self.pool), self._factory())
        self.pool.append(rep)
        self._fleet_register_locked(rep)
        if self._started:
            rep.start_driver(self._collect, self._on_lost)
        self._refresh_gauges_locked()
        return rep

    def _refresh_gauges_locked(self):
        alive = 0
        for rep in self.pool:
            self._m_state.labels(str(rep.index)).set(
                STATE_CODES[rep.state])
            if rep.alive:
                alive += 1
        self._m_replicas.set(alive)

    @property
    def replicas_alive(self):
        with self._lock:
            return sum(1 for r in self.pool if r.alive)

    def report(self):
        """Scalar summary for benches (the engines' report() analogue)."""
        with self._lock:
            return {
                'replicas': len(self.pool),
                'replicas_alive': sum(1 for r in self.pool if r.alive),
                'requests': int(self._m_requests.value()),
                'completed': int(self._m_completed.value()),
                'tokens': int(self._m_tokens.value()),
                'failovers': int(self._m_failover.value()),
                'retries': int(self._m_retries.value()),
                'pending': len(self._pending),
                'rejected': self._n_rejected,
            }
