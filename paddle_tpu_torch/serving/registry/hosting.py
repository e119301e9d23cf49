"""ModelHost: per-replica weight paging over a ModelRegistry (counterpart
of paddle_tpu/serving/registry/hosting.py).

One host runs MANY models inside one replica process, paging weights
in and out under a byte budget the way the KV pool pages sequences:

- a resident model is REFCOUNTED like a `kv_cache.PageAllocator` page —
  every queued or in-flight request holds one reference from admission
  to completion, so eviction of a busy model *defers* until its last
  reference drops (never yanks weights out from under a decode), and a
  double-release raises instead of corrupting the count;
- a cold `submit(model=...)` PARKS the request and queues an async
  load: the load runs on the replica's driver thread inside step(),
  never on the gateway's submit/drain path;
- eviction is LRU over unpinned, idle models; `pin()` exempts hot
  models; the byte budget is enforced at load time (evict until it
  fits, else the load waits for references to drop).

The host duck-types as an engine — `add_request` / `step` / `shutdown`,
a scheduler shim with `pending`, settable `metrics`, `rebind_perf` — so
`InprocReplica` and `ServingGateway` drive a multi-model replica with
zero changes. Residency and churn export as the `registry_*` metric
families (monitor/telemetry.py REGISTRY_FAMILIES).

No trace lock. The reference's host takes the process-wide `_TRACE_LOCK`
for a warm bring-up and steps an engine under it while
`engine.trace_counts` shows an untraced program (jax tracing swaps
parameters through the shared model). The port's engines run eagerly,
trace nothing (their `trace_counts` raises) and the model's forward writes
no module state, so the host has neither the lock nor the check: its
warm-up is a 2-token generate under torch.no_grad, and
`program_trace_counts()` raises NotImplementedError. The compile-cache
delta a warm load reports counts the port's kernel builds
(framework/compile_cache.py): the engines launch no kernel, so a warm
bring-up reads 0 / 0.

The port's InprocReplica moves an engine onto its private registry with
`rebind_perf(registry)` alone, so the host's `rebind_perf` moves the
host's serving metrics and `registry_*` families too (the reference's
replica also assigns `metrics`).
"""
import queue as _queue
import threading
import time
from collections import deque

import torch

from ...framework import compile_cache
from ...monitor.telemetry import record_registry_schema
from ..metrics import ServingMetrics
from ..scheduler import Request

__all__ = ['ModelHost', 'HostedModel']


class HostedModel:
    """One resident (model, version): the engine holding its weights
    plus the paging bookkeeping (refcount, pin, LRU stamp)."""

    __slots__ = ('entry', 'engine', 'refs', 'pinned', 'evict_pending',
                 'last_used')

    def __init__(self, entry, engine, pinned=False):
        self.entry = entry
        self.engine = engine
        self.refs = 0
        self.pinned = bool(pinned)
        self.evict_pending = False
        self.last_used = 0.0

    @property
    def key(self):
        return self.entry.key

    def __repr__(self):
        return ('HostedModel(%r, %r, refs=%d, pinned=%s, evict_pending=%s)'
                % (self.entry.model, self.entry.version, self.refs,
                   self.pinned, self.evict_pending))


class _HostScheduler:
    """Engine-shaped scheduler view over the whole host: parked
    requests plus every resident engine's own queue/residency — what
    the replica driver loop and queue-depth gauges read."""

    def __init__(self, host):
        self._host = host

    @property
    def pending(self):
        h = self._host
        with h._lock:
            return len(h._parked) + sum(
                hm.engine.scheduler.pending
                for hm in h._resident.values())

    @property
    def queue(self):
        h = self._host
        with h._lock:
            out = [req for _, req in h._parked]
            for hm in h._resident.values():
                out.extend(hm.engine.scheduler.queue)
            return tuple(out)


class ModelHost:
    """Engine-duck-typed multi-model replica over a ModelRegistry.

    `engine_factory(entry)` builds a ready engine for one registry
    entry (loading the artifact's weights is its job — the host only
    decides WHEN and accounts the bytes). `byte_budget` caps resident
    artifact bytes (None: unlimited); `max_len` enables the engines'
    front-door capacity guard before any engine exists.
    """

    def __init__(self, registry, engine_factory, byte_budget=None,
                 max_len=None, default_model=None, clock=None):
        self.registry = registry
        self._factory = engine_factory
        self.byte_budget = None if byte_budget is None else int(byte_budget)
        self.max_len = None if max_len is None else int(max_len)
        self.default_model = default_model
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._resident = {}       # (model, version) -> HostedModel
        self._parked = deque()    # (key, Request) awaiting a load
        self._want = deque()      # keys queued for async load
        self._want_set = set()
        self._loading = set()     # keys being built outside the lock
        self._inflight = {}       # req.id -> (key, Request): refs held
        self._use_seq = 0
        self._closed = False
        self._perf_registry = None
        self.scheduler = _HostScheduler(self)
        self._metrics = None
        self.metrics = ServingMetrics(clock=clock)

    # ---- engine-contract surface --------------------------------------

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, m):
        """The replica rebind point: moving the host onto a private
        registry re-registers the registry_* families there and carries
        every resident engine along (the InprocReplica pattern)."""
        self._metrics = m
        fams = record_registry_schema(m.registry)
        self._m_resident_bytes = fams['registry_resident_bytes']
        self._m_models = fams['registry_models_resident']
        self._m_loads = fams['registry_loads_total']
        self._m_evictions = fams['registry_evictions_total']
        self._m_deferred = fams['registry_evictions_deferred_total']
        self._m_load_s = fams['registry_load_seconds']
        self._m_warm_hits = fams['registry_warm_load_cache_hits_total']
        self._m_warm_misses = fams['registry_warm_load_cache_misses_total']
        self._m_rollouts = fams['registry_rollouts_total']
        with self._lock:
            for hm in self._resident.values():
                hm.engine.metrics = ServingMetrics(registry=m.registry)

    def rebind_perf(self, registry):
        """Move the host's serving metrics and registry_* families, and
        every resident engine's metrics and step timeline, onto
        `registry`; engines built later follow."""
        with self._lock:
            self._perf_registry = registry
            self.metrics = ServingMetrics(registry=registry)
            for hm in self._resident.values():
                hm.engine.rebind_perf(registry)
        return self

    @property
    def num_slots(self):
        with self._lock:
            return sum(hm.engine.num_slots
                       for hm in self._resident.values())

    def shutdown(self):
        with self._lock:
            self._closed = True
            for hm in self._resident.values():
                hm.engine.shutdown()

    # ---- front door ---------------------------------------------------

    def add_request(self, prompt, max_new_tokens=32, temperature=1.0,
                    top_k=0, do_sample=False, seed=0, stream=False,
                    tenant=None, priority=0, model=None, version=None,
                    emit_event=True):
        """Queue one request against `model` (the host's default_model,
        or the sole registered model, when omitted). `version=None`
        resolves the registry's serving pointer AT SUBMISSION — the
        hot-swap contract: requests accepted before a rollout flip keep
        the old version, requests after it get the new one.

        A miss parks the request and queues an async load for step();
        it never loads inline, so the caller (the gateway's routing
        walk) returns immediately."""
        if model is None:
            model = self.default_model
        if model is None:
            models = self.registry.models()
            if len(models) != 1:
                raise ValueError(
                    'multi-model host needs model=... (registered: %s)'
                    % models)
            model = models[0]
        entry = self.registry.resolve(model, version)
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k,
                      do_sample=do_sample, seed=seed, tenant=tenant,
                      priority=priority, model=model)
        req._emit_event = bool(emit_event)
        if stream:
            req._stream_q = _queue.Queue()
        # the engines' shared front-door guard, verbatim, so impossible
        # requests fail here even before their model's engine exists
        worst = len(req.prompt) + req.max_new_tokens - 1
        if self.max_len and len(req.prompt) and worst > self.max_len:
            raise ValueError(
                'request cannot ever be admitted: prompt of %d tokens + '
                'max_new_tokens=%d needs %d cache rows but max_len=%d'
                % (len(req.prompt), req.max_new_tokens, worst,
                   self.max_len))
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    'engine is shut down — it no longer admits requests')
            req._arrival_t = self.metrics.now()
            hm = self._resident.get(entry.key)
            if hm is not None and not hm.evict_pending:
                self._enqueue_locked(hm, req)
            else:
                self._parked.append((entry.key, req))
                if entry.key not in self._want_set:
                    self._want.append(entry.key)
                    self._want_set.add(entry.key)
        return req

    def generate(self, prompts, **sampling):
        reqs = [self.add_request(p, **sampling) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]

    def run(self):
        while self.step():
            pass

    # ---- residency ----------------------------------------------------

    def hosts_model(self, model, version=None):
        """Is (model, version) resident and servable? version=None
        matches any — the router's affinity question."""
        with self._lock:
            for hm in self._resident.values():
                if hm.evict_pending:
                    continue
                if hm.entry.model == model and \
                        (version is None or hm.entry.version == version):
                    return True
            return False

    def resident_models(self):
        with self._lock:
            return sorted(self._resident)

    @property
    def resident_bytes(self):
        with self._lock:
            return sum(hm.entry.nbytes for hm in self._resident.values())

    def refcount(self, model, version):
        with self._lock:
            hm = self._resident.get((model, version))
            return 0 if hm is None else hm.refs

    def load(self, model, version=None, pin=False, warm=False):
        """Synchronously bring (model, version) resident; returns a
        load-info dict. `warm=True` runs a tiny generate and reports the
        persistent-compile-cache delta (kernel builds in the port) — the
        rollout bring-up proof. Raises RuntimeError when
        the byte budget cannot be met (nothing evictable)."""
        entry = self.registry.resolve(model, version)
        with self._lock:
            while entry.key in self._loading:
                self._cv.wait(0.01)     # driver thread building it
            hm = self._resident.get(entry.key)
            if hm is not None:
                hm.evict_pending = False
                if pin:
                    hm.pinned = True
                return {'loaded': False, 'model': entry.model,
                        'version': entry.version,
                        'fingerprint': entry.fingerprint,
                        'cache_hits': 0, 'cache_misses': 0,
                        'load_s': 0.0}
            if not self._make_room_locked(entry.nbytes):
                raise RuntimeError(
                    'byte budget %d cannot admit %r (%d bytes): %d bytes '
                    'resident and nothing evictable (all pinned or '
                    'referenced)' % (self.byte_budget, entry.key,
                                     entry.nbytes, self._bytes_locked()))
            self._loading.add(entry.key)
        try:
            hm, info = self._build(entry, warm=warm, pin=pin)
        finally:
            with self._lock:
                self._loading.discard(entry.key)
                self._cv.notify_all()
        with self._lock:
            self._install_locked(hm)
        return info

    def pin(self, model, version=None):
        entry = self.registry.resolve(model, version)
        with self._lock:
            hm = self._resident.get(entry.key)
            if hm is None:
                raise KeyError('%r is not resident' % (entry.key,))
            hm.pinned = True

    def unpin(self, model, version=None):
        entry = self.registry.resolve(model, version)
        with self._lock:
            hm = self._resident.get(entry.key)
            if hm is not None:
                hm.pinned = False

    def evict(self, model, version):
        """Page (model, version) out. With live references the eviction
        DEFERS — flagged now, completed when the last reference drops —
        so an in-flight request never loses its weights. Returns True
        when evicted immediately, False when deferred."""
        with self._lock:
            hm = self._resident.get((model, version))
            if hm is None:
                raise KeyError('(%r, %r) is not resident'
                               % (model, version))
            if hm.pinned:
                raise ValueError('(%r, %r) is pinned — unpin before '
                                 'evicting' % (model, version))
            return self._evict_or_defer_locked(hm)

    def acquire(self, model, version):
        """Take one reference on a resident model (what admission does
        internally) — the test door for the refcount contract."""
        with self._lock:
            hm = self._resident.get((model, version))
            if hm is None:
                raise KeyError('(%r, %r) is not resident'
                               % (model, version))
            hm.refs += 1
            return hm.refs

    def release(self, model, version):
        """Drop one reference; completes a deferred eviction at zero.
        Releasing a model that holds no references raises — a silent
        double-release here would let a deferred eviction fire while a
        request still decodes on the weights, the exact corruption the
        PageAllocator's double-free rule exists to prevent."""
        with self._lock:
            hm = self._resident.get((model, version))
            if hm is None or hm.refs <= 0:
                raise ValueError(
                    'model (%r, %r) holds no references (double-release, '
                    'or never acquired)' % (model, version))
            self._release_locked(hm)
            return hm.refs

    # ---- hot-swap (gateway.rollout drives these) ----------------------

    def prepare_rollout(self, model, version):
        """Warm-load and pin the incoming version; returns the load
        info (compile-cache delta included)."""
        return self.load(model, version, pin=True, warm=True)

    def finish_rollout(self, model, old_version):
        """Retire the outgoing version: unpin + evict (deferred while
        its in-flight requests finish — drain, never kill)."""
        self._m_rollouts.labels(self.metrics.model_label(model)).inc()
        if old_version is None:
            return True
        with self._lock:
            hm = self._resident.get((model, old_version))
            if hm is None:
                return True
            hm.pinned = False
            return self._evict_or_defer_locked(hm)

    # ---- drive --------------------------------------------------------

    def step(self):
        """One host iteration: service queued loads, admit parked
        requests whose model came resident, step every engine with
        work, release references for finished requests (completing any
        deferred evictions), refresh gauges. Returns requests still
        pending anywhere in the host."""
        self._process_loads()
        with self._lock:
            keep = deque()
            while self._parked:
                key, req = self._parked.popleft()
                hm = self._resident.get(key)
                if hm is not None and not hm.evict_pending:
                    self._enqueue_locked(hm, req)
                else:
                    keep.append((key, req))
            self._parked = keep
            engines = [hm.engine for hm in self._resident.values()
                       if hm.engine.scheduler.pending]
        for eng in engines:
            eng.step()
        with self._lock:
            done = [rid for rid, (_, req) in self._inflight.items()
                    if req.done]
            for rid in done:
                key, _ = self._inflight.pop(rid)
                hm = self._resident.get(key)
                if hm is not None:
                    self._release_locked(hm)
            self._refresh_gauges_locked()
            pending = len(self._parked) + sum(
                hm.engine.scheduler.pending
                for hm in self._resident.values())
            if pending and not engines and not self._inflight \
                    and not self._want_progress_possible_locked():
                raise RuntimeError(
                    'weight paging deadlock: %d requests parked but the '
                    'byte budget (%s) cannot admit their models and no '
                    'in-flight work can free references'
                    % (len(self._parked), self.byte_budget))
            return pending

    def program_trace_counts(self):
        """{(model, version): engine.trace_counts} in the reference. Not
        ported: the port's engines run eagerly and trace nothing."""
        raise NotImplementedError(
            'program_trace_counts() is not ported: the eager engines trace '
            'nothing; its counterpart comes with a CUDA-graph decode step')

    # ---- internals (lock held unless noted) ---------------------------

    def _enqueue_locked(self, hm, req):
        hm.refs += 1
        self._inflight[req.id] = (hm.key, req)
        self._use_seq += 1
        hm.last_used = self._use_seq
        hm.engine.enqueue(req)

    def _release_locked(self, hm):
        hm.refs -= 1
        if hm.refs == 0 and hm.evict_pending:
            self._evict_locked(hm)

    def _evict_or_defer_locked(self, hm):
        if hm.refs > 0:
            if not hm.evict_pending:
                hm.evict_pending = True
                self._m_deferred.inc()
            return False
        self._evict_locked(hm)
        return True

    def _evict_locked(self, hm):
        del self._resident[hm.key]
        hm.engine.shutdown()
        self._m_evictions.labels(
            self.metrics.model_label(hm.entry.model)).inc()
        self._refresh_residency_locked()

    def _bytes_locked(self):
        return sum(hm.entry.nbytes for hm in self._resident.values())

    def _make_room_locked(self, need):
        """Evict LRU idle unpinned models until `need` more bytes fit
        the budget; False when they cannot."""
        if self.byte_budget is None:
            return True
        while self._bytes_locked() + need > self.byte_budget:
            victims = [hm for hm in self._resident.values()
                       if not hm.pinned and hm.refs == 0]
            if not victims:
                return False
            self._evict_locked(min(victims, key=lambda h: h.last_used))
        return True

    def _want_progress_possible_locked(self):
        """Could any queued load ever be admitted as things stand?"""
        for key in self._want:
            if key in self._resident:
                return True
            entry = self.registry.entry(*key)
            if self.byte_budget is None or \
                    self._bytes_locked() + entry.nbytes <= self.byte_budget:
                return True
            if any(not hm.pinned and hm.refs == 0
                   for hm in self._resident.values()):
                return True
        return not self._want

    def _process_loads(self):
        """Drain the async load queue (driver thread). The engine build
        runs OUTSIDE the host lock so submissions keep flowing during a
        multi-second weight load; budget-blocked keys stay queued and
        retry next step, after completions have dropped references."""
        while True:
            with self._lock:
                if not self._want:
                    return
                key = self._want[0]
                hm = self._resident.get(key)
                if hm is not None:
                    # an eviction raced the re-request: cancel it
                    hm.evict_pending = False
                    self._want.popleft()
                    self._want_set.discard(key)
                    continue
                if key in self._loading:
                    self._want.popleft()
                    self._want_set.discard(key)
                    continue
                entry = self.registry.entry(*key)
                if not self._make_room_locked(entry.nbytes):
                    return          # blocked: retry next step
                self._want.popleft()
                self._want_set.discard(key)
                self._loading.add(key)
            try:
                hm, _ = self._build(entry)
            finally:
                with self._lock:
                    self._loading.discard(key)
                    self._cv.notify_all()
            with self._lock:
                self._install_locked(hm)

    def _build(self, entry, warm=False, pin=False):
        """Construct the engine for `entry` (no host lock held) and
        account the load. The warm-up needs no lock: the eager forward
        writes no module state."""
        t0 = self._clock()
        before = compile_cache.stats()
        engine = self._factory(entry)
        engine.metrics = ServingMetrics(
            registry=self._metrics.registry)
        if self._perf_registry is not None:
            engine.rebind_perf(self._perf_registry)
        if warm:
            with torch.no_grad():
                engine.generate([[0, 0]], max_new_tokens=2,
                                emit_event=False)
        after = compile_cache.stats()
        load_s = self._clock() - t0
        hits = after['hits'] - before['hits']
        misses = after['misses'] - before['misses']
        label = self.metrics.model_label(entry.model)
        self._m_loads.labels(label).inc()
        self._m_load_s.observe(load_s)
        if warm:
            if hits:
                self._m_warm_hits.inc(hits)
            if misses:
                self._m_warm_misses.inc(misses)
        hm = HostedModel(entry, engine, pinned=pin)
        info = {'loaded': True, 'model': entry.model,
                'version': entry.version,
                'fingerprint': entry.fingerprint,
                'cache_hits': hits, 'cache_misses': misses,
                'load_s': load_s}
        return hm, info

    def _install_locked(self, hm):
        self._use_seq += 1
        hm.last_used = self._use_seq
        self._resident[hm.key] = hm
        self._refresh_residency_locked()

    def _refresh_residency_locked(self):
        self._m_resident_bytes.set(self._bytes_locked())
        self._m_models.set(len(self._resident))

    def _refresh_gauges_locked(self):
        hms = list(self._resident.values())
        queued = len(self._parked) + sum(
            len(hm.engine.scheduler.queue) for hm in hms)
        self.metrics.on_queue_depth(queued)
        slots = sum(hm.engine.num_slots for hm in hms)
        if slots:
            # duck-typed engines (test stubs) may lack an allocator —
            # occupancy then reads zero rather than crashing the driver
            self.metrics.on_step(
                sum(getattr(hm.engine, 'allocator', None).in_use
                    if getattr(hm.engine, 'allocator', None) is not None
                    else 0 for hm in hms), slots)
        self._refresh_residency_locked()

    def __repr__(self):
        with self._lock:
            return ('ModelHost(resident=%d, bytes=%d/%s, parked=%d, '
                    'inflight=%d)'
                    % (len(self._resident), self._bytes_locked(),
                       self.byte_budget, len(self._parked),
                       len(self._inflight)))
