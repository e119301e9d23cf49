"""One engine replica behind the gateway: transport shim + lifecycle
(counterpart of paddle_tpu/serving/gateway/replica.py).

An InprocReplica wraps a ContinuousBatchingEngine (or the paged
variant) running in this process and gives it the same *shape* as a
remote worker:

- an endpoint string ('inproc://gw-replica-N') that chaos injectors
  scope to — every submission fires the resilience 'send' hook and
  every completed step fires 'recv', so `chaos.partition(endpoint)`
  black-holes this replica exactly as it would a socket peer;
- a per-endpoint CircuitBreaker (distributed/resilience.py) with
  in-proc defaults: one transport failure means partitioned-or-dead,
  not a blip, so a single strike opens the breaker and the gateway
  replaces rather than retries;
- its OWN MetricRegistry. Engines on the shared default registry would
  collide on the unlabeled serving gauges (last-writer-wins); a private
  registry per replica keeps `serving_queue_depth` / `serving_occupancy`
  honest, which is exactly what the router load-balances on — and what
  `metrics_server()` exposes for a real per-replica scrape.

Lifecycle: READY -> DRAINING (no new admissions, in-flight decode
finishes) -> STOPPED, or -> DEAD on transport loss. The gateway owns
all transitions except DRAINING -> STOPPED, which the driver thread
takes when the drained engine runs empty. The ladder, condvar
discipline and driver loop live in the base class
(serving/fabric/transport.py).

No trace lock. The reference serialises each replica's first steps
under a process-wide lock while the engine still has untraced programs
(its `_untraced()` reads `engine.trace_counts`): replicas share one
model object and jax tracing swaps parameters through it. The port's
engines run eagerly and trace nothing (their `trace_counts` raises),
and the model's `forward` writes no module state, so replicas sharing
one model step concurrently without a lock.
"""
from ...distributed.resilience import fire_fault_points
from ..fabric.transport import (DEAD, DRAINING, READY, STATE_CODES,
                                STOPPED, ReplicaTransport)

__all__ = ['InprocReplica', 'READY', 'DRAINING', 'DEAD', 'STOPPED',
           'STATE_CODES']


class InprocReplica(ReplicaTransport):

    def __init__(self, index, engine, breaker=None, registry=None):
        super().__init__(index, 'inproc://gw-replica-%d' % int(index),
                         breaker=breaker, registry=registry)
        self.engine = engine
        # the engine's serving metrics and step timeline move onto the
        # private registry (the multi-engine pattern)
        engine.rebind_perf(self.registry)

    # ---- transport (chaos hook points fire around every engine op) ----

    def submit(self, prompt, **sampling):
        """Submit one request to the wrapped engine. Fires the 'send'
        hook first: a partitioned replica rejects the submission before
        the engine sees it, like a dead socket."""
        fire_fault_points('send', self.endpoint)
        # emit_event=False: the GATEWAY emits the one canonical wide
        # event per request (it alone knows the failover history); an
        # engine-level event per placement would double-count failovers
        eng_req = self.engine.add_request(prompt, emit_event=False,
                                          **sampling)
        # refresh the queue gauge immediately so the router's next
        # ranking sees this submission without waiting for a step
        self.engine.metrics.on_queue_depth(
            len(self.engine.scheduler.queue))
        return eng_req

    def step(self):
        """One engine step. Fires 'recv' after: a partition that lands
        mid-burst surfaces as a failed token delivery, which is the case
        failover must re-admit (tokens were generated but never made it
        back to the caller)."""
        n = self.engine.step()
        fire_fault_points('recv', self.endpoint)
        return n

    def has_pending(self):
        return bool(self.engine.scheduler.pending)

    # ---- observable state ---------------------------------------------

    def _gauge(self, name):
        fam = self.registry.get(name)
        return 0.0 if fam is None else fam.value()

    def queue_depth(self):
        return self._gauge('serving_queue_depth')

    def occupancy(self):
        return self._gauge('serving_occupancy')

    def load(self):
        return (self.queue_depth()
                + self.occupancy() * self.engine.num_slots)

    # ---- lifecycle ----------------------------------------------------

    def drain(self):
        """Stop admissions, let in-flight decode finish."""
        super().drain()
        self.engine.shutdown()
