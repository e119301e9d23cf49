"""ReplicaTransport: the gateway's replica contract, made explicit
(counterpart of paddle_tpu/serving/fabric/transport.py).

The gateway composes replicas through a small surface — submit new
work, step in-flight work, observe load, walk the lifecycle ladder.
This base class states it so a replica living in another PROCESS
(fabric/socket_replica.py) is interchangeable with one living in this
one (gateway/replica.py).

The contract, by group:

transport (subclass MUST implement)
    submit(prompt, **sampling) -> request handle with .tokens/.done/
        .outcome (engine Request in-proc, RemoteRequest over a socket)
    step() -> int            one unit of progress; raising means
                             transport loss, the driver calls on_lost
    has_pending() -> bool    unfinished work exists (drives parking)

observability (subclass MUST implement)
    queue_depth(), occupancy(), load()   router ranking inputs

lifecycle (provided here)
    READY -> DRAINING -> STOPPED, or -> DEAD on loss. All state writes
    go through one condvar so the driver's DRAINING -> STOPPED
    check-and-set cannot race the gateway's mark_dead.

driver (provided here)
    start_driver(on_step, on_lost): the park/step loop every transport
    shares. Parks while no pending work; a DRAINING replica with no
    assigned requests self-transitions to STOPPED and exits.

scrape (default here, socket transports override)
    scrape_kwargs() -> kwargs for a fleet collector's add_target:
    in-proc replicas hand over their registry object, socket replicas
    their worker's /metrics.json url; metrics_server() -> a
    MetricsServer over the replica's registry whose /readyz follows the
    drain state.
"""
import threading

from ...distributed.resilience import CircuitBreaker
from ...monitor.registry import MetricRegistry

__all__ = ['ReplicaTransport', 'READY', 'DRAINING', 'DEAD', 'STOPPED',
           'STATE_CODES']

READY = 'ready'
DRAINING = 'draining'
DEAD = 'dead'
STOPPED = 'stopped'

# gauge encoding for gateway_replica_state
STATE_CODES = {READY: 0, DRAINING: 1, DEAD: 2, STOPPED: 3}


class ReplicaTransport:

    def __init__(self, index, endpoint, breaker=None, registry=None,
                 failure_threshold=1):
        self.index = int(index)
        self.endpoint = endpoint
        self.registry = registry if registry is not None \
            else MetricRegistry()
        if breaker is None:
            # in-proc default: one transport failure means
            # partitioned-or-dead, not a blip — a single strike opens
            # the breaker and the gateway replaces rather than retries.
            # Socket transports raise the threshold to tolerate one
            # reconnect (see SocketReplica).
            breaker = CircuitBreaker(failure_threshold=failure_threshold,
                                     reset_timeout=3600.0)
        breaker.bind_name(self.endpoint)
        self.breaker = breaker
        self.state = READY
        # GatewayRequest -> request handle; guarded by the GATEWAY lock
        # (never touched by the driver thread directly)
        self.assigned = {}
        self._cv = threading.Condition()
        self._thread = None

    def _abstract(self, method):
        raise NotImplementedError(
            '%s does not implement %s(): a transport subclass must; '
            'InprocReplica (gateway/replica.py) and SocketReplica '
            '(fabric/socket_replica.py) do' % (type(self).__name__, method))

    # ---- transport (subclass responsibility) --------------------------

    def submit(self, prompt, **sampling):
        self._abstract('submit')

    def step(self):
        self._abstract('step')

    def has_pending(self):
        """Unfinished work the driver should keep stepping for."""
        self._abstract('has_pending')

    # ---- observability (subclass responsibility) ----------------------

    def queue_depth(self):
        self._abstract('queue_depth')

    def occupancy(self):
        self._abstract('occupancy')

    def load(self):
        """Router ranking key: queued requests + occupied slots, both
        in request units."""
        self._abstract('load')

    def scrape_kwargs(self):
        """How gateway.attach_fleet registers this replica with the
        FleetCollector. In-proc: the registry object itself."""
        return {'registry': self.registry}

    def metrics_server(self, **kwargs):
        """A MetricsServer over this replica's registry with readiness
        wired to its drain state (not started)."""
        from ...monitor.server import MetricsServer
        return MetricsServer(registry=self.registry, readiness=self.ready,
                             **kwargs)

    # ---- lifecycle (gateway lock held unless noted) -------------------

    def routable(self):
        """May the router place NEW work here?"""
        return self.state == READY and self.breaker.allow()

    @property
    def alive(self):
        """Still worth stepping (in-flight work may exist)?"""
        return self.state in (READY, DRAINING)

    def ready(self):
        """/readyz readiness: READY routes, anything else 503s while
        /healthz stays 200 (drain must not get the process restarted)."""
        return self.state == READY

    def drain(self):
        """Stop admissions, let in-flight decode finish. Subclasses
        chain to propagate the drain to the engine/worker."""
        self._transition(DRAINING)

    def mark_dead(self):
        self._transition(DEAD)

    def mark_stopped(self):
        self._transition(STOPPED)

    def _transition(self, state):
        """All writes of `state` go through the condvar: the driver
        thread check-and-sets DRAINING -> STOPPED under _cv, so a bare
        write here could race it and overwrite DEAD with STOPPED."""
        with self._cv:
            self.state = state
            self._cv.notify_all()

    def wake(self):
        with self._cv:
            self._cv.notify_all()

    # ---- driver thread ------------------------------------------------

    def start_driver(self, on_step, on_lost):
        """Spawn the replica's drive loop: step whenever work exists,
        park on the condvar otherwise. `on_step(self)` runs after every
        successful step (the gateway collects tokens there);
        `on_lost(self, exc)` runs once on transport failure and the
        thread exits. Neither callback is invoked under the condvar, so
        the gateway lock ordering (gateway -> engine) holds."""
        def _run():
            while True:
                with self._cv:
                    while self.alive and not self.has_pending():
                        if self.state == DRAINING and not self.assigned:
                            self.state = STOPPED
                            return
                        self._cv.wait(0.02)
                    if not self.alive:
                        return
                try:
                    self.step()
                except Exception as exc:     # noqa: BLE001 — transport
                    on_lost(self, exc)
                    return
                on_step(self)

        self._thread = threading.Thread(
            target=_run, name='gw-replica-%d' % self.index, daemon=True)
        self._thread.start()
        return self._thread

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    def __repr__(self):
        return ('%s(%d, %s, load=%.1f, assigned=%d)'
                % (type(self).__name__, self.index, self.state,
                   self.load(), len(self.assigned)))
