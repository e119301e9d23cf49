"""Multi-replica serving gateway: routing, failover, autoscaling
(counterpart of paddle_tpu/serving/gateway/).

Turns one continuous-batching engine into a self-healing pool:

    gw = ServingGateway(lambda: ContinuousBatchingEngine(model, ...),
                        replicas=2,
                        autoscaler=AutoscalePolicy(slo_ttft_s=0.5))
    gw.start()
    req = gw.submit(prompt, max_new_tokens=32)
    req.wait(); req.tokens      # token-identical to a single engine

Layering: replica.py wraps one engine as an endpoint-addressable worker
(chaos hook points, circuit breaker, private metric registry);
router.py ranks replicas on the live serving gauges; autoscaler.py is
the pure SLO-burn policy; admission.py is the QoS door
(capacity/qos.py); gateway.py composes them behind one lock.
"""
from .admission import QosPolicy, TenantClass, TokenBucket
from .autoscaler import AutoscalePolicy, Decision, slo_burn_rate
from .gateway import GatewayRequest, ServingGateway
from .replica import InprocReplica
from .router import (LeastLoadedRouter, ModelAffinityRouter,
                     RoundRobinRouter)

__all__ = ['ServingGateway', 'GatewayRequest', 'InprocReplica',
           'LeastLoadedRouter', 'ModelAffinityRouter', 'RoundRobinRouter',
           'AutoscalePolicy', 'Decision', 'slo_burn_rate', 'QosPolicy',
           'TenantClass', 'TokenBucket']
