"""Capacity planning (counterpart of paddle_tpu/capacity/): the workload
language, the trace replay and the fleet simulator, with the QoS
admission policy the gateway enforces.

- `workload` — declarative, seeded trace generation (Poisson/diurnal
  arrivals, heavy-tailed lengths, tenant skew, shared prefixes) and
  loaders for recorded wide events. Same spec + same seed ==
  byte-identical trace, in either package.
- `replay`   — open-loop, arrival-faithful replay of a Trace against the
  real ServingGateway.
- `simulator` — discrete-event gateway+replicas simulation with a
  calibrated two-parameter service model (from wide events, bench rows
  or the cost model's peaks); validates against replayed runs by
  TTFT-distribution divergence, then sweeps replica counts.
- `qos`      — the pure admission policy (token buckets, concurrency
  quotas, priorities).
"""
from .qos import QosPolicy, TenantClass, TokenBucket
from .replay import ReplayResult, measure, replay
from .simulator import (ServiceModel, SimResult, compare_events,
                        ks_statistic, min_replicas_for, simulate,
                        sweep_qos, sweep_replicas, ttft_divergence,
                        ttfts_of_events)
from .workload import (Trace, WorkloadSpec, generate, load_trace,
                       poisson_arrivals, trace_from_events)

__all__ = [
    'Trace', 'WorkloadSpec', 'generate', 'load_trace',
    'poisson_arrivals', 'trace_from_events',
    'ReplayResult', 'replay', 'measure',
    'QosPolicy', 'TenantClass', 'TokenBucket',
    'ServiceModel', 'SimResult', 'simulate', 'sweep_replicas',
    'sweep_qos', 'min_replicas_for', 'ks_statistic', 'ttft_divergence',
    'compare_events', 'ttfts_of_events',
]
