"""Capacity planning (counterpart of paddle_tpu/capacity/): the workload
language and the trace replay, with the QoS admission policy the gateway
enforces.

- `workload` — declarative, seeded trace generation (Poisson/diurnal
  arrivals, heavy-tailed lengths, tenant skew, shared prefixes) and
  loaders for recorded wide events. Same spec + same seed ==
  byte-identical trace, in either package.
- `replay`   — open-loop, arrival-faithful replay of a Trace against the
  real ServingGateway.
- `qos`      — the pure admission policy (token buckets, concurrency
  quotas, priorities).

The discrete-event fleet simulator (`simulator`) is not ported yet.
"""
from .qos import QosPolicy, TenantClass, TokenBucket
from .replay import ReplayResult, measure, replay
from .workload import (Trace, WorkloadSpec, generate, load_trace,
                       poisson_arrivals, trace_from_events)

__all__ = [
    'Trace', 'WorkloadSpec', 'generate', 'load_trace',
    'poisson_arrivals', 'trace_from_events',
    'ReplayResult', 'replay', 'measure',
    'QosPolicy', 'TenantClass', 'TokenBucket',
]
