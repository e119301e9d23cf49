"""Continuous-batching serving for decoder-only LMs (counterpart of
paddle_tpu/serving/, Orca/vLLM-style).

The decode matmuls of a cached autoregressive model are batch-starved
when requests are served one at a time: `generate()` runs [1, hidden]
GEMMs no matter how many requests are waiting. Continuous batching keeps
a fixed pool of KV-cache slots and admits and retires requests per decode
step, so every step runs at full slot occupancy with the same shapes.

    engine = ContinuousBatchingEngine(model, num_slots=8)
    req = engine.add_request([1, 2, 3], max_new_tokens=16)
    engine.run()                 # or step() / stream(req) / serve threads
    req.tokens                   # generated ids, identical to generate()

Two engines share that skeleton:

- ContinuousBatchingEngine: every slot reserves max_len KV rows;
- PagedContinuousBatchingEngine: a block-granular KV pool with prefix
  sharing and optional speculative decoding (paged_engine.py).

kv_cache.py owns slot and page bookkeeping, scheduler.py the request queue
and admission/prefill policy, engine.py and paged_engine.py the steps
(chunked prefill, decode burst, spec verify) and the thread-safe front
door, metrics.py tokens/s and latency percentiles.

gateway/ fronts a pool of engine replicas: `ServingGateway` with QoS
admission (`QosPolicy`, `TenantClass`), least-loaded / round-robin /
model-affinity / prefix-affinity routing, failover of a lost replica's
requests, drain, `AutoscalePolicy` and the zero-loss `rollout()` of a
model version. registry/ holds `ModelRegistry` (versions, fingerprints,
the serving pointer) and `ModelHost` (weight paging under a byte budget).
fabric/ puts replicas in worker processes behind sockets (`ReplicaWorker`,
`SocketReplica`, the JSON wire protocol, artifact distribution, the
prefix directory, the preset zoo).
"""
from .engine import ContinuousBatchingEngine
from .fabric import (PrefixAffinityRouter, ReplicaWorker, SocketReplica,
                     spawn_worker)
from .gateway import (AutoscalePolicy, GatewayRequest, ModelAffinityRouter,
                      QosPolicy, ServingGateway, TenantClass)
from .kv_cache import (PageAllocator, PrefixCache, SlotAllocator,
                       build_paged_pools, build_slot_caches)
from .metrics import ServingMetrics, percentile
from .paged_engine import NGramProposer, PagedContinuousBatchingEngine
from .registry import ModelHost, ModelRegistry, RegistryEntry
from .scheduler import PagedScheduler, Request, Scheduler

__all__ = ['ContinuousBatchingEngine', 'PagedContinuousBatchingEngine',
           'SlotAllocator', 'PageAllocator', 'PrefixCache',
           'NGramProposer', 'build_slot_caches', 'build_paged_pools',
           'ServingMetrics', 'percentile', 'Request', 'Scheduler',
           'PagedScheduler', 'ServingGateway', 'GatewayRequest',
           'AutoscalePolicy', 'QosPolicy', 'TenantClass',
           'ModelAffinityRouter', 'ModelRegistry', 'RegistryEntry',
           'ModelHost', 'SocketReplica', 'ReplicaWorker',
           'PrefixAffinityRouter', 'spawn_worker']
