"""Multi-model serving: model registry, weight paging, hot-swap
(counterpart of paddle_tpu/serving/registry/).

Three pieces compose the "many models per process" layer out of parts
the stack already has:

- ``registry.ModelRegistry`` — the catalog: (model, version) → loadable
  artifact (a CRC-manifest checkpoint from framework/io_save), each
  entry carrying a content-addressed fingerprint that keys the
  persistent compile cache, plus the per-model *serving pointer* the
  hot-swap flips atomically.
- ``hosting.ModelHost`` — the per-replica weight pager: loads models on
  demand under a byte budget, pins hot ones, LRU-evicts cold ones with
  PageAllocator-style refcounts so an in-flight request never loses its
  weights. A ModelHost quacks like an engine, so ``InprocReplica`` and
  the gateway drive it unchanged.
- gateway glue (serving/gateway): ``submit(model=...)``,
  ``ModelAffinityRouter``, and ``ServingGateway.rollout()`` — the
  zero-downtime version swap.
"""
from .hosting import ModelHost
from .registry import ModelRegistry, RegistryEntry, artifact_fingerprint

__all__ = ['ModelRegistry', 'RegistryEntry', 'artifact_fingerprint',
           'ModelHost']
