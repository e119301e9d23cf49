"""Front-door admission control for the gateway (QoS enforcement;
counterpart of paddle_tpu/serving/gateway/admission.py).

The policy objects live in `paddle_tpu_torch.capacity.qos` — pure
stdlib/virtual-time classes (the AutoscalePolicy discipline: no clock,
no locks, caller owns time) — so offline sweeps can run the EXACT code
path the gateway enforces, not a reimplementation. This module is the
serving-side door: it re-exports the policy vocabulary and documents the
contract the gateway holds it to.

Contract (`ServingGateway(admission=QosPolicy(...))`):

- `admit(now, tenant_label)` is called once per submit under the
  gateway lock, with the bounded TenantLabeler label — policy state
  cardinality is bounded by construction, like the tenant metric
  families.
- a rejection (`'rate'`/`'quota'`, or the gateway's own
  `'queue_full'`/`'deadline'` queue sheds) finishes the request
  immediately with outcome='rejected': one wide event, `error` set,
  stream sentinel delivered, no engine traffic. Callers see a finished
  handle, never an exception — overload is data, not a crash.
- `finish(tenant_label)` releases the concurrency slot exactly once
  per admitted request at any terminal outcome (delivered, errored,
  shed from the queue).
- `priority_of(tenant)` supplies the default `priority=` for tenants
  that did not pass one explicitly; priorities thread
  gateway -> engines in the sampling dict exactly like `tenant=`, so
  failover re-submits keep them.
"""
from ...capacity.qos import (REJECT_REASONS, QosPolicy, TenantClass,
                             TokenBucket)

__all__ = ['REJECT_REASONS', 'QosPolicy', 'TenantClass', 'TokenBucket']
