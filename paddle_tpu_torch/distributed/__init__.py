"""Distributed pieces of the port: the RPC resilience layer
(resilience.py: retry policy, deadlines, circuit breakers, the framed
`ResilientChannel`), the parameter server's wire codec (ps/wire.py) and
fleet's activation recompute (fleet/utils.py). The collectives, fleet's
strategies, pipeline and the parameter server's tables and services are
not ported."""
from . import fleet  # noqa: F401
