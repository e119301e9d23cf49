"""Distributed pieces of the port: the RPC resilience layer
(resilience.py: retry policy, deadlines, circuit breakers, the framed
`ResilientChannel`) and the parameter server's wire codec (ps/wire.py).
The collectives, fleet, pipeline and the parameter server's tables and
services are not ported."""
