"""Distributed pieces of the port. So far only the part of the RPC
resilience layer that the serving gateway uses (resilience.py); the
collectives, fleet, pipeline and parameter-server modules are not
ported."""
