"""The parameter server's pieces of the port. So far only its wire codec
(wire.py), the default codec of the RPC channel; the tables, services and
communicators are not ported."""
