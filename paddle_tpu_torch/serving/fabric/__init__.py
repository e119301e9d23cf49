"""The serving fabric (counterpart of paddle_tpu/serving/fabric/): so far
only the replica contract the gateway composes (transport.py). Socket
replicas, the worker processes, the wire protocol and prefix-affinity
routing are not ported yet."""
from .transport import (DEAD, DRAINING, READY, STATE_CODES, STOPPED,
                        ReplicaTransport)

__all__ = ['ReplicaTransport', 'READY', 'DRAINING', 'DEAD', 'STOPPED',
           'STATE_CODES']
