"""Distributed pieces of the port: the RPC resilience layer
(resilience.py: retry policy, deadlines, circuit breakers, the framed
`ResilientChannel`), the parameter server (ps/: the wire codec, the
sharded embedding service and its tables, the communicators, the MultiSlot
dataset, the Downpour trainer and the heter embeddings), the graph engine
(graph_service.py, graph_learning.py), the TDM tree index
(index_dataset.py), fleet's parameter-server surface and activation
recompute (fleet/), checkpoints (checkpoint.py) and the supervisors
(supervisor.py: training and shards). The collectives, fleet's collective
strategies and the pipeline are not ported."""
from . import fleet  # noqa: F401
