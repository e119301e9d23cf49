"""paddle.distributed (counterpart of paddle_tpu/distributed/; reference:
python/paddle/distributed/).

Collective training, one process a rank over torch.distributed (NCCL on
the card, gloo on the CPU): env.py (init_parallel_env from Paddle's env
contract), spawn.py, collective.py, topology.py (HybridCommunicateGroup on
a DeviceMesh), parallel.py (DataParallel), strategy.py (the shardings),
sp.py (sequence parallelism), pipeline.py and pipeline_1f1b.py (the
GPipe and 1F1B schedules over point-to-point), meta_parallel/ (the TP
layers, PipelineLayer) and fleet/ (fleet_train_step and the strategies,
expert parallelism over 'ep' for incubate/moe.py). Also the RPC
resilience layer (resilience.py), the parameter server (ps/), the graph engine
(graph_service.py, graph_learning.py), the TDM tree index
(index_dataset.py), checkpoints (checkpoint.py) and the supervisors
(supervisor.py). Not ported, each queued in ROADMAP Queue 1 item 3:
auto_parallel/, launch/, fleet/elastic.py and cloud_utils.py.
shard_map_compat.py is JAX-only and has no counterpart.
"""
from .env import (init_parallel_env, get_rank, get_world_size,  # noqa: F401
                  ParallelEnv, is_initialized)
from .parallel import DataParallel  # noqa: F401
from .collective import (ReduceOp, new_group, all_reduce, all_gather,  # noqa: F401
                         broadcast, reduce, scatter, alltoall, send, recv,
                         barrier, wait, split, get_group)
from .topology import (HybridCommunicateGroup, Group,  # noqa: F401
                       get_hybrid_communicate_group, default_mesh)
from . import fleet  # noqa: F401
from .fleet import utils  # noqa: F401
from . import meta_parallel  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import strategy  # noqa: F401
from . import checkpoint  # noqa: F401
from . import supervisor  # noqa: F401
from .supervisor import (TrainingSupervisor, ShardSupervisor,  # noqa: F401
                         ShardSpec, PushJournal, PreemptionWatcher,
                         ResumeCursor, Preempted, SupervisorAbort)

from .ps.dataset import MultiSlotDataset as QueueDataset  # noqa: F401
from .ps.dataset import MultiSlotDataset as InMemoryDataset  # noqa: F401
from .ps.dataset import BoxPSDataset  # noqa: F401
from .ps.embedding_service import (CountFilterEntry,  # noqa: F401
                                   ProbabilityEntry)
