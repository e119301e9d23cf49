"""Hybrid-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/; reference:
python/paddle/distributed/fleet/meta_parallel/).

Ported: the tensor-parallel layers (mp_layers.py), the RNG tracker
(random_ctrl.py), the pipeline's PipelineLayer / LayerDesc /
SharedLayerDesc (pp_layers.py) and the TensorParallel / ShardingParallel /
PipelineParallel wrappers (parallel_base.py). Absent: SyncBatchNorm
(sync_bn.py), which waits for the norms (ROADMAP Queue 1 item 5).
"""
from .mp_layers import (VocabParallelEmbedding, ColumnParallelLinear,  # noqa: F401
                        RowParallelLinear, ParallelCrossEntropy)
from .random_ctrl import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                          model_parallel_random_seed)
from .parallel_base import (PipelineParallel, TensorParallel,  # noqa: F401
                            ShardingParallel)
from .pp_layers import (LayerDesc, SharedLayerDesc,  # noqa: F401
                        PipelineLayer, SegmentLayers)
