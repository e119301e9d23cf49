"""MetaParallel wrappers (counterpart of
paddle_tpu/distributed/meta_parallel/parallel_base.py; reference:
fleet/meta_parallel/pipeline_parallel.py PipelineParallel:32,
tensor_parallel.py, sharding_parallel.py).

They wrap a model for the hybrid configuration; the layouts and the
collectives come from distributed/strategy.py and the TP layers, so a
wrapper's job is bookkeeping: calls, attributes and the state dict pass
through to the model. PipelineParallel.train_batch runs the pipeline
schedule (distributed/pipeline.py, PipelineEngine).
"""
from torch import nn

__all__ = ['TensorParallel', 'ShardingParallel', 'PipelineParallel']


class _MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules['_layers'], name)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    load_state_dict = set_state_dict


class TensorParallel(_MetaParallelBase):
    pass


class ShardingParallel(_MetaParallelBase):
    pass


class PipelineParallel(_MetaParallelBase):
    """train_batch parity (pipeline_parallel.py:109): the GPipe schedule
    over the hybrid group's 'pp' line through PipelineEngine."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        self._engine = None

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        from ..pipeline import PipelineEngine
        if self._engine is None:
            self._engine = PipelineEngine(self._layers, optimizer,
                                          self._hcg)
        inputs, labels = data
        loss = self._engine.step(inputs, labels)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
