"""DataParallel (counterpart of paddle_tpu/distributed/parallel.py;
reference: python/paddle/distributed/parallel.py, fluid/dygraph/parallel.py
DataParallel, imperative/reducer.cc).

The JAX package's DataParallel only marks the model: its gradient sync is
the psum XLA inserts into a jitted step. The port runs one process a
rank, so the sync is real: over more than one rank the wrapper runs the
model through torch's DistributedDataParallel (bucketed all-reduce of the
grads during the backward, their mean over the group; the parameters
broadcast from rank 0 at wrap time), on the group given or every rank.
On one rank it is a pass-through, as the JAX package's is. `no_sync()`
skips the all-reduce of the backwards inside it (their grads accumulate
locally, as Paddle's does); `scale_loss` returns the loss and
`apply_collective_grads` does nothing, as in Paddle 2's dygraph, where
the reducer averages during the backward. The state dict is the model's.
"""
import contextlib

import torch.distributed as dist
from torch import nn

from .env import init_parallel_env, ParallelEnv, get_rank, get_world_size  # noqa: F401

__all__ = ['DataParallel', 'init_parallel_env', 'ParallelEnv', 'get_rank',
           'get_world_size']


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        if not isinstance(layers, nn.Module):
            raise TypeError('DataParallel expects a Layer, got %s'
                            % type(layers).__name__)
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        layers._is_data_parallel = True
        pg = getattr(group, 'pg', group)
        world = dist.get_world_size(pg) if dist.is_initialized() else 1
        self._ddp = None
        if world > 1:
            from torch.nn.parallel import DistributedDataParallel
            self._ddp = DistributedDataParallel(
                layers, process_group=pg, bucket_cap_mb=comm_buffer_size,
                find_unused_parameters=find_unused_parameters)
        # register with fleet so a later fleet_train_step /
        # distributed_optimizer picks this model up
        from . import fleet as fleet_mod
        if fleet_mod._FLEET.get('model') is None:
            fleet_mod._FLEET['model'] = layers

    def no_sync(self):
        """Backwards inside accumulate their grads without the all-reduce."""
        return self._ddp.no_sync() if self._ddp is not None \
            else contextlib.nullcontext()

    def forward(self, *args, **kwargs):
        if self._ddp is not None:
            return self._ddp(*args, **kwargs)
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules['_layers'], name)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    load_state_dict = set_state_dict

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    @property
    def layers(self):
        return self._layers
