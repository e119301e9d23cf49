"""Process bootstrap (counterpart of paddle_tpu/distributed/env.py;
reference: fleet launch env PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS).

The JAX package is single-controller: one process drives every device and
init_parallel_env is a no-op on one host. The port runs one process per
rank, as Paddle does: init_parallel_env starts torch.distributed's default
process group from Paddle's env contract (PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS; the first endpoint is the
rendezvous), NCCL when the rank runs on the card and gloo when the caller
asks for the CPU. A CUDA rank never turns to gloo or the CPU: without
CUDA it raises. Without a process group the queries read the env, as the
JAX package does off a multi-host job.
"""
import os
import socket

import torch
import torch.distributed as dist

from ..framework import device as device_mod

__all__ = ['init_parallel_env', 'get_rank', 'get_world_size',
           'is_initialized', 'ParallelEnv', 'local_device']

_STATE = {'initialized': False, 'device': None}


def get_rank(group=None):
    """This process's rank in `group` (a Group), else in the job."""
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get('PADDLE_TRAINER_ID', 0))


def get_world_size(group=None):
    """Ranks in `group` (a Group), else in the job."""
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
    return len(eps.split(',')) if eps else 1


def is_initialized():
    return _STATE['initialized']


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def end_nccl_groups():
    """End this rank's NCCL process groups once its job is done: a
    barrier (every rank done), the card's queue drained, then every group
    (the default one with the point-to-point communicators a pipeline's
    sends made, and the mesh's) aborted inside one NCCL group call, which
    cannot wait on a peer. Left to the interpreter's exit, the ranks
    destroy their communicators one by one in orders of their own; a
    4-card pipelined job has hung there once, for a reason not found.
    gloo groups are left as they are. spawn calls it when a rank's
    function returns."""
    if not dist.is_initialized() or dist.get_backend() != 'nccl':
        return
    dist.barrier()
    torch.cuda.synchronize()
    from torch.distributed import distributed_c10d as c10d
    end = getattr(c10d, '_abort_process_group', None) or \
        dist.destroy_process_group
    end()
    _STATE['initialized'] = False


def local_device():
    """The torch.device this rank computes on: the one init_parallel_env
    chose, else the current device."""
    return _STATE['device'] or device_mod.resolve()


def init_parallel_env(backend=None, device=None):
    """Start the default process group (reference: distributed/parallel.py:58
    init_parallel_env); returns a ParallelEnv.

    The rank and world come from PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM
    (or the endpoint count) and the rendezvous from the first of
    PADDLE_TRAINER_ENDPOINTS; a job of one rank without endpoints takes a
    free local port. `device` (default: PADDLE_DISTRI_DEVICE, else the
    current device) picks the backend: a CUDA device takes NCCL on card
    FLAGS_selected_gpus (default: the rank's local index), 'cpu' takes
    gloo. `backend` may name it ('nccl', 'gloo'); NCCL with a CPU device
    or gloo with a CUDA one raises."""
    if _STATE['initialized'] and dist.is_initialized():
        return ParallelEnv()
    dev = device_mod.resolve(device or os.environ.get('PADDLE_DISTRI_DEVICE')
                             or None)
    want = 'nccl' if dev.type == 'cuda' else 'gloo'
    backend = backend or os.environ.get('PADDLE_DISTRI_BACKEND') or want
    if backend != want:
        raise ValueError('backend %r with a %s device: a CUDA rank takes '
                         'NCCL and a CPU rank gloo' % (backend, dev.type))
    if dev.type == 'cuda':
        index = dev.index if dev.index is not None else int(
            os.environ.get('FLAGS_selected_gpus', '').split(',')[0] or
            os.environ.get('PADDLE_LOCAL_RANK', 0))
        torch.cuda.set_device(index)
        dev = torch.device('cuda', index)
    if not dist.is_initialized():
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        world = int(os.environ.get('PADDLE_TRAINERS_NUM') or
                    (len(eps.split(',')) if eps else 1))
        rank = int(os.environ.get('PADDLE_TRAINER_ID', '0'))
        master = eps.split(',')[0] if eps else \
            '127.0.0.1:%d' % _free_port()
        kwargs = {'device_id': dev} if dev.type == 'cuda' else {}
        dist.init_process_group(backend, init_method='tcp://' + master,
                                rank=rank, world_size=world, **kwargs)
    _STATE['initialized'] = True
    _STATE['device'] = dev
    return ParallelEnv()


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return int(os.environ.get('FLAGS_selected_gpus', '0').split(',')[0])

    @property
    def current_endpoint(self):
        return os.environ.get('PADDLE_CURRENT_ENDPOINT', '127.0.0.1:6170')

    @property
    def trainer_endpoints(self):
        return os.environ.get('PADDLE_TRAINER_ENDPOINTS', '').split(',')

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return self.rank
