"""fleet (counterpart of paddle_tpu/distributed/fleet/): `recompute`, the
MultiSlot data generators (data_generator.py), and the parameter-server
surface — the role makers, `init` (records the role and the strategy),
the worker / server queries, the PS runtime's init_worker / init_server /
run_server / stop_worker, barrier_worker over the service's BarrierTable,
PS-mode save_persistables, and save_inference_model (the port's static
one).

The collective surface (distributed_optimizer, distributed_model,
minimize, distributed_scaler, fleet_train_step, the hybrid communicate
group, the strategies' sharded steps) raises NotImplementedError: it
belongs to ROADMAP Queue 1 item 3's collective part.
"""
import os

from . import data_generator  # noqa: F401
from .utils import recompute  # noqa: F401

__all__ = ['init', 'distributed_optimizer', 'distributed_model',
           'get_hybrid_communicate_group', 'worker_index', 'worker_num',
           'is_worker', 'is_server', 'is_first_worker', 'worker_endpoints',
           'server_endpoints', 'barrier_worker', 'init_worker',
           'init_server', 'run_server', 'stop_worker', 'save_persistables',
           'UserDefinedRoleMaker', 'PaddleCloudRoleMaker', 'minimize',
           'distributed_scaler', 'fleet_train_step', 'save_inference_model',
           'recompute', 'utils', 'data_generator']

_FLEET = {'initialized': False, 'strategy': None, 'is_collective': True,
          'role_maker': None}

_COLLECTIVE = ('fleet.%s: the collective fleet surface is not ported yet '
               '(ROADMAP Queue 1 item 3, collective part); the parameter-'
               'server surface is')


def get_rank():
    """This trainer's index: PADDLE_TRAINER_ID (the JAX package reads the
    process index first, which is this on a one-process host)."""
    return int(os.environ.get('PADDLE_TRAINER_ID', 0))


def get_world_size():
    """Trainers in the job: the length of PADDLE_TRAINER_ENDPOINTS, else
    1."""
    eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
    return len(eps.split(',')) if eps else 1


class PaddleCloudRoleMaker:
    """reference: fleet/base/role_maker.py:946 — reads PADDLE_* env."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self):
        return get_rank()

    def _worker_num(self):
        return get_world_size()

    def _is_worker(self):
        return os.environ.get('TRAINING_ROLE', 'TRAINER') == 'TRAINER'

    def _is_server(self):
        return os.environ.get('TRAINING_ROLE', '') == 'PSERVER'


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, role='TRAINER', worker_num=1,
                 server_endpoints=None, **kwargs):
        super().__init__()
        self._cur = current_id
        self._n = worker_num

    def _worker_index(self):
        return self._cur

    def _worker_num(self):
        return self._n


def init(role_maker=None, is_collective=False, strategy=None,
         log_level='INFO'):
    """Record the role and the strategy. The JAX package also builds its
    hybrid communicate group here; the port's collective half is not
    ported, so nothing is built."""
    _FLEET['strategy'] = strategy
    _FLEET['is_collective'] = is_collective or role_maker is None
    _FLEET['role_maker'] = role_maker or PaddleCloudRoleMaker(is_collective)
    _FLEET['initialized'] = True


def distributed_optimizer(optimizer, strategy=None):
    raise NotImplementedError(_COLLECTIVE % 'distributed_optimizer')


def distributed_model(model):
    raise NotImplementedError(_COLLECTIVE % 'distributed_model')


def get_hybrid_communicate_group():
    raise NotImplementedError(_COLLECTIVE % 'get_hybrid_communicate_group')


def minimize(loss, startup_program=None, parameter_list=None,
             no_grad_set=None):
    raise NotImplementedError(_COLLECTIVE % 'minimize')


def distributed_scaler(scaler):
    raise NotImplementedError(_COLLECTIVE % 'distributed_scaler')


def fleet_train_step(model, loss_fn, optimizer, strategy=None, hcg=None):
    raise NotImplementedError(_COLLECTIVE % 'fleet_train_step')


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_worker():
    return _FLEET['role_maker']._is_worker() if _FLEET['role_maker'] else True


def is_server():
    return _FLEET['role_maker']._is_server() if _FLEET['role_maker'] \
        else False


def is_first_worker():
    return get_rank() == 0


def worker_endpoints(to_string=False):
    eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS',
                         '127.0.0.1:6170').split(',')
    return ','.join(eps) if to_string else eps


def server_endpoints(to_string=False):
    eps = os.environ.get('PADDLE_PSERVERS_IP_PORT_LIST', '').split(',')
    return ','.join(eps) if to_string else eps


def barrier_worker():
    """reference fleet_base.py barrier_worker: in PS mode, rendezvous all
    workers through the service's BarrierTable (configure its table id
    with PADDLE_FLEET_BARRIER_TABLE_ID); without a PS client it does
    nothing, as in the JAX package's collective mode."""
    from ..ps import runtime as ps_runtime
    client = ps_runtime.get_client()
    tid = os.environ.get('PADDLE_FLEET_BARRIER_TABLE_ID')
    if client is not None and tid is not None:
        client.barrier(int(tid), worker_id=worker_index())


def init_worker():
    """PS-mode worker init (reference the_one_ps.py:486): starts the
    embedding-service client over PADDLE_PSERVERS_IP_PORT_LIST."""
    from ..ps import runtime as ps_runtime
    ps_runtime.init_worker(_FLEET)


def init_server(*args, **kwargs):
    from ..ps import runtime as ps_runtime
    ps_runtime.init_server(_FLEET, *args, **kwargs)


def run_server():
    from ..ps import runtime as ps_runtime
    ps_runtime.run_server(_FLEET)


def stop_worker():
    from ..ps import runtime as ps_runtime
    ps_runtime.stop_worker(_FLEET)


def save_inference_model(*args, **kwargs):
    from ...static import save_inference_model as _save
    return _save(*args, **kwargs)


def save_persistables(executor, dirname, main_program=None, mode=0):
    """reference fleet save_persistables, PS mode: every service table
    listed in PADDLE_FLEET_PS_TABLE_IDS (default '0') is saved through the
    service under `dirname`/table_<id>. Without a PS client the JAX
    package saves the fleet model registered by distributed_model, which
    is collective and not ported."""
    from ..ps import runtime as ps_runtime
    client = ps_runtime.get_client()
    if client is None:
        raise NotImplementedError(
            _COLLECTIVE % 'save_persistables without a PS client')
    tids = os.environ.get('PADDLE_FLEET_PS_TABLE_IDS', '0')
    for tid in tids.split(','):
        client.save(int(tid), os.path.join(dirname,
                                           'table_%s' % tid.strip()))
