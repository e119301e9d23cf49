"""fleet (counterpart of paddle_tpu/distributed/fleet/; reference:
fleet/base/fleet_base.py:139 init, :783 distributed_optimizer, :836
distributed_model, :1288 minimize).

The collective surface: `init` builds the HybridCommunicateGroup (a
DeviceMesh over the job's ranks; degrees that do not match the world fall
back to pure data parallelism, as in the JAX package), and
`fleet_train_step` turns (model, loss, optimizer, strategy) into the step
the strategy asks for, routed as the JAX package routes it: localsgd /
dgc / fp16_allreduce build the explicit-collective ShardMapDPStep over
the dp ranks; everything else (dp, mp, sharding stage 1-3, sp, amp,
recompute, gradient merge) is a TrainStep with the strategy's shardings
(distributed/strategy.py); lars / lamb swap the optimizer first; at
pp_degree > 1 the TrainStep runs the pipeline schedule (GPipe, or 1F1B
under strategy.pipeline's schedule_mode), each rank keeping its stage.
`distributed_model` lays the registered model out on the mesh,
`distributed_optimizer` wraps the optimizer, `get_hybrid_communicate_group`
returns the group, `distributed_scaler` returns the scaler (each rank's
found-inf follows its all-reduced grads), and `save_persistables` without
a PS client writes the fleet model's state dict (every parameter whole,
from rank 0).

The parameter-server surface: the role makers, the worker / server
queries, the PS runtime's init_worker / init_server / run_server /
stop_worker, barrier_worker over the service's BarrierTable, PS-mode
save_persistables, save_inference_model (the port's static one),
`recompute`, `LocalFS` / `HDFSClient` (utils.py) and the MultiSlot data
generators (data_generator.py).
"""
import os

from . import data_generator  # noqa: F401
from . import utils  # noqa: F401
from .distributed_strategy import DistributedStrategy
from .utils import recompute  # noqa: F401
from .. import meta_parallel  # noqa: F401
from ..env import get_rank, get_world_size, init_parallel_env
from ..topology import (HybridCommunicateGroup,
                        set_hybrid_communicate_group,
                        get_hybrid_communicate_group as _get_hcg)

__all__ = ['init', 'DistributedStrategy', 'distributed_optimizer',
           'distributed_model', 'get_hybrid_communicate_group',
           'worker_index', 'worker_num', 'is_worker', 'is_server',
           'is_first_worker', 'worker_endpoints', 'server_endpoints',
           'barrier_worker', 'init_worker', 'init_server', 'run_server',
           'stop_worker', 'save_persistables', 'UserDefinedRoleMaker',
           'PaddleCloudRoleMaker', 'minimize', 'distributed_scaler',
           'fleet_train_step', 'save_inference_model', 'recompute',
           'meta_parallel', 'utils', 'data_generator']

_FLEET = {'initialized': False, 'strategy': None, 'hcg': None,
          'is_collective': True, 'model': None, 'optimizer': None,
          'train_step': None, 'role_maker': None}


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
    """Record the role and the strategy; in collective mode start the
    process group (init_parallel_env) and build the hybrid communicate
    group from strategy.hybrid_configs (pure dp when the degrees do not
    match the world size)."""
    strategy = strategy or DistributedStrategy()
    _FLEET['strategy'] = strategy
    _FLEET['is_collective'] = is_collective or role_maker is None
    _FLEET['role_maker'] = role_maker or PaddleCloudRoleMaker(is_collective)
    if _FLEET['is_collective']:
        init_parallel_env()
        hc = strategy.hybrid_configs
        try:
            hcg = HybridCommunicateGroup(
                dp_degree=hc.get('dp_degree', -1),
                mp_degree=hc.get('mp_degree', 1),
                pp_degree=hc.get('pp_degree', 1),
                sharding_degree=hc.get('sharding_degree', 1),
                sp_degree=hc.get('sp_degree', 1),
                ep_degree=hc.get('ep_degree', 1))
        except ValueError:
            # degrees don't match the world size: fall back to pure DP
            hcg = HybridCommunicateGroup(dp_degree=-1)
        _FLEET['hcg'] = hcg
        set_hybrid_communicate_group(hcg)
    _FLEET['initialized'] = True


def _strategy_dict(s=None):
    s = s or _FLEET['strategy'] or DistributedStrategy()
    return {
        'zero_stage': s._zero_stage(),
        'tensor_parallel': s.tensor_parallel,
        'sequence_parallel': s.sequence_parallel,
        'amp': s.amp,
        'recompute': s.recompute,
        'gradient_merge_k': (s.gradient_merge_configs.get('k_steps', 1)
                             if s.gradient_merge else 1),
    }


def get_hybrid_communicate_group():
    return _FLEET['hcg'] or _get_hcg()


def distributed_model(model):
    """reference fleet_base.py:836. Records the model and, once an
    optimizer is registered, lays its parameters out on the mesh per the
    strategy (DTensors over 'mp', FSDP2 over 'sharding'). Returns the
    model, as the JAX package does."""
    _FLEET['model'] = model
    if _FLEET['hcg'] is not None and _FLEET['optimizer'] is not None:
        _prepare_train_step()
    return model


class _FleetOptimizer:
    """What distributed_optimizer returns: the inner optimizer's surface."""

    def __init__(self, inner, strategy):
        self._inner = inner
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self.__dict__['_inner'], name)

    def step(self):
        self._inner.step()

    def clear_grad(self):
        self._inner.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner.minimize(loss, startup_program, parameters,
                                    no_grad_set)


def distributed_optimizer(optimizer, strategy=None):
    if strategy is not None:
        _FLEET['strategy'] = strategy
    _FLEET['optimizer'] = optimizer
    return _FleetOptimizer(optimizer, _FLEET['strategy'])


def _prepare_train_step():
    """distributed_model's placement step: every parameter onto the fleet
    mesh under the strategy's shardings now (the slots follow at
    fleet_train_step)."""
    from .. import strategy as strategy_mod
    model = _FLEET['model']
    hcg = _FLEET['hcg']
    if model is None or hcg is None:
        return
    cfg = strategy_mod.build_shardings(model, None, hcg.mesh,
                                       _strategy_dict())
    swapped = strategy_mod.place_params(model, cfg['param_shardings'])
    opt = _FLEET['optimizer']
    if opt is not None:
        strategy_mod.place_opt_slots(model, opt, {}, swapped)


def fleet_train_step(model, loss_fn, optimizer, strategy=None, hcg=None):
    """Build the step for (model, loss, optimizer) under the fleet
    strategy — the executable artifact of fleet.minimize.

    Routing (reference meta-optimizer selection,
    base/strategy_compiler.py): localsgd / dgc / fp16_allreduce need
    explicit collectives, so they build ShardMapDPStep over the dp ranks;
    everything else composes in TrainStep. lars / lamb swap the optimizer
    first."""
    from . import meta_optimizers as mo
    from .. import strategy as strategy_mod
    from ...framework import functional as func_mod

    hcg = hcg or _FLEET['hcg']
    if hcg is None:
        init(is_collective=True, strategy=strategy)
        hcg = _FLEET['hcg']
    s = strategy if isinstance(strategy, DistributedStrategy) \
        else _FLEET['strategy'] or DistributedStrategy()
    optimizer = mo.select_optimizer(optimizer, s)

    # one strategy object governs both the step build and the shardings
    sdict = _strategy_dict(s)
    gm_k = sdict['gradient_merge_k']
    mesh = hcg.mesh
    wants_explicit = s.localsgd or s.adaptive_localsgd or s.dgc or \
        s.fp16_allreduce
    if wants_explicit:
        pure_dp = hcg.nranks == hcg.get_data_parallel_world_size()
        if not pure_dp:
            raise ValueError(
                'localsgd/dgc/fp16_allreduce run on a pure data-parallel '
                'mesh (mp/pp/sharding degree 1); got %s' % (mesh,))
        adaptive = False
        if s.localsgd or s.adaptive_localsgd:
            mode = 'local'
            if s.adaptive_localsgd:
                adaptive = True
                k = s.adaptive_localsgd_configs.get('init_k_steps', 1)
            else:
                k = s.localsgd_configs.get('k_steps', 1)
        elif s.dgc:
            mode = 'dgc'
            k = 1
        else:
            mode = 'fp16'
            k = 1
        return mo.ShardMapDPStep(
            model, loss_fn, optimizer, mesh=mesh, axis='dp', mode=mode,
            k_steps=k, gm_k_steps=gm_k, adaptive=adaptive,
            momentum=s.dgc_configs.get('momentum', 0.9),
            sparsity=s.dgc_configs.get('sparsity', 0.999),
            rampup_begin_step=s.dgc_configs.get('rampup_begin_step', 0),
            rampup_step=s.dgc_configs.get('rampup_step', 1))

    # pipeline parallel -> the GPipe / 1F1B schedule over the 'pp' line
    # (distributed/pipeline.py), scoped to the step like sp.
    # strategy.pipeline engages pipeline_configs: accumulate_steps and
    # schedule_mode ('1F1B' -> interleaved, loss in the last stage;
    # 'F-then-B' -> GPipe); without it GPipe at n_micro = pp. An explicit
    # accumulate_steps is honoured as the JAX package honours it (at least
    # pp); the 2 pp default applies to 1F1B only. Each rank keeps its
    # stage's layers before the shardings are built.
    pp_state = None
    pp_deg = hcg.get_pipe_parallel_world_size()
    if pp_deg > 1:
        from .. import pipeline as pp_mod
        schedule, acc = 'gpipe', 1
        if s.pipeline:
            acc = s.pipeline_configs.get('accumulate_steps', 1)
            mode = s.pipeline_configs.get('schedule_mode', '1F1B')
            schedule = '1f1b' if str(mode).upper() == '1F1B' else 'gpipe'
        if acc > 1:
            n_micro = max(pp_deg, acc)
        else:
            n_micro = 2 * pp_deg if schedule == '1f1b' else pp_deg
        pp_state = pp_mod.make_pp_state(mesh, n_stages=pp_deg,
                                        n_micro=n_micro,
                                        remat=bool(sdict['recompute']),
                                        schedule=schedule)
        pp_state['n_micro_defaulted'] = acc <= 1
        pp_mod.keep_stage(model, pp_state, optimizer)

    # sequence parallel -> sp attention routing over the 'sp' mesh axis,
    # scoped to the TrainStep (sp_scope). The JAX package routes only at
    # sp degree > 1; here the ring / Ulysses path runs at any degree (at
    # 1 it computes ordinary attention), so one card drives it.
    sp_state = None
    shape = {a: hcg.mesh.size(i) for i, a in
             enumerate(hcg.mesh.mesh_dim_names)}
    if sdict['sequence_parallel']:
        from .. import sp as sp_mod
        batch_axes = tuple(a for a in ('dp', 'sharding')
                           if shape.get(a, 1) > 1)
        sp_state = sp_mod.make_sp_state(
            mesh, axis='sp',
            mode=s.sequence_parallel_configs.get('mode', 'ring'),
            batch_axes=batch_axes,
            head_axis='mp' if shape.get('mp', 1) > 1 else None)

    # amp -> the O2 compute-dtype policy inside the step (reference fleet
    # AMPOptimizer); bf16 unless pure fp16 is asked for
    amp_dtype = None
    if sdict['amp']:
        pure_fp16 = s.amp_configs.get('use_pure_fp16', False) and \
            not s.amp_configs.get('use_bf16', True)
        amp_dtype = 'float16' if pure_fp16 else 'bfloat16'
        if s.amp_configs.get('custom_white_list') or \
                s.amp_configs.get('custom_black_list'):
            import warnings
            warnings.warn(
                'fleet amp runs the O2 pure-%s policy inside the step; '
                'custom_white_list/custom_black_list apply only to the '
                'eager paddle.amp.auto_cast path and are ignored here'
                % amp_dtype)
    sdict['amp_dtype'] = amp_dtype

    # recompute -> per-block recompute when the model declares segments
    # (enable_recompute), else whole-forward remat in the step; set both
    # ways so an earlier build's flag does not leak
    remat = False
    if hasattr(model, 'enable_recompute'):
        model.enable_recompute(bool(sdict['recompute']))
    elif sdict['recompute']:
        remat = True

    # vocab-parallel fused CE under plain tensor parallelism (local max
    # and sum + small all-reduces over 'mp' instead of a gathered head);
    # not under sp, whose rows mix sharded sequence
    fce_sharding = None
    if 'mp' in shape and (shape['mp'] > 1 or sdict['tensor_parallel']) \
            and shape.get('sp', 1) <= 1:
        rows = tuple(a for a in ('dp', 'sharding') if shape.get(a, 1) > 1)
        fce_sharding = strategy_mod.NamedSharding(
            mesh, strategy_mod.P(rows if rows else None, 'mp'))

    cfg = strategy_mod.build_shardings(model, optimizer, mesh, sdict)
    amp_torch = None
    if amp_dtype is not None:
        from ...framework.dtype import to_torch_dtype
        amp_torch = to_torch_dtype(amp_dtype)
    swapped = strategy_mod.place_params(model, cfg['param_shardings'],
                                        amp_torch)
    strategy_mod.place_opt_slots(model, optimizer, cfg['out_shardings'][2],
                                 swapped)
    step = func_mod.TrainStep(
        model, loss_fn, optimizer,
        out_shardings=cfg['out_shardings'],
        mesh=mesh,
        batch_sharding=cfg['batch_sharding'],
        k_steps=gm_k,
        grad_merge_avg=s.gradient_merge_configs.get('avg', True)
        if s.gradient_merge else True,
        amp_dtype=amp_dtype,
        remat=remat,
        sp_state=sp_state,
        pp_state=pp_state,
        init_loss_scaling=s.amp_configs.get('init_loss_scaling', 65536.0),
        ls_growth_interval=s.amp_configs.get('incr_every_n_steps', 2000),
        fce_sharding=fce_sharding)
    _FLEET['train_step'] = step
    return step


def minimize(loss, startup_program=None, parameter_list=None,
             no_grad_set=None):
    opt = _FLEET['optimizer']
    return opt.minimize(loss)


def distributed_scaler(scaler):
    """The scaler as it is: a rank's grads are all-reduced before its
    found-inf check, so an overflow anywhere is seen everywhere."""
    return scaler


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
    """reference fleet save_persistables: PS mode saves every service
    table listed in PADDLE_FLEET_PS_TABLE_IDS (default '0') through the
    service under `dirname`/table_<id>; otherwise the model registered by
    distributed_model is written to `dirname`/persistables.pdparams
    (sharded parameters gathered whole, written by rank 0)."""
    from ..ps import runtime as ps_runtime
    client = ps_runtime.get_client()
    if client is not None:
        tids = os.environ.get('PADDLE_FLEET_PS_TABLE_IDS', '0')
        for tid in tids.split(','):
            client.save(int(tid), os.path.join(dirname,
                                               'table_%s' % tid.strip()))
        return
    model = _FLEET['model']
    if model is None:
        raise RuntimeError('save_persistables: no fleet model registered '
                           '(call fleet.distributed_model first) and no '
                           'PS service is running')
    from torch.distributed.tensor import DTensor
    from ...framework.io_save import save
    state = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
             for k, v in model.state_dict().items()}
    if get_rank() == 0:
        os.makedirs(dirname, exist_ok=True)
        save(state, os.path.join(dirname, 'persistables.pdparams'))
