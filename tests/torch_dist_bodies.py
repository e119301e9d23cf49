"""Rank bodies and the world harness of the collective tests
(test_torch_collective.py, test_torch_fleet.py, test_torch_ring.py).

A spawn child imports the module that defines its function again, so the
rank bodies live here, where nothing imports jax or paddle_tpu: only
torch, numpy and paddle_tpu_torch. A world is one gloo job of N CPU ranks
(paddle_tpu_torch.distributed.spawn with backend='gloo') that runs a list
of sections in order and writes each rank's results to a pickle; the
tests compare them with the JAX package's results computed in the test
process. `world_results` runs a world once per test session, whatever
the number of pytest-xdist workers: the first worker to take the lock
runs it and the others read its results.
"""
import fcntl
import os
import pickle
import time
import traceback

import numpy as np
import torch

ENV_KEYS = ('PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM',
            'PADDLE_CURRENT_ENDPOINT', 'PADDLE_TRAINER_ENDPOINTS',
            'PADDLE_DISTRI_BACKEND', 'PADDLE_DISTRI_DEVICE')
WORLD_TIMEOUT = 240


# ---- the harness (test process) ----------------------------------------

def shared_root(tmp_path_factory):
    """A directory of this test session that every xdist worker shares:
    the parent of a worker's base temp directory (pytest-<n>/popen-gw<i>),
    or the base temp directory itself without xdist."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        base = base.parent
    return str(base)


def world_results(root, name, nprocs, job):
    """{rank: results} of the world `name` run over `job` ({'sections':
    [(key, spec), ...], ...}); run once per session under a file lock in
    `root` (a directory every xdist worker shares)."""
    out_dir = os.path.join(root, 'world_' + name)
    done = os.path.join(out_dir, 'done')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(root, 'world_%s.lock' % name), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(done):
                _run_world(out_dir, nprocs, job)
                open(done, 'w').close()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    out = {}
    for r in range(nprocs):
        with open(os.path.join(out_dir, 'rank%d.pkl' % r), 'rb') as f:
            out[r] = pickle.load(f)
    return out


def world_results_beside(root, name, nprocs, job, work):
    """(world_results(root, name, nprocs, job), work()): the world's ranks
    run in their processes while this process computes work() (the JAX
    references: its compiles release the interpreter lock)."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(world_results, root, name, nprocs, job)
        try:
            done = work()
        finally:
            results = world.result()
    return results, done


def _run_world(out_dir, nprocs, job):
    from paddle_tpu_torch.distributed import spawn
    job_path = os.path.join(out_dir, 'job.pkl')
    with open(job_path, 'wb') as f:
        pickle.dump(job, f)
    ctx = spawn(world_main, args=(job_path, out_dir), nprocs=nprocs,
                join=False, backend='gloo',
                env={'OMP_NUM_THREADS': '1', 'GLOO_SOCKET_IFNAME': 'lo'})
    deadline = time.time() + WORLD_TIMEOUT
    for p in ctx.processes:
        p.join(max(1.0, deadline - time.time()))
    alive = [p for p in ctx.processes if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise RuntimeError('world in %s did not finish in %d s'
                           % (out_dir, WORLD_TIMEOUT))
    ctx.join()


def section(results, key):
    """Every rank's result of one section; raises with a rank's traceback
    when the section failed there."""
    out = {}
    for r, res in results.items():
        got = res[key]
        if isinstance(got, dict) and 'error' in got:
            raise AssertionError('rank %d, section %s:\n%s'
                                 % (r, key, got['error']))
        out[r] = got
    return out


# ---- the ranks ----------------------------------------------------------

def world_main(job_path, out_dir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.framework import device
    device.set_device('cpu')
    import paddle_tpu_torch.distributed as dist
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    dist.init_parallel_env()
    rank = dist.get_rank()
    res = {'env': {k: os.environ.get(k) for k in ENV_KEYS}}
    for key, spec in job['sections']:
        try:
            res[key] = SECTIONS[spec['kind']](spec)
        except Exception:
            res[key] = {'error': traceback.format_exc()}
    with open(os.path.join(out_dir, 'rank%d.pkl' % rank), 'wb') as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def fail_on_rank(rank):
    """A body that raises on `rank` (spawn's error propagation)."""
    if int(os.environ['PADDLE_TRAINER_ID']) == rank:
        raise ValueError('rank %d fails on purpose' % rank)


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy().copy()


def _collectives(spec):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import p2p_shift
    rank, world = dist.get_rank(), dist.get_world_size()
    base = torch.arange(6.0).reshape(2, 3) + 10 * rank + 1
    out = {}
    for name, op in (('sum', dist.ReduceOp.SUM), ('max', dist.ReduceOp.MAX),
                     ('min', dist.ReduceOp.MIN), ('prod', dist.ReduceOp.PROD),
                     ('avg', dist.ReduceOp.AVG)):
        t = base.clone()
        dist.all_reduce(t, op=op)
        out['all_reduce_' + name] = t.numpy()
    got = []
    dist.all_gather(got, base.clone())
    out['all_gather'] = np.stack([t.numpy() for t in got])
    t = base.clone()
    dist.broadcast(t, src=world - 1)
    out['broadcast'] = t.numpy()
    t = base.clone()
    dist.reduce(t, dst=0)
    out['reduce'] = t.numpy()
    t = torch.zeros(2, 3)
    dist.scatter(t, [torch.full((2, 3), float(i)) for i in range(world)]
                 if rank == 0 else None, src=0)
    out['scatter'] = t.numpy()
    parts = dist.alltoall([base[0] * 0 + 100 * rank + j for j in
                           range(world)])
    out['alltoall'] = np.stack([p.numpy() for p in parts])
    t = base.clone()
    if rank == 0:
        dist.send(t * 2, dst=1)
    elif rank == 1:
        dist.recv(t, src=0)
    out['send_recv'] = t.numpy()
    x = base.clone().requires_grad_()
    y = p2p_shift(x, dist.get_group(0), 1)
    (y * (rank + 1)).sum().backward()
    out['p2p_shift'] = y.detach().numpy()
    out['p2p_shift_grad'] = x.grad.numpy()
    g = dist.new_group(list(range(world)))
    t = base.clone()
    dist.all_reduce(t, group=g)
    out['new_group'] = (t.numpy(), dist.get_group(g.id).ranks, g.rank)
    dist.barrier()
    dist.wait(t)
    return out


def _hcg(spec):
    from paddle_tpu_torch.distributed import HybridCommunicateGroup
    out = []
    for deg in spec['degrees']:
        try:
            hcg = HybridCommunicateGroup(**deg)
        except ValueError as e:
            out.append({'error_value': str(e)})
            continue
        acc = {}
        for name in ('data_parallel', 'model_parallel', 'pipe_parallel',
                     'sharding_parallel', 'sequence_parallel',
                     'expert_parallel'):
            acc[name + '_world_size'] = getattr(
                hcg, 'get_%s_world_size' % name)()
            if name != 'pipe_parallel':
                acc[name + '_rank'] = getattr(hcg, 'get_%s_rank' % name)()
        acc['stage_id'] = hcg.get_stage_id()
        acc['topology_dims'] = [hcg.topology().get_dim(a) for a in
                                ('data', 'pipe', 'sharding', 'model')]
        acc['groups'] = {a: hcg._group(a).ranks for a in
                         ('dp', 'mp', 'sharding', 'sp')}
        acc['check_group'] = hcg.get_check_parallel_group().ranks
        out.append(acc)
    return out


def _flat_cache(spec):
    """flat_group's groups over ('dp', 'sharding') for meshes of each
    degree set in turn, each mesh dropped before the next is made: the
    group's ranks, and whether the dropped mesh is still alive (held by
    the cache, so a later mesh cannot take its id)."""
    import gc
    import weakref
    from paddle_tpu_torch.distributed import HybridCommunicateGroup
    from paddle_tpu_torch.distributed.topology import flat_group
    out = []
    for deg in spec['degrees']:
        hcg = HybridCommunicateGroup(**deg)
        group = flat_group(hcg.mesh, ('dp', 'sharding'))
        ref = weakref.ref(hcg.mesh)
        del hcg
        gc.collect()
        out.append({'ranks': group.ranks, 'alive': ref() is not None})
    return out


def _place_full(param, full):
    """Copy the whole value `full` into a (possibly DTensor) parameter."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    full = torch.as_tensor(full)
    with torch.no_grad():
        if isinstance(param, DTensor):
            param.to_local().copy_(distribute_tensor(
                full, param.device_mesh, param.placements).to_local())
        else:
            param.copy_(full)


def _tp_layers(spec):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    world = dist.get_world_size()
    hcg = dist.HybridCommunicateGroup(dp_degree=1, mp_degree=world)
    set_hybrid_communicate_group(hcg)
    w = spec['weights']
    col = ColumnParallelLinear(*w['col_w'].shape, device='cpu')
    row = RowParallelLinear(*w['row_w'].shape, device='cpu')
    emb = VocabParallelEmbedding(*w['emb_w'].shape, device='cpu')
    for layer, key in ((col, 'col'), (row, 'row')):
        _place_full(layer.weight, w[key + '_w'])
        _place_full(layer.bias, w[key + '_b'])
    _place_full(emb.weight, w['emb_w'])
    x = torch.tensor(w['x'], requires_grad=True)
    mid = col(x)
    out = row(mid)
    (out * torch.tensor(w['cot'])).sum().backward()
    ids = torch.tensor(w['ids'])
    e = emb(ids)
    (e * torch.tensor(w['emb_cot'])).sum().backward()
    ce = ParallelCrossEntropy()
    logits = torch.tensor(w['logits'])
    cols = logits.shape[-1] // world
    r = hcg.get_model_parallel_rank()
    local = logits[:, r * cols:(r + 1) * cols].clone().requires_grad_()
    loss = ce(local, torch.tensor(w['labels']))
    loss.sum().backward()
    grads = [None] * world
    torch.distributed.all_gather_object(grads, local.grad.numpy())
    res = {'mid': _np(mid), 'out': _np(out), 'x_grad': _np(x.grad),
           'col_w_grad': _np(col.weight.grad),
           'col_b_grad': _np(col.bias.grad),
           'row_w_grad': _np(row.weight.grad),
           'row_b_grad': _np(row.bias.grad),
           'emb': _np(e), 'emb_grad': _np(emb.weight.grad),
           'ce': _np(loss), 'ce_grad': np.concatenate(grads, axis=1),
           'placements': {k: str(getattr(lay, 'weight').placements)
                          for k, lay in (('col', col), ('row', row),
                                         ('emb', emb))}}
    set_hybrid_communicate_group(None)
    return res


def _attention(spec):
    from torch.distributed.device_mesh import init_device_mesh
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import sp as sp_mod
    from paddle_tpu_torch.ops import ring_attention as ra
    world = dist.get_world_size()
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('sp',))
    d = spec['data']
    out = {}
    for name, causal in spec['cases']:
        q, k, v = (torch.tensor(d[n], requires_grad=True)
                   for n in ('q', 'k', 'v'))
        if name == 'zigzag':
            state = sp_mod.make_sp_state(mesh, 'sp', 'zigzag')
            from paddle_tpu_torch.distributed.meta_parallel.mp_layers import \
                MPGroup, gather_replicated, scatter_to_mp
            grp = MPGroup(mesh.get_group('sp'), mesh.get_local_rank('sp'),
                          world, None)
            o = sp_mod.sp_attention(
                *(scatter_to_mp(t, 1, grp) for t in (q, k, v)),
                causal=causal, scale=1.0 / np.sqrt(q.shape[-1]),
                state=state)
            o = gather_replicated(o, 1, grp)
        else:
            fn = getattr(ra, name + '_sharded')
            o = fn(q, k, v, mesh, causal=causal)
        (o * torch.tensor(d['cot'])).sum().backward()
        out['%s_%s' % (name, causal)] = {
            'out': _np(o), 'dq': _np(q.grad), 'dk': _np(k.grad),
            'dv': _np(v.grad)}
    return out


def _fleet_strategy(case):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict({'dp_degree': 1, 'mp_degree': 1,
                             'pp_degree': 1, 'sharding_degree': 1,
                             'sp_degree': 1}, **case['hybrid'])
    for key, value in case.get('flags', {}).items():
        setattr(s, key, value)
    for key, value in case.get('configs', {}).items():
        getattr(s, key).update(value)
    return s


def _full_state(model):
    """The model's state_dict as whole numpy arrays (a sharded one's
    gathered: a collective)."""
    return {k: _np(v) for k, v in model.state_dict().items()}


def _opt_state(opt):
    """opt.state_dict() with its tensors as whole numpy arrays."""
    return {k: _np(v) if torch.is_tensor(v) else v
            for k, v in opt.state_dict().items()}


def _fleet_model(case, spec, state, opt_state=None, load=None):
    """A fresh GPT, AdamW and fleet_train_step under the case's strategy,
    its weights from `state` and, with opt_state, the optimizer's loaded
    before ('before') or after ('after') the step is built. A case with
    'clip' (clip_norm, lr) takes SGD with ClipGradByGlobalNorm instead."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    s = _fleet_strategy(case)
    fleet.init(is_collective=True, strategy=s)
    model = GPTForCausalLM(GPTConfig(**case['config']), device='cpu')
    load_paddle_tpu_state(model, state)
    if case.get('clip'):
        norm, lr = case['clip']
        opt = SGD(learning_rate=lr, parameters=model.parameters(),
                  grad_clip=ClipGradByGlobalNorm(norm))
    else:
        opt = AdamW(learning_rate=spec['lr'], weight_decay=spec['wd'],
                    parameters=model.parameters())
    if load == 'before':
        opt.set_state_dict(opt_state)
    step = fleet.fleet_train_step(model, model.loss, opt, strategy=s)
    if load == 'after':
        opt.set_state_dict(opt_state)
    return model, opt, step


def _plain_opt_state(case, spec, ids, labels):
    """The optimizer's state_dict after spec['steps'] plain TrainSteps on
    the whole batch (no mesh)."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    model = GPTForCausalLM(GPTConfig(**case['config']), device='cpu')
    load_paddle_tpu_state(model, case['state'])
    opt = AdamW(learning_rate=spec['lr'], weight_decay=spec['wd'],
                parameters=model.parameters())
    step = TrainStep(model, model.loss, opt)
    for _ in range(spec['steps']):
        step(ids, labels)
    return _opt_state(opt)


def _fleet_grads(case, spec, ids, labels):
    """One SGD step at lr 1 (each parameter moves by its grad) under the
    case's strategy and as a plain TrainStep on the whole batch:
    {parameter: |move - plain move| / |plain move|}. Adam's per-element
    scaling hides a grad's scale from the losses; this does not."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    moves = []
    for sharded in (False, True):
        model = GPTForCausalLM(GPTConfig(**case['config']), device='cpu')
        load_paddle_tpu_state(model, case['state'])
        opt = SGD(learning_rate=1.0, parameters=model.parameters())
        if sharded:
            s = _fleet_strategy(case)
            fleet.init(is_collective=True, strategy=s)
            step = fleet.fleet_train_step(model, model.loss, opt, strategy=s)
        else:
            step = TrainStep(model, model.loss, opt)
        step(ids, labels)
        moves.append({n: _np(p) - case['state'][n]
                      for n, p in model.named_parameters()})
    plain, got = moves
    # a pipeline stage holds only its own parameters
    return {n: float(np.linalg.norm(got[n] - plain[n]) /
                     np.linalg.norm(plain[n])) for n in got}


def _sgd_moves(case, spec, ids, labels):
    """Each parameter's move in one SGD step at lr 1 under the case's
    strategy (minus its grad), whole."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    model = GPTForCausalLM(GPTConfig(**case['config']), device='cpu')
    load_paddle_tpu_state(model, case['state'])
    opt = SGD(learning_rate=1.0, parameters=model.parameters())
    s = _fleet_strategy(case)
    fleet.init(is_collective=True, strategy=s)
    step = fleet.fleet_train_step(model, model.loss, opt, strategy=s)
    step(ids, labels)
    return {n: _np(p) - case['state'][n]
            for n, p in model.named_parameters()}


def _fleet(spec):
    """fleet_train_step's losses under each case's strategy; for a case
    with 'grads', each parameter's first SGD move against a plain step's
    (_fleet_grads); for a case with 'resume', also the optimizer's state_dict after the steps beside
    a plain step's, and two more steps unbroken beside the same two steps
    of fresh steps loaded from the model's and the optimizer's state
    (the optimizer's loaded before and after the step is built)."""
    from torch.distributed.tensor import DTensor
    from paddle_tpu_torch.distributed import fleet
    ids, labels = (torch.tensor(spec[k]).long() for k in ('ids', 'labels'))
    out = {}
    for case in spec['cases']:
        model, opt, step = _fleet_model(case, spec, case['state'])
        losses = [float(step(ids, labels)) for _ in range(spec['steps'])]
        placed = {n: str(p.placements) for n, p in model.named_parameters()
                  if isinstance(p, DTensor)}
        pp = getattr(step, '_pp_state', None)
        hcg = fleet.get_hybrid_communicate_group()
        tied = hcg.get_pipe_tied_group()
        line = {'first': hcg.is_first_stage, 'last': hcg.is_last_stage,
                'prev': hcg.get_p2p_prev_rank(),
                'next': hcg.get_p2p_next_rank(),
                'tied': None if tied is None else tied.ranks,
                'rank': torch.distributed.get_rank()}
        out[case['name']] = {
            'pp_line': line,
            'losses': losses, 'placed': placed,
            'step': type(step).__name__,
            'pp_stats': getattr(step, 'pp_stats', None),
            'pp_state': None if pp is None else
            {k: pp[k] for k in ('n_stages', 'n_micro', 'schedule', 'remat')},
            'params': sorted(n for n, _ in model.named_parameters())}
        if case.get('grads'):
            out[case['name']]['grad_rel'] = _fleet_grads(case, spec, ids,
                                                         labels)
        if case.get('moves'):
            out[case['name']]['moves'] = _sgd_moves(case, spec, ids, labels)
        if not case.get('resume'):
            continue
        state, opt_state = _full_state(model), _opt_state(opt)
        unbroken = [float(step(ids, labels)) for _ in range(2)]
        resumed = {}
        for load in ('before', 'after'):
            _, _, fresh = _fleet_model(case, spec, state, opt_state, load)
            resumed[load] = [float(fresh(ids, labels)) for _ in range(2)]
        out[case['name']]['resume'] = {
            'opt_state': opt_state, 'unbroken': unbroken,
            'resumed': resumed,
            'plain_opt_state': _plain_opt_state(case, spec, ids, labels),
            'shapes': {n: tuple(p.shape)
                       for n, p in model.named_parameters()}}
    return out


def _data_parallel(spec):
    import paddle_tpu_torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    lin = torch.nn.Linear(*spec['w'].shape)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(spec['w']).t())
        lin.bias.zero_()
    model = dist.DataParallel(lin)
    x = torch.tensor(spec['x'])
    rows = x.shape[0] // world
    loss = model(x[rank * rows:(rank + 1) * rows]).square().mean()
    loss.backward()
    synced = lin.weight.grad.numpy().copy()
    with model.no_sync():
        model(x[:1]).sum().backward()
    return {'synced': synced,
            'no_sync_delta': lin.weight.grad.numpy() - synced,
            'state_keys': sorted(model.state_dict())}


def _persist(spec):
    """fleet's collective surface on a tensor-parallel model: the
    optimizer wrapper, distributed_model laying the parameters out, the
    hybrid group, and save_persistables writing whole parameters."""
    from torch.distributed.tensor import DTensor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import io_save
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {'dp_degree': 1, 'mp_degree': 2}
    s.tensor_parallel = True
    fleet.init(is_collective=True, strategy=s)
    model = GPTForCausalLM(GPTConfig(**spec['config']), device='cpu')
    load_paddle_tpu_state(model, spec['state'])
    opt = fleet.distributed_optimizer(AdamW(parameters=model.parameters()))
    fleet.distributed_model(model)
    placed = sorted(n for n, p in model.named_parameters()
                    if isinstance(p, DTensor))
    fleet.save_persistables(None, spec['dir'])
    torch.distributed.barrier()
    saved = io_save.load(os.path.join(spec['dir'],
                                      'persistables.pdparams'))
    hcg = fleet.get_hybrid_communicate_group()
    # a trust-ratio rule needs whole-parameter norms: refused over shards
    from paddle_tpu_torch.optimizer import Lamb
    ids = torch.arange(16).reshape(2, 8) % spec['config']['vocab_size']
    lamb = fleet.fleet_train_step(model, model.loss,
                                  Lamb(parameters=model.parameters()),
                                  strategy=s)
    try:
        lamb(ids, ids)
        lamb_refused = ''
    except NotImplementedError as e:
        lamb_refused = str(e)
    return {'placed': placed, 'mp': hcg.get_model_parallel_world_size(),
            'lamb_refused': lamb_refused,
            'optimizer_params': sum(p.numel() for p in
                                    opt._inner._parameter_list),
            'saved': {k: np.asarray(torch.as_tensor(v).float())
                      for k, v in saved.items()}}


def _pipeline_layer(spec):
    """PipelineParallel.train_batch over a PipelineLayer whose first and
    last stage share an embedding (SharedLayerDesc): the losses, and the
    shared weight on each stage after the steps."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed.meta_parallel import (
        LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)
    from paddle_tpu_torch.distributed.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    w = spec['weights']
    vocab, hidden = w['embed'].shape
    hcg = dist.HybridCommunicateGroup(pp_degree=dist.get_world_size())
    set_hybrid_communicate_group(hcg)

    def head(layer, x):
        return torch.matmul(x, layer.weight.t())

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1))

    descs = [SharedLayerDesc('embed', pnn.Embedding, None, 'weight', vocab,
                             hidden, device='cpu'),
             LayerDesc(pnn.Linear, hidden, hidden, device='cpu'),
             torch.tanh,
             LayerDesc(pnn.Linear, hidden, hidden, device='cpu'),
             SharedLayerDesc('embed', pnn.Embedding, head, 'weight', vocab,
                             hidden, device='cpu')]
    layer = PipelineLayer(descs, loss_fn=loss_fn)
    for i, key in ((1, 'A'), (3, 'B')):
        lin = layer.layer(i)
        if lin is not None:
            with torch.no_grad():
                lin.weight.copy_(torch.tensor(w[key + '_w']))
                lin.bias.copy_(torch.tensor(w[key + '_b']))
    emb = layer.layer(0) or layer.layer(4)
    with torch.no_grad():
        emb.weight.copy_(torch.tensor(w['embed']))
    model = PipelineParallel(layer, hcg)
    opt = AdamW(learning_rate=spec['lr'], parameters=layer.parameters())
    x, y = (torch.tensor(spec[k]).long() for k in ('ids', 'labels'))
    losses = [float(model.train_batch((x, y), opt))
              for _ in range(spec['steps'])]
    out = {'losses': losses, 'stage': hcg.get_stage_id(),
           'embed': _np(emb.weight),
           'tied': len(layer.tied_params()),
           'n_micro': model._engine.n_micro}
    set_hybrid_communicate_group(None)
    return out


SECTIONS = {'persist': _persist, 'collectives': _collectives, 'hcg': _hcg,
            'flat_cache': _flat_cache, 'tp': _tp_layers,
            'attention': _attention, 'fleet': _fleet,
            'data_parallel': _data_parallel,
            'pipeline_layer': _pipeline_layer}
