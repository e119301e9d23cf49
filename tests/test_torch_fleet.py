"""fleet.fleet_train_step and the tensor-parallel layers of the port
(paddle_tpu_torch/distributed/{fleet,strategy,meta_parallel}, TrainStep's
distributed options) in gloo worlds of 2 and 4 CPU ranks, against the JAX
package on as many of its virtual devices. The JAX GPT's initial
state_dict() is carried across (load_paddle_tpu_state) and each rank
takes its shard; the global batch goes to both sides. Losses over 3 steps
within rtol 1e-4, the JAX package's own bound (tests/test_distributed.py).
The rank bodies are in torch_dist_bodies.py (nothing there imports jax).
"""
import os

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import HybridCommunicateGroup as JaxHCG
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.meta_parallel import (ColumnParallelLinear,
                                                  ParallelCrossEntropy,
                                                  RowParallelLinear,
                                                  VocabParallelEmbedding)
from paddle_tpu.text.models import gpt as jgpt

import torch_dist_bodies as bodies

CONFIG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
              max_position_embeddings=32, dropout=0.0, fused_loss=True)
BATCH, SEQ, STEPS, LR, WD = 4, 32, 3, 1e-3, 0.01
# 'mp 2' runs the 2-layer GPT; the other cases one layer of
# it (each JAX fleet step compiles for seconds a layer)
MP_CASES = ('mp2',)
# the strategies whose TrainStep updates parameters through their shards:
# the optimizer's state_dict / set_state_dict must see the slots it uses
RESUME_CASES = ('sharding2_stage1', 'mp2', 'dp2_sharding2_stage3',
                'dp2_mp2', 'mp2_sp2_ring')
# the strategies that run TrainStep on the mean loss of the global batch:
# each parameter's grad equals a plain step's on the whole batch
GRAD_CASES = ('dp2', 'sharding2_stage1', 'mp2', 'sp2_ring', 'sp2_zigzag',
              'sp2_ulysses', 'dp2_sharding2_stage3', 'dp2_mp2',
              'mp2_sp2_ring')

# (name, world, hybrid degrees, strategy flags, strategy configs)
CASES = [
    ('dp2', 2, {'dp_degree': 2}, {}, {}),
    ('sharding2_stage1', 2, {'sharding_degree': 2},
     {'sharding': True}, {'sharding_configs': {'stage': 1}}),
    ('mp2', 2, {'mp_degree': 2}, {'tensor_parallel': True}, {}),
    ('sp2_ring', 2, {'sp_degree': 2}, {'sequence_parallel': True},
     {'sequence_parallel_configs': {'mode': 'ring'}}),
    ('sp2_zigzag', 2, {'sp_degree': 2}, {'sequence_parallel': True},
     {'sequence_parallel_configs': {'mode': 'zigzag'}}),
    ('sp2_ulysses', 2, {'sp_degree': 2}, {'sequence_parallel': True},
     {'sequence_parallel_configs': {'mode': 'ulysses'}}),
    ('localsgd', 2, {'dp_degree': 2}, {'localsgd': True},
     {'localsgd_configs': {'k_steps': 2}}),
    ('dgc', 2, {'dp_degree': 2}, {'dgc': True},
     {'dgc_configs': {'sparsity': 0.75, 'rampup_begin_step': 1}}),
    ('fp16_allreduce', 2, {'dp_degree': 2}, {'fp16_allreduce': True}, {}),
    ('dp2_merge2_recompute', 2, {'dp_degree': 2},
     {'gradient_merge': True, 'recompute': True},
     {'gradient_merge_configs': {'k_steps': 2}}),
    ('dp2_sharding2_stage3', 4, {'dp_degree': 2, 'sharding_degree': 2},
     {'sharding': True}, {'sharding_configs': {'stage': 3}}),
    ('dp2_mp2', 4, {'dp_degree': 2, 'mp_degree': 2},
     {'tensor_parallel': True}, {}),
    ('mp2_sp2_ring', 4, {'mp_degree': 2, 'sp_degree': 2},
     {'tensor_parallel': True, 'sequence_parallel': True},
     {'sequence_parallel_configs': {'mode': 'ring'}}),
]


def _strategy(module, hybrid, flags, configs):
    s = module.DistributedStrategy()
    s.hybrid_configs = dict({'dp_degree': 1, 'mp_degree': 1, 'pp_degree': 1,
                             'sharding_degree': 1, 'sp_degree': 1}, **hybrid)
    for key, value in flags.items():
        setattr(s, key, value)
    for key, value in configs.items():
        getattr(s, key).update(value)
    return s


def _config(name):
    return dict(CONFIG, num_layers=2 if name in MP_CASES else 1)


def _jax_model(name):
    paddle.seed(23)
    return jgpt.GPTForCausalLM(jgpt.GPTConfig(**_config(name)))


def _batch():
    rng = np.random.RandomState(5)
    return (rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)),
            rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)))


@pytest.fixture(scope='module')
def shared_root(tmp_path_factory):
    return bodies.shared_root(tmp_path_factory)


def _fleet_job(world):
    ids, labels = _batch()
    cases = []
    for name, w, hybrid, flags, configs in CASES:
        if w == world:
            jm = _jax_model(name)
            cases.append({'name': name, 'hybrid': hybrid, 'flags': flags,
                          'configs': configs, 'config': _config(name),
                          'resume': name in RESUME_CASES,
                          'grads': name in GRAD_CASES,
                          'state': {k: np.asarray(v.numpy()) for k, v in
                                    jm.state_dict().items()}})
    return {'kind': 'fleet', 'cases': cases, 'ids': ids, 'labels': labels,
            'lr': LR, 'wd': WD, 'steps': STEPS}


def _tp_job():
    paddle.seed(7)
    col = ColumnParallelLinear(8, 16)
    row = RowParallelLinear(16, 8)
    emb = VocabParallelEmbedding(12, 6)
    rng = np.random.RandomState(3)
    w = {'col_w': col.weight.numpy(), 'col_b': col.bias.numpy() + 0.1,
         'row_w': row.weight.numpy(), 'row_b': row.bias.numpy() + 0.2,
         'emb_w': emb.weight.numpy(),
         'x': rng.standard_normal((4, 8)).astype(np.float32),
         'cot': rng.standard_normal((4, 8)).astype(np.float32),
         'ids': rng.randint(0, 12, (3, 5)),
         'emb_cot': rng.standard_normal((3, 5, 6)).astype(np.float32),
         'logits': rng.standard_normal((6, 10)).astype(np.float32) * 3,
         'labels': np.array([0, 9, 4, 5, -100, 7])}
    return {'kind': 'tp', 'weights': w}, (col, row, emb)


def _persist_job(root):
    jm = _jax_model('mp2')
    return {'kind': 'persist', 'config': _config('mp2'),
            'dir': os.path.join(root, 'fleet2_persistables'),
            'state': {k: np.asarray(v.numpy()) for k, v in
                      jm.state_dict().items()}}


@pytest.fixture(scope='module')
def world2(shared_root):
    tp, layers = _tp_job()
    job = {'sections': [('tp', tp), ('fleet', _fleet_job(2)),
                        ('persist', _persist_job(shared_root))]}
    return bodies.world_results(shared_root, 'fleet2', 2, job), tp, layers


@pytest.fixture(scope='module')
def world4(shared_root):
    job = {'sections': [('fleet', _fleet_job(4))]}
    return bodies.world_results(shared_root, 'fleet4', 4, job)


def _jax_losses(name, world, hybrid, flags, configs):
    s = _strategy(jfleet, hybrid, flags, configs)
    hcg = JaxHCG(devices=jax.devices()[:world],
                 **{k: v for k, v in s.hybrid_configs.items()})
    jfleet._FLEET['strategy'] = s
    jm = _jax_model(name)
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=jm.parameters())
    step = jfleet.fleet_train_step(jm, jm.loss, opt, strategy=s, hcg=hcg)
    ids, labels = _batch()
    return [float(np.asarray(step(paddle.to_tensor(ids),
                                  paddle.to_tensor(labels)).numpy()))
            for _ in range(STEPS)]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_fleet_train_step_matches_jax(case, request):
    name, world = case[0], case[1]
    results = request.getfixturevalue('world%d' % world)
    if world == 2:
        results = results[0]
    got = bodies.section(results, 'fleet')
    want = _jax_losses(*case)
    for rank in range(world):
        np.testing.assert_allclose(got[rank][name]['losses'], want,
                                   rtol=1e-4, err_msg='%s rank %d'
                                   % (name, rank))
    run = got[0][name]
    explicit = name in ('localsgd', 'dgc', 'fp16_allreduce')
    assert run['step'] == ('ShardMapDPStep' if explicit else 'TrainStep')
    if 'stage3' in name:
        # FSDP2 laid every parameter out over the sharding axis
        assert run['placed'] and all('Shard(dim=0)' in p
                                     for p in run['placed'].values())
    elif 'mp2' in name:
        # the GPT's placement hints as DTensors over 'mp'
        assert 'gpt.h.0.attn.qkv_proj.weight' in run['placed']
        assert run['placed']['gpt.wte.weight'] == '(Shard(dim=0),)'
        assert 'gpt.h.0.ln_1.weight' not in run['placed']
    else:
        assert not run['placed']


@pytest.mark.parametrize('name', GRAD_CASES)
def test_fleet_grads_match_plain_step(name, request):
    """Each parameter's grad under the strategy (its move in one SGD step
    at lr 1) equals a plain TrainStep's on the whole batch within 1e-4 in
    norm: a grad summed where it should be averaged, or taken on part of
    the batch, fails here, where Adam would hide it from the losses."""
    world = next(c[1] for c in CASES if c[0] == name)
    results = request.getfixturevalue('world%d' % world)
    if world == 2:
        results = results[0]
    got = bodies.section(results, 'fleet')
    for rank in range(world):
        rel = got[rank][name]['grad_rel']
        worst = max(rel, key=rel.get)
        assert rel[worst] < 1e-4, (name, rank, worst, rel[worst])


@pytest.mark.parametrize('name', RESUME_CASES)
def test_fleet_optimizer_state_resumes(name, request):
    """Under a sharded strategy the optimizer's state_dict gives the
    moments the step uses, at the parameters' global shapes (those of a
    plain TrainStep after the same steps, within 1e-4 in norm), and a
    fresh step loaded from it, before or after the step is built, takes
    the next two steps as the unbroken run does (losses within 1e-4)."""
    world = next(c[1] for c in CASES if c[0] == name)
    results = request.getfixturevalue('world%d' % world)
    if world == 2:
        results = results[0]
    got = bodies.section(results, 'fleet')
    for rank in range(world):
        run = got[rank][name]['resume']
        state, plain = run['opt_state'], run['plain_opt_state']
        assert sorted(state) == sorted(plain)
        assert state['step'] == STEPS
        moments = [k for k in state if k.endswith(('_moment1', '_moment2'))]
        assert len(moments) == 2 * len(run['shapes'])
        for key in moments:
            a, b = state[key], plain[key]
            assert a.shape == b.shape, key
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err < 1e-4, (name, rank, key, err)
        for load, losses in run['resumed'].items():
            np.testing.assert_allclose(
                losses, run['unbroken'], rtol=1e-4,
                err_msg='%s rank %d, loaded %s the step is built'
                % (name, rank, load))


def test_tp_layers_match_jax(world2):
    results, tp, (col, row, emb) = world2
    got = bodies.section(results, 'tp')
    w = tp['weights']
    x, cot = w['x'], w['cot']
    mid = x @ w['col_w'] + w['col_b']
    out = mid @ w['row_w'] + w['row_b']
    # the JAX layers' forward on the same weights
    import paddle_tpu as paddle_
    col.bias._data = paddle_.to_tensor(w['col_b'])._data
    row.bias._data = paddle_.to_tensor(w['row_b'])._data
    jmid = col(paddle_.to_tensor(x))
    jout = row(jmid)
    np.testing.assert_allclose(jout.numpy(), out, rtol=1e-5, atol=1e-5)
    d_mid = cot @ w['row_w'].T
    for rank in range(2):
        g = got[rank]
        np.testing.assert_allclose(g['mid'], jmid.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g['out'], jout.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g['row_w_grad'], mid.T @ cot, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g['row_b_grad'], cot.sum(0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g['col_w_grad'], x.T @ d_mid, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g['col_b_grad'], d_mid.sum(0),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g['x_grad'], d_mid @ w['col_w'].T,
                                   rtol=1e-5, atol=1e-5)
        assert g['placements'] == {'col': '(Shard(dim=1),)',
                                   'row': '(Shard(dim=0),)',
                                   'emb': '(Shard(dim=0),)'}


def test_vocab_parallel_embedding_matches_jax(world2):
    results, tp, (col, row, emb) = world2
    got = bodies.section(results, 'tp')
    w = tp['weights']
    want = emb(paddle.to_tensor(w['ids'])).numpy()
    grad = np.zeros_like(w['emb_w'])
    np.add.at(grad, w['ids'].reshape(-1), w['emb_cot'].reshape(-1, 6))
    for rank in range(2):
        np.testing.assert_allclose(got[rank]['emb'], want, rtol=1e-6)
        np.testing.assert_allclose(got[rank]['emb_grad'], grad, rtol=1e-5,
                                   atol=1e-6)


def test_parallel_cross_entropy_matches_jax(world2):
    results, tp, _ = world2
    got = bodies.section(results, 'tp')
    w = tp['weights']
    logits, labels = w['logits'], w['labels']
    want = ParallelCrossEntropy()(paddle.to_tensor(logits),
                                  paddle.to_tensor(labels)).numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    valid = labels != -100
    p[np.arange(len(labels))[valid], labels[valid]] -= 1.0
    p[~valid] = 0.0
    for rank in range(2):
        np.testing.assert_allclose(got[rank]['ce'].reshape(want.shape),
                                   want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[rank]['ce_grad'], p, rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_and_left_out_options_raise():
    """The pipeline and MoE paths, which raised until their slice, build
    and run (tests/test_torch_pipeline.py and test_torch_moe.py hold them
    to the JAX package); MoE under a pipeline still raises, as in the JAX
    package."""
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import PipelineParallel
    from paddle_tpu_torch.distributed.pipeline import make_pp_state
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    wrapped = PipelineParallel(torch.nn.Linear(2, 2), None)
    assert callable(wrapped.train_batch)
    m = GPTForCausalLM(GPTConfig(**CONFIG), device='cpu')
    step = TrainStep(m, m.loss, AdamW(parameters=m.parameters()),
                     pp_state=make_pp_state(None, 1, n_micro=2))
    ids = torch.arange(64).reshape(2, 32) % CONFIG['vocab_size']
    assert np.isfinite(step(ids, ids).item())
    assert step.pp_stats['n_micro'] == 2
    pre, blocks, post = m.pp_decompose()
    assert len(blocks) == CONFIG['num_layers']
    moe = GPTForCausalLM(GPTConfig(**dict(CONFIG, num_experts=2)),
                         device='cpu')
    assert moe.gpt.h[0].mlp.num_experts == 2
    with pytest.raises(NotImplementedError, match='MoE'):
        moe.pp_decompose()


def test_strategy_specs_match_jax():
    """build_shardings' parameter, slot and batch specs are the JAX
    package's on the same degrees."""
    from paddle_tpu.distributed import strategy as jstrategy
    from paddle_tpu_torch.distributed import strategy as tstrategy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    class _Mesh:
        # the spec rules read only axis names and sizes
        mesh_dim_names = ('dp', 'pp', 'sharding', 'ep', 'mp', 'sp')

        def __init__(self, shape):
            self._shape = shape

        def size(self, i):
            return self._shape[i]
    jm = _jax_model('mp2')
    tm = GPTForCausalLM(GPTConfig(**CONFIG), device='cpu')
    topt = AdamW(parameters=tm.parameters())
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters())
    for hybrid, sdict in (({'dp_degree': 2, 'mp_degree': 2},
                           {'tensor_parallel': True}),
                          ({'dp_degree': 2, 'sharding_degree': 2},
                           {'zero_stage': 3}),
                          ({'sharding_degree': 2, 'dp_degree': 2},
                           {'zero_stage': 1}),
                          ({'sp_degree': 2, 'dp_degree': 2},
                           {'sequence_parallel': True})):
        hcg = JaxHCG(devices=jax.devices()[:4], **hybrid)
        shape = tuple(hcg.mesh.shape[a] for a in _Mesh.mesh_dim_names)
        jcfg = jstrategy.build_shardings(jm, jopt, hcg.mesh, sdict)
        tcfg = tstrategy.build_shardings(tm, topt, _Mesh(shape), sdict)
        for name, sh in jcfg['param_shardings'].items():
            assert tuple(tcfg['param_shardings'][name].spec) == \
                tuple(sh.spec), (hybrid, name)
        jslots = jcfg['out_shardings'][2]['slots']
        tslots = tcfg['out_shardings'][2]['slots']
        for name, slots in jslots.items():
            for k, sh in slots.items():
                assert tuple(tslots[name][k].spec)[:len(sh.spec)] == \
                    tuple(sh.spec), (hybrid, name, k)
        assert tuple(tcfg['batch_sharding'].spec) == \
            tuple(jcfg['batch_sharding'].spec), hybrid


def test_distributed_strategy_matches_jax():
    from paddle_tpu_torch.distributed import fleet as tfleet
    want = jfleet.DistributedStrategy().to_dict()
    got = tfleet.DistributedStrategy().to_dict()
    assert got == want
    s = tfleet.DistributedStrategy()
    s.sharding = True
    s.sharding_configs['stage'] = 2
    assert s._zero_stage() == 2


def test_dgc_compress_matches_jax():
    import torch
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        dgc_compress as jdgc
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        dgc_compress as tdgc
    rng = np.random.RandomState(9)
    g, u, v = (rng.standard_normal((6, 5)).astype(np.float32)
               for _ in range(3))
    for sparsity in (0.5, 0.9, 0.999):
        want = jdgc(jax.numpy.asarray(g), jax.numpy.asarray(u),
                    jax.numpy.asarray(v), 0.9, sparsity)
        got = tdgc(torch.tensor(g), torch.tensor(u), torch.tensor(v), 0.9,
                   sparsity)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_select_optimizer_swaps_as_jax():
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        select_optimizer
    import torch
    p = torch.nn.Parameter(torch.ones(3))
    base = topt.Momentum(learning_rate=0.1, momentum=0.8, parameters=[p])
    s = tfleet.DistributedStrategy()
    assert select_optimizer(base, s) is base
    s.lars = True
    lars = select_optimizer(base, s)
    assert isinstance(lars, topt.LarsMomentum) and lars._momentum == 0.8
    assert lars._lars_coeff == 0.001 and lars._parameter_list == [p]
    s.lars, s.lamb = False, True
    lamb = select_optimizer(base, s)
    assert isinstance(lamb, topt.Lamb) and lamb._lamb_wd == 0.01


def test_rng_states_tracker():
    import torch
    from paddle_tpu_torch.distributed.meta_parallel import random_ctrl
    tracker = random_ctrl.RNGStatesTracker()
    tracker.add('local', 5)
    with pytest.raises(ValueError, match='already exists'):
        tracker.add('other', 5)
    torch.manual_seed(0)
    with tracker.rng_state('local'):
        a = torch.rand(3)
    outside = torch.rand(3)
    torch.manual_seed(0)
    assert torch.equal(torch.rand(3), outside)   # the default stream kept
    with tracker.rng_state('local'):
        b = torch.rand(3)                          # the tracked one advanced
    # the first draw inside is the seed-5 stream's first
    assert torch.equal(a, torch.rand(3, generator=torch.Generator()
                                     .manual_seed(5)))
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match='does not exist'):
        with tracker.rng_state('missing'):
            pass
    random_ctrl.model_parallel_random_seed(100)
    states = random_ctrl.get_rng_state_tracker().get_states_tracker()
    assert list(states) == [random_ctrl.MODEL_PARALLEL_RNG]
    # the global stream is seeded with the seed itself
    assert torch.equal(torch.rand(2), torch.rand(
        2, generator=torch.Generator().manual_seed(100)))


def test_fleet_optimizer_surface(monkeypatch):
    import torch
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.optimizer import SGD
    monkeypatch.setattr(tfleet, '_FLEET', dict(tfleet._FLEET))
    p = torch.nn.Parameter(torch.ones(2))
    opt = tfleet.distributed_optimizer(SGD(learning_rate=0.5,
                                           parameters=[p]))
    loss = (p * torch.tensor([1.0, 2.0])).sum()
    tfleet.minimize(loss)
    np.testing.assert_allclose(p.detach().numpy(), [0.5, 0.0])
    assert opt.get_lr() == 0.5
    scaler = object()
    assert tfleet.distributed_scaler(scaler) is scaler


def test_fleet_surface_saves_whole_tensor_parallel_parameters(world2):
    """distributed_model lays the registered model out over 'mp';
    save_persistables writes every parameter whole (rank 0), equal to the
    JAX state_dict() the model was loaded from; a Lamb step over the
    sharded parameters is refused, naming its ROADMAP item."""
    got = bodies.section(world2[0], 'persist')
    want = _persist_job('unused')['state']
    for rank in range(2):
        res = got[rank]
        assert res['mp'] == 2
        assert 'gpt.wte.weight' in res['placed'] and \
            'gpt.h.1.mlp.fc_out.weight' in res['placed']
        assert res['optimizer_params'] == sum(v.size for v in want.values())
        assert 'Lamb' in res['lamb_refused'] and \
            'ROADMAP Queue 1 item 3' in res['lamb_refused']
        assert sorted(res['saved']) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(res['saved'][key], value, rtol=1e-6,
                                       err_msg=key)
