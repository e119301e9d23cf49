"""The port's Mixture-of-Experts (paddle_tpu_torch/incubate/moe.py) and
the GPT's MoE blocks against the JAX package: SwitchMoE and GShardMoE on
the same weights (outputs and aux loss within 1e-5, grads within 1e-4),
including capacities that drop tokens in top-2 priority order; a
2-layer MoE GPT's TrainStep; and gloo worlds of 2 and 4 CPU ranks under
expert parallelism (ep 2, dp 2 x ep 2) against the JAX fleet's losses,
with each parameter's grad against the JAX grad on the whole batch at a
capacity that drops tokens (the global capacity, slot order and aux loss
under dp). The rank bodies are in torch_dist_bodies.py.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import HybridCommunicateGroup as JaxHCG
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.framework import functional as jfm
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.incubate import moe as tmoe

import torch_dist_bodies as bodies

H, FF, E = 16, 32, 4
# capacity 0.5 * 32 tokens / 4 experts = 4 slots: about half the tokens
# drop; 0.75 under top-2 (6 slots) fills the top-1 choices first and
# drops second choices past them; 4.0 drops none
LAYER_CASES = [('switch', 0.5), ('switch', 4.0), ('gshard', 0.75),
               ('gshard', 4.0)]
CONFIG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              max_position_embeddings=32, dropout=0.0, fused_loss=True,
              num_experts=4, intermediate_size=128,
              moe_capacity_factor=0.5)
BATCH, SEQ, STEPS, LR, WD = 4, 32, 3, 1e-3, 0.01
# (name, world, hybrid degrees)
CASES = [('ep2', 2, {'ep_degree': 2}),
         ('dp2', 2, {'dp_degree': 2}),
         ('dp2_ep2', 4, {'dp_degree': 2, 'ep_degree': 2})]
EXPERT_KEYS = ('.mlp.w1', '.mlp.b1', '.mlp.w2', '.mlp.b2')


def _layer_pair(kind, cf, dtype=torch.float32):
    paddle.seed(1)
    J = jmoe.SwitchMoE if kind == 'switch' else jmoe.GShardMoE
    T = tmoe.SwitchMoE if kind == 'switch' else tmoe.GShardMoE
    jl = J(H, FF, num_experts=E, capacity_factor=cf)
    tl = T(H, FF, num_experts=E, capacity_factor=cf, device='cpu')
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    # non-zero expert biases, so an empty slot's output would show
    rng = np.random.RandomState(7)
    for key in ('b1', 'b2'):
        state[key] = rng.standard_normal(state[key].shape).astype(np.float32)
        getattr(jl, key)._data = paddle.to_tensor(state[key])._data
    tl.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return jl, tl.to(dtype)


def _layer_data():
    rng = np.random.RandomState(2)
    return (rng.standard_normal((2, 16, H)).astype(np.float32),
            rng.standard_normal((2, 16, H)).astype(np.float32))


def _jax_layer_grads(jl, x, cot):
    """Output, aux loss and the grads of sum(y * cot) + aux in JAX (one
    jitted program)."""
    def f(p, xa):
        def post(out):
            return ((out * paddle.to_tensor(cot)).sum() + jl.aux_loss,
                    out, jl.aux_loss)
        (loss, y, aux), _ = jfm.functional_call(jl, p, {}, args=(xa,),
                                                training=True, post_fn=post)
        return loss, (y, aux)
    (grads, gx), (y, aux) = jax.jit(jax.grad(f, argnums=(0, 1),
                                             has_aux=True))(
        jfm.extract_params(jl), jax.numpy.asarray(x))
    return np.asarray(y), float(aux), \
        {k: np.asarray(v) for k, v in grads.items()}, np.asarray(gx)


@pytest.mark.parametrize('kind,cf', LAYER_CASES,
                         ids=['%s_cf%s' % c for c in LAYER_CASES])
def test_moe_layer_matches_jax(kind, cf):
    jl, tl = _layer_pair(kind, cf)
    x, cot = _layer_data()
    want_y, want_aux, want_g, want_gx = _jax_layer_grads(jl, x, cot)
    xt = torch.tensor(x, requires_grad=True)
    y = tl(xt)
    ((y * torch.tensor(cot)).sum() + tl.aux_loss).backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl.aux_loss.item(), want_aux, rtol=1e-5)
    for name, p in tl.named_parameters():
        g = want_g[name]
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), 1e-6), (name, err)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=1e-4,
                               atol=1e-5)
    dropped = tl.last_dropped.item()
    assert (dropped > 0.2) == (cf < 1.0), dropped


@pytest.mark.parametrize('kind', ['switch', 'gshard'])
def test_moe_bf16_close_to_f32(kind):
    """bf16 weights and inputs route like f32 at an ample capacity and
    land within bf16 rounding of the f32 output."""
    _, t32 = _layer_pair(kind, 4.0)
    _, t16 = _layer_pair(kind, 4.0, torch.bfloat16)
    x, _ = _layer_data()
    y32 = t32(torch.tensor(x)).detach()
    y16 = t16(torch.tensor(x).bfloat16()).detach()
    assert y16.dtype == torch.bfloat16
    y16 = y16.float()
    err = (y16 - y32).abs().max() / y32.abs().max()
    assert err < 3e-2, err


def _jax_model():
    paddle.seed(23)
    return jgpt.GPTForCausalLM(jgpt.GPTConfig(**CONFIG))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batch():
    rng = np.random.RandomState(5)
    return (rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)),
            rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)))


_JAX = {}


def _jax_fleet_losses():
    """The JAX fleet step under dp 2 x ep 2 (one SPMD program over 4
    virtual devices: the global batch, capacity and aux loss)."""
    if 'losses' not in _JAX:
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = {'dp_degree': 2, 'mp_degree': 1, 'pp_degree': 1,
                            'sharding_degree': 1, 'sp_degree': 1,
                            'ep_degree': 2}
        hcg = JaxHCG(devices=jax.devices()[:4], **s.hybrid_configs)
        jfleet._FLEET['strategy'] = s
        jm = _jax_model()
        opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                     parameters=jm.parameters())
        step = jfleet.fleet_train_step(jm, jm.loss, opt, strategy=s,
                                       hcg=hcg)
        ids, labels = _batch()
        _JAX['losses'] = [float(np.asarray(step(
            paddle.to_tensor(ids), paddle.to_tensor(labels)).numpy()))
            for _ in range(STEPS)]
    return _JAX['losses']


def _jax_grads():
    """The JAX grads of the MoE GPT's training loss on the whole batch."""
    if 'grads' not in _JAX:
        jm = _jax_model()
        ids, labels = (jax.numpy.asarray(a) for a in _batch())
        bufs = jfm.extract_buffers(jm)

        def f(params):
            loss, _ = jfm.functional_call(
                jm, params, bufs, args=(ids,), training=True,
                post_fn=jfm.make_loss_post(lambda o, l: jm.loss(o, l),
                                           (labels,)))
            return loss
        grads = jax.jit(jax.grad(f))(jfm.extract_params(jm))
        _JAX['grads'] = {k: np.asarray(v) for k, v in grads.items()}
    return _JAX['grads']


def test_moe_gpt_train_step_matches_jax():
    """The 2-layer MoE GPT through TrainStep, tokens dropping in both
    blocks: the losses of the JAX fleet's step (the same function of the
    global batch) within 1e-4, the aux terms consumed by loss()."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    model = GPTForCausalLM(GPTConfig(**CONFIG), device='cpu')
    load_paddle_tpu_state(model, _state(_jax_model()))
    step = TrainStep(model, model.loss, AdamW(
        learning_rate=LR, weight_decay=WD, parameters=model.parameters()))
    ids, labels = (torch.tensor(a).long() for a in _batch())
    losses = [step(ids, labels).item() for _ in range(STEPS)]
    np.testing.assert_allclose(losses, _jax_fleet_losses(), rtol=1e-4)
    assert model.gpt._moe_aux is None  # consumed by loss()
    dropped = [b.mlp.last_dropped.item() for b in model.gpt.h]
    assert all(d > 0.1 for d in dropped), dropped


def test_moe_refuses_pipeline_and_recompute():
    """MoE blocks under a pipeline state or recompute raise, as in the JAX
    package (the aux terms would escape the schedule's stages)."""
    from paddle_tpu_torch.distributed.pipeline import (make_pp_state,
                                                       pp_scope)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(**CONFIG), device='cpu')
    ids = torch.zeros(1, 8).long()
    with pytest.raises(NotImplementedError, match='MoE'):
        model.pp_decompose()
    with pp_scope(make_pp_state(None, 1)):
        with pytest.raises(NotImplementedError, match='MoE'):
            model(ids)
    model.enable_recompute(True)
    with pytest.raises(NotImplementedError, match='MoE'):
        model(ids)
    model.eval()
    assert model(ids).shape == (1, 8, CONFIG['vocab_size'])


@pytest.fixture(scope='module')
def shared_root(tmp_path_factory):
    return bodies.shared_root(tmp_path_factory)


def _job(world):
    ids, labels = _batch()
    state = _state(_jax_model())
    cases = [{'name': name, 'hybrid': hybrid, 'flags': {}, 'configs': {},
              'config': CONFIG, 'moves': True, 'state': state}
             for name, w, hybrid in CASES if w == world]
    return {'sections': [('fleet', {
        'kind': 'fleet', 'cases': cases, 'ids': ids, 'labels': labels,
        'lr': LR, 'wd': WD, 'steps': STEPS})]}


def _references():
    _jax_fleet_losses()
    _jax_grads()


@pytest.fixture(scope='module')
def world2(shared_root):
    return bodies.world_results_beside(shared_root, 'moe2', 2, _job(2),
                                       _references)[0]


@pytest.fixture(scope='module')
def world4(shared_root):
    return bodies.world_results_beside(shared_root, 'moe4', 4, _job(4),
                                       _references)[0]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_moe_fleet_matches_jax(case, request):
    """Under ep 2 each rank holds 2 of the 4 experts (a DTensor over
    'ep'); under dp the ranks route over the global batch. Every rank's
    losses are the JAX fleet's within 1e-4, and each parameter's grad
    (its move in one SGD step at lr 1) the JAX grad on the whole batch
    within 1e-4 of its norm: a missing all-reduce over 'ep' in the
    backward, or a capacity or aux loss taken on a rank's own tokens,
    fails here."""
    name, world, hybrid = case
    got = bodies.section(request.getfixturevalue('world%d' % world),
                         'fleet')
    want = _jax_fleet_losses()
    grads = _jax_grads()
    for rank in range(world):
        run = got[rank][name]
        np.testing.assert_allclose(run['losses'], want, rtol=1e-4,
                                   err_msg='%s rank %d' % (name, rank))
        experts = {n for n in run['placed']}
        if 'ep' in name:
            assert experts == {n for n in run['params']
                               if n.endswith(EXPERT_KEYS)}, experts
            assert all(p == '(Shard(dim=0),)'
                       for p in run['placed'].values())
        else:
            assert not experts
        for n, move in run['moves'].items():
            g = grads[n]
            err = np.linalg.norm(move + g) / np.linalg.norm(g)
            assert err < 1e-4, (name, rank, n, err)
