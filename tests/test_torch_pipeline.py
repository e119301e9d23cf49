"""The port's pipeline parallelism (paddle_tpu_torch/distributed/
{pipeline,pipeline_1f1b}.py, meta_parallel/pp_layers.py, TrainStep's
pp_state, fleet's pp route) in gloo worlds of 2 and 4 CPU ranks, against
the JAX package on the same numpy batch with the JAX GPT's initial
state_dict() carried across (each stage loads its own slice). The JAX
package's pipelined steps compute the function of its plain TrainStep
(tests/test_pipeline.py holds them to it), so each world case is held
to the JAX TrainStep on the whole batch: losses over 3 steps within 1e-4
in f32, 2e-2 under bf16. The rank bodies are in torch_dist_bodies.py
(nothing there imports jax).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.meta_parallel.pp_layers import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    SharedLayerDesc as JSharedLayerDesc)
from paddle_tpu.framework import functional as jfm
from paddle_tpu.text.models import gpt as jgpt

import torch_dist_bodies as bodies

CONFIG = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
              max_position_embeddings=32, dropout=0.0, fused_loss=True)
BATCH, SEQ, STEPS, LR, WD = 8, 32, 3, 1e-3, 0.01
PP = {'pp_degree': 2}
ONE_F = {'pipeline': True}


def _sched(mode, **kw):
    return {'pipeline_configs': dict({'schedule_mode': mode}, **kw)}


# (name, world, hybrid degrees, strategy flags, strategy configs, config
# changes, the JAX reference's config changes and amp)
CASES = [
    ('pp2', 2, PP, {}, {}, {}),
    ('pp2_1f1b', 2, PP, ONE_F, _sched('1F1B'), {}),
    ('pp2_1f1b_untied', 2, PP, ONE_F, _sched('1F1B'),
     {'tie_word_embeddings': False}),
    ('pp2_fthenb', 2, PP, ONE_F, _sched('F-then-B'), {}),
    ('pp2_1f1b_acc8', 2, PP, ONE_F, _sched('1F1B', accumulate_steps=8), {}),
    ('pp2_recompute_bf16', 2, PP, {'recompute': True, 'amp': True}, {}, {}),
    ('pp4', 4, {'pp_degree': 4}, {}, {}, {}),
    ('pp4_1f1b', 4, {'pp_degree': 4}, ONE_F, _sched('1F1B'), {}),
    ('pp4_uneven', 4, {'pp_degree': 4}, {}, {}, {'num_layers': 6}),
    ('dp2_pp2', 4, {'dp_degree': 2, 'pp_degree': 2}, {}, {}, {}),
    ('pp2_mp2', 4, {'pp_degree': 2, 'mp_degree': 2},
     {'tensor_parallel': True}, {}, {}),
    ('dp2_pp2_clip', 4, {'dp_degree': 2, 'pp_degree': 2}, ONE_F,
     _sched('1F1B'), {}),
    ('pp2_mp2_clip', 4, {'pp_degree': 2, 'mp_degree': 2},
     {'tensor_parallel': True}, {}, {}),
]
# cases whose optimizer is SGD at lr CLIP[1] with ClipGradByGlobalNorm at
# CLIP[0], a norm below the grads' (1.3-1.7 over the three steps): one
# clip factor for the whole model, not one a stage
CLIP = (0.5, 0.5)
CLIPPED = ('dp2_pp2_clip', 'pp2_mp2_clip')
GRAD_CASES = ('pp2', 'dp2_pp2', 'pp4_uneven')
NAMES = [c[0] for c in CASES]


def _config(changes):
    return dict(CONFIG, **changes)


def _jax_model(changes):
    paddle.seed(31)
    return jgpt.GPTForCausalLM(jgpt.GPTConfig(**_config(changes)))


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _batch():
    rng = np.random.RandomState(8)
    return (rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)),
            rng.randint(0, CONFIG['vocab_size'], (BATCH, SEQ)))


def _jax_losses(changes, amp, clip=False):
    jm = _jax_model(changes)
    if clip:
        opt = paddle.optimizer.SGD(
            learning_rate=CLIP[1], parameters=jm.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(CLIP[0]))
    else:
        opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                     parameters=jm.parameters())
    step = jfm.TrainStep(jm, lambda o, l: jm.loss(o, l), opt,
                         amp_dtype='bfloat16' if amp else None)
    ids, labels = _batch()
    return [float(np.asarray(step(paddle.to_tensor(ids),
                                  paddle.to_tensor(labels)).numpy()))
            for _ in range(STEPS)]


_REFS = {}


def _reference(changes, amp=False, clip=False):
    key = (tuple(sorted(changes.items())), amp, clip)
    if key not in _REFS:
        _REFS[key] = _jax_losses(changes, amp, clip)
    return _REFS[key]


@pytest.fixture(scope='module')
def shared_root(tmp_path_factory):
    return bodies.shared_root(tmp_path_factory)


def _fleet_job(world):
    ids, labels = _batch()
    cases = []
    for name, w, hybrid, flags, configs, changes in CASES:
        if w == world:
            cases.append({'name': name, 'hybrid': hybrid, 'flags': flags,
                          'configs': configs, 'config': _config(changes),
                          'grads': name in GRAD_CASES,
                          'clip': CLIP if name in CLIPPED else None,
                          'state': _state(_jax_model(changes))})
    return {'kind': 'fleet', 'cases': cases, 'ids': ids, 'labels': labels,
            'lr': LR, 'wd': WD, 'steps': STEPS}


def _pipeline_layer_model():
    """The JAX PipelineLayer of the port's section (one stage): a shared
    embedding used as the input lookup and the tied head."""
    paddle.seed(12)
    vocab, hidden = 32, 16

    def head(layer, x):
        return paddle.matmul(x, layer.weight, transpose_y=True)

    def loss_fn(logits, labels):
        return paddle.nn.functional.cross_entropy(
            paddle.reshape(logits, [-1, vocab]),
            paddle.reshape(labels, [-1]))

    descs = [JSharedLayerDesc('embed', paddle.nn.Embedding, None, 'weight',
                              vocab, hidden),
             JLayerDesc(paddle.nn.Linear, hidden, hidden),
             paddle.tanh,
             JLayerDesc(paddle.nn.Linear, hidden, hidden),
             JSharedLayerDesc('embed', paddle.nn.Embedding, head, 'weight',
                              vocab, hidden)]
    return JPipelineLayer(descs, num_stages=1, loss_fn=loss_fn)


def _pipeline_layer_job():
    jl = _pipeline_layer_model()
    w = {'embed': jl._shared['embed'].weight.numpy()}
    for key, layer in (('A', jl._built[1]), ('B', jl._built[2])):
        w[key + '_w'] = layer.weight.numpy()
        w[key + '_b'] = layer.bias.numpy() + 0.05
        layer.bias._data = paddle.to_tensor(w[key + '_b'])._data
    rng = np.random.RandomState(4)
    return {'kind': 'pipeline_layer', 'weights': w, 'lr': 1e-2,
            'steps': STEPS, 'ids': rng.randint(0, 32, (4, 6)),
            'labels': rng.randint(0, 32, (4, 6))}, jl


def _references(world):
    for name, w, _, flags, _, changes in CASES:
        if w == world:
            _reference(changes, flags.get('amp', False), name in CLIPPED)


@pytest.fixture(scope='module')
def world2(shared_root):
    job, jl = _pipeline_layer_job()
    sections = [('fleet', _fleet_job(2)), ('pipeline_layer', job)]
    results, _ = bodies.world_results_beside(
        shared_root, 'pipe2', 2, {'sections': sections},
        lambda: _references(2))
    return results, job, jl


@pytest.fixture(scope='module')
def world4(shared_root):
    job = {'sections': [('fleet', _fleet_job(4))]}
    return bodies.world_results_beside(shared_root, 'pipe4', 4, job,
                                       lambda: _references(4))[0]


def _results(request, world):
    got = request.getfixturevalue('world%d' % world)
    return bodies.section(got[0] if world == 2 else got, 'fleet')


@pytest.mark.parametrize('case', CASES, ids=NAMES)
def test_pipeline_fleet_matches_jax(case, request):
    """fleet_train_step at pp_degree > 1: every rank's losses against the
    JAX TrainStep's on the same weights and batch, and the schedule,
    microbatch count and stage layout the strategy asks for. Under a
    global-norm clip every stage scales its grads by the whole model's
    norm, the tied embedding's grad counted once."""
    name, world, hybrid, flags, configs, changes = case
    got = _results(request, world)
    amp = flags.get('amp', False)
    want = _reference(changes, amp, name in CLIPPED)
    for rank in range(world):
        np.testing.assert_allclose(got[rank][name]['losses'], want,
                                   rtol=2e-2 if amp else 1e-4,
                                   err_msg='%s rank %d' % (name, rank))
    pp = hybrid['pp_degree']
    one_f = configs.get('pipeline_configs', {}).get('schedule_mode') == \
        '1F1B'
    acc = configs.get('pipeline_configs', {}).get('accumulate_steps', 1)
    n_micro = max(pp, acc) if acc > 1 else 2 * pp if one_f else pp
    layers = _config(changes)['num_layers']
    per = -(-layers // pp)
    for rank in range(world):
        run = got[rank][name]
        assert run['pp_state'] == {'n_stages': pp, 'n_micro': n_micro,
                                   'schedule': '1f1b' if one_f else 'gpipe',
                                   'remat': bool(flags.get('recompute'))}
        stage = run['pp_stats']['stage']
        blocks = {int(n.split('.')[2]) for n in run['params']
                  if n.startswith('gpt.h.')}
        assert blocks == set(range(min(layers, stage * per),
                                   min(layers, (stage + 1) * per))), name
        names = set(run['params'])
        assert ('gpt.wpe.weight' in names) == (stage == 0)
        assert ('gpt.ln_f.weight' in names) == (stage == pp - 1)
        tied = changes.get('tie_word_embeddings', True)
        assert ('gpt.wte.weight' in names) == (
            stage == 0 or (stage == pp - 1 and tied))
        assert ('lm_head.weight' in names) == (stage == pp - 1 and not tied)
        if name.startswith('pp2_mp2'):
            assert run['placed'] and all('Shard' in p for p in
                                         run['placed'].values())
        # the hybrid group's pipeline neighbours: ranks are row-major over
        # (dp, pp, ..., mp), so a stage is mp ranks from the next
        line, stride = run['pp_line'], hybrid.get('mp_degree', 1)
        me = line['rank']
        assert (line['first'], line['last']) == (stage == 0,
                                                 stage == pp - 1)
        assert line['prev'] == (me - stride if stage > 0 else None)
        assert line['next'] == (me + stride if stage < pp - 1 else None)
        ends = [me - stage * stride, me + (pp - 1 - stage) * stride]
        assert line['tied'] == (ends if stage in (0, pp - 1) else None)


@pytest.mark.parametrize('name', GRAD_CASES)
def test_pipeline_grads_match_plain_step(name, request):
    """Each parameter a stage holds moves in one SGD step at lr 1 as a
    plain TrainStep's on the whole batch moves it (within 1e-4 in norm):
    a microbatch loss not scaled by 1 / n_micro, a tied embedding grad
    not summed over its stages or a grad not averaged over dp fails."""
    world = next(c[1] for c in CASES if c[0] == name)
    got = _results(request, world)
    for rank in range(world):
        rel = got[rank][name]['grad_rel']
        worst = max(rel, key=rel.get)
        assert rel[worst] < 1e-4, (name, rank, worst, rel[worst])


def test_1f1b_peak_stash(request):
    """At most pp - r microbatches in flight on rank r under 1F1B (the
    JAX package checks its stash depth in HLO, tests/test_pp_hlo_depth.py);
    GPipe holds all of them."""
    for world, name, pp in ((2, 'pp2_1f1b', 2), (2, 'pp2_1f1b_acc8', 2),
                            (4, 'pp4_1f1b', 4), (4, 'pp4', 4)):
        got = _results(request, world)
        for rank in range(world):
            stats = got[rank][name]['pp_stats']
            if stats['schedule'] == '1f1b':
                assert stats['peak_stash'] == pp - stats['stage'], \
                    (name, rank, stats)
            else:
                assert stats['peak_stash'] == stats['n_micro'], stats


def test_pipeline_parallel_train_batch_matches_jax(world2):
    """PipelineParallel.train_batch over a PipelineLayer split over two
    stages, whose embedding is shared with the head of the last stage
    (SharedLayerDesc): the losses of the JAX PipelineEngine's plain step,
    and the tied weight equal on both stages after the steps."""
    results, job, jl = world2
    got = bodies.section(results, 'pipeline_layer')
    from paddle_tpu.distributed.pipeline import PipelineEngine
    from paddle_tpu.distributed.topology import HybridCommunicateGroup
    import jax
    hcg = HybridCommunicateGroup(devices=jax.devices()[:1])
    opt = paddle.optimizer.AdamW(learning_rate=job['lr'],
                                 parameters=jl.parameters())
    engine = PipelineEngine(jl, opt, hcg)
    want = [float(np.asarray(engine.step(
        paddle.to_tensor(job['ids']), paddle.to_tensor(job['labels']))
        .numpy())) for _ in range(STEPS)]
    for rank in range(2):
        np.testing.assert_allclose(got[rank]['losses'], want, rtol=1e-4)
        assert got[rank]['tied'] == 1 and got[rank]['n_micro'] == 2
    assert sorted(got[r]['stage'] for r in range(2)) == [0, 1]
    np.testing.assert_array_equal(got[0]['embed'], got[1]['embed'])
    np.testing.assert_allclose(got[0]['embed'],
                               jl._shared['embed'].weight.numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('schedule', ['gpipe', '1f1b'])
def test_world1_pp_state_matches_plain_step(schedule):
    """TrainStep(pp_state=make_pp_state(None, 1, n_micro=4)) is 4-
    microbatch accumulation: its losses and parameters equal the plain
    TrainStep's within 1e-5."""
    from paddle_tpu_torch.distributed.pipeline import make_pp_state
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    state = _state(_jax_model({}))
    ids, labels = (torch.tensor(a).long() for a in _batch())
    runs = []
    for pp_state in (None, make_pp_state(None, 1, n_micro=4,
                                         schedule=schedule)):
        model = GPTForCausalLM(GPTConfig(**CONFIG), device='cpu')
        load_paddle_tpu_state(model, state)
        step = TrainStep(model, model.loss,
                         AdamW(learning_rate=LR, parameters=model.parameters()),
                         pp_state=pp_state)
        runs.append(([step(ids, labels).item() for _ in range(STEPS)],
                     {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}, step.pp_stats))
    (plain, p_plain, _), (pp, p_pp, stats) = runs
    np.testing.assert_allclose(pp, plain, rtol=1e-5)
    assert stats == {'peak_stash': 4 if schedule == 'gpipe' else 1,
                     'n_micro': 4, 'schedule': schedule, 'stage': 0}
    # Adam moves each entry by ~lr whatever its grad's size: where the
    # exact grad is 0 (the key third of each qkv bias) the sign of the sum
    # order's noise decides, so no entry apart by more than 2 lr a step,
    # and all but a few within f32 rounding of each other
    close = total = 0
    for n, v in p_plain.items():
        diff = np.abs(p_pp[n] - v)
        assert diff.max() <= 2 * LR * STEPS + 1e-6, (n, diff.max())
        ok = diff <= 1e-5 * np.abs(v) + 1e-6
        if n.endswith('attn.qkv_proj.bias'):
            third = v.size // 3
            ok = np.r_[ok[:third], ok[2 * third:]]
        close += int(np.sum(ok))
        total += ok.size
    assert close >= 0.999 * total, (close, total)
    np.testing.assert_allclose(pp, _reference({}), rtol=1e-4)


def test_stage_bounds_and_pipeline_layer_segments():
    """The layer split is the JAX package's (ceil(n / pp) a stage, its
    ghost layers dropped) and SegmentLayers is its segmenter."""
    from paddle_tpu.distributed.meta_parallel.pp_layers import \
        SegmentLayers as JSeg
    from paddle_tpu_torch.distributed.meta_parallel import SegmentLayers
    from paddle_tpu_torch.distributed.pipeline import stage_bounds
    assert [stage_bounds(6, 4, r) for r in range(4)] == \
        [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert [stage_bounds(3, 2, r) for r in range(2)] == [(0, 2), (2, 3)]
    descs = [JLayerDesc(paddle.nn.Linear, 2, 2) for _ in range(7)]
    for parts in (1, 2, 3, 4):
        for method in ('uniform', 'layer:Linear'):
            assert SegmentLayers(descs, parts, method).do_segment() == \
                JSeg(descs, parts, method).do_segment()
