"""The port's optimizers (paddle_tpu_torch/optimizer/optimizers.py) against
the JAX package's eager step(): the same parameters and the same
gradients, made from a seed with numpy, over several steps. All fifteen
rules, in f32 and in bf16 (with an f32 master where the rule takes
multi_precision), with schedulers, gradient clipping, regularizers and
per-parameter learning rates."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import Tensor
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import io_save

SHAPES = {'w_decayed': (6, 5), 'b_plain': (5,)}
STEPS = 5

# each package's modules, for options built per package
J = types.SimpleNamespace(opt=paddle.optimizer, lr=paddle.optimizer.lr,
                          reg=paddle.regularizer, nn=paddle.nn)
T = types.SimpleNamespace(opt=topt, lr=topt.lr, reg=tpt.regularizer,
                          nn=tpt.nn)


def _grads(seed, steps=STEPS):
    rng = np.random.RandomState(seed)
    # a spread of magnitudes, and exact zeros, where Adam's first steps are
    # most sensitive (|update| ~ lr for any nonzero grad)
    return [{name: (rng.randn(*shape) * 10.0 ** rng.randint(-3, 1, shape)
                    * (rng.rand(*shape) > 0.1)).astype(np.float32)
             for name, shape in SHAPES.items()} for _ in range(steps)]


def _params(seed):
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*shape) * 0.05).astype(np.float32)
            for name, shape in SHAPES.items()}


def _options(spec, pkg):
    """kwargs with every callable entry but apply_decay_param_fun built
    for `pkg`."""
    spec = spec(pkg) if callable(spec) else spec
    return {k: (v(pkg) if callable(v) and k != 'apply_decay_param_fun'
                else v) for k, v in spec.items()}


def _run_jax(cls, kwargs, dtype, init, grads, meta=None):
    params = {}
    for name, value in init.items():
        p = paddle.create_parameter(list(value.shape), 'float32', name=name)
        p._data = jnp.asarray(value).astype(dtype)
        for attr, v in (meta(J).get(name, {}) if meta else {}).items():
            if attr == 'learning_rate':
                p.optimize_attr['learning_rate'] = v
            else:
                setattr(p, attr, v)
        params[name] = p
    opt = cls(parameters=list(params.values()), **kwargs)
    for g in grads:
        for name, p in params.items():
            p.grad = Tensor(jnp.asarray(g[name]).astype(dtype))
        opt.step()
        if hasattr(kwargs.get('learning_rate'), 'step'):
            kwargs['learning_rate'].step()
    slots = {name: opt._get_slots(p) for name, p in params.items()}
    return ({n: np.asarray(p._data.astype(jnp.float32))
             for n, p in params.items()},
            {n: {k: np.asarray(v) for k, v in s.items()}
             for n, s in slots.items()})


def _torch_params(init, dtype, meta=None):
    params = {}
    for n, v in init.items():
        p = torch.tensor(v).to(dtype).requires_grad_(True)
        for attr, value in (meta(T).get(n, {}) if meta else {}).items():
            if attr == 'learning_rate':
                p.optimize_attr = {'learning_rate': value}
            else:
                setattr(p, attr, value)
        params[n] = p
    return params


def _run_torch(cls, kwargs, dtype, init, grads, meta=None):
    params = _torch_params(init, dtype, meta)
    opt = cls(parameters=list(params.items()), **kwargs)
    for g in grads:
        for name, p in params.items():
            p.grad = torch.tensor(g[name]).to(dtype)
        opt.step()
        if hasattr(kwargs.get('learning_rate'), 'step'):
            kwargs['learning_rate'].step()
    return ({n: p.detach().float().numpy() for n, p in params.items()},
            {n: opt._get_slots(p) for n, p in params.items()})


def _decay_fun(name):
    return name.startswith('w_')


def _meta(pkg):
    # per-parameter learning rates and regularizers
    return {'w_decayed': {'learning_rate': 0.5,
                          'regularizer': pkg.reg.L1Decay(0.01)},
            'b_plain': {'regularizer': pkg.reg.L2Decay(0.1)}}


# name: (class, kwargs, dtype[, per-parameter metadata])
CASES = {
    'adam_f32': ('Adam', {'learning_rate': 1e-2}, 'float32'),
    'adam_f32_coupled_decay': ('Adam', {'learning_rate': 1e-2,
                                        'weight_decay': 0.1}, 'float32'),
    'adam_bf16_master': ('Adam', {'learning_rate': 1e-2,
                                  'multi_precision': True}, 'bfloat16'),
    'adamw_f32_decay_fun': ('AdamW', {'learning_rate': 1e-2,
                                      'weight_decay': 0.5,
                                      'apply_decay_param_fun': _decay_fun},
                            'float32'),
    'adamw_bf16': ('AdamW', {'learning_rate': 1e-2}, 'bfloat16'),
    'adamw_bf16_master': ('AdamW', {'learning_rate': 1e-2,
                                    'multi_precision': True}, 'bfloat16'),
    # the eager AdamW skips the parameters' regularizers
    'adamw_f32_param_meta': ('AdamW', {'learning_rate': 1e-2,
                                       'weight_decay': 0.3}, 'float32',
                             _meta),
    'sgd_f32': ('SGD', {'learning_rate': 0.1}, 'float32'),
    'sgd_bf16': ('SGD', {'learning_rate': 0.1}, 'bfloat16'),
    'sgd_f32_param_meta': ('SGD', {'learning_rate': 0.1,
                                   'weight_decay': lambda p:
                                   p.reg.L2Decay(0.05)}, 'float32', _meta),
    'momentum_f32': ('Momentum', {'learning_rate': 0.1, 'momentum': 0.9},
                     'float32'),
    'momentum_f32_nesterov': ('Momentum', {'learning_rate': 0.1,
                                           'use_nesterov': True,
                                           'weight_decay': 0.01},
                              'float32'),
    'momentum_bf16_master': ('Momentum', {'learning_rate': 0.1,
                                          'multi_precision': True},
                             'bfloat16'),
    'adamax_f32': ('Adamax', {'learning_rate': 1e-2}, 'float32'),
    'adamax_bf16': ('Adamax', {'learning_rate': 1e-2}, 'bfloat16'),
    'adagrad_f32': ('Adagrad', {'learning_rate': 0.05,
                                'initial_accumulator_value': 0.1},
                    'float32'),
    'adagrad_bf16': ('Adagrad', {'learning_rate': 0.05}, 'bfloat16'),
    'adadelta_f32': ('Adadelta', {'learning_rate': 1.0, 'rho': 0.9},
                     'float32'),
    'adadelta_bf16': ('Adadelta', {'learning_rate': 1.0}, 'bfloat16'),
    'rmsprop_f32': ('RMSProp', {'learning_rate': 1e-2, 'momentum': 0.5},
                    'float32'),
    'rmsprop_f32_centered': ('RMSProp', {'learning_rate': 1e-2,
                                         'centered': True}, 'float32'),
    'rmsprop_bf16': ('RMSProp', {'learning_rate': 1e-2}, 'bfloat16'),
    'lamb_f32': ('Lamb', {'learning_rate': 1e-2}, 'float32'),
    'lamb_bf16': ('Lamb', {'learning_rate': 1e-2}, 'bfloat16'),
    'lars_f32': ('LarsMomentum', {'learning_rate': 0.5, 'lars_coeff': 0.1,
                                  'exclude_from_weight_decay': ['b_']},
                 'float32'),
    'lars_bf16': ('LarsMomentum', {'learning_rate': 0.5, 'lars_coeff': 0.1},
                  'bfloat16'),
    'ftrl_f32': ('Ftrl', {'learning_rate': 0.1, 'l1': 1e-3, 'l2': 1e-2},
                 'float32'),
    'ftrl_bf16': ('Ftrl', {'learning_rate': 0.1, 'l1': 1e-3}, 'bfloat16'),
    'proximal_gd_f32': ('ProximalGD', {'learning_rate': 0.1, 'l1': 1e-3,
                                       'l2': 1e-2}, 'float32'),
    'proximal_gd_bf16': ('ProximalGD', {'learning_rate': 0.1, 'l1': 1e-3},
                         'bfloat16'),
    'proximal_adagrad_f32': ('ProximalAdagrad', {'learning_rate': 0.05,
                                                 'l1': 1e-3, 'l2': 1e-2},
                             'float32'),
    'proximal_adagrad_bf16': ('ProximalAdagrad', {'learning_rate': 0.05},
                              'bfloat16'),
    'sparse_adam_f32': ('SparseAdam', {'learning_rate': 1e-2}, 'float32'),
    'sparse_adam_bf16_master': ('SparseAdam', {'learning_rate': 1e-2,
                                               'multi_precision': True},
                                'bfloat16'),
}


def _compare(case, cls_name, spec, dtype, meta=None, grads=None):
    init, grads = _params(1), grads or _grads(2)
    want, want_slots = _run_jax(getattr(paddle.optimizer, cls_name),
                                _options(spec, J), getattr(jnp, dtype), init,
                                grads, meta)
    got, got_slots = _run_torch(getattr(topt, cls_name), _options(spec, T),
                                getattr(torch, dtype), init, grads, meta)
    for name in SHAPES:
        if dtype == 'float32':
            # the same f32 arithmetic: rounding-level differences only
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       atol=1e-7, err_msg=case)
        else:
            # bf16 params: the updates (~lr) are ~1 bf16 ulp of |p| ~0.05,
            # so a rounding flip moves a value by one ulp (2^-7 relative)
            ulp = 2.0 ** -7 * np.maximum(np.abs(want[name]), 2.0 ** -126)
            assert np.all(np.abs(got[name] - want[name]) <= ulp + 1e-12), \
                (case, name, np.abs(got[name] - want[name]).max())
        for slot, value in want_slots[name].items():
            mine = got_slots[name][slot]
            # moments (and the master) of 16-bit params are f32
            assert str(mine.dtype).split('.')[-1] == str(value.dtype), slot
            # in bf16 a slot that reads the parameter inherits its ulp
            tol = 2e-5 if dtype == 'float32' or slot.startswith('moment') \
                else 2e-2
            np.testing.assert_allclose(mine.float().numpy(),
                                       value.astype(np.float32),
                                       rtol=tol, atol=1e-9,
                                       err_msg='%s %s' % (case, slot))


@pytest.mark.parametrize('case', sorted(CASES))
def test_optimizer_steps_match_jax(case):
    cls_name, spec, dtype = CASES[case][:3]
    _compare(case, cls_name, spec, dtype, *CASES[case][3:])


def test_every_optimizer_is_ported():
    names = {c[0] for c in CASES.values()} | {'Optimizer', 'Dpsgd'}
    assert names == set(paddle.optimizer.optimizers.__all__)
    for name in names:
        assert hasattr(topt, name), name


def test_dpsgd_semantics():
    # its noise is threefry in the JAX package and a seeded torch
    # generator here: held by what it must do, not by value
    p0 = torch.full((400,), 0.5)
    g = torch.full((400,), 3.0)  # norm 60 > clip 1

    def step(**kw):
        p = p0.clone().requires_grad_(True)
        opt = topt.Dpsgd(learning_rate=0.1, parameters=[p], **kw)
        p.grad = g.clone()
        opt.step()
        return p.detach()

    # no noise: one SGD step on the grad clipped to norm `clip`
    quiet = step(clip=1.0, sigma=0.0)
    torch.testing.assert_close(quiet, p0 - 0.1 * g / g.norm(),
                               rtol=1e-6, atol=1e-7)
    # noise of std sigma * clip / batch_size, the same for the same seed
    # and step, another for another seed
    noisy = step(clip=1.0, sigma=2.0, batch_size=4.0, seed=3)
    noise = (quiet - noisy) / 0.1
    assert abs(noise.std().item() - 0.5) < 0.1
    assert abs(noise.mean().item()) < 0.1
    assert torch.equal(noisy, step(clip=1.0, sigma=2.0, batch_size=4.0,
                                   seed=3))
    assert not torch.equal(noisy, step(clip=1.0, sigma=2.0, batch_size=4.0,
                                       seed=4))


def test_adamw_decay_fun_sees_the_names():
    seen = []
    p = torch.zeros(3, requires_grad=True)
    opt = topt.AdamW(parameters=[('layer.weight', p)],
                     apply_decay_param_fun=lambda n: seen.append(n) or True)
    p.grad = torch.ones(3)
    opt.step()
    assert seen == ['layer.weight']
    unnamed = topt.AdamW(parameters=[p])
    assert unnamed._names[id(p)] == 'param0'
    attr = tpt.nn.Linear(2, 2, device='cpu',
                         weight_attr=tpt.ParamAttr(name='fc.w'))
    named = topt.AdamW(parameters=attr.parameters())
    assert named._names[id(attr.weight)] == 'fc.w'


def test_clear_grad_and_state_dict():
    p = torch.ones(4, requires_grad=True)
    opt = topt.Adam(learning_rate=0.1, parameters=[('p', p)])
    p.grad = torch.full((4,), 0.5)
    opt.step()
    state = opt.state_dict()
    assert state['step'] == 1 and set(state) == {'step', 'p_moment1',
                                                  'p_moment2'}
    opt.clear_grad()
    assert torch.equal(p.grad, torch.zeros(4))
    opt.clear_grad(set_to_zero=False)
    assert p.grad is None
    opt.clear_gradients()
    assert torch.equal(p.grad, torch.zeros(4))
    # minimize: backward, step, zeroed grads
    before = p.detach().clone()
    opt.minimize((p * torch.arange(4.0)).sum())
    assert opt.state_dict()['step'] == 2
    assert not torch.equal(p.detach(), before)
    assert torch.equal(p.grad, torch.zeros(4))


def test_lr_get_set_and_scheduler():
    p = torch.ones(2, requires_grad=True)
    opt = topt.SGD(learning_rate=0.1, parameters=[p])
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    sched = topt.lr.StepDecay(0.1, 2)
    opt = topt.SGD(learning_rate=sched, parameters=[p])
    with pytest.raises(RuntimeError, match='LRScheduler'):
        opt.set_lr(0.3)
    sched.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.01)
    assert opt.state_dict()['LR_Scheduler'] == sched.state_dict()


def _recipe(params, sched):
    return topt.AdamW(sched, beta1=0.9, beta2=0.95, weight_decay=0.1,
                      parameters=list(params.items()),
                      apply_decay_param_fun=_decay_fun,
                      grad_clip=tpt.nn.ClipGradByGlobalNorm(1.0),
                      multi_precision=True)


def test_state_resumes_through_io_save(tmp_path):
    """An optimizer's state_dict written with io_save and read into a fresh
    optimizer continues the run exactly (bf16 parameters with f32 masters,
    a scheduler, clipping)."""
    init, grads = _params(5), _grads(6, steps=6)

    def sched():
        return topt.lr.LinearWarmup(
            topt.lr.CosineAnnealingDecay(1e-2, 6), 2, 0.0, 1e-2)

    def run(opt, s, params, gs):
        for g in gs:
            for name, p in params.items():
                p.grad = torch.tensor(g[name]).bfloat16()
            opt.step()
            s.step()

    params = _torch_params(init, torch.bfloat16)
    s = sched()
    opt = _recipe(params, s)
    run(opt, s, params, grads)

    params2 = _torch_params(init, torch.bfloat16)
    s2 = sched()
    opt2 = _recipe(params2, s2)
    run(opt2, s2, params2, grads[:3])
    io_save.save({'opt': opt2.state_dict(),
                  'params': {n: p.detach() for n, p in params2.items()}},
                 str(tmp_path / 'ckpt.pdparams'))
    loaded = io_save.load(str(tmp_path / 'ckpt.pdparams'))
    params3 = {n: v.clone().requires_grad_(True)
               for n, v in loaded['params'].items()}
    s3 = sched()
    opt3 = _recipe(params3, s3)
    opt3.set_state_dict(loaded['opt'])
    assert opt3._step_count == 3 and s3.last_epoch == 3
    run(opt3, s3, params3, grads[3:])
    for name in SHAPES:
        assert torch.equal(params3[name], params[name]), name
        for slot, value in opt._get_slots(params[name]).items():
            assert torch.equal(opt3._get_slots(params3[name])[slot], value)


# These options raised NotImplementedError until the training slice ported
# them; each case now holds the port to the JAX package with it.
@pytest.mark.parametrize('kwargs', [
    {'learning_rate': lambda p: p.lr.PiecewiseDecay([2, 4],
                                                    [1e-2, 5e-3, 1e-3])},
    {'grad_clip': lambda p: p.nn.ClipGradByGlobalNorm(0.05)},
    {'weight_decay': lambda p: p.reg.L1Decay(0.1)}])
def test_unported_optimizer_options_raise(kwargs):
    # (a regularizer as weight_decay is coupled decay by its coefficient,
    # in both packages)
    spec = dict({'learning_rate': 1e-2}, **kwargs)
    _compare(str(kwargs), 'AdamW', spec, 'float32')
    _compare(str(kwargs), 'Momentum', spec, 'float32')


# each rule as TrainStep applies it: the learning rate an f32 array (the
# JAX step's traced rate, the port's lr_is_f32), so its products with bf16
# parameters (no master) are taken in f32
STEP_RULES = {
    'SGD': {'learning_rate': 0.05},
    'Momentum': {'learning_rate': 0.05},
    'Adam': {'learning_rate': 1e-2},
    'AdamW': {'learning_rate': 1e-2, 'weight_decay': 0.1},
    'Adamax': {'learning_rate': 1e-2},
    'Adagrad': {'learning_rate': 0.05},
    'Adadelta': {'learning_rate': 1.0},
    'RMSProp': {'learning_rate': 1e-2},
    'Lamb': {'learning_rate': 1e-2},
    'LarsMomentum': {'learning_rate': 0.5, 'lars_coeff': 0.1},
    'Ftrl': {'learning_rate': 0.1, 'l1': 1e-3},
    'ProximalGD': {'learning_rate': 0.1, 'l1': 1e-3},
    'ProximalAdagrad': {'learning_rate': 0.05},
    'SparseAdam': {'learning_rate': 1e-2},
}


@pytest.mark.parametrize('rule', sorted(STEP_RULES))
def test_train_step_rules_bf16_match_jax(rule):
    """The update of the JAX TrainStep's apply_updates (the rule with an
    f32 rate and an int32 step, decoupled decay in f32, the result cast
    back to bf16), run op by op, against the port's _update with
    lr_is_f32."""
    kwargs = STEP_RULES[rule]
    lr = kwargs['learning_rate']
    init, grads = _params(3), _grads(4)
    jparams = {n: jnp.asarray(v).astype(jnp.bfloat16)
               for n, v in init.items()}
    jopt = getattr(paddle.optimizer, rule)(**kwargs)
    jslots = {}
    for n, v in jparams.items():
        p = paddle.create_parameter(list(v.shape), 'float32', name=n)
        p._data = v
        jslots[n] = dict(jopt._get_slots(p))
    tparams = _torch_params(init, torch.bfloat16)
    topt_ = getattr(topt, rule)(parameters=list(tparams.items()), **kwargs)
    coeff = jopt._decay_coeff()
    for step, g in enumerate(grads, start=1):
        flr = jnp.asarray(lr, jnp.float32)
        t = jnp.asarray(step - 1, jnp.int32) + 1
        for n in jparams:
            p = jparams[n]
            jg = jnp.asarray(g[n]).astype(jnp.bfloat16)
            if coeff and not jopt._apply_decoupled_decay():
                jg = jg + coeff * p
            if coeff and jopt._apply_decoupled_decay():
                p = p * (1.0 - flr * coeff)
            jopt._apply_param_name = n
            new_p, slots = jopt._apply(p, jg, jslots[n], flr, t)
            jslots[n] = {k: v.astype(jslots[n][k].dtype)
                         for k, v in slots.items()}
            jparams[n] = new_p.astype(jnp.bfloat16)
        topt_._update([(n, p, torch.tensor(g[n]).bfloat16())
                       for n, p in tparams.items()], lr, step,
                      lr_is_f32=True)
    for n in SHAPES:
        want = np.asarray(jparams[n].astype(jnp.float32))
        got = tparams[n].detach().float().numpy()
        ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert np.all(np.abs(got - want) <= ulp + 1e-12), \
            (rule, n, np.abs(got - want).max())
