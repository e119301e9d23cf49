"""The port's optimizers (paddle_tpu_torch/optimizer/optimizers.py) against
the JAX package's eager step(): the same parameters and the same
gradients, made from a seed with numpy, over several steps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu_torch import optimizer as topt

SHAPES = {'w_decayed': (6, 5), 'b_plain': (5,)}
STEPS = 4


def _grads(seed):
    rng = np.random.RandomState(seed)
    # a spread of magnitudes, and exact zeros, where Adam's first steps are
    # most sensitive (|update| ~ lr for any nonzero grad)
    return [{name: (rng.randn(*shape) * 10.0 ** rng.randint(-3, 1, shape)
                    * (rng.rand(*shape) > 0.1)).astype(np.float32)
             for name, shape in SHAPES.items()} for _ in range(STEPS)]


def _params(seed):
    rng = np.random.RandomState(seed)
    return {name: (rng.randn(*shape) * 0.05).astype(np.float32)
            for name, shape in SHAPES.items()}


def _run_jax(cls, kwargs, dtype, init, grads):
    params = {}
    for name, value in init.items():
        p = paddle.create_parameter(list(value.shape), 'float32', name=name)
        p._data = jnp.asarray(value).astype(dtype)
        params[name] = p
    opt = cls(parameters=list(params.values()), **kwargs)
    for g in grads:
        for name, p in params.items():
            p.grad = Tensor(jnp.asarray(g[name]).astype(dtype))
        opt.step()
    slots = {name: opt._get_slots(p) for name, p in params.items()}
    return ({n: np.asarray(p._data.astype(jnp.float32))
             for n, p in params.items()},
            {n: {k: np.asarray(v) for k, v in s.items()}
             for n, s in slots.items()})


def _run_torch(cls, kwargs, dtype, init, grads):
    params = {n: torch.tensor(v).to(dtype).requires_grad_(True)
              for n, v in init.items()}
    opt = cls(parameters=list(params.items()), **kwargs)
    for g in grads:
        for name, p in params.items():
            p.grad = torch.tensor(g[name]).to(dtype)
        opt.step()
    return ({n: p.detach().float().numpy() for n, p in params.items()},
            {n: opt._get_slots(p) for n, p in params.items()})


def _decay_fun(name):
    return name.startswith('w_')


CASES = {
    'adam_f32': ('Adam', {'learning_rate': 1e-2}, 'float32'),
    'adam_f32_coupled_decay': ('Adam', {'learning_rate': 1e-2,
                                        'weight_decay': 0.1}, 'float32'),
    'adamw_f32_decay_fun': ('AdamW', {'learning_rate': 1e-2,
                                      'weight_decay': 0.5,
                                      'apply_decay_param_fun': _decay_fun},
                            'float32'),
    'adamw_bf16': ('AdamW', {'learning_rate': 1e-2}, 'bfloat16'),
    'adamw_bf16_master': ('AdamW', {'learning_rate': 1e-2,
                                    'multi_precision': True}, 'bfloat16'),
    'sgd_f32': ('SGD', {'learning_rate': 0.1}, 'float32'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_optimizer_steps_match_jax(case):
    cls_name, kwargs, dtype = CASES[case]
    init, grads = _params(1), _grads(2)
    want, want_slots = _run_jax(getattr(paddle.optimizer, cls_name), kwargs,
                                getattr(jnp, dtype), init, grads)
    got, got_slots = _run_torch(getattr(topt, cls_name), kwargs,
                                getattr(torch, dtype), init, grads)
    for name in SHAPES:
        if dtype == 'float32':
            # the same f32 arithmetic: rounding-level differences only
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       atol=1e-7)
        else:
            # bf16 params: the updates (~lr) are ~1 bf16 ulp of |p| ~0.05,
            # so a rounding flip moves a value by one ulp (2^-7 relative)
            ulp = 2.0 ** -7 * np.maximum(np.abs(want[name]), 2.0 ** -126)
            assert np.all(np.abs(got[name] - want[name]) <= ulp + 1e-12)
        for slot, value in want_slots[name].items():
            mine = got_slots[name][slot]
            # moments (and the master) of 16-bit params are f32
            assert str(mine.dtype).split('.')[-1] == str(value.dtype), slot
            np.testing.assert_allclose(mine.float().numpy(),
                                       value.astype(np.float32),
                                       rtol=2e-5, atol=1e-9)


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


@pytest.mark.parametrize('kwargs', [
    {'learning_rate': lambda: 0.1}, {'grad_clip': object()},
    {'weight_decay': object()}])
def test_unported_optimizer_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match='not ported'):
        topt.AdamW(parameters=[torch.zeros(2)], **kwargs)
