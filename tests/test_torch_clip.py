"""The port's gradient clipping (paddle_tpu_torch/nn/clip.py) against the
JAX package's (paddle_tpu/nn/clip.py): the three clip classes over
(param, grad) pairs, a parameter with need_clip=False, and
clip_grad_norm_ / clip_grad_value_ on parameters' grads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import Tensor

SHAPES = [(4, 3), (3,), (5, 2)]


def _pairs(seed, scale, need_clip=(True, False, True)):
    rng = np.random.RandomState(seed)
    grads = [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
    jp, tp = [], []
    for shape, flag in zip(SHAPES, need_clip):
        j = paddle.create_parameter(list(shape), 'float32')
        j.need_clip = flag
        t = torch.zeros(shape, requires_grad=True)
        t.need_clip = flag
        jp.append(j)
        tp.append(t)
    return grads, jp, tp


def _make(pkg_nn, kind):
    return {'value': lambda: pkg_nn.ClipGradByValue(0.5, -0.3),
            'norm': lambda: pkg_nn.ClipGradByNorm(1.0),
            'global_norm': lambda: pkg_nn.ClipGradByGlobalNorm(1.0)}[kind]()


@pytest.mark.parametrize('kind', ['value', 'norm', 'global_norm'])
@pytest.mark.parametrize('scale', [0.01, 3.0])
def test_clip_classes_match_jax(kind, scale):
    grads, jp, tp = _pairs(7, scale)
    want = _make(paddle.nn, kind)(
        [(p, Tensor(jnp.asarray(g))) for p, g in zip(jp, grads)])
    got = _make(tpt.nn, kind)(
        [(p, torch.tensor(g)) for p, g in zip(tp, grads)])
    for (_, w), (_, g), raw, p in zip(want, got, grads, tp):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data),
                                   rtol=1e-6, atol=1e-8)
        if kind == 'global_norm' and not p.need_clip:
            assert np.array_equal(g.numpy(), raw)  # left alone


def test_global_norm_bf16_grads_and_none():
    grads, jp, tp = _pairs(8, 4.0, need_clip=(True, True, True))
    want = paddle.nn.ClipGradByGlobalNorm(1.0)(
        [(p, Tensor(jnp.asarray(g).astype(jnp.bfloat16)))
         for p, g in zip(jp, grads)] + [(jp[0], None)])
    got = tpt.nn.ClipGradByGlobalNorm(1.0)(
        [(p, torch.tensor(g).bfloat16()) for p, g in zip(tp, grads)] +
        [(tp[0], None)])
    assert got[-1][1] is None
    for (_, w), (_, g) in zip(want[:-1], got[:-1]):
        assert g.dtype == torch.bfloat16
        # the norm is taken in f32 on both sides, the product rounded once
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w._data.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-6)
    # the scale stays on the device: nothing is read back
    norm = tpt.nn.ClipGradByGlobalNorm(1.0).global_norm(
        [(p, torch.tensor(g)) for p, g in zip(tp, grads)])
    assert torch.is_tensor(norm) and norm.dim() == 0


@pytest.mark.parametrize('norm_type', [2.0, 1.0, float('inf')])
def test_clip_grad_norm_matches_jax(norm_type):
    grads, jp, tp = _pairs(9, 2.0)
    for p, g in zip(jp, grads):
        p.grad = Tensor(jnp.asarray(g))
    for p, g in zip(tp, grads):
        p.grad = torch.tensor(g)
    want = paddle.nn.clip.clip_grad_norm_(jp, 1.5, norm_type=norm_type)
    got = tpt.nn.clip.clip_grad_norm_(tp, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(got.item(), float(want.numpy()), rtol=1e-6)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad._data),
                                   rtol=1e-6, atol=1e-8)


def test_clip_grad_value_matches_jax():
    grads, jp, tp = _pairs(10, 2.0)
    for p, g in zip(jp, grads):
        p.grad = Tensor(jnp.asarray(g))
    for p, g in zip(tp, grads):
        p.grad = torch.tensor(g)
    paddle.nn.clip.clip_grad_value_(jp, 0.7)
    tpt.nn.clip.clip_grad_value_(tp, 0.7)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.grad.numpy(),
                                      np.asarray(j.grad._data))
