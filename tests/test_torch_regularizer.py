"""The port's regularizers (paddle_tpu_torch/regularizer.py) and parameter
metadata (ParamAttr: per-parameter regularizers and learning rates)
against the JAX package's: the terms themselves, and a TrainStep of a
small model whose parameters carry them, with a regularizer as the
optimizer's weight_decay too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.framework import functional as jfm
from paddle_tpu_torch.framework.functional import TrainStep


@pytest.mark.parametrize('kind', ['L1Decay', 'L2Decay'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_regularizer_terms_match_jax(kind, dtype):
    rng = np.random.RandomState(0)
    g, p = rng.randn(2, 7, 3).astype(np.float32)
    p[0, 0] = 0.0  # sign(0) = 0
    want = getattr(paddle.regularizer, kind)(0.3)._append(
        jnp.asarray(g).astype(dtype), jnp.asarray(p).astype(dtype))
    got = getattr(tpt.regularizer, kind)(0.3)._append(
        torch.tensor(g).to(getattr(torch, dtype)),
        torch.tensor(p).to(getattr(torch, dtype)))
    assert str(got.dtype).split('.')[-1] == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert tpt.regularizer.L1DecayRegularizer is tpt.regularizer.L1Decay
    assert tpt.regularizer.L2DecayRegularizer is tpt.regularizer.L2Decay


def _attrs(pkg):
    return dict(weight_attr=pkg.ParamAttr(
        learning_rate=0.5, regularizer=pkg.regularizer.L1Decay(0.02)),
        bias_attr=pkg.ParamAttr(regularizer=pkg.regularizer.L2Decay(0.1),
                                need_clip=False))


def _pair():
    jl = paddle.nn.Linear(6, 4, **_attrs(paddle))
    tl = tpt.nn.Linear(6, 4, device='cpu', **_attrs(tpt))
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(np.asarray(jl.weight._data)))
        tl.bias.copy_(torch.tensor(
            np.random.RandomState(1).randn(4).astype(np.float32)))
    jl.bias._data = jnp.asarray(tl.bias.detach().numpy())
    assert tl.weight.optimize_attr == {'learning_rate': 0.5}
    assert tl.bias.need_clip is False and tl.weight.need_clip is True
    return jl, tl


@pytest.mark.parametrize('opt', ['AdamW', 'SGD', 'Momentum'])
def test_param_metadata_in_train_step_matches_jax(opt):
    """In TrainStep the per-parameter regularizer is added after coupled
    decay (a regularizer as weight_decay is coupled decay by its
    coefficient), for AdamW as for the others, and each parameter runs at
    its own learning rate; clipping skips need_clip=False."""
    jl, tl = _pair()
    rng = np.random.RandomState(2)
    batches = [(rng.randn(8, 6).astype(np.float32),
                rng.randn(8, 4).astype(np.float32)) for _ in range(4)]

    def kwargs(pkg):
        kw = dict(learning_rate=0.05,
                  grad_clip=pkg.nn.ClipGradByGlobalNorm(0.5))
        kw['weight_decay'] = 0.1 if opt == 'AdamW' else \
            pkg.regularizer.L2Decay(0.05)
        return kw

    jstep = jfm.TrainStep(jl, lambda o, y: ((o - y) ** 2).mean(),
                          getattr(paddle.optimizer, opt)(
                              parameters=jl.parameters(), **kwargs(paddle)))
    tstep = TrainStep(tl, lambda o, y: ((o - y) ** 2).mean(),
                      getattr(tpt.optimizer, opt)(
                          parameters=tl.parameters(), **kwargs(tpt)))
    for x, y in batches:
        want = float(np.asarray(jstep(paddle.to_tensor(x),
                                      paddle.to_tensor(y)).numpy()))
        got = tstep(torch.tensor(x), torch.tensor(y)).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ('weight', 'bias'):
        np.testing.assert_allclose(
            getattr(tl, name).detach().numpy(),
            np.asarray(getattr(jl, name)._data), rtol=1e-5, atol=1e-6,
            err_msg=name)
