"""The port's convolutions (paddle_tpu_torch/nn/functional/conv.py,
nn/layer/conv.py) and the static.nn builders they unlock, against the JAX
package's on the same seeded numpy inputs and weights.

Forward outputs agree within 1e-5 (absolute and relative): both sides sum
the same f32 products, XLA's CPU convolution and torch's in different
orders, a few ulps apart at these sizes. Gradients (jax.grad of
sum(out * cotangent) against autograd) agree within 1e-4: the weight's
grad sums over every output position, so its rounding error grows with
the batch and spatial size.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.static.nn as jstatic_nn
from paddle_tpu.framework.core import Tensor as JTensor

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.static.nn as tstatic_nn

from jax_numpy_init import numpy_init  # noqa: F401

TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, want, tol=TOL, msg=''):
    got, want = (v.detach().numpy() if torch.is_tensor(v) else v
                 for v in (got, want))
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


# (name, nd, x shape, w shape, kwargs): strides, dilations, groups, every
# padding form Paddle takes, 'SAME' and 'VALID' at stride 2, channel-last
CONV_CASES = [
    ('1d-int', 1, (2, 4, 11), (6, 4, 3), dict(padding=1)),
    ('1d-same-s2', 1, (2, 4, 11), (6, 2, 4), dict(stride=2, padding='SAME',
                                                  groups=2)),
    ('1d-nlc', 1, (2, 11, 4), (6, 4, 3), dict(padding=[2],
                                              data_format='NLC')),
    ('2d-int-s2', 2, (2, 4, 9, 10), (6, 4, 3, 3), dict(stride=2,
                                                       padding=1)),
    ('2d-list', 2, (2, 4, 9, 10), (6, 4, 3, 2), dict(padding=[1, 0],
                                                     dilation=2)),
    ('2d-pairs-flat', 2, (2, 4, 9, 10), (6, 4, 3, 3),
     dict(stride=2, padding=[0, 2, 1, 0])),
    ('2d-pairs', 2, (2, 4, 9, 10), (6, 4, 3, 3),
     dict(stride=(2, 1), padding=[(1, 2), (0, 1)])),
    ('2d-same-s2', 2, (2, 4, 9, 10), (6, 4, 3, 3), dict(stride=2,
                                                        padding='SAME')),
    ('2d-same-s2-dil', 2, (2, 4, 10, 9), (6, 4, 3, 3),
     dict(stride=2, padding='same', dilation=2)),
    ('2d-valid-s2', 2, (2, 4, 9, 10), (6, 4, 3, 3), dict(stride=2,
                                                         padding='VALID')),
    ('2d-groups', 2, (2, 6, 8, 8), (9, 2, 3, 3), dict(padding=1,
                                                      groups=3)),
    ('2d-depthwise', 2, (2, 6, 8, 8), (6, 1, 3, 3), dict(stride=2,
                                                         padding=1,
                                                         groups=6)),
    ('2d-nhwc', 2, (2, 9, 10, 4), (6, 4, 3, 3), dict(stride=2,
                                                     padding='SAME',
                                                     data_format='NHWC')),
    ('2d-nhwc-pairs', 2, (2, 9, 10, 4), (6, 4, 3, 3),
     dict(padding=[1, 2, 0, 1], data_format='NHWC')),
    ('3d', 3, (1, 3, 6, 7, 5), (4, 3, 3, 3, 2), dict(stride=(1, 2, 1),
                                                     padding=1)),
    ('3d-same-ndhwc', 3, (1, 6, 7, 5, 3), (4, 3, 3, 3, 3),
     dict(stride=2, padding='SAME', data_format='NDHWC')),
]


def jax_fwd_grad(fn, args, seed):
    """fn's output on `args` (numpy) and the grads of sum(out * cot) for
    a seeded normal cotangent, from one jitted program; returns (out,
    grads, cot)."""
    shape = jax.eval_shape(fn, *args).shape
    cot = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def both(*a):
        return fn(*a), jax.grad(lambda *p: jnp.sum(fn(*p) * cot),
                                argnums=tuple(range(len(a))))(*a)
    out, grads = jax.jit(both)(*args)
    return np.asarray(out), grads, cot


def _conv_fns(nd):
    name = 'conv%dd' % nd
    return getattr(JF, name), getattr(TF, name)


@pytest.mark.parametrize('case', CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_matches_jax_forward_and_grads(case):
    _, nd, xs, ws, kw = case
    rng = np.random.RandomState(len(case[0]))
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32) * 0.3
    b = rng.randn(ws[0]).astype(np.float32)
    jfn, tfn = _conv_fns(nd)
    want, grads, cot = jax_fwd_grad(
        lambda a, ww, bb: jfn(JTensor(a), JTensor(ww), JTensor(bb),
                              **kw)._data, (x, w, b), 1)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    out = tfn(tx, tw, tb, **kw)
    assert tuple(out.shape) == want.shape
    _close(out, want)
    (out * torch.tensor(cot)).sum().backward()
    for got, g, what in zip((tx.grad, tw.grad, tb.grad), grads,
                            ('dx', 'dw', 'db')):
        _close(got, g, GRAD_TOL, what)


# transposed convolutions: stride, symmetric and asymmetric pads,
# output_padding, output_size, groups, dilation, 'SAME' / 'VALID',
# channel-last
CONV_T_CASES = [
    ('1d-s2', 1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1)),
    ('1d-nlc-op', 1, (2, 7, 4), (4, 3, 3), dict(stride=3, padding=1,
                                                output_padding=2,
                                                data_format='NLC')),
    ('2d-s2-op', 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=1,
                                                     output_padding=1)),
    ('2d-asym', 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2,
                                                    padding=[0, 2, 1, 0])),
    ('2d-pairs-big', 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=[(3, 1), (0, 0)], output_padding=1)),
    ('2d-op-over-pad', 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=3, padding=[0, 0], output_padding=2)),
    ('2d-output-size', 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_size=[10, 12])),
    ('2d-groups-dil', 2, (2, 6, 5, 5), (6, 2, 3, 3), dict(stride=2,
                                                          padding=2,
                                                          groups=3,
                                                          dilation=2)),
    ('2d-same', 2, (2, 4, 5, 6), (4, 3, 4, 3), dict(stride=2,
                                                    padding='SAME')),
    ('2d-valid', 2, (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2,
                                                     padding='VALID',
                                                     output_padding=1)),
    ('2d-nhwc', 2, (2, 5, 6, 4), (4, 3, 3, 3), dict(stride=2, padding=1,
                                                    data_format='NHWC')),
    ('3d', 3, (1, 3, 4, 3, 4), (3, 2, 3, 2, 3), dict(stride=2, padding=1,
                                                     output_padding=1)),
]


@pytest.mark.parametrize('case', CONV_T_CASES,
                         ids=[c[0] for c in CONV_T_CASES])
def test_conv_transpose_matches_jax_forward_and_grads(case):
    _, nd, xs, ws, kw = case
    kw = dict(kw)
    size = kw.pop('output_size', None)
    rng = np.random.RandomState(len(case[0]) + 7)
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32) * 0.3
    groups = kw.get('groups', 1)
    b = rng.randn(ws[1] * groups).astype(np.float32)
    name = 'conv%dd_transpose' % nd
    jfn, tfn = getattr(JF, name), getattr(TF, name)
    want, grads, cot = jax_fwd_grad(
        lambda a, ww, bb: jfn(JTensor(a), JTensor(ww), JTensor(bb),
                              output_size=size, **kw)._data, (x, w, b), 2)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    out = tfn(tx, tw, tb, output_size=size, **kw)
    assert tuple(out.shape) == want.shape
    _close(out, want)
    (out * torch.tensor(cot)).sum().backward()
    for got, g, what in zip((tx.grad, tw.grad, tb.grad), grads,
                            ('dx', 'dw', 'db')):
        _close(got, g, GRAD_TOL, what)


def test_conv_transpose_output_size_checks_match_jax():
    x = np.zeros((1, 2, 5, 5), np.float32)
    w = np.zeros((2, 3, 3, 3), np.float32)
    for kw, match in ((dict(stride=2, padding=1, output_size=[12, 12]),
                       'unreachable'),
                      (dict(stride=2, padding='SAME', output_size=[10, 10]),
                       'string padding')):
        with pytest.raises(ValueError, match=match):
            JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                **kw)
        with pytest.raises(ValueError, match=match):
            TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), **kw)


LAYER_CASES = [
    ('Conv1D', (2, 4, 9), (4, 6, 3), dict(stride=2, padding=1)),
    ('Conv2D', (2, 4, 9, 9), (4, 6, 3), dict(padding='SAME', groups=2)),
    ('Conv3D', (1, 2, 5, 5, 5), (2, 4, (3, 3, 2)), dict(padding=1)),
    ('Conv1DTranspose', (2, 4, 6), (4, 6, 3), dict(stride=2, padding=1,
                                                   output_padding=1)),
    ('Conv2DTranspose', (2, 4, 5, 5), (4, 6, 3), dict(stride=2, padding=1,
                                                      groups=2)),
    ('Conv3DTranspose', (1, 2, 3, 3, 3), (2, 4, 3), dict(stride=2)),
]


@pytest.mark.parametrize('case', LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_conv_layers_match_jax(case, numpy_init):
    """Weight and bias shapes and names, the init's bound (Uniform(+-1 /
    sqrt(fan_in))), then the forward with the JAX layer's weights carried
    across."""
    name, xs, (cin, cout, k), kw = case
    paddle.seed(0)
    jl = getattr(jnn, name)(cin, cout, k, **kw)
    tl = getattr(tnn, name)(cin, cout, k, device='cpu',
                            generator=torch.Generator().manual_seed(0),
                            **kw)
    js = {n: v.numpy() for n, v in jl.state_dict().items()}
    ts = tl.state_dict()
    assert sorted(js) == sorted(ts) == ['bias', 'weight']
    for n in js:
        assert tuple(ts[n].shape) == js[n].shape, n
    groups = kw.get('groups', 1)
    fan_in = cin // groups * int(np.prod(tl._kernel_size))
    bound = 1 / np.sqrt(fan_in)
    for v in ts.values():
        assert v.abs().max().item() <= bound
        assert v.abs().max().item() > 0.5 * bound
    with torch.no_grad():
        for n, v in ts.items():
            v.copy_(torch.tensor(js[n]))
    x = np.random.RandomState(3).randn(*xs).astype(np.float32)
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)).numpy())
    # padding_mode is stored and not used, as in the JAX package
    # (paddle_tpu/nn/layer/conv.py:30 stores it; its forward never reads
    # it): a 'reflect' layer pads with zeros all the same
    if not name.endswith('Transpose'):
        tr = getattr(tnn, name)(cin, cout, k, padding_mode='reflect',
                                device='cpu', **kw)
        tr.load_state_dict(tl.state_dict())
        assert tr._padding_mode == 'reflect'
        _close(tr(torch.tensor(x)), tl(torch.tensor(x)))


def test_conv_layers_keep_bias_attr_false_and_channel_last(numpy_init):
    tl = tnn.Conv2D(3, 4, 3, bias_attr=False, data_format='NHWC',
                    device='cpu')
    assert tl.bias is None
    jl = jnn.Conv2D(3, 4, 3, bias_attr=False, data_format='NHWC')
    with torch.no_grad():
        tl.weight.copy_(torch.tensor(jl.weight.numpy()))
    x = np.random.RandomState(5).randn(2, 7, 6, 3).astype(np.float32)
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)).numpy())


def test_conv_under_auto_cast_computes_in_bf16():
    from paddle_tpu_torch.amp import auto_cast
    x = torch.randn(1, 3, 6, 6)
    w = torch.randn(4, 3, 3, 3)
    with auto_cast(dtype='bfloat16'):
        out = TF.conv2d(x, w, padding=1)
    assert out.dtype == torch.bfloat16
    _close(out.float(), TF.conv2d(x, w, padding=1), 0.1)


# ---- the static.nn builders conv unlocks --------------------------------

STATIC_CONV = [
    ('conv2d', (2, 3, 8, 8), (4, 3), dict(stride=2, padding=1, act='relu'),
     lambda: tnn.Conv2D(3, 4, 3, stride=2, padding=1, device='cpu'),
     'relu'),
    ('conv2d_transpose', (2, 3, 5, 5), (4,), dict(filter_size=3, stride=2,
                                                  padding=1),
     lambda: tnn.Conv2DTranspose(3, 4, 3, stride=2, padding=1,
                                    device='cpu'), None),
    ('conv3d', (1, 2, 5, 5, 5), (3, 3), dict(),
     lambda: tnn.Conv3D(2, 3, 3, device='cpu'), None),
    ('conv3d_transpose', (1, 2, 3, 3, 3), (3,), dict(filter_size=2,
                                                     stride=2),
     lambda: tnn.Conv3DTranspose(2, 3, 2, stride=2, device='cpu'), None),
]


@pytest.mark.parametrize('case', STATIC_CONV, ids=[c[0] for c in STATIC_CONV])
def test_static_conv_builders_match_their_layer_and_jax_shape(case,
                                                              numpy_init):
    """A builder is a fresh layer over its input: its output equals that
    layer's from the same generator state, and its shape the JAX
    builder's."""
    name, xs, args, kw, make, act = case
    x = np.random.RandomState(2).randn(*xs).astype(np.float32)
    torch.manual_seed(11)
    got = getattr(tstatic_nn, name)(torch.tensor(x), *args, **kw)
    torch.manual_seed(11)
    want = make()(torch.tensor(x))
    if act:
        want = torch.relu(want)
    _close(got, want)
    jout = getattr(jstatic_nn, name)(paddle.to_tensor(x), *args, **kw)
    assert tuple(got.shape) == tuple(jout.shape)


STATIC_PLAIN = [
    ('batch_norm', (2, 3, 4, 4), (), dict(act='relu')),
    ('instance_norm', (2, 3, 4, 4), (), {}),
    ('group_norm', (2, 4, 3, 3), (2,), {}),
    ('prelu', (2, 3, 4, 4), (), dict(mode='channel')),
    ('prelu', (2, 3, 4, 4), (), {}),
    ('lrn', (2, 6, 4, 4), (), dict(n=3)),
    ('space_to_depth', (2, 3, 4, 6), (2,), {}),
    ('reverse', (2, 3, 4), ([0, 2],), {}),
]


@pytest.mark.parametrize('case', STATIC_PLAIN,
                         ids=['%s-%d' % (c[0], i)
                              for i, c in enumerate(STATIC_PLAIN)])
def test_static_norm_and_alias_builders_match_jax(case, numpy_init):
    name, xs, args, kw = case
    x = np.random.RandomState(4).randn(*xs).astype(np.float32)
    want = getattr(jstatic_nn, name)(paddle.to_tensor(x), *args, **kw)
    got = getattr(tstatic_nn, name)(torch.tensor(x), *args, **kw)
    _close(got, want.numpy())


def test_static_cos_sim_and_refusals_match_jax():
    rng = np.random.RandomState(6)
    a, b = rng.randn(5, 7).astype(np.float32), rng.randn(5, 7).astype(
        np.float32)
    _close(tstatic_nn.cos_sim(torch.tensor(a), torch.tensor(b)),
           jstatic_nn.cos_sim(paddle.to_tensor(a),
                              paddle.to_tensor(b)).numpy())
    for mod in (jstatic_nn, tstatic_nn):
        with pytest.raises(NotImplementedError, match='nn.utils.spectral'):
            mod.spectral_norm(None)
    # deform_conv2d passes through to vision.ops.deform_conv2d in both
    # packages. The JAX function raises on every input (a reference
    # defect, tests/test_torch_detection.py), so the port's is held, with
    # zero offsets, to the JAX package's conv2d
    x = rng.randn(1, 3, 5, 4).astype(np.float32)
    w = rng.randn(2, 3, 3, 3).astype(np.float32)
    off = np.zeros((1, 18, 3, 2), np.float32)
    _close(tstatic_nn.deform_conv2d(torch.tensor(x), torch.tensor(off),
                                    torch.tensor(w)),
           JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w)).numpy())
    with pytest.raises(TypeError):
        jstatic_nn.deform_conv2d(paddle.to_tensor(x), paddle.to_tensor(off),
                                 paddle.to_tensor(w))
