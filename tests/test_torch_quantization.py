"""The port's slim quantization (paddle_tpu_torch/slim/) against the JAX
package's, on the CPU at small sizes: a 2-layer MLP (8 -> 32 -> 4) and a
2-conv net (1 x 8 x 8 images), weights carried across with
load_paddle_tpu_state, inputs drawn by numpy from a seed.

- the fake-quant forward and its straight-through gradient, exact in
  f32, at points whose quantized value is a half-integer or exactly
  +-qmax and at points outside the range;
- QAT: the wrapped forward and 3 SGD steps with the moving-average scale
  updates, within 1e-6;
- PTQ: the calibrated scales of every algorithm on the same numpy batches
  within 1e-6 relative, and the quantized forward within 1e-5;
- cal_kl_threshold and the observer's re-binning equal to the JAX ones;
- skip_quant, one wrapper for a shared layer, the type aliases, the
  observer hooks removed after a failing loader, save_quantized_model
  through jit.save / jit.load.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import slim as jslim
from paddle_tpu.slim import ptq as jptq

import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import slim as tslim
from paddle_tpu_torch.slim import ptq as tptq
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

from jax_numpy_init import numpy_init  # noqa: F401

TOL = 1e-6


def _state(jl):
    return {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}


def _carry(jl, tl):
    load_paddle_tpu_state(tl, _state(jl))
    return tl


def _mlp_pair():
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = tnn.Sequential(tnn.Linear(8, 32, device='cpu'), tnn.ReLU(),
                        tnn.Linear(32, 4, device='cpu'))
    return jm, _carry(jm, tm)


def _convnet_pair():
    jm = jnn.Sequential(jnn.Conv2D(1, 4, 3, padding=1), jnn.ReLU(),
                        jnn.Conv2D(4, 4, 3, padding=1), jnn.ReLU(),
                        jnn.Flatten(), jnn.Linear(4 * 8 * 8, 3))
    tm = tnn.Sequential(tnn.Conv2D(1, 4, 3, padding=1, device='cpu'),
                        tnn.ReLU(),
                        tnn.Conv2D(4, 4, 3, padding=1, device='cpu'),
                        tnn.ReLU(), tnn.Flatten(),
                        tnn.Linear(4 * 8 * 8, 3, device='cpu'))
    return jm, _carry(jm, tm)


def _f32(a):
    return np.asarray(a, np.float32)


# -- the fake-quant primitive -------------------------------------------------

def _edge_points(s, qmax=127.0):
    """x values (f32) whose y = fl(fl(x / s) * qmax) is a half-integer,
    exactly +-qmax, or outside [-qmax, qmax], found by scanning a few ulps
    around each target."""
    f = np.float32
    s, qmax = f(s), f(qmax)
    targets = [k + 0.5 for k in range(-4, 4)] + [-126.5, 126.5, -127.0,
                                                   127.0, -127.5, 127.5,
                                                   -130.0, 130.0]
    xs, kinds = [], {'half': 0, 'edge': 0, 'outside': 0}
    for t in targets:
        x = f(f(t) * s / qmax)
        for _ in range(4):
            x = np.nextafter(x, f(-np.inf))
        for _ in range(9):
            y = f(f(x / s) * qmax)
            if y == f(t):
                xs.append(x)
                if abs(t) > qmax:
                    kinds['outside'] += 1
                elif abs(t) == qmax:
                    kinds['edge'] += 1
                else:
                    kinds['half'] += 1
            x = np.nextafter(x, f(np.inf))
    return _f32(xs), kinds


def test_fake_quant_ste_at_half_integers_and_bounds():
    s = 0.37
    x, kinds = _edge_points(s)
    assert kinds['half'] >= 8 and kinds['edge'] >= 2 and \
        kinds['outside'] >= 2, kinds
    cot = _f32(np.random.RandomState(0).uniform(0.5, 1.5, x.shape))

    def jf(a):
        return jnp.sum(jslim.fake_quant_dequant_with_scale(
            a, jnp.float32(s)) * cot)
    j_out = np.asarray(jslim.fake_quant_dequant_with_scale(
        jnp.asarray(x), jnp.float32(s)))
    j_grad = np.asarray(jax.grad(jf)(jnp.asarray(x)))

    tx = torch.tensor(x, requires_grad=True)
    t_out = tslim.fake_quant_dequant_with_scale(tx, torch.tensor(
        s, dtype=torch.float32))
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(t_out.detach().numpy(), j_out)
    np.testing.assert_array_equal(tx.grad.numpy(), j_grad)
    # the quantized levels: round half to even, and the STE's range
    y = (x / np.float32(s)) * np.float32(127)
    levels = t_out.detach().numpy() * np.float32(127) / np.float32(s)
    np.testing.assert_allclose(levels, np.clip(np.round(y), -127, 127),
                               atol=1e-3)
    inside = np.abs(y) <= 127
    assert np.all((tx.grad.numpy() != 0) == inside)


@pytest.mark.parametrize('kind', ['abs_max', 'channel_wise_0',
                                  'channel_wise_1'])
def test_fake_quant_dynamic_scales_match_jax(kind):
    rng = np.random.RandomState(1)
    w = _f32(rng.standard_normal((16, 8)) * np.linspace(0.1, 10, 8))
    cot = _f32(rng.standard_normal(w.shape))
    if kind == 'abs_max':
        jfn, tfn = jslim.fake_quant_dequant_abs_max, \
            tslim.fake_quant_dequant_abs_max
        kw = {}
    else:
        jfn, tfn = jslim.fake_quant_dequant_channel_wise, \
            tslim.fake_quant_dequant_channel_wise
        kw = {'axis': int(kind[-1])}
    j_out = np.asarray(jfn(jnp.asarray(w), **kw))
    j_grad = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a, **kw) * cot))(
        jnp.asarray(w)))
    tw = torch.tensor(w, requires_grad=True)
    t_out = tfn(tw, **kw)
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(t_out.detach().numpy(), j_out)
    np.testing.assert_array_equal(tw.grad.numpy(), j_grad)


# -- QAT ---------------------------------------------------------------------

def test_qat_wrap_and_forward_match_jax(numpy_init):
    jm, tm = _mlp_pair()
    x = _f32(np.random.RandomState(0).standard_normal((16, 8)))
    for model, quanter in ((jm, jslim.ImperativeQuantAware(
            weight_quantize_type='channel_wise_abs_max')),
            (tm, tslim.ImperativeQuantAware(
                weight_quantize_type='channel_wise_abs_max'))):
        quanter.quantize(model)
        model.train()
    assert [type(l).__name__ for l in tm.modules()].count(
        'QuantedLinear') == 2
    assert isinstance(tm[0], tslim.QuantedLinear) and \
        isinstance(tm[2], tslim.QuantedLinear)
    j_out = jm(paddle.to_tensor(x)).numpy()
    t_out = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=TOL, atol=TOL)
    js, ts = _state(jm), {k: v.numpy() for k, v in tm.state_dict().items()}
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert float(ts['0._act_quanter.scale']) > 0
    assert int(ts['0._act_quanter.initialized']) == 1


def test_qat_three_steps_match_jax(numpy_init):
    jm, tm = _mlp_pair()
    jslim.ImperativeQuantAware().quantize(jm)
    tslim.ImperativeQuantAware().quantize(tm)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = tpt.optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())
    rng = np.random.RandomState(3)
    jl, tl = [], []
    scales = []
    for i in range(3):
        x = _f32(rng.standard_normal((32, 8)) * (1 + i))
        y = rng.randint(0, 4, (32,)).astype(np.int64)
        loss = jnn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = tnn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
        scales.append((float(jm[2]._act_quanter.scale.numpy()),
                       tm[2]._act_quanter.scale.item()))
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    # the EMA moved: each batch is wider than the last
    assert scales[0][1] < scales[1][1] < scales[2][1]
    np.testing.assert_allclose([t for _, t in scales], [j for j, _ in scales],
                               rtol=TOL)
    js = _state(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), js[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_qat_eval_uses_frozen_scale_and_exports(tmp_path, numpy_init):
    jm, tm = _mlp_pair()
    quanter = tslim.ImperativeQuantAware()
    jslim.ImperativeQuantAware().quantize(jm)
    quanter.quantize(tm)
    x = _f32(np.random.RandomState(0).standard_normal((4, 8)))
    for model, fwd in ((jm, lambda a: jm(paddle.to_tensor(a)).numpy()),
                       (tm, lambda a: tm(torch.from_numpy(a)).detach()
                        .numpy())):
        model.train()
        fwd(x)              # one training call sets the EMA scales
        model.eval()
    j_ref = jm(paddle.to_tensor(x * 3)).numpy()
    ref = tm(torch.from_numpy(x * 3)).detach().numpy()
    # eval clips to the frozen scale: the 3x input saturates as in JAX
    np.testing.assert_allclose(ref, j_ref, rtol=TOL, atol=TOL)
    path = str(tmp_path / 'qat_model')
    quanter.save_quantized_model(
        tm, path, input_spec=[tpt.static.InputSpec([4, 8], 'float32')])
    loaded = tpt.jit.load(path, device='cpu')
    np.testing.assert_allclose(
        loaded(torch.from_numpy(x * 3)).detach().numpy(), ref, rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        loaded.run_exported(torch.from_numpy(x * 3)).numpy(), ref,
        rtol=1e-6, atol=1e-6)


# -- PTQ ---------------------------------------------------------------------

@pytest.mark.parametrize('algo', ['abs_max', 'avg', 'mse', 'KL', 'hist'])
def test_ptq_scales_match_jax(algo, numpy_init):
    jm, tm = _convnet_pair()
    rng = np.random.RandomState(0)
    data = [_f32(rng.standard_normal((8, 1, 8, 8)) * (1 + 0.5 * i))
            for i in range(4)]
    jp = jslim.PostTrainingQuantization(
        model=jm, data_loader=[paddle.to_tensor(d) for d in data],
        batch_nums=4, algo=algo, bins=512)
    tp = tslim.PostTrainingQuantization(
        model=tm, data_loader=[torch.from_numpy(d) for d in data],
        batch_nums=4, algo=algo, bins=512)
    jq, tq = jp.quantize(), tp.quantize()
    assert tq is tm
    assert sorted(tp.scales) == sorted(jp.scales) == ['0', '2', '5']
    for name, s in jp.scales.items():
        assert s > 0
        np.testing.assert_allclose(tp.scales[name], s, rtol=TOL,
                                   err_msg=name)
    kinds = [type(l) for l in tq.modules()]
    assert kinds.count(tslim.QuantedConv2D) == 2 and \
        kinds.count(tslim.QuantedLinear) == 1
    np.testing.assert_allclose(
        tq(torch.from_numpy(data[0])).detach().numpy(),
        jq(paddle.to_tensor(data[0])).numpy(), rtol=1e-5, atol=1e-5)


def test_cal_kl_threshold_equals_jax():
    rng = np.random.RandomState(0)
    hists = []
    h = np.zeros(2048)
    h[:256] = 1000.0
    h[-1] = 1.0
    hists.append(h)
    hists.append(np.histogram(np.abs(rng.standard_normal(20000)), 1024,
                              range=(0, 5))[0].astype(np.float64))
    hists.append(rng.randint(0, 50, 300).astype(np.float64))
    hists.append(np.zeros(2048))
    for h in hists:
        for bits in (8, 4):
            got = tslim.cal_kl_threshold(h, 10.0 / len(h), bits)
            assert got == jslim.cal_kl_threshold(h, 10.0 / len(h), bits)
    assert tslim.cal_kl_threshold(hists[0], 10.0 / 2048, 8) < 7.5


@pytest.mark.parametrize('algo', ['hist', 'KL'])
def test_observer_rebinning_equals_jax(algo):
    rng = np.random.RandomState(0)
    batches = [rng.uniform(-1, 1, 4096), rng.uniform(-10, 10, 4096),
               rng.standard_normal(8192) * 0.1, np.asarray([5.0, 12.0])]
    jo = jptq._Observer(algo, 8, hist_bins=512, hist_percent=0.999)
    to = tptq._Observer(algo, 8, hist_bins=512, hist_percent=0.999)
    for b in batches:
        jo.observe(b)
        to.observe(torch.from_numpy(b.astype(np.float32)).numpy())
        np.testing.assert_array_equal(to.hist, jo.hist)
        assert to.hist_range == jo.hist_range
    assert to.scale() == jo.scale()


# -- the layer walk ------------------------------------------------------------

def test_skip_quant_respected(numpy_init):
    jm, tm = _mlp_pair()
    jm[0].skip_quant = True
    tm[0].skip_quant = True
    jslim.ImperativeQuantAware().quantize(jm)
    tslim.ImperativeQuantAware().quantize(tm)
    assert type(tm[0]) is tnn.Linear and type(jm[0]) is jnn.Linear
    assert type(tm[2]) is tslim.QuantedLinear


class _TwoPath(torch.nn.Module):
    def __init__(self):
        super().__init__()
        shared = tnn.Linear(8, 8, device='cpu')
        self.a = shared
        self.b = shared

    def forward(self, x):
        return self.a(x) + self.b(x)


def test_shared_layer_single_wrapper_and_alias_types():
    model = _TwoPath()
    rng = np.random.RandomState(0)
    data = [torch.from_numpy(_f32(rng.standard_normal((4, 8))))
            for _ in range(2)]
    ptq = tslim.PostTrainingQuantization(model=model, data_loader=data,
                                         batch_nums=2, algo='abs_max',
                                         quantizable_op_type=('linear',))
    ptq.quantize()
    assert model.a is model.b
    assert isinstance(model.a, tslim.QuantedLinear)
    assert model.a._act_quanter.scale.item() > 0
    assert list(ptq.scales) == ['a']
    with pytest.raises(ValueError):
        tslim.PostTrainingQuantization(model=model, data_loader=data,
                                       quantizable_op_type=('nope',))
    with pytest.raises(NotImplementedError):
        tslim.ImperativeQuantAware(weight_quantize_layer=object())
    for alias in ('mul', 'matmul', 'conv2d', 'depthwise_conv2d'):
        assert tslim.quant_layers.resolve_quant_types([alias]) == \
            jslim.quant_layers.resolve_quant_types([alias])


def test_ptq_hooks_removed_on_failure(numpy_init):
    _, tm = _mlp_pair()
    bad = [torch.zeros(4, 8), torch.zeros(4, 3)]  # the second: wrong width
    ptq = tslim.PostTrainingQuantization(model=tm, data_loader=bad,
                                         batch_nums=2, algo='abs_max')
    with pytest.raises(Exception):
        ptq.quantize()
    for layer in tm.modules():
        assert not layer._forward_pre_hooks, layer


def test_nn_quant_namespace():
    assert tnn.quant.QuantedLinear is tslim.QuantedLinear
    assert tnn.quant.QUANT_LAYER_MAP['Conv2D'] == (tnn.Conv2D,
                                                   tslim.QuantedConv2D)
    assert sorted(tnn.quant.quant_layers.__all__) == \
        sorted(jnn.quant.quant_layers.__all__)
    assert sorted(tslim.__all__) == sorted(jslim.__all__)
