"""The port's incubate package (paddle_tpu_torch/incubate/) against the
JAX package's, on the CPU at small sizes, inputs and weights drawn by
numpy from a seed and carried across with load_paddle_tpu_state:

- ASP: the 1d and 2d masks equal, prune_model plus a decorated
  optimizer's steps within 1e-6 (the 2:4 pattern kept), the excluded
  layers, and the convolution weights that the last-dim rule skips;
- LookAhead, ModelAverage and ExponentialMovingAverage over 6 eager steps
  within 1e-6, and their snapshots kept apart from the parameters the
  inner optimizer updates in place;
- TrainEpochRange: resume after a crash, keep-last pruning and a torn
  snapshot skipped, epoch for epoch as in the JAX package;
- the segment ops with empty segments (values and gradients), vjp / jvp,
  softmax_mask_fuse_upper_triangle, recompute and the nn aliases.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as jinc
import paddle_tpu.nn as jnn
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.incubate.auto_checkpoint import \
    TrainEpochRange as JTrainEpochRange

import paddle_tpu_torch as tpt
import paddle_tpu_torch.incubate as tinc
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.incubate.auto_checkpoint import TrainEpochRange
from paddle_tpu_torch.text.models.gpt import load_paddle_tpu_state

from jax_numpy_init import numpy_init  # noqa: F401

TOL = 1e-6


def _state(jl):
    return {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}


def _pair(build):
    jm, tm = build(jnn, {}), build(tnn, {'device': 'cpu'})
    load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


def _mlp(mod, kw):
    return mod.Sequential(mod.Linear(16, 32, **kw), mod.ReLU(),
                          mod.Linear(32, 4, **kw))


def _f32(a):
    return np.asarray(a, np.float32)


def _assert_state_close(tm, jm, tol=TOL):
    js = _state(jm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), js[k], rtol=tol,
                                   atol=tol, err_msg=k)


# -- ASP -----------------------------------------------------------------------

@pytest.mark.parametrize('algo', ['mask_1d', 'mask_2d_greedy'])
def test_masks_equal_jax(algo):
    rng = np.random.RandomState(0)
    w = _f32(rng.standard_normal((16, 32)))
    w[0, :4] = 1.0   # a tied group: the stable order decides
    jm = jasp.create_mask(w, algo, n=2, m=4)
    tm = tasp.create_mask(torch.from_numpy(w), algo, n=2, m=4)
    np.testing.assert_array_equal(tm, jm)
    check = 'check_1d' if algo == 'mask_1d' else 'check_2d'
    assert tasp.check_sparsity(torch.from_numpy(w * tm), check, 2, 4)
    assert not tasp.check_sparsity(w, check, 2, 4)
    assert tasp.calculate_density(tm) == jasp.calculate_density(jm)


def test_prune_model_and_decorated_steps_match_jax(numpy_init, monkeypatch):
    monkeypatch.setattr(jasp, '_default_helper', jasp.ASPHelper())
    monkeypatch.setattr(tasp, '_default_helper', tasp.ASPHelper())
    jm, tm = _pair(_mlp)
    assert len(jasp.prune_model(jm, n=2, m=4)) == 2
    assert len(tasp.prune_model(tm, n=2, m=4)) == 2
    _assert_state_close(tm, jm, 0)
    ids = [id(p) for p in tm.parameters()]
    jopt = jasp.decorate(paddle.optimizer.SGD(learning_rate=0.1,
                                              parameters=jm.parameters()))
    topt = tasp.decorate(tpt.optimizer.SGD(learning_rate=0.1,
                                           parameters=tm.parameters()))
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = _f32(rng.standard_normal((8, 16)))
        y = rng.randint(0, 4, (8,)).astype(np.int64)
        loss = jnn.functional.cross_entropy(jm(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        loss = tnn.functional.cross_entropy(tm(torch.from_numpy(x)),
                                            torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
    assert [id(p) for p in tm.parameters()] == ids   # masked in place
    _assert_state_close(tm, jm)
    for i in (0, 2):
        w = tm[i].weight
        assert tasp.check_sparsity(w, 'check_1d', 2, 4)
        assert tasp.calculate_density(w) == 0.5


def test_excluded_layers(numpy_init):
    _, tm = _pair(lambda mod, kw: mod.Sequential(mod.Linear(8, 8, **kw),
                                                 mod.Linear(8, 8, **kw)))
    tasp.set_excluded_layers(['0'])
    jasp.set_excluded_layers(['0'])
    try:
        assert len(tasp.ASPHelper().prune_model(tm)) == 1
        assert tasp.calculate_density(tm[0].weight) == 1.0
    finally:
        tasp.reset_excluded_layers()
        jasp.reset_excluded_layers()
    assert len(tasp.ASPHelper().prune_model(tm)) == 2


def _convnet(mod, kw):
    return mod.Sequential(mod.Conv2D(4, 8, 3, padding=1, **kw), mod.ReLU(),
                          mod.Conv2D(8, 8, 1, **kw), mod.ReLU(),
                          mod.Conv2D(8, 8, 7, padding=3, **kw),
                          mod.Flatten(), mod.Linear(8 * 8 * 8, 8, **kw))


def test_conv_weights_skipped_by_the_last_dim_rule(numpy_init):
    """A conv weight's last dim is kw (3, 1, 7 here): none is a multiple
    of m = 4, so only the Linear is pruned, in both packages."""
    jm, tm = _pair(_convnet)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    jmasks = jasp.ASPHelper().prune_model(jm)
    tmasks = tasp.ASPHelper().prune_model(tm)
    assert len(tmasks) == len(jmasks) == 1
    after = tm.state_dict()
    for k in ('0.weight', '2.weight', '4.weight'):
        assert torch.equal(after[k], before[k]), k
    assert tasp.calculate_density(after['6.weight']) == 0.5
    _assert_state_close(tm, jm, 0)


def test_conv_flattened_branch_when_kw_divides(numpy_init):
    jm, tm = _pair(lambda mod, kw: mod.Sequential(mod.Conv2D(2, 4, 4,
                                                             **kw)))
    assert len(jasp.ASPHelper().prune_model(jm)) == \
        len(tasp.ASPHelper().prune_model(tm)) == 1
    _assert_state_close(tm, jm, 0)
    w = tm[0].weight.reshape(4, -1)
    assert tasp.check_sparsity(w, 'check_1d', 2, 4)


# -- optimizer wrappers -----------------------------------------------------------

def _small(mod, kw):
    return mod.Sequential(mod.Linear(4, 8, **kw), mod.Tanh(),
                          mod.Linear(8, 2, **kw))


def _steps(jm, tm, jstep, tstep, n=6, after=None):
    rng = np.random.RandomState(1)
    for i in range(n):
        x = _f32(rng.standard_normal((16, 4)))
        y = _f32(rng.standard_normal((16, 2)))
        jnn.functional.mse_loss(jm(paddle.to_tensor(x)),
                                paddle.to_tensor(y)).backward()
        jstep()
        tnn.functional.mse_loss(tm(torch.from_numpy(x)),
                                torch.from_numpy(y)).backward()
        tstep()
        if after is not None:
            after(i)


def test_lookahead_matches_jax(numpy_init):
    from paddle_tpu.incubate.optimizer import LookAhead as JLookAhead
    jm, tm = _pair(_small)
    jla = JLookAhead(paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm.parameters()),
        alpha=0.5, k=5)
    tla = tinc.LookAhead(tpt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()),
        alpha=0.5, k=5)
    _steps(jm, tm, lambda: (jla.step(), jla.clear_grad()),
           lambda: (tla.step(), tla.clear_grad()),
           after=lambda i: _assert_state_close(tm, jm))
    assert tla.state_dict()['steps'] == 6 and tla.get_lr() == 0.1


def test_lookahead_slow_weights_do_not_move_with_the_inner_step(numpy_init):
    _, tm = _pair(_small)
    start = [p.detach().clone() for p in tm.parameters()]
    ids = [id(p) for p in tm.parameters()]
    la = tinc.LookAhead(tpt.optimizer.SGD(learning_rate=0.5,
                                          parameters=tm.parameters()),
                        alpha=0.5, k=3)
    x, y = torch.randn(16, 4), torch.randn(16, 2)
    for step in range(3):
        tnn.functional.mse_loss(tm(x), y).backward()
        la.step()
        la.clear_grad()
        for p, s in zip(tm.parameters(), start):
            slow = la._slow[id(p)]
            if step < 2:
                # the inner SGD updated p in place; the slow copy did not
                assert torch.equal(slow, s)
                assert not torch.equal(p, s)
            else:
                assert torch.equal(slow, p.detach())
                assert slow.data_ptr() != p.data_ptr()
    assert [id(p) for p in tm.parameters()] == ids


def test_model_average_matches_jax(numpy_init):
    from paddle_tpu.incubate.optimizer import ModelAverage as JModelAverage
    jm, tm = _pair(_small)
    jopt = paddle.optimizer.SGD(learning_rate=0.2, parameters=jm.parameters())
    topt = tpt.optimizer.SGD(learning_rate=0.2, parameters=tm.parameters())
    jma = JModelAverage(0.15, parameters=jm.parameters())
    tma = tinc.ModelAverage(0.15, parameters=tm.parameters())
    _steps(jm, tm, lambda: (jopt.step(), jopt.clear_grad(), jma.step()),
           lambda: (topt.step(), topt.clear_grad(), tma.step()))
    current = {k: v.clone() for k, v in tm.state_dict().items()}
    with tma.apply(), jma.apply():
        _assert_state_close(tm, jm)
        assert not torch.equal(tm[0].weight, current['0.weight'])
    for k, v in tm.state_dict().items():
        assert torch.equal(v, current[k]), k
    _assert_state_close(tm, jm)


def test_ema_matches_jax_and_keeps_its_shadow(numpy_init):
    from paddle_tpu.incubate.optimizer import ExponentialMovingAverage as JEMA
    jm, tm = _pair(_small)
    jopt = paddle.optimizer.SGD(learning_rate=0.2, parameters=jm.parameters())
    topt = tpt.optimizer.SGD(learning_rate=0.2, parameters=tm.parameters())
    jema = JEMA(decay=0.8, parameters=jm.parameters())
    tema = tinc.optimizer.ExponentialMovingAverage(
        decay=0.8, parameters=tm.parameters())
    start = tm[0].weight.detach().clone()
    shadow = tema._shadow[id(tm[0].weight)]
    _steps(jm, tm, lambda: (jopt.step(), jopt.clear_grad(), jema.update()),
           lambda: (topt.step(), topt.clear_grad(), tema.update()),
           n=1)
    # after one update: 0.8 start + 0.2 current, not the parameter itself
    np.testing.assert_allclose(
        shadow.numpy(), (0.8 * start + 0.2 * tm[0].weight.detach()).numpy(),
        rtol=1e-6)
    _steps(jm, tm, lambda: (jopt.step(), jopt.clear_grad(), jema.update()),
           lambda: (topt.step(), topt.clear_grad(), tema.update()), n=5)
    current = tm[0].weight.detach().clone()
    tema.apply(need_restore=False)
    jema.apply(need_restore=False)
    _assert_state_close(tm, jm)
    tema.restore()
    jema.restore()
    assert torch.equal(tm[0].weight, current)
    _assert_state_close(tm, jm)


# -- auto_checkpoint -----------------------------------------------------------------

def _acp_setup(pkg, seed):
    rng = np.random.RandomState(seed)
    w = _f32(rng.standard_normal((4, 2)))
    if pkg == 'jax':
        model = jnn.Linear(4, 2)
        model.set_state_dict({'weight': paddle.to_tensor(w),
                              'bias': paddle.to_tensor(np.zeros(2,
                                                                np.float32))})
        opt = paddle.optimizer.Adam(learning_rate=0.05,
                                    parameters=model.parameters())
    else:
        model = tnn.Linear(4, 2, device='cpu')
        load_paddle_tpu_state(model, {'weight': w,
                                      'bias': np.zeros(2, np.float32)})
        opt = tpt.optimizer.Adam(learning_rate=0.05,
                                 parameters=model.parameters())
    return model, opt


def _train_one(pkg, model, opt):
    rng = np.random.RandomState(1)
    x, y = _f32(rng.randn(8, 4)), _f32(rng.randn(8, 2))
    if pkg == 'jax':
        loss = jnn.functional.mse_loss(model(paddle.to_tensor(x)),
                                       paddle.to_tensor(y))
    else:
        loss = tnn.functional.mse_loss(model(torch.from_numpy(x)),
                                       torch.from_numpy(y))
    loss.backward()
    opt.step()
    opt.clear_grad()


def _weight(pkg, model):
    return np.asarray(model.weight.numpy()) if pkg == 'jax' else \
        model.weight.detach().numpy().copy()


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_resume_after_crash(tmp_path, pkg, numpy_init):
    cls = JTrainEpochRange if pkg == 'jax' else TrainEpochRange
    ckpt = str(tmp_path)
    model, opt = _acp_setup(pkg, 0)
    seen = []
    for epoch in cls(10, 'job1', checkpoint_dir=ckpt, model=model,
                     optimizer=opt):
        seen.append(epoch)
        _train_one(pkg, model, opt)
        if epoch == 1:
            saved = _weight(pkg, model)
        if epoch == 2:
            break   # the crash skips epoch 2's save
    assert seen == [0, 1, 2]
    model2, opt2 = _acp_setup(pkg, 99)
    r = cls(5, 'job1', checkpoint_dir=ckpt, model=model2, optimizer=opt2)
    assert r.restored_epoch == 1
    np.testing.assert_array_equal(_weight(pkg, model2), saved)
    assert [e for e in r] == [2, 3, 4]
    model3, opt3 = _acp_setup(pkg, 5)
    assert [e for e in cls(5, 'job1', checkpoint_dir=ckpt, model=model3,
                           optimizer=opt3)] == []


def test_resumed_runs_match_jax(tmp_path, numpy_init):
    weights = {}
    for pkg, cls in (('jax', JTrainEpochRange), ('torch', TrainEpochRange)):
        ckpt = str(tmp_path / pkg)
        model, opt = _acp_setup(pkg, 3)
        for epoch in cls(4, 'job2', checkpoint_dir=ckpt, model=model,
                         optimizer=opt):
            _train_one(pkg, model, opt)
            if epoch == 1:
                break
        model, opt = _acp_setup(pkg, 7)
        r = cls(4, 'job2', checkpoint_dir=ckpt, model=model, optimizer=opt)
        assert r.restored_epoch == 0
        for _ in r:
            _train_one(pkg, model, opt)
        weights[pkg] = _weight(pkg, model)
        if pkg == 'torch':
            assert opt.state_dict()['step'] == 4
    np.testing.assert_allclose(weights['torch'], weights['jax'], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize('pkg', ['jax', 'torch'])
def test_keep_last_and_torn_snapshot(tmp_path, pkg, numpy_init):
    cls = JTrainEpochRange if pkg == 'jax' else TrainEpochRange
    model, opt = _acp_setup(pkg, 0)
    for epoch in cls(8, 'job3', checkpoint_dir=str(tmp_path), model=model,
                     optimizer=opt, keep_last=2):
        _train_one(pkg, model, opt)
        if epoch == 6:
            at6 = _weight(pkg, model)
    root = os.path.join(str(tmp_path), 'job3')
    assert sorted(os.listdir(root)) == [
        'epoch_6.ckpt', 'epoch_6.ckpt.manifest', 'epoch_7.ckpt',
        'epoch_7.ckpt.manifest']
    path = os.path.join(root, 'epoch_7.ckpt')
    with open(path, 'rb') as f:
        data = f.read()
    with open(path, 'wb') as f:
        f.write(data[:len(data) // 2])     # a writer torn mid-save
    model2, opt2 = _acp_setup(pkg, 1)
    r = cls(8, 'job3', checkpoint_dir=str(tmp_path), model=model2,
            optimizer=opt2, keep_last=2)
    assert r.skipped_corrupt == [7] and r.restored_epoch == 6
    np.testing.assert_array_equal(_weight(pkg, model2), at6)
    assert [e for e in r] == [7]


# -- ops and namespaces ----------------------------------------------------------------

@pytest.mark.parametrize('op', ['sum', 'mean', 'max', 'min'])
def test_segment_ops_with_empty_segments(op):
    rng = np.random.RandomState(2)
    data = _f32(rng.standard_normal((6, 3)))
    ids = np.asarray([0, 0, 2, 2, 2, 4], np.int64)
    cot = _f32(rng.standard_normal((5, 3)))
    jx = paddle.to_tensor(data, stop_gradient=False)
    jout = getattr(jinc, 'segment_' + op)(jx, paddle.to_tensor(ids))
    (jout * paddle.to_tensor(cot)).sum().backward()
    tx = torch.tensor(data, requires_grad=True)
    tout = getattr(tinc, 'segment_' + op)(tx, torch.from_numpy(ids))
    (tout * torch.from_numpy(cot)).sum().backward()
    assert tuple(tout.shape) == (5, 3)
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=TOL, atol=TOL)
    assert not tout[1].any() and not tout[3].any()   # empty segments: 0
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=TOL,
                               atol=TOL)


def test_vjp_and_jvp_match_jax():
    rng = np.random.RandomState(3)
    a, b = _f32(rng.standard_normal(5)), _f32(rng.standard_normal(5))
    v = _f32(rng.standard_normal(5))
    jout, jgrads = jinc.autograd.vjp(lambda x, y: paddle.tanh(x) * y,
                                     [paddle.to_tensor(a),
                                      paddle.to_tensor(b)],
                                     paddle.to_tensor(v))
    tout, tgrads = tinc.autograd.vjp(lambda x, y: torch.tanh(x) * y,
                                     [torch.from_numpy(a),
                                      torch.from_numpy(b)],
                                     torch.from_numpy(v))
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), rtol=TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=TOL,
                                   atol=TOL)
    _, ones = tinc.autograd.vjp(lambda x: (x * x).sum(),
                                torch.from_numpy(a))
    np.testing.assert_allclose(ones[0].numpy(), 2 * a, rtol=TOL)
    jout, jt = jinc.autograd.jvp(lambda x, y: paddle.sin(x) * y,
                                 [paddle.to_tensor(a), paddle.to_tensor(b)],
                                 paddle.to_tensor(v))
    tout, tt = tinc.autograd.jvp(lambda x, y: torch.sin(x) * y,
                                 [torch.from_numpy(a), torch.from_numpy(b)],
                                 torch.from_numpy(v))
    np.testing.assert_allclose(tout.numpy(), jout.numpy(), rtol=TOL)
    # every input takes the same tangent v, as in the JAX package
    np.testing.assert_allclose(tt.numpy(), jt.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tt.numpy(), np.cos(a) * b * v + np.sin(a) * v,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_softmax_mask_fuse_upper_triangle(dtype):
    x = _f32(np.random.RandomState(4).standard_normal((2, 3, 7, 7)) * 4)
    jout = jinc.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(x).astype(dtype))
    tout = tinc.softmax_mask_fuse_upper_triangle(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tout.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype('float32').numpy()),
                               rtol=TOL, atol=TOL)
    assert not torch.triu(tout.float(), diagonal=1).any()


def test_recompute_and_the_namespaces():
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    assert tinc.recompute is recompute
    lin = tnn.Linear(4, 4, device='cpu')
    x = torch.randn(3, 4, requires_grad=True)
    recompute(lambda a: torch.tanh(lin(a)), x).sum().backward()
    g = x.grad.clone()
    x.grad = None
    torch.tanh(lin(x)).sum().backward()
    assert torch.equal(x.grad, g)
    assert tinc.nn.FusedTransformerEncoderLayer is \
        tnn.TransformerEncoderLayer
    assert tinc.nn.FusedMultiHeadAttention is tnn.MultiHeadAttention
    assert tinc.LookAhead is tinc.optimizer.LookAhead
    assert callable(tinc.auto_checkpoint.train_epoch_range)
    public = {n for n in dir(jinc) if not n.startswith('_')}
    missing = sorted(n for n in public if not hasattr(tinc, n))
    assert missing == [], missing
    for mod in ('asp', 'optimizer', 'auto_checkpoint'):
        jm, tm = getattr(jinc, mod), getattr(tinc, mod)
        assert sorted(tm.__all__) == sorted(jm.__all__)
        assert all(hasattr(tm, n) for n in tm.__all__)
