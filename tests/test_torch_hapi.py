"""The port's training shell (hapi.Model, callbacks, summary / flops)
against the JAX package's.

The slice as a whole: a 2-layer GPT (hidden 32, vocab 128, seq 16, f32)
built in JAX and carried across with load_paddle_tpu_state, trained by
both packages' Model.fit with Adam under one np.random.seed, with shuffle,
for 2 epochs. The batch order (the datasets' access logs) must be equal,
the per-step losses within 1e-5, evaluate()'s loss within 1e-5 and its
Accuracy equal, and the parameters within 2 lr (Adam's first steps move a
parameter by about lr whatever its gradient, so where the exact gradient
is 0 the two sides may move it opposite ways). predict() from the JAX
network's trained weights, carried across, agrees within 1e-5. Seq 16
is below the flash gate, so no Pallas kernel runs on the JAX side.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.text.models import gpt as tgpt

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_position_embeddings=16, dropout=0.0)
SEQ, N, BATCH, LR = 16, 12, 4, 1e-3


class _Tokens:
    """Seeded (ids, next-token labels) rows; every index read is logged."""

    def __init__(self, dtype, n=N, seed=0):
        rng = np.random.RandomState(seed)
        toks = rng.randint(0, CFG['vocab_size'], (n, SEQ + 1))
        self.ids = toks[:, :-1].astype(dtype)
        self.labels = toks[:, 1:].astype(dtype)
        self.accessed = []

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        self.accessed.append(int(i))
        return self.ids[i], self.labels[i]


def _datasets():
    """The same rows as a JAX-package Dataset (int32) and a port Dataset
    (int64)."""
    class J(_Tokens, paddle.io.Dataset):
        pass

    class T(_Tokens, tpt.io.Dataset):
        pass
    return J(np.int32), T(np.int64)


class _Losses:
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs['loss']).reshape(-1)[0]))


class JLosses(_Losses, jcb.Callback):
    def __init__(self):
        jcb.Callback.__init__(self)
        _Losses.__init__(self)


class TLosses(_Losses, tcb.Callback):
    def __init__(self):
        tcb.Callback.__init__(self)
        _Losses.__init__(self)


def _models(metrics=True):
    paddle.seed(11)
    jm = JGPT(JConfig(**CFG))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    jmodel = paddle.Model(jm)
    jmodel.prepare(optimizer=paddle.optimizer.Adam(
        learning_rate=LR, parameters=jm.parameters()), loss=jm.loss,
        metrics=paddle.metric.Accuracy() if metrics else None)
    tmodel = tpt.Model(tm)
    tmodel.prepare(optimizer=tpt.optimizer.Adam(
        learning_rate=LR, parameters=tm.parameters()), loss=tm.loss,
        metrics=tpt.metric.Accuracy() if metrics else None)
    return jmodel, tmodel


@pytest.fixture(scope='module')
def fitted():
    jmodel, tmodel = _models(metrics=False)
    jdata, tdata = _datasets()
    jl, tl = JLosses(), TLosses()
    np.random.seed(2024)
    jmodel.fit(jdata, batch_size=BATCH, epochs=2, shuffle=True, verbose=0,
               callbacks=[jl])
    np.random.seed(2024)
    tmodel.fit(tdata, batch_size=BATCH, epochs=2, shuffle=True, verbose=0,
               callbacks=[tl])
    return jmodel, tmodel, jdata, tdata, jl.losses, tl.losses


def test_fit_matches_jax_losses_and_batch_order(fitted):
    jmodel, tmodel, jdata, tdata, jlosses, tlosses = fitted
    assert tdata.accessed == jdata.accessed
    assert len(tdata.accessed) == 2 * N
    assert sorted(tdata.accessed[:N]) == list(range(N))
    assert tdata.accessed[:N] != list(range(N))      # it did shuffle
    assert len(tlosses) == len(jlosses) == 2 * N // BATCH
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=1e-5)
    assert tlosses[-1] < tlosses[0]
    jstate = {k: np.asarray(v.numpy())
              for k, v in jmodel.network.state_dict().items()}
    for k, v in tmodel.network.state_dict().items():
        assert np.abs(v.numpy() - jstate[k]).max() <= 2 * LR + 1e-6, k
    # the fit's StepTimeline stays readable: one step per batch
    assert tmodel.last_timeline.steps == len(tlosses)


def test_evaluate_and_predict_match_jax(fitted):
    jmodel, tmodel, _, _, _, _ = fitted
    jmodel._metrics = [paddle.metric.Accuracy(topk=(1, 5))]
    tmodel._metrics = [tpt.metric.Accuracy(topk=(1, 5))]
    jdata, tdata = _datasets()
    jev = jmodel.evaluate(jdata, batch_size=BATCH, verbose=0)
    tev = tmodel.evaluate(tdata, batch_size=BATCH, verbose=0)
    assert sorted(tev) == sorted(jev) == ['acc_top1', 'acc_top5', 'loss']
    assert abs(tev['loss'] - jev['loss']) <= 1e-5
    assert tev['acc_top1'] == jev['acc_top1']
    assert tev['acc_top5'] == jev['acc_top5']
    # predict() from the same weights: the JAX network's, carried across
    # (the trained weights themselves differ by Adam's noise, up to 2 lr)
    jp = jmodel.predict(jdata, batch_size=BATCH, stack_outputs=True)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {
        k: np.asarray(v.numpy())
        for k, v in jmodel.network.state_dict().items()})
    tp = tpt.Model(tm).predict(tdata, batch_size=BATCH, stack_outputs=True)
    assert tp[0].shape == jp[0].shape == (N, SEQ, CFG['vocab_size'])
    np.testing.assert_allclose(tp[0], jp[0], rtol=0, atol=1e-5)


def test_fit_with_workers_and_eval_data(tmp_path):
    """num_workers=2 gives the same batches (and losses) as num_workers=0;
    eval_data runs evaluate() at each epoch end; save / load round-trip
    the network and the optimizer through io_save."""
    runs = []
    for workers in (0, 2):
        _, tmodel = _models(metrics=False)
        _, tdata = _datasets()
        tl = TLosses()
        np.random.seed(7)
        tmodel.fit(tdata, eval_data=_datasets()[1], batch_size=BATCH,
                   epochs=1, shuffle=True, verbose=0, num_workers=workers,
                   callbacks=[tl])
        runs.append((tl.losses, tmodel))
    assert runs[0][0] == runs[1][0]
    tmodel = runs[1][1]
    path = str(tmp_path / 'm')
    tmodel.save(path)
    _, other = _models(metrics=False)
    other.load(path)
    for (k, a), b in zip(tmodel.network.state_dict().items(),
                         other.network.state_dict().values()):
        assert torch.equal(a, b), k
    assert other._optimizer.state_dict()['step'] == \
        tmodel._optimizer.state_dict()['step']
    # training=False exports through jit.save (no input spec given to
    # the Model: the architecture and the weights, no exported program)
    tmodel.save(path, training=False)
    loaded = tpt.jit.load(path, device='cpu')
    ids = torch.from_numpy(tdata.ids[:2])
    tmodel.network.eval()
    assert torch.equal(loaded(ids), tmodel.network(ids))
    # summary_perf prices the step on fake tensors: the parameters and
    # the optimizer's state are left as they were
    before = {k: v.clone() for k, v in tmodel.network.state_dict().items()}
    slots = dict(tmodel._optimizer._slots)
    labels = torch.from_numpy(tdata.labels[:2])
    est = tmodel.summary_perf(ids, labels, step_seconds=1.0)
    assert est['flops'] > 0 and est['bytes_accessed'] > 0
    assert est['mfu_est'] == est['flops'] / est['peak_flops']
    assert all(torch.equal(v, tmodel.network.state_dict()[k])
               for k, v in before.items())
    assert tmodel._optimizer._slots == slots


# ---- the narrowed fallback ---------------------------------------------

class _Boom(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tpt.nn.Linear(4, 1, device='cpu')

    def forward(self, x):
        raise RuntimeError('kernel fault inside the step')


class _Rows(tpt.io.Dataset):
    def __init__(self, n=8):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 4).astype(np.float32)
        self.y = rng.randn(n, 1).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _mse(out, y):
    return ((out - y) ** 2).mean()


def test_error_inside_the_step_propagates_out_of_fit():
    net = _Boom()
    model = tpt.Model(net)
    model.prepare(tpt.optimizer.SGD(learning_rate=0.1,
                                    parameters=net.parameters()), _mse)
    with pytest.raises(RuntimeError, match='kernel fault'):
        model.fit(_Rows(), batch_size=4, epochs=1, verbose=0)


def test_only_trainstep_refusal_falls_back_to_eager(monkeypatch):
    """TrainStep's NotImplementedError for an option it refuses sends the
    batch to the eager loop, which computes the same update."""
    from paddle_tpu_torch.framework import functional as fm

    def build(refuse):
        torch.manual_seed(0)
        net = tpt.nn.Linear(4, 1, device='cpu',
                            generator=tpt.framework.random.seed(3))
        model = tpt.Model(net)
        model.prepare(tpt.optimizer.SGD(learning_rate=0.1,
                                        parameters=net.parameters()), _mse)
        return model

    class Refusing(fm.TrainStep):
        def __init__(self, *a, **k):
            raise NotImplementedError('TrainStep(mesh=...) is not ported')

    ref = build(False)
    np.random.seed(1)
    ref.fit(_Rows(), batch_size=4, epochs=1, verbose=0)
    monkeypatch.setattr(fm, 'TrainStep', Refusing)
    eager = build(True)
    np.random.seed(1)
    eager.fit(_Rows(), batch_size=4, epochs=1, verbose=0)
    for a, b in zip(ref.network.parameters(), eager.network.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-6)


# ---- callbacks against the JAX package's at the same logs ------------------

class _FakeOpt:
    def __init__(self, lr):
        self.lr = lr

    def get_lr(self):
        return self.lr

    def set_lr(self, v):
        self.lr = v


class _FakeModel:
    def __init__(self, opt=None):
        self.stop_training = False
        self._optimizer = opt
        self.saved = []

    def save(self, path):
        self.saved.append(path)


EVAL_LOSSES = [1.0, 0.9, 0.95, 0.93, 0.96, 0.99, 0.5, 0.7, 0.8, 0.9]


@pytest.mark.parametrize('kw', [dict(patience=2),
                                dict(patience=1, min_delta=0.05),
                                dict(monitor='acc', patience=2)])
def test_early_stopping_matches_jax(kw):
    trace = {}
    for name, mod in (('jax', jcb), ('port', tcb)):
        cb = mod.EarlyStopping(**kw)
        m = _FakeModel()
        cb.set_model(m)
        out = []
        for v in EVAL_LOSSES:
            cb.on_eval_end({'loss': v, 'acc': 1 - v})
            out.append((m.stop_training, cb.best, cb.wait))
        trace[name] = out
    assert trace['port'] == trace['jax']


@pytest.mark.parametrize('kw', [dict(patience=1, factor=0.5),
                                dict(patience=2, factor=0.1, cooldown=1,
                                     min_lr=1e-4)])
def test_reduce_lr_on_plateau_matches_jax(kw):
    trace = {}
    for name, mod in (('jax', jcb), ('port', tcb)):
        opt = _FakeOpt(0.01)
        cb = mod.ReduceLROnPlateau(verbose=0, **kw)
        cb.set_model(_FakeModel(opt))
        out = []
        for v in EVAL_LOSSES:
            cb.on_eval_end({'loss': v})
            out.append((opt.lr, cb.wait, cb.cooldown_counter))
        trace[name] = out
    assert trace['port'] == trace['jax']


@pytest.mark.parametrize('by', ['step', 'epoch'])
def test_lr_scheduler_callback_matches_jax(by):
    lrs = {}
    for name, pkg, mod in (('jax', paddle, jcb), ('port', tpt, tcb)):
        sched = pkg.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                           gamma=0.5)
        model = _FakeModel(pkg.optimizer.SGD(learning_rate=sched))
        cb = mod.LRScheduler(by_step=by == 'step', by_epoch=by == 'epoch')
        cb.set_model(model)
        out = []
        for epoch in range(3):
            for step in range(3):
                cb.on_train_batch_end(step)
                out.append(model._optimizer.get_lr())
            cb.on_epoch_end(epoch)
            out.append(model._optimizer.get_lr())
        lrs[name] = out
    assert lrs['port'] == lrs['jax']


def test_model_checkpoint_files_match_jax(tmp_path):
    paths = {}
    for name, mod in (('jax', jcb), ('port', tcb)):
        d = str(tmp_path / name)
        cb = mod.ModelCheckpoint(save_freq=2, save_dir=d)
        m = _FakeModel()
        cb.set_model(m)
        for epoch in range(5):
            cb.on_epoch_end(epoch)
        cb.on_train_end()
        paths[name] = [os.path.relpath(p, d) for p in m.saved]
    assert paths['port'] == paths['jax'] == ['0', '2', '4', 'final']


def test_telemetry_callback_families_match_jax():
    from paddle_tpu.monitor import MetricRegistry as JReg
    from paddle_tpu_torch.monitor import MetricRegistry as TReg

    names = {}
    for name, mod, reg in (('jax', jcb, JReg()), ('port', tcb, TReg())):
        ticks = iter([0.0, 0.25, 1.0, 1.5])
        cb = mod.TelemetryCallback(registry=reg, sample_every=1,
                                   clock=lambda: next(ticks))
        cb.set_params({'batch_size': 8})
        cb.on_epoch_begin(0)
        for step in range(2):
            cb.on_train_batch_begin(step)
            cb.on_train_batch_end(step, {'loss': np.array([2.0 - step])})
        cb.on_train_end()
        names[name] = {fam.name for fam in reg.collect()}
        assert reg.get('train_steps_total').value() == 2
        assert reg.get('train_examples_total').value() == 16
        assert reg.get('train_loss').value() == 1.0
    shared = {'train_steps_total', 'train_examples_total',
              'train_examples_per_second', 'train_loss',
              'train_step_duration_seconds', 'train_epoch',
              'process_resident_bytes', 'runtime_samples_total'}
    assert shared <= names['jax'] and shared <= names['port']


# ---- summary / flops -------------------------------------------------------

def test_summary_and_flops_match_jax(capsys):
    paddle.seed(5)
    jm = JGPT(JConfig(**CFG))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**CFG), device='cpu')
    jsum = paddle.hapi.summary(jm, (2, SEQ), dtypes='int32')
    tsum = tpt.hapi.summary(tm, (2, SEQ), dtypes='int64')
    assert tsum == jsum
    assert tsum['total_params'] == tm.num_params()
    assert tpt.hapi.flops(tm, [2, SEQ]) == paddle.hapi.flops(jm, [2, SEQ])
    frozen = tpt.nn.Linear(4, 8, tpt.ParamAttr(trainable=False),
                           device='cpu')
    jfrozen = paddle.nn.Linear(4, 8, paddle.ParamAttr(trainable=False))
    assert tpt.hapi.summary(frozen) == paddle.hapi.summary(jfrozen) == \
        {'total_params': 40, 'trainable_params': 8}
    out = capsys.readouterr().out
    assert 'Total params' in out
