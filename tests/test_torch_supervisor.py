"""The port's checkpoint / resume plane: TrainingSupervisor inside
Model.fit, CheckpointManager, AsyncCheckpointer and ResumeCursor.

A killed run resumed by a fresh Model after a wrong np.random.seed must
consume the uninterrupted run's batch order (the datasets' access logs,
which the JAX package's fit produces too under the same seed), reproduce
its per-step losses and end on bit-identical parameters. The toy network
(Linear 4-8, relu, Linear 8-1 of the port, MSE, Adam) keeps each fit to
milliseconds on the CPU.
"""
import os
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.supervisor import (PreemptionWatcher,
                                                     ResumeCursor,
                                                     TrainingSupervisor)
from paddle_tpu_torch.framework import io_save
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.hapi.callbacks import Callback
from paddle_tpu_torch.testing import chaos


class _Rows:
    def __init__(self, n=32):
        rng = np.random.RandomState(7)
        self.x = rng.randn(n, 4).astype(np.float32)
        self.y = rng.randn(n, 1).astype(np.float32)
        self.accessed = []

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        self.accessed.append(int(i))
        return self.x[i], self.y[i]


class TRows(_Rows, tpt.io.Dataset):
    pass


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = trandom.seed(1234)
        self.fc1 = tpt.nn.Linear(4, 8, device='cpu', generator=gen)
        self.fc2 = tpt.nn.Linear(8, 1, device='cpu', generator=gen)

    def forward(self, x):
        # dropout with generator=None draws from torch's default CPU
        # generator: the cursor's RNG capture must restore it
        return self.fc2(tpt.nn.functional.dropout(
            torch.relu(self.fc1(x)), 0.25, training=self.training))


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _build():
    np.random.seed(99)
    torch.manual_seed(5)
    net = _Net()
    m = tpt.Model(net)
    m.prepare(optimizer=tpt.optimizer.Adam(learning_rate=0.01,
                                           parameters=net.parameters()),
              loss=_mse)
    return m


class _Losses(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs['loss'][0]))


class _KillAt(Callback):
    """Simulated hard kill: raises out of the fit loop at the Nth
    completed batch, before the supervisor's on_step checkpointing."""

    def __init__(self, at):
        super().__init__()
        self.at = at
        self.seen = 0

    def on_train_batch_end(self, step, logs=None):
        self.seen += 1
        if self.seen == self.at:
            raise KeyboardInterrupt('simulated kill at batch %d' % self.at)


def _fit(m, data, **kw):
    return m.fit(data, batch_size=4, epochs=3, shuffle=True, verbose=0,
                 **kw)


def _params(m):
    return {k: v.clone() for k, v in m.network.state_dict().items()}


@pytest.fixture(scope='module')
def reference():
    """The uninterrupted seeded 3-epoch run: losses, access log and final
    parameters."""
    m, data, losses = _build(), TRows(), _Losses()
    _fit(m, data, callbacks=[losses])
    return {'params': _params(m), 'accessed': data.accessed,
            'losses': losses.losses}


def _assert_bit_identical(got, ref):
    for k in ref:
        assert torch.equal(ref[k], got[k]), k


def test_reference_batch_order_matches_jax(reference):
    """The JAX package's fit walks the same shuffle under the same seed."""
    class JRows(_Rows, paddle.io.Dataset):
        pass

    class Noop(JCallback):
        pass

    paddle.seed(0)
    np.random.seed(99)
    net = paddle.nn.Linear(4, 1)
    m = paddle.Model(net)
    m.prepare(optimizer=paddle.optimizer.SGD(learning_rate=0.0,
                                             parameters=net.parameters()),
              loss=paddle.nn.MSELoss())
    data = JRows()
    m.fit(data, batch_size=4, epochs=3, shuffle=True, verbose=0,
          callbacks=[Noop()])
    assert data.accessed == reference['accessed']


def test_killed_run_resumes_bit_identical(tmp_path, reference):
    d = str(tmp_path / 'ckpt')
    m1 = _build()
    sup1 = TrainingSupervisor(d, save_every_steps=5)
    with pytest.raises(KeyboardInterrupt):
        _fit(m1, TRows(), supervisor=sup1, callbacks=[_KillAt(13)])
    assert sup1.last_saved_step == 10        # epoch 1, step 2

    m2 = _build()
    np.random.seed(555)   # wrong seed on purpose: the cursor must win
    torch.manual_seed(555)
    data, losses = TRows(), _Losses()
    sup2 = TrainingSupervisor(d, save_every_steps=5)
    _fit(m2, data, supervisor=sup2, callbacks=[losses])
    per_epoch = len(data)
    # the resumed epoch is re-read from its top (the trained prefix is
    # drained), then training continues at step 10 of 24
    assert data.accessed == reference['accessed'][per_epoch:]
    assert losses.losses == reference['losses'][10:]
    _assert_bit_identical(_params(m2), reference['params'])


@pytest.mark.parametrize('point', ['pre_rename', 'pre_manifest'])
def test_killed_mid_checkpoint_falls_back(tmp_path, point, reference):
    """The writer dies inside the step-8 checkpoint (before the rename, and
    between rename and manifest). The restart falls back to the intact
    step-4 snapshot and still reaches the bit-identical final state."""
    d = str(tmp_path / 'ckpt')
    m1 = _build()
    sup1 = TrainingSupervisor(d, save_every_steps=4)
    with chaos.crash_io_save(point, path_substr='step_8') as fault:
        with pytest.raises(chaos.WriterKilled):
            _fit(m1, TRows(), supervisor=sup1)
    assert fault.fired == 1
    assert os.path.exists(os.path.join(d, 'step_8.ckpt')) == \
        (point == 'pre_manifest')
    m2 = _build()
    sup2 = TrainingSupervisor(d, save_every_steps=4)
    assert sup2.restore(m2).global_step == 4   # torn step 8 skipped
    _fit(m2, TRows(), supervisor=sup2)
    _assert_bit_identical(_params(m2), reference['params'])


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path, reference):
    d = str(tmp_path / 'ckpt')

    class Sigterm(Callback):
        seen = 0

        def on_train_batch_end(self, step, logs=None):
            self.seen += 1
            if self.seen == 7:
                os.kill(os.getpid(), signal.SIGTERM)

    m1 = _build()
    with PreemptionWatcher() as watcher:
        sup1 = TrainingSupervisor(d, watcher=watcher)
        _fit(m1, TRows(), supervisor=sup1, callbacks=[Sigterm()])
    assert m1.stop_training
    assert sup1.last_saved_step == 7          # urgent, not periodic
    m2 = _build()
    _fit(m2, TRows(), supervisor=TrainingSupervisor(d))
    _assert_bit_identical(_params(m2), reference['params'])


def test_shard_supervisor_is_not_ported(tmp_path):
    """The shard supervisor is ported now: TrainingSupervisor takes one and
    makes every periodic checkpoint of a fit a snapshot barrier of its
    shards (the urgent ones are not). The name is the test's from before
    the port of the shard supervisor."""
    class Shards:
        barriers = 0

        def snapshot_all(self):
            self.barriers += 1

    shards = Shards()
    sup = TrainingSupervisor(str(tmp_path), save_every_steps=6,
                             shard_supervisor=shards)
    assert sup.shards is shards
    _fit(_build(), TRows(), supervisor=sup)     # 24 steps
    assert shards.barriers == 4
    off = TrainingSupervisor(str(tmp_path / 'off'), save_every_steps=6,
                             shard_supervisor=shards, snapshot_shards=False)
    _fit(_build(), TRows(), supervisor=off)
    assert shards.barriers == 4


def test_checkpoint_snapshots_before_the_next_step_mutates(tmp_path):
    """save() copies every tensor to the CPU before it returns: parameters
    and moments changed in place right after it are not in the file."""
    p = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
    moment = torch.full((6,), 0.5)
    state = {'w': p, 'opt': {'moment1': moment, 'step': 3}}
    ck = ckpt.AsyncCheckpointer()
    gate = threading.Event()
    real_save = io_save.save

    def slow_save(obj, path, **kw):
        # the writer thread writes only after the caller has mutated
        gate.wait(10)
        return real_save(obj, path, **kw)

    io_save.save = slow_save
    try:
        ck.save(str(tmp_path / 'snap'), state)
        with torch.no_grad():
            p.add_(100.0)
            moment.mul_(0.0)
        gate.set()
        ck.wait_until_finished()
    finally:
        io_save.save = real_save
    back = ck.restore(str(tmp_path / 'snap'))
    assert torch.equal(back['w'], torch.arange(6, dtype=torch.float32))
    assert torch.equal(back['opt']['moment1'], torch.full((6,), 0.5))
    assert back['opt']['step'] == 3
    # save_checkpoint / load_checkpoint ride the same writer
    ckpt.save_checkpoint({'a': torch.ones(2)}, str(tmp_path / 'b'),
                         asynchronous=False)
    assert torch.equal(ckpt.load_checkpoint(str(tmp_path / 'b'))['a'],
                       torch.ones(2))


def test_async_checkpointer_reraises_writer_error_on_wait(tmp_path):
    ck = ckpt.AsyncCheckpointer()
    blocker = tmp_path / 'file'
    blocker.write_text('x')
    # a path under a regular file cannot be created: the writer fails
    ck.save(str(blocker / 'sub' / 'ckpt'), {'a': torch.ones(3)})
    with pytest.raises(OSError):
        ck.wait_until_finished()
    ck.wait_until_finished()                  # the error is reported once


def test_checkpoint_manager_keeps_the_last_n(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep_last=2)
    for step in (1, 2, 3):
        mgr.save(step, {'step': step, 'w': torch.full((2,), step)})
    assert mgr.steps() == [2, 3]
    step, state = mgr.restore_latest()
    assert step == 3 and torch.equal(state['w'], torch.full((2,), 3))
    chaos.truncate_file(os.path.join(str(tmp_path), 'step_3.ckpt'))
    assert mgr.restore_latest()[0] == 2
    with pytest.raises(ValueError, match='keep_last'):
        ckpt.CheckpointManager(str(tmp_path), keep_last=0)


def test_resume_cursor_roundtrips_through_io_save(tmp_path):
    np.random.seed(1)
    torch.manual_seed(2)
    np.random.rand(3)
    torch.rand(3)
    cur = ResumeCursor(epoch=2, step=5, global_step=21,
                       epoch_rng=ResumeCursor.capture_rng(),
                       rng=ResumeCursor.capture_rng(),
                       ingest={'records': 7})
    want_np, want_torch = np.random.rand(4), torch.rand(4)
    path = str(tmp_path / 'cursor.ckpt')
    io_save.save(cur.to_state(), path)
    back = ResumeCursor.from_state(io_save.load(path))
    assert (back.epoch, back.step, back.global_step) == (2, 5, 21)
    assert back.ingest == {'records': 7}
    assert repr(back) == 'ResumeCursor(epoch=2, step=5, global_step=21)'
    ResumeCursor.restore_rng(back.rng)
    assert np.array_equal(np.random.rand(4), want_np)
    assert torch.equal(torch.rand(4), want_torch)
