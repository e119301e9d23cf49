"""hapi Model (counterpart of paddle_tpu/hapi/model.py; reference:
python/paddle/hapi/model.py:878 Model, fit :1523).

train_batch runs the port's TrainStep (framework/functional.py): eager
forward, backward and update on the network's device. Batches are moved to
the device of the network's parameters (non_blocking) inside train_batch,
eval_batch and predict_batch, so a DataLoader's CPU tensors and an
IngestPipeline's device-staged ones both work. A network without parameters
or buffers runs on the current device (framework.device), never on a
CPU chosen for it.

Differences from the JAX package, each on purpose:
- No hidden fallback. The JAX train_batch catches every exception from its
  jitted step and reruns the batch eagerly; here that would rerun a failed
  CUDA step and hide a kernel fault. The port falls back to the eager loop
  only on the NotImplementedError that TrainStep raises when it is built
  with an option it refuses, and re-raises everything else. prepare()
  passes TrainStep no such option: it passes no pp_state, as the JAX
  Model's prepare() passes none (a pipeline trains through fleet or
  PipelineParallel.train_batch), so the eager loop waits for an option
  prepare() would pass and TrainStep refuse.
- fit wires a CompileWatchdog(owner=self) beside its StepTimeline
  (data_wait / host_dispatch / device_block), with the warmup barrier
  after the first eval pass as in the JAX package; the eager step
  compiles nothing, so it counts 0 unless a to_static network compiles.
  The last fit's timeline and watchdog stay readable as `last_timeline`
  and `last_watchdog`.
- save(training=False) exports through jit.save with prepare()'s inputs
  as the input spec. summary_perf prices the TrainStep's step on fake
  tensors (monitor/perf/costmodel.py) instead of reading XLA's cost
  analysis; nothing runs on the device.
- prepare(amp_configs=...) is accepted and ignored, as in the JAX package.
"""
import contextlib
import os

import numpy as np
import torch

from ..distributed.supervisor import Preempted
from ..framework import device as device_mod
from ..framework import functional as func_mod
from ..framework import io_save
from ..metric import _np
from .callbacks import config_callbacks

__all__ = ['Model']


def _to_device(obj, device):
    """Tensors (and numpy arrays) of a batch tree moved to `device`."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if torch.is_tensor(obj):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


def network_device(network):
    """The device of the network's parameters (or buffers); a network
    with neither runs on the current device, which raises when that is
    CUDA and CUDA is missing."""
    for t in network.parameters():
        return t.device
    for t in network.buffers():
        return t.device
    return device_mod.resolve()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics = []
        self._train_step = None
        self._perf_timeline = None    # StepTimeline while fit() runs
        self.last_timeline = None     # the last fit()'s StepTimeline
        self.last_watchdog = None     # the last fit()'s CompileWatchdog
        self.stop_training = False
        self.mode = 'train'

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        self._train_step = None
        return self

    def _ensure_train_step(self):
        if self._train_step is None:
            loss_fn = self._loss
            if not callable(loss_fn):
                raise ValueError("call prepare(loss=...) first")
            self._train_step = func_mod.TrainStep(self.network, loss_fn,
                                                  self._optimizer)
        return self._train_step

    def _device(self):
        return network_device(self.network)

    # -- batch-level API ----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        dev = self._device()
        inputs = _to_device(inputs, dev)
        labels = _to_device(labels, dev)
        tl = self._perf_timeline
        dispatch = tl.phase('host_dispatch') if tl is not None \
            else contextlib.nullcontext()
        block = tl.phase('device_block') if tl is not None \
            else contextlib.nullcontext()
        try:
            step = self._ensure_train_step()
        except NotImplementedError:
            # TrainStep refuses the configuration: the eager loop computes
            # the same update. Anything raised by a step itself propagates.
            step = None
        with dispatch:
            if step is not None:
                loss = step(inputs, labels)
            else:
                loss = self._eager_train_batch(inputs, labels)
        with block:
            # blocks until the device result is ready — the
            # dispatch-to-materialize gap is the device-bound phase
            loss_np = _np(loss)
        metrics = self._update_metrics(inputs, labels)
        return [loss_np] if not metrics else ([loss_np], metrics)

    def _eager_train_batch(self, inputs, labels):
        outs = _as_list(self.network(*_as_list(inputs)))
        loss = self._loss(*outs, *_as_list(labels))
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return loss.detach()

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        ins = _as_list(_to_device(inputs, dev))
        labs = _as_list(_to_device(labels, dev))
        outs_l = _as_list(self.network(*ins))
        loss = self._loss(*outs_l, *labs) if self._loss else None
        metrics = []
        for m in self._metrics:
            res = m.compute(*outs_l, *labs)
            m.update(res if not isinstance(res, (list, tuple)) else res[0],
                     *labs)
            metrics.append(m.accumulate())
        out = [_np(loss)] if loss is not None else []
        return (out, metrics) if metrics else out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        ins = _as_list(_to_device(inputs, self._device()))
        return [_np(o) for o in _as_list(self.network(*ins))]

    def _update_metrics(self, inputs, labels):
        if not self._metrics:
            return []
        with torch.no_grad():
            outs_l = _as_list(self.network(*_as_list(inputs)))
            labs = _as_list(labels)
            accum = []
            for m in self._metrics:
                res = m.compute(*outs_l, *labs)
                m.update(res if not isinstance(res, (list, tuple)) else res[0])
                accum.append(m.accumulate())
        return accum

    # -- loop API -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, supervisor=None):
        from ..io import DataLoader, Dataset
        from ..monitor.perf import CompileWatchdog, StepTimeline
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose, batch_size=batch_size,
                                metrics=[m.name() for m in self._metrics])
        cbks.on_train_begin()
        self.stop_training = False
        wd = CompileWatchdog(owner=self, name='Model.fit')
        self.last_watchdog = wd
        tl = StepTimeline()
        self._perf_timeline = tl
        self.last_timeline = tl
        # everything up to and including the FIRST eval pass may
        # legitimately compile; compiles after that barrier are
        # steady-state recompiles
        warmup_epoch = 0 if eval_loader is None \
            else min(eval_freq, epochs) - 1
        it = 0
        cursor = None
        if supervisor is not None:
            # elastic resume: the cursor restores params and optimizer and
            # says how much completed work to skip deterministically
            cursor = supervisor.restore(self)
            if cursor is not None:
                it = cursor.global_step
        logs = {}
        try:
            for epoch in range(epochs):
                if cursor is not None and epoch < cursor.epoch:
                    continue          # fully-trained epoch from before
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(epoch)
                logs = {}
                if supervisor is not None:
                    supervisor.begin_epoch(epoch)
                if hasattr(train_loader, 'set_epoch'):
                    # pin streaming pipelines (data.IngestPipeline) to
                    # fit's epoch counter; a staged resume cursor
                    # overrides this inside iter()
                    train_loader.set_epoch(epoch)
                # pipelines that prefetch overlap producer work with the
                # dispatched step: take their measured queue wait as
                # data_wait instead of the raw next() time
                pipe_wait = hasattr(train_loader, 'last_wait_s')
                data_iter = iter(train_loader)
                step = 0
                if cursor is not None and epoch == cursor.epoch:
                    step = supervisor.fast_forward(data_iter)
                    cursor = None
                while True:
                    try:
                        if pipe_wait:
                            batch = next(data_iter)
                            tl.record('data_wait',
                                      train_loader.last_wait_s)
                        else:
                            with tl.phase('data_wait'):
                                batch = next(data_iter)
                    except StopIteration:
                        tl.discard()
                        break
                    cbks.on_train_batch_begin(step)
                    ins, labs = self._split_batch(batch)
                    res = self.train_batch(ins, labs)
                    tl.end_step()
                    logs = self._pack_logs(res)
                    cbks.on_train_batch_end(step, logs)
                    step += 1
                    it += 1
                    if supervisor is not None:
                        try:
                            supervisor.on_step(self, epoch, step, it)
                        except Preempted:
                            # urgent checkpoint already written; stop as
                            # cleanly as num_iters would
                            self.stop_training = True
                            break
                    if num_iters is not None and it >= num_iters:
                        self.stop_training = True
                        break
                if eval_loader is not None and \
                        (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              num_workers=num_workers)
                    logs.update({'eval_' + k: v
                                 for k, v in eval_logs.items()})
                    cbks.on_eval_end(eval_logs)
                if epoch == warmup_epoch:
                    wd.declare_warmup('Model.fit epoch %d done' % epoch)
                cbks.on_epoch_end(epoch, logs)
                if self.stop_training:
                    break
            cbks.on_train_end(logs)
        finally:
            self._perf_timeline = None
            wd.close()
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader, Dataset
        loader = DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(eval_data, Dataset) else eval_data
        for m in self._metrics:
            m.reset()
        losses = []
        metrics = []
        for batch in loader:
            ins, labs = self._split_batch(batch)
            res = self.eval_batch(ins, labs)
            if isinstance(res, tuple):
                loss_list, metrics = res
            else:
                loss_list = res
            if loss_list:
                losses.append(np.asarray(loss_list[0]).reshape(-1)[0])
        logs = {}
        if losses:
            logs['loss'] = float(np.mean(losses))
        for m, v in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = v if isinstance(v, (list, tuple)) else [v]
            for n, val in zip(names, vals):
                logs[n] = val
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        from ..io import DataLoader, Dataset
        loader = DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers) \
            if isinstance(test_data, Dataset) else test_data
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, predict=True)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _split_batch(self, batch, predict=False):
        if isinstance(batch, (list, tuple)):
            if predict:
                # drop trailing labels the dataset may carry: feed only as
                # many inputs as forward accepts
                import inspect
                try:
                    sig = inspect.signature(self.network.forward)
                    n_in = len([p for p in sig.parameters.values()
                                if p.kind in (p.POSITIONAL_ONLY,
                                              p.POSITIONAL_OR_KEYWORD)
                                and p.default is p.empty])
                    return list(batch[:max(n_in, 1)]), None
                except (TypeError, ValueError):
                    return list(batch), None
            if len(batch) >= 2:
                n_lab = len(self._labels) if self._labels else 1
                return list(batch[:-n_lab]), list(batch[-n_lab:])
            return list(batch), None
        return [batch], None

    def _pack_logs(self, res):
        logs = {}
        if isinstance(res, tuple):
            loss_list, metrics = res
        else:
            loss_list, metrics = res, []
        if loss_list:
            logs['loss'] = np.asarray(loss_list[0]).reshape(-1)
        for m, v in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = v if isinstance(v, (list, tuple)) else [v]
            for n, val in zip(names, vals):
                logs[n] = val
        return logs

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """training=True: the parameters (.pdparams) and the optimizer's
        state (.pdopt); training=False: the inference artifact, through
        jit.save with prepare()'s inputs as its input spec."""
        if not training:
            from .. import jit
            jit.save(self.network, path, input_spec=self._inputs)
            return
        io_save.save(self.network.state_dict(), path + '.pdparams')
        if self._optimizer:
            io_save.save(self._optimizer.state_dict(), path + '.pdopt')

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.load_state_dict(io_save.load(path + '.pdparams'))
        if not reset_optimizer and self._optimizer and \
                os.path.exists(path + '.pdopt'):
            self._optimizer.set_state_dict(io_save.load(path + '.pdopt'))
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from . import summary as summary_fn
        return summary_fn(self.network, input_size, dtypes=dtype)

    def summary_perf(self, inputs, labels=None, step_seconds=None,
                     registry=None):
        """Cost-model companion to ``summary()``: price the TrainStep's
        step for this batch on fake tensors and report analytic FLOPs,
        bytes accessed, arithmetic intensity, roofline bound and ideal
        step time against the card's peaks; with a measured
        ``step_seconds``, also ``mfu_est`` and ``roofline_frac``. The
        peak is the card's rate for the step's compute dtype: its AMP
        dtype, else its parameters'. Publishes the perf gauges as a side
        effect. Requires ``prepare(loss=..., optimizer=...)``; the batch
        is moved to the network's device first, and nothing runs
        there."""
        from ..monitor.perf import costmodel
        step = self._ensure_train_step()
        dev = self._device()
        dtype = step._amp_dtype or next(
            (p.dtype for p in self.network.parameters()
             if p.is_floating_point()), torch.float32)
        est = costmodel.estimate(
            step, (_to_device(inputs, dev), _to_device(labels, dev)),
            step_seconds=step_seconds, dtype=dtype)
        if est is not None:
            costmodel.record(est, registry=registry)
        return est
