"""The training step (counterpart of paddle_tpu/framework/functional.py's
TrainStep).

The JAX package traces forward, backward and update into one jitted XLA
program. The port runs them eagerly: model.train(), forward,
loss_fn(*outputs, *labels), backward, then the optimizer update in the
order of the JAX step's apply_updates (grad clip; coupled decay and the
parameters' regularizers; their learning rates; decoupled decay on the
stored operand; the rule; the cast back to the parameter's dtype; the step
count t = step + 1).

The JAX step's options, each as it does it:
- amp_dtype ('bfloat16' / 'float16'): the parameters (trainable or
  not), the floating buffers and the floating inputs are cast to it for
  the forward and the backward (the parameters' storage swapped for the
  cast copies for the step); the grads return in the parameters' dtype,
  the buffers are cast back, and the loss is taken in f32.
- fp16 dynamic loss scaling (amp_dtype='float16'): the f32 loss times the
  scale is differentiated and the grads divided by it; a non-finite grad
  skips the update (parameters, slots and step count stay as they were)
  and halves the scale, to a floor of 1; ls_growth_interval finite steps
  in a row double it, to a cap of 2^24. The finite check is one fused
  reduction and one flag read to the host a step (the JAX step decides
  on the device with lax.cond).
- remat: the whole loss is checkpointed (torch.utils.checkpoint,
  non-reentrant): the backward runs the forward again.
- k_steps / grad_merge_avg: the grads are summed over k_steps calls, in
  f32 for 16-bit parameters; on the k-th call clip, decay and the update
  run on the sum (times 1 / k_steps when grad_merge_avg), and only then
  does the step count advance. fp16 loss scaling with k_steps > 1
  raises, as in the JAX package.
Shardings, grad sync and the sequence- and pipeline-parallel states come
with the distributed slice; asking for them raises.
"""
import torch
from torch.utils.checkpoint import checkpoint

from ..amp.grad_scaler import unscale_and_check
from ..optimizer.optimizers import _is_low_precision
from .dtype import to_torch_dtype

__all__ = ['TrainStep']

_MAX_LOSS_SCALE = 2.0 ** 24


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, donate=True,
                 in_shardings=None, out_shardings=None, mesh=None,
                 batch_sharding=None, grad_sync=None, k_steps=1,
                 grad_merge_avg=True, amp_dtype=None, remat=False,
                 sp_state=None, pp_state=None, init_loss_scaling=65536.0,
                 ls_growth_interval=2000, fce_sharding=None):
        sharded = {'in_shardings': in_shardings,
                   'out_shardings': out_shardings, 'mesh': mesh,
                   'batch_sharding': batch_sharding, 'sp_state': sp_state,
                   'pp_state': pp_state, 'fce_sharding': fce_sharding}
        for name, value in sharded.items():
            if value is not None:
                raise NotImplementedError(
                    'TrainStep(%s=...): sharded and parallel steps are not '
                    'ported yet; they come with the distributed slice' % name)
        if grad_sync is not None:
            raise NotImplementedError(
                'TrainStep(grad_sync=...) is not ported yet; it comes with '
                'the distributed slice')
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._amp_dtype = (None if amp_dtype is None else torch.bfloat16
                           if amp_dtype is True
                           else to_torch_dtype(amp_dtype))
        self._loss_scaling = self._amp_dtype == torch.float16
        self._k_steps = int(k_steps)
        if self._loss_scaling and self._k_steps > 1:
            raise NotImplementedError(
                'fp16 loss scaling is not composed with gradient merge '
                'yet; use bf16 amp with gradient_merge')
        self._grad_merge_avg = grad_merge_avg
        self._remat = bool(remat)
        self.loss_scale = float(init_loss_scaling)
        self._ls_growth = 0
        self._ls_growth_interval = int(ls_growth_interval)
        self._acc = None
        self._micro = 0
        self._params = [(name, p) for name, p in model.named_parameters()
                        if p.requires_grad]

    # -- forward and backward ------------------------------------------------
    def _cast_for_step(self, inputs):
        """Swap the storage of every parameter (frozen ones too, as the JAX
        step casts all of them) and of the floating buffers for copies in
        the AMP dtype; returns the cast inputs and what to restore."""
        amp = self._amp_dtype
        swapped = []
        for p in self.model.parameters():
            if p.is_floating_point():
                swapped.append((p, p.data,
                                'grad' if p.requires_grad else 'frozen'))
                p.data = p.data.to(amp)
        for b in self.model.buffers():
            if b.is_floating_point():
                swapped.append((b, b.data, 'buffer'))
                b.data = b.data.to(amp)
        inputs = tuple(a.to(amp) if torch.is_tensor(a) and
                       a.is_floating_point() else a for a in inputs)
        return inputs, swapped

    @staticmethod
    def _restore(swapped):
        """Put the stored dtypes back: a trainable parameter's grad is cast
        to it, a frozen one gets its own storage back, a buffer's new value
        is cast to it."""
        for t, keep, kind in swapped:
            if kind == 'buffer':
                t.data = t.data.to(keep.dtype)
                continue
            g, t.grad = t.grad, None
            t.data = keep
            if kind == 'grad' and g is not None:
                t.grad = g.to(keep.dtype)

    def _loss_and_grads(self, inputs, labels):
        """Forward and backward; the loss (f32 under AMP), detached."""
        swapped = []
        if self._amp_dtype is not None:
            inputs, swapped = self._cast_for_step(inputs)
        try:
            def compute(*args):
                out = self.model(*args[:len(inputs)])
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self.loss_fn(*outs, *args[len(inputs):])
                return loss.float() if self._amp_dtype is not None else loss

            if self._remat:
                loss = checkpoint(compute, *inputs, *labels,
                                  use_reentrant=False)
            else:
                loss = compute(*inputs, *labels)
            # differentiate the scaled loss so fp16 cotangents stay above
            # the fp16 underflow floor; report the raw loss
            (loss * self.loss_scale if self._loss_scaling
             else loss).backward()
        finally:
            self._restore(swapped)
        return loss.detach()

    # -- the step ------------------------------------------------------------
    def _update_scale(self, finite):
        grown = self._ls_growth + 1 >= self._ls_growth_interval
        if finite:
            if grown:
                self.loss_scale = min(self.loss_scale * 2.0,
                                      _MAX_LOSS_SCALE)
            self._ls_growth = 0 if grown else self._ls_growth + 1
        else:
            self.loss_scale = max(self.loss_scale * 0.5, 1.0)
            self._ls_growth = 0

    def __call__(self, inputs, labels):
        """One step (one micro-step under gradient merge) on a batch;
        returns the loss (detached, f32 under AMP)."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        self.model.train()
        for _, p in self._params:
            p.grad = None
        loss = self._loss_and_grads(tuple(inputs), tuple(labels))
        # every trainable parameter is updated, as in the JAX step, where a
        # parameter the loss does not reach has a zero grad
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self._params]
        for _, p in self._params:
            p.grad = None
        if self._loss_scaling:
            finite = unscale_and_check(grads, self.loss_scale)
            self._update_scale(finite)
            if not finite:
                return loss
        if self._k_steps > 1:
            grads = self._merge(grads)
            if grads is None:
                return loss
        self._apply(grads)
        return loss

    @torch.no_grad()
    def _merge(self, grads):
        """Add this micro-step's grads to the f32 sums; on the k-th, the
        grads to apply (the sums times 1 / k_steps under grad_merge_avg)
        and the sums zeroed, else None."""
        if self._acc is None:
            self._acc = [torch.zeros(p.shape, device=p.device,
                                     dtype=torch.float32
                                     if _is_low_precision(p) else p.dtype)
                         for _, p in self._params]
        torch._foreach_add_(self._acc, [g.to(a.dtype) for g, a in
                                        zip(grads, self._acc)])
        self._micro += 1
        if self._micro < self._k_steps:
            return None
        scale = 1.0 / self._k_steps if self._grad_merge_avg else 1.0
        eff = torch._foreach_mul(self._acc, scale)
        torch._foreach_zero_(self._acc)
        self._micro = 0
        return eff

    def _apply(self, grads):
        opt = self.optimizer
        named = [(opt._name_for(p, name), p, g)
                 for (name, p), g in zip(self._params, grads)]
        t = opt._step_count + 1
        opt._update(named, opt.get_lr(), t, lr_is_f32=True)
        opt._step_count = t

    def multi_step(self, inputs, labels):
        """K steps at one learning rate: every input and label carries a
        leading K axis. The JAX package runs them as one lax.scan program;
        here they are K eager steps. Returns the K losses."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        k = inputs[0].shape[0]
        return torch.stack([self([a[i] for a in inputs],
                                 [b[i] for b in labels]) for i in range(k)])

    def _no_program(self, *args, **kwargs):
        raise NotImplementedError(
            'the port builds no XLA program: its TrainStep runs eagerly, '
            'so there is no jaxpr, executable or HLO to return')

    trace_jaxpr = compiled_executable = compiled_hlo = _no_program
