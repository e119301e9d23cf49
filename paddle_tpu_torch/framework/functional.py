"""The training step (counterpart of paddle_tpu/framework/functional.py's
TrainStep).

The JAX package traces forward, backward and update into one jitted XLA
program. The port runs them eagerly: model.train(), forward,
loss_fn(*outputs, *labels), backward, then the optimizer update in the
order of the JAX step's apply_updates (no grad clip in this slice;
decoupled decay on the stored operand; the rule; the cast back to the
parameter's dtype; the step count t = step + 1). Shardings, gradient
merge, AMP and loss scaling, recompute and grad sync come in later
slices, and asking for them raises.
"""
import torch

__all__ = ['TrainStep']


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
        if int(k_steps) != 1:
            raise NotImplementedError(
                'gradient merge (k_steps > 1) is not ported yet (a later '
                'training slice)')
        if amp_dtype is not None:
            raise NotImplementedError(
                'AMP and loss scaling (amp_dtype) are not ported yet (a '
                'later training slice)')
        if remat:
            raise NotImplementedError(
                'recompute (remat=True) is not ported yet (a later training '
                'slice)')
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._params = [(name, p) for name, p in model.named_parameters()
                        if p.requires_grad]

    def __call__(self, inputs, labels):
        """One step on a batch; returns the loss (detached)."""
        if not isinstance(inputs, (list, tuple)):
            inputs = (inputs,)
        if not isinstance(labels, (list, tuple)):
            labels = (labels,)
        self.model.train()
        for _, p in self._params:
            p.grad = None
        out = self.model(*inputs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        opt = self.optimizer
        # every trainable parameter is updated, as in the JAX step, where a
        # parameter the loss does not reach has a zero grad
        named = [(opt._names.get(id(p), name), p,
                  p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in self._params]
        t = opt._step_count + 1
        opt._update(named, opt.get_lr(), t, lr_is_f32=True)
        opt._step_count = t
        for _, p in self._params:
            p.grad = None
        return loss.detach()
