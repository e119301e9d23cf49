"""Optimizers (counterpart of paddle_tpu/optimizer/optimizers.py): SGD,
Adam and AdamW with the JAX package's update rules and state dtypes.

Moments of bf16 / fp16 parameters are f32 (`_slot_zeros`): the per-step
increments fall below a bf16 moment's resolution and would freeze it.
torch.optim keeps moments in the parameter's dtype, so it is not used.
With multi_precision=True an f32 master copy of each 16-bit parameter is
kept; the rule runs on it and the parameter is its rounded shadow.

Updates run in place on the parameters, their moments and masters, with
torch._foreach ops over the parameters that share a dtype and a decay.
The learning rate is a float; schedulers, gradient clipping and
regularizer objects come in a later slice.
"""
import numbers

import torch

__all__ = ['Optimizer', 'SGD', 'Adam', 'AdamW']


def _is_low_precision(t):
    return t.dtype in (torch.bfloat16, torch.float16)


def _weak(x, dtype):
    """A Python scalar as JAX applies it to an array of `dtype`: rounded to
    that dtype first (a weakly typed scalar takes the array's type)."""
    return float(torch.tensor(x, dtype=dtype))


def _slot_zeros(p):
    return torch.zeros(p.shape, device=p.device,
                       dtype=torch.float32 if _is_low_precision(p)
                       else p.dtype)


class Optimizer:
    """`parameters`: tensors, or (name, tensor) pairs such as
    model.named_parameters(); the names are what AdamW's
    apply_decay_param_fun sees ('param<i>' for unnamed tensors)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                'learning-rate schedulers are not ported yet; the training '
                'slice takes a float learning rate')
        if grad_clip is not None:
            raise NotImplementedError(
                'gradient clipping is not ported yet (a later training '
                'slice)')
        if weight_decay is not None and \
                not isinstance(weight_decay, numbers.Real):
            raise NotImplementedError(
                'regularizer objects are not ported yet; pass weight_decay '
                'as a float')
        self._lr = float(learning_rate)
        self._parameter_list = None
        self._names = {}
        if parameters is not None:
            self._parameter_list = []
            for i, item in enumerate(parameters):
                name, p = item if isinstance(item, tuple) else \
                    ('param%d' % i, item)
                self._parameter_list.append(p)
                self._names[id(p)] = name
        self._weight_decay = weight_decay
        self._slots = {}  # id(param) -> {slot name: tensor}
        self._step_count = 0
        self._multi_precision = False

    def get_lr(self):
        return self._lr

    # -- slots -------------------------------------------------------------
    def _init_slots(self, p):
        return {}

    def _get_slots(self, p):
        slots = self._slots.get(id(p))
        if slots is None:
            slots = self._init_slots(p)
            if self._multi_precision and _is_low_precision(p):
                slots['master'] = p.detach().float()
            self._slots[id(p)] = slots
        return slots

    # -- the update --------------------------------------------------------
    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        """The rule over lists: new parameter values from the operands
        `ps`, grads `gs` (in the operands' dtype) and per-parameter slot
        dicts, whose moments it updates in place."""
        raise NotImplementedError

    def _decay_coeff(self):
        return 0.0 if self._weight_decay is None else \
            float(self._weight_decay)

    def _apply_decoupled_decay(self):
        return False

    @torch.no_grad()
    def _update(self, named_grads, lr, t, lr_is_f32):
        """Update each (name, param, grad) as the JAX package does: the rule
        runs on the f32 master where there is one, else on the parameter;
        the grad is cast to that operand's dtype; coupled decay adds
        coeff * p to it; decoupled decay (AdamW, where
        apply_decay_param_fun allows) scales the operand by
        1 - lr * coeff first; the result is stored rounded to the
        parameter's dtype. lr_is_f32: the learning rate acts as an f32
        array, as in the JAX TrainStep, so its products with a 16-bit
        operand are taken in f32; in the eager step() they keep the
        operand's dtype."""
        coeff = self._decay_coeff()
        decoupled = self._apply_decoupled_decay()
        decay_fun = getattr(self, '_apply_decay_param_fun', None)
        groups = {}
        for name, p, g in named_grads:
            slots = self._get_slots(p)
            master = slots.get('master')
            operand = master if master is not None else p
            g = g.to(operand.dtype)
            if coeff and not decoupled:
                g = g + _weak(coeff, g.dtype) * operand
            decay = coeff if decoupled and (
                decay_fun is None or decay_fun(name)) else 0.0
            groups.setdefault((operand.dtype, decay), []).append(
                (p, operand, g, slots))
        for (dtype, decay), items in groups.items():
            ps = [op for _, op, _, _ in items]
            if decay:
                if lr_is_f32 and dtype != torch.float32:
                    ps = [x.float() for x in ps]
                ps = torch._foreach_mul(ps, _weak(1.0 - lr * decay,
                                                  ps[0].dtype))
            new = self._apply(ps, [g for _, _, g, _ in items],
                              [s for _, _, _, s in items], lr, t, lr_is_f32)
            for (p, _, _, slots), new_p in zip(items, new):
                if 'master' in slots:
                    slots['master'].copy_(new_p)
            torch._foreach_copy_([p for p, _, _, _ in items], new)

    # -- public api --------------------------------------------------------
    def step(self):
        """One update of every listed parameter that has a grad."""
        if self._parameter_list is None:
            raise ValueError('optimizer created without parameters')
        named = [(self._names[id(p)], p, p.grad)
                 for p in self._parameter_list
                 if p.requires_grad and p.grad is not None]
        self._step_count += 1
        self._update(named, self._lr, self._step_count, lr_is_f32=False)

    def clear_grad(self, set_to_zero=True):
        """Zero the grads (so the next step() still decays and moves every
        parameter, as in Paddle), or drop them with set_to_zero=False."""
        for p in self._parameter_list or []:
            if p.requires_grad:
                p.grad = torch.zeros_like(p) if set_to_zero else None

    def state_dict(self):
        """{'step': n, '<name>_<slot>': tensor} (slots: moment1, moment2,
        master), the JAX package's keys."""
        state = {'step': self._step_count}
        for p in self._parameter_list or []:
            for slot, value in self._get_slots(p).items():
                state['%s_%s' % (self._names[id(p)], slot)] = value
        return state


class SGD(Optimizer):
    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        if lr_is_f32:
            gs = [g.float() for g in gs]
        return torch._foreach_sub(
            ps, torch._foreach_mul(gs, _weak(lr, gs[0].dtype)))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if lazy_mode:
            raise NotImplementedError('lazy_mode is not ported yet')
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._multi_precision = multi_precision

    def _init_slots(self, p):
        return {'moment1': _slot_zeros(p), 'moment2': _slot_zeros(p)}

    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        b1, b2 = self._beta1, self._beta2
        m = [s['moment1'] for s in slots]
        v = [s['moment2'] for s in slots]
        # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g, the g terms in
        # g's dtype and the sums in the moments'
        dt = gs[0].dtype
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(gs, _weak(1 - b1, dt)))
        g2 = torch._foreach_mul(gs, _weak(1 - b2, dt))
        torch._foreach_mul_(g2, gs)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        # p - lr * mhat / (sqrt(vhat) + eps)
        step = torch._foreach_div(m, 1 - b1 ** t)
        den = torch._foreach_div(v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_mul_(step, lr)
        torch._foreach_div_(step, den)
        return torch._foreach_sub(ps, step)


class AdamW(Adam):
    """Adam with decoupled weight decay: p * (1 - lr * coeff) before the
    rule, for the parameters whose name apply_decay_param_fun accepts
    (all when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError('lr_ratio is not ported yet')
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_decoupled_decay(self):
        return True
