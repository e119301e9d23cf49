"""Optimizers (counterpart of paddle_tpu/optimizer/optimizers.py): the JAX
package's fifteen update rules, its state dtypes and its order of work.

Moments of bf16 / fp16 parameters are f32 (`_slot_zeros`): the per-step
increments fall below a bf16 moment's resolution and would freeze it.
torch.optim keeps moments in the parameter's dtype, so it is not used.
With multi_precision=True (Momentum, Adam, AdamW, SparseAdam) an f32
master copy of each 16-bit parameter is kept; the rule runs on it and the
parameter is its rounded shadow.

An update (`_update`) runs, for each parameter: the gradient clip over
all of them; the cast of the grad to the operand's dtype (the master's
where there is one); coupled decay (weight_decay as a float or a
regularizer's coefficient) and the parameter's own regularizer; its
learning rate (the optimizer's times `optimize_attr['learning_rate']`);
AdamW's decoupled decay of the operand; the rule; the cast back.
`learning_rate` is a float or an LRScheduler (optimizer/lr.py), read at
each update. Parameters carry their metadata as attributes
(nn/layer/layers.py).

Adam, AdamW and SGD run as torch._foreach ops over the parameters that
share a dtype, a decay and a learning rate; the other rules run one
parameter at a time. Every Python scalar that meets a 16-bit tensor is
rounded to that tensor's dtype first, as JAX applies a weakly typed
scalar, and a scalar is divided by a tensor as a 0-d tensor (torch's
`scalar / tensor` multiplies by a reciprocal, which rounds otherwise).
"""
import torch

from ..nn.layer.layers import param_meta
from .lr import LRScheduler

__all__ = ['Optimizer', 'SGD', 'Momentum', 'Adam', 'AdamW', 'Adamax',
           'Adagrad', 'Adadelta', 'RMSProp', 'Lamb', 'LarsMomentum',
           'Ftrl', 'Dpsgd', 'ProximalGD', 'ProximalAdagrad', 'SparseAdam']


def _is_low_precision(t):
    return t.dtype in (torch.bfloat16, torch.float16)


def _weak(x, dtype):
    """A Python scalar as JAX applies it to an array of `dtype`: rounded to
    that dtype first (a weakly typed scalar takes the array's type)."""
    return float(torch.tensor(x, dtype=dtype))


def _c(x, t):
    """Scalar x rounded to tensor t's dtype."""
    return _weak(x, t.dtype)


def _lr_mul(x, lr, lr_is_f32):
    """lr * x: with lr_is_f32 the learning rate is an f32 array (the JAX
    TrainStep's), which promotes a 16-bit x to f32; else a weakly typed
    float in x's dtype (the JAX eager step())."""
    if lr_is_f32 and x.dtype != torch.float32:
        x = x.float()
    return x * _c(lr, x)


def _slot_zeros(p):
    return torch.zeros(p.shape, device=p.device,
                       dtype=torch.float32 if _is_low_precision(p)
                       else p.dtype)


def _norm(t):
    return t.square().sum().sqrt()


class Optimizer:
    """`parameters`: tensors, or (name, tensor) pairs such as
    model.named_parameters(). A pair's name, else the ParamAttr name
    (`param_name`), is what AdamW's apply_decay_param_fun and
    LarsMomentum's exclusions see and what keys state_dict; an unnamed
    tensor is 'param<i>' there, and TrainStep gives it the model's name for
    it."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._parameter_list = None
        self._names = {}
        self._explicit_names = set()
        if parameters is not None:
            self._parameter_list = []
            for i, item in enumerate(parameters):
                name, p = item if isinstance(item, tuple) else \
                    (getattr(item, 'param_name', None), item)
                if name is not None:
                    self._explicit_names.add(id(p))
                self._parameter_list.append(p)
                self._names[id(p)] = name if name is not None \
                    else 'param%d' % i
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._slots = {}  # id(param) -> {slot name: tensor}
        # id(param) -> the view of a parameter that a sharded TrainStep
        # updates through its local shard (framework/functional.py)
        self._slot_views = {}
        self._step_count = 0
        self._multi_precision = False

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return self._lr

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError('cannot set_lr when using LRScheduler')
        self._lr = float(value)

    @property
    def _learning_rate(self):
        return self._lr

    def _name_for(self, p, default):
        """The name the rules see for p: its explicit one, else `default`
        (TrainStep passes the model's name)."""
        return self._names[id(p)] if id(p) in self._explicit_names \
            else default

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
        dicts, whose entries it updates. By default one parameter at a
        time through `_apply_one`."""
        return [self._apply_one(p, g, s, lr, t, lr_is_f32)
                for p, g, s in zip(ps, gs, slots)]

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        raise NotImplementedError

    def _group_key(self, name):
        """What besides dtype, decay and lr splits the foreach groups."""
        return None

    def _decay_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if hasattr(wd, '_coeff'):
            return wd._coeff
        return float(wd)

    def _apply_decoupled_decay(self):
        return False

    @torch.no_grad()
    def _update(self, named_grads, lr, t, lr_is_f32):
        """Update each (name, param, grad) as the JAX package does.

        lr_is_f32: the call is TrainStep's, the JAX jitted step's
        counterpart. Its learning rate acts as an f32 array, so products
        with a 16-bit operand are taken in f32 (in the eager step() they
        keep the operand's dtype), and AdamW applies the parameters' own
        regularizers there too (its eager step() skips them)."""
        if self._grad_clip is not None and named_grads:
            clipped = self._grad_clip([(p, g) for _, p, g in named_grads])
            named_grads = [(name, p, g) for (name, p, _), (_, g) in
                           zip(named_grads, clipped)]
        coeff = self._decay_coeff()
        decoupled = self._apply_decoupled_decay()
        decay_fun = getattr(self, '_apply_decay_param_fun', None)
        groups = {}
        for name, p, g in named_grads:
            slots = self._get_slots(p)
            master = slots.get('master')
            operand = master if master is not None else p
            g = g.to(operand.dtype)
            lr_mult, regularizer, _ = param_meta(p)
            if coeff and not decoupled:
                g = g + _c(coeff, g) * operand
            if regularizer is not None and (lr_is_f32 or not decoupled):
                g = regularizer._append(g, operand)
            plr = lr * lr_mult
            decay = coeff if decoupled and (
                decay_fun is None or decay_fun(name)) else 0.0
            key = (operand.dtype, decay, plr, self._group_key(name))
            groups.setdefault(key, []).append((p, operand, g, slots))
        for (dtype, decay, plr, gkey), items in groups.items():
            ps = [op for _, op, _, _ in items]
            if decay:
                if lr_is_f32 and dtype != torch.float32:
                    ps = [x.float() for x in ps]
                ps = torch._foreach_mul(ps, _weak(1.0 - plr * decay,
                                                  ps[0].dtype))
            self._apply_group = gkey
            new = self._apply(ps, [g for _, _, g, _ in items],
                              [s for _, _, _, s in items], plr, t, lr_is_f32)
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
        self._update(named, self.get_lr(), self._step_count,
                     lr_is_f32=False)

    def clear_grad(self, set_to_zero=True):
        """Zero the grads (so the next step() still decays and moves every
        parameter, as in Paddle), or drop them with set_to_zero=False."""
        for p in self._parameter_list or []:
            if p.requires_grad:
                p.grad = torch.zeros_like(p) if set_to_zero else None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        """{'step': n, '<name>_<slot>': tensor, 'LR_Scheduler': {...}} (slots:
        moment1, moment2, velocity, ..., master), the JAX package's keys.
        A parameter that a sharded TrainStep updates through its local
        shard has its slots gathered to the parameter's global shape (a
        collective: every rank of the step calls state_dict)."""
        state = {'step': self._step_count}
        for p in self._parameter_list or []:
            view = self._slot_views.get(id(p))
            for slot, value in self._get_slots(
                    p if view is None else view.local).items():
                state['%s_%s' % (self._names[id(p)], slot)] = \
                    value if view is None else view.gather(value)
        if isinstance(self._lr, LRScheduler):
            state['LR_Scheduler'] = self._lr.state_dict()
        return state

    def set_state_dict(self, state_dict):
        """Load what state_dict() gave (its tensors copied onto each
        parameter's device; a sharded step's parameter keeps its shard)."""
        self._step_count = int(state_dict.get('step', 0))
        if isinstance(self._lr, LRScheduler) and \
                'LR_Scheduler' in state_dict:
            self._lr.set_state_dict(state_dict['LR_Scheduler'])
        for p in self._parameter_list or []:
            view = self._slot_views.get(id(p))
            slots = self._get_slots(p if view is None else view.local)
            for slot in list(slots):
                key = '%s_%s' % (self._names[id(p)], slot)
                if key in state_dict:
                    value = torch.as_tensor(state_dict[key]).to(p.device)
                    slots[slot] = value.clone() if view is None else \
                        view.scatter(value)

    set_dict = set_state_dict


class SGD(Optimizer):
    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        if lr_is_f32:
            gs = [g.float() for g in gs]
        return torch._foreach_sub(
            ps, torch._foreach_mul(gs, _weak(lr, gs[0].dtype)))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov
        self._multi_precision = multi_precision

    def _init_slots(self, p):
        return {'velocity': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        vel = s['velocity']
        v = _c(self._momentum, vel) * vel + g
        update = g + _c(self._momentum, v) * v if self._nesterov else v
        s['velocity'] = v.to(vel.dtype)
        return p - _lr_mul(update, lr, lr_is_f32)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        if lazy_mode:
            raise NotImplementedError(
                'lazy_mode is not ported: the JAX package accepts and '
                'ignores it; SparseAdam is its row-sparse rule')
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = float(epsilon)
        self._multi_precision = multi_precision

    def _betas(self):
        b1 = self._beta1() if callable(self._beta1) else self._beta1
        b2 = self._beta2() if callable(self._beta2) else self._beta2
        return float(b1), float(b2)

    def _init_slots(self, p):
        return {'moment1': _slot_zeros(p), 'moment2': _slot_zeros(p)}

    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        b1, b2 = self._betas()
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
            raise NotImplementedError(
                'lr_ratio is not ported: the JAX package accepts and '
                'ignores it; give a parameter its own rate with '
                'ParamAttr(learning_rate=...)')
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_decoupled_decay(self):
        return True


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {'moment': _slot_zeros(p), 'inf_norm': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        b1, b2 = self._beta1, self._beta2
        m = _c(b1, s['moment']) * s['moment'] + _c(1 - b1, g) * g
        u = torch.maximum(_c(b2, s['inf_norm']) * s['inf_norm'], g.abs())
        s['moment'], s['inf_norm'] = m.to(s['moment'].dtype), \
            u.to(s['inf_norm'].dtype)
        step = _lr_mul(m, lr / (1 - b1 ** t), lr_is_f32)
        return p - step / (u + _c(self._epsilon, u))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_slots(self, p):
        z = _slot_zeros(p)
        return {'moment': z + _c(self._init_val, z)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        mom = s['moment'] + g * g
        s['moment'] = mom.to(s['moment'].dtype)
        den = mom.sqrt() + _c(self._epsilon, mom)
        return p - _lr_mul(g, lr, lr_is_f32) / den


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots(self, p):
        return {'avg_squared_grad': _slot_zeros(p),
                'avg_squared_update': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        rho, eps = self._rho, self._epsilon
        asg0, asu0 = s['avg_squared_grad'], s['avg_squared_update']
        asg = _c(rho, asg0) * asg0 + _c(1 - rho, g) * g * g
        update = -((asu0 + _c(eps, asu0)) / (asg + _c(eps, asg))).sqrt() * g
        asu = _c(rho, asu0) * asu0 + _c(1 - rho, update) * update * update
        s['avg_squared_grad'] = asg.to(asg0.dtype)
        s['avg_squared_update'] = asu.to(asu0.dtype)
        return p + _lr_mul(update, lr, lr_is_f32)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        return {'mean_square': _slot_zeros(p), 'mean_grad': _slot_zeros(p),
                'momentum': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        rho, eps = self._rho, self._epsilon
        ms0 = s['mean_square']
        ms = _c(rho, ms0) * ms0 + _c(1 - rho, g) * g * g
        mg = s['mean_grad']
        if self._centered:
            mg = _c(rho, mg) * mg + _c(1 - rho, g) * g
            denom = ms - mg * mg + _c(eps, ms)
        else:
            denom = ms + _c(eps, ms)
        mom0 = s['momentum']
        mom = _c(self._momentum, mom0) * mom0 + \
            _lr_mul(g, lr, lr_is_f32) / denom.sqrt()
        s['mean_square'] = ms.to(ms0.dtype)
        s['mean_grad'] = mg.to(ms0.dtype)
        s['momentum'] = mom.to(mom0.dtype)
        return p - mom


class Lamb(Optimizer):
    """Lamb. As in the JAX package, exclude_from_weight_decay_fn is kept
    but not applied: every parameter takes lamb_weight_decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        return {'moment1': _slot_zeros(p), 'moment2': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        b1, b2 = self._beta1, self._beta2
        m0, v0 = s['moment1'], s['moment2']
        m = _c(b1, m0) * m0 + _c(1 - b1, g) * g
        v = _c(b2, v0) * v0 + _c(1 - b2, g) * g * g
        mhat = m / _c(1 - b1 ** t, m)
        vhat = v / _c(1 - b2 ** t, v)
        r = mhat / (vhat.sqrt() + _c(self._epsilon, vhat))
        update = r + _c(self._lamb_wd, p) * p
        w_norm, u_norm = _norm(p), _norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        s['moment1'], s['moment2'] = m.to(m0.dtype), v.to(v0.dtype)
        return p - _lr_mul(trust, lr, lr_is_f32) * update


class LarsMomentum(Optimizer):
    """LARS momentum: the update scaled by lars_coeff * ||w|| / (||g|| +
    wd ||w|| + eps) per parameter; a parameter whose name contains a
    token of exclude_from_weight_decay takes plain momentum, with no
    scaling and no decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _init_slots(self, p):
        return {'velocity': _slot_zeros(p)}

    def _group_key(self, name):
        return any(tok in (name or '') for tok in self._exclude)

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        vel = s['velocity']
        if self._apply_group:  # this call's parameters are excluded
            v = _c(self._momentum, vel) * vel + _lr_mul(g, lr, lr_is_f32)
            s['velocity'] = v.to(vel.dtype)
            return p - v
        w_norm, g_norm = _norm(p), _norm(g)
        wd = self._lars_wd
        denom = g_norm + _c(wd, w_norm) * w_norm + _c(self._epsilon, g_norm)
        scaled = _lr_mul(w_norm, lr * self._lars_coeff, lr_is_f32) / \
            denom.clamp_min(_c(1e-30, denom))
        local_lr = torch.where((w_norm > 0) & (denom > 0), scaled,
                               _c(lr, scaled))
        # an f32 learning rate promotes the 16-bit term (torch would not
        # promote a tensor by a 0-d one)
        v = _c(self._momentum, vel) * vel + \
            local_lr * (g + _c(wd, p) * p).to(local_lr.dtype)
        s['velocity'] = v.to(vel.dtype)
        return p - v


class Ftrl(Optimizer):
    """FTRL-Proximal: squared grads (n) and a linear term (z) per
    coordinate; the closed-form update applies L1 / L2 shrinkage."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1 = float(l1)
        self._l2 = float(l2)
        self._lr_power = float(lr_power)

    def _init_slots(self, p):
        return {'squared': _slot_zeros(p), 'linear': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        n, z = s['squared'], s['linear']
        n_new = n + g * g
        pw = -self._lr_power
        sigma = (n_new ** pw - n ** pw) / lr
        z_new = z + g - sigma * p
        l1 = _c(self._l1, z_new)
        new_p = torch.where(
            z_new.abs() <= l1, torch.zeros_like(p),
            (torch.sign(z_new) * l1 - z_new) /
            (n_new ** pw / lr + _c(2.0 * self._l2, n_new)))
        s['squared'], s['linear'] = n_new.to(n.dtype), z_new.to(z.dtype)
        return new_p


class Dpsgd(Optimizer):
    """Differentially private SGD: each update's grad clipped to an L2
    norm of `clip`, plus gaussian noise of std sigma * clip / batch_size.
    The noise comes from a torch.Generator seeded from (seed, step), so a
    run repeats itself; it is not the JAX package's threefry noise."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, weight_decay=None,
                 grad_clip=None, seed=0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._clip = float(clip)
        self._batch = float(batch_size)
        self._sigma = float(sigma)
        self._seed = int(seed)

    def _noise(self, g, t):
        gen = torch.Generator(device=g.device)
        # (the CPU generator keeps 32 bits of its seed)
        gen.manual_seed(((self._seed * 0x9E3779B1) ^ int(t)) & 0xFFFFFFFF)
        return torch.randn(g.shape, generator=gen, device=g.device,
                           dtype=torch.float32).to(g.dtype)

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        g_norm = _norm(g)
        scale = (g_norm.new_tensor(self._clip) /
                 g_norm.clamp_min(_c(1e-30, g_norm))).clamp(max=1.0)
        noise = self._noise(g, t) * _c(self._sigma * self._clip, g)
        g_priv = g * scale + noise / _c(self._batch, noise)
        return p - _lr_mul(g_priv, lr, lr_is_f32)


class ProximalGD(Optimizer):
    """Proximal gradient descent with L1 / L2 shrinkage."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._l1 = float(l1)
        self._l2 = float(l2)

    def _prox(self, w, lr, lr_is_f32):
        if lr_is_f32 and w.dtype != torch.float32:
            w = w.float()
        shrunk = torch.sign(w) * (w.abs() - _c(lr * self._l1, w)).clamp_min(
            0.0)
        return shrunk / _c(1.0 + lr * self._l2, w)

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        return self._prox(p - _lr_mul(g, lr, lr_is_f32), lr, lr_is_f32)


class ProximalAdagrad(ProximalGD):
    """An Adagrad step, then the proximal L1 / L2 shrinkage."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, l1, l2, parameters, weight_decay,
                         grad_clip)
        self._epsilon = float(epsilon)

    def _init_slots(self, p):
        return {'moment': _slot_zeros(p)}

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        mom = s['moment'] + g * g
        s['moment'] = mom.to(s['moment'].dtype)
        eff = mom.new_tensor(lr) / (mom.sqrt() + _c(self._epsilon, mom))
        return self._prox(p - eff * g, lr, lr_is_f32)


class SparseAdam(Adam):
    """Row-sparse Adam: the moments move only on rows (slices along the
    first axis) where the grad has a nonzero entry, and only those rows
    move."""

    def _apply(self, ps, gs, slots, lr, t, lr_is_f32):
        return Optimizer._apply(self, ps, gs, slots, lr, t, lr_is_f32)

    def _apply_one(self, p, g, s, lr, t, lr_is_f32):
        touched = (g != 0).flatten(1).any(dim=1).reshape(
            (-1,) + (1,) * (g.dim() - 1)) if g.dim() > 1 else g != 0
        b1, b2 = self._betas()
        m0, v0 = s['moment1'], s['moment2']
        m = torch.where(touched, _c(b1, m0) * m0 + _c(1 - b1, g) * g, m0)
        v = torch.where(touched, _c(b2, v0) * v0 + _c(1 - b2, g) * g * g,
                        v0)
        mhat = m / _c(1 - b1 ** t, m)
        vhat = v / _c(1 - b2 ** t, v)
        upd = _lr_mul(mhat, lr, lr_is_f32) / (vhat.sqrt() +
                                              _c(self._epsilon, vhat))
        s['moment1'], s['moment2'] = m.to(m0.dtype), v.to(v0.dtype)
        return p - torch.where(touched, upd, 0.0)
