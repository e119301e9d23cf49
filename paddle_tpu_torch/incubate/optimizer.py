"""Optimizer wrappers (counterpart of paddle_tpu/incubate/optimizer.py;
reference: fluid/optimizer.py — LookaheadOptimizer :5969, ModelAverage
:3573, ExponentialMovingAverage :3882; modern paddle re-exposes them under
paddle.incubate.optimizer).

Each wraps an inner optimizer or a parameter list and keeps shadow state
(slow weights, sums, EMA shadows, backups) as tensors of its own: a
snapshot is a clone, never the parameter's storage, which the inner
optimizer updates in place. New values go into the same Parameter with
an in-place copy under no_grad, so optimizer slots and named_parameters
stay valid. The arithmetic is the JAX package's, in its order.

Kept from the JAX package: LookAhead works in an eager loop (TrainStep
updates through the optimizer's `_update`, which LookAhead does not
wrap), and its state_dict holds no slow weights; ModelAverage keeps a
cumulative mean (the window arguments are accepted and ignored);
ExponentialMovingAverage ignores `thres_steps`.
"""
import torch

__all__ = ['LookAhead', 'ModelAverage', 'ExponentialMovingAverage']


def _snapshot(p):
    return p.detach().clone()


class LookAhead:
    """k fast steps, then slow weights pull toward fast by alpha
    (Lookahead Optimizer; reference LookaheadOptimizer)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = {}
        self._steps = 0

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    @torch.no_grad()
    def step(self):
        params = self.inner_optimizer._parameter_list
        for p in params:
            if id(p) not in self._slow:
                self._slow[id(p)] = _snapshot(p)
        self.inner_optimizer.step()
        self._steps += 1
        if self._steps % self.k == 0:
            for p in params:
                slow = self._slow[id(p)]
                slow.copy_(slow + self.alpha * (p - slow))
                p.copy_(slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def state_dict(self):
        return {'inner': self.inner_optimizer.state_dict(),
                'steps': self._steps}

    def set_state_dict(self, state):
        self.inner_optimizer.set_state_dict(state.get('inner', {}))
        self._steps = state.get('steps', 0)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """Running average of parameters; apply()/restore() swaps the averaged
    weights in for evaluation (reference ModelAverageOptimizer, simplified
    to a cumulative window as in the JAX package)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000000,
                 name=None):
        self._params = list(parameters or [])
        self._sum = {id(p): torch.zeros_like(p.detach())
                     for p in self._params}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Accumulate after the inner optimizer stepped."""
        for p in self._params:
            self._sum[id(p)].add_(p)
        self._count += 1

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._backup = {id(p): _snapshot(p) for p in self._params}
        for p in self._params:
            p.copy_(self._sum[id(p)] / self._count)
        return _RestoreCtx(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None


class _RestoreCtx:
    def __init__(self, ma):
        self._ma = ma

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ma.restore()
        return False


class ExponentialMovingAverage:
    """EMA of parameters: shadow = decay*shadow + (1-decay)*param, a static
    decay (`thres_steps` ignored, as in the JAX package); apply()/restore()
    swap the shadows in for eval (reference ExponentialMovingAverage
    :3882)."""

    def __init__(self, decay=0.999, thres_steps=None, parameters=None,
                 name=None):
        self._decay = float(decay)
        self._params = list(parameters or [])
        self._shadow = {id(p): _snapshot(p) for p in self._params}
        self._step = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        for p in self._params:
            shadow = self._shadow[id(p)]
            shadow.copy_(d * shadow + (1.0 - d) * p)

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {id(p): _snapshot(p) for p in self._params}
        for p in self._params:
            p.copy_(self._shadow[id(p)])
        return _RestoreCtx(self) if need_restore else None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None
