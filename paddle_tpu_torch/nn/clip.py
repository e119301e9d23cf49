"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

A clip object maps a list of (param, grad) pairs to a new one; the
optimizers and TrainStep apply it before the update. Grads of None pass
through. ClipGradByGlobalNorm skips parameters whose `need_clip` is
False, sums the squared grads in f32 and keeps the norm and the scale as
device tensors: clipping reads nothing back to the host.
"""
import torch

__all__ = ['ClipGradByValue', 'ClipGradByNorm', 'ClipGradByGlobalNorm',
           'clip_grad_norm_', 'clip_grad_value_']


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = g.square().sum().sqrt()
            scale = torch.where(norm > self.clip_norm,
                                norm.new_tensor(self.clip_norm) / norm, 1.0)
            out.append((p, g * scale))
        return out


def _sum_squares_f32(grads):
    """sum of g^2 over every grad, in f32 (one norm kernel per group of a
    dtype)."""
    total = None
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for dtype, group in by_dtype.items():
        if dtype != torch.float32:
            group = [g.float() for g in group]
        part = torch.stack(torch._foreach_norm(group)).square().sum()
        total = part if total is None else total + part
    return total


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad with need_clip scaled by clip_norm / max(global norm,
    clip_norm), the global norm taken over those grads in f32."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, 'need_clip', True)]
        return _sum_squares_f32(grads).sqrt() if grads else None

    def __call__(self, params_grads):
        global_norm = self.global_norm(params_grads)
        if global_norm is None:
            return params_grads
        scale = global_norm.new_tensor(self.clip_norm) / \
            global_norm.clamp_min(self.clip_norm)
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, 'need_clip', True):
                out.append((p, g))
            elif g.dtype == torch.float32:
                out.append((p, g * scale))
            else:
                out.append((p, (g.float() * scale).to(g.dtype)))
        return out


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the grads of `parameters` in place by min(max_norm / (total +
    1e-6), 1), the total their joint norm_type norm; returns the total."""
    params = [p for p in (parameters if isinstance(parameters, (list, tuple))
                          else [parameters]) if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float('inf'):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = sum((p.grad.abs() ** norm_type).sum()
                    for p in params) ** (1.0 / norm_type)
    scale = (total.new_tensor(max_norm) / (total + 1e-6)).clamp(max=1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the grads of `parameters` to [-clip_value, clip_value]."""
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    for p in params:
        if p.grad is not None:
            p.grad = p.grad.clamp(-clip_value, clip_value)
