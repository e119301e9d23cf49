"""GradScaler (counterpart of paddle_tpu/amp/grad_scaler.py): fp16 loss
scaling for the eager loop.

`scale(loss)` multiplies the loss by the scale; `step(optimizer)` divides
every listed parameter's grad by it and runs the optimizer's step only if
every grad is finite; `update()` moves the scale: times decr_ratio (at
least 1) after decr_every_n_nan_or_inf overflowing steps, times
incr_ratio after incr_every_n_steps finite ones. The finite check is one
reduction on the device and one flag read to the host a step (the JAX
package reads one per grad).
"""
import torch

__all__ = ['GradScaler', 'AmpScaler']


def unscale_and_check(grads, scale, by_inverse=False):
    """Divide each grad by `scale` in place (or, by_inverse, multiply it by
    1 / scale, as the JAX GradScaler does); True if all are finite. One
    fused check per device and dtype, one flag read to the host."""
    groups = {}
    for g in grads:
        groups.setdefault((g.device, g.dtype), []).append(g)
    found = []
    for (device, _), group in groups.items():
        if by_inverse:
            torch._foreach_mul_(group, 1.0 / scale)
        else:
            torch._foreach_div_(group, scale)
        flag = torch.zeros(1, device=device)
        # the fused check: an inv_scale of 1 leaves the grads as they are
        torch._amp_foreach_non_finite_check_and_unscale_(
            group, flag, torch.ones(1, device=device))
        found.append(flag.to(grads[0].device))
    return not found or not bool(torch.cat(found).any().item())


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._parameter_list or []
                 if p.grad is not None]
        self._found_inf = not unscale_and_check(grads, self._scale,
                                                by_inverse=True)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {'scale': self._scale, 'incr_ratio': self._incr_ratio,
                'decr_ratio': self._decr_ratio,
                'good_steps': self._good_steps, 'bad_steps': self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get('scale', self._scale)
        self._good_steps = state.get('good_steps', 0)
        self._bad_steps = state.get('bad_steps', 0)


AmpScaler = GradScaler
