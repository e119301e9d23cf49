"""Numerical debugging utilities (counterpart of
paddle_tpu/framework/debug.py).

Reference: FLAGS_check_nan_inf + framework/details/nan_inf_utils_detail.cc
(per-op output scanning naming the offending var). Here the flag turns on
autograd's anomaly detection (framework/flags.py); check_numerics gives
the explicit per-tensor check for user code and tests, counting on the
tensor's own device.
"""
import numpy as np
import torch

__all__ = ['check_numerics', 'enable_check_nan_inf',
           'disable_check_nan_inf']


def check_numerics(x, name='tensor'):
    """Raise FloatingPointError if x contains NaN/Inf; returns x so it can
    be inserted inline in eager code."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    n_nan, n_inf = torch.stack([torch.isnan(t).sum(),
                                torch.isinf(t).sum()]).tolist()
    if n_nan or n_inf:
        raise FloatingPointError(
            '%s contains %d NaN and %d Inf values (shape %s, dtype %s)'
            % (name, n_nan, n_inf, tuple(t.shape),
               str(t.dtype).replace('torch.', '')))
    return x


def enable_check_nan_inf():
    from . import flags
    flags.set_flags({'FLAGS_check_nan_inf': True})


def disable_check_nan_inf():
    from . import flags
    flags.set_flags({'FLAGS_check_nan_inf': False})
