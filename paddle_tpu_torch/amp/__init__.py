"""AMP (counterpart of paddle_tpu/amp/): `auto_cast` casts each port
functional's inputs by Paddle's allow / block lists, and `GradScaler` keeps
the fp16 loss-scaling contract of the eager loop."""
from .auto_cast import amp_guard, auto_cast, black_list, white_list  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ['auto_cast', 'GradScaler']
