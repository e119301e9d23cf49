"""Normalisation (counterpart of paddle_tpu/nn/functional/norm.py and of the
RMSNorm layer's body in paddle_tpu/nn/layer/norm.py)."""
import torch

from ...amp.auto_cast import cast as amp_cast


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast('layer_norm', x, weight, bias)
    return torch.nn.functional.layer_norm(x, list(normalized_shape), weight,
                                          bias, epsilon)


def rms_norm(x, normalized_shape, weight=None, epsilon=1e-6):
    """x * rsqrt(mean(x^2) + eps) * w, the mean taken in f32 and the scale
    cast back to x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight = amp_cast('rms_norm', x, weight)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    var = x.float().square().mean(dim=dims, keepdim=True)
    out = x * torch.rsqrt(var + epsilon).to(x.dtype)
    return out if weight is None else out * weight
