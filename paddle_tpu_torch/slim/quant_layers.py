"""Fake-quant primitives and quantized layer wrappers (counterpart of
paddle_tpu/slim/quant_layers.py).

Quantization is simulated (quantize-dequantize) with a straight-through
estimator: the forward is round(clip(y, -qmax, qmax)), the gradient 1
where |y| <= qmax (both bounds included) and 0 outside. torch.clamp's
gradient is inclusive at both bounds, and torch.round rounds half to even
as jnp.round does, so `c + (round(c) - c).detach()` with c = clamp(y) is
that function and that gradient, and traces under torch.export (the
quantized layers export through jit.save). round(c) - c is exact in
floating point, so the forward equals round(c) bit for bit.

Scales are module buffers ('scale', 'initialized'), updated in place
under no_grad; the moving-average quanter picks its first value or the
average with torch.where on the 'initialized' buffer, so a training step
reads nothing back to the host.
"""
import torch
from torch import nn

from ..framework import device as device_mod
from ..nn.functional import conv2d, linear
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D

__all__ = [
    'fake_quant_dequant_abs_max', 'fake_quant_dequant_channel_wise',
    'fake_quant_dequant_with_scale', 'FakeQuantAbsMax',
    'FakeQuantMovingAverageAbsMax', 'QuantedLinear', 'QuantedConv2D',
    'QUANT_LAYER_MAP',
]

_EPS = 1e-9


def _ste_round_clip(y, qmax):
    c = torch.clamp(y, -qmax, qmax)
    return c + (torch.round(c) - c).detach()


def fake_quant_dequant_with_scale(x, scale, bits=8):
    """Quantize-dequantize against a given scale (per-tensor or broadcast).

    Gradient is straight-through inside the clip range, zero outside
    (reference fake_quantize_dequantize_moving_average_abs_max behavior).
    """
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.as_tensor(scale, dtype=x.dtype, device=x.device).clamp_min(
        _EPS)
    return _ste_round_clip(x / s * qmax, qmax) * s / qmax


def fake_quant_dequant_abs_max(x, bits=8):
    """Dynamic per-tensor abs-max quant-dequant (reference 'abs_max')."""
    return fake_quant_dequant_with_scale(x, x.detach().abs().max(), bits)


def fake_quant_dequant_channel_wise(w, bits=8, axis=0):
    """Per-output-channel abs-max (reference 'channel_wise_abs_max')."""
    red = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    scale = w.detach().abs().amax(dim=red, keepdim=True)
    return fake_quant_dequant_with_scale(w, scale, bits)


class FakeQuantAbsMax(nn.Module):
    """Weight quanter: dynamic abs-max each call (no state)."""

    def __init__(self, bits=8, channel_wise=False, axis=0):
        super().__init__()
        self._bits = bits
        self._channel_wise = channel_wise
        self._axis = axis

    def forward(self, x):
        if self._channel_wise:
            return fake_quant_dequant_channel_wise(x, self._bits, self._axis)
        return fake_quant_dequant_abs_max(x, self._bits)


class FakeQuantMovingAverageAbsMax(nn.Module):
    """Activation quanter: EMA of abs-max during training, frozen scale in
    eval (reference 'moving_average_abs_max', moving_rate=0.9). Its f32
    buffers live on `device` (the current device when None)."""

    def __init__(self, bits=8, moving_rate=0.9, *, device=None):
        super().__init__()
        self._bits = bits
        self._rate = moving_rate
        dev = device_mod.resolve(device)
        self.register_buffer('scale', torch.zeros([], device=dev))
        self.register_buffer('initialized',
                             torch.zeros([], dtype=torch.int32, device=dev))

    def forward(self, x):
        with torch.no_grad():
            cur = x.detach().abs().max().float()
            if self.training:
                scale = torch.where(self.initialized > 0,
                                    self._rate * self.scale +
                                    (1 - self._rate) * cur, cur)
                self.scale.copy_(scale)
                self.initialized.fill_(1)
            else:
                scale = torch.where(self.scale > 0, self.scale, cur)
        return fake_quant_dequant_with_scale(x, scale.to(x.dtype),
                                             self._bits)


def _make_weight_quanter(quantize_type, bits, axis):
    return FakeQuantAbsMax(bits=bits,
                           channel_wise=quantize_type == 'channel_wise_abs_max',
                           axis=axis)


def _make_act_quanter(quantize_type, bits, moving_rate, device):
    if quantize_type == 'moving_average_abs_max':
        return FakeQuantMovingAverageAbsMax(bits=bits,
                                            moving_rate=moving_rate,
                                            device=device)
    return FakeQuantAbsMax(bits=bits)


class QuantedLinear(nn.Module):
    """Linear with fake-quantized input and weight (qat.py QuantizedLinear).
    Shares the wrapped layer's weight and bias."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 moving_rate=0.9):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        # the weight is [in, out]: per-channel axis is 1
        self._weight_quanter = _make_weight_quanter(weight_quantize_type,
                                                    weight_bits, axis=1)
        self._act_quanter = _make_act_quanter(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        xq = self._act_quanter(x)
        wq = self._weight_quanter(self.weight)
        return linear(xq, wq, self.bias)


class QuantedConv2D(nn.Module):
    """Conv2D with fake-quantized input and weight (qat.py QuantizedConv2D).
    Shares the wrapped layer's weight and bias."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 moving_rate=0.9):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._stride = layer._stride
        self._padding = layer._padding
        self._dilation = layer._dilation
        self._groups = layer._groups
        self._data_format = getattr(layer, '_data_format', 'NCHW')
        # the weight is [out, in / groups, kh, kw]: per-channel axis 0
        self._weight_quanter = _make_weight_quanter(weight_quantize_type,
                                                    weight_bits, axis=0)
        self._act_quanter = _make_act_quanter(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        xq = self._act_quanter(x)
        wq = self._weight_quanter(self.weight)
        return conv2d(xq, wq, self.bias, stride=self._stride,
                      padding=self._padding, dilation=self._dilation,
                      groups=self._groups, data_format=self._data_format)


QUANT_LAYER_MAP = {
    'Linear': (Linear, QuantedLinear),
    'Conv2D': (Conv2D, QuantedConv2D),
}

# the reference's static-graph op names, accepted as aliases by both QAT
# and PTQ constructors
QUANT_TYPE_ALIASES = {
    'conv2d': 'Conv2D', 'depthwise_conv2d': 'Conv2D',
    'linear': 'Linear', 'mul': 'Linear', 'matmul': 'Linear',
}


def resolve_quant_types(types):
    """Normalize user-provided quantizable layer/op types to
    QUANT_LAYER_MAP keys; raises ValueError on unknown names."""
    out = []
    for t in types:
        key = t if isinstance(t, str) else t.__name__
        key = QUANT_TYPE_ALIASES.get(key, key)
        if key not in QUANT_LAYER_MAP:
            raise ValueError('unsupported quantizable type %r '
                             '(supported: %s + aliases %s)'
                             % (t, sorted(QUANT_LAYER_MAP),
                                sorted(QUANT_TYPE_ALIASES)))
        out.append(key)
    return tuple(dict.fromkeys(out))
