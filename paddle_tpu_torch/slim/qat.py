"""Imperative quantization-aware training (counterpart of
paddle_tpu/slim/qat.py).

Parity: python/paddle/fluid/contrib/slim/quantization/imperative/qat.py:40
(ImperativeQuantAware.quantize walks the model and swaps quantizable layers
for fake-quant wrappers; save_quantized_model exports for inference). The
walk is the JAX package's over torch's modules: every module's `_modules`,
exact-type matching, one wrapper for a layer shared at several paths.
"""
from torch import nn

from .quant_layers import QUANT_LAYER_MAP, resolve_quant_types

__all__ = ['ImperativeQuantAware']


class ImperativeQuantAware:
    def __init__(self, quantizable_layer_type=('Conv2D', 'Linear'),
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 weight_bits=8, activation_bits=8, moving_rate=0.9,
                 weight_preprocess_layer=None, act_preprocess_layer=None,
                 weight_quantize_layer=None, act_quantize_layer=None):
        types = resolve_quant_types(quantizable_layer_type)
        if weight_quantize_type not in ('abs_max', 'channel_wise_abs_max'):
            raise ValueError('weight_quantize_type must be abs_max or '
                             'channel_wise_abs_max')
        if activation_quantize_type not in ('abs_max',
                                            'moving_average_abs_max'):
            raise ValueError('activation_quantize_type must be abs_max or '
                             'moving_average_abs_max')
        if any(l is not None for l in (weight_preprocess_layer,
                                       act_preprocess_layer,
                                       weight_quantize_layer,
                                       act_quantize_layer)):
            raise NotImplementedError(
                'custom preprocess/quantize layers are not supported yet; '
                'use weight_quantize_type/activation_quantize_type')
        self._types = types
        self._wq_type = weight_quantize_type
        self._aq_type = activation_quantize_type
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate

    def _wrap(self, layer, memo):
        for tname in self._types:
            cls, quanted = QUANT_LAYER_MAP[tname]
            if type(layer) is cls:
                if getattr(layer, 'skip_quant', False):
                    return layer
                # a layer shared at several model paths gets ONE wrapper
                # (so e.g. PTQ scale assignment covers every path)
                if id(layer) not in memo:
                    memo[id(layer)] = quanted(
                        layer, weight_bits=self._wbits,
                        activation_bits=self._abits,
                        weight_quantize_type=self._wq_type,
                        activation_quantize_type=self._aq_type,
                        moving_rate=self._rate)
                return memo[id(layer)]
        return layer

    def quantize(self, model):
        """In-place: swap quantizable sublayers for fake-quant wrappers.
        Returns the model (reference returns None; returning it is a strict
        superset)."""
        if not isinstance(model, nn.Module):
            raise TypeError('quantize expects a paddle Layer')
        memo = {}
        for layer in list(model.modules()):
            for name, sub in list(layer._modules.items()):
                if sub is not None:
                    layer._modules[name] = self._wrap(sub, memo)
        return model

    def save_quantized_model(self, layer, path, input_spec=None, **config):
        from .. import jit
        layer.eval()
        jit.save(layer, path, input_spec=input_spec, **config)
