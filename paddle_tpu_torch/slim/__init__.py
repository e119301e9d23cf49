"""Model compression (counterpart of paddle_tpu/slim/): quantization-aware
training, post-training quantization and weight-only int8 for serving.

Reference: python/paddle/fluid/contrib/slim/ — imperative/qat.py
(ImperativeQuantAware), post_training_quantization.py,
cal_kl_threshold.py. As in the JAX package, one mechanism (swapping
layers for quantized wrappers) serves both, and the observers, KL
thresholds and histograms run in numpy on the host.
"""
from .cal_kl_threshold import cal_kl_threshold
from .ptq import ImperativePTQ, PostTrainingQuantization
from .qat import ImperativeQuantAware
from .quant_layers import (FakeQuantAbsMax, FakeQuantMovingAverageAbsMax,
                           QuantedConv2D, QuantedLinear,
                           fake_quant_dequant_abs_max,
                           fake_quant_dequant_channel_wise,
                           fake_quant_dequant_with_scale)
from .weight_only import (WeightOnlyLinear, quantize_weight_only,
                          streamed_bytes)

__all__ = [
    'ImperativeQuantAware', 'PostTrainingQuantization', 'ImperativePTQ',
    'cal_kl_threshold', 'QuantedLinear', 'QuantedConv2D', 'FakeQuantAbsMax',
    'FakeQuantMovingAverageAbsMax', 'fake_quant_dequant_abs_max',
    'fake_quant_dequant_channel_wise', 'fake_quant_dequant_with_scale',
    'WeightOnlyLinear', 'quantize_weight_only', 'streamed_bytes',
]
