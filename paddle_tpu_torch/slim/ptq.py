"""Post-training quantization (counterpart of paddle_tpu/slim/ptq.py).

Parity: python/paddle/fluid/contrib/slim/quantization/
post_training_quantization.py:124 (PostTrainingQuantization: run calibration
batches, sample activation ranges with abs_max/avg/mse/KL, then emit a
quantized model) and imperative/ptq.py (ImperativePTQ). Forward pre-hooks
on the live model hand each quantizable layer's input to an observer,
which collects its range statistics in numpy on the host, as in the JAX
package (one copy to the host a layer and batch); then the quantizable
layers are swapped for fake-quant wrappers with frozen calibrated scales.
"""
import inspect

import numpy as np
import torch

from .cal_kl_threshold import cal_kl_threshold
from .qat import ImperativeQuantAware
from .quant_layers import (QUANT_LAYER_MAP, FakeQuantMovingAverageAbsMax,
                           QuantedConv2D, QuantedLinear,
                           resolve_quant_types)

__all__ = ['PostTrainingQuantization', 'ImperativePTQ']

_ALGOS = ('abs_max', 'avg', 'mse', 'KL', 'hist')


class _Observer:
    """Collects activation range stats for one layer's input."""

    def __init__(self, algo, bits, hist_bins=2048, hist_percent=0.99999):
        self.algo = algo
        self.bits = bits
        self.hist_bins = hist_bins
        self.hist_percent = hist_percent
        self.abs_max = 0.0
        self.batch_maxes = []
        self.samples = []
        self.hist = None
        self.hist_range = 0.0
        self._mse_rng = np.random.RandomState(0)

    def _rebin(self, new_range):
        """Proportionally redistribute hist counts from [0, hist_range)
        into [0, new_range) so batches with growing ranges merge correctly
        (the reference re-bins before merging too)."""
        old = self.hist
        bins = self.hist_bins
        out = np.zeros(bins, np.float64)
        ratio = self.hist_range / new_range
        for i in range(bins):
            if old[i] == 0:
                continue
            lo = i * ratio
            hi = (i + 1) * ratio
            j0, j1 = int(lo), min(int(np.ceil(hi)), bins)
            width = hi - lo
            for j in range(j0, j1):
                overlap = min(hi, j + 1) - max(lo, j)
                if overlap > 0:
                    out[j] += old[i] * overlap / width
        self.hist = out
        self.hist_range = new_range

    def observe(self, arr):
        arr = np.asarray(arr, np.float32)
        amax = float(np.max(np.abs(arr))) if arr.size else 0.0
        self.abs_max = max(self.abs_max, amax)
        self.batch_maxes.append(amax)
        if self.algo == 'mse':
            # subsample to bound memory (collisions are harmless here, so a
            # plain randint draw beats an O(n) no-replacement permutation)
            flat = arr.reshape(-1)
            if flat.size > 1 << 16:
                # persistent rng: each batch samples different positions
                idx = self._mse_rng.randint(0, flat.size, 1 << 16)
                flat = flat[idx]
            self.samples.append(flat)
        elif self.algo in ('KL', 'hist'):
            rng_hi = max(self.abs_max, 1e-8)
            if self.hist is None:
                self.hist = np.zeros(self.hist_bins, np.float64)
                self.hist_range = rng_hi
            elif rng_hi > self.hist_range:
                self._rebin(rng_hi)
            h, _ = np.histogram(np.abs(arr), bins=self.hist_bins,
                                range=(0.0, self.hist_range))
            self.hist += h

    def scale(self):
        if self.algo == 'abs_max':
            return self.abs_max
        if self.algo == 'avg':
            return float(np.mean(self.batch_maxes)) if self.batch_maxes \
                else 0.0
        if self.algo == 'mse':
            return self._mse_scale()
        if self.algo == 'KL':
            if self.hist is None:
                return self.abs_max
            bin_width = self.hist_range / self.hist_bins
            return cal_kl_threshold(self.hist, bin_width, self.bits)
        if self.algo == 'hist':
            if self.hist is None:
                return self.abs_max
            cum = np.cumsum(self.hist) / max(np.sum(self.hist), 1)
            idx = int(np.searchsorted(cum, self.hist_percent))
            return (idx + 0.5) * self.hist_range / self.hist_bins
        raise ValueError(self.algo)

    def _mse_scale(self):
        if not self.samples:
            return self.abs_max
        x = np.concatenate(self.samples)
        qmax = 2 ** (self.bits - 1) - 1
        best, best_s = None, self.abs_max
        for frac in np.linspace(0.3, 1.0, 36):
            s = self.abs_max * frac
            if s <= 0:
                continue
            xq = np.clip(np.round(x / s * qmax), -qmax, qmax) * s / qmax
            mse = float(np.mean((x - xq) ** 2))
            if best is None or mse < best:
                best, best_s = mse, s
        return best_s


def _host_f32(x):
    """A layer input as an f32 numpy array on the host."""
    if torch.is_tensor(x):
        return x.detach().to('cpu', torch.float32).numpy()
    return np.asarray(x, np.float32)


class PostTrainingQuantization:
    """Calibrate a Layer on sample data and return a fake-quantized model.

    Differences from the reference ctor are deliberate (no executor or
    scope): pass the live model + a data source. `data_loader` yields
    either tensors (fed as the single input) or tuples/lists (fed
    positionally; trailing entries beyond forward's positional parameters,
    such as a label, are dropped).
    """

    def __init__(self, model=None, data_loader=None, batch_nums=10,
                 algo='abs_max', hist_percent=0.99999, bins=2048,
                 quantizable_op_type=('Conv2D', 'Linear'),
                 weight_bits=8, activation_bits=8,
                 weight_quantize_type='channel_wise_abs_max',
                 onnx_format=False, **_compat):
        if algo not in _ALGOS:
            raise ValueError('algo must be one of %s' % (_ALGOS,))
        if model is None or data_loader is None:
            raise ValueError('model and data_loader are required')
        if weight_quantize_type not in ('abs_max', 'channel_wise_abs_max'):
            raise ValueError('weight_quantize_type must be abs_max or '
                             'channel_wise_abs_max')
        self._model = model
        self._loader = data_loader
        self._batch_nums = batch_nums
        self._algo = algo
        self._bins = bins
        self._hist_percent = hist_percent
        self._types = resolve_quant_types(quantizable_op_type)
        self._wbits = weight_bits
        self._abits = activation_bits
        self._wq_type = weight_quantize_type
        self._scales = {}

    def _target_layers(self):
        classes = tuple(QUANT_LAYER_MAP[t][0] for t in self._types)
        for name, sub in self._model.named_modules():
            if name and type(sub) in classes and \
                    not getattr(sub, 'skip_quant', False):
                yield name, sub

    def quantize(self):
        # 1. observe activation ranges via pre-hooks
        observers, removes = {}, []
        for name, sub in self._target_layers():
            obs = _Observer(self._algo, self._abits, self._bins,
                            self._hist_percent)
            observers[name] = obs

            def hook(layer, inputs, _obs=obs):
                _obs.observe(_host_f32(inputs[0]))
                return None
            removes.append(sub.register_forward_pre_hook(hook))

        # decide feed arity up front (no retry — a retry after a mid-model
        # TypeError would double-count observations on early layers).
        # Count ALL positional params (optional ones included: a loader may
        # legitimately supply them); only the surplus beyond that — e.g. a
        # trailing label — is dropped.
        n_feed = None
        try:
            sig = inspect.signature(self._model.forward)
            ps = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
            if not any(p.kind == p.VAR_POSITIONAL
                       for p in sig.parameters.values()):
                n_feed = len(ps)
        except (TypeError, ValueError):
            pass

        self._model.eval()
        seen = 0
        try:
            with torch.no_grad():
                for batch in self._loader:
                    args = batch if isinstance(batch, (tuple, list)) \
                        else (batch,)
                    if n_feed is not None and len(args) > n_feed:
                        args = args[:n_feed]  # drop trailing label entries
                    self._model(*args)
                    seen += 1
                    if self._batch_nums and seen >= self._batch_nums:
                        break
        finally:
            # never leave observer hooks on the user's live model
            for r in removes:
                r.remove()
        if seen == 0:
            raise RuntimeError('data_loader yielded no calibration batches')

        # 2. swap in quanted layers with frozen calibrated scales
        quanter = ImperativeQuantAware(
            quantizable_layer_type=self._types,
            weight_quantize_type=self._wq_type,
            activation_quantize_type='moving_average_abs_max',
            weight_bits=self._wbits, activation_bits=self._abits)
        quanter.quantize(self._model)
        for name, sub in self._model.named_modules():
            if isinstance(sub, (QuantedLinear, QuantedConv2D)):
                # the wrapper replaced the original at the same name path
                obs = observers.get(name)
                if obs is None:
                    continue
                s = float(obs.scale())
                self._scales[name] = s
                aq = sub._act_quanter
                if isinstance(aq, FakeQuantMovingAverageAbsMax):
                    with torch.no_grad():
                        aq.scale.fill_(s)
                        aq.initialized.fill_(1)
        self._model.eval()
        return self._model

    @property
    def scales(self):
        return dict(self._scales)

    def save_quantized_model(self, save_model_path, input_spec=None,
                             **config):
        from .. import jit
        jit.save(self._model, save_model_path, input_spec=input_spec,
                 **config)


ImperativePTQ = PostTrainingQuantization
