"""KL-divergence calibration threshold (a copy of
paddle_tpu/slim/cal_kl_threshold.py: numpy only).

Parity: python/paddle/fluid/contrib/slim/quantization/cal_kl_threshold.py
(the TensorRT-style entropy calibration: pick the clip threshold whose
quantized distribution has minimal KL divergence from the original
histogram).
"""

import numpy as np

__all__ = ['cal_kl_threshold']


def _expand_quantized_bins(quantized_bins, reference_bins):
    """Spread each quantized bin's mass uniformly over its nonzero source
    bins (zero-count source bins stay zero). Vectorized: the search loop
    calls this ~hist_bins/2 times per layer."""
    n_ref = len(reference_bins)
    n_q = len(quantized_bins)
    num_merged = n_ref // n_q if n_q else 0
    if num_merged == 0:
        return np.zeros(n_ref, np.float64)
    # group index per reference bin; the last group absorbs the remainder
    groups = np.minimum(np.arange(n_ref) // num_merged, n_q - 1)
    nonzero = np.asarray(reference_bins) != 0
    nz_per_group = np.bincount(groups[nonzero], minlength=n_q)
    with np.errstate(divide='ignore', invalid='ignore'):
        avg = np.where(nz_per_group > 0,
                       np.asarray(quantized_bins) / np.maximum(nz_per_group,
                                                               1), 0.0)
    return np.where(nonzero, avg[groups], 0.0)


def _safe_kl(reference, candidate):
    """KL(reference || candidate) over matching bins, skipping zeros."""
    total = float(np.sum(reference))
    if total <= 0:
        return float('inf')
    p_pos = reference > 0
    if np.any(p_pos & (candidate <= 0)):
        return float('inf')
    p = reference[p_pos]
    q = candidate[p_pos]
    return float(np.sum(p * np.log(p / q))) / total


def cal_kl_threshold(hist, bin_width, bits):
    """Return the activation clip threshold for `hist` (histogram of |x|).

    hist: counts over [0, abs_max); bin_width: abs_max/len(hist);
    bits: target bit width (8 → 127 positive quant levels, matching the
    reference's 2**(bits-1)-1).
    """
    assert hist.ndim == 1
    hist_bins = len(hist)
    starting_iter = hist_bins // 2
    quant_range = 2 ** (bits - 1) - 1

    p_sum = float(np.sum(hist))
    if p_sum <= 0 or hist_bins <= quant_range:
        return bin_width * hist_bins

    min_kl = float('inf')
    best_i = hist_bins
    for i in range(starting_iter, hist_bins + 1):
        reference = hist[:i].astype(np.float64).copy()
        # outliers beyond i clip into the last bin
        reference[-1] += float(np.sum(hist[i:]))
        if reference[-1] == 0 or quant_range >= i:
            continue
        # quantize reference into quant_range merged bins
        num_merged = i // quant_range
        used = num_merged * quant_range
        q = reference[:used].reshape(quant_range, num_merged).sum(axis=1)
        q[-1] += float(np.sum(reference[used:]))
        candidate = _expand_quantized_bins(q, reference)
        kl = _safe_kl(reference, candidate)
        if kl < min_kl:
            min_kl = kl
            best_i = i
    return (best_i + 0.5) * bin_width
