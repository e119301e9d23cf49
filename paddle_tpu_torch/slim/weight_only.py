"""Weight-only int8 quantization for the serving/decode path (counterpart
of paddle_tpu/slim/weight_only.py).

Different animal from the QDQ fake-quant in quant_layers.py: the weights
are STORED as int8 with a per-output-channel f32 scale (symmetric abs-max
over the [in, out] weight, quant_layers' channel-wise axis 1), held as
buffers named as the JAX package names them ('qweight', 'weight_scale'),
so a state dict carries across with load_paddle_tpu_state.

The forward dequantizes the whole weight to the source weight's dtype
(`q.to(cd) * scale.to(cd)`, as the JAX package computes it), then runs the
plain matmul. XLA fuses that dequantization into the matmul's operand
read; in torch it materializes a 16-bit weight every call, so a decode
step here reads the int8 weight, writes and reads a 16-bit one: more
bytes than the unquantized layer, not half. `streamed_bytes` counts what
the model holds (the decode roofline's denominator), the JAX package's
rule. A fused dequant-GEMM kernel would give the halved bytes.

Inference-only: the int8 buffer is not a Parameter, so training through
a WeightOnlyLinear raises rather than silently freezing the weight.
"""
import torch
from torch import nn

from ..nn.functional import linear
from ..nn.layer.common import Linear

__all__ = ['WeightOnlyLinear', 'quantize_weight_only', 'streamed_bytes']

_EPS = 1e-8


def _quantize_int8(w):
    """Per-output-channel symmetric int8: w[in, out] -> (q int8, scale f32).
    The divisions are true divisions on every device (CUDA divides by a
    Python scalar as a multiplication by its reciprocal, an ulp off), so
    the card quantizes as the CPU and the JAX package do."""
    wf = w.detach().float()
    scale = torch.clamp_min(wf.abs().amax(dim=0) / wf.new_tensor(127.0),
                            _EPS)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(
        torch.int8)
    return q, scale


class WeightOnlyLinear(nn.Module):
    """Linear whose weight lives as int8 + per-channel scale buffers.

    Built FROM a trained Linear (same swap-in pattern as
    slim.QuantedLinear), on its device. It has no `weight`: code that
    needs one reads `getattr(layer, 'weight', None)`. A weight laid out
    over a device mesh (tensor-parallel 'mp', ZeRO-3) is refused: the int8
    buffers carry no placement.
    """

    def __init__(self, layer):
        super().__init__()
        from torch.distributed.tensor import DTensor
        w = layer.weight
        if isinstance(w, DTensor):
            raise ValueError(
                'WeightOnlyLinear cannot quantize a weight laid out over a '
                "device mesh (tensor parallelism over 'mp', ZeRO-3): its "
                'int8 buffers carry no placement. Quantize the unsharded '
                'model and serve it on one card')
        self.in_features = layer.in_features
        self.out_features = layer.out_features
        # compute dtype follows the source weight (bf16 in bf16 serving)
        self._compute_dtype = w.dtype
        q, scale = _quantize_int8(w)
        self.register_buffer('qweight', q)
        self.register_buffer('weight_scale', scale)
        self.bias = layer.bias
        # inherit the source layer's mode: a model already in eval() must
        # stay servable after the swap without another .eval() call
        self.training = layer.training

    def forward(self, x):
        if self.training:
            raise RuntimeError(
                'WeightOnlyLinear is inference-only (int8 weights are not '
                'trainable) — call model.eval(), or quantize after training')
        cd = self._compute_dtype
        w = self.qweight.to(cd) * self.weight_scale.to(cd)
        return linear(x, w, self.bias)

    def extra_repr(self):
        return 'in_features=%d, out_features=%d, int8-weight' % (
            self.in_features, self.out_features)


def streamed_bytes(model):
    """Bytes of model state one decode step streams: all parameters plus
    the buffers (int8 qweights count 1 byte an element, their scales
    count too), each tensor once. The denominator of the decode roofline
    `steps/s <= bandwidth / streamed_bytes`, one rule for the quantized
    and the full-precision model.
    """
    total = 0
    for _, p in model.named_parameters():
        total += int(p.nbytes)
    for _, b in model.named_buffers():
        if b is not None:
            total += int(b.nbytes)
    return float(total)


def quantize_weight_only(model, exclude=None):
    """Swap every Linear sublayer for WeightOnlyLinear, in place.

    exclude: optional predicate (qualified_name, layer) -> bool; True
    keeps that Linear in full precision (e.g. a final logits head whose
    accuracy budget is tighter). Returns the number of layers swapped.

    Embeddings stay full precision by design: a gather reads only the
    touched rows, so there is no bandwidth to win, and the tied-head
    matmul (GPT wte reuse) shares the same storage.
    """
    if type(model) is Linear:
        # the root layer cannot be swapped in place — the caller's own
        # reference IS the Linear (unless the exclude predicate keeps the
        # root fp on purpose, which really is a no-op)
        if exclude is not None and exclude('', model):
            return 0
        raise ValueError(
            'quantize_weight_only cannot swap a bare root nn.Linear in '
            'place — wrap it yourself: model = WeightOnlyLinear(model)')
    # snapshot the walk first: swapping children while the walk is
    # mid-descent would make it recurse into the replacement layers
    sites = []          # (parent, key, child) for every Linear occurrence
    excluded = set()    # id(child): exclusion is by layer IDENTITY — if
    #                     ANY alias of a shared Linear is excluded, every
    #                     alias stays fp (a partial swap would silently
    #                     break the sharing)
    for pname, parent in list(model.named_modules()):
        for key, child in list(parent._modules.items()):
            if type(child) is Linear:
                sites.append((parent, key, child))
                qual = '%s.%s' % (pname, key) if pname else key
                if exclude is not None and exclude(qual, child):
                    excluded.add(id(child))
    swapped = 0
    done = {}  # id(original) -> replacement: a shared Linear stays shared
    for parent, key, child in sites:
        if id(child) in excluded:
            continue
        rep = done.get(id(child))
        if rep is None:
            rep = done[id(child)] = WeightOnlyLinear(child)
            swapped += 1
        parent._modules[key] = rep
    return swapped
