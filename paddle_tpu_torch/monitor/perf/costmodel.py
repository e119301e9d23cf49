"""Cost-model estimator: analytic FLOPs/bytes -> roofline + MFU
(counterpart of paddle_tpu/monitor/perf/costmodel.py).

The JAX package reads XLA's cost analysis of the compiled program. The
port counts the same two numbers by running the program on fake tensors
(``torch._subclasses.FakeTensorMode``: shapes and dtypes only, no device
memory, no kernel), so a full-width training step is priced without
running it:

  flops          — ``torch.utils.flop_counter.FlopCounterMode``'s count:
                   its formulas for the matmuls, convolutions and
                   attention, plus the formulas this module registers for
                   the port's four custom ops. The flash ops count the
                   products chip_smoke's kernel bounds count (2 of 2 * d
                   for each visible pair forward; 5 on the fused backward
                   route, 3 + 4 on the dq and dk/dv pair), the LM-head
                   loss ops their GEMMs (1 forward; 3 backward: the logits
                   again, dx and dw). Elementwise work (softmax, norms,
                   the optimizer update) counts 0, where XLA counts it.
                   A custom op of the port without a formula raises: it
                   is never counted as 0.
  bytes_accessed — the sum of every op's operand and result bytes (views
                   and allocations excluded): an UNFUSED count, each op
                   reading and writing memory on its own, so an upper
                   bound on what a fused program moves.

From these: arithmetic intensity (flops / bytes), the roofline bound
('compute' when the intensity clears the ridge peak_flops /
peak_bandwidth, else 'bandwidth'), ideal_step_s = max(flops / peak,
bytes / bandwidth), and, given a measured step time, mfu_est = flops /
step / peak and roofline_frac = ideal / step.

Peaks are the card's datasheet figures (dense, no sparsity) by SKU,
matched on ``torch.cuda.get_device_name()`` (SKUS; chip_smoke bounds its
kernels with the same table); 'cpu' is a nominal comparator, not a
hardware figure.
"""
import contextlib

import torch

__all__ = ['SKUS', 'sku', 'PEAKS', 'platform_peaks', 'flash_pairs',
           'flash_fwd_flops', 'flash_bwd_flops', 'BWD_PRODUCTS', 'count',
           'cost_of', 'roofline', 'estimate', 'record']

# Datasheet peaks (dense, no sparsity) by SKU, matched against the card's
# name: (memory bytes/s, {dtype: operations/s}). The H100 SXM figures are
# the default for an H100 whose name matches no other row. f32 products at
# f32 accuracy run as three TF32 tensor-core products each (split TF32, the
# f32 flash kernels at d = 64 / 128), so the card's f32 rate is its TF32
# peak over 3 (H100 SXM: 495e12 / 3 = 165e12); 'float32_cuda_cores' is
# the FFMA rate of the CUDA cores.
SKUS = [
    ('H100 PCIe', 2.0e12, {'bfloat16': 756e12, 'float16': 756e12,
                           'float32': 378e12 / 3,
                           'float32_cuda_cores': 51e12}),
    ('H100 NVL', 3.9e12, {'bfloat16': 835e12, 'float16': 835e12,
                          'float32': 417.5e12 / 3,
                          'float32_cuda_cores': 60e12}),
    ('H100', 3.35e12, {'bfloat16': 989e12, 'float16': 989e12,
                       'float32': 495e12 / 3,
                       'float32_cuda_cores': 67e12}),
]

# platform -> (peak FLOP/s at bf16, peak bytes/s): every SKU row, and a
# nominal CPU comparator (the JAX package's)
PEAKS = dict({key: (ops['bfloat16'], bw) for key, bw, ops in SKUS},
             cpu=(1e12, 50e9))


def sku(name):
    """(key, bytes/s, {dtype: ops/s}) of the first SKU row whose key is in
    the card's name; raises for a card with no row."""
    for key, bw, ops in SKUS:
        if key in name:
            return key, bw, ops
    raise RuntimeError('no datasheet figures for %r' % name)


def platform_peaks(platform=None, peak_flops=None, peak_bandwidth=None,
                   dtype='bfloat16'):
    """(platform, peak_flops, peak_bytes_per_s) with overrides applied.
    platform None is the card when CUDA is available, else 'cpu'; 'gpu'
    is the card, looked up by its name in SKUS (raising when it has no
    row); a SKUS key names a row. `dtype` picks the row's rate."""
    if platform is None:
        platform = 'gpu' if torch.cuda.is_available() else 'cpu'
    if platform == 'gpu':
        platform = sku(torch.cuda.get_device_name(0))[0]
    if platform == 'cpu':
        pf, pb = PEAKS['cpu']
    else:
        key, pb, ops = sku(platform)
        platform, pf = key, ops[str(dtype).replace('torch.', '')]
    return (platform,
            float(peak_flops) if peak_flops else pf,
            float(peak_bandwidth) if peak_bandwidth else pb)


# ---- the flash products -------------------------------------------------

# products of 2 * d flops a visible pair, per backward kernel
BWD_PRODUCTS = {'fused': 5, 'dq': 3, 'dkv': 4}


def flash_pairs(n, m, causal):
    """(query, key) pairs the kernels visit: all n * m, or causal
    (top-left, row i sees keys 0..i) the visible ones."""
    if not causal:
        return n * m
    if n <= m:
        return n * (n + 1) // 2
    return m * (m + 1) // 2 + (n - m) * m


def flash_fwd_flops(b, h, n, m, d, causal):
    """The flash forward's products: s = q k^T and o = p v, 2 * d flops
    each a visible pair."""
    return 4 * d * b * h * flash_pairs(n, m, causal)


def flash_bwd_flops(b, h, n, m, d, causal, which):
    """A backward kernel's products: `which` 'fused' (5), 'dq' (3) or
    'dkv' (4) of 2 * d flops a visible pair."""
    return BWD_PRODUCTS[which] * 2 * d * b * h * flash_pairs(n, m, causal)


def _register_formulas():
    """FlopCounterMode formulas for the port's custom ops (called once,
    at import). The flash backward takes the route the op takes."""
    from torch.utils.flop_counter import register_flop_formula
    from ...ops import flash_attention as fa
    from ...ops import fused_ce  # noqa: F401 — registers the CE ops
    ops = torch.ops.paddle_tpu_torch

    @register_flop_formula(ops.flash_fwd)
    def _fwd(q, k, v, causal, scale, *args, out_val=None, **kwargs):
        b, h, n, d = q
        return flash_fwd_flops(b, h, n, k[2], d, causal)

    @register_flop_formula(ops.flash_bwd)
    def _bwd(q, k, v, o, lse, do, causal, scale, *args, out_val=None,
             **kwargs):
        b, h, n, d = q
        m = k[2]
        if not fa._use_long_path(n, m) and \
                max(n, m) <= fa.FUSED_BWD_MAX_SEQ:
            return flash_bwd_flops(b, h, n, m, d, causal, 'fused')
        return (flash_bwd_flops(b, h, n, m, d, causal, 'dq') +
                flash_bwd_flops(b, h, n, m, d, causal, 'dkv'))

    @register_flop_formula(ops.linear_ce_fwd)
    def _ce_fwd(x, w, labels, bias, *args, out_val=None, **kwargs):
        return 2 * x[0] * x[1] * w[1]

    @register_flop_formula(ops.linear_ce_bwd)
    def _ce_bwd(g, x, w, labels, *args, out_val=None, **kwargs):
        # the logits tile again, dx = p w^T and dw = x^T p
        return 3 * 2 * x[0] * x[1] * w[1]


_register_formulas()


# ---- counting -----------------------------------------------------------

def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums every op's operand and result bytes (views and allocations
    excluded), and refuses a custom op of the port with no flop
    formula."""

    _FREE = ('empty', 'new_empty', 'empty_like', 'empty_strided',
             'new_empty_strided', 'detach', 'alias', 'lift_fresh')

    def __init__(self, flop_registry):
        super().__init__()
        self.bytes = 0
        self._registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == 'paddle_tpu_torch' and \
                packet not in self._registry:
            raise RuntimeError(
                'the cost model has no flop formula for %s: register one '
                'with torch.utils.flop_counter.register_flop_formula'
                % func)
        if not func.is_view and func.__name__.split('.')[0] \
                not in self._FREE:
            seen = set()
            for t in _tensors((args, kwargs, out)):
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def _counting(mode):
    """Count FLOPs and bytes of what runs inside, on fake tensors of
    `mode`. Yields a dict filled in at exit."""
    from torch.utils.flop_counter import FlopCounterMode
    result = {}
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter(flops.flop_registry)
    with mode, flops, nbytes:
        yield result
    result['flops'] = float(flops.get_total_flops())
    result['bytes_accessed'] = float(nbytes.bytes)


def _fake_mode(allow_real=False):
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=allow_real)


def _faked(mode, tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda a: mode.from_tensor(a, static_shapes=True)
                    if isinstance(a, torch.Tensor) else a, tree)


def count(fn, *args, **kwargs):
    """{'flops', 'bytes_accessed'} of fn(*args, **kwargs) run on fake
    copies of its tensor arguments (tensors it closes over are faked as
    it reads them). Nothing runs on the device."""
    mode = _fake_mode(allow_real=True)
    fargs, fkwargs = _faked(mode, (args, kwargs))
    with _counting(mode) as out:
        fn(*fargs, **fkwargs)
    return out


def _count_train_step(step, inputs, labels):
    """The FLOPs and bytes of one TrainStep call on (inputs, labels):
    forward, loss, backward and the optimizer's update, run on fake
    copies of the parameters, buffers, inputs and optimizer slots (the
    step's own state is left as it was). AMP casts and remat are taken
    as the step takes them."""
    from torch.nn.utils.stateless import _reparametrize_module
    from torch.utils.checkpoint import checkpoint
    if not isinstance(inputs, (list, tuple)):
        inputs = (inputs,)
    if not isinstance(labels, (list, tuple)):
        labels = (labels,)
    model, opt, amp = step.model, step.optimizer, step._amp_dtype
    mode = _fake_mode()
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    fake = {name: _faked(mode, t) for name, t in state.items()}
    fin, flab = _faked(mode, (tuple(inputs), tuple(labels)))
    made = []
    was_training = model.training
    model.train()
    try:
        with _counting(mode) as out:
            if amp is not None:
                fake = {n: t.to(amp) if t.is_floating_point() else t
                        for n, t in fake.items()}
                fin = tuple(a.to(amp) if torch.is_tensor(a) and
                            a.is_floating_point() else a for a in fin)
            params = [fake[name] for name, _ in step._params]

            def compute(*args):
                o = model(*args[:len(fin)])
                outs = o if isinstance(o, (list, tuple)) else (o,)
                loss = step.loss_fn(*outs, *args[len(fin):])
                return loss.float() if amp is not None else loss

            # the loss function may read the model's parameters too (a
            # tied LM head): both run on the fake ones
            with step._scope(), _reparametrize_module(model, fake):
                loss = (checkpoint(compute, *fin, *flab, use_reentrant=False)
                        if step._remat else compute(*fin, *flab))
                grads = torch.autograd.grad(loss, params,
                                            allow_unused=True)
            named = []
            for (name, p), fp, g in zip(step._params, params, grads):
                fp = fp.detach()
                made.append(fp)
                named.append((opt._name_for(p, name), fp,
                              torch.zeros_like(fp) if g is None else
                              g.to(fp.dtype)))
            opt._update(named, opt.get_lr(), opt._step_count + 1,
                        lr_is_f32=True)
    finally:
        model.train(was_training)
        for fp in made:
            opt._slots.pop(id(fp), None)
    return out


def cost_of(program, *args):
    """{'flops', 'bytes_accessed'} of a program on example arguments: a
    TrainStep with (inputs, labels), or any callable with its
    arguments. None when nothing was counted."""
    from ...framework.functional import TrainStep
    if isinstance(program, TrainStep):
        cost = _count_train_step(program, *args)
    else:
        cost = count(program, *args)
    if cost['flops'] <= 0.0 and cost['bytes_accessed'] <= 0.0:
        return None
    return cost


def roofline(flops, bytes_accessed, platform=None, peak_flops=None,
             peak_bandwidth=None, dtype='bfloat16'):
    """Roofline classification of an analytic (flops, bytes) point."""
    platform, pf, pb = platform_peaks(platform, peak_flops,
                                      peak_bandwidth, dtype=dtype)
    intensity = (flops / bytes_accessed) if bytes_accessed > 0 \
        else float('inf')
    ridge = pf / pb
    return {
        'platform': platform,
        'peak_flops': pf,
        'peak_bandwidth': pb,
        'arithmetic_intensity': intensity,
        'ridge_intensity': ridge,
        'roofline_bound': 'compute' if intensity >= ridge
        else 'bandwidth',
        'ideal_step_s': max(flops / pf, bytes_accessed / pb),
    }


def estimate(program, args=None, step_seconds=None, platform=None,
             peak_flops=None, peak_bandwidth=None, dtype='bfloat16'):
    """Full cost-model estimate of a program: a TrainStep (args =
    (inputs, labels)), a callable (args = its arguments), or a precounted
    {'flops', 'bytes_accessed'} dict (args None). Returns the counts +
    roofline fields, plus 'measured_step_s' / 'mfu_est' /
    'roofline_frac' when a measured wall time is given; None when
    nothing was counted."""
    if isinstance(program, dict):
        cost = {'flops': float(program['flops']),
                'bytes_accessed': float(program['bytes_accessed'])}
    else:
        cost = cost_of(program, *(args or ()))
    if cost is None:
        return None
    est = dict(cost)
    est.update(roofline(cost['flops'], cost['bytes_accessed'],
                        platform=platform, peak_flops=peak_flops,
                        peak_bandwidth=peak_bandwidth, dtype=dtype))
    if step_seconds and step_seconds > 0:
        est['measured_step_s'] = float(step_seconds)
        est['mfu_est'] = cost['flops'] / step_seconds / est['peak_flops']
        ideal = est['ideal_step_s']
        est['roofline_frac'] = (ideal / step_seconds) if ideal else 0.0
    return est


def record(est, registry=None):
    """Publish an estimate onto the perf gauges (mfu_est, arithmetic
    intensity, roofline bound as 0=bandwidth/1=compute) so telemetry
    snapshots carry the cost-model block."""
    from ..registry import default_registry
    from ..telemetry import record_perf_schema
    if not est:
        return None
    reg = registry if registry is not None else default_registry()
    fams = record_perf_schema(reg)
    if 'mfu_est' in est:
        fams['perf_mfu_est'].set(est['mfu_est'])
    intensity = est.get('arithmetic_intensity')
    if intensity is not None and intensity != float('inf'):
        fams['perf_arithmetic_intensity'].set(intensity)
    fams['perf_roofline_bound'].set(
        1.0 if est.get('roofline_bound') == 'compute' else 0.0)
    return reg
