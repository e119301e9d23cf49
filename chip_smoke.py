"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure exits non-zero:
  1. build   - nvcc builds every kernel of the paths from
               paddle_tpu_torch/csrc, one process per source, in parallel.
  2. kernel  - each kernel against its plain PyTorch version on the card at
               the paths' shapes and more, with times, the card's bound
               and a PyTorch library call's time as a yardstick. A
               kernel's `ms` is its device time, launches replayed from a
               CUDA graph; `eager_ms` times the same launches from Python,
               wrapper included. Two launches of each dq entry on the same
               inputs must give bitwise-equal dq; the fused backward's two
               kernels are timed apart under the profiler.
  3. slice 1, f32  - GPT-2 small (seeded weights) prefill logits on the card
               against the same weights on the CPU plain path; greedy tokens.
  4. slice 1, bf16 - serving: generate() on 8 prompts of 768 tokens, 128 new
               tokens, greedy, timed as the median of 3 calls; the flash
               forward must launch exactly once per layer. A 64-token run
               must not launch it.
  5. slice 2, f32  - one AdamW TrainStep of the bench's GPT cut to 2 layers
               (full width and vocabulary, batch 2 x 512) on the card
               against the same step on the CPU plain path.
  6. slice 2, bf16 - training, the main path: the bench's configuration
               (vocab 30528, hidden 768, 12 layers, 12 heads, batch 32 x
               seq 512, bf16, fused loss, AdamW lr 1e-4); 2 warm-up and 10
               timed steps, 12 flash forward and 12 fused backward launches
               a step, falling loss on the fixed batch, and a profile.
  7. slice 2, seq 1024 - GPT-2 small training at batch 8 x 1024 tokens, the
               two-pass backward: 12 dq and 12 dk/dv launches a step.
  8. long kernels - the long route's forward, dq and dk/dv entries against
               their plain versions (n = 8192 at the slice's shape, 4096
               with d = 128, a ragged 4100, fp16, f32, non-causal n != m),
               each timed beside the standard entry at the same shape (both
               launch the same kernels).
  9. wide heads - the d = 192 and 256 instantiations of the forward,
               fused, dq and dk/dv entries (CUDA cores, 16-bit operands
               staged as 16-bit), bf16 / fp16 / f32, at b=2 h=4 n=m=512
               causal and a ragged cross-length shape, each against its
               plain version with its time, bound and library time (the
               `kernels_wide` line). No path runs these head dims.
 10. slice 4, f32 - engine parity: GPT-2 small at full width and depth,
               6 prompts of 5-300 tokens + 32 new, greedy, through the slot
               engine (3 slots x 512), the paged engine with prefix sharing
               and the paged engine with spec_k=4: each token-identical to
               sequential generate() on the card.
 11. slice 4, bf16 - engine throughput: 64 requests at t = 0 (prompts of
               64-512 tokens, 128 new) through the slot engine (16 slots x
               1024, chunk 128, burst 4): tokens/s, TTFT p50/p99, the decode
               burst's time, a profiled burst's busy share, peak memory;
               the same requests through the paged engine with 4 groups
               sharing a 256-token prefix; spec_k=4 on repetitive prompts.
 12. slice 3, long context - the JAX package's long-context training run
               (bench.py with PADDLE_TPU_BENCH_SEQ=8192, BATCH=2): the
               bench's GPT with max_position 8192, bf16, batch 2 x 8192, 2
               warm-up and 6 timed steps, 12 launches a step of each long
               kernel and none of the standard ones, falling loss, a
               profile, and the same step on the standard route.
(Phases 9-11 run after phase 8 and before phases 5-7 and 12 in main().)
The last lines are a {"kernels_wide": [...]} line, the card's name and
power limit as nvidia-smi gives them, a {"kernels": [...]} line and the
{"ok": true, ...} line.
"""
import json
import math
import subprocess
import sys
import time

import torch

SEED = 1234

# Datasheet peaks (dense, no sparsity) by SKU, matched against the card's
# name: (memory bytes/s, {dtype: operations/s}). The H100 SXM figures are
# the default for an H100 whose name matches no other row.
_SKUS = [
    ('H100 PCIe', 2.0e12, {'bfloat16': 756e12, 'float16': 756e12,
                           'float32': 51e12}),
    ('H100 NVL', 3.9e12, {'bfloat16': 835e12, 'float16': 835e12,
                          'float32': 60e12}),
    ('H100', 3.35e12, {'bfloat16': 989e12, 'float16': 989e12,
                       'float32': 67e12}),
]


def _check(ok, msg):
    if not ok:
        raise RuntimeError('check failed: ' + msg)


def _sku(name):
    for key, bw, ops in _SKUS:
        if key in name:
            return key, bw, ops
    raise RuntimeError('no datasheet figures for %r' % name)


def _nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=10, warmup=2):
    """Mean device time of fn over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=10):
    """Device time of one call of fn: `iters` calls captured in a CUDA graph,
    the graph replayed 3 times between CUDA events. A kernel's wrapper costs
    tens of microseconds of host time a call, as much as the kernel itself at
    the short shapes; replaying the graph leaves no host gaps between the
    launches, so this times the kernel. fn is warmed up on a side stream
    before the capture, as torch.cuda.graph asks for code that runs
    autograd."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _profile(fn):
    """(wall ms, summed device kernel ms, top kernels, top aten ops) of fn.
    The wall time is taken on a call without the profiler, which slows the
    host; the kernel times on a second call under torch.profiler. Their
    ratio is the card's busy share. An aten op's device time includes the
    kernels of the ops it calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith('aten::')),
                 key=lambda e: -e.device_time_total)[:6]
    return (wall_ms, device_ms,
            [(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in top],
            [(e.key, e.device_time_total / 1e3, e.count) for e in ops])


def _flash_bound_ms(b, h, n, m, d, dtype, causal, sku):
    """Least time for the flash forward: each input read once, o and lse
    written once, over the memory rate; the score and p @ v products that
    these inputs need (causal: the visible pairs only) over the peak rate
    for their type. Returns (ms, 'bytes' or 'operations')."""
    _, bw, ops = sku
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * h * n * d + 2 * b * h * m * d) * item + 4 * b * h * n
    pairs = (sum(min(i + 1, m) for i in range(n)) if causal else n * m)
    flops = 4 * d * b * h * pairs
    name = {torch.bfloat16: 'bfloat16', torch.float16: 'float16',
            torch.float32: 'float32'}[dtype]
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / ops[name] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


# (b, h, n, m, d, dtype, causal, strided): `strided` slices q, k, v out of
# one [b, n, 3, h, d] projection as the GPT prefill does; the first row is
# the serving path's shape, the second the training path's
PREFILL_SHAPE = (8, 12, 768, 768, 64, torch.bfloat16, True, True)
TRAIN_SHAPE = (32, 12, 512, 512, 64, torch.bfloat16, True, True)
KERNEL_SHAPES = [
    PREFILL_SHAPE,
    TRAIN_SHAPE,
    (8, 12, 768, 768, 64, torch.bfloat16, False, False),
    (8, 12, 768, 768, 64, torch.float32, True, False),
    (8, 12, 768, 768, 64, torch.float32, False, True),
    (8, 12, 768, 768, 64, torch.float16, True, False),
    (2, 12, 4096, 4096, 64, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, False, False),
    # ragged last tiles, and a cross-length call, on both kernel paths
    (1, 2, 700, 700, 64, torch.float32, True, False),
    (1, 2, 700, 700, 64, torch.bfloat16, True, False),
    (1, 3, 300, 700, 128, torch.float16, False, False),
]

# Tolerances of the kernel against its plain version. Both sum the same
# f32 products in another order and round p to v's dtype at another point
# (the kernel against the running max, the plain version against the row
# max), then round o to the input dtype. In f32 that leaves sum-order error
# (~1e-6 here), so 1e-4 holds with margin. In bf16 / fp16, o is rounded to
# 8 / 11 bits: |o| < 4 at these inputs gives a bf16 ulp of at most 1/64,
# so one ulp of disagreement stays under 2e-2. lse is f32 in every case and
# only sees sum order: 1e-3 for the 16-bit inputs (their exp sums are
# larger and less flat), 1e-4 for f32.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3),
             torch.float16: (2e-2, 1e-3)}


def _qkv(gen, b, h, n, m, d, dtype, strided):
    """Seeded q, k, v [b, h, n|m, d]; strided ones are views of one
    [b, n, 3, h, d] projection, as in the GPT attention."""
    if strided:
        _check(n == m, 'strided inputs share one sequence length')
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device='cuda')
        qkv[:, :, 2] *= 0.5
        qkv = qkv.to(dtype)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    q = torch.randn((b, h, n, d), generator=gen, device='cuda')
    k = torch.randn((b, h, m, d), generator=gen, device='cuda')
    v = 0.5 * torch.randn((b, h, m, d), generator=gen, device='cuda')
    return [q.to(dtype), k.to(dtype), v.to(dtype)]


def kernel_phase(sku):
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    for b, h, n, m, d, dtype, causal, strided in KERNEL_SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        _check(o.shape == (b, h, n, d) and lse.shape == (b, h, n, 1),
               'output shapes')
        _check(bool(torch.isfinite(o.float()).all()), 'o finite')
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'kernel vs plain at %s: o err %.3g (tol %g), lse err %.3g '
               '(tol %g)' % ((b, h, n, m, d, str(dtype), causal), err_o,
                             tol_o, err_lse, tol_lse))
        ms = _graph_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        eager_ms = _time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        plain_ms = _time_ms(
            lambda: fa.flash_attention_fwd_ref(q, k, v, causal, scale),
            iters=3, warmup=1)
        library_ms = _graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale))
        bound_ms, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal,
                                             sku)
        row = {'shape': [b, h, n, m, d], 'dtype': str(dtype).split('.')[-1],
               'causal': causal, 'strided': strided, 'err_o': err_o,
               'err_lse': err_lse, 'ms': ms, 'eager_ms': eager_ms,
               'plain_ms': plain_ms,
               'library_ms': library_ms, 'bound_ms': bound_ms,
               'bound_by': bound_by}
        print('kernel flash_fwd %s' % json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


def _bwd_bound_ms(b, h, n, m, d, dtype, causal, which, sku):
    """Least time for a backward kernel: q, k, v, do, lse and delta read
    once and its gradients (fused: dq, dk, dv; dq: dq; dkv: dk, dv) written
    once, over the memory rate; its products (5, 3 or 4 of 2 * d flops for
    each visible pair) over the peak rate for their type. Returns (ms,
    'bytes' or 'operations')."""
    _, bw, ops = sku
    item = torch.empty((), dtype=dtype).element_size()
    q_elems, k_elems = b * h * n * d, b * h * m * d
    written = {'fused': q_elems + 2 * k_elems, 'dq': q_elems,
               'dkv': 2 * k_elems}[which]
    nbytes = (2 * q_elems + 2 * k_elems + written) * item + 2 * 4 * b * h * n
    pairs = (sum(min(i + 1, m) for i in range(n)) if causal else n * m)
    products = {'fused': 5, 'dq': 3, 'dkv': 4}[which]
    flops = products * 2 * d * b * h * pairs
    name = {torch.bfloat16: 'bfloat16', torch.float16: 'float16',
            torch.float32: 'float32'}[dtype]
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / ops[name] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


# (b, h, n, m, d, dtype, causal, strided): every backward kernel runs at
# every shape. The first is the training main path's shape (fused route),
# the second the seq-1024 path's (two-pass); the last the non-causal
# cross-length call with which ring attention takes the two-pass pair.
BWD_MAIN_SHAPE = (32, 12, 512, 512, 64, torch.bfloat16, True, True)
BWD_SECOND_SHAPE = (8, 12, 1024, 1024, 64, torch.bfloat16, True, True)
BWD_SHAPES = [
    BWD_MAIN_SHAPE,
    BWD_SECOND_SHAPE,
    (8, 12, 512, 512, 64, torch.bfloat16, False, True),
    (8, 12, 512, 512, 64, torch.float16, True, False),
    (2, 12, 512, 512, 64, torch.float32, True, True),
    (4, 8, 512, 512, 128, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, False, False),
    (1, 2, 300, 300, 64, torch.bfloat16, True, False),
    (1, 2, 700, 700, 64, torch.bfloat16, True, False),
    (1, 2, 700, 700, 128, torch.float32, False, False),
    (2, 8, 640, 1152, 64, torch.bfloat16, False, False),
]

# Tolerances of the backward kernels against their plain version, as a
# share of the largest reference gradient. Both take the same f32 products
# of the same native operands; they differ in the order of the f32 sums
# (~1e-6 relative), so where p or ds lies that close to a rounding boundary
# of the operand dtype they may round it differently, and each gradient is
# then rounded to the operand dtype: one ulp at the largest entry is 2^-8
# of it in bf16 and 2^-11 in fp16. 2e-2 (bf16) and 4e-3 (fp16) allow a few
# ulps; f32 sees sum order only, 1e-4.
BWD_TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                 torch.float32: 1e-4}


def bwd_kernel_phase(sku):
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    rows = []
    for shape_key in BWD_SHAPES:
        b, h, n, m, d, dtype, causal, strided = shape_key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        # the output gradient as the GPT attention hands it over: a
        # [b, h, n, d] view of a [b, n, h, d] tensor
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        ref = fa.flash_attention_bwd_ref(*args)
        calls = {
            'fused': lambda: fa.flash_bwd_fused_cuda(*args),
            'dq': lambda: (fa.flash_bwd_dq_cuda(*args),),
            'dkv': lambda: fa.flash_bwd_dkv_cuda(*args),
        }
        refs = {'fused': ref, 'dq': ref[:1], 'dkv': ref[1:]}
        tol = BWD_TOLERANCE[dtype]
        shape = [b, h, n, m, d]
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            errs, scales = [], []
            for g, r in zip(got, refs[which]):
                _check(g.shape == r.shape and g.dtype == r.dtype,
                       'flash_bwd_%s output shape / dtype' % which)
                _check(bool(torch.isfinite(g.float()).all()),
                       'flash_bwd_%s output finite' % which)
                errs.append((g.float() - r.float()).abs().max().item())
                scales.append(r.float().abs().max().item())
            for err, top in zip(errs, scales):
                _check(err <= tol * top,
                       'flash_bwd_%s vs plain at %s %s causal=%s: err %.3g > '
                       '%g x max %.3g' % (which, shape, dtype, causal, err,
                                          tol, top))
            if which != 'dkv':
                _check_same_dq(call, got[0], 'flash_bwd_%s' % which, shape)
            bound_ms, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                               which, sku)
            row = {'shape': shape, 'dtype': str(dtype).split('.')[-1],
                   'causal': causal, 'strided': strided,
                   'max_abs_err': max(errs), 'errs': errs,
                   'ref_max': scales, 'tol_share': tol, 'ms': _graph_ms(call),
                   'eager_ms': _time_ms(call),
                   'plain_ms': plain_ms, 'library_ms': lib,
                   'bound_ms': bound_ms, 'bound_by': bound_by}
            if which == 'fused' and shape_key == BWD_MAIN_SHAPE:
                row['kernels_ms'] = _kernels_ms(call)
            print('kernel flash_bwd_%s %s' % (which, json.dumps(row)),
                  flush=True)
            rows.append((which, shape_key, row))
        del q, k, v, o, lse, do, delta, ref
        torch.cuda.empty_cache()
    return rows


def _check_same_dq(call, dq, name, shape):
    """A second launch of a dq entry on the same inputs gives a bitwise-equal
    dq: the kernels sum in a fixed order, with no atomics."""
    again = call()[0]
    torch.cuda.synchronize()
    _check(torch.equal(again, dq),
           '%s at %s: two launches differ by up to %.3g' % (
               name, shape, (again.float() - dq.float()).abs().max().item()))


def _kernels_ms(fn, calls=10):
    """{kernel name: mean device ms a launch} over `calls` calls of fn
    under torch.profiler: the fused backward's two kernels apart."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split('<')[0].split('::')[-1]:
            e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _sdpa_bwd_ms(q, k, v, do, causal, scale):
    """The backward part of torch's scaled_dot_product_attention on these
    inputs: forward + backward through autograd, minus the forward, both
    timed by CUDA-graph replay as the kernels are."""
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def both():
        out = sdpa(qr, kr, vr, is_causal=causal, scale=scale)
        torch.autograd.grad(out, (qr, kr, vr), do)

    def forward():
        with torch.no_grad():
            sdpa(qr, kr, vr, is_causal=causal, scale=scale)

    return _graph_ms(both) - _graph_ms(forward)


def _prefill_logits(model, ids):
    from paddle_tpu_torch.text.models.gpt import GPTStaticCache

    c = model.config
    dev = model.gpt.wte.weight.device
    caches = [GPTStaticCache.empty(
        ids.shape[0], ids.shape[1] + 1, c.num_heads,
        c.hidden_size // c.num_heads, dtype=model.gpt.wte.weight.dtype,
        device=dev) for _ in range(c.num_layers)]
    with torch.no_grad():
        logits, _ = model(ids.to(dev), caches=caches)
    return logits


def slice_phases():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    cpu = GPTForCausalLM(cfg, device='cpu', seed=SEED + 1).eval()
    cpu.load_state_dict(model.state_dict())
    prompt_gen = torch.Generator().manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (8, 768), generator=prompt_gen)

    # -- slice, f32: the card against the CPU plain path, same weights
    t0 = time.time()
    logits = _prefill_logits(model, ids)
    torch.cuda.synchronize()
    logits_cpu = _prefill_logits(cpu, ids)
    err = (logits.cpu() - logits_cpu).abs().max().item()
    # f32 products on both sides (TF32 off); sums in another order through
    # 12 layers leave ~1e-5 on logits of magnitude ~1
    _check(err <= 1e-3, 'f32 prefill logits vs CPU: %.3g > 1e-3' % err)
    new_f32 = 32
    out = model.generate(ids.cuda(), max_new_tokens=new_f32).cpu()
    out_cpu = cpu.generate(ids, max_new_tokens=new_f32)
    agree = int((out[:, 768:] == out_cpu[:, 768:]).sum())
    print('slice f32: params %d, prefill logits max abs err vs CPU %.3g '
          '(tol 1e-3), greedy tokens agreeing %d of %d, %.1f s'
          % (model.num_params(), err, agree, out_cpu[:, 768:].numel(),
             time.time() - t0), flush=True)
    last_f32 = logits[:, -1].float()
    del cpu, logits, logits_cpu

    # -- slice, bf16: the main path
    model.bfloat16()
    ids_cuda = ids.cuda()
    model.generate(ids_cuda[:, :64], max_new_tokens=2)  # warm-up, no flash
    last_bf16 = _prefill_logits(model, ids_cuda)[:, -1].float()
    rel = ((last_bf16 - last_f32).abs().max()
           / last_f32.abs().max()).item()
    # bf16 keeps 8 mantissa bits; 12 layers of it stay within a few per
    # cent of the f32 logits' range
    _check(rel <= 0.1, 'bf16 vs f32 last logits: %.3g of range' % rel)

    _reset_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(ids_cuda, max_new_tokens=128)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = fa.flash_fwd_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    _check(launches == cfg.num_layers,
           'flash launches %d on the main path, want %d (one per layer, '
           'prefill only)' % (launches, cfg.num_layers))
    _check(fa.counts['rejected'] == 0, 'a shape was routed off the kernel')
    _check(tuple(out.shape) == (8, 768 + 128), 'generate output shape')
    _check(bool((out[:, :768] == ids_cuda).all()), 'prompt preserved')
    _check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           'tokens in the vocabulary')

    model.generate(ids_cuda[:, :64], max_new_tokens=128)
    torch.cuda.synchronize()
    _check(fa.flash_fwd_cuda.launches == launches,
           '64-token prompts launched the flash kernel')

    # one generate call varies by a fifth from call to call on the host's
    # clock, so the decode rate is taken from the median of three
    total_s = [total_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids_cuda, max_new_tokens=128)
        torch.cuda.synchronize()
        total_s.append(time.perf_counter() - t0)
    calls_ms = ['%.1f' % (x * 1e3) for x in total_s]
    total_s = sorted(total_s)[1]
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids_cuda, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_s = sorted(prefill_s)[1]
    decode_tps = 8 * 127 / max(total_s - prefill_s, 1e-9)
    print('slice bf16: generate 8 x 768 + 128 new in %.1f ms (median of '
          '%s), prefill %.2f ms, decode %.1f tokens/s, peak memory %.2f GiB, '
          'flash launches %d, bf16 vs f32 last logits %.3g of range'
          % (total_s * 1e3, ', '.join(calls_ms), prefill_s * 1e3, decode_tps,
             peak / 2 ** 30, launches, rel), flush=True)

    for label, new in (('prefill', 1), ('prefill + 32 decode steps', 33)):
        wall, dev, top, ops = _profile(
            lambda: model.generate(ids_cuda, max_new_tokens=new))
        print('profile %s: wall %.2f ms, device kernels %.2f ms, busy '
              'share %.3f; top kernels: %s; top aten ops: %s'
              % (label, wall, dev, dev / wall,
                 '; '.join('%s %.2f ms x%d' % t for t in top),
                 '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    return launches


def _wrappers(fa):
    return {'flash_fwd': fa.flash_fwd_cuda,
            'flash_bwd_fused': fa.flash_bwd_fused_cuda,
            'flash_bwd_dq': fa.flash_bwd_dq_cuda,
            'flash_bwd_dkv': fa.flash_bwd_dkv_cuda,
            'flash_fwd_long': fa.flash_fwd_long_cuda,
            'flash_bwd_dq_long': fa.flash_bwd_dq_long_cuda,
            'flash_bwd_dkv_long': fa.flash_bwd_dkv_long_cuda}


def _reset_counts(fa):
    for wrapper in _wrappers(fa).values():
        wrapper.launches = 0
    for key in fa.counts:
        fa.counts[key] = 0


def _launches(fa):
    out = {name: w.launches for name, w in _wrappers(fa).items()}
    out['rejected'] = fa.counts['rejected']
    return out


def _want(steps, **per_step):
    """The launch counts of `steps` steps: per_step[name] a step for the
    kernels named, none of the others, none rejected."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out = {name: steps * per_step.get(name, 0) for name in _wrappers(fa)}
    out['rejected'] = 0
    return out


# the bench's training configuration (bench.py), at full width and depth
BENCH_CFG = dict(vocab_size=30528, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=512, dropout=0.0,
                 fused_loss=True)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 32, 512, 1e-4


def _train_setup(cfg, device, seed, batch, seq, dtype=None):
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    if dtype is not None:
        model.to(dtype)
    step = TrainStep(model, model.loss,
                     AdamW(learning_rate=TRAIN_LR,
                           parameters=model.parameters()))
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    return model, step, ids.to(device), labels.to(device)


def train_f32_phase():
    """One AdamW step of the bench's GPT cut to 2 layers on the card and on
    the CPU plain path, from the same weights."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**dict(BENCH_CFG, num_layers=2))
    t0 = time.time()
    model, step, ids, labels = _train_setup(cfg, 'cuda', SEED, 2, TRAIN_SEQ)
    cpu, cpu_step, _, _ = _train_setup(cfg, 'cpu', SEED + 1, 2, TRAIN_SEQ)
    cpu.load_state_dict(model.state_dict())
    _reset_counts(fa)
    loss = step(ids, labels).item()
    torch.cuda.synchronize()
    launches = _launches(fa)
    loss_cpu = cpu_step(ids.cpu(), labels.cpu()).item()
    _check(launches == _want(1, flash_fwd=2, flash_bwd_fused=2),
           'f32 step launches %s, want 2 forward and 2 fused backward'
           % launches)
    # f32 products on both sides (TF32 off), summed in another order: the
    # loss to 1e-5 of itself
    rel = abs(loss - loss_cpu) / abs(loss_cpu)
    _check(rel <= 1e-5, 'f32 loss %.7f vs CPU %.7f' % (loss, loss_cpu))
    # Adam moves each parameter by ~lr whatever the size of its gradient;
    # where the exact gradient is 0 (the key third of each qkv bias) the
    # sign of f32 noise decides, so entries may differ by up to 2 lr. All
    # others agree to f32 rounding of the update.
    worst, close, total = 0.0, 0, 0
    cpu_state = cpu.state_dict()
    for name, p in model.state_dict().items():
        diff = (p.cpu() - cpu_state[name]).abs()
        worst = max(worst, diff.max().item())
        close += int((diff <= 1e-6 + 1e-4 * cpu_state[name].abs()).sum())
        total += diff.numel()
    _check(worst <= 2 * TRAIN_LR + 1e-6,
           'f32 params after the step differ by %.3g > 2 lr' % worst)
    _check(close >= 0.999 * total,
           'f32 params: only %d of %d close to the CPU step' % (close, total))
    print('train f32: 2 layers, batch 2 x %d, loss %.7f vs CPU %.7f '
          '(rel %.3g, tol 1e-5), params after the step max abs diff %.3g '
          '(tol 2 lr), %d of %d within 1e-6 + 1e-4 |p|, launches %s, '
          '%.1f s' % (TRAIN_SEQ, loss, loss_cpu, rel, worst, close, total,
                      launches, time.time() - t0), flush=True)
    del model, step, cpu, cpu_step
    torch.cuda.empty_cache()


def train_main_phase(sku):
    """The main path: the bench's training step on the card."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**BENCH_CFG)
    model, step, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    losses = [step(ids, labels).item() for _ in range(2)]  # warm-up
    steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'main path launches %s over %d steps, want %d forward and %d '
           'fused backward a step' % (launches, steps, layers, layers))
    _check(all(math.isfinite(x) for x in losses), 'losses finite')
    _check(losses[-1] < losses[0],
           'loss %.4f after %d steps not below the first %.4f'
           % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[steps // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak_flops = sku[2]['bfloat16']
    mfu = flops_tok * tokens / (median / 1e3) / peak_flops
    print('train bf16 (main path): %d params, batch %d x %d, median step '
          '%.2f ms (min %.2f, max %.2f), %.1f samples/s, %.0f tokens/s, '
          '%.1f MFLOP/token, MFU %.4f of %.0f TFLOP/s (least step at peak '
          '%.2f ms), peak memory %.2f GiB, launches over %d steps %s, '
          'losses %s' % (model.num_params(), TRAIN_BATCH, TRAIN_SEQ, median,
                         min(step_ms), max(step_ms), TRAIN_BATCH / median
                         * 1e3, tokens / median * 1e3, flops_tok / 1e6, mfu,
                         peak_flops / 1e12, flops_tok * tokens / peak_flops
                         * 1e3, peak / 2 ** 30, steps, launches,
                         ['%.4f' % x for x in losses]), flush=True)
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    print('profile train step: wall %.2f ms, device kernels %.2f ms, busy '
          'share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)

    # The fused/two-pass threshold (512) is the TPU's tuning. For its
    # re-measurement on this card: the same step with the two-pass
    # backward, after the main path's launches were read.
    fused_max, fa.FUSED_BWD_MAX_SEQ = fa.FUSED_BWD_MAX_SEQ, 0
    try:
        _reset_counts(fa)
        two_pass_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids, labels).item()
            two_pass_ms.append((time.perf_counter() - t0) * 1e3)
        _check(fa.flash_bwd_dq_cuda.launches == 5 * layers,
               'two-pass variant did not take the two-pass kernels')
    finally:
        fa.FUSED_BWD_MAX_SEQ = fused_max
    print('train bf16 with the two-pass backward at seq 512: median step '
          '%.2f ms (fused route above: %.2f ms)'
          % (sorted(two_pass_ms)[2], median), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps, 'median_ms': median}


def train_seq1024_phase():
    """GPT-2 small training at 1024 tokens: the two-pass backward."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024, dropout=0.0,
                    fused_loss=True)
    model, step, ids, labels = _train_setup(cfg, 'cuda', SEED, 8, 1024,
                                            torch.bfloat16)
    steps = 2
    torch.cuda.synchronize()
    _reset_counts(fa)
    t0 = time.perf_counter()
    losses = [step(ids, labels).item() for _ in range(steps)]
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches(fa)
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_dq=layers, flash_bwd_dkv=layers),
           'seq-1024 launches %s over %d steps, want %d forward, dq and dk/dv '
           'a step' % (launches, steps, layers))
    _check(all(math.isfinite(x) for x in losses), 'seq-1024 losses finite')
    print('train seq 1024 (two-pass path): GPT-2 small, batch 8 x 1024, '
          'bf16, %d steps in %.1f ms (first includes warm-up), losses %s, '
          'launches %s' % (steps, total_ms, ['%.4f' % x for x in losses],
                           launches), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps}


# (b, h, n, m, d, dtype, causal): the d = 192 / 256 instantiations (CUDA
# cores, operands staged as their own type) of every entry, at one short
# causal shape and one ragged non-causal cross-length shape. No path of this
# script runs these head dims; their launches here are checks, not a path.
WIDE_SHAPES = [(b, h, n, m, d, dtype, causal)
               for d in (192, 256)
               for dtype in (torch.bfloat16, torch.float16, torch.float32)
               for b, h, n, m, causal in ((2, 4, 512, 512, True),
                                          (1, 3, 300, 700, False))]


def wide_kernel_phase(sku):
    """Each entry at d = 192 and 256 against its plain version, at the
    forward's and the backward's tolerances, with its time, bound and the
    library call's time."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    rows = []
    for key in WIDE_SHAPES:
        b, h, n, m, d, dtype, causal = key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, False)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        dt = str(dtype).split('.')[-1]
        shape = [b, h, n, m, d]
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(o.shape == (b, h, n, d) and bool(torch.isfinite(
            o.float()).all()), 'wide forward output')
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'flash_fwd vs plain at %s %s causal=%s: o err %.3g (tol %g), '
               'lse err %.3g (tol %g)' % (shape, dt, causal, err_o, tol_o,
                                          err_lse, tol_lse))
        bound, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal, sku)
        row = {'name': 'flash_fwd', 'shape': shape, 'dtype': dt,
               'causal': causal, 'max_abs_err': err_o, 'err_lse': err_lse,
               'ms': _graph_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal,
                                                         scale)),
               'plain_ms': _time_ms(lambda: fa.flash_attention_fwd_ref(
                   q, k, v, causal, scale), iters=3, warmup=1),
               'library_ms': _graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, scale=scale)),
               'bound_ms': bound, 'bound_by': bound_by}
        print('kernel wide %s' % json.dumps(row), flush=True)
        rows.append(row)

        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        calls = (('fused', lambda: fa.flash_bwd_fused_cuda(*args)),
                 ('dq', lambda: (fa.flash_bwd_dq_cuda(*args),)),
                 ('dkv', lambda: fa.flash_bwd_dkv_cuda(*args)))
        # every kernel runs before the plain version first does, so no
        # output of the plain version lies freed in the allocator's cache
        # for a kernel's output to be handed (a kernel that wrote nothing
        # would then read as exact)
        outs = {which: call() for which, call in calls}
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_ref(*args)
        refs = {'fused': ref, 'dq': ref[:1], 'dkv': ref[1:]}
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        tol = BWD_TOLERANCE[dtype]
        for which, call in calls:
            got = outs.pop(which)
            errs, shares = _err_share(got, refs[which])
            _check(max(shares) <= tol,
                   'flash_bwd_%s vs plain at %s %s causal=%s: errors %s of '
                   'the largest gradient > %g' % (which, shape, dt, causal,
                                                  shares, tol))
            if which != 'dkv':
                _check_same_dq(call, got[0], 'flash_bwd_%s' % which, shape)
            bound, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                            which, sku)
            row = {'name': 'flash_bwd_%s' % which, 'shape': shape,
                   'dtype': dt, 'causal': causal, 'max_abs_err': max(errs),
                   'err_share': shares, 'tol_share': tol,
                   'ms': _graph_ms(call), 'plain_ms': plain_ms,
                   'library_ms': lib, 'bound_ms': bound,
                   'bound_by': bound_by}
            print('kernel wide %s' % json.dumps(row), flush=True)
            rows.append(row)
            del got
        del q, k, v, do, o, lse, delta, ref, args, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


# (b, h, n, m, d, dtype, causal, strided): every long kernel runs at every
# shape. The first is the long training path's (the attention of one layer
# at batch 2 x 8192, q, k, v strided views of the packed projection).
LONG_MAIN_SHAPE = (2, 12, 8192, 8192, 64, torch.bfloat16, True, True)
LONG_SHAPES = [
    LONG_MAIN_SHAPE,
    (1, 8, 4096, 4096, 128, torch.bfloat16, True, False),
    (1, 4, 4100, 4100, 64, torch.bfloat16, True, False),
    (1, 4, 4096, 4096, 64, torch.float16, True, False),
    (1, 2, 4100, 4100, 128, torch.float32, True, False),
    (1, 4, 1000, 4160, 64, torch.bfloat16, False, False),
]


def _err_share(got, refs):
    """(largest error, largest error over the largest reference entry) of
    each output."""
    errs, shares = [], []
    for g, r in zip(got, refs):
        _check(g.shape == r.shape and g.dtype == r.dtype,
               'output shape / dtype')
        _check(bool(torch.isfinite(g.float()).all()), 'output finite')
        err = (g.float() - r.float()).abs().max().item()
        errs.append(err)
        shares.append(err / max(r.float().abs().max().item(), 1e-30))
    return errs, shares


def long_kernel_phase(sku):
    """Each long entry against its plain version, its time beside the
    standard entry's at the same shape, the bound and the library call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rows = {}
    for key in LONG_SHAPES:
        b, h, n, m, d, dtype, causal, strided = key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        dt = str(dtype).split('.')[-1]
        shape = [b, h, n, m, d]

        # forward
        o, lse = fa.flash_fwd_long_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(o.shape == (b, h, n, d) and bool(torch.isfinite(
            o.float()).all()), 'long forward output')
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'flash_fwd_long vs plain at %s %s causal=%s: o err %.3g (tol '
               '%g), lse err %.3g (tol %g)' % (shape, dt, causal, err_o,
                                                tol_o, err_lse, tol_lse))
        bound, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal, sku)
        row = {'shape': shape, 'dtype': dt, 'causal': causal,
               'strided': strided, 'max_abs_err': err_o, 'err_lse': err_lse,
               'ms': _graph_ms(lambda: fa.flash_fwd_long_cuda(
                   q, k, v, causal, scale)),
               'eager_ms': _time_ms(lambda: fa.flash_fwd_long_cuda(
                   q, k, v, causal, scale)),
               'std_ms': _graph_ms(lambda: fa.flash_fwd_cuda(
                   q, k, v, causal, scale)),
               'plain_ms': _time_ms(lambda: fa.flash_attention_fwd_ref(
                   q, k, v, causal, scale), iters=3, warmup=1),
               'library_ms': _graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, scale=scale)),
               'bound_ms': bound, 'bound_by': bound_by}
        print('kernel flash_fwd_long %s' % json.dumps(row), flush=True)
        rows['fwd', key] = row
        torch.cuda.empty_cache()

        # backward
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        ref = fa.flash_attention_bwd_ref(*args)
        torch.cuda.empty_cache()
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        torch.cuda.empty_cache()
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        tol = BWD_TOLERANCE[dtype]
        for which, call, std, refs in (
                ('dq', lambda: (fa.flash_bwd_dq_long_cuda(*args),),
                 lambda: fa.flash_bwd_dq_cuda(*args), ref[:1]),
                ('dkv', lambda: fa.flash_bwd_dkv_long_cuda(*args),
                 lambda: fa.flash_bwd_dkv_cuda(*args), ref[1:])):
            got = call()
            torch.cuda.synchronize()
            errs, shares = _err_share(got, refs)
            _check(max(shares) <= tol,
                   'flash_bwd_%s_long vs plain at %s %s causal=%s: errors %s '
                   'of the largest gradient > %g' % (which, shape, dt, causal,
                                                     shares, tol))
            if which == 'dq':
                _check_same_dq(call, got[0], 'flash_bwd_dq_long', shape)
            bound, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                            which, sku)
            row = {'shape': shape, 'dtype': dt, 'causal': causal,
                   'strided': strided, 'max_abs_err': max(errs),
                   'err_share': shares, 'tol_share': tol,
                   'ms': _graph_ms(call), 'eager_ms': _time_ms(call),
                   'std_ms': _graph_ms(std),
                   'plain_ms': plain_ms, 'library_ms': lib,
                   'bound_ms': bound, 'bound_by': bound_by}
            print('kernel flash_bwd_%s_long %s' % (which, json.dumps(row)),
                  flush=True)
            rows[which, key] = row
            del got
        del q, k, v, do, o, lse, delta, ref, args
        torch.cuda.empty_cache()
    return rows


# the JAX package's long-context run (bench.py:102-120 with
# PADDLE_TPU_BENCH_SEQ=8192 and PADDLE_TPU_BENCH_BATCH=2)
LONG_CFG = dict(BENCH_CFG, max_position_embeddings=8192)
LONG_BATCH, LONG_SEQ = 2, 8192


def train_long_phase(sku):
    """Slice 3: the bench's GPT trained at batch 2 x 8192 on the long
    route; then the same step with the long route switched off."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**LONG_CFG)
    model, step, ids, labels = _train_setup(
        cfg, 'cuda', SEED, LONG_BATCH, LONG_SEQ, torch.bfloat16)
    losses = [step(ids, labels).item() for _ in range(2)]  # warm-up
    steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd_long=layers,
                             flash_bwd_dq_long=layers,
                             flash_bwd_dkv_long=layers),
           'long path launches %s over %d steps, want %d of each long '
           'kernel a step and no other' % (launches, steps, layers))
    _check(all(math.isfinite(x) for x in losses), 'long losses finite')
    _check(losses[-1] < losses[0],
           'long loss %.4f after %d steps not below the first %.4f'
           % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[steps // 2]
    tokens = LONG_BATCH * LONG_SEQ
    flops_tok = model.flops_per_token(LONG_SEQ)
    peak_flops = sku[2]['bfloat16']
    mfu = flops_tok * tokens / (median / 1e3) / peak_flops
    print('train long (slice 3): %d params, batch %d x %d, median step '
          '%.2f ms (min %.2f, max %.2f), %.2f samples/s, %.0f tokens/s, '
          '%.1f MFLOP/token, MFU %.4f of %.0f TFLOP/s (least step at peak '
          '%.2f ms), peak memory %.2f GiB, launches over %d steps %s, '
          'losses %s' % (model.num_params(), LONG_BATCH, LONG_SEQ, median,
                         min(step_ms), max(step_ms), LONG_BATCH / median
                         * 1e3, tokens / median * 1e3, flops_tok / 1e6, mfu,
                         peak_flops / 1e12, flops_tok * tokens / peak_flops
                         * 1e3, peak / 2 ** 30, steps, launches,
                         ['%.4f' % x for x in losses]), flush=True)
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    print('profile train long step: wall %.2f ms, device kernels %.2f ms, '
          'busy share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)

    # The 4096 threshold is the TPU's tuning. Both routes launch the same
    # kernels here; the same step on the standard route (two-pass backward),
    # after the long path's launches were read, shows they cost the same.
    long_seq, fa.LONG_SEQ = fa.LONG_SEQ, LONG_SEQ + 1
    try:
        _reset_counts(fa)
        std_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids, labels).item()
            std_ms.append((time.perf_counter() - t0) * 1e3)
        _check(fa.flash_bwd_dq_cuda.launches == 4 * layers
               and fa.flash_fwd_long_cuda.launches == 0,
               'standard variant did not take the standard route')
    finally:
        fa.LONG_SEQ = long_seq
    print('train long on the standard route: median step %.2f ms (long '
          'route above: %.2f ms)' % (sorted(std_ms)[2], median), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps, 'median_ms': median}


def _first_divergence(model, prompt, want, got):
    """(index, top-2 logit gap of generate()'s model at that token) of the
    first token where `got` leaves `want`."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    ids = torch.tensor([prompt + want[:j]], device='cuda')
    with torch.no_grad():
        top = model(ids)[0, -1].float().topk(2).values
    return j, (top[0] - top[1]).item()


def engine_parity_phase():
    """Slice 4, f32: the slot engine, the paged engine with prefix sharing
    and the paged engine with spec_k=4 against sequential generate() on the
    card, GPT-2 small at full width and depth, token for token."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 4)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    # six prompts of 5 to 300 tokens; the first and the fourth share a
    # 64-token head (the fourth is admitted after the first has prefilled)
    head = tokens(64)
    prompts = [head + tokens(40), tokens(5), tokens(300), head + tokens(100),
               tokens(23), tokens(150)]
    new = 32
    want = [model.generate(torch.tensor([p], device='cuda'),
                           max_new_tokens=new)[0, len(p):].tolist()
            for p in prompts]
    kw = dict(max_len=512, prefill_chunk=16, decode_block=4)
    engines = [
        ('slot', ContinuousBatchingEngine(model, num_slots=3, **kw)),
        ('paged prefix', PagedContinuousBatchingEngine(
            model, num_seqs=3, page_size=16, **kw)),
        ('paged spec_k=4', PagedContinuousBatchingEngine(
            model, num_seqs=3, page_size=16, spec_k=4, **kw))]
    _reset_counts(fa)
    reports = {}
    for label, eng in engines:
        got = eng.generate(prompts, max_new_tokens=new)
        for i, (w, g) in enumerate(zip(want, got)):
            if w != g:
                j, gap = _first_divergence(model, prompts[i], w, g)
                raise RuntimeError(
                    'check failed: %s engine diverges from generate() on '
                    'prompt %d (%d tokens) at new token %d: %d vs %d, top-2 '
                    'logit gap there %.3g' % (label, i, len(prompts[i]), j,
                                              g[j], w[j], gap))
        reports[label] = eng.metrics.report()
    _check(reports['paged prefix']['prefix_hits'] > 0,
           'the shared head hit no prefix-cache page')
    _check(_launches(fa) == _want(1), 'an engine launched a flash kernel: '
           '%s' % _launches(fa))
    print('engine f32 parity: GPT-2 small, 6 prompts of %s tokens, %d new, '
          'greedy: slot, paged (prefix hits %d blocks) and paged spec_k=4 '
          '(accept rate %.3f) token-identical to generate() on the card, '
          '%.1f s' % ([len(p) for p in prompts], new,
                      reports['paged prefix']['prefix_hits'],
                      reports['paged spec_k=4']['spec_accept_rate'],
                      time.time() - t0), flush=True)
    del model, engines
    torch.cuda.empty_cache()


# the throughput workload: 64 requests at t = 0, prompts of 64-512 tokens
# from the seed, 128 new tokens, greedy
THROUGHPUT_REQUESTS, THROUGHPUT_NEW = 64, 128


def _serve(eng, prompts, new):
    """Submit every prompt at once, drive to the end; (requests, wall s,
    pages in use at peak)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    peak_pages = 0
    while eng.step():
        peak_pages = max(peak_pages, getattr(eng, 'pages', eng.allocator)
                         .in_use)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(all(len(r.tokens) == new for r in reqs), 'a request came short')
    return reqs, wall, peak_pages


def engine_throughput_phase():
    """Slice 4, bf16: the throughput workload through the slot engine, the
    paged engine with 4 groups sharing a 256-token prefix, and spec_k=4 on
    repetitive prompts."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    t_phase = time.time()
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda',
                           seed=SEED).eval().bfloat16()
    gen = torch.Generator().manual_seed(SEED + 5)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    lengths = torch.randint(64, 513, (THROUGHPUT_REQUESTS,),
                            generator=gen).tolist()
    prompts = [tokens(n) for n in lengths]
    new = THROUGHPUT_NEW
    slot = ContinuousBatchingEngine(model, num_slots=16, max_len=1024,
                                    prefill_chunk=128, decode_block=4)
    slot.generate(prompts[:2], max_new_tokens=8)     # warm-up
    _reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    metrics_before = slot.metrics.report()['tokens']
    reqs, wall, _ = _serve(slot, prompts, new)
    peak = torch.cuda.max_memory_allocated()
    _check(_launches(fa) == _want(1), 'the slot engine launched a flash '
           'kernel: %s' % _launches(fa))
    ttft = sorted(r._first_token_t - r._arrival_t for r in reqs)
    rep = slot.metrics.report()
    _check(rep['tokens'] - metrics_before == THROUGHPUT_REQUESTS * new,
           'token count')
    tl = slot.timeline
    burst = {key: tl.percentile(50, key) for key in ('host_dispatch',
                                                     'device_block')}
    print('engine bf16 slot: %d requests (prompts %d-%d, mean %.0f tokens) '
          '+ %d new at t=0, 16 slots x 1024: %.0f tokens/s (%d tokens in '
          '%.2f s), TTFT p50 %.1f ms p99 %.1f ms, decode burst (4 steps) '
          'p50 %.2f ms (host dispatch %.2f, wait for the card %.2f), peak '
          'memory %.2f GiB' % (
              THROUGHPUT_REQUESTS, min(lengths), max(lengths),
              sum(lengths) / len(lengths), new,
              THROUGHPUT_REQUESTS * new / wall, THROUGHPUT_REQUESTS * new,
              wall, _pct(ttft, 50) * 1e3, _pct(ttft, 99) * 1e3,
              tl.percentile(50) * 1e3, burst['host_dispatch'] * 1e3,
              burst['device_block'] * 1e3, peak / 2 ** 30), flush=True)

    # one burst with all 16 slots decoding, under the profiler
    for p in prompts[:16]:
        slot.add_request(p[:128], max_new_tokens=64)
    while slot.scheduler.queue or any(
            r.state != 'decode' for r in slot.scheduler.resident.values()):
        slot.step()

    def burst_fn():
        with slot._lock, torch.no_grad():
            slot._decode_step()

    wall_ms, dev_ms, top, ops = _profile(burst_fn)
    print('profile decode burst (16 slots, 4 steps): wall %.2f ms, device '
          'kernels %.2f ms, busy share %.3f; top kernels: %s; top aten '
          'ops: %s' % (wall_ms, dev_ms, dev_ms / wall_ms,
                       '; '.join('%s %.2f ms x%d' % t for t in top),
                       '; '.join('%s %.2f ms x%d' % t for t in ops)),
          flush=True)
    slot.run()
    del slot
    torch.cuda.empty_cache()

    # the same requests, 4 groups each sharing a 256-token prefix
    heads = [tokens(256) for _ in range(4)]
    shared = [heads[i % 4] + p[:max(len(p) - 256, 16)]
              for i, p in enumerate(prompts)]
    paged = PagedContinuousBatchingEngine(
        model, num_seqs=16, max_len=1024, page_size=16, prefill_chunk=128,
        decode_block=4)
    _reset_counts(fa)
    reqs, wall, peak_pages = _serve(paged, shared, new)
    rep = paged.metrics.report()
    _check(rep['prefix_hits'] > 0, 'the shared prefixes hit no page')
    print('engine bf16 paged: the same %d requests with 4 groups sharing a '
          '256-token prefix (prompts %d-%d tokens), page 16: %.0f tokens/s '
          '(%.2f s), prompt tokens saved by the prefix cache %d of %d, '
          'pages in use at peak %d of %d, launches %s' % (
              THROUGHPUT_REQUESTS, min(map(len, shared)),
              max(map(len, shared)), THROUGHPUT_REQUESTS * new / wall, wall,
              rep['prefix_hits'] * 16, sum(map(len, shared)), peak_pages,
              paged.num_pages - 1, _launches(fa)), flush=True)
    del paged
    torch.cuda.empty_cache()

    # spec_k=4 on repetitive prompts: a 16-token motif repeated
    spec_prompts = [(tokens(16) * 16)[:96 + 8 * i] for i in range(16)]
    spec = PagedContinuousBatchingEngine(
        model, num_seqs=16, max_len=1024, page_size=16, prefill_chunk=128,
        decode_block=4, spec_k=4)
    reqs, wall, _ = _serve(spec, spec_prompts, 64)
    rep = spec.metrics.report()
    print('engine bf16 paged spec_k=4: 16 repetitive prompts (a 16-token '
          'motif, 96-216 tokens) + 64 new: acceptance rate %.3f (%d of %d '
          'drafts), %.0f tokens/s (%.2f s); whole phase %.1f s' % (
              rep['spec_accept_rate'], rep['spec_accepted'],
              rep['spec_proposed'], 16 * 64 / wall, wall,
              time.time() - t_phase), flush=True)
    del spec, model
    torch.cuda.empty_cache()


def _pct(xs, q):
    from paddle_tpu_torch.serving import percentile
    return percentile(xs, q)


# How each kernel entry computes its products: "wgmma+tma" (warpgroup
# wgmma on TMA-fed shared memory, a producer warpgroup and consumer
# warpgroups). The fused backward launches the dk/dv kernel, then the dq
# kernel; both are wgmma+tma.
DESIGN = {'flash_fwd': 'wgmma+tma', 'flash_fwd_long': 'wgmma+tma',
          'flash_bwd_fused': 'wgmma+tma', 'flash_bwd_dkv': 'wgmma+tma',
          'flash_bwd_dkv_long': 'wgmma+tma', 'flash_bwd_dq': 'wgmma+tma',
          'flash_bwd_dq_long': 'wgmma+tma'}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from paddle_tpu_torch import _build

    card = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    sku = _sku(name)
    print('card: %s (datasheet row %s)' % (card, sku[0]), flush=True)
    print('torch %s, CUDA %s' % (torch.__version__, torch.version.cuda),
          flush=True)

    t0 = time.time()
    outputs = _build.build(['flash_fwd', 'flash_bwd'])
    print('build: %.1f s' % (time.time() - t0), flush=True)
    for src, text in outputs.items():
        entry = ''
        for line in text.splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1] if "'" in line else line
                # from the kernel's name on: its template arguments follow
                entry = entry[entry.rfind('flash_'):]
            if any(key in line for key in ('registers', 'spill', 'wgmma')):
                print('  %s: %s %s' % (src, entry[:64], line.strip()), flush=True)

    fwd_rows = kernel_phase(sku)
    bwd_rows = bwd_kernel_phase(sku)
    long_rows = long_kernel_phase(sku)
    wide_rows = wide_kernel_phase(sku)
    generate_launches = slice_phases()
    engine_parity_phase()
    engine_throughput_phase()
    train_f32_phase()
    train = train_main_phase(sku)
    second = train_seq1024_phase()
    long_train = train_long_phase(sku)

    fwd = next(r for r in fwd_rows
               if r['shape'] == list(TRAIN_SHAPE[:5]) and r['strided'])

    def bwd(which, shape_key):
        return next(r for w, key, r in bwd_rows
                    if w == which and key == shape_key)

    def entry(name, source, line, row, launches, steps, path, shape):
        out = {
            'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/%s.cu' % source,
            'replaces': 'paddle_tpu/ops/flash_attention.py:%d' % line,
            'design': DESIGN[name],
            'launches': launches, 'launches_per_step': launches // steps,
            'path': path, 'max_abs_err': row.get('err_o', row.get(
                'max_abs_err')),
            'ms': row['ms'], 'eager_ms': row['eager_ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'],
            'share_of_bound': row['bound_ms'] / row['ms'],
            'library_ms': row['library_ms'],
            'vs_library': row['ms'] / row['library_ms'], 'shape': shape,
        }
        for key in ('std_ms', 'kernels_ms'):
            if key in row:
                out[key] = row[key]
        return out

    def pair(dq_row, dkv_row):
        """The two-pass pair (dq + dk/dv ms) over the library's whole
        backward at the same shape: no PyTorch call computes dq alone."""
        return (dq_row['ms'] + dkv_row['ms']) / dq_row['library_ms']

    train_shape = 'b=32 h=12 n=m=512 d=64 bfloat16 causal strided'
    second_shape = 'b=8 h=12 n=m=1024 d=64 bfloat16 causal strided'
    kernels = [
        entry('flash_fwd', 'flash_fwd', 137, fwd,
              train['launches']['flash_fwd'], train['steps'],
              'train (generate: %d)' % generate_launches, train_shape),
        dict(entry('flash_bwd_fused', 'flash_bwd', 659,
                   bwd('fused', BWD_MAIN_SHAPE),
                   train['launches']['flash_bwd_fused'], train['steps'],
                   'train', train_shape),
             two_pass_ms=bwd('dq', BWD_MAIN_SHAPE)['ms'] +
             bwd('dkv', BWD_MAIN_SHAPE)['ms']),
        entry('flash_bwd_dq', 'flash_bwd', 580,
              bwd('dq', BWD_SECOND_SHAPE),
              second['launches']['flash_bwd_dq'], second['steps'],
              'train seq 1024', second_shape),
        entry('flash_bwd_dkv', 'flash_bwd', 617,
              bwd('dkv', BWD_SECOND_SHAPE),
              second['launches']['flash_bwd_dkv'], second['steps'],
              'train seq 1024', second_shape),
    ]
    long_shape = 'b=2 h=12 n=m=8192 d=64 bfloat16 causal strided'
    for kernel, source, line, which in (
            ('flash_fwd_long', 'flash_fwd', 343, 'fwd'),
            ('flash_bwd_dq_long', 'flash_bwd', 437, 'dq'),
            ('flash_bwd_dkv_long', 'flash_bwd', 474, 'dkv')):
        kernels.append(entry(kernel, source, line,
                             long_rows[which, LONG_MAIN_SHAPE],
                             long_train['launches'][kernel],
                             long_train['steps'], 'train seq 8192',
                             long_shape))
    pairs = {'flash_bwd_dq': pair(bwd('dq', BWD_SECOND_SHAPE),
                                  bwd('dkv', BWD_SECOND_SHAPE)),
             'flash_bwd_dq_long': pair(long_rows['dq', LONG_MAIN_SHAPE],
                                       long_rows['dkv', LONG_MAIN_SHAPE])}
    for k in kernels:
        if k['name'] in pairs:
            k['pair_vs_library'] = pairs[k['name']]
    body_line = {'flash_fwd': 137, 'flash_bwd_fused': 659,
                 'flash_bwd_dq': 580, 'flash_bwd_dkv': 617}
    wide = [dict(row, route='cuda', design='cuda cores, 16-bit staged',
                 source='paddle_tpu_torch/csrc/%s.cu' % (
                     'flash_fwd' if row['name'] == 'flash_fwd'
                     else 'flash_bwd'),
                 replaces='paddle_tpu/ops/flash_attention.py:%d'
                 % body_line[row['name']],
                 launches=0, path='none (a check at d = 192 / 256)')
            for row in wide_rows]
    print(json.dumps({'kernels_wide': wide}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
