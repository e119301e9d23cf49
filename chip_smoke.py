"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure exits non-zero:
  1. build   - nvcc builds every kernel of the path from paddle_tpu_torch/csrc.
  2. kernel  - each kernel against its plain PyTorch version on the card at
               the main path's shapes and more, with times, the card's bound
               and a PyTorch library call's time as a yardstick.
  3. slice, f32  - GPT-2 small (seeded weights) prefill logits on the card
               against the same weights on the CPU plain path; greedy tokens.
  4. slice, bf16 - the main path: generate() on 8 prompts of 768 tokens,
               128 new tokens, greedy; the flash kernel must launch exactly
               once per layer. A 64-token run must not launch it.
The last lines are the card's name and power limit as nvidia-smi gives
them, a {"kernels": [...]} line and the {"ok": true, ...} line.
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
# the main path's shape
KERNEL_SHAPES = [
    (8, 12, 768, 768, 64, torch.bfloat16, True, True),
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


def kernel_phase(sku):
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    for b, h, n, m, d, dtype, causal, strided in KERNEL_SHAPES:
        scale = 1.0 / math.sqrt(d)
        if strided:
            _check(n == m, 'strided inputs share one sequence length')
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device='cuda')
            qkv[:, :, 2] *= 0.5
            qkv = qkv.to(dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q = torch.randn((b, h, n, d), generator=gen, device='cuda')
            k = torch.randn((b, h, m, d), generator=gen, device='cuda')
            v = 0.5 * torch.randn((b, h, m, d), generator=gen, device='cuda')
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
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
        ms = _time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        plain_ms = _time_ms(
            lambda: fa.flash_attention_fwd_ref(q, k, v, causal, scale),
            iters=3, warmup=1)
        library_ms = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale))
        bound_ms, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal,
                                             sku)
        row = {'shape': [b, h, n, m, d], 'dtype': str(dtype).split('.')[-1],
               'causal': causal, 'strided': strided, 'err_o': err_o,
               'err_lse': err_lse, 'ms': ms, 'plain_ms': plain_ms,
               'library_ms': library_ms, 'bound_ms': bound_ms,
               'bound_by': bound_by}
        print('kernel flash_fwd %s' % json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


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

    fa.flash_fwd_cuda.launches = 0
    fa.counts['flash'] = fa.counts['rejected'] = 0
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

    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids_cuda, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_s = sorted(prefill_s)[1]
    decode_tps = 8 * 127 / max(total_s - prefill_s, 1e-9)
    print('slice bf16: generate 8 x 768 + 128 new in %.1f ms, prefill '
          '%.2f ms, decode %.1f tokens/s, peak memory %.2f GiB, flash '
          'launches %d, bf16 vs f32 last logits %.3g of range'
          % (total_s * 1e3, prefill_s * 1e3, decode_tps, peak / 2 ** 30,
             launches, rel), flush=True)

    for label, new in (('prefill', 1), ('prefill + 32 decode steps', 33)):
        wall, dev, top, ops = _profile(
            lambda: model.generate(ids_cuda, max_new_tokens=new))
        print('profile %s: wall %.2f ms, device kernels %.2f ms, busy '
              'share %.3f; top kernels: %s; top aten ops: %s'
              % (label, wall, dev, dev / wall,
                 '; '.join('%s %.2f ms x%d' % t for t in top),
                 '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    return launches


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
    outputs = _build.build(['flash_fwd'])
    print('build: %.1f s' % (time.time() - t0), flush=True)
    for src, text in outputs.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                print('  %s: %s' % (src, line.strip()), flush=True)

    rows = kernel_phase(sku)
    launches = slice_phases()

    main_row = rows[0]
    kernels = [{
        'name': 'flash_fwd', 'route': 'cuda',
        'source': 'paddle_tpu_torch/csrc/flash_fwd.cu',
        'replaces': 'paddle_tpu/ops/flash_attention.py:137',
        'launches': launches,
        'max_abs_err': main_row['err_o'],
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
        'shape': 'b=8 h=12 n=m=768 d=64 bfloat16 causal',
    }]
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
