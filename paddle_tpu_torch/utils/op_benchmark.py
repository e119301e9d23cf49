"""Op micro-benchmark harness + perf regression gate (reference:
operators/benchmark/op_tester.cc config-driven op timing,
tools/test_op_benchmark.sh + check_op_benchmark_result.py CI gate;
counterpart of paddle_tpu/utils/op_benchmark.py).

Usage:
    python -m paddle_tpu_torch.utils.op_benchmark --out ops.json
    python -m paddle_tpu_torch.utils.op_benchmark --out new.json \
        --baseline ops.json --threshold 0.15   # fails on >15% regressions

Each config is (name, builder): builder(device=...) returns (fn, args),
the arguments made on that device. fn runs eagerly, `warmup` times and
then `repeat` times between two device synchronisations; each config is
one or a few device ops already, so there is nothing to compile (the JAX
package jits fn, its way to run device code). The default suite covers the
ops the bench model leans on (matmul / flash attention / layernorm / CE)
at the bench model's widths, so a kernel regression is localizable
without rerunning the full model bench. The flash attention config
launches the flash forward kernel (csrc/flash_fwd.cu) on the card,
warmup + repeat times.
"""
import argparse
import json
import time

import numpy as np
import torch

__all__ = ['OP_CONFIGS', 'run_benchmarks', 'compare', 'main']


def _on(arr, dtype, device):
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _dev(device):
    from ..framework import device as device_mod
    return device_mod.resolve(device)


def _matmul(m=1024, k=1024, n=1024, dtype='bfloat16', device=None):
    dt, dev = getattr(torch, dtype), _dev(device)
    a = _on(np.random.RandomState(0).randn(m, k), dt, dev)
    b = _on(np.random.RandomState(1).randn(k, n), dt, dev)
    return lambda a, b: a @ b, (a, b)


def _qkv(b, h, n, d, device):
    rng = np.random.RandomState(0)
    return tuple(_on(rng.randn(b, h, n, d) * 0.2, torch.bfloat16,
                     _dev(device)) for _ in range(3))


def _flash_attention(b=4, h=12, n=512, d=64, causal=True, device=None):
    from ..ops import flash_attention as fa
    return (lambda q, k, v: fa.flash_attention_bhnd(q, k, v, causal=causal),
            _qkv(b, h, n, d, device))


def _sdpa_ref(b=4, h=12, n=512, d=64, device=None):
    from ..ops.flash_attention import _ref_bhnd
    return (lambda q, k, v: _ref_bhnd(q, k, v, True, d ** -0.5),
            _qkv(b, h, n, d, device))


def _layernorm(b=16, n=512, h=768, device=None):
    dev = _dev(device)
    x = _on(np.random.RandomState(0).randn(b, n, h), torch.bfloat16, dev)
    g = torch.ones((h,), dtype=torch.bfloat16, device=dev)
    bb = torch.zeros((h,), dtype=torch.bfloat16, device=dev)

    def ln(x, g, b2):
        mu = torch.mean(x, -1, keepdim=True)
        var = torch.mean((x - mu) ** 2, -1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * g + b2
    return ln, (x, g, bb)


def _softmax_ce(b=16, n=512, v=30528, device=None):
    dev = _dev(device)
    rng = np.random.RandomState(0)
    logits = _on(rng.randn(b * n, v) * 0.1, torch.bfloat16, dev)
    labels = _on(rng.randint(0, v, b * n), torch.int64, dev)

    def ce(logits, labels):
        lp = torch.log_softmax(logits.float(), -1)
        return -torch.mean(torch.take_along_dim(lp, labels[:, None], 1))
    return ce, (logits, labels)


def _conv2d(b=32, c=64, hw=56, k=3, co=64, device=None):
    dev = _dev(device)
    rng = np.random.RandomState(0)
    x = _on(rng.randn(b, c, hw, hw) * 0.1, torch.bfloat16, dev)
    w = _on(rng.randn(co, c, k, k) * 0.1, torch.bfloat16, dev)

    def conv(x, w):
        return torch.nn.functional.conv2d(x, w, padding='same')
    return conv, (x, w)


def _embedding(v=30528, h=768, b=16, n=512, device=None):
    dev = _dev(device)
    rng = np.random.RandomState(0)
    table = _on(rng.randn(v, h) * 0.02, torch.bfloat16, dev)
    ids = _on(rng.randint(0, v, (b, n)), torch.int64, dev)
    return lambda t, i: t[i], (table, ids)


OP_CONFIGS = [
    ('matmul_1k_bf16', _matmul),
    ('flash_attention_b4h12n512d64', _flash_attention),
    ('sdpa_reference_b4h12n512d64', _sdpa_ref),
    ('layernorm_16x512x768', _layernorm),
    ('softmax_ce_16x512_v30k', _softmax_ce),
    ('conv2d_32x64x56', _conv2d),
    ('embedding_30k_768', _embedding),
]


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_benchmarks(configs=None, repeat=20, warmup=3, device=None):
    """[{'op', 'mean_ms', 'ok'}] or [{'op', 'ok', 'error'}] a config, on
    `device` (the current device when None)."""
    dev = _dev(device)
    results = []
    for name, builder in (configs or OP_CONFIGS):
        try:
            fn, args = builder(device=dev)
            for _ in range(warmup):
                fn(*args)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(repeat):
                fn(*args)
            _sync(dev)
            dt = (time.perf_counter() - t0) / repeat
            results.append({'op': name, 'mean_ms': round(dt * 1e3, 4),
                            'ok': True})
        except Exception as e:
            results.append({'op': name, 'ok': False, 'error': repr(e)[:300]})
    return results


def compare(baseline, current, threshold=0.15):
    """check_op_benchmark_result.py analog: list of regressions where
    current mean_ms exceeds baseline by more than `threshold` fraction."""
    base = {r['op']: r for r in baseline if r.get('ok')}
    regressions = []
    for r in current:
        if not r.get('ok'):
            continue
        b = base.get(r['op'])
        if b and r['mean_ms'] > b['mean_ms'] * (1.0 + threshold):
            regressions.append({
                'op': r['op'], 'baseline_ms': b['mean_ms'],
                'current_ms': r['mean_ms'],
                'regression': round(r['mean_ms'] / b['mean_ms'] - 1.0, 3)})
    return regressions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=None)
    ap.add_argument('--baseline', default=None)
    ap.add_argument('--threshold', type=float, default=0.15)
    ap.add_argument('--repeat', type=int, default=20)
    args = ap.parse_args(argv)

    results = run_benchmarks(repeat=args.repeat)
    print(json.dumps(results, indent=1))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f)
    if args.baseline:
        with open(args.baseline) as f:
            base = json.load(f)
        regs = compare(base, results, args.threshold)
        if regs:
            print('PERF REGRESSIONS:', json.dumps(regs, indent=1))
            return 1
        print('perf gate: OK')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
