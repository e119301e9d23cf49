"""Compare builds of the flash backward kernels on one NVIDIA GPU.

    python3 flash_bwd_probe.py [--variant NAME=SOURCE.cu[:FLAG,FLAG...]] ...

Builds this tree's paddle_tpu_torch/csrc/flash_bwd.cu and every variant
given (another tree's flash_bwd.cu, or an edited copy; FLAGs are extra
nvcc flags such as -DNAME=1), all with nvcc in parallel, and loads each
library beside the others in one process. Then, at each shape, every
build's dq entry (flash_bwd_dq) and fused entry (flash_bwd_fused) is held
against the plain version (chip_smoke's tolerances) and launched twice
for a bitwise-equal dq; at the timed shapes every build's dq, fused and
dk/dv entries are timed by CUDA-graph replay, the builds in turns and then
in the reverse order, and at the training shape the fused entry's two
kernels are timed apart under the profiler. Prints the registers and
spills of each dq kernel; exits non-zero if a build fails or any check of
this tree's build fails.
"""
import argparse
import ctypes
import math
import os
import subprocess
import sys
import time

import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as fa
import chip_smoke as cs

ENTRIES = ('flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv',
           'flash_bwd_dq_long', 'flash_bwd_dkv_long')

# (b, h, n, m, d, dtype, causal): ragged tiles, both head dims, fp16, the
# non-causal cross-length call, then the timed shapes: the seq-1024
# two-pass path, the training main path and the seq-8192 long path
SHAPES = [
    (1, 2, 700, 700, 64, torch.bfloat16, True),
    (2, 4, 512, 512, 64, torch.float16, True),
    (1, 2, 700, 700, 128, torch.bfloat16, True),
    (2, 8, 640, 1152, 64, torch.bfloat16, False),
    (1, 2, 300, 700, 128, torch.float16, False),
    (8, 12, 1024, 1024, 64, torch.bfloat16, True),
    (32, 12, 512, 512, 64, torch.bfloat16, True),
    (2, 12, 8192, 8192, 64, torch.bfloat16, True),
]
TIMED = SHAPES[-3:]


def _build_all(variants):
    """{name: ctypes library}: this tree's source as 'tree', and each
    variant, built by nvcc processes started together."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        out = os.path.join(_build.BUILD_DIR, 'probe_%s.so' % name)
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path()] + _build.NVCC_FLAGS + flags + ['-o', out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed for %s:\n%s' % (name, text[-4000:]))
        entry = ''
        for line in text.splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1] if "'" in line else line
                entry = entry[entry.rfind('flash_'):]
            if 'bwd_dq' in entry and any(k in line for k in ('registers', 'spill', 'wgmma')):
                print('  %s %s: %s' % (name, entry[:64], line.strip()), flush=True)
        lib = ctypes.CDLL(out)
        for fn_name in ENTRIES:
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
                           [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p])
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME=SOURCE.cu[:FLAG,FLAG...]')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('flash_bwd_probe: CUDA is not available', file=sys.stderr)
        return 1
    print(cs._nvidia_smi(), flush=True)
    variants = {'tree': (os.path.join(_build.CSRC, 'flash_bwd.cu'), [])}
    for spec in args.variant:
        name, _, rest = spec.partition('=')
        src, _, flags = rest.partition(':')
        variants[name] = (os.path.abspath(src), [f for f in flags.split(',') if f])
    t0 = time.time()
    libs = _build_all(variants)
    print('builds: %.1f s' % (time.time() - t0), flush=True)

    def use(name):
        fa._bwd_lib = lambda: libs[name]

    failures = 0
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    for key in SHAPES:
        b, h, n, m, d, dtype, causal = key
        scale = 1 / math.sqrt(d)
        q, k, v = cs._qkv(gen, b, h, n, m, d, dtype, False)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        bwd_args = (q, k, v, do, lse, delta, causal, scale)
        ref_dq = fa.flash_attention_bwd_ref(*bwd_args)[0].float()
        top = ref_dq.abs().max().item()
        calls = {'dq': lambda: fa.flash_bwd_dq_cuda(*bwd_args),
                 'fused': lambda: fa.flash_bwd_fused_cuda(*bwd_args)[0],
                 'dkv': lambda: fa.flash_bwd_dkv_cuda(*bwd_args)[0]}
        for name in libs:
            use(name)
            for which in ('dq', 'fused'):
                first = calls[which]()
                again = calls[which]()
                torch.cuda.synchronize()
                err = (first.float() - ref_dq).abs().max().item()
                ok = (err <= cs.BWD_TOLERANCE[dtype] * top and
                      torch.equal(first, again) and
                      bool(torch.isfinite(first.float()).all()))
                failures += not ok and name == 'tree'
                print('check %s %s %s: dq err %.3g of the largest, repeat %s, %s'
                      % (name, which, key[:5], err / top,
                         'equal' if torch.equal(first, again) else 'DIFFERS',
                         'ok' if ok else 'FAILED'), flush=True)
        if key in TIMED:
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    use(name)
                    print('time %s %s: dq %.4f ms, fused %.4f ms, dkv %.4f ms'
                          % (name, key[:5], cs._graph_ms(calls['dq']),
                             cs._graph_ms(calls['fused']),
                             cs._graph_ms(calls['dkv'])), flush=True)
            if key[2] == 512:
                for name in list(libs) + list(libs)[::-1]:
                    use(name)
                    print('split %s fused: %s' % (
                        name, cs._kernels_ms(calls['fused'], calls=50)),
                        flush=True)
        use('tree')
        del q, k, v, o, lse, do, delta, bwd_args, ref_dq
        torch.cuda.empty_cache()
    print('failures of this tree: %d' % failures, flush=True)
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
