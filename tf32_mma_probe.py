"""The rate of `mma.sync.m16n8k8` TF32 products alone on one NVIDIA GPU.

    python3 tf32_mma_probe.py

The f32 flash kernels (paddle_tpu_torch/csrc/tf32x3.cuh) take every f32
product as three of these. This times a kernel that does nothing else:
each warp of a block an SM issues `chains` independent accumulator chains
of products in a loop, and the rate is their flops over the device time
(CUDA events). It is the ceiling of the kernels' design, beside the
card's TF32 datasheet peak, which wgmma can reach and mma.sync cannot be
assumed to. Exits non-zero without CUDA.
"""
import ctypes
import os
import subprocess
import sys

import torch

from paddle_tpu_torch import _build
import chip_smoke as cs

SOURCE = r'''
#include <cstdint>
#include <cuda_runtime.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
    float d[CHAINS][4] = {};
    const uint32_t x = threadIdx.x;
    const uint32_t a[4] = {x, 3 * x, 5 * x, 7 * x};
    const uint32_t b[2] = {11 * x, 13 * x};
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    float s = 0.f;
    for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}
extern "C" int run(float* out, int blocks, int threads, int iters, int chains) {
    if (chains == 4) mma_loop<4><<<blocks, threads>>>(out, iters);
    else mma_loop<8><<<blocks, threads>>>(out, iters);
    return (int)cudaGetLastError();
}
'''


def main():
    if not torch.cuda.is_available():
        print('tf32_mma_probe: CUDA is not available', file=sys.stderr)
        return 1
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, 'tf32_mma_probe.cu')
    lib_path = os.path.join(_build.BUILD_DIR, 'libtf32_mma_probe.so')
    with open(src, 'w') as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path()] + _build.NVCC_FLAGS + ['-o', lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.restype = ctypes.c_int
    lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(cs._nvidia_smi(), flush=True)
    out = torch.empty(sms * 16 * 32, device='cuda')
    iters = 20000
    for chains in (4, 8):
        for warps in (4, 8, 16):
            args = (out.data_ptr(), sms, warps * 32)
            if lib.run(*args, 100, chains) != 0:
                raise RuntimeError('mma_loop launch failed')
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(*args, iters, chains)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            flops = sms * warps * iters * chains * 2 * 16 * 8 * 8
            print('mma.sync m16n8k8 tf32: %d chains a warp, %d warps an SM: '
                  '%.1f TFLOP/s' % (chains, warps, flops / ms / 1e9), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
