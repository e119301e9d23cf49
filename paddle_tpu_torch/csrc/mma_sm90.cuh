// Helpers shared by the flash kernels (flash_fwd.cu, flash_bwd.cu): packing
// f32 pairs to bf16 / fp16 operands, shared-memory addresses, the
// exponential, and the block order of the kernels that are not persistent.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// Two f32 values packed into one 32-bit register of T (lo in the low half),
// as the 16-bit tensor-core operands and the 16-bit stores take them.
template <typename T> struct MmaOp;
template <> struct MmaOp<__nv_bfloat16> {
    __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
        return *reinterpret_cast<uint32_t*>(&v);
    }
};
template <> struct MmaOp<__half> {
    __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr float LOG2E = 1.4426950408889634f;

// 2^x as one ex2.approx, relative error about 2^-22. The 16-bit kernels take
// e^x as exp2_approx(x * log2 e), with the softmax scale folded into the same
// factor: two instructions where expf takes about eight. The relative error
// is then about 2^-22 + |x| * 2^-24 (the second term from rounding the
// product to f32): about 2^-19 at |x| = 30, where the backward clamps. That
// is far below the bf16 / fp16 rounding (2^-9 / 2^-12) of the p it feeds;
// the f32 kernels keep expf.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The (tile, head, batch) a block works on. The grid of every kernel that
// is not persistent (the f32 kernels) is one-dimensional and ordered for
// the causal triangle: the tiles of one (b, h) are adjacent, so its K/V
// stays in L2 while they run, and within it the heaviest tile comes first
// (HEAVY_LAST: the last tile is the heaviest, as for query tiles; else the
// first, as for key tiles), so the lightest tiles fill the last wave.
struct Tile {
    int t, hi, bi;
};

template <bool HEAVY_LAST>
__device__ __forceinline__ Tile block_tile(int num_tiles, int h) {
    const int bh = blockIdx.x / num_tiles;
    const int r = blockIdx.x % num_tiles;
    return {HEAVY_LAST ? num_tiles - 1 - r : r, bh % h, bh / h};
}

inline dim3 tile_grid(int num_tiles, int h, int b) { return dim3(num_tiles * h * b); }

}  // namespace
