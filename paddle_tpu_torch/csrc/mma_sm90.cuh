// Tensor-core, copy and grid helpers shared by the flash kernels
// (flash_fwd.cu, flash_bwd.cu): mma.sync.m16n8k16 with f32 accumulators for
// bf16 and fp16, ldmatrix fragment loads from shared memory, cp.async tile
// copies, the exponential, and the block order of every kernel.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// Fragment layouts (PTX ISA, mma.m16n8k16 with 16-bit A/B, f32 C/D), for
// lane = 4 * g + t: A holds rows g and g+8, columns 2t, 2t+1 and 2t+8,
// 2t+9; B holds k rows 2t, 2t+1 and 2t+8, 2t+9 of column g; C holds rows g
// and g+8, columns 2t, 2t+1. A score accumulator pair of n-blocks is
// therefore laid out as the A fragment of p @ v over the same 16 keys.

template <typename T> struct MmaOp;
template <> struct MmaOp<__nv_bfloat16> {
    __device__ __forceinline__ static void run(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
        return *reinterpret_cast<uint32_t*>(&v);
    }
};
template <> struct MmaOp<__half> {
    __device__ __forceinline__ static void run(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
    __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(ptr)));
}

// 16-byte global -> shared copy; with pred false it writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr float LOG2E = 1.4426950408889634f;

// 2^x as one ex2.approx, relative error about 2^-22.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// e^x as one ex2.approx of x * log2(e): two instructions where expf takes
// about eight. Its relative error is about 2^-22 + |x| * 2^-24 (the second
// term from rounding x * log2(e) to f32): about 2^-19 at |x| = 30, where the
// backward clamps. That is far below the bf16 / fp16 rounding (2^-9 / 2^-12)
// of the p it feeds; the f32 kernels keep expf. The wgmma kernels fold the
// scale and log2(e) into one factor of the score and call exp2_approx, the
// same instruction with the same error.
__device__ __forceinline__ float exp_e(float x) { return exp2_approx(x * LOG2E); }

// Start the copy of a [ROWS, W] tile (rows row0.. of x) into dst, whose rows
// are W + 8 elements apart (ldmatrix rows then hit distinct banks), by a
// block of THREADS threads; rows at or past `limit` are zero, so a ragged
// last tile contributes nothing.
template <typename T, int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(T* dst, const T* x, long long row_stride,
                                                int row0, int limit) {
    constexpr int CHUNKS = W / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * 8;
        const int row = row0 + r;
        const bool in = row < limit;
        cp_async16(dst + r * (W + 8) + c, in ? x + (long long)row * row_stride + c : x, in);
    }
}

// The (tile, head, batch) a block works on. The grid of every kernel that
// is not persistent (the dq and f32 kernels) is one-dimensional and ordered
// for the causal triangle: the tiles of one
// (b, h) are adjacent, so its K/V stays in L2 while they run, and within it
// the heaviest tile comes first (HEAVY_LAST: the last tile is the heaviest,
// as for query tiles; else the first, as for key tiles), so the lightest
// tiles fill the last wave.
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
