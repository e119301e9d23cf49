// Tensor-core and copy helpers shared by the flash kernels (flash_fwd.cu,
// flash_bwd.cu): mma.sync.m16n8k16 with f32 accumulators for bf16 and fp16,
// ldmatrix fragment loads from shared memory, and cp.async copies.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

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

}  // namespace
