// Hopper building blocks of the flash kernels' tensor-core paths
// (flash_fwd.cu, flash_bwd.cu), in raw PTX for sm_90a:
// - TMA: a tile of R rows and W columns of a rank-4 (d, row, head, batch)
//   tensor map is W / B boxes of R x B elements (R x 128 bytes each; B = 64
//   for the 16-bit types, 32 for f32), copied by cp.async.bulk.tensor into
//   shared memory in the 128-byte swizzle, completion counted in bytes on
//   an mbarrier. Rows past the end of the map arrive as zeros.
// - mbarriers: init, arrive, arrive with expected bytes, and the parity wait;
//   Ring carries the stage and phase bit of a ring of buffers.
// - wgmma.mma_async m64nNk16 with f32 accumulators in its SS form (A and B
//   from shared memory, both K-major; N = 32, 64 or 128) and its RS form
//   (A from registers, B MN-major; N = 64 or 128), with the shared-memory matrix
//   descriptors of the 128-byte swizzle, fence, commit and wait.
// - setmaxnreg, and on the host the tensor-map encoding, reached through
//   cudaGetDriverEntryPointByVersion (no -lcuda).
//
// A swizzled box is R rows of 128 bytes, 1024-byte aligned; the 16-byte
// chunk c of row r lies at chunk c ^ (r % 8) of the row (what TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B and what wgmma reads with layout type 1).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"  // smem_addr, Tile

namespace {

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier starts in
// phase 0, so waiting on parity 1 returns at once (the "previous" phase).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}

// The position in a ring of STAGES buffers, each with a "full" barrier (the
// producer's copies landed) and an "empty" one (the consumers are done with
// it): the stage, and the parity of its current phase, which flips each time
// the ring wraps. Consumers wait on full with `phase`, the producer on empty
// with `phase ^ 1` (its first round finds every buffer free).
template <int STAGES>
struct Ring {
    int stage = 0;
    uint32_t phase = 0;
    __device__ __forceinline__ void advance() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }
};

// -- TMA ---------------------------------------------------------------------

// One box (64 columns x the map's box rows) at (col, row, head, batch).
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int col, int row, int head, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head),
        "r"(batch)
        : "memory");
}

// The columns of a 128-byte box of T: 64 of a 16-bit type, 32 of f32
template <typename T>
__host__ __device__ constexpr int box_cols() {
    return 128 / (int)sizeof(T);
}

// All W / box_cols<T>() boxes of the rows row0.. of (head, batch) into
// `tile`, boxes ROWS x box_cols<T>() elements apart; ROWS is the map's box
// height.
template <int W, int ROWS, typename T>
__device__ __forceinline__ void tma_load_rows(T* tile, const CUtensorMap* map, uint64_t* bar,
                                              int row0, int head, int batch) {
    constexpr int BOX = box_cols<T>();
#pragma unroll
    for (int c = 0; c < W / BOX; ++c)
        tma_load_box(tile + c * ROWS * BOX, map, bar, c * BOX, row0, head, batch);
}

// -- wgmma -------------------------------------------------------------------

// The shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets, all in 16-byte units, and
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A K-major operand (the contraction runs along the 128-byte rows): its k16
// slice kk lies in box kk / 4, 32 bytes per slice into the row (the hardware
// applies the swizzle to the advanced address); groups of 8 rows are 1024
// bytes apart (SBO). The leading offset is unused in this layout.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, uint32_t box_bytes, int kk) {
    return sw128_desc(tile + (kk / 4) * box_bytes + (kk % 4) * 32, 16, 1024);
}

// An MN-major B (K rows of N contiguous columns, 64 columns a box): its k16
// slice kc starts 16 rows (2048 bytes) in; groups of 8 rows along K are 1024
// bytes apart (SBO), the next 64 columns one box further (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, uint32_t box_bytes, int kc) {
    return sw128_desc(tile + kc * 2048, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers to this point of the program: accumulators after a wait
// (the asynchronous product writes them until then), operands before one.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator layout of m64nNk16 (f32), for thread 32 w + 4 g + t of the
// warpgroup: d[4 j + e] is row 16 w + g + 8 (e >> 1), column 8 j + 2 t +
// (e & 1). The register A operand of m64nNk16 (16-bit) is, per warp, the
// mma.m16n8k16 A fragment: a[0] rows g, k 2t..2t+1; a[1] rows g + 8; a[2]
// and a[3] the same rows at k + 8. So the accumulator columns 16 c..16 c + 15
// packed in pairs are the A operand of the k16 slice c of the next product.

// m64n32k16: A and B from shared memory, both K-major
#define PT_WGMMA_SS_32(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
        : "l"(da), "l"(db), "r"(scale_d))

// m64n64k16: A and B from shared memory, both K-major
#define PT_WGMMA_SS_64(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "l"(da), "l"(db), "r"(scale_d))

// m64n64k16: A from registers, B from shared memory, MN-major
#define PT_WGMMA_RS_64(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// m64n128k16: A and B from shared memory, both K-major
#define PT_WGMMA_SS_128(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "l"(da), "l"(db), "r"(scale_d))

// m64n128k16: A from registers, B from shared memory, MN-major
#define PT_WGMMA_RS_128(TY) \
    asm volatile( \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define PT_WGMMA_TYPED(FORM)                                        \
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {               \
        FORM("bf16");                                               \
    } else {                                                        \
        static_assert(std::is_same_v<T, __half>, "bf16 or fp16");   \
        FORM("f16");                                                \
    }

// d (+)= A B over one k16 slice, A (64 x 16) and B (16 x N) from shared
// memory, both K-major; scale_d == 0 overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
    static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
    if constexpr (N == 32) {
        PT_WGMMA_TYPED(PT_WGMMA_SS_32)
    } else if constexpr (N == 64) {
        PT_WGMMA_TYPED(PT_WGMMA_SS_64)
    } else {
        PT_WGMMA_TYPED(PT_WGMMA_SS_128)
    }
}

// d (+)= A B over one k16 slice, A (64 x 16) from registers, B (16 x N) from
// shared memory, MN-major.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
    static_assert(N == 64 || N == 128, "wgmma width");
    if constexpr (N == 64) {
        PT_WGMMA_TYPED(PT_WGMMA_RS_64)
    } else {
        PT_WGMMA_TYPED(PT_WGMMA_RS_128)
    }
}

#undef PT_WGMMA_TYPED

// -- registers ---------------------------------------------------------------

// setmaxnreg: the whole warpgroup gives up or takes registers; it must run
// where the compiler sees one role per warpgroup, and it moves registers
// only within a block. In a block of one producer and two consumer
// warpgroups (384 threads, one block an SM) every thread starts with 168
// (65536 / 384, rounded down to 8); the producer gives up 128 x (168 - 40)
// and the consumers take 256 x (232 - 168). With 24 the producer of the
// persistent dk/dv kernel spilled.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int N>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The first 1024-byte boundary at or after p (swizzled boxes need it).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
    const uint32_t a = smem_addr(p);
    return p + (((a + 1023) & ~1023u) - a);
}

// -- persistent blocks ---------------------------------------------------------

// The work of a persistent launch, one block an SM: units u = blockIdx.x,
// blockIdx.x + gridDim.x, ..., where a unit is the pair of tiles j and
// num_tiles - 1 - j of one (b, h), the heavier first. Every unit of a causal
// launch then carries the same work (a static stride balances the SMs), and
// the tiles a block walks in a row share their K/V in L2. With an odd count
// the middle tile is a unit alone.
struct TilePairs {
    int num_tiles;  // tiles of one (b, h)
    int per_bh;     // units of one (b, h)
    int units;      // units of the launch
    __device__ __forceinline__ TilePairs(int tiles, int bh_count)
        : num_tiles(tiles), per_bh((tiles + 1) / 2), units((tiles + 1) / 2 * bh_count) {}
    // 1 or 2
    __device__ __forceinline__ int count(int u) const {
        return 2 * (u % per_bh) + 1 == num_tiles ? 1 : 2;
    }
    // tile s (0: the heavier) of unit u; HEAVY_LAST: the last tile of a
    // (b, h) is the heaviest (query tiles under the causal mask), else the
    // first (key tiles)
    template <bool HEAVY_LAST>
    __device__ __forceinline__ Tile tile(int u, int s, int h) const {
        const int bh = u / per_bh;
        const int j = u % per_bh;
        const int heavy = HEAVY_LAST ? num_tiles - 1 - j : j;
        return {s == 0 ? heavy : num_tiles - 1 - heavy, bh % h, bh / h};
    }
};

// The grid of a persistent launch over `units` work units: one block an SM
// of the current device, no more blocks than units.
inline dim3 persistent_grid(int units) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 0;
    return dim3(sms > 0 && sms < units ? sms : units);
}

// -- host: tensor maps -------------------------------------------------------

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime, so the
// library links no -lcuda; null if the lookup fails.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
    static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
    return fn;
}

// The rank-4 map (d, row, head, batch) of a [b, h, rows, d] operand of type
// T (bf16, fp16 or f32) with (batch, head, row) strides in elements (the
// last dimension contiguous), read in boxes of box_cols<T>() columns (128
// bytes) x box_rows rows in the 128-byte swizzle. Rows at or past `rows`
// read as zeros, never the next head's. The base must be 16-byte aligned
// and the strides multiples of 16 bytes (the wrappers' _rows_aligned).
// Returns cudaErrorInvalidValue if the encoder refuses the map,
// cudaErrorNotSupported if there is no encoder.
template <typename T>
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                                   int batch, const long long* strides, int box_rows) {
    static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half> ||
                      std::is_same_v<T, float>,
                  "bf16, fp16 or f32 operands");
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                                (cuuint64_t)batch};
    // byte strides of dims 1..3: row, head, batch
    constexpr cuuint64_t item = sizeof(T);
    const cuuint64_t byte_strides[3] = {(cuuint64_t)strides[2] * item,
                                        (cuuint64_t)strides[1] * item,
                                        (cuuint64_t)strides[0] * item};
    const cuuint32_t box[4] = {(cuuint32_t)box_cols<T>(), (cuuint32_t)box_rows, 1, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    const CUtensorMapDataType type = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : std::is_same_v<T, __nv_bfloat16>
                                         ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    const CUresult res = encode(map, type, 4, const_cast<void*>(base), dims, byte_strides, box,
                                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
