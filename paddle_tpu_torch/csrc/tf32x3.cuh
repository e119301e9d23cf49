// Split-TF32 products for the f32 flash kernels (flash_fwd.cu, flash_bwd.cu):
// f32-accurate matrix products on the tensor cores.
//
// The tensor cores take f32 operands only as TF32 (10 mantissa bits). An f32
// x is split into two TF32 words, hi = x with its low 13 mantissa bits
// cleared and lo = x - hi (exact in f32), of which the tensor core reads the
// top 19 bits; a product a b is then lo(a) hi(b) + hi(a) lo(b) + hi(a)
// hi(b), the small terms first (CUTLASS's 3xTF32), with the lo lo term
// dropped. What is lost is below 2^-20 of |a||b|: the f32 contract holds (a
// single TF32 product misses it by a factor of ~20 at the flash kernels'
// inputs; tests/test_torch_flash_f32_split.py emulates both in numpy). hi
// is made here by the mask, so hi + lo is x whether the tensor core
// truncates or rounds the low bits of a word; how it reads lo moves a
// product by at most 2^-21 of |a||b|.
//
// The products are mma.sync.m16n8k8 .tf32 with f32 accumulators, each warp
// on its own 16 rows. Operands come from shared memory that TMA fills in
// the 128-byte swizzle, f32 tiles of 32 columns a box (sm90_async.cuh), and
// are split in registers as they are loaded, so no lo copy is kept in
// shared memory:
// - K-major operands (the contraction runs along a row of the tile) by
//   ldmatrix.x4, four 8 x 4 f32 matrices a load: the A fragment of 16 rows
//   x 8 columns, or the B fragments of two n8 tiles;
// - MN-major B operands (the contraction runs down the tile's rows: V in
//   p v, do and q in the backward's dv and dk, K in dq) by 32-bit loads,
//   which the swizzle keeps free of bank conflicts.
// The contraction order within each k8 slice is permuted so that an f32
// accumulator of one product is, unshuffled, the A fragment of the next:
// logical k = t holds column 2t of the slice and k = t + 4 column 2t + 1
// (frag_from_acc, and the rows MnmajorLoader reads).
#pragma once

#include <cstdint>

namespace {

constexpr uint32_t TF32_MASK = 0xffffe000u;

// A (16 x 8) and B (8 x 8) fragments of mma.m16n8k8 .tf32, split (hi and
// lo as the words the tensor core reads). For lane
// 4 g + t: a[0] row g, k t; a[1] row g + 8, k t; a[2] row g, k t + 4; a[3]
// row g + 8, k t + 4; b[0] k t, column g; b[1] k t + 4, column g.
struct FragA {
    uint32_t hi[4], lo[4];
};
struct FragB {
    uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& hi, uint32_t& lo) {
    hi = x & TF32_MASK;
    lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(const uint32_t (&x)[4]) {
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(x[i], f.hi[i], f.lo[i]);
    return f;
}

__device__ __forceinline__ FragB split_b(uint32_t x0, uint32_t x1) {
    FragB f;
    tf32_split(x0, f.hi[0], f.lo[0]);
    tf32_split(x1, f.hi[1], f.lo[1]);
    return f;
}

// The A fragment of a product whose k8 slice is the n8 tile `c` of an f32
// accumulator (d[0], d[1]: row g, columns 2t, 2t + 1; d[2], d[3]: row g + 8),
// in the permuted contraction order: k t is column 2t, k t + 4 column 2t + 1.
__device__ __forceinline__ FragA frag_from_acc(const float (&c)[4]) {
    const uint32_t x[4] = {__float_as_uint(c[0]), __float_as_uint(c[2]), __float_as_uint(c[1]),
                           __float_as_uint(c[3])};
    return split_a(x);
}

// d += a b: one m16n8k8 TF32 product, f32 accumulators (a pure function
// of its registers: not volatile, so the compiler may interleave products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split TF32: lo hi, hi lo, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
}

// -- shared-memory f32 tiles in the 128-byte swizzle ---------------------------
//
// A TMA-filled f32 tile of ROWS rows is boxes of 32 columns (ROWS x 128
// bytes) one after another; the 16-byte chunk c (columns 4c..4c + 3) of row
// r lies at chunk c ^ (r % 8) of its box row. The loaders below hold each
// lane's offsets into a tile (its row and its swizzled chunks), made once a
// kernel, so a load inside the unrolled product loops is the tile's base
// plus one of these offsets plus an immediate: the offsets of every load
// held apart took the registers that the accumulators need.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

// A K-major operand by ldmatrix.x4 (four 8 x 4 f32 matrices a load). Lanes
// 0-7, 8-15, 16-23 and 24-31 address the rows of matrix 0 to 3: with
// SECOND_ROWS matrix 1 and 3 are rows 8.. (the A fragment of 16 rows:
// a[0] rows 0-7 columns 0-3 of the k8 slice, a[1] rows 8-15, a[2] and a[3]
// columns 4-7), else matrix 2 and 3 are (two n8 tiles of B: b[0], b[1] of
// tile j, then of tile j + 1). off[i] serves the k8 slices kk with
// kk % 4 == i; kk / 4 picks the box.
template <int ROWS, bool SECOND_ROWS>
struct KmajorLoader {
    uint32_t off[4];
    // row0: the first row of the fragment (A) or of the n8 tile pair (B, 0)
    __device__ __forceinline__ explicit KmajorLoader(int row0) {
        const int lane = threadIdx.x & 31;
        const int row = row0 + (lane & 7) + (SECOND_ROWS ? ((lane >> 3) & 1) : (lane >> 4)) * 8;
        const int half = SECOND_ROWS ? (lane >> 4) : ((lane >> 3) & 1);  // columns 4..7
#pragma unroll
        for (int i = 0; i < 4; ++i) off[i] = row * 128 + ((((2 * i + half) ^ row) & 7) << 4);
    }
    __device__ __forceinline__ void load(uint32_t (&x)[4], uint32_t tile, int row_imm,
                                         int kk) const {
        ldsm_x4(x, tile + (kk >> 2) * (ROWS * 128) + row_imm * 128 + off[kk & 3]);
    }
};

// The A fragment of 16 rows (from the loader's row0), k8 slice kk, split.
template <int ROWS>
__device__ __forceinline__ FragA ld_a(const KmajorLoader<ROWS, true>& ld, uint32_t tile, int kk) {
    uint32_t x[4];
    ld.load(x, tile, 0, kk);
    return split_a(x);
}

// The B fragments of the n8 tiles j and j + 1 (rows 8 j.. 8 j + 15 of the
// tile: the product's columns), k8 slice kk, split; the loader made at row 0.
template <int ROWS>
__device__ __forceinline__ void ld_b_pair(FragB& b0, FragB& b1,
                                          const KmajorLoader<ROWS, false>& ld, uint32_t tile,
                                          int j, int kk) {
    uint32_t x[4];
    ld.load(x, tile, 8 * j, kk);
    b0 = split_b(x[0], x[1]);
    b1 = split_b(x[2], x[3]);
}

// An MN-major B (the contraction runs down the tile's rows) by 32-bit loads:
// the fragment of the n8 tile j (columns 8 j..), k8 slice c (rows 8 c..),
// in the permuted order: k t is row 8 c + 2 t, k t + 4 row 8 c + 2 t + 1.
// The rows of a lane are 2t and 2t + 1 mod 8, so the swizzle spreads a
// warp's 32 loads over the 32 banks. off[r][i] serves row 2t + r and the
// tiles j with j % 4 == i; j / 4 picks the box.
template <int ROWS>
struct MnmajorLoader {
    uint32_t off[2][4];
    __device__ __forceinline__ MnmajorLoader() {
        const int lane = threadIdx.x & 31;
        const int g = lane >> 2;
        const int t = lane & 3;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                off[r][i] = (2 * t + r) * 128 + (((2 * i + (g >> 2)) ^ (2 * t + r)) << 4) +
                            (g & 3) * 4;
    }
    __device__ __forceinline__ FragB load(uint32_t tile, int c, int j) const {
        const uint32_t at = tile + (j >> 2) * (ROWS * 128) + c * 1024;
        return split_b(lds32(at + off[0][j & 3]), lds32(at + off[1][j & 3]));
    }
};

}  // namespace
