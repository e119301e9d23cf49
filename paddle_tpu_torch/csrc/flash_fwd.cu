// Flash-attention forward for Hopper (sm_90a): o and lse = m + log(l).
//
// Replaces the TPU Pallas kernel paddle_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd_impl). It computes the same function, not the same
// blocks: one thread block per (batch, head, tile of 64 query rows) walks the
// K/V tiles in a loop, keeping a running max, a running sum and the output
// accumulator in f32 registers, so the [n, m] score matrix never reaches
// device memory.
//
// Numeric contract (the TPU kernel's _mm_f32): products of native-dtype
// operands summed in f32 (a bf16 or fp16 product is exact in f32), the
// scale applied to the f32 scores, softmax in f32, and p cast to v's dtype
// before p @ v. Causal masking is top-left (key j is visible to query i
// when j <= i), which is the n == m contract of the host side; the host
// routes cross-length causal elsewhere before any launch.
//
// What bounds it on the card. At the GPT-2-small prefill shape (b=8, h=12,
// n=m=768, d=64, bf16, causal) the kernel must read q, k, v and write o
// (4 x 9.4 MB) and lse (0.3 MB): ~38 MB, 11.4 us at the H100 SXM's
// 3.35 TB/s. Its causal work is 4*d*b*h*n*(n+1)/2 ~ 7.3 GFLOP, 7.3 us at
// the 989 TFLOP/s bf16 tensor-core peak. So the bound is the bytes, and
// each K/V element is read from device memory once per query tile.
//
// Two paths:
// - bf16 / fp16 (flash_fwd_mma_kernel): 4 warps, 16 query rows each, on the
//   tensor cores through mma.sync.m16n8k16 with f32 accumulators. Tiles are
//   copied to shared memory with cp.async, the next K/V tile while the
//   current one is used, and read into mma fragments with ldmatrix. The
//   probabilities go from the score accumulators straight into the A
//   fragments of p @ v, rounded to the input dtype on the way.
// - f32 (flash_fwd_f32_kernel): f32 FMAs on the CUDA cores, each thread on
//   a 4x4 register tile of scores (float4 shared-memory reads, 2 loads per
//   16 FMAs), so an f32 call keeps full f32 products.
// wgmma, TMA and warp specialisation are later work.
//
// flash_fwd_long() launches the same kernels. It replaces the TPU kernel
// paddle_tpu/ops/flash_attention.py:_fwd_kernel_long (launched by
// _fwd_impl_long for max(n, m) >= 4096). The TPU needs a second kernel
// because its standard one stages the whole K/V of a (b, h) in VMEM, which
// runs out at 8k; the kernel here stages 64-key tiles at any length, so that
// reason does not carry over. What changes at n >= 4096 on the H100 is the
// bound. At the long training shape (b=2, h=12, n=m=8192, d=64, bf16,
// causal) the bytes are q, k, v, o (4 x 25.2 MB) and lse: 30 us at
// 3.35 TB/s; the work is 4*d*b*h*n*(n+1)/2 = 206 GFLOP, 208 us at the
// 989 TFLOP/s bf16 peak. So operations bound it, and the causal triangle is
// 128 tiles deep. Three choices serve that, and they measured faster at
// every length from 512 on, so every launch takes them:
// - the exponentials are one ex2.approx each (exp_e), where expf costs about
//   eight instructions: at 64 keys a tile a thread computes 32 of them for
//   64 products, so they, not the tensor cores, held the issue slots;
// - a register cap that holds 4 blocks on an SM at d = 64 (without it the
//   compiler takes 144 registers, which hold 3);
// - a one-dimensional grid in which the tiles of one (b, h) are adjacent and
//   the heaviest query tile (the last) starts first.
// Larger blocks that feed more products per K/V tile loaded (8 warps, or 2
// m-tiles of 16 rows a warp) measured no faster. The kernels mask only the
// tiles that cross the diagonal or the end of the keys.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// The C entry point flash_fwd() launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // keys per K/V tile
constexpr float MASKED = -1e30f;  // the TPU kernel's _NEG_INF

struct FwdParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;              // [b, h, n] f32, contiguous
    long long sq[3], sk[3], sv[3], so[3];  // strides of (b, h, row), in elements
    int h, n, m;
    float scale;
    int causal;
};

// Number of K/V tiles a query tile starting at q0 walks: causal runs stop
// at the tile that holds the diagonal of its last row.
__device__ __forceinline__ int kv_tiles(const FwdParams& p, int q0) {
    const int num_kt = cdiv(p.m, BN);
    if (!p.causal) return num_kt;
    const int last_row = min(q0 + BM, p.n) - 1;
    return min(num_kt, last_row / BN + 1);
}

// Whether the K/V tile at kv0 needs the mask for the query rows q0..: it
// holds keys past the end, or (causal) a key above some row's diagonal.
__device__ __forceinline__ bool edge_tile(const FwdParams& p, int q0, int kv0) {
    return kv0 + BN > p.m || (p.causal && kv0 + BN - 1 > q0);
}

__device__ __forceinline__ float masked_score(float s, const FwdParams& p, int row, int col) {
    return (col >= p.m || (p.causal && col > row)) ? MASKED : s * p.scale;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores through mma.sync.m16n8k16 (the helpers and the
// fragment layouts are in mma_sm90.cuh).

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows
// The register cap: __launch_bounds__ holds MINB blocks on an SM, 65536 /
// (128 * MINB) registers a thread (at d = 128 the compiler's own choice).
template <int D> constexpr int mma_minb() { return D == 64 ? 4 : 2; }

template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }  // padded row: ldmatrix rows hit distinct banks

template <int D>
constexpr size_t mma_smem_bytes() {
    // q tile, then two buffers each of k and v
    return (size_t)(BM + 4 * BN) * mma_ld<D>() * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS, mma_minb<D>())
    flash_fwd_mma_kernel(const FwdParams p) {
    constexpr int LD = mma_ld<D>();
    constexpr int KSTEPS = D / 16;  // 16-deep slices of the head dim
    constexpr int NB = BN / 8;      // 8-key blocks of a score tile
    constexpr int DB = D / 8;       // 8-column blocks of the output
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Qs = reinterpret_cast<T*>(smem_raw);
    T* Ks = Qs + BM * LD;       // two buffers
    T* Vs = Ks + 2 * BN * LD;   // two buffers

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const Tile tile = block_tile<true>(cdiv(p.n, BM), p.h);
    const int q0 = tile.t * BM;
    const int hi = tile.hi;
    const int bi = tile.bi;

    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    T* o = static_cast<T*>(p.o) + bi * p.so[0] + hi * p.so[1];

    const int kt_end = kv_tiles(p, q0);
    load_rows_async<T, D, BM, MMA_THREADS>(Qs, q, p.sq[2], q0, p.n);
    load_rows_async<T, D, BN, MMA_THREADS>(Ks, k, p.sk[2], 0, p.m);
    load_rows_async<T, D, BN, MMA_THREADS>(Vs, v, p.sv[2], 0, p.m);
    cp_async_commit();

    uint32_t qf[KSTEPS][4];
    float acc[DB][4];
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

    for (int kt = 0; kt < kt_end; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < kt_end) {  // fetch the next tile while this one is used
            load_rows_async<T, D, BN, MMA_THREADS>(Ks + (buf ^ 1) * BN * LD, k, p.sk[2],
                                                   (kt + 1) * BN, p.m);
            load_rows_async<T, D, BN, MMA_THREADS>(Vs + (buf ^ 1) * BN * LD, v, p.sv[2],
                                                   (kt + 1) * BN, p.m);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt == 0) {
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks)
                ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
        }
        const T* Kb = Ks + buf * BN * LD;
        const T* Vb = Vs + buf * BN * LD;
        const int kv0 = kt * BN;

        // s = q @ k^T: 16 rows x 64 keys per warp
        float s[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
            for (int nb = 0; nb < NB; nb += 2) {
                uint32_t b[4];  // B fragments of key blocks nb and nb + 1
                ldmatrix_x4(b, Kb + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                                   ((lane >> 3) & 1) * 8);
                MmaOp<T>::run(s[nb], qf[ks], b[0], b[1]);
                MmaOp<T>::run(s[nb + 1], qf[ks], b[2], b[3]);
            }
        }

        // online softmax over rows row_a (e = 0, 1) and row_a + 8 (e = 2, 3);
        // a row's keys live in the 4 lanes of a quad
        const bool edge = edge_tile(p, q0, kv0);
        float mx[2] = {MASKED, MASKED};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = edge ? masked_score(s[nb][e], p, row_a + (e >> 1) * 8,
                                                    kv0 + nb * 8 + 2 * t + (e & 1))
                                     : s[nb][e] * p.scale;
                s[nb][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            alpha[r] = exp_e(m_run[r] - m_new);
            m_run[r] = m_new;
        }
        uint32_t pf[NB / 2][4];  // p as A fragments, one per 16 keys
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            float e4[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                e4[e] = exp_e(s[nb][e] - m_run[e >> 1]);
                sum[e >> 1] += e4[e];
            }
            // key block nb is half (nb & 1) of the 16-key A fragment nb / 2
            pf[nb / 2][(nb & 1) * 2 + 0] = MmaOp<T>::pack(e4[0], e4[1]);
            pf[nb / 2][(nb & 1) * 2 + 1] = MmaOp<T>::pack(e4[2], e4[3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
            l_run[r] = alpha[r] * l_run[r] + sum[r];
        }
#pragma unroll
        for (int j = 0; j < DB; ++j) {
            acc[j][0] *= alpha[0];
            acc[j][1] *= alpha[0];
            acc[j][2] *= alpha[1];
            acc[j][3] *= alpha[1];
        }

        // acc += p @ v
#pragma unroll
        for (int kc = 0; kc < NB / 2; ++kc) {
#pragma unroll
            for (int db = 0; db < DB; db += 2) {
                uint32_t b[4];  // B fragments of output blocks db and db + 1
                ldmatrix_x4_trans(b, Vb + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                         db * 8 + (lane >> 4) * 8);
                MmaOp<T>::run(acc[db], pf[kc], b[0], b[1]);
                MmaOp<T>::run(acc[db + 1], pf[kc], b[2], b[3]);
            }
        }
        __syncthreads();  // the next iteration's copy overwrites this buffer
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_a + r * 8;
        if (row >= p.n) continue;
        const float l_safe = fmaxf(l_run[r], 1e-30f);
        T* orow = o + (long long)row * p.so[2];
#pragma unroll
        for (int j = 0; j < DB; ++j) {
            const uint32_t pair = MmaOp<T>::pack(acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
            *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pair;
        }
        if (t == 0)
            p.lse[((long long)bi * p.h + hi) * p.n + row] = m_run[r] + logf(l_safe);
    }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores.

constexpr int F32_THREADS = 256;  // 16 x 16: each thread owns 4 rows x 4 keys
constexpr int LDT = 68;           // row stride of the transposed tiles (floats)

template <int D>
constexpr size_t f32_smem_bytes() {
    // Qt [D][LDT], Kt [D][LDT], Vs [BN][D], Pt [BN][LDT]
    return ((size_t)2 * D * LDT + (size_t)BN * D + (size_t)BN * LDT) * sizeof(float);
}

// Stage a [BM, D] tile of x into shared memory, transposed
// (dst[c * LDT + r]) or row-major (dst[r * D + c]). Rows at or past `limit`
// are zero.
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* x, long long row_stride,
                                              int row0, int limit) {
    for (int idx = threadIdx.x; idx < BM * D; idx += F32_THREADS) {
        const int r = idx / D;
        const int c = idx % D;
        const int row = row0 + r;
        const float val = row < limit ? x[(long long)row * row_stride + c] : 0.f;
        if (TRANSPOSE) {
            dst[c * LDT + r] = val;
        } else {
            dst[r * D + c] = val;
        }
    }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32_kernel(const FwdParams p) {
    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;
    float* Kt = Qt + D * LDT;
    float* Vs = Kt + D * LDT;
    float* Pt = Vs + BN * D;

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<true>(cdiv(p.n, BM), p.h);
    const int q0 = tile.t * BM;
    const int hi = tile.hi;
    const int bi = tile.bi;

    const float* q = static_cast<const float*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const float* k = static_cast<const float*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const float* v = static_cast<const float*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    float* o = static_cast<float*>(p.o) + bi * p.so[0] + hi * p.so[1];

    f32_load_tile<D, true>(Qt, q, p.sq[2], q0, p.n);

    constexpr int OC = D / 16;  // output columns per thread
    float acc[4][OC];
    float m_run[4], l_run[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_run[i] = -INFINITY;
        l_run[i] = 0.f;
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
    }

    const int kt_end = kv_tiles(p, q0);
    for (int kt = 0; kt < kt_end; ++kt) {
        const int kv0 = kt * BN;
        f32_load_tile<D, true>(Kt, k, p.sk[2], kv0, p.m);
        f32_load_tile<D, false>(Vs, v, p.sv[2], kv0, p.m);
        __syncthreads();

        // s = q @ k^T for this thread's rows ty*4+i and keys tx*4+j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&Qt[kk * LDT + ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Kt[kk * LDT + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }

        // online softmax; a row's 64 keys live in the 16 lanes sharing ty
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty * 4 + i;
            float mx = MASKED;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = masked_score(s[i][j], p, row, kv0 + tx * 4 + j);
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_run[i], mx);
            const float alpha = expf(m_run[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                sum += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l_run[i] = alpha * l_run[i] + sum;
            m_run[i] = m_new;
#pragma unroll
            for (int j = 0; j < OC; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        }
        __syncthreads();

        // acc += p @ v; this thread's output columns are jj*64 + tx*4 + j
#pragma unroll 4
        for (int c = 0; c < BN; ++c) {
            const float4 pp = *reinterpret_cast<const float4*>(&Pt[c * LDT + ty * 4]);
            const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int jj = 0; jj < D / 64; ++jj) {
                const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * D + jj * 64 + tx * 4]);
                const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][jj * 4 + j] = fmaf(pv[i], vw[j], acc[i][jj * 4 + j]);
            }
        }
        __syncthreads();  // the next tile overwrites Kt, Vs and Pt
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= p.n) continue;
        const float l_safe = fmaxf(l_run[i], 1e-30f);
        float* orow = o + (long long)row * p.so[2];
#pragma unroll
        for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
            for (int j = 0; j < 4; ++j) orow[jj * 64 + tx * 4 + j] = acc[i][jj * 4 + j] / l_safe;
        if (tx == 0)
            p.lse[((long long)bi * p.h + hi) * p.n + row] = m_run[i] + logf(l_safe);
    }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const FwdParams& p, int b,
                   cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<tile_grid(cdiv(p.n, BM), p.h, b), threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const FwdParams& p, int dtype, int b, cudaStream_t stream) {
    switch (dtype) {
        case 0:
            return launch(flash_fwd_f32_kernel<D>, F32_THREADS, f32_smem_bytes<D>(), p, b, stream);
        case 1:
            return launch(flash_fwd_mma_kernel<__nv_bfloat16, D>, MMA_THREADS, mma_smem_bytes<D>(),
                          p, b, stream);
        case 2:
            return launch(flash_fwd_mma_kernel<__half, D>, MMA_THREADS, mma_smem_bytes<D>(), p, b,
                          stream);
        default:
            return cudaErrorInvalidValue;
    }
}

int run(const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int b, int h,
        int n, int m, int d, const long long* strides, float scale, int causal, void* stream) {
    FwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = static_cast<float*>(lse);
    long long* dst[4] = {p.sq, p.sk, p.sv, p.so};
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
    p.h = h;
    p.n = n;
    p.m = m;
    p.scale = scale;
    p.causal = causal;
    if (b <= 0 || h <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 64) return (int)launch_d<64>(p, dtype, b, s);
    if (d == 128) return (int)launch_d<128>(p, dtype, b, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements;
// the last dimension of q, k, v and o must be contiguous, and for the
// 16-bit types every row must start on a 16-byte boundary.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int dtype, int b, int h, int n, int m, int d,
                         long long sqb, long long sqh, long long sqn,
                         long long skb, long long skh, long long skn,
                         long long svb, long long svh, long long svn,
                         long long sob, long long soh, long long son,
                         float scale, int causal, void* stream) {
    const long long strides[12] = {sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son};
    return run(q, k, v, o, lse, dtype, b, h, n, m, d, strides, scale, causal, stream);
}

// The long-sequence forward (the long route's entry): the same kernels,
// arguments and contract.
extern "C" int flash_fwd_long(const void* q, const void* k, const void* v, void* o, void* lse,
                              int dtype, int b, int h, int n, int m, int d,
                              long long sqb, long long sqh, long long sqn,
                              long long skb, long long skh, long long skn,
                              long long svb, long long svh, long long svn,
                              long long sob, long long soh, long long son,
                              float scale, int causal, void* stream) {
    const long long strides[12] = {sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son};
    return run(q, k, v, o, lse, dtype, b, h, n, m, d, strides, scale, causal, stream);
}

extern "C" const char* flash_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
