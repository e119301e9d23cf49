// Flash-attention forward for Hopper (sm_90a): o and lse = m + log(l).
//
// Replaces the TPU Pallas kernel paddle_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd_impl). It computes the same function, not the same
// blocks: a block walks the K/V tiles of a query tile in a loop, keeping a
// running max, a running sum and the output accumulator in f32 registers,
// so the [n, m] score matrix never reaches device memory.
//
// Numeric contract (the TPU kernel's _mm_f32): products of native-dtype
// operands summed in f32 (a bf16 or fp16 product is exact in f32), the
// scale applied to the f32 scores, softmax in f32, and p cast to v's dtype
// before p @ v. Causal masking is top-left (key j is visible to query i
// when j <= i), which is the n == m contract of the host side; the host
// routes cross-length causal elsewhere before any launch. The 16-bit path
// takes e^(s * scale - m) as one ex2.approx of s * (scale * log2 e) - m',
// with m' the running max in log2 units (exp2_approx in mma_sm90.cuh), the
// scale folded into the same product.
//
// flash_fwd_long() launches the same kernels. It replaces the TPU kernel
// paddle_tpu/ops/flash_attention.py:_fwd_kernel_long (launched by
// _fwd_impl_long for max(n, m) >= 4096). The TPU needs a second kernel
// because its standard one stages the whole K/V of a (b, h) in VMEM, which
// runs out at 8k; the kernels here stage K/V tiles at any length, so that
// reason does not carry over.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16):
// - the training shape (b=32, h=12, n=m=512, d=64, bf16, causal) must read
//   q, k, v and write o (4 x 25.2 MB) and lse: 30 us; its causal work,
//   4*d*b*h*n*(n+1)/2 = 12.9 GFLOP, takes 13 us. The bytes bound it, and
//   a query tile walks only 1 to 4 K/V tiles, so its start (the first
//   copies) and end (the o stores) weigh as much as its products.
// - the long shape (b=2, h=12, n=m=8192) moves 101 MB (30 us) for 206
//   GFLOP (208 us): operations bound it, over a causal triangle 64 tiles of
//   128 rows deep.
//
// Three paths:
// - bf16 / fp16 at d = 64 and 128 (flash_fwd_tma_kernel): warpgroup wgmma on shared memory
//   that TMA fills. A producer warpgroup (one thread issuing the copies,
//   40 registers) and two consumer warpgroups (64 query rows each, 232
//   registers, moved over by setmaxnreg) share a ring of K/V tiles tracked
//   by mbarriers. The products of the next K/V tile are issued before the
//   softmax of this one, so the tensor cores run while the exponentials
//   issue, and the softmax keeps its row maxima and sums in 4 independent
//   chains a row. The block is persistent (one an SM): it walks pairs of
//   query tiles whose causal work adds up to the same (TilePairs), and the
//   producer copies the next tile's q and K/V while the consumers finish
//   this one, so the start and end of a tile overlap other work.
// - f32 at d = 64 and 128 (flash_fwd_tf32_kernel): f32-accurate products as
//   three TF32 tensor-core products each (split TF32, tf32x3.cuh) on
//   TMA-fed shared memory, a producer warp feeding 8 consumer warps; its
//   section below says what bounds it and what the design does about that.
// - every type at d = 192 and 256 (flash_fwd_cc_kernel): f32 FMAs
//   on the CUDA cores, each thread on a 4x4 register tile of scores (4-wide
//   shared-memory reads, 2 loads per 16 FMAs), so an f32 call keeps full
//   f32 products. 16-bit operands are staged as 16-bit and widened at use:
//   at d = 256 the f32 layout takes 222,208 of 232,448 bytes, the 16-bit
//   one 119,808. This path is the simple first kernel for the wide heads;
//   it runs at CUDA-core rates, far below the tensor cores'.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// The C entry point flash_fwd() launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or the
// error of a tensor map that cuTensorMapEncodeTiled refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"
#include "sm90_async.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float MASKED = -1e30f;  // the TPU kernel's _NEG_INF

struct FwdParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;              // [b, h, n] f32, contiguous
    long long sq[3], sk[3], sv[3], so[3];  // strides of (b, h, row), in elements
    int b, h, n, m;
    float scale;
    int causal;
};

// Number of K/V tiles of BN keys that the block of BM query rows starting at
// q0 walks: causal blocks stop at the tile that holds the diagonal of their
// last row.
template <int BM, int BN>
__device__ __forceinline__ int kv_tiles(const FwdParams& p, int q0) {
    const int num_kt = cdiv(p.m, BN);
    if (!p.causal) return num_kt;
    const int last_row = min(q0 + BM, p.n) - 1;
    return min(num_kt, last_row / BN + 1);
}

// Whether the K/V tile of BN keys at kv0 needs the mask for the query rows
// q0..: it holds keys past the end, or (causal) a key above some row's
// diagonal.
template <int BN>
__device__ __forceinline__ bool edge_tile(const FwdParams& p, int q0, int kv0) {
    return kv0 + BN > p.m || (p.causal && kv0 + BN - 1 > q0);
}

__device__ __forceinline__ float masked_score(float s, const FwdParams& p, int row, int col) {
    return (col >= p.m || (p.causal && col > row)) ? MASKED : s * p.scale;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma on TMA-fed shared memory (the helpers in sm90_async.cuh).
//
// A persistent block on each SM walks query tiles of 128 rows (TilePairs):
// two consumer warpgroups of 64 rows (wgmma's M) and one producer warpgroup,
// of which one thread issues the copies. It copies each tile's q into one of
// two buffers and the K/V tiles of fwd_bn<D>() keys into a ring of
// FWD_STAGES buffers, running ahead into the next query tile while the
// consumers finish this one. Each consumer computes s = q k^T as SS wgmma,
// the online softmax on the f32 accumulator in registers, and o += p v as RS
// wgmma (p packed to T from the s accumulator, v as MN-major B). The
// products of the next K/V tile are issued before the softmax of this one,
// so the tensor cores work while the exponentials issue.

constexpr int TMA_BM = 128;  // query rows per tile: 2 consumer warpgroups x 64
constexpr int TMA_CONSUMERS = 2;
constexpr int TMA_THREADS = (TMA_CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr float LN2 = 0.6931471805599453f;

// keys per K/V tile: at d = 128 the 64-key tile measured faster (the s, o
// and p of a 128-key tile take 160 registers a thread)
template <int D> __host__ __device__ constexpr int fwd_bn() { return D == 64 ? 128 : 64; }
constexpr int FWD_STAGES = 3;  // K/V tiles in flight

template <int D>
constexpr size_t tma_smem_bytes() {
    // two q buffers, then K and V of every stage, the barriers and the
    // 1024-byte alignment slack
    return (size_t)(2 * TMA_BM + 2 * FWD_STAGES * fwd_bn<D>()) * D * 2 +
           (2 * FWD_STAGES + 4) * 8 + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const FwdParams p) {
    constexpr int BN = fwd_bn<D>();
    constexpr int ST = FWD_STAGES;
    constexpr int NS = BN / 2;   // score accumulators a thread
    constexpr int NO = D / 2;    // output accumulators a thread
    constexpr int KC = BN / 16;  // k16 slices of p @ v
    constexpr uint32_t Q_BOX = TMA_BM * 128;  // bytes of a 64-column q box
    constexpr uint32_t KV_BOX = BN * 128;     // bytes of a 64-column K or V box
    extern __shared__ unsigned char smem_raw[];
    T* Qs = reinterpret_cast<T*>(align_1024(smem_raw));  // 2 buffers
    T* Ks = Qs + 2 * TMA_BM * D;                         // ST stages
    T* Vs = Ks + ST * BN * D;                            // ST stages
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BN * D);  // 2
    uint64_t* q_empty = q_full + 2;                                     // 2
    uint64_t* full = q_empty + 2;                                       // ST
    uint64_t* empty = full + ST;                                        // ST

    const TilePairs work(cdiv(p.n, TMA_BM), p.h * p.b);
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(q_full + i, 1);
            mbar_init(q_empty + i, TMA_CONSUMERS);
        }
        for (int s = 0; s < ST; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, TMA_CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= TMA_CONSUMERS * 128) {
        // the producer warpgroup; one thread issues every copy
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x != TMA_CONSUMERS * 128) return;
        Ring<ST> ring;
        int local = 0;  // tiles this block has walked
        for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
            for (int s = 0; s < work.count(u); ++s, ++local) {
                const Tile tile = work.tile<true>(u, s, p.h);
                const int q0 = tile.t * TMA_BM;
                const int qb = local & 1;
                mbar_wait(q_empty + qb, ((local >> 1) & 1) ^ 1);
                mbar_arrive_expect_tx(q_full + qb, TMA_BM * D * 2);
                tma_load_rows<D, TMA_BM>(Qs + qb * TMA_BM * D, &tm_q, q_full + qb, q0, tile.hi,
                                         tile.bi);
                const int kt_end = kv_tiles<TMA_BM, BN>(p, q0);
                for (int kt = 0; kt < kt_end; ++kt, ring.advance()) {
                    mbar_wait(empty + ring.stage, ring.phase ^ 1);
                    mbar_arrive_expect_tx(full + ring.stage, 2 * BN * D * 2);
                    tma_load_rows<D, BN>(Ks + ring.stage * BN * D, &tm_k, full + ring.stage,
                                         kt * BN, tile.hi, tile.bi);
                    tma_load_rows<D, BN>(Vs + ring.stage * BN * D, &tm_v, full + ring.stage,
                                         kt * BN, tile.hi, tile.bi);
                }
            }
        }
        return;
    }

    regs_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    const int w = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float sl2 = p.scale * LOG2E;  // scores to log2 units
    const uint32_t k_tiles = smem_addr(Ks);
    const uint32_t v_tiles = smem_addr(Vs);
    float o[NO];
    float s[NS];
    uint32_t pf[KC][4];
    float m_run[2], l_run[2];  // running max (log2 units); this thread's share of the row sums
    Ring<ST> ring;
    int local = 0;
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
        for (int si = 0; si < work.count(u); ++si, ++local) {
            const Tile tile = work.tile<true>(u, si, p.h);
            const int q0 = tile.t * TMA_BM;
            const int kt_end = kv_tiles<TMA_BM, BN>(p, q0);
            const int qb = local & 1;
            const int q0w = q0 + wg * 64;        // the warpgroup's first row
            const int row_a = q0w + 16 * w + g;  // this thread's rows: row_a, row_a + 8
            const uint32_t q_tile = smem_addr(Qs + qb * TMA_BM * D) + wg * 64 * 128;

            // s = q k^T of the K/V tile in `stage`, issued as one group
            auto issue_qk = [&](int stage) {
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<T, BN>(s, kmajor_desc(q_tile, Q_BOX, kk),
                                    kmajor_desc(k_tiles + stage * KV_BOX * (D / 64), KV_BOX, kk),
                                    kk > 0);
                wgmma_commit();
            };
            // o += p v of the K/V tile in `stage`, issued as one group
            auto issue_pv = [&](int stage) {
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < KC; ++kc)
                    wgmma_rs<T, D>(o, pf[kc],
                                   mnmajor_desc(v_tiles + stage * KV_BOX * (D / 64), KV_BOX, kc),
                                   1);
                wgmma_commit();
            };
            // s of K/V tile kt -> p = exp(s * scale - m_new) in place (f32),
            // the row maxima and this thread's row sums moved on; returns
            // alpha, the factor that brings the old sums to the new maxima.
            // The maxima and sums run in 4 independent chains a row: one
            // chain of 32 dependent instructions held each warp for longer
            // than the products took.
            auto softmax = [&](int kt, float (&alpha)[2]) {
                const int kv0 = kt * BN;
                if (edge_tile<BN>(p, q0w, kv0)) {
#pragma unroll
                    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int col = kv0 + 8 * j + 2 * t + (e & 1);
                            const int row = row_a + (e >> 1) * 8;
                            if (col >= p.m || (p.causal && col > row)) s[4 * j + e] = MASKED;
                        }
                }
                float mx[2][4];
#pragma unroll
                for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = MASKED;
#pragma unroll
                for (int j = 0; j < NS / 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        mx[e >> 1][(j & 1) * 2 + (e & 1)] =
                            fmaxf(mx[e >> 1][(j & 1) * 2 + (e & 1)], s[4 * j + e]);
                float m_new[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                    m_new[r] = fmaxf(m_run[r], m * sl2);
                    alpha[r] = exp2_approx(m_run[r] - m_new[r]);
                    m_run[r] = m_new[r];
                }
                float sum[2][4];
#pragma unroll
                for (int i = 0; i < 8; ++i) sum[i / 4][i % 4] = 0.f;
#pragma unroll
                for (int j = 0; j < NS / 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float pe = exp2_approx(fmaf(s[4 * j + e], sl2, -m_new[e >> 1]));
                        s[4 * j + e] = pe;
                        sum[e >> 1][(j & 1) * 2 + (e & 1)] += pe;
                    }
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    l_run[r] = l_run[r] * alpha[r] +
                               ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
            };
            // p (f32, in s) -> the A operands of p v, rounded to T
            auto pack_p = [&]() {
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) {
                    pf[kc][0] = MmaOp<T>::pack(s[8 * kc + 0], s[8 * kc + 1]);
                    pf[kc][1] = MmaOp<T>::pack(s[8 * kc + 2], s[8 * kc + 3]);
                    pf[kc][2] = MmaOp<T>::pack(s[8 * kc + 4], s[8 * kc + 5]);
                    pf[kc][3] = MmaOp<T>::pack(s[8 * kc + 6], s[8 * kc + 7]);
                }
            };

#pragma unroll
            for (int i = 0; i < NO; ++i) o[i] = 0.f;
            for (int r = 0; r < 2; ++r) {
                m_run[r] = -INFINITY;
                l_run[r] = 0.f;
            }
            float alpha[2];
            mbar_wait(q_full + qb, (local >> 1) & 1);
            mbar_wait(full + ring.stage, ring.phase);
            issue_qk(ring.stage);
            wgmma_wait<0>();
            reg_fence(s);
            softmax(0, alpha);
            pack_p();
            for (int kt = 1; kt < kt_end; ++kt) {
                const int prev = ring.stage;
                ring.advance();
                mbar_wait(full + ring.stage, ring.phase);
                issue_qk(ring.stage);  // s of tile kt ...
                issue_pv(prev);        // ... while p v of tile kt - 1 runs
                wgmma_wait<1>();
                reg_fence(s);
                softmax(kt, alpha);
                wgmma_wait<0>();
                reg_fence(o);
                reg_fence(pf);
                if (threadIdx.x % 128 == 0) mbar_arrive(empty + prev);
#pragma unroll
                for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
                pack_p();
            }
            // every q k^T of this tile is done: its q buffer may be refilled
            if (threadIdx.x % 128 == 0) mbar_arrive(q_empty + qb);
            issue_pv(ring.stage);
            wgmma_wait<0>();
            reg_fence(o);
            reg_fence(pf);
            if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
            ring.advance();

            // rows row_a (r = 0) and row_a + 8 (r = 1); a row's sums live in
            // the 4 lanes of a quad
            T* out = static_cast<T*>(p.o) + tile.bi * p.so[0] + tile.hi * p.so[1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float l = l_run[r];
                l += __shfl_xor_sync(0xffffffffu, l, 1);
                l += __shfl_xor_sync(0xffffffffu, l, 2);
                const int row = row_a + r * 8;
                if (row >= p.n) continue;
                const float l_safe = fmaxf(l, 1e-30f);
                const float inv = 1.f / l_safe;
                T* orow = out + (long long)row * p.so[2];
#pragma unroll
                for (int j = 0; j < NO / 4; ++j)
                    *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
                        MmaOp<T>::pack(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
                if (t == 0)
                    p.lse[((long long)tile.bi * p.h + tile.hi) * p.n + row] =
                        m_run[r] * LN2 + logf(l_safe);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// f32 at d = 64 and 128 (flash_fwd_tf32_kernel): split-TF32 products on the
// tensor cores (tf32x3.cuh) on TMA-fed shared memory.
//
// Replaces the TPU kernels _fwd_kernel (paddle_tpu/ops/flash_attention.py:137,
// launched by _fwd_impl) and _fwd_kernel_long (:343, by _fwd_impl_long) for
// f32 operands. f32 is the default parameter type and auto_cast O1 runs
// attention in f32, so every f32 training step and prefill runs this kernel.
//
// What bounds it on the card: at the training shape (b=32, h=12, n=m=512,
// d=64, causal) the kernel must move 4 x 50.3 MB (30 us at 3.35 TB/s) and
// do 12.9 GFLOP of f32-accurate products; the CUDA cores' 67 TFLOP/s take
// 193 us for them, and three TF32 products on the tensor cores (495 TFLOP/s
// dense) 78 us. So operations bound it, and the design spends them on the
// tensor cores: each product is three mma.sync.m16n8k8 .tf32 on operands
// split in registers as they are loaded (no lo copy in shared memory, no
// conversion pass), and a producer warp keeps the K/V ring full by TMA, so
// the consumers never wait on a synchronous load. For p v, V is MN-major,
// which wgmma takes for .tf32 only K-major; mma.sync reads its B fragments
// from the row-major V tile with 32-bit loads instead, and p goes from the
// s accumulator to the A fragment in registers (frag_from_acc).
//
// A persistent block (one an SM) walks query tiles of 128 rows (TilePairs):
// 8 consumer warps of 16 rows and one producer warp, of which one lane
// issues the copies: q into one of f32t_qbufs<D>() buffers, K and V tiles
// of 64 keys into a ring of f32t_stages<D>() stages. Each consumer warp
// computes s = q k^T, the online softmax with expf in f32 (the CUDA-core
// kernel's arithmetic) and o += p v, and skips the K/V tiles past its last
// row's diagonal. 288 threads leave ptxas 168 registers a thread (9 warps
// put 3 on one of the SM's four quarters of 16K registers); with s, o and
// the loads' offsets (tf32x3.cuh) d = 64 fits in them.

constexpr int F32T_WARPS = 8;                        // consumer warps, 16 query rows each
constexpr int F32T_BM = 16 * F32T_WARPS;             // query rows a tile
constexpr int F32T_THREADS = (F32T_WARPS + 1) * 32;  // + the producer warp
constexpr int F32T_BN = 64;                          // keys a K/V tile
template <int D> __host__ __device__ constexpr int f32t_stages() { return D == 64 ? 3 : 2; }
template <int D> __host__ __device__ constexpr int f32t_qbufs() { return D == 64 ? 2 : 1; }

template <int D>
constexpr size_t f32t_smem_bytes() {
    // q buffers, then K and V of every stage, the barriers and the
    // 1024-byte alignment slack
    return (size_t)(f32t_qbufs<D>() * F32T_BM + 2 * f32t_stages<D>() * F32T_BN) * D * 4 +
           (2 * f32t_qbufs<D>() + 2 * f32t_stages<D>()) * 8 + 1024;
}

template <int D>
__global__ void __launch_bounds__(F32T_THREADS, 1)
    flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const FwdParams p) {
    constexpr int BM = F32T_BM;
    constexpr int BN = F32T_BN;
    constexpr int ST = f32t_stages<D>();
    constexpr int QB = f32t_qbufs<D>();
    constexpr int NJ = BN / 8;  // n8 tiles of s (keys)
    constexpr int NO = D / 8;   // n8 tiles of o
    extern __shared__ unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(align_1024(smem_raw));  // QB buffers
    float* Ks = Qs + QB * BM * D;                                // ST stages
    float* Vs = Ks + ST * BN * D;                                // ST stages
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * BN * D);  // QB
    uint64_t* q_empty = q_full + QB;                                    // QB
    uint64_t* full = q_empty + QB;                                      // ST
    uint64_t* empty = full + ST;                                        // ST

    const TilePairs work(cdiv(p.n, BM), p.h * p.b);
    if (threadIdx.x == 0) {
        for (int i = 0; i < QB; ++i) {
            mbar_init(q_full + i, 1);
            mbar_init(q_empty + i, F32T_WARPS);
        }
        for (int s = 0; s < ST; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, F32T_WARPS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == F32T_WARPS) {
        // the producer warp; one lane issues every copy
        if (lane != 0) return;
        Ring<ST> ring;
        int local = 0;  // tiles this block has walked
        for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
            for (int s = 0; s < work.count(u); ++s, ++local) {
                const Tile tile = work.tile<true>(u, s, p.h);
                const int q0 = tile.t * BM;
                const int qb = local % QB;
                mbar_wait(q_empty + qb, ((local / QB) & 1) ^ 1);
                mbar_arrive_expect_tx(q_full + qb, BM * D * 4);
                tma_load_rows<D, BM>(Qs + qb * BM * D, &tm_q, q_full + qb, q0, tile.hi, tile.bi);
                const int kt_end = kv_tiles<BM, BN>(p, q0);
                for (int kt = 0; kt < kt_end; ++kt, ring.advance()) {
                    mbar_wait(empty + ring.stage, ring.phase ^ 1);
                    mbar_arrive_expect_tx(full + ring.stage, 2 * BN * D * 4);
                    tma_load_rows<D, BN>(Ks + ring.stage * BN * D, &tm_k, full + ring.stage,
                                         kt * BN, tile.hi, tile.bi);
                    tma_load_rows<D, BN>(Vs + ring.stage * BN * D, &tm_v, full + ring.stage,
                                         kt * BN, tile.hi, tile.bi);
                }
            }
        }
        return;
    }

    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t k_tiles = smem_addr(Ks);
    const uint32_t v_tiles = smem_addr(Vs);
    constexpr uint32_t KV_STAGE = BN * D * 4;  // bytes of one K or V stage
    const KmajorLoader<BM, true> q_ld(16 * warp);  // q as A: the warp's 16 rows
    const KmajorLoader<BN, false> k_ld(0);         // K as B
    const MnmajorLoader<BN> v_ld;                  // V as B
    float o[NO][4];
    float s[NJ][4];
    float m_run[2], l_run[2];  // running max (scaled scores); this thread's share of the row sums
    Ring<ST> ring;
    int local = 0;
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
        for (int si = 0; si < work.count(u); ++si, ++local) {
            const Tile tile = work.tile<true>(u, si, p.h);
            const int q0 = tile.t * BM;
            const int kt_end = kv_tiles<BM, BN>(p, q0);
            const int qb = local % QB;
            const int q0w = q0 + 16 * warp;  // the warp's first row
            const int row_a = q0w + g;       // this thread's rows: row_a, row_a + 8
            // K/V tiles with a key that some row of the warp sees; the rest
            // (causal) only pass through the ring
            const int kt_w = p.causal ? min(kt_end, (q0w + 15) / BN + 1) : kt_end;
            const uint32_t q_tile = smem_addr(Qs + qb * BM * D);
#pragma unroll
            for (int j = 0; j < NO; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
            for (int r = 0; r < 2; ++r) {
                m_run[r] = -INFINITY;
                l_run[r] = 0.f;
            }
            mbar_wait(q_full + qb, (local / QB) & 1);
            for (int kt = 0; kt < kt_end; ++kt, ring.advance()) {
                mbar_wait(full + ring.stage, ring.phase);
                if (kt < kt_w) {
                    const uint32_t k_tile = k_tiles + ring.stage * KV_STAGE;
                    const uint32_t v_tile = v_tiles + ring.stage * KV_STAGE;
                    const int kv0 = kt * BN;
                    // s = q k^T: q as A (K-major), K as B (its rows K-major)
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
                    for (int kk = 0; kk < D / 8; ++kk) {
                        const FragA a = ld_a(q_ld, q_tile, kk);
#pragma unroll
                        for (int j = 0; j < NJ; j += 2) {
                            FragB b0, b1;
                            ld_b_pair(b0, b1, k_ld, k_tile, j, kk);
                            mma3(s[j], a, b0);
                            mma3(s[j + 1], a, b1);
                        }
                    }
                    // online softmax: scaled scores, masked ones MASKED; a
                    // row's keys live in the 4 lanes of a quad
                    const bool edge = edge_tile<BN>(p, q0w, kv0);
                    float mx[2] = {MASKED, MASKED};
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int row = row_a + (e >> 1) * 8;
                            const int col = kv0 + 8 * j + 2 * t + (e & 1);
                            s[j][e] = edge ? masked_score(s[j][e], p, row, col) : s[j][e] * p.scale;
                            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
                        }
                    float alpha[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        float m = mx[r];
                        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
                        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
                        const float m_new = fmaxf(m_run[r], m);
                        alpha[r] = expf(m_run[r] - m_new);
                        m_run[r] = m_new;
                    }
                    float sum[2] = {0.f, 0.f};
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            s[j][e] = expf(s[j][e] - m_run[e >> 1]);
                            sum[e >> 1] += s[j][e];
                        }
#pragma unroll
                    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
                    for (int j = 0; j < NO; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
                    // o += p v: p from the s accumulator, V as an MN-major B
#pragma unroll
                    for (int c = 0; c < NJ; ++c) {
                        const FragA a = frag_from_acc(s[c]);
#pragma unroll
                        for (int j = 0; j < NO; ++j)
                            mma3(o[j], a, v_ld.load(v_tile, c, j));
                    }
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + ring.stage);
            }
            // every q k^T of this tile is done: its q buffer may be refilled
            __syncwarp();
            if (lane == 0) mbar_arrive(q_empty + qb);

            // rows row_a (r = 0) and row_a + 8 (r = 1); a row's sums live in
            // the 4 lanes of a quad
            float* out = static_cast<float*>(p.o) + tile.bi * p.so[0] + tile.hi * p.so[1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float l = l_run[r];
                l += __shfl_xor_sync(0xffffffffu, l, 1);
                l += __shfl_xor_sync(0xffffffffu, l, 2);
                const int row = row_a + r * 8;
                if (row >= p.n) continue;
                const float l_safe = fmaxf(l, 1e-30f);
                float* orow = out + (long long)row * p.so[2];
#pragma unroll
                for (int j = 0; j < NO; ++j)
                    *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
                        make_float2(o[j][2 * r] / l_safe, o[j][2 * r + 1] / l_safe);
                if (t == 0)
                    p.lse[((long long)tile.bi * p.h + tile.hi) * p.n + row] =
                        m_run[r] + logf(l_safe);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The CUDA-core kernel: f32 and bf16 / fp16 at d = 192 and 256, where the
// tensor-core kernels' rings would not fit in shared memory (they are
// instantiated at d = 64 and 128). Operands are staged in
// shared memory as T (16-bit ones in half the bytes of f32) and widened to
// f32 at use, so the products are the exact products of the native operands
// and the sums f32, the contract of the wgmma kernel; p is rounded to T
// before p @ v, as that kernel packs it.

constexpr int F32_BM = 64;  // query rows per block
constexpr int F32_BN = 64;  // keys per K/V tile
constexpr int F32_THREADS = 256;  // 16 x 16: each thread owns 4 rows x 4 keys
constexpr int LDT = 68;           // row stride of the transposed tiles (elements)

template <typename T, int D>
constexpr size_t cc_smem_bytes() {
    // Qt [D][LDT], Kt [D][LDT] and Vs [F32_BN][D] of T; Pt [F32_BN][LDT] f32
    return ((size_t)2 * D * LDT + (size_t)F32_BN * D) * sizeof(T) +
           (size_t)F32_BN * LDT * sizeof(float);
}

// Stage a [F32_BM, D] tile of x into shared memory, transposed
// (dst[c * LDT + r]) or row-major (dst[r * D + c]). Rows at or past `limit`
// are zero.
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void cc_load_tile(T* dst, const T* x, long long row_stride, int row0,
                                             int limit) {
    for (int idx = threadIdx.x; idx < F32_BM * D; idx += F32_THREADS) {
        const int r = idx / D;
        const int c = idx % D;
        const int row = row0 + r;
        const T val = row < limit ? x[(long long)row * row_stride + c] : Cvt<T>::from(0.f);
        if (TRANSPOSE) {
            dst[c * LDT + r] = val;
        } else {
            dst[r * D + c] = val;
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_cc_kernel(const FwdParams p) {
    extern __shared__ __align__(16) unsigned char cc_smem[];
    T* Qt = reinterpret_cast<T*>(cc_smem);
    T* Kt = Qt + D * LDT;
    T* Vs = Kt + D * LDT;
    float* Pt = reinterpret_cast<float*>(Vs + F32_BN * D);

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<true>(cdiv(p.n, F32_BM), p.h);
    const int q0 = tile.t * F32_BM;
    const int hi = tile.hi;
    const int bi = tile.bi;

    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    T* o = static_cast<T*>(p.o) + bi * p.so[0] + hi * p.so[1];

    cc_load_tile<T, D, true>(Qt, q, p.sq[2], q0, p.n);

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

    const int kt_end = kv_tiles<F32_BM, F32_BN>(p, q0);
    for (int kt = 0; kt < kt_end; ++kt) {
        const int kv0 = kt * F32_BN;
        cc_load_tile<T, D, true>(Kt, k, p.sk[2], kv0, p.m);
        cc_load_tile<T, D, false>(Vs, v, p.sv[2], kv0, p.m);
        __syncthreads();

        // s = q @ k^T for this thread's rows ty*4+i and keys tx*4+j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk) {
            const float4 a = load4(&Qt[kk * LDT + ty * 4]);
            const float4 b = load4(&Kt[kk * LDT + tx * 4]);
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
        // p rounded to v's type for p @ v; l keeps the unrounded sum
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LDT + ty * 4]) =
                make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]), round_to<T>(s[2][j]),
                            round_to<T>(s[3][j]));
        }
        __syncthreads();

        // acc += p @ v; this thread's output columns are jj*64 + tx*4 + j
#pragma unroll 4
        for (int c = 0; c < F32_BN; ++c) {
            const float4 pp = *reinterpret_cast<const float4*>(&Pt[c * LDT + ty * 4]);
            const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int jj = 0; jj < D / 64; ++jj) {
                const float4 vv = load4(&Vs[c * D + jj * 64 + tx * 4]);
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
        T* orow = o + (long long)row * p.so[2];
#pragma unroll
        for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                orow[jj * 64 + tx * 4 + j] = Cvt<T>::from(acc[i][jj * 4 + j] / l_safe);
        if (tx == 0)
            p.lse[((long long)bi * p.h + hi) * p.n + row] = m_run[i] + logf(l_safe);
    }
}

// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_cc(const FwdParams& p, int b, cudaStream_t stream) {
    constexpr size_t smem = cc_smem_bytes<T, D>();
    static_assert(smem <= MAX_SMEM, "the CUDA-core forward's shared memory exceeds 227 KB");
    const auto kernel = flash_fwd_cc_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<tile_grid(cdiv(p.n, F32_BM), p.h, b), F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tma(const FwdParams& p, int b, cudaStream_t stream) {
    CUtensorMap maps[3];
    const void* bases[3] = {p.q, p.k, p.v};
    const long long* strides[3] = {p.sq, p.sk, p.sv};
    const int rows[3] = {p.n, p.m, p.m};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = encode_rows_map<T>(&maps[i], bases[i], D, rows[i], p.h, b,
                                                   strides[i], i == 0 ? TMA_BM : fwd_bn<D>());
        if (err != cudaSuccess) return err;
    }
    const auto kernel = flash_fwd_tma_kernel<T, D>;
    const size_t smem = tma_smem_bytes<D>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = persistent_grid((cdiv(p.n, TMA_BM) + 1) / 2 * p.h * b);
    kernel<<<grid, TMA_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const FwdParams& p, int b, cudaStream_t stream) {
    CUtensorMap maps[3];
    const void* bases[3] = {p.q, p.k, p.v};
    const long long* strides[3] = {p.sq, p.sk, p.sv};
    const int rows[3] = {p.n, p.m, p.m};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = encode_rows_map<float>(&maps[i], bases[i], D, rows[i], p.h, b,
                                                       strides[i], i == 0 ? F32T_BM : F32T_BN);
        if (err != cudaSuccess) return err;
    }
    const auto kernel = flash_fwd_tf32_kernel<D>;
    constexpr size_t smem = f32t_smem_bytes<D>();
    static_assert(smem <= MAX_SMEM, "the f32 forward's shared memory exceeds 227 KB");
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = persistent_grid((cdiv(p.n, F32T_BM) + 1) / 2 * p.h * b);
    kernel<<<grid, F32T_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], p);
    return cudaGetLastError();
}

// d = 64 and 128: the wgmma kernel for bf16 / fp16, the split-TF32 kernel
// for f32; d = 192 and 256: the CUDA-core kernel for every type.
template <int D>
cudaError_t launch_d(const FwdParams& p, int dtype, int b, cudaStream_t stream) {
    constexpr bool WGMMA = D <= 128;
    switch (dtype) {
        case 0:
            if constexpr (WGMMA) return launch_tf32<D>(p, b, stream);
            else return launch_cc<float, D>(p, b, stream);
        case 1:
            if constexpr (WGMMA) return launch_tma<__nv_bfloat16, D>(p, b, stream);
            else return launch_cc<__nv_bfloat16, D>(p, b, stream);
        case 2:
            if constexpr (WGMMA) return launch_tma<__half, D>(p, b, stream);
            else return launch_cc<__half, D>(p, b, stream);
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
    p.b = b;
    p.h = h;
    p.n = n;
    p.m = m;
    p.scale = scale;
    p.causal = causal;
    if (b <= 0 || h <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 64) return (int)launch_d<64>(p, dtype, b, s);
    if (d == 128) return (int)launch_d<128>(p, dtype, b, s);
    if (d == 192) return (int)launch_d<192>(p, dtype, b, s);
    if (d == 256) return (int)launch_d<256>(p, dtype, b, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Strides are in elements;
// the last dimension of q, k, v and o must be contiguous, and for the
// tensor-core paths (16-bit, and f32 at d = 64 / 128) every row must start
// on a 16-byte boundary.
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
