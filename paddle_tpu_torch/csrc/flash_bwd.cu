// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// o = softmax(q k^T * scale) v, given o's lse and delta = rowsum(do * o).
//
// Replaces the three TPU Pallas kernels of the standard path in
// paddle_tpu/ops/flash_attention.py:
// - flash_bwd_fused (_bwd_fused_kernel): dq, dk and dv from one computation
//   of s, p and dp for each (query tile, key tile) pair.
// - flash_bwd_dq (_bwd_dq_kernel): each query tile walks the key tiles up to
//   the diagonal, dq in f32 registers.
// - flash_bwd_dkv (_bwd_dkv_kernel): one block per (batch, head, tile of 128
//   keys) walks the query tiles from the first that sees it, dk and dv in
//   f32 registers.
// They compute the TPU kernels' function, not their blocks: a TPU core holds
// a whole 512 x 512 score tile in VMEM, a Hopper block has 227 KB of shared
// memory, so every kernel here walks tiles of 32 to 128 rows.
//
// Numeric contract (the TPU kernels'): products of native-dtype operands
// summed in f32, top-left causal masking, p = exp(min(s * scale - lse, 30))
// (0 where masked), ds = p * (dp - delta) * scale, and p and ds rounded to
// the operand dtype before the products they feed. The 16-bit kernels take
// the exponential as one ex2.approx of min(s * scale * log2 e - lse * log2 e,
// 30 log2 e), the scale folded in (exp2_approx in mma_sm90.cuh); the f32
// kernels take expf.
//
// The fused backward is two kernels on one stream. Blocks run in parallel
// and cannot carry dq's sum over key tiles from one to the next, so the
// first (the dk/dv kernel, one block per key tile) also stores each pair's
// ds^T, rounded to the operand dtype as the product takes it, in a
// [b, h, m, n rounded up to 64] workspace; the second sums dq = ds k per
// query tile in registers, reading ds instead of recomputing s, p and dp.
// dq is deterministic, as the TPU kernel's is: no atomics, a fixed order.
//
// flash_bwd_dq_long and flash_bwd_dkv_long launch the same dq and dk/dv
// kernels. They replace the TPU kernels of _bwd_impl_long, which the JAX
// package runs for max(n, m) >= 4096: _bwd_dq_kernel_long and
// _bwd_dkv_kernel_long. The TPU needs them because its standard kernels
// stage whole sequences in VMEM; these kernels stage tiles at any length, so
// that reason does not carry over.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16):
// - the training shape (b=32, h=12, n=m=512, d=64, bf16, causal): the fused
//   backward must read q, k, v, do (4 x 25.2 MB) and lse, delta, and write
//   dq, dk, dv (3 x 25.2 MB): 177.8 MB, 53 us; its 5 products of 2 * d
//   flops for each of the 131,328 visible pairs per (b, h), 32.3 GFLOP, take
//   33 us. The bytes bound it, by a small margin; the ds round trip adds
//   2 x 113 MB.
// - the long shape (b=2, h=12, n=m=8192): the dk/dv pass moves 6 x 25.2 MB
//   (46 us) for 4 products on 33.6M visible pairs per (b, h), 412 GFLOP
//   (417 us); the dq pass 3 products (313 us). Operations bound both.
//
// Two paths:
// - bf16 / fp16 at d = 64 and 128: warpgroup wgmma on shared memory that
//   TMA fills, a producer warpgroup (40 registers) feeding two consumer
//   warpgroups (232 registers, moved over by setmaxnreg) through rings
//   tracked by mbarriers.
//   The dk/dv kernel (flash_bwd_kv_tma_kernel, with STORE_DS the fused
//   pass's first kernel) copies the K and V of its key tile once and
//   streams q, do, lse and delta; its consumers (64 keys each) compute
//   s^T = k q^T and dp^T = v do^T with K and V resident as A, p^T and ds^T
//   in registers, and dv += p^T do, dk += ds^T q with those registers as A.
//   The dq kernel (flash_bwd_dq_tma_kernel, with FROM_DS the fused pass's
//   second kernel) copies the q and do of its query tile once and streams
//   K and V; its consumers (64 query rows each) compute s = q k^T and
//   dp = do v^T, ds in registers, and dq += ds k with ds as A and the same
//   K tile as B. Only the tiles that cross the diagonal or an end test
//   each pair: the test cost more instructions than the rest of the
//   elementwise step.
// - f32, and every type at d = 192 and 256: FMAs on the CUDA cores, 256
//   threads, each on a 4 x 2 to 4 x 16 register tile, operands staged in
//   shared memory as their own type (flash_bwd_kv_cc_kernel,
//   flash_bwd_dq_cc_kernel). This is the simple first kernel for the wide
//   heads; it runs at CUDA-core rates, far below the tensor cores'.
// The wgmma kernels are persistent (one block an SM): each walks pairs of
// tiles whose causal work adds up to the same (TilePairs), and the next
// tile's resident operands (K and V, or q and do) arrive in a second buffer
// while this one finishes. The CUDA-core kernels' grid is one-dimensional, the
// tiles of one (b, h) adjacent and the heaviest first (the last query tile
// for dq, the first key tile for dk/dv).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Each C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError(), or the error of a
// tensor map that cuTensorMapEncodeTiled refused.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"
#include "sm90_async.cuh"

namespace {

constexpr int BK = 64;  // keys per K/V tile

struct BwdParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // [b, h, n] f32, dense
    const float* delta;  // [b, h, n] f32, dense
    void* dq;
    void* dk;
    void* dv;
    void* ds;  // the fused path's ds^T: [b, h, m, ds_ld(n)], operand dtype, dense
    // strides of (b, h, row), in elements
    long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
    int b, h, n, m;
    float scale;
    int causal;
};

// row length of the ds^T workspace: whole 64-query tiles
__host__ __device__ constexpr int ds_ld(int n) { return cdiv(n, 64) * 64; }

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int key) {
    return row < p.n && key < p.m && !(p.causal && key > row);
}


// The first query tile of bq rows that sees the keys from k0 on (top-left
// causal: rows at or below the first key).
__device__ __forceinline__ int first_q_tile(const BwdParams& p, int k0, int bq) {
    return p.causal ? k0 / bq : 0;
}

// Whether a (query rows q0.., keys k0..) tile pair needs the mask: it holds
// rows or keys past the end, or (causal) a key above some row's diagonal.
__device__ __forceinline__ bool edge_pair(const BwdParams& p, int q0, int bq, int k0, int bk) {
    return q0 + bq > p.n || k0 + bk > p.m || (p.causal && k0 + bk - 1 > q0);
}

// The number of key tiles of kt keys a query tile [q0, q0 + bq) walks.
__device__ __forceinline__ int last_k_tile(const BwdParams& p, int q0, int bq, int kt) {
    const int num_kt = cdiv(p.m, kt);
    if (!p.causal) return num_kt;
    return min(num_kt, (min(q0 + bq, p.n) - 1) / kt + 1);
}

// the ds^T rows of (batch bi, head hi)
template <typename T>
__device__ __forceinline__ T* ds_rows(const BwdParams& p, int bi, int hi) {
    return static_cast<T*>(p.ds) + ((long long)bi * p.h + hi) * p.m * ds_ld(p.n);
}

// ---------------------------------------------------------------------------
// The dk/dv kernel, bf16 / fp16: wgmma on TMA-fed shared memory (helpers in
// sm90_async.cuh).
//
// A block walks key tiles of 128: two consumer warpgroups of 64 keys
// (wgmma's M) and one producer warpgroup, of which one warp works. It copies
// each tile's K and V once, then streams the query tiles of kv_tma_bq<D>()
// rows (q and do by TMA, lse and delta by plain loads) into a ring of
// KV_STAGES buffers. Each consumer
// computes s^T = k q^T and dp^T = v do^T as SS wgmma (its K and V rows as
// A, q and do as K-major B), p^T and ds^T in registers, and dv += p^T do and
// dk += ds^T q as RS wgmma (the packed p^T and ds^T as A, do and q as
// MN-major B). BQ is 64 at d = 64 and 32 at d = 128, where the dk and dv
// accumulators take 2 x 64 registers a thread.

constexpr int KV_ROWS = 128;  // keys per tile: 2 consumer warpgroups x 64
constexpr int KV_CONSUMERS = 2;
constexpr int KV_THREADS = (KV_CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int KV_STAGES = 3;
template <int D> __host__ __device__ constexpr int kv_tma_bq() { return D == 64 ? 64 : 32; }

template <int D>
constexpr size_t kv_tma_smem_bytes() {
    // two buffers each of K and V, then q and do of every stage, lse and
    // delta of every stage, the barriers and the 1024-byte alignment slack
    constexpr int BQ = kv_tma_bq<D>();
    return (size_t)(4 * KV_ROWS + 2 * KV_STAGES * BQ) * D * 2 +
           (size_t)2 * KV_STAGES * BQ * sizeof(float) + (2 * KV_STAGES + 4) * 8 + 1024;
}

// p^T and ds^T of one warpgroup's 64 keys x NS / 2 queries from the s^T and
// dp^T accumulators (the contract's arithmetic, the scale folded into the
// one ex2.approx in log2 units), packed to T as the A operands of
// dv += p^T do and dk += ds^T q. lse_b holds lse * log2(e) of the tile's
// queries, delta_b their delta. MASK tests each pair for visibility.
template <typename T, bool MASK, int NS>
__device__ __forceinline__ void p_ds_tile(const BwdParams& p, const float (&s)[NS],
                                          const float (&dp)[NS], const float* lse_b,
                                          const float* delta_b, int q0, int key_a,
                                          uint32_t (&pf)[NS / 8][4], uint32_t (&dsf)[NS / 8][4]) {
    const int t = threadIdx.x & 3;
    const float sl2 = p.scale * LOG2E;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_b + 8 * j + 2 * t);
        const float2 dl2 = *reinterpret_cast<const float2*>(delta_b + 8 * j + 2 * t);
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x =
                fminf(fmaf(s[4 * j + e], sl2, -((e & 1) ? lse2.y : lse2.x)), 30.f * LOG2E);
            pv[e] = exp2_approx(x);
            dsv[e] = pv[e] * (dp[4 * j + e] - ((e & 1) ? dl2.y : dl2.x)) * p.scale;
            if (MASK && !visible(p, q0 + 8 * j + 2 * t + (e & 1), key_a + (e >> 1) * 8)) {
                pv[e] = 0.f;
                dsv[e] = 0.f;
            }
        }
        // query block j is half (j & 1) of the k16 slice j / 2
        pf[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(pv[0], pv[1]);
        pf[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(pv[2], pv[3]);
        dsf[j / 2][(j & 1) * 2 + 0] = MmaOp<T>::pack(dsv[0], dsv[1]);
        dsf[j / 2][(j & 1) * 2 + 1] = MmaOp<T>::pack(dsv[2], dsv[3]);
    }
}

// dk and dv of tiles of 128 keys, each walking the query tiles from the
// first that sees it; with STORE_DS also ds^T of its visible pairs (the
// fused backward's first kernel). A persistent block (one an SM) walks pairs
// of key tiles whose causal work adds up to the same (TilePairs); the
// producer copies the next tile's K and V into the second buffer while the
// consumers finish this one.
template <typename T, int D, bool STORE_DS>
__global__ void __launch_bounds__(KV_THREADS, 1)
    flash_bwd_kv_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do, const BwdParams p) {
    constexpr int BQ = kv_tma_bq<D>();
    constexpr int NS = BQ / 2;  // s^T (and dp^T) accumulators a thread
    constexpr int NG = D / 2;   // dk (and dv) accumulators a thread
    constexpr int KC = BQ / 16; // k16 slices of the dk and dv products
    constexpr uint32_t KV_BOX = KV_ROWS * 128;  // bytes of a 64-column K or V box
    constexpr uint32_t Q_BOX = BQ * 128;        // bytes of a 64-column q or do box
    extern __shared__ unsigned char smem_raw[];
    T* Ks = reinterpret_cast<T*>(align_1024(smem_raw));  // 2 buffers
    T* Vs = Ks + 2 * KV_ROWS * D;                         // 2 buffers
    T* Qs = Vs + 2 * KV_ROWS * D;                         // KV_STAGES stages
    T* dOs = Qs + KV_STAGES * BQ * D;                     // KV_STAGES stages
    float* lse_s = reinterpret_cast<float*>(dOs + KV_STAGES * BQ * D);  // lse * log2(e)
    float* delta_s = lse_s + KV_STAGES * BQ;
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + KV_STAGES * BQ);  // 2
    uint64_t* kv_empty = kv_full + 2;                                            // 2
    uint64_t* full = kv_empty + 2;                                               // KV_STAGES
    uint64_t* empty = full + KV_STAGES;                                          // KV_STAGES

    const TilePairs work(cdiv(p.m, KV_ROWS), p.h * p.b);
    const int num_qt = cdiv(p.n, BQ);
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(kv_full + i, 1);
            mbar_init(kv_empty + i, KV_CONSUMERS);
        }
        for (int s = 0; s < KV_STAGES; ++s) {
            mbar_init(full + s, 32);  // every producer lane writes lse and delta
            mbar_init(empty + s, KV_CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= KV_CONSUMERS * 128) {
        // the producer warpgroup: in its first warp, lane 0 issues the copies
        // and every lane loads the row stats
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x >= KV_CONSUMERS * 128 + 32) return;
        const int lane = threadIdx.x % 32;
        Ring<KV_STAGES> ring;
        int local = 0;  // key tiles this block has walked
        for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
            for (int si = 0; si < work.count(u); ++si, ++local) {
                const Tile tile = work.tile<false>(u, si, p.h);
                const int k0 = tile.t * KV_ROWS;
                const int kb = local & 1;
                if (lane == 0) {
                    mbar_wait(kv_empty + kb, ((local >> 1) & 1) ^ 1);
                    mbar_arrive_expect_tx(kv_full + kb, 2 * KV_ROWS * D * 2);
                    tma_load_rows<D, KV_ROWS>(Ks + kb * KV_ROWS * D, &tm_k, kv_full + kb, k0,
                                              tile.hi, tile.bi);
                    tma_load_rows<D, KV_ROWS>(Vs + kb * KV_ROWS * D, &tm_v, kv_full + kb, k0,
                                              tile.hi, tile.bi);
                }
                const long long row_base = ((long long)tile.bi * p.h + tile.hi) * p.n;
                for (int qt = first_q_tile(p, k0, BQ); qt < num_qt; ++qt, ring.advance()) {
                    const int q0 = qt * BQ;
                    mbar_wait(empty + ring.stage, ring.phase ^ 1);
                    for (int r = lane; r < BQ; r += 32) {
                        const int row = q0 + r;
                        lse_s[ring.stage * BQ + r] =
                            row < p.n ? p.lse[row_base + row] * LOG2E : 0.f;
                        delta_s[ring.stage * BQ + r] = row < p.n ? p.delta[row_base + row] : 0.f;
                    }
                    if (lane == 0) {
                        mbar_arrive_expect_tx(full + ring.stage, 2 * BQ * D * 2);
                        tma_load_rows<D, BQ>(Qs + ring.stage * BQ * D, &tm_q, full + ring.stage,
                                             q0, tile.hi, tile.bi);
                        tma_load_rows<D, BQ>(dOs + ring.stage * BQ * D, &tm_do, full + ring.stage,
                                             q0, tile.hi, tile.bi);
                    } else {
                        mbar_arrive(full + ring.stage);
                    }
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
    const uint32_t q_tiles = smem_addr(Qs);
    const uint32_t do_tiles = smem_addr(dOs);
    constexpr uint32_t STAGE_BYTES = BQ * D * 2;  // one stage of q or of do
    float dk[NG], dv[NG];
    Ring<KV_STAGES> ring;
    int local = 0;
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
        for (int si = 0; si < work.count(u); ++si, ++local) {
            const Tile tile = work.tile<false>(u, si, p.h);
            const int k0 = tile.t * KV_ROWS;
            const int kb = local & 1;
            const int k0w = k0 + wg * 64;        // the warpgroup's first key
            const int key_a = k0w + 16 * w + g;  // this thread's keys: key_a, key_a + 8
            const uint32_t k_tile = smem_addr(Ks + kb * KV_ROWS * D) + wg * 64 * 128;
            const uint32_t v_tile = smem_addr(Vs + kb * KV_ROWS * D) + wg * 64 * 128;
#pragma unroll
            for (int i = 0; i < NG; ++i) {
                dk[i] = 0.f;
                dv[i] = 0.f;
            }
            mbar_wait(kv_full + kb, (local >> 1) & 1);
            for (int qt = first_q_tile(p, k0, BQ); qt < num_qt; ++qt, ring.advance()) {
                const int q0 = qt * BQ;
                mbar_wait(full + ring.stage, ring.phase);
                if (p.causal && q0 + BQ - 1 < k0w) {
                    // every query of the tile precedes the warpgroup's keys
                    if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
                    continue;
                }
                const uint32_t q_tile = q_tiles + ring.stage * STAGE_BYTES;
                const uint32_t do_tile = do_tiles + ring.stage * STAGE_BYTES;

                // s^T = k q^T and dp^T = v do^T: the warpgroup's 64 keys x BQ queries
                float s[NS], dp[NS];
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<T, BQ>(s, kmajor_desc(k_tile, KV_BOX, kk),
                                    kmajor_desc(q_tile, Q_BOX, kk), kk > 0);
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk)
                    wgmma_ss<T, BQ>(dp, kmajor_desc(v_tile, KV_BOX, kk),
                                    kmajor_desc(do_tile, Q_BOX, kk), kk > 0);
                wgmma_commit();
                wgmma_wait<0>();
                reg_fence(s);
                reg_fence(dp);

                // p^T and ds^T, rounded to T as the A operands of the next
                // products; only tiles that cross the diagonal or an end test
                // each pair
                uint32_t pf[KC][4], dsf[KC][4];
                const float* lse_b = lse_s + ring.stage * BQ;
                const float* delta_b = delta_s + ring.stage * BQ;
                if (edge_pair(p, q0, BQ, k0w, 64))
                    p_ds_tile<T, true>(p, s, dp, lse_b, delta_b, q0, key_a, pf, dsf);
                else
                    p_ds_tile<T, false>(p, s, dp, lse_b, delta_b, q0, key_a, pf, dsf);

                // ds^T is stored before the products below take dsf as their A
                // operand: registers a wgmma reads may not be touched until
                // its wait_group
                if (STORE_DS) {  // rows key_a (r = 0) and key_a + 8 (r = 1) of ds^T
                    T* ds_t = ds_rows<T>(p, tile.bi, tile.hi);
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        const int key = key_a + r * 8;
                        if (key >= p.m) continue;
#pragma unroll
                        for (int j = 0; j < NS / 4; ++j)
                            *reinterpret_cast<uint32_t*>(ds_t + (long long)key * ds_ld(p.n) + q0 +
                                                         8 * j + 2 * t) =
                                dsf[j / 2][(j & 1) * 2 + r];
                    }
                }

                // dv += p^T do, dk += ds^T q
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) {
                    wgmma_rs<T, D>(dv, pf[kc], mnmajor_desc(do_tile, Q_BOX, kc), 1);
                    wgmma_rs<T, D>(dk, dsf[kc], mnmajor_desc(q_tile, Q_BOX, kc), 1);
                }
                wgmma_commit();
                wgmma_wait<0>();
                reg_fence(dk);
                reg_fence(dv);
                reg_fence(pf);
                reg_fence(dsf);
                if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
            }
            // every product of this tile is done: its K/V buffer may be refilled
            if (threadIdx.x % 128 == 0) mbar_arrive(kv_empty + kb);

            // rows key_a (r = 0) and key_a + 8 (r = 1) of dk and dv
            T* dk_out = static_cast<T*>(p.dk) + tile.bi * p.sdk[0] + tile.hi * p.sdk[1];
            T* dv_out = static_cast<T*>(p.dv) + tile.bi * p.sdv[0] + tile.hi * p.sdv[1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int key = key_a + r * 8;
                if (key >= p.m) continue;
#pragma unroll
                for (int j = 0; j < NG / 4; ++j) {
                    *reinterpret_cast<uint32_t*>(dk_out + (long long)key * p.sdk[2] + 8 * j +
                                                 2 * t) =
                        MmaOp<T>::pack(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
                    *reinterpret_cast<uint32_t*>(dv_out + (long long)key * p.sdv[2] + 8 * j +
                                                 2 * t) =
                        MmaOp<T>::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The dq kernel, bf16 / fp16: wgmma on TMA-fed shared memory, the forward's
// design with a second score product.
//
// A persistent block (one an SM) walks query tiles of 128 rows in pairs
// whose causal work adds up to the same (TilePairs): two consumer
// warpgroups of 64 rows (wgmma's M) and one producer warpgroup, of which
// one thread issues the copies. It copies each tile's q and do once into
// one of two buffers, so the next tile's copy overlaps this one, and
// streams the K and V tiles of BN keys up to the tile's diagonal through a
// ring of DQ_STAGES buffers. Each consumer computes s = q k^T and dp = do
// v^T as SS wgmma (q and do K-major A, K and V K-major B), ds from the f32
// accumulators in registers (lse and delta of its two rows held there), and
// dq += ds k as RS wgmma: ds packed to T as the A operand, and the same
// swizzled K tile as an MN-major B. The products of the next key tile are
// issued with this tile's dq += ds k, so the tensor cores work while the
// exponentials of the next tile issue. Without that overlap, or with
// 64-key tiles, the kernel measured 10-14 % slower at seq 8192 on an H100
// SXM at 700 W (64-key tiles were 9-16 % faster at seq 512-1024, where
// the diagonal tiles weigh more).
//
// FROM_DS (the fused backward's second kernel) streams K and the ds^T
// workspace instead and needs no q, do, V, lse or delta: the tile's 128
// query columns of ds^T are two 64-column boxes, box w holding warpgroup
// w's queries contiguous; ldmatrix.trans takes ds from it into registers
// for dq += ds k as RS wgmma (an SS wgmma with A transposed measured the
// same on the H100, within 1 %). The dk/dv kernel writes ds^T only for
// the pairs it visits: key k at queries from k rounded down to 64 on
// (causal). So a warpgroup reads only the keys up to its last row (on the
// diagonal tile of 128 keys, the first warpgroup takes 64), and the tensor
// map's columns end at n: the workspace is never zeroed, and what it holds
// past that region never reaches a product.

constexpr int DQ_ROWS = 128;  // query rows per tile: 2 consumer warpgroups x 64
constexpr int DQ_CONSUMERS = 2;
constexpr int DQ_THREADS = (DQ_CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int DQ_STAGES = 3;                          // key tiles in flight

// keys per tile: at d = 128 the recomputing kernel takes 64 (its q and do
// buffers take 128 KB of shared memory)
template <int D, bool FROM_DS>
__host__ __device__ constexpr int dq_bn() {
    return FROM_DS || D == 64 ? 128 : 64;
}

// columns of the second tile of a stage: V (d) or the tile's ds^T (128 queries)
template <int D, bool FROM_DS>
__host__ __device__ constexpr int dq_x_cols() {
    return FROM_DS ? DQ_ROWS : D;
}

template <int D, bool FROM_DS>
constexpr size_t dq_tma_smem_bytes() {
    // two buffers each of q and do (recomputing only), then K and V (or
    // ds^T) of every stage, the barriers and the 1024-byte alignment slack
    constexpr int BN = dq_bn<D, FROM_DS>();
    return (size_t)(FROM_DS ? 0 : 4 * DQ_ROWS * D) * 2 +
           (size_t)DQ_STAGES * BN * (D + dq_x_cols<D, FROM_DS>()) * 2 +
           (2 * DQ_STAGES + 4) * 8 + 1024;
}

// ds of one warpgroup's 64 query rows x NS / 2 keys from the s and dp
// accumulators, left in s as f32: the dk/dv kernel's arithmetic (p_ds_tile),
// for rows row_a (r = 0) and row_a + 8 (r = 1) of this thread, keys k0 + 8 j
// + 2 t (+ 1). lse2 holds lse * log2(e) of the two rows, dl their delta.
// MASK tests each pair for visibility.
template <bool MASK, int NS>
__device__ __forceinline__ void ds_rows_tile(const BwdParams& p, float (&s)[NS],
                                             const float (&dp)[NS], const float (&lse2)[2],
                                             const float (&dl)[2], int row_a, int k0) {
    const int t = threadIdx.x & 3;
    const float sl2 = p.scale * LOG2E;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float pv = exp2_approx(fminf(fmaf(s[4 * j + e], sl2, -lse2[r]), 30.f * LOG2E));
            float dsv = pv * (dp[4 * j + e] - dl[r]) * p.scale;
            if (MASK && !visible(p, row_a + 8 * r, k0 + 8 * j + 2 * t + (e & 1))) dsv = 0.f;
            s[4 * j + e] = dsv;
        }
}

// ldmatrix.x4.trans: four 8 x 8 16-bit matrices from shared memory,
// transposed, lane l giving the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// dq += ds k over the first SLICES k16 slices of the key tile (FROM_DS):
// ds from the warpgroup's swizzled ds^T box (keys as rows, its 64 queries
// contiguous) by ldmatrix.trans into the RS A fragments (rows g, g + 8,
// keys 2t.. and 2t + 8..), K as the MN-major B
template <typename T, int D, int SLICES>
__device__ __forceinline__ void dq_from_ds(float (&dq)[D / 2], uint32_t ds_tile, uint32_t k_tile,
                                           uint32_t box) {
    const int lane = threadIdx.x % 32;
    const int w = (threadIdx.x % 128) / 32;
    // the 16-byte chunk of the warp's 16 queries that this lane's matrix holds
    const int chunk = 2 * w + ((lane >> 3) & 1);
    uint32_t a[SLICES][4];
#pragma unroll
    for (int kc = 0; kc < SLICES; ++kc) {
        const int key = 16 * kc + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4_trans(a[kc], ds_tile + key * 128 + ((chunk ^ (key & 7)) << 4));
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < SLICES; ++kc) wgmma_rs<T, D>(dq, a[kc], mnmajor_desc(k_tile, box, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(a);
}

// dq of query tiles of 128 rows, each walking the key tiles up to its
// diagonal. FROM_DS (the fused backward's second kernel) reads ds^T from
// the workspace instead of recomputing s, p and dp. tm_q and tm_do are
// unused with FROM_DS, and tm_x maps V or, with FROM_DS, the ds^T workspace.
template <typename T, int D, bool FROM_DS>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_do, const BwdParams p) {
    constexpr int BQ = DQ_ROWS;
    constexpr int BN = dq_bn<D, FROM_DS>();
    constexpr int XW = dq_x_cols<D, FROM_DS>();
    constexpr int ST = DQ_STAGES;
    constexpr int QBUFS = FROM_DS ? 0 : 2;
    constexpr int NS = BN / 2;   // s (and dp) accumulators a thread
    constexpr int NO = D / 2;    // dq accumulators a thread
    constexpr int KC = BN / 16;  // k16 slices of dq += ds k
    constexpr uint32_t Q_BOX = BQ * 128;   // bytes of a 64-column q or do box
    constexpr uint32_t KV_BOX = BN * 128;  // bytes of a 64-column K, V or ds^T box
    constexpr uint32_t K_STAGE = BN * D * 2;
    constexpr uint32_t X_STAGE = BN * XW * 2;
    extern __shared__ unsigned char smem_raw[];
    T* Qs = reinterpret_cast<T*>(align_1024(smem_raw));  // QBUFS buffers
    T* dOs = Qs + QBUFS * BQ * D;                         // QBUFS buffers
    T* Ks = dOs + QBUFS * BQ * D;                         // ST stages
    T* Xs = Ks + ST * BN * D;                             // ST stages of V or ds^T
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Xs + ST * BN * XW);  // 2
    uint64_t* q_empty = q_full + 2;                                      // 2
    uint64_t* full = q_empty + 2;                                        // ST
    uint64_t* empty = full + ST;                                         // ST

    const TilePairs work(cdiv(p.n, BQ), p.h * p.b);
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(q_full + i, 1);
            mbar_init(q_empty + i, DQ_CONSUMERS);
        }
        for (int s = 0; s < ST; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, DQ_CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= DQ_CONSUMERS * 128) {
        // the producer warpgroup; one thread issues every copy
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x != DQ_CONSUMERS * 128) return;
        Ring<ST> ring;
        int local = 0;  // tiles this block has walked
        for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
            for (int si = 0; si < work.count(u); ++si, ++local) {
                const Tile tile = work.tile<true>(u, si, p.h);
                const int q0 = tile.t * BQ;
                if constexpr (!FROM_DS) {
                    const int qb = local & 1;
                    mbar_wait(q_empty + qb, ((local >> 1) & 1) ^ 1);
                    mbar_arrive_expect_tx(q_full + qb, 2 * BQ * D * 2);
                    tma_load_rows<D, BQ>(Qs + qb * BQ * D, &tm_q, q_full + qb, q0, tile.hi,
                                         tile.bi);
                    tma_load_rows<D, BQ>(dOs + qb * BQ * D, &tm_do, q_full + qb, q0, tile.hi,
                                         tile.bi);
                }
                const int kt_end = last_k_tile(p, q0, BQ, BN);
                for (int kt = 0; kt < kt_end; ++kt, ring.advance()) {
                    mbar_wait(empty + ring.stage, ring.phase ^ 1);
                    mbar_arrive_expect_tx(full + ring.stage, BN * (D + XW) * 2);
                    tma_load_rows<D, BN>(Ks + ring.stage * BN * D, &tm_k, full + ring.stage,
                                         kt * BN, tile.hi, tile.bi);
                    T* x = Xs + ring.stage * BN * XW;
                    if constexpr (FROM_DS) {
                        // ds^T rows kt * BN.. (keys), columns q0.. (queries)
#pragma unroll
                        for (int c = 0; c < XW / 64; ++c)
                            tma_load_box(x + c * BN * 64, &tm_x, full + ring.stage, q0 + c * 64,
                                         kt * BN, tile.hi, tile.bi);
                    } else {
                        tma_load_rows<D, BN>(x, &tm_x, full + ring.stage, kt * BN, tile.hi,
                                             tile.bi);
                    }
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
    const uint32_t k_tiles = smem_addr(Ks);
    const uint32_t x_tiles = smem_addr(Xs);
    float dq[NO];
    Ring<ST> ring;
    int local = 0;
    for (int u = blockIdx.x; u < work.units; u += gridDim.x) {
        for (int si = 0; si < work.count(u); ++si, ++local) {
            const Tile tile = work.tile<true>(u, si, p.h);
            const int q0 = tile.t * BQ;
            const int kt_end = last_k_tile(p, q0, BQ, BN);
            const int q0w = q0 + wg * 64;        // the warpgroup's first row
            const int row_a = q0w + 16 * w + g;  // this thread's rows: row_a, row_a + 8
            // key tiles with a key that some row of the warpgroup sees; the
            // rest (causal) only pass through the ring
            const int kt_wg = p.causal ? min(kt_end, (q0w + 63) / BN + 1) : kt_end;
#pragma unroll
            for (int i = 0; i < NO; ++i) dq[i] = 0.f;

            if constexpr (FROM_DS) {
                for (int kt = 0; kt < kt_wg; ++kt, ring.advance()) {
                    mbar_wait(full + ring.stage, ring.phase);
                    // the warpgroup's queries are box wg of the ds^T tile;
                    // causal, on the diagonal tile the first warpgroup's rows
                    // see 64 keys
                    const uint32_t ds_tile = x_tiles + ring.stage * X_STAGE + wg * KV_BOX;
                    const uint32_t k_tile = k_tiles + ring.stage * K_STAGE;
                    if (p.causal && q0w + 64 - kt * BN < BN)
                        dq_from_ds<T, D, KC / 2>(dq, ds_tile, k_tile, KV_BOX);
                    else
                        dq_from_ds<T, D, KC>(dq, ds_tile, k_tile, KV_BOX);
                    if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
                }
            } else {
                const int qb = local & 1;
                const uint32_t q_tile = smem_addr(Qs + qb * BQ * D) + wg * 64 * 128;
                const uint32_t do_tile = smem_addr(dOs + qb * BQ * D) + wg * 64 * 128;
                const long long row_base = ((long long)tile.bi * p.h + tile.hi) * p.n;
                float lse2[2], dl[2];  // lse * log2(e) and delta of rows row_a, row_a + 8
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int row = row_a + r * 8;
                    lse2[r] = row < p.n ? p.lse[row_base + row] * LOG2E : 0.f;
                    dl[r] = row < p.n ? p.delta[row_base + row] : 0.f;
                }
                float s[NS], dp[NS];
                uint32_t dsf[KC][4];
                // The tiles' addresses pass through an empty asm, so the
                // shared-memory descriptors are rebuilt at each issue (a few
                // integer operations) instead of held in registers across
                // the loop: held, they spilled at d = 64, where s, dp, dq
                // and the in-flight ds take 192 registers a thread.
                // s = q k^T and dp = do v^T of the key tile in `stage`, one group
                auto issue_s = [&](int stage) {
                    uint32_t qa = q_tile, da = do_tile;
                    uint32_t ka = k_tiles + stage * K_STAGE, va = x_tiles + stage * X_STAGE;
                    asm volatile("" : "+r"(qa), "+r"(da), "+r"(ka), "+r"(va));
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < D / 16; ++kk)
                        wgmma_ss<T, BN>(s, kmajor_desc(qa, Q_BOX, kk),
                                        kmajor_desc(ka, KV_BOX, kk), kk > 0);
#pragma unroll
                    for (int kk = 0; kk < D / 16; ++kk)
                        wgmma_ss<T, BN>(dp, kmajor_desc(da, Q_BOX, kk),
                                        kmajor_desc(va, KV_BOX, kk), kk > 0);
                    wgmma_commit();
                };
                // dq += ds k of the key tile in `stage` (the same swizzled K
                // tile, MN-major), one group
                auto issue_dq = [&](int stage) {
                    uint32_t ka = k_tiles + stage * K_STAGE;
                    asm volatile("" : "+r"(ka));
                    wgmma_fence();
#pragma unroll
                    for (int kc = 0; kc < KC; ++kc)
                        wgmma_rs<T, D>(dq, dsf[kc], mnmajor_desc(ka, KV_BOX, kc), 1);
                    wgmma_commit();
                };
                // ds of key tile kt, left in s (f32); only tiles that cross
                // the diagonal or an end test each pair
                auto make_ds = [&](int kt) {
                    const int k0 = kt * BN;
                    if (edge_pair(p, q0w, 64, k0, BN))
                        ds_rows_tile<true>(p, s, dp, lse2, dl, row_a, k0);
                    else
                        ds_rows_tile<false>(p, s, dp, lse2, dl, row_a, k0);
                };
                // ds (f32, in s) -> the A operands of dq += ds k, rounded to T
                auto pack_ds = [&]() {
#pragma unroll
                    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            dsf[kc][i] = MmaOp<T>::pack(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
                };

                mbar_wait(q_full + qb, (local >> 1) & 1);
                mbar_wait(full + ring.stage, ring.phase);
                issue_s(ring.stage);
                wgmma_wait<0>();
                reg_fence(s);
                reg_fence(dp);
                make_ds(0);
                pack_ds();
                for (int kt = 1; kt < kt_wg; ++kt) {
                    const int prev = ring.stage;
                    ring.advance();
                    mbar_wait(full + ring.stage, ring.phase);
                    issue_s(ring.stage);  // s and dp of tile kt ...
                    issue_dq(prev);       // ... while dq of tile kt - 1 runs
                    wgmma_wait<1>();
                    reg_fence(s);
                    reg_fence(dp);
                    make_ds(kt);
                    // registers an in-flight RS wgmma reads (dsf) are not
                    // touched before its wait_group
                    wgmma_wait<0>();
                    reg_fence(dq);
                    reg_fence(dsf);
                    if (threadIdx.x % 128 == 0) mbar_arrive(empty + prev);
                    pack_ds();
                }
                // every product on this tile's q and do has been issued and
                // is done but the last dq += ds k, which reads K only
                if (threadIdx.x % 128 == 0) mbar_arrive(q_empty + qb);
                issue_dq(ring.stage);
                wgmma_wait<0>();
                reg_fence(dq);
                reg_fence(dsf);
                if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
                ring.advance();
            }
            // key tiles whose keys all follow the warpgroup's rows
            for (int kt = kt_wg; kt < kt_end; ++kt, ring.advance()) {
                mbar_wait(full + ring.stage, ring.phase);
                if (threadIdx.x % 128 == 0) mbar_arrive(empty + ring.stage);
            }

            // rows row_a (r = 0) and row_a + 8 (r = 1) of dq
            T* dq_out = static_cast<T*>(p.dq) + tile.bi * p.sdq[0] + tile.hi * p.sdq[1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = row_a + r * 8;
                if (row >= p.n) continue;
#pragma unroll
                for (int j = 0; j < NO / 4; ++j)
                    *reinterpret_cast<uint32_t*>(dq_out + (long long)row * p.sdq[2] + 8 * j +
                                                 2 * t) =
                        MmaOp<T>::pack(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The CUDA-core kernels: f32 at every head dim, and bf16 / fp16 at d = 192
// and 256, where the wgmma kernels' rings would not fit in shared memory
// (they are instantiated at d = 64 and 128). 256 threads as 16 x 16; thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j of every product, so the
// operand reads of a warp are broadcasts or hit distinct banks. Operands are
// staged in shared memory as T (16-bit ones in half the bytes of f32, rows
// padded to an odd number of 32-bit words) and widened to f32 at use: a
// product of two bf16 or fp16 values is exact in f32, so this is the wgmma
// kernels' "native products, f32 sums"; p and ds are rounded to T before the
// products they feed, as those kernels pack them.
//
// Tiles of 64 rows and 64 columns, except where that does not fit in a
// block's 227 KB (f32 at d = 256): there the dk/dv kernel streams query tiles
// of 32 rows and the dq kernel key tiles of 32 (kv_cc_bq, dq_cc_bn). Each
// budget is a static_assert.

constexpr int F32_THREADS = 256;
constexpr int F32_BQ = 64;  // query rows of the dq kernel's tile

// row stride of a staged [rows, D] operand tile, in elements of T
template <typename T, int D>
__host__ __device__ constexpr int cc_ldf() { return D + (sizeof(T) == 4 ? 1 : 2); }

// p and ds of one score; both 0 where the pair is masked
__device__ __forceinline__ void p_ds(const BwdParams& p, bool vis, float s, float dp, float lse,
                                     float delta, float& pv, float& dsv) {
    pv = vis ? expf(fminf(s * p.scale - lse, 30.f)) : 0.f;
    dsv = vis ? pv * (dp - delta) * p.scale : 0.f;
}

// lse and delta of rows row0.. (0 past the end) into shared memory
template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const float* lse,
                                               const float* delta, int row0, int n) {
    for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
        const int row = row0 + r;
        lse_s[r] = row < n ? lse[row] : 0.f;
        delta_s[r] = row < n ? delta[row] : 0.f;
    }
}

// acc[i][j] += sum_kk A[(ty + 16 i) * a_r + kk * a_k] * B[kk * b_k + (tx + 16 j) * b_c]
template <int NJ, typename TA, typename TB>
__device__ __forceinline__ void cc_mm(float (*acc)[NJ], const TA* A, int a_r, int a_k,
                                      const TB* B, int b_k, int b_c, int depth) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
        float a[4], b[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cvt<TA>::to(A[(ty + 16 * i) * a_r + kk * a_k]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = Cvt<TB>::to(B[kk * b_k + (tx + 16 * j) * b_c]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

// ROWS rows row0.. of x into dst[r * cc_ldf + c]; rows at or past `limit`
// are 0
template <typename T, int D, int ROWS>
__device__ __forceinline__ void cc_load_rows(T* dst, const T* x, long long row_stride, int row0,
                                             int limit) {
    constexpr int LDF = cc_ldf<T, D>();
    for (int idx = threadIdx.x; idx < ROWS * D; idx += F32_THREADS) {
        const int r = idx / D;
        const int c = idx % D;
        const int row = row0 + r;
        dst[r * LDF + c] = row < limit ? x[(long long)row * row_stride + c] : Cvt<T>::from(0.f);
    }
}

template <int NJ>
__device__ __forceinline__ void f32_zero(float (*acc)[NJ]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// Store this thread's rows ty + 16 i (row0.., below limit) and columns
// tx + 16 j, rounded to T.
template <int NJ, typename T>
__device__ __forceinline__ void cc_store_rows(T* x, long long row_stride, int row0, int limit,
                                              const float (*acc)[NJ]) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty + 16 * i;
        if (row >= limit) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            x[(long long)row * row_stride + tx + 16 * j] = Cvt<T>::from(acc[i][j]);
    }
}

template <typename T, int D, int BQ>
constexpr size_t kv_cc_smem_bytes() {
    // K, V tiles of BK keys and q, do tiles of BQ rows (T); p^T and ds^T;
    // lse and delta
    return (size_t)(2 * BK + 2 * BQ) * cc_ldf<T, D>() * sizeof(T) +
           ((size_t)2 * BK * (BQ + 1) + 2 * BQ) * sizeof(float);
}

// query rows of the dk/dv kernel's streamed tile: 64 where it fits
template <typename T, int D>
constexpr int kv_cc_bq() { return kv_cc_smem_bytes<T, D, 64>() <= MAX_SMEM ? 64 : 32; }

// The dk/dv of one tile of BK keys, streaming query tiles of BQ rows;
// STORE_DS also writes ds^T, rounded to T, to the fused pass's workspace.
template <typename T, int D, int BQ, bool STORE_DS>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_kv_cc_kernel(const BwdParams p) {
    constexpr int LDF = cc_ldf<T, D>();
    constexpr int NJ = D / 16;
    constexpr int NQ = BQ / 16;  // query columns a thread
    constexpr int LDQ = BQ + 1;  // row stride of p^T and ds^T
    extern __shared__ __align__(16) unsigned char cc_smem[];
    T* Ks = reinterpret_cast<T*>(cc_smem);
    T* Vs = Ks + BK * LDF;
    T* Qs = Vs + BK * LDF;
    T* dOs = Qs + BQ * LDF;
    float* Pt = reinterpret_cast<float*>(dOs + BQ * LDF);
    float* dSt = Pt + BK * LDQ;
    float* lse_s = dSt + BK * LDQ;
    float* delta_s = lse_s + BQ;

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<false>(cdiv(p.m, BK), p.h);
    const int hi = tile.hi;
    const int bi = tile.bi;
    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    T* dk = static_cast<T*>(p.dk) + bi * p.sdk[0] + hi * p.sdk[1];
    T* dv = static_cast<T*>(p.dv) + bi * p.sdv[0] + hi * p.sdv[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    T* ds_t = STORE_DS ? ds_rows<T>(p, bi, hi) : nullptr;

    const int k0 = tile.t * BK;
    cc_load_rows<T, D, BK>(Ks, k, p.sk[2], k0, p.m);
    cc_load_rows<T, D, BK>(Vs, v, p.sv[2], k0, p.m);
    float dk_acc[4][NJ], dv_acc[4][NJ];
    f32_zero<NJ>(dk_acc);
    f32_zero<NJ>(dv_acc);
    for (int qt = first_q_tile(p, k0, BQ); qt < cdiv(p.n, BQ); ++qt) {
        const int q0 = qt * BQ;
        cc_load_rows<T, D, BQ>(Qs, q, p.sq[2], q0, p.n);
        cc_load_rows<T, D, BQ>(dOs, dout, p.sdo[2], q0, p.n);
        load_row_stats<BQ>(lse_s, delta_s, p.lse + row_base, p.delta + row_base, q0, p.n);
        __syncthreads();

        // s^T[key][query] = k q^T and dp^T = v do^T
        float s[4][NQ], dp[4][NQ];
        f32_zero<NQ>(s);
        f32_zero<NQ>(dp);
        cc_mm<NQ>(s, Ks, LDF, 1, Qs, 1, LDF, D);
        cc_mm<NQ>(dp, Vs, LDF, 1, dOs, 1, LDF, D);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NQ; ++j) {
                const int key = ty + 16 * i;
                const int col = tx + 16 * j;
                float pv, dsv;
                p_ds(p, visible(p, q0 + col, k0 + key), s[i][j], dp[i][j], lse_s[col],
                     delta_s[col], pv, dsv);
                Pt[key * LDQ + col] = round_to<T>(pv);
                dSt[key * LDQ + col] = round_to<T>(dsv);
                if (STORE_DS && k0 + key < p.m)
                    ds_t[(long long)(k0 + key) * ds_ld(p.n) + q0 + col] = Cvt<T>::from(dsv);
            }
        __syncthreads();
        cc_mm<NJ>(dv_acc, Pt, LDQ, 1, dOs, LDF, 1, BQ);  // dv += p^T do
        cc_mm<NJ>(dk_acc, dSt, LDQ, 1, Qs, LDF, 1, BQ);  // dk += ds^T q
        __syncthreads();  // the next tile overwrites q, do, p^T and ds^T
    }
    cc_store_rows<NJ>(dk, p.sdk[2], k0, p.m, dk_acc);
    cc_store_rows<NJ>(dv, p.sdv[2], k0, p.m, dv_acc);
}

template <typename T, int D, int BN>
constexpr size_t dq_cc_smem_bytes() {
    // q, do tiles of F32_BQ rows and K, V tiles of BN keys (T); ds; lse and
    // delta
    return (size_t)(2 * F32_BQ + 2 * BN) * cc_ldf<T, D>() * sizeof(T) +
           ((size_t)F32_BQ * (BN + 1) + 2 * F32_BQ) * sizeof(float);
}

// keys of the dq kernel's streamed tile: 64 where it fits
template <typename T, int D>
constexpr int dq_cc_bn() { return dq_cc_smem_bytes<T, D, 64>() <= MAX_SMEM ? 64 : 32; }

// dq of one tile of F32_BQ query rows, streaming key tiles of BN; FROM_DS
// reads ds^T from the workspace instead of recomputing it.
template <typename T, int D, int BN, bool FROM_DS>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_dq_cc_kernel(const BwdParams p) {
    constexpr int LDF = cc_ldf<T, D>();
    constexpr int NJ = D / 16;
    constexpr int NK = BN / 16;  // key columns a thread
    constexpr int LDS = BN + 1;  // row stride of ds
    extern __shared__ __align__(16) unsigned char cc_smem[];
    T* Qs = reinterpret_cast<T*>(cc_smem);
    T* dOs = Qs + F32_BQ * LDF;
    T* Ks = dOs + F32_BQ * LDF;
    T* Vs = Ks + BN * LDF;
    float* dSs = reinterpret_cast<float*>(Vs + BN * LDF);
    float* lse_s = dSs + F32_BQ * LDS;
    float* delta_s = lse_s + F32_BQ;

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<true>(cdiv(p.n, F32_BQ), p.h);
    const int q0 = tile.t * F32_BQ;
    const int hi = tile.hi;
    const int bi = tile.bi;
    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    T* dq = static_cast<T*>(p.dq) + bi * p.sdq[0] + hi * p.sdq[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    const T* ds_t = FROM_DS ? ds_rows<T>(p, bi, hi) : nullptr;

    if (!FROM_DS) {
        cc_load_rows<T, D, F32_BQ>(Qs, q, p.sq[2], q0, p.n);
        cc_load_rows<T, D, F32_BQ>(dOs, dout, p.sdo[2], q0, p.n);
        load_row_stats<F32_BQ>(lse_s, delta_s, p.lse + row_base, p.delta + row_base, q0, p.n);
    }
    float dq_acc[4][NJ];
    f32_zero<NJ>(dq_acc);
    const int kt_end = last_k_tile(p, q0, F32_BQ, BN);
    for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * BN;
        cc_load_rows<T, D, BN>(Ks, k, p.sk[2], k0, p.m);
        if (FROM_DS) {
            // ds[query r][key c] from ds^T; consecutive threads read
            // consecutive queries of one key row (queries past n read 0:
            // the workspace holds whole tiles of the dk/dv kernel's rows)
            for (int idx = threadIdx.x; idx < BN * F32_BQ; idx += F32_THREADS) {
                const int c = idx / F32_BQ;
                const int r = idx % F32_BQ;
                dSs[r * LDS + c] =
                    k0 + c < p.m && q0 + r < p.n
                        ? Cvt<T>::to(ds_t[(long long)(k0 + c) * ds_ld(p.n) + q0 + r])
                        : 0.f;
            }
            __syncthreads();
        } else {
            cc_load_rows<T, D, BN>(Vs, v, p.sv[2], k0, p.m);
            __syncthreads();
            // s[query][key] = q k^T and dp = do v^T
            float s[4][NK], dp[4][NK];
            f32_zero<NK>(s);
            f32_zero<NK>(dp);
            cc_mm<NK>(s, Qs, LDF, 1, Ks, 1, LDF, D);
            cc_mm<NK>(dp, dOs, LDF, 1, Vs, 1, LDF, D);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NK; ++j) {
                    const int r = ty + 16 * i;
                    const int c = tx + 16 * j;
                    float pv, dsv;
                    p_ds(p, visible(p, q0 + r, k0 + c), s[i][j], dp[i][j], lse_s[r],
                         delta_s[r], pv, dsv);
                    dSs[r * LDS + c] = round_to<T>(dsv);
                }
            __syncthreads();
        }
        cc_mm<NJ>(dq_acc, dSs, LDS, 1, Ks, LDF, 1, BN);  // dq += ds k
        __syncthreads();  // the next tile overwrites K, V and ds
    }
    cc_store_rows<NJ>(dq, p.sdq[2], q0, p.n, dq_acc);
}

// ---------------------------------------------------------------------------

enum Pass { FUSED_PASS, DQ_PASS, DKV_PASS };

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const BwdParams& p,
                   cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// The dk/dv kernel (with STORE_DS: the fused backward's first kernel) on its
// four tensor maps.
template <typename T, int D, bool STORE_DS>
cudaError_t launch_kv_tma(const BwdParams& p, int b, cudaStream_t stream) {
    CUtensorMap maps[4];
    const void* bases[4] = {p.q, p.k, p.v, p.dout};
    const long long* strides[4] = {p.sq, p.sk, p.sv, p.sdo};
    const int rows[4] = {p.n, p.m, p.m, p.n};
    const int box_rows[4] = {kv_tma_bq<D>(), KV_ROWS, KV_ROWS, kv_tma_bq<D>()};
    for (int i = 0; i < 4; ++i) {
        const cudaError_t err = encode_rows_map<T>(&maps[i], bases[i], D, rows[i], p.h, b,
                                                   strides[i], box_rows[i]);
        if (err != cudaSuccess) return err;
    }
    const auto kernel = flash_bwd_kv_tma_kernel<T, D, STORE_DS>;
    const size_t smem = kv_tma_smem_bytes<D>();
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = persistent_grid((cdiv(p.m, KV_ROWS) + 1) / 2 * p.h * b);
    kernel<<<grid, KV_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
    return cudaGetLastError();
}

// The dq kernel on its four tensor maps: q, K, V and do, or with FROM_DS
// K and the ds^T workspace (columns n of rows ds_ld(n), so the queries past
// n read as zeros) with K's map in the unused places.
template <typename T, int D, bool FROM_DS>
cudaError_t launch_dq_tma(const BwdParams& p, int b, cudaStream_t stream) {
    constexpr int BN = dq_bn<D, FROM_DS>();
    CUtensorMap maps[4];
    cudaError_t err = encode_rows_map<T>(&maps[1], p.k, D, p.m, p.h, b, p.sk, BN);
    if (err != cudaSuccess) return err;
    if (FROM_DS) {
        const long long ld = ds_ld(p.n);
        const long long ds_strides[3] = {(long long)p.h * p.m * ld, (long long)p.m * ld, ld};
        err = encode_rows_map<T>(&maps[2], p.ds, p.n, p.m, p.h, b, ds_strides, BN);
        maps[0] = maps[3] = maps[1];
    } else {
        err = encode_rows_map<T>(&maps[0], p.q, D, p.n, p.h, b, p.sq, DQ_ROWS);
        if (err == cudaSuccess) err = encode_rows_map<T>(&maps[2], p.v, D, p.m, p.h, b, p.sv, BN);
        if (err == cudaSuccess)
            err = encode_rows_map<T>(&maps[3], p.dout, D, p.n, p.h, b, p.sdo, DQ_ROWS);
    }
    if (err != cudaSuccess) return err;
    const auto kernel = flash_bwd_dq_tma_kernel<T, D, FROM_DS>;
    constexpr size_t smem = dq_tma_smem_bytes<D, FROM_DS>();
    static_assert(smem <= MAX_SMEM, "the dq kernel's shared memory exceeds a block's 227 KB");
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = persistent_grid((cdiv(p.n, DQ_ROWS) + 1) / 2 * p.h * b);
    kernel<<<grid, DQ_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_16bit(const BwdParams& p, Pass pass, int b, cudaStream_t s) {
    if (pass == DKV_PASS) return launch_kv_tma<T, D, false>(p, b, s);
    if (pass == DQ_PASS) return launch_dq_tma<T, D, false>(p, b, s);
    cudaError_t err = launch_kv_tma<T, D, true>(p, b, s);
    if (err != cudaSuccess) return err;
    return launch_dq_tma<T, D, true>(p, b, s);
}

template <typename T, int D>
cudaError_t launch_cc(const BwdParams& p, Pass pass, int b, cudaStream_t s) {
    constexpr int BQ = kv_cc_bq<T, D>();
    constexpr int BN = dq_cc_bn<T, D>();
    constexpr size_t kv_smem = kv_cc_smem_bytes<T, D, BQ>();
    constexpr size_t dq_smem = dq_cc_smem_bytes<T, D, BN>();
    static_assert(kv_smem <= MAX_SMEM, "the CUDA-core dk/dv kernel's shared memory exceeds 227 KB");
    static_assert(dq_smem <= MAX_SMEM, "the CUDA-core dq kernel's shared memory exceeds 227 KB");
    const dim3 kv_grid = tile_grid(cdiv(p.m, BK), p.h, b);
    const dim3 q_grid = tile_grid(cdiv(p.n, F32_BQ), p.h, b);
    if (pass == DKV_PASS)
        return launch(flash_bwd_kv_cc_kernel<T, D, BQ, false>, kv_grid, kv_smem, p, s);
    if (pass == DQ_PASS)
        return launch(flash_bwd_dq_cc_kernel<T, D, BN, false>, q_grid, dq_smem, p, s);
    cudaError_t err = launch(flash_bwd_kv_cc_kernel<T, D, BQ, true>, kv_grid, kv_smem, p, s);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_cc_kernel<T, D, BN, true>, q_grid, dq_smem, p, s);
}

// d = 64 and 128: the wgmma kernels for bf16 / fp16, the CUDA-core kernels
// for f32; d = 192 and 256: the CUDA-core kernels for every type.
template <int D>
cudaError_t launch_d(const BwdParams& p, Pass pass, int dtype, int b, cudaStream_t s) {
    constexpr bool WGMMA = D <= 128;
    switch (dtype) {
        case 0:
            return launch_cc<float, D>(p, pass, b, s);
        case 1:
            if constexpr (WGMMA) return launch_16bit<__nv_bfloat16, D>(p, pass, b, s);
            else return launch_cc<__nv_bfloat16, D>(p, pass, b, s);
        case 2:
            if constexpr (WGMMA) return launch_16bit<__half, D>(p, pass, b, s);
            else return launch_cc<__half, D>(p, pass, b, s);
        default:
            return cudaErrorInvalidValue;
    }
}

int run(Pass pass, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, void* ds,
        int dtype, int b, int h, int n, int m, int d, const long long* strides, float scale,
        int causal, void* stream) {
    const bool writes_dq = pass == FUSED_PASS || pass == DQ_PASS;
    const bool writes_dkv = pass == FUSED_PASS || pass == DKV_PASS;
    if (b <= 0 || h <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    if (writes_dq && dq == nullptr) return (int)cudaErrorInvalidValue;
    if (writes_dkv && (dk == nullptr || dv == nullptr)) return (int)cudaErrorInvalidValue;
    if (pass == FUSED_PASS && ds == nullptr) return (int)cudaErrorInvalidValue;
    BwdParams p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.ds = ds;
    long long* dst[7] = {p.sq, p.sk, p.sv, p.sdo, p.sdq, p.sdk, p.sdv};
    for (int i = 0; i < 7; ++i)
        for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
    p.b = b;
    p.h = h;
    p.n = n;
    p.m = m;
    p.scale = scale;
    p.causal = causal;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 64) return (int)launch_d<64>(p, pass, dtype, b, s);
    if (d == 128) return (int)launch_d<128>(p, pass, dtype, b, s);
    if (d == 192) return (int)launch_d<192>(p, pass, dtype, b, s);
    if (d == 256) return (int)launch_d<256>(p, pass, dtype, b, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. `strides` holds the (b, h,
// row) strides in elements of q, k, v, do, dq, dk, dv, in that order (zeros
// for an output the pass does not write). The last dimension of every
// operand must be contiguous, and for the 16-bit types every row must start
// on a 16-byte boundary. lse and delta are dense f32 [b, h, n]; `ds` is the
// fused pass's workspace, dense [b, h, m, n rounded up to 64] of the
// operand dtype (NULL for the other passes).
#define FLASH_BWD_ENTRY(name, pass)                                                              \
    extern "C" int name(const void* q, const void* k, const void* v, const void* dout,         \
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,       \
                        void* ds, int dtype, int b, int h, int n, int m, int d,                  \
                        const long long* strides, float scale, int causal, void* stream) {       \
        return run(pass, q, k, v, dout, lse, delta, dq, dk, dv, ds, dtype, b, h, n, m, d,      \
                   strides, scale, causal, stream);                                              \
    }

FLASH_BWD_ENTRY(flash_bwd_fused, FUSED_PASS)
FLASH_BWD_ENTRY(flash_bwd_dq, DQ_PASS)
FLASH_BWD_ENTRY(flash_bwd_dkv, DKV_PASS)
// the long route's entries: the same kernels
FLASH_BWD_ENTRY(flash_bwd_dq_long, DQ_PASS)
FLASH_BWD_ENTRY(flash_bwd_dkv_long, DKV_PASS)

extern "C" const char* flash_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
