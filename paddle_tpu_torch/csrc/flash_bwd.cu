// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// o = softmax(q k^T * scale) v, given o's lse and delta = rowsum(do * o).
//
// Replaces the three TPU Pallas kernels of the standard path in
// paddle_tpu/ops/flash_attention.py:
// - flash_bwd_fused (_bwd_fused_kernel): dq, dk and dv from one computation
//   of s, p and dp for each (query tile, key tile) pair.
// - flash_bwd_dq (_bwd_dq_kernel): one block per (batch, head, tile of 64
//   query rows) walks the key tiles up to the diagonal, dq in f32 registers.
// - flash_bwd_dkv (_bwd_dkv_kernel): one block per (batch, head, tile of 64
//   keys) walks the query tiles from the first that sees it, dk and dv in
//   f32 registers.
// They compute the TPU kernels' function, not their blocks: a TPU core holds
// a whole 512 x 512 score tile in VMEM, a Hopper block has 227 KB of shared
// memory, so every kernel here walks 64-key tiles.
//
// Numeric contract (the TPU kernels'): products of native-dtype operands
// summed in f32, top-left causal masking, p = exp(min(s * scale - lse, 30))
// (0 where masked), ds = p * (dp - delta) * scale, and p and ds rounded to
// the operand dtype before the products they feed.
//
// The fused backward is two kernels on one stream. Blocks run in parallel
// and cannot carry dq's sum over key tiles from one to the next, so the
// first (the dk/dv kernel, one block per key tile) also stores each pair's
// ds^T, rounded to the operand dtype as the product takes it, in a
// [b, h, m, n rounded up to 64] workspace; the second sums dq = ds k per
// query tile in registers, reading ds instead of recomputing s, p and dp.
// dq is deterministic, as the TPU kernel's is: no atomics, a fixed order.
//
// What bounds it on the card. At the training shape (b=32, h=12, n=m=512,
// d=64, bf16, causal) the backward must read q, k, v, do (4 x 25.2 MB) and
// lse, delta (2 x 0.8 MB) and write dq, dk, dv (3 x 25.2 MB): 177.8 MB,
// 53 us at the H100 SXM's 3.35 TB/s. Its work is 5 products of 2 * d flops
// for each of the 131,328 visible pairs per (b, h): 32.3 GFLOP, 33 us at
// the 989 TFLOP/s bf16 peak. So the bytes bound it, by a small margin. The
// fused path's ds round trip adds 2 x 113 MB there.
//
// Two paths, as in flash_fwd.cu:
// - bf16 / fp16: 4 warps on the tensor cores (mma.sync.m16n8k16, f32
//   accumulators, ldmatrix from shared memory, cp.async double-buffered
//   tiles). In the key-tile kernel each warp owns 16 keys and computes
//   s^T = k q^T and dp^T = v do^T, so p^T and ds^T go from the accumulators
//   straight into the A fragments of dv += p^T do and dk += ds^T q.
// - f32: FMAs on the CUDA cores, 256 threads, each on a 4 x 4 (or 4 x 8)
//   register tile, operands staged in shared memory.
// wgmma, TMA and warp specialisation are later work.
//
// flash_bwd_dq_long and flash_bwd_dkv_long launch the same dq and dk/dv
// kernels. They replace the TPU kernels of _bwd_impl_long, which the JAX
// package runs for max(n, m) >= 4096: _bwd_dq_kernel_long and
// _bwd_dkv_kernel_long. The TPU needs them because its standard kernels
// stage whole sequences in VMEM; these kernels stage 64-row tiles at any
// length, so that reason does not carry over. What changes on the H100 is
// the bound: at the long training shape (b=2, h=12, n=m=8192, d=64, bf16,
// causal) the dq pass must move q, k, v, do, dq (5 x 25.2 MB) and lse,
// delta: 38 us at 3.35 TB/s, against 3 products of 2*d flops on 33.6M
// visible pairs per (b, h), 309 GFLOP, 313 us at the bf16 peak (dk/dv: 4
// products, 417 us). Operations bound both. Three choices serve that, and
// they measured faster at every length from 512 on, so every kernel here
// takes them: one ex2.approx per p (exp_e) instead of expf's eight
// instructions in the tensor-core kernels, a register cap that holds 3
// blocks on an SM at d = 64, and a one-dimensional grid that keeps the
// tiles of one (b, h) adjacent and starts the heaviest first (the last
// query tile for dq, the first key tile for dk/dv). The f32 dk/dv kernel
// alone runs a few per cent slower in that order; it keeps it, so that one
// order serves every kernel. 8 warps, 2 m-tiles a warp and other steps
// measured no faster. Every kernel here applies the
// causal / ragged mask only on the tiles that cross the diagonal or an end.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Each C entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

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
    int h, n, m;
    float scale;
    int causal;
};

// row length of the ds^T workspace: whole 64-query tiles
__host__ __device__ constexpr int ds_ld(int n) { return cdiv(n, 64) * 64; }

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int key) {
    return row < p.n && key < p.m && !(p.causal && key > row);
}

// p and ds of one score for operands of type T; both 0 where the pair is
// masked. The 16-bit kernels take exp_e, the f32 ones expf.
template <typename T>
__device__ __forceinline__ void p_ds(const BwdParams& p, bool vis, float s, float dp, float lse,
                                     float delta, float& pv, float& dsv) {
    const float x = fminf(s * p.scale - lse, 30.f);
    if constexpr (std::is_same_v<T, float>)
        pv = vis ? expf(x) : 0.f;
    else
        pv = vis ? exp_e(x) : 0.f;
    dsv = vis ? pv * (dp - delta) * p.scale : 0.f;
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
// bf16 / fp16: tensor cores (helpers and fragment layouts in mma_sm90.cuh).
//
// 4 warps; each owns 16 rows of the block's 64 (query rows in the dq kernel,
// keys in the dk/dv kernel). The dq kernel walks 64 keys a step, the dk/dv
// kernel 64 queries (32 at d = 128, which keeps the dk and dv accumulators,
// 2 x 64 floats a thread, and the score tiles in registers). The register
// cap: __launch_bounds__ holds MINB blocks on an SM, 65536 / (128 * MINB)
// registers a thread (at d = 128 the compiler's own choice).
constexpr int MMA_THREADS = 128;
constexpr int MMA_ROWS = 64;  // query rows (dq) or keys (dk/dv) per block
template <int D> __host__ __device__ constexpr int kv_bq() { return D == 64 ? 64 : 32; }
template <int D> constexpr int mma_minb() { return D == 64 ? 3 : 2; }

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

// acc[16 x 8 * NB] += A[16 x 16 * KSTEPS] @ B^T, A's rows at a and B's rows
// (the output columns) at b, both row-major with stride ld
template <typename T, int KSTEPS, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const T* a, const T* b, int ld) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
            uint32_t bf[4];
            ldmatrix_x4(bf, b + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + ks * 16 +
                                ((lane >> 3) & 1) * 8);
            MmaOp<T>::run(acc[nb], af, bf[0], bf[1]);
            MmaOp<T>::run(acc[nb + 1], af, bf[2], bf[3]);
        }
    }
}

// acc[16 x 8 * NB] += A @ B, A given as fragments (one per 16 of the
// contraction) and B row-major [16 * KC, >= 8 * NB] with stride ld
template <typename T, int KC, int NB>
__device__ __forceinline__ void mma_frag_b(float (&acc)[NB][4], const uint32_t (&af)[KC][4],
                                           const T* b, int ld) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, b + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                      nb * 8 + (lane >> 4) * 8);
            MmaOp<T>::run(acc[nb], af[kc], bf[0], bf[1]);
            MmaOp<T>::run(acc[nb + 1], af[kc], bf[2], bf[3]);
        }
    }
}

// Store 16 rows (row_a + 8 r) x 8 * NB columns of f32 accumulators as T.
template <typename T, int NB>
__device__ __forceinline__ void store_rows(T* x, long long row_stride, int row_a, int limit,
                                           const float (&acc)[NB][4]) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_a + r * 8;
        if (row >= limit) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
            *reinterpret_cast<uint32_t*>(x + (long long)row * row_stride + nb * 8 + 2 * t) =
                MmaOp<T>::pack(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

template <int D>
constexpr size_t kv_mma_smem_bytes() {
    // K and V tiles, two buffers each of q and do, two each of lse and delta
    constexpr int BQ = kv_bq<D>();
    return (size_t)(2 * MMA_ROWS + 4 * BQ) * (D + 8) * 2 + (size_t)4 * BQ * sizeof(float);
}

// dk and dv of one tile of 64 keys, walking kv_bq<D>() queries a step; with
// STORE_DS also ds^T of its visible pairs (the fused backward's first
// kernel).
template <typename T, int D, bool STORE_DS>
__global__ void __launch_bounds__(MMA_THREADS, mma_minb<D>())
    flash_bwd_kv_mma_kernel(const BwdParams p) {
    constexpr int BQ = kv_bq<D>();
    constexpr int LD = D + 8;
    constexpr int QB = BQ / 8;  // 8-query blocks of a score tile
    constexpr int DB = D / 8;   // 8-column blocks of dk and dv
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ks = reinterpret_cast<T*>(smem_raw);
    T* Vs = Ks + MMA_ROWS * LD;
    T* Qs = Vs + MMA_ROWS * LD;  // two buffers
    T* dOs = Qs + 2 * BQ * LD;   // two buffers
    float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // two buffers
    float* delta_s = lse_s + 2 * BQ;                              // two buffers

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const Tile tile = block_tile<false>(cdiv(p.m, MMA_ROWS), p.h);
    const int hi = tile.hi;
    const int bi = tile.bi;
    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    T* dk = static_cast<T*>(p.dk) + bi * p.sdk[0] + hi * p.sdk[1];
    T* dv = static_cast<T*>(p.dv) + bi * p.sdv[0] + hi * p.sdv[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    const float* lse = p.lse + row_base;
    const float* delta = p.delta + row_base;

    const int num_qt = cdiv(p.n, BQ);
    const int k0 = tile.t * MMA_ROWS;
    const int qt_begin = first_q_tile(p, k0, BQ);
    load_rows_async<T, D, MMA_ROWS, MMA_THREADS>(Ks, k, p.sk[2], k0, p.m);
    load_rows_async<T, D, MMA_ROWS, MMA_THREADS>(Vs, v, p.sv[2], k0, p.m);
    load_rows_async<T, D, BQ, MMA_THREADS>(Qs, q, p.sq[2], qt_begin * BQ, p.n);
    load_rows_async<T, D, BQ, MMA_THREADS>(dOs, dout, p.sdo[2], qt_begin * BQ, p.n);
    cp_async_commit();
    load_row_stats<BQ>(lse_s, delta_s, lse, delta, qt_begin * BQ, p.n);

    float dk_acc[DB][4], dv_acc[DB][4];
    zero(dk_acc);
    zero(dv_acc);
    const int key_a = k0 + warp * 16 + g;  // this thread's keys: key_a, key_a + 8

    for (int qt = qt_begin; qt < num_qt; ++qt) {
        const int buf = (qt - qt_begin) & 1;
        if (qt + 1 < num_qt) {  // fetch the next query tile while this one is used
            const int nq0 = (qt + 1) * BQ;
            load_rows_async<T, D, BQ, MMA_THREADS>(Qs + (buf ^ 1) * BQ * LD, q, p.sq[2], nq0,
                                                   p.n);
            load_rows_async<T, D, BQ, MMA_THREADS>(dOs + (buf ^ 1) * BQ * LD, dout, p.sdo[2],
                                                   nq0, p.n);
            cp_async_commit();
            load_row_stats<BQ>(lse_s + (buf ^ 1) * BQ, delta_s + (buf ^ 1) * BQ, lse, delta,
                               nq0, p.n);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* Qb = Qs + buf * BQ * LD;
        const T* dOb = dOs + buf * BQ * LD;
        const float* lse_b = lse_s + buf * BQ;
        const float* delta_b = delta_s + buf * BQ;
        const int q0 = qt * BQ;

        // s^T = k q^T and dp^T = v do^T: the warp's 16 keys x BQ queries
        float s[QB][4], dp[QB][4];
        zero(s);
        zero(dp);
        mma_abt<T, D / 16, QB>(s, Ks + warp * 16 * LD, Qb, LD);
        mma_abt<T, D / 16, QB>(dp, Vs + warp * 16 * LD, dOb, LD);

        // p^T and ds^T, rounded to T as the A fragments of the next products
        const bool edge = edge_pair(p, q0, BQ, k0, MMA_ROWS);
        uint32_t pf[QB / 2][4], dsf[QB / 2][4];
#pragma unroll
        for (int nb = 0; nb < QB; ++nb) {
            float pv[4], dsv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = nb * 8 + 2 * t + (e & 1);
                p_ds<T>(p, !edge || visible(p, q0 + col, key_a + (e >> 1) * 8), s[nb][e],
                        dp[nb][e], lse_b[col], delta_b[col], pv[e], dsv[e]);
            }
            pf[nb / 2][(nb & 1) * 2 + 0] = MmaOp<T>::pack(pv[0], pv[1]);
            pf[nb / 2][(nb & 1) * 2 + 1] = MmaOp<T>::pack(pv[2], pv[3]);
            dsf[nb / 2][(nb & 1) * 2 + 0] = MmaOp<T>::pack(dsv[0], dsv[1]);
            dsf[nb / 2][(nb & 1) * 2 + 1] = MmaOp<T>::pack(dsv[2], dsv[3]);
        }

        // dv += p^T do, dk += ds^T q
        mma_frag_b<T, BQ / 16, DB>(dv_acc, pf, dOb, LD);
        mma_frag_b<T, BQ / 16, DB>(dk_acc, dsf, Qb, LD);

        if (STORE_DS) {  // rows key_a (r = 0) and key_a + 8 (r = 1) of ds^T
            T* ds_t = ds_rows<T>(p, bi, hi);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int key = key_a + r * 8;
                if (key >= p.m) continue;
#pragma unroll
                for (int nb = 0; nb < QB; ++nb)
                    *reinterpret_cast<uint32_t*>(ds_t + (long long)key * ds_ld(p.n) + q0 +
                                                 nb * 8 + 2 * t) = dsf[nb / 2][(nb & 1) * 2 + r];
            }
        }
        __syncthreads();  // the next iteration's copies overwrite these buffers
    }
    store_rows<T, DB>(dk, p.sdk[2], key_a, p.m, dk_acc);
    store_rows<T, DB>(dv, p.sdv[2], key_a, p.m, dv_acc);
}

template <int D, bool FROM_DS>
constexpr size_t dq_mma_smem_bytes() {
    // two buffers each of K and of V (or of ds^T), then the q and do tiles
    return FROM_DS ? (size_t)2 * BK * ((D + 8) + (MMA_ROWS + 8)) * 2
                   : (size_t)(4 * BK + 2 * MMA_ROWS) * (D + 8) * 2;
}

// dq of one tile of 64 query rows, walking the key tiles up to the
// diagonal. FROM_DS (the fused backward's second kernel) reads ds^T from the
// workspace instead of recomputing s, p and dp.
template <typename T, int D, bool FROM_DS>
__global__ void __launch_bounds__(MMA_THREADS, mma_minb<D>())
    flash_bwd_dq_mma_kernel(const BwdParams p) {
    constexpr int BQ = MMA_ROWS;
    constexpr int LD = D + 8;
    constexpr int LDS = BQ + 8;
    constexpr int XLD = FROM_DS ? LDS : LD;  // row stride of the V / ds^T buffers
    constexpr int KB = BK / 8;  // 8-key blocks of a score tile
    constexpr int DB = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ks = reinterpret_cast<T*>(smem_raw);  // two buffers
    T* Xs = Ks + 2 * BK * LD;                // two buffers of V or of ds^T
    T* Qs = Xs + 2 * BK * XLD;               // recomputing only
    T* dOs = Qs + BQ * LD;

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const Tile tile = block_tile<true>(cdiv(p.n, BQ), p.h);
    const int q0 = tile.t * BQ;
    const int hi = tile.hi;
    const int bi = tile.bi;
    const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    T* dq = static_cast<T*>(p.dq) + bi * p.sdq[0] + hi * p.sdq[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    const T* ds_t = FROM_DS ? ds_rows<T>(p, bi, hi) + q0 : nullptr;

    // key tile kt (K, and V or this tile's ds^T columns) into buffer buf
    auto load_k_tile = [&](int kt, int buf) {
        load_rows_async<T, D, BK, MMA_THREADS>(Ks + buf * BK * LD, k, p.sk[2], kt * BK, p.m);
        if (FROM_DS)
            load_rows_async<T, BQ, BK, MMA_THREADS>(Xs + buf * BK * XLD, ds_t, ds_ld(p.n),
                                                    kt * BK, p.m);
        else
            load_rows_async<T, D, BK, MMA_THREADS>(Xs + buf * BK * XLD, v, p.sv[2], kt * BK,
                                                   p.m);
    };

    const int kt_end = last_k_tile(p, q0, BQ, BK);
    if (!FROM_DS) {
        load_rows_async<T, D, BQ, MMA_THREADS>(Qs, q, p.sq[2], q0, p.n);
        load_rows_async<T, D, BQ, MMA_THREADS>(dOs, dout, p.sdo[2], q0, p.n);
    }
    load_k_tile(0, 0);
    cp_async_commit();

    const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_a + r * 8;
        lse_r[r] = !FROM_DS && row < p.n ? p.lse[row_base + row] : 0.f;
        delta_r[r] = !FROM_DS && row < p.n ? p.delta[row_base + row] : 0.f;
    }
    float dq_acc[DB][4];
    zero(dq_acc);

    for (int kt = 0; kt < kt_end; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < kt_end) {  // fetch the next key tile while this one is used
            load_k_tile(kt + 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* Kb = Ks + buf * BK * LD;
        const T* Xb = Xs + buf * BK * XLD;
        const int k0 = kt * BK;

        // ds [the warp's 16 rows x BK keys] as A fragments
        uint32_t dsf[KB / 2][4];
        if (FROM_DS) {
#pragma unroll
            for (int kc = 0; kc < KB / 2; ++kc)
                ldmatrix_x4_trans(dsf[kc], Xb + (kc * 16 + (lane & 7) + ((lane >> 4) << 3)) * XLD +
                                               warp * 16 + ((lane >> 3) & 1) * 8);
        } else {
            // s = q k^T and dp = do v^T: the warp's 16 rows x BK keys
            float s[KB][4], dp[KB][4];
            zero(s);
            zero(dp);
            mma_abt<T, D / 16, KB>(s, Qs + warp * 16 * LD, Kb, LD);
            mma_abt<T, D / 16, KB>(dp, dOs + warp * 16 * LD, Xb, LD);
            const bool edge = edge_pair(p, q0, BQ, k0, BK);
#pragma unroll
            for (int nb = 0; nb < KB; ++nb) {
                float pv[4], dsv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    p_ds<T>(p, !edge || visible(p, row_a + r * 8, k0 + nb * 8 + 2 * t + (e & 1)),
                            s[nb][e], dp[nb][e], lse_r[r], delta_r[r], pv[e], dsv[e]);
                }
                dsf[nb / 2][(nb & 1) * 2 + 0] = MmaOp<T>::pack(dsv[0], dsv[1]);
                dsf[nb / 2][(nb & 1) * 2 + 1] = MmaOp<T>::pack(dsv[2], dsv[3]);
            }
        }
        mma_frag_b<T, BK / 16, DB>(dq_acc, dsf, Kb, LD);  // dq += ds k
        __syncthreads();  // the next iteration's copy overwrites this buffer
    }
    store_rows<T, DB>(dq, p.sdq[2], row_a, p.n, dq_acc);
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores. 256 threads as 16 x 16; thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j of every product, so the operand
// reads of a warp are broadcasts or hit consecutive banks.

constexpr int F32_THREADS = 256;
constexpr int F32_BQ = 64;  // query rows per tile
constexpr int LDP = F32_BQ + 1;

// acc[i][j] += sum_kk A[(ty + 16 i) * a_r + kk * a_k] * B[kk * b_k + (tx + 16 j) * b_c]
template <int NJ>
__device__ __forceinline__ void f32_mm(float (*acc)[NJ], const float* A, int a_r, int a_k,
                                       const float* B, int b_k, int b_c, int depth) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
        float a[4], b[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * a_r + kk * a_k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = B[kk * b_k + (tx + 16 * j) * b_c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

// rows row0.. of x into dst[r * (D + 1) + c]; rows at or past `limit` are 0
template <int D>
__device__ __forceinline__ void f32_load_rows(float* dst, const float* x, long long row_stride,
                                              int row0, int limit) {
    for (int idx = threadIdx.x; idx < 64 * D; idx += F32_THREADS) {
        const int r = idx / D;
        const int c = idx % D;
        const int row = row0 + r;
        dst[r * (D + 1) + c] = row < limit ? x[(long long)row * row_stride + c] : 0.f;
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
// tx + 16 j.
template <int NJ>
__device__ __forceinline__ void f32_store_rows(float* x, long long row_stride, int row0,
                                               int limit, const float (*acc)[NJ]) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty + 16 * i;
        if (row >= limit) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) x[(long long)row * row_stride + tx + 16 * j] = acc[i][j];
    }
}

template <int D>
constexpr size_t kv_f32_smem_bytes() {
    // K, V, q, do tiles; p^T and ds^T; lse and delta
    return ((size_t)4 * 64 * (D + 1) + (size_t)2 * BK * LDP + 2 * F32_BQ) * sizeof(float);
}

template <int D, bool STORE_DS>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_kv_f32_kernel(const BwdParams p) {
    constexpr int LDF = D + 1;
    constexpr int NJ = D / 16;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;
    float* Vs = Ks + 64 * LDF;
    float* Qs = Vs + 64 * LDF;
    float* dOs = Qs + 64 * LDF;
    float* Pt = dOs + 64 * LDF;
    float* dSt = Pt + BK * LDP;
    float* lse_s = dSt + BK * LDP;
    float* delta_s = lse_s + F32_BQ;

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<false>(cdiv(p.m, BK), p.h);
    const int hi = tile.hi;
    const int bi = tile.bi;
    const float* q = static_cast<const float*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const float* k = static_cast<const float*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const float* v = static_cast<const float*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const float* dout = static_cast<const float*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    float* dk = static_cast<float*>(p.dk) + bi * p.sdk[0] + hi * p.sdk[1];
    float* dv = static_cast<float*>(p.dv) + bi * p.sdv[0] + hi * p.sdv[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    float* ds_t = STORE_DS ? ds_rows<float>(p, bi, hi) : nullptr;

    const int k0 = tile.t * BK;
    f32_load_rows<D>(Ks, k, p.sk[2], k0, p.m);
    f32_load_rows<D>(Vs, v, p.sv[2], k0, p.m);
    float dk_acc[4][NJ], dv_acc[4][NJ];
    f32_zero<NJ>(dk_acc);
    f32_zero<NJ>(dv_acc);
    for (int qt = first_q_tile(p, k0, F32_BQ); qt < cdiv(p.n, F32_BQ); ++qt) {
        const int q0 = qt * F32_BQ;
        f32_load_rows<D>(Qs, q, p.sq[2], q0, p.n);
        f32_load_rows<D>(dOs, dout, p.sdo[2], q0, p.n);
        load_row_stats<F32_BQ>(lse_s, delta_s, p.lse + row_base, p.delta + row_base, q0, p.n);
        __syncthreads();

        // s^T[key][query] = k q^T and dp^T = v do^T
        float s[4][4], dp[4][4];
        f32_zero<4>(s);
        f32_zero<4>(dp);
        f32_mm<4>(s, Ks, LDF, 1, Qs, 1, LDF, D);
        f32_mm<4>(dp, Vs, LDF, 1, dOs, 1, LDF, D);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = ty + 16 * i;
                const int col = tx + 16 * j;
                float pv, dsv;
                p_ds<float>(p, visible(p, q0 + col, k0 + key), s[i][j], dp[i][j], lse_s[col],
                     delta_s[col], pv, dsv);
                Pt[key * LDP + col] = pv;
                dSt[key * LDP + col] = dsv;
                if (STORE_DS && k0 + key < p.m)
                    ds_t[(long long)(k0 + key) * ds_ld(p.n) + q0 + col] = dsv;
            }
        __syncthreads();
        f32_mm<NJ>(dv_acc, Pt, LDP, 1, dOs, LDF, 1, F32_BQ);  // dv += p^T do
        f32_mm<NJ>(dk_acc, dSt, LDP, 1, Qs, LDF, 1, F32_BQ);  // dk += ds^T q
        __syncthreads();  // the next tile overwrites q, do, p^T and ds^T
    }
    f32_store_rows<NJ>(dk, p.sdk[2], k0, p.m, dk_acc);
    f32_store_rows<NJ>(dv, p.sdv[2], k0, p.m, dv_acc);
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
    // q, do, K, V tiles; ds; lse and delta
    return ((size_t)4 * 64 * (D + 1) + (size_t)F32_BQ * LDP + 2 * F32_BQ) * sizeof(float);
}

// dq of one tile of 64 query rows; FROM_DS reads ds^T from the workspace
// instead of recomputing it.
template <int D, bool FROM_DS>
__global__ void __launch_bounds__(F32_THREADS) flash_bwd_dq_f32_kernel(const BwdParams p) {
    constexpr int LDF = D + 1;
    constexpr int NJ = D / 16;
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* dOs = Qs + 64 * LDF;
    float* Ks = dOs + 64 * LDF;
    float* Vs = Ks + 64 * LDF;
    float* dSs = Vs + 64 * LDF;
    float* lse_s = dSs + F32_BQ * LDP;
    float* delta_s = lse_s + F32_BQ;

    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const Tile tile = block_tile<true>(cdiv(p.n, F32_BQ), p.h);
    const int q0 = tile.t * F32_BQ;
    const int hi = tile.hi;
    const int bi = tile.bi;
    const float* q = static_cast<const float*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
    const float* k = static_cast<const float*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
    const float* v = static_cast<const float*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
    const float* dout = static_cast<const float*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
    float* dq = static_cast<float*>(p.dq) + bi * p.sdq[0] + hi * p.sdq[1];
    const long long row_base = ((long long)bi * p.h + hi) * p.n;
    const float* ds_t = FROM_DS ? ds_rows<float>(p, bi, hi) : nullptr;

    if (!FROM_DS) {
        f32_load_rows<D>(Qs, q, p.sq[2], q0, p.n);
        f32_load_rows<D>(dOs, dout, p.sdo[2], q0, p.n);
        load_row_stats<F32_BQ>(lse_s, delta_s, p.lse + row_base, p.delta + row_base, q0, p.n);
    }
    float dq_acc[4][NJ];
    f32_zero<NJ>(dq_acc);
    const int kt_end = last_k_tile(p, q0, F32_BQ, BK);
    for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        f32_load_rows<D>(Ks, k, p.sk[2], k0, p.m);
        if (FROM_DS) {
            // ds[query r][key c] from ds^T; consecutive threads read
            // consecutive queries of one key row
            for (int idx = threadIdx.x; idx < BK * F32_BQ; idx += F32_THREADS) {
                const int c = idx / F32_BQ;
                const int r = idx % F32_BQ;
                dSs[r * LDP + c] =
                    k0 + c < p.m ? ds_t[(long long)(k0 + c) * ds_ld(p.n) + q0 + r] : 0.f;
            }
            __syncthreads();
        } else {
            f32_load_rows<D>(Vs, v, p.sv[2], k0, p.m);
            __syncthreads();
            // s[query][key] = q k^T and dp = do v^T
            float s[4][4], dp[4][4];
            f32_zero<4>(s);
            f32_zero<4>(dp);
            f32_mm<4>(s, Qs, LDF, 1, Ks, 1, LDF, D);
            f32_mm<4>(dp, dOs, LDF, 1, Vs, 1, LDF, D);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int r = ty + 16 * i;
                    const int c = tx + 16 * j;
                    float pv;
                    p_ds<float>(p, visible(p, q0 + r, k0 + c), s[i][j], dp[i][j], lse_s[r],
                         delta_s[r], pv, dSs[r * LDP + c]);
                }
            __syncthreads();
        }
        f32_mm<NJ>(dq_acc, dSs, LDP, 1, Ks, LDF, 1, BK);  // dq += ds k
        __syncthreads();  // the next tile overwrites K, V and ds
    }
    f32_store_rows<NJ>(dq, p.sdq[2], q0, p.n, dq_acc);
}

// ---------------------------------------------------------------------------

enum Pass { FUSED_PASS, DQ_PASS, DKV_PASS };

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const BwdParams& p,
                   cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const BwdParams& p, Pass pass, int b, cudaStream_t s) {
    const dim3 kv_grid = tile_grid(cdiv(p.m, MMA_ROWS), p.h, b);
    const dim3 q_grid = tile_grid(cdiv(p.n, MMA_ROWS), p.h, b);
    if (pass == DKV_PASS)
        return launch(flash_bwd_kv_mma_kernel<T, D, false>, kv_grid, MMA_THREADS,
                      kv_mma_smem_bytes<D>(), p, s);
    if (pass == DQ_PASS)
        return launch(flash_bwd_dq_mma_kernel<T, D, false>, q_grid, MMA_THREADS,
                      dq_mma_smem_bytes<D, false>(), p, s);
    cudaError_t err = launch(flash_bwd_kv_mma_kernel<T, D, true>, kv_grid, MMA_THREADS,
                             kv_mma_smem_bytes<D>(), p, s);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_mma_kernel<T, D, true>, q_grid, MMA_THREADS,
                  dq_mma_smem_bytes<D, true>(), p, s);
}

template <int D>
cudaError_t launch_f32(const BwdParams& p, Pass pass, int b, cudaStream_t s) {
    const dim3 kv_grid = tile_grid(cdiv(p.m, BK), p.h, b);
    const dim3 q_grid = tile_grid(cdiv(p.n, F32_BQ), p.h, b);
    if (pass == DKV_PASS)
        return launch(flash_bwd_kv_f32_kernel<D, false>, kv_grid, F32_THREADS,
                      kv_f32_smem_bytes<D>(), p, s);
    if (pass == DQ_PASS)
        return launch(flash_bwd_dq_f32_kernel<D, false>, q_grid, F32_THREADS,
                      dq_f32_smem_bytes<D>(), p, s);
    cudaError_t err = launch(flash_bwd_kv_f32_kernel<D, true>, kv_grid, F32_THREADS,
                             kv_f32_smem_bytes<D>(), p, s);
    if (err != cudaSuccess) return err;
    return launch(flash_bwd_dq_f32_kernel<D, true>, q_grid, F32_THREADS,
                  dq_f32_smem_bytes<D>(), p, s);
}

template <int D>
cudaError_t launch_d(const BwdParams& p, Pass pass, int dtype, int b, cudaStream_t s) {
    switch (dtype) {
        case 0:
            return launch_f32<D>(p, pass, b, s);
        case 1:
            return launch_mma<__nv_bfloat16, D>(p, pass, b, s);
        case 2:
            return launch_mma<__half, D>(p, pass, b, s);
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
    p.h = h;
    p.n = n;
    p.m = m;
    p.scale = scale;
    p.causal = causal;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 64) return (int)launch_d<64>(p, pass, dtype, b, s);
    if (d == 128) return (int)launch_d<128>(p, pass, dtype, b, s);
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
