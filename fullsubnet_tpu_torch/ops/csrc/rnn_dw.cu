// The weight-gradient stage of one LSTM or GRU layer's backward (K3 for the
// LSTM, K4 for the GRU) for Hopper (sm_90a): a split-K GEMM over the T*N
// rows of the layer's cotangent streams, at bf16 storage on the tensor cores
// and at fp32 storage on the fp32 cores.
//
// Replaces the weight-gradient products that the TPU kernels
// fullsubnet_tpu/ops/subband_lstm.py:_lstm_layer_bwd_kernel and
// _gru_layer_bwd_kernel compute in their own body, in the fused-dW form
// that _pallas_layer_bwd (the pl.pallas_call at :844) picks for every bf16
// sub-band layer at the flagship widths: per row tile,
// dwih += [x | 1]^T . dgates and dwhh += [h_prev | 1]^T . dgates, bf16 x
// bf16 -> fp32 (LSTM :609-626; GRU :710-727, with dxw and dhw), in revisited
// fp32 output blocks, one per row tile, summed afterwards (:896-901). Here
// the same sums run as a stage of their own after the layer's walk, from
// the cotangent streams the walk wrote (rnn_bwd_tc.cu at bf16,
// rnn_bwd_f32.cu at fp32), as stored: no upcast, no copy.
//
// What it computes. C [M, Ncols] fp32 = sum over k < K of A[k]^T . B[k],
// K = T*N rows, A[k] = [seg0[k] | seg1[k] | 1] (M = cols0 + cols1 + 1: the
// last column is ones, so the last row of C, row Mw = cols0 + cols1, is the
// bias gradient), B[k] a row of the cotangent stream. A segment is read in
// place: row k of a
// segment with shift S is head[k] for k < S, else seg[k - S], so h_prev is
// the h stash one block of N rows back with h0 for the first block, the row
// offset rnn_bwd_tc.cu's GEMM reads.
//   LSTM: one problem, A = [x | h_prev | 1], B = dgates [K, 4H]: C holds
//   dW_ih^T, dW_hh^T and db.
//   GRU: two problems, [x | 1]^T . dxw and [h_prev | 1]^T . dhw (B [K, 3H]
//   each): the two bias gradients stay apart.
//
// What bounds it on this card. At the flagship sub-band stage (K = 798,720,
// H = 384) the LSTM's two layers come to 2.90 TFLOP and read 6.8 GB of
// operands: 2.9 ms at the bf16 tensor-core peak (989 TFLOP/s), 2.0 ms of
// HBM at 3.35 TB/s; at fp32 43.3 ms at the fp32 cores' 67 TFLOP/s. Both
// instances are bound by operations. The output is small (at most 1025 x
// 2048, the full-band LSTM's layer 2) and K is long, so the tiles of C
// alone would give the card a fraction of a wave.
//
// What the design does about it. Split-K: the grid is (tiles of C's first
// Mw rows, S slices of K), S from the shape and the SM count
// (ops/subband_lstm.py, pick_dw_splits), slices of whole 32-row tiles. Each
// CTA sums its slice into a 128 x 128 fp32 tile of C in registers and
// writes it to a workspace [S, M, Ncols]; a second kernel sums each
// element's S partials in slice order. No atomics: the result is the same
// from run to run. The ones column is not loaded: at Mw = 768, 384 or 1024
// it would cost a whole tile row of CTAs (a seventh to a quarter of the
// work); the CTAs of the first tile row sum B's columns instead, from the
// B tiles already in shared memory, into row Mw of their partial.
//   bf16: 8 warps of 64 x 32 outputs; mma.sync m16n8k16 (bf16 in, fp32
//   accumulators) from a 4-stage cp.async ring of 32-row tiles of A and B.
//   Both operands are K-major in memory (rows of the streams), so both reach
//   the mma through ldmatrix.trans, from tiles whose 16-byte chunks are
//   XOR-swizzled by the row.
//   fp32: the same grid and ring of 16-row tiles; each thread sums an 8 x 8
//   block of C from outer products of A's and B's k-rows (FFMA, no TF32).
//   A 16-byte chunk that lies in one segment with aligned rows is copied by
//   cp.async; a chunk across the two segments, and every chunk of a segment
//   whose offset or row stride breaks 16-byte alignment (the full-band x,
//   F = 257, moves the h_prev segment off it), is gathered element by
//   element.
//
// Layouts. seg0/head0 and seg1/head1: rows of ld0 / ld1 elements; b [K,
// Ncols] with row stride ldb; work [S, M, Ncols] fp32 (unused for S = 1);
// out [M, Ncols] fp32. A and B both bf16 or both fp32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC

#include <algorithm>

#include "mma_common.cuh"

namespace {

using namespace fsn;

constexpr int kBM = 128;        // rows of C (columns of A) a CTA
constexpr int kBN = 128;        // columns of C a CTA
constexpr int kSliceGrain = 32;  // a slice of K is whole tiles of this many rows
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kChunksPerThread = 2;  // 16-byte chunks of one A (or B) tile a thread
// one ring slot is an A tile and a B tile of 128 columns by 32 bf16 rows or
// 16 fp32 rows: 8 KB each either way
constexpr int kTileBytes = 8192;
constexpr size_t kSmem = (size_t)kStages * 2 * kTileBytes;

// one segment of A's columns: row k at p + (k - shift) * ld, rows k < shift
// at head + k * ld; cols columns; vec: its rows are copied 16 bytes at a time
struct Seg {
    const void* p;
    const void* head;
    int ld, cols, shift, vec;
};

struct DwArgs {
    Seg s0, s1;      // A = [s0 | s1 | 1]
    const void* b;   // [K, Ncols], row stride ldb
    int ldb, vec_b;
    float* c;        // [S, M, Ncols] partials, or the output when S = 1
    int Mw;          // rows of C from A's segments (cols0 + cols1); row Mw is the bias row
    int Ncols, K, slice_rows;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
    return v;
}

template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
    return __float2bfloat16(v);
}

// row k of segment 1 (one) or 0, from its head block for k < shift
template <typename T>
__device__ __forceinline__ const T* seg_row(const DwArgs& g, bool one, int k) {
    const int shift = one ? g.s1.shift : g.s0.shift;
    const void* base = k >= shift ? (one ? g.s1.p : g.s0.p) : (one ? g.s1.head : g.s0.head);
    return static_cast<const T*>(base) +
           (size_t)(k >= shift ? k - shift : k) * (one ? g.s1.ld : g.s0.ld);
}

// A[k][m] for k < K, m < Mw
template <typename T>
__device__ __forceinline__ T a_elem(const DwArgs& g, int k, int m) {
    return m < g.s0.cols ? seg_row<T>(g, false, k)[m] : seg_row<T>(g, true, k)[m - g.s0.cols];
}

// element offset of 16-byte chunk c of row k in a 128-column tile: bf16 rows
// hold 16 chunks, XOR-swizzled by the row so that the 8 rows one
// ldmatrix.trans phase reads fall in 8 different bank groups; fp32 rows hold
// 32 chunks, read along the row
template <typename T>
__device__ __forceinline__ int tile_off(int k, int c);

template <>
__device__ __forceinline__ int tile_off<bf16>(int k, int c) {
    return k * kBM + ((c ^ (k & 7)) << 3);
}

template <>
__device__ __forceinline__ int tile_off<float>(int k, int c) {
    return k * kBM + (c << 2);
}

// one k-tile of A and B (rows [k0, k0 + BK), zeros from k_end on and past
// Mw and Ncols) into shared memory. The segments are picked by selects, not
// by an index into DwArgs: an indexed kernel parameter goes to local memory.
template <typename T>
__device__ __forceinline__ void load_tile(const DwArgs& g, T* sa, T* sb, int m0, int n0, int k0,
                                          int k_end) {
    constexpr int E = 16 / (int)sizeof(T);  // elements of a chunk
    constexpr int CH = kBM / E;             // chunks of a tile row
#pragma unroll
    for (int i = 0; i < kChunksPerThread; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int kk = idx / CH;
        const int c = idx % CH;
        const int k = k0 + kk;
        const bool k_ok = k < k_end;
        {
            const int m = m0 + c * E;
            T* dst = sa + tile_off<T>(kk, c);
            const bool one = m >= g.s0.cols;  // in segment 1
            const int ms = one ? m - g.s0.cols : m;
            const bool vec = one ? g.s1.vec && ms + E <= g.s1.cols
                                 : g.s0.vec && ms + E <= g.s0.cols;
            if (!k_ok || m >= g.Mw) {
                cp_async_16(smem_addr(dst), g.b, false);
            } else if (vec) {
                cp_async_16(smem_addr(dst), seg_row<T>(g, one, k) + ms, true);
            } else {
                alignas(16) T v[E];
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    v[e] = m + e < g.Mw ? a_elem<T>(g, k, m + e) : from_float<T>(0.0f);
                }
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
            }
        }
        {
            const int n = n0 + c * E;
            T* dst = sb + tile_off<T>(kk, c);
            const T* row = static_cast<const T*>(g.b) + (size_t)k * g.ldb;
            if (!k_ok || n >= g.Ncols) {
                cp_async_16(smem_addr(dst), g.b, false);
            } else if (g.vec_b && n + E <= g.Ncols) {
                cp_async_16(smem_addr(dst), row + n, true);
            } else {
                alignas(16) T v[E];
#pragma unroll
                for (int e = 0; e < E; ++e) v[e] = n + e < g.Ncols ? row[n + e] : from_float<T>(0.0f);
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
            }
        }
    }
}

// the CTA's slice of K: rows [k_begin, k_end) and its count of BK-row tiles
struct Slice {
    int m0, n0, k_begin, k_end, k_tiles;
};

template <int BK>
__device__ __forceinline__ Slice cta_slice(const DwArgs& g) {
    const int tiles_n = (g.Ncols + kBN - 1) / kBN;
    Slice s;
    s.m0 = (int)(blockIdx.x / tiles_n) * kBM;
    s.n0 = (int)(blockIdx.x % tiles_n) * kBN;
    s.k_begin = (int)blockIdx.y * g.slice_rows;
    s.k_end = min(g.K, s.k_begin + g.slice_rows);
    s.k_tiles = (s.k_end - s.k_begin + BK - 1) / BK;
    return s;
}

// The bias row, the column sums of B, in the CTAs of the first tile of
// rows (m0 = 0), from the B tiles already in shared memory: thread t sums
// the column pair (2 (t % 64), +1) over a quarter of each tile's rows.
// CTA-uniform: every thread of the CTA runs it or none.
struct BiasSum {
    float s0 = 0.0f, s1 = 0.0f;
};

__device__ __forceinline__ float2 smem_pair(const bf16* p) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float2 smem_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}

template <typename T, int BK>
__device__ __forceinline__ void bias_add(BiasSum& b, const T* tb) {
    constexpr int E = 16 / (int)sizeof(T);
    const int col = (threadIdx.x & 63) * 2;
    const int row0 = (threadIdx.x >> 6) * (BK / 4);
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) {
        const int kk = row0 + r;
        const float2 v = smem_pair(tb + tile_off<T>(kk, col / E) + col % E);
        b.s0 += v.x;
        b.s1 += v.y;
    }
}

// the four quarters summed in order, into row Mw of this slice's partial;
// the ring is free (every thread has passed its last wait)
__device__ __forceinline__ void bias_store(const BiasSum& b, const DwArgs& g, float* out,
                                           unsigned char* smem, int n0) {
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);  // [4][kBN]
    const int col = (threadIdx.x & 63) * 2;
    red[(threadIdx.x >> 6) * kBN + col] = b.s0;
    red[(threadIdx.x >> 6) * kBN + col + 1] = b.s1;
    __syncthreads();
    const int n = n0 + (int)threadIdx.x;
    if (threadIdx.x < kBN && n < g.Ncols) {
        float s = red[threadIdx.x];
#pragma unroll
        for (int q = 1; q < 4; ++q) s += red[q * kBN + threadIdx.x];
        out[(size_t)g.Mw * g.Ncols + n] = s;
    }
}

__device__ __forceinline__ void store2(float* row, int n, int ncols, float v0, float v1) {
    if (n >= ncols) return;
    if (n + 1 < ncols && (reinterpret_cast<uintptr_t>(row + n) & 7) == 0) {
        *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
    } else {
        row[n] = v0;
        if (n + 1 < ncols) row[n + 1] = v1;
    }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) dw_bf16_kernel(DwArgs g) {
    constexpr int BK = 32;
    constexpr int kTile = BK * kBM;
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    bf16* sa = reinterpret_cast<bf16*>(fsn_smem);  // [stages][BK x BM]
    bf16* sb = sa + kStages * kTile;               // [stages][BK x BN]
    const Slice sl = cta_slice<BK>(g);
    const bool bias_cta = sl.m0 == 0;
    BiasSum bias;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2;  // 2 x 4 warps, each 64 x 32 of C
    const int wn = warp & 3;

    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < sl.k_tiles) {
            load_tile<bf16>(g, sa + s * kTile, sb + s * kTile, sl.m0, sl.n0, sl.k_begin + s * BK,
                            sl.k_end);
        }
        cp_async_commit();
    }
    for (int kt = 0; kt < sl.k_tiles; ++kt) {
        // tile kt has landed for every thread, and every warp is done with
        // tile kt - 1, whose slot the next load takes
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int next = kt + kStages - 1;
        if (next < sl.k_tiles) {
            const int s = next % kStages;
            load_tile<bf16>(g, sa + s * kTile, sb + s * kTile, sl.m0, sl.n0,
                            sl.k_begin + next * BK, sl.k_end);
        }
        cp_async_commit();
        const bf16* ta = sa + (kt % kStages) * kTile;
        const bf16* tb = sb + (kt % kStages) * kTile;
        if (bias_cta) bias_add<bf16, BK>(bias, tb);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            // A is stored [k][m]: matrix j of the x4 load is rows k
            // (j >> 1) * 8 .. + 7 of the 16, columns m (j & 1) * 8 .. + 7,
            // so that .trans gives the row-major fragments a0..a3
            uint32_t af[4][4];
            const int mat = lane >> 3;
            const int ka = ks * 16 + (mat >> 1) * 8 + (lane & 7);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const int c = (wm * 64 + mt * 16 + (mat & 1) * 8) >> 3;
                ldsm_x4_trans(smem_addr(ta + tile_off<bf16>(ka, c)), af[mt]);
            }
            uint32_t bfr[4][2];
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                const int kb = ks * 16 + (lane & 15);
                const int c = wn * 4 + np * 2 + (lane >> 4);
                uint32_t r[4];
                ldsm_x4_trans(smem_addr(tb + tile_off<bf16>(kb, c)), r);
                bfr[2 * np][0] = r[0];
                bfr[2 * np][1] = r[1];
                bfr[2 * np + 1][0] = r[2];
                bfr[2 * np + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
        }
    }
    cp_async_wait<0>();

    float* out = g.c + (size_t)blockIdx.y * (g.Mw + 1) * g.Ncols;
    if (bias_cta) bias_store(bias, g, out, fsn_smem, sl.n0);
    const int gq = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int m = sl.m0 + wm * 64 + mt * 16 + gq + half * 8;
            if (m >= g.Mw) continue;
            float* row = out + (size_t)m * g.Ncols;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                store2(row, sl.n0 + wn * 32 + nt * 8 + 2 * q, g.Ncols, acc[mt][nt][2 * half],
                       acc[mt][nt][2 * half + 1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// fp32: outer products on the fp32 cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) dw_f32_kernel(DwArgs g) {
    constexpr int BK = 16;
    constexpr int kTile = BK * kBM;
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    float* sa = reinterpret_cast<float*>(fsn_smem);  // [stages][BK x BM]
    float* sb = sa + kStages * kTile;                // [stages][BK x BN]
    const Slice sl = cta_slice<BK>(g);
    const bool bias_cta = sl.m0 == 0;
    BiasSum bias;
    // thread (tm, tn) sums rows {tm*4 .. +3, 64 + tm*4 .. +3} by the same
    // columns of tn of the CTA's tile
    const int tm = threadIdx.x >> 4;
    const int tn = threadIdx.x & 15;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < sl.k_tiles) {
            load_tile<float>(g, sa + s * kTile, sb + s * kTile, sl.m0, sl.n0,
                             sl.k_begin + s * BK, sl.k_end);
        }
        cp_async_commit();
    }
    for (int kt = 0; kt < sl.k_tiles; ++kt) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int next = kt + kStages - 1;
        if (next < sl.k_tiles) {
            const int s = next % kStages;
            load_tile<float>(g, sa + s * kTile, sb + s * kTile, sl.m0, sl.n0,
                             sl.k_begin + next * BK, sl.k_end);
        }
        cp_async_commit();
        const float* ta = sa + (kt % kStages) * kTile;
        const float* tb = sb + (kt % kStages) * kTile;
        if (bias_cta) bias_add<float, BK>(bias, tb);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(ta + kk * kBM + tm * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(ta + kk * kBM + 64 + tm * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(tb + kk * kBN + tn * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(tb + kk * kBN + 64 + tn * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();

    float* out = g.c + (size_t)blockIdx.y * (g.Mw + 1) * g.Ncols;
    if (bias_cta) bias_store(bias, g, out, fsn_smem, sl.n0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = sl.m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
        if (m >= g.Mw) continue;
        float* row = out + (size_t)m * g.Ncols;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            const int n = sl.n0 + (j < 4 ? tn * 4 + j : 64 + tn * 4 + j - 4);
            store2(row, n, g.Ncols, acc[i][j], acc[i][j + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// the ordered sum of the partials
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) dw_reduce_kernel(const float* __restrict__ work,
                                                             float* __restrict__ out,
                                                             long long mn, int splits) {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < mn;
         i += (long long)gridDim.x * kThreads) {
        float s = work[i];
        for (int z = 1; z < splits; ++z) s += work[(size_t)z * mn + i];
        out[i] = s;
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kernel>
cudaError_t launch_gemm(Kernel kernel, const DwArgs& g, int splits, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    const int tiles = ((g.Mw + kBM - 1) / kBM) * ((g.Ncols + kBN - 1) / kBN);
    kernel<<<dim3((unsigned)tiles, (unsigned)splits), kThreads, kSmem, stream>>>(g);
    return cudaGetLastError();
}

}  // namespace

// C = [A0 | A1 | 1]^T . B over K rows, as the header says. bf16_in: A and B
// bf16 (else fp32). Segment 1 may be empty (cols1 = 0). slice_rows a
// multiple of 32; S = ceil(K / slice_rows) slices, each summed into
// work[s] (S > 1) and then into out in slice order, or into out directly
// (S = 1). Returns a cudaError_t.
extern "C" int fsn_dw_gemm(int bf16_in, const void* seg0, const void* head0, int ld0, int cols0,
                           int shift0, const void* seg1, const void* head1, int ld1, int cols1,
                           int shift1, const void* b, int ldb, int ncols, int K, int slice_rows,
                           float* work, float* out, void* stream) {
    if (K < 1 || ncols < 1 || cols0 < 1 || cols1 < 0 || shift0 < 0 || shift1 < 0 ||
        ld0 < cols0 || ld1 < cols1 || ldb < ncols || slice_rows < kSliceGrain ||
        slice_rows % kSliceGrain != 0 || seg0 == nullptr || b == nullptr || out == nullptr ||
        (shift0 > 0 && head0 == nullptr) ||
        (cols1 > 0 && (seg1 == nullptr || (shift1 > 0 && head1 == nullptr)))) {
        return (int)cudaErrorInvalidValue;
    }
    const long long splits = ((long long)K + slice_rows - 1) / slice_rows;
    if (splits > 65535 || (splits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
    const int e = bf16_in ? 8 : 4;  // elements of a 16-byte chunk
    DwArgs g;
    g.s0 = {seg0, head0, ld0, cols0, shift0,
            ld0 % e == 0 && aligned16(seg0) && (shift0 == 0 || aligned16(head0))};
    g.s1 = {seg1, head1, ld1, cols1, shift1,
            cols1 > 0 && cols0 % e == 0 && ld1 % e == 0 && aligned16(seg1) &&
                (shift1 == 0 || aligned16(head1))};
    g.b = b;
    g.ldb = ldb;
    g.vec_b = ldb % e == 0 && aligned16(b);
    g.Mw = cols0 + cols1;
    g.Ncols = ncols;
    g.K = K;
    g.slice_rows = slice_rows;
    g.c = splits > 1 ? work : out;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = bf16_in ? launch_gemm(dw_bf16_kernel, g, (int)splits, s)
                              : launch_gemm(dw_f32_kernel, g, (int)splits, s);
    if (err != cudaSuccess || splits == 1) return (int)err;
    const long long mn = (long long)(g.Mw + 1) * ncols;
    const long long blocks = std::min<long long>((mn + kThreads - 1) / kThreads, 132LL * 8);
    dw_reduce_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(work, out, mn, (int)splits);
    return (int)cudaGetLastError();
}

extern "C" const char* fsn_dw_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
