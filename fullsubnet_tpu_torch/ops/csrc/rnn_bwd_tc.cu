// One LSTM or GRU layer's backward on Hopper's tensor cores, bf16 storage
// (K3 for the LSTM, K4 for the GRU), for sm_90a.
//
// Replaces the TPU kernels fullsubnet_tpu/ops/subband_lstm.py:
// _lstm_layer_bwd_kernel and _gru_layer_bwd_kernel, as launched by
// _pallas_layer_bwd (the pl.pallas_call of the per-layer backward), in
// their split-dW form, at bf16 storage; fp32 storage runs the same three
// stages on the fp32 cores (fsn_fwd_gemm in rnn_fwd.cu, the walk in
// rnn_bwd_f32.cu). The outputs are theirs: dx and
// dgates (LSTM) or dx, dxw and dhw (GRU) in bf16, and the fp32 carries
// into the initial state. Initial states and incoming carries are
// arguments, so a time-chunked backward can chain calls.
//
// What bounds it on this card. Per step and row the TPU kernel does three
// products against the layer's weights: the gate recompute
// [x_t | h_{t-1}] . W (the forward stashed h and c, not the gates), the dx
// part of dgates . W^T, and its h part, the next dh carry. Only the last
// one is on the reverse-time chain: the recompute reads x and the stashes
// alone, and dx needs only dgates. At the flagship sub-band shape
// (N = 4096, T = 195, H = 384) the three come to 5.8 TFLOP for the two
// layers: 5.9 ms at the bf16 tensor-core peak, about 87 ms on the fp32
// cores the earlier kernels use. The chained product is a third of it,
// but its weights W_hh^T (1.18 MB in bf16; 2 MB at the full-band shape)
// do not fit in one SM's 227 KB, so every block streams them from L2 at
// every step: 128 blocks x 390 steps x 1.18 MB = 59 GB of L2 reads for
// the two layers.
//
// What the design does about it: three stages per layer.
//   1. fsn_tc_gemm: P = x . W_ih^T + h_prev . W_hh^T + b over all T*N
//      rows at once, bf16 operands on the tensor cores (mma.sync m16n8k16,
//      fp32 accumulators, fed by a 4-stage cp.async ring), fp32 out (the
//      TPU kernel keeps the gates in f32). A takes two K segments, x and
//      h_prev; h_prev is the h stash read one step back, with h0 for the
//      first step: a row offset, not a copy. The GRU's weights come packed
//      as [[W_ir W_iz W_in 0], [W_hr W_hz 0 W_hn]] with bias
//      [b_ir+b_hr, b_iz+b_hz, b_in, b_hn], so one product gives the four
//      sums r, z, n_x and hn = W_hn h + b_hn that the reset gate needs
//      apart.
//   2. The walk over t = T-1 .. 0. Per step it does the cell backward of
//      _lstm_layer_bwd_kernel (or _gru_layer_bwd_kernel) from P[t], the
//      stashes and dh[t]; rounds dgates (dxw, dhw) to bf16 where the TPU
//      kernel casts them; writes them to their streams and to shared
//      memory; and takes the one chained product, the next dh carry
//      dgates . W_hh^T (GRU: dh_tot z + dhw . W_hh^T), on the tensor
//      cores. Rows never interact. Two kernels, picked by the wrapper from
//      the shape:
//      fsn_rnn_bwd_walk, for many rows: one block of 512 threads per tile
//      of 16, 32 or 64 rows. W_hh^T streams through a ring of 32-row
//      chunks in shared memory (cp.async, 2 to 4 stages); the ring runs on
//      across steps, so the next step's first chunks load during the cell
//      backward. A thread does the cell backward for exactly the (row,
//      unit) pairs its mma accumulators hold, so the dh carry never
//      leaves registers, and the dc carry stays beside it. P, dh and the
//      stash of step t-1 are prefetched into L2 while step t multiplies.
//      fsn_rnn_bwd_walk_split, for few rows (the full-band stage, where the
//      streaming walk has one or two blocks, each waiting on L2 for all of
//      W_hh^T at every step): a cluster of 16 CTAs walks 32 rows, each CTA
//      holding the W_hh^T rows of its 16th of the units' gates (128 KB at
//      H = 512) for the whole walk. Each CTA multiplies its units' dgates
//      by its rows, and the partial carries are reduce-scattered through
//      distributed shared memory.
//   3. fsn_tc_gemm again: dx = dgates . W_ih (GRU: dxw . W_ih) over all
//      T*N rows, fp32 accumulators, stored in bf16.
//
// Layouts (all contiguous unless a leading dimension is given).
//   GEMM: A [M, k_split] (lda) then [M, K - k_split] read from a_prev one
//   `shift` rows back (ldp), rows m < shift from a_head; B [K, Ncols]
//   (ldb); bias [Ncols] fp32 or null; C [M, Ncols], fp32 or bf16.
//   Walk: p [T, N, 4H] fp32; dh [T, N, H]; stash [T, N, H] (LSTM: the c
//   stash, GRU: the h stash); init [N, H] (c0, or h0); whh [Gp, Hp] =
//   W_hh^T zero-padded (Gp = G rounded up to 64, G = 4H or 3H; Hp = 128 NT),
//   or for the split walk W_hh^T [G, H];
//   dh_in, dc_in, dh_out, dc_out [N, H] fp32; out0 [T, N, G] (dgates, or
//   dxw); out1 [T, N, 3H] (dhw, GRU only). Unmarked ones in bf16.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math).

#include <cooperative_groups.h>

#include "lstm_train_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace fsn;

// ---------------------------------------------------------------------------
// Stages 1 and 3: C = [A | A_prev] . B (+ bias) on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kGemmBM = 128;
constexpr int kGemmBN = 128;
constexpr int kGemmBK = 32;
constexpr int kGemmStages = 4;
constexpr int kGemmThreads = 256;  // 8 warps, 2 x 4, each 64 x 32 of C
constexpr int kGemmTileA = kGemmBM * kGemmBK;
constexpr int kGemmTileB = kGemmBK * kGemmBN;
constexpr size_t kGemmSmem = sizeof(bf16) * kGemmStages * (kGemmTileA + kGemmTileB);

struct GemmArgs {
    const bf16* a;       // columns [0, k_split): row m at a + m * lda
    const bf16* a_prev;  // columns [k_split, K): row m at a_prev + (m - shift) * ldp,
    const bf16* a_head;  //   rows m < shift at a_head + m * ldp
    const bf16* b;       // [K, Ncols], row stride ldb
    const float* bias;   // [Ncols] or null
    void* c;             // [M, Ncols]
    int M, Ncols, K, k_split, shift, lda, ldp, ldb;
};

__device__ __forceinline__ const bf16* a_elem(const GemmArgs& g, int m, int k) {
    if (k < g.k_split) return g.a + (size_t)m * g.lda + k;
    k -= g.k_split;
    return m >= g.shift ? g.a_prev + (size_t)(m - g.shift) * g.ldp + k
                        : g.a_head + (size_t)m * g.ldp + k;
}

// shared-memory element offsets of 16-byte chunk c8 of a row: the chunk
// index is XOR-swizzled so that the 8 rows one ldmatrix phase reads fall
// in 8 different bank groups
__device__ __forceinline__ int gemm_a_off(int r, int c8) {  // A tile rows: 4 chunks
    return r * kGemmBK + ((c8 ^ ((r >> 1) & 3)) << 3);
}

__device__ __forceinline__ int gemm_b_off(int k, int c8) {  // B tile rows: 16 chunks
    return k * kGemmBN + ((c8 ^ (k & 7)) << 3);
}

__device__ __forceinline__ uint4 load8_scalar(const bf16* const (&src)[8], const bool (&ok)[8]) {
    union {
        uint4 v;
        unsigned short h[8];
    } u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        u.h[e] = ok[e] ? __ldg(reinterpret_cast<const unsigned short*>(src[e])) : 0;
    }
    return u.v;
}

// one k-tile of A and B into shared memory: by cp.async where every
// 16-byte chunk is aligned and lies in one segment (kVec), else element
// by element through registers
template <bool kVec>
__device__ __forceinline__ void gemm_load_tile(const GemmArgs& g, bf16* sa, bf16* sb, int m0,
                                               int n0, int k0) {
#pragma unroll
    for (int i = 0; i < kGemmTileA / 8 / kGemmThreads; ++i) {
        const int idx = threadIdx.x + i * kGemmThreads;
        const int r = idx >> 2;
        const int c8 = idx & 3;
        const int m = m0 + r;
        const int k = k0 + (c8 << 3);
        bf16* dst = sa + gemm_a_off(r, c8);
        if constexpr (kVec) {
            const bool ok = m < g.M && k < g.K;
            cp_async_16(smem_addr(dst), ok ? a_elem(g, m, k) : g.b, ok);
        } else {
            const bf16* src[8];
            bool ok[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                ok[e] = m < g.M && k + e < g.K;
                src[e] = ok[e] ? a_elem(g, m, k + e) : g.b;
            }
            *reinterpret_cast<uint4*>(dst) = load8_scalar(src, ok);
        }
    }
#pragma unroll
    for (int i = 0; i < kGemmTileB / 8 / kGemmThreads; ++i) {
        const int idx = threadIdx.x + i * kGemmThreads;
        const int kk = idx >> 4;
        const int c8 = idx & 15;
        const int k = k0 + kk;
        const int n = n0 + (c8 << 3);
        bf16* dst = sb + gemm_b_off(kk, c8);
        if constexpr (kVec) {
            const bool ok = k < g.K && n < g.Ncols;
            cp_async_16(smem_addr(dst), ok ? g.b + (size_t)k * g.ldb + n : g.b, ok);
        } else {
            const bf16* src[8];
            bool ok[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                ok[e] = k < g.K && n + e < g.Ncols;
                src[e] = ok[e] ? g.b + (size_t)k * g.ldb + n + e : g.b;
            }
            *reinterpret_cast<uint4*>(dst) = load8_scalar(src, ok);
        }
    }
}

template <bool kVec, bool kOutF32>
__global__ void __launch_bounds__(kGemmThreads) tc_gemm_kernel(GemmArgs g) {
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    bf16* sa = reinterpret_cast<bf16*>(fsn_smem);  // [stages][BM x BK]
    bf16* sb = sa + kGemmStages * kGemmTileA;      // [stages][BK x BN]

    // consecutive blocks share a row tile of A: its rows are read once
    // from device memory and then from L2
    const int tiles_n = (g.Ncols + kGemmBN - 1) / kGemmBN;
    const int m0 = (int)(blockIdx.x / tiles_n) * kGemmBM;
    const int n0 = (int)(blockIdx.x % tiles_n) * kGemmBN;
    const int k_tiles = (g.K + kGemmBK - 1) / kGemmBK;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = warp >> 2;
    const int wn = warp & 3;

    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kGemmStages - 1; ++s) {
        if (s < k_tiles) {
            gemm_load_tile<kVec>(g, sa + s * kGemmTileA, sb + s * kGemmTileB, m0, n0, s * kGemmBK);
        }
        cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
        // tile kt has landed for every thread, and every warp is done with
        // tile kt - 1, whose slot the next load takes
        cp_async_wait<kGemmStages - 2>();
        __syncthreads();
        const int next = kt + kGemmStages - 1;
        if (next < k_tiles) {
            const int s = next % kGemmStages;
            gemm_load_tile<kVec>(g, sa + s * kGemmTileA, sb + s * kGemmTileB, m0, n0,
                                 next * kGemmBK);
        }
        cp_async_commit();
        const bf16* ta = sa + (kt % kGemmStages) * kGemmTileA;
        const bf16* tb = sb + (kt % kGemmStages) * kGemmTileB;
#pragma unroll
        for (int ks = 0; ks < kGemmBK / 16; ++ks) {
            uint32_t af[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const int r = wm * 64 + mt * 16 + (lane & 15);
                ldsm_x4(smem_addr(ta + gemm_a_off(r, ks * 2 + (lane >> 4))), af[mt]);
            }
            uint32_t bfr[4][2];
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                const int kk = ks * 16 + (lane & 15);
                const int c8 = wn * 4 + np * 2 + (lane >> 4);
                uint32_t r[4];
                ldsm_x4_trans(smem_addr(tb + gemm_b_off(kk, c8)), r);
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

    const int gq = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int m = m0 + wm * 64 + mt * 16 + gq + half * 8;
                const int n = n0 + wn * 32 + nt * 8 + 2 * q;
                if (m >= g.M || n >= g.Ncols) continue;
                const bool two = n + 1 < g.Ncols;
                float v0 = acc[mt][nt][2 * half];
                float v1 = acc[mt][nt][2 * half + 1];
                if (g.bias != nullptr) {
                    v0 += g.bias[n];
                    if (two) v1 += g.bias[n + 1];
                }
                const size_t o = (size_t)m * g.Ncols + n;
                if constexpr (kOutF32) {
                    float* c = static_cast<float*>(g.c) + o;
                    if (two && (o & 1) == 0) {
                        *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
                    } else {
                        c[0] = v0;
                        if (two) c[1] = v1;
                    }
                } else {
                    bf16* c = static_cast<bf16*>(g.c) + o;
                    if (two && (o & 1) == 0) {
                        *reinterpret_cast<unsigned*>(c) = pack_bf16x2(v0, v1);
                    } else {
                        c[0] = __float2bfloat16(v0);
                        if (two) c[1] = __float2bfloat16(v1);
                    }
                }
            }
        }
    }
}

template <bool kVec, bool kOutF32>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t stream) {
    auto kernel = tc_gemm_kernel<kVec, kOutF32>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kGemmSmem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)((g.M + kGemmBM - 1) / kGemmBM) *
                             ((g.Ncols + kGemmBN - 1) / kGemmBN);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kGemmThreads, kGemmSmem, stream>>>(g);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// Stage 2: the walk over time
// ---------------------------------------------------------------------------

constexpr int kWalkWarps = 16;
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkBK = 32;     // rows of W_hh^T in one ring slot
constexpr int kSplitCtas = 16;  // CTAs of one cluster of the split walk
constexpr int kSplitRows = 32;  // rows one cluster walks

struct WalkArgs {
    const float* p;      // [T, N, 4H] pre-activations
    const bf16* dh;      // [T, N, H]
    const bf16* stash;   // [T, N, H] c (LSTM) or h (GRU) stash
    const bf16* init;    // [N, H] c0 or h0
    const bf16* whh;     // streaming walk: [Gp, Hp] W_hh^T, zero-padded; split walk: [G, H]
    const float* dh_in;  // [N, H]
    const float* dc_in;  // [N, H], LSTM only
    bf16* out0;          // [T, N, G] dgates (LSTM) or dxw (GRU)
    bf16* out1;          // [T, N, 3H] dhw (GRU only)
    float* dh_out;       // [N, H]
    float* dc_out;       // [N, H], LSTM only
    long long* clocks;   // null, or [3]: block 0's cycles in the cell backward, the
                         // product and (split walk) the cluster exchange, over all steps
    int T, N, H, Gp, stages;
};

// block 0's phase cycles into a.clocks, where the caller asked for them
__device__ __forceinline__ void report_clocks(const WalkArgs& a, const long long (&c)[3]) {
    if (a.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        a.clocks[0] = c[0];
        a.clocks[1] = c[1];
        a.clocks[2] = c[2];
    }
}

// One (row, unit pair) of a step: the loads of the cell backward and its
// rounded cotangents d (LSTM dgates i, f, g, o; GRU dr, dz, dn, dn r), by
// unit e = 0, 1 of the pair.
struct Pair {
    float p[4][2];   // pre-activations: LSTM i, f, g, o; GRU r, z, n's x part, hn
    float dh[2];     // dh_t
    float cur[2];    // LSTM: c_t
    float prev[2];   // the state before step t: LSTM c_{t-1}; GRU h_{t-1}
    float d[4][2];
};

// the loads of pair (row, units j, j + 1) at step t; `row` indexes [T*N],
// `init_row` [N]. Rows past N call this not at all and keep zeros.
template <bool kLstm>
__device__ __forceinline__ void load_pair(const WalkArgs& a, int t, size_t row, size_t init_row,
                                          int j, Pair& v) {
    const int H = a.H;
    const float* pr = a.p + row * (size_t)(4 * H) + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 pk = __ldg(reinterpret_cast<const float2*>(pr + k * H));
        v.p[k][0] = pk.x;
        v.p[k][1] = pk.y;
    }
    const float2 dht = load_bf16x2(a.dh + row * H + j);
    // at t = 0 the initial state stands for the stash
    const float2 prev = t > 0 ? load_bf16x2(a.stash + (row - a.N) * H + j)
                              : load_bf16x2(a.init + init_row * H + j);
    v.dh[0] = dht.x;
    v.dh[1] = dht.y;
    v.prev[0] = prev.x;
    v.prev[1] = prev.y;
    if constexpr (kLstm) {
        const float2 cur = load_bf16x2(a.stash + row * H + j);
        v.cur[0] = cur.x;
        v.cur[1] = cur.y;
    }
}

// The cell backward of _lstm_layer_bwd_kernel / _gru_layer_bwd_kernel for
// one pair: fills v.d, updates the LSTM's dc carry, and returns by unit
// the start of the next dh carry (LSTM 0, GRU dh_tot z); `carry` is the dh
// carry into step t.
template <bool kLstm>
__device__ __forceinline__ void cell_backward(Pair& v, const float (&carry)[2], float (&dcc)[2],
                                              float (&next)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const float dh_tot = v.dh[e] + carry[e];
        if constexpr (kLstm) {
            const float ig = sigmoid_f(v.p[0][e]);
            const float fg = sigmoid_f(v.p[1][e]);
            const float gg = tanhf(v.p[2][e]);
            const float og = sigmoid_f(v.p[3][e]);
            const float tc = tanhf(v.cur[e]);
            const float d_o = dh_tot * tc;
            const float dc = dcc[e] + dh_tot * og * (1.0f - tc * tc);
            v.d[0][e] = round_bf16((dc * gg) * ig * (1.0f - ig));
            v.d[1][e] = round_bf16((dc * v.prev[e]) * fg * (1.0f - fg));
            v.d[2][e] = round_bf16((dc * ig) * (1.0f - gg * gg));
            v.d[3][e] = round_bf16(d_o * og * (1.0f - og));
            dcc[e] = dc * fg;
            next[e] = 0.0f;
        } else {
            const float rg = sigmoid_f(v.p[0][e]);
            const float zg = sigmoid_f(v.p[1][e]);
            const float hn = v.p[3][e];
            const float ng = tanhf(v.p[2][e] + rg * hn);
            const float dz = dh_tot * (v.prev[e] - ng);
            const float dn = (dh_tot * (1.0f - zg)) * (1.0f - ng * ng);
            v.d[0][e] = round_bf16((dn * hn) * rg * (1.0f - rg));
            v.d[1][e] = round_bf16(dz * zg * (1.0f - zg));
            v.d[2][e] = round_bf16(dn);
            v.d[3][e] = round_bf16(dn * rg);
            next[e] = dh_tot * zg;
        }
    }
}

// the pair's cotangents: into the streams at (row, gate k, unit j), and
// into the A operand of the carry product (dgates; GRU dhw) at column
// k * stride + col of a tile of gp columns
template <bool kLstm>
__device__ __forceinline__ void store_pair(const WalkArgs& a, const Pair& v, bool real, size_t row,
                                           int j, bf16* sa, int r, int col, int stride, int gp) {
    const int H = a.H;
    constexpr int kGates = kLstm ? 4 : 3;
#pragma unroll
    for (int k = 0; k < kGates; ++k) {
        const int src = (!kLstm && k == 2) ? 3 : k;  // dhw's n part is dn r
        *reinterpret_cast<unsigned*>(sa + walk_a_off(r, k * stride + col, gp)) =
            pack_bf16x2(v.d[src][0], v.d[src][1]);
    }
    if (!real) return;
    bf16* o0 = a.out0 + row * (size_t)(kGates * H) + j;
#pragma unroll
    for (int k = 0; k < kGates; ++k) {
        *reinterpret_cast<unsigned*>(o0 + k * H) = pack_bf16x2(v.d[k][0], v.d[k][1]);
    }
    if constexpr (!kLstm) {
        bf16* o1 = a.out1 + row * (size_t)(3 * H) + j;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int src = k == 2 ? 3 : k;
            *reinterpret_cast<unsigned*>(o1 + k * H) = pack_bf16x2(v.d[src][0], v.d[src][1]);
        }
    }
}

template <int NT>
__device__ __forceinline__ void walk_load_chunk(const bf16* whh, bf16* slot, int kchunk) {
    constexpr int kHp = kWalkWarps * NT * 8;
    constexpr int kPerRow = kHp / 8;
#pragma unroll
    for (int i = 0; i < NT; ++i) {  // 32 rows x kPerRow chunks over 512 threads
        const int idx = threadIdx.x + i * kWalkThreads;
        const int kk = idx / kPerRow;
        const int c8 = idx - kk * kPerRow;
        const bf16* src = whh + (size_t)(kchunk * kWalkBK + kk) * kHp + (c8 << 3);
        cp_async_16(smem_addr(slot + walk_b_off(kk, c8, kHp)), src, true);
    }
}

// The streaming walk. Warp w owns units [8 NT w, 8 NT (w + 1)) of the dh
// carry, for all ROWS rows: MT x NT mma tiles of 16 x 8. Its lane (gq, q)
// holds, in tile (mt, nt), rows mt 16 + gq (+ 8) and units 8 (NT w + nt) +
// 2q (+ 1); the cell backward of step t runs on exactly those pairs.
template <int ROWS, int NT, bool kLstm>
__global__ void __launch_bounds__(kWalkThreads, 1) rnn_bwd_walk_kernel(WalkArgs a) {
    constexpr int MT = ROWS / 16;
    constexpr int kHp = kWalkWarps * NT * 8;
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    const int gp = a.Gp;
    bf16* sa = reinterpret_cast<bf16*>(fsn_smem);  // [ROWS][Gp] dgates (GRU: dhw)
    bf16* ring = sa + ROWS * gp;                   // [stages][32][Hp] W_hh^T chunks
    const int H = a.H;
    const int N = a.N;
    const int row0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, N - row0);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gq = lane >> 2;
    const int q = lane & 3;
    const int nk = gp / kWalkBK;
    const int stages = a.stages;

    // the tile's padding (columns past G, rows past N) stays zero
    for (int i = threadIdx.x; i < ROWS * gp / 8; i += kWalkThreads) {
        reinterpret_cast<uint4*>(sa)[i] = make_uint4(0u, 0u, 0u, 0u);
    }

    float acc[MT][NT][4];  // the dh carry into step t; then the product's accumulators
    float dcc[MT][NT][4];  // the dc carry (LSTM)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = mt * 16 + gq + half * 8;
                const int j = (warp * NT + nt) * 8 + 2 * q;
                float2 dh0 = make_float2(0.0f, 0.0f);
                float2 dc0 = make_float2(0.0f, 0.0f);
                if (r < rows && j < H) {
                    const size_t o = (size_t)(row0 + r) * H + j;
                    dh0 = __ldg(reinterpret_cast<const float2*>(a.dh_in + o));
                    if constexpr (kLstm) dc0 = __ldg(reinterpret_cast<const float2*>(a.dc_in + o));
                }
                acc[mt][nt][2 * half] = dh0.x;
                acc[mt][nt][2 * half + 1] = dh0.y;
                dcc[mt][nt][2 * half] = dc0.x;
                dcc[mt][nt][2 * half + 1] = dc0.y;
            }
        }
    }

    for (int s = 0; s < stages - 1; ++s) {
        walk_load_chunk<NT>(a.whh, ring + s * kWalkBK * kHp, s % nk);
        cp_async_commit();
    }
    int chunk = 0;  // chunk c of the ring holds rows (c % nk) 32.. of W_hh^T, in slot c % stages
    __syncthreads();

    long long clk[3] = {0, 0, 0};
    for (int t = a.T - 1; t >= 0; --t) {
        const size_t step0 = (size_t)t * N + row0;  // row index of the tile's first row at t
        const long long c0 = clock64();

        // ---- the cell backward of step t ----
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = mt * 16 + gq + half * 8;
                    const int j = (warp * NT + nt) * 8 + 2 * q;
                    float* c = acc[mt][nt] + 2 * half;
                    if (j >= H) {  // a padding unit: its product stays zero
                        c[0] = c[1] = 0.0f;
                        continue;
                    }
                    // rows past N read zeros, and their cotangents come out zero
                    const bool real = r < rows;
                    Pair v = {};
                    if (real) load_pair<kLstm>(a, t, step0 + r, (size_t)(row0 + r), j, v);
                    const float carry[2] = {c[0], c[1]};
                    float dc[2] = {dcc[mt][nt][2 * half], dcc[mt][nt][2 * half + 1]};
                    float next[2];
                    cell_backward<kLstm>(v, carry, dc, next);
                    c[0] = next[0];  // the product's start
                    c[1] = next[1];
                    dcc[mt][nt][2 * half] = dc[0];
                    dcc[mt][nt][2 * half + 1] = dc[1];
                    store_pair<kLstm>(a, v, real, step0 + r, j, sa, r, j, H, gp);
                }
            }
        }
        __syncthreads();  // the dgates tile is complete
        const long long c1 = clock64();

        // step t - 1's streams into L2 while this step multiplies
        if (t > 0) {
            const size_t prev0 = step0 - N;
            prefetch_rows(a.p + prev0 * (size_t)(4 * H), (size_t)rows * 4 * H * sizeof(float),
                          kWalkThreads);
            prefetch_rows(a.dh + prev0 * H, (size_t)rows * H * sizeof(bf16), kWalkThreads);
            if (t > 1) {
                prefetch_rows(a.stash + (prev0 - N) * H, (size_t)rows * H * sizeof(bf16),
                              kWalkThreads);
            }
        }

        // ---- the next dh carry: acc += A . W_hh^T on the tensor cores ----
        for (int kc = 0; kc < nk; ++kc, ++chunk) {
            ring_wait(stages);
            __syncthreads();  // chunk landed for all; the slot of chunk - 1 is free
            {
                const int c = chunk + stages - 1;
                walk_load_chunk<NT>(a.whh, ring + (c % stages) * kWalkBK * kHp, c % nk);
                cp_async_commit();
            }
            const bf16* slot = ring + (chunk % stages) * kWalkBK * kHp;
#pragma unroll
            for (int ks = 0; ks < kWalkBK / 16; ++ks) {
                uint32_t af[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int r = mt * 16 + (lane & 15);
                    const int col = kc * kWalkBK + ks * 16 + (lane >> 4) * 8;
                    ldsm_x4(smem_addr(sa + walk_a_off(r, col, gp)), af[mt]);
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    uint32_t b[2];
                    const int kk = ks * 16 + (lane & 15);
                    ldsm_x2_trans(smem_addr(slot + walk_b_off(kk, warp * NT + nt, kHp)), b);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][nt], af[mt], b[0], b[1]);
                }
            }
        }
        __syncthreads();  // every warp is done with the dgates tile
        const long long c2 = clock64();
        clk[0] += c1 - c0;
        clk[1] += c2 - c1;
    }
    cp_async_wait<0>();
    report_clocks(a, clk);

    // the carries into the initial state
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = mt * 16 + gq + half * 8;
                const int j = (warp * NT + nt) * 8 + 2 * q;
                if (r >= rows || j >= H) continue;
                const size_t o = (size_t)(row0 + r) * H + j;
                *reinterpret_cast<float2*>(a.dh_out + o) =
                    make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
                if constexpr (kLstm) {
                    *reinterpret_cast<float2*>(a.dc_out + o) =
                        make_float2(dcc[mt][nt][2 * half], dcc[mt][nt][2 * half + 1]);
                }
            }
        }
    }
}

// The split walk, for few rows. A cluster of 16 CTAs walks a tile of 32
// rows; CTA k owns units [k H/16, (k + 1) H/16) and keeps the rows of
// W_hh^T of their gates (4 H/16 of the LSTM, 3 H/16 of the GRU; 128 KB at
// H = 512) resident in shared memory for the whole walk. Per step each CTA
// does the cell backward of its units, forms the partial carries
// partial_k = dgates_k . W_hh^T_k for all H units on the tensor cores, and
// the cluster reduce-scatters them through distributed shared memory: the
// thread of pair (row, units j, j + 1) sums the 16 CTAs' partials of its
// units, in rank order. Nothing streams from L2 but the step's own inputs.
// Thread i does the cell backward of row i / (H/32), units 2 (i % (H/32)).
template <int NT, bool kLstm>
__global__ void __launch_bounds__(kWalkThreads, 1) rnn_bwd_walk_split_kernel(WalkArgs a) {
    namespace cg = cooperative_groups;
    constexpr int H = kWalkWarps * NT * 8;
    constexpr int HC = H / kSplitCtas;           // units of one CTA
    constexpr int kGates = kLstm ? 4 : 3;
    constexpr int KC = kGates * HC;              // its rows of W_hh^T: its dgates columns
    constexpr int KCP = (KC + 63) / 64 * 64;     // its dgates tile's row, padded for the swizzle
    constexpr int PS = H + 8;                    // a partial row, padded against bank conflicts
    constexpr int MT = kSplitRows / 16;
    constexpr int kPairsPerRow = HC / 2;
    static_assert(KC % 16 == 0 && kSplitRows * kPairsPerRow <= kWalkThreads, "split walk shape");
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    bf16* sw = reinterpret_cast<bf16*>(fsn_smem);                   // [KC][H]
    bf16* sa = sw + KC * H;                                          // [32][KCP]
    float* part = reinterpret_cast<float*>(sa + kSplitRows * KCP);  // [32][PS]

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int u0 = rank * HC;
    const int N = a.N;
    const int row0 = (int)(blockIdx.x / kSplitCtas) * kSplitRows;
    const int rows = min(kSplitRows, N - row0);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gq = lane >> 2;
    const int q = lane & 3;

    // this CTA's rows of W_hh^T: local row g HC + i is row g H + u0 + i
    for (int idx = threadIdx.x; idx < KC * H / 8; idx += kWalkThreads) {
        const int k = idx / (H / 8);
        const int c8 = idx - k * (H / 8);
        const int g = k / HC;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            a.whh + (size_t)(g * H + u0 + k - g * HC) * H + c8 * 8));
        *reinterpret_cast<uint4*>(sw + walk_b_off(k, c8, H)) = w;
    }
    for (int i = threadIdx.x; i < kSplitRows * KCP / 8; i += kWalkThreads) {
        reinterpret_cast<uint4*>(sa)[i] = make_uint4(0u, 0u, 0u, 0u);
    }

    const int r = threadIdx.x / kPairsPerRow;
    const int jl = (threadIdx.x % kPairsPerRow) * 2;
    const int j = u0 + jl;
    const bool active = threadIdx.x < kSplitRows * kPairsPerRow;
    const bool real = active && r < rows;
    float carry[2] = {0.0f, 0.0f};
    float dcc[2] = {0.0f, 0.0f};
    if (real) {
        const size_t o = (size_t)(row0 + r) * H + j;
        const float2 dh0 = __ldg(reinterpret_cast<const float2*>(a.dh_in + o));
        carry[0] = dh0.x;
        carry[1] = dh0.y;
        if constexpr (kLstm) {
            const float2 dc0 = __ldg(reinterpret_cast<const float2*>(a.dc_in + o));
            dcc[0] = dc0.x;
            dcc[1] = dc0.y;
        }
    }
    __syncthreads();
    cluster_arrive();  // pairs with the first wait below

    long long clk[3] = {0, 0, 0};
    for (int t = a.T - 1; t >= 0; --t) {
        const long long c0 = clock64();
        const size_t row = (size_t)t * N + row0 + r;
        float next[2] = {0.0f, 0.0f};
        if (active) {
            Pair v = {};
            if (real) load_pair<kLstm>(a, t, row, (size_t)(row0 + r), j, v);
            cell_backward<kLstm>(v, carry, dcc, next);
            store_pair<kLstm>(a, v, real, row, j, sa, r, jl, HC, KCP);
        }
        __syncthreads();  // this CTA's dgates tile is complete
        const long long c1 = clock64();

        // partial = dgates_k . W_hh^T_k: 32 x H over K = KC, warp w owns
        // columns [8 NT w, 8 NT (w + 1))
        float acc[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
            uint32_t af[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ldsm_x4(smem_addr(sa + walk_a_off(mt * 16 + (lane & 15),
                                                  ks * 16 + (lane >> 4) * 8, KCP)), af[mt]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                uint32_t b[2];
                ldsm_x2_trans(smem_addr(sw + walk_b_off(ks * 16 + (lane & 15), warp * NT + nt, H)),
                              b);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][nt], af[mt], b[0], b[1]);
            }
        }
        cluster_wait();  // every CTA has read the partials of step t + 1
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int pr = mt * 16 + gq + half * 8;
                    const int pc = (warp * NT + nt) * 8 + 2 * q;
                    *reinterpret_cast<float2*>(part + pr * PS + pc) =
                        make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
                }
        const long long c2 = clock64();
        cluster_arrive();
        cluster_wait();  // the partials of step t are written, cluster-wide

        // the reduce-scatter: the next dh carry of this thread's pair
        if (active) {
            float s0 = next[0], s1 = next[1];
#pragma unroll
            for (int k = 0; k < kSplitCtas; ++k) {
                const float* remote = cluster.map_shared_rank(part, k);
                const float2 v = *reinterpret_cast<const float2*>(remote + r * PS + j);
                s0 += v.x;
                s1 += v.y;
            }
            carry[0] = s0;
            carry[1] = s1;
        }
        cluster_arrive();  // done reading the partials of step t
        const long long c3 = clock64();
        clk[0] += c1 - c0;
        clk[1] += c2 - c1;
        clk[2] += c3 - c2;
    }
    cluster_wait();  // no CTA leaves while another may still read its partials
    report_clocks(a, clk);

    if (real) {
        const size_t o = (size_t)(row0 + r) * H + j;
        *reinterpret_cast<float2*>(a.dh_out + o) = make_float2(carry[0], carry[1]);
        if constexpr (kLstm) *reinterpret_cast<float2*>(a.dc_out + o) = make_float2(dcc[0], dcc[1]);
    }
}

size_t walk_smem(int rows, int gp, int nt, int stages) {
    return sizeof(bf16) * ((size_t)rows * gp + (size_t)stages * kWalkBK * kWalkWarps * nt * 8);
}

size_t split_smem(bool lstm, int H) {
    const size_t kc = (size_t)(lstm ? 4 : 3) * (H / kSplitCtas);
    const size_t kcp = (kc + 63) / 64 * 64;
    return sizeof(bf16) * (kc * H + kSplitRows * kcp) + sizeof(float) * kSplitRows * (H + 8);
}

template <int ROWS, int NT, bool kLstm>
cudaError_t launch_walk(const WalkArgs& a, cudaStream_t stream) {
    auto kernel = rnn_bwd_walk_kernel<ROWS, NT, kLstm>;
    const size_t smem = walk_smem(ROWS, a.Gp, NT, a.stages);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + ROWS - 1) / ROWS);
    kernel<<<grid, kWalkThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int ROWS, bool kLstm>
cudaError_t walk_by_nt(const WalkArgs& a, int nt, cudaStream_t stream) {
    switch (nt) {
        case 1: return launch_walk<ROWS, 1, kLstm>(a, stream);
        case 2: return launch_walk<ROWS, 2, kLstm>(a, stream);
        case 3: return launch_walk<ROWS, 3, kLstm>(a, stream);
        case 4: return launch_walk<ROWS, 4, kLstm>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <bool kLstm>
cudaError_t walk_by_rows(const WalkArgs& a, int rows, int nt, cudaStream_t stream) {
    switch (rows) {
        case 16: return walk_by_nt<16, kLstm>(a, nt, stream);
        case 32: return walk_by_nt<32, kLstm>(a, nt, stream);
        case 64: return walk_by_nt<64, kLstm>(a, nt, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <int NT, bool kLstm>
cudaError_t launch_split(const WalkArgs& a, cudaStream_t stream) {
    auto kernel = rnn_bwd_walk_split_kernel<NT, kLstm>;
    const size_t smem = split_smem(kLstm, a.H);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(kSplitCtas * ((a.N + kSplitRows - 1) / kSplitRows)), 1, 1);
    cfg.blockDim = dim3(kWalkThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSplitCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

WalkArgs walk_args(const float* p, const void* dh, const void* stash, const void* init,
                   const void* whh, const float* dh_in, const float* dc_in, void* out0, void* out1,
                   float* dh_out, float* dc_out, long long* clocks, int T, int N, int H) {
    WalkArgs a;
    a.p = p;
    a.dh = static_cast<const bf16*>(dh);
    a.stash = static_cast<const bf16*>(stash);
    a.init = static_cast<const bf16*>(init);
    a.whh = static_cast<const bf16*>(whh);
    a.dh_in = dh_in;
    a.dc_in = dc_in;
    a.out0 = static_cast<bf16*>(out0);
    a.out1 = static_cast<bf16*>(out1);
    a.dh_out = dh_out;
    a.dc_out = dc_out;
    a.clocks = clocks;
    a.T = T; a.N = N; a.H = H; a.Gp = 0; a.stages = 0;
    return a;
}

}  // namespace

// C = [A | A_prev] . B (+ bias): A [M, k_split] (lda); columns [k_split,
// K) of row m from a_prev row m - shift (ldp), or a_head row m for
// m < shift (a_prev and a_head may be null when k_split = K); B [K, Ncols]
// (ldb); bias [Ncols] fp32 or null; C [M, Ncols] contiguous, fp32
// (out_f32 = 1) or bf16. Returns a cudaError_t.
extern "C" int fsn_tc_gemm(const void* a, const void* a_prev, const void* a_head, const void* b,
                           const float* bias, void* c, int M, int Ncols, int K, int k_split,
                           int shift, int lda, int ldp, int ldb, int out_f32, void* stream) {
    if (M < 1 || Ncols < 1 || K < 1 || k_split < 1 || k_split > K || shift < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (k_split < K && (a_prev == nullptr || (shift > 0 && a_head == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    GemmArgs g;
    g.a = static_cast<const bf16*>(a);
    g.a_prev = static_cast<const bf16*>(a_prev);
    g.a_head = static_cast<const bf16*>(a_head);
    g.b = static_cast<const bf16*>(b);
    g.bias = bias;
    g.c = c;
    g.M = M; g.Ncols = Ncols; g.K = K; g.k_split = k_split; g.shift = shift;
    g.lda = lda; g.ldp = ldp; g.ldb = ldb;
    const bool two = k_split < K;
    const bool vec = lda % 8 == 0 && ldb % 8 == 0 && k_split % 8 == 0 && K % 8 == 0 &&
                     Ncols % 8 == 0 && aligned16(a) && aligned16(b) &&
                     (!two || (ldp % 8 == 0 && aligned16(a_prev) &&
                               (shift == 0 || aligned16(a_head))));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec) return (int)(out_f32 ? launch_gemm<true, true>(g, s) : launch_gemm<true, false>(g, s));
    return (int)(out_f32 ? launch_gemm<false, true>(g, s) : launch_gemm<false, false>(g, s));
}

// The streaming walk of one layer's backward. lstm = 1: stash = c stash,
// init = c0, out0 = dgates [T, N, 4H], dc_in and dc_out used; lstm = 0
// (GRU): stash = h stash, init = h0, out0 = dxw and out1 = dhw [T, N, 3H].
// whh [Gp, 128 nt] zero-padded W_hh^T; rows_per_block 16, 32 or 64; stages
// 2 to 4. H even. clocks null, or [3] int64 for block 0's phase cycles.
// Returns a cudaError_t.
extern "C" int fsn_rnn_bwd_walk(int lstm, const float* p, const void* dh, const void* stash,
                                const void* init, const void* whh, const float* dh_in,
                                const float* dc_in, void* out0, void* out1, float* dh_out,
                                float* dc_out, long long* clocks, int T, int N, int H, int Gp,
                                int nt, int rows_per_block, int stages, void* stream) {
    const int G = lstm ? 4 * H : 3 * H;
    if (T < 1 || N < 1 || H < 2 || H % 2 != 0 || nt < 1 || nt > 4 || H > kWalkWarps * 8 * nt ||
        Gp < G || Gp % 64 != 0 || stages < 2 || stages > 4) {
        return (int)cudaErrorInvalidValue;
    }
    if (walk_smem(rows_per_block, Gp, nt, stages) > 232448) return (int)cudaErrorInvalidValue;
    WalkArgs a = walk_args(p, dh, stash, init, whh, dh_in, dc_in, out0, out1, dh_out, dc_out,
                           clocks, T, N, H);
    a.Gp = Gp;
    a.stages = stages;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? walk_by_rows<true>(a, rows_per_block, nt, s)
                      : walk_by_rows<false>(a, rows_per_block, nt, s));
}

// The split walk (clusters of 16 CTAs, 32 rows each), same operands as
// fsn_rnn_bwd_walk but whh = W_hh^T [G, H] contiguous. H 256 or 512.
// Returns a cudaError_t.
extern "C" int fsn_rnn_bwd_walk_split(int lstm, const float* p, const void* dh,
                                      const void* stash, const void* init, const void* whh,
                                      const float* dh_in, const float* dc_in, void* out0,
                                      void* out1, float* dh_out, float* dc_out, long long* clocks,
                                      int T, int N, int H, void* stream) {
    if (T < 1 || N < 1 || (H != 256 && H != 512)) return (int)cudaErrorInvalidValue;
    WalkArgs a = walk_args(p, dh, stash, init, whh, dh_in, dc_in, out0, out1, dh_out, dc_out,
                           clocks, T, N, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (H == 256) return (int)(lstm ? launch_split<2, true>(a, s) : launch_split<2, false>(a, s));
    return (int)(lstm ? launch_split<4, true>(a, s) : launch_split<4, false>(a, s));
}

extern "C" const char* fsn_tc_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
