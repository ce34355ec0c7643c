// The training forward's walk over time on Hopper's tensor cores, bf16
// storage (K2 for the LSTM, K2-GRU for the GRU), for sm_90a.
//
// Replaces, together with the GEMM of rnn_bwd_tc.cu (fsn_tc_gemm), the TPU
// kernel fullsubnet_tpu/ops/subband_lstm.py: _kernel_train_fwd as launched
// by _stash_fwd_call (the pl.pallas_call of the training forward), with
// _lstm_step or _gru_step, at bf16 storage; fp32 storage keeps
// lstm_train_fwd.cu and gru_forward.cu. The outputs are the TPU kernel's:
// every layer's h stash (and the LSTM's c stash) in bf16, from given
// initial states, so a time-chunked forward can chain calls.
//
// What bounds it on this card. Per step and row the TPU kernel takes the
// whole product [x_t | h_{t-1}] . W of every layer, then the head. Only
// h_{t-1} . W_hh^T is on the time chain: the input projections read x (or
// the layer below's h stash) alone, and the head reads the last h stash.
// At the flagship sub-band shape (N = 4096, T = 195, H = 384) the whole
// forward is 2.9 TFLOP, 2.9 ms at the bf16 tensor-core peak; the chained
// product is 2.3 TFLOP of it. Its weights W_hh^T (1.18 MB in bf16 for the
// LSTM, 2 MB at the full-band shape) do not fit in one SM's 227 KB, so for
// many rows every block streams them from L2 at every step: 128 blocks x
// 390 steps x 1.18 MB = 59 GB of L2 reads for the two layers.
//
// What the design does about it: three stages per layer, composed in
// ops/subband_lstm.py (_train_forward_stages).
//   1. fsn_tc_gemm: P = x . W_ih^T + b over all T*N rows at once (LSTM
//      b_ih + b_hh; GRU b_ih alone, since the reset gate scales
//      W_hn h + b_hn), bf16 operands, fp32 out.
//   2. The walk (this file) over t = 0 .. T-1. Per step it takes the one
//      chained product h_{t-1} . W_hh^T on the tensor cores (mma.sync
//      m16n8k16, bf16 operands from the rounded h, fp32 accumulators), adds
//      P[t] (and the GRU's b_hh), runs the cell in fp32 with accurate
//      expf/tanhf, rounds h to bf16 where it is produced, and writes it to
//      the h stash and to shared memory as the next step's A operand; the
//      fp32 carry (LSTM c, GRU h) stays in registers, the LSTM's c stash is
//      c rounded. The gate columns are laid out so that a thread's
//      accumulators hold every gate of the same (row, unit) pairs: the cell
//      never leaves registers. Two kernels, picked by the wrapper from the
//      shape:
//      fsn_rnn_train_walk, for many rows: one block of 512 threads per tile
//      of 16 or 32 rows. The units go in chunks of 128, 8 a warp; per chunk
//      the block multiplies h_{t-1} by the chunk's gate columns of W_hh^T,
//      which stream from L2 through a ring of 32-row slices (cp.async, 2 to
//      6 slots) that runs on across chunks and steps, then runs the cell of
//      the chunk. h goes to shared memory by step parity; the chunk's P[t]
//      comes into shared memory by cp.async with the chunk's first ring slot
//      and lands while the chunk multiplies.
//      fsn_rnn_train_walk_split, for few rows (the full-band stage, where
//      the streaming walk has one or two blocks, each waiting on L2 for all
//      of W_hh^T at every step): a cluster of 16 CTAs walks 32 rows, CTA k
//      holding the gate columns of its 16th of the units (W_hh^T [H, G/16],
//      128 KB at H = 512) for the whole walk. Each step it gathers h_{t-1}
//      from the 16 CTAs' slices through distributed shared memory,
//      multiplies, runs the cell of its units and writes its slice of h_t,
//      by step parity; one cluster barrier a step. A thread's P[t] is
//      loaded into registers before the exchange.
//   3. fsn_tc_gemm: the head, h_last . W_fc^T + b_fc, fp32 out.
//
// The inference form of the streaming walk (kInfer; fsn_rnn_fwd_stream_walk
// _bf16) serves K1-bf16 (the inference forward on a bf16 x, the TPU
// kernel's _kernel via _infer_impl at compute_dtype = bf16) for many rows,
// past the 2,400 up to which rnn_fwd_tc.cu's tensor-core walk is faster
// (ops/subband_lstm.py, pick_fwd_bf16_form):
// the same walk from an fp32 state (h0 rounded into the tile, c0 or h0 the
// fp32 carry), writing the h stream alone (no c stash) and the fp32 state
// after the last step (h_T, c_T), so that a time-chunked forward carries
// fp32 states as the TPU kernel's single call does.
//
// Layouts (all contiguous; unmarked ones in bf16).
//   p [T, N, G] fp32 (G = 4H or 3H); b_hh [G] fp32 (GRU); h0, c0 [N, H];
//   hs, cs [T, N, H].
//   Streaming walk: whh [UC][Kp][gates x 128], W_hh^T regrouped by chunk of
//   128 units (UC = ceil(H / 128)), K rows padded to Kp = H rounded up to
//   32, column g 128 + u of chunk c = W_hh^T column g H + 128 c + u, zero
//   where the unit or the row is padding.
//   Split walk: whh [16][H][WP], CTA k's block: column g H/16 + u =
//   W_hh^T column g H + k H/16 + u, each row zero-padded to WP = the
//   block's G/16 columns rounded up to 64.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math).

#include <cooperative_groups.h>

#include "lstm_train_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace fsn;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;             // K rows (units of h_{t-1}) of one ring slot
constexpr int kChunk = 8 * kWarps;  // units of one chunk of the streaming walk
constexpr int kSplitCtas = 16;      // CTAs of one cluster of the split walk
constexpr int kSplitRows = 32;      // rows one cluster walks
constexpr int kMaxStages = 6;

struct Args {
    const float* p;      // [T, N, G] input projections
    const bf16* whh;     // W_hh^T, regrouped (see the layouts above)
    const float* b_hh;   // [G], GRU only
    const bf16* h0;      // [N, H]
    const bf16* c0;      // [N, H], LSTM only
    bf16* hs;            // [T, N, H] h stash
    bf16* cs;            // [T, N, H] c stash, LSTM only
    const float* h0f;    // the inference form's fp32 state [N, H] (c0f LSTM only),
    const float* c0f;    //   in place of h0 and c0
    float* h_out;        // and the fp32 state after the last step [N, H] (c_out LSTM
    float* c_out;        //   only)
    long long* clocks;   // null, or [3]: block 0's cycles in the product, the cell and
                         // stash stores, and (split walk) the exchange, over all steps
    int T, N, H, Kp, stages;
};

__device__ __forceinline__ void report_clocks(const Args& a, const long long (&c)[3]) {
    if (a.clocks != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        a.clocks[0] = c[0];
        a.clocks[1] = c[1];
        a.clocks[2] = c[2];
    }
}

// One (row, unit pair) of a step: its gates' input projections pv (P) and
// their h . W_hh^T parts from the accumulators acc[g][e0], acc[g][e0 + 1]
// (with the GRU's b_hh); runs the cell on both units and returns the new h
// rounded to bf16, packed, after writing it (and the LSTM's c) to the
// stashes. `row` indexes [T*N], `j` the pair's first unit. The inference
// form (kInfer) writes no c stash and, at the last step (`last`), the fp32
// h and c of the pair to h_out and c_out at row `state_row` of [N, H].
template <bool kLstm, int kGates, bool kInfer = false>
__device__ __forceinline__ unsigned cell_pair(const Args& a, size_t row, int j,
                                              const float2 (&pv)[kGates],
                                              const float (&acc)[kGates][4], int e0,
                                              float* carry, bool last = false,
                                              size_t state_row = 0) {
    const int H = a.H;
    float hv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        float pre[kGates], hw[kGates];
#pragma unroll
        for (int g = 0; g < kGates; ++g) {
            pre[g] = e ? pv[g].y : pv[g].x;
            hw[g] = acc[g][e0 + e];
            if constexpr (!kLstm) hw[g] += __ldg(a.b_hh + g * H + j + e);
        }
        hv[e] = cell_update<kLstm>(pre, hw, carry[e]);
    }
    const unsigned h = pack_bf16x2(hv[0], hv[1]);
    const size_t o = row * H + j;
    *reinterpret_cast<unsigned*>(a.hs + o) = h;
    if constexpr (kInfer) {
        if (last) {
            const size_t so = state_row * H + j;
            *reinterpret_cast<float2*>(a.h_out + so) = make_float2(hv[0], hv[1]);
            if constexpr (kLstm) {
                *reinterpret_cast<float2*>(a.c_out + so) = make_float2(carry[0], carry[1]);
            }
        }
    } else if constexpr (kLstm) {
        *reinterpret_cast<unsigned*>(a.cs + o) = pack_bf16x2(carry[0], carry[1]);
    }
    return h;
}

// ---------------------------------------------------------------------------
// The streaming walk
// ---------------------------------------------------------------------------

// ring slot `sidx` of one step's W_hh^T (chunk sidx / (Kp / 32), its K rows
// 32 (sidx % (Kp / 32)) ..) into `slot`
template <int WC>
__device__ __forceinline__ void load_slice(const bf16* whh, bf16* slot, int sidx) {
    constexpr int kPerRow = WC / 8;
    const bf16* src = whh + (size_t)sidx * kBK * WC;
#pragma unroll
    for (int i = 0; i < kBK * kPerRow / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int kk = idx / kPerRow;
        const int c8 = idx - kk * kPerRow;
        cp_async_16(smem_addr(slot + walk_b_off(kk, c8, WC)), src + kk * WC + c8 * 8, true);
    }
}

// the row stride (floats) of the P tile of one chunk: its gate columns, and
// 8 more so that the 8 rows one float2 load reads fall in other banks
template <int kGates>
__host__ __device__ constexpr int p_stride() {
    return kGates * kChunk + 8;
}

// P[t] of chunk c's units (from u0 = 128 c) for the tile's rows into `tile`
// [ROWS][p_stride]: gate g's units at columns 128 g ..; rows past N and
// units past H read as zeros
template <int ROWS, int kGates>
__device__ __forceinline__ void load_p_chunk(const Args& a, float* tile, size_t step0, int rows,
                                             int u0) {
    constexpr int kPerGate = kChunk / 4;  // 16-byte pieces of one gate's units
    constexpr int kPerRow = kGates * kPerGate;
    const int H = a.H;
    for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
        const int r = idx / kPerRow;
        const int c = idx - r * kPerRow;
        const int g = c / kPerGate;
        const int u = u0 + (c - g * kPerGate) * 4;
        const bool ok = r < rows && u < H;
        const float* src = ok ? a.p + (step0 + r) * (size_t)(kGates * H) + g * H + u : a.p;
        cp_async_16(smem_addr(tile + r * p_stride<kGates>() + c * 4), src, ok);
    }
}

// Warp w owns units 128 c + 8 w .. + 8 of each chunk c, for all ROWS rows
// and every gate: in chunk c its lane (gq, q) holds, in m-tile mt and gate
// g, rows mt 16 + gq (+ 8) and units 128 c + 8 w + 2q (+ 1); the cell of
// step t runs on exactly those pairs.
template <int ROWS, int UC, bool kLstm, bool kInfer>
__global__ void __launch_bounds__(kThreads, 1) train_walk_kernel(Args a) {
    constexpr int MT = ROWS / 16;
    constexpr int kGates = kLstm ? 4 : 3;
    constexpr int HP = UC * kChunk;       // a row of the h tile: the units, padded
    constexpr int WC = kGates * kChunk;   // a row of a ring slot: one chunk's gate columns
    constexpr int PS = p_stride<kGates>();
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    bf16* hbuf = reinterpret_cast<bf16*>(fsn_smem);                // [2][ROWS][HP] h by parity
    float* ptile = reinterpret_cast<float*>(hbuf + 2 * ROWS * HP);  // [ROWS][PS] P of a chunk
    bf16* ring = reinterpret_cast<bf16*>(ptile + ROWS * PS);        // [stages][32][WC] W_hh^T
    const int H = a.H;
    const int N = a.N;
    const int row0 = blockIdx.x * ROWS;
    const int rows = min(ROWS, N - row0);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gq = lane >> 2;
    const int q = lane & 3;
    const int kslices = a.Kp / kBK;  // ring slots of one chunk
    const int nk = UC * kslices;     // of one step
    const int stages = a.stages;

    // the tiles' padding (units past H, rows past N) stays zero
    for (int i = threadIdx.x; i < 2 * ROWS * HP / 8; i += kThreads) {
        reinterpret_cast<uint4*>(hbuf)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const int pairs = H / 2;
    for (int idx = threadIdx.x; idx < rows * pairs; idx += kThreads) {
        const int r = idx / pairs;
        const int j = 2 * (idx - r * pairs);
        const size_t o = (size_t)(row0 + r) * H + j;
        unsigned h;
        if constexpr (kInfer) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(a.h0f + o));
            h = pack_bf16x2(v.x, v.y);
        } else {
            h = __ldg(reinterpret_cast<const unsigned*>(a.h0 + o));
        }
        *reinterpret_cast<unsigned*>(hbuf + walk_a_off(r, j, HP)) = h;
    }

    float carry[MT][UC][4];  // the fp32 carry: LSTM c, GRU h
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int uc = 0; uc < UC; ++uc)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = mt * 16 + gq + half * 8;
                const int j = uc * kChunk + warp * 8 + 2 * q;
                float2 v = make_float2(0.0f, 0.0f);
                if (r < rows && j < H) {
                    const size_t o = (size_t)(row0 + r) * H + j;
                    if constexpr (kInfer) {
                        v = __ldg(reinterpret_cast<const float2*>((kLstm ? a.c0f : a.h0f) + o));
                    } else {
                        v = load_bf16x2((kLstm ? a.c0 : a.h0) + o);
                    }
                }
                carry[mt][uc][2 * half] = v.x;
                carry[mt][uc][2 * half + 1] = v.y;
            }

    for (int s = 0; s < stages - 1; ++s) {
        load_slice<WC>(a.whh, ring + s * kBK * WC, s % nk);
        cp_async_commit();
    }
    int slice = 0;  // slice c of the ring is W_hh^T slice c % nk, in slot c % stages
    __syncthreads();

    long long clk[3] = {0, 0, 0};
    for (int t = 0; t < a.T; ++t) {
        const bf16* cur = hbuf + (t & 1) * ROWS * HP;  // h_{t-1}
        bf16* nxt = hbuf + ((t + 1) & 1) * ROWS * HP;  // h_t
        const size_t step0 = (size_t)t * N + row0;     // row index of the tile's first row at t
#pragma unroll
        for (int uc = 0; uc < UC; ++uc) {
            const long long c0 = clock64();
            float acc[MT][kGates][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int g = 0; g < kGates; ++g)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][g][e] = 0.0f;

            // ---- this chunk's gates: acc = h_{t-1} . W_hh^T on the tensor cores ----
            for (int kc = 0; kc < kslices; ++kc, ++slice) {
                ring_wait(stages);
                __syncthreads();  // slice landed for all; the slot of slice - 1 is free
                {
                    const int c = slice + stages - 1;
                    load_slice<WC>(a.whh, ring + (c % stages) * kBK * WC, c % nk);
                    // the chunk's P joins the first slot's group: the last
                    // slots' waits cover it when the chunk has >= stages
                    // slices, else the wait below
                    if (kc == 0) load_p_chunk<ROWS, kGates>(a, ptile, step0, rows, uc * kChunk);
                    cp_async_commit();
                }
                const bf16* slot = ring + (slice % stages) * kBK * WC;
#pragma unroll
                for (int ks = 0; ks < kBK / 16; ++ks) {
                    uint32_t af[MT][4];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        const int col = kc * kBK + ks * 16 + (lane >> 4) * 8;
                        ldsm_x4(smem_addr(cur + walk_a_off(mt * 16 + (lane & 15), col, HP)),
                                af[mt]);
                    }
#pragma unroll
                    for (int g = 0; g < kGates; ++g) {
                        uint32_t b[2];
                        const int kk = ks * 16 + (lane & 15);
                        ldsm_x2_trans(smem_addr(slot + walk_b_off(kk, g * kWarps + warp, WC)), b);
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][g], af[mt], b[0], b[1]);
                    }
                }
            }
            if (kslices < stages) {
                cp_async_wait<0>();
                __syncthreads();
            }
            const long long c1 = clock64();

            // ---- the cell of the chunk's pairs: h_t into the next tile and the stashes ----
            const int j = uc * kChunk + warp * 8 + 2 * q;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = mt * 16 + gq + half * 8;
                    if (r >= rows || j >= H) continue;
                    float2 pv[kGates];
#pragma unroll
                    for (int g = 0; g < kGates; ++g) {
                        pv[g] = *reinterpret_cast<const float2*>(ptile + r * PS + g * kChunk +
                                                                 warp * 8 + 2 * q);
                    }
                    const unsigned h = cell_pair<kLstm, kGates, kInfer>(
                        a, step0 + r, j, pv, acc[mt], 2 * half, carry[mt][uc] + 2 * half,
                        t + 1 == a.T, (size_t)(row0 + r));
                    *reinterpret_cast<unsigned*>(nxt + walk_a_off(r, j, HP)) = h;
                }
            }
            const long long c2 = clock64();
            clk[0] += c1 - c0;
            clk[1] += c2 - c1;
        }
        __syncthreads();  // h_t is complete; every warp is done with h_{t-1} and P
    }
    cp_async_wait<0>();
    report_clocks(a, clk);
}

// ---------------------------------------------------------------------------
// The split walk
// ---------------------------------------------------------------------------

// A cluster of 16 CTAs walks a tile of 32 rows; CTA k owns units
// [k H/16, (k + 1) H/16) = [u0, u0 + 8 UT). Warp w = UT mt + ut holds m-tile
// mt and unit tile ut of every gate: lane (gq, q) the rows mt 16 + gq (+ 8)
// and units u0 + 8 ut + 2q (+ 1).
template <int UT, bool kLstm>
__global__ void __launch_bounds__(64 * UT, 1) train_walk_split_kernel(Args a) {
    namespace cg = cooperative_groups;
    constexpr int kGates = kLstm ? 4 : 3;
    constexpr int HC = 8 * UT;                           // units of one CTA
    constexpr int H = kSplitCtas * HC;
    constexpr int WP = (kGates * HC + 63) / 64 * 64;     // its W_hh^T row, padded for the swizzle
    constexpr int kCtaThreads = 64 * UT;
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    bf16* sw = reinterpret_cast<bf16*>(fsn_smem);  // [H][WP] its gate columns of W_hh^T
    bf16* sa = sw + H * WP;                        // [32][H] h_{t-1}, gathered
    bf16* own = sa + kSplitRows * H;               // [2][32][HC] its slice of h, by step parity

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
    const int mt = warp / UT;
    const int ut = warp - mt * UT;
    const int jl = ut * 8 + 2 * q;  // the pair's first unit, in the CTA's slice
    const int j = u0 + jl;

    const bf16* wsrc = a.whh + (size_t)rank * H * WP;
    for (int idx = threadIdx.x; idx < H * WP / 8; idx += kCtaThreads) {
        const int k = idx / (WP / 8);
        const int c8 = idx - k * (WP / 8);
        *reinterpret_cast<uint4*>(sw + walk_b_off(k, c8, WP)) =
            __ldg(reinterpret_cast<const uint4*>(wsrc + (size_t)k * WP + c8 * 8));
    }
    // the slices start at zero (rows past N stay so); h0 into parity 0
    for (int i = threadIdx.x; i < 2 * kSplitRows * HC / 8; i += kCtaThreads) {
        reinterpret_cast<uint4*>(own)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * (HC / 2); idx += kCtaThreads) {
        const int r = idx / (HC / 2);
        const int jj = 2 * (idx - r * (HC / 2));
        *reinterpret_cast<unsigned*>(own + r * HC + jj) =
            __ldg(reinterpret_cast<const unsigned*>(a.h0 + (size_t)(row0 + r) * H + u0 + jj));
    }
    float carry[2][2];  // the fp32 carry (LSTM c, GRU h) by half and unit
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + gq + half * 8;
        float2 v = make_float2(0.0f, 0.0f);
        if (r < rows) v = load_bf16x2((kLstm ? a.c0 : a.h0) + (size_t)(row0 + r) * H + j);
        carry[half][0] = v.x;
        carry[half][1] = v.y;
    }
    cluster_arrive();
    cluster_wait();  // every CTA's slice of h0 is written

    long long clk[3] = {0, 0, 0};
    for (int t = 0; t < a.T; ++t) {
        const long long c0 = clock64();
        const size_t step0 = (size_t)t * N + row0;
        // this thread's P[t], in flight during the exchange and the product
        float2 pv[2][kGates];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + gq + half * 8;
            const float* pr = a.p + (step0 + r) * (size_t)(kGates * H) + j;
#pragma unroll
            for (int g = 0; g < kGates; ++g) {
                pv[half][g] = r < rows ? __ldg(reinterpret_cast<const float2*>(pr + g * H))
                                       : make_float2(0.0f, 0.0f);
            }
        }
        // ---- the exchange: h_{t-1} from the parity-(t & 1) slices of all 16 CTAs ----
        const bf16* slices = own + (t & 1) * kSplitRows * HC;
        for (int idx = threadIdx.x; idx < kSplitRows * H / 8; idx += kCtaThreads) {
            const int r = idx / (H / 8);
            const int c8 = idx - r * (H / 8);
            const int k = c8 / UT;  // the CTA whose slice holds this 16-byte chunk
            const bf16* remote = cluster.map_shared_rank(slices, k);
            *reinterpret_cast<uint4*>(sa + walk_a_off(r, c8 * 8, H)) =
                *reinterpret_cast<const uint4*>(remote + r * HC + (c8 - k * UT) * 8);
        }
        __syncthreads();
        const long long c1 = clock64();

        // ---- this CTA's gates: acc = h_{t-1} . W_hh^T[:, its columns] ----
        float acc[kGates][4];
#pragma unroll
        for (int g = 0; g < kGates; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
#pragma unroll 4
        for (int ks = 0; ks < H / 16; ++ks) {
            uint32_t af[4];
            ldsm_x4(smem_addr(sa + walk_a_off(mt * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8, H)),
                    af);
#pragma unroll
            for (int g = 0; g < kGates; ++g) {
                uint32_t b[2];
                const int kk = ks * 16 + (lane & 15);
                ldsm_x2_trans(smem_addr(sw + walk_b_off(kk, g * UT + ut, WP)), b);
                mma_16816(acc[g], af, b[0], b[1]);
            }
        }
        const long long c2 = clock64();

        // ---- the cell of this thread's pairs: h_t into its slice and the stashes ----
        bf16* next = own + ((t + 1) & 1) * kSplitRows * HC;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = mt * 16 + gq + half * 8;
            if (r >= rows) continue;
            const unsigned h = cell_pair<kLstm, kGates>(a, step0 + r, j, pv[half], acc, 2 * half,
                                                        carry[half]);
            *reinterpret_cast<unsigned*>(next + r * HC + jl) = h;
        }
        const long long c3 = clock64();
        cluster_arrive();
        cluster_wait();  // the slices of h_t are written, and no CTA reads those of h_{t-1} now
        const long long c4 = clock64();
        clk[0] += c2 - c1;
        clk[1] += c3 - c2;
        clk[2] += (c1 - c0) + (c4 - c3);
    }
    report_clocks(a, clk);
}

size_t walk_smem(int rows, int uc, bool lstm, int stages) {
    const size_t wc = (size_t)(lstm ? 4 : 3) * kChunk;
    return sizeof(bf16) * (2 * (size_t)rows * uc * kChunk + (size_t)stages * kBK * wc) +
           sizeof(float) * rows * (wc + 8);
}

size_t split_smem(bool lstm, int H) {
    const size_t hc = H / kSplitCtas;
    const size_t wp = ((lstm ? 4 : 3) * hc + 63) / 64 * 64;
    return sizeof(bf16) * (H * wp + kSplitRows * H + 2 * kSplitRows * hc);
}

template <int ROWS, int UC, bool kLstm, bool kInfer>
cudaError_t launch_walk(const Args& a, cudaStream_t stream) {
    auto kernel = train_walk_kernel<ROWS, UC, kLstm, kInfer>;
    const size_t smem = walk_smem(ROWS, UC, kLstm, a.stages);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + ROWS - 1) / ROWS);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int ROWS, bool kLstm, bool kInfer>
cudaError_t walk_by_chunks(const Args& a, int uc, cudaStream_t stream) {
    switch (uc) {
        case 1: return launch_walk<ROWS, 1, kLstm, kInfer>(a, stream);
        case 2: return launch_walk<ROWS, 2, kLstm, kInfer>(a, stream);
        case 3: return launch_walk<ROWS, 3, kLstm, kInfer>(a, stream);
        case 4: return launch_walk<ROWS, 4, kLstm, kInfer>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <bool kLstm, bool kInfer = false>
cudaError_t walk_by_rows(const Args& a, int rows, int uc, cudaStream_t stream) {
    switch (rows) {
        case 16: return walk_by_chunks<16, kLstm, kInfer>(a, uc, stream);
        case 32: return walk_by_chunks<32, kLstm, kInfer>(a, uc, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <int UT, bool kLstm>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
    auto kernel = train_walk_split_kernel<UT, kLstm>;
    const size_t smem = split_smem(kLstm, a.H);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(kSplitCtas * ((a.N + kSplitRows - 1) / kSplitRows)), 1, 1);
    cfg.blockDim = dim3(64 * UT, 1, 1);
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

template <bool kLstm>
cudaError_t split_by_units(const Args& a, cudaStream_t stream) {
    switch (a.H) {
        case 128: return launch_split<1, kLstm>(a, stream);
        case 256: return launch_split<2, kLstm>(a, stream);
        case 384: return launch_split<3, kLstm>(a, stream);
        case 512: return launch_split<4, kLstm>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

Args make_args(const float* p, const void* whh, const float* b_hh, const void* h0, const void* c0,
               void* hs, void* cs, long long* clocks, int T, int N, int H) {
    Args a;
    a.p = p;
    a.whh = static_cast<const bf16*>(whh);
    a.b_hh = b_hh;
    a.h0 = static_cast<const bf16*>(h0);
    a.c0 = static_cast<const bf16*>(c0);
    a.hs = static_cast<bf16*>(hs);
    a.cs = static_cast<bf16*>(cs);
    a.h0f = a.c0f = nullptr;
    a.h_out = a.c_out = nullptr;
    a.clocks = clocks;
    a.T = T; a.N = N; a.H = H; a.Kp = (H + kBK - 1) / kBK * kBK; a.stages = 0;
    return a;
}

bool operands_ok(int lstm, const float* b_hh, const void* c0, const void* cs) {
    return lstm ? (c0 != nullptr && cs != nullptr) : b_hh != nullptr;
}

}  // namespace

// The streaming walk of one layer's training forward. lstm = 1: c0 and cs
// used, b_hh null; lstm = 0 (GRU): b_hh used. whh regrouped as
// [ceil(H/128)][Kp][gates x 128]; H a multiple of 4, at most 512; rows_per_block 16
// or 32; stages 2 to 6. clocks null, or [3] int64 for block 0's phase
// cycles. Returns a cudaError_t.
extern "C" int fsn_rnn_train_walk(int lstm, const float* p, const void* whh, const float* b_hh,
                                  const void* h0, const void* c0, void* hs, void* cs,
                                  long long* clocks, int T, int N, int H, int rows_per_block,
                                  int stages, void* stream) {
    if (T < 1 || N < 1 || H < 4 || H % 4 != 0 || H > 4 * kChunk || stages < 2 ||
        stages > kMaxStages || !operands_ok(lstm, b_hh, c0, cs)) {
        return (int)cudaErrorInvalidValue;
    }
    const int uc = (H + kChunk - 1) / kChunk;
    if (walk_smem(rows_per_block, uc, lstm != 0, stages) > 232448) {
        return (int)cudaErrorInvalidValue;
    }
    Args a = make_args(p, whh, b_hh, h0, c0, hs, cs, clocks, T, N, H);
    a.stages = stages;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? walk_by_rows<true>(a, rows_per_block, uc, s)
                      : walk_by_rows<false>(a, rows_per_block, uc, s));
}

// The split walk (clusters of 16 CTAs, 32 rows each), same operands as
// fsn_rnn_train_walk but whh regrouped as [16][H][WP]. H 128, 256, 384 or
// 512. Returns a cudaError_t.
extern "C" int fsn_rnn_train_walk_split(int lstm, const float* p, const void* whh,
                                        const float* b_hh, const void* h0, const void* c0,
                                        void* hs, void* cs, long long* clocks, int T, int N, int H,
                                        void* stream) {
    if (T < 1 || N < 1 || !operands_ok(lstm, b_hh, c0, cs)) return (int)cudaErrorInvalidValue;
    Args a = make_args(p, whh, b_hh, h0, c0, hs, cs, clocks, T, N, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? split_by_units<true>(a, s) : split_by_units<false>(a, s));
}

// The inference form of the streaming walk (K1-bf16 for many rows): the
// operands of fsn_rnn_train_walk but the state fp32, h0 and c0 (LSTM) in,
// h_out and c_out (LSTM) [N, H] out, and no c stash; the h stream hs bf16.
// Returns a cudaError_t.
extern "C" int fsn_rnn_fwd_stream_walk_bf16(int lstm, const float* p, const void* whh,
                                            const float* b_hh, const float* h0, const float* c0,
                                            void* hs, float* h_out, float* c_out,
                                            long long* clocks, int T, int N, int H,
                                            int rows_per_block, int stages, void* stream) {
    if (T < 1 || N < 1 || H < 4 || H % 4 != 0 || H > 4 * kChunk || stages < 2 ||
        stages > kMaxStages || h0 == nullptr || h_out == nullptr ||
        (lstm ? (c0 == nullptr || c_out == nullptr) : b_hh == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const int uc = (H + kChunk - 1) / kChunk;
    if (walk_smem(rows_per_block, uc, lstm != 0, stages) > 232448) {
        return (int)cudaErrorInvalidValue;
    }
    Args a = make_args(p, whh, b_hh, nullptr, nullptr, hs, nullptr, clocks, T, N, H);
    a.h0f = h0; a.c0f = c0; a.h_out = h_out; a.c_out = c_out;
    a.stages = stages;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? walk_by_rows<true, true>(a, rows_per_block, uc, s)
                      : walk_by_rows<false, true>(a, rows_per_block, uc, s));
}

extern "C" const char* fsn_train_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
