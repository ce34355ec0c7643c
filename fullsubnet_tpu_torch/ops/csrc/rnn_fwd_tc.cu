// The walk of the inference forward on a bf16 x (K1-bf16 for the LSTM,
// K1-GRU-bf16 for the GRU) on Hopper's tensor cores, for sm_90a.
//
// Replaces, with the GEMM of rnn_bwd_tc.cu (fsn_tc_gemm) for the input
// projections and the head, the TPU kernel
// fullsubnet_tpu/ops/subband_lstm.py:_kernel with _lstm_step or _gru_step,
// as launched by _infer_impl (its pl.pallas_call) on a bf16 x
// (compute_dtype = x.dtype): W_hh in bf16, h rounded to bf16 before each
// product with fp32 sums, the carry (LSTM c, GRU h for z * h) in fp32, the h
// stream passed on rounded to bf16, the state in and out in fp32. It computes
// what plain_lstm_fwd_walk_bf16 / plain_gru_fwd_walk_bf16
// (ops/subband_lstm.py) compute: from P [T, N, G H] (fp32, the biases in;
// the GRU's b_hh comes here, since r scales W_hn h + b_hn), the h stream
// [T, N, H] bf16 and (h_T, c_T) fp32. rnn_fwd.cu's cluster walk at bf16 and
// rnn_train_fwd_tc.cu's streaming inference form compute the same function;
// ops/subband_lstm.py (pick_fwd_bf16_form) picks among the three by shape.
//
// What bounds it on this card. Per step only h_{t-1} . W_hh^T is on the
// time chain: N x H x G H products, 2 N H G H FLOP (N = 320, H = 384, LSTM:
// 0.38 GFLOP a step, 0.4 us at the bf16 tensor-core peak). W_hh^T (1.18 MB
// in bf16 at H = 384) does not fit in one SM, so it is split over the 16
// CTAs of a cluster, each keeping its units' gate columns for the whole
// walk; then every CTA needs all of h_{t-1} at every step: the exchange of
// N H bf16 a step into each of the 16 CTAs, after a cluster barrier. P
// adds N G H fp32 a step from HBM (2 MB at N = 320). At few rows a step is
// a chain of latencies (gather, product, cell, barrier), not a rate.
//
// What the design does about each.
//   - The product runs on the tensor cores: mma.sync m16n8k16, bf16 from
//     ldmatrix, fp32 accumulators; no bf16 value is widened before it.
//     CTA k keeps W_hh rows g H + k H/16 + u (its units u < H/16 of each
//     gate g) in shared memory, [G H/16][H] bf16 with K contiguous and the
//     16-byte chunks XOR-swizzled by row (walk_a_off), so a non-transposed
//     ldmatrix gives the B fragments without bank conflicts: 72 KB a CTA
//     for the LSTM at H = 384, 128 KB at H = 512.
//   - A cluster walks row tiles of 16 MT rows (16 to 128). Warp w takes a
//     pair of m-tiles, 8 units of every gate (a unit tile) and a K slice:
//     the K slices (4, 2 or 1, tc_ksplit) keep a CTA at up to 16 warps, so
//     a tile of few rows still runs many short mma chains. The warps' fp32
//     partial sums go to shared memory (over the tile's gather buffer, read
//     by then), and every thread then runs the cell of up to 4 (row, unit
//     pair)s, consecutive threads on consecutive units: P, the carry and
//     the h stream move in whole sectors.
//   - One persistent wave: the wrapper launches as many clusters as the
//     card runs at once, each owning a band of tiles_per_cluster tiles, and
//     each walks all of its tiles at every step, with one cluster barrier a
//     step. With more than one tile, tile i + 1 is gathered into the second
//     gather buffer while tile i's partial sums are stored.
//   - The exchange: every CTA writes its units of h_t to the h stream in
//     global memory (the output) and to its own slice of the tile (bf16, by
//     step parity, rows padded to an odd number of 16-byte chunks against
//     bank conflicts), then meets the cluster barrier; a step gathers a
//     tile's h_{t-1} with 16-byte loads, four in flight a thread, from the
//     h stream through L2, and only h0 (the first step) and the rows past N
//     from the 16 slices through DSMEM. Gathering every row through DSMEM
//     was slower at every shape measured (N = 20 to 2,056 at H = 384, one
//     layer: 18.29 against 14.20 ms at N = 2,056, 10.09 against 8.62 at
//     N = 320; PERF.md §6): the SM-to-SM network moved a tile's rows more
//     slowly than L2 returned them.
//   - P of the next tile (or step) comes into the second of two P tiles
//     in shared memory by cp.async while this tile's exchange, product and
//     cell run; the fp32 carry of the band's rows stays in shared memory for
//     the whole walk. Nothing a cell reads waits in registers, so the 128
//     registers of a 16-warp CTA hold the accumulators and fragments.
//   clocks: block 0's cycles in the exchange (gathers, the syncs that wait
//   for them and the cluster barrier), the product (with its partial sums'
//   stores) and the cell with its stores.
//
// Layouts (contiguous): p [T, N, G H] fp32; whh = W_hh [G H, H] bf16 (PyTorch's
// layout, read as it is); bhh [G H] fp32 (GRU); h0, c0, h_out, c_out [N, H]
// fp32; hseq [T, N, H] bf16. H 128, 256, 384 or 512.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math).

#include <cooperative_groups.h>

#include "lstm_train_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace fsn;
namespace cg = cooperative_groups;

constexpr int kCtas = 16;           // CTAs of a cluster
constexpr int kTcMaxRows = 128;     // rows of a tile, at most: 8 m-tiles
constexpr int kTcMaxThreads = 512;  // 16 warps
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kGatherUnroll = 4;    // 16-byte DSMEM loads in flight a thread
constexpr int kCellPairs = 4;       // (row, unit pair)s a thread's cell takes, at most

struct TcArgs {
    const float* p;
    const bf16* whh;
    const float* bhh;
    const float* h0;
    const float* c0;
    bf16* hseq;
    float* h_out;
    float* c_out;
    long long* clocks;  // null, or [3]
    int T, N, rows, tpc, tiles, ksplit;
};

// the row pitch (bf16) of a CTA's h slice of 8 UT units: an odd number of
// 16-byte chunks, so 8 rows read or written at one column fall in 8 bank groups
__host__ __device__ constexpr int slice_pitch(int ut) {
    return 8 * (ut % 2 ? ut : ut + 1);
}

// the row stride (floats) of the partial sums [ksplit][rows][stride]: the
// CTA's G H/16 gate columns and 8 more, so the 8 rows of a warp's float2
// stores fall in other banks
__host__ __device__ constexpr int red_stride(int gates, int ut) {
    return gates * 8 * ut + 8;
}

// warps of a CTA at one K slice: a pair of m-tiles and a unit tile each
__host__ __device__ constexpr int tc_warps(int ut, int rows) {
    return ((rows / 16 + 1) / 2) * ut;
}

// K slices of the product: 4, 2 or 1, the most that keep a CTA at 16 warps
__host__ __device__ constexpr int tc_ksplit(int ut, int rows) {
    return tc_warps(ut, rows) * 4 <= 16 ? 4 : tc_warps(ut, rows) * 2 <= 16 ? 2 : 1;
}

// bytes of one tile buffer: the gathered h_{t-1} [rows][H] bf16, which after
// the product holds the partial sums [ksplit][rows][red_stride] fp32
__host__ __device__ constexpr size_t tc_buf_bytes(int gates, int ut, int rows) {
    return (size_t)rows * (2 * 128 * ut > 4 * tc_ksplit(ut, rows) * red_stride(gates, ut)
                               ? 2 * 128 * ut
                               : 4 * tc_ksplit(ut, rows) * red_stride(gates, ut));
}

// Gather a tile's h_{t-1} [rows][H] into dst (swizzled as the A operand):
// its first prev_rows rows from the h stream in global memory (prev: the
// tile's first row of h_{t-1}), which every CTA wrote before the cluster
// barrier, through L2; at the first step (prev null) and past prev_rows
// from the 16 CTAs' slices at src (the same offset in every CTA; chunk c8
// of a row lies in CTA c8 / UT) through DSMEM.
template <int UT>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, bf16* dst, const bf16* src,
                                       int rows, const bf16* prev, int prev_rows) {
    constexpr int H = kCtas * 8 * UT;
    constexpr int C8 = H / 8;
    constexpr int P = slice_pitch(UT);
    const int total = rows * C8;
    const int nthreads = blockDim.x;
    for (int base = threadIdx.x; base < total; base += kGatherUnroll * nthreads) {
        uint4 v[kGatherUnroll];
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
            const int idx = base + u * nthreads;
            if (idx < total) {
                const int r = idx / C8;
                const int c8 = idx - r * C8;
                if (prev != nullptr && r < prev_rows) {
                    v[u] = __ldcg(reinterpret_cast<const uint4*>(prev + (size_t)r * H + c8 * 8));
                } else {
                    const int k = c8 / UT;
                    const bf16* remote = cluster.map_shared_rank(src, k);
                    v[u] = *reinterpret_cast<const uint4*>(remote + r * P + (c8 - k * UT) * 8);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u) {
            const int idx = base + u * nthreads;
            if (idx < total) {
                const int r = idx / C8;
                const int c8 = idx - r * C8;
                *reinterpret_cast<uint4*>(dst + walk_a_off(r, c8 * 8, H)) = v[u];
            }
        }
    }
}

template <int UT, bool kLstm>
__global__ void __launch_bounds__(kTcMaxThreads, 1) fwd_walk_tc_kernel(TcArgs a) {
    constexpr int G = kLstm ? 4 : 3;
    constexpr int HC = 8 * UT;            // units of a CTA
    constexpr int H = kCtas * HC;
    constexpr int GH = G * H;
    constexpr int GC = G * HC;            // gate columns of a CTA
    constexpr int RS = red_stride(G, UT);
    constexpr int P = slice_pitch(UT);
    constexpr int KS = H / 16;            // k-steps of the product
    constexpr int PAIRS_ROW = HC / 2;     // unit pairs of a row in a CTA
    constexpr int P4 = GC / 4;            // 16-byte pieces of a row of the P tile
    extern __shared__ __align__(128) unsigned char fsn_smem[];
    const int rows = a.rows;
    const int tpc = a.tpc;
    const int ksplit = a.ksplit;
    const size_t buf_bytes = tc_buf_bytes(G, UT, rows);
    bf16* sw = reinterpret_cast<bf16*>(fsn_smem);              // [GC][H] its W_hh rows
    unsigned char* bufs = fsn_smem + sizeof(bf16) * GC * H;    // [1 or 2][buf_bytes]
    float* sp = reinterpret_cast<float*>(bufs + (tpc > 1 ? 2 : 1) * buf_bytes);
                                                               // [2][rows][GC] P of a tile
    float* carry = sp + 2 * rows * GC;                         // [tpc][rows][HC] the fp32 carry
    bf16* own = reinterpret_cast<bf16*>(carry + tpc * rows * HC);
                                                               // [2][tpc][rows][P] h slices
    float* sb = reinterpret_cast<float*>(own + 2 * tpc * rows * P);  // [GC] b_hh (GRU)

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int u0 = rank * HC;
    const int tile0 = (int)(blockIdx.x / kCtas) * tpc;
    const int nt = min(tpc, a.tiles - tile0);  // this cluster's tiles
    const int N = a.N;
    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gq = lane >> 2;
    const int q = lane & 3;
    // the warp's part of the product: unit tile ut, m-tile pair grp, K slice
    const int mts = rows / 16;
    const int groups = (mts + 1) / 2;
    const int ut = warp % UT;
    const int grp = (warp / UT) % groups;
    const int kslice = warp / (UT * groups);
    const int mt0 = 2 * grp;
    const bool two = mt0 + 1 < mts;        // the warp's second m-tile exists
    const int ksl = KS / ksplit;           // k-steps of a slice
    const int pairs = rows * PAIRS_ROW;    // (row, unit pair)s of a tile in this CTA

    for (int idx = tid; idx < GC * (H / 8); idx += nthreads) {
        const int n = idx / (H / 8);
        const int c8 = idx - n * (H / 8);
        const int g = n / HC;
        const size_t src = (size_t)(g * H + u0 + n - g * HC) * H + c8 * 8;
        *reinterpret_cast<uint4*>(sw + walk_a_off(n, c8 * 8, H)) =
            __ldg(reinterpret_cast<const uint4*>(a.whh + src));
    }
    if constexpr (!kLstm) {
        for (int idx = tid; idx < GC; idx += nthreads) {
            sb[idx] = a.bhh[(idx / HC) * H + u0 + idx % HC];
        }
    }
    // the slices start at zero (rows past N stay so); h0 rounded into parity
    // 0, and the carry (LSTM c0, GRU h0) in fp32
    for (int i = tid; i < 2 * tpc * rows * P / 8; i += nthreads) {
        reinterpret_cast<uint4*>(own)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int idx = tid; idx < tpc * pairs; idx += nthreads) {
        const int r = idx / PAIRS_ROW;  // row of the band
        const int jl = 2 * (idx - r * PAIRS_ROW);
        const int row = tile0 * rows + r;
        float2 c = make_float2(0.0f, 0.0f);
        if (row < N) {
            const size_t o = (size_t)row * H + u0 + jl;
            const float2 h = __ldg(reinterpret_cast<const float2*>(a.h0 + o));
            *reinterpret_cast<unsigned*>(own + r * P + jl) = pack_bf16x2(h.x, h.y);
            c = kLstm ? __ldg(reinterpret_cast<const float2*>(a.c0 + o)) : h;
        }
        *reinterpret_cast<float2*>(carry + r * HC + jl) = c;
    }

    // P of tile i of the band at step t into P tile buffer `par` by
    // cp.async (zeros past N), as one group
    auto stage_p = [&](int par, int t, int i) {
        for (int idx = tid; idx < rows * P4; idx += nthreads) {
            const int r = idx / P4;
            const int c4 = idx - r * P4;
            const int g = c4 / (HC / 4);
            const int uo = (c4 - g * (HC / 4)) * 4;
            const int row = (tile0 + i) * rows + r;
            const bool ok = row < N;
            const float* src = ok ? a.p + ((size_t)t * N + row) * GH + g * H + u0 + uo : a.p;
            cp_async_16(smem_addr(sp + (par * rows + r) * GC + g * HC + uo), src, ok);
        }
        cp_async_commit();
    };

    stage_p(0, 0, 0);
    cluster_arrive();
    cluster_wait();  // every CTA's weights and h0 slices are in place

    const int arow = mt0 * 16 + (lane & 15);
    const int acol = (lane >> 4) * 8;
    const int brow = ut * 8 + (lane & 7);
    const int bcol = ((lane >> 3) & 1) * 8;
    const int bgate = lane >> 4;
    long long clk[3] = {0, 0, 0};
    const int band = tpc * rows * P;  // elements of one parity's slices
    int seq = 0;                      // tiles walked so far: P tile buffer seq & 1
    for (int t = 0; t < a.T; ++t) {
        const bf16* cur = own + (t & 1) * band;   // h_{t-1}
        bf16* nxt = own + ((t + 1) & 1) * band;   // h_t
        const long long c0 = clock64();
        // the h stream of step t - 1 (null at the first step): rows of the
        // band's tile i start at prev + i rows H
        const bf16* prev = t > 0 ? a.hseq + ((size_t)(t - 1) * N + (size_t)tile0 * rows) * H
                                 : nullptr;
        gather<UT>(cluster, reinterpret_cast<bf16*>(bufs), cur, rows, prev,
                   N - tile0 * rows);
        __syncthreads();
        clk[0] += clock64() - c0;
        for (int i = 0; i < nt; ++i, ++seq) {
            unsigned char* buf = bufs + (i & 1) * buf_bytes;
            const long long c1 = clock64();
            // ---- the warp's part of h_{t-1} . W_hh^T: its m-tiles, unit tile, K slice ----
            float acc[2][G][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][g][e] = 0.0f;
            const bf16* A = reinterpret_cast<const bf16*>(buf);
#pragma unroll 2
            for (int s = 0; s < ksl; ++s) {
                const int kk = (kslice * ksl + s) * 16;
                uint32_t a0[4], a1[4] = {0u, 0u, 0u, 0u}, b[G][2];
                ldsm_x4(smem_addr(A + walk_a_off(arow, kk + acol, H)), a0);
                if (two) ldsm_x4(smem_addr(A + walk_a_off(arow + 16, kk + acol, H)), a1);
#pragma unroll
                for (int g = 0; g + 1 < G; g += 2) {
                    uint32_t r4[4];
                    ldsm_x4(smem_addr(sw + walk_a_off((g + bgate) * HC + brow, kk + bcol, H)), r4);
                    b[g][0] = r4[0];
                    b[g][1] = r4[1];
                    b[g + 1][0] = r4[2];
                    b[g + 1][1] = r4[3];
                }
                if constexpr (G % 2 == 1) {
                    ldsm_x2(smem_addr(sw + walk_a_off((G - 1) * HC + brow, kk + bcol, H)),
                            b[G - 1]);
                }
#pragma unroll
                for (int g = 0; g < G; ++g) mma_16816(acc[0][g], a0, b[g][0], b[g][1]);
                if (two) {
#pragma unroll
                    for (int g = 0; g < G; ++g) mma_16816(acc[1][g], a1, b[g][0], b[g][1]);
                }
            }
            // every warp has read the gathered tile (it takes the partials)
            // and is past the last cell (its P tile buffer takes the next P)
            __syncthreads();
            if (i + 1 < nt) {
                stage_p((seq + 1) & 1, t, i + 1);
            } else if (t + 1 < a.T) {
                stage_p((seq + 1) & 1, t + 1, 0);
            } else {
                cp_async_commit();
            }
            float* red = reinterpret_cast<float*>(buf);  // [ksplit][rows][RS]
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                if (m == 1 && !two) break;
                const int r0 = (mt0 + m) * 16 + gq;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    float* dst = red + (size_t)(kslice * rows + r0) * RS + g * HC + ut * 8 + 2 * q;
                    *reinterpret_cast<float2*>(dst) = make_float2(acc[m][g][0], acc[m][g][1]);
                    *reinterpret_cast<float2*>(dst + 8 * RS) =
                        make_float2(acc[m][g][2], acc[m][g][3]);
                }
            }
            const long long c2 = clock64();
            if (i + 1 < nt) {
                gather<UT>(cluster, reinterpret_cast<bf16*>(bufs + ((i + 1) & 1) * buf_bytes),
                           cur + (i + 1) * rows * P, rows,
                           prev ? prev + (size_t)(i + 1) * rows * H : nullptr,
                           N - (tile0 + i + 1) * rows);
            }
            cp_async_wait<1>();  // this tile's P (all groups but the newest)
            __syncthreads();     // the partials and P in place (and the next tile gathered)
            const long long c3 = clock64();
            // ---- the cell of this thread's pairs: h_t into the slice, the h stream, the carry ----
            const float* pt = sp + (seq & 1) * rows * GC;
            float* ct = carry + i * rows * HC;
            bf16* next = nxt + i * rows * P;
#pragma unroll
            for (int c = 0; c < kCellPairs; ++c) {
                const int pi = tid + c * nthreads;
                if (pi >= pairs) break;
                const int r = pi / PAIRS_ROW;
                const int jl = 2 * (pi - r * PAIRS_ROW);
                const int row = (tile0 + i) * rows + r;
                float pre[G][2], hw[G][2];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float2 pg = *reinterpret_cast<const float2*>(pt + r * GC + g * HC + jl);
                    float2 v = *reinterpret_cast<const float2*>(red + (size_t)r * RS + g * HC + jl);
                    for (int ks = 1; ks < ksplit; ++ks) {
                        const float2 w = *reinterpret_cast<const float2*>(
                            red + (size_t)(ks * rows + r) * RS + g * HC + jl);
                        v.x += w.x;
                        v.y += w.y;
                    }
                    if constexpr (!kLstm) {
                        v.x += sb[g * HC + jl];
                        v.y += sb[g * HC + jl + 1];
                    }
                    pre[g][0] = pg.x;
                    pre[g][1] = pg.y;
                    hw[g][0] = v.x;
                    hw[g][1] = v.y;
                }
                float2* cp = reinterpret_cast<float2*>(ct + r * HC + jl);
                float cr[2] = {cp->x, cp->y};
                float hv[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float pe[G], he[G];
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        pe[g] = pre[g][e];
                        he[g] = hw[g][e];
                    }
                    hv[e] = cell_update<kLstm>(pe, he, cr[e]);
                }
                *cp = make_float2(cr[0], cr[1]);
                const unsigned h = pack_bf16x2(hv[0], hv[1]);
                *reinterpret_cast<unsigned*>(next + r * P + jl) = h;
                if (row < N) {
                    const size_t o = (size_t)row * H + u0 + jl;
                    *reinterpret_cast<unsigned*>(a.hseq + (size_t)t * N * H + o) = h;
                    if (t + 1 == a.T) {
                        *reinterpret_cast<float2*>(a.h_out + o) = make_float2(hv[0], hv[1]);
                        if constexpr (kLstm) {
                            *reinterpret_cast<float2*>(a.c_out + o) = make_float2(cr[0], cr[1]);
                        }
                    }
                }
            }
            const long long c4 = clock64();
            clk[0] += c3 - c2;
            clk[1] += c2 - c1;
            clk[2] += c4 - c3;
        }
        const long long c5 = clock64();
        cluster_arrive();
        cluster_wait();  // every slice of h_t is written; no CTA reads those of h_{t-1} now
        clk[0] += clock64() - c5;
    }
    cp_async_wait<0>();
    if (a.clocks != nullptr && blockIdx.x == 0 && tid == 0) {
        a.clocks[0] = clk[0];
        a.clocks[1] = clk[1];
        a.clocks[2] = clk[2];
    }
}

// bytes of dynamic shared memory of the instance (G, H) at `rows` rows a
// tile and `tpc` tiles a cluster
size_t tc_smem(bool lstm, int H, int rows, int tpc) {
    const int g = lstm ? 4 : 3;
    const int ut = H / kCtas / 8;
    const size_t gc = (size_t)g * 8 * ut;
    const size_t nbuf = tpc > 1 ? 2 : 1;
    return sizeof(bf16) * (gc * H + 2 * (size_t)tpc * rows * slice_pitch(ut)) +
           nbuf * tc_buf_bytes(g, ut, rows) +
           sizeof(float) * (2 * rows * gc + (size_t)tpc * rows * 8 * ut + (lstm ? 0 : gc));
}

// launch (max_clusters null) or ask how many clusters of this instance and
// configuration fit on the card at once
template <int UT, bool kLstm>
cudaError_t tc_run(const TcArgs& a, cudaStream_t stream, int* max_clusters) {
    constexpr int H = kCtas * 8 * UT;
    auto kernel = fwd_walk_tc_kernel<UT, kLstm>;
    const size_t smem = tc_smem(kLstm, H, a.rows, a.tpc);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int clusters = max_clusters ? 1 : (a.tiles + a.tpc - 1) / a.tpc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(kCtas * clusters), 1, 1);
    cfg.blockDim = dim3((unsigned)(32 * tc_warps(UT, a.rows) * a.ksplit), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool kLstm>
cudaError_t tc_by_hidden(const TcArgs& a, int H, cudaStream_t stream, int* max_clusters) {
    switch (H) {
        case 128: return tc_run<1, kLstm>(a, stream, max_clusters);
        case 256: return tc_run<2, kLstm>(a, stream, max_clusters);
        case 384: return tc_run<3, kLstm>(a, stream, max_clusters);
        case 512: return tc_run<4, kLstm>(a, stream, max_clusters);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t tc_dispatch(bool lstm, TcArgs& a, int H, cudaStream_t stream, int* max_clusters) {
    if (H % 128 != 0 || H < 128 || H > 512 || a.rows < 16 || a.rows > kTcMaxRows ||
        a.rows % 16 != 0 || a.tpc < 1 || a.N < 1 || a.T < 1 ||
        tc_smem(lstm, H, a.rows, a.tpc) > (size_t)kSmemLimit) {
        return cudaErrorInvalidValue;
    }
    const int ut = H / kCtas / 8;
    a.tiles = (a.N + a.rows - 1) / a.rows;
    a.ksplit = tc_ksplit(ut, a.rows);
    return lstm ? tc_by_hidden<true>(a, H, stream, max_clusters)
                : tc_by_hidden<false>(a, H, stream, max_clusters);
}

}  // namespace

// One layer's walk of K1-bf16 (lstm = 1) or K1-GRU-bf16 (lstm = 0) over T
// steps: p fp32, whh = W_hh [G H, H] bf16, bhh [G H] fp32 (GRU; null for the
// LSTM), h0 and c0 (LSTM) fp32 in, hseq bf16 and h_out, c_out (LSTM) fp32 out.
// H 128, 256, 384 or 512; rows a tile 16 to 128, a multiple of 16;
// tiles_per_cluster >= 1 (the band each cluster walks; ceil(ceil(N / rows) /
// tiles_per_cluster) clusters are launched). clocks null, or [3] int64.
// Returns a cudaError_t.
extern "C" int fsn_rnn_fwd_walk_tc_bf16(int lstm, const float* p, const void* whh,
                                        const float* bhh, const float* h0, const float* c0,
                                        void* hseq, float* h_out, float* c_out,
                                        long long* clocks, int T, int N, int H, int rows,
                                        int tiles_per_cluster, void* stream) {
    if (h0 == nullptr || h_out == nullptr ||
        (lstm ? (c0 == nullptr || c_out == nullptr) : bhh == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    TcArgs a = {};
    a.p = p; a.whh = static_cast<const bf16*>(whh); a.bhh = bhh; a.h0 = h0; a.c0 = c0;
    a.hseq = static_cast<bf16*>(hseq); a.h_out = h_out; a.c_out = c_out; a.clocks = clocks;
    a.T = T; a.N = N; a.rows = rows; a.tpc = tiles_per_cluster;
    return (int)tc_dispatch(lstm != 0, a, H, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the instance (cell, H) at `rows` rows a tile and
// `tiles_per_cluster` tiles a cluster the current card runs at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int fsn_rnn_fwd_max_clusters_tc_bf16(int lstm, int H, int rows, int tiles_per_cluster,
                                                int* out) {
    TcArgs a = {};
    a.T = 1; a.N = rows; a.rows = rows; a.tpc = tiles_per_cluster;
    *out = 0;
    return (int)tc_dispatch(lstm != 0, a, H, nullptr, out);
}

extern "C" const char* fsn_rnn_fwd_tc_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
