// The walk over time of one LSTM or GRU layer's backward at fp32 storage
// (stage 2 of K3 and K4 at fp32), for Hopper (sm_90a).
//
// Replaces, together with fsn_fwd_gemm (rnn_fwd.cu) for stages 1 and 3,
// the TPU kernels fullsubnet_tpu/ops/subband_lstm.py:_lstm_layer_bwd_kernel
// and _gru_layer_bwd_kernel, as launched by _pallas_layer_bwd (the
// pl.pallas_call of the per-layer backward), in their split-dW form at fp32
// storage. The Python side (ops/subband_lstm.py, _lstm_backward_stages /
// _gru_backward_stages) runs per layer: fsn_fwd_gemm for the gate
// pre-activations P = [x | h_prev] . W + b over all T*N rows (h_prev is the
// h stash one block of N rows back, h0 first: a row offset, not a copy),
// this walk, and fsn_fwd_gemm for dx = dgates . W_ih (GRU: dxw . W_ih). The
// earlier fp32 kernels (lstm_layer_bwd.cu, gru_layer_bwd.cu) did all three
// products inside the time loop. Initial states and incoming carries are
// arguments, so a time-chunked backward can chain calls.
//
// What bounds it on this card. Per step the walk does the cell backward of
// _lstm_layer_bwd_kernel (or _gru_layer_bwd_kernel) from P[t], the stash
// and dh[t], and the one product on the reverse-time chain: the next dh
// carry dgates . W_hh (GRU: dh_tot z + dhw . W_hh), N x G H x H FMAs a step
// on the fp32 cores (TF32 would change the results). Its weights W_hh (4 MB
// for the LSTM at H = 512, 2.4 MB at H = 384) do not fit in one SM's
// 227 KB, and every step needs all of them.
//
// What the design does about it. A cluster of 16 CTAs walks a tile of RT
// rows (1 to 16). CTA k owns the units [k H/16, (k + 1) H/16) and keeps the
// rows of W_hh of their G gates, C = G H/16 rows of H (the torch layout
// [G H, H], read once at the start), resident for the whole walk: in shared
// memory, and for the widest stack (LSTM, H = 512: 256 KB a CTA) the first
// KR = 8 rows of each K slice in registers. Per step:
//   1. the cell backward of the CTA's (row, unit) pairs, one a thread, the
//      dc carry in its register; dgates (GRU dxw and dhw) go to their
//      streams and the product's operand (GRU: dhw) to shared memory. The
//      pair's inputs of step t-1 are loaded during the product of step t;
//   2. the partial carries partial_k = dgates_k . W_hh_k [RT, H]: a thread
//      owns 4 columns of all RT rows and one of 4 K slices (the slices of a
//      column group are lanes 8 apart of one warp), so a float4 of
//      dgates feeds 16 FMAs; the slices are summed by warp shuffles,
//      halving twice, each lane keeping a quarter of the outputs;
//   3. the cluster reduce-scatters the partials through distributed shared
//      memory: the thread of pair (row, unit j) sums the 16 CTAs' partials
//      of column j, in rank order, with one cluster barrier a step and a
//      split arrive/wait around the reads.
// A tile picker (ops/subband_lstm.py, pick_bwd_f32_tile) takes the smallest
// tile that walks every row in one wave of the clusters the card runs at
// once (cudaOccupancyMaxActiveClusters), else the largest that fits.
// Where that is more than one wave and H is at most 384 (the sub-band
// stage), the streaming form runs instead (bwd_f32_streams): one block of 16
// rows holds every unit and streams W_hh from L2 through a 2-slot cp.async
// ring at every step, with no cluster.
//
// Layouts (all fp32, contiguous unless a leading dimension is given).
//   p [T, N, 4H] (LSTM i, f, g, o; GRU r, z, n's x part, hn = W_hn h + b_hn);
//   dh, stash [T, N, H] (stash: LSTM c, GRU h); init [N, H] (c0, or h0);
//   whh = W_hh [G H, H] with row stride ldw; dh_in, dc_in, dh_out, dc_out
//   [N, H]; out0 [T, N, G H] (dgates, or dxw); out1 [T, N, 3H] (dhw, GRU).
//   H a multiple of 16, at most 512: H rounded up to 32 threads a CTA.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math: expf/tanhf
//             keep the fp32 results close to the CPU path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kCtas = 16;        // CTAs of a cluster
constexpr int kSlices = 4;       // K slices of the carry product
constexpr int kMaxThreads = 512; // H rounded up to a warp: threads a CTA
constexpr int kRegRows = 8;      // the KR of the register-holding instances
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `full` false nothing is read and the
// bytes are zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

struct WalkArgs {
    const float* p;
    const float* dh;
    const float* stash;
    const float* init;
    const float* whh;
    const float* dh_in;
    const float* dc_in;
    float* out0;
    float* out1;
    float* dh_out;
    float* dc_out;
    long long* clocks;  // null, or [3]: block 0's cycles in the cell backward, the
                        // product and the cluster exchange, over all steps
    int T, N, H, ldw;
};

// the widths of one CTA's cotangent tile: C = G H/16 columns, padded with
// zeros to CP (a multiple of 16), CS = CP/4 of them in each K slice
__host__ __device__ __forceinline__ int tile_cp(bool lstm, int H) {
    return ((lstm ? 4 : 3) * (H / kCtas) + 15) / 16 * 16;
}

// The loads of one (row, unit) pair at step t: the four pre-activations,
// dh_t, (LSTM) c_t, and the state before the step (LSTM c_{t-1}, GRU
// h_{t-1}; at t = 0 the initial state stands for the stash).
struct PairIn {
    float p[4];
    float dh, cur, prev;
};

template <bool kLstm>
__device__ __forceinline__ void load_pair(const WalkArgs& a, int t, int grow, int j, PairIn& v) {
    const int H = a.H;
    const size_t row = (size_t)t * a.N + grow;
    const float* pr = a.p + row * (size_t)(4 * H) + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) v.p[k] = __ldg(pr + k * H);
    v.dh = __ldg(a.dh + row * H + j);
    if constexpr (kLstm) v.cur = __ldg(a.stash + row * H + j);
    v.prev = t > 0 ? __ldg(a.stash + (row - a.N) * H + j) : __ldg(a.init + (size_t)grow * H + j);
}

// The cell backward of _lstm_layer_bwd_kernel / _gru_layer_bwd_kernel for
// one pair: from its loads and the dh carry into step t, the cotangents d
// (LSTM dgates i, f, g, o; GRU dr, dz, dn, dn r); updates the LSTM's dc
// carry; returns the start of the next dh carry (LSTM 0, GRU dh_tot z).
template <bool kLstm>
__device__ __forceinline__ float cell_backward(const PairIn& v, float carry, float& dcc,
                                               float (&d)[4]) {
    const float dh_tot = v.dh + carry;
    if constexpr (kLstm) {
        const float ig = sigmoid_f(v.p[0]);
        const float fg = sigmoid_f(v.p[1]);
        const float gg = tanhf(v.p[2]);
        const float og = sigmoid_f(v.p[3]);
        const float tc = tanhf(v.cur);
        const float dc = dcc + dh_tot * og * (1.0f - tc * tc);
        d[0] = (dc * gg) * ig * (1.0f - ig);
        d[1] = (dc * v.prev) * fg * (1.0f - fg);
        d[2] = (dc * ig) * (1.0f - gg * gg);
        d[3] = (dh_tot * tc) * og * (1.0f - og);
        dcc = dc * fg;
        return 0.0f;
    } else {
        const float rg = sigmoid_f(v.p[0]);
        const float zg = sigmoid_f(v.p[1]);
        const float hn = v.p[3];
        const float ng = tanhf(v.p[2] + rg * hn);
        const float dz = dh_tot * (v.prev - ng);
        const float dn = (dh_tot * (1.0f - zg)) * (1.0f - ng * ng);
        d[0] = (dn * hn) * rg * (1.0f - rg);
        d[1] = dz * zg * (1.0f - zg);
        d[2] = dn;
        d[3] = dn * rg;
        return dh_tot * zg;
    }
}

// A thread's 4 K slices' sums of its RT x 4 outputs, halving twice over
// lanes 16 and 8 apart: the lane of slice s keeps outputs v = s RT + i
// (row v / 4, column v % 4) in q[i].
template <int RT>
__device__ __forceinline__ void reduce_slices(const float (&acc)[RT][4], int s, float (&q)[RT]) {
    constexpr int V = 4 * RT;
    float halves[V / 2];
    const bool up1 = (s & 2) != 0;
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
        const float lo = acc[i / 4][i % 4];
        const float hi = acc[(i + V / 2) / 4][(i + V / 2) % 4];
        halves[i] = (up1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, up1 ? lo : hi, 16);
    }
    const bool up0 = (s & 1) != 0;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const float lo = halves[i];
        const float hi = halves[i + RT];
        q[i] = (up0 ? hi : lo) + __shfl_xor_sync(0xffffffffu, up0 ? lo : hi, 8);
    }
}

// acc[r][e] += sum over k < 4 of a[r][k] w[k][e]: 4 rows of W (columns
// col .. col + 3) against a float4 of each row's cotangents
template <int RT>
__device__ __forceinline__ void fma_quad(float (&acc)[RT][4], const float* a, int lda,
                                         const float4 (&w)[4]) {
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(a + rr * lda);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
            acc[rr][0] = fmaf(ak[kq], w[kq].x, acc[rr][0]);
            acc[rr][1] = fmaf(ak[kq], w[kq].y, acc[rr][1]);
            acc[rr][2] = fmaf(ak[kq], w[kq].z, acc[rr][2]);
            acc[rr][3] = fmaf(ak[kq], w[kq].w, acc[rr][3]);
        }
    }
}

template <int RT, bool kLstm, int KR>
__global__ void __launch_bounds__(kMaxThreads, 1) rnn_bwd_f32_walk_kernel(WalkArgs a) {
    constexpr int G = kLstm ? 4 : 3;
    constexpr int V = 4 * RT;  // a thread's outputs of the product: RT rows x 4 columns
    static_assert(RT >= 1 && RT <= 16, "a tile of 1 to 16 rows: one pair a thread");
    const int H = a.H;
    const int HC = H / kCtas;
    const int C = G * HC;
    const int CP = tile_cp(kLstm, H);
    const int CS = CP / kSlices;
    const int KS = CS - KR;  // rows of each K slice in shared memory
    const int nthreads = blockDim.x;

    extern __shared__ __align__(16) float fsn_bwd_f32_smem[];
    float* sW = fsn_bwd_f32_smem;     // [4][KS][H] this CTA's W_hh rows beyond KR of each slice
    float* sA = sW + kSlices * KS * H;  // [RT][CP] the cotangents of step t (GRU: dhw)
    float* part = sA + RT * CP;       // [RT][H] the partial carries

    cg::cluster_group cluster = cg::this_cluster();
    const int u0 = (int)cluster.block_rank() * HC;
    const int row0 = (int)(blockIdx.x / kCtas) * RT;
    const int rows = min(RT, a.N - row0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int s = lane >> 3;                          // the K slice of the product
    const int col = 4 * ((tid >> 5) * 8 + (lane & 7));  // its 4 columns
    const bool has_col = col < H;  // H not a multiple of 32 leaves the last warp's lanes idle

    // local row c of the CTA's weights is W_hh row (c / HC) H + u0 + c % HC;
    // rows C .. CP are zeros
    auto w_at = [&](int c, int k) -> float {
        return c < C ? __ldg(a.whh + (size_t)((c / HC) * H + u0 + c % HC) * a.ldw + k) : 0.0f;
    };
    float4 wreg[KR > 0 ? KR : 1];
#pragma unroll
    for (int i = 0; i < KR; ++i) {
        const int c = has_col ? s * CS + i : C;
        wreg[i] = make_float4(w_at(c, col), w_at(c, col + 1), w_at(c, col + 2), w_at(c, col + 3));
    }
    for (int idx = tid; idx < kSlices * KS * H; idx += nthreads) {
        const int k = idx / H;
        const int ss = k / KS;
        sW[idx] = w_at(ss * CS + KR + k - ss * KS, idx - k * H);
    }
    for (int idx = tid; idx < RT * CP; idx += nthreads) sA[idx] = 0.0f;

    // this thread's pair: row r, unit u0 + u
    const int r = tid / HC;
    const int u = tid - r * HC;
    const int j = u0 + u;
    const bool active = tid < RT * HC;
    const bool real = active && r < rows;
    float carry = 0.0f;  // the dh carry into step t
    float dcc = 0.0f;    // the dc carry (LSTM)
    PairIn v = {};
    if (real) {
        const size_t o = (size_t)(row0 + r) * H + j;
        carry = __ldg(a.dh_in + o);
        if constexpr (kLstm) dcc = __ldg(a.dc_in + o);
        load_pair<kLstm>(a, a.T - 1, row0 + r, j, v);
    }
    __syncthreads();
    cluster_arrive();  // pairs with the first wait below

    long long clk[3] = {0, 0, 0};
    for (int t = a.T - 1; t >= 0; --t) {
        const long long c0 = clock64();
        // ---- the cell backward of step t (rows past N keep zeros) ----
        float next = 0.0f;  // the start of the next dh carry: LSTM 0, GRU dh_tot z
        if (active) {
            float d[4];
            next = cell_backward<kLstm>(v, carry, dcc, d);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                sA[r * CP + g * HC + u] = d[(!kLstm && g == 2) ? 3 : g];
            }
            if (real) {
                const size_t row = (size_t)t * a.N + row0 + r;
                float* o0 = a.out0 + row * (size_t)(G * H) + j;
#pragma unroll
                for (int g = 0; g < G; ++g) o0[g * H] = d[g];
                if constexpr (!kLstm) {
                    float* o1 = a.out1 + row * (size_t)(3 * H) + j;
                    o1[0] = d[0];
                    o1[H] = d[1];
                    o1[2 * H] = d[3];
                }
            }
        }
        __syncthreads();  // the cotangent tile is complete
        const long long c1 = clock64();
        if (real && t > 0) load_pair<kLstm>(a, t - 1, row0 + r, j, v);  // in flight meanwhile

        // ---- partial = cotangents . W_hh rows of this CTA, K slice s ----
        float acc[RT][4];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rr][e] = 0.0f;
        const float* as = sA + s * CS;
#pragma unroll
        for (int i = 0; i < KR; i += 4) {
            const float4 w[4] = {wreg[i], wreg[i + 1], wreg[i + 2], wreg[i + 3]};
            fma_quad<RT>(acc, as + i, CP, w);
        }
        const float* wsl = sW + s * KS * H + col;
        // a body of RT x 16 independent FMAs; unrolling the wide tiles
        // further only spills
#pragma unroll(RT >= 8 ? 1 : 2)
        for (int i = KR; i < (has_col ? CS : KR); i += 4) {
            float4 w[4];
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
                w[kq] = *reinterpret_cast<const float4*>(wsl + (i - KR + kq) * H);
            }
            fma_quad<RT>(acc, as + i, CP, w);
        }
        float quarter[RT];
        reduce_slices<RT>(acc, s, quarter);
        const long long c2 = clock64();

        // ---- the reduce-scatter over the cluster ----
        cluster_wait();  // every CTA has read the partials of step t + 1
        if (has_col) {
            if constexpr (RT >= 4) {
#pragma unroll
                for (int q = 0; q < RT / 4; ++q) {
                    *reinterpret_cast<float4*>(part + (s * (RT / 4) + q) * H + col) =
                        make_float4(quarter[4 * q], quarter[4 * q + 1], quarter[4 * q + 2],
                                    quarter[4 * q + 3]);
                }
            } else {
#pragma unroll
                for (int i = 0; i < RT; ++i) {
                    const int vi = s * RT + i;
                    part[(vi >> 2) * H + col + (vi & 3)] = quarter[i];
                }
            }
        }
        cluster_arrive();
        cluster_wait();  // the partials of step t are written, cluster-wide
        if (active) {
            float sum = next;
#pragma unroll
            for (int k = 0; k < kCtas; ++k) {
                const float* remote = cluster.map_shared_rank(part, k);
                sum += remote[r * H + j];
            }
            carry = sum;
        }
        cluster_arrive();  // done reading the partials of step t
        const long long c3 = clock64();
        clk[0] += c1 - c0;
        clk[1] += c2 - c1;
        clk[2] += c3 - c2;
    }
    cluster_wait();  // no CTA leaves while another may still read its partials
    if (a.clocks != nullptr && blockIdx.x == 0 && tid == 0) {
        a.clocks[0] = clk[0];
        a.clocks[1] = clk[1];
        a.clocks[2] = clk[2];
    }
    if (real) {
        const size_t o = (size_t)(row0 + r) * H + j;
        a.dh_out[o] = carry;
        if constexpr (kLstm) a.dc_out[o] = dcc;
    }
}

// ---------------------------------------------------------------------------
// The streaming walk, for many rows: one block of kStreamRows rows holds
// all H units, so no step needs its cluster; W_hh streams from L2 through
// a ring of chunks at every step.
// ---------------------------------------------------------------------------

constexpr int kStreamRows = 16;         // rows of one block
constexpr int kStreamMaxThreads = 384;  // H rounded up to a warp: threads a block
constexpr int kChunkRows = 8;           // W_hh rows of each K slice in one ring slot
constexpr int kRing = 2;                // slots of the ring (a third times the same)

// the K depth of the streaming product: G H rows of W_hh, zero-padded to a
// whole number of chunks in each of the 4 slices
__host__ __device__ __forceinline__ int stream_kp(bool lstm, int H) {
    const int q = kSlices * kChunkRows;
    return ((lstm ? 4 : 3) * H + q - 1) / q * q;
}

// Thread (s, column group) owns, as in the cluster walk, 4 columns of the
// product and K slice s; after the slices' shuffle sum it holds the next
// dh carry of rows 4 s .. 4 s + 3 at those columns, and it does the cell
// backward of exactly those 16 (row, unit) pairs: the carries never leave
// its registers. W_hh [G H, H] (contiguous, 16-byte rows) streams through a
// ring of kRing slots [4][kChunkRows][H]; chunk k of a step holds rows
// s KSL + k kChunkRows .. + kChunkRows of each slice s, and the ring runs on
// across steps, so the next step's first chunks load during the cell
// backward. The step's inputs of t-1 are prefetched into L2 during the
// product.
template <bool kLstm>
__global__ void __launch_bounds__(kStreamMaxThreads, 1) rnn_bwd_f32_stream_kernel(WalkArgs a) {
    constexpr int RT = kStreamRows;
    constexpr int G = kLstm ? 4 : 3;
    const int H = a.H;
    const int K = G * H;
    const int KP = stream_kp(kLstm, H);
    const int KSL = KP / kSlices;
    const int nk = KSL / kChunkRows;
    const int slot_floats = kSlices * kChunkRows * H;
    const int nthreads = blockDim.x;

    extern __shared__ __align__(16) float fsn_bwd_f32_smem[];
    float* sA = fsn_bwd_f32_smem;  // [RT][KP] the cotangents of step t (GRU: dhw)
    float* ring = sA + RT * KP;    // [kRing][4][kChunkRows][H] W_hh chunks

    const int row0 = blockIdx.x * RT;
    const int rows = min(RT, a.N - row0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int s = lane >> 3;
    const int col = 4 * ((tid >> 5) * 8 + (lane & 7));
    const bool has_col = col < H;

    auto load_chunk = [&](int slot, int kc) {
        float* dst = ring + slot * slot_floats;
        for (int idx = tid; idx < slot_floats / 4; idx += nthreads) {
            const int k = idx / (H / 4);  // (slice, row) of the slot
            const int c4 = idx - k * (H / 4);
            const int ss = k / kChunkRows;
            const int c = ss * KSL + kc * kChunkRows + (k - ss * kChunkRows);
            const bool ok = c < K;
            cp_async_16(smem_addr(dst + k * H + 4 * c4), ok ? a.whh + (size_t)c * H + 4 * c4 : a.whh,
                        ok);
        }
    };

    for (int idx = tid; idx < RT * KP; idx += nthreads) sA[idx] = 0.0f;
    float carry[16];  // the dh carry into step t of pair (row 4 s + i / 4, unit col + i % 4)
    float dcc[16];    // the dc carry (LSTM)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int r = 4 * s + q;
        float4 dh0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 dc0 = dh0;
        if (has_col && r < rows) {
            const size_t o = (size_t)(row0 + r) * H + col;
            dh0 = __ldg(reinterpret_cast<const float4*>(a.dh_in + o));
            if constexpr (kLstm) dc0 = __ldg(reinterpret_cast<const float4*>(a.dc_in + o));
        }
        carry[4 * q] = dh0.x; carry[4 * q + 1] = dh0.y; carry[4 * q + 2] = dh0.z;
        carry[4 * q + 3] = dh0.w;
        dcc[4 * q] = dc0.x; dcc[4 * q + 1] = dc0.y; dcc[4 * q + 2] = dc0.z; dcc[4 * q + 3] = dc0.w;
    }
    load_chunk(0, 0);
    cp_async_commit();
    int chunk = 0;  // chunk c of the ring holds chunk c % nk of a step, in slot c % kRing
    __syncthreads();

    long long clk[3] = {0, 0, 0};
    for (int t = a.T - 1; t >= 0; --t) {
        const long long c0 = clock64();
        // ---- the cell backward of step t for this thread's 16 pairs ----
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = 4 * s + q;
            const bool real = has_col && r < rows;
            const size_t row = (size_t)t * a.N + row0 + r;
            float4 pg[4], dht, cur, prev;
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            pg[0] = pg[1] = pg[2] = pg[3] = dht = cur = prev = zero;
            if (real) {
                const float* pr = a.p + row * (size_t)(4 * H) + col;
#pragma unroll
                for (int g = 0; g < 4; ++g) pg[g] = __ldg(reinterpret_cast<const float4*>(pr + g * H));
                dht = __ldg(reinterpret_cast<const float4*>(a.dh + row * H + col));
                if constexpr (kLstm) cur = __ldg(reinterpret_cast<const float4*>(a.stash + row * H + col));
                prev = t > 0 ? __ldg(reinterpret_cast<const float4*>(a.stash + (row - a.N) * H + col))
                             : __ldg(reinterpret_cast<const float4*>(a.init + (size_t)(row0 + r) * H + col));
            }
            float dq[4][4];  // [cotangent][unit]
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                PairIn v;
#pragma unroll
                for (int g = 0; g < 4; ++g) v.p[g] = reinterpret_cast<const float*>(&pg[g])[e];
                v.dh = reinterpret_cast<const float*>(&dht)[e];
                v.cur = reinterpret_cast<const float*>(&cur)[e];
                v.prev = reinterpret_cast<const float*>(&prev)[e];
                float d[4];
                carry[4 * q + e] = cell_backward<kLstm>(v, carry[4 * q + e], dcc[4 * q + e], d);
#pragma unroll
                for (int k = 0; k < 4; ++k) dq[k][e] = d[k];
            }
            if (has_col) {
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int k = (!kLstm && g == 2) ? 3 : g;
                    *reinterpret_cast<float4*>(sA + r * KP + g * H + col) =
                        make_float4(dq[k][0], dq[k][1], dq[k][2], dq[k][3]);
                }
            }
            if (real) {
                float* o0 = a.out0 + row * (size_t)K + col;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    *reinterpret_cast<float4*>(o0 + g * H) =
                        make_float4(dq[g][0], dq[g][1], dq[g][2], dq[g][3]);
                }
                if constexpr (!kLstm) {
                    float* o1 = a.out1 + row * (size_t)(3 * H) + col;
#pragma unroll
                    for (int g = 0; g < 3; ++g) {
                        const int k = g == 2 ? 3 : g;
                        *reinterpret_cast<float4*>(o1 + g * H) =
                            make_float4(dq[k][0], dq[k][1], dq[k][2], dq[k][3]);
                    }
                }
            }
        }
        __syncthreads();  // the cotangent tile is complete
        const long long c1 = clock64();
        if (t > 0) {  // step t - 1's inputs into L2 while this step multiplies
            const size_t prev0 = ((size_t)(t - 1) * a.N + row0);
            const size_t nrow = (size_t)rows;
            for (size_t off = (size_t)tid * 32; off < nrow * 4 * H; off += (size_t)nthreads * 32) {
                prefetch_l2(a.p + prev0 * 4 * H + off);
            }
            for (size_t off = (size_t)tid * 32; off < nrow * H; off += (size_t)nthreads * 32) {
                prefetch_l2(a.dh + prev0 * H + off);
                if (t > 1) prefetch_l2(a.stash + (prev0 - a.N) * H + off);
            }
        }

        // ---- the next dh carry: cotangents . W_hh, chunk by chunk ----
        float acc[RT][4];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rr][e] = 0.0f;
        for (int kc = 0; kc < nk; ++kc, ++chunk) {
            cp_async_wait<0>();
            __syncthreads();  // the chunk landed for all; the slot of chunk - 1 is free
            load_chunk((chunk + 1) % kRing, (chunk + 1) % nk);
            cp_async_commit();
            if (has_col) {
                const float* ws = ring + (chunk % kRing) * slot_floats + s * kChunkRows * H + col;
                const float* as = sA + s * KSL + kc * kChunkRows;
#pragma unroll
                for (int i = 0; i < kChunkRows; i += 4) {
                    float4 w[4];
#pragma unroll
                    for (int kq = 0; kq < 4; ++kq) {
                        w[kq] = *reinterpret_cast<const float4*>(ws + (i + kq) * H);
                    }
                    fma_quad<RT>(acc, as + i, KP, w);
                }
            }
        }
        float quarter[RT];
        reduce_slices<RT>(acc, s, quarter);
#pragma unroll
        for (int i = 0; i < 16; ++i) carry[i] += quarter[i];
        __syncthreads();  // every thread is done with the cotangent tile
        const long long c2 = clock64();
        clk[0] += c1 - c0;
        clk[1] += c2 - c1;
    }
    cp_async_wait<0>();
    if (a.clocks != nullptr && blockIdx.x == 0 && tid == 0) {
        a.clocks[0] = clk[0];
        a.clocks[1] = clk[1];
        a.clocks[2] = 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int r = 4 * s + q;
        if (!has_col || r >= rows) continue;
        const size_t o = (size_t)(row0 + r) * H + col;
        *reinterpret_cast<float4*>(a.dh_out + o) =
            make_float4(carry[4 * q], carry[4 * q + 1], carry[4 * q + 2], carry[4 * q + 3]);
        if constexpr (kLstm) {
            *reinterpret_cast<float4*>(a.dc_out + o) =
                make_float4(dcc[4 * q], dcc[4 * q + 1], dcc[4 * q + 2], dcc[4 * q + 3]);
        }
    }
}

size_t stream_smem(bool lstm, int H) {
    return sizeof(float) * ((size_t)kStreamRows * stream_kp(lstm, H) +
                            (size_t)kRing * kSlices * kChunkRows * H);
}

template <bool kLstm>
cudaError_t stream_run(const WalkArgs& a, cudaStream_t stream) {
    auto kernel = rnn_bwd_f32_stream_kernel<kLstm>;
    const size_t smem = stream_smem(kLstm, a.H);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + kStreamRows - 1) / kStreamRows);
    kernel<<<grid, (a.H + 31) / 32 * 32, smem, stream>>>(a);
    return cudaGetLastError();
}

size_t walk_smem(bool lstm, int H, int rows, int kr) {
    const size_t cp = tile_cp(lstm, H);
    const size_t ks = cp / kSlices - kr;
    return sizeof(float) * (kSlices * ks * H + (size_t)rows * cp + (size_t)rows * H);
}

// launch (max_clusters null) or ask how many clusters of this instance fit
// on the card at once
template <int RT, bool kLstm, int KR>
cudaError_t walk_run(const WalkArgs& a, cudaStream_t stream, int* max_clusters) {
    auto kernel = rnn_bwd_f32_walk_kernel<RT, kLstm, KR>;
    const size_t smem = walk_smem(kLstm, a.H, RT, KR);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int tiles = max_clusters ? 1 : (a.N + RT - 1) / RT;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(kCtas * tiles), 1, 1);
    cfg.blockDim = dim3((unsigned)((a.H + 31) / 32 * 32), 1, 1);
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

// the register-holding instances are the LSTM's alone: the GRU's rows of
// W_hh fit in shared memory at every H up to 512
template <bool kLstm>
cudaError_t walk_by_tile(const WalkArgs& a, int rows, int kr, cudaStream_t stream,
                         int* max_clusters) {
    if constexpr (kLstm) {
        if (kr == kRegRows) {
            switch (rows) {
                case 1: return walk_run<1, true, kRegRows>(a, stream, max_clusters);
                case 2: return walk_run<2, true, kRegRows>(a, stream, max_clusters);
                case 4: return walk_run<4, true, kRegRows>(a, stream, max_clusters);
                case 8: return walk_run<8, true, kRegRows>(a, stream, max_clusters);
                default: return cudaErrorInvalidValue;
            }
        }
    }
    switch (rows) {
        case 1: return walk_run<1, kLstm, 0>(a, stream, max_clusters);
        case 2: return walk_run<2, kLstm, 0>(a, stream, max_clusters);
        case 4: return walk_run<4, kLstm, 0>(a, stream, max_clusters);
        case 8: return walk_run<8, kLstm, 0>(a, stream, max_clusters);
        case 16: return walk_run<16, kLstm, 0>(a, stream, max_clusters);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t walk_dispatch(bool lstm, const WalkArgs& a, int rows, int kr, cudaStream_t stream,
                          int* max_clusters) {
    const int H = a.H;
    if (H < kCtas || H % kCtas != 0 || H > kMaxThreads || (kr != 0 && (!lstm || kr != kRegRows)) ||
        kr > tile_cp(lstm, H) / kSlices || walk_smem(lstm, H, rows, kr) > kMaxSmem) {
        return cudaErrorInvalidValue;
    }
    return lstm ? walk_by_tile<true>(a, rows, kr, stream, max_clusters)
                : walk_by_tile<false>(a, rows, kr, stream, max_clusters);
}

}  // namespace

// One layer's backward walk over T steps. lstm = 1: stash = c stash, init =
// c0, out0 = dgates [T, N, 4H], dc_in and dc_out used; lstm = 0 (GRU):
// stash = h stash, init = h0, out0 = dxw and out1 = dhw [T, N, 3H]. whh =
// W_hh [G H, H] with row stride ldw. rows 1, 2, 4, 8 or 16 a cluster; kr 0,
// or 8 for the LSTM with at most 8 rows. clocks null, or [3] int64. Returns a
// cudaError_t.
extern "C" int fsn_rnn_bwd_f32_walk(int lstm, const float* p, const float* dh, const float* stash,
                                    const float* init, const float* whh, const float* dh_in,
                                    const float* dc_in, float* out0, float* out1, float* dh_out,
                                    float* dc_out, long long* clocks, int T, int N, int H, int ldw,
                                    int rows, int kr, void* stream) {
    if (T < 1 || N < 1 || ldw < H) return (int)cudaErrorInvalidValue;
    if (lstm ? (dc_in == nullptr || dc_out == nullptr) : out1 == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.p = p; a.dh = dh; a.stash = stash; a.init = init; a.whh = whh;
    a.dh_in = dh_in; a.dc_in = dc_in; a.out0 = out0; a.out1 = out1;
    a.dh_out = dh_out; a.dc_out = dc_out; a.clocks = clocks;
    a.T = T; a.N = N; a.H = H; a.ldw = ldw;
    return (int)walk_dispatch(lstm != 0, a, rows, kr, static_cast<cudaStream_t>(stream), nullptr);
}

// The streaming walk of one layer's backward: the operands of
// fsn_rnn_bwd_f32_walk with whh contiguous (ldw = H) and 16-byte aligned;
// blocks of 16 rows. H a multiple of 16, at most 384. Returns a
// cudaError_t.
extern "C" int fsn_rnn_bwd_f32_stream(int lstm, const float* p, const float* dh,
                                      const float* stash, const float* init, const float* whh,
                                      const float* dh_in, const float* dc_in, float* out0,
                                      float* out1, float* dh_out, float* dc_out, long long* clocks,
                                      int T, int N, int H, void* stream) {
    if (T < 1 || N < 1 || H < kCtas || H % kCtas != 0 || H > kStreamMaxThreads ||
        (reinterpret_cast<uintptr_t>(whh) & 15) != 0 || stream_smem(lstm != 0, H) > kMaxSmem) {
        return (int)cudaErrorInvalidValue;
    }
    if (lstm ? (dc_in == nullptr || dc_out == nullptr) : out1 == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.p = p; a.dh = dh; a.stash = stash; a.init = init; a.whh = whh;
    a.dh_in = dh_in; a.dc_in = dc_in; a.out0 = out0; a.out1 = out1;
    a.dh_out = dh_out; a.dc_out = dc_out; a.clocks = clocks;
    a.T = T; a.N = N; a.H = H; a.ldw = H;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? stream_run<true>(a, s) : stream_run<false>(a, s));
}

// How many clusters of the walk instance (cell, H, rows, kr) the current
// card runs at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int fsn_rnn_bwd_f32_max_clusters(int lstm, int H, int rows, int kr, int* out) {
    WalkArgs a = {};
    a.T = 1; a.N = rows; a.H = H; a.ldw = H;
    *out = 0;
    return (int)walk_dispatch(lstm != 0, a, rows, kr, nullptr, out);
}

extern "C" const char* fsn_rnn_bwd_f32_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
