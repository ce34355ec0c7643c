// The walk over time of one LSTM or GRU layer of the training forward at
// fp32 storage, for many rows (stage 2 of K2 and K2-GRU at fp32), for Hopper
// (sm_90a).
//
// Replaces, together with fsn_fwd_gemm (rnn_fwd.cu) for the input
// projections and the head, the TPU kernel
// fullsubnet_tpu/ops/subband_lstm.py:_kernel_train_fwd as launched by
// _stash_fwd_call (the pl.pallas_call of the training forward) at fp32
// storage. The Python side (ops/subband_lstm.py, stash_forward) runs per
// layer: fsn_fwd_gemm for P = x . W_ih^T + bias over all T*N rows (LSTM
// b_ih + b_hh, GRU b_ih), a walk with only h_{t-1} . W_hh^T on the time chain
// whose h stream is the layer's h stash and the next layer's input, and
// last fsn_fwd_gemm for the head. For few rows the walk is rnn_fwd.cu's
// cluster walk (W_hh^T resident over 16 CTAs; its c-stream instances for the
// LSTM); for many rows, where that form needs more than one wave of
// clusters (train_f32_streams), this kernel. The earlier fp32 kernels
// (lstm_train_fwd.cu, gru_forward.cu) did all the products inside the time
// loop.
//
// What bounds it on this card. Each step needs all of W_hh^T (2.4 MB for
// the LSTM at H = 384, 1.8 MB for the GRU), more than an SM holds, for a
// product of N x H x G H FMAs on the fp32 cores (TF32 would change the
// results). At the sub-band stage (N = 4096) the cluster form would run 256
// clusters in waves of 7.
//
// What the design does about it. One block of 32 rows holds every unit, so
// a step needs no cluster and the card runs one wave of 128 blocks at
// N = 4096; each block streams W_hh^T from L2 at every step, half as often
// a row as 16-row blocks would. The product runs one group of 96 units at a
// time: the block's 384 threads are 4 row groups x 96 units, and thread
// (row group, unit) sums the G gate columns of its unit over the 8 rows of
// its row group (an [8][G] accumulator), so no thread holds more than its
// share of one group's outputs. W_hh^T is regrouped by the wrapper as
// [group][k][unit][gate] (units past H zero) and streams through a ring of
// 2 slots of 32 K rows by 16-byte cp.async, one barrier a slot (on an H100,
// 4 slots of 16 rows spent a fifth of a step at the barriers, 2 of 32 rows
// a seventh); the ring runs on across
// groups and steps. A warp's 32 lanes are 32 units of one
// row group: a float4 of h_{t-1} is a broadcast, the unit's G weights a
// conflict-free load. After a group's product the thread does the cell
// update of its 8 (row, unit) pairs: P_t from global memory (its lines
// prefetched into L2 when the group starts, loaded into registers during
// the group's last chunk), the LSTM's c_{t-1} read back at the cell update
// from where the thread wrote it in the c stream (in registers it would
// crowd the product's, and local memory does not fit in what shared memory
// leaves of L1), h_t into the next step's shared tile (h_{t-1} and h_t by
// step parity, zero-padded to a multiple of 32 columns) and to the h
// stream, and (LSTM) c_t to the c stream.
//
// Layouts (all fp32, contiguous). p [T, N, G H] (gate blocks i, f, g, o or
// r, z, n, each H wide); w [NG, HP, 96, G] the regrouped W_hh^T, NG =
// ceil(H / 96), HP = H rounded up to 32; bhh [3H] (GRU) or null; h0, c0,
// h_out, c_out [N, H]; hseq, cseq [T, N, H]. H up to 512.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math: expf/tanhf
//             keep the fp32 results close to the CPU path).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;          // rows of one block
constexpr int kRowGroups = 4;      // of 8 rows: a thread's rows
constexpr int kRpt = kRows / kRowGroups;
constexpr int kUnits = 96;         // units of one group: a thread each in each row group
constexpr int kThreads = kRowGroups * kUnits;
constexpr int kChunk = 32;         // K rows of W_hh^T in one ring slot
constexpr int kRing = 2;           // slots of the ring: one in flight while one is read
constexpr int kMaxGroups = 6;      // H up to 576; shared memory allows 512
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
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

struct Args {
    const float* p;
    const float* w;
    const float* bhh;
    const float* h0;
    const float* c0;
    float* hseq;
    float* cseq;
    float* h_out;
    float* c_out;
    long long* clocks;  // null, or [3]: block 0's cycles waiting for the ring (and the
                        // barrier), in the product, and in the cell updates, over all steps
    int T, N, H;
};

__host__ __device__ __forceinline__ int padded_h(int H) {
    return (H + kChunk - 1) / kChunk * kChunk;
}

__host__ __device__ __forceinline__ int unit_groups(int H) { return (H + kUnits - 1) / kUnits; }

template <bool kLstm>
__global__ void __launch_bounds__(kThreads, 1) train_f32_walk_kernel(Args a) {
    constexpr int G = kLstm ? 4 : 3;
    constexpr int kSlot = kChunk * kUnits * G;  // floats of one ring slot
    const int H = a.H;
    const int HP = padded_h(H);
    const int NG = unit_groups(H);
    const int nk = HP / kChunk;  // chunks of one group
    const int nch = NG * nk;     // chunks of one step

    extern __shared__ __align__(16) float fsn_train_f32_smem[];
    float* sh = fsn_train_f32_smem;   // [2][kRows][HP] h by step parity
    float* ring = sh + 2 * kRows * HP;  // [kRing][kChunk][kUnits][G]

    const int tid = threadIdx.x;
    const int rg = tid / kUnits;
    const int ul = tid - rg * kUnits;
    const int r0 = rg * kRpt;
    const int row0 = blockIdx.x * kRows;
    const int rows = min(kRows, a.N - row0);
    const int GH = G * H;

    // chunk c of a step (group c / nk, K rows (c % nk) kChunk ..) is the
    // c-th run of kSlot floats of the regrouped weights
    auto load_chunk = [&](int slot, int c) {
        const float* src = a.w + (size_t)c * kSlot;
        float* dst = ring + slot * kSlot;
#pragma unroll
        for (int i = tid; i < kSlot / 4; i += kThreads) {
            cp_async_16(smem_addr(dst + 4 * i), src + 4 * i);
        }
    };

    // h0 into the parity-0 tile; everything else of both tiles zero
    for (int idx = tid; idx < 2 * kRows * HP; idx += kThreads) {
        const int r = idx / HP;
        const int k = idx - r * HP;
        sh[idx] = (r < rows && k < H) ? __ldg(a.h0 + (size_t)(row0 + r) * H + k) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) {
        load_chunk(s, s % nch);
        cp_async_commit();
    }
    int chunk = 0;  // chunks read so far: chunk c sits in slot c % kRing

    long long clk[3] = {0, 0, 0};
    for (int t = 0; t < a.T; ++t) {
        const float* hp = sh + (t & 1) * kRows * HP;
        float* hn = sh + ((t + 1) & 1) * kRows * HP;
        const float* pt = a.p + ((size_t)t * a.N + row0) * GH;
        // c_{t-1} of this block's rows, [rows, H], where this thread wrote it
        // (plain loads: the walk writes it)
        const float* c_prev = !kLstm  ? nullptr
                              : t == 0 ? a.c0 + (size_t)row0 * H
                                       : a.cseq + ((size_t)(t - 1) * a.N + row0) * H;
#pragma unroll 1
        for (int g = 0; g < NG; ++g) {
            const int u = g * kUnits + ul;
            const bool has_unit = u < H;
            // this warp's lines of P_t for the group: lane l takes row r0 + l / 4, gate l % 4
            {
                const int lane = tid & 31;
                const int r = r0 + lane / 4;
                const int gate = lane % 4;
                const int u_warp = g * kUnits + (ul & ~31);
                if (gate < G && r < rows && u_warp < H) {
                    prefetch_l2(pt + (size_t)r * GH + gate * H + u_warp);
                }
            }
            float acc[kRpt][G];
            float pv[kRpt][G];  // P_t of the thread's pairs
#pragma unroll
            for (int i = 0; i < kRpt; ++i)
#pragma unroll
                for (int j = 0; j < G; ++j) acc[i][j] = pv[i][j] = 0.0f;

            for (int kc = 0; kc < nk; ++kc, ++chunk) {
                const long long c0 = clock64();
                cp_async_wait<kRing - 2>();
                __syncthreads();  // chunk landed for all; the slot of chunk - 1 is free
                const int next = chunk + kRing - 1;
                load_chunk(next % kRing, next % nch);
                cp_async_commit();
                const long long c1 = clock64();
                if (kc == nk - 1 && has_unit) {  // in flight during the last chunk's product
#pragma unroll
                    for (int i = 0; i < kRpt; ++i) {
                        if (r0 + i < rows) {
#pragma unroll
                            for (int j = 0; j < G; ++j) {
                                pv[i][j] = __ldg(pt + (size_t)(r0 + i) * GH + j * H + u);
                            }
                        }
                    }
                }
                const float* ws = ring + (chunk % kRing) * kSlot + ul * G;
                const float* hs = hp + r0 * HP + kc * kChunk;
#pragma unroll
                for (int kq = 0; kq < kChunk; kq += 4) {
                    float w[4][G];
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const float* wk = ws + (kq + kk) * kUnits * G;
                        if constexpr (G == 4) {
                            const float4 w4 = *reinterpret_cast<const float4*>(wk);
                            w[kk][0] = w4.x;
                            w[kk][1] = w4.y;
                            w[kk][2] = w4.z;
                            w[kk][3] = w4.w;
                        } else {
#pragma unroll
                            for (int j = 0; j < G; ++j) w[kk][j] = wk[j];
                        }
                    }
#pragma unroll
                    for (int i = 0; i < kRpt; ++i) {
                        const float4 hv = *reinterpret_cast<const float4*>(hs + i * HP + kq);
#pragma unroll
                        for (int j = 0; j < G; ++j) {
                            acc[i][j] = fmaf(hv.x, w[0][j], acc[i][j]);
                            acc[i][j] = fmaf(hv.y, w[1][j], acc[i][j]);
                            acc[i][j] = fmaf(hv.z, w[2][j], acc[i][j]);
                            acc[i][j] = fmaf(hv.w, w[3][j], acc[i][j]);
                        }
                    }
                }
                const long long c2 = clock64();
                clk[0] += c1 - c0;
                clk[1] += c2 - c1;
            }

            // the cell update of this thread's 8 pairs of the group
            const long long c3 = clock64();
            if (has_unit) {
                float cv[kRpt];  // c_{t-1} of the pairs (LSTM), in flight during the gates
#pragma unroll
                for (int i = 0; i < kRpt; ++i) {
                    cv[i] = (kLstm && r0 + i < rows) ? c_prev[(size_t)(r0 + i) * H + u] : 0.0f;
                }
                float bh[3] = {0.0f, 0.0f, 0.0f};
                if constexpr (!kLstm) {
#pragma unroll
                    for (int j = 0; j < 3; ++j) bh[j] = __ldg(a.bhh + j * H + u);
                }
#pragma unroll
                for (int i = 0; i < kRpt; ++i) {
                    const int r = r0 + i;
                    const bool real = r < rows;
                    float h;
                    if constexpr (kLstm) {
                        const float ig = sigmoid_f(pv[i][0] + acc[i][0]);
                        const float fg = sigmoid_f(pv[i][1] + acc[i][1]);
                        const float gg = tanhf(pv[i][2] + acc[i][2]);
                        const float og = sigmoid_f(pv[i][3] + acc[i][3]);
                        cv[i] = fg * cv[i] + ig * gg;
                        h = og * tanhf(cv[i]);
                    } else {
                        const float rr = sigmoid_f(pv[i][0] + (acc[i][0] + bh[0]));
                        const float zz = sigmoid_f(pv[i][1] + (acc[i][1] + bh[1]));
                        const float nn = tanhf(pv[i][2] + rr * (acc[i][2] + bh[2]));
                        h = (1.0f - zz) * nn + zz * hp[r * HP + u];
                    }
                    hn[r * HP + u] = h;
                    if (real) {
                        const size_t o = ((size_t)t * a.N + row0 + r) * H + u;
                        a.hseq[o] = h;
                        if constexpr (kLstm) a.cseq[o] = cv[i];
                        if (t == a.T - 1) {
                            const size_t last = (size_t)(row0 + r) * H + u;
                            a.h_out[last] = h;
                            if constexpr (kLstm) a.c_out[last] = cv[i];
                        }
                    }
                }
            }
            clk[2] += clock64() - c3;
        }
    }
    cp_async_wait<0>();
    if (a.clocks != nullptr && blockIdx.x == 0 && tid == 0) {
        a.clocks[0] = clk[0];
        a.clocks[1] = clk[1];
        a.clocks[2] = clk[2];
    }
}

size_t walk_smem(bool lstm, int H) {
    return sizeof(float) * (2 * (size_t)kRows * padded_h(H) +
                            (size_t)kRing * kChunk * kUnits * (lstm ? 4 : 3));
}

template <bool kLstm>
cudaError_t walk_run(const Args& a, cudaStream_t stream) {
    auto kernel = train_f32_walk_kernel<kLstm>;
    const size_t smem = walk_smem(kLstm, a.H);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + kRows - 1) / kRows);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// One layer's streaming walk over T steps. lstm = 1: c0, c_out and cseq (the
// c stream) used, bhh null; lstm = 0 (GRU): bhh [3H] used, c0, c_out and
// cseq null. w the regrouped W_hh^T [NG, HP, 96, G], 16-byte
// aligned. h_out and c_out take the state after the last step. Blocks of 32
// rows; H up to 512. clocks null, or [3] int64. Returns a cudaError_t.
extern "C" int fsn_rnn_train_f32_walk(int lstm, const float* p, const float* w, const float* bhh,
                                      const float* h0, const float* c0, float* hseq, float* cseq,
                                      float* h_out, float* c_out, long long* clocks, int T, int N,
                                      int H, void* stream) {
    if (T < 1 || N < 1 || H < 1 || unit_groups(H) > kMaxGroups ||
        walk_smem(lstm != 0, H) > kMaxSmem || (reinterpret_cast<uintptr_t>(w) & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (lstm ? (c0 == nullptr || c_out == nullptr || cseq == nullptr || bhh != nullptr)
             : (bhh == nullptr || c0 != nullptr || c_out != nullptr || cseq != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    Args a;
    a.p = p; a.w = w; a.bhh = bhh; a.h0 = h0; a.c0 = c0;
    a.hseq = hseq; a.cseq = cseq; a.h_out = h_out; a.c_out = c_out; a.clocks = clocks;
    a.T = T; a.N = N; a.H = H;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(lstm ? walk_run<true>(a, s) : walk_run<false>(a, s));
}

extern "C" const char* fsn_rnn_train_f32_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
