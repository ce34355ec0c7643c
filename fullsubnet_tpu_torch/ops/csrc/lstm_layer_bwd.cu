// One LSTM layer's backward in reverse time, for Hopper (sm_90a): the
// port's first K3, of the earlier design. No path runs it now: fp32
// storage runs the stages fsn_fwd_gemm (rnn_fwd.cu) and lstm_walk_f32
// (rnn_bwd_f32.cu), bf16 storage the tensor-core stages of rnn_bwd_tc.cu.
// chip_smoke.py checks and times this kernel (fp32, and its bf16
// instance) beside the stages that replaced it.
//
// Replaces the TPU kernel fullsubnet_tpu/ops/subband_lstm.py:
// _lstm_layer_bwd_kernel, as launched by _pallas_layer_bwd (the
// pl.pallas_call of the per-layer backward), in its split-dW form. For
// t = T-1 .. 0 it recomputes the gates from [x_t | h_{t-1}] and W (the
// forward stashed h and c, not the gates), forms the gate cotangents
// dgates from the incoming dh_t and the (dh, dc) carries, and takes
// dxh = dgates . W^T: the x part is dx_t, the h part the next dh carry.
// It writes dx [T, N, F], the dgates stream [T, N, 4H] (the weight
// gradients are plain products over T*N outside the kernel, as the TPU
// package computes them outside Pallas), and the carries into the
// initial state (dh0, dc0). Initial states and incoming carries are
// arguments, so a time-chunked backward can chain calls.
//
// What bounds it on this card. Per step and row it does two products
// against the layer's weights, the gate recompute ((F+H) x 4H) and the
// transposed one (4H x (F+H)): at the flagship sub-band shape (N = 4096,
// T = 195, H = 384) that is 5.8 TFLOP for the two layers, 5.9 ms at the
// bf16 tensor-core peak and about 87 ms on the fp32 cores used here. The
// streams it reads and writes (dh, x, the h and c stashes, dx, dgates) are
// 9.9 GB in bf16 for both layers, 3.0 ms at 3.35 TB/s. As in the forward
// kernels, the weights do not fit in shared memory and are streamed from
// L2 at every step, twice (once per layout); as there, the fp32 FMAs and
// the shared-memory reads that feed them set the pace on an H100 more
// than L2 does (bf16 storage took 16% off the fp32 time, PERF.md).
//
// What the design does about it. One block per tile of R rows (2 or 8)
// walks the time loop, as in the forward kernels. Each step has two
// phases with a barrier between them:
//   1. thread j owns hidden unit j: it recomputes the four gate
//      pre-activations of unit j for the block's R rows (W [F+H, 4H]
//      read coalesced across j), then does the cell backward for (r, j)
//      locally and writes dgates (rounded to the storage type, as the TPU
//      kernel casts them before the product) to shared memory and to the
//      dgates stream;
//   2. thread k owns column k of [x | h]: it takes dxh[r, k] as the sum
//      over the 4H gates of dgates[r, g] * W^T[g, k], reading the torch
//      layout W^T [4H, F+H] coalesced across k. Column k < F is dx_t;
//      column F + j is the dh carry of unit j for step t-1.
// The dc carry of (r, j) never leaves thread j. The carries stay fp32 in
// shared memory for the whole walk. The products stay on the fp32 cores:
// at fp32 storage the TPU kernel's f32 products are kept exact (no TF32);
// the bf16 design that moves them to the tensor cores is rnn_bwd_tc.cu.
//
// Layouts. dh, hs, cs [T, N, H]; x [T, N, F]; h0, c0 [N, H]; dh_in,
// dc_in, dh_out, dc_out [N, H] fp32; w [F + H, 4H]; wt [4H, F + H]; b [4H]
// fp32; dx [T, N, F]; dg [T, N, 4H]. All contiguous; the unmarked ones in
// the storage type.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math).

#include "lstm_train_common.cuh"

namespace {

using fsn::Io;
using fsn::kMaxThreads;
using fsn::sigmoid_f;

template <typename S>
struct LayerBwdArgs {
    const S* dh;
    const S* x;
    const S* hs;
    const S* cs;
    const S* h0;
    const S* c0;
    const float* dh_in;
    const float* dc_in;
    const S* w;
    const S* wt;
    const float* b;
    S* dx;
    S* dg;
    float* dh_out;
    float* dc_out;
    int steps, N, F, H;
};

template <typename S, int R>
__global__ void __launch_bounds__(kMaxThreads) lstm_layer_backward_kernel(LayerBwdArgs<S> a) {
    extern __shared__ float smem[];
    const int H = a.H;
    const int F = a.F;
    const int K = F + H;
    const int G = 4 * H;
    const int row0 = blockIdx.x * R;
    const int rows = min(R, a.N - row0);

    float* xh = smem;          // [R][K]  [x_t | h_{t-1}]
    float* dgs = xh + R * K;   // [R][G]  dgates of step t
    float* dhc = dgs + R * G;  // [R][H]  dh carry (into step t)
    float* dcc = dhc + R * H;  // [R][H]  dc carry (into step t)

    // rows past N carry zeros, so their dgates and dx stay zero
    for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
        const bool real = i < rows * H;
        const size_t g = (size_t)row0 * H + i;
        dhc[i] = real ? a.dh_in[g] : 0.0f;
        dcc[i] = real ? a.dc_in[g] : 0.0f;
    }

    for (int t = a.steps - 1; t >= 0; --t) {
        // stage [x_t | h_{t-1}]; at t = 0 the initial state stands for the stash
        const S* xt = a.x + ((size_t)t * a.N + row0) * F;
        const S* hp = t > 0 ? a.hs + ((size_t)(t - 1) * a.N + row0) * H
                            : a.h0 + (size_t)row0 * H;
        for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
            const int r = i / K;
            const int k = i - r * K;
            float v = 0.0f;
            if (r < rows) {
                v = k < F ? Io<S>::load(xt + r * F + k) : Io<S>::load(hp + r * H + (k - F));
            }
            xh[i] = v;
        }
        __syncthreads();

        // phase 1: gate recompute and the cell backward, thread j = unit j
        const S* cp = t > 0 ? a.cs + ((size_t)(t - 1) * a.N + row0) * H
                            : a.c0 + (size_t)row0 * H;
        const S* cc = a.cs + ((size_t)t * a.N + row0) * H;
        const S* dht = a.dh + ((size_t)t * a.N + row0) * H;
        S* dgt = a.dg + ((size_t)t * a.N + row0) * G;
        for (int j = threadIdx.x; j < H; j += blockDim.x) {
            float acc[R][4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const float bg = a.b[g * H + j];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r][g] = bg;
            }
            const S* wk = a.w + j;
#pragma unroll 4
            for (int k = 0; k < K; ++k, wk += G) {
                const float w0 = Io<S>::load(wk);
                const float w1 = Io<S>::load(wk + H);
                const float w2 = Io<S>::load(wk + 2 * H);
                const float w3 = Io<S>::load(wk + 3 * H);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float v = xh[r * K + k];
                    acc[r][0] = fmaf(v, w0, acc[r][0]);
                    acc[r][1] = fmaf(v, w1, acc[r][1]);
                    acc[r][2] = fmaf(v, w2, acc[r][2]);
                    acc[r][3] = fmaf(v, w3, acc[r][3]);
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float ig = sigmoid_f(acc[r][0]);
                const float fg = sigmoid_f(acc[r][1]);
                const float gg = tanhf(acc[r][2]);
                const float og = sigmoid_f(acc[r][3]);
                float c_cur = 0.0f, c_prev = 0.0f, dh_t = 0.0f;
                if (r < rows) {
                    c_cur = Io<S>::load(cc + r * H + j);
                    c_prev = Io<S>::load(cp + r * H + j);
                    dh_t = Io<S>::load(dht + r * H + j);
                }
                const float tc = tanhf(c_cur);
                const float dh_tot = dh_t + dhc[r * H + j];
                const float d_o = dh_tot * tc;
                const float dc = dcc[r * H + j] + dh_tot * og * (1.0f - tc * tc);
                const float d0 = Io<S>::round((dc * gg) * ig * (1.0f - ig));
                const float d1 = Io<S>::round((dc * c_prev) * fg * (1.0f - fg));
                const float d2 = Io<S>::round((dc * ig) * (1.0f - gg * gg));
                const float d3 = Io<S>::round(d_o * og * (1.0f - og));
                float* dgr = dgs + r * G;
                dgr[j] = d0;
                dgr[H + j] = d1;
                dgr[2 * H + j] = d2;
                dgr[3 * H + j] = d3;
                dcc[r * H + j] = dc * fg;
                if (r < rows) {
                    S* out = dgt + r * G + j;
                    Io<S>::store(out, d0);
                    Io<S>::store(out + H, d1);
                    Io<S>::store(out + 2 * H, d2);
                    Io<S>::store(out + 3 * H, d3);
                }
            }
        }
        __syncthreads();

        // phase 2: dxh = dgates . W^T, thread k = column k of [x | h]
        S* dxt = a.dx + ((size_t)t * a.N + row0) * F;
        for (int k = threadIdx.x; k < K; k += blockDim.x) {
            float acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = 0.0f;
            const S* wg = a.wt + k;
#pragma unroll 4
            for (int g = 0; g < G; ++g, wg += K) {
                const float wv = Io<S>::load(wg);
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = fmaf(dgs[r * G + g], wv, acc[r]);
            }
            if (k < F) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r < rows) Io<S>::store(dxt + r * F + k, acc[r]);
                }
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) dhc[r * H + (k - F)] = acc[r];
            }
        }
        // the next step stages only xh, which no thread reads after the
        // phase-1 barrier; its own barrier orders the carries and dgs
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
        a.dh_out[(size_t)row0 * H + i] = dhc[i];
        a.dc_out[(size_t)row0 * H + i] = dcc[i];
    }
}

template <typename S, int R>
cudaError_t launch(const LayerBwdArgs<S>& a, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)R *
                        ((size_t)(a.F + a.H) + 4 * (size_t)a.H + 2 * (size_t)a.H);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_layer_backward_kernel<S, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + R - 1) / R);
    lstm_layer_backward_kernel<S, R><<<grid, fsn::block_threads(a.H), smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename S>
int run(const void* dh, const void* x, const void* hs, const void* cs,
        const void* h0, const void* c0, const float* dh_in, const float* dc_in,
        const void* w, const void* wt, const float* b, void* dx, void* dg,
        float* dh_out, float* dc_out, int T, int N, int F, int H,
        int rows_per_block, cudaStream_t stream) {
    LayerBwdArgs<S> a;
    a.dh = static_cast<const S*>(dh);
    a.x = static_cast<const S*>(x);
    a.hs = static_cast<const S*>(hs);
    a.cs = static_cast<const S*>(cs);
    a.h0 = static_cast<const S*>(h0);
    a.c0 = static_cast<const S*>(c0);
    a.dh_in = dh_in;
    a.dc_in = dc_in;
    a.w = static_cast<const S*>(w);
    a.wt = static_cast<const S*>(wt);
    a.b = b;
    a.dx = static_cast<S*>(dx);
    a.dg = static_cast<S*>(dg);
    a.dh_out = dh_out;
    a.dc_out = dc_out;
    a.steps = T; a.N = N; a.F = F; a.H = H;
    switch (rows_per_block) {
        case 2: return (int)launch<S, 2>(a, stream);
        case 8: return (int)launch<S, 8>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: fsn::kFloat32 or fsn::kBFloat16. Returns a cudaError_t.
extern "C" int fsn_lstm_layer_backward(
    const void* dh, const void* x, const void* hs, const void* cs,
    const void* h0, const void* c0, const float* dh_in, const float* dc_in,
    const void* w, const void* wt, const float* b, void* dx, void* dg,
    float* dh_out, float* dc_out, int T, int N, int F, int H,
    int rows_per_block, int dtype, void* stream) {
    if (T < 1 || N < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case fsn::kFloat32:
            return run<float>(dh, x, hs, cs, h0, c0, dh_in, dc_in, w, wt, b, dx,
                              dg, dh_out, dc_out, T, N, F, H, rows_per_block, s);
        case fsn::kBFloat16:
            return run<__nv_bfloat16>(dh, x, hs, cs, h0, c0, dh_in, dc_in, w, wt,
                                      b, dx, dg, dh_out, dc_out, T, N, F, H,
                                      rows_per_block, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
