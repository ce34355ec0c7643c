// One GRU layer's backward in reverse time, for Hopper (sm_90a): the
// port's first K4, of the earlier design. No path runs it now: fp32
// storage runs the stages fsn_fwd_gemm (rnn_fwd.cu) and gru_walk_f32
// (rnn_bwd_f32.cu), bf16 storage the tensor-core stages of rnn_bwd_tc.cu.
// chip_smoke.py checks and times this kernel (fp32, and its bf16
// instance) beside the stages that replaced it.
//
// Replaces the TPU kernel fullsubnet_tpu/ops/subband_lstm.py:
// _gru_layer_bwd_kernel, as launched by _pallas_layer_bwd (the
// pl.pallas_call of the per-layer backward), in its split-dW form. For
// t = T-1 .. 0 it recomputes r, z and n of the torch GRU cell from
// [x_t | h_{t-1}] and W (the forward stashed h only), forms the
// pre-activation cotangents from the incoming dh_t and the dh carry, and
// writes two streams: dxw = [dr, dz, dn], the cotangent of x W_ih^T + b_ih,
// and dhw = [dr, dz, dn r], that of h W_hh^T + b_hh (the reset gate scales
// only the h side of n). It takes dx_t = dxw . W_ih and the next dh carry
// dh_tot z + dhw . W_hh in the kernel. The weight gradients are plain
// products over T*N outside the kernel, as the TPU package computes them
// outside Pallas: dW_ih from dxw, dW_hh from dhw, and the two bias
// gradients, which differ here, from each. It writes dx [T, N, F], dxw and
// dhw [T, N, 3H], and the carry into the initial state, dh0. The initial
// state and the incoming carry are arguments, so a time-chunked backward
// can chain calls.
//
// What bounds it on this card. Per step and row it does two products
// against the layer's weights, the gate recompute ((F+H) x 3H) and the
// transposed one (3H x (F+H)): at the flagship sub-band shape (N = 4096,
// T = 195, H = 384) that is 4.4 TFLOP for the two layers, ¾ of the LSTM
// backward (lstm_layer_bwd.cu), 4.4 ms at the bf16 tensor-core peak and
// about 65 ms on the fp32 cores used here. Its streams are larger than the
// LSTM's: two [T, N, 3H] cotangent streams (1.84 GB each at that shape in
// bf16) against one [T, N, 4H]. As in the forward kernels, the weights do
// not fit in shared memory and are streamed from L2 at every step, twice
// (once per layout).
//
// What the design does about it. The LSTM backward's two-phase step, one
// block per tile of R rows (2 or 8) walking the time loop:
//   1. thread j owns hidden unit j: it recomputes four fp32 sums of unit j
//      for the block's R rows (r and z with x and h together, n's x part
//      and n's h part hn_pre = h W_hn + b_hn apart; W [F+H, 3H] read
//      coalesced across j), then the cell backward for (r, j) locally:
//      dz = dh_tot (h_prev - n), dn = dh_tot (1 - z)(1 - n^2),
//      dr = dn hn_pre r (1 - r), dz_pre = dz z (1 - z). dxw and dhw,
//      rounded to the storage type (the TPU kernel casts both before its
//      products), go to shared memory and to their streams; dhw shares its
//      r and z parts with dxw, so only its n part dn r is kept apart. The
//      term dh_tot z of the next carry goes into the carry slot of (r, j);
//   2. thread k owns column k of [x | h]: it sums over the 3H gates against
//      the torch layout W^T [3H, F+H], read coalesced across k. Column
//      k < F takes dxw and is dx_t; column F + j takes dhw and adds to the
//      carry slot of unit j, which phase 1 left there across the barrier.
// h_{t-1} is the stash's value (rounded to the storage type at bf16), in
// the recompute and in dz both, as the TPU kernel reads it. The carry stays
// fp32 in shared memory for the whole walk. The products stay on the fp32
// cores: at fp32 storage the TPU kernel's f32 products are kept exact (no
// TF32); the bf16 design that moves them to the tensor cores is
// rnn_bwd_tc.cu.
//
// Layouts. dh, hs [T, N, H]; x [T, N, F]; h0 [N, H]; dh_in, dh_out [N, H]
// fp32; w [F + H, 3H]; wt [3H, F + H]; b [2, 3H] fp32 (rows b_ih, b_hh);
// dx [T, N, F]; dxw, dhw [T, N, 3H]. All contiguous; the unmarked ones in
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
struct GruBwdArgs {
    const S* dh;
    const S* x;
    const S* hs;
    const S* h0;
    const float* dh_in;
    const S* w;
    const S* wt;
    const float* b;
    S* dx;
    S* dxw;
    S* dhw;
    float* dh_out;
    int steps, N, F, H;
};

template <typename S, int R>
__global__ void __launch_bounds__(kMaxThreads) gru_layer_backward_kernel(GruBwdArgs<S> a) {
    extern __shared__ float smem[];
    const int H = a.H;
    const int F = a.F;
    const int K = F + H;
    const int G = 3 * H;
    const int row0 = blockIdx.x * R;
    const int rows = min(R, a.N - row0);

    float* xh = smem;          // [R][K]  [x_t | h_{t-1}]
    float* dgs = xh + R * K;   // [R][G]  dxw of step t: dr, dz, dn
    float* dhn = dgs + R * G;  // [R][H]  the n part of dhw: dn r
    float* dhc = dhn + R * H;  // [R][H]  dh carry (into step t)

    // rows past N carry zeros, so their cotangents and dx stay zero
    for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
        dhc[i] = i < rows * H ? a.dh_in[(size_t)row0 * H + i] : 0.0f;
    }
    const float* b_ih = a.b;
    const float* b_hh = a.b + G;

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
        const S* dht = a.dh + ((size_t)t * a.N + row0) * H;
        S* dxw_t = a.dxw + ((size_t)t * a.N + row0) * G;
        S* dhw_t = a.dhw + ((size_t)t * a.N + row0) * G;
        for (int j = threadIdx.x; j < H; j += blockDim.x) {
            // acc[r]: r gate, z gate, n gate's x part, n gate's h part
            float acc[R][4];
            const float b_r = b_ih[j] + b_hh[j];
            const float b_z = b_ih[H + j] + b_hh[H + j];
            const float b_xn = b_ih[2 * H + j];
            const float b_hn = b_hh[2 * H + j];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                acc[r][0] = b_r;
                acc[r][1] = b_z;
                acc[r][2] = b_xn;
                acc[r][3] = b_hn;
            }
            const S* wk = a.w + j;
#pragma unroll 4
            for (int k = 0; k < F; ++k, wk += G) {
                const float w0 = Io<S>::load(wk);
                const float w1 = Io<S>::load(wk + H);
                const float w2 = Io<S>::load(wk + 2 * H);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float v = xh[r * K + k];
                    acc[r][0] = fmaf(v, w0, acc[r][0]);
                    acc[r][1] = fmaf(v, w1, acc[r][1]);
                    acc[r][2] = fmaf(v, w2, acc[r][2]);
                }
            }
#pragma unroll 4
            for (int k = F; k < K; ++k, wk += G) {
                const float w0 = Io<S>::load(wk);
                const float w1 = Io<S>::load(wk + H);
                const float w2 = Io<S>::load(wk + 2 * H);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float v = xh[r * K + k];
                    acc[r][0] = fmaf(v, w0, acc[r][0]);
                    acc[r][1] = fmaf(v, w1, acc[r][1]);
                    acc[r][3] = fmaf(v, w2, acc[r][3]);
                }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float rg = sigmoid_f(acc[r][0]);
                const float zg = sigmoid_f(acc[r][1]);
                const float hn_pre = acc[r][3];
                const float ng = tanhf(acc[r][2] + rg * hn_pre);
                const float h_prev = xh[r * K + F + j];
                const float dh_t = r < rows ? Io<S>::load(dht + r * H + j) : 0.0f;
                const float dh_tot = dh_t + dhc[r * H + j];
                const float dz = dh_tot * (h_prev - ng);
                const float dn = (dh_tot * (1.0f - zg)) * (1.0f - ng * ng);
                const float d0 = Io<S>::round((dn * hn_pre) * rg * (1.0f - rg));
                const float d1 = Io<S>::round(dz * zg * (1.0f - zg));
                const float d2 = Io<S>::round(dn);
                const float d2h = Io<S>::round(dn * rg);
                float* dgr = dgs + r * G;
                dgr[j] = d0;
                dgr[H + j] = d1;
                dgr[2 * H + j] = d2;
                dhn[r * H + j] = d2h;
                dhc[r * H + j] = dh_tot * zg;  // phase 2 adds dhw . W_hh
                if (r < rows) {
                    S* ox = dxw_t + r * G + j;
                    Io<S>::store(ox, d0);
                    Io<S>::store(ox + H, d1);
                    Io<S>::store(ox + 2 * H, d2);
                    S* oh = dhw_t + r * G + j;
                    Io<S>::store(oh, d0);
                    Io<S>::store(oh + H, d1);
                    Io<S>::store(oh + 2 * H, d2h);
                }
            }
        }
        __syncthreads();

        // phase 2: dx_t = dxw . W_ih and dh_{t-1} += dhw . W_hh, thread k =
        // column k of [x | h]
        S* dxt = a.dx + ((size_t)t * a.N + row0) * F;
        for (int k = threadIdx.x; k < K; k += blockDim.x) {
            float acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = 0.0f;
            const S* wg = a.wt + k;
            if (k < F) {
#pragma unroll 4
                for (int g = 0; g < G; ++g, wg += K) {
                    const float wv = Io<S>::load(wg);
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r] = fmaf(dgs[r * G + g], wv, acc[r]);
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r < rows) Io<S>::store(dxt + r * F + k, acc[r]);
                }
            } else {
#pragma unroll 4
                for (int g = 0; g < 2 * H; ++g, wg += K) {
                    const float wv = Io<S>::load(wg);
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r] = fmaf(dgs[r * G + g], wv, acc[r]);
                }
#pragma unroll 4
                for (int g = 0; g < H; ++g, wg += K) {
                    const float wv = Io<S>::load(wg);
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r] = fmaf(dhn[r * H + g], wv, acc[r]);
                }
#pragma unroll
                for (int r = 0; r < R; ++r) dhc[r * H + (k - F)] += acc[r];
            }
        }
        // the next step stages only xh, which no thread reads after the
        // phase-1 barrier; its own barrier orders the carry and dgs
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
        a.dh_out[(size_t)row0 * H + i] = dhc[i];
    }
}

template <typename S, int R>
cudaError_t launch(const GruBwdArgs<S>& a, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)R * ((size_t)a.F + 6 * (size_t)a.H);
    cudaError_t err = cudaFuncSetAttribute(
        gru_layer_backward_kernel<S, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + R - 1) / R);
    gru_layer_backward_kernel<S, R><<<grid, fsn::block_threads(a.H), smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename S>
int run(const void* dh, const void* x, const void* hs, const void* h0,
        const float* dh_in, const void* w, const void* wt, const float* b,
        void* dx, void* dxw, void* dhw, float* dh_out, int T, int N, int F,
        int H, int rows_per_block, cudaStream_t stream) {
    GruBwdArgs<S> a;
    a.dh = static_cast<const S*>(dh);
    a.x = static_cast<const S*>(x);
    a.hs = static_cast<const S*>(hs);
    a.h0 = static_cast<const S*>(h0);
    a.dh_in = dh_in;
    a.w = static_cast<const S*>(w);
    a.wt = static_cast<const S*>(wt);
    a.b = b;
    a.dx = static_cast<S*>(dx);
    a.dxw = static_cast<S*>(dxw);
    a.dhw = static_cast<S*>(dhw);
    a.dh_out = dh_out;
    a.steps = T; a.N = N; a.F = F; a.H = H;
    switch (rows_per_block) {
        case 2: return (int)launch<S, 2>(a, stream);
        case 8: return (int)launch<S, 8>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: fsn::kFloat32 or fsn::kBFloat16. Returns a cudaError_t.
extern "C" int fsn_gru_layer_backward(
    const void* dh, const void* x, const void* hs, const void* h0,
    const float* dh_in, const void* w, const void* wt, const float* b,
    void* dx, void* dxw, void* dhw, float* dh_out, int T, int N, int F, int H,
    int rows_per_block, int dtype, void* stream) {
    if (T < 1 || N < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case fsn::kFloat32:
            return run<float>(dh, x, hs, h0, dh_in, w, wt, b, dx, dxw, dhw, dh_out,
                              T, N, F, H, rows_per_block, s);
        case fsn::kBFloat16:
            return run<__nv_bfloat16>(dh, x, hs, h0, dh_in, w, wt, b, dx, dxw, dhw,
                                      dh_out, T, N, F, H, rows_per_block, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
