// Fused N-layer LSTM scan + Linear head, TRAINING forward with state
// stashes, fp32 or bf16 storage, for Hopper (sm_90a): the port's first K2,
// of the earlier design. No path runs it now: fp32 storage runs the stages
// fsn_fwd_gemm and the fp32 training walk (rnn_fwd.cu's cluster walk with
// its c stream for few rows, rnn_train_fwd_f32.cu for many), bf16 storage
// the tensor-core stages (rnn_bwd_tc.cu, rnn_train_fwd_tc.cu).
// chip_smoke.py checks and times this kernel (fp32, and its bf16 instance)
// beside the stages that replaced it.
//
// Replaces the TPU kernel fullsubnet_tpu/ops/subband_lstm.py:
// _kernel_train_fwd, as launched by _stash_fwd_call (the pl.pallas_call
// of the training forward). It computes the same function: 1 to 3 stacked
// LSTM layers (gate order i, f, g, o; bias b_ih + b_hh) over T steps for
// N independent rows, from given per-row initial states (h0, c0 of every
// layer), with the Linear head fused. Besides the [T, N, OUT] head output
// it writes every layer's per-step h and c to [T, N, H] stashes in the
// storage type, which the backward kernel (lstm_layer_bwd.cu) reads.
//
// What bounds it on this card. At the flagship sub-band training shape
// (N = 4096 rows, T = 195, in 32, H 384, 2 layers, bf16) it is 2.9 TFLOP:
// 2.9 ms at the 989 TFLOP/s bf16 tensor-core peak, 43 ms on the fp32
// cores this kernel uses. The stash writes are 2.45 GB (0.73 ms at
// 3.35 TB/s). At the full-band shape (N = 32, in 257, H 512) the FLOPs
// are 47 GFLOP and the chain of T dependent steps bounds it. As in the
// inference kernel (subband_lstm.cu), the weights do not fit in shared
// memory, so every block streams every layer's weights from L2 at every
// step, and with few blocks what one SM can pull from L2 limits it. bf16
// storage halves those bytes, yet on an H100 the bf16 kernel measured no
// faster than the fp32 one (PERF.md): with 8 rows per block the fp32 FMAs
// and the shared-memory reads that feed them set the pace, not L2.
//
// What the design does about it. The inference kernel's structure: one
// block per tile of R rows (2 or 8) with the time loop inside; thread j
// owns hidden unit j's four gate columns for the block's R rows, reads
// W[k, j + {0,1,2,3}H] coalesced across the warp and takes [x_t | h][r, k]
// from shared memory as a broadcast; h double-buffered by step parity.
// The stash writes are coalesced across j and never read back here.
// h is rounded to the storage type where it is produced, because the TPU
// kernel casts it to the compute dtype before every product and stashes
// the cast value; c stays fp32 in shared memory and is stashed rounded.
// Tensor cores (wgmma), TMA and clusters come in later work.
//
// Layouts. x [T, N, F]; w_l [in_l + H, 4H] = [W_ih^T ; W_hh^T]; b_l [4H]
// fp32; wfc [H, OUT] = W_fc^T; bfc [OUT] fp32; h0_l, c0_l [N, H];
// out [T, N, OUT] fp32; hs_l, cs_l [T, N, H]. All contiguous; the
// unmarked ones in the storage type.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math).

#include "lstm_train_common.cuh"

namespace {

using fsn::Io;
using fsn::kMaxLayers;
using fsn::kMaxThreads;
using fsn::sigmoid_f;

template <typename S>
struct StashArgs {
    const S* x;
    const S* w[kMaxLayers];
    const float* b[kMaxLayers];
    const S* wfc;
    const float* bfc;
    const S* h0[kMaxLayers];
    const S* c0[kMaxLayers];
    float* out;
    S* hs[kMaxLayers];
    S* cs[kMaxLayers];
    int steps, N, F, H, OUT, L;
};

template <typename S, int R>
__global__ void __launch_bounds__(kMaxThreads) lstm_stash_forward_kernel(StashArgs<S> a) {
    extern __shared__ float smem[];
    const int H = a.H;
    const int F = a.F;
    const int L = a.L;
    const int G = 4 * H;
    const int row0 = blockIdx.x * R;
    const int rows = min(R, a.N - row0);

    float* xs = smem;                     // [R][F]   x_t tile
    float* hbuf = xs + R * F;             // [2][L][R][H]  h by step parity
    float* cbuf = hbuf + 2 * L * R * H;   // [L][R][H]

    // initial states into parity 0 (rows past N start, and stay, at zero)
    for (int l = 0; l < L; ++l) {
        float* h = hbuf + (size_t)l * R * H;
        float* c = cbuf + (size_t)l * R * H;
        for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
            const bool real = i < rows * H;
            const size_t g = (size_t)row0 * H + i;
            h[i] = real ? Io<S>::load(a.h0[l] + g) : 0.0f;
            c[i] = real ? Io<S>::load(a.c0[l] + g) : 0.0f;
        }
    }

    for (int t = 0; t < a.steps; ++t) {
        const int cur = t & 1;
        const S* xt = a.x + ((size_t)t * a.N + row0) * F;
        for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
            xs[i] = (i < rows * F) ? Io<S>::load(xt + i) : 0.0f;
        }
        __syncthreads();

        const float* in = xs;
        int in_dim = F;
        for (int l = 0; l < L; ++l) {
            const float* hprev = hbuf + (size_t)(cur * L + l) * R * H;
            float* hnext = hbuf + (size_t)((cur ^ 1) * L + l) * R * H;
            float* c = cbuf + (size_t)l * R * H;
            const S* w = a.w[l];
            const float* bias = a.b[l];
            S* hs_t = a.hs[l] + ((size_t)t * a.N + row0) * H;
            S* cs_t = a.cs[l] + ((size_t)t * a.N + row0) * H;

            for (int j = threadIdx.x; j < H; j += blockDim.x) {
                float acc[R][4];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    const float bg = bias[g * H + j];
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r][g] = bg;
                }
                // input part: rows 0 .. in_dim-1 of w_l
                const S* wk = w + j;
#pragma unroll 4
                for (int k = 0; k < in_dim; ++k, wk += G) {
                    const float w0 = Io<S>::load(wk);
                    const float w1 = Io<S>::load(wk + H);
                    const float w2 = Io<S>::load(wk + 2 * H);
                    const float w3 = Io<S>::load(wk + 3 * H);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float v = in[r * in_dim + k];
                        acc[r][0] = fmaf(v, w0, acc[r][0]);
                        acc[r][1] = fmaf(v, w1, acc[r][1]);
                        acc[r][2] = fmaf(v, w2, acc[r][2]);
                        acc[r][3] = fmaf(v, w3, acc[r][3]);
                    }
                }
                // recurrent part: rows in_dim .. in_dim+H-1 of w_l
#pragma unroll 4
                for (int k = 0; k < H; ++k, wk += G) {
                    const float w0 = Io<S>::load(wk);
                    const float w1 = Io<S>::load(wk + H);
                    const float w2 = Io<S>::load(wk + 2 * H);
                    const float w3 = Io<S>::load(wk + 3 * H);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float v = hprev[r * H + k];
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
                    const float cc = fg * c[r * H + j] + ig * gg;
                    const float hv = Io<S>::round(og * tanhf(cc));
                    c[r * H + j] = cc;
                    hnext[r * H + j] = hv;
                    if (r < rows) {
                        Io<S>::store(hs_t + r * H + j, hv);
                        Io<S>::store(cs_t + r * H + j, cc);
                    }
                }
            }
            __syncthreads();
            in = hnext;
            in_dim = H;
        }

        // Linear head over (row, out) pairs; wfc reads coalesce across out
        float* out_t = a.out + ((size_t)t * a.N + row0) * a.OUT;
        for (int i = threadIdx.x; i < rows * a.OUT; i += blockDim.x) {
            const int r = i / a.OUT;
            const int o = i - r * a.OUT;
            const float* hr = in + r * H;
            const S* wo = a.wfc + o;
            float acc = a.bfc[o];
            for (int k = 0; k < H; ++k) acc = fmaf(hr[k], Io<S>::load(wo + (size_t)k * a.OUT), acc);
            out_t[i] = acc;
        }
        // the next step's x_t load touches only xs, which no thread reads
        // after the layer-0 barrier; its own barrier orders the rest
    }
}

template <typename S, int R>
cudaError_t launch(const StashArgs<S>& a, cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * ((size_t)R * a.F + 3 * (size_t)a.L * R * a.H);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_stash_forward_kernel<S, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + R - 1) / R);
    lstm_stash_forward_kernel<S, R><<<grid, fsn::block_threads(a.H), smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename S>
int run(const void* x, const void* const* w, const float* const* b,
        const void* wfc, const float* bfc, const void* const* h0,
        const void* const* c0, float* out, void* const* hs, void* const* cs,
        int T, int N, int F, int H, int OUT, int L, int rows_per_block,
        cudaStream_t stream) {
    StashArgs<S> a;
    a.x = static_cast<const S*>(x);
    for (int l = 0; l < kMaxLayers; ++l) {
        const bool on = l < L;
        a.w[l] = on ? static_cast<const S*>(w[l]) : nullptr;
        a.b[l] = on ? b[l] : nullptr;
        a.h0[l] = on ? static_cast<const S*>(h0[l]) : nullptr;
        a.c0[l] = on ? static_cast<const S*>(c0[l]) : nullptr;
        a.hs[l] = on ? static_cast<S*>(hs[l]) : nullptr;
        a.cs[l] = on ? static_cast<S*>(cs[l]) : nullptr;
    }
    a.wfc = static_cast<const S*>(wfc);
    a.bfc = bfc;
    a.out = out;
    a.steps = T; a.N = N; a.F = F; a.H = H; a.OUT = OUT; a.L = L;
    switch (rows_per_block) {
        case 2: return (int)launch<S, 2>(a, stream);
        case 8: return (int)launch<S, 8>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Pointer arrays (w, b, h0, c0, hs, cs) hold L entries each, in layer
// order. dtype: fsn::kFloat32 or fsn::kBFloat16. Returns a cudaError_t.
extern "C" int fsn_lstm_stash_forward(
    const void* x, const void* const* w, const float* const* b,
    const void* wfc, const float* bfc, const void* const* h0,
    const void* const* c0, float* out, void* const* hs, void* const* cs,
    int T, int N, int F, int H, int OUT, int L, int rows_per_block,
    int dtype, void* stream) {
    if (L < 1 || L > kMaxLayers || T < 1 || N < 1 || F < 1 || H < 1 || OUT < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case fsn::kFloat32:
            return run<float>(x, w, b, wfc, bfc, h0, c0, out, hs, cs,
                              T, N, F, H, OUT, L, rows_per_block, s);
        case fsn::kBFloat16:
            return run<__nv_bfloat16>(x, w, b, wfc, bfc, h0, c0, out, hs, cs,
                                      T, N, F, H, OUT, L, rows_per_block, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* fsn_train_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
