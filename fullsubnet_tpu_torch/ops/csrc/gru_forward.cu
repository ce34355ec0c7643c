// Fused N-layer GRU scan + Linear head, forward, for Hopper (sm_90a): the
// inference forward (K1-GRU, fp32) and the training forward with h stashes
// (K2-GRU, fp32 or bf16 storage), one kernel template for both: the port's
// first K1-GRU and K2-GRU, of the earlier design. No path runs them now:
// the inference forward runs rnn_fwd.cu's stages, the fp32 training forward
// fsn_fwd_gemm and the fp32 training walk (rnn_fwd.cu's cluster walk for few
// rows, rnn_train_fwd_f32.cu for many), the bf16 one the tensor-core stages.
// chip_smoke.py checks and times both beside the stages that replaced them.
//
// Replaces the GRU cell of two TPU kernels in
// fullsubnet_tpu/ops/subband_lstm.py: _kernel with _gru_step, as launched
// by _infer_impl (the pl.pallas_call of the inference forward), and the GRU
// branch of _kernel_train_fwd, as launched by _stash_fwd_call (the
// pl.pallas_call of the training forward). They compute 1 to 3 stacked GRU
// layers (torch semantics, gate order r, z, n: the reset gate scales
// W_hn h + b_hn, so b_ih and b_hh stay apart) over T steps for N
// independent rows, with the Linear head fused. K1-GRU starts from zero
// state and writes only the [T, N, OUT] head output; K2-GRU starts from
// given per-row h0 and also writes every layer's per-step h to a
// [T, N, H] stash in the storage type, which the backward kernel
// (gru_layer_bwd.cu) reads.
//
// What bounds it on this card. As for the LSTM kernels (subband_lstm.cu,
// lstm_train_fwd.cu): the weights do not fit in shared memory, so every
// block streams every layer's weights from L2 at every step; a GRU step
// holds 3H gate columns instead of 4H, so ¾ of the LSTM's weight bytes and
// FLOPs. At the flagship sub-band training shape (N = 4096, T = 195, in 32,
// H 384, 2 layers) it is 2.2 TFLOP, 2.2 ms at the bf16 tensor-core peak and
// 33 ms on the fp32 cores this kernel uses; on an H100 the LSTM twins are
// paced by the fp32 FMAs and the shared-memory reads that feed them.
//
// What the design does about it. The LSTM kernels' structure: one block per
// tile of R rows (2 or 8) with the time loop inside; thread j owns hidden
// unit j's three gate columns for the block's R rows, reads
// W[k, j + {0,1,2}H] coalesced across the warp and takes [x_t | h][r, k]
// from shared memory as a broadcast. Four fp32 sums per row: r and z take
// the x and h parts together (bias b_ih + b_hh), the n gate keeps its x
// part (with b_ih,n) and its h part (with b_hh,n) apart, because only the
// h part is scaled by r. h is double-buffered by step parity.
//
// Rounding (bf16 storage). The TPU kernel keeps the h carry in fp32 scratch
// and casts h to the compute dtype only before the W_hh product, for the
// next layer's input and for the stash. The GRU update
// h = (1 - z) n + z h_prev reads the carry itself, so unlike the LSTM,
// rounding h where it is produced would drift over the steps. So the
// parity buffers hold h rounded to the storage type (what every product and
// the stash read), and a separate fp32 array holds the carry, which only
// thread j reads and writes for unit j. With fp32 storage the rounding is
// the identity and the parity buffers are the carry.
//
// Layouts. x [T, N, F]; w_l [in_l + H, 3H] = [W_ih^T ; W_hh^T];
// b_l [2, 3H] fp32 (rows b_ih, b_hh); wfc [H, OUT] = W_fc^T; bfc [OUT]
// fp32; h0_l [N, H]; out [T, N, OUT] fp32; hs_l [T, N, H]. All contiguous;
// the unmarked ones in the storage type.
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
struct GruArgs {
    const S* x;
    const S* w[kMaxLayers];
    const float* b[kMaxLayers];
    const S* wfc;
    const float* bfc;
    const S* h0[kMaxLayers];  // nullptr: zero initial state
    float* out;
    S* hs[kMaxLayers];        // written only when the kernel stashes
    int steps, N, F, H, OUT, L;
};

// whether the fp32 h carry needs an array of its own beside the rounded h
template <typename S>
struct Carry {
    static constexpr bool kSeparate = true;
};
template <>
struct Carry<float> {
    static constexpr bool kSeparate = false;
};

template <typename S>
size_t forward_smem(int R, int F, int H, int L) {
    const size_t planes = Carry<S>::kSeparate ? 3 : 2;
    return sizeof(float) * ((size_t)R * F + planes * (size_t)L * R * H);
}

template <typename S, int R, bool kStash>
__global__ void __launch_bounds__(kMaxThreads) gru_forward_kernel(GruArgs<S> a) {
    extern __shared__ float smem[];
    const int H = a.H;
    const int F = a.F;
    const int L = a.L;
    const int G = 3 * H;
    const int row0 = blockIdx.x * R;
    const int rows = min(R, a.N - row0);
    constexpr bool kCarry = Carry<S>::kSeparate;

    float* xs = smem;                     // [R][F]   x_t tile
    float* hbuf = xs + R * F;             // [2][L][R][H]  h rounded to S, by step parity
    float* hcar = hbuf + 2 * L * R * H;   // [L][R][H]  fp32 h carry (kCarry only)

    // initial states into parity 0 (rows past N start, and stay, at zero)
    for (int l = 0; l < L; ++l) {
        float* h = hbuf + (size_t)l * R * H;
        for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
            const bool real = a.h0[l] != nullptr && i < rows * H;
            const float v = real ? Io<S>::load(a.h0[l] + (size_t)row0 * H + i) : 0.0f;
            h[i] = v;
            if (kCarry) hcar[(size_t)l * R * H + i] = v;
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
            float* carry = hcar + (size_t)l * R * H;
            const S* w = a.w[l];
            const float* b_ih = a.b[l];
            const float* b_hh = b_ih + G;
            S* hs_t = kStash ? a.hs[l] + ((size_t)t * a.N + row0) * H : nullptr;

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
                // input part: rows 0 .. in_dim-1 of w_l
                const S* wk = w + j;
#pragma unroll 4
                for (int k = 0; k < in_dim; ++k, wk += G) {
                    const float w0 = Io<S>::load(wk);
                    const float w1 = Io<S>::load(wk + H);
                    const float w2 = Io<S>::load(wk + 2 * H);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float v = in[r * in_dim + k];
                        acc[r][0] = fmaf(v, w0, acc[r][0]);
                        acc[r][1] = fmaf(v, w1, acc[r][1]);
                        acc[r][2] = fmaf(v, w2, acc[r][2]);
                    }
                }
                // recurrent part: rows in_dim .. in_dim+H-1 of w_l
#pragma unroll 4
                for (int k = 0; k < H; ++k, wk += G) {
                    const float w0 = Io<S>::load(wk);
                    const float w1 = Io<S>::load(wk + H);
                    const float w2 = Io<S>::load(wk + 2 * H);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float v = hprev[r * H + k];
                        acc[r][0] = fmaf(v, w0, acc[r][0]);
                        acc[r][1] = fmaf(v, w1, acc[r][1]);
                        acc[r][3] = fmaf(v, w2, acc[r][3]);
                    }
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float rg = sigmoid_f(acc[r][0]);
                    const float zg = sigmoid_f(acc[r][1]);
                    const float ng = tanhf(acc[r][2] + rg * acc[r][3]);
                    const float h_prev = kCarry ? carry[r * H + j] : hprev[r * H + j];
                    const float hv = (1.0f - zg) * ng + zg * h_prev;
                    if (kCarry) carry[r * H + j] = hv;
                    const float hr = Io<S>::round(hv);
                    hnext[r * H + j] = hr;
                    if (kStash && r < rows) Io<S>::store(hs_t + r * H + j, hr);
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

template <typename S, int R, bool kStash>
cudaError_t launch(const GruArgs<S>& a, cudaStream_t stream) {
    const size_t smem = forward_smem<S>(R, a.F, a.H, a.L);
    cudaError_t err = cudaFuncSetAttribute(
        gru_forward_kernel<S, R, kStash>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)((a.N + R - 1) / R);
    gru_forward_kernel<S, R, kStash><<<grid, fsn::block_threads(a.H), smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename S, bool kStash>
int run(const void* x, const void* const* w, const float* const* b,
        const void* wfc, const float* bfc, const void* const* h0, float* out,
        void* const* hs, int T, int N, int F, int H, int OUT, int L,
        int rows_per_block, cudaStream_t stream) {
    if (L < 1 || L > kMaxLayers || T < 1 || N < 1 || F < 1 || H < 1 || OUT < 1) {
        return (int)cudaErrorInvalidValue;
    }
    GruArgs<S> a;
    a.x = static_cast<const S*>(x);
    for (int l = 0; l < kMaxLayers; ++l) {
        const bool on = l < L;
        a.w[l] = on ? static_cast<const S*>(w[l]) : nullptr;
        a.b[l] = on ? b[l] : nullptr;
        a.h0[l] = on && h0 != nullptr ? static_cast<const S*>(h0[l]) : nullptr;
        a.hs[l] = on && hs != nullptr ? static_cast<S*>(hs[l]) : nullptr;
    }
    a.wfc = static_cast<const S*>(wfc);
    a.bfc = bfc;
    a.out = out;
    a.steps = T; a.N = N; a.F = F; a.H = H; a.OUT = OUT; a.L = L;
    switch (rows_per_block) {
        case 2: return (int)launch<S, 2, kStash>(a, stream);
        case 8: return (int)launch<S, 8, kStash>(a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// K1-GRU: zero initial state, no stash, fp32. Pointer arrays (w, b) hold L
// entries each, in layer order. Returns a cudaError_t.
extern "C" int fsn_gru_scan_forward(
    const float* x, const void* const* w, const float* const* b,
    const float* wfc, const float* bfc, float* out, int T, int N, int F,
    int H, int OUT, int L, int rows_per_block, void* stream) {
    return run<float, false>(x, w, b, wfc, bfc, nullptr, out, nullptr, T, N, F,
                             H, OUT, L, rows_per_block,
                             static_cast<cudaStream_t>(stream));
}

// K2-GRU: initial states h0 and per-layer h stashes hs (L entries each).
// dtype: fsn::kFloat32 or fsn::kBFloat16. Returns a cudaError_t.
extern "C" int fsn_gru_stash_forward(
    const void* x, const void* const* w, const float* const* b,
    const void* wfc, const float* bfc, const void* const* h0, float* out,
    void* const* hs, int T, int N, int F, int H, int OUT, int L,
    int rows_per_block, int dtype, void* stream) {
    if (h0 == nullptr || hs == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case fsn::kFloat32:
            return run<float, true>(x, w, b, wfc, bfc, h0, out, hs, T, N, F, H,
                                    OUT, L, rows_per_block, s);
        case fsn::kBFloat16:
            return run<__nv_bfloat16, true>(x, w, b, wfc, bfc, h0, out, hs, T, N,
                                            F, H, OUT, L, rows_per_block, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* fsn_gru_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
