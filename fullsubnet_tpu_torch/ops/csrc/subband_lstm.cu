// Fused N-layer LSTM scan + Linear head, forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel fullsubnet_tpu/ops/subband_lstm.py:_kernel, as
// launched by _infer_impl (the pl.pallas_call of the inference forward).
// It computes the same function: 1 to 3 stacked LSTM layers (gate order
// i, f, g, o; bias b_ih + b_hh) from zero state over T steps for N
// independent rows, with the Linear head fused. Every layer's h and c stay
// on chip for the whole scan, the inter-layer h never reaches device
// memory, and only the [T, N, OUT] head output is written.
//
// What bounds it on this card. The TPU kernel keeps all weights resident
// in VMEM. An SM has at most 227 KB of shared memory, and the flagship
// stacks hold 7.3 MB (sub-band: in 32, H 384) and 15.2 MB (full-band:
// in 257, H 512, OUT 257) of fp32 weights. So every block streams every
// layer's weights from the 50 MB L2 cache at every step: the kernel moves
// about (weight bytes) x (number of blocks) x T bytes from L2, against
// 2 x (weight bytes / 4) x rows x T FLOPs, and is bound by L2 bandwidth
// (or, with few blocks, by the bandwidth one SM can pull from L2).
//
// What the design does about it. Rows are independent sequences, so the
// TPU's sequential (row_tiles, T) grid becomes one block per tile of R
// rows with the time loop inside the block. R (2 or 8, picked by the
// wrapper from N) amortises each weight read over R rows: thread j owns
// hidden unit j's four gate columns for the block's R rows, reads
// W[k, j + {0,1,2,3}H] coalesced across the warp, and takes [x_t | h][r, k]
// from shared memory as a broadcast. The cell update is then local to the
// thread. h is double-buffered by step parity, so one __syncthreads()
// per layer and step separates the gate products from the next reader.
// Tensor cores (wgmma), TMA and thread block clusters that split the
// weights over several SMs come in later work.
//
// Layouts. x [T, N, F] (rows contiguous, so a block's x_t tile is one
// contiguous run); w_l [in_l + H, 4H] = [W_ih^T ; W_hh^T]; b_l [4H];
// wfc [H, OUT] = W_fc^T; bfc [OUT]; out [T, N, OUT]. All fp32, contiguous.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math: expf/tanhf
//             keep the fp32 results close to the CPU path).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 3;
constexpr int kMaxThreads = 512;

struct ScanArgs {
    const float* x;
    const float* w[kMaxLayers];
    const float* b[kMaxLayers];
    const float* wfc;
    const float* bfc;
    float* out;
    int T, N, F, H, OUT, L;
};

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads) lstm_scan_kernel(ScanArgs a) {
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

    // zero initial state (hbuf and cbuf are contiguous)
    for (int i = threadIdx.x; i < 3 * L * R * H; i += blockDim.x) hbuf[i] = 0.0f;

    for (int t = 0; t < a.T; ++t) {
        const int cur = t & 1;
        const float* xt = a.x + ((size_t)t * a.N + row0) * F;
        for (int i = threadIdx.x; i < R * F; i += blockDim.x) {
            xs[i] = (i < rows * F) ? xt[i] : 0.0f;
        }
        __syncthreads();

        const float* in = xs;
        int in_dim = F;
        for (int l = 0; l < L; ++l) {
            const float* hprev = hbuf + (size_t)(cur * L + l) * R * H;
            float* hnext = hbuf + (size_t)((cur ^ 1) * L + l) * R * H;
            float* c = cbuf + (size_t)l * R * H;
            const float* w = a.w[l];
            const float* bias = a.b[l];

            for (int j = threadIdx.x; j < H; j += blockDim.x) {
                float acc[R][4];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    const float bg = bias[g * H + j];
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r][g] = bg;
                }
                // input part: rows 0 .. in_dim-1 of w_l
                const float* wk = w + j;
#pragma unroll 4
                for (int k = 0; k < in_dim; ++k, wk += G) {
                    const float w0 = __ldg(wk);
                    const float w1 = __ldg(wk + H);
                    const float w2 = __ldg(wk + 2 * H);
                    const float w3 = __ldg(wk + 3 * H);
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
                    const float w0 = __ldg(wk);
                    const float w1 = __ldg(wk + H);
                    const float w2 = __ldg(wk + 2 * H);
                    const float w3 = __ldg(wk + 3 * H);
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
                    c[r * H + j] = cc;
                    hnext[r * H + j] = og * tanhf(cc);
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
            const float* wo = a.wfc + o;
            float acc = a.bfc[o];
            for (int k = 0; k < H; ++k) acc = fmaf(hr[k], __ldg(wo + (size_t)k * a.OUT), acc);
            out_t[i] = acc;
        }
        // the next step's x_t load touches only xs, which no thread reads
        // after the layer-0 barrier; its own barrier orders the rest
    }
}

template <int R>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * ((size_t)R * a.F + 3 * (size_t)a.L * R * a.H);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int threads = ((a.H + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const unsigned grid = (unsigned)((a.N + R - 1) / R);
    lstm_scan_kernel<R><<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" int fsn_lstm_scan_forward(
    const float* x, const float* w0, const float* b0, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* wfc,
    const float* bfc, float* out, int T, int N, int F, int H, int OUT, int L,
    int rows_per_block, void* stream) {
    if (L < 1 || L > kMaxLayers || T < 1 || N < 1 || F < 1 || H < 1 || OUT < 1) {
        return (int)cudaErrorInvalidValue;
    }
    ScanArgs a;
    a.x = x;
    a.w[0] = w0; a.w[1] = w1; a.w[2] = w2;
    a.b[0] = b0; a.b[1] = b1; a.b[2] = b2;
    a.wfc = wfc;
    a.bfc = bfc;
    a.out = out;
    a.T = T; a.N = N; a.F = F; a.H = H; a.OUT = OUT; a.L = L;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (rows_per_block) {
        case 2: return (int)launch<2>(a, s);
        case 8: return (int)launch<8>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* fsn_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
