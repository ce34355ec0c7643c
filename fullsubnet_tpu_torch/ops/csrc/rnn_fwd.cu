// The inference forward of an LSTM or GRU stack + Linear head (K1 and
// K1-GRU) as separate stages, for Hopper (sm_90a): fp32, and the walk of
// its bf16 instance (K1-bf16).
//
// Replaces the TPU kernel fullsubnet_tpu/ops/subband_lstm.py:_kernel with
// _lstm_step or _gru_step, as launched by _infer_impl (the pl.pallas_call of
// the inference forward). The function is the same: 1 to 3 layers from a
// given state over T steps for N independent rows, then the head. The
// Python side (ops/subband_lstm.py, fused_forward) runs, for each chunk of
// Tc steps: fsn_fwd_gemm for layer 0's input projection, the walk of layer
// 0, fsn_fwd_gemm on its h stream, the walk of layer 1, ..., and
// fsn_fwd_gemm for the head; (h, c) carry from one chunk to the next.
//
// What bounds it on this card. Per step and row the Pallas body does
// [x_t | h_{t-1}] . W and the head. Only h_{t-1} . W_hh^T depends on the
// step before: the input projection and the head read x and the h streams
// alone, so they leave the T-step chain for one GEMM each over all Tc*N
// rows (fp32 SIMT cores: TF32 would change the results). What stays on the
// chain needs all of W_hh^T at every step (4.2 MB at H = 512, 2.4 MB at
// H = 384 for the LSTM), more than an SM holds (227 KB). The earlier
// kernels (subband_lstm.cu, gru_forward.cu) streamed the whole stack from
// L2 at every step in every block of 2 or 8 rows: one SM pulled 15.2 MB a
// step for the full-band stage.
//
// What the design does about it.
//   fsn_fwd_gemm: C = A . B^T + bias, fp32, with B in PyTorch's [out, in]
//   weight layout (A may take a second K segment read one block of rows
//   back, as the fp32 layer backward's recompute [x | h_prev] . W needs:
//   rnn_bwd_f32.cu); 128 x 128 x 8 tiles, 256 threads with 8 x 8 outputs each,
//   a cp.async double buffer (4-byte copies, so odd K and row strides need
//   no padding). It computes the LSTM's
//   P = x . W_ih^T + (b_ih + b_hh), the GRU's P = x . W_ih^T + b_ih (r, z
//   and n's x part; b_hh goes to the walk, since r scales W_hn h + b_hn),
//   and the head h_L . W_fc^T + b_fc. The fp32 training forward (K2, K2-GRU
//   at fp32 storage) runs the same GEMM over all T*N rows at once.
//   The walk: a cluster of 16 CTAs walks a tile of RT rows. CTA k owns the
//   units [k H/16, (k + 1) H/16) and keeps their G gate columns of W_hh^T
//   (rows of W_hh, read once at the start) resident for the whole walk: in
//   shared memory, and for the widest stack
//   (LSTM, H = 512: 256 KB a CTA) its first KR = 48 rows of each K slice in
//   registers. Per step a CTA gathers h_{t-1} from the 16 CTAs' slices
//   through distributed shared memory, does its RT x H x (G H/16) FMAs
//   (each thread a K slice of 4, and one column of all RT rows, or from 16
//   rows on 4 columns of RT/4 rows, so that a shared-memory load of h feeds
//   4 columns), sums the four
//   K slices, adds P_t (prefetched with cp.async during the step before)
//   and does the cell update of its own units, with the c carry (LSTM) or
//   the h carry (GRU) in registers. It writes h_t to its slice (by step
//   parity) and to the layer's h stream, and meets the cluster at one
//   arrive/wait barrier: the slice a CTA overwrites at step t + 1 was read
//   by every CTA at step t, before that barrier. The training instances
//   (kStash, LSTM) also write c_t to a c stream beside h_t: the stashes of
//   the fp32 training forward for few rows (ops/subband_lstm.py,
//   train_f32_streams picks this form where one wave of clusters walks every
//   row; rnn_train_fwd_f32.cu streams W_hh^T for many). The inference
//   instances write no c stream.
//
// The bf16 instance (T = __nv_bfloat16; fsn_rnn_fwd_walk_bf16). It
// replaces the same Pallas kernel called with a bf16 x (_infer_impl's
// compute_dtype = x.dtype): W_hh, W_ih and W_fc rounded to bf16, each step's
// product on bf16 x and on h rounded to bf16 with fp32 sums, c and the
// carried h in fp32 (the GRU's z * h reads the fp32 h), the h stream passed
// on rounded to bf16. Its GEMMs (input projections and head, bf16 in, fp32
// out) are tc_gemm's (rnn_bwd_tc.cu). The walk is this kernel with the
// resident W_hh^T, the gathered h_{t-1}, the CTA's h slice and the h stream
// in bf16, and the products, P_t, the partial sums, the cell and the state
// (h0, c0, h_T, c_T) in fp32: the LSTM's W_hh^T at H = 512 takes 128 KB a
// CTA (fp32: 256 KB, so KR = 48 rows in registers), so the bf16 instances
// keep it all in shared memory (KR = 0), and the exchange moves half the
// bytes. The products stay on the fp32 FMA units (each bf16 value widened
// once as it is read). ops/subband_lstm.py (pick_fwd_bf16_form) takes this
// instance below 8 rows only; from there rnn_fwd_tc.cu's walk on the tensor
// cores serves K1-bf16.
//
// Layouts (fp32, contiguous unless a leading dimension is given; the bf16
// walk's whh and hseq are bf16).
//   GEMM: A [M, K] (lda), or [M, k_split] (lda) and [M, K - k_split] from
//   a_prev/a_head (ldp); B [Nc, K]; bias [Nc] or null; C [M, Nc] (ldc).
//   Walk: p [T, N, G H] (gate blocks i, f, g, o or r, z, n, each H wide);
//   whh [G H, H] = W_hh; bhh [3 H] (GRU) or null; h0, c0, h_out, c_out
//   [N, H]; hseq and cseq (the LSTM's c stream, training instances)
//   [T, N, H]. H a multiple of 16; G H / 4 threads, at most 512.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (no --use_fast_math: expf/tanhf
//             keep the fp32 results close to the CPU path).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

using bf16 = __nv_bfloat16;

// the walk's storage types: fp32, or bf16 widened to fp32 where it is read
// and rounded to nearest even where it is written
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// four consecutive values as fp32: one 16-byte load (fp32) or 8-byte load (bf16)
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive values copied as they are stored
__device__ __forceinline__ void copy4(float* dst, const float* src) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void copy4(bf16* dst, const bf16* src) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes global -> shared; with `full` false nothing is read and the
// bytes are zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

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

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// fsn_fwd_gemm
// ---------------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kPad = kBM + 4;  // a tile row, padded: a warp's transposing copies hit 32 banks
constexpr int kGemmThreads = 256;

struct GemmArgs {
    const float* a;       // columns [0, k_split): row m at a + m * lda
    const float* a_prev;  // columns [k_split, K): row m at a_prev + (m - shift) * ldp,
    const float* a_head;  //   rows m < shift at a_head + m * ldp
    const float* b;
    const float* bias;
    float* c;
    int M, Nc, K, k_split, shift, lda, ldp, ldc;
};

// element (m, k) of A, from its second K segment where k >= k_split
__device__ __forceinline__ const float* a_elem(const GemmArgs& g, int m, int k) {
    if (k < g.k_split) return g.a + (size_t)m * g.lda + k;
    k -= g.k_split;
    return m >= g.shift ? g.a_prev + (size_t)(m - g.shift) * g.ldp + k
                        : g.a_head + (size_t)m * g.ldp + k;
}

// Thread (tm, tn) of a 16 x 16 grid owns rows {4 tm, 64 + 4 tm} + 0..3 and
// columns {4 tn, 64 + 4 tn} + 0..3 of the block's tile: its float4 reads of
// both tiles are broadcasts or conflict-free. kTwo: A has a second K
// segment (a_elem); without it A is read as it always was.
template <bool kTwo>
__global__ void __launch_bounds__(kGemmThreads) fwd_gemm_kernel(GemmArgs g) {
    __shared__ __align__(16) float As[2][kBK][kPad];
    __shared__ __align__(16) float Bs[2][kBK][kPad];
    const int tid = threadIdx.x;
    const int m0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;
    const int tm = tid / 16;
    const int tn = tid % 16;

    auto load = [&](int buf, int k0) {
#pragma unroll
        for (int i = 0; i < kBM * kBK / kGemmThreads; ++i) {
            const int e = tid + i * kGemmThreads;
            const int m = e / kBK;
            const int k = e - m * kBK;
            const bool ok = m0 + m < g.M && k0 + k < g.K;
            const float* src;
            if constexpr (kTwo) {
                src = ok ? a_elem(g, m0 + m, k0 + k) : g.a;
            } else {
                src = ok ? g.a + (size_t)(m0 + m) * g.lda + k0 + k : g.a;
            }
            cp_async_4(smem_addr(&As[buf][k][m]), src, ok);
        }
#pragma unroll
        for (int i = 0; i < kBN * kBK / kGemmThreads; ++i) {
            const int e = tid + i * kGemmThreads;
            const int n = e / kBK;
            const int k = e - n * kBK;
            const bool ok = n0 + n < g.Nc && k0 + k < g.K;
            const float* src = ok ? g.b + (size_t)(n0 + n) * g.K + k0 + k : g.b;
            cp_async_4(smem_addr(&Bs[buf][k][n]), src, ok);
        }
        cp_async_commit();
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    const int ktiles = (g.K + kBK - 1) / kBK;
    load(0, 0);
    for (int kt = 0; kt < ktiles; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < ktiles) {
            load(buf ^ 1, (kt + 1) * kBK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][4 * tm]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + 4 * tm]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][4 * tn]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + 4 * tn]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();  // the next load overwrites this buffer
    }

    const bool vec = g.ldc % 4 == 0 && (reinterpret_cast<uintptr_t>(g.c) & 15) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? 4 * tm + i : 64 + 4 * tm + i - 4);
        if (m >= g.M) continue;
        float* crow = g.c + (size_t)m * g.ldc;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int n = n0 + half * 64 + 4 * tn;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float b = (g.bias != nullptr && n + j < g.Nc) ? g.bias[n + j] : 0.0f;
                v[j] = acc[i][4 * half + j] + b;
            }
            if (vec && n + 3 < g.Nc) {
                *reinterpret_cast<float4*>(crow + n) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (n + j < g.Nc) crow[n + j] = v[j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The walk
// ---------------------------------------------------------------------------

constexpr int kCtas = 16;          // CTAs of a cluster
constexpr int kSlices = 4;         // K slices of the recurrent product
constexpr int kWalkMaxThreads = 512;
constexpr int kWideRows = 16;      // tiles from this many rows give a thread 4 columns

struct WalkArgs {
    const float* p;
    const void* whh;    // fp32, or bf16 (the bf16 instances)
    const float* bhh;
    const float* h0;
    const float* c0;
    void* hseq;         // fp32, or bf16 (the bf16 instances)
    float* cseq;        // the c stream (kStash instances), else unused
    float* h_out;
    float* c_out;
    long long* clocks;  // null, or [3]: block 0's cycles in the exchange (gather and
                        // barrier), the product and the cell, over all steps
    int T, N, H;
};

// Thread tid = s C + q owns K slice s of the product and, with CPT = 4
// columns a thread in the wide tiles (1 otherwise), the columns
// [CPT cg, CPT (cg + 1)) (local column c: gate c / HC, unit c % HC of the
// CTA) of the rows [RPT rg, RPT (rg + 1)), where q = rg C / CPT + cg. Each
// h_{t-1} value it loads then feeds CPT columns and each weight RPT rows.
// It also does the cell update of the pairs (row, unit) = tid + i G 4 HC
// for i < PAIRS. kStash (LSTM only) writes each pair's c_t to a.cseq. T is
// the storage type of W_hh^T, of h_{t-1} as it is gathered and of the h
// stream (float, or bf16 for K1-bf16); the sums and the state are fp32.
template <typename T, int RT, bool kLstm, int KR, bool kStash>
__global__ void __launch_bounds__(kWalkMaxThreads, 1) rnn_fwd_walk_kernel(WalkArgs a) {
    static_assert(kLstm || !kStash, "the GRU's stash is its h stream");
    constexpr bool kBf16 = sizeof(T) == 2;
    static_assert(!kBf16 || !kStash, "the bf16 instances write no c stream");
    constexpr int G = kLstm ? 4 : 3;
    constexpr int PAIRS = (RT + kSlices * G - 1) / (kSlices * G);
    constexpr int CPT = (RT >= kWideRows && KR == 0) ? 4 : 1;
    constexpr int RPT = RT / CPT;
    const int H = a.H;
    const int HC = H / kCtas;
    const int C = G * HC;
    const int KL = H / kSlices;
    const int GH = G * H;
    const int nthreads = kSlices * C;
    const bool vec = HC % 4 == 0;

    const T* whh = static_cast<const T*>(a.whh);
    T* hseq = static_cast<T*>(a.hseq);
    // every region's byte size is a multiple of 16 where a 16- or 8-byte
    // access reads it (H a multiple of 16; HC a multiple of 4 where vec)
    extern __shared__ __align__(16) float fsn_fwd_smem[];
    T* sW = reinterpret_cast<T*>(fsn_fwd_smem);    // [4][KL - KR][C] W_hh^T rows beyond KR
    T* sH = sW + kSlices * (KL - KR) * C;          // [RT][H] h_{t-1}; then the partials
    float* sPart = reinterpret_cast<float*>(sH);   // [4][RT][C] partial sums
    const int h_bytes = max((int)sizeof(T) * RT * H, (int)sizeof(float) * kSlices * RT * C);
    T* sOwn = reinterpret_cast<T*>(reinterpret_cast<char*>(sH) + h_bytes);
                                                   // [2][RT][HC] this CTA's h, by step parity
    float* sP = reinterpret_cast<float*>(sOwn + 2 * RT * HC);  // [RT][C] P_t of its columns
    float* sB = sP + RT * C;                       // [C] b_hh of them (GRU)

    cg::cluster_group cluster = cg::this_cluster();
    const int u0 = (int)cluster.block_rank() * HC;
    const int row0 = (int)(blockIdx.x / kCtas) * RT;
    const int rows = min(RT, a.N - row0);
    const int tid = threadIdx.x;
    const int s = tid / C;
    const int k0 = s * KL;
    const int q = tid - s * C;
    const int rg = q / (C / CPT);
    const int col0 = (q - rg * (C / CPT)) * CPT;
    const int r0 = rg * RPT;

    // the resident weights, W_hh^T [k][column] = W_hh [column][k]: column
    // col0's first KR rows of slice s in registers (KR > 0 only with one
    // column a thread)
    float wreg[KR > 0 ? KR : 1];
    {
        const T* wrow = whh + (size_t)((col0 / HC) * H + u0 + col0 % HC) * H + k0;
#pragma unroll
        for (int i = 0; i < KR; ++i) wreg[i] = to_f(__ldg(wrow + i));
    }
    const int KS = KL - KR;
    for (int idx = tid; idx < kSlices * KS * C; idx += nthreads) {
        const int rest = idx / C;
        const int cc = idx - rest * C;
        const int ss = rest / KS;
        const int kk = rest - ss * KS;
        sW[idx] = __ldg(whh + (size_t)((cc / HC) * H + u0 + cc % HC) * H + ss * KL + KR + kk);
    }
    if constexpr (!kLstm) {
        for (int idx = tid; idx < C; idx += nthreads) sB[idx] = a.bhh[(idx / HC) * H + u0 + idx % HC];
    }

    // P_t of this CTA's columns and rows (zeros past N)
    auto prefetch_p = [&](int t) {
        const float* pt = a.p + ((size_t)t * a.N + row0) * GH;
        if (vec) {
            const int q = HC / 4;
            for (int idx = tid; idx < RT * G * q; idx += nthreads) {
                const int r = idx / (G * q);
                const int rem = idx - r * G * q;
                const int g = rem / q;
                const int i4 = rem - g * q;
                const bool ok = r < rows;
                const float* src = ok ? pt + (size_t)r * GH + g * H + u0 + 4 * i4 : a.p;
                cp_async_16(smem_addr(sP + r * C + g * HC + 4 * i4), src, ok);
            }
        } else {
            for (int idx = tid; idx < RT * C; idx += nthreads) {
                const int r = idx / C;
                const int cc = idx - r * C;
                const bool ok = r < rows;
                const float* src = ok ? pt + (size_t)r * GH + (cc / HC) * H + u0 + cc % HC : a.p;
                cp_async_4(smem_addr(sP + idx), src, ok);
            }
        }
        cp_async_commit();
    };

    // the initial state: h0 into this CTA's slice (parity 0), c0 (LSTM) or
    // h0 (GRU) into the carries. The bf16 LSTM also keeps its last fp32 h
    // (the slice holds it rounded); the GRU's is its carry.
    float carry[PAIRS];
    float hlast[(kBf16 && kLstm) ? PAIRS : 1];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
        carry[i] = 0.0f;
        if constexpr (kBf16 && kLstm) hlast[i] = 0.0f;
        const int pidx = tid + i * nthreads;
        if (pidx < RT * HC) {
            const int r = pidx / HC;
            const int u = pidx - r * HC;
            float h = 0.0f;
            if (r < rows) {
                const size_t o = (size_t)(row0 + r) * H + u0 + u;
                h = a.h0[o];
                carry[i] = kLstm ? a.c0[o] : h;
                if constexpr (kBf16 && kLstm) hlast[i] = h;
            }
            sOwn[r * HC + u] = from_f<T>(h);
        }
    }
    prefetch_p(0);
    cluster_arrive();
    cluster_wait();  // every CTA's weights and h0 slice are in place

    long long clk[3] = {0, 0, 0};
    for (int t = 0; t < a.T; ++t) {
        const long long t0 = clock64();
        const int cur = t & 1;
        // gather h_{t-1}: CTA k's slice row r -> sH[r][k HC ...]
        if (vec) {
            const int q = HC / 4;
            for (int idx = tid; idx < RT * H / 4; idx += nthreads) {
                const int r = idx / (H / 4);
                const int rem = idx - r * (H / 4);
                const int k = rem / q;
                const T* remote = cluster.map_shared_rank(sOwn + cur * RT * HC, k);
                copy4(sH + r * H + 4 * rem, remote + r * HC + 4 * (rem - k * q));
            }
        } else {
            for (int idx = tid; idx < RT * H; idx += nthreads) {
                const int r = idx / H;
                const int rem = idx - r * H;
                const int k = rem / HC;
                const T* remote = cluster.map_shared_rank(sOwn + cur * RT * HC, k);
                sH[idx] = remote[r * HC + rem - k * HC];
            }
        }
        __syncthreads();
        const long long t1 = clock64();

        // h_{t-1} . W_hh^T for this thread's rows and columns over K slice s
        float acc[RPT][CPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.0f;
        const T* hk = sH + r0 * H + k0;
#pragma unroll
        for (int i = 0; i < KR; i += 4) {
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const float4 hv = load4(hk + r * H + i);
                acc[r][0] = fmaf(hv.x, wreg[i], acc[r][0]);
                acc[r][0] = fmaf(hv.y, wreg[i + 1], acc[r][0]);
                acc[r][0] = fmaf(hv.z, wreg[i + 2], acc[r][0]);
                acc[r][0] = fmaf(hv.w, wreg[i + 3], acc[r][0]);
            }
        }
        const T* wk = sW + s * KS * C + col0;
        // a wide tile's body is already RPT x CPT x 4 independent FMAs;
        // unrolling it further only spills
#pragma unroll(RPT * CPT >= 16 ? 1 : 4)
        for (int i = KR; i < KL; i += 4) {
            float wv[4][CPT];
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
                const T* wi = wk + (i - KR + kq) * C;
                if constexpr (CPT == 4) {
                    const float4 w4 = load4(wi);
                    wv[kq][0] = w4.x;
                    wv[kq][1] = w4.y;
                    wv[kq][2] = w4.z;
                    wv[kq][3] = w4.w;
                } else {
                    wv[kq][0] = to_f(wi[0]);
                }
            }
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const float4 hv = load4(hk + r * H + i);
#pragma unroll
                for (int cc = 0; cc < CPT; ++cc) {
                    acc[r][cc] = fmaf(hv.x, wv[0][cc], acc[r][cc]);
                    acc[r][cc] = fmaf(hv.y, wv[1][cc], acc[r][cc]);
                    acc[r][cc] = fmaf(hv.z, wv[2][cc], acc[r][cc]);
                    acc[r][cc] = fmaf(hv.w, wv[3][cc], acc[r][cc]);
                }
            }
        }
        const long long t2 = clock64();
        __syncthreads();  // every thread has read h_{t-1}: sH takes the partials
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) sPart[(s * RT + r0 + r) * C + col0 + cc] = acc[r][cc];
        cp_async_wait<0>();
        __syncthreads();  // the partials and P_t are in place

        // the cell update of this thread's pairs
        T* own_next = sOwn + (cur ^ 1) * RT * HC;
#pragma unroll
        for (int i = 0; i < PAIRS; ++i) {
            const int pidx = tid + i * nthreads;
            if (pidx < RT * HC) {
                const int r = pidx / HC;
                const int u = pidx - r * HC;
                float gate[G];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    float v = 0.0f;
#pragma unroll
                    for (int ss = 0; ss < kSlices; ++ss) v += sPart[(ss * RT + r) * C + g * HC + u];
                    gate[g] = v;
                }
                const float* pr = sP + r * C + u;
                float h;
                if constexpr (kLstm) {
                    const float ig = sigmoid_f(pr[0] + gate[0]);
                    const float fg = sigmoid_f(pr[HC] + gate[1]);
                    const float gg = tanhf(pr[2 * HC] + gate[2]);
                    const float og = sigmoid_f(pr[3 * HC] + gate[3]);
                    carry[i] = fg * carry[i] + ig * gg;
                    h = og * tanhf(carry[i]);
                    if constexpr (kBf16) hlast[i] = h;
                } else {
                    const float* b = sB + u;
                    const float rg = sigmoid_f(pr[0] + (gate[0] + b[0]));
                    const float zg = sigmoid_f(pr[HC] + (gate[1] + b[HC]));
                    const float ng = tanhf(pr[2 * HC] + rg * (gate[2] + b[2 * HC]));
                    h = (1.0f - zg) * ng + zg * carry[i];
                    carry[i] = h;
                }
                const T hq = from_f<T>(h);
                own_next[r * HC + u] = hq;
                if (r < rows) {
                    const size_t o = ((size_t)t * a.N + row0 + r) * H + u0 + u;
                    hseq[o] = hq;
                    if constexpr (kStash) a.cseq[o] = carry[i];
                }
            }
        }
        __syncthreads();  // P_t is consumed
        if (t + 1 < a.T) prefetch_p(t + 1);
        const long long t3 = clock64();
        cluster_arrive();  // this CTA's h_t slice is written, and it has read the h_{t-1} slices
        cluster_wait();
        const long long t4 = clock64();
        clk[0] += (t1 - t0) + (t4 - t3);
        clk[1] += t2 - t1;
        clk[2] += t3 - t2;
    }
    if (a.clocks != nullptr && blockIdx.x == 0 && tid == 0) {
        a.clocks[0] = clk[0];
        a.clocks[1] = clk[1];
        a.clocks[2] = clk[2];
    }

    // the state after the last step, fp32; each thread reads back what it
    // wrote (the fp32 slice), or its own registers (bf16)
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
        const int pidx = tid + i * nthreads;
        if (pidx < RT * HC) {
            const int r = pidx / HC;
            const int u = pidx - r * HC;
            if (r < rows) {
                const size_t o = (size_t)(row0 + r) * H + u0 + u;
                if constexpr (!kBf16) {
                    a.h_out[o] = sOwn[(a.T & 1) * RT * HC + r * HC + u];
                } else if constexpr (kLstm) {
                    a.h_out[o] = hlast[i];
                } else {
                    a.h_out[o] = carry[i];
                }
                if constexpr (kLstm) a.c_out[o] = carry[i];
            }
        }
    }
}

// bytes of dynamic shared memory (the kernel's layout); `storage` is
// sizeof(T), 4 or 2
size_t walk_smem(bool lstm, int H, int rows, int kr, size_t storage = sizeof(float)) {
    const size_t g = lstm ? 4 : 3;
    const size_t hc = H / kCtas;
    const size_t c = g * hc;
    const size_t kl = H / kSlices;
    const size_t h_bytes = storage * rows * H > sizeof(float) * kSlices * rows * c
                               ? storage * rows * H : sizeof(float) * kSlices * rows * c;
    return storage * (kSlices * (kl - kr) * c + 2 * (size_t)rows * hc) + h_bytes +
           sizeof(float) * ((size_t)rows * c + (lstm ? 0 : c));
}

// sets the kernel's attributes and a launch configuration for `tiles` tiles
template <typename T, int RT, bool kLstm, int KR, bool kStash>
cudaError_t walk_config(int H, int tiles, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                        cudaLaunchAttribute (&attr)[1]) {
    auto kernel = rnn_fwd_walk_kernel<T, RT, kLstm, KR, kStash>;
    const size_t smem = walk_smem(kLstm, H, RT, KR, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cfg = {};
    cfg.gridDim = dim3((unsigned)(kCtas * tiles), 1, 1);
    cfg.blockDim = dim3((unsigned)(kSlices * (kLstm ? 4 : 3) * (H / kCtas)), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

// launch (max_clusters null) or ask how many clusters of this instance fit
// on the card at once
template <typename T, int RT, bool kLstm, int KR, bool kStash>
cudaError_t walk_run(const WalkArgs& a, cudaStream_t stream, int* max_clusters) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const int tiles = max_clusters ? 1 : (a.N + RT - 1) / RT;
    cudaError_t err = walk_config<T, RT, kLstm, KR, kStash>(a.H, tiles, stream, cfg, attr);
    if (err != cudaSuccess) return err;
    auto kernel = rnn_fwd_walk_kernel<T, RT, kLstm, KR, kStash>;
    if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool kLstm, int KR, bool kStash, typename T = float>
cudaError_t walk_by_rows(const WalkArgs& a, int rows, cudaStream_t stream, int* max_clusters) {
    switch (rows) {
        case 1: return walk_run<T, 1, kLstm, KR, kStash>(a, stream, max_clusters);
        case 2: return walk_run<T, 2, kLstm, KR, kStash>(a, stream, max_clusters);
        case 4: return walk_run<T, 4, kLstm, KR, kStash>(a, stream, max_clusters);
        case 8: return walk_run<T, 8, kLstm, KR, kStash>(a, stream, max_clusters);
        case 16: return walk_run<T, 16, kLstm, KR, kStash>(a, stream, max_clusters);
        case 32: return walk_run<T, 32, kLstm, KR, kStash>(a, stream, max_clusters);
        case 40: return walk_run<T, 40, kLstm, KR, kStash>(a, stream, max_clusters);
        default: return cudaErrorInvalidValue;
    }
}

constexpr int kRegRows = 48;  // the KR of the register-holding instances

// the bf16 instances: no register rows (KR = 0), no c stream
cudaError_t walk_dispatch(bool lstm, bool stash, const WalkArgs& a, int rows, int kr,
                          cudaStream_t stream, int* max_clusters, bool bf16_walk = false) {
    const int H = a.H;
    const int threads = kSlices * (lstm ? 4 : 3) * (H / kCtas);
    if (H < kCtas || H % kCtas != 0 || threads > kWalkMaxThreads ||
        (kr != 0 && kr != kRegRows) || kr > H / kSlices ||
        (rows >= kWideRows && kr == 0 && threads % (4 * kSlices) != 0) ||
        walk_smem(lstm, H, rows, kr, bf16_walk ? sizeof(bf16) : sizeof(float)) > 232448 ||
        (stash && !lstm) || (bf16_walk && (kr != 0 || stash))) {
        return cudaErrorInvalidValue;
    }
    if (bf16_walk) {
        return lstm ? walk_by_rows<true, 0, false, bf16>(a, rows, stream, max_clusters)
                    : walk_by_rows<false, 0, false, bf16>(a, rows, stream, max_clusters);
    }
    if (stash) {
        return kr ? walk_by_rows<true, kRegRows, true>(a, rows, stream, max_clusters)
                  : walk_by_rows<true, 0, true>(a, rows, stream, max_clusters);
    }
    if (lstm) {
        return kr ? walk_by_rows<true, kRegRows, false>(a, rows, stream, max_clusters)
                  : walk_by_rows<true, 0, false>(a, rows, stream, max_clusters);
    }
    return kr ? walk_by_rows<false, kRegRows, false>(a, rows, stream, max_clusters)
              : walk_by_rows<false, 0, false>(a, rows, stream, max_clusters);
}

}  // namespace

// C = [A | A_prev] . B^T + bias: A [M, k_split] (lda); columns [k_split,
// K) of row m from a_prev row m - shift (ldp), or a_head row m for
// m < shift (a_prev and a_head may be null when k_split = K: then A is
// [M, K] and read as K1's GEMM reads it); B [Nc, K] contiguous, bias [Nc]
// or null, C [M, Nc] (ldc). Returns a cudaError_t.
extern "C" int fsn_fwd_gemm(const float* a, const float* a_prev, const float* a_head,
                            const float* b, const float* bias, float* c, int M, int Nc, int K,
                            int k_split, int shift, int lda, int ldp, int ldc, void* stream) {
    if (M < 1 || Nc < 1 || K < 1 || k_split < 1 || k_split > K || shift < 0 || lda < k_split ||
        ldc < Nc) {
        return (int)cudaErrorInvalidValue;
    }
    const bool two = k_split < K;
    if (two && (a_prev == nullptr || ldp < K - k_split || (shift > 0 && a_head == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    GemmArgs g;
    g.a = a; g.a_prev = a_prev; g.a_head = a_head; g.b = b; g.bias = bias; g.c = c;
    g.M = M; g.Nc = Nc; g.K = K; g.k_split = k_split; g.shift = shift;
    g.lda = lda; g.ldp = ldp; g.ldc = ldc;
    const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Nc + kBN - 1) / kBN), 1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (two) {
        fwd_gemm_kernel<true><<<grid, kGemmThreads, 0, s>>>(g);
    } else {
        fwd_gemm_kernel<false><<<grid, kGemmThreads, 0, s>>>(g);
    }
    return (int)cudaGetLastError();
}

// One layer's walk over T steps. lstm = 1: c0 and c_out used, bhh null, and
// cseq, where not null, takes the c stream (the training instances); lstm =
// 0 (GRU): bhh [3H] used, cseq null. rows 1, 2, 4, 8, 16, 32 or 40 per
// cluster; kr 0 or 48 (at 16 rows and more, kr 0 needs 4 | G H/16). clocks
// null, or [3] int64. Returns a cudaError_t.
extern "C" int fsn_rnn_fwd_walk(int lstm, const float* p, const float* whh, const float* bhh,
                                const float* h0, const float* c0, float* hseq, float* cseq,
                                float* h_out, float* c_out, long long* clocks, int T, int N, int H,
                                int rows, int kr, void* stream) {
    if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
    if (lstm ? (c0 == nullptr || c_out == nullptr) : (bhh == nullptr || cseq != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.p = p; a.whh = whh; a.bhh = bhh; a.h0 = h0; a.c0 = c0;
    a.hseq = hseq; a.cseq = cseq; a.h_out = h_out; a.c_out = c_out; a.clocks = clocks;
    a.T = T; a.N = N; a.H = H;
    return (int)walk_dispatch(lstm != 0, cseq != nullptr, a, rows, kr,
                              static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the walk instance (cell, stash, H, rows, kr) the
// current card runs at once (cudaOccupancyMaxActiveClusters), into *out.
// stash = 1 (LSTM only): the instance with the c stream.
extern "C" int fsn_rnn_fwd_max_clusters(int lstm, int stash, int H, int rows, int kr, int* out) {
    WalkArgs a = {};
    a.T = 1; a.N = rows; a.H = H;
    *out = 0;
    return (int)walk_dispatch(lstm != 0, stash != 0, a, rows, kr, nullptr, out);
}

// The walk of K1-bf16 (K1-GRU-bf16): as fsn_rnn_fwd_walk with W_hh
// [G H, H] and the h stream [T, N, H] in bf16; p, bhh, h0, c0, h_out and
// c_out fp32. rows 1, 2, 4, 8, 16, 32 or 40, where the tile fits in shared
// memory (KR = 0). Returns a cudaError_t.
extern "C" int fsn_rnn_fwd_walk_bf16(int lstm, const float* p, const void* whh, const float* bhh,
                                     const float* h0, const float* c0, void* hseq, float* h_out,
                                     float* c_out, long long* clocks, int T, int N, int H,
                                     int rows, void* stream) {
    if (T < 1 || N < 1) return (int)cudaErrorInvalidValue;
    if (lstm ? (c0 == nullptr || c_out == nullptr) : bhh == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.p = p; a.whh = whh; a.bhh = bhh; a.h0 = h0; a.c0 = c0;
    a.hseq = hseq; a.cseq = nullptr; a.h_out = h_out; a.c_out = c_out; a.clocks = clocks;
    a.T = T; a.N = N; a.H = H;
    return (int)walk_dispatch(lstm != 0, false, a, rows, 0, static_cast<cudaStream_t>(stream),
                              nullptr, true);
}

// How many clusters of the bf16 walk instance (cell, H, rows) the current
// card runs at once, into *out.
extern "C" int fsn_rnn_fwd_max_clusters_bf16(int lstm, int H, int rows, int* out) {
    WalkArgs a = {};
    a.T = 1; a.N = rows; a.H = H;
    *out = 0;
    return (int)walk_dispatch(lstm != 0, false, a, rows, 0, nullptr, out, true);
}

extern "C" const char* fsn_rnn_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
