// Shared pieces of the LSTM training kernels (lstm_train_fwd.cu,
// lstm_layer_bwd.cu) and the GRU kernels (gru_forward.cu,
// gru_layer_bwd.cu): the storage-type traits, the gate nonlinearity and
// the launch shape; and the cell update of the tensor-core forward walks
// (rnn_train_fwd_tc.cu, rnn_fwd_tc.cu).
//
// Storage type S is float or __nv_bfloat16. Tensors in device memory
// (inputs, weights, state stashes, cotangent streams) are stored as S;
// every product accumulates in fp32, and the h/c and dh/dc carries, the
// gate math and the biases stay fp32. A value that the TPU kernel casts
// to the compute dtype before a product (h before W_hh, gate cotangents
// before W^T) is rounded to S here too, with Io<S>::round, and kept as float.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fsn {

constexpr int kMaxLayers = 3;
constexpr int kMaxThreads = 512;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

template <typename S>
struct Io;

template <>
struct Io<float> {
    static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
    static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
    // a bf16 value is the top half of the fp32 with the same bits
    static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
        const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
        return __uint_as_float(static_cast<unsigned>(u) << 16);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
        *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
    }
    static __device__ __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16(v));
    }
};

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

// The cell of one unit at one step, _lstm_step / _gru_step after the
// products: pre = the gates' input projections, hw = their h . W_hh^T parts
// (GRU: b_hh added). carry, the fp32 c (LSTM) or h (GRU), is updated;
// returns h in fp32 (the caller rounds it).
template <bool kLstm>
__device__ __forceinline__ float cell_update(const float* pre, const float* hw, float& carry) {
    if constexpr (kLstm) {
        const float ig = sigmoid_f(pre[0] + hw[0]);
        const float fg = sigmoid_f(pre[1] + hw[1]);
        const float gg = tanhf(pre[2] + hw[2]);
        const float og = sigmoid_f(pre[3] + hw[3]);
        carry = fg * carry + ig * gg;
        return og * tanhf(carry);
    } else {
        const float rg = sigmoid_f(pre[0] + hw[0]);
        const float zg = sigmoid_f(pre[1] + hw[1]);
        const float ng = tanhf(pre[2] + rg * hw[2]);
        carry = (1.0f - zg) * ng + zg * carry;
        return carry;
    }
}

// one thread per hidden unit, in whole warps, at most kMaxThreads
inline int block_threads(int hidden) {
    int threads = ((hidden + 31) / 32) * 32;
    return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace fsn
