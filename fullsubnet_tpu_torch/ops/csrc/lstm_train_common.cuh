// Shared pieces of the LSTM training kernels (lstm_train_fwd.cu,
// lstm_layer_bwd.cu) and the GRU kernels (gru_forward.cu,
// gru_layer_bwd.cu): the storage-type traits, the gate nonlinearity and
// the launch shape.
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

// one thread per hidden unit, in whole warps, at most kMaxThreads
inline int block_threads(int hidden) {
    int threads = ((hidden + 31) / 32) * 32;
    return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace fsn
