// Shared pieces of the bf16 tensor-core kernels (rnn_bwd_tc.cu,
// rnn_train_fwd_tc.cu, rnn_fwd_tc.cu, rnn_dw.cu): the PTX wrappers (cp.async, ldmatrix, mma.sync
// m16n8k16 with bf16 operands and fp32 accumulators, L2 prefetch, cluster
// barriers), bf16 pair loads and stores, and the XOR swizzles of the
// shared-memory tiles the walks feed to ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fsn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; with `full` false nothing is
// read and the 16 bytes are zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool full) {
    const int bytes = full ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the oldest slot of a ring of `stages` cp.async groups (2 to 6) has landed
// for this thread
__device__ __forceinline__ void ring_wait(int stages) {
    switch (stages) {
        case 6: cp_async_wait<4>(); break;
        case 5: cp_async_wait<3>(); break;
        case 4: cp_async_wait<2>(); break;
        case 3: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// c += a . b for one 16 x 8 x 16 tile: a row-major, b column-major, bf16
// in, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// bytes from base into L2, one 128-byte line a thread at a time, spread over
// the `threads` threads of the block
__device__ __forceinline__ void prefetch_rows(const void* base, size_t bytes, int threads) {
    const char* p = static_cast<const char*>(base);
    for (size_t off = (size_t)threadIdx.x * 128; off < bytes; off += (size_t)threads * 128) {
        prefetch_l2(p + off);
    }
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// two bf16 at an even element offset, as floats
__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// two floats rounded to bf16 (to nearest even, as torch's .to()), the
// first at the lower address
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

// element offset of (row r, column col) in an A tile of gp columns (a
// multiple of 64): the 16-byte chunk index is XOR-swizzled by the row, so
// that the 8 rows one ldmatrix phase reads fall in 8 different bank groups
__device__ __forceinline__ int walk_a_off(int r, int col, int gp) {
    return r * gp + ((((col >> 3) ^ (r & 7))) << 3) + (col & 7);
}

// element offset of 16-byte chunk c8 of row k in a B tile of hp columns (a
// multiple of 64), swizzled likewise
__device__ __forceinline__ int walk_b_off(int k, int c8, int hp) {
    return k * hp + ((c8 ^ (k & 7)) << 3);
}

}  // namespace fsn
