// The weight-gradient stage of one LSTM or GRU layer's backward (K3 for the
// LSTM, K4 for the GRU) for Hopper (sm_90a), redesigned: a persistent,
// warp-specialised GEMM over the T*N rows of the layer's cotangent streams,
// fed by a ring of TMA loads, at bf16 storage on wgmma and at fp32 storage
// on the fp32 cores. It takes the main path's place of rnn_dw.cu (the
// split-K mma.sync kernel of the earlier design, which stays built, checked
// and timed beside it).
//
// Replaces the weight-gradient products that the TPU kernels
// fullsubnet_tpu/ops/subband_lstm.py:_lstm_layer_bwd_kernel and
// _gru_layer_bwd_kernel sum in their own body, in the fused-dW form
// _pallas_layer_bwd (the pl.pallas_call at :844) picks: per row tile,
// dwih += [x | 1]^T . dgates and dwhh += [h_prev | 1]^T . dgates (LSTM
// :609-626; GRU :710-727, with dxw and dhw), summed over the row tiles
// afterwards (:896-901).
//
// What it computes. C [M, Ncols] fp32 = sum over k < K of A[k]^T . B[k],
// A[k] = [a[k] | a_prev[k] | 1] (M = cols0 + cols1 + 1: the last row of C,
// row Mw = cols0 + cols1, is the bias gradient, B's column sums), B[k] a
// row of the cotangent stream; a_prev's row k is head[k] for k < shift,
// else prev[k - shift] (the h stash one block of N rows back, h0 first).
//   LSTM: one problem, [x | h_prev | 1]^T . dgates [K, 4H].
//   GRU: two, [x | 1]^T . dxw and [h_prev | 1]^T . dhw ([K, 3H] each).
//
// What bounds it on this card. Operations, at both types. At the flagship
// sub-band stage (K = 798,720, H = 384) the LSTM's two layers come to 2.90
// TFLOP and read 6.8 GB: 2.9 ms at the bf16 tensor-core peak (989 TFLOP/s)
// against 2.0 ms of HBM at 3.35 TB/s; at fp32 43.3 ms at the fp32 cores'
// 67 TFLOP/s. C is small (at most 1025 x 2048) and K long, so C's tiles
// alone give the card a fraction of a wave, and each k-row of A and B is
// read by several tiles: from L2, whose rate to the SMs is the limit the
// bf16 instance meets first (a 128 x 256 tile reads 48 KB a k-tile of 64
// rows).
//
// What the design does about it.
//   Tiles. A CTA sums a 128 x 256 tile of C: two slots of 64 rows, each
//   inside one segment of A (a or a_prev), by 256 columns of B. A segment
//   narrower than its last slot gets the tail from the loads' zero fill
//   (the sub-band x: 32 columns in a 64-row slot).
//   The bias row. B's column sums are taken on the fp32 cores beside the
//   products, in fp32 adds (as the earlier design took them): at bf16 by
//   two warps of the producer's warpgroup from the B tiles in shared
//   memory, at fp32 by each FFMA thread from its column of each k-tile.
//   Neither takes a slot, nor the tensor cores' truncating sums, whose
//   error grows with the run on a stream of one sign.
//   Schedule. A persistent grid, one CTA an SM, walks a list of work units
//   (C tile, range of k-tiles): units of K's slabs, slab-major, so the
//   units that run together read the same rows of A and B from L2, the
//   number of slabs picked (ops/subband_lstm.py, plan_dw) to even out the
//   CTAs' loads; the units of the first pair of slots also sum the bias
//   row. The shifted segment loads prev at row k - shift (TMA fills the
//   rows < 0 with zeros); head^T . B[0:shift] is a unit of its own per C
//   tile, after the slabs' units. The CTAs take the units round robin.
//   Each unit writes its partial to its place in a workspace, and a second
//   kernel sums each element's partials in the list's order:
//   no atomic sums, the same bits every call.
//   Clusters. At bf16, where C has an even number of slot pairs, two CTAs
//   of a cluster take two pairs of one column tile and k range, and each
//   loads half of B's boxes into both (TMA multicast): a third less read
//   from L2 a k-tile.
//   Ring. A producer of its own keeps the stages of A and B k-tiles in
//   flight (bf16 4 stages, fp32 6), with a full and an empty mbarrier a
//   stage. An operand whose base and row stride are 16-byte multiples is
//   loaded by TMA (64 x BK boxes, 128-byte swizzled at bf16); any other by
//   the producer's threads, element by element with 4-byte cp.async (pairs
//   at bf16) that complete on the same barrier, so the ring stays
//   asynchronous for every operand. (A bf16 operand with an
//   odd row stride is the one left: its elements are gathered with 2-byte
//   loads; no path of the port has one.) Every mbarrier wait traps after
//   2^22 polls: a ring out of step fails the launch instead of hanging.
//   bf16: two consumer warpgroups, one slot each, run wgmma m64n256k16 on
//   both operands from shared memory, MN-major through the transpose bits,
//   accumulators in registers (128 a thread), one k-tile's group in flight.
//   fp32: one CTA a unit and an SM: the producer's warpgroup (56
//   registers a thread; its 128 threads copy what TMA does not load, such
//   as the full-band x of 257 columns) and two warpgroups of FFMA (no
//   TF32; 224 registers), each thread an 8 x 16 block of the tile (128
//   accumulators: 6 16-byte shared loads a k-row for 128 FFMA), the
//   shared-memory fragments of the next k-row double-buffered in
//   registers, across k-tiles too. A warp leaves out a slot none of its 16
//   rows reaches (the sub-band x: 32 of a slot's 64 rows; the empty slot of
//   an odd last pair). It does not leave out columns past Ncols: on an
//   H100 that made the GRU's stage (1,152 columns, a last tile of 128)
//   slower.
//
// Layouts. a [*, lda], prev [*, ldp], head [shift, ldp], b [K, ldb], all of
// one type, rows of the given strides; work: [units, 128, 256] fp32
// partials, then [slabs, n_tiles * 256] fp32 bias sums; out [M, Ncols] fp32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC

#include <algorithm>
#include <cstring>

#include "mma_common.cuh"
#include "tma_common.cuh"

namespace {

using namespace fsn;

constexpr int kSlot = 64;               // rows of C a slot (a warpgroup at bf16)
constexpr int kTileM = 2 * kSlot;       // rows of a CTA's tile
constexpr int kBN = 256;                // columns of a unit's tile
constexpr int kPartial = kTileM * kBN;  // floats of a unit's partial
// a k-tile of BK rows: bf16 64, fp32 16; a box (64 columns of it) and the
// ring of each type: stages of two A slots and B's four 64-column boxes
constexpr int kBf16K = 64, kF32K = 16;
template <typename T, int BK>
constexpr int kBoxBytes = BK * kSlot * (int)sizeof(T);
constexpr int kBf16Box = kBoxBytes<bf16, kBf16K>;
constexpr int kBf16Stages = 4, kBf16StageBytes = 6 * kBf16Box;
constexpr int kF32Stages = 6, kF32StageBytes = 6 * kBoxBytes<float, kF32K>;
// the ring, its alignment and its two barriers a stage
constexpr size_t smem_bytes(int stages, int stage_bytes) {
    return (size_t)stages * stage_bytes + 1024 + 2 * stages * 8;
}

enum Src : int { kSrcA = 0, kSrcPrev = 1, kSrcHead = 2, kSrcEmpty = 3 };
enum Path : int { kTma = 0, kCpAsync = 1, kGather = 2 };

// one operand: rows [0, rows) of `cols` columns at a row stride of ld
// elements, and the path its loads take
struct Operand {
    const void* p;
    int ld, rows, cols, path;
};

// the plan of ops/subband_lstm.py:plan_dw, as it hands it over
struct Plan {
    int cols0, cols1, shift, ncols, K;
    int n0, n1, n_slots, pairs, n_tiles;
    int k_tiles, slabs;
    int cs, groups;  // CTAs a cluster, and groups of cs pairs (one B tile each)
    int head_group0, head_groups, head_tiles;
    int cunits, units;  // a cluster's units, and the CTAs' (cs each)
    int swap;           // the partials hold column c at c ^ 1 (the fp32 instance)
};

struct Operands {
    Operand a, prev, head, b;
};

// the tensor maps of the operands that take TMA (the others' are unused)
struct Maps {
    CUtensorMap a, prev, head, b;
};

struct Unit {
    int pair, nt, kt0, kt1, slab;  // slab -1: a head unit
};

// unit u = cluster unit cu = u / cs, taken by the CTA of rank r = u % cs:
// pair cs * group + r of the cluster unit's group and column tile
__device__ __forceinline__ Unit decode(const Plan& p, int u) {
    Unit w;
    const int cu = u / p.cs, r = u % p.cs;
    const int gtiles = p.groups * p.n_tiles;
    const int mains = p.slabs * gtiles;
    if (cu >= mains) {
        w.pair = (p.head_group0 + (cu - mains) / p.n_tiles) * p.cs + r;
        w.nt = (cu - mains) % p.n_tiles;
        w.kt0 = 0;
        w.kt1 = p.head_tiles;
        w.slab = -1;
    } else {
        const int t = cu % gtiles;
        w.slab = cu / gtiles;
        w.pair = (t / p.n_tiles) * p.cs + r;
        w.nt = t % p.n_tiles;
        w.kt0 = (int)((long long)w.slab * p.k_tiles / p.slabs);
        w.kt1 = (int)((long long)(w.slab + 1) * p.k_tiles / p.slabs);
    }
    return w;
}

// the slab units of the first pair also sum the bias row
__device__ __forceinline__ bool bias_unit(const Unit& w) { return w.slab >= 0 && w.pair == 0; }

// this CTA's place: its rank in its cluster, the cluster, and how many
struct Place {
    int rank, cluster, clusters;
};

// what a slot loads in a unit: its source and its first column there
struct Slot {
    int src, col0;
};

__device__ __forceinline__ Slot slot_of(const Plan& p, int slot, bool head) {
    Slot s{kSrcEmpty, 0};
    if (slot < p.n0) {
        s = {head ? kSrcEmpty : kSrcA, slot * kSlot};
    } else if (slot < p.n0 + p.n1) {
        s = {head ? kSrcHead : kSrcPrev, (slot - p.n0) * kSlot};
    }
    return s;
}

// byte offset of element (row r, column c) in a k-tile of a 64-column box:
// bf16 rows of 128 bytes with 16-byte chunks XOR-swizzled by the row (the
// TMA's and wgmma's 128-byte swizzle, the tile 1024-byte aligned); fp32
// rows of 256 bytes as they are
template <typename T>
__device__ __forceinline__ uint32_t box_off(int r, int c);

template <>
__device__ __forceinline__ uint32_t box_off<bf16>(int r, int c) {
    return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1));
}

template <>
__device__ __forceinline__ uint32_t box_off<float>(int r, int c) {
    return (uint32_t)(r * 256 + c * 4);
}

// one 64-column box of BK rows (rows row0.., columns col0..) of an operand
// by the producer's LANES threads without TMA: 4-byte cp.async (a bf16
// pair or an fp32 element), zero-filled out of bounds; at bf16 with an odd
// row stride, 2-byte loads and stores
template <typename T, int BK, int LANES>
__device__ __forceinline__ void copy_box(const Operand& op, uint32_t dst, int row0, int col0) {
    const int lane = threadIdx.x % LANES;
    const T* base = static_cast<const T*>(op.p);
    if (op.path == kGather) {
        for (int idx = lane; idx < BK * kSlot; idx += LANES) {
            const int r = idx / kSlot, c = idx % kSlot;
            const int gr = row0 + r, gc = col0 + c;
            unsigned short v = 0;
            if (gr >= 0 && gr < op.rows && gc < op.cols) {
                v = __ldg(reinterpret_cast<const unsigned short*>(base + (size_t)gr * op.ld + gc));
            }
            asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst + box_off<T>(r, c)), "h"(v)
                         : "memory");
        }
        return;
    }
    constexpr int E = 4 / (int)sizeof(T);  // elements a copy
    for (int idx = lane; idx < BK * kSlot / E; idx += LANES) {
        const int r = idx / (kSlot / E), c = (idx % (kSlot / E)) * E;
        const int gr = row0 + r, gc = col0 + c;
        int bytes = 0;
        const T* src = base;
        if (gr >= 0 && gr < op.rows && gc < op.cols) {
            bytes = min(E, op.cols - gc) * (int)sizeof(T);
            src = base + (size_t)gr * op.ld + gc;
        }
        cp_async_4(dst + box_off<T>(r, c), src, bytes);
    }
}

struct Ring {
    uint32_t full0, empty0;  // shared addresses of the barrier arrays
    unsigned char* tiles;    // stage 0, 1024-byte aligned
};

__device__ __forceinline__ Ring ring_of(unsigned char* smem, int stages, int stage_bytes) {
    Ring r;
    const uint32_t base = smem_addr(smem);
    const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
    r.tiles = smem + pad;
    r.full0 = base + pad + stages * stage_bytes;
    r.empty0 = r.full0 + stages * 8;
    return r;
}

// the ring's barriers: a stage is full when the producer's `lanes`
// arrivals, its first lane's expect_tx and its bytes are in (the cluster's
// multicast boxes among them), empty when `warps` (of every CTA of the
// cluster) have released it; the cluster's CTAs wait for each other's
// barriers
__device__ __forceinline__ void ring_init(const Ring& r, int stages, int lanes, int warps,
                                          int cs) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(r.full0 + 8 * s, lanes + 1);
            mbar_init(r.empty0 + 8 * s, warps);
        }
        fence_barrier_init();
    }
    __syncthreads();
    if (cs > 1) {
        cluster_arrive();
        cluster_wait();
    }
}

__device__ __forceinline__ const Operand& operand_of(const Operands& o, int src) {
    return src == kSrcA ? o.a : src == kSrcPrev ? o.prev : o.head;
}

__device__ __forceinline__ const CUtensorMap* map_of(const Maps& m, int src) {
    return src == kSrcA ? &m.a : src == kSrcPrev ? &m.prev : &m.head;
}

// the next k-tile the loading warp loads: cluster unit cu (of this CTA's
// cluster), k-tile kt, and what this CTA's unit's two slots load
struct Cursor {
    int cu, kt;
    Unit w;
    Slot s0, s1;
};

__device__ __forceinline__ void cursor_unit(Cursor& c, const Plan& p, const Place& at) {
    if (c.cu < p.cunits) {
        c.w = decode(p, c.cu * p.cs + at.rank);
        c.s0 = slot_of(p, 2 * c.w.pair, c.w.slab < 0);
        c.s1 = slot_of(p, 2 * c.w.pair + 1, c.w.slab < 0);
        c.kt = c.w.kt0;
    }
}

__device__ __forceinline__ Cursor cursor_start(const Plan& p, const Place& at) {
    Cursor c;
    c.cu = at.cluster;
    cursor_unit(c, p, at);
    return c;
}

__device__ __forceinline__ void cursor_next(Cursor& c, const Plan& p, const Place& at) {
    if (++c.kt == c.w.kt1) {
        c.cu += at.clusters;
        cursor_unit(c, p, at);
    }
}

// this warp is done with a stage: lane 0 arrives for the warp once every
// lane has passed its reads, on the stage's empty barrier in each of the
// cluster's cs CTAs (their loads multicast into this one's stage)
__device__ __forceinline__ void release(const Ring& ring, int stage, int cs) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
        mbar_arrive(ring.empty0 + 8 * stage);
        const int own = (int)blockIdx.x % cs;
        for (int r = 0; r < cs; ++r) {
            if (r != own) mbar_arrive_cluster(ring.empty0 + 8 * stage, r);
        }
    }
}

// the loads of the cursor's k-tile into ring stage `stage` (free) of
// `stage_bytes`, by the producer's LANES threads: lane 0 issues the TMA
// boxes and expects their bytes; every lane copies its share of the other
// operands' elements; each lane's arrival completes when its copies have
// landed. B's boxes b0 .. b0 + nb - 1 (of the tile's four) go to the
// stage's boxes 2..
template <typename T, int BK, int LANES>
__device__ void load_stage(const Plan& p, const Operands& o, const Maps& m, const Ring& ring,
                           const Cursor& c, int stage, int stage_bytes, const Place& at, int b0,
                           int nb) {
    constexpr int kBox = kBoxBytes<T, BK>;
    const int lane = threadIdx.x % LANES;
    const uint32_t full = ring.full0 + 8 * stage;
    const uint32_t st = smem_addr(ring.tiles + (size_t)stage * stage_bytes);
    const int k0 = c.kt * BK;
    const int n0 = c.w.nt * kBN + b0 * kSlot;
    bool gather = o.b.path == kGather;
    uint32_t tx = o.b.path == kTma ? nb * kBox : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const Slot& s = h ? c.s1 : c.s0;
        if (s.src != kSrcEmpty) {
            const int path = operand_of(o, s.src).path;
            tx += path == kTma ? kBox : 0;
            gather |= path == kGather;
        }
    }
    if (lane == 0) {
        mbar_arrive_expect_tx(full, tx);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const Slot& s = h ? c.s1 : c.s0;
            if (s.src != kSrcEmpty && operand_of(o, s.src).path == kTma) {
                tma_load_2d(st + h * kBox, map_of(m, s.src), full, s.col0,
                            s.src == kSrcPrev ? k0 - p.shift : k0);
            }
        }
        if (o.b.path == kTma && p.cs == 1) {
            for (int j = 0; j < nb; ++j) {
                tma_load_2d(st + (2 + j) * kBox, &m.b, full, n0 + j * kSlot, k0);
            }
        } else if (o.b.path == kTma) {
            // the cluster shares B: each CTA loads its share of the boxes
            // into every CTA's stage
            const uint16_t all = (uint16_t)((1u << p.cs) - 1);
            for (int j = at.rank; j < nb; j += p.cs) {
                tma_load_2d_multicast(st + (2 + j) * kBox, &m.b, full, n0 + j * kSlot, k0, all);
            }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const Slot& s = h ? c.s1 : c.s0;
        if (s.src != kSrcEmpty) {
            const Operand& op = operand_of(o, s.src);
            if (op.path != kTma) {
                copy_box<T, BK, LANES>(op, st + h * kBox,
                                       s.src == kSrcPrev ? k0 - p.shift : k0, s.col0);
            }
        }
    }
    if (o.b.path != kTma) {
        for (int j = 0; j < nb; ++j) {
            copy_box<T, BK, LANES>(o.b, st + (2 + j) * kBox, k0, n0 + j * kSlot);
        }
    }
    if (gather) __threadfence_block();
    cp_async_mbar_arrive(full);
}

// where a bias unit's column sums go: slab w.slab, columns of tile w.nt
__device__ __forceinline__ float* bias_sums(const Plan& p, float* work, const Unit& w) {
    return work + (size_t)p.units * kPartial + (size_t)w.slab * p.n_tiles * kBN + w.nt * kBN;
}

// ---------------------------------------------------------------------------
// bf16: two consumer warpgroups on wgmma
// ---------------------------------------------------------------------------

// the producer's warpgroup (warp 0 loads, warps 1 and 2 sum the bias row,
// warp 3 waits) and two consumer warpgroups
constexpr int kBf16Threads = 384;
constexpr int kBf16Warps = 10;  // the warps that release a stage: 8 consumers, 2 bias

// warps 1 and 2: B's column sums in the bias units, 4 columns a thread
// (64 threads over the tile's 256), rows in order, fp32 adds
__device__ __forceinline__ void bf16_bias_warps(const Plan& p, const Ring& ring, const Place& at,
                                                float* work) {
    const int bt = (int)threadIdx.x - 32;  // 0 .. 63
    const int box = bt / 16, c = (bt * 4) % kSlot;
    int stage = 0;
    uint32_t phase = 0;
    for (int cu = at.cluster; cu < p.cunits; cu += at.clusters) {
        const Unit w = decode(p, cu * p.cs + at.rank);
        const bool bias = bias_unit(w);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int kt = w.kt0; kt < w.kt1; ++kt) {
            mbar_wait(ring.full0 + 8 * stage, phase);
            if (bias) {
                const unsigned char* tb =
                    ring.tiles + (size_t)stage * kBf16StageBytes + (2 + box) * kBf16Box;
#pragma unroll 8
                for (int r = 0; r < kBf16K; ++r) {
                    const uint2 v = *reinterpret_cast<const uint2*>(tb + box_off<bf16>(r, c));
                    s0 += __uint_as_float(v.x << 16);
                    s1 += __uint_as_float(v.x & 0xffff0000u);
                    s2 += __uint_as_float(v.y << 16);
                    s3 += __uint_as_float(v.y & 0xffff0000u);
                }
            }
            release(ring, stage, p.cs);
            if (++stage == kBf16Stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        if (bias) {
            *reinterpret_cast<float4*>(bias_sums(p, work, w) + bt * 4) = make_float4(s0, s1, s2, s3);
        }
    }
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    dw_tma_bf16_kernel(const __grid_constant__ Plan p, const __grid_constant__ Operands o,
                       const __grid_constant__ Maps m, float* __restrict__ work) {
    constexpr int BK = kBf16K;
    extern __shared__ __align__(1024) unsigned char fsn_smem[];
    const Ring ring = ring_of(fsn_smem, kBf16Stages, kBf16StageBytes);
    ring_init(ring, kBf16Stages, 32, kBf16Warps * p.cs, p.cs);
    const Place at = {(int)blockIdx.x % p.cs, (int)blockIdx.x / p.cs, (int)gridDim.x / p.cs};
    const int wg = (int)threadIdx.x / 128;
    if (wg == 0) {
        setmaxnreg_dec<80>();
        const int warp = (int)threadIdx.x / 32;
        if (warp == 0) {
            int stage = 0;
            uint32_t phase = 0;
            for (Cursor c = cursor_start(p, at); c.cu < p.cunits; cursor_next(c, p, at)) {
                mbar_wait(ring.empty0 + 8 * stage, phase ^ 1);
                load_stage<bf16, BK, 32>(p, o, m, ring, c, stage, kBf16StageBytes, at, 0, 4);
                if (++stage == kBf16Stages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        } else if (warp < 3) {
            bf16_bias_warps(p, ring, at, work);
        }
        // no CTA of a cluster leaves while another may still arrive on its
        // barriers or load into its shared memory
        if (p.cs > 1) {
            cluster_arrive();
            cluster_wait();
        }
        return;
    }
    // 128 x 80 + 256 x 208 registers: within the 384 x 168 the launch holds
    setmaxnreg_inc<208>();
    const int cw = wg - 1;  // this consumer's slot of the pair
    const int t = (int)threadIdx.x % 128;
    // a non-TMA load is a generic-proxy write that wgmma reads through the
    // async proxy
    const bool fence_b = o.b.path != kTma;
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int cu = at.cluster; cu < p.cunits; cu += at.clusters) {
        const int u = cu * p.cs + at.rank;
        const Unit w = decode(p, u);
        const Slot s = slot_of(p, 2 * w.pair + cw, w.slab < 0);
        const bool active = s.src != kSrcEmpty;
        const bool fence = fence_b || (active && operand_of(o, s.src).path != kTma);
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
        int last = -1;
        for (int kt = w.kt0; kt < w.kt1; ++kt) {
            mbar_wait(ring.full0 + 8 * stage, phase);
            unsigned char* st = ring.tiles + (size_t)stage * kBf16StageBytes;
            if (fence) fence_proxy_async();
            if (active) {
#pragma unroll
                for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
                wgmma_fence();
                // A: one 64-column atom, 8-row groups 1024 bytes apart; B:
                // four 64-column boxes of BK rows, 8 KB apart
                const uint64_t da = sw128_desc(smem_addr(st + cw * kBf16Box), kBf16Box, 1024);
                const uint64_t db = sw128_desc(smem_addr(st + 2 * kBf16Box), kBf16Box, 1024);
#pragma unroll
                for (int ks = 0; ks < BK / 16; ++ks) {
                    // 16 rows of k further on: 2048 bytes, in 16-byte units
                    wgmma_m64n256k16_tt(acc, da + ks * 128, db + ks * 128);
                }
                wgmma_commit();
                wgmma_wait<1>();
#pragma unroll
                for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
            }
            // the previous k-tile's wgmma group has finished reading its stage
            if (last >= 0) release(ring, last, p.cs);
            last = stage;
            if (++stage == kBf16Stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        if (active) {
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 128; ++i) reg_fence(acc[i]);
        }
        release(ring, last, p.cs);
        // the m64nNk16 fragment: warp q holds rows 16q .. 16q + 15, lane l
        // rows l / 4 and l / 4 + 8, columns 8j + 2 (l % 4) and one more
        float* out = work + (size_t)u * kPartial;
        const int q = t / 32, l = t % 32;
        const int r0 = cw * kSlot + q * 16 + l / 4;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = j * 8 + (l % 4) * 2;
            __stcs(reinterpret_cast<float2*>(out + (size_t)r0 * kBN + c),
                   make_float2(acc[4 * j], acc[4 * j + 1]));
            __stcs(reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * kBN + c),
                   make_float2(acc[4 * j + 2], acc[4 * j + 3]));
        }
    }
    if (p.cs > 1) {
        cluster_arrive();
        cluster_wait();
    }
}

// ---------------------------------------------------------------------------
// fp32: a producer warp and eight FFMA warps, one CTA a unit and an SM
// ---------------------------------------------------------------------------

// the producer's warpgroup (its 128 threads load) and two FFMA warpgroups,
// which sum the unit's 128 x 256 tile, each thread an 8 x 16 block
constexpr int kF32Compute = 256;
constexpr int kF32Threads = 128 + kF32Compute;
constexpr int kF32Warps = kF32Compute / 32;  // the warps that release a stage
constexpr int kF32Box = kBoxBytes<float, kF32K> / 4;  // floats of a box

// one k-row's fragments of a thread: A rows {tm*4 .. +3} of both slots, B
// columns {tn*4 .. +3} of each of the tile's four 64-column boxes
struct Frag {
    float4 a[2], b[4];
};

// shared-memory loads at a shared address, in program order with the
// ring's barrier waits
__device__ __forceinline__ float4 lds128(uint32_t addr) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

// k-row kk of a stage: sa = the stage's A boxes at column tm * 4, sb = its
// B boxes at column tn * 4 (shared addresses); the slots of MASK
template <int MASK>
__device__ __forceinline__ void load_frag(Frag& f, uint32_t sa, uint32_t sb, int kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (MASK >> h & 1) f.a[h] = lds128(sa + h * kF32Box * 4 + kk * kSlot * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) f.b[j] = lds128(sb + j * kF32Box * 4 + kk * kSlot * 4);
}

// acc += a . b for one k-row, over the slots of MASK
template <int MASK>
__device__ __forceinline__ void ffma_row(float (&acc)[8][16], const Frag& f) {
    const float a[8] = {f.a[0].x, f.a[0].y, f.a[0].z, f.a[0].w,
                        f.a[1].x, f.a[1].y, f.a[1].z, f.a[1].w};
    float b[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        b[4 * j] = f.b[j].x;
        b[4 * j + 1] = f.b[j].y;
        b[4 * j + 2] = f.b[j].z;
        b[4 * j + 3] = f.b[j].w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (MASK >> (i / 4) & 1) {
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
}

// an FFMA warp's place in the ring and in its tile
struct F32Lane {
    uint32_t tiles;   // shared address of stage 0
    uint32_t ta, tb;  // offsets of the thread's A and B fragments in a stage
    uint32_t bias;    // offset of the thread's column of B in a stage
    int stage;
    uint32_t phase;
};

// one unit's k-tiles [kt0, kt1) by an FFMA warp whose live share of the
// tile is the slots of MASK (0: none; it waits and releases the stages all
// the same); in a bias unit each thread also sums its column of B, rows in
// order, in fp32 adds. The fragments of the next k-row load while this
// one's sums run, across k-tiles too.
template <int MASK>
__device__ __forceinline__ void f32_unit(float (&acc)[8][16], float& bsum, F32Lane& l,
                                         const Ring& ring, int kt0, int kt1, bool bias) {
    constexpr int BK = kF32K;
    constexpr bool live = MASK != 0;
    uint32_t st = l.tiles + l.stage * kF32StageBytes;
    Frag f[2];
    mbar_wait(ring.full0 + 8 * l.stage, l.phase);
    if (live) load_frag<MASK>(f[0], st + l.ta, st + l.tb, 0);
    for (int kt = kt0; kt < kt1; ++kt) {
        const int nstage = l.stage + 1 == kF32Stages ? 0 : l.stage + 1;
        const uint32_t nphase = l.stage + 1 == kF32Stages ? l.phase ^ 1 : l.phase;
        const uint32_t nst = l.tiles + nstage * kF32StageBytes;
        if (live) {
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                if (kk + 1 < BK) {
                    load_frag<MASK>(f[(kk + 1) & 1], st + l.ta, st + l.tb, kk + 1);
                } else if (kt + 1 < kt1) {
                    mbar_wait(ring.full0 + 8 * nstage, nphase);
                    load_frag<MASK>(f[(kk + 1) & 1], nst + l.ta, nst + l.tb, 0);
                }
                ffma_row<MASK>(acc, f[kk & 1]);
            }
        } else if (kt + 1 < kt1) {
            mbar_wait(ring.full0 + 8 * nstage, nphase);
        }
        if (bias) {
#pragma unroll
            for (int r = 0; r < BK; ++r) bsum += lds32(st + l.bias + r * kSlot * 4);
        }
        release(ring, l.stage, 1);
        l.stage = nstage;
        l.phase = nphase;
        st = nst;
    }
}

// rows of a slot's segment that this warp's rows (16 from `row0`) reach
__device__ __forceinline__ bool slot_live(const Plan& p, const Slot& s, int row0) {
    if (s.src == kSrcEmpty) return false;
    return s.col0 + row0 < (s.src == kSrcA ? p.cols0 : p.cols1);
}

__global__ void __launch_bounds__(kF32Threads, 1)
    dw_tma_f32_kernel(const __grid_constant__ Plan p, const __grid_constant__ Operands o,
                      const __grid_constant__ Maps m, float* __restrict__ work) {
    constexpr int BK = kF32K;
    extern __shared__ __align__(1024) unsigned char fsn_smem[];
    const Ring ring = ring_of(fsn_smem, kF32Stages, kF32StageBytes);
    ring_init(ring, kF32Stages, 128, kF32Warps, 1);
    const Place at = {0, (int)blockIdx.x, (int)gridDim.x};
    if (threadIdx.x < 128) {
        setmaxnreg_dec<56>();
        // the whole warpgroup copies what TMA does not load
        int stage = 0;
        uint32_t phase = 0;
        for (Cursor c = cursor_start(p, at); c.cu < p.cunits; cursor_next(c, p, at)) {
            mbar_wait(ring.empty0 + 8 * stage, phase ^ 1);
            load_stage<float, BK, 128>(p, o, m, ring, c, stage, kF32StageBytes, at, 0, 4);
            if (++stage == kF32Stages) {
                stage = 0;
                phase ^= 1;
            }
        }
        return;
    }
    // 128 x 56 + 256 x 224 registers: within the 384 x 168 the launch holds
    setmaxnreg_inc<224>();
    const int ct = (int)threadIdx.x - 128;
    // thread (tm, tn) of 16 x 16; a warp holds 4 tm by 8 tn, so that each
    // fragment load reads 4 or 8 distinct 16-byte chunks
    const int lane = ct & 31, warp = ct >> 5;
    const int tm = (warp >> 1) * 4 + lane / 8, tn = (warp & 1) * 8 + lane % 8;
    F32Lane l;
    l.tiles = smem_addr(ring.tiles);
    l.ta = tm * 16;
    l.tb = 2 * kF32Box * 4 + tn * 16;
    l.bias = ((2 + ct / kSlot) * kF32Box + ct % kSlot) * 4;
    l.stage = 0;
    l.phase = 0;
    float acc[8][16];
    for (int u = at.cluster; u < p.units; u += at.clusters) {
        const Unit w = decode(p, u);
        const bool bias = bias_unit(w);
        float bsum = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
        // this warp's live share: rows (warp / 2) * 16 .. + 15 of each slot,
        // columns (warp % 2) * 32 .. + 31 of each of the tile's boxes
        const bool head = w.slab < 0;
        const int row0 = (warp >> 1) * 16;
        const int mask = (slot_live(p, slot_of(p, 2 * w.pair, head), row0) ? 1 : 0) |
                         (slot_live(p, slot_of(p, 2 * w.pair + 1, head), row0) ? 2 : 0);
        // (a warp whose columns all lie past Ncols has none)
        switch (p.ncols - w.nt * kBN - (warp & 1) * 32 > 0 ? mask : 0) {
            case 1: f32_unit<1>(acc, bsum, l, ring, w.kt0, w.kt1, bias); break;
            case 2: f32_unit<2>(acc, bsum, l, ring, w.kt0, w.kt1, bias); break;
            case 3: f32_unit<3>(acc, bsum, l, ring, w.kt0, w.kt1, bias); break;
            default: f32_unit<0>(acc, bsum, l, ring, w.kt0, w.kt1, bias); break;
        }
        float* out = work + (size_t)u * kPartial;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = (i / 4) * kSlot + tm * 4 + i % 4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                // columns swapped in pairs (the ordered sum reads them so),
                // which frees the register allocation of the accumulators from
                // the B fragments' quads: the GRU's sub-band stage ran faster
                // so on an H100
                __stcs(reinterpret_cast<float4*>(out + (size_t)r * kBN + j * kSlot + tn * 4),
                       make_float4(acc[i][4 * j + 1], acc[i][4 * j], acc[i][4 * j + 3],
                                   acc[i][4 * j + 2]));
            }
        }
        if (bias) bias_sums(p, work, w)[ct] = bsum;
    }
}

// ---------------------------------------------------------------------------
// the ordered sum of the partials
// ---------------------------------------------------------------------------

constexpr int kReduceThreads = 256;

// out[r][n] = each slab's partial, then the head unit's (rows of the
// shifted segment), in the plan's order; the bias row each slab's column
// sums
__global__ void __launch_bounds__(kReduceThreads)
    dw_tma_reduce_kernel(const Plan p, const float* __restrict__ work, float* __restrict__ out) {
    const int mw = p.cols0 + p.cols1;
    const long long total = (long long)(mw + 1) * p.ncols;
    const int gtiles = p.groups * p.n_tiles;
    const float* bias = work + (size_t)p.units * kPartial;
    for (long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x; i < total;
         i += (long long)gridDim.x * kReduceThreads) {
        const int r = (int)(i / p.ncols);
        const int n = (int)(i % p.ncols);
        float s = 0.0f;
        if (r == mw) {
            for (int z = 0; z < p.slabs; ++z) s += __ldcs(bias + (size_t)z * p.n_tiles * kBN + n);
            out[i] = s;
            continue;
        }
        const int slot = r < p.cols0 ? r / kSlot : p.n0 + (r - p.cols0) / kSlot;
        const int lr = r < p.cols0 ? r % kSlot : (r - p.cols0) % kSlot;
        const int pair = slot / 2;
        const int g = pair / p.cs, rank = pair % p.cs;
        const int nt = n / kBN;
        const size_t at = (size_t)((slot % 2) * kSlot + lr) * kBN + ((n % kBN) ^ p.swap);
        const int t = g * p.n_tiles + nt;
        for (int z = 0; z < p.slabs; ++z) {
            s += __ldcs(work + ((size_t)(z * gtiles + t) * p.cs + rank) * kPartial + at);
        }
        if (r >= p.cols0 && p.head_groups > 0) {
            const int hu = p.slabs * gtiles + (g - p.head_group0) * p.n_tiles + nt;
            s += __ldcs(work + ((size_t)hu * p.cs + rank) * kPartial + at);
        }
        out[i] = s;
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime (the library
// links no libcuda)
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                          cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiled>(ptr);
        }
    }
    return fn;
}

// the tensor map of a TMA operand: boxes of 64 columns by bk rows, 128-byte
// swizzled at bf16; zeros out of bounds
bool make_map(CUtensorMap* map, const Operand& op, bool is_bf16, int bk) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    const int size = is_bf16 ? 2 : 4;
    const cuuint64_t dims[2] = {(cuuint64_t)op.cols, (cuuint64_t)op.rows};
    const cuuint64_t strides[1] = {(cuuint64_t)op.ld * size};
    const cuuint32_t box[2] = {(cuuint32_t)kSlot, (cuuint32_t)bk};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          2, const_cast<void*>(op.p), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS;
}

// the path an operand's loads can take: TMA where its base and row stride
// are 16-byte multiples, else 4-byte cp.async where every pair is 4-byte
// aligned, else (bf16 only) 2-byte gathers
int path_of(const void* p, int ld, int size) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (a % 16 == 0 && ((long long)ld * size) % 16 == 0) return kTma;
    if (a % 4 == 0 && ((long long)ld * size) % 4 == 0) return kCpAsync;
    return kGather;
}

bool valid(const Operand& op, int size) {
    return op.p != nullptr && op.rows >= 1 && op.cols >= 1 && op.ld >= op.cols &&
           op.path == path_of(op.p, op.ld, size);
}

}  // namespace

// C = [a | a_prev | 1]^T . b over K rows, as the header says, by the plan
// that ops/subband_lstm.py:plan_dw made: plan[] = (n0, n1, n_slots, pairs,
// n_tiles, k_tiles, slabs, cs, head_group0, head_groups, head_tiles,
// units), run by `ctas` CTAs in clusters of cs (B multicast across a
// cluster at cs = 2, bf16 with B on TMA only); paths[] the load path of a,
// prev, head and b (0 TMA, 1 cp.async, 2 gather), as the wrapper computed
// them and this checks. a (cols0 > 0) [>= K rows, lda]; prev (cols1 > 0)
// [prev_rows, ldp] read at row k - shift, head [shift, ldp]; b [K, ldb];
// work [units * 128 * 256 + slabs * n_tiles * 256] fp32; out [cols0 +
// cols1 + 1, ncols] fp32. Returns a cudaError_t.
extern "C" int fsn_dw_tma(int bf16_in, const void* a, int lda, int cols0, const void* prev,
                          const void* head, int ldp, int prev_rows, int cols1, int shift,
                          const void* b, int ldb, int ncols, int K, const int* plan, int ctas,
                          const int* paths, float* work, float* out, void* stream) {
    const int size = bf16_in ? 2 : 4;
    const int bk = bf16_in ? kBf16K : kF32K;
    if (K < 1 || ncols < 1 || cols0 < 0 || cols1 < 0 || cols0 + cols1 < 1 || shift < 0 ||
        plan == nullptr || paths == nullptr || work == nullptr || out == nullptr || ctas < 1) {
        return (int)cudaErrorInvalidValue;
    }
    Plan p;
    p.cols0 = cols0;
    p.cols1 = cols1;
    p.shift = cols1 > 0 ? shift : 0;
    p.ncols = ncols;
    p.K = K;
    p.n0 = plan[0];
    p.n1 = plan[1];
    p.n_slots = plan[2];
    p.pairs = plan[3];
    p.n_tiles = plan[4];
    p.k_tiles = plan[5];
    p.slabs = plan[6];
    p.cs = plan[7];
    p.head_group0 = plan[8];
    p.head_groups = plan[9];
    p.head_tiles = plan[10];
    p.units = plan[11];
    p.swap = bf16_in ? 0 : 1;
    // the plan's shape against the operands (the plan itself is not redone)
    if (p.cs != 1 && p.cs != 2) return (int)cudaErrorInvalidValue;
    p.groups = (p.pairs + p.cs - 1) / p.cs;
    p.cunits = p.units / p.cs;
    const long long cunits =
        (long long)(p.slabs * p.groups + p.head_groups) * (long long)p.n_tiles;
    if (p.n0 != (cols0 + kSlot - 1) / kSlot || p.n1 != (cols1 + kSlot - 1) / kSlot ||
        p.n_slots != p.n0 + p.n1 || p.pairs != (p.n_slots + 1) / 2 ||
        p.n_tiles != (ncols + kBN - 1) / kBN || p.k_tiles != (K + bk - 1) / bk ||
        p.slabs < 1 || p.slabs > p.k_tiles || p.head_groups < 0 ||
        (p.head_groups > 0 && (p.head_tiles < 1 || p.shift < 1)) || p.units % p.cs != 0 ||
        (long long)p.cunits != cunits || ctas > p.units || ctas % p.cs != 0 ||
        (p.cs > 1 && (!bf16_in || paths[3] != kTma))) {
        return (int)cudaErrorInvalidValue;
    }
    Operands o{};
    if (cols0 > 0) {
        o.a = {a, lda, K, cols0, paths[0]};
        if (!valid(o.a, size)) return (int)cudaErrorInvalidValue;
    }
    if (cols1 > 0) {
        o.prev = {prev, ldp, prev_rows, cols1, paths[1]};
        if (!valid(o.prev, size) || (p.shift > 0 && head == nullptr)) {
            return (int)cudaErrorInvalidValue;
        }
        if (p.shift > 0) {
            o.head = {head, ldp, p.shift, cols1, paths[2]};
            if (!valid(o.head, size)) return (int)cudaErrorInvalidValue;
        }
    }
    o.b = {b, ldb, K, ncols, paths[3]};
    if (!valid(o.b, size)) return (int)cudaErrorInvalidValue;
    if (!bf16_in && (o.a.path == kGather || o.prev.path == kGather || o.head.path == kGather ||
                     o.b.path == kGather)) {
        return (int)cudaErrorInvalidValue;  // fp32 elements are 4-byte aligned
    }
    Maps m;
    memset(&m, 0, sizeof(m));
    if ((cols0 > 0 && o.a.path == kTma && !make_map(&m.a, o.a, bf16_in, bk)) ||
        (cols1 > 0 && o.prev.path == kTma && !make_map(&m.prev, o.prev, bf16_in, bk)) ||
        (p.shift > 0 && o.head.path == kTma && !make_map(&m.head, o.head, bf16_in, bk)) ||
        (o.b.path == kTma && !make_map(&m.b, o.b, bf16_in, bk))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bf16_in) {
        const size_t smem = smem_bytes(kBf16Stages, kBf16StageBytes);
        err = cudaFuncSetAttribute(dw_tma_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        if (p.cs == 1) {
            dw_tma_bf16_kernel<<<ctas, kBf16Threads, smem, s>>>(p, o, m, work);
        } else {
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3((unsigned)ctas);
            cfg.blockDim = dim3(kBf16Threads);
            cfg.dynamicSmemBytes = smem;
            cfg.stream = s;
            cudaLaunchAttribute cluster[1];
            cluster[0].id = cudaLaunchAttributeClusterDimension;
            cluster[0].val.clusterDim.x = (unsigned)p.cs;
            cluster[0].val.clusterDim.y = 1;
            cluster[0].val.clusterDim.z = 1;
            cfg.attrs = cluster;
            cfg.numAttrs = 1;
            err = cudaLaunchKernelEx(&cfg, dw_tma_bf16_kernel, p, o, m, work);
            if (err != cudaSuccess) return (int)err;
        }
    } else {
        const size_t smem = smem_bytes(kF32Stages, kF32StageBytes);
        err = cudaFuncSetAttribute(dw_tma_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        dw_tma_f32_kernel<<<ctas, kF32Threads, smem, s>>>(p, o, m, work);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)(cols0 + cols1 + 1) * ncols;
    const long long blocks =
        std::min<long long>((total + kReduceThreads - 1) / kReduceThreads, 132LL * 8);
    dw_tma_reduce_kernel<<<(unsigned)blocks, kReduceThreads, 0, s>>>(p, work, out);
    return (int)cudaGetLastError();
}

extern "C" const char* fsn_dw_tma_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
