// Checksum of gathered 64-byte rows: the gather probe's kernel.
//
// Replaces the TPU kernel biokanga_tpu/ops/stream_gather.py
// `_consume_kernel` (stream_gather_consume).  For a table of R rows of 16
// uint32 words and n row indices it returns
//
//     sum over i, k, w of ((table[idx[i]][w] >> 8k) & 0xFF)
//                         ^ ((idx[i] >> 8k) & 0xFF)        mod 2^32,
//
// a value that can only be had by reading every byte of every gathered
// row, so its time is the time of the gather.  Addition mod 2^32 is exact
// in any order, so the kernel takes the gathers in any order.
//
// The TPU kernel sorts the indices, streams the table through on-chip
// memory in tiles and gathers inside a tile, because a gather from device
// memory cost that machine a full memory latency per row.  This card
// gathers in hardware and keeps 50 MB of the table in L2; order matters
// where rows are wanted more than once from a table larger than L2:
// gathered in the order the indices come, a repeat of a row finds it
// evicted and reads it from device memory again (6.29 M random gathers
// from a 128 MB table move ~400 MB of row sectors for 122 MB of distinct
// rows).
//
// Bound on the H100: each distinct row, each index and the sum once,
// distinct x 64 + n x 4 + 4 bytes, or n x 16 words x 2 int32 operations
// (an XOR and a byte sum, IDP.4A against 0x01010101), whichever is
// longer.  A gather in index order from a table past L2 reads n x 4 bytes
// of indices and, of its n rows, the share L2 does not hold from device
// memory.
//
// The design: region sweeps.  The table is taken in regions of rows, one
// after another; for each region every warp streams all the indices
// (16-byte loads, evict-first, 256 a warp in flight), keeps those that
// fall in the region (a ballot; the hits packed in shared memory) and
// gathers them: four neighbouring lanes take one row, each one 16-byte
// load (`__ldg` of a uint4), so a warp reads eight whole rows a step and
// every row arrives as two full 32-byte sectors.  A byte of a word XORed
// with the same byte of the index is a byte of (word ^ index), so each
// word costs one XOR and one 4-byte dot product with 0x01010101
// (`__dp4a`), the two operations of the bound.  A warp shuffle, a block
// reduction in shared memory and one atomicAdd a block end it.
//
// ops/stream_gather.py `gather_plan` picks the region size from R, n and
// the card's L2 size (cudaDevAttrL2CacheSize).  Where rows are wanted
// about once or more each, regions are half the L2: while a region is
// swept its rows stay in L2, so each distinct row leaves device memory
// about once, at the price of one pass over the indices a region.  With
// little reuse (n < R, or a table of more than ten such regions) the
// whole table is one region: one pass, the indices in their order.
//
// What bounds the sweeps: every gathered row still crosses L2 to an SM
// (~0.068 ms for 6.29 M rows of a table that L2 holds whole), plus
// ~0.015 ms a region for the index pass.  Bucketing the indices by region
// first (a counting and a scatter pass), staging regions in shared memory
// (cp.async.bulk) and a gather in index order with scalar index loads
// were measured and ran slower (PERF.md, the designs of #4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kRuns = 8;                 // runs of 32 indices a warp holds

// Sum of the four bytes of each of the four words of v ^ r: a 4-byte dot
// product with 0x01010101 a word.
__device__ inline uint32_t byte_sum(uint4 v, uint32_t r) {
    const unsigned ones = 0x01010101u;
    uint32_t s = __dp4a(v.x ^ r, ones, 0u);
    s = __dp4a(v.y ^ r, ones, s);
    s = __dp4a(v.z ^ r, ones, s);
    return __dp4a(v.w ^ r, ones, s);
}

// acc of every thread summed into *out: warp shuffle, shared memory, one
// atomicAdd a block.
__device__ inline void block_sum_to(uint32_t acc, uint32_t* out) {
    __shared__ uint32_t s_warp[kThreads / 32];
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(kFull, acc, d);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t total = 0;
        for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
        atomicAdd(out, total);
    }
}

// Region by region of region_rows rows, each warp reads runs of 32 x kRuns
// indices (lane l the 16 bytes at 4 (32 j + l), j < kRuns / 4; idx is
// 16-byte aligned) and gathers those in the region.
__global__ void __launch_bounds__(kThreads)
    stream_gather_sweep_kernel(const uint4* __restrict__ table,
                               const int32_t* __restrict__ idx, int n,
                               int region_rows, int n_regions,
                               uint32_t* __restrict__ out) {
    __shared__ int32_t s_hit[kThreads / 32][32 * kRuns];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = lane & 3;
    const int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    uint32_t acc = 0;
    for (int reg = 0; reg < n_regions; ++reg) {
        const uint32_t lo = (uint32_t)reg * (uint32_t)region_rows;
        // the loop bound is warp-uniform: every lane reaches the ballots
        for (int64_t w = gw * 32 * kRuns; w < n; w += warps * 32 * kRuns) {
            uint32_t v[kRuns];
#pragma unroll
            for (int j = 0; j < kRuns / 4; ++j) {
                const int64_t i = w + 4 * (j * 32 + lane);
                if (i + 3 < n) {
                    const int4 q4 =
                        __ldcs(reinterpret_cast<const int4*>(idx + i));
                    v[4 * j] = (uint32_t)q4.x;
                    v[4 * j + 1] = (uint32_t)q4.y;
                    v[4 * j + 2] = (uint32_t)q4.z;
                    v[4 * j + 3] = (uint32_t)q4.w;
                } else {
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        v[4 * j + c] =
                            i + c < n ? (uint32_t)__ldcs(idx + i + c) : kFull;
                }
            }
            int hits = 0;
#pragma unroll
            for (int k = 0; k < kRuns; ++k) {
                const bool in = v[k] - lo < (uint32_t)region_rows;
                const unsigned mask = __ballot_sync(kFull, in);
                if (in)
                    s_hit[warp][hits + __popc(mask & ((1u << lane) - 1))] =
                        (int32_t)v[k];
                hits += __popc(mask);
            }
            __syncwarp();
            for (int j = lane >> 2; j < hits; j += 8) {
                const uint32_t r = (uint32_t)s_hit[warp][j];
                acc += byte_sum(__ldg(table + (int64_t)r * 4 + q), r);
            }
            __syncwarp();
        }
    }
    block_sum_to(acc, out);
}

}  // namespace

// *bytes = the L2 size of the current device.
extern "C" int stream_gather_l2_bytes(int* bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(bytes, cudaDevAttrL2CacheSize, dev);
    return (int)err;
}

// table: (R, 16) uint32 words, 16-byte aligned; idx: (n,) int32 in
// [0, R), 16-byte aligned; out: one uint32, set to 0 here and summed
// into.  The table is swept in regions of region_rows rows (>= 1).
extern "C" int stream_gather_consume(const void* table, const void* idx,
                                     int n, int R, int region_rows,
                                     void* out, void* stream) {
    const auto st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), st);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return (int)cudaGetLastError();
    if (region_rows <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    // a warp takes 32 x kRuns indices a step: no more blocks than n needs
    const int64_t per_block = (int64_t)(kThreads / 32) * 32 * kRuns;
    const int64_t want = ((int64_t)n + per_block - 1) / per_block;
    const int64_t cap = (int64_t)sms * kBlocksPerSM;
    const int n_regions =
        (int)(((int64_t)R + region_rows - 1) / region_rows);
    stream_gather_sweep_kernel<<<(int)(want < cap ? want : cap), kThreads, 0,
                                 st>>>((const uint4*)table,
                                       (const int32_t*)idx, n, region_rows,
                                       n_regions, (uint32_t*)out);
    return (int)cudaGetLastError();
}
