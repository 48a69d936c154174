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
// row, so its time is the time of the gather.
//
// The TPU kernel sorts the indices, streams the whole table through
// on-chip memory in tiles and gathers inside a tile with a one-hot matrix
// product, because a gather from device memory cost that machine a full
// memory latency per row.  None of that is carried over: this card
// gathers in hardware, loads 16 bytes a thread and keeps 50 MB of the
// table in L2.
//
// Design: four neighbouring lanes take one row, each one 16-byte load
// (`__ldg` of a uint4), so a warp reads eight whole rows per step and
// every 64-byte row arrives as two full 32-byte sectors.  A byte of a word
// XORed with the same byte of the index is a byte of (word ^ index), so
// each word costs one XOR; its bytes are summed SWAR-wise, even and odd
// bytes in two registers of two 16-bit lanes each (four words add at most
// 4 x 255 to a lane, so nothing carries between lanes), and folded into a
// 32-bit sum per row.  A grid-stride loop walks the indices, unrolled so
// that several loads are in flight per thread; the sums meet in a warp
// shuffle, a block reduction in shared memory and one atomicAdd per
// block.  Addition mod 2^32 is exact in any order, so the result does not
// depend on the schedule.
//
// Bounds on the H100: n x (64 + 4) bytes against n x 16 words x ~6 int32
// operations: bound by bytes.  Random rows from a table past L2 pay one
// device-memory access of two sectors per row; sorted indices put
// neighbouring rows in neighbouring lanes, and repeated rows hit L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

// Sum of the four bytes of each of the four words of v ^ r.
__device__ inline uint32_t byte_sum(uint4 v, uint32_t r) {
    const uint32_t m = 0x00FF00FFu;
    const uint32_t a = v.x ^ r, b = v.y ^ r, c = v.z ^ r, d = v.w ^ r;
    const uint32_t even = (a & m) + (b & m) + (c & m) + (d & m);
    const uint32_t odd = ((a >> 8) & m) + ((b >> 8) & m) + ((c >> 8) & m) +
                         ((d >> 8) & m);
    const uint32_t s = even + odd;            // two lanes of at most 2,040
    return (s & 0xFFFFu) + (s >> 16);
}

__global__ void stream_gather_consume_kernel(
    const uint4* __restrict__ table, const int32_t* __restrict__ idx, int n,
    uint32_t* __restrict__ out) {
    __shared__ uint32_t s_warp[kThreads / 32];
    const int q = threadIdx.x & 3;            // which 16 bytes of the row
    const int64_t slot =
        ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
    const int64_t stride = ((int64_t)gridDim.x * blockDim.x) >> 2;
    uint32_t acc = 0;
#pragma unroll 4
    for (int64_t i = slot; i < n; i += stride) {
        const uint32_t r = (uint32_t)__ldg(idx + i);
        acc += byte_sum(__ldg(table + (int64_t)r * 4 + q), r);
    }
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xFFFFFFFFu, acc, d);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t total = 0;
        for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
        atomicAdd(out, total);
    }
}

}  // namespace

// table: (R, 16) uint32 words; idx: (n,) int32 in [0, R); out: one uint32,
// set to 0 here and summed into by every block.
extern "C" int stream_gather_consume(const void* table, const void* idx,
                                     int n, void* out, void* stream) {
    cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(uint32_t), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return (int)cudaGetLastError();
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int64_t want = ((int64_t)n * 4 + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)sms * kBlocksPerSM;
    const int blocks = (int)(want < cap ? want : cap);
    stream_gather_consume_kernel<<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const uint4*)table, (const int32_t*)idx, n, (uint32_t*)out);
    return (int)cudaGetLastError();
}
