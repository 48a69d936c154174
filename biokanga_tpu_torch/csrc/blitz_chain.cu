// Collinear-chain DP of `blitz`: the chain kernel (#8).
//
// Replaces the XLA scan biokanga_tpu/tools/blitz.py `_chain_scan` (:158).
// For each chain c of M blocks (q0, t0, ln, score, valid), sorted by
// (t, q), and each i in order:
//
//     dq = q0[i] - (q0[j] + ln[j]),  dt = t0[i] - (t0[j] + ln[j])
//     ok_j = j < i, valid[j], valid[i], dq > -8, dt > -8,
//            dq <= 100,000, dt <= 100,000
//     gap = max(dq, dt, 0); gcost = gap > 0 ? gap_open + min(gap / 10, 10) : 0
//     cand_j = ok_j ? f[j] - gcost : -10^9
//     j* = argmax cand (the lowest j of equal values)
//     f[i] = valid[i] ? score[i] + (cand_j* > 0 ? cand_j* : 0) : -10^9
//     pred[i] = cand_j* > 0 ? j* : -1
//
// all in int32 arithmetic that wraps, as XLA's does.
//
// Bound on the H100: integer operations, some 14 for each (i, j < i) pair
// of valid blocks and 2 for each valid block's ends; the bytes are 5 M
// int32 in and 2 M out a chain.
//
// The design, a simple kernel that is right: one block a chain.  The
// blocks' ends (q0 + ln, t0 + ln), valid flags and f live in shared
// memory; the block walks i in order, its threads cover j < i, each keeps
// the best (cand, -j) it sees packed in one 64-bit key, a warp shuffle
// and a pass over the warps' keys in shared memory pick j*, and thread 0
// writes f[i] and pred[i].  The walk stops at the chain's last valid
// block.  Every (strand, entry) chain of a batch of queries goes in one
// launch, padded to one width M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kNegB = -1000000000;
constexpr int kMaxOverlap = 8;      // C_MAX_OVERLAP_FLOAT
constexpr int kGapMax = 100000;     // C_GAP_MAX_LEN
constexpr int kGapExtendLimit = 10; // C_GAP_EXTEND_LIMIT, cost 1 a 10 bp

__device__ __forceinline__ int wrap_sub(int x, int y) {
    return (int)((unsigned)x - (unsigned)y);
}

__device__ __forceinline__ int wrap_add(int x, int y) {
    return (int)((unsigned)x + (unsigned)y);
}

// (value, j) -> one key whose max is the max value, then the lowest j
__device__ __forceinline__ long long pack(int v, int j) {
    return (long long)v * 4294967296LL + (long long)(kFull - (unsigned)j);
}

__global__ void __launch_bounds__(kThreads)
    blitz_chain_kernel(const int* __restrict__ q0, const int* __restrict__ t0,
                       const int* __restrict__ ln,
                       const int* __restrict__ score,
                       const int* __restrict__ valid, int* __restrict__ f_out,
                       int* __restrict__ pred_out, int M, int gap_open) {
    extern __shared__ int sm[];
    int* qe = sm;
    int* te = sm + M;
    int* f = sm + 2 * M;
    int* ok = sm + 3 * M;
    __shared__ long long s_key[kThreads / 32];
    __shared__ int s_last;
    const long long base = (long long)blockIdx.x * M;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_last = -1;
    __syncthreads();
    int last = -1;
    for (int j = threadIdx.x; j < M; j += kThreads) {
        qe[j] = wrap_add(q0[base + j], ln[base + j]);
        te[j] = wrap_add(t0[base + j], ln[base + j]);
        f[j] = kNegB;
        ok[j] = valid[base + j] != 0;
        if (ok[j]) last = j;
        pred_out[base + j] = -1;
    }
    atomicMax(&s_last, last);
    __syncthreads();
    const int n = s_last + 1;
    for (int i = 0; i < n; ++i) {
        if (!ok[i]) continue;             // f[i] stays -10^9, pred[i] -1
        const int qi = q0[base + i], ti = t0[base + i];
        long long best = pack(kNegB, M);
        for (int j = threadIdx.x; j < i; j += kThreads) {
            if (!ok[j]) continue;
            const int dq = wrap_sub(qi, qe[j]), dt = wrap_sub(ti, te[j]);
            if (dq <= -kMaxOverlap || dt <= -kMaxOverlap || dq > kGapMax ||
                dt > kGapMax)
                continue;
            const int gap = max(max(dq, dt), 0);
            const int gcost =
                gap > 0 ? gap_open + min(gap / 10, kGapExtendLimit) : 0;
            best = max(best, pack(wrap_sub(f[j], gcost), j));
        }
        for (int o = 16; o > 0; o >>= 1)
            best = max(best, __shfl_xor_sync(kFull, best, o));
        if (lane == 0) s_key[warp] = best;
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < kThreads / 32; ++w) best = max(best, s_key[w]);
            const int cand = (int)(best >> 32);
            const int j = (int)(kFull - (unsigned)(best & 0xffffffffLL));
            const bool take = cand > 0;
            f[i] = take ? wrap_add(score[base + i], cand) : score[base + i];
            pred_out[base + i] = take ? j : -1;
        }
        __syncthreads();
    }
    for (int j = threadIdx.x; j < M; j += kThreads) f_out[base + j] = f[j];
}

}  // namespace

// (C, M) int32 inputs and outputs, one block a chain.
extern "C" int blitz_chain(const void* q0, const void* t0, const void* ln,
                           const void* score, const void* valid, void* f,
                           void* pred, int C, int M, int gap_open,
                           void* stream) {
    if (C <= 0 || M <= 0) return (int)cudaSuccess;
    const size_t smem = (size_t)4 * M * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        blitz_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    blitz_chain_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)q0, (const int*)t0, (const int*)ln, (const int*)score,
        (const int*)valid, (int*)f, (int*)pred, M, gap_open);
    return (int)cudaGetLastError();
}
