// Genome-wide minimum Hamming distance sweep: the `uhamming` kernel (#7).
//
// Replaces the XLA loops biokanga_tpu/tools/uhamming.py `_sweep_block`
// (:33) and `_cross_sweep` (:116).  For codes a and b of length n, each
// code's bit 7 set where the K-window starting there lies inside one
// entry ("valid"), and shifts d in [d_lo, d_hi):
//
//     hmin[i] = min(hmin[i], min over d of min(Ham(a[i, i+K), b[i+d, i+d+K)), 255))
//               over the pairs with valid a[i] and valid b[i+d], 0 <= i+d
//     and, with sym (b == a, the watson sweep), the backward partner
//               min(Ham(a[i-d, i-d+K), a[i, i+K)), 255), valid both, i-d >= 0,
//
// which is the JAX package's symmetric update at locus i+d read from the
// locus that receives it.  A code >= 4 (N) mismatches everything, another
// N too.  The caller clears bit 7 of b past n-K (the reverse-complement
// windows that would wrap), so a set bit also means i+d+K <= n.
//
// Bound on the H100: integer operations.  Each pair of windows costs the
// function a mismatch test (3 operations a 32 bases on 2-bit packed
// words), the window's slide (add the entering, drop the leaving base),
// the validity mask and the minima at both windows' loci; the
// reverse-complement distances are symmetric, Ham(a_i, rc a_k) =
// Ham(a_k, rc a_i), so the function needs each unordered pair once.  The
// bytes moved are n codes and n results.
//
// The design, a simple kernel that is right: a block owns a tile of 1,024
// loci and 4,096 shifts, 256 at a time, one a thread.  A thread counts the
// first window of its shift in K compares, then slides along the tile, one
// locus a step, forward (i against i+d) and, for the watson sweep,
// backward (i-d against i), so no locus outside the tile is written.  The
// 32 lanes of a warp hold 32 consecutive shifts at the same locus: one
// __reduce_min_sync gives their minimum, which lane 0 folds into the
// tile's row in shared memory.  At the end the block merges its row into
// an int32 row in device memory with atomicMin (there is no 8-bit one),
// skipping loci whose stored value is already as low; the wrapper casts
// that row to uint8.  A warp runs only the loci where one of its lanes
// has a pair, so shifts longer than the tile's reach cost nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;             // shifts in flight, one a thread
constexpr int kTile = 1024;               // loci a block
constexpr int kRounds = 16;               // rounds of kThreads shifts
constexpr long long kShiftsPerBlock = (long long)kThreads * kRounds;
constexpr int kInvalid = 255;
constexpr int kMaxGridY = 65535;

// 1 where the codes at s (in x) and t (in y) differ or either is an N;
// positions off [0, n) count 1, the same on entry and on leaving.
__device__ __forceinline__ int mism(const uint8_t* __restrict__ x,
                                    long long s,
                                    const uint8_t* __restrict__ y,
                                    long long t, long long n) {
    if (s < 0 || s >= n || t < 0 || t >= n) return 1;
    const unsigned u = x[s], v = y[t];
    return (((u ^ v) & 3u) | ((u | v) & 4u)) != 0u;
}

__device__ __forceinline__ long long warp_min(long long v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__global__ void __launch_bounds__(kThreads)
    uhamming_sweep_kernel(const uint8_t* __restrict__ a,
                          const uint8_t* __restrict__ b,
                          int* __restrict__ hmin, long long n, int K,
                          long long d_lo, long long d_hi, long long chunk0,
                          int sym) {
    __shared__ int s_min[kTile];
    const long long n_win = n - K + 1;    // loci with a whole window
    const long long i0 = (long long)blockIdx.x * kTile;
    const long long i_end = min(i0 + kTile, n_win);
    for (int t = threadIdx.x; t < kTile; t += kThreads) s_min[t] = kInvalid;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long dblk = d_lo + (chunk0 + blockIdx.y) * kShiftsPerBlock;
    for (int r = 0; r < kRounds; ++r) {
        const long long d = dblk + (long long)r * kThreads + threadIdx.x;
        const bool live = d < d_hi;
        // loci of this tile where the lane has a pair: forward needs
        // 0 <= i+d <= n-K, backward i-d >= 0
        long long lo = i_end, hi = i0;
        if (live) {
            const long long f_lo = max(i0, -d), f_hi = min(i_end, n_win - d);
            if (f_lo < f_hi) { lo = f_lo; hi = f_hi; }
            if (sym && max(i0, d) < i_end) {
                lo = min(lo, max(i0, d));
                hi = i_end;
            }
        }
        const long long wlo = warp_min(lo), whi = warp_max(hi);
        if (wlo >= whi) continue;         // warp-uniform
        int cf = 0, cb = 0;
        for (int t = 0; t < K; ++t) {
            cf += mism(a, wlo + t, b, wlo + t + d, n);
            if (sym) cb += mism(a, wlo + t - d, a, wlo + t, n);
        }
        for (long long i = wlo; i < whi; ++i) {
            int v = kInvalid;
            if (live && (a[i] & 0x80)) {
                const long long u = i + d;
                if (u >= 0 && u < n && (b[u] & 0x80)) v = min(cf, kInvalid);
                if (sym && i - d >= 0 && (a[i - d] & 0x80))
                    v = min(v, min(cb, kInvalid));
            }
            const unsigned m = __reduce_min_sync(kFull, (unsigned)v);
            if (lane == 0 && m < (unsigned)kInvalid)
                atomicMin(&s_min[i - i0], (int)m);
            cf += mism(a, i + K, b, i + K + d, n) - mism(a, i, b, i + d, n);
            if (sym)
                cb += mism(a, i + K - d, a, i + K, n) -
                      mism(a, i - d, a, i, n);
        }
    }
    __syncthreads();
    for (long long t = threadIdx.x; t < i_end - i0; t += kThreads) {
        const int v = s_min[t];
        if (v < kInvalid && v < hmin[i0 + t]) atomicMin(&hmin[i0 + t], v);
    }
}

}  // namespace

// a, b: (n,) uint8 codes | valid << 7; hmin: (n,) int32, updated in place.
// One grid of loci tiles x shift blocks, in slices of 65,535 shift blocks.
extern "C" int uhamming_sweep(const void* a, const void* b, void* hmin,
                              long long n, int K, long long d_lo,
                              long long d_hi, int sym, void* stream) {
    const long long n_win = n - K + 1;
    if (n_win <= 0 || d_hi <= d_lo) return (int)cudaSuccess;
    const long long tiles = (n_win + kTile - 1) / kTile;
    const long long chunks = (d_hi - d_lo + kShiftsPerBlock - 1) /
                             kShiftsPerBlock;
    for (long long c0 = 0; c0 < chunks; c0 += kMaxGridY) {
        const dim3 grid((unsigned)tiles,
                        (unsigned)std::min(chunks - c0, (long long)kMaxGridY));
        uhamming_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)a, (const uint8_t*)b, (int*)hmin, n, K, d_lo,
            d_hi, c0, sym);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
