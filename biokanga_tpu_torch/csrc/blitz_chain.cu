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
// Bounds on the H100: integer operations, some 14 for each (i, j < i) pair
// of valid blocks and 2 for each valid block's ends; and the dependent
// chain, since f[i] needs f[i-1]: a step is at least one cross-lane max
// and the register update around it, whose latency blitz_chain_step_probe
// measures on the card (chip_smoke.py gives the floor).
//
// The design.  A thread owns the blocks j = t, t + T, ... of its chain
// (T its chain's threads): it stages their rows (q0 + ln, t0 + ln, f,
// valid) once, scans them for each step i, and writes f[i] and pred[i]
// itself when it owns i, so no thread reads another's row and f needs no
// fence.  A step's best is the max of the 32-bit candidates
// (__reduce_max_sync), then the least j among the lanes that hold it
// (__reduce_min_sync): the (cand, lowest j) order without 64-bit keys.
// Each thread prefetches the next step's q0, t0, score and valid, and
// scans its rows four at a time.  The walk stops at the chain's last
// valid block; invalid steps cost no reduction.
//
// - A warp a chain, 8 chains a block, no barrier at all: up to 128
//   blocks a lane's rows live in registers (1, 2 or 4 of them), past that
//   in shared memory, up to kNarrowMaxM blocks (8 chains' rows a block).
// - A block of 256 threads a chain, one barrier a step: lane 0 of each
//   warp writes its (max, j) into one of two buffers, in turns, and every
//   thread reduces the 8 pairs itself.  Rows in shared memory up to
//   kSharedMaxM blocks, past that in a (C, M) int4 scratch in device
//   memory (a thread reads only the rows it wrote; they stay in L1/L2).
// - By width and count: a warp a chain up to 128 blocks, and up to
//   kNarrowMaxM where the chains fill more than a wave of 256-thread
//   blocks (8 an SM); a block a chain otherwise (scripts/
//   bench_tools_torch.py times both layouts by build-time variants of
//   this rule; PERF.md).
//
// Every (strand, entry) chain of a batch of queries goes in one launch,
// padded to one width M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegB = -1000000000;
constexpr int kMaxOverlap = 8;      // C_MAX_OVERLAP_FLOAT
constexpr int kGapMax = 100000;     // C_GAP_MAX_LEN
constexpr int kGapExtendLimit = 10; // C_GAP_EXTEND_LIMIT, cost 1 a 10 bp
constexpr int kNarrowChains = 8;    // chains (warps) a narrow block
constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kRegRows = 4;         // a lane's rows in registers, at most
constexpr int kNarrowMaxM = 1024;   // the widest whose 8 rows fit a block
static_assert(kNarrowChains * kNarrowMaxM * 16 <= 232448,
              "a narrow block's rows pass the H100's shared memory");
constexpr int kSharedMaxM = 14336;  // wide rows in shared memory (16 B a block)

__device__ __forceinline__ int wrap_sub(int x, int y) {
    return (int)((unsigned)x - (unsigned)y);
}

__device__ __forceinline__ int wrap_add(int x, int y) {
    return (int)((unsigned)x + (unsigned)y);
}

// one chain's inputs at row `base`
struct Chain {
    const int* __restrict__ q0;
    const int* __restrict__ t0;
    const int* __restrict__ ln;
    const int* __restrict__ score;
    const uint8_t* __restrict__ valid;
    int* f;
    int* pred;
};

// Block j's row (qe, te, f, ok), its pred cleared.
__device__ __forceinline__ int4 stage_row(const Chain& ch, long long base,
                                          int j) {
    const int l = ch.ln[base + j];
    ch.pred[base + j] = -1;
    return make_int4(wrap_add(ch.q0[base + j], l),
                     wrap_add(ch.t0[base + j], l), kNegB,
                     ch.valid[base + j] != 0);
}

// Stage this thread's rows; returns the last valid j it owns, or -1.
__device__ __forceinline__ int stage(const Chain& ch, long long base, int4* rows,
                                     int first, int stride, int M) {
    int last = -1;
    for (int j = first; j < M; j += stride) {
        const int4 r = stage_row(ch, base, j);
        rows[j] = r;
        if (r.w) last = j;
    }
    return last;
}

// Block j's candidate for step i into (best, best_j) where it passes and
// beats best (j ascends, so the least j keeps a tie).
__device__ __forceinline__ void consider(int4 r, int j, int qi, int ti,
                                         int gap_open, int& best,
                                         int& best_j) {
    const int dq = wrap_sub(qi, r.x), dt = wrap_sub(ti, r.y);
    // -8 < dq, dt <= 100,000 as one unsigned compare each
    const bool ok =
        r.w && (unsigned)dq + (kMaxOverlap - 1) <=
                   (unsigned)(kGapMax + kMaxOverlap - 1) &&
        (unsigned)dt + (kMaxOverlap - 1) <=
            (unsigned)(kGapMax + kMaxOverlap - 1);
    const int gap = max(max(dq, dt), 0);
    const int gcost = gap > 0 ? gap_open + (int)min((unsigned)gap / 10u,
                                                    (unsigned)kGapExtendLimit)
                              : 0;
    const int cand = wrap_sub(r.z, gcost);
    if (ok && cand > best) best = cand, best_j = j;
}

// The best candidate of this thread's blocks j < i: (value, its least j),
// (kNegB, M) where none passes.  Four rows a round, loaded together.
__device__ __forceinline__ void scan(const int4* rows, int first, int stride,
                                     int i, int qi, int ti, int gap_open,
                                     int& best, int& best_j) {
    for (int j = first; j < i; j += 4 * stride) {
        int4 r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {     // i - 1 bounds every load
            r[u] = rows[min(j + u * stride, i - 1)];
            if (j + u * stride >= i) r[u].w = 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            consider(r[u], j + u * stride, qi, ti, gap_open, best, best_j);
    }
}

// the warp's (max value, least j holding it)
__device__ __forceinline__ void warp_best(int& best, int& best_j) {
    const int m = __reduce_max_sync(kFull, best);
    best_j = (int)__reduce_min_sync(kFull, best == m ? (unsigned)best_j : kFull);
    best = m;
}

// Step i's inputs, loaded one step ahead (every step loads, i clamped to
// the last, so no branch ties the valid flag's test to its load).
struct Step {
    int q, t, s, v;
    __device__ __forceinline__ void load(const Chain& ch, long long base, int i,
                                         int n) {
        i = max(min(i, n - 1), 0);
        q = ch.q0[base + i], t = ch.t0[base + i];
        s = ch.score[base + i], v = ch.valid[base + i];
    }
};

// A warp a chain.  R > 0: a lane's rows j = lane + 32 u (u < R, M <=
// 32 R) in registers, so a step loads no row; R == 0: the chain's rows in
// shared memory.
template <int R>
__global__ void __launch_bounds__(32 * kNarrowChains)
    chain_warp_kernel(Chain ch, int C, int M, int gap_open) {
    extern __shared__ int4 sm_rows[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + w;
    if (c >= C) return;                   // a whole warp
    const long long base = c * M;
    int4* rows = sm_rows + (long long)w * M;
    int4 reg[R > 0 ? R : 1];
    int last;
    if (R > 0) {
        last = -1;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int j = lane + 32 * u;
            reg[u] = j < M ? stage_row(ch, base, j) : make_int4(0, 0, kNegB, 0);
            if (reg[u].w) last = j;
        }
    } else {
        last = stage(ch, base, rows, lane, 32, M);
    }
    const int n = __reduce_max_sync(kFull, last) + 1;
    Step nx;
    nx.load(ch, base, 0, n);
    for (int i = 0; i < n; ++i) {
        const Step cur = nx;
        nx.load(ch, base, i + 1, n);
        if (!cur.v) continue;             // f[i] stays -10^9, pred[i] -1
        int best = kNegB, best_j = M;
        if (R > 0) {
#pragma unroll
            for (int u = 0; u < R; ++u) {
                int4 r = reg[u];
                if (lane + 32 * u >= i) r.w = 0;
                consider(r, lane + 32 * u, cur.q, cur.t, gap_open, best,
                         best_j);
            }
        } else {
            scan(rows, lane, 32, i, cur.q, cur.t, gap_open, best, best_j);
        }
        warp_best(best, best_j);
        if (lane == (i & 31)) {
            const bool take = best > 0;
            const int fi = take ? wrap_add(cur.s, best) : cur.s;
            if (R > 0) {
#pragma unroll
                for (int u = 0; u < R; ++u)
                    if (u == i >> 5) reg[u].z = fi;
            } else {
                rows[i].z = fi;
            }
            ch.pred[base + i] = take ? best_j : -1;
        }
    }
    if (R > 0) {
#pragma unroll
        for (int u = 0; u < R; ++u)
            if (lane + 32 * u < M) ch.f[base + lane + 32 * u] = reg[u].z;
    } else {
        for (int j = lane; j < M; j += 32) ch.f[base + j] = rows[j].z;
    }
}

template <bool kGlobalRows>
__global__ void __launch_bounds__(kWideThreads)
    chain_block_kernel(Chain ch, int4* __restrict__ scratch, int M,
                       int gap_open) {
    extern __shared__ int4 sm_rows[];
    __shared__ __align__(16) int2 s_key[2][kWideWarps];
    __shared__ int s_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base = (long long)blockIdx.x * M;
    int4* rows = kGlobalRows ? scratch + base : sm_rows;
    if (threadIdx.x == 0) s_last = -1;
    __syncthreads();
    atomicMax(&s_last, stage(ch, base, rows, threadIdx.x, kWideThreads, M));
    __syncthreads();
    const int n = s_last + 1;
    Step nx;
    nx.load(ch, base, 0, n);
    int buf = 0;
    for (int i = 0; i < n; ++i) {
        const Step cur = nx;
        nx.load(ch, base, i + 1, n);
        if (!cur.v) continue;             // uniform: no barrier
        int best = kNegB, best_j = M;
        scan(rows, threadIdx.x, kWideThreads, i, cur.q, cur.t, gap_open, best,
             best_j);
        warp_best(best, best_j);
        if (lane == 0) s_key[buf][warp] = make_int2(best, best_j);
        __syncthreads();
        // every thread reduces the warps' pairs (max, then least j)
        int m = kNegB, jm = M;
        const int4* keys = reinterpret_cast<const int4*>(s_key[buf]);
#pragma unroll
        for (int k = 0; k < kWideWarps / 2; ++k) {
            const int4 q = keys[k];       // two warps' (max, j)
            if (q.x > m || (q.x == m && q.y < jm)) m = q.x, jm = q.y;
            if (q.z > m || (q.z == m && q.w < jm)) m = q.z, jm = q.w;
        }
        buf ^= 1;
        if (threadIdx.x == (i & (kWideThreads - 1))) {
            const bool take = m > 0;
            rows[i].z = take ? wrap_add(cur.s, m) : cur.s;
            ch.pred[base + i] = take ? jm : -1;
        }
    }
    for (int j = threadIdx.x; j < M; j += kWideThreads)
        ch.f[base + j] = rows[j].z;
}

// The floor's step: `steps` steps of one warp, each what step i of the
// DP waits for once f[i-1] is known: its candidate (a subtract and a max
// with the lane's best of the older blocks), the 32-lane max (one
// REDUX) and f[i] (a max with 0 and an add).  Timed at two step counts,
// the difference is the latency of one step.
__global__ void chain_step_probe_kernel(int steps, int* __restrict__ out) {
    const int lane = threadIdx.x;
    const int g = 7 * lane + 3, p = -lane, s = lane & 5;
    int f = lane;
    for (int i = 0; i < steps; ++i)
        f = wrap_add(s, max(__reduce_max_sync(kFull, max(p, wrap_sub(f, g))),
                            0));
    out[lane] = f;
}

}  // namespace

// (C, M) int32 q0, t0, ln, score, f and pred, (C, M) uint8 valid; scratch:
// (C, M) int4, needed (non-NULL) where a wide chain's rows pass the shared
// memory (M > blitz_chain_shared_max_m()).
extern "C" int blitz_chain(const void* q0, const void* t0, const void* ln,
                           const void* score, const void* valid, void* f,
                           void* pred, void* scratch, int C, int M,
                           int gap_open, void* stream) {
    if (C <= 0 || M <= 0) return (int)cudaSuccess;
    const Chain ch{(const int*)q0, (const int*)t0, (const int*)ln,
                   (const int*)score, (const uint8_t*)valid, (int*)f,
                   (int*)pred};
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
    }
    // a warp a chain for rows in registers, and up to kNarrowMaxM where
    // the chains pass what one wave of blocks of 256 threads holds (8 an
    // SM); a block a chain otherwise
    const bool warp = M <= 32 * kRegRows || (M <= kNarrowMaxM && C >= 8 * sms);
    const size_t row_bytes = (size_t)M * sizeof(int4);
    const auto s = (cudaStream_t)stream;
    cudaError_t err;
    if (warp) {
        const unsigned blocks = (C + kNarrowChains - 1) / kNarrowChains;
        if (M <= 32) {
            chain_warp_kernel<1><<<blocks, 32 * kNarrowChains, 0, s>>>(
                ch, C, M, gap_open);
        } else if (M <= 64) {
            chain_warp_kernel<2><<<blocks, 32 * kNarrowChains, 0, s>>>(
                ch, C, M, gap_open);
        } else if (M <= 32 * kRegRows) {
            chain_warp_kernel<kRegRows><<<blocks, 32 * kNarrowChains, 0, s>>>(
                ch, C, M, gap_open);
        } else {
            const size_t smem = kNarrowChains * row_bytes;
            err = cudaFuncSetAttribute(
                chain_warp_kernel<0>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
            chain_warp_kernel<0><<<blocks, 32 * kNarrowChains, smem, s>>>(
                ch, C, M, gap_open);
        }
    } else if (M <= kSharedMaxM) {
        err = cudaFuncSetAttribute(chain_block_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)row_bytes);
        if (err != cudaSuccess) return (int)err;
        chain_block_kernel<false><<<C, kWideThreads, row_bytes, s>>>(
            ch, nullptr, M, gap_open);
    } else {
        if (scratch == nullptr) return (int)cudaErrorInvalidValue;
        chain_block_kernel<true><<<C, kWideThreads, 0, s>>>(
            ch, (int4*)scratch, M, gap_open);
    }
    return (int)cudaGetLastError();
}

// the widest chain whose rows the kernel keeps in shared memory
extern "C" int blitz_chain_shared_max_m() { return kSharedMaxM; }

// One warp of chain_step_probe_kernel: `steps` dependent steps; out: 32
// int32 (the lanes' last f, so nothing is left out).
extern "C" int blitz_chain_step_probe(int steps, void* out, void* stream) {
    chain_step_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps,
                                                                (int*)out);
    return (int)cudaGetLastError();
}
