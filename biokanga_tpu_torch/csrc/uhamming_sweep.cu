// Genome-wide minimum Hamming distance sweep: the `uhamming` kernel (#7).
//
// Replaces the XLA loops biokanga_tpu/tools/uhamming.py `_sweep_block`
// (:33) and `_cross_sweep` (:116).  For codes a (the genome) and b (the
// genome itself, or its reverse complement), K-windows, "valid" windows
// (inside one entry) and shifts d in [d_lo, d_hi):
//
//   watson (b == a): each pair (i, i+d), 0 <= i, i+d+K <= n, valid at both
//     loci, lowers hmin at i and at i+d to min(Ham(a_i, a_{i+d}), 255);
//   cross (b = revcomp a): on the diagonal d the pair (i, j = i+d) is the
//     window a_i against rc(a_k), k = n-K-j, and Ham(a_i, rc a_k) =
//     Ham(a_k, rc a_i) is the same diagonal's pair (k, i).  So only the
//     pairs with i <= k (i <= (n-K-d)/2) are evaluated, the self-pair
//     i = k once, and each lowers hmin at i and at k.
//
// A code >= 4 (N) mismatches everything, another N too.  hmin is int32
// in device memory here; the wrapper casts it to uint8.
//
// Bound on the H100: integer operations, 5.1 a pair of windows (the
// mismatch test of 2-bit packed words, the window's slide, the pair's
// mask, both loci's minima) over each unordered pair once; the bytes, n
// codes and n results, are nothing beside them.
//
// The design.  The wrapper packs each genome once into four bit planes of
// 32-position words (the low code bit, the high code bit, N, valid; the
// first position in the top bit), padded at both ends with positions
// whose N bit is set, so a position off the genome mismatches without a
// test.  The mismatch word of 32 positions of a against b is
// (alo^blo)|(ahi^bhi)|an|bn, b aligned to a's word by a funnel shift of
// two neighbouring words per plane.
//
// A block owns a tile of 1,024 loci and 4,096 shifts; a warp takes 32
// consecutive shifts, one a lane, and slides along the tile's loci.  A
// lane keeps its window's mismatch count c and two 32-bit registers of
// mismatch bits, the ones that enter at i+K and the ones that leave at i;
// a locus step is c += enter.top - leave.top and two shifts, and the
// registers are refilled every 32 loci (14 loads and 7 funnel shifts a
// lane).  A warp's first window costs ceil(K/32) popcounts.
//
// Every pair lowers two loci.  Its own locus i is common to the warp's 32
// lanes: one __reduce_min_sync gives the warp's minimum, which lane 0
// folds into the tile's row in shared memory.  Its partner (i+d, or
// n-K-d-i) moves in lockstep: lane l's partner at step i+1 is lane l+1's
// at step i.  So each lane carries a partner minimum, shifted down one
// lane a step by __shfl_down_sync; lane 0's is complete and goes into
// the block's partner row (5,184 slots), and the 31 open carries are
// flushed when the warp's run ends.  Both rows take shared reductions
// (red.shared.min) that every lane runs, lane 0 at its row's slot and
// each other lane at a scratch slot of its own in another bank: no branch
// around them, no bank conflict.  No pair counts where its count is ORed
// with all ones (an invalid window, a locus out of the lane's range), so
// unsigned minima against rows that start at 255 also saturate the
// counts.  At the end the block merges both rows into hmin with
// device-memory atomicMin where they are lower.  Words where no lane has
// a pair only slide c; words where every lane's 32 pairs count skip the
// mask.  The partner row in shared memory beat one device-memory
// atomicMin a warp a locus by 1.17x at 1 Mbp (PERF.md).
//
// SASS (scripts/sass_sw_torch.py, nvcc 12.8 for sm_90a): a locus step
// is 11.94 instructions in the 32-step body where every lane's pairs
// count and 15.88 in the masked one; 64 registers, no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // no pair: above every count
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;               // loci a block
constexpr int kRounds = 16;               // groups of kThreads shifts
constexpr long long kShiftsPerBlock = (long long)kThreads * kRounds;
constexpr int kSpan = kTile + (int)kShiftsPerBlock + 64;  // partner row
constexpr int kCrossMargin = 32;          // partner row slots below a cross
                                          // warp's first partner
constexpr int kInvalid = 255;
constexpr int kMaxGridY = 65535;
// blocks an SM: caps the registers at 64 a thread, where the 32 unrolled
// steps would otherwise interleave into 128 and spill
constexpr int kMinBlocks = 4;

// the 32 plane bits from bit s of word `hi` on (top bit first)
__device__ __forceinline__ uint32_t bits_at(uint32_t hi, uint32_t lo,
                                            int s) {
    return __funnelshift_l(lo, hi, s);
}

// Mismatch words of a lane: a's plane word wa against b's 32 positions
// 32 * wa + d on (b's words wb = wa + (d >> 5) and wb + 1, shift d & 31).
// The valid stream also gives both windows' valid bits.
template <bool kValid>
struct Stream {
    const uint32_t* __restrict__ a;
    const uint32_t* __restrict__ b;
    long long W, wa, wb;
    int sb;
    uint32_t lo, hi, nn, vv;              // b's words at wb

    __device__ __forceinline__ void start(const uint32_t* a_, const uint32_t* b_,
                                          long long W_, long long wa0,
                                          long long d) {
        a = a_, b = b_, W = W_, wa = wa0, wb = wa0 + (d >> 5);
        sb = (int)(d & 31);
        lo = __ldg(b + wb), hi = __ldg(b + W + wb), nn = __ldg(b + 2 * W + wb);
        if (kValid) vv = __ldg(b + 3 * W + wb);
    }

    __device__ __forceinline__ uint32_t next(uint32_t* ok = nullptr) {
        const uint32_t lo1 = __ldg(b + wb + 1), hi1 = __ldg(b + W + wb + 1),
                       nn1 = __ldg(b + 2 * W + wb + 1);
        const uint32_t m = (__ldg(a + wa) ^ bits_at(lo, lo1, sb)) |
                           (__ldg(a + W + wa) ^ bits_at(hi, hi1, sb)) |
                           __ldg(a + 2 * W + wa) | bits_at(nn, nn1, sb);
        if (kValid) {
            const uint32_t vv1 = __ldg(b + 3 * W + wb + 1);
            *ok = __ldg(a + 3 * W + wa) & bits_at(vv, vv1, sb);
            vv = vv1;
        }
        lo = lo1, hi = hi1, nn = nn1;
        ++wa, ++wb;
        return m;
    }
};

// bits t in [x, y) of a word, top bit first (x, y clamped to [0, 32])
__device__ __forceinline__ uint32_t range_bits(long long x, long long y) {
    const int lo = (int)min(max(x, 0LL), 32LL);
    const int hi = (int)min(max(y, 0LL), 32LL);
    if (lo >= hi) return 0u;
    return (kFull >> lo) & ~(hi == 32 ? 0u : kFull >> hi);
}

__device__ __forceinline__ long long warp_min(long long v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

// The loci [lo, hi) of the tile where shift d has a pair.
template <bool kCross>
__device__ __forceinline__ void lane_range(long long d, long long d_hi,
                                           long long n, int K, long long i0,
                                           long long i_end, long long& lo,
                                           long long& hi) {
    lo = max(i0, -d);
    if (kCross) {
        const long long s = n - K - d;    // i + k on this diagonal
        hi = s >= 0 ? s / 2 + 1 : lo;
    } else {
        hi = n - K + 1 - d;
    }
    hi = min(hi, i_end);
    if (d >= d_hi || lo >= hi) lo = i_end, hi = i0;
}

// A lane's window count, its open partner minimum and the chunk's bit
// registers (top bit: this step).
struct Lane {
    unsigned c, carry;
    uint32_t enter, leave, inv;
};

// Locus step T of a chunk of 32.  own, part: each lane's shared address
// for the step's tile row and partner row slots at T = 0: lane 0's real
// slots (its own locus, its partner), every other lane a scratch slot of
// its own in another bank, so all lanes run the two reductions and no
// branch is needed.
template <bool kMasked, int T>
__device__ __forceinline__ void step(Lane& s, int lane, unsigned own,
                                     unsigned part) {
    unsigned v = s.c;
    if (kMasked) {
        v |= (unsigned)((int)s.inv >> 31);
        s.inv <<= 1;
    }
    const unsigned r = __reduce_min_sync(kFull, v);
    asm volatile("red.shared.min.u32 [%0+%2], %1;"
                 :: "r"(own), "r"(r), "n"(4 * T) : "memory");
    s.carry = min(s.carry, v);
    asm volatile("red.shared.min.u32 [%0+%2], %1;"
                 :: "r"(part), "r"(s.carry), "n"(4 * T) : "memory");
    s.carry = __shfl_down_sync(kFull, s.carry, 1);
    if (lane == 31) s.carry = kNone;
    s.c += (s.enter >> 31) - (s.leave >> 31);
    s.enter <<= 1;
    s.leave <<= 1;
}

// A lane's open partner minimum, complete: into the partner row at lane
// 0's partner slot `part` plus the lane.
__device__ __forceinline__ void flush(unsigned carry, int lane,
                                      unsigned* part) {
    if (carry != kNone) atomicMin(part + lane, carry);
}

template <bool kMasked, int... T>
__device__ __forceinline__ void steps(std::integer_sequence<int, T...>,
                                      Lane& s, int lane, unsigned own,
                                      unsigned part) {
    (step<kMasked, T>(s, lane, own, part), ...);
}

// a, b: (4, W) uint32 planes with `pad` positions before position 0;
// hmin: (n,) int32, lowered in place.
template <bool kCross>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    uhamming_sweep_kernel(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b, long long W,
                          long long pad, int* __restrict__ hmin, long long n,
                          int K, long long d_lo, long long d_hi,
                          long long chunk0) {
    // slot 32 m + b of every row lies in bank b (see step)
    __shared__ __align__(128) unsigned s_own[kTile];
    __shared__ __align__(128) unsigned s_part[kSpan];
    __shared__ __align__(128) unsigned s_scratch[64];
    const long long n_win = n - K + 1;    // loci with a whole window
    const long long i0 = (long long)blockIdx.x * kTile;
    const long long i_end = min(i0 + kTile, n_win);
    const long long dblk = d_lo + (chunk0 + blockIdx.y) * kShiftsPerBlock;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // partner row slot x holds locus pbase + x (watson), pbase - x (cross)
    const long long pbase = kCross ? n - K - dblk - i0 + kCrossMargin
                                   : i0 + dblk;
    const int off = kCross ? kCrossMargin : 0;

    bool work = false;
    for (int r = 0; r < kRounds; ++r) {
        long long lo, hi;
        lane_range<kCross>(dblk + (long long)r * kThreads + threadIdx.x, d_hi,
                           n, K, i0, i_end, lo, hi);
        work |= lo < hi;
    }
    if (!__syncthreads_or(work)) return;
    for (int t = threadIdx.x; t < kTile; t += kThreads) s_own[t] = kInvalid;
    for (int t = threadIdx.x; t < kSpan; t += kThreads) s_part[t] = kInvalid;
    __syncthreads();

    const int se = K & 31;
    for (int r = 0; r < kRounds; ++r) {
        const long long d0 = dblk + (long long)r * kThreads + warp * 32;
        const long long d = d0 + lane;
        long long lo, hi;
        lane_range<kCross>(d, d_hi, n, K, i0, i_end, lo, hi);
        const long long wlo = warp_min(lo), whi = warp_max(hi);
        if (wlo >= whi) continue;         // warp-uniform
        const long long i_start = i0 + ((wlo - i0) & ~31LL);
        const long long wl = (pad + i_start) >> 5;
        // a lane past d_hi reads as its warp's last live shift (no pair
        // counts there; its positions stay inside the planes' padding)
        const long long d_read = min(d, d_hi - 1);
        // the first window: K mismatch bits from i_start
        Stream<false> ent;
        ent.start(a, b, W, wl, d_read);
        Lane st;
        st.c = 0;
        for (int t = 0; t < (K >> 5); ++t) st.c += __popc(ent.next());
        uint32_t e_prev = ent.next();
        st.c += __popc(e_prev & ~(kFull >> se));
        st.carry = kNone;
        Stream<true> lev;
        lev.start(a, b, W, wl, d_read);
        int x = (int)(d0 - dblk + (i_start - i0)) + off;
        // this lane's slots at a chunk's first step: lane 0's rows, the
        // others' scratch (lane l's at step t in bank l + t, apart from
        // lane 0's bank t since the rows' chunks start at bank 0)
        const unsigned scratch = (unsigned)__cvta_generic_to_shared(
            s_scratch + lane);
        const unsigned own0 = lane ? scratch
                                   : (unsigned)__cvta_generic_to_shared(s_own);
        const unsigned part0 = lane ? scratch
                                    : (unsigned)__cvta_generic_to_shared(s_part);
        const unsigned slot_bytes = lane ? 0u : 4u;  // lane 0's rows move
        for (long long i = i_start; i < whi; i += 32, x += 32) {
            uint32_t ok;
            st.leave = lev.next(&ok);
            const uint32_t en = ent.next();
            st.enter = bits_at(e_prev, en, se);
            e_prev = en;
            st.inv = ~(ok & range_bits(lo - i, hi - i));
            if (__all_sync(kFull, st.inv == kFull)) {
                // no pair in these 32 loci: the open carries are complete
                flush(st.carry, lane, s_part + x);
                st.carry = kNone;
                st.c += __popc(st.enter) - __popc(st.leave);
                continue;
            }
            const unsigned own = own0 + slot_bytes * (unsigned)(i - i0);
            const unsigned part = part0 + slot_bytes * (unsigned)x;
            if (__any_sync(kFull, st.inv != 0u))
                steps<true>(std::make_integer_sequence<int, 32>{}, st, lane,
                            own, part);
            else
                steps<false>(std::make_integer_sequence<int, 32>{}, st, lane,
                             own, part);
        }
        // the 31 open carries (lane 31's is empty)
        flush(st.carry, lane, s_part + x);
    }
    __syncthreads();
    for (long long t = threadIdx.x; t < i_end - i0; t += kThreads) {
        const int v = (int)s_own[t];
        if (v < kInvalid && v < hmin[i0 + t]) atomicMin(&hmin[i0 + t], v);
    }
    for (int t = threadIdx.x; t < kSpan; t += kThreads) {
        const int v = (int)s_part[t];
        if (v >= kInvalid) continue;      // a count comes from a real pair,
        const long long u = kCross ? pbase - t : pbase + t;  // 0 <= u < n
        if (v < hmin[u]) atomicMin(&hmin[u], v);
    }
}

}  // namespace

// a, b: (4, words) uint32 planes of the genome and of the sequence it is
// swept against (itself, or its reverse complement with its own valid
// plane), `pad` positions before position 0; hmin: (n,) int32, lowered in
// place.  cross: 0 the watson sweep, 1 the pair-once cross sweep.  One
// grid of loci tiles x shift blocks, in slices of 65,535 shift blocks.
extern "C" int uhamming_sweep(const void* a, const void* b, long long words,
                              long long pad, void* hmin, long long n, int K,
                              long long d_lo, long long d_hi, int cross,
                              void* stream) {
    const long long n_win = n - K + 1;
    if (n_win <= 0 || d_hi <= d_lo) return (int)cudaSuccess;
    const long long tiles = (n_win + kTile - 1) / kTile;
    const long long chunks = (d_hi - d_lo + kShiftsPerBlock - 1) /
                             kShiftsPerBlock;
    for (long long c0 = 0; c0 < chunks; c0 += kMaxGridY) {
        const dim3 grid((unsigned)tiles,
                        (unsigned)std::min(chunks - c0, (long long)kMaxGridY));
        const auto* pa = (const uint32_t*)a;
        const auto* pb = (const uint32_t*)b;
        if (cross)
            uhamming_sweep_kernel<true><<<grid, kThreads, 0,
                                          (cudaStream_t)stream>>>(
                pa, pb, words, pad, (int*)hmin, n, K, d_lo, d_hi, c0);
        else
            uhamming_sweep_kernel<false><<<grid, kThreads, 0,
                                           (cudaStream_t)stream>>>(
                pa, pb, words, pad, (int*)hmin, n, K, d_lo, d_hi, c0);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
