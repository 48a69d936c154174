// The seed stage of align_core around the dedup sort (#1): the candidate
// rows of one strand before it (`seed_rows`), and the extension's (#3)
// inputs after it (`dedup_pack`).
//
// Replaces no TPU kernel: the JAX package runs this stage as XLA ops
// (biokanga_tpu/align/pipeline.py `_strand_candidates`, ops/lookup.py
// `pack_read_kmers` and `seed_range_lookup`, ops/extend_packed.py
// `pack_reads`).  On the card the same op chains in PyTorch
// (ops/seed_rows.py `seed_rows_plain`, `dedup_pack_plain`) materialised
// the whole (B, S, H) slot grid in device memory several times over: an
// int64 `start + j`, its clamp, the gathered positions, the diagonals,
// five masks and the select, for a grid of which a tenth of the slots
// or fewer hold a position; then eight passes over the sorted rows for
// the dedup, and the read widened to int64 for the packing.
//
// Bounds on the H100: device memory.  Per strand pass the work needs the
// (B, L) int8 reads, the LUT entries and keys its cores touch, the
// min(size, H) positions of each core, the (B, S*H) int32 row written
// once and read once after the sort (up to the first sentinel), and the
// (B, C) loci and flags and (B, W) read words written once.  Most of
// those reads are scattered 4-byte loads (a LUT entry, a key, a run of
// ~4 positions), each costing a 32-byte sector and its latency, so the
// kernels run at 2.5-6 x the bytes bound (PERF.md's kernel table).
//
// `seed_rows`: a block of 256 threads takes a run of whole rows (256 / S
// of them, at least one, fewer where their reads would pass 48 KB of
// shared memory beside three ints a core) and stages their reads there,
// 16 or 4 bytes a load (a read past ~45 KB stays in device memory).
// Then one thread a (row, core): it packs the core's bases (its reverse
// complement taken on the fly, pad codes at the tail as `rc_reads` keeps
// them), flags an N, reads the LUT bucket and, where core_len >
// lut_bases, runs the two lower-bound searches of ops/lookup.py
// `_lower_bound` in lock step (their loads interleaved; a search that
// has converged stops, as the plain version's frozen lanes do; a key's
// low word is read only where the high words tie, which a core of at
// most 16 bases never needs), and keeps the core's first position and
// its live slot count, min(size, H), 0 where it has an N or is skipped,
// in shared memory.  Then the block writes its rows' S*H slots, one
// contiguous run of device memory, a slot a thread in order, eight
// slots' loads issued before their stores: only a live slot reads its
// position, so the sentinel slots cost their store alone.  (A thread
// that also filled its own core's slots wrote them scattered: 1.7-2 x
// slower at H 48, 8% faster at H 16.)
//
// `dedup_pack`: a warp a sorted row.  Its lanes read 32 columns at a
// time; a column equal to its left neighbour (from the lane to the left,
// or the last column of the previous step) is a duplicate.  The first C
// columns are written as loci and valid flags; past C only a valid
// column is looked for.  A sorted row ends in its sentinels, so once a
// step has met one the rest of the row is sentinels: nothing more is
// read, the remaining loci are written as sentinels.  The lanes then
// count the row's overflowing cores by ballots and pack the strand's
// read into (W) code and N-plane words: a base a lane, the 16 lanes of a
// word ORing their bits together (__reduce_or_sync).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeedThreads = 256;
constexpr int kUnroll = 8;            // seed_rows: slots a thread loads at once
constexpr int kSeedSmem = 48 * 1024;  // seed_rows: a block's shared memory
constexpr int kDedupThreads = 256;    // 8 rows a block
constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Base i of a row of the strand: the read itself, or its reverse
// complement with the pad codes kept at the tail (`rc_reads`: base i is
// the complement of read[L - 1 - ((i + L - len) mod L)], a code >= 4
// kept as it is); an N (4) past the row's end.
__device__ __forceinline__ int strand_base(const int8_t* row, int L, int len,
                                           bool rc, int i) {
  if (i >= L) return 4;
  if (!rc) return row[i];
  int j = i + L - len;
  if (0 <= len && len <= L) {
    j = j >= L ? j - L : j;
  } else {
    j %= L;
    if (j < 0) j += L;
  }
  int x = row[L - 1 - j];
  return x >= 4 ? x : (int)(int8_t)(3 - x);
}

// A 32-bit query word as a `key32` key: its sign bit flipped, so that a
// signed compare is the unsigned compare of the words.
__device__ __forceinline__ int32_t key32(uint32_t q) {
  return (int32_t)(q ^ 0x80000000u);
}

// Copy n bytes from device memory to shared memory, 16 or 4 bytes a load
// where both ends allow it.
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src,
                                      int n) {
  const uintptr_t a = (uintptr_t)src;
  if ((a & 15) == 0 && (n & 15) == 0 && ((uintptr_t)dst & 15) == 0) {
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x) {
      ((int4*)dst)[i] = __ldg((const int4*)src + i);
    }
  } else if ((a & 3) == 0 && (n & 3) == 0 && ((uintptr_t)dst & 3) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      ((int*)dst)[i] = __ldg((const int*)src + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kSeedThreads, 8) seed_rows_kernel(
    const int8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ offs, int B, int L, int S, int core_len,
    int H, bool rc, bool occ_skip, long long owned,
    const int32_t* __restrict__ key_hi, const int32_t* __restrict__ key_lo,
    long long n_keys, const int32_t* __restrict__ lut, int lut_bases,
    int steps, const int32_t* __restrict__ pos, long long n_pos,
    int32_t* __restrict__ flat, bool* __restrict__ overflow,
    int rows_per_block, bool staged) {
  extern __shared__ int smem[];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - row0);
  const int pairs = rows * S;
  int* s_start = smem;
  int* s_live = smem + pairs;
  int* s_off = smem + 2 * pairs;
  int8_t* s_reads = (int8_t*)(smem + 3 * pairs);
  const int shift = 32 - 2 * lut_bases;
  const long long last = n_keys - 1;

  // the block's reads, one contiguous run, staged by coalesced loads
  const int8_t* block_reads = reads + (size_t)row0 * L;
  if (staged) {
    stage(s_reads, block_reads, rows * L);
    __syncthreads();
  }

  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = p / S, s = p - r * S;
    const int b = row0 + r;
    const int8_t* row = (staged ? s_reads : block_reads) + (size_t)r * L;
    const int len = lengths[b];
    const int off = offs[s];
    uint32_t hi = 0, lo = 0;
    bool has_n = false;
    for (int i = 0; i < core_len; ++i) {
      const int x = strand_base(row, L, len, rc, off + i);
      const bool n = x >= 4;
      has_n |= n;
      const uint32_t v = n ? 0u : (uint32_t)x;
      if (i < 16) hi |= v << (2 * (15 - i));
      else lo |= v << (2 * (31 - i));
    }
    // the query bounds of ops/lookup.py pack_read_kmers
    uint32_t qlh = hi, qll, qhh, qhl;
    if (core_len > 16) {
      qll = lo;
      qhh = hi;
      qhl = lo | (uint32_t)((1ull << (2 * (32 - core_len))) - 1);
    } else {
      qll = 0;
      qhh = hi | (uint32_t)((1ull << (2 * (16 - core_len))) - 1);
      qhl = 0xffffffffu;
    }
    const long long bl = shift >= 32 ? 0 : (long long)(qlh >> shift);
    const long long bh = shift >= 32 ? 0 : (long long)(qhh >> shift);
    long long start = __ldg(lut + bl);
    long long end = __ldg(lut + bh + 1);
    if (core_len > lut_bases) {
      // first i in the bucket with key[i] >= qlow (a) and > qhigh (b); a
      // key's low word is read only where its high word ties the query's
      const int32_t ah = key32(qlh), al = key32(qll);
      const int32_t bh32 = key32(qhh), bl32 = key32(qhl);
      long long lo_a = start, hi_a = end, lo_b = start, hi_b = end;
      for (int t = 0; t < steps; ++t) {
        const bool live_a = lo_a < hi_a, live_b = lo_b < hi_b;
        if (!live_a && !live_b) break;
        const long long mid_a = (lo_a + hi_a) >> 1;
        const long long mid_b = (lo_b + hi_b) >> 1;
        const long long ma = max(0LL, min(mid_a, last));
        const long long mb = max(0LL, min(mid_b, last));
        const int32_t kha = __ldg(key_hi + ma), khb = __ldg(key_hi + mb);
        const bool gt_a =
            kha > ah || (kha == ah && __ldg(key_lo + ma) >= al);
        const bool gt_b =
            khb > bh32 || (khb == bh32 && __ldg(key_lo + mb) > bl32);
        if (live_a) {
          if (gt_a) hi_a = mid_a;
          else lo_a = mid_a + 1;
        }
        if (live_b) {
          if (gt_b) hi_b = mid_b;
          else lo_b = mid_b + 1;
        }
      }
      start = lo_a;
      end = lo_b;
    }
    long long size = end - start;
    // a core with an N gives a junk range and never counts as over H
    const bool over = size > H && !has_n;
    if (occ_skip && over) size = 0;
    long long live = has_n ? 0 : min(size, (long long)H);
    overflow[(size_t)b * S + s] = over;
    s_start[p] = (int)start;
    s_live[p] = live > 0 ? (int)live : 0;
    s_off[p] = off;
  }
  __syncthreads();

  // a thread's slots t, t + 256, ...: slot t is (core p, j) = (t / H,
  // t mod H), stepped without a division, and kUnroll slots' positions
  // loaded before any is stored; -1 marks a slot with none
  const int n = pairs * H;
  int32_t* out = flat + (size_t)row0 * S * H;
  const int dp = kSeedThreads / H, dj = kSeedThreads - dp * H;
  int t = threadIdx.x, p = t / H, j = t - p * H;
  while (t < n) {
    int32_t d[kUnroll];
    int tt = t;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = -1;
      if (tt < n && j < s_live[p]) {
        const long long slot = min((long long)s_start[p] + j, n_pos - 1);
        d[u] = (int32_t)((uint32_t)__ldg(pos + slot) - (uint32_t)s_off[p]);
      }
      tt += kSeedThreads;
      p += dp;
      j += dj;
      if (j >= H) {
        j -= H;
        ++p;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u, t += kSeedThreads) {
      if (t < n) {
        out[t] = d[u] >= 0 && (long long)d[u] < owned ? d[u] : kI32Max;
      }
    }
  }
}

__global__ void __launch_bounds__(kDedupThreads) dedup_pack_kernel(
    const int32_t* __restrict__ srt, const bool* __restrict__ overflow,
    const int8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int B, int SH, int S, int C, int L, int W, bool rc, bool occ_skip,
    int32_t* __restrict__ loci, bool* __restrict__ valid,
    int32_t* __restrict__ n_over, bool* __restrict__ trunc,
    int32_t* __restrict__ rcodes, int32_t* __restrict__ rnlane) {
  const int b = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const int32_t* row = srt + (size_t)b * SH;
  int32_t* lrow = loci + (size_t)b * C;
  bool* vrow = valid + (size_t)b * C;

  int32_t prev = 0;          // the column left of this step's first
  bool ended = false;        // a sentinel met: the rest are sentinels
  bool past = false;         // a valid column past C
  for (int c0 = 0; c0 < SH; c0 += 32) {
    if (ended && c0 >= C) break;
    const int c = c0 + lane;
    const int32_t x = (!ended && c < SH) ? row[c] : kI32Max;
    int32_t left = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) left = prev;
    const bool v = x != kI32Max && !(c > 0 && x == left);
    if (c < C) {
      lrow[c] = x;
      vrow[c] = v;
    } else {
      past |= v;
    }
    prev = __shfl_sync(kFull, x, 31);
    ended = __any_sync(kFull, x == kI32Max);
  }
  past = __any_sync(kFull, past);

  int over = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const bool o = s0 + lane < S && overflow[(size_t)b * S + s0 + lane];
    over += __popc(__ballot_sync(kFull, o));
  }
  if (lane == 0) {
    n_over[b] = occ_skip ? over : 0;
    trunc[b] = past || (!occ_skip && over > 0);
  }

  // a base a lane, each half-warp one word, its lanes' bits ORed
  const int8_t* rrow = reads + (size_t)b * L;
  const int len = lengths[b];
  const unsigned half = lane < 16 ? 0x0000ffffu : 0xffff0000u;
  for (int i0 = 0; i0 < 16 * W; i0 += 32) {
    const int i = i0 + lane;
    const int x = strand_base(rrow, L, len, rc, i);
    const bool nb = x >= 4;
    const int sh = 2 * (15 - (i & 15));
    const uint32_t code = __reduce_or_sync(
        half, (nb ? 0u : (uint32_t)x) << sh);
    const uint32_t nl = __reduce_or_sync(half, (nb ? 3u : 0u) << sh);
    if ((lane & 15) == 0 && (i >> 4) < W) {
      rcodes[(size_t)b * W + (i >> 4)] = (int32_t)code;
      rnlane[(size_t)b * W + (i >> 4)] = (int32_t)nl;
    }
  }
}

}  // namespace

// Rows a seed_rows block takes, whether it stages their reads, and its
// shared memory in bytes: three ints a (row, core), and the rows' reads
// where they fit in 48 KB beside them (a row of S <= 4,096 cores always
// does without its read: the wrapper holds S to it).
static int seed_rows_per_block(int S, int L) {
  const int rows = S >= kSeedThreads ? 1 : kSeedThreads / S;
  return max(1, min(rows, kSeedSmem / (3 * (int)sizeof(int) * S + L)));
}

static bool seed_rows_staged(int S, int L) {
  return 3 * (int)sizeof(int) * S + L <= kSeedSmem;
}

static int seed_rows_smem_bytes(int S, int L) {
  return seed_rows_per_block(S, L) *
         (3 * (int)sizeof(int) * S + (seed_rows_staged(S, L) ? L : 0));
}

extern "C" int seed_rows(const void* reads, const void* lengths,
                         const void* offs, int B, int L, int S, int core_len,
                         int H, int rc, int occ_skip, long long owned,
                         const void* key_hi, const void* key_lo,
                         long long n_keys, const void* lut, int lut_bases,
                         int steps, const void* pos, long long n_pos,
                         void* flat, void* overflow, void* stream) {
  const int rows = seed_rows_per_block(S, L);
  const int blocks = (B + rows - 1) / rows;
  seed_rows_kernel<<<blocks, kSeedThreads, seed_rows_smem_bytes(S, L),
                     (cudaStream_t)stream>>>(
      (const int8_t*)reads, (const int32_t*)lengths, (const int32_t*)offs,
      B, L, S, core_len, H, rc != 0, occ_skip != 0, owned,
      (const int32_t*)key_hi, (const int32_t*)key_lo, n_keys,
      (const int32_t*)lut, lut_bases, steps, (const int32_t*)pos, n_pos,
      (int32_t*)flat, (bool*)overflow, rows, seed_rows_staged(S, L));
  return (int)cudaGetLastError();
}

extern "C" int dedup_pack(const void* srt, const void* overflow,
                          const void* reads, const void* lengths, int B,
                          int SH, int S, int C, int L, int W, int rc,
                          int occ_skip, void* loci, void* valid,
                          void* n_over, void* trunc, void* rcodes,
                          void* rnlane, void* stream) {
  const int rows = kDedupThreads / 32;
  const int blocks = (B + rows - 1) / rows;
  dedup_pack_kernel<<<blocks, kDedupThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)srt, (const bool*)overflow, (const int8_t*)reads,
      (const int32_t*)lengths, B, SH, S, C, L, W, rc != 0, occ_skip != 0,
      (int32_t*)loci, (bool*)valid, (int32_t*)n_over, (bool*)trunc,
      (int32_t*)rcodes, (int32_t*)rnlane);
  return (int)cudaGetLastError();
}
