// The resident chunked path's per-chunk select and its exact merge across
// chunks (parallel/chunked.py `ChunkedAligner`), so that a block's
// per-chunk results never leave the card before they are merged.
//
// Replaces no TPU kernel: the JAX package selects each chunk's fast and
// classic rows and merges the chunks on the host
// (biokanga_tpu/parallel/chunked.py `merge_chunk_results`).  The port's
// plain versions are ops/chunk_merge.py `select_chunk_plain` (torch
// selects) and `merge_chunks_plain` (the merge of the module doc of
// parallel/chunked.py, in torch ops).
//
// Both kernels take one thread a row.  The work is a few hundred bytes a
// row: a block of 131,072 rows and 13 chunks reads ~10 MB a select and
// ~80 MB in the merge, tens of microseconds of device memory, so the
// kernels are written for exactness and few launches, not for the bytes
// bound.
//
// `select_chunk`: one chunk's row of the staging set (13 fields in the
// order of ops/chunk_merge.py FIELDS) from its fast and classic passes.
// A row is resolved where best_mm + n_over <= min(len / F, RL / F) -
// MMDelta (F, RL: the fast pass's core length and read length;
// FastPassParams.resolved_bound) and the fast pass did not truncate its
// candidates; a resolved row takes the fast pass's result and zero ladder
// keys, any other row the classic pass's fields.  An unresolved row that
// `inexact_rows` would send up the rescue ladder (cap truncation, or a
// skipped core with best_mm + n_over + MMDelta > len / core_len of the
// classic pass) is counted; so are the unresolved rows, where there is a
// fast pass.  The counts are warp ballots added with one atomic a warp.
// The passes' result tensors are read where they lie, each with its row
// stride (the accept stage's `locus` is a column of the sorted loci).
//
// `merge_chunks`: the winner chunk by the least (best*2 + rc) << 42 |
// global locus, the first chunk on ties; inst the sum over the chunks
// whose best equals the winner's (the winner's own where best is
// MM_INVALID); next_mm the least of each chunk's next_mm where its best
// is the winner's and its best elsewhere, the winner's best where inst >=
// 2, re-saturated at best + MMDelta; any_hit against the budget
// clip(floor(len * subs / 100 + 0.5), 1, 63) in double precision, with
// the multiply and the add rounded apart as numpy rounds them (no fused
// multiply-add); the ladder keys reduced over the chunks.  The multi-hit
// list takes the Kml smallest of the K x Kml union entries by (comp,
// chunk-major position), comp = (mm*2 + rc) << 44 | clamp(locus, 0, 2^44
// - 1): the first Kml of a stable sort, found by Kml scans for the next
// entry in that order, which needs no order within a chunk's list.  A
// global locus outside [0, 2^42) sets an error flag that the wrapper
// raises on.  With one chunk the result is the chunk's own, its loci
// moved by the chunk's base.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 13;
constexpr int kMmInvalid = 255;
constexpr long long kLocusLimit = 1LL << 42;
constexpr long long kMlLocusMax = (1LL << 44) - 1;
constexpr unsigned kFull = 0xffffffffu;

// ops/chunk_merge.py FIELDS: RESULT_KEYS, then the ladder keys
enum {
  kUnique, kAnyHit, kBestMm, kNextMm, kInst, kLocus, kIsRc, kMlLoci, kMlMm,
  kMlRc, kOverflow, kNOver, kCapTrunc
};

// A result's fields where they lie: each a pointer and its row stride in
// elements (the columns of a multi-hit field contiguous).
struct Rows {
  const void* p[kFields];
  long long stride[kFields];
};

// A chunk's slot of the staging set, or the merged result: contiguous.
struct Out {
  void* p[kFields];
};

template <typename T>
__device__ __forceinline__ T ld(const Rows& r, int f, long long row,
                                int col = 0) {
  return static_cast<const T*>(r.p[f])[row * r.stride[f] + col];
}

template <typename T>
__device__ __forceinline__ void st(const Out& o, int f, long long at, T v) {
  static_cast<T*>(o.p[f])[at] = v;
}

__global__ void select_chunk_kernel(Rows fast, Rows classic, Out out,
                                    const int32_t* lengths, int B, int Kml,
                                    int fast_core, int fast_read_len,
                                    int core_len, int med, int32_t* flagged,
                                    int32_t* unresolved) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B;
  bool resolved = false, flag = false;
  if (live) {
    const int len = lengths[i];
    if (fast_core > 0) {
      const int bound = min(len / fast_core, fast_read_len / fast_core) - med;
      resolved = int(ld<uint8_t>(fast, kBestMm, i)) +
                         ld<int32_t>(fast, kNOver, i) <= bound &&
                 !ld<uint8_t>(fast, kCapTrunc, i);
    }
    const Rows& src = resolved ? fast : classic;
    st<uint8_t>(out, kUnique, i, ld<uint8_t>(src, kUnique, i));
    st<uint8_t>(out, kAnyHit, i, ld<uint8_t>(src, kAnyHit, i));
    st<uint8_t>(out, kBestMm, i, ld<uint8_t>(src, kBestMm, i));
    st<uint8_t>(out, kNextMm, i, ld<uint8_t>(src, kNextMm, i));
    st<uint8_t>(out, kIsRc, i, ld<uint8_t>(src, kIsRc, i));
    st<int32_t>(out, kInst, i, ld<int32_t>(src, kInst, i));
    st<int32_t>(out, kLocus, i, ld<int32_t>(src, kLocus, i));
    const long long at = (long long)i * Kml;
    for (int j = 0; j < Kml; ++j) {
      st<int32_t>(out, kMlLoci, at + j, ld<int32_t>(src, kMlLoci, i, j));
      st<uint8_t>(out, kMlMm, at + j, ld<uint8_t>(src, kMlMm, i, j));
      st<uint8_t>(out, kMlRc, at + j, ld<uint8_t>(src, kMlRc, i, j));
    }
    uint8_t ovf = 0, trunc = 0;
    int32_t n_over = 0;
    if (!resolved) {
      ovf = ld<uint8_t>(classic, kOverflow, i);
      n_over = ld<int32_t>(classic, kNOver, i);
      trunc = ld<uint8_t>(classic, kCapTrunc, i);
      const int best = ld<uint8_t>(classic, kBestMm, i);
      flag = trunc || (n_over != 0 && best + n_over + med > len / core_len);
    }
    st<uint8_t>(out, kOverflow, i, ovf);
    st<int32_t>(out, kNOver, i, n_over);
    st<uint8_t>(out, kCapTrunc, i, trunc);
  }
  const unsigned f = __ballot_sync(kFull, flag);
  const unsigned u = __ballot_sync(kFull, live && !resolved && fast_core > 0);
  if ((threadIdx.x & 31) == 0) {
    if (f) atomicAdd(flagged, __popc(f));
    if (u) atomicAdd(unresolved, __popc(u));
  }
}

// The staging set's field f of chunk k, row i (column j).
template <typename T>
__device__ __forceinline__ T sld(const Out& s, int f, int k, int B, int i,
                                 int Kml = 1, int j = 0) {
  return static_cast<const T*>(s.p[f])[((long long)k * B + i) * Kml + j];
}

__device__ __forceinline__ long long ml_global(const Out& s, int k, int B,
                                               int i, int Kml, int j,
                                               const long long* base) {
  const int32_t loc = sld<int32_t>(s, kMlLoci, k, B, i, Kml, j);
  return loc >= 0 ? loc + base[k] : -1LL;
}

__global__ void merge_chunks_kernel(Out s, Out o, const long long* base,
                                    const int32_t* lengths, int K, int B,
                                    int Kml, double rate, int budget, int med,
                                    int32_t* err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long at = (long long)i * Kml;
  if (K == 1) {
    const int bytes[] = {kUnique, kAnyHit, kBestMm, kNextMm, kIsRc,
                         kOverflow, kCapTrunc};
    for (int f : bytes) st<uint8_t>(o, f, i, sld<uint8_t>(s, f, 0, B, i));
    st<int32_t>(o, kInst, i, sld<int32_t>(s, kInst, 0, B, i));
    st<int32_t>(o, kNOver, i, sld<int32_t>(s, kNOver, 0, B, i));
    st<long long>(o, kLocus, i, sld<int32_t>(s, kLocus, 0, B, i) + base[0]);
    for (int j = 0; j < Kml; ++j) {
      st<long long>(o, kMlLoci, at + j, ml_global(s, 0, B, i, Kml, j, base));
      st<uint8_t>(o, kMlMm, at + j, sld<uint8_t>(s, kMlMm, 0, B, i, Kml, j));
      st<uint8_t>(o, kMlRc, at + j, sld<uint8_t>(s, kMlRc, 0, B, i, Kml, j));
    }
    return;
  }
  // the winner chunk, the first on ties
  int kstar = 0;
  long long kmin = 0, loc_star = 0;
  bool bad = false;
  for (int k = 0; k < K; ++k) {
    const long long g = sld<int32_t>(s, kLocus, k, B, i) + base[k];
    bad |= g < 0 || g >= kLocusLimit;
    const long long key =
        ((long long)(2 * sld<uint8_t>(s, kBestMm, k, B, i) +
                     sld<uint8_t>(s, kIsRc, k, B, i))
         << 42) |
        g;
    if (k == 0 || key < kmin) {
      kmin = key;
      kstar = k;
      loc_star = g;
    }
  }
  if (bad) *err = 1;
  const int b_star = sld<uint8_t>(s, kBestMm, kstar, B, i);
  long long inst_sum = 0;
  int next_star = 0x7fffffff, n_over = 0;
  bool ovf = false, trunc = false;
  for (int k = 0; k < K; ++k) {
    const int b = sld<uint8_t>(s, kBestMm, k, B, i);
    if (b == b_star) {
      inst_sum += sld<int32_t>(s, kInst, k, B, i);
      next_star = min(next_star, int(sld<uint8_t>(s, kNextMm, k, B, i)));
    } else {
      next_star = min(next_star, b);
    }
    ovf |= sld<uint8_t>(s, kOverflow, k, B, i) != 0;
    trunc |= sld<uint8_t>(s, kCapTrunc, k, B, i) != 0;
    const int32_t n = sld<int32_t>(s, kNOver, k, B, i);
    n_over = k == 0 ? n : max(n_over, n);
  }
  const long long inst_star =
      b_star >= kMmInvalid ? sld<int32_t>(s, kInst, kstar, B, i) : inst_sum;
  if (inst_star >= 2) next_star = b_star;
  next_star = min(next_star, b_star + med);
  int mtm = 0;
  if (budget) {
    const double x = floor(__dadd_rn(__dmul_rn((double)lengths[i], rate), 0.5));
    mtm = (int)fmin(fmax(x, 1.0), 63.0);
  }
  const bool any_hit = b_star <= mtm;
  st<uint8_t>(o, kUnique, i, any_hit && next_star - b_star >= med);
  st<uint8_t>(o, kAnyHit, i, any_hit);
  st<uint8_t>(o, kBestMm, i, (uint8_t)min(b_star, kMmInvalid));
  st<uint8_t>(o, kNextMm, i, (uint8_t)min(next_star, kMmInvalid));
  st<int32_t>(o, kInst, i, (int32_t)inst_star);
  st<long long>(o, kLocus, i, loc_star);
  st<uint8_t>(o, kIsRc, i, sld<uint8_t>(s, kIsRc, kstar, B, i));
  st<uint8_t>(o, kOverflow, i, ovf);
  st<int32_t>(o, kNOver, i, n_over);
  st<uint8_t>(o, kCapTrunc, i, trunc);
  // the multi-hit union's Kml smallest by (comp, position): each scan
  // takes the least entry past the last one taken
  long long last_c = -1;
  int last_p = -1;
  for (int t = 0; t < Kml; ++t) {
    long long best_c = 0;
    int best_p = -1;
    for (int k = 0; k < K; ++k) {
      for (int j = 0; j < Kml; ++j) {
        const int p = k * Kml + j;
        const long long g = ml_global(s, k, B, i, Kml, j, base);
        const long long c =
            ((long long)(2 * sld<uint8_t>(s, kMlMm, k, B, i, Kml, j) +
                         sld<uint8_t>(s, kMlRc, k, B, i, Kml, j))
             << 44) |
            min(max(g, 0LL), kMlLocusMax);
        if (c < last_c || (c == last_c && p <= last_p)) continue;
        // positions rise through the scan: a strictly smaller comp wins
        if (best_p < 0 || c < best_c) {
          best_c = c;
          best_p = p;
        }
      }
    }
    const int k = best_p / Kml, j = best_p % Kml;
    st<long long>(o, kMlLoci, at + t, ml_global(s, k, B, i, Kml, j, base));
    st<uint8_t>(o, kMlMm, at + t, sld<uint8_t>(s, kMlMm, k, B, i, Kml, j));
    st<uint8_t>(o, kMlRc, at + t, sld<uint8_t>(s, kMlRc, k, B, i, Kml, j));
    last_c = best_c;
    last_p = best_p;
  }
}

Rows rows_of(const void* const* p, const long long* stride) {
  Rows r;
  for (int f = 0; f < kFields; ++f) {
    r.p[f] = p[f];
    r.stride[f] = stride[f];
  }
  return r;
}

Out out_of(void* const* p) {
  Out o;
  for (int f = 0; f < kFields; ++f) o.p[f] = p[f];
  return o;
}

}  // namespace

// fast, classic: 13 pointers each (FIELDS order) with their row strides;
// fast_core 0 where the chunk has no fast pass (classic is then its only
// pass and every row takes it).  out: chunk k's slot of each staging
// field.  flagged, unresolved: the chunk's int32 counters.
extern "C" int select_chunk(const void* const* fast,
                            const long long* fast_stride,
                            const void* const* classic,
                            const long long* classic_stride,
                            void* const* out, const void* lengths, int B,
                            int Kml, int fast_core, int fast_read_len,
                            int core_len, int med, void* flagged,
                            void* unresolved, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  select_chunk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows_of(fast, fast_stride), rows_of(classic, classic_stride),
      out_of(out), (const int32_t*)lengths, B, Kml, fast_core, fast_read_len,
      core_len, med, (int32_t*)flagged, (int32_t*)unresolved);
  return (int)cudaGetLastError();
}

// stage: the 13 (K, B[, Kml]) staging fields; out: the 13 merged (B[,
// Kml]) fields (locus and ml_loci int64); base: (K,) int64 chunk bases;
// budget 0 where the mismatch budget is 0 (-s 0), else rate = subs / 100.
extern "C" int merge_chunks(void* const* stage, void* const* out,
                            const void* base, const void* lengths, int K,
                            int B, int Kml, double rate, int budget, int med,
                            void* err, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  merge_chunks_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out_of(stage), out_of(out), (const long long*)base,
      (const int32_t*)lengths, K, B, Kml, rate, budget, med, (int32_t*)err);
  return (int)cudaGetLastError();
}
