// Packed 2-bit Hamming extension: mismatch counts of (B, C) candidate loci.
//
// Replaces the TPU kernel biokanga_tpu/ops/stream_gather.py `_mm_kernel`
// (stream_extend_mm) and covers the whole contract of the plain JAX
// function it stands in for, biokanga_tpu/ops/extend_packed.py
// `hamming_extend_packed`: reads of up to 4,096 bases (W <= 256 words),
// the genome's N plane, Ns in reads (an N on either side is a mismatch),
// and entry containment.  `_mm_kernel`'s read-N fault is not copied.
//
// Layout: the genome is 2-bit packed, 16 bases per uint32 word, most
// significant base first, into overlapping rows of 16 words with a stride
// of 8 words (row i = words[8i, 8i+16)).  A candidate at `locus` needs
// the W+1 words from word locus >> 4 on, shifted left by 2 (locus & 15)
// bits: words s16 .. s16+W of rows r0, r0+2, ... (r0 = locus >> 7,
// s16 = (locus >> 4) & 7), one aligned 64 B row when W <= 8 (reads of up
// to 128 bases), two rows when W <= 16.
//
// Design: one thread a candidate, 256 a block, the blocks walking the
// flattened (B, C) candidates (at most four waves of them), so that no
// thread idles behind a read's short row and no barrier is needed after
// the entry starts are staged.  A warp's lanes take consecutive candidates,
// so they share one or two reads, whose words come from L1.  The word count
// W is a template parameter up to 16, so the word loop unrolls and every
// load of a candidate's window is one instruction at a fixed offset from
// its row.  Per candidate: entry containment by one binary search (the
// first entry start above min(locus, last) must lie above max(locus,
// last)), in shared memory when the starts fit in 16 KB; then per window
// word the two neighbouring genome words are aligned with __funnelshift_l,
// XORed with the read, ORed with both N planes, folded to one bit per base
// lane, masked to the read's length and counted with __popc.  Invalid
// candidates load nothing past their locus and flag.  Reads past 256 bases
// (W > 16), and tables too short for a window (never for pack_genome's
// rows), take a loop over the words with the row index clamped, as the
// plain version clamps it.  The output is (B, C) uint8: min(count, 254),
// 255 where invalid.
//
// Bounds on the H100: the integer operations of the candidates that pass
// the flag, range and containment tests (per word of the read a funnel
// shift, two LOP3s, a shift, __popc and an add), the containment search of
// those in range, and 6 bytes of loci, flags and output a candidate.  The
// first kernel (one block of 128 threads a read, the read staged behind a
// barrier, a clamped index per word, two binary searches in device
// memory) and this one both run under half of that bound (PERF.md's
// kernel table gives the shares, from chip_smoke.py).  What holds this one
// is the latency of scattered 64 B row reads.  A warp a read (8 a block, a
// grid of 8 blocks an SM) ran about 4% faster on random candidates and on
// the PE cell's, and no faster on the SE cell's; it was not kept, for this
// kernel's simpler mapping.  Several candidates a thread, 16-byte row
// loads and read words staged in shared memory ran slower (PERF.md, #3's
// designs tried).
//
// The windowed entry (#3w), `hamming_extend_packed_win`, replaces the XLA
// function biokanga_tpu/ops/extend_packed.py `hamming_extend_packed_win`,
// the hot loop of the assembler's overlap sweep (assembly/scale_overlap):
// the same kernel with a window per candidate in place of the read's
// length.  win (B, C) is clipped to [0, 16 W]; a candidate needs win > 0,
// locus >= 0, locus + win - 1 < n and its window (not the read) inside
// one entry; the lane mask is the window's; read and genome Ns count as
// mismatches; the output is the int32 count, unclamped, and 2^30 where
// invalid.  A candidate counts only the ceil(win / 16) words its window
// covers, so the loop path (W > 16: overlaps of 257 to 4,096 bases) does
// the work this call's windows need, not W words each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;         // a block
constexpr int kSmemStarts = 4096;     // entry starts staged in shared memory
constexpr int kMaxFastWords = 16;     // template word counts 1..16
constexpr int kGridWaves = 4;         // blocks: at most this many waves

// Number of elements of the ascending a[0, n) that are <= x, by binary
// lifting from `top`, the largest power of two <= n (0 when n = 0): the
// same steps in every lane.
template <bool SMEM>
__device__ __forceinline__ int count_le(const int32_t* a, int n, int top,
                                        int64_t x) {
    int pos = 0;
    for (int step = top; step > 0; step >>= 1) {
        const int i = pos + step;
        if (i <= n && (int64_t)(SMEM ? a[i - 1] : __ldg(a + i - 1)) <= x)
            pos = i;
    }
    return pos;
}

// Entry containment: no entry start in (min(locus, last), max(locus,
// last)], which is count_le(locus) == count_le(last).
template <bool SMEM>
__device__ __forceinline__ bool one_entry(const int32_t* a, int n, int top,
                                          int64_t locus, int64_t last) {
    const int64_t lo = locus < last ? locus : last;
    const int64_t hi = locus < last ? last : locus;
    const int e = count_le<SMEM>(a, n, top, lo);
    return e == n || (int64_t)(SMEM ? a[e] : __ldg(a + e)) > hi;
}

// Lane mask of read word j: the first clamp(len - 16 j, 0, 16) bases.
__device__ __forceinline__ uint32_t len_mask(int len, int j) {
    int v = len - 16 * j;
    v = v < 0 ? 0 : (v > 16 ? 16 : v);
    return v == 0 ? 0u : (0x55555555u << (2 * (16 - v)));
}

// Mismatches of one window word against read word (rc, rn) under mask m.
__device__ __forceinline__ int word_mm(uint32_t g0, uint32_t g1, uint32_t n0,
                                       uint32_t n1, bool has_n, int sh,
                                       uint32_t rc, uint32_t rn,
                                       uint32_t m) {
    uint32_t x = (__funnelshift_l(g1, g0, sh) ^ rc) | rn;
    if (has_n) x |= __funnelshift_l(n1, n0, sh);
    return __popc((x | (x >> 1)) & m);
}

// Word i of the concatenated stride-2 rows starting at row r0 (clamped).
__device__ __forceinline__ uint32_t row_word(const uint32_t* __restrict__ tab,
                                             int r0, int R, int i) {
    int r = r0 + 2 * (i >> 4);
    r = r < R - 1 ? r : R - 1;
    return __ldg(tab + (int64_t)r * 16 + (i & 15));
}

// Any word count, rows clamped to the table: reads past 256 bases, and
// the first W words of a window.
__device__ int mismatches_any(const uint32_t* __restrict__ rows,
                              const uint32_t* __restrict__ n_rows, int R,
                              int64_t locus, const uint32_t* __restrict__ rc,
                              const uint32_t* __restrict__ rn, int len,
                              int W) {
    int r0 = (int)(locus >> 7);
    r0 = r0 < R - 1 ? r0 : R - 1;
    const int s16 = (int)(locus >> 4) & 7;
    const int sh = 2 * (int)(locus & 15);
    const bool has_n = n_rows != nullptr;
    uint32_t g0 = row_word(rows, r0, R, s16);
    uint32_t n0 = has_n ? row_word(n_rows, r0, R, s16) : 0u;
    int mm = 0;
    for (int j = 0; j < W; ++j) {
        const uint32_t g1 = row_word(rows, r0, R, s16 + j + 1);
        const uint32_t n1 = has_n ? row_word(n_rows, r0, R, s16 + j + 1) : 0u;
        mm += word_mm(g0, g1, n0, n1, has_n, sh, __ldg(rc + j), __ldg(rn + j),
                      len_mask(len, j));
        g0 = g1;
        n0 = n1;
    }
    return mm;
}

// NW = 1..16: a candidate's window words in registers; NW = 0: any word
// count, a loop.  One thread a candidate; the threads of a block take
// consecutive candidates, so a warp's lanes share one or two reads and
// their words come from L1.  WIN: the compare window is win[i] (clipped
// to [0, 16 W]) and the output int32 (module note); else the read's
// length and uint8.
template <int NW, bool HAS_N, bool WIN>
__global__ void __launch_bounds__(kThreads)
hamming_extend_kernel(const uint32_t* __restrict__ rows,
                      const uint32_t* __restrict__ n_rows, int R,
                      int genome_len, const int32_t* __restrict__ starts,
                      int n_starts, const int32_t* __restrict__ loci,
                      const uint8_t* __restrict__ valid,
                      const uint32_t* __restrict__ rcodes,
                      const uint32_t* __restrict__ rnlane,
                      const int32_t* __restrict__ lengths,
                      const int32_t* __restrict__ win, void* __restrict__ out,
                      int B, int C, int W) {
    extern __shared__ int32_t s_starts[];
    const bool staged = n_starts <= kSmemStarts;
    if (staged)
        for (int i = threadIdx.x; i < n_starts; i += blockDim.x)
            s_starts[i] = starts[i];
    __syncthreads();
    const int top = n_starts > 0 ? 1 << (31 - __clz(n_starts)) : 0;
    const int64_t total = (int64_t)B * C;
    const bool narrow = total <= 0x7fffffff;

    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         i < total; i += (int64_t)gridDim.x * blockDim.x) {
        const int32_t locus = loci[i];
        bool ok = valid[i] != 0;
        const int b = narrow ? (int)((uint32_t)i / (uint32_t)C)
                             : (int)(i / C);
        int len;
        if constexpr (WIN) {
            const int w = win[i];
            len = w < 0 ? 0 : (w > 16 * W ? 16 * W : w);
            ok = ok && len > 0;
        } else {
            len = lengths[b];
        }
        // last = locus + len - 1 < genome_len
        ok = ok && locus >= 0 && locus <= (int64_t)genome_len - len;
        const int64_t last = (int64_t)locus + len - 1;
        if (ok)
            ok = staged ? one_entry<true>(s_starts, n_starts, top, locus,
                                          last)
                        : one_entry<false>(starts, n_starts, top, locus,
                                           last);
        int mm = -1;
        if (ok) {
            const uint32_t* rc = rcodes + (int64_t)b * W;
            const uint32_t* rn = rnlane + (int64_t)b * W;
            const int r0 = locus >> 7;
            const int s16 = (locus >> 4) & 7;
            mm = 0;
            if (NW > 0 && r0 + 2 * ((s16 + NW) >> 4) < R) {
                // words s16 .. s16+NW of row r0, and of row r0+2 (32 words
                // on) once past the row's 16
                const int sh = 2 * (locus & 15);
                const int off = r0 << 4 | s16;
                constexpr int NR = NW > 0 ? NW : 1;
                uint32_t g[NR + 1], gn[HAS_N ? NR + 1 : 1];
#pragma unroll
                for (int j = 0; j <= NW; ++j) {
                    const int o = off + j + (NW > 8 ? ((s16 + j) & 16) : 0);
                    g[j] = __ldg(rows + o);
                    if (HAS_N) gn[HAS_N ? j : 0] = __ldg(n_rows + o);
                }
#pragma unroll
                for (int j = 0; j < NW; ++j)
                    mm += word_mm(g[j], g[j + 1],
                                  HAS_N ? gn[HAS_N ? j : 0] : 0u,
                                  HAS_N ? gn[HAS_N ? j + 1 : 0] : 0u, HAS_N,
                                  sh, __ldg(rc + j), __ldg(rn + j),
                                  len_mask(len, j));
            } else {
                // a window counts only the words it covers
                mm = mismatches_any(rows, HAS_N ? n_rows : nullptr, R, locus,
                                    rc, rn, len, WIN ? (len + 15) >> 4 : W);
            }
        }
        if constexpr (WIN)
            static_cast<int32_t*>(out)[i] = mm < 0 ? 1 << 30 : mm;
        else
            static_cast<uint8_t*>(out)[i] =
                (uint8_t)(mm < 0 ? 255 : (mm < 254 ? mm : 254));
    }
}

struct Args {
    const uint32_t *rows, *n_rows;
    int R, genome_len;
    const int32_t* starts;
    int n_starts;
    const int32_t* loci;
    const uint8_t* valid;
    const uint32_t *rcodes, *rnlane;
    const int32_t* lengths;
    const int32_t* win;       // NULL but for the windowed entry
    void* out;
    int B, C, W;
};

constexpr int kMaxDevices = 64;

template <int NW, bool HAS_N, bool WIN>
cudaError_t launch(const Args& x, cudaStream_t stream) {
    const auto kernel = hamming_extend_kernel<NW, HAS_N, WIN>;
    const size_t smem =
        x.n_starts <= kSmemStarts ? (size_t)x.n_starts * sizeof(int32_t) : 0;
    // one wave of blocks on each card, asked of the runtime on the first
    // launch there (with the most shared memory a launch stages) and kept
    static std::atomic<int> waves[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    int wave = waves[dev].load(std::memory_order_relaxed);
    if (wave == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, kSmemStarts * sizeof(int32_t));
        if (err != cudaSuccess) return err;
        wave = sms * per_sm > 0 ? sms * per_sm : 1;
        waves[dev].store(wave, std::memory_order_relaxed);
    }
    const int64_t want = ((int64_t)x.B * x.C + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)kGridWaves * wave;
    const int grid = (int)(want < cap ? want : cap);
    kernel<<<grid, kThreads, smem, stream>>>(
        x.rows, x.n_rows, x.R, x.genome_len, x.starts, x.n_starts, x.loci,
        x.valid, x.rcodes, x.rnlane, x.lengths, x.win, x.out, x.B, x.C,
        x.W);
    return cudaGetLastError();
}

// The kernel for W words: NW = W up to 16, else the loop (NW = 0).
template <bool HAS_N, bool WIN, int NW = 1>
cudaError_t launch_words(const Args& x, cudaStream_t stream) {
    if constexpr (NW <= kMaxFastWords) {
        if (x.W == NW) return launch<NW, HAS_N, WIN>(x, stream);
        return launch_words<HAS_N, WIN, NW + 1>(x, stream);
    } else {
        return launch<0, HAS_N, WIN>(x, stream);
    }
}

template <bool WIN>
int launch_any(const Args& x, void* stream) {
    if (x.B <= 0 || x.C <= 0) return (int)cudaGetLastError();
    if (x.R <= 0 || x.W < 0) return (int)cudaErrorInvalidValue;
    const auto s = (cudaStream_t)stream;
    return (int)(x.n_rows ? launch_words<true, WIN>(x, s)
                          : launch_words<false, WIN>(x, s));
}

}  // namespace

extern "C" int hamming_extend_packed(
    const void* rows, const void* n_rows, int R, int genome_len,
    const void* entry_starts, int n_starts, const void* loci,
    const void* valid, const void* rcodes, const void* rnlane,
    const void* lengths, void* out, int B, int C, int W, void* stream) {
    return launch_any<false>(
        Args{(const uint32_t*)rows, (const uint32_t*)n_rows, R, genome_len,
             (const int32_t*)entry_starts, n_starts, (const int32_t*)loci,
             (const uint8_t*)valid, (const uint32_t*)rcodes,
             (const uint32_t*)rnlane, (const int32_t*)lengths, nullptr, out,
             B, C, W},
        stream);
}

// The windowed entry: win (B, C) int32 in place of lengths, out (B, C)
// int32.
extern "C" int hamming_extend_packed_win(
    const void* rows, const void* n_rows, int R, int genome_len,
    const void* entry_starts, int n_starts, const void* loci,
    const void* valid, const void* rcodes, const void* rnlane,
    const void* win, void* out, int B, int C, int W, void* stream) {
    return launch_any<true>(
        Args{(const uint32_t*)rows, (const uint32_t*)n_rows, R, genome_len,
             (const int32_t*)entry_starts, n_starts, (const int32_t*)loci,
             (const uint8_t*)valid, (const uint32_t*)rcodes,
             (const uint32_t*)rnlane, nullptr, (const int32_t*)win, out, B,
             C, W},
        stream);
}
