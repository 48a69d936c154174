// Banded affine-gap local Smith-Waterman over B pairs, with or without
// packed 2-bit traceback codes.
//
// Replaces two TPU kernels of biokanga_tpu/ops/pallas_sw.py: `_kernel_moves`
// (banded_sw_moves, the error-correction SW step) and `_kernel`
// (banded_sw_score, the same DP reporting the score and best cell only).
//
// The DP is the JAX package's, cell for cell.  Pair p aligns query a[p]
// (rows i < min(alen, La)) against its target band window bwin[p]
// (bwin[t] = b[t - W + diag], see ops/banded_sw.py normalize_band); band
// column k in [0, K), K = 2W+1, of row i reads bwin[i + k] and is valid
// when jlo <= i + k - W < jhi.  Per row, with match/mismatch `sub` (the
// bases match when equal and both below 4):
//   E  = max(Hup + gap_open, Eup + gap_ext)     (up: column k+1, row i-1)
//   Hd = H + sub                                (diagonal: column k)
//   H0 = max(Hd, E, 0, sub > 0 ? sub : 0)  =  max(Hd, E, sub, 0)
//   F  = max_{k' < k} H0[k'] + gap_open + (k - k' - 1) gap_ext   (lazy F)
//   H  = max(H0, F, 0);  H and E are NEG outside the band.
// The move code of a cell is STOP < LEFT (H == F) < UP (H == E) < DIAG
// (H == Hd), each only where H > 0.  The best cell is the first row whose
// maximum exceeds the best so far, at its lowest column; a pair with no
// positive cell reports (0, 0, 0).  With moves, word mv[p][i >> 4][k] holds
// code(i, k) at bit 2*(i & 15), shape (B, ceil(La/16), K); words of rows at
// or past alen are 0 (STOP).
//
// Layout: the band in registers, lane l holding C consecutive columns
// (C = ceil(K/32) rounded up to a compiled width: 7 at the default
// W = 96), one warp a block, so that the loop bounds and every branch on
// them are warp-uniform (no convergence code around the shuffles).  Per
// row the warp broadcasts the query base (__shfl_sync of 32 bases staged
// a lane each), shifts the target bases and takes its up-neighbours from
// the next lane (__shfl_down_sync), runs the lazy-F prefix max as a
// per-lane prefix plus a 5-step __shfl_up_sync scan of the lane totals,
// and finds the row maximum with one __reduce_max_sync (the lowest column
// only when the best improves, rare).
//
// Bound on the H100: integer operations (bytes are 2 per row in and, with
// moves, 4 per 16 cells out), issued by one warp a pair.  One int32 a cell;
// Hopper's DPX instructions take the max chains: E is __viaddmax_s32, H0
// one __vimax3_s32_relu, the lazy-F prefix one __viaddmax_s32 a cell; the
// band test is one bit of a per-row lane mask; the codes enter their words
// by a funnel shift, so no shift depends on the row.  One warp a block
// keeps the shuffles free of convergence code.  16-bit lanes (two columns
// or two pairs a register) were tried and ran slower at the error
// correction's chunks of ~1,300 pairs; PERF.md lists each design's times.
//
// Bands past one warp's 512 columns (W > 255, up to W = 4,095): one block
// a pair, the band split across up to 16 warps of C = 4, 8 or 16 columns
// a lane (the least C that needs no more than 16 warps), each warp running
// the row as above.  A row crosses warps three times, through shared
// memory: the up-neighbour of a warp's last lane (the next warp's first
// column of the last row), the carry of the lazy-F prefix (the maximum of
// the lower warps' totals) and the row maximum.  The up-neighbours of row
// i+1 are written with row i's maxima, so a row takes two barriers; a new
// best cell takes a third, for its lowest column.  Registers are the
// limit at 512 threads a block (128 a thread): the lazy F runs as the
// recurrence F[c] = max(F[c-1] + gap_ext, H0[c-1] + gap_open) inside a
// lane, whose maxima are those of the prefix form, so no per-column
// prefix or offset array is kept.
//
// Bands past what registers hold (K > 16 warps x 512 columns, W > 4,095):
// the same block of 16 warps walks each row in segments of 16 x 32 x 8
// columns, left to right, and keeps every column's H and E between rows
// (and, with moves, its word of codes for the current 16 rows) in a state
// row: in shared memory while K x 8 B (12 B with moves) fits the block's
// opt-in shared memory (up to about 29 K columns, 19 K with moves), else
// in a scratch row of device memory that the wrapper allocates
// (banded_sw_scratch says how many int32 a pair).  A segment reads its
// columns and the up-neighbour of its last column (the next segment's
// first, still last row's) before its barrier and writes them after it;
// the lazy-F carry runs from segment to segment in a register; each
// thread keeps its row maximum and lowest column over its segments, so a
// new best cell needs no second pass over the row.  The target bases are
// read from bwin at i + k each row (L1), not shifted through registers.
// Speed is not this path's aim: one pass over the state row a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -10000000;     // ops/sw.py NEG
constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;

// a query base as compared: 0..3 (or a negative code) itself, else a value
// no target base takes; a target base likewise
__device__ __forceinline__ int query_code(int a) {
    return a < 4 ? a : 0x4000;
}
__device__ __forceinline__ int target_code(int b) {
    return b < 4 ? b : 0x2000;
}

// columns [lo, hi) of the C a lane holds that are in the band, as a mask
__device__ __forceinline__ uint32_t band_bits(int lo, int hi, int C) {
    lo = lo < 0 ? 0 : (lo > C ? C : lo);
    hi = hi < 0 ? 0 : (hi > C ? C : hi);
    const uint32_t below_hi = hi >= 32 ? 0xffffffffu : (1u << hi) - 1u;
    const uint32_t below_lo = lo >= 32 ? 0xffffffffu : (1u << lo) - 1u;
    return below_hi & ~below_lo;
}

template <int C, bool MOVES>
__global__ void __launch_bounds__(32)
banded_sw_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bwin,
                 const int32_t* __restrict__ alen,
                 const int32_t* __restrict__ jlo,
                 const int32_t* __restrict__ jhi,
                 int32_t* __restrict__ best_out,
                 int32_t* __restrict__ bi_out, int32_t* __restrict__ bk_out,
                 int32_t* __restrict__ mv, int B, int La, int T, int W,
                 int match, int mismatch, int gap_open, int gap_ext) {
    const int p = blockIdx.x;                 // one warp a block: p, the
    const int lane = threadIdx.x;             // loop bounds and every branch
                                              // on them are warp-uniform
    const int K = 2 * W + 1;
    const int Wd = (La + 15) >> 4;
    const int8_t* ap = a + (int64_t)p * La;
    const int8_t* bp = bwin + (int64_t)p * T;
    int n_rows = alen[p];
    n_rows = n_rows < 0 ? 0 : (n_rows > La ? La : n_rows);
    const int lo = jlo[p], hi = jhi[p];
    const int k0 = lane * C;
    // the band columns of row i are k in [lo + W - i, hi + W - i) and < K
    const int lo_rel = lo + W - k0;
    const int hi_rel = hi + W - k0;
    const int k_rel_end = K - k0;

    int H[C], E[C], bb[C], run_k[C], f_k[C];
    uint32_t word[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        H[c] = 0;
        E[c] = kNeg;
        word[c] = 0;
        const int t = k0 + c;
        bb[c] = target_code(t < T ? bp[t] : 4);
        run_k[c] = -gap_ext * (k0 + c);              // H0 - k * gap_ext
        f_k[c] = gap_ext * (k0 + c) + gap_open - gap_ext;
    }
    int best = 0, bi = 0, bk = 0;
    int a_stage = 0x4000, b_stage = 0x2000;

    for (int i = 0; i < n_rows; ++i) {
        const int r = i & 31;
        if (r == 0) {
            a_stage = query_code(i + lane < La ? ap[i + lane] : 4);
            const int t = i + 32 * C + lane;  // enters lane 31 at row i+lane+1
            b_stage = target_code(t < T ? bp[t] : 4);
        }
        const int ai = __shfl_sync(kFull, a_stage, r);
        int h_next = __shfl_down_sync(kFull, H[0], 1);
        int e_next = __shfl_down_sync(kFull, E[0], 1);
        if (lane == 31) h_next = e_next = kNeg;
        const int hi_c = hi_rel - i < k_rel_end ? hi_rel - i : k_rel_end;
        const uint32_t inb = band_bits(lo_rel - i, hi_c, C);

        // E, Hd and H0 (H0 replaces H in place; H[c+1] is still last row's)
        int hd[MOVES ? C : 1];
        int pm[C];
        int run_max = kNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int hup = c + 1 < C ? H[c + 1] : h_next;
            const int eup = c + 1 < C ? E[c + 1] : e_next;
            const int e = __viaddmax_s32(eup, gap_ext, hup + gap_open);
            const int sub = ai == bb[c] ? match : mismatch;
            const int d = H[c] + sub;
            if (MOVES) hd[MOVES ? c : 0] = d;
            E[c] = e;
            H[c] = __vimax3_s32_relu(d, e, sub);
            run_max = __viaddmax_s32(H[c], run_k[c], run_max);
            pm[c] = run_max;
        }
        // lazy F: exclusive prefix max over the band of H0 - gap_ext * k
        // (a lane below d gets its own value back from __shfl_up_sync)
        int scan = run_max;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
            scan = max(scan, __shfl_up_sync(kFull, scan, d));
        int excl = __shfl_up_sync(kFull, scan, 1);
        if (lane == 0) excl = kNeg;

        int row_max = kNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int prev = c == 0 ? excl : max(excl, pm[c - 1]);
            const int f = prev + f_k[c];
            const bool in = (inb >> c) & 1u;
            const int h = in ? __vimax_s32_relu(H[c], f) : kNeg;
            const int e = in ? E[c] : kNeg;
            if (MOVES) {
                int code = h == f ? kLeft : kStop;
                code = h == e ? kUp : code;
                code = h == hd[MOVES ? c : 0] ? kDiag : code;
                code = h > 0 ? code : kStop;
                // row i's code enters at bits 30-31 and moves down two bits
                // a row: after 16 rows row r sits at bit 2*r
                word[c] = __funnelshift_r(word[c], (uint32_t)code, 2);
            }
            H[c] = h;
            E[c] = e;
            row_max = max(row_max, h);
        }
        const int rb = __reduce_max_sync(kFull, row_max);
        if (rb > best) {                      // warp-uniform
            int kk = 0x7fffffff;
#pragma unroll
            for (int c = C - 1; c >= 0; --c)
                if (H[c] == rb) kk = k0 + c;
            bk = __reduce_min_sync(kFull, kk);
            best = rb;
            bi = i;
        }
        if (MOVES && ((i & 15) == 15 || i == n_rows - 1)) {
            const int sh = 2 * (15 - (i & 15));   // a short last word
            int32_t* dst = mv + ((int64_t)p * Wd + (i >> 4)) * K;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (k0 + c < K) dst[k0 + c] = (int32_t)(word[c] >> sh);
                word[c] = 0;
            }
        }

        // target window of row i+1: one column down
        const int from_next = __shfl_down_sync(kFull, bb[0], 1);
        const int top = __shfl_sync(kFull, b_stage, r);
#pragma unroll
        for (int c = 0; c + 1 < C; ++c) bb[c] = bb[c + 1];
        bb[C - 1] = lane == 31 ? top : from_next;
    }

    if (MOVES) {                              // rows >= alen: all STOP
        for (int w = (n_rows + 15) >> 4; w < Wd; ++w) {
            int32_t* dst = mv + ((int64_t)p * Wd + w) * K;
#pragma unroll
            for (int c = 0; c < C; ++c)
                if (k0 + c < K) dst[k0 + c] = 0;
        }
    }
    if (lane == 0) {
        best_out[p] = best;
        bi_out[p] = bi;
        bk_out[p] = bk;
    }
}


// The same DP, one block a pair: warp w holds columns [32 C w, 32 C (w+1))
// of the band, lane l of it C consecutive columns from 32 C w + C l.
constexpr int kWideWarps = 16;

template <int C, bool MOVES>
__global__ void __launch_bounds__(kWideWarps * 32)
banded_sw_wide(const int8_t* __restrict__ a, const int8_t* __restrict__ bwin,
               const int32_t* __restrict__ alen,
               const int32_t* __restrict__ jlo,
               const int32_t* __restrict__ jhi,
               int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
               int32_t* __restrict__ bk_out, int32_t* __restrict__ mv, int B,
               int La, int T, int W, int match, int mismatch, int gap_open,
               int gap_ext) {
    // one block a pair: p, the loop bounds and every branch on them are
    // block-uniform; the warp index is broadcast so the compiler sees it
    // is warp-uniform
    __shared__ int s_h[kWideWarps], s_e[kWideWarps], s_tot[kWideWarps],
        s_max[kWideWarps], s_k[kWideWarps];
    const int p = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = __shfl_sync(kFull, (int)threadIdx.x, 0) >> 5;
    const int nw = blockDim.x >> 5;
    const int K = 2 * W + 1;
    const int Wd = (La + 15) >> 4;
    const int8_t* ap = a + (int64_t)p * La;
    const int8_t* bp = bwin + (int64_t)p * T;
    int n_rows = alen[p];
    n_rows = n_rows < 0 ? 0 : (n_rows > La ? La : n_rows);
    const int lo = jlo[p], hi = jhi[p];
    const int k0 = (warp * 32 + lane) * C;
    const int lo_rel = lo + W - k0;
    const int hi_rel = hi + W - k0;
    const int k_rel_end = K - k0;
    const int f0 = gap_ext * k0 + gap_open - gap_ext;   // F offset at k0

    int H[C], E[C], bb[C];
    uint32_t word[MOVES ? C : 1];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        H[c] = 0;
        E[c] = kNeg;
        if (MOVES) word[MOVES ? c : 0] = 0;
        const int t = k0 + c;
        bb[c] = target_code(t < T ? bp[t] : 4);
    }
    if (lane == 0) {
        s_h[warp] = 0;
        s_e[warp] = kNeg;
    }
    __syncthreads();
    int best = 0, bi = 0, bk = 0;
    int a_stage = 0x4000, b_stage = 0x2000;

    for (int i = 0; i < n_rows; ++i) {
        const int r = i & 31;
        if (r == 0) {
            a_stage = query_code(i + lane < La ? ap[i + lane] : 4);
            // enters this warp's lane 31 at row i+lane+1
            const int t = i + 32 * C * (warp + 1) + lane;
            b_stage = target_code(t < T ? bp[t] : 4);
        }
        const int ai = __shfl_sync(kFull, a_stage, r);
        int h_next = __shfl_down_sync(kFull, H[0], 1);
        int e_next = __shfl_down_sync(kFull, E[0], 1);
        if (lane == 31) {
            const bool last = warp + 1 == nw;
            h_next = last ? kNeg : s_h[warp + 1];
            e_next = last ? kNeg : s_e[warp + 1];
        }
        const int hi_c = hi_rel - i < k_rel_end ? hi_rel - i : k_rel_end;
        const uint32_t inb = band_bits(lo_rel - i, hi_c, C);

        // E, Hd and H0 (H0 replaces H in place; H[c+1] is still last row's)
        int hd[MOVES ? C : 1];
        int run_max = kNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int hup = c + 1 < C ? H[c + 1] : h_next;
            const int eup = c + 1 < C ? E[c + 1] : e_next;
            const int e = __viaddmax_s32(eup, gap_ext, hup + gap_open);
            const int sub = ai == bb[c] ? match : mismatch;
            const int d = H[c] + sub;
            if (MOVES) hd[MOVES ? c : 0] = d;
            E[c] = e;
            H[c] = __vimax3_s32_relu(d, e, sub);
            run_max = __viaddmax_s32(H[c], -gap_ext * (k0 + c), run_max);
        }
        // lazy F: the exclusive prefix max of H0 - gap_ext * k over the
        // lower lanes of the warp, then over the lower warps
        int scan = run_max;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
            scan = max(scan, __shfl_up_sync(kFull, scan, d));
        int excl = __shfl_up_sync(kFull, scan, 1);
        if (lane == 0) excl = kNeg;
        if (lane == 31) s_tot[warp] = scan;
        __syncthreads();
        excl = max(excl, __reduce_max_sync(
                             kFull, lane < warp ? s_tot[lane] : kNeg));

        int row_max = kNeg;
        int f = excl + f0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const bool in = (inb >> c) & 1u;
            const int h0 = H[c];
            const int h = in ? __vimax_s32_relu(h0, f) : kNeg;
            const int e = in ? E[c] : kNeg;
            if (MOVES) {
                int code = h == f ? kLeft : kStop;
                code = h == e ? kUp : code;
                code = h == hd[MOVES ? c : 0] ? kDiag : code;
                code = h > 0 ? code : kStop;
                word[MOVES ? c : 0] =
                    __funnelshift_r(word[MOVES ? c : 0], (uint32_t)code, 2);
            }
            f = __viaddmax_s32(f, gap_ext, h0 + gap_open);
            H[c] = h;
            E[c] = e;
            row_max = max(row_max, h);
        }
        // the row maximum, and the up-neighbours of row i+1
        const int wmax = __reduce_max_sync(kFull, row_max);
        if (lane == 0) {
            s_max[warp] = wmax;
            s_h[warp] = H[0];
            s_e[warp] = E[0];
        }
        __syncthreads();
        const int rb = __reduce_max_sync(kFull,
                                         lane < nw ? s_max[lane] : kNeg);
        if (rb > best) {                      // block-uniform
            int kk = 0x7fffffff;
#pragma unroll
            for (int c = C - 1; c >= 0; --c)
                if (H[c] == rb) kk = k0 + c;
            kk = __reduce_min_sync(kFull, kk);
            if (lane == 0) s_k[warp] = kk;
            __syncthreads();
            bk = __reduce_min_sync(kFull,
                                   lane < nw ? s_k[lane] : 0x7fffffff);
            best = rb;
            bi = i;
        }
        if (MOVES && ((i & 15) == 15 || i == n_rows - 1)) {
            const int sh = 2 * (15 - (i & 15));   // a short last word
            int32_t* dst = mv + ((int64_t)p * Wd + (i >> 4)) * K;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (k0 + c < K)
                    dst[k0 + c] = (int32_t)(word[MOVES ? c : 0] >> sh);
                word[MOVES ? c : 0] = 0;
            }
        }

        // target window of row i+1: one column down
        const int from_next = __shfl_down_sync(kFull, bb[0], 1);
        const int top = __shfl_sync(kFull, b_stage, r);
#pragma unroll
        for (int c = 0; c + 1 < C; ++c) bb[c] = bb[c + 1];
        bb[C - 1] = lane == 31 ? top : from_next;
    }

    if (MOVES) {                              // rows >= alen: all STOP
        for (int w = (n_rows + 15) >> 4; w < Wd; ++w) {
            int32_t* dst = mv + ((int64_t)p * Wd + w) * K;
#pragma unroll
            for (int c = 0; c < C; ++c)
                if (k0 + c < K) dst[k0 + c] = 0;
        }
    }
    if (threadIdx.x == 0) {
        best_out[p] = best;
        bi_out[p] = bi;
        bk_out[p] = bk;
    }
}

// Bands past the block path: the row in segments, the state row in shared
// or device memory (see the note at the top).  Thread t of a segment holds
// columns seg * kSeg + t * kTileC .. + kTileC - 1.
constexpr int kTileC = 8;
constexpr int kSeg = kWideWarps * 32 * kTileC;

template <bool MOVES>
__global__ void __launch_bounds__(kWideWarps * 32)
banded_sw_tiled(const int8_t* __restrict__ a, const int8_t* __restrict__ bwin,
                const int32_t* __restrict__ alen,
                const int32_t* __restrict__ jlo,
                const int32_t* __restrict__ jhi,
                int32_t* __restrict__ best_out, int32_t* __restrict__ bi_out,
                int32_t* __restrict__ bk_out, int32_t* __restrict__ mv,
                int32_t* __restrict__ scratch, int La, int T, int W,
                int match, int mismatch, int gap_open, int gap_ext) {
    constexpr int C = kTileC;
    extern __shared__ int32_t s_state[];
    __shared__ int s_tot[2][kWideWarps], s_max[kWideWarps], s_k[kWideWarps];
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = __shfl_sync(kFull, tid, 0) >> 5;
    const int K = 2 * W + 1;
    const int n_seg = (K + kSeg - 1) / kSeg;
    const int Wd = (La + 15) >> 4;
    const int8_t* ap = a + (int64_t)p * La;
    const int8_t* bp = bwin + (int64_t)p * T;
    int n_rows = alen[p];
    n_rows = n_rows < 0 ? 0 : (n_rows > La ? La : n_rows);
    const int lo = jlo[p], hi = jhi[p];
    // H, E and (with moves) the code words of the K columns
    const int64_t ints = (MOVES ? 3 : 2) * (int64_t)K;
    int32_t* sH = scratch ? scratch + (int64_t)p * ints : s_state;
    int32_t* sE = sH + K;
    int32_t* sW = sE + K;
    for (int k = tid; k < K; k += blockDim.x) {
        sH[k] = 0;
        sE[k] = kNeg;
    }
    __syncthreads();
    int best = 0, bi = 0, bk = 0;

    for (int i = 0; i < n_rows; ++i) {
        const int ai = query_code(ap[i]);
        int carry = kNeg;                     // prefix max of lower segments
        int tmax = kNeg, tk = 0x7fffffff;     // this thread's row max, column
        for (int seg = 0; seg < n_seg; ++seg) {
            const int k0 = seg * kSeg + tid * C;
            int H[C], E[C], hd[MOVES ? C : 1];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const bool ok = k0 + c < K;
                H[c] = ok ? sH[k0 + c] : kNeg;
                E[c] = ok ? sE[k0 + c] : kNeg;
            }
            const bool up_ok = k0 + C < K;
            const int h_next = up_ok ? sH[k0 + C] : kNeg;
            const int e_next = up_ok ? sE[k0 + C] : kNeg;
            int run_max = kNeg;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int hup = c + 1 < C ? H[c + 1] : h_next;
                const int eup = c + 1 < C ? E[c + 1] : e_next;
                const int e = __viaddmax_s32(eup, gap_ext, hup + gap_open);
                const int t = i + k0 + c;
                const int sub =
                    ai == target_code(t < T ? __ldg(bp + t) : 4) ? match
                                                                 : mismatch;
                const int d = H[c] + sub;
                if (MOVES) hd[MOVES ? c : 0] = d;
                E[c] = e;
                H[c] = __vimax3_s32_relu(d, e, sub);
                run_max = __viaddmax_s32(H[c], -gap_ext * (k0 + c), run_max);
            }
            // lazy F: the exclusive prefix max of H0 - gap_ext * k over the
            // lower lanes, the lower warps and the lower segments
            int scan = run_max;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1)
                scan = max(scan, __shfl_up_sync(kFull, scan, d));
            int excl = __shfl_up_sync(kFull, scan, 1);
            if (lane == 0) excl = kNeg;
            if (lane == 31) s_tot[seg & 1][warp] = scan;
            __syncthreads();
            const int tot = lane < kWideWarps ? s_tot[seg & 1][lane] : kNeg;
            excl = max(max(excl, carry),
                       __reduce_max_sync(kFull, lane < warp ? tot : kNeg));
            carry = max(carry, __reduce_max_sync(kFull, tot));

            int f = excl + gap_ext * k0 + gap_open - gap_ext;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int k = k0 + c;
                const int j = i + k - W;
                const bool in = k < K && j >= lo && j < hi;
                const int h0 = H[c];
                const int h = in ? __vimax_s32_relu(h0, f) : kNeg;
                const int e = in ? E[c] : kNeg;
                if (k < K) {
                    if (MOVES) {
                        int code = h == f ? kLeft : kStop;
                        code = h == e ? kUp : code;
                        code = h == hd[MOVES ? c : 0] ? kDiag : code;
                        code = h > 0 ? code : kStop;
                        // row i's code enters at bits 30-31, as in the
                        // register paths; the word waits in the state row
                        const uint32_t word = __funnelshift_r(
                            (i & 15) ? (uint32_t)sW[k] : 0u, (uint32_t)code,
                            2);
                        if ((i & 15) == 15 || i == n_rows - 1)
                            mv[((int64_t)p * Wd + (i >> 4)) * K + k] =
                                (int32_t)(word >> (2 * (15 - (i & 15))));
                        else
                            sW[k] = (int32_t)word;
                    }
                    sH[k] = h;
                    sE[k] = e;
                }
                f = __viaddmax_s32(f, gap_ext, h0 + gap_open);
                if (h > tmax) {
                    tmax = h;
                    tk = k;
                }
            }
        }
        // the row maximum and its lowest column
        const int wmax = __reduce_max_sync(kFull, tmax);
        if (lane == 0) s_max[warp] = wmax;
        __syncthreads();
        const int rb =
            __reduce_max_sync(kFull, lane < kWideWarps ? s_max[lane] : kNeg);
        if (rb > best) {                      // block-uniform
            const int kk = __reduce_min_sync(kFull,
                                             tmax == rb ? tk : 0x7fffffff);
            if (lane == 0) s_k[warp] = kk;
            __syncthreads();
            bk = __reduce_min_sync(kFull,
                                   lane < kWideWarps ? s_k[lane] : 0x7fffffff);
            best = rb;
            bi = i;
        }
    }

    if (MOVES) {                              // rows >= alen: all STOP
        for (int w = (n_rows + 15) >> 4; w < Wd; ++w) {
            int32_t* dst = mv + ((int64_t)p * Wd + w) * K;
            for (int k = tid; k < K; k += blockDim.x) dst[k] = 0;
        }
    }
    if (tid == 0) {
        best_out[p] = best;
        bi_out[p] = bi;
        bk_out[p] = bk;
    }
}

struct Args {
    const int8_t* a;
    const int8_t* bwin;
    const int32_t *alen, *jlo, *jhi;
    int32_t *best, *bi, *bk, *mv, *scratch;
    int B, La, T, W, match, mismatch, gap_open, gap_ext;
};

template <bool MOVES>
cudaError_t launch(const Args& x, cudaStream_t stream) {
    const int cols = 2 * x.W + 1;
    const dim3 grid(x.B), block(32);
#define BIOKANGA_SW_CASE(CC)                                                 \
    if (cols <= 32 * CC) {                                                   \
        banded_sw_kernel<CC, MOVES><<<grid, block, 0, stream>>>(             \
            x.a, x.bwin, x.alen, x.jlo, x.jhi, x.best, x.bi, x.bk, x.mv,     \
            x.B, x.La, x.T, x.W, x.match, x.mismatch, x.gap_open,            \
            x.gap_ext);                                                      \
        return cudaGetLastError();                                           \
    }
    BIOKANGA_SW_CASE(1)
    BIOKANGA_SW_CASE(2)
    BIOKANGA_SW_CASE(4)
    BIOKANGA_SW_CASE(7)
    BIOKANGA_SW_CASE(8)
    BIOKANGA_SW_CASE(16)
#undef BIOKANGA_SW_CASE
#define BIOKANGA_SW_WIDE(CC)                                                 \
    if (cols <= kWideWarps * 32 * CC) {                                      \
        const int warps = (cols + 32 * CC - 1) / (32 * CC);                  \
        banded_sw_wide<CC, MOVES><<<grid, warps * 32, 0, stream>>>(          \
            x.a, x.bwin, x.alen, x.jlo, x.jhi, x.best, x.bi, x.bk, x.mv,     \
            x.B, x.La, x.T, x.W, x.match, x.mismatch, x.gap_open,            \
            x.gap_ext);                                                      \
        return cudaGetLastError();                                           \
    }
    BIOKANGA_SW_WIDE(4)
    BIOKANGA_SW_WIDE(8)
    BIOKANGA_SW_WIDE(16)
#undef BIOKANGA_SW_WIDE
    const auto kernel = banded_sw_tiled<MOVES>;
    size_t smem = 0;
    if (!x.scratch) {
        smem = (size_t)(MOVES ? 3 : 2) * cols * sizeof(int32_t);
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kWideWarps * 32, smem, stream>>>(
        x.a, x.bwin, x.alen, x.jlo, x.jhi, x.best, x.bi, x.bk, x.mv,
        x.scratch, x.La, x.T, x.W, x.match, x.mismatch, x.gap_open,
        x.gap_ext);
    return cudaGetLastError();
}

// int32 of state a pair keeps in device memory: 0 where the band fits
// the register paths or its state row fits the tiled kernel's shared
// memory.
cudaError_t scratch_ints(int W, bool moves, long long* ints) {
    *ints = 0;
    const long long cols = 2 * (long long)W + 1;
    if (cols <= kWideWarps * 32 * 16) return cudaSuccess;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr{};
    if (err == cudaSuccess)
        err = moves ? cudaFuncGetAttributes(&attr, banded_sw_tiled<true>)
                    : cudaFuncGetAttributes(&attr, banded_sw_tiled<false>);
    if (err != cudaSuccess) return err;
    const long long state = (moves ? 3 : 2) * cols;
    if (state * (long long)sizeof(int32_t) + (long long)attr.sharedSizeBytes >
        optin)
        *ints = state;
    return cudaSuccess;
}

}  // namespace

// a (B, La) int8; bwin (B, T) int8, T >= ceil(La/16)*16 + 2W; alen, jlo,
// jhi (B,) int32; best, bi, bk (B,) int32 out; mv (B, ceil(La/16), 2W+1)
// int32 out, or null for the score-only kernel; scratch (B, n) int32 with
// n from banded_sw_scratch, or null where n is 0.  One warp a pair up to
// W = 255, one block of up to 16 warps to W = 4,095, past that one block
// of 16 warps walking the row in segments.
extern "C" int banded_sw(const void* a, const void* bwin, const void* alen,
                         const void* jlo, const void* jhi, void* best,
                         void* bi, void* bk, void* mv, void* scratch, int B,
                         int La, int T, int W, int match, int mismatch,
                         int gap_open, int gap_ext, void* stream) {
    if (W < 0 || W > (0x7fffffff - 1) / 2) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    long long need = 0;
    const cudaError_t err = scratch_ints(W, mv != nullptr, &need);
    if (err != cudaSuccess) return (int)err;
    if ((need > 0) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
    const Args x{(const int8_t*)a,   (const int8_t*)bwin, (const int32_t*)alen,
                 (const int32_t*)jlo, (const int32_t*)jhi, (int32_t*)best,
                 (int32_t*)bi,        (int32_t*)bk,        (int32_t*)mv,
                 (int32_t*)scratch,   B, La, T, W, match, mismatch, gap_open,
                 gap_ext};
    const auto s = (cudaStream_t)stream;
    return (int)(mv ? launch<true>(x, s) : launch<false>(x, s));
}

// *ints = the int32 of device-memory state banded_sw needs a pair at band
// half-width W, with (moves != 0) or without move planes.
extern "C" int banded_sw_scratch(int W, int moves, long long* ints) {
    if (W < 0) return (int)cudaErrorInvalidValue;
    return (int)scratch_ints(W, moves != 0, ints);
}
