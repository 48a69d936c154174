// Banded affine-gap local Smith-Waterman over B pairs, with or without
// packed 2-bit traceback codes.
//
// Replaces two TPU kernels of biokanga_tpu/ops/pallas_sw.py: `_kernel_moves`
// (banded_sw_moves, the error-correction SW step) and `_kernel`
// (banded_sw_score, the same DP reporting the score and best cell only).
// One template serves both; MOVES=false compiles the move output out.
//
// The DP is the JAX package's, cell for cell.  Pair p aligns query a[p]
// (rows i < min(alen, La)) against its target band window bwin[p]
// (bwin[t] = b[t - W + diag], see ops/banded_sw.py normalize_band); band
// column k in [0, K), K = 2W+1, of row i reads bwin[i + k] and is valid
// when jlo <= i + k - W < jhi.  Per row, with match/mismatch `sub` (N
// never matches):
//   E  = max(Hup + gap_open, Eup + gap_ext)     (up: column k+1, row i-1)
//   Hd = H + sub                                (diagonal: column k)
//   H0 = max(Hd, E, 0, sub > 0 ? sub : 0)
//   F  = max_{k' < k} H0[k'] + gap_open + (k - k' - 1) gap_ext   (lazy F)
//   H  = max(H0, F, 0);  H and E are NEG outside the band.
// The move code of a cell is STOP < LEFT (H == F) < UP (H == E) < DIAG
// (H == Hd), each only where H > 0.  The best cell is the first row whose
// maximum exceeds the best so far, at its lowest column; a pair with no
// positive cell reports (0, 0, 0).
//
// Design: one warp per pair.  Lane l holds the C consecutive band columns
// k = l*C .. l*C + C-1 of H and E in registers (C = ceil(K/32) rounded up
// to a compiled width: 7 at the default W = 96).  Per row:
//   - the query base is a warp broadcast (__shfl_sync) from 32 bases
//     staged one per lane every 32 rows;
//   - the target bases shift down one column: each lane moves its
//     registers along and takes its last one from the next lane
//     (__shfl_down_sync); lane 31 takes a base staged every 32 rows;
//   - the up-neighbour of a lane's last column comes from the next lane
//     (__shfl_down_sync);
//   - the lazy-F running max is a per-lane prefix max, a 5-step
//     __shfl_up_sync scan of the lane totals, then a fix-up;
//   - the row maximum is one __reduce_max_sync; only when it beats the
//     best so far (rare) does a __reduce_min_sync find its lowest column.
// With MOVES, each lane gathers 16 rows of 2-bit codes per column in one
// 32-bit register and stores one word per column every 16 rows:
//   mv[p][i >> 4][k] bit 2*(i & 15) = code(i, k),   shape (B, ceil(La/16), K).
// Words of rows at or past alen are written as 0 (STOP).
//
// Bound on the H100: integer operations, not bytes.  A cell costs some 20
// int32 operations (25 with moves) of a strictly serial row recurrence,
// while the bytes are 2 per row in and, with moves, 4 per 16 cells out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -10000000;     // ops/sw.py NEG
constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int C, bool MOVES>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
banded_sw_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bwin,
                 const int32_t* __restrict__ alen,
                 const int32_t* __restrict__ jlo,
                 const int32_t* __restrict__ jhi, int32_t* __restrict__ best_out,
                 int32_t* __restrict__ bi_out, int32_t* __restrict__ bk_out,
                 int32_t* __restrict__ mv, int B, int La, int T, int W,
                 int match, int mismatch, int gap_open, int gap_ext) {
    const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (p >= B) return;                       // whole warps leave together
    const int K = 2 * W + 1;
    const int Wd = (La + 15) >> 4;
    const int8_t* ap = a + (int64_t)p * La;
    const int8_t* bp = bwin + (int64_t)p * T;
    int n_rows = alen[p];
    n_rows = n_rows < 0 ? 0 : (n_rows > La ? La : n_rows);
    const int lo = jlo[p], hi = jhi[p];
    const int k0 = lane * C;

    int H[C], E[C], bb[C];
    uint32_t word[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        H[c] = 0;
        E[c] = kNeg;
        word[c] = 0;
        const int t = k0 + c;
        bb[c] = t < T ? bp[t] : 4;
    }
    int best = 0, bi = 0, bk = 0;
    int a_stage = 4, b_stage = 4;

    for (int i = 0; i < n_rows; ++i) {
        const int r = i & 31;
        if (r == 0) {
            a_stage = i + lane < La ? ap[i + lane] : 4;
            const int t = i + 32 * C + lane;  // enters lane 31 at row i+lane+1
            b_stage = t < T ? bp[t] : 4;
        }
        const int ai = __shfl_sync(kFull, a_stage, r);
        int h_next = __shfl_down_sync(kFull, H[0], 1);
        int e_next = __shfl_down_sync(kFull, E[0], 1);
        if (lane == 31) h_next = e_next = kNeg;

        // E, Hd and H0 (H0 replaces H in place; H[c+1] is still last row's)
        int hd[MOVES ? C : 1];
        int pm[C];
        int run_max = kNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int hup = c + 1 < C ? H[c + 1] : h_next;
            const int eup = c + 1 < C ? E[c + 1] : e_next;
            const int e = max(hup + gap_open, eup + gap_ext);
            const int bj = bb[c];
            const int sub = (ai == bj && ai < 4 && bj < 4) ? match : mismatch;
            const int d = H[c] + sub;
            int h0 = max(max(d, e), 0);
            h0 = max(h0, sub > 0 ? sub : 0);
            if (MOVES) hd[MOVES ? c : 0] = d;
            E[c] = e;
            H[c] = h0;
            run_max = max(run_max, h0 - gap_ext * (k0 + c));
            pm[c] = run_max;
        }
        // lazy F: exclusive prefix max over the band of H0 - gap_ext * k
        int scan = run_max;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(kFull, scan, d);
            if (lane >= d) scan = max(scan, y);
        }
        int excl = __shfl_up_sync(kFull, scan, 1);
        if (lane == 0) excl = kNeg;

        const int j0 = i + k0 - W;
        int row_max = kNeg;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int k = k0 + c;
            const int prev = c == 0 ? excl : max(excl, pm[c - 1]);
            const int f = prev + gap_ext * k + gap_open - gap_ext;
            const int j = j0 + c;
            const bool inb = j >= lo && j < hi && k < K;
            const int h = inb ? max(max(H[c], f), 0) : kNeg;
            const int e = inb ? E[c] : kNeg;
            if (MOVES) {
                int code = kStop;
                if (h > 0) {
                    if (h == f) code = kLeft;
                    if (h == e) code = kUp;
                    if (h == hd[MOVES ? c : 0]) code = kDiag;
                }
                word[c] |= (uint32_t)code << (2 * (i & 15));
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
            int32_t* dst = mv + ((int64_t)p * Wd + (i >> 4)) * K;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (k0 + c < K) dst[k0 + c] = (int32_t)word[c];
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

template <bool MOVES>
cudaError_t launch(int cols, const int8_t* a, const int8_t* bwin,
                   const int32_t* alen, const int32_t* jlo,
                   const int32_t* jhi, int32_t* best, int32_t* bi, int32_t* bk,
                   int32_t* mv, int B, int La, int T, int W, int match,
                   int mismatch, int gap_open, int gap_ext,
                   cudaStream_t stream) {
    const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const dim3 block(32 * kWarpsPerBlock);
#define BIOKANGA_SW_CASE(CC)                                                \
    if (cols <= 32 * CC) {                                                  \
        banded_sw_kernel<CC, MOVES><<<grid, block, 0, stream>>>(            \
            a, bwin, alen, jlo, jhi, best, bi, bk, mv, B, La, T, W, match,  \
            mismatch, gap_open, gap_ext);                                   \
        return cudaGetLastError();                                          \
    }
    BIOKANGA_SW_CASE(1)
    BIOKANGA_SW_CASE(2)
    BIOKANGA_SW_CASE(4)
    BIOKANGA_SW_CASE(7)
    BIOKANGA_SW_CASE(8)
    BIOKANGA_SW_CASE(16)
#undef BIOKANGA_SW_CASE
    return cudaErrorInvalidValue;
}

}  // namespace

// a (B, La) int8; bwin (B, T) int8, T >= ceil(La/16)*16 + 2W; alen, jlo,
// jhi (B,) int32; best, bi, bk (B,) int32 out; mv (B, ceil(La/16), 2W+1)
// int32 out, or null for the score-only kernel.  W <= 255.
extern "C" int banded_sw(const void* a, const void* bwin, const void* alen,
                         const void* jlo, const void* jhi, void* best,
                         void* bi, void* bk, void* mv, int B, int La, int T,
                         int W, int match, int mismatch, int gap_open,
                         int gap_ext, void* stream) {
    if (W < 0 || 2 * W + 1 > 512) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const int K = 2 * W + 1;
    auto s = (cudaStream_t)stream;
    auto a8 = (const int8_t*)a;
    auto b8 = (const int8_t*)bwin;
    auto al = (const int32_t*)alen;
    auto lo = (const int32_t*)jlo;
    auto hi = (const int32_t*)jhi;
    auto o0 = (int32_t*)best;
    auto o1 = (int32_t*)bi;
    auto o2 = (int32_t*)bk;
    const cudaError_t err =
        mv ? launch<true>(K, a8, b8, al, lo, hi, o0, o1, o2, (int32_t*)mv, B,
                          La, T, W, match, mismatch, gap_open, gap_ext, s)
           : launch<false>(K, a8, b8, al, lo, hi, o0, o1, o2, nullptr, B, La,
                           T, W, match, mismatch, gap_open, gap_ext, s);
    return (int)err;
}
