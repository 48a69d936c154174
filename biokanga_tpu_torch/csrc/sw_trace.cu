// Column-aligned traceback decode over packed 2-bit move planes.
//
// Counterpart of biokanga_tpu/ops/sw_trace.py `traceback_cols_packed`.  In
// the JAX package this decode is a lax.scan over 16-row move words, not a
// Pallas kernel; eager PyTorch would spend some twenty launches per row,
// so on the card it is this kernel.  It reads the planes that
// csrc/banded_sw.cu writes: mv[p][i >> 4][k] bit 2*(i & 15) holds the
// code of row i, band column k, shape (B, Wd, K).
//
// The walk is traceback_cols_packed's (biokanga_tpu/ops/sw_trace.py:52-94):
// it starts at row best_i, column best_k, and goes up one query row at a
// time.  On a row, the run of LEFT codes from column k down to the last
// column that is not LEFT ("land") is consumed: columns land+1..k are
// target bases inserted before the query base, counted in ins_cnt and, by
// base, in ins_base (an N target base counts as T, base 3).  Then DIAG
// emits the target base at land (N as 4) and keeps column land; UP emits 5
// (the query base is deleted) and moves to column land+1; STOP, no
// non-LEFT column (land = -1, after counting the run 0..k) or leaving the
// band ends the walk.  Rows off the path emit 6 and count no insertions.
// The insertions consumed at row i are recorded at index i+1 of the
// (La+1)-long planes, and index 0 is 0.  Outputs: out (B, La) int8,
// ins_cnt (B, La+1) int32, ins_base (B, La+1, 4) int32; every element is
// written.
//
// Bound on the H100: the instructions and latency of one dependent step
// per row, not the function's bytes (the outputs, 21 per query row, and
// the move words along the path): a row's step needs the last row's
// column, so each warp issues its rows one after another.
// The first design (one thread per pair, 32 threads a block) made
// each step a load whose address depended on the last step, a serial loop
// over LEFT runs and stores 21 bytes apart between threads, on a quarter
// of the SMs.  This one takes one warp per pair, one warp a block (so
// that every branch on the walk is warp-uniform and ~1,000-1,300 pairs
// fill ~8-10 warps on each SM):
//   - the warp holds a 64-column window of one word row of move words in
//     registers (lane l: columns kbase + l and kbase + 32 + l), loaded with
//     two coalesced loads; the 16 rows of the word are then decoded from
//     registers.  While it works through word row w it already loads the
//     window of word row w-1, placed where the column can reach (k rises
//     at most one column a row, by UP);
//   - per row, every lane offers each of its two columns that is not
//     LEFT and lies at or below k as (column << 2 | code), and one
//     __reduce_max_sync returns the landing column with its code: the
//     step is a handful of integer operations and one reduction.  Only a
//     LEFT run that covers the whole window below k (a long insertion,
//     rare) loads the window 64 columns to the left;
//   - rows are staged 32 at a time, lane r holding row i0 + r's land,
//     insertion count and code; then each lane reads its own target bases
//     (the base at land, the inserted bases) and the warp stores 32 B of
//     out, 128 B of ins_cnt and 512 B of ins_base, each contiguous.
//   Rows above best_i and below the end of the walk are stored as 6 / 0 /
//   0 without a walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;

struct Window {
    uint32_t lo, hi;       // words of columns kbase + lane, kbase + 32 + lane
    int kbase;
};

// Columns outside [0, K) read as all LEFT, so that no walk lands there.
__device__ __forceinline__ Window load_window(const int32_t* row, int kbase,
                                              int K, int lane) {
    const int c0 = kbase + lane, c1 = c0 + 32;
    Window w;
    w.kbase = kbase;
    w.lo = c0 >= 0 && c0 < K ? (uint32_t)__ldg(row + c0) : 0xffffffffu;
    w.hi = c1 >= 0 && c1 < K ? (uint32_t)__ldg(row + c1) : 0xffffffffu;
    return w;
}

// Where a walk standing at column k lands on row shift sh of the window:
// (land << 2 | its code) for the highest column land <= k whose code is
// not LEFT, or -1 if the window has none.  One reduction over the warp.
__device__ __forceinline__ int landing(const Window& w, int sh, int k,
                                       int lane) {
    const int c0 = w.kbase + lane, c1 = c0 + 32;
    const int code0 = (int)((w.lo >> sh) & 3u);
    const int code1 = (int)((w.hi >> sh) & 3u);
    const int v0 = code0 != kLeft && c0 <= k ? c0 << 2 | code0 : -1;
    const int v1 = code1 != kLeft && c1 <= k ? c1 << 2 | code1 : -1;
    return __reduce_max_sync(kFull, max(v0, v1));
}

__global__ void __launch_bounds__(32)
sw_trace_kernel(const int32_t* __restrict__ mv,
                const int32_t* __restrict__ best_i,
                const int32_t* __restrict__ best_k,
                const int8_t* __restrict__ bwin, int8_t* __restrict__ out,
                int32_t* __restrict__ ins_cnt, int4* __restrict__ ins_base,
                int B, int La, int Wd, int K, int T) {
    const int p = blockIdx.x;                 // one warp a block: p, the
    const int lane = threadIdx.x;             // walk and every branch on it
                                              // are warp-uniform
    const int32_t* m = mv + (int64_t)p * Wd * K;
    const int8_t* bw = bwin + (int64_t)p * T;
    int8_t* o = out + (int64_t)p * La;
    int32_t* ic = ins_cnt + (int64_t)p * (La + 1);
    int4* ib = ins_base + (int64_t)p * (La + 1);
    const int bi = best_i[p];
    const int bk = best_k[p];
    if (lane == 0) {
        ic[0] = 0;
        ib[0] = make_int4(0, 0, 0, 0);
    }
    // walk state, warp-uniform
    bool pending = bi >= 0 && bi < La, active = false;
    int k = bk < 0 ? 0 : (bk >= K ? K - 1 : bk);   // the column searched
    int kin = bk < K ? bk : K - 1;                 // the top inserted column
    Window win{0u, 0u, 0}, pf{0u, 0u, 0};
    int w_cur = -1, w_pf = -1;

    for (int i0 = ((La - 1) >> 5) << 5; i0 >= 0; i0 -= 32) {
        int st_code = kStop, st_land = 0, st_cnt = 0;
        int i_top = i0 + 31;
        if (pending && bi >= i0 && bi <= i_top) {
            pending = false;
            active = true;
            i_top = bi;
        }
        for (int i = i_top; active && i >= i0; --i) {
            const int w = i >> 4;
            if (w != w_cur) {
                if (w == w_pf && k >= pf.kbase && k <= pf.kbase + 63) {
                    win = pf;
                } else {                      // k may rise 16 in this word
                    win = load_window(m + (int64_t)w * K, max(k - 47, 0), K,
                                      lane);
                }
                w_cur = w;
                if (w > 0) {                  // and 16 more in the next one
                    pf = load_window(m + (int64_t)(w - 1) * K,
                                     max(k - 31, 0), K, lane);
                    w_pf = w - 1;
                }
            } else if (k > win.kbase + 63) {  // UP past the window's top
                win = load_window(m + (int64_t)w * K, k - 47, K, lane);
            }
            const int sh = 2 * (i & 15);
            int v = landing(win, sh, k, lane);
            while (v < 0 && win.kbase > 0) {  // a LEFT run past the window
                win = load_window(m + (int64_t)w * K, win.kbase - 64, K,
                                  lane);
                v = landing(win, sh, k, lane);
            }
            const int land = v < 0 ? -1 : v >> 2;
            const int code = v < 0 ? kStop : v & 3;     // never LEFT
            if (lane == i - i0) {
                st_code = code;
                st_land = land;
                st_cnt = max(kin - land, 0);
            }
            k = land + (code == kUp);
            active = code != kStop && k < K;
            kin = k;
        }
        // lane r writes row i0 + r
        const int row = i0 + lane;
        if (row < La) {
            int code_out = 6;
            int4 cb = make_int4(0, 0, 0, 0);
            if (st_code == kDiag) {
                const int t = bw[row + st_land];
                code_out = t < 4 ? t : 4;
            } else if (st_code == kUp) {
                code_out = 5;
            }
            for (int l = st_land + 1; l <= st_land + st_cnt; ++l) {
                const int t = bw[row + l];
                const int c4 = t < 4 ? (t < 0 ? 0 : t) : 3;
                cb.x += c4 == 0;
                cb.y += c4 == 1;
                cb.z += c4 == 2;
                cb.w += c4 == 3;
            }
            o[row] = (int8_t)code_out;
            ic[row + 1] = st_cnt;
            ib[row + 1] = cb;
        }
    }
}

}  // namespace

// mv (B, Wd, K) int32; best_i, best_k (B,) int32; bwin (B, T) int8 with
// T >= La + K - 1; out (B, La) int8, ins_cnt (B, La+1) int32 and
// ins_base (B, La+1, 4) int32 are written in full.
extern "C" int sw_trace_packed(const void* mv, const void* best_i,
                               const void* best_k, const void* bwin,
                               void* out, void* ins_cnt, void* ins_base,
                               int B, int La, int Wd, int K, int T,
                               void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    sw_trace_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)mv, (const int32_t*)best_i, (const int32_t*)best_k,
        (const int8_t*)bwin, (int8_t*)out, (int32_t*)ins_cnt,
        (int4*)ins_base, B, La, Wd, K, T);
    return (int)cudaGetLastError();
}
