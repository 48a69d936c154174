// Column-aligned traceback decode over packed 2-bit move planes.
//
// Counterpart of biokanga_tpu/ops/sw_trace.py `traceback_cols_packed`.  In
// the JAX package this decode is a lax.scan over 16-row move words, not a
// Pallas kernel; eager PyTorch would spend some twenty launches per row,
// so on the card it is this kernel.  It reads the planes that
// csrc/banded_sw.cu writes: mv[p][i >> 4][k] bit 2*(i & 15) holds the
// code of row i, band column k, shape (B, Wd, K).
//
// One thread per pair walks the path up from the best cell (best_i,
// best_k), one query row at a time, exactly as traceback_cols_packed
// (biokanga_tpu/ops/sw_trace.py:52-94) does:
//   - on the row, the run of LEFT codes from column k down to the last
//     column that is not LEFT ("land") is consumed: columns land+1..k are
//     target bases inserted before the query base, counted in ins_cnt and,
//     by base, in ins_base (an N target base counts as T, base 3);
//   - then DIAG emits the target base at land (N as 4) and keeps column
//     land; UP emits 5 (the query base is deleted) and moves to column
//     land+1; STOP, no non-LEFT column, or leaving the band ends the walk.
// Rows off the path emit 6 and count no insertions.  The insertions
// consumed at row i are recorded at index i+1 of the (La+1)-long planes.
// Outputs: out (B, La) int8, ins_cnt (B, La+1) int32, ins_base
// (B, La+1, 4) int32; every element is written.
//
// Bound on the H100: latency, not bytes or operations.  Each row's move
// word is a load whose address depends on the last step, so a thread is a
// chain of dependent loads; the words stay in L1 while the path runs
// down one column, which DIAG steps mostly do.  The bytes the function
// must move are its outputs, 21 per query base.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr int kThreads = 32;

__global__ void sw_trace_kernel(const int32_t* __restrict__ mv,
                                const int32_t* __restrict__ best_i,
                                const int32_t* __restrict__ best_k,
                                const int8_t* __restrict__ bwin,
                                int8_t* __restrict__ out,
                                int32_t* __restrict__ ins_cnt,
                                int4* __restrict__ ins_base, int B, int La,
                                int Wd, int K, int T) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= B) return;
    const int32_t* m = mv + (int64_t)p * Wd * K;
    const int8_t* bw = bwin + (int64_t)p * T;
    int8_t* o = out + (int64_t)p * La;
    int32_t* ic = ins_cnt + (int64_t)p * (La + 1);
    int4* ib = ins_base + (int64_t)p * (La + 1);
    const int bi = best_i[p];
    int k = best_k[p];
    bool active = false;
    ic[0] = 0;
    ib[0] = make_int4(0, 0, 0, 0);
    for (int i = La - 1; i >= 0; --i) {
        int code_out = 6, cnt = 0;
        int4 cb = make_int4(0, 0, 0, 0);
        if (i == bi && !active) {
            active = true;
            k = best_k[p];
        }
        if (active) {
            const int32_t* row = m + (int64_t)(i >> 4) * K;
            const int sh = 2 * (i & 15);
            int kc = k < 0 ? 0 : (k >= K ? K - 1 : k);
            int land = kc;
            int code = (__ldg(row + land) >> sh) & 3;
            while (code == kLeft) {
                --land;
                code = land >= 0 ? (__ldg(row + land) >> sh) & 3 : kStop;
            }
            cnt = k - land;
            for (int l = land + 1; l <= k; ++l) {
                const int t = bw[i + l];
                const int c4 = t < 4 ? (t < 0 ? 0 : t) : 3;
                cb.x += c4 == 0;
                cb.y += c4 == 1;
                cb.z += c4 == 2;
                cb.w += c4 == 3;
            }
            if (land >= 0 && code == kDiag) {
                const int t = bw[i + land];
                code_out = t < 4 ? t : 4;
                k = land;
            } else if (land >= 0 && code == kUp) {
                code_out = 5;
                k = land + 1;
            } else {
                active = false;
            }
            if (k < 0 || k >= K) active = false;
        }
        o[i] = (int8_t)code_out;
        ic[i + 1] = cnt;
        ib[i + 1] = cb;
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
    sw_trace_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t*)mv, (const int32_t*)best_i, (const int32_t*)best_k,
        (const int8_t*)bwin, (int8_t*)out, (int32_t*)ins_cnt,
        (int4*)ins_base, B, La, Wd, K, T);
    return (int)cudaGetLastError();
}
