// Row-wise bitonic sorts for the aligner: one thread block sorts one read.
//
// Replaces the TPU kernels biokanga_tpu/ops/pallas_sort.py `_sort_kernel`
// (sort_cols, the diagonal dedup sort) and `_sort2_kernel` (sort2_cols,
// the (mm*2|rc, locus) accept sort).  Those sort a (C, B) matrix along C
// with reads in lanes; here the layout is (B, C), one read per row.
//
// Design: a row of C int32 values (or key/value pairs) is loaded into
// dynamic shared memory, padded with INT32_MAX up to P = next power of two,
// sorted in place by a bitonic network of log2(P)*(log2(P)+1)/2 stages,
// each stage one compare-exchange per thread pair and one __syncthreads,
// and the first C values are written back.  Padding sorts last, so the
// result equals a plain ascending sort of the C values.  Compares are
// signed; the two-key version compares (key, val) lexicographically.
//
// Bounds on the H100: each element crosses device memory once in and once
// out, so the kernel is bound by shared-memory compare-exchange latency
// and the barrier per stage, not by HBM.  P*4 bytes (one key) or P*8 bytes
// (two keys) of shared memory cap P at 32,768 and 16,384 (128 KB); the
// wrapper (ops/sort.py) refuses larger rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kMaxThreads = 1024;

__host__ __device__ inline int next_pow2(int c) {
    int p = 2;
    while (p < c) p <<= 1;
    return p;
}

__global__ void sort_rows_kernel(const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, int C, int P) {
    extern __shared__ int32_t s[];
    // 64-bit: a fused paired-end batch has 131,072 rows, and B x C would
    // pass 2^31 at 16,384 values a row (the rescue ladder's wide rows come
    // in dispatches of 512 and 2,048 rows, far below that)
    const int64_t base = (int64_t)blockIdx.x * C;
    for (int i = threadIdx.x; i < P; i += blockDim.x)
        s[i] = i < C ? x[base + i] : kI32Max;
    __syncthreads();
    const int half = P >> 1;
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < half; t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const int32_t a = s[lo], b = s[hi];
                if ((a > b) == up) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < C; i += blockDim.x) out[base + i] = s[i];
}

__global__ void sort2_rows_kernel(const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ val,
                                  int32_t* __restrict__ out_key,
                                  int32_t* __restrict__ out_val, int C,
                                  int P) {
    extern __shared__ int32_t s[];
    int32_t* sk = s;
    int32_t* sv = s + P;
    const int64_t base = (int64_t)blockIdx.x * C;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool in = i < C;
        sk[i] = in ? key[base + i] : kI32Max;
        sv[i] = in ? val[base + i] : kI32Max;
    }
    __syncthreads();
    const int half = P >> 1;
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < half; t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const bool up = (lo & size) == 0;
                const int32_t ka = sk[lo], kb = sk[hi];
                const int32_t va = sv[lo], vb = sv[hi];
                const bool gt = (ka > kb) || (ka == kb && va > vb);
                if (gt == up) {
                    sk[lo] = kb;
                    sk[hi] = ka;
                    sv[lo] = vb;
                    sv[hi] = va;
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
        out_key[base + i] = sk[i];
        out_val[base + i] = sv[i];
    }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

}  // namespace

extern "C" int sort_rows_i32(const void* x, void* out, int B, int C,
                             void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const int P = next_pow2(C);
    const int threads = P / 2 < kMaxThreads ? P / 2 : kMaxThreads;
    const size_t smem = (size_t)P * sizeof(int32_t);
    cudaError_t err = allow_smem(sort_rows_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    sort_rows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)out, C, P);
    return (int)cudaGetLastError();
}

extern "C" int sort2_rows_i32(const void* key, const void* val,
                              void* out_key, void* out_val, int B, int C,
                              void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const int P = next_pow2(C);
    const int threads = P / 2 < kMaxThreads ? P / 2 : kMaxThreads;
    const size_t smem = 2 * (size_t)P * sizeof(int32_t);
    cudaError_t err = allow_smem(sort2_rows_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    sort2_rows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)key, (const int32_t*)val, (int32_t*)out_key,
        (int32_t*)out_val, C, P);
    return (int)cudaGetLastError();
}

extern "C" const char* biokanga_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
