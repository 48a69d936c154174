// Row-wise sorts for the aligner: one warp sorts one read's row in
// registers.
//
// Replaces the TPU kernels biokanga_tpu/ops/pallas_sort.py `_sort_kernel`
// (sort_cols, the diagonal dedup sort) and `_sort2_kernel` (sort2_cols,
// the (mm*2|rc, locus) accept sort).  Those sort a (C, B) matrix along C
// with reads in lanes; here the layout is (B, C), one read per row.
//
// Network: a bitonic sort of P = next power of two >= C positions, the
// rest padded with the largest value, in its form without directions:
// merging two sorted runs of size/2 compares position i with
// i ^ (size - 1), then with i ^ stride for stride = size/4 .. 1, the lower
// position keeping the smaller value.  Padding sorts last, so the first C
// outputs equal a plain ascending sort.  Pairs sort as one 64-bit key,
// (key ^ 2^31) << 32 | (val ^ 2^31), whose unsigned order is the signed
// lexicographic (key, val) order; the pad (INT32_MAX, INT32_MAX) packs to
// the largest key.
//
// Rows up to 1,024 values (512 pairs): one warp a row.  Lane l holds the
// V = P/32 consecutive positions l*V .. l*V+V-1 in registers, loaded and
// stored 16 bytes at a time where the row allows.  Strides below V are
// compare-exchanges between registers of one lane (min/max at register
// indices fixed at compile time, V a template parameter); strides >= V
// take one __shfl_xor_sync a register to lane l ^ (stride/V), each lane
// keeping the min or the max by whether it is the lower partner.  At
// P = 512 (the dedup row of 480) 30 of the 45 stages need no shuffle, and
// nothing waits at a barrier.  One warp a block, so that the compiler sees
// the row and every branch but its ragged end as the same in all lanes and
// wraps no shuffle in convergence code; one wave of blocks walks the rows.
//
// Wider rows (up to 32,768 values, 16,384 pairs): one block a row.  Each
// warp sorts chunks of 32*V positions (1,024 values, 512 pairs) in
// registers as above; each merge above the chunk size then runs its
// strides >= the chunk through shared memory, one barrier a stage, and
// its strides below the chunk in registers again.  Shared memory holds the
// row with one pad slot every V, so that the 32 lanes' runs of V start in
// different banks.
//
// Bounds on the H100: each value crosses device memory once in and once
// out (65,536 rows of 480 int32: 0.075 ms at 3.35 TB/s).  The network
// does P/2 * log2 P * (log2 P + 1) / 2 compare-exchanges a row (11,520 at
// P = 512), each a min and a max in one lane or a shuffle and a min or max
// in two: 960 integer min/max a lane and row at P = 512, issued at half
// the rate of other instructions, so the integer pipe sets the time, not
// HBM.  A pair's compare-exchange is two compares and four selects.
// Packing a row's INT32_MAX out before sorting (the dedup rows of the
// align cells are ~90% INT32_MAX) was measured and not kept: it cost rows
// that are mostly other values ~1% (PERF.md, the sorts' designs tried).
// The shared-memory row (P plus P/V slots) caps the block path at 32,768
// values and 16,384 pairs.
//
// Rows past 32,768 values (the rescue ladder's dedup rows of reads past
// 400 bp: up to 369 cores x 1,024 positions at 4,096 bp) take the same
// network over a scratch row of P = 2^ceil(log2 C) positions in device
// memory that the wrapper allocates: the block path sorts each chunk of
// 32,768 positions, reading the row padded with INT32_MAX, into the
// scratch row; each merge above the chunk then runs its strides >= the
// chunk in passes over device memory (a thread holds one column and its
// mirror of each of up to 64 chunks in registers: a merge of up to 64
// chunks in one pass, a wider one in one pass per 6 of its strides, the
// first with the merge's mirror stage) and finishes its strides below the
// chunk in shared memory and registers, one block a chunk, as the block
// path does; the last merge writes the first C positions out.  A row of
// P = 2^19 takes 1 + 4 + 4 launches, each a pass over the scratch rows:
// the passes' bytes bound it.  Any P whose scratch rows fit in device
// memory sorts; positions are 64-bit.
//
// Pair rows past 16,384 (the sharded multi-hit union's K x n_sp pairs:
// 33 sp ranks at -R 500) take the same path with each pair packed into
// one 64-bit word in scratch, as the block path packs it: chunks of
// 16,384 pairs (the pair block path's reach), 16 a lane, and a level
// pass holding at most 32 chunks' columns a thread.  The levels and the
// tail are templated on the element type, so both sorts run one network.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using u64 = unsigned long long;

constexpr int32_t kI32Max = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;
constexpr int kBlockMaxWarps = 16;     // wide path: warps of a row's block

__host__ __device__ constexpr int log2i(int p) {
    return p <= 1 ? 0 : 1 + log2i(p >> 1);
}

int next_pow2(int c) {
    int p = 1;
    while (p < c) p <<= 1;
    return p;
}

// compare-exchange: a takes the smaller, b the larger
__device__ __forceinline__ void cx(int32_t& a, int32_t& b) {
    const int32_t lo = min(a, b);
    b = max(a, b);
    a = lo;
}
__device__ __forceinline__ void cx(u64& a, u64& b) {
    const bool s = b < a;
    const u64 lo = s ? b : a;
    b = s ? a : b;
    a = lo;
}

// what a lane keeps of (own v, partner's w): the lower partner the
// smaller, the upper partner the larger
__device__ __forceinline__ int32_t keep(int32_t v, int32_t w, bool lower) {
    return lower ? min(v, w) : max(v, w);
}
__device__ __forceinline__ u64 keep(u64 v, u64 w, bool lower) {
    return (w < v) == lower ? w : v;
}

// The first stage of the merge of two sorted runs of size/2: position i
// against i ^ (size - 1).  Position i = lane * V + r.
template <typename T, int V>
__device__ __forceinline__ void flip(T (&x)[V], int size, int lane) {
    if (size <= V) {
#pragma unroll
        for (int r = 0; r < V; ++r)
            if (!(r & (size >> 1))) cx(x[r], x[r ^ (size - 1)]);
    } else {
        // the partner lane is lane ^ (size/V - 1), its register V-1-r
        const int m = size / V - 1;
        const bool lower = !(lane & (size / V >> 1));
        if constexpr (V == 1) {
            x[0] = keep(x[0], __shfl_xor_sync(kFull, x[0], m), lower);
        } else {
#pragma unroll
            for (int r = 0; r < V / 2; ++r) {
                const T a = __shfl_xor_sync(kFull, x[V - 1 - r], m);
                const T b = __shfl_xor_sync(kFull, x[r], m);
                x[r] = keep(x[r], a, lower);
                x[V - 1 - r] = keep(x[V - 1 - r], b, lower);
            }
        }
    }
}

// A later stage of a merge: position i against i ^ s.
template <typename T, int V>
__device__ __forceinline__ void half_clean(T (&x)[V], int s, int lane) {
    if (s < V) {
#pragma unroll
        for (int r = 0; r < V; ++r)
            if (!(r & s)) cx(x[r], x[r | s]);
    } else {
        const int m = s / V;
        const bool lower = !(lane & m);
#pragma unroll
        for (int r = 0; r < V; ++r)
            x[r] = keep(x[r], __shfl_xor_sync(kFull, x[r], m), lower);
    }
}

// Sort the warp's 32 * V positions ascending.
template <typename T, int V>
__device__ __forceinline__ void warp_sort(T (&x)[V], int lane) {
    constexpr int kLog = log2i(32 * V);
#pragma unroll
    for (int k = 1; k <= kLog; ++k) {
        flip(x, 1 << k, lane);
#pragma unroll
        for (int j = k - 2; j >= 0; --j) half_clean(x, 1 << j, lane);
    }
}

// The strides below 32 * V of a merge whose larger strides are done.
template <typename T, int V>
__device__ __forceinline__ void warp_merge(T (&x)[V], int lane) {
    constexpr int kLog = log2i(32 * V);
#pragma unroll
    for (int j = kLog - 1; j >= 0; --j) half_clean(x, 1 << j, lane);
}

// Device-memory access of the one-key sort.
struct OneKey {
    using T = int32_t;
    static constexpr T kPad = kI32Max;
    const int32_t* __restrict__ x;
    int32_t* __restrict__ out;

    __device__ T load(int64_t i) const { return __ldg(x + i); }
    __device__ void store(int64_t i, T v) const { out[i] = v; }
    __device__ void load4(int64_t i, T& a, T& b, T& c, T& d) const {
        const int4 q = __ldg(reinterpret_cast<const int4*>(x + i));
        a = q.x;
        b = q.y;
        c = q.z;
        d = q.w;
    }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        *reinterpret_cast<int4*>(out + i) = make_int4(a, b, c, d);
    }
};

__device__ __forceinline__ u64 pack(int32_t k, int32_t v) {
    return (u64)((uint32_t)k ^ kSign) << 32 | ((uint32_t)v ^ kSign);
}
__device__ __forceinline__ int32_t key_of(u64 p) {
    return (int32_t)((uint32_t)(p >> 32) ^ kSign);
}
__device__ __forceinline__ int32_t val_of(u64 p) {
    return (int32_t)((uint32_t)p ^ kSign);
}

// Device-memory access of the two-key sort: (key, val) as one 64-bit key.
struct TwoKey {
    using T = u64;
    static constexpr T kPad = ~0ull;    // pack(INT32_MAX, INT32_MAX)
    const int32_t* __restrict__ key;
    const int32_t* __restrict__ val;
    int32_t* __restrict__ out_key;
    int32_t* __restrict__ out_val;

    __device__ T load(int64_t i) const {
        return pack(__ldg(key + i), __ldg(val + i));
    }
    __device__ void store(int64_t i, T v) const {
        out_key[i] = key_of(v);
        out_val[i] = val_of(v);
    }
    __device__ void load4(int64_t i, T& a, T& b, T& c, T& d) const {
        const int4 k = __ldg(reinterpret_cast<const int4*>(key + i));
        const int4 v = __ldg(reinterpret_cast<const int4*>(val + i));
        a = pack(k.x, v.x);
        b = pack(k.y, v.y);
        c = pack(k.z, v.z);
        d = pack(k.w, v.w);
    }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        *reinterpret_cast<int4*>(out_key + i) =
            make_int4(key_of(a), key_of(b), key_of(c), key_of(d));
        *reinterpret_cast<int4*>(out_val + i) =
            make_int4(val_of(a), val_of(b), val_of(c), val_of(d));
    }
};

// Positions first .. first+V-1 of the row at `base`, padded past C.
// `vec`: C % 4 == 0 and every pointer 16-byte aligned, so a run of 4 is
// wholly inside the row or wholly past it.
template <class Rows, int V>
__device__ __forceinline__ void load_run(const Rows& rows,
                                         typename Rows::T (&x)[V],
                                         int64_t base, int first, int C,
                                         bool vec) {
    if constexpr (V % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < V; q += 4) {
                if (first + q < C) {
                    rows.load4(base + first + q, x[q], x[q + 1], x[q + 2],
                               x[q + 3]);
                } else {
                    x[q] = x[q + 1] = x[q + 2] = x[q + 3] = Rows::kPad;
                }
            }
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < V; ++r)
        x[r] = first + r < C ? rows.load(base + first + r) : Rows::kPad;
}

template <class Rows, int V>
__device__ __forceinline__ void store_run(const Rows& rows,
                                          const typename Rows::T (&x)[V],
                                          int64_t base, int first, int C,
                                          bool vec) {
    if constexpr (V % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < V; q += 4)
                if (first + q < C)
                    rows.store4(base + first + q, x[q], x[q + 1], x[q + 2],
                                x[q + 3]);
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < V; ++r)
        if (first + r < C) rows.store(base + first + r, x[r]);
}

// Rows of up to 32 * V positions: one warp a row, grid-stride.
template <class Rows, int V>
__global__ void __launch_bounds__(32)
    sort_rows_warp(Rows rows, int B, int C, bool vec) {
    // one warp a block: the row, the loop bounds and every branch but the
    // row's ragged end are the same in all lanes, and the compiler sees it
    const int lane = threadIdx.x;
    for (int row = blockIdx.x; row < B; row += gridDim.x) {
        // 64-bit: a fused paired-end batch has 131,072 rows, and B x C
        // would pass 2^31 at 16,384 values a row
        const int64_t base = (int64_t)row * C;
        typename Rows::T x[V];
        load_run(rows, x, base, lane * V, C, vec);
        warp_sort(x, lane);
        store_run(rows, x, base, lane * V, C, vec);
    }
}

// Rows of P > 32 * V positions: one block a row, P / (32 * V) chunks
// shared by up to kBlockMaxWarps warps.
template <class Rows, int V>
__global__ void __launch_bounds__(kBlockMaxWarps * 32)
    sort_rows_block(Rows rows, int C, int P, bool vec) {
    using T = typename Rows::T;
    constexpr int kChunk = 32 * V;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int lane = threadIdx.x & 31;
    // the warp's index, as the compiler can see, is the same in all lanes
    const int warp = __shfl_sync(kFull, (int)threadIdx.x, 0) >> 5;
    const int warps = blockDim.x >> 5;
    const int chunks = P / kChunk;
    const int64_t base = (int64_t)blockIdx.x * C;
    T x[V];

    for (int c = warp; c < chunks; c += warps) {
        const int first = c * kChunk + lane * V;
        load_run(rows, x, base, first, C, vec);
        warp_sort(x, lane);
#pragma unroll
        for (int r = 0; r < V; ++r) s[first + first / V + r] = x[r];
    }
    __syncthreads();
    for (int size = 2 * kChunk; size <= P; size <<= 1) {
        const int half = size >> 1;
        for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
            const int lo = 2 * t - (t & (half - 1));
            const int hi = lo ^ (size - 1);
            cx(s[lo + lo / V], s[hi + hi / V]);
        }
        __syncthreads();
        for (int st = size >> 2; st >= kChunk; st >>= 1) {
            for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
                const int lo = 2 * t - (t & (st - 1));
                const int hi = lo + st;
                cx(s[lo + lo / V], s[hi + hi / V]);
            }
            __syncthreads();
        }
        // a lane reads and writes only its own run: no barrier inside
        for (int c = warp; c < chunks; c += warps) {
            const int first = c * kChunk + lane * V;
#pragma unroll
            for (int r = 0; r < V; ++r) x[r] = s[first + first / V + r];
            warp_merge(x, lane);
            if (size == P) {
                store_run(rows, x, base, first, C, vec);
            } else {
#pragma unroll
                for (int r = 0; r < V; ++r) s[first + first / V + r] = x[r];
            }
        }
        __syncthreads();
    }
}

constexpr int kMaxDevices = 64;

template <class Rows, int V>
cudaError_t launch_warp(const Rows& rows, int B, int C, bool vec,
                        cudaStream_t stream) {
    const auto kernel = sort_rows_warp<Rows, V>;
    // one wave of the kernel's one-warp blocks on each card, asked of the
    // runtime on the first launch there and kept
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
                &per_sm, kernel, 32, 0);
        if (err != cudaSuccess) return err;
        wave = sms * per_sm > 0 ? sms * per_sm : 1;
        waves[dev].store(wave, std::memory_order_relaxed);
    }
    const int grid = B < wave ? B : wave;
    kernel<<<grid, 32, 0, stream>>>(rows, B, C, vec);
    return cudaGetLastError();
}

// Past 48 KB a kernel takes dynamic shared memory only once allowed to.
cudaError_t smem_attr(const void* kernel, size_t smem) {
    return smem > 48 * 1024
               ? cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)smem)
               : cudaSuccess;
}

template <class Rows, int V>
cudaError_t launch_block(const Rows& rows, int B, int C, int P, bool vec,
                         cudaStream_t stream) {
    const int chunks = P / (32 * V);
    const int warps = chunks < kBlockMaxWarps ? chunks : kBlockMaxWarps;
    const size_t smem = (size_t)(P + P / V) * sizeof(typename Rows::T);
    const cudaError_t err =
        smem_attr((const void*)sort_rows_block<Rows, V>, smem);
    if (err != cudaSuccess) return err;
    sort_rows_block<Rows, V><<<B, warps * 32, smem, stream>>>(rows, C, P,
                                                              vec);
    return cudaGetLastError();
}

// The warp kernel with the least V that holds C, or the block kernel
// past 32 * VMax positions.
template <class Rows, int V, int VMax>
cudaError_t launch_fit(const Rows& rows, int B, int C, bool vec,
                       cudaStream_t stream) {
    if constexpr (V < VMax) {
        if (C > 32 * V)
            return launch_fit<Rows, 2 * V, VMax>(rows, B, C, vec, stream);
    } else {
        if (C > 32 * V)
            return launch_block<Rows, V>(rows, B, C, next_pow2(C), vec,
                                         stream);
    }
    return launch_warp<Rows, V>(rows, B, C, vec, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---- rows past the block path: a scratch row of P positions ----------

// What the wide path does for each element type: positions a block sorts
// or merges (the block path's reach), values a lane, and the largest
// group of spans one level pass holds in registers (2^kMaxLogG spans, a
// column and its mirror of each: 2 x 64 int32 or 2 x 32 uint64 a thread).
template <typename T>
struct Wide;
template <>
struct Wide<int32_t> {
    static constexpr int kChunk = 32 * 1024, kV = 32, kMaxLogG = 6;
};
template <>
struct Wide<u64> {
    static constexpr int kChunk = 16 * 1024, kV = 16, kMaxLogG = 5;
};

// Positions i .. i+3 of scratch rows as 16-byte stores.
__device__ __forceinline__ void store4_at(int32_t* s, int64_t i, int32_t a,
                                          int32_t b, int32_t c, int32_t d) {
    *reinterpret_cast<int4*>(s + i) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void store4_at(u64* s, int64_t i, u64 a, u64 b,
                                          u64 c, u64 d) {
    *reinterpret_cast<ulonglong2*>(s + i) = make_ulonglong2(a, b);
    *reinterpret_cast<ulonglong2*>(s + i + 2) = make_ulonglong2(c, d);
}

// Column of flat position i of rows of P = 2^log_p positions.
__device__ __forceinline__ int64_t col_of(int64_t i, int log_p) {
    return i & ((int64_t(1) << log_p) - 1);
}

// Reads a (B, C) row as the first C of P = 2^log_p positions, the rest
// INT32_MAX; writes positions to the (B, P) scratch rows.  With vec, C is
// a multiple of 4 and x is 16-byte aligned, so a run of 4 positions is
// wholly inside the row or wholly past it.
struct PaddedIn {
    using T = int32_t;
    static constexpr T kPad = kI32Max;
    const int32_t* __restrict__ x;
    int32_t* __restrict__ s;
    int64_t C;
    int log_p;

    __device__ T load(int64_t i) const {
        const int64_t col = col_of(i, log_p);
        return col < C ? __ldg(x + (i >> log_p) * C + col) : kPad;
    }
    __device__ void load4(int64_t i, T& a, T& b, T& c, T& d) const {
        const int64_t col = col_of(i, log_p);
        if (col < C) {
            const int4 q = __ldg(
                reinterpret_cast<const int4*>(x + (i >> log_p) * C + col));
            a = q.x;
            b = q.y;
            c = q.z;
            d = q.w;
        } else {
            a = b = c = d = kPad;
        }
    }
    __device__ void store(int64_t i, T v) const { s[i] = v; }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        store4_at(s, i, a, b, c, d);
    }
};

// The same for (key, val) rows, each pair packed as the block path packs
// it; the pad (INT32_MAX, INT32_MAX) packs to the largest key.
struct PaddedIn2 {
    using T = u64;
    static constexpr T kPad = ~0ull;
    const int32_t* __restrict__ key;
    const int32_t* __restrict__ val;
    u64* __restrict__ s;
    int64_t C;
    int log_p;

    __device__ T load(int64_t i) const {
        const int64_t col = col_of(i, log_p);
        const int64_t at = (i >> log_p) * C + col;
        return col < C ? pack(__ldg(key + at), __ldg(val + at)) : kPad;
    }
    __device__ void load4(int64_t i, T& a, T& b, T& c, T& d) const {
        const int64_t col = col_of(i, log_p);
        if (col < C) {
            const int64_t at = (i >> log_p) * C + col;
            const int4 k = __ldg(reinterpret_cast<const int4*>(key + at));
            const int4 v = __ldg(reinterpret_cast<const int4*>(val + at));
            a = pack(k.x, v.x);
            b = pack(k.y, v.y);
            c = pack(k.z, v.z);
            d = pack(k.w, v.w);
        } else {
            a = b = c = d = kPad;
        }
    }
    __device__ void store(int64_t i, T v) const { s[i] = v; }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        store4_at(s, i, a, b, c, d);
    }
};

// Writes the first C of each row's P positions to the (B, C) output.
struct PaddedOut {
    using T = int32_t;
    int32_t* __restrict__ out;
    int64_t C;
    int log_p;

    __device__ void store(int64_t i, T v) const {
        const int64_t col = col_of(i, log_p);
        if (col < C) out[(i >> log_p) * C + col] = v;
    }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        const int64_t col = col_of(i, log_p);
        if (col < C)
            *reinterpret_cast<int4*>(out + (i >> log_p) * C + col) =
                make_int4(a, b, c, d);
    }
};

// The same for pairs: keys and values to their two (B, C) outputs.
struct PaddedOut2 {
    using T = u64;
    int32_t* __restrict__ out_key;
    int32_t* __restrict__ out_val;
    int64_t C;
    int log_p;

    __device__ void store(int64_t i, T v) const {
        const int64_t col = col_of(i, log_p);
        if (col < C) {
            const int64_t at = (i >> log_p) * C + col;
            out_key[at] = key_of(v);
            out_val[at] = val_of(v);
        }
    }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        const int64_t col = col_of(i, log_p);
        if (col < C) {
            const int64_t at = (i >> log_p) * C + col;
            *reinterpret_cast<int4*>(out_key + at) =
                make_int4(key_of(a), key_of(b), key_of(c), key_of(d));
            *reinterpret_cast<int4*>(out_val + at) =
                make_int4(val_of(a), val_of(b), val_of(c), val_of(d));
        }
    }
};

// Writes positions back to the scratch rows (where the tail read them).
template <typename E>
struct ScratchOut {
    using T = E;
    T* s;

    __device__ void store(int64_t i, T v) const { s[i] = v; }
    __device__ void store4(int64_t i, T a, T b, T c, T d) const {
        store4_at(s, i, a, b, c, d);
    }
};

// Stages of a merge at strides >= D = 2^log_d (a multiple of the chunk)
// in one pass over the scratch rows (their B * P positions as one array:
// every merge lies inside a row), over groups of G * D positions.  Thread
// t takes, in one group, column c < D / 2 and its mirror D - 1 - c of the
// group's G spans of D: x[j] at span j, column c, y[j] at span j, column
// D - 1 - c.  With FLIP the group is a whole merge and its first stage
// pairs position i with i ^ (G D - 1), that is x[j] with y[G-1-j], the
// lower position keeping the smaller value; each later stage at stride
// s * D pairs x[j] with x[j + s] and y[j] with y[j + s], down to s = 1.
// Neighbouring threads take neighbouring columns, so the loads and stores
// of a warp are contiguous.
template <typename T, int G, bool FLIP>
__global__ void __launch_bounds__(256)
    sort_wide_level(T* __restrict__ s, int64_t threads, int log_d) {
    const int64_t D = int64_t(1) << log_d, half = D >> 1;
    for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         t < threads; t += (int64_t)gridDim.x * blockDim.x) {
        const int64_t c = t & (half - 1);
        T* base = s + ((t >> (log_d - 1)) << log_d) * G;
        T x[G], y[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            x[j] = base[j * D + c];
            y[j] = base[j * D + D - 1 - c];
        }
        if constexpr (FLIP) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
                if (j < G / 2)
                    cx(x[j], y[G - 1 - j]);
                else
                    cx(y[G - 1 - j], x[j]);
            }
        }
#pragma unroll
        for (int st = FLIP ? G / 4 : G / 2; st >= 1; st >>= 1) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
                if (!(j & st)) {
                    cx(x[j], x[j | st]);
                    cx(y[j], y[j | st]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
            base[j * D + c] = x[j];
            base[j * D + D - 1 - c] = y[j];
        }
    }
}

template <typename T, bool FLIP>
cudaError_t launch_level(T* s, int G, int64_t threads, int log_d,
                         unsigned grid, cudaStream_t st) {
    void (*kernel)(T*, int64_t, int);
    switch (G) {
        case 2: kernel = sort_wide_level<T, 2, FLIP>; break;
        case 4: kernel = sort_wide_level<T, 4, FLIP>; break;
        case 8: kernel = sort_wide_level<T, 8, FLIP>; break;
        case 16: kernel = sort_wide_level<T, 16, FLIP>; break;
        case 32: kernel = sort_wide_level<T, 32, FLIP>; break;
        case 64:
            if constexpr (Wide<T>::kMaxLogG >= 6) {
                kernel = sort_wide_level<T, 64, FLIP>;
                break;
            } else {
                return cudaErrorInvalidValue;
            }
        default: return cudaErrorInvalidValue;
    }
    kernel<<<grid, 256, 0, st>>>(s, threads, log_d);
    return cudaGetLastError();
}

// The strides below the chunk of a merge whose larger strides are done:
// one block a chunk of the scratch rows, strides >= 32 V through shared
// memory (one pad slot every V), the rest in registers, then the chunk to
// `dst` (back to scratch, or the output after the last merge; `vec` as
// for the block path).  A block reads all of its chunk before it writes.
// `src` is read with plain loads, not the read-only path: below the last
// merge `dst` writes the same scratch rows in this kernel.
template <class Dst>
__global__ void __launch_bounds__(kBlockMaxWarps * 32)
    sort_wide_tail(const typename Dst::T* src, Dst dst, bool vec) {
    using T = typename Dst::T;
    constexpr int V = Wide<T>::kV, kChunk = 32 * V, P = Wide<T>::kChunk;
    constexpr int kPer16 = 16 / sizeof(T);    // values in 16 bytes
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s = reinterpret_cast<T*>(smem_raw);
    const int lane = threadIdx.x & 31;
    const int warp = __shfl_sync(kFull, (int)threadIdx.x, 0) >> 5;
    const int warps = blockDim.x >> 5;
    const int64_t base = (int64_t)blockIdx.x * P;
    T x[V];

    for (int c = warp; c < P / kChunk; c += warps) {
        const int first = c * kChunk + lane * V;
#pragma unroll
        for (int q = 0; q < V; q += kPer16) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(src + base + first + q);
            const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
            for (int k = 0; k < kPer16; ++k) s[first + first / V + q + k] = e[k];
        }
    }
    __syncthreads();
    for (int st = P >> 1; st >= kChunk; st >>= 1) {
        for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
            const int lo = 2 * t - (t & (st - 1));
            const int hi = lo + st;
            cx(s[lo + lo / V], s[hi + hi / V]);
        }
        __syncthreads();
    }
    for (int c = warp; c < P / kChunk; c += warps) {
        const int first = c * kChunk + lane * V;
#pragma unroll
        for (int r = 0; r < V; ++r) x[r] = s[first + first / V + r];
        warp_merge(x, lane);
        store_run(dst, x, base, first, P, vec);
    }
}

template <class Dst>
cudaError_t launch_tail(const typename Dst::T* src, const Dst& dst,
                        int64_t chunks, bool vec, cudaStream_t stream) {
    using T = typename Dst::T;
    const size_t smem =
        (size_t)(Wide<T>::kChunk + Wide<T>::kChunk / Wide<T>::kV) *
        sizeof(T);
    const cudaError_t err =
        smem_attr((const void*)sort_wide_tail<Dst>, smem);
    if (err != cudaSuccess) return err;
    sort_wide_tail<Dst><<<(unsigned)chunks, kBlockMaxWarps * 32, smem,
                          stream>>>(src, dst, vec);
    return cudaGetLastError();
}

// The whole wide sort of B rows of P = 2^log_p positions in scratch `s`:
// `in` reads the rows, padded, into s; `out` writes the first C of each.
template <class In, class Out>
cudaError_t sort_wide(const In& in, const Out& out, typename In::T* s,
                      int B, int log_p, bool vec, cudaStream_t st) {
    using T = typename In::T;
    constexpr int kChunk = Wide<T>::kChunk;
    constexpr int kLogChunk = log2i(kChunk);
    const int64_t P = int64_t(1) << log_p;
    const int64_t chunks = (int64_t)B * (P / kChunk);
    // each chunk of each padded row sorted into scratch by the block path
    cudaError_t err = launch_block<In, Wide<T>::kV>(in, (int)chunks, kChunk,
                                                    kChunk, vec, st);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    for (int log_m = 1; kLogChunk + log_m <= log_p; ++log_m) {
        // a merge of 2^log_m chunks: its strides >= the chunk in passes of
        // at most 2^kMaxLogG chunks' columns a thread, the first with the
        // mirror stage, then the strides below the chunk in the tail
        for (int span = log_m; span > 0;) {
            const int g =
                span < Wide<T>::kMaxLogG ? span : Wide<T>::kMaxLogG;
            span -= g;
            const int64_t n = (int64_t)B * P >> (g + 1);
            const int64_t want = (n + 255) / 256;
            const unsigned grid =
                (unsigned)(want < 16 * sms ? want : 16 * sms);
            err = span + g == log_m
                      ? launch_level<T, true>(s, 1 << g, n,
                                              kLogChunk + span, grid, st)
                      : launch_level<T, false>(s, 1 << g, n,
                                               kLogChunk + span, grid, st);
            if (err != cudaSuccess) return err;
        }
        err = kLogChunk + log_m == log_p
                  ? launch_tail(s, out, chunks, vec, st)
                  : launch_tail(s, ScratchOut<T>{s}, chunks, true, st);
        if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
}

// log2 of P if P is a power of two of at least C past `chunk`, else -1.
int wide_log_p(int C, long long P, int chunk) {
    int log_p = 0;
    while ((int64_t(1) << log_p) < P) ++log_p;
    if (C <= chunk || P != int64_t(1) << log_p || P < C) return -1;
    return log_p;
}

}  // namespace

extern "C" int sort_rows_i32(const void* x, void* out, int B, int C,
                             void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const OneKey rows{(const int32_t*)x, (int32_t*)out};
    const bool vec = C % 4 == 0 && aligned16(x) && aligned16(out);
    return (int)launch_fit<OneKey, 1, 32>(rows, B, C, vec,
                                          (cudaStream_t)stream);
}

// Rows of C > 32,768 values: scratch holds B rows of P = 2^ceil(log2 C)
// int32, 16-byte aligned (the wrapper's torch.empty).
extern "C" int sort_rows_wide_i32(const void* x, void* out, void* scratch,
                                  int B, int C, long long P, void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const int log_p = wide_log_p(C, P, Wide<int32_t>::kChunk);
    if (log_p < 0) return (int)cudaErrorInvalidValue;
    int32_t* s = (int32_t*)scratch;
    const bool vec = C % 4 == 0 && aligned16(x) && aligned16(out) &&
                     aligned16(scratch);
    return (int)sort_wide(PaddedIn{(const int32_t*)x, s, C, log_p},
                          PaddedOut{(int32_t*)out, C, log_p}, s, B, log_p,
                          vec, (cudaStream_t)stream);
}

extern "C" int sort2_rows_i32(const void* key, const void* val,
                              void* out_key, void* out_val, int B, int C,
                              void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const TwoKey rows{(const int32_t*)key, (const int32_t*)val,
                      (int32_t*)out_key, (int32_t*)out_val};
    const bool vec = C % 4 == 0 && aligned16(key) && aligned16(val) &&
                     aligned16(out_key) && aligned16(out_val);
    return (int)launch_fit<TwoKey, 1, 16>(rows, B, C, vec,
                                          (cudaStream_t)stream);
}

// Pair rows of C > 16,384 pairs: scratch holds B rows of P =
// 2^ceil(log2 C) packed pairs (uint64), 16-byte aligned.
extern "C" int sort2_rows_wide_i32(const void* key, const void* val,
                                   void* out_key, void* out_val,
                                   void* scratch, int B, int C, long long P,
                                   void* stream) {
    if (B <= 0 || C <= 0) return (int)cudaGetLastError();
    const int log_p = wide_log_p(C, P, Wide<u64>::kChunk);
    if (log_p < 0) return (int)cudaErrorInvalidValue;
    u64* s = (u64*)scratch;
    const bool vec = C % 4 == 0 && aligned16(key) && aligned16(val) &&
                     aligned16(out_key) && aligned16(out_val) &&
                     aligned16(scratch);
    return (int)sort_wide(
        PaddedIn2{(const int32_t*)key, (const int32_t*)val, s, C, log_p},
        PaddedOut2{(int32_t*)out_key, (int32_t*)out_val, C, log_p}, s, B,
        log_p, vec, (cudaStream_t)stream);
}

extern "C" const char* biokanga_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
