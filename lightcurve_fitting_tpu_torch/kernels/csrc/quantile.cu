// Exact percentiles of float32 rows by a radix select (K5), for sm_90a,
// bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/): ops/quantile.py:46-105
// percentile_f32, the sort-free device percentiles of _epoch_summary
// (parallel/batched.py:161-168) and of the population summaries. Each order
// statistic is the smallest int32 key v (the order-isomorphic view of the
// float32 value) with count(key <= v) >= rank + 1; the bracketing
// statistics are interpolated linearly in float64.
//
// The JAX function finds that key by 32 passes of counting bisection (and
// so does the plain version, ops/quantile.py::percentile_f32_plain). Here
// the key is read as unsigned with its sign bit flipped and found a byte at
// a time, from the most significant: four passes, each a 256-bin histogram
// of the next digit over the keys that share the target's prefix so far,
// and a scan that picks the digit holding the target's remaining rank.
// After four digits the prefix is the rank-th smallest key, which is the
// bisection's answer: the same order statistics on every input, NaNs (above
// +inf) and -0.0 < +0.0 included.
//
// What bounds it on the H100: the integer operations. A row of N values is
// read once (N x 4 bytes) and converted to keys in shared memory; the
// passes cost ~5 + 3 x (4 + 2 x 2Q) integer operations a key, which run at
// a quarter of the FP32 rate (64 INT32 lanes an SM). At the bolometric
// shapes (1024 rows x 3200) that is ~0.0069 ms of operations against
// 0.0039 ms of memory time.
// What the design does about it: one block per row converts its row once,
// counting the first digit as it goes, and keeps the keys in shared memory
// for the three passes after (12.8 KB at 3200; rows past the block's
// shared-memory limit read and convert from global memory each pass). The
// 2Q targets (the low and the high bracket of each percentile) carry a
// (prefix, remaining rank) each; targets with one prefix share one
// histogram, indexed by the first of them, so a posterior's 16/50/84 fill
// 1-3 histograms. A key adds one to the bin of its digit in the histogram
// of the target whose prefix it shares, by a shared-memory atomic (on the
// H100 plain atomics beat grouping a warp's adds to one bin first, with
// __match_any_sync, though a posterior's row falls into one
// or two bins of its top byte: PERF.md). Then a
// warp a target scans its histogram (8 bins a lane and a shuffle scan).
// The histograms are double-buffered, so the pass after next's is cleared
// while one counts: two barriers a pass.
// The interpolation uses round-to-nearest intrinsics (no FMA contraction),
// so results equal the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

#include "stretch.cuh"

#define PCT_MAX_Q 8
#define PCT_THREADS 256
#define PCT_BINS 256

// Every field is 8 bytes wide (mirror: kernels/quantile.py _PercentileParams).
struct PercentileParams {
    const float* a;              // (rows, n) contiguous
    double* out;                 // (n_q, rows)
    long long rows;
    long long n;
    long long n_q;
    long long rank_lo[PCT_MAX_Q];
    long long rank_hi[PCT_MAX_Q];
    double frac[PCT_MAX_Q];
};

__device__ __forceinline__ int sortable_key(float x) {
    const int i = __float_as_int(x);
    return i < 0 ? (~i) ^ INT_MIN : i;
}

__device__ __forceinline__ float key_to_f32(int k) {
    return __int_as_float(k < 0 ? ~(k ^ INT_MIN) : k);
}

// The int32 key as unsigned, in the same order: its bytes are the digits.
__device__ __forceinline__ unsigned radix_key(float x) {
    return (unsigned)sortable_key(x) ^ 0x80000000u;
}

// T = 2 n_q targets: the low brackets, then the high ones; a compile-time
// count, so that a key's prefix compares stay in registers.
template <int T>
__global__ void __launch_bounds__(PCT_THREADS)
percentile_kernel(const PercentileParams P, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned* hist = reinterpret_cast<unsigned*>(smem_raw);   // [2][T][PCT_BINS]
    unsigned* keys = hist + 2 * T * PCT_BINS;                  // (n,) when use_smem
    __shared__ unsigned s_prefix[2][T];   // each target's digits so far, by pass parity
    __shared__ int s_rank[2][T];          // its rank among the keys with that prefix
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int n = (int)P.n;
    const float* src = P.a + (size_t)blockIdx.x * P.n;
    for (int i = tid; i < 2 * T * PCT_BINS; i += blockDim.x) hist[i] = 0u;
    if (tid < T) {
        s_prefix[0][tid] = 0u;
        s_rank[0][tid] = (int)(tid < (int)P.n_q ? P.rank_lo[tid] : P.rank_hi[tid - P.n_q]);
    }
    __syncthreads();
    // the first pass counts the top digits as the row is converted: every
    // key shares the targets' empty prefix, so all count in histogram 0
    for (int i = tid; i < n; i += blockDim.x) {
        const unsigned u = radix_key(src[i]);
        if (use_smem) keys[i] = u;
        atomicAdd(&hist[u >> 24], 1u);
    }
    __syncthreads();
#pragma unroll 1
    for (int pass = 0; pass < 4; ++pass) {
        const int cur = pass & 1;
        unsigned* h = hist + cur * T * PCT_BINS;
        if (pass > 0) {
            const int shift = 24 - 8 * pass;
            unsigned pre[T];
#pragma unroll
            for (int t = 0; t < T; ++t) pre[t] = s_prefix[cur][t];
            for (int i = tid; i < n; i += blockDim.x) {
                const unsigned u = use_smem ? keys[i] : radix_key(src[i]);
                const unsigned hi = u >> (shift + 8);
                int rep = -1;   // the first target whose prefix the key shares
#pragma unroll
                for (int t = T - 1; t >= 0; --t)
                    if (pre[t] == hi) rep = t;
                if (rep >= 0) atomicAdd(&h[rep * PCT_BINS + ((u >> shift) & 0xffu)], 1u);
            }
            // the pass after next counts in the buffer the last scan read
            if (pass < 3) {
                unsigned* h_next = hist + (cur ^ 1) * T * PCT_BINS;
                for (int i = tid; i < T * PCT_BINS; i += blockDim.x) h_next[i] = 0u;
            }
            __syncthreads();
        }
        // a warp a target: the digit whose cumulative count first reaches rank + 1
        for (int t = warp; t < T; t += (int)(blockDim.x >> 5)) {
            const unsigned pt = s_prefix[cur][t];
            int rep = t;
            for (int j = t - 1; j >= 0; --j)
                if (s_prefix[cur][j] == pt) rep = j;
            const uint4* b4 = reinterpret_cast<const uint4*>(h + rep * PCT_BINS) + 2 * lane;
            const uint4 a = b4[0], b = b4[1];
            unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
            for (int j = 1; j < 8; ++j) c[j] += c[j - 1];
            unsigned incl = c[7];
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += v;
            }
            const unsigned excl = incl - c[7];
            const unsigned need = (unsigned)s_rank[cur][t] + 1u;
            const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
            if (lane == __ffs(hit) - 1) {
                int digit = 7;
                unsigned below = excl + c[6];
#pragma unroll
                for (int j = 6; j >= 0; --j)
                    if (excl + c[j] >= need) {
                        digit = j;
                        below = excl + (j ? c[j - 1] : 0u);
                    }
                s_prefix[cur ^ 1][t] = (pt << 8) | (unsigned)(8 * lane + digit);
                s_rank[cur ^ 1][t] = (int)(need - 1u - below);
            }
        }
        __syncthreads();
    }
    if (tid < (int)P.n_q) {   // after four passes the prefixes are in buffer 0
        const double v_lo = (double)key_to_f32((int)(s_prefix[0][tid] ^ 0x80000000u));
        const double v_hi = (double)key_to_f32((int)(s_prefix[0][P.n_q + tid] ^ 0x80000000u));
        P.out[(size_t)tid * P.rows + blockIdx.x] =
            __dadd_rn(v_lo, __dmul_rn(P.frac[tid], __dsub_rn(v_hi, v_lo)));
    }
}

template <int T>
static int launch_percentile(const PercentileParams& P, cudaStream_t stream) {
    auto kernel = percentile_kernel<T>;
    const size_t hist = sizeof(unsigned) * 2 * T * PCT_BINS;
    const size_t with_keys = hist + sizeof(unsigned) * (size_t)P.n;
    // the keys join the histograms where they fit, beside ~0.2 KB of static
    const int use_smem = with_keys + 1024 <= (size_t)smem_optin_limit();
    const size_t bytes = use_smem ? with_keys : hist;
    if (bytes > 48 * 1024) {
        const int rc = (int)cudaFuncSetAttribute(kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
        if (rc) return rc;
    }
    kernel<<<(unsigned)P.rows, PCT_THREADS, bytes, stream>>>(P, use_smem);
    return (int)cudaGetLastError();
}

extern "C" {

// K5 launch: one block per row. Returns 0 or a cudaError_t code.
int percentile_launch(const PercentileParams* P, int device, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->rows <= 0) return 0;
    if (P->n <= 0 || P->n_q <= 0 || P->n_q > PCT_MAX_Q || P->rows > 2147483647LL ||
        P->n > 2147483647LL - PCT_THREADS)   // the key loops' int index passes n by a block
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (P->n_q) {
        case 1: return launch_percentile<2>(*P, s);
        case 2: return launch_percentile<4>(*P, s);
        case 3: return launch_percentile<6>(*P, s);
        case 4: return launch_percentile<8>(*P, s);
        case 5: return launch_percentile<10>(*P, s);
        case 6: return launch_percentile<12>(*P, s);
        case 7: return launch_percentile<14>(*P, s);
        case 8: return launch_percentile<16>(*P, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
