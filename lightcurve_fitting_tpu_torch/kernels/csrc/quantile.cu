// Exact percentiles of float32 rows by counting bisection (K5), for sm_90a,
// bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/): ops/quantile.py:46-105
// percentile_f32, the sort-free device percentiles of _epoch_summary
// (parallel/batched.py:161-168) and of the population summaries. Each order
// statistic is the smallest int32 key v (the order-isomorphic view of the
// float32 value) with count(key <= v) >= rank + 1, found in 32 bisection
// passes over the row; the bracketing statistics are interpolated linearly
// in float64.
//
// What bounds it on the H100: the compares. A row of N values costs
// 32 x 2Q x N key compares (Q = 3 percentiles: 192 N), against N x 4 bytes
// read once; at the bolometric shapes (N = 3200) that is ~50 compares a
// byte, so the ALU, not the memory, sets the bound.
// What the design does about it: one block per row converts the row to keys
// once and keeps them in shared memory for all 32 passes (12.8 KB at 3200;
// rows past the block's shared-memory limit read and convert from global
// memory each pass); every pass advances all 2Q searches together, each
// thread counting its strided keys for every target, a warp-shuffle and
// shared-memory reduction giving the block's counts.
// The interpolation uses round-to-nearest intrinsics (no FMA contraction),
// so results equal the plain PyTorch version's bit for bit.

#include <cuda_runtime.h>
#include <limits.h>

#include "stretch.cuh"

#define PCT_MAX_Q 8
#define PCT_THREADS 256

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

// T = 2 n_q bisection targets, a compile-time count so that the per-target
// counters stay in registers.
template <int T>
__global__ void __launch_bounds__(PCT_THREADS)
percentile_kernel(const PercentileParams P, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* keys = reinterpret_cast<int*>(smem_raw);
    __shared__ int s_lo[2 * PCT_MAX_Q];
    __shared__ int s_hi[2 * PCT_MAX_Q];
    __shared__ int s_cnt[PCT_THREADS / 32][2 * PCT_MAX_Q];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const long long n = P.n;
    const float* src = P.a + (size_t)blockIdx.x * n;
    if (use_smem)
        for (long long i = tid; i < n; i += blockDim.x) keys[i] = sortable_key(src[i]);
    if (tid < T) {
        s_lo[tid] = INT_MIN;
        s_hi[tid] = INT_MAX;
    }
    __syncthreads();
    for (int pass = 0; pass < 32; ++pass) {
        int mid[T];   // targets: the low brackets, then the high ones
        int cnt[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            const int lo = s_lo[t], hi = s_hi[t];
            mid[t] = (lo >> 1) + (hi >> 1) + (lo & hi & 1);  // floor((lo + hi) / 2)
            cnt[t] = 0;
        }
        for (long long i = tid; i < n; i += blockDim.x) {
            const int k = use_smem ? keys[i] : sortable_key(src[i]);
#pragma unroll
            for (int t = 0; t < T; ++t) cnt[t] += k <= mid[t] ? 1 : 0;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
            int c = cnt[t];
            for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
            if (lane == 0) s_cnt[warp][t] = c;
        }
        __syncthreads();
        if (tid < T) {
            long long total = 0;
            for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_cnt[w][tid];
            const long long rank = tid < (int)P.n_q ? P.rank_lo[tid] : P.rank_hi[tid - P.n_q];
            // the rank-th order statistic is the smallest v with count(key <= v) >= rank + 1
            const int lo = s_lo[tid], hi = s_hi[tid];
            const int m = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
            if (total >= rank + 1)
                s_hi[tid] = m;
            else
                s_lo[tid] = m + 1;
        }
        __syncthreads();
    }
    if (tid < (int)P.n_q) {
        const double v_lo = (double)key_to_f32(s_lo[tid]);
        const double v_hi = (double)key_to_f32(s_lo[P.n_q + tid]);
        P.out[(size_t)tid * P.rows + blockIdx.x] =
            __dadd_rn(v_lo, __dmul_rn(P.frac[tid], __dsub_rn(v_hi, v_lo)));
    }
}

template <int T>
static int launch_percentile(const PercentileParams& P, size_t bytes, cudaStream_t stream) {
    auto kernel = percentile_kernel<T>;
    // the keys take the dynamic shared memory, next to ~0.6 KB of static
    const int use_smem = bytes + 1024 <= (size_t)smem_optin_limit();
    if (use_smem && bytes > 48 * 1024) {
        const int rc = (int)cudaFuncSetAttribute(kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
        if (rc) return rc;
    }
    kernel<<<(unsigned)P.rows, PCT_THREADS, use_smem ? bytes : 0, stream>>>(P, use_smem);
    return (int)cudaGetLastError();
}

extern "C" {

// K5 launch: one block per row. Returns 0 or a cudaError_t code.
int percentile_launch(const PercentileParams* P, int device, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->rows <= 0) return 0;
    if (P->n <= 0 || P->n_q <= 0 || P->n_q > PCT_MAX_Q || P->rows > 2147483647LL ||
        P->n > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = sizeof(int) * (size_t)P->n;
    cudaStream_t s = (cudaStream_t)stream;
    switch (P->n_q) {
        case 1: return launch_percentile<2>(*P, bytes, s);
        case 2: return launch_percentile<4>(*P, bytes, s);
        case 3: return launch_percentile<6>(*P, bytes, s);
        case 4: return launch_percentile<8>(*P, bytes, s);
        case 5: return launch_percentile<10>(*P, bytes, s);
        case 6: return launch_percentile<12>(*P, bytes, s);
        case 7: return launch_percentile<14>(*P, bytes, s);
        case 8: return launch_percentile<16>(*P, bytes, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
