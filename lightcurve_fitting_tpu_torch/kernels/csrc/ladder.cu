// K6: the model-free kernels of the tempered ladder, for sm_90a, bound to
// Python through a plain C interface (ctypes). The model kernels (the
// tempered half-step and the initial state) are templates in ladder.cuh.
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K6c parallel/evidence.py:95-115 (do_swap: replica exchange between
//       neighbouring rungs) with :117-123 (the production outputs of a step:
//       the post-swap log L of every rung, the swap flags, the cold rung's
//       states).
//   K6d parallel/evidence.py:473-503 (_rung_block_terms): the stepping-stone
//       terms log mean exp(dbeta_k log L_k) over each block of production
//       steps.
//
// What bounds them on the H100: device memory. The swap reads and writes a
// few dozen bytes a walker with a handful of flops; the block terms read the
// production log L, (nsteps, K+1, 2, half) float64 (83.6 MB at 150 steps x
// 17 rungs x 4096 walkers), once for the maximum and once for the sum of
// exponentials, an exp a value.
// What the design does about it: the swap is one thread per (rung pair,
// walker): the lower rung's thread reads both members, decides once (the two
// rows' acceptance ratios are the same number: both factors change sign) and
// writes both, so nothing races and the pair shares its uniform as in the
// JAX graph; the same launch writes the step's production outputs, so they
// cost no launch of their own. The block terms run one block per (block of
// steps, rung), a strided max pass and a strided sum pass with warp-shuffle
// reductions; the second read mostly hits the 50 MB L2 for short blocks.

#include "stretch.cuh"

#define LADDER_MAX_BLOCKS 8
#define TERMS_THREADS 512

// The rung that rung r exchanges with at this step's parity: even parity
// pairs (0,1), (2,3), ...; odd parity (1,2), (3,4), ...; an unpaired edge
// rung is its own partner (evidence.py:87-93).
__device__ __forceinline__ int swap_partner(int r, int parity, int n_rungs) {
    const int p = parity ? (r == 0 ? 0 : (((r - 1) ^ 1) + 1)) : (r ^ 1);
    return p >= n_rungs ? r : p;
}

// K6c: the replica exchange of one step, in place. x (R, W, ndim), logpri and
// logl (R, W) float64 with W = 2 half; betas (R,); u (R, W) uniforms, a pair
// reading its lower rung's row. A pair (r, r+1) exchanges walker w's states
// when log u < (beta_{r+1} - beta_r)(ll_r - ll_{r+1}) and both ll are finite.
// When given: n_swap (R, W) int32 counts the exchanges of both rows,
// logl_out (R, W) receives the post-swap log L, cold_out (W, ndim) the last
// rung's post-swap states.
template <typename S>
__global__ void replica_swap_kernel(S* __restrict__ x, int ndim, double* __restrict__ logpri,
                                    double* __restrict__ logl, const double* __restrict__ betas,
                                    int n_rungs, int W, const S* __restrict__ u, int parity,
                                    int* __restrict__ n_swap, double* __restrict__ logl_out,
                                    S* __restrict__ cold_out) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    const int r = blockIdx.y;
    const int q = swap_partner(r, parity, n_rungs);
    if (q < r) return;    // the pair's lower rung does the work
    const size_t a = (size_t)r * W + w;
    const int cold = n_rungs - 1;
    if (q != r) {
        const size_t b = (size_t)q * W + w;
        const double lla = logl[a], llb = logl[b];
        const double log_acc = __dmul_rn(__dsub_rn(betas[q], betas[r]), __dsub_rn(lla, llb));
        // a log L of -inf (a NaN-likelihood start) never moves between rungs
        const bool acc = (double)m_log(u[a]) < log_acc && isfinite(lla) && isfinite(llb);
        if (acc) {
            for (int k = 0; k < ndim; ++k) {
                const S t = x[a * ndim + k];
                x[a * ndim + k] = x[b * ndim + k];
                x[b * ndim + k] = t;
            }
            const double tp = logpri[a];
            logpri[a] = logpri[b];
            logpri[b] = tp;
            logl[a] = llb;
            logl[b] = lla;
        }
        if (n_swap != nullptr) {
            n_swap[a] += acc ? 1 : 0;
            n_swap[b] += acc ? 1 : 0;
        }
        if (logl_out != nullptr) logl_out[b] = logl[b];
        if (cold_out != nullptr && q == cold)
            for (int k = 0; k < ndim; ++k) cold_out[(size_t)w * ndim + k] = x[b * ndim + k];
    }
    if (logl_out != nullptr) logl_out[a] = logl[a];
    if (cold_out != nullptr && r == cold)
        for (int k = 0; k < ndim; ++k) cold_out[(size_t)w * ndim + k] = x[a * ndim + k];
}

struct TermBlocks {
    long long lo[LADDER_MAX_BLOCKS];  // first production step of each block
    long long hi[LADDER_MAX_BLOCKS];  // one past its last
};

// max that keeps a NaN, as torch.amax and jnp.max do
__device__ __forceinline__ double nan_max(double m, double v) {
    return (isnan(v) || v > m) ? v : m;
}

// Reduce v over the block (blockDim.x a multiple of 32, at most 1024) with
// op; every thread returns the result.
template <typename Op>
__device__ double block_reduce(double v, Op op, double* scratch) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();   // scratch may still be read by an earlier reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = scratch[0];
    for (int k = 1; k < n_warps; ++k) v = op(v, scratch[k]);
    return v;
}

// K6d: out[b, k] = log mean exp(dbetas[k] * logl[s, k, w]) over the steps s of
// block b and all W walkers, for the rungs k < K of logl (nsteps, R, W)
// float64: m + log(sum exp(v - m) / n) with m the maximum, in float64. One
// CUDA block per (b, k).
__global__ void __launch_bounds__(TERMS_THREADS)
rung_block_terms_kernel(const double* __restrict__ logl, int n_rungs, int W,
                        const double* __restrict__ dbetas, int K, const TermBlocks blocks,
                        double* __restrict__ out) {
    __shared__ double scratch[32];
    const int b = blockIdx.x, k = blockIdx.y;
    const double db = dbetas[k];
    const long long s0 = blocks.lo[b], s1 = blocks.hi[b];
    double m = -INFINITY;
    for (long long s = s0; s < s1; ++s) {
        const double* row = logl + (s * n_rungs + k) * (long long)W;
        for (int w = threadIdx.x; w < W; w += blockDim.x) m = nan_max(m, __dmul_rn(db, row[w]));
    }
    m = block_reduce(m, [](double p, double q) { return nan_max(p, q); }, scratch);
    double sum = 0.0;
    for (long long s = s0; s < s1; ++s) {
        const double* row = logl + (s * n_rungs + k) * (long long)W;
        for (int w = threadIdx.x; w < W; w += blockDim.x) sum += exp(__dmul_rn(db, row[w]) - m);
    }
    sum = block_reduce(sum, [](double p, double q) { return p + q; }, scratch);
    if (threadIdx.x == 0) out[(size_t)b * K + k] = m + log(sum / (double)((s1 - s0) * W));
}

extern "C" {

// K6c launch. n_swap, logl_out and cold_out may be null (a burn-in step).
// Returns 0 or a cudaError_t code.
int replica_swap_launch(int device, void* x, int state_f64, int ndim, double* logpri,
                        double* logl, const double* betas, int n_rungs, int W, const void* u,
                        int parity, int* n_swap, double* logl_out, void* cold_out,
                        void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || n_rungs <= 0) return 0;
    if (n_rungs > 65535 || ndim > LP_MAX_DIM) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, n_rungs);
    if (state_f64)
        replica_swap_kernel<double><<<grid, threads, 0, s>>>(
            (double*)x, ndim, logpri, logl, betas, n_rungs, W, (const double*)u, parity, n_swap,
            logl_out, (double*)cold_out);
    else
        replica_swap_kernel<float><<<grid, threads, 0, s>>>(
            (float*)x, ndim, logpri, logl, betas, n_rungs, W, (const float*)u, parity, n_swap,
            logl_out, (float*)cold_out);
    return (int)cudaGetLastError();
}

// K6d launch: n_blocks blocks of steps [lo[b], hi[b]) (host arrays), out
// (n_blocks, K) float64. Returns 0 or a cudaError_t code.
int rung_block_terms_launch(int device, const double* logl, int n_rungs, int W,
                            const double* dbetas, int K, int n_blocks, const long long* lo,
                            const long long* hi, double* out, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (n_blocks <= 0 || K <= 0) return 0;
    if (n_blocks > LADDER_MAX_BLOCKS || K > n_rungs || K > 65535)
        return (int)cudaErrorInvalidValue;
    TermBlocks blocks;
    for (int b = 0; b < n_blocks; ++b) {
        blocks.lo[b] = lo[b];
        blocks.hi[b] = hi[b];
    }
    rung_block_terms_kernel<<<dim3(n_blocks, K), TERMS_THREADS, 0, (cudaStream_t)stream>>>(
        logl, n_rungs, W, dbetas, K, blocks, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
