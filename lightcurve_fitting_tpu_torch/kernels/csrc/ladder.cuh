// K6: the tempered ladder's model kernels, templates over a model policy M of
// stretch.cuh (K6a over SC2 and over CS a warp per walker, SC2WarpModel and
// CSWarpModel in sc2_logpost.cu and companion.cu; over SC3 a thread per
// walker, SC3Model in sc3_logpost.cu; K6b a warp per state over
// SC2WarpModel, SC3WarpModel and CSWarpModel). The model-free K6 kernels
// (the replica exchange and the stepping-stone block terms) are in
// ladder.cu.
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K6a parallel/evidence.py:60-74 (half_update) and :76-83 (the step_one
//       vmapped over the rungs): K+1 stretch-move ensembles, one per inverse
//       temperature beta_r, that accept by log pi + beta_r log L.
//   K6b parallel/evidence.py:229-235 (init_carry): log pi and log L of every
//       starting state of every rung.
//
// What bounds it on the H100: as K2, the model's log-likelihood (FP32 work
// for ShockCooling2, special functions for ShockCooling3); the state, the
// draws and the two float64 values a walker are a few dozen bytes.
// What the design does about it: the stretch-move half-step of stretch.cuh
// with the rung on blockIdx.y, so one launch advances half of every rung's
// ensemble: the per-point data are staged once per block in shared memory
// as in K2, and one thread per walker runs the proposal (the same
// stretch_proposal as K2, bit for bit), log_prior and, only when the prior is
// finite, M::log_likelihood (a proposal outside the priors is always
// rejected, so its likelihood is never read). The acceptance sums run in
// float64 with round-to-nearest intrinsics, in the JAX graph's order, so that
// no multiply-add contraction moves a near-tie; beta log L is 0 on a
// beta = 0 rung, where 0 x (-inf) would be NaN. With WARP (SC2WarpModel,
// CSWarpModel) a warp runs each walker, its lanes over the points, in
// batches of walkers as the warp form of the stretch half-step (stretch.cuh,
// warp_batch_ll): a thread per walker left the ladders of the fits (7 rungs
// x half 16 or 32, 17 x 2048) a few warps an SM, each walking 149 (SC2) or
// 108 (CS) dependent point evaluations. K6a over SC3 keeps a thread per
// walker.
// K6b runs the batch log-posterior's warp form (logpost_batch) with the
// likelihood evaluated whatever the prior, so a starting state's log pi and
// log L have the bits that K6a over the same policy stores when it accepts
// that state. The ladder starts every rung from the same states (one p0
// broadcast to the K+1 rungs, as the JAX package's init_carry), so K6b
// takes the distinct states once and each lane writes its state's two
// values into the `copies` rows that hold it: at the evidence's 17 x 4096
// that is 4096 evaluations, not 69632 (a thread per state and rung took
// ~0.35 ms there, at the floor of a thread per walker).

#pragma once

#include "stretch.cuh"

// beta * ll with the prior rung's convention: 0 when beta is 0 (JAX:
// jnp.where(beta > 0.0, beta * logl, 0.0)).
__device__ __forceinline__ double tempered(double beta, double ll) {
    return beta > 0.0 ? __dmul_rn(beta, ll) : 0.0;
}

// The end of one walker's tempered half-step, from its proposal y (log pi
// lpri_y, log L ll_y, stretch z): the accept decision by log pi + beta log
// L and its writes (walker w of rung r).
template <typename S>
__device__ __forceinline__ void tempered_accept(int ndim, S* xm, const S* y, S z, double lpri_y,
                                                double ll_y, double* logpri, double* logl,
                                                double beta, const S* u_acc, size_t w,
                                                int* n_accept) {
    const S lz = (S)(ndim - 1) * m_log(z);
    // ((((lz + lpri_y) + beta ll_y) - lpri_x) - beta ll_x), as the JAX graph
    const double log_ratio = __dsub_rn(
        __dsub_rn(__dadd_rn(__dadd_rn((double)lz, lpri_y), tempered(beta, ll_y)), logpri[w]),
        tempered(beta, logl[w]));
    // log(0) = -inf accepts unless log_ratio is -inf; a NaN ratio rejects
    const double log_u = (double)m_log(u_acc[w]);
    const bool accept = !isnan(log_ratio) && log_u < log_ratio;
    if (accept) {
        for (int k = 0; k < ndim; ++k) xm[k] = y[k];
        logpri[w] = lpri_y;
        logl[w] = ll_y;
    }
    n_accept[w] += accept ? 1 : 0;
}

// One walker's tempered half-step, a thread: walker i of half h of rung r.
template <typename M, typename S>
__device__ __forceinline__ void tempered_walker(const typename M::Params& P,
                                                const typename M::Data& d, S* x, double* logpri,
                                                double* logl, const double* betas, int half,
                                                int h, const S* u_z, const long long* j,
                                                const S* u_acc, double a, int* n_accept, int r,
                                                int i) {
    const int ndim = (int)P.ndim;
    const size_t rung = (size_t)r * 2 * half;    // walkers of the rungs before r
    const size_t w = rung + (size_t)h * half + i;  // this walker, its values and its draws
    S* xm = x + w * ndim;
    const S* xj = x + (rung + (size_t)(1 - h) * half + (size_t)j[w]) * ndim;

    S y[LP_MAX_DIM];
    double p[LP_MAX_DIM];
    const S z = stretch_proposal(P, xm, xj, u_z[w], a, y, p);
    const double lpri_y = log_prior(P, p);
    double ll_y = -INFINITY;
    if (isfinite(lpri_y)) ll_y = M::log_likelihood(p, d, P);
    tempered_accept(ndim, xm, y, z, lpri_y, ll_y, logpri, logl, betas[r], u_acc, w, n_accept);
}

// The tempered half-steps of the walkers b0 .. b0 + nb - 1 of the R x half
// flattened over the rungs, a warp per walker: lane l forms walker b0 + l's
// proposal, log pi and constants (with nb = 1 every lane forms walker b0's,
// on the same bits), warp_batch_ll gives each its log L (only where log pi
// is finite), and lane l decides and writes for its walker (lane 0 with
// nb = 1).
template <typename M, typename S>
__device__ __forceinline__ void tempered_batch(const typename M::Params& P,
                                               const typename M::Data& d, S* x, double* logpri,
                                               double* logl, const double* betas, int half,
                                               int h, const S* u_z, const long long* j,
                                               const S* u_acc, double a, int* n_accept,
                                               long long b0, int nb) {
    const int lane = threadIdx.x & 31;
    const bool own = nb == 1 || lane < nb;
    const long long k = b0 + (nb == 1 ? 0 : lane);
    const int r = (int)(k / half);
    const int ndim = (int)P.ndim;
    const size_t rung = (size_t)r * 2 * half;
    const size_t w = rung + (size_t)h * half + (size_t)(k - (long long)r * half);
    S y[LP_MAX_DIM];
    S z = S(1);
    double lpri_y = -INFINITY;
    typename M::Walker wk;
    if (own) {
        const S* xj = x + (rung + (size_t)(1 - h) * half + (size_t)j[w]) * ndim;
        double p[LP_MAX_DIM];
        z = stretch_proposal(P, x + w * ndim, xj, u_z[w], a, y, p);
        lpri_y = log_prior(P, p);
        if (isfinite(lpri_y)) wk = M::walker(p, P);
    }
    const double ll_y = warp_batch_ll<M>(wk, lpri_y, nb, d, P);
    if (lane >= nb) return;
    tempered_accept(ndim, x + w * ndim, y, z, lpri_y, ll_y, logpri, logl, betas[r], u_acc, w,
                    n_accept);
}

// K6a: one tempered stretch-move half-step of half h of every rung, in place.
// x (R, 2, half, ndim) walker states; logpri and logl (R, 2, half) float64;
// betas (R,); the draws u_z, j, u_acc (R, 2, half), the half-step reading the
// [r, h] slice; n_accept (R, 2, half) int32, incremented. The partner pool of
// a walker is the other half of its own rung. A thread per walker, the rung
// on blockIdx.y; with WARP a warp per walker (tempered_batch), the block's
// warps striding over batches of `batch` of the R x half walkers of every
// rung (the data do not depend on the rung; warp_layout).
template <typename M, typename S, bool WARP>
__global__ void __launch_bounds__(block_limit<M>::value)
tempered_half_step_kernel(const typename M::Params P, S* __restrict__ x,
                          double* __restrict__ logpri, double* __restrict__ logl,
                          const double* __restrict__ betas, int half, int h,
                          const S* __restrict__ u_z, const long long* __restrict__ j,
                          const S* __restrict__ u_acc, double a, int* __restrict__ n_accept,
                          int use_smem, int n_rungs, int batch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    if constexpr (WARP) {
        const int per_block = blockDim.x >> 5;
        const long long n = (long long)n_rungs * half;
        const long long n_batches = (n + batch - 1) / batch;
        for (long long b = (long long)blockIdx.x * per_block + (threadIdx.x >> 5); b < n_batches;
             b += (long long)gridDim.x * per_block) {   // (whole warps)
            const long long b0 = b * batch;
            tempered_batch<M, S>(P, d, x, logpri, logl, betas, half, h, u_z, j, u_acc, a,
                                 n_accept, b0, (int)(n - b0 < batch ? n - b0 : batch));
        }
    } else {
        const int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i >= half) return;
        tempered_walker<M, S>(P, d, x, logpri, logl, betas, half, h, u_z, j, u_acc, a, n_accept,
                              blockIdx.y, i);
    }
}

// The initial values of the states b0 .. b0 + nb - 1 of x, a warp per
// state, as logpost_batch evaluates a batch (the same layout, staging and
// warp_batch_ll) but with the likelihood of every state, whatever its prior:
// lane l maps state b0 + l to absolute parameters and forms its log pi and
// constants (with nb = 1 every lane forms state b0's), and writes log pi
// and log L (-inf for a NaN) into each of its `copies` rows: state i of set
// s (per_set states a set) goes to rows s copies + c, c < copies.
template <typename M, typename S>
__device__ __forceinline__ void ladder_init_batch(const typename M::Params& P,
                                                  const typename M::Data& d, const S* x,
                                                  int per_set, int copies, double* logpri,
                                                  double* logl, int b0, int nb) {
    const int lane = threadIdx.x & 31;
    const bool own = nb == 1 || lane < nb;
    const int i = b0 + (nb == 1 ? 0 : lane);
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    double lpri = -INFINITY;
    typename M::Walker wk;
    if (own) {
        double p[D > 0 ? D : LP_MAX_DIM];
        for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, x[(size_t)i * ndim + k]);
        lpri = log_prior<D>(P, p);
        wk = M::walker(p, P);
    }
    double ll = warp_batch_ll<M, true>(wk, lpri, nb, d, P);
    if (lane >= nb) return;
    if (isnan(ll)) ll = -INFINITY;
    const int s = i / per_set;
    size_t row = (size_t)s * copies * per_set + (size_t)(i - s * per_set);
    for (int c = 0; c < copies; ++c, row += per_set) {
        logpri[row] = lpri;
        logl[row] = ll;
    }
}

// K6b: log pi and log L of the n states x (n, ndim), n = sets x per_set,
// the likelihood evaluated whatever the prior (the swaps read it alone),
// each written to `copies` rows: logpri and logl (sets x copies x per_set).
// A warp per state (ladder_init_batch), the block's warps striding over
// batches of `batch` states (warp_layout), as logpost_warp_kernel.
template <typename M, typename S>
__global__ void __launch_bounds__(block_limit<M>::value)
ladder_init_kernel(const typename M::Params P, const S* __restrict__ x, int n, int per_set,
                   int copies, double* __restrict__ logpri, double* __restrict__ logl,
                   int use_smem, int batch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const int n_batches = (n + bsz - 1) / bsz;
    for (int b = blockIdx.x * per_block + (threadIdx.x >> 5); b < n_batches;
         b += gridDim.x * per_block) {   // (whole warps)
        const int b0 = b * bsz;
        ladder_init_batch<M, S>(P, d, x, per_set, copies, logpri, logl, b0,
                                M::batched && n - b0 < bsz ? n - b0 : bsz);
    }
}

// ------------------------------------------------------------------ launch

template <typename M, typename S, bool WARP>
static int launch_tempered(const typename M::Params& P, void* x, double* logpri, double* logl,
                           const double* betas, int n_rungs, int half, int h, const void* u_z,
                           const long long* j, const void* u_acc, double a, int* n_accept,
                           cudaStream_t stream) {
    auto kernel = tempered_half_step_kernel<M, S, WARP>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    // a thread per walker, the rung on blockIdx.y, or WarpLayout's warps with WARP
    WarpLayout lay = {threads_for(half), 0, 1};
    dim3 grid((half + lay.threads - 1) / lay.threads, n_rungs);
    if constexpr (WARP) {
        lay = warp_layout<M>(kernel, (long long)n_rungs * half, use_smem ? bytes : 0);
        grid = dim3(lay.blocks, 1);
    }
    kernel<<<grid, lay.threads, use_smem ? bytes : 0, stream>>>(
        P, (S*)x, logpri, logl, betas, half, h, (const S*)u_z, j, (const S*)u_acc, a, n_accept,
        use_smem, n_rungs, lay.batch);
    return (int)cudaGetLastError();
}

template <typename M, typename S>
static int launch_init(const typename M::Params& P, const void* x, int n, int per_set,
                       int copies, double* logpri, double* logl, cudaStream_t stream) {
    auto kernel = ladder_init_kernel<M, S>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const WarpLayout lay = warp_layout<M>(kernel, n, use_smem ? bytes : 0);
    kernel<<<lay.blocks, lay.threads, use_smem ? bytes : 0, stream>>>(
        P, (const S*)x, n, per_set, copies, logpri, logl, use_smem, lay.batch);
    return (int)cudaGetLastError();
}

// The K6a launch for the model policy M<C> in the compute type C (float or
// double) and the walker state's type (float or double); WARP as in
// tempered_half_step_kernel. Returns 0 or a cudaError_t code.
template <template <typename> class M, bool WARP = false>
static int launch_tempered_half_step(const typename M<float>::Params* P, int device,
                                     int compute_f64, void* x, int state_f64, double* logpri,
                                     double* logl, const double* betas, int n_rungs, int half,
                                     int h, const void* u_z, const long long* j,
                                     const void* u_acc, double a, int* n_accept, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || n_rungs <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || n_rungs > 65535 || (h != 0 && h != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LADDER_ARGS *P, x, logpri, logl, betas, n_rungs, half, h, u_z, j, u_acc, a, n_accept, s
    if (compute_f64)
        return state_f64 ? launch_tempered<M<double>, double, WARP>(LADDER_ARGS)
                         : launch_tempered<M<double>, float, WARP>(LADDER_ARGS);
    return state_f64 ? launch_tempered<M<float>, double, WARP>(LADDER_ARGS)
                     : launch_tempered<M<float>, float, WARP>(LADDER_ARGS);
#undef LADDER_ARGS
}

// The K6b launch for the warp policy M<C> over the n states x (sets x
// per_set, ndim), each written to `copies` rows. Returns 0 or a cudaError_t
// code.
template <template <typename> class M>
static int launch_ladder_init(const typename M<float>::Params* P, int device, int compute_f64,
                              const void* x, int state_f64, int n, int per_set, int copies,
                              double* logpri, double* logl, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (n <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || per_set <= 0 || n % per_set || copies < 1 ||
        (long long)n * copies > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LADDER_INIT_ARGS *P, x, n, per_set, copies, logpri, logl, s
    if (compute_f64)
        return state_f64 ? launch_init<M<double>, double>(LADDER_INIT_ARGS)
                         : launch_init<M<double>, float>(LADDER_INIT_ARGS);
    return state_f64 ? launch_init<M<float>, double>(LADDER_INIT_ARGS)
                     : launch_init<M<float>, float>(LADDER_INIT_ARGS);
#undef LADDER_INIT_ARGS
}
