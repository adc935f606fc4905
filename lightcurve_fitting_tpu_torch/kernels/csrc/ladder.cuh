// K6: the tempered ladder's model kernels, templates over a warp policy M of
// stretch.cuh (K6a and K6b a warp per walker or state over SC2WarpModel,
// SC3WarpModel, CSWarpModel, SCWarpModel and SC4WarpModel, instantiated in
// sc2_logpost.cu, sc3_logpost.cu, companion.cu and sc_logpost.cu; K6a and
// K6b also in a latency form, a block per walker or state, for a policy
// with point_term). The
// model-free K6 kernels (the replica exchange and the stepping-stone block
// terms) are in ladder.cu.
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
// over every rung at once, so one launch advances half of every rung's
// ensemble: the per-point data are staged once per block in shared memory
// as in K2, and a warp runs each walker, its lanes over the points, in
// batches of walkers as the warp form of the stretch half-step
// (stretch.cuh, warp_batch_ll; a batch of one walker for a policy that is
// not batched, SC3WarpModel): the proposal (the same stretch_proposal as K2,
// bit for bit), log_prior and, only when the prior is finite, the
// log-likelihood (a proposal outside the priors is always rejected, so its
// likelihood is never read). A thread per walker left the ladders of the
// fits (7 rungs x half 16 or 32, 17 x 2048 over SC2 and CS; 17 x 256 over
// SC3) a few warps an SM, each walking 149 (SC2, SC3) or 108 (CS) dependent
// point evaluations, an SC3 point ~39 Planck terms (~1.2 ms a launch over
// SC3, against ~0.06 ms for the warp form's one walker). The acceptance sums
// run in float64 with round-to-nearest intrinsics, in the JAX graph's
// order, so that no multiply-add contraction moves a near-tie; beta log L
// is 0 on a beta = 0 rung, where 0 x (-inf) would be NaN.
// K6b runs the batch log-posterior's warp form (logpost_batch) with the
// likelihood evaluated whatever the prior, so a starting state's log pi and
// log L have the bits that K6a over the same policy stores when it accepts
// that state. The ladder starts every rung from the same states (one p0
// broadcast to the K+1 rungs, as the JAX package's init_carry), so K6b
// takes the distinct states once and each lane writes its state's two
// values into the `copies` rows that hold it: at the evidence's 17 x 4096
// that is 4096 evaluations, not 69632 (a thread per state and rung took
// ~0.35 ms there, at the floor of a thread per walker). Over SCWarpModel
// and SC4WarpModel K6b also has a latency form, a block per distinct state
// (ladder_init_latency_kernel), where a warp per state leaves the card
// idle; the same bits.

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
// a walker is the other half of its own rung. A warp per walker
// (tempered_batch), the block's warps striding over batches of `batch` of
// the R x half walkers of every rung (the data do not depend on the rung;
// warp_layout), a batch of one for a policy that is not batched.
template <typename M, typename S>
__global__ void __launch_bounds__(block_limit<M>::value)
tempered_half_step_kernel(const typename M::Params P, S* __restrict__ x,
                          double* __restrict__ logpri, double* __restrict__ logl,
                          const double* __restrict__ betas, int half, int h,
                          const S* __restrict__ u_z, const long long* __restrict__ j,
                          const S* __restrict__ u_acc, double a, int* __restrict__ n_accept,
                          int use_smem, int n_rungs, int batch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const long long n = (long long)n_rungs * half;
    const long long n_batches = (n + bsz - 1) / bsz;
    for (long long b = (long long)blockIdx.x * per_block + (threadIdx.x >> 5); b < n_batches;
         b += (long long)gridDim.x * per_block) {   // (whole warps)
        const long long b0 = b * bsz;
        tempered_batch<M, S>(P, d, x, logpri, logl, betas, half, h, u_z, j, u_acc, a, n_accept,
                             b0, M::batched && n - b0 < bsz ? (int)(n - b0) : bsz);
    }
}

// K6a's latency form (a policy with point_term, stretch.cuh: ShockCooling's
// and ShockCooling4's), where a warp per walker leaves the card idle: the
// arguments and writes of tempered_half_step_kernel, a block per (rung,
// walker), blockIdx.x = r half + i, of ceil(N / 32) warps, as
// stretch_half_step_latency_kernel. Warp 0 forms the walker's proposal and
// log pi as tempered_batch does with nb = 1 (every lane the same bits) and,
// where log pi is finite, its constants, and puts them and the proposal into
// shared memory (the proposal held in registers across the barriers spilled
// in one dtype instantiation); after a barrier thread n forms point n's term
// (its coefficients read where they lie); after another warp 0 sums the
// terms in log_likelihood_warp's order and lane 0 decides and writes by
// tempered_accept with beta_r. A proposal outside the priors never has its
// likelihood evaluated, on any rung (a beta = 0 rung's log L is evaluated:
// the swaps read it). So the stored log pi and log L have the warp form's
// bits, K6b's and the batch log-posterior's at the new state.
template <typename M, typename S>
__global__ void __launch_bounds__(32 * LP_LAT_WARPS)
tempered_half_step_latency_kernel(const typename M::Params P, S* __restrict__ x,
                                  double* __restrict__ logpri, double* __restrict__ logl,
                                  const double* __restrict__ betas, int half, int h,
                                  const S* __restrict__ u_z, const long long* __restrict__ j,
                                  const S* __restrict__ u_acc, double a,
                                  int* __restrict__ n_accept) {
    typedef typename M::Compute C;
    typedef typename M::Walker Walker;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double lpri_s;
    __shared__ Walker walker_s;
    __shared__ S y_s[LP_MAX_DIM];
    __shared__ S z_s;
    C* terms = reinterpret_cast<C*>(smem_raw);   // blockDim.x of them
    const typename M::Data d = M::stage(P, nullptr, 0, 0);
    const int r = (int)(blockIdx.x / (unsigned)half);
    const int i = (int)(blockIdx.x - (unsigned)r * (unsigned)half);
    const int n = threadIdx.x, lane = threadIdx.x & 31;
    const bool lead = n < 32;
    const int ndim = (int)P.ndim;
    const int N = (int)P.n_points;
    const size_t rung = (size_t)r * 2 * half;
    const size_t w = rung + (size_t)h * half + i;
    if (lead) {
        const S* xj = x + (rung + (size_t)(1 - h) * half + (size_t)j[w]) * ndim;
        S y[LP_MAX_DIM];
        double p[LP_MAX_DIM];
        const S z = stretch_proposal(P, x + w * ndim, xj, u_z[w], a, y, p);
        const double lpri_y = log_prior(P, p);
        if (lane == 0) {
            lpri_s = lpri_y, z_s = z;
            for (int k = 0; k < ndim; ++k) y_s[k] = y[k];
        }
        if constexpr (policy_walker_lanes<M>::value) {
            if (isfinite(lpri_y)) {   // (uniform over the warp)
                const Walker wk = M::walker_lanes(p, P);
                if (lane == 0) walker_s = wk;
            }
        } else if (lane == 0 && isfinite(lpri_y)) {
            walker_s = M::walker(p, P);
        }
    }
    __syncthreads();
    if (n < N && isfinite(lpri_s)) terms[n] = M::point_term(n, walker_s, d, P);
    __syncthreads();
    if (!lead) return;
    const double lpri_y = lpri_s;
    double ll_y = -INFINITY;
    if (isfinite(lpri_y)) {   // (uniform over the warp)
        C acc = C(0);
        for (int k = lane; k < N; k += 32) acc = add_rn(acc, terms[k]);
        ll_y = finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset,
                                        P.log_norm_const);
    }
    if (lane != 0) return;
    tempered_accept(ndim, x + w * ndim, y_s, z_s, lpri_y, ll_y, logpri, logl, betas[r], u_acc,
                    w, n_accept);
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

// K6b's latency form (a policy with point_term: ShockCooling's and
// ShockCooling4's), where a warp per state leaves the card idle (the
// ladders' 32-4096 distinct starting states): the arguments and writes of
// ladder_init_kernel, a block per state of ceil(N / 32) warps, as
// logpost_latency_kernel (stretch.cuh). Warp 0 maps state i to absolute
// parameters and forms its log pi and, whatever it is, its constants
// (latency_walker); latency_log_likelihood<M, true> evaluates its log L (the
// swaps read it alone) in the warp form's order; warp 0's lanes write log
// pi and log L (-inf for a NaN) into the state's `copies` rows, lane l the
// rows l, l + 32, .... So each row has the warp form's bits, and those that
// K6a (both forms) stores when it accepts that state.
template <typename M, typename S>
__global__ void __launch_bounds__(32 * LP_LAT_WARPS)
ladder_init_latency_kernel(const typename M::Params P, const S* __restrict__ x, int per_set,
                           int copies, double* __restrict__ logpri, double* __restrict__ logl) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ typename M::Walker walker_s;
    const typename M::Data d = M::stage(P, nullptr, 0, 0);
    const int i = blockIdx.x;
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    double lpri = -INFINITY;
    if (threadIdx.x < 32) {
        double p[D > 0 ? D : LP_MAX_DIM];
        for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, x[(size_t)i * ndim + k]);
        lpri = log_prior<D>(P, p);
        latency_walker<M>(p, P, true, walker_s);
    }
    double ll = latency_log_likelihood<M, true>(nullptr, walker_s, d, P,
                                                reinterpret_cast<typename M::Compute*>(smem_raw));
    if (threadIdx.x >= 32) return;
    if (isnan(ll)) ll = -INFINITY;
    const int s = i / per_set;
    const size_t row = (size_t)s * copies * per_set + (size_t)(i - s * per_set);
    for (int c = threadIdx.x; c < copies; c += 32) {
        logpri[row + (size_t)c * per_set] = lpri;
        logl[row + (size_t)c * per_set] = ll;
    }
}

// ------------------------------------------------------------------ launch

template <typename M, typename S>
static int launch_tempered(const typename M::Params& P, void* x, double* logpri, double* logl,
                           const double* betas, int n_rungs, int half, int h, const void* u_z,
                           const long long* j, const void* u_acc, double a, int* n_accept,
                           cudaStream_t stream) {
    auto kernel = tempered_half_step_kernel<M, S>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const WarpLayout lay = warp_layout<M>(kernel, (long long)n_rungs * half,
                                          use_smem ? bytes : 0);
    kernel<<<lay.blocks, lay.threads, use_smem ? bytes : 0, stream>>>(
        P, (S*)x, logpri, logl, betas, half, h, (const S*)u_z, j, (const S*)u_acc, a, n_accept,
        use_smem, n_rungs, lay.batch);
    return (int)cudaGetLastError();
}

// K6a's latency form (tempered_half_step_latency_kernel) over the R x half
// walkers, a block of ceil(N / 32) warps each. Refused for a policy without
// point_term, and past LP_LAT_WARPS warps a walker.
template <typename M, typename S>
static int launch_tempered_latency(const typename M::Params& P, void* x, double* logpri,
                                   double* logl, const double* betas, int n_rungs, int half,
                                   int h, const void* u_z, const long long* j, const void* u_acc,
                                   double a, int* n_accept, cudaStream_t stream) {
    if constexpr (!policy_point<M>::value) {
        return (int)cudaErrorInvalidValue;
    } else {
        auto kernel = tempered_half_step_latency_kernel<M, S>;
        const long long per_walker = (P.n_points + 31) / 32;
        const long long blocks = (long long)n_rungs * half;
        if (per_walker < 1 || per_walker > LP_LAT_WARPS || blocks > 2147483647LL)
            return (int)cudaErrorInvalidValue;
        const int threads = (int)(32 * per_walker);
        kernel<<<(unsigned)blocks, threads, sizeof(typename M::Compute) * threads, stream>>>(
            P, (S*)x, logpri, logl, betas, half, h, (const S*)u_z, j, (const S*)u_acc, a,
            n_accept);
        return (int)cudaGetLastError();
    }
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

// The K6a launch for the warp policy M<C> in the compute type C (float or
// double) and the walker state's type (float or double); form 0 the warp
// form, 1 the latency form (a policy with point_term). Returns 0 or a
// cudaError_t code.
template <template <typename> class M>
static int launch_tempered_half_step(const typename M<float>::Params* P, int device,
                                     int compute_f64, void* x, int state_f64, double* logpri,
                                     double* logl, const double* betas, int n_rungs, int half,
                                     int h, const void* u_z, const long long* j,
                                     const void* u_acc, double a, int* n_accept, void* stream,
                                     int form = 0) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || n_rungs <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || (h != 0 && h != 1) || (form != 0 && form != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LADDER_ARGS *P, x, logpri, logl, betas, n_rungs, half, h, u_z, j, u_acc, a, n_accept, s
#define LADDER_CASE(C, S) \
    (form ? launch_tempered_latency<M<C>, S>(LADDER_ARGS) : launch_tempered<M<C>, S>(LADDER_ARGS))
    if (compute_f64)
        return state_f64 ? LADDER_CASE(double, double) : LADDER_CASE(double, float);
    return state_f64 ? LADDER_CASE(float, double) : LADDER_CASE(float, float);
#undef LADDER_CASE
#undef LADDER_ARGS
}

// K6b's latency form (ladder_init_latency_kernel) over the n states, a block
// of ceil(N / 32) warps each. Refused for a policy without point_term, and
// past LP_LAT_WARPS warps a state.
template <typename M, typename S>
static int launch_init_latency(const typename M::Params& P, const void* x, int n, int per_set,
                               int copies, double* logpri, double* logl, cudaStream_t stream) {
    if constexpr (!policy_point<M>::value) {
        return (int)cudaErrorInvalidValue;
    } else {
        const long long per_state = (P.n_points + 31) / 32;
        if (per_state < 1 || per_state > LP_LAT_WARPS) return (int)cudaErrorInvalidValue;
        const int threads = (int)(32 * per_state);
        ladder_init_latency_kernel<M, S><<<n, threads, sizeof(typename M::Compute) * threads,
                                           stream>>>(P, (const S*)x, per_set, copies, logpri,
                                                     logl);
        return (int)cudaGetLastError();
    }
}

// The K6b launch for the warp policy M<C> over the n states x (sets x
// per_set, ndim), each written to `copies` rows; form 0 the warp form
// (ladder_init_kernel), 1 the latency form (ladder_init_latency_kernel, a
// policy with point_term). Returns 0 or a cudaError_t code.
template <template <typename> class M>
static int launch_ladder_init(const typename M<float>::Params* P, int device, int compute_f64,
                              const void* x, int state_f64, int n, int per_set, int copies,
                              double* logpri, double* logl, void* stream, int form = 0) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (n <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || per_set <= 0 || n % per_set || copies < 1 ||
        (long long)n * copies > 2147483647LL || (form != 0 && form != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LADDER_INIT_ARGS *P, x, n, per_set, copies, logpri, logl, s
#define LADDER_INIT_CASE(C, S)                               \
    (form ? launch_init_latency<M<C>, S>(LADDER_INIT_ARGS)   \
          : launch_init<M<C>, S>(LADDER_INIT_ARGS))
    if (compute_f64)
        return state_f64 ? LADDER_INIT_CASE(double, double) : LADDER_INIT_CASE(double, float);
    return state_f64 ? LADDER_INIT_CASE(float, double) : LADDER_INIT_CASE(float, float);
#undef LADDER_INIT_CASE
#undef LADDER_INIT_ARGS
}
