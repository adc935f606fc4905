// The SED log-posterior of one epoch's blackbody fit (K10), the stretch-move
// half-step over it, and its run form (a whole segment of steps in one
// launch), for sm_90a, bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K10       bolometric.py:81-140 (_make_sed_log_posterior, its table
//             branch: planck_fast without reddening), fused by XLA with
//             ops/bandtable.py:152-181 (chebyshev_bandflux) and
//             models/priors.py:124-156 (the priors, KDEPrior.logp
//             among them).
//   K10 half  parallel/sampler.py:38-57 (propose_stretch), :86-104
//             (half_update, step) applied to that log-posterior.
//   K10 run   parallel/sampler.py:205-235 (the lax.scan of step over a
//             run_mcmc segment) over the same.
//
// What it computes: for walker (T, R[, sigma]) the float64 log-posterior
//   sum_i prior_i(p_i) - 0.5 sum_n [log(2 pi s_n^2) + (y_n - F_n / yscale)^2
//   / s_n^2] - N log(yscale),
// s_n^2 = dy_n^2 (+ (sigma u_n)^2 with the intrinsic scatter), where
// F_n = R^2 exp(ln g_b(n)(ln T)) is one Clenshaw recurrence over point n's
// row of the epoch's Chebyshev band table (0 where T <= 0 or NaN), in the
// compute type C (float32 on CUDA by default, as chebyshev_bandflux);
// everything after F_n is float64, as in the JAX package. -inf outside the
// priors and where the likelihood is not finite.
//
// What bounds it at the path's width: latency. calculate_bolometric fits
// one epoch at a time with 10 walkers (5 a half) over 1-11 points, so a
// half-step is 5 warps in one block; the time is one walker's chain of
// dependent operations (the prior, a degree-24..48 recurrence, the warp's
// sum), not any rate of the card, and a launch a half-step spends more
// time starting and staging than computing. The design keeps that chain
// short and every input in shared memory:
// - a warp per walker (SEDWarpModel, not batched): lane l takes the points
//   l, l + 32, ... (one each at the path's width) and a butterfly sums
//   them; the same walker's prior on all 32 lanes;
// - the run form (stretch_run_kernel, stretch.cuh): an ensemble of up to 64
//   walkers in one block, the step loop inside it, the data staged and the
//   state kept in shared memory once a segment: one launch a run_mcmc
//   segment in place of two a step;
// - the KDE prior (kind 3, the single-filter epochs' temperature prior:
//   logsumexp over at most 512 components) in one summation order, fixed by
//   the component index (kde_logp): 128 partials of at most 4 components,
//   the max from the smallest |v - s_k| (no exponent needed), so each
//   exponent is computed once, in the sum. K10 and the half-step give the
//   walker's warp the partials l, l + 32, l + 64, l + 96 (16 components a
//   lane); the run form gives them to the warps that hold no moving walker
//   too (a partial a thread, 4 components; block_log_prior), the same bits.
//   The components are staged with the table rows (4 KB in float64 at 512);
// - every float64 operation after the flux, and the recurrence's links,
//   rounded by hand (the _rn intrinsics: no contraction), so the batch
//   log-posterior (logpost_warp_kernel, the initial state), the half-step
//   (stretch_half_step_kernel) and the run form, each inlining the policy,
//   give a state the same bits; the new states equal the plain PyTorch
//   half-step's bit for bit wherever both accept (stretch.cuh).

#include "stretch.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/sed.py (_SEDParams) matches it field for field.
struct SEDParams {
    const void* coef;             // (N, n_coef) compute type: the points' table rows
    const void* s_a;              // (N,) compute type: s = s_a ln T - s_b
    const void* s_b;              // (N,)
    const double* y;              // (N,) lum / yscale
    const double* dy;             // (N,) dlum / yscale
    const double* sigma_units;    // (N,)
    const double* kde;            // (n_kde,) the KDE prior's components, or null
    long long n_points;
    long long n_coef;
    long long n_kde;
    long long ndim;
    long long use_sigma;
    long long has_affine;
    double inv_yscale;
    double offset;                // -N log(yscale)
    double kde_bandwidth;
    double kde_lognorm;
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian, 3 KDE
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

template <typename C>
struct SEDData {
    const double* y;
    const double* dy;
    const double* su;
    const double* kde;
    const C* coef;
    const C* s_a;
    const C* s_b;
};

template <typename C>
struct SEDWalker {
    C T, R;
    double sig;
};

template <typename C>
__host__ __device__ inline size_t sed_stage_bytes(const SEDParams& P) {
    return sizeof(double) * (size_t)(3 * P.n_points + P.n_kde)
           + sizeof(C) * (size_t)P.n_points * (size_t)(P.n_coef + 2);
}

// The float64 arrays first (8-byte aligned), then the compute-type ones;
// every thread of the block takes part, so call it before any returns.
template <typename C>
__device__ SEDData<C> sed_stage(const SEDParams& P, unsigned char* smem, int use_smem) {
    const long long N = P.n_points;
    SEDData<C> d;
    if (!use_smem) {
        d.y = P.y, d.dy = P.dy, d.su = P.sigma_units, d.kde = P.kde;
        d.coef = (const C*)P.coef, d.s_a = (const C*)P.s_a, d.s_b = (const C*)P.s_b;
        return d;
    }
    double* s = reinterpret_cast<double*>(smem);
    d.y = stage_array(P.y, N, s);
    d.dy = stage_array(P.dy, N, s);
    d.su = stage_array(P.sigma_units, N, s);
    d.kde = P.n_kde > 0 ? stage_array(P.kde, P.n_kde, s) : nullptr;
    C* c = reinterpret_cast<C*>(s);
    d.coef = stage_array((const C*)P.coef, N * P.n_coef, c);
    d.s_a = stage_array((const C*)P.s_a, N, c);
    d.s_b = stage_array((const C*)P.s_b, N, c);
    __syncthreads();
    return d;
}

// Point n's band flux R^2 exp(ln g(ln T)) in the compute type, the order and
// roundings of chebyshev_bandflux: s = clip(ln T s_a - s_b, -1, 1), the
// degree-(K-1) Clenshaw recurrence b_k = 2 s b_{k+1} - b_{k+2} + c_k, ln g =
// s b_1 - b_2 + c_0; 0 where T <= 0 (or NaN).
template <typename C>
__device__ __forceinline__ C sed_flux(int n, C T, C R, const SEDData<C>& d, int K) {
    if (!(T > C(0))) return C(0);
    const C s_raw = sub_rn(mul_rn(m_log(T), d.s_a[n]), d.s_b[n]);
    const C s = s_raw < C(-1) ? C(-1) : (s_raw > C(1) ? C(1) : s_raw);
    const C two_s = C(2) * s;
    const C* c = d.coef + (size_t)n * K;
    C b1 = C(0), b2 = C(0);
    for (int k = K - 1; k >= 1; --k) {
        const C b0 = add_rn(sub_rn(mul_rn(two_s, b1), b2), c[k]);
        b2 = b1;
        b1 = b0;
    }
    const C ln_g = add_rn(sub_rn(mul_rn(s, b1), b2), c[0]);
    return mul_rn(mul_rn(R, R), m_exp(ln_g));
}

// The KDE prior's log-density at v (KDEPrior.logp): logsumexp over the n
// components s_k of a_k = -0.5 ((v - s_k) / bw)^2, minus its log
// normalization; -inf where every a_k is -inf (torch.logsumexp shifts by 0
// there: log(0)). One summation order, fixed by the component index alone,
// in every form (a warp: kde_logp; the block's warps: the run form): the
// sum of exp(a_k - max) is 128 partials, partial q the components q, q +
// 128, q + 256, ... in that order from 0; lane l of the walker's warp adds
// the partials l, l + 32, l + 64, l + 96 in that order from 0, and a
// butterfly adds the lanes. The max needs no exponent: a_k is a decreasing
// function of |v - s_k| with every rounding (each step is monotone), so the
// max is the exponent at the smallest |v - s_k|, found exactly in any order.
// Each a_k is then computed once, in its partial's sum, and none is held in
// registers (sixteen float64 exponents a lane, live across the division's
// slow-path call, spilled).
#define KDE_PARTIALS 128

__device__ __forceinline__ double kde_exponent(double d, double bw) {
    const double zz = __ddiv_rn(d, bw);
    return __dmul_rn(-0.5, __dmul_rn(zz, zz));
}

// The smallest |v - s_k| over partial q's components (inf where it has none).
__device__ __forceinline__ double kde_partial_distance(double v, const double* comp, int n, int q) {
    double dmin = INFINITY;
    for (int k = q; k < n; k += KDE_PARTIALS) dmin = fmin(dmin, fabs(__dsub_rn(v, comp[k])));
    return dmin;
}

// Partial q's sum of exp(a_k - m), its components in order, from 0.
__device__ __forceinline__ double kde_partial_sum(double v, const double* comp, int n, double bw,
                                                  int q, double m) {
    double s = 0.0;
    for (int k = q; k < n; k += KDE_PARTIALS)
        s = __dadd_rn(s, exp(__dsub_rn(kde_exponent(__dsub_rn(v, comp[k]), bw), m)));
    return s;
}

// The log-density from the max m (finite) and the 128 partials part[]:
// every lane of the warp calls it and returns the same bits.
__device__ __forceinline__ double kde_finish(const double* part, double m, double lognorm) {
    const int lane = threadIdx.x & 31;
    double t = 0.0;
#pragma unroll
    for (int g = 0; g < KDE_PARTIALS / 32; ++g) t = __dadd_rn(t, part[32 * g + lane]);
    return __dsub_rn(__dadd_rn(log(warp_sum(t)), m), lognorm);
}

// The KDE prior on the 32 lanes of one warp (K10, the half-step): all
// lanes call it with the same v; lane l takes the partials l, l + 32, l +
// 64, l + 96.
__device__ __forceinline__ double kde_logp(double v, const double* comp, int n, double bw,
                                           double lognorm) {
    const int lane = threadIdx.x & 31;
    constexpr int G = KDE_PARTIALS / 32;
    double dmin = INFINITY;
#pragma unroll
    for (int g = 0; g < G; ++g) dmin = fmin(dmin, kde_partial_distance(v, comp, n, 32 * g + lane));
    const double m = kde_exponent(warp_min(dmin), bw);
    if (!(m > -INFINITY)) return -INFINITY;
    double t = 0.0;
#pragma unroll
    for (int g = 0; g < G; ++g) t = __dadd_rn(t, kde_partial_sum(v, comp, n, bw, 32 * g + lane, m));
    return __dsub_rn(__dadd_rn(log(warp_sum(t)), m), lognorm);
}

// Whether the absolute parameters p[N] lie inside every prior's open bounds
// (NaN outside), and the KDE prior's argument (its parameter: kind 3, at most
// one; selected with compile-time indices, so p stays in registers).
template <int N>
__device__ __forceinline__ bool sed_inside(const SEDParams& P, const double* p) {
    bool in = true;
#pragma unroll
    for (int i = 0; i < N; ++i) in = in && p[i] > P.p_min[i] && p[i] < P.p_max[i];
    return in;
}
template <int N>
__device__ __forceinline__ double sed_kde_arg(const SEDParams& P, const double* p) {
    double v = p[0];
#pragma unroll
    for (int i = 1; i < N; ++i)
        if (P.prior_kind[i] == 3) v = p[i];
    return v;
}

// The prior sum 0 + prior_0 + prior_1 (+ prior_2) in float64, the order of
// the JAX package's loop, inside the bounds, the KDE prior's term given.
template <int N>
__device__ __forceinline__ double sed_prior_sum(const SEDParams& P, const double* p, double kde) {
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const double v = p[i];
        double l;
        if (P.prior_kind[i] == 0) {
            l = 0.0;
        } else if (P.prior_kind[i] == 1) {
            l = -log(v);
        } else if (P.prior_kind[i] == 2) {
            const double zz = __ddiv_rn(__dsub_rn(v, P.mean[i]), P.stddev[i]);
            l = __dmul_rn(-0.5, __dmul_rn(zz, zz));
        } else {
            l = kde;
        }
        sum = __dadd_rn(sum, l);
    }
    return sum;
}

// The policy of K10, its half-step and its run form: a warp per walker, not
// batched (every lane holds the warp's one walker, which the KDE prior's
// lanes need), 8 warps a block (fewer for a small ensemble: 5 at the path's
// 10 walkers; the run form's block: stretch.cuh).
// N: the walker's dimension at compile time, 2 (T, R) or 3 (with sigma).
template <typename C, int N>
struct SEDWarpModel {
    typedef SEDParams Params;
    typedef SEDData<C> Data;
    typedef SEDWalker<C> Walker;
    static constexpr int warps_per_block = 8;
    static constexpr bool batched = false;
    static constexpr int ndim = N;
    static constexpr bool own_prior = true;

    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return sed_stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return sed_stage<C>(P, smem, use_smem);
    }
    static __device__ Walker walker(const double* p, const Params& P) {
        Walker w;
        w.T = (C)p[0];
        w.R = (C)p[1];
        w.sig = P.use_sigma ? p[N - 1] : 0.0;
        return w;
    }
    // The priors' sum (sed_prior_sum); -inf outside the open bounds (NaN
    // included), the branch uniform over the warp (every lane holds the same
    // walker), which evaluates the KDE prior on its 32 lanes.
    static __device__ double log_prior(const Params& P, const Data& d, const double* p) {
        if (!sed_inside<N>(P, p)) return -INFINITY;
        const double kde = P.n_kde > 0 ? kde_logp(sed_kde_arg<N>(P, p), d.kde, (int)P.n_kde,
                                                  P.kde_bandwidth, P.kde_lognorm)
                                       : 0.0;
        return sed_prior_sum<N>(P, p, kde);
    }
    // The run form's prior (stretch.cuh, block_prior): log_prior's bits,
    // the KDE prior over the whole block. Walker i's warp writes its KDE
    // argument; the block's threads take the (walker, partial) pairs, a
    // partial a thread (several past half 8): each warp's smallest distance
    // over its 32 partials, a barrier, each partial's sum, a barrier; walker
    // i's warp adds them up (kde_finish). Scratch: the arguments (half; NaN
    // where a walker needs no KDE term), the warps' distances (half, 4), the
    // partials (half, 128).
    static constexpr bool block_prior = true;
    static __host__ __device__ size_t block_prior_doubles(const Params& P, int half) {
        return P.n_kde > 0 ? (size_t)half * (1 + KDE_PARTIALS / 32 + KDE_PARTIALS) : 0;
    }
    static int block_prior_warps(const Params& P, int half) {
        return P.n_kde > 0 ? half * (KDE_PARTIALS / 32) : half;   // a partial a thread
    }
    static __device__ double block_log_prior(const Params& P, const Data& d, const double* p,
                                             bool own, int i, int half, double* scratch) {
        if (P.n_kde == 0) return own ? log_prior(P, d, p) : -INFINITY;   // (uniform)
        constexpr int G = KDE_PARTIALS / 32;
        static_assert(G == 4, "four warps' distances a walker");
        double* v = scratch;
        double* wmin = v + half;
        double* part = wmin + G * half;
        const int lane = threadIdx.x & 31, n = (int)P.n_kde;
        const bool inside = own && sed_inside<N>(P, p);
        if (own && lane == 0) v[i] = inside ? sed_kde_arg<N>(P, p) : NAN;
        __syncthreads();
        // a thread's tasks t, t + blockDim.x, ...: a warp's 32 threads share
        // their walker (and whether it is live) and their number of tasks
        const int tasks = half * KDE_PARTIALS;
        for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
            const int w = t / KDE_PARTIALS, q = t % KDE_PARTIALS;
            const bool live = !isnan(v[w]);
            const double dmin = warp_min(live ? kde_partial_distance(v[w], d.kde, n, q)
                                              : INFINITY);
            if (live && lane == 0) wmin[w * G + q / 32] = dmin;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
            const int w = t / KDE_PARTIALS, q = t % KDE_PARTIALS;
            if (isnan(v[w])) continue;
            const double* wm = wmin + w * G;
            const double m = kde_exponent(fmin(fmin(wm[0], wm[1]), fmin(wm[2], wm[3])),
                                          P.kde_bandwidth);
            if (m > -INFINITY) part[t] = kde_partial_sum(v[w], d.kde, n, P.kde_bandwidth, q, m);
        }
        __syncthreads();
        if (!inside) return -INFINITY;
        const double* wm = wmin + i * G;
        const double m = kde_exponent(fmin(fmin(wm[0], wm[1]), fmin(wm[2], wm[3])),
                                      P.kde_bandwidth);
        const double kde = m > -INFINITY ? kde_finish(part + i * KDE_PARTIALS, m, P.kde_lognorm)
                                         : -INFINITY;
        return sed_prior_sum<N>(P, p, kde);
    }
    // The Gaussian log-likelihood: lane l sums the float64 terms of points
    // l, l + 32, ... in that order, a butterfly sums the lanes; -inf where it
    // is not finite.
    static __device__ double log_likelihood_warp(const Walker& w, const Data& d,
                                                 const Params& P) {
        const int Np = (int)P.n_points, K = (int)P.n_coef;
        double acc = 0.0;
        for (int n = threadIdx.x & 31; n < Np; n += 32) {
            const double y_fit = __dmul_rn((double)sed_flux<C>(n, w.T, w.R, d, K),
                                           P.inv_yscale);
            const double r = __dsub_rn(d.y[n], y_fit);
            double sigma2 = __dmul_rn(d.dy[n], d.dy[n]);
            if (P.use_sigma) {
                const double sg = __dmul_rn(w.sig, d.su[n]);
                sigma2 = __dadd_rn(sigma2, __dmul_rn(sg, sg));
            }
            acc = __dadd_rn(acc, __dadd_rn(log(__dmul_rn(6.283185307179586, sigma2)),
                                           __ddiv_rn(__dmul_rn(r, r), sigma2)));
        }
        acc = warp_sum(acc);
        const double ll = __dadd_rn(__dmul_rn(-0.5, acc), P.offset);
        return isfinite(ll) ? ll : -INFINITY;
    }
};

template <typename C>
using SEDWarpModel2 = SEDWarpModel<C, 2>;
template <typename C>
using SEDWarpModel3 = SEDWarpModel<C, 3>;

// ------------------------------------------------------------------ launch

extern "C" {

// K10 launch: the log-posterior (W,) float64 of the walker states q (W,
// ndim), a warp per walker (logpost_warp_kernel over SEDWarpModel of the
// walker's dimension, 2 or 3). Returns 0 or a cudaError_t code.
int sed_logpost_launch(const SEDParams* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, double* out, void* stream) {
    if (P->ndim == 2)
        return launch_logpost<SEDWarpModel2>(P, device, compute_f64, q, q_f64, W, out, stream);
    if (P->ndim == 3)
        return launch_logpost<SEDWarpModel3>(P, device, compute_f64, q, q_f64, W, out, stream);
    return (int)cudaErrorInvalidValue;
}

// K10's half-step launch (stretch_half_step_kernel over SEDWarpModel, a warp
// per walker). chain_x/chain_lp may be null. Returns 0 or a cudaError_t code.
int sed_half_step_launch(const SEDParams* P, int device, int compute_f64, void* x,
                         int state_f64, double* logp, int half, int h, const void* u_z,
                         const long long* j, const void* u_acc, double a, void* chain_x,
                         int chain_x_f64, void* chain_lp, int chain_lp_f64, int* n_accept,
                         void* stream) {
    if (P->ndim == 2)
        return launch_half_step<SEDWarpModel2>(P, device, compute_f64, x, state_f64, logp, half,
                                               h, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                               chain_lp, chain_lp_f64, n_accept, stream);
    if (P->ndim == 3)
        return launch_half_step<SEDWarpModel3>(P, device, compute_f64, x, state_f64, logp, half,
                                               h, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                               chain_lp, chain_lp_f64, n_accept, stream);
    return (int)cudaErrorInvalidValue;
}

// K10's run form (stretch_run_kernel over SEDWarpModel, one block): n_prop
// proposals of the ensemble x (2, half, ndim), half <= 32, draws (n_prop, 2,
// half), the chain (n_prop / thin_by, 2, half[, ndim]) or null. Returns 0
// or a cudaError_t code.
int sed_run_launch(const SEDParams* P, int device, int compute_f64, void* x, int state_f64,
                   double* logp, int half, int n_prop, int thin_by, const void* u_z,
                   const long long* j, const void* u_acc, double a, void* chain_x,
                   int chain_x_f64, void* chain_lp, int chain_lp_f64, int* n_accept,
                   void* stream) {
    if (P->ndim == 2)
        return launch_run<SEDWarpModel2>(P, device, compute_f64, x, state_f64, logp, half, n_prop,
                                         thin_by, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                         chain_lp, chain_lp_f64, n_accept, stream);
    if (P->ndim == 3)
        return launch_run<SEDWarpModel3>(P, device, compute_f64, x, state_f64, logp, half, n_prop,
                                         thin_by, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                         chain_lp, chain_lp_f64, n_accept, stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
