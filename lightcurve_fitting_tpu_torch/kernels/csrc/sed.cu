// The SED log-posterior of one epoch's blackbody fit (K10) and the
// stretch-move half-step over it, for sm_90a, bound to Python through a plain
// C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K10       bolometric.py:81-140 (_make_sed_log_posterior, its table
//             branch: planck_fast without reddening), fused by XLA with
//             ops/bandtable.py:152-181 (chebyshev_bandflux) and
//             models/priors.py:124-156 (the priors, KDEPrior.logp
//             among them).
//   K10 half  parallel/sampler.py:38-57 (propose_stretch), :86-104
//             (half_update, step) applied to that log-posterior.
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
// sum), not any rate of the card. The design keeps that chain short and
// every input in shared memory:
// - a warp per walker (SEDWarpModel, not batched): lane l takes the points
//   l, l + 32, ... (one each at the path's width) and a butterfly sums
//   them; the same walker's prior on all 32 lanes;
// - the KDE prior (kind 3, the single-filter epochs' temperature prior:
//   logsumexp over at most 512 components) split over the warp's lanes,
//   lane l taking the components l, l + 32, ... (16 at most), the max and
//   then the sum combined by butterflies. One lane per walker would walk all
//   512 components in a dependent chain, ~16x the latency, while the other
//   31 lanes of the warp wait; the walkers a warp per walker leave no lane
//   free to take another walker's prior. The components are staged with
//   the table rows once a block (4 KB in float64 at 512);
// - every float64 operation after the flux, and the recurrence's links,
//   rounded by hand (the _rn intrinsics: no contraction), so the batch
//   log-posterior (logpost_warp_kernel, the initial state) and the
//   half-step (stretch_half_step_kernel), each inlining the policy once,
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

// The KDE prior's log-density at v (KDEPrior.logp): logsumexp over the
// components of -0.5 ((v - s_k) / bw)^2, minus its log normalization. All 32
// lanes call it with the same v: lane l takes the components l, l + 32, ...,
// a butterfly gives the max, then the sum of exp(a_k - max). Every lane
// returns the same bits. -inf where every term is -inf (torch.logsumexp
// shifts by 0 there: log(0)).
__device__ __forceinline__ double kde_logp(double v, const double* comp, int n, double bw,
                                           double lognorm) {
    const int lane = threadIdx.x & 31;
    double m = -INFINITY;
    for (int k = lane; k < n; k += 32) {
        const double zz = __ddiv_rn(__dsub_rn(v, comp[k]), bw);
        m = fmax(m, __dmul_rn(-0.5, __dmul_rn(zz, zz)));
    }
    m = warp_max(m);
    if (!(m > -INFINITY)) return -INFINITY;
    double s = 0.0;
    for (int k = lane; k < n; k += 32) {
        const double zz = __ddiv_rn(__dsub_rn(v, comp[k]), bw);
        s = __dadd_rn(s, exp(__dsub_rn(__dmul_rn(-0.5, __dmul_rn(zz, zz)), m)));
    }
    s = warp_sum(s);
    return __dsub_rn(__dadd_rn(log(s), m), lognorm);
}

// The policy of K10 and its half-step: a warp per walker, not batched (every
// lane holds the warp's one walker, which the KDE prior's lanes need), 8
// warps a block (fewer for a small ensemble: 5 at the path's 10 walkers).
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
    // The prior sum 0 + prior_0 + prior_1 (+ prior_2) in float64, the order
    // of the JAX package's loop; -inf outside the open bounds (NaN included),
    // the branch uniform over the warp (every lane holds the same walker).
    static __device__ double log_prior(const Params& P, const Data& d, const double* p) {
        double sum = 0.0;
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const double v = p[i];
            if (!(v > P.p_min[i] && v < P.p_max[i])) return -INFINITY;
            double l;
            if (P.prior_kind[i] == 0) {
                l = 0.0;
            } else if (P.prior_kind[i] == 1) {
                l = -log(v);
            } else if (P.prior_kind[i] == 2) {
                const double zz = __ddiv_rn(__dsub_rn(v, P.mean[i]), P.stddev[i]);
                l = __dmul_rn(-0.5, __dmul_rn(zz, zz));
            } else {
                l = kde_logp(v, d.kde, (int)P.n_kde, P.kde_bandwidth, P.kde_lognorm);
            }
            sum = __dadd_rn(sum, l);
        }
        return sum;
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

}  // extern "C"
