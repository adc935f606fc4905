// The companion-shocking kernels for sm_90a, bound to Python through a plain
// C interface (ctypes): K8, the SiFTO spline, and the fused log-posterior of
// CompanionShocking, CompanionShocking2 and CompanionShocking3 with its
// stretch-move half-step and its tempered-ladder kernels.
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K8  models/companion_shocking.py:45-59 (_ppoly_batched) through
//       _sifto_points (:186-195), ops/interpolate.py:55-74 (ppoly_eval): per
//       point the template phase (t - t_peak - dt_{U,i}) / s, the knot search
//       searchsorted(side="right") - 1 clipped to [0, S-2], a Horner cubic
//       with the band's (4, S-1) coefficients, NaN outside the knots, then 0.
//   The CS log-posterior: fitting.py:62-68 with models/base.py:278-288 (ll)
//       over companion_shocking.py:120-126 (_tr_points, the Kasen T and R),
//       :197-201 (_kasen_points), :243-296 (_eval_points of CS1-3) and
//       ops/bandtable.py:152-181 (chebyshev_bandflux); its half-step
//       parallel/sampler.py:38-57, :86-104, :205-225 (stretch.cuh over
//       CSWarpModel) and the tempered ladder's parallel/evidence.py:60-83
//       (ladder.cuh over CSWarpModel) and :229-235 (over CSModel).
//
// What bounds it on the H100: FP32 ALU and special-function work. One
// evaluation runs per point the Chebyshev table's Clenshaw recurrence (24
// steps, ~75 flops), ~10 special functions (the Kasen power laws, log T, exp)
// and K8 (a 7-step binary search over the 103 knots and a cubic); the
// per-point data (25.2 KB in float32 at 108 points, the SiFTO rows included;
// 49.2 KB in float64) is shared by every walker, so device-memory traffic is
// negligible.
// What the design does about it: the per-point constants and the per-band
// SiFTO rows (B x 4 x (S-1), 9.8 KB in float32 for 6 bands) staged once per
// block in shared memory; the walker-constant parts of the Kasen product,
// the CS3 viewing-angle factor and the scale factors hoisted out of the
// point loop (cs_walker); an out-of-prior walker returns -inf without
// touching the likelihood. The batch log-posterior and K6b run one thread
// per walker, as K1. The half-step and K6a run a warp per walker
// (CSWarpModel): a thread per walker left the fits' widths a few warps an
// SM (half 16 is one warp on one SM, half 16384 four warps on each), whose
// 108 dependent point evaluations (the recurrence, the knot search) set
// both at ~0.15-0.2 ms. The lanes split the points (lane l takes l, l + 32,
// ...: four evaluations at most). A warp per walker repeats the walker's
// prologue (the proposal, the prior, the float64 Kasen constant's pow and
// log) on all 32 lanes, ~35% of its time at the large widths, so a warp
// takes its walkers in batches (stretch.cuh, warp_batch_ll): lane l forms
// walker l's prologue, and for each walker the lanes evaluate its points on
// its constants, shuffled from its lane. The grid holds the blocks resident
// at once (32 warps a block in float32: one block an SM, the tables staged
// once an SM), the batch is as large as that takes. The points share one
// __device__ function (cs_point) in both forms, which differ only in the
// order of the residual sum; the bits do not depend on the batch. The
// standalone K8 strides over (walker, point) elements with the rows staged
// once per block.
//
// Dtype semantics: as K1, parameters are absolute float64 and cast to the
// compute type C after the epoch centring (tt = C(t - t_ref) - C(t_exp -
// t_ref)). The Kasen temperature T = 25 (a13^36 Mc kappa^-35 tt^-74)^(1/144):
// in float64 the JAX graph, operation order kept (the walker constant
// (a13^36 Mc) kappa^-35 then the per-point power laws); in float32 the
// product would underflow (tt^-74 for tt > 3.3 d), so the walker constant K
// is formed in float64 and T = 25 exp((ln K - 74 ln tt) / 144) in C, 0 where
// tt <= 0 or K <= 0 (power's zeros), as the plain version computes it.

#include "ladder.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/cs.py (_CSParams) matches it field for field.
struct CSParams {
    const void* t_centered;   // (N,) compute type: t - t_ref
    const void* y;            // (N,) y / yscale
    const void* inv_dy;       // (N,) yscale / dy
    const void* dy;           // (N,) dy / yscale
    const void* sigma_units;  // (N,)
    const void* s_a;          // (N,)
    const void* s_b;          // (N,)
    const void* coef;         // (N, n_coef) Chebyshev rows
    const void* sifto_rows;   // (B, 4, S-1) SiFTO coefficients per band
    const void* sifto_knots;  // (S,)
    const long long* sifto_band;  // (N,) each point's row
    const bool* is_U;         // (N,)
    const bool* is_i;         // (N,)
    const bool* is_r;         // (N,)
    long long n_points;
    long long n_coef;
    long long n_bands;
    long long n_knots;
    long long ndim;
    long long use_sigma;
    long long has_affine;
    long long variant;        // 1 CompanionShocking, 2 CompanionShocking2, 3 CompanionShocking3
    double t_ref;
    double inv_yscale;
    double log_norm_const;
    double ll_offset;
    double kappa;
    double kappa_m35;         // kappa^-35, float64
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

// The standalone K8's arguments; the same 8-byte layout rule (mirror:
// kernels/cs.py _SiftoParams).
struct SiftoParams {
    const void* t_centered;   // (N,) compute type: t - t_ref
    const double* t_peak;     // (W,) absolute
    const double* stretch;    // (W,)
    const double* dtU;        // (W,), or null: no U shift
    const double* dti;        // (W,), or null: no i shift
    const void* rows;         // (B, 4, S-1)
    const void* knots;        // (S,)
    const long long* band;    // (N,)
    const bool* is_U;         // (N,)
    const bool* is_i;         // (N,)
    void* out;                // (W, N) compute type
    long long n_walkers;
    long long n_points;
    long long n_bands;
    long long n_knots;
    double t_ref;
};

// K8's device function: the SiFTO term at template phase x of the band whose
// (4, S-1) coefficients are row, over the S knots: searchsorted(side="right")
// - 1 clipped to [0, S-2], then a Horner cubic; 0 outside [knots[0],
// knots[S-1]] and for a NaN phase (the JAX graph's NaN, then nan_to_num).
template <typename C>
__device__ __forceinline__ C sifto_value(const C* knots, int S, const C* row, C x) {
    if (!(x >= knots[0] && x <= knots[S - 1])) return C(0);
    int lo = 0, hi = S;  // the first knot > x
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (knots[mid] <= x) lo = mid + 1;
        else hi = mid;
    }
    int i = lo - 1;
    i = i < 0 ? 0 : (i > S - 2 ? S - 2 : i);
    const int M = S - 1;
    const C t = x - knots[i];
    const C v = ((row[i] * t + row[M + i]) * t + row[2 * M + i]) * t + row[3 * M + i];
    return isnan(v) ? C(0) : v;
}

// K8: out[w, n] = the SiFTO term of point n for walker w, elements strided
// over the grid; the rows and knots staged once per block.
template <typename C>
__global__ void __launch_bounds__(LP_THREADS) sifto_kernel(const SiftoParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    C* s = reinterpret_cast<C*>(smem_raw);
    const int S = (int)P.n_knots;
    const C* rows = stage_array((const C*)P.rows, P.n_bands * 4 * (S - 1), s);
    const C* knots = stage_array((const C*)P.knots, (long long)S, s);
    __syncthreads();
    const long long N = P.n_points, total = P.n_walkers * N;
    const C* tc = (const C*)P.t_centered;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const long long w = e / N, n = e - w * N;
        const C ph = tc[n] - (C)(P.t_peak[w] - P.t_ref);
        C dt = C(0);
        if (P.dtU != nullptr && P.is_U[n]) dt = (C)P.dtU[w];
        if (P.dti != nullptr && P.is_i[n]) dt = (C)P.dti[w];
        const C arg = (ph - dt) / (C)P.stretch[w];
        ((C*)P.out)[e] = sifto_value<C>(knots, S, rows + P.band[n] * 4 * (S - 1), arg);
    }
}

template <typename C>
struct CSData {
    const long long* band;
    const C* coef;
    const C* tc;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    const C* s_a;
    const C* s_b;
    const C* rows;
    const C* knots;
    const bool* is_U;
    const bool* is_i;
    const bool* is_r;
};

template <typename C>
__host__ __device__ inline size_t cs_stage_bytes(const CSParams& P) {
    const size_t N = (size_t)P.n_points;
    return sizeof(long long) * N + 3 * N
           + sizeof(C) * (N * (size_t)(P.n_coef + 7)
                          + (size_t)(P.n_bands * 4 * (P.n_knots - 1) + P.n_knots));
}

// Copy the per-point constants, the SiFTO rows and knots into shared memory
// (every thread of the block takes part, so call it before any thread
// returns), or point at global memory when they exceed the block's limit.
template <typename C>
__device__ CSData<C> stage_cs(const CSParams& P, unsigned char* smem, int use_smem) {
    const long long N = P.n_points;
    CSData<C> d;
    if (use_smem) {
        long long* si = reinterpret_cast<long long*>(smem);
        d.band = stage_array(P.sifto_band, N, si);
        C* s = reinterpret_cast<C*>(si);
        d.coef = stage_array((const C*)P.coef, N * P.n_coef, s);
        d.tc = stage_array((const C*)P.t_centered, N, s);
        d.y = stage_array((const C*)P.y, N, s);
        d.inv_dy = stage_array((const C*)P.inv_dy, N, s);
        d.dy = stage_array((const C*)P.dy, N, s);
        d.su = stage_array((const C*)P.sigma_units, N, s);
        d.s_a = stage_array((const C*)P.s_a, N, s);
        d.s_b = stage_array((const C*)P.s_b, N, s);
        d.rows = stage_array((const C*)P.sifto_rows, P.n_bands * 4 * (P.n_knots - 1), s);
        d.knots = stage_array((const C*)P.sifto_knots, P.n_knots, s);
        bool* sb = reinterpret_cast<bool*>(s);
        d.is_U = stage_array(P.is_U, N, sb);
        d.is_i = stage_array(P.is_i, N, sb);
        d.is_r = stage_array(P.is_r, N, sb);
        __syncthreads();
    } else {
        d.band = P.sifto_band;
        d.coef = (const C*)P.coef;
        d.tc = (const C*)P.t_centered;
        d.y = (const C*)P.y;
        d.inv_dy = (const C*)P.inv_dy;
        d.dy = (const C*)P.dy;
        d.su = (const C*)P.sigma_units;
        d.s_a = (const C*)P.s_a;
        d.s_b = (const C*)P.s_b;
        d.rows = (const C*)P.sifto_rows;
        d.knots = (const C*)P.sifto_knots;
        d.is_U = P.is_U;
        d.is_i = P.is_i;
        d.is_r = P.is_r;
    }
    return d;
}

// The walker's constants of the CS log-likelihood at absolute parameters
// p[ndim]: CS1 (t_0, a13, Mc_v9_7, t_peak, s, rr, ri, rU), CS2 (t_0, a13,
// Mc_v9_7, t_peak, s, dtU, dti) or CS3 (t_0, a13, theta, t_peak, s, dtU,
// dti), then sigma with use_sigma. Every lane of a warp forms them on the
// same bits: the warp issues these instructions once whether one lane or 32
// run them, so computing them on lane 0 and broadcasting would only add the
// shuffles.
template <typename C>
struct CSWalker {
    double K;   // (a13^36 Mc) kappa^-35, float64
    C t_exp, t_peak, stretch, ln_k, kM, f_kasen, rU, rr, ri, dtU, dti, inv_yscale, sig;
};

template <typename C>
__device__ __forceinline__ CSWalker<C> cs_walker(const double* p, const CSParams& P) {
    CSWalker<C> w;
    const int ndim = (int)P.ndim;
    const int variant = (int)P.variant;
    w.t_exp = (C)(p[0] - P.t_ref);
    w.t_peak = (C)(p[3] - P.t_ref);
    w.stretch = (C)p[4];
    const double Mc = variant == 3 ? 1.0 : p[2];
    // the walker constants of the Kasen power laws, in the JAX graph's order
    w.K = (pow(p[1], 36.0) * Mc) * P.kappa_m35;
    w.ln_k = w.K > 0.0 ? (C)log(w.K) : (C)(-INFINITY);
    w.kM = (C)P.kappa * (C)Mc;
    // the factors of the Kasen (f_kasen, and rU on U) and SiFTO (rr on r, ri
    // on i) terms, and the U and i time shifts
    w.f_kasen = C(1), w.rU = C(1), w.rr = C(1), w.ri = C(1), w.dtU = C(0), w.dti = C(0);
    if (variant == 1) {
        w.rr = (C)p[5];
        w.ri = (C)p[6];
        w.rU = (C)p[7];
    } else {
        w.dtU = (C)p[5];
        w.dti = (C)p[6];
    }
    if (variant == 3) {  // Brown et al. (2012) viewing angle, theta in degrees
        const double th = p[2] * (3.141592653589793 / 180.0);
        w.f_kasen = (C)((0.5 * cos(th) + 0.5) * (0.14 * (th * th) - 0.4 * th + 1.0));
    }
    w.inv_yscale = (C)P.inv_yscale;
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    return w;
}

// Point n's residual term: the Kasen T and R, the Chebyshev band table's
// Clenshaw recurrence, K8's SiFTO value and the Gaussian residual. The
// thread and warp forms of the log-likelihood share it, so that they differ
// only in the order of their residual sums.
template <typename C>
__device__ __forceinline__ C cs_point(int n, const CSWalker<C>& w, const CSData<C>& d,
                                      const CSParams& P) {
    const bool f64 = sizeof(C) == sizeof(double);
    const int K1 = (int)P.n_coef;
    const int S = (int)P.n_knots;
    const C tt = d.tc[n] - w.t_exp;
    C T;
    if (f64) {
        T = C(25) * power0((C)w.K * power0(tt, C(-74)), C(1.0 / 144.0));
    } else {
        T = tt > C(0) ? C(25) * m_exp((w.ln_k - C(74) * m_log(tt)) * C(1.0 / 144.0)) : C(0);
    }
    const C R = C(2.7) * power0(w.kM * m_pow(tt, C(7)), C(1.0 / 9.0));
    C kasen = C(0);
    if (T > C(0)) {  // T <= 0 (t before t_exp) or NaN: zero flux (K1's loop)
        C s = m_log(T) * d.s_a[n] - d.s_b[n];
        s = s < C(-1) ? C(-1) : (s > C(1) ? C(1) : s);  // clip, NaN stays NaN
        const C two_s = C(2) * s;
        const C* c = d.coef + (size_t)n * K1;
        C b1 = C(0), b2 = C(0);
        for (int k = K1 - 1; k >= 1; --k) {
            const C b0 = two_s * b1 - b2 + c[k];
            b2 = b1;
            b1 = b0;
        }
        const C ln_g = s * b1 - b2 + c[0];
        kasen = R * R * m_exp(ln_g);
    }
    const bool U = d.is_U[n], I = d.is_i[n];
    const C dt = U ? w.dtU : (I ? w.dti : C(0));
    const C arg = ((d.tc[n] - w.t_peak) - dt) / w.stretch;
    const C sif = sifto_value<C>(d.knots, S, d.rows + d.band[n] * 4 * (S - 1), arg);
    const C kf = U ? w.f_kasen * w.rU : w.f_kasen;
    const C sf = d.is_r[n] ? w.rr : (I ? w.ri : C(1));
    const C y_fit = (kasen * kf + sif * sf) * w.inv_yscale;
    return residual_term<C>(P.use_sigma, y_fit, d.y[n], d.inv_dy[n], d.dy[n], d.su[n], w.sig);
}

// The Gaussian log-likelihood of one walker at absolute parameters p[ndim]
// (cs_walker's), float64, -inf when not finite. It does not look at the
// priors. One thread walks the points in order.
template <typename C>
__device__ double cs_log_likelihood(const double* p, const CSData<C>& d, const CSParams& P) {
    const CSWalker<C> w = cs_walker<C>(p, P);
    const int N = (int)P.n_points;
    C acc = C(0);
    for (int n = 0; n < N; ++n) acc += cs_point<C>(n, w, d, P);
    return finish_log_likelihood<C>(acc, P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The same log-likelihood of the walker with constants w, computed by the
// 32 lanes of a warp together (every lane returns the same bits): lane l
// takes the points l, l + 32, l + 64, ... in time order, sums its residual
// terms in that order, and a butterfly shuffle sums the lanes, a fixed order
// from run to run. CS points have equal loop lengths but for the walker's
// own skips (the Clenshaw recurrence before t_0, the SiFTO cubic outside
// the knots), which no static order evens out.
template <typename C>
__device__ double cs_log_likelihood_warp(const CSWalker<C>& w, const CSData<C>& d,
                                         const CSParams& P) {
    const int N = (int)P.n_points;
    C acc = C(0);
    for (int n = threadIdx.x & 31; n < N; n += 32) acc += cs_point<C>(n, w, d, P);
    return finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The log-posterior of one walker: the prior sum (-inf outside the open
// bounds, and then the likelihood is not evaluated) plus the log-likelihood.
template <typename C>
__device__ double cs_log_posterior(const double* p, const CSData<C>& d, const CSParams& P) {
    const double lprior = log_prior(P, p);
    if (!isfinite(lprior)) return -INFINITY;
    return lprior + cs_log_likelihood<C>(p, d, P);
}

// The model policy of stretch.cuh and ladder.cuh for the companion-shocking
// models in compute type C.
template <typename C>
struct CSModel {
    typedef CSParams Params;
    typedef CSData<C> Data;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return cs_stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return stage_cs<C>(P, smem, use_smem);
    }
    static __device__ double log_posterior(const double* p, const Data& d, const Params& P) {
        return cs_log_posterior<C>(p, d, P);
    }
    static __device__ double log_likelihood(const double* p, const Data& d, const Params& P) {
        return cs_log_likelihood<C>(p, d, P);
    }
};

// The policy of the CS half-step and of K6a over CS: a warp per walker
// (stretch_half_step_kernel and tempered_half_step_kernel with WARP), 32
// warps a block in float32 (one block an SM: the tables staged once an SM;
// 64 registers a thread) and 16 in float64 (whose kernels need ~70),
// batched: the grid holds only the blocks resident at once, and a warp
// takes its walkers in batches whose prologues (the proposal, the prior and
// cs_walker's float64 constants, ~35% of a walker's time when every lane
// repeats them) run one walker a lane (warp_layout).
template <typename C>
struct CSWarpModel : CSModel<C> {
    typedef CSWalker<C> Walker;
    static constexpr int warps_per_block = sizeof(C) == sizeof(float) ? 32 : 16;
    static constexpr bool batched = true;
    static __device__ Walker walker(const double* p, const CSParams& P) {
        return cs_walker<C>(p, P);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const CSData<C>& d,
                                                 const CSParams& P) {
        return cs_log_likelihood_warp<C>(w, d, P);
    }
};

// out[w] = CS log-posterior of walker state q[w, :] (affine-mapped when
// has_affine), for the initial state and LogPosterior.forward.
template <typename C, typename S>
__global__ void __launch_bounds__(LP_THREADS)
cs_logpost_kernel(const CSParams P, const S* __restrict__ q, int W,
                  double* __restrict__ out, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const CSData<C> d = stage_cs<C>(P, smem_raw, use_smem);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= W) return;
    const int ndim = (int)P.ndim;
    double p[LP_MAX_DIM];
    for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, q[(size_t)i * ndim + k]);
    out[i] = cs_log_posterior<C>(p, d, P);
}

// ------------------------------------------------------------------ launch

template <typename C, typename S>
static int launch_cs_logpost(const CSParams& P, const void* q, int W, double* out,
                             cudaStream_t stream) {
    auto kernel = cs_logpost_kernel<C, S>;
    int use_smem = 0;
    const size_t bytes = cs_stage_bytes<C>(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const int blocks = (W + LP_THREADS - 1) / LP_THREADS;
    kernel<<<blocks, LP_THREADS, use_smem ? bytes : 0, stream>>>(P, (const S*)q, W, out,
                                                                 use_smem);
    return (int)cudaGetLastError();
}

template <typename C>
static int launch_sifto(const SiftoParams& P, cudaStream_t stream) {
    auto kernel = sifto_kernel<C>;
    const size_t bytes = sizeof(C) * (size_t)(P.n_bands * 4 * (P.n_knots - 1) + P.n_knots);
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // rows larger than shared memory
    const long long total = P.n_walkers * P.n_points;
    long long blocks = (total + LP_THREADS - 1) / LP_THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;  // a grid-stride loop amortizes the staging
    kernel<<<(unsigned)blocks, LP_THREADS, bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

extern "C" {

// K8 launch. Returns 0 or a cudaError_t code.
int sifto_launch(const SiftoParams* P, int device, int compute_f64, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->n_walkers <= 0 || P->n_points <= 0) return 0;
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return compute_f64 ? launch_sifto<double>(*P, s) : launch_sifto<float>(*P, s);
}

// CS log-posterior launch. Returns 0 or a cudaError_t code.
int cs_logpost_launch(const CSParams* P, int device, int compute_f64, const void* q, int q_f64,
                      int W, double* out, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->n_knots < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (compute_f64)
        return q_f64 ? launch_cs_logpost<double, double>(*P, q, W, out, s)
                     : launch_cs_logpost<double, float>(*P, q, W, out, s);
    return q_f64 ? launch_cs_logpost<float, double>(*P, q, W, out, s)
                 : launch_cs_logpost<float, float>(*P, q, W, out, s);
}

// CS half-step launch, a warp per walker (CSWarpModel); the arguments of
// stretch_half_step_launch (sc2_logpost.cu). Returns 0 or a cudaError_t code.
int cs_half_step_launch(const CSParams* P, int device, int compute_f64, void* x, int state_f64,
                        double* logp, int half, int h, const void* u_z, const long long* j,
                        const void* u_acc, double a, void* chain_x, int chain_x_f64,
                        void* chain_lp, int chain_lp_f64, int* n_accept, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    return launch_half_step<CSWarpModel, true>(P, device, compute_f64, x, state_f64, logp, half,
                                               h, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                               chain_lp, chain_lp_f64, n_accept, stream);
}

// K6a launch over the CS models (ladder.cuh), a warp per walker
// (CSWarpModel). Returns 0 or a cudaError_t code.
int cs_tempered_half_step_launch(const CSParams* P, int device, int compute_f64, void* x,
                                 int state_f64, double* logpri, double* logl,
                                 const double* betas, int n_rungs, int half, int h,
                                 const void* u_z, const long long* j, const void* u_acc, double a,
                                 int* n_accept, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    return launch_tempered_half_step<CSWarpModel, true>(P, device, compute_f64, x, state_f64,
                                                        logpri, logl, betas, n_rungs, half, h,
                                                        u_z, j, u_acc, a, n_accept, stream);
}

// K6b launch over the CS models (ladder.cuh). Returns 0 or a cudaError_t code.
int cs_ladder_init_launch(const CSParams* P, int device, int compute_f64, const void* x,
                          int state_f64, int n, double* logpri, double* logl, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    return launch_ladder_init<CSModel>(P, device, compute_f64, x, state_f64, n, logpri, logl,
                                       stream);
}

}  // extern "C"
