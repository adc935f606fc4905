// Fused ShockCooling2 log-posterior (K1) and stretch-move half-step (K2) for
// sm_90a, bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K1  fitting.py:62-68 make_log_posterior.log_posterior, fused by XLA with
//       models/base.py:278-288 (ll), models/shock_cooling.py:150-156
//       (ShockCooling2._tr_points), ops/mathx.py:28-57 (hot_phase, power)
//       and ops/bandtable.py:152-181 (chebyshev_bandflux).
//   K2  parallel/sampler.py:38-57 (propose_stretch), :86-95 (half_update),
//       :97-104 (step) and :205-225 (thinned_step).
//   K6a, K6b over ShockCooling2: the tempered half-step and the ladder's
//       initial state (parallel/evidence.py:60-83, :229-235), the templates
//       of ladder.cuh over SC2Model.
//   K7, K7h, K9 over ShockCooling2: the value and gradient of the
//       log-posterior (jax.value_and_grad of K1's graph), the HMC and the
//       NUTS transitions, the templates of gradient.cuh over SC2Model, whose
//       value_and_grad is sc2_value_and_grad_warp below (K7, K7h) and
//       value_and_grad_block sc2_value_and_grad_block (K9).
//
// What bounds it on the H100: FP32 ALU work. One evaluation is ~23.5k flops
// over the N = 149 points of the flagship, of which the degree-40 Clenshaw
// recurrence is 3 * deg * N ~ 17.9k; the per-point data is 26 KB in f32 and
// is shared by every walker, so device-memory traffic is negligible.
// What the design does about it: one thread per walker loops over the
// points with the per-point constants staged once per block in shared memory
// (every thread of a warp reads the same address: a broadcast, no bank
// conflicts), so the inner loop is register FMAs. The prior bounds are tested
// first and an out-of-prior walker returns -inf without touching the
// likelihood (the JAX graph evaluates it and masks it afterwards: same value).
// K1 and K2 share one __device__ function, so a proposal's log-posterior is
// bit-identical to the batch evaluation of the same point. K2 is the
// stretch_half_step_kernel template of stretch.cuh over SC2Model.
// Measured on an H100 80GB HBM3 at 700 W: K1 reaches ~6 TFLOP/s (9% of the
// FP32 peak) at 131072 walkers, and a launch never takes less than ~0.18 ms
// however few the walkers: one thread walks all points through a dependent
// Clenshaw chain, so the kernel is bound by that chain's latency, not by the
// ALU rate. Spreading a walker's points over a warp is the next step.
//
// Dtype semantics follow the JAX accelerator path exactly: parameters are
// rebuilt in f64 as offset + scale * q and the priors see those f64 values;
// tt = C(t - t_ref) - C(t_exp - t_ref); T_1, L_1, t_tr are cast to the compute
// type C; the residual sum and log_norm_const are added in C; the f64 prior
// sum plus that C value gives the f64 result. The proposal arithmetic uses
// round-to-nearest intrinsics (no FMA contraction), so a new state equals
// the plain PyTorch half-step's bit for bit whenever both accept.

#include "gradient.cuh"
#include "ladder.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/sc2.py (_SC2Params) matches it field for field.
struct SC2Params {
    const void* t_centered;   // (N,) compute type: t - t_ref
    const void* y;            // (N,) y / yscale
    const void* inv_dy;       // (N,) yscale / dy
    const void* dy;           // (N,) dy / yscale
    const void* sigma_units;  // (N,)
    const void* s_a;          // (N,)
    const void* s_b;          // (N,)
    const void* coef;         // (N, n_coef) Chebyshev rows
    long long n_points;
    long long n_coef;
    long long ndim;
    long long use_sigma;
    long long has_affine;
    double t_ref;
    double inv_yscale;
    double log_norm_const;
    double ll_offset;
    double eps_T;
    double eps_L;
    double a_model;
    double alpha;
    double c3_42;
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

template <typename C>
struct PointData {
    const C* tc;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    const C* s_a;
    const C* s_b;
    const C* coef;
};

template <typename C>
__host__ __device__ inline size_t stage_bytes(const SC2Params& P) {
    return sizeof(C) * (size_t)P.n_points * (size_t)(P.n_coef + 7);
}

// Copy the per-point constants into shared memory (every thread of the block
// takes part, so call it before any thread returns), or point at global
// memory when the table is larger than the block's shared memory.
template <typename C>
__device__ PointData<C> stage_points(const SC2Params& P, C* smem, int use_smem) {
    PointData<C> d;
    const C* src[8] = {(const C*)P.coef, (const C*)P.t_centered, (const C*)P.y,
                       (const C*)P.inv_dy, (const C*)P.dy, (const C*)P.sigma_units,
                       (const C*)P.s_a, (const C*)P.s_b};
    const C* dst[8];
    const int N = (int)P.n_points;
    if (use_smem) {
        C* s = smem;
        for (int a = 0; a < 8; ++a) {
            const int len = a == 0 ? N * (int)P.n_coef : N;
            for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = src[a][i];
            dst[a] = s;
            s += len;
        }
        __syncthreads();
    } else {
        for (int a = 0; a < 8; ++a) dst[a] = src[a];
    }
    d.coef = dst[0];
    d.tc = dst[1];
    d.y = dst[2];
    d.inv_dy = dst[3];
    d.dy = dst[4];
    d.su = dst[5];
    d.s_a = dst[6];
    d.s_b = dst[7];
    return d;
}

// The Gaussian log-likelihood of the ShockCooling2 band fluxes of one walker
// at absolute parameters p[ndim], float64; -inf when not finite. It does not
// look at the priors.
template <typename C>
__device__ double sc2_log_likelihood(const double* p, const PointData<C>& d, const SC2Params& P) {
    const int ndim = (int)P.ndim;
    const C T1 = (C)p[0];
    const C L1 = (C)p[1];
    const C t_tr = (C)p[2];
    const C t_exp = (C)(p[3] - P.t_ref);
    const C eps_T = (C)P.eps_T;
    const C eps_L = (C)P.eps_L;
    const C a_mod = (C)P.a_model;
    const C alpha = (C)P.alpha;
    const C c3 = (C)P.c3_42;
    const C inv_yscale = (C)P.inv_yscale;
    const C sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    const int N = (int)P.n_points;
    const int K = (int)P.n_coef;

    C acc = C(0);
    for (int n = 0; n < N; ++n) {
        const C tt = d.tc[n] - t_exp;
        const C T = T1 * power0(tt, eps_T);
        const C L = L1 * m_exp(-power0(a_mod * tt / t_tr, alpha)) * power0(tt, eps_L);
        const C R = c3 * m_sqrt(L) * power0(T, C(-2));
        C y_fit = C(0);
        if (T > C(0)) {  // T <= 0 (t before t_exp) or NaN: zero flux
            C s = m_log(T) * d.s_a[n] - d.s_b[n];
            s = s < C(-1) ? C(-1) : (s > C(1) ? C(1) : s);  // clip, NaN stays NaN
            const C two_s = C(2) * s;
            const C* c = d.coef + (size_t)n * K;
            C b1 = C(0), b2 = C(0);
            for (int k = K - 1; k >= 1; --k) {
                const C b0 = two_s * b1 - b2 + c[k];
                b2 = b1;
                b1 = b0;
            }
            const C ln_g = s * b1 - b2 + c[0];
            y_fit = R * R * m_exp(ln_g);
        }
        y_fit = y_fit * inv_yscale;
        acc += residual_term<C>(P.use_sigma, y_fit, d.y[n], d.inv_dy[n], d.dy[n], d.su[n], sig);
    }
    return finish_log_likelihood<C>(acc, P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The log-posterior of one walker at absolute parameters p[ndim]: the sum of
// the prior log-densities (-inf outside the open bounds, and then the
// likelihood is not evaluated) plus the log-likelihood; -inf when not finite.
template <typename C>
__device__ double sc2_log_posterior(const double* p, const PointData<C>& d, const SC2Params& P) {
    const double lprior = log_prior(P, p);
    if (!isfinite(lprior)) return -INFINITY;
    return lprior + sc2_log_likelihood<C>(p, d, P);
}

// The value and gradient of the log-posterior (K7's device function, and the
// block form of K9): the log-posterior of one walker at absolute float64
// parameters p[ndim] and its raw gradient g[ndim]. The residual terms and
// their derivatives are accumulated in the compute type C over slots of
// points: slot l takes the points n = l, l + 32, l + 64, ... in that order,
// then a butterfly shuffle sums the 32 slots in a fixed order. The warp form
// runs slot l on lane l; the block form computes each point on its own
// thread, keeps the point's factors in a workspace, and lets every warp fold
// the slots from there. Both accumulate through sc2_accumulate, so a
// walker's value and gradient have the same bits in both forms. The priors
// and their gradient (0 uniform, -1/x log-uniform, -(x - mu)/sigma^2
// Gaussian) are added in float64.
// The derivatives retrace the reverse pass of the JAX graph of K1, step for
// step (sc2_point, one copy for both forms), so the gradient is NaN exactly
// where jax.grad's is: T, L, R and the power laws of ShockCooling2._tr_points
// (zero derivative where power's base is <= 0, the double-where of
// ops/mathx.py:52-57), s = clip(a ln T - b, -1, 1) (zero where the clip is
// active), the Clenshaw derivative run alongside the recurrence (d_k = 2
// b_{k+1} + 2 s d_{k+1} - d_{k+2}, then d ln g / ds = b_1 + s d_1 - d_2), the
// flux's where(T > 0) and the Gaussian residual with or without the
// intrinsic scatter. In particular d sqrt(L) / dL = 0.5 / sqrt(L) is infinite
// where L = 0 (t <= t_exp), and 0 x inf makes d/dL_1 NaN there, as in the
// JAX graph; the callers mask it as the JAX callers do.
// -inf (and g = 0) outside the priors or where the likelihood is not finite.

// The walker's parameters in the compute type, and the model's constants.
template <typename C>
struct SC2Walker {
    C T1, L1, t_tr, t_exp, eT, eL, a_mod, alpha, c3, inv_yscale, sig;
};

// One point's part of the six sums, as the factors the sums take it in: the
// residual term r * r (r alone with the intrinsic scatter), ct_T * ptT,
// ct_L1E * E, the t_tr and tt derivatives, and the sigma derivative s0 * s1.
template <typename C>
struct SC2Point {
    C r, t0, t1, l0, l1, ttr, tt, s0, s1;
};

// The residual sum and its derivatives in T_1, L_1, t_tr, tt (tt = t -
// t_exp, so d/dt_exp = -d/dtt) and sigma.
template <typename C>
struct SC2Sums {
    C acc = C(0), dT1 = C(0), dL1 = C(0), dttr = C(0), dtt = C(0), dsig = C(0);
};

template <typename C>
__device__ __forceinline__ void sc2_accumulate(SC2Sums<C>& s, const SC2Point<C>& q,
                                               bool use_sigma) {
    if (use_sigma) {
        s.acc += q.r;
        s.dsig += q.s0 * q.s1;
    } else {
        s.acc += q.r * q.r;
    }
    s.dT1 += q.t0 * q.t1;
    s.dL1 += q.l0 * q.l1;
    s.dttr += q.ttr;
    s.dtt += q.tt;
}

template <typename C>
__device__ __forceinline__ SC2Walker<C> sc2_walker(const double* p, const SC2Params& P,
                                                   int ndim) {
    SC2Walker<C> w;
    w.T1 = (C)p[0];
    w.L1 = (C)p[1];
    w.t_tr = (C)p[2];
    w.t_exp = (C)(p[3] - P.t_ref);
    w.eT = (C)P.eps_T;
    w.eL = (C)P.eps_L;
    w.a_mod = (C)P.a_model;
    w.alpha = (C)P.alpha;
    w.c3 = (C)P.c3_42;
    w.inv_yscale = (C)P.inv_yscale;
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    return w;
}

// Point n's residual term and its reverse pass.
template <typename C>
__device__ __forceinline__ SC2Point<C> sc2_point(int n, const SC2Walker<C>& w,
                                                 const PointData<C>& d, int K, bool use_sigma) {
    const C tt = d.tc[n] - w.t_exp;
    const bool tpos = tt > C(0);
    const C ptT = tpos ? m_pow(tt, w.eT) : C(0);
    const C T = w.T1 * ptT;
    const C uu = (w.a_mod * tt) / w.t_tr;
    const bool upos = uu > C(0);
    const C pu = upos ? m_pow(uu, w.alpha) : C(0);
    const C E = m_exp(-pu);
    const C ptL = tpos ? m_pow(tt, w.eL) : C(0);
    const C L1E = w.L1 * E;
    const C L = L1E * ptL;
    const C sL = m_sqrt(L);
    const bool Tpos = T > C(0);
    const C pT2 = Tpos ? m_pow(T, C(-2)) : C(0);
    const C c3sL = w.c3 * sL;
    const C R = c3sL * pT2;
    // the power laws of the reverse pass, issued before the recurrence
    // (they do not depend on it)
    const C pT3 = Tpos ? m_pow(T, C(-3)) : C(0);
    const C pua = upos ? m_pow(uu, w.alpha - C(1)) : C(0);
    const C ptL1 = tpos ? m_pow(tt, w.eL - C(1)) : C(0);
    const C ptT1 = tpos ? m_pow(tt, w.eT - C(1)) : C(0);
    C F = C(0), G = C(0), dlng = C(0), s_a = C(0);
    bool clipped = false;
    if (Tpos) {
        s_a = d.s_a[n];
        const C s_raw = m_log(T) * s_a - d.s_b[n];
        clipped = !(s_raw >= C(-1) && s_raw <= C(1));
        const C s = s_raw < C(-1) ? C(-1) : (s_raw > C(1) ? C(1) : s_raw);
        const C two_s = C(2) * s;
        const C* c = d.coef + (size_t)n * K;
        C b1 = C(0), b2 = C(0), d1 = C(0), d2 = C(0);
        for (int k = K - 1; k >= 1; --k) {
            const C d0 = C(2) * b1 + two_s * d1 - d2;
            const C b0 = two_s * b1 - b2 + c[k];
            b2 = b1;
            b1 = b0;
            d2 = d1;
            d1 = d0;
        }
        const C ln_g = s * b1 - b2 + c[0];
        dlng = b1 + s * d1 - d2;
        G = m_exp(ln_g);
        F = R * R * G;
    }
    const C y_fit = F * w.inv_yscale;
    SC2Point<C> q;
    C dy_fit;   // d term / d y_fit
    if (use_sigma) {
        const C two_pi = (C)6.283185307179586;
        const C sg = w.sig * d.su[n];
        const C sigma2 = d.dy[n] * d.dy[n] + sg * sg;
        const C res = d.y[n] - y_fit;
        q.r = m_log(two_pi * sigma2) + res * res / sigma2;
        dy_fit = C(-2) * res / sigma2;
        q.s0 = C(1) / sigma2 - res * res / (sigma2 * sigma2);
        q.s1 = C(2) * sg * d.su[n];
    } else {
        const C r = (d.y[n] - y_fit) * d.inv_dy[n];
        q.r = r;
        dy_fit = C(-2) * r * d.inv_dy[n];
        q.s0 = q.s1 = C(0);
    }
    // the reverse pass (cotangents of the residual term)
    const C ct_F = dy_fit * w.inv_yscale;
    const C ct_R = Tpos ? ct_F * (C(2) * R * G) : C(0);
    const C ct_s = Tpos && !clipped ? ct_F * F * dlng : C(0);
    C ct_T = Tpos ? ct_s * s_a / T : C(0);
    const C ct_pT2 = ct_R * c3sL;
    ct_T += Tpos ? ct_pT2 * (C(-2) * pT3) : C(0);
    const C ct_sL = (ct_R * pT2) * w.c3;
    const C ct_L = ct_sL * (C(0.5) / sL);
    const C ct_L1E = ct_L * ptL;
    const C ct_ptL = ct_L * L1E;
    const C ct_E = ct_L1E * w.L1;
    const C ct_pu = -(ct_E * E);
    const C ct_uu = upos ? ct_pu * (w.alpha * pua) : C(0);
    C ct_tt = (ct_uu / w.t_tr) * w.a_mod;
    ct_tt += tpos ? ct_ptL * (w.eL * ptL1) : C(0);
    ct_tt += tpos ? (ct_T * w.T1) * (w.eT * ptT1) : C(0);
    q.t0 = ct_T;
    q.t1 = ptT;
    q.l0 = ct_L1E;
    q.l1 = E;
    q.ttr = -ct_uu * uu / w.t_tr;
    q.tt = ct_tt;
    return q;
}

// The prior sum at p[ndim] and its gradient gprior; false outside the open
// bounds (NaN included).
template <int D>
__device__ __forceinline__ bool sc2_prior(const double* p, const SC2Params& P, int ndim,
                                          double& lprior, double (&gprior)[D]) {
    lprior = 0.0;
    bool inside = true;
    for (int i = 0; i < ndim; ++i) {
        const double v = p[i];
        if (!(v > P.p_min[i] && v < P.p_max[i])) inside = false;
        if (P.prior_kind[i] == 0) {
            gprior[i] = 0.0;
        } else if (P.prior_kind[i] == 1) {
            lprior = lprior + (-log(v));
            gprior[i] = -1.0 / v;
        } else {
            const double zz = (v - P.mean[i]) / P.stddev[i];
            lprior = lprior + (-0.5 * (zz * zz));
            gprior[i] = -zz / P.stddev[i];
        }
    }
    return inside;
}

// The butterfly over the 32 slots, then the value and g from the sums.
template <typename C, int D>
__device__ __forceinline__ double sc2_finish(SC2Sums<C> s, double lprior,
                                             const double (&gprior)[D], const SC2Params& P,
                                             int ndim, double* g) {
    s.acc = warp_sum(s.acc);
    s.dT1 = warp_sum(s.dT1);
    s.dL1 = warp_sum(s.dL1);
    s.dttr = warp_sum(s.dttr);
    s.dtt = warp_sum(s.dtt);
    if (P.use_sigma) s.dsig = warp_sum(s.dsig);
    const double ll = finish_log_likelihood<C>(s.acc, P.use_sigma, P.ll_offset, P.log_norm_const);
    if (!(ll > -INFINITY)) {
        for (int k = 0; k < ndim; ++k) g[k] = 0.0;
        return -INFINITY;
    }
    // ll = -0.5 acc + const: the cotangent of each term is -0.5 (exact)
    g[0] = gprior[0] + (double)(C(-0.5) * s.dT1);
    g[1] = gprior[1] + (double)(C(-0.5) * s.dL1);
    g[2] = gprior[2] + (double)(C(-0.5) * s.dttr);
    g[3] = gprior[3] + (double)(C(0.5) * s.dtt);
    if (P.use_sigma) g[ndim - 1] = gprior[ndim - 1] + (double)(C(-0.5) * s.dsig);
    return lprior + ll;
}

// The warp form (K7, K7h): called by the 32 lanes of a warp with the same p;
// lane l runs slot l. Every lane returns the same bits.
template <typename C>
__device__ double sc2_value_and_grad_warp(const double* p, const PointData<C>& d,
                                          const SC2Params& P, double* g) {
    const int ndim = (int)P.ndim;
    double lprior, gprior[LP_MAX_DIM];
    if (!sc2_prior(p, P, ndim, lprior, gprior)) {
        for (int k = 0; k < ndim; ++k) g[k] = 0.0;
        return -INFINITY;
    }
    const SC2Walker<C> w = sc2_walker<C>(p, P, ndim);
    const int N = (int)P.n_points, K = (int)P.n_coef;
    SC2Sums<C> s;
    for (int n = threadIdx.x & 31; n < N; n += 32)
        sc2_accumulate(s, sc2_point<C>(n, w, d, K, P.use_sigma != 0), P.use_sigma != 0);
    return sc2_finish<C>(s, lprior, gprior, P, ndim, g);
}

// The block form (K9): called by every thread of the block with the same
// p[NDIM] (NDIM == P.ndim). Thread t computes the points t, t + blockDim,
// ... into ws, one of two buffers of n_points factors that successive calls
// use in turns (turn, the caller's, flips at each call that evaluates the
// likelihood), so one barrier a call keeps a fast warp from overwriting the
// factors a slow one still reads. Every warp then folds the slots from ws in
// the warp form's order. Every thread returns the same bits, the warp
// form's for the same p.
template <typename C, int NDIM>
__device__ double sc2_value_and_grad_block(const double* p, const PointData<C>& d,
                                           const SC2Params& P, double* g, SC2Point<C>* ws,
                                           int& turn) {
    double lprior, gprior[NDIM];
    if (!sc2_prior(p, P, NDIM, lprior, gprior)) {
        for (int k = 0; k < NDIM; ++k) g[k] = 0.0;
        return -INFINITY;
    }
    const SC2Walker<C> w = sc2_walker<C>(p, P, NDIM);
    const int N = (int)P.n_points, K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    SC2Point<C>* buf = ws + (size_t)turn * N;
    turn ^= 1;
    for (int n = threadIdx.x; n < N; n += blockDim.x) buf[n] = sc2_point<C>(n, w, d, K, use_sigma);
    __syncthreads();
    SC2Sums<C> s;
    for (int n = threadIdx.x & 31; n < N; n += 32) sc2_accumulate(s, buf[n], use_sigma);
    return sc2_finish<C>(s, lprior, gprior, P, NDIM, g);
}

// The model policy of stretch.cuh, ladder.cuh and gradient.cuh for
// ShockCooling2 in compute type C.
template <typename C>
struct SC2Model {
    typedef SC2Params Params;
    typedef PointData<C> Data;
    static __host__ __device__ size_t stage_bytes(const Params& P) { return ::stage_bytes<C>(P); }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return stage_points<C>(P, reinterpret_cast<C*>(smem), use_smem);
    }
    static __device__ double log_posterior(const double* p, const Data& d, const Params& P) {
        return sc2_log_posterior<C>(p, d, P);
    }
    static __device__ double log_likelihood(const double* p, const Data& d, const Params& P) {
        return sc2_log_likelihood<C>(p, d, P);
    }
    static __device__ double value_and_grad(const double* p, const Data& d, const Params& P,
                                            double* g) {
        return sc2_value_and_grad_warp<C>(p, d, P, g);
    }
    static __host__ __device__ size_t block_ws_bytes(const Params& P) {
        return 2 * sizeof(SC2Point<C>) * (size_t)P.n_points;
    }
    template <int NDIM>
    static __device__ double value_and_grad_block(const double* p, const Data& d,
                                                  const Params& P, double* g, void* ws,
                                                  int& turn) {
        return sc2_value_and_grad_block<C, NDIM>(p, d, P, g, static_cast<SC2Point<C>*>(ws), turn);
    }
};

// K1: out[w] = log-posterior of walker state q[w, :] (affine-mapped when
// has_affine), for the initial state and LogPosterior.forward.
template <typename C, typename S>
__global__ void __launch_bounds__(LP_THREADS)
sc2_logpost_kernel(const SC2Params P, const S* __restrict__ q, int W,
                   double* __restrict__ out, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const PointData<C> d = stage_points<C>(P, reinterpret_cast<C*>(smem_raw), use_smem);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= W) return;
    const int ndim = (int)P.ndim;
    double p[LP_MAX_DIM];
    for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, q[(size_t)i * ndim + k]);
    out[i] = sc2_log_posterior<C>(p, d, P);
}

// ------------------------------------------------------------------ launch

template <typename C, typename S>
static int launch_logpost(const SC2Params& P, const void* q, int W, double* out,
                          cudaStream_t stream) {
    auto kernel = sc2_logpost_kernel<C, S>;
    int use_smem = 0;
    size_t bytes = stage_bytes<C>(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const int blocks = (W + LP_THREADS - 1) / LP_THREADS;
    kernel<<<blocks, LP_THREADS, use_smem ? bytes : 0, stream>>>(
        P, (const S*)q, W, out, use_smem);
    return (int)cudaGetLastError();
}

extern "C" {

// K1 launch. Returns 0 or a cudaError_t code.
int sc2_logpost_launch(const SC2Params* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, double* out, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0) return 0;
    if (P->ndim > LP_MAX_DIM) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (compute_f64)
        return q_f64 ? launch_logpost<double, double>(*P, q, W, out, s)
                     : launch_logpost<double, float>(*P, q, W, out, s);
    return q_f64 ? launch_logpost<float, double>(*P, q, W, out, s)
                 : launch_logpost<float, float>(*P, q, W, out, s);
}

// K2 launch. chain_x/chain_lp may be null (a thinned step that is not
// stored). Returns 0 or a cudaError_t code.
int stretch_half_step_launch(const SC2Params* P, int device, int compute_f64, void* x,
                             int state_f64, double* logp, int half, int h, const void* u_z,
                             const long long* j, const void* u_acc, double a, void* chain_x,
                             int chain_x_f64, void* chain_lp, int chain_lp_f64,
                             int* n_accept, void* stream) {
    return launch_half_step<SC2Model>(P, device, compute_f64, x, state_f64, logp, half, h, u_z,
                                      j, u_acc, a, chain_x, chain_x_f64, chain_lp, chain_lp_f64,
                                      n_accept, stream);
}

// K6a launch over ShockCooling2 (ladder.cuh). Returns 0 or a cudaError_t code.
int sc2_tempered_half_step_launch(const SC2Params* P, int device, int compute_f64, void* x,
                                  int state_f64, double* logpri, double* logl,
                                  const double* betas, int n_rungs, int half, int h,
                                  const void* u_z, const long long* j, const void* u_acc,
                                  double a, int* n_accept, void* stream) {
    return launch_tempered_half_step<SC2Model>(P, device, compute_f64, x, state_f64, logpri, logl,
                                               betas, n_rungs, half, h, u_z, j, u_acc, a,
                                               n_accept, stream);
}

// K6b launch over ShockCooling2 (ladder.cuh). Returns 0 or a cudaError_t code.
int sc2_ladder_init_launch(const SC2Params* P, int device, int compute_f64, const void* x,
                           int state_f64, int n, double* logpri, double* logl, void* stream) {
    return launch_ladder_init<SC2Model>(P, device, compute_f64, x, state_f64, n, logpri, logl,
                                        stream);
}

// K7 launch: val (W,) and grad (W, ndim) at the float64 rows q, in the
// whitened space of T when T is not null. Returns 0 or a cudaError_t code.
int sc2_logpost_grad_launch(const SC2Params* P, int device, int compute_f64,
                            const WhiteParams* T, const double* q, int W, double* val,
                            double* grad, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->has_affine || (T && T->ndim != P->ndim))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return compute_f64 ? launch_logpost_grad<SC2Model<double>>(*P, T, q, W, val, grad, s)
                       : launch_logpost_grad<SC2Model<float>>(*P, T, q, W, val, grad, s);
}

// K9's plan (gradient.cuh): the float64 scratch, in doubles, that a launch
// over C chains needs (0 when the workspace and the trajectory buffer fit in
// shared memory), or minus a cudaError_t code.
long long sc2_nuts_scratch_len(const SC2Params* P, int device, int compute_f64, int max_depth,
                               int C) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return -rc;
    const int ndim = (int)P->ndim;
    const long long per_chain = compute_f64
        ? nuts_plan<SC2Model<double>>(*P, ndim, max_depth).scratch
        : nuts_plan<SC2Model<float>>(*P, ndim, max_depth).scratch;
    return per_chain * C;
}

// K9 launch (gradient.cuh), for ndim 4 (5 with the intrinsic scatter);
// scratch may be null when sc2_nuts_scratch_len gives 0. Returns 0 or a
// cudaError_t code.
int sc2_nuts_transition_launch(const SC2Params* P, int device, int compute_f64,
                               const WhiteParams* T, const double* q, const double* logp,
                               const double* z, const double* u, const double* eps,
                               const double* inv_mass, int max_depth, int C, double* q_out,
                               double* logp_out, double* accept_stat, int* depth, int* diverged,
                               double* scratch, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (C <= 0) return 0;
    if (P->ndim != 4 + (P->use_sigma != 0) || P->has_affine || T->ndim != P->ndim ||
        max_depth < 1 || max_depth > 12)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LP_NUTS(C_, N_)                                                                      \
    launch_nuts<SC2Model<C_>, N_>(*P, *T, q, logp, z, u, eps, inv_mass, max_depth, C, q_out, \
                                  logp_out, accept_stat, depth, diverged, scratch, s)
    if (P->ndim == 4) return compute_f64 ? LP_NUTS(double, 4) : LP_NUTS(float, 4);
    return compute_f64 ? LP_NUTS(double, 5) : LP_NUTS(float, 5);
#undef LP_NUTS
}

// K7h launch (gradient.cuh). Returns 0 or a cudaError_t code.
int sc2_hmc_transition_launch(const SC2Params* P, int device, int compute_f64,
                              const WhiteParams* T, const double* q, const double* logp,
                              const double* z, const double* u_acc, const long long* n_used,
                              const double* eps, const double* inv_mass, int C, double* q_out,
                              double* logp_out, double* accept_prob, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (C <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->has_affine || T->ndim != P->ndim)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return compute_f64
        ? launch_hmc<SC2Model<double>>(*P, *T, q, logp, z, u_acc, n_used, eps, inv_mass, C,
                                       q_out, logp_out, accept_prob, s)
        : launch_hmc<SC2Model<float>>(*P, *T, q, logp, z, u_acc, n_used, eps, inv_mass, C,
                                      q_out, logp_out, accept_prob, s);
}

}  // extern "C"
