// Fused log-posteriors of ShockCooling (SW17 in physical parameters) and
// ShockCooling4 (MSW23) over the band table, their stretch-move half-steps
// and tempered-ladder kernels, for sm_90a, bound to Python through a plain C
// interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   SC log-posterior: fitting.py:62-68 make_log_posterior.log_posterior,
//       fused by XLA with models/base.py:278-288 (ll),
//       models/shock_cooling.py:71-98 (temperature_radius, the SW17 power
//       laws, kappa bound at construction), ops/mathx.py:28-57 (hot_phase,
//       power) and ops/bandtable.py:152-181 (chebyshev_bandflux).
//   SC4 log-posterior: the same graph over models/shock_cooling.py:247-265
//       (ShockCooling4._tr_points: MSW23 Eq. A1-A9) and :278-282
//       (_eval_points: the smaller of the band fluxes at (T, R) and at
//       (0.74 T, 0.74^-2 R), Eq. A4).
//   Their half-steps: parallel/sampler.py:38-57, :86-95, :97-104 and
//       :205-225, the stretch_half_step_kernel template of stretch.cuh; K6a
//       and K6b over them: parallel/evidence.py:60-83 and :229-235, the
//       templates of ladder.cuh.
//
// What bounds it on the H100: FP32 ALU work, as K1. A point is the band
// table's degree-40 Clenshaw recurrence (three operations a degree) and a
// dozen power laws and special functions; ShockCooling4 runs the recurrence
// twice a point. The per-point data, 28.6 KB in f32 (57.2 KB in f64) on the
// flagship, are shared by every walker: device-memory traffic is
// negligible.
// What the design does about it: SC2WarpModel's form (sc2_logpost.cu). The
// per-point data are staged once a block (band_table.cuh, the SC2 kernels'
// staging), a warp runs a walker with lane l on the points l, l + 32, ...,
// and a warp takes its walkers in batches whose prologues (the proposal,
// the prior and the walker's constants) run a walker a lane (stretch.cuh,
// warp_batch_ll). The batch log-posterior and K6b take the walker's
// dimension at compile time (5, or 6 with the intrinsic scatter: the state
// in registers), the half-steps at run time. ShockCooling4's two
// recurrences run interleaved over one read of the row's coefficients
// (table_ln_g2), each with its own clamped s: the 0.74 T lookup clamps its
// own s = clip(s_a ln(0.74 T) - s_b, -1, 1), as the JAX graph evaluates the
// table at 0.74 T. Every product that meets a sum in a point is fused or
// rounded by hand, in both dtypes, so the two inlined copies of the point
// (a batch of one walker, and a batch) give the same bits: the batch
// log-posterior and K6b repeat the values that the half-steps store.
// Sixteen warps a block in both dtypes (a 128-register cap: SC4's two
// chains at SC2's 64-register cap would risk spills).
// The half-steps' latency form (stretch_half_step_latency_kernel of
// stretch.cuh, through point_term), where a warp per walker leaves the card
// idle (the fits' 32-2048 walkers a half; kernels/sc.py::sc_half_form): a
// walker of the warp form takes its staging, prologue and ~5 points a lane
// one after another (~2 us a point: a dozen power laws and the Clenshaw
// chain, each step depending on the last), so a walker's points spread over
// ceil(N / 32) warps, one a thread, read where they lie (a warp's 32
// points' coefficients from coef_t, coalesced); the walker's prologue runs
// on the block's first warp (ShockCooling4's nine float64 powers a lane
// each, sc4_walker_lanes), and the terms are summed in the warp form's
// order, so both forms store the same bits. K6a over them has the same
// latency form (tempered_half_step_latency_kernel of ladder.cuh, a block per
// (rung, walker); kernels/sc.py::tempered_form over the launch's R x half
// walkers), and so have the batch log-posterior (logpost_latency_kernel of
// stretch.cuh, a block per walker; kernels/sc.py::logpost_form) and K6b
// (ladder_init_latency_kernel of ladder.cuh, a block per distinct state;
// kernels/sc.py::ladder_init_form), the fits' initial states and the
// ladders' starting values at 64-4096 walkers: the same bits as their warp
// forms, and as the half-steps' and K6a's stored values.
//
// Dtype semantics follow the JAX accelerator path, with each model's own
// order of casts. SW17 (temperature_radius) casts t - t_exp, v_s, M_env,
// f_rho M, R and kappa to the compute type C first and does all its
// arithmetic there. MSW23 (_tr_points) forms t_br, L_br, T_col,br and t_tr
// in float64 from the float64 parameters and casts them afterwards. tt =
// C(t - t_ref) - C(t_exp - t_ref); the residual sum and its constant are
// added in C; the float64 prior sum plus that value gives the result.
// power(x, e) is 0 where x <= 0 (RW's a = 0 gives power(0, alpha) = 0), so
// t < t_0 gives T = 0 and a zero flux, as the plain version.

#include "band_table.cuh"
#include "ladder.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/sc.py (_SCParams) matches it field for field. One block
// serves both models: each reads its own constants.
struct SCParams {
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
    double kappa;
    double A;
    double a_model;
    double alpha;
    double eps1;              // SW17
    double eps2;
    double L0_42;
    double T0;
    double tph_to_tcol;
    double L_br_0_42;         // MSW23
    double T_col_br_0;
    double t_br_0;
    double t_tr_0;
    double kappa_L;           // kappa^-0.89, formed on the host as the JAX graph does
    double kappa_T;           // kappa^-0.22
    double k_B;
    double c3_42;
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
    const void* coef_t;       // (n_coef, N) the rows' transpose: the half-steps' latency
                              // form reads it, a warp's 32 points coalesced
};

// minimum with jnp.minimum's NaN: NaN when either is NaN
template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
    return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}

// The residual term of a point of flux F: ((y - F / yscale) / dy)^2, or
// with the intrinsic scatter log(2 pi sigma^2) + (y - F / yscale)^2 /
// sigma^2, fused and rounded as K1's EXACT point (sc2_forward) in both
// dtypes.
template <typename C>
__device__ __forceinline__ C sc_term(C F, C inv_yscale, C sig, const PointData<C>& d, int n,
                                     bool use_sigma) {
    const C res = fma(-F, inv_yscale, d.y[n]);
    if (use_sigma) {
        const C sg = mul_rn(sig, d.su[n]);
        const C sigma2 = fma(d.dy[n], d.dy[n], mul_rn(sg, sg));
        return add_rn(m_log(mul_rn((C)6.283185307179586, sigma2)),
                      div_rn(mul_rn(res, res), sigma2));
    }
    const C r = mul_rn(res, d.inv_dy[n]);
    return mul_rn(r, r);
}

// The warp's residual sum of a walker, term(n) the point's term: lane l
// sums the points l, l + 32, ... in that order, a butterfly sums the lanes
// (every lane returns the same bits); float64, -inf when not finite.
template <typename C, typename Term>
__device__ __forceinline__ double warp_log_likelihood(const SCParams& P, Term term) {
    const int N = (int)P.n_points;
    C acc = C(0);
    for (int n = threadIdx.x & 31; n < N; n += 32) acc = add_rn(acc, term(n));
    return finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset, P.log_norm_const);
}

// ---------------------------------------------------------------- SW17

// The model's constants in the compute type, formed from P by every lane at
// the start of a walker's evaluation (not carried with the walker: a
// batch's lanes shuffle the walker to the warp, and in float64 the
// constants in it spilled registers).
template <typename C>
struct SCConsts {
    C kappa, kappa_q, A, a_mod, alpha, eps1, neg_eps2, L0, T0, tph_to_tcol, k_B, c3, inv_yscale;
};

template <typename C>
__device__ __forceinline__ SCConsts<C> sc_consts(const SCParams& P) {
    SCConsts<C> k;
    k.kappa = (C)P.kappa;
    k.kappa_q = m_pow(k.kappa, C(-0.25));
    k.A = (C)P.A, k.a_mod = (C)P.a_model, k.alpha = (C)P.alpha;
    k.eps1 = (C)P.eps1, k.neg_eps2 = (C)(-P.eps2);
    k.L0 = (C)P.L0_42, k.T0 = (C)P.T0, k.tph_to_tcol = (C)P.tph_to_tcol, k.k_B = (C)P.k_B;
    k.c3 = (C)P.c3_42, k.inv_yscale = (C)P.inv_yscale;
    return k;
}

// The walker's factors of SW17 in the compute type (the JAX graph forms them
// per point: the same values).
template <typename C>
struct SCWalker {
    C v_s, R, t_exp, sig, fk, v2, t_tr, R_q;
};

template <typename C>
__device__ __forceinline__ SCWalker<C> sc_walker(const double* p, const SCParams& P, int ndim) {
    SCWalker<C> w;
    const C kappa = (C)P.kappa;
    w.v_s = (C)p[0];
    const C M_env = (C)p[1];
    const C f_rho_M = (C)p[2];
    w.R = (C)p[3];
    w.t_exp = (C)(p[4] - P.t_ref);
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    w.fk = mul_rn(f_rho_M, kappa);
    w.v2 = mul_rn(w.v_s, w.v_s);
    w.t_tr = mul_rn(C(19.5), m_sqrt(div_rn(mul_rn(kappa, M_env), w.v_s)));
    w.R_q = m_pow(w.R, C(0.25));
    return w;
}

// Point n's residual term: T and R of SW17 (temperature_radius's order) and
// the band table's flux, the point's coefficients its row of d.coef, or with
// COLUMN its column of coef_t (N points a row).
template <typename C, bool COLUMN = false>
__device__ __forceinline__ C sc_point(int n, const SCWalker<C>& w, const SCConsts<C>& k,
                                      const PointData<C>& d, int K, bool use_sigma,
                                      const C* coef_t = nullptr, int N = 0) {
    const C tt = sub_rn(d.tc[n], w.t_exp);
    const C tt2 = mul_rn(tt, tt);
    const C L_RW = div_rn(mul_rn(mul_rn(mul_rn(k.L0, power0(div_rn(mul_rn(tt2, w.v_s), w.fk),
                                                            k.neg_eps2)),
                                        w.v2), w.R), k.kappa);
    const C L_42 = mul_rn(mul_rn(L_RW, k.A),
                          m_exp(-power0(div_rn(mul_rn(k.a_mod, tt), w.t_tr), k.alpha)));
    const C T_ph = mul_rn(mul_rn(mul_rn(mul_rn(k.T0, power0(div_rn(mul_rn(tt2, w.v2), w.fk),
                                                             k.eps1)),
                                        k.kappa_q), power0(tt, C(-0.5))), w.R_q);
    const C T = div_rn(mul_rn(T_ph, k.tph_to_tcol), k.k_B);
    const C R = mul_rn(mul_rn(k.c3, m_sqrt(L_42)), power0(T, C(-2)));
    C F = C(0);
    if (T > C(0)) {
        const C s = table_s(T, d.s_a[n], d.s_b[n]);
        C g;
        if constexpr (COLUMN) g = table_ln_g<C, true>(s, coef_t + n, K, N);
        else g = table_ln_g(s, d.coef + (size_t)n * K, K);
        F = mul_rn(mul_rn(R, R), m_exp(g));
    }
    return sc_term(F, k.inv_yscale, w.sig, d, n, use_sigma);
}

template <typename C>
__device__ double sc_log_likelihood_warp(const SCWalker<C>& w, const PointData<C>& d,
                                         const SCParams& P) {
    const int K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    const SCConsts<C> k = sc_consts<C>(P);
    return warp_log_likelihood<C>(P,
                                  [&](int n) { return sc_point<C>(n, w, k, d, K, use_sigma); });
}

// ---------------------------------------------------------------- MSW23

// The model's constants in the compute type (as SCConsts).
template <typename C>
struct SC4Consts {
    C A, a_mod, alpha, k_B, c3, inv_yscale;
};

template <typename C>
__device__ __forceinline__ SC4Consts<C> sc4_consts(const SCParams& P) {
    SC4Consts<C> k;
    k.A = (C)P.A, k.a_mod = (C)P.a_model, k.alpha = (C)P.alpha;
    k.k_B = (C)P.k_B, k.c3 = (C)P.c3_42, k.inv_yscale = (C)P.inv_yscale;
    return k;
}

// The walker's breakout scales (float64, cast to C afterwards, as the JAX
// graph).
template <typename C>
struct SC4Walker {
    C t_exp, sig, t_br, L_br, T_col_br, t_tr;
};

// The walker's breakout scales (Eq. A5-A7, A9) from pw(k), k = 0-9: the
// float64 values R^1.26, v_s*^-1.13, f_rho M^-0.13, R^0.78, v_s*^2.11,
// f_rho M^0.11, R^-0.32, v_s*^0.58, f_rho M^0.03 and sqrt(kappa M_env /
// v_s*), multiplied left to right as the JAX graph multiplies.
template <typename C, typename PW>
__device__ __forceinline__ SC4Walker<C> sc4_breakout(const PW& pw, const double* p,
                                                     const SCParams& P, int ndim) {
    SC4Walker<C> w;
    const double t_br = __dmul_rn(__dmul_rn(__dmul_rn(P.t_br_0, pw(0)), pw(1)), pw(2));
    const double L_br = __dmul_rn(__dmul_rn(__dmul_rn(__dmul_rn(P.L_br_0_42, pw(3)), pw(4)),
                                            pw(5)), P.kappa_L);
    const double T_col_br = __dmul_rn(__dmul_rn(__dmul_rn(__dmul_rn(P.T_col_br_0, pw(6)), pw(7)),
                                                pw(8)), P.kappa_T);
    const double t_tr = __dmul_rn(P.t_tr_0, pw(9));
    w.t_exp = (C)(p[4] - P.t_ref);
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    w.t_br = (C)t_br, w.L_br = (C)L_br, w.T_col_br = (C)T_col_br, w.t_tr = (C)t_tr;
    return w;
}

// sc4_breakout's ten values on one lane, each where the product takes it.
template <typename C>
__device__ __forceinline__ SC4Walker<C> sc4_walker(const double* p, const SCParams& P,
                                                   int ndim) {
    const double v_s = p[0], M_env = p[1], f_rho_M = p[2], R = p[3];
    return sc4_breakout<C>([&](int k) {
        switch (k) {
            case 0: return pow(R, 1.26);
            case 1: return pow(v_s, -1.13);
            case 2: return pow(f_rho_M, -0.13);
            case 3: return pow(R, 0.78);
            case 4: return pow(v_s, 2.11);
            case 5: return pow(f_rho_M, 0.11);
            case 6: return pow(R, -0.32);
            case 7: return pow(v_s, 0.58);
            case 8: return pow(f_rho_M, 0.03);
            default: return sqrt(__ddiv_rn(__dmul_rn(P.kappa, M_env), v_s));
        }
    }, p, P, ndim);
}

// sc4_walker by the 32 lanes of a warp together, the same bits on every
// lane: lane k < 10 forms sc4_breakout's k-th value, shuffled to all (on one
// lane the nine float64 pows run one after another, ~0.6 us each on the
// H100).
template <typename C>
__device__ __forceinline__ SC4Walker<C> sc4_walker_lanes(const double* p, const SCParams& P,
                                                         int ndim) {
    const int lane = threadIdx.x & 31;
    const double e = lane == 0 ? 1.26 : lane == 1 ? -1.13 : lane == 2 ? -0.13 : lane == 3 ? 0.78
                   : lane == 4 ? 2.11 : lane == 5 ? 0.11 : lane == 6 ? -0.32 : lane == 7 ? 0.58
                   : 0.03;
    double mine = 0.0;
    if (lane < 9) mine = pow(lane % 3 == 0 ? p[3] : (lane % 3 == 1 ? p[0] : p[2]), e);
    else if (lane == 9) mine = sqrt(__ddiv_rn(__dmul_rn(P.kappa, p[1]), p[0]));
    double pw[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) pw[k] = __shfl_sync(0xffffffffu, mine, k);
    return sc4_breakout<C>([&](int k) { return pw[k]; }, p, P, ndim);
}

// Point n's residual term: T and R of MSW23 (Eq. A1, A2) and the smaller of
// the band table's fluxes at (T, R) and (0.74 T, 0.74^-2 R) (Eq. A4); the
// coefficients as sc_point's.
template <typename C, bool COLUMN = false>
__device__ __forceinline__ C sc4_point(int n, const SC4Walker<C>& w, const SC4Consts<C>& k,
                                       const PointData<C>& d, int K, bool use_sigma,
                                       const C* coef_t = nullptr, int N = 0) {
    const C tt = sub_rn(d.tc[n], w.t_exp);
    const C tl = div_rn(tt, w.t_br);
    const C decay = mul_rn(mul_rn(k.A, m_exp(-power0(div_rn(mul_rn(k.a_mod, tt), w.t_tr),
                                                      k.alpha))),
                           power0(tl, (C)-0.17));
    const C L_42 = mul_rn(w.L_br, add_rn(power0(tl, (C)(-4.0 / 3.0)), decay));
    const C T_col = mul_rn(w.T_col_br, nan_min(mul_rn((C)0.97, power0(tl, (C)(-1.0 / 3.0))),
                                               power0(tl, (C)-0.45)));
    const C T = div_rn(T_col, k.k_B);
    const C R = mul_rn(mul_rn(k.c3, m_sqrt(L_42)), power0(T, C(-2)));
    C F = C(0);
    if (T > C(0)) {
        const C T2 = mul_rn((C)0.74, T);
        const C R2 = mul_rn((C)1.8261504747991235, R);   // 0.74 ** -2.0, as Python forms it
        C g1, g2;
        const C s1 = table_s(T, d.s_a[n], d.s_b[n]), s2 = table_s(T2, d.s_a[n], d.s_b[n]);
        if constexpr (COLUMN) table_ln_g2<C, true>(s1, s2, coef_t + n, K, g1, g2, N);
        else table_ln_g2(s1, s2, d.coef + (size_t)n * K, K, g1, g2);
        F = nan_min(mul_rn(mul_rn(R, R), m_exp(g1)), mul_rn(mul_rn(R2, R2), m_exp(g2)));
    }
    return sc_term(F, k.inv_yscale, w.sig, d, n, use_sigma);
}

template <typename C>
__device__ double sc4_log_likelihood_warp(const SC4Walker<C>& w, const PointData<C>& d,
                                          const SCParams& P) {
    const int K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    const SC4Consts<C> k = sc4_consts<C>(P);
    return warp_log_likelihood<C>(P,
                                  [&](int n) { return sc4_point<C>(n, w, k, d, K, use_sigma); });
}

// ---------------------------------------------------------------- policies

// The table-path warp policy of stretch.cuh and ladder.cuh (the batch
// log-posterior, the half-step, K6a and K6b): a warp per walker, batched,
// sixteen warps a block, the tables staged once a block. N: the walker's
// dimension at compile time (policy_dim), or 0 (P.ndim). Its point_term
// (sc_point, sc4_point) also runs the latency forms of the half-step, K6a,
// the batch log-posterior and K6b, a point a thread.
template <typename C, int N>
struct SCTableModel {
    typedef SCParams Params;
    typedef PointData<C> Data;
    typedef C Compute;
    static constexpr int warps_per_block = 16;
    static constexpr bool batched = true;
    static constexpr int ndim = N;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return ::stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return stage_points<C>(P, reinterpret_cast<C*>(smem), use_smem);
    }
};

template <typename C, int N>
struct SCWarpModel : SCTableModel<C, N> {
    typedef SCWalker<C> Walker;
    static __device__ Walker walker(const double* p, const SCParams& P) {
        return sc_walker<C>(p, P, N > 0 ? N : (int)P.ndim);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const PointData<C>& d,
                                                 const SCParams& P) {
        return sc_log_likelihood_warp<C>(w, d, P);
    }
    static __device__ C point_term(int n, const Walker& w, const PointData<C>& d,
                                   const SCParams& P) {
        return sc_point<C, true>(n, w, sc_consts<C>(P), d, (int)P.n_coef, P.use_sigma != 0,
                                 (const C*)P.coef_t, (int)P.n_points);
    }
};

template <typename C, int N>
struct SC4WarpModel : SCTableModel<C, N> {
    typedef SC4Walker<C> Walker;
    static __device__ Walker walker(const double* p, const SCParams& P) {
        return sc4_walker<C>(p, P, N > 0 ? N : (int)P.ndim);
    }
    static __device__ Walker walker_lanes(const double* p, const SCParams& P) {
        return sc4_walker_lanes<C>(p, P, N > 0 ? N : (int)P.ndim);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const PointData<C>& d,
                                                 const SCParams& P) {
        return sc4_log_likelihood_warp<C>(w, d, P);
    }
    static __device__ C point_term(int n, const Walker& w, const PointData<C>& d,
                                   const SCParams& P) {
        return sc4_point<C, true>(n, w, sc4_consts<C>(P), d, (int)P.n_coef, P.use_sigma != 0,
                                  (const C*)P.coef_t, (int)P.n_points);
    }
};

template <typename C>
using SCWarpModelAnyDim = SCWarpModel<C, 0>;
template <typename C>
using SCWarpModel5 = SCWarpModel<C, 5>;
template <typename C>
using SCWarpModel6 = SCWarpModel<C, 6>;
template <typename C>
using SC4WarpModelAnyDim = SC4WarpModel<C, 0>;
template <typename C>
using SC4WarpModel5 = SC4WarpModel<C, 5>;
template <typename C>
using SC4WarpModel6 = SC4WarpModel<C, 6>;

// ------------------------------------------------------------------ launch

// The four launches of a policy family M<C, N> under the C names prefix_*:
// the batch log-posterior and K6b at the walker's dimension (5, or 6 with the
// intrinsic scatter), the half-step and K6a at run time. Each returns 0 or a
// cudaError_t code; the arguments are those of sc2_logpost.cu's launches,
// with the form before the stream (0 the warp form, 1 the latency form).
#define SC_LAUNCHES(prefix, M)                                                                 \
    int prefix##_logpost_launch(const SCParams* P, int device, int compute_f64, const void* q, \
                                int q_f64, int W, double* out, int form, void* stream) {       \
        if (P->ndim == 5)                                                                      \
            return launch_logpost<M##5>(P, device, compute_f64, q, q_f64, W, out, stream, 1,   \
                                        form);                                                 \
        if (P->ndim == 6)                                                                      \
            return launch_logpost<M##6>(P, device, compute_f64, q, q_f64, W, out, stream, 1,   \
                                        form);                                                 \
        return (int)cudaErrorInvalidValue;                                                     \
    }                                                                                          \
    int prefix##_half_step_launch(const SCParams* P, int device, int compute_f64, void* x,     \
                                  int state_f64, double* logp, int half, int h,                \
                                  const void* u_z, const long long* j, const void* u_acc,      \
                                  double a, void* chain_x, int chain_x_f64, void* chain_lp,    \
                                  int chain_lp_f64, int* n_accept, int form, void* stream) {   \
        return launch_half_step<M##AnyDim>(P, device, compute_f64, x, state_f64, logp, half, h, \
                                           u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,   \
                                           chain_lp_f64, n_accept, stream, 1, 0, form);        \
    }                                                                                          \
    int prefix##_tempered_half_step_launch(const SCParams* P, int device, int compute_f64,     \
                                           void* x, int state_f64, double* logpri,             \
                                           double* logl, const double* betas, int n_rungs,     \
                                           int half, int h, const void* u_z,                   \
                                           const long long* j, const void* u_acc, double a,    \
                                           int* n_accept, int form, void* stream) {            \
        return launch_tempered_half_step<M##AnyDim>(P, device, compute_f64, x, state_f64,      \
                                                    logpri, logl, betas, n_rungs, half, h,     \
                                                    u_z, j, u_acc, a, n_accept, stream, form); \
    }                                                                                          \
    int prefix##_ladder_init_launch(const SCParams* P, int device, int compute_f64,            \
                                    const void* x, int state_f64, int n, int per_set,          \
                                    int copies, double* logpri, double* logl, int form,        \
                                    void* stream) {                                            \
        if (P->ndim == 5)                                                                      \
            return launch_ladder_init<M##5>(P, device, compute_f64, x, state_f64, n, per_set,  \
                                            copies, logpri, logl, stream, form);               \
        if (P->ndim == 6)                                                                      \
            return launch_ladder_init<M##6>(P, device, compute_f64, x, state_f64, n, per_set,  \
                                            copies, logpri, logl, stream, form);               \
        return (int)cudaErrorInvalidValue;                                                     \
    }

extern "C" {
SC_LAUNCHES(sc, SCWarpModel)
SC_LAUNCHES(sc4, SC4WarpModel)
}  // extern "C"
