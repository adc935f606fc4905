// The ShockCooling (SW17 in physical parameters) and ShockCooling4 (MSW23)
// point over the band table: each model's walker constants, one point's
// residual term (sc_point, sc4_point) and the single fit's parameter block
// and warp sum. Shared by the single-light-curve kernels of sc_logpost.cu
// and the per-transient population kernels of pop_sc.cu (P1, P2), so that a
// point rounds alike in both. The walker and constant builders take any
// parameter block with the model's constants under SCParams' names, and the
// walker's t_exp less the curve's t_ref.

#pragma once

#include "band_table.cuh"

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

// The model's constants in the compute type, formed from P (and the curve's
// 1 / yscale) by every lane at the start of a walker's evaluation (not
// carried with the walker: a batch's lanes shuffle the walker to the warp,
// and in float64 the constants in it spilled registers).
template <typename C>
struct SCConsts {
    C kappa, kappa_q, A, a_mod, alpha, eps1, neg_eps2, L0, T0, tph_to_tcol, k_B, c3, inv_yscale;
};

template <typename C, typename Params>
__device__ __forceinline__ SCConsts<C> sc_consts(const Params& P, double inv_yscale) {
    SCConsts<C> k;
    k.kappa = (C)P.kappa;
    k.kappa_q = m_pow(k.kappa, C(-0.25));
    k.A = (C)P.A, k.a_mod = (C)P.a_model, k.alpha = (C)P.alpha;
    k.eps1 = (C)P.eps1, k.neg_eps2 = (C)(-P.eps2);
    k.L0 = (C)P.L0_42, k.T0 = (C)P.T0, k.tph_to_tcol = (C)P.tph_to_tcol, k.k_B = (C)P.k_B;
    k.c3 = (C)P.c3_42, k.inv_yscale = (C)inv_yscale;
    return k;
}

// The walker's factors of SW17 in the compute type (the JAX graph forms them
// per point: the same values); t_exp the walker's less the curve's t_ref.
template <typename C>
struct SCWalker {
    C v_s, R, t_exp, sig, fk, v2, t_tr, R_q;
};

template <typename C, typename Params>
__device__ __forceinline__ SCWalker<C> sc_walker(const double* p, const Params& P, int ndim,
                                                 double t_exp) {
    SCWalker<C> w;
    const C kappa = (C)P.kappa;
    w.v_s = (C)p[0];
    const C M_env = (C)p[1];
    const C f_rho_M = (C)p[2];
    w.R = (C)p[3];
    w.t_exp = (C)t_exp;
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
    const SCConsts<C> k = sc_consts<C>(P, P.inv_yscale);
    return warp_log_likelihood<C>(P,
                                  [&](int n) { return sc_point<C>(n, w, k, d, K, use_sigma); });
}

// ---------------------------------------------------------------- MSW23

// The model's constants in the compute type (as SCConsts).
template <typename C>
struct SC4Consts {
    C A, a_mod, alpha, k_B, c3, inv_yscale;
};

template <typename C, typename Params>
__device__ __forceinline__ SC4Consts<C> sc4_consts(const Params& P, double inv_yscale) {
    SC4Consts<C> k;
    k.A = (C)P.A, k.a_mod = (C)P.a_model, k.alpha = (C)P.alpha;
    k.k_B = (C)P.k_B, k.c3 = (C)P.c3_42, k.inv_yscale = (C)inv_yscale;
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
// v_s*), multiplied left to right as the JAX graph multiplies; t_exp the
// walker's less the curve's t_ref.
template <typename C, typename PW, typename Params>
__device__ __forceinline__ SC4Walker<C> sc4_breakout(const PW& pw, const double* p,
                                                     const Params& P, int ndim, double t_exp) {
    SC4Walker<C> w;
    const double t_br = __dmul_rn(__dmul_rn(__dmul_rn(P.t_br_0, pw(0)), pw(1)), pw(2));
    const double L_br = __dmul_rn(__dmul_rn(__dmul_rn(__dmul_rn(P.L_br_0_42, pw(3)), pw(4)),
                                            pw(5)), P.kappa_L);
    const double T_col_br = __dmul_rn(__dmul_rn(__dmul_rn(__dmul_rn(P.T_col_br_0, pw(6)), pw(7)),
                                                pw(8)), P.kappa_T);
    const double t_tr = __dmul_rn(P.t_tr_0, pw(9));
    w.t_exp = (C)t_exp;
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    w.t_br = (C)t_br, w.L_br = (C)L_br, w.T_col_br = (C)T_col_br, w.t_tr = (C)t_tr;
    return w;
}

// sc4_breakout's ten values on one lane, each where the product takes it.
template <typename C, typename Params>
__device__ __forceinline__ SC4Walker<C> sc4_walker(const double* p, const Params& P, int ndim,
                                                   double t_exp) {
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
    }, p, P, ndim, t_exp);
}

// sc4_walker by the 32 lanes of a warp together, the same bits on every
// lane: lane k < 10 forms sc4_breakout's k-th value, shuffled to all (on one
// lane the nine float64 pows run one after another, ~0.6 us each on the
// H100).
template <typename C, typename Params>
__device__ __forceinline__ SC4Walker<C> sc4_walker_lanes(const double* p, const Params& P,
                                                         int ndim, double t_exp) {
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
    return sc4_breakout<C>([&](int k) { return pw[k]; }, p, P, ndim, t_exp);
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
    const SC4Consts<C> k = sc4_consts<C>(P, P.inv_yscale);
    return warp_log_likelihood<C>(P,
                                  [&](int n) { return sc4_point<C>(n, w, k, d, K, use_sigma); });
}
