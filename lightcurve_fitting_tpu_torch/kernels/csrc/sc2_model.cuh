// The ShockCooling2 point of the fused kernels: a walker's constants, the
// forward pass of one point (sc2_forward) and its reverse pass (sc2_point),
// and the priors with their gradient. Shared by
// the single-light-curve kernels of sc2_logpost.cu (K1, K2, K6a, K6b, K7,
// K7h, K9) and the per-transient population kernels of population.cu (P1,
// P2, P3), so that a point rounds alike in all of them.

#pragma once

#include "band_table.cuh"

// The walker's parameters in the compute type, and the model's constants.
template <typename C>
struct SC2Walker {
    C T1, L1, t_tr, t_exp, eT, eL, a_mod, alpha, c3, inv_yscale, sig;
};

// Point n's forward pass, and what the reverse pass reads of it.
template <typename C>
struct SC2Forward {
    C tt, ptT, T, uu, pu, E, ptL, L1E, sL, pT2, c3sL, R;   // ShockCooling2._tr_points
    C s_a, s, b1, b2, G, F;   // the band table: s, the recurrence's last two links, g, the flux
    C r, res, sigma2, sg;     // the residual (res, sigma2, sg: with the intrinsic scatter)
    bool tpos, upos, Tpos, clipped;
};

// Point n of the walker w, forward: the power laws of ShockCooling2._tr_points
// (0 where power's base is <= 0 or NaN, ops/mathx.py:28-57), T, L and R, the
// band table's s = clip(a ln T - b, -1, 1) and its degree-(K-1) Clenshaw
// recurrence (skipped where T <= 0 or NaN: zero flux), y_fit, and the
// residual r: (y - y_fit) / dy, whose square is the point's term, or with
// the intrinsic scatter the term log(2 pi sigma2) + res^2 / sigma2 itself.
// Every kernel of this file computes its points here. The gradient's
// sc2_point adds to it through two hooks: before(f), called once T, L and R
// are known and before the recurrence, and link(two_s, b1, b2), called at
// each link of the recurrence before it moves; the value alone passes
// no-ops (sc2_no_before, sc2_no_link).
// EXACT (the value path of K1, K2, K6a and K6b): in float64 the products
// that meet a sum are fused or rounded by hand, in the forms of K7's
// compiled point (fma in s, in the recurrence's links, in ln g and in the
// residual y - F / yscale; the squared residual rounded before it is
// summed), so that every inlined copy of the point rounds alike and as K7.
// Left to the compiler, the two copies that warp_batch_ll inlines (one
// walker a warp, a batch a warp) fused them differently in float64: a
// state's value depended on the batch size of the launch that evaluated it,
// and differed from K7's in the last bit of ~20% of the values at the
// large widths. Float32 keeps the compiler's forms, whose copies agree.
template <typename C, bool EXACT = false, typename Before, typename Link>
__device__ __forceinline__ SC2Forward<C> sc2_forward(int n, const SC2Walker<C>& w,
                                                     const PointData<C>& d, int K,
                                                     bool use_sigma, Before before, Link link) {
    constexpr bool X = EXACT && sizeof(C) == sizeof(double);
    SC2Forward<C> f;
    f.tt = d.tc[n] - w.t_exp;
    f.tpos = f.tt > C(0);
    f.ptT = f.tpos ? m_pow(f.tt, w.eT) : C(0);
    f.T = w.T1 * f.ptT;
    f.uu = (w.a_mod * f.tt) / w.t_tr;
    f.upos = f.uu > C(0);
    f.pu = f.upos ? m_pow(f.uu, w.alpha) : C(0);
    f.E = m_exp(-f.pu);
    f.ptL = f.tpos ? m_pow(f.tt, w.eL) : C(0);
    f.L1E = w.L1 * f.E;
    const C L = f.L1E * f.ptL;
    f.sL = m_sqrt(L);
    f.Tpos = f.T > C(0);
    f.pT2 = f.Tpos ? m_pow(f.T, C(-2)) : C(0);
    f.c3sL = w.c3 * f.sL;
    f.R = f.c3sL * f.pT2;
    before(f);
    f.s_a = f.s = f.b1 = f.b2 = f.G = f.F = C(0);
    f.clipped = false;
    if (f.Tpos) {
        f.s_a = d.s_a[n];
        const C s_raw = X ? fma(m_log(f.T), f.s_a, -d.s_b[n]) : m_log(f.T) * f.s_a - d.s_b[n];
        f.clipped = !(s_raw >= C(-1) && s_raw <= C(1));
        f.s = s_raw < C(-1) ? C(-1) : (s_raw > C(1) ? C(1) : s_raw);   // NaN stays NaN
        const C two_s = C(2) * f.s;
        const C* c = d.coef + (size_t)n * K;
        C b1 = C(0), b2 = C(0);
        for (int k = K - 1; k >= 1; --k) {
            link(two_s, b1, b2);
            const C b0 = X ? add_rn(fma(two_s, b1, -b2), c[k]) : two_s * b1 - b2 + c[k];
            b2 = b1;
            b1 = b0;
        }
        f.b1 = b1;
        f.b2 = b2;
        const C ln_g = X ? add_rn(fma(f.s, b1, -b2), c[0]) : f.s * b1 - b2 + c[0];
        f.G = m_exp(ln_g);
        f.F = f.R * f.R * f.G;
    }
    if (X) {   // the residual y - F / yscale fused
        const C res = fma(-f.F, w.inv_yscale, d.y[n]);
        if (use_sigma) {
            f.res = res;
            f.sg = mul_rn(w.sig, d.su[n]);
            f.sigma2 = fma(d.dy[n], d.dy[n], mul_rn(f.sg, f.sg));
            f.r = add_rn(m_log(mul_rn((C)6.283185307179586, f.sigma2)),
                         div_rn(mul_rn(res, res), f.sigma2));
        } else {
            f.r = mul_rn(res, d.inv_dy[n]);
            f.res = f.sigma2 = f.sg = C(0);
        }
        return f;
    }
    const C y_fit = f.F * w.inv_yscale;
    if (use_sigma) {
        const C two_pi = (C)6.283185307179586;
        f.sg = w.sig * d.su[n];
        f.sigma2 = d.dy[n] * d.dy[n] + f.sg * f.sg;
        f.res = d.y[n] - y_fit;
        f.r = m_log(two_pi * f.sigma2) + f.res * f.res / f.sigma2;
    } else {
        f.r = (d.y[n] - y_fit) * d.inv_dy[n];
        f.res = f.sigma2 = f.sg = C(0);
    }
    return f;
}

struct sc2_no_before {
    template <typename F>
    __device__ __forceinline__ void operator()(const F&) const {}
};
struct sc2_no_link {
    template <typename C>
    __device__ __forceinline__ void operator()(C, C, C) const {}
};

// The point's term added to the residual sum: r * r, or r itself with the
// intrinsic scatter (EXACT: by hand in float64, as sc2_forward).
template <typename C, bool EXACT = false>
__device__ __forceinline__ void sc2_add_term(C& acc, C r, bool use_sigma) {
    constexpr bool X = EXACT && sizeof(C) == sizeof(double);
    if (use_sigma) {
        acc = X ? add_rn(acc, r) : acc + r;
    } else {
        acc = X ? add_rn(acc, mul_rn(r, r)) : acc + r * r;
    }
}

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
    sc2_add_term(s.acc, q.r, use_sigma);
    if (use_sigma) s.dsig += q.s0 * q.s1;
    s.dT1 += q.t0 * q.t1;
    s.dL1 += q.l0 * q.l1;
    s.dttr += q.ttr;
    s.dtt += q.tt;
}

// Point n's residual term (sc2_forward) and its reverse pass.
template <typename C>
__device__ __forceinline__ SC2Point<C> sc2_point(int n, const SC2Walker<C>& w,
                                                 const PointData<C>& d, int K, bool use_sigma) {
    // the power laws of the reverse pass, issued before the recurrence (they
    // do not depend on it), and the derivative recurrence run alongside it;
    // its product 2 s d_{k+1} is rounded on its own (mul_rn): the compiler
    // may fuse it with 2 b_{k+1} where this hook is inlined, which would
    // change K7's, K7h's and K9's gradient bits
    C pT3 = C(0), pua = C(0), ptL1 = C(0), ptT1 = C(0), d1 = C(0), d2 = C(0);
    const SC2Forward<C> f = sc2_forward<C>(
        n, w, d, K, use_sigma,
        [&](const SC2Forward<C>& v) {
            pT3 = v.Tpos ? m_pow(v.T, C(-3)) : C(0);
            pua = v.upos ? m_pow(v.uu, w.alpha - C(1)) : C(0);
            ptL1 = v.tpos ? m_pow(v.tt, w.eL - C(1)) : C(0);
            ptT1 = v.tpos ? m_pow(v.tt, w.eT - C(1)) : C(0);
        },
        [&](C two_s, C b1, C) {
            const C d0 = C(2) * b1 + mul_rn(two_s, d1) - d2;
            d2 = d1;
            d1 = d0;
        });
    const C dlng = f.Tpos ? f.b1 + f.s * d1 - d2 : C(0);
    SC2Point<C> q;
    q.r = f.r;
    C dy_fit;   // d term / d y_fit
    if (use_sigma) {
        dy_fit = C(-2) * f.res / f.sigma2;
        q.s0 = C(1) / f.sigma2 - f.res * f.res / (f.sigma2 * f.sigma2);
        q.s1 = C(2) * f.sg * d.su[n];
    } else {
        dy_fit = C(-2) * f.r * d.inv_dy[n];
        q.s0 = q.s1 = C(0);
    }
    // the reverse pass (cotangents of the residual term)
    const C ct_F = dy_fit * w.inv_yscale;
    const C ct_R = f.Tpos ? ct_F * (C(2) * f.R * f.G) : C(0);
    const C ct_s = f.Tpos && !f.clipped ? ct_F * f.F * dlng : C(0);
    C ct_T = f.Tpos ? ct_s * f.s_a / f.T : C(0);
    const C ct_pT2 = ct_R * f.c3sL;
    ct_T += f.Tpos ? ct_pT2 * (C(-2) * pT3) : C(0);
    const C ct_sL = (ct_R * f.pT2) * w.c3;
    const C ct_L = ct_sL * (C(0.5) / f.sL);
    const C ct_L1E = ct_L * f.ptL;
    const C ct_ptL = ct_L * f.L1E;
    const C ct_E = ct_L1E * w.L1;
    const C ct_pu = -(ct_E * f.E);
    const C ct_uu = f.upos ? ct_pu * (w.alpha * pua) : C(0);
    C ct_tt = (ct_uu / w.t_tr) * w.a_mod;
    ct_tt += f.tpos ? ct_ptL * (w.eL * ptL1) : C(0);
    ct_tt += f.tpos ? (ct_T * w.T1) * (w.eT * ptT1) : C(0);
    q.t0 = ct_T;
    q.t1 = f.ptT;
    q.l0 = ct_L1E;
    q.l1 = f.E;
    q.ttr = -ct_uu * f.uu / w.t_tr;
    q.tt = ct_tt;
    return q;
}

// The prior sum at p[ndim] and its gradient gprior; false outside the open
// bounds (NaN included).
template <int D, typename Params>
__device__ __forceinline__ bool sc2_prior(const double* p, const Params& P, int ndim,
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
