// The blackbody band sum shared by the quadrature kernels: K3 and the
// ShockCooling3 log-posterior and half-step (sc3_logpost.cu), and K4
// (epoch_bb.cu). One Planck term for all of them; the warp forms of
// epoch_bb.cu (the epoch half-step, K4p) form the same term from staged
// node factors (band_flux_warp), and K4s from its staged nodes (in float32
// on the special-function unit: summary_sum).

#pragma once

#include "stretch.cuh"

// One Planck term of K3's band sum before its extinction and weight:
// c2 R^2 nu^3 cut / expm1(x), x = c1 nu / T (inv_T = 1 / T, or 0 for T <= 0
// or NaN), with x and 1 / expm1(x) (0 for x <= 0 and at Wien overflow) kept
// for the derivative. band_flux and K3's warp form (sc3_logpost.cu) both
// form their terms here, so the two give every term the same bits.
template <typename C>
struct PlanckTerm {
    C lnu, x, pdi;
};

template <typename C>
__device__ __forceinline__ PlanckTerm<C> planck_term(C nuk, C inv_T, C c2R2, C c1,
                                                     bool has_cutoff, C cutoff) {
    const C x = (c1 * nuk) * inv_T;
    const C e = m_expm1(x);
    const C pdi = e > C(0) ? C(1) / e : C(0);  // x <= 0 -> 0; Wien overflow 1/inf = 0
    C lnu = c2R2 * (nuk * nuk * nuk);
    if (has_cutoff) {
        const C cut = cutoff / nuk;
        lnu = lnu * (cut < C(1) ? cut : C(1));
    }
    return {lnu * pdi, x, pdi};
}

// 1 / T as band_flux takes it: safe_reciprocal, T <= 0 or NaN -> 0.
template <typename C>
__device__ __forceinline__ C planck_inv_T(C T) {
    return T > C(0) ? C(1) / T : C(0);
}

// K3's band sum for one point: sum_{k < n_k} w[k] * L_nu(nu[k]; T, R) *
// 10^(-0.4 kx[k] ebv), over one row of the node, weight and extinction
// tables (kx null: no extinction), with L_nu = c2 R^2 nu^3 cut / expm1(x),
// x = c1 nu / T, in the reference's term order.
// GRAD: also writes dS/dT = sum_k w[k] L_nu (1 + 1/expm1(x)) x / T into
// *dS_dT, the analytic derivative of the same terms (T <= 0, where the flux
// is 0, and Wien-overflowed terms give 0).
template <typename C, bool GRAD = false>
__device__ __forceinline__ C band_flux(const C* nu, const C* w, const C* kx, int n_k, C T, C R,
                                       C ebv, C c1, C c2, C ext_coef, bool has_cutoff,
                                       C cutoff, C* dS_dT = nullptr) {
    const C inv_T = planck_inv_T(T);
    const C c2R2 = c2 * (R * R);
    C acc = C(0);
    C dacc = C(0);
    for (int k = 0; k < n_k; ++k) {
        const PlanckTerm<C> t = planck_term(nu[k], inv_T, c2R2, c1, has_cutoff, cutoff);
        C lnu = t.lnu;
        if (kx != nullptr) lnu = lnu * m_exp((kx[k] * ebv) * ext_coef);
        acc += w[k] * lnu;
        if constexpr (GRAD) if (lnu != C(0)) dacc += w[k] * (lnu * (C(1) + t.pdi) * (t.x * inv_T));
    }
    if constexpr (GRAD) *dS_dT = dacc;
    return acc;
}
