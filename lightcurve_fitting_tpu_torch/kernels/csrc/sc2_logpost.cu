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
//       of ladder.cuh over SC2WarpModel.
//   K7, K7h, K9 over ShockCooling2: the value and gradient of the
//       log-posterior (jax.value_and_grad of K1's graph), the HMC and the
//       NUTS transitions, the templates of gradient.cuh over SC2Model, whose
//       value_and_grad is sc2_value_and_grad_warp below (K7 at large widths)
//       and value_and_grad_block sc2_value_and_grad_block (K9, K7h, K7 at
//       small widths).
//
// What bounds it on the H100: FP32 ALU work. One evaluation is ~23.5k flops
// over the N = 149 points of the flagship, of which the degree-40 Clenshaw
// recurrence is 3 * deg * N ~ 17.9k; the per-point data is 28.6 KB in f32
// (57.2 KB in f64) and is shared by every walker, so device-memory traffic
// is negligible.
// What the design does about it: the per-point constants are staged once
// per block in shared memory and the prior bounds are tested first (an
// out-of-prior walker returns -inf without touching the likelihood; the JAX
// graph evaluates it and masks it afterwards: same value; K6b evaluates it,
// as the ladder's swaps read log L alone). Every kernel
// computes a point through one __device__ function, sc2_forward (T, L and R
// with their power laws, the clip, the Clenshaw recurrence, the residual);
// the kernels differ in who sums the points, and in what order:
// - K1, K2, K6a and K6b run a warp per walker (SC2WarpModel): lane l takes
//   the points l, l + 32, ... (five at most, 93% of the slots busy), sums
//   its terms in that order, and a butterfly sums the lanes
//   (sc2_log_likelihood_warp). A warp takes its walkers in batches whose
//   prologues (proposal, prior, constants) run a walker a lane
//   (stretch.cuh, warp_batch_ll). K1 (the batch log-posterior,
//   logpost_warp_kernel) and K6b (the ladder's initial state,
//   ladder_init_kernel) are the half-steps' warp form without the
//   proposal, at a compile-time ndim (SC2WarpModel<C, 4 or 5>: the
//   walker's parameters in registers), so a state's initial value has the
//   bits that K2 or K6a stores when it accepts that state. A thread per
//   walker, their earlier form, summed the points in time order and never
//   took less than ~0.18 ms however few the walkers (one thread walking all
//   149 points through a dependent Clenshaw chain: latency, not the ALU
//   rate). This is K7's order and code, so a proposal's log-posterior in
//   K2 and K6a has K7's value bits at the same parameters (chip_smoke.py
//   checks it): in float32 through the compiler's forms, in float64 through
//   K7's forms written by hand (sc2_forward's EXACT; without the intrinsic
//   scatter, whose variance K7 may fuse otherwise).
// - K7, K7h and K9 add the derivative recurrence and the reverse pass to
//   sc2_forward (sc2_point) and fold the points in the warp's order.
// Lane l reads row l of the (N, 41) coefficient table at offset 41 l + k:
// 41 is odd, so in float32 the 32 lanes hit 32 banks; in float64 the 8-byte
// words go in half-warps and 82 l mod 32 (in 4-byte banks) takes 16
// distinct even values over l = 0..15. (Reasoned, not counted: ncu does not
// run on the card's machine.)
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/time_port_kernels.py,
// the profiler's device time): K2 0.0148 ms per half 32, 0.067 per 16384,
// 0.234 per 65536 (a thread per walker: 0.21, 0.19, 0.28); K6a 0.0153 ms
// per 7 rungs x half 16, 0.141 per 17 x 2048 (0.21, 0.22). At the large
// widths a walker costs about what it did a thread per walker: the point's
// instructions (four powf, the recurrence) set the time, not the latency.
// Interleaving a lane's two points in one loop (two chains at once) was
// 18% slower at half 65536: at the 64-register cap of 1024-thread blocks
// it spills.
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

// The walker's parameters in the compute type, and the model's constants.
template <typename C>
struct SC2Walker {
    C T1, L1, t_tr, t_exp, eT, eL, a_mod, alpha, c3, inv_yscale, sig;
};

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

// The Gaussian log-likelihood of the ShockCooling2 band fluxes of the walker
// with constants w, float64, -inf when not finite; it does not look at the
// priors. Computed by the 32 lanes of a warp together (K1, K2, K6a, K6b),
// every lane returning the same bits:
// lane l sums the terms of points l, l + 32, l + 64, ... in that order, then
// a butterfly shuffle sums the lanes. This is the order of K7's value
// (sc2_value_and_grad_warp), without the derivatives.
template <typename C>
__device__ double sc2_log_likelihood_warp(const SC2Walker<C>& w, const PointData<C>& d,
                                          const SC2Params& P) {
    const int N = (int)P.n_points, K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    C acc = C(0);
    for (int n = threadIdx.x & 31; n < N; n += 32)
        sc2_add_term<C, true>(
            acc, sc2_forward<C, true>(n, w, d, K, use_sigma, sc2_no_before(), sc2_no_link()).r,
            use_sigma);
    return finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The value and gradient of the log-posterior (K7's device function in its
// two forms, and the evaluations of K9 and K7h): the log-posterior of one
// walker at absolute float64 parameters p[ndim] and its raw gradient
// g[ndim]. The residual terms and
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

// The warp form (K7 at large widths): called by the 32 lanes of a warp with
// the same p; lane l runs slot l. Every lane returns the same bits.
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

// The block form (K9, K7h, K7 at small widths): called by every thread of
// the block with the same p[NDIM] (NDIM == P.ndim). Thread t computes the points t, t + blockDim,
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

// The policy of K1, K2, K6a and K6b over ShockCooling2: a warp per walker
// (logpost_warp_kernel, stretch_half_step_kernel, tempered_half_step_kernel
// with WARP, ladder_init_kernel), 32 warps a block in float32 (the tables,
// 28.6 KB, staged once a block) and 16 in float64 (57.2 KB, over the 48 KB
// default: smem_plan opts in, and warp_layout's occupancy query sees it),
// batched: a warp takes its walkers in batches whose prologues (the
// proposal, the prior, sc2_walker's casts) run a walker a lane, the
// walker's 11 constants shuffled to the warp for its points (warp_layout,
// warp_batch_ll). N: the walker's dimension at compile time (policy_dim),
// or 0 (P.ndim). K1 and K6b take N = 4, or 5 with the intrinsic scatter, so
// that the walker's parameters live in registers (at a runtime dimension
// the SC3 batch kernel took a 72-byte stack frame); the half-steps keep
// N = 0, their code and bits unchanged.
template <typename C, int N>
struct SC2WarpModel : SC2Model<C> {
    typedef SC2Walker<C> Walker;
    static constexpr int warps_per_block = sizeof(C) == sizeof(float) ? 32 : 16;
    static constexpr bool batched = true;
    static constexpr int ndim = N;
    static __device__ Walker walker(const double* p, const SC2Params& P) {
        return sc2_walker<C>(p, P, N > 0 ? N : (int)P.ndim);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const PointData<C>& d,
                                                 const SC2Params& P) {
        return sc2_log_likelihood_warp<C>(w, d, P);
    }
};

template <typename C>
using SC2WarpModelAnyDim = SC2WarpModel<C, 0>;
template <typename C>
using SC2WarpModel4 = SC2WarpModel<C, 4>;
template <typename C>
using SC2WarpModel5 = SC2WarpModel<C, 5>;

// ------------------------------------------------------------------ launch

extern "C" {

// K1 launch, a warp per walker (logpost_warp_kernel over SC2WarpModel of
// the walker's dimension, 4 or 5). Returns 0 or a cudaError_t code.
int sc2_logpost_launch(const SC2Params* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, double* out, void* stream) {
    if (P->ndim == 4)
        return launch_logpost<SC2WarpModel4>(P, device, compute_f64, q, q_f64, W, out, stream);
    if (P->ndim == 5)
        return launch_logpost<SC2WarpModel5>(P, device, compute_f64, q, q_f64, W, out, stream);
    return (int)cudaErrorInvalidValue;
}

// K2 launch, a warp per walker (SC2WarpModel, the walker's dimension at run
// time). chain_x/chain_lp may be null (a thinned step that is not stored).
// Returns 0 or a cudaError_t code.
int stretch_half_step_launch(const SC2Params* P, int device, int compute_f64, void* x,
                             int state_f64, double* logp, int half, int h, const void* u_z,
                             const long long* j, const void* u_acc, double a, void* chain_x,
                             int chain_x_f64, void* chain_lp, int chain_lp_f64,
                             int* n_accept, void* stream) {
    return launch_half_step<SC2WarpModelAnyDim>(P, device, compute_f64, x, state_f64, logp, half, h,
                                          u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,
                                          chain_lp_f64, n_accept, stream);
}

// K6a launch over ShockCooling2 (ladder.cuh), a warp per walker
// (SC2WarpModel). Returns 0 or a cudaError_t code.
int sc2_tempered_half_step_launch(const SC2Params* P, int device, int compute_f64, void* x,
                                  int state_f64, double* logpri, double* logl,
                                  const double* betas, int n_rungs, int half, int h,
                                  const void* u_z, const long long* j, const void* u_acc,
                                  double a, int* n_accept, void* stream) {
    return launch_tempered_half_step<SC2WarpModelAnyDim, true>(P, device, compute_f64, x,
                                                               state_f64, logpri, logl, betas,
                                                               n_rungs, half, h, u_z, j, u_acc,
                                                               a, n_accept, stream);
}

// K6b launch over ShockCooling2 (ladder.cuh), a warp per state
// (SC2WarpModel of the walker's dimension, 4 or 5): n states, per_set a
// set, each set's values written to `copies` consecutive rows of per_set.
// Returns 0 or a cudaError_t code.
int sc2_ladder_init_launch(const SC2Params* P, int device, int compute_f64, const void* x,
                           int state_f64, int n, int per_set, int copies, double* logpri,
                           double* logl, void* stream) {
    if (P->ndim == 4)
        return launch_ladder_init<SC2WarpModel4>(P, device, compute_f64, x, state_f64, n,
                                                 per_set, copies, logpri, logl, stream);
    if (P->ndim == 5)
        return launch_ladder_init<SC2WarpModel5>(P, device, compute_f64, x, state_f64, n,
                                                 per_set, copies, logpri, logl, stream);
    return (int)cudaErrorInvalidValue;
}

// K7 launch: val (W,) and grad (W, ndim) at the float64 rows q, in the
// whitened space of T when T is not null; block 0 runs the warp form (a
// warp per row), 1 the block form (a block per row, ndim 4, or 5 with the
// intrinsic scatter; scratch may be null when sc2_block_scratch_len gives
// 0). Returns 0 or a cudaError_t code.
int sc2_logpost_grad_launch(const SC2Params* P, int device, int compute_f64,
                            const WhiteParams* T, const double* q, int W, double* val,
                            double* grad, int block, double* scratch, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->has_affine || (T && T->ndim != P->ndim) ||
        (block && P->ndim != 4 + (P->use_sigma != 0)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (!block)
        return compute_f64 ? launch_logpost_grad<SC2Model<double>>(*P, T, q, W, val, grad, s)
                           : launch_logpost_grad<SC2Model<float>>(*P, T, q, W, val, grad, s);
#define LP_K7B(C_, N_) \
    launch_logpost_grad_block<SC2Model<C_>, N_>(*P, T, q, W, val, grad, scratch, s)
    if (P->ndim == 4) return compute_f64 ? LP_K7B(double, 4) : LP_K7B(float, 4);
    return compute_f64 ? LP_K7B(double, 5) : LP_K7B(float, 5);
#undef LP_K7B
}

// The float64 scratch, in doubles, that a block-per-chain launch over C
// chains (or rows) needs for what does not fit in shared memory: K9's at
// max_depth >= 1 (the workspace and the trajectory buffer), K7h's and K7's
// block form's at 0 (the workspace); 0 when it all fits, or minus a
// cudaError_t code.
long long sc2_block_scratch_len(const SC2Params* P, int device, int compute_f64, int max_depth,
                                int C) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return -rc;
    const int ndim = (int)P->ndim;
    const long long per_chain = compute_f64
        ? block_scratch<SC2Model<double>>(*P, ndim, max_depth)
        : block_scratch<SC2Model<float>>(*P, ndim, max_depth);
    return per_chain * C;
}

// K9 launch (gradient.cuh), for ndim 4 (5 with the intrinsic scatter);
// scratch may be null when sc2_block_scratch_len gives 0. Returns 0 or a
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

// K7h launch (gradient.cuh), for ndim 4 (5 with the intrinsic scatter);
// scratch may be null when sc2_block_scratch_len gives 0. Returns 0 or a
// cudaError_t code.
int sc2_hmc_transition_launch(const SC2Params* P, int device, int compute_f64,
                              const WhiteParams* T, const double* q, const double* logp,
                              const double* z, const double* u_acc, const long long* n_used,
                              const double* eps, const double* inv_mass, int C, double* q_out,
                              double* logp_out, double* accept_prob, double* scratch,
                              void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (C <= 0) return 0;
    if (P->ndim != 4 + (P->use_sigma != 0) || P->has_affine || T->ndim != P->ndim)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LP_HMC(C_, N_)                                                                    \
    launch_hmc<SC2Model<C_>, N_>(*P, *T, q, logp, z, u_acc, n_used, eps, inv_mass, C, q_out, \
                                 logp_out, accept_prob, scratch, s)
    if (P->ndim == 4) return compute_f64 ? LP_HMC(double, 4) : LP_HMC(float, 4);
    return compute_f64 ? LP_HMC(double, 5) : LP_HMC(float, 5);
#undef LP_HMC
}

}  // extern "C"
