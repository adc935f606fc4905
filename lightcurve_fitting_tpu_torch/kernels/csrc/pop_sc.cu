// The per-transient ShockCooling (SW17) and ShockCooling4 (MSW23) kernels of
// the population fit (P1, P2) for sm_90a, bound to Python through a plain C
// interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/parallel/population.py):
//   P1  :349-386 make_logpost and :407-411 init_one, vmapped over the S
//       transients, over models/shock_cooling.py:96-125 (SW17's
//       _tr_points, kappa bound) and :247-282 (MSW23): the log-posterior of
//       every transient's walkers, the transients along blockIdx.y, in
//       population.cu's two forms (logpost_warp_kernel and
//       logpost_latency_kernel<..., ENS = true> over PopSCWarpModel and
//       PopSC4WarpModel; kernels/pop.py::logpost_form).
//   P2  :413-433 seg_one's step over the same make_logpost: one
//       stretch-move half-step of all S ensembles in one launch, in
//       population.cu's two forms (stretch_half_step_kernel and
//       stretch_half_step_latency_kernel<..., ENS = true>;
//       kernels/pop.py::half_form).
//
// The point is SCWarpModel's and SC4WarpModel's (sc_model.cuh: SW17's power
// laws with the model's n, RW and kappa; MSW23's breakout scales in float64,
// its two Clenshaw chains over one read of the row and their minimum), so
// it rounds as the single fit's kernels round. The phase and the likelihood
// are the population's (population.cuh): the transient's own t_ref (tt =
// C(t - t_ref) - C(t_exp - t_ref), t_exp = 0 below the most parameters), y
// and dy over its yscale, the sum over its n_real real points alone (the
// padded copies of the last real point skipped: where that point's model
// value is not finite the JAX graph's padded terms are NaN and log L is
// -inf, as here from the real point itself), pop_finish. A walker's
// constants do not depend on the transient, so the walker keeps t_exp
// absolute and each evaluation forms t_exp - t_ref of its transient.
//
// What bounds them on the H100: as P1 and P2 over ShockCooling2, the latency
// of one walker's chain; a point is a dozen power laws and the degree-40
// Clenshaw recurrence (MSW23 two, interleaved), ~2 us one after another, so
// the latency form (a block per walker, a point a thread) serves the small
// launches, the warp form the full card, as population.cu's rules pick.
// MSW23's nine float64 powers of a walker run a lane each in the latency
// forms (sc4_walker_lanes).

#include "population.cuh"
#include "sc_model.cuh"

// A walker's constants and its absolute t_exp (the model's walker formed at
// t_exp = 0; pop_sc_at puts in the transient's t_exp - t_ref).
template <typename W>
struct PopSCWalker {
    W w;
    double t_exp;
};

template <typename W, typename C>
__device__ __forceinline__ W pop_sc_at(const PopSCWalker<W>& v, const PopData<C>& d) {
    W w = v.w;
    w.t_exp = (C)(v.t_exp - d.t_ref);
    return w;
}

// The walker's absolute t_exp: the parameter after v_s*, M_env, f_rho M and
// R, 0 when not fitted.
__device__ __forceinline__ double pop_sc_t_exp(const double* p, const PopParams& P) {
    return P.n_model == 5 ? p[4] : 0.0;
}

// The policies of P1 and P2 over SW17 and MSW23: PopTableModel's form, the
// terms sc_term's (the squared residual, or with the intrinsic scatter the
// whole term) added with one rounding each. N: the walker's dimension, 4, 5
// or 6, at compile time. The warp form of the half-step is built for one
// block an SM (min_blocks): without it ptxas held its float32
// instantiations to 64 registers and spilled 8-68 bytes in 10 of 24.
template <typename C, int N>
struct PopSCWarpModel : PopTableModel<C, N> {
    static constexpr int min_blocks = 1;
    typedef PopData<C> Data;
    typedef PopSCWalker<SCWalker<C>> Walker;
    static __device__ Walker walker(const double* p, const PopParams& P) {
        Walker v;
        v.w = sc_walker<C>(p, P, N, 0.0);
        v.t_exp = pop_sc_t_exp(p, P);
        return v;
    }
    // Lane l adds the terms of its real points l, l + 32, ... in that
    // order, then the butterfly sums the lanes, every lane the same bits.
    static __device__ double log_likelihood_warp(const Walker& v, const Data& d,
                                                 const PopParams& P) {
        const SCWalker<C> w = pop_sc_at(v, d);
        const SCConsts<C> k = sc_consts<C>(P, (double)d.inv_yscale);
        const int K = (int)P.n_coef;
        const bool use_sigma = P.use_sigma != 0;
        C acc = C(0);
        for (int n = threadIdx.x & 31; n < d.n_real; n += 32)
            acc = add_rn(acc, sc_point<C>(n, w, k, d.pts, K, use_sigma));
        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
    }
    static __device__ C point_term(int n, const Walker& v, const Data& d, const PopParams& P) {
        return sc_point<C>(n, pop_sc_at(v, d), sc_consts<C>(P, (double)d.inv_yscale), d.pts,
                           (int)P.n_coef, P.use_sigma != 0);
    }
    static __device__ C add_term(C acc, C t, const PopParams&) { return add_rn(acc, t); }
};

template <typename C, int N>
struct PopSC4WarpModel : PopTableModel<C, N> {
    static constexpr int min_blocks = 1;
    typedef PopData<C> Data;
    typedef PopSCWalker<SC4Walker<C>> Walker;
    static __device__ Walker walker(const double* p, const PopParams& P) {
        Walker v;
        v.w = sc4_walker<C>(p, P, N, 0.0);
        v.t_exp = pop_sc_t_exp(p, P);
        return v;
    }
    static __device__ Walker walker_lanes(const double* p, const PopParams& P) {
        Walker v;
        v.w = sc4_walker_lanes<C>(p, P, N, 0.0);
        v.t_exp = pop_sc_t_exp(p, P);
        return v;
    }
    static __device__ double log_likelihood_warp(const Walker& v, const Data& d,
                                                 const PopParams& P) {
        const SC4Walker<C> w = pop_sc_at(v, d);
        const SC4Consts<C> k = sc4_consts<C>(P, (double)d.inv_yscale);
        const int K = (int)P.n_coef;
        const bool use_sigma = P.use_sigma != 0;
        C acc = C(0);
        for (int n = threadIdx.x & 31; n < d.n_real; n += 32)
            acc = add_rn(acc, sc4_point<C>(n, w, k, d.pts, K, use_sigma));
        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
    }
    static __device__ C point_term(int n, const Walker& v, const Data& d, const PopParams& P) {
        return sc4_point<C>(n, pop_sc_at(v, d), sc4_consts<C>(P, (double)d.inv_yscale), d.pts,
                            (int)P.n_coef, P.use_sigma != 0);
    }
    static __device__ C add_term(C acc, C t, const PopParams&) { return add_rn(acc, t); }
};

// P1 (form 0 the warp form, 1 the latency form) and P2 of the policy M for
// the state's type S, as population.cu launches them over ShockCooling2.
template <typename M, typename S>
static int launch_pop_sc_logpost(const PopParams& P, int form, const void* q, int W, int n_ens,
                                 double* out, cudaStream_t stream) {
    if (form) return launch_logpost_latency<M, S, true>(P, q, W, out, stream, n_ens);
    return launch_logpost_warp<M, S>(P, q, W, n_ens, out, stream);
}

template <typename M, typename S>
static int launch_pop_sc_half(const PopParams& P, int form, void* x, double* logp, int half,
                              int h, const void* u_z, const long long* j, const void* u_acc,
                              double a, void* chain_x, double* chain_lp, int* n_accept, int n_ens,
                              long long draw_stride, cudaStream_t stream) {
    if (form)
        return launch_half_latency<M, S, S, double, true>(P, x, logp, half, h, u_z, j, u_acc, a,
                                                          chain_x, chain_lp, n_accept, stream,
                                                          n_ens, draw_stride);
    return launch_half<M, S, S, double>(P, x, logp, half, h, u_z, j, u_acc, a, chain_x, chain_lp,
                                        n_accept, n_ens, draw_stride, stream);
}

// P1 and P2 of P.model's policy (1 ShockCooling, 2 ShockCooling4) at the
// compute type C, the walker dimension N and the state's type S.
template <typename C, int N, typename S>
static int pop_sc_p1(const PopParams& P, int form, const void* q, int W, int n_ens, double* out,
                     cudaStream_t stream) {
    if (P.model == 1)
        return launch_pop_sc_logpost<PopSCWarpModel<C, N>, S>(P, form, q, W, n_ens, out, stream);
    return launch_pop_sc_logpost<PopSC4WarpModel<C, N>, S>(P, form, q, W, n_ens, out, stream);
}

template <typename C, int N, typename S>
static int pop_sc_p2(const PopParams& P, int form, void* x, double* logp, int half, int h,
                     const void* u_z, const long long* j, const void* u_acc, double a,
                     void* chain_x, double* chain_lp, int* n_accept, int n_ens,
                     long long draw_stride, cudaStream_t stream) {
    if (P.model == 1)
        return launch_pop_sc_half<PopSCWarpModel<C, N>, S>(P, form, x, logp, half, h, u_z, j,
                                                           u_acc, a, chain_x, chain_lp, n_accept,
                                                           n_ens, draw_stride, stream);
    return launch_pop_sc_half<PopSC4WarpModel<C, N>, S>(P, form, x, logp, half, h, u_z, j, u_acc,
                                                        a, chain_x, chain_lp, n_accept, n_ens,
                                                        draw_stride, stream);
}

static bool pop_sc_valid(const PopParams& P, int S, int form) {
    return (P.model == 1 || P.model == 2) && (P.n_model == 4 || P.n_model == 5)
           && P.ndim == P.n_model + (P.use_sigma != 0) && S <= 65535 && (form == 0 || form == 1);
}

// ------------------------------------------------------------------ launch

extern "C" {

// P1 over SW17 (P->model 1) or MSW23 (2): out (S, W) at the walker states q
// (S, W, ndim), transient e along blockIdx.y; ndim 4, 5 or 6; form 0 the
// warp form, 1 the latency form. Returns 0 or a cudaError_t code.
int pop_sc_logpost_launch(const PopParams* P, int device, int compute_f64, const void* q,
                          int q_f64, int W, int S, double* out, int form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || S <= 0) return 0;
    if (!pop_sc_valid(*P, S, form)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_SC_P1(N_)                                                                     \
    (compute_f64 ? (q_f64 ? pop_sc_p1<double, N_, double>(*P, form, q, W, S, out, s)      \
                          : pop_sc_p1<double, N_, float>(*P, form, q, W, S, out, s))      \
                 : (q_f64 ? pop_sc_p1<float, N_, double>(*P, form, q, W, S, out, s)       \
                          : pop_sc_p1<float, N_, float>(*P, form, q, W, S, out, s)))
    switch (P->ndim) {
        case 4: return POP_SC_P1(4);
        case 5: return POP_SC_P1(5);
        case 6: return POP_SC_P1(6);
    }
#undef POP_SC_P1
    return (int)cudaErrorInvalidValue;
}

// P2 over SW17 or MSW23: one half-step of the S ensembles x (S, 2, half,
// ndim), the draws of ensemble e draw_stride after those of e - 1; chain_x
// (the state's type) and chain_lp may be null; ndim 4, 5 or 6; form 0 the
// warp form, 1 the latency form. Returns 0 or a cudaError_t code.
int pop_sc_half_step_launch(const PopParams* P, int device, int compute_f64, void* x,
                            int state_f64, double* logp, int half, int h, const void* u_z,
                            const long long* j, const void* u_acc, double a, void* chain_x,
                            double* chain_lp, int* n_accept, int S, long long draw_stride,
                            int form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || S <= 0) return 0;
    if (!pop_sc_valid(*P, S, form)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_SC_P2(C, N_, S_)                                                                  \
    pop_sc_p2<C, N_, S_>(*P, form, x, logp, half, h, u_z, j, u_acc, a, chain_x, chain_lp,      \
                         n_accept, S, draw_stride, s)
#define POP_SC_P2_DIM(N_)                                                                     \
    (compute_f64 ? (state_f64 ? POP_SC_P2(double, N_, double) : POP_SC_P2(double, N_, float)) \
                 : (state_f64 ? POP_SC_P2(float, N_, double) : POP_SC_P2(float, N_, float)))
    switch (P->ndim) {
        case 4: return POP_SC_P2_DIM(4);
        case 5: return POP_SC_P2_DIM(5);
        case 6: return POP_SC_P2_DIM(6);
    }
#undef POP_SC_P2_DIM
#undef POP_SC_P2
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
