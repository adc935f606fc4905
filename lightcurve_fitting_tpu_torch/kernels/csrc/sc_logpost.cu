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

#include "sc_model.cuh"
#include "ladder.cuh"

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
        return sc_walker<C>(p, P, N > 0 ? N : (int)P.ndim, p[4] - P.t_ref);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const PointData<C>& d,
                                                 const SCParams& P) {
        return sc_log_likelihood_warp<C>(w, d, P);
    }
    static __device__ C point_term(int n, const Walker& w, const PointData<C>& d,
                                   const SCParams& P) {
        return sc_point<C, true>(n, w, sc_consts<C>(P, P.inv_yscale), d, (int)P.n_coef,
                                 P.use_sigma != 0, (const C*)P.coef_t, (int)P.n_points);
    }
};

template <typename C, int N>
struct SC4WarpModel : SCTableModel<C, N> {
    typedef SC4Walker<C> Walker;
    static __device__ Walker walker(const double* p, const SCParams& P) {
        return sc4_walker<C>(p, P, N > 0 ? N : (int)P.ndim, p[4] - P.t_ref);
    }
    static __device__ Walker walker_lanes(const double* p, const SCParams& P) {
        return sc4_walker_lanes<C>(p, P, N > 0 ? N : (int)P.ndim, p[4] - P.t_ref);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const PointData<C>& d,
                                                 const SCParams& P) {
        return sc4_log_likelihood_warp<C>(w, d, P);
    }
    static __device__ C point_term(int n, const Walker& w, const PointData<C>& d,
                                   const SCParams& P) {
        return sc4_point<C, true>(n, w, sc4_consts<C>(P, P.inv_yscale), d, (int)P.n_coef,
                                  P.use_sigma != 0, (const C*)P.coef_t, (int)P.n_points);
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
