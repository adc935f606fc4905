// The quadrature band flux (K3), the fused ShockCooling3 log-posterior and
// its stretch-move half-step, for sm_90a, bound to Python through a plain C
// interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K3  the Pallas kernel ops/pallas_bandflux.py:61 bandflux_pallas
//       (pallas_call at :85; removed in 86c8937, read it with
//       `git show 0ee4f99:lightcurve_fitting_tpu/ops/pallas_bandflux.py`),
//       whose computation lives on in models/blackbody.py:27-73 (planck_lnu,
//       bandflux_pointwise): y[w,n] = sum_k W[n,k] c2 R^2 nu^3 cut
//       / expm1(c1 nu / T) * exp(-0.4 ln10 k_ext E(B-V)).
//   SC3 log-posterior: fitting.py:62-68 fused by XLA with models/base.py:278-288,
//       models/shock_cooling.py:71-98 (temperature_radius) and :201-208
//       (ShockCooling3._eval_points), ops/mathx.py and K3.
//   SC3 half-step: parallel/sampler.py:38-57, :86-95, :97-104 and :205-225,
//       the stretch_half_step_kernel template of stretch.cuh over
//       SC3WarpModel, a warp per walker; the batch log-posterior (a fit's
//       initial state) its logpost_warp_kernel over the same policy.
//   K6a, K6b over ShockCooling3: the templates of ladder.cuh, K6a over
//       SC3Model, K6b over SC3WarpModel (the batch log-posterior's form).
//
// What bounds it on the H100: the special functions. Each quadrature term
// is one expm1, one exp and one division (~60 instructions in all), and one
// SC3 evaluation on the flagship is 5738 such terms (13261 with the padding);
// the tables, 3 x 9 bands x 89 nodes, are 9.6 KB in f32 and shared by every
// walker, so device-memory traffic is negligible. The operations bound of
// the half-step is ~0.084 ms per half 16384 (the fit's width).
// What the design does about it: the per-band tables are staged once per
// block in shared memory and indexed through each point's band id, so no
// per-point (N, K) gather is ever materialized, and each point sums only its
// band's native nodes (the zero-weight padding past them adds nothing to a
// finite sum), 5738 terms against 13261. The half-step and the batch
// log-posterior run a warp per walker: a thread per walker left the fits'
// widths with one warp of 4 per SM (half 16384, or the 32768 walkers of an
// initial state) or a single warp (half 32, 64 walkers), so that the latency
// of one thread's 5738 terms set each at ~1.25 ms; K6b runs the same warp
// form. K6a over SC3 keeps a thread per walker over the points in order, so
// a warp works on one band at a time (broadcast table reads, one loop
// length). The lanes take the points
// in the order of kernels/sc3.py::point_order, by descending native node
// count, so the 32 points a warp runs at once have near-equal loop lengths:
// a lane runs 212 nodes on the flagship (440 in the time order), 85% of its
// slots busy; each lane sums its residual terms in that order and a
// butterfly sums the lanes, a fixed order from run to run. The standalone K3
// runs one block column per point and one thread per walker, over all K
// nodes: the JAX function's padded sum.
// One __device__ function (band_flux, planck.cuh) carries the band sum for
// all the kernels, so a proposal's band fluxes are bit-identical to K3's
// evaluation of the same T, R and E(B-V) over the same nodes; the epoch
// blackbody kernels of epoch_bb.cu call it too. The half-step and the batch
// log-posterior (and K6b) share the warp's residual sum, so a state's batch
// value has the bits the half-step stored when it accepted that state; K6a
// over SC3 sums in another order, and agrees with them to rounding.
//
// Dtype semantics follow the JAX accelerator path: the SW17 power laws run
// in the compute type C on C-cast parameters, tt = C(t - t_ref) - C(t_exp -
// t_ref), and each term keeps the reference's order, (((c2 R^2) nu^3) cut)
// / expm1((c1 nu) / T) * exp((k_ext E(B-V)) (-0.4 ln10)), with expm1 (the
// Pallas kernel's exp - 1 is not copied), T <= 0 or NaN giving x = 0 and a
// zero term, and Wien overflow 1/inf = 0. The flux ((lum 1e-30) c4_30) is
// divided in float64 by d_L^2 (d_L is not cast), then rounded to C for the
// residual sum, as the JAX graph promotes it.

#include "ladder.cuh"
#include "planck.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/sc3.py (_SC3Params) matches it field for field.
struct SC3Params {
    const void* t_centered;      // (N,) compute type: t - t_ref
    const void* y;               // (N,) y / yscale
    const void* inv_dy;          // (N,) yscale / dy
    const void* dy;              // (N,) dy / yscale
    const void* sigma_units;     // (N,)
    const void* nodes;           // (B, K) emitted-frame nodes (THz), one row per band
    const void* weights;         // (B, K) quadrature weights
    const void* k_ext;           // (B, K) F99 A/E(B-V) at the nodes
    const long long* band_ids;   // (N,) each point's row
    const long long* n_native;   // (B,) each row's node count before its zero-weight padding
    const long long* point_order;  // (N,) the points by descending native node count
    long long n_points;
    long long n_bands;
    long long n_nodes;
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
    double eps1;
    double eps2;
    double L0_42;
    double T0;
    double tph_to_tcol;
    double k_B;
    double c1;
    double c2;
    double c3_42;
    double c4_30;
    double ext_coef;             // -0.4 ln 10
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

// The standalone K3's arguments; the same 8-byte layout rule (mirror:
// kernels/sc3.py _BandfluxParams).
struct BandfluxParams {
    const void* nodes;           // (B, K) compute type
    const void* weights;         // (B, K)
    const void* k_ext;           // (B, K), or null: no extinction
    const long long* band_ids;   // (N,), or null: row n for point n (B = N)
    const void* T;               // (W, N) contiguous
    const void* R;               // (W, N) contiguous
    const void* ebv;             // element (w, n) at ebv[w * ebv_stride_w + n * ebv_stride_n]
    void* out;                   // (W, N) contiguous
    long long n_walkers;
    long long n_points;
    long long n_nodes;
    long long ebv_stride_w;
    long long ebv_stride_n;
    long long has_cutoff;
    double cutoff;               // THz; used when has_cutoff
    double c1;
    double c2;
    double ext_coef;             // -0.4 ln 10
};

// K3: out[w, n] = the band flux of point n (row band_ids[n]) at T[w, n],
// R[w, n], ebv[w, n]. Block column blockIdx.x is point n, its threads are
// walkers (grid-stride over blockIdx.y); the block stages row n's tables.
template <typename C>
__global__ void __launch_bounds__(LP_THREADS) bandflux_kernel(const BandfluxParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    C* s_nu = reinterpret_cast<C*>(smem_raw);
    const int K = (int)P.n_nodes;
    C* s_w = s_nu + K;
    C* s_k = s_w + K;
    const int n = blockIdx.x;
    const long long row = P.band_ids != nullptr ? P.band_ids[n] : n;
    const bool has_ext = P.k_ext != nullptr;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        s_nu[k] = ((const C*)P.nodes)[row * K + k];
        s_w[k] = ((const C*)P.weights)[row * K + k];
        if (has_ext) s_k[k] = ((const C*)P.k_ext)[row * K + k];
    }
    __syncthreads();
    const C c1 = (C)P.c1, c2 = (C)P.c2, ext_coef = (C)P.ext_coef, cutoff = (C)P.cutoff;
    const long long N = P.n_points;
    for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x; w < P.n_walkers;
         w += (long long)gridDim.y * blockDim.x) {
        const size_t e = (size_t)w * N + n;
        const C ebv = has_ext ? ((const C*)P.ebv)[w * P.ebv_stride_w + n * P.ebv_stride_n] : C(0);
        ((C*)P.out)[e] = band_flux<C>(s_nu, s_w, has_ext ? s_k : nullptr, K, ((const C*)P.T)[e],
                                      ((const C*)P.R)[e], ebv, c1, c2, ext_coef,
                                      P.has_cutoff != 0, cutoff);
    }
}

template <typename C>
struct SC3Data {
    const long long* band;
    const long long* n_native;
    const long long* order;      // the warp form's point order (null for the thread form)
    const C* nu;
    const C* w;
    const C* kx;
    const C* tc;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
};

template <typename C>
__host__ __device__ inline size_t sc3_stage_bytes(const SC3Params& P, bool order) {
    return sizeof(long long) * (size_t)(P.n_points * (order ? 2 : 1) + P.n_bands)
           + sizeof(C) * (size_t)(3 * P.n_bands * P.n_nodes + 5 * P.n_points);
}

// Copy the band tables, band ids (and the point order, for the warp form)
// and per-point data into shared memory (every thread of the block takes
// part, so call it before any thread returns), or point at global memory
// when they exceed the block's limit.
template <typename C>
__device__ SC3Data<C> stage_sc3(const SC3Params& P, unsigned char* smem, int use_smem,
                                bool order) {
    const long long N = P.n_points, BK = P.n_bands * P.n_nodes;
    SC3Data<C> d;
    d.order = nullptr;
    if (use_smem) {
        long long* si = reinterpret_cast<long long*>(smem);
        d.band = stage_array(P.band_ids, N, si);
        d.n_native = stage_array(P.n_native, P.n_bands, si);
        if (order) d.order = stage_array(P.point_order, N, si);
        C* s = reinterpret_cast<C*>(si);
        d.nu = stage_array((const C*)P.nodes, BK, s);
        d.w = stage_array((const C*)P.weights, BK, s);
        d.kx = stage_array((const C*)P.k_ext, BK, s);
        d.tc = stage_array((const C*)P.t_centered, N, s);
        d.y = stage_array((const C*)P.y, N, s);
        d.inv_dy = stage_array((const C*)P.inv_dy, N, s);
        d.dy = stage_array((const C*)P.dy, N, s);
        d.su = stage_array((const C*)P.sigma_units, N, s);
        __syncthreads();
    } else {
        d.band = P.band_ids;
        d.n_native = P.n_native;
        if (order) d.order = P.point_order;
        d.nu = (const C*)P.nodes;
        d.w = (const C*)P.weights;
        d.kx = (const C*)P.k_ext;
        d.tc = (const C*)P.t_centered;
        d.y = (const C*)P.y;
        d.inv_dy = (const C*)P.inv_dy;
        d.dy = (const C*)P.dy;
        d.su = (const C*)P.sigma_units;
    }
    return d;
}

// The walker's factors of SW17 in the compute type (the JAX graph forms
// them per point: same values) and the model's constants.
template <typename C>
struct SC3Walker {
    C v_s, R, ebv, t_exp, sig, A, a_mod, alpha, eps1, neg_eps2, L0, T0, tph_to_tcol, k_B, c1,
        c2, c3, c4, ext_coef, inv_yscale, fk, v2, t_tr, kappa, kappa_q, R_q;
    double dist2;
};

// N: the walker's dimension at compile time (then p may live in
// registers), or 0 (P.ndim).
template <typename C, int N = 0>
__device__ __forceinline__ SC3Walker<C> sc3_walker(const double* p, const SC3Params& P) {
    SC3Walker<C> w;
    const int ndim = N > 0 ? N : (int)P.ndim;
    w.v_s = (C)p[0];
    const C M_env = (C)p[1];
    const C f_rho_M = (C)p[2];
    w.R = (C)p[3];
    w.dist2 = p[4] * p[4];
    w.ebv = (C)p[5];
    w.t_exp = (C)(p[6] - P.t_ref);
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    w.kappa = (C)P.kappa;
    w.A = (C)P.A, w.a_mod = (C)P.a_model, w.alpha = (C)P.alpha;
    w.eps1 = (C)P.eps1, w.neg_eps2 = (C)(-P.eps2);
    w.L0 = (C)P.L0_42, w.T0 = (C)P.T0, w.tph_to_tcol = (C)P.tph_to_tcol, w.k_B = (C)P.k_B;
    w.c1 = (C)P.c1, w.c2 = (C)P.c2, w.c3 = (C)P.c3_42, w.c4 = (C)P.c4_30;
    w.ext_coef = (C)P.ext_coef, w.inv_yscale = (C)P.inv_yscale;
    w.fk = f_rho_M * w.kappa;
    w.v2 = w.v_s * w.v_s;
    w.t_tr = C(19.5) * m_pow(w.kappa * M_env / w.v_s, C(0.5));
    w.kappa_q = m_pow(w.kappa, C(-0.25));
    w.R_q = m_pow(w.R, C(0.25));
    return w;
}

// Point n's residual term: the SW17 power laws, its band's native
// quadrature (band_flux) and the Gaussian residual.
template <typename C>
__device__ __forceinline__ C sc3_point(int n, const SC3Walker<C>& w, const SC3Data<C>& d,
                                       const SC3Params& P, int K) {
    const C tt = d.tc[n] - w.t_exp;
    const C tt2 = tt * tt;
    const C L_RW = w.L0 * power0(tt2 * w.v_s / w.fk, w.neg_eps2) * w.v2 * w.R / w.kappa;
    const C L_42 = L_RW * w.A * m_exp(-power0(w.a_mod * tt / w.t_tr, w.alpha));
    const C T_ph = w.T0 * power0(tt2 * w.v2 / w.fk, w.eps1) * w.kappa_q * power0(tt, C(-0.5))
                   * w.R_q;
    const C T_K = T_ph * w.tph_to_tcol / w.k_B;
    const C R_bb = w.c3 * m_pow(L_42, C(0.5)) * power0(T_K, C(-2));
    const long long b = d.band[n];
    const C lum = band_flux<C>(d.nu + b * K, d.w + b * K, d.kx + b * K, (int)d.n_native[b], T_K,
                               R_bb, w.ebv, w.c1, w.c2, w.ext_coef, false, C(0));
    const double flux = (double)(lum * C(1e-30) * w.c4) / w.dist2;
    const C y_fit = (C)flux * w.inv_yscale;
    return residual_term<C>(P.use_sigma, y_fit, d.y[n], d.inv_dy[n], d.dy[n], d.su[n], w.sig);
}

// The Gaussian log-likelihood of the ShockCooling3 fluxes of one walker at
// absolute parameters p[ndim] = (v_s*, M_env, f_rho M, R, d_L, E(B-V),
// t_0[, sigma]), float64; -inf when not finite. It does not look at the
// priors. One thread walks the points in order.
template <typename C>
__device__ double sc3_log_likelihood(const double* p, const SC3Data<C>& d, const SC3Params& P) {
    const SC3Walker<C> w = sc3_walker<C>(p, P);
    const int N = (int)P.n_points;
    const int K = (int)P.n_nodes;
    C acc = C(0);
    for (int n = 0; n < N; ++n) acc += sc3_point<C>(n, w, d, P, K);
    return finish_log_likelihood<C>(acc, P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The same log-likelihood of the walker with factors w, computed by the 32
// lanes of a warp together (every lane returns the same bits): lane l takes
// the points d.order[l], d.order[l
// + 32], ..., in that order, and a butterfly shuffle sums the lanes. The
// order sorts the points by descending native node count, so the 32 points
// a warp works on at once have near-equal quadrature lengths (on the
// flagship a lane runs 212 nodes where the longest band alone has 88 per
// point, against 440 in the time order).
template <typename C>
__device__ double sc3_log_likelihood_warp(const SC3Walker<C>& w, const SC3Data<C>& d,
                                          const SC3Params& P) {
    const int N = (int)P.n_points;
    const int K = (int)P.n_nodes;
    C acc = C(0);
    for (int i = threadIdx.x & 31; i < N; i += 32) acc += sc3_point<C>((int)d.order[i], w, d, P, K);
    return finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The model policy of stretch.cuh and ladder.cuh for ShockCooling3 in
// compute type C.
template <typename C>
struct SC3Model {
    typedef SC3Params Params;
    typedef SC3Data<C> Data;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return sc3_stage_bytes<C>(P, false);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return stage_sc3<C>(P, smem, use_smem, false);
    }
    static __device__ double log_likelihood(const double* p, const Data& d, const Params& P) {
        return sc3_log_likelihood<C>(p, d, P);
    }
};

// The policy of the SC3 half-step, batch log-posterior and K6b: the warp
// form (stretch_half_step_kernel, logpost_warp_kernel, ladder_init_kernel),
// its data with the point order; four warps a block, a walker a warp
// (not batched: every lane forms the walker's proposal and factors), a block
// for every four walkers. N: the walker's dimension at compile time
// (policy_dim), or 0 (P.ndim). The batch log-posterior and K6b take N = 7,
// or 8 with the intrinsic scatter, so that the walker's parameters live in
// registers (at a runtime dimension they took a 72-byte stack frame and
// 1.2% of its time on the H100); the half-step keeps N = 0 (at N = 8 it
// spills under its launch bound).
template <typename C, int N>
struct SC3WarpModel : SC3Model<C> {
    typedef SC3Walker<C> Walker;
    static constexpr int warps_per_block = 4;
    static constexpr bool batched = false;
    static constexpr int ndim = N;
    static __device__ Walker walker(const double* p, const SC3Params& P) {
        return sc3_walker<C, N>(p, P);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const SC3Data<C>& d,
                                                 const SC3Params& P) {
        return sc3_log_likelihood_warp<C>(w, d, P);
    }
    static __host__ __device__ size_t stage_bytes(const SC3Params& P) {
        return sc3_stage_bytes<C>(P, true);
    }
    static __device__ SC3Data<C> stage(const SC3Params& P, unsigned char* smem, int use_smem,
                                       int) {
        return stage_sc3<C>(P, smem, use_smem, true);
    }
};

template <typename C>
using SC3WarpModelAnyDim = SC3WarpModel<C, 0>;
template <typename C>
using SC3WarpModel7 = SC3WarpModel<C, 7>;
template <typename C>
using SC3WarpModel8 = SC3WarpModel<C, 8>;

// ------------------------------------------------------------------ launch

template <typename C>
static int launch_bandflux(const BandfluxParams& P, cudaStream_t stream) {
    auto kernel = bandflux_kernel<C>;
    const size_t bytes = 3 * sizeof(C) * (size_t)P.n_nodes;
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // a row longer than shared memory
    const long long col_blocks = (P.n_walkers + LP_THREADS - 1) / LP_THREADS;
    const dim3 grid((unsigned)P.n_points, (unsigned)(col_blocks < 65535 ? col_blocks : 65535));
    kernel<<<grid, LP_THREADS, bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

extern "C" {

// K3 launch. Returns 0 or a cudaError_t code.
int bandflux_launch(const BandfluxParams* P, int device, int compute_f64, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->n_walkers <= 0 || P->n_points <= 0) return 0;
    if (P->n_points > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return compute_f64 ? launch_bandflux<double>(*P, s) : launch_bandflux<float>(*P, s);
}

// SC3 log-posterior launch, a warp per walker (logpost_warp_kernel over
// SC3WarpModel of the walker's dimension, 7 or 8). Returns 0 or a
// cudaError_t code.
int sc3_logpost_launch(const SC3Params* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, double* out, void* stream) {
    if (P->ndim == 7)
        return launch_logpost<SC3WarpModel7>(P, device, compute_f64, q, q_f64, W, out, stream);
    if (P->ndim == 8)
        return launch_logpost<SC3WarpModel8>(P, device, compute_f64, q, q_f64, W, out, stream);
    return (int)cudaErrorInvalidValue;
}

// SC3 half-step launch, a warp per walker (SC3WarpModel, the walker's
// dimension at run time); the arguments of stretch_half_step_launch
// (sc2_logpost.cu). Returns 0 or a cudaError_t code.
int sc3_half_step_launch(const SC3Params* P, int device, int compute_f64, void* x,
                         int state_f64, double* logp, int half, int h, const void* u_z,
                         const long long* j, const void* u_acc, double a, void* chain_x,
                         int chain_x_f64, void* chain_lp, int chain_lp_f64, int* n_accept,
                         void* stream) {
    return launch_half_step<SC3WarpModelAnyDim>(P, device, compute_f64, x, state_f64, logp,
                                                half, h, u_z, j, u_acc, a, chain_x, chain_x_f64,
                                                chain_lp, chain_lp_f64, n_accept, stream);
}

// K6a launch over ShockCooling3 (ladder.cuh). Returns 0 or a cudaError_t code.
int sc3_tempered_half_step_launch(const SC3Params* P, int device, int compute_f64, void* x,
                                  int state_f64, double* logpri, double* logl,
                                  const double* betas, int n_rungs, int half, int h,
                                  const void* u_z, const long long* j, const void* u_acc,
                                  double a, int* n_accept, void* stream) {
    return launch_tempered_half_step<SC3Model>(P, device, compute_f64, x, state_f64, logpri, logl,
                                               betas, n_rungs, half, h, u_z, j, u_acc, a,
                                               n_accept, stream);
}

// K6b launch over ShockCooling3 (ladder.cuh), a warp per state
// (SC3WarpModel of the walker's dimension, 7 or 8: the batch log-posterior's
// form and bits); the arguments of sc2_ladder_init_launch. Returns 0 or a
// cudaError_t code.
int sc3_ladder_init_launch(const SC3Params* P, int device, int compute_f64, const void* x,
                           int state_f64, int n, int per_set, int copies, double* logpri,
                           double* logl, void* stream) {
    if (P->ndim == 7)
        return launch_ladder_init<SC3WarpModel7>(P, device, compute_f64, x, state_f64, n,
                                                 per_set, copies, logpri, logl, stream);
    if (P->ndim == 8)
        return launch_ladder_init<SC3WarpModel8>(P, device, compute_f64, x, state_f64, n,
                                                 per_set, copies, logpri, logl, stream);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
