// The per-transient ShockCooling2 kernels of the population fit (P1, P2,
// P3) for sm_90a, bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/parallel/population.py):
//   P1  :349-386 make_logpost and :407-411 init_one, vmapped over the S
//       transients: the log-posterior of every transient's walkers
//       (logpost_warp_kernel over PopSC2WarpModel, the transients along the
//       ensemble axis blockIdx.y).
//   P2  :413-433 seg_one's step, make_stretch_kernel over make_logpost,
//       vmapped: one stretch-move half-step of all S ensembles in one launch
//       (stretch_half_step_kernel over PopSC2WarpModel, transient e =
//       blockIdx.y, the draws (S, 2, half) of the step).
//   P3  :204-231 optimize_fn: the Adam ascent of every transient's
//       posterior from n_starts starts (vmap over transients of vmap over
//       starts of value_and_grad, in an n_iter-step lax.scan) and the final
//       negative log-posteriors, in one launch (pop_map_kernel: a block per
//       transient, a warp per start).
//
// The likelihood is the population's, not the single fit's: y and dy are
// divided by the transient's own yscale; inv_dy is 0 on the padded points,
// whose residual (y - y_fit) * 0 still enters the sum (a non-finite model
// value there poisons it, as in the JAX graph); the Gaussian normalization
// log_norm (float64, over the real points) is added to the compute-type sum
// promoted to float64; with the intrinsic scatter the terms of the real
// points alone are summed, in the compute type, and there is no constant;
// a non-finite log L is -inf. The phase is ops/mathx.py:hot_phase's,
// centred on each transient's own t_ref = floor(min t): tt = C(t - t_ref) -
// C(t_exp - t_ref), t_exp = 0 for the three-parameter fit (T_1, L_1, t_tr).
// A point is sc2_forward's (EXACT, the bits of K1 and K2 at the same
// constants), its derivatives sc2_point's (K7's).
//
// What bounds it on the H100: the FP32 ALU work of the points, as K1 and K2
// (the example's 24-42 points a transient put a warp's 32 lanes on one or
// two points each). Each block stages its transient's rows (S x N x (D + 8)
// values over the population) in shared memory.

#include "adam.cuh"
#include "sc2_model.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/pop.py (_PopParams) matches it field for field. The
// per-point arrays are (S, N) in the compute type, coef (S, N, n_coef).
struct PopParams {
    const void* t_centered;      // t - t_ref of the transient
    const void* y;               // y / yscale
    const void* inv_dy;          // yscale / dy, 0 on the padded points
    const void* dy;              // dy / yscale
    const void* sigma_units;     // the intrinsic scatter's units
    const void* s_a;
    const void* s_b;
    const void* coef;            // the Chebyshev rows
    const unsigned char* mask;   // (S, N): 1 on the real points
    const double* t_ref;         // (S,)
    const double* inv_yscale;    // (S,)
    const double* log_norm;      // (S,)
    long long n_points;
    long long n_coef;
    long long ndim;
    long long n_model;           // 3 (t_exp = 0) or 4 (t_exp the fourth parameter)
    long long use_sigma;
    long long has_affine;
    double eps_T;
    double eps_L;
    double a_model;
    double alpha;
    double c3_42;
    long long prior_kind[LP_MAX_DIM];
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

// Transient e's rows as stage_points reads a parameter block.
struct PopRows {
    const void *t_centered, *y, *inv_dy, *dy, *sigma_units, *s_a, *s_b, *coef;
    long long n_points, n_coef;
};

// A transient's data as the points read them: its staged rows, its mask
// and its scalars.
template <typename C>
struct PopData {
    PointData<C> pts;
    const unsigned char* mask;
    double t_ref;
    double log_norm;
    C inv_yscale;
};

template <typename C>
__device__ PopData<C> pop_stage(const PopParams& P, unsigned char* smem, int use_smem, int e) {
    const size_t N = (size_t)P.n_points, off = (size_t)e * N;
    PopRows R;
    R.t_centered = (const C*)P.t_centered + off;
    R.y = (const C*)P.y + off;
    R.inv_dy = (const C*)P.inv_dy + off;
    R.dy = (const C*)P.dy + off;
    R.sigma_units = (const C*)P.sigma_units + off;
    R.s_a = (const C*)P.s_a + off;
    R.s_b = (const C*)P.s_b + off;
    R.coef = (const C*)P.coef + off * (size_t)P.n_coef;
    R.n_points = P.n_points;
    R.n_coef = P.n_coef;
    PopData<C> d;
    d.pts = stage_points<C>(R, reinterpret_cast<C*>(smem), use_smem);
    d.mask = P.mask + off;
    d.t_ref = P.t_ref[e];
    d.log_norm = P.log_norm[e];
    d.inv_yscale = (C)P.inv_yscale[e];
    return d;
}

// A walker's parameters as the points take them: t_exp absolute (float64,
// an MJD), the others in the compute type.
template <typename C>
struct PopWalker {
    double t_exp;
    C T1, L1, t_tr, sig;
};

template <typename C>
__device__ __forceinline__ PopWalker<C> pop_walker(const double* p, const PopParams& P,
                                                   int ndim) {
    PopWalker<C> w;
    w.t_exp = P.n_model == 4 ? p[3] : 0.0;
    w.T1 = (C)p[0];
    w.L1 = (C)p[1];
    w.t_tr = (C)p[2];
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    return w;
}

// The walker's constants of sc2_forward for transient d.
template <typename C>
__device__ __forceinline__ SC2Walker<C> pop_sc2_walker(const PopWalker<C>& v, const PopData<C>& d,
                                                       const PopParams& P) {
    SC2Walker<C> w;
    w.T1 = v.T1;
    w.L1 = v.L1;
    w.t_tr = v.t_tr;
    w.t_exp = (C)(v.t_exp - d.t_ref);
    w.eT = (C)P.eps_T;
    w.eL = (C)P.eps_L;
    w.a_mod = (C)P.a_model;
    w.alpha = (C)P.alpha;
    w.c3 = (C)P.c3_42;
    w.inv_yscale = d.inv_yscale;
    w.sig = v.sig;
    return w;
}

// Whether point n enters the sum: every point without the intrinsic
// scatter (the padded ones through inv_dy = 0), the real ones with it.
__device__ __forceinline__ bool pop_counts(const unsigned char* mask, int n, bool use_sigma) {
    return !use_sigma || mask[n] != 0;
}

// The population's log L from the residual sum acc in the compute type:
// -0.5 acc, plus log_norm in float64 without the intrinsic scatter; -inf
// when not finite.
template <typename C>
__device__ __forceinline__ double pop_finish(C acc, bool use_sigma, double log_norm) {
    const C half = C(-0.5) * acc;
    const double ll = use_sigma ? (double)half : (double)half + log_norm;
    return isfinite(ll) ? ll : -INFINITY;
}

// The policy of P1 and P2 (stretch.cuh): a warp per walker, batched as
// SC2WarpModel, the transient e of a block staged from its rows. 16 warps a
// block at most: a transient's rows are small, and at S = 512 x 64 walkers
// P1 took 0.065 ms of device time at 16 against 0.108 at 32 (PERF.md §6).
// N: the walker's dimension at compile time, or 0 (P.ndim).
template <typename C, int N>
struct PopSC2WarpModel {
    typedef PopParams Params;
    typedef PopData<C> Data;
    typedef PopWalker<C> Walker;
    static constexpr int warps_per_block = 16;
    static constexpr bool batched = true;
    static constexpr int ndim = N;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return ::stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int e) {
        return pop_stage<C>(P, smem, use_smem, e);
    }
    static __device__ Walker walker(const double* p, const Params& P) {
        return pop_walker<C>(p, P, N > 0 ? N : (int)P.ndim);
    }
    // Lane l sums the terms of points l, l + 32, ... in that order, then the
    // butterfly sums the lanes (K1's order), every lane the same bits.
    static __device__ double log_likelihood_warp(const Walker& v, const Data& d, const Params& P) {
        const SC2Walker<C> w = pop_sc2_walker<C>(v, d, P);
        const int Np = (int)P.n_points, K = (int)P.n_coef;
        const bool use_sigma = P.use_sigma != 0;
        C acc = C(0);
        for (int n = threadIdx.x & 31; n < Np; n += 32) {
            if (!pop_counts(d.mask, n, use_sigma)) continue;
            sc2_add_term<C, true>(
                acc,
                sc2_forward<C, true>(n, w, d.pts, K, use_sigma, sc2_no_before(), sc2_no_link()).r,
                use_sigma);
        }
        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
    }
};

template <typename C>
using PopSC2WarpModelAnyDim = PopSC2WarpModel<C, 0>;

// ------------------------------------------------------------------------ P3

#define POP_MAP_WARPS 16   // warps a block of P3: a start a warp at the default 16 starts

// P3's arguments (mirror: kernels/pop.py _PopMapParams). The bounds
// bijection is BoundsTransform.kernel_spec's (parallel/hmc.py).
struct PopMapParams {
    const double* u0;     // (S, n_starts, ndim) the starts in the unbounded space
    const double* sched;  // (n_iter, 3) a step's learning rate, 1 - b1^t, 1 - b2^t
    double* u_out;        // (S, n_starts, ndim) each start's last iterate
    double* neg_out;      // (S, n_starts) -log p there (+inf where it is -inf)
    long long n_starts;
    long long n_iter;
    double b1;
    double b2;
    double one_minus_b1;
    double one_minus_b2;
    double eps;
    long long kind[LP_MAX_DIM];  // 0 unbounded, 1 two-sided, 2 lower only, 3 upper only
    double lo[LP_MAX_DIM];
    double hi[LP_MAX_DIM];
    double width[LP_MAX_DIM];
};

// The log-posterior of transient d at absolute float64 parameters p[N] and
// its gradient g[N], by the 32 lanes of a warp together (every lane the same
// bits): the priors and their gradient in float64 (sc2_prior), the points'
// terms and derivatives in the compute type (sc2_point, lane l on points l,
// l + 32, ... that pop_counts, summed as K7's warp form), the population's
// log L (pop_finish). -inf and g = 0 outside the priors or where log L is
// not finite (the JAX where() passes no cotangent there).
template <typename C, int N>
__device__ double pop_value_and_grad_warp(const double* p, const PopData<C>& d,
                                          const PopParams& P, double* g) {
    double lprior, gprior[N];
    if (!sc2_prior<N>(p, P, N, lprior, gprior)) {
#pragma unroll
        for (int k = 0; k < N; ++k) g[k] = 0.0;
        return -INFINITY;
    }
    const SC2Walker<C> w = pop_sc2_walker<C>(pop_walker<C>(p, P, N), d, P);
    const int Np = (int)P.n_points, K = (int)P.n_coef;
    const bool use_sigma = P.use_sigma != 0;
    SC2Sums<C> s;
    for (int n = threadIdx.x & 31; n < Np; n += 32)
        if (pop_counts(d.mask, n, use_sigma))
            sc2_accumulate(s, sc2_point<C>(n, w, d.pts, K, use_sigma), use_sigma);
    s.acc = warp_sum(s.acc);
    s.dT1 = warp_sum(s.dT1);
    s.dL1 = warp_sum(s.dL1);
    s.dttr = warp_sum(s.dttr);
    s.dtt = warp_sum(s.dtt);
    if (use_sigma) s.dsig = warp_sum(s.dsig);
    const double ll = pop_finish<C>(s.acc, use_sigma, d.log_norm);
    if (!(ll > -INFINITY)) {
#pragma unroll
        for (int k = 0; k < N; ++k) g[k] = 0.0;
        return -INFINITY;
    }
    // ll = -0.5 acc (+ const): the cotangent of each term is -0.5 (exact)
    g[0] = gprior[0] + (double)(C(-0.5) * s.dT1);
    g[1] = gprior[1] + (double)(C(-0.5) * s.dL1);
    g[2] = gprior[2] + (double)(C(-0.5) * s.dttr);
    if (P.n_model == 4) g[3] = gprior[3] + (double)(C(0.5) * s.dtt);
    if (use_sigma) g[N - 1] = gprior[N - 1] + (double)(C(-0.5) * s.dsig);
    return lprior + ll;
}

// P3: the Adam ascent of _map_seeded_guesses for transient blockIdx.x, a
// start a warp (warp w takes starts w, w + warps, ...). Each of n_iter
// steps: x = the bijection of u, the warp's value and gradient of the
// transient's log-posterior at x, then adam_step (the chain rule into u, a
// non-finite component 0, and the step with the host's scalars). Then each
// start's last iterate and its -log p, +inf where log p is -inf.
template <typename C, int N>
__global__ void __launch_bounds__(32 * POP_MAP_WARPS)
pop_map_kernel(const PopParams P, const PopMapParams Q, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.x;
    const PopData<C> d = pop_stage<C>(P, smem_raw, use_smem, e);
    const int S = (int)Q.n_starts;
    for (int s = threadIdx.x >> 5; s < S; s += blockDim.x >> 5) {
        const size_t row = (size_t)e * S + s;
        double u[N], m[N], v[N], x[N], f[N], g[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            u[k] = Q.u0[row * N + k];
            m[k] = 0.0;
            v[k] = 0.0;
        }
        for (int t = 0; t < (int)Q.n_iter; ++t) {
            adam_bounded<N>(Q, u, x, f);
            pop_value_and_grad_warp<C, N>(x, d, P, g);
            adam_step<N>(Q, g, f, __ldg(Q.sched + 3 * t), __ldg(Q.sched + 3 * t + 1),
                         __ldg(Q.sched + 3 * t + 2), u, m, v);
        }
        adam_bounded<N>(Q, u, x, f);
        const double neg = -pop_value_and_grad_warp<C, N>(x, d, P, g);
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int k = 0; k < N; ++k) Q.u_out[row * N + k] = u[k];
            Q.neg_out[row] = neg;
        }
    }
}

template <typename C, int N>
static int launch_pop_map(const PopParams& P, const PopMapParams& Q, int S, cudaStream_t stream) {
    auto kernel = pop_map_kernel<C, N>;
    const size_t bytes = ::stage_bytes<C>(P);
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const int warps = Q.n_starts < POP_MAP_WARPS ? (int)Q.n_starts : POP_MAP_WARPS;
    kernel<<<(unsigned)S, 32 * warps, use_smem ? bytes : 0, stream>>>(P, Q, use_smem);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ launch

extern "C" {

// P1 launch: out (S, W) at the walker states q (S, W, ndim), a warp per
// walker, transient e along blockIdx.y. Returns 0 or a cudaError_t code.
int pop_logpost_launch(const PopParams* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, int S, double* out, void* stream) {
    if (P->n_model != 3 && P->n_model != 4) return (int)cudaErrorInvalidValue;
    return launch_logpost<PopSC2WarpModelAnyDim>(P, device, compute_f64, q, q_f64, W, out,
                                                 stream, S);
}

// P2 launch: one half-step of the S ensembles x (S, 2, half, ndim), the
// draws of ensemble e draw_stride after those of e - 1; chain_x/chain_lp
// may be null. Returns 0 or a cudaError_t code.
int pop_half_step_launch(const PopParams* P, int device, int compute_f64, void* x, int state_f64,
                         double* logp, int half, int h, const void* u_z, const long long* j,
                         const void* u_acc, double a, void* chain_x, int chain_x_f64,
                         void* chain_lp, int chain_lp_f64, int* n_accept, int S,
                         long long draw_stride, void* stream) {
    if (P->n_model != 3 && P->n_model != 4) return (int)cudaErrorInvalidValue;
    return launch_half_step<PopSC2WarpModelAnyDim>(P, device, compute_f64, x, state_f64, logp,
                                                   half, h, u_z, j, u_acc, a, chain_x,
                                                   chain_x_f64, chain_lp, chain_lp_f64, n_accept,
                                                   stream, S, draw_stride);
}

// P3 launch: a block per transient of min(n_starts, POP_MAP_WARPS) warps;
// ndim 3, 4 or 5. Returns 0 or a cudaError_t code.
int pop_map_launch(const PopParams* P, const PopMapParams* Q, int device, int compute_f64, int S,
                   void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (S <= 0) return 0;
    if (Q->n_starts < 1 || Q->n_iter < 0 || P->has_affine
        || (P->n_model != 3 && P->n_model != 4) || P->ndim != P->n_model + (P->use_sigma != 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_MAP(N_)                                                \
    (compute_f64 ? launch_pop_map<double, N_>(*P, *Q, S, s)        \
                 : launch_pop_map<float, N_>(*P, *Q, S, s))
    switch (P->ndim) {
        case 3: return POP_MAP(3);
        case 4: return POP_MAP(4);
        case 5: return POP_MAP(5);
    }
#undef POP_MAP
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
