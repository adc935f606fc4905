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

// The model policy of stretch.cuh and ladder.cuh for ShockCooling2 in
// compute type C.
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

}  // extern "C"
