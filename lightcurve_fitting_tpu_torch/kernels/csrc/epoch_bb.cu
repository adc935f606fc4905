// The per-epoch blackbody posterior of the batched bolometric path (K4), its
// analytic gradient, the stretch-move half-step over E epochs at once, and the
// posterior-summary integrand (K4s), for sm_90a, bound to Python through a
// plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K4  parallel/batched.py:53-94 _make_epoch_logpost (logpost), fused by XLA
//       under vmap over epochs and walkers; its jax.grad in the Adam polish
//       of batched_map_centers (:355-380); models/blackbody.py:27-37
//       planck_lnu and ops/mathx.py planck_denom_inv inside it.
//   epoch half-step: parallel/sampler.py:86-104 (make_stretch_kernel) vmapped
//       over epochs by batched.py:243-256; the stretch_half_step_kernel
//       template of stretch.cuh over EpochBBModel.
//   K4s parallel/batched.py:129-159 _epoch_summary: the Planck trapezoid over
//       the 580-point pseudobolometric grid per posterior sample, and the
//       Stefan-Boltzmann product (R T^2)^2.
//
// What bounds it on the H100: the special functions. A Planck term is one
// expm1 and one division; an epoch evaluation is sum over its real bands of
// their native node counts (~530 terms for 6 bands) and a summary sample 580
// terms. The per-epoch data (<= 9 bands x 89 nodes x 2 tables, 6.4 KB in f32)
// are shared by the epoch's walkers, and the walkers' state is a few bytes, so
// device-memory traffic is negligible; at the bolometric shapes (32 walkers an
// epoch, 16 a half) the launches are small and sit on their latency floor.
// What the design does about it: a block works on one epoch (blockIdx.y) and
// stages that epoch's tables in shared memory; one thread per parameter
// vector walks the real bands in order (a warp reads one band's node at a
// time: broadcasts) and stops at each band's last non-zero weight, and masked
// (padding) bands are skipped: their terms are exact zeros in the JAX sum.
// The gradient (T, R[, sigma]) is accumulated in the same pass from the same
// terms (band_flux<C, true>, planck.cuh).
//
// Dtype semantics follow the JAX accelerator path (batched.py:60-90): the
// Planck sum, the residuals and their sum run in the compute type C on
// C-cast T, R and sigma; without intrinsic scatter the f64 log_norm is added
// to the C sum promoted to f64, with it the C sum is the likelihood; the
// priors, the isfinite guards and the result are f64. A non-finite
// likelihood gives -inf, and its gradient is the prior's alone (the JAX
// where() passes no cotangent into the likelihood there); outside the
// priors both are -inf and 0.

#include "planck.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/epoch_bb.py (_EpochBBParams) matches it field for field.
struct EpochBBParams {
    const void* y;               // (E, B) compute type: y / yscale
    const void* inv_dy;          // (E, B) yscale / dy on real bands, 0 on padding
    const void* dy;              // (E, B) dy / yscale
    const void* sigma_units;     // (E, B)
    const void* nodes;           // (E, B, K) emitted-frame nodes (THz)
    const void* weights;         // (E, B, K) quadrature weights
    const void* inv_yscale;      // (E,) compute type
    const double* log_norm;      // (E,) float64 Gaussian normalization
    const long long* n_native;   // (E, B) each band's node count before its padding
    const unsigned char* mask;   // (E, B) 1 for a real band
    long long n_epochs;
    long long n_bands;
    long long n_nodes;
    long long ndim;
    long long use_sigma;
    long long has_affine;        // always 0: the state is absolute
    long long has_cutoff;
    double cutoff;               // THz; used when has_cutoff
    double c1;
    double c2;
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

// K4s's arguments (mirror: kernels/epoch_bb.py _SummaryParams).
struct SummaryParams {
    const void* chain;           // state type; sample s of epoch e at
                                 // chain[(s / nwalkers) * stride_step + e * stride_e
                                 //       + (s % nwalkers) * ndim]
    const void* nu;              // (F,) compute type: emitted-frame grid (THz)
    const void* w;               // (F,) trapezoid weights
    void* out;                   // (E, 4, S) compute type: T, R, (R T^2)^2, the integral
    long long n_epochs;
    long long n_samples;
    long long nwalkers;
    long long ndim;
    long long stride_step;
    long long stride_e;
    long long n_freq;
    long long has_cutoff;
    double cutoff;
    double c1;
    double c2;
};

template <typename C>
struct EpochBBData {
    const long long* n_native;
    const unsigned char* mask;
    const C* nu;
    const C* w;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    C inv_h;
    double log_norm;
};

template <typename C>
__host__ __device__ inline size_t epoch_stage_bytes(const EpochBBParams& P) {
    const size_t B = (size_t)P.n_bands, K = (size_t)P.n_nodes;
    return sizeof(long long) * B + sizeof(C) * (2 * B * K + 4 * B) + B;
}

// Epoch e's tables and band data, copied into shared memory (every thread
// of the block takes part, so call it before any thread returns), or read
// in place when they exceed the block's limit.
template <typename C>
__device__ EpochBBData<C> stage_epoch(const EpochBBParams& P, unsigned char* smem, int use_smem,
                                      int e) {
    const long long B = P.n_bands, BK = P.n_bands * P.n_nodes;
    const long long* nn = P.n_native + e * B;
    const unsigned char* mk = P.mask + e * B;
    const C* nu = (const C*)P.nodes + e * BK;
    const C* w = (const C*)P.weights + e * BK;
    const C* y = (const C*)P.y + e * B;
    const C* inv_dy = (const C*)P.inv_dy + e * B;
    const C* dy = (const C*)P.dy + e * B;
    const C* su = (const C*)P.sigma_units + e * B;
    EpochBBData<C> d;
    d.inv_h = ((const C*)P.inv_yscale)[e];
    d.log_norm = P.log_norm[e];
    if (use_smem) {
        long long* si = reinterpret_cast<long long*>(smem);
        d.n_native = stage_array(nn, B, si);
        C* s = reinterpret_cast<C*>(si);
        d.nu = stage_array(nu, BK, s);
        d.w = stage_array(w, BK, s);
        d.y = stage_array(y, B, s);
        d.inv_dy = stage_array(inv_dy, B, s);
        d.dy = stage_array(dy, B, s);
        d.su = stage_array(su, B, s);
        unsigned char* sm = reinterpret_cast<unsigned char*>(s);
        d.mask = stage_array(mk, B, sm);
        __syncthreads();
    } else {
        d.n_native = nn;
        d.mask = mk;
        d.nu = nu;
        d.w = w;
        d.y = y;
        d.inv_dy = inv_dy;
        d.dy = dy;
        d.su = su;
    }
    return d;
}

// d/dp of the prior log-densities at absolute parameters p inside the bounds.
template <typename Params>
__device__ __forceinline__ void log_prior_grad(const Params& P, const double* p, double* g) {
    for (int i = 0; i < (int)P.ndim; ++i) {
        if (P.prior_kind[i] == 1) {
            g[i] = -1.0 / p[i];
        } else if (P.prior_kind[i] == 2) {
            g[i] = -((p[i] - P.mean[i]) / P.stddev[i]) / P.stddev[i];
        } else {
            g[i] = 0.0;
        }
    }
}

// The log-posterior of one parameter vector p = (T, R[, ..., sigma]) of
// one epoch; with GRAD also its gradient into g[ndim].
template <typename C, bool GRAD>
__device__ double epoch_log_posterior(const double* p, const EpochBBData<C>& d,
                                      const EpochBBParams& P, double* g) {
    const int ndim = (int)P.ndim;
    if constexpr (GRAD)
        for (int k = 0; k < ndim; ++k) g[k] = 0.0;
    const double lprior = log_prior(P, p);
    if (!isfinite(lprior)) return -INFINITY;
    if constexpr (GRAD) log_prior_grad(P, p, g);

    const bool use_sigma = P.use_sigma != 0;
    const C T = (C)p[0];
    const C R = (C)p[1];
    const C sig = use_sigma ? (C)p[ndim - 1] : C(0);
    const C c1 = (C)P.c1, c2 = (C)P.c2, cutoff = (C)P.cutoff;
    const bool has_cutoff = P.has_cutoff != 0;
    const int B = (int)P.n_bands;
    const int K = (int)P.n_nodes;
    C acc = C(0);
    C gT = C(0), gR = C(0), gS = C(0);
    for (int b = 0; b < B; ++b) {
        if (!d.mask[b]) continue;
        C dS = C(0);
        const C S = band_flux<C, GRAD>(d.nu + b * K, d.w + b * K, nullptr, (int)d.n_native[b],
                                       T, R, C(0), c1, c2, C(0), has_cutoff, cutoff, &dS);
        const C y_fit = S * d.inv_h;
        acc += residual_term<C>(use_sigma, y_fit, d.y[b], d.inv_dy[b], d.dy[b], d.su[b], sig);
        if constexpr (GRAD) {
            // dll/dy_fit of ll = -0.5 sum(term)
            C dll;
            if (use_sigma) {
                const C sg = sig * d.su[b];
                const C sigma2 = d.dy[b] * d.dy[b] + sg * sg;
                const C res = d.y[b] - y_fit;
                dll = res / sigma2;
                gS += -(sg * d.su[b]) * (C(1) / sigma2 - (res * res) / (sigma2 * sigma2));
            } else {
                const C r = (d.y[b] - y_fit) * d.inv_dy[b];
                dll = r * d.inv_dy[b];
            }
            const C gy = dll * d.inv_h;
            gT += gy * dS;
            gR += gy * (R != C(0) ? (S + S) / R : C(0));  // dS/dR = 2 S / R
        }
    }
    double ll;
    if (use_sigma) {
        const C llc = C(-0.5) * acc;
        if (!isfinite(llc)) return -INFINITY;
        ll = (double)llc;
    } else {
        ll = (double)(C(-0.5) * acc) + d.log_norm;
        if (!isfinite(ll)) return -INFINITY;
    }
    if constexpr (GRAD) {
        g[0] += (double)gT;
        g[1] += (double)gR;
        if (use_sigma) g[ndim - 1] += (double)gS;
    }
    return lprior + ll;
}

// The model policy of stretch.cuh for the epoch blackbody in compute type C.
template <typename C>
struct EpochBBModel {
    typedef EpochBBParams Params;
    typedef EpochBBData<C> Data;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return epoch_stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int e) {
        return stage_epoch<C>(P, smem, use_smem, e);
    }
    static __device__ double log_posterior(const double* p, const Data& d, const Params& P) {
        return epoch_log_posterior<C, false>(p, d, P, nullptr);
    }
};

// K4: out[e, m] = the log-posterior of epoch e at q[e, m, :]; with GRAD also
// grad[e, m, :]. Block (blockIdx.x, e) holds M-chunk blockIdx.x of epoch e.
template <typename C, typename S, bool GRAD>
__global__ void __launch_bounds__(LP_THREADS)
epoch_logpost_kernel(const EpochBBParams P, const S* __restrict__ q, int M,
                     double* __restrict__ out, double* __restrict__ grad, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.y;
    const EpochBBData<C> d = stage_epoch<C>(P, smem_raw, use_smem, e);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    const int ndim = (int)P.ndim;
    const size_t w = (size_t)e * M + i;
    double p[LP_MAX_DIM];
    double g[LP_MAX_DIM];
    for (int k = 0; k < ndim; ++k) p[k] = (double)q[w * ndim + k];
    out[w] = epoch_log_posterior<C, GRAD>(p, d, P, g);
    if constexpr (GRAD)
        for (int k = 0; k < ndim; ++k) grad[w * ndim + k] = g[k];
}

// K4s: for sample s of epoch e, T, R, u = (R T^2)^2 (f64, then C) and the
// trapezoid sum over the grid of L_nu(nu_f; T, R) in C.
template <typename C, typename S>
__global__ void __launch_bounds__(256) epoch_summary_kernel(const SummaryParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    C* s_nu = reinterpret_cast<C*>(smem_raw);
    const int F = (int)P.n_freq;
    C* s_w = s_nu + F;
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        s_nu[f] = ((const C*)P.nu)[f];
        s_w[f] = ((const C*)P.w)[f];
    }
    __syncthreads();
    const long long e = blockIdx.y;
    const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long NS = P.n_samples;
    if (s >= NS) return;
    const S* src = (const S*)P.chain + (s / P.nwalkers) * P.stride_step + e * P.stride_e
                   + (s % P.nwalkers) * P.ndim;
    const S Ts = src[0], Rs = src[1];
    const double T = (double)Ts, R = (double)Rs;
    const double v = __dmul_rn(__dmul_rn(R, T), T);
    const double u = __dmul_rn(v, v);
    const C sv = band_flux<C>(s_nu, s_w, nullptr, F, (C)Ts, (C)Rs, C(0), (C)P.c1, (C)P.c2, C(0),
                              P.has_cutoff != 0, (C)P.cutoff);
    C* o = (C*)P.out + e * 4 * NS;
    o[s] = (C)T;
    o[NS + s] = (C)R;
    o[2 * NS + s] = (C)u;
    o[3 * NS + s] = sv;
}

// ------------------------------------------------------------------ launch

template <typename C, typename S, bool GRAD>
static int launch_epoch_logpost(const EpochBBParams& P, const void* q, int M, double* out,
                                double* grad, cudaStream_t stream) {
    auto kernel = epoch_logpost_kernel<C, S, GRAD>;
    int use_smem = 0;
    const size_t bytes = epoch_stage_bytes<C>(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const int threads = threads_for(M);
    const dim3 grid((M + threads - 1) / threads, (unsigned)P.n_epochs);
    kernel<<<grid, threads, use_smem ? bytes : 0, stream>>>(P, (const S*)q, M, out, grad,
                                                            use_smem);
    return (int)cudaGetLastError();
}

template <typename C, typename S>
static int launch_summary(const SummaryParams& P, cudaStream_t stream) {
    auto kernel = epoch_summary_kernel<C, S>;
    const size_t bytes = 2 * sizeof(C) * (size_t)P.n_freq;
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // a grid longer than shared memory
    const dim3 grid((unsigned)((P.n_samples + 255) / 256), (unsigned)P.n_epochs);
    kernel<<<grid, 256, bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

extern "C" {

// K4 launch: q (E, M, ndim) f32 or f64, out (E, M) f64, grad (E, M, ndim)
// f64 when with_grad. Returns 0 or a cudaError_t code.
int epoch_logpost_launch(const EpochBBParams* P, int device, int compute_f64, const void* q,
                         int q_f64, int M, double* out, int with_grad, double* grad,
                         void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (M <= 0 || P->n_epochs <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->ndim < 2 || P->n_epochs > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 4 + q_f64 * 2 + (with_grad ? 1 : 0);
    switch (key) {
        case 0: return launch_epoch_logpost<float, float, false>(*P, q, M, out, grad, s);
        case 1: return launch_epoch_logpost<float, float, true>(*P, q, M, out, grad, s);
        case 2: return launch_epoch_logpost<float, double, false>(*P, q, M, out, grad, s);
        case 3: return launch_epoch_logpost<float, double, true>(*P, q, M, out, grad, s);
        case 4: return launch_epoch_logpost<double, float, false>(*P, q, M, out, grad, s);
        case 5: return launch_epoch_logpost<double, float, true>(*P, q, M, out, grad, s);
        case 6: return launch_epoch_logpost<double, double, false>(*P, q, M, out, grad, s);
        case 7: return launch_epoch_logpost<double, double, true>(*P, q, M, out, grad, s);
    }
    return (int)cudaErrorInvalidValue;
}

// Epoch half-step launch: the arguments of stretch_half_step_launch
// (sc2_logpost.cu) over E = n_ens ensembles, x (E, 2, half, ndim), the draws
// of ensemble e draw_stride elements after those of e - 1. Returns 0 or a
// cudaError_t code.
int epoch_half_step_launch(const EpochBBParams* P, int device, int compute_f64, void* x,
                           int state_f64, double* logp, int half, int h, const void* u_z,
                           const long long* j, const void* u_acc, double a, void* chain_x,
                           int chain_x_f64, void* chain_lp, int chain_lp_f64, int* n_accept,
                           int n_ens, long long draw_stride, void* stream) {
    if (P->ndim < 2) return (int)cudaErrorInvalidValue;
    return launch_half_step<EpochBBModel>(P, device, compute_f64, x, state_f64, logp, half, h,
                                          u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,
                                          chain_lp_f64, n_accept, stream, n_ens, draw_stride);
}

// K4s launch: out (E, 4, S) in the compute type. Returns 0 or a cudaError_t
// code.
int epoch_summary_launch(const SummaryParams* P, int device, int compute_f64, int state_f64,
                         void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->n_samples <= 0 || P->n_epochs <= 0) return 0;
    if (P->n_epochs > 65535 || P->ndim < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 2 + state_f64;
    switch (key) {
        case 0: return launch_summary<float, float>(*P, s);
        case 1: return launch_summary<float, double>(*P, s);
        case 2: return launch_summary<double, float>(*P, s);
        case 3: return launch_summary<double, double>(*P, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
