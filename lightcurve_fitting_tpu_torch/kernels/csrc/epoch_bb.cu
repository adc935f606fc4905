// The per-epoch blackbody posterior of the batched bolometric path (K4), its
// analytic gradient, the Adam polish of the MAP centering (K4p), the
// stretch-move half-step over E epochs at once, and the posterior-summary
// integrand (K4s), for sm_90a, bound to Python through a plain C interface
// (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K4  parallel/batched.py:53-94 _make_epoch_logpost (logpost), fused by XLA
//       under vmap over epochs and walkers; models/blackbody.py:27-37
//       planck_lnu and ops/mathx.py planck_denom_inv inside it.
//   K4p parallel/batched.py:355-380: the Adam lax.scan of batched_map_centers
//       over the bounds-bijected posterior (jax.grad of K4's graph, optax's
//       adam under a cosine decay), the final evaluation and the argmin.
//   epoch half-step: parallel/sampler.py:86-104 (make_stretch_kernel) vmapped
//       over epochs by batched.py:243-256; the stretch_half_step_kernel
//       template of stretch.cuh over EpochBBModel.
//   K4s parallel/batched.py:129-159 _epoch_summary: the Planck trapezoid over
//       the 580-point pseudobolometric grid per posterior sample, and the
//       Stefan-Boltzmann product (R T^2)^2.
//
// What bounds it on the H100: the special functions. A Planck term is one
// expm1 and one division; an epoch evaluation is sum over its real bands of
// their native node counts (~290 terms for the bench's 6 bands) and a
// summary sample 580 terms. The per-epoch data (<= 9 bands x 89 nodes x 2
// tables, 6.4 KB in f32) are shared by the epoch's walkers, and the walkers'
// state is a few bytes, so device-memory traffic is negligible; at the
// bolometric shapes (16 walkers a half, 8 Adam starts an epoch) the work is
// small and a thread's serial walk over an epoch's terms sets the time.
// What the design does about it: a block works on one epoch and stages that
// epoch's tables in shared memory. The half-step, K4's values (the cloud's
// scoring and the initial state: logpost_warp_kernel over the half-step's
// policy, the epochs along its ensemble axis) and K4p run a warp per walker,
// vector or start (epoch_log_likelihood_warp): the 32 lanes split each
// band's terms and one butterfly a band gives every lane the band flux (and
// its T derivative); their tables also hold the node-only factors of the
// Planck term (c1 nu, nu^3, the cutoff), staged once a block. So a walker's
// initial value has the bits the half-step stores when it accepts that
// state. Where the vectors hide the longest vector's walk (the bench's
// cloud), K4's values run a thread per vector on the same tables, the
// lanes' 32 partial sums in its registers and added in the butterfly's
// order (band_flux_lanes): the same bits. K4 with the gradient (the plain polish's
// autograd form) runs a thread per vector, which walks the real bands in
// order and stops at each band's last non-zero weight (masked bands are
// skipped: their terms are exact zeros in the JAX sum), the gradient
// accumulated in the same pass (band_flux<C, true>, planck.cuh). K4p runs the
// whole polish of an epoch in one block, a start a warp, its iterate and
// Adam's moments in registers for all n_iter steps. K4s runs a thread per
// sample over the grid's nodes, staged once a block with each node's
// factors in one (a = w nu^3 cut, c1 nu, and in float32 the exponent
// factor), c2 R^2 taken out of the sum; in float32 a term with x in [0.25,
// 86.6] runs on the special-function unit (ex2, rcp: the two special
// functions its bound counts) instead of expm1 and an IEEE division.
//
// Dtype semantics follow the JAX accelerator path (batched.py:60-90): the
// Planck sum, the residuals and their sum run in the compute type C on
// C-cast T, R and sigma; without intrinsic scatter the f64 log_norm is added
// to the C sum promoted to f64, with it the C sum is the likelihood; the
// priors, the isfinite guards and the result are f64. A non-finite
// likelihood gives -inf, and its gradient is the prior's alone (the JAX
// where() passes no cotangent into the likelihood there); outside the
// priors both are -inf and 0.

#include "adam.cuh"
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

// d/dp of the prior log-densities at absolute parameters p inside the bounds
// (D as in log_prior).
template <int D = 0, typename Params>
__device__ __forceinline__ void log_prior_grad(const Params& P, const double* p, double* g) {
    for (int i = 0; i < (D > 0 ? D : (int)P.ndim); ++i) {
        if (P.prior_kind[i] == 1) {
            g[i] = -1.0 / p[i];
        } else if (P.prior_kind[i] == 2) {
            g[i] = -((p[i] - P.mean[i]) / P.stddev[i]) / P.stddev[i];
        } else {
            g[i] = 0.0;
        }
    }
}

// The float64 log-likelihood of one parameter vector of an epoch (-inf when
// not finite) from its band fluxes: flux(b, &dS) is real band b's flux S
// (and with GRAD dS/dT into dS), R and sig the vector's radius and scatter
// in the compute type, d either form's tables (EpochBBData, EpochWarpData).
// GRAD: also dll/dT, dll/dR and dll/dsigma in the compute type into g[3].
template <typename C, bool GRAD, typename Data, typename Flux>
__device__ __forceinline__ double epoch_log_likelihood(const Data& d, const EpochBBParams& P, C R,
                                                       C sig, Flux flux, C* g) {
    const bool use_sigma = P.use_sigma != 0;
    const int B = (int)P.n_bands;
    C acc = C(0);
    C gT = C(0), gR = C(0), gS = C(0);
    for (int b = 0; b < B; ++b) {
        if (!d.mask[b]) continue;
        C dS = C(0);
        const C S = flux(b, &dS);
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
    if constexpr (GRAD) {
        g[0] = gT;
        g[1] = gR;
        g[2] = gS;
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
    return ll;
}

// The log-posterior of one parameter vector p = (T, R[, ..., sigma]) from
// its log-likelihood loglike(gl) (epoch_log_likelihood, its derivatives into
// gl[3]); with GRAD also its gradient into g[ndim]. Outside the priors -inf
// and g = 0; where the likelihood is not finite, -inf and the prior's
// gradient alone. D as in log_prior.
template <typename C, bool GRAD, int D, typename LogLike>
__device__ __forceinline__ double epoch_posterior(const double* p, const EpochBBParams& P,
                                                  double* g, LogLike loglike) {
    const int ndim = D > 0 ? D : (int)P.ndim;
    if constexpr (GRAD)
        for (int k = 0; k < ndim; ++k) g[k] = 0.0;
    const double lprior = log_prior<D>(P, p);
    if (!isfinite(lprior)) return -INFINITY;
    if constexpr (GRAD) log_prior_grad<D>(P, p, g);
    C gl[3];
    const double ll = loglike(gl);
    if (!(ll > -INFINITY)) return -INFINITY;
    if constexpr (GRAD) {
        g[0] += (double)gl[0];
        g[1] += (double)gl[1];
        if (P.use_sigma) g[ndim - 1] += (double)gl[2];
    }
    return lprior + ll;
}

// K4's log-posterior of one parameter vector p of one epoch and its gradient
// into g[ndim], a thread: the bands' terms in order (band_flux).
template <typename C>
__device__ double epoch_log_posterior_grad(const double* p, const EpochBBData<C>& d,
                                           const EpochBBParams& P, double* g) {
    const C T = (C)p[0];
    const C R = (C)p[1];
    const C sig = P.use_sigma ? (C)p[P.ndim - 1] : C(0);
    const C c1 = (C)P.c1, c2 = (C)P.c2, cutoff = (C)P.cutoff;
    const bool has_cutoff = P.has_cutoff != 0;
    const int K = (int)P.n_nodes;
    auto flux = [&](int b, C* dS) {
        return band_flux<C, true>(d.nu + b * K, d.w + b * K, nullptr, (int)d.n_native[b], T, R,
                                  C(0), c1, c2, C(0), has_cutoff, cutoff, dS);
    };
    return epoch_posterior<C, true, 0>(
        p, P, g, [&](C* gl) { return epoch_log_likelihood<C, true>(d, P, R, sig, flux, gl); });
}

// ------------------------------------------------------- the warp forms

// An epoch's tables as the warp forms read them (the half-step and K4p):
// beside the weights, the node-only factors of band_flux's Planck term,
// c1 nu, nu^3 and min(cutoff / nu, 1) (null without the cutoff), each formed
// by band_flux's operations in its order, so every term keeps its bits.
template <typename C>
struct EpochWarpData {
    const long long* n_native;
    const unsigned char* mask;
    const C* w;
    const C* c1nu;
    const C* nu3;
    const C* cut;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    C inv_h;
    double log_norm;
};

template <typename C>
__host__ __device__ inline size_t epoch_warp_stage_bytes(const EpochBBParams& P) {
    const size_t B = (size_t)P.n_bands, K = (size_t)P.n_nodes;
    return sizeof(long long) * B + sizeof(C) * ((P.has_cutoff ? 4 : 3) * B * K + 4 * B) + B;
}

// Epoch e's warp-form tables, formed in shared memory at smem (every thread
// of the block takes part, so call it before any thread returns). The
// launches refuse tables larger than the block's shared memory.
template <typename C>
__device__ EpochWarpData<C> stage_epoch_warp(const EpochBBParams& P, unsigned char* smem, int e) {
    const long long B = P.n_bands, BK = P.n_bands * P.n_nodes;
    const C* nu = (const C*)P.nodes + e * BK;
    EpochWarpData<C> d;
    d.inv_h = ((const C*)P.inv_yscale)[e];
    d.log_norm = P.log_norm[e];
    long long* si = reinterpret_cast<long long*>(smem);
    d.n_native = stage_array(P.n_native + e * B, B, si);
    C* s = reinterpret_cast<C*>(si);
    d.w = stage_array((const C*)P.weights + e * BK, BK, s);
    C* c1nu = s;
    C* nu3 = s + BK;
    C* cut = P.has_cutoff ? s + 2 * BK : nullptr;
    const C c1 = (C)P.c1, cutoff = (C)P.cutoff;
    for (long long i = threadIdx.x; i < BK; i += blockDim.x) {
        const C nuk = nu[i];
        c1nu[i] = c1 * nuk;
        nu3[i] = nuk * nuk * nuk;
        if (cut != nullptr) {
            const C c = cutoff / nuk;
            cut[i] = c < C(1) ? c : C(1);
        }
    }
    s += (cut != nullptr ? 3 : 2) * BK;
    d.c1nu = c1nu;
    d.nu3 = nu3;
    d.cut = cut;
    d.y = stage_array((const C*)P.y + e * B, B, s);
    d.inv_dy = stage_array((const C*)P.inv_dy + e * B, B, s);
    d.dy = stage_array((const C*)P.dy + e * B, B, s);
    d.su = stage_array((const C*)P.sigma_units + e * B, B, s);
    unsigned char* sm = reinterpret_cast<unsigned char*>(s);
    d.mask = stage_array(P.mask + e * B, B, sm);
    __syncthreads();
    return d;
}

// A walker's constants in the compute type: 1 / T (0 where T <= 0 or NaN,
// as band_flux), c2 R^2 and the intrinsic scatter.
template <typename C>
struct EpochWalker {
    C inv_T, c2R2, sig;
};

template <typename C>
__device__ __forceinline__ EpochWalker<C> epoch_walker(double Tp, double Rp, double sig,
                                                       const EpochBBParams& P) {
    const C T = (C)Tp;
    const C R = (C)Rp;
    EpochWalker<C> w;
    w.inv_T = T > C(0) ? C(1) / T : C(0);
    w.c2R2 = (C)P.c2 * (R * R);
    w.sig = P.use_sigma ? (C)sig : C(0);
    return w;
}

// Node k's Planck term of walker w without its weight, c2 R^2 nu^3
// min(1, cutoff / nu) / expm1(x) with x = c1 nu / T, from the staged node
// factors (band_flux's operations in its order); x and 1 / expm1(x) into x
// and pdi.
template <typename C>
__device__ __forceinline__ C epoch_node_lnu(const EpochWarpData<C>& d, int k,
                                            const EpochWalker<C>& w, C& x, C& pdi) {
    x = d.c1nu[k] * w.inv_T;
    const C e = m_expm1(x);
    pdi = e > C(0) ? C(1) / e : C(0);  // x <= 0 -> 0; Wien overflow 1/inf = 0
    C lnu = w.c2R2 * d.nu3[k];
    if (d.cut != nullptr) lnu = lnu * d.cut[k];
    return lnu * pdi;
}

// Band flux S (the sum of n Planck terms from table offset off) of walker w,
// by the 32 lanes of a warp: lane l sums terms l, l + 32, ..., then a
// butterfly gives every lane the same bits. GRAD: also dS/dT into *dS (the
// terms of band_flux<C, true>, its butterfly beside S's).
template <typename C, bool GRAD>
__device__ __forceinline__ C band_flux_warp(const EpochWarpData<C>& d, int off, int n,
                                            const EpochWalker<C>& w, C* dS) {
    C acc = C(0), dacc = C(0);
    for (int k = off + (threadIdx.x & 31); k < off + n; k += 32) {
        C x, pdi;
        const C lnu = epoch_node_lnu(d, k, w, x, pdi);
        acc += d.w[k] * lnu;
        if constexpr (GRAD) if (lnu != C(0)) dacc += d.w[k] * (lnu * (C(1) + pdi) * (x * w.inv_T));
    }
    for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if constexpr (GRAD) dacc += __shfl_xor_sync(0xffffffffu, dacc, o);
    }
    if constexpr (GRAD) *dS = dacc;
    return acc;
}

// band_flux_warp's S by one thread, its bits: the lanes' partial sums
// (lane l's the terms off + l, off + l + 32, ... in order) added in the
// butterfly's tree, v(x, o) = v(x, 2o) + v(x + o, 2o) for o = 16, 8, 4, 2, 1
// and x < o, v(x, 32) lane x's partial, S = v(0, 1). The lanes are taken
// eight at a time, x, x + 4, ..., x + 28, whose partials form v(x, 4) and
// are summed over the band's rounds of 32 terms together.
template <typename C>
__device__ __forceinline__ C band_flux_lanes(const EpochWarpData<C>& d, int off, int n,
                                             const EpochWalker<C>& w) {
    C s1 = C(0);
    for (int a = 0; a < 2; ++a) {
        C s2 = C(0);
        for (int b = 0; b < 2; ++b) {
            const int x = a + 2 * b;
            C acc[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = C(0);
            for (int r = off + x; r < off + n; r += 32) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int k = r + 4 * i;
                    if (k < off + n) {
                        C xk, pdi;
                        const C lnu = epoch_node_lnu(d, k, w, xk, pdi);
                        acc[i] += d.w[k] * lnu;
                    }
                }
            }
            // v(x, 4) = (v(x, 16) + v(x + 8, 16)) + (v(x + 4, 16) + v(x + 12, 16))
            const C s4 = ((acc[0] + acc[4]) + (acc[2] + acc[6]))
                         + ((acc[1] + acc[5]) + (acc[3] + acc[7]));
            s2 = b ? s2 + s4 : s4;
        }
        s1 = a ? s1 + s2 : s2;
    }
    return s1;
}

// The float64 log-likelihood of walker w on epoch d (-inf when not
// finite), by the 32 lanes of a warp together, every lane returning the
// same bits: epoch_log_likelihood over band_flux_warp (the bands in order,
// each band's terms split over the lanes). GRAD: its derivatives into g[3],
// R the walker's radius.
template <typename C, bool GRAD>
__device__ __forceinline__ double epoch_log_likelihood_warp(const EpochWalker<C>& w,
                                                            const EpochWarpData<C>& d,
                                                            const EpochBBParams& P,
                                                            C R = C(0), C* g = nullptr) {
    const int K = (int)P.n_nodes;
    auto flux = [&](int b, C* dS) {
        return band_flux_warp<C, GRAD>(d, b * K, (int)d.n_native[b], w, dS);
    };
    return epoch_log_likelihood<C, GRAD>(d, P, R, w.sig, flux, g);
}

// The log-posterior of p[N] (N == P.ndim) on epoch d by a warp, with GRAD
// its gradient into g[N], the state in registers: epoch_log_posterior_grad's
// value and rules over the warp's likelihood.
template <typename C, int N, bool GRAD>
__device__ __forceinline__ double epoch_log_posterior_warp(const double* p,
                                                           const EpochWarpData<C>& d,
                                                           const EpochBBParams& P, double* g) {
    const EpochWalker<C> w = epoch_walker<C>(p[0], p[1], p[N - 1], P);
    return epoch_posterior<C, GRAD, N>(p, P, g, [&](C* gl) {
        return epoch_log_likelihood_warp<C, GRAD>(w, d, P, (C)p[1], gl);
    });
}

// The model policy of stretch.cuh for the epoch blackbody in compute type C
// and N parameters (2, or 3 with the intrinsic scatter): the warp form
// (stretch_half_step_kernel), a walker a warp (not batched: every
// lane forms the walker's proposal and constants), up to 16 walkers a block
// and a block per epoch (blockIdx.y) at the bolometric path's 16 walkers a
// half; N at compile time keeps the walker's state in registers.
template <typename C, int N>
struct EpochBBModel {
    typedef EpochBBParams Params;
    typedef EpochWarpData<C> Data;
    typedef EpochWalker<C> Walker;
    static constexpr int ndim = N;
    static constexpr int warps_per_block = 16;
    static constexpr bool batched = false;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return epoch_warp_stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int, int e) {
        return stage_epoch_warp<C>(P, smem, e);
    }
    static __device__ Walker walker(const double* p, const Params& P) {
        return epoch_walker<C>(p[0], p[1], p[N - 1], P);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const Data& d,
                                                 const Params& P) {
        return epoch_log_likelihood_warp<C, false>(w, d, P);
    }
};
template <typename C>
using EpochBBModel2 = EpochBBModel<C, 2>;
template <typename C>
using EpochBBModel3 = EpochBBModel<C, 3>;

// --------------------------------------------------------------------- K4p

#define POLISH_WARPS 8        // warps a block of K4p: a start a warp at the default 8 starts
#define POLISH_MAX_STARTS 32  // starts an epoch: the block's result slots

// K4p's arguments (mirror: kernels/epoch_bb.py _PolishParams). The bounds
// bijection is BoundsTransform.kernel_spec's (parallel/hmc.py).
struct PolishParams {
    const double* u0;            // (E, S, ndim) the starts in the unbounded space
    const double* sched;         // (n_iter, 3) a step's learning rate, 1 - b1^t, 1 - b2^t
    double* centers;             // (E, ndim) the best start's parameters
    unsigned char* alive;        // (E,) 1 where its log-posterior is finite
    double* u_out;               // (E, S, ndim) each start's last iterate, or null
    double* lp_out;              // (E, S) its log-posterior, or null
    long long n_starts;
    long long n_iter;
    double b1;
    double b2;
    double one_minus_b1;
    double one_minus_b2;
    double eps;
    long long kind[LP_MAX_DIM];  // 0 unbounded, 1 two-sided, 2 lower only, 3 upper only
    double lo[LP_MAX_DIM];       // the lower bound (two-sided, lower only)
    double hi[LP_MAX_DIM];       // the upper bound (upper only)
    double width[LP_MAX_DIM];    // hi - lo (two-sided)
};

// K4p: the Adam polish of _map_centers (parallel/batched.py) for epoch
// blockIdx.x, a start a warp (warp w takes starts w, w + warps, ...). Each
// of n_iter steps: x = the bijection of u, the warp's value and gradient of
// the epoch log-posterior at x, the chain rule into the gradient of -lp in u
// (as autograd runs it through BoundsTransform.to_bounded; a non-finite
// component 0), and one CosineAdam step with the host's scalars of the step
// (optimize.py:CosineAdam.step, the same operations, none contracted). Then
// each start's last log-posterior (-inf -> +inf in the minimized -lp), the
// first start of the least -lp, its parameters and whether it is finite.
template <typename C, int N>
__global__ void __launch_bounds__(32 * POLISH_WARPS, 1)
epoch_map_polish_kernel(const EpochBBParams P, const PolishParams Q) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* s_neg = reinterpret_cast<double*>(smem_raw);    // [POLISH_MAX_STARTS]
    double* s_u = s_neg + POLISH_MAX_STARTS;                 // [POLISH_MAX_STARTS][N]
    const int e = blockIdx.x;
    const EpochWarpData<C> d = stage_epoch_warp<C>(
        P, smem_raw + sizeof(double) * POLISH_MAX_STARTS * (N + 1), e);
    const int S = (int)Q.n_starts;
    const int lane = threadIdx.x & 31;
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
            epoch_log_posterior_warp<C, N, true>(x, d, P, g);
            const double lr = __ldg(Q.sched + 3 * t);
            const double c1 = __ldg(Q.sched + 3 * t + 1);
            const double c2 = __ldg(Q.sched + 3 * t + 2);
            adam_step<N>(Q, g, f, lr, c1, c2, u, m, v);
        }
        adam_bounded<N>(Q, u, x, f);
        const double lp = epoch_log_posterior_warp<C, N, false>(x, d, P, nullptr);
        const double neg = -lp;
        if (lane == 0) {
            s_neg[s] = isfinite(neg) ? neg : INFINITY;
#pragma unroll
            for (int k = 0; k < N; ++k) s_u[s * N + k] = u[k];
            if (Q.u_out != nullptr) {
#pragma unroll
                for (int k = 0; k < N; ++k) Q.u_out[row * N + k] = u[k];
                Q.lp_out[row] = lp;
            }
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int best = 0;   // torch.argmin: the first of the least
        for (int s = 1; s < S; ++s)
            if (s_neg[s] < s_neg[best]) best = s;
        double x[N], f[N];
        adam_bounded<N>(Q, s_u + best * N, x, f);
#pragma unroll
        for (int k = 0; k < N; ++k) Q.centers[(size_t)e * N + k] = x[k];
        Q.alive[e] = isfinite(s_neg[best]) ? 1 : 0;
    }
}

// K4 with the gradient: out[e, m] = the log-posterior of epoch e at q[e, m,
// :] and grad[e, m, :] its gradient, a thread per vector (EpochLogPosterior:
// the plain polish's autograd form). Block (blockIdx.x, e) holds M-chunk
// blockIdx.x of epoch e.
template <typename C, typename S>
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
    out[w] = epoch_log_posterior_grad<C>(p, d, P, g);
    for (int k = 0; k < ndim; ++k) grad[w * ndim + k] = g[k];
}

// K4's values a thread per vector (the form for widths whose vectors hide
// the longest vector's walk: kernels/epoch_bb.py::k4_form): out[e, m] as
// logpost_warp_kernel over EpochBBModel<C, N> computes it, on that form's
// staged tables, in its order (band_flux_lanes), a vector's state in
// registers (N at compile time), so the two forms give the same bits. The
// launch bound asks for four blocks an SM: without it ptxas gave the
// float64 kernels 56 registers and a 16-32-byte stack frame (spills).
template <typename C, typename S, int N>
__global__ void __launch_bounds__(LP_THREADS, 4)
epoch_logpost_thread_kernel(const EpochBBParams P, const S* __restrict__ q, int M,
                            double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.y;
    const EpochWarpData<C> d = stage_epoch_warp<C>(P, smem_raw, e);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    const size_t w = (size_t)e * M + i;
    double p[N];
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = to_absolute(P, k, q[w * N + k]);
    const double lprior = log_prior<N>(P, p);
    double lp = -INFINITY;
    if (isfinite(lprior)) {
        const EpochWalker<C> wk = epoch_walker<C>(p[0], p[1], p[N - 1], P);
        const int K = (int)P.n_nodes;
        auto flux = [&](int b, C*) {
            return band_flux_lanes<C>(d, b * K, (int)d.n_native[b], wk);
        };
        lp = lprior + epoch_log_likelihood<C, false>(d, P, C(0), wk.sig, flux, nullptr);
    }
    out[w] = isnan(lp) ? -INFINITY : lp;
}

// K4s's node f of the frequency grid, formed once a block in shared memory:
// band_flux's node-only factors in one, a = w nu^3 min(1, cutoff / nu)
// (formed in float64 and rounded once: no division a term), and c1 nu,
// band_flux's x = c1 nu / T; in float32 also b = -c1 nu log2(e) (float64,
// rounded once), the exponent of the special-function-unit term. A term
// reads its node with one shared load, the same address on every lane.
template <typename C>
struct SummaryNode;
template <>
struct __align__(16) SummaryNode<float> { float a, b, c1nu, pad; };
template <>
struct __align__(16) SummaryNode<double> { double a, c1nu; };

template <typename C>
__device__ __forceinline__ SummaryNode<C> summary_node(const SummaryParams& P, int f) {
    const C nuc = ((const C*)P.nu)[f];
    const double nu = (double)nuc;
    const double cut = P.has_cutoff && P.cutoff / nu < 1.0 ? P.cutoff / nu : 1.0;
    SummaryNode<C> n;
    n.a = (C)((double)((const C*)P.w)[f] * (nu * nu * nu) * cut);
    n.c1nu = (C)P.c1 * nuc;
    if constexpr (sizeof(C) == sizeof(float)) {
        n.b = (float)(-P.c1 * nu * 1.4426950408889634);
        n.pad = 0.0f;
    }
    return n;
}

// The float32 terms with t = b / T in [-125, -0.25 log2(e)], x in [0.25,
// 86.6], run on the special-function unit: q = 2^t = exp(-x) (ex2.approx; a
// normal number over the range, so its flush to zero never fires), then 1 /
// expm1(x) = q / (1 - q) (rcp.approx), two MUFU instructions and four FP32
// ones a term with the multiply-add. For x >= 0.25, 1 - q >= 0.22 bounds
// the cancellation: q's relative error reaches q / (1 - q) at most
// 4.6-fold. Other terms (T <= 0 and NaN give x = 0; the Wien tail, where q
// would be subnormal) take band_flux's term: libdevice expm1 and an IEEE
// division, x <= 0 -> 0, 1 / inf = 0.
#define SUMMARY_T0 (-0.36067376022224085f)   // -0.25 log2(e)
#define SUMMARY_T1 (-125.0f)                  // 2^t normal with room for ex2's error

__device__ __forceinline__ float planck_pdi_sfu(float t) {
    float q, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(q) : "f"(t));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f - q));
    return q * r;
}

template <typename C>
__device__ __forceinline__ C planck_pdi(C x) {
    const C e = m_expm1(x);
    return e > C(0) ? C(1) / e : C(0);  // x <= 0 -> 0; Wien overflow 1/inf = 0
}

// The trapezoid sum without c2 R^2, sum_f a_f pdi(node f) over the F staged
// nodes, pdi(n) = 1 / expm1(c1 nu / T) by one of the forms above: node f
// into partial sum f mod 4, the four added at the end (in float32 a
// quarter of one sum's rounding over the 580 nodes, and four independent
// multiply-add chains).
template <typename C, typename Pdi>
__device__ __forceinline__ C summary_sum(const SummaryNode<C>* node, int F, Pdi pdi) {
    C acc[4] = {C(0), C(0), C(0), C(0)};
    int f = 0;
    for (; f + 4 <= F; f += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fma(node[f + k].a, pdi(node[f + k]), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
        if (f + k < F) acc[k] = fma(node[f + k].a, pdi(node[f + k]), acc[k]);
    return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// K4s: for sample s of epoch e, T, R, u = (R T^2)^2 (f64, then C) and the
// trapezoid sum over the grid of L_nu(nu_f; T, R) in C, c2 R^2 times
// summary_sum (c2 R^2 out of the sum: on the bolometric priors, T in [1,
// 100] kK, the float32 partial sums over the pseudobolometric grid stay
// within ~[0.8, 5e11], normal and far from overflow). A thread per
// sample (65 x 3200 and 256 x 3200 samples fill the card), the grid's nodes
// staged once a block; a float32 sample whose x lie in [0.25, 86.6] at
// every node runs every term on the special-function unit, any other
// sample each term by its x (the fork measured 11-30% faster than the
// per-term choice alone on the H100, PERF.md).
template <typename C, typename S>
__global__ void __launch_bounds__(256) epoch_summary_kernel(const SummaryParams P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ float2 s_b[8];   // a warp's largest and smallest b (float32)
    constexpr bool F32 = sizeof(C) == sizeof(float);
    SummaryNode<C>* node = reinterpret_cast<SummaryNode<C>*>(smem_raw);
    const int F = (int)P.n_freq;
    float bmax = -INFINITY, bmin = INFINITY;
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const SummaryNode<C> n = summary_node<C>(P, f);
        node[f] = n;
        if constexpr (F32) bmax = fmaxf(bmax, n.b), bmin = fminf(bmin, n.b);
    }
    if constexpr (F32) {
        bmax = warp_max(bmax);
        bmin = -warp_max(-bmin);
        if ((threadIdx.x & 31) == 0) s_b[threadIdx.x >> 5] = make_float2(bmax, bmin);
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
    const C Tc = (C)Ts, Rc = (C)Rs;
    const C inv_T = Tc > C(0) ? C(1) / Tc : C(0);  // safe_reciprocal: T <= 0 or NaN -> 0
    C sum;
    if constexpr (F32) {
        bmax = s_b[0].x, bmin = s_b[0].y;
        for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
            bmax = fmaxf(bmax, s_b[k].x), bmin = fminf(bmin, s_b[k].y);
        // every t_f = b_f inv_T lies in [bmin inv_T, bmax inv_T] (inv_T >= 0;
        // rounding is monotone)
        if (bmax * inv_T <= SUMMARY_T0 && bmin * inv_T >= SUMMARY_T1) {
            sum = summary_sum(node, F, [&](const SummaryNode<C>& n) {
                return planck_pdi_sfu(n.b * inv_T);
            });
        } else {
            sum = summary_sum(node, F, [&](const SummaryNode<C>& n) {
                const float t = n.b * inv_T;
                return t <= SUMMARY_T0 && t >= SUMMARY_T1 ? planck_pdi_sfu(t)
                                                          : planck_pdi(n.c1nu * inv_T);
            });
        }
    } else {
        sum = summary_sum(node, F, [&](const SummaryNode<C>& n) {
            return planck_pdi(n.c1nu * inv_T);
        });
    }
    C* o = (C*)P.out + e * 4 * NS;
    o[s] = (C)T;
    o[NS + s] = (C)R;
    o[2 * NS + s] = (C)u;
    o[3 * NS + s] = ((C)P.c2 * (Rc * Rc)) * sum;
}

// ------------------------------------------------------------------ launch

template <typename C, typename S>
static int launch_epoch_logpost_grad(const EpochBBParams& P, const void* q, int M, double* out,
                                     double* grad, cudaStream_t stream) {
    auto kernel = epoch_logpost_kernel<C, S>;
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

template <typename C, typename S, int N>
static int launch_epoch_logpost_thread(const EpochBBParams& P, const void* q, int M, double* out,
                                       cudaStream_t stream) {
    auto kernel = epoch_logpost_thread_kernel<C, S, N>;
    int use_smem = 0;
    const size_t bytes = epoch_warp_stage_bytes<C>(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // tables larger than shared memory
    const int threads = threads_for(M);
    const dim3 grid((M + threads - 1) / threads, (unsigned)P.n_epochs);
    kernel<<<grid, threads, bytes, stream>>>(P, (const S*)q, M, out);
    return (int)cudaGetLastError();
}

// K4's values for ndim N: the warp form (logpost_warp_kernel over
// EpochBBModel<C, N>, the epochs along its ensemble axis) or the thread form.
template <int N>
static int launch_epoch_values(const EpochBBParams* P, int device, int compute_f64,
                               const void* q, int q_f64, int M, double* out, int thread_form,
                               cudaStream_t s) {
    if (!thread_form) {
        if constexpr (N == 2)
            return launch_logpost<EpochBBModel2>(P, device, compute_f64, q, q_f64, M, out, s,
                                                 (int)P->n_epochs);
        else
            return launch_logpost<EpochBBModel3>(P, device, compute_f64, q, q_f64, M, out, s,
                                                 (int)P->n_epochs);
    }
    switch (compute_f64 * 2 + q_f64) {
        case 0: return launch_epoch_logpost_thread<float, float, N>(*P, q, M, out, s);
        case 1: return launch_epoch_logpost_thread<float, double, N>(*P, q, M, out, s);
        case 2: return launch_epoch_logpost_thread<double, float, N>(*P, q, M, out, s);
        case 3: return launch_epoch_logpost_thread<double, double, N>(*P, q, M, out, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename C, int N>
static int launch_polish(const EpochBBParams& P, const PolishParams& Q, cudaStream_t stream) {
    auto kernel = epoch_map_polish_kernel<C, N>;
    const size_t bytes = sizeof(double) * POLISH_MAX_STARTS * (N + 1)
                         + epoch_warp_stage_bytes<C>(P);
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // tables larger than shared memory
    const int warps = Q.n_starts < POLISH_WARPS ? (int)Q.n_starts : POLISH_WARPS;
    kernel<<<(unsigned)P.n_epochs, 32 * warps, bytes, stream>>>(P, Q);
    return (int)cudaGetLastError();
}

template <typename C, typename S>
static int launch_summary(const SummaryParams& P, cudaStream_t stream) {
    auto kernel = epoch_summary_kernel<C, S>;
    const size_t bytes = sizeof(SummaryNode<C>) * (size_t)P.n_freq;
    int use_smem = 0;
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    if (!use_smem) return (int)cudaErrorInvalidValue;  // a grid longer than shared memory
    const dim3 grid((unsigned)((P.n_samples + 255) / 256), (unsigned)P.n_epochs);
    kernel<<<grid, 256, bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

extern "C" {

// K4 launch: q (E, M, ndim) f32 or f64, out (E, M) f64. With with_grad also
// grad (E, M, ndim) f64, a thread per vector (ndim 2-9); without it the
// values alone, ndim 2 or 3, the warp form or (thread_form) the thread form,
// the same bits. Returns 0 or a cudaError_t code (cudaErrorInvalidValue for
// any other ndim of the values, or their tables larger than a block's
// shared memory).
int epoch_logpost_launch(const EpochBBParams* P, int device, int compute_f64, const void* q,
                         int q_f64, int M, double* out, int with_grad, double* grad,
                         int thread_form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (M <= 0 || P->n_epochs <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || P->ndim < 2 || P->n_epochs > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (!with_grad) {
        const size_t bytes = compute_f64 ? epoch_warp_stage_bytes<double>(*P)
                                         : epoch_warp_stage_bytes<float>(*P);
        if ((P->ndim != 2 && P->ndim != 3) || bytes > (size_t)smem_optin_limit())
            return (int)cudaErrorInvalidValue;
        return P->ndim == 2
                   ? launch_epoch_values<2>(P, device, compute_f64, q, q_f64, M, out,
                                            thread_form, s)
                   : launch_epoch_values<3>(P, device, compute_f64, q, q_f64, M, out,
                                            thread_form, s);
    }
    switch (compute_f64 * 2 + q_f64) {
        case 0: return launch_epoch_logpost_grad<float, float>(*P, q, M, out, grad, s);
        case 1: return launch_epoch_logpost_grad<float, double>(*P, q, M, out, grad, s);
        case 2: return launch_epoch_logpost_grad<double, float>(*P, q, M, out, grad, s);
        case 3: return launch_epoch_logpost_grad<double, double>(*P, q, M, out, grad, s);
    }
    return (int)cudaErrorInvalidValue;
}

// Epoch half-step launch, a warp per walker (EpochBBModel, ndim 2 or 3):
// the arguments of stretch_half_step_launch (sc2_logpost.cu) over E = n_ens
// ensembles, x (E, 2, half, ndim), the draws of ensemble e draw_stride
// elements after those of e - 1. Returns 0 or a cudaError_t code
// (cudaErrorInvalidValue for tables larger than a block's shared memory).
int epoch_half_step_launch(const EpochBBParams* P, int device, int compute_f64, void* x,
                           int state_f64, double* logp, int half, int h, const void* u_z,
                           const long long* j, const void* u_acc, double a, void* chain_x,
                           int chain_x_f64, void* chain_lp, int chain_lp_f64, int* n_accept,
                           int n_ens, long long draw_stride, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    const size_t bytes = compute_f64 ? epoch_warp_stage_bytes<double>(*P)
                                     : epoch_warp_stage_bytes<float>(*P);
    if ((P->ndim != 2 && P->ndim != 3) || bytes > (size_t)smem_optin_limit())
        return (int)cudaErrorInvalidValue;
    if (P->ndim == 2)
        return launch_half_step<EpochBBModel2>(P, device, compute_f64, x, state_f64, logp, half, h,
                                               u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,
                                               chain_lp_f64, n_accept, stream, n_ens,
                                               draw_stride);
    return launch_half_step<EpochBBModel3>(P, device, compute_f64, x, state_f64, logp, half, h,
                                           u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,
                                           chain_lp_f64, n_accept, stream, n_ens, draw_stride);
}

// K4p launch: a block per epoch, min(S, POLISH_WARPS) warps, the tables and
// the result slots in shared memory; ndim 2 or 3, S <= POLISH_MAX_STARTS.
// Returns 0 or a cudaError_t code.
int epoch_map_polish_launch(const EpochBBParams* P, const PolishParams* Q, int device,
                            int compute_f64, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->n_epochs <= 0) return 0;
    if (P->n_epochs > 65535 || Q->n_starts < 1 || Q->n_starts > POLISH_MAX_STARTS
        || Q->n_iter < 0 || (P->ndim != 2 && P->ndim != 3))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 2 + (P->ndim == 3 ? 1 : 0);
    switch (key) {
        case 0: return launch_polish<float, 2>(*P, *Q, s);
        case 1: return launch_polish<float, 3>(*P, *Q, s);
        case 2: return launch_polish<double, 2>(*P, *Q, s);
        case 3: return launch_polish<double, 3>(*P, *Q, s);
    }
    return (int)cudaErrorInvalidValue;
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
