// Pieces shared by the fused log-posterior kernels of csrc/*.cu: device math
// overloads, the priors, the Gaussian residual, and the stretch-move
// half-step (K2), its latency form (a walker's points over a block, for
// SCWarpModel, SC4WarpModel and, over several ensembles, PopSC2WarpModel),
// its run form (a segment of steps in one
// block) and the batch log-posterior (also in a latency form) as templates
// over a model policy.
//
// A model policy M (SC2Model in sc2_logpost.cu, SC3WarpModel in
// sc3_logpost.cu, EpochBBModel in epoch_bb.cu, CSModel in companion.cu,
// SEDWarpModel in sed.cu) provides
//   typedef ... Params;  // the model's parameter block (8-byte fields)
//   typedef ... Data;    // the per-point data as the kernel reads it
//   static size_t stage_bytes(const Params&);             // host and device
//   static __device__ Data stage(const Params&, unsigned char* smem, int use_smem, int e);
// where e is the ensemble (epoch) of the block: always 0 for a single
// ensemble, whose data do not depend on it. A policy whose kernels run a
// warp per walker (stretch_half_step_kernel: SC2WarpModel, SC3WarpModel,
// CSWarpModel, EpochBBModel, SEDWarpModel; the tempered half-step
// tempered_half_step_kernel and the ladder's initial state
// ladder_init_kernel: SC2WarpModel, SC3WarpModel, CSWarpModel; the batch
// log-posterior logpost_warp_kernel: SC2WarpModel, SC3WarpModel,
// CSWarpModel, EpochBBModel, SEDWarpModel) provides
//   typedef ... Walker;  // a walker's constants (32-bit words, copied by value)
//   static __device__ Walker walker(const double* p, const Params&);
//   static __device__ double log_likelihood_warp(const Walker&, const Data&, const Params&);
//   static constexpr int warps_per_block;  // the warps a block
//   static constexpr bool batched;         // warps take batches of walkers (warp_batch_ll)
// where log_likelihood_warp is computed by the 32 lanes of a warp together,
// every lane returning the same bits, and may provide
//   static constexpr int ndim;  // the walker's dimension at compile time (policy_dim)
// which keeps the walker's state in registers,
//   static constexpr bool own_prior;  // its own log_prior (model_log_prior)
//   static constexpr int min_blocks;  // the half-step's least blocks an SM (block_min)
// Every Params has the fields ndim, use_sigma, has_affine, prior_kind,
// p_min, p_max, mean, stddev, affine_offset and affine_scale.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define LP_MAX_DIM 9   // CompanionShocking with the intrinsic scatter
#define LP_THREADS 128

__device__ __forceinline__ float m_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double m_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float m_exp(float a) { return expf(a); }
__device__ __forceinline__ double m_exp(double a) { return exp(a); }
__device__ __forceinline__ float m_expm1(float a) { return expm1f(a); }
__device__ __forceinline__ double m_expm1(double a) { return expm1(a); }
__device__ __forceinline__ float m_log(float a) { return logf(a); }
__device__ __forceinline__ double m_log(double a) { return log(a); }
__device__ __forceinline__ float m_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double m_sqrt(double a) { return sqrt(a); }

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// Butterfly reductions over a warp: every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
    for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
    for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The threads a block of a kernel over the policy M may have (its launch
// bound): 32 x M::warps_per_block for a warp-per-walker policy, else
// LP_THREADS.
template <typename M, typename = void>
struct block_limit {
    static constexpr int value = LP_THREADS;
};
template <typename M>
struct block_limit<M, std::void_t<decltype(M::warps_per_block)>> {
    static constexpr int value = 32 * M::warps_per_block;
};

// The least blocks an SM that the warp form of the half-step over M is built
// for (its launch bound's second argument): M::min_blocks where the policy
// gives it, else 0, none, as before the trait. A minimum of one lets ptxas
// take the registers of one block an SM where its own choice spills.
template <typename M, typename = void>
struct block_min {
    static constexpr int value = 0;
};
template <typename M>
struct block_min<M, std::void_t<decltype(M::min_blocks)>> {
    static constexpr int value = M::min_blocks;
};

// The walker dimension of a policy M known at compile time: M::ndim where
// the policy has one (EpochBBModel; SC2WarpModel, SC3WarpModel and
// CSWarpModel, whose N = 0 means none), else 0; 0 is P.ndim at run time.
template <typename M, typename = void>
struct policy_dim {
    static constexpr int value = 0;
};
template <typename M>
struct policy_dim<M, std::void_t<decltype(M::ndim)>> {
    static constexpr int value = M::ndim;
};

// Lane src's copy of the register struct v, to every lane of the warp, one
// 32-bit word at a time (the bits unchanged).
template <typename T>
__device__ __forceinline__ T shfl_struct(const T& v, int src) {
    static_assert(sizeof(T) % sizeof(int) == 0, "a struct of 32-bit words");
    constexpr int n = (int)(sizeof(T) / sizeof(int));
    int words[n];
    memcpy(words, &v, sizeof(T));
#pragma unroll
    for (int k = 0; k < n; ++k) words[k] = __shfl_sync(0xffffffffu, words[k], src);
    T out;
    memcpy(&out, words, sizeof(T));
    return out;
}

// power(base, e) of ops/mathx.py: 0 where base <= 0 (or NaN), never NaN from
// a negative base
template <typename C>
__device__ __forceinline__ C power0(C base, C e) {
    return base > C(0) ? m_pow(base, e) : C(0);
}

// absolute float64 parameter k of the walker state value q
template <typename Params, typename S>
__device__ __forceinline__ double to_absolute(const Params& P, int k, S q) {
    return P.has_affine ? __dadd_rn(P.affine_offset[k], __dmul_rn(P.affine_scale[k], (double)q))
                        : (double)q;
}

// Sum of the prior log-densities at absolute parameters p[ndim]: -inf
// outside the open bounds (NaN included). D: ndim when it is known at compile
// time (then p may live in registers), else 0.
template <int D = 0, typename Params>
__device__ __forceinline__ double log_prior(const Params& P, const double* p) {
    double sum = 0.0;
    for (int i = 0; i < (D > 0 ? D : (int)P.ndim); ++i) {
        const double v = p[i];
        if (!(v > P.p_min[i] && v < P.p_max[i])) return -INFINITY;  // also NaN
        double l;
        if (P.prior_kind[i] == 0) {
            l = 0.0;
        } else if (P.prior_kind[i] == 1) {
            l = -log(v);
        } else {
            const double zz = (v - P.mean[i]) / P.stddev[i];
            l = -0.5 * (zz * zz);
        }
        sum = sum + l;
    }
    return sum;
}

// Whether the policy M evaluates its own priors (M::own_prior, with
// static __device__ double log_prior(const Params&, const Data&, const
// double* p)): SEDWarpModel, whose KDE prior (kind 3) the 32 lanes of a
// warp evaluate together. The templates below call model_log_prior, which
// is log_prior<D> for every other policy.
template <typename M, typename = void>
struct policy_prior {
    static constexpr bool value = false;
};
template <typename M>
struct policy_prior<M, std::void_t<decltype(M::own_prior)>> {
    static constexpr bool value = M::own_prior;
};

template <typename M, int D>
__device__ __forceinline__ double model_log_prior(const typename M::Params& P,
                                                  const typename M::Data& d, const double* p) {
    if constexpr (policy_prior<M>::value) {
        return M::log_prior(P, d, p);
    } else {
        return log_prior<D>(P, p);
    }
}

// One point's term of the Gaussian residual sum, y_fit already divided by
// yscale: log(2 pi sigma^2) + r^2 / sigma^2 with the intrinsic scatter sig
// (use_sigma), else ((y - y_fit) / dy)^2.
template <typename C>
__device__ __forceinline__ C residual_term(bool use_sigma, C y_fit, C y, C inv_dy, C dy,
                                           C su, C sig) {
    if (use_sigma) {
        const C two_pi = (C)6.283185307179586;
        const C sg = sig * su;
        const C sigma2 = dy * dy + sg * sg;
        const C res = y - y_fit;
        return m_log(two_pi * sigma2) + res * res / sigma2;
    }
    const C r = (y - y_fit) * inv_dy;
    return r * r;
}

// The float64 log-likelihood from the residual sum acc in the compute type:
// -0.5 acc plus the normalization constant, added in the compute type; -inf
// when it is not finite.
template <typename C>
__device__ __forceinline__ double finish_log_likelihood(C acc, bool use_sigma, double ll_offset,
                                                        double log_norm_const) {
    const C ll = C(-0.5) * acc + (C)(use_sigma ? ll_offset : log_norm_const);
    if (!isfinite(ll)) return -INFINITY;
    return (double)ll;
}

// The Goodman-Weare proposal of stretch move from walker xm with partner xj
// and the uniform u: z = ((a - 1) u + 1)^2 / a, y = xj + z (xm - xj) in the
// state type with round-to-nearest intrinsics (no contraction, so it equals
// the plain PyTorch proposal bit for bit), p the absolute float64 parameters
// of y. Returns z. D as in log_prior.
template <int D = 0, typename Params, typename S>
__device__ __forceinline__ S stretch_proposal(const Params& P, const S* xm, const S* xj, S u,
                                              double a, S* y, double* p) {
    const S zw = add_rn(mul_rn((S)(a - 1.0), u), S(1));
    const S z = div_rn(mul_rn(zw, zw), (S)a);
    for (int k = 0; k < (D > 0 ? D : (int)P.ndim); ++k) {
        y[k] = add_rn(xj[k], mul_rn(z, sub_rn(xm[k], xj[k])));
        p[k] = to_absolute(P, k, y[k]);
    }
    return z;
}

// The log-likelihoods of a warp's batch of nb <= 32 walkers, a warp per
// walker: lane l has prepared walker l's log-prior lprior and, where it is
// finite (or, with EVERY, whatever it is), its constants wk (with nb = 1
// every lane has prepared the batch's one walker, on the same bits). For
// each walker k whose prior is finite (a uniform branch: the flag is lane
// k's), the 32 lanes evaluate M::log_likelihood_warp on walker k's
// constants, broadcast from lane k. Returns the value of the lane's own
// walker, -inf where its prior is not finite (its likelihood is never
// evaluated); with EVERY every walker's likelihood is evaluated, whatever
// its prior (the ladder's initial state: the swaps read log L alone). The
// point is inlined twice here (nb = 1, and the batch), so the batched
// policies (SC2WarpModel, CSWarpModel) round their float64 points by hand:
// then the bits do not depend on nb or EVERY. With a policy that is not
// batched nb is 1 and nothing is broadcast.
template <typename M, bool EVERY = false>
__device__ __forceinline__ double warp_batch_ll(const typename M::Walker& wk, double lprior,
                                                int nb, const typename M::Data& d,
                                                const typename M::Params& P) {
    if (!M::batched || nb == 1)
        return EVERY || isfinite(lprior) ? M::log_likelihood_warp(wk, d, P) : -INFINITY;
    const int lane = threadIdx.x & 31;
    double own = -INFINITY;
    for (int k = 0; k < nb; ++k) {
        if (!EVERY && !isfinite(__shfl_sync(0xffffffffu, lprior, k))) continue;
        const double ll = M::log_likelihood_warp(shfl_struct(wk, k), d, P);
        if (lane == k) own = ll;
    }
    return own;
}

// The Goodman-Weare accept decision for a walker at log-posterior lp_x and
// its proposal's lp_y (no NaN), stretch z and uniform u: log u < (ndim - 1)
// log z + lp_y - lp_x. log(0) = -inf accepts unless the ratio is -inf; a NaN
// ratio rejects. The one decision of the half-step and the run form.
template <typename S>
__device__ __forceinline__ bool stretch_accepts(int ndim, S z, double lp_y, double lp_x, S u) {
    const S lz = (S)(ndim - 1) * m_log(z);
    const double log_ratio = (double)lz + lp_y - lp_x;
    const double log_u = (double)m_log(u);
    return !isnan(log_ratio) && log_u < log_ratio;
}

// The end of one walker's Goodman-Weare half-step, from its proposal y
// (log-posterior lp_y, stretch z): the accept decision and its writes
// (offsets of stretch_half_step_kernel). D: ndim at compile time, or 0.
template <int D = 0, typename S, typename X, typename L>
__device__ __forceinline__ void half_step_accept(int n, S* xm, const S* y, S z, double lp_y,
                                                 double* logp, const S* u_acc, size_t w,
                                                 size_t di, X* chain_x, L* chain_lp,
                                                 int* n_accept) {
    const int ndim = D > 0 ? D : n;
    if (isnan(lp_y)) lp_y = -INFINITY;
    const double lp_x = logp[w];
    const bool accept = stretch_accepts<S>(ndim, z, lp_y, lp_x, u_acc[di]);
    double lp_new = lp_x;
    if (accept) {
        for (int k = 0; k < ndim; ++k) xm[k] = y[k];
        logp[w] = lp_y;
        lp_new = lp_y;
    }
    n_accept[w] += accept ? 1 : 0;
    if (chain_x != nullptr) {
        for (int k = 0; k < ndim; ++k) chain_x[w * ndim + k] = (X)xm[k];
        chain_lp[w] = (L)lp_new;
    }
}

// The half-steps of walkers b0 .. b0 + nb - 1 of half h of ensemble e, a
// warp per walker: lane l forms walker b0 + l's proposal, log-prior and
// constants (with nb = 1 every lane forms walker b0's, on the same bits),
// warp_batch_ll gives each its log-likelihood, and lane l decides and
// writes for its walker (lane 0 with nb = 1). A policy with a compile-time
// dimension (policy_dim) keeps the walker's state in registers.
template <typename M, typename S, typename X, typename L>
__device__ __forceinline__ void half_step_batch(const typename M::Params& P,
                                                const typename M::Data& d, S* x, double* logp,
                                                int half, int h, const S* u_z,
                                                const long long* j, const S* u_acc, double a,
                                                X* chain_x, L* chain_lp, int* n_accept,
                                                long long draw_stride, int e, int b0, int nb) {
    const int lane = threadIdx.x & 31;
    const bool own = nb == 1 || lane < nb;
    const int i = b0 + (nb == 1 ? 0 : lane);
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    const size_t ens = (size_t)e * 2 * half;
    const size_t di = (size_t)e * draw_stride + i;
    const size_t w = ens + (size_t)h * half + i;
    S y[D > 0 ? D : LP_MAX_DIM];
    S z = S(1);
    double lprior = -INFINITY;
    typename M::Walker wk;
    if (own) {
        const S* xj = x + (ens + (size_t)(1 - h) * half + (size_t)j[di]) * ndim;
        double p[D > 0 ? D : LP_MAX_DIM];
        z = stretch_proposal<D>(P, x + w * ndim, xj, u_z[di], a, y, p);
        lprior = model_log_prior<M, D>(P, d, p);
        if (isfinite(lprior)) wk = M::walker(p, P);
    }
    const double ll = warp_batch_ll<M>(wk, lprior, nb, d, P);
    if (lane >= nb) return;
    half_step_accept<D>(ndim, x + w * ndim, y, z, isfinite(lprior) ? lprior + ll : -INFINITY,
                        logp, u_acc, w, di, chain_x, chain_lp, n_accept);
}

// The launch of a warp-per-walker kernel (warp_layout): threads a block,
// blocks, and the walkers a warp takes at a time.
struct WarpLayout {
    int threads, blocks, batch;
};

// K2: one Goodman-Weare half-step for half h of the ensemble x (2, half,
// ndim), in place, with the proposal's log-posterior from the model policy
// M. The partner pool is the other half. Draws are inputs: u_z and u_acc
// uniform in [0, 1), j in [0, half). Adds the accept flag to n_accept and,
// when chain_x is not null, writes the walker's new state and log-posterior
// into the chain slot (2, half, ndim) / (2, half).
// Several independent ensembles advance in one launch along blockIdx.y: then
// x, logp, n_accept and the chain slot are (E, 2, half[, ndim]) and the
// draws of ensemble e start draw_stride elements after those of e - 1. With
// one ensemble (e = 0) every offset below is 0.
// A warp per walker (half_step_batch) for a policy whose
// log_likelihood_warp the 32 lanes compute together (SC2WarpModel for K2,
// SC3WarpModel, CSWarpModel, EpochBBModel), the block's warps striding over
// batches of `batch` walkers of the ensemble (warp_layout).
template <typename M, typename S, typename X, typename L>
__global__ void __launch_bounds__(block_limit<M>::value, block_min<M>::value)
stretch_half_step_kernel(const typename M::Params P, S* __restrict__ x,
                         double* __restrict__ logp, int half, int h,
                         const S* __restrict__ u_z, const long long* __restrict__ j,
                         const S* __restrict__ u_acc, double a, X* __restrict__ chain_x,
                         L* __restrict__ chain_lp, int* __restrict__ n_accept, int use_smem,
                         long long draw_stride, int batch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.y;
    const typename M::Data d = M::stage(P, smem_raw, use_smem, e);
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const int n_batches = (half + bsz - 1) / bsz;
    for (int b = blockIdx.x * per_block + (threadIdx.x >> 5); b < n_batches;
         b += gridDim.x * per_block) {   // (whole warps)
        const int b0 = b * bsz;
        half_step_batch<M, S, X, L>(P, d, x, logp, half, h, u_z, j, u_acc, a, chain_x, chain_lp,
                                    n_accept, draw_stride, e, b0,
                                    M::batched && half - b0 < bsz ? half - b0 : bsz);
    }
}

// ------------------------------------------------------------ latency form

// The latency form of K2, for a policy whose log-likelihood is a sum of
// per-point terms (ShockCooling's and ShockCooling4's in sc_logpost.cu),
// where a warp per walker leaves the card idle: a walker's points spread
// over a block of ceil(N / 32) warps, one point a thread. Such a policy
// also provides
//   typedef ... Compute;   // the compute type C of its terms
//   static __device__ C point_term(int n, const Walker&, const Data&, const Params&);
// point n's term of the residual sum, the one its log_likelihood_warp adds.
// Every Params of such a policy has n_points, ll_offset and log_norm_const.
// It may provide
//   static __device__ Walker walker_lanes(const double* p, const Params&);
// M::walker's bits, formed by the 32 lanes of a warp together
// (ShockCooling4's float64 powers, a lane each), and, for a policy whose
// sum is not finish_log_likelihood of add_rn over P.n_points terms (the
// population's, population.cu), all three of
//   static __device__ int n_terms(const Data&, const Params&);   // the terms summed
//   static __device__ C add_term(C acc, C t, const Params&);      // acc plus term t
//   static __device__ double finish(C acc, const Data&, const Params&);   // log L
// the operations of its log_likelihood_warp, and
//   static __device__ void prefetch(int n, const Data&, const Params&);
// which brings point n's data towards the SM while warp 0 forms the walker.
template <typename M, typename = void>
struct policy_point {
    static constexpr bool value = false;
};
template <typename M>
struct policy_point<M, std::void_t<decltype(&M::point_term)>> {
    static constexpr bool value = true;
};
template <typename M, typename = void>
struct policy_walker_lanes {
    static constexpr bool value = false;
};
template <typename M>
struct policy_walker_lanes<M, std::void_t<decltype(&M::walker_lanes)>> {
    static constexpr bool value = true;
};
template <typename M, typename = void>
struct policy_own_sum {
    static constexpr bool value = false;
};
template <typename M>
struct policy_own_sum<M, std::void_t<decltype(&M::add_term)>> {
    static constexpr bool value = true;
};

// The latency forms' terms summed, a term added and the finish: the
// policy's own (policy_own_sum), else P.n_points terms, add_rn and
// finish_log_likelihood.
template <typename M>
__device__ __forceinline__ int latency_terms(const typename M::Data& d,
                                             const typename M::Params& P) {
    if constexpr (policy_own_sum<M>::value) {
        return M::n_terms(d, P);
    } else {
        return (int)P.n_points;
    }
}
template <typename M, typename C>
__device__ __forceinline__ C latency_add(C acc, C t, const typename M::Params& P) {
    if constexpr (policy_own_sum<M>::value) {
        return M::add_term(acc, t, P);
    } else {
        return add_rn(acc, t);
    }
}
template <typename M, typename C>
__device__ __forceinline__ double latency_finish(C acc, const typename M::Data& d,
                                                 const typename M::Params& P) {
    if constexpr (policy_own_sum<M>::value) {
        return M::finish(acc, d, P);
    } else {
        return finish_log_likelihood<C>(acc, P.use_sigma, P.ll_offset, P.log_norm_const);
    }
}

// The latency form's largest walker: LP_LAT_WARPS warps, 32 x LP_LAT_WARPS
// points; LP_LAT_ENS_WARPS over several ensembles (the population's
// transients, at most 128 points: under the 640-thread bound ptxas kept a
// float32-compute, float64-state instantiation in 48 registers and spilled).
#define LP_LAT_WARPS 20
#define LP_LAT_ENS_WARPS 4
// The batch log-posterior's latency form over several ensembles (the
// population's P1): at most LP_LAT_LP_ENS_WARPS warps a walker, 256 points,
// under a bound of as many threads (no proposal to carry: every
// instantiation in registers, without a spill or a stack frame).
#define LP_LAT_LP_ENS_WARPS 8

// The latency forms' walker constants (a policy with point_term), formed by
// warp 0 from the absolute parameters p where `form` (uniform over the
// warp), into the shared walker_s: M::walker_lanes by the 32 lanes where the
// policy has it, else M::walker on lane 0. The same bits either way.
template <typename M>
__device__ __forceinline__ void latency_walker(const double* p, const typename M::Params& P,
                                               bool form, typename M::Walker& walker_s) {
    if constexpr (policy_walker_lanes<M>::value) {
        if (form) {
            const typename M::Walker wk = M::walker_lanes(p, P);
            if ((threadIdx.x & 31) == 0) walker_s = wk;
        }
    } else if ((threadIdx.x & 31) == 0 && form) {
        walker_s = M::walker(p, P);
    }
}

// The latency forms' block body: every thread of the block calls it once
// warp 0 has put the walker's constants into walker_s and its prior into
// *lprior_s (shared memory). After a barrier thread n forms point n's term
// into terms[n] (blockDim.x of them, shared memory), where the prior is
// finite or with EVERY whatever it is; after another, warp 0 sums the terms
// in log_likelihood_warp's order (lane l adds its points l, l + 32, ... in
// turn with add_rn, then warp_sum's butterfly) and finish_log_likelihood
// (or the policy's own latency_terms, latency_add and latency_finish).
// Returns that log-likelihood on warp 0 (every lane the same bits: the
// warp form's), -inf where it was not evaluated and on the other warps. With
// EVERY, lprior_s is not read (may be null). The latency forms of the batch
// log-posterior and K6b call it; those of the half-step and K6a keep their
// own copy of these lines: through this function ptxas spilled 4-20 bytes
// in their float32-compute, float64-state instantiations, which their own
// copies keep in 32 registers without a spill (PERF.md §6).
template <typename M, bool EVERY = false>
__device__ __forceinline__ double latency_log_likelihood(const double* lprior_s,
                                                         const typename M::Walker& walker_s,
                                                         const typename M::Data& d,
                                                         const typename M::Params& P,
                                                         typename M::Compute* terms) {
    typedef typename M::Compute C;
    __syncthreads();
    const int n = threadIdx.x, N = latency_terms<M>(d, P);
    // (the prior, read at each use, is uniform over the block)
    if (n < N && (EVERY || isfinite(*lprior_s))) terms[n] = M::point_term(n, walker_s, d, P);
    __syncthreads();
    if (n >= 32 || !(EVERY || isfinite(*lprior_s))) return -INFINITY;
    C acc = C(0);
    for (int k = n; k < N; k += 32) acc = latency_add<M>(acc, terms[k], P);
    return latency_finish<M>(warp_sum(acc), d, P);
}

// K2's latency form (a policy with point_term): one Goodman-Weare half-step
// of half h, the arguments and writes of stretch_half_step_kernel. A block
// per walker, of ceil(N / 32) warps: the per-point data are read where they
// lie (M::stage without staging: a block would copy the whole table for one
// walker). Warp 0 forms the walker's proposal, prior and constants (every
// lane the same bits, as half_step_batch with nb = 1) and puts the prior
// and the constants into shared memory; after a barrier, thread n forms
// point n's term, into shared memory; after another, warp 0 sums them in
// log_likelihood_warp's order (lane l adds its points l, l + 32, ... in
// turn with add_rn, then warp_sum's butterfly and finish_log_likelihood;
// or the policy's own latency_terms, latency_add and latency_finish) and
// its lane 0 decides and writes. So the stored log-posterior has the bits
// of the warp form, of the batch log-posterior and of K6b at that state.
// One walker a block was the fastest at every width measured for SC and SC4
// (two and four a block 4-24% slower from half 2048 up, PERF.md §6). ENS:
// several ensembles along blockIdx.y, as stretch_half_step_kernel takes
// them (the population's transients: ensemble e's data through M::stage,
// its draws draw_stride after those of e - 1), and warp 0 keeps the
// proposal, its stretch and its prior in shared memory while its threads
// form their points (held in registers, they spilled in ptxas's report);
// without it one ensemble.
template <typename M, typename S, typename X, typename L, bool ENS = false>
__global__ void __launch_bounds__(32 * (ENS ? LP_LAT_ENS_WARPS : LP_LAT_WARPS))
stretch_half_step_latency_kernel(const typename M::Params P, S* __restrict__ x,
                                 double* __restrict__ logp, int half, int h,
                                 const S* __restrict__ u_z, const long long* __restrict__ j,
                                 const S* __restrict__ u_acc, double a, X* __restrict__ chain_x,
                                 L* __restrict__ chain_lp, int* __restrict__ n_accept,
                                 long long draw_stride) {
    typedef typename M::Compute C;
    typedef typename M::Walker Walker;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double lprior_s;
    __shared__ Walker walker_s;
    __shared__ S prop_s[(policy_dim<M>::value > 0 ? policy_dim<M>::value : LP_MAX_DIM) + 1];
    C* terms = reinterpret_cast<C*>(smem_raw);   // blockDim.x of them
    const int e = ENS ? (int)blockIdx.y : 0;
    const typename M::Data d = M::stage(P, nullptr, 0, e);
    const int i = blockIdx.x, n = threadIdx.x, lane = threadIdx.x & 31;
    const bool lead = n < 32;
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    const int N = latency_terms<M>(d, P);
    const size_t ens = ENS ? (size_t)e * 2 * half : 0;
    const size_t di = ENS ? (size_t)e * draw_stride + i : (size_t)i;
    const size_t w = ens + (size_t)h * half + i;
    if constexpr (ENS) {
        if (n < N) M::prefetch(n, d, P);
    }
    S y[D > 0 ? D : LP_MAX_DIM];
    S z = S(1);
    double lprior = -INFINITY;
    if (lead) {
        const S* xj = x + (ens + (size_t)(1 - h) * half + (size_t)j[di]) * ndim;
        double p[D > 0 ? D : LP_MAX_DIM];
        z = stretch_proposal<D>(P, x + w * ndim, xj, u_z[di], a, y, p);
        lprior = model_log_prior<M, D>(P, d, p);
        if (lane == 0) lprior_s = lprior;
        if constexpr (ENS) {
            if (lane == 0) {
                for (int k = 0; k < ndim; ++k) prop_s[k] = y[k];
                prop_s[ndim] = z;
            }
        }
        if constexpr (policy_walker_lanes<M>::value) {
            if (isfinite(lprior)) {   // (uniform over the warp)
                const Walker wk = M::walker_lanes(p, P);
                if (lane == 0) walker_s = wk;
            }
        } else if (lane == 0 && isfinite(lprior)) {
            walker_s = M::walker(p, P);
        }
    }
    __syncthreads();
    if (n < N && isfinite(lprior_s)) terms[n] = M::point_term(n, walker_s, d, P);
    __syncthreads();
    if (!lead) return;
    if constexpr (ENS) lprior = lprior_s;
    double ll = -INFINITY;
    if (isfinite(lprior)) {   // (uniform over the warp)
        C acc = C(0);
        for (int k = lane; k < N; k += 32) acc = latency_add<M>(acc, terms[k], P);
        ll = latency_finish<M>(warp_sum(acc), d, P);
    }
    if (lane != 0) return;
    if constexpr (ENS) {
        for (int k = 0; k < ndim; ++k) y[k] = prop_s[k];
        z = prop_s[ndim];
    }
    half_step_accept<D>(ndim, x + w * ndim, y, z, isfinite(lprior) ? lprior + ll : -INFINITY,
                        logp, u_acc, w, di, chain_x, chain_lp, n_accept);
}

// The log-posteriors of walkers b0 .. b0 + nb - 1 of q, a warp per walker, as
// half_step_batch evaluates a proposal: lane l maps walker b0 + l's state to
// absolute parameters and forms its log-prior and, where that is finite, its
// constants (with nb = 1 every lane forms walker b0's), warp_batch_ll gives
// each its log-likelihood, and lane l writes its walker's value (lane 0 with
// nb = 1): -inf outside the priors, and for a NaN.
template <typename M, typename S>
__device__ __forceinline__ void logpost_batch(const typename M::Params& P,
                                              const typename M::Data& d, const S* q,
                                              double* out, int b0, int nb) {
    const int lane = threadIdx.x & 31;
    const bool own = nb == 1 || lane < nb;
    const int i = b0 + (nb == 1 ? 0 : lane);
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    double lprior = -INFINITY;
    typename M::Walker wk;
    if (own) {
        double p[D > 0 ? D : LP_MAX_DIM];
        for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, q[(size_t)i * ndim + k]);
        lprior = model_log_prior<M, D>(P, d, p);
        if (isfinite(lprior)) wk = M::walker(p, P);
    }
    const double ll = warp_batch_ll<M>(wk, lprior, nb, d, P);
    if (lane >= nb) return;
    const double lp = isfinite(lprior) ? lprior + ll : -INFINITY;
    out[i] = isnan(lp) ? -INFINITY : lp;
}

// The batch log-posterior over a warp policy M: out[i] = log_prior + log L of
// walker state q[i, :] (W, ndim), affine-mapped when has_affine, float64; the
// initial state of a fit, LogPosterior.forward and the epochs' K4. A warp per
// walker (logpost_batch) in the half-step's layout (warp_layout) and staging,
// so a state's value has the bits that the half-step of the same policy
// stores when it accepts that state as a proposal. Several ensembles along
// blockIdx.y, as the half-step takes them: q (E, W, ndim) and out (E, W),
// ensemble e's data staged by its blocks; with one ensemble (e = 0) every
// offset is 0.
template <typename M, typename S>
__global__ void __launch_bounds__(block_limit<M>::value)
logpost_warp_kernel(const typename M::Params P, const S* __restrict__ q, int W,
                    double* __restrict__ out, int use_smem, int batch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.y;
    const typename M::Data d = M::stage(P, smem_raw, use_smem, e);
    constexpr int D = policy_dim<M>::value;
    const size_t ens = (size_t)e * W;
    q += ens * (D > 0 ? D : (int)P.ndim);
    out += ens;
    const int per_block = blockDim.x >> 5;
    const int bsz = M::batched ? batch : 1;   // (a constant 1 when not batched)
    const int n_batches = (W + bsz - 1) / bsz;
    for (int b = blockIdx.x * per_block + (threadIdx.x >> 5); b < n_batches;
         b += gridDim.x * per_block) {   // (whole warps)
        const int b0 = b * bsz;
        logpost_batch<M, S>(P, d, q, out, b0, M::batched && W - b0 < bsz ? W - b0 : bsz);
    }
}

// The batch log-posterior's latency form (a policy with point_term:
// SCWarpModel and SC4WarpModel of sc_logpost.cu), where a warp per walker
// leaves the card idle (the fits' initial states, 64-4096 walkers): out[i]
// for the walker state q[i, :] (W, ndim), one ensemble, a block per walker
// of ceil(N / 32) warps, the per-point data read where they lie. Warp 0 maps
// the state to absolute parameters and forms its prior and, where that is
// finite, its constants (every lane the same bits, as logpost_batch with
// nb = 1; latency_walker), latency_log_likelihood sums the points' terms, a
// point a thread, in the warp form's order, and lane 0 writes
// logpost_batch's value: -inf outside the priors, and for a NaN. So a
// state's value has the warp form's bits, and those that the half-steps
// and K6a (both forms of each) store when they accept it. ENS: several
// ensembles along blockIdx.y, as logpost_warp_kernel takes them (the
// population's transients, PopSC2WarpModel: q (E, W, ndim) and out (E, W),
// W = gridDim.x, ensemble e's data through M::stage), each thread first
// bringing its point's data towards the SM (M::prefetch) while warp 0
// forms the walker; without it one ensemble.
template <typename M, typename S, bool ENS = false>
__global__ void __launch_bounds__(32 * (ENS ? LP_LAT_LP_ENS_WARPS : LP_LAT_WARPS))
logpost_latency_kernel(const typename M::Params P, const S* __restrict__ q,
                       double* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double lprior_s;
    __shared__ typename M::Walker walker_s;
    const int e = ENS ? (int)blockIdx.y : 0;
    const typename M::Data d = M::stage(P, nullptr, 0, e);
    const int i = blockIdx.x;
    constexpr int D = policy_dim<M>::value;
    const int ndim = D > 0 ? D : (int)P.ndim;
    if constexpr (ENS) {
        const size_t ens = (size_t)e * gridDim.x;
        q += ens * ndim;
        out += ens;
        if ((int)threadIdx.x < latency_terms<M>(d, P)) M::prefetch(threadIdx.x, d, P);
    }
    double lprior = -INFINITY;
    if (threadIdx.x < 32) {
        double p[D > 0 ? D : LP_MAX_DIM];
        for (int k = 0; k < ndim; ++k) p[k] = to_absolute(P, k, q[(size_t)i * ndim + k]);
        lprior = model_log_prior<M, D>(P, d, p);
        if (threadIdx.x == 0) lprior_s = lprior;
        latency_walker<M>(p, P, isfinite(lprior), walker_s);
    }
    const double ll = latency_log_likelihood<M>(&lprior_s, walker_s, d, P,
                                                reinterpret_cast<typename M::Compute*>(smem_raw));
    if (threadIdx.x != 0) return;
    const double lp = isfinite(lprior) ? lprior + ll : -INFINITY;
    out[i] = isnan(lp) ? -INFINITY : lp;
}

// ---------------------------------------------------------------- run form

// The run form: a whole segment of stretch-move steps of one ensemble in one
// launch and one block (stretch_run_kernel), for a warp policy that is not
// batched and has a compile-time ndim (SEDWarpModel). Such a policy may also
// provide
//   static constexpr bool block_prior;   // its prior takes the whole block
//   static size_t block_prior_doubles(const Params&, int half);   // scratch
//   static int block_prior_warps(const Params&, int half);        // warps it wants
//   static __device__ double block_log_prior(const Params&, const Data&,
//       const double* p, bool own, int i, int half, double* scratch);
// which every thread of the block calls, walker i's warp (own) with its
// proposal's absolute parameters p; it returns that warp M::log_prior's
// bits at p. SEDWarpModel's KDE prior takes the warps that hold no moving
// walker that way.
#define LP_RUN_WARPS 32   // the run form's largest half: a warp per walker, one block

template <typename M, typename = void>
struct policy_block_prior {
    static constexpr bool value = false;
};
template <typename M>
struct policy_block_prior<M, std::void_t<decltype(M::block_prior)>> {
    static constexpr bool value = M::block_prior;
};

template <typename M, int D>
__device__ __forceinline__ double run_log_prior(const typename M::Params& P,
                                                const typename M::Data& d, const double* p,
                                                bool own, int i, int half, double* scratch) {
    if constexpr (policy_block_prior<M>::value) {
        return M::block_log_prior(P, d, p, own, i, half, scratch);
    } else {
        return own ? model_log_prior<M, D>(P, d, p) : -INFINITY;
    }
}

// The run form's own shared memory, before the staged data: the
// log-posteriors (2, half) float64, the policy's scratch, then the state
// (2, half, D) in S, rounded up to 16 bytes.
template <typename M>
__host__ __device__ inline size_t run_prior_doubles(const typename M::Params& P, int half) {
    if constexpr (policy_block_prior<M>::value) {
        return M::block_prior_doubles(P, half);
    } else {
        return 0;
    }
}
template <typename M, typename S>
__host__ __device__ inline size_t run_own_bytes(const typename M::Params& P, int half) {
    const size_t b = sizeof(double) * (2 * (size_t)half + run_prior_doubles<M>(P, half))
                     + sizeof(S) * 2 * (size_t)half * policy_dim<M>::value;
    return (b + 15) / 16 * 16;
}

// n_prop stretch-move proposals of the ensemble x (2, half, D) in one block:
// for each, half 0, __syncthreads(), half 1, __syncthreads(), half 1
// reading half 0's new states as its partner pool, as stretch_half_step_kernel
// launched twice. Warp i moves walker i of each half (warps past half only
// help a block-wide prior). The state and its log-posteriors live in shared
// memory for the whole run, the policy's data are staged once, the accept
// counts live in registers and are added to n_accept (2, half) at the end.
// The draws of proposal s are u_z, j, u_acc[s] (2, half). When chain_x is
// not null, proposal s with s % thin_by == thin_by - 1 writes its new states
// and log-posteriors into chain slot s / thin_by of chain_x (n_prop /
// thin_by, 2, half, D) and chain_lp. Each walker's proposal, prior,
// likelihood and decision are half_step_batch's (nb = 1), so the run gives
// the bits of n_prop x 2 half-step launches on the same draws.
template <typename M, typename S, typename X, typename L>
__global__ void __launch_bounds__(32 * LP_RUN_WARPS)
stretch_run_kernel(const typename M::Params P, S* __restrict__ x, double* __restrict__ logp,
                   int half, int n_prop, int thin_by, const S* __restrict__ u_z,
                   const long long* __restrict__ j, const S* __restrict__ u_acc, double a,
                   X* __restrict__ chain_x, L* __restrict__ chain_lp,
                   int* __restrict__ n_accept, int use_smem) {
    static_assert(!M::batched, "the run form takes a warp per walker");
    constexpr int D = policy_dim<M>::value;
    static_assert(D > 0, "the run form keeps the walker's state in registers");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* lp_s = reinterpret_cast<double*>(smem_raw);
    double* scratch = lp_s + 2 * half;
    S* x_s = reinterpret_cast<S*>(scratch + run_prior_doubles<M>(P, half));
    const int n_state = 2 * half * D;
    for (int t = threadIdx.x; t < n_state; t += blockDim.x) x_s[t] = x[t];
    for (int t = threadIdx.x; t < 2 * half; t += blockDim.x) lp_s[t] = logp[t];
    const typename M::Data d = M::stage(P, smem_raw + run_own_bytes<M, S>(P, half), use_smem, 0);
    __syncthreads();
    const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool own = i < half;
    int acc0 = 0, acc1 = 0;
    // each half-step's draws are loaded one half-step ahead (the next one's
    // lie half elements further on), so their latency overlaps a half-step
    const size_t n_draws = (size_t)n_prop * 2 * half;
    S dz = S(0), du = S(0);
    long long dj = 0;
    if (own) dz = u_z[i], dj = j[i], du = u_acc[i];
    for (int s = 0; s < n_prop; ++s) {
        const bool stored = chain_x != nullptr && s % thin_by == thin_by - 1;
        for (int h = 0; h < 2; ++h) {
            const size_t w = (size_t)h * half + i;
            const size_t next = (size_t)s * 2 * half + w + half;
            S nz = S(0), nu = S(0);
            long long nj = 0;
            if (own && next < n_draws) nz = u_z[next], nj = j[next], nu = u_acc[next];
            S* xm = x_s + w * D;
            S y[D];
            double p[D];
            S z = S(1);
            if (own) {
                const S* xj = x_s + ((size_t)(1 - h) * half + (size_t)dj) * D;
                z = stretch_proposal<D>(P, xm, xj, dz, a, y, p);
            }
            const double lprior = run_log_prior<M, D>(P, d, p, own, i, half, scratch);
            if (own) {
                double lp_y = -INFINITY;
                if (isfinite(lprior)) {
                    const typename M::Walker wk = M::walker(p, P);
                    lp_y = lprior + M::log_likelihood_warp(wk, d, P);
                }
                if (isnan(lp_y)) lp_y = -INFINITY;
                const double lp_x = lp_s[w];
                const bool accept = stretch_accepts<S>(D, z, lp_y, lp_x, du);
                __syncwarp();   // every lane has read xm and lp_x
                if (lane == 0) {
                    if (accept) {
#pragma unroll
                        for (int k = 0; k < D; ++k) xm[k] = y[k];
                        lp_s[w] = lp_y;
                    }
                    if (h == 0) acc0 += accept ? 1 : 0;
                    else acc1 += accept ? 1 : 0;
                    if (stored) {
                        const size_t c = (size_t)(s / thin_by) * 2 * half + w;
#pragma unroll
                        for (int k = 0; k < D; ++k) chain_x[c * D + k] = (X)xm[k];
                        chain_lp[c] = (L)(accept ? lp_y : lp_x);
                    }
                }
            }
            dz = nz, dj = nj, du = nu;
            __syncthreads();
        }
    }
    for (int t = threadIdx.x; t < n_state; t += blockDim.x) x[t] = x_s[t];
    for (int t = threadIdx.x; t < 2 * half; t += blockDim.x) logp[t] = lp_s[t];
    if (own && lane == 0) {
        n_accept[i] += acc0;
        n_accept[half + i] += acc1;
    }
}

// ------------------------------------------------------------------ launch

// The card's opt-in shared-memory limit per block, read once per device and
// kept (the attribute query is a runtime API call, and every launch asks).
static inline int smem_optin_limit() {
    static int limit[64] = {0};   // 0: not read yet
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return 48 * 1024;
    if (limit[dev] == 0) {
        int v = 0;
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        limit[dev] = v > 0 ? v : 48 * 1024;
    }
    return limit[dev];
}

// Dynamic shared memory for a kernel that stages `bytes`: 0 (read global
// memory) when the card's opt-in limit is smaller.
template <typename Kernel>
static int smem_plan(Kernel kernel, size_t bytes, int* use_smem) {
    if (bytes > (size_t)smem_optin_limit()) {
        *use_smem = 0;  // read the per-point data from global memory instead
        return 0;
    }
    *use_smem = 1;
    if (bytes > 48 * 1024)
        return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    return 0;
}

// Copy len elements of src into the shared-memory cursor s and advance it
// (every thread of the block takes part).
template <typename T>
__device__ __forceinline__ const T* stage_array(const T* src, long long len, T*& s) {
    for (long long i = threadIdx.x; i < len; i += blockDim.x) s[i] = src[i];
    const T* out = s;
    s += len;
    return out;
}

// Threads a block for n parameter vectors of one ensemble: a warp multiple,
// at most max_threads (small ensembles leave no idle warps).
static inline int threads_for(long long n, int max_threads = LP_THREADS) {
    const long long t = (n + 31) / 32 * 32;
    return t < max_threads ? (int)t : max_threads;
}

// The current device's SMs (read once per device, and kept).
static inline int device_sms() {
    static int key_dev = -1, sms = 1;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev != key_dev) {
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 1;
        key_dev = dev;
    }
    return sms;
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that the card holds at once for `kernel`: its occupancy times the SMs
// (read once per kernel, device, block size and shared memory, and kept).
template <typename Kernel>
static int resident_blocks(Kernel kernel, int threads, size_t smem) {
    static const void* key_fn = nullptr;
    static int key_dev = -1, key_threads = 0, resident = 1;
    static size_t key_smem = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if ((const void*)kernel != key_fn || dev != key_dev || threads != key_threads
        || smem != key_smem) {
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        resident = device_sms() * (per_sm > 0 ? per_sm : 1);
        key_fn = (const void*)kernel, key_dev = dev, key_threads = threads, key_smem = smem;
    }
    return resident;
}

// The WarpLayout of a warp-per-walker kernel over n walkers for the policy
// M. Not batched: M::warps_per_block warps a block (fewer for a small n), a
// walker a warp, a block for every warps_per_block walkers. Batched: a
// small launch spread over the SMs (no more warps a block than ceil(n /
// SMs), but 8 at least: a block stages the tables with its own threads, and
// 32 take ~3x as long), and batches of ceil(n / W) walkers (at most 32), W
// the warps the card holds at once (resident_blocks), so that every batch
// runs in one wave and a walker's prologue (proposal, prior, constants)
// runs on a lane of its own.
template <typename M, typename Kernel>
static WarpLayout warp_layout(Kernel kernel, long long n, size_t smem) {
    static_assert(32 * M::warps_per_block <= 1024, "block too large");
    WarpLayout L;
    int per_block = M::warps_per_block;
    L.batch = 1;
    if (M::batched) {
        const int sms = device_sms();
        const long long spread = (n + sms - 1) / sms;
        const int fewest = per_block < 8 ? per_block : 8;
        if (spread < per_block) per_block = spread > fewest ? (int)spread : fewest;
        L.threads = 32 * per_block;
        const long long warps = (long long)resident_blocks(kernel, L.threads, smem) * per_block;
        const long long batch = (n + warps - 1) / warps;
        L.batch = (int)(batch < 32 ? batch : 32);
    } else {
        L.threads = threads_for(32 * n, 32 * per_block);
        per_block = L.threads / 32;
    }
    const long long n_batches = (n + L.batch - 1) / L.batch;
    L.blocks = (int)((n_batches + per_block - 1) / per_block);
    return L;
}

template <typename M, typename S, typename X, typename L>
static int launch_half(const typename M::Params& P, void* x, double* logp, int half, int h,
                       const void* u_z, const long long* j, const void* u_acc, double a,
                       void* chain_x, void* chain_lp, int* n_accept, int n_ens,
                       long long draw_stride, cudaStream_t stream) {
    auto kernel = stretch_half_step_kernel<M, S, X, L>;
    int use_smem = 0;
    size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const WarpLayout lay = warp_layout<M>(kernel, half, use_smem ? bytes : 0);
    const dim3 grid(lay.blocks, n_ens);
    kernel<<<grid, lay.threads, use_smem ? bytes : 0, stream>>>(
        P, (S*)x, logp, half, h, (const S*)u_z, j, (const S*)u_acc, a, (X*)chain_x,
        (L*)chain_lp, n_accept, use_smem, draw_stride, lay.batch);
    return (int)cudaGetLastError();
}

// K2's latency form (stretch_half_step_latency_kernel) over half walkers of
// each of n_ens ensembles (ENS; else one), a block of ceil(N / 32) warps
// each. Refused for a policy without point_term, and past LP_LAT_WARPS
// (ENS: LP_LAT_ENS_WARPS) warps a walker.
template <typename M, typename S, typename X, typename L, bool ENS = false>
static int launch_half_latency(const typename M::Params& P, void* x, double* logp, int half,
                               int h, const void* u_z, const long long* j, const void* u_acc,
                               double a, void* chain_x, void* chain_lp, int* n_accept,
                               cudaStream_t stream, int n_ens = 1, long long draw_stride = 0) {
    if constexpr (!policy_point<M>::value) {
        return (int)cudaErrorInvalidValue;
    } else {
        auto kernel = stretch_half_step_latency_kernel<M, S, X, L, ENS>;
        const long long per_walker = (P.n_points + 31) / 32;
        if (per_walker < 1 || per_walker > (ENS ? LP_LAT_ENS_WARPS : LP_LAT_WARPS)
            || (!ENS && n_ens != 1))
            return (int)cudaErrorInvalidValue;
        const int threads = (int)(32 * per_walker);
        kernel<<<dim3((unsigned)half, (unsigned)n_ens), threads,
                 sizeof(typename M::Compute) * threads, stream>>>(
            P, (S*)x, logp, half, h, (const S*)u_z, j, (const S*)u_acc, a, (X*)chain_x,
            (L*)chain_lp, n_accept, draw_stride);
        return (int)cudaGetLastError();
    }
}

// The half-step launch for the model policy M<C> of the run's dtypes: the
// compute type C, the walker state S, the chain's state X and log-posterior
// L, each float or double; n_ens ensembles (draw_stride apart in the draws),
// 1 and 0 for a single one; form 0 the warp form, 1 the latency form (one
// ensemble, a policy with point_term). Returns 0 or a cudaError_t code.
template <template <typename> class M>
static int launch_half_step(const typename M<float>::Params* P, int device, int compute_f64,
                            void* x, int state_f64, double* logp, int half, int h,
                            const void* u_z, const long long* j, const void* u_acc, double a,
                            void* chain_x, int chain_x_f64, void* chain_lp, int chain_lp_f64,
                            int* n_accept, void* stream, int n_ens = 1,
                            long long draw_stride = 0, int form = 0) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || n_ens <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || n_ens > 65535 || (form != 0 && (form != 1 || n_ens != 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 8 + state_f64 * 4 + chain_x_f64 * 2 + chain_lp_f64;
#define LP_HALF_CASE(K, C, S, X, L)                                                           \
    case K:                                                                                   \
        return form ? launch_half_latency<M<C>, S, X, L>(*P, x, logp, half, h, u_z, j, u_acc, \
                                                         a, chain_x, chain_lp, n_accept, s)   \
                    : launch_half<M<C>, S, X, L>(*P, x, logp, half, h, u_z, j, u_acc, a,      \
                                                 chain_x, chain_lp, n_accept, n_ens,          \
                                                 draw_stride, s);
    switch (key) {
        LP_HALF_CASE(0, float, float, float, float)
        LP_HALF_CASE(1, float, float, float, double)
        LP_HALF_CASE(2, float, float, double, float)
        LP_HALF_CASE(3, float, float, double, double)
        LP_HALF_CASE(4, float, double, float, float)
        LP_HALF_CASE(5, float, double, float, double)
        LP_HALF_CASE(6, float, double, double, float)
        LP_HALF_CASE(7, float, double, double, double)
        LP_HALF_CASE(8, double, float, float, float)
        LP_HALF_CASE(9, double, float, float, double)
        LP_HALF_CASE(10, double, float, double, float)
        LP_HALF_CASE(11, double, float, double, double)
        LP_HALF_CASE(12, double, double, float, float)
        LP_HALF_CASE(13, double, double, float, double)
        LP_HALF_CASE(14, double, double, double, float)
        LP_HALF_CASE(15, double, double, double, double)
    }
#undef LP_HALF_CASE
    return (int)cudaErrorInvalidValue;
}

// The layout of a batched policy takes its batch from the walkers of all
// n_ens ensembles (a grid sized for one ensemble's warps, n_ens times over,
// would oversubscribe the card); a walker a warp needs no such care.
template <typename M, typename S>
static int launch_logpost_warp(const typename M::Params& P, const void* q, int W, int n_ens,
                               double* out, cudaStream_t stream) {
    auto kernel = logpost_warp_kernel<M, S>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    const WarpLayout lay = warp_layout<M>(kernel, M::batched ? (long long)n_ens * W : W,
                                          use_smem ? bytes : 0);
    const long long n_batches = (W + lay.batch - 1) / lay.batch;
    const int per_block = lay.threads / 32;
    const dim3 grid((unsigned)((n_batches + per_block - 1) / per_block), (unsigned)n_ens);
    kernel<<<grid, lay.threads, use_smem ? bytes : 0, stream>>>(P, (const S*)q, W, out,
                                                                use_smem, lay.batch);
    return (int)cudaGetLastError();
}

// The batch log-posterior's latency form (logpost_latency_kernel) over W
// walkers of each of n_ens ensembles (ENS; else one), a block of
// ceil(N / 32) warps each. Refused for a policy without point_term, and
// past LP_LAT_WARPS (ENS: LP_LAT_LP_ENS_WARPS) warps a walker.
template <typename M, typename S, bool ENS = false>
static int launch_logpost_latency(const typename M::Params& P, const void* q, int W,
                                  double* out, cudaStream_t stream, int n_ens = 1) {
    if constexpr (!policy_point<M>::value) {
        return (int)cudaErrorInvalidValue;
    } else {
        const long long per_walker = (P.n_points + 31) / 32;
        if (per_walker < 1 || per_walker > (ENS ? LP_LAT_LP_ENS_WARPS : LP_LAT_WARPS)
            || (!ENS && n_ens != 1))
            return (int)cudaErrorInvalidValue;
        const int threads = (int)(32 * per_walker);
        logpost_latency_kernel<M, S, ENS><<<dim3((unsigned)W, (unsigned)n_ens), threads,
                                            sizeof(typename M::Compute) * threads, stream>>>(
            P, (const S*)q, out);
        return (int)cudaGetLastError();
    }
}

// The batch log-posterior launch for the warp policy M<C> of the compute
// type C and the state's type, each float or double, over n_ens ensembles
// of W walkers; form 0 the warp form (logpost_warp_kernel), 1 the latency
// form (logpost_latency_kernel: one ensemble, a policy with point_term).
// Returns 0 or a cudaError_t code.
template <template <typename> class M>
static int launch_logpost(const typename M<float>::Params* P, int device, int compute_f64,
                          const void* q, int q_f64, int W, double* out, void* stream,
                          int n_ens = 1, int form = 0) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || n_ens <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || n_ens > 65535 || (form != 0 && (form != 1 || n_ens != 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define LP_LOGPOST_CASE(C, S)                                       \
    (form ? launch_logpost_latency<M<C>, S>(*P, q, W, out, s)      \
          : launch_logpost_warp<M<C>, S>(*P, q, W, n_ens, out, s))
    if (compute_f64)
        return q_f64 ? LP_LOGPOST_CASE(double, double) : LP_LOGPOST_CASE(double, float);
    return q_f64 ? LP_LOGPOST_CASE(float, double) : LP_LOGPOST_CASE(float, float);
#undef LP_LOGPOST_CASE
}

// The run form's warps: a warp per walker of a half, or more where the
// policy's block-wide prior wants them (at most LP_RUN_WARPS).
template <typename M>
static inline int run_warps(const typename M::Params& P, int half) {
    int w = half;
    if constexpr (policy_block_prior<M>::value) {
        const int want = M::block_prior_warps(P, half);
        if (want > w) w = want;
    }
    return w < LP_RUN_WARPS ? w : LP_RUN_WARPS;
}

template <typename M, typename S, typename X, typename L>
static int launch_run_t(const typename M::Params& P, void* x, double* logp, int half,
                        int n_prop, int thin_by, const void* u_z, const long long* j,
                        const void* u_acc, double a, void* chain_x, void* chain_lp,
                        int* n_accept, cudaStream_t stream) {
    auto kernel = stretch_run_kernel<M, S, X, L>;
    const size_t own = run_own_bytes<M, S>(P, half);
    const size_t staged = M::stage_bytes(P);
    const size_t limit = (size_t)smem_optin_limit();
    // the state and the scratch always live in shared memory; the policy's
    // data too where they fit beside them, else they are read where they lie
    const int use_smem = own + staged <= limit ? 1 : 0;
    const size_t bytes = own + (use_smem ? staged : 0);
    if (bytes > limit) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
        const int rc = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (rc) return rc;
    }
    kernel<<<1, 32 * run_warps<M>(P, half), bytes, stream>>>(
        P, (S*)x, logp, half, n_prop, thin_by, (const S*)u_z, j, (const S*)u_acc, a,
        (X*)chain_x, (L*)chain_lp, n_accept, use_smem);
    return (int)cudaGetLastError();
}

// The run form's launch (stretch_run_kernel) for the model policy M<C> of
// the run's dtypes, as launch_half_step: n_prop proposals of the ensemble
// x (2, half, ndim), half <= LP_RUN_WARPS, the draws (n_prop, 2, half), the
// chain (n_prop / thin_by, 2, half[, ndim]) or null. Returns 0 or a
// cudaError_t code.
template <template <typename> class M>
static int launch_run(const typename M<float>::Params* P, int device, int compute_f64, void* x,
                      int state_f64, double* logp, int half, int n_prop, int thin_by,
                      const void* u_z, const long long* j, const void* u_acc, double a,
                      void* chain_x, int chain_x_f64, void* chain_lp, int chain_lp_f64,
                      int* n_accept, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || n_prop <= 0) return 0;
    if (half > LP_RUN_WARPS || thin_by <= 0 || P->ndim != M<float>::ndim)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 8 + state_f64 * 4 + chain_x_f64 * 2 + chain_lp_f64;
#define LP_RUN_CASE(K, C, S, X, L)                                                            \
    case K:                                                                                   \
        return launch_run_t<M<C>, S, X, L>(*P, x, logp, half, n_prop, thin_by, u_z, j, u_acc,  \
                                           a, chain_x, chain_lp, n_accept, s);
    switch (key) {
        LP_RUN_CASE(0, float, float, float, float)
        LP_RUN_CASE(1, float, float, float, double)
        LP_RUN_CASE(2, float, float, double, float)
        LP_RUN_CASE(3, float, float, double, double)
        LP_RUN_CASE(4, float, double, float, float)
        LP_RUN_CASE(5, float, double, float, double)
        LP_RUN_CASE(6, float, double, double, float)
        LP_RUN_CASE(7, float, double, double, double)
        LP_RUN_CASE(8, double, float, float, float)
        LP_RUN_CASE(9, double, float, float, double)
        LP_RUN_CASE(10, double, float, double, float)
        LP_RUN_CASE(11, double, float, double, double)
        LP_RUN_CASE(12, double, double, float, float)
        LP_RUN_CASE(13, double, double, float, double)
        LP_RUN_CASE(14, double, double, double, float)
        LP_RUN_CASE(15, double, double, double, double)
    }
#undef LP_RUN_CASE
    return (int)cudaErrorInvalidValue;
}
