// Pieces shared by the fused log-posterior kernels of csrc/*.cu: device math
// overloads, the priors, the Gaussian residual, and the stretch-move
// half-step (K2) and the batch log-posterior as templates over a model
// policy.
//
// A model policy M (SC2Model in sc2_logpost.cu, SC3Model in sc3_logpost.cu,
// EpochBBModel in epoch_bb.cu, CSModel in companion.cu) provides
//   typedef ... Params;  // the model's parameter block (8-byte fields)
//   typedef ... Data;    // the per-point data as the kernel reads it
//   static size_t stage_bytes(const Params&);             // host and device
//   static __device__ Data stage(const Params&, unsigned char* smem, int use_smem, int e);
// where e is the ensemble (epoch) of the block: always 0 for a single
// ensemble, whose data do not depend on it. A policy whose tempered
// half-step runs a thread per walker (ladder.cuh, SC3Model) provides
//   static __device__ double log_likelihood(const double* p, const Data&, const Params&);
// the float64 log-likelihood alone (-inf when not finite). A policy whose
// kernels run a warp per walker (stretch_half_step_kernel: SC2WarpModel,
// SC3WarpModel, CSWarpModel, EpochBBModel; tempered_half_step_kernel with
// WARP: SC2WarpModel, CSWarpModel; the batch log-posterior
// logpost_warp_kernel: SC2WarpModel, SC3WarpModel, CSWarpModel,
// EpochBBModel; the ladder's initial state ladder_init_kernel:
// SC2WarpModel, SC3WarpModel, CSWarpModel) provides
//   typedef ... Walker;  // a walker's constants (32-bit words, copied by value)
//   static __device__ Walker walker(const double* p, const Params&);
//   static __device__ double log_likelihood_warp(const Walker&, const Data&, const Params&);
//   static constexpr int warps_per_block;  // the warps a block
//   static constexpr bool batched;         // warps take batches of walkers (warp_batch_ll)
// where log_likelihood_warp is computed by the 32 lanes of a warp together,
// every lane returning the same bits, and may provide
//   static constexpr int ndim;  // the walker's dimension at compile time (policy_dim)
// which keeps the walker's state in registers.
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
    const S lz = (S)(ndim - 1) * m_log(z);
    const double log_ratio = (double)lz + lp_y - lp_x;
    // log(0) = -inf accepts unless log_ratio is -inf; a NaN ratio rejects
    const double log_u = (double)m_log(u_acc[di]);
    const bool accept = !isnan(log_ratio) && log_u < log_ratio;
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
        lprior = log_prior<D>(P, p);
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
__global__ void __launch_bounds__(block_limit<M>::value)
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
        lprior = log_prior<D>(P, p);
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

// The WarpLayout of a warp-per-walker kernel over n walkers for the policy
// M. Not batched: M::warps_per_block warps a block (fewer for a small n), a
// walker a warp, a block for every warps_per_block walkers. Batched: a
// small launch spread over the SMs (no more warps a block than ceil(n /
// SMs), but 8 at least: a block stages the tables with its own threads, and
// 32 take ~3x as long), and batches of ceil(n / W) walkers (at most 32), W
// the warps the card holds at once, so that every batch runs in one wave
// and a walker's prologue (proposal, prior, constants) runs on a lane of
// its own. The card's resident blocks come from the kernel's occupancy at
// the block size and shared memory, times the SMs (read once per kernel,
// block size and shared memory, and kept).
template <typename M, typename Kernel>
static WarpLayout warp_layout(Kernel kernel, long long n, size_t smem) {
    static_assert(32 * M::warps_per_block <= 1024, "block too large");
    WarpLayout L;
    int per_block = M::warps_per_block;
    L.batch = 1;
    if (M::batched) {
        static const void* key_fn = nullptr;
        static int key_dev = -1, key_threads = 0, sms = 1, resident = 1;
        static size_t key_smem = 0;
        int dev = 0;
        cudaGetDevice(&dev);
        if (dev != key_dev) {
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (sms < 1) sms = 1;
            key_fn = nullptr;
        }
        const long long spread = (n + sms - 1) / sms;
        const int fewest = per_block < 8 ? per_block : 8;
        if (spread < per_block) per_block = spread > fewest ? (int)spread : fewest;
        L.threads = 32 * per_block;
        if ((const void*)kernel != key_fn || dev != key_dev || L.threads != key_threads
            || smem != key_smem) {
            int per_sm = 0;
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L.threads, smem);
            resident = sms * (per_sm > 0 ? per_sm : 1);
            key_fn = (const void*)kernel, key_dev = dev, key_threads = L.threads;
            key_smem = smem;
        }
        const long long warps = (long long)resident * per_block;
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

// The half-step launch for the model policy M<C> of the run's dtypes: the
// compute type C, the walker state S, the chain's state X and log-posterior
// L, each float or double; n_ens ensembles (draw_stride apart in the draws),
// 1 and 0 for a single one. Returns 0 or a cudaError_t code.
template <template <typename> class M>
static int launch_half_step(const typename M<float>::Params* P, int device, int compute_f64,
                            void* x, int state_f64, double* logp, int half, int h,
                            const void* u_z, const long long* j, const void* u_acc, double a,
                            void* chain_x, int chain_x_f64, void* chain_lp, int chain_lp_f64,
                            int* n_accept, void* stream, int n_ens = 1,
                            long long draw_stride = 0) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || n_ens <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || n_ens > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int key = compute_f64 * 8 + state_f64 * 4 + chain_x_f64 * 2 + chain_lp_f64;
#define LP_HALF_CASE(K, C, S, X, L)                                                      \
    case K:                                                                              \
        return launch_half<M<C>, S, X, L>(*P, x, logp, half, h, u_z, j, u_acc, a, chain_x,  \
                                          chain_lp, n_accept, n_ens, draw_stride, s);
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

// The batch log-posterior launch (logpost_warp_kernel) for the warp policy
// M<C> of the compute type C and the state's type, each float or double,
// over n_ens ensembles of W walkers. Returns 0 or a cudaError_t code.
template <template <typename> class M>
static int launch_logpost(const typename M<float>::Params* P, int device, int compute_f64,
                          const void* q, int q_f64, int W, double* out, void* stream,
                          int n_ens = 1) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || n_ens <= 0) return 0;
    if (P->ndim > LP_MAX_DIM || n_ens > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (compute_f64)
        return q_f64 ? launch_logpost_warp<M<double>, double>(*P, q, W, n_ens, out, s)
                     : launch_logpost_warp<M<double>, float>(*P, q, W, n_ens, out, s);
    return q_f64 ? launch_logpost_warp<M<float>, double>(*P, q, W, n_ens, out, s)
                 : launch_logpost_warp<M<float>, float>(*P, q, W, n_ens, out, s);
}
