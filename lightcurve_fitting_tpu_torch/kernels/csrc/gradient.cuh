// The gradient path's kernels, templates over a model policy M of stretch.cuh
// that also provides the warp-cooperative value and gradient of its
// log-posterior (SC2Model in sc2_logpost.cu):
//   static __device__ double value_and_grad(const double* p, const Data&,
//                                           const Params&, double* g);
// called by all 32 lanes of a warp with the same absolute float64 parameters
// p[ndim]; every lane gets the same float64 log-posterior (-inf outside the
// priors or where the likelihood is not finite, and then g = 0) and the same
// raw gradient g[ndim], which may hold NaN where the JAX graph's gradient
// does (the callers mask it where the JAX callers do).
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K7  jax.value_and_grad of the log-posterior: parallel/nuts.py:102,
//       parallel/hmc.py:164, parallel/optimize.py:34, fitting.py:721; with
//       the whitened transform of fitting.py:517-519 (u = mu + L w, the
//       bounds bijection of parallel/hmc.py:54-73 and its log-Jacobian).
//   K7h parallel/hmc.py:241-276 (HMCSampler._transition, vmapped at :308 and
//       :376): one jittered-length leapfrog trajectory and its Metropolis
//       accept per chain.
//   K9  parallel/nuts.py:98-204 (make_nuts_transition, with _leapfrog :54,
//       _subtree_turns :68, _ends_turn :93): one multinomial NUTS transition
//       per chain, tree doublings up to max_depth.
//
// What bounds it on the H100: K7 is FP32 (or FP64) work, the model's value
// and its derivative recurrences over the points (~2x K1's operations); K9
// and K7h are a dependent chain of up to 2^max_depth - 1 and n_leapfrog
// gradient evaluations per chain, so a transition's time is the latency of
// one evaluation times the trajectory length, and only C warps are busy.
// What the design does about it: one warp per walker or chain, its lanes
// striding over the points, then a butterfly shuffle reduction in a fixed
// order (every lane ends with the same bits, so all lanes run the scalar
// part of the sampler redundantly, with no broadcast and no divergence); the
// per-point data staged once per block in shared memory; the whole NUTS
// while-loop in the kernel, the trajectory buffer (Q, P, log w, log p,
// alpha) in shared memory when it fits beside the points, else in a global
// scratch; the subtree U-turn checks and the Gumbel argmax spread over the
// lanes. Draws are inputs, so a kernel's transition equals the plain one's
// under the same draws up to rounding.

#pragma once

#include "stretch.cuh"

#define GRAD_WARPS 4   // walkers (warps) per block of the K7 batch kernel

// The whitened, unbounded space of the gradient samplers: u = mean + L w,
// x = the bounds bijection of u. Every field is 8 bytes wide; the ctypes
// mirror is kernels/gradient.py (_WhiteParams).
struct WhiteParams {
    long long ndim;
    long long kind[LP_MAX_DIM];  // 0 unbounded, 1 two-sided, 2 lower only, 3 upper only
    double lo[LP_MAX_DIM];       // the lower bound (two-sided, lower only)
    double hi[LP_MAX_DIM];       // the upper bound (upper only)
    double width[LP_MAX_DIM];    // hi - lo (two-sided)
    double log_width[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double L[LP_MAX_DIM * LP_MAX_DIM];  // Cholesky factor, row-major ndim x ndim
};

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

// The log-posterior of the whitened space at w[ndim] and its gradient gw,
// as jax.value_and_grad of fitting.py:517-519 followed by the JAX callers'
// mask (non-finite components of gw are 0): the model's raw x-space gradient
// is carried through the chain rule first, so a NaN component reaches the
// components of w it touches, as in the JAX graph. -inf (gw = 0) where the
// value is not finite. All lanes of the warp call it.
template <typename M>
__device__ double white_value_and_grad(const double* w, const typename M::Data& d,
                                       const typename M::Params& P, const WhiteParams& T,
                                       double* gw) {
    const int n = (int)T.ndim;
    double u[LP_MAX_DIM], x[LP_MAX_DIM], dxdu[LP_MAX_DIM], dlj[LP_MAX_DIM];
    double logj = 0.0;
    for (int i = 0; i < n; ++i) {
        double acc = 0.0;
        for (int j = 0; j < n; ++j) acc += T.L[i * n + j] * w[j];
        u[i] = T.mean[i] + acc;
        if (T.kind[i] == 1) {
            const double s = 1.0 / (1.0 + exp(-u[i]));
            x[i] = T.lo[i] + T.width[i] * s;
            dxdu[i] = T.width[i] * (s * (1.0 - s));
            logj += T.log_width[i] + (log(s) + log1p(-s));
            dlj[i] = (1.0 - s) - s;
        } else if (T.kind[i] == 2 || T.kind[i] == 3) {
            const double e = exp(u[i]);
            x[i] = T.kind[i] == 2 ? T.lo[i] + e : T.hi[i] - e;
            dxdu[i] = T.kind[i] == 2 ? e : -e;
            logj += u[i];
            dlj[i] = 1.0;
        } else {
            x[i] = u[i];
            dxdu[i] = 1.0;
            dlj[i] = 0.0;
        }
    }
    double gx[LP_MAX_DIM];
    const double v = M::value_and_grad(x, d, P, gx) + logj;
    if (!(v > -INFINITY) || isnan(v)) {
        for (int j = 0; j < n; ++j) gw[j] = 0.0;
        return -INFINITY;
    }
    for (int j = 0; j < n; ++j) {
        double acc = 0.0;
        for (int i = j; i < n; ++i) acc += T.L[i * n + j] * (gx[i] * dxdu[i] + dlj[i]);
        gw[j] = isfinite(acc) ? acc : 0.0;
    }
    return v;
}

// The value and the masked gradient at p: the whitened space when T is given,
// else the model's own parameters (non-finite components 0; all 0 at -inf).
template <typename M>
__device__ __forceinline__ double masked_value_and_grad(const double* p, const typename M::Data& d,
                                                        const typename M::Params& P,
                                                        const WhiteParams* T, double* g) {
    if (T != nullptr) return white_value_and_grad<M>(p, d, P, *T, g);
    const double v = M::value_and_grad(p, d, P, g);
    for (int k = 0; k < (int)P.ndim; ++k) g[k] = isfinite(g[k]) ? g[k] : 0.0;
    return v;
}

// K7: val[w] and grad[w, :] (float64) at the rows q (W, ndim), one warp per
// row; the whitened space when has_T.
template <typename M>
__global__ void __launch_bounds__(32 * GRAD_WARPS)
logpost_grad_kernel(const typename M::Params P, const WhiteParams T, int has_T,
                    const double* __restrict__ q, int W, double* __restrict__ val,
                    double* __restrict__ grad, int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    const int row = blockIdx.x * GRAD_WARPS + (threadIdx.x >> 5);
    if (row >= W) return;   // whole warps return together, after the staging barrier
    const int ndim = (int)P.ndim;
    double p[LP_MAX_DIM], g[LP_MAX_DIM];
    for (int k = 0; k < ndim; ++k) p[k] = q[(size_t)row * ndim + k];
    const double v = masked_value_and_grad<M>(p, d, P, has_T ? &T : nullptr, g);
    if ((threadIdx.x & 31) == 0) {
        val[row] = v;
        for (int k = 0; k < ndim; ++k) grad[(size_t)row * ndim + k] = g[k];
    }
}

// One leapfrog step (nuts.py:54-65, hmc.py:257-261) in the whitened space,
// in place: kick with the entry gradient g, drift, evaluate, kick with the
// exit gradient, which is left in g. eps carries the direction. Returns the
// new log-posterior.
template <typename M>
__device__ __forceinline__ double leapfrog(double* q, double* p, double* g, double eps,
                                           const double* inv_mass, int n,
                                           const typename M::Data& d,
                                           const typename M::Params& P, const WhiteParams& T) {
    for (int k = 0; k < n; ++k) {
        p[k] = p[k] + (0.5 * eps) * g[k];
        q[k] = q[k] + (eps * inv_mass[k]) * p[k];
    }
    const double lp = white_value_and_grad<M>(q, d, P, T, g);
    for (int k = 0; k < n; ++k) p[k] = p[k] + (0.5 * eps) * g[k];
    return lp;
}

__device__ __forceinline__ double kinetic(const double* p, const double* inv_mass, int n) {
    double s = 0.0;
    for (int k = 0; k < n; ++k) s += (p[k] * p[k]) * inv_mass[k];
    return 0.5 * s;
}

// sum_k V[k] dq[k] < 0 for V = p * inv_mass: the U-turn criterion
__device__ __forceinline__ bool turns(const double* p, const double* dq, const double* inv_mass,
                                      int n) {
    double s = 0.0;
    for (int k = 0; k < n; ++k) s += (p[k] * inv_mass[k]) * dq[k];
    return s < 0.0;
}

// K9: one multinomial NUTS transition of every chain (one warp, one block
// per chain), the body of nuts.py:105-202 with its draws as inputs: z (C,
// ndim) normals for the momentum; u (C, max_depth, max_len + 2) uniforms per
// doubling, [0] the direction (+1 when < 0.5: jr.bernoulli), [1 .. max_len]
// the Gumbel pick, [max_len + 1] the progressive-sampling accept. eps and
// inv_mass are device values (the warmup adapts them between launches). The
// trajectory buffer holds max_len rows of Q, P (ndim each), log w, log p and
// alpha: in shared memory after the staged points when traj_smem, else at
// scratch + chain * max_len * (2 ndim + 3).
template <typename M>
__global__ void __launch_bounds__(32)
nuts_transition_kernel(const typename M::Params P, const WhiteParams T,
                       const double* __restrict__ q_in, const double* __restrict__ logp_in,
                       const double* __restrict__ z, const double* __restrict__ u,
                       const double* __restrict__ eps_ptr, const double* __restrict__ inv_mass_ptr,
                       int max_depth, double* __restrict__ q_out, double* __restrict__ logp_out,
                       double* __restrict__ accept_stat, int* __restrict__ depth_out,
                       int* __restrict__ diverged_out, double* __restrict__ scratch, int use_smem,
                       size_t points_bytes, int traj_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    const int c = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int n = (int)T.ndim;
    const int max_len = max_depth > 1 ? 1 << (max_depth - 1) : 1;
    const int row = 2 * n + 3;
    double* buf = traj_smem ? reinterpret_cast<double*>(smem_raw + points_bytes)
                            : scratch + (size_t)c * max_len * row;
    double* Qb = buf;                             // (max_len, n)
    double* Pb = Qb + (size_t)max_len * n;        // (max_len, n)
    double* lwb = Pb + (size_t)max_len * n;       // (max_len,)
    double* lpb = lwb + max_len;
    double* alb = lpb + max_len;

    const double eps = *eps_ptr;
    double inv_mass[LP_MAX_DIM];
    double q_l[LP_MAX_DIM], p_l[LP_MAX_DIM], q_r[LP_MAX_DIM], p_r[LP_MAX_DIM];
    double q_prop[LP_MAX_DIM];
    for (int k = 0; k < n; ++k) {
        inv_mass[k] = inv_mass_ptr[k];
        q_l[k] = q_r[k] = q_prop[k] = q_in[(size_t)c * n + k];
        p_l[k] = p_r[k] = z[(size_t)c * n + k] / sqrt(inv_mass[k]);
    }
    const double logp0 = logp_in[c];
    const double h0 = -logp0 + kinetic(p_l, inv_mass, n);
    double logp_prop = logp0, logW = 0.0, a_sum = 0.0, a_cnt = 0.0;
    bool turned = false, diverged = false;
    int depth = 0;

    while (depth < max_depth && !(turned || diverged)) {
        const double* ud = u + ((size_t)c * max_depth + depth) * (max_len + 2);
        const double dir = ud[0] < 0.5 ? 1.0 : -1.0;
        const int n_steps = 1 << depth;
        double q[LP_MAX_DIM], p[LP_MAX_DIM], g[LP_MAX_DIM];
        for (int k = 0; k < n; ++k) {
            q[k] = dir > 0.0 ? q_r[k] : q_l[k];
            p[k] = dir > 0.0 ? p_r[k] : p_l[k];
        }
        // one evaluation seeds the subtree; every later step reuses its
        // predecessor's exit gradient (n_steps + 1 evaluations)
        white_value_and_grad<M>(q, d, P, T, g);
        bool div_new = false;
        for (int i = 0; i < n_steps; ++i) {
            const double lp = leapfrog<M>(q, p, g, dir * eps, inv_mass, n, d, P, T);
            double h = -lp + kinetic(p, inv_mass, n);
            if (isnan(h)) h = INFINITY;
            const double lw = h0 - h;
            div_new = div_new || lw < -1000.0;
            if (lane == 0) {
                for (int k = 0; k < n; ++k) {
                    Qb[(size_t)i * n + k] = q[k];
                    Pb[(size_t)i * n + k] = p[k];
                }
                lwb[i] = lw;
                lpb[i] = lp;
                alb[i] = fmin(1.0, exp(lw));
            }
        }
        __syncwarp();
        // U-turns inside the subtree: the endpoints of every aligned
        // power-of-two block (nuts.py:68-90), blocks spread over the lanes
        bool bad = false;
        for (int size = 2; size <= n_steps; size <<= 1) {
            for (int b = lane; b < n_steps / size; b += 32) {
                const int s = b * size, e = s + size - 1;
                double dq[LP_MAX_DIM], vs[LP_MAX_DIM], ve[LP_MAX_DIM];
                for (int k = 0; k < n; ++k) {
                    dq[k] = dir * (Qb[(size_t)e * n + k] - Qb[(size_t)s * n + k]);
                    vs[k] = Pb[(size_t)s * n + k];
                    ve[k] = Pb[(size_t)e * n + k];
                }
                bad = bad || turns(vs, dq, inv_mass, n) || turns(ve, dq, inv_mass, n);
            }
        }
        bad = __any_sync(0xffffffffu, bad) || div_new;
        // log W of the subtree, its Gumbel-argmax pick (the first index wins
        // a tie, as jnp.argmax) and its alpha sum
        double m = -INFINITY, best = -INFINITY, a_part = 0.0;
        int pick = 0x7fffffff;
        for (int i = lane; i < n_steps; i += 32) {
            m = fmax(m, lwb[i]);
            const double key = lwb[i] + (-log(-log(ud[1 + i])));
            if (key > best || (key == best && i < pick)) {
                best = key;
                pick = i;
            }
            a_part += alb[i];
        }
        m = warp_max(m);
        const double shift = isfinite(m) ? m : 0.0;
        double se = 0.0;
        for (int i = lane; i < n_steps; i += 32) se += exp(lwb[i] - shift);
        const double logW_new = log(warp_sum(se)) + shift;
        for (int o = 16; o > 0; o >>= 1) {
            const double ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oi = __shfl_xor_sync(0xffffffffu, pick, o);
            if (ob > best || (ob == best && oi < pick)) {
                best = ob;
                pick = oi;
            }
        }
        const double alpha_sum = warp_sum(a_part);
        // biased progressive sampling: the subtree's pick with probability
        // min(1, W_new / W_old)
        if (!bad && log(ud[max_len + 1]) < logW_new - logW) {
            for (int k = 0; k < n; ++k) q_prop[k] = Qb[(size_t)pick * n + k];
            logp_prop = lpb[pick];
        }
        if (!bad) {   // a bad subtree ends the growth without being merged
            for (int k = 0; k < n; ++k) {
                if (dir > 0.0) {
                    q_r[k] = q[k];
                    p_r[k] = p[k];
                } else {
                    q_l[k] = q[k];
                    p_l[k] = p[k];
                }
            }
            const double hi = fmax(logW, logW_new);
            logW = hi + log1p(exp(-fabs(logW - logW_new)));
            double dq[LP_MAX_DIM];
            for (int k = 0; k < n; ++k) dq[k] = q_r[k] - q_l[k];
            turned = turns(p_l, dq, inv_mass, n) || turns(p_r, dq, inv_mass, n);
        } else {
            turned = true;
        }
        diverged = diverged || div_new;
        depth += 1;
        a_sum += alpha_sum;
        a_cnt += (double)n_steps;
        __syncwarp();   // the buffer is rewritten by the next doubling
    }
    if (lane == 0) {
        for (int k = 0; k < n; ++k) q_out[(size_t)c * n + k] = q_prop[k];
        logp_out[c] = logp_prop;
        accept_stat[c] = a_sum / fmax(a_cnt, 1.0);
        depth_out[c] = depth;
        diverged_out[c] = diverged ? 1 : 0;
    }
}

// K7h: one HMC transition of every chain (one warp per chain), hmc.py:241-276
// with its draws as inputs: z (C, ndim) normals, u_acc (C,) the accept
// uniform, n_used (C,) the trajectory length in [(L + 1) / 2, L]; the steps
// past n_used of the JAX scan are identity and are not run.
template <typename M>
__global__ void __launch_bounds__(32)
hmc_transition_kernel(const typename M::Params P, const WhiteParams T,
                      const double* __restrict__ q_in, const double* __restrict__ logp_in,
                      const double* __restrict__ z, const double* __restrict__ u_acc,
                      const long long* __restrict__ n_used, const double* __restrict__ eps_ptr,
                      const double* __restrict__ inv_mass_ptr, double* __restrict__ q_out,
                      double* __restrict__ logp_out, double* __restrict__ accept_prob,
                      int use_smem) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, use_smem, 0);
    const int c = blockIdx.x;
    const int n = (int)T.ndim;
    const double eps = *eps_ptr;
    double inv_mass[LP_MAX_DIM], x[LP_MAX_DIM], p0[LP_MAX_DIM], q[LP_MAX_DIM], p[LP_MAX_DIM];
    double g[LP_MAX_DIM];
    for (int k = 0; k < n; ++k) {
        inv_mass[k] = inv_mass_ptr[k];
        x[k] = q[k] = q_in[(size_t)c * n + k];
        p0[k] = p[k] = z[(size_t)c * n + k] / sqrt(inv_mass[k]);
    }
    const double logp0 = logp_in[c];
    white_value_and_grad<M>(q, d, P, T, g);
    double logp_new = logp0;
    const long long steps = n_used[c];
    for (long long i = 0; i < steps; ++i) logp_new = leapfrog<M>(q, p, g, eps, inv_mass, n, d, P, T);
    const double h0 = logp0 - kinetic(p0, inv_mass, n);
    const double h1 = logp_new - kinetic(p, inv_mass, n);
    const double log_accept = isfinite(h1) ? h1 - h0 : -INFINITY;
    const bool accept = log(u_acc[c]) < log_accept;
    if ((threadIdx.x & 31) == 0) {
        for (int k = 0; k < n; ++k) q_out[(size_t)c * n + k] = accept ? q[k] : x[k];
        logp_out[c] = accept ? logp_new : logp0;
        accept_prob[c] = fmin(1.0, exp(fmin(log_accept, 0.0)));
    }
}

// ------------------------------------------------------------------ launch

template <typename M>
static int launch_logpost_grad(const typename M::Params& P, const WhiteParams* T,
                               const double* q, int W, double* val, double* grad,
                               cudaStream_t stream) {
    auto kernel = logpost_grad_kernel<M>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    WhiteParams none;
    none.ndim = 0;
    const int blocks = (W + GRAD_WARPS - 1) / GRAD_WARPS;
    kernel<<<blocks, 32 * GRAD_WARPS, use_smem ? bytes : 0, stream>>>(
        P, T ? *T : none, T != nullptr, q, W, val, grad, use_smem);
    return (int)cudaGetLastError();
}

// K9's shared memory: the points and the trajectory buffer when both fit,
// else the points alone (the buffer in scratch), else neither. Returns the
// trajectory buffer's length in doubles per chain.
template <typename M>
static size_t nuts_plan(const typename M::Params& P, int ndim, int max_depth, int* use_smem,
                        int* traj_smem, size_t* points) {
    const size_t max_len = max_depth > 1 ? (size_t)1 << (max_depth - 1) : 1;
    const size_t traj = max_len * (size_t)(2 * ndim + 3);
    const size_t limit = (size_t)smem_optin_limit();
    *points = (M::stage_bytes(P) + 15) / 16 * 16;
    *use_smem = *points <= limit;
    *traj_smem = *points + sizeof(double) * traj <= limit;
    return traj;
}

// The float64 scratch (in doubles) that K9 over C chains needs: 0 when the
// trajectory buffer fits in shared memory beside the points.
template <typename M>
static long long nuts_scratch_len(const typename M::Params& P, int ndim, int max_depth, int C) {
    int use_smem = 0, traj_smem = 0;
    size_t points = 0;
    const size_t traj = nuts_plan<M>(P, ndim, max_depth, &use_smem, &traj_smem, &points);
    return traj_smem ? 0 : (long long)(traj * (size_t)C);
}

template <typename M>
static int launch_nuts(const typename M::Params& P, const WhiteParams& T, const double* q,
                       const double* logp, const double* z, const double* u, const double* eps,
                       const double* inv_mass, int max_depth, int C, double* q_out,
                       double* logp_out, double* accept_stat, int* depth, int* diverged,
                       double* scratch, cudaStream_t stream) {
    auto kernel = nuts_transition_kernel<M>;
    int use_smem = 0, traj_smem = 0;
    size_t points = 0;
    const size_t traj = sizeof(double)
        * nuts_plan<M>(P, (int)T.ndim, max_depth, &use_smem, &traj_smem, &points);
    if (!traj_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const size_t bytes = (use_smem ? points : 0) + (traj_smem ? traj : 0);
    if (bytes > 48 * 1024) {
        int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
        if (rc) return rc;
    }
    kernel<<<C, 32, bytes, stream>>>(P, T, q, logp, z, u, eps, inv_mass, max_depth, q_out,
                                     logp_out, accept_stat, depth, diverged, scratch, use_smem,
                                     use_smem ? points : 0, traj_smem);
    return (int)cudaGetLastError();
}

template <typename M>
static int launch_hmc(const typename M::Params& P, const WhiteParams& T, const double* q,
                      const double* logp, const double* z, const double* u_acc,
                      const long long* n_used, const double* eps, const double* inv_mass, int C,
                      double* q_out, double* logp_out, double* accept_prob,
                      cudaStream_t stream) {
    auto kernel = hmc_transition_kernel<M>;
    int use_smem = 0;
    const size_t bytes = M::stage_bytes(P);
    int rc = smem_plan(kernel, bytes, &use_smem);
    if (rc) return rc;
    kernel<<<C, 32, use_smem ? bytes : 0, stream>>>(P, T, q, logp, z, u_acc, n_used, eps,
                                                    inv_mass, q_out, logp_out, accept_prob,
                                                    use_smem);
    return (int)cudaGetLastError();
}
