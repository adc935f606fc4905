// The gradient path's kernels, templates over a model policy M of stretch.cuh
// that also provides the value and gradient of its log-posterior in two
// cooperative forms (SC2Model in sc2_logpost.cu):
//   static __device__ double value_and_grad(const double* p, const Data&,
//                                           const Params&, double* g);
// the warp form, called by all 32 lanes of a warp with the same absolute
// float64 parameters p[ndim]; and
//   template <int NDIM> static __device__ double value_and_grad_block(
//       const double* p, const Data&, const Params&, double* g, void* ws, int& turn);
//   static size_t block_ws_bytes(const Params&);   // host and device
// the block form, called by every thread of a block, with a workspace of
// block_ws_bytes. Every caller gets the same float64 log-posterior (-inf
// outside the priors or where the likelihood is not finite, and then g = 0)
// and the same raw gradient g[ndim], which may hold NaN where the JAX
// graph's gradient does (the callers mask it where the JAX callers do); the
// two forms give the same bits.
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
// and its derivative recurrences over the points (~2x K1's operations): a
// warp per walker, its lanes striding over the points, then a butterfly
// shuffle reduction in a fixed order, the per-point data staged once per
// block in shared memory. K9 and K7h are a dependent chain of up to
// 2^max_depth - 1 and n_leapfrog gradient evaluations per chain, so a
// transition's time is the latency of one evaluation times the trajectory
// length (the operations bound is ~1e-3 of it at 16 chains).
// What the design does about it: K9, K7h and K7 at small widths run a block
// per chain (or row) and one point per thread (ceil(N / 32) warps: 5 for the
// flagship's 149 points, at most BLOCK_MAX_WARPS), so an evaluation's
// latency is one point's, not a lane's five in a row; the points' factors
// are folded in the warp form's order (sc2_logpost.cu), so the block form's
// evaluations are the warp form's bit for bit. ndim is a template parameter
// (4, or 5 with the intrinsic scatter): the chain's state, the whitening and
// the prior gradient live in registers, with no stack frame. Every thread
// runs the sampler's scalar part (kicks, drift, energies, the accept test;
// K9's U-turns and progressive sampling) on the same values, so no state is
// broadcast and an evaluation costs one barrier. block_plan places the
// staged points, the reduction slots and the model's block workspace in
// shared memory (the workspace in a global scratch where it does not fit).
// K9 runs its whole while-loop in the kernel; its trajectory buffer (Q, P,
// log w, log p) lies in shared memory when it fits beside the rest, else in
// the scratch; the subtree U-turn checks, the Gumbel argmax, the
// log-sum-exp and the accept statistic's exp are spread over the block.
// Draws are inputs, so a kernel's transition equals the plain one's under
// the same draws up to rounding. K7 keeps the warp form (a warp per row,
// GRAD_WARPS rows a block) where the rows fill the card; the wrapper picks
// the form from the width and the SM count (kernels/gradient.py::k7_form).

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

// The log-posterior of the whitened space at w[n] and its gradient gw, as
// jax.value_and_grad of fitting.py:517-519 followed by the JAX callers' mask
// (non-finite components of gw are 0): the model's raw x-space gradient is
// carried through the chain rule first, so a NaN component reaches the
// components of w it touches, as in the JAX graph. -inf (gw = 0) where the
// value is not finite. eval(x, gx) is the model's value and raw gradient
// (the warp or the block form), called by every thread that runs this. N is
// the dimension when it is known at compile time (then the state lives in
// registers and the loops unroll), else 0 and n = T.ndim.
template <int N, typename Eval>
__device__ __forceinline__ double white_value_and_grad(const double* w, const WhiteParams& T,
                                                       double* gw, Eval eval) {
    constexpr int D = N > 0 ? N : LP_MAX_DIM;
    const int n = N > 0 ? N : (int)T.ndim;
    double u[D], x[D], dxdu[D], dlj[D];
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
    double gx[D];
    const double v = eval(x, gx) + logj;
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

// K7's warp form: val[w] and grad[w, :] (float64) at the rows q (W, ndim),
// one warp per row; the whitened space when has_T, else the model's own
// parameters (non-finite components 0; all 0 at -inf). The block form,
// logpost_grad_block_kernel below, computes the same bits.
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
    auto eval = [&](const double* x, double* gx) { return M::value_and_grad(x, d, P, gx); };
    double v;
    if (has_T) {
        v = white_value_and_grad<0>(p, T, g, eval);
    } else {
        v = eval(p, g);
        for (int k = 0; k < ndim; ++k) g[k] = isfinite(g[k]) ? g[k] : 0.0;
    }
    if ((threadIdx.x & 31) == 0) {
        val[row] = v;
        for (int k = 0; k < ndim; ++k) grad[(size_t)row * ndim + k] = g[k];
    }
}

// One leapfrog step (hmc.py:257-261) in the whitened space of dimension N,
// in place: kick with the entry gradient g, drift, evaluate, kick with the
// exit gradient, which is left in g. Returns the new log-posterior.
template <int N, typename Eval>
__device__ __forceinline__ double leapfrog(double* q, double* p, double* g, double eps,
                                           const double* inv_mass, const WhiteParams& T,
                                           Eval eval) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        p[k] = p[k] + (0.5 * eps) * g[k];
        q[k] = q[k] + (eps * inv_mass[k]) * p[k];
    }
    const double lp = white_value_and_grad<N>(q, T, g, eval);
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = p[k] + (0.5 * eps) * g[k];
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

// The shared memory of a kernel that runs the model's block form (a block per
// chain or row: K9, K7h, K7's block form), in bytes from the start of the
// dynamic allocation, and its global scratch, in doubles per block
// (block_plan).
struct BlockLayout {
    int threads;        // of the block: a warp for every 32 points, at most BLOCK_MAX_WARPS
    int use_smem;       // the staged points at 0 (else read from global memory)
    int ws_smem;        // the model's block workspace at ws_off (else in scratch at 0)
    long long red_off;  // the kernel's doubles for its block reductions
    long long ws_off;
    long long smem;     // bytes of dynamic shared memory
    long long scratch;  // doubles of global scratch per block
};

// K9's: the block's, then its trajectory buffer (nuts_plan).
struct NutsLayout : BlockLayout {
    int traj_smem;      // the trajectory buffer at traj_off (else in scratch at traj_scratch)
    long long traj_off;
    long long traj_scratch;
};

#define BLOCK_MAX_WARPS 8                 // 256 threads: the chain's state keeps its registers
#define NUTS_RED (5 * BLOCK_MAX_WARPS)    // per warp: max, best key, pick, alpha sum, exp sum

// The model's workspace of the block form: in shared memory at Lay.ws_off, or
// in block b's part of the global scratch.
__device__ __forceinline__ void* block_workspace(unsigned char* smem_raw, const BlockLayout& Lay,
                                                 double* scratch, int b) {
    return Lay.ws_smem ? static_cast<void*>(smem_raw + Lay.ws_off)
                       : static_cast<void*>(scratch + (size_t)b * Lay.scratch);
}

// K7's block form: val[r] and grad[r, :] as logpost_grad_kernel computes them,
// at the rows q (W, N), one block per row (Lay.threads threads, a point a
// thread), for the widths at which a warp per row leaves most of the card
// idle. Every thread computes the same bits (the block form's), the warp
// form's for the same row; thread 0 writes them.
template <typename M, int N>
__global__ void __launch_bounds__(32 * BLOCK_MAX_WARPS, 1)
logpost_grad_block_kernel(const typename M::Params P, const WhiteParams T, int has_T,
                          const double* __restrict__ q, double* __restrict__ val,
                          double* __restrict__ grad, double* __restrict__ scratch,
                          const BlockLayout Lay) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, Lay.use_smem, 0);
    const int row = blockIdx.x;
    void* ws = block_workspace(smem_raw, Lay, scratch, row);
    int turn = 0;
    auto eval = [&](const double* x, double* gx) {
        return M::template value_and_grad_block<N>(x, d, P, gx, ws, turn);
    };
    double p[N], g[N];
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = q[(size_t)row * N + k];
    double v;
    if (has_T) {
        v = white_value_and_grad<N>(p, T, g, eval);
    } else {
        v = eval(p, g);
#pragma unroll
        for (int k = 0; k < N; ++k) g[k] = isfinite(g[k]) ? g[k] : 0.0;
    }
    if (threadIdx.x == 0) {
        val[row] = v;
#pragma unroll
        for (int k = 0; k < N; ++k) grad[(size_t)row * N + k] = g[k];
    }
}

// K9: one multinomial NUTS transition of every chain (one block per chain,
// Lay.threads threads), the body of nuts.py:105-202 with its draws as inputs:
// z (C, N) normals for the momentum; u (C, max_depth, max_len + 2) uniforms
// per doubling, [0] the direction (+1 when < 0.5: jr.bernoulli), [1 ..
// max_len] the Gumbel pick, [max_len + 1] the progressive-sampling accept.
// eps and inv_mass are device values (the warmup adapts them between
// launches). Every thread runs the sampler's scalar part on the same values
// (the model's block form gives every thread the same bits), so the state
// needs no broadcast; thread 0 writes the trajectory buffer, max_len rows of
// Q, P (N each), log w and log p, whose U-turn blocks, Gumbel argmax,
// log-sum-exp and alpha sum are then spread over the block and combined in
// a fixed order (warp butterflies, then the warps in order).
template <typename M, int N>
__global__ void __launch_bounds__(32 * BLOCK_MAX_WARPS, 1)
nuts_transition_kernel(const typename M::Params P, const WhiteParams T,
                       const double* __restrict__ q_in, const double* __restrict__ logp_in,
                       const double* __restrict__ z, const double* __restrict__ u,
                       const double* __restrict__ eps_ptr, const double* __restrict__ inv_mass_ptr,
                       int max_depth, double* __restrict__ q_out, double* __restrict__ logp_out,
                       double* __restrict__ accept_stat, int* __restrict__ depth_out,
                       int* __restrict__ diverged_out, double* __restrict__ scratch,
                       const NutsLayout Lay) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, Lay.use_smem, 0);
    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
    const int max_len = max_depth > 1 ? 1 << (max_depth - 1) : 1;
    double* cs = scratch != nullptr ? scratch + (size_t)c * Lay.scratch : nullptr;
    double* Qb = Lay.traj_smem ? reinterpret_cast<double*>(smem_raw + Lay.traj_off)
                               : cs + Lay.traj_scratch;   // (max_len, N)
    double* Pb = Qb + (size_t)max_len * N;                // (max_len, N)
    double* lwb = Pb + (size_t)max_len * N;               // (max_len,)
    double* lpb = lwb + max_len;
    double* red = reinterpret_cast<double*>(smem_raw + Lay.red_off);
    void* ws = block_workspace(smem_raw, Lay, scratch, c);
    int turn = 0;
    auto eval = [&](const double* x, double* gx) {
        return M::template value_and_grad_block<N>(x, d, P, gx, ws, turn);
    };

    const double eps = *eps_ptr;
    double inv_mass[N], q_l[N], p_l[N], q_r[N], p_r[N], q_prop[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        inv_mass[k] = inv_mass_ptr[k];
        q_l[k] = q_r[k] = q_prop[k] = q_in[(size_t)c * N + k];
        p_l[k] = p_r[k] = z[(size_t)c * N + k] / sqrt(inv_mass[k]);
    }
    const double logp0 = logp_in[c];
    const double h0 = -logp0 + kinetic(p_l, inv_mass, N);
    double logp_prop = logp0, logW = 0.0, a_sum = 0.0, a_cnt = 0.0;
    bool turned = false, diverged = false;
    int depth = 0;

    while (depth < max_depth && !(turned || diverged)) {
        const double* ud = u + ((size_t)c * max_depth + depth) * (max_len + 2);
        const double dir = ud[0] < 0.5 ? 1.0 : -1.0;
        const int n_steps = 1 << depth;
        double q[N], p[N], g[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
            q[k] = dir > 0.0 ? q_r[k] : q_l[k];
            p[k] = dir > 0.0 ? p_r[k] : p_l[k];
        }
        // one evaluation seeds the subtree (i = -1), every later step is a
        // leapfrog (nuts.py:54-65) that reuses its predecessor's exit
        // gradient: n_steps + 1 evaluations from one call site
        const double e = dir * eps;
        bool div_new = false;
        for (int i = -1; i < n_steps; ++i) {
            if (i >= 0) {
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    p[k] = p[k] + (0.5 * e) * g[k];
                    q[k] = q[k] + (e * inv_mass[k]) * p[k];
                }
            }
            const double lp = white_value_and_grad<N>(q, T, g, eval);
            if (i < 0) continue;
#pragma unroll
            for (int k = 0; k < N; ++k) p[k] = p[k] + (0.5 * e) * g[k];
            double h = -lp + kinetic(p, inv_mass, N);
            if (isnan(h)) h = INFINITY;
            const double lw = h0 - h;
            div_new = div_new || lw < -1000.0;
            if (tid == 0) {
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    Qb[(size_t)i * N + k] = q[k];
                    Pb[(size_t)i * N + k] = p[k];
                }
                lwb[i] = lw;
                lpb[i] = lp;
            }
        }
        __syncthreads();
        // U-turns inside the subtree: the endpoints of every aligned
        // power-of-two block (nuts.py:68-90); with them this thread's part of
        // the subtree's max log w, its Gumbel-argmax pick (the first index
        // wins a tie, as jnp.argmax) and its alpha sum
        bool bad = false;
        for (int size = 2; size <= n_steps; size <<= 1) {
            for (int b = tid; b < n_steps / size; b += blockDim.x) {
                const int s = b * size, e = s + size - 1;
                double dq[N], vs[N], ve[N];
#pragma unroll
                for (int k = 0; k < N; ++k) {
                    dq[k] = dir * (Qb[(size_t)e * N + k] - Qb[(size_t)s * N + k]);
                    vs[k] = Pb[(size_t)s * N + k];
                    ve[k] = Pb[(size_t)e * N + k];
                }
                bad = bad || turns(vs, dq, inv_mass, N) || turns(ve, dq, inv_mass, N);
            }
        }
        double m = -INFINITY, best = -INFINITY, a_part = 0.0;
        int pick = 0x7fffffff;
        for (int i = tid; i < n_steps; i += blockDim.x) {
            m = fmax(m, lwb[i]);
            const double key = lwb[i] + (-log(-log(ud[1 + i])));
            if (key > best || (key == best && i < pick)) {
                best = key;
                pick = i;
            }
            a_part += fmin(1.0, exp(lwb[i]));
        }
        m = warp_max(m);
        for (int o = 16; o > 0; o >>= 1) {
            const double ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oi = __shfl_xor_sync(0xffffffffu, pick, o);
            if (ob > best || (ob == best && oi < pick)) {
                best = ob;
                pick = oi;
            }
        }
        a_part = warp_sum(a_part);
        if (lane == 0) {
            red[warp] = m;
            red[BLOCK_MAX_WARPS + warp] = best;
            red[2 * BLOCK_MAX_WARPS + warp] = (double)pick;
            red[3 * BLOCK_MAX_WARPS + warp] = a_part;
        }
        bad = __syncthreads_or(bad) || div_new;
        m = red[0];
        best = red[BLOCK_MAX_WARPS];
        pick = (int)red[2 * BLOCK_MAX_WARPS];
        double alpha_sum = red[3 * BLOCK_MAX_WARPS];
        for (int w = 1; w < nw; ++w) {
            m = fmax(m, red[w]);
            const double ob = red[BLOCK_MAX_WARPS + w];
            const int oi = (int)red[2 * BLOCK_MAX_WARPS + w];
            if (ob > best || (ob == best && oi < pick)) {
                best = ob;
                pick = oi;
            }
            alpha_sum += red[3 * BLOCK_MAX_WARPS + w];
        }
        // log W of the subtree
        const double shift = isfinite(m) ? m : 0.0;
        double se = 0.0;
        for (int i = tid; i < n_steps; i += blockDim.x) se += exp(lwb[i] - shift);
        se = warp_sum(se);
        if (lane == 0) red[4 * BLOCK_MAX_WARPS + warp] = se;
        __syncthreads();
        se = red[4 * BLOCK_MAX_WARPS];
        for (int w = 1; w < nw; ++w) se += red[4 * BLOCK_MAX_WARPS + w];
        const double logW_new = log(se) + shift;
        // biased progressive sampling: the subtree's pick with probability
        // min(1, W_new / W_old)
        if (!bad && log(ud[max_len + 1]) < logW_new - logW) {
#pragma unroll
            for (int k = 0; k < N; ++k) q_prop[k] = Qb[(size_t)pick * N + k];
            logp_prop = lpb[pick];
        }
        if (!bad) {   // a bad subtree ends the growth without being merged
#pragma unroll
            for (int k = 0; k < N; ++k) {
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
            double dq[N];
#pragma unroll
            for (int k = 0; k < N; ++k) dq[k] = q_r[k] - q_l[k];
            turned = turns(p_l, dq, inv_mass, N) || turns(p_r, dq, inv_mass, N);
        } else {
            turned = true;
        }
        diverged = diverged || div_new;
        depth += 1;
        a_sum += alpha_sum;
        a_cnt += (double)n_steps;
        __syncthreads();   // the buffer and red are rewritten by the next doubling
    }
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) q_out[(size_t)c * N + k] = q_prop[k];
        logp_out[c] = logp_prop;
        accept_stat[c] = a_sum / fmax(a_cnt, 1.0);
        depth_out[c] = depth;
        diverged_out[c] = diverged ? 1 : 0;
    }
}

// K7h: one HMC transition of every chain (one block per chain, Lay.threads
// threads, a point a thread in each evaluation), hmc.py:241-276 with its
// draws as inputs: z (C, N) normals, u_acc (C,) the accept uniform, n_used
// (C,) the trajectory length in [(L + 1) / 2, L]; the steps past n_used of
// the JAX scan are identity and are not run. Every thread runs the leapfrog
// and the accept test on the same values (the block form gives every thread
// the same bits); thread 0 writes the outputs.
template <typename M, int N>
__global__ void __launch_bounds__(32 * BLOCK_MAX_WARPS)
hmc_transition_kernel(const typename M::Params P, const WhiteParams T,
                      const double* __restrict__ q_in, const double* __restrict__ logp_in,
                      const double* __restrict__ z, const double* __restrict__ u_acc,
                      const long long* __restrict__ n_used, const double* __restrict__ eps_ptr,
                      const double* __restrict__ inv_mass_ptr, double* __restrict__ q_out,
                      double* __restrict__ logp_out, double* __restrict__ accept_prob,
                      double* __restrict__ scratch, const BlockLayout Lay) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const typename M::Data d = M::stage(P, smem_raw, Lay.use_smem, 0);
    const int c = blockIdx.x;
    void* ws = block_workspace(smem_raw, Lay, scratch, c);
    int turn = 0;
    auto eval = [&](const double* x, double* gx) {
        return M::template value_and_grad_block<N>(x, d, P, gx, ws, turn);
    };
    const double eps = *eps_ptr;
    double inv_mass[N], x[N], p0[N], q[N], p[N], g[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        inv_mass[k] = inv_mass_ptr[k];
        x[k] = q[k] = q_in[(size_t)c * N + k];
        p0[k] = p[k] = z[(size_t)c * N + k] / sqrt(inv_mass[k]);
    }
    const double logp0 = logp_in[c];
    white_value_and_grad<N>(q, T, g, eval);
    double logp_new = logp0;
    const long long steps = n_used[c];
    for (long long i = 0; i < steps; ++i) logp_new = leapfrog<N>(q, p, g, eps, inv_mass, T, eval);
    const double h0 = logp0 - kinetic(p0, inv_mass, N);
    const double h1 = logp_new - kinetic(p, inv_mass, N);
    const double log_accept = isfinite(h1) ? h1 - h0 : -INFINITY;
    const bool accept = log(u_acc[c]) < log_accept;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) q_out[(size_t)c * N + k] = accept ? q[k] : x[k];
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

// The plan of a block over the model's points (a warp for every 32 points,
// at most BLOCK_MAX_WARPS) and its memory, for a kernel that reduces over
// red_doubles doubles of shared memory. Shared memory holds the staged
// points, then the reduction slots and the model's block workspace, each
// where it still fits under the card's limit, in that order; what does not
// fit lies in global memory (the points where the model keeps them, the
// workspace in a scratch of BlockLayout.scratch doubles per block).
template <typename M>
static BlockLayout block_plan(const typename M::Params& P, long long red_doubles) {
    BlockLayout L;
    const long long warps = (P.n_points + 31) / 32;
    L.threads = 32 * (int)(warps < 1 ? 1 : (warps < BLOCK_MAX_WARPS ? warps : BLOCK_MAX_WARPS));
    const long long points = ((long long)M::stage_bytes(P) + 15) / 16 * 16;
    const long long ws = ((long long)M::block_ws_bytes(P) + 15) / 16 * 16;
    const long long limit = smem_optin_limit();
    L.use_smem = points + 8 * red_doubles <= limit;
    L.red_off = L.use_smem ? points : 0;
    long long used = L.red_off + 8 * red_doubles;
    L.ws_smem = used + ws <= limit;
    L.ws_off = used;
    if (L.ws_smem) used += ws;
    L.smem = used;
    L.scratch = L.ws_smem ? 0 : ws / 8;
    return L;
}

// K9's plan for a chain of the model's points: block_plan with NUTS_RED
// reduction slots, then the trajectory buffer (max_len rows of 2 ndim + 2
// doubles) in shared memory where it still fits, else after the workspace in
// the scratch.
template <typename M>
static NutsLayout nuts_plan(const typename M::Params& P, int ndim, int max_depth) {
    NutsLayout L;
    static_cast<BlockLayout&>(L) = block_plan<M>(P, NUTS_RED);
    const long long max_len = max_depth > 1 ? 1LL << (max_depth - 1) : 1;
    const long long traj = 8 * max_len * (2 * ndim + 2);
    L.traj_smem = L.smem + traj <= smem_optin_limit();
    L.traj_off = L.smem;
    if (L.traj_smem) L.smem += traj;
    L.traj_scratch = L.scratch;
    L.scratch += L.traj_smem ? 0 : traj / 8;
    return L;
}

// The float64 scratch, in doubles per block, of a block-per-chain launch: K9
// at max_depth >= 1, K7h and K7's block form at 0.
template <typename M>
static long long block_scratch(const typename M::Params& P, int ndim, int max_depth) {
    return max_depth > 0 ? nuts_plan<M>(P, ndim, max_depth).scratch : block_plan<M>(P, 0).scratch;
}

// Dynamic shared memory over the 48 KB default: opt in.
template <typename Kernel>
static int opt_in_smem(Kernel kernel, long long smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}

template <typename M, int N>
static int launch_logpost_grad_block(const typename M::Params& P, const WhiteParams* T,
                                     const double* q, int W, double* val, double* grad,
                                     double* scratch, cudaStream_t stream) {
    auto kernel = logpost_grad_block_kernel<M, N>;
    const BlockLayout L = block_plan<M>(P, 0);
    if (L.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    int rc = opt_in_smem(kernel, L.smem);
    if (rc) return rc;
    WhiteParams none;
    none.ndim = 0;
    kernel<<<W, L.threads, L.smem, stream>>>(P, T ? *T : none, T != nullptr, q, val, grad,
                                             scratch, L);
    return (int)cudaGetLastError();
}

template <typename M, int N>
static int launch_nuts(const typename M::Params& P, const WhiteParams& T, const double* q,
                       const double* logp, const double* z, const double* u, const double* eps,
                       const double* inv_mass, int max_depth, int C, double* q_out,
                       double* logp_out, double* accept_stat, int* depth, int* diverged,
                       double* scratch, cudaStream_t stream) {
    auto kernel = nuts_transition_kernel<M, N>;
    const NutsLayout L = nuts_plan<M>(P, N, max_depth);
    if (L.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    int rc = opt_in_smem(kernel, L.smem);
    if (rc) return rc;
    kernel<<<C, L.threads, L.smem, stream>>>(P, T, q, logp, z, u, eps, inv_mass, max_depth, q_out,
                                             logp_out, accept_stat, depth, diverged, scratch, L);
    return (int)cudaGetLastError();
}

template <typename M, int N>
static int launch_hmc(const typename M::Params& P, const WhiteParams& T, const double* q,
                      const double* logp, const double* z, const double* u_acc,
                      const long long* n_used, const double* eps, const double* inv_mass, int C,
                      double* q_out, double* logp_out, double* accept_prob, double* scratch,
                      cudaStream_t stream) {
    auto kernel = hmc_transition_kernel<M, N>;
    const BlockLayout L = block_plan<M>(P, 0);
    if (L.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    int rc = opt_in_smem(kernel, L.smem);
    if (rc) return rc;
    kernel<<<C, L.threads, L.smem, stream>>>(P, T, q, logp, z, u_acc, n_used, eps, inv_mass,
                                             q_out, logp_out, accept_prob, scratch, L);
    return (int)cudaGetLastError();
}
