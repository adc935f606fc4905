// The per-transient ShockCooling2 kernels of the population fit (P1, P2,
// P3) for sm_90a, bound to Python through a plain C interface (ctypes).
//
// Replaces (JAX package, lightcurve_fitting_tpu/parallel/population.py):
//   P1  :349-386 make_logpost and :407-411 init_one, vmapped over the S
//       transients: the log-posterior of every transient's walkers, the
//       transients along the ensemble axis blockIdx.y, in one of two forms
//       that give the same bits (kernels/pop.py::logpost_form): the warp
//       form, logpost_warp_kernel over PopSC2WarpModel (a warp per walker),
//       and, for small launches, the latency form, logpost_latency_kernel
//       over it (a block per walker, a point a thread).
//   P2  :413-433 seg_one's step, make_stretch_kernel over make_logpost,
//       vmapped: one stretch-move half-step of all S ensembles in one launch
//       (transient e = blockIdx.y, the draws (S, 2, half) of the step), in
//       one of two forms that store the same bits (kernels/pop.py::half_form):
//       the warp form, stretch_half_step_kernel over PopSC2WarpModel (a warp
//       per walker, each block staging its transient's rows in one round
//       trip), and, for small launches, the latency form,
//       stretch_half_step_latency_kernel over it (a block per walker, a
//       point a thread, the rows read where they lie).
//   P3  :204-231 optimize_fn: the Adam ascent of every transient's
//       posterior from n_starts starts (vmap over transients of vmap over
//       starts of value_and_grad, in an n_iter-step lax.scan) and the final
//       negative log-posteriors, in one launch (pop_map_kernel: blocks of
//       four warps over (starts, transient), a start a warp or, in the pair
//       form, two warps, a point a thread; kernels/pop.py::map_form).
//
// The likelihood is the population's, not the single fit's: y and dy are
// divided by the transient's own yscale; log_norm (float64, over the real
// points) is added to the compute-type sum promoted to float64; with the
// intrinsic scatter there is no constant; a non-finite log L is -inf. The
// sums take the transient's n_real real points alone: pack_population pads
// a transient with copies of its last real point (the same time and table
// row, so the same model value) at inv_dy = 0, whose term the JAX graph
// adds as (y - y_fit) * 0: +0 where the model value is finite, which leaves
// every sum's bits as they are, and NaN where it is not, where the real
// point's own term is already not finite and log L is -inf either way. The
// phase is ops/mathx.py:hot_phase's, centred on each transient's own t_ref
// = floor(min t): tt = C(t - t_ref) - C(t_exp - t_ref), t_exp = 0 for the
// three-parameter fit (T_1, L_1, t_tr). A point is sc2_forward's (EXACT,
// the bits of K1 and K2 at the same constants), its derivatives
// sc2_point's (K7's).
//
// What bounds them on the H100: the latency of one walker's or one start's
// chain, not a pipe. A point's value takes ~2900 cycles and its value and
// gradient ~6500 (the float32 powers, in turn), a start's float64 bijection
// and Adam step ~3300 an evaluation at five dimensions a lane, P2's staging
// of the rows ~5000 array after array (tools/probe_pop_latency.py, PERF.md
// §6). So the warp form stages a transient's rows in one round trip
// (pop_stage_rows), every sum skips the padded copies, the latency form
// gives a small launch a thread per point, and P3 spreads its starts over
// blocks of four warps on every SM, gives a point a thread in the pair form,
// reduces its six sums in one interleaved butterfly, and keeps a
// dimension's Adam state on a lane of its own (five dimensions' state a
// lane spilled in the warp-per-start kernel).

#include "adam.cuh"
#include "population.cuh"
#include "sc2_model.cuh"

// P3's stamps (tools/probe_pop_latency.py defines them in a copy of this
// file): no-ops here.
#ifndef POP_MAP_PROBE
#define POP_MAP_BEGIN
#define POP_MAP_STAGED
#define POP_MAP_PROBE_DECL
#define POP_MAP_START()
#define POP_MAP_MARK(k)
#define POP_MAP_PUT(w)
#endif

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

// A point's residual r (sc2_forward's) added to the sum: r * r, or r itself
// with the intrinsic scatter, rounded by hand in both types (sc2_add_term's
// EXACT), so that every form of P1 and P2 adds alike, with the bits of the
// compiled `acc + r * r` (a multiply and an add: a fused multiply-add gives
// other float32 bits, tools/time_port_kernels.py's digests).
template <typename C>
__device__ __forceinline__ C pop_add(C acc, C r, bool use_sigma) {
    return use_sigma ? add_rn(acc, r) : add_rn(acc, mul_rn(r, r));
}

// The ShockCooling2 policy of P1 and P2 (stretch.cuh): PopTableModel's
// form, batched as SC2WarpModel, the point sc2_forward's. N: the walker's
// dimension, 3, 4 or 5, at compile time.
template <typename C, int N>
struct PopSC2WarpModel : PopTableModel<C, N> {
    typedef PopData<C> Data;
    typedef PopWalker<C> Walker;
    static __device__ Walker walker(const double* p, const PopParams& P) {
        return pop_walker<C>(p, P, N);
    }
    // Lane l adds the terms of its real points l, l + 32, ... in that
    // order, then the butterfly sums the lanes (K1's order), every lane the
    // same bits.
    static __device__ double log_likelihood_warp(const Walker& v, const Data& d,
                                                 const PopParams& P) {
        const SC2Walker<C> w = pop_sc2_walker<C>(v, d, P);
        const int K = (int)P.n_coef;
        const bool use_sigma = P.use_sigma != 0;
        C acc = C(0);
        for (int n = threadIdx.x & 31; n < d.n_real; n += 32)
            acc = pop_add<C>(
                acc,
                sc2_forward<C, true>(n, w, d.pts, K, use_sigma, sc2_no_before(), sc2_no_link()).r,
                use_sigma);
        return pop_finish<C>(warp_sum(acc), use_sigma, d.log_norm);
    }
    // The latency form's point n (its residual r) and the sum over a
    // transient's real points, in log_likelihood_warp's operations.
    static __device__ C point_term(int n, const Walker& v, const Data& d, const PopParams& P) {
        return sc2_forward<C, true>(n, pop_sc2_walker<C>(v, d, P), d.pts, (int)P.n_coef,
                                    P.use_sigma != 0, sc2_no_before(), sc2_no_link()).r;
    }
    static __device__ C add_term(C acc, C r, const PopParams& P) {
        return pop_add<C>(acc, r, P.use_sigma != 0);
    }
};

// ------------------------------------------------------------------------ P3

#define POP_MAP_THREADS 128   // a block of P3: four warps over its transient's starts

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

// The pair form's exchange of a point's factors (SC2Point, nine values)
// between the two warps of a start: [iteration parity][warp][field][lane],
// in shared memory, a start's slot of POP_PAIR_VALUES.
#define POP_PAIR_VALUES (2 * 2 * 9 * 32)
// The pair form's most padded points: one a thread over its two warps.
#define POP_MAP_PAIR_MAX_POINTS 64

template <typename C>
__device__ __forceinline__ void pop_pair_put(C* b, int lane, const SC2Point<C>& q) {
    const C v[9] = {q.r, q.t0, q.t1, q.l0, q.l1, q.ttr, q.tt, q.s0, q.s1};
#pragma unroll
    for (int f = 0; f < 9; ++f) b[32 * f + lane] = v[f];
}

template <typename C>
__device__ __forceinline__ SC2Point<C> pop_pair_get(const C* b, int lane) {
    SC2Point<C> q;
    q.r = b[lane];
    q.t0 = b[32 + lane];
    q.t1 = b[64 + lane];
    q.l0 = b[96 + lane];
    q.l1 = b[128 + lane];
    q.ttr = b[160 + lane];
    q.tt = b[192 + lane];
    q.s0 = b[224 + lane];
    q.s1 = b[256 + lane];
    return q;
}

// The six sums over the 32 lanes, each by warp_sum's butterfly, the six
// interleaved (each sum's own order, so warp_sum's bits, every lane the
// same).
template <typename C>
__device__ __forceinline__ void pop_reduce(SC2Sums<C>& s, bool use_sigma) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const C a = __shfl_xor_sync(0xffffffffu, s.acc, o);
        const C t = __shfl_xor_sync(0xffffffffu, s.dT1, o);
        const C l = __shfl_xor_sync(0xffffffffu, s.dL1, o);
        const C r = __shfl_xor_sync(0xffffffffu, s.dttr, o);
        const C u = __shfl_xor_sync(0xffffffffu, s.dtt, o);
        const C g = use_sigma ? __shfl_xor_sync(0xffffffffu, s.dsig, o) : C(0);
        s.acc += a;
        s.dT1 += t;
        s.dL1 += l;
        s.dttr += r;
        s.dtt += u;
        if (use_sigma) s.dsig += g;
    }
}

// Dimension k of the log-posterior's gradient (the JAX where() passes no
// cotangent where log L is not finite, so the caller keeps 0 there): the
// prior's gradient gp there plus the cotangent -0.5 (exact) times the sum
// of that parameter's derivative; t_exp's is +0.5 dtt (tt = t - t_exp).
template <typename C>
__device__ __forceinline__ double pop_grad_k(int k, double gp, const SC2Sums<C>& s,
                                             const PopParams& P) {
    C c;
    if (k == 0) c = C(-0.5) * s.dT1;
    else if (k == 1) c = C(-0.5) * s.dL1;
    else if (k == 2) c = C(-0.5) * s.dttr;
    else if (k == 3 && P.n_model == 4) c = C(0.5) * s.dtt;
    else c = C(-0.5) * s.dsig;
    return gp + (double)c;
}

// P3: the Adam ascents of _map_seeded_guesses, transient blockIdx.y, a block
// of POP_MAP_THREADS threads over starts blockIdx.x * SPB, ... (WPS warps a
// start). Each of n_iter steps: x = the bijection of u, the log-posterior of
// the transient at x and its gradient, then the Adam step (the chain rule
// into u, a non-finite component 0, the step with the host's scalars); then
// each start's last iterate and its -log p, +inf where log p is -inf. Lane
// k < N keeps dimension k's u, m and v (adam_bounded_k, adam_step_k) and
// shuffles its x[k] to the start's lanes; every lane forms the priors and
// the walker. The points: WPS 1, lane l adds its real points l, l + 32, ...
// (sc2_point, sc2_accumulate) in turn; WPS 2 (N <= 64), thread 32 w + l
// forms point 32 w + l into shared memory (double-buffered by the step's
// parity, a named barrier of the start's 64 threads every step), and each
// warp reads points l and l + 32 back and adds them in the order of WPS 1
// (holding no point across the barrier: a float32 instantiation spilled
// at 128 registers with one held). The six sums by one interleaved butterfly (pop_reduce);
// pop_finish. So both forms give the same bits.
template <typename C, int N, int WPS>
__global__ void __launch_bounds__(POP_MAP_THREADS)
pop_map_kernel(const PopParams P, const PopMapParams Q, int use_smem) {
    static_assert(WPS == 1 || WPS == 2, "a start takes one warp or two");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int SPB = POP_MAP_THREADS / (32 * WPS);   // starts a block
    constexpr size_t PAIR_BYTES = WPS == 2 ? sizeof(C) * SPB * POP_PAIR_VALUES : 0;
    POP_MAP_BEGIN
    const PopData<C> d = pop_stage<C, false>(P, smem_raw + PAIR_BYTES, use_smem, blockIdx.y);
    POP_MAP_STAGED
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int slot = warp / WPS, part = warp % WPS;
    const int n_starts = (int)Q.n_starts;
    const int s = blockIdx.x * SPB + slot;
    if (s >= n_starts) return;   // (a start's warps together)
    C* pair = reinterpret_cast<C*>(smem_raw) + (size_t)slot * POP_PAIR_VALUES;
    const size_t row = (size_t)blockIdx.y * n_starts + s;
    const int k = lane < N ? lane : N - 1;   // (lanes past N repeat the last dimension)
    const int K = (int)P.n_coef, n_real = d.n_real, n_iter = (int)Q.n_iter;
    const bool use_sigma = P.use_sigma != 0;
    double u = Q.u0[row * N + k], m = 0.0, v = 0.0, neg = INFINITY;
    POP_MAP_PROBE_DECL
    POP_MAP_START();
    for (int t = 0;; ++t) {
        double f, x[N];
        const double xk = adam_bounded_k(Q, k, u, f);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = __shfl_sync(0xffffffffu, xk, i);
        POP_MAP_MARK(0);
        double lprior, gprior[N], lp = -INFINITY, g = 0.0, gp = 0.0;
        const bool inside = sc2_prior<N>(x, P, N, lprior, gprior);   // (uniform over the start)
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (i == k) gp = gprior[i];
        SC2Walker<C> w;
        if (inside) w = pop_sc2_walker<C>(pop_walker<C>(x, P, N), d, P);
        POP_MAP_MARK(1);
        SC2Sums<C> sums;
        if constexpr (WPS == 1) {
            if (inside)
                for (int n = lane; n < n_real; n += 32)
                    sc2_accumulate(sums, sc2_point<C>(n, w, d.pts, K, use_sigma), use_sigma);
            POP_MAP_MARK(2);
        } else {
            const int n = 32 * part + lane;
            SC2Point<C> q = {};
            if (inside && n < n_real) q = sc2_point<C>(n, w, d.pts, K, use_sigma);
            POP_MAP_MARK(2);
            C* buf = pair + (t & 1) * (2 * 9 * 32);
            pop_pair_put(buf + part * (9 * 32), lane, q);
            asm volatile("bar.sync %0, 64;" ::"r"(1 + slot) : "memory");
            if (inside) {
                if (lane < n_real) sc2_accumulate(sums, pop_pair_get(buf, lane), use_sigma);
                if (lane + 32 < n_real)
                    sc2_accumulate(sums, pop_pair_get(buf + 9 * 32, lane), use_sigma);
            }
        }
        if (inside) {
            pop_reduce(sums, use_sigma);
            POP_MAP_MARK(3);
            const double ll = pop_finish<C>(sums.acc, use_sigma, d.log_norm);
            if (ll > -INFINITY) {
                lp = lprior + ll;
                g = pop_grad_k<C>(k, gp, sums, P);
            }
        }
        POP_MAP_MARK(4);
        if (t == n_iter) {
            neg = -lp;
            break;
        }
        adam_step_k(Q, k, g, f, __ldg(Q.sched + 3 * t), __ldg(Q.sched + 3 * t + 1),
                    __ldg(Q.sched + 3 * t + 2), u, m, v);
        POP_MAP_MARK(5);
    }
    if (part == 0) {
        if (lane < N) Q.u_out[row * N + lane] = u;
        if (lane == 0) Q.neg_out[row] = neg;
    }
    POP_MAP_PUT((int)((blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x >> 5) + warp));
}

// P3's launch over S transients: blocks of min(n_starts, SPB) starts (WPS
// warps each), ceil(n_starts / SPB) a transient; the pair form needs N <= 64
// padded points. The rows are staged where they fit beside the exchange.
template <typename C, int N, int WPS>
static int launch_pop_map(const PopParams& P, const PopMapParams& Q, int S, cudaStream_t stream) {
    auto kernel = pop_map_kernel<C, N, WPS>;
    constexpr int SPB = POP_MAP_THREADS / (32 * WPS);
    if (WPS == 2 && P.n_points > POP_MAP_PAIR_MAX_POINTS) return (int)cudaErrorInvalidValue;
    const size_t pair = WPS == 2 ? sizeof(C) * SPB * POP_PAIR_VALUES : 0;
    const size_t rows = ::stage_bytes<C>(P);
    const int use_smem = pair + rows <= (size_t)smem_optin_limit() ? 1 : 0;
    const size_t bytes = pair + (use_smem ? rows : 0);
    if (bytes > 48 * 1024) {
        const int rc = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (rc) return rc;
    }
    const long long n = Q.n_starts;
    const int threads = n < SPB ? (int)(32 * WPS * n) : POP_MAP_THREADS;
    kernel<<<dim3((unsigned)((n + SPB - 1) / SPB), (unsigned)S), threads, bytes, stream>>>(
        P, Q, use_smem);
    return (int)cudaGetLastError();
}

// P2's launch for the compute type C, the walker dimension N and the state
// type S (the chain's state S, its log-posteriors float64): form 0 the warp
// form, 1 the latency form.
template <typename C, int N, typename S>
static int launch_pop_half(const PopParams& P, int form, void* x, double* logp, int half, int h,
                           const void* u_z, const long long* j, const void* u_acc, double a,
                           void* chain_x, double* chain_lp, int* n_accept, int n_ens,
                           long long draw_stride, cudaStream_t stream) {
    typedef PopSC2WarpModel<C, N> M;
    if (form)
        return launch_half_latency<M, S, S, double, true>(P, x, logp, half, h, u_z, j, u_acc, a,
                                                          chain_x, chain_lp, n_accept, stream,
                                                          n_ens, draw_stride);
    return launch_half<M, S, S, double>(P, x, logp, half, h, u_z, j, u_acc, a, chain_x, chain_lp,
                                        n_accept, n_ens, draw_stride, stream);
}

template <int N>
static int pop_half_dim(const PopParams& P, int compute_f64, int state_f64, int form, void* x,
                        double* logp, int half, int h, const void* u_z, const long long* j,
                        const void* u_acc, double a, void* chain_x, double* chain_lp,
                        int* n_accept, int n_ens, long long draw_stride, cudaStream_t s) {
#define POP_HALF(C, S)                                                                       \
    launch_pop_half<C, N, S>(P, form, x, logp, half, h, u_z, j, u_acc, a, chain_x, chain_lp, \
                             n_accept, n_ens, draw_stride, s)
    if (compute_f64) return state_f64 ? POP_HALF(double, double) : POP_HALF(double, float);
    return state_f64 ? POP_HALF(float, double) : POP_HALF(float, float);
#undef POP_HALF
}

// P1's launch for the compute type C, the walker dimension N and the
// state's type S: form 0 the warp form (logpost_warp_kernel, a warp per
// walker), 1 the latency form (logpost_latency_kernel with the ensemble
// axis: a block per walker, a point a thread, at most LP_LAT_LP_ENS_WARPS
// warps a walker); the same bits.
template <typename C, int N, typename S>
static int launch_pop_logpost(const PopParams& P, int form, const void* q, int W, int n_ens,
                              double* out, cudaStream_t stream) {
    typedef PopSC2WarpModel<C, N> M;
    if (form) return launch_logpost_latency<M, S, true>(P, q, W, out, stream, n_ens);
    return launch_logpost_warp<M, S>(P, q, W, n_ens, out, stream);
}

// ------------------------------------------------------------------ launch

extern "C" {

// P1 launch: out (S, W) at the walker states q (S, W, ndim), transient e
// along blockIdx.y; ndim 3, 4 or 5; form 0 the warp form, 1 the latency
// form. Returns 0 or a cudaError_t code.
int pop_logpost_launch(const PopParams* P, int device, int compute_f64, const void* q,
                       int q_f64, int W, int S, double* out, int form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || S <= 0) return 0;
    if (P->model != 0 || (P->n_model != 3 && P->n_model != 4) || S > 65535
        || (form != 0 && form != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_P1(N_)                                                                        \
    (compute_f64                                                                          \
         ? (q_f64 ? launch_pop_logpost<double, N_, double>(*P, form, q, W, S, out, s)     \
                  : launch_pop_logpost<double, N_, float>(*P, form, q, W, S, out, s))     \
         : (q_f64 ? launch_pop_logpost<float, N_, double>(*P, form, q, W, S, out, s)      \
                  : launch_pop_logpost<float, N_, float>(*P, form, q, W, S, out, s)))
    switch (P->ndim) {
        case 3: return POP_P1(3);
        case 4: return POP_P1(4);
        case 5: return POP_P1(5);
    }
#undef POP_P1
    return (int)cudaErrorInvalidValue;
}

// P2 launch: one half-step of the S ensembles x (S, 2, half, ndim), the
// draws of ensemble e draw_stride after those of e - 1; chain_x (the
// state's type) and chain_lp may be null; ndim 3, 4 or 5; form 0 the warp
// form, 1 the latency form. Returns 0 or a cudaError_t code.
int pop_half_step_launch(const PopParams* P, int device, int compute_f64, void* x, int state_f64,
                         double* logp, int half, int h, const void* u_z, const long long* j,
                         const void* u_acc, double a, void* chain_x, double* chain_lp,
                         int* n_accept, int S, long long draw_stride, int form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (half <= 0 || S <= 0) return 0;
    if (P->model != 0 || (P->n_model != 3 && P->n_model != 4) || S > 65535
        || (form != 0 && form != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_HALF_DIM(N_)                                                                      \
    pop_half_dim<N_>(*P, compute_f64, state_f64, form, x, logp, half, h, u_z, j, u_acc, a,     \
                     chain_x, chain_lp, n_accept, S, draw_stride, s)
    switch (P->ndim) {
        case 3: return POP_HALF_DIM(3);
        case 4: return POP_HALF_DIM(4);
        case 5: return POP_HALF_DIM(5);
    }
#undef POP_HALF_DIM
    return (int)cudaErrorInvalidValue;
}

// P3 launch: form 0 a warp a start, 1 two warps a start (the pair form);
// ndim 3, 4 or 5. Returns 0 or a cudaError_t code.
int pop_map_launch(const PopParams* P, const PopMapParams* Q, int device, int compute_f64, int S,
                   int form, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (S <= 0) return 0;
    if (Q->n_starts < 1 || Q->n_iter < 0 || P->has_affine || S > 65535 || (form != 0 && form != 1)
        || P->model != 0 || (P->n_model != 3 && P->n_model != 4)
        || P->ndim != P->n_model + (P->use_sigma != 0))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define POP_MAP(N_)                                                                \
    (compute_f64 ? (form ? launch_pop_map<double, N_, 2>(*P, *Q, S, s)             \
                         : launch_pop_map<double, N_, 1>(*P, *Q, S, s))            \
                 : (form ? launch_pop_map<float, N_, 2>(*P, *Q, S, s)              \
                         : launch_pop_map<float, N_, 1>(*P, *Q, S, s)))
    switch (P->ndim) {
        case 3: return POP_MAP(3);
        case 4: return POP_MAP(4);
        case 5: return POP_MAP(5);
    }
#undef POP_MAP
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
