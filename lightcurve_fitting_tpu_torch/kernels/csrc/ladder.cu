// K6: the model-free kernels of the tempered ladder, for sm_90a, bound to
// Python through a plain C interface (ctypes). The model kernels (the
// tempered half-step and the initial state) are templates in ladder.cuh.
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K6c parallel/evidence.py:95-115 (do_swap: replica exchange between
//       neighbouring rungs) with :117-123 (the production outputs of a step:
//       the post-swap log L of every rung, the swap flags, the cold rung's
//       states).
//   K6d parallel/evidence.py:473-503 (_rung_block_terms): the stepping-stone
//       terms log mean exp(dbeta_k log L_k) over each block of production
//       steps.
//
// What bounds them on the H100: device memory, and for the swap the latency
// of its loads. The swap reads and writes a few dozen bytes a walker with a
// handful of flops: 5.9 MB at the evidence's 17 rungs x 4096 walkers (1.8
// us at 3.35 TB/s), a few kilobytes at the PT fits' 7 x 32, where a step is
// the round trips to memory that its dependent loads make. The block terms
// read the production log L, (nsteps, K+1, 2, half) float64, of the K rungs
// below the cold one (78.6 MB at 150 steps x 16 rungs x 4096 walkers), and
// take an exp a value.
// What the design does about it: the swap is one thread per (unit, walker),
// a unit being a rung pair or an unpaired edge rung, so no thread of the
// grid is idle: a pair's thread issues every load of both members (the two
// state rows as whole vectors, log pi, log L, the betas, its uniform and
// the swap counts) before it decides, so a step costs one round trip, then
// decides once (the two rows' acceptance ratios are the same number: both
// factors change sign) and writes both rows from registers, so nothing races
// and the pair shares its uniform as in the JAX graph; the same launch writes
// the step's production outputs, so they cost no launch of their own. The
// row's length is a template parameter (1-9). The block terms read the log L
// once: a CTA per (split, rung, block of steps), enough splits of each
// block's values to put several CTAs on every SM; a thread keeps a running
// maximum and sum of exponentials over its values, loaded as 16-byte pairs a
// chunk at a time, and rescales the sum at most once a chunk; the last CTA
// of each (block, rung) combines the splits' partials in split order in the
// same launch, so the same inputs give the same bits on every run.

#include "stretch.cuh"

#define LADDER_MAX_BLOCKS 8
#define TERMS_THREADS 256
#define TERMS_CHUNK 4        // loads a thread issues before it reduces them
#define TERMS_MAX_SPLITS 32  // the last CTA's warp combines one split a lane

// The rung that rung r exchanges with at this step's parity: even parity
// pairs (0,1), (2,3), ...; odd parity (1,2), (3,4), ...; an unpaired edge
// rung is its own partner (evidence.py:87-93).
__device__ __forceinline__ int swap_partner(int r, int parity, int n_rungs) {
    const int p = parity ? (r == 0 ? 0 : (((r - 1) ^ 1) + 1)) : (r ^ 1);
    return p >= n_rungs ? r : p;
}

// The lower rung of unit u of the exchange at this step's parity: the units
// are the pairs and the unpaired edge rungs, in rung order (0, 2, 4, ... at
// even parity; 0, 1, 3, 5, ... at odd parity), ceil(R / 2) and 1 + R / 2 of
// them.
__device__ __forceinline__ int unit_rung(int u, int parity) {
    return parity ? (u == 0 ? 0 : 2 * u - 1) : 2 * u;
}

static inline int n_units(int n_rungs, int parity) {
    return parity ? 1 + n_rungs / 2 : (n_rungs + 1) / 2;
}

// A walker's state row of N elements of S in registers, moved as whole
// vectors V: the widest of int4, int2 and int whose size divides the row's
// bytes, so that every row of an aligned array starts on a V boundary (a
// float32 row of 4 is one 16-byte vector, of 7 seven words).
template <typename S, int N>
struct StateRow {
    static constexpr int bytes = N * (int)sizeof(S);
    typedef typename std::conditional<
        bytes % 16 == 0, int4, typename std::conditional<bytes % 8 == 0, int2, int>::type>::type V;
    static constexpr int n = bytes / (int)sizeof(V);
    V v[n];
    __device__ __forceinline__ void load(const S* base, size_t row) {
        const V* p = reinterpret_cast<const V*>(base) + row * n;
#pragma unroll
        for (int k = 0; k < n; ++k) v[k] = p[k];
    }
    __device__ __forceinline__ void store(S* base, size_t row) const {
        V* p = reinterpret_cast<V*>(base) + row * n;
#pragma unroll
        for (int k = 0; k < n; ++k) p[k] = v[k];
    }
};

// K6c: the replica exchange of one step, in place. x (R, W, N), logpri and
// logl (R, W) float64 with W = 2 half; betas (R,); u (R, W) uniforms, a pair
// reading its lower rung's row. A pair (r, r+1) exchanges walker w's states
// when log u < (beta_{r+1} - beta_r)(ll_r - ll_{r+1}) and both ll are finite.
// When given: n_swap (R, W) int32 counts the exchanges of both rows,
// logl_out (R, W) receives the post-swap log L, cold_out (W, N) the last
// rung's post-swap states. A thread per (unit, walker), blockIdx.y the unit:
// a pair's thread issues every load of both members (their state rows
// whether or not they move, as whole vectors) before the decision, so the
// step costs one round trip to memory, then writes both rows.
template <typename S, int N>
__global__ void replica_swap_kernel(S* __restrict__ x, double* __restrict__ logpri,
                                    double* __restrict__ logl, const double* __restrict__ betas,
                                    int n_rungs, int W, const S* __restrict__ u, int parity,
                                    int* __restrict__ n_swap, double* __restrict__ logl_out,
                                    S* __restrict__ cold_out) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= W) return;
    const int r = unit_rung(blockIdx.y, parity);
    const int q = swap_partner(r, parity, n_rungs);
    const int cold = n_rungs - 1;
    const size_t a = (size_t)r * W + w;
    if (q == r) {   // an unpaired edge rung: only the production outputs
        if (logl_out != nullptr) logl_out[a] = logl[a];
        if (cold_out != nullptr && r == cold) {
            StateRow<S, N> xa;
            xa.load(x, a);
            xa.store(cold_out, w);
        }
        return;
    }
    const size_t b = (size_t)q * W + w;
    StateRow<S, N> xa, xb;
    xa.load(x, a);
    xb.load(x, b);
    const double lla = logl[a], llb = logl[b], pa = logpri[a], pb = logpri[b];
    const double br = betas[r], bq = betas[q];
    const S ua = u[a];
    const int na = n_swap != nullptr ? n_swap[a] : 0, nb = n_swap != nullptr ? n_swap[b] : 0;
    const double log_acc = __dmul_rn(__dsub_rn(bq, br), __dsub_rn(lla, llb));
    // a log L of -inf (a NaN-likelihood start) never moves between rungs
    const bool acc = (double)m_log(ua) < log_acc && isfinite(lla) && isfinite(llb);
    if (acc) {
        xb.store(x, a);
        xa.store(x, b);
        logpri[a] = pb;
        logpri[b] = pa;
        logl[a] = llb;
        logl[b] = lla;
    }
    if (n_swap != nullptr) {
        n_swap[a] = na + (acc ? 1 : 0);
        n_swap[b] = nb + (acc ? 1 : 0);
    }
    if (logl_out != nullptr) {
        logl_out[a] = acc ? llb : lla;
        logl_out[b] = acc ? lla : llb;
    }
    if (cold_out != nullptr && q == cold) {   // rung q's post-swap row, chosen word by word
        StateRow<S, N> c;                      // (a choice of a whole row would address the
#pragma unroll                                 // rows, and put them on the stack)
        for (int k = 0; k < StateRow<S, N>::n; ++k) c.v[k] = acc ? xa.v[k] : xb.v[k];
        c.store(cold_out, w);
    }
}

template <typename S, int N>
static void launch_swap(void* x, double* logpri, double* logl, const double* betas, int n_rungs,
                        int W, const void* u, int parity, int* n_swap, double* logl_out,
                        void* cold_out, cudaStream_t stream) {
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, n_units(n_rungs, parity));
    replica_swap_kernel<S, N><<<grid, threads, 0, stream>>>(
        (S*)x, logpri, logl, betas, n_rungs, W, (const S*)u, parity, n_swap, logl_out,
        (S*)cold_out);
}

struct TermBlocks {
    long long lo[LADDER_MAX_BLOCKS];  // first production step of each block
    long long hi[LADDER_MAX_BLOCKS];  // one past its last
};

// max that keeps a NaN, as torch.amax and jnp.max do
__device__ __forceinline__ double nan_max(double m, double v) {
    return (isnan(v) || v > m) ? v : m;
}

// Reduce v over the block (blockDim.x a multiple of 32, at most 1024) with
// op; every thread returns the result.
template <typename Op>
__device__ double block_reduce(double v, Op op, double* scratch) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();   // scratch may still be read by an earlier reduction
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    const int n_warps = blockDim.x >> 5;
    v = scratch[0];
    for (int k = 1; k < n_warps; ++k) v = op(v, scratch[k]);
    return v;
}

// The finished term m + log(s / n) of a (block, rung) from the maximum m
// and the sum s of exp(v - m) over its n values: NaN where m is not finite
// (a NaN or +inf among the values, or every value -inf), as the plain
// m + log(mean(exp(v - m))) gives.
__device__ __forceinline__ double block_term(double m, double s, double n) {
    return isfinite(m) ? m + log(s / n) : (double)NAN;
}

// K6d: out[b, k] = log mean exp(dbetas[k] * logl[s, k, w]) over the steps s of
// block b and all W walkers, for the rungs k < K of logl (nsteps, R, W)
// float64, in float64. CTA (p, k, b) takes split p of the splits contiguous
// ranges of block b's values in (step, walker) order, V values an item (V =
// 2: 16-byte loads, W even and logl 16-byte aligned). Each thread keeps (m,
// s) over its items, s the sum of exp(v - m) with m their maximum: a chunk of
// TERMS_CHUNK items at a time, its maximum first and s rescaled to it once,
// then its exps; a -inf adds 0 where the maximum is finite, and a thread
// that has seen only -inf keeps (-inf, 0). The CTA's (M, S) is the block
// maximum and the sum of each thread's s rescaled to it. With one split the
// CTA writes the term; else it writes (M, S) to partial[(b K + k) splits +
// p], and the last CTA of (b, k) to finish (atomicInc on ctr[b K + k], which
// wraps back to 0 at splits - 1, so the counters stay zero between launches
// and need no reset) combines the splits' partials in split order: the
// bits do not depend on the order in which the CTAs ran. The counters and
// partials are one buffer a (device, stream) (kernels/ladder.py): the
// launches that share one run one after another.
template <int V>
__global__ void __launch_bounds__(TERMS_THREADS)
rung_block_terms_kernel(const double* __restrict__ logl, int n_rungs, int W,
                        const double* __restrict__ dbetas, int K, const TermBlocks blocks,
                        int splits, double2* __restrict__ partial, unsigned int* __restrict__ ctr,
                        double* __restrict__ out) {
    __shared__ double scratch[32];
    __shared__ bool s_last;
    const int p = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
    const double db = dbetas[k];
    long long s0 = 0, s1 = 0;   // block b's steps (constant indices: no stack copy)
#pragma unroll
    for (int j = 0; j < LADDER_MAX_BLOCKS; ++j)
        if (j == b) s0 = blocks.lo[j], s1 = blocks.hi[j];
    const unsigned per_row = (unsigned)(W / V);                 // items a step
    const unsigned items = (unsigned)(s1 - s0) * per_row;
    const unsigned i0 = (unsigned)((unsigned long long)items * p / splits);
    const unsigned i1 = (unsigned)((unsigned long long)items * (p + 1) / splits);
    const size_t row_stride = (size_t)n_rungs * W;
    const double* base = logl + (size_t)s0 * row_stride + (size_t)k * W;
    // item i lies in step r = i / per_row of the block, at column c = i % per_row;
    // a thread's items are TERMS_THREADS apart: (r, c) advance by (dr, dc)
    const unsigned dr = TERMS_THREADS / per_row, dc = TERMS_THREADS % per_row;
    unsigned i = i0 + threadIdx.x;
    unsigned r = i / per_row, c = i - r * per_row;
    double m = -INFINITY, sum = 0.0;
    while (i < i1) {
        double v[TERMS_CHUNK * V];
        double mc = m;
#pragma unroll
        for (int u = 0; u < TERMS_CHUNK; ++u) {
            if (i < i1) {
                const double* src = base + r * row_stride + (size_t)c * V;
                if constexpr (V == 2) {
                    const double2 x = __ldg(reinterpret_cast<const double2*>(src));
                    v[2 * u] = __dmul_rn(db, x.x);
                    v[2 * u + 1] = __dmul_rn(db, x.y);
                } else {
                    v[u] = __dmul_rn(db, __ldg(src));
                }
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j) v[V * u + j] = -INFINITY;   // adds nothing
            }
            i += TERMS_THREADS;
            r += dr;
            c += dc;
            if (c >= per_row) c -= per_row, ++r;
        }
#pragma unroll
        for (int j = 0; j < TERMS_CHUNK * V; ++j) mc = nan_max(mc, v[j]);
        if (mc == -INFINITY) continue;            // every value so far -inf: (m, s) = (-inf, 0)
        if (mc != m) sum *= exp(m - mc);          // (a NaN m stays NaN)
        m = mc;
#pragma unroll
        for (int j = 0; j < TERMS_CHUNK * V; ++j) sum += exp(v[j] - m);
    }
    const double M = block_reduce(m, [](double x, double y) { return nan_max(x, y); }, scratch);
    const double S = block_reduce(M == -INFINITY ? 0.0 : sum * exp(m - M),
                                  [](double x, double y) { return x + y; }, scratch);
    const double n = (double)(s1 - s0) * W;
    const size_t slot = (size_t)b * K + k;
    if (splits == 1) {
        if (threadIdx.x == 0) out[slot] = block_term(M, S, n);
        return;
    }
    if (threadIdx.x == 0) {
        partial[slot * splits + p] = make_double2(M, S);
        __threadfence();
        s_last = atomicInc(ctr + slot, (unsigned)splits - 1) == (unsigned)splits - 1;
    }
    __syncthreads();
    if (!s_last || threadIdx.x >= 32) return;
    // the last CTA: lane l reads split l's partial (from L2: other SMs wrote
    // it), the maximum over the splits, each partial's sum rescaled to it,
    // and lane 0 adds them in split order
    const int lane = threadIdx.x;
    const double2 part = lane < splits ? __ldcg(partial + slot * splits + lane)
                                       : make_double2(-INFINITY, 0.0);
    double mx = part.x;
    for (int o = 16; o > 0; o >>= 1) mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const double scaled = isfinite(mx) ? part.y * exp(part.x - mx) : 0.0;
    double total = 0.0;
    for (int q = 0; q < splits; ++q) total += __shfl_sync(0xffffffffu, scaled, q);
    if (lane == 0) out[slot] = block_term(mx, total, n);
}

extern "C" {

// K6c launch. n_swap, logl_out and cold_out may be null (a burn-in step).
// Returns 0 or a cudaError_t code.
int replica_swap_launch(int device, void* x, int state_f64, int ndim, double* logpri,
                        double* logl, const double* betas, int n_rungs, int W, const void* u,
                        int parity, int* n_swap, double* logl_out, void* cold_out,
                        void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (W <= 0 || n_rungs <= 0) return 0;
    if (n_rungs > 65535 || ndim < 1 || ndim > LP_MAX_DIM) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    parity = parity ? 1 : 0;
    const int key = state_f64 * 16 + ndim;
#define LP_SWAP_CASE(N)                                                                      \
    case N:                                                                                  \
        launch_swap<float, N>(x, logpri, logl, betas, n_rungs, W, u, parity, n_swap,         \
                              logl_out, cold_out, s);                                        \
        break;                                                                               \
    case 16 + N:                                                                             \
        launch_swap<double, N>(x, logpri, logl, betas, n_rungs, W, u, parity, n_swap,        \
                               logl_out, cold_out, s);                                       \
        break;
    switch (key) {
        LP_SWAP_CASE(1)
        LP_SWAP_CASE(2)
        LP_SWAP_CASE(3)
        LP_SWAP_CASE(4)
        LP_SWAP_CASE(5)
        LP_SWAP_CASE(6)
        LP_SWAP_CASE(7)
        LP_SWAP_CASE(8)
        LP_SWAP_CASE(9)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef LP_SWAP_CASE
    return (int)cudaGetLastError();
}

// K6d launch: n_blocks blocks of steps [lo[b], hi[b]) (host arrays), out
// (n_blocks, K) float64; splits (1-32) CTAs a (block, rung), vec 1 for
// 16-byte loads (W even, logl 16-byte aligned); partial (n_blocks K splits)
// double2 and ctr (n_blocks K) zeroed counters when splits > 1. Returns 0
// or a cudaError_t code.
int rung_block_terms_launch(int device, const double* logl, int n_rungs, int W,
                            const double* dbetas, int K, int n_blocks, const long long* lo,
                            const long long* hi, int splits, int vec, void* partial,
                            unsigned int* ctr, double* out, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (n_blocks <= 0 || K <= 0) return 0;
    if (n_blocks > LADDER_MAX_BLOCKS || K > n_rungs || K > 65535 || splits < 1
        || splits > TERMS_MAX_SPLITS || (vec && W % 2) || W <= 0)
        return (int)cudaErrorInvalidValue;
    TermBlocks blocks;
    for (int b = 0; b < n_blocks; ++b) {
        if (lo[b] < 0 || hi[b] <= lo[b] || (hi[b] - lo[b]) * W >= (1LL << 31))
            return (int)cudaErrorInvalidValue;   // an item index is 32 bits
        blocks.lo[b] = lo[b];
        blocks.hi[b] = hi[b];
    }
    const dim3 grid(splits, K, n_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        rung_block_terms_kernel<2><<<grid, TERMS_THREADS, 0, s>>>(
            logl, n_rungs, W, dbetas, K, blocks, splits, (double2*)partial, ctr, out);
    else
        rung_block_terms_kernel<1><<<grid, TERMS_THREADS, 0, s>>>(
            logl, n_rungs, W, dbetas, K, blocks, splits, (double2*)partial, ctr, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
