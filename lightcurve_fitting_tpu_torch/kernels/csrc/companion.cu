// The companion-shocking kernels for sm_90a, bound to Python through a plain
// C interface (ctypes): K8, the SiFTO spline, and the fused log-posterior of
// CompanionShocking, CompanionShocking2 and CompanionShocking3 with its
// stretch-move half-step and its tempered-ladder kernels.
//
// Replaces (JAX package, lightcurve_fitting_tpu/):
//   K8  models/companion_shocking.py:45-59 (_ppoly_batched) through
//       _sifto_points (:186-195), ops/interpolate.py:55-74 (ppoly_eval): per
//       point the template phase (t - t_peak - dt_{U,i}) / s, the knot search
//       searchsorted(side="right") - 1 clipped to [0, S-2], a Horner cubic
//       with the band's (4, S-1) coefficients, NaN outside the knots, then 0.
//   The CS log-posterior: fitting.py:62-68 with models/base.py:278-288 (ll)
//       over companion_shocking.py:120-126 (_tr_points, the Kasen T and R),
//       :197-201 (_kasen_points), :243-296 (_eval_points of CS1-3) and
//       ops/bandtable.py:152-181 (chebyshev_bandflux); its half-step
//       parallel/sampler.py:38-57, :86-104, :205-225 (stretch.cuh over
//       CSWarpModel) and the tempered ladder's parallel/evidence.py:60-83
//       and :229-235 (ladder.cuh over CSWarpModel).
//
// What bounds it on the H100: FP32 ALU and special-function work. One
// evaluation runs per point the Chebyshev table's Clenshaw recurrence (24
// steps, ~75 flops), ~10 special functions (the Kasen power laws, log T, exp)
// and K8 (the knot interval from a guess, a cubic); the
// per-point data (25.2 KB in float32 at 108 points, the SiFTO rows included;
// 49.2 KB in float64) is shared by every walker, so device-memory traffic is
// negligible.
// What the design does about it: the per-point constants and the per-band
// SiFTO rows (B x 4 x (S-1), 9.8 KB in float32 for 6 bands) staged once per
// block in shared memory; the walker-constant parts of the Kasen product,
// the CS3 viewing-angle factor and the scale factors hoisted out of the
// point loop (cs_walker); an out-of-prior walker returns -inf without
// touching the likelihood. The batch log-posterior (logpost_warp_kernel),
// the half-step, K6a and K6b run a warp per walker (CSWarpModel): a thread
// per walker left the fits' widths a few warps an SM (half 16 is one warp
// on one SM, half 16384 four warps on each), whose 108 dependent point
// evaluations (the recurrence, the knot search) set them at ~0.15-0.2 ms.
// The lanes split the points (lane l takes l, l + 32,
// ...: four evaluations at most). A warp per walker repeats the walker's
// prologue (the proposal, the prior, the float64 Kasen constant's pow and
// log) on all 32 lanes, ~35% of its time at the large widths, so a warp
// takes its walkers in batches (stretch.cuh, warp_batch_ll): lane l forms
// walker l's prologue, and for each walker the lanes evaluate its points on
// its constants, shuffled from its lane. The grid holds the blocks resident
// at once (32 warps a block in float32: one block an SM, the tables staged
// once an SM), the batch is as large as that takes. Every kernel over the
// policy evaluates a point with one __device__ function (cs_point), so a
// state's value has the same bits in each of them, whatever the batch.
// K8 alone (the SiFTO term of every (walker, point), the CS models'
// evaluate) has the bytes of its (W, N) output for its bound: a warp takes
// a walker, its lanes over the points (coalesced stores along the output's
// rows), each lane holding its points' records and rounding each walker's
// four parameters once for them; the knot interval comes from a guess for
// uniform knots corrected against its neighbours (sifto_eval), not a
// binary search, and no 64-bit division indexes the elements. The knots
// and the cubics (an interval's four coefficients together) are
// staged once a block only where a block has enough elements to pay for
// it (kernels/cs.py::k8_form); else they are read where they lie, through
// the read-only path. At large widths the random gathers from the table
// (32 lanes' intervals, conflicting in the banks) set its time.
//
// Dtype semantics: as K1, parameters are absolute float64 and cast to the
// compute type C after the epoch centring (tt = C(t - t_ref) - C(t_exp -
// t_ref)). The Kasen temperature T = 25 (a13^36 Mc kappa^-35 tt^-74)^(1/144):
// in float64 the JAX graph, operation order kept (the walker constant
// (a13^36 Mc) kappa^-35 then the per-point power laws); in float32 the
// product would underflow (tt^-74 for tt > 3.3 d), so the walker constant K
// is formed in float64 and T = 25 exp((ln K - 74 ln tt) / 144) in C, 0 where
// tt <= 0 or K <= 0 (power's zeros), as the plain version computes it.

#include "ladder.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/cs.py (_CSParams) matches it field for field.
struct CSParams {
    const void* t_centered;   // (N,) compute type: t - t_ref
    const void* y;            // (N,) y / yscale
    const void* inv_dy;       // (N,) yscale / dy
    const void* dy;           // (N,) dy / yscale
    const void* sigma_units;  // (N,)
    const void* s_a;          // (N,)
    const void* s_b;          // (N,)
    const void* coef;         // (N, n_coef) Chebyshev rows
    const void* sifto_rows;   // (B, 4, S-1) SiFTO coefficients per band
    const void* sifto_knots;  // (S,)
    const long long* sifto_band;  // (N,) each point's row
    const bool* is_U;         // (N,)
    const bool* is_i;         // (N,)
    const bool* is_r;         // (N,)
    long long n_points;
    long long n_coef;
    long long n_bands;
    long long n_knots;
    long long ndim;
    long long use_sigma;
    long long has_affine;
    long long variant;        // 1 CompanionShocking, 2 CompanionShocking2, 3 CompanionShocking3
    double t_ref;
    double inv_yscale;
    double log_norm_const;
    double ll_offset;
    double kappa;
    double kappa_m35;         // kappa^-35, float64
    long long prior_kind[LP_MAX_DIM];  // 0 uniform, 1 log-uniform, 2 Gaussian
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
};

// The standalone K8's arguments; the same 8-byte layout rule (mirror:
// kernels/cs.py _SiftoParams).
struct SiftoParams {
    const void* t_centered;   // (N,) compute type: t - t_ref
    const double* t_peak;     // (W,) absolute
    const double* stretch;    // (W,)
    const double* dtU;        // (W,), or null: no U shift
    const double* dti;        // (W,), or null: no i shift
    const void* rows;         // (B, 4, S-1)
    const void* knots;        // (S,)
    const long long* band;    // (N,)
    const bool* is_U;         // (N,)
    const bool* is_i;         // (N,)
    void* out;                // (W, N) compute type
    long long n_walkers;
    long long n_points;
    long long n_bands;
    long long n_knots;
    double t_ref;
};

// A load, through the read-only data path when LDG (global memory only).
template <bool LDG, typename T>
__device__ __forceinline__ T ld(const T* p) {
    if constexpr (LDG) return __ldg(p);
    else return *p;
}

// The first guess at the knot interval of x in [k_0, k_{S-1}]: (x - k_0)
// inv, inv = (S - 1) / (k_{S-1} - k_0) from a fast reciprocal, clipped to
// [0, S-2], in float (a NaN guess starts at 0): the interval of uniform
// knots up to its rounding (the SiFTO knots are whole days). The callers
// step from it against the neighbouring knots to the exact interval.
template <typename C>
__device__ __forceinline__ int knot_guess(C x, C k0, float inv, int S) {
    float g = (float)(x - k0) * inv;
    g = g > 0.0f ? g : 0.0f;
    g = g < (float)(S - 2) ? g : (float)(S - 2);
    return (int)g;
}

// knot_guess's scale, (S - 1) / (k_{S-1} - k_0), by a fast reciprocal.
template <typename C>
__device__ __forceinline__ float knot_inv(C k0, C k_end, int S) {
    return __fdividef((float)(S - 1), (float)(k_end - k0));
}

// An interval's cubic, its four coefficients side by side: in K8's staged
// table one vector load from shared memory (the (B, 4, S-1) rows would take
// four scalar loads a gather, each conflicting in the banks).
template <typename C>
struct alignas(4 * sizeof(C)) Cubic {
    C c3, c2, c1, c0;
};

// The SiFTO table where it lies: the S knots and a band's (4, S-1) row, read
// through the read-only path when LDG (global memory only).
template <typename C, bool LDG>
struct RowTable {
    const C* knots;
    const C* row;
    int M;   // S - 1
    __device__ __forceinline__ C lo(int i) const { return ld<LDG>(knots + i); }
    __device__ __forceinline__ C hi(int i) const { return ld<LDG>(knots + i + 1); }
    __device__ __forceinline__ Cubic<C> cubic(int i) const {
        return {ld<LDG>(row + i), ld<LDG>(row + M + i), ld<LDG>(row + 2 * M + i),
                ld<LDG>(row + 3 * M + i)};
    }
};

// The staged table (K8's staged form): the S knots, and cf[i] interval i's
// cubic of the point's band.
template <typename C>
struct StagedTable {
    const C* knots;
    const Cubic<C>* cf;
    __device__ __forceinline__ C lo(int i) const { return knots[i]; }
    __device__ __forceinline__ C hi(int i) const { return knots[i + 1]; }
    __device__ __forceinline__ Cubic<C> cubic(int i) const { return cf[i]; }
};

// K8's device function, on either table (lo(i) and hi(i) the knots that
// bound interval i, cubic(i) its coefficients; the knots read one at a
// time: a pair read at once costs the 64-register float32 CS log-posterior
// a stack frame): the SiFTO term at template phase x over the S knots, k0
// and k_end their ends and inv their knot_inv:
// searchsorted(side="right") - 1 clipped to [0, S-2], then a Horner cubic; 0
// outside [k0, k_end] and for a NaN phase (the JAX graph's NaN, then
// nan_to_num). The interval starts from knot_guess and steps against the
// neighbouring knots until k_i <= x < k_{i+1} (or an end): at most a step
// for uniform knots, at most S - 2 for any non-decreasing ones, the
// searchsorted interval exactly in every case, so the cubic and its bits are
// a binary search's. EXACT: the cubic's multiply-adds fused by hand in
// float64 (cs_point).
template <typename C, bool EXACT, typename Table>
__device__ __forceinline__ C sifto_eval(const Table& tab, int S, C k0, C k_end, float inv, C x) {
    if (!(x >= k0 && x <= k_end)) return C(0);
    int i = knot_guess(x, k0, inv, S);
    while (i > 0 && tab.lo(i) > x) --i;
    while (i < S - 2 && tab.hi(i) <= x) ++i;
    const C t = x - tab.lo(i);
    const Cubic<C> c = tab.cubic(i);
    const C v = EXACT && sizeof(C) == sizeof(double)
        ? fma(fma(fma(c.c3, t, c.c2), t, c.c1), t, c.c0)
        : ((c.c3 * t + c.c2) * t + c.c1) * t + c.c0;
    return isnan(v) ? C(0) : v;
}

// sifto_eval over the knots and a band's (4, S-1) row where they lie.
template <typename C, bool EXACT = false, bool LDG = false>
__device__ __forceinline__ C sifto_value(const C* knots, int S, const C* row, C x) {
    const C k0 = ld<LDG>(knots), k_end = ld<LDG>(knots + S - 1);
    return sifto_eval<C, EXACT>(RowTable<C, LDG>{knots, row, S - 1}, S, k0, k_end,
                                knot_inv(k0, k_end, S), x);
}

#define K8_WARPS 8   // warps a block, at most

// K8: out[w, n] = the SiFTO term of point n for walker w. A warp takes a
// walker at a time and a group of the points, its lanes over them (lane l:
// n0 + l, n0 + l + 32, ..., PTS of them, so a warp's stores fill
// neighbouring elements of a row of the output), the block's warps
// striding over the walkers and blockIdx.y over the groups: a lane forms
// its points' records once (the phase origin, the band's row, the walker
// shift the point takes: dti for an i point, else dtU for a U point), and
// each walker's four parameters are read and rounded to C once a lane, for
// its PTS points. STAGE: four points a lane (a group of 128), the knots and
// the rows (an interval's cubic together) staged in shared memory once per
// block, in a grid of the blocks resident at once; else
// one point a lane, so that few walkers still spread their points over
// warps and SMs (each point's walk and cubic a chain of dependent loads),
// the table read where it lies, through the read-only path
// (kernels/cs.py::k8_form).
template <typename C, bool STAGE>
__global__ void __launch_bounds__(32 * K8_WARPS) sifto_kernel(const SiftoParams P) {
    constexpr int PTS = STAGE ? 4 : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int S = (int)P.n_knots, M = S - 1;
    const C* rows = (const C*)P.rows;
    const C* knots = (const C*)P.knots;
    Cubic<C>* cf = reinterpret_cast<Cubic<C>*>(smem_raw);
    C* ks = reinterpret_cast<C*>(cf + P.n_bands * M);
    if constexpr (STAGE) {
        const int n_cf = (int)P.n_bands * M;
        for (int e = threadIdx.x; e < n_cf; e += blockDim.x) {
            const int b = e / M, i = e - b * M;
            const C* r = rows + (size_t)b * 4 * M + i;
            cf[e] = Cubic<C>{r[0], r[M], r[2 * M], r[3 * M]};
        }
        for (int i = threadIdx.x; i < S; i += blockDim.x) ks[i] = knots[i];
        __syncthreads();
    }
    const C k0 = __ldg(knots), k_end = __ldg(knots + M);
    const float inv = knot_inv(k0, k_end, S);
    const int N = (int)P.n_points, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    const long long W = P.n_walkers;
    C* out = (C*)P.out;
    for (int n0 = blockIdx.y * 32 * PTS; n0 < N; n0 += gridDim.y * 32 * PTS) {
        C tc[PTS];
        int row[PTS], shift[PTS];
#pragma unroll
        for (int k = 0; k < PTS; ++k) {
            const int n = n0 + lane + 32 * k;
            if (n >= N) continue;
            tc[k] = ((const C*)P.t_centered)[n];
            row[k] = (int)P.band[n] * M;
            shift[k] = P.dti != nullptr && P.is_i[n] ? 2 : (P.dtU != nullptr && P.is_U[n] ? 1 : 0);
        }
        for (long long w = (long long)blockIdx.x * warps + (threadIdx.x >> 5); w < W;
             w += (long long)gridDim.x * warps) {
            const C tpk = (C)(P.t_peak[w] - P.t_ref), s = (C)P.stretch[w];
            const C dU = P.dtU != nullptr ? (C)P.dtU[w] : C(0);
            const C di = P.dti != nullptr ? (C)P.dti[w] : C(0);
#pragma unroll
            for (int k = 0; k < PTS; ++k) {
                const int n = n0 + lane + 32 * k;
                if (n >= N) continue;
                const C dt = shift[k] == 2 ? di : (shift[k] == 1 ? dU : C(0));
                const C x = ((tc[k] - tpk) - dt) / s;
                C v;
                if constexpr (STAGE)
                    v = sifto_eval<C, false>(StagedTable<C>{ks, cf + row[k]}, S, k0, k_end, inv, x);
                else
                    v = sifto_eval<C, false>(RowTable<C, true>{knots, rows + (size_t)row[k] * 4, M},
                                             S, k0, k_end, inv, x);
                out[w * N + n] = v;
            }
        }
    }
}

template <typename C>
struct CSData {
    const long long* band;
    const C* coef;
    const C* tc;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    const C* s_a;
    const C* s_b;
    const C* rows;
    const C* knots;
    const bool* is_U;
    const bool* is_i;
    const bool* is_r;
};

template <typename C>
__host__ __device__ inline size_t cs_stage_bytes(const CSParams& P) {
    const size_t N = (size_t)P.n_points;
    return sizeof(long long) * N + 3 * N
           + sizeof(C) * (N * (size_t)(P.n_coef + 7)
                          + (size_t)(P.n_bands * 4 * (P.n_knots - 1) + P.n_knots));
}

// Copy the per-point constants, the SiFTO rows and knots into shared memory
// (every thread of the block takes part, so call it before any thread
// returns), or point at global memory when they exceed the block's limit.
template <typename C>
__device__ CSData<C> stage_cs(const CSParams& P, unsigned char* smem, int use_smem) {
    const long long N = P.n_points;
    CSData<C> d;
    if (use_smem) {
        long long* si = reinterpret_cast<long long*>(smem);
        d.band = stage_array(P.sifto_band, N, si);
        C* s = reinterpret_cast<C*>(si);
        d.coef = stage_array((const C*)P.coef, N * P.n_coef, s);
        d.tc = stage_array((const C*)P.t_centered, N, s);
        d.y = stage_array((const C*)P.y, N, s);
        d.inv_dy = stage_array((const C*)P.inv_dy, N, s);
        d.dy = stage_array((const C*)P.dy, N, s);
        d.su = stage_array((const C*)P.sigma_units, N, s);
        d.s_a = stage_array((const C*)P.s_a, N, s);
        d.s_b = stage_array((const C*)P.s_b, N, s);
        d.rows = stage_array((const C*)P.sifto_rows, P.n_bands * 4 * (P.n_knots - 1), s);
        d.knots = stage_array((const C*)P.sifto_knots, P.n_knots, s);
        bool* sb = reinterpret_cast<bool*>(s);
        d.is_U = stage_array(P.is_U, N, sb);
        d.is_i = stage_array(P.is_i, N, sb);
        d.is_r = stage_array(P.is_r, N, sb);
        __syncthreads();
    } else {
        d.band = P.sifto_band;
        d.coef = (const C*)P.coef;
        d.tc = (const C*)P.t_centered;
        d.y = (const C*)P.y;
        d.inv_dy = (const C*)P.inv_dy;
        d.dy = (const C*)P.dy;
        d.su = (const C*)P.sigma_units;
        d.s_a = (const C*)P.s_a;
        d.s_b = (const C*)P.s_b;
        d.rows = (const C*)P.sifto_rows;
        d.knots = (const C*)P.sifto_knots;
        d.is_U = P.is_U;
        d.is_i = P.is_i;
        d.is_r = P.is_r;
    }
    return d;
}

// The walker's constants of the CS log-likelihood at absolute parameters
// p[ndim]: CS1 (t_0, a13, Mc_v9_7, t_peak, s, rr, ri, rU), CS2 (t_0, a13,
// Mc_v9_7, t_peak, s, dtU, dti) or CS3 (t_0, a13, theta, t_peak, s, dtU,
// dti), then sigma with use_sigma. Every lane of a warp forms them on the
// same bits: the warp issues these instructions once whether one lane or 32
// run them, so computing them on lane 0 and broadcasting would only add the
// shuffles.
template <typename C>
struct CSWalker {
    double K;   // (a13^36 Mc) kappa^-35, float64
    C t_exp, t_peak, stretch, ln_k, kM, f_kasen, rU, rr, ri, dtU, dti, inv_yscale, sig;
};

template <typename C, int N = 0>
__device__ __forceinline__ CSWalker<C> cs_walker(const double* p, const CSParams& P) {
    CSWalker<C> w;
    const int ndim = N > 0 ? N : (int)P.ndim;
    const int variant = (int)P.variant;
    w.t_exp = (C)(p[0] - P.t_ref);
    w.t_peak = (C)(p[3] - P.t_ref);
    w.stretch = (C)p[4];
    const double Mc = variant == 3 ? 1.0 : p[2];
    // the walker constants of the Kasen power laws, in the JAX graph's order
    w.K = (pow(p[1], 36.0) * Mc) * P.kappa_m35;
    w.ln_k = w.K > 0.0 ? (C)log(w.K) : (C)(-INFINITY);
    w.kM = (C)P.kappa * (C)Mc;
    // the factors of the Kasen (f_kasen, and rU on U) and SiFTO (rr on r, ri
    // on i) terms, and the U and i time shifts
    w.f_kasen = C(1), w.rU = C(1), w.rr = C(1), w.ri = C(1), w.dtU = C(0), w.dti = C(0);
    if (variant == 1) {
        w.rr = (C)p[5];
        w.ri = (C)p[6];
        w.rU = (C)p[7];
    } else {
        w.dtU = (C)p[5];
        w.dti = (C)p[6];
    }
    if (variant == 3) {  // Brown et al. (2012) viewing angle, theta in degrees
        // cos(th) as cospi(theta / 180): exact argument reduction at any
        // theta, where cos's reduction of a large argument needs a 40-byte
        // local array (a stack frame in every kernel over this policy); the
        // multiply-adds by hand, so that every kernel rounds them alike
        const double th = p[2] * (3.141592653589793 / 180.0);
        w.f_kasen = (C)__dmul_rn(__fma_rn(0.5, cospi(p[2] / 180.0), 0.5),
                                 __dadd_rn(__fma_rn(0.14, __dmul_rn(th, th), __dmul_rn(-0.4, th)),
                                           1.0));
    }
    w.inv_yscale = (C)P.inv_yscale;
    w.sig = P.use_sigma ? (C)p[ndim - 1] : C(0);
    return w;
}

// Point n's residual term: the Kasen T and R, the Chebyshev band table's
// Clenshaw recurrence, K8's SiFTO value and the Gaussian residual. In
// float64 (X) the products that meet a sum are fused or rounded by hand, so
// that the two copies warp_batch_ll inlines (one walker a warp, a batch a
// warp) round alike, as sc2_forward's EXACT: left to the compiler they did
// not, and K6b's values at the states K6a accepted differed in last bits.
template <typename C>
__device__ __forceinline__ C cs_point(int n, const CSWalker<C>& w, const CSData<C>& d,
                                      const CSParams& P) {
    constexpr bool X = sizeof(C) == sizeof(double);
    const int K1 = (int)P.n_coef;
    const int S = (int)P.n_knots;
    const C tt = d.tc[n] - w.t_exp;
    C T;
    if (X) {
        T = C(25) * power0((C)w.K * power0(tt, C(-74)), C(1.0 / 144.0));
    } else {
        T = tt > C(0) ? C(25) * m_exp((w.ln_k - C(74) * m_log(tt)) * C(1.0 / 144.0)) : C(0);
    }
    const C R = C(2.7) * power0(w.kM * m_pow(tt, C(7)), C(1.0 / 9.0));
    C kasen = C(0);
    if (T > C(0)) {  // T <= 0 (t before t_exp) or NaN: zero flux (K1's loop)
        C s = X ? fma(m_log(T), d.s_a[n], -d.s_b[n]) : m_log(T) * d.s_a[n] - d.s_b[n];
        s = s < C(-1) ? C(-1) : (s > C(1) ? C(1) : s);  // clip, NaN stays NaN
        const C two_s = C(2) * s;
        const C* c = d.coef + (size_t)n * K1;
        C b1 = C(0), b2 = C(0);
        for (int k = K1 - 1; k >= 1; --k) {
            const C b0 = X ? add_rn(fma(two_s, b1, -b2), c[k]) : two_s * b1 - b2 + c[k];
            b2 = b1;
            b1 = b0;
        }
        const C ln_g = X ? add_rn(fma(s, b1, -b2), c[0]) : s * b1 - b2 + c[0];
        kasen = R * R * m_exp(ln_g);
    }
    const bool U = d.is_U[n], I = d.is_i[n];
    const C dt = U ? w.dtU : (I ? w.dti : C(0));
    const C arg = ((d.tc[n] - w.t_peak) - dt) / w.stretch;
    const C sif = sifto_value<C, X>(d.knots, S, d.rows + d.band[n] * 4 * (S - 1), arg);
    const C kf = U ? w.f_kasen * w.rU : w.f_kasen;
    const C sf = d.is_r[n] ? w.rr : (I ? w.ri : C(1));
    if (!X) {
        const C y_fit = (kasen * kf + sif * sf) * w.inv_yscale;
        return residual_term<C>(P.use_sigma, y_fit, d.y[n], d.inv_dy[n], d.dy[n], d.su[n],
                                w.sig);
    }
    const C y_fit = mul_rn(fma(kasen, kf, mul_rn(sif, sf)), w.inv_yscale);
    if (P.use_sigma) {
        const C sg = mul_rn(w.sig, d.su[n]);
        const C sigma2 = fma(d.dy[n], d.dy[n], mul_rn(sg, sg));
        const C res = sub_rn(d.y[n], y_fit);
        return add_rn(m_log(mul_rn((C)6.283185307179586, sigma2)),
                      div_rn(mul_rn(res, res), sigma2));
    }
    const C r = mul_rn(sub_rn(d.y[n], y_fit), d.inv_dy[n]);
    return mul_rn(r, r);
}

// The Gaussian log-likelihood (float64, -inf when not finite) of the walker
// with constants w (cs_walker's; the priors are not looked at), computed by
// the 32 lanes of a warp together (every lane returns the same bits): lane l
// takes the points l, l + 32, l + 64, ... in time order, sums its residual
// terms in that order, and a butterfly shuffle sums the lanes, a fixed order
// from run to run. CS points have equal loop lengths but for the walker's
// own skips (the Clenshaw recurrence before t_0, the SiFTO cubic outside
// the knots), which no static order evens out.
template <typename C>
__device__ double cs_log_likelihood_warp(const CSWalker<C>& w, const CSData<C>& d,
                                         const CSParams& P) {
    const int N = (int)P.n_points;
    C acc = C(0);
    for (int n = threadIdx.x & 31; n < N; n += 32) acc += cs_point<C>(n, w, d, P);
    return finish_log_likelihood<C>(warp_sum(acc), P.use_sigma, P.ll_offset, P.log_norm_const);
}

// The model policy of stretch.cuh and ladder.cuh for the companion-shocking
// models in compute type C.
template <typename C>
struct CSModel {
    typedef CSParams Params;
    typedef CSData<C> Data;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return cs_stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int) {
        return stage_cs<C>(P, smem, use_smem);
    }
};

// The policy of the CS batch log-posterior, half-step, K6a and K6b: a warp
// per walker (logpost_warp_kernel, stretch_half_step_kernel,
// tempered_half_step_kernel, ladder_init_kernel), 32 warps a
// block in float32 (one block an SM: the tables staged once an SM; 64
// registers a thread) and 16 in float64 (whose kernels need ~70), batched:
// the grid holds only the blocks resident at once, and a warp takes its
// walkers in batches whose prologues (the proposal, the prior and
// cs_walker's float64 constants, ~35% of a walker's time when every lane
// repeats them) run one walker a lane (warp_layout).
// N: the walker's dimension at compile time (policy_dim), or 0 (P.ndim).
// The batch log-posterior and K6b take N = 7, 8 or 9 (the variant's
// parameters and the intrinsic scatter), so that the walker's parameters
// live in registers; the half-steps keep N = 0, their code and bits
// unchanged.
template <typename C, int N>
struct CSWarpModel : CSModel<C> {
    typedef CSWalker<C> Walker;
    static constexpr int warps_per_block = sizeof(C) == sizeof(float) ? 32 : 16;
    static constexpr bool batched = true;
    static constexpr int ndim = N;
    static __device__ Walker walker(const double* p, const CSParams& P) {
        return cs_walker<C, N>(p, P);
    }
    static __device__ double log_likelihood_warp(const Walker& w, const CSData<C>& d,
                                                 const CSParams& P) {
        return cs_log_likelihood_warp<C>(w, d, P);
    }
};

template <typename C>
using CSWarpModelAnyDim = CSWarpModel<C, 0>;
template <typename C>
using CSWarpModel7 = CSWarpModel<C, 7>;
template <typename C>
using CSWarpModel8 = CSWarpModel<C, 8>;
template <typename C>
using CSWarpModel9 = CSWarpModel<C, 9>;

// ------------------------------------------------------------------ launch

// The staged K8 table's bytes: every band's cubics and the knots.
template <typename C>
static size_t sifto_stage_bytes(const SiftoParams& P) {
    return (size_t)(P.n_knots - 1) * P.n_bands * sizeof(Cubic<C>) + (size_t)P.n_knots * sizeof(C);
}

// K8's launch in the form `staged` (kernels/cs.py::k8_form; the direct form
// where the table would not fit in shared memory): the staged form's grid
// holds the blocks of K8_WARPS warps resident at once (resident_blocks,
// stretch.cuh), a block for every K8_WARPS walkers and, where the walkers
// leave blocks over (a few posterior draws over a dense grid), for every 128
// points; the direct form's a block for every K8_WARPS walkers (fewer warps
// for fewer walkers) and every 32 points.
template <typename C>
static int launch_sifto(const SiftoParams& P, int* staged, cudaStream_t stream) {
    const long long blocks = (P.n_walkers + K8_WARPS - 1) / K8_WARPS;
    const size_t bytes = sifto_stage_bytes<C>(P);
    *staged = *staged && bytes <= (size_t)smem_optin_limit();
    if (*staged) {
        auto kernel = sifto_kernel<C, true>;
        int use_smem = 0;
        int rc = smem_plan(kernel, bytes, &use_smem);
        if (rc) return rc;
        // the walkers' blocks first, the groups of 128 points on what is left
        const int resident = resident_blocks(kernel, 32 * K8_WARPS, bytes);
        const long long gx = blocks < resident ? blocks : resident;
        const long long groups = (P.n_points + 127) / 128, spare = resident / gx;
        const dim3 grid((unsigned)gx, (unsigned)(groups < spare ? groups : spare));
        kernel<<<grid, 32 * K8_WARPS, bytes, stream>>>(P);
    } else {
        const long long groups = (P.n_points + 31) / 32;
        const dim3 grid((unsigned)(blocks < 2147483647LL ? blocks : 2147483647LL),
                        (unsigned)(groups < 65535 ? groups : 65535));
        const int warps = (int)(P.n_walkers < K8_WARPS ? P.n_walkers : K8_WARPS);
        sifto_kernel<C, false><<<grid, 32 * warps, 0, stream>>>(P);
    }
    return (int)cudaGetLastError();
}

extern "C" {

// K8 launch, the rows staged once a block when `*staged`, else read where
// they lie; `*staged` is left 1 where the staged form ran (0 where its table
// would not fit in shared memory). Returns 0 or a cudaError_t code.
int sifto_launch(const SiftoParams* P, int device, int compute_f64, int* staged, void* stream) {
    int rc = (int)cudaSetDevice(device);
    if (rc) return rc;
    if (P->n_walkers <= 0 || P->n_points <= 0) return 0;
    if (P->n_knots < 2 || P->n_points > 2147483647LL || P->n_bands * P->n_knots > 2147483647LL)
        return (int)cudaErrorInvalidValue;   // (int indices: a point, a band's row)
    cudaStream_t s = (cudaStream_t)stream;
    return compute_f64 ? launch_sifto<double>(*P, staged, s)
                       : launch_sifto<float>(*P, staged, s);
}

// CS log-posterior launch, a warp per walker (logpost_warp_kernel over
// CSWarpModel of the walker's dimension, 7-9). Returns 0 or a cudaError_t
// code.
int cs_logpost_launch(const CSParams* P, int device, int compute_f64, const void* q, int q_f64,
                      int W, double* out, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    if (P->ndim == 7)
        return launch_logpost<CSWarpModel7>(P, device, compute_f64, q, q_f64, W, out, stream);
    if (P->ndim == 8)
        return launch_logpost<CSWarpModel8>(P, device, compute_f64, q, q_f64, W, out, stream);
    if (P->ndim == 9)
        return launch_logpost<CSWarpModel9>(P, device, compute_f64, q, q_f64, W, out, stream);
    return (int)cudaErrorInvalidValue;
}

// CS half-step launch, a warp per walker (CSWarpModel); the arguments of
// stretch_half_step_launch (sc2_logpost.cu). Returns 0 or a cudaError_t code.
int cs_half_step_launch(const CSParams* P, int device, int compute_f64, void* x, int state_f64,
                        double* logp, int half, int h, const void* u_z, const long long* j,
                        const void* u_acc, double a, void* chain_x, int chain_x_f64,
                        void* chain_lp, int chain_lp_f64, int* n_accept, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    return launch_half_step<CSWarpModelAnyDim>(P, device, compute_f64, x, state_f64, logp, half, h,
                                         u_z, j, u_acc, a, chain_x, chain_x_f64, chain_lp,
                                         chain_lp_f64, n_accept, stream);
}

// K6a launch over the CS models (ladder.cuh), a warp per walker
// (CSWarpModel). Returns 0 or a cudaError_t code.
int cs_tempered_half_step_launch(const CSParams* P, int device, int compute_f64, void* x,
                                 int state_f64, double* logpri, double* logl,
                                 const double* betas, int n_rungs, int half, int h,
                                 const void* u_z, const long long* j, const void* u_acc, double a,
                                 int* n_accept, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
    return launch_tempered_half_step<CSWarpModelAnyDim>(P, device, compute_f64, x,
                                                              state_f64, logpri, logl, betas,
                                                              n_rungs, half, h, u_z, j, u_acc, a,
                                                              n_accept, stream);
}

// K6b launch over the CS models (ladder.cuh), a warp per state (CSWarpModel
// of the walker's dimension, 7-9); the arguments of sc2_ladder_init_launch.
// Returns 0 or a cudaError_t code.
int cs_ladder_init_launch(const CSParams* P, int device, int compute_f64, const void* x,
                          int state_f64, int n, int per_set, int copies, double* logpri,
                          double* logl, void* stream) {
    if (P->n_knots < 2) return (int)cudaErrorInvalidValue;
#define LP_CS_INIT(M_)                                                                         \
    launch_ladder_init<M_>(P, device, compute_f64, x, state_f64, n, per_set, copies, logpri, \
                           logl, stream)
    if (P->ndim == 7) return LP_CS_INIT(CSWarpModel7);
    if (P->ndim == 8) return LP_CS_INIT(CSWarpModel8);
    if (P->ndim == 9) return LP_CS_INIT(CSWarpModel9);
#undef LP_CS_INIT
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
