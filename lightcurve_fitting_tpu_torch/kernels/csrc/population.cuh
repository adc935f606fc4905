// What the population kernels of every class share (population.cu over
// ShockCooling2, pop_sc.cu over ShockCooling and ShockCooling4): the
// parameter block, a transient's data and its staging along blockIdx.y, the
// population's finish of the residual sum, and the policy pieces that P1
// and P2 (stretch.cuh's warp and latency forms) read of every class.

#pragma once

#include "band_table.cuh"

// Every field is 8 bytes wide, so the layout has no padding and the ctypes
// mirror in kernels/pop.py (_PopParams) matches it field for field. The
// per-point arrays are (S, N) in the compute type, coef (S, N, n_coef).
struct PopParams {
    const void* t_centered;      // t - t_ref of the transient
    const void* y;               // y / yscale
    const void* inv_dy;          // yscale / dy, 0 on the padded points
    const void* dy;              // dy / yscale
    const void* sigma_units;     // the intrinsic scatter's units
    const void* s_a;
    const void* s_b;
    const void* coef;            // the Chebyshev rows
    const int* n_real;           // (S,): the real points, the first of the transient's row
    const double* t_ref;         // (S,)
    const double* inv_yscale;    // (S,)
    const double* log_norm;      // (S,)
    long long n_points;          // N, the padded row
    long long n_coef;
    long long ndim;
    long long n_model;           // the model's parameters (t_exp = 0 below the most)
    long long use_sigma;
    long long has_affine;
    double eps_T;                // ShockCooling2
    double eps_L;
    double a_model;              // every class
    double alpha;
    double c3_42;
    long long prior_kind[LP_MAX_DIM];
    double p_min[LP_MAX_DIM];
    double p_max[LP_MAX_DIM];
    double mean[LP_MAX_DIM];
    double stddev[LP_MAX_DIM];
    double affine_offset[LP_MAX_DIM];
    double affine_scale[LP_MAX_DIM];
    long long model;             // 0 ShockCooling2, 1 ShockCooling, 2 ShockCooling4
    double kappa;                // ShockCooling and ShockCooling4, SCParams' names
    double A;
    double eps1;                 // ShockCooling
    double eps2;
    double L0_42;
    double T0;
    double tph_to_tcol;
    double L_br_0_42;            // ShockCooling4
    double T_col_br_0;
    double t_br_0;
    double t_tr_0;
    double kappa_L;
    double kappa_T;
    double k_B;
};

// Transient e's rows as stage_points reads a parameter block.
struct PopRows {
    const void *t_centered, *y, *inv_dy, *dy, *sigma_units, *s_a, *s_b, *coef;
    long long n_points, n_coef;
};

// A transient's data as the points read them: its rows (staged or where
// they lie), its real points and its scalars.
template <typename C>
struct PopData {
    PointData<C> pts;
    int n_real;
    double t_ref;
    double log_norm;
    C inv_yscale;
};

// stage_points' copy of transient e's rows into shared memory, in its
// layout (the N x n_coef table, then the seven per-point arrays), each
// thread's loads issued before its stores: one round trip to the L2 for the
// block, where stage_points' array after array took eight (5000-5700 cycles
// of a P2 walker's 7.1 us, 2300-3800 this way; tools/probe_pop_latency.py).
// P1 and P2 stage so; P3, which stages once for 401 evaluations, keeps
// stage_points (this copy moved ptxas to spill in three of its
// instantiations).
#define POP_STAGE_UNROLL 4

template <typename C>
__device__ PointData<C> pop_stage_rows(const PopRows& R, C* smem, int use_smem) {
    if (!use_smem) return stage_points<C>(R, smem, 0);
    const int N = (int)R.n_points, NK = N * (int)R.n_coef, total = NK + 7 * N;
    for (int b = threadIdx.x; b < total; b += POP_STAGE_UNROLL * blockDim.x) {
        C v[POP_STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < POP_STAGE_UNROLL; ++u) {
            const int i = b + u * blockDim.x;
            if (i < NK) {
                v[u] = ((const C*)R.coef)[i];
            } else if (i < total) {
                const int a = (i - NK) / N;   // (a select, not an indexed array: no stack)
                const void* row = a == 0 ? R.t_centered : a == 1 ? R.y : a == 2 ? R.inv_dy
                                : a == 3 ? R.dy : a == 4 ? R.sigma_units : a == 5 ? R.s_a : R.s_b;
                v[u] = ((const C*)row)[i - NK - a * N];
            }
        }
#pragma unroll
        for (int u = 0; u < POP_STAGE_UNROLL; ++u) {
            const int i = b + u * blockDim.x;
            if (i < total) smem[i] = v[u];
        }
    }
    __syncthreads();
    PointData<C> d;
    d.coef = smem;
    d.tc = smem + NK;
    d.y = d.tc + N;
    d.inv_dy = d.y + N;
    d.dy = d.inv_dy + N;
    d.su = d.dy + N;
    d.s_a = d.su + N;
    d.s_b = d.s_a + N;
    return d;
}

// Transient e's data; its rows staged by pop_stage_rows (ONE_TRIP) or
// stage_points.
template <typename C, bool ONE_TRIP = true>
__device__ PopData<C> pop_stage(const PopParams& P, unsigned char* smem, int use_smem, int e) {
    const size_t N = (size_t)P.n_points, off = (size_t)e * N;
    PopRows R;
    R.t_centered = (const C*)P.t_centered + off;
    R.y = (const C*)P.y + off;
    R.inv_dy = (const C*)P.inv_dy + off;
    R.dy = (const C*)P.dy + off;
    R.sigma_units = (const C*)P.sigma_units + off;
    R.s_a = (const C*)P.s_a + off;
    R.s_b = (const C*)P.s_b + off;
    R.coef = (const C*)P.coef + off * (size_t)P.n_coef;
    R.n_points = P.n_points;
    R.n_coef = P.n_coef;
    PopData<C> d;
    d.pts = ONE_TRIP ? pop_stage_rows<C>(R, reinterpret_cast<C*>(smem), use_smem)
                 : stage_points<C>(R, reinterpret_cast<C*>(smem), use_smem);
    d.n_real = P.n_real[e];
    d.t_ref = P.t_ref[e];
    d.log_norm = P.log_norm[e];
    d.inv_yscale = (C)P.inv_yscale[e];
    return d;
}

// The population's log L from the residual sum acc in the compute type:
// -0.5 acc, plus log_norm in float64 without the intrinsic scatter; -inf
// when not finite.
template <typename C>
__device__ __forceinline__ double pop_finish(C acc, bool use_sigma, double log_norm) {
    const C half = C(-0.5) * acc;
    const double ll = use_sigma ? (double)half : (double)half + log_norm;
    return isfinite(ll) ? ll : -INFINITY;
}

// Bring the line of p into the SM's L1 (a generic address).
__device__ __forceinline__ void pop_prefetch(const void* p) {
    asm volatile("prefetch.L1 [%0];" ::"l"(p));
}

// The policy pieces of P1 and P2 that every class shares (stretch.cuh): a
// warp per walker, batched, the transient e of a block staged from its rows;
// with a class's point_term and add_term, P1's and P2's latency forms, a
// sum over the transient's n_real real points finished by pop_finish, each
// thread first prefetching its point's data. 16 warps a block at most: a
// transient's rows are small, and at S = 512 x 64 walkers P1 over
// ShockCooling2 took 0.065 ms of device time at 16 against 0.108 at 32
// (PERF.md §6). N: the walker's dimension at compile time. A class's
// policy adds Walker, walker (a walker's constants that do not depend on the
// transient: t_exp stays absolute), log_likelihood_warp, point_term and
// add_term.
template <typename C, int N>
struct PopTableModel {
    typedef PopParams Params;
    typedef PopData<C> Data;
    typedef C Compute;
    static constexpr int warps_per_block = 16;
    static constexpr bool batched = true;
    static constexpr int ndim = N;
    static __host__ __device__ size_t stage_bytes(const Params& P) {
        return ::stage_bytes<C>(P);
    }
    static __device__ Data stage(const Params& P, unsigned char* smem, int use_smem, int e) {
        return pop_stage<C>(P, smem, use_smem, e);
    }
    static __device__ int n_terms(const Data& d, const Params&) { return d.n_real; }
    static __device__ double finish(C acc, const Data& d, const Params& P) {
        return pop_finish<C>(acc, P.use_sigma != 0, d.log_norm);
    }
    static __device__ void prefetch(int n, const Data& d, const Params& P) {
        const PointData<C>& q = d.pts;
        const C* row = q.coef + (size_t)n * P.n_coef;
        pop_prefetch(q.tc + n);
        pop_prefetch(q.y + n);
        pop_prefetch(q.inv_dy + n);
        pop_prefetch(q.s_a + n);
        pop_prefetch(q.s_b + n);
        pop_prefetch(row);
        pop_prefetch(row + P.n_coef - 1);
        if (P.use_sigma) {
            pop_prefetch(q.dy + n);
            pop_prefetch(q.su + n);
        }
    }
};
