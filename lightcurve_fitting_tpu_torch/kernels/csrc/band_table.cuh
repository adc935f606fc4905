// The band table's per-point data as the table-path kernels read it, and
// their staging: the Chebyshev rows of ln g_b(ln T), the affine s-map and the
// photometry of every point (ShockCooling2's kernels in sc2_logpost.cu, the
// ShockCooling and ShockCooling4 policies in sc_logpost.cu). A Params has
// the fields t_centered, y, inv_dy, dy, sigma_units, s_a, s_b, coef (the
// (N, n_coef) rows), n_points and n_coef.

#pragma once

#include "stretch.cuh"

template <typename C>
struct PointData {
    const C* tc;
    const C* y;
    const C* inv_dy;
    const C* dy;
    const C* su;
    const C* s_a;
    const C* s_b;
    const C* coef;
};

template <typename C, typename Params>
__host__ __device__ inline size_t stage_bytes(const Params& P) {
    return sizeof(C) * (size_t)P.n_points * (size_t)(P.n_coef + 7);
}

// Copy the per-point constants into shared memory (every thread of the block
// takes part, so call it before any thread returns), or point at global
// memory when the table is larger than the block's shared memory.
template <typename C, typename Params>
__device__ PointData<C> stage_points(const Params& P, C* smem, int use_smem) {
    PointData<C> d;
    const C* src[8] = {(const C*)P.coef, (const C*)P.t_centered, (const C*)P.y,
                       (const C*)P.inv_dy, (const C*)P.dy, (const C*)P.sigma_units,
                       (const C*)P.s_a, (const C*)P.s_b};
    const C* dst[8];
    const int N = (int)P.n_points;
    if (use_smem) {
        C* s = smem;
        for (int a = 0; a < 8; ++a) {
            const int len = a == 0 ? N * (int)P.n_coef : N;
            for (int i = threadIdx.x; i < len; i += blockDim.x) s[i] = src[a][i];
            dst[a] = s;
            s += len;
        }
        __syncthreads();
    } else {
        for (int a = 0; a < 8; ++a) dst[a] = src[a];
    }
    d.coef = dst[0];
    d.tc = dst[1];
    d.y = dst[2];
    d.inv_dy = dst[3];
    d.dy = dst[4];
    d.su = dst[5];
    d.s_a = dst[6];
    d.s_b = dst[7];
    return d;
}

// The clamped table coordinate s = clip(s_a ln T - s_b, -1, 1) of a point at
// T > 0 (NaN stays NaN), its product fused as K1's (sc2_forward's EXACT).
template <typename C>
__device__ __forceinline__ C table_s(C T, C s_a, C s_b) {
    const C s_raw = fma(m_log(T), s_a, -s_b);
    return s_raw < C(-1) ? C(-1) : (s_raw > C(1) ? C(1) : s_raw);
}

// ln g(s) of the Chebyshev row c[0 .. K-1] by Clenshaw's recurrence, each
// link fused and rounded by hand as K1's (sc2_forward's EXACT), so that
// every inlined copy gives the same bits. COLUMN: the row's coefficients
// lie stride apart, c[0], c[stride], ... (a column of a transposed table).
template <typename C, bool COLUMN = false>
__device__ __forceinline__ C table_ln_g(C s, const C* c, int K, int stride = 0) {
    const C two_s = C(2) * s;
    C b1 = C(0), b2 = C(0);
    for (int k = K - 1; k >= 1; --k) {
        const C b0 = add_rn(fma(two_s, b1, -b2), COLUMN ? c[(size_t)k * stride] : c[k]);
        b2 = b1;
        b1 = b0;
    }
    return add_rn(fma(s, b1, -b2), c[0]);
}

// table_ln_g at two coordinates of one row at once: the two recurrences
// interleaved, each link's coefficient read once for both. Each chain has
// table_ln_g's operations, so each result has its bits.
template <typename C, bool COLUMN = false>
__device__ __forceinline__ void table_ln_g2(C s1, C s2, const C* c, int K, C& g1, C& g2,
                                            int stride = 0) {
    const C t1 = C(2) * s1, t2 = C(2) * s2;
    C a1 = C(0), a2 = C(0), b1 = C(0), b2 = C(0);
    for (int k = K - 1; k >= 1; --k) {
        const C ck = COLUMN ? c[(size_t)k * stride] : c[k];
        const C a0 = add_rn(fma(t1, a1, -a2), ck);
        const C b0 = add_rn(fma(t2, b1, -b2), ck);
        a2 = a1;
        a1 = a0;
        b2 = b1;
        b1 = b0;
    }
    g1 = add_rn(fma(s1, a1, -a2), c[0]);
    g2 = add_rn(fma(s2, b1, -b2), c[0]);
}
