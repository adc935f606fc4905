// The MAP ascents' Adam step in the unbounded space of the bounds
// bijection, shared by K4p (epoch_bb.cu) and P3 (population.cu). A Q has
// the fields kind, lo, hi, width (BoundsTransform.kernel_spec,
// parallel/hmc.py), b1, b2, one_minus_b1, one_minus_b2 and eps (optax's
// adam, parallel/optimize.py), each a parameter's or a scalar.

#pragma once

// x = the bounds bijection of u[N] (BoundsTransform.to_bounded, operation
// for operation), and f[N], the factor its derivative is formed from: the
// sigmoid s (two-sided), exp(u) (one-sided), else 1.
template <int N, typename Q_>
__device__ __forceinline__ void adam_bounded(const Q_& Q, const double* u, double* x,
                                             double* f) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        if (Q.kind[k] == 1) {
            f[k] = 1.0 / (1.0 + exp(-u[k]));
            x[k] = __dadd_rn(Q.lo[k], __dmul_rn(Q.width[k], f[k]));
        } else if (Q.kind[k] == 2 || Q.kind[k] == 3) {
            f[k] = exp(u[k]);
            x[k] = Q.kind[k] == 2 ? __dadd_rn(Q.lo[k], f[k]) : __dsub_rn(Q.hi[k], f[k]);
        } else {
            f[k] = 1.0;
            x[k] = u[k];
        }
    }
}

// One CosineAdam step of u[N] (optimize.py:CosineAdam.step, the same
// operations, none contracted) from g[N], the gradient of the log-posterior
// at x = the bijection of u, and its factors f[N] (adam_bounded): the chain
// rule into the gradient of -lp in u, as autograd runs it through
// BoundsTransform.to_bounded, a non-finite component 0; then the moments m,
// v and the step with the host's scalars of the step: the learning rate lr
// and the bias corrections c1, c2.
template <int N, typename Q_>
__device__ __forceinline__ void adam_step(const Q_& Q, const double* g, const double* f,
                                          double lr, double c1, double c2, double* u, double* m,
                                          double* v) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const double gn = -g[k];   // d(-lp)/dx
        double gu = gn;
        if (Q.kind[k] == 1)
            gu = __dmul_rn(__dmul_rn(__dmul_rn(gn, Q.width[k]), __dsub_rn(1.0, f[k])), f[k]);
        else if (Q.kind[k] == 2)
            gu = __dmul_rn(gn, f[k]);
        else if (Q.kind[k] == 3)
            gu = __dmul_rn(-gn, f[k]);
        if (!isfinite(gu)) gu = 0.0;
        m[k] = __dadd_rn(__dmul_rn(Q.one_minus_b1, gu), __dmul_rn(Q.b1, m[k]));
        v[k] = __dadd_rn(__dmul_rn(Q.one_minus_b2, __dmul_rn(gu, gu)), __dmul_rn(Q.b2, v[k]));
        const double mh = __ddiv_rn(m[k], c1);
        const double vh = __ddiv_rn(v[k], c2);
        u[k] = __dadd_rn(u[k], __dmul_rn(-lr, __ddiv_rn(mh, __dadd_rn(__dsqrt_rn(vh), Q.eps))));
    }
}
