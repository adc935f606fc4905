// The MAP ascents' Adam step in the unbounded space of the bounds
// bijection, shared by K4p (epoch_bb.cu) and P3 (population.cu). A Q has
// the fields kind, lo, hi, width (BoundsTransform.kernel_spec,
// parallel/hmc.py), b1, b2, one_minus_b1, one_minus_b2 and eps (optax's
// adam, parallel/optimize.py), each a parameter's or a scalar.

#pragma once

// x = the bounds bijection of u, dimension k (BoundsTransform.to_bounded,
// operation for operation), and f, the factor its derivative is formed
// from: the sigmoid s (two-sided), exp(u) (one-sided), else 1.
template <typename Q_>
__device__ __forceinline__ double adam_bounded_k(const Q_& Q, int k, double u, double& f) {
    if (Q.kind[k] == 1) {
        f = 1.0 / (1.0 + exp(-u));
        return __dadd_rn(Q.lo[k], __dmul_rn(Q.width[k], f));
    }
    if (Q.kind[k] == 2 || Q.kind[k] == 3) {
        f = exp(u);
        return Q.kind[k] == 2 ? __dadd_rn(Q.lo[k], f) : __dsub_rn(Q.hi[k], f);
    }
    f = 1.0;
    return u;
}

// adam_bounded_k of every dimension of u[N] into x[N] and f[N].
template <int N, typename Q_>
__device__ __forceinline__ void adam_bounded(const Q_& Q, const double* u, double* x,
                                             double* f) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = adam_bounded_k(Q, k, u[k], f[k]);
}

// One CosineAdam step of dimension k of u (optimize.py:CosineAdam.step, the
// same operations, none contracted) from g, that dimension of the gradient
// of the log-posterior at x = the bijection of u, and its factor f
// (adam_bounded_k): the chain rule into the gradient of -lp in u, as
// autograd runs it through BoundsTransform.to_bounded, 0 where it is not
// finite; then the moments m, v and the step with the host's scalars of
// the step: the learning rate lr and the bias corrections c1, c2.
template <typename Q_>
__device__ __forceinline__ void adam_step_k(const Q_& Q, int k, double g, double f, double lr,
                                            double c1, double c2, double& u, double& m,
                                            double& v) {
    const double gn = -g;   // d(-lp)/dx
    double gu = gn;
    if (Q.kind[k] == 1)
        gu = __dmul_rn(__dmul_rn(__dmul_rn(gn, Q.width[k]), __dsub_rn(1.0, f)), f);
    else if (Q.kind[k] == 2)
        gu = __dmul_rn(gn, f);
    else if (Q.kind[k] == 3)
        gu = __dmul_rn(-gn, f);
    if (!isfinite(gu)) gu = 0.0;
    m = __dadd_rn(__dmul_rn(Q.one_minus_b1, gu), __dmul_rn(Q.b1, m));
    v = __dadd_rn(__dmul_rn(Q.one_minus_b2, __dmul_rn(gu, gu)), __dmul_rn(Q.b2, v));
    const double mh = __ddiv_rn(m, c1);
    const double vh = __ddiv_rn(v, c2);
    u = __dadd_rn(u, __dmul_rn(-lr, __ddiv_rn(mh, __dadd_rn(__dsqrt_rn(vh), Q.eps))));
}

// adam_step_k of every dimension of u[N], m[N], v[N] from g[N] and f[N].
template <int N, typename Q_>
__device__ __forceinline__ void adam_step(const Q_& Q, const double* g, const double* f,
                                          double lr, double c1, double c2, double* u, double* m,
                                          double* v) {
#pragma unroll
    for (int k = 0; k < N; ++k) adam_step_k(Q, k, g[k], f[k], lr, c1, c2, u[k], m[k], v[k]);
}
