"""Chain-based predictive model comparison: WAIC and PSIS-LOO.

Beyond-reference capability (the reference offers no model-selection
machinery at all; its workflow ends at per-model fits, reference
fitting.py:16-168): these estimate the expected log pointwise predictive
density (elpd) of a fitted model directly from the posterior chain —
no tempered ladder required — following Vehtari, Gelman & Gabry (2017,
Stat. Comput. 27, 1413) and Zhang & Stephens (2009) for the generalized
Pareto tail fit.

The split of labor mirrors the rest of the stack: the (S draws x N points)
pointwise log-likelihood matrix is produced on device in one vmapped call
(fitting.information_criteria builds it with a cached compiled kernel); the
statistics here are O(S*N) host numpy on a matrix of a few hundred kB.

All functions take ``ll`` with shape (S, N): S posterior draws, N data
points, natural-log densities.
"""

import numpy as np

__all__ = ["waic", "psis_loo", "psis_logo", "compare_elpd", "stacking_weights"]


def _logsumexp(a, axis=None):
    amax = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - amax), axis=axis)) + np.squeeze(amax, axis=axis)
    return out


def waic(ll):
    """Widely applicable information criterion (Watanabe 2010; VGG17 eq. 2-5).

    lppd_i = log mean_s exp(ll_si); p_waic_i = var_s(ll_si);
    elpd_waic = sum_i (lppd_i - p_i), with the standard error from the
    pointwise spread (VGG17 eq. 23). Returns a dict with ``elpd_waic``,
    ``p_waic``, ``waic`` (= -2 elpd, deviance scale), ``se_elpd_waic``, and
    ``pointwise`` (the per-point elpd contributions, needed for paired model
    comparison).
    """
    ll = np.asarray(ll, float)
    S, N = ll.shape
    lppd_i = _logsumexp(ll, axis=0) - np.log(S)
    p_i = np.var(ll, axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    elpd = float(np.sum(elpd_i))
    se = float(np.sqrt(N * np.var(elpd_i, ddof=1))) if N > 1 else np.nan
    return {"elpd_waic": elpd, "p_waic": float(np.sum(p_i)),
            "waic": -2.0 * elpd, "se_elpd_waic": se, "pointwise": elpd_i}


def gpd_fit(x):
    """Fit a generalized Pareto distribution to exceedances ``x`` (> 0) by
    the Zhang & Stephens (2009) profile-posterior method with the weak
    (k ~ N(0.5) pseudo-observations) prior VGG17 Appendix C recommends for
    stabilizing small tails. Returns (k, sigma).

    Parameterization: CDF(x) = 1 - (1 + k x / sigma)^(-1/k), so k > 0 is a
    heavy tail and the PSIS reliability threshold is k < 0.7.
    """
    x = np.sort(np.asarray(x, float))
    n = len(x)
    if n < 5 or x[0] <= 0:
        return np.inf, np.nan
    # the fit is scale-equivariant: normalize by the largest exceedance so
    # denormal-tiny or huge weights cannot overflow the 1/x grid terms
    xmax = x[-1]
    x = x / xmax
    # ZS09 profile the likelihood over b = -k/sigma (their Sec. 4 grid,
    # built from the sample quartile and maximum; all b_j < 1/x_max keeps
    # 1 - b x positive). At fixed b the inner MLE is analytic:
    # k(b) = mean log(1 - b x) in OUR (tail-shape) sign convention.
    m = 30 + int(np.sqrt(n))
    j = np.arange(1, m + 1, dtype=float)
    x_quart = x[int(n / 4.0 + 0.5) - 1]
    # a denormal-tiny quartile (quartile exceedance ~0 relative to the max,
    # an extreme-contrast tail) overflows the 1/(3 x_quart) grid terms to
    # -inf; those grid points get log_lik = -inf below and drop out, so
    # silence the transient overflow/invalid warnings rather than leak them
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        b = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * x_quart)
        k_b = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    # profile log-likelihood n [log(-b/k) - k - 1]; -b/k > 0 on the grid
    # except the measure-zero b == 0 point (k == 0 there) — mask it out
    with np.errstate(divide="ignore", invalid="ignore"):
        log_lik = n * (np.log(-b / k_b) - k_b - 1.0)
    log_lik = np.where(np.isfinite(log_lik), log_lik, -np.inf)
    if not np.any(np.isfinite(log_lik)):
        return np.inf, np.nan
    # posterior-mean b under the implicit flat prior (normalized weights)
    w = np.exp(log_lik - log_lik.max())
    w /= w.sum()
    # restrict the mean to grid points with mass: a -inf b times its zero
    # weight would otherwise contribute nan, not 0
    live = w > 0.0
    # tripwire (the errstate blocks above silence transient overflow on the
    # dead grid points only): every live grid point must have a finite b
    assert np.isfinite(b[live]).all(), "non-finite b at a live grid point"
    b_hat = float(np.sum(b[live] * w[live]))
    k = float(np.mean(np.log1p(-b_hat * x)))
    sigma = float(-k / b_hat) * xmax
    # regularize k towards 0.5 with 10 pseudo-observations (VGG17 App. C)
    k = (n * k + 5.0) / (n + 10.0)
    return k, sigma


def _gpd_quantiles(p, k, sigma):
    """Inverse CDF of the generalized Pareto (same parameterization as
    :func:`gpd_fit`)."""
    p = np.asarray(p, float)
    if np.abs(k) < 1e-12:
        return sigma * (-np.log1p(-p))
    # very heavy fitted tails (large k) overflow the top quantile to inf;
    # psis_smooth truncates every smoothed weight at the raw maximum, so
    # the overflow is harmless — keep the warning from reaching users
    with np.errstate(over="ignore"):
        return (sigma / k) * (np.power(1.0 - p, -k) - 1.0)


def psis_smooth(lw):
    """Pareto-smooth one vector of log importance weights (VGG17 §3).

    The largest M = min(S/5, 3 sqrt(S)) weights are replaced by the order
    statistics of a generalized Pareto fit to their exceedances over the
    tail threshold, then the whole vector is truncated at the raw maximum.
    Returns (smoothed log-weights, normalized to logsumexp=0, and the tail
    shape estimate k-hat).
    """
    lw = np.asarray(lw, float)
    S = len(lw)
    lw = lw - lw.max()
    M = int(min(np.ceil(S / 5.0), np.ceil(3.0 * np.sqrt(S))))
    # NaN = "tail too small to estimate" (arviz semantics): it must NOT
    # read as reliable in `k > 0.7` checks, but a -inf sentinel would read
    # as CONFIDENTLY reliable, which is the opposite of the truth
    khat = np.nan
    if M >= 5:
        order = np.argsort(lw)
        cutoff = lw[order[-M - 1]]  # largest non-tail log-weight
        # fit and replace exactly the strict exceedances: weights tied at
        # the cutoff contribute zero exceedance and stay untouched (with
        # ties the effective tail is smaller than M)
        tail_idx = order[-M:]
        exceed = np.exp(lw[tail_idx]) - np.exp(cutoff)
        strict = exceed > 0
        tail_idx, exceed = tail_idx[strict], exceed[strict]
        m_eff = len(exceed)
        if m_eff >= 5:
            khat, sigma = gpd_fit(exceed)
            if np.isfinite(khat):
                # expected order statistics of the fitted tail
                pp = (np.arange(1, m_eff + 1) - 0.5) / m_eff
                repl = np.log(_gpd_quantiles(pp, khat, sigma) + np.exp(cutoff))
                # tail_idx is ascending in lw, pp ascending: ranks align
                lw[tail_idx] = np.minimum(repl, 0.0)  # truncate at raw max
    return lw - _logsumexp(lw), khat


def psis_loo(ll):
    """PSIS-LOO (VGG17): leave-one-out elpd by Pareto-smoothed importance
    sampling on the posterior draws.

    elpd_loo_i = log sum_s w_si exp(ll_si) with smoothed self-normalized
    weights w derived from lw_si = -ll_si. Returns a dict with
    ``elpd_loo``, ``p_loo`` (= lppd - elpd_loo), ``looic`` (= -2 elpd),
    ``se_elpd_loo``, ``pareto_k`` (per-point tail shapes; > 0.7 means the
    importance estimate for that point is unreliable, NaN means the chain
    was too short for a tail fit), and ``pointwise``.
    """
    ll = np.asarray(ll, float)
    S, N = ll.shape
    elpd_i = np.empty(N)
    khat = np.empty(N)
    for i in range(N):
        lw, k = psis_smooth(-ll[:, i])
        elpd_i[i] = _logsumexp(lw + ll[:, i])
        khat[i] = k
    lppd_i = _logsumexp(ll, axis=0) - np.log(S)
    elpd = float(np.sum(elpd_i))
    se = float(np.sqrt(N * np.var(elpd_i, ddof=1))) if N > 1 else np.nan
    return {"elpd_loo": elpd, "p_loo": float(np.sum(lppd_i - elpd_i)),
            "looic": -2.0 * elpd, "se_elpd_loo": se,
            "pareto_k": khat, "pointwise": elpd_i}


def psis_logo(ll, groups):
    """Leave-one-GROUP-out elpd via PSIS (the VGG17 machinery with joint
    importance ratios: dropping group g multiplies the ratios over its
    points, ``lw_s = -sum_{i in g} ll_si``).

    The astronomy-relevant cross-validation axis: pointwise LOO asks "can
    the model predict this one photometry point given the rest" — easy,
    because its bandmates at neighbouring epochs remain. Grouping by
    ``filter`` (or by epoch) asks "can the model predict a whole held-out
    band/epoch", which is what transferring a fit to an unobserved band
    actually requires. Larger groups give heavier importance tails — the
    per-group ``pareto_k`` reports when the estimate degrades (> 0.7).

    ``ll``: (S, N). ``groups``: length-N labels. Returns a dict with
    ``elpd_logo``, ``se_elpd_logo``, ``pointwise`` (per-group elpd, ordered
    by first appearance), ``pareto_k`` (per group), and ``groups`` (the
    label order). Singleton groups reproduce :func:`psis_loo` exactly.
    """
    ll = np.asarray(ll, float)
    groups = np.asarray(groups)
    if groups.shape != (ll.shape[1],):
        raise ValueError(f"groups must label each of the {ll.shape[1]} points "
                         f"(got shape {groups.shape})")
    _, first = np.unique(groups, return_index=True)
    labels = groups[np.sort(first)]                 # first-appearance order
    elpd_g = np.empty(len(labels))
    khat = np.empty(len(labels))
    for j, g in enumerate(labels):
        llg = ll[:, groups == g].sum(axis=1)        # joint group log density
        lw, k = psis_smooth(-llg)
        elpd_g[j] = _logsumexp(lw + llg)
        khat[j] = k
    G = len(labels)
    se = float(np.sqrt(G * np.var(elpd_g, ddof=1))) if G > 1 else np.nan
    return {"elpd_logo": float(np.sum(elpd_g)), "se_elpd_logo": se,
            "pointwise": elpd_g, "pareto_k": khat, "groups": labels}


def stacking_weights(pointwise_list, tol=1e-12, max_iter=100000):
    """Bayesian stacking of predictive distributions (Yao, Vehtari, Gabry &
    Gelman 2018, Bayesian Analysis 13, 917-1007).

    Finds the simplex weights ``w`` maximizing the stacked LOO score
    ``sum_i log sum_k w_k exp(elpd_ik)``, where ``elpd_ik`` is model k's
    pointwise LOO predictive density at point i (from :func:`psis_loo`).
    Unlike elpd ranking — which picks ONE model — stacking rewards
    *complementary* models: two misspecified models that each predict a
    different subset of the data well can both carry weight, and the
    stacked mixture then predicts better than either alone.

    The objective is concave on the simplex (log of an affine function),
    so the mixture-proportion EM fixed point ``w_k <- mean_i r_ki`` with
    responsibilities ``r_ki = w_k p_ki / sum_j w_j p_ji`` converges
    monotonically to the global optimum. Per-point densities are
    normalized by their column max first — the argmax is invariant and
    exp() then cannot underflow to an all-zero column.

    Returns ``w`` (shape (K,), sums to 1), aligned with the input order.
    """
    pw = [np.asarray(p, float) for p in pointwise_list]
    n = {len(p) for p in pw}
    if len(n) != 1:
        raise ValueError("models were scored on different numbers of points "
                         f"({sorted(n)}); stacking requires the same data")
    L = np.stack(pw)                              # (K, N)
    P = np.exp(L - L.max(axis=0, keepdims=True))  # column max -> 1
    K, N = P.shape
    w = np.full(K, 1.0 / K)
    prev = -np.inf
    for _ in range(max_iter):
        mix = w @ P                               # (N,)
        obj = float(np.sum(np.log(mix)))
        w = np.mean((w[:, None] * P) / mix[None, :], axis=1)
        if obj - prev <= tol * max(1.0, abs(obj)):
            break
        prev = obj
    return w / w.sum()


def compare_elpd(pointwise_list, labels):
    """Rank models by elpd with PAIRED difference standard errors.

    ``pointwise_list`` holds each model's per-point elpd contributions over
    the SAME N data points (from :func:`waic` or :func:`psis_loo`). The SE
    of an elpd difference uses the pointwise differences (VGG17 eq. 24) —
    much tighter than differencing two marginal SEs, because per-point
    difficulty is shared across models. Returns a list of dicts ranked
    best-first with ``label``, ``elpd``, ``d_elpd`` (vs best, <= 0),
    ``se_d_elpd``.
    """
    pw = [np.asarray(p, float) for p in pointwise_list]
    n = {len(p) for p in pw}
    if len(n) != 1:
        raise ValueError("models were scored on different numbers of points "
                         f"({sorted(n)}); elpd comparison requires the same data")
    N = n.pop()
    elpds = np.array([float(np.sum(p)) for p in pw])
    best = int(np.argmax(elpds))
    out = []
    for j in np.argsort(-elpds):
        diff = pw[j] - pw[best]
        if j == best:
            se = 0.0                        # d_elpd is identically 0
        elif N > 1:
            se = float(np.sqrt(N * np.var(diff, ddof=1)))
        else:
            se = float("nan")               # undefined variance, as in waic/psis_loo
        out.append({"label": labels[j], "elpd": float(elpds[j]),
                    "d_elpd": float(elpds[j] - elpds[best]), "se_d_elpd": se})
    return out
