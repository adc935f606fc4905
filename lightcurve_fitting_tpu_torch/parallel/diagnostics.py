"""Convergence diagnostics: split-R-hat (plain and rank-normalized) and
effective sample size, on host numpy arrays.

A copy of the JAX package's ``parallel/diagnostics.py`` (numpy and scipy
only, the same arithmetic, so the results are bit-identical), kept here so
the port imports nothing of that package. Standard checks (Gelman et al.
2013, BDA3 §11.4; Vehtari et al. 2021 for the rank-normalized bulk/tail
variant) on the (nsteps, nchains, ndim) chain layout of the samplers.
"""

import numpy as np

__all__ = ["split_rhat", "rank_normalized_split_rhat", "effective_sample_size",
           "summarize_chain"]


def split_rhat(chain):
    """Split-R-hat per parameter. ``chain``: (nsteps, nchains, ndim).
    Values near 1 (< 1.01 strict, < 1.1 loose) indicate convergence.

    Caveat: R-hat assumes *independent* chains. Stretch-move ensemble walkers
    are coupled (each proposal uses the complementary half), so the ensemble
    drifts coherently and R-hat over walkers reads high even when the pooled
    posterior is correct (verified against independent MH and across
    precisions/backends in the test suite). Use R-hat for HMC chains; for
    ensembles prefer ``EnsembleSampler.get_autocorr_time`` / ESS."""
    chain = np.asarray(chain, float)
    n, m, d = chain.shape
    half = n // 2
    halves = np.concatenate([chain[:half], chain[half:2 * half]], axis=1)  # (half, 2m, d)
    nn, mm = half, 2 * m
    means = halves.mean(axis=0)               # (2m, d)
    B = nn * means.var(axis=0, ddof=1)        # between-chain
    W = halves.var(axis=0, ddof=1).mean(axis=0)  # within-chain
    var_hat = (nn - 1) / nn * W + B / nn
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_hat / W)


def _rank_normalize(chain):
    """Pooled average ranks mapped through the normal quantile function
    (Vehtari+21 eq. 14, the Blom offset (r - 3/8)/(S + 1/4))."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    n, m, d = chain.shape
    r = rankdata(chain.reshape(n * m, d), method="average", axis=0)
    return ndtri((r - 0.375) / (n * m + 0.25)).reshape(n, m, d)


def rank_normalized_split_rhat(chain):
    """Rank-normalized split-R-hat, max of the bulk and tail variants
    (Vehtari, Gelman, Simpson, Carpenter & Buerkner 2021, Bayesian Analysis
    16, 667: their recommended replacement for plain R-hat — robust to
    heavy tails and to chains agreeing in mean but not in spread).

    ``chain``: (nsteps, nchains, ndim). Bulk: split-R-hat of the
    rank-normalized draws. Tail: the same on the draws folded about the
    pooled median (|x - median|), which exposes scale disagreement.
    Ranking pools all draws, so it commutes with the half-splitting done
    inside :func:`split_rhat`. The ensemble-coupling caveat on
    :func:`split_rhat` applies here identically."""
    chain = np.asarray(chain, float)
    bulk = split_rhat(_rank_normalize(chain))
    med = np.median(chain.reshape(-1, chain.shape[-1]), axis=0)
    tail = split_rhat(_rank_normalize(np.abs(chain - med)))
    return np.maximum(bulk, tail)


def effective_sample_size(chain, max_lag=None):
    """ESS per parameter via the initial-monotone-sequence autocorrelation
    estimator pooled across chains. ``chain``: (nsteps, nchains, ndim)."""
    chain = np.asarray(chain, float)
    n, m, d = chain.shape
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    ess = np.empty(d)
    for k in range(d):
        x = chain[:, :, k]
        x = x - x.mean(axis=0)
        # mean autocorrelation over chains via FFT
        nfft = 1
        while nfft < 2 * n:
            nfft <<= 1
        f = np.fft.rfft(x, n=nfft, axis=0)
        acf = np.fft.irfft(f * np.conjugate(f), n=nfft, axis=0)[:n].real
        alive = acf[0] > 0.0
        if not np.any(alive):
            # zero-variance (pinned/degenerate) parameter: no autocorrelation
            # to estimate — every draw is "independent", ESS = n*m
            ess[k] = n * m
            continue
        # pinned chains (zero variance) carry no autocorrelation information;
        # average the normalized ACF over the varying chains only
        acf = (acf[:, alive] / acf[0][alive]).mean(axis=1)
        # Geyer initial monotone positive sequence
        rho_sum = 0.0
        prev = np.inf
        for t in range(1, max_lag, 2):
            pair = acf[t] + (acf[t + 1] if t + 1 < n else 0.0)
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            rho_sum += pair
        ess[k] = n * m / (1.0 + 2.0 * rho_sum)
    return ess


def summarize_chain(chain, names=None):
    """Text summary: median, 68% interval, R-hat, ESS per parameter."""
    chain = np.asarray(chain, float)
    flat = chain.reshape(-1, chain.shape[-1])
    rhat = split_rhat(chain)
    ess = effective_sample_size(chain)
    lines = []
    for k in range(chain.shape[-1]):
        name = names[k] if names else f"p{k}"
        lo, med, hi = np.percentile(flat[:, k], [15.87, 50.0, 84.13])
        lines.append(f"{name:>12s}: {med:.5g} (+{hi - med:.3g}/-{med - lo:.3g})  "
                     f"R-hat={rhat[k]:.3f}  ESS={ess[k]:.0f}")
    return "\n".join(lines)
