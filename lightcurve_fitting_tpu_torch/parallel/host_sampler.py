"""Pure-numpy stretch-move sampler (a copy of the JAX package's
``parallel/host_sampler.py``, bit for bit): the host path for log-posteriors
that no kernel of the port evaluates (arbitrary user spectrum functions
passed to ``bolometric.spectrum_mcmc``, reference bolometric.py:87-97). Same
Goodman-Weare algorithm and API subset as the device sampler."""

import numpy as np

__all__ = ["HostEnsembleSampler"]


class HostEnsembleSampler:
    def __init__(self, nwalkers, ndim, log_prob_fn, a=2.0, seed=None):
        if nwalkers % 2:
            raise ValueError("nwalkers must be even")
        self.nwalkers = nwalkers
        self.ndim = ndim
        self.a = a
        self.log_prob_fn = log_prob_fn
        self._rng = np.random.default_rng(seed)
        self.reset()

    def reset(self):
        self._chain = np.empty((0, self.nwalkers, self.ndim))
        self._logp = np.empty((0, self.nwalkers))
        self._accepted = np.zeros(self.nwalkers)
        self._nsteps = 0

    def run_mcmc(self, initial_state, nsteps, skip_initial_state_check=False, **kwargs):
        if initial_state is None:
            if not hasattr(self, "_pos"):
                # same error contract as EnsembleSampler
                raise ValueError("no previous state; provide initial_state")
            x = self._pos
            logp = self._pos_logp
        else:
            x = np.array(initial_state, float)
            logp = np.array([self.log_prob_fn(p) for p in x])
            if not skip_initial_state_check and not np.all(np.isfinite(logp)):
                raise ValueError("non-finite initial log-probability")
        half = self.nwalkers // 2
        chain = np.empty((nsteps, self.nwalkers, self.ndim))
        logps = np.empty((nsteps, self.nwalkers))
        for step in range(nsteps):
            for first in (0, 1):
                sel = slice(0, half) if first == 0 else slice(half, None)
                oth = slice(half, None) if first == 0 else slice(0, half)
                z = ((self.a - 1.0) * self._rng.uniform(size=half) + 1.0) ** 2 / self.a
                j = self._rng.integers(0, half, size=half)
                x_j = x[oth][j]
                y = x_j + z[:, None] * (x[sel] - x_j)
                logp_y = np.array([self.log_prob_fn(p) for p in y])
                logp_y = np.where(np.isnan(logp_y), -np.inf, logp_y)
                log_ratio = (self.ndim - 1.0) * np.log(z) + logp_y - logp[sel]
                accept = np.log(self._rng.uniform(size=half)) < log_ratio
                x[sel] = np.where(accept[:, None], y, x[sel])
                logp[sel] = np.where(accept, logp_y, logp[sel])
                self._accepted[sel] += accept
            chain[step] = x
            logps[step] = logp
        self._chain = np.concatenate([self._chain, chain])
        self._logp = np.concatenate([self._logp, logps])
        self._nsteps += nsteps
        self._pos = x
        self._pos_logp = logp
        return x.copy(), logp.copy(), None

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self.ndim)

    @property
    def acceptance_fraction(self):
        return self._accepted / max(self._nsteps, 1)
