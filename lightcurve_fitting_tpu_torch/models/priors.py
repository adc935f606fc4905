"""Prior probability distributions (reference models.py:1048-1098), usable both
host-side (numpy or Python scalars) and on tensors: out-of-bounds parameters
map to -inf via ``where`` masking instead of Python branching, so the same
objects work on a batch of walkers.

The fused kernels (``kernels/csrc/``) evaluate the three closed-form priors
from :meth:`Prior.kernel_spec`; any other prior runs on the plain (CPU) path
only. :class:`KDEPrior` (kind 3) is evaluated on CUDA by the SED kernel K10
alone (``kernels/sed.py``); the other kernels refuse it (ROADMAP Queue 1
item 21).
"""

import numpy as np
import torch

__all__ = ["Prior", "UniformPrior", "LogUniformPrior", "GaussianPrior", "KDEPrior"]


def _as_tensor(p):
    return p if torch.is_tensor(p) else torch.as_tensor(np.asarray(p, float))


class Prior:
    #: kernel code of the prior's log-density (see kernel_spec)
    kind = None

    def __init__(self, p_min=-np.inf, p_max=np.inf):
        self.p_min = p_min
        self.p_max = p_max

    def __call__(self, p):
        p = _as_tensor(p)
        in_bounds = (p > self.p_min) & (p < self.p_max)
        # evaluate logp on a value guaranteed in-domain to avoid NaN (e.g. log of
        # a negative number), then mask
        safe_p = torch.where(in_bounds, p, torch.full_like(p, self._safe_point()))
        return torch.where(in_bounds, self.logp(safe_p), torch.full_like(p, -torch.inf))

    def _safe_point(self):
        lo = self.p_min if np.isfinite(self.p_min) else 0.0
        hi = self.p_max if np.isfinite(self.p_max) else lo + 2.0
        return 0.5 * (lo + hi) if hi > lo else lo + 1.0

    def logp(self, p):
        raise NotImplementedError

    def kernel_spec(self):
        """(kind, p_min, p_max, mean, stddev) for the fused kernel: kind 0 is
        uniform, 1 log-uniform, 2 Gaussian, 3 the KDE prior (its components
        travel beside the spec: :class:`KDEPrior`); every kernel takes kinds
        0-2, the SED kernel K10 also kind 3."""
        if self.kind is None:
            raise NotImplementedError(
                f"{self.__class__.__name__} has no CUDA kernel form: the kernels take the "
                "uniform, log-uniform and Gaussian priors only (kinds 0-2); run other priors "
                'with device="cpu"')
        return (self.kind, float(self.p_min), float(self.p_max),
                float(getattr(self, "mean", 0.0)), float(getattr(self, "stddev", 1.0)))

    def sample(self, rng, size=None):
        """Draw from the (normalized) prior with a host numpy Generator:
        exact inverse-CDF draws where analytic, rejection against the bounds
        otherwise."""
        raise NotImplementedError(
            f"{self.__class__.__name__} does not implement sampling")

    def _rejection_sample(self, rng, size, propose):
        """Draw ``propose(n)`` until all lie strictly inside the bounds."""
        n = 1 if size is None else int(np.prod(size))
        out = np.empty(n)
        filled = 0
        for _ in range(1000):
            cand = np.asarray(propose(max(n - filled, 16)))
            cand = cand[(cand > self.p_min) & (cand < self.p_max)]
            take = min(len(cand), n - filled)
            out[filled:filled + take] = cand[:take]
            filled += take
            if filled == n:
                return float(out[0]) if size is None else out.reshape(size)
        raise RuntimeError(f"{self!r}: rejection sampling failed to find "
                           "in-bounds draws (bounds far in the tail?)")

    def __repr__(self):
        return f"<{self.__class__.__name__}: ({self.p_min}, {self.p_max})>"


class UniformPrior(Prior):
    """dP/dp ∝ 1"""

    kind = 0

    def logp(self, p):
        return torch.zeros_like(_as_tensor(p))

    def sample(self, rng, size=None):
        if not (np.isfinite(self.p_min) and np.isfinite(self.p_max)):
            raise ValueError("cannot sample an unbounded uniform prior")
        return rng.uniform(self.p_min, self.p_max, size=size)


class LogUniformPrior(Prior):
    """dP/dp ∝ 1/p"""

    kind = 1

    def __init__(self, p_min=0.0, p_max=np.inf):
        if p_min < 0.0:
            raise ValueError("a log-uniform prior cannot have negative limits")
        super().__init__(p_min, p_max)

    def logp(self, p):
        return -torch.log(_as_tensor(p))

    def sample(self, rng, size=None):
        if not (self.p_min > 0.0 and np.isfinite(self.p_max)):
            raise ValueError("cannot sample a log-uniform prior with "
                             "p_min <= 0 or infinite p_max")
        return np.exp(rng.uniform(np.log(self.p_min), np.log(self.p_max),
                                  size=size))


class GaussianPrior(Prior):
    """dP/dp ∝ exp(-(p-mean)^2 / (2 stddev^2))"""

    kind = 2

    def __init__(self, p_min=-np.inf, p_max=np.inf, mean=0.0, stddev=1.0):
        super().__init__(p_min, p_max)
        self.mean = mean
        self.stddev = stddev

    def logp(self, p):
        return -0.5 * ((_as_tensor(p) - self.mean) / self.stddev) ** 2.0

    def _safe_point(self):
        return self.mean

    def sample(self, rng, size=None):
        return self._rejection_sample(
            rng, size, lambda n: rng.normal(self.mean, self.stddev, size=n))

    def __repr__(self):
        return (f"<GaussianPrior: {self.mean} +/- {self.stddev} on "
                f"({self.p_min}, {self.p_max})>")


class KDEPrior(Prior):
    """Gaussian kernel density estimate of a posterior sample, used to chain the
    previous epoch's temperature posterior into single-filter epochs
    (reference bolometric.py:753-759 uses ``scipy.stats.gaussian_kde``).

    Scott's-rule bandwidth, matching scipy's default. Subsamples to
    ``max_components`` (without replacement, ``default_rng(seed)``) so the
    log-density is a logsumexp over at most that many components. The host
    arithmetic is the JAX package's, so the components, the bandwidth and
    ``_lognorm`` are its bits.
    """

    kind = 3

    def __init__(self, samples, p_min=-np.inf, p_max=np.inf, max_components=512, seed=0):
        super().__init__(p_min, p_max)
        samples = np.asarray(samples, float).ravel()
        if len(samples) > max_components:
            rng = np.random.default_rng(seed)
            samples = rng.choice(samples, size=max_components, replace=False)
        self.samples = samples
        n = len(samples)
        factor = n ** (-1.0 / 5.0)  # Scott's rule, d=1
        self.bandwidth = float(np.std(samples, ddof=1) * factor)
        self._lognorm = float(np.log(n) + np.log(self.bandwidth) + 0.5 * np.log(2 * np.pi))
        self._on = {}

    @classmethod
    def from_components(cls, samples, bandwidth, lognorm, p_min=-np.inf, p_max=np.inf):
        """A KDE prior with the given components, bandwidth and log
        normalization as they are (no subsampling, nothing recomputed): the
        copy of another package's KDE prior."""
        self = cls.__new__(cls)
        Prior.__init__(self, p_min, p_max)
        self.samples = np.asarray(samples, float).ravel().copy()
        self.bandwidth = float(bandwidth)
        self._lognorm = float(lognorm)
        self._on = {}
        return self

    def components(self, device):
        """The components as a float64 tensor on ``device`` (kept per
        device: K10 reads them by address)."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.samples, dtype=torch.float64,
                                            device=device).contiguous()
        return self._on[key]

    def kernel_spec(self):
        return (self.kind, float(self.p_min), float(self.p_max), 0.0, self.bandwidth)

    def logp(self, p):
        p = _as_tensor(p)
        z = (p[..., None] - self.components(p.device)) / self.bandwidth
        return torch.logsumexp(-0.5 * z ** 2, dim=-1) - self._lognorm

    def sample(self, rng, size=None):
        comp = np.asarray(self.samples)

        def propose(n):
            return (rng.choice(comp, size=n)
                    + self.bandwidth * rng.normal(size=n))

        return self._rejection_sample(rng, size, propose)
