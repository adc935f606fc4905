"""The bounds bijection of the JAX package's ``parallel/hmc.py``, on tensors.

Only :class:`BoundsTransform` is ported: the batched MAP centering of the
bolometric path (:func:`..parallel.batched.batched_map_centers`) ascends the
posterior in its unbounded space. The HMC sampler itself waits for ROADMAP
Queue 1 item 14.
"""

import numpy as np
import torch

__all__ = ["BoundsTransform"]


class BoundsTransform:
    """Bijection between a box-constrained parameter space and R^n,
    Stan-style: two-sided bounds map through a scaled sigmoid, one-sided
    through exp, unbounded through identity; ``log_jacobian`` gives the
    pushforward's correction.

    The masks are static (numpy), and the unused branches are evaluated on
    sanitized values (double-where), so gradients stay free of NaN. The
    tensor methods broadcast over any leading shape of ``(..., n)``."""

    def __init__(self, lower, upper):
        lower = np.asarray(lower, float)
        upper = np.asarray(upper, float)
        self.lower = lower
        self.upper = upper
        self.two_sided = np.isfinite(lower) & np.isfinite(upper)
        self.lower_only = np.isfinite(lower) & ~np.isfinite(upper)
        self.upper_only = ~np.isfinite(lower) & np.isfinite(upper)
        self.one_sided = self.lower_only | self.upper_only
        # sanitized bounds for the unused branches
        self._lo2 = np.where(self.two_sided, lower, 0.0)
        self._hi2 = np.where(self.two_sided, upper, 1.0)
        self._width = self._hi2 - self._lo2
        self._lo1 = np.where(self.lower_only, lower, 0.0)
        self._hi1 = np.where(self.upper_only, upper, 0.0)

    def _t(self, a, like):
        return torch.as_tensor(a, device=like.device,
                               dtype=like.dtype if a.dtype != bool else torch.bool)

    def to_bounded(self, u):
        """u in R^n -> x in the box."""
        t = self._t
        two, one = t(self.two_sided, u), t(self.one_sided, u)
        zero = torch.zeros_like(u)
        s = torch.sigmoid(torch.where(two, u, zero))
        e = torch.exp(torch.where(one, u, zero))
        x2 = t(self._lo2, u) + t(self._width, u) * s
        x_lo = t(self._lo1, u) + e
        x_hi = t(self._hi1, u) - e
        return torch.where(two, x2, torch.where(t(self.lower_only, u), x_lo,
                                                torch.where(t(self.upper_only, u), x_hi, u)))

    def log_jacobian(self, u):
        """log |dx/du| summed over the last axis."""
        t = self._t
        two = t(self.two_sided, u)
        zero = torch.zeros_like(u)
        s = torch.sigmoid(torch.where(two, u, zero))
        lj_two = torch.log(torch.where(two, t(self._width, u), torch.ones_like(u))) \
            + torch.where(two, torch.log(s) + torch.log1p(-s), zero)
        lj_one = torch.where(t(self.one_sided, u), u, zero)
        return torch.sum(lj_two + lj_one, dim=-1)

    def to_unbounded(self, x, eps=1e-6):
        """x (a tensor, or host numpy returned as numpy) -> u; values at or
        beyond a bound are clipped ``eps`` inside so the logit stays finite."""
        if not torch.is_tensor(x):
            return self.to_unbounded(torch.as_tensor(np.asarray(x, float)), eps).numpy()
        t = self._t
        p = torch.clamp((x - t(self._lo2, x)) / t(self._width, x), eps, 1.0 - eps)
        u2 = torch.log(p) - torch.log1p(-p)
        gap_lo = torch.clamp(x - t(self._lo1, x), min=eps)
        gap_hi = torch.clamp(t(self._hi1, x) - x, min=eps)
        return torch.where(t(self.two_sided, x), u2,
                           torch.where(t(self.lower_only, x), torch.log(gap_lo),
                                       torch.where(t(self.upper_only, x), torch.log(gap_hi),
                                                   x)))
