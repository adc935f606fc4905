"""Gradient-based Hamiltonian Monte Carlo, the port of the JAX package's
``parallel/hmc.py``: the bounds bijection, the whitening of the unbounded
space, and multi-chain HMC with dual-averaging step-size adaptation (Hoffman
& Gelman 2014, Alg. 5) and a diagonal mass matrix estimated in the warmup.

The samplers' target is a :class:`WhitenedLogPosterior` (a LogPosterior
seen from the whitened, unbounded space, as ``fitting.lightcurve_hmc``
builds it), whose transitions run in one kernel launch each on CUDA (K7h
here, K9 for NUTS; ``kernels/gradient.py``), or any torch callable of
(C, ndim) float64 states, which runs the plain transitions (autograd
gradients) on the CPU only. A transition takes its draws as tensors; the
draws of global transition i come from a device generator seeded from
(seed, i) alone, so a segmented run equals a single one. The warmup's
adaptation stays on the device, updated by tensor operations between
launches; step size and inverse mass reach the host once, at its end, and
the production chain once, at the end of the run.
"""

import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["BoundsTransform", "WhitenedPosterior", "WhitenedLogPosterior", "gradient_target",
           "hmc_transition_plain", "HMCSampler"]


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

    def kernel_spec(self):
        """Per dimension (kind, lo, hi, width), the bijection as the gradient
        kernels take it: kind 0 unbounded, 1 two-sided, 2 lower only, 3
        upper only; lo the lower bound (two-sided or lower only), hi the
        upper bound (upper only), width hi - lo (two-sided, else 1)."""
        kind = np.select([self.two_sided, self.lower_only, self.upper_only], [1, 2, 3], 0)
        lo = np.where(self.two_sided, self._lo2, self._lo1)
        return [(int(k), float(a), float(b), float(w))
                for k, a, b, w in zip(kind, lo, self._hi1, self._width)]

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


class WhitenedPosterior:
    """Affine reparametrization u = mean + L w of the unbounded space, L the
    Cholesky factor of a sample covariance estimate (host numpy, as in the
    JAX package): aligns the unit mass with the posterior's correlations."""

    def __init__(self, samples, jitter=1e-9):
        samples = np.atleast_2d(np.asarray(samples, float))
        self.mean = samples.mean(axis=0)
        cov = np.atleast_2d(np.cov(samples.T))
        scale = np.trace(cov) / cov.shape[0]
        self.L = np.linalg.cholesky(cov + jitter * scale * np.eye(cov.shape[0]))

    @classmethod
    def from_moments(cls, mean, L):
        """Rebuild from a stored (mean, Cholesky factor)."""
        self = cls.__new__(cls)
        self.mean = np.asarray(mean, float)
        self.L = np.asarray(L, float)
        return self

    def to_u(self, w):
        """w (..., ndim) tensor -> u."""
        mean = torch.as_tensor(self.mean, dtype=w.dtype, device=w.device)
        L = torch.as_tensor(self.L, dtype=w.dtype, device=w.device)
        return mean + w @ L.T

    def to_w(self, u):
        """host-side inverse for initializing chains"""
        return np.linalg.solve(self.L, (np.asarray(u, float) - self.mean).T).T

    def u_from_w_chain(self, w_chain):
        """map a (..., ndim) array of whitened samples back (host numpy)"""
        return self.mean + np.asarray(w_chain) @ self.L.T


def _masked(value, grad):
    """The JAX callers' mask: gradient components that are not finite are 0,
    and so is the whole gradient where the value is not finite."""
    ok = torch.isfinite(grad) & torch.isfinite(value)[:, None]
    return torch.where(ok, grad, torch.zeros_like(grad))


def _autograd_value_and_grad(fn, q):
    """(fn(q), masked d fn / dq) of a batched torch function by autograd."""
    with torch.enable_grad():
        q = q.detach().clone().requires_grad_(True)
        v = fn(q)
        g, = torch.autograd.grad(v.sum(), q)
    v = v.detach()
    return v, _masked(v, g)


class WhitenedLogPosterior:
    """The samplers' density on the whitened, unbounded space
    (fitting.py:516-519 of the JAX package): log p(w) = log pi(x) +
    log |dx/du|, with u = mean + L w and x = ``bounds.to_bounded(u)``.

    ``log_posterior`` is a LogPosterior (its model's gradient kernels run
    the transitions on CUDA) or a torch callable of x (B, ndim) -> (B,) (the
    plain transitions, on the CPU)."""

    def __init__(self, log_posterior, bounds, white):
        self.log_posterior = log_posterior
        self.bounds = bounds
        self.white = white

    def _plain_log_prob(self, w):
        from ..fitting import LogPosterior
        u = self.white.to_u(w)
        x = self.bounds.to_bounded(u)
        lp = self.log_posterior
        v = lp.forward_plain(x) if isinstance(lp, LogPosterior) else lp(x)
        return v + self.bounds.log_jacobian(u)

    def logp_and_grad_plain(self, w):
        """(log p (B,), masked gradient (B, ndim)) by autograd, float64."""
        return _autograd_value_and_grad(self._plain_log_prob, w)

    def logp_and_grad(self, w):
        """The same through K7 on CUDA (one launch), or the plain version on
        the CPU."""
        from .. import kernels
        return kernels.log_posterior_and_grad(self.log_posterior, w.contiguous(), white=self)


class _AutogradTarget:
    """A torch callable of (C, ndim) float64 states as a sampler target: the
    plain transitions, gradients by autograd (CPU only)."""

    def __init__(self, log_prob_fn):
        self.log_prob_fn = log_prob_fn

    def logp_and_grad(self, q):
        return _autograd_value_and_grad(self.log_prob_fn, q)

    logp_and_grad_plain = logp_and_grad


def gradient_target(log_prob_fn, device):
    """The sampler target of ``log_prob_fn`` on ``device``: a
    WhitenedLogPosterior as it is, any other callable through autograd, which
    runs on the CPU only."""
    if isinstance(log_prob_fn, WhitenedLogPosterior):
        if device.type == "cuda":
            from .. import kernels
            kernels.gradient.check_target(log_prob_fn)
        return log_prob_fn
    if device.type != "cpu":
        raise NotImplementedError(
            "on CUDA the gradient samplers run the transition kernels of a model, which take a "
            "WhitenedLogPosterior over a LogPosterior; other log-probabilities run on the CPU")
    return _AutogradTarget(log_prob_fn)


def hmc_transition_plain(logp_and_grad, x, logp, z, u_acc, n_used, eps, inv_mass, n_leapfrog,
                         margins=False):
    """One HMC transition of every chain (hmc.py:241-276 of the JAX package,
    batched over chains, draws as inputs): momentum z / sqrt(inv_mass), up
    to ``n_leapfrog`` leapfrog steps of which chain c takes ``n_used[c]``
    (the later ones are identity, as the JAX scan masks them), then the
    Metropolis accept of ``log(u_acc) < h1 - h0``.

    ``logp_and_grad`` maps (C, ndim) states to (log p, masked gradient).
    Returns (x', logp', accept_prob), each batched over the chains, and with
    ``margins`` the accept decision's gap |log u - (h1 - h0)| in nats."""
    p0 = z / torch.sqrt(inv_mass)
    _, g = logp_and_grad(x)
    q, p, logp_new = x, p0, logp
    for i in range(n_leapfrog):
        active = (i < n_used)[:, None]
        p2 = p + 0.5 * eps * g
        q2 = q + eps * inv_mass * p2
        lp2, g2 = logp_and_grad(q2)
        p2 = p2 + 0.5 * eps * g2
        q, p, g = (torch.where(active, a, b) for a, b in ((q2, q), (p2, p), (g2, g)))
        logp_new = torch.where(active[:, 0], lp2, logp_new)
    h0 = logp - 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    h1 = logp_new - 0.5 * torch.sum(p * p * inv_mass, dim=-1)
    log_accept = torch.where(torch.isfinite(h1), h1 - h0, torch.full_like(h1, -math.inf))
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_accept, max=0.0)), max=1.0)
    accept = torch.log(u_acc) < log_accept
    out = (torch.where(accept[:, None], q, x), torch.where(accept, logp_new, logp), accept_prob)
    if margins:
        gap = torch.nan_to_num((torch.log(u_acc) - log_accept).abs(), nan=math.inf)
        return out + (gap,)
    return out


class GradientSampler:
    """What the HMC and NUTS samplers share: the draws' seeding, the
    two-phase warmup (dual averaging of the step size on the mean accept
    statistic, Welford variance of the chain states for the inverse mass),
    the production loop and the continuation. A subclass provides
    ``_draws(i)`` and ``_step(x, logp, draws, eps, inv_mass)`` -> (x',
    logp', accept statistic, depth, diverged) (depth and diverged None for
    HMC)."""

    def __init__(self, nchains, ndim, log_prob_fn, target_accept=0.8, init_step_size=0.1,
                 init_scales=None, seed=None, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError("sharding the chains over a device mesh is not ported yet "
                                      "(ROADMAP Queue 1 item 17)")
        self.nchains = int(nchains)
        self.ndim = int(ndim)
        self.target_accept = float(target_accept)
        self.init_step_size = float(init_step_size)
        self.init_scales = (np.ones(ndim) if init_scales is None
                            else np.asarray(init_scales, float))
        self.device = resolve_device(device)
        self._target = gradient_target(log_prob_fn, self.device)
        if seed is None:
            seed = np.random.randint(0, 2 ** 31 - 1)
        self._seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._draw_count = 0
        self.reset()

    def reset(self):
        self._chain = np.empty((0, self.nchains, self.ndim))
        self._accept_sum = np.zeros(self.nchains)
        self._depth_sum = np.zeros(self.nchains)
        self._divergences = np.zeros(self.nchains)
        self._nsteps = 0
        self.step_size = None
        self.inv_mass = None
        self._last_pos = None
        self._last_logp = None

    def _seeded(self, i):
        """The generator, seeded for global transition ``i``."""
        from .sampler import _step_seed
        self._gen.manual_seed(_step_seed(self._seed, i))
        return self._gen

    def _tensor(self, a):
        return torch.tensor(np.array(a, dtype=float, order="C"), device=self.device)

    def run_mcmc(self, initial_state, n_samples, n_warmup=500):
        x_np = np.asarray(initial_state, float)
        if x_np.shape != (self.nchains, self.ndim):
            raise ValueError(f"initial_state must be {(self.nchains, self.ndim)}")
        x0 = self._tensor(x_np)
        if (self._last_logp is not None and self._last_pos is not None
                and np.array_equal(x_np, self._last_pos)):
            # continuation: the carried log p, not a recomputation
            logp0 = self._tensor(self._last_logp)
        else:
            logp0 = self._target.logp_and_grad(x0)[0]
        if not bool(torch.all(torch.isfinite(logp0))):
            raise ValueError("non-finite initial log-probability")
        if n_warmup == 0:
            # continuation: sample with the previously adapted kinetic terms
            return self._run_adapted(x0, logp0, n_samples)
        if n_warmup < 2:
            raise ValueError("n_warmup must be 0 (continue a previously "
                             "adapted sampler) or >= 2")
        n_w1 = (2 * n_warmup) // 3
        log_eps0 = self._tensor(math.log(self.init_step_size))
        x, logp, log_eps_bar, m, _, m2 = self._warmup(
            x0, logp0, n_w1, math.log(10.0 * self.init_step_size),
            self._tensor(self.init_scales ** 2), log_eps0)
        inv_mass = torch.clamp(m2 / max(m - 1.0, 1.0), min=1e-20)
        x, logp, log_eps_bar, _, _, _ = self._warmup(
            x, logp, n_warmup - n_w1, math.log(10.0) + log_eps_bar, inv_mass, log_eps_bar)
        self.step_size = float(torch.exp(log_eps_bar))   # the one readback of the warmup
        self.inv_mass = inv_mass.cpu().numpy()
        return self._sample(x, logp, n_samples)

    def _warmup(self, x, logp, n, mu, inv_mass, log_eps):
        """``n`` adapting transitions (hmc.py:303-325, nuts.py:348-368):
        returns (x, logp, log_eps_bar, m, mean, m2), all on the device but m."""
        gamma, t0, kappa = 0.05, 10.0, 0.75
        log_eps_bar = log_eps
        h_bar = torch.zeros((), dtype=torch.float64, device=self.device)
        mean = torch.zeros(self.ndim, dtype=torch.float64, device=self.device)
        m2 = torch.zeros_like(mean)
        m = 0.0
        for it in range(n):
            x, logp, astat, _, _ = self._step(x, logp, self._draws(self._draw_count + it),
                                              torch.exp(log_eps), inv_mass)
            i = float(it)
            h_bar = (1.0 - 1.0 / (i + 1 + t0)) * h_bar \
                + (self.target_accept - astat.mean()) / (i + 1 + t0)
            log_eps = mu - math.sqrt(i + 1.0) / gamma * h_bar
            w = (i + 1.0) ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            m = m + self.nchains
            delta = x - mean
            mean = mean + torch.sum(delta, dim=0) / m
            m2 = m2 + torch.sum(delta * (x - mean), dim=0)
        self._draw_count += n
        return x, logp, log_eps_bar, m, mean, m2

    def _sample(self, x, logp, n_samples):
        """The production loop: the chain and the statistics stay on the
        device and come to the host once."""
        eps, inv_mass = self._tensor(self.step_size), self._tensor(self.inv_mass)
        chain = torch.empty((n_samples, self.nchains, self.ndim), dtype=torch.float64,
                            device=self.device)
        sums = torch.zeros((3, self.nchains), dtype=torch.float64, device=self.device)
        for s in range(n_samples):
            x, logp, astat, depth, div = self._step(x, logp, self._draws(self._draw_count + s),
                                                    eps, inv_mass, out=chain[s])
            sums[0] += astat
            if depth is not None:
                sums[1] += depth
                sums[2] += div
        self._draw_count += n_samples
        xs, sums = chain.cpu().numpy(), sums.cpu().numpy()
        self._chain = np.concatenate([self._chain, xs])
        self._accept_sum += sums[0]
        self._depth_sum += sums[1]
        self._divergences += sums[2]
        self._nsteps += n_samples
        self._last_pos = xs[-1]
        self._last_logp = logp.cpu().numpy()
        return self._last_pos

    def _run_adapted(self, x0, logp0, n_samples):
        """Sampling-only run at the stored (step_size, inv_mass)."""
        if self.step_size is None or self.inv_mass is None:
            raise ValueError("n_warmup=0 requires a previous adapted run "
                             "(no stored step_size/inv_mass)")
        return self._sample(x0, logp0, n_samples)

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self.ndim)

    @property
    def acceptance_fraction(self):
        return self._accept_sum / max(self._nsteps, 1)


class HMCSampler(GradientSampler):
    """Multi-chain adaptive HMC with jittered trajectory lengths: the API of
    the JAX package's HMCSampler (``run_mcmc(initial, n_samples,
    n_warmup)``, ``flatchain``, ``chain``, ``acceptance_fraction``, the
    adapted ``step_size`` and ``inv_mass``), plus ``device`` (default CUDA,
    raising without it). On CUDA each transition is one launch of K7h over a
    WhitenedLogPosterior of ShockCooling2; ``mesh`` raises
    NotImplementedError (ROADMAP Queue 1 item 17)."""

    def __init__(self, nchains, ndim, log_prob_fn, n_leapfrog=16, target_accept=0.8,
                 init_step_size=0.1, init_scales=None, seed=None, mesh=None, device=None):
        self.n_leapfrog = int(n_leapfrog)
        super().__init__(nchains, ndim, log_prob_fn, target_accept, init_step_size,
                         init_scales, seed, mesh, device)

    def _draws(self, i):
        """(z (C, ndim), u_acc (C,), n_used (C,) in [(L + 1) // 2, L]) of
        global transition ``i``."""
        g, dev, C = self._seeded(i), self.device, self.nchains
        z = torch.randn((C, self.ndim), generator=g, device=dev, dtype=torch.float64)
        u_acc = torch.rand(C, generator=g, device=dev, dtype=torch.float64)
        n_used = torch.randint((self.n_leapfrog + 1) // 2, self.n_leapfrog + 1, (C,),
                               generator=g, device=dev)
        return z, u_acc, n_used

    def _step(self, x, logp, draws, eps, inv_mass, out=None):
        from .. import kernels
        x, logp, aprob = kernels.hmc_transition(self._target, x, logp, *draws, eps, inv_mass,
                                                self.n_leapfrog, out=out)
        return x, logp, aprob, None, None
