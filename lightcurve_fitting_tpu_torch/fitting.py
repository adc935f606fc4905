"""Model-fit drivers: the ensemble-MCMC fit, the gradient fits (MAP with
Laplace uncertainties, NUTS and HMC), the Bayesian evidence, parallel
tempering and the evidence comparison of models.

Covers ``lightcurve_fitting_tpu/fitting.py``'s ``make_log_posterior`` and
``lightcurve_mcmc`` (reference fitting.py:16-168) with its setup helpers,
its gradient drivers ``lightcurve_map`` and ``lightcurve_hmc``, and its
tempered-ladder drivers ``lightcurve_evidence``, ``lightcurve_ptmcmc`` and
``compare_models``, and its posterior diagnostics ``goodness_of_fit``,
``information_criteria``, ``compare_information_criteria`` and
``compare_models_loo``. The log-posterior is an ``nn.Module``
(:class:`LogPosterior`) over a leading walker axis; on a CUDA device a fit
runs through the fused kernels of its model (``kernels/``: K1 and K2 for
ShockCooling2, the SC3 log-posterior and half-step over K3 for
ShockCooling3, the SC and SC4 log-posteriors and half-steps for ShockCooling
and ShockCooling4, the CS log-posterior and half-step over K8 for
CompanionShocking 1-3, the K6 ladder kernels over each, and on the gradient
path K7, K9 and K7h for ShockCooling2), on the CPU through their plain PyTorch
versions. Every entry point runs on CUDA unless it is given
``device="cpu"``, and raises where CUDA is missing.

The plotting drivers of the JAX module wait for ROADMAP Queue 1 item 18.
"""

import warnings

import numpy as np
import torch
from torch import nn

from .core import config
from .core.device import resolve_device
from .models import GaussianPrior, KDEPrior, UniformPrior
from .parallel.sampler import EnsembleSampler
from .utils import units as u

__all__ = ["lightcurve_mcmc", "lightcurve_map", "lightcurve_hmc", "make_log_posterior",
           "LogPosterior", "lightcurve_evidence", "lightcurve_ptmcmc", "compare_models",
           "goodness_of_fit", "information_criteria", "compare_information_criteria",
           "compare_models_loo"]

PRIOR_WARNING = "The p_max/p_min keywords are deprecated. Use the priors keyword instead."
MODEL_KWARGS_WARNING = "The model_kwargs keyword is deprecated. These are now included in the model intialization."


class LogPosterior(nn.Module):
    """Sum of prior log-densities (-inf outside bounds) plus the Gaussian
    log-likelihood, ``forward(p (W, ndim) float64) -> (W,) float64``
    (reference fitting.py:121-128, without the Python early-exit).

    On a CUDA tensor ``forward`` launches the fused log-posterior kernel
    of the model (ShockCooling, ShockCooling2-4 or CompanionShocking 1-3; any
    other model raises),
    and, when the tensor requires a gradient, K7 (ShockCooling2), whose
    gradient the backward returns; on a CPU tensor it runs
    :meth:`forward_plain`."""

    def __init__(self, log_likelihood, priors):
        super().__init__()
        self.log_likelihood = log_likelihood
        self.priors = list(priors)

    @property
    def kernel_module(self):
        """The kernel module whose fused kernels evaluate this log-posterior
        on CUDA (:func:`~.kernels.module_for` of the model; raises for a
        model without kernels)."""
        from .kernels import module_for
        return module_for(self.log_likelihood.model)

    def log_prior_plain(self, p):
        """The sum of the prior log-densities (-inf outside the bounds) of
        each row of ``p`` (W, ndim) float64, plain PyTorch."""
        log_prior = 0.0
        for i, prior in enumerate(self.priors):
            log_prior = log_prior + prior(p[:, i])
        return log_prior

    def log_likelihood_plain(self, p):
        """The float64 log-likelihood of each row of ``p`` (W, ndim), -inf
        where it is not finite, plain PyTorch; it does not look at the
        priors."""
        ll = self.log_likelihood(p)
        return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf)).to(
            torch.float64)

    def forward_plain(self, p):
        """The plain PyTorch log-posterior of each row of ``p``."""
        squeeze = p.ndim == 1
        p = p.reshape(-1, p.shape[-1])
        log_prior = self.log_prior_plain(p)
        out = torch.where(torch.isfinite(log_prior), log_prior + self.log_likelihood_plain(p),
                          torch.full_like(log_prior, -torch.inf))
        return out[0] if squeeze else out

    def grad_term_scales(self, p):
        """(W, ndim) float64: for each walker and parameter, the summed
        magnitudes of the per-point terms of the log-posterior's gradient
        (every point's residual term and every prior), by forward-mode
        differentiation of the plain version, non-finite terms counted as 0.
        A gradient's rounding follows these terms, which cancel near an
        optimum, not their sum: the scale K7's tolerances are stated in."""
        from torch.func import jvp
        p = p.reshape(-1, p.shape[-1]).to(torch.float64)

        def terms(x):
            prior = torch.stack([prior(x[:, i]) for i, prior in enumerate(self.priors)], dim=1)
            return torch.cat([-0.5 * self.log_likelihood.residual_terms(x).double(), prior], dim=1)

        cols = []
        for k in range(p.shape[1]):
            tangent = torch.zeros_like(p)
            tangent[:, k] = 1.0
            _, d = jvp(terms, (p,), (tangent,))
            cols.append(torch.nan_to_num(d.abs(), nan=0.0, posinf=0.0).sum(dim=1))
        return torch.stack(cols, dim=1)

    def forward(self, p):
        from . import kernels
        squeeze = p.ndim == 1
        p2 = p.reshape(-1, p.shape[-1]).contiguous()
        if p2.device.type == "cuda" and p2.requires_grad and torch.is_grad_enabled():
            out = _LogPosteriorK7.apply(p2.to(torch.float64), self)
        else:
            out = kernels.log_posterior(self, p2)
        return out[0] if squeeze else out


class _LogPosteriorK7(torch.autograd.Function):
    """LogPosterior.forward on a CUDA tensor that requires a gradient: K7
    gives the value and the (masked) gradient in one launch, and the
    backward scales the saved gradient."""

    @staticmethod
    def forward(ctx, p, lp):
        from . import kernels
        val, grad = kernels.log_posterior_and_grad(lp, p)
        ctx.save_for_backward(grad)
        return val

    @staticmethod
    def backward(ctx, g_out):
        grad, = ctx.saved_tensors
        return g_out[:, None] * grad, None


def make_log_posterior(model, lc, priors, use_sigma=False, sigma_type="relative", device=None):
    """Build the :class:`LogPosterior` of ``model`` on ``lc`` with its
    buffers on ``device`` (default: CUDA; without it RuntimeError, see
    ``core.device.resolve_device``)."""
    device = resolve_device(device)
    ll = model.make_log_likelihood(lc, use_sigma=use_sigma, sigma_type=sigma_type,
                                   device=device)
    return LogPosterior(ll, priors)


# --------------------------------------------------------------------------
# fit setup helpers
# --------------------------------------------------------------------------

def _derive_fit_columns(lc, model):
    """Materialize the column the model is fit against, from magnitudes when
    present (reference fitting.py:68-72); synthetic tables that already carry
    the quantity are used as-is."""
    needs_rebuild = "mag" in lc.colnames or model.output_quantity not in lc.colnames
    if not needs_rebuild:
        return
    if model.output_quantity == "flux":
        lc.calcFlux()
    elif model.output_quantity == "lum":
        lc.calcAbsMag()
        lc.calcLum()


def _ensure_sigma_param(model, use_sigma):
    """Append the intrinsic-scatter parameter to the model's metadata once
    (reference fitting.py:74-76)."""
    if use_sigma and model.input_names[-1] != "\\sigma":
        model.input_names = model.input_names + ["\\sigma"]
        model.units = model.units + [u.dimensionless_unscaled]


def _deprecated_bound(arg, ndim, default):
    """Validate one of the deprecated p_min/p_max keywords; warn when used
    (reference fitting.py:80-96)."""
    if arg is None:
        return np.tile(default, ndim)
    if len(arg) != ndim:
        raise Exception(PRIOR_WARNING)
    warnings.warn(PRIOR_WARNING)
    return np.array(arg, float)


def _init_window(p_lo, p_up, p_min, ndim):
    """The uniform-random initialization box for walker starting positions."""
    if p_lo is None:
        p_lo = p_min
    elif len(p_lo) == ndim:
        p_lo = np.array(p_lo, float)
    else:
        raise Exception("p_lo must have length {:d}".format(ndim))
    if len(p_up) == ndim:
        p_up = np.array(p_up, float)
    else:
        raise Exception("p_up must have length {:d}".format(ndim))
    return p_lo, p_up


def _check_window_inside_priors(model, priors, p_lo, p_up):
    """Starting guesses outside the prior support would initialize walkers at
    -inf (reference fitting.py:115-119)."""
    for param, prior, lo, up in zip(model.input_names, priors, p_lo, p_up):
        support_lo = getattr(prior, "p_min", -np.inf)
        support_up = getattr(prior, "p_max", np.inf)
        if lo < support_lo:
            raise Exception(f"starting guess for {param} (p_lo = {lo}) is outside prior "
                            f"(p_min = {support_lo})")
        if up > support_up:
            raise Exception(f"starting guess for {param} (p_up = {up}) is outside prior "
                            f"(p_max = {support_up})")


def _state_rescaling(state_dtype, p_lo, p_up, device):
    """Resolve the walker-state dtype + affine rescaling for this run.

    ``state_dtype="auto"``: on CUDA the walker state runs in float32 over the
    rescaled space ``q = (p - mid) / halfwidth`` of the init window (O(1)
    values make f32 safe; the stretch move is affine-equivariant, so the
    statistics are identical). On the CPU the state stays absolute float64.
    Pass ``np.float32``/``np.float64`` (or the torch dtypes) to force either
    mode.
    """
    if state_dtype == "auto":
        use_f32 = torch.device(device).type == "cuda"
    else:
        use_f32 = state_dtype in (np.float32, torch.float32) or \
            (not isinstance(state_dtype, torch.dtype) and np.dtype(state_dtype) == np.float32)
    if not use_f32:
        return {}
    offset = (np.asarray(p_lo, float) + np.asarray(p_up, float)) / 2.0
    scale = (np.asarray(p_up, float) - np.asarray(p_lo, float)) / 2.0
    scale = np.maximum(scale, 1e-12 * np.maximum(1.0, np.abs(offset)))
    # inflate the scale a hair so the window edges map strictly INSIDE
    # |q| < 1: otherwise a draw within half an f32 ulp of the window edge
    # (common when p_lo/p_up equal the prior support) rounds to exactly the
    # bound, the open-interval prior returns -inf, and the initial-state
    # check aborts the run probabilistically at large walker counts
    scale = scale * (1.0 + 1e-6)
    return {"dtype": torch.float32, "param_offset": offset, "param_scale": scale}


def _select_sampler(log_posterior, nwalkers, ndim, seed, replicas=1, mesh=None,
                    shard=None, store_dtype=None, state_kw=None, device=None):
    """The sampler for this run: one device, one ensemble. Replicas (refused
    by the sampler) and walker sharding are not ported yet."""
    if mesh is not None or shard is True:
        raise NotImplementedError("walker sharding (mesh, shard=True) is not ported yet "
                                  "(ROADMAP Queue 1 item 17)")
    return EnsembleSampler(nwalkers, ndim, log_posterior, seed=seed, store_dtype=store_dtype,
                           replicas=replicas, device=device, **(state_kw or {}))


def _plot_chain_histories(ax_column, sampler, model, title):
    """One column of per-parameter chain-history traces (reference
    fitting.py:135-166)."""
    for i, ax in enumerate(ax_column):
        ax.plot(sampler.chain[:, :, i].T, "k", alpha=0.2)
        ax.set_ylabel(model.axis_labels[i])
    ax_column[0].set_title(title)
    ax_column[-1].set_xlabel("Step Number")


def _report_convergence(sampler, model, nsamples):
    """Post-run convergence summary: mean acceptance and per-parameter
    integrated autocorrelation time / effective sample size."""
    accept = float(np.mean(sampler.acceptance_fraction))
    lines = [f"mean acceptance fraction: {accept:.3f}"]
    try:
        tau = sampler.get_autocorr_time()
        for name, t in zip(model.input_names, tau):
            ess = nsamples / max(t, 1.0)
            lines.append(f"  {name}: tau = {t:.1f} steps, ESS ~ {ess:.0f}")
    except Exception as exc:  # diagnostics must never kill a finished fit
        lines.append(f"  (autocorrelation estimate unavailable: {exc})")
    print("\n".join(lines))


def lightcurve_mcmc(lc, model, priors=None, p_min=None, p_max=None, p_lo=None, p_up=None,
                    nwalkers=100, nsteps=1000, nsteps_burnin=1000, model_kwargs=None,
                    show=False, save_plot_as="", save_sampler_as="", use_sigma=False,
                    sigma_type="relative", seed=None, replicas=1, mesh=None, shard=None,
                    store_dtype=None, init="window", quiet=False,
                    checkpoint_every=None, checkpoint_file=None, resume_from=None,
                    state_dtype="auto", device=None):
    """Fit an analytical model to observed photometry with ensemble MCMC.

    Same signature and behavior as ``lightcurve_fitting_tpu.fitting.
    lightcurve_mcmc`` (reference fitting.py:16-168), plus ``device``
    (default ``"cuda"``; without CUDA it raises: pass ``"cpu"`` for the plain
    versions). On CUDA every
    half-step is one launch of the model's fused half-step kernel (K2 for
    ShockCooling2, its SC3, SC, SC4 and CS instantiations for ShockCooling3,
    ShockCooling, ShockCooling4 and CompanionShocking 1-3; other models
    raise) and the walker state is
    float32 over the rescaled init window (``state_dtype="auto"``); on the
    CPU the plain PyTorch step runs on absolute float64 state.

    * ``seed`` makes the chains reproducible: the draws of global step i
      depend only on (seed, i), so progress segments do not change the chain;
    * ``init="map"`` seeds the walkers from the Laplace approximation at the
      MAP (:func:`lightcurve_map`, through K7 on CUDA), parameters pinned at
      a prior bound jittered into a thin band inside it;
    * ``quiet=False`` prints acceptance + autocorrelation/ESS and
      :func:`goodness_of_fit` after the production run.

    Not ported yet, and refused with ``NotImplementedError``: ``replicas > 1``
    (ROADMAP Queue 1 item 4), ``mesh`` and ``shard=True`` (item 17),
    ``checkpoint_every``, ``checkpoint_file`` and ``resume_from`` (item 16).

    Returns an :class:`~lightcurve_fitting_tpu_torch.parallel.sampler.EnsembleSampler`
    exposing the emcee attributes the reference workflow uses (``flatchain``,
    ``chain``).
    """
    if model_kwargs is not None:
        raise Exception(MODEL_KWARGS_WARNING)
    if checkpoint_every is not None or checkpoint_file is not None or resume_from is not None:
        raise NotImplementedError("checkpoint/resume is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    if init not in ("window", "map"):
        raise ValueError('init must be "window" or "map"')
    device = resolve_device(device)

    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams

    p_min = _deprecated_bound(p_min, ndim, -np.inf)
    p_max = _deprecated_bound(p_max, ndim, np.inf)
    p_lo, p_up = _init_window(p_lo, p_up, p_min, ndim)

    if priors is None:
        priors = [UniformPrior(lo, hi) for lo, hi in zip(p_min, p_max)]
    elif len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    _check_window_inside_priors(model, priors, p_lo, p_up)

    log_posterior = make_log_posterior(model, lc, priors, use_sigma, sigma_type, device=device)
    sampler = _select_sampler(log_posterior, nwalkers, ndim, seed, replicas=replicas,
                              mesh=mesh, shard=shard, store_dtype=store_dtype,
                              state_kw=_state_rescaling(state_dtype, p_lo, p_up, device),
                              device=device)

    rng = np.random.RandomState(seed) if seed is not None else np.random
    if init == "map":
        starting_guesses = _laplace_starting_guesses(lc, model, priors, p_lo, p_up,
                                                     sampler.total_walkers, use_sigma, sigma_type,
                                                     seed, quiet, rng, device)
    else:
        starting_guesses = rng.rand(sampler.total_walkers, ndim) * (p_up - p_lo) + p_lo

    if nsteps_burnin > 0:
        sampler.run_mcmc(starting_guesses, nsteps_burnin, progress=not quiet,
                         progress_kwargs={"desc": " Burn-in"})
    fig = None
    if show or save_plot_as:
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(ndim, 2, figsize=(12.0, 2.0 * ndim), squeeze=False)
        _plot_chain_histories(ax[:, 0], sampler, model, "During Burn In")
    sampler.reset()
    # nsteps_burnin=0 skips the burn-in loop entirely, so the starting guesses
    # were never delivered to the sampler — seed production with them directly
    # (and keep the initial-state check, since these are raw guesses)
    prod_initial = starting_guesses if nsteps_burnin <= 0 else None
    sampler.run_mcmc(prod_initial, nsteps, progress=not quiet,
                     progress_kwargs={"desc": "Sampling"},
                     skip_initial_state_check=prod_initial is None)

    flat = sampler.flatchain if (save_sampler_as or not quiet) else None
    if save_sampler_as:
        np.save(save_sampler_as, flat)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        _report_convergence(sampler, model, flat.shape[0])
        try:
            goodness_of_fit(lc, model, flat, use_sigma=use_sigma, sigma_type=sigma_type,
                            device=device)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")

    if fig is not None:
        import matplotlib.pyplot as plt
        _plot_chain_histories(ax[:, 1], sampler, model, "After Burn In")
        for axis in ax[:, 1]:
            axis.yaxis.set_label_position("right")
            axis.yaxis.tick_right()
        fig.tight_layout()
        if save_plot_as:
            print("saving chain plot as " + save_plot_as)
            fig.savefig(save_plot_as)
        if show:
            plt.show()

    return sampler


# --------------------------------------------------------------------------
# gradient drivers: MAP + Laplace, NUTS and HMC (no reference counterpart:
# the reference's numpy models are not differentiable)
# --------------------------------------------------------------------------

def _refuse_gradient_unported(priors, mesh=None, checkpoint_every=None, checkpoint_file=None,
                              resume_from=None):
    """The gradient drivers' options the port does not have yet raise
    NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError("sharding the gradient fits over a device mesh is not ported "
                                  "yet (ROADMAP Queue 1 item 17)")
    if checkpoint_every is not None or checkpoint_file is not None or resume_from is not None:
        raise NotImplementedError("checkpoint/resume of the gradient fits is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    if any(isinstance(p, KDEPrior) for p in priors):
        raise NotImplementedError("a KDEPrior in the gradient drivers is not ported yet: the "
                                  "gradient kernels take prior kinds 0-2 (ROADMAP Queue 1 "
                                  "item 21)")


def _gradient_setup(lc, model, priors, use_sigma, sigma_type, device):
    """The fit columns, the sigma parameter and the LogPosterior of a
    gradient driver on ``device``; on CUDA the model must have the gradient
    kernels (ShockCooling2)."""
    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams
    if len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    log_posterior = make_log_posterior(model, lc, priors, use_sigma, sigma_type, device=device)
    if device.type == "cuda":
        from .kernels.gradient import check_model
        check_model(log_posterior)
    return ndim, log_posterior


def _bounds_of(priors):
    from .parallel.hmc import BoundsTransform
    return BoundsTransform([getattr(p, "p_min", -np.inf) for p in priors],
                           [getattr(p, "p_max", np.inf) for p in priors])


class _HMCFitResult:
    """HMC or NUTS chains mapped back to the model's parameter space, with
    the sampler surface the rest of the workflow expects (``flatchain``,
    ``chain``, ``acceptance_fraction``)."""

    def __init__(self, hmc, x_chain):
        self.sampler = hmc              # the raw whitened-space sampler
        self._chain = x_chain           # (nsteps, nchains, ndim), x-space
        self.step_size = hmc.step_size
        self.acceptance_fraction = hmc.acceptance_fraction

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self._chain.shape[-1])


def lightcurve_hmc(lc, model, priors, p_lo=None, p_up=None, nchains=16, nsamples=1000,
                   n_warmup=800, sampler="nuts", max_depth=9, n_leapfrog=32, use_sigma=False,
                   sigma_type="relative", seed=None, warmup_walkers=64, warmup_steps=300,
                   save_sampler_as="", quiet=False, mesh=None, checkpoint_every=None,
                   checkpoint_file=None, resume_from=None, device=None):
    """One-call gradient-based fit of a light-curve model (NUTS by default),
    the JAX package's ``lightcurve_hmc`` with the same signature plus
    ``device`` (default ``"cuda"``, raising without it):

    1. a stretch-move ensemble of ``warmup_walkers`` x ``warmup_steps``
       (K1/K2 on CUDA) locates the typical set;
    2. the prior box is removed by the sigmoid/exp bijection
       (:class:`~.parallel.hmc.BoundsTransform`, with its log-Jacobian);
    3. the warm samples' covariance whitens the unbounded space
       (:class:`~.parallel.hmc.WhitenedPosterior`);
    4. ``sampler="nuts"`` runs NUTS in the whitened space (one K9 launch a
       transition on CUDA), ``sampler="hmc"`` fixed-budget HMC with
       jittered ``n_leapfrog`` trajectories (one K7h launch a transition);
    5. the chains are mapped back through both bijections.

    On CUDA the model must be ShockCooling2 (the gradient kernels); on the
    CPU any model runs the plain versions. The compute dtype is the
    configured one (``core.config``; AUTO gives float32 on CUDA). Not ported
    yet, and refused with NotImplementedError: ``mesh`` (ROADMAP Queue 1 item
    17), ``checkpoint_every``, ``checkpoint_file`` and ``resume_from`` (item
    16), a KDEPrior (item 21). ``quiet=False`` prints the sampler's summary,
    the R-hat of each parameter and :func:`goodness_of_fit`.

    Returns a :class:`_HMCFitResult`.
    """
    from .parallel.hmc import HMCSampler, WhitenedLogPosterior, WhitenedPosterior
    from .parallel.nuts import NUTSSampler
    _refuse_gradient_unported(priors, mesh, checkpoint_every, checkpoint_file, resume_from)
    device = resolve_device(device)
    if sampler not in ("nuts", "hmc"):
        raise ValueError('sampler must be "nuts" or "hmc"')
    ndim, log_posterior = _gradient_setup(lc, model, priors, use_sigma, sigma_type, device)
    bounds = _bounds_of(priors)
    lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)

    # ensemble warm start: typical-set location + covariance + seeds
    rng = np.random.RandomState(seed) if seed is not None else np.random
    warm = EnsembleSampler(warmup_walkers, ndim, log_posterior, seed=seed, device=device)
    guesses = rng.rand(warmup_walkers, ndim) * (up - lo) + lo
    warm.run_mcmc(guesses, warmup_steps, progress=not quiet,
                  progress_kwargs={"desc": " HMC warm start"})
    warm_flat = warm.get_chain(flat=True, discard=warmup_steps // 2)
    warm_logp = warm.get_log_prob(flat=True, discard=warmup_steps // 2)
    warm_u = bounds.to_unbounded(warm_flat)
    white = WhitenedPosterior(warm_u)
    # seed chains from the warm draws already inside the typical set
    good = np.flatnonzero(warm_logp >= np.median(warm_logp))
    seeds = good[rng.choice(good.size, nchains, replace=good.size < nchains)]
    target = WhitenedLogPosterior(log_posterior, bounds, white)
    if sampler == "nuts":
        engine = NUTSSampler(nchains, ndim, target, max_depth=max_depth, seed=seed,
                             device=device)
    else:
        engine = HMCSampler(nchains, ndim, target, n_leapfrog=n_leapfrog, seed=seed,
                            device=device)
    engine.run_mcmc(white.to_w(warm_u[seeds]), nsamples, n_warmup=n_warmup)

    u_chain = white.u_from_w_chain(engine._chain)
    x_chain = bounds.to_bounded(torch.as_tensor(u_chain)).numpy()
    result = _HMCFitResult(engine, x_chain)
    if save_sampler_as:
        np.save(save_sampler_as, result.flatchain)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        from .parallel.diagnostics import rank_normalized_split_rhat
        extra = ""
        if sampler == "nuts":
            extra = (f", mean tree depth {engine.mean_tree_depth:.1f}, "
                     f"divergence rate {engine.divergence_rate:.3f}")
        print(f"{sampler.upper()}: step size {engine.step_size:.3g}, mean acceptance "
              f"{float(engine.acceptance_fraction.mean()):.3f}{extra}")
        rhat = rank_normalized_split_rhat(x_chain)
        for name, r in zip(model.input_names, np.atleast_1d(rhat)):
            print(f"  {name}: rank-normalized R-hat = {r:.3f}  (independent chains)")
        try:
            goodness_of_fit(lc, model, result.flatchain, use_sigma=use_sigma,
                            sigma_type=sigma_type, device=device)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


def _laplace_starting_guesses(lc, model, priors, p_lo, p_up, n_walkers, use_sigma, sigma_type,
                              seed, quiet, rng, device=None):
    """Walker starting positions drawn from the Laplace approximation at the
    MAP (``init="map"``). Draws outside the prior support, and parameters
    pinned at a bound (zero Laplace variance), are jittered uniformly into a
    thin band just inside the bound so every dimension keeps nonzero spread."""
    result = lightcurve_map(lc, model, priors, p_lo=p_lo, p_up=p_up, use_sigma=use_sigma,
                            sigma_type=sigma_type, seed=seed, nsamples=n_walkers, quiet=quiet,
                            device=device)
    draws = result.flatchain[:n_walkers].copy()
    lo_s = np.array([getattr(p, "p_min", -np.inf) for p in priors])
    up_s = np.array([getattr(p, "p_max", np.inf) for p in priors])
    width = np.where(np.isfinite(up_s - lo_s), up_s - lo_s,
                     np.maximum(np.abs(result.parameters), 1.0))
    band = 1e-3 * width
    jitter = rng.rand(*draws.shape)
    # pinned columns carry zero Laplace variance: spread them through the
    # thin band just inside their bound (which bound: the one the MAP sits on)
    pin_up = result.at_bound & (up_s - result.parameters < result.parameters - lo_s)
    low_viol = (draws <= lo_s) | (result.at_bound & ~pin_up)
    up_viol = (draws >= up_s) | pin_up
    draws = np.where(low_viol, lo_s + band * jitter, draws)
    draws = np.where(up_viol, up_s - band * jitter, draws)
    return draws


class _MAPFitResult:
    """MAP point estimate plus its Laplace approximation, with the same
    ``flatchain`` surface as the samplers.

    Attributes: ``parameters`` (ndim,), ``log_posterior`` (float at the
    mode), ``covariance`` (ndim, ndim), ``stderr`` (ndim,), ``at_bound``
    (bool mask: parameter pinned against a prior bound; its stderr is 0 and
    the curvature of the others is conditional on the pinned value),
    ``covariance_ok`` (False when the free-parameter curvature is not
    positive definite) and ``flatchain``: Gaussian draws from the Laplace
    approximation, pinned parameters held at the bound."""

    def __init__(self, parameters, log_posterior, covariance, covariance_ok, at_bound, nsamples,
                 seed):
        self.parameters = parameters
        self.log_posterior = log_posterior
        self.covariance = covariance
        self.covariance_ok = covariance_ok
        self.at_bound = at_bound
        self.stderr = np.sqrt(np.maximum(np.diag(covariance), 0.0))
        rng = np.random.default_rng(seed)
        self.flatchain = rng.multivariate_normal(parameters, covariance, size=nsamples,
                                                 method="eigh")


def lightcurve_map(lc, model, priors, p_lo=None, p_up=None, n_starts=64, n_iter=1000,
                   learning_rate=0.05, use_sigma=False, sigma_type="relative", seed=None,
                   nsamples=1000, quiet=False, device=None):
    """One-call maximum-a-posteriori fit with Laplace uncertainties, the JAX
    package's ``lightcurve_map`` with the same signature plus ``device``
    (default ``"cuda"``, raising without it).

    A multi-start Adam ascent of the log-posterior in the unbounded space of
    the prior box (each iteration's value and gradient one K7 launch on
    CUDA), a parameter pinned against a prior bound detected from the sign
    of K7's gradient there, and the curvature of the free parameters at the
    mode inverted into a covariance: the Hessian by central differences of
    K7's float64 gradient (a float64 twin of the log-posterior when the
    compute dtype is float32). On CUDA the model must be ShockCooling2.
    KDEPrior raises NotImplementedError (ROADMAP Queue 1 item 21).
    ``quiet=False`` prints the mode and :func:`goodness_of_fit` with the MAP
    point as its ``best``.

    Returns a :class:`_MAPFitResult`; ``result.flatchain`` holds the Laplace
    draws.
    """
    from . import kernels
    from .parallel.optimize import laplace_covariance, multistart_maximize
    _refuse_gradient_unported(priors)
    device = resolve_device(device)
    ndim, log_posterior = _gradient_setup(lc, model, priors, use_sigma, sigma_type, device)
    lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)
    bounds = _bounds_of(priors)

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(lo, up, size=(n_starts, ndim))
    u0 = torch.as_tensor(bounds.to_unbounded(x0), device=device)
    u_fin, logp_fin = multistart_maximize(lambda u: log_posterior(bounds.to_bounded(u)), u0,
                                          n_iter=n_iter, learning_rate=learning_rate)
    logp_fin = logp_fin.cpu().numpy()
    if not np.isfinite(logp_fin).any():
        raise RuntimeError("no optimizer start reached finite posterior "
                           "probability; widen p_lo/p_up or check the priors")
    best = int(np.nanargmax(np.where(np.isfinite(logp_fin), logp_fin, -np.inf)))
    x_best = bounds.to_bounded(u_fin[best])
    x_map = x_best.cpu().numpy()

    # a parameter sits ON a prior bound when the iterate is within 1e-3 of it
    # in scaled units AND the gradient still pushes outward (fitting.py:714-726
    # of the JAX package); Laplace then runs conditional on the pinned values
    g_map = kernels.log_posterior_and_grad(log_posterior, x_best[None])[1][0].cpu().numpy()
    scale = np.where(bounds.two_sided, bounds.upper - bounds.lower,
                     np.maximum(np.abs(x_map), 1.0))
    near_lo = np.isfinite(bounds.lower) & (x_map - bounds.lower < 1e-3 * scale)
    near_up = np.isfinite(bounds.upper) & (bounds.upper - x_map < 1e-3 * scale)
    at_bound = (near_lo & (g_map < 0)) | (near_up & (g_map > 0))
    if log_posterior.log_likelihood.compute_dtype == torch.float64:
        lp64 = log_posterior
    else:
        with config.override(torch.float64):
            lp64 = make_log_posterior(model, lc, priors, use_sigma, sigma_type, device=device)
    cov, ok = laplace_covariance(lp64, x_map, free=~at_bound)
    result = _MAPFitResult(x_map, float(logp_fin[best]), cov, ok, at_bound, nsamples, seed)
    if not quiet:
        spread = logp_fin[np.isfinite(logp_fin)]
        print(f"MAP: log-posterior {result.log_posterior:.2f} "
              f"({(spread >= spread.max() - 1.0).sum()}/{n_starts} starts "
              f"within 1 nat of the best)")
        if not ok:
            print("  curvature not positive definite (ridge saddle): "
                  "stderr values are order-of-magnitude only")
        for name, val, err, pinned in zip(model.input_names, x_map, result.stderr, at_bound):
            note = "  (at prior bound)" if pinned else ""
            print(f"  {name} = {val:.6g} +/- {err:.2g}{note}")
        try:
            # the Laplace cloud scatters off the curved ridge: the MAP point
            # itself is always scored, so chi2 reflects the actual best fit
            goodness_of_fit(lc, model, result.flatchain, best=x_map, use_sigma=use_sigma,
                            sigma_type=sigma_type, device=device)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


# --------------------------------------------------------------------------
# Bayesian evidence and parallel tempering (no reference counterpart: the
# reference has no model-comparison machinery at all)
# --------------------------------------------------------------------------

def _hmc_init_window(priors, p_lo, p_up, ndim):
    """Initialization box for the ladder's starting cloud: explicit p_lo/p_up
    when given (each side independently: a lone p_up caps the prior-derived
    window instead of being dropped), else prior bounds, else mean +/- 2
    stddev for Gaussian priors."""
    if p_lo is not None and p_up is not None:
        return np.array(p_lo, float), np.array(p_up, float)
    explicit_lo = None if p_lo is None else np.array(p_lo, float)
    explicit_up = None if p_up is None else np.array(p_up, float)
    lo = np.empty(ndim)
    up = np.empty(ndim)
    for i, prior in enumerate(priors):
        bound_lo = getattr(prior, "p_min", -np.inf)
        bound_up = getattr(prior, "p_max", np.inf)
        if isinstance(prior, GaussianPrior):
            bound_lo = max(bound_lo, prior.mean - 2.0 * prior.stddev)
            bound_up = min(bound_up, prior.mean + 2.0 * prior.stddev)
        if explicit_lo is not None:
            bound_lo = explicit_lo[i]
        if explicit_up is not None:
            bound_up = explicit_up[i]
        if not (np.isfinite(bound_lo) and np.isfinite(bound_up)):
            raise ValueError(f"prior {i} has unbounded support; pass p_lo/p_up "
                             "to initialize the walkers")
        lo[i], up[i] = bound_lo, bound_up
    return lo, up


def _prior_log_norm(prior):
    """log of a prior's normalization constant over its support.

    The Prior classes return *unnormalized* log-densities (reference parity:
    MCMC does not care). The stepping-stone ratio Z(1)/Z(0) normalizes the
    prior automatically, so the tempered drivers call this only to *validate
    properness* (an improper prior has no evidence) and discard the value.
    Uniform priors normalize analytically; every other proper prior, a
    user-defined ``Prior`` subclass included, integrates its ``logp``
    numerically on a dense closed grid in float64 (Gaussian supports
    windowed to mean +/- 15 sigma, KDE supports to the sample range +/- 12
    bandwidths); anything else unbounded is rejected."""
    lo = getattr(prior, "p_min", -np.inf)
    hi = getattr(prior, "p_max", np.inf)
    if not hi > lo:
        raise ValueError(f"{prior!r} has empty support")
    if type(prior) is UniformPrior and np.isfinite(lo) and np.isfinite(hi):
        return float(np.log(hi - lo))
    if isinstance(prior, GaussianPrior):
        wlo = max(lo, prior.mean - 15.0 * prior.stddev)
        whi = min(hi, prior.mean + 15.0 * prior.stddev)
        # support disjoint from the 15-sigma core (a pure-tail truncation):
        # integrate the support directly, the max-shift handles underflow
        if whi > wlo:
            lo, hi = wlo, whi
    elif isinstance(prior, KDEPrior):
        s = np.asarray(prior.samples, float)
        lo = max(lo, s.min() - 12.0 * prior.bandwidth)
        hi = min(hi, s.max() + 12.0 * prior.bandwidth)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"evidence requires proper (normalizable) priors; "
                         f"{prior!r} has unbounded support")
    # integrate the raw (unmasked) density on the CLOSED interval: the masked
    # __call__ is -inf exactly at the bounds, which would drop the edge
    # slivers (the density often peaks at a bound)
    g = np.linspace(lo, hi, 4097)
    vals = np.broadcast_to(torch.as_tensor(prior.logp(torch.as_tensor(g, dtype=torch.float64)),
                                           dtype=torch.float64).numpy(), g.shape)
    if np.any(np.isposinf(vals)):
        raise ValueError(f"{prior!r} has a divergent density on its support; "
                         "its evidence normalization is undefined")
    finite = vals[np.isfinite(vals)]
    if finite.size == 0:
        raise ValueError(f"{prior!r} has zero density everywhere on [{lo}, {hi}]")
    m = finite.max()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(m + np.log(trapezoid(np.exp(vals - m), g)))  # exp(-inf) -> 0


def _tempered_setup(lc, model, priors, p_lo, p_up, nwalkers, use_sigma, sigma_type, seed,
                    state_dtype="auto", device=None):
    """Shared setup for the tempered-ladder drivers (evidence and PT):
    derived fit columns, sigma parameter, prior properness validation, the
    model's LogLikelihood on ``device`` (the ladder tracks it apart from the
    prior), and the walker starting cloud.

    Returns ``(priors, log_likelihood, p0, state_kw)``. With
    ``state_dtype="auto"`` on CUDA, ``state_kw`` holds the float32 state
    dtype and the affine rescaling of the init window as the sampler takes
    it (``param_offset``/``param_scale``, see ``_state_rescaling``) and
    ``p0`` is rescaled. The evidence is invariant: the constant Jacobian of
    the affine map cancels in the stepping-stone ratio Z(1)/Z(0)."""
    _derive_fit_columns(lc, model)
    _ensure_sigma_param(model, use_sigma)
    ndim = model.nparams
    if len(priors) != ndim:
        raise Exception("priors must have length {:d}".format(ndim))
    for prior in priors:
        _prior_log_norm(prior)  # properness check; the constant cancels in Z(1)/Z(0)
    log_likelihood = model.make_log_likelihood(lc, use_sigma=use_sigma, sigma_type=sigma_type,
                                               device=device)
    lo, up = _hmc_init_window(priors, p_lo, p_up, ndim)
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(lo, up, size=(nwalkers, ndim))
    state_kw = _state_rescaling(state_dtype, lo, up, device)
    if state_kw:
        p0 = (p0 - state_kw["param_offset"]) / state_kw["param_scale"]
    return list(priors), log_likelihood, p0, state_kw


def _ladder_kwargs(state_kw):
    return {"state_dtype": state_kw.get("dtype"), "param_offset": state_kw.get("param_offset"),
            "param_scale": state_kw.get("param_scale")}


def lightcurve_evidence(lc, model, priors, p_lo=None, p_up=None, nwalkers=64, n_rungs=32,
                        nsteps=500, nsteps_burnin=500, use_sigma=False, sigma_type="relative",
                        seed=None, mesh=None, quiet=False, checkpoint_every=None,
                        checkpoint_file=None, resume_from=None, state_dtype="auto",
                        device=None):
    """log marginal likelihood (Bayesian evidence) of a model for this light
    curve, by stepping-stone sampling over a ladder of power posteriors
    (``parallel/evidence.py``): on CUDA every half-step of the whole ladder
    is one launch of the model's K6 kernel, so this costs about one MCMC fit
    of (n_rungs + 1) x nwalkers walkers, not n_rungs fits.

    Same signature and behavior as ``lightcurve_fitting_tpu.fitting.
    lightcurve_evidence``, plus ``device`` (default ``"cuda"``, raising
    without it); on CUDA the model must be ShockCooling, ShockCooling2-4 or
    CompanionShocking 1-3 (the models with kernels). Differences in the returned
    ``log_z`` between models are log Bayes factors, given those priors.

    Returns ``(log_z, log_z_err, info)``; ``info`` has the ladder, per-rung
    terms, and per-rung acceptance and swap rates.

    Not ported yet, and refused with ``NotImplementedError``: ``mesh``
    (ROADMAP Queue 1 item 17), ``checkpoint_every``, ``checkpoint_file`` and
    ``resume_from`` (item 16); on CUDA a ``KDEPrior`` (item 21).
    """
    from .parallel.evidence import refuse_unported, stepping_stone_evidence
    refuse_unported(mesh, checkpoint_every, checkpoint_file, resume_from)
    device = resolve_device(device)
    priors, log_likelihood, p0, state_kw = _tempered_setup(
        lc, model, priors, p_lo, p_up, nwalkers, use_sigma, sigma_type, seed, state_dtype,
        device)
    log_z, log_z_err, info = stepping_stone_evidence(
        priors, log_likelihood, p0, n_rungs=n_rungs, nsteps=nsteps, nsteps_burnin=nsteps_burnin,
        seed=seed if seed is not None else 0, **_ladder_kwargs(state_kw))
    if not quiet:
        print(f"log evidence: {log_z:.2f} +/- {log_z_err:.2f} "
              f"({n_rungs} rungs x {nwalkers} walkers x {nsteps} steps; "
              f"rung acceptance {info['acceptance'].min():.2f}-"
              f"{info['acceptance'].max():.2f})")
    return log_z, log_z_err, info


def _compare_args(models, priors, p_lo, p_up, labels):
    """Normalize the shared-vs-per-model argument shapes of the comparison
    driver: priors (flat shared list or one list per model), p_lo/p_up
    (shared window or per-model), labels (default: deduplicated class
    names)."""
    models = list(models)
    n = len(models)
    if n < 2:
        raise ValueError("model comparison needs at least two models")

    def per_model(arg, name):
        if arg is None:
            return [None] * n
        seq = list(arg)
        if seq and not np.iterable(seq[0]):      # one shared flat window
            return [seq] * n
        if len(seq) != n:
            raise ValueError(f"{name} must be shared or one entry per model "
                             f"({len(seq)} given for {n} models)")
        return seq

    if priors and callable(priors[0]):           # shared flat prior list
        ndims = {len(m.input_names) for m in models}
        if len(ndims) != 1:
            raise ValueError("a shared prior list requires all models to "
                             "have the same number of parameters; give one "
                             "prior list per model")
        priors = [list(priors)] * n
    elif len(priors) != n:
        raise ValueError(f"priors must be shared or one list per model "
                         f"({len(priors)} given for {n} models)")
    p_lo, p_up = per_model(p_lo, "p_lo"), per_model(p_up, "p_up")

    if labels is None:
        labels, seen = [], {}
        for m in models:
            base = type(m).__name__
            seen[base] = seen.get(base, 0) + 1
            labels.append(base if seen[base] == 1 else f"{base}#{seen[base]}")
    else:
        labels = [str(lb) for lb in labels]
        if len(labels) != n:
            raise ValueError(f"labels must be one per model "
                             f"({len(labels)} given for {n} models)")
        if len(set(labels)) != n:
            raise ValueError("labels must be unique")
    return models, priors, p_lo, p_up, labels


def compare_models(lc, models, priors, p_lo=None, p_up=None, labels=None, quiet=False,
                   **evidence_kwargs):
    """Bayes-factor model comparison: run ``lightcurve_evidence`` for each
    candidate model and rank them by log marginal likelihood (the JAX
    package's ``compare_models``).

    ``priors``: one prior list per model, or a single flat prior list shared
    by all models (only valid when every model has the same parameters).
    ``p_lo``/``p_up``: per-model sequences (or one shared window) bounding the
    walker initialization; None draws from the priors. ``labels``: display
    names, by default each model's class name (deduplicated with #k
    suffixes). ``evidence_kwargs`` go to ``lightcurve_evidence`` (nwalkers,
    n_rungs, nsteps, seed, device, ...); its checkpoint options are not
    ported (ROADMAP Queue 1 item 16) and raise NotImplementedError.

    Returns a Table ranked best-first with columns ``model``, ``log_z``,
    ``dlog_z`` (stepping-stone MC uncertainty), ``delta_log_z`` (log Bayes
    factor relative to the best model) and ``ddelta_log_z`` (its
    uncertainty, the two MC errors in quadrature); ``table.meta["info"]``
    keeps each run's ladder diagnostics.
    """
    from .utils.table import Table

    models, priors, p_lo, p_up, labels = _compare_args(models, priors, p_lo, p_up, labels)
    rows = []
    for label, model, pri, lo, up in zip(labels, models, priors, p_lo, p_up):
        log_z, log_z_err, info = lightcurve_evidence(lc, model, pri, p_lo=lo, p_up=up,
                                                     quiet=True, **evidence_kwargs)
        rows.append((label, log_z, log_z_err, info, pri))

    rows.sort(key=lambda r: -r[1])
    best_z, best_err = rows[0][1], rows[0][2]
    table = Table(
        [[r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
         [r[1] - best_z for r in rows],
         [0.0 if i == 0 else np.hypot(r[2], best_err) for i, r in enumerate(rows)]],
        names=["model", "log_z", "dlog_z", "delta_log_z", "ddelta_log_z"])
    table.meta["info"] = {r[0]: r[3] for r in rows}
    if not quiet:
        print("model comparison (log Bayes factors vs best; evidence is prior-sensitive):")
        for i, (label, log_z, err, _, pri) in enumerate(rows):
            mark = " <- preferred" if i == 0 else ""
            print(f"  {label}: log Z = {log_z:.2f} +/- {err:.2f}, "
                  f"delta = {log_z - best_z:+.2f}{mark}")
            print("    priors: " + ", ".join(repr(p) for p in pri))
    return table


class _PTFitResult:
    """Cold-rung (beta = 1) production states of a parallel-tempering run,
    exposing the sampler surface the rest of the workflow expects, plus the
    evidence the ladder yields for free."""

    def __init__(self, cold_chain, cold_logl, log_z, log_z_err, info):
        self._chain = cold_chain          # (nsteps, nwalkers, ndim)
        self.cold_logl = cold_logl
        self.log_z = log_z
        self.log_z_err = log_z_err
        self.info = info
        self.swap_rate = info["swap_rate"]
        self.acceptance_fraction = np.broadcast_to(
            info["acceptance"][-1], cold_chain.shape[1:2]).copy()

    @property
    def chain(self):
        return np.swapaxes(self._chain, 0, 1)

    @property
    def flatchain(self):
        return self._chain.reshape(-1, self._chain.shape[-1])

    @property
    def flatlnlikelihood(self):
        return self.cold_logl.reshape(-1)


def lightcurve_ptmcmc(lc, model, priors, p_lo=None, p_up=None, nwalkers=64, n_rungs=16,
                      nsteps=1000, nsteps_burnin=1000, use_sigma=False, sigma_type="relative",
                      seed=None, mesh=None, save_sampler_as="", quiet=False,
                      checkpoint_every=None, checkpoint_file=None, resume_from=None,
                      state_dtype="auto", device=None):
    """Parallel-tempering fit: robust to multimodal posteriors, and the
    evidence comes free.

    A ladder of tempered ensembles (hot rungs see a flattened likelihood and
    roam between modes; replica-exchange swaps carry their states down to the
    cold beta = 1 rung) runs through the K6 kernels on CUDA, as
    :func:`lightcurve_evidence` does, and the replica exchange also writes
    the cold rung's states into a device chain. Same signature and behavior
    as the JAX package's ``lightcurve_ptmcmc``, plus ``device``; ``mesh``
    (ROADMAP Queue 1 item 17) and the checkpoint options (item 16) raise
    NotImplementedError.

    Returns a :class:`_PTFitResult`: ``flatchain``/``chain`` are the cold
    rung's production states (absolute parameters), ``log_z``/``log_z_err``
    the evidence, ``swap_rate`` the per-rung exchange acceptance (healthy
    ladders sit around 0.2-0.8; a rate near 0 flags a temperature gap).
    """
    from .parallel.evidence import refuse_unported, stepping_stone_evidence
    refuse_unported(mesh, checkpoint_every, checkpoint_file, resume_from)
    device = resolve_device(device)
    priors, log_likelihood, p0, state_kw = _tempered_setup(
        lc, model, priors, p_lo, p_up, nwalkers, use_sigma, sigma_type, seed, state_dtype,
        device)
    log_z, log_z_err, info = stepping_stone_evidence(
        priors, log_likelihood, p0, n_rungs=n_rungs, nsteps=nsteps, nsteps_burnin=nsteps_burnin,
        seed=seed if seed is not None else 0, return_cold_chain=True, **_ladder_kwargs(state_kw))
    cold = info.pop("cold_chain")
    if state_kw:
        # map the rescaled float32 cold chain back to absolute parameters
        cold = np.asarray(cold, np.float64) * state_kw["param_scale"] + state_kw["param_offset"]
    result = _PTFitResult(cold, info.pop("cold_logl"), log_z, log_z_err, info)
    if save_sampler_as:
        np.save(save_sampler_as, result.flatchain)
        print("saving sampler.flatchain as " + save_sampler_as)
    if not quiet:
        print(f"PT: {n_rungs + 1} rungs x {nwalkers} walkers x {nsteps} steps; "
              f"cold acceptance {info['acceptance'][-1]:.2f}, swap rates "
              f"{info['swap_rate'].min():.2f}-{info['swap_rate'].max():.2f}; "
              f"log evidence {log_z:.2f} +/- {log_z_err:.2f}")
        try:
            goodness_of_fit(lc, model, result.flatchain, use_sigma=use_sigma,
                            sigma_type=sigma_type, device=device)
        except Exception as exc:  # diagnostics must never kill a finished fit
            print(f"(goodness-of-fit unavailable: {exc})")
    return result


# --------------------------------------------------------------------------
# posterior diagnostics: goodness of fit and predictive model comparison
# (no reference counterpart: the reference's workflow ends at the corner plot)
# --------------------------------------------------------------------------

def _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type, kind, device=None):
    """Per-draw discrepancies of a posterior sample against the light
    curve's photometry, in one batched evaluation on ``device`` (default:
    CUDA): ``kind="chi2"`` gives the (S,) summed chi-square of each draw,
    ``kind="pointwise_ll"`` the (S, N) per-point Gaussian log-densities (the
    likelihood's variance model; absolute densities: the -log(yscale)
    Jacobian of the data normalization is added back).

    The model's ``_eval_points`` evaluates every draw at once as (S, 1)
    parameter columns: on CUDA the band table as torch ops, K3 for
    ShockCooling3, K8 for the companion-shocking models. The draws reach the
    host only as the result. Returns ``(values, yscale, n_points)``."""
    from .models.base import _quad_tensors
    device = resolve_device(device)
    _derive_fit_columns(lc, model)
    oq = model.output_quantity
    f = np.asarray(lc["filter"])
    t = np.asarray(lc["MJD"], float)
    y = np.asarray(lc[oq], float)
    dy = np.asarray(lc["d" + oq], float)
    n_model = np.shape(draws)[1] - (1 if use_sigma else 0)
    # the likelihood's O(1) data normalization (chi-square is invariant under
    # it; the log densities regain its Jacobian below)
    yscale, y_n, dy_n, sigma_units = model._normalized_data(y, dy, sigma_type)

    def f64(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=device)

    p = f64(draws)
    quad = _quad_tensors(model.prepare_quad(f), device)
    y_fit = model._eval_points(f64(t), quad, *[p[:, i:i + 1] for i in range(n_model)])
    y_fit = y_fit.to(torch.float64) * (1.0 / yscale)
    sigma2 = f64(dy_n) ** 2.0
    if use_sigma:
        sigma2 = sigma2 + (p[:, -1:] * f64(sigma_units)) ** 2.0
    r2 = (f64(y_n) - y_fit) ** 2.0 / sigma2
    if kind == "chi2":
        out = torch.sum(r2, dim=-1)
    else:
        out = -0.5 * (torch.log(2.0 * np.pi * sigma2) + r2)
    out = out.cpu().numpy()
    if kind == "pointwise_ll":
        out = out - np.log(yscale)
    return out, yscale, len(y)


def goodness_of_fit(lc, model, flatchain, use_sigma=False, sigma_type="relative", n_draws=512,
                    seed=0, quiet=False, best=None, device=None):
    """Posterior-predictive goodness of fit of a completed fit, the JAX
    package's ``goodness_of_fit`` plus ``device`` (default CUDA).

    For ``n_draws`` posterior samples theta_j it computes the discrepancy
    chi2_j = sum_i ((y_i - m_i(theta_j)) / sigma_ij)^2 in one batched device
    call (sigma_ij with the intrinsic scatter when ``use_sigma``), and the
    posterior-predictive p-value p = mean_j SF_chi2(chi2_j; N) (Gelman et
    al. 1996; given theta the replicated discrepancy is chi-square with N
    degrees of freedom, so no replicates are drawn). The reduced chi-square
    is reported at the best evaluated draw; ``best`` (the MAP point of
    :func:`lightcurve_map`) is always evaluated and joins that minimum, not
    the p-value.

    Returns a dict with ``chi2``, ``dof`` (N - ndim), ``chi2_nu``,
    ``p_value``, ``n_points`` and ``n_invalid_draws`` (draws whose chi2 is
    not finite, excluded from the score)."""
    from scipy.stats import chi2 as _chi2_dist

    flatchain = np.asarray(flatchain, float)
    ndim = flatchain.shape[1]

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), len(flatchain))
    draws = flatchain[rng.choice(len(flatchain), n_draws, replace=False)]
    # row 0 optionally carries the caller's best point: it scores the chi2
    # minimum, not the p-value average
    n_extra = 0
    if best is not None:
        draws = np.concatenate([np.asarray(best, float)[None], draws])
        n_extra = 1
    chi2_all, _, npts = _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type,
                                               kind="chi2", device=device)
    chi2_draws = chi2_all[n_extra:]
    finite = np.isfinite(chi2_draws)
    n_bad = int(np.sum(~finite))
    chi2_draws = chi2_draws[finite]
    chi2_pool = np.concatenate([chi2_all[:n_extra][np.isfinite(chi2_all[:n_extra])],
                                chi2_draws])
    if len(chi2_pool) == 0:
        out = {"chi2": np.nan, "dof": npts - ndim, "chi2_nu": np.nan,
               "p_value": np.nan, "n_points": npts, "n_invalid_draws": n_bad}
        if not quiet:
            print("goodness of fit: unavailable — every posterior draw "
                  "evaluated outside the model's validity window")
        return out
    p_value = float(np.mean(_chi2_dist.sf(chi2_draws, npts))) if len(chi2_draws) else np.nan

    chi2_best = float(np.min(chi2_pool))
    dof = npts - ndim
    out = {"chi2": chi2_best, "dof": dof,
           "chi2_nu": chi2_best / dof if dof > 0 else np.nan,
           "p_value": p_value, "n_points": npts, "n_invalid_draws": n_bad}
    if not quiet:
        note = (f" ({n_bad}/{n_bad + len(chi2_draws)} draws outside the "
                f"model's validity window were excluded)" if n_bad else "")
        print(f"goodness of fit: chi^2/dof = {chi2_best:.1f}/{dof} "
              f"= {out['chi2_nu']:.2f} at the best posterior draw; "
              f"posterior-predictive p = {p_value:.3f}{note}")
    return out


def _exact_cv_elpd(lc, model, priors, masks, use_sigma, sigma_type, flatchain, n_draws, seed,
                   refit_options, device=None):
    """Exact leave-out cross-validation of unreliable PSIS terms, the JAX
    package's ``_exact_cv_elpd`` plus ``device`` (default CUDA): the model
    refit without each ``masks`` entry's points (boolean (N,) arrays, True on
    the held-out points), all in one ``fit_population`` call (64 walkers x
    500 + 500 steps, MAP-seeded, unless ``refit_options`` says otherwise)
    in the chain's [2, 98] percentile box, then the held-out scores
    (:func:`_held_out_elpd`): elpd_g = log mean_s exp(sum_{i in g}
    ll(y_i | theta_s^(-g))). The box: a dimension the chain pins is widened
    by 1e-8 of its value (at least 1e-8), the box is clipped to the prior
    support, and a dimension the clip collapsed (a chain pinned at a bound)
    is regrown inside it, down from the upper bound where there is room,
    else up from the lower one. Returns (elpd (G,), refit acceptance
    (G,)); an entry is NaN where fewer than 8 draws score finitely on its
    held-out points."""
    from .parallel.population import fit_population

    chain = np.asarray(flatchain, float)
    p_lo = np.percentile(chain, 2.0, axis=0)
    p_up = np.percentile(chain, 98.0, axis=0)
    degenerate = ~(p_up > p_lo)
    if np.any(degenerate):
        eps = np.maximum(1e-8, 1e-8 * np.abs(p_lo))
        p_lo = np.where(degenerate, p_lo - eps, p_lo)
        p_up = np.where(degenerate, p_up + eps, p_up)
    lo_b = np.array([getattr(p, "p_min", -np.inf) for p in priors], float)
    up_b = np.array([getattr(p, "p_max", np.inf) for p in priors], float)
    p_lo = np.clip(p_lo, lo_b, up_b)
    p_up = np.clip(p_up, lo_b, up_b)
    collapsed = ~(p_up > p_lo)
    if np.any(collapsed):
        width = np.minimum(np.maximum(1e-8, 1e-8 * np.abs(p_up)), up_b - lo_b)
        grow_down = collapsed & (p_up - width >= lo_b)
        p_lo = np.where(grow_down, p_up - width, p_lo)
        p_up = np.where(collapsed & ~grow_down, p_lo + width, p_up)

    lcs = [lc[~m] for m in masks]
    models = [model.clone_for(sub) for sub in lcs]
    opts = dict(nwalkers=64, nsteps=500, nsteps_burnin=500, init="map")
    opts.update(refit_options or {})
    flat, acc = fit_population(models, lcs, priors, p_lo=p_lo, p_up=p_up, use_sigma=use_sigma,
                               sigma_type=sigma_type, seed=seed, device=device, **opts)
    return (_held_out_elpd(lc, model, flat, masks, use_sigma, sigma_type, n_draws, seed, device),
            np.asarray(acc))


def _refit_init(refit_options):
    """The refits' ``init``: :func:`_exact_cv_elpd`'s default, "map", unless
    ``refit_options`` says otherwise."""
    return (refit_options or {}).get("init", "map")


def _held_out_elpd(lc, model, flat, masks, use_sigma, sigma_type, n_draws, seed, device=None):
    """The exact-refit CV's scores: ``n_draws`` of each refit's draws
    (``flat`` (G, M, ndim), numpy's default_rng(seed) choosing the same
    columns for every refit) scored on the full curve in one
    :func:`_posterior_discrepancy` call on ``device``, each refit's held-out
    points' log-densities summed a draw, then log mean exp over its finite
    sums (:func:`~.parallel.ic._logsumexp`); NaN for a refit with fewer than
    8. Returns (G,)."""
    from .parallel.ic import _logsumexp

    flat = np.asarray(flat, float)
    G = len(masks)
    rng = np.random.default_rng(seed)
    nd = min(int(n_draws), flat.shape[1])
    idx = rng.choice(flat.shape[1], nd, replace=False)
    draws = flat[:, idx, :].reshape(G * nd, flat.shape[2])
    ll, _, _ = _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type,
                                      kind="pointwise_ll", device=device)
    ll = ll.reshape(G, nd, -1)
    elpd = np.full(G, np.nan)
    for g, m in enumerate(masks):
        llg = ll[g][:, m].sum(axis=1)
        llg = llg[np.isfinite(llg)]
        if len(llg) >= 8:
            elpd[g] = float(_logsumexp(llg) - np.log(len(llg)))
    return elpd


def _apply_refit(res, pointwise_key, elpd_key, se_key, masks, bad_idx, group_names, lc, model,
                 priors, use_sigma, sigma_type, flatchain, n_draws, seed, refit_options,
                 device=None):
    """Patch a PSIS result dict in place with the exact-refit CV values of
    its flagged entries (``bad_idx``; :func:`_exact_cv_elpd`), recompute
    its elpd and standard error, and record the provenance under
    ``res["refit"]``: ``method``, ``labels`` (the entries actually repaired),
    ``elpd_psis`` and ``elpd_exact`` (theirs), ``failed_labels`` (refits
    with no finite held-out score, left on the PSIS value), ``acceptance``
    (every refit's) and ``n_failed``."""
    elpd_exact, acc = _exact_cv_elpd(lc, model, priors, masks, use_sigma, sigma_type, flatchain,
                                     n_draws, seed, refit_options, device)
    ok = np.isfinite(elpd_exact)
    pw = np.asarray(res[pointwise_key], float).copy()
    elpd_psis = pw[bad_idx].copy()
    pw[bad_idx[ok]] = elpd_exact[ok]
    n = len(pw)
    res[pointwise_key] = pw
    res[elpd_key] = float(np.sum(pw))
    res[se_key] = float(np.sqrt(n * np.var(pw, ddof=1))) if n > 1 else np.nan
    group_names = np.asarray(group_names)
    res["refit"] = {
        "method": "exact_refit_cv",
        "labels": group_names[ok],
        "elpd_psis": elpd_psis[ok],
        "elpd_exact": elpd_exact[ok],
        "failed_labels": group_names[~ok],
        "acceptance": acc,
        "n_failed": int(np.sum(~ok)),
    }
    return res


def information_criteria(lc, model, flatchain, use_sigma=False, sigma_type="relative",
                         n_draws=1024, seed=0, group_by=None, refit=False, priors=None,
                         refit_options=None, quiet=False, device=None):
    """WAIC and PSIS-LOO predictive scores of a completed fit, the JAX
    package's ``information_criteria`` plus ``device`` (default CUDA): the
    (draws x points) pointwise log-likelihood matrix in one batched device
    call (:func:`_posterior_discrepancy`), then the host statistics of
    ``parallel/ic.py`` (Vehtari, Gelman & Gabry 2017).

    Returns a dict with ``elpd_loo``, ``se_elpd_loo``, ``p_loo``, ``looic``,
    ``pareto_k``, ``elpd_waic``, ``se_elpd_waic``, ``p_waic``, ``waic``,
    ``pointwise`` (per-point LOO elpd, for
    :func:`compare_information_criteria`), ``pointwise_waic``, ``n_points``
    and ``n_invalid_draws``. ``group_by`` (a column name such as
    ``"filter"``, or one label a point) adds leave-one-group-out scores
    under ``out["logo"]``.

    ``refit`` repairs the unreliable PSIS terms by exact cross-validation:
    every point (and, with ``group_by``, every group) whose ``pareto_k``
    exceeds the threshold (0.7 for ``refit=True``, else the float given; a
    NaN k counts as unreliable) is re-scored by refitting the model without
    it, all of a kind's refits in one ``fit_population`` call on ``device``
    (:func:`_exact_cv_elpd`), and the patched result records the provenance
    under ``out["refit"]`` and ``out["logo"]["refit"]``; ``pareto_k`` keeps
    the PSIS diagnostics. It needs ``priors`` (the fit's, with the intrinsic
    scatter's prior when ``use_sigma``) and a class the population fits on
    ``device`` (``parallel.population.check_model_class``: on the CPU every
    class of the JAX function; on CUDA ShockCooling2, and ShockCooling and
    ShockCooling4 with ``refit_options={"init": "window"}``; otherwise
    NotImplementedError naming ROADMAP Queue 1 item 10 or 22), both checked
    at entry; ``refit_options`` go to ``fit_population`` (``nwalkers``,
    ``nsteps``, ``nsteps_burnin``, ``init``)."""
    from .parallel.ic import (waic as _waic, psis_loo as _psis_loo, psis_logo,
                              _logsumexp as _ic_logsumexp)
    from .parallel.population import check_model_class

    if refit is not False:
        # checked at entry, not when something happens to be flagged
        if priors is None:
            raise ValueError("refit of unreliable PSIS terms needs the fit's priors: pass "
                             "priors=[...] (including the intrinsic-scatter prior when "
                             "use_sigma=True)")
        check_model_class(model, device, _refit_init(refit_options))

    flatchain = np.asarray(flatchain, float)

    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), len(flatchain))
    draws = flatchain[rng.choice(len(flatchain), n_draws, replace=False)]
    ll, _, _ = _posterior_discrepancy(lc, model, draws, use_sigma, sigma_type,
                                      kind="pointwise_ll", device=device)
    # drop draws outside the model's validity window (nan/inf rows), as in
    # goodness_of_fit
    good = np.all(np.isfinite(ll), axis=1)
    n_bad = int(np.sum(~good))
    ll = ll[good]
    if len(ll) < 8:
        raise RuntimeError("fewer than 8 finite posterior draws — the chain "
                           "does not sample the model's validity window")

    loo = _psis_loo(ll)
    wa = _waic(ll)
    out = {"elpd_loo": loo["elpd_loo"], "se_elpd_loo": loo["se_elpd_loo"],
           "p_loo": loo["p_loo"], "looic": loo["looic"],
           "pareto_k": loo["pareto_k"],
           "elpd_waic": wa["elpd_waic"], "se_elpd_waic": wa["se_elpd_waic"],
           "p_waic": wa["p_waic"], "waic": wa["waic"],
           "pointwise": loo["pointwise"], "pointwise_waic": wa["pointwise"],
           "n_points": ll.shape[1], "n_invalid_draws": n_bad}

    threshold = 0.7 if refit is True else refit
    N = ll.shape[1]
    refit_kw = dict(lc=lc, model=model, priors=priors, use_sigma=use_sigma,
                    sigma_type=sigma_type, flatchain=flatchain, n_draws=n_draws, seed=seed,
                    refit_options=refit_options, device=device)
    if refit is not False:
        bad_pts = np.flatnonzero(~(out["pareto_k"] <= threshold))
        if len(bad_pts):
            masks = [np.arange(N) == i for i in bad_pts]
            _apply_refit(out, "pointwise", "elpd_loo", "se_elpd_loo", masks, bad_pts, bad_pts,
                         **refit_kw)
            out["looic"] = -2.0 * out["elpd_loo"]
            lppd = float(np.sum(_ic_logsumexp(ll, axis=0) - np.log(len(ll))))
            out["p_loo"] = lppd - out["elpd_loo"]

    if group_by is not None:
        labels = (np.asarray(lc[group_by]) if isinstance(group_by, str)
                  else np.asarray(group_by))
        lg = out["logo"] = psis_logo(ll, labels)
        if refit is not False:
            bad_g = np.flatnonzero(~(lg["pareto_k"] <= threshold))
            if len(bad_g):
                masks = [labels == lg["groups"][j] for j in bad_g]
                _apply_refit(lg, "pointwise", "elpd_logo", "se_elpd_logo", masks, bad_g,
                             lg["groups"][bad_g], **refit_kw)
    if not quiet:
        def _notes(res, n_total, kind):
            # the refit's provenance prints whenever a repair ran, whatever
            # the 0.7 count (a custom threshold repairs terms below it)
            parts = []
            n_hi = int(np.sum(res["pareto_k"] > 0.7))
            if n_hi:
                parts.append(f"{n_hi}/{n_total} {kind} have pareto_k > 0.7"
                             + (" (unreliable LOO terms)" if kind == "points" else ""))
            if "refit" in res:
                nf = res["refit"]["n_failed"]
                parts.append(f"{len(res['refit']['labels'])} repaired by exact refit CV"
                             + (f" ({nf} refits failed)" if nf else ""))
            return "; " + "; ".join(parts) if parts else ""

        print(f"elpd_loo = {out['elpd_loo']:.1f} +/- {out['se_elpd_loo']:.1f} "
              f"(p_loo = {out['p_loo']:.1f}); "
              f"elpd_waic = {wa['elpd_waic']:.1f} +/- {wa['se_elpd_waic']:.1f}"
              f"{_notes(out, ll.shape[1], 'points')}")
        if group_by is not None:
            lg = out["logo"]
            print(f"leave-one-group-out ({len(lg['groups'])} groups): "
                  f"elpd_logo = {lg['elpd_logo']:.1f} "
                  f"+/- {lg['se_elpd_logo']:.1f}"
                  f"{_notes(lg, len(lg['groups']), 'groups')}")
    return out


def compare_information_criteria(ics, labels=None, quiet=False):
    """Rank fitted models by PSIS-LOO elpd with paired standard errors (the
    JAX package's ``compare_information_criteria``).

    ``ics``: :func:`information_criteria` results of models scored on the
    same light curve. Returns a Table ranked best-first with columns
    ``model``, ``elpd_loo``, ``d_elpd`` (difference to the best model, <= 0),
    ``se_d_elpd`` (the paired pointwise SE of that difference, Vehtari+17
    eq. 24) and ``stacking_weight`` (Yao+18 Bayesian-stacking weights)."""
    from .parallel.ic import compare_elpd, stacking_weights
    from .utils.table import Table

    ics = list(ics)
    if labels is None:
        labels = [f"model#{i}" for i in range(len(ics))]
    if len(labels) != len(ics) or len(set(labels)) != len(labels):
        raise ValueError("labels must be one per model and unique")
    ranked = compare_elpd([ic["pointwise"] for ic in ics], list(labels))
    w = stacking_weights([ic["pointwise"] for ic in ics])
    weight = dict(zip(labels, w))
    tab = Table([[r["label"] for r in ranked],
                 [r["elpd"] for r in ranked],
                 [r["d_elpd"] for r in ranked],
                 [r["se_d_elpd"] for r in ranked],
                 [weight[r["label"]] for r in ranked]],
                names=["model", "elpd_loo", "d_elpd", "se_d_elpd", "stacking_weight"])
    if not quiet:
        print("model ranking by PSIS-LOO elpd (best first):")
        for r in ranked:
            if r["d_elpd"] == 0.0:
                print(f"  {r['label']}: elpd_loo = {r['elpd']:.1f} (best), "
                      f"stacking weight {weight[r['label']]:.3f}")
            else:
                print(f"  {r['label']}: elpd_loo = {r['elpd']:.1f} "
                      f"(d_elpd = {r['d_elpd']:.1f} +/- {r['se_d_elpd']:.1f}), "
                      f"stacking weight {weight[r['label']]:.3f}")
    return tab


def compare_models_loo(lc, models, priors, p_lo=None, p_up=None, labels=None, nwalkers=100,
                       nsteps=1000, nsteps_burnin=1000, use_sigma=False, sigma_type="relative",
                       seed=None, n_draws=1024, refit=False, refit_options=None, group_by=None,
                       quiet=False, device=None, **mcmc_kwargs):
    """Chain-based model comparison in one call, the JAX package's
    ``compare_models_loo`` plus ``device`` (default CUDA): every candidate
    is fit with :func:`lightcurve_mcmc`, scored by PSIS-LOO
    (:func:`information_criteria`) and ranked with paired standard errors
    (:func:`compare_information_criteria`).

    Arguments shape-match :func:`compare_models` (shared or per-model priors,
    windows and labels); ``mcmc_kwargs`` go to every :func:`lightcurve_mcmc`
    call; ``refit``, ``refit_options`` and ``group_by`` to every
    :func:`information_criteria` (each candidate's priors back its own
    refits; with ``refit`` every model is checked for a class the
    population can fit on ``device`` before the first fit). Not ported yet, and refused
    with NotImplementedError: ``checkpoint_file``/``resume_from`` (ROADMAP
    Queue 1 item 16).

    Returns the :func:`compare_information_criteria` Table;
    ``table.meta["ics"]``, ``["samplers"]`` and ``["models"]`` keep each
    model's scores, fitted sampler and model, keyed by label."""
    if mcmc_kwargs.get("checkpoint_file") is not None \
            or mcmc_kwargs.get("resume_from") is not None:
        raise NotImplementedError("checkpoint/resume is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    models, priors, p_lo, p_up, labels = _compare_args(models, priors, p_lo, p_up, labels)
    if refit is not False:
        from .parallel.population import check_model_class
        for model in models:
            check_model_class(model, device, _refit_init(refit_options))
    ics, samplers = {}, {}
    for label, model, pri, lo, up in zip(labels, models, priors, p_lo, p_up):
        sampler = lightcurve_mcmc(lc, model, priors=pri, p_lo=lo, p_up=up, nwalkers=nwalkers,
                                  nsteps=nsteps, nsteps_burnin=nsteps_burnin,
                                  use_sigma=use_sigma, sigma_type=sigma_type, seed=seed,
                                  quiet=True, device=device, **mcmc_kwargs)
        ics[label] = information_criteria(lc, model, sampler.flatchain, use_sigma=use_sigma,
                                          sigma_type=sigma_type, n_draws=n_draws,
                                          seed=0 if seed is None else seed, refit=refit,
                                          priors=pri, refit_options=refit_options,
                                          group_by=group_by, quiet=True, device=device)
        samplers[label] = sampler
    tab = compare_information_criteria([ics[lb] for lb in labels], labels=labels, quiet=quiet)
    tab.meta["ics"] = ics
    tab.meta["samplers"] = samplers
    tab.meta["models"] = dict(zip(labels, models))
    tab.meta["use_sigma"] = use_sigma
    if not quiet:
        worst = max(int(np.sum(ics[lb]["pareto_k"] > 0.7)) for lb in labels)
        if worst:
            print(f"  (up to {worst} points per model have pareto_k > 0.7 — "
                  "expected under misspecification, but verify convergence)")
    return tab
