"""Model-fit driver: the flagship ensemble-MCMC fit.

Covers ``lightcurve_fitting_tpu/fitting.py``'s ``make_log_posterior`` and
``lightcurve_mcmc`` (reference fitting.py:16-168) with its setup helpers. The
log-posterior is an ``nn.Module`` (:class:`LogPosterior`) over a leading
walker axis; on a CUDA device the fit runs through the fused kernels of its
model (``kernels/``: K1 and K2 for ShockCooling2, the SC3 log-posterior and
half-step over K3 for ShockCooling3), on the CPU through their plain
PyTorch versions.

The HMC, MAP, evidence, tempering, goodness-of-fit and plotting drivers of
the JAX module wait for ROADMAP Queue 1 items 11-18.
"""

import warnings

import numpy as np
import torch
from torch import nn

from .models import UniformPrior
from .parallel.sampler import EnsembleSampler
from .utils import units as u

__all__ = ["lightcurve_mcmc", "make_log_posterior", "LogPosterior"]

PRIOR_WARNING = "The p_max/p_min keywords are deprecated. Use the priors keyword instead."
MODEL_KWARGS_WARNING = "The model_kwargs keyword is deprecated. These are now included in the model intialization."


def _default_device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class LogPosterior(nn.Module):
    """Sum of prior log-densities (-inf outside bounds) plus the Gaussian
    log-likelihood, ``forward(p (W, ndim) float64) -> (W,) float64``
    (reference fitting.py:121-128, without the Python early-exit).

    On a CUDA tensor ``forward`` launches the fused log-posterior kernel
    of the model (ShockCooling2 or ShockCooling3; any other model raises);
    on a CPU tensor it runs :meth:`forward_plain`."""

    def __init__(self, log_likelihood, priors):
        super().__init__()
        self.log_likelihood = log_likelihood
        self.priors = list(priors)

    def forward_plain(self, p):
        """The plain PyTorch log-posterior of each row of ``p``."""
        squeeze = p.ndim == 1
        p = p.reshape(-1, p.shape[-1])
        log_prior = 0.0
        for i, prior in enumerate(self.priors):
            log_prior = log_prior + prior(p[:, i])
        ll = self.log_likelihood(p)
        ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))
        out = torch.where(torch.isfinite(log_prior), log_prior + ll,
                          torch.full_like(log_prior, -torch.inf))
        return out[0] if squeeze else out

    def forward(self, p):
        from . import kernels
        squeeze = p.ndim == 1
        out = kernels.log_posterior(self, p.reshape(-1, p.shape[-1]).contiguous())
        return out[0] if squeeze else out


def make_log_posterior(model, lc, priors, use_sigma=False, sigma_type="relative", device=None):
    """Build the :class:`LogPosterior` of ``model`` on ``lc`` with its
    buffers on ``device`` (default: CUDA when available, else the CPU)."""
    device = torch.device(device) if device is not None else _default_device()
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
    (default: ``"cuda"`` when available, else ``"cpu"``). On CUDA every
    half-step is one launch of the model's fused half-step kernel (K2 for
    ShockCooling2, its SC3 instantiation for ShockCooling3; other models
    raise) and the walker state is float32 over the rescaled init window
    (``state_dtype="auto"``); on the CPU the plain PyTorch step runs on
    absolute float64 state.

    * ``seed`` makes the chains reproducible: the draws of global step i
      depend only on (seed, i), so progress segments do not change the chain;
    * ``quiet=False`` prints acceptance + autocorrelation/ESS after the
      production run. The JAX driver's goodness-of-fit print is not called
      here (ROADMAP Queue 1 item 15).

    Not ported yet, and refused with ``NotImplementedError``: ``replicas > 1``
    (ROADMAP Queue 1 item 4), ``mesh`` and ``shard=True`` (item 17),
    ``init="map"`` (item 11), ``checkpoint_every``, ``checkpoint_file`` and
    ``resume_from`` (item 16).

    Returns an :class:`~lightcurve_fitting_tpu_torch.parallel.sampler.EnsembleSampler`
    exposing the emcee attributes the reference workflow uses (``flatchain``,
    ``chain``).
    """
    if model_kwargs is not None:
        raise Exception(MODEL_KWARGS_WARNING)
    if checkpoint_every is not None or checkpoint_file is not None or resume_from is not None:
        raise NotImplementedError("checkpoint/resume is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")
    if init == "map":
        raise NotImplementedError('init="map" is not ported yet (ROADMAP Queue 1 item 11)')
    if init != "window":
        raise ValueError('init must be "window" or "map"')
    device = torch.device(device) if device is not None else _default_device()

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
