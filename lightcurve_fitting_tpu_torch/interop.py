"""Build the port's objects from what the JAX package produces, without
importing it: its host outputs are numpy arrays and plain Python objects.

Used to feed both packages identical inputs (the parity tests) and to carry
a fit's setup or walker state across to the GPU.
"""

import numpy as np
import torch

from .core import config
from .models.base import LogLikelihood
from .models import priors as _priors

__all__ = ["log_likelihood_from_numpy", "priors_from_jax", "walkers_from_numpy",
           "bounds_from_jax", "whitening_from_jax", "adaptation_from_jax"]


def log_likelihood_from_numpy(quad, t, y, dy, use_sigma=False, sigma_type="relative",
                              device="cpu", dtype=None, model=None):
    """The port's :class:`~lightcurve_fitting_tpu_torch.models.base.LogLikelihood`
    from the numpy dict of ``Model.prepare_quad`` (either package: the
    Chebyshev table rows, or the quadrature ``nodes``/``weights``/``k_ext``
    per point with ``band_ids``) and the photometry ``t, y, dy``.

    ``model`` is the port model whose physics the likelihood evaluates
    (default: a ShockCooling2, the flagship; a ShockCooling3 takes the
    quadrature dict; a companion-shocking model takes the table dict with
    the SiFTO entries of its ``prepare_quad``, to which the per-band rows
    of ``sifto_band_rows`` are added where the dict lacks them). ``dtype``
    is the compute dtype the buffers must have; it has to agree with what
    ``core.config`` resolves for ``device`` (set it with
    ``config.set_compute_dtype``), because the plain path reads the
    configuration when it runs."""
    device = torch.device(device)
    resolved = config.get_compute_dtype(device) or torch.float64
    if dtype is not None and dtype != resolved:
        raise ValueError(f"dtype {dtype} disagrees with the compute dtype {resolved} "
                         f"configured for {device}; use core.config.set_compute_dtype")
    if model is None:
        from .models import ShockCooling2
        model = ShockCooling2(device=device)
    quad = {k: np.asarray(v) for k, v in quad.items()}
    if "sifto_c" in quad and "sifto_rows" not in quad:
        from .models.companion_shocking import sifto_band_rows
        quad["sifto_rows"], quad["sifto_band"] = sifto_band_rows(quad["sifto_c"], quad["band_ids"])
    return LogLikelihood.from_quad(model, quad, t, y, dy, use_sigma, sigma_type, device=device)


def priors_from_jax(priors):
    """Port priors with the same bounds and parameters as the given JAX
    package priors (matched by class name)."""
    out = []
    for p in priors:
        name = type(p).__name__
        if name == "GaussianPrior":
            out.append(_priors.GaussianPrior(float(p.p_min), float(p.p_max),
                                             float(p.mean), float(p.stddev)))
        elif name in ("UniformPrior", "LogUniformPrior"):
            out.append(getattr(_priors, name)(float(p.p_min), float(p.p_max)))
        else:
            raise NotImplementedError(f"{name} has no port counterpart here (KDEPrior: ROADMAP "
                                      "Queue 1 item 12)")
    return out


def walkers_from_numpy(pos, logp, offset=None, scale=None, device="cpu"):
    """A walker state ``(x (2, half, ndim), logp (2, half) float64)`` on
    ``device`` from numpy positions (W, ndim) or an internal (2, half, ndim)
    state and their log-probabilities.

    With ``offset``/``scale``, ``pos`` is absolute and is rescaled to the
    internal space ``(pos - offset) / scale``, as ``EnsembleSampler.run_mcmc``
    does. The state is float32 when rescaled (the CUDA path's state) and
    float64 otherwise."""
    pos = np.asarray(pos, float)
    ndim = pos.shape[-1]
    pos = pos.reshape(-1, ndim)
    if pos.shape[0] % 2:
        raise ValueError("the walker count must be even")
    if offset is not None:
        pos = (pos - np.asarray(offset, float)) / np.asarray(scale, float)
    dtype = torch.float32 if offset is not None else torch.float64
    half = pos.shape[0] // 2
    x = torch.tensor(pos.reshape(2, half, ndim), device=device).to(dtype)
    lp = torch.tensor(np.array(logp, float).reshape(2, half), device=device)
    return x, lp


def bounds_from_jax(bounds):
    """The port's BoundsTransform with the bounds of a JAX package
    ``BoundsTransform``."""
    from .parallel.hmc import BoundsTransform
    return BoundsTransform(np.asarray(bounds.lower, float), np.asarray(bounds.upper, float))


def whitening_from_jax(white):
    """The port's WhitenedPosterior with the (mean, Cholesky factor) of a JAX
    package ``WhitenedPosterior``, bit for bit."""
    from .parallel.hmc import WhitenedPosterior
    return WhitenedPosterior.from_moments(np.asarray(white.mean, float),
                                          np.asarray(white.L, float))


def adaptation_from_jax(jax_sampler, sampler):
    """Copy the adapted ``step_size`` and ``inv_mass`` of a JAX package
    ``NUTSSampler`` or ``HMCSampler`` into the port's ``sampler``, so that a
    continuation (``run_mcmc(..., n_warmup=0)``) samples with them."""
    sampler.step_size = float(jax_sampler.step_size)
    sampler.inv_mass = np.asarray(jax_sampler.inv_mass, float).copy()
    return sampler
