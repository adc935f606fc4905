"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers
and their plain PyTorch versions.

* ``csrc/sc2_logpost.cu`` (:mod:`.sc2`): K1, the fused ShockCooling2
  log-posterior, and K2, the stretch-move half-step over it.
* ``csrc/sc3_logpost.cu`` (:mod:`.sc3`): K3, the quadrature band flux, and
  the fused ShockCooling3 log-posterior and half-step built on it.
* ``csrc/sc_logpost.cu`` (:mod:`.sc`, :mod:`.sc4`): the fused ShockCooling
  (SW17) and ShockCooling4 (MSW23) log-posteriors over the band table
  (``csrc/band_table.cuh``, the staging K1 shares), their half-steps and
  their tempered-ladder instantiations.
* ``csrc/epoch_bb.cu`` (:mod:`.epoch_bb`): K4, the per-epoch blackbody
  log-posterior of the batched bolometric path and its gradient, the
  half-step over E epochs at once, and K4s, the posterior-summary rows.
* ``csrc/quantile.cu`` (:mod:`.quantile`): K5, exact percentiles of float32
  rows by counting bisection.
* ``csrc/ladder.cuh`` and ``csrc/ladder.cu`` (:mod:`.ladder`): K6, the
  tempered ladder: its half-step and initial state (templates instantiated
  for every model with kernels in its source), the replica
  exchange and the stepping-stone block terms.
* ``csrc/gradient.cuh`` (:mod:`.sc2` for K7, :mod:`.gradient` for K9 and
  K7h): the gradient path over ShockCooling2, templates instantiated in
  ``sc2_logpost.cu``: K7, the log-posterior and its gradient (one warp per
  walker), K9, the NUTS transition, and K7h, the HMC transition, both in
  the whitened space of the gradient samplers.
* ``csrc/companion.cu`` (:mod:`.cs`): K8, the SiFTO spline, and the fused
  log-posterior of CompanionShocking 1-3 with its half-step and its
  tempered-ladder instantiations.
* ``csrc/sed.cu`` (:mod:`.sed`): K10, the SED log-posterior of one epoch's
  blackbody fit (``bolometric.SEDLogPosterior``, its band-table form, the
  KDE prior inside it), its half-step, and its run form (a whole segment
  of steps in one launch): the sequential bolometric path's
  ``spectrum_mcmc``.
* ``csrc/population.cu`` (:mod:`.pop`): the population fit's per-transient
  ShockCooling2 kernels, P1 (the log-posterior of every transient's
  walkers), P2 (one half-step of all S ensembles) and P3 (the MAP seeding's
  whole Adam ascent), over the point of ``csrc/sc2_model.cuh`` that K1, K2
  and K7 share; ``csrc/adam.cuh`` the Adam step of P3 and K4p.
* ``csrc/stretch.cuh``: the half-step and run-form templates and the device
  code they share, ``csrc/planck.cuh`` the Planck band sum of K3, K4 and K4s;
  :mod:`.common` their Python side and the plain stretch move.

:mod:`.build` compiles the sources with nvcc at first use. Importing this
package needs neither nvcc nor a GPU. :func:`log_posterior` and
:func:`stretch_half_step` route a log-posterior to its ``kernel_module``
(a LogPosterior's is its model's, an SEDLogPosterior's K10's), as
:func:`stretch_run` does where the module has a run form
(:func:`runs_segments`), :func:`log_posterior_and_grad` to K7.
"""

from . import cs, epoch_bb, gradient, ladder, pop, quantile, sc, sc2, sc3, sc4, sed  # noqa: F401
from .common import (LAUNCHES, reset_launch_counts, log_posterior_plain,  # noqa: F401
                     stretch_half_step_plain)
from .gradient import hmc_transition, nuts_transition  # noqa: F401

__all__ = ["LAUNCHES", "reset_launch_counts", "module_for", "module_of", "log_posterior",
           "stretch_half_step", "runs_segments", "stretch_run", "log_posterior_and_grad",
           "nuts_transition", "hmc_transition"]


def module_for(model):
    """The kernel module whose fused log-posterior evaluates ``model``:
    :mod:`.sc2` for ShockCooling2, :mod:`.sc3` for ShockCooling3, :mod:`.sc`
    for ShockCooling, :mod:`.sc4` for ShockCooling4, :mod:`.cs` for
    CompanionShocking 1-3. Any other model raises NotImplementedError."""
    from ..models import (BaseCompanionShocking, ShockCooling, ShockCooling2, ShockCooling3,
                          ShockCooling4)
    for cls, mod in ((ShockCooling3, sc3), (ShockCooling2, sc2), (ShockCooling, sc),
                     (ShockCooling4, sc4), (BaseCompanionShocking, cs)):
        if isinstance(model, cls):
            return mod
    raise NotImplementedError(f"{type(model).__name__} has no fused CUDA log-posterior")


def module_of(lp):
    """The kernel module of a log-posterior, its ``kernel_module``:
    :func:`module_for` a LogPosterior's model, :mod:`.sed` (K10) for an
    SEDLogPosterior."""
    return lp.kernel_module


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The log-posterior (W,) float64 of LogPosterior or SEDLogPosterior
    ``lp`` at walker states ``q`` (W, ndim): the plain version for a CPU
    tensor, else the fused kernel of ``lp``'s model or K10 (see the modules'
    ``log_posterior``)."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    return module_of(lp).log_posterior(lp, q, param_offset, param_scale)


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One stretch-move half-step of LogPosterior or SEDLogPosterior ``lp``,
    in place: the plain version for a CPU tensor, else the half-step kernel
    of ``lp``'s model or K10's (arguments: :func:`.sc2.stretch_half_step`)."""
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior_plain(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    return module_of(lp).stretch_half_step(
        lp, x, logp, h, u_z, j, u_acc, a, param_offset, param_scale, chain_x, chain_logp,
        n_accept, check_partners)


def runs_segments(lp, half):
    """Whether a sampler segment of ``lp``'s ensemble at ``half`` walkers a
    half runs as one :func:`stretch_run`: where ``lp``'s module has a run
    form and picks it for that half (:func:`.sed.k10_form`; K10's, up to 64
    walkers). Otherwise the sampler launches :func:`stretch_half_step` twice
    a step; so too, on the CPU, for a model without kernels."""
    try:
        mod = module_of(lp)
    except NotImplementedError:
        return False
    return hasattr(mod, "stretch_run") and mod.k10_form(half) == "run"


def stretch_run(lp, x, logp, u_z, j, u_acc, a=2.0, param_offset=None, param_scale=None,
                chain_x=None, chain_logp=None, n_accept=None, thin_by=1, check_partners=True):
    """A segment of stretch-move proposals of ``lp``'s ensemble over stacked
    draws (n, 2, half), in place, where :func:`runs_segments`: the run form
    of ``lp``'s module, its plain version for a CPU tensor (arguments:
    :func:`.sed.stretch_run`)."""
    return module_of(lp).stretch_run(lp, x, logp, u_z, j, u_acc, a, param_offset, param_scale,
                                     chain_x, chain_logp, n_accept, thin_by, check_partners)


def log_posterior_and_grad(lp, p, white=None):
    """(value (W,), masked gradient (W, ndim)) float64 of LogPosterior ``lp``
    at the float64 rows ``p``, or in the whitened space of ``white`` (see
    :func:`.sc2.log_posterior_and_grad`): the plain version for a CPU tensor,
    else K7, which exists for ShockCooling2 only (any other model raises)."""
    if p.device.type != "cpu":
        gradient.check_model(lp)
    return sc2.log_posterior_and_grad(lp, p, white)
