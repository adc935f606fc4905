"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes wrappers
and their plain PyTorch versions.

* ``csrc/sc2_logpost.cu`` (:mod:`.sc2`): K1, the fused ShockCooling2
  log-posterior, and K2, the stretch-move half-step over it.
* ``csrc/sc3_logpost.cu`` (:mod:`.sc3`): K3, the quadrature band flux, and
  the fused ShockCooling3 log-posterior and half-step built on it.
* ``csrc/epoch_bb.cu`` (:mod:`.epoch_bb`): K4, the per-epoch blackbody
  log-posterior of the batched bolometric path and its gradient, the
  half-step over E epochs at once, and K4s, the posterior-summary rows.
* ``csrc/quantile.cu`` (:mod:`.quantile`): K5, exact percentiles of float32
  rows by counting bisection.
* ``csrc/ladder.cuh`` and ``csrc/ladder.cu`` (:mod:`.ladder`): K6, the
  tempered ladder: its half-step and initial state (templates instantiated
  for ShockCooling2 and ShockCooling3 in their sources), the replica
  exchange and the stepping-stone block terms.
* ``csrc/gradient.cuh`` (:mod:`.sc2` for K7, :mod:`.gradient` for K9 and
  K7h): the gradient path over ShockCooling2, templates instantiated in
  ``sc2_logpost.cu``: K7, the log-posterior and its gradient (one warp per
  walker), K9, the NUTS transition, and K7h, the HMC transition, both in
  the whitened space of the gradient samplers.
* ``csrc/companion.cu`` (:mod:`.cs`): K8, the SiFTO spline, and the fused
  log-posterior of CompanionShocking 1-3 with its half-step and its
  tempered-ladder instantiations.
* ``csrc/stretch.cuh``: the half-step template and the device code they
  share, ``csrc/planck.cuh`` the Planck band sum of K3, K4 and K4s;
  :mod:`.common` their Python side and the plain stretch move.

:mod:`.build` compiles the sources with nvcc at first use. Importing this
package needs neither nvcc nor a GPU. :func:`log_posterior` and
:func:`stretch_half_step` route a LogPosterior to its model's kernels,
:func:`log_posterior_and_grad` to K7.
"""

from . import cs, epoch_bb, gradient, ladder, quantile, sc2, sc3  # noqa: F401
from .common import (LAUNCHES, reset_launch_counts, log_posterior_plain,  # noqa: F401
                     stretch_half_step_plain)
from .gradient import hmc_transition, nuts_transition  # noqa: F401

__all__ = ["LAUNCHES", "reset_launch_counts", "module_for", "log_posterior",
           "stretch_half_step", "log_posterior_and_grad", "nuts_transition", "hmc_transition"]


def module_for(model):
    """The kernel module whose fused log-posterior evaluates ``model``:
    :mod:`.sc2` for ShockCooling2, :mod:`.sc3` for ShockCooling3, :mod:`.cs`
    for CompanionShocking 1-3. Any other model raises NotImplementedError."""
    from ..models import BaseCompanionShocking, ShockCooling2, ShockCooling3
    if isinstance(model, ShockCooling3):
        return sc3
    if isinstance(model, ShockCooling2):
        return sc2
    if isinstance(model, BaseCompanionShocking):
        return cs
    raise NotImplementedError(f"{type(model).__name__} has no fused CUDA log-posterior yet "
                              "(ROADMAP Queue 1 item 7)")


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The log-posterior (W,) float64 of LogPosterior ``lp`` at walker
    states ``q`` (W, ndim): the plain version for a CPU tensor, else the
    fused kernel of ``lp``'s model (see the modules' ``log_posterior``)."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    return module_for(lp.log_likelihood.model).log_posterior(lp, q, param_offset, param_scale)


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One stretch-move half-step of LogPosterior ``lp``, in place: the
    plain version for a CPU tensor, else the half-step kernel of ``lp``'s
    model (arguments: :func:`.sc2.stretch_half_step`)."""
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior_plain(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    return module_for(lp.log_likelihood.model).stretch_half_step(
        lp, x, logp, h, u_z, j, u_acc, a, param_offset, param_scale, chain_x, chain_logp,
        n_accept, check_partners)


def log_posterior_and_grad(lp, p, white=None):
    """(value (W,), masked gradient (W, ndim)) float64 of LogPosterior ``lp``
    at the float64 rows ``p``, or in the whitened space of ``white`` (see
    :func:`.sc2.log_posterior_and_grad`): the plain version for a CPU tensor,
    else K7, which exists for ShockCooling2 only (any other model raises)."""
    if p.device.type != "cpu":
        gradient.check_model(lp)
    return sc2.log_posterior_and_grad(lp, p, white)
