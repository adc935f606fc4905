"""Wrappers of the fused ShockCooling4 kernels (``csrc/sc_logpost.cu``,
MSW23 over the band table: the smaller of the band fluxes at (T, R) and at
(0.74 T, 0.74^-2 R) a point), through :mod:`.sc`'s helpers.

* :func:`log_posterior`: the log-posterior of a batch of walker states, in
  the form :func:`logpost_form` picks (``logpost_warp_kernel`` over
  ``SC4WarpModel<C, N>``, a warp per walker, or ``logpost_latency_kernel``,
  a block per walker; the same bits, those the half-steps store), counted
  under ``sc4_logpost`` and under ``sc4_logpost_warp`` or
  ``sc4_logpost_latency``.
* :func:`stretch_half_step`: one Goodman-Weare half-step of the ensemble,
  in place, in the form :func:`sc_half_form` picks
  (``stretch_half_step_kernel`` over ``SC4WarpModel``, a warp per walker,
  or its latency form ``stretch_half_step_latency_kernel``, a block per
  walker; the same bits), counted under ``sc4_half_step`` and under
  ``sc4_half_step_warp`` or ``sc4_half_step_latency``.
* K6a and K6b over ``SC4WarpModel`` are launched by :mod:`.ladder`, which
  counts them under ``LADDER_COUNTS``'s names; K6a in the form
  :func:`tempered_form` picks (the warp form or the latency form, the same
  bits), counted once more under ``sc4_tempered_half_step_warp`` or
  ``sc4_tempered_half_step_latency``; K6b in the form
  :func:`ladder_init_form` picks (a warp or a block per state, the same
  bits), counted once more under ``sc4_ladder_init_warp`` or
  ``sc4_ladder_init_latency``.

For a tensor on the CPU each wrapper runs its plain version; for a CUDA
tensor it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``, and nothing else does.
"""

from . import sc
from .sc import _BUFFERS, half_step_launch, kernel_params, logpost_launch  # noqa: F401

__all__ = ["log_posterior", "stretch_half_step", "sc_half_form", "tempered_form", "logpost_form",
           "ladder_init_form", "LADDER_COUNTS"]

#: the LAUNCHES names under which :mod:`.ladder` counts K6a and K6b over
#: this module's policy
LADDER_COUNTS = {"tempered_half_step": "sc4_tempered_half_step",
                 "ladder_init": "sc4_ladder_init"}


def _kernel_params(lp, ndim, offset, scale):
    return kernel_params("sc4", lp, ndim, offset, scale)


def sc_half_form(half, n_points, n_sm):
    """The ShockCooling4 half-step's form (:func:`.sc.sc_half_form` at its
    own crossover)."""
    return sc.sc_half_form(half, n_points, n_sm, "sc4")


def tempered_form(n_walkers, n_points, n_sm):
    """K6a's form over ShockCooling4 (:func:`.sc.tempered_form` at its own
    crossover)."""
    return sc.tempered_form(n_walkers, n_points, n_sm, "sc4")


def logpost_form(n_walkers, n_points, n_sm):
    """The batch log-posterior's form over ShockCooling4
    (:func:`.sc.logpost_form` at its own crossover)."""
    return sc.logpost_form(n_walkers, n_points, n_sm, "sc4")


def ladder_init_form(n_states, n_points, n_sm):
    """K6b's form over ShockCooling4 (:func:`.sc.ladder_init_form`)."""
    return sc.ladder_init_form(n_states, n_points, n_sm, "sc4")


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The ShockCooling4 log-posterior (W,) float64 of LogPosterior ``lp`` at
    the walker states ``q`` (W, ndim) (see :func:`.sc.logpost_launch`)."""
    return logpost_launch("sc4", lp, q, param_offset, param_scale)


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One ShockCooling4 stretch-move half-step, in place (see
    :func:`.sc.half_step_launch`)."""
    return half_step_launch("sc4", lp, x, logp, h, u_z, j, u_acc, a, param_offset, param_scale,
                            chain_x, chain_logp, n_accept, check_partners)
