"""Wrappers of the companion-shocking kernels (``csrc/companion.cu``): K8 and
the fused CompanionShocking 1-3 log-posterior and half-step.

* :func:`sifto` (K8, ``sifto_kernel``): the stretched SiFTO term (W, N) of
  every point for every walker, the CUDA route of
  :func:`~lightcurve_fitting_tpu_torch.models.companion_shocking.sifto_points`,
  whose plain version is ``sifto_points_plain`` beside it; a warp a
  walker, its lanes over the points, the knots and cubics staged in shared
  memory once a block where the elements an SM pay for it, else read
  where they lie (:func:`k8_form`; the two forms give the same bits).
  :func:`sifto_launch` runs either form; a launch counts under
  ``LAUNCHES["sifto_staged"]`` or ``LAUNCHES["sifto_direct"]``, the form
  that ran.
* :func:`log_posterior` (``logpost_warp_kernel`` over ``CSWarpModel``, a
  warp per walker): the CS log-posterior of a batch of walker states; plain
  version ``LogPosterior.forward_plain``.
* :func:`stretch_half_step` (``stretch_half_step_kernel`` over
  ``CSWarpModel``, a warp per walker): one stretch-move half-step, in place;
  plain version
  :func:`~lightcurve_fitting_tpu_torch.kernels.common.stretch_half_step_plain`.

The tempered ladder's kernels over CS (``cs_tempered_half_step``, K6a, and
``cs_ladder_init``, K6b, a warp per walker over ``CSWarpModel``) are reached
through :mod:`.ladder`. The log-posterior
wrappers run their plain version for a CPU tensor; for a CUDA tensor every
wrapper launches its kernel or raises: there is no fallback. Each launch adds
one to ``LAUNCHES[name]``, and nothing else does.
"""

import ctypes

import numpy as np
import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, check, check_buffers, cuda_args, affine_key,
                     fill_priors_and_affine, half_step_checks, half_step_args,
                     log_posterior_plain, stretch_half_step_plain)

__all__ = ["sifto", "sifto_launch", "k8_form", "log_posterior", "stretch_half_step"]

#: model parameters (before the intrinsic scatter) of each variant
_N_MODEL_PARAMS = {1: 8, 2: 7, 3: 7}
#: K8 stages the SiFTO table once a block from this many (walker, point)
#: elements an SM, and reads it where it lies below (k8_form). On the H100
#: at 108 points the direct form took 0.0026-0.0037 ms through 2048
#: walkers against the staged form's 0.0045-0.0054, the two 0.0061 and
#: 0.0060 at 4096, the staged form 0.0074 against 0.0105 at 8192
#: (tools/time_port_kernels.py K8_W*_dev; PERF.md): the switch at ~4034
K8_STAGED_ELEMENTS_PER_SM = 3300


class _CSParams(ctypes.Structure):
    """ctypes mirror of ``struct CSParams`` (csrc/companion.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "y", "inv_dy", "dy", "sigma_units", "s_a", "s_b", "coef",
                  "sifto_rows", "sifto_knots", "sifto_band", "is_U", "is_i", "is_r")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_coef", "n_bands", "n_knots", "ndim", "use_sigma",
                    "has_affine", "variant")]
                + [(n, ctypes.c_double) for n in
                   ("t_ref", "inv_yscale", "log_norm_const", "ll_offset", "kappa", "kappa_m35")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")])


class _SiftoParams(ctypes.Structure):
    """ctypes mirror of ``struct SiftoParams`` (csrc/companion.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "t_peak", "stretch", "dtU", "dti", "rows", "knots", "band",
                  "is_U", "is_i", "out")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_walkers", "n_points", "n_bands", "n_knots")]
                + [("t_ref", ctypes.c_double)])


_BUFFERS = ("t_centered", "y", "inv_dy", "dy", "sigma_units", "bb_s_a", "bb_s_b", "bb_coeffs",
            "sifto_rows", "sifto_knots", "sifto_band", "is_U", "is_i", "is_r")


def _compute_f64(dtype):
    return int(dtype == torch.float64)


def _check_rows(rows, knots, band):
    """(B, 4, S-1) rows, (S,) knots, band indices in [0, B); returns (B, S)."""
    B, S = rows.shape[0], knots.shape[0]
    if rows.ndim != 3 or tuple(rows.shape[1:]) != (4, S - 1) or S < 2:
        raise ValueError(f"SiFTO rows must be (B, 4, S-1) over S >= 2 knots, got "
                         f"{tuple(rows.shape)} for {S} knots")
    if bool(((band < 0) | (band >= B)).any()):   # the kernels index unchecked
        raise ValueError(f"SiFTO band indices must lie in [0, {B})")
    return B, S


# ------------------------------------------------------------------------ K8

def k8_form(elements, n_sm):
    """K8's form for ``elements`` (walker, point) pairs on a card of ``n_sm``
    SMs: ``"staged"`` (the rows and knots copied into shared memory once a
    block, in a grid of the blocks resident at once) where the elements an
    SM pay for the copy, ``"direct"`` (read where they lie, through the
    read-only path) below. Both give the same bits."""
    return "staged" if elements >= K8_STAGED_ELEMENTS_PER_SM * n_sm else "direct"


def sifto(t, quad, t_peak, stretch, dtU=None, dti=None):
    """K8 on CUDA tensors: ``sifto_points_plain``'s result from the
    hand-written ``sifto_kernel`` in the form :func:`k8_form` picks. ``t``
    (N,) float64 absolute times; ``quad`` the model's per-point dict with
    ``sifto_rows`` (B, 4, S-1), ``sifto_band`` (N,), ``sifto_knots`` (S,),
    ``is_U`` and ``is_i``; parameters 0-d or (W, 1) columns (float64).
    Returns (N,) for 0-d parameters, else (W, N), in the compute dtype of
    the device."""
    return sifto_launch(None, t, quad, t_peak, stretch, dtU, dti)


def sifto_launch(form, t, quad, t_peak, stretch, dtU=None, dti=None):
    """:func:`sifto` in ``form``, ``"staged"`` or ``"direct"`` (None: the
    form :func:`k8_form` picks)."""
    from ..core import config
    from ..ops.mathx import epoch_reference
    if form not in (None, "staged", "direct"):
        raise ValueError(f"K8's form is 'staged' or 'direct', not {form!r}")
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"K8 runs on CUDA (or its plain version on the CPU), not {dev}")
    N = t.shape[-1]
    if t.ndim != 1:
        raise ValueError(f"t must be (N,), got shape {tuple(t.shape)}")
    cdt = config.get_compute_dtype(dev)
    t64 = t.to(torch.float64)
    if cdt is None:                                  # float64, uncentred, as hot_phase
        cdt, t_ref = torch.float64, 0.0
    else:
        t_ref = float(epoch_reference(t64))
    tc = (t64 - t_ref).to(cdt).contiguous()
    cols = [None if x is None else torch.as_tensor(x, dtype=torch.float64, device=dev)
            for x in (t_peak, stretch, dtU, dti)]
    given = [c for c in cols if c is not None]
    W = max(c.numel() for c in given)
    if any(c.numel() not in (1, W) for c in given):
        raise ValueError("the parameters must be 0-d or (W, 1) columns of one W")
    flat = [None if c is None else c.reshape(-1).expand(W).contiguous() for c in cols]
    rows = quad["sifto_rows"].to(device=dev, dtype=cdt).contiguous()
    knots = quad["sifto_knots"].to(device=dev, dtype=cdt).contiguous()
    band = quad["sifto_band"]
    check(band, "sifto_band", (N,), (torch.int64,), dev)
    for name in ("is_U", "is_i"):
        check(quad[name], name, (N,), (torch.bool,), dev)
    B, S = _check_rows(rows, knots, band)
    out = torch.empty((W, N), dtype=cdt, device=dev)
    P = _SiftoParams()
    P.t_centered = tc.data_ptr()
    P.t_peak, P.stretch = flat[0].data_ptr(), flat[1].data_ptr()
    P.dtU = None if flat[2] is None else flat[2].data_ptr()
    P.dti = None if flat[3] is None else flat[3].data_ptr()
    P.rows, P.knots, P.band = rows.data_ptr(), knots.data_ptr(), band.data_ptr()
    P.is_U, P.is_i, P.out = quad["is_U"].data_ptr(), quad["is_i"].data_ptr(), out.data_ptr()
    P.n_walkers, P.n_points, P.n_bands, P.n_knots = W, N, B, S
    P.t_ref = t_ref
    if form is None:
        from .gradient import sm_count
        form = k8_form(W * N, sm_count(dev))
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    staged = ctypes.c_int(int(form == "staged"))
    rc = lib.sifto_launch(ctypes.addressof(P), device_index, _compute_f64(cdt),
                          ctypes.byref(staged), stream)
    if rc != 0:
        raise RuntimeError(f"sifto_kernel ({form}) launch failed: cudaError {rc}")
    LAUNCHES["sifto_staged" if staged.value else "sifto_direct"] += 1
    vector = any(c.ndim > 0 for c in given)
    return out if vector else out[0]


# ------------------------------------------------------------ log-posterior

def _kernel_params(lp, ndim, offset, scale):
    """The parameter block for LogPosterior ``lp``, cached on it and keyed
    by the buffers' addresses (a module moved between devices gets a new
    block)."""
    ll = lp.log_likelihood
    key = (ndim, affine_key(offset, scale),
           tuple(getattr(ll, name).data_ptr() for name in _BUFFERS))
    cache = lp.__dict__.setdefault("_kernel_params_cache", {})
    if key in cache:
        return cache[key]
    consts = ll.model.kernel_constants()
    n_model = _N_MODEL_PARAMS[consts["variant"]]
    if ndim != len(lp.priors) or ndim != n_model + int(ll.use_sigma) or ndim > MAX_DIM:
        raise ValueError(f"the CS{consts['variant']} kernels take ndim = {n_model} (+1 with "
                         f"use_sigma) matching the priors; got ndim={ndim} for "
                         f"{len(lp.priors)} priors")
    B, S = _check_rows(ll.sifto_rows, ll.sifto_knots, ll.sifto_band)
    P = _CSParams()
    for name in ("t_centered", "y", "inv_dy", "dy", "sigma_units", "sifto_rows", "sifto_knots",
                 "sifto_band", "is_U", "is_i", "is_r"):
        setattr(P, name, getattr(ll, name).data_ptr())
    P.s_a, P.s_b, P.coef = ll.bb_s_a.data_ptr(), ll.bb_s_b.data_ptr(), ll.bb_coeffs.data_ptr()
    P.n_points, P.n_coef = ll.bb_coeffs.shape
    P.n_bands, P.n_knots = B, S
    P.ndim, P.use_sigma, P.variant = ndim, int(ll.use_sigma), consts["variant"]
    P.t_ref, P.inv_yscale = ll.t_ref, ll.inv_yscale
    P.log_norm_const, P.ll_offset = ll.log_norm_const, ll.offset
    P.kappa = consts["kappa"]
    with np.errstate(divide="ignore"):
        P.kappa_m35 = float(np.float64(consts["kappa"]) ** -35.0)
    fill_priors_and_affine(P, lp.priors, key[1])
    cache[key] = P
    return P


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The CS log-posterior (W,) float64 of LogPosterior ``lp`` at each walker
    state ``q`` (W, ndim) float32/float64, affine-mapped to absolute float64
    parameters ``offset + scale * q`` when ``param_offset``/``param_scale``
    are given."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    if q.device.type != "cuda":
        raise ValueError(f"the CS log-posterior kernel runs on CUDA (or its plain version "
                         f"on the CPU), not {q.device}")
    if q.ndim != 2:
        raise ValueError(f"q must be (W, ndim), got shape {tuple(q.shape)}")
    W, ndim = q.shape
    check(q, "q", (W, ndim), FLOATS, q.device)
    check_buffers(lp.log_likelihood, _BUFFERS, q.device)
    from .build import library
    lib = library()
    P = _kernel_params(lp, ndim, param_offset, param_scale)
    out = torch.empty(W, dtype=torch.float64, device=q.device)
    dev, stream = cuda_args(q.device)
    rc = lib.cs_logpost_launch(ctypes.addressof(P), dev,
                               _compute_f64(lp.log_likelihood.compute_dtype), q.data_ptr(),
                               int(q.dtype == torch.float64), W, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"logpost_warp_kernel (CS) launch failed: cudaError {rc}")
    LAUNCHES["cs_logpost"] += 1
    return out


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One stretch-move half-step of the CS LogPosterior ``lp`` on half ``h``
    of the ensemble, in place: the arguments and contract of
    :func:`~lightcurve_fitting_tpu_torch.kernels.sc2.stretch_half_step`."""
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    if x.device.type != "cuda":
        raise ValueError(f"the CS half-step kernel runs on CUDA (or its plain version on "
                         f"the CPU), not {x.device}")
    _, ndim = half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                               check_partners)
    check_buffers(lp.log_likelihood, _BUFFERS, x.device)
    from .build import library
    lib = library()
    P = _kernel_params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(x.device)
    rc = lib.cs_half_step_launch(
        ctypes.addressof(P), device_index, _compute_f64(lp.log_likelihood.compute_dtype),
        *half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept), stream)
    if rc != 0:
        raise RuntimeError(f"stretch_half_step_kernel (CS) launch failed: cudaError {rc}")
    LAUNCHES["cs_half_step"] += 1
