"""Wrappers of the quadrature kernels (``csrc/sc3_logpost.cu``): K3 and the
fused ShockCooling3 log-posterior and half-step built on it.

* :func:`bandflux` (K3): the band-averaged blackbody L_nu per point, the
  CUDA route of
  :func:`~lightcurve_fitting_tpu_torch.models.blackbody.bandflux_pointwise`,
  whose plain version is ``bandflux_pointwise_plain`` beside it: a thread
  per (walker, point) (``bandflux_kernel``) or, where those are too few to
  fill the card, a warp per (walker, point) (``bandflux_warp_kernel``), by
  :func:`k3_form`; the two give the same bits. :func:`bandflux_launch` runs
  either form.
* :func:`log_posterior` (``logpost_warp_kernel`` over ``SC3WarpModel``, a warp
  per walker as the half-step, whose stored values it repeats bit for bit):
  the SC3 log-posterior of a batch of walker states; plain version
  ``LogPosterior.forward_plain``.
* :func:`stretch_half_step` (``stretch_half_step_kernel`` over
  ``SC3WarpModel``, one warp per walker, its lanes over the points in the
  order of :func:`point_order`): one stretch-move half-step, in place; plain
  version
  :func:`~lightcurve_fitting_tpu_torch.kernels.common.stretch_half_step_plain`.

The log-posterior wrappers run their plain version for a CPU tensor; for a
CUDA tensor every wrapper launches its kernel or raises: there is no
fallback. Each launch adds one to ``LAUNCHES[name]``, and nothing else does.
"""

import ctypes

import numpy as np
import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, check, check_buffers, cuda_args, affine_key,
                     fill_priors_and_affine, half_step_checks, half_step_args,
                     log_posterior_plain, stretch_half_step_plain)

__all__ = ["bandflux", "bandflux_launch", "k3_form", "log_posterior", "stretch_half_step",
           "point_order"]

#: K3 runs a thread per (walker, point) from this many pairs an SM, a warp
#: per pair below (k3_form)
K3_THREAD_PAIRS_PER_SM = 176


class _SC3Params(ctypes.Structure):
    """ctypes mirror of ``struct SC3Params`` (csrc/sc3_logpost.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "y", "inv_dy", "dy", "sigma_units", "nodes", "weights", "k_ext",
                  "band_ids", "n_native", "point_order")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_bands", "n_nodes", "ndim", "use_sigma", "has_affine")]
                + [(n, ctypes.c_double) for n in
                   ("t_ref", "inv_yscale", "log_norm_const", "ll_offset", "kappa", "A",
                    "a_model", "alpha", "eps1", "eps2", "L0_42", "T0", "tph_to_tcol", "k_B",
                    "c1", "c2", "c3_42", "c4_30", "ext_coef")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")])


class _BandfluxParams(ctypes.Structure):
    """ctypes mirror of ``struct BandfluxParams`` (csrc/sc3_logpost.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("nodes", "weights", "k_ext", "band_ids", "T", "R", "ebv", "out")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_walkers", "n_points", "n_nodes", "ebv_stride_w", "ebv_stride_n",
                    "has_cutoff")]
                + [(n, ctypes.c_double) for n in ("cutoff", "c1", "c2", "ext_coef")])


_BUFFERS = ("t_centered", "y", "inv_dy", "dy", "sigma_units", "nodes", "weights", "k_ext",
            "band_ids", "n_native")


def _compute_f64(dtype):
    return int(dtype == torch.float64)


# ------------------------------------------------------------------------ K3

def k3_form(pairs, n_sm):
    """K3's form for ``pairs`` (walker, point) pairs on a card of ``n_sm``
    SMs: ``"warp"`` (a warp per pair, the lanes forming its terms) where a
    thread per pair would leave most of the card's schedulers idle, each
    thread walking its K terms alone; ``"thread"`` (a thread per pair)
    where the pairs fill the card. Both give the same bits."""
    return "thread" if pairs >= K3_THREAD_PAIRS_PER_SM * n_sm else "warp"


def bandflux(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0,
             band_ids=None):
    """K3 on CUDA tensors: ``bandflux_pointwise_plain``'s result, from the
    hand-written kernel in the form :func:`k3_form` picks. Same arguments:
    tables (N, K) per point, or (B, K) per band with ``band_ids`` (N,); T, R
    (..., N); ebv broadcastable to (..., N), read in place (stride 0 where
    broadcast). The sum runs in the compute dtype of the device; the result
    has T's dtype."""
    return bandflux_launch(None, nodes_emit, weights, T, R, cutoff_freq, k_ext, ebv, band_ids)


def bandflux_launch(form, nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0,
                    band_ids=None):
    """:func:`bandflux` in ``form``, ``"thread"`` or ``"warp"`` (None: the
    form :func:`k3_form` picks)."""
    from ..core import config
    from ..core.constants import c1, c2
    from ..ops.extinction import EXT_COEF
    if form not in (None, "thread", "warp"):
        raise ValueError(f"K3's form is 'thread' or 'warp', not {form!r}")
    dev = T.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA (or its plain version on the CPU), not {dev}")
    if R.shape != T.shape or T.ndim < 1:
        raise ValueError(f"T and R must have one shape (..., N): {tuple(T.shape)}, "
                         f"{tuple(R.shape)}")
    N = T.shape[-1]
    W = T.numel() // N if N else 0
    cdt = config.get_compute_dtype(dev) or T.dtype
    if cdt not in FLOATS:
        raise TypeError(f"K3 computes in float32 or float64, not {cdt}")
    tables = [nodes_emit, weights] + ([] if k_ext is None else [k_ext])
    B, K = nodes_emit.shape if nodes_emit.ndim == 2 else (-1, -1)
    for name, t in zip(("nodes_emit", "weights", "k_ext"), tables):
        if t.device != dev or t.shape != (B, K) or not t.is_floating_point():
            raise ValueError(f"{name} must be a (B, K) float tensor on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if band_ids is None:
        if B != N:
            raise ValueError(f"per-point tables need N = {N} rows, got {B}")
    else:
        check(band_ids, "band_ids", (N,), (torch.int64,), dev)
        if bool(((band_ids < 0) | (band_ids >= B)).any()):   # the kernel indexes unchecked
            raise ValueError(f"band_ids must lie in [0, {B})")
    tables = [t.to(cdt).contiguous() for t in tables]
    Tc = T.to(cdt).reshape(W, N).contiguous()
    Rc = R.to(cdt).reshape(W, N).contiguous()
    P = _BandfluxParams()
    P.nodes, P.weights = tables[0].data_ptr(), tables[1].data_ptr()
    P.k_ext = None if k_ext is None else tables[2].data_ptr()
    P.band_ids = None if band_ids is None else band_ids.data_ptr()
    P.T, P.R = Tc.data_ptr(), Rc.data_ptr()
    if k_ext is not None:
        e = torch.as_tensor(ebv, dtype=torch.float64, device=dev) if not torch.is_tensor(ebv) \
            else ebv
        if e.device != dev:
            raise ValueError(f"ebv is on {e.device}, expected {dev}")
        e = torch.broadcast_to(e.to(cdt), T.shape).reshape(W, N)
        P.ebv, P.ebv_stride_w, P.ebv_stride_n = e.data_ptr(), e.stride(0), e.stride(1)
    out = torch.empty((W, N), dtype=cdt, device=dev)
    P.out = out.data_ptr()
    P.n_walkers, P.n_points, P.n_nodes = W, N, K
    P.has_cutoff = int(np.isfinite(cutoff_freq))
    P.cutoff = float(cutoff_freq) if P.has_cutoff else 0.0
    P.c1, P.c2, P.ext_coef = c1, c2, EXT_COEF
    if form is None:
        from .gradient import sm_count
        form = k3_form(W * N, sm_count(dev))
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    rc = lib.bandflux_launch(ctypes.addressof(P), device_index, _compute_f64(cdt),
                             int(form == "warp"), stream)
    if rc != 0:
        raise RuntimeError(f"K3's {form} form launch failed: cudaError {rc}")
    LAUNCHES["bandflux"] += 1
    return out.reshape(T.shape).to(T.dtype)


# ------------------------------------------------------------ log-posterior

def point_order(ll):
    """The order in which the half-step's warp takes the points of
    LogLikelihood ``ll``: by descending native node count of their bands,
    ties in time order (a stable sort), so that the 32 points a warp works
    on at once have near-equal quadrature lengths. (N,) int64 on ll's
    device."""
    return torch.argsort(ll.n_native[ll.band_ids], descending=True, stable=True)


def _kernel_params(lp, ndim, offset, scale):
    """The parameter block for LogPosterior ``lp``, cached on it and keyed
    by the buffers' addresses (a module moved between devices gets a new
    block)."""
    from ..core.constants import c1, c2, c3_42, c4_30, k_B
    from ..ops.extinction import EXT_COEF
    ll = lp.log_likelihood
    key = (ndim, affine_key(offset, scale),
           tuple(getattr(ll, name).data_ptr() for name in _BUFFERS))
    cache = lp.__dict__.setdefault("_kernel_params_cache", {})
    if key in cache:
        return cache[key]
    if ndim != len(lp.priors) or ndim != 7 + int(ll.use_sigma) or ndim > MAX_DIM:
        raise ValueError(f"the SC3 kernels take ndim = 7 (+1 with use_sigma) matching the "
                         f"priors; got ndim={ndim} for {len(lp.priors)} priors")
    P = _SC3Params()
    for name in _BUFFERS:
        setattr(P, name, getattr(ll, name).data_ptr())
    P._point_order = point_order(ll)     # kept alive with the block: the kernels read it by address
    P.point_order = P._point_order.data_ptr()
    P.n_points = ll.band_ids.shape[0]
    P.n_bands, P.n_nodes = ll.nodes.shape
    P.ndim, P.use_sigma = ndim, int(ll.use_sigma)
    P.t_ref, P.inv_yscale = ll.t_ref, ll.inv_yscale
    P.log_norm_const, P.ll_offset = ll.log_norm_const, ll.offset
    consts = ll.model.kernel_constants()
    P.kappa, P.A, P.a_model, P.alpha = consts["kappa"], consts["A"], consts["a"], consts["alpha"]
    P.eps1, P.eps2, P.L0_42 = consts["eps1"], consts["eps2"], consts["L0_42"]
    P.T0, P.tph_to_tcol = consts["T0"], consts["tph_to_tcol"]
    P.k_B, P.c1, P.c2, P.c3_42, P.c4_30, P.ext_coef = k_B, c1, c2, c3_42, c4_30, EXT_COEF
    fill_priors_and_affine(P, lp.priors, key[1])
    cache[key] = P
    return P


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The SC3 log-posterior (W,) float64 of LogPosterior ``lp`` at each
    walker state ``q`` (W, ndim) float32/float64, affine-mapped to absolute
    float64 parameters ``offset + scale * q`` when ``param_offset``/
    ``param_scale`` are given."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    if q.device.type != "cuda":
        raise ValueError(f"the SC3 log-posterior kernel runs on CUDA (or its plain version "
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
    rc = lib.sc3_logpost_launch(ctypes.addressof(P), dev,
                                _compute_f64(lp.log_likelihood.compute_dtype),
                                q.data_ptr(), int(q.dtype == torch.float64), W,
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"logpost_warp_kernel (SC3) launch failed: cudaError {rc}")
    LAUNCHES["sc3_logpost"] += 1
    return out


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One stretch-move half-step of the SC3 LogPosterior ``lp`` on half
    ``h`` of the ensemble, in place: the arguments and contract of
    :func:`~lightcurve_fitting_tpu_torch.kernels.sc2.stretch_half_step`."""
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    if x.device.type != "cuda":
        raise ValueError(f"the SC3 half-step kernel runs on CUDA (or its plain version on "
                         f"the CPU), not {x.device}")
    _, ndim = half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                               check_partners)
    check_buffers(lp.log_likelihood, _BUFFERS, x.device)
    from .build import library
    lib = library()
    P = _kernel_params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(x.device)
    rc = lib.sc3_half_step_launch(
        ctypes.addressof(P), device_index, _compute_f64(lp.log_likelihood.compute_dtype),
        *half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept), stream)
    if rc != 0:
        raise RuntimeError(f"stretch_half_step_kernel (SC3) launch failed: cudaError {rc}")
    LAUNCHES["sc3_half_step"] += 1
