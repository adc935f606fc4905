"""Wrappers of the fused ShockCooling2 kernels, K1, K2 and K7, with their
plain PyTorch versions beside them.

* :func:`log_posterior` (K1, ``logpost_warp_kernel`` over ``SC2WarpModel``,
  a warp per walker as the half-step, whose stored values it repeats bit
  for bit): the log-posterior of a batch of walker states.
* :func:`stretch_half_step` (K2, ``stretch_half_step_kernel`` over
  ``SC2WarpModel``, a warp per walker): one Goodman-Weare half-step of the
  ensemble, in place; the proposal's log-posterior sums the points as K7's
  value does.
* :func:`log_posterior_and_grad` (K7, ``logpost_grad_kernel`` and
  ``logpost_grad_block_kernel`` of ``csrc/gradient.cuh`` over
  ``SC2Model``): the log-posterior and its gradient, in the model's
  parameters or in the whitened space of the gradient samplers; a warp per
  walker where the walkers fill the card, a block per walker at small widths
  (:func:`~.gradient.k7_form`), the same bits in both forms.

For a tensor on the CPU each wrapper runs its plain version
(:func:`log_posterior_plain`, :func:`stretch_half_step_plain`). For a CUDA
tensor it launches the kernel or raises: there is no fallback. Each launch
adds one to ``LAUNCHES[name]``, and nothing else does.
"""

import ctypes

import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, check, check_buffers, cuda_args, affine_key,
                     fill_priors_and_affine, half_step_checks, half_step_args,
                     log_posterior_plain, propose_stretch, half_update,
                     stretch_half_step_plain, reset_launch_counts)

__all__ = ["LAUNCHES", "reset_launch_counts", "log_posterior", "log_posterior_plain",
           "stretch_half_step", "stretch_half_step_plain", "propose_stretch", "half_update",
           "log_posterior_and_grad", "log_posterior_and_grad_plain", "logpost_grad_launch"]


class _SC2Params(ctypes.Structure):
    """ctypes mirror of ``struct SC2Params`` (csrc/sc2_logpost.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "y", "inv_dy", "dy", "sigma_units", "s_a", "s_b", "coef")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_coef", "ndim", "use_sigma", "has_affine")]
                + [(n, ctypes.c_double) for n in
                   ("t_ref", "inv_yscale", "log_norm_const", "ll_offset", "eps_T", "eps_L",
                    "a_model", "alpha", "c3_42")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")])


_BUFFERS = ("t_centered", "y", "inv_dy", "dy", "sigma_units", "bb_s_a", "bb_s_b", "bb_coeffs")


def _kernel_params(lp, ndim, offset, scale):
    """The kernel's parameter block for LogPosterior ``lp``, cached on it and
    keyed by the buffers' addresses (a module moved between devices gets a
    new block)."""
    from ..core.constants import c3_42
    ll = lp.log_likelihood
    key = (ndim, affine_key(offset, scale),
           tuple(getattr(ll, name).data_ptr() for name in _BUFFERS))
    cache = lp.__dict__.setdefault("_kernel_params_cache", {})
    if key in cache:
        return cache[key]
    if ndim != len(lp.priors) or ndim != 4 + int(ll.use_sigma) or ndim > MAX_DIM:
        raise ValueError(f"the SC2 kernels take ndim = 4 (+1 with use_sigma) matching the "
                         f"priors; got ndim={ndim} for {len(lp.priors)} priors")
    consts = ll.model.kernel_constants()
    P = _SC2Params()
    for name in ("t_centered", "y", "inv_dy", "dy", "sigma_units"):
        setattr(P, name, getattr(ll, name).data_ptr())
    P.s_a, P.s_b, P.coef = ll.bb_s_a.data_ptr(), ll.bb_s_b.data_ptr(), ll.bb_coeffs.data_ptr()
    P.n_points, P.n_coef = ll.bb_coeffs.shape
    P.ndim, P.use_sigma = ndim, int(ll.use_sigma)
    P.t_ref, P.inv_yscale = ll.t_ref, ll.inv_yscale
    P.log_norm_const, P.ll_offset = ll.log_norm_const, ll.offset
    P.eps_T, P.eps_L = consts["eps_T"], consts["eps_L"]
    P.a_model, P.alpha, P.c3_42 = consts["a"], consts["alpha"], c3_42
    fill_priors_and_affine(P, lp.priors, key[1])
    cache[key] = P
    return P


# ------------------------------------------------------------------------ K1

def log_posterior(lp, q, param_offset=None, param_scale=None):
    """K1: the log-posterior (W,) float64 of LogPosterior ``lp`` at each walker
    state ``q`` (W, ndim) float32/float64, affine-mapped to absolute float64
    parameters ``offset + scale * q`` when ``param_offset``/``param_scale``
    are given."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (or its plain version on the CPU), not {q.device}")
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
    rc = lib.sc2_logpost_launch(ctypes.addressof(P), dev,
                                int(lp.log_likelihood.compute_dtype == torch.float64),
                                q.data_ptr(), int(q.dtype == torch.float64), W,
                                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"logpost_warp_kernel (SC2) launch failed: cudaError {rc}")
    LAUNCHES["sc2_logpost"] += 1
    return out


# ------------------------------------------------------------------------ K2

def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """K2: one stretch-move half-step of LogPosterior ``lp`` on half ``h`` of
    the ensemble, in place.

    x (2, half, ndim) float32/float64 walker state (affine-rescaled when
    ``param_offset``/``param_scale`` are given); logp (2, half) float64;
    u_z, u_acc (half,) uniform draws in x's dtype; j (half,) int64 partner
    indices into the other half; n_accept (2, half) int32, incremented;
    chain_x (2, half, ndim) and chain_logp (2, half), float32 or float64,
    receive the new half when given (both or neither).

    ``check_partners`` verifies 0 <= j < half before the launch (the kernel
    reads ``x[1-h, j]`` unchecked); it synchronizes with the device, so the
    sampler, whose partners come from ``randint(0, half)``, turns it off.
    """
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA (or its plain version on the CPU), not {x.device}")
    _, ndim = half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                               check_partners)
    check_buffers(lp.log_likelihood, _BUFFERS, x.device)
    from .build import library
    lib = library()
    P = _kernel_params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(x.device)
    rc = lib.stretch_half_step_launch(
        ctypes.addressof(P), device_index, int(lp.log_likelihood.compute_dtype == torch.float64),
        *half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept), stream)
    if rc != 0:
        raise RuntimeError(f"stretch_half_step_kernel launch failed: cudaError {rc}")
    LAUNCHES["stretch_half_step"] += 1


# ------------------------------------------------------------------------ K7

def log_posterior_and_grad_plain(lp, p):
    """Plain K7: the log-posterior (W,) float64 of LogPosterior ``lp`` at
    absolute float64 parameters ``p`` (W, ndim) and its gradient (W, ndim),
    by autograd through :meth:`LogPosterior.forward_plain`, masked as the JAX
    callers mask ``jax.grad`` (non-finite components 0; all 0 where the
    value is -inf)."""
    from ..parallel.hmc import _autograd_value_and_grad
    return _autograd_value_and_grad(lp.forward_plain, p.to(torch.float64))


def log_posterior_and_grad(lp, p, white=None):
    """K7: (value (W,), gradient (W, ndim)) float64 of LogPosterior ``lp`` at
    the float64 rows ``p`` (W, ndim): the model's absolute parameters, or,
    with ``white`` (a :class:`~..parallel.hmc.WhitenedLogPosterior` over
    ``lp``), its whitened space. The gradient is masked as the JAX callers
    mask it; in the whitened space the mask applies after the chain rule
    (a NaN model derivative zeroes the whitened components it reaches). The
    value has K1's bits (the same points, order and roundings; with the
    intrinsic scatter, in float64, up to its last bits).
    On CUDA the form (a block or a warp per row) is
    :func:`~.gradient.k7_form`'s for W and the card's SM count."""
    if p.device.type == "cpu":
        if white is not None:
            return white.logp_and_grad_plain(p)
        return log_posterior_and_grad_plain(lp, p)
    if p.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA (or its plain version on the CPU), not {p.device}")
    if p.ndim != 2:
        raise ValueError(f"p must be (W, ndim), got shape {tuple(p.shape)}")
    from .gradient import k7_form, sm_count
    return logpost_grad_launch(lp, p, white, k7_form(p.shape[0], sm_count(p.device)))


def logpost_grad_launch(lp, p, white, form):
    """K7 on CUDA in the given ``form``: ``"block"`` (a block per row) or
    ``"warp"`` (a warp per row). :func:`log_posterior_and_grad` takes
    :func:`~.gradient.k7_form`'s; the card's tests and
    ``tools/time_port_kernels.py`` run both."""
    if form not in ("block", "warp"):
        raise ValueError(f"K7's form is 'block' or 'warp', not {form!r}")
    if p.device.type != "cuda":
        raise ValueError(f"K7's forms run on CUDA, not {p.device}")
    W, ndim = p.shape
    check(p, "p", (W, ndim), (torch.float64,), p.device)
    check_buffers(lp.log_likelihood, _BUFFERS, p.device)
    from .build import library
    from .gradient import _ptr, scratch, white_params
    lib = library()
    P = _kernel_params(lp, ndim, None, None)
    T = white_params(white, ndim) if white is not None else None
    f64 = lp.log_likelihood.compute_dtype == torch.float64
    val = torch.empty(W, dtype=torch.float64, device=p.device)
    grad = torch.empty((W, ndim), dtype=torch.float64, device=p.device)
    dev, stream = cuda_args(p.device)
    block = form == "block"
    buf = scratch(lib, P, f64, dev, 0, W, p.device) if block else None
    rc = lib.sc2_logpost_grad_launch(ctypes.addressof(P), dev, int(f64),
                                     None if T is None else ctypes.addressof(T), p.data_ptr(), W,
                                     val.data_ptr(), grad.data_ptr(), int(block), _ptr(buf),
                                     stream)
    if rc != 0:
        kernel = "logpost_grad_block_kernel" if block else "logpost_grad_kernel"
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
    LAUNCHES["logpost_grad"] += 1
    return val, grad
