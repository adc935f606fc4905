"""Wrappers of the SED kernel K10 (``csrc/sed.cu``) of the sequential
bolometric path, with their plain PyTorch versions beside them.

* :func:`log_posterior` (K10, ``logpost_warp_kernel`` over
  ``SEDWarpModel<C, N>``, a warp per walker): the log-posterior of an
  :class:`~..bolometric.SEDLogPosterior` (its table form: ``planck_fast``
  without reddening) at a batch of walker states, the priors inside it (the
  KDE prior of the single-filter epochs among them, its components over the
  warp's lanes). Plain version :func:`log_posterior_plain`.
* :func:`stretch_half_step` (K10's half-step, ``stretch_half_step_kernel``
  over ``SEDWarpModel``): one Goodman-Weare half-step of the ensemble, in
  place; a state's stored log-posterior has the bits K10 gives it. Plain
  version :func:`stretch_half_step_plain`.
* :func:`stretch_run` (K10's run form, ``stretch_run_kernel`` over
  ``SEDWarpModel``, one block): a whole segment of steps of an ensemble of
  up to 64 walkers (:func:`k10_form`) in one launch, over draws generated
  before it; the bits of the half-step launched twice a step. Plain
  version :func:`stretch_run_plain`.

The KDE prior sums its components in one order in all three, fixed by the
component index (``csrc/sed.cu``), so K10 at a state gives the bits the
half-step and the run store.

For a tensor on the CPU each wrapper runs its plain version. For a CUDA
tensor it launches the kernel or raises: there is no fallback (the
quadrature form of a reddened ``planck_fast`` raises NotImplementedError,
ROADMAP Queue 1 item 20; any other spectrum function runs on the host). Each launch adds
one to ``LAUNCHES[name]`` (``sed_logpost``, ``sed_half_step``, ``sed_run``),
and nothing else does.
"""

import ctypes

import torch

from .common import (LAUNCHES, MAX_DIM, KDE_KIND, FLOATS, check, cuda_args, affine_key,
                     half_step_checks, half_step_args, log_posterior_plain,
                     run_checks, stretch_half_step_plain as _half_step_plain,
                     stretch_run_plain as _run_plain)

__all__ = ["log_posterior", "log_posterior_plain", "stretch_half_step",
           "stretch_half_step_plain", "stretch_run", "stretch_run_plain", "k10_form",
           "kde_prior_of"]

#: the run form's largest half: a warp per walker of a half, 32 warps in its
#: one block (LP_RUN_WARPS of csrc/stretch.cuh)
RUN_MAX_HALF = 32


class _SEDParams(ctypes.Structure):
    """ctypes mirror of ``struct SEDParams`` (csrc/sed.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("coef", "s_a", "s_b", "y", "dy", "sigma_units", "kde")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_coef", "n_kde", "ndim", "use_sigma", "has_affine")]
                + [(n, ctypes.c_double) for n in
                   ("inv_yscale", "offset", "kde_bandwidth", "kde_lognorm")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")])


_BUFFERS = ("coef", "s_a", "s_b", "y", "dy", "sigma_units")


def kde_prior_of(priors):
    """The one KDE prior among ``priors`` (kind 3), or None; K10 takes at
    most one."""
    kdes = [p for p in priors if p.kernel_spec()[0] == KDE_KIND]
    if len(kdes) > 1:
        raise NotImplementedError("K10 takes at most one KDE prior")
    return kdes[0] if kdes else None


def _require_table(lp, device):
    if lp.form != "table":
        raise NotImplementedError("the quadrature SED form (planck_fast with ebv != 0) has no "
                                  "CUDA kernel yet (ROADMAP Queue 1 item 20); run it with "
                                  'device="cpu"')
    for name in _BUFFERS:
        buf = getattr(lp, name)
        want = lp.compute_dtype if name in ("coef", "s_a", "s_b") else torch.float64
        if buf.device != device or buf.dtype != want or not buf.is_contiguous():
            raise ValueError(f"SED buffer {name} must be a contiguous {want} tensor on {device}")


def _params(lp, ndim, offset, scale):
    """K10's parameter block for SEDLogPosterior ``lp``, cached on it and
    keyed by the buffers' addresses and the affine map."""
    kde = kde_prior_of(lp.priors)
    comp = kde.components(lp.y.device) if kde is not None else None
    key = (ndim, affine_key(offset, scale),
           tuple(getattr(lp, n).data_ptr() for n in _BUFFERS),
           None if comp is None else (comp.data_ptr(), kde.bandwidth, kde._lognorm))
    cache = lp.__dict__.setdefault("_kernel_params_cache", {})
    if key in cache:
        return cache[key][0]
    if ndim != len(lp.priors) or ndim != 2 + int(lp.use_sigma):
        raise ValueError(f"K10 takes ndim = 2 (+1 with use_sigma) matching the priors; got "
                         f"ndim={ndim} for {len(lp.priors)} priors")
    P = _SEDParams()
    for name in _BUFFERS:
        setattr(P, name, getattr(lp, name).data_ptr())
    P.kde = None if comp is None else comp.data_ptr()
    P.n_points, P.n_coef = lp.coef.shape
    P.n_kde = 0 if comp is None else comp.shape[0]
    P.ndim, P.use_sigma = ndim, int(lp.use_sigma)
    P.inv_yscale, P.offset = lp.inv_yscale, lp.offset
    P.kde_bandwidth = 1.0 if kde is None else kde.bandwidth
    P.kde_lognorm = 0.0 if kde is None else kde._lognorm
    for i, prior in enumerate(lp.priors):
        P.prior_kind[i], P.p_min[i], P.p_max[i], P.mean[i], P.stddev[i] = prior.kernel_spec()
    P.has_affine = int(key[1] is not None)
    if key[1] is not None:
        for i, (o, s) in enumerate(zip(*key[1])):
            P.affine_offset[i], P.affine_scale[i] = o, s
    cache[key] = (P, comp)   # the components stay alive with the block
    return P


# ----------------------------------------------------------------------- K10

def log_posterior(lp, q, param_offset=None, param_scale=None):
    """K10: the log-posterior (W,) float64 of SEDLogPosterior ``lp`` at each
    walker state ``q`` (W, ndim) float32/float64 (absolute parameters, or
    ``offset + scale * q`` when ``param_offset``/``param_scale`` are
    given)."""
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    if q.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA (or its plain version on the CPU), not {q.device}")
    if q.ndim != 2:
        raise ValueError(f"q must be (W, ndim), got shape {tuple(q.shape)}")
    W, ndim = q.shape
    check(q, "q", (W, ndim), FLOATS, q.device)
    _require_table(lp, q.device)
    from .build import library
    lib = library()
    P = _params(lp, ndim, param_offset, param_scale)
    out = torch.empty(W, dtype=torch.float64, device=q.device)
    dev, stream = cuda_args(q.device)
    rc = lib.sed_logpost_launch(ctypes.addressof(P), dev, int(lp.compute_dtype == torch.float64),
                                q.data_ptr(), int(q.dtype == torch.float64), W, out.data_ptr(),
                                stream)
    if rc != 0:
        raise RuntimeError(f"logpost_warp_kernel (SED, K10) launch failed: cudaError {rc}")
    LAUNCHES["sed_logpost"] += 1
    return out


# ------------------------------------------------------------- K10 half-step

def stretch_half_step_plain(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                            param_scale=None, chain_x=None, chain_logp=None, n_accept=None):
    """Plain K10 half-step: the kernel's in-place contract (arguments:
    :func:`stretch_half_step`) over :func:`log_posterior_plain`."""
    def log_prob(q):
        return log_posterior_plain(lp, q, param_offset, param_scale)
    return _half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp,
                            n_accept)


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """K10's half-step: one stretch-move half-step of SEDLogPosterior ``lp``
    on half ``h`` of the ensemble, in place (arguments as
    :func:`.sc2.stretch_half_step`: x (2, half, ndim), logp (2, half)
    float64, the draws (half,), n_accept (2, half) int32 and the optional
    chain slot)."""
    if x.device.type == "cpu":
        return stretch_half_step_plain(lp, x, logp, h, u_z, j, u_acc, a, param_offset,
                                       param_scale, chain_x, chain_logp, n_accept)
    if x.device.type != "cuda":
        raise ValueError(f"K10's half-step runs on CUDA (or its plain version on the CPU), "
                         f"not {x.device}")
    _, ndim = half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                               check_partners)
    _require_table(lp, x.device)
    from .build import library
    lib = library()
    P = _params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(x.device)
    rc = lib.sed_half_step_launch(
        ctypes.addressof(P), device_index, int(lp.compute_dtype == torch.float64),
        *half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept), stream)
    if rc != 0:
        raise RuntimeError(f"stretch_half_step_kernel (SED, K10) launch failed: cudaError {rc}")
    LAUNCHES["sed_half_step"] += 1


# ------------------------------------------------------------- K10 run form

def k10_form(half):
    """K10's form for an ensemble of ``2 * half`` walkers: ``"run"`` (a whole
    segment in one launch, :func:`stretch_run`) where a half fits the run
    form's block (``half <= RUN_MAX_HALF``), else ``"half"`` (a launch a
    half-step, :func:`stretch_half_step`)."""
    return "run" if 0 < half <= RUN_MAX_HALF else "half"


def stretch_run_plain(lp, x, logp, u_z, j, u_acc, a=2.0, param_offset=None, param_scale=None,
                      chain_x=None, chain_logp=None, n_accept=None, thin_by=1):
    """Plain K10 run: the kernel's in-place contract (arguments:
    :func:`stretch_run`), the plain half-step twice a proposal over
    :func:`log_posterior_plain`."""
    def log_prob(q):
        return log_posterior_plain(lp, q, param_offset, param_scale)
    return _run_plain(log_prob, x, logp, u_z, j, u_acc, a, chain_x, chain_logp, n_accept,
                      thin_by)


def stretch_run(lp, x, logp, u_z, j, u_acc, a=2.0, param_offset=None, param_scale=None,
                chain_x=None, chain_logp=None, n_accept=None, thin_by=1, check_partners=True):
    """K10's run form: ``n`` stretch-move proposals of SEDLogPosterior
    ``lp`` on the ensemble ``x`` (2, half, ndim), ``half <= RUN_MAX_HALF``,
    in place, in one launch: for each, half 0 and then half 1 (which reads
    half 0's new states as its partner pool). The draws ``u_z``, ``j``,
    ``u_acc`` are (n, 2, half) (proposal s's are ``u_z[s]``, ...; the
    uniforms in x's dtype, ``j`` int64); ``logp`` (2, half) float64 and
    ``n_accept`` (2, half) int32 as in :func:`stretch_half_step`; proposal s
    with ``s % thin_by == thin_by - 1`` writes its new states and
    log-posteriors into chain slot ``s // thin_by`` of ``chain_x`` (n //
    thin_by, 2, half, ndim) and ``chain_logp`` (n // thin_by, 2, half), when
    given. The same bits as ``2 n`` launches of :func:`stretch_half_step` on
    the same draws."""
    if x.device.type == "cpu":
        return stretch_run_plain(lp, x, logp, u_z, j, u_acc, a, param_offset, param_scale,
                                 chain_x, chain_logp, n_accept, thin_by)
    if x.device.type != "cuda":
        raise ValueError(f"K10's run form runs on CUDA (or its plain version on the CPU), not "
                         f"{x.device}")
    n, ndim = run_checks(x, logp, u_z, j, u_acc, chain_x, chain_logp, n_accept, thin_by,
                         check_partners)
    half = x.shape[1]
    if k10_form(half) != "run":
        raise ValueError(f"K10's run form takes a half of at most {RUN_MAX_HALF} walkers (one "
                         f"block); half {half} runs a launch a half-step (k10_form)")
    _require_table(lp, x.device)
    from .build import library
    lib = library()
    P = _params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(x.device)
    rc = lib.sed_run_launch(
        ctypes.addressof(P), device_index, int(lp.compute_dtype == torch.float64),
        x.data_ptr(), int(x.dtype == torch.float64), logp.data_ptr(), half, n, int(thin_by),
        u_z.data_ptr(), j.data_ptr(), u_acc.data_ptr(), float(a),
        None if chain_x is None else chain_x.data_ptr(),
        int(chain_x is not None and chain_x.dtype == torch.float64),
        None if chain_logp is None else chain_logp.data_ptr(),
        int(chain_logp is not None and chain_logp.dtype == torch.float64),
        n_accept.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stretch_run_kernel (SED, K10) launch failed: cudaError {rc}")
    LAUNCHES["sed_run"] += 1
