"""Blackbody spectra and synthetic photometry, on tensors (the port of
``lightcurve_fitting_tpu/models/blackbody.py``).

Device side: :func:`planck_lnu`, :func:`bandflux_pointwise` and
:func:`bandflux_outer`. The band integral is a weighted sum over the
quadrature nodes of :class:`~lightcurve_fitting_tpu_torch.ops.filterbank.FilterBank`.
:func:`bandflux_pointwise` is K3: on a CUDA tensor it launches the
hand-written kernel ``bandflux_kernel`` (``kernels/sc3.py``), on a CPU
tensor it runs :func:`bandflux_pointwise_plain`. :func:`bandflux_outer` is
plain PyTorch on every device (no fit calls it).

Host side: :func:`planck_fast`, :func:`planck` and :func:`blackbody_to_filters`
reproduce the reference API, broadcasting conventions included
(models.py:1105-1200), on numpy in and out.
"""

import numpy as np
import torch

from ..core import config
from ..core.constants import c1, c2
from ..ops.extinction import extinction_factor
from ..ops.filterbank import bank_for
from ..ops.mathx import planck_denom_inv, safe_reciprocal

__all__ = ["planck_fast", "planck", "blackbody_to_filters", "planck_lnu",
           "bandflux_pointwise", "bandflux_pointwise_plain", "bandflux_outer"]


# ----------------------------------------------------------------- device side

def planck_lnu(nu, T, R, cutoff_freq=np.inf):
    """Spectral luminosity L_nu (W/Hz) of a blackbody; elementwise broadcast.

    nu in THz, T in kK, R in 1000 Rsun. ``T <= 0`` yields 0 (reference
    models.py:1105-1128); the Wien tail overflows to 1/inf = 0, never NaN.
    """
    x = c1 * nu * safe_reciprocal(T)
    cut = torch.clamp(cutoff_freq / nu, max=1.0)
    return c2 * R ** 2 * nu ** 3 * cut * planck_denom_inv(x)


def bandflux_pointwise_plain(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None,
                             ebv=0.0, band_ids=None):
    """Plain PyTorch K3: the band-averaged L_nu per photometry point.

    nodes_emit, weights, k_ext: (N, K) per point, or (B, K) per band with
    ``band_ids`` (N,) naming each point's row; T, R: (..., N), walker axes
    leading; ``ebv`` broadcastable to (..., N) (a scalar, a (W, 1) column
    per walker, or per point). Returns (..., N) in T's dtype.

    The (..., N, K) Planck cube runs in the compute dtype of T's device
    when one is set (float32 on CUDA by default), as in the JAX package.
    """
    if band_ids is not None:
        nodes_emit, weights = nodes_emit[band_ids], weights[band_ids]
        k_ext = None if k_ext is None else k_ext[band_ids]
    out_dtype = T.dtype
    dt = config.get_compute_dtype(T.device)
    if dt is not None:
        nodes_emit, weights, T, R = (a.to(dt) for a in (nodes_emit, weights, T, R))
    lnu = planck_lnu(nodes_emit, T[..., None], R[..., None], cutoff_freq)
    if k_ext is not None:
        ebv = torch.as_tensor(ebv, dtype=torch.float64, device=T.device) \
            if not torch.is_tensor(ebv) else ebv
        if dt is not None:
            k_ext, ebv = k_ext.to(dt), ebv.to(dt)
        if ebv.ndim:                       # per walker or per point: (..., N) -> (..., N, 1)
            ebv = ebv[..., None]
        lnu = lnu * extinction_factor(k_ext, ebv)
    return torch.sum(weights * lnu, dim=-1).to(out_dtype)


def bandflux_pointwise(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0,
                       band_ids=None):
    """K3: :func:`bandflux_pointwise_plain`'s result, computed on a CUDA
    tensor by the hand-written ``bandflux_kernel`` and on a CPU tensor by
    the plain version. Any other device raises."""
    if T.device.type == "cpu":
        return bandflux_pointwise_plain(nodes_emit, weights, T, R, cutoff_freq, k_ext, ebv,
                                        band_ids)
    from ..kernels import sc3
    return sc3.bandflux(nodes_emit, weights, T, R, cutoff_freq, k_ext, ebv, band_ids)


def bandflux_outer(nodes_emit, weights, T, R, cutoff_freq=np.inf, k_ext=None, ebv=0.0):
    """Band-averaged L_nu for all B bands at all T/R values, plain PyTorch.

    nodes_emit, weights, k_ext: (B, K); T, R: any shape S; ``ebv`` a scalar
    or one value per T. Returns (B,) + S.
    """
    sh = T.shape
    lnu = planck_lnu(nodes_emit[:, None, :], T.reshape(1, -1, 1), R.reshape(1, -1, 1),
                     cutoff_freq)  # (B, prod(S), K)
    if k_ext is not None:
        ebv = torch.as_tensor(ebv, dtype=torch.float64, device=T.device)
        lnu = lnu * extinction_factor(k_ext[:, None, :], ebv.reshape(1, -1, 1))
    out = torch.einsum("bsk,bk->bs", lnu, weights)
    return out.reshape((nodes_emit.shape[0],) + tuple(sh))


# ------------------------------------------------------------------- host side

def _f64(a, device="cpu"):
    return torch.tensor(np.asarray(a, float), device=device)


def planck_fast(nu, T, R, cutoff_freq=np.inf):
    """The reference's ``planck_fast`` (models.py:1105-1128): outer-product
    broadcasting of (T, R) against nu, squeezed. Host numpy in/out."""
    nu, T, R = _f64(nu), _f64(T), _f64(R)
    lnu = planck_lnu(nu.reshape((1,) * T.ndim + tuple(nu.shape)),
                     T.reshape(tuple(T.shape) + (1,) * nu.ndim),
                     R.reshape(tuple(R.shape) + (1,) * nu.ndim),
                     cutoff_freq)
    return np.squeeze(lnu.numpy())


def planck(nu, T, R, dT=0.0, dR=0.0, cov=0.0):
    """Blackbody L_nu with linear uncertainty propagation (reference
    models.py:1168-1200)."""
    Lnu = planck_fast(nu, T, R)
    if not np.any(dT) and not np.any(dR) and not np.any(cov):
        return Lnu
    dlogLdT = c1 * nu * T ** -2 / (1 - np.exp(-c1 * nu / T))
    dlogLdR = 2.0 / R
    dLnu = Lnu * (dlogLdT ** 2 * dT ** 2 + dlogLdR ** 2 * dR ** 2
                  + 2.0 * dlogLdT * dlogLdR * cov) ** 0.5
    return Lnu, dLnu


def blackbody_to_filters(filters, T, R, z=0.0, cutoff_freq=np.inf, ebv=0.0, n_nodes=None,
                         device=None):
    """Band-averaged blackbody L_nu through one or more filters (reference
    models.py:1131-1165): pointwise mode when ``len(T) == len(filters)`` and T
    is 1-D, outer mode otherwise. ``device`` (default the CPU) is where the
    band sums run: on CUDA the pointwise mode launches K3."""
    T = np.asarray(T, float)
    R = np.asarray(R, float)
    if T.shape != R.shape:
        raise Exception("T & R must have the same shape")
    np.broadcast(T, ebv)  # raises if not broadcastable, as in the reference
    filters = np.atleast_1d(filters)
    bank = bank_for(tuple(filters), n_nodes)
    dev = torch.device(device if device is not None else "cpu")
    if T.ndim == 1 and len(T) == len(filters):  # pointwise, over the per-band tables
        y = bandflux_pointwise(_f64(bank.emitted_nodes(z), dev), _f64(bank.weights, dev),
                               _f64(T, dev), _f64(R, dev), cutoff_freq,
                               _f64(bank.ext_curve(z), dev), _f64(ebv, dev),
                               band_ids=torch.as_tensor(bank.band_ids(filters), device=dev,
                                                        dtype=torch.int64))
    else:
        ebv_arr = np.broadcast_to(np.asarray(ebv, float), T.shape) if np.ndim(ebv) else ebv
        y = bandflux_outer(_f64(bank.emitted_nodes(z), dev), _f64(bank.weights, dev),
                           _f64(T, dev), _f64(R, dev), cutoff_freq,
                           _f64(bank.ext_curve(z), dev), _f64(ebv_arr, dev))
    return y.cpu().numpy()
