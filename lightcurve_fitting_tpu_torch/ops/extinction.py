"""Fitzpatrick (1999) R_V-dependent Galactic extinction law.

``lightcurve_fitting_tpu/ops/extinction.py`` on numpy and tensors: UV uses
the Fitzpatrick & Massa (1990) parametrization with the F99 coefficients;
optical/IR is a natural cubic spline through the standard F99 anchor points.
On the host: :func:`fitzpatrick99`, :func:`extinction_law`,
:func:`f99_curve`. On tensors: :func:`f99_k_tensor`, the curve at
wavelengths held in a tensor (the JAX package's ``f99_k_jax``), and
:func:`extinction_factor`, which applies a sampled E(B-V) to the curve
precomputed at static quadrature nodes.
"""

import functools

import numpy as np
import torch

from .interpolate import natural_cubic_coeffs, ppoly_eval, ppoly_eval_np
from ..core.constants import C_AA_THZ

__all__ = ["fitzpatrick99", "extinction_law", "f99_curve", "f99_k_tensor", "extinction_factor",
           "EXT_COEF"]

EXT_COEF = -0.4 * np.log(10.0)   # 10^(A/-2.5) = exp(EXT_COEF * A)

_X0 = 4.596     # UV bump position (1/um)
_GAMMA = 0.99   # UV bump width
_C3 = 3.23
_C4 = 0.41
_C5 = 5.9
_UV_CUT = 1e4 / 2700.0   # spline/UV transition (1/um)
_SPLINE_X = np.array([0.0, 1e4 / 26500.0, 1e4 / 12200.0, 1e4 / 6000.0, 1e4 / 5470.0,
                      1e4 / 4670.0, 1e4 / 4110.0, 1e4 / 2700.0, 1e4 / 2600.0])


def _uv_k(x, rv):
    """FM90 k(lambda-V) + R_V in the UV, giving A(lambda)/E(B-V)."""
    c2u = -0.824 + 4.717 / rv
    c1u = 2.030 - 3.007 * c2u
    x2 = x * x
    d = x2 / ((x2 - _X0 ** 2) ** 2 + x2 * _GAMMA ** 2)
    k = c1u + c2u * x + _C3 * d
    y = x - _C5
    fuv = _C4 * (0.5392 * y ** 2 + 0.05644 * y ** 3)
    k = k + np.where(x > _C5, fuv, 0.0)
    return k + rv


@functools.lru_cache(maxsize=8)
def _spline_for_rv(rv):
    """Anchor values and natural-spline coefficients of A(lambda)/E(B-V) for a
    given R_V (host-cached; R_V is always a concrete float)."""
    y = np.empty(9)
    y[0] = 0.0
    y[1] = 0.26469 * rv / 3.1
    y[2] = 0.82925 * rv / 3.1
    y[3] = -0.422809 + 1.00270 * rv + 2.13572e-04 * rv ** 2
    y[4] = -5.13540e-02 + 1.00216 * rv - 7.35778e-05 * rv ** 2
    y[5] = 0.700127 + 1.00184 * rv - 3.32598e-05 * rv ** 2
    y[6] = (1.19456 + 1.01707 * rv - 5.46959e-03 * rv ** 2
            + 7.97809e-04 * rv ** 3 - 4.45636e-05 * rv ** 4)
    y[7:] = _uv_k(_SPLINE_X[7:], rv)
    coeffs = natural_cubic_coeffs(_SPLINE_X, y)
    return _SPLINE_X, coeffs


def f99_curve(wave, rv=3.1):
    """A(lambda)/E(B-V) at wavelengths ``wave`` (angstrom), host numpy."""
    wave = np.atleast_1d(np.asarray(wave, float))
    x = 1e4 / wave  # inverse microns
    knots, coeffs = _spline_for_rv(float(rv))
    k_spline = ppoly_eval_np(knots, coeffs, x)
    k_uv = _uv_k(x, rv)
    return np.where(x >= _UV_CUT, k_uv, k_spline)


def fitzpatrick99(wave, a_v, r_v=3.1):
    """Fitzpatrick (1999) extinction A(lambda) in magnitudes.

    Same signature and semantics as ``extinction.fitzpatrick99``:
    ``wave`` in angstroms, ``a_v = r_v * E(B-V)``.
    """
    return f99_curve(wave, r_v) * (a_v / r_v)


def extinction_law(freq, ebv, rv=3.1):
    """Extinction *factor* ``10^(A/-2.5)`` at frequencies ``freq`` (THz) in the
    dust frame — vectorized over ``ebv`` exactly like reference filters.py:14-33."""
    freq = np.asarray(freq, float)
    k = f99_curve(C_AA_THZ / freq, rv)  # (nfreq,)
    ebv_arr = np.atleast_1d(np.asarray(ebv, float))
    A = np.squeeze(np.multiply.outer(ebv_arr, k))
    return 10.0 ** (A / -2.5)


def f99_k_tensor(wave_aa, rv=3.1):
    """A(lambda)/E(B-V) at the wavelengths (angstrom) of a float tensor, in
    its dtype and on its device (the JAX package's ``f99_k_jax``). R_V must
    be a concrete float (it is never sampled in any reference model)."""
    knots, coeffs = _spline_for_rv(float(rv))
    x = 1e4 / wave_aa
    k_spline = ppoly_eval(knots, coeffs, x)
    k_uv = _uv_k_tensor(x, float(rv))
    return torch.where(x >= _UV_CUT, k_uv, k_spline)


def _uv_k_tensor(x, rv):
    """:func:`_uv_k` on a tensor, in the JAX package's ``_uv_k_jax`` order."""
    c2u = -0.824 + 4.717 / rv
    c1u = 2.030 - 3.007 * c2u
    x2 = x * x
    d = x2 / ((x2 - _X0 ** 2) ** 2 + x2 * _GAMMA ** 2)
    k = c1u + c2u * x + _C3 * d
    y = x - _C5
    fuv = _C4 * (0.5392 * y ** 2 + 0.05644 * y ** 3)
    return k + torch.where(x > _C5, fuv, torch.zeros_like(fuv)) + rv


def extinction_factor(k, ebv):
    """``10^(ebv*k/-2.5)`` for tensors: ``k`` the precomputed A/E(B-V) at
    static nodes, ``ebv`` a sampled E(B-V) broadcastable to it (reference
    ``extinction_factor_jax``, same operation order)."""
    return torch.exp(k * ebv * EXT_COEF)
