"""Cubic-spline utilities: host-side coefficient construction (numpy/scipy)
and evaluation on the host (numpy) and on tensors, used by the F99
extinction optical/IR spline and the SiFTO Ia template (reference
models.py:717 uses scipy CubicSpline). The tensor evaluation
:func:`ppoly_eval` is the plain version of K8 (``kernels/cs.py``)."""

import numpy as np
import torch

__all__ = ["natural_cubic_coeffs", "notaknot_cubic_coeffs", "ppoly_eval", "ppoly_eval_np"]


def natural_cubic_coeffs(x, y):
    """Natural cubic spline (zero second derivative at both ends) through
    ``(x, y)``. Returns piecewise-polynomial coefficients ``c`` of shape
    ``(4, n-1)`` in scipy's PPoly layout (highest power first, local variable
    ``t = xq - x[i]``). Natural boundaries match the GSL cspline used by the
    Cython ``extinction`` package the reference imports (filters.py:9)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = len(x)
    h = np.diff(x)
    # solve tridiagonal system for second derivatives M (natural: M0 = Mn-1 = 0)
    a = np.zeros(n)
    b = np.ones(n)
    c_ = np.zeros(n)
    d = np.zeros(n)
    a[1:-1] = h[:-1] / 6.0
    b[1:-1] = (h[:-1] + h[1:]) / 3.0
    c_[1:-1] = h[1:] / 6.0
    d[1:-1] = (y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1]
    # Thomas algorithm
    for i in range(1, n):
        w = a[i] / b[i - 1]
        b[i] -= w * c_[i - 1]
        d[i] -= w * d[i - 1]
    M = np.zeros(n)
    M[-1] = d[-1] / b[-1]
    for i in range(n - 2, -1, -1):
        M[i] = (d[i] - c_[i] * M[i + 1]) / b[i]
    # convert to local polynomial coefficients on [x_i, x_{i+1}]
    c3 = (M[1:] - M[:-1]) / (6.0 * h)
    c2 = M[:-1] / 2.0
    c1 = (y[1:] - y[:-1]) / h - h * (2.0 * M[:-1] + M[1:]) / 6.0
    c0 = y[:-1]
    return np.stack([c3, c2, c1, c0])


def notaknot_cubic_coeffs(x, y):
    """Not-a-knot cubic spline coefficients (scipy CubicSpline default, used by
    the reference for the SiFTO template, models.py:717)."""
    from scipy.interpolate import CubicSpline
    cs = CubicSpline(np.asarray(x, float), np.asarray(y, float), extrapolate=False)
    return cs.c  # (4, n-1)


def _interval(x_knots, xq):
    """``searchsorted(x_knots, xq, side="right") - 1`` clipped to [0, n-2]:
    the interval of each query point, the last one at and beyond the end."""
    idx = torch.searchsorted(x_knots.contiguous(), xq.contiguous(), right=True) - 1
    return idx.clamp(0, x_knots.shape[0] - 2)


def ppoly_eval(x_knots, c, xq, extrapolate="clip"):
    """Evaluate a piecewise cubic polynomial on tensors (the JAX package's
    ``ppoly_eval``).

    Parameters
    ----------
    x_knots : (n,) breakpoints
    c : (4, n-1) coefficients, highest power first, or (..., 4, n-1) per
        query point (the leading axes broadcast against ``xq``)
    xq : query points; the knots and coefficients are taken in its dtype
    extrapolate : 'clip' evaluates the edge polynomial outside the domain;
        'nan' returns NaN outside (scipy ``extrapolate=False`` behavior).
    """
    xq = torch.as_tensor(xq)
    x_knots = torch.as_tensor(x_knots, device=xq.device).to(xq.dtype)
    c = torch.as_tensor(c, device=xq.device).to(xq.dtype)
    idx = _interval(x_knots, xq)
    t = xq - x_knots[idx]
    if c.ndim == 2:
        c0, c1, c2, c3 = c[0, idx], c[1, idx], c[2, idx], c[3, idx]
    else:
        shape = torch.broadcast_shapes(c.shape[:-2], xq.shape)
        cb = c.expand(*shape, *c.shape[-2:])
        ib = idx.expand(shape)[..., None, None].expand(*shape, 4, 1)
        c0, c1, c2, c3 = torch.gather(cb, -1, ib)[..., 0].unbind(-1)
    val = ((c0 * t + c1) * t + c2) * t + c3
    if extrapolate == "nan":
        outside = (xq < x_knots[0]) | (xq > x_knots[-1])
        val = torch.where(outside, torch.full_like(val, torch.nan), val)
    return val


def ppoly_eval_np(x_knots, c, xq, extrapolate="clip"):
    """Evaluate a piecewise cubic polynomial (PPoly layout) on the host."""
    x_knots = np.asarray(x_knots)
    c = np.asarray(c)
    xq = np.asarray(xq, float)
    idx = np.clip(np.searchsorted(x_knots, xq, side="right") - 1, 0, len(x_knots) - 2)
    t = xq - x_knots[idx]
    val = ((c[0, idx] * t + c[1, idx]) * t + c[2, idx]) * t + c[3, idx]
    if extrapolate == "nan":
        outside = (xq < x_knots[0]) | (xq > x_knots[-1])
        val = np.where(outside, np.nan, val)
    return val
