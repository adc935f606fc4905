"""Exact percentiles of float32 data by counting bisection (the port of
``lightcurve_fitting_tpu/ops/quantile.py``).

For the handful of quantiles the summary paths need (16/50/84), each exact
order statistic is found by bisection on the order-isomorphic int32 view of
the float32 data: 32 passes, each a compare-and-count over the row, all
(row, quantile) searches advancing together. The bracketing statistics are
interpolated linearly in float64, as ``numpy.percentile``'s default does.

IEEE-754 key map (total order, -0.0 < +0.0, NaNs above +inf):
``i = bitcast_int32(x); key = i < 0 ? ~i ^ INT32_MIN : i``.

:func:`percentile_f32` runs K5 (``kernels/csrc/quantile.cu``) on a CUDA
float32 tensor and :func:`percentile_f32_plain`, the same bisection in
PyTorch ops, on a CPU one; other dtypes go to ``torch.quantile``, as the
JAX function sends them to ``jnp.percentile``.
"""

import numpy as np
import torch

__all__ = ["percentile_f32", "percentile_f32_plain"]

_I32_MIN = -2147483648
_I32_MAX = 2147483647


def _sortable_key(a32):
    """Order-isomorphic int32 view of a float32 tensor."""
    i = a32.contiguous().view(torch.int32)
    return torch.where(i < 0, (~i) ^ _I32_MIN, i)


def _key_to_f32(k):
    back = torch.where(k < 0, ~(k ^ _I32_MIN), k)
    return back.contiguous().view(torch.float32)


def bisection_targets(n, q):
    """0-indexed ranks of the low and high brackets (each (Q,) int64) and
    the interpolation fractions (Q,) float64 of percentiles ``q`` over ``n``
    values."""
    q_arr = np.atleast_1d(np.asarray(q, np.float64))
    h = (n - 1) * q_arr / 100.0
    return np.floor(h).astype(np.int64), np.ceil(h).astype(np.int64), h - np.floor(h)


def _rows(a, axis):
    """``a`` moved to (rows, N) with the reduced axis last; returns it and
    the batch shape."""
    a = torch.movedim(a, axis % a.ndim, -1)
    return a.reshape(int(np.prod(a.shape[:-1])), a.shape[-1]), a.shape[:-1]


def percentile_f32_plain(a, q, axis=-1):
    """Plain PyTorch version of K5: the exact linear-interpolation
    percentiles of float32 ``a`` along ``axis``, shaped ``(len(q),) +
    batch_shape``, float64. NaNs sort above +inf (they are not propagated)."""
    if a.dtype != torch.float32:
        raise TypeError(f"percentile_f32_plain takes float32, not {a.dtype}")
    rows, batch = _rows(a, axis)
    N = rows.shape[-1]
    lo_rank, hi_rank, frac = bisection_targets(N, q)
    Q = len(frac)
    if N == 0:
        return torch.full((Q,) + tuple(batch), torch.nan, dtype=torch.float64, device=a.device)
    key = _sortable_key(rows)                                        # (B, N)
    ranks = torch.as_tensor(np.concatenate([lo_rank, hi_rank]), device=a.device)
    lo = torch.full((rows.shape[0], 2 * Q), _I32_MIN, dtype=torch.int32, device=a.device)
    hi = torch.full_like(lo, _I32_MAX)
    for _ in range(32):
        # overflow-free floor((lo + hi) / 2) in int32
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = (key[:, None, :] <= mid[:, :, None]).sum(-1)           # (B, 2Q)
        # the rank-th order statistic is the smallest v with count(key <= v) >= rank + 1
        take_hi = cnt >= ranks + 1
        lo, hi = torch.where(take_hi, lo, mid + 1), torch.where(take_hi, mid, hi)
    vals = _key_to_f32(lo).to(torch.float64)
    v_lo, v_hi = vals[:, :Q], vals[:, Q:]
    out = v_lo + torch.as_tensor(frac, device=a.device) * (v_hi - v_lo)   # (B, Q)
    return torch.movedim(out.reshape(tuple(batch) + (Q,)), -1, 0)


def percentile_f32(a, q, axis=-1):
    """Exact linear-interpolation percentiles along ``axis``, shaped
    ``(len(q),) + batch_shape``: K5 for a CUDA float32 tensor, the plain
    version for a CPU one (both float64 results with bit-identical order
    statistics); any other dtype goes to ``torch.quantile`` (linear)."""
    if a.dtype != torch.float32:
        qs = torch.as_tensor(np.atleast_1d(np.asarray(q, np.float64)) / 100.0, dtype=a.dtype,
                             device=a.device)
        return torch.quantile(a, qs, dim=axis % a.ndim, interpolation="linear")
    if a.device.type == "cpu":
        return percentile_f32_plain(a, q, axis)
    from ..kernels import quantile as kq
    rows, batch = _rows(a, axis)
    if rows.shape[-1] == 0:
        return torch.full((len(bisection_targets(0, q)[2]),) + tuple(batch), torch.nan,
                          dtype=torch.float64, device=a.device)
    out = kq.percentile_rows(rows.contiguous(), q)                   # (Q, B)
    return out.reshape((out.shape[0],) + tuple(batch))
