"""Wrapper of K5 (``csrc/quantile.cu``, ``percentile_kernel``): exact
percentiles of float32 rows by counting bisection. The plain version is
:func:`~lightcurve_fitting_tpu_torch.ops.quantile.percentile_f32_plain`;
:func:`~lightcurve_fitting_tpu_torch.ops.quantile.percentile_f32` routes a
CPU tensor there and a CUDA one here. Each launch adds one to
``LAUNCHES["percentile"]``, and nothing else does.
"""

import ctypes

import numpy as np
import torch

from .common import LAUNCHES, check, cuda_args

__all__ = ["percentile_rows", "MAX_Q"]

MAX_Q = 8  # PCT_MAX_Q of csrc/quantile.cu


class _PercentileParams(ctypes.Structure):
    """ctypes mirror of ``struct PercentileParams`` (csrc/quantile.cu)."""
    _fields_ = [("a", ctypes.c_void_p), ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("n_q", ctypes.c_longlong),
                ("rank_lo", ctypes.c_longlong * MAX_Q), ("rank_hi", ctypes.c_longlong * MAX_Q),
                ("frac", ctypes.c_double * MAX_Q)]


def percentile_rows(rows, q):
    """K5 on a CUDA float32 tensor ``rows`` (B, N), contiguous: the
    percentiles ``q`` of each row, (len(q), B) float64."""
    from ..ops.quantile import bisection_targets
    if rows.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA (or its plain version on the CPU), not {rows.device}")
    if rows.ndim != 2 or rows.shape[1] == 0:
        raise ValueError(f"rows must be (B, N) with N > 0, got {tuple(rows.shape)}")
    check(rows, "rows", rows.shape, (torch.float32,), rows.device)
    B, N = rows.shape
    lo_rank, hi_rank, frac = bisection_targets(N, q)
    Q = len(frac)
    if not 0 < Q <= MAX_Q or not np.all((lo_rank >= 0) & (hi_rank < N)):
        raise ValueError(f"K5 takes 1 to {MAX_Q} percentiles in [0, 100], got {q}")
    out = torch.empty((Q, B), dtype=torch.float64, device=rows.device)
    P = _PercentileParams()
    P.a, P.out, P.rows, P.n, P.n_q = rows.data_ptr(), out.data_ptr(), B, N, Q
    for i in range(Q):
        P.rank_lo[i], P.rank_hi[i], P.frac[i] = int(lo_rank[i]), int(hi_rank[i]), float(frac[i])
    from .build import library
    lib = library()
    device_index, stream = cuda_args(rows.device)
    rc = lib.percentile_launch(ctypes.addressof(P), device_index, stream)
    if rc != 0:
        raise RuntimeError(f"percentile_kernel launch failed: cudaError {rc}")
    LAUNCHES["percentile"] += 1
    return out
