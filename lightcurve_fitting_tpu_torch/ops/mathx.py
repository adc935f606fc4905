"""Small numerics helpers shared by the model code, on tensors.

These encode the reference's NaN-avoidance semantics (``models.py:42-48``:
power() returns 0 for nonpositive base) with the double-``where`` pattern of
``lightcurve_fitting_tpu/ops/mathx.py``, which keeps gradients NaN-free.
"""

import torch

from ..core import config

__all__ = ["power", "safe_reciprocal", "planck_denom_inv", "hot", "hot_phase"]


def hot(device, *xs):
    """Cast tensors into the hot-path compute dtype of ``device`` (no-op when
    it resolves to None). Used right after the epoch subtraction
    ``t - t_exp``: absolute MJDs need float64, but the elapsed times and
    physical parameters are O(1)-O(100) and are float32-safe."""
    dt = config.get_compute_dtype(device)
    if dt is None:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(torch.as_tensor(x, device=device).to(dt) for x in xs)
    return out if len(out) > 1 else out[0]


def hot_phase(t, t_exp):
    """Elapsed time ``t - t_exp`` in the hot-path dtype of ``t``'s device.

    Both operands are first centered on the per-dataset epoch
    ``t_ref = floor(min t)``, which makes them O(10): an absolute float32
    MJD (~5.7e4) would quantize at ~6 min, while the centered float32
    difference resolves ~0.1 s. With no compute dtype the plain float64
    difference is returned, as in the JAX package."""
    t = torch.as_tensor(t, dtype=torch.float64)
    dt = config.get_compute_dtype(t.device)
    t_exp = torch.as_tensor(t_exp, dtype=torch.float64, device=t.device)
    if dt is None:
        return t - t_exp
    t_ref = epoch_reference(t)
    return (t - t_ref).to(dt) - (t_exp - t_ref).to(dt)


def epoch_reference(t):
    """``floor(min t)`` over the finite times (0 when none is finite): the
    centering epoch of :func:`hot_phase`, as a float64 scalar tensor."""
    t = torch.as_tensor(t, dtype=torch.float64)
    finite = torch.isfinite(t)
    t_ref = torch.floor(torch.min(torch.where(finite, t, torch.inf)))
    return torch.where(torch.isfinite(t_ref), t_ref, torch.zeros_like(t_ref))


def power(base, exp):
    """``base ** exp`` that returns 0 where ``base <= 0`` (reference
    models.py:42-48) without NaN gradients."""
    positive = base > 0.0
    safe_base = torch.where(positive, base, torch.ones_like(base))
    return torch.where(positive, safe_base ** exp, torch.zeros_like(base))


def safe_reciprocal(x):
    """1/x that returns 0 where ``x <= 0`` (matches reference
    ``power(x, -1.)`` semantics)."""
    positive = x > 0.0
    return torch.where(positive, 1.0 / torch.where(positive, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def planck_denom_inv(x):
    """``1 / (exp(x) - 1)`` with the reference's convention that x <= 0 maps
    to 0 (reference models.py:1128: a nonpositive temperature yields x = 0
    there and hence zero luminosity).

    expm1 keeps float32 accurate in the Rayleigh-Jeans limit, and the Wien
    tail overflows to 1/inf = 0 instead of NaN."""
    return safe_reciprocal(torch.expm1(x))
