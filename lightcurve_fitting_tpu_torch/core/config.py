"""Runtime configuration.

``compute_dtype`` controls the precision of the log-likelihood hot path
(SC2 power laws, the Chebyshev band table, the residual sum). ``None``
inherits the input dtype — float64 for exact host parity. ``torch.float32``
runs the hot path in single precision: parameter and time arithmetic stay
float64 (MJD epochs need it), while the O(1) band-table arithmetic runs at
full FP32 rate. Relative error of the band fluxes in float32 is ~1e-7, far
below photometric uncertainty.

``AUTO`` (the default) resolves per device on every call: float32 on CUDA,
``None`` (ambient float64) on the CPU. Nothing is cached, so a CPU call never
pins a later CUDA call to float64 or the reverse.
"""

import contextlib

import torch

AUTO = "auto"
compute_dtype = AUTO


def set_compute_dtype(dtype):
    """Set the hot-path compute dtype (None, torch.float32, or config.AUTO
    to re-enable per-device resolution)."""
    global compute_dtype
    if dtype not in (AUTO, None, torch.float32, torch.float64):
        raise ValueError("compute_dtype must be config.AUTO, None, torch.float32 "
                         "or torch.float64")
    compute_dtype = dtype


def get_compute_dtype(device):
    """Resolve the hot-path dtype for ``device``: an explicit setting wins;
    AUTO gives float32 on CUDA and None (ambient precision) elsewhere."""
    if compute_dtype != AUTO:
        return compute_dtype
    return torch.float32 if torch.device(device).type == "cuda" else None


@contextlib.contextmanager
def override(dtype):
    """Set the compute dtype inside a ``with`` block, restoring the previous
    setting after it (used to build a float64 twin of a log-posterior)."""
    global compute_dtype
    previous = compute_dtype
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        compute_dtype = previous
