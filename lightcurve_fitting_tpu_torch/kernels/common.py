"""What the kernel wrappers of :mod:`.sc2`, :mod:`.sc3`, :mod:`.cs`,
:mod:`.epoch_bb`, :mod:`.quantile`, :mod:`.ladder` and :mod:`.gradient` share: the launch
counts, input checks, the parameter-block fields of the priors and the
affine map, and the plain PyTorch stretch move (the plain version of every
half-step kernel).
"""

import numpy as np
import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "MAX_DIM", "absolute_params", "log_posterior_plain",
           "propose_stretch", "half_update", "stretch_half_step_plain"]

MAX_DIM = 9  # LP_MAX_DIM of csrc/stretch.cuh

#: kernel launches by name; each wrapper adds one where it launches, and
#: nothing else does
LAUNCHES = {"sc2_logpost": 0, "stretch_half_step": 0, "bandflux": 0, "sc3_logpost": 0,
            "sc3_half_step": 0, "epoch_logpost": 0, "epoch_logpost_grad": 0,
            "epoch_map_polish": 0, "epoch_half_step": 0, "epoch_summary": 0, "percentile": 0,
            "tempered_half_step": 0, "ladder_init": 0, "replica_swap": 0, "rung_block_terms": 0,
            "logpost_grad": 0, "nuts_transition": 0, "hmc_transition": 0, "sifto": 0,
            "cs_logpost": 0, "cs_half_step": 0}

FLOATS = (torch.float32, torch.float64)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(t, name, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_buffers(ll, names, device):
    """The log-likelihood buffers a kernel reads: contiguous, on ``device``,
    floating ones in the compute dtype, indices int64, masks bool."""
    for name in names:
        buf = getattr(ll, name)
        want = ll.compute_dtype if buf.is_floating_point() else (
            torch.bool if buf.dtype == torch.bool else torch.int64)
        if buf.device != device or buf.dtype != want or not buf.is_contiguous():
            raise ValueError(f"log-likelihood buffer {name} must be a contiguous "
                             f"{want} tensor on {device}")


def cuda_args(device):
    """(device index, current stream handle) of a CUDA device."""
    return device.index if device.index is not None else torch.cuda.current_device(), \
        torch.cuda.current_stream(device).cuda_stream


def affine_key(offset, scale):
    if offset is None:
        return None
    return (tuple(float(v) for v in np.asarray(offset, float).ravel()),
            tuple(float(v) for v in np.asarray(scale, float).ravel()))


def fill_priors_and_affine(P, priors, affine):
    """Write the priors' kernel form and the affine map (``affine_key``
    output, or None) into parameter block ``P``."""
    for i, prior in enumerate(priors):
        P.prior_kind[i], P.p_min[i], P.p_max[i], P.mean[i], P.stddev[i] = prior.kernel_spec()
    P.has_affine = int(affine is not None)
    if affine is not None:
        for i, (o, s) in enumerate(zip(*affine)):
            P.affine_offset[i], P.affine_scale[i] = o, s


def half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                     check_partners):
    """The input checks of a half-step kernel; returns (half, ndim)."""
    if x.ndim != 3 or x.shape[0] != 2:
        raise ValueError(f"x must be (2, half, ndim), got shape {tuple(x.shape)}")
    if h not in (0, 1):
        raise ValueError("h must be 0 or 1")
    if (chain_x is None) != (chain_logp is None) or n_accept is None:
        raise ValueError("the half-step kernel needs n_accept, and chain_x with chain_logp "
                         "or neither")
    _, half, ndim = x.shape
    dev = x.device
    check(x, "x", (2, half, ndim), FLOATS, dev)
    check(logp, "logp", (2, half), (torch.float64,), dev)
    check(u_z, "u_z", (half,), (x.dtype,), dev)
    check(u_acc, "u_acc", (half,), (x.dtype,), dev)
    check(j, "j", (half,), (torch.int64,), dev)
    check(n_accept, "n_accept", (2, half), (torch.int32,), dev)
    if check_partners and bool(((j < 0) | (j >= half)).any()):
        raise ValueError(f"partner indices j must lie in [0, {half})")
    if chain_x is not None:
        check(chain_x, "chain_x", (2, half, ndim), FLOATS, dev)
        check(chain_logp, "chain_logp", (2, half), FLOATS, dev)
    return half, ndim


def half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept):
    """The tensor arguments of a ``*_half_step_launch`` C function, after
    the parameter block, device and compute-dtype flag."""
    return (x.data_ptr(), int(x.dtype == torch.float64), logp.data_ptr(), x.shape[1], int(h),
            u_z.data_ptr(), j.data_ptr(), u_acc.data_ptr(), float(a),
            None if chain_x is None else chain_x.data_ptr(),
            int(chain_x is not None and chain_x.dtype == torch.float64),
            None if chain_logp is None else chain_logp.data_ptr(),
            int(chain_logp is not None and chain_logp.dtype == torch.float64),
            n_accept.data_ptr())


# ------------------------------------------------------------ plain versions

def absolute_params(q, param_offset=None, param_scale=None):
    """The absolute float64 parameters ``offset + scale * q`` of walker
    states ``q``, or ``q`` in float64 when no affine map is given."""
    p = q.to(torch.float64)
    if param_offset is not None:
        off = torch.as_tensor(np.asarray(param_offset, float), device=q.device)
        sc = torch.as_tensor(np.asarray(param_scale, float), device=q.device)
        p = off + sc * p
    return p


def log_posterior_plain(lp, q, param_offset=None, param_scale=None):
    """Plain PyTorch batch log-posterior: ``lp``'s log-posterior at
    ``offset + scale * q`` (float64), or at ``q`` when no affine map is
    given."""
    return lp.forward_plain(absolute_params(q, param_offset, param_scale))


def propose_stretch(u_z, j, x_move, x_other, a=2.0):
    """The Goodman-Weare stretch proposal from given draws: z ~ g(z) ∝
    1/sqrt(z) on [1/a, a] as z = ((a-1)u + 1)^2 / a, and the partner
    ``x_other[j]``; returns (y, z). With a leading ensemble axis (x
    (E, half, ndim), draws (E, half)) each ensemble draws its partner from
    its own pool."""
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    x_j = torch.gather(x_other, -2, j[..., None].expand(*j.shape, x_other.shape[-1]))
    return x_j + z[..., None] * (x_move - x_j), z


def half_update(log_prob, x_move, x_other, logp_move, u_z, j, u_acc, a=2.0):
    """Plain half-step: propose, evaluate ``log_prob`` (of the walker state)
    on the proposals, accept if log u < (ndim-1) log z + lp(y) - lp(x).
    Returns (x_new, logp_new, accept)."""
    ndim = x_move.shape[-1]
    y, z = propose_stretch(u_z, j, x_move, x_other, a)
    logp_y = log_prob(y)
    logp_y = torch.where(torch.isnan(logp_y), torch.full_like(logp_y, -torch.inf), logp_y)
    log_ratio = (ndim - 1.0) * torch.log(z) + logp_y - logp_move
    accept = torch.log(u_acc) < log_ratio
    x_new = torch.where(accept[..., None], y, x_move)
    logp_new = torch.where(accept, logp_y, logp_move)
    return x_new, logp_new, accept


def stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a=2.0, chain_x=None,
                            chain_logp=None, n_accept=None):
    """Plain PyTorch half-step kernel, with the kernels' in-place contract:
    half ``h`` of ``x`` (2, half, ndim) and ``logp`` (2, half) is updated,
    ``n_accept[h]`` counts the accepts, and the chain slot gets the new half
    when given."""
    x_new, lp_new, acc = half_update(log_prob, x[h], x[1 - h], logp[h], u_z, j, u_acc, a)
    x[h] = x_new
    logp[h] = lp_new
    if n_accept is not None:
        n_accept[h] += acc.to(n_accept.dtype)
    if chain_x is not None:
        chain_x[h] = x_new.to(chain_x.dtype)
        chain_logp[h] = lp_new.to(chain_logp.dtype)
