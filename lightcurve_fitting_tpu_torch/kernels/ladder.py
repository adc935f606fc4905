"""Wrappers of the tempered-ladder kernels (K6), with their plain PyTorch
versions beside them.

* :func:`tempered_half_step` (K6a, ``tempered_half_step_kernel`` of
  ``csrc/ladder.cuh`` over the model's policy, in ``sc2_logpost.cu``,
  ``sc3_logpost.cu`` or ``companion.cu``: a warp per walker over
  ShockCooling2 and the companion-shocking models, a thread per walker over
  ShockCooling3): one stretch-move half-step of every rung's ensemble,
  accepting by log pi + beta log L;
* :func:`ladder_init` (K6b, ``ladder_init_kernel``, a warp per state over
  the model's warp policy): log pi and log L of the ladder's starting
  states, each distinct state evaluated once and written to every rung
  that starts from it (``copies``);
* :func:`replica_swap` (K6c, ``replica_swap_kernel`` of ``csrc/ladder.cu``):
  the exchange between neighbouring rungs, writing a production step's
  outputs;
* :func:`rung_block_terms` (K6d, ``rung_block_terms_kernel``): the
  stepping-stone terms log mean exp(dbeta_k log L_k) of each block of
  production steps, in one pass over the log L by enough CTAs to fill the
  card (:func:`k6d_splits`), the same bits on every run.

The ladder's target is a LogPosterior (the priors and the
:class:`~lightcurve_fitting_tpu_torch.models.base.LogLikelihood` of
ShockCooling2, ShockCooling3 or a companion-shocking model), whose kernels
K6a and K6b evaluate, or a pair ``(log_prior, log_like)`` of torch callables
of absolute float64 parameters (W, ndim) -> (W,), which only the plain
versions run. For a
tensor on the CPU each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises: there is no fallback. Each launch adds one to
``LAUNCHES[name]``, and nothing else does.
"""

import ctypes
import numbers

import numpy as np
import torch

from .common import (LAUNCHES, FLOATS, absolute_params, check, check_buffers, cuda_args,
                     propose_stretch)

__all__ = ["tempered_half_step", "ladder_init", "replica_swap", "rung_block_terms",
           "plain_functions", "tempered_half_update", "replica_swap_update", "swap_partners",
           "tempered_half_step_plain", "ladder_init_plain", "replica_swap_plain",
           "rung_block_terms_plain", "k6d_splits"]

MAX_BLOCKS = 8   # LADDER_MAX_BLOCKS of csrc/ladder.cu
MAX_SPLITS = 32  # TERMS_MAX_SPLITS of csrc/ladder.cu
#: K6d's CTAs a card aims at, per SM (k6d_splits). On the H100 at the
#: evidence bench shape 2 (5 splits) took 0.0402 ms, 4 (9) 0.0422 and 8
#: (17) 0.0419 (tools/time_port_kernels.py K6d_cta*_dev; PERF.md)
K6D_CTAS_PER_SM = 2
#: the least items (16-byte pairs of values, or values) a K6d split takes:
#: one chunk of loads of each of its threads (TERMS_THREADS x TERMS_CHUNK)
K6D_SPLIT_ITEMS = 256 * 4


def plain_functions(target, param_offset=None, param_scale=None):
    """``(log_prior, log_like)`` of walker states (..., ndim), affine-mapped
    to absolute parameters when ``param_offset``/``param_scale`` are given,
    -> (...) float64: the plain versions of what K6a and K6b evaluate for a
    LogPosterior ``target``, or the given callables of a pair."""
    if isinstance(target, tuple):
        fns = target
    else:
        fns = (target.log_prior_plain, target.log_likelihood_plain)

    def on_states(fn):
        def f(q):
            p = absolute_params(q.reshape(-1, q.shape[-1]), param_offset, param_scale)
            return torch.as_tensor(fn(p), dtype=torch.float64).reshape(q.shape[:-1])
        return f
    return tuple(on_states(fn) for fn in fns)


def _fused(target, what):
    """The LogPosterior of ``target`` and its model's kernel module, or
    NotImplementedError for callables on a non-CPU device."""
    from . import module_for
    if isinstance(target, tuple):
        raise NotImplementedError(
            f"on CUDA {what} runs a fused kernel, which takes the priors and the "
            "LogLikelihood of a model with kernels; other log-probabilities run on the CPU")
    return target, module_for(target.log_likelihood.model)


def _ladder_checks(x, logpri, logl, betas):
    """x (R, 2, half, ndim), logpri and logl (R, 2, half) float64, betas (R,)
    float64, all contiguous on x's device; returns (R, half, ndim)."""
    if x.ndim != 4 or x.shape[1] != 2:
        raise ValueError(f"x must be (R, 2, half, ndim), got shape {tuple(x.shape)}")
    R, _, half, ndim = x.shape
    dev = x.device
    check(x, "x", (R, 2, half, ndim), FLOATS, dev)
    check(logpri, "logpri", (R, 2, half), (torch.float64,), dev)
    check(logl, "logl", (R, 2, half), (torch.float64,), dev)
    check(betas, "betas", (R,), (torch.float64,), dev)
    return R, half, ndim


def _ptr(t):
    return None if t is None else t.data_ptr()


# ----------------------------------------------------------------------- K6a

def tempered_half_update(log_prior, log_like, x_move, x_other, logpri_move, logl_move, betas,
                         u_z, j, u_acc, a=2.0):
    """The plain tempered half-step of every rung (evidence.py:60-74): x_move,
    x_other (R, half, ndim), logpri_move, logl_move and the draws (R, half),
    betas (R,). Accepts when log u < (ndim-1) log z + lp(y) + beta ll(y) -
    lp(x) - beta ll(x), with beta ll := 0 on a beta = 0 rung. Returns
    (x_new, logpri_new, logl_new, accept)."""
    ndim = x_move.shape[-1]
    y, z = propose_stretch(u_z, j, x_move, x_other, a)
    logpri_y = log_prior(y)
    logl_y = log_like(y)
    logl_y = torch.where(torch.isnan(logl_y), torch.full_like(logl_y, -torch.inf), logl_y)
    beta = betas[:, None]
    # beta = 0 rungs sample the bare prior: 0 * (-inf) would poison them
    blogl_y = torch.where(beta > 0.0, beta * logl_y, torch.zeros_like(logl_y))
    blogl_move = torch.where(beta > 0.0, beta * logl_move, torch.zeros_like(logl_move))
    log_ratio = (ndim - 1.0) * torch.log(z) + logpri_y + blogl_y - logpri_move - blogl_move
    accept = torch.log(u_acc) < log_ratio
    return (torch.where(accept[..., None], y, x_move), torch.where(accept, logpri_y, logpri_move),
            torch.where(accept, logl_y, logl_move), accept)


def tempered_half_step_plain(log_prior, log_like, x, logpri, logl, betas, h, u_z, j, u_acc,
                             a=2.0, n_accept=None):
    """Plain PyTorch K6a with the kernel's in-place contract: half ``h`` of
    every rung of ``x`` (R, 2, half, ndim), ``logpri`` and ``logl`` (R, 2,
    half) is updated from the [:, h] slices of the draws (R, 2, half), and
    ``n_accept[:, h]`` counts the accepts."""
    x_new, pri_new, ll_new, acc = tempered_half_update(
        log_prior, log_like, x[:, h], x[:, 1 - h], logpri[:, h], logl[:, h], betas, u_z[:, h],
        j[:, h], u_acc[:, h], a)
    x[:, h] = x_new
    logpri[:, h] = pri_new
    logl[:, h] = ll_new
    if n_accept is not None:
        n_accept[:, h] += acc.to(n_accept.dtype)


def tempered_half_step(target, x, logpri, logl, betas, h, u_z, j, u_acc, a=2.0,
                       param_offset=None, param_scale=None, n_accept=None, check_partners=True):
    """K6a: one tempered stretch-move half-step of half ``h`` of every rung,
    in place.

    x (R, 2, half, ndim) float32/float64 walker states (affine-rescaled when
    ``param_offset``/``param_scale`` are given), logpri and logl (R, 2, half)
    float64, betas (R,) float64; u_z, u_acc (R, 2, half) uniforms in x's
    dtype and j (R, 2, half) int64 partners in [0, half), of which the
    half-step reads the [:, h] slice; n_accept (R, 2, half) int32,
    incremented. ``check_partners`` verifies the partners before the launch
    (the kernel reads them unchecked); it synchronizes with the device."""
    if x.device.type == "cpu":
        return tempered_half_step_plain(*plain_functions(target, param_offset, param_scale), x,
                                        logpri, logl, betas, h, u_z, j, u_acc, a, n_accept)
    lp, mod = _fused(target, "the tempered half-step")
    R, half, ndim = _ladder_checks(x, logpri, logl, betas)
    if h not in (0, 1):
        raise ValueError("h must be 0 or 1")
    if n_accept is None:
        raise ValueError("the tempered half-step kernel needs n_accept")
    dev = x.device
    for name, t, dts in (("u_z", u_z, (x.dtype,)), ("u_acc", u_acc, (x.dtype,)),
                         ("j", j, (torch.int64,)), ("n_accept", n_accept, (torch.int32,))):
        check(t, name, (R, 2, half), dts, dev)
    if check_partners and bool(((j < 0) | (j >= half)).any()):
        raise ValueError(f"partner indices j must lie in [0, {half})")
    check_buffers(lp.log_likelihood, mod._BUFFERS, dev)
    from .build import library
    lib = library()
    P = mod._kernel_params(lp, ndim, param_offset, param_scale)
    device_index, stream = cuda_args(dev)
    launch = getattr(lib, f"{mod.__name__.rsplit('.', 1)[-1]}_tempered_half_step_launch")
    rc = launch(ctypes.addressof(P), device_index,
                int(lp.log_likelihood.compute_dtype == torch.float64), x.data_ptr(),
                int(x.dtype == torch.float64), logpri.data_ptr(), logl.data_ptr(),
                betas.data_ptr(), R, half, int(h), u_z.data_ptr(), j.data_ptr(), u_acc.data_ptr(),
                float(a), n_accept.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tempered_half_step_kernel launch failed: cudaError {rc}")
    LAUNCHES["tempered_half_step"] += 1


# ----------------------------------------------------------------------- K6b

def ladder_init_plain(log_prior, log_like, x, copies=1):
    """Plain K6b: (logpri, logl) of the states x (S, ..., ndim), a NaN log L
    mapped to -inf (evidence.py:229-235), each state's values repeated in
    ``copies`` consecutive rows of the first axis: (S * copies, ...)."""
    logl = log_like(x)
    logpri = log_prior(x)
    logl = torch.where(torch.isnan(logl), torch.full_like(logl, -torch.inf), logl)
    if copies == 1:
        return logpri, logl
    return logpri.repeat_interleave(copies, dim=0), logl.repeat_interleave(copies, dim=0)


def ladder_init(target, x, param_offset=None, param_scale=None, copies=1):
    """K6b: (logpri, logl), each (S * copies, 2, half) float64, of the
    ladder's starting states x (S, 2, half, ndim): set s of states fills
    the ``copies`` rows s * copies, ..., s * copies + copies - 1 (the
    ladder, whose rungs all start from one set, passes that set and its
    rung count; ``copies=1`` gives each of S rungs its own states). The
    likelihood is evaluated whatever the prior. The outputs are buffers of
    their own, row by row (the half-steps and swaps write them in place)."""
    if isinstance(copies, bool) or not isinstance(copies, numbers.Integral) or copies < 1:
        raise ValueError(f"copies must be a positive integer, got {copies!r}")
    copies = int(copies)
    if x.device.type == "cpu":
        return ladder_init_plain(*plain_functions(target, param_offset, param_scale), x, copies)
    lp, mod = _fused(target, "the ladder's initial state")
    if x.ndim != 4 or x.shape[1] != 2:
        raise ValueError(f"x must be (S, 2, half, ndim), got shape {tuple(x.shape)}")
    S, _, half, ndim = x.shape
    check(x, "x", tuple(x.shape), FLOATS, x.device)
    check_buffers(lp.log_likelihood, mod._BUFFERS, x.device)
    from .build import library
    lib = library()
    P = mod._kernel_params(lp, ndim, param_offset, param_scale)
    logpri = torch.empty((S * copies, 2, half), dtype=torch.float64, device=x.device)
    logl = torch.empty_like(logpri)
    device_index, stream = cuda_args(x.device)
    launch = getattr(lib, f"{mod.__name__.rsplit('.', 1)[-1]}_ladder_init_launch")
    rc = launch(ctypes.addressof(P), device_index,
                int(lp.log_likelihood.compute_dtype == torch.float64), x.data_ptr(),
                int(x.dtype == torch.float64), S * 2 * half, 2 * half, copies,
                logpri.data_ptr(), logl.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ladder_init_kernel launch failed: cudaError {rc}")
    LAUNCHES["ladder_init"] += 1
    return logpri, logl


# ----------------------------------------------------------------------- K6c

def swap_partners(n_rungs, parity):
    """Each rung's exchange partner (evidence.py:85-93): even parity pairs
    (0,1), (2,3), ...; odd parity (1,2), (3,4), ...; an unpaired edge rung
    partners itself."""
    idx = np.arange(n_rungs)
    p = np.where(idx == 0, 0, ((idx - 1) ^ 1) + 1) if parity else idx ^ 1
    return np.where(p >= n_rungs, idx, p)


def replica_swap_update(x, logpri, logl, betas, u, parity):
    """The plain replica exchange of one step (evidence.py:95-115): x (R, 2,
    half, ndim), logpri, logl and u (R, 2, half), betas (R,). Rung i takes
    its partner j's state when log u[min(i, j)] < (b_j - b_i)(ll_i - ll_j)
    and both log L are finite. Returns (x, logpri, logl, swapped)."""
    R = x.shape[0]
    idx = torch.arange(R, device=x.device)
    partner = torch.as_tensor(swap_partners(R, parity), device=x.device)
    x_p, pri_p, ll_p = x[partner], logpri[partner], logl[partner]
    log_acc = (betas[partner] - betas)[:, None, None] * (logl - ll_p)
    u_pair = u[torch.minimum(idx, partner)]
    acc = (torch.log(u_pair) < log_acc) & (partner != idx)[:, None, None]
    # never swap a logl = -inf state (possible only from a NaN-likelihood
    # start point): (b_j - b_i)(-inf) can give +inf and carry a zero-density
    # state into a beta > 0 rung
    acc = acc & torch.isfinite(logl) & torch.isfinite(ll_p)
    return (torch.where(acc[..., None], x_p, x), torch.where(acc, pri_p, logpri),
            torch.where(acc, ll_p, logl), acc)


def replica_swap_plain(x, logpri, logl, betas, u, parity, n_swap=None, logl_out=None,
                       cold_out=None):
    """Plain K6c with the kernel's in-place contract; ``n_swap`` counts the
    exchanges, ``logl_out`` (R, 2, half) and ``cold_out`` (2, half, ndim)
    receive the step's post-swap log L and last-rung states, when given."""
    x_new, pri_new, ll_new, acc = replica_swap_update(x, logpri, logl, betas, u, parity)
    x.copy_(x_new)
    logpri.copy_(pri_new)
    logl.copy_(ll_new)
    if n_swap is not None:
        n_swap += acc.to(n_swap.dtype)
    if logl_out is not None:
        logl_out.copy_(logl)
    if cold_out is not None:
        cold_out.copy_(x[-1])


def replica_swap(x, logpri, logl, betas, u, parity, n_swap=None, logl_out=None, cold_out=None):
    """K6c: the replica exchange of one step between neighbouring rungs, in
    place (model-free). x (R, 2, half, ndim), logpri, logl (R, 2, half)
    float64, betas (R,) float64, u (R, 2, half) uniforms in x's dtype,
    ``parity`` the step index's parity. A production step also passes
    n_swap (R, 2, half) int32, incremented for both rows of an exchange,
    logl_out (R, 2, half) float64 for the post-swap log L and, for parallel
    tempering, cold_out (2, half, ndim) in x's dtype for the last rung's
    post-swap states."""
    if x.device.type == "cpu":
        return replica_swap_plain(x, logpri, logl, betas, u, parity, n_swap, logl_out, cold_out)
    if x.device.type != "cuda":
        raise ValueError(f"K6c runs on CUDA (or its plain version on the CPU), not {x.device}")
    R, half, ndim = _ladder_checks(x, logpri, logl, betas)
    dev = x.device
    check(u, "u", (R, 2, half), (x.dtype,), dev)
    for name, t, shape, dts in (("n_swap", n_swap, (R, 2, half), (torch.int32,)),
                                ("logl_out", logl_out, (R, 2, half), (torch.float64,)),
                                ("cold_out", cold_out, (2, half, ndim), (x.dtype,))):
        if t is not None:
            check(t, name, shape, dts, dev)
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    rc = lib.replica_swap_launch(device_index, x.data_ptr(), int(x.dtype == torch.float64), ndim,
                                 logpri.data_ptr(), logl.data_ptr(), betas.data_ptr(), R,
                                 2 * half, u.data_ptr(), int(bool(parity)), _ptr(n_swap),
                                 _ptr(logl_out), _ptr(cold_out), stream)
    if rc != 0:
        raise RuntimeError(f"replica_swap_kernel launch failed: cudaError {rc}")
    LAUNCHES["replica_swap"] += 1


# ----------------------------------------------------------------------- K6d

def rung_block_terms_plain(logl_samples, dbetas, boundaries):
    """Plain K6d (evidence.py:473-503): t[b, k] = log mean exp(dbetas[k] *
    logl[s, k, :]) over the steps s of block b = [b0, b1) and every walker,
    float64, for the K = len(dbetas) lowest rungs of logl (nsteps, R, ...)."""
    K = dbetas.shape[0]
    ll = logl_samples.reshape(logl_samples.shape[0], logl_samples.shape[1], -1)
    w = dbetas[None, :, None] * ll[:, :K, :].to(torch.float64)
    outs = []
    for b0, b1 in boundaries:
        wb = w[b0:b1]
        m = torch.amax(wb, dim=(0, 2))
        outs.append(m + torch.log(torch.mean(torch.exp(wb - m[None, :, None]), dim=(0, 2))))
    return torch.stack(outs)


def k6d_splits(n_terms, min_items, n_sm):
    """K6d's CTAs a (block, rung) for ``n_terms`` blocks x rungs whose
    smallest block has ``min_items`` items, on a card of ``n_sm`` SMs:
    enough that the grid puts ~K6D_CTAS_PER_SM CTAs on every SM, none with
    less than one chunk of loads a thread, at most MAX_SPLITS (the last
    CTA's warp combines one split a lane), at least 1."""
    want = -(-K6D_CTAS_PER_SM * n_sm // n_terms)
    return max(1, min(want, min_items // K6D_SPLIT_ITEMS, MAX_SPLITS))


#: {(device index, stream handle): (counters int32, partials float64)} of
#: K6d's combine: the counters are zeroed when allocated, and each launch
#: leaves them zero; launches on one stream run one after another, so no two
#: launches share a buffer at once
_K6D_WORKSPACE = {}


def _k6d_workspace(index, stream, n_slots, splits):
    ctr, part = _K6D_WORKSPACE.get((index, stream), (None, None))
    dev = torch.device("cuda", index)
    if ctr is None or ctr.numel() < n_slots:
        ctr = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    if part is None or part.numel() < 2 * n_slots * splits:
        part = torch.empty(2 * n_slots * splits, dtype=torch.float64, device=dev)
    _K6D_WORKSPACE[(index, stream)] = (ctr, part)
    return ctr, part


def rung_block_terms(logl_samples, dbetas, boundaries):
    """K6d: the stepping-stone block terms (len(boundaries), K) float64 of
    the production log L ``logl_samples`` (nsteps, R, ...) float64, for the
    rungs k < K = len(dbetas) (dbetas a float64 tensor on the same device),
    over blocks of steps ``boundaries`` ((b0, b1), ...), at most 8. NaN where
    a block holds a NaN or +inf, or only -inf, as the plain version. Its
    CTAs combine through a buffer of the current stream's own."""
    dev = logl_samples.device
    if dev.type == "cpu":
        return rung_block_terms_plain(logl_samples, dbetas, boundaries)
    nb = len(boundaries)
    if not 0 < nb <= MAX_BLOCKS:
        raise ValueError(f"K6d takes 1 to {MAX_BLOCKS} blocks of steps, got {nb}")
    if dev.type != "cuda":
        raise ValueError(f"K6d runs on CUDA (or its plain version on the CPU), not {dev}")
    if logl_samples.ndim < 3:
        raise ValueError("logl_samples must be (nsteps, R, walkers...)")
    nsteps, R = logl_samples.shape[:2]
    ll = logl_samples.reshape(nsteps, R, -1)
    check(ll, "logl_samples", tuple(ll.shape), (torch.float64,), dev)
    K = dbetas.shape[0]
    check(dbetas, "dbetas", (K,), (torch.float64,), dev)
    W = ll.shape[2]
    if K > R:
        raise ValueError(f"K6d takes K <= R rungs, got K = {K} for R = {R}")
    if any(not 0 <= b0 < b1 <= nsteps for b0, b1 in boundaries):
        raise ValueError(f"blocks must be non-empty ranges of the {nsteps} steps")
    if max(b1 - b0 for b0, b1 in boundaries) * W >= 2 ** 31:
        raise ValueError("K6d takes fewer than 2^31 values a block")
    vec = W % 2 == 0 and ll.data_ptr() % 16 == 0
    from .gradient import sm_count
    splits = k6d_splits(nb * K, min(b1 - b0 for b0, b1 in boundaries) * (W // 2 if vec else W),
                        sm_count(dev))
    device_index, stream = cuda_args(dev)
    ctr, part = _k6d_workspace(device_index, stream, nb * K, splits)
    lo = (ctypes.c_longlong * nb)(*[int(b0) for b0, _ in boundaries])
    hi = (ctypes.c_longlong * nb)(*[int(b1) for _, b1 in boundaries])
    out = torch.empty((nb, K), dtype=torch.float64, device=dev)
    from .build import library
    lib = library()
    rc = lib.rung_block_terms_launch(device_index, ll.data_ptr(), R, W, dbetas.data_ptr(), K, nb,
                                     lo, hi, splits, int(vec), part.data_ptr(), ctr.data_ptr(),
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rung_block_terms_kernel launch failed: cudaError {rc}")
    LAUNCHES["rung_block_terms"] += 1
    return out
