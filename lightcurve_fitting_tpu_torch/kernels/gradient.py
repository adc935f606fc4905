"""Wrappers of the gradient samplers' transition kernels, with their plain
PyTorch versions beside them, and the rule that picks K7's form.

* :func:`nuts_transition` (K9, ``nuts_transition_kernel`` of
  ``csrc/gradient.cuh`` over ``SC2Model``): one multinomial NUTS transition
  of every chain, the whole loop over tree doublings in one launch;
* :func:`hmc_transition` (K7h, ``hmc_transition_kernel``): one
  jittered-length HMC trajectory and its Metropolis accept per chain.

Both run a block per chain, a warp per 32 points (ndim 4, or 5 with the
intrinsic scatter), and evaluate the block form of K7's device function,
whose bits are K7's, in the whitened space of a
:class:`~..parallel.hmc.WhitenedLogPosterior` (u = mean + L w, the bounds
bijection and its log-Jacobian, in the kernel). The chain states are
(C, ndim) float64; the draws are inputs; eps and inv_mass are device
tensors. For a tensor on the CPU each wrapper runs its plain version, which
also takes any sampler target with ``logp_and_grad``; for a CUDA tensor it
launches the kernel or raises: there is no fallback. Each launch adds one to
``LAUNCHES[name]``, and nothing else does. :func:`k7_form` is the rule by
which :func:`~.sc2.log_posterior_and_grad` runs K7 a block per row or a warp
per row.
"""

import ctypes

import numpy as np
import torch

from .common import LAUNCHES, MAX_DIM, check, check_buffers, cuda_args

__all__ = ["nuts_transition", "nuts_transition_plain", "nuts_scratch_len", "hmc_transition",
           "hmc_transition_plain", "white_params", "check_model", "check_target", "k7_form",
           "sm_count"]

MAX_DEPTH = 12   # what sc2_nuts_transition_launch accepts

#: K7 runs a block per row up to this many rows per SM, a warp per row above
#: (k7_form)
K7_BLOCK_ROWS_PER_SM = 4


def k7_form(W, n_sm):
    """K7's form for ``W`` rows on a card of ``n_sm`` SMs: ``"block"`` (a
    block per row, a point a thread: an evaluation's latency is one point's)
    where a warp per row, four rows a block, would leave most of the card's
    schedulers idle; ``"warp"`` (a warp per row, its lanes over the points in
    five rounds) where the rows fill the card. Both give the same bits."""
    return "block" if W <= K7_BLOCK_ROWS_PER_SM * n_sm else "warp"


def sm_count(device):
    """The number of SMs of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class _WhiteParams(ctypes.Structure):
    """ctypes mirror of ``struct WhiteParams`` (csrc/gradient.cuh)."""
    _fields_ = ([("ndim", ctypes.c_longlong), ("kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("lo", "hi", "width", "log_width", "mean")]
                + [("L", ctypes.c_double * (MAX_DIM * MAX_DIM))])


def white_params(target, ndim):
    """The kernel's block of the whitened space of WhitenedLogPosterior
    ``target``, cached on it."""
    cached = target.__dict__.get("_white_params")
    if cached is not None:
        return cached
    spec, w = target.bounds.kernel_spec(), target.white
    if len(spec) != ndim or w.L.shape != (ndim, ndim) or ndim > MAX_DIM:
        raise ValueError(f"the whitened space has {len(spec)} bounds and a {w.L.shape} "
                         f"factor; the kernels take ndim = {ndim} <= {MAX_DIM}")
    T = _WhiteParams()
    T.ndim = ndim
    for i, (kind, lo, hi, width) in enumerate(spec):
        T.kind[i], T.lo[i], T.hi[i], T.width[i] = kind, lo, hi, width
        T.log_width[i] = float(np.log(width))
        T.mean[i] = w.mean[i]
        for j in range(ndim):
            T.L[i * ndim + j] = w.L[i, j]
    target.__dict__["_white_params"] = T
    return T


def check_model(lp):
    """Raise NotImplementedError unless ``lp`` is a LogPosterior whose model
    has the gradient kernels: those of :mod:`.sc2` (``kernels.module_for``),
    ShockCooling2."""
    from . import module_for, sc2
    model = getattr(getattr(lp, "log_likelihood", None), "model", None)
    if model is None:
        raise NotImplementedError(
            "on CUDA the gradient kernels take a WhitenedLogPosterior over a LogPosterior "
            "(fitting.make_log_posterior); other log-probabilities run on the CPU")
    try:
        has_kernels = module_for(model) is sc2
    except NotImplementedError:
        has_kernels = False
    if not has_kernels:
        raise NotImplementedError(
            f"{type(model).__name__} has no gradient kernel yet: on CUDA the gradient path runs "
            "ShockCooling2 (K7 over the quadrature of ShockCooling3 is a later slice)")


def check_target(target):
    """Raise unless the transition kernels can run ``target``: a
    WhitenedLogPosterior over a LogPosterior of ShockCooling2."""
    check_model(getattr(target, "log_posterior", None))


def _launch_args(target, q, logp, eps, inv_mass):
    """Checks shared by K9 and K7h; returns (lib, P, T, device index, stream)."""
    from .build import library
    from .sc2 import _BUFFERS, _kernel_params
    check_target(target)
    C, ndim = q.shape
    dev = q.device
    check(q, "q", (C, ndim), (torch.float64,), dev)
    check(logp, "logp", (C,), (torch.float64,), dev)
    check(eps, "eps", (), (torch.float64,), dev)
    check(inv_mass, "inv_mass", (ndim,), (torch.float64,), dev)
    lp = target.log_posterior
    check_buffers(lp.log_likelihood, _BUFFERS, dev)
    lib = library()
    return (lib, _kernel_params(lp, ndim, None, None), white_params(target, ndim),
            lp.log_likelihood.compute_dtype == torch.float64, *cuda_args(dev))


def _output(out, like):
    if out is None:
        return torch.empty_like(like)
    check(out, "out", tuple(like.shape), (torch.float64,), like.device)
    return out


def _scratch_len(lib, P, f64, dev_index, max_depth, C):
    n = lib.sc2_block_scratch_len(ctypes.addressof(P), dev_index, int(f64), max_depth, C)
    if n < 0:
        raise RuntimeError(f"sc2_block_scratch_len failed: cudaError {-n}")
    return n


def scratch(lib, P, f64, dev_index, max_depth, C, device):
    """The float64 global scratch of a block-per-chain launch over ``C``
    chains or rows (K9 at ``max_depth`` >= 1, K7h and K7's block form at 0),
    allocated only where its workspace (and K9's trajectory buffer) do not
    fit in shared memory beside the points; else None."""
    n = _scratch_len(lib, P, f64, dev_index, max_depth, C)
    return torch.empty(n, dtype=torch.float64, device=device) if n else None


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ------------------------------------------------------------------------ K9

def nuts_scratch_len(target, C, max_depth, device):
    """The float64 scratch, in doubles, that K9 over ``C`` chains of
    WhitenedLogPosterior ``target`` on CUDA ``device`` takes for its
    trajectory buffer and its evaluations' workspace: 0 where both fit in
    shared memory beside the points (for the flagship at ndim 4 on an H100:
    up to max_depth 12 with float32 compute, up to 11 with float64)."""
    from .build import library
    from .sc2 import _kernel_params
    check_target(target)
    lp = target.log_posterior
    ndim = len(lp.priors)
    device = torch.device(device)
    return _scratch_len(library(), _kernel_params(lp, ndim, None, None),
                        lp.log_likelihood.compute_dtype == torch.float64, cuda_args(device)[0],
                        max_depth, C)


def nuts_transition_plain(target, q, logp, z, u, eps, inv_mass, max_depth, out=None):
    """Plain K9 (:func:`~..parallel.nuts.make_nuts_transition` over
    ``target.logp_and_grad_plain``): (q', logp', accept_stat, depth,
    diverged); q' is written into ``out`` when given."""
    from ..parallel.nuts import make_nuts_transition
    step = make_nuts_transition(target.logp_and_grad_plain, q.shape[1], max_depth)
    q_new, logp_new, astat, depth, div = step(q, logp, z, u, eps, inv_mass)
    if out is not None:
        out.copy_(q_new)
        q_new = out
    return q_new, logp_new, astat, depth, div


def nuts_transition(target, q, logp, z, u, eps, inv_mass, max_depth, out=None):
    """K9: one NUTS transition of the C chains ``q`` (C, ndim) float64 with
    log-posteriors ``logp`` (C,) of WhitenedLogPosterior ``target``; draws
    ``z`` (C, ndim) and ``u`` (C, max_depth, 2^(max_depth-1) + 2) float64;
    ``eps`` () and ``inv_mass`` (ndim,) float64 device tensors. Returns
    (q', logp', accept_stat (C,) float64, depth (C,) int32, diverged (C,)
    int32), q' written into ``out`` when given."""
    if q.device.type == "cpu":
        return nuts_transition_plain(target, q, logp, z, u, eps, inv_mass, max_depth, out)
    if q.device.type != "cuda":
        raise ValueError(f"K9 runs on CUDA (or its plain version on the CPU), not {q.device}")
    if q.ndim != 2 or not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"q must be (C, ndim) and 1 <= max_depth <= {MAX_DEPTH}")
    lib, P, T, f64, dev_index, stream = _launch_args(target, q, logp, eps, inv_mass)
    C, ndim = q.shape
    max_len = 2 ** (max_depth - 1)
    check(z, "z", (C, ndim), (torch.float64,), q.device)
    check(u, "u", (C, max_depth, max_len + 2), (torch.float64,), q.device)
    q_out = _output(out, q)
    logp_out = torch.empty_like(logp)
    astat = torch.empty_like(logp)
    depth = torch.empty(C, dtype=torch.int32, device=q.device)
    div = torch.empty_like(depth)
    buf = scratch(lib, P, f64, dev_index, max_depth, C, q.device)
    rc = lib.sc2_nuts_transition_launch(
        ctypes.addressof(P), dev_index, int(f64), ctypes.addressof(T), q.data_ptr(),
        logp.data_ptr(), z.data_ptr(), u.data_ptr(), eps.data_ptr(), inv_mass.data_ptr(),
        max_depth, C, q_out.data_ptr(), logp_out.data_ptr(), astat.data_ptr(), depth.data_ptr(),
        div.data_ptr(), _ptr(buf), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_transition_kernel launch failed: cudaError {rc}")
    LAUNCHES["nuts_transition"] += 1
    return q_out, logp_out, astat, depth, div


# ----------------------------------------------------------------------- K7h

def hmc_transition_plain(target, q, logp, z, u_acc, n_used, eps, inv_mass, n_leapfrog,
                         out=None):
    """Plain K7h (:func:`~..parallel.hmc.hmc_transition_plain` over
    ``target.logp_and_grad_plain``): (q', logp', accept_prob)."""
    from ..parallel.hmc import hmc_transition_plain as transition
    q_new, logp_new, aprob = transition(target.logp_and_grad_plain, q, logp, z, u_acc, n_used,
                                        eps, inv_mass, n_leapfrog)
    if out is not None:
        out.copy_(q_new)
        q_new = out
    return q_new, logp_new, aprob


def hmc_transition(target, q, logp, z, u_acc, n_used, eps, inv_mass, n_leapfrog, out=None):
    """K7h: one HMC transition of the C chains ``q`` (C, ndim) float64 of
    WhitenedLogPosterior ``target``: draws ``z`` (C, ndim), ``u_acc`` (C,)
    float64 and ``n_used`` (C,) int64 in [(n_leapfrog + 1) // 2,
    n_leapfrog]. Returns (q', logp', accept_prob), q' written into ``out``
    when given."""
    if q.device.type == "cpu":
        return hmc_transition_plain(target, q, logp, z, u_acc, n_used, eps, inv_mass,
                                    n_leapfrog, out)
    if q.device.type != "cuda":
        raise ValueError(f"K7h runs on CUDA (or its plain version on the CPU), not {q.device}")
    if q.ndim != 2:
        raise ValueError(f"q must be (C, ndim), got shape {tuple(q.shape)}")
    lib, P, T, f64, dev_index, stream = _launch_args(target, q, logp, eps, inv_mass)
    C, ndim = q.shape
    check(z, "z", (C, ndim), (torch.float64,), q.device)
    check(u_acc, "u_acc", (C,), (torch.float64,), q.device)
    check(n_used, "n_used", (C,), (torch.int64,), q.device)
    q_out = _output(out, q)
    logp_out = torch.empty_like(logp)
    aprob = torch.empty_like(logp)
    buf = scratch(lib, P, f64, dev_index, 0, C, q.device)
    rc = lib.sc2_hmc_transition_launch(
        ctypes.addressof(P), dev_index, int(f64), ctypes.addressof(T), q.data_ptr(),
        logp.data_ptr(), z.data_ptr(), u_acc.data_ptr(), n_used.data_ptr(), eps.data_ptr(),
        inv_mass.data_ptr(), C, q_out.data_ptr(), logp_out.data_ptr(), aprob.data_ptr(),
        _ptr(buf), stream)
    if rc != 0:
        raise RuntimeError(f"hmc_transition_kernel launch failed: cudaError {rc}")
    LAUNCHES["hmc_transition"] += 1
    return q_out, logp_out, aprob
