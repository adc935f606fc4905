"""Wrappers of the epoch blackbody kernels (``csrc/epoch_bb.cu``) of the
batched bolometric path.

* :func:`log_posterior` (K4): the per-epoch blackbody log-posterior of (E,
  M) parameter vectors, ndim 2 or 3, on the epoch half-step's warp form
  (``logpost_warp_kernel`` over ``EpochBBModel``, a warp per vector), so a
  walker's initial value has the bits the half-step stores; where the
  vectors are enough to hide the longest vector's walk the same bits a
  thread per vector (``epoch_logpost_thread_kernel``; :func:`k4_form`). With its analytic
  gradient (``epoch_logpost_kernel``, a thread per vector, ndim 2-9)
  :class:`EpochLogPosterior` is the autograd form the plain MAP polish
  differentiates through. Plain version ``EpochPosterior.plain``
  (``parallel/batched.py``).
* :func:`map_polish` (K4p, ``epoch_map_polish_kernel``): the Adam polish of
  the MAP centering, every epoch's starts for all its steps in one launch;
  plain version :func:`map_polish_plain`.
* :func:`stretch_half_step` (``stretch_half_step_kernel`` over
  ``EpochBBModel``, a warp per walker): one stretch-move half-step of E
  ensembles at once, in place; plain version :func:`stretch_half_step_plain`.
* :func:`summary_samples` (K4s, ``epoch_summary_kernel``): the (E, 4, S)
  posterior-summary rows T, R, (R T^2)^2 and the pseudobolometric
  trapezoid; plain version :func:`summary_samples_plain`.

Every wrapper runs its plain version for a CPU tensor; for a CUDA tensor it
launches its kernel or raises: there is no fallback. Each launch adds one
to ``LAUNCHES[name]`` (K4 with the gradient under ``epoch_logpost_grad``,
K4p under ``epoch_map_polish``), and nothing else does.
"""

import ctypes

import numpy as np
import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, check, cuda_args, fill_priors_and_affine,
                     half_update)

__all__ = ["log_posterior", "k4_form", "longest_terms", "EpochLogPosterior", "adam_table",
           "map_polish", "map_polish_plain", "stretch_half_step", "stretch_half_step_plain",
           "summary_samples", "summary_samples_plain"]

SUMMARY_STEP_CHUNK = 8   # steps per plain summary chunk: the (E, nw, F) cube stays small
POLISH_MAX_STARTS = 32   # POLISH_MAX_STARTS of csrc/epoch_bb.cu: K4p's result slots a block

#: K4's values run a thread per vector where the vectors an SM reach this
#: many for each term of the longest vector (its epoch's bands' nodes), a
#: warp per vector below (k4_form): the thread form's time at small widths
#: is the longest vector's walk, the warp form's grows with the vectors. On
#: the H100 the forms met at ~0.75 on both measured sets of epochs: the
#: bench's (286 terms) at ~55 x 512 vectors, SN 2016bkv's (416) at ~82 x
#: 512 (tools/time_port_kernels.py, K4_cross_E* and K4_cloud_E65; PERF.md).
K4_THREAD_VECTORS_PER_SM_TERM = 0.75


def k4_form(n_vectors, n_sm, max_terms):
    """The form of K4's values for ``n_vectors`` (E x M) on a card of
    ``n_sm`` SMs, where the longest vector sums ``max_terms`` Planck terms:
    ``"warp"`` (a warp per vector, the lanes over each band's terms) where
    a thread per vector would wait on its longest walk, ``"thread"`` (a
    thread per vector, the lanes' partial sums in its registers) where the
    vectors are enough to hide it. Both give the same bits."""
    return "thread" if n_vectors >= K4_THREAD_VECTORS_PER_SM_TERM * max_terms * n_sm \
        else "warp"


def longest_terms(ep):
    """The most Planck terms one vector of EpochPosterior ``ep`` sums (its
    epoch's real bands' node counts): read from the device once, cached on
    ``ep`` and keyed by its buffers' addresses."""
    key = (ep.n_native.data_ptr(), ep.mask.data_ptr())
    cached = ep.__dict__.get("_longest_terms")
    if cached is None or cached[0] != key:
        terms = (ep.n_native * ep.mask).sum(1)
        cached = (key, int(terms.max()) if terms.numel() else 0)
        ep.__dict__["_longest_terms"] = cached
    return cached[1]


class _EpochBBParams(ctypes.Structure):
    """ctypes mirror of ``struct EpochBBParams`` (csrc/epoch_bb.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("y", "inv_dy", "dy", "sigma_units", "nodes", "weights", "inv_yscale",
                  "log_norm", "n_native", "mask")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_epochs", "n_bands", "n_nodes", "ndim", "use_sigma", "has_affine",
                    "has_cutoff")]
                + [(n, ctypes.c_double) for n in ("cutoff", "c1", "c2")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")])


class _PolishParams(ctypes.Structure):
    """ctypes mirror of ``struct PolishParams`` (csrc/epoch_bb.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("u0", "sched", "centers", "alive", "u_out", "lp_out")]
                + [(n, ctypes.c_longlong) for n in ("n_starts", "n_iter")]
                + [(n, ctypes.c_double) for n in ("b1", "b2", "one_minus_b1", "one_minus_b2",
                                                  "eps")]
                + [("kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in ("lo", "hi", "width")])


class _SummaryParams(ctypes.Structure):
    """ctypes mirror of ``struct SummaryParams`` (csrc/epoch_bb.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("chain", "nu", "w", "out")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_epochs", "n_samples", "nwalkers", "ndim", "stride_step", "stride_e",
                    "n_freq", "has_cutoff")]
                + [(n, ctypes.c_double) for n in ("cutoff", "c1", "c2")])


_BUFFERS = ("y", "inv_dy", "dy", "sigma_units", "nodes", "weights", "inv_yscale", "log_norm",
            "n_native", "mask")


def _cutoff(P, cutoff_freq):
    from ..core.constants import c1, c2
    P.has_cutoff = int(np.isfinite(cutoff_freq))
    P.cutoff = float(cutoff_freq) if P.has_cutoff else 0.0
    P.c1, P.c2 = c1, c2


def _params(ep):
    """The parameter block of EpochPosterior ``ep``, cached on it and keyed
    by its buffers' addresses."""
    key = tuple(getattr(ep, n).data_ptr() for n in _BUFFERS)
    cached = ep.__dict__.get("_kernel_params")
    if cached is not None and cached[0] == key:
        return cached[1]
    ndim = len(ep.priors)
    if not 2 <= ndim <= MAX_DIM:
        raise ValueError(f"the epoch kernels take 2 to {MAX_DIM} parameters, got {ndim}")
    dev = ep.y.device
    for n in _BUFFERS:
        buf = getattr(ep, n)
        want = {"log_norm": torch.float64, "n_native": torch.int64,
                "mask": torch.bool}.get(n, ep.compute_dtype)
        if buf.device != dev or buf.dtype != want or not buf.is_contiguous():
            raise ValueError(f"epoch buffer {n} must be a contiguous {want} tensor on {dev}")
    P = _EpochBBParams()
    for n in _BUFFERS:
        setattr(P, n, getattr(ep, n).data_ptr())
    P.n_epochs, P.n_bands, P.n_nodes = ep.nodes.shape
    P.ndim, P.use_sigma, P.has_affine = ndim, int(ep.use_sigma), 0
    _cutoff(P, ep.cutoff_freq)
    fill_priors_and_affine(P, ep.priors, None)
    ep.__dict__["_kernel_params"] = (key, P)
    return P


def _require_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA (or its plain version on the CPU), "
                         f"not {t.device}")


# ------------------------------------------------------------------------ K4

def log_posterior(ep, q, with_grad=False):
    """K4: the log-posterior (E, M) float64 of EpochPosterior ``ep`` at
    absolute parameters ``q`` (E, M, ndim) float32/float64, ndim 2 or 3 (2-9
    with the gradient), and with ``with_grad`` its gradient (E, M, ndim)
    float64 (else None). A CPU tensor takes the plain version (its gradient
    by autograd)."""
    if q.device.type == "cpu":
        if not with_grad:
            return ep.plain(q), None
        p = q.detach().to(torch.float64).requires_grad_(True)
        lp = ep.plain(p)
        g, = torch.autograd.grad(lp.sum(), p)
        return lp.detach(), g
    if q.ndim != 3 or q.shape[0] != ep.n_epochs:
        raise ValueError(f"q must be (E={ep.n_epochs}, M, ndim), got {tuple(q.shape)}")
    E, M, ndim = q.shape
    if ndim != len(ep.priors):
        raise ValueError(f"q has {ndim} parameters for {len(ep.priors)} priors")
    if not with_grad and ndim not in (2, 3):
        raise ValueError(f"K4's values take 2 or 3 parameters (the epoch half-step's policy), "
                         f"got {ndim}")
    _require_cuda(q, "epoch log-posterior")
    check(q, "q", (E, M, ndim), FLOATS, q.device)
    from .gradient import sm_count
    form = None if with_grad else k4_form(E * M, sm_count(q.device), longest_terms(ep))
    return _launch_k4(ep, q, with_grad, form)


def _launch_k4(ep, q, with_grad, form):
    """One K4 launch on checked CUDA ``q``: with the gradient, or the values
    in ``form`` ("warp" or "thread", :func:`k4_form`)."""
    E, M, ndim = q.shape
    P = _params(ep)
    out = torch.empty((E, M), dtype=torch.float64, device=q.device)
    grad = torch.empty((E, M, ndim), dtype=torch.float64, device=q.device) if with_grad else None
    from .build import library
    lib = library()
    dev, stream = cuda_args(q.device)
    rc = lib.epoch_logpost_launch(ctypes.addressof(P), dev,
                                  int(ep.compute_dtype == torch.float64), q.data_ptr(),
                                  int(q.dtype == torch.float64), M, out.data_ptr(),
                                  int(with_grad), None if grad is None else grad.data_ptr(),
                                  int(form == "thread"), stream)
    if rc != 0:
        what = "epoch_logpost_kernel" if with_grad else f"K4's {form} form"
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    LAUNCHES["epoch_logpost_grad" if with_grad else "epoch_logpost"] += 1
    return out, grad


class EpochLogPosterior(torch.autograd.Function):
    """K4 as an autograd function of the absolute parameters p (E, M, ndim)
    float64: the forward launches the kernel with its gradient, the backward
    scales that saved gradient by the incoming one."""

    @staticmethod
    def forward(ctx, p, ep):
        lp, grad = log_posterior(ep, p.detach().contiguous(), with_grad=True)
        ctx.save_for_backward(grad)
        return lp

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return g[..., None] * grad, None


# ----------------------------------------------------------------------- K4p

def adam_table(n_iter, lr, alpha):
    """The host scalars of ``n_iter`` steps of ``CosineAdam(lr, n_iter,
    alpha)`` (``CosineAdam.scalars``): (n_iter, 3) float64 rows of the
    learning rate, 1 - b1^(t + 1) and 1 - b2^(t + 1), which K4p reads in
    place of the device's cos and pow."""
    from ..parallel.optimize import CosineAdam
    opt = CosineAdam(torch.zeros(0), lr=lr, n_iter=n_iter, alpha=alpha)
    return np.array([opt.scalars(t) for t in range(n_iter)], dtype=np.float64).reshape(-1, 3)


_ADAM_TABLES = {}


def _adam_table_on(device, n_iter, lr, alpha):
    key = (str(device), n_iter, float(lr), float(alpha))
    if key not in _ADAM_TABLES:
        _ADAM_TABLES[key] = torch.as_tensor(adam_table(n_iter, lr, alpha), device=device)
    return _ADAM_TABLES[key]


def map_polish_plain(ep, u0, bounds, n_iter=300, lr=0.05, alpha=0.01, return_starts=False):
    """Plain PyTorch K4p: ``n_iter`` CosineAdam steps of every start ``u0``
    (E, S, ndim) float64 in the unbounded space of BoundsTransform
    ``bounds`` down -log p(to_bounded(u)), gradients by autograd
    through ``ep.differentiable`` (K4's gradient on CUDA), non-finite
    components zeroed; then each epoch's start of the least final -log p
    (non-finite: +inf; the first of equals). Returns (centers (E, ndim)
    float64, alive (E,) bool: that start's log-posterior is finite), and
    with ``return_starts`` also the last iterates (E, S, ndim) and their
    log-posteriors (E, S)."""
    from ..parallel.optimize import CosineAdam
    u = u0
    opt = CosineAdam(u, lr=lr, n_iter=n_iter, alpha=alpha)
    for _ in range(n_iter):
        u_g = u.detach().requires_grad_(True)
        neg = -ep.differentiable(bounds.to_bounded(u_g))
        g, = torch.autograd.grad(neg.sum(), u_g)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        u = opt.step(u, g)
    lp = ep(bounds.to_bounded(u))
    neg_fin = -lp
    neg_fin = torch.where(torch.isfinite(neg_fin), neg_fin, torch.full_like(neg_fin, torch.inf))
    best = torch.argmin(neg_fin, dim=1)
    rows = torch.arange(u.shape[0], device=u.device)
    out = bounds.to_bounded(u[rows, best]), torch.isfinite(neg_fin[rows, best])
    return out + (u, lp) if return_starts else out


def map_polish(ep, u0, bounds, n_iter=300, lr=0.05, alpha=0.01, return_starts=False):
    """K4p: the Adam polish of EpochPosterior ``ep``'s starts ``u0`` (E, S,
    ndim) float64, S <= 32, ndim 2 or 3, in one launch (arguments and
    result: :func:`map_polish_plain`). A CPU tensor takes the plain
    version."""
    if u0.device.type == "cpu":
        return map_polish_plain(ep, u0, bounds, n_iter, lr, alpha, return_starts)
    if u0.ndim != 3 or u0.shape[0] != ep.n_epochs:
        raise ValueError(f"u0 must be (E={ep.n_epochs}, n_starts, ndim), got {tuple(u0.shape)}")
    E, S, ndim = u0.shape
    if not 1 <= S <= POLISH_MAX_STARTS:
        raise ValueError(f"the polish kernel takes 1 to {POLISH_MAX_STARTS} starts an epoch, "
                         f"got {S}")
    if ndim not in (2, 3) or ndim != len(ep.priors) or len(bounds.lower) != ndim:
        raise ValueError(f"the polish kernel takes 2 or 3 parameters, as many as the priors "
                         f"and the bounds; got {ndim}")
    _require_cuda(u0, "MAP polish")
    dev = u0.device
    check(u0, "u0", (E, S, ndim), (torch.float64,), dev)
    P = _params(ep)
    centers = torch.empty((E, ndim), dtype=torch.float64, device=dev)
    alive = torch.empty(E, dtype=torch.bool, device=dev)
    u_out = torch.empty_like(u0) if return_starts else None
    lp_out = torch.empty((E, S), dtype=torch.float64, device=dev) if return_starts else None
    sched = _adam_table_on(dev, n_iter, lr, alpha)
    from ..parallel.optimize import B1, B2, EPS
    Q = _PolishParams()
    Q.u0, Q.sched, Q.centers, Q.alive = (u0.data_ptr(), sched.data_ptr(), centers.data_ptr(),
                                         alive.data_ptr())
    Q.u_out = None if u_out is None else u_out.data_ptr()
    Q.lp_out = None if lp_out is None else lp_out.data_ptr()
    Q.n_starts, Q.n_iter = S, n_iter
    Q.b1, Q.b2, Q.one_minus_b1, Q.one_minus_b2, Q.eps = B1, B2, 1 - B1, 1 - B2, EPS
    for i, (kind, lo, hi, width) in enumerate(bounds.kernel_spec()):
        Q.kind[i], Q.lo[i], Q.hi[i], Q.width[i] = kind, lo, hi, width
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    rc = lib.epoch_map_polish_launch(ctypes.addressof(P), ctypes.addressof(Q), device_index,
                                     int(ep.compute_dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"epoch_map_polish_kernel launch failed: cudaError {rc}")
    LAUNCHES["epoch_map_polish"] += 1
    return (centers, alive, u_out, lp_out) if return_starts else (centers, alive)


# ----------------------------------------------------------- epoch half-step

def stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a=2.0, chain_x=None,
                            chain_logp=None, n_accept=None):
    """Plain PyTorch epoch half-step, the kernel's in-place contract over E
    ensembles: half ``h`` of ``x`` (E, 2, half, ndim) and ``logp`` (E, 2,
    half) is updated from the draws ``u_z``, ``j``, ``u_acc`` (E, 2, half)
    (their half ``h``), each epoch's partner drawn from its own other half;
    ``log_prob`` maps (E, half, ndim) states to (E, half)."""
    x_new, lp_new, acc = half_update(log_prob, x[:, h], x[:, 1 - h], logp[:, h], u_z[:, h],
                                     j[:, h], u_acc[:, h], a)
    x[:, h] = x_new
    logp[:, h] = lp_new
    if n_accept is not None:
        n_accept[:, h] += acc.to(n_accept.dtype)
    if chain_x is not None:
        chain_x[:, h] = x_new.to(chain_x.dtype)
        chain_logp[:, h] = lp_new.to(chain_logp.dtype)


def stretch_half_step(ep, x, logp, h, u_z, j, u_acc, a=2.0, chain_x=None, chain_logp=None,
                      n_accept=None, check_partners=True):
    """One stretch-move half-step of every epoch's ensemble under
    EpochPosterior ``ep``, in place (arguments: :func:`stretch_half_step_plain`;
    the chain slot is (E, 2, half, ndim) / (E, 2, half))."""
    if x.device.type == "cpu":
        return stretch_half_step_plain(ep.plain, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    _require_cuda(x, "epoch half-step")
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[0] != ep.n_epochs:
        raise ValueError(f"x must be (E={ep.n_epochs}, 2, half, ndim), got {tuple(x.shape)}")
    if h not in (0, 1):
        raise ValueError("h must be 0 or 1")
    if (chain_x is None) != (chain_logp is None) or n_accept is None:
        raise ValueError("the half-step kernel needs n_accept, and chain_x with chain_logp "
                         "or neither")
    E, _, half, ndim = x.shape
    dev = x.device
    check(x, "x", (E, 2, half, ndim), FLOATS, dev)
    check(logp, "logp", (E, 2, half), (torch.float64,), dev)
    check(u_z, "u_z", (E, 2, half), (x.dtype,), dev)
    check(u_acc, "u_acc", (E, 2, half), (x.dtype,), dev)
    check(j, "j", (E, 2, half), (torch.int64,), dev)
    check(n_accept, "n_accept", (E, 2, half), (torch.int32,), dev)
    if check_partners and bool(((j < 0) | (j >= half)).any()):
        raise ValueError(f"partner indices j must lie in [0, {half})")
    if chain_x is not None:
        check(chain_x, "chain_x", (E, 2, half, ndim), FLOATS, dev)
        check(chain_logp, "chain_logp", (E, 2, half), FLOATS, dev)
    if ndim != len(ep.priors) or ndim not in (2, 3):
        raise ValueError(f"the epoch half-step kernel takes 2 or 3 parameters, as many as the "
                         f"priors; x has {ndim} for {len(ep.priors)} priors")
    P = _params(ep)
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    off = h * half   # the draws of half h; ensemble e's start 2 * half later
    rc = lib.epoch_half_step_launch(
        ctypes.addressof(P), device_index, int(ep.compute_dtype == torch.float64),
        x.data_ptr(), int(x.dtype == torch.float64), logp.data_ptr(), half, int(h),
        u_z.data_ptr() + off * u_z.element_size(), j.data_ptr() + off * j.element_size(),
        u_acc.data_ptr() + off * u_acc.element_size(), float(a),
        None if chain_x is None else chain_x.data_ptr(),
        int(chain_x is not None and chain_x.dtype == torch.float64),
        None if chain_logp is None else chain_logp.data_ptr(),
        int(chain_logp is not None and chain_logp.dtype == torch.float64),
        n_accept.data_ptr(), E, 2 * half, stream)
    if rc != 0:
        raise RuntimeError(f"stretch_half_step_kernel (epochs) launch failed: cudaError {rc}")
    LAUNCHES["epoch_half_step"] += 1


# ----------------------------------------------------------------------- K4s

def summary_samples_plain(chain, nu_emit, trap_w, cutoff_freq, dt):
    """Plain PyTorch K4s. ``chain`` (steps, E, nwalkers, ndim) holds the
    production samples (sample s = step * nwalkers + walker); returns
    (E, 4, S) rows T, R, (R T^2)^2 (float64 arithmetic) and the trapezoid
    sum over ``nu_emit`` of L_nu(nu; T, R) weighted by ``trap_w``, in the
    compute dtype ``dt`` (None: float64); the rows are in the compute
    dtype."""
    from ..models.blackbody import planck_lnu
    steps, E, nw, _ = chain.shape
    dtc = dt if dt is not None else torch.float64
    nu_c, w_c = nu_emit.to(dtc), trap_w.to(dtc)
    T, R = chain[..., 0], chain[..., 1]                        # (steps, E, nw)
    s = torch.cat([torch.sum(w_c * planck_lnu(nu_c, Tc.to(dtc)[..., None],
                                              Rc.to(dtc)[..., None], cutoff_freq), dim=-1)
                   for Tc, Rc in zip(T.split(SUMMARY_STEP_CHUNK), R.split(SUMMARY_STEP_CHUNK))])
    T64, R64 = T.to(torch.float64), R.to(torch.float64)
    v = R64 * T64 * T64
    rows = torch.stack([T64, R64, v * v, s.to(torch.float64)])   # (4, steps, E, nw)
    return rows.permute(2, 0, 1, 3).reshape(E, 4, steps * nw).to(dtc)


def summary_samples(chain, nu_emit, trap_w, cutoff_freq, dt):
    """K4s on CUDA tensors (arguments: :func:`summary_samples_plain`); a CPU
    chain takes the plain version."""
    if chain.device.type == "cpu":
        return summary_samples_plain(chain, nu_emit, trap_w, cutoff_freq, dt)
    _require_cuda(chain, "epoch summary")
    if chain.ndim != 4 or chain.shape[-1] < 2:
        raise ValueError(f"chain must be (steps, E, nwalkers, ndim >= 2), got "
                         f"{tuple(chain.shape)}")
    steps, E, nw, ndim = chain.shape
    dev = chain.device
    check(chain, "chain", chain.shape, FLOATS, dev)
    dtc = dt if dt is not None else torch.float64
    nu_c = nu_emit.to(device=dev, dtype=dtc).contiguous()
    w_c = trap_w.to(device=dev, dtype=dtc).contiguous()
    if nu_c.ndim != 1 or w_c.shape != nu_c.shape:
        raise ValueError("nu_emit and trap_w must be one (F,) grid")
    out = torch.empty((E, 4, steps * nw), dtype=dtc, device=dev)
    P = _SummaryParams()
    P.chain, P.nu, P.w, P.out = chain.data_ptr(), nu_c.data_ptr(), w_c.data_ptr(), out.data_ptr()
    P.n_epochs, P.n_samples, P.nwalkers, P.ndim = E, steps * nw, nw, ndim
    P.stride_step, P.stride_e, P.n_freq = E * nw * ndim, nw * ndim, nu_c.shape[0]
    _cutoff(P, cutoff_freq)
    from .build import library
    lib = library()
    device_index, stream = cuda_args(dev)
    rc = lib.epoch_summary_launch(ctypes.addressof(P), device_index,
                                  int(dtc == torch.float64), int(chain.dtype == torch.float64),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"epoch_summary_kernel launch failed: cudaError {rc}")
    LAUNCHES["epoch_summary"] += 1
    return out
