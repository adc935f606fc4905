"""Wrappers of the per-transient kernels of the population fit, with their
plain PyTorch versions beside them: over ShockCooling2 P1-P3
(``csrc/population.cu``), over ShockCooling and ShockCooling4 P1 and P2
(``csrc/pop_sc.cu``: ``PopSCWarpModel`` and ``PopSC4WarpModel``, the point
of the single fits' SW17 and MSW23 kernels, ``csrc/sc_model.cuh``).

Each takes a :class:`~..parallel.population.PopulationPosterior` ``pp`` (the
packed transients in the compute dtype, and their plain log-posterior):

* :func:`log_posterior` (P1): the log-posterior of every transient's
  walkers, (S, W, ndim) -> (S, W), transient e along the ensemble axis, in
  the form :func:`logpost_form` picks: ``"latency"``
  (``logpost_latency_kernel`` over ``PopSC2WarpModel``: a block per walker,
  a point a thread) or ``"warp"`` (``logpost_warp_kernel``: a warp per
  walker), the bits that P2 stores when it accepts a state in either;
* :func:`stretch_half_step` (P2): one Goodman-Weare half-step of all S
  ensembles in one launch, in place, from the draws (S, 2, half) of the
  step, in the form :func:`half_form` picks: ``"latency"``
  (``stretch_half_step_latency_kernel`` over ``PopSC2WarpModel``: a block
  per walker, a point a thread) or ``"warp"`` (``stretch_half_step_kernel``:
  a warp per walker), the same bits;
* :func:`map_ascent` (P3, ``pop_map_kernel``): the whole Adam ascent of
  every transient's posterior from its starts in one launch (blocks of four
  warps over a transient's starts, a start a warp or, in the form
  :func:`map_form` picks, two: ``"warp"`` or ``"pair"``, the same bits), and
  the final negative log-posteriors.

For a tensor on the CPU each wrapper runs its plain version. For a CUDA
tensor it launches the kernel or raises: there is no fallback; a class
without kernels raises NotImplementedError (ROADMAP Queue 1 item 10), and
so does P3 over ShockCooling and ShockCooling4 (item 22). Each launch adds
one to ``LAUNCHES[name]`` (over ShockCooling2 ``pop_logpost``,
``pop_half_step``, ``pop_map``; over ShockCooling ``pop_sc_logpost``,
``pop_sc_half_step``; over ShockCooling4 ``pop_sc4_logpost``,
``pop_sc4_half_step``) and one under its form's name (the name and
``_warp``, ``_latency`` or, for P3, ``_pair``), and nothing else does.
"""

import ctypes

import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, absolute_params, affine_key, check, cuda_args,
                     fill_priors_and_affine)
from .epoch_bb import _adam_table_on, stretch_half_step_plain

__all__ = ["log_posterior", "log_posterior_plain", "stretch_half_step",
           "stretch_half_step_plain", "map_ascent", "map_ascent_plain", "logpost_form",
           "half_form", "map_form"]

#: P1 runs its latency form while the launch has at most this many walkers
#: (blocks) an SM (:func:`logpost_form`; on the H100 it led at 3.9 walkers an
#: SM with 42 points and at 0.5-4.4 with 143-144, tied at 7.8 with 42 and
#: lost at 7.8 with 143 and from 15.5 with either: PERF.md §6)
LOGPOST_LATENCY_WALKERS_PER_SM = 6
#: P1's latency form takes a transient's points one a thread over at most
#: eight warps (LP_LAT_LP_ENS_WARPS of csrc/stretch.cuh; a test ties the two)
LOGPOST_LATENCY_MAX_POINTS = 256

#: P2 runs its latency form while the launch's walkers, ceil(N / 32) warps
#: each, need at most this many warps an SM (:func:`half_form`; on the H100
#: it led at 8 warps an SM, tied at 15.5 with 42 points and led at 15.5 with
#: 126, lost from 31: PERF.md §6)
HALF_LATENCY_WARPS_PER_SM = 16
#: the latency form takes a transient's points one a thread over at most
#: four warps (LP_LAT_ENS_WARPS of csrc/stretch.cuh; a test ties the two)
HALF_LATENCY_MAX_POINTS = 128
#: P3 runs its pair form (two warps a start) while the launch's starts, two
#: warps each, need at most this many warps an SM (:func:`map_form`; on the
#: H100 it led through 15.5, lost from 23: PERF.md §6)
MAP_PAIR_WARPS_PER_SM = 16
#: the pair form takes a transient's points one a thread over two warps
#: (POP_MAP_PAIR_MAX_POINTS of csrc/population.cu; a test ties the two)
MAP_PAIR_MAX_POINTS = 64


class _PopParams(ctypes.Structure):
    """ctypes mirror of ``struct PopParams`` (csrc/population.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "y", "inv_dy", "dy", "sigma_units", "s_a", "s_b", "coef", "n_real",
                  "t_ref", "inv_yscale", "log_norm")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_coef", "ndim", "n_model", "use_sigma", "has_affine")]
                + [(n, ctypes.c_double) for n in ("eps_T", "eps_L", "a_model", "alpha", "c3_42")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")]
                + [("model", ctypes.c_longlong)]
                + [(n, ctypes.c_double) for n in
                   ("kappa", "A", "eps1", "eps2", "L0_42", "T0", "tph_to_tcol", "L_br_0_42",
                    "T_col_br_0", "t_br_0", "t_tr_0", "kappa_L", "kappa_T", "k_B")])


#: a population's kernel family -> (the model field of PopParams, the C
#: entry points' prefix, the LAUNCHES prefix)
_FAMILIES = {"sc2": (0, "pop", "pop"), "sc": (1, "pop_sc", "pop_sc"),
             "sc4": (2, "pop_sc", "pop_sc4")}


class _PopMapParams(ctypes.Structure):
    """ctypes mirror of ``struct PopMapParams`` (csrc/population.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("u0", "sched", "u_out", "neg_out")]
                + [(n, ctypes.c_longlong) for n in ("n_starts", "n_iter")]
                + [(n, ctypes.c_double) for n in ("b1", "b2", "one_minus_b1", "one_minus_b2",
                                                  "eps")]
                + [("kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in ("lo", "hi", "width")])


_BUFFERS = ("t_centered", "y", "inv_dy", "dy", "sigma_units", "bb_s_a", "bb_s_b", "bb_coeffs",
            "n_real", "t_ref", "inv_yscale", "log_norm")


def _require_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA (or its plain version on the CPU), "
                         f"not {t.device}")


def _family(pp):
    """``pp``'s kernel family, NotImplementedError for a class without
    kernels."""
    if pp.family is None:
        raise NotImplementedError(
            f"a {type(pp.model).__name__} population has no kernels yet (ROADMAP Queue 1 item "
            '10): run it with device="cpu"')
    return pp.family


def _params(pp, ndim, offset, scale):
    """The kernels' parameter block of PopulationPosterior ``pp``, cached on
    it by (ndim, the affine map)."""
    from ..core.constants import c3_42, k_B
    from .sc import _CONSTANTS
    family = _family(pp)
    key = (ndim, affine_key(offset, scale))
    if key in pp.kernel_params:
        return pp.kernel_params[key]
    if ndim != len(pp.priors) or ndim != pp.n_model + int(pp.use_sigma) or ndim > MAX_DIM:
        raise ValueError(f"the population kernels take ndim = {pp.n_model} (+1 with use_sigma) "
                         f"matching the priors; got ndim={ndim} for {len(pp.priors)} priors")
    for name in _BUFFERS:
        buf = getattr(pp, name)
        if not buf.is_contiguous() or buf.device != pp.device:
            raise ValueError(f"population buffer {name} must be contiguous on {pp.device}")
    consts = pp.model.kernel_constants()
    P = _PopParams()
    (P.t_centered, P.y, P.inv_dy, P.dy, P.sigma_units, P.s_a, P.s_b, P.coef, P.n_real, P.t_ref,
     P.inv_yscale, P.log_norm) = (getattr(pp, name).data_ptr() for name in _BUFFERS)
    P.n_points, P.n_coef = pp.bb_coeffs.shape[1:]
    P.ndim, P.n_model, P.use_sigma = ndim, pp.n_model, int(pp.use_sigma)
    P.model = _FAMILIES[family][0]
    if family == "sc2":
        P.eps_T, P.eps_L = consts["eps_T"], consts["eps_L"]
    else:
        for name, field in _CONSTANTS[family].items():
            setattr(P, field, consts[name])
        P.kappa_L, P.kappa_T = consts["kappa"] ** -0.89, consts["kappa"] ** -0.22
        P.k_B = k_B
    P.a_model, P.alpha, P.c3_42 = consts["a"], consts["alpha"], c3_42
    fill_priors_and_affine(P, pp.priors, key[1])
    pp.kernel_params[key] = P
    return P


def _f64(pp):
    return int(pp.compute_dtype == torch.float64)


def _check_form(what, form, forms):
    if form not in (None,) + forms:
        raise ValueError(f"the population {what}'s form is one of {forms}, not {form!r}")


def _sm_count(device):
    from .gradient import sm_count
    return sm_count(device)


def logpost_form(n_transients, W, n_points, n_sm):
    """P1's form for ``n_transients`` x ``W`` walkers over rows of
    ``n_points`` (padded) points on a card of ``n_sm`` SMs: ``"latency"``
    (a block of ceil(n_points / 32) warps per walker, a point a thread: one
    walker's chain, where a small launch leaves the card idle, as 28c's and
    the exact-refit CV's few transients do) up to LOGPOST_LATENCY_MAX_POINTS
    points while the walkers number at most LOGPOST_LATENCY_WALKERS_PER_SM
    an SM, else ``"warp"`` (a warp per walker; the example's 64 and 512
    transients). The walkers, not the warps, set the crossover: a block's
    warps form their points side by side. Both give the same bits."""
    if n_points > LOGPOST_LATENCY_MAX_POINTS:
        return "warp"
    return "latency" if n_transients * W <= LOGPOST_LATENCY_WALKERS_PER_SM * n_sm else "warp"


def half_form(n_transients, half, n_points, n_sm):
    """P2's form for ``n_transients`` ensembles of ``half`` walkers a half
    over rows of ``n_points`` (padded) points on a card of ``n_sm`` SMs:
    ``"latency"`` (a block of ceil(n_points / 32) warps per walker, a point a
    thread, no staging: one walker's chain, where a small launch leaves the
    card idle) up to HALF_LATENCY_MAX_POINTS points while its warps need at
    most HALF_LATENCY_WARPS_PER_SM an SM, else ``"warp"`` (a warp per walker,
    each block staging its transient's rows; the example's 64 and 512
    transients). Both store the same bits."""
    if n_points > HALF_LATENCY_MAX_POINTS:
        return "warp"
    warps = n_transients * half * -(-n_points // 32)
    return "latency" if warps <= HALF_LATENCY_WARPS_PER_SM * n_sm else "warp"


def map_form(n_transients, n_starts, n_points, n_sm):
    """P3's form for ``n_transients`` x ``n_starts`` ascents over rows of
    ``n_points`` (padded) points on a card of ``n_sm`` SMs: ``"pair"`` (two
    warps a start, a point a thread: half the chain of the points a lane
    walks in turn) up to MAP_PAIR_MAX_POINTS points while its warps need at
    most MAP_PAIR_WARPS_PER_SM an SM, else ``"warp"`` (a warp a start, lane l
    on points l, l + 32, ...: half the warps, where the card is full). Both
    give the same bits."""
    if n_points > MAP_PAIR_MAX_POINTS:
        return "warp"
    return "pair" if 2 * n_transients * n_starts <= MAP_PAIR_WARPS_PER_SM * n_sm else "warp"


# ------------------------------------------------------------------------ P1

def log_posterior_plain(pp, q, param_offset=None, param_scale=None):
    """Plain P1: ``pp``'s log-posterior (S, W) float64 at the walker states
    ``q`` (S, W, ndim), affine-mapped to absolute float64 parameters when
    ``param_offset``/``param_scale`` are given."""
    return pp.plain(absolute_params(q, param_offset, param_scale))


def log_posterior(pp, q, param_offset=None, param_scale=None, form=None):
    """P1: the log-posterior (S, W) float64 of every transient's walker
    states ``q`` (S, W, ndim) float32/float64 (arguments:
    :func:`log_posterior_plain`; ``form``: ``"latency"``, ``"warp"`` or
    None, :func:`logpost_form`'s pick). A CPU tensor takes the plain
    version."""
    _check_form("log-posterior", form, ("warp", "latency"))
    if q.device.type == "cpu":
        return log_posterior_plain(pp, q, param_offset, param_scale)
    _require_cuda(q, "population log-posterior")
    if q.ndim != 3 or q.shape[0] != pp.n_transients:
        raise ValueError(f"q must be (S={pp.n_transients}, W, ndim), got {tuple(q.shape)}")
    S, W, ndim = q.shape
    check(q, "q", (S, W, ndim), FLOATS, pp.device)
    P = _params(pp, ndim, param_offset, param_scale)
    if form is None:
        form = logpost_form(S, W, P.n_points, _sm_count(q.device))
    out = torch.empty((S, W), dtype=torch.float64, device=q.device)
    from .build import library
    dev, stream = cuda_args(q.device)
    _, entry, count = _FAMILIES[pp.family]
    rc = getattr(library(), f"{entry}_logpost_launch")(
        ctypes.addressof(P), dev, _f64(pp), q.data_ptr(), int(q.dtype == torch.float64), W, S,
        out.data_ptr(), int(form == "latency"), stream)
    if rc != 0:
        raise RuntimeError(f"the population log-posterior ({pp.family}, {form} form) launch "
                           f"failed: cudaError {rc}")
    LAUNCHES[f"{count}_logpost"] += 1
    LAUNCHES[f"{count}_logpost_{form}"] += 1
    return out


# ------------------------------------------------------------------------ P2

def stretch_half_step(pp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None, param_scale=None,
                      chain_x=None, chain_logp=None, n_accept=None, check_partners=True,
                      form=None):
    """P2: one stretch-move half-step of every transient's ensemble under
    ``pp``, in place (arguments: :func:`stretch_half_step_plain`, the plain
    half-step over ensembles that the epochs' half-step shares; the state
    affine-rescaled when ``param_offset``/``param_scale`` are given; the
    chain slot ``chain_x`` in the state's dtype, ``chain_logp`` float64).
    ``check_partners`` verifies 0 <= j < half before the launch (it
    synchronizes with the device; the fit, whose partners come from
    ``randint(0, half)``, turns it off). ``form``: ``"latency"``, ``"warp"``
    or None (:func:`half_form`'s pick). A CPU tensor takes the plain
    version."""
    _check_form("half-step", form, ("warp", "latency"))
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior_plain(pp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    _require_cuda(x, "population half-step")
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[0] != pp.n_transients:
        raise ValueError(f"x must be (S={pp.n_transients}, 2, half, ndim), got "
                         f"{tuple(x.shape)}")
    if h not in (0, 1):
        raise ValueError("h must be 0 or 1")
    if (chain_x is None) != (chain_logp is None) or n_accept is None:
        raise ValueError("the half-step kernel needs n_accept, and chain_x with chain_logp "
                         "or neither")
    S, _, half, ndim = x.shape
    dev = x.device
    check(x, "x", (S, 2, half, ndim), FLOATS, dev)
    check(logp, "logp", (S, 2, half), (torch.float64,), dev)
    check(u_z, "u_z", (S, 2, half), (x.dtype,), dev)
    check(u_acc, "u_acc", (S, 2, half), (x.dtype,), dev)
    check(j, "j", (S, 2, half), (torch.int64,), dev)
    check(n_accept, "n_accept", (S, 2, half), (torch.int32,), dev)
    if check_partners and bool(((j < 0) | (j >= half)).any()):
        raise ValueError(f"partner indices j must lie in [0, {half})")
    if chain_x is not None:
        check(chain_x, "chain_x", (S, 2, half, ndim), (x.dtype,), dev)
        check(chain_logp, "chain_logp", (S, 2, half), (torch.float64,), dev)
    P = _params(pp, ndim, param_offset, param_scale)
    if form is None:
        form = half_form(S, half, P.n_points, _sm_count(dev))
    from .build import library
    device_index, stream = cuda_args(dev)
    off = h * half   # the draws of half h; transient e's start 2 * half later
    _, entry, count = _FAMILIES[pp.family]
    rc = getattr(library(), f"{entry}_half_step_launch")(
        ctypes.addressof(P), device_index, _f64(pp), x.data_ptr(), int(x.dtype == torch.float64),
        logp.data_ptr(), half, int(h), u_z.data_ptr() + off * u_z.element_size(),
        j.data_ptr() + off * j.element_size(), u_acc.data_ptr() + off * u_acc.element_size(),
        float(a), None if chain_x is None else chain_x.data_ptr(),
        None if chain_logp is None else chain_logp.data_ptr(), n_accept.data_ptr(), S, 2 * half,
        int(form == "latency"), stream)
    if rc != 0:
        raise RuntimeError(f"the population half-step ({pp.family}, {form} form) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[f"{count}_half_step"] += 1
    LAUNCHES[f"{count}_half_step_{form}"] += 1


# ------------------------------------------------------------------------ P3

def map_ascent_plain(pp, u0, bounds, n_iter=400, lr=0.05, alpha=0.01):
    """Plain P3: ``n_iter`` CosineAdam steps (optax's ``adam`` under
    ``cosine_decay_schedule(lr, n_iter, alpha)``) of every start ``u0`` (S,
    n_starts, ndim) float64 in the unbounded space of BoundsTransform
    ``bounds`` down -log p(to_bounded(u)), gradients by autograd through
    ``pp.plain``, non-finite components zeroed. Returns the last iterates
    (S, n_starts, ndim) and their -log p (S, n_starts), +inf where log p is
    -inf."""
    from ..parallel.optimize import CosineAdam
    u = u0
    opt = CosineAdam(u, lr=lr, n_iter=n_iter, alpha=alpha)
    for _ in range(n_iter):
        with torch.enable_grad():
            u_g = u.detach().requires_grad_(True)
            neg = -pp.plain(bounds.to_bounded(u_g))
            g, = torch.autograd.grad(neg.sum(), u_g)
        u = opt.step(u, torch.where(torch.isfinite(g), g, torch.zeros_like(g)))
    return u, -pp.plain(bounds.to_bounded(u))


def map_ascent(pp, u0, bounds, n_iter=400, lr=0.05, alpha=0.01, form=None):
    """P3: the Adam ascent of ``pp``'s transients from the starts ``u0`` (S,
    n_starts, ndim) float64 in one launch (arguments and result:
    :func:`map_ascent_plain`; ``form``: ``"pair"``, ``"warp"`` or None,
    :func:`map_form`'s pick). A CPU tensor takes the plain version."""
    _check_form("MAP ascent", form, ("warp", "pair"))
    if u0.device.type == "cpu":
        return map_ascent_plain(pp, u0, bounds, n_iter, lr, alpha)
    _require_cuda(u0, "population MAP ascent")
    if _family(pp) != "sc2":
        raise NotImplementedError(
            f"P3 takes ShockCooling2 populations only: the Adam ascent over a "
            f"{type(pp.model).__name__} population needs its gradient (ROADMAP Queue 1 item 22)")
    if u0.ndim != 3 or u0.shape[0] != pp.n_transients:
        raise ValueError(f"u0 must be (S={pp.n_transients}, n_starts, ndim), got "
                         f"{tuple(u0.shape)}")
    S, n_starts, ndim = u0.shape
    if ndim != len(bounds.lower):
        raise ValueError(f"the bounds have {len(bounds.lower)} dimensions, the starts {ndim}")
    dev = u0.device
    check(u0, "u0", (S, n_starts, ndim), (torch.float64,), dev)
    P = _params(pp, ndim, None, None)
    if form is None:
        form = map_form(S, n_starts, P.n_points, _sm_count(dev))
    u_out = torch.empty_like(u0)
    neg_out = torch.empty((S, n_starts), dtype=torch.float64, device=dev)
    from ..parallel.optimize import B1, B2, EPS
    sched = _adam_table_on(dev, n_iter, lr, alpha)
    Q = _PopMapParams()
    Q.u0, Q.sched, Q.u_out, Q.neg_out = (u0.data_ptr(), sched.data_ptr(), u_out.data_ptr(),
                                         neg_out.data_ptr())
    Q.n_starts, Q.n_iter = n_starts, n_iter
    Q.b1, Q.b2, Q.one_minus_b1, Q.one_minus_b2, Q.eps = B1, B2, 1 - B1, 1 - B2, EPS
    for i, (kind, lo, hi, width) in enumerate(bounds.kernel_spec()):
        Q.kind[i], Q.lo[i], Q.hi[i], Q.width[i] = kind, lo, hi, width
    from .build import library
    device_index, stream = cuda_args(dev)
    rc = library().pop_map_launch(ctypes.addressof(P), ctypes.addressof(Q), device_index,
                                  _f64(pp), S, int(form == "pair"), stream)
    if rc != 0:
        raise RuntimeError(f"pop_map_kernel ({form} form) launch failed: cudaError {rc}")
    LAUNCHES["pop_map"] += 1
    LAUNCHES[f"pop_map_{form}"] += 1
    return u_out, neg_out

