"""Wrappers of the fused ShockCooling kernels (``csrc/sc_logpost.cu``, SW17
in physical parameters over the band table), with the plain PyTorch versions
beside them; :mod:`.sc4` wraps the ShockCooling4 (MSW23) instantiations of
the same source through the helpers here.

* :func:`log_posterior`: the log-posterior of a batch of walker states, in
  the form :func:`logpost_form` picks: ``"warp"`` (``logpost_warp_kernel``
  over ``SCWarpModel<C, N>``, a warp per walker as the half-step) where the
  walkers fill the card, ``"latency"`` (``logpost_latency_kernel``: a block
  per walker, a point a thread) below. Both give the same bits, those that
  the half-steps and K6a store. A launch counts once under ``sc_logpost``
  and once under ``sc_logpost_warp`` or ``sc_logpost_latency``.
* :func:`stretch_half_step`: one Goodman-Weare half-step of the ensemble,
  in place, in the form :func:`sc_half_form` picks: ``"warp"``
  (``stretch_half_step_kernel`` over ``SCWarpModel``, a warp per walker)
  where the walkers fill the card, ``"latency"``
  (``stretch_half_step_latency_kernel``: a block per walker, its points
  over ceil(N / 32) warps, one point a thread) below. Both store the same
  bits. A launch counts once under ``sc_half_step`` and once under its
  form's name, ``sc_half_step_warp`` or ``sc_half_step_latency``.
* K6a and K6b over ``SCWarpModel`` are launched by :mod:`.ladder`, which
  counts them under ``LADDER_COUNTS``'s names; K6a in the form
  :func:`tempered_form` picks for the launch's R x half walkers
  (``tempered_half_step_kernel``, a warp per walker, or
  ``tempered_half_step_latency_kernel``, a block per (rung, walker); the
  same bits), counted once more under ``sc_tempered_half_step_warp`` or
  ``sc_tempered_half_step_latency``; K6b in the form :func:`ladder_init_form`
  picks for its distinct states (``ladder_init_kernel``, a warp per state,
  or ``ladder_init_latency_kernel``, a block per state; the same bits),
  counted once more under ``sc_ladder_init_warp`` or
  ``sc_ladder_init_latency``.

For a tensor on the CPU each wrapper runs its plain version
(:func:`~.common.log_posterior_plain`, :func:`~.common.stretch_half_step_plain`).
For a CUDA tensor it launches the kernel or raises: there is no fallback.
Each launch adds one to ``LAUNCHES[name]``, and nothing else does.
"""

import ctypes

import torch

from .common import (LAUNCHES, MAX_DIM, FLOATS, check, check_buffers, cuda_args, affine_key,
                     fill_priors_and_affine, half_step_checks, half_step_args,
                     log_posterior_plain, stretch_half_step_plain)

__all__ = ["log_posterior", "stretch_half_step", "sc_half_form", "tempered_form",
           "logpost_form", "ladder_init_form", "LADDER_COUNTS"]

#: the LAUNCHES names under which :mod:`.ladder` counts K6a and K6b over
#: this module's policy
LADDER_COUNTS = {"tempered_half_step": "sc_tempered_half_step",
                 "ladder_init": "sc_ladder_init"}


class _SCParams(ctypes.Structure):
    """ctypes mirror of ``struct SCParams`` (csrc/sc_logpost.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("t_centered", "y", "inv_dy", "dy", "sigma_units", "s_a", "s_b", "coef")]
                + [(n, ctypes.c_longlong) for n in
                   ("n_points", "n_coef", "ndim", "use_sigma", "has_affine")]
                + [(n, ctypes.c_double) for n in
                   ("t_ref", "inv_yscale", "log_norm_const", "ll_offset", "kappa", "A",
                    "a_model", "alpha", "eps1", "eps2", "L0_42", "T0", "tph_to_tcol",
                    "L_br_0_42", "T_col_br_0", "t_br_0", "t_tr_0", "kappa_L", "kappa_T", "k_B",
                    "c3_42")]
                + [("prior_kind", ctypes.c_longlong * MAX_DIM)]
                + [(n, ctypes.c_double * MAX_DIM) for n in
                   ("p_min", "p_max", "mean", "stddev", "affine_offset", "affine_scale")]
                + [("coef_t", ctypes.c_void_p)])


#: the latency form's largest block, warps a walker (LP_LAT_WARPS of
#: csrc/stretch.cuh): past 20 x 32 points a walker only the warp form runs
LATENCY_MAX_WARPS = 20
#: the half-steps run the latency form while a half's walkers need at most
#: this many warps an SM (ceil(N / 32) a walker), the warp form above
#: (sc_half_form), by model. ShockCooling4's forms cross between half 32768
#: (the latency form 0.155 against 0.159-0.163 ms) and 40960 (0.191-0.192
#: against 0.186-0.191): 1300, half 34320 at 149 points on the H100's 132
#: SMs. ShockCooling's latency form leads through half 81920 (0.3047 against
#: 0.3158-0.3181 ms) and ties from 90112 (0.3358 against 0.3219-0.3349):
#: its own 3104, half 81920 (tools/time_port_kernels.py --sc-only
#: --sc-halves; PERF.md §6)
HALF_LATENCY_WARPS_PER_SM = {"sc": 3104, "sc4": 1300}
#: K6a's latency form runs while a launch's R x half walkers need at most
#: this many warps an SM (tempered_form), by model. ShockCooling4's K6a
#: crosses between 24576 walkers (the latency form 0.110-0.124 ms against
#: 0.124-0.126) and 34816 (0.1724-0.1727 against 0.161-0.180), beside its
#: half-step's 32768-40960: the half-steps' constant (34320 walkers) stays.
#: ShockCooling's stays ahead to 65536 walkers (0.2580 against
#: 0.2545-0.2617 ms), at 34816, the evidence bench shape, by 10-17%
#: (0.134-0.140 against 0.147-0.167), and the warp form leads from 98304
#: (0.3835 against 0.3609-0.3697): its own constant, 2500 (65536 walkers at
#: 149 points on 132 SMs) (tools/time_port_kernels.py --sc-only
#: --sc-ladders; PERF.md §6)
TEMPERED_LATENCY_WARPS_PER_SM = {"sc": 2500, "sc4": 1300}
#: the batch log-posterior's latency form runs while a launch's walkers need
#: at most this many warps an SM (logpost_form), by model, and K6b's while
#: its distinct states do (ladder_init_form: a state's work is a walker's,
#: and the two forms of each cross at the same widths). On the window's
#: states (a fit's initial state, every walker's likelihood evaluated),
#: ShockCooling's latency form leads through 12288 walkers (0.0648-0.0685
#: against 0.0682-0.0712 ms) and loses from 16384 (0.0929 against
#: 0.0918-0.0923): 466, 12288 walkers at 149 points on 132 SMs;
#: ShockCooling4's leads through 8192 (0.0602 against 0.0622-0.0623) and
#: loses from 12288 (0.0880-0.0882 against 0.0848-0.0849): 311, 8192
#: walkers. Far earlier than the half-steps' crossovers, whose proposals
#: outside the priors skip their likelihood: blocks of unequal work favour
#: the latency form (tools/time_port_kernels.py --sc-only --sc-logpost
#: --sc-k6b; PERF.md §6)
LOGPOST_LATENCY_WARPS_PER_SM = {"sc": 466, "sc4": 311}

_BUFFERS = ("t_centered", "y", "inv_dy", "dy", "sigma_units", "bb_s_a", "bb_s_b", "bb_coeffs")

#: the model constants of each kernel family, by the name kernel_constants()
#: gives them and the field of _SCParams they fill
_CONSTANTS = {
    "sc": {"kappa": "kappa", "A": "A", "a": "a_model", "alpha": "alpha", "eps1": "eps1",
           "eps2": "eps2", "L0_42": "L0_42", "T0": "T0", "tph_to_tcol": "tph_to_tcol"},
    "sc4": {"kappa": "kappa", "A": "A", "a": "a_model", "alpha": "alpha",
            "L_br_0_42": "L_br_0_42", "T_col_br_0": "T_col_br_0", "t_br_0": "t_br_0",
            "t_tr_0": "t_tr_0"},
}


def kernel_params(prefix, lp, ndim, offset, scale):
    """The parameter block of family ``prefix`` ("sc" or "sc4") for
    LogPosterior ``lp``, cached on it and keyed by the buffers' addresses (a
    module moved between devices gets a new block)."""
    from ..core.constants import c3_42, k_B
    ll = lp.log_likelihood
    key = (prefix, ndim, affine_key(offset, scale),
           tuple(getattr(ll, name).data_ptr() for name in _BUFFERS))
    cache = lp.__dict__.setdefault("_kernel_params_cache", {})
    if key in cache:
        return cache[key]
    if ndim != len(lp.priors) or ndim != 5 + int(ll.use_sigma) or ndim > MAX_DIM:
        raise ValueError(f"the {prefix.upper()} kernels take ndim = 5 (+1 with use_sigma) "
                         f"matching the priors; got ndim={ndim} for {len(lp.priors)} priors")
    consts = ll.model.kernel_constants()
    P = _SCParams()
    for name in ("t_centered", "y", "inv_dy", "dy", "sigma_units"):
        setattr(P, name, getattr(ll, name).data_ptr())
    P.s_a, P.s_b, P.coef = ll.bb_s_a.data_ptr(), ll.bb_s_b.data_ptr(), ll.bb_coeffs.data_ptr()
    # the latency form's coalesced copy, kept alive with the block
    P.coef_t_tensor = ll.bb_coeffs.t().contiguous()
    P.coef_t = P.coef_t_tensor.data_ptr()
    P.n_points, P.n_coef = ll.bb_coeffs.shape
    P.ndim, P.use_sigma = ndim, int(ll.use_sigma)
    P.t_ref, P.inv_yscale = ll.t_ref, ll.inv_yscale
    P.log_norm_const, P.ll_offset = ll.log_norm_const, ll.offset
    for name, field in _CONSTANTS[prefix].items():
        setattr(P, field, consts[name])
    # the JAX graph raises the Python float kappa to these powers on the host
    P.kappa_L, P.kappa_T = consts["kappa"] ** -0.89, consts["kappa"] ** -0.22
    P.k_B, P.c3_42 = k_B, c3_42
    fill_priors_and_affine(P, lp.priors, key[2])
    cache[key] = P
    return P


def _kernel_params(lp, ndim, offset, scale):
    return kernel_params("sc", lp, ndim, offset, scale)


def _check_form(prefix, what, form):
    if form not in (None, "warp", "latency"):
        raise ValueError(f"the {prefix.upper()} {what}'s form is 'warp' or 'latency', "
                         f"not {form!r}")


def logpost_launch(prefix, lp, q, param_offset=None, param_scale=None, form=None):
    """The batch log-posterior (W,) float64 of family ``prefix`` for
    LogPosterior ``lp`` at the walker states ``q`` (W, ndim) float32/float64,
    affine-mapped to ``offset + scale * q`` when given: its plain version for
    a CPU tensor, else the kernel in ``form``, ``"warp"`` or ``"latency"``
    (None: the form :func:`logpost_form` picks)."""
    _check_form(prefix, "log-posterior", form)
    if q.device.type == "cpu":
        return log_posterior_plain(lp, q, param_offset, param_scale)
    if q.device.type != "cuda":
        raise ValueError(f"the {prefix.upper()} log-posterior runs on CUDA (or its plain "
                         f"version on the CPU), not {q.device}")
    if q.ndim != 2:
        raise ValueError(f"q must be (W, ndim), got shape {tuple(q.shape)}")
    W, ndim = q.shape
    check(q, "q", (W, ndim), FLOATS, q.device)
    check_buffers(lp.log_likelihood, _BUFFERS, q.device)
    from .build import library
    lib = library()
    P = kernel_params(prefix, lp, ndim, param_offset, param_scale)
    if form is None:
        from .gradient import sm_count
        form = logpost_form(W, P.n_points, sm_count(q.device), prefix)
    out = torch.empty(W, dtype=torch.float64, device=q.device)
    dev, stream = cuda_args(q.device)
    rc = getattr(lib, f"{prefix}_logpost_launch")(
        ctypes.addressof(P), dev, int(lp.log_likelihood.compute_dtype == torch.float64),
        q.data_ptr(), int(q.dtype == torch.float64), W, out.data_ptr(), int(form == "latency"),
        stream)
    if rc != 0:
        raise RuntimeError(f"the {prefix.upper()} batch log-posterior ({form} form) launch "
                           f"failed: cudaError {rc}")
    LAUNCHES[f"{prefix}_logpost"] += 1
    LAUNCHES[f"{prefix}_logpost_{form}"] += 1
    return out


def _form(n_walkers, n_points, n_sm, warps_per_sm):
    """``"latency"`` while ``n_walkers`` walkers of ceil(n_points / 32) warps
    each (at most LATENCY_MAX_WARPS) need at most ``warps_per_sm`` warps an
    SM of the card's ``n_sm``, else ``"warp"``."""
    per_walker = -(-n_points // 32)
    if per_walker > LATENCY_MAX_WARPS:
        return "warp"
    return "latency" if n_walkers * per_walker <= warps_per_sm * n_sm else "warp"


def sc_half_form(half, n_points, n_sm, prefix="sc"):
    """The half-step's form over family ``prefix`` ("sc" or "sc4"; :mod:`.sc4`
    binds its own) for ``half`` walkers of ``n_points`` points on a card of
    ``n_sm`` SMs: ``"latency"`` (a walker's points over ceil(n_points / 32)
    warps, a point a thread) where a warp per walker would leave the card's
    schedulers idle, each lane walking its points one after another;
    ``"warp"`` (a warp per walker) where the walkers' groups would overfill
    the card, past the family's HALF_LATENCY_WARPS_PER_SM. Both store the
    same bits."""
    return _form(half, n_points, n_sm, HALF_LATENCY_WARPS_PER_SM[prefix])


def tempered_form(n_walkers, n_points, n_sm, prefix="sc"):
    """K6a's form over family ``prefix`` ("sc" or "sc4"; :mod:`.sc4` binds
    its own) for a launch of ``n_walkers`` = R x half walkers (every rung's
    half together, a block per walker in the latency form) of
    ``n_points`` points on a card of ``n_sm`` SMs: the half-steps' rule at
    the family's TEMPERED_LATENCY_WARPS_PER_SM. Both forms store the same
    bits."""
    return _form(n_walkers, n_points, n_sm, TEMPERED_LATENCY_WARPS_PER_SM[prefix])


def logpost_form(n_walkers, n_points, n_sm, prefix="sc"):
    """The batch log-posterior's form over family ``prefix`` ("sc" or "sc4";
    :mod:`.sc4` binds its own) for ``n_walkers`` walkers of ``n_points``
    points on a card of ``n_sm`` SMs: ``"latency"`` (a block per walker, a
    point a thread) below the family's LOGPOST_LATENCY_WARPS_PER_SM, else
    ``"warp"``. Both give the same bits."""
    return _form(n_walkers, n_points, n_sm, LOGPOST_LATENCY_WARPS_PER_SM[prefix])


def ladder_init_form(n_states, n_points, n_sm, prefix="sc"):
    """K6b's form over family ``prefix`` for ``n_states`` distinct starting
    states (each written to its rungs' rows): :func:`logpost_form`'s rule,
    a state's work being a walker's. Both forms give the same bits."""
    return logpost_form(n_states, n_points, n_sm, prefix)


def half_step_launch(prefix, lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                     param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                     check_partners=True, form=None):
    """One stretch-move half-step of family ``prefix``, in place (arguments:
    :func:`.sc2.stretch_half_step`): its plain version for a CPU tensor,
    else the kernel in ``form``, ``"warp"`` or ``"latency"`` (None: the form
    :func:`sc_half_form` picks)."""
    _check_form(prefix, "half-step", form)
    if x.device.type == "cpu":
        def log_prob(q):
            return log_posterior_plain(lp, q, param_offset, param_scale)
        return stretch_half_step_plain(log_prob, x, logp, h, u_z, j, u_acc, a, chain_x,
                                       chain_logp, n_accept)
    if x.device.type != "cuda":
        raise ValueError(f"the {prefix.upper()} half-step runs on CUDA (or its plain version "
                         f"on the CPU), not {x.device}")
    _, ndim = half_step_checks(x, logp, h, u_z, j, u_acc, chain_x, chain_logp, n_accept,
                               check_partners)
    check_buffers(lp.log_likelihood, _BUFFERS, x.device)
    from .build import library
    lib = library()
    P = kernel_params(prefix, lp, ndim, param_offset, param_scale)
    if form is None:
        from .gradient import sm_count
        form = sc_half_form(x.shape[1], P.n_points, sm_count(x.device), prefix)
    device_index, stream = cuda_args(x.device)
    rc = getattr(lib, f"{prefix}_half_step_launch")(
        ctypes.addressof(P), device_index, int(lp.log_likelihood.compute_dtype == torch.float64),
        *half_step_args(x, logp, h, u_z, j, u_acc, a, chain_x, chain_logp, n_accept),
        int(form == "latency"), stream)
    if rc != 0:
        raise RuntimeError(f"the {prefix.upper()} half-step ({form} form) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[f"{prefix}_half_step"] += 1
    LAUNCHES[f"{prefix}_half_step_{form}"] += 1


def log_posterior(lp, q, param_offset=None, param_scale=None):
    """The ShockCooling log-posterior (W,) float64 of LogPosterior ``lp`` at
    the walker states ``q`` (W, ndim) (see :func:`logpost_launch`)."""
    return logpost_launch("sc", lp, q, param_offset, param_scale)


def stretch_half_step(lp, x, logp, h, u_z, j, u_acc, a=2.0, param_offset=None,
                      param_scale=None, chain_x=None, chain_logp=None, n_accept=None,
                      check_partners=True):
    """One ShockCooling stretch-move half-step, in place (see
    :func:`half_step_launch`)."""
    return half_step_launch("sc", lp, x, logp, h, u_z, j, u_acc, a, param_offset, param_scale,
                            chain_x, chain_logp, n_accept, check_partners)
