"""Population fitting: many transients, each with its own stretch-move
ensemble, fit concurrently on one device (the port of
``lightcurve_fitting_tpu/parallel/population.py``).

Photometry is padded to the widest transient with masks
(:func:`pack_population`), and S independent ensembles advance in lockstep:
on CUDA every ensemble's half-step is one launch of P2, the initial state
one launch of P1 and ``init="map"``'s whole multi-start Adam ascent one
launch of P3 (``kernels/csrc/population.cu``, :mod:`..kernels.pop`); on
the CPU the same calls run their plain versions. The walker state stays on
the device from the initial state to the end of the run; the acceptance
mean and, with ``summaries``, the percentiles (K5 on float32 chains) are
reduced there too.

On the CPU a population of any class the JAX function takes fits there:
ShockCooling2, ShockCooling, ShockCooling4, ShockCooling3 and
CompanionShocking 1-3 (:func:`check_model_class`). On CUDA the classes with
kernels do: ShockCooling2 (P1-P3), ShockCooling and ShockCooling4 (P1 and
P2; their ``init="map"`` waits for P3 over their gradient, ROADMAP Queue 1
item 22); CompanionShocking 1-3 and ShockCooling3 wait for item 10. Draws
come from a ``torch.Generator`` on the device seeded by splitmix64(seed,
step) (:func:`.sampler._step_seed`), so chains agree with the JAX package in
distribution, not path; the MAP seeding's starts and the walkers' jitter
come from numpy's ``default_rng(seed)`` in the JAX order, so they agree
with it to the ascent's rounding.

Not ported yet, and refused with ``NotImplementedError``: ``mesh``
(ROADMAP Queue 1 item 17), ``checkpoint_every``, ``checkpoint_file`` and
``resume_from`` (item 16); on CUDA a ``KDEPrior`` (item 21). The XLA
executable cache (``_COMPILED_CACHE``) has nothing to cache here.
"""

import hashlib
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..core import config
from ..core.device import resolve_device
from ..kernels import pop as kpop
from ..models.base import intrinsic_scatter_units
from ..ops.mathx import epoch_reference
from ..ops.quantile import percentile_f32
from .hmc import BoundsTransform
from .sampler import _step_seed

__all__ = ["pack_population", "PopulationPosterior", "fit_population",
           "population_goodness_of_fit", "population_information_criteria",
           "population_compare_elpd"]

SUMMARY_PERCENTILES = (16.0, 50.0, 84.0)
TABLE = ("bb_coeffs", "bb_s_a", "bb_s_b")   # the band table's rows, as the kernels read them

# content-keyed shipments of pack_population: a fit -> goodness of fit -> IC
# workflow packs the same transients several times
_PACK_SHIP_CACHE = OrderedDict()
_PACK_SHIP_ENTRIES = 4


def _array_digest(a):
    a = np.ascontiguousarray(a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a))
    return (a.shape, str(a.dtype), hashlib.sha1(a.tobytes()).hexdigest()[:16])


def pack_population(models, lcs, use_sigma=False, device=None):
    """Pack per-transient photometry and band data into dense padded tensors
    on ``device`` (default: CUDA, raising without it).

    Returns a dict: ``t``, ``y``, ``dy`` (S, N) float64, ``mask`` (S, N)
    bool, ``quad`` (each of the models' ``prepare_quad`` entries stacked
    over transients) and ``yscale`` (S,), the JAX package's arrays bit for
    bit: times padded with the transient's last real time (``hot_phase``
    centres on floor(min t)), each per-point quad array with its last row,
    ``bb_coeffs`` with zeros to the population's largest Chebyshev degree
    (exact no-ops in Clenshaw), the band data cast to the device's compute
    dtype. ``use_sigma`` does not change the pack (the JAX signature).

    Repeat packs of identical content on one device reuse the shipped
    tensors (a content-keyed LRU of four entries, keyed by sha1 digests of
    the host arrays): the returned dicts are shallow copies, so a caller
    may add keys without touching the cached entry."""
    dev = resolve_device(device)
    S = len(lcs)
    N = max(len(lc) for lc in lcs)
    oq = models[0].output_quantity
    t = np.zeros((S, N))
    y = np.zeros((S, N))
    dy = np.ones((S, N))
    mask = np.zeros((S, N), bool)
    quads = []
    for s, (m, lc) in enumerate(zip(models, lcs)):
        n = len(lc)
        t_i = np.asarray(lc["MJD"], float)
        t[s, :n] = t_i
        t[s, n:] = t_i[-1] if n else 0.0
        y[s, :n] = np.asarray(lc[oq], float)
        dy[s, :n] = np.asarray(lc["d" + oq], float)
        mask[s, :n] = True
        padded = {}
        for k, v in m.prepare_quad(np.asarray(lc["filter"])).items():
            v = np.asarray(v)
            if v.shape[:1] == (n,) and n < N:
                v = np.concatenate([v, np.repeat(v[-1:], N - n, axis=0)], axis=0)
            padded[k] = v
        quads.append(padded)
    if "bb_coeffs" in quads[0]:
        D = max(q["bb_coeffs"].shape[-1] for q in quads)
        for q in quads:
            d = q["bb_coeffs"].shape[-1]
            if d < D:
                q["bb_coeffs"] = np.pad(q["bb_coeffs"], [(0, 0), (0, D - d)])
    dt = config.get_compute_dtype(dev)
    np_dt = None if dt is None else {torch.float32: np.float32, torch.float64: np.float64}[dt]
    castable = {"bb_coeffs", "bb_s_a", "bb_s_b", "nodes", "weights", "k_ext"}
    stacked = {}
    for k in quads[0]:
        out = np.stack([q[k] for q in quads])
        if np_dt is not None and k in castable and out.dtype.kind == "f":
            out = out.astype(np_dt)
        stacked[k] = out
    yscale = np.array([np.median(np.abs(yy[mm])) if mm.any() else 1.0
                       for yy, mm in zip(y, mask)])

    key = (str(dev), str(dt), _array_digest(t), _array_digest(y), _array_digest(dy),
           _array_digest(mask), _array_digest(yscale),
           tuple(sorted((k, _array_digest(v)) for k, v in stacked.items())))
    hit = _PACK_SHIP_CACHE.get(key)
    if hit is None:
        hit = {"t": torch.as_tensor(t, device=dev), "y": torch.as_tensor(y, device=dev),
               "dy": torch.as_tensor(dy, device=dev), "mask": torch.as_tensor(mask, device=dev),
               "quad": {k: torch.as_tensor(v, device=dev) for k, v in stacked.items()},
               "yscale": torch.as_tensor(yscale, device=dev)}
        _PACK_SHIP_CACHE[key] = hit
        while len(_PACK_SHIP_CACHE) > _PACK_SHIP_ENTRIES:
            _PACK_SHIP_CACHE.popitem(last=False)
    _PACK_SHIP_CACHE.move_to_end(key)
    return {**hit, "quad": dict(hit["quad"])}


def _normalized(packed, sigma_type):
    """Host float64 (y / yscale, dy / yscale, the intrinsic scatter's units
    (S, N), log_norm (S,)) of a pack: the units of ``sigma_type`` over each
    transient's real points (``intrinsic_scatter_units`` with its mask),
    log_norm = -0.5 sum over them of log(2 pi dy^2)."""
    y = packed["y"].cpu().numpy()
    dy = packed["dy"].cpu().numpy()
    mask = packed["mask"].cpu().numpy()
    inv = 1.0 / packed["yscale"].cpu().numpy()
    yn = y * inv[:, None]
    dyn = dy * inv[:, None]
    units = np.stack([np.broadcast_to(intrinsic_scatter_units(dyn[s], sigma_type, mask=mask[s]),
                                      dyn[s].shape) for s in range(len(dyn))])
    log_norm = -0.5 * np.sum(np.where(mask, np.log(2 * np.pi * dyn ** 2.0), 0.0), axis=-1)
    return yn, dyn, units, log_norm


# The classes a population takes (the JAX function's: its make_logpost calls
# any class's _eval_points), each with the fewest and the most parameters of
# its _eval_points (t_exp, ebv and CS's optional factors or shifts default;
# kappa is bound at construction) and its kernels' family on CUDA (None: the
# CPU only, ROADMAP Queue 1 item 10).
def _pop_classes():
    from ..models import (CompanionShocking, CompanionShocking2, CompanionShocking3,
                          ShockCooling, ShockCooling2, ShockCooling3, ShockCooling4)
    return ((ShockCooling2, 3, 4, "sc2"), (ShockCooling, 4, 5, "sc"),
            (ShockCooling4, 4, 5, "sc4"), (ShockCooling3, 5, 7, None),
            (CompanionShocking, 5, 8, None), (CompanionShocking2, 5, 7, None),
            (CompanionShocking3, 5, 7, None))


def _class_spec(model):
    """(n_min, n_max, kernel family or None) of ``model``'s class; a class the
    population does not take raises NotImplementedError."""
    for cls, n_min, n_max, family in _pop_classes():
        if isinstance(model, cls):
            return n_min, n_max, family
    raise NotImplementedError(
        f"the population fit takes ShockCooling2, ShockCooling, ShockCooling4, ShockCooling3 "
        f"and CompanionShocking 1-3, not {type(model).__name__}")


def check_model_class(model, device, init="window"):
    """Raise NotImplementedError where ``device`` cannot fit a population of
    ``model``'s class: on the CPU every class of the JAX function runs (the
    plain versions); on CUDA (``device`` None or a CUDA device) ShockCooling2,
    ShockCooling and ShockCooling4 run on their kernels, ShockCooling3 and
    CompanionShocking 1-3 wait for ROADMAP Queue 1 item 10, and
    ``init="map"`` over ShockCooling or ShockCooling4 for P3 over their
    gradient (item 22)."""
    _, _, family = _class_spec(model)
    if (torch.device(device) if device is not None else torch.device("cuda")).type != "cuda":
        return
    name = type(model).__name__
    if family is None:
        raise NotImplementedError(
            f"a {name} population has no kernels yet: on CUDA the population fit takes "
            "ShockCooling2, ShockCooling and ShockCooling4; P1 and P2 over the other classes "
            'wait for ROADMAP Queue 1 item 10 (device="cpu" runs their plain versions)')
    if family != "sc2" and init == "map":
        raise NotImplementedError(
            f'init="map" over a {name} population on CUDA needs P3 over its gradient (ROADMAP '
            'Queue 1 item 22); pass init="window", or device="cpu" for the plain ascent')


def _check_n_model(model, n_model):
    """The class's (n_min, family) after checking that it takes ``n_model``
    parameters."""
    n_min, n_max, family = _class_spec(model)
    if not n_min <= n_model <= n_max:
        names = ", ".join(model.input_names[:n_max])
        raise ValueError(f"a {type(model).__name__} population fits {n_min} to {n_max} of its "
                         f"parameters ({names}; those past the first {n_min} default), plus "
                         f"sigma with use_sigma; got {n_model}")
    return n_min, family


class PopulationPosterior:
    """The per-transient log-posterior of a packed population (the JAX
    function's ``make_logpost``, vmapped over transients): ``p`` (S, W,
    ndim) absolute float64 parameters -> (S, W) float64, the walkers of
    transient s under its own data, for any class :func:`_class_spec` takes.

    The buffers, on the pack's device, in the compute dtype (float32 on CUDA
    by default): ``t_centered`` (S, N), the times less the transient's
    ``t_ref = floor(min t)``; ``y``, ``dy`` (divided by the transient's
    ``yscale``), ``inv_dy`` (0 on the padded points), ``sigma_units`` (S,
    N); for a band-table class ``bb_coeffs`` (S, N, D + 1), ``bb_s_a``,
    ``bb_s_b`` (S, N). In float64: ``t_ref``, ``inv_yscale``, ``log_norm``
    (S,); ``mask`` (S, N) bool, each transient's real points first (as
    :func:`pack_population` packs them, padded with copies of the last), and
    ``n_real`` (S,) int32 their number, which the kernels read. ``family``
    names the class's kernels (``"sc2"``, ``"sc"``, ``"sc4"``; None: the
    CPU only). :meth:`plain` is the plain version of P1."""

    def __init__(self, packed, model, priors, use_sigma=False, sigma_type="relative"):
        self.priors = list(priors)
        self.use_sigma = bool(use_sigma)
        self.n_model = len(self.priors) - int(self.use_sigma)
        self.n_min, self.family = _check_n_model(model, self.n_model)
        self.model = model
        dev = packed["t"].device
        dt = config.get_compute_dtype(dev)
        self.compute_dtype = dt if dt is not None else torch.float64
        cdt = self.compute_dtype
        yn, dyn, units, log_norm = _normalized(packed, sigma_type)

        def buf(a, dtype=cdt):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        t = packed["t"].to(torch.float64)
        self.t_abs = t
        self.t_ref = epoch_reference(t, dim=1)
        t_shift = t - self.t_ref[:, None]
        self.t_shift = t_shift[:, None, :]                  # (S, 1, N) for the plain version
        self.t_centered = t_shift.to(cdt).contiguous()
        # one byte a point, as P1-P3 read it
        self.mask = packed["mask"].to(torch.bool).contiguous()
        self.n_real = self.mask.sum(dim=1).to(torch.int32).contiguous()
        first = torch.arange(self.mask.shape[1], device=dev) < self.n_real[:, None]
        if not torch.equal(self.mask, first):
            raise ValueError("each transient's real points must come first in the pack "
                             "(pack_population's layout)")
        self.y = buf(yn)
        self.dy = buf(dyn)
        self.inv_dy = torch.where(self.mask, 1.0 / self.dy, torch.zeros_like(self.dy))
        self.sigma_units = buf(units)
        self.quad = packed["quad"]
        if self.family is not None:
            for name in TABLE:
                setattr(self, name, packed["quad"][name].to(cdt).contiguous())
        self.inv_yscale = buf(1.0 / packed["yscale"].cpu().numpy(), torch.float64)
        self.log_norm = buf(log_norm, torch.float64)
        self.kernel_params = {}

    @property
    def n_transients(self):
        return self.t_centered.shape[0]

    @property
    def device(self):
        return self.t_centered.device

    def flux(self, p):
        """The model's band fluxes (S, W, N) at absolute float64 parameters
        ``p`` (S, W, >= n_model), each transient on its own points, plain
        PyTorch in the compute dtype (the class's ``_eval_points``). A class
        with kernels runs all transients at once: the times and t_exp (the
        parameter after the first ``n_min``, 0 when not fitted) enter less
        the transient's t_ref, so that ``hot_phase``'s centring (floor(min t)
        = 0 over the shifted times) rounds each transient's phase as the JAX
        package's vmap does: C(t - t_ref) - C(t_exp - t_ref), or in float64
        t - t_exp exactly. Any other class runs transient by transient on its
        absolute times and parameters, where ``hot_phase`` centres each on
        its own floor(min t), as the vmap."""
        if self.family is None:
            rows = [self.model._eval_points(
                self.t_abs[s], {k: v[s] for k, v in self.quad.items()},
                *[p[s, :, i:i + 1] for i in range(self.n_model)], plain=True)
                for s in range(self.n_transients)]
            return torch.stack(rows)
        k = self.n_min
        t_exp = p[..., k:k + 1] if self.n_model > k else torch.zeros_like(p[..., :1])
        quad = {name: getattr(self, name)[:, None] for name in TABLE}
        return self.model._eval_points(self.t_shift, quad, *[p[..., i:i + 1] for i in range(k)],
                                       t_exp - self.t_ref[:, None, None], plain=True)
    def _term_parts(self, p):
        """The two parts of each point's residual term at ``p``, (S, W, N) in
        the compute dtype: log(2 pi sigma^2) and r^2 / sigma^2 with the
        intrinsic scatter, None and (r inv_dy)^2 without."""
        cdt = self.compute_dtype
        y_fit = self.flux(p).to(cdt) * self.inv_yscale.to(cdt)[:, None, None]
        y = self.y[:, None, :]
        if self.use_sigma:
            sig = p[..., -1:].to(cdt)
            sigma2 = self.dy[:, None, :] ** 2.0 + (sig * self.sigma_units[:, None, :]) ** 2.0
            return torch.log(2 * np.pi * sigma2), (y - y_fit) ** 2.0 / sigma2
        r = (y - y_fit) * self.inv_dy[:, None, :]
        return None, r * r

    def residual_terms(self, p):
        """(S, W, N) per-point terms of the residual sum at ``p``, in the
        compute dtype: (r inv_dy)^2 over every point (0 weight on the padded
        ones), or with the intrinsic scatter log(2 pi sigma^2) + r^2 /
        sigma^2 over the real points (0 on the padded ones)."""
        log_term, quad = self._term_parts(p)
        if log_term is None:
            return quad
        terms = log_term + quad
        return torch.where(self.mask[:, None, :], terms, torch.zeros_like(terms))

    def log_likelihood(self, p):
        """The population's log L (S, W) float64 at ``p``, -inf where it is
        not finite: -0.5 times the compute-dtype sum of the residual terms,
        plus log_norm in float64 without the intrinsic scatter."""
        ll = (-0.5 * torch.sum(self.residual_terms(p), dim=-1)).to(torch.float64)
        if not self.use_sigma:
            ll = ll + self.log_norm[:, None]
        return torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))

    def term_scales(self, p):
        """(S, W) float64: the yardstick of the log-likelihood's rounding at
        ``p``: 0.5 x the summed magnitudes of the parts of the residual terms
        (with the intrinsic scatter |log(2 pi sigma^2)| and r^2 / sigma^2
        apart, over the real points; non-finite parts counted as 0) plus
        |log_norm| without it. The parts cancel near an optimum, their
        rounding does not."""
        log_term, quad = self._term_parts(p)
        mags = quad.double().abs()
        if log_term is not None:
            mags = torch.where(self.mask[:, None, :], mags + log_term.double().abs(),
                               torch.zeros_like(mags))
        mags = torch.nan_to_num(mags, nan=0.0, posinf=0.0)
        const = 0.0 if self.use_sigma else self.log_norm.abs()[:, None]
        return 0.5 * mags.sum(dim=-1) + const

    def log_prior(self, p):
        log_prior = 0.0
        for i, prior in enumerate(self.priors):
            log_prior = log_prior + prior(p[..., i])
        return log_prior

    def plain(self, p):
        """Plain P1: the log-posterior (S, W) float64 at absolute float64
        parameters ``p`` (S, W, ndim): -inf outside the priors."""
        log_prior = self.log_prior(p)
        return torch.where(torch.isfinite(log_prior), log_prior + self.log_likelihood(p),
                           torch.full_like(log_prior, -torch.inf))


def _map_seeded_guesses(pp, priors, p_lo, p_up, S, nwalkers, ndim, n_starts, n_iter, rng):
    """Walker starting positions around each transient's MAP: P3 runs all S
    x n_starts Adam ascents of the bounds-bijected posterior in one launch,
    then the walkers jitter in a thin band around each transient's best
    point, folded inside the prior support. Transients where every start
    ends non-finite fall back to window-uniform starts, with a warning.
    ``rng`` draws in the JAX function's order: the starts, the band jitter,
    the fallback.

    In float32 compute with the intrinsic scatter the seeding does not
    follow the JAX package's: there its float32 ascent stops far short of
    the MAP (each transient's best seeded walker's float64 log p a median
    2.27 and at worst 38.4 of the term scale below the float64 MAP's, on
    ``chip_smoke.pop_example``'s population), while the port's ascents land
    near it (the plain float32 one within 0.5 of the term scale, pinned by
    tests/test_torch_population.py; P3 within 2e-5 on the card), so a
    float32 fit with the scatter starts from other walkers than the JAX
    package's."""
    bounds = BoundsTransform([getattr(p, "p_min", -np.inf) for p in priors],
                             [getattr(p, "p_max", np.inf) for p in priors])
    x0 = rng.uniform(size=(S, n_starts, ndim)) * (p_up - p_lo) + p_lo
    u0 = torch.as_tensor(bounds.to_unbounded(x0), device=pp.device).contiguous()
    u_fin, neg_fin = kpop.map_ascent(pp, u0, bounds, n_iter)
    neg_fin = neg_fin.cpu().numpy()
    best = np.argmin(np.where(np.isfinite(neg_fin), neg_fin, np.inf), axis=1)
    x_fin = bounds.to_bounded(u_fin).cpu().numpy()
    x_map = x_fin[np.arange(S), best]

    band = 1e-3 * (p_up - p_lo)
    g = x_map[:, None, :] + band * rng.uniform(-1.0, 1.0, (S, nwalkers, ndim))
    s_lo = np.array([getattr(p, "p_min", -np.inf) for p in priors])
    s_up = np.array([getattr(p, "p_max", np.inf) for p in priors])
    g = np.where(g <= s_lo, 2 * s_lo - g + band * 1e-3, g)
    g = np.where(g >= s_up, 2 * s_up - g - band * 1e-3, g)
    g = np.clip(g, s_lo + 1e-9 * np.abs(band), s_up - 1e-9 * np.abs(band))
    dead = ~np.isfinite(neg_fin[np.arange(S), best])
    if dead.any():
        warnings.warn(f"MAP seeding found no finite posterior for {int(dead.sum())} "
                      "transient(s); falling back to window-uniform starts for those")
        fallback = rng.uniform(size=(S, nwalkers, ndim)) * (p_up - p_lo) + p_lo
        g = np.where(dead[:, None, None], fallback, g)
    return g


def _refuse_unported(mesh, checkpoint_every, checkpoint_file, resume_from):
    if mesh is not None:
        raise NotImplementedError("sharding the transients over a device mesh is not ported "
                                  "yet (ROADMAP Queue 1 item 17)")
    if checkpoint_every is not None or checkpoint_file is not None or resume_from is not None:
        raise NotImplementedError("checkpoint/resume of the population fit is not ported yet "
                                  "(ROADMAP Queue 1 item 16)")


def _percentiles(fl):
    """The (S, ndim, 3) SUMMARY_PERCENTILES of the chains ``fl`` (S, M,
    ndim) along M, float64 on the host: K5 for float32 chains on CUDA (its
    plain version on the CPU), ``torch.quantile`` for float64 ones, a few
    transients at a time within its input limit."""
    rows = fl.shape[0] if fl.dtype == torch.float32 else max(1, (1 << 24) // max(fl[0].numel(), 1))
    parts = [percentile_f32(c, SUMMARY_PERCENTILES, axis=1) for c in fl.split(rows)]
    return np.moveaxis(torch.cat(parts, dim=1).cpu().numpy(), 0, -1)


def fit_population(models, lcs, priors, p_lo, p_up, nwalkers=64, nsteps=500,
                   nsteps_burnin=500, use_sigma=False, sigma_type="relative",
                   seed=0, mesh=None, axis_name="transients", a=2.0,
                   init="window", n_map_starts=16, n_map_iter=400,
                   state_dtype="auto", checkpoint_every=None,
                   checkpoint_file=None, resume_from=None,
                   return_chains=True, summaries=False, device=None):
    """Fit every light curve with its own ensemble, all transients at once.

    Same signature and behaviour as the JAX function, plus ``device``
    (default CUDA; without it RuntimeError: pass ``"cpu"`` for the plain
    versions). ``init="map"`` seeds the walkers around each transient's MAP
    from a batched multi-start Adam ascent (P3: S x ``n_map_starts`` ascents
    of ``n_map_iter`` steps in one launch). ``state_dtype="auto"``: on CUDA
    the walker state and the chains are float32 over the rescaled [p_lo,
    p_up] window (``fitting._state_rescaling``); the returned chains are
    absolute float64. ``summaries=True`` also returns each transient's (16,
    50, 84)th percentiles (S, ndim, 3), computed on the device in the
    state's representation and mapped to absolute values on the host;
    ``return_chains=False`` (which needs ``summaries``) keeps the chains on
    the device.

    Refused with ``NotImplementedError``: ``mesh`` (ROADMAP Queue 1 item
    17); ``checkpoint_every``, ``checkpoint_file`` and ``resume_from`` (item
    16); on CUDA a ``KDEPrior`` (item 21), ShockCooling3 and
    CompanionShocking 1-3 (item 10) and ``init="map"`` over ShockCooling and
    ShockCooling4 (item 22) (:func:`check_model_class`).

    Returns (flatchains (S, nsteps * nwalkers, ndim) or None, acceptance
    (S,)) plus the (S, ndim, 3) summaries when ``summaries=True``.
    """
    if not return_chains and not summaries:
        raise ValueError("return_chains=False requires summaries=True "
                         "(nothing would be returned)")
    _refuse_unported(mesh, checkpoint_every, checkpoint_file, resume_from)
    if nwalkers % 2:
        raise ValueError("nwalkers must be even")
    from ..fitting import _state_rescaling
    device = resolve_device(device)
    check_model_class(models[0], device, init)
    ndim = len(priors)
    half = nwalkers // 2
    S = len(lcs)
    packed = pack_population(models, lcs, use_sigma, device)
    pp = PopulationPosterior(packed, models[0], priors, use_sigma, sigma_type)
    rng = np.random.default_rng(seed)
    p_lo = np.asarray(p_lo, float)
    p_up = np.asarray(p_up, float)
    state_kw = _state_rescaling(state_dtype, p_lo, p_up, device)
    q_off, q_sc = state_kw.get("param_offset"), state_kw.get("param_scale")
    sdt = state_kw.get("dtype", torch.float64)

    if init == "map":
        guesses = _map_seeded_guesses(pp, priors, p_lo, p_up, S, nwalkers, ndim, n_map_starts,
                                      n_map_iter, rng)
    elif init == "window":
        guesses = rng.uniform(size=(S, nwalkers, ndim)) * (p_up - p_lo) + p_lo
    else:
        raise ValueError('init must be "window" or "map"')
    guesses = np.asarray(guesses, float)
    if q_off is not None:
        guesses = (guesses - q_off) / q_sc
    x = torch.as_tensor(guesses, device=device).to(sdt).contiguous()
    logp = kpop.log_posterior(pp, x, q_off, q_sc).reshape(S, 2, half)
    x = x.reshape(S, 2, half, ndim)

    gen = torch.Generator(device=device)
    shape = (S, 2, half)

    def run(first, n, chain=None, n_accept=None):
        slot_lp = None if chain is None else torch.empty(shape, dtype=torch.float64,
                                                         device=device)
        n_accept = torch.zeros(shape, dtype=torch.int32, device=device) \
            if n_accept is None else n_accept
        for s in range(n):
            gen.manual_seed(_step_seed(seed, first + s))
            u_z = torch.rand(shape, generator=gen, device=device, dtype=sdt)
            j = torch.randint(0, half, shape, generator=gen, device=device)
            u_acc = torch.rand(shape, generator=gen, device=device, dtype=sdt)
            slot = None if chain is None else chain[s]
            for h in (0, 1):
                kpop.stretch_half_step(pp, x, logp, h, u_z, j, u_acc, a, q_off, q_sc, slot,
                                       slot_lp, n_accept, check_partners=False)

    run(0, nsteps_burnin)
    if nsteps <= 0:
        flat = np.empty((S, 0, ndim)) if return_chains else None
        out = (flat, np.zeros(S))
        return out + (np.full((S, ndim, 3), np.nan),) if summaries else out
    # the production chain in the state's representation: float32 q-space
    # for the rescaled state, absolute float64 otherwise
    chain = torch.empty((nsteps,) + shape + (ndim,), dtype=sdt, device=device)
    n_accept = torch.zeros(shape, dtype=torch.int32, device=device)
    run(nsteps_burnin, nsteps, chain, n_accept)
    acc = (n_accept.sum(dim=(1, 2)).to(torch.float64) / (nsteps * nwalkers)).cpu().numpy()
    fl = chain.permute(1, 0, 2, 3, 4).reshape(S, nsteps * nwalkers, ndim)
    summ = None
    if summaries:
        summ = _percentiles(fl)
        if q_off is not None:
            summ = summ * q_sc[None, :, None] + q_off[None, :, None]
    flat = None
    if return_chains:
        flat = fl.cpu().numpy().astype(np.float64)
        if q_off is not None:
            flat = flat * q_sc + q_off
    return (flat, acc, summ) if summaries else (flat, acc)


# ------------------------------------------------------------ diagnostics

def _draws(flatchains, lcs, n_draws, seed):
    """(flatchains float64 (S, M, ndim), each transient's n_draws posterior
    draws (S, n_draws, ndim), in the JAX function's rng order)."""
    flatchains = np.asarray(flatchains, float)
    S, M, _ = flatchains.shape
    if S != len(lcs):
        raise ValueError(f"flatchains has {S} transients, got {len(lcs)} lcs")
    rng = np.random.default_rng(seed)
    n_draws = min(int(n_draws), M)
    return flatchains, np.stack([fc[rng.choice(M, n_draws, replace=False)] for fc in flatchains])


def _masked_terms(models, lcs, draws, use_sigma, sigma_type, kind, device):
    """The masked copy of the variance model of ``fitting._posterior_discrepancy``
    over a packed population, float64 torch ops on ``device``: for each
    transient's draws (S, D, ndim), ``kind="chi2"`` the chi-square over its
    real points (S, D), ``kind="ll"`` the pointwise log-likelihood (S, D, N),
    0 on the padded points. The model's flux runs in the compute dtype, as
    the JAX function's does; everything after it in float64."""
    dev = resolve_device(device)
    packed = pack_population(models, lcs, use_sigma, dev)
    # no priors: the diagnostics read the flux alone
    pp = PopulationPosterior(packed, models[0], [None] * draws.shape[-1], use_sigma, sigma_type)
    yn, dyn, units, _ = (torch.as_tensor(a, device=dev) for a in _normalized(packed, sigma_type))
    p = torch.as_tensor(draws, device=dev)
    y_fit = pp.flux(p).to(torch.float64) * (1.0 / packed["yscale"])[:, None, None]
    sigma2 = (dyn ** 2.0)[:, None, :]
    if use_sigma:
        sigma2 = sigma2 + (p[..., -1:] * units[:, None, :]) ** 2.0
    mask = packed["mask"][:, None, :]
    r2 = (yn[:, None, :] - y_fit) ** 2.0 / sigma2
    if kind == "chi2":
        return torch.sum(torch.where(mask, r2, torch.zeros_like(r2)), dim=-1), packed
    ll = -0.5 * (torch.log(2.0 * np.pi * sigma2) + r2)
    return torch.where(mask, ll, torch.zeros_like(ll)), packed


def population_goodness_of_fit(models, lcs, flatchains, use_sigma=False,
                               sigma_type="relative", n_draws=256, seed=0,
                               quiet=False, device=None):
    """Per-transient posterior-predictive goodness of fit for a population:
    the survey companion of ``fitting.goodness_of_fit``, every transient's
    draws evaluated in one pass of torch operations on ``device`` (default
    CUDA) over the padded pack (ragged lengths masked).

    ``flatchains``: (S, M, ndim) posterior samples from
    :func:`fit_population`. Returns a dict of (S,) arrays: ``chi2`` (the
    best evaluated draw per transient), ``dof``, ``chi2_nu``, ``p_value``
    (posterior-predictive, analytic chi-square), ``n_points`` and
    ``n_invalid_draws`` (draws outside the model's validity window,
    excluded), as the JAX function's."""
    from scipy.stats import chi2 as _chi2_dist

    flatchains, draws = _draws(flatchains, lcs, n_draws, seed)
    S, _, ndim = flatchains.shape
    chi2_dev, packed = _masked_terms(models, lcs, draws, use_sigma, sigma_type, "chi2", device)
    chi2_all = chi2_dev.cpu().numpy()
    npts = packed["mask"].sum(dim=1).cpu().numpy()
    dof = npts - ndim
    chi2_best = np.full(S, np.nan)
    p_value = np.full(S, np.nan)
    n_bad = np.zeros(S, int)
    for s in range(S):
        finite = np.isfinite(chi2_all[s])
        n_bad[s] = int(np.sum(~finite))
        vals = chi2_all[s][finite]
        if len(vals):
            chi2_best[s] = float(np.min(vals))
            p_value[s] = float(np.mean(_chi2_dist.sf(vals, npts[s])))
    with np.errstate(invalid="ignore", divide="ignore"):
        chi2_nu = chi2_best / np.where(dof > 0, dof, np.nan)
    out = {"chi2": chi2_best, "dof": dof, "chi2_nu": chi2_nu,
           "p_value": p_value, "n_points": npts, "n_invalid_draws": n_bad}
    if not quiet:
        flagged = int(np.sum(p_value < 0.01))
        print(f"population goodness of fit: chi2_nu median {np.nanmedian(chi2_nu):.2f} over "
              f"{S} transients; {flagged} with posterior-predictive p < 0.01")
    return out


def population_information_criteria(models, lcs, flatchains, use_sigma=False,
                                    sigma_type="relative", n_draws=512,
                                    seed=0, quiet=False, device=None):
    """Per-transient WAIC and PSIS-LOO for a fitted population: the survey
    companion of ``fitting.information_criteria``. One pass of torch
    operations on ``device`` (default CUDA) gives every transient's (draws
    x points) pointwise log-likelihood over the padded pack; the host
    statistics (:mod:`.ic`) then run per transient on its real points only.

    ``flatchains``: (S, M, ndim) posterior samples from
    :func:`fit_population`. Returns, as the JAX function: (S,) arrays
    ``elpd_loo``, ``se_elpd_loo``, ``p_loo``, ``elpd_waic``,
    ``se_elpd_waic``, ``p_waic``, ``n_points``, ``n_high_pareto_k`` (points
    with k > 0.7), ``n_invalid_draws``, and lists ``pareto_k`` and
    ``pointwise`` (per-transient arrays over the real points). Log densities
    are absolute (the -log(yscale) Jacobian of the normalization restored
    per transient)."""
    from .ic import psis_loo as _psis_loo, waic as _waic

    flatchains, draws = _draws(flatchains, lcs, n_draws, seed)
    S = flatchains.shape[0]
    ll_dev, packed = _masked_terms(models, lcs, draws, use_sigma, sigma_type, "ll", device)
    ll_all = ll_dev.cpu().numpy()
    mask = packed["mask"].cpu().numpy()
    log_yscale = np.log(packed["yscale"].cpu().numpy())
    out = {k: np.full(S, np.nan) for k in
           ("elpd_loo", "se_elpd_loo", "p_loo", "elpd_waic", "se_elpd_waic", "p_waic")}
    out["n_points"] = mask.sum(axis=1)
    out["n_high_pareto_k"] = np.zeros(S, int)
    out["n_invalid_draws"] = np.zeros(S, int)
    out["pareto_k"] = [None] * S
    out["pointwise"] = [None] * S
    for s in range(S):
        ll = ll_all[s][:, mask[s]] - log_yscale[s]       # real points only
        good = np.all(np.isfinite(ll), axis=1)
        out["n_invalid_draws"][s] = int(np.sum(~good))
        ll = ll[good]
        if len(ll) < 8:
            continue                        # the chain missed the validity window
        loo = _psis_loo(ll)
        wa = _waic(ll)
        out["elpd_loo"][s] = loo["elpd_loo"]
        out["se_elpd_loo"][s] = loo["se_elpd_loo"]
        out["p_loo"][s] = loo["p_loo"]
        out["elpd_waic"][s] = wa["elpd_waic"]
        out["se_elpd_waic"][s] = wa["se_elpd_waic"]
        out["p_waic"][s] = wa["p_waic"]
        out["n_high_pareto_k"][s] = int(np.sum(loo["pareto_k"] > 0.7))
        out["pareto_k"][s] = loo["pareto_k"]
        out["pointwise"][s] = loo["pointwise"]
    if not quiet:
        n_flag = int(np.sum(out["n_high_pareto_k"] > 0))
        print(f"population information criteria: elpd_loo median "
              f"{np.nanmedian(out['elpd_loo']):.1f} over {S} transients; "
              f"{n_flag} with any pareto_k > 0.7")
    return out


def population_compare_elpd(ics, labels, quiet=False):
    """Survey-level model comparison: per-transient paired elpd rankings and
    Yao+18 stacking weights across K model families, each family's
    :func:`population_information_criteria` scored on the same transients.

    Returns, as the JAX function: ``elpd_loo`` (K, S), ``d_elpd`` and
    ``se_d_elpd`` (K, S, against each transient's best), ``stacking_weight``
    (K, S), ``best`` (S,), the survey totals ``total_elpd``,
    ``total_d_elpd``, ``total_se_d_elpd`` (K,, paired over all points of all
    transients) and ``n_best`` (K,), the compared ``transients`` and the
    ``skipped`` ones (no finite scores in some family)."""
    from .ic import stacking_weights

    K = len(ics)
    if K != len(labels) or len(set(map(str, labels))) != K:
        raise ValueError("labels must be one per model family and unique")
    S = len(ics[0]["pointwise"])
    for ic in ics:
        if len(ic["pointwise"]) != S:
            raise ValueError("families were scored on different numbers of transients")
    skipped = [s for s in range(S) if any(ic["pointwise"][s] is None for ic in ics)]
    if skipped and not quiet:
        print(f"excluding {len(skipped)} transient(s) with no finite scores "
              f"in at least one family: {skipped}")
    kept = [s for s in range(S) if s not in set(skipped)]
    if not kept:
        raise ValueError("no transient has finite scores in every family")
    ics = [{"pointwise": [ic["pointwise"][s] for s in kept]} for ic in ics]
    S = len(kept)
    elpd = np.empty((K, S))
    d_elpd = np.empty((K, S))
    se_d = np.empty((K, S))
    w = np.empty((K, S))
    for s in range(S):
        pw = [np.asarray(ic["pointwise"][s], float) for ic in ics]
        n = {len(p) for p in pw}
        if len(n) != 1:
            raise ValueError(f"transient {s} was scored on different numbers of points "
                             f"across families ({sorted(n)})")
        N = n.pop()
        elpd[:, s] = [p.sum() for p in pw]
        best = int(np.argmax(elpd[:, s]))
        for k in range(K):
            diff = pw[k] - pw[best]
            d_elpd[k, s] = elpd[k, s] - elpd[best, s]
            se_d[k, s] = (float(np.sqrt(N * np.var(diff, ddof=1)))
                          if k != best and N > 1 else 0.0)
        w[:, s] = stacking_weights(pw)
    best_idx = np.argmax(elpd, axis=0)

    all_pw = [np.concatenate([np.asarray(ic["pointwise"][s], float) for s in range(S)])
              for ic in ics]
    total = np.array([p.sum() for p in all_pw])
    tbest = int(np.argmax(total))
    N_all = len(all_pw[0])
    total_se = np.array([float(np.sqrt(N_all * np.var(all_pw[k] - all_pw[tbest], ddof=1)))
                         if k != tbest and N_all > 1 else 0.0 for k in range(K)])
    out = {"labels": list(labels), "elpd_loo": elpd, "d_elpd": d_elpd,
           "se_d_elpd": se_d, "stacking_weight": w, "best": best_idx,
           "total_elpd": total, "total_d_elpd": total - total[tbest],
           "total_se_d_elpd": total_se,
           "n_best": np.bincount(best_idx, minlength=K),
           "transients": np.asarray(kept), "skipped": np.asarray(skipped)}
    if not quiet:
        order = np.argsort(-total)
        print(f"survey model comparison over {S} transients (best first):")
        for k in order:
            print(f"  {labels[k]}: total elpd_loo = {total[k]:.1f} "
                  f"(d = {total[k] - total[tbest]:.1f} +/- {total_se[k]:.1f}), "
                  f"best on {out['n_best'][k]}/{S} transients, "
                  f"mean stacking weight {w[k].mean():.3f}")
    return out
