"""Bolometric light curves from per-epoch blackbody SED fits (the port of
``lightcurve_fitting_tpu/bolometric.py``).

``calculate_bolometric`` fits one epoch at a time by default
(``batch_mode=False``): each epoch's stretch-move ensemble runs through
:func:`spectrum_mcmc` over :class:`SEDLogPosterior`, on CUDA through the SED
kernel K10 (``kernels/csrc/sed.cu``: the log-posterior and the half-step, the
KDE prior of the single-filter epochs inside it). ``batch_mode=True`` fits
every multi-filter epoch before the first single-filter one at once on the
device (``parallel/batched.py``): the MAP centers through K4 and its
gradient, the per-epoch ensembles through the epoch half-step kernel, and
the posterior summaries through K4s and K5 (``kernels/csrc/epoch_bb.cu``,
``kernels/csrc/quantile.cu``). KDE prior chaining into single-filter epochs
(``min_nfilt < 2``) runs in both modes. The estimators that run on the host
(bounded least squares, direct SED integration, colors) are numpy/scipy
copies of the JAX package's.

Not in this slice of the port, and refused with NotImplementedError naming
their ROADMAP Queue 1 item: corner plots and the other figures
(``save_corners=True``, ``show=True``, ``make_corner=True``,
``plot_bolometric_results``, ``plot_color_curves``, ``plot_chain``,
``spectrum_corner``: item 18), sharding the epochs over a mesh (item 17),
and on CUDA the quadrature SED form of a reddened ``planck_fast``
(``ebv != 0``: item 20).
"""

import os
import warnings

import numpy as np
from scipy.optimize import curve_fit, OptimizeWarning

import torch

from .core import config
from .core.constants import sigma_sb
from .core.device import resolve_device
from .filters import filtdict, extinction_law
from .lightcurve import LC
from .models.base import intrinsic_scatter_units
from .models.blackbody import planck_fast, planck_lnu
from .models.priors import GaussianPrior, KDEPrior, LogUniformPrior, UniformPrior
from .ops.bandtable import chebyshev_bandflux
from .ops.filterbank import bank_for, band_table_for
from .utils import units as u

__all__ = ["calculate_bolometric", "spectrum_mcmc", "SEDLogPosterior", "blackbody_lstsq",
           "integrate_sed", "pseudo", "stefan_boltzmann", "group_by_epoch", "median_and_unc",
           "calc_colors"]

DEPRECATED_BOLOMETRIC_COLNAMES = [  # (old, new)
    ("L_opt", "L"),
    ("lum", "L_bol"),
    ("dlum", "dL_bol"),
    ("dtemp0", "dtemp_mcmc0"),
    ("dtemp1", "dtemp_mcmc1"),
    ("dradius0", "dradius_mcmc0"),
    ("dradius1", "dradius_mcmc1"),
]


def _trapezoid(y, x=None):
    trap = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2 names it trapz
    return trap(y) if x is None else trap(y, x)


def pseudo(temp, radius, z, filter0=filtdict["I"], filter1=filtdict["U"], cutoff_freq=np.inf):
    """Pseudobolometric luminosity: blackbody integrated between two filters on
    a 1-THz grid (reference bolometric.py:32-59). Default U to I."""
    freq0 = filter0.freq_eff.value - filter0.dfreq.value / 2.0
    freq1 = filter1.freq_eff.value + filter1.dfreq.value / 2.0
    x_optical = np.arange(freq0, freq1)
    y_optical = planck_fast(x_optical * (1.0 + z), temp, radius, cutoff_freq)
    return _trapezoid(y_optical) * 1e12  # dx = 1 THz


def _snap_to_grid(mjd, res):
    """Round times onto a ``res``-day grid whose phase is chosen so the
    typical observation lands mid-cell (keeps nightly cadences together even
    when nights straddle integer MJDs)."""
    scaled = np.asarray(mjd, float) / res
    typical_frac = np.median(scaled - np.trunc(scaled))
    return np.round(scaled - typical_frac + np.round(typical_frac)) * res


def group_by_epoch(lc, res=1.0, also_group_by=()):
    """Split photometry into single-SED epochs at resolution ``res`` days,
    ordered by median MJD; rows with a manual 'epoch' value keep it
    (behavioral spec: reference bolometric.py:383-416)."""
    epochs = lc.get("epoch").astype(float)
    missing = np.ma.getmaskarray(epochs)
    if missing.any():
        epochs[missing] = _snap_to_grid(np.asarray(lc["MJD"], float)[missing], res)
    lc["epoch"] = np.ma.filled(epochs)
    for col in also_group_by:
        if np.ma.is_masked(lc[col]):
            lc[col] = lc[col].filled()
    grouped = lc.group_by(["epoch", *also_group_by])
    order = np.argsort([np.median(np.asarray(g["MJD"], float)) for g in grouped.groups])
    return [grouped.groups[i] for i in order]


def stefan_boltzmann(temp, radius, dtemp=None, drad=None, covTR=None):
    """L = 4 pi R^2 sigma T^4 (W; T in kK, R in 1000 Rsun), optionally with
    first-order error propagation through dL/dR = 2L/R and dL/dT = 4L/T
    (behavioral spec: reference bolometric.py:422-453)."""
    temp = np.asarray(temp)
    radius = np.asarray(radius)
    lum = 4.0 * np.pi * sigma_sb * radius ** 2 * temp ** 4
    if dtemp is None or drad is None or covTR is None:
        return lum
    dl_dr = 2.0 * lum / radius
    dl_dt = 4.0 * lum / temp
    var = dl_dr ** 2 * drad ** 2 + dl_dt ** 2 * dtemp ** 2 + 2.0 * dl_dr * dl_dt * covTR
    return lum, np.sqrt(var)


def median_and_unc(x, perc_contained=68.0):
    """Median and the half-widths of the equal-tailed ``perc_contained``%
    interval (behavioral spec: reference bolometric.py:456-480)."""
    tail = (100.0 - perc_contained) / 2.0
    lo, med, hi = np.percentile(np.asarray(x, float), [tail, 50.0, 100.0 - tail], axis=0)
    return med, med - lo, hi - med


def blackbody_lstsq(epoch1, z, p0=None, T_range=(1.0, 100.0), R_range=(0.01, 1000.0),
                    cutoff_freq=np.inf):
    """chi^2 blackbody fit of one epoch via bounded least squares (reference
    bolometric.py:483-534)."""
    if p0 is None:
        p0 = [10.0, 10.0]

    def planck_cutoff(nu, T, R):
        return planck_fast(nu, T, R, cutoff_freq)

    lo = [T_range[0] if np.isfinite(T_range[0]) else 0.0,
          R_range[0] if np.isfinite(R_range[0]) else 0.0]
    hi = [T_range[1] if np.isfinite(T_range[1]) else np.inf,
          R_range[1] if np.isfinite(R_range[1]) else np.inf]
    with warnings.catch_warnings():
        if len(epoch1) <= 2:
            warnings.simplefilter("ignore", OptimizeWarning)
        p0, cov = curve_fit(planck_cutoff, np.asarray(epoch1["freq"], float) * (1.0 + z),
                            np.asarray(epoch1["lum"], float), p0=p0, bounds=(lo, hi))
    temp, radius = p0
    dtemp, drad = np.sqrt(np.diag(cov))
    lum, dlum = stefan_boltzmann(temp, radius, dtemp, drad, cov[0, 1])
    L_opt = pseudo(temp, radius, z, cutoff_freq=cutoff_freq)
    return temp, radius, dtemp, drad, lum, dlum, L_opt


def integrate_sed(epoch1):
    """Trapezoidal integral of the observed SED, zero-padded by one effective
    bandwidth at each end (reference bolometric.py:537-557). Returns watts."""
    epoch1.sort("freq")
    freq = np.asarray(epoch1["freq"], float)
    dfreq = np.asarray(epoch1["dfreq"], float)
    lum = np.asarray(epoch1["lum"], float)
    freqs = np.concatenate([[freq[0] - dfreq[0]], freq, [freq[-1] + dfreq[-1]]])
    lums = np.concatenate([[0.0], lum, [0.0]])
    return _trapezoid(lums, freqs) * 1e12  # W/Hz * THz -> W


def _one_color(epoch1, color):
    """(value, uncertainty, lolim, uplim) for one color string like 'B-V'.
    Missing bands give a fully-masked entry; two nondetections give an
    unconstrained color; one nondetection becomes a one-sided limit."""
    blue, red = (filtdict[name] for name in color.split("-"))
    available = list(epoch1["filter"])
    if blue not in available or red not in available:
        return np.nan, np.nan, True, True
    rows = {f: epoch1.where(filter=f)[["absmag", "dmag", "nondet"]][0]
            for f in (blue, red)}
    (m_b, dm_b, lim_b), (m_r, dm_r, lim_r) = rows[blue], rows[red]
    value = np.nan if (lim_b and lim_r) else m_b - m_r
    return value, np.hypot(dm_b, dm_r), bool(lim_b), bool(lim_r)


def calc_colors(epoch1, colors):
    """Colors from one epoch's SED, with nondetection limit flags
    (behavioral spec: reference bolometric.py:560-605)."""
    results = [_one_color(epoch1, color) for color in colors]
    if not results:
        return [], [], [], []
    mags, dmags, lolims, uplims = (list(col) for col in zip(*results))
    return mags, dmags, lolims, uplims


class SEDLogPosterior:
    """The log-posterior of a blackbody (``planck_fast``) fit to one epoch's
    photometry (the JAX package's ``_make_sed_log_posterior``,
    bolometric.py:81-140), batched over walkers: ``lp(p)`` maps absolute
    parameters (W, ndim) to (W,) float64. Any other spectrum function runs
    on the host (:func:`spectrum_mcmc`).

    The luminosities are divided by ``yscale`` (the median of the nonzero
    |lum|), and ``offset = -N log(yscale)`` restores the likelihood's
    normalization. Two forms, as in the JAX package:

    * ``"table"``: ``planck_fast`` without reddening (``ebv`` 0). The band
      integral factorizes, so each point is one lookup of the epoch's
      Chebyshev band table, ``R^2 exp(ln g(ln T))``
      (``ops/bandtable.py::chebyshev_bandflux``, in the compute dtype of
      ``device``). On CUDA this form runs the SED kernel K10
      (``kernels/sed.py``).
    * ``"quadrature"``: ``planck_fast`` with ``ebv != 0``: the Planck sum
      over each band's emitted-frame nodes times the extinction factor, in
      float64. Plain PyTorch only; CUDA raises (ROADMAP Queue 1 item 20).

    The Gaussian likelihood carries the full ``log(2 pi sigma^2)`` sum, with
    the intrinsic scatter ``p[-1]`` in units of ``sigma_type`` when
    ``use_sigma``; a non-finite likelihood is -inf, as is any state outside
    the priors.
    """

    def __init__(self, epoch1, priors, z=0.0, ebv=0.0, spectrum_kwargs=None, use_sigma=False,
                 sigma_type="relative", device="cpu"):
        device = torch.device(device)
        spectrum_kwargs = dict(spectrum_kwargs or {})
        y_np = np.asarray(epoch1["lum"], float)
        dy_np = np.asarray(epoch1["dlum"], float)
        # O(1) data scale for float32 safety (see models/base.py)
        yscale = float(np.median(np.abs(y_np[y_np != 0]))) if np.any(y_np != 0) else 1.0
        self.offset = -len(y_np) * np.log(yscale)
        self.inv_yscale = 1.0 / yscale
        self.priors = list(priors)
        self.use_sigma = bool(use_sigma)
        self.spectrum_kwargs = spectrum_kwargs
        self.compute_dtype = config.get_compute_dtype(device) or torch.float64

        def f64(a):
            return torch.tensor(np.asarray(a, float), dtype=torch.float64, device=device)

        self.y = f64(y_np / yscale)
        self.dy = f64(dy_np / yscale)
        self.sigma_units = f64(np.broadcast_to(
            intrinsic_scatter_units(dy_np / yscale, sigma_type), y_np.shape))
        filters = list(epoch1["filter"])
        bank = bank_for(sorted(set(filters)))
        ids = bank.band_ids(filters)
        if not np.any(ebv):
            # blackbody: the band integral factorizes -> per-band Chebyshev
            # of ln g(ln T)
            self.form = "table"
            table = band_table_for(bank, z=z,
                                   cutoff_freq=spectrum_kwargs.get("cutoff_freq", np.inf))
            coef, s_a, s_b = table.gather(ids, device=False)
            cdt = self.compute_dtype
            self.coef = torch.as_tensor(coef, device=device).to(cdt).contiguous()
            self.s_a = torch.as_tensor(s_a, device=device).to(cdt).contiguous()
            self.s_b = torch.as_tensor(s_b, device=device).to(cdt).contiguous()
        else:
            self.form = "quadrature"
            nodes, weights, _ = bank.gather(ids, z=z, device=False)
            self.nodes, self.weights = f64(nodes), f64(weights)
            ext = extinction_law(np.asarray(bank.emitted_nodes(z)[ids]).ravel(), ebv)
            self.ext = f64(np.reshape(ext, nodes.shape))

    @property
    def ndim(self):
        return len(self.priors)

    @property
    def kernel_module(self):
        """The kernel module that evaluates this log-posterior on CUDA:
        :mod:`.kernels.sed` (K10)."""
        from .kernels import sed
        return sed

    def log_prior(self, p):
        """The summed prior log-densities (W,) float64 at ``p`` (W, ndim)."""
        log_prior = 0.0
        for i, prior in enumerate(self.priors):
            log_prior = log_prior + prior(p[:, i])
        return log_prior

    def band_flux(self, p):
        """The model's band-averaged L_nu / yscale (W, N) float64 at ``p``."""
        if self.form == "table":
            shape = (p.shape[0], self.y.shape[0])
            return chebyshev_bandflux(self.coef, p[:, 0:1].expand(shape),
                                      p[:, 1:2].expand(shape), self.s_a,
                                      self.s_b) * self.inv_yscale
        lnu = planck_lnu(self.nodes, p[:, 0, None, None], p[:, 1, None, None],
                         **self.spectrum_kwargs) * self.ext
        return torch.sum(self.weights * lnu, dim=-1) * self.inv_yscale

    def residual_terms(self, p):
        """Each point's log(2 pi sigma^2) + (y - y_fit)^2 / sigma^2, (W, N)."""
        y_fit = self.band_flux(p)
        if self.use_sigma:
            sigma2 = self.dy ** 2.0 + (p[:, -1:] * self.sigma_units) ** 2.0
        else:
            sigma2 = self.dy ** 2.0
        return torch.log(2 * np.pi * sigma2) + (self.y - y_fit) ** 2.0 / sigma2

    def forward_plain(self, p):
        """The plain PyTorch log-posterior (W,) float64 at ``p`` (W, ndim),
        on any device (the version beside K10 and the CPU path)."""
        p = p.to(torch.float64)
        log_prior = self.log_prior(p)
        ll = -0.5 * torch.sum(self.residual_terms(p), dim=-1) + self.offset
        ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -torch.inf))
        return torch.where(torch.isfinite(log_prior), log_prior + ll,
                           torch.full_like(ll, -torch.inf))

    def term_scales(self, p):
        """The magnitude the log-posterior's rounding scales with, (W,):
        0.5 x the summed residual terms' magnitudes, plus |offset| and the
        prior's magnitude."""
        p = p.to(torch.float64)
        terms = self.residual_terms(p).abs()
        terms = torch.where(torch.isfinite(terms), terms, torch.zeros_like(terms))
        prior = self.log_prior(p).abs()
        prior = torch.where(torch.isfinite(prior), prior, torch.zeros_like(prior))
        return 0.5 * terms.sum(-1) + abs(self.offset) + prior

    def __call__(self, p):
        """The log-posterior (W,) float64 at absolute parameters ``p`` (W,
        ndim): K10 on CUDA, the plain version on the CPU."""
        from . import kernels
        return kernels.log_posterior(self, p)


def _host_log_posterior(spectrum, epoch1, priors, z, ebv, spectrum_kwargs, use_sigma,
                        sigma_type):
    """The JAX package's host log-posterior (bolometric.py:186-204): numpy,
    one walker at a time, each band through ``Filter.synthesize``."""
    filters = list(epoch1["filter"])
    y_np = np.asarray(epoch1["lum"], float)
    dy_np = np.asarray(epoch1["dlum"], float)
    sigma_units = intrinsic_scatter_units(dy_np, sigma_type)

    def log_posterior_host(p):
        log_prior = 0.0
        for prior, p_i in zip(priors, p):
            log_prior += float(prior(p_i))
        if np.isinf(log_prior):
            return log_prior
        y_fit = np.array([f.synthesize(spectrum, *p[: -1 if use_sigma else None],
                                       z=z, ebv=ebv, **spectrum_kwargs) for f in filters])
        sigma = np.sqrt(dy_np ** 2 + (p[-1] * sigma_units) ** 2) if use_sigma else dy_np
        ll = -0.5 * np.sum(np.log(2 * np.pi * sigma ** 2) + ((y_np - y_fit) / sigma) ** 2)
        return log_prior + ll

    return log_posterior_host


def spectrum_mcmc(spectrum, epoch1, priors, starting_guesses, z=0.0, ebv=0.0,
                  spectrum_kwargs=None, show=False, outpath=".", nwalkers=10,
                  burnin_steps=200, steps=100, save_chains=False, use_sigma=False,
                  sigma_type="relative", labels=None, freq_min=100.0, freq_max=1000.0,
                  seed=None, make_corner=True, device=None):
    """Fit an SED function to one epoch of photometry with ensemble MCMC
    (reference bolometric.py:87-190), with the JAX package's signature plus
    ``device`` (default: CUDA when present).

    ``planck_fast`` runs the device sampler over :class:`SEDLogPosterior`:
    on CUDA every log-posterior and half-step is K10 (a failure there
    raises, as the JAX package's device path does), on the CPU the plain
    versions. Any other spectrum function takes the JAX package's host path,
    with its loud warning: the numpy stretch move
    (:class:`~.parallel.host_sampler.HostEnsembleSampler`) over
    ``Filter.synthesize``, orders of magnitude slower. An odd ``nwalkers``
    is made even by repeating the last starting guess. ``save_chains``
    writes the flat chain to ``outpath/<median MJD>.npy``.

    Not ported yet, and refused with NotImplementedError before any work:
    ``make_corner=True`` and ``show=True`` (ROADMAP Queue 1 item 18).
    """
    if make_corner:
        raise NotImplementedError("the corner plot of spectrum_mcmc (make_corner=True) is not "
                                  "ported yet (ROADMAP Queue 1 item 18); pass make_corner=False")
    if show:
        raise NotImplementedError("chain plots (show=True) are not ported yet "
                                  "(ROADMAP Queue 1 item 18)")
    mjdavg = float(np.median(np.asarray(epoch1["MJD"], float)))
    if spectrum_kwargs is None:
        spectrum_kwargs = {}
    # drop a non-finite cutoff: the table's and planck_lnu's default
    sk = {k: v for k, v in spectrum_kwargs.items() if not (k == "cutoff_freq" and np.isinf(v))}

    ndim = len(priors)
    if nwalkers % 2:
        nwalkers += 1
        starting_guesses = np.vstack([starting_guesses, starting_guesses[-1:]])
    if spectrum is planck_fast:
        from .parallel.sampler import EnsembleSampler
        dev = resolve_device(device)
        log_posterior = SEDLogPosterior(epoch1, priors, z, ebv, sk, use_sigma, sigma_type,
                                        device=dev)
        sampler = EnsembleSampler(nwalkers, ndim, log_posterior, seed=seed, device=dev)
    else:
        from .parallel.host_sampler import HostEnsembleSampler
        warnings.warn(
            f"device SED path unavailable for spectrum function "
            f"{getattr(spectrum, '__name__', spectrum)!r} (the port's kernels evaluate "
            f"planck_fast only); falling back to the host sampler (reference-parity path, "
            f"orders of magnitude slower)")
        sampler = HostEnsembleSampler(nwalkers, ndim,
                                      _host_log_posterior(spectrum, epoch1, priors, z, ebv, sk,
                                                          use_sigma, sigma_type), seed=seed)
    pos, _, _ = sampler.run_mcmc(starting_guesses, burnin_steps, skip_initial_state_check=True)
    sampler.reset()
    # continue from the burn-in's last state: the positions and their
    # log-posteriors that run_mcmc(pos) would recompute, bit for bit
    sampler.run_mcmc(None, steps, skip_initial_state_check=True)

    os.makedirs(outpath, exist_ok=True)
    if save_chains:
        chain_filename = os.path.join(outpath, f"{mjdavg:.3f}.npy")
        np.save(chain_filename, sampler.flatchain)
    return sampler


class _FlatchainSampler:
    """Minimal sampler shim so batched results feed the same downstream code
    (chain saving, KDE chaining) as the sequential path."""

    def __init__(self, flatchain):
        self.flatchain = flatchain


# result-table schema (names and dtypes follow the reference's documented
# output, bolometric.py:712-726); per-color and source columns are appended
_SED_FIT_COLUMNS = (
    ("MJD", float), ("dMJD0", float), ("dMJD1", float),
    ("temp", float), ("radius", float), ("dtemp", float), ("dradius", float),
    ("L_bol", float), ("dL_bol", float), ("L", float),
    ("temp_mcmc", float), ("radius_mcmc", float),
    ("dtemp_mcmc0", float), ("dtemp_mcmc1", float),
    ("dradius_mcmc0", float), ("dradius_mcmc1", float),
    ("L_bol_mcmc", float), ("dL_bol_mcmc0", float), ("dL_bol_mcmc1", float),
    ("L_mcmc", float), ("dL_mcmc0", float), ("dL_mcmc1", float),
    ("L_int", float), ("npoints", int),
)

_LSTSQ_FIELDS = ("temp", "radius", "dtemp", "dradius", "L_bol", "dL_bol", "L")
_MCMC_FIELDS = ("temp_mcmc", "radius_mcmc", "dtemp_mcmc0", "dtemp_mcmc1",
                "dradius_mcmc0", "dradius_mcmc1", "L_bol_mcmc", "dL_bol_mcmc0",
                "dL_bol_mcmc1", "L_mcmc", "dL_mcmc0", "dL_mcmc1")


def _result_table(colors, with_source):
    names = [name for name, _ in _SED_FIT_COLUMNS]
    dtypes = [dt for _, dt in _SED_FIT_COLUMNS]
    for template, dt in ((("{}"), float), (("d({})"), float),
                         (("lolims({})"), bool), (("uplims({})"), bool)):
        names += [template.format(c) for c in colors]
        dtypes += [dt] * len(colors)
    names.append("filts")
    dtypes.append("S6")
    if with_source:
        names.append("source")
        dtypes.append(object)
    return LC(names=names, dtype=dtypes, masked=True)


def _missing(value):
    """Mask rule for one result cell: numpy-masked values, NaN floats, and
    empty strings are masked; booleans never are."""
    if np.ma.is_masked(value):
        # a masked scalar would otherwise fall through every test below as
        # "present" and expose its fill value in the output table
        return True
    if isinstance(value, (bool, np.bool_, int, np.integer)):
        return False
    if isinstance(value, (str, bytes)):
        return not value
    try:
        return bool(np.isnan(value))
    except TypeError:
        return not bool(value)


def _append_record(t0, record):
    values = [record[name] for name in t0.colnames]
    t0.add_row(values, mask=[_missing(v) for v in values])


def _lstsq_record(epoch1, z, p0, priors, cutoff_freq):
    """Bounded least-squares stage; optimization failure degrades to masked
    cells, not a crash (reference bolometric.py:767-771)."""
    T_range = (priors[0].p_min, priors[0].p_max)
    R_range = (priors[1].p_min, priors[1].p_max)
    try:
        fitted = blackbody_lstsq(epoch1, z, p0, T_range, R_range, cutoff_freq)
        return dict(zip(_LSTSQ_FIELDS, fitted)), np.array(fitted[:2])
    except RuntimeError:
        return {field: np.nan for field in _LSTSQ_FIELDS}, p0


def _mcmc_record(flatchain, z, cutoff_freq):
    """Posterior summaries of the MCMC stage from host chains: T/R medians
    with asymmetric errors, plus Stefan-Boltzmann and pseudobolometric
    luminosity sample distributions (reference bolometric.py:786-798)."""
    bol_samples = stefan_boltzmann(flatchain[:, 0], flatchain[:, 1])
    opt_samples = pseudo(flatchain[:, 0], flatchain[:, 1], z, cutoff_freq=cutoff_freq)
    (T, R), (dT0, dR0), (dT1, dR1) = median_and_unc(flatchain[:, :2])
    L_bol, dL_bol0, dL_bol1 = median_and_unc(bol_samples)
    L_opt, dL_opt0, dL_opt1 = median_and_unc(opt_samples)
    return {"temp_mcmc": T, "radius_mcmc": R,
            "dtemp_mcmc0": dT0, "dtemp_mcmc1": dT1,
            "dradius_mcmc0": dR0, "dradius_mcmc1": dR1,
            "L_bol_mcmc": L_bol, "dL_bol_mcmc0": dL_bol0, "dL_bol_mcmc1": dL_bol1,
            "L_mcmc": L_opt, "dL_mcmc0": dL_opt0, "dL_mcmc1": dL_opt1}


def _pseudo_grid(filter0=filtdict["I"], filter1=filtdict["U"]):
    """The observed-frame 1-THz integration grid ``pseudo`` uses (reference
    bolometric.py:32-59), shared with the on-device batched summaries so
    both paths integrate the same frequencies."""
    freq0 = filter0.freq_eff.value - filter0.dfreq.value / 2.0
    freq1 = filter1.freq_eff.value + filter1.dfreq.value / 2.0
    return np.arange(freq0, freq1)


def _summary_record(summ_row):
    """The ``_mcmc_record`` fields from one epoch's on-device summary row
    (``batched_blackbody_mcmc(summaries=...)``): rows (T, R, R^2T^4,
    pseudo/1e12), columns (16th, 50th, 84th percentile). The unit constants
    are applied here, on the host; percentiles commute with the positive
    scaling."""
    (T_lo, T, T_hi), (R_lo, R, R_hi), u_, s = summ_row
    L_bol = 4.0 * np.pi * sigma_sb * np.asarray(u_)
    L_opt = 1e12 * np.asarray(s)
    return {"temp_mcmc": T, "radius_mcmc": R,
            "dtemp_mcmc0": T - T_lo, "dtemp_mcmc1": T_hi - T,
            "dradius_mcmc0": R - R_lo, "dradius_mcmc1": R_hi - R,
            "L_bol_mcmc": L_bol[1], "dL_bol_mcmc0": L_bol[1] - L_bol[0],
            "dL_bol_mcmc1": L_bol[2] - L_bol[1],
            "L_mcmc": L_opt[1], "dL_mcmc0": L_opt[1] - L_opt[0],
            "dL_mcmc1": L_opt[2] - L_opt[1]}


def _color_record(epoch1, colors):
    mags, dmags, lolims, uplims = calc_colors(epoch1, colors)
    record = {}
    for c, mag, dmag, lo, up in zip(colors, mags, dmags, lolims, uplims):
        record[c] = mag
        record[f"d({c})"] = dmag
        record[f"lolims({c})"] = lo
        record[f"uplims({c})"] = up
    return record


def _prepare_epoch_seds(lc, res, also_group_by):
    """Per epoch: flux -> single bin -> mags -> luminosities, plus effective
    frequencies (reference bolometric.py:736-740)."""
    groups = []
    for epoch1 in group_by_epoch(lc, res, also_group_by):
        epoch1.calcFlux()
        epoch1 = epoch1.bin(delta=np.inf)
        epoch1.calcMag()
        epoch1.calcAbsMag()
        epoch1.calcLum()
        epoch1["freq"] = np.array([f.freq_eff.value for f in epoch1["filter"]])
        epoch1["dfreq"] = np.array([f.dfreq.value for f in epoch1["filter"]])
        epoch1["freq"].unit = u.THz
        epoch1["lum"].unit = u.W / u.Hz
        epoch1["dlum"].unit = u.W / u.Hz
        groups.append(epoch1)
    return groups


def _refuse_unported(save_corners, show, mesh):
    if save_corners:
        raise NotImplementedError("corner plots (save_corners=True) are not ported yet "
                                  "(ROADMAP Queue 1 item 18); pass save_corners=False")
    if show:
        raise NotImplementedError("chain plots (show=True) are not ported yet "
                                  "(ROADMAP Queue 1 item 18)")
    if mesh is not None and mesh is not False:
        raise NotImplementedError("sharding the epochs over a device mesh is not ported yet "
                                  "(ROADMAP Queue 1 item 17)")


def _n_detected(epoch1):
    return len(set(epoch1.where(nondet=False)["filter"]))


def calculate_bolometric(lc, z=0.0, outpath=".", res=1.0, nwalkers=10, burnin_steps=200,
                         steps=100, priors=None, save_table_as=None, min_nfilt=3,
                         cutoff_freq=np.inf, show=False, colors=None, do_mcmc=True,
                         save_chains=False, use_sigma=False, sigma_type="relative",
                         also_group_by=(), seed=None, save_corners=True,
                         batch_mode=False, mesh=None, device=None):
    """Full bolometric light curve from broadband photometry (behavioral
    spec: reference bolometric.py:648-832), with the JAX package's
    signature plus ``device`` (default: CUDA when present).

    Each epoch with at least ``min_nfilt`` detected filters gets a row: the
    bounded least-squares blackbody (curve_fit), the MCMC percentiles of T,
    R and the luminosities, the direct SED integral and colors. By default
    (``batch_mode=False``) the epochs are fitted one after another through
    :func:`spectrum_mcmc` on ``device`` (on CUDA through K10), each seeded
    from ``seed`` and its index, its walkers started around the least-squares
    solution. A single-filter epoch (``min_nfilt < 2``) takes the previous
    epoch's temperature posterior as its temperature prior (a
    :class:`~.models.priors.KDEPrior`, kept for every later epoch) and starts
    from that chain's medians (KDE chaining, reference bolometric.py:753-759).
    ``batch_mode=True`` fits the multi-filter epochs before the first
    single-filter one (all of them when ``min_nfilt >= 2``) at once on the
    device: MAP centers, then one stretch-move ensemble per epoch, then the
    posterior summaries, through the epoch kernels on CUDA; the later epochs
    run sequentially, so the chaining is preserved. The starting guesses are
    drawn with host numpy from ``seed`` as in the JAX package.
    ``save_chains=True`` saves each epoch's chain with ``np.save``.

    Not ported yet, and refused with NotImplementedError:
    ``save_corners=True`` and ``show=True`` (ROADMAP Queue 1 item 18), a
    ``mesh`` (item 17).
    """
    _refuse_unported(save_corners, show, mesh)
    if z:
        warnings.warn('The z keyword is deprecated. Include the redshift in `lc.meta["redshift"]` instead.')
    z = lc.meta.get("redshift", z)
    dev = resolve_device(device)

    colors = list(colors) if colors is not None else []
    use_src = "source" in lc.colnames
    t0 = _result_table(colors, use_src)

    if priors is None:
        priors = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]
        if use_sigma:
            priors.append(GaussianPrior(0.0, 10.0))
    else:
        # copy: KDE chaining rebinds priors[0] below, which must not leak into
        # a caller-owned list
        priors = list(priors)

    sampler = None
    finite = np.isfinite(np.ma.filled(np.ma.MaskedArray(lc["dmag"]).astype(float), np.nan))
    lc = lc[finite & np.ma.filled(np.ma.MaskedArray(lc["dmag"]) > 0.0, False)]
    rng = np.random.default_rng(seed)

    groups = _prepare_epoch_seds(lc, res, also_group_by)

    # batch mode: fit the multi-filter epochs concurrently on the device
    batched_chains = {}
    batched_summaries = {}
    if batch_mode and do_mcmc:
        from .parallel.batched import (batched_blackbody_mcmc, batched_map_centers,
                                       pack_epochs)
        # KDE chaining (min_nfilt <= 1): a single-filter epoch replaces the
        # temperature prior for every later epoch, so only the epochs before
        # the first single-filter one batch; the rest fit sequentially
        chain_cut = len(groups)
        if min_nfilt <= 1:
            for i, ep in enumerate(groups):
                if _n_detected(ep) == 1:
                    chain_cut = i
                    break
        eligible = [i for i, ep in enumerate(groups[:chain_cut])
                    if _n_detected(ep) >= min_nfilt and _n_detected(ep) > 1]
        if eligible:
            all_filts = sorted({f for i in eligible for f in groups[i]["filter"]})
            bank = bank_for(all_filts)
            packed = pack_epochs([groups[i] for i in eligible], bank, z, device=dev)
            ndim = len(priors)
            # center each epoch's walkers on its MAP; non-converged epochs
            # fall back to the default p0, the curve_fit-RuntimeError degrade
            centers = batched_map_centers(packed, priors, cutoff_freq, use_sigma, sigma_type,
                                          seed=seed if seed is not None else 0)
            # the stretch move needs an even walker count
            nw_batch = nwalkers + (nwalkers % 2)
            guesses = rng.normal(size=(len(eligible), nw_batch, ndim)) + centers[:, None, :]
            guesses[guesses <= 0.0] = 1.0
            # the chains come to the host only when something needs them:
            # saved chains, or KDE chaining into a later single-filter epoch
            need_chains = bool(save_chains or min_nfilt < 2)
            flat, _acc, summ = batched_blackbody_mcmc(
                packed, priors, guesses, nw_batch, burnin_steps, steps,
                cutoff_freq, use_sigma, sigma_type,
                seed=seed if seed is not None else 0,
                summaries={"z": z, "pseudo_nu": _pseudo_grid()},
                return_chains=need_chains)
            batched_summaries = {i: summ[j] for j, i in enumerate(eligible)}
            if flat is not None:
                batched_chains = {i: flat[j] for j, i in enumerate(eligible)}

    for i_epoch, epoch1 in enumerate(groups):
        detected = set(epoch1.where(nondet=False)["filter"])
        nfilt = len(detected)
        if nfilt < min_nfilt:
            continue

        if nfilt > 1:
            p0 = np.array([10.0, 10.0])
        elif sampler is not None:
            # single-filter epoch: the previous posterior's temperature
            # becomes the prior (KDE chaining, reference bolometric.py:753-759)
            priors[0] = KDEPrior(sampler.flatchain[:, 0])
            # (T, R) columns only: with use_sigma the flatchain carries the
            # intrinsic-scatter column
            p0 = np.median(sampler.flatchain[:, :2], axis=0)
        else:
            continue

        mjdavg, dmjd0, dmjd1 = median_and_unc(np.asarray(epoch1["MJD"], float), 100.0)
        record = {"MJD": mjdavg, "dMJD0": dmjd0, "dMJD1": dmjd1, "npoints": nfilt,
                  "filts": "".join([f.char for f in sorted(detected)])}
        if use_src:
            record["source"] = epoch1["source"][0]

        # stage 1: bounded least squares (also recenters the MCMC guesses)
        lstsq, p0 = _lstsq_record(epoch1, z, p0, priors, cutoff_freq)
        record.update(lstsq)

        starting_guesses = rng.normal(size=(nwalkers, 2)) + p0
        starting_guesses[starting_guesses <= 0.0] = 1.0
        if use_sigma:
            starting_guesses = np.append(starting_guesses,
                                         np.abs(rng.normal(size=(nwalkers, 1))), axis=1)

        # stage 2: MCMC posterior (the batched summaries where precomputed)
        try:
            if not do_mcmc:
                raise ValueError("do_mcmc=False")
            if i_epoch in batched_summaries:
                record.update(_summary_record(batched_summaries[i_epoch]))
                if i_epoch in batched_chains:
                    sampler = _FlatchainSampler(batched_chains[i_epoch])
                    os.makedirs(outpath, exist_ok=True)
                    if save_chains:
                        np.save(os.path.join(outpath, f"{mjdavg:.3f}.npy"), sampler.flatchain)
            else:
                # a per-epoch seed (fold_in-style): every epoch's sampler gets
                # an independent, reproducible stream
                seed_i = (None if seed is None else
                          int(np.random.SeedSequence((seed, i_epoch))
                              .generate_state(1)[0] & 0x7FFFFFFF))
                sampler = spectrum_mcmc(planck_fast, epoch1, priors, starting_guesses, z=z,
                                        spectrum_kwargs={"cutoff_freq": cutoff_freq},
                                        outpath=outpath, nwalkers=nwalkers,
                                        burnin_steps=burnin_steps, steps=steps,
                                        save_chains=save_chains, use_sigma=use_sigma,
                                        sigma_type=sigma_type, seed=seed_i, make_corner=False,
                                        device=dev)
                record.update(_mcmc_record(sampler.flatchain, z, cutoff_freq))
        except ValueError as e:
            print(e)
            record.update({field: np.nan for field in _MCMC_FIELDS})

        # stage 3: direct SED integration + colors
        record["L_int"] = integrate_sed(epoch1)
        record.update(_color_record(epoch1, colors))
        _append_record(t0, record)

    # keep deprecated column names for now (reference bolometric.py:824-827)
    for old, new in DEPRECATED_BOLOMETRIC_COLNAMES:
        t0[old] = t0[new]
    warnings.warn("Some column names in the output table have changed (see documentation). "
                  "Please update your code!")

    if save_table_as is not None and t0:
        t0.write(save_table_as, format="ascii.fixed_width_two_line", overwrite=True)

    return t0
