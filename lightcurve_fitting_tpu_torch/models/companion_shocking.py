"""Companion-shocking models: Kasen (2010) shock + SiFTO SN Ia template
(Conley et al. 2008), as combined by Hosseinzadeh et al. (2017); the port of
``lightcurve_fitting_tpu/models/companion_shocking.py`` (reference
models.py:660-1045).

The per-filter SiFTO cubic splines are built on the host at model
construction into piecewise-polynomial coefficients; on tensors the
template is a per-point knot search and cubic (:func:`_ppoly_batched`, the
plain version of K8 in ``kernels/cs.py``), with the per-band special cases
(DLT40/unfiltered -> r template, U/i time shifts and scale factors,
reference models.py:701-717, 786-827, 913-916) as per-point masks.

The Kasen temperature is 25 kK (a13^36 Mc_v9_7 kappa^-35 tt^-74)^(1/144).
In float64 the JAX package's graph is kept, operation for operation. In
float32 that product leaves the normal range once tt > 3.3 d (tt^-74), and
the JAX package's float32 path then gives T = 0, so no shock at all; here
float32 forms the walker-constant factor in float64 and evaluates
25 exp((ln K - 74 ln tt) / 144) instead, which is held to the JAX package's
float64 values.
"""

import os

import numpy as np
import torch

from ..filters import _DATA_DIR, filtdict
from ..ops.interpolate import notaknot_cubic_coeffs, ppoly_eval, ppoly_eval_np
from ..ops.mathx import power, hot, hot_phase
from ..utils import units as u
from ..utils.table import Table
from .base import Model

__all__ = ["BaseCompanionShocking", "CompanionShocking", "CompanionShocking2",
           "CompanionShocking3", "sifto", "M_chandra", "sifto_band_rows", "sifto_points",
           "sifto_points_plain"]

_SIFTO_FILE = os.path.join(_DATA_DIR, "sifto.npz")
sifto_filename = _SIFTO_FILE  # reference models.py:660 exposes this name


def _load_sifto():
    data = np.load(_SIFTO_FILE, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    tab = Table([data["table"][:, i] for i in range(len(names))], names=names)
    return tab[3:]  # the first three points are ~0 (reference models.py:661)


sifto = _load_sifto()
M_chandra = u.def_unit("M_chandra", 1.4 * u.Quantity(1.0, u.Msun), format={"latex": "M_\\mathrm{Ch}"})


def _ppoly_batched(knots, c_pt, xq):
    """Evaluate per-point piecewise cubics: knots (S,), c_pt (N, 4, S-1),
    xq (..., N). NaN outside the domain (scipy extrapolate=False)."""
    return ppoly_eval(knots, c_pt, xq, extrapolate="nan")


def _kasen_temperature_f32(tt, a13, Mc_v9_7, kappa):
    """The Kasen temperature (kK) in tt's (float32) dtype without underflow:
    25 exp((ln K - 74 ln tt) / 144), K = a13^36 Mc_v9_7 kappa^-35 formed in
    float64 from the float64 parameters; 0 where tt <= 0 or K <= 0 (the
    zeros of ``power`` in the JAX graph), as the CS kernels compute it."""
    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=tt.device)
    K = f64(a13) ** 36.0 * f64(Mc_v9_7) * f64(kappa) ** -35.0
    ln_k = torch.where(K > 0.0, torch.log(K), torch.full_like(K, -torch.inf)).to(tt.dtype)
    pos = tt > 0.0
    ln_tt = torch.log(torch.where(pos, tt, torch.ones_like(tt)))
    return torch.where(pos, 25.0 * torch.exp((ln_k - 74.0 * ln_tt) * (1.0 / 144.0)),
                       torch.zeros_like(tt))


def sifto_band_rows(sifto_c, band_ids):
    """The per-point SiFTO coefficients ``sifto_c`` (N, 4, S-1) as per-band
    rows (B, 4, S-1) and each point's row (N,) int64: every point of a band
    carries its band's coefficients, so the band's first point gives them."""
    _, first, rows = np.unique(np.asarray(band_ids), return_index=True, return_inverse=True)
    return np.asarray(sifto_c)[first], rows.ravel().astype(np.int64)


def sifto_points_plain(t, quad, t_peak, stretch, dtU=None, dti=None):
    """The stretched SiFTO term of each point, plain PyTorch (the JAX
    package's ``_sifto_points``): the template phase (t - t_peak - dt) /
    stretch in the compute dtype, dt = dtU on U points and dti on i points,
    through the per-point cubics of ``quad``, 0 outside the template.
    Parameters are 0-d or (W, 1) columns; returns (N,) or (W, N)."""
    ph = hot_phase(t, t_peak)   # centered template phase in the compute dtype
    dt = torch.zeros_like(ph)
    if dtU is not None:
        dt = torch.where(quad["is_U"], torch.as_tensor(dtU, device=ph.device).to(ph.dtype), dt)
    if dti is not None:
        dt = torch.where(quad["is_i"], torch.as_tensor(dti, device=ph.device).to(ph.dtype), dt)
    arg = (ph - dt) / torch.as_tensor(stretch, device=ph.device).to(ph.dtype)
    val = _ppoly_batched(quad["sifto_knots"], quad["sifto_c"], arg)
    return torch.nan_to_num(val, nan=0.0)


def sifto_points(t, quad, t_peak, stretch, dtU=None, dti=None):
    """:func:`sifto_points_plain`'s result: the plain version for a CPU
    tensor, else K8 (``kernels.cs.sifto``), which needs the per-band
    ``sifto_rows``/``sifto_band`` entries of the quad dict."""
    if torch.as_tensor(t).device.type == "cpu":
        return sifto_points_plain(t, quad, t_peak, stretch, dtU, dti)
    from ..kernels import cs
    return cs.sifto(t, quad, t_peak, stretch, dtU, dti)


class BaseCompanionShocking(Model):
    """Kasen (2010) shock + scaled/stretched SiFTO template (reference
    models.py:665-845)."""

    def __init__(self, lc, redshift=0.0, kappa=1.0, device=None):
        super().__init__(lc, redshift=redshift, device=device)
        #: opacity in units of the electron-scattering 0.34 cm^2/g, threaded
        #: through the Kasen component (the reference only accepts kappa per
        #: evaluate() call, models.py:731-784)
        self.kappa = float(kappa)
        if "lum" not in lc.colnames:
            if "absmag" not in lc.colnames:
                lc.calcAbsMag()
            lc.calcLum()

        self.sifto = {}          # Filter -> host spline-eval callable
        self._sifto_coeffs = {}  # Filter -> (4, S-1) scaled ppoly coefficients
        self._epochs = np.asarray(sifto["Epoch"], float)
        for filt in set(lc["filter"]):
            # unfiltered data are scaled like DLT40 (r template); see
            # reference models.py:701-714
            if filt.name == "unfilt." and filtdict["DLT40"] in lc["filter"]:
                sifto_filt = "r"
                scale_filt = "DLT40"
            elif filt.name == "DLT40":
                sifto_filt = "r"
                scale_filt = filt
            elif filt.char in sifto.colnames:
                sifto_filt = filt.char
                scale_filt = filt
            else:
                raise Exception("No SiFTO template for filter " + filt.name)
            lc_filt = lc.where(filter=scale_filt)
            template = np.asarray(sifto[sifto_filt], float)
            # mask-respecting max (reference models.py:706): np.asarray would
            # expose fill values under masked rows (e.g. nondetections)
            lum_max = np.ma.max(np.ma.MaskedArray(lc_filt["lum"]).astype(float))
            scaled = template * float(lum_max) / np.max(template)
            coeffs = notaknot_cubic_coeffs(self._epochs, scaled)
            self._sifto_coeffs[filt] = coeffs
            self.sifto[filt] = _HostSpline(self._epochs, coeffs)

    def __repr__(self):
        return f"<{self.__class__.__name__}: z={self.z:.3f}>"

    # ------------------------------------------------------------ components
    @staticmethod
    def temperature_radius(t_in, t_exp, a13, Mc_v9_7, kappa=1.0):
        """Kasen 2010 shock temperature (kK) and radius (1000 Rsun), float64
        on the host, outer-broadcast over vector parameters (reference
        models.py:726-755)."""
        def f64(x):
            return torch.as_tensor(np.asarray(x, float), dtype=torch.float64)

        kappa = f64(kappa) if np.ndim(kappa) else float(kappa)
        t = f64(t_in).reshape(-1, 1) - f64(t_exp)
        a13, Mc_v9_7 = f64(a13), f64(Mc_v9_7)
        T_kasen = torch.squeeze(25.0 * power(a13 ** 36.0 * Mc_v9_7 * kappa ** -35.0
                                             * power(t, -74.0), 1.0 / 144.0))  # kK
        R_kasen = torch.squeeze(2.7 * power(kappa * Mc_v9_7 * t ** 7.0, 1.0 / 9.0))  # kiloRsun
        return T_kasen, R_kasen

    @staticmethod
    def _tr_points(t, t_exp, a13, Mc_v9_7, kappa=1.0):
        """T, R at the points' times ``t`` (N,) for 0-d parameters or (W, 1)
        columns, in the compute dtype (see the module docstring)."""
        tt = hot_phase(t, t_exp)
        if tt.dtype == torch.float64:
            tt, a13, Mc_v9_7, kappa = hot(tt.device, tt, a13, Mc_v9_7, kappa)
            T_kasen = 25.0 * power(a13 ** 36.0 * Mc_v9_7 * kappa ** -35.0 * power(tt, -74.0),
                                   1.0 / 144.0)
        else:
            T_kasen = _kasen_temperature_f32(tt, a13, Mc_v9_7, kappa)
            Mc_v9_7, kappa = hot(tt.device, Mc_v9_7, kappa)
        R_kasen = 2.7 * power(kappa * Mc_v9_7 * tt ** 7.0, 1.0 / 9.0)
        return T_kasen, R_kasen

    def companion_shocking(self, t_in, f, t_exp, a13, Mc_v9_7, kappa=None):
        """Shock component only, host API (reference models.py:757-784).
        ``kappa`` defaults to the constructor-bound opacity so component
        curves match a kappa-bound fit."""
        from .blackbody import blackbody_to_filters
        if kappa is None:
            kappa = self.kappa
        T_kasen, R_kasen = self.temperature_radius(np.asarray(t_in, float), t_exp, a13, Mc_v9_7,
                                                   kappa)
        return blackbody_to_filters(f, T_kasen.numpy(), R_kasen.numpy(), self.z,
                                    device=self.device)

    def stretched_sifto(self, t_in, f, t_peak, stretch, dtU=None, dti=None):
        """SiFTO template, offset and stretched; U/i may get extra time shifts.
        Host API with the reference's three broadcasting modes
        (models.py:786-827); extrapolation is zero."""
        dt_peak = {}
        if dtU is not None:
            dt_peak[filtdict["U"]] = dtU
        if dti is not None:
            dt_peak[filtdict["i"]] = dti
        t_wrt_peak = np.squeeze(np.reshape(np.asarray(t_in, float), (-1, 1)) - t_peak)
        f = np.atleast_1d(f)

        def ev(filt, arg):
            return ppoly_eval_np(self._epochs, self._sifto_coeffs[filt], arg, extrapolate="nan")

        if t_wrt_peak.ndim <= 1 and t_wrt_peak.shape == (len(f),):
            # pointwise (per reference mode 1: vector stretch broadcasts each
            # point's epoch over the stretch draws, returning (N, W))
            Lnu_sifto = np.array([ev(filt, (t - dt_peak.get(filt, 0.0)) / stretch)
                                  for t, filt in zip(np.atleast_1d(t_wrt_peak), f)])
        elif t_wrt_peak.ndim <= 1:
            Lnu_sifto = np.array([ev(filt, (t_wrt_peak - dt_peak.get(filt, 0.0)) / stretch)
                                  for filt in f])
        else:
            stretch = np.asarray(stretch, float)
            Lnu_sifto = np.array([
                np.transpose([ev(filt, (t - dt) / s) for t, dt, s in
                              zip(t_wrt_peak.T, np.broadcast_to(
                                  dt_peak.get(filt, np.zeros_like(stretch)), stretch.shape),
                                  stretch)])
                for filt in f])
        Lnu_sifto = np.asarray(Lnu_sifto, float)
        Lnu_sifto[np.isnan(Lnu_sifto)] = 0.0
        return Lnu_sifto

    # -------------------------------------------------------- tensor pieces
    def prepare_quad(self, filters, bank=None):
        """The table path's quad dict plus the JAX package's SiFTO entries:
        per-point coefficients ``sifto_c`` (N, 4, S-1), ``sifto_knots`` (S,)
        and the masks ``is_U``, ``is_i``, ``is_r`` (N,); and, for K8, the
        same coefficients as per-band rows ``sifto_rows`` (B, 4, S-1) with
        each point's row ``sifto_band`` (N,)."""
        quad = super().prepare_quad(filters, bank)
        coeffs = np.stack([self._sifto_coeffs[f] for f in filters])  # (N, 4, S-1)
        quad["sifto_c"] = coeffs
        quad["sifto_knots"] = self._epochs
        chars = np.array([f.char for f in filters])
        quad["is_U"] = chars == "U"
        quad["is_i"] = chars == "i"
        quad["is_r"] = chars == "r"
        quad["sifto_rows"], quad["sifto_band"] = sifto_band_rows(coeffs, quad["band_ids"])
        return quad

    def _sifto_points(self, t, quad, t_peak, stretch, dtU=None, dti=None, plain=False):
        """The stretched SiFTO term (..., N), 0 outside the template: K8 on
        CUDA unless ``plain``."""
        fn = sifto_points_plain if plain else sifto_points
        return fn(t, quad, t_peak, stretch, dtU, dti)

    def _kasen_points(self, t, quad, t_exp, a13, Mc_v9_7, kappa=None):
        if kappa is None:
            kappa = self.kappa
        T_kasen, R_kasen = self._tr_points(t, t_exp, a13, Mc_v9_7, kappa)
        return self._bandflux(quad, T_kasen, R_kasen)

    def kernel_constants(self):
        """The CS kernels' model constants: the variant (1, 2, 3) of the
        parameters and factors, and the opacity."""
        return {"variant": self.kernel_variant, "kappa": self.kappa}

    # ----------------------------------------------------------- validity
    @staticmethod
    def t_min(p):
        return p[3] + p[4] * float(np.min(np.asarray(sifto["Epoch"])))

    @staticmethod
    def t_max(p):
        return p[3] + p[4] * float(np.max(np.asarray(sifto["Epoch"])))


class _HostSpline:
    """Host-side callable mirroring scipy CubicSpline(extrapolate=False)."""

    def __init__(self, knots, coeffs):
        self._knots = knots
        self._coeffs = coeffs

    def __call__(self, x):
        return ppoly_eval_np(self._knots, self._coeffs, np.asarray(x, float), extrapolate="nan")


class CompanionShocking(BaseCompanionShocking):
    """Kasen + SiFTO with scale factors on the r and i SiFTO components and on
    the U shock component (reference models.py:848-918)."""

    input_names = ["t_0", "a", "M v^7", "t_\\mathrm{max}", "s", "r_r", "r_i", "r_U"]
    units = [u.d, 10.0 ** 13.0 * u.cm, M_chandra * (1e9 * u.cm / u.s) ** 7, u.d,
             u.dimensionless_unscaled, u.dimensionless_unscaled,
             u.dimensionless_unscaled, u.dimensionless_unscaled]
    kernel_variant = 1

    def evaluate(self, t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                 rr=1.0, ri=1.0, rU=1.0, kappa=None):
        # kappa rides the Kasen component as an ordinary parameter
        # (reference models.py:876-918 signature)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                                rr, ri, rU, kappa)

    def _eval_points(self, t, quad, t_exp, a13, Mc_v9_7, t_peak, stretch,
                     rr=1.0, ri=1.0, rU=1.0, kappa=None, plain=False):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, Mc_v9_7, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch, plain=plain)

        def col(x):
            return torch.as_tensor(x, dtype=torch.float64, device=Lnu_kasen.device)
        one = col(1.0)
        kasen_fac = torch.where(quad["is_U"], col(rU), one)
        sifto_fac = torch.where(quad["is_r"], col(rr), torch.where(quad["is_i"], col(ri), one))
        return Lnu_kasen * kasen_fac + Lnu_sifto * sifto_fac


class CompanionShocking2(BaseCompanionShocking):
    """Kasen + SiFTO with U/i time offsets (reference models.py:921-980)."""

    input_names = ["t_0", "a", "M v^7", "t_\\mathrm{max}", "s", "\\Delta t_U", "\\Delta t_i"]
    units = [u.d, 10.0 ** 13.0 * u.cm, M_chandra * (1e9 * u.cm / u.s) ** 7, u.d,
             u.dimensionless_unscaled, u.d, u.d]
    kernel_variant = 2

    def evaluate(self, t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                 dtU=0.0, dti=0.0, kappa=None):
        # kappa rides the Kasen component (reference models.py:957-980 signature)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, Mc_v9_7, t_peak, stretch,
                                dtU, dti, kappa)

    def _eval_points(self, t, quad, t_exp, a13, Mc_v9_7, t_peak, stretch,
                     dtU=0.0, dti=0.0, kappa=None, plain=False):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, Mc_v9_7, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch, dtU, dti, plain=plain)
        return Lnu_kasen + Lnu_sifto


class CompanionShocking3(BaseCompanionShocking):
    """Kasen + SiFTO with U/i time offsets and the Brown et al. (2012) viewing-
    angle factor (reference models.py:983-1045)."""

    input_names = ["t_0", "a", "\\theta", "t_\\mathrm{max}", "s", "\\Delta t_U", "\\Delta t_i"]
    units = [u.d, 10.0 ** 13.0 * u.cm, u.deg, u.d, u.dimensionless_unscaled, u.d, u.d]
    kernel_variant = 3

    def evaluate(self, t_in, f, t_exp, a13, theta, t_peak, stretch,
                 dtU=0.0, dti=0.0, kappa=None):
        # kappa rides the Kasen component (reference models.py:1022-1045 signature)
        if kappa is None:
            kappa = self.kappa
        return super().evaluate(t_in, f, t_exp, a13, theta, t_peak, stretch,
                                dtU, dti, kappa)

    def _eval_points(self, t, quad, t_exp, a13, theta, t_peak, stretch,
                     dtU=0.0, dti=0.0, kappa=None, plain=False):
        Lnu_kasen = self._kasen_points(t, quad, t_exp, a13, 1.0, kappa)
        Lnu_sifto = self._sifto_points(t, quad, t_peak, stretch, dtU, dti, plain=plain)
        theta_rad = torch.deg2rad(torch.as_tensor(theta, dtype=torch.float64,
                                                  device=Lnu_kasen.device))
        fractional_flux = ((0.5 * torch.cos(theta_rad) + 0.5)
                           * (0.14 * theta_rad ** 2.0 - 0.4 * theta_rad + 1.0))
        return Lnu_kasen * fractional_flux + Lnu_sifto
