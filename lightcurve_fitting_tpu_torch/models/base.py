"""Model base class: metadata, host evaluation API (reference-compatible
broadcasting), and the tensor contract used by the log-posterior and the
sampler.

Every concrete model implements one torch function,

    _eval_points(self, t, quad, *params, plain=False) -> y (..., N)

over per-point times ``t`` (N,), a ``quad`` dict of static per-point tensors
built from :meth:`prepare_quad`, and parameters that are 0-d tensors or
``(W, 1)`` columns. Batching over walkers is that leading walker axis,
written out (the JAX package vmaps a scalar-parameter function instead).
``plain=True`` keeps the band flux on its plain PyTorch version on every
device (the log-likelihood's plain path); otherwise the quadrature band
flux launches K3 on CUDA.
"""

import numpy as np
import torch
from torch import nn

from ..ops.filterbank import native_lengths
from ..ops.mathx import epoch_reference
from ..utils import units as u

__all__ = ["Model", "LogLikelihood", "format_unit", "intrinsic_scatter_units"]


def intrinsic_scatter_units(dy, sigma_type, mask=None):
    """Units of the intrinsic-scatter parameter sigma (reference
    models.py:116-129): the per-point uncertainties for ``'relative'``, their
    median for ``'absolute'``, over the real (``mask``) points only when a
    mask is given (the padded bands of a packed epoch). Host numpy, the JAX
    package's definition: with a mask, ``np.nanmedian`` of the masked data
    (the mean of the two middle values for an even count)."""
    if sigma_type == "relative":
        return dy
    if sigma_type == "absolute":
        return np.median(dy) if mask is None else np.nanmedian(np.where(mask, dy, np.nan))
    raise Exception('sigma_type must either be "relative" or "absolute"')


def format_unit(unit):
    """LaTeX-format a unit or an order-of-magnitude quantity
    (reference models.py:15-39)."""
    if isinstance(unit, u.Quantity):
        value = np.log10(unit.value)
        unit = unit.unit
        if value % 1.0:
            unit_str = "$10^{{{value:.1f}}}$ {unit:latex_inline}"
        else:
            unit_str = "$10^{{{value:.0f}}}$ {unit:latex_inline}"
    else:
        value = None
        unit_str = "{unit:latex_inline}"
    return unit_str.format(value=value, unit=unit)


def _quad_tensors(quad, device):
    """numpy quad dict -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in quad.items()}


class Model:
    """An analytical light-curve model (reference models.py:51-136).

    ``device`` is where the host evaluation API (:meth:`evaluate`,
    :meth:`log_likelihood`) runs; the fit drivers take their own."""

    input_names = []
    units = []
    output_quantity = "lum"
    n_nodes = None  # FilterBank mode: None = exact native quadrature
    use_band_table = True
    """Blackbody band integrals via precomputed ln g_b(ln T) tables
    (ops/bandtable.py). False on models whose band integral cannot
    factorize (sampled E(B-V)): the exact quadrature then runs."""
    cutoff_freq = np.inf

    @property
    def nparams(self):
        return len(self.input_names)

    @property
    def axis_labels(self):
        return ["${}$ ({})".format(var, format_unit(unit))
                if unit is not u.dimensionless_unscaled else "${}$".format(var)
                for var, unit in zip(self.input_names, self.units)]

    def __init__(self, lc=None, redshift=0.0, device=None):
        if redshift:
            self.z = redshift
        elif lc is not None and "redshift" in lc.meta:
            self.z = lc.meta["redshift"]
        else:
            self.z = 0.0
        self.device = torch.device(device if device is not None else "cpu")

    def __repr__(self):
        return f"<{self.__class__.__name__}: z={self.z:.3f}>"

    def __call__(self, *args, **kwargs):
        return self.evaluate(*args, **kwargs)

    # ------------------------------------------------------------ device side
    def bank_for(self, filters):
        from ..ops.filterbank import bank_for
        return bank_for(filters, n_nodes=self.n_nodes)

    def prepare_quad(self, filters, bank=None):
        """Build the static per-point quadrature dict (host numpy arrays) for
        an array of Filter objects (one entry per photometry point): the
        Chebyshev table rows, or with ``use_band_table = False`` the
        quadrature ``nodes``, ``weights`` and ``k_ext`` (N, K), as in the JAX
        package."""
        bank = bank or self.bank_for(sorted(set(filters)))
        ids = bank.band_ids(filters)
        if not self.use_band_table:
            nodes, weights, k_ext = bank.gather(ids, z=self.z, device=False)
            return {"nodes": nodes, "weights": weights, "k_ext": k_ext, "band_ids": ids}
        quad = {"band_ids": ids}
        quad["bb_coeffs"], quad["bb_s_a"], quad["bb_s_b"] = \
            self.table_for(bank).gather(ids, device=False)
        return quad

    def table_for(self, bank):
        from ..ops.filterbank import band_table_for
        return band_table_for(bank, z=self.z, cutoff_freq=self.cutoff_freq)

    def _bandflux(self, quad, T, R, plain=False):
        """Band-averaged blackbody L_nu per point: the Chebyshev table when
        the quad dict has one, the exact quadrature otherwise."""
        if "bb_coeffs" in quad:
            from ..ops.bandtable import chebyshev_bandflux
            return chebyshev_bandflux(quad["bb_coeffs"], T, R, quad["bb_s_a"], quad["bb_s_b"])
        from .blackbody import bandflux_pointwise, bandflux_pointwise_plain
        flux = bandflux_pointwise_plain if plain else bandflux_pointwise
        return flux(quad["nodes"], quad["weights"], T, R, cutoff_freq=self.cutoff_freq)

    def _eval_points(self, t, quad, *params, plain=False):
        raise NotImplementedError

    def kernel_constants(self):
        """Model constants of the fused CUDA log-posterior, for models that
        have one; see ShockCooling2 and ShockCooling3."""
        raise NotImplementedError(
            f"{self.__class__.__name__} has no fused CUDA log-posterior yet "
            "(ROADMAP Queue 1 item 7)")

    # -------------------------------------------------------------- host side
    def evaluate(self, t_in, f, *params):
        """Reference-compatible evaluation: per-point when ``len(f) == len(t)``
        and parameters are scalars; otherwise an outer product over filters,
        times, and (optionally) parameter vectors, shaped (B, N[, W]) like the
        reference's broadcasting (fitting.py:350-352 relies on this)."""
        dev = self.device
        t_arr = np.atleast_1d(np.asarray(t_in, float))
        f_arr = np.atleast_1d(f)
        params = [np.asarray(p, float) for p in params]
        vector = any(p.ndim > 0 for p in params)

        def scalar(p):
            return torch.tensor(np.array(p, float), device=dev)

        if not vector and f_arr.shape == t_arr.shape and f_arr.ndim == 1:
            quad = _quad_tensors(self.prepare_quad(f_arr), dev)
            y = self._eval_points(scalar(t_arr), quad, *[scalar(p) for p in params])
            out = y.cpu().numpy()
            return out if np.ndim(t_in) else float(out[0])

        # outer mode: tile the time grid over bands
        B, N = len(f_arr), len(t_arr)
        f_tiled = np.repeat(f_arr, N)
        t_tiled = np.tile(t_arr, B)
        quad = _quad_tensors(self.prepare_quad(f_tiled), dev)
        t_dev = scalar(t_tiled)
        if vector:
            W = max(p.shape[0] for p in params if p.ndim > 0)
            pcols = [scalar(np.broadcast_to(p, (W,)))[:, None] for p in params]
            y = self._eval_points(t_dev, quad, *pcols)                   # (W, B*N)
            y = y.cpu().numpy().reshape(W, B, N).transpose(1, 2, 0)     # (B, N, W)
        else:
            y = self._eval_points(t_dev, quad, *[scalar(p) for p in params])
            y = y.cpu().numpy().reshape(B, N)
        return np.squeeze(y) if np.ndim(t_in) == 0 else y

    # -------------------------------------------------------------- likelihood
    def log_likelihood(self, lc, p, use_sigma=False, sigma_type="relative"):
        """Host-side log-likelihood, identical formula to reference
        models.py:93-136 (Gaussian with optional intrinsic-scatter parameter).

        1-D ``p`` returns a float; extra trailing dimensions of ``p`` return
        an array of that shape (one likelihood per parameter set, in one
        batched call)."""
        f = np.asarray(lc["filter"])
        t = np.asarray(lc["MJD"], float)
        y = np.asarray(lc[self.output_quantity], float)
        dy = np.asarray(lc["d" + self.output_quantity], float)
        ll_fn = self.make_log_likelihood_arrays(t, f, y, dy, use_sigma, sigma_type,
                                                device=self.device)
        p = np.asarray(p, float)
        flat = p.reshape(p.shape[0], -1).T                    # (W, nparams)
        vals = ll_fn(torch.as_tensor(flat, device=self.device)).cpu().numpy()
        return float(vals[0]) if p.ndim == 1 else vals.reshape(p.shape[1:])

    def _normalized_data(self, y, dy, sigma_type="relative"):
        """O(1) data normalization shared by the likelihood and the
        goodness-of-fit diagnostic: raw flux units (~1e-30 W/m^2/Hz) or
        luminosities (~1e13 W/Hz) must not appear squared or logged in
        float32.

        Returns host-numpy ``(yscale, y/yscale, dy/yscale, sigma_units)``
        where ``sigma_units`` is the per-point (or scalar, for
        sigma_type='absolute') unit of the intrinsic-scatter parameter
        (reference models.py:116-129)."""
        y = np.asarray(y, float)
        dy = np.asarray(dy, float)
        yscale = float(np.median(np.abs(y[y != 0]))) if np.any(y != 0) else 1.0
        sigma_units = intrinsic_scatter_units(dy / yscale, sigma_type)
        return yscale, y / yscale, dy / yscale, sigma_units

    def make_log_likelihood_arrays(self, t, f, y, dy, use_sigma=False, sigma_type="relative",
                                   device=None):
        """Build the :class:`LogLikelihood` module over the given photometry
        arrays, with its buffers on ``device`` (default: the model's)."""
        quad = self.prepare_quad(f)
        return LogLikelihood.from_quad(self, quad, t, y, dy, use_sigma, sigma_type,
                                       device=device if device is not None else self.device)

    def make_log_likelihood(self, lc, use_sigma=False, sigma_type="relative", device=None):
        f = np.asarray(lc["filter"])
        t = np.asarray(lc["MJD"], float)
        y = np.asarray(lc[self.output_quantity], float)
        dy = np.asarray(lc["d" + self.output_quantity], float)
        return self.make_log_likelihood_arrays(t, f, y, dy, use_sigma, sigma_type,
                                               device=device)


class LogLikelihood(nn.Module):
    """Gaussian log-likelihood of one light curve, batched over walkers:
    ``forward(p (W, ndim) float64) -> (W,)``.

    The buffers are the per-point data in the compute dtype resolved for the
    device at construction (float32 on CUDA, float64 on the CPU by default):
    the centered times, ``y/yscale``, ``1/dy``, ``dy`` and the sigma units,
    and the band data of the model's path. The table path keeps the
    Chebyshev rows ``bb_coeffs (N, D+1)``, ``bb_s_a (N,)``, ``bb_s_b (N,)``.
    The quadrature path keeps one row per band, ``nodes``, ``weights`` and
    ``k_ext`` (B, K), with ``band_ids`` (N,) int64 naming each point's row
    and ``n_native`` (B,) int64, each band's node count before its
    zero-weight padding. A companion-shocking model's SiFTO template rides
    beside the table: ``sifto_rows`` (B, 4, S-1), one row of spline
    coefficients per band, ``sifto_band`` (N,) int64 naming each point's
    row, ``sifto_knots`` (S,) and the masks ``is_U``, ``is_i``, ``is_r``
    (N,) bool. The absolute float64 times feed the plain path's
    :func:`~lightcurve_fitting_tpu_torch.ops.mathx.hot_phase`. The constants
    ``log_norm_const``, ``offset`` and ``inv_yscale`` are host float64.
    """

    TABLE_BUFFERS = ("bb_coeffs", "bb_s_a", "bb_s_b")
    SIFTO_MASKS = ("is_U", "is_i", "is_r")

    def __init__(self, model, quad, t, y_n, dy_n, sigma_units, log_norm_const, offset,
                 inv_yscale, use_sigma, sigma_type, device):
        super().__init__()
        from ..core import config
        device = torch.device(device)
        dt = config.get_compute_dtype(device)
        self.compute_dtype = dt if dt is not None else torch.float64
        cdt = self.compute_dtype
        self.model = model
        self.use_sigma = bool(use_sigma)
        self.sigma_type = sigma_type
        self.log_norm_const = float(log_norm_const)
        self.offset = float(offset)
        self.inv_yscale = float(inv_yscale)

        def buf(a, dtype=cdt):
            return torch.tensor(np.array(a, float), device=device).to(dtype)

        N = len(y_n)
        t64 = buf(t, torch.float64)
        self.t_ref = float(epoch_reference(t64)) if dt is not None else 0.0
        self.register_buffer("t", t64)
        self.register_buffer("t_centered", buf(np.asarray(t, float) - self.t_ref))
        self.register_buffer("y", buf(y_n))
        self.register_buffer("inv_dy", buf(1.0 / np.asarray(dy_n, float)))
        self.register_buffer("dy", buf(dy_n))
        self.register_buffer("sigma_units", buf(np.broadcast_to(sigma_units, (N,))))
        self.use_band_table = "bb_coeffs" in quad
        if self.use_band_table:
            for name in self.TABLE_BUFFERS:
                self.register_buffer(name, buf(quad[name]))
        else:
            # the per-point rows are gathered from the bank's per-band rows:
            # the first point of each band gives that band's row back exactly
            _, first, rows = np.unique(np.asarray(quad["band_ids"]), return_index=True,
                                       return_inverse=True)
            for name in ("nodes", "weights", "k_ext"):
                self.register_buffer(name, buf(np.asarray(quad[name])[first]))
            self.register_buffer("band_ids", torch.as_tensor(rows.ravel(), dtype=torch.int64,
                                                             device=device))
            self.register_buffer("n_native", torch.as_tensor(
                native_lengths(np.asarray(quad["weights"])[first]), dtype=torch.int64,
                device=device))
        self.has_sifto = "sifto_rows" in quad
        if self.has_sifto:
            for name in ("sifto_rows", "sifto_knots"):
                self.register_buffer(name, buf(quad[name]))
            self.register_buffer("sifto_band", torch.as_tensor(
                np.asarray(quad["sifto_band"]), dtype=torch.int64, device=device))
            for name in self.SIFTO_MASKS:
                self.register_buffer(name, torch.as_tensor(np.asarray(quad[name], bool),
                                                           device=device))

    @classmethod
    def from_quad(cls, model, quad, t, y, dy, use_sigma=False, sigma_type="relative",
                  device="cpu"):
        """The likelihood of photometry ``(t, y, dy)`` given the numpy quad
        dict of its points (``Model.prepare_quad``'s output)."""
        # the log-likelihood changes by the constant -N log(yscale) under the
        # data normalization, which is added back
        y = np.asarray(y, float)
        dy = np.asarray(dy, float)
        yscale, y_n, dy_n, sigma_units = model._normalized_data(y, dy, sigma_type)
        offset = -len(y) * np.log(yscale)
        # the Gaussian normalization term is a constant when sigma is fixed:
        # hoisted to the host (float64, exact)
        log_norm_const = float(-0.5 * np.sum(np.log(2 * np.pi * dy_n ** 2)) + offset)
        return cls(model, quad, t, y_n, dy_n, sigma_units, log_norm_const, offset,
                   1.0 / yscale, use_sigma, sigma_type, device)

    @property
    def quad(self):
        """The per-point quad dict ``_eval_points`` reads (the quadrature
        rows and the SiFTO coefficients gathered per point, as the JAX
        package's ``prepare_quad`` gives them)."""
        if self.use_band_table:
            quad = {name: getattr(self, name) for name in self.TABLE_BUFFERS}
        else:
            quad = {"nodes": self.nodes[self.band_ids], "weights": self.weights[self.band_ids],
                    "k_ext": self.k_ext[self.band_ids], "band_ids": self.band_ids}
        if self.has_sifto:
            quad.update({name: getattr(self, name) for name in self.SIFTO_MASKS},
                        sifto_c=self.sifto_rows[self.sifto_band], sifto_knots=self.sifto_knots,
                        sifto_rows=self.sifto_rows, sifto_band=self.sifto_band)
        return quad

    def residual_terms(self, p):
        """(W, N) per-point terms of the residual sum of the rows of ``p``
        (W, ndim), in the compute dtype: ((y - y_fit) / dy)^2, or with the
        intrinsic scatter log(2 pi sigma^2) + (y - y_fit)^2 / sigma^2."""
        n_model = p.shape[1] - (1 if self.use_sigma else 0)
        cdt = self.y.dtype
        y_fit = self.model._eval_points(self.t, self.quad,
                                        *[p[:, i:i + 1] for i in range(n_model)], plain=True)
        # 1/yscale rounded to the compute dtype first, as the JAX package's
        # ``dtype.type(inv_yscale)`` (and K1's cast) does
        y_fit = y_fit.to(cdt) * float(torch.tensor(self.inv_yscale, dtype=cdt))
        if self.use_sigma:
            sig = p[:, -1:].to(cdt)
            sigma2 = self.dy ** 2.0 + (sig * self.sigma_units) ** 2.0
            return torch.log(2 * np.pi * sigma2) + (self.y - y_fit) ** 2.0 / sigma2
        r = (self.y - y_fit) * self.inv_dy
        return r * r

    def term_scales(self, p, chunk=16384):
        """(...,) float64: the yardstick of the log-likelihood's rounding at
        the absolute parameters ``p`` (..., ndim), plain PyTorch: 0.5 x the
        summed magnitudes of the per-point residual terms (the log term of
        the intrinsic scatter included, non-finite terms counted as 0; they
        cancel near an optimum, their rounding does not) plus the magnitude
        of the constant added to their sum. Without the scatter it is
        |ll - c| + |c|. Evaluated ``chunk`` rows at a time."""
        const = abs(self.offset if self.use_sigma else self.log_norm_const)
        flat = p.reshape(-1, p.shape[-1]).to(torch.float64)
        parts = [0.5 * torch.nan_to_num(self.residual_terms(c).double().abs(), nan=0.0,
                                        posinf=0.0).sum(dim=-1) + const
                 for c in flat.split(chunk)]
        return torch.cat(parts).reshape(p.shape[:-1])

    def forward(self, p):
        """Plain torch log-likelihood of each row of ``p`` (W, ndim), the
        band flux included on every device."""
        squeeze = p.ndim == 1
        p = p.reshape(-1, p.shape[-1])
        const = self.offset if self.use_sigma else self.log_norm_const
        ll = -0.5 * torch.sum(self.residual_terms(p), dim=-1) + const
        return ll[0] if squeeze else ll
