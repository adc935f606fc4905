"""The companion-shocking models of the port (CompanionShocking 1-3, the
SiFTO template, ``ops/interpolate.py::ppoly_eval``) against the JAX package,
on the CPU (``device="cpu"``: the plain versions of K8 and the CS kernels).

Inputs are made from a seed with numpy (the synthetic SN 2017cbv-style Ia
light curve of ``tests/test_companion_shocking.py::make_ia_lc``) and go
through both packages. Tolerances:

* ``ppoly_eval``, ``notaknot_cubic_coeffs`` and every model's
  ``_sifto_coeffs``: bit-equal (the same float64 operations);
* ``_eval_points``, ``evaluate`` (pointwise, outer, outer over parameter
  vectors), ``stretched_sifto``, ``companion_shocking``, ``t_min``,
  ``t_max``: <= 1e-12 relative in float64;
* the batched log-posterior: <= 1e-10 of the term scale in float64 (the
  reduction order over 108 points differs); the port's float32 path against
  the JAX package's **float64** values, <= 1e-5 of the term scale (the JAX
  package's own float32 Kasen temperature underflows, see
  ``test_float32_kasen_temperature_does_not_underflow``);
* one stretch step under shared draws: accept flags identical, states
  <= 1e-12, log-posteriors <= 1e-10 relative;
* the residual sum in the order of the CS kernels' warp form (a warp per
  walker), emulated in float32: <= 1e-5 of the term scale from the plain
  float32 sum and from the JAX package's float64 values.

The term scale of a log-likelihood is 0.5 x the summed magnitudes of its
per-point residual terms plus the magnitude of its constant: the rounding
follows the terms, which cancel near the best fit, not their sum.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from lightcurve_fitting_tpu import models as jmodels  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.filters import filtdict as jfd  # noqa: E402
from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import UniformPrior as JU, LogUniformPrior as JLU  # noqa: E402
from lightcurve_fitting_tpu.ops import extinction as jext, interpolate as jinterp  # noqa: E402
from lightcurve_fitting_tpu.parallel import sampler as jsampler  # noqa: E402

from lightcurve_fitting_tpu_torch import interop, kernels, models as tmodels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict as tfd  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import LogPosterior, lightcurve_mcmc  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import cs  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models.base import _quad_tensors  # noqa: E402
from lightcurve_fitting_tpu_torch.ops import extinction as text, interpolate as tinterp  # noqa: E402

from test_companion_shocking import make_ia_lc  # noqa: E402
from test_torch_kernels import _warp_order_sum  # noqa: E402

NAMES = {1: "CompanionShocking", 2: "CompanionShocking2", 3: "CompanionShocking3"}
PRIORS = {2: [JU(57815.0, 57825.0), JU(0.01, 5.0), JU(0.1, 10.0), JU(57835.0, 57845.0),
              JU(0.6, 1.6), JU(-5.0, 5.0), JU(-5.0, 5.0)]}       # test_companion_shocking.py:112
PRIORS[1] = PRIORS[2][:5] + [JU(0.1, 10.0)] * 3
PRIORS[3] = PRIORS[2][:2] + [JU(0.0, 180.0)] + PRIORS[2][3:]
P_LO = {2: np.array([57818.0, 0.2, 0.5, 57838.0, 0.8, -1.0, -1.0])}
P_UP = {2: np.array([57822.0, 1.0, 2.0, 57842.0, 1.2, 1.0, 1.0])}
P_LO[1], P_UP[1] = np.append(P_LO[2][:5], [0.8] * 3), np.append(P_UP[2][:5], [1.2] * 3)
P_LO[3], P_UP[3] = P_LO[2].copy(), P_UP[2].copy()
P_LO[3][2], P_UP[3][2] = 0.0, 90.0


def _port_lc(jlc, col="lum"):
    """The port's LC with the rows of the JAX package's ``jlc``."""
    t = np.asarray(jlc["MJD"], float)
    f = np.array([tfd[x.name] for x in np.asarray(jlc["filter"])])
    return TLC([t, f, np.asarray(jlc[col], float), np.asarray(jlc["d" + col], float)],
               names=["MJD", "filter", col, "d" + col])


@pytest.fixture(scope="module")
def lcs():
    jlc, _, _ = make_ia_lc(seed=3)
    return jlc, _port_lc(jlc)


def _generating_lc(tlc):
    """The port's copy of make_ia_lc's seed curve (every point 2e15): a
    model built on it has the SiFTO scaling of the truth (the scaling is
    data-derived, reference models.py:716)."""
    lum = np.full(len(tlc), 2e15)
    return TLC([np.asarray(tlc["MJD"], float), np.asarray(tlc["filter"]), lum, 0.05 * lum],
               names=["MJD", "filter", "lum", "dlum"])


def _models(variant, lcs, **kw):
    jlc, tlc = lcs
    return getattr(jmodels, NAMES[variant])(jlc, **kw), getattr(tmodels, NAMES[variant])(tlc, **kw)


# ------------------------------------------------------------------ splines

def _ppoly_inputs(seed=0):
    """The SiFTO knots, random coefficients (4, 102) and per point (N, 4,
    102), and query points on every knot, at and just beyond both ends, far
    outside, between knots, NaN and +-inf."""
    rng = np.random.default_rng(seed)
    knots = np.arange(-17.0, 86.0)
    c = rng.normal(size=(4, 102))
    xq = np.concatenate([knots, [-17.0, 85.0, -17.0 - 1e-9, 85.0 + 1e-9, -40.0, 200.0,
                                 np.nan, np.inf, -np.inf], rng.uniform(-20.0, 90.0, 200)])
    c_pt = rng.normal(size=(xq.size, 4, 102))
    return knots, c, c_pt, xq


@pytest.mark.parametrize("extrapolate", ["clip", "nan"])
def test_ppoly_eval_matches_jax_bit_for_bit(extrapolate):
    knots, c, c_pt, xq = _ppoly_inputs()
    want = np.asarray(jinterp.ppoly_eval(knots, c, jnp.asarray(xq), extrapolate=extrapolate))
    got = tinterp.ppoly_eval(knots, c, torch.as_tensor(xq), extrapolate=extrapolate).numpy()
    np.testing.assert_array_equal(got, want)
    # per-point coefficients, as _ppoly_batched takes them, over a walker axis
    want = np.asarray(jmodels.companion_shocking._ppoly_batched(knots, c_pt, jnp.asarray(xq)))
    got = tmodels.companion_shocking._ppoly_batched(knots, c_pt, torch.as_tensor(xq)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[np.isin(xq, [np.nan, np.inf, -np.inf, -40.0, 200.0])]).all()
    xw = torch.as_tensor(np.stack([xq, xq[::-1]]))
    both = tmodels.companion_shocking._ppoly_batched(knots, c_pt, xw).numpy()
    np.testing.assert_array_equal(both[0], got)
    # the host twin and the numpy half of the extinction spline are the same function
    np.testing.assert_array_equal(tinterp.ppoly_eval_np(knots, c, xq, extrapolate),
                                  jinterp.ppoly_eval_np(knots, c, xq, extrapolate))


def test_notaknot_and_f99_tensor_curve_match_jax():
    x = np.linspace(-3.0, 7.0, 23)
    y = np.sin(x) + 0.1 * x ** 2
    np.testing.assert_array_equal(tinterp.notaknot_cubic_coeffs(x, y),
                                  jinterp.notaknot_cubic_coeffs(x, y))
    wave = np.geomspace(1100.0, 30000.0, 97)
    for rv in (3.1, 2.5):
        want = np.asarray(jext.f99_k_jax(jnp.asarray(wave), rv))
        got = text.f99_k_tensor(torch.as_tensor(wave), rv).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_sifto_coeffs_bit_equal(lcs, variant):
    """Every model's per-filter template scaling equals the JAX package's,
    bit for bit: the coefficients the kernels read come from the data."""
    jm, tm = _models(variant, lcs)
    assert {f.name for f in tm._sifto_coeffs} == {f.name for f in jm._sifto_coeffs}
    for filt, coeffs in jm._sifto_coeffs.items():
        np.testing.assert_array_equal(tm._sifto_coeffs[tfd[filt.name]], coeffs)
    np.testing.assert_array_equal(tm._epochs, jm._epochs)
    assert len(tmodels.sifto) == len(jmodels.sifto) == 103
    assert tm._epochs[0] == -17.0 and tm._epochs[-1] == 85.0
    assert str(tmodels.M_chandra) == str(jmodels.M_chandra)


def test_sifto_scaling_special_cases():
    """DLT40 and unfiltered data take the r template scaled by the DLT40
    maximum (reference models.py:701-714), and the scaling takes the
    mask-respecting maximum (test_companion_shocking.py:166-181)."""
    jlc, _, _ = make_ia_lc(with_noise=False)
    t = np.asarray(jlc["MJD"], float)
    lum = np.asarray(jlc["lum"], float)
    n = len(t)
    names = ["r", "DLT40", "unfilt."]
    for LC_, fd, out in ((JLC, jfd, "j"), (TLC, tfd, "t")):
        f = np.array([fd[names[i % 3]] for i in range(n)])
        lc = LC_([t, f, lum * (1.0 + 0.1 * (np.arange(n) % 3)), 0.05 * lum],
                 names=["MJD", "filter", "lum", "dlum"])
        if out == "j":
            jm = jmodels.CompanionShocking2(lc)
        else:
            tm = tmodels.CompanionShocking2(lc)
    for name in names:
        np.testing.assert_array_equal(tm._sifto_coeffs[tfd[name]], jm._sifto_coeffs[jfd[name]])
    np.testing.assert_array_equal(tm._sifto_coeffs[tfd["unfilt."]],
                                  tm._sifto_coeffs[tfd["DLT40"]])
    # the masked maximum: garbage hidden under the mask does not scale the template
    tlc = _port_lc(jlc)
    clean = tmodels.CompanionShocking2(tlc)
    masked = np.ma.MaskedArray(np.asarray(tlc["lum"], float), mask=np.zeros(n, bool))
    masked[0] = float(masked.max()) * 1e6
    masked.mask[0] = True
    tlc["lum"] = masked
    for filt, coeffs in clean._sifto_coeffs.items():
        np.testing.assert_array_equal(tmodels.CompanionShocking2(tlc)._sifto_coeffs[filt],
                                      coeffs)


# ------------------------------------------------------------------- models

def _params(variant, n, seed):
    """n parameter vectors of the CS window, the last two with t_0 after
    the first epochs."""
    p = np.random.default_rng(seed).uniform(P_LO[variant], P_UP[variant],
                                            size=(n, len(P_LO[variant])))
    p[-2:, 0] = [57822.5, 57823.5]
    return p


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_eval_points_and_evaluate_match_jax(lcs, variant):
    jlc, tlc = lcs
    jm, tm = _models(variant, lcs, kappa=0.8)
    t = np.asarray(tlc["MJD"], float)
    jf, tf = np.asarray(jlc["filter"]), np.asarray(tlc["filter"])
    jq = jm.prepare_quad(jf)
    tq_np = tm.prepare_quad(tf)
    for k in jq:
        np.testing.assert_array_equal(tq_np[k], jq[k])
    tq = _quad_tensors(tq_np, "cpu")
    p = _params(variant, 5, 1)
    for row in p:
        a = np.asarray(jm._eval_points(jnp.asarray(t), jq, *[jnp.asarray(v) for v in row]))
        b = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(v) for v in row])
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=0)
    yb = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(p[:, i:i + 1])
                                                   for i in range(p.shape[1])]).numpy()
    for w, row in enumerate(p):
        yw = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(v) for v in row])
        np.testing.assert_allclose(yb[w], yw.numpy(), rtol=1e-14, atol=0)
    # evaluate: pointwise, outer with scalar and vector parameters, kappa
    args = tuple(p[0])
    np.testing.assert_allclose(tm.evaluate(t[:30], tf[:30], *args),
                               jm.evaluate(t[:30], jf[:30], *args), rtol=1e-12, atol=0)
    jb = [jfd[n] for n in ("U", "r", "i")]
    tb = [tfd[n] for n in ("U", "r", "i")]
    tgrid = np.linspace(57800.0, 57900.0, 9)
    for extra in ({}, {"kappa": 1.3}):
        a, b = jm.evaluate(tgrid, jb, *args, **extra), tm.evaluate(tgrid, tb, *args, **extra)
        assert b.shape == (3, 9)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    vec = tuple(p[:3, i] if i in (1, 4) else p[0, i] for i in range(p.shape[1]))
    a, b = jm.evaluate(tgrid, jb, *vec), tm.evaluate(tgrid, tb, *vec)
    assert b.shape == (3, 9, 3)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    assert tm.t_min(args) == jm.t_min(args) and tm.t_max(args) == jm.t_max(args)


def test_components_and_stretched_sifto_match_jax(lcs):
    """stretched_sifto in its three broadcasting modes, companion_shocking,
    temperature_radius (scalar and vector parameters, kappa)."""
    jm, tm = _models(2, lcs)
    jb = np.array([jfd[n] for n in ("U", "B", "r")], dtype=object)
    tb = np.array([tfd[n] for n in ("U", "B", "r")], dtype=object)
    t3 = np.array([57835.0, 57840.0, 57845.0])
    tgrid = np.linspace(57800.0, 57900.0, 50)
    cases = [((t3, 57840.0, 1.0), {}), ((t3, 57840.0, np.array([0.9, 1.0])), {}),
             ((tgrid, 57840.0, 1.0), {"dtU": 3.0}),
             ((tgrid, np.full(5, 57840.0), np.full(5, 1.1), np.full(5, 1.0), np.full(5, -0.5)),
              {})]
    for args, kw in cases:
        a = jm.stretched_sifto(args[0], jb, *args[1:], **kw)
        b = tm.stretched_sifto(args[0], tb, *args[1:], **kw)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    t = np.array([57822.0, 57824.0, 57830.0])
    np.testing.assert_allclose(tm.companion_shocking(t, tb, 57820.0, 0.5, 1.0),
                               jm.companion_shocking(t, jb, 57820.0, 0.5, 1.0), rtol=1e-12)
    for args in [(57820.0, 0.5, 1.0), (57820.0, np.array([0.4, 0.6]), 1.0, 0.7)]:
        for a, b in zip(jm.temperature_radius(tgrid, *args), tm.temperature_radius(tgrid, *args)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=0)


def test_float32_kasen_temperature_does_not_underflow(lcs):
    """The JAX package's float32 path loses the Kasen component from ~4 d
    after t_0 (tt^-74 underflows: a relative error of ~-1 there); the
    port's float32 U-band Kasen L_nu stays within 1e-5 of the JAX package's
    float64 value at 1-30 d, and so does its float32 log-likelihood."""
    jlc, tlc = lcs
    jm, tm = _models(2, lcs)
    tt = np.array([1.0, 4.0, 6.0, 10.0, 20.0, 30.0])
    t = 57820.0 + tt
    jq = jm.prepare_quad(np.array([jfd["U"]] * 6))
    tq = _quad_tensors(tm.prepare_quad(np.array([tfd["U"]] * 6)), "cpu")
    args = (57820.0, 0.5, 1.0)
    k64 = np.asarray(jm._kasen_points(jnp.asarray(t), jq, *args))
    try:
        jconfig.set_compute_dtype(jnp.float32)
        tconfig.set_compute_dtype(torch.float32)
        k32_jax = np.asarray(jm._kasen_points(jnp.asarray(t), jq, *args), float)
        k32 = tm._kasen_points(torch.as_tensor(t), tq, *args).double().numpy()
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert np.all(k64 > 1e18)
    assert np.all((k32_jax[1:] - k64[1:]) / k64[1:] < -0.99)          # the reference's fault
    np.testing.assert_allclose(k32, k64, rtol=1e-5, atol=0)            # the port's repair
    # the log-likelihood at points 4-30 d after t_0, float32 against JAX float64
    sel = np.asarray(jlc["MJD"], float) - 57820.0 >= 4.0
    jsub, tsub = jlc[sel], tlc[sel]
    p = np.array([57820.0, 0.5, 1.0, 57840.0, 1.0, 0.0, 0.0])
    want = float(jm.make_log_likelihood(jsub)(jnp.asarray(p)))
    try:
        tconfig.set_compute_dtype(torch.float32)
        ll = tm.make_log_likelihood(tsub, device="cpu")
        got = float(ll(torch.as_tensor(p[None]))[0])
        scale = float(ll.term_scales(torch.as_tensor(p[None]))[0])
    finally:
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert abs(got - want) <= 1e-5 * scale, (got, want, scale)


def _both(lcs, variant, p, f32, use_sigma=False, sigma_type="relative"):
    """The batched log-posterior of the JAX package (float64) and of the port
    (float32 when ``f32``) at ``p``, the port's log-likelihood built from the
    JAX quad dict; returns (jax, port, the port's term scales)."""
    jlc, tlc = lcs
    pri = PRIORS[variant] + ([JLU(0.01, 10.0)] if use_sigma else [])
    jm = getattr(jmodels, NAMES[variant])(jlc)
    a = np.asarray(jax.vmap(j_make(jm, jlc, pri, use_sigma, sigma_type))(jnp.asarray(p)))
    quad = jm.prepare_quad(np.asarray(jlc["filter"]))
    try:
        if f32:
            tconfig.set_compute_dtype(torch.float32)
        ll = interop.log_likelihood_from_numpy(
            quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["lum"], float),
            np.asarray(tlc["dlum"], float), use_sigma, sigma_type,
            model=getattr(tmodels, NAMES[variant])(tlc), dtype=torch.float32 if f32 else None)
        lp = LogPosterior(ll, interop.priors_from_jax(pri))
        before = dict(kernels.LAUNCHES)
        b = lp(torch.as_tensor(p)).numpy()
        assert kernels.LAUNCHES == before           # the CPU runs the plain path
        scale = ll.term_scales(torch.as_tensor(p)).numpy()
    finally:
        tconfig.set_compute_dtype(tconfig.AUTO)
    return a, b, scale


@pytest.mark.parametrize("variant,use_sigma,sigma_type",
                         [(1, False, "relative"), (2, False, "relative"), (3, False, "relative"),
                          (1, True, "relative"), (2, True, "absolute")],
                         ids=["cs1", "cs2", "cs3", "cs1-sigma", "cs2-sigma-absolute"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_log_posterior_batch_matches_jax(lcs, variant, use_sigma, sigma_type, f32):
    p = _params(variant, 40, 2)
    bad = p[:3].copy()
    bad[0, 0], bad[1, 4], bad[2, 1] = 57814.0, 1.7, np.nan     # outside the priors, NaN
    p = np.concatenate([p, bad])
    if use_sigma:
        p = np.concatenate([p, np.random.default_rng(3).uniform(0.5, 3.0, (len(p), 1))], axis=1)
    a, b, scale = _both(lcs, variant, p, f32, use_sigma, sigma_type)
    assert np.isfinite(b[:40]).all() and np.isneginf(b[40:]).all()
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    d = np.abs(b[fin] - a[fin]) / scale[fin]
    assert np.all(d <= (1e-5 if f32 else 1e-10)), d.max()


def test_ladder_init_copies_match_jax_init_carry(lcs):
    """K6b's plain version with copies > 1 (the ladder's call: one set of
    starting states for every rung) against the JAX package's init_carry
    on the rungs' copies, CS2 with the intrinsic scatter in float64: states
    outside the priors (log L evaluated all the same; a NaN a13 zeroes the
    Kasen term, as in the JAX package), a NaN scatter (log L NaN, so -inf)
    and t_0 after the first epochs (t < t_0 there), within 1e-10 of the
    term scale."""
    from lightcurve_fitting_tpu import fitting as jfit
    from test_torch_evidence import check_init_copies
    jlc, tlc = lcs
    p = _params(2, 40, 2)
    bad = p[:4].copy()
    bad[0, 0], bad[1, 4], bad[2, 1] = 57814.0, 1.7, np.nan     # outside the priors
    p = np.concatenate([np.concatenate([p, bad]),
                        np.random.default_rng(3).uniform(0.5, 3.0, (44, 1))], axis=1)
    p[43, 7] = np.nan
    pri_j = PRIORS[2] + [JLU(0.01, 10.0)]
    jm = jmodels.CompanionShocking2(jlc)
    jpri, jll, _, _, _ = jfit._tempered_setup(jlc, jm, pri_j, None, None, len(p), True,
                                              "relative", 0)
    ll = interop.log_likelihood_from_numpy(
        jm.prepare_quad(np.asarray(jlc["filter"])), np.asarray(tlc["MJD"], float),
        np.asarray(tlc["lum"], float), np.asarray(tlc["dlum"], float), True, "relative",
        model=tmodels.CompanionShocking2(tlc))
    pri, logl = check_init_copies(LogPosterior(ll, interop.priors_from_jax(pri_j)), jpri, jll,
                                  p, 4, 1e-10, ll.term_scales(torch.as_tensor(p)).numpy())
    assert np.isfinite(pri[:, :40]).all() and np.isneginf(pri[:, 40:]).all()
    assert np.isfinite(logl[:, :43]).all() and np.isneginf(logl[:, 43]).all()


def test_warp_sum_order_stays_within_the_yardstick(lcs):
    """The CS half-step and K6a over CS run a warp per walker, which sums a
    walker's 108 residual terms in another order than the plain version.
    Emulated in float32 on 1024 CS2 walkers from the 32768-walker fit's
    window, that order gives every lane the same bits, stays within 1e-5 of
    the term scale (the card tests' float32 tolerance) of the plain float32
    sum and of the JAX package's float64 log-posterior, and differs from the
    plain sum on some walker: the tolerance, not bit equality, is what holds
    the kernels to their plain versions."""
    jlc, tlc = lcs
    jm = jmodels.CompanionShocking2(jlc)
    p = np.random.default_rng(11).uniform(P_LO[2], P_UP[2], size=(1024, 7))
    want = np.asarray(jax.vmap(j_make(jm, jlc, PRIORS[2]))(jnp.asarray(p)))
    quad = jm.prepare_quad(np.asarray(jlc["filter"]))
    q = torch.as_tensor(p)
    try:
        tconfig.set_compute_dtype(torch.float32)
        ll = interop.log_likelihood_from_numpy(
            quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["lum"], float),
            np.asarray(tlc["dlum"], float), model=tmodels.CompanionShocking2(tlc),
            dtype=torch.float32)
        terms = ll.residual_terms(q)
        plain = ll(q).double()
        scale = ll.term_scales(q)
    finally:
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert terms.dtype == torch.float32 and tuple(terms.shape) == (1024, 108)
    lanes = _warp_order_sum(terms)
    assert torch.equal(lanes, lanes[:, :1].expand(-1, 32))
    const = torch.tensor(ll.log_norm_const, dtype=torch.float32)
    warp = (torch.tensor(-0.5, dtype=torch.float32) * lanes[:, 0] + const).double()
    assert torch.isfinite(warp).all() and torch.isfinite(plain).all()
    assert bool(((warp - plain).abs() <= 1e-5 * scale).all())
    assert bool((warp != plain).any())
    assert np.all(np.abs(warp.numpy() - want) <= 1e-5 * scale.numpy())


def _jax_draws(key, half):
    """The draws half_update makes from ``key`` (parallel/sampler.py:87-92)."""
    kz, kj, ku = jr.split(key, 3)
    return (np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64)),
            np.asarray(jr.randint(kj, (half,), 0, half)),
            np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64)))


def test_step_matches_jax_under_shared_draws(lcs):
    jlc, tlc = lcs
    jm = jmodels.CompanionShocking2(jlc)
    jlp = j_make(jm, jlc, PRIORS[2])
    quad = jm.prepare_quad(np.asarray(jlc["filter"]))
    tlp = LogPosterior(interop.log_likelihood_from_numpy(
        quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["lum"], float),
        np.asarray(tlc["dlum"], float), model=tmodels.CompanionShocking2(tlc)),
        interop.priors_from_jax(PRIORS[2]))
    W, ndim = 64, 7
    half = W // 2
    pos = np.random.default_rng(3).uniform(P_LO[2], P_UP[2], size=(W, ndim)).reshape(2, half, ndim)
    jstep, jbatched = jsampler.make_stretch_kernel(jlp, half, ndim)
    jx = jnp.asarray(pos)
    jl = jbatched(jx.reshape(-1, ndim)).reshape(2, half)
    x, logp = interop.walkers_from_numpy(pos, np.asarray(jl))
    key = jr.PRNGKey(5)
    for i in range(3):
        k = jr.fold_in(key, i)
        (jx, jl), (_, _, jacc) = jstep((jx, jl), k)
        draws = [_jax_draws(kh, half) for kh in jr.split(k)]
        u_z, j, u_acc = (torch.as_tensor(np.stack([d[n] for d in draws])) for n in range(3))
        acc = torch.zeros((2, half), dtype=torch.int32)
        for h in (0, 1):
            kernels.stretch_half_step(tlp, x, logp, h, u_z[h], j[h].to(torch.int64), u_acc[h],
                                      n_accept=acc)
        assert np.array_equal(acc.bool().numpy(), np.asarray(jacc))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=0)
        np.testing.assert_allclose(logp.numpy(), np.asarray(jl), rtol=1e-10, atol=0)
    assert 0 < int(np.asarray(jacc).sum()) < W


def test_cs2_fit_recovers_truth(lcs):
    """The port of test_companion_shocking.py::test_companion_shocking2_fit_
    recovers_truth on the CPU, with that test's priors, window, size and
    criteria. The seed is this test's own: the port's generator draws other
    numbers than the JAX package's from the same seed, and the stretch's
    posterior is wide, so the median of a 32 x 550 chain moves by about 0.1
    with the seed; seed 1 meets the JAX test's +-0.15."""
    _, tlc = lcs
    tlc.meta["redshift"] = 0.0
    model = tmodels.CompanionShocking2(_generating_lc(tlc))
    sampler = lightcurve_mcmc(tlc, model, priors=interop.priors_from_jax(PRIORS[2]),
                              p_lo=list(P_LO[2]), p_up=list(P_UP[2]), nwalkers=32, nsteps=250,
                              nsteps_burnin=300, seed=1, quiet=True, device="cpu")
    med = np.median(sampler.flatchain, axis=0)
    assert med[0] == pytest.approx(57820.0, abs=1.0)
    assert med[3] == pytest.approx(57840.0, abs=1.0)
    assert med[4] == pytest.approx(1.0, abs=0.15)
    assert 0.1 < sampler.acceptance_fraction.mean() < 0.9


def test_interop_nine_parameters(lcs):
    """CompanionShocking with the intrinsic scatter (9 parameters) through
    interop: the JAX quad's SiFTO entries become the port's per-band rows,
    its kernel parameter block takes ndim = 9, and the log-posterior equals
    the JAX package's."""
    jlc, tlc = lcs
    jm = jmodels.CompanionShocking(jlc)
    quad = jm.prepare_quad(np.asarray(jlc["filter"]))
    ll = interop.log_likelihood_from_numpy(
        quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["lum"], float),
        np.asarray(tlc["dlum"], float), use_sigma=True, model=tmodels.CompanionShocking(tlc))
    pri = interop.priors_from_jax(PRIORS[1] + [JLU(0.01, 10.0)])
    lp = LogPosterior(ll, pri)
    assert tuple(ll.sifto_rows.shape) == (6, 4, 102)
    np.testing.assert_array_equal(ll.quad["sifto_c"].numpy(), quad["sifto_c"])
    for name in ("is_U", "is_i", "is_r"):
        np.testing.assert_array_equal(ll.quad[name].numpy(), quad[name])
    P = cs._kernel_params(lp, 9, None, None)
    assert P.ndim == 9 and P.variant == 1 and P.use_sigma == 1
    pos = np.concatenate([_params(1, 8, 4), np.full((8, 1), 1.5)], axis=1)
    x, logp = interop.walkers_from_numpy(pos, np.zeros(8))
    assert tuple(x.shape) == (2, 4, 9)
    want = np.asarray(jax.vmap(j_make(jm, jlc, PRIORS[1] + [JLU(0.01, 10.0)], True))(
        jnp.asarray(pos)))
    np.testing.assert_allclose(lp(torch.as_tensor(pos)).numpy(), want, rtol=1e-10, atol=0)


# ------------------------------------------------------------------------------
# the JAX package's reference values of chip_smoke.py's companion-shocking
# main path (phase 24), float64 on the CPU: not a test, run by hand
# (PYTHONPATH=. python tests/test_torch_companion.py)
# ------------------------------------------------------------------------------

def jax_cs_references():
    """The JAX package's mean acceptance of CompanionShocking2 (make_ia_lc's
    generating model, whose SiFTO scaling is the truth's) on make_ia_lc
    (seed 3) at 32768 walkers x 300 steps from the window of
    test_companion_shocking.py:116-117, no burn-in, seed 7, and its
    stepping-stone log Z at 4096 walkers x 16 rungs + beta = 1 x 150 + 150
    steps, seed 1, both with that test's priors, float64 on the CPU."""
    import contextlib
    import io
    from lightcurve_fitting_tpu.fitting import lightcurve_evidence, lightcurve_mcmc as j_mcmc
    jlc, _, model = make_ia_lc(seed=3)
    jlc.meta["redshift"] = 0.0
    kw = dict(p_lo=list(P_LO[2]), p_up=list(P_UP[2]))
    with contextlib.redirect_stdout(io.StringIO()):
        s = j_mcmc(jlc, model, PRIORS[2], nwalkers=32768, nsteps=300,
                   nsteps_burnin=0, seed=7, quiet=True, shard=False, **kw)
        acc = float(np.mean(s.acceptance_fraction))
        log_z, err = lightcurve_evidence(jlc, model, PRIORS[2],
                                         nwalkers=4096, n_rungs=16, nsteps=150,
                                         nsteps_burnin=150, seed=1, quiet=True, **kw)[:2]
    return {"acceptance": acc, "log_z": (log_z, err)}


if __name__ == "__main__":
    print(jax_cs_references())
