"""The posterior diagnostics of the port against the JAX package, on the CPU:
``parallel/ic.py`` (WAIC, PSIS-LOO, PSIS-LOGO, the paired comparison and
the stacking weights), bit-equal on seeded matrices; ``_posterior_discrepancy``
(chi2 and the pointwise log-density) on the same draws for ShockCooling2,
ShockCooling3, CompanionShocking2, ShockCooling and ShockCooling4, to 1e-10
relative in float64 (the point sums run in another order); and
``goodness_of_fit``, ``information_criteria`` (with ``group_by``) and
``compare_information_criteria`` on the same flatchain, to 1e-9 relative
(the host statistics of a matrix that agrees to 1e-10). Then the port's
``compare_models_loo`` at a small size, its refusals, and the goodness-of-fit
line each fit driver prints.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu import fitting as jfit, models as jmodels  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.parallel import ic as jic  # noqa: E402

from lightcurve_fitting_tpu_torch import fitting as tfit, interop, models as tmodels  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import ic as tic  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
D_L = 10 ** (30.79 / 5 + 1) / 1e6
# a cloud about each model's posterior region on SN 2016bkv's early curve
# (centre, spread), the CS cloud on the synthetic Ia curve's truth
CLOUDS = {
    "ShockCooling2": ([30.0, 4.0, 20.0, 57468.6], [0.5, 0.05, 0.5, 0.01]),
    "ShockCooling3": ([0.44, 0.67, 8.1, 6.6, D_L, 0.024, 57468.63],
                      [0.02, 0.05, 0.5, 0.3, 0.001, 0.005, 0.02]),
    "ShockCooling": ([1.0, 2.0, 1.0, 3.0, 57468.5], [0.1, 0.2, 0.1, 0.3, 0.05]),
    "ShockCooling4": ([1.0, 2.0, 1.0, 3.0, 57468.5], [0.1, 0.2, 0.1, 0.3, 0.05]),
    "CompanionShocking2": ([57820.0, 0.6, 1.25, 57840.0, 1.0, 0.0, 0.0],
                           [0.5, 0.1, 0.2, 0.5, 0.05, 0.2, 0.2]),
}


def _early(LC, flux=False):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    lc = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    if flux:
        lc.calcFlux()
    return lc


@pytest.fixture(scope="module")
def lcs():
    return _early(JLC), _early(TLC)


def _pair(name, lcs):
    """(JAX light curve, JAX model, port light curve, port model) of
    ``name`` on its light curve."""
    jlc, tlc = lcs
    if name == "CompanionShocking2":
        from test_companion_shocking import make_ia_lc
        from test_torch_companion import _port_lc
        jlc = make_ia_lc(seed=3)[0]
        tlc = _port_lc(jlc)
    elif name == "ShockCooling3":
        jlc, tlc = _early(JLC, True), _early(TLC, True)
    jm = getattr(jmodels, name)(jlc)
    return jlc, jm, tlc, interop.model_from_jax(jm, tlc)


def _cloud(name, n, seed=0):
    mu, sd = (np.asarray(v, float) for v in CLOUDS[name])
    return np.random.default_rng(seed).normal(mu, sd, size=(n, len(mu)))


# ----------------------------------------------------------- parallel/ic.py

def _assert_same(a, b):
    """Bit-equal results: dicts, lists and arrays of floats (NaN where NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_ic_is_the_jax_copy_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    S, N = 400, 24
    ll = rng.normal(-2.0, 1.0, size=(S, N)) + rng.standard_t(3, size=(S, 1)) * (seed + 0.5)
    groups = np.repeat(np.array(["g", "r", "i", "B"]), N // 4)
    for fn in ("waic", "psis_loo"):
        _assert_same(getattr(tic, fn)(ll), getattr(jic, fn)(ll))
    _assert_same(tic.psis_logo(ll, groups), jic.psis_logo(ll, groups))
    x = np.exp(rng.normal(size=60))
    _assert_same(tic.gpd_fit(x), jic.gpd_fit(x))
    pw = [rng.normal(-1.0, 0.5, N) for _ in range(3)]
    _assert_same(tic.compare_elpd(pw, ["a", "b", "c"]), jic.compare_elpd(pw, ["a", "b", "c"]))
    _assert_same(tic.stacking_weights(pw), jic.stacking_weights(pw))


# ------------------------------------------------------ the discrepancy op

@pytest.mark.parametrize("name", ["ShockCooling2", "ShockCooling3", "CompanionShocking2",
                                  "ShockCooling", "ShockCooling4"])
def test_posterior_discrepancy_matches_jax(lcs, name):
    jlc, jm, tlc, tm = _pair(name, lcs)
    draws = _cloud(name, 48)
    draws[-2:, 0] = draws[-2:, 0] + (5.0 if "Companion" in name else 0.0)   # late t_0 / t_exp
    for use_sigma in (False, True):
        d = np.concatenate([draws, np.full((len(draws), 1), 0.5)], 1) if use_sigma else draws
        for kind in ("chi2", "pointwise_ll"):
            a, ya, na = jfit._posterior_discrepancy(jlc, jm, d, use_sigma, "relative", kind)
            b, yb, nb = tfit._posterior_discrepancy(tlc, tm, d, use_sigma, "relative", kind,
                                                    device="cpu")
            assert (ya, na) == (yb, nb) and b.shape == a.shape
            assert np.array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=1e-10, atol=0)


# ------------------------------------------- the diagnostics on one flatchain

def test_goodness_of_fit_and_information_criteria_match_jax(lcs, capsys):
    jlc, jm, tlc, tm = _pair("ShockCooling2", lcs)
    flat = _cloud("ShockCooling2", 600, seed=2)
    best = np.array([30.0, 4.0, 20.0, 57468.6])
    for kw in ({}, {"best": best}, {"n_draws": 64, "seed": 3}):
        a = jfit.goodness_of_fit(jlc, jm, flat, quiet=True, **kw)
        b = tfit.goodness_of_fit(tlc, tm, flat, device="cpu", **kw)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9)
    out = capsys.readouterr().out
    assert out.count("goodness of fit: chi^2/dof = ") == 3
    ics = {}
    for label, fl in (("a", flat), ("b", _cloud("ShockCooling2", 600, seed=4) * [1, 1, 1.05, 1])):
        a = jfit.information_criteria(jlc, jm, fl, group_by="filter", n_draws=300, quiet=True)
        b = tfit.information_criteria(tlc, tm, fl, group_by="filter", n_draws=300, device="cpu")
        for k in ("elpd_loo", "se_elpd_loo", "p_loo", "looic", "pareto_k", "elpd_waic",
                  "se_elpd_waic", "p_waic", "waic", "pointwise", "pointwise_waic"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-9)
        assert (b["n_points"], b["n_invalid_draws"]) == (a["n_points"], a["n_invalid_draws"])
        assert [g.name for g in b["logo"]["groups"]] == [g.name for g in a["logo"]["groups"]]
        for k in ("elpd_logo", "se_elpd_logo", "pointwise", "pareto_k"):
            np.testing.assert_allclose(b["logo"][k], a["logo"][k], rtol=1e-9, atol=1e-9)
        ics[label] = (a, b)
    assert "leave-one-group-out" in capsys.readouterr().out
    ta = jfit.compare_information_criteria([v[0] for v in ics.values()], labels=["a", "b"],
                                           quiet=True)
    tb = tfit.compare_information_criteria([v[1] for v in ics.values()], labels=["a", "b"])
    assert list(tb.colnames) == ["model", "elpd_loo", "d_elpd", "se_d_elpd", "stacking_weight"]
    assert list(tb["model"]) == list(ta["model"])
    for k in tb.colnames[1:]:
        np.testing.assert_allclose(np.asarray(tb[k], float), np.asarray(ta[k], float),
                                   rtol=1e-9, atol=1e-9)
    assert "model ranking by PSIS-LOO elpd" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unique"):
        tfit.compare_information_criteria([ics["a"][1], ics["b"][1]], labels=["x", "x"])


# ---------------------------------------------- compare_models_loo and drivers

def _synthetic():
    """ShockCooling2 photometry in g, r, i at 5 epochs (the JAX tests'
    recipe), a port light curve."""
    from lightcurve_fitting_tpu_torch.filters import filtdict as tfd
    rng = np.random.default_rng(11)
    t = np.repeat(np.linspace(1.0, 8.0, 5), 3)
    f = np.array([tfd[n] for n in ("g", "r", "i")] * 5)
    y = tmodels.ShockCooling2()(t, f, 12.0, 2.0, 35.0, 0.0)
    dy = 0.05 * y
    return TLC([t, f, y + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])


SNUG = [tmodels.UniformPrior(8.0, 16.0), tmodels.UniformPrior(1.0, 3.0),
        tmodels.UniformPrior(25.0, 45.0), tmodels.UniformPrior(-0.5, 0.5)]
WIDE = [tmodels.UniformPrior(1.0, 81.0), tmodels.UniformPrior(0.1, 20.1),
        tmodels.UniformPrior(5.0, 205.0), tmodels.UniformPrior(-5.0, 5.0)]


def test_compare_models_loo_small(capsys, monkeypatch):
    lc = _synthetic()
    models = [tmodels.ShockCooling2(lc), tmodels.ShockCooling2(lc)]
    tab = tfit.compare_models_loo(lc, models, [SNUG, WIDE], p_lo=[10.0, 1.5, 30.0, -0.2],
                                  p_up=[14.0, 2.5, 40.0, 0.2], labels=["snug", "wide"],
                                  nwalkers=16, nsteps=40, nsteps_burnin=40, seed=3,
                                  group_by="filter", device="cpu")
    assert list(tab.colnames) == ["model", "elpd_loo", "d_elpd", "se_d_elpd", "stacking_weight"]
    assert sorted(tab["model"]) == ["snug", "wide"] and tab["d_elpd"][0] == 0.0
    assert np.isfinite(np.asarray(tab["elpd_loo"], float)).all()
    assert set(tab.meta["ics"]) == {"snug", "wide"} and "logo" in tab.meta["ics"]["snug"]
    assert tab.meta["samplers"]["snug"].flatchain.shape == (16 * 40, 4)
    assert tab.meta["models"]["wide"] is models[1]
    assert "model ranking by PSIS-LOO elpd" in capsys.readouterr().out
    kw = dict(labels=["snug", "wide"], nwalkers=16, nsteps=4, nsteps_burnin=4, device="cpu")
    # refit runs the population: on the CPU every class reaches the fits, on
    # CUDA a class without population kernels (item 10) and init="map" over
    # SW17 (P3, item 22) refuse before any fit (the device check needs no card)
    sw17 = [models[0], tmodels.ShockCooling(lc)]
    cs2 = [models[0], tmodels.CompanionShocking2(lc)]
    pri2 = [SNUG, WIDE + [tmodels.UniformPrior(0.0, 1.0)]]

    class Fitted(Exception):
        pass

    def no_fit(*a, **k):
        raise Fitted
    with monkeypatch.context() as m:
        m.setattr(tfit, "lightcurve_mcmc", no_fit)
        for pair, ro in ((sw17, None), (cs2, None), (sw17, {"init": "window"})):
            with pytest.raises(Fitted):
                tfit.compare_models_loo(lc, pair, pri2, refit=True, refit_options=ro, **kw)
        cuda = dict(kw, device=torch.device("cuda"))
        with pytest.raises(Fitted):
            tfit.compare_models_loo(lc, sw17, pri2, refit=True, refit_options={"init": "window"},
                                    **cuda)
        with pytest.raises(NotImplementedError, match="item 22"):
            tfit.compare_models_loo(lc, sw17, pri2, refit=True, **cuda)
        with pytest.raises(NotImplementedError, match="item 10"):
            tfit.compare_models_loo(lc, cs2, pri2, refit=True, refit_options={"init": "window"},
                                    **cuda)
    with pytest.raises(NotImplementedError, match="item 16"):
        tfit.compare_models_loo(lc, models, [SNUG, WIDE], checkpoint_file="ck.npz", **kw)
    with pytest.raises(NotImplementedError, match="item 16"):
        tfit.compare_models_loo(lc, models, [SNUG, WIDE], resume_from="ck.npz", **kw)
    flat = tab.meta["samplers"]["snug"].flatchain
    ic_kw = dict(refit=True, priors=SNUG + [tmodels.UniformPrior(-1.0, 1.0)])
    with pytest.raises(NotImplementedError, match="item 22"):
        tfit.information_criteria(lc, sw17[1], np.c_[flat, flat[:, :1]],
                                  device=torch.device("cuda"), **ic_kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        tfit.information_criteria(lc, tmodels.ShockCooling3(lc), np.c_[flat, flat[:, :3]],
                                  device=torch.device("cuda"), refit_options={"init": "window"},
                                  refit=True, priors=SNUG + [tmodels.UniformPrior(-1.0, 1.0)] * 3)


@pytest.mark.parametrize("driver", ["mcmc", "hmc", "map", "ptmcmc"])
def test_each_driver_prints_the_goodness_of_fit(driver, capsys):
    """Each fit driver prints the goodness-of-fit line after the fit, as the
    JAX drivers do (lightcurve_map scores its MAP point)."""
    lc = _synthetic()
    model = tmodels.ShockCooling2(lc)
    kw = dict(p_lo=[10.0, 1.5, 30.0, -0.2], p_up=[14.0, 2.5, 40.0, 0.2], seed=5, device="cpu")
    if driver == "mcmc":
        tfit.lightcurve_mcmc(lc, model, SNUG, nwalkers=16, nsteps=20, nsteps_burnin=10, **kw)
    elif driver == "hmc":
        tfit.lightcurve_hmc(lc, model, SNUG, nchains=2, nsamples=10, n_warmup=10,
                            max_depth=3, warmup_walkers=16, warmup_steps=20, **kw)
    elif driver == "map":
        tfit.lightcurve_map(lc, model, SNUG, n_starts=4, n_iter=30, nsamples=50, **kw)
    else:
        tfit.lightcurve_ptmcmc(lc, model, SNUG, nwalkers=16, n_rungs=2, nsteps=10,
                               nsteps_burnin=10, **kw)
    out = capsys.readouterr().out
    assert "goodness of fit: chi^2/dof = " in out, out
    assert "goodness-of-fit unavailable" not in out
