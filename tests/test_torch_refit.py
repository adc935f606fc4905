"""The port's exact-refit cross-validation (``fitting._exact_cv_elpd``,
``_apply_refit`` and the ``refit`` branches of ``information_criteria`` and
``compare_models_loo``) against the JAX package's, on the CPU, and P1's form
rule (``kernels/pop.py::logpost_form``).

(a) Everything around the sampler, deterministically: one stub replaces
``fit_population`` in both packages' population modules, records what each
passes it and returns the same fixed chains to both; the refit box must be
the JAX package's bit for bit (a chain constant in one dimension, and chains
whose box the prior support collapses, on either side), and the held-out
scores, the patched pointwise values, elpd, se, looic and p_loo must agree
within 1e-10 relative in float64 (the pointwise log-densities agree to
1e-10: tests/test_torch_ic.py), with the same repaired and failed labels.
(b) One statistical end-to-end comparison on one chain: both packages refit
every point and band (threshold -inf) with their own samplers, the port
through its plain versions on the CPU; the flagged sets equal, no refit
failed, the exact elpds within tests/test_ic.py:437-444's tolerances, the
refits' mean acceptance within 0.02 of the JAX package's. (c) The entry
checks, and ``compare_models_loo`` forwarding the refit. (d) P1's form rule
at the shapes of ``chip_smoke.py`` 28a-c and of the refits, and its point
cap against the C++ define.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu import fitting as jfit, models as jmodels  # noqa: E402
from lightcurve_fitting_tpu.filters import filtdict as jfd  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.parallel import population as jpop  # noqa: E402

from lightcurve_fitting_tpu_torch import fitting as tfit, models as tmodels  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict as tfd  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import build, pop as kpop  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import population as tpop  # noqa: E402

TRUTH = np.array([12.0, 2.0, 15.0, 0.0])
BOUNDS = [(1.0, 50.0), (0.1, 20.0), (5.0, 100.0), (-1.0, 1.0)]   # tests/test_ic.py's priors
P_LO, P_UP = [8.0, 1.0, 8.0, -0.5], [16.0, 4.0, 30.0, 0.5]


def _curves(seed=2):
    """tests/test_ic.py's ``_synthetic_fit`` photometry (ShockCooling2 in g,
    r, i at 8 epochs, 24 points), as a JAX and a port light curve with their
    models and priors."""
    rng = np.random.default_rng(seed)
    t = np.repeat(np.linspace(1.0, 10.0, 8), 3)
    names = ["g", "r", "i"] * 8
    y = jmodels.ShockCooling2()(t, np.array([jfd[n] for n in names]), *TRUTH)
    dy = 0.05 * y
    y = y + rng.normal(scale=dy)
    out = []
    for LC, fd, mods in ((JLC, jfd, jmodels), (TLC, tfd, tmodels)):
        lc = LC([t, np.array([fd[n] for n in names]), y, dy],
                names=["MJD", "filter", "lum", "dlum"])
        out.append((lc, mods.ShockCooling2(lc), [mods.UniformPrior(*b) for b in BOUNDS]))
    return out


def _cloud(n=400, seed=0):
    return np.random.default_rng(seed).normal(TRUTH, [0.3, 0.05, 0.5, 0.05], size=(n, 4))


class _Stub:
    """One ``fit_population`` for both packages: records each call's window,
    curve lengths and options, and returns G fixed chains (64 draws about the
    truth, from numpy's default_rng(G)) and acceptances; with ``starve``, the
    refit of that index keeps 5 draws where the model is finite (the rest
    with a negative L_1), fewer than the 8 a score needs."""

    def __init__(self, starve=None):
        self.calls, self.starve = [], starve

    def __call__(self, models, lcs, priors, p_lo, p_up, **kw):
        kw.pop("device", None)
        self.calls.append((np.array(p_lo), np.array(p_up), [len(lc) for lc in lcs], kw))
        G = len(lcs)
        flat = np.random.default_rng(G).normal(TRUTH, [0.2, 0.03, 0.3, 0.03], size=(G, 64, 4))
        if self.starve is not None and self.starve < G:
            flat[self.starve, 5:, 1] = -2.0
        return flat, np.linspace(0.3, 0.5, G)


def _stubbed(monkeypatch, starve=None):
    stubs = (_Stub(starve), _Stub(starve))
    monkeypatch.setattr(jpop, "fit_population", stubs[0])
    monkeypatch.setattr(tpop, "fit_population", stubs[1])
    return stubs


def _same_calls(a, b):
    assert len(a.calls) == len(b.calls)
    for (lo_a, up_a, n_a, kw_a), (lo_b, up_b, n_b, kw_b) in zip(a.calls, b.calls):
        assert np.array_equal(lo_a, lo_b) and np.array_equal(up_a, up_b)
        assert n_a == n_b and kw_a == kw_b


def _close(got, want, rel=1e-10):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rel, atol=0)


def _names(labels):
    return [getattr(v, "name", v) for v in np.atleast_1d(labels)]


@pytest.mark.parametrize("case", ["cloud", "degenerate_and_collapsed_high", "collapsed_low"])
def test_exact_cv_box_and_scores_match_jax(monkeypatch, case):
    """(a) ``_exact_cv_elpd`` with the stub: the box each package hands the
    population bit for bit (the [2, 98] box; a dimension the chain pins,
    widened; t_exp beyond the prior's upper bound, collapsed by the clip and
    regrown down from it; below the lower bound, regrown up), the same
    curves and options, and the held-out elpds and acceptances of the
    leave-one-band-out masks within 1e-10 relative."""
    (jlc, jm, jpri), (tlc, tm, tpri) = _curves()
    flat = _cloud()
    if case == "degenerate_and_collapsed_high":
        flat[:, 1] = 2.0
        flat[:, 3] = np.linspace(1.2, 1.5, len(flat))
    elif case == "collapsed_low":
        flat[:, 3] = np.linspace(-1.5, -1.2, len(flat))
    stubs = _stubbed(monkeypatch)
    bands = np.array([f.name for f in jlc["filter"]])
    masks = [bands == b for b in ("g", "r", "i")]
    opts = dict(nwalkers=16, nsteps=10)
    ja = jfit._exact_cv_elpd(jlc, jm, jpri, masks, False, "relative", flat, 1024, 3, opts)
    ta = tfit._exact_cv_elpd(tlc, tm, tpri, masks, False, "relative", flat, 1024, 3, opts,
                             device="cpu")
    _same_calls(*stubs)
    lo, up = stubs[1].calls[0][:2]
    assert np.all(up > lo) and np.all(lo >= [b[0] for b in BOUNDS]) \
        and np.all(up <= [b[1] for b in BOUNDS])
    assert stubs[1].calls[0][2] == [16, 16, 16]
    assert stubs[1].calls[0][3] == dict(nwalkers=16, nsteps=10, nsteps_burnin=500, init="map",
                                        use_sigma=False, sigma_type="relative", seed=3)
    _close(ta[0], ja[0])
    assert np.isfinite(ta[0]).all() and np.array_equal(ta[1], ja[1])


@pytest.mark.parametrize("starve", [None, 1])
def test_information_criteria_refit_matches_jax_around_the_sampler(monkeypatch, starve):
    """(a) ``information_criteria(refit=-inf, group_by="filter")`` with the
    stub: every point and band refit; the patched pointwise values, elpd,
    se, looic and p_loo, the PSIS and exact values of the repaired entries
    and the acceptances within 1e-10 relative of the JAX package's; the same
    repaired and failed labels; with ``starve`` the refit of point 1 and of
    band r scores fewer than 8 finite draws, fails in both and keeps its
    PSIS value."""
    (jlc, jm, jpri), (tlc, tm, tpri) = _curves()
    flat = _cloud()
    stubs = _stubbed(monkeypatch, starve)
    kw = dict(group_by="filter", refit=-np.inf, seed=0, quiet=True)
    ja = jfit.information_criteria(jlc, jm, flat, priors=jpri, **kw)
    ta = tfit.information_criteria(tlc, tm, flat, priors=tpri, device="cpu", **kw)
    _same_calls(*stubs)
    assert [c[2] for c in stubs[1].calls] == [[23] * 24, [16, 16, 16]]
    for a, b, elpd, se in ((ja, ta, "elpd_loo", "se_elpd_loo"),
                           (ja["logo"], ta["logo"], "elpd_logo", "se_elpd_logo")):
        for k in ("pointwise", elpd, se, "pareto_k"):
            _close(b[k], a[k])
        ra, rb = a["refit"], b["refit"]
        assert rb["method"] == ra["method"] == "exact_refit_cv"
        assert _names(rb["labels"]) == _names(ra["labels"])
        assert _names(rb["failed_labels"]) == _names(ra["failed_labels"])
        assert rb["n_failed"] == ra["n_failed"] == (0 if starve is None else 1)
        for k in ("elpd_psis", "elpd_exact", "acceptance"):
            _close(rb[k], ra[k])
    for k in ("looic", "p_loo"):
        _close(ta[k], ja[k])
    if starve is not None:
        assert _names(ta["refit"]["failed_labels"]) == [1]
        assert _names(ta["logo"]["refit"]["failed_labels"]) == ["r"]


def test_information_criteria_refit_matches_jax_end_to_end():
    """(b) One chain (the port's ``lightcurve_mcmc`` on the CPU, tests/
    test_ic.py's 32 walkers x 400 + 400), every point and band refit by both
    packages with their own samplers (32 walkers x 300 + 300, MAP-seeded):
    the same flagged sets, no failed refit, each band's exact elpd within
    max(2, 0.3 |v|) of the JAX package's, more than 90% of the points within
    max(1, 0.3 |v|); the refits' mean acceptance within 0.02 of the JAX
    package's and each refit's within 0.045: a refit's acceptance at this
    size varies by ~0.009 between the two packages' random streams (sd over
    the 24 + 3 refits, no bias: mean differences -0.001 and +0.006), so 0.02
    a refit would fail on noise alone for about one seed in three."""
    (jlc, jm, jpri), (tlc, tm, tpri) = _curves()
    s = tfit.lightcurve_mcmc(tlc, tm, priors=tpri, p_lo=P_LO, p_up=P_UP, nwalkers=32, nsteps=400,
                             nsteps_burnin=400, seed=2, quiet=True, device="cpu")
    kw = dict(group_by="filter", refit=-np.inf, seed=0, quiet=True,
              refit_options=dict(nwalkers=32, nsteps=300, nsteps_burnin=300))
    ja = jfit.information_criteria(jlc, jm, s.flatchain, priors=jpri, **kw)
    ta = tfit.information_criteria(tlc, tm, s.flatchain, priors=tpri, device="cpu", **kw)
    for a, b in ((ja, ta), (ja["logo"], ta["logo"])):
        ra, rb = a["refit"], b["refit"]
        assert _names(rb["labels"]) == _names(ra["labels"])
        assert rb["n_failed"] == ra["n_failed"] == 0
        d = rb["acceptance"] - ra["acceptance"]
        assert abs(np.mean(d)) <= 0.02 and np.all(np.abs(d) <= 0.045), d
    for v_t, v_j in zip(ta["logo"]["pointwise"], ja["logo"]["pointwise"]):
        assert abs(v_t - v_j) <= max(2.0, 0.3 * abs(v_j))
    agree = [abs(v_t - v_j) <= max(1.0, 0.3 * abs(v_j))
             for v_t, v_j in zip(ta["pointwise"], ja["pointwise"])]
    assert np.mean(agree) > 0.9
    assert ta["elpd_loo"] == pytest.approx(float(np.sum(ta["pointwise"])))


def test_refit_entry_checks(monkeypatch):
    """(c) ``refit`` without priors raises ValueError before any scoring; on
    the CPU a ShockCooling (SW17) model passes the class check and reaches
    the scoring; on CUDA (the device check, which needs no card) the refits'
    default init="map" over SW17 raises NotImplementedError naming item 22
    (P3 over its gradient), and ShockCooling3 and CompanionShocking item 10,
    before any scoring, while init="window" over SW17 passes;
    ``refit=False`` needs neither."""
    (_, _, _), (tlc, tm, tpri) = _curves()
    flat = _cloud()

    def no_scoring(*a, **k):
        raise AssertionError("scored before the entry checks")
    monkeypatch.setattr(tfit, "_posterior_discrepancy", no_scoring)
    with pytest.raises(ValueError, match="priors"):
        tfit.information_criteria(tlc, tm, flat, refit=True, device="cpu")
    sw17 = tmodels.ShockCooling(tlc)
    kw = dict(refit=0.7, priors=tpri + [tmodels.UniformPrior(-1.0, 1.0)])
    sw17_flat = np.c_[flat, flat[:, :1]]
    with pytest.raises(AssertionError, match="scored"):
        tfit.information_criteria(tlc, sw17, sw17_flat, device="cpu", **kw)
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="item 22"):
        tfit.information_criteria(tlc, sw17, sw17_flat, device=cuda, **kw)
    with pytest.raises(AssertionError, match="scored"):
        tfit.information_criteria(tlc, sw17, sw17_flat, device=cuda,
                                  refit_options={"init": "window"}, **kw)
    for other in (tmodels.ShockCooling3(tlc), tmodels.CompanionShocking2(tlc)):
        with pytest.raises(NotImplementedError, match="item 10"):
            tfit.information_criteria(tlc, other, sw17_flat, device=cuda,
                                      refit_options={"init": "window"}, **kw)
    with pytest.raises(AssertionError, match="scored"):
        tfit.information_criteria(tlc, sw17, flat, device="cpu")


def test_compare_models_loo_forwards_the_refit(monkeypatch):
    """``compare_models_loo(refit=..., refit_options=...)`` refits each
    candidate's flagged terms under its own priors (the stub records the
    calls: one leave-one-point-out and one leave-one-band-out call a model,
    the options forwarded), and ranks the patched pointwise values."""
    (_, _, _), (tlc, tm, tpri) = _curves()
    stub = _Stub()
    monkeypatch.setattr(tpop, "fit_population", stub)
    wide = [tmodels.UniformPrior(lo - 1.0, hi + 1.0) for lo, hi in BOUNDS]
    tab = tfit.compare_models_loo(tlc, [tm, tmodels.ShockCooling2(tlc)], [tpri, wide],
                                  p_lo=P_LO, p_up=P_UP, labels=["a", "b"], nwalkers=16,
                                  nsteps=20, nsteps_burnin=20, seed=1, group_by="filter",
                                  refit=-np.inf, refit_options=dict(nsteps=7), quiet=True,
                                  device="cpu")
    assert [c[2] for c in stub.calls] == [[23] * 24, [16, 16, 16]] * 2
    assert all(c[3]["nsteps"] == 7 for c in stub.calls)
    for label in ("a", "b"):
        ic = tab.meta["ics"][label]
        assert len(ic["refit"]["labels"]) == 24 and len(ic["logo"]["refit"]["labels"]) == 3
        assert ic["elpd_loo"] == pytest.approx(float(np.sum(ic["pointwise"])))
    assert set(tab["model"]) == {"a", "b"}


@pytest.mark.parametrize("S,W,N,form", [
    (64, 64, 42, "warp"), (512, 64, 42, "warp"), (8, 64, 42, "latency"),   # 28a-c
    (5, 64, 143, "latency"), (1, 64, 148, "latency"), (12, 64, 148, "latency"),
    (16, 64, 143, "warp"), (1, 64, 256, "latency"), (1, 64, 257, "warp")])
def test_logpost_form_rule(S, W, N, form):
    """(d) P1's latency form while the launch has at most
    LOGPOST_LATENCY_WALKERS_PER_SM walkers an SM of 132 and a transient at
    most LOGPOST_LATENCY_MAX_POINTS points: 28c's 8 transients and the
    refits' 1-12 at 143-148 points take it, the example's 64 and 512
    transients and 16 long curves the warp form."""
    assert kpop.logpost_form(S, W, N, 132) == form


def test_logpost_form_crossover_and_cap():
    """(d) The rule's crossover sits at LOGPOST_LATENCY_WALKERS_PER_SM
    walkers an SM whatever the points, and its point cap is the latency
    form's own: 32 x LP_LAT_LP_ENS_WARPS of csrc/stretch.cuh, past which its
    launch refuses."""
    sm = 132
    w = kpop.LOGPOST_LATENCY_WALKERS_PER_SM * sm // 64   # transients of 64 walkers
    for n in (42, 143):
        assert kpop.logpost_form(w, 64, n, sm) == "latency"
        assert kpop.logpost_form(w + 1, 64, n, sm) == "warp"
    define = None
    for path in sum(build._sources(), []):
        with open(path) as f:
            for ln in f:
                if ln.startswith("#define LP_LAT_LP_ENS_WARPS "):
                    define = int(ln.split()[2])
    assert kpop.LOGPOST_LATENCY_MAX_POINTS == 32 * define
