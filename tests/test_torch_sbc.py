"""The port's simulation-based calibration (``parallel/sbc.py``) against the
JAX package's, on the CPU.

Inputs are made from a seed with numpy and go through both packages.
Tolerances, each with its reason:
- ``rank_statistic``, ``_auto_bins`` and ``uniformity_pvalues``: bit for bit
  (the same host numpy and scipy calls);
- the simulations: the truths and the fits' and thinning's seeds equal (the
  same numpy stream), each simulated ``y`` and ``dy`` within 1e-12 relative
  (the models' float64 evaluations sum and power in other orders), with and
  without the intrinsic scatter; captured by replacing both packages'
  ``fit_population``;
- the end-to-end run at tests/test_sbc.py's size: that test's statistical
  criteria, on the port's plain versions (``device="cpu"``);
- ``plot_sbc``: the bar heights and the axis labels of the JAX figure.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import matplotlib  # noqa: E402

matplotlib.use("Agg")

from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2, UniformPrior as JU  # noqa: E402
from lightcurve_fitting_tpu.parallel import population as jpop  # noqa: E402
from lightcurve_fitting_tpu.parallel import sbc as jsbc  # noqa: E402

from lightcurve_fitting_tpu_torch.models import (ShockCooling2 as TSC2,  # noqa: E402
                                                 UniformPrior as TU)
from lightcurve_fitting_tpu_torch.parallel import population as tpop  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import sbc as tsbc  # noqa: E402

BOUNDS = [(8.0, 20.0), (1.0, 4.0), (25.0, 50.0)]          # tests/test_sbc.py's priors
# examples/calibration_check.py's, t_exp the fourth
EXAMPLE_BOUNDS = BOUNDS + [(-1.0, 1.0)]


def _priors(bounds):
    return [JU(*b) for b in bounds], [TU(*b) for b in bounds]


def _posterior(seed):
    """tests/test_sbc.py's exact synthetic posterior: truths, calibrated
    draws, and the observation they are conditioned on."""
    rng = np.random.default_rng(seed)
    S, M, D = 96, 300, 2
    truths = rng.normal(size=(S, D))
    obs = truths + rng.normal(size=(S, D))
    post = obs[:, None, :] / 2 + np.sqrt(0.5) * rng.normal(size=(S, M, D))
    return post, truths


@pytest.mark.parametrize("shift", [0.0, 0.7])
def test_rank_statistic_and_pvalues_bit_for_bit(shift):
    post, truths = _posterior(1)
    for L in (31, 63):
        r_t = tsbc.rank_statistic(post + shift, truths, n_ranks=L, seed=4)
        r_j = jsbc.rank_statistic(post + shift, truths, n_ranks=L, seed=4)
        np.testing.assert_array_equal(r_t, r_j)
        assert r_t.dtype == r_j.dtype and r_t.min() >= 0 and r_t.max() <= L
        for n_bins in (None, 8, 4):
            np.testing.assert_array_equal(tsbc.uniformity_pvalues(r_t, L, n_bins),
                                          jsbc.uniformity_pvalues(r_j, L, n_bins))
    if shift:
        assert np.all(tsbc.uniformity_pvalues(r_t, 63) < 1e-4)
    for n in (3, 9, 10, 39, 40, 79, 80, 500):
        for n_bins in (None, 5):
            assert tsbc._auto_bins(n, n_bins) == jsbc._auto_bins(n, n_bins)


def test_early_errors_as_jax_raises_them(monkeypatch):
    """The rank helpers' and the harness's errors, raised before any fit."""
    def no_fit(*a, **k):
        raise AssertionError("fitted before the checks")
    monkeypatch.setattr(tpop, "fit_population", no_fit)
    monkeypatch.setattr(jpop, "fit_population", no_fit)
    post, truths = _posterior(0)
    ranks = np.random.default_rng(0).integers(0, 64, size=(100, 1))
    for mod in (tsbc, jsbc):
        with pytest.raises(ValueError, match="exceeds the 300"):
            mod.rank_statistic(post, truths, n_ranks=511)
        with pytest.raises(ValueError, match="divisible"):
            mod.uniformity_pvalues(ranks, 63, n_bins=5)
    jpri, tpri = _priors(BOUNDS)
    kw = dict(times=np.linspace(1.0, 8.0, 4), filters=["g", "r"], seed=0, quiet=True)
    for mod, model, pri in ((tsbc, TSC2(), tpri), (jsbc, JSC2(), jpri)):
        # nsteps * nwalkers = 96 caps n_ranks at 96; 97 is prime: no valid bins
        with pytest.raises(ValueError, match="n_ranks"):
            mod.simulation_based_calibration(model, pri, n_sims=20, n_ranks=127, nwalkers=32,
                                             nsteps=3, nsteps_burnin=2, **kw)
        for extra in ({"summaries": True}, {"return_chains": False}):
            with pytest.raises(TypeError, match="full chains"):
                mod.simulation_based_calibration(model, pri, n_sims=4, n_ranks=63, nwalkers=16,
                                                 nsteps=4, nsteps_burnin=2, **kw, **extra)


def test_sbc_refuses_the_cpu_without_being_asked(monkeypatch):
    """device=None means CUDA: without it the harness raises, naming
    device="cpu", before it simulates anything."""
    def no_simulation(*a, **k):
        raise AssertionError("simulated before the device check")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tsbc, "_host_f64", no_simulation)
    _, tpri = _priors(BOUNDS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsbc.simulation_based_calibration(TSC2(), tpri, times=np.linspace(1.0, 8.0, 4),
                                          filters=["g", "r"], n_sims=8, n_ranks=31,
                                          nwalkers=8, nsteps=8, nsteps_burnin=2, quiet=True)


class _Capture:
    """A ``fit_population`` that records its arguments and returns chains
    drawn about the truths (each simulation's own columns), so that the
    ranks come out of the harness."""

    def __init__(self):
        self.call = None

    def __call__(self, models, lcs, priors, **kw):
        self.call = {"models": models, "lcs": lcs, "priors": priors, "kw": kw}
        S, D = len(lcs), len(priors)
        M = kw["nsteps"] * kw["nwalkers"]
        rng = np.random.default_rng(kw["seed"])
        return rng.normal(size=(S, M, D)), np.full(S, 0.5)


@pytest.mark.parametrize("sigma", [None, "relative", "absolute"])
def test_simulations_and_streams_match_jax(sigma, monkeypatch):
    """The truths, the simulated curves and the derived seeds are the JAX
    function's, and so are the ranks over the same chains (tests/test_sbc.py's
    use_sigma case: the scatter's draw inflates the noise)."""
    bounds = EXAMPLE_BOUNDS + ([(0.5, 2.0)] if sigma else [])
    jpri, tpri = _priors(bounds)
    caps = {"jax": _Capture(), "port": _Capture()}
    monkeypatch.setattr(jpop, "fit_population", caps["jax"])
    monkeypatch.setattr(tpop, "fit_population", caps["port"])
    kw = dict(times=np.linspace(1.0, 8.0, 5), filters=["g", "r", "i", "B"], n_sims=12,
              n_ranks=31, nwalkers=8, nsteps=10, nsteps_burnin=5, seed=3, quiet=True,
              use_sigma=sigma is not None, sigma_type=sigma or "relative")
    r_j = jsbc.simulation_based_calibration(JSC2(), jpri, **kw)
    r_t = tsbc.simulation_based_calibration(TSC2(), tpri, device="cpu", **kw)
    np.testing.assert_array_equal(r_t["truths"], r_j["truths"])
    cj, ct = caps["jax"].call, caps["port"].call
    assert ct["kw"]["seed"] == cj["kw"]["seed"] and ct["kw"]["device"] == torch.device("cpu")
    for k in ("p_lo", "p_up"):
        np.testing.assert_array_equal(ct["kw"][k], cj["kw"][k])
    for k in ("nwalkers", "nsteps", "nsteps_burnin", "use_sigma", "sigma_type", "init"):
        assert ct["kw"][k] == cj["kw"][k], k
    assert [type(m).__name__ for m in ct["models"]] == ["ShockCooling2"] * 12
    for lt, lj in zip(ct["lcs"], cj["lcs"]):
        np.testing.assert_array_equal(np.asarray(lt["MJD"]), np.asarray(lj["MJD"]))
        assert [f.name for f in lt["filter"]] == [f.name for f in lj["filter"]]
        for col in ("lum", "dlum"):
            np.testing.assert_allclose(np.asarray(lt[col], float), np.asarray(lj[col], float),
                                       rtol=1e-12, atol=0.0)
    # the rank seed: the same chains give the same ranks
    np.testing.assert_array_equal(r_t["ranks"], r_j["ranks"])
    np.testing.assert_array_equal(r_t["p_values"], r_j["p_values"])
    assert r_t["n_ranks"] == r_j["n_ranks"] == 31
    if sigma:
        assert r_t["ranks"].shape == (12, 5)
        assert np.all((r_t["truths"][:, -1] > 0.5) & (r_t["truths"][:, -1] < 2.0))


def test_sbc_end_to_end_shockcooling2():
    """tests/test_sbc.py's end-to-end harness (ShockCooling2, 64 simulations
    of 5 epochs x 4 bands, 32 walkers x 400 + 600 steps, MAP-seeded, seed 1)
    on the port's plain versions: ranks in range, every acceptance above
    0.2, calibrated p-values."""
    _, tpri = _priors(BOUNDS)
    res = tsbc.simulation_based_calibration(
        TSC2(), tpri, times=np.linspace(1.0, 8.0, 5), filters=["g", "r", "i", "B"], n_sims=64,
        n_ranks=63, nwalkers=32, nsteps=600, nsteps_burnin=400, seed=1, quiet=True,
        device="cpu")
    assert res["ranks"].shape == (64, 3)
    assert res["ranks"].min() >= 0 and res["ranks"].max() <= 63
    assert np.all(res["acceptance"] > 0.2)
    assert np.all(res["p_values"] > 1e-3)


@pytest.mark.parametrize("with_sigma", [False, True])
def test_plot_sbc_bars_match_jax(with_sigma, tmp_path):
    """The bar heights and the x labels of the JAX figure, the model's axis
    labels padded with sigma for a use_sigma run's extra parameter."""
    rng = np.random.default_rng(3)
    D = 5 if with_sigma else 4
    res = {"ranks": rng.integers(0, 64, size=(40, D)), "n_ranks": 63}
    figs = [mod.plot_sbc(res, model, save_plot_as=str(tmp_path / f"{name}.png"))
            for mod, model, name in ((tsbc, TSC2(), "t"), (jsbc, JSC2(), "j"))]
    for ax_t, ax_j in zip(*(f.axes for f in figs)):
        assert [p.get_height() for p in ax_t.patches] == [p.get_height() for p in ax_j.patches]
        assert ax_t.get_xlabel() == ax_j.get_xlabel()
    labels = [ax.get_xlabel() for ax in figs[0].axes]
    assert len(labels) == D and ("sigma" in labels[-1]) == with_sigma
    assert (tmp_path / "t.png").exists()


def jax_example_sbc():
    """The JAX package's run of examples/calibration_check.py's SBC at its full
    size (ShockCooling2, priors U(8, 20), U(1, 4), U(25, 50), U(-1, 1); 128
    simulations of linspace(1, 8, 5) x g, r, i, B; n_ranks 63; 32 walkers x
    400 + 600 steps, init="map", seed 3), float64 on the CPU: the mean
    acceptance over the simulations, the least, and the p-values.
    ``chip_smoke.py`` 30 holds the port's run to it."""
    jpri, _ = _priors(EXAMPLE_BOUNDS)
    res = jsbc.simulation_based_calibration(
        JSC2(), jpri, times=np.linspace(1.0, 8.0, 5), filters=["g", "r", "i", "B"], n_sims=128,
        n_ranks=63, nwalkers=32, nsteps=600, nsteps_burnin=400, seed=3, quiet=True)
    acc = np.asarray(res["acceptance"])
    return float(np.mean(acc)), float(np.min(acc)), [float(p) for p in res["p_values"]]


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_sbc.py: the JAX package's float64
    # CPU reference of chip_smoke.py's phase 30 (SBC_REF)
    import time

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    print(f"(mean acceptance, least acceptance, p-values) = {jax_example_sbc()} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
