"""The port's MAP + Laplace fit (``fitting.lightcurve_map``,
``parallel/optimize.py``) and ``lightcurve_mcmc(init="map")`` against the
JAX package: ports of tests/test_map.py's analytic tests, its flagship
assertions, and the JAX package's own MAP of the flagship (the free
parameters within 0.1 truth std of it, their stderr within 5%; the pinned
t_0 is compared through ``at_bound`` only, since both packages approach the
bound asymptotically)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu.fitting import lightcurve_map as j_map  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import GaussianPrior as JG, ShockCooling2 as JSC2  # noqa: E402

from lightcurve_fitting_tpu_torch import interop  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import lightcurve_map, lightcurve_mcmc  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.optimize import (laplace_covariance,  # noqa: E402
                                                            multistart_maximize)

CPU = "cpu"
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
GAUSS = [(0.0, 100.0, 30.0, 15.0), (0.0, 100.0, 4.0, 3.0), (0.0, 100.0, 30.0, 15.0),
         (57468.0, 57468.7, 57468.5, 0.2)]          # tests/test_hmc.py::_flagship_priors
TRUTH_MED = [37.58, 5.326, 16.25, 57468.6999]
TRUTH_STD = [0.145, 0.053, 0.110, 0.00018]


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


def _tpriors():
    return interop.priors_from_jax([JG(*g) for g in GAUSS])


def _quadratic(prec, mean=None):
    prec = torch.as_tensor(np.asarray(prec, float))
    mean = torch.zeros(prec.shape[0], dtype=torch.float64) if mean is None else \
        torch.as_tensor(np.asarray(mean, float))

    def logp(p):
        d = p - mean
        return -0.5 * torch.sum((d @ prec) * d, dim=-1)
    return logp


def test_multistart_recovers_gaussian_mode_and_curvature():
    mean = np.array([1.0, -2.0, 0.5])
    cov = np.array([[1.0, 0.6, 0.0], [0.6, 1.0, 0.2], [0.0, 0.2, 0.5]])
    logp = _quadratic(np.linalg.inv(cov), mean)
    u0 = np.random.default_rng(0).normal(size=(16, 3)) * 4.0
    u_fin, logp_fin = multistart_maximize(logp, u0, n_iter=600, learning_rate=0.2)
    best = u_fin[torch.argmax(logp_fin)].numpy()
    np.testing.assert_allclose(best, mean, atol=2e-3)
    lap, ok = laplace_covariance(logp, best)
    assert ok
    np.testing.assert_allclose(lap, cov, atol=1e-6)


def test_multistart_nonfinite_starts_do_not_poison_batch():
    def logp(p):
        # -inf half-plane: gradients there are NaN-free zero after masking
        return torch.where(p[:, 0] > 0, -0.5 * torch.sum((p - 3.0) ** 2, dim=-1),
                           torch.full_like(p[:, 0], -np.inf))

    u0 = np.array([[-5.0, 0.0], [4.0, 0.0], [2.0, 9.0]])
    u_fin, logp_fin = multistart_maximize(logp, u0, n_iter=400, learning_rate=0.3)
    logp_fin = logp_fin.numpy()
    assert np.isfinite(logp_fin[1]) and np.isfinite(logp_fin[2])
    np.testing.assert_allclose(u_fin[1].numpy(), [3.0, 3.0], atol=1e-2)


def test_laplace_covariance_conditional_on_pinned():
    logp = _quadratic([[2.0, 0.5], [0.5, 1.0]])
    cov, ok = laplace_covariance(logp, np.zeros(2), free=np.array([True, False]))
    assert ok
    assert cov[1, 1] == 0.0 and cov[0, 1] == 0.0
    np.testing.assert_allclose(cov[0, 0], 0.5)  # 1/prec[0,0], conditional


def test_lightcurve_map_flagship_matches_jax():
    """test_map.py:82-104's assertions on the port (seed 0), and the JAX
    package's MAP at the same seed."""
    tlc, jlc = _early(TLC), _early(JLC)
    result = lightcurve_map(tlc, TSC2(tlc), _tpriors(), seed=0, quiet=True, device=CPU)
    for d in range(4):
        assert abs(result.parameters[d] - TRUTH_MED[d]) < TRUTH_STD[d], d
    assert result.covariance_ok
    assert list(result.at_bound) == [False, False, False, True]
    for d in range(3):
        assert TRUTH_STD[d] / 1.3 < result.stderr[d] < TRUTH_STD[d] * 1.3, d
    assert result.stderr[3] == 0.0
    assert result.flatchain.shape == (1000, 4)
    assert np.ptp(result.flatchain[:, 3]) == 0.0
    assert np.isfinite(result.log_posterior)
    want = j_map(jlc, JSC2(jlc), [JG(*g) for g in GAUSS], seed=0, quiet=True)
    assert np.array_equal(result.at_bound, want.at_bound)
    free = ~want.at_bound
    dist = np.abs(result.parameters - want.parameters)[free] / np.asarray(TRUTH_STD)[free]
    assert np.all(dist < 0.1), dist
    assert np.all(np.abs(result.stderr[free] / want.stderr[free] - 1.0) < 0.05)


def test_lightcurve_mcmc_init_map_short_burnin():
    """test_map.py:59-79 on the port: walkers seeded from the Laplace draws
    reach the converged posterior with an 80-step burn-in."""
    tlc = _early(TLC)
    s = lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), p_lo=[20, 2, 20, 57468.4],
                        p_up=[50, 5, 50, 57468.69], nwalkers=48, nsteps=100, nsteps_burnin=80,
                        init="map", seed=1, quiet=True, device=CPU)
    med = np.median(s.flatchain, axis=0)
    std = s.flatchain.std(axis=0)
    for d in range(4):
        assert abs(med[d] - TRUTH_MED[d]) < 4 * TRUTH_STD[d], (d, med[d])
        assert TRUTH_STD[d] / 2 < std[d] < TRUTH_STD[d] * 2, (d, std[d])
    with pytest.raises(ValueError, match="init"):
        lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), p_lo=[20, 2, 20, 57468.4],
                        p_up=[50, 5, 50, 57468.69], init="prior", device=CPU)
