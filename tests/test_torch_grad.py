"""K7's plain version (``kernels.sc2.log_posterior_and_grad_plain``,
autograd through ``LogPosterior.forward_plain``) against ``jax.grad`` of the
JAX package's ``make_log_posterior``, and the Laplace Hessian of the port
(central differences of K7's float64 gradient) against ``jax.hessian``.

Inputs: 64 flagship walkers from the init window, rows outside the priors
and rows with t_0 after the first points (t < t_exp), with and without the
intrinsic scatter (both ``sigma_type``s), under uniform, log-uniform and
Gaussian priors. Tolerances: values as K1's (float64 1e-10 |ll|, float32
1e-5 |ll|, the same -inf set); gradients after the JAX callers' isfinite
mask (and 0 where the value is -inf) within 1e-9 (float64) and 1e-4
(float32) of the summed magnitudes of their per-point terms (K4's
``term_scales`` rule: the rounding follows the terms, which cancel near an
optimum, not their sum), and exactly 0 wherever the JAX gradient is not
finite."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.fitting import lightcurve_map as j_map  # noqa: E402
from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import GaussianPrior as JG  # noqa: E402
from lightcurve_fitting_tpu.models import LogUniformPrior as JLU  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2  # noqa: E402
from lightcurve_fitting_tpu.models import UniformPrior as JU  # noqa: E402

from lightcurve_fitting_tpu_torch import interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import make_log_posterior  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.optimize import (_hessian,  # noqa: E402
                                                            laplace_covariance)

CPU = "cpu"
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
GAUSS = [JG(0.0, 100.0, 30.0, 15.0), JG(0.0, 100.0, 4.0, 3.0), JG(0.0, 100.0, 30.0, 15.0),
         JG(57468.0, 57468.7, 57468.5, 0.2)]          # tests/test_hmc.py::_flagship_priors
# the three prior kinds, t_0 wide enough that t < t_exp walkers stay inside
MIXED = [JG(0.0, 100.0, 35.0, 8.0), JLU(0.1, 100.0), JU(0.0, 100.0), JU(57460.0, 57480.0)]
CASES = {"no_sigma": (False, "relative", MIXED),
         "sigma_relative": (True, "relative", MIXED + [JLU(0.01, 10.0)]),
         "sigma_absolute": (True, "absolute", MIXED + [JU(0.0, 10.0)])}


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def lcs():
    return _early(JLC), _early(TLC)


def _walkers(use_sigma):
    """64 walkers: 48 from the init window, 8 with t_0 after the first
    points, 8 outside the priors (one parameter each)."""
    rng = np.random.default_rng(7)
    p = rng.uniform([20.0, 2.0, 20.0, 57468.5], [50.0, 5.0, 50.0, 57468.7], size=(64, 4))
    p[48:56, 3] = rng.uniform(57468.8, 57472.0, 8)
    p[56:] = p[:8]
    p[56, 0], p[57, 1], p[58, 1], p[59, 3] = -1.0, 150.0, 0.05, 57481.0
    p[60, 2], p[61, 0] = 0.0, 100.0
    if use_sigma:
        p = np.concatenate([p, rng.uniform(0.5, 3.0, (64, 1))], axis=1)
        p[62, 4], p[63, 4] = -0.5, 20.0
    else:
        p[62, 2], p[63, 3] = 200.0, 57459.0
    return p


def _models(lcs, use_sigma):
    jm, tm = JSC2(lcs[0]), TSC2(lcs[1])
    if use_sigma:
        jm.input_names = jm.input_names + ["\\sigma"]
        tm.input_names = tm.input_names + ["\\sigma"]
    return jm, tm


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_k7_plain_matches_jax_grad(lcs, case, f32):
    use_sigma, sigma_type, jpri = CASES[case]
    p = _walkers(use_sigma)
    jm, tm = _models(lcs, use_sigma)
    try:
        if f32:
            jconfig.set_compute_dtype(jnp.float32)
            tconfig.set_compute_dtype(torch.float32)
        jfn = jax.vmap(jax.value_and_grad(j_make(jm, lcs[0], jpri, use_sigma, sigma_type)))
        jv, jg = (np.asarray(a) for a in jfn(jnp.asarray(p)))
        lp = make_log_posterior(tm, lcs[1], interop.priors_from_jax(jpri), use_sigma,
                                sigma_type, device=CPU)
        tv, tg = (a.numpy() for a in kernels.log_posterior_and_grad(lp, torch.as_tensor(p)))
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    rel = 1e-5 if f32 else 1e-10
    fin = np.isfinite(jv)
    assert np.array_equal(np.isneginf(tv), np.isneginf(jv)) and not np.isnan(tv).any()
    assert np.all(np.abs(tv[fin] - jv[fin]) <= rel * np.abs(jv[fin]))
    assert fin.sum() >= 50 and (~fin).sum() >= 6                      # both kinds present
    assert (~np.isfinite(jg[fin])).any()      # the t < t_exp rows: NaN d/dL_1 in jax.grad
    # the JAX callers' mask, and 0 where the value is -inf
    want = np.where(np.isfinite(jg) & fin[:, None], jg, 0.0)
    assert np.all(tg[~np.isfinite(jg) | ~fin[:, None]] == 0.0)
    scale = make_log_posterior(tm, lcs[1], interop.priors_from_jax(jpri), use_sigma, sigma_type,
                               device=CPU).grad_term_scales(torch.as_tensor(p)).numpy()
    tol = (1e-4 if f32 else 1e-9) * scale + 1e-300
    assert np.all(np.abs(tg - want) <= tol), np.max(np.abs(tg - want) / tol)


@pytest.fixture(scope="module")
def jax_map(lcs):
    """The JAX package's MAP of the flagship at test_map.py:90's seed."""
    return j_map(lcs[0], JSC2(lcs[0]), GAUSS, seed=0, quiet=True)


def test_finite_difference_hessian_matches_jax_hessian(lcs, jax_map):
    """The port's Laplace Hessian of a float64 LogPosterior (central
    differences of K7's gradient, optimize.FD_STEP's rule) against
    jax.hessian at the JAX package's MAP point: the free block within 1e-8
    of its largest entry (measured 9.6e-10), and the covariance of both
    within 1e-6 relative (measured 6.5e-8)."""
    x_map, free = jax_map.parameters, ~jax_map.at_bound
    lp = make_log_posterior(TSC2(lcs[1]), lcs[1], interop.priors_from_jax(GAUSS), device=CPU)
    H_t = _hessian(lp, torch.tensor(x_map), free).numpy()[np.ix_(free, free)]
    H_j = np.asarray(jax.hessian(j_make(JSC2(lcs[0]), lcs[0], GAUSS))(jnp.asarray(x_map)))
    H_j = H_j[np.ix_(free, free)]
    assert np.abs(H_t - H_j).max() <= 1e-8 * np.abs(H_j).max()
    cov, ok = laplace_covariance(lp, x_map, free)
    assert ok and np.abs(cov - jax_map.covariance).max() <= 1e-6 * np.abs(cov).max()
