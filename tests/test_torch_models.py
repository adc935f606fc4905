"""Models and numerics of the port against the JAX package, float64 on the
CPU: ops/mathx (power, hot_phase), ShockCooling2 (_eval_points, evaluate in
pointwise and outer mode, temperature_radius, t_max), the priors, and the
host log-likelihood for every use_sigma x sigma_type.

Tolerances: rel <= 1e-12 per point (same formulas, same operation order:
libm rounding of pow/exp/log only); summed log-likelihoods <= 1e-10 |ll|
(the reduction order over 149 points differs)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import priors as jpriors  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2  # noqa: E402
from lightcurve_fitting_tpu.ops import mathx as jmathx  # noqa: E402

from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import priors as tpriors  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.models.base import _quad_tensors  # noqa: E402
from lightcurve_fitting_tpu_torch.ops import mathx as tmathx  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def lcs():
    return _early(JLC), _early(TLC)


def _params(seed, W=24):
    rng = np.random.default_rng(seed)
    p = rng.uniform([20.0, 2.0, 5.0, 57466.0], [50.0, 5.0, 50.0, 57470.0], size=(W, 4))
    p[0, 3] = 57480.0   # explosion after most points: t < t_exp branch
    return p


def test_power_and_safe_reciprocal():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 0.3, 1.0, 7.5, np.inf])
    for e in (-2.0, -0.5, 0.027 * 2 - 0.5, 0.8, 3.0):
        a = np.asarray(jmathx.power(jnp.asarray(x), e))
        b = tmathx.power(torch.as_tensor(x), e).numpy()
        assert not np.any(np.isnan(b))
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tmathx.safe_reciprocal(torch.as_tensor(x)).numpy(),
                                  np.asarray(jmathx.safe_reciprocal(jnp.asarray(x))))


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_hot_phase(f32):
    t = np.array([57468.703, 57469.2, 57470.9, np.nan, 57484.99])
    t_exp = np.array([[57468.6], [57468.7], [57471.0]])
    try:
        if f32:
            jconfig.set_compute_dtype(jnp.float32)
            tconfig.set_compute_dtype(torch.float32)
        a = np.asarray(jmathx.hot_phase(jnp.asarray(t), jnp.asarray(t_exp)))
        b = tmathx.hot_phase(torch.as_tensor(t), torch.as_tensor(t_exp)).numpy()
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert a.dtype == b.dtype == (np.float32 if f32 else np.float64)
    # float32 centering: identical casts of identical float64 differences
    np.testing.assert_array_equal(b, a)
    assert float(tmathx.epoch_reference(torch.as_tensor(t))) == 57468.0


@pytest.mark.parametrize("seed", [0, 1])
def test_sc2_eval_points(lcs, seed):
    jlc, tlc = lcs
    jm, tm = JSC2(jlc), TSC2(tlc)
    f = np.asarray(tlc["filter"])
    t = np.asarray(tlc["MJD"], float)
    jq = jm.prepare_quad(np.asarray(jlc["filter"]))
    tq = _quad_tensors(tm.prepare_quad(f), "cpu")
    p = _params(seed)
    for row in p:
        a = np.asarray(jm._eval_points(jnp.asarray(t), jq, *[jnp.asarray(v) for v in row]))
        b = tm._eval_points(torch.as_tensor(t), tq,
                            *[torch.as_tensor(v) for v in row]).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    # the batched walker axis equals the per-walker evaluation
    pc = [torch.as_tensor(p[:, i:i + 1]) for i in range(4)]
    yb = tm._eval_points(torch.as_tensor(t), tq, *pc).numpy()
    for w, row in enumerate(p):
        yw = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(v) for v in row])
        np.testing.assert_allclose(yb[w], yw.numpy(), rtol=1e-14, atol=0)
    assert np.all(yb[0][t < p[0, 3]] == 0)


def test_sc2_evaluate_pointwise_and_outer(lcs):
    jlc, tlc = lcs
    jm, tm = JSC2(jlc), TSC2(tlc)
    t = np.asarray(tlc["MJD"], float)[:20]
    jf = np.asarray(jlc["filter"])[:20]
    tf = np.asarray(tlc["filter"])[:20]
    args = (37.6, 5.3, 16.2, 57468.7)
    np.testing.assert_allclose(tm.evaluate(t, tf, *args), jm.evaluate(t, jf, *args),
                               rtol=1e-12, atol=0)
    assert isinstance(tm.evaluate(t[3], tf[3:4], *args), float)
    # outer mode: bands x times, scalar then vector parameters (B, N[, W])
    tgrid = np.linspace(57469.0, 57480.0, 7)
    jb = [jf[0], jf[5], jf[9]]
    tb = [tf[0], tf[5], tf[9]]
    a, b = jm.evaluate(tgrid, jb, *args), tm.evaluate(tgrid, tb, *args)
    assert b.shape == (3, 7)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    vec = (np.array([30.0, 37.6]), 5.3, np.array([12.0, 16.2]), 57468.7)
    a, b = jm.evaluate(tgrid, jb, *vec), tm.evaluate(tgrid, tb, *vec)
    assert b.shape == (3, 7, 2)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)


def test_sc2_temperature_radius_and_t_max(lcs):
    jlc, tlc = lcs
    jm, tm = JSC2(jlc), TSC2(tlc)
    t = np.linspace(0.5, 12.0, 9)
    for args in [(37.6, 5.3, 16.2), (np.array([30.0, 37.6]), 5.3, np.array([12.0, 16.2]))]:
        for a, b in zip(jm.temperature_radius(t, *args), tm.temperature_radius(t, *args)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=0)
    p = [37.6, 5.3, 16.2, 57468.7]
    assert tm.t_max(p) == jm.t_max(p)
    with pytest.raises(NotImplementedError):
        tm.t_min(p)


PRIOR_CASES = [
    ("UniformPrior", (0.0, 100.0)),
    ("UniformPrior", (-np.inf, np.inf)),
    ("LogUniformPrior", (0.0, 50.0)),
    ("LogUniformPrior", (1.0, np.inf)),
    ("GaussianPrior", (-5.0, 20.0, 3.0, 2.5)),
    ("GaussianPrior", (-np.inf, np.inf, 57468.6, 0.05)),
]


@pytest.mark.parametrize("name,args", PRIOR_CASES)
def test_priors(name, args):
    jp, tp = getattr(jpriors, name)(*args), getattr(tpriors, name)(*args)
    x = np.array([-10.0, -5.0, 0.0, 1e-3, 1.0, 3.0, 20.0, 49.999, 50.0, 100.0, 1e3,
                  57468.6, np.nan])
    a = np.asarray(jp(jnp.asarray(x)))
    b = tp(torch.as_tensor(x)).numpy()
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=1e-12, atol=0)
    inside = x[(x > tp.p_min) & (x < tp.p_max)]
    np.testing.assert_allclose(tp.logp(torch.as_tensor(inside)).numpy(),
                               np.asarray(jp.logp(jnp.asarray(inside))), rtol=1e-12, atol=0)
    assert float(tp(5.0)) == float(jp(5.0))
    bounded = np.isfinite(tp.p_min) and np.isfinite(tp.p_max)
    if name == "GaussianPrior" or (bounded and tp.p_min > 0) or \
            (name == "UniformPrior" and bounded):
        s_t = tp.sample(np.random.default_rng(3), size=(64,))
        s_j = jp.sample(np.random.default_rng(3), size=(64,))
        np.testing.assert_array_equal(s_t, s_j)
        assert np.all((s_t > tp.p_min) & (s_t < tp.p_max))
    assert tp.kernel_spec()[0] == {"UniformPrior": 0, "LogUniformPrior": 1,
                                   "GaussianPrior": 2}[name]


@pytest.mark.parametrize("use_sigma", [False, True])
@pytest.mark.parametrize("sigma_type", ["relative", "absolute"])
def test_log_likelihood(lcs, use_sigma, sigma_type):
    jlc, tlc = lcs
    jm, tm = JSC2(jlc), TSC2(tlc)
    p = _params(5, W=12)
    if use_sigma:
        p = np.concatenate([p, np.random.default_rng(6).uniform(0.5, 3.0, (12, 1))], axis=1)
    a = jm.log_likelihood(jlc, p.T, use_sigma=use_sigma, sigma_type=sigma_type)
    b = tm.log_likelihood(tlc, p.T, use_sigma=use_sigma, sigma_type=sigma_type)
    assert b.shape == (12,)
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=0)
    a1 = jm.log_likelihood(jlc, p[1], use_sigma=use_sigma, sigma_type=sigma_type)
    b1 = tm.log_likelihood(tlc, p[1], use_sigma=use_sigma, sigma_type=sigma_type)
    assert isinstance(b1, float) and abs(b1 - a1) <= 1e-10 * abs(a1)
