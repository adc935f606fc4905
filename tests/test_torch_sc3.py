"""ShockCooling3 of the port against the JAX package, on the CPU: the model
(prepare_quad, _eval_points, evaluate in pointwise and outer mode with
kappa != 1, temperature_radius, t_min/t_max), the batched log-posterior on
the full 149-point SN 2016bkv light curve, one stretch step under shared
draws, and a synthetic fit that recovers its truth.

Inputs are made from a seed with numpy and go through both packages; the
port's log-likelihood is built through ``interop`` from the JAX package's
quad dict. Tolerances: float64 <= 1e-12 relative per point and
<= 1e-10 |ll| for summed log-likelihoods (the reduction order over 149
points differs); float32, both packages under their float32 compute dtype,
<= 1e-5 (|ll - c| + |c|), the repo's float32 log-likelihood budget, with c
the normalization constant added to the residual sum in float32 (near the
best fit of this flux model the two cancel, and the rounding scales with
the terms, not their sum); identical -inf sets.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from lightcurve_fitting_tpu import filters as jfilters  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling3 as J3  # noqa: E402
from lightcurve_fitting_tpu.models import UniformPrior as JU, LogUniformPrior as JLU  # noqa: E402
from lightcurve_fitting_tpu.parallel import sampler as jsampler  # noqa: E402

from lightcurve_fitting_tpu_torch import filters as tfilters, interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import LogPosterior, lightcurve_mcmc  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling3 as T3  # noqa: E402
from lightcurve_fitting_tpu_torch.models import UniformPrior as TU  # noqa: E402
from lightcurve_fitting_tpu_torch.models.base import _quad_tensors  # noqa: E402
from lightcurve_fitting_tpu_torch.utils.table import Table  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
D_L = 10 ** (30.79 / 5 + 1) / 1e6     # Mpc, pinned by the flagship's dm
PRIORS = [JU(0.0, 10.0), JU(0.0, 10.0), JU(0.0, 100.0), JU(0.0, 100.0),
          JU(D_L - 0.01, D_L + 0.01), JU(0.0, 1.0), JU(57468.0, 57468.7)]
P_LO = np.array([0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5])
P_UP = np.array([2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7])
FILTS = ["U", "B", "V", "g", "r", "i"]


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002)
    lc.calcAbsMag()
    lc = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    lc.calcFlux()
    return lc


@pytest.fixture(scope="module")
def lcs():
    return _early(JLC), _early(TLC)


def _batch(seed=0):
    """64 walkers from the init window, 5 outside the priors and a NaN, and
    8 with t_0 after the first points (t < t_exp there; inside a prior
    widened to t_0 < 57480)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(P_LO, P_UP, size=(64, 7))
    bad = p[:6].copy()
    bad[np.arange(6), [0, 1, 4, 5, 6, 3]] = [-0.1, 11.0, D_L + 0.02, 1.2, 57467.5, np.nan]
    late = rng.uniform(P_LO, P_UP, size=(8, 7))
    late[:, 6] = rng.uniform(57468.8, 57472.0, 8)
    return np.concatenate([p, bad, late])


def _both(lcs, p, f32, use_sigma=False, sigma_type="relative"):
    """The batched log-posterior of both packages at ``p``, the t_0 prior
    widened to (57468, 57480); the port's log-likelihood from the JAX quad
    dict."""
    jlc, tlc = lcs
    pri = PRIORS[:6] + [JU(57468.0, 57480.0)] + ([JLU(0.01, 10.0)] if use_sigma else [])
    try:
        if f32:
            jconfig.set_compute_dtype(jnp.float32)
            tconfig.set_compute_dtype(torch.float32)
        jm = J3(jlc)
        a = np.asarray(jax.vmap(j_make(jm, jlc, pri, use_sigma, sigma_type))(jnp.asarray(p)))
        quad = jm.prepare_quad(np.asarray(jlc["filter"]))
        ll = interop.log_likelihood_from_numpy(
            quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["flux"], float),
            np.asarray(tlc["dflux"], float), use_sigma, sigma_type, model=T3(tlc),
            dtype=torch.float32 if f32 else None)
        lp = LogPosterior(ll, interop.priors_from_jax(pri))
        before = dict(kernels.LAUNCHES)
        b = lp(torch.as_tensor(p)).numpy()
        assert kernels.LAUNCHES == before           # the CPU runs the plain path
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    return a, b, ll.offset if use_sigma else ll.log_norm_const


def _assert_ll_close(a, b, rel, const=0.0):
    assert b.dtype == np.float64 and not np.isnan(b).any()
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    scale = np.abs(a[fin] - const) + abs(const)
    assert np.all(np.abs(b[fin] - a[fin]) <= rel * scale), \
        np.max(np.abs(b[fin] - a[fin]) / scale)


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("use_sigma", [False, True], ids=["fixed", "use_sigma"])
def test_log_posterior_batch(lcs, f32, use_sigma):
    p = _batch()
    if use_sigma:
        p = np.concatenate([p, np.random.default_rng(1).uniform(0.5, 3.0, (len(p), 1))], axis=1)
        p[0, 7] = 20.0                               # outside the sigma prior
    a, b, c = _both(lcs, p, f32, use_sigma)
    assert np.isfinite(b[1:64]).all() and np.isneginf(b[64:70]).all()
    assert np.isfinite(b[70:]).all()                 # t < t_exp at the first points
    _assert_ll_close(a, b, 1e-5, c) if f32 else _assert_ll_close(a, b, 1e-10)


def test_log_likelihood_buffers_from_the_jax_quad(lcs):
    """The per-band tables the kernels read give the JAX per-point rows back
    exactly, and the port's own prepare_quad equals the JAX package's."""
    jlc, tlc = lcs
    jq = J3(jlc).prepare_quad(np.asarray(jlc["filter"]))
    tq = T3(tlc).prepare_quad(np.asarray(tlc["filter"]))
    for k in ("nodes", "weights", "k_ext", "band_ids"):
        assert np.array_equal(tq[k], jq[k])
    ll = interop.log_likelihood_from_numpy(jq, np.asarray(tlc["MJD"], float),
                                           np.asarray(tlc["flux"], float),
                                           np.asarray(tlc["dflux"], float), model=T3(tlc))
    assert tuple(ll.nodes.shape) == (9, 89) and ll.band_ids.dtype == torch.int64
    for k in ("nodes", "weights", "k_ext"):
        assert np.array_equal(ll.quad[k].numpy(), jq[k])
    assert list(ll.n_native.numpy()) == [12, 10, 88, 14, 4, 74, 52, 88, 42]


def test_eval_points_and_evaluate(lcs):
    jlc, tlc = lcs
    jm, tm = J3(jlc, kappa=0.7), T3(tlc, kappa=0.7)
    t = np.asarray(tlc["MJD"], float)
    f = np.asarray(tlc["filter"])
    jq = jm.prepare_quad(np.asarray(jlc["filter"]))
    tq = _quad_tensors(tm.prepare_quad(f), "cpu")
    p = _batch(2)[[0, 1, 2, 70, 71]]
    for row in p:
        a = np.asarray(jm._eval_points(jnp.asarray(t), jq, *[jnp.asarray(v) for v in row]))
        b = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(v) for v in row])
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=0)
    # the walker axis equals the per-walker evaluation; t < t_exp gives 0
    yb = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(p[:, i:i + 1])
                                                    for i in range(7)]).numpy()
    for w, row in enumerate(p):
        yw = tm._eval_points(torch.as_tensor(t), tq, *[torch.as_tensor(v) for v in row])
        np.testing.assert_allclose(yb[w], yw.numpy(), rtol=1e-14, atol=0)
    assert np.all(yb[3][t < p[3, 6]] == 0) and np.all(yb[3][t > p[3, 6] + 0.1] > 0)
    # evaluate: pointwise, outer with scalar and vector parameters, kappa
    args = tuple(p[0])
    np.testing.assert_allclose(tm.evaluate(t[:20], f[:20], *args),
                               jm.evaluate(t[:20], np.asarray(jlc["filter"])[:20], *args),
                               rtol=1e-12, atol=0)
    jb = [jfilters.filtdict[n] for n in ("g", "r", "B")]
    tb = [tfilters.filtdict[n] for n in ("g", "r", "B")]
    tgrid = np.linspace(57469.0, 57480.0, 5)
    for extra in ({}, {"kappa": 1.3}):
        a, b = jm.evaluate(tgrid, jb, *args, **extra), tm.evaluate(tgrid, tb, *args, **extra)
        assert b.shape == (3, 5)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    vec = (np.array([0.8, 1.2]), 1.0, np.array([8.0, 12.0]), 3.0, D_L, 0.05, 57468.6)
    a, b = jm.evaluate(tgrid, jb, *vec), tm.evaluate(tgrid, tb, *vec)
    assert b.shape == (3, 5, 2)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)


def test_temperature_radius_and_validity_window():
    jm, tm = J3(kappa=0.7), T3(kappa=0.7)
    t = np.linspace(-0.5, 12.0, 9)
    for args in [(1.2, 1.0, 10.0, 1.5), (np.array([0.8, 1.2]), 1.0, np.array([8.0, 12.0]), 3.0)]:
        for kw in ({}, {"t_exp": 0.3, "kappa": 1.2}):
            for a, b in zip(jm.temperature_radius(t, *args, **kw),
                            tm.temperature_radius(t, *args, **kw)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=0)
    p = [1.2, 1.0, 10.0, 1.5, D_L, 0.1, 57468.6]
    for kw in ({}, {"kappa": 1.4}):
        assert tm.t_min(p, **kw) == pytest.approx(jm.t_min(p, **kw), rel=1e-15)
        assert tm.t_max(p, **kw) == pytest.approx(jm.t_max(p, **kw), rel=1e-15)
    assert tm.t_max(p[:4]) == jm.t_max(p[:4])


def _jax_draws(key, half):
    """The draws half_update makes from ``key`` (parallel/sampler.py:87-92)."""
    kz, kj, ku = jr.split(key, 3)
    return (np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64)),
            np.asarray(jr.randint(kj, (half,), 0, half)),
            np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64)))


def test_step_matches_jax_under_shared_draws(lcs):
    jlc, tlc = lcs
    jlp = j_make(J3(jlc), jlc, PRIORS)
    quad = J3(jlc).prepare_quad(np.asarray(jlc["filter"]))
    tlp = LogPosterior(interop.log_likelihood_from_numpy(
        quad, np.asarray(tlc["MJD"], float), np.asarray(tlc["flux"], float),
        np.asarray(tlc["dflux"], float), model=T3(tlc)), interop.priors_from_jax(PRIORS))
    W, ndim = 64, 7
    half = W // 2
    pos = np.random.default_rng(3).uniform(P_LO, P_UP, size=(W, ndim)).reshape(2, half, ndim)
    jstep, jbatched = jsampler.make_stretch_kernel(jlp, half, ndim)
    jx = jnp.asarray(pos)
    jl = jbatched(jx.reshape(-1, ndim)).reshape(2, half)
    x, logp = interop.walkers_from_numpy(pos, np.asarray(jl))
    assert x.dtype == torch.float64 and tuple(x.shape) == (2, half, ndim)
    key = jr.PRNGKey(5)
    for i in range(2):
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
    # the rescaled float32 walker state of the CUDA path, as interop builds it
    off, sc = (P_LO + P_UP) / 2, (P_UP - P_LO) / 2
    xq, _ = interop.walkers_from_numpy(pos, np.zeros(W), off, sc)
    assert xq.dtype == torch.float32 and float(xq.abs().max()) <= 1.0


def test_synthetic_fit_recovers_truth():
    """The port of tests/test_models.py::test_shockcooling3_fit_recovers_truth:
    a 48-point SC3 light curve with sampled E(B-V), fit at 32 walkers."""
    truth = (1.2, 1.0, 10.0, 1.5, 40.0, 0.15, 0.3)  # v_s, M_env, f_rho_M, R, d_L, ebv, t_0
    t = np.repeat(np.linspace(1.0, 7.0, 8), 6)
    f = np.array([tfilters.filtdict[n] for n in FILTS] * 8)
    y_true = T3(redshift=0.01)(t, f, *truth)
    np.testing.assert_allclose(
        y_true, J3(redshift=0.01)(t, np.array([jfilters.filtdict[n] for n in FILTS] * 8), *truth),
        rtol=1e-12, atol=0)
    rng = np.random.default_rng(5)
    dy = 0.03 * y_true
    y = y_true + rng.normal(scale=dy)
    lc = Table([t, f, y, dy], names=["MJD", "filter", "flux", "dflux"])
    lc.meta["redshift"] = 0.01
    model = T3(lc)
    priors = [TU(0.1, 5.0), TU(0.1, 10.0), TU(1.0, 100.0), TU(0.1, 10.0), TU(39.99, 40.01),
              TU(0.0, 1.0), TU(-1.0, 1.0)]
    sampler = lightcurve_mcmc(lc, model, priors=priors,
                              p_lo=[0.5, 0.5, 5.0, 0.5, 39.99, 0.05, 0.0],
                              p_up=[2.5, 2.0, 20.0, 3.0, 40.01, 0.4, 0.6],
                              nwalkers=32, nsteps=200, nsteps_burnin=300, seed=21,
                              device="cpu", quiet=True)
    med = np.median(sampler.flatchain, axis=0)
    assert med[5] == pytest.approx(0.15, abs=0.1)       # E(B-V)
    assert med[6] == pytest.approx(0.3, abs=0.3)        # t_0
    y_fit = model(t, f, *med)
    assert np.mean(((y - y_fit) / dy) ** 2) < 3.0


def test_interop_priors_for_seven_and_eight_parameters():
    pri = interop.priors_from_jax(PRIORS + [JLU(0.01, 10.0)])
    assert [type(p).__name__ for p in pri] == ["UniformPrior"] * 7 + ["LogUniformPrior"]
    assert [(p.p_min, p.p_max) for p in pri] == [(p.p_min, p.p_max) for p in PRIORS] \
        + [(0.01, 10.0)]
    pos = np.random.default_rng(4).uniform(P_LO, P_UP, size=(8, 7))
    x, lp = interop.walkers_from_numpy(np.concatenate([pos, np.ones((8, 1))], 1), np.zeros(8))
    assert tuple(x.shape) == (2, 4, 8) and tuple(lp.shape) == (2, 4)


def jax_sc3_acceptance(seeds=range(1, 9), nwalkers=4096, nsteps=300):
    """The JAX package's mean acceptance, float64 on the CPU, of the
    ShockCooling3 fit of SN 2016bkv that ``chip_smoke.py`` phase 9c runs on
    the card: the flagship curve with its Milky Way extinction, the SC3
    priors and init window, ``nwalkers`` x ``nsteps`` steps, no burn-in, one
    run a seed (``shard=False``). Returns {seed: acceptance}. About a minute
    a seed on 8 CPU cores."""
    import contextlib
    import io
    from lightcurve_fitting_tpu.fitting import lightcurve_mcmc as j_mcmc
    lc = JLC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002, extinction={
        "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
        "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
    lc.calcAbsMag()
    lc.calcLum()
    early = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    out = {}
    for seed in seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            s = j_mcmc(early, J3(early), PRIORS, p_lo=P_LO, p_up=P_UP, nwalkers=nwalkers,
                       nsteps=nsteps, nsteps_burnin=0, seed=seed, shard=False, quiet=True)
        out[seed] = float(np.mean(s.acceptance_fraction))
    return out


if __name__ == "__main__":
    acc = jax_sc3_acceptance()
    for seed, a in acc.items():
        print(f"seed {seed}: acceptance {a!r}")
    vals = np.array(list(acc.values()))
    print(f"mean {vals.mean()!r} +/- {vals.std(ddof=1) / np.sqrt(len(vals))!r}")
