"""The port's gradient samplers (``parallel/nuts.py``, ``parallel/hmc.py``)
and ``fitting.lightcurve_hmc`` against the JAX package.

Exactness: one NUTS and one HMC transition of the plain port, fed the draws
split from the JAX transition's own keys, equal the JAX transition: the same
depths, divergence flags and picks, states within 1e-12 and log-posteriors
within 1e-12 of their magnitude (float64 on the CPU; the sums over the 149
points run in another order, so log p differs in its last bits, and a
trajectory of up to 2^(max_depth-1) leapfrogs carries that along). Then the
JAX tests' statistical assertions on the port's samplers and on the
screening-size ``lightcurve_hmc``, and the refused options."""

import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make_lp  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import GaussianPrior as JG, ShockCooling2 as JSC2  # noqa: E402
from lightcurve_fitting_tpu.parallel import hmc as jhmc, nuts as jnuts  # noqa: E402

from lightcurve_fitting_tpu_torch import interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import lightcurve_hmc, make_log_posterior  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import KDEPrior, ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import hmc as thmc, nuts as tnuts  # noqa: E402

CPU = "cpu"
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
GAUSS = [(0.0, 100.0, 30.0, 15.0), (0.0, 100.0, 4.0, 3.0), (0.0, 100.0, 30.0, 15.0),
         (57468.0, 57468.7, 57468.5, 0.2)]          # tests/test_hmc.py::_flagship_priors
TRUTH_MED = np.array([37.58, 5.326, 16.25, 57468.6999])
TRUTH_STD = np.array([0.145, 0.053, 0.110, 0.00018])
SIGMA_PRIOR = (0.0, 10.0, 1.0, 1.0)                  # the intrinsic scatter's, in dy units


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


def _gaussian(seed=0):
    """test_nuts.py:11-20's correlated 3-D Gaussian in both packages."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + 0.5 * np.eye(3)
    prec, mean = np.linalg.inv(cov), np.array([1.0, -2.0, 0.5])

    def jlogp(p):
        d = p - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(prec) @ d

    def tlogp(p):
        d = p - torch.as_tensor(mean)
        return -0.5 * torch.sum((d @ torch.as_tensor(prec)) * d, dim=-1)
    return rng, cov, mean, jlogp, tlogp


def _flagship_whitened(use_sigma=False):
    """The whitened flagship posterior of lightcurve_hmc in both packages,
    float64: the JAX package's BoundsTransform and WhitenedPosterior of
    Gaussian draws around the converged posterior (t_0 just inside its upper
    bound), carried across by interop; and eight chain states from them.
    With ``use_sigma`` the intrinsic scatter (relative) is a fifth parameter,
    its Gaussian prior on (0, 10) and its draws around 1: ndim 5, the width
    of the kernels' N = 5 instantiations."""
    jlc, tlc = _early(JLC), _early(TLC)
    jpri = [JG(*g) for g in GAUSS + ([SIGMA_PRIOR] if use_sigma else [])]
    jlp = j_make_lp(JSC2(jlc), jlc, jpri, use_sigma=use_sigma)
    tlp = make_log_posterior(TSC2(tlc), tlc, interop.priors_from_jax(jpri), use_sigma=use_sigma,
                             device=CPU)
    jb = jhmc.BoundsTransform([p.p_min for p in jpri], [p.p_max for p in jpri])
    rng = np.random.default_rng(11)
    med, std = TRUTH_MED, TRUTH_STD
    if use_sigma:
        med, std = np.append(med, 1.0), np.append(std, 0.1)
    x = med + rng.normal(size=(400, len(jpri))) * std
    x[:, 3] = 57468.7 - 1e-6 - np.abs(rng.normal(size=400)) * TRUTH_STD[3]
    warm_u = jb.to_unbounded(x)
    jw = jhmc.WhitenedPosterior(warm_u)

    def jlogp_w(w):
        u = jw.to_u(w)
        return jlp(jb.to_bounded(u)) + jb.log_jacobian(u)
    target = thmc.WhitenedLogPosterior(tlp, interop.bounds_from_jax(jb),
                                       interop.whitening_from_jax(jw))
    return jlogp_w, target, jw.to_w(warm_u[:8])


def _nuts_draws(keys, ndim, max_depth):
    """(z, u) of make_nuts_transition from the JAX transition's keys
    (nuts.py:106-107, :171-181): the momentum normals, then per doubling the
    direction (jr.bernoulli's decision, as u < 0.5), the Gumbel uniforms
    and the accept uniform."""
    max_len = 2 ** (max_depth - 1)
    Z, U = [], []
    for key in keys:
        k_mom, key = jr.split(key)
        Z.append(np.asarray(jr.normal(k_mom, (ndim,))))
        u = np.empty((max_depth, max_len + 2))
        for d in range(max_depth):
            key, k_dir, k_sel, k_acc = jr.split(key, 4)
            u[d, 0] = 0.25 if bool(jr.bernoulli(k_dir)) else 0.75
            u[d, 1:max_len + 1] = np.asarray(jr.uniform(k_sel, (max_len,)))
            u[d, -1] = float(jr.uniform(k_acc))
        U.append(u)
    return torch.as_tensor(np.array(Z)), torch.as_tensor(np.array(U))


def _hmc_draws(keys, ndim, n_leapfrog):
    """(z, u_acc, n_used) of the HMC transition from its keys (hmc.py:243-247)."""
    Z, UA, NU = [], [], []
    for key in keys:
        k_mom, k_acc, k_jit = jr.split(key, 3)
        Z.append(np.asarray(jr.normal(k_mom, (ndim,))))
        UA.append(float(jr.uniform(k_acc)))
        NU.append(int(jr.randint(k_jit, (), (n_leapfrog + 1) // 2, n_leapfrog + 1)))
    return torch.as_tensor(np.array(Z)), torch.as_tensor(UA), torch.as_tensor(NU)


def _assert_same(jax_out, port_out, what):
    q_j, l_j = np.asarray(jax_out[0]), np.asarray(jax_out[1])
    q_t, l_t = port_out[0].numpy(), port_out[1].numpy()
    assert np.abs(q_t - q_j).max() <= 1e-12, what
    assert np.all(np.abs(l_t - l_j) <= 1e-12 * np.abs(l_j)), what


def _assert_stat_same(a_j, a_t, l_j):
    """The accept statistic is exp of energy differences, whose rounding is
    that of log p: within 1e-12 of the largest |log p|."""
    tol = 1e-12 * max(1.0, float(np.abs(np.asarray(l_j)).max()))
    assert np.abs(a_t.numpy() - np.asarray(a_j)).max() <= tol


@pytest.mark.parametrize("case", ["gaussian", "flagship", "flagship_sigma"])
def test_nuts_transition_equals_jax_under_the_same_draws(case):
    if case == "gaussian":
        rng, _, mean, jlogp, tlogp = _gaussian()
        q0 = mean + 2.0 * rng.normal(size=(16, 3))
        target, eps, inv_mass = thmc._AutogradTarget(tlogp), 0.35, np.array([1.0, 2.0, 0.5])
    else:
        jlogp, target, q0 = _flagship_whitened(use_sigma=case == "flagship_sigma")
        eps, inv_mass = 0.1, np.ones(q0.shape[1])
    C, ndim, max_depth = q0.shape[0], q0.shape[1], 6
    keys = [jr.fold_in(jr.PRNGKey(3), i) for i in range(C)]
    jstep = jnuts.make_nuts_transition(jlogp, ndim, max_depth)
    q_j, l_j, (a_j, d_j, div_j) = jax.jit(jax.vmap(
        lambda q, k: jstep(q, jlogp(q), k, eps, jnp.asarray(inv_mass))))(
            jnp.asarray(q0), jnp.stack(keys))
    z, u = _nuts_draws(keys, ndim, max_depth)
    q0t = torch.as_tensor(q0)
    logp0 = target.logp_and_grad(q0t)[0]
    out = kernels.nuts_transition(target, q0t, logp0, z, u, torch.tensor(eps, dtype=torch.float64),
                                  torch.as_tensor(inv_mass), max_depth)
    assert np.array_equal(out[3].numpy(), np.asarray(d_j))
    assert np.array_equal(out[4].numpy(), np.asarray(div_j))
    _assert_same((q_j, l_j), out, case)
    _assert_stat_same(a_j, out[2], l_j)
    assert 1 < np.asarray(d_j).mean() < max_depth          # trees of several depths


@pytest.mark.parametrize("case", ["gaussian", "flagship", "flagship_sigma"])
def test_hmc_transition_equals_jax_under_the_same_draws(case):
    n_leapfrog = 12
    if case == "gaussian":
        rng, _, mean, jlogp, tlogp = _gaussian()
        q0 = mean + 2.0 * rng.normal(size=(16, 3))
        target, eps, inv_mass = thmc._AutogradTarget(tlogp), 0.3, np.array([1.0, 2.0, 0.5])
    else:
        jlogp, target, q0 = _flagship_whitened(use_sigma=case == "flagship_sigma")
        # the scatter's target accepts every chain at 0.15: a longer step
        # rejects some, so the accept test is exercised
        eps, inv_mass = (0.15 if case == "flagship" else 0.45), np.ones(q0.shape[1])
    C, ndim = q0.shape
    keys = [jr.fold_in(jr.PRNGKey(4), i) for i in range(C)]
    js = jhmc.HMCSampler(C, ndim, jlogp, n_leapfrog=n_leapfrog)
    q_j, l_j, a_j = jax.jit(jax.vmap(
        lambda q, k: js._transition(q, jlogp(q), k, eps, jnp.asarray(inv_mass))))(
            jnp.asarray(q0), jnp.stack(keys))
    draws = _hmc_draws(keys, ndim, n_leapfrog)
    q0t = torch.as_tensor(q0)
    logp0 = target.logp_and_grad(q0t)[0]
    out = kernels.hmc_transition(target, q0t, logp0, *draws,
                                 torch.tensor(eps, dtype=torch.float64),
                                 torch.as_tensor(inv_mass), n_leapfrog)
    _assert_same((q_j, l_j), out, case)
    _assert_stat_same(a_j, out[2], l_j)
    assert 0 < np.mean(np.asarray(a_j)) < 1                 # not all accepted


def test_nuts_sampler_correlated_gaussian():
    """test_nuts.py:11-33 on the port's NUTSSampler (plain path)."""
    rng, cov, mean, _, tlogp = _gaussian()
    s = tnuts.NUTSSampler(8, 3, tlogp, seed=0, device=CPU)
    x0 = mean + rng.normal(size=(8, 3))
    s.run_mcmc(x0, n_samples=1200, n_warmup=500)
    flat = s.flatchain
    assert flat.shape == (1200 * 8, 3)
    assert 0.7 < s.acceptance_fraction.mean() < 0.95
    assert 1.0 < s.mean_tree_depth < 8.0
    assert s.divergence_rate < 0.01
    assert np.all(np.abs(flat.mean(0) - mean) < 0.12)
    emp = np.cov(flat.T)
    assert np.abs(emp - cov).max() / np.abs(cov).max() < 0.15


@pytest.mark.parametrize("which", ["nuts", "hmc"])
def test_continuation_reuses_adaptation(which):
    """test_nuts.py:60-104: n_warmup=0 continues with the stored (step_size,
    inv_mass); a fresh sampler rejects it, as does n_warmup=1. A segmented
    run equals a single run, the draws of transition i depending on (seed,
    i) alone; and interop carries a JAX sampler's adaptation across."""
    def logp(p):
        return -0.5 * torch.sum(p ** 2, dim=-1)

    cls = tnuts.NUTSSampler if which == "nuts" else thmc.HMCSampler
    nchains = 4 if which == "nuts" else 8
    x0 = np.random.default_rng(0 if which == "nuts" else 1).normal(size=(nchains, 2))
    fresh = cls(nchains, 2, logp, seed=0, device=CPU)
    with pytest.raises(ValueError):
        fresh.run_mcmc(x0, 10, n_warmup=0)
    with pytest.raises(ValueError):
        fresh.run_mcmc(x0, 10, n_warmup=1)
    s = cls(nchains, 2, logp, seed=0, device=CPU)
    last = s.run_mcmc(x0, 60, n_warmup=60)
    eps, inv_mass = s.step_size, s.inv_mass.copy()
    s.run_mcmc(last, 150, n_warmup=0)
    assert s.step_size == eps and np.array_equal(s.inv_mass, inv_mass)
    tail = s._chain[-150:]
    assert tail.reshape(-1, 2).std(axis=0) == pytest.approx([1.0, 1.0], rel=0.35)
    whole = cls(nchains, 2, logp, seed=0, device=CPU)
    whole.run_mcmc(x0, 210, n_warmup=60)
    assert np.array_equal(whole._chain, s._chain)

    class Adapted:
        step_size, inv_mass = 0.7, np.array([1.5, 0.5])
    t = interop.adaptation_from_jax(Adapted, cls(nchains, 2, logp, seed=1, device=CPU))
    t.run_mcmc(x0, 5, n_warmup=0)
    assert t.step_size == 0.7 and np.array_equal(t.inv_mass, [1.5, 0.5])


def test_lightcurve_hmc_screening():
    """test_hmc.py:105-125: the one-call NUTS fit of SN 2016bkv at screening
    size lands on the posterior ridge (plain path)."""
    tlc = _early(TLC)
    pri = interop.priors_from_jax([JG(*g) for g in GAUSS])
    result = lightcurve_hmc(tlc, TSC2(tlc), pri, nchains=4, nsamples=30, n_warmup=80,
                            max_depth=7, warmup_walkers=32, warmup_steps=100, seed=3,
                            quiet=True, device=CPU)
    assert result.flatchain.shape == (30 * 4, 4)
    assert np.isfinite(result.flatchain).all()
    assert result.acceptance_fraction.mean() > 0.4
    med = np.median(result.flatchain, axis=0)
    assert 35.0 < med[0] < 40.5, med
    assert 5.0 < med[1] < 5.7, med
    assert 57468.69 < med[3] < 57468.705, med
    assert result.sampler.mean_tree_depth > 1.0 and result.sampler.divergence_rate < 0.1


def test_refusals():
    tlc = _early(TLC)
    pri = interop.priors_from_jax([JG(*g) for g in GAUSS])
    kw = dict(nchains=2, nsamples=2, n_warmup=2, warmup_walkers=16, warmup_steps=2, quiet=True,
              device=CPU)
    with pytest.raises(NotImplementedError, match="item 17"):
        lightcurve_hmc(tlc, TSC2(tlc), pri, mesh=object(), **kw)
    for opt in ({"checkpoint_every": 2, "checkpoint_file": "ck.npz"}, {"resume_from": "ck.npz"}):
        with pytest.raises(NotImplementedError, match="item 16"):
            lightcurve_hmc(tlc, TSC2(tlc), pri, **opt, **kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        KDEPrior(np.zeros(10))
    kde = KDEPrior.__new__(KDEPrior)
    with pytest.raises(NotImplementedError, match="item 12"):
        lightcurve_hmc(tlc, TSC2(tlc), pri[:3] + [kde], **kw)
    with pytest.raises(NotImplementedError, match="item 17"):
        tnuts.NUTSSampler(4, 2, lambda p: -p.sum(-1), mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="sampler"):
        lightcurve_hmc(tlc, TSC2(tlc), pri, sampler="mala", **kw)
    # plain callables have no kernel: they run on the CPU only
    with pytest.raises(NotImplementedError, match="run on the CPU"):
        thmc.gradient_target(lambda p: -p.sum(-1), torch.device("cuda"))
