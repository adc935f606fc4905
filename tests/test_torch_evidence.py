"""parallel/evidence.py and the tempered-ladder drivers of the port
(``lightcurve_evidence``, ``lightcurve_ptmcmc``, ``compare_models``) against
the JAX package, on the CPU (the K6 kernels' plain versions).

Exact checks, float64:

* ``make_beta_ladder``: bit-equal;
* five ladder steps on ShockCooling2 (15 synthetic points, 4 rungs + beta = 1,
  16 walkers), fed the very draws the JAX step makes from its keys
  (``make_xs``, then ``step_one``'s and ``half_update``'s ``jr.split``):
  accept and swap flags identical over both parities, states, log pi and
  log L <= 1e-12 relative;
* the ladder's initial state with ``copies`` (one set of states for every
  rung) against the JAX package's ``init_carry`` on ShockCooling2 (here),
  ShockCooling3 and CompanionShocking2 (``test_torch_sc3.py``,
  ``test_torch_companion.py``), states outside the priors, with t < t_exp
  and NaN among them: log pi <= 1e-12 relative, log L to float64 rounding;
* ``_rung_block_terms`` on one random log L array: <= 1e-12 relative (the
  means are summed in another order);
* ``_prior_log_norm``: <= 1e-12 relative (``logp`` on the same grid, the
  trapezoid of numpy).

Statistical checks, with the JAX tests' seeds and bounds: the analytic
Gaussian, the NaN-start walker, the Occam log Bayes factor on ShockCooling2
against the JAX package's (|dZ_port - dZ_jax| < 4 hypot(errors) + 0.5), the
float32 rescaled ladder, the parallel-tempering recovery of a bimodal target
and the ranking of ``compare_models``. The random streams of the two
packages differ, so whole runs agree only in distribution.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from lightcurve_fitting_tpu import fitting as jfit  # noqa: E402
from lightcurve_fitting_tpu.filters import filtdict as jfd  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import (GaussianPrior as JG, LogUniformPrior as JLU,  # noqa: E402
                                           ShockCooling2 as JSC2, UniformPrior as JU)
from lightcurve_fitting_tpu.parallel import evidence as jev  # noqa: E402

from lightcurve_fitting_tpu_torch import fitting as tfit, interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict as tfd  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import ladder  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import (KDEPrior, Prior, ShockCooling2 as TSC2,  # noqa: E402
                                                 UniformPrior as TU)
from lightcurve_fitting_tpu_torch.parallel import evidence as tev  # noqa: E402

SNUG = [JU(8.0, 16.0), JU(1.0, 3.0), JU(25.0, 45.0), JU(-0.5, 0.5)]
WIDE = [JU(1.0, 81.0), JU(0.1, 20.1), JU(5.0, 205.0), JU(-5.0, 5.0)]


def _synthetic(rng_seed, t0=0.0):
    """ShockCooling2 photometry in g, r, i at 5 epochs (the JAX tests'
    recipe), as a JAX and a port light curve with the same numbers."""
    rng = np.random.default_rng(rng_seed)
    names = ["g", "r", "i"]
    t = np.repeat(t0 + np.linspace(1.0, 8.0, 5), 3)
    f = np.array([jfd[n] for n in names] * 5)
    y = np.asarray(JSC2()(t, f, 12.0, 2.0, 35.0, t0))
    dy = 0.05 * y
    y = y + rng.normal(scale=dy)
    jlc = JLC([t, f, y, dy], names=["MJD", "filter", "lum", "dlum"])
    tlc = TLC([t, np.array([tfd[n] for n in names] * 5), y, dy],
              names=["MJD", "filter", "lum", "dlum"])
    return jlc, tlc


# ------------------------------------------------------------ exact checks

def test_beta_ladder_equals_jax():
    for n, alpha in ((32, 0.3), (16, 0.3), (5, 0.5)):
        assert np.array_equal(tev.make_beta_ladder(n, alpha), jev.make_beta_ladder(n, alpha))
    b = tev.make_beta_ladder(32)
    assert b[0] == 0.0 and b[-1] == 1.0 and np.sum(b < 0.1) > 16


def _jax_step_draws(i, base, K, half):
    """The keys ``make_xs`` gives step ``i`` and the draws ``step_one``,
    ``half_update``/``propose_stretch`` and ``do_swap`` make from them
    (evidence.py:60-115, :296-308)."""
    ks = jr.split(jr.fold_in(base, i), K + 1)
    u_z, j, u_acc = (np.empty((K, 2, half)) for _ in range(3))
    for r in range(K):
        for h, kh in enumerate(jr.split(ks[r])):
            kz, kj, ku = jr.split(kh, 3)
            u_z[r, h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
            j[r, h] = np.asarray(jr.randint(kj, (half,), 0, half))
            u_acc[r, h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    u_swap = np.array(jr.uniform(ks[K], (K, 2, half), dtype=jnp.float64))
    draws = (torch.as_tensor(u_z), torch.as_tensor(j).to(torch.int64), torch.as_tensor(u_acc),
             torch.as_tensor(u_swap))
    return (ks[:K], ks[K], i % 2 == 1), draws


@pytest.mark.parametrize("route", ["make_tempered_step", "ladder_wrappers"])
def test_ladder_steps_match_jax_under_shared_draws(route):
    jlc, tlc = _synthetic(11)
    W, n_rungs, seed = 16, 4, 3
    jpri, jll, jp0, jkw, _ = jfit._tempered_setup(jlc, JSC2(jlc), SNUG, None, None, W, False,
                                                  "relative", seed)
    priors, ll, p0, kw = tfit._tempered_setup(tlc, TSC2(tlc), interop.priors_from_jax(SNUG),
                                              None, None, W, False, "relative", seed,
                                              device="cpu")
    assert jkw == {} and kw == {} and np.array_equal(p0, jp0)
    betas = tev.make_beta_ladder(n_rungs)
    K, half, ndim = len(betas), W // 2, 4
    jstep, jbpri, jbll = jev._make_tempered_step(jpri, jll, half, ndim, betas)
    x0 = np.broadcast_to(p0.reshape(1, 2, half, ndim), (K, 2, half, ndim)).copy()
    jx = jnp.asarray(x0)
    jlp = jnp.stack([jbpri(jx[r].reshape(W, ndim)).reshape(2, half) for r in range(K)])
    jl = jnp.stack([jbll(jx[r].reshape(W, ndim)).reshape(2, half) for r in range(K)])
    jl = jnp.where(jnp.isnan(jl), -jnp.inf, jl)

    lp = tfit.LogPosterior(ll, priors)
    x = torch.as_tensor(x0)
    logpri, logl = ladder.ladder_init(lp, x)
    np.testing.assert_array_equal(logpri.numpy(), np.asarray(jlp))
    np.testing.assert_allclose(logl.numpy(), np.asarray(jl), rtol=1e-12, atol=0)
    step = tev._make_tempered_step(*ladder.plain_functions(lp), half, ndim, betas)
    bt = torch.as_tensor(betas)
    before = dict(kernels.LAUNCHES)
    base = jr.PRNGKey(seed)
    n_acc = n_swap = 0
    for i in range(5):
        xs, draws = _jax_step_draws(i, base, K, half)
        (jx, jlp, jl), (_, jacc, jsw, jcold) = jstep((jx, jlp, jl), xs)
        if route == "make_tempered_step":
            (x, logpri, logl), (_, acc, sw, cold) = step((x, logpri, logl), draws, xs[2])
        else:
            u_z, j, u_acc, u_swap = draws
            n_accept = torch.zeros((K, 2, half), dtype=torch.int32)
            counts = torch.zeros_like(n_accept)
            out_l = torch.empty((K, 2, half), dtype=torch.float64)
            cold = torch.empty((2, half, ndim), dtype=torch.float64)
            for h in (0, 1):
                ladder.tempered_half_step(lp, x, logpri, logl, bt, h, u_z, j, u_acc,
                                          n_accept=n_accept)
            ladder.replica_swap(x, logpri, logl, bt, u_swap, xs[2], counts, out_l, cold)
            acc, sw = n_accept.bool(), counts.bool()
            assert torch.equal(out_l, logl)
        assert np.array_equal(acc.numpy(), np.asarray(jacc))
        assert np.array_equal(sw.numpy(), np.asarray(jsw))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=0)
        np.testing.assert_allclose(cold.numpy(), np.asarray(jcold), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(logpri.numpy(), np.asarray(jlp))
        np.testing.assert_allclose(logl.numpy(), np.asarray(jl), rtol=1e-12, atol=0)
        n_acc += int(acc.sum())
        n_swap += int(sw.sum())
    assert kernels.LAUNCHES == before          # the CPU runs the plain versions
    assert 0 < n_acc < 5 * K * W and 0 < n_swap < 5 * K * W


def jax_init_carry(jpri, jll, p, K):
    """The JAX package's ``init_carry`` arithmetic (evidence.py:229-235) on K
    copies of the states p (W, ndim): its ``batched_pri`` and ``batched_ll``
    vmapped over the rungs, a NaN log L mapped to -inf; (K, W) numpy each."""
    W, ndim = p.shape
    _, jbpri, jbll = jev._make_tempered_step(jpri, jll, W // 2, ndim,
                                             jev.make_beta_ladder(K - 1))
    jx = jnp.asarray(np.broadcast_to(p, (K, W, ndim)))
    logl = jax.vmap(jbll)(jx)
    return np.asarray(jax.vmap(jbpri)(jx)), np.asarray(jnp.where(jnp.isnan(logl), -jnp.inf, logl))


def check_init_copies(lp, jpri, jll, p, K, rel, scale):
    """``ladder.ladder_init`` on the CPU with ``copies=K`` (the plain
    version: one evaluation of the W states p, repeated) against
    ``jax_init_carry`` on K copies: (K, 2, W/2) buffers of their own, no
    launch, the same -inf sets, log pi within 1e-12 relative and log L
    within ``rel`` of ``scale`` (W,) where finite. Returns (logpri, logl),
    (K, W) numpy."""
    want_pri, want_ll = jax_init_carry(jpri, jll, p, K)
    W, ndim = p.shape
    before = dict(kernels.LAUNCHES)
    pri, ll = ladder.ladder_init(lp, torch.as_tensor(p.reshape(1, 2, W // 2, ndim)), copies=K)
    assert kernels.LAUNCHES == before           # the CPU runs the plain version
    assert pri.shape == ll.shape == (K, 2, W // 2) and pri.is_contiguous() and ll.is_contiguous()
    pri, ll = pri.reshape(K, W).numpy(), ll.reshape(K, W).numpy()
    assert not np.isnan(pri).any() and not np.isnan(ll).any()
    assert np.array_equal(np.isneginf(pri), np.isneginf(want_pri))
    assert np.array_equal(np.isneginf(ll), np.isneginf(want_ll))
    fin = np.isfinite(want_pri)
    np.testing.assert_allclose(pri[fin], want_pri[fin], rtol=1e-12, atol=0)
    fin = np.isfinite(want_ll)
    d = np.abs(ll[fin] - want_ll[fin]) / np.broadcast_to(scale, ll.shape)[fin]
    assert np.all(d <= rel), d.max()
    return pri, ll


def test_ladder_init_copies_match_jax_init_carry():
    """K6b's plain version with copies > 1 on ShockCooling2 (the ladder's
    call: one set of starting states for every rung) against the JAX
    package's init_carry on the rungs' copies, float64: states outside the
    priors (their log L evaluated all the same), one with t < t_exp at the
    first epochs and a NaN one (log L -inf)."""
    jlc, tlc = _synthetic(11)
    W, seed, K = 16, 5, 4
    jpri, jll, jp0, _, _ = jfit._tempered_setup(jlc, JSC2(jlc), SNUG, None, None, W, False,
                                                "relative", seed)
    priors, ll, p0, _ = tfit._tempered_setup(tlc, TSC2(tlc), interop.priors_from_jax(SNUG),
                                             None, None, W, False, "relative", seed,
                                             device="cpu")
    p = np.array(p0)
    p[0, 0] = 20.0                     # T_1 above its prior
    p[1, 3] = 3.0                      # t_0 after the first epochs (and above its prior)
    p[2, 1] = np.nan
    pri, logl = check_init_copies(tfit.LogPosterior(ll, priors), jpri, jll, p, K, 1e-12,
                                  np.abs(jax_init_carry(jpri, jll, p, 1)[1][0]))
    assert np.isneginf(pri[:, :3]).all() and np.isfinite(pri[:, 3:]).all()
    assert np.isfinite(logl[:, :2]).all() and np.isneginf(logl[:, 2]).all()
    assert np.isfinite(logl[:, 3:]).all() and (logl == logl[0]).all()


def test_rung_block_terms_match_jax():
    rng = np.random.default_rng(4)
    nsteps, K1, W = 37, 6, 16
    ll = -50.0 - 40.0 * rng.random((nsteps, K1, W))
    ll[3, 2, 5] = ll[30, 0, 1] = -np.inf
    dbetas = np.diff(jev.make_beta_ladder(K1 - 1))
    boundaries = tuple((int(ix[0]), int(ix[-1]) + 1)
                       for ix in np.array_split(np.arange(nsteps), 4))
    want = jev._rung_block_terms(ll, dbetas, boundaries)
    got = tev._rung_block_terms(torch.as_tensor(ll), dbetas, boundaries)
    assert got.shape == (4, K1 - 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", ["nan", "posinf", "one-neginf", "all-neginf"])
def test_rung_block_terms_edge_cases_match_jax(case):
    """The block terms where a block holds a NaN, a +inf or only -inf (NaN
    in both packages: nan_max, inf - inf, exp(-inf + inf)) and where one
    -inf lies among finite values (exp(-inf) = 0: a finite term): NaN at
    the same places, the rest <= 1e-12 relative."""
    rng = np.random.default_rng(6)
    nsteps, K1, W = 37, 6, 16
    ll = -50.0 - 40.0 * rng.random((nsteps, K1, W))
    boundaries = tuple((int(ix[0]), int(ix[-1]) + 1)
                       for ix in np.array_split(np.arange(nsteps), 4))
    b0, b1 = boundaries[1]
    if case == "nan":
        ll[b0 + 2, 3, 4] = np.nan
    elif case == "posinf":
        ll[b0 + 2, 3, 4] = np.inf
    elif case == "one-neginf":
        ll[b0 + 2, 3, 4] = -np.inf
    else:
        ll[b0:b1, 3] = -np.inf
    dbetas = np.diff(jev.make_beta_ladder(K1 - 1))
    want = jev._rung_block_terms(ll, dbetas, boundaries)
    got = tev._rung_block_terms(torch.as_tensor(ll), dbetas, boundaries)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert nan.sum() == (0 if case == "one-neginf" else 1) and not nan[[0, 2, 3]].any()
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-12, atol=0)


@pytest.mark.parametrize("prior", [JU(2.0, 7.0), JG(-100.0, 100.0, 1.0, 2.0),
                                   JG(1.0, 5.0, 1.0, 2.0), JG(0.0, 10.0, -100.0, 1.0),
                                   JLU(1.0, 100.0)],
                         ids=["uniform", "gaussian-wide", "gaussian-truncated",
                              "gaussian-pure-tail", "log-uniform"])
def test_prior_log_norm_matches_jax(prior):
    want = jfit._prior_log_norm(prior)
    got = tfit._prior_log_norm(interop.priors_from_jax([prior])[0])
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)


def test_prior_log_norm_of_a_custom_prior_matches_jax():
    """A user-defined prior with finite bounds (a density that peaks at the
    lower bound and decays as exp(-p^1.5)) normalizes as in the JAX package:
    its logp integrated on the same closed 4097-point grid."""
    from lightcurve_fitting_tpu.models.priors import Prior as JPrior

    class JDecay(JPrior):
        def logp(self, p):
            return -jnp.abs(p) ** 1.5

    class TDecay(Prior):
        def logp(self, p):
            return -torch.abs(p) ** 1.5

    for lo, hi in ((0.0, 4.0), (-1.0, 2.5)):
        want = jfit._prior_log_norm(JDecay(lo, hi))
        got = tfit._prior_log_norm(TDecay(lo, hi))
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)


def test_prior_log_norm_refusals():
    with pytest.raises(ValueError, match="unbounded"):
        tfit._prior_log_norm(TU(0.0, np.inf))
    with pytest.raises(ValueError, match="empty support"):
        tfit._prior_log_norm(TU(1.0, 1.0))

    class Custom(Prior):
        def logp(self, p):
            return -p

    with pytest.raises(ValueError, match="unbounded"):
        tfit._prior_log_norm(Custom(0.0, np.inf))
    with pytest.raises(NotImplementedError, match="item 12"):
        KDEPrior(np.zeros(10))


# ------------------------------------------------------- statistical checks

def _gauss_fns(sigma=0.3, aa=5.0, d=2, poison=False):
    def log_prior(p):
        inside = ((p > -aa) & (p < aa)).all(dim=-1)
        return torch.where(inside, torch.full_like(p[:, 0], -d * np.log(2 * aa)),
                           torch.full_like(p[:, 0], -torch.inf))

    def log_like(p):
        ll = -0.5 * (p ** 2).sum(dim=-1) / sigma ** 2
        if poison:    # NaN likelihood in a corner of the prior box
            ll = torch.where((p > 4.5).all(dim=-1), torch.full_like(ll, torch.nan), ll)
        return ll

    true_log_z = 0.5 * d * np.log(2 * np.pi * sigma ** 2) - d * np.log(2 * aa)
    return log_prior, log_like, true_log_z


def test_stepping_stone_matches_analytic_gaussian():
    log_prior, log_like, true_log_z = _gauss_fns()
    p0 = np.random.default_rng(0).uniform(-5.0, 5.0, (64, 2))
    log_z, err, info = tev.stepping_stone_evidence(log_prior, log_like, p0, n_rungs=24,
                                                   nsteps=400, nsteps_burnin=400, seed=1,
                                                   device="cpu")
    assert err < 0.1
    assert abs(log_z - true_log_z) < max(4 * err, 0.05), (log_z, true_log_z, err)
    assert np.all(info["acceptance"] > 0.2) and info["swap_rate"].shape == (25,)


def test_ladder_survives_nonfinite_start_walker():
    log_prior, log_like, true_log_z = _gauss_fns(poison=True)
    p0 = np.random.default_rng(3).uniform(-5.0, 5.0, (64, 2))
    p0[0] = [4.9, 4.9]  # one walker starts in the NaN region
    log_z, err, _ = tev.stepping_stone_evidence(log_prior, log_like, p0, n_rungs=16,
                                                nsteps=300, nsteps_burnin=300, seed=4,
                                                device="cpu")
    assert np.isfinite(log_z)
    assert abs(log_z - true_log_z) < max(4 * err, 0.1), (log_z, true_log_z, err)


def test_short_chain_error_is_inf():
    log_prior, log_like, _ = _gauss_fns()
    p0 = np.random.default_rng(0).uniform(-5, 5, (16, 2))
    log_z, err, _ = tev.stepping_stone_evidence(log_prior, log_like, p0, n_rungs=4, nsteps=1,
                                                nsteps_burnin=2, seed=0, device="cpu")
    assert np.isfinite(log_z) and err == np.inf


def test_occam_factor_matches_jax():
    """Snug priors against 10x wider ones on synthetic ShockCooling2
    photometry: the log Bayes factor (~ 4 log 10) of the port agrees with
    the JAX package's."""
    jlc, tlc = _synthetic(3)
    kw = dict(nwalkers=32, n_rungs=16, nsteps=250, nsteps_burnin=250, seed=4, quiet=True)
    z = {}
    for name, pri in (("snug", SNUG), ("wide", WIDE)):
        z[name, "jax"] = jfit.lightcurve_evidence(jlc, JSC2(jlc), pri, **kw)[:2]
        z[name, "port"] = tfit.lightcurve_evidence(tlc, TSC2(tlc), interop.priors_from_jax(pri),
                                                   device="cpu", **kw)[:2]
    d_port = z["snug", "port"][0] - z["wide", "port"][0]
    d_jax = z["snug", "jax"][0] - z["wide", "jax"][0]
    e_port = np.hypot(z["snug", "port"][1], z["wide", "port"][1])
    e_jax = np.hypot(z["snug", "jax"][1], z["wide", "jax"][1])
    assert 3.0 < d_port < 20.0, z
    assert abs(d_port - d_jax) < 4 * np.hypot(e_port, e_jax) + 0.5, z


def test_f32_rescaled_ladder_state_preserves_evidence():
    """state_dtype=float32: the ladder's walker state runs over the
    affine-rescaled init window in float32 (the CUDA mode); the evidence is
    invariant and the PT cold chain maps back to absolute parameters."""
    t0_true = 57000.0
    _, lc = _synthetic(0, t0_true)
    priors = [TU(1.0, 50.0), TU(0.1, 20.0), TU(5.0, 100.0), TU(56999.5, 57000.5)]
    kw = dict(p_lo=[5.0, 0.5, 20.0, 56999.7], p_up=[25.0, 5.0, 60.0, 57000.3], nwalkers=32,
              n_rungs=8, nsteps=150, nsteps_burnin=150, seed=2, quiet=True, device="cpu")
    z64, e64, _ = tfit.lightcurve_evidence(lc, TSC2(lc), priors, state_dtype=np.float64, **kw)
    z32, e32, _ = tfit.lightcurve_evidence(lc, TSC2(lc), priors, state_dtype=np.float32, **kw)
    assert abs(z32 - z64) < 4.0 * np.hypot(e32, e64) + 0.5, (z32, z64, e32, e64)
    pt = tfit.lightcurve_ptmcmc(lc, TSC2(lc), priors, state_dtype=np.float32, **kw)
    assert pt.flatchain.shape == (150 * 32, 4) and pt.flatchain.dtype == np.float64
    med = np.median(pt.flatchain, axis=0)
    assert med[0] == pytest.approx(12.0, rel=0.3)
    assert med[3] == pytest.approx(t0_true, abs=0.2)
    assert 1e-8 < pt.flatchain[:, 3].std() < 0.2
    assert pt.chain.shape == (32, 150, 4) and pt.flatlnlikelihood.shape == (150 * 32,)


def test_replica_exchange_recovers_both_modes_from_one():
    aa = 8.0
    mu = torch.tensor([3.0, 3.0], dtype=torch.float64)

    def log_prior(p):
        inside = ((p > -aa) & (p < aa)).all(dim=-1)
        return torch.where(inside, torch.full_like(p[:, 0], -2 * np.log(2 * aa)),
                           torch.full_like(p[:, 0], -torch.inf))

    def log_like(p):
        a = -0.5 * ((p - mu) ** 2).sum(dim=-1) / 0.25 ** 2
        b = -0.5 * ((p + mu) ** 2).sum(dim=-1) / 0.25 ** 2
        return torch.logaddexp(a, b)

    p0 = np.random.default_rng(0).normal([3.0, 3.0], 0.25, (32, 2))   # all in one mode
    log_z, err, info = tev.stepping_stone_evidence(log_prior, log_like, p0, n_rungs=12,
                                                   nsteps=600, nsteps_burnin=600, seed=1,
                                                   return_cold_chain=True, device="cpu")
    cold = info["cold_chain"][300:].reshape(-1, 2)
    frac_pos = float(np.mean(cold[:, 0] > 0))
    assert 0.25 < frac_pos < 0.75, frac_pos
    d = np.minimum(np.abs(cold[:, 0] - 3.0), np.abs(cold[:, 0] + 3.0))
    assert np.percentile(d, 95) < 1.0
    true_log_z = np.log(2 * 2 * np.pi * 0.25 ** 2) - 2 * np.log(2 * aa)
    assert abs(log_z - true_log_z) < max(5 * err, 0.2), (log_z, true_log_z, err)
    assert info["swap_rate"].max() > 0.2
    assert info["cold_logl"].shape == (600, 32)


def test_compare_models_ranks_by_occam_factor(capsys):
    _, lc = _synthetic(11)
    narrow = [TU(8.0, 16.0), TU(1.0, 3.0), TU(25.0, 45.0), TU(-0.5, 0.5)]
    wide = [TU(1.0, 400.0), TU(0.1, 100.0), TU(1.0, 1000.0), TU(-3.0, 3.0)]
    kw = dict(p_lo=[8.0, 1.0, 25.0, -0.5], p_up=[16.0, 3.0, 45.0, 0.5], nwalkers=16,
              n_rungs=8, nsteps=60, nsteps_burnin=60, seed=5, device="cpu")
    table = tfit.compare_models(lc, [TSC2(lc), TSC2(lc)], [wide, narrow],
                                labels=["wide", "narrow"], **kw)
    assert "narrow: log Z" in capsys.readouterr().out
    assert list(table["model"]) == ["narrow", "wide"]
    assert table["delta_log_z"][0] == 0.0 and table["ddelta_log_z"][0] == 0.0
    assert table["delta_log_z"][1] < -3.0 and table["ddelta_log_z"][1] > 0.0
    assert set(table.meta["info"]) == {"narrow", "wide"}
    assert np.all(np.asarray(table["dlog_z"]) > 0.0)
    # one shared flat prior list, default labels deduplicated
    kw.update(n_rungs=4, nsteps=20, nsteps_burnin=20, quiet=True)
    table = tfit.compare_models(lc, [TSC2(lc), TSC2(lc)], narrow, **kw)
    assert sorted(table["model"]) == ["ShockCooling2", "ShockCooling2#2"]
    with pytest.raises(ValueError, match="at least two"):
        tfit.compare_models(lc, [TSC2(lc)], narrow, **kw)
    with pytest.raises(ValueError, match="per model"):
        tfit.compare_models(lc, [TSC2(lc), TSC2(lc)], [narrow] * 3, **kw)
    with pytest.raises(ValueError, match="unique"):
        tfit.compare_models(lc, [TSC2(lc), TSC2(lc)], [wide, narrow], labels=["a", "a"], **kw)


# --------------------------------------------------------------- refusals

def test_refusals():
    _, lc = _synthetic(11)
    pri = [TU(8.0, 16.0), TU(1.0, 3.0), TU(25.0, 45.0), TU(-0.5, 0.5)]
    kw = dict(nwalkers=16, n_rungs=4, nsteps=4, nsteps_burnin=4, quiet=True, device="cpu")
    for driver in (tfit.lightcurve_evidence, tfit.lightcurve_ptmcmc):
        with pytest.raises(NotImplementedError, match="item 17"):
            driver(lc, TSC2(lc), pri, mesh=object(), **kw)
        for opt in ({"checkpoint_every": 2, "checkpoint_file": "ck.npz"},
                    {"resume_from": "ck.npz"}):
            with pytest.raises(NotImplementedError, match="item 16"):
                driver(lc, TSC2(lc), pri, **opt, **kw)
    with pytest.raises(NotImplementedError, match="item 16"):
        tfit.compare_models(lc, [TSC2(lc), TSC2(lc)], pri, checkpoint_file="ck.npz", **kw)
    log_prior, log_like, _ = _gauss_fns()
    p0 = np.random.default_rng(0).uniform(-5, 5, (16, 2))
    with pytest.raises(NotImplementedError, match="item 17"):
        tev.stepping_stone_evidence(log_prior, log_like, p0, mesh=object(), device="cpu")
    # plain callables have no kernel: they run on the CPU only
    with pytest.raises(NotImplementedError, match="run on the CPU"):
        tev.stepping_stone_evidence(log_prior, log_like, p0, device="cuda")
    with pytest.raises(NotImplementedError, match="CUDA"):
        ladder.tempered_half_step((log_prior, log_like), torch.empty((2, 2, 4, 2), device="meta"),
                                  *(torch.empty((2, 2, 4), device="meta"),) * 2,
                                  torch.empty(2, device="meta"), 0, None, None, None)


def jax_bench_evidence(seeds=(1, 2)):
    """The JAX package's stepping-stone log Z, float64 on the CPU, at the
    evidence bench shape (bench.py:189-232: ShockCooling2 on SN 2016bkv,
    4096 walkers, 16 rungs + beta = 1, 150 + 150 steps): the reference
    ``chip_smoke.py`` holds the port's card run to. About 70 s a seed on 8
    CPU cores."""
    import contextlib
    import io
    import os
    lc = JLC.read(os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                               "SN2016bkv.csv"))
    lc.meta.update(dm=30.79, redshift=0.002, extinction={
        "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
        "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
    lc.calcAbsMag()
    lc.calcLum()
    early = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    priors = [JU(0.0, 100.0)] * 3 + [JU(57468.0, 57468.7)]
    out = {}
    for seed in seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            out[seed] = jfit.lightcurve_evidence(
                early, JSC2(early), priors, p_lo=[20.0, 2.0, 20.0, 57468.5],
                p_up=[50.0, 5.0, 50.0, 57468.7], nwalkers=4096, n_rungs=16, nsteps=150,
                nsteps_burnin=150, seed=seed, quiet=True)[:2]
    return out


if __name__ == "__main__":
    for seed, (log_z, err) in jax_bench_evidence().items():
        print(f"seed {seed}: log Z {log_z!r} +/- {err!r}")
