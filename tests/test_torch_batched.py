"""The batched per-epoch blackbody path of the port (``parallel/batched.py``,
``parallel/hmc.py::BoundsTransform``, ``parallel/optimize.py``, and the plain
versions of the epoch kernels) against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and go through both packages.
Tolerances, each with its reason:
- ``pack_epochs``: bit-equal arrays (the same host numpy);
- the epoch log-posterior in float64: <= 1e-12 relative (the two
  frameworks sum the Planck terms in other orders); in float32, both
  packages under their float32 compute dtype: <= 1e-5 (|ll - c| + |c|),
  the repo's float32 log-likelihood budget, c the epoch's normalization
  constant log_norm (the residual sum and c cancel near the best fit);
  identical -inf sets;
- its gradient against ``jax.grad`` in float64: <= 1e-10 relative;
- ``CosineAdam`` against optax over 300 steps in float64: <= 1e-12
  relative (XLA on the CPU may contract to FMA, so not bit for bit);
- ``batched_map_centers`` from the JAX package's own cloud: <= 1e-6
  relative (300 Adam steps from identical starts; measured ~1e-15);
- one epoch half-step under shared draws: exact (same arithmetic in float64);
- ``_epoch_summary`` on one chain: float64 <= 1e-12 relative; the float32
  path <= 1e-5, the budget of tests/test_bolometric.py:432;
- a whole ``batched_blackbody_mcmc`` run: statistical (the random streams
  differ): medians within one posterior sigma, 16-84 widths in ratio
  (0.6, 1.7), acceptance within 0.03.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import optax  # noqa: E402

from lightcurve_fitting_tpu.bolometric import _pseudo_grid  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.filters import filtdict as jfd  # noqa: E402
from lightcurve_fitting_tpu.models import GaussianPrior as JG  # noqa: E402
from lightcurve_fitting_tpu.models import LogUniformPrior as JLU, UniformPrior as JU  # noqa: E402
from lightcurve_fitting_tpu.models.base import intrinsic_scatter_units as j_units  # noqa: E402
from lightcurve_fitting_tpu.models.blackbody import planck_lnu as j_planck  # noqa: E402
from lightcurve_fitting_tpu.ops.filterbank import FilterBank as JFB  # noqa: E402
from lightcurve_fitting_tpu.parallel import batched as jb  # noqa: E402
from lightcurve_fitting_tpu.parallel.hmc import BoundsTransform as JBT  # noqa: E402
from lightcurve_fitting_tpu.parallel.sampler import make_stretch_kernel  # noqa: E402
from lightcurve_fitting_tpu.utils.table import Table as JT  # noqa: E402

from lightcurve_fitting_tpu_torch import kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict as tfd  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import epoch_bb  # noqa: E402
from lightcurve_fitting_tpu_torch.models import GaussianPrior as TG  # noqa: E402
from lightcurve_fitting_tpu_torch.models import LogUniformPrior as TLU, UniformPrior as TU  # noqa: E402
from lightcurve_fitting_tpu_torch.models.base import intrinsic_scatter_units as t_units  # noqa: E402
from lightcurve_fitting_tpu_torch.ops.filterbank import FilterBank as TFB  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import batched as tb  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform as TBT  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.optimize import CosineAdam, cosine_decay_lr  # noqa: E402
from lightcurve_fitting_tpu_torch.utils.table import Table as TT  # noqa: E402

NAMES = ["U", "B", "g", "V", "r", "i"]
DATA_KEYS = ["y", "dy", "mask", "nodes", "weights", "yscale"]


def _priors(use_sigma):
    j = [JU(1.0, 100.0), JLU(0.01, 1000.0)] + ([JG(0.0, 10.0)] if use_sigma else [])
    t = [TU(1.0, 100.0), TLU(0.01, 1000.0)] + ([TG(0.0, 10.0)] if use_sigma else [])
    return j, t


def _epochs(E, seed=0, z=0.0, ragged=True):
    """E synthetic blackbody epochs (JAX and port tables of the same numbers):
    6 bands, or with ``ragged`` 6, 5 and 4 bands in turn; returns
    (jax packed, port packed, true (T, R))."""
    rng = np.random.default_rng(seed)
    jbank = JFB([jfd[n] for n in NAMES])
    tbank = TFB([tfd[n] for n in NAMES])
    jeps, teps, truth = [], [], []
    for e in range(E):
        T, R = rng.uniform(4.0, 20.0), rng.uniform(1.0, 30.0)
        lnu = np.asarray(j_planck(jnp.asarray(jbank.emitted_nodes(z)), T, R))
        y = (jbank.weights * lnu).sum(-1)
        dy = 0.05 * np.abs(y)
        y = y + rng.normal(scale=dy)
        nb = 6 - (e % 3) if ragged else 6
        jeps.append(JT([[jfd[n] for n in NAMES[:nb]], y[:nb], dy[:nb]],
                       names=["filter", "lum", "dlum"]))
        teps.append(TT([[tfd[n] for n in NAMES[:nb]], y[:nb], dy[:nb]],
                       names=["filter", "lum", "dlum"]))
        truth.append((T, R))
    return (jb.pack_epochs(jeps, jbank, z), tb.pack_epochs(teps, tbank, z, device="cpu"),
            np.array(truth))


@pytest.fixture(scope="module")
def packs():
    return _epochs(5, seed=1, z=0.01)


def _jax_logpost(jpacked, jpriors, use_sigma, sigma_type, p):
    """The JAX package's epoch log-posterior at p (E, M, ndim)."""
    dt = jconfig.get_compute_dtype()
    make = jb._make_epoch_logpost(jpriors, np.inf, use_sigma, sigma_type, dt)
    out = []
    for e in range(p.shape[0]):
        lp = make(*[jpacked[k][e] for k in DATA_KEYS])
        out.append(np.asarray(jax.vmap(lp)(jnp.asarray(p[e]))))
    return np.stack(out)


def _params(rng, E, M, ndim):
    """Log-uniform parameter vectors over and beyond the priors, with some
    T <= 0 and R outside its prior."""
    lo, hi = [0.5, 0.005, 0.01][:ndim], [150.0, 2000.0, 20.0][:ndim]
    p = np.exp(rng.uniform(np.log(lo), np.log(hi), size=(E, M, ndim)))
    p[:, 0, 0] = -1.0
    p[:, 1, 0] = 0.0
    p[:, 2, 1] = 1500.0
    return p


# ------------------------------------------------------------------- packing

def test_pack_epochs_bit_equal(packs):
    jp, tp, _ = packs
    for k in DATA_KEYS:
        want = np.asarray(jp[k])
        got = tp[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k


def test_intrinsic_scatter_units_masked_absolute_even_count():
    """'absolute' over the real bands only: 4 real of 6, an even count, whose
    median is the mean of the middle two (not torch.nanmedian's lower one)."""
    dy = np.array([0.3, 0.1, 0.4, 0.2, 9.0, 9.0])
    mask = np.array([True, True, True, True, False, False])
    got = t_units(dy, "absolute", mask=mask)
    assert got == float(j_units(jnp.asarray(dy), "absolute", mask=jnp.asarray(mask)))
    assert got == float(j_units(dy, "absolute", mask=mask, xp=np)) == 0.25
    assert np.array_equal(t_units(dy, "relative", mask=mask), dy)


# ------------------------------------------------------- the log-posterior (K4)

@pytest.mark.parametrize("use_sigma,sigma_type", [(False, "relative"), (True, "relative"),
                                                  (True, "absolute")])
def test_epoch_logpost_f64_matches_jax(packs, use_sigma, sigma_type):
    jp, tp, _ = packs
    jpri, tpri = _priors(use_sigma)
    p = _params(np.random.default_rng(2), 5, 24, len(tpri))
    want = _jax_logpost(jp, jpri, use_sigma, sigma_type, p)
    ep = tb.EpochPosterior(tp, tpri, use_sigma=use_sigma, sigma_type=sigma_type)
    got = ep(torch.as_tensor(p)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isinf(got[:, :3]).all() and np.isfinite(got).sum() > 60
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("use_sigma", [False, True])
def test_epoch_logpost_f32_matches_jax(packs, use_sigma):
    jp, tp, _ = packs
    jpri, tpri = _priors(use_sigma)
    p = _params(np.random.default_rng(3), 5, 24, len(tpri))
    try:
        jconfig.set_compute_dtype(jnp.float32)
        tconfig.set_compute_dtype(torch.float32)
        want = _jax_logpost(jp, jpri, use_sigma, "relative", p)
        ep = tb.EpochPosterior(tp, tpri, use_sigma=use_sigma)
        assert ep.y.dtype == torch.float32
        got = ep(torch.as_tensor(p)).numpy()
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    c = np.broadcast_to(ep.log_norm.numpy()[:, None], want.shape)[fin]
    scale = np.abs(want[fin] - c) + np.abs(c)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 * scale)


@pytest.mark.parametrize("use_sigma", [False, True])
def test_epoch_logpost_gradient_matches_jax_grad(packs, use_sigma):
    """The gradient the MAP polish uses (autograd of the plain version on
    the CPU) against jax.grad of the JAX package's epoch log-posterior, at
    points inside the priors, float64."""
    jp, tp, truth = packs
    jpri, tpri = _priors(use_sigma)
    rng = np.random.default_rng(4)
    ndim = len(tpri)
    p = np.stack([np.column_stack([rng.uniform(0.6, 1.5, 12) * t[0],
                                   rng.uniform(0.6, 1.5, 12) * t[1]]
                                  + ([rng.uniform(0.1, 3.0, 12)] if use_sigma else []))
                  for t in truth])
    make = jb._make_epoch_logpost(jpri, np.inf, use_sigma, "relative", None)
    want = np.stack([np.asarray(jax.vmap(jax.grad(make(*[jp[k][e] for k in DATA_KEYS])))(
        jnp.asarray(p[e]))) for e in range(len(p))])
    ep = tb.EpochPosterior(tp, tpri, use_sigma=use_sigma)
    lp, got = epoch_bb.log_posterior(ep, torch.as_tensor(p), with_grad=True)
    assert got.shape == (5, 12, ndim) and torch.isfinite(lp).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0.0)


def test_differentiable_form_gives_the_same_gradient(packs):
    _, tp, truth = packs
    _, tpri = _priors(False)
    ep = tb.EpochPosterior(tp, tpri)
    p = torch.as_tensor(np.repeat(truth[:, None, :], 3, axis=1) * [1.1, 0.9]).requires_grad_(True)
    g, = torch.autograd.grad(ep.differentiable(p).sum(), p)
    _, g_direct = epoch_bb.log_posterior(ep, p.detach(), with_grad=True)
    assert torch.equal(g, g_direct)


# --------------------------------------------------------- transforms, Adam

def test_bounds_transform_round_trips_and_matches_jax():
    lo = np.array([1.0, 0.01, -np.inf, 0.0, -np.inf])
    up = np.array([100.0, 1000.0, 5.0, np.inf, np.inf])
    jbt, tbt = JBT(lo, up), TBT(lo, up)
    rng = np.random.default_rng(5)
    u = rng.normal(scale=3.0, size=(7, 5))
    x_t = tbt.to_bounded(torch.as_tensor(u))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(jbt.to_bounded(jnp.asarray(u))),
                               rtol=1e-14, atol=0.0)
    np.testing.assert_allclose(tbt.log_jacobian(torch.as_tensor(u)).numpy(),
                               np.asarray(jax.vmap(jbt.log_jacobian)(jnp.asarray(u))),
                               rtol=1e-13, atol=1e-13)
    # round trips: x -> u -> x in the box, and the numpy and tensor forms agree
    x = x_t.numpy()
    u_back = tbt.to_unbounded(torch.as_tensor(x))
    np.testing.assert_allclose(tbt.to_bounded(u_back).numpy(), x, rtol=1e-9, atol=0.0)
    np.testing.assert_allclose(tbt.to_unbounded(x), np.asarray(jbt.to_unbounded(x)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(u_back.numpy(), u, rtol=1e-6, atol=1e-6)
    # a point on a bound is clipped eps inside: finite u, and finite gradients
    edge = torch.tensor([[1.0, 1000.0, 5.0, 0.0, 3.0]], dtype=torch.float64)
    assert torch.isfinite(tbt.to_unbounded(edge)).all()
    uu = torch.as_tensor(u).requires_grad_(True)
    g, = torch.autograd.grad(tbt.to_bounded(uu).sum() + tbt.log_jacobian(uu).sum(), uu)
    assert torch.isfinite(g).all()


def test_cosine_adam_matches_optax():
    """300 steps on a batch of starts of a curved objective: the state stays
    one tensor, and every iterate agrees with optax within 1e-12."""
    rng = np.random.default_rng(6)
    u0 = rng.normal(size=(4, 8, 3))
    target = rng.normal(size=(4, 1, 3))

    def grad_np(u, xp):
        d = u - xp.asarray(target)
        return 2.0 * d * (1.0 + 0.5 * xp.sin(3.0 * d)) + 1.5 * xp.cos(3.0 * d) * d * d

    opt = optax.adam(optax.cosine_decay_schedule(0.05, 300, alpha=0.01))
    uj = jnp.asarray(u0)
    state = opt.init(uj)
    ut = torch.as_tensor(u0)
    adam = CosineAdam(ut, lr=0.05, n_iter=300, alpha=0.01)
    for t in range(300):
        updates, state = opt.update(grad_np(uj, jnp), state, uj)
        uj = optax.apply_updates(uj, updates)
        ut = adam.step(ut, grad_np(ut, torch))
        assert ut.shape == (4, 8, 3)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-12, atol=1e-14)
    sched = optax.cosine_decay_schedule(0.05, 300, alpha=0.01)
    for t in (0, 1, 150, 299, 300, 400):
        assert cosine_decay_lr(t, 0.05, 300, 0.01) == pytest.approx(float(sched(t)), rel=1e-15)


# ------------------------------------------------------------- the centering

def test_map_centers_from_the_jax_cloud_match(packs):
    """The port's centering fed the JAX package's cloud (the uniforms of
    jr.split(jr.PRNGKey(seed), E)) lands on the JAX centers."""
    jp, tp, _ = packs
    jpri, tpri = _priors(False)
    seed, E = 3, 5
    keys = jr.split(jr.PRNGKey(seed), E)
    cloud_u = np.stack([np.asarray(jr.uniform(keys[e], (512, 2))) for e in range(E)])
    want = jb.batched_map_centers(jp, jpri, seed=seed)
    centers, alive = tb._map_centers(tb.EpochPosterior(tp, tpri), torch.as_tensor(cloud_u))
    assert bool(alive.all())
    np.testing.assert_allclose(centers.numpy(), want, rtol=1e-6, atol=0.0)


def test_map_centers_fall_back_and_break_ties_by_index(packs):
    """An epoch whose whole cloud is outside the priors falls back to
    ``fallback``; among equal (-inf) scores the lowest indices are kept, as
    lax.top_k keeps them."""
    _, tp, _ = packs
    _, tpri = _priors(False)
    ep = tb.EpochPosterior(tp, tpri)
    scores = torch.tensor([[0.0, -np.inf, 1.0, -np.inf, -np.inf, 1.0]])
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :4]
    assert top.tolist() == [[2, 5, 0, 1]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), 4)[1]).tolist() == [[2, 5, 0, 1]]
    dead = dict(tp, dy=torch.zeros_like(tp["dy"]))         # log_norm = -inf: no finite start
    c = tb.batched_map_centers(dead, tpri, n_iter=3, n_cloud=16, fallback=[7.0, 8.0])
    assert np.array_equal(c, np.tile([7.0, 8.0], (ep.n_epochs, 1)))


# ---------------------------------------------------- the half-step, summaries

def test_epoch_half_step_matches_jax_under_shared_draws(packs):
    """One step (both halves) of every epoch's ensemble from the JAX
    package's draws: new states and log-posteriors equal the JAX step's."""
    jp, tp, truth = packs
    jpri, tpri = _priors(False)
    E, half, ndim = 5, 8, 2
    rng = np.random.default_rng(7)
    x0 = np.abs(truth[:, None, None, :] * (1 + 0.2 * rng.normal(size=(E, 2, half, ndim))))
    make = jb._make_epoch_logpost(jpri, np.inf, False, "relative", None)
    keys = jr.split(jr.PRNGKey(11), E)
    draws = {k: np.empty((E, 2, half)) for k in ("u_z", "u_acc")}
    draws["j"] = np.empty((E, 2, half), np.int64)
    x_want, lp_want = [], []
    for e in range(E):
        lp = make(*[jp[k][e] for k in DATA_KEYS])
        step, batched = make_stretch_kernel(lp, half, ndim)
        xe = jnp.asarray(x0[e])
        (xn, ln), _ = step((xe, batched(xe.reshape(-1, ndim)).reshape(2, half)), keys[e])
        x_want.append(np.asarray(xn))
        lp_want.append(np.asarray(ln))
        for h, kh in enumerate(jr.split(keys[e])):      # the draws half_update makes
            kz, kj, ku = jr.split(kh, 3)
            draws["u_z"][e, h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
            draws["j"][e, h] = np.asarray(jr.randint(kj, (half,), 0, half))
            draws["u_acc"][e, h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    ep = tb.EpochPosterior(tp, tpri)
    x = torch.as_tensor(x0).contiguous()
    logp = ep(x.reshape(E, 2 * half, ndim)).reshape(E, 2, half)
    n_acc = torch.zeros((E, 2, half), dtype=torch.int32)
    cx, cl = torch.empty_like(x), torch.empty_like(logp)
    u_z, j, u_acc = (torch.as_tensor(draws[k]) for k in ("u_z", "j", "u_acc"))
    for h in (0, 1):
        epoch_bb.stretch_half_step(ep, x, logp, h, u_z, j, u_acc, 2.0, cx, cl, n_acc)
    assert 0 < int(n_acc.sum()) < 2 * E * half
    assert np.array_equal(x.numpy(), np.stack(x_want))
    np.testing.assert_allclose(logp.numpy(), np.stack(lp_want), rtol=1e-12, atol=0.0)
    assert torch.equal(cx, x) and torch.equal(cl, logp)


def _chain_for(truth, steps, nwalkers, seed=8):
    rng = np.random.default_rng(seed)
    E = len(truth)
    return np.abs(truth[:, None, None, :] * (1 + 0.1 * rng.normal(size=(E, steps, nwalkers, 2))))


@pytest.mark.parametrize("cutoff_freq", [np.inf, 600.0], ids=["no-cutoff", "cutoff600"])
def test_epoch_summary_matches_jax(packs, cutoff_freq):
    """_epoch_summary on one chain per epoch: float64 within 1e-12, the
    float32 path (float32 rows, counting-bisection percentiles) within 1e-5;
    without a cutoff and with one inside the grid (600 THz)."""
    _, _, truth = packs
    steps, nw = 12, 10
    chain = _chain_for(truth, steps, nw)                       # (E, steps, nw, 2)
    nu = _pseudo_grid() * 1.01
    w = np.ones(nu.shape)
    w[0] = w[-1] = 0.5
    tchain = torch.as_tensor(chain).permute(1, 0, 2, 3).contiguous()   # (steps, E, nw, 2)
    for dt_j, dt_t, rtol in ((None, None, 1e-12), (jnp.float32, torch.float32, 1e-5)):
        want = np.stack([np.asarray(jb._epoch_summary(
            jnp.asarray(c.reshape(-1, 2)), jnp.float64, dt_j, jnp.asarray(nu), jnp.asarray(w),
            cutoff_freq, nw)) for c in chain])
        x = tchain.float() if dt_t is not None else tchain
        got = tb._epoch_summary(x, dt_t, torch.as_tensor(nu), torch.as_tensor(w), cutoff_freq)
        assert got.shape == (5, 4, 3) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0.0)


def test_summary_samples_layout():
    """K4s's plain rows: T, R exactly; (R T^2)^2 in float64; sample s =
    step * nwalkers + walker."""
    chain = torch.as_tensor(_chain_for(np.array([[8.0, 3.0], [12.0, 5.0]]), 4, 6)) \
        .permute(1, 0, 2, 3).contiguous()
    nu = torch.linspace(400.0, 900.0, 50, dtype=torch.float64)
    rows = epoch_bb.summary_samples(chain, nu, torch.ones_like(nu), np.inf, None)
    assert rows.shape == (2, 4, 24)
    T = chain[..., 0].permute(1, 0, 2).reshape(2, 24)
    R = chain[..., 1].permute(1, 0, 2).reshape(2, 24)
    assert torch.equal(rows[:, 0], T) and torch.equal(rows[:, 1], R)
    assert torch.equal(rows[:, 2], (R * T * T) ** 2)


# --------------------------------------------------------------- whole runs

def test_batched_mcmc_statistics_match_jax():
    """8 synthetic epochs x 16 walkers x (150 + 150) steps with summaries,
    from the same guesses: the port's medians within one posterior sigma
    of the JAX package's, 16-84 widths in ratio (0.6, 1.7), acceptance
    within 0.03; chains and summaries consistent."""
    jp, tp, truth = _epochs(8, seed=9, ragged=False)
    jpri, tpri = _priors(False)
    rng = np.random.default_rng(10)
    guesses = np.abs(truth[:, None, :] * (1 + 0.05 * rng.normal(size=(8, 16, 2))))
    summ = {"z": 0.0, "pseudo_nu": _pseudo_grid()}
    jf, ja, js = jb.batched_blackbody_mcmc(jp, jpri, guesses, 16, 150, 150, seed=1,
                                           summaries=summ)
    before = dict(kernels.LAUNCHES)
    tf, ta, ts = tb.batched_blackbody_mcmc(tp, tpri, guesses, 16, 150, 150, seed=1,
                                           summaries=summ)
    assert kernels.LAUNCHES == before                        # the CPU runs no kernel
    assert tf.shape == jf.shape == (8, 150 * 16, 2) and ts.shape == (8, 4, 3)
    assert np.isfinite(ts).all() and np.isfinite(tf).all()
    sigma = (js[:, :2, 2] - js[:, :2, 0]) / 2
    assert np.all(np.abs(ts[:, :2, 1] - js[:, :2, 1]) < sigma)
    ratio = (ts[:, :, 2] - ts[:, :, 0]) / (js[:, :, 2] - js[:, :, 0])
    assert np.all((ratio > 0.6) & (ratio < 1.7)), ratio
    assert abs(ta.mean() - ja.mean()) < 0.03
    # the summary is the chain's (float64 on the CPU: torch.quantile)
    np.testing.assert_allclose(ts[:, 0], np.percentile(tf[..., 0], [16, 50, 84], axis=1).T,
                               rtol=1e-12)
    # no summaries: (chains, acceptance)
    out = tb.batched_blackbody_mcmc(tp, tpri, guesses, 16, 2, 3, seed=1)
    assert len(out) == 2 and out[0].shape == (8, 48, 2)


def test_batched_refusals(packs):
    _, tp, _ = packs
    _, tpri = _priors(False)
    with pytest.raises(NotImplementedError, match="item 17"):
        tb.batched_map_centers(tp, tpri, mesh=object())
    with pytest.raises(NotImplementedError, match="item 17"):
        tb.batched_blackbody_mcmc(tp, tpri, np.ones((5, 4, 2)), 4, 1, 1, mesh=object())
    with pytest.raises(ValueError, match="even"):
        tb.batched_blackbody_mcmc(tp, tpri, np.ones((5, 3, 2)), 3, 1, 1)


def jax_bench_acceptance(seeds=(1, 2, 3)):
    """The JAX package's mean acceptance, float64 on the CPU, at the
    bolometric bench shape (bench.py:108-166: 256 epochs of rng 0 x 32
    walkers x 200 + 100 steps, centers and guesses of each seed in turn):
    the reference value ``chip_smoke.py`` holds the port to (seed 1)."""
    from lightcurve_fitting_tpu.utils.table import Table
    E, nwalkers = 256, 32
    rng = np.random.default_rng(0)
    filts = [jfd[n] for n in NAMES]
    bank = JFB(filts)
    epochs = []
    for _ in range(E):
        T, R = rng.uniform(4.0, 20.0), rng.uniform(1.0, 30.0)
        y = (bank.weights * np.asarray(j_planck(jnp.asarray(bank.emitted_nodes(0.0)), T, R))).sum(-1)
        dy = 0.05 * np.abs(y)
        epochs.append(Table([filts, y + rng.normal(scale=dy), dy], names=["filter", "lum", "dlum"]))
    packed = jb.pack_epochs(epochs, bank, 0.0)
    priors, _ = _priors(False)
    out = {}
    for seed in seeds:
        centers = jb.batched_map_centers(packed, priors, seed=seed)
        guesses = rng.normal(size=(E, nwalkers, 2)) * 0.5 + centers[:, None, :]
        guesses[guesses <= 0.0] = 1.0
        _, acc, _ = jb.batched_blackbody_mcmc(packed, priors, guesses, nwalkers, 200, 100,
                                              seed=seed, return_chains=False,
                                              summaries={"z": 0.0, "pseudo_nu": _pseudo_grid()})
        out[seed] = float(np.mean(acc))
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_batched.py: the reference acceptance (~30 s)
    jax.config.update("jax_enable_x64", True)
    for seed, acc in jax_bench_acceptance().items():
        print(f"seed {seed}: mean acceptance {acc!r}")
