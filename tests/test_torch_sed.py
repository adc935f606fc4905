"""The port's sequential bolometric path against the JAX package's, on the
CPU: the SED log-posterior (``bolometric.SEDLogPosterior``, the plain
version beside K10), ``KDEPrior`` and its evidence window, the host sampler,
one SED half-step and five steps of the run form under shared draws,
``spectrum_mcmc`` and
``calculate_bolometric(batch_mode=False)`` with KDE chaining into a
single-filter epoch, on windows of SN 2016bkv.

Tolerances, each with its reason:
- the SED log-posterior in float64: 1e-12 of the term scale
  (``SEDLogPosterior.term_scales``; float64 rounding: torch and XLA sum the
  points and round log/exp apart); with the float32 compute of the card's
  default in both packages, 1e-5 of it (the band table's Clenshaw
  recurrence in float32, as ``chebyshev_bandflux``);
- ``KDEPrior`` construction (subsampling, bandwidth, ``_lognorm``) and
  ``sample``: equal bits (the same numpy arithmetic); ``logp``: 1e-12
  relative (torch's and XLA's logsumexp sum in different orders);
  ``_prior_log_norm``: 1e-10 absolute (a 4097-node trapezoid of either);
- the host sampler and the host path of ``spectrum_mcmc``: equal bits
  (numpy on both sides);
- the SED half-step under the JAX step's draws, and five steps of K10's
  run form under the JAX scan's (op by op): new states equal, new
  log-posteriors within 1e-12 relative;
- ``calculate_bolometric``: ``MJD``, ``npoints`` and the filters equal;
  the least-squares columns within rtol 1e-6 (curve_fit stops at its own
  tolerance, so the last bits of the two packages' ``planck_fast`` move
  its optimum by ~1e-9 relative, measured; the single-filter epoch's
  least squares starts from the previous chain's medians, so it is held
  to the port's own solve from the JAX package's medians); the MCMC
  medians within 1 sigma (the JAX run's half-width) and the width ratios
  within (0.6, 1.7), the stage-1 criteria of ``dryrun_multichip``
  (``__graft_entry__.py``), the random streams of the packages differing.

``jax_sequential_bolometric`` and ``jax_sed_acceptance`` (not collected)
compute the JAX package's float64 CPU references of ``chip_smoke.py``
phases 13c and 13d: ``PYTHONPATH=. python tests/test_torch_sed.py``
writes them to ``tests/jax_sequential_bolometric.json`` (~12 min).
"""

import os
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from lightcurve_fitting_tpu import bolometric as jbol  # noqa: E402
from lightcurve_fitting_tpu import fitting as jfit  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import (GaussianPrior as JG, KDEPrior as JK,  # noqa: E402
                                           LogUniformPrior as JLU, UniformPrior as JU)
from lightcurve_fitting_tpu.parallel.host_sampler import (  # noqa: E402
    HostEnsembleSampler as JHost)
from lightcurve_fitting_tpu.parallel.sampler import make_stretch_kernel  # noqa: E402

from lightcurve_fitting_tpu_torch import bolometric as tbol, fitting as tfit  # noqa: E402
from lightcurve_fitting_tpu_torch import interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import common, sed  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import KDEPrior as TK  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.host_sampler import (  # noqa: E402
    HostEnsembleSampler as THost)

from test_torch_native import jax_native_loaded  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
Z = 0.002
# MJD 57482-57488: epochs of 5 (BIRUV) and 6 (BUVgir) filters, then one of U
# alone (the first KDE-chained epoch of the full curve)
CHAIN_WINDOW = (57482.0, 57488.0)
# MJD 57468-57471: two U-only epochs (no sampler before them: skipped), then
# the 9-filter epoch
CUT0_WINDOW = (57468.0, 57471.0)
REFERENCE_FILE = os.path.join(os.path.dirname(__file__), "jax_sequential_bolometric.json")


def _lc(LC, window=None):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    return lc if window is None else lc.where(MJD_min=window[0], MJD_max=window[1])


def _groups(LC, mod, window):
    lc = _lc(LC, window)
    finite = np.isfinite(np.ma.filled(np.ma.MaskedArray(lc["dmag"]).astype(float), np.nan))
    lc = lc[finite & np.ma.filled(np.ma.MaskedArray(lc["dmag"]) > 0.0, False)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod._prepare_epoch_seds(lc, 1.0, ())


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's binning on its native path, as the port's
    (test_torch_native.jax_native_loaded)."""
    jax_native_loaded()


@pytest.fixture(scope="module")
def epochs():
    """The three epochs of CHAIN_WINDOW (8, 6 and 1 points), in both packages."""
    return _groups(JLC, jbol, CHAIN_WINDOW), _groups(TLC, tbol, CHAIN_WINDOW)


def _kde_samples(n=2000, seed=4):
    return np.random.default_rng(seed).normal(10.7, 0.12, size=n)


def _jpriors(kind, use_sigma):
    first = JK(_kde_samples()) if kind == "kde" else JU(1.0, 100.0)
    return [first, JLU(0.01, 1000.0)] + ([JG(0.0, 10.0)] if use_sigma else [])


def _states(rng, ndim, W=64):
    """W states around the epoch's posterior; one (1.6%) outside the priors."""
    p = np.abs(rng.normal([10.0, 4.0, 1.0][:ndim], [2.0, 1.0, 0.5][:ndim], size=(W, ndim)))
    p[7, 1] = -0.5                      # R outside the log-uniform prior
    return p


def _term_scale(lp, p):
    return lp.term_scales(torch.as_tensor(p)).numpy()


# ------------------------------------------------------- the SED log-posterior

@pytest.mark.parametrize("cutoff", [np.inf, 800.0], ids=["no-cutoff", "cutoff"])
@pytest.mark.parametrize("use_sigma,sigma_type", [(False, "relative"), (True, "relative"),
                                                  (True, "absolute")],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
@pytest.mark.parametrize("ebv", [0.0, 0.1], ids=["table", "quadrature"])
def test_sed_log_posterior_matches_jax(epochs, ebv, use_sigma, sigma_type, cutoff):
    gj, gt = epochs
    rng = np.random.default_rng(11)
    for kind in ("default", "kde"):
        jpri = _jpriors(kind, use_sigma)
        tpri = interop.priors_from_jax(jpri)
        for e in (0, 2):
            sk = {} if np.isinf(cutoff) else {"cutoff_freq": cutoff}
            lpj = jbol._make_sed_log_posterior(jbol.planck_fast, gj[e], jpri, Z, ebv, sk,
                                               use_sigma, sigma_type)
            lpt = tbol.SEDLogPosterior(gt[e], tpri, Z, ebv, sk, use_sigma,
                                       sigma_type, device="cpu")
            assert lpt.form == ("table" if ebv == 0 else "quadrature")
            p = _states(rng, len(tpri))
            want = np.asarray(jax.vmap(lpj)(jnp.asarray(p)))
            got = lpt.forward_plain(torch.as_tensor(p)).numpy()
            assert np.array_equal(np.isneginf(got), np.isneginf(want))
            assert np.isneginf(got[7]) and np.isfinite(got).sum() == 63
            fin = np.isfinite(want)
            err = np.abs(got[fin] - want[fin]) / _term_scale(lpt, p)[fin]
            assert err.max() <= 1e-12, (kind, e, err.max())
            # __call__ on the CPU is the plain version
            assert np.array_equal(lpt(torch.as_tensor(p)).numpy(), got, equal_nan=True)


@pytest.mark.parametrize("use_sigma", [False, True], ids=["no-sigma", "sigma"])
def test_sed_log_posterior_f32_compute_within_budget(epochs, use_sigma):
    """The card's default: the band table in float32, the rest float64, in
    both packages (the JAX package's accelerator compute dtype)."""
    gj, gt = epochs
    rng = np.random.default_rng(12)
    jpri = _jpriors("kde", use_sigma)
    try:
        jconfig.set_compute_dtype(jnp.float32)
        config.set_compute_dtype(torch.float32)
        for e in range(3):
            lpj = jbol._make_sed_log_posterior(jbol.planck_fast, gj[e], jpri, Z, 0.0, {},
                                               use_sigma, "relative")
            lpt = tbol.SEDLogPosterior(gt[e], interop.priors_from_jax(jpri),
                                       Z, 0.0, {}, use_sigma, "relative", device="cpu")
            assert lpt.coef.dtype == torch.float32
            p = _states(rng, len(jpri))
            want = np.asarray(jax.vmap(lpj)(jnp.asarray(p)))
            got = lpt.forward_plain(torch.as_tensor(p)).numpy()
            assert np.array_equal(np.isneginf(got), np.isneginf(want))
            fin = np.isfinite(want)
            err = np.abs(got[fin] - want[fin]) / _term_scale(lpt, p)[fin]
            assert err.max() <= 1e-5, (e, err.max())
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        config.set_compute_dtype(config.AUTO)


def test_kernel_routing_by_kernel_module(epochs):
    """``kernels`` routes a log-posterior by its ``kernel_module``: K10's
    module for an SEDLogPosterior, the model's for a LogPosterior; on the
    CPU both run their plain versions through the same entry points."""
    _, gt = epochs
    pri = interop.priors_from_jax(_jpriors("default", False))
    lp = tbol.SEDLogPosterior(gt[0], pri, Z, device="cpu")
    assert kernels.module_of(lp) is sed
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, UniformPrior
    lc = _lc(TLC, (57468.0, 57485.0))
    lc.calcAbsMag()
    lc.calcLum()
    model_lp = tfit.make_log_posterior(ShockCooling2(lc), lc,
                                       [UniformPrior(0.0, 100.0)] * 3
                                       + [UniformPrior(57468.0, 57468.7)], device="cpu")
    assert kernels.module_of(model_lp) is kernels.sc2
    q = torch.as_tensor(_states(np.random.default_rng(5), 2))
    assert torch.equal(kernels.log_posterior(lp, q), lp.forward_plain(q))
    assert torch.equal(lp(q), lp.forward_plain(q))


# ------------------------------------------------------------------ KDEPrior

@pytest.mark.parametrize("n", [100, 2000], ids=["all-components", "subsampled"])
def test_kde_prior_matches_jax(n):
    samples = _kde_samples(n)
    jk, tk = JK(samples), TK(samples)
    assert np.array_equal(np.asarray(jk.samples), tk.samples)
    assert len(tk.samples) == min(n, 512)
    assert tk.bandwidth == jk.bandwidth and tk._lognorm == jk._lognorm
    assert (tk.p_min, tk.p_max) == (-np.inf, np.inf)
    x = np.concatenate([np.linspace(9.5, 12.0, 97), [-1e3, 0.0, 1e200]])
    want = np.asarray(jax.vmap(jk.logp)(jnp.asarray(x)))
    got = tk.logp(torch.as_tensor(x)).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and not fin[-1]
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)
    # the masked __call__ (no bounds: -inf only where the density is 0)
    np.testing.assert_allclose(tk(torch.as_tensor(x[:97])).numpy(),
                               np.asarray(jax.vmap(jk)(jnp.asarray(x[:97]))), rtol=1e-12)
    s_t = tk.sample(np.random.default_rng(3), size=(64,))
    s_j = jk.sample(np.random.default_rng(3), size=(64,))
    assert np.array_equal(s_t, s_j)
    assert tfit._prior_log_norm(tk) == pytest.approx(jfit._prior_log_norm(jk), abs=1e-10)
    # interop copies the components, bandwidth and normalization as they are
    back, = interop.priors_from_jax([jk])
    assert isinstance(back, TK) and np.array_equal(back.samples, tk.samples)
    assert back.bandwidth == tk.bandwidth and back._lognorm == tk._lognorm
    assert torch.equal(back.logp(torch.as_tensor(x)), tk.logp(torch.as_tensor(x)))
    assert back.kernel_spec() == tk.kernel_spec() == (3, -np.inf, np.inf, 0.0, tk.bandwidth)


def test_kde_kind_refused_outside_k10():
    """The model kernels' parameter blocks and the gradient drivers refuse a
    KDE prior (kind 3) and name ROADMAP item 21; K10's block takes it."""
    kde = TK(_kde_samples(300))

    class Block:
        prior_kind, p_min, p_max, mean, stddev = ([0] * 9 for _ in range(5))

    with pytest.raises(NotImplementedError, match="item 21"):
        common.fill_priors_and_affine(Block(), [kde], None)
    lc = _lc(TLC, (57468.0, 57485.0))
    lc.calcAbsMag()
    lc.calcLum()
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, UniformPrior
    priors = [kde, UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
              UniformPrior(57468.0, 57468.7)]
    with pytest.raises(NotImplementedError, match="item 21"):
        tfit.lightcurve_map(lc, ShockCooling2(lc), priors, n_starts=2, n_iter=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 21"):
        tfit.lightcurve_hmc(lc, ShockCooling2(lc), priors, nchains=2, nsamples=2, n_warmup=2,
                            device="cpu")
    assert sed.kde_prior_of([kde, UniformPrior(0.0, 1.0)]) is kde
    with pytest.raises(NotImplementedError, match="at most one"):
        sed.kde_prior_of([kde, kde])


def test_k10_param_block_layout_matches_the_c_struct():
    """Every field of struct SEDParams (csrc/sed.cu) is 8 bytes wide: its
    ctypes mirror has the same fields in the same order."""
    import ctypes
    path = os.path.join(os.path.dirname(sed.__file__), "csrc", "sed.cu")
    with open(path) as f:
        src = f.read()
    body = src[src.index("struct SEDParams {"):src.index("};", src.index("struct SEDParams {"))]
    fields = [ln.split(";")[0].split()[-1].split("[")[0].lstrip("*")
              for ln in body.splitlines()[1:] if ";" in ln]
    assert fields == [name for name, _ in sed._SEDParams._fields_]
    assert ctypes.sizeof(sed._SEDParams) == 8 * (7 + 6 + 4) + 7 * 9 * 8


# --------------------------------------------------- samplers: host and K10

def test_host_sampler_is_the_jax_packages_bit_for_bit():
    def log_prob(p):
        return -0.5 * float(np.sum((p - 1.0) ** 2 / np.array([0.5, 2.0, 1.0]) ** 2))

    x0 = np.random.default_rng(1).normal(size=(8, 3))
    out = []
    for cls in (JHost, THost):
        s = cls(8, 3, log_prob, seed=5)
        pos, lp, _ = s.run_mcmc(x0, 40)
        s.run_mcmc(None, 10)
        out.append((pos, lp, s.flatchain, s.chain, s.acceptance_fraction))
    for a, b in zip(*out):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="no previous state"):
        THost(8, 3, log_prob).run_mcmc(None, 1)


def test_sed_half_step_matches_jax_under_shared_draws(epochs):
    """One step (both halves) of the SED ensemble under a KDE prior, from the
    JAX step's draws: the new states equal the JAX step's and the new
    log-posteriors agree to float64 rounding."""
    gj, gt = epochs
    half, ndim = 16, 2
    jpri = _jpriors("kde", False)
    lpj = jbol._make_sed_log_posterior(jbol.planck_fast, gj[2], jpri, Z, 0.0, {}, False,
                                       "relative")
    lpt = tbol.SEDLogPosterior(gt[2], interop.priors_from_jax(jpri), Z, 0.0,
                               {}, False, "relative", device="cpu")
    rng = np.random.default_rng(7)
    x0 = np.abs(np.array([10.7, 3.6]) * (1 + 0.02 * rng.normal(size=(2, half, ndim))))
    step, batched = make_stretch_kernel(lpj, half, ndim)
    key = jr.PRNGKey(11)
    xj = jnp.asarray(x0)
    (x_want, lp_want), _ = jax.jit(step)((xj, batched(xj.reshape(-1, ndim)).reshape(2, half)),
                                         key)
    draws = {k: np.empty((2, half)) for k in ("u_z", "u_acc")}
    draws["j"] = np.empty((2, half), np.int64)
    for h, kh in enumerate(jr.split(key)):              # the draws half_update makes
        kz, kj, ku = jr.split(kh, 3)
        draws["u_z"][h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
        draws["j"][h] = np.asarray(jr.randint(kj, (half,), 0, half))
        draws["u_acc"][h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    x = torch.as_tensor(x0).contiguous()
    logp = lpt.forward_plain(x.reshape(-1, ndim)).reshape(2, half)
    n_acc = torch.zeros((2, half), dtype=torch.int32)
    cx, cl = torch.empty_like(x), torch.empty_like(logp)
    u_z, j, u_acc = (torch.as_tensor(draws[k]) for k in ("u_z", "j", "u_acc"))
    before = dict(kernels.LAUNCHES)
    for h in (0, 1):
        kernels.stretch_half_step(lpt, x, logp, h, u_z[h], j[h], u_acc[h], 2.0, None, None, cx,
                                  cl, n_acc)
    assert kernels.LAUNCHES == before                    # the CPU runs the plain version
    assert 0 < int(n_acc.sum()) < 2 * half
    assert np.array_equal(x.numpy(), np.asarray(x_want))
    np.testing.assert_allclose(logp.numpy(), np.asarray(lp_want), rtol=1e-12, atol=0.0)
    assert torch.equal(cx, x) and torch.equal(cl, logp)


@pytest.mark.parametrize("kind", ["default", "kde"])
def test_sed_run_matches_jax_scan_under_shared_draws(epochs, kind):
    """Five steps of K10's run form (its plain version on the CPU, one call
    over the stacked draws) against the JAX package's ``lax.scan`` of
    ``make_stretch_kernel``'s step over the same log-posterior, run op by
    op, from the JAX steps' draws: the states equal, the log-posteriors
    within 1e-12 relative, every stored step's chain the scan's. (Compiled,
    XLA may fuse the proposal's multiply and add into one rounding: a last
    bit of a state, measured once in the 5 x 32 proposals here.)"""
    gj, gt = epochs
    half, ndim, n = 16, 2, 5
    e = 2 if kind == "kde" else 0
    jpri = _jpriors(kind, False)
    lpj = jbol._make_sed_log_posterior(jbol.planck_fast, gj[e], jpri, Z, 0.0, {}, False,
                                       "relative")
    lpt = tbol.SEDLogPosterior(gt[e], interop.priors_from_jax(jpri), Z, 0.0,
                               {}, False, "relative", device="cpu")
    rng = np.random.default_rng(8)
    centre = [10.7, 3.6] if kind == "kde" else [13.0, 2.9]
    x0 = np.abs(np.array(centre) * (1 + 0.02 * rng.normal(size=(2, half, ndim))))
    step, batched = make_stretch_kernel(lpj, half, ndim)
    keys = jr.split(jr.PRNGKey(12), n)
    xj = jnp.asarray(x0)
    with jax.disable_jit():     # op by op: XLA fusing a compiled scan's body may contract
        (x_want, lp_want), (xs_want, lps_want, _) = jax.lax.scan(    # the proposal's mul-add
            step, (xj, batched(xj.reshape(-1, ndim)).reshape(2, half)), keys)
    u_z, u_acc = np.empty((n, 2, half)), np.empty((n, 2, half))
    j = np.empty((n, 2, half), np.int64)
    for s in range(n):
        for h, kh in enumerate(jr.split(keys[s])):       # the draws half_update makes
            kz, kj, ku = jr.split(kh, 3)
            u_z[s, h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
            j[s, h] = np.asarray(jr.randint(kj, (half,), 0, half))
            u_acc[s, h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    x = torch.as_tensor(x0).contiguous()
    logp = lpt.forward_plain(x.reshape(-1, ndim)).reshape(2, half)
    n_acc = torch.zeros((2, half), dtype=torch.int32)
    cx = torch.empty((n, 2, half, ndim), dtype=torch.float64)
    cl = torch.empty((n, 2, half), dtype=torch.float64)
    before = dict(kernels.LAUNCHES)
    kernels.stretch_run(lpt, x, logp, *(torch.as_tensor(d) for d in (u_z, j, u_acc)), 2.0,
                        None, None, cx, cl, n_acc)
    assert kernels.LAUNCHES == before                    # the CPU runs the plain version
    assert 0 < int(n_acc.sum()) < 2 * half * n
    assert np.array_equal(x.numpy(), np.asarray(x_want))
    assert np.array_equal(cx.numpy(), np.asarray(xs_want))
    np.testing.assert_allclose(logp.numpy(), np.asarray(lp_want), rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(cl.numpy(), np.asarray(lps_want), rtol=1e-12, atol=0.0)


# ------------------------------------------------------------- spectrum_mcmc

def _host_spectrum(nu, T, R):
    """A spectrum the JAX package cannot trace (``np.asarray`` of its input):
    a blackbody through numpy."""
    nu = np.asarray(nu, float)
    return np.asarray(jbol.planck_fast(nu, float(T), float(R)))


def test_spectrum_mcmc_host_path_matches_jax(epochs, tmp_path):
    gj, gt = epochs
    guesses = np.abs(np.random.default_rng(2).normal([10.0, 3.5], 0.3, size=(5, 2)))
    kw = dict(nwalkers=5, burnin_steps=3, steps=4, seed=9, make_corner=False, z=Z,
              save_chains=True)
    with pytest.warns(UserWarning, match="falling back to the host sampler"):
        s_j = jbol.spectrum_mcmc(_host_spectrum, gj[1], _jpriors("default", False), guesses,
                                 outpath=str(tmp_path / "j"), **kw)
    with pytest.warns(UserWarning, match="falling back to the host sampler"):
        s_t = tbol.spectrum_mcmc(_host_spectrum, gt[1],
                                 interop.priors_from_jax(_jpriors("default", False)), guesses,
                                 outpath=str(tmp_path / "t"), device="cpu", **kw)
    assert isinstance(s_t, THost) and s_t.nwalkers == 6   # the odd count padded
    assert np.array_equal(s_t.flatchain, s_j.flatchain)
    assert np.array_equal(s_t.acceptance_fraction, s_j.acceptance_fraction)
    name = os.listdir(tmp_path / "t")
    assert name == os.listdir(tmp_path / "j") and len(name) == 1
    assert np.array_equal(np.load(tmp_path / "t" / name[0]), s_t.flatchain)


def test_spectrum_mcmc_device_path_and_refusals(epochs, tmp_path):
    _, gt = epochs
    pri = interop.priors_from_jax(_jpriors("default", False))
    guesses = np.abs(np.random.default_rng(3).normal([13.0, 2.9], 0.3, size=(8, 2)))
    for kw in (dict(make_corner=True), dict(make_corner=False, show=True)):
        with pytest.raises(NotImplementedError, match="item 18"):
            tbol.spectrum_mcmc(tbol.planck_fast, gt[0], pri, guesses, device="cpu", **kw)
    before = dict(kernels.LAUNCHES)
    s = tbol.spectrum_mcmc(tbol.planck_fast, gt[0], pri, guesses, z=Z, nwalkers=8,
                           burnin_steps=20, steps=30, seed=4, make_corner=False, device="cpu",
                           outpath=str(tmp_path))
    assert kernels.LAUNCHES == before
    assert isinstance(s._log_prob_fn, tbol.SEDLogPosterior) and s.flatchain.shape == (240, 2)
    assert np.isfinite(s.flatchain).all() and 0.1 < s.acceptance_fraction.mean() < 0.9
    # the same seed gives the same chain; the production run continues the
    # burn-in's state as run_mcmc(pos) would
    s2 = tbol.spectrum_mcmc(tbol.planck_fast, gt[0], pri, guesses, z=Z, nwalkers=8,
                            burnin_steps=20, steps=30, seed=4, make_corner=False, device="cpu",
                            outpath=str(tmp_path))
    assert np.array_equal(s.flatchain, s2.flatchain)
    # a reddened planck_fast has no CUDA kernel yet (item 20)
    lp = tbol.SEDLogPosterior(gt[0], pri, Z, 0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        sed._require_table(lp, torch.device("cpu"))


# ------------------------------------------------------ calculate_bolometric

RUN = dict(res=1.0, nwalkers=32, burnin_steps=200, steps=300, seed=7, save_corners=False,
           min_nfilt=1, colors=["B-V"])


class _SpyKDE(TK):
    made = []

    def __init__(self, samples, *args, **kwargs):
        super().__init__(samples, *args, **kwargs)
        _SpyKDE.made.append(np.asarray(samples, float).copy())


@pytest.fixture(scope="module")
def sequential_tables(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_j = jbol.calculate_bolometric(_lc(JLC, CHAIN_WINDOW), mesh=False, batch_mode=False,
                                        outpath=str(out), **RUN)
        _SpyKDE.made.clear()
        mp = pytest.MonkeyPatch()
        mp.setattr(tbol, "KDEPrior", _SpyKDE)
        try:
            before = dict(kernels.LAUNCHES)
            t_t = tbol.calculate_bolometric(_lc(TLC, CHAIN_WINDOW), device="cpu",
                                            outpath=str(out), batch_mode=False, **RUN)
            assert kernels.LAUNCHES == before             # the CPU runs the plain versions
        finally:
            mp.undo()
    return t_j, t_t, list(_SpyKDE.made)


def _col(t, name):
    return np.ma.filled(np.ma.MaskedArray(t[name]).astype(float), np.nan)


def test_calculate_bolometric_sequential_matches_jax(sequential_tables, epochs):
    t_j, t_t, kde_made = sequential_tables
    assert len(t_t) == len(t_j) == 3 and t_t.colnames == t_j.colnames
    assert list(np.asarray(t_t["filts"])) == list(np.asarray(t_j["filts"]))
    for c in ("MJD", "dMJD0", "dMJD1", "npoints", "L_int", "B-V"):
        np.testing.assert_allclose(_col(t_t, c), _col(t_j, c), rtol=1e-12, equal_nan=True)
    assert list(_col(t_t, "npoints")) == [5, 6, 1]
    lstsq = ("temp", "radius", "dtemp", "dradius", "L_bol", "dL_bol", "L")
    for c in lstsq:
        np.testing.assert_allclose(_col(t_t, c)[:2], _col(t_j, c)[:2], rtol=1e-6)
    # KDE chaining took place: one KDE prior, of the previous epoch's chain
    # temperatures (its 32 x 300 samples), and the single-filter epoch's least
    # squares started from that chain's medians (the JAX run's, here: the port's
    # own solve from them gives the JAX row)
    assert len(kde_made) == 1 and kde_made[0].shape == (RUN["nwalkers"] * RUN["steps"],)
    assert np.median(kde_made[0]) == pytest.approx(_col(t_t, "temp_mcmc")[1], rel=1e-12)
    _, gt = epochs
    p0 = [_col(t_j, "temp_mcmc")[1], _col(t_j, "radius_mcmc")[1]]
    mine = tbol.blackbody_lstsq(gt[2], Z, p0, (-np.inf, np.inf), (0.01, 1000.0))
    np.testing.assert_allclose(mine, [_col(t_j, c)[2] for c in lstsq], rtol=1e-6)
    assert np.isinf(_col(t_j, "dtemp")[2]) == np.isinf(_col(t_t, "dtemp")[2])
    for c in ("temp", "radius"):
        a, b = _col(t_j, f"{c}_mcmc"), _col(t_t, f"{c}_mcmc")
        wa = (_col(t_j, f"d{c}_mcmc0") + _col(t_j, f"d{c}_mcmc1")) / 2
        wb = (_col(t_t, f"d{c}_mcmc0") + _col(t_t, f"d{c}_mcmc1")) / 2
        assert np.all(np.abs(a - b) < wa), (c, a, b, wa)
        assert np.all((0.6 < wb / wa) & (wb / wa < 1.7)), (c, wb / wa)
    for c in ("L_mcmc", "L_bol_mcmc"):
        assert np.isfinite(_col(t_t, c)).all()


def test_batch_mode_chain_cut(monkeypatch, tmp_path):
    """batch_mode=True with min_nfilt=1: where the first epoch is a
    single-filter one (the cut at 0) nothing batches and the table is
    bit-equal to batch_mode=False; where it falls later, the epochs before it
    batch and the single-filter epoch chains from the batched chain."""
    kw = dict(res=1.0, nwalkers=10, burnin_steps=20, steps=30, seed=3, save_corners=False,
              min_nfilt=1, device="cpu", outpath=str(tmp_path))
    from lightcurve_fitting_tpu_torch.parallel import batched
    packed = []
    real_pack = batched.pack_epochs
    monkeypatch.setattr(batched, "pack_epochs",
                        lambda groups, *a, **k: packed.append(len(groups)) or
                        real_pack(groups, *a, **k))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        seq = tbol.calculate_bolometric(_lc(TLC, CUT0_WINDOW), batch_mode=False, **kw)
        bat = tbol.calculate_bolometric(_lc(TLC, CUT0_WINDOW), batch_mode=True, **kw)
        assert packed == [] and len(seq) == 1
        for c in seq.colnames:
            assert np.array_equal(np.asarray(seq[c]), np.asarray(bat[c])), c
        _SpyKDE.made.clear()
        monkeypatch.setattr(tbol, "KDEPrior", _SpyKDE)
        later = tbol.calculate_bolometric(_lc(TLC, CHAIN_WINDOW), batch_mode=True, **kw)
    assert packed == [2] and len(later) == 3
    assert len(_SpyKDE.made) == 1 and _SpyKDE.made[0].shape == (10 * 30,)
    assert np.isfinite(_col(later, "temp_mcmc")).all()


def test_refusals_left(tmp_path):
    for kwargs, match in ((dict(), "item 18"), (dict(save_corners=False, show=True), "item 18"),
                          (dict(save_corners=False, mesh=object()), "item 17")):
        with pytest.raises(NotImplementedError, match=match):
            tbol.calculate_bolometric(_lc(TLC, CUT0_WINDOW), device="cpu", **kwargs)


# ------------------------------------- references of chip_smoke.py 13c, 13d

BOL_SEQ_SEED = 7
SED_SEEDS = tuple(range(1, 9))
SED_WALKERS, SED_BURNIN, SED_STEPS = 64, 300, 300


def sed_acceptance_epochs(LC, mod, KDE):
    """The two epochs of ``chip_smoke.py`` 13d with their priors and starting
    centers, built by either package (``mod``: its ``bolometric``): SN
    2016bkv's 9-filter epoch (MJD 57470.4) under the default priors, started
    at its least-squares solution; and the single-filter epoch of MJD
    57487.1 (U) under a KDE temperature prior of fixed samples
    (``_kde_samples()``), started at (10.7, 3.6)."""
    groups = _groups(LC, mod, None)
    nine = next(g for g in groups if len(set(g.where(nondet=False)["filter"])) == 9)
    single = next(g for g in groups
                  if abs(float(np.median(np.asarray(g["MJD"], float))) - 57487.1) < 0.5)
    pri_nine = [mod.UniformPrior(1.0, 100.0), mod.LogUniformPrior(0.01, 1000.0)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        center = np.array(mod.blackbody_lstsq(nine, Z, [10.0, 10.0], (1.0, 100.0),
                                              (0.01, 1000.0))[:2])
    pri_single = [KDE(_kde_samples()), mod.LogUniformPrior(0.01, 1000.0)]
    return [(nine, pri_nine, center), (single, pri_single, np.array([10.7, 3.6]))]


def jax_sed_acceptance(seeds=SED_SEEDS):
    """The JAX package's mean stretch acceptance, float64 on the CPU, of
    ``spectrum_mcmc(planck_fast)`` at 64 walkers x 300 + 300 steps on the
    two epochs of :func:`sed_acceptance_epochs`, at each seed (starting
    guesses ``default_rng(seed).normal(size=(64, 2)) + center``)."""
    out = {}
    for name, (ep, pri, center) in zip(("nine", "single"),
                                       sed_acceptance_epochs(JLC, jbol, JK)):
        acc = []
        for seed in seeds:
            guesses = np.random.default_rng(seed).normal(size=(SED_WALKERS, 2)) + center
            guesses[guesses <= 0.0] = 1.0
            s = jbol.spectrum_mcmc(jbol.planck_fast, ep, pri, guesses, z=Z,
                                   nwalkers=SED_WALKERS, burnin_steps=SED_BURNIN,
                                   steps=SED_STEPS, seed=seed, make_corner=False)
            acc.append(float(np.mean(s.acceptance_fraction)))
        out[name] = acc
    return out


def jax_sequential_bolometric():
    """The JAX package's ``calculate_bolometric(batch_mode=False,
    save_corners=False)`` on the full SN 2016bkv light curve, float64 on the
    CPU, at seed 7: at the defaults (65 rows) and at ``min_nfilt=1`` (77
    rows), the columns MJD, npoints, temp, radius and the MCMC medians and
    half-widths of T and R that ``chip_smoke.py`` 13c holds the card's run
    to; and at ``min_nfilt=1`` the MCMC columns at seeds 8 and 9, whose
    spread over seeds 7-9 is the reference's own scatter downstream of the
    KDE chaining (every epoch after the first single-filter one fits under
    a KDE prior of an earlier chain). About 8 min on one core."""
    cols = ("MJD", "npoints", "temp", "radius", "temp_mcmc", "dtemp_mcmc0", "dtemp_mcmc1",
            "radius_mcmc", "dradius_mcmc0", "dradius_mcmc1")
    mcmc = ("MJD",) + cols[4:]

    def run(seed, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return jbol.calculate_bolometric(_lc(JLC), batch_mode=False, save_corners=False,
                                             seed=seed, mesh=False, outpath=".", **kw)

    out = {}
    for label, kw in (("defaults", {}), ("min_nfilt_1", {"min_nfilt": 1})):
        t = run(BOL_SEQ_SEED, **kw)
        out[label] = {c: [float(v) for v in _col(t, c)] for c in cols}
    out["min_nfilt_1_seeds"] = {}
    for seed in (8, 9):
        t = run(seed, min_nfilt=1)
        out["min_nfilt_1_seeds"][str(seed)] = {c: [float(v) for v in _col(t, c)] for c in mcmc}
    return out


if __name__ == "__main__":
    import contextlib
    import io
    import json
    import time
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jconfig.set_compute_dtype(None)
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        ref = {"run": "the JAX package's float64 CPU run, tests/test_torch_sed.py "
                      "(jax_sequential_bolometric, jax_sed_acceptance)",
               "sequential": jax_sequential_bolometric(),
               "acceptance": jax_sed_acceptance()}
    with open(REFERENCE_FILE, "w") as f:
        json.dump(ref, f, indent=1)
    for k, v in ref["acceptance"].items():
        print(k, np.mean(v), np.std(v, ddof=1) / np.sqrt(len(v)))
    print(f"wrote {REFERENCE_FILE} in {time.time() - t0:.1f} s")
