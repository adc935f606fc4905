"""ShockCooling (SW17 in physical parameters) and ShockCooling4 (MSW23) of
the port against the JAX package, on the CPU: the models (evaluate in
pointwise and outer mode, temperature_radius, t_min, t_max, clone_for) at
n = 1.5 and 3, RW and kappa = 0.7; the batched log-posterior through
``make_log_posterior`` on SN 2016bkv's early curve, with t < t_0 and the
intrinsic scatter; one stretch half-step and one tempered-ladder step (K6a,
K6b) under the JAX package's own draws; the routing to the kernel modules,
the form rules of the half-steps, K6a, the batch log-posterior and K6b and
the form argument their wrappers hand the C launch (a stub library); and
``interop.model_from_jax`` for every model class.

Inputs are made from a seed with numpy and go through both packages.
Tolerances: float64 <= 1e-12 relative per point, <= 1e-10 |ll| for summed
log-likelihoods (the reduction order over 149 points differs); float32,
both packages under their float32 compute dtype, <= 1e-5 (|ll - c| + |c|),
the repo's float32 log-likelihood budget, with c the normalization constant
added to the residual sum in float32; identical -inf sets.

The helpers at the end compute the JAX package's float64 CPU references of
``chip_smoke.py`` phase 26: ``PYTHONPATH=. python tests/test_torch_shock_cooling.py``.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from lightcurve_fitting_tpu import filters as jfilters, models as jmodels  # noqa: E402
from lightcurve_fitting_tpu import fitting as jfit  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import LogUniformPrior as JLU, UniformPrior as JU  # noqa: E402
from lightcurve_fitting_tpu.parallel import evidence as jev, sampler as jsampler  # noqa: E402

from lightcurve_fitting_tpu_torch import filters as tfilters, interop, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch import fitting as tfit, models as tmodels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import common, ladder, sc, sc4  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
# examples/compare_models.py's shared priors and window (SW17 and MSW23 share
# the physical parameters v_s*, M_env, f_rho M, R, t_0)
PRIORS = [JU(0.1, 20.0), JU(0.1, 30.0), JLU(0.01, 100.0), JU(0.01, 50.0),
          JU(57468.0, 57468.7)]
P_LO = np.array([0.5, 0.5, 0.1, 0.1, 57468.3])
P_UP = np.array([10.0, 20.0, 10.0, 20.0, 57468.7])
CONFIGS = [("ShockCooling", {}), ("ShockCooling", {"n": 3.0}), ("ShockCooling", {"RW": True}),
           ("ShockCooling", {"kappa": 0.7}), ("ShockCooling4", {}),
           ("ShockCooling4", {"kappa": 0.7})]
CONFIG_IDS = ["sc", "sc-n3", "sc-rw", "sc-kappa", "sc4", "sc4-kappa"]


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def lcs():
    return _early(JLC), _early(TLC)


def _models(name, kw, jlc=None, tlc=None):
    return getattr(jmodels, name)(jlc, **kw), getattr(tmodels, name)(tlc, **kw)


def _batch(seed=0, n=48):
    """n walkers from the init window, 5 outside the priors and a NaN, and 8
    with t_0 after the first points (t < t_0 there; inside a prior widened
    to t_0 < 57480)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(P_LO, P_UP, size=(n, 5))
    bad = p[:6].copy()
    bad[np.arange(6), [0, 1, 2, 3, 4, 3]] = [-0.1, 31.0, 200.0, 60.0, 57467.5, np.nan]
    late = rng.uniform(P_LO, P_UP, size=(8, 5))
    late[:, 4] = rng.uniform(57468.8, 57472.0, 8)
    return np.concatenate([p, bad, late])


def _late_priors(use_sigma):
    return PRIORS[:4] + [JU(57468.0, 57480.0)] + ([JLU(0.01, 10.0)] if use_sigma else [])


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("name,kw", CONFIGS, ids=CONFIG_IDS)
def test_evaluate_temperature_radius_and_window(lcs, name, kw):
    jlc, tlc = lcs
    jm, tm = _models(name, kw, jlc, tlc)
    t = np.asarray(tlc["MJD"], float)
    f, jf = np.asarray(tlc["filter"]), np.asarray(jlc["filter"])
    p = tuple(_batch(1)[3])
    for extra in ({}, {"kappa": 1.3}):
        np.testing.assert_allclose(tm.evaluate(t[:30], f[:30], *p, **extra),
                                   jm.evaluate(t[:30], jf[:30], *p, **extra), rtol=1e-12, atol=0)
    y = tm.evaluate(t, f, *p)
    assert np.all(y[t < p[4]] == 0) and np.all(y[t > p[4] + 0.1] > 0)
    jb = [jfilters.filtdict[n] for n in ("g", "r", "B")]
    tb = [tfilters.filtdict[n] for n in ("g", "r", "B")]
    tgrid = np.linspace(57468.0, 57480.0, 6)
    a, b = jm.evaluate(tgrid, jb, *p), tm.evaluate(tgrid, tb, *p)
    assert b.shape == (3, 6)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    vec = (np.array([0.8, 3.0]), 2.0, np.array([0.5, 5.0]), 4.0, 57468.4)
    a, b = jm.evaluate(tgrid, jb, *vec), tm.evaluate(tgrid, tb, *vec)
    assert b.shape == (3, 6, 2)
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    tt = np.linspace(-0.5, 12.0, 9)
    for args in [p[:4], vec[:4]]:
        for extra in ({}, {"t_exp": 0.3, "kappa": 1.2}):
            for x, w in zip(tm.temperature_radius(tt, *args, **extra),
                            jm.temperature_radius(tt, *args, **extra)):
                np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    for extra in ({}, {"kappa": 1.4}):
        assert tm.t_min(p, **extra) == pytest.approx(jm.t_min(p, **extra), rel=1e-15)
        assert tm.t_max(p, **extra) == pytest.approx(jm.t_max(p, **extra), rel=1e-15)
    assert tm.t_max(p[:4]) == pytest.approx(jm.t_max(p[:4]), rel=1e-15)


@pytest.mark.parametrize("name,kw", CONFIGS, ids=CONFIG_IDS)
def test_clone_for_keeps_the_physics(lcs, name, kw):
    jlc, tlc = lcs
    jm, tm = _models(name, kw, jlc, tlc)
    tm.z = 0.0                                     # z = 0 survives, as in the JAX package
    jm.z = 0.0
    sub_t = tlc.where(MJD_min=57470.0)
    sub_j = jlc.where(MJD_min=57470.0)
    tc, jc = tm.clone_for(sub_t), jm.clone_for(sub_j)
    assert type(tc) is type(tm) and tc is not tm and tc.z == 0.0
    assert tc._ctor_kwargs() == jc._ctor_kwargs() == tm._ctor_kwargs()
    assert tc.kappa == tm.kappa and tc.A == tm.A and tc.a == tm.a
    t = np.asarray(sub_t["MJD"], float)
    p = tuple(_batch(2)[0])
    np.testing.assert_allclose(tc.evaluate(t, np.asarray(sub_t["filter"]), *p),
                               jc.evaluate(t, np.asarray(sub_j["filter"]), *p),
                               rtol=1e-12, atol=0)


# ----------------------------------------------------------- log-posterior

def _both(lcs, name, kw, p, f32, use_sigma=False):
    """The batched log-posterior of both packages at ``p`` through their
    make_log_posterior, the t_0 prior widened to (57468, 57480)."""
    jlc, tlc = lcs
    pri = _late_priors(use_sigma)
    jm, tm = _models(name, kw, jlc, tlc)
    try:
        if f32:
            jconfig.set_compute_dtype(jnp.float32)
            tconfig.set_compute_dtype(torch.float32)
        a = np.asarray(jax.vmap(jfit.make_log_posterior(jm, jlc, pri, use_sigma))(jnp.asarray(p)))
        lp = tfit.make_log_posterior(tm, tlc, interop.priors_from_jax(pri), use_sigma,
                                     device="cpu")
        assert lp.log_likelihood.compute_dtype == (torch.float32 if f32 else torch.float64)
        before = dict(kernels.LAUNCHES)
        b = lp(torch.as_tensor(p)).numpy()
        assert kernels.LAUNCHES == before           # the CPU runs the plain path
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    ll = lp.log_likelihood
    return a, b, ll.offset if use_sigma else ll.log_norm_const


def _assert_ll_close(a, b, rel, const=0.0):
    assert b.dtype == np.float64 and not np.isnan(b).any()
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    scale = np.abs(a[fin] - const) + abs(const)
    assert np.all(np.abs(b[fin] - a[fin]) <= rel * scale), \
        np.max(np.abs(b[fin] - a[fin]) / scale)


@pytest.mark.parametrize("name,kw", [CONFIGS[0], CONFIGS[1], CONFIGS[2], CONFIGS[4],
                                     CONFIGS[5]], ids=["sc", "sc-n3", "sc-rw", "sc4",
                                                       "sc4-kappa"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_log_posterior_batch(lcs, name, kw, f32):
    p = _batch()
    a, b, c = _both(lcs, name, kw, p, f32)
    assert np.isfinite(b[:48]).all() and np.isneginf(b[48:54]).all()
    assert np.isfinite(b[54:]).all()                 # t < t_0 at the first points
    _assert_ll_close(a, b, 1e-5, c) if f32 else _assert_ll_close(a, b, 1e-10)


@pytest.mark.parametrize("name", ["ShockCooling", "ShockCooling4"], ids=["sc", "sc4"])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_log_posterior_batch_use_sigma(lcs, name, f32):
    p = _batch(3)
    p = np.concatenate([p, np.random.default_rng(4).uniform(0.5, 3.0, (len(p), 1))], axis=1)
    p[0, 5] = 20.0                                   # outside the sigma prior
    a, b, c = _both(lcs, name, {}, p, f32, use_sigma=True)
    assert np.isneginf(b[0]) and np.isfinite(b[1:48]).all()
    _assert_ll_close(a, b, 1e-5, c) if f32 else _assert_ll_close(a, b, 1e-10)


# ----------------------------------------------------- steps under shared draws

def _jax_draws(key, half):
    """The draws half_update makes from ``key`` (parallel/sampler.py:87-92)."""
    kz, kj, ku = jr.split(key, 3)
    return (np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64)),
            np.asarray(jr.randint(kj, (half,), 0, half)),
            np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64)))


@pytest.mark.parametrize("name", ["ShockCooling", "ShockCooling4"], ids=["sc", "sc4"])
def test_step_matches_jax_under_shared_draws(lcs, name):
    jlc, tlc = lcs
    jm, tm = _models(name, {}, jlc, tlc)
    jlp = jfit.make_log_posterior(jm, jlc, PRIORS)
    tlp = tfit.make_log_posterior(tm, tlc, interop.priors_from_jax(PRIORS), device="cpu")
    W, ndim = 32, 5
    half = W // 2
    pos = np.random.default_rng(3).uniform(P_LO, P_UP, size=(W, ndim)).reshape(2, half, ndim)
    jstep, jbatched = jsampler.make_stretch_kernel(jlp, half, ndim)
    jx = jnp.asarray(pos)
    jl = jbatched(jx.reshape(-1, ndim)).reshape(2, half)
    x, logp = interop.walkers_from_numpy(pos, np.asarray(jl))
    before = dict(kernels.LAUNCHES)
    k = jr.fold_in(jr.PRNGKey(5), 0)
    (jx, jl), (_, _, jacc) = jstep((jx, jl), k)
    draws = [_jax_draws(kh, half) for kh in jr.split(k)]
    u_z, j, u_acc = (torch.as_tensor(np.stack([d[n] for d in draws])) for n in range(3))
    acc = torch.zeros((2, half), dtype=torch.int32)
    for h in (0, 1):
        kernels.stretch_half_step(tlp, x, logp, h, u_z[h], j[h].to(torch.int64), u_acc[h],
                                  n_accept=acc)
    assert kernels.LAUNCHES == before
    assert np.array_equal(acc.bool().numpy(), np.asarray(jacc))
    assert 0 < int(np.asarray(jacc).sum()) < W
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=0)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jl), rtol=1e-10, atol=0)


@pytest.mark.parametrize("name", ["ShockCooling", "ShockCooling4"], ids=["sc", "sc4"])
def test_ladder_step_matches_jax_under_shared_draws(lcs, name):
    """K6b (the ladder's initial state) and one step of K6a over both halves
    and K6c, the plain versions, against the JAX package's tempered step fed
    the same keys' draws, float64: accept and swap flags identical, states
    <= 1e-12 relative, log pi bit-equal, log L <= 1e-10 relative."""
    from test_torch_evidence import _jax_step_draws
    jlc, tlc = lcs
    jm, tm = _models(name, {}, jlc, tlc)
    W, n_rungs, seed = 16, 3, 3
    jpri, jll, jp0, jkw, _ = jfit._tempered_setup(jlc, jm, PRIORS, P_LO, P_UP, W, False,
                                                  "relative", seed)
    priors, ll, p0, kw = tfit._tempered_setup(tlc, tm, interop.priors_from_jax(PRIORS), P_LO,
                                              P_UP, W, False, "relative", seed, device="cpu")
    assert jkw == {} and kw == {} and np.array_equal(p0, jp0)
    betas = jev.make_beta_ladder(n_rungs)
    K, half, ndim = len(betas), W // 2, 5
    jstep, jbpri, jbll = jev._make_tempered_step(jpri, jll, half, ndim, betas)
    x0 = np.broadcast_to(p0.reshape(1, 2, half, ndim), (K, 2, half, ndim)).copy()
    jx = jnp.asarray(x0)
    jlp = jnp.stack([jbpri(jx[r].reshape(W, ndim)).reshape(2, half) for r in range(K)])
    jl = jnp.stack([jbll(jx[r].reshape(W, ndim)).reshape(2, half) for r in range(K)])
    lp = tfit.LogPosterior(ll, priors)
    before = dict(kernels.LAUNCHES)
    x = torch.as_tensor(x0)
    logpri, logl = ladder.ladder_init(lp, x[:1], copies=K)
    np.testing.assert_array_equal(logpri.numpy(), np.asarray(jlp))
    np.testing.assert_allclose(logl.numpy(), np.asarray(jl), rtol=1e-10, atol=0)
    xs, (u_z, j, u_acc, u_swap) = _jax_step_draws(0, jr.PRNGKey(seed), K, half)
    (jx, jlp, jl), (_, jacc, jsw, _) = jstep((jx, jlp, jl), xs)
    bt = torch.as_tensor(betas)
    n_accept = torch.zeros((K, 2, half), dtype=torch.int32)
    counts = torch.zeros_like(n_accept)
    for h in (0, 1):
        ladder.tempered_half_step(lp, x, logpri, logl, bt, h, u_z, j, u_acc, n_accept=n_accept)
    ladder.replica_swap(x, logpri, logl, bt, u_swap, xs[2], counts)
    assert kernels.LAUNCHES == before              # the CPU runs the plain versions
    assert np.array_equal(n_accept.bool().numpy(), np.asarray(jacc))
    assert np.array_equal(counts.bool().numpy(), np.asarray(jsw))
    assert 0 < int(n_accept.sum()) < K * W
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(logpri.numpy(), np.asarray(jlp))
    np.testing.assert_allclose(logl.numpy(), np.asarray(jl), rtol=1e-10, atol=0)


# ----------------------------------------------------------------- routing

def test_kernel_modules_and_cpu_wrappers(lcs):
    """SC and SC4 route to their own kernel modules (BaseShockCooling stays
    refused), the parameter blocks take ndim 5 (6 with the scatter) and the
    models' constants, and on CPU tensors every wrapper is its plain
    version, launching nothing."""
    _, tlc = lcs
    assert kernels.module_for(tmodels.ShockCooling(tlc)) is sc
    assert kernels.module_for(tmodels.ShockCooling4(tlc)) is sc4
    with pytest.raises(NotImplementedError, match="no fused CUDA log-posterior"):
        kernels.module_for(tmodels.BaseShockCooling(tlc))
    with pytest.raises(NotImplementedError, match="no fused CUDA log-posterior"):
        tmodels.BaseShockCooling(tlc).kernel_constants()
    pri = interop.priors_from_jax(PRIORS)
    p = torch.as_tensor(_batch(5)[:16])
    before = dict(kernels.LAUNCHES)
    for mod, model in ((sc, tmodels.ShockCooling(tlc, kappa=0.7)),
                       (sc4, tmodels.ShockCooling4(tlc, kappa=0.7))):
        lp = tfit.make_log_posterior(model, tlc, pri, device="cpu")
        assert lp.kernel_module is mod
        want = lp.forward_plain(p)
        assert torch.equal(mod.log_posterior(lp, p), want)
        assert torch.equal(kernels.log_posterior(lp, p), want)
        off, scl = (P_LO + P_UP) / 2, (P_UP - P_LO) / 2
        q = ((p - torch.as_tensor(off)) / torch.as_tensor(scl)).float()
        assert torch.equal(mod.log_posterior(lp, q, off, scl),
                           common.log_posterior_plain(lp, q, off, scl))
        x = p[:16].reshape(2, 8, 5).clone()
        lg = lp.forward_plain(x.reshape(-1, 5)).reshape(2, 8)
        x2, lg2 = x.clone(), lg.clone()
        g = torch.Generator().manual_seed(1)
        u_z, u_acc = torch.rand(8, generator=g, dtype=torch.float64), \
            torch.rand(8, generator=g, dtype=torch.float64)
        j = torch.randint(0, 8, (8,), generator=g)
        a1, a2 = torch.zeros((2, 8), dtype=torch.int32), torch.zeros((2, 8), dtype=torch.int32)
        mod.stretch_half_step(lp, x, lg, 0, u_z, j, u_acc, n_accept=a1)
        common.stretch_half_step_plain(lp.forward_plain, x2, lg2, 0, u_z, j, u_acc, n_accept=a2)
        assert torch.equal(x, x2) and torch.equal(lg, lg2) and torch.equal(a1, a2)
        P = mod._kernel_params(lp, 5, off, scl)
        assert P.ndim == 5 and P.kappa == 0.7 and P.has_affine == 1
        assert P.prior_kind[2] == 1 and P.kappa_L == 0.7 ** -0.89
        with pytest.raises(ValueError, match="ndim = 5"):
            mod._kernel_params(lp, 4, None, None)
        meta = torch.empty((4, 5), device="meta")
        with pytest.raises(ValueError, match="runs on CUDA"):
            mod.log_posterior(lp, meta)
    assert kernels.LAUNCHES == before
    assert sc._kernel_params(tfit.make_log_posterior(tmodels.ShockCooling(tlc, n=3.0), tlc, pri,
                                                     device="cpu"), 5, None, None).A == 0.79
    lp4 = tfit.make_log_posterior(tmodels.ShockCooling4(tlc), tlc, pri, device="cpu")
    P4 = sc4._kernel_params(lp4, 5, None, None)
    assert (P4.t_br_0, P4.L_br_0_42, P4.T_col_br_0, P4.t_tr_0) == (0.036, 3.69, 8.19, 19.5)


def test_sc_half_form_by_width():
    """The SC and SC4 half-steps' form rules on the H100's 132 SMs at the
    flagship's 149 points, each model's measured crossover: the latency form
    at 26c's half 32 and 26a's half 2048; SC4's warp form from half 34321,
    SC's latency form through 81920 and its warp form at 98304; past 20
    warps a walker (640 points) only the warp form runs."""
    for mod in (sc, sc4):
        assert mod.sc_half_form(32, 149, 132) == "latency"
        assert mod.sc_half_form(2048, 149, 132) == "latency"
        assert mod.sc_half_form(98304, 149, 132) == "warp"
        assert mod.sc_half_form(1, 641, 132) == "warp"
        assert mod.sc_half_form(1, 640, 132) == "latency"
    assert sc4.sc_half_form(34320, 149, 132) == "latency"
    assert sc4.sc_half_form(34321, 149, 132) == "warp"
    assert sc4.sc_half_form(65536, 149, 132) == "warp"
    assert sc.sc_half_form(65536, 149, 132) == "latency"
    assert sc.sc_half_form(81920, 149, 132) == "latency"


class _FakeCudaState:
    """A CPU state tensor that reports a CUDA device, so that a half-step
    wrapper takes its kernel branch up to the C call."""

    def __init__(self, t):
        self.t, self.shape, self.dtype, self.ndim = t, t.shape, t.dtype, t.dim()
        self.device = torch.device("cuda", 0)

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("prefix", ["sc", "sc4"])
def test_half_step_form_reaches_the_c_call(lcs, monkeypatch, prefix):
    """The form sc_half_form picks (or the caller names) is the form argument
    of the C launch, one LAUNCHES count a half-step under the name it had
    and one under its form's name; a failed launch raises, naming the form
    and counting nothing."""
    from lightcurve_fitting_tpu_torch.kernels import build, gradient
    _, tlc = lcs
    model = tmodels.ShockCooling(tlc) if prefix == "sc" else tmodels.ShockCooling4(tlc)
    lp = tfit.make_log_posterior(model, tlc, interop.priors_from_jax(PRIORS), device="cpu")
    calls = []

    class Lib:
        rc = 0

        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args[-2]))
                return Lib.rc
            return launch
    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(gradient, "sm_count", lambda dev: 132)
    monkeypatch.setattr(sc, "half_step_checks", lambda x, *a: (x.shape[1], x.shape[2]))
    monkeypatch.setattr(sc, "check_buffers", lambda *a: None)
    monkeypatch.setattr(sc, "cuda_args", lambda dev: (0, 0))
    name = f"{prefix}_half_step"
    names = (name, f"{name}_warp", f"{name}_latency")
    for k in names:
        monkeypatch.setitem(kernels.LAUNCHES, k, kernels.LAUNCHES[k])   # restored after
    for half, form, want in ((32, None, 1), (2048, None, 1), (98304, None, 0),
                             (32, "warp", 0), (65536, "latency", 1)):
        x = _FakeCudaState(torch.zeros((2, half, 5), dtype=torch.float32))
        logp = torch.zeros((2, half), dtype=torch.float64)
        u = torch.zeros(half, dtype=torch.float32)
        j = torch.zeros(half, dtype=torch.int64)
        acc = torch.zeros((2, half), dtype=torch.int32)
        n0 = {k: kernels.LAUNCHES[k] for k in names}
        sc.half_step_launch(prefix, lp, x, logp, 0, u, j, u, n_accept=acc, form=form)
        assert calls[-1] == (f"{prefix}_half_step_launch", want)
        ran = f"{name}_{('warp', 'latency')[want]}"
        assert {k: kernels.LAUNCHES[k] - n0[k] for k in names} == {
            k: int(k in (name, ran)) for k in names}
    Lib.rc = 1
    n0 = {k: kernels.LAUNCHES[k] for k in names}
    with pytest.raises(RuntimeError, match="latency form"):
        sc.half_step_launch(prefix, lp, x, logp, 0, u, j, u, n_accept=acc, form="latency")
    assert {k: kernels.LAUNCHES[k] for k in names} == n0
    with pytest.raises(ValueError, match="'warp' or 'latency'"):
        sc.half_step_launch(prefix, lp, x, logp, 0, u, j, u, n_accept=acc, form="thread")


@pytest.mark.parametrize("mod", [sc, sc4], ids=["sc", "sc4"])
def test_tempered_form_by_width(mod):
    """K6a's form rule over SC and SC4 on the H100's 132 SMs at the
    flagship's 149 points, counting every rung's walkers of a launch: the
    latency form at 26b's 25 rungs x half 32, lightcurve_evidence's default
    33 x 32, lightcurve_ptmcmc's 17 x 32 and 16384 walkers; at the evidence
    bench shape, 17 x half 2048, SC's latency form and SC4's warp form (each
    model's measured crossover), at 65536 SC's latency form, at 81920 both
    warp forms; past 20 warps a walker (640 points) only the warp form."""
    for walkers in (25 * 32, 33 * 32, 17 * 32, 16384):
        assert mod.tempered_form(walkers, 149, 132) == "latency"
    wide = "latency" if mod is sc else "warp"
    assert mod.tempered_form(17 * 2048, 149, 132) == wide
    assert mod.tempered_form(65536, 149, 132) == wide
    assert mod.tempered_form(81920, 149, 132) == "warp"
    assert mod.tempered_form(1, 641, 132) == "warp"
    assert mod.tempered_form(25 * 32, 640, 132) == "latency"


def _stub_ladder_launches(monkeypatch, calls):
    """A stub kernel library whose launches record (name, the argument
    before the stream) and return Lib.rc (Lib.args: the last launch's
    arguments), with the ladder's input checks and the card's 132 SMs
    stubbed, so that ladder.tempered_half_step and ladder.ladder_init on a
    _FakeCudaState reach their C call."""
    from lightcurve_fitting_tpu_torch.kernels import build, gradient

    class Lib:
        rc = 0
        args = None   # the last launch's arguments

        def __getattr__(self, name):
            def launch(*args):
                calls.append((name, args[-2]))
                Lib.args = args
                return Lib.rc
            return launch
    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(gradient, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ladder, "_ladder_checks", lambda x, *a: (x.shape[0], x.shape[2],
                                                                  x.shape[3]))
    monkeypatch.setattr(ladder, "check", lambda *a: None)
    monkeypatch.setattr(ladder, "check_buffers", lambda *a: None)
    monkeypatch.setattr(ladder, "cuda_args", lambda dev: (0, 0))
    return Lib


def _ladder_args(R, half, ndim=5):
    x = _FakeCudaState(torch.zeros((R, 2, half, ndim), dtype=torch.float32))
    lg = torch.zeros((R, 2, half), dtype=torch.float64)
    u = torch.zeros((R, 2, half), dtype=torch.float32)
    j = torch.zeros((R, 2, half), dtype=torch.int64)
    return x, lg, lg.clone(), torch.zeros(R, dtype=torch.float64), 1, u, j, u, \
        torch.zeros((R, 2, half), dtype=torch.int32)


@pytest.mark.parametrize("prefix", ["sc", "sc4"])
def test_tempered_half_step_form_reaches_the_c_call(lcs, monkeypatch, prefix):
    """The form K6a's rule picks over a launch's R x half walkers (or the
    caller names) is the form argument of the SC or SC4 C launch, one
    LAUNCHES count a launch under the LADDER_COUNTS name and one under its
    form's name; a failed launch raises, naming the form and counting
    nothing; an unknown form raises."""
    _, tlc = lcs
    model = tmodels.ShockCooling(tlc) if prefix == "sc" else tmodels.ShockCooling4(tlc)
    lp = tfit.make_log_posterior(model, tlc, interop.priors_from_jax(PRIORS), device="cpu")
    calls = []
    Lib = _stub_ladder_launches(monkeypatch, calls)
    name = f"{prefix}_tempered_half_step"
    names = (name, f"{name}_warp", f"{name}_latency")
    for k in names:
        monkeypatch.setitem(kernels.LAUNCHES, k, kernels.LAUNCHES[k])   # restored after
    for R, half, form, want in ((25, 32, None, 1), (33, 32, None, 1), (17, 32, None, 1),
                                (17, 2048, None, int(prefix == "sc")), (1, 81920, None, 0),
                                (25, 32, "warp", 0), (1, 81920, "latency", 1)):
        *args, acc = _ladder_args(R, half)
        n0 = {k: kernels.LAUNCHES[k] for k in names}
        ladder.tempered_half_step(lp, *args, n_accept=acc, form=form)
        assert calls[-1] == (f"{prefix}_tempered_half_step_launch", want)
        ran = f"{name}_{('warp', 'latency')[want]}"
        assert {k: kernels.LAUNCHES[k] - n0[k] for k in names} == {
            k: int(k in (name, ran)) for k in names}
    Lib.rc = 1
    n0 = {k: kernels.LAUNCHES[k] for k in names}
    for form in ("latency", None):
        with pytest.raises(RuntimeError, match="latency form"):
            ladder.tempered_half_step(lp, *_ladder_args(25, 32)[:8], n_accept=acc, form=form)
    with pytest.raises(RuntimeError, match="warp form"):
        ladder.tempered_half_step(lp, *_ladder_args(25, 32)[:8], n_accept=acc, form="warp")
    assert {k: kernels.LAUNCHES[k] for k in names} == n0
    with pytest.raises(ValueError, match="'warp' or 'latency'"):
        ladder.tempered_half_step(lp, *_ladder_args(25, 32)[:8], n_accept=acc, form="thread")


@pytest.mark.parametrize("which", ["ShockCooling2", "CompanionShocking2"])
def test_tempered_latency_form_refused_without_a_point_term(lcs, monkeypatch, which):
    """K6a over ShockCooling2 or a companion-shocking model has the warp
    form only: form="latency" raises before any launch, while the rule's
    pick and form="warp" launch the warp form (no form argument in the C
    call, the one LAUNCHES count of before)."""
    from types import SimpleNamespace
    from lightcurve_fitting_tpu_torch.filters import filtdict
    _, tlc = lcs
    if which == "ShockCooling2":
        model, ndim = tmodels.ShockCooling2(tlc), 4
    else:
        t = np.repeat(np.linspace(1.0, 20.0, 4), 3)
        f = np.array([filtdict[n] for n in ("B", "V", "g")] * 4)
        lum = np.full(len(t), 2e15)
        model = tmodels.CompanionShocking2(TLC([t, f, lum, 0.05 * lum],
                                               names=["MJD", "filter", "lum", "dlum"]),
                                           device="cpu")
        ndim = 8
    mod = kernels.module_for(model)
    assert not hasattr(mod, "tempered_form")
    target = SimpleNamespace(log_likelihood=SimpleNamespace(model=model))
    calls = []
    _stub_ladder_launches(monkeypatch, calls)
    params = sc._SCParams()   # (any ctypes block: the stub reads none of it)
    params.n_points = 149
    monkeypatch.setattr(mod, "_kernel_params", lambda *a: params)
    monkeypatch.setitem(kernels.LAUNCHES, "tempered_half_step",
                        kernels.LAUNCHES["tempered_half_step"])
    args = _ladder_args(25, 32, ndim)
    with pytest.raises(ValueError, match="warp form only"):
        ladder.tempered_half_step(target, *args[:8], n_accept=args[8], form="latency")
    assert calls == []
    target.log_likelihood.compute_dtype = torch.float32
    n0 = kernels.LAUNCHES["tempered_half_step"]
    for form in (None, "warp"):
        ladder.tempered_half_step(target, *args[:8], n_accept=args[8], form=form)
        assert calls[-1][0] == f"{mod.__name__.rsplit('.', 1)[-1]}_tempered_half_step_launch"
        assert calls[-1][1] == args[8].data_ptr()   # n_accept, then the stream
    assert kernels.LAUNCHES["tempered_half_step"] == n0 + 2


@pytest.mark.parametrize("mod", [sc, sc4], ids=["sc", "sc4"])
def test_logpost_form_by_width(mod):
    """The batch log-posterior's form rule over SC and SC4, and K6b's (the
    same rule over its distinct states), on the H100's 132 SMs at the
    flagship's 149 points: the latency form at 26c's 64 walkers, 26a's 4096
    and 8192; each side of the family's measured crossover
    (LOGPOST_LATENCY_WARPS_PER_SM: SC's latency form through 12288 walkers,
    SC4's through 8192); the warp form at 16384 and 131072 (chip_smoke.py
    25's width); past 20 warps a walker (640 points) only the warp form."""
    prefix = mod.__name__.rsplit(".", 1)[-1]
    last = sc.LOGPOST_LATENCY_WARPS_PER_SM[prefix] * 132 // 5   # 5 warps a walker
    assert last == (12302 if mod is sc else 8210)
    for rule in (mod.logpost_form, mod.ladder_init_form):
        for walkers in (64, 4096, 8192, last):
            assert rule(walkers, 149, 132) == "latency"
        for walkers in (last + 1, 16384, 131072):
            assert rule(walkers, 149, 132) == "warp"
        assert rule(12288, 149, 132) == ("latency" if mod is sc else "warp")
        assert rule(1, 641, 132) == "warp"
        assert rule(64, 640, 132) == "latency"


def _cpu_outputs(monkeypatch):
    """torch.empty on a CPU device whatever device it is asked for, so that a
    wrapper's outputs for a _FakeCudaState can be made here."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))


@pytest.mark.parametrize("prefix", ["sc", "sc4"])
def test_logpost_form_reaches_the_c_call(lcs, monkeypatch, prefix):
    """The form the batch log-posterior's rule picks over the walkers (or the
    caller names) is the form argument of the SC or SC4 C launch, one
    LAUNCHES count a launch under its name of before and one under its
    form's; a failed launch raises, naming the form and counting nothing;
    an unknown form raises."""
    _, tlc = lcs
    model = tmodels.ShockCooling(tlc) if prefix == "sc" else tmodels.ShockCooling4(tlc)
    lp = tfit.make_log_posterior(model, tlc, interop.priors_from_jax(PRIORS), device="cpu")
    calls = []
    Lib = _stub_ladder_launches(monkeypatch, calls)
    monkeypatch.setattr(sc, "check", lambda *a: None)
    monkeypatch.setattr(sc, "check_buffers", lambda *a: None)
    monkeypatch.setattr(sc, "cuda_args", lambda dev: (0, 0))
    _cpu_outputs(monkeypatch)
    name = f"{prefix}_logpost"
    names = (name, f"{name}_warp", f"{name}_latency")
    for k in names:
        monkeypatch.setitem(kernels.LAUNCHES, k, kernels.LAUNCHES[k])   # restored after
    for W, form, want in ((64, None, 1), (4096, None, 1), (8192, None, 1), (16384, None, 0),
                          (131072, None, 0), (64, "warp", 0), (131072, "latency", 1)):
        q = _FakeCudaState(torch.zeros((W, 5), dtype=torch.float32))
        n0 = {k: kernels.LAUNCHES[k] for k in names}
        out = sc.logpost_launch(prefix, lp, q, form=form)
        assert calls[-1] == (f"{prefix}_logpost_launch", want) and out.shape == (W,)
        assert Lib.args[5] == W
        ran = f"{name}_{('warp', 'latency')[want]}"
        assert {k: kernels.LAUNCHES[k] - n0[k] for k in names} == {
            k: int(k in (name, ran)) for k in names}
    Lib.rc = 1
    n0 = {k: kernels.LAUNCHES[k] for k in names}
    q = _FakeCudaState(torch.zeros((64, 5), dtype=torch.float32))
    for form, what in (("latency", "latency"), (None, "latency"), ("warp", "warp")):
        with pytest.raises(RuntimeError, match=f"{what} form"):
            sc.logpost_launch(prefix, lp, q, form=form)
    assert {k: kernels.LAUNCHES[k] for k in names} == n0
    with pytest.raises(ValueError, match="'warp' or 'latency'"):
        sc.logpost_launch(prefix, lp, q, form="thread")


@pytest.mark.parametrize("prefix", ["sc", "sc4"])
def test_ladder_init_form_reaches_the_c_call(lcs, monkeypatch, prefix):
    """The form K6b's rule picks over a launch's distinct states (or the
    caller names) is the form argument of the SC or SC4 C launch, with the
    states, per set and copies of before; one LAUNCHES count a launch under
    the LADDER_COUNTS name and one under its form's; a failed launch
    raises, naming the form and counting nothing; an unknown form raises."""
    _, tlc = lcs
    model = tmodels.ShockCooling(tlc) if prefix == "sc" else tmodels.ShockCooling4(tlc)
    lp = tfit.make_log_posterior(model, tlc, interop.priors_from_jax(PRIORS), device="cpu")
    calls = []
    Lib = _stub_ladder_launches(monkeypatch, calls)
    _cpu_outputs(monkeypatch)
    name = f"{prefix}_ladder_init"
    names = (name, f"{name}_warp", f"{name}_latency")
    for k in names:
        monkeypatch.setitem(kernels.LAUNCHES, k, kernels.LAUNCHES[k])   # restored after
    for S, half, copies, form, want in ((1, 32, 25, None, 1), (1, 2048, 17, None, 1),
                                        (2, 2048, 1, None, 1), (4, 2048, 1, None, 0),
                                        (1, 65536, 2, None, 0),
                                        (1, 32, 25, "warp", 0), (1, 65536, 1, "latency", 1)):
        x = _FakeCudaState(torch.zeros((S, 2, half, 5), dtype=torch.float32))
        n0 = {k: kernels.LAUNCHES[k] for k in names}
        pri, ll = ladder.ladder_init(lp, x, copies=copies, form=form)
        assert calls[-1] == (f"{prefix}_ladder_init_launch", want)
        assert Lib.args[5:8] == (S * 2 * half, 2 * half, copies)
        assert pri.shape == ll.shape == (S * copies, 2, half)
        ran = f"{name}_{('warp', 'latency')[want]}"
        assert {k: kernels.LAUNCHES[k] - n0[k] for k in names} == {
            k: int(k in (name, ran)) for k in names}
    Lib.rc = 1
    n0 = {k: kernels.LAUNCHES[k] for k in names}
    x = _FakeCudaState(torch.zeros((1, 2, 32, 5), dtype=torch.float32))
    for form, what in (("latency", "latency"), (None, "latency"), ("warp", "warp")):
        with pytest.raises(RuntimeError, match=f"{what} form"):
            ladder.ladder_init(lp, x, copies=25, form=form)
    assert {k: kernels.LAUNCHES[k] for k in names} == n0
    with pytest.raises(ValueError, match="'warp' or 'latency'"):
        ladder.ladder_init(lp, x, copies=25, form="thread")


@pytest.mark.parametrize("which", ["ShockCooling2", "CompanionShocking2"])
def test_ladder_init_latency_refused_without_a_point_term(lcs, monkeypatch, which):
    """K6b over ShockCooling2 or a companion-shocking model has the warp
    form only: form="latency" raises before any launch, while the rule's
    pick and form="warp" launch the warp form (no form argument in the C
    call: its eleven arguments of before, the one LAUNCHES count)."""
    from types import SimpleNamespace
    from lightcurve_fitting_tpu_torch.filters import filtdict
    _, tlc = lcs
    if which == "ShockCooling2":
        model, ndim = tmodels.ShockCooling2(tlc), 4
    else:
        t = np.repeat(np.linspace(1.0, 20.0, 4), 3)
        f = np.array([filtdict[n] for n in ("B", "V", "g")] * 4)
        lum = np.full(len(t), 2e15)
        model = tmodels.CompanionShocking2(TLC([t, f, lum, 0.05 * lum],
                                               names=["MJD", "filter", "lum", "dlum"]),
                                           device="cpu")
        ndim = 8
    mod = kernels.module_for(model)
    assert not hasattr(mod, "ladder_init_form")
    target = SimpleNamespace(log_likelihood=SimpleNamespace(model=model))
    calls = []
    Lib = _stub_ladder_launches(monkeypatch, calls)
    _cpu_outputs(monkeypatch)
    params = sc._SCParams()   # (any ctypes block: the stub reads none of it)
    params.n_points = 149
    monkeypatch.setattr(mod, "_kernel_params", lambda *a: params)
    monkeypatch.setitem(kernels.LAUNCHES, "ladder_init", kernels.LAUNCHES["ladder_init"])
    x = _FakeCudaState(torch.zeros((1, 2, 32, ndim), dtype=torch.float32))
    with pytest.raises(ValueError, match="warp form only"):
        ladder.ladder_init(target, x, copies=25, form="latency")
    assert calls == []
    target.log_likelihood.compute_dtype = torch.float32
    n0 = kernels.LAUNCHES["ladder_init"]
    for form in (None, "warp"):
        pri, _ = ladder.ladder_init(target, x, copies=25, form=form)
        assert calls[-1][0] == f"{mod.__name__.rsplit('.', 1)[-1]}_ladder_init_launch"
        assert len(Lib.args) == 11 and Lib.args[-3] == pri.data_ptr()   # logpri, logl, stream
    assert kernels.LAUNCHES["ladder_init"] == n0 + 2


def test_param_block_layout_matches_the_c_struct():
    """struct SCParams (csrc/sc_logpost.cu) and its ctypes mirror: every
    field 8 bytes wide, 8 pointers, 5 ints, 21 doubles, 7 arrays of
    LP_MAX_DIM = 9, then the latency form's coef_t pointer, in one order."""
    import ctypes
    from test_torch_kernels import _c_fields
    assert ctypes.sizeof(sc._SCParams) == 8 * (8 + 5 + 21) + 7 * 9 * 8 + 8
    assert _c_fields("SCParams") == [name for name, _ in sc._SCParams._fields_]


# ----------------------------------------------------------------- interop

@pytest.mark.parametrize("name", ["BaseShockCooling", "ShockCooling", "ShockCooling2",
                                  "ShockCooling3", "ShockCooling4", "BaseCompanionShocking",
                                  "CompanionShocking", "CompanionShocking2",
                                  "CompanionShocking3"])
def test_model_from_jax(lcs, name):
    """Every model class of both packages: the port's model of the same
    class, constructor options and z, whose evaluation equals the JAX
    model's where the class evaluates."""
    jlc, tlc = lcs
    kw = {"kappa": 0.7}
    if "Companion" in name:
        from test_companion_shocking import make_ia_lc
        from test_torch_companion import _port_lc
        jlc = make_ia_lc(seed=3)[0]
        tlc = _port_lc(jlc)
    elif name != "ShockCooling4":
        kw.update(n=3.0, RW=name != "ShockCooling3")
    jm = getattr(jmodels, name)(jlc, **kw)
    jm.z = 0.0
    if "Companion" in name:
        with pytest.raises(ValueError, match="pass lc"):
            interop.model_from_jax(jm)
    tm = interop.model_from_jax(jm, tlc)
    assert type(tm) is getattr(tmodels, name) and tm.z == 0.0
    assert tm._ctor_kwargs() == jm._ctor_kwargs() and tm.kappa == 0.7
    if name.startswith("Base"):
        return
    t = np.asarray(tlc["MJD"], float)[:25]
    p = {"ShockCooling": (1.2, 1.0, 3.0, 2.0, 57468.3),
         "ShockCooling2": (30.0, 3.0, 30.0, 57468.5),
         "ShockCooling3": (1.2, 1.0, 10.0, 3.0, 14.4, 0.02, 57468.5),
         "ShockCooling4": (1.2, 1.0, 3.0, 2.0, 57468.3),
         "CompanionShocking": (57820.0, 0.6, 1.25, 57840.0, 1.0, 1.0, 1.0, 1.0),
         "CompanionShocking2": (57820.0, 0.6, 1.25, 57840.0, 1.0, 0.0, 0.0),
         "CompanionShocking3": (57820.0, 0.6, 45.0, 57840.0, 1.0, 0.0, 0.0)}[name]
    np.testing.assert_allclose(tm.evaluate(t, np.asarray(tlc["filter"])[:25], *p),
                               jm.evaluate(t, np.asarray(jlc["filter"])[:25], *p),
                               rtol=1e-12, atol=0)


# ------------------------------------------------- references of chip_smoke.py

def _quiet(fn, *a, **k):
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def jax_sc_acceptance(name, seeds=range(1, 9), nwalkers=4096, nsteps=300):
    """The JAX package's mean acceptance, float64 on the CPU, of
    ``lightcurve_mcmc`` for model ``name`` ("ShockCooling" or
    "ShockCooling4") on SN 2016bkv's early curve at examples/compare_models.py's
    priors and window, ``nwalkers`` x ``nsteps`` steps from the window, no
    burn-in, one run a seed (``shard=False``): what ``chip_smoke.py`` phase
    26a holds the card's runs to. Returns {seed: acceptance}."""
    jlc = _early(JLC)
    out = {}
    for seed in seeds:
        s = _quiet(jfit.lightcurve_mcmc, jlc, getattr(jmodels, name)(jlc), PRIORS, p_lo=P_LO,
                   p_up=P_UP, nwalkers=nwalkers, nsteps=nsteps, nsteps_burnin=0, seed=seed,
                   shard=False, quiet=True)
        out[seed] = float(np.mean(s.acceptance_fraction))
    return out


def jax_sc_evidence(seed=7):
    """The JAX package's float64 CPU log Z and its error of SW17 and MSW23 at
    tests/test_evidence.py:124-131's settings (64 walkers, 24 rungs + beta =
    1, 600 + 400 steps): what ``chip_smoke.py`` phase 26b holds
    ``compare_models`` on the card to. Returns {name: (log Z, error)}."""
    jlc = _early(JLC)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=64, n_rungs=24, nsteps=400, nsteps_burnin=600,
              seed=seed, quiet=True)
    return {name: tuple(float(v) for v in jfit.lightcurve_evidence(
        jlc, getattr(jmodels, name)(jlc), PRIORS, **kw)[:2])
        for name in ("ShockCooling", "ShockCooling4")}


def jax_sc_loo(seeds=tuple(range(7, 17))):
    """The JAX package's float64 CPU ``compare_models_loo`` of SW17 and
    MSW23 at examples/compare_models.py's settings (64 walkers x 500 + 500):
    {seed: ({name: elpd_loo}, the ranking best first, d_elpd, se_d_elpd)},
    what ``chip_smoke.py`` phase 26c holds the card's run to. At these
    settings the chains have not converged and the ranking changes with the
    seed."""
    jlc = _early(JLC)
    out = {}
    for seed in seeds:
        tab = _quiet(jfit.compare_models_loo, jlc, [jmodels.ShockCooling(jlc),
                                                    jmodels.ShockCooling4(jlc)],
                     PRIORS, p_lo=P_LO, p_up=P_UP, labels=["ShockCooling", "ShockCooling4"],
                     nwalkers=64, nsteps=500, nsteps_burnin=500, seed=seed, quiet=True)
        out[seed] = ({str(m): float(e) for m, e in zip(tab["model"], tab["elpd_loo"])},
                     [str(m) for m in tab["model"]], float(tab["d_elpd"][1]),
                     float(tab["se_d_elpd"][1]))
        print(f"compare_models_loo seed {seed}: {out[seed]!r}", flush=True)
    return out


if __name__ == "__main__":
    for name in ("ShockCooling", "ShockCooling4"):
        acc = jax_sc_acceptance(name)
        vals = np.array(list(acc.values()))
        print(f"{name} acceptance {acc!r}; mean {vals.mean()!r} +/- "
              f"{vals.std(ddof=1) / np.sqrt(len(vals))!r}", flush=True)
    print(f"log Z at seed 7: {jax_sc_evidence()!r}", flush=True)
    loo = jax_sc_loo()
    for name in ("ShockCooling", "ShockCooling4"):
        e = np.log10(-np.array([v[0][name] for v in loo.values()]))
        print(f"{name} log10(-elpd_loo) mean {e.mean()!r} sd {e.std(ddof=1)!r}")
