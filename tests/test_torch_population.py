"""The port's population fit (``parallel/population.py`` and the plain
versions of P1-P3, ``kernels/pop.py``) against the JAX package's, on the CPU.

Inputs are made from a seed with numpy (tests/test_population.py's
fixtures) and go through both packages. ``make_logpost`` is a closure
inside the JAX ``fit_population``, so :func:`_jax_logpost` rebuilds it, line
for line, from the JAX package's own ``pack_population``, ``_eval_points``
and ``intrinsic_scatter_units`` (population.py:349-386). Tolerances, each
with its reason:
- ``pack_population``: bit-equal arrays in float64 (the same host numpy);
- P1 in float64: <= 1e-12 relative (the frameworks sum the points in other
  orders); in float32, both packages under their float32 compute dtype:
  <= 1e-5 of the term scale (``PopulationPosterior.term_scales``: 0.5 x the
  summed magnitudes of the residual terms' parts, the scatter's log term
  apart, plus |log_norm|), the repo's
  float32 log-likelihood budget, plus the JAX float32 value's own distance
  from the float64 one (XLA's float32 exp, log and pow on the CPU put it
  up to 1.4e-5 of the term scale from float64 with the intrinsic scatter);
  identical -inf sets;
- one P2 step (both halves) under the JAX step's own draws: states exact,
  log-posteriors <= 1e-12 relative;
- ``_map_seeded_guesses`` from the same numpy seed: walkers <= 1e-8
  relative (Adam steps from identical starts; only the gradients' last
  bits differ), the dead-transient fallback and its warning included;
- a whole ``fit_population`` run: statistical (the random streams differ):
  tests/test_population.py's recovery criteria, medians within one posterior
  sigma of the JAX run's, 16-84 widths in ratio (0.6, 1.7), mean acceptance
  within 0.02; its summaries the percentiles of its chains;
- the diagnostics on the same chains: chi2, WAIC and LOO <= 1e-10 relative
  (float64), ``population_compare_elpd`` <= 1e-12.
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

from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.filters import filtdict as jfd  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu import models as jmodels  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2, UniformPrior as JU  # noqa: E402
from lightcurve_fitting_tpu.models.base import intrinsic_scatter_units as j_units  # noqa: E402
from lightcurve_fitting_tpu.parallel import population as jpop  # noqa: E402
from lightcurve_fitting_tpu.parallel.sampler import make_stretch_kernel  # noqa: E402

from lightcurve_fitting_tpu_torch import interop, kernels, models as tmodels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict as tfd  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import pop as kpop  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import (ShockCooling as TSC,  # noqa: E402
                                                 ShockCooling2 as TSC2, KDEPrior as TK,
                                                 UniformPrior as TU)
from lightcurve_fitting_tpu_torch.parallel import population as tpop  # noqa: E402

from test_population import TRUTHS, make_synth_lc  # noqa: E402

P_LO, P_UP = [5.0, 0.5, 20.0], [25.0, 5.0, 60.0]


def _to_port(lc):
    """The port's table of the JAX table's numbers."""
    return TLC([np.asarray(lc["MJD"], float), np.array([tfd[f.name] for f in lc["filter"]]),
                np.asarray(lc["lum"], float), np.asarray(lc["dlum"], float)],
               names=["MJD", "filter", "lum", "dlum"])


def _priors(n, sigma=False):
    bounds = [(1.0, 50.0), (0.1, 20.0), (5.0, 100.0), (56990.0, 57800.0)][:n]
    if sigma:
        bounds.append((0.0, 5.0))
    return [JU(*b) for b in bounds], [TU(*b) for b in bounds]


def _shifted(n=len(TRUTHS)):
    """tests/test_population.py's population with t_exp fixed at 0 (the
    times shifted by each truth's epoch): JAX and port tables."""
    jl = []
    for i, truth in enumerate(TRUTHS[:n]):
        lc = make_synth_lc(i, *truth)
        lc2 = lc.copy()
        lc2["MJD"] = np.asarray(lc2["MJD"], float) - truth[3]
        jl.append(JLC(lc2))
    return jl, [_to_port(lc) for lc in jl]


def _raw_mjd(n=4):
    """The MJD-scale ragged population (t_exp the fourth parameter; 3-7
    epochs a transient, so padded rows)."""
    jl = [make_synth_lc(i, *truth) for i, truth in enumerate(TRUTHS[:n])]
    return jl, [_to_port(lc) for lc in jl]


def _heterogeneous():
    """Transients whose filter sets land in different Chebyshev degree
    classes (griz-only and with the unfiltered '0'): the JAX test's."""
    rng = np.random.default_rng(0)
    jl = []
    for i, (T1, L1, ttr) in enumerate([(12.0, 2.0, 35.0), (15.0, 2.5, 40.0)]):
        names = ["g", "r", "i"] if i == 0 else ["g", "r", "i", "0"]
        filters = [jfd[n] for n in names]
        t = np.repeat(np.linspace(1.0, 8.0, 4), len(filters))
        f = np.array(filters * 4)
        y_true = JSC2()(t, f, T1, L1, ttr, 0.0)
        dy = 0.05 * y_true
        jl.append(JLC([t, f, y_true + rng.normal(scale=dy), dy],
                      names=["MJD", "filter", "lum", "dlum"]))
    return jl, [_to_port(lc) for lc in jl]


def _models(jl, tl):
    return [JSC2(lc) for lc in jl], [TSC2(lc) for lc in tl]


def _jax_logpost(jpacked, jmodel, jpriors, use_sigma, sigma_type):
    """The JAX fit_population's make_logpost (population.py:349-386), line
    for line, vmapped over transients and walkers: p (S, W, ndim) -> (S, W)."""
    dt = jconfig.get_compute_dtype()
    ndim = len(jpriors)

    def make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s):
        inv = 1.0 / yscale_s
        yn = y_s * inv
        dyn = dy_s * inv
        sigma_units = j_units(dyn, sigma_type, mask=mask_s, dt=dt)
        log_norm = -0.5 * jnp.sum(jnp.where(mask_s, jnp.log(2 * jnp.pi * dyn ** 2.0), 0.0))
        yn_h = yn if dt is None else yn.astype(dt)
        dyn_h = dyn if dt is None else dyn.astype(dt)
        inv_dyn = jnp.where(mask_s, 1.0 / dyn_h, 0.0)
        inv_h = inv if dt is None else inv.astype(dt)

        def logpost(p):
            log_prior = 0.0
            for i, prior in enumerate(jpriors):
                log_prior = log_prior + prior(p[i])
            n_model = ndim - (1 if use_sigma else 0)
            y_fit = jmodel._eval_points(t_s, quad_s, *[p[i] for i in range(n_model)])
            y_fit = (y_fit if dt is None else y_fit.astype(dt)) * inv_h
            if use_sigma:
                sig = p[-1] if dt is None else p[-1].astype(dt)
                sigma2 = dyn_h ** 2.0 + (sig * sigma_units) ** 2.0
                terms = jnp.log(2 * jnp.pi * sigma2) + (yn_h - y_fit) ** 2.0 / sigma2
                ll = -0.5 * jnp.sum(jnp.where(mask_s, terms, 0.0))
            else:
                r = (yn_h - y_fit) * inv_dyn
                ll = -0.5 * jnp.sum(r * r) + log_norm
            ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
            return jnp.where(jnp.isfinite(log_prior), log_prior + ll, -jnp.inf)

        return logpost

    def one(p_s, t_s, y_s, dy_s, mask_s, yscale_s, quad_s):
        return jax.vmap(make_logpost(t_s, y_s, dy_s, mask_s, yscale_s, quad_s))(p_s)

    f = jax.jit(jax.vmap(one))
    args = (jpacked["t"], jpacked["y"], jpacked["dy"], jpacked["mask"], jpacked["yscale"],
            jpacked["quad"])
    return make_logpost, lambda p: np.asarray(f(jnp.asarray(p), *args))


def _walkers(rng, jl, n_model, W, sigma=False):
    """W states a transient (S, W, ndim): the init window, the epoch around
    each transient's first time for t_exp, sigma in (0.01, 2); 10% outside
    the priors."""
    S = len(jl)
    p = rng.uniform(P_LO, P_UP, size=(S, W, 3))
    cols = [p]
    if n_model == 4:
        t0 = np.array([np.min(np.asarray(lc["MJD"], float)) for lc in jl])
        cols.append(t0[:, None, None] - rng.uniform(0.2, 1.5, size=(S, W, 1)))
    if sigma:
        cols.append(rng.uniform(0.01, 2.0, size=(S, W, 1)))
    p = np.concatenate(cols, axis=-1)
    out = rng.random((S, W)) < 0.1
    p[out, 0] = -1.0
    return p


@pytest.fixture(autouse=True)
def _compute_dtypes():
    yield
    jconfig.set_compute_dtype(None)
    tconfig.set_compute_dtype(tconfig.AUTO)


def _set_dtype(label):
    jconfig.set_compute_dtype(jnp.float32 if label == "f32" else None)
    tconfig.set_compute_dtype(torch.float32 if label == "f32" else tconfig.AUTO)


@pytest.mark.parametrize("which", ["shifted", "raw_mjd", "heterogeneous"])
def test_pack_population_is_the_jax_packs_bit_for_bit(which):
    jl, tl = {"shifted": _shifted, "raw_mjd": _raw_mjd, "heterogeneous": _heterogeneous}[which]()
    jm, tm = _models(jl, tl)
    jp = jpop.pack_population(jm, jl)
    tp = tpop.pack_population(tm, tl, device="cpu")
    for k in ("t", "y", "dy", "mask", "yscale"):
        assert tp[k].dtype == torch.from_numpy(np.asarray(jp[k])).dtype, k
        assert np.array_equal(np.asarray(jp[k]), tp[k].numpy()), k
    assert sorted(tp["quad"]) == sorted(jp["quad"])
    for k in jp["quad"]:
        assert np.array_equal(np.asarray(jp["quad"][k]), tp["quad"][k].numpy()), k
    if which == "heterogeneous":
        assert tp["quad"]["bb_coeffs"].shape[-1] == max(
            m.prepare_quad(np.asarray(lc["filter"]))["bb_coeffs"].shape[-1]
            for m, lc in zip(tm, tl))


def test_pack_population_shipment_cache():
    """Repeat packs reuse the shipped tensors, callers may add keys without
    touching the cache, and a content change re-ships (the JAX test's)."""
    jl, tl = _shifted(4)
    _, tm = _models(jl, tl)
    a = tpop.pack_population(tm, tl, device="cpu")
    b = tpop.pack_population(tm, tl, device="cpu")
    assert b["t"] is a["t"] and b["quad"]["bb_coeffs"] is a["quad"]["bb_coeffs"]
    assert b is not a and b["quad"] is not a["quad"]
    b["extra"] = 1
    b["quad"]["extra"] = 1
    c = tpop.pack_population(tm, tl, device="cpu")
    assert "extra" not in c and "extra" not in c["quad"]
    tl2 = [lc.copy() for lc in tl]
    tl2[0]["lum"] = np.asarray(tl2[0]["lum"], float) * 1.5
    d = tpop.pack_population([m.clone_for(lc) for m, lc in zip(tm, tl2)], tl2, device="cpu")
    assert d["y"] is not a["y"]
    np.testing.assert_allclose(d["y"][0].numpy(), 1.5 * a["y"][0].numpy())
    np.testing.assert_array_equal(d["y"][1].numpy(), a["y"][1].numpy())


@pytest.mark.parametrize("label", ["f64", "f32"])
@pytest.mark.parametrize("sigma", [None, "relative", "absolute"])
@pytest.mark.parametrize("which", ["shifted", "raw_mjd"])
def test_p1_plain_matches_the_jax_population_logpost(label, sigma, which):
    """P1's plain version against the rebuilt make_logpost on the same
    packed population and walker states: three parameters (t_exp = 0) or,
    on the ragged MJD-scale population, four; with and without the
    intrinsic scatter, both sigma_types; float64 and float32 compute."""
    _set_dtype(label)
    jl, tl = (_shifted if which == "shifted" else _raw_mjd)()
    jm, tm = _models(jl, tl)
    n_model = 3 if which == "shifted" else 4
    jpri, tpri = _priors(n_model, sigma is not None)
    use_sigma, stype = sigma is not None, sigma or "relative"
    p = _walkers(np.random.default_rng(1), jl, n_model, 24, use_sigma)
    _, jfn = _jax_logpost(jpop.pack_population(jm, jl), jm[0], jpri, use_sigma, stype)
    want = jfn(p)
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri,
                                  use_sigma, stype)
    got = kpop.log_posterior(pp, torch.as_tensor(p)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    assert fin.sum() > 0.8 * want.size
    if label == "f64":
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)
    else:
        # the yardstick and the float64 value (the JAX package's within 1e-12:
        # the f64 cases)
        _set_dtype("f64")
        pp64 = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri,
                                        use_sigma, stype)
        q = torch.as_tensor(p)
        scale, truth = pp64.term_scales(q).numpy()[fin], pp64.plain(q).numpy()[fin]
        assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 * scale + np.abs(want[fin] - truth))


def test_p1_phase_with_mjd_scale_times_in_float32():
    """The f32 phase of a padded MJD-scale row is centred on the
    transient's own floor(min t), as hot_phase does (the JAX test's 2e-5 d
    bound): the plain P1's and the kernel's t_centered."""
    _set_dtype("f32")
    jl, tl = _raw_mjd(4)
    _, tm = _models(jl, tl)
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0],
                                  _priors(4)[1])
    t = pp.t_shift[:, 0, :] + pp.t_ref[:, None]
    assert pp.t_centered.dtype == torch.float32
    np.testing.assert_array_equal(pp.t_ref.numpy(), np.floor(t.min(dim=1).values.numpy()))
    ph = pp.t_centered.double() - (58000.123 - pp.t_ref[:, None]).float().double()
    assert float((ph - (t - 58000.123)).abs().max()) < 2e-5


@pytest.mark.parametrize("use_sigma", [False, True])
def test_p2_step_under_the_jax_draws(use_sigma):
    """One step (h = 0, then 1) of the plain P2 over the JAX step's own
    draws, each transient its own ensemble: states exact, log-posteriors
    within 1e-12, the accept counts and the chain slot written."""
    jl, tl = _shifted(4)
    jm, tm = _models(jl, tl)
    jpri, tpri = _priors(3, use_sigma)
    jp = jpop.pack_population(jm, jl)
    make, _ = _jax_logpost(jp, jm[0], jpri, use_sigma, "relative")
    S, half = len(jl), 8
    ndim = len(tpri)
    x0 = _walkers(np.random.default_rng(2), jl, 3, 2 * half, use_sigma)
    x0[..., 0] = np.abs(x0[..., 0])
    x0 = x0.reshape(S, 2, half, ndim)
    keys = jr.split(jr.PRNGKey(11), S)
    x_want, lp_want = [], []
    draws = {k: np.empty((S, 2, half), dtype=np.int64 if k == "j" else np.float64)
             for k in ("u_z", "j", "u_acc")}
    for s in range(S):
        lp = make(*[jp[k][s] for k in ("t", "y", "dy", "mask", "yscale")],
                  {k: v[s] for k, v in jp["quad"].items()})
        step, batched = make_stretch_kernel(lp, half, ndim)
        xs = jnp.asarray(x0[s])
        (xn, ln), _ = step((xs, batched(xs.reshape(-1, ndim)).reshape(2, half)), keys[s])
        x_want.append(np.asarray(xn))
        lp_want.append(np.asarray(ln))
        for h, kh in enumerate(jr.split(keys[s])):      # the draws half_update makes
            kz, kj, ku = jr.split(kh, 3)
            draws["u_z"][s, h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
            draws["j"][s, h] = np.asarray(jr.randint(kj, (half,), 0, half))
            draws["u_acc"][s, h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri,
                                  use_sigma)
    x = torch.as_tensor(x0).contiguous()
    logp = kpop.log_posterior(pp, x.reshape(S, 2 * half, ndim)).reshape(S, 2, half)
    n_acc = torch.zeros((S, 2, half), dtype=torch.int32)
    cx, cl = torch.empty_like(x), torch.empty_like(logp)
    u_z, j, u_acc = (torch.as_tensor(draws[k]) for k in ("u_z", "j", "u_acc"))
    for h in (0, 1):
        kpop.stretch_half_step(pp, x, logp, h, u_z, j, u_acc, 2.0, None, None, cx, cl, n_acc)
    assert 0 < int(n_acc.sum()) < 2 * S * half
    assert np.array_equal(x.numpy(), np.stack(x_want))
    np.testing.assert_allclose(logp.numpy(), np.stack(lp_want), rtol=1e-12, atol=0.0)
    assert torch.equal(cx, x) and torch.equal(cl, logp)


def _guesses(jl, tl, dead=False, n_iter=120, n_starts=8, nwalkers=16, seed=5):
    """The JAX _map_seeded_guesses over the rebuilt make_logpost and the
    port's (the plain P3), each from default_rng(seed); with ``dead`` the
    second transient's photometry is NaN (no finite posterior anywhere)."""
    jm, tm = _models(jl, tl)
    if dead:
        for lcs in (jl, tl):
            lcs[1]["lum"] = np.full(len(lcs[1]), np.nan)
    jpri, tpri = _priors(3)
    jp = jpop.pack_population(jm, jl)
    make, _ = _jax_logpost(jp, jm[0], jpri, False, "relative")
    S, lo, up = len(jl), np.array(P_LO), np.array(P_UP)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jpop._map_seeded_guesses(make, jp, jpri, lo, up, S, nwalkers, 3, n_starts, n_iter,
                                        np.random.default_rng(seed))
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tpop._map_seeded_guesses(pp, tpri, lo, up, S, nwalkers, 3, n_starts, n_iter,
                                       np.random.default_rng(seed))
    return got, np.asarray(want), [str(w.message) for w in wt], [str(w.message) for w in wj]


def test_map_seeded_guesses_match_jax():
    got, want, _, _ = _guesses(*_shifted(4))
    assert got.shape == want.shape == (4, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0.0)
    truth = np.array([t[:3] for t in TRUTHS[:4]])
    assert np.all(np.abs(np.median(got, axis=1)[:, 0] - truth[:, 0]) < 0.2 * truth[:, 0])


def test_map_seeded_guesses_dead_transient_falls_back():
    got, want, msg_t, msg_j = _guesses(*_shifted(3), dead=True)
    assert [m for m in msg_t if "MAP seeding" in m] == [m for m in msg_j if "MAP seeding" in m]
    assert any("1 transient(s)" in m for m in msg_t)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0.0)
    assert np.all((got[1] >= P_LO) & (got[1] <= P_UP))       # the window-uniform fallback


def test_map_ascent_plain_is_the_adam_of_cosineadam():
    """The plain P3's last iterates and values: log p at the last iterate
    equals the plain P1 there, non-finite -> +inf in -log p."""
    jl, tl = _shifted(3)
    _, tm = _models(jl, tl)
    _, tpri = _priors(3)
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri)
    bounds = tpop.BoundsTransform([p.p_min for p in tpri], [p.p_max for p in tpri])
    x0 = np.random.default_rng(3).uniform(P_LO, P_UP, size=(3, 4, 3))
    u, neg = kpop.map_ascent(pp, torch.as_tensor(bounds.to_unbounded(x0)), bounds, 30)
    assert u.shape == (3, 4, 3) and neg.shape == (3, 4)
    np.testing.assert_array_equal(neg.numpy(), -pp.plain(bounds.to_bounded(u)).numpy())
    start = -pp.plain(torch.as_tensor(x0))
    assert bool((neg < start).all())


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("label", ["f32", "f64"])
def test_population_posterior_counts_the_real_points(label):
    """``n_real`` (what P1-P3 read) is each transient's count of real points,
    which pack_population puts first; a mask whose real points do not come
    first is refused."""
    _set_dtype(label)
    jl, tl = _heterogeneous()
    _, tm = _models(jl, tl)
    _, tpri = _priors(3)
    packed = tpop.pack_population(tm, tl, device="cpu")
    pp = tpop.PopulationPosterior(packed, tm[0], tpri)
    assert pp.n_real.dtype == torch.int32 and pp.n_real.is_contiguous()
    assert pp.n_real.tolist() == [len(lc) for lc in tl]
    bad = dict(packed, mask=packed["mask"].flip(1))
    with pytest.raises(ValueError, match="first"):
        tpop.PopulationPosterior(bad, tm[0], tpri)


def test_float32_plain_ascent_with_the_scatter_reaches_the_map():
    """The port's float32 MAP seeding with the intrinsic scatter: on
    ``chip_smoke.pop_example``'s population with ``pop_priors(sigma=True)``
    and 16 starts a transient from default_rng(27) (``chip_smoke.py`` 27's),
    the float32 plain ascent (``kpop.map_ascent_plain``, P3's plain version)
    lands, at each transient's best start, within
    ``POP_MAP_F64[True]["plain"]`` (0.5) of the term scale of the float64
    plain ascent's MAP, in float64 -log p. The JAX package's float32 ascent
    does not follow: on the same population at S = 64 (its
    ``fit_population(init="map")`` under float32 compute on the CPU, these
    starts substituted for its draw) each transient's best seeded walker
    lay a median 2.27 and at worst 38.4 of the term scale below the float64
    MAP, its float64 run within 1.6e-4 (the seeding's jitter band)."""
    cs = _chip_smoke()
    S = 8
    lcs, models, _ = cs.pop_example(S, "cpu")
    priors, lo, up = cs.pop_priors(sigma=True)
    bounds = tpop.BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
    x0 = np.random.default_rng(27).uniform(lo, up, size=(S, cs.POP_STARTS, len(lo)))
    u0 = torch.as_tensor(bounds.to_unbounded(x0))
    best = {}
    for label in ("f32", "f64"):
        _set_dtype(label)
        pp = tpop.PopulationPosterior(tpop.pack_population(models, lcs, True, "cpu"), models[0],
                                      priors, True)
        u, neg = kpop.map_ascent_plain(pp, u0, bounds, cs.POP_ITER)
        k = torch.argmin(torch.where(torch.isfinite(neg), neg, torch.full_like(neg, np.inf)), 1)
        best[label] = bounds.to_bounded(u[torch.arange(S), k])
    pp64 = pp
    ref = pp64.plain(best["f64"][:, None])[:, 0]
    gap = (ref - pp64.plain(best["f32"][:, None])[:, 0]) / pp64.term_scales(best["f64"][:, None])[:, 0]
    assert bool(torch.isfinite(ref).all())
    assert float(gap.abs().max()) <= cs.POP_MAP_F64[True]["plain"], gap


@pytest.fixture(scope="module")
def fits():
    """tests/test_population.py's map-seeded run (S = 8, 16 walkers, 60 +
    150 steps, seed 3) in both packages, the port's with summaries."""
    jl, tl = _shifted()
    jm, tm = _models(jl, tl)
    jpri, tpri = _priors(3)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=16, nsteps=150, nsteps_burnin=60, seed=3,
              init="map")
    jflat, jacc = jpop.fit_population(jm, jl, jpri, **kw)
    before = dict(kernels.LAUNCHES)
    tflat, tacc, summ = tpop.fit_population(tm, tl, tpri, summaries=True, device="cpu", **kw)
    assert kernels.LAUNCHES == before                # the CPU runs the plain versions
    return (np.asarray(jflat), np.asarray(jacc)), (tflat, tacc, summ), (jl, tl, jm, tm)


def test_fit_population_recovers_and_matches_jax(fits):
    (jflat, jacc), (tflat, tacc, summ), _ = fits
    assert tflat.shape == jflat.shape == (len(TRUTHS), 150 * 16, 3)
    assert tflat.dtype == np.float64 and np.isfinite(tflat).all()
    assert np.all(tacc > 0.1)
    for s, (T1, L1, ttr, t0) in enumerate(TRUTHS):
        med = np.median(tflat[s], axis=0)
        assert med[0] == pytest.approx(T1, rel=0.2), s
        assert med[1] == pytest.approx(L1, rel=0.3), s
        q_t = np.percentile(tflat[s], [16, 50, 84], axis=0)
        q_j = np.percentile(jflat[s], [16, 50, 84], axis=0)
        sig = 0.5 * (q_j[2] - q_j[0])
        assert np.all(np.abs(q_t[1] - q_j[1]) <= sig), (s, q_t[1], q_j[1], sig)
        ratio = (q_t[2] - q_t[0]) / (q_j[2] - q_j[0])
        assert np.all((ratio > 0.6) & (ratio < 1.7)), (s, ratio)
    assert abs(float(np.mean(tacc)) - float(np.mean(jacc))) < 0.02


def test_fit_population_summaries_are_the_chains_percentiles(fits):
    _, (tflat, tacc, summ), _ = fits
    assert summ.shape == (len(TRUTHS), 3, 3)
    host = np.moveaxis(np.percentile(tflat, [16.0, 50.0, 84.0], axis=1), 0, -1)
    np.testing.assert_allclose(summ, host, rtol=1e-12, atol=0.0)


def test_fit_population_f32_state_without_chains():
    """The float32 rescaled state (the CUDA default): summaries from the
    f32 q-space chains by K5's plain version, mapped to absolute values,
    equal to the host percentiles of the returned chains; return_chains=False
    gives the same summaries and acceptance."""
    jl, tl = _shifted(4)
    _, tm = _models(jl, tl)
    _, tpri = _priors(3)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=16, nsteps=40, nsteps_burnin=40, seed=4,
              state_dtype=np.float32, device="cpu")
    flat, acc, summ = tpop.fit_population(tm, tl, tpri, summaries=True, **kw)
    assert flat.dtype == np.float64 and np.all(acc > 0.05)
    host = np.moveaxis(np.percentile(flat, [16.0, 50.0, 84.0], axis=1), 0, -1)
    np.testing.assert_allclose(summ, host, rtol=1e-6, atol=1e-9)
    flat2, acc2, summ2 = tpop.fit_population(tm, tl, tpri, summaries=True, return_chains=False,
                                             **kw)
    assert flat2 is None
    np.testing.assert_array_equal(summ2, summ)
    np.testing.assert_array_equal(acc2, acc)


def test_fit_population_errors_as_jax_raises_them():
    jl, tl = _shifted(2)
    jm, tm = _models(jl, tl)
    jpri, tpri = _priors(3)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=8, nsteps=4, nsteps_burnin=2)
    for fn, m, lcs, pri, extra in ((jpop.fit_population, jm, jl, jpri, {}),
                                   (tpop.fit_population, tm, tl, tpri, {"device": "cpu"})):
        with pytest.raises(ValueError, match="summaries"):
            fn(m, lcs, pri, return_chains=False, **kw, **extra)
        with pytest.raises(ValueError, match='init must be "window" or "map"'):
            fn(m, lcs, pri, init="laplace", **kw, **extra)
    flat, acc, summ = tpop.fit_population(tm, tl, tpri, summaries=True, device="cpu",
                                          **dict(kw, nsteps=0))
    assert flat.shape == (2, 0, 3) and np.all(acc == 0) and np.isnan(summ).all()


@pytest.mark.parametrize("what", ["mesh", "checkpoint_every", "checkpoint_file", "resume_from",
                                  "kde_on_cuda", "model", "model_on_cuda", "no_cuda"])
def test_refusals_name_their_roadmap_items(what, monkeypatch):
    jl, tl = _shifted(2)
    _, tm = _models(jl, tl)
    _, tpri = _priors(3)
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=8, nsteps=4, nsteps_burnin=2, device="cpu")
    if what in ("mesh", "checkpoint_every", "checkpoint_file", "resume_from"):
        kw[what] = {"mesh": object(), "checkpoint_every": 2}.get(what, "pop.ckpt")
        item = "item 17" if what == "mesh" else "item 16"
        with pytest.raises(NotImplementedError, match=item):
            tpop.fit_population(tm, tl, tpri, **kw)
    elif what == "kde_on_cuda":
        pri = tpri[:2] + [TK(np.random.default_rng(0).normal(40.0, 3.0, 200), 5.0, 100.0)]
        pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], pri)
        with pytest.raises(NotImplementedError, match="item 21"):
            kpop._params(pp, 3, None, None)
    elif what == "model":
        # the CPU fits a population of any class the JAX function takes
        flat, acc = tpop.fit_population([TSC(lc) for lc in tl], tl,
                                        _bounded(SC_POP_BOUNDS, "port"),
                                        **dict(kw, p_lo=SC_POP_LO, p_up=SC_POP_UP))
        assert flat.shape == (2, 4 * 8, 4) and np.isfinite(flat).all() and acc.shape == (2,)
        with pytest.raises(ValueError, match="4 to 5"):
            tpop.fit_population([TSC(lc) for lc in tl], tl, tpri, **kw)
    elif what == "model_on_cuda":
        # the device check, as fit_population and the refit entry checks call
        # it (no card needed): CUDA's kernels take SC2, SC and SC4, P3 SC2 alone
        cuda = torch.device("cuda")
        for m in (tmodels.ShockCooling3(tl[0]), tmodels.CompanionShocking(tl[0]),
                  tmodels.CompanionShocking2(tl[0]), tmodels.CompanionShocking3(tl[0])):
            with pytest.raises(NotImplementedError, match="item 10"):
                tpop.check_model_class(m, cuda)
            tpop.check_model_class(m, "cpu", "map")
        for m in (TSC(tl[0]), tmodels.ShockCooling4(tl[0])):
            with pytest.raises(NotImplementedError, match="item 22"):
                tpop.check_model_class(m, cuda, "map")
            with pytest.raises(NotImplementedError, match="item 22"):
                tpop.check_model_class(m, None, "map")
            tpop.check_model_class(m, cuda, "window")
            tpop.check_model_class(m, "cpu", "map")
        tpop.check_model_class(tm[0], cuda, "map")
        with pytest.raises(NotImplementedError, match="takes ShockCooling2"):
            tpop.check_model_class(tmodels.Model(), "cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpop.fit_population(tm, tl, tpri, **dict(kw, device=None))


def _diag_chains(n=4, sigma=False):
    rng = np.random.default_rng(0)
    M = 64
    flat = np.stack([np.asarray(t[:3]) + 0.01 * rng.normal(size=(M, 3)) for t in TRUTHS[:n]])
    flat[2] = flat[2] + np.array([8.0, 3.0, 30.0])      # badly wrong parameters
    if sigma:
        flat = np.concatenate([flat, np.full((n, M, 1), 0.7)], axis=2)
    return flat


@pytest.mark.parametrize("sigma", [None, "relative", "absolute"])
def test_population_goodness_of_fit_matches_jax(sigma):
    jl, tl = _shifted(4)
    jm, tm = _models(jl, tl)
    kw = dict(use_sigma=sigma is not None, sigma_type=sigma or "relative", n_draws=48, seed=1,
              quiet=True)
    flat = _diag_chains(4, sigma is not None)
    want = jpop.population_goodness_of_fit(jm, jl, flat, **kw)
    got = tpop.population_goodness_of_fit(tm, tl, flat, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in ("dof", "n_points", "n_invalid_draws"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("chi2", "chi2_nu", "p_value"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-300)
    assert got["p_value"][2] < 1e-6


@pytest.mark.parametrize("sigma", [None, "absolute"])
def test_population_information_criteria_and_compare_match_jax(sigma):
    jl, tl = _shifted(3)
    jm, tm = _models(jl, tl)
    rng = np.random.default_rng(1)
    flat = np.stack([np.asarray(t[:3]) + 0.02 * rng.normal(size=(96, 3)) for t in TRUTHS[:3]])
    if sigma:
        flat = np.concatenate([flat, rng.uniform(0.3, 0.9, (3, 96, 1))], axis=2)
    kw = dict(use_sigma=sigma is not None, sigma_type=sigma or "relative", n_draws=80, seed=0,
              quiet=True)
    want = jpop.population_information_criteria(jm, jl, flat, **kw)
    got = tpop.population_information_criteria(tm, tl, flat, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in ("n_points", "n_high_pareto_k", "n_invalid_draws"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("elpd_loo", "se_elpd_loo", "p_loo", "elpd_waic", "se_elpd_waic", "p_waic"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=0.0)
    for s in range(3):
        np.testing.assert_allclose(got["pointwise"][s], want["pointwise"][s], rtol=1e-10)
        np.testing.assert_allclose(got["pareto_k"][s], want["pareto_k"][s], rtol=1e-8, atol=1e-10)
    # the survey comparison of two families (the second a shifted copy)
    shift = {"pointwise": [p - 0.5 * (s == 1) for s, p in enumerate(got["pointwise"])]}
    shift_j = {"pointwise": [p - 0.5 * (s == 1) for s, p in enumerate(want["pointwise"])]}
    c_t = tpop.population_compare_elpd([got, shift], ["A", "B"], quiet=True)
    c_j = jpop.population_compare_elpd([want, shift_j], ["A", "B"], quiet=True)
    assert sorted(c_t) == sorted(c_j)
    for k in c_j:
        if k == "labels":
            assert c_t[k] == c_j[k]
        else:
            np.testing.assert_allclose(np.asarray(c_t[k], float), np.asarray(c_j[k], float),
                                       rtol=1e-12, atol=1e-12)


def test_population_compare_elpd_is_the_jax_table():
    """tests/test_population.py's synthetic families, through both packages,
    with a transient skipped for a missing family score."""
    rng = np.random.default_rng(0)
    base = [rng.normal(-2.0, 0.3, 12) for _ in range(4)]
    ic_a = {"pointwise": [base[0], base[1], base[2] - 2.0, base[3]]}
    ic_b = {"pointwise": [base[0] - 2.0, base[1] - 2.0, base[2], None]}
    got = tpop.population_compare_elpd([ic_a, ic_b], ["A", "B"], quiet=True)
    want = jpop.population_compare_elpd([ic_a, ic_b], ["A", "B"], quiet=True)
    assert list(got["best"]) == [0, 0, 1] and list(got["skipped"]) == [3]
    for k in want:
        if k != "labels":
            np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                       rtol=1e-12, atol=1e-12)
    for bad in ([ic_a], [ic_a, {"pointwise": [base[0]]}]):
        with pytest.raises(ValueError):
            tpop.population_compare_elpd(bad, ["A", "B"], quiet=True)


def example_population(S):
    """examples/fit_population.py's synthetic population of S transients
    (default_rng(0); 6 filters, 4-7 epochs each) in the JAX package (the
    port's twin: ``chip_smoke.pop_example``); returns (lcs, models,
    truths)."""
    rng = np.random.default_rng(0)
    filters = [jfd[n] for n in ["U", "B", "V", "g", "r", "i"]]
    lcs, models, truths = [], [], []
    for _ in range(S):
        T1, L1, ttr = rng.uniform(8.0, 20.0), rng.uniform(1.0, 4.0), rng.uniform(25.0, 50.0)
        truths.append((T1, L1, ttr))
        n_epochs = rng.integers(4, 8)
        t = np.repeat(np.linspace(1.0, 8.0, n_epochs), len(filters))
        f = np.array(filters * n_epochs)
        y_true = JSC2()(t, f, T1, L1, ttr, 0.0)
        dy = 0.05 * y_true
        lc = JLC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
        lcs.append(lc)
        models.append(JSC2(lc))
    return lcs, models, np.array(truths)


def jax_example_fit(S, seed=1):
    """The JAX package's fit of examples/fit_population.py at its defaults
    (64 walkers, 100 + 500 steps, init="map" with 16 starts x 400 Adam
    steps, seed 1) on S transients, float64 on the CPU: the mean
    acceptance over the transients, its standard error over them, and the
    transients whose T_1 median lies within 20% of the truth and whose L_1
    median lies within 30% (tests/test_population.py's criteria), from
    the summaries. ``chip_smoke.py`` holds the port's run to it."""
    lcs, models, truths = example_population(S)
    priors = [JU(1.0, 50.0), JU(0.1, 20.0), JU(5.0, 100.0)]
    _, acc, summ = jpop.fit_population(models, lcs, priors, p_lo=P_LO, p_up=P_UP, nwalkers=64,
                                       nsteps=500, nsteps_burnin=100, seed=seed, init="map",
                                       summaries=True, return_chains=False)
    med = summ[:, :, 1]
    ok = (np.abs(med[:, 0] - truths[:, 0]) < 0.2 * truths[:, 0]) & \
        (np.abs(med[:, 1] - truths[:, 1]) < 0.3 * truths[:, 1])
    return float(np.mean(acc)), float(np.std(acc, ddof=1) / np.sqrt(S)), int(ok.sum()), \
        float(np.min(acc))


# ------------------------------------------------- populations of other classes

SN2016BKV = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                         "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
D_L = 10 ** (30.79 / 5 + 1) / 1e6
# each class's priors and walker window on its light curve (SN 2016bkv's
# early curve; the synthetic Ia curve for CompanionShocking 1-3), t_exp fitted
# (tests/test_torch_shock_cooling.py, test_torch_companion.py, chip_smoke.py)
SC_BOUNDS = [(0.1, 20.0), (0.1, 30.0), ("log", 0.01, 100.0), (0.01, 50.0), (57468.0, 57468.7)]
CS2_BOUNDS = [(57815.0, 57825.0), (0.01, 5.0), (0.1, 10.0), (57835.0, 57845.0), (0.6, 1.6),
              (-5.0, 5.0), (-5.0, 5.0)]
CLASS_SETUP = {
    "ShockCooling2": ([(0.0, 100.0)] * 3 + [(57468.0, 57468.7)],
                      ([20.0, 2.0, 20.0, 57468.5], [50.0, 5.0, 50.0, 57468.7])),
    "ShockCooling": (SC_BOUNDS, ([0.5, 0.5, 0.1, 0.1, 57468.3], [10.0, 20.0, 10.0, 20.0, 57468.7])),
    "ShockCooling4": (SC_BOUNDS,
                      ([0.5, 0.5, 0.1, 0.1, 57468.3], [10.0, 20.0, 10.0, 20.0, 57468.7])),
    "ShockCooling3": ([(0.0, 10.0), (0.0, 10.0), (0.0, 100.0), (0.0, 100.0),
                       (D_L - 0.01, D_L + 0.01), (0.0, 1.0), (57468.0, 57468.7)],
                      ([0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5],
                       [2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7])),
    "CompanionShocking": (CS2_BOUNDS[:5] + [(0.1, 10.0)] * 3,
                          ([57818.0, 0.2, 0.5, 57838.0, 0.8, 0.8, 0.8, 0.8],
                           [57822.0, 1.0, 2.0, 57842.0, 1.2, 1.2, 1.2, 1.2])),
    "CompanionShocking2": (CS2_BOUNDS, ([57818.0, 0.2, 0.5, 57838.0, 0.8, -1.0, -1.0],
                                        [57822.0, 1.0, 2.0, 57842.0, 1.2, 1.0, 1.0])),
    "CompanionShocking3": (CS2_BOUNDS[:2] + [(0.0, 180.0)] + CS2_BOUNDS[3:],
                           ([57818.0, 0.2, 0.0, 57838.0, 0.8, -1.0, -1.0],
                            [57822.0, 1.0, 90.0, 57842.0, 1.2, 1.0, 1.0])),
}


def _bounded(bounds, package):
    mods = jmodels if package == "jax" else tmodels
    return [mods.LogUniformPrior(*b[1:]) if b[0] == "log" else mods.UniformPrior(*b)
            for b in bounds]


def _class_population(name):
    """Three ragged transients of ``name``'s light curve (every third row, or
    epoch, from the s-th, the later ones cut short), in both packages,
    each with its model (the port's from the JAX one's numbers,
    ``interop.model_from_jax``): (JAX curves, port curves, JAX models, port
    models)."""
    if name.startswith("CompanionShocking"):
        from test_companion_shocking import make_ia_lc
        whole = make_ia_lc(seed=3)[0]
        col = "lum"
    else:
        whole = JLC.read(SN2016BKV)
        whole.meta.update(META)
        whole.calcAbsMag()
        whole.calcLum()
        whole = whole.where(MJD_min=57468.0, MJD_max=57485.0)
        col = "lum"
        if name == "ShockCooling3":
            whole.calcFlux()
            col = "flux"
    rows = np.arange(len(whole))
    # SN 2016bkv's rows in turn; the Ia curve's epochs in turn (its rows are
    # an epoch's six bands)
    per = len({f.name for f in whole["filter"]}) if name.startswith("Companion") else 1
    jl, tl = [], []
    for s, cut in enumerate((0, 4, 9)):
        idx = rows[(rows // per) % 3 == s]
        idx = idx[:len(idx) - cut]
        lc = whole[idx]
        jl.append(JLC([np.asarray(lc["MJD"], float), np.asarray(lc["filter"]),
                       np.asarray(lc[col], float), np.asarray(lc["d" + col], float)],
                      names=["MJD", "filter", col, "d" + col]))
        tl.append(TLC([np.asarray(lc["MJD"], float),
                       np.array([tfd[f.name] for f in lc["filter"]]),
                       np.asarray(lc[col], float), np.asarray(lc["d" + col], float)],
                      names=["MJD", "filter", col, "d" + col]))
    bands = {frozenset(f.name for f in lc["filter"]) for lc in jl}
    assert len(bands) == 1 or not name.startswith("Companion"), bands
    jm = [getattr(jmodels, name)(lc) for lc in jl]
    tm = [interop.model_from_jax(m, lc) for m, lc in zip(jm, tl)]
    return jl, tl, jm, tm


def _poison(jp, tp, e):
    """Transient e's model value made +inf (or NaN) at its last real point,
    and so at its padded copies, in both packs: the band table's constant
    term lifted by 1e30, or, on the quadrature path, its weights inf."""
    n = int(np.asarray(jp["mask"])[e].sum())
    key = "bb_coeffs" if "bb_coeffs" in jp["quad"] else "weights"
    a = np.array(jp["quad"][key])
    if key == "bb_coeffs":
        a[e, n - 1:, 0] = 1e30
    else:
        a[e, n - 1:] = np.inf
    jp["quad"] = dict(jp["quad"], **{key: jnp.asarray(a)})
    tp["quad"] = dict(tp["quad"], **{key: torch.as_tensor(a)})


@pytest.mark.parametrize("use_sigma", [False, True])
@pytest.mark.parametrize("name", list(CLASS_SETUP))
def test_plain_logpost_of_every_class_matches_jax(name, use_sigma):
    """The plain P1 of each class the JAX function takes against the rebuilt
    make_logpost, float64 (1e-12 relative), on three ragged transients, the
    second of which has a non-finite model value at its last real point (-inf
    at every walker in both packages); t_exp fitted, 10% of the walkers
    outside the priors."""
    bounds, (lo, up) = CLASS_SETUP[name]
    sig = [(0.0, 5.0)] if use_sigma else []
    jpri, tpri = _bounded(bounds + sig, "jax"), _bounded(bounds + sig, "port")
    jl, tl, jm, tm = _class_population(name)
    jp = jpop.pack_population(jm, jl)
    tp = tpop.pack_population(tm, tl, device="cpu")
    _poison(jp, tp, 1)
    rng = np.random.default_rng(7)
    W = 12
    p = rng.uniform(lo, up, size=(3, W, len(lo)))
    if use_sigma:
        p = np.concatenate([p, rng.uniform(0.01, 2.0, size=(3, W, 1))], axis=-1)
    p[rng.random((3, W)) < 0.1, 1] = -1.0
    _, jfn = _jax_logpost(jp, jm[0], jpri, use_sigma, "relative")
    want = jfn(p)
    pp = tpop.PopulationPosterior(tp, tm[0], tpri, use_sigma)
    assert pp.family == {"ShockCooling2": "sc2", "ShockCooling": "sc",
                         "ShockCooling4": "sc4"}.get(name)
    got = kpop.log_posterior(pp, torch.as_tensor(p)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want)) and not np.isnan(got).any()
    assert np.isneginf(got[1]).all()
    fin = np.isfinite(want)
    assert fin[[0, 2]].mean() > 0.6
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("name", ["ShockCooling", "ShockCooling4"])
def test_p2_step_over_sw17_and_msw23_under_the_jax_draws(name):
    """One step (h = 0, then 1) of the plain P2 over SW17 and MSW23
    populations under the JAX step's own draws, each transient its own
    ensemble (t_exp fitted): states exact, log-posteriors within 1e-12, the
    accept counts and the chain slot written."""
    bounds, (lo, up) = CLASS_SETUP[name]
    jpri, tpri = _bounded(bounds, "jax"), _bounded(bounds, "port")
    jl, tl, jm, tm = _class_population(name)
    jp = jpop.pack_population(jm, jl)
    make, _ = _jax_logpost(jp, jm[0], jpri, False, "relative")
    S, half, ndim = 3, 8, len(lo)
    x0 = np.random.default_rng(2).uniform(lo, up, size=(S, 2, half, ndim))
    keys = jr.split(jr.PRNGKey(5), S)
    x_want, lp_want = [], []
    draws = {k: np.empty((S, 2, half), dtype=np.int64 if k == "j" else np.float64)
             for k in ("u_z", "j", "u_acc")}
    for s in range(S):
        lp = make(*[jp[k][s] for k in ("t", "y", "dy", "mask", "yscale")],
                  {k: v[s] for k, v in jp["quad"].items()})
        step, batched = make_stretch_kernel(lp, half, ndim)
        xs = jnp.asarray(x0[s])
        (xn, ln), _ = step((xs, batched(xs.reshape(-1, ndim)).reshape(2, half)), keys[s])
        x_want.append(np.asarray(xn))
        lp_want.append(np.asarray(ln))
        for h, kh in enumerate(jr.split(keys[s])):
            kz, kj, ku = jr.split(kh, 3)
            draws["u_z"][s, h] = np.asarray(jr.uniform(kz, (half,), dtype=jnp.float64))
            draws["j"][s, h] = np.asarray(jr.randint(kj, (half,), 0, half))
            draws["u_acc"][s, h] = np.asarray(jr.uniform(ku, (half,), dtype=jnp.float64))
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0], tpri)
    x = torch.as_tensor(x0).contiguous()
    logp = kpop.log_posterior(pp, x.reshape(S, 2 * half, ndim)).reshape(S, 2, half)
    n_acc = torch.zeros((S, 2, half), dtype=torch.int32)
    cx, cl = torch.empty_like(x), torch.empty_like(logp)
    u_z, j, u_acc = (torch.as_tensor(draws[k]) for k in ("u_z", "j", "u_acc"))
    for h in (0, 1):
        kpop.stretch_half_step(pp, x, logp, h, u_z, j, u_acc, 2.0, None, None, cx, cl, n_acc)
    assert 0 < int(n_acc.sum()) < 2 * S * half
    assert np.array_equal(x.numpy(), np.stack(x_want))
    np.testing.assert_allclose(logp.numpy(), np.stack(lp_want), rtol=1e-12, atol=0.0)
    assert torch.equal(cx, x) and torch.equal(cl, logp)


class _FakeCuda:
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel branch up to the C call."""

    def __init__(self, t):
        self.t, self.shape, self.dtype, self.ndim = t, t.shape, t.dtype, t.dim()
        self.device = torch.device("cuda", 0)

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("name", ["ShockCooling2", "ShockCooling", "ShockCooling4",
                                  "CompanionShocking2"])
def test_population_kernels_reach_their_c_calls(name, monkeypatch):
    """On a CUDA tensor P1 and P2 launch the class's C entry (population.cu
    over ShockCooling2, pop_sc.cu over SW17 and MSW23) with the class's
    model field and constants in the parameter block, counting one launch
    under the family's name and one under its form's; P3 over SW17 and
    MSW23 refuses (item 22), a class without kernels refuses (item 10)."""
    from lightcurve_fitting_tpu_torch.kernels import build, gradient
    bounds, (lo, up) = CLASS_SETUP[name]
    _, tl, _, tm = _class_population(name)
    pp = tpop.PopulationPosterior(tpop.pack_population(tm, tl, device="cpu"), tm[0],
                                  _bounded(bounds, "port"))
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def launch(*args):
                P = kpop._PopParams.from_address(args[0])
                calls.append((fn, P.model, P.kappa, P.eps_T, P.t_br_0, args[-2]))
                return 0
            return launch
    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(gradient, "sm_count", lambda dev: 132)
    monkeypatch.setattr(kpop, "check", lambda *a: None)
    monkeypatch.setattr(kpop, "cuda_args", lambda dev: (0, 0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    for k in list(kernels.LAUNCHES):
        monkeypatch.setitem(kernels.LAUNCHES, k, 0)
    S, W, ndim = 3, 8, len(lo)
    q = _FakeCuda(torch.zeros((S, W, ndim)))
    x = _FakeCuda(torch.zeros((S, 2, W // 2, ndim)))
    draws = torch.zeros((S, 2, W // 2))
    n_acc = torch.zeros((S, 2, W // 2), dtype=torch.int32)
    family = {"ShockCooling2": "sc2", "ShockCooling": "sc", "ShockCooling4": "sc4"}.get(name)
    if family is None:
        with pytest.raises(NotImplementedError, match="item 10"):
            kpop.log_posterior(pp, q)
        assert not calls and not any(kernels.LAUNCHES.values())
        return
    with pytest.raises(ValueError, match="not 'thread'"):
        kpop.log_posterior(pp, q, form="thread")
    kpop.log_posterior(pp, q)
    kpop.stretch_half_step(pp, x, draws.double(), 0, draws, draws.long(), draws, n_accept=n_acc,
                           check_partners=False, form="warp")
    entry, count = {"sc2": ("pop", "pop"), "sc": ("pop_sc", "pop_sc"),
                    "sc4": ("pop_sc", "pop_sc4")}[family]
    model = {"sc2": 0, "sc": 1, "sc4": 2}[family]
    consts = tm[0].kernel_constants()
    for (fn, m, kappa, eps_T, t_br_0, form), want in zip(
            calls, (f"{entry}_logpost_launch", f"{entry}_half_step_launch")):
        assert fn == want and m == model
        assert kappa == consts.get("kappa", 0.0) and eps_T == consts.get("eps_T", 0.0)
        assert t_br_0 == consts.get("t_br_0", 0.0)
    assert [c[-1] for c in calls] == [1, 0]   # 3 x 8 walkers: the latency form; then the warp
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        f"{count}_logpost": 1, f"{count}_logpost_latency": 1, f"{count}_half_step": 1,
        f"{count}_half_step_warp": 1}
    u0 = _FakeCuda(torch.zeros((S, 4, ndim), dtype=torch.float64))
    bounds_t = tpop.BoundsTransform([p.p_min for p in pp.priors], [p.p_max for p in pp.priors])
    if family != "sc2":
        with pytest.raises(NotImplementedError, match="item 22"):
            kpop.map_ascent(pp, u0, bounds_t, 10)


# the SW17 and MSW23 surveys of chip_smoke.py 31: examples/fit_population.py's
# generator with the class's truths (v_s*, M_env, f_rho M, R) drawn from this
# box, where both curves are finite and positive over days 1-8 (t_exp = 0),
# and examples/compare_models.py's priors and window without t_0
SC_BOX = ([1.0, 1.0, 0.5, 1.0], [5.0, 10.0, 5.0, 10.0])
SC_POP_BOUNDS = SC_BOUNDS[:4]
SC_POP_LO, SC_POP_UP = [0.5, 0.5, 0.1, 0.1], [10.0, 20.0, 10.0, 20.0]


def sc_example_population(name, S):
    """examples/fit_population.py's synthetic population of S transients
    (default_rng(0); 6 filters, 4-7 epochs over days 1-8, 5% errors) from
    the JAX package's ``name`` (ShockCooling or ShockCooling4), each truth
    drawn uniformly from SC_BOX (the port's twin: ``chip_smoke.sc_pop_example``);
    returns (lcs, models, truths)."""
    rng = np.random.default_rng(0)
    filters = [jfd[n] for n in ["U", "B", "V", "g", "r", "i"]]
    Model = getattr(jmodels, name)
    lcs, models, truths = [], [], []
    for _ in range(S):
        truth = rng.uniform(*SC_BOX)
        truths.append(truth)
        n_epochs = rng.integers(4, 8)
        t = np.repeat(np.linspace(1.0, 8.0, n_epochs), len(filters))
        f = np.array(filters * n_epochs)
        y_true = Model()(t, f, *truth, 0.0)
        dy = 0.05 * y_true
        lc = JLC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
        lcs.append(lc)
        models.append(Model(lc))
    return lcs, models, np.array(truths)


def _port_population(jl, name):
    tl = [_to_port(lc) for lc in jl]
    return tl, [getattr(tmodels, name)(lc) for lc in tl]


SC_FIT = dict(p_lo=SC_POP_LO, p_up=SC_POP_UP, nwalkers=64, nsteps=300, nsteps_burnin=300,
              seed=1, init="window")


def test_fit_population_over_shockcooling_matches_jax():
    """A CPU fit of a ShockCooling (SW17) survey, 32 transients of the
    generator above, 64 walkers x 300 + 300 steps from the window: every
    chain finite, the mean acceptance within 0.01 of the JAX package's run
    of the same call (other random streams: the same distribution; over
    seeds 1-6 the two differed by 0.0076 at most, by 0.004 in the spread,
    where 32 walkers x 100 + 400 steps on 24 transients differed by up to
    0.014: the mean over transients is led by a few whose chains are still
    contracting)."""
    jl, jm, _ = sc_example_population("ShockCooling", 32)
    tl, tm = _port_population(jl, "ShockCooling")
    _, jacc = jpop.fit_population(jm, jl, _bounded(SC_POP_BOUNDS, "jax"), **SC_FIT)
    before = dict(kernels.LAUNCHES)
    tflat, tacc = tpop.fit_population(tm, tl, _bounded(SC_POP_BOUNDS, "port"), device="cpu",
                                      **SC_FIT)
    assert kernels.LAUNCHES == before
    assert tflat.shape == (32, 300 * 64, 4) and np.isfinite(tflat).all()
    assert abs(float(np.mean(tacc)) - float(np.mean(jacc))) < 0.01, (np.mean(tacc),
                                                                       np.mean(jacc))


def jax_sc_example_fit(name, S):
    """The JAX package's fit of ``name``'s survey (:func:`sc_example_population`)
    at examples/fit_population.py's 64 walkers x 100 + 500 steps, from the
    window (init="window"), seed 1, float64 on the CPU: the mean acceptance,
    its standard error over the transients and the least acceptance.
    ``chip_smoke.py`` 31 holds the port's run to it."""
    lcs, models, _ = sc_example_population(name, S)
    _, acc = jpop.fit_population(models, lcs, _bounded(SC_POP_BOUNDS, "jax"), p_lo=SC_POP_LO,
                                 p_up=SC_POP_UP, nwalkers=64, nsteps=500, nsteps_burnin=100,
                                 seed=1, init="window")
    acc = np.asarray(acc)
    return float(np.mean(acc)), float(np.std(acc, ddof=1) / np.sqrt(S)), float(np.min(acc))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_population.py [S ...]: the JAX
    # package's float64 CPU reference of chip_smoke.py's population path
    import sys
    import time
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if sys.argv[1:2] in (["ShockCooling"], ["ShockCooling4"]):
        # ... tests/test_torch_population.py ShockCooling [S]: chip_smoke.py's
        # SC_POP_REF (phase 31)
        t0 = time.perf_counter()
        print(f"{sys.argv[1]}: (mean acceptance, its standard error over the transients, least "
              f"acceptance) = {jax_sc_example_fit(sys.argv[1], int((sys.argv[2:] or [64])[0]))} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        sys.exit()
    for S in [int(a) for a in sys.argv[1:]] or [64]:
        t0 = time.perf_counter()
        print(f"S={S}: (mean acceptance, its standard error over the transients, transients "
              f"recovered, least acceptance) = {jax_example_fit(S)} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
