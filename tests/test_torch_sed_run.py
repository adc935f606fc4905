"""K10's run form on the CPU: its plain version (``kernels/sed.py::
stretch_run_plain``, the plain half-step twice a proposal over stacked
draws), the sampler's routing to it (``kernels.runs_segments``,
``sed.k10_form``) and the stacked draws of a segment, on SN 2016bkv's SEDs.

Tolerances: none. Each check is bit for bit: the run form's plain version
is the sampler's step loop over the same draws, so the states, the
log-posteriors, the accept counts and the chain are the loop's bits. (The
run against the JAX package's scan is in ``test_torch_sed.py``, within 1e-12
relative; the kernel against these plain versions, on the card, in
``chip_smoke.py`` phase 13.)
"""

import os
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu_torch import bolometric as tbol, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import common, sed  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import (KDEPrior, LogUniformPrior,  # noqa: E402
                                                 UniformPrior)
from lightcurve_fitting_tpu_torch.parallel.sampler import EnsembleSampler  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
Z = 0.002


@pytest.fixture(scope="module")
def epochs():
    """The epochs of MJD 57482-57488: 5 and 6 filters, then U alone."""
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=Z)
    lc = lc.where(MJD_min=57482.0, MJD_max=57488.0)
    dmag = np.ma.MaskedArray(lc["dmag"])
    lc = lc[np.isfinite(np.ma.filled(dmag.astype(float), np.nan)) & np.ma.filled(dmag > 0, False)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tbol._prepare_epoch_seds(lc, 1.0, ())


def _posterior(epochs, kde):
    first = KDEPrior(np.random.default_rng(4).normal(10.7, 0.12, 2000)) if kde \
        else UniformPrior(1.0, 100.0)
    return tbol.SEDLogPosterior(epochs[2 if kde else 0], [first, LogUniformPrior(0.01, 1000.0)],
                                Z, device="cpu")


def _state(lp, half, dtype, seed=3):
    x = np.abs(np.array([10.7, 3.6]) * (1 + 0.05 * np.random.default_rng(seed).normal(
        size=(2, half, 2))))
    x = torch.as_tensor(x).to(dtype).contiguous()
    return x, lp.forward_plain(x.reshape(-1, 2)).reshape(2, half)


def _draws(n, half, dtype, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 2, half), generator=g, dtype=dtype),
            torch.randint(0, half, (n, 2, half), generator=g),
            torch.rand((n, 2, half), generator=g, dtype=dtype))


@pytest.mark.parametrize("state", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kde", [False, True], ids=["uniform", "kde"])
@pytest.mark.parametrize("thin_by", [1, 2])
def test_plain_run_is_the_half_step_loop(epochs, thin_by, kde, state):
    """stretch_run_plain over stacked draws equals 2 n plain half-steps on
    the same draws, bit for bit: states, log-posteriors, accept counts and
    the chain, thinned."""
    lp = _posterior(epochs, kde)
    half, n = 5, 6
    u_z, j, u_acc = _draws(n, half, state)
    out = []
    for run in (True, False):
        x, logp = _state(lp, half, state)
        acc = torch.zeros((2, half), dtype=torch.int32)
        cx = torch.empty((n // thin_by, 2, half, 2), dtype=state)
        cl = torch.empty((n // thin_by, 2, half), dtype=torch.float64)
        if run:
            sed.stretch_run_plain(lp, x, logp, u_z, j, u_acc, 2.0, None, None, cx, cl, acc,
                                  thin_by)
        else:
            for s in range(n):
                stored = s % thin_by == thin_by - 1
                for h in (0, 1):
                    sed.stretch_half_step_plain(lp, x, logp, h, u_z[s, h], j[s, h], u_acc[s, h],
                                                2.0, None, None,
                                                cx[s // thin_by] if stored else None,
                                                cl[s // thin_by] if stored else None, acc)
        out.append((x, logp, acc, cx, cl))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert 0 < int(out[0][2].sum()) < 2 * half * n
    assert torch.equal(out[0][3][-1], out[0][0]) and torch.equal(out[0][4][-1], out[0][1])


def test_kernels_stretch_run_routes_the_cpu_to_the_plain_run(epochs):
    lp = _posterior(epochs, True)
    u_z, j, u_acc = _draws(4, 5, torch.float64)
    res = []
    before = dict(kernels.LAUNCHES)
    for fn in (kernels.stretch_run, sed.stretch_run, sed.stretch_run_plain):
        x, logp = _state(lp, 5, torch.float64)
        acc = torch.zeros((2, 5), dtype=torch.int32)
        fn(lp, x, logp, u_z, j, u_acc, 2.0, None, None, None, None, acc)
        res.append((x, logp, acc))
    assert kernels.LAUNCHES == before
    for other in res[1:]:
        for a, b in zip(res[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("half,form", [(1, "run"), (5, "run"), (32, "run"), (33, "half"),
                                       (2048, "half"), (0, "half")])
def test_k10_form_picks_the_run_up_to_a_block(epochs, half, form):
    assert sed.k10_form(half) == form
    assert kernels.runs_segments(_posterior(epochs, False), half) == (form == "run")


def test_models_without_a_run_form_keep_the_half_steps():
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=Z)
    lc.calcAbsMag()
    lc.calcLum()
    lc = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    lp = make_log_posterior(ShockCooling2(lc), lc, [UniformPrior(0.0, 100.0)] * 3
                            + [UniformPrior(57468.0, 57468.7)], device="cpu")
    assert not kernels.runs_segments(lp, 5)


class _NoKernels:
    """A log-posterior whose model has no kernels: a Gaussian, run on the
    CPU only."""

    @property
    def kernel_module(self):
        raise NotImplementedError("no fused CUDA log-posterior")

    def forward_plain(self, p):
        return -0.5 * (p ** 2).sum(-1)


def test_a_model_without_kernels_keeps_the_cpu_loop():
    lp = _NoKernels()
    assert not kernels.runs_segments(lp, 5)
    s = EnsembleSampler(10, 2, lp, seed=3, device="cpu")
    before = dict(kernels.LAUNCHES)
    pos, logp, _ = s.run_mcmc(np.random.default_rng(1).normal(size=(10, 2)), 50)
    assert kernels.LAUNCHES == before and np.isfinite(pos).all()
    assert 0.2 < s.acceptance_fraction.mean() < 0.9


@pytest.mark.parametrize("what,kwargs,match", [
    ("u_z", dict(u_z=torch.zeros((4, 2, 6), dtype=torch.float64)), "u_z has shape"),
    ("j", dict(j=torch.full((4, 2, 5), 5)), "partner indices"),
    ("thin_by", dict(thin_by=0), "thin_by"),
    ("chain", dict(chain_x=torch.zeros((4, 2, 5, 2)), chain_logp=torch.zeros((4, 2, 5)),
                   thin_by=2), "chain_x has shape"),
    ("n_accept", dict(n_accept=None), "needs n_accept"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_run_checks_refuse(what, kwargs, match):
    x = torch.zeros((2, 5, 2), dtype=torch.float64)
    args = dict(x=x, logp=torch.zeros((2, 5), dtype=torch.float64),
                u_z=torch.zeros((4, 2, 5), dtype=torch.float64),
                j=torch.zeros((4, 2, 5), dtype=torch.int64),
                u_acc=torch.zeros((4, 2, 5), dtype=torch.float64), chain_x=None,
                chain_logp=None, n_accept=torch.zeros((2, 5), dtype=torch.int32), thin_by=1,
                check_partners=True)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        common.run_checks(**args)


def test_run_refuses_a_device_other_than_the_cpu_or_cuda(epochs):
    lp = _posterior(epochs, False)
    x = torch.zeros((2, 5, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        sed.stretch_run(lp, x, None, None, None, None)


# ------------------------------------------------------------------ sampler

def _sampler(lp, seed=11):
    return EnsembleSampler(10, 2, lp, seed=seed, device="cpu")


def test_segment_draws_are_the_steps_draws(epochs):
    s = _sampler(_posterior(epochs, False))
    stacked = s._segment_draws(7, 4)
    for k in range(4):
        for a, b in zip(stacked, s._draws(7 + k)):
            assert torch.equal(a[k], b)
    assert [t.shape for t in stacked] == [(4, 2, 5)] * 3


def test_a_run_split_into_segments_equals_one_run(epochs):
    """300 steps in one run_mcmc equal 100 + 200, bit for bit."""
    lp = _posterior(epochs, True)
    x0 = np.abs(np.array([10.7, 3.6]) * (1 + 0.05 * np.random.default_rng(2).normal(
        size=(10, 2))))
    before = dict(kernels.LAUNCHES)
    one, two = _sampler(lp), _sampler(lp)
    pos1, lp1, _ = one.run_mcmc(x0, 300)
    two.run_mcmc(x0, 100)
    pos2, lp2, _ = two.run_mcmc(None, 200)
    assert kernels.LAUNCHES == before
    assert np.array_equal(pos1, pos2) and np.array_equal(lp1, lp2)
    assert np.array_equal(one.get_chain(), two.get_chain())
    assert np.array_equal(one.get_log_prob(), two.get_log_prob())
    assert np.array_equal(one.acceptance_fraction, two.acceptance_fraction)
    assert 0.1 < one.acceptance_fraction.mean() < 0.9


@pytest.mark.parametrize("kde", [False, True], ids=["uniform", "kde"])
def test_spectrum_mcmc_chain_is_the_loops(epochs, tmp_path, monkeypatch, kde):
    """spectrum_mcmc on the CPU through the run form gives the chain of the
    half-step loop it replaces."""
    lp = _posterior(epochs, kde)
    ep = epochs[2 if kde else 0]
    guesses = np.abs(np.random.default_rng(3).normal([10.7, 3.6], 0.3, size=(10, 2)))
    kw = dict(z=Z, nwalkers=10, burnin_steps=30, steps=20, seed=4, make_corner=False,
              device="cpu", outpath=str(tmp_path))
    routed = []
    real = kernels.runs_segments
    monkeypatch.setattr(kernels, "runs_segments",
                        lambda *a: routed.append(real(*a)) or routed[-1])
    before = dict(kernels.LAUNCHES)
    run = tbol.spectrum_mcmc(tbol.planck_fast, ep, lp.priors, guesses, **kw)
    monkeypatch.setattr(kernels, "runs_segments", lambda *a: False)
    loop = tbol.spectrum_mcmc(tbol.planck_fast, ep, lp.priors, guesses, **kw)
    assert routed == [True, True] and kernels.LAUNCHES == before
    assert np.array_equal(run.flatchain, loop.flatchain)
    assert np.array_equal(run.flatlnprobability, loop.flatlnprobability)
    assert np.array_equal(run.acceptance_fraction, loop.acceptance_fraction)
