"""The port's public fit driver, ``fitting.lightcurve_mcmc``, against the JAX
package's on the flagship (ShockCooling2, SN 2016bkv), plus its API surface,
the options this slice refuses, and an import check: the port loads no jax.

The chains come from different random streams, so the comparison is
statistical, with the stage-1 criteria of ``__graft_entry__.dryrun_multichip``:
pooled medians within 1 posterior sigma of each other and width ratios in
(0.6, 1.7), sigma being the flagship's converged posterior widths
(VALIDATION.md)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu.fitting import lightcurve_mcmc as j_mcmc  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2, UniformPrior as JU  # noqa: E402

from lightcurve_fitting_tpu_torch import kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import lightcurve_mcmc  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.models import UniformPrior as TU  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.sampler import EnsembleSampler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
BOUNDS = [(0.0, 100.0), (0.0, 100.0), (0.0, 100.0), (57468.0, 57468.7)]
TRUTH_STD = np.array([0.145, 0.053, 0.110, 0.00018])
# the dryrun's window inside the typical set: the comparison then measures the
# posterior, not how far 300 burn-in steps get from a wide start
EQ_LO = [37.2, 5.2, 16.0, 57468.699]
EQ_UP = [38.0, 5.5, 16.5, 57468.7]


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def tlc():
    return _early(TLC)


def _tpriors():
    return [TU(*b) for b in BOUNDS]


def test_fit_matches_jax_statistically(tlc):
    jlc = _early(JLC)
    kw = dict(p_lo=EQ_LO, p_up=EQ_UP, nwalkers=512, nsteps=300, nsteps_burnin=100,
              quiet=True)
    js = j_mcmc(jlc, JSC2(jlc), priors=[JU(*b) for b in BOUNDS], seed=21, shard=False, **kw)
    ts = lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), seed=22, device="cpu", **kw)
    jf, tf = js.flatchain, ts.flatchain
    assert tf.shape == jf.shape == (512 * 300, 4)
    d_med = np.abs(np.median(tf, 0) - np.median(jf, 0)) / TRUTH_STD
    ratio = tf.std(0) / jf.std(0)
    assert np.all(d_med < 1.0), d_med
    assert np.all((ratio > 0.6) & (ratio < 1.7)), ratio
    acc_t, acc_j = np.mean(ts.acceptance_fraction), np.mean(js.acceptance_fraction)
    assert abs(acc_t - acc_j) < 0.01, (acc_t, acc_j)


def test_api_shapes_and_report(tlc, capsys):
    before = dict(kernels.LAUNCHES)
    s = lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), p_lo=[20, 2, 20, 57468.5],
                        p_up=[50, 5, 50, 57468.7], nwalkers=32, nsteps=30, nsteps_burnin=20,
                        seed=7, device="cpu")
    out = capsys.readouterr().out
    assert "mean acceptance fraction" in out and "tau =" in out
    assert isinstance(s, EnsembleSampler)
    assert s.flatchain.shape == (32 * 30, 4)
    assert s.chain.shape == (32, 30, 4)
    assert s.acceptance_fraction.shape == (32,)
    assert s.get_log_prob().shape == (30, 32) and np.isfinite(s.flatlnprobability).all()
    lo, hi = np.array(BOUNDS).T
    assert ((s.flatchain > lo) & (s.flatchain < hi)).all()
    # on the CPU the plain path runs: no kernel launches
    assert kernels.LAUNCHES == before
    # state_dtype=float32 runs the rescaled float32 state of the CUDA path
    s32 = lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), p_lo=[20, 2, 20, 57468.5],
                          p_up=[50, 5, 50, 57468.7], nwalkers=32, nsteps=10,
                          nsteps_burnin=0, seed=7, device="cpu", quiet=True,
                          state_dtype=np.float32)
    assert s32.param_scale is not None and np.isfinite(s32.flatlnprobability).all()
    assert s32.flatchain.shape == (320, 4)


@pytest.mark.parametrize("kw,item", [
    (dict(replicas=2), "item 4"),
    (dict(shard=True), "item 17"),
    (dict(mesh=object()), "item 17"),
    (dict(checkpoint_every=5, checkpoint_file="x.npz"), "item 16"),
    (dict(resume_from="x.npz"), "item 16"),
], ids=["kw0-item 4", "kw1-item 17", "kw2-item 17", "kw4-item 16", "kw5-item 16"])
def test_unsupported_options_raise(tlc, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        lightcurve_mcmc(tlc, TSC2(tlc), priors=_tpriors(), p_lo=[20, 2, 20, 57468.5],
                        p_up=[50, 5, 50, 57468.7], nwalkers=32, nsteps=2, nsteps_burnin=2,
                        seed=0, device="cpu", quiet=True, **kw)


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import lightcurve_fitting_tpu_torch\n"
            "import lightcurve_fitting_tpu_torch.fitting, lightcurve_fitting_tpu_torch.kernels\n"
            "import lightcurve_fitting_tpu_torch.parallel.sampler\n"
            "import lightcurve_fitting_tpu_torch.interop\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightcurve_fitting_tpu'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
