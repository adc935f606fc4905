"""The port's numpy host layer (lightcurve_fitting_tpu_torch) against the JAX
package's originals: the code is the same, so every array must be
bit-identical (np.array_equal)."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu import filters as jfilters  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402
from lightcurve_fitting_tpu.models import ShockCooling2 as JSC2  # noqa: E402
from lightcurve_fitting_tpu.ops import extinction as jext  # noqa: E402
from lightcurve_fitting_tpu.ops.filterbank import bank_for as jbank_for  # noqa: E402

from lightcurve_fitting_tpu_torch import filters as tfilters  # noqa: E402
from lightcurve_fitting_tpu_torch import interop  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import ShockCooling2 as TSC2  # noqa: E402
from lightcurve_fitting_tpu_torch.ops import extinction as text  # noqa: E402
from lightcurve_fitting_tpu_torch.ops.filterbank import bank_for as tbank_for  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})


def _early(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc, lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def both():
    return _early(JLC), _early(TLC)


def _column_values(col):
    data = np.ma.getdata(col)
    if data.dtype == object:
        return np.array([getattr(v, "name", v) for v in data], dtype=object)
    return data


@pytest.mark.parametrize("which", [0, 1], ids=["full", "early"])
def test_lc_columns_identical(both, which):
    (j_full, j_early), (t_full, t_early) = both
    jlc, tlc = (j_full, t_full) if which == 0 else (j_early, t_early)
    assert jlc.colnames == tlc.colnames
    assert len(tlc) == (len(jlc))
    for name in jlc.colnames:
        a, b = _column_values(jlc[name]), _column_values(tlc[name])
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name
        assert np.array_equal(np.ma.getmaskarray(jlc[name]), np.ma.getmaskarray(tlc[name])), name
    if which == 1:
        assert len(tlc) == 149
        assert len(set(f.name for f in tlc["filter"])) == 9


def test_filter_registry_identical():
    assert sorted(jfilters.filtdict) == sorted(tfilters.filtdict)
    for key, jf in jfilters.filtdict.items():
        tf = tfilters.filtdict[key]
        assert jf.name == tf.name and jf.system == tf.system
        if jf.trans is None:
            assert tf.trans is None
            continue
        for col in ("wl", "T"):
            assert np.array_equal(np.asarray(jf.trans[col]), np.asarray(tf.trans[col]))


def test_extinction_identical():
    wave = np.geomspace(1000.0, 30000.0, 257)
    assert np.array_equal(jext.f99_curve(wave, 3.1), text.f99_curve(wave, 3.1))
    assert np.array_equal(jext.fitzpatrick99(wave, 0.3), text.fitzpatrick99(wave, 0.3))
    freq = np.linspace(100.0, 2000.0, 33)
    assert np.array_equal(jext.extinction_law(freq, [0.1, 0.2]),
                          text.extinction_law(freq, [0.1, 0.2]))


def test_filterbank_and_table_identical(both):
    (_, j_early), (_, t_early) = both
    jb = jbank_for(sorted(set(j_early["filter"])))
    tb = tbank_for(sorted(set(t_early["filter"])))
    assert [f.name for f in jb.filters] == [f.name for f in tb.filters]
    assert np.array_equal(jb.nodes, tb.nodes)
    assert np.array_equal(jb.weights, tb.weights)
    jt = JSC2(j_early).table_for(jb)
    tt = TSC2(t_early).table_for(tb)
    assert jt.deg == tt.deg == 40
    for attr in ("_coef", "_s_a", "_s_b", "T_lo"):
        assert np.array_equal(getattr(jt, attr), getattr(tt, attr)), attr
    ids = np.arange(len(tb))
    coef, s_a, s_b = tt.gather(ids, device="cpu")
    assert coef.dtype == torch.float64 and np.array_equal(coef.numpy(), jt._coef)
    assert np.array_equal(tt.gather(ids, device=False)[1], np.asarray(jt.gather(ids)[1]))


def test_prepare_quad_identical(both):
    (_, j_early), (_, t_early) = both
    jq = JSC2(j_early).prepare_quad(np.asarray(j_early["filter"]))
    tq = TSC2(t_early).prepare_quad(np.asarray(t_early["filter"]))
    assert sorted(jq) == sorted(tq)
    for k in jq:
        assert np.array_equal(np.asarray(jq[k]), tq[k]), k


@pytest.mark.parametrize("use_sigma,sigma_type", [(False, "relative"), (True, "absolute")])
def test_interop_log_likelihood_identical(both, use_sigma, sigma_type):
    (_, j_early), (_, t_early) = both
    jm, tm = JSC2(j_early), TSC2(t_early)
    args = [np.asarray(t_early[c], float) for c in ("MJD", "lum", "dlum")]
    jq = jm.prepare_quad(np.asarray(j_early["filter"]))
    via_jax = interop.log_likelihood_from_numpy(jq, *args, use_sigma=use_sigma,
                                                sigma_type=sigma_type, device="cpu",
                                                dtype=torch.float64)
    own = tm.make_log_likelihood(t_early, use_sigma=use_sigma, sigma_type=sigma_type,
                                 device="cpu")
    for name, buf in own.named_buffers():
        assert np.array_equal(buf.numpy(), getattr(via_jax, name).numpy()), name
    for attr in ("log_norm_const", "offset", "inv_yscale", "t_ref"):
        assert getattr(own, attr) == getattr(via_jax, attr), attr
    with pytest.raises(ValueError):
        interop.log_likelihood_from_numpy(jq, *args, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("fn", ["split_rhat", "rank_normalized_split_rhat",
                                "effective_sample_size", "summarize_chain"])
def test_diagnostics_identical(fn):
    """The port's copy of parallel/diagnostics.py gives the JAX package's
    results bit for bit on random chains, ties and a pinned column
    included."""
    from lightcurve_fitting_tpu.parallel import diagnostics as jdiag
    from lightcurve_fitting_tpu_torch.parallel import diagnostics as tdiag
    rng = np.random.default_rng(5)
    chain = rng.normal(size=(301, 6, 4)).cumsum(axis=0) * [1.0, 0.1, 3.0, 1.0]
    chain[:, :, 3] = np.round(chain[:, :, 3])      # rank ties
    chain[:, 2, 1] = 0.5                           # one pinned chain
    got, want = getattr(tdiag, fn)(chain), getattr(jdiag, fn)(chain)
    if fn == "summarize_chain":
        assert got == want
    else:
        assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("entry", ["make_log_posterior", "lightcurve_mcmc", "lightcurve_map",
                                   "lightcurve_hmc", "lightcurve_evidence",
                                   "calculate_bolometric"])
def test_entry_points_refuse_the_cpu_without_being_asked(both, monkeypatch, entry):
    """device=None means CUDA: with no CUDA every entry-point family raises
    (and names device="cpu") instead of running the plain versions."""
    from lightcurve_fitting_tpu_torch import bolometric, fitting
    from lightcurve_fitting_tpu_torch.core.device import resolve_device
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (t_lc, t_early) = both
    priors = [UniformPrior(0.0, 100.0)] * 3 + [UniformPrior(57468.0, 57468.7)]
    window = dict(p_lo=[20, 2, 20, 57468.5], p_up=[50, 5, 50, 57468.7])
    calls = {
        "make_log_posterior": lambda: fitting.make_log_posterior(TSC2(t_early), t_early, priors),
        "lightcurve_mcmc": lambda: fitting.lightcurve_mcmc(t_early, TSC2(t_early), priors,
                                                           nwalkers=16, nsteps=2,
                                                           nsteps_burnin=2, **window),
        "lightcurve_map": lambda: fitting.lightcurve_map(t_early, TSC2(t_early), priors,
                                                         n_starts=2, n_iter=2, **window),
        "lightcurve_hmc": lambda: fitting.lightcurve_hmc(t_early, TSC2(t_early), priors,
                                                         nchains=2, nsamples=2, n_warmup=2,
                                                         **window),
        "lightcurve_evidence": lambda: fitting.lightcurve_evidence(
            t_early, TSC2(t_early), priors, nwalkers=16, n_rungs=2, nsteps=2, nsteps_burnin=2,
            **window),
        "calculate_bolometric": lambda: bolometric.calculate_bolometric(
            t_lc.copy(), batch_mode=True, save_corners=False),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("cuda") == torch.device("cuda")
