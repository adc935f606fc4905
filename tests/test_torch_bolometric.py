"""The port's bolometric pipeline (``bolometric.py``) against the JAX
package's, on the CPU: the host estimators, and
``calculate_bolometric(batch_mode=True, save_corners=False)`` over SN 2016bkv
MJD 57468-57474 (four epochs of 5-9 bands), with its refusals.

The same light curve, read from the same file, goes through both packages.
Tolerances, each with its reason:
- host helpers (numpy/scipy copies): 1e-12 relative; the port's
  ``planck_fast`` rounds in torch, numpy's in XLA;
- the curve_fit columns ``temp``/``radius``/``L``: rtol 1e-6 (the optimizer
  stops at its own tolerance, so last-bit differences in the model move
  the optimum far below it);
- the MCMC columns: the criterion of tests/test_bolometric.py:168-177,
  |a - b| < 2 sigma + 0.1 |a| with sigma the JAX run's 16-84 width (the
  random streams of the two packages differ);
- grouping, record layout, ``L_int``, colors: equal (same host code), the
  SED rows compared in one canonical order (``_canonical``);
- the packed SN 2016bkv epochs under two hash seeds: equal bits.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu import bolometric as jbol  # noqa: E402
from lightcurve_fitting_tpu.lightcurve import LC as JLC  # noqa: E402

from lightcurve_fitting_tpu_torch import bolometric as tbol, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC  # noqa: E402

from test_torch_native import jax_native_loaded  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
RUN = dict(res=1.0, nwalkers=10, burnin_steps=150, steps=100, seed=7, save_corners=False,
           batch_mode=True, colors=["B-V", "g-r"])


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX package's binning on its native path, as the port's
    (test_torch_native.jax_native_loaded)."""
    jax_native_loaded()


def _lc(LC):
    lc = LC.read(EXAMPLE)
    lc.meta.update(META)
    return lc.where(MJD_min=57468.0, MJD_max=57474.0)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    out = tmp_path_factory.mktemp("bol")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_j = jbol.calculate_bolometric(_lc(JLC), outpath=str(out / "j"), mesh=False, **RUN)
        before = dict(kernels.LAUNCHES)
        t_t = tbol.calculate_bolometric(_lc(TLC), outpath=str(out / "t"), device="cpu",
                                        save_chains=True, **RUN)
        assert kernels.LAUNCHES == before                # the CPU runs the plain versions
    return t_j, t_t, out


def test_host_helpers_match_jax():
    for T, R in ((8.0, 10.0), (25.0, 1.5)):
        assert tbol.pseudo(T, R, 0.01) == pytest.approx(jbol.pseudo(T, R, 0.01), rel=1e-12)
        assert tbol.stefan_boltzmann(T, R) == pytest.approx(jbol.stefan_boltzmann(T, R),
                                                            rel=1e-15)
    got = tbol.stefan_boltzmann(10.0, 5.0, 1.0, 0.5, 0.1)
    np.testing.assert_allclose(got, jbol.stefan_boltzmann(10.0, 5.0, 1.0, 0.5, 0.1), rtol=1e-15)
    x = np.random.default_rng(0).normal(10.0, 2.0, size=501)
    assert tbol.median_and_unc(x) == jbol.median_and_unc(x)
    mjd = np.array([57468.9, 57469.1, 57470.95, 57471.02, 57473.5])
    assert np.array_equal(tbol._snap_to_grid(mjd, 1.0), jbol._snap_to_grid(mjd, 1.0))
    assert np.array_equal(tbol._pseudo_grid(), jbol._pseudo_grid())
    chain = np.abs(np.random.default_rng(1).normal([9.0, 4.0], [0.5, 0.3], size=(400, 2)))
    rec_t, rec_j = tbol._mcmc_record(chain, 0.002, np.inf), jbol._mcmc_record(chain, 0.002, np.inf)
    summ = np.abs(np.random.default_rng(2).normal(5.0, 1.0, size=(4, 3)))
    sum_t, sum_j = tbol._summary_record(summ), jbol._summary_record(summ)
    for got, want in ((rec_t, rec_j), (sum_t, sum_j)):
        assert got.keys() == want.keys() == set(tbol._MCMC_FIELDS)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def _canonical(epoch1):
    """The row order of an epoch's SED sorted by (filter name, source, MJD).
    The port bins by the sorted group keys; the JAX package by a set's
    order, which follows PYTHONHASHSEED, so rows are compared in this order."""
    return np.lexsort((np.asarray(epoch1["MJD"], float),
                       np.asarray(epoch1["source"]).astype(str),
                       np.array([f.name for f in epoch1["filter"]])))


def test_epoch_grouping_and_seds_match_jax():
    g_t = tbol._prepare_epoch_seds(_lc(TLC), 1.0, ())
    g_j = jbol._prepare_epoch_seds(_lc(JLC), 1.0, ())
    assert len(g_t) == len(g_j) > 3
    for a, b in zip(g_t, g_j):
        ia, ib = _canonical(a), _canonical(b)
        assert [a["filter"][i].name for i in ia] == [b["filter"][i].name for i in ib]
        for col in ("MJD", "lum", "dlum", "freq"):
            np.testing.assert_allclose(np.asarray(a[col], float)[ia],
                                       np.asarray(b[col], float)[ib], rtol=1e-12)
    lst_t = tbol.blackbody_lstsq(g_t[-1], 0.002)
    lst_j = jbol.blackbody_lstsq(g_j[-1], 0.002)
    np.testing.assert_allclose(lst_t, lst_j, rtol=1e-6)
    assert tbol.integrate_sed(g_t[-1]) == pytest.approx(jbol.integrate_sed(g_j[-1]), rel=1e-12)


def test_calculate_bolometric_batch_matches_jax(tables):
    t_j, t_t, _ = tables
    assert len(t_t) == len(t_j) == 4
    assert t_t.colnames == t_j.colnames
    assert list(np.asarray(t_t["filts"])) == list(np.asarray(t_j["filts"]))
    for col in ("MJD", "dMJD0", "dMJD1", "npoints", "L_int", "B-V", "d(B-V)", "g-r"):
        np.testing.assert_allclose(np.asarray(t_t[col], float), np.asarray(t_j[col], float),
                                   rtol=1e-12, equal_nan=True)
    for col in ("temp", "radius", "L", "L_bol"):
        np.testing.assert_allclose(np.asarray(t_t[col], float), np.asarray(t_j[col], float),
                                   rtol=1e-6)
    for col in ("temp_mcmc", "radius_mcmc"):
        a = np.asarray(t_j[col], float)
        b = np.asarray(t_t[col], float)
        sig = np.asarray(t_j[f"d{col}0"], float) + np.asarray(t_j[f"d{col}1"], float)
        assert np.isfinite(b).all()
        assert np.all(np.abs(a - b) < 2.0 * sig + 0.1 * np.abs(a))
    for col in ("L_mcmc", "L_bol_mcmc"):
        a = np.asarray(t_j[col], float)
        b = np.asarray(t_t[col], float)
        sig = np.asarray(t_j[f"d{col}0"], float) + np.asarray(t_j[f"d{col}1"], float)
        assert np.all(np.abs(a - b) < 2.0 * sig + 0.1 * np.abs(a))
    for old, _ in tbol.DEPRECATED_BOLOMETRIC_COLNAMES:
        assert old in t_t.colnames


def test_save_chains_writes_each_epoch(tables):
    _, t_t, out = tables
    files = sorted(os.listdir(out / "t"))
    assert files == sorted(f"{m:.3f}.npy" for m in np.asarray(t_t["MJD"], float))
    chain = np.load(out / "t" / files[0])
    assert chain.shape == (RUN["steps"] * RUN["nwalkers"], 2) and np.isfinite(chain).all()


def test_do_mcmc_false_masks_the_mcmc_columns():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = tbol.calculate_bolometric(_lc(TLC).where(MJD_min=57470.0, MJD_max=57471.0),
                                      do_mcmc=False, save_corners=False, batch_mode=True,
                                      device="cpu")
    assert len(t) == 1 and np.isfinite(float(t["temp"][0]))
    assert np.ma.is_masked(t["temp_mcmc"][0])


@pytest.mark.parametrize("kwargs,match", [
    (dict(batch_mode=True), "item 18"),
    (dict(batch_mode=True, save_corners=False, show=True), "item 18"),
    (dict(batch_mode=True, save_corners=False, mesh=object()), "item 17"),
], ids=["corners", "show", "mesh"])
def test_refusals(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        tbol.calculate_bolometric(_lc(TLC), device="cpu", **kwargs)


# Packs the 65 epochs of >= 3 filters of SN 2016bkv by chip_smoke.sn2016bkv_packed,
# on the CPU, importing only the port, and prints a digest of the arrays.
_PACK_DIGEST = """
import hashlib, sys
import chip_smoke
packed = chip_smoke.sn2016bkv_packed("cpu")
assert not any(m == "jax" or m.startswith(("jax.", "lightcurve_fitting_tpu."))
               for m in sys.modules)
h = hashlib.sha256()
for k in ("y", "dy", "nodes", "weights", "mask", "yscale"):
    h.update(k.encode())
    h.update(packed[k].numpy().tobytes())
print(packed["y"].shape[0], h.hexdigest())
"""


def test_packing_is_the_same_under_any_hash_seed():
    """SN 2016bkv's packed epochs have the same bits under PYTHONHASHSEED 1
    and 2, which binned the bands in different orders while ``LC.bin`` took
    its group keys in a set's order."""
    root = os.path.join(os.path.dirname(__file__), "..")
    procs = [subprocess.Popen([sys.executable, "-c", _PACK_DIGEST], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONHASHSEED": str(seed),
                                   "PYTHONPATH": root})
             for seed in (1, 2)]
    digests = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        digests.append(out.split()[-2:])
    assert digests[0] == digests[1] and int(digests[0][0]) == 65
