"""The port's native host kernels (``lightcurve_fitting_tpu_torch/utils/native``)
against the JAX package's and against the port's own numpy binning.

* the port builds its library from its own copy of ``lcf_native.cpp``, into
  a directory that ``.gitignore`` lists, and names no path of the JAX
  package;
* its ``binflux_native`` on SN 2016bkv's columns equals the JAX package's bit
  for bit (the same C++ code, built the same way);
* its native and numpy paths (``lightcurve._seeded_groups`` and
  ``_merge_bin``) agree to 1e-12 relative: the twin of
  ``tests/test_native.py::test_binflux_native_matches_numpy``. They differ
  in the last bits, which is why the bolometric path holds the native
  packing: on SN 2016bkv's bolometric bins the C++ loop's values are, bit
  for bit, its own operations in its own order (``1 / (d * d)``, sums one
  point at a time, the weighted sum fused into multiply-adds where g++
  fuses it, ``1 / sqrt``), and :func:`native_fallback_trace` counts which
  of them move the numpy path's bits (``PYTHONPATH=. python
  tests/test_torch_native.py``; PERF.md).

The JAX package's library is loaded through :func:`jax_native_loaded`,
which every port test that compares with the JAX package's binning calls
first (see its docstring for why).
"""

import math
import os
import threading
from fractions import Fraction

import numpy as np
import pytest

from lightcurve_fitting_tpu.utils import native as jnative

from lightcurve_fitting_tpu_torch import lightcurve as tlightcurve
from lightcurve_fitting_tpu_torch.lightcurve import LC as TLC
from lightcurve_fitting_tpu_torch.utils import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lightcurve_fitting_tpu_torch")
EXAMPLE = os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv")


def _ignored_dirs():
    """The directories ``.gitignore`` lists by path (lines ending in /)."""
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = [ln.strip() for ln in f]
    return {os.path.normpath(os.path.join(REPO, ln)) for ln in lines
            if ln.endswith("/") and not ln.startswith("#")}


_JAX_LIB = os.path.join(os.path.dirname(tnative._LIB_PATH), "jax_liblcf_native.so")
_jax_lock = threading.Lock()


def jax_native_loaded():
    """The JAX package's native library, complete and loaded in this process.

    The JAX loader compiles ``liblcf_native.so`` with g++ straight to its
    final path at first use. Under ``pytest -n`` another worker that loads
    the library while g++ writes it reads a partial (at first empty) file:
    its ``CDLL`` fails, and the loader's ``_tried`` flag keeps the native
    path off in that process for good, so ``LC.bin`` there falls back to the
    numpy path, whose last bits differ from the port's native ones. Here the
    JAX loader's own ``_build`` compiles the JAX source into a file of this
    process, renamed into the port's build directory, and the JAX loader
    loads that file (its path pointed there for the one call): no process
    reads a file that another is writing. Nothing in the JAX package
    changes."""
    with _jax_lock:
        if jnative._lib is None:
            if (not os.path.exists(_JAX_LIB)
                    or os.path.getmtime(_JAX_LIB) < os.path.getmtime(jnative._SRC)):
                os.makedirs(os.path.dirname(_JAX_LIB), exist_ok=True)
                tmp = f"{_JAX_LIB}.{os.getpid()}.tmp"
                _with_jax_lib_path(tmp, jnative._build)
                os.replace(tmp, _JAX_LIB)
            jnative._tried = False
            _with_jax_lib_path(_JAX_LIB, jnative._load)
    return jnative


def _with_jax_lib_path(path, fn):
    """``fn()`` with the JAX loader's library path set to ``path``."""
    saved = jnative._LIB_PATH
    jnative._LIB_PATH = path
    try:
        return fn()
    finally:
        jnative._LIB_PATH = saved


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_loaded()


def test_the_port_builds_its_own_native_source():
    """_SRC is the port's copy, the library is built beside the CUDA
    kernels' in a directory .gitignore lists, and native.py names no path
    inside the JAX package."""
    src = os.path.realpath(tnative._SRC)
    assert src.startswith(os.path.realpath(PORT) + os.sep) and os.path.isfile(src)
    assert os.path.normpath(os.path.dirname(tnative._LIB_PATH)) in _ignored_dirs()
    with open(os.path.join(PORT, "utils", "native.py")) as f:
        code = f.read()
    assert '"lightcurve_fitting_tpu"' not in code and "lightcurve_fitting_tpu/" not in code
    assert tnative.available(), "the native library did not build (g++ missing?)"
    assert os.path.isfile(tnative._LIB_PATH)


def _sn2016bkv_columns():
    """SN 2016bkv's (MJD, flux, dflux, bad) columns, each (filter, source)
    group in the order LC.bin takes them, and the whole curve."""
    lc = TLC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002)
    lc.calcFlux()
    groups = [lc] + list(lc.group_by(["filter", "source"]).groups)
    out = []
    for g in groups:
        t = np.asarray(g["MJD"], float)
        f = np.asarray(g["flux"], float)
        d = np.ma.filled(np.ma.MaskedArray(g["dflux"]).astype(float), np.nan)
        bad = np.isin(d, tlightcurve._SENTINEL_DFLUX) | np.isnan(d)
        out.append((t, f, np.where(bad, 1.0, d), bad))
    return out


@pytest.mark.parametrize("delta", [0.3, np.inf], ids=["0.3d", "inf"])
def test_binflux_native_is_the_jax_packages_on_sn2016bkv(delta):
    """The port's binflux_native on SN 2016bkv's columns equals the JAX
    package's bit for bit, at LC.bin's default window and at the bolometric
    path's (one bin a group)."""
    assert tnative.available() and jnative.available()
    for t, f, d, bad in _sn2016bkv_columns():
        for include_zero in (True, False):
            got = tnative.binflux_native(t, f, d, bad, delta, include_zero)
            want = jnative.binflux_native(t, f, d, bad, delta, include_zero)
            for g, w in zip(got, want):
                assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.filterwarnings("ignore:Mean of empty slice:RuntimeWarning")
@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
@pytest.mark.filterwarnings("ignore:divide by zero:RuntimeWarning")
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("include_zero", [True, False])
def test_binflux_native_matches_the_numpy_path(seed, include_zero):
    """The port's native binning against its numpy path (the fallback of
    ``lightcurve.binflux``) on tests/test_native.py's inputs: 500 points,
    30 bad error bars (0, 999, NaN), 0.3-day bins; within 1e-12 relative,
    NaN where the other gives NaN."""
    rng = np.random.default_rng(seed)
    n = 500
    time = np.sort(rng.uniform(0, 30, n))
    flux = rng.normal(100, 10, n)
    dflux = rng.uniform(0.5, 3.0, n)
    bad_idx = rng.choice(n, 30, replace=False)
    dflux[bad_idx[:10]] = 0.0
    dflux[bad_idx[10:20]] = 999
    dflux[bad_idx[20:]] = np.nan
    bad = np.isin(dflux, tlightcurve._SENTINEL_DFLUX) | np.isnan(dflux)
    got = tnative.binflux_native(time, flux, np.where(bad, 1.0, dflux), bad, 0.3, include_zero)
    with np.errstate(divide="ignore", invalid="ignore"):
        bins = [tlightcurve._merge_bin(np.ma.MaskedArray(time)[idx], np.ma.MaskedArray(flux)[idx],
                                       np.ma.MaskedArray(dflux)[idx], include_zero)
                for idx in tlightcurve._seeded_groups(time, 0.3)]
    want = [np.array(col, float) for col in zip(*bins)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True)


def _seq(xs):
    total = 0.0
    for x in xs:
        total = total + float(x)
    return total


def _c_loop_bin(t, f, d, fused):
    """One bin of ``lcf_binflux`` (every error bar good) in Python floats, in
    the C++ loop's operations and order; ``fused``: its weighted sum as
    multiply-adds (exact products, one rounding each)."""
    w = [1.0 / (float(x) * float(x)) for x in d]
    wf = 0.0
    for wi, fi in zip(w, f):
        wf = float(Fraction(wi) * Fraction(float(fi)) + Fraction(wf)) if fused else \
            wf + wi * float(fi)
    sw = _seq(w)
    return _seq(t) / len(t), wf / sw, 1.0 / math.sqrt(sw)


def _bolometric_bins():
    """The (time, flux, dflux) of every bin that SN 2016bkv's bolometric
    packing (``chip_smoke.sn2016bkv_packed`` on the CPU) hands to
    ``binflux``."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    calls = []
    binflux = tlightcurve.binflux

    def recording(time, flux, dflux, delta=0.2, include_zero=True):
        calls.append(tuple(np.ma.MaskedArray(c).astype(float) for c in (time, flux, dflux))
                      + (delta, include_zero))
        return binflux(time, flux, dflux, delta, include_zero)
    tlightcurve.binflux = recording
    try:
        chip_smoke.sn2016bkv_packed("cpu")
    finally:
        tlightcurve.binflux = binflux
    return calls


def native_fallback_trace():
    """Which of the C++ loop's operations move the numpy path's bits on SN
    2016bkv's bolometric bins: counts of the bins, those of more than one
    point, and of the time, flux and dflux values that differ, each by the
    first numpy operation that, put in the C++ form, gives the native bits
    (``wsum ** -0.5``, the weights ``dflux ** -2``, the unfused weighted
    sum, numpy's pairwise time sum)."""
    out = dict(bins=0, multi=0, time=0, flux=0, dflux=0, dflux_by_rsqrt=0, dflux_by_weights=0,
               flux_by_weights=0, flux_by_fusion=0, time_by_pairwise_sum=0)
    for t, f, d, delta, include_zero in _bolometric_bins():
        dd = np.ma.filled(d, np.nan)
        bad = np.isin(dd, tlightcurve._SENTINEL_DFLUX) | np.isnan(dd)
        nt, nf, nd = tnative.binflux_native(np.ma.getdata(t), np.ma.getdata(f),
                                            np.where(bad, 1.0, dd), bad, delta, include_zero)
        for k, idx in enumerate(tlightcurve._seeded_groups(t, delta)):
            pt, pf, pd = tlightcurve._merge_bin(t[idx], f[idx], d[idx], include_zero)
            out["bins"] += 1
            out["multi"] += len(idx) > 1
            tt, ff, ee = (np.asarray(c[idx], float) for c in (t, f, d))
            w = 1.0 / (ee * ee)
            if pt != nt[k]:
                out["time"] += 1
                out["time_by_pairwise_sum"] += _seq(tt) / len(tt) == nt[k]
            if pd != nd[k]:
                out["dflux"] += 1
                if float(w.sum() ** -0.5) == nd[k]:
                    out["dflux_by_weights"] += 1
                else:
                    out["dflux_by_rsqrt"] += 1
            if pf != nf[k]:
                out["flux"] += 1
                if _c_loop_bin(tt, ff, ee, False)[1] == nf[k]:
                    out["flux_by_weights"] += 1
                else:
                    out["flux_by_fusion"] += 1
    return out


def test_native_binning_is_its_own_operations_on_sn2016bkv():
    """Each of SN 2016bkv's bolometric bins: the native time, flux and dflux
    equal the C++ loop's operations redone in Python floats (the weighted
    sum fused or not, as g++ built it), and the numpy fallback differs from
    them in the last bits somewhere (the packing holds the native bits)."""
    assert tnative.available()
    calls = _bolometric_bins()
    assert len(calls) > 100
    moved = 0
    for t, f, d, delta, include_zero in calls:
        tt, ff, ee = (np.ma.getdata(c) for c in (t, f, d))
        assert not np.isin(ee, tlightcurve._SENTINEL_DFLUX).any() and np.isfinite(ee).all()
        got = tnative.binflux_native(tt, ff, ee, np.zeros(len(tt), bool), delta, include_zero)
        assert all(len(g) == 1 for g in got)          # one bin a call (delta = inf)
        got = tuple(float(g[0]) for g in got)
        assert got in (_c_loop_bin(tt, ff, ee, True), _c_loop_bin(tt, ff, ee, False))
        moved += got != tuple(tlightcurve._merge_bin(t, f, d, include_zero))
    assert moved > 0


if __name__ == "__main__":
    for key, value in native_fallback_trace().items():
        print(f"{key}: {value}")
