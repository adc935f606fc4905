"""The quadrature band flux of the port against the JAX package, on the CPU:
``ops/mathx.planck_denom_inv``, ``ops/extinction.extinction_factor``,
``models/blackbody`` (planck_lnu, bandflux_pointwise and its plain version,
bandflux_outer, planck_fast, planck, blackbody_to_filters in both modes) and
``ops/filterbank.native_lengths``.

Inputs are made from a seed with numpy and go through both packages.
Tolerances: float64 <= 1e-12 relative per element (same formulas and
operation order: libm rounding of expm1/exp only, and the K-term sum's
order); float32, against the JAX package under
``set_compute_dtype(jnp.float32)``, <= 1e-6 relative (the float32 arguments
of expm1 and exp are computed identically; the two libms differ by an ulp or
two and the 89-term sums in order). T <= 0 and the Wien tail give 0, never
NaN.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from lightcurve_fitting_tpu import filters as jfilters  # noqa: E402
from lightcurve_fitting_tpu.core import config as jconfig  # noqa: E402
from lightcurve_fitting_tpu.models import blackbody as jbb  # noqa: E402
from lightcurve_fitting_tpu.ops import extinction as jext  # noqa: E402
from lightcurve_fitting_tpu.ops import mathx as jmathx  # noqa: E402

from lightcurve_fitting_tpu_torch import filters as tfilters, kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config as tconfig  # noqa: E402
from lightcurve_fitting_tpu_torch.models import blackbody as tbb  # noqa: E402
from lightcurve_fitting_tpu_torch.ops import extinction as text  # noqa: E402
from lightcurve_fitting_tpu_torch.ops import mathx as tmathx  # noqa: E402
from lightcurve_fitting_tpu_torch.ops.filterbank import bank_for, native_lengths  # noqa: E402

BANDS = ["U", "B", "g", "V", "r", "R", "i", "I"]


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and not np.isnan(got).any()
    assert np.all(np.abs(got - want) <= rel * np.abs(want)), \
        np.max(np.abs(got - want) / np.where(want == 0, 1, np.abs(want)))


def _tables(z=0.01):
    """The per-band tables (B, K) of the test bands, per point (N, K) for
    N = 3 points per band, and the band ids."""
    bank = bank_for(tuple(tfilters.filtdict[b] for b in BANDS))
    ids = np.repeat(np.arange(len(BANDS)), 3)
    return bank, ids, bank.gather(ids, z=z, device=False)


def _walkers(W, N, seed):
    """T (kK) and R (1000 Rsun), (W, N), with T <= 0 and Wien-tail entries."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(2.0, 60.0, size=(W, N))
    R = rng.uniform(0.1, 10.0, size=(W, N))
    T[0, :3] = [0.0, -2.0, 1e-3]
    T[1, -1] = 1e-4
    return T, R


def test_planck_denom_inv_and_extinction_factor():
    x = np.array([-3.0, -0.0, 0.0, 1e-9, 1e-3, 0.7, 20.0, 88.0, 710.0, 1e5, np.inf])
    a = np.asarray(jmathx.planck_denom_inv(jnp.asarray(x)))
    b = tmathx.planck_denom_inv(torch.as_tensor(x)).numpy()
    assert not np.isnan(b).any() and np.all(b[[0, 1, 2, -3, -2, -1]] == 0)
    _close(b, a, 1e-12)
    k = np.random.default_rng(0).uniform(0.0, 6.0, size=(5, 7))
    for ebv in (0.0, 0.3, np.linspace(0, 1, 7)):
        _close(text.extinction_factor(torch.as_tensor(k),
                                      torch.as_tensor(ebv, dtype=torch.float64)).numpy(),
               np.asarray(jext.extinction_factor_jax(k, ebv)), 1e-12)


@pytest.mark.parametrize("cutoff", [np.inf, 700.0])
def test_planck_lnu(cutoff):
    rng = np.random.default_rng(1)
    nu = rng.uniform(100.0, 1500.0, size=(6, 1, 9))
    T, R = _walkers(4, 9, 2)
    a = np.asarray(jbb.planck_lnu(jnp.asarray(nu), jnp.asarray(T), jnp.asarray(R), cutoff))
    b = tbb.planck_lnu(torch.as_tensor(nu), torch.as_tensor(T), torch.as_tensor(R),
                       cutoff).numpy()
    assert np.all(b[:, 0, :3] == 0) and np.all(b[:, 1, -1] == 0)
    _close(b, a, 1e-12)


EBV_CASES = {
    "none": None,
    "scalar": 0.2,
    "per_walker": np.random.default_rng(3).uniform(0.0, 1.0, size=(5, 1)),
    "per_point": np.random.default_rng(4).uniform(0.0, 1.0, size=len(BANDS) * 3),
}


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(EBV_CASES))
def test_bandflux_pointwise(case, f32):
    _, ids, (nodes, weights, k_ext) = _tables()
    T, R = _walkers(5, len(ids), 5)
    ebv = EBV_CASES[case]
    kw_j = {} if ebv is None else dict(k_ext=jnp.asarray(k_ext), ebv=jnp.asarray(ebv))
    kw_t = {} if ebv is None else dict(k_ext=torch.as_tensor(k_ext),
                                       ebv=torch.as_tensor(ebv, dtype=torch.float64))
    args_j = [jnp.asarray(a) for a in (nodes, weights, T, R)]
    args_t = [torch.as_tensor(a) for a in (nodes, weights, T, R)]
    before = dict(kernels.LAUNCHES)
    try:
        if f32:
            jconfig.set_compute_dtype(jnp.float32)
            tconfig.set_compute_dtype(torch.float32)
        a = np.asarray(jbb.bandflux_pointwise(*args_j, **kw_j))
        b = tbb.bandflux_pointwise(*args_t, **kw_t)
        plain = tbb.bandflux_pointwise_plain(*args_t, **kw_t)
    finally:
        jconfig.set_compute_dtype(jconfig.AUTO)
        tconfig.set_compute_dtype(tconfig.AUTO)
    assert kernels.LAUNCHES == before           # a CPU tensor runs the plain version
    assert b.dtype == torch.float64 and torch.equal(b, plain)
    assert np.all(b.numpy()[0, :3] == 0) and b.numpy()[1, -1] == 0
    _close(b.numpy(), a, 1e-6 if f32 else 1e-12)


def test_bandflux_pointwise_per_band_tables_equal_per_point():
    """``band_ids`` with (B, K) tables is the per-point gather, exactly."""
    bank, ids, (nodes, weights, k_ext) = _tables()
    T, R = _walkers(3, len(ids), 6)
    ebv = torch.as_tensor(EBV_CASES["per_walker"][:3])
    per_band = tbb.bandflux_pointwise(
        torch.as_tensor(bank.emitted_nodes(0.01)), torch.as_tensor(bank.weights),
        torch.as_tensor(T), torch.as_tensor(R), k_ext=torch.as_tensor(bank.ext_curve(0.01)),
        ebv=ebv, band_ids=torch.as_tensor(ids, dtype=torch.int64))
    per_point = tbb.bandflux_pointwise(
        torch.as_tensor(nodes), torch.as_tensor(weights), torch.as_tensor(T),
        torch.as_tensor(R), k_ext=torch.as_tensor(k_ext), ebv=ebv)
    assert torch.equal(per_band, per_point)


@pytest.mark.parametrize("ebv", [None, 0.15, "per_value"])
def test_bandflux_outer(ebv):
    bank, _, _ = _tables()
    nodes, weights, k_ext = bank.emitted_nodes(0.01), bank.weights, bank.ext_curve(0.01)
    T, R = _walkers(3, 4, 7)
    if ebv == "per_value":
        ebv = np.random.default_rng(8).uniform(0.0, 1.0, size=T.shape)
    kw_j = {} if ebv is None else dict(k_ext=jnp.asarray(k_ext), ebv=jnp.asarray(ebv))
    kw_t = {} if ebv is None else dict(k_ext=torch.as_tensor(k_ext),
                                       ebv=torch.as_tensor(ebv, dtype=torch.float64))
    a = np.asarray(jbb.bandflux_outer(jnp.asarray(nodes), jnp.asarray(weights), jnp.asarray(T),
                                      jnp.asarray(R), **kw_j))
    b = tbb.bandflux_outer(torch.as_tensor(nodes), torch.as_tensor(weights),
                           torch.as_tensor(T), torch.as_tensor(R), **kw_t).numpy()
    assert b.shape == (len(BANDS), 3, 4)
    _close(b, a, 1e-12)


def test_planck_fast_and_planck():
    nu = np.linspace(200.0, 1400.0, 7)
    for T, R in [(12.0, 2.0), (np.array([5.0, 12.0, 0.0]), np.array([1.0, 2.0, 3.0]))]:
        _close(tbb.planck_fast(nu, T, R), jbb.planck_fast(nu, T, R), 1e-12)
        _close(tbb.planck_fast(nu, T, R, 800.0), jbb.planck_fast(nu, T, R, 800.0), 1e-12)
    a = jbb.planck(nu, 12.0, 2.0, dT=0.5, dR=0.1, cov=0.01)
    b = tbb.planck(nu, 12.0, 2.0, dT=0.5, dR=0.1, cov=0.01)
    for x, y in zip(b, a):
        _close(x, y, 1e-12)


@pytest.mark.parametrize("mode", ["pointwise", "pointwise_ebv_per_point", "outer",
                                  "outer_ebv_per_value"])
def test_blackbody_to_filters(mode):
    names = ["g", "r", "i", "B"]
    jf = [jfilters.filtdict[n] for n in names]
    tf = [tfilters.filtdict[n] for n in names]
    rng = np.random.default_rng(9)
    if mode.startswith("pointwise"):
        T, R = rng.uniform(5.0, 30.0, 4), rng.uniform(0.5, 5.0, 4)
        T[1] = -1.0
    else:
        T, R = rng.uniform(5.0, 30.0, (2, 3)), rng.uniform(0.5, 5.0, (2, 3))
    ebv = rng.uniform(0.0, 0.5, T.shape) if mode.endswith(("per_point", "per_value")) else 0.1
    a = jbb.blackbody_to_filters(jf, T, R, z=0.01, ebv=ebv)
    b = tbb.blackbody_to_filters(tf, T, R, z=0.01, ebv=ebv)
    assert b.shape == a.shape == ((4,) if mode.startswith("pointwise") else (4, 2, 3))
    _close(b, a, 1e-12)
    with pytest.raises(Exception, match="same shape"):
        tbb.blackbody_to_filters(tf, T, R[..., :1], z=0.01)


def test_native_lengths():
    bank, ids, (_, weights, _) = _tables()
    n = native_lengths(bank.weights)
    for b, row in enumerate(bank.weights):
        assert n[b] > 0 and row[n[b] - 1] != 0 and not row[n[b]:].any()
    assert np.array_equal(native_lengths(weights), n[ids])
    assert list(native_lengths(np.array([[0.0, 0.0], [0.0, 1.0], [2.0, 0.0]]))) == [0, 2, 1]
