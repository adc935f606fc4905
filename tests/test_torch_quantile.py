"""The port's counting-bisection percentiles (``ops/quantile.py``, the plain
version of K5) against the JAX package's ``percentile_f32``, on the CPU.

Inputs are made from a seed with numpy and go through both packages.
Tolerances: the order statistics are identical (bit for bit, the sign of
zero included: both find the same int32 key); the float64 interpolation
between them within 1e-13 relative (the two frameworks round the same
three operations); non-float32 input goes to ``torch.quantile`` and
``jnp.percentile``, which agree within 1e-13 relative. K5's edge cases
(``chip_smoke.K5_EDGE_CASES``, which the card holds K5 to bit for bit) are
held here the same way, but for subnormal values: the JAX function flushes
them to zero (its docstring), so there the order statistics are held to
numpy's sort and the percentiles to the JAX function's where neither is
subnormal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lightcurve_fitting_tpu.ops import quantile as jq  # noqa: E402

from lightcurve_fitting_tpu_torch.ops import quantile as tq  # noqa: E402

import chip_smoke  # noqa: E402  (run from the repository's root)

Q = [16.0, 50.0, 84.0]


def _rows(seed, n_rows, n):
    """float32 rows with ties, signed zeros, infinities and tiny values."""
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=10.0, size=(n_rows, n)).astype(np.float32)
    a[0, : n // 2] = 3.0                                    # a half-tied row
    a[1, ::3] = 0.0
    a[1, 1::3] = -0.0                                       # signed zeros
    a[2, :4] = [np.inf, -np.inf, np.inf, 1e-30]
    a[3] = np.round(a[3])                                   # many ties
    a[4] = np.abs(a[4])
    return a


def _both(a, q, axis):
    want = np.asarray(jq.percentile_f32(jnp.asarray(a), q, axis=axis))
    got = tq.percentile_f32(torch.as_tensor(a), q, axis=axis).numpy()
    return got, want


@pytest.mark.parametrize("n", [64, 65, 3200], ids=["even", "odd", "bench"])
def test_percentiles_match_jax(n):
    """16/50/84 over rows with ties, +-0.0, +-inf, an even and an odd N:
    the same order statistics, the interpolation within 1e-13."""
    a = _rows(n, 6, n)
    got, want = _both(a, Q, axis=1)
    assert got.shape == want.shape == (3, 6) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("n", [64, 101])
def test_order_statistics_identical(n):
    """Percentiles whose rank is an integer return an order statistic
    itself: bit-identical to the JAX package's and to numpy's sort."""
    a = _rows(7 + n, 6, n)
    q = [100.0 * k / (n - 1) for k in (0, 1, n // 2, n - 2, n - 1)]
    got, want = _both(a, q, axis=1)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    ref = np.sort(a.astype(np.float64), axis=1)[:, [0, 1, n // 2, n - 2, n - 1]].T
    # numpy's sort ties -0.0 with +0.0; q * (n - 1) / 100 is not always an
    # exact integer, so +-inf brackets interpolate to nan in both packages
    comparable = (ref != 0) & np.isfinite(ref)
    assert np.array_equal(got[comparable], ref[comparable])


def _integer_ranks(n):
    """Percentiles whose rank over n values is an exact integer (the first,
    the middle and the last order statistic), and those ranks."""
    ranks = sorted({0, n // 2, n - 1})
    q = np.array([100.0 * k / (n - 1) if n > 1 else 50.0 for k in ranks])
    h = (n - 1) * q / 100.0
    keep = h == np.floor(h)
    return list(q[keep]), list(h[keep].astype(np.int64))


@pytest.mark.parametrize("name", [c for c in chip_smoke.K5_EDGE_CASES if c != "long"])
def test_k5_edge_rows_match_jax(name):
    """K5's edge cases but the 70000-value row (the card's global-memory
    branch, the same arithmetic): +-0.0 and +-inf, subnormals, an all-equal
    row, N = 1, 2 and 3201, one and eight percentiles, 0 and 100. The
    percentiles within 1e-13 of the JAX function's, the order statistics
    (integer ranks) bit for bit, and equal to numpy's sort. Subnormals
    flush to zero in the JAX function, so in that case only the order
    statistics are held bit for bit (to numpy's sort), and the percentiles
    to the JAX function's where neither side is subnormal."""
    rows, q = chip_smoke.k5_edge_case(name)
    n = rows.shape[1]
    got, want = _both(rows, q, axis=1)
    assert got.shape == want.shape == (len(q), rows.shape[0]) and got.dtype == np.float64
    q_os, ranks = _integer_ranks(n)
    os_got, os_want = _both(rows, q_os, axis=1)
    ref = np.sort(rows.astype(np.float64), axis=1)[:, ranks].T
    # numpy's sort ties -0.0 with +0.0 (the keys order them), and an
    # infinite order statistic interpolates to nan (inf + 0 x nan)
    comparable = (ref != 0) & np.isfinite(ref)
    assert np.array_equal(os_got[comparable], ref[comparable])
    if name == "subnormal":
        tiny = np.finfo(np.float32).tiny
        assert (np.abs(os_got[comparable]) < tiny).any()      # the case holds subnormals
        normal = ~((np.abs(got) < tiny) & (got != 0)) & ~((np.abs(want) < tiny) & (want != 0))
        normal &= ~((want == 0) & (got != 0))                  # flushed by the JAX function
        np.testing.assert_allclose(got[normal], want[normal], rtol=1e-13, atol=0.0)
    else:
        assert np.array_equal(os_got.view(np.int64), os_want.view(np.int64))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0, equal_nan=True)


def test_leading_axis_and_batch_shape():
    """axis=0 over a (N, 2, 3) array gives (Q, 2, 3), as the JAX function."""
    a = np.random.default_rng(3).normal(size=(40, 2, 3)).astype(np.float32)
    got, want = _both(a, Q, axis=0)
    assert got.shape == want.shape == (3, 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0.0)
    np.testing.assert_allclose(got, np.percentile(a.astype(np.float64), Q, axis=0),
                               rtol=1e-13, atol=0.0)


def test_float64_goes_to_quantile():
    a = np.random.default_rng(4).normal(size=(5, 33))
    got, want = _both(a, Q, axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_sortable_key_is_order_isomorphic():
    """The int32 key orders floats totally (-inf < -x < -0.0 < +0.0 < x <
    inf) and maps back to the same bits, as the JAX helpers."""
    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    k = tq._sortable_key(torch.as_tensor(x))
    assert np.array_equal(k.numpy(), np.asarray(jq._sortable_key(jnp.asarray(x))))
    assert bool((k[1:] > k[:-1]).all())
    back = tq._key_to_f32(k).numpy()
    assert np.array_equal(back.view(np.int32), x.view(np.int32))


def test_plain_version_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        tq.percentile_f32_plain(torch.zeros(4, dtype=torch.float64), Q)


def test_empty_rows_give_nan():
    out = tq.percentile_f32(torch.zeros((2, 0), dtype=torch.float32), Q, axis=1)
    assert out.shape == (3, 2) and bool(torch.isnan(out).all())
    jax_out = np.asarray(jq.percentile_f32(jnp.zeros((2, 0), jnp.float32), Q, axis=1))
    assert jax_out.shape == (3, 2) and np.isnan(jax_out).all()
