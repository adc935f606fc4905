"""The CUDA kernels of ``lightcurve_fitting_tpu_torch/kernels``: K1, K2
and the gradient path's K7, K9 and K7h (ShockCooling2), K3 (the quadrature
band flux) and the ShockCooling3 log-posterior and half-step built on it;
K4 (the per-epoch blackbody log-posterior and its gradient), K4p (the MAP
centering's Adam polish in one launch), the epoch half-step (a warp per
walker), K4s (the summary rows) and K5 (percentiles) of the batched
bolometric path; K6a-K6d of the
tempered ladder (the tempered half-step and the initial state over
ShockCooling2 and ShockCooling3, the replica exchange, the stepping-stone
block terms).

This file imports neither jax nor the JAX package, so the ``cuda``-marked
tests also run on a machine with the card and no jax:
``python -m pytest --noconftest -q tests/test_torch_kernels.py``. Without a
card they skip: a CUDA kernel has no CPU mode. The CPU tests cover what
surrounds the kernels: the build's failure without nvcc, the ctypes layout
of the parameter block, and the wrappers' routing and input checks.

Tolerances on the card, kernel against its plain PyTorch version on the same
inputs: float32 <= 1e-5 |ll| (the repo's float32 log-likelihood budget; the
kernel fuses multiply-adds and sums the 149 points in another order),
float64 <= 1e-10 |ll|, identical -inf sets; K2's accept flags agree except at
near-ties, and the new states are bit-equal where they agree. For the flux
model ShockCooling3 |ll| is replaced by |ll - c| + |c|, c the normalization
constant added in the compute dtype: near the best fit the residual sum and
c cancel, and float32 rounding scales with the terms, not with their sum
(plain float32 itself is 1e-3 |ll| from float64 there). K3 per point:
float32 <= 1e-5 relative (a sum of up to 89 non-negative float32 terms in
another order, ~89 ulps at worst), float64 <= 1e-12 relative. K4, with
and without intrinsic scatter, within 1e-5 (float32) and 1e-10 (float64) of
its log-posterior's scale and 1e-4 and 1e-9 of its gradient's, the scales of
``EpochPosterior.term_scales``: the summed magnitudes of the pieces that
cancel near an optimum (the rounding follows the pieces, not their sum);
the epoch half-step as K2, its new log-posteriors within 1e-5 (float32) and
1e-10 (float64) of the term scale, and on the CPU its warp sum order
against the plain sum and the JAX package's; K4p against the plain polish
on the card, the same alive set and centers within POLISH_REL, and on the
CPU its Adam step and chain rule bit for bit against CosineAdam and
autograd; K4s's integral float32 <= 1e-5 relative; K5's
percentiles bit-equal to the plain version's. K6a as K2, its log pi and
log L held as K1's; K6b's log pi <= 1e-12 relative and log L as K1's at the
ladders' shapes, each rung its own states and one set written to every
rung (``copies``), and over ShockCooling2 and CompanionShocking2 bit for
bit the values K6a stored at the states it accepted; on the CPU its
``copies`` routing and refusals; K6c
bit-equal at the ladders' shapes and every row length of its template;
K6d float64 <= 1e-12 relative (the sums run in another order), NaN where
the plain version gives NaN (a NaN, a +inf or only -inf in a block), at
block lengths its splits do not divide, two launches bit-equal, and on the
CPU its split rule and refusals. K4's values (the epoch half-step's warp
form, and a thread per vector in the warp's sum order) within K4's
tolerances, the two forms bit-equal to each other and, at the states two
half-steps accepted, to the values the half-step stored; on the CPU the
rule choosing the form and the value path's refusal of other ndims.
K7's values as K1's and its gradients within 1e-4 (float32) and 1e-9
(float64) of the summed magnitudes of their per-point terms; K7's two forms
(a block per row at small widths, a warp per row at large ones) bit-equal
to each other; K9 and K7h (a block per chain)
against their plain transitions under shared draws (float64 over the plain
gradient, float32 over K7's own evaluations), equal except near-ties, and
K9's new log-posteriors equal to K7's at the new states bit for bit (the
block form folds the points in the warp form's order). K2 and K6a over
ShockCooling2 (a warp per walker) at the fits' widths (half 32, 16384,
65536; 7 rungs x half 16, 17 x 2048) in float32 and float64, their
proposals' log-posteriors K7's values (bit for bit), and on the
CPU their sum order against the plain sum and the JAX package's float64
log-posterior. K1, the same warp form, at the fits' widths (64, 4096,
131072), and bit for bit the values K2 stored at the states it accepted
(ndim 4 and 5, float32 and float64). The SC3 half-step,
a warp per walker, as K2 at the fits' widths (half 32, 16384) and 65536;
the SC3 log-posterior, the same warp form, as K1 at the widths of the
fits' initial states (64, 4096, 32768) and 131072, bit for bit the values
the half-step stored on the states it accepted, and on the CPU its sum
order against the plain sum and the JAX package's float64 log-posterior;
the CS log-posterior (a thread per walker) at 32, 2048, 32768 and 131072;
the CS half-step and K6a over CS, a warp per walker, as K2 and K6a at the
fits' widths (half 16, 16384; 7 rungs x half 32, 17 x 2048), CS1 with the
intrinsic scatter beside them.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightcurve_fitting_tpu_torch import kernels  # noqa: E402
from lightcurve_fitting_tpu_torch.core import config  # noqa: E402
from lightcurve_fitting_tpu_torch.fitting import make_log_posterior  # noqa: E402
from lightcurve_fitting_tpu_torch.kernels import (build, common, epoch_bb,  # noqa: E402
                                                  gradient, ladder, sc2, sc3)
from lightcurve_fitting_tpu_torch.kernels import quantile as kquantile  # noqa: E402
from lightcurve_fitting_tpu_torch.lightcurve import LC  # noqa: E402
from lightcurve_fitting_tpu_torch.models import (BaseShockCooling, GaussianPrior,  # noqa: E402
                                                 LogUniformPrior, ShockCooling2, ShockCooling3,
                                                 UniformPrior)
from lightcurve_fitting_tpu_torch.models.blackbody import (  # noqa: E402
    bandflux_pointwise, bandflux_pointwise_plain, planck_lnu)
from lightcurve_fitting_tpu_torch.ops.filterbank import FilterBank  # noqa: E402
from lightcurve_fitting_tpu_torch.ops.quantile import percentile_f32_plain  # noqa: E402
from lightcurve_fitting_tpu_torch.filters import filtdict  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel import batched  # noqa: E402
from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder  # noqa: E402
from lightcurve_fitting_tpu_torch.utils.table import Table  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "lightcurve_fitting_tpu", "data",
                       "SN2016bkv.csv")
P_LO = np.array([20.0, 2.0, 20.0, 57468.5])
P_UP = np.array([50.0, 5.0, 50.0, 57468.7])
OFFSET = (P_LO + P_UP) / 2
SCALE = (P_UP - P_LO) / 2 * (1 + 1e-6)


@pytest.fixture(scope="module")
def lc():
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


@pytest.fixture(scope="module")
def lc_ext():
    """The flagship with its Milky Way extinction, the posterior around
    which _whitened builds its whitening (test_hmc.py's truth)."""
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002, extinction={
        "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
        "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


D_L =10 ** (30.79 / 5 + 1) / 1e6    # Mpc, pinned by the flagship's dm
SC3_LO = np.array([0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5])
SC3_UP = np.array([2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7])
SC3_OFFSET = (SC3_LO + SC3_UP) / 2
SC3_SCALE = (SC3_UP - SC3_LO) / 2 * (1 + 1e-6)


@pytest.fixture(scope="module")
def lc_flux(lc):
    out = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    out.calcFlux()
    return out


def _sc3_priors(t0_hi=57468.7):
    return [UniformPrior(0.0, 10.0), UniformPrior(0.0, 10.0), UniformPrior(0.0, 100.0),
            UniformPrior(0.0, 100.0), UniformPrior(D_L - 0.01, D_L + 0.01),
            UniformPrior(0.0, 1.0), UniformPrior(57468.0, t0_hi)]


def _sc3_walkers(n, seed=0):
    """Init-window walkers, the last rows outside the priors or NaN."""
    p = np.random.default_rng(seed).uniform(SC3_LO, SC3_UP, size=(n, 7))
    p[-4:] = p[:4]
    p[-4, 0], p[-3, 5], p[-2, 6], p[-1, 3] = -1.0, 1.5, 57468.75, np.nan
    return p


def _c_fields(struct):
    """Field names of ``struct`` in the CUDA sources, in order."""
    for path in build._sources()[0]:
        with open(path) as f:
            src = f.read()
        head = f"struct {struct} {{"
        if head in src:
            body = src[src.index(head):src.index("};", src.index(head))]
            return [ln.split(";")[0].split()[-1].split("[")[0].lstrip("*")
                    for ln in body.splitlines()[1:] if ";" in ln]
    raise AssertionError(f"struct {struct} not found")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _priors(t0_hi=57468.7):
    return [UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
            UniformPrior(57468.0, t0_hi)]


def _walkers(n, seed=0):
    """Init-window walkers, the last rows outside the priors or NaN."""
    p = np.random.default_rng(seed).uniform(P_LO, P_UP, size=(n, 4))
    p[-4:] = [[-1.0, 3.0, 30.0, 57468.6], [30.0, 150.0, 30.0, 57468.6],
              [30.0, 3.0, 30.0, 57468.75], [np.nan, 3.0, 30.0, 57468.6]]
    return p


def _assert_ll_close(got, want, rel, const=0.0):
    """Same -inf sets; |got - want| <= rel (|ll - c| + |c|) where finite, c
    the normalization constant added to the residual sum in the compute
    dtype (the float32 rounding scales with both terms, which cancel near
    the best fit of a flux model)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert not np.isnan(got).any()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin] - const) + abs(const)
    assert np.all(np.abs(got[fin] - want[fin]) <= rel * scale)


# ----------------------------------------------------------------- CPU side

def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDACXX", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda path: False if path.endswith("nvcc") else os.path.isfile(path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
    srcs, _ = build._sources()
    assert [os.path.basename(s) for s in srcs] == ["companion.cu", "epoch_bb.cu", "ladder.cu",
                                                   "quantile.cu", "sc2_logpost.cu",
                                                   "sc3_logpost.cu"]


def test_param_block_layout_matches_the_c_struct():
    """Every field of struct SC2Params is 8 bytes wide: 8 pointers, 5 ints,
    9 doubles, then 7 arrays of LP_MAX_DIM = 9 (no padding anywhere)."""
    with open(os.path.join(build.CSRC_DIR, "sc2_logpost.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC_DIR, "stretch.cuh")) as f:
        assert "#define LP_MAX_DIM 9 " in f.read() and sc2.MAX_DIM == 9
    assert ctypes.sizeof(sc2._SC2Params) == 8 * (8 + 5 + 9) + 7 * 9 * 8
    assert "struct SC2Params {" in src
    assert _c_fields("SC2Params") == [name for name, _ in sc2._SC2Params._fields_]


@pytest.mark.parametrize("struct,mirror,size", [
    # 11 pointers, 6 ints, 19 doubles, 7 arrays of LP_MAX_DIM
    ("SC3Params", sc3._SC3Params, 8 * (11 + 6 + 19) + 7 * 9 * 8),
    # 8 pointers, 6 ints, 4 doubles
    ("BandfluxParams", sc3._BandfluxParams, 8 * (8 + 6 + 4)),
])
def test_sc3_param_blocks_match_the_c_structs(struct, mirror, size):
    assert ctypes.sizeof(mirror) == size
    assert _c_fields(struct) == [name for name, _ in mirror._fields_]


def test_wrappers_route_by_device(lc):
    lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device="cpu")
    q = torch.as_tensor(_walkers(16))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(sc2.log_posterior(lp, q), lp.forward_plain(q))
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    with pytest.raises(ValueError, match="K1 runs on CUDA"):
        sc2.log_posterior(lp, torch.empty((4, 4), device="meta"))
    x = torch.empty((2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="K2 runs on CUDA"):
        sc2.stretch_half_step(lp, x, x[..., 0], 0, x[0, :, 0], x[0, :, 0].long(),
                              x[0, :, 0])


def test_sc3_wrappers_route_by_device(lc_flux):
    lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device="cpu")
    q = torch.as_tensor(_sc3_walkers(16))
    x = torch.as_tensor(_sc3_walkers(8)[:, None, :].reshape(2, 4, 7)).contiguous()
    logp = lp.forward_plain(x.reshape(8, 7)).reshape(2, 4)
    u = torch.full((4,), 0.5, dtype=torch.float64)
    j = torch.zeros(4, dtype=torch.int64)
    acc = torch.zeros((2, 4), dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.log_posterior(lp, q), lp.forward_plain(q))
    assert torch.equal(sc3.log_posterior(lp, q), lp.forward_plain(q))
    kernels.stretch_half_step(lp, x, logp, 0, u, j, u, n_accept=acc)
    T = torch.tensor([[5.0, 0.0, -1.0]], dtype=torch.float64)
    nodes = torch.linspace(400.0, 800.0, 12, dtype=torch.float64).reshape(3, 4)
    w = torch.full((3, 4), 0.25, dtype=torch.float64)
    assert torch.equal(bandflux_pointwise(nodes, w, T, T.abs(), k_ext=w, ebv=0.1),
                       bandflux_pointwise_plain(nodes, w, T, T.abs(), k_ext=w, ebv=0.1))
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    meta = torch.empty((4, 7), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        sc3.log_posterior(lp, meta)
    with pytest.raises(ValueError, match="K3 runs on CUDA"):
        bandflux_pointwise(nodes, w, T.to("meta"), T.to("meta"))


def test_cuda_path_refuses_models_without_kernels(lc_flux):
    """A model with no fused kernel raises on a non-CPU tensor before any
    launch: it never runs quietly on a plain path."""
    model = BaseShockCooling(lc_flux)
    lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device="cpu")
    lp.log_likelihood.model = model
    with pytest.raises(NotImplementedError, match="no fused CUDA log-posterior"):
        kernels.module_for(model)
    with pytest.raises(NotImplementedError, match="no fused CUDA log-posterior"):
        kernels.log_posterior(lp, torch.empty((4, 7), device="meta"))
    x = torch.empty((2, 2, 7), device="meta")
    with pytest.raises(NotImplementedError, match="no fused CUDA log-posterior"):
        kernels.stretch_half_step(lp, x, x[..., 0], 0, x[0, :, 0], x[0, :, 0].long(),
                                  x[0, :, 0])
    assert kernels.module_for(ShockCooling3(lc_flux)) is sc3
    assert kernels.module_for(ShockCooling2(lc_flux)) is sc2


def test_sc3_kernel_params_check_ndim(lc_flux):
    lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device="cpu")
    with pytest.raises(ValueError, match="ndim = 7"):
        sc3._kernel_params(lp, 4, None, None)
    P = sc3._kernel_params(lp, 7, SC3_OFFSET, SC3_SCALE)
    ll = lp.log_likelihood
    assert (P.n_points, P.n_bands, P.n_nodes) == (149, 9, 89)
    assert P.has_affine == 1 and P.affine_scale[6] == SC3_SCALE[6]
    assert list(ll.n_native.numpy()) == [12, 10, 88, 14, 4, 74, 52, 88, 42]
    assert P.kappa == 1.0 and P.ext_coef == -0.4 * np.log(10.0)
    assert P.point_order == P._point_order.data_ptr()
    assert torch.equal(P._point_order, sc3.point_order(ll))
    assert sc3._kernel_params(lp, 7, SC3_OFFSET, SC3_SCALE) is P   # cached


def test_sc3_point_order_levels_the_warp_lanes(lc_flux):
    """The SC3 half-step's warp takes the points in sc3.point_order: a
    permutation by descending native node count, ties in time order. On the
    flagship a lane then runs 212 quadrature nodes (the longest of each 32
    points taken together), against 440 in the time order, and the lanes
    hold 5738 / (32 x 212) = 85% of the slots busy."""
    ll = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(),
                            device="cpu").log_likelihood
    order = sc3.point_order(ll)
    n = ll.n_native[ll.band_ids]
    assert order.dtype == torch.int64 and torch.equal(order.sort().values, torch.arange(149))
    assert bool((n[order][:-1] >= n[order][1:]).all())
    same = n[order][:-1] == n[order][1:]
    assert bool((order[:-1][same] < order[1:][same]).all())

    def lane_nodes(m):
        return sum(int(m[i:i + 32].max()) for i in range(0, len(m), 32))
    assert (lane_nodes(n[order]), lane_nodes(n), int(n.sum())) == (212, 440, 5738)


@pytest.mark.parametrize("struct,mirror,size", [
    # 10 pointers, 7 ints, 3 doubles, 7 arrays of LP_MAX_DIM
    ("EpochBBParams", epoch_bb._EpochBBParams, 8 * (10 + 7 + 3) + 7 * 9 * 8),
    # 4 pointers, 8 ints, 3 doubles
    ("SummaryParams", epoch_bb._SummaryParams, 8 * (4 + 8 + 3)),
    # 6 pointers, 2 ints, 5 doubles, 4 arrays of LP_MAX_DIM
    ("PolishParams", epoch_bb._PolishParams, 8 * (6 + 2 + 5) + 4 * 9 * 8),
    # 2 pointers, 3 ints, 3 arrays of PCT_MAX_Q
    ("PercentileParams", kquantile._PercentileParams, 8 * (2 + 3) + 3 * 8 * 8),
])
def test_epoch_param_blocks_match_the_c_structs(struct, mirror, size):
    assert ctypes.sizeof(mirror) == size
    assert _c_fields(struct) == [name for name, _ in mirror._fields_]


def _epoch_pack(E, device, seed=0):
    """E synthetic blackbody epochs of 6, 5 and 4 bands in turn (the bench's
    recipe, with the port's planck_lnu), packed on ``device``."""
    rng = np.random.default_rng(seed)
    filts = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filts)
    nodes = torch.as_tensor(bank.emitted_nodes(0.0))
    epochs = []
    for e in range(E):
        T, R = rng.uniform(4.0, 20.0), rng.uniform(1.0, 30.0)
        y = (bank.weights * planck_lnu(nodes, torch.tensor(T), torch.tensor(R)).numpy()).sum(-1)
        dy = 0.05 * np.abs(y)
        nb = 6 - e % 3
        epochs.append(Table([filts[:nb], (y + rng.normal(scale=dy))[:nb], dy[:nb]],
                            names=["filter", "lum", "dlum"]))
    return batched.pack_epochs(epochs, bank, 0.0, device=device)


_EPOCH_PRIORS = [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]


def _epoch_params(E, M, seed=1):
    """Log-uniform (T, R) over and beyond the priors, some T <= 0."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.uniform(np.log([0.5, 0.005]), np.log([150.0, 2000.0]), size=(E, M, 2)))
    p[:, :2, 0] = [-1.0, 0.0]
    return p


def test_epoch_wrappers_route_by_device():
    ep = batched.EpochPosterior(_epoch_pack(3, "cpu"), _EPOCH_PRIORS)
    q = torch.as_tensor(_epoch_params(3, 8))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(ep(q), ep.plain(q))
    rows = torch.randn(4, 50).float()
    from lightcurve_fitting_tpu_torch.ops.quantile import percentile_f32
    assert torch.equal(percentile_f32(rows, [16, 50, 84], axis=1),
                       percentile_f32_plain(rows, [16, 50, 84], axis=1))
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    with pytest.raises(ValueError, match="runs on CUDA"):
        epoch_bb.log_posterior(ep, torch.empty((3, 4, 2), device="meta"))
    x = torch.empty((3, 2, 4, 2), device="meta")
    with pytest.raises(ValueError, match="runs on CUDA"):
        epoch_bb.stretch_half_step(ep, x, x[..., 0], 0, x[..., 0], x[..., 0].long(), x[..., 0])
    with pytest.raises(ValueError, match="runs on CUDA"):
        epoch_bb.summary_samples(torch.empty((2, 3, 4, 2), device="meta"), rows[0], rows[0],
                                 np.inf, torch.float32)
    with pytest.raises(ValueError, match="K5 runs on CUDA"):
        kquantile.percentile_rows(rows, [50])


@pytest.mark.parametrize("case", ["k4-values-ndim4", "k6d-9-blocks"])
def test_value_wrappers_refuse_before_the_device(case):
    """K4's values run the epoch half-step's policy, ndim 2 or 3, and K6d
    takes at most 8 blocks of steps: each wrapper refuses anything else
    before it looks at the device (here a meta tensor, which would be
    refused for its device), and launches nothing."""
    before = dict(kernels.LAUNCHES)
    if case == "k4-values-ndim4":
        ep = batched.EpochPosterior(_epoch_pack(3, "cpu"),
                                    _EPOCH_PRIORS + [UniformPrior(0.0, 1.0)] * 2)
        q = torch.empty((3, 4, 4), dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="2 or 3 parameters"):
            epoch_bb.log_posterior(ep, q)
        with pytest.raises(ValueError, match="runs on CUDA"):   # the gradient takes 2-9
            epoch_bb.log_posterior(ep, q, with_grad=True)
    else:
        ll = torch.empty((9, 3, 4), dtype=torch.float64, device="meta")
        db = torch.empty(2, dtype=torch.float64, device="meta")
        with pytest.raises(ValueError, match="1 to 8 blocks"):
            ladder.rung_block_terms(ll, db, tuple((b, b + 1) for b in range(9)))
        with pytest.raises(ValueError, match="K6d runs on CUDA"):
            ladder.rung_block_terms(ll, db, tuple((b, b + 1) for b in range(8)))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("n_sm", [132, 114])
def test_k4_form_runs_a_thread_per_vector_where_the_vectors_fill_the_card(n_sm):
    """k4_form on an H100 (SXM 132 SMs, PCIe 114): the warp form at the
    bolometric initial states (256 and 65 epochs x 32 walkers) and at SN
    2016bkv's cloud (65 x 512, its longest vector 416 terms), below the
    crossover of K4_THREAD_VECTORS_PER_SM_TERM vectors an SM a term of the
    longest vector; the thread form from it, at the bench's clouds (64 and
    256 epochs x 512, 286 terms). The rule scales with the SM count and the
    longest vector."""
    for terms in (286, 416):
        cross = epoch_bb.K4_THREAD_VECTORS_PER_SM_TERM * terms * n_sm
        for n in (1, 65 * 32, 256 * 32, int(np.ceil(cross)) - 1):
            assert epoch_bb.k4_form(n, n_sm, terms) == "warp", (n, terms)
        for n in (int(np.ceil(cross)), 4 * int(cross)):
            assert epoch_bb.k4_form(n, n_sm, terms) == "thread", (n, terms)
    assert epoch_bb.k4_form(65 * 512, n_sm, 416) == "warp"
    for E in (64, 256):
        assert epoch_bb.k4_form(E * 512, n_sm, 286) == "thread", E


def test_longest_terms_counts_the_real_bands_nodes():
    """longest_terms: the most node counts one epoch's real bands sum (the
    6-, 5- and 4-band epochs of _epoch_pack), cached on the posterior until
    its buffers change."""
    ep = batched.EpochPosterior(_epoch_pack(5, "cpu"), _EPOCH_PRIORS)
    n = ep.n_native.numpy() * ep.mask.numpy()
    assert epoch_bb.longest_terms(ep) == int(n.sum(1).max()) == int(n[0].sum())
    assert int(n[2].sum()) < int(n[0].sum())
    ep.mask = ep.mask.clone()
    ep.mask[:, 0] = False
    assert epoch_bb.longest_terms(ep) == int((n * ep.mask.numpy()).sum(1).max())


@pytest.mark.parametrize("n_sm", [132, 114])
def test_k6d_splits_fill_the_card(n_sm):
    """k6d_splits: at the evidence bench shape (4 blocks of ~37 steps x 16
    rungs x 2048 pairs of walkers) enough splits that the grid holds
    K6D_CTAS_PER_SM CTAs an SM or more; one split where a block holds less
    than one chunk of loads a thread (the PT fits' and compare_models' 32-
    and 64-walker ladders); never more than MAX_SPLITS, never fewer than
    one."""
    s = ladder.k6d_splits(4 * 16, 37 * 2048, n_sm)
    assert s * 4 * 16 >= ladder.K6D_CTAS_PER_SM * n_sm
    assert (s - 1) * 4 * 16 < ladder.K6D_CTAS_PER_SM * n_sm
    assert 37 * 2048 // s >= ladder.K6D_SPLIT_ITEMS
    for n_terms, items in ((4 * 6, 62 * 16), (4 * 16, 62 * 16), (4 * 6, 62 * 32), (1, 1)):
        assert ladder.k6d_splits(n_terms, items, n_sm) == 1
    assert ladder.k6d_splits(1, 10 ** 9, n_sm) == ladder.MAX_SPLITS
    assert ladder.k6d_splits(10 ** 6, 10 ** 9, n_sm) == 1


def _polish_case(E, device, use_sigma=False, sigma_type="relative", dead=False, seed=3):
    """An EpochPosterior of E synthetic epochs on ``device`` (with ``dead``
    epoch 0 has dy = 0: log_norm = -inf, no finite start), its
    BoundsTransform and 8 starts an epoch (``batched._polish_starts``)."""
    packed = _epoch_pack(E, device)
    if dead:
        packed = dict(packed, dy=packed["dy"].clone())
        packed["dy"][0] = 0.0
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    ep = batched.EpochPosterior(packed, priors, use_sigma=use_sigma, sigma_type=sigma_type)
    cloud_u = torch.as_tensor(np.random.default_rng(seed).random((E, 512, len(priors))),
                              device=device)
    return (ep, *batched._polish_starts(ep, cloud_u))


def test_map_polish_routes_by_device_and_refuses_too_many_starts():
    ep, bounds, u0 = _polish_case(3, "cpu")
    before = dict(kernels.LAUNCHES)
    got = epoch_bb.map_polish(ep, u0, bounds, n_iter=4)
    want = epoch_bb.map_polish_plain(ep, u0, bounds, n_iter=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (3, 2) and got[1].dtype == torch.bool
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    with pytest.raises(ValueError, match="1 to 32 starts"):
        epoch_bb.map_polish(ep, torch.empty((3, 33, 2), dtype=torch.float64, device="meta"),
                            bounds)
    with pytest.raises(ValueError, match="runs on CUDA"):
        epoch_bb.map_polish(ep, torch.empty((3, 8, 2), dtype=torch.float64, device="meta"),
                            bounds)


def test_polish_adam_arithmetic_equals_cosine_adam():
    """K4p's Adam step (``epoch_map_polish_kernel``) emulated in float64 from
    ``adam_table``'s scalars, in the kernel's order of operations, equals
    ``CosineAdam.step`` bit for bit over 300 steps, and the table's rows are
    ``CosineAdam.scalars``."""
    from lightcurve_fitting_tpu_torch.parallel.optimize import B1, B2, EPS, CosineAdam
    rng = np.random.default_rng(3)
    table = epoch_bb.adam_table(300, 0.05, 0.01)
    assert table.shape == (300, 3) and table.dtype == np.float64
    u = torch.as_tensor(rng.normal(size=(4, 8, 3)))
    opt = CosineAdam(u, lr=0.05, n_iter=300, alpha=0.01)
    uk, m, v = u.clone(), torch.zeros_like(u), torch.zeros_like(u)
    for t in range(300):
        g = torch.as_tensor(rng.normal(size=u.shape)) * 10.0 ** rng.uniform(-3.0, 3.0)
        assert tuple(table[t]) == opt.scalars(t)
        u = opt.step(u, g)
        lr, corr1, corr2 = (float(c) for c in table[t])
        m = (1 - B1) * g + B1 * m
        v = (1 - B2) * (g * g) + B2 * v
        uk = uk + (-lr) * ((m / corr1) / (torch.sqrt(v / corr2) + EPS))
        assert torch.equal(uk, u)


def test_polish_chain_rule_is_autograds_through_the_bijection():
    """K4p's bijection and chain rule (``polish_bounded`` and the gradient of
    -lp in u, from ``BoundsTransform.kernel_spec``), emulated in float64 from
    the forward's sigmoid and exp (on the CPU their bits depend on the
    tensor's layout; the kernel forms them as PyTorch's CUDA kernels do),
    equal ``BoundsTransform.to_bounded`` and autograd through it bit for bit,
    for each kind of bound."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    bounds = BoundsTransform([1.0, 0.01, 0.0, -np.inf, -np.inf],
                             [100.0, 1000.0, np.inf, 5.0, np.inf])
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.normal(scale=3.0, size=(64, 5))).requires_grad_(True)
    gx = torch.as_tensor(rng.normal(size=(64, 5)) * 10.0 ** rng.uniform(-3, 3, (64, 5)))
    x = bounds.to_bounded(u)
    gu, = torch.autograd.grad(x, u, grad_outputs=-gx)
    u = u.detach()
    zero = torch.zeros_like(u)
    sig = torch.sigmoid(torch.where(torch.as_tensor(bounds.two_sided), u, zero))
    ex = torch.exp(torch.where(torch.as_tensor(bounds.one_sided), u, zero))
    for k, (kind, lo, hi, width) in enumerate(bounds.kernel_spec()):
        gn = -gx[:, k]
        if kind == 1:
            f = sig[:, k]
            xk, gk = lo + width * f, ((gn * width) * (1.0 - f)) * f
        elif kind in (2, 3):
            f = ex[:, k]
            xk, gk = (lo + f, gn * f) if kind == 2 else (hi - f, (-gn) * f)
        else:
            xk, gk = u[:, k], gn
        assert torch.equal(xk, x[:, k].detach()) and torch.equal(gk, gu[:, k]), k
    assert [k for k, *_ in bounds.kernel_spec()] == [1, 1, 2, 3, 0]


# ---------------------------------------------------------------- card side

# K1's widths: the fits' initial states (5a and lightcurve_hmc's warm start:
# 64; 5c: 4096; 5b: 131072)
K1_WIDTHS = (64, 4096, 131072)


@pytest.mark.cuda
@pytest.mark.parametrize("W", K1_WIDTHS)
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k1_matches_plain_on_card(lc, cuda_device, f64, W):
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
        wide = make_log_posterior(ShockCooling2(lc), lc, _priors(57480.0), device=cuda_device)
        assert lp.log_likelihood.compute_dtype == (torch.float64 if f64 else torch.float32)
        p = torch.as_tensor(_walkers(W), device=cuda_device)
        late = np.random.default_rng(1).uniform([20, 2, 10, 57468.8], [50, 5, 50, 57472.0],
                                                size=(512, 4))
        late = torch.as_tensor(late, device=cuda_device)
        n0 = kernels.LAUNCHES["sc2_logpost"]
        got = lp(p)
        assert kernels.LAUNCHES["sc2_logpost"] == n0 + 1
        _assert_ll_close(got, lp.forward_plain(p), 1e-10 if f64 else 1e-5)
        # a walker's bits do not depend on the launch's width (one walker a
        # warp at 64, batches of walkers a warp at the larger widths)
        assert torch.equal(lp(p[:64]), got[:64]) and torch.equal(lp(p[:4096]), got[:4096])
        assert torch.isneginf(got[-4:]).all() and torch.isfinite(got[:-4]).all()
        got_late = wide(late)
        assert torch.isfinite(got_late).all()
        _assert_ll_close(got_late, wide.forward_plain(late), 1e-10 if f64 else 1e-5)
        # the rescaled float32 state of the sampler, as K1 sees it at the start
        q = ((p[:-4] - torch.as_tensor(OFFSET, device=cuda_device))
             / torch.as_tensor(SCALE, device=cuda_device)).float()
        _assert_ll_close(sc2.log_posterior(lp, q, OFFSET, SCALE),
                         sc2.log_posterior_plain(lp, q, OFFSET, SCALE), 1e-10 if f64 else 1e-5)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative"], ids=["ndim4", "ndim5-sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k1_repeats_the_half_steps_values_on_card(lc, lc_flux, cuda_device, f64, sigma_type):
    """K1 and K2 run one warp form (SC2WarpModel; K1 at a compile-time
    ndim, K2 at a runtime one): on the states that two K2 half-steps left
    at u_acc = 0 (every proposal inside the priors accepted), K1 returns
    the log-posterior K2 stored, bit for bit, on the sampler's float32
    rescaled state, with and without the intrinsic scatter."""
    try:
        if f64:
            config.set_compute_dtype(None)
        if sigma_type is None:
            lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
            lo, up = P_LO, P_UP
        else:
            lp, lo, up = _sigma_case("sc2", lc, lc_flux, cuda_device, sigma_type)
        ndim, half = len(lo), 2048
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        pos = (np.random.default_rng(5).uniform(lo, up, size=(2 * half, ndim)) - off) / sc
        x = torch.as_tensor(pos.reshape(2, half, ndim), device=cuda_device).float().contiguous()
        logp = sc2.log_posterior(lp, x.reshape(-1, ndim), off, sc).reshape(2, half)
        g = torch.Generator(device=cuda_device).manual_seed(6)
        acc = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
        for h in (0, 1):
            u_z = torch.rand(half, generator=g, device=cuda_device)
            j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
            sc2.stretch_half_step(lp, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                                  n_accept=acc)
        assert 0.5 < float(acc.float().mean()) < 1.0   # the proposals inside the priors
        assert torch.equal(sc2.log_posterior(lp, x.reshape(-1, ndim), off, sc),
                           logp.reshape(-1))
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [32, 16384, 65536])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("h", [0, 1])
def test_k2_matches_plain_on_card(lc, cuda_device, half, f64, h):
    """K2 (a warp per walker) against the plain half-step under shared draws
    at the main path's widths (half 32: the 64-walker fit and
    lightcurve_hmc's warm start; 16384; 65536: the 131072-walker fit), in
    float32 and float64: flags equal except near-ties, new states bit-equal
    and new log-posteriors within 1e-5 (float32) or 1e-10 (float64) of the
    term scale where they agree, the chain slot written in other dtypes
    than the state's."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
        W = 2 * half
        pos = (np.random.default_rng(2).uniform(P_LO, P_UP, size=(W, 4)) - OFFSET) / SCALE
        x0 = torch.as_tensor(pos.reshape(2, half, 4), device=cuda_device).float().contiguous()
        l0 = sc2.log_posterior(lp, x0.reshape(W, 4), OFFSET, SCALE).reshape(2, half)
        g = torch.Generator(device=cuda_device).manual_seed(3)
        u_z = torch.rand(half, generator=g, device=cuda_device)
        j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
        u_acc = torch.rand(half, generator=g, device=cuda_device)
        u_acc[0] = 0.0                                   # log 0 = -inf: accepts
        xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
        ap = torch.zeros_like(ak)
        chain_x = torch.empty((2, half, 4), dtype=torch.float64, device=cuda_device)
        chain_lp = torch.empty((2, half), dtype=torch.float32, device=cuda_device)
        n0 = kernels.LAUNCHES["stretch_half_step"]
        sc2.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, OFFSET, SCALE, chain_x,
                              chain_lp, ak)
        assert kernels.LAUNCHES["stretch_half_step"] == n0 + 1
        sc2.stretch_half_step_plain(lambda q: sc2.log_posterior_plain(lp, q, OFFSET, SCALE),
                                    xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
        agree = ak[h] == ap[h]
        y, z = sc2.propose_stretch(u_z, j, x0[h], x0[1 - h])
        lp_y = sc2.log_posterior_plain(lp, y, OFFSET, SCALE)
        gap = (torch.log(u_acc).double() - (3.0 * torch.log(z) + lp_y - l0[h])).abs()
        assert bool((agree | (gap <= 1e-5 * lp_y.abs())).all())
        assert bool(ak[h][0] == 1) == bool(torch.isfinite(lp_y[0]))
        assert torch.equal(xk[h][agree], xp[h][agree])
        _assert_scaled(lk[h][agree], lpp[h][agree], 1e-10 if f64 else 1e-5,
                       lp.log_likelihood.term_scales(common.absolute_params(xk[h], OFFSET,
                                                                            SCALE))[agree])
        assert torch.equal(xk[1 - h], x0[1 - h]) and torch.equal(ak[1 - h], ap[1 - h])
        assert torch.equal(chain_x[h], xk[h].double())
        assert torch.equal(chain_lp[h], lk[h].float())
        assert 0.05 < float(ak[h].float().mean()) < 0.95
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k2_and_k6a_proposals_have_k7_values_on_card(lc, cuda_device, f64):
    """K2 and K6a over ShockCooling2 sum a proposal's points in K7's order
    through the same device code (in float64 with K7's fused multiply-adds
    written by hand), so with u_acc = 0 (every proposal inside the priors
    accepted) the new log-posterior of each walker, and K6a's log pi + log
    L, are K7's value at its new state, bit for bit in float32 and float64,
    at half 4096 (batches of walkers a warp in float64) and on 5 rungs x
    half 256 (one walker a warp)."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
        half = 4096
        pos = (np.random.default_rng(4).uniform(P_LO, P_UP, size=(2 * half, 4)) - OFFSET) / SCALE
        x = torch.as_tensor(pos.reshape(2, half, 4), device=cuda_device).float().contiguous()
        logp = sc2.log_posterior(lp, x.reshape(-1, 4), OFFSET, SCALE).reshape(2, half)
        g = torch.Generator(device=cuda_device).manual_seed(5)
        u_z = torch.rand(half, generator=g, device=cuda_device)
        j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
        acc = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
        sc2.stretch_half_step(lp, x, logp, 0, u_z, j, torch.zeros_like(u_z), 2.0, OFFSET, SCALE,
                              n_accept=acc)
        moved = acc[0] == 1
        assert int(moved.sum()) > half // 2
        pa = common.absolute_params(x[0], OFFSET, SCALE)
        k7 = sc2.log_posterior_and_grad(lp, pa)[0]
        assert torch.equal(logp[0][moved], k7[moved])

        R = 5
        lp_l, off, sc, xl = _ladder_case("sc2", lc, lc, cuda_device, R, 512, seed=6)
        pri, ll = ladder.ladder_init(lp_l, xl, off, sc)
        shape = (R, 2, 256)
        u_zl = torch.rand(shape, generator=g, device=cuda_device)
        jl = torch.randint(0, 256, shape, generator=g, device=cuda_device)
        al = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
        betas = torch.as_tensor(make_beta_ladder(R - 1), device=cuda_device)
        ladder.tempered_half_step(lp_l, xl, pri, ll, betas, 1, u_zl, jl, torch.zeros_like(u_zl),
                                  2.0, off, sc, al)
        moved = al[:, 1] == 1
        assert int(moved.sum()) > R * 128
        pa = common.absolute_params(xl[:, 1], off, sc)
        k7 = sc2.log_posterior_and_grad(lp_l, pa.reshape(-1, 4))[0].reshape(R, 256)
        assert torch.equal((pri[:, 1] + ll[:, 1])[moved], k7[moved])
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
def test_k2_checks_inputs_on_card(lc, cuda_device):
    lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
    half = 64
    x = torch.zeros((2, half, 4), device=cuda_device)
    logp = torch.zeros((2, half), dtype=torch.float64, device=cuda_device)
    u = torch.full((half,), 0.5, device=cuda_device)
    j = torch.zeros(half, dtype=torch.int64, device=cuda_device)
    acc = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
    n0 = kernels.LAUNCHES["stretch_half_step"]
    with pytest.raises(ValueError, match="partner indices"):
        sc2.stretch_half_step(lp, x, logp, 0, u, j + half, u, 2.0, OFFSET, SCALE, n_accept=acc)
    with pytest.raises(TypeError):
        sc2.stretch_half_step(lp, x, logp.float(), 0, u, j, u, 2.0, OFFSET, SCALE,
                              n_accept=acc)
    with pytest.raises(ValueError, match="contiguous"):
        sc2.stretch_half_step(lp, x.transpose(0, 1).contiguous().transpose(0, 1), logp, 0, u,
                              j, u, 2.0, OFFSET, SCALE, n_accept=acc)
    with pytest.raises(ValueError):
        sc2.log_posterior(lp.cpu(), x.reshape(-1, 4))
    assert kernels.LAUNCHES["stretch_half_step"] == n0


def _k3_inputs(lc_flux, device, W, seed):
    """The flagship's per-band tables and band ids, and T, R (W, N) with 5%
    of T <= 0 and 1% deep in the Wien tail, E(B-V) (W, 1) in [0, 1]."""
    ll = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(),
                            device="cpu").log_likelihood
    rng = np.random.default_rng(seed)
    N = ll.band_ids.shape[0]
    T = rng.uniform(2.0, 60.0, size=(W, N))
    T[rng.random((W, N)) < 0.05] = rng.choice([0.0, -3.0])
    T[rng.random((W, N)) < 0.01] = 1e-3
    R = rng.uniform(0.1, 10.0, size=(W, N))
    ebv = rng.uniform(0.0, 1.0, size=(W, 1))
    tables = [torch.as_tensor(getattr(ll, n).numpy().astype(np.float64), device=device)
              for n in ("nodes", "weights", "k_ext")]
    return (tables, ll.band_ids.to(device), torch.as_tensor(T, device=device),
            torch.as_tensor(R, device=device), torch.as_tensor(ebv, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k3_matches_plain_on_card(lc_flux, cuda_device, f64):
    try:
        if f64:
            config.set_compute_dtype(None)
        (nodes, weights, k_ext), ids, T, R, ebv = _k3_inputs(lc_flux, cuda_device, 2048, 4)
        n0 = kernels.LAUNCHES["bandflux"]
        got = bandflux_pointwise(nodes, weights, T, R, k_ext=k_ext, ebv=ebv, band_ids=ids)
        assert kernels.LAUNCHES["bandflux"] == n0 + 1
        want = bandflux_pointwise_plain(nodes, weights, T, R, k_ext=k_ext, ebv=ebv,
                                        band_ids=ids)
        assert got.dtype == torch.float64 and torch.isfinite(got).all()
        assert bool((got[T <= 0] == 0).all()) and bool((got[T == 1e-3] == 0).all())
        rel = 1e-12 if f64 else 1e-5
        assert bool(((got - want).abs() <= rel * want.abs()).all())
        # per-point tables, a scalar E(B-V), a finite cutoff
        got = bandflux_pointwise(nodes[ids], weights[ids], T[:64], R[:64], 500.0,
                                 k_ext[ids], 0.3)
        want = bandflux_pointwise_plain(nodes[ids], weights[ids], T[:64], R[:64], 500.0,
                                        k_ext[ids], 0.3)
        assert bool(((got - want).abs() <= rel * want.abs()).all())
    finally:
        config.set_compute_dtype(config.AUTO)


def _chunked(fn, x, chunk=8192):
    """``fn`` over chunks of ``chunk`` rows of x, concatenated (a plain
    quadrature version's (W, 149, 89) cube stays under ~1 GB)."""
    return torch.cat([fn(c) for c in x.split(chunk)])


# the batch log-posteriors' widths: the fits' initial states (SC3: 64 in
# 9a, 4096 in 9c, 32768 in 9b; CS2: 32 in 24a, 32768 in 24b) and 131072
SC3_WIDTHS = (64, 4096, 32768, 131072)
CS_WIDTHS = (32, 2048, 32768, 131072)


@pytest.mark.cuda
@pytest.mark.parametrize("W", SC3_WIDTHS)
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_sc3_logpost_matches_plain_on_card(lc_flux, cuda_device, f64, W):
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(),
                                device=cuda_device)
        wide = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(57480.0),
                                  device=cuda_device)
        p = torch.as_tensor(_sc3_walkers(W), device=cuda_device)
        late = np.random.default_rng(1).uniform(SC3_LO, SC3_UP, size=(256, 7))
        late[:, 6] = np.random.default_rng(2).uniform(57468.8, 57472.0, 256)
        late = torch.as_tensor(late, device=cuda_device)
        n0 = kernels.LAUNCHES["sc3_logpost"]
        got = lp(p)
        assert kernels.LAUNCHES["sc3_logpost"] == n0 + 1
        rel = 1e-10 if f64 else 1e-5
        c = lp.log_likelihood.log_norm_const
        _assert_ll_close(got, _chunked(lp.forward_plain, p), rel, c)
        assert torch.isneginf(got[-4:]).all() and torch.isfinite(got[:-4]).all()
        got_late = wide(late)
        assert torch.isfinite(got_late).all()
        _assert_ll_close(got_late, wide.forward_plain(late), rel, c)
        q = ((p[:-4] - torch.as_tensor(SC3_OFFSET, device=cuda_device))
             / torch.as_tensor(SC3_SCALE, device=cuda_device)).float()
        _assert_ll_close(sc3.log_posterior(lp, q, SC3_OFFSET, SC3_SCALE),
                         _chunked(lambda c_: common.log_posterior_plain(lp, c_, SC3_OFFSET,
                                                                         SC3_SCALE), q), rel, c)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative"], ids=["no-sigma", "sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_sc3_logpost_repeats_the_half_steps_values_on_card(lc, lc_flux, cuda_device, f64,
                                                            sigma_type):
    """The batch log-posterior and the half-step run one warp form
    (SC3WarpModel): on the states that a half-step accepted at u_acc = 0
    (every proposal inside the priors), the batch kernel returns the
    log-posterior the half-step stored, bit for bit, on the sampler's
    float32 rescaled state."""
    try:
        if f64:
            config.set_compute_dtype(None)
        if sigma_type is None:
            lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(),
                                    device=cuda_device)
            lo, up = SC3_LO, SC3_UP
        else:
            lp, lo, up = _sigma_case("sc3", lc, lc_flux, cuda_device, sigma_type)
        ndim, half = len(lo), 1024
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        pos = (np.random.default_rng(5).uniform(lo, up, size=(2 * half, ndim)) - off) / sc
        x = torch.as_tensor(pos.reshape(2, half, ndim), device=cuda_device).float().contiguous()
        logp = sc3.log_posterior(lp, x.reshape(-1, ndim), off, sc).reshape(2, half)
        g = torch.Generator(device=cuda_device).manual_seed(6)
        acc = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
        for h in (0, 1):
            u_z = torch.rand(half, generator=g, device=cuda_device)
            j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
            sc3.stretch_half_step(lp, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                                  n_accept=acc)
        assert 0.5 < float(acc.float().mean()) < 1.0   # the proposals inside the priors
        assert torch.equal(sc3.log_posterior(lp, x.reshape(-1, ndim), off, sc),
                           logp.reshape(-1))
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 1])
def test_sc3_half_step_matches_plain_on_card(lc_flux, cuda_device, h):
    lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device=cuda_device)
    W, half = 2048, 1024
    pos = (np.random.default_rng(2).uniform(SC3_LO, SC3_UP, size=(W, 7)) - SC3_OFFSET) \
        / SC3_SCALE
    x0 = torch.as_tensor(pos.reshape(2, half, 7), device=cuda_device).float().contiguous()
    l0 = sc3.log_posterior(lp, x0.reshape(W, 7), SC3_OFFSET, SC3_SCALE).reshape(2, half)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    u_z = torch.rand(half, generator=g, device=cuda_device)
    j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
    u_acc = torch.rand(half, generator=g, device=cuda_device)
    xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
    ak = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
    ap = torch.zeros_like(ak)
    chain_x = torch.empty((2, half, 7), device=cuda_device)
    chain_lp = torch.empty((2, half), dtype=torch.float64, device=cuda_device)
    n0 = kernels.LAUNCHES["sc3_half_step"]
    kernels.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, SC3_OFFSET, SC3_SCALE,
                              chain_x, chain_lp, ak)
    assert kernels.LAUNCHES["sc3_half_step"] == n0 + 1

    def plain(q):
        return common.log_posterior_plain(lp, q, SC3_OFFSET, SC3_SCALE)

    common.stretch_half_step_plain(plain, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
    agree = ak[h] == ap[h]
    y, z = common.propose_stretch(u_z, j, x0[h], x0[1 - h])
    lp_y = plain(y)
    gap = (torch.log(u_acc).double() - (6.0 * torch.log(z) + lp_y - l0[h])).abs()
    c = lp.log_likelihood.log_norm_const
    assert bool((agree | (gap <= 1e-5 * ((lp_y - c).abs() + abs(c)))).all())
    assert torch.equal(xk[h][agree], xp[h][agree])
    assert torch.equal(xk[1 - h], x0[1 - h]) and torch.equal(ak[1 - h], ap[1 - h])
    assert torch.equal(chain_x[h], xk[h]) and torch.equal(chain_lp[h], lk[h])
    assert 0.02 < float(ak[h].float().mean()) < 0.98


@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
def test_k4_yardsticks_bound_float32_rounding(sigma_type):
    """The scales K4 is held to on the card (``EpochPosterior.term_scales``)
    bound the plain version's own float32 rounding, measured against its
    float64 evaluation, with a margin of 4 under the card's budgets."""
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    packed = _epoch_pack(8, "cpu")
    q = _epoch_params(8, 64)
    if use_sigma:
        q = np.concatenate([q, np.random.default_rng(2).uniform(-4.0, 6.0, (8, 64, 1))], -1)
    q = torch.as_tensor(q)

    def value_and_grad(ep):
        qq = q.clone().requires_grad_(True)
        lp = ep.plain(qq)
        g, = torch.autograd.grad(lp.sum(), qq)
        return lp.detach(), g

    kw = dict(use_sigma=use_sigma, sigma_type=sigma_type or "relative")
    lp64, g64 = value_and_grad(batched.EpochPosterior(packed, priors, **kw))
    try:
        config.set_compute_dtype(torch.float32)
        ep = batched.EpochPosterior(packed, priors, **kw)
        lp32, g32 = value_and_grad(ep)
        ll_scale, g_scale = ep.term_scales(q)
    finally:
        config.set_compute_dtype(config.AUTO)
    fin = torch.isfinite(lp64) & torch.isfinite(lp32)
    assert int(fin.sum()) > 200
    assert bool(((lp32 - lp64).abs()[fin] <= 0.25e-5 * ll_scale[fin]).all())
    ok = fin[..., None] & torch.isfinite(g64)
    assert bool(((g32 - g64).abs()[ok] <= 0.25e-4 * (g_scale + g64.abs())[ok]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k4_matches_plain_on_card(cuda_device, f64, sigma_type):
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    try:
        if f64:
            config.set_compute_dtype(None)
        ep = batched.EpochPosterior(_epoch_pack(24, cuda_device), priors, use_sigma=use_sigma,
                                    sigma_type=sigma_type or "relative")
        q = _epoch_params(24, 160)
        if use_sigma:
            q = np.concatenate([q, np.random.default_rng(2).uniform(-4.0, 6.0, (24, 160, 1))], -1)
        q = torch.as_tensor(q, device=cuda_device)
        n0 = kernels.LAUNCHES["epoch_logpost_grad"]
        lp, grad = epoch_bb.log_posterior(ep, q, with_grad=True)
        assert kernels.LAUNCHES["epoch_logpost_grad"] == n0 + 1
        want = ep.plain(q)
        rel, grel = (1e-10, 1e-9) if f64 else (1e-5, 1e-4)
        ll_scale, g_scale = ep.term_scales(q)
        fin = torch.isfinite(want)
        # the gradient launch's values, and the value launch's (the warp form)
        for v in (lp, epoch_bb.log_posterior(ep, q)[0]):
            assert torch.equal(torch.isneginf(v), torch.isneginf(want)) and int(fin.sum()) > 1000
            assert bool(((v - want).abs()[fin] <= rel * ll_scale[fin]).all())
        qq = q.clone().requires_grad_(True)
        g_want, = torch.autograd.grad(ep.plain(qq).sum(), qq)
        ok = fin[..., None] & torch.isfinite(g_want)
        assert bool(((grad - g_want).abs()[ok] <= grel * (g_scale + g_want.abs())[ok]).all())
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k4_value_forms_match_plain_on_card(cuda_device, f64, sigma_type):
    """K4's values in both forms (the epoch half-step's warp form, and a
    thread per vector in the warp's sum order) against ``EpochPosterior.plain``
    at 24 epochs x 512 vectors beyond the priors: within 1e-5 (float32) or
    1e-10 (float64) of the term scale, identical -inf sets, the two forms and
    the wrapper's choice (k4_form) bit-equal, and a vector's value the same
    at width 32."""
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    try:
        if f64:
            config.set_compute_dtype(None)
        ep = batched.EpochPosterior(_epoch_pack(24, cuda_device), priors, use_sigma=use_sigma,
                                    sigma_type=sigma_type or "relative")
        q = _epoch_params(24, 512)
        if use_sigma:
            q = np.concatenate([q, np.random.default_rng(2).uniform(-4.0, 6.0, (24, 512, 1))], -1)
        q = torch.as_tensor(q, device=cuda_device)
        n0 = kernels.LAUNCHES["epoch_logpost"]
        lw = epoch_bb._launch_k4(ep, q, False, "warp")[0]
        lt = epoch_bb._launch_k4(ep, q, False, "thread")[0]
        assert kernels.LAUNCHES["epoch_logpost"] == n0 + 2
        assert torch.equal(lw, lt) and torch.equal(epoch_bb.log_posterior(ep, q)[0], lw)
        assert torch.equal(epoch_bb.log_posterior(ep, q[:, :32].contiguous())[0], lw[:, :32])
        want = ep.plain(q)
        rel = 1e-10 if f64 else 1e-5
        ll_scale, _ = ep.term_scales(q)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isneginf(lw), torch.isneginf(want)) and int(fin.sum()) > 1000
        assert bool(((lw - want).abs()[fin] <= rel * ll_scale[fin]).all())
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 1])
def test_epoch_half_step_matches_plain_on_card(cuda_device, h):
    E, half = 40, 16
    ep = batched.EpochPosterior(_epoch_pack(E, cuda_device), _EPOCH_PRIORS)
    rng = np.random.default_rng(4)
    x0 = torch.as_tensor(np.exp(rng.uniform(np.log([5.0, 1.0]), np.log([20.0, 30.0]),
                                            size=(E, 2, half, 2))), device=cuda_device).float()
    l0 = ep(x0.reshape(E, 2 * half, 2)).reshape(E, 2, half)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    u_z = torch.rand((E, 2, half), generator=g, device=cuda_device)
    j = torch.randint(0, half, (E, 2, half), generator=g, device=cuda_device)
    u_acc = torch.rand((E, 2, half), generator=g, device=cuda_device)
    xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
    ak = torch.zeros((E, 2, half), dtype=torch.int32, device=cuda_device)
    ap = torch.zeros_like(ak)
    cx = torch.empty_like(x0)
    cl = torch.empty((E, 2, half), device=cuda_device)
    n0 = kernels.LAUNCHES["epoch_half_step"]
    epoch_bb.stretch_half_step(ep, xk, lk, h, u_z, j, u_acc, 2.0, cx, cl, ak)
    assert kernels.LAUNCHES["epoch_half_step"] == n0 + 1
    epoch_bb.stretch_half_step_plain(ep.plain, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
    agree = ak[:, h] == ap[:, h]
    y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
    lp_y = ep.plain(y)
    gap = (torch.log(u_acc[:, h]).double() - (torch.log(z) + lp_y - l0[:, h])).abs()
    c = ep.log_norm[:, None]
    assert bool((agree | (gap <= 1e-5 * ((lp_y - c).abs() + c.abs()))).all())
    assert torch.equal(xk[:, h][agree], xp[:, h][agree])
    assert torch.equal(xk[:, 1 - h], x0[:, 1 - h]) and torch.equal(ak[:, 1 - h], ap[:, 1 - h])
    assert torch.equal(cx[:, h], xk[:, h]) and torch.equal(cl[:, h], lk[:, h].float())
    assert 0.02 < float(ak[:, h].float().mean()) < 0.98


#: K4p's centers against the plain polish on the card: float64 relative;
#: float32 relative, measured on the H100 (PERF.md: the optimum of a float32
#: objective moves with its rounding)
POLISH_REL = {True: 1e-9, False: 1e-5}


def _assert_polish_close(got, want, rel):
    """K4p's (centers, alive, last iterates, their log-posteriors) against the
    plain polish's: the same alive set; centers within ``rel`` relative
    where both keep the same start, and where they keep different starts
    the two are a near-tie (the plain log-posteriors of both within 1e-5 of
    each other's magnitude)."""
    c, alive, _, lp = got
    cp, alive_p, _, lpp = want
    assert torch.equal(alive, alive_p)
    neg = torch.where(torch.isfinite(lp), -lp, torch.full_like(lp, torch.inf))
    neg_p = torch.where(torch.isfinite(lpp), -lpp, torch.full_like(lpp, torch.inf))
    best, best_p = torch.argmin(neg, dim=1), torch.argmin(neg_p, dim=1)
    rows = torch.arange(len(best), device=best.device)
    same = (best == best_p) & alive
    assert bool(((c - cp).abs() <= rel * cp.abs())[same].all())
    tie = ~same & alive
    assert bool(((lpp[rows, best] - lpp[rows, best_p]).abs()
                 <= 1e-5 * lpp[rows, best_p].abs())[tie].all())


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_map_polish_matches_plain_on_card(cuda_device, f64, sigma_type):
    """K4p (a block per epoch, a warp per start, 300 steps in one launch)
    against the plain polish on the same device: the same alive set (epoch 0
    without intrinsic scatter is dead: dy = 0), centers within POLISH_REL."""
    try:
        if f64:
            config.set_compute_dtype(None)
        ep, bounds, u0 = _polish_case(24, cuda_device, use_sigma=sigma_type is not None,
                                      sigma_type=sigma_type or "relative",
                                      dead=sigma_type is None)
        n0 = kernels.LAUNCHES["epoch_map_polish"]
        got = epoch_bb.map_polish(ep, u0, bounds, return_starts=True)
        assert kernels.LAUNCHES["epoch_map_polish"] == n0 + 1
        assert torch.equal(got[0], epoch_bb.map_polish(ep, u0, bounds)[0])
        want = epoch_bb.map_polish_plain(ep, u0, bounds, return_starts=True)
        _assert_polish_close(got, want, POLISH_REL[f64])
        assert (not bool(got[1][0])) == (sigma_type is None) and bool(got[1][1:].all())
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("E,half", [(256, 16), (40, 5)])
@pytest.mark.parametrize("sigma_type", [None, "relative"], ids=["no-sigma", "sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_epoch_warp_half_step_matches_plain_on_card(cuda_device, E, half, sigma_type, f64):
    """The epoch half-step, a warp per walker, against the plain half-step
    under shared draws (h = 0, 1): accept flags agree except near-ties, new
    states bit-equal where they agree, new log-posteriors within 1e-5
    (float32) or 1e-10 (float64) of ``EpochPosterior.term_scales``."""
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    rel = 1e-10 if f64 else 1e-5
    try:
        if f64:
            config.set_compute_dtype(None)
        ep = batched.EpochPosterior(_epoch_pack(E, cuda_device), priors, use_sigma=use_sigma)
        rng = np.random.default_rng(4)
        x0 = np.exp(rng.uniform(np.log([5.0, 1.0]), np.log([20.0, 30.0]), size=(E, 2, half, 2)))
        if use_sigma:
            x0 = np.concatenate([x0, rng.uniform(0.5, 3.0, size=(E, 2, half, 1))], axis=-1)
        x0 = torch.as_tensor(x0, device=cuda_device).float().contiguous()
        ndim = x0.shape[-1]
        l0 = ep(x0.reshape(E, 2 * half, ndim)).reshape(E, 2, half)
        g = torch.Generator(device=cuda_device).manual_seed(5)
        u_z = torch.rand((E, 2, half), generator=g, device=cuda_device)
        j = torch.randint(0, half, (E, 2, half), generator=g, device=cuda_device)
        u_acc = torch.rand((E, 2, half), generator=g, device=cuda_device)
        for h in (0, 1):
            xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
            ak = torch.zeros((E, 2, half), dtype=torch.int32, device=cuda_device)
            ap = torch.zeros_like(ak)
            epoch_bb.stretch_half_step(ep, xk, lk, h, u_z, j, u_acc, 2.0, n_accept=ak)
            epoch_bb.stretch_half_step_plain(ep.plain, xp, lpp, h, u_z, j, u_acc, 2.0,
                                             n_accept=ap)
            agree = ak[:, h] == ap[:, h]
            y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
            lp_y = ep.plain(y)
            ll_scale, _ = ep.term_scales(y.double())
            gap = (torch.log(u_acc[:, h]).double()
                   - ((ndim - 1) * torch.log(z) + lp_y - l0[:, h])).abs()
            assert bool((agree | (gap <= rel * ll_scale)).all())
            assert torch.equal(xk[:, h][agree], xp[:, h][agree])
            assert torch.equal(xk[:, 1 - h], x0[:, 1 - h]) and torch.equal(ak[:, 1 - h],
                                                                          ap[:, 1 - h])
            moved = agree & (ak[:, h] == 1)
            assert bool(((lk[:, h] - lpp[:, h]).abs() <= rel * ll_scale)[moved].all())
            assert 0.02 < float(ak[:, h].float().mean()) < 0.98
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("cutoff_freq", [np.inf, 600.0], ids=["no-cutoff", "cutoff600"])
def test_k4s_and_k5_match_plain_on_card(cuda_device, cutoff_freq):
    """K4s against its plain version without a cutoff and with one inside
    the grid, float32 and float64 compute: T, R and (R T^2)^2 equal, the
    integral within 1e-5 and 1e-12 relative, on samples whose terms all run
    on the special-function unit and on samples with T <= 0 (0 exactly) or
    x < 0.25 at some or every node (T 80 and 200 kK); K5 bit-equal to its
    plain version on the float32 rows."""
    rng = np.random.default_rng(6)
    E, steps, nw = 20, 50, 32
    chain = np.exp(rng.uniform(np.log([5.0, 1.0]), np.log([20.0, 30.0]),
                               size=(steps, E, nw, 2)))
    chain[0, :, :4, 0] = [0.0, -1.0, 80.0, 200.0]
    chain = torch.as_tensor(chain, device=cuda_device)
    nu = torch.arange(380.0, 960.0, dtype=torch.float64, device=cuda_device)
    w = torch.ones_like(nu)
    w[0] = w[-1] = 0.5
    n0 = dict(kernels.LAUNCHES)
    for dt, rel in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x = chain.to(dt)
        rows = epoch_bb.summary_samples(x, nu, w, cutoff_freq, dt)
        want = epoch_bb.summary_samples_plain(x, nu, w, cutoff_freq, dt)
        assert rows.shape == (E, 4, steps * nw) and rows.dtype == dt
        assert torch.equal(rows[:, :3], want[:, :3])
        assert bool(((rows[:, 3] - want[:, 3]).abs() <= rel * want[:, 3].abs()).all())
        assert bool((rows[:, 3, :2] == 0).all()) and bool((rows[:, 3, 2:] > 0).all())
    flat = rows.reshape(E * 4, -1).contiguous()
    pct = kquantile.percentile_rows(flat, [16, 50, 84])
    assert torch.equal(pct, percentile_f32_plain(flat, [16, 50, 84], axis=1))
    assert kernels.LAUNCHES["epoch_summary"] == n0["epoch_summary"] + 2
    assert kernels.LAUNCHES["percentile"] == n0["percentile"] + 1


@pytest.mark.cuda
def test_k4s_term_is_one_over_expm1_within_a_few_ulp_on_card(cuda_device):
    """K4s's float32 Planck term on a one-node grid over x = c1 nu / T from
    0.05 to 87, against 1 / expm1 in float64 at the kernel's own rounded
    exponent: within a few ulp on the special-function unit and off it, T
    <= 0 giving 0 (``chip_smoke.k4s_term_ulps``, which ``chip_smoke.py``'s
    K4s phase runs too, holds the ulp model)."""
    import chip_smoke
    on_unit, of_bound, off_unit = chip_smoke.k4s_term_ulps(cuda_device)
    assert of_bound <= 1.0 and off_unit <= 3.0, (on_unit, of_bound, off_unit)


@pytest.mark.cuda
def test_bolometric_runs_through_the_epoch_kernels_on_card(cuda_device):
    from lightcurve_fitting_tpu_torch.bolometric import calculate_bolometric
    lc = LC.read(EXAMPLE)
    lc.meta.update(dm=30.79, redshift=0.002)
    kernels.reset_launch_counts()
    t = calculate_bolometric(lc.where(MJD_min=57468.0, MJD_max=57474.0), nwalkers=10,
                             burnin_steps=50, steps=50, seed=7, save_corners=False,
                             batch_mode=True)
    assert len(t) == 4 and np.isfinite(np.asarray(t["temp_mcmc"], float)).all()
    for k in ("epoch_logpost", "epoch_map_polish", "epoch_half_step", "epoch_summary",
              "percentile"):
        assert kernels.LAUNCHES[k] > 0, k
    assert kernels.LAUNCHES["epoch_map_polish"] == 1 and kernels.LAUNCHES["epoch_logpost_grad"] == 0


# ------------------------------------------------------------- K6 (ladder)

def _ladder_case(which, lc, lc_flux, dev, R, W, seed=0, ia=None):
    """A LogPosterior, its rescaling, and a float32 ladder state (R, 2, W/2,
    ndim) from the init window with 1% of the walkers outside the priors:
    ShockCooling2, ShockCooling3, or CompanionShocking2 on the synthetic Ia
    curve ``ia``."""
    if which == "sc2":
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=dev)
        lo, up, off, sc = P_LO, P_UP, OFFSET, SCALE
    elif which == "cs":
        lp = make_log_posterior(_cs_model(2, ia), ia[0], CS_PRIORS[2], device=dev)
        lo, up = CS_LO[2], CS_UP[2]
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
    else:
        lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device=dev)
        lo, up, off, sc = SC3_LO, SC3_UP, SC3_OFFSET, SC3_SCALE
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, up, size=(R * W, len(lo)))
    out = rng.choice(R * W, R * W // 100, replace=False)
    p[out, rng.integers(0, len(lo), out.size)] = -1.0
    q = torch.as_tensor((p - off) / sc, device=dev).float().reshape(R, 2, W // 2, len(lo))
    return lp, off, sc, q.contiguous()


def test_ladder_wrappers_route_by_device(lc):
    """On the CPU the K6 wrappers run their plain versions and launch
    nothing; off the CPU they launch or raise, and plain callables have no
    kernel."""
    lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device="cpu")
    x = torch.as_tensor(_walkers(16)[:12].reshape(3, 2, 2, 4)).contiguous()
    betas = torch.as_tensor(make_beta_ladder(2))
    before = dict(kernels.LAUNCHES)
    pri, ll = ladder.ladder_init(lp, x)
    want = lp.forward_plain(x.reshape(12, 4)).reshape(3, 2, 2)
    fin = torch.isfinite(pri)
    assert torch.equal((pri + ll)[fin], want[fin]) and torch.isneginf(want[~fin]).all()
    u = torch.full((3, 2, 2), 0.5, dtype=torch.float64)
    j = torch.zeros((3, 2, 2), dtype=torch.int64)
    acc = torch.zeros((3, 2, 2), dtype=torch.int32)
    ladder.tempered_half_step(lp, x, pri, ll, betas, 0, u, j, u, n_accept=acc)
    ladder.replica_swap(x, pri, ll, betas, u, 1)
    ladder.rung_block_terms(ll[None].expand(4, 3, 2, 2).contiguous(), betas[1:] - betas[:-1],
                            ((0, 2), (2, 4)))
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    meta = torch.empty((3, 2, 2, 4), device="meta")
    m3 = torch.empty((3, 2, 2), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="K6c runs on CUDA"):
        ladder.replica_swap(meta, m3, m3, torch.empty(3, device="meta"), m3, 0)
    with pytest.raises(ValueError, match="K6d runs on CUDA"):
        ladder.rung_block_terms(torch.empty((4, 3, 4), device="meta"), betas, ((0, 4),))
    with pytest.raises(NotImplementedError, match="CPU"):
        ladder.ladder_init((lambda p: p[:, 0], lambda p: p[:, 0]), meta)


def test_ladder_init_copies_route_and_refuse(lc):
    """``ladder_init(..., copies=K)`` (the ladder's call: one set of
    starting states for every rung): on the CPU the plain version evaluates
    the set once and fills K rows of buffers of their own, equal to the
    states' own values row by row, and launches nothing; ``copies`` must be
    a positive integer (checked before the device is), and off the CPU the
    states must be (S, 2, half, ndim)."""
    lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device="cpu")
    x = torch.as_tensor(_walkers(8).reshape(2, 2, 2, 4)).contiguous()
    before = dict(kernels.LAUNCHES)
    pri1, ll1 = ladder.ladder_init(lp, x)
    pri, ll = ladder.ladder_init(lp, x, copies=3)
    assert kernels.LAUNCHES == before
    assert pri.shape == ll.shape == (6, 2, 2) and pri.is_contiguous() and ll.is_contiguous()
    for r in range(6):
        assert torch.equal(pri[r], pri1[r // 3]) and torch.equal(ll[r], ll1[r // 3])
    pri[0] += 1.0                                  # the rows do not share storage
    assert torch.equal(pri[1], pri1[0])
    assert torch.equal(ladder.ladder_init(lp, x, copies=np.int64(2))[1],
                       ll1.repeat_interleave(2, dim=0))
    meta = torch.empty((1, 2, 2, 4), device="meta")
    for bad in (0, -1, 2.5, True, "2", None):
        for xx in (x, meta):
            with pytest.raises(ValueError, match="copies"):
                ladder.ladder_init(lp, xx, copies=bad)
    with pytest.raises(ValueError, match=r"\(S, 2, half, ndim\)"):
        ladder.ladder_init(lp, torch.empty((2, 2, 4), device="meta"), copies=2)
    with pytest.raises(NotImplementedError, match="CPU"):
        ladder.ladder_init((lambda p: p[:, 0], lambda p: p[:, 0]), meta, copies=2)
    assert kernels.LAUNCHES == before


# K6b's ladders (rungs, walkers): SC2's evidence (16a), PT fit (16b) and
# compare_models (16c); CS2's evidence and PT fit (24c); SC3's ladder of
# chip_smoke.py phase 14; and 5 x 512 beside them
K6B_LADDERS = [("sc2", 17, 4096), ("sc2", 7, 32), ("sc2", 17, 32), ("sc2", 5, 512),
               ("cs", 17, 4096), ("cs", 7, 64), ("sc3", 17, 512), ("sc3", 5, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("which,R,W", K6B_LADDERS,
                         ids=[f"{w}-{r}x{n}" for w, r, n in K6B_LADDERS])
def test_k6b_matches_plain_on_card(lc, lc_flux, cuda_device, request, which, R, W):
    """K6b (a warp per state) against its plain version at the ladders'
    shapes, float32 compute: each rung its own states (copies = 1), and as
    the ladders call it, one set of states written to all R rows (copies =
    R): the same -inf sets, log pi within 1e-12, the likelihood evaluated
    outside the priors too, log L within 1e-5 of |ll - c| + |c|."""
    ia = request.getfixturevalue("ia") if which == "cs" else None
    lp, off, sc, x = _ladder_case(which, lc, lc_flux, cuda_device, R, W, ia=ia)
    x[0, 0, 0, 0] = -1e3                  # the first set holds a state outside the priors too
    fns = ladder.plain_functions(lp, off, sc)
    c = lp.log_likelihood.log_norm_const if which == "sc3" else 0.0
    for xs, copies in ((x, 1), (x[:1], R)):
        n0 = kernels.LAUNCHES["ladder_init"]
        pri, ll = ladder.ladder_init(lp, xs, off, sc, copies=copies)
        assert kernels.LAUNCHES["ladder_init"] == n0 + 1
        assert pri.shape == ll.shape == (R, 2, W // 2)
        want_pri, want_ll = ladder.ladder_init_plain(*fns, xs, copies=copies)
        assert torch.equal(torch.isneginf(pri), torch.isneginf(want_pri))
        fin = torch.isfinite(want_pri)
        assert 0 < int((~fin).sum()) and bool(((pri - want_pri).abs()[fin] <= 1e-12).all())
        # the likelihood is evaluated outside the priors too
        assert int(torch.isfinite(ll).sum()) > int(fin.sum())
        _assert_ll_close(ll, want_ll, 1e-5, c)
    for r in range(R):                     # each of the R rows holds the set's values
        assert torch.equal(pri[r], pri[0]) and torch.equal(ll[r], ll[0])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sc2", "cs"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k6b_repeats_k6a_values_on_card(lc, lc_flux, cuda_device, request, which, f64):
    """K6b and K6a over ShockCooling2 and CompanionShocking2 run one warp
    policy (K6b at a compile-time ndim, K6a at a runtime one): at the
    states two K6a half-steps left at u_acc = 0 (every proposal inside the
    priors accepted, on every rung), K6b gives the log pi and log L that
    K6a stored, bit for bit, at every walker."""
    try:
        if f64:
            config.set_compute_dtype(None)
        ia = request.getfixturevalue("ia") if which == "cs" else None
        R, half = 7, 512
        lp, off, sc, x = _ladder_case(which, lc, lc_flux, cuda_device, R, 2 * half, seed=3,
                                      ia=ia)
        pri, ll = ladder.ladder_init(lp, x, off, sc)
        betas = torch.as_tensor(make_beta_ladder(R - 1), device=cuda_device)
        g = torch.Generator(device=cuda_device).manual_seed(4)
        acc = torch.zeros((R, 2, half), dtype=torch.int32, device=cuda_device)
        for h in (0, 1):
            u_z = torch.rand((R, 2, half), generator=g, device=cuda_device)
            j = torch.randint(0, half, (R, 2, half), generator=g, device=cuda_device)
            ladder.tempered_half_step(lp, x, pri, ll, betas, h, u_z, j, torch.zeros_like(u_z),
                                      2.0, off, sc, acc)
        assert 0.3 < float(acc.float().mean()) < 1.0
        pri2, ll2 = ladder.ladder_init(lp, x, off, sc)
        assert torch.equal(pri2, pri) and torch.equal(ll2, ll)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("which,R,half", [("sc2", 5, 256), ("sc2", 7, 16), ("sc2", 17, 2048),
                                          ("sc3", 5, 128)],
                         ids=["sc2-5x256", "sc2-ptfit-7x16", "sc2-evidence-17x2048",
                              "sc3-5x128"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("h", [0, 1])
def test_k6a_matches_plain_on_card(lc, lc_flux, cuda_device, which, R, half, f64, h):
    """K6a (over ShockCooling2 a warp per walker, over ShockCooling3 a
    thread per walker) against its plain version under shared draws, on R
    rungs x half walkers a half (SC2 at the PT fit's 7 x 16 and the
    evidence's 17 x 2048 besides 5 x 256), float32 and float64: flags equal
    except near-ties, states and log pi bit-equal and log L within 1e-5
    (float32) or 1e-10 (float64) of |ll - c| + |c| where they agree."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp, off, sc, x0 = _ladder_case(which, lc, lc_flux, cuda_device, R, 2 * half, seed=1)
        pri0, ll0 = ladder.ladder_init(lp, x0, off, sc)
        betas = torch.as_tensor(make_beta_ladder(R - 1), device=cuda_device)
        g = torch.Generator(device=cuda_device).manual_seed(2)
        shape = (R, 2, half)
        u_z = torch.rand(shape, generator=g, device=cuda_device)
        j = torch.randint(0, half, shape, generator=g, device=cuda_device)
        u_acc = torch.rand(shape, generator=g, device=cuda_device)
        xk, pk, lk = x0.clone(), pri0.clone(), ll0.clone()
        xp, pp, lpl = x0.clone(), pri0.clone(), ll0.clone()
        ak = torch.zeros(shape, dtype=torch.int32, device=cuda_device)
        ap = torch.zeros_like(ak)
        n0 = kernels.LAUNCHES["tempered_half_step"]
        ladder.tempered_half_step(lp, xk, pk, lk, betas, h, u_z, j, u_acc, 2.0, off, sc, ak)
        assert kernels.LAUNCHES["tempered_half_step"] == n0 + 1
        fns = ladder.plain_functions(lp, off, sc)
        ladder.tempered_half_step_plain(*fns, xp, pp, lpl, betas, h, u_z, j, u_acc, 2.0, ap)
        agree = ak[:, h] == ap[:, h]
        y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
        pri_y, ll_y = fns[0](y), fns[1](y)
        b = betas[:, None]
        c = lp.log_likelihood.log_norm_const if which == "sc3" else 0.0
        ratio = ((x0.shape[-1] - 1.0) * torch.log(z) + pri_y + b * ll_y - pri0[:, h]
                 - b * ll0[:, h])
        gap = (torch.log(u_acc[:, h]).double() - ratio).abs()
        scale = (ll_y - c).abs() + (ll0[:, h] - c).abs() + 2 * abs(c)
        assert bool((agree | (gap <= 1e-5 * scale)).all())
        assert torch.equal(xk[:, h][agree], xp[:, h][agree])
        assert torch.equal(xk[:, 1 - h], x0[:, 1 - h])
        assert torch.equal(ak[:, 1 - h], ap[:, 1 - h])
        assert torch.equal(pk[:, h][agree], pp[:, h][agree])
        _assert_ll_close(lk[:, h][agree], lpl[:, h][agree], 1e-10 if f64 else 1e-5, c)
        assert 0.02 < float(ak[:, h].float().mean()) < 0.98
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("R,half,ndim", [(7, 300, 4), (17, 2048, 4), (17, 16, 4), (7, 16, 4),
                                         (17, 2048, 7), (7, 32, 7), (6, 100, 9), (2, 50, 8),
                                         (1, 8, 5), (4, 10, 1)])
@pytest.mark.parametrize("production", [True, False], ids=["production", "burn-in"])
def test_k6c_matches_plain_bit_for_bit_on_card(cuda_device, parity, f64, R, half, ndim,
                                               production):
    """K6c at the ladders' shapes (the evidence's 17 x 4096, compare_models'
    17 x 32, the PT fits' 7 x 32 and 7 x 64, SC2's 4 and CS's 7 parameters)
    and at odd and even rung counts and every row length of its template,
    a production step (all outputs) and a burn-in step (none): bit for bit
    the plain version."""
    rng = np.random.default_rng(3)
    dt = torch.float64 if f64 else torch.float32
    x = torch.as_tensor(rng.normal(size=(R, 2, half, ndim)), device=cuda_device).to(dt)
    pri = torch.as_tensor(rng.normal(size=(R, 2, half)), device=cuda_device)
    ll = torch.as_tensor(-100.0 + 30.0 * rng.normal(size=(R, 2, half)), device=cuda_device)
    stuck = (min(2, R - 1), 0, slice(0, min(50, half)))
    ll[stuck] = -np.inf                              # NaN-likelihood starts never move
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=cuda_device)   # beta_0 = 0
    u = torch.as_tensor(rng.random((R, 2, half)), device=cuda_device).to(dt)
    outs = []
    for fn in (ladder.replica_swap, ladder.replica_swap_plain):
        state = [x.clone(), pri.clone(), ll.clone()]
        extra = [torch.zeros((R, 2, half), dtype=torch.int32, device=cuda_device),
                 torch.empty((R, 2, half), dtype=torch.float64, device=cuda_device),
                 torch.empty((2, half, ndim), dtype=dt, device=cuda_device)] if production else []
        n0 = kernels.LAUNCHES["replica_swap"]
        fn(*state, betas, u, parity, *extra)
        assert kernels.LAUNCHES["replica_swap"] == n0 + (fn is ladder.replica_swap)
        outs.append(state + extra)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    moved = (outs[0][0] != x).any(dim=-1)
    assert int(moved[stuck].sum()) == 0
    assert bool(moved.any()) == (R >= 2 + parity)   # a pair exists at this parity
    if production:
        n_swap = outs[0][3]
        assert torch.equal(n_swap > 0, moved) and int(n_swap[stuck].sum()) == 0
        assert torch.equal(outs[0][4], outs[0][2]) and torch.equal(outs[0][5], outs[0][0][-1])


@pytest.mark.cuda
def test_k6d_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(4)
    nsteps, R, W = 37, 9, 1000
    ll = torch.as_tensor(-5000.0 - 100.0 * rng.random((nsteps, R, W)), device=cuda_device)
    ll[5, 3, 7] = -np.inf
    db = torch.as_tensor(np.diff(make_beta_ladder(R - 1)), device=cuda_device)
    bounds = tuple((int(i[0]), int(i[-1]) + 1) for i in np.array_split(np.arange(nsteps), 4))
    n0 = kernels.LAUNCHES["rung_block_terms"]
    got = ladder.rung_block_terms(ll, db, bounds)
    assert kernels.LAUNCHES["rung_block_terms"] == n0 + 1
    want = ladder.rung_block_terms_plain(ll, db, bounds)
    assert got.shape == (4, R - 1)
    assert bool(((got - want).abs() <= 1e-12 * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("W", [998, 999], ids=["pairs", "scalar"])
def test_k6d_edge_cases_match_plain_on_card(cuda_device, W):
    """K6d's splits against its plain version where a block holds a NaN, a
    +inf or only -inf (NaN, at the same places), one -inf among finite
    values (it adds 0) and a whole split of -inf in a finite block; blocks
    of 9 and 10 steps that the splits do not divide; 16-byte loads (an even
    walker count) and scalar ones (odd); two launches bit-equal."""
    rng = np.random.default_rng(5)
    nsteps, R = 37, 9
    ll = torch.as_tensor(-5000.0 - 100.0 * rng.random((nsteps, R, W)), device=cuda_device)
    bounds = tuple((int(i[0]), int(i[-1]) + 1) for i in np.array_split(np.arange(nsteps), 4))
    ll[bounds[0][0] + 3, 1, 7] = np.nan
    ll[bounds[1][0] + 2, 2, 5] = np.inf
    ll[bounds[2][0] + 1, 3, 11] = -np.inf
    ll[bounds[3][0]:bounds[3][0] + 3, 4] = -np.inf     # more than a split's values
    ll[bounds[1][0]:bounds[1][1], 5] = -np.inf
    db = torch.as_tensor(np.diff(make_beta_ladder(R - 1)), device=cuda_device)
    items = 9 * (W // 2 if W % 2 == 0 else W)   # the smallest block's pairs, or values
    splits = ladder.k6d_splits(4 * (R - 1), items, gradient.sm_count(cuda_device))
    assert splits > 1 and items % splits != 0
    got = ladder.rung_block_terms(ll, db, bounds)
    want = ladder.rung_block_terms_plain(ll, db, bounds)
    nan = torch.isnan(want)
    assert nan.nonzero().tolist() == [[0, 1], [1, 2], [1, 5]]
    assert torch.equal(torch.isnan(got), nan)
    assert bool(((got - want).abs() <= 1e-12 * want.abs())[~nan].all())
    assert torch.equal(ladder.rung_block_terms(ll, db, bounds).nan_to_num(), got.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(250, 7, 32), (250, 17, 32), (250, 7, 64), (250, 7, 33)],
                         ids=["16b", "16c", "24c_pt", "scalar"])
def test_k6d_one_split_matches_plain_on_card(cuda_device, shape):
    """K6d where a (block, rung) is one split and its CTA writes the term
    itself: the production log L of the PT fits and compare_models (and an
    odd walker count, scalar loads), with a -inf row (a walker's
    NaN-likelihood start on every rung) and the edge cases, against the
    plain version; two launches bit-equal."""
    nsteps, R, W = shape
    rng = np.random.default_rng(6)
    ll = torch.as_tensor(-12990.0 + 10.0 * rng.normal(size=shape), device=cuda_device)
    bounds = tuple((int(i[0]), int(i[-1]) + 1) for i in np.array_split(np.arange(nsteps), 4))
    items = min(b1 - b0 for b0, b1 in bounds) * (W // 2 if W % 2 == 0 else W)
    assert ladder.k6d_splits(4 * (R - 1), items, gradient.sm_count(cuda_device)) == 1
    ll[bounds[0][0] + 5, :, 3] = -np.inf
    ll[bounds[0][0] + 3, 1, 7] = np.nan
    ll[bounds[1][0] + 2, 2, 5] = np.inf
    ll[bounds[2][0] + 1, 3, 11] = -np.inf
    ll[bounds[1][0]:bounds[1][1], 5] = -np.inf
    db = torch.as_tensor(np.diff(make_beta_ladder(R - 1)), device=cuda_device)
    n0 = kernels.LAUNCHES["rung_block_terms"]
    got = ladder.rung_block_terms(ll, db, bounds)
    assert kernels.LAUNCHES["rung_block_terms"] == n0 + 1
    want = ladder.rung_block_terms_plain(ll, db, bounds)
    nan = torch.isnan(want)
    assert nan.nonzero().tolist() == [[0, 1], [1, 2], [1, 5]]
    assert torch.equal(torch.isnan(got), nan)
    assert bool(((got - want).abs() <= 1e-12 * want.abs())[~nan].all())
    assert torch.equal(ladder.rung_block_terms(ll, db, bounds).nan_to_num(), got.nan_to_num())


@pytest.mark.cuda
def test_evidence_runs_through_the_ladder_kernels_on_card(lc, cuda_device, monkeypatch):
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_evidence, lightcurve_ptmcmc

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("tempered_half_step_plain", "ladder_init_plain", "replica_swap_plain",
                 "rung_block_terms_plain"):
        monkeypatch.setattr(ladder, name, no_plain)
    kernels.reset_launch_counts()
    kw = dict(p_lo=list(P_LO), p_up=list(P_UP), nwalkers=64, n_rungs=4, nsteps=20,
              nsteps_burnin=20, seed=3, quiet=True, device=cuda_device)
    log_z, err, info = lightcurve_evidence(lc, ShockCooling2(lc), _priors(), **kw)
    assert np.isfinite(log_z) and np.isfinite(err) and info["acceptance"].shape == (5,)
    for k in ("tempered_half_step", "ladder_init", "replica_swap", "rung_block_terms"):
        assert kernels.LAUNCHES[k] > 0, k
    assert kernels.LAUNCHES["tempered_half_step"] == 80 and kernels.LAUNCHES["replica_swap"] == 40
    pt = lightcurve_ptmcmc(lc, ShockCooling2(lc), _priors(), **kw)
    assert pt.flatchain.shape == (20 * 64, 4) and np.isfinite(pt.flatchain).all()


@pytest.mark.cuda
def test_sc3_evidence_runs_through_the_ladder_kernels_on_card(lc_flux, cuda_device):
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_evidence
    kernels.reset_launch_counts()
    log_z, err, info = lightcurve_evidence(
        lc_flux, ShockCooling3(lc_flux), _sc3_priors(), p_lo=list(SC3_LO), p_up=list(SC3_UP),
        nwalkers=64, n_rungs=3, nsteps=8, nsteps_burnin=8, seed=4, quiet=True,
        device=cuda_device)
    assert np.isfinite(log_z) and np.isfinite(err) and info["acceptance"].shape == (4,)
    assert kernels.LAUNCHES["tempered_half_step"] == 32 and kernels.LAUNCHES["ladder_init"] == 1
    assert kernels.LAUNCHES["replica_swap"] == 16 and kernels.LAUNCHES["rung_block_terms"] == 1


# ------------------------------------------------ the gradient path: K7, K9, K7h

def _whitened(lc, device, n_chains, seed=12):
    """A WhitenedLogPosterior of the flagship as lightcurve_hmc builds it
    (Gaussian priors), its whitening from draws around the converged
    posterior, and n_chains states from those draws."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    pri = [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
           GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]
    lp = make_log_posterior(ShockCooling2(lc), lc, pri, device=device)
    bounds = BoundsTransform([q.p_min for q in pri], [q.p_max for q in pri])
    rng = np.random.default_rng(seed)
    x = np.array([37.58, 5.326, 16.25, 57468.6999]) + rng.normal(size=(400, 4)) * [
        0.145, 0.053, 0.110, 0.00018]
    x[:, 3] = 57468.7 - 1e-6 - np.abs(rng.normal(size=400)) * 0.00018
    warm_u = bounds.to_unbounded(x)
    white = WhitenedPosterior(warm_u)
    w0 = np.ascontiguousarray(white.to_w(warm_u[:n_chains]))
    return WhitenedLogPosterior(lp, bounds, white), torch.as_tensor(w0, device=device)


def test_white_params_layout_matches_the_c_struct():
    """struct WhiteParams: ndim, LP_MAX_DIM = 9 kinds, 5 arrays of
    LP_MAX_DIM doubles and the LP_MAX_DIM^2 Cholesky factor, all 8 bytes
    wide."""
    with open(os.path.join(build.CSRC_DIR, "gradient.cuh")) as f:
        src = f.read()
    body = src[src.index("struct WhiteParams {"):src.index("};", src.index("struct WhiteParams {"))]
    names = [ln.split(";")[0].split("[")[0].split()[-1] for ln in body.splitlines()[1:]
             if ";" in ln]
    assert names == [n for n, _ in gradient._WhiteParams._fields_]
    assert gradient.MAX_DIM == 9
    assert ctypes.sizeof(gradient._WhiteParams) == 8 * (1 + 9 + 5 * 9 + 81)


def test_white_params_follow_the_bounds_bijection():
    """The kernels' block of a whitened space (BoundsTransform.kernel_spec),
    read back as gradient.cuh reads it, gives BoundsTransform's to_bounded
    and log_jacobian for each kind of bound (within 1e-14)."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    bounds = BoundsTransform([0.0, 1.0, -np.inf, -np.inf], [2.0, np.inf, 3.0, np.inf])
    L = np.tril(np.arange(1.0, 17.0).reshape(4, 4))
    white = WhitenedPosterior.from_moments([0.5, -1.0, 2.0, 3.0], L)
    T = gradient.white_params(WhitenedLogPosterior(None, bounds, white), 4)
    assert list(T.kind[:4]) == [1, 2, 3, 0] and list(T.mean[:4]) == [0.5, -1.0, 2.0, 3.0]
    assert np.array_equal(np.array(T.L[:16]).reshape(4, 4), L)
    u = np.array([0.3, -0.7, 1.1, 2.5])
    x, log_j = [], 0.0
    for i, ui in enumerate(u):
        if T.kind[i] == 1:
            s = 1.0 / (1.0 + np.exp(-ui))
            x.append(T.lo[i] + T.width[i] * s)
            log_j += T.log_width[i] + np.log(s) + np.log1p(-s)
        elif T.kind[i] in (2, 3):
            x.append(T.lo[i] + np.exp(ui) if T.kind[i] == 2 else T.hi[i] - np.exp(ui))
            log_j += ui
        else:
            x.append(ui)
    ut = torch.as_tensor(u)
    np.testing.assert_allclose(x, bounds.to_bounded(ut).numpy(), rtol=1e-14)
    np.testing.assert_allclose(log_j, float(bounds.log_jacobian(ut)), rtol=1e-14)


def test_gradient_wrappers_route_by_device(lc, lc_flux):
    lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device="cpu")
    q = torch.as_tensor(_walkers(16))
    target, w = _whitened(lc, "cpu", 4)
    before = dict(kernels.LAUNCHES)
    v, g = kernels.log_posterior_and_grad(lp, q)
    assert torch.equal(v, lp.forward_plain(q)) and g.shape == (16, 4)
    assert torch.equal(g[-4:], torch.zeros((4, 4), dtype=torch.float64))   # -inf rows
    vw, gw = kernels.log_posterior_and_grad(target.log_posterior, w, white=target)
    assert torch.isfinite(vw).all() and torch.isfinite(gw).all()
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    meta = torch.empty((4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="K7 runs on CUDA"):
        sc2.log_posterior_and_grad(lp, meta)
    for form in ("block", "warp"):
        with pytest.raises(ValueError, match="K7's forms run on CUDA"):
            sc2.logpost_grad_launch(lp, q, None, form)
    with pytest.raises(ValueError, match="'block' or 'warp'"):
        sc2.logpost_grad_launch(lp, q, None, "lane")
    args = (meta, meta[:, 0], meta, torch.empty((4, 3, 6), dtype=torch.float64, device="meta"),
            meta[0, 0], meta[0])
    with pytest.raises(ValueError, match="K9 runs on CUDA"):
        gradient.nuts_transition(target, *args, 3)
    with pytest.raises(ValueError, match="K7h runs on CUDA"):
        gradient.hmc_transition(target, meta, meta[:, 0], meta, meta[:, 0],
                                meta[:, 0].long(), meta[0, 0], meta[0], 4)
    lp3 = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(), device="cpu")
    with pytest.raises(NotImplementedError, match="ShockCooling3 has no gradient kernel"):
        kernels.log_posterior_and_grad(lp3, torch.empty((4, 7), dtype=torch.float64,
                                                        device="meta"))


@pytest.mark.parametrize("n_sm", [132, 114])
def test_k7_form_runs_a_block_per_row_where_the_rows_leave_the_card_idle(n_sm):
    """k7_form: the block form at the gradient path's small widths on an
    H100 (SXM 132 SMs, PCIe 114): one row (fitting.py's), the Laplace
    Hessian's 6, the MAP's 64 starts, up to the crossover of
    K7_BLOCK_ROWS_PER_SM rows an SM; the warp form above it and at the
    131072 walkers of the large fits. The rule scales with the SM count."""
    cross = gradient.K7_BLOCK_ROWS_PER_SM * n_sm
    for W in (1, 6, 64, cross - 1, cross):
        assert gradient.k7_form(W, n_sm) == "block", W
    for W in (cross + 1, 4096 if cross < 4096 else cross + 2, 131072):
        assert gradient.k7_form(W, n_sm) == "warp", W
    assert gradient.k7_form(cross // n_sm, 1) == "block"
    assert gradient.k7_form(cross // n_sm + 1, 1) == "warp"


def _transitions_agree(got, want, gaps, gap_nats, rel):
    """Per chain: the same depth and divergence flag (K9), q' within rel and
    logp' within rel |logp|, except near-ties (a decision within gap_nats,
    or a U-turn criterion within rel, of going the other way)."""
    same = ((got[0] - want[0]).abs() <= rel).all(dim=1) \
        & ((got[1] - want[1]).abs() <= rel * want[1].abs())
    for k in range(3, len(got)):
        same &= got[k].to(torch.int64) == want[k].to(torch.int64)
    near = gaps[0] < gap_nats
    if len(gaps) > 1:
        near |= gaps[1] < rel
    assert bool((same | near).all()) and bool(same.any())


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k7_matches_plain_on_card(lc, cuda_device, f64):
    """K7 against autograd through forward_plain: values as K1's, gradients
    within 1e-4 (float32) and 1e-9 (float64) of their per-point terms'
    summed magnitudes (LogPosterior.grad_term_scales), zero (masked) at the
    same places; also in the whitened space of the gradient samplers."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
        wide = make_log_posterior(ShockCooling2(lc), lc, _priors(57480.0), device=cuda_device)
        late = np.random.default_rng(1).uniform([20, 2, 10, 57468.8], [50, 5, 50, 57472.0],
                                                size=(512, 4))
        rel, grel = (1e-10, 1e-9) if f64 else (1e-5, 1e-4)
        for lp_, p in ((lp, _walkers(4096)), (wide, late)):
            p = torch.as_tensor(p, device=cuda_device)
            n0 = kernels.LAUNCHES["logpost_grad"]
            v, g = kernels.log_posterior_and_grad(lp_, p)
            assert kernels.LAUNCHES["logpost_grad"] == n0 + 1
            vp, gp = sc2.log_posterior_and_grad_plain(lp_, p)
            _assert_ll_close(v, vp, rel)
            assert torch.equal(g == 0, gp == 0)
            assert bool(((g - gp).abs() <= grel * lp_.grad_term_scales(p)).all())
        target, w = _whitened(lc, cuda_device, 64)
        v, g = kernels.log_posterior_and_grad(target.log_posterior, w, white=target)
        vp, gp = target.logp_and_grad_plain(w)
        _assert_ll_close(v, vp, rel)
        assert bool(((g - gp).abs() <= (1e-2 if not f64 else 1e-6) * (1 + gp.abs())).all())
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k9_matches_plain_on_card(lc, cuda_device, f64):
    """K9 against the plain transition under shared draws (16 whitened
    flagship chains, max_depth 7): in float64 over the plain gradient, in
    float32 over K7's own evaluations; equal except near-ties."""
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition
    try:
        if f64:
            config.set_compute_dtype(None)
        target, q0 = _whitened(lc, cuda_device, 16)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(5)
        z = torch.randn((16, 4), generator=g, device=cuda_device, dtype=torch.float64)
        u = torch.rand((16, 7, 66), generator=g, device=cuda_device, dtype=torch.float64)
        eps = torch.tensor(0.1, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(4, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        n0 = kernels.LAUNCHES["nuts_transition"]
        got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, 7)
        assert kernels.LAUNCHES["nuts_transition"] == n0 + 1
        fn = target.logp_and_grad_plain if f64 else target.logp_and_grad
        want = make_nuts_transition(fn, 4, 7, margins=True)(q0, logp0, z, u, eps, inv_mass)
        _transitions_agree(got, want[:5], want[5:], 1e-6 if f64 else 1e-3, 1e-8)
        assert got[3].min() >= 1 and got[3].max() > 1
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k9_deep_trees_match_plain_on_card(lc_ext, cuda_device, f64):
    """K9 against the plain transition on deep trees (eps 0.005, max_depth
    12): subtrees of 64 steps and more spread their U-turn blocks and Gumbel
    pick over the lanes; the float32 trajectory buffer lies in shared memory,
    the float64 one in the global scratch."""
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition
    try:
        if f64:
            config.set_compute_dtype(None)
        target, q0 = _whitened(lc_ext, cuda_device, 16)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(7)
        z = torch.randn((16, 4), generator=g, device=cuda_device, dtype=torch.float64)
        u = torch.rand((16, 12, 2050), generator=g, device=cuda_device, dtype=torch.float64)
        eps = torch.tensor(0.005, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(4, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, 12)
        fn = target.logp_and_grad_plain if f64 else target.logp_and_grad
        want = make_nuts_transition(fn, 4, 12, margins=True)(q0, logp0, z, u, eps, inv_mass)
        _transitions_agree(got, want[:5], want[5:], 1e-6 if f64 else 1e-3, 1e-8)
        assert got[3].max() >= 7
        assert (gradient.nuts_scratch_len(target, 16, 12, cuda_device) > 0) == f64
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k7h_matches_plain_on_card(lc, cuda_device, f64):
    from lightcurve_fitting_tpu_torch.parallel.hmc import hmc_transition_plain
    try:
        if f64:
            config.set_compute_dtype(None)
        target, q0 = _whitened(lc, cuda_device, 16)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(6)
        z = torch.randn((16, 4), generator=g, device=cuda_device, dtype=torch.float64)
        u_acc = torch.rand(16, generator=g, device=cuda_device, dtype=torch.float64)
        n_used = torch.randint(8, 17, (16,), generator=g, device=cuda_device)
        eps = torch.tensor(0.1, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(4, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        args = (q0, logp0, z, u_acc, n_used, eps, inv_mass, 16)
        got = gradient.hmc_transition(target, *args)
        fn = target.logp_and_grad_plain if f64 else target.logp_and_grad
        want = hmc_transition_plain(fn, *args, margins=True)
        _transitions_agree(got, want[:3], want[3:], 1e-6 if f64 else 1e-3, 1e-8)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [4, 5], ids=["no-sigma", "sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k7_block_and_warp_forms_are_bit_equal_on_card(lc, cuda_device, f64, ndim):
    """K7's block form (a block per row) and its warp form (a warp per row)
    give the same bits, value and gradient, at 1, 6 and 64 rows and at
    k7_form's crossover and one row either side, in the model's parameters
    (rows outside the priors and NaN among them) and in the whitened space;
    ndim 5 with the intrinsic scatter. The wrapper runs k7_form's form."""
    try:
        if f64:
            config.set_compute_dtype(None)
        if ndim == 4:
            lp = make_log_posterior(ShockCooling2(lc), lc, _priors(), device=cuda_device)
            target, _ = _whitened(lc, cuda_device, 1)
        else:
            lp, lo, up = _sigma_case("sc2", lc, None, cuda_device, "relative")
            target, _ = _whitened_sigma(lc, cuda_device, 1, "relative")
        cross = gradient.K7_BLOCK_ROWS_PER_SM * gradient.sm_count(cuda_device)
        n = cross + 1
        base = _walkers(n, 3) if ndim == 4 else _window_walkers(lo, up, n, 3)
        wbase = np.random.default_rng(4).normal(size=(n, ndim))
        for W in (1, 6, 64, cross - 1, cross, cross + 1):
            rows = base[:1] if W == 1 else base[-W:]      # the last rows outside the priors
            for lp_, p, white in ((lp, rows, None), (target.log_posterior, wbase[:W], target)):
                p = torch.as_tensor(np.ascontiguousarray(p), device=cuda_device)
                n0 = kernels.LAUNCHES["logpost_grad"]
                vb, gb = sc2.logpost_grad_launch(lp_, p, white, "block")
                vw, gw = sc2.logpost_grad_launch(lp_, p, white, "warp")
                assert kernels.LAUNCHES["logpost_grad"] == n0 + 2
                assert torch.equal(vb, vw) and torch.equal(gb, gw), (W, white is not None)
                v, g = kernels.log_posterior_and_grad(lp_, p, white=white)
                assert torch.equal(v, vb) and torch.equal(g, gb)
                assert torch.isfinite(vb).any()
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k7h_block_matches_the_transition_over_k7_on_card(lc, cuda_device, f64, C):
    """K7h (a block per chain) at lightcurve_hmc's 16 chains and at 64
    against the plain transition over K7's own evaluations under shared
    draws (32 jittered leapfrogs, eps 0.1): the same arithmetic but for the
    leapfrog's kicks and drifts, so equal except near-ties."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import hmc_transition_plain
    try:
        if f64:
            config.set_compute_dtype(None)
        target, q0 = _whitened(lc, cuda_device, C)
        g = torch.Generator(device=cuda_device).manual_seed(9)
        z = torch.randn((C, 4), generator=g, device=cuda_device, dtype=torch.float64)
        u_acc = torch.rand(C, generator=g, device=cuda_device, dtype=torch.float64)
        n_used = torch.randint(16, 33, (C,), generator=g, device=cuda_device)
        eps = torch.tensor(0.1, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(4, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        args = (q0, logp0, z, u_acc, n_used, eps, inv_mass, 32)
        n0 = kernels.LAUNCHES["hmc_transition"]
        got = gradient.hmc_transition(target, *args)
        assert kernels.LAUNCHES["hmc_transition"] == n0 + 1
        want = hmc_transition_plain(target.logp_and_grad, *args, margins=True)
        _transitions_agree(got, want[:3], want[3:], 1e-6 if f64 else 1e-3, 1e-8)
        accepted = (got[0] != q0).any(dim=1)
        assert bool(accepted.any())
        assert torch.equal(target.logp_and_grad(got[0])[0][accepted], got[1][accepted])
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
def test_gradient_fits_run_through_the_kernels_on_card(lc, cuda_device, monkeypatch):
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_hmc, lightcurve_map

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("nuts_transition_plain", "hmc_transition_plain"):
        monkeypatch.setattr(gradient, name, no_plain)
    monkeypatch.setattr(sc2, "log_posterior_and_grad_plain", no_plain)
    pri = _whitened(lc, "cpu", 1)[0].log_posterior.priors
    kernels.reset_launch_counts()
    r = lightcurve_map(lc, ShockCooling2(lc), pri, n_starts=8, n_iter=50, seed=0, quiet=True,
                       device=cuda_device)
    assert np.isfinite(r.parameters).all() and kernels.LAUNCHES["logpost_grad"] >= 52
    for sampler in ("nuts", "hmc"):
        res = lightcurve_hmc(lc, ShockCooling2(lc), pri, nchains=4, nsamples=10, n_warmup=10,
                             warmup_walkers=32, warmup_steps=20, sampler=sampler, seed=1,
                             quiet=True, device=cuda_device)
        assert res.flatchain.shape == (40, 4) and np.isfinite(res.flatchain).all()
    assert kernels.LAUNCHES["nuts_transition"] == 20 and kernels.LAUNCHES["hmc_transition"] == 20



# ------------------------------------------- the intrinsic scatter on the card

def _assert_scaled(got, want, rel, scale):
    """Same -inf sets, |got - want| <= rel * scale where finite."""
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    d = (got - want).abs()[fin] / scale[fin]
    assert bool((d <= rel).all()), float(d.max())


_SIGMA_PRIOR = LogUniformPrior(0.01, 10.0)


def _sigma_case(which, lc, lc_flux, device, sigma_type, ia=None):
    """A LogPosterior with the intrinsic scatter, SC2 (5 parameters), SC3
    (8) or CS1 (9, on the synthetic Ia curve ``ia``), and its init window
    (sigma in [0.5, 3] dy units)."""
    if which == "sc2":
        lp = make_log_posterior(ShockCooling2(lc), lc, _priors() + [_SIGMA_PRIOR], use_sigma=True,
                                sigma_type=sigma_type, device=device)
        return lp, np.append(P_LO, 0.5), np.append(P_UP, 3.0)
    if which == "cs1":
        lp = make_log_posterior(_cs_model(1, ia), ia[0], CS_PRIORS[1] + [_SIGMA_PRIOR],
                                use_sigma=True, sigma_type=sigma_type, device=device)
        return lp, np.append(CS_LO[1], 0.5), np.append(CS_UP[1], 3.0)
    lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors() + [_SIGMA_PRIOR],
                            use_sigma=True, sigma_type=sigma_type, device=device)
    return lp, np.append(SC3_LO, 0.5), np.append(SC3_UP, 3.0)


def _window_walkers(lo, up, n, seed):
    """n walkers from the window [lo, up], the last three outside the priors
    (sigma < 0, the first parameter < 0, NaN)."""
    p = np.random.default_rng(seed).uniform(lo, up, size=(n, len(lo)))
    p[-3, -1], p[-2, 0], p[-1, 1] = -0.5, -1.0, np.nan
    return p


@pytest.mark.parametrize("which", ["sc2", "sc3", "cs1"])
def test_sigma_yardstick_bounds_float32_rounding(lc, lc_flux, request, which):
    """The scale the use_sigma kernels are held to bounds the plain
    version's own float32 rounding against its float64 evaluation, with a
    margin of 2 under the card's 1e-5 budget (the kernel and the plain
    version differ by less: the same float32 operations in another order)."""
    ia = request.getfixturevalue("ia") if which == "cs1" else None
    lp64, lo, up = _sigma_case(which, lc, lc_flux, "cpu", "relative", ia)
    p = torch.as_tensor(_window_walkers(lo, up, 256, 0))
    want = lp64.forward_plain(p)
    try:
        config.set_compute_dtype(torch.float32)
        lp32 = _sigma_case(which, lc, lc_flux, "cpu", "relative", ia)[0]
        got = lp32.forward_plain(p)
        scale = lp32.log_likelihood.term_scales(p)
    finally:
        config.set_compute_dtype(config.AUTO)
    _assert_scaled(got, want, 0.5e-5, scale)


def test_term_scales_without_scatter_are_the_ll_scale(lc):
    """Without the intrinsic scatter every residual term is >= 0, so
    LogLikelihood.term_scales is |ll - c| + |c|, c = log_norm_const."""
    ll = make_log_posterior(ShockCooling2(lc), lc, _priors(), device="cpu").log_likelihood
    p = torch.as_tensor(np.random.default_rng(0).uniform(P_LO, P_UP, size=(64, 4)))
    c = ll.log_norm_const
    torch.testing.assert_close(ll.term_scales(p), (ll(p) - c).abs() + abs(c), rtol=1e-12, atol=0)
    assert ll.term_scales(p[0]).shape == () and ll.term_scales(p[:0]).shape == (0,)


def _warp_order_sum(terms):
    """The residual sum of the warp forms (csrc/sc2_logpost.cu,
    ``sc2_log_likelihood_warp`` of K2 and K6a, and K7's value;
    csrc/companion.cu, ``cs_log_likelihood_warp``; csrc/sc3_logpost.cu,
    ``sc3_log_likelihood_warp``, on the terms taken in ``sc3.point_order``)
    over (W, N) terms, in their dtype: lane l sums points l, l + 32, l + 64,
    ... in that order, then the butterfly (offsets 16, 8, 4, 2, 1), each
    lane adding lane l ^ o's value. Returns (W, 32): every lane's sum."""
    lanes = torch.zeros((terms.shape[0], 32), dtype=terms.dtype)
    for n in range(terms.shape[1]):
        lanes[:, n % 32] = lanes[:, n % 32] + terms[:, n]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
    return lanes


@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
def test_sc2_warp_sum_order_stays_within_the_yardstick(lc_ext, sigma_type):
    """K2 and K6a over ShockCooling2 run a warp per walker, which sums a
    walker's 149 residual terms in another order than the plain version
    (and K1). Emulated in float32 on 1024 flagship walkers from the
    131072-walker fit's window (with the scatter, sigma in [0.5, 3] dy
    units), that order gives every lane the same bits, stays within 1e-5 of
    the term scale (the card tests' float32 tolerance) of the plain float32
    sum and of the JAX package's float64 log-posterior, and differs from the
    plain sum on some walker: the tolerance, not bit equality, is what holds
    the kernels to their plain versions. (The JAX package is imported here,
    not with the module, whose card tests run where it is not installed.)"""
    jax = pytest.importorskip("jax", reason="the JAX package's reference needs jax")
    pytest.importorskip("matplotlib", reason="the JAX package's LC needs matplotlib")
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make
    from lightcurve_fitting_tpu.lightcurve import LC as JLC
    from lightcurve_fitting_tpu.models import (LogUniformPrior as JLU, ShockCooling2 as JSC2,
                                               UniformPrior as JU)
    use_sigma = sigma_type is not None
    jlc = JLC.read(EXAMPLE)
    jlc.meta.update(dm=30.79, redshift=0.002, extinction={
        "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
        "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
    jlc.calcAbsMag()
    jlc.calcLum()
    jlc = jlc.where(MJD_min=57468.0, MJD_max=57485.0)
    jpriors = [JU(0.0, 100.0), JU(0.0, 100.0), JU(0.0, 100.0), JU(57468.0, 57468.7)]
    lo, up = P_LO, P_UP
    if use_sigma:
        jpriors.append(JLU(0.01, 10.0))
        lo, up = np.append(P_LO, 0.5), np.append(P_UP, 3.0)
    p = np.random.default_rng(12).uniform(lo, up, size=(1024, len(lo)))
    want = np.asarray(jax.vmap(j_make(JSC2(jlc), jlc, jpriors, use_sigma,
                                      sigma_type or "relative"))(jnp.asarray(p)))
    assert want.dtype == np.float64
    q = torch.as_tensor(p)
    try:
        config.set_compute_dtype(torch.float32)
        lp = make_log_posterior(ShockCooling2(lc_ext), lc_ext,
                                _priors() + ([_SIGMA_PRIOR] if use_sigma else []),
                                use_sigma=use_sigma, sigma_type=sigma_type or "relative",
                                device="cpu")
        ll = lp.log_likelihood
        terms = ll.residual_terms(q)
        plain = ll(q).double()
        scale = ll.term_scales(q)
        prior = lp.log_prior_plain(q)
    finally:
        config.set_compute_dtype(config.AUTO)
    assert terms.dtype == torch.float32 and tuple(terms.shape) == (1024, 149)
    lanes = _warp_order_sum(terms)
    assert torch.equal(lanes, lanes[:, :1].expand(-1, 32))
    const = torch.tensor(ll.offset if use_sigma else ll.log_norm_const, dtype=torch.float32)
    warp = (torch.tensor(-0.5, dtype=torch.float32) * lanes[:, 0] + const).double()
    assert torch.isfinite(warp).all() and torch.isfinite(plain).all()
    assert torch.isfinite(prior).all()
    assert bool(((warp - plain).abs() <= 1e-5 * scale).all())
    assert bool((warp != plain).any())
    assert np.all(np.abs((prior + warp).numpy() - want) <= 1e-5 * scale.numpy())



@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
def test_sc3_warp_sum_order_stays_within_the_yardstick(lc_flux, sigma_type):
    """The SC3 log-posterior, half-step (and so a fit's initial state and
    every later value) run a warp per walker, whose lanes take the points in
    ``sc3.point_order`` (lane l: order[l], order[l + 32], ...) and a
    butterfly sums the lanes: another order than the plain version's.
    Emulated in float32 on 1024 walkers of the SC3 init window (with the
    scatter, sigma in [0.5, 3] dy units), that order gives every lane the
    same bits, stays within 1e-5 of the term scale (the card tests' float32
    tolerance) of the plain float32 sum and of the JAX package's float64
    log-posterior, and differs from the plain sum on some walker. (The JAX
    package is imported here, not with the module, whose card tests run
    where it is not installed.)"""
    jax = pytest.importorskip("jax", reason="the JAX package's reference needs jax")
    pytest.importorskip("matplotlib", reason="the JAX package's LC needs matplotlib")
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.fitting import make_log_posterior as j_make
    from lightcurve_fitting_tpu.lightcurve import LC as JLC
    from lightcurve_fitting_tpu.models import (LogUniformPrior as JLU, ShockCooling3 as JSC3,
                                               UniformPrior as JU)
    use_sigma = sigma_type is not None
    jlc = JLC.read(EXAMPLE)
    jlc.meta.update(dm=30.79, redshift=0.002)
    jlc.calcAbsMag()
    jlc.calcLum()
    jlc = jlc.where(MJD_min=57468.0, MJD_max=57485.0)
    jlc.calcFlux()
    jpriors = [JU(p.p_min, p.p_max) for p in _sc3_priors()]
    lo, up = SC3_LO, SC3_UP
    if use_sigma:
        jpriors.append(JLU(0.01, 10.0))
        lo, up = np.append(SC3_LO, 0.5), np.append(SC3_UP, 3.0)
    p = np.random.default_rng(13).uniform(lo, up, size=(1024, len(lo)))
    want = np.asarray(jax.vmap(j_make(JSC3(jlc), jlc, jpriors, use_sigma,
                                      sigma_type or "relative"))(jnp.asarray(p)))
    assert want.dtype == np.float64
    q = torch.as_tensor(p)
    try:
        config.set_compute_dtype(torch.float32)
        lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux,
                                _sc3_priors() + ([_SIGMA_PRIOR] if use_sigma else []),
                                use_sigma=use_sigma, sigma_type=sigma_type or "relative",
                                device="cpu")
        ll = lp.log_likelihood
        terms = ll.residual_terms(q)
        plain = ll(q).double()
        scale = ll.term_scales(q)
        prior = lp.log_prior_plain(q)
    finally:
        config.set_compute_dtype(config.AUTO)
    assert terms.dtype == torch.float32 and tuple(terms.shape) == (1024, 149)
    lanes = _warp_order_sum(terms[:, sc3.point_order(ll)])
    assert torch.equal(lanes, lanes[:, :1].expand(-1, 32))
    const = torch.tensor(ll.offset if use_sigma else ll.log_norm_const, dtype=torch.float32)
    warp = (torch.tensor(-0.5, dtype=torch.float32) * lanes[:, 0] + const).double()
    assert torch.isfinite(warp).all() and torch.isfinite(plain).all()
    assert torch.isfinite(prior).all()
    assert bool(((warp - plain).abs() <= 1e-5 * scale).all())
    assert bool((warp != plain).any())
    assert np.all(np.abs((prior + warp).numpy() - want) <= 1e-5 * scale.numpy())

def _epoch_warp_emulation(ep, q):
    """The epoch log-posterior and its gradient as the warp forms compute
    them (csrc/epoch_bb.cu ``epoch_log_posterior_warp``, the epoch half-step
    and K4p), in ``ep``'s compute dtype, at q (E, M, ndim) float64 inside
    the priors: band_flux's Planck terms from the node factors c1 nu and
    nu^3, each band's sum and its T derivative in the warp order
    (``_warp_order_sum``), then the bands, residuals and the thread form's
    gradient in band order. Returns (lp (E, M), grad (E, M, ndim)) float64;
    asserts that every lane holds the same band sums."""
    from lightcurve_fitting_tpu_torch.core.constants import c1, c2
    cdt = ep.compute_dtype
    one, zero, half = (torch.tensor(v, dtype=cdt) for v in (1.0, 0.0, -0.5))
    T, R = q[..., 0].to(cdt), q[..., 1].to(cdt)
    sig = q[..., -1].to(cdt) if ep.use_sigma else torch.zeros_like(T)
    inv_T = torch.where(T > 0, one / T, zero)
    c2R2 = torch.tensor(c2, dtype=cdt) * (R * R)
    acc, gT, gR, gS = (torch.zeros(T.shape, dtype=cdt) for _ in range(4))
    for e, b in zip(*np.nonzero(ep.mask.numpy())):
        n = int(ep.n_native[e, b])
        nu, w = ep.nodes[e, b, :n], ep.weights[e, b, :n]
        x = (torch.tensor(c1, dtype=cdt) * nu) * inv_T[e, :, None]          # (M, n)
        ex = torch.expm1(x)
        pdi = torch.where(ex > 0, one / ex, zero)
        lnu = (c2R2[e, :, None] * ((nu * nu) * nu)) * pdi
        lanes = _warp_order_sum(w * lnu)
        dlanes = _warp_order_sum(torch.where(lnu != 0, w * (lnu * (one + pdi)
                                                            * (x * inv_T[e, :, None])), zero))
        assert torch.equal(lanes, lanes[:, :1].expand(-1, 32))
        assert torch.equal(dlanes, dlanes[:, :1].expand(-1, 32))
        S, dS = lanes[:, 0], dlanes[:, 0]
        y_fit = S * ep.inv_yscale[e]
        y, dy, inv_dy, su = ep.y[e, b], ep.dy[e, b], ep.inv_dy[e, b], ep.sigma_units[e, b]
        if ep.use_sigma:
            sg = sig[e] * su
            sigma2 = dy * dy + sg * sg
            res = y - y_fit
            acc[e] = acc[e] + (torch.log(torch.tensor(6.283185307179586, dtype=cdt) * sigma2)
                               + res * res / sigma2)
            dll = res / sigma2
            gS[e] = gS[e] + (-(sg * su)) * (one / sigma2 - (res * res) / (sigma2 * sigma2))
        else:
            r = (y - y_fit) * inv_dy
            acc[e] = acc[e] + r * r
            dll = r * inv_dy
        gy = dll * ep.inv_yscale[e]
        gT[e] = gT[e] + gy * dS
        gR[e] = gR[e] + gy * torch.where(R[e] != 0, (S + S) / R[e], zero)
    ll = (half * acc).double() + (0.0 if ep.use_sigma else ep.log_norm[:, None])
    p = q.clone().requires_grad_(True)
    log_prior = sum(prior(p[..., i]) for i, prior in enumerate(ep.priors))
    g, = torch.autograd.grad(log_prior.sum(), p)
    g[..., 0] += gT.double()
    g[..., 1] += gR.double()
    if ep.use_sigma:
        g[..., -1] += gS.double()
    return log_prior.detach() + ll, g


@pytest.mark.parametrize("sigma_type", [None, "relative", "absolute"],
                         ids=["no-sigma", "sigma-relative", "sigma-absolute"])
def test_epoch_warp_sum_order_stays_within_the_yardstick(sigma_type):
    """The epoch half-step and K4p run a warp per walker, whose lanes split
    each band's Planck terms: another sum order than the plain version's
    and K4's thread form. Emulated in float32 (``_epoch_warp_emulation``)
    on 8 synthetic epochs x 64 vectors near their data, that order stays
    within the card tests' yardsticks (``EpochPosterior.term_scales``: 1e-5
    of the log-posterior's, 1e-4 of the gradient's) of the plain float32
    value and autograd gradient and of the JAX package's float64
    ``_make_epoch_logpost`` and its ``jax.grad``, and the value differs
    from the plain sum on some vector: the tolerance, not bit equality,
    holds the warp kernels to their plain versions. (The JAX package is
    imported here, not with the module, whose card tests run where it is
    not installed.)"""
    jax = pytest.importorskip("jax", reason="the JAX package's reference needs jax")
    import jax.numpy as jnp
    from lightcurve_fitting_tpu.models import (GaussianPrior as JG, LogUniformPrior as JLU,
                                               UniformPrior as JU)
    from lightcurve_fitting_tpu.parallel import batched as jb
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    jpriors = [JU(1.0, 100.0), JLU(0.01, 1000.0)] + ([JG(0.0, 10.0)] if use_sigma else [])
    packed = _epoch_pack(8, "cpu")
    rng = np.random.default_rng(9)
    q = np.exp(rng.uniform(np.log([4.0, 1.0]), np.log([20.0, 30.0]), size=(8, 64, 2)))
    if use_sigma:
        q = np.concatenate([q, rng.uniform(0.5, 3.0, size=(8, 64, 1))], axis=-1)
    make = jb._make_epoch_logpost(jpriors, np.inf, use_sigma, sigma_type or "relative", None)
    want, g_want = [], []
    for e in range(8):
        lp_e = make(*[jnp.asarray(packed[k][e].numpy())
                      for k in ("y", "dy", "mask", "nodes", "weights", "yscale")])
        want.append(np.asarray(jax.vmap(lp_e)(jnp.asarray(q[e]))))
        g_want.append(np.asarray(jax.vmap(jax.grad(lp_e))(jnp.asarray(q[e]))))
    want, g_want = torch.as_tensor(np.stack(want)), torch.as_tensor(np.stack(g_want))
    assert want.dtype == torch.float64
    q = torch.as_tensor(q)
    try:
        config.set_compute_dtype(torch.float32)
        ep = batched.EpochPosterior(packed, priors, use_sigma=use_sigma,
                                    sigma_type=sigma_type or "relative")
        lp, grad = _epoch_warp_emulation(ep, q)
        qq = q.clone().requires_grad_(True)
        plain = ep.plain(qq)
        g_plain, = torch.autograd.grad(plain.sum(), qq)
        ll_scale, g_scale = ep.term_scales(q)
    finally:
        config.set_compute_dtype(config.AUTO)
    plain = plain.detach()
    assert torch.isfinite(lp).all() and torch.isfinite(plain).all() and torch.isfinite(want).all()
    for ref, g_ref in ((plain, g_plain), (want, g_want)):
        assert bool(((lp - ref).abs() <= 1e-5 * ll_scale).all())
        assert bool(((grad - g_ref).abs() <= 1e-4 * (g_scale + g_ref.abs())).all())
    assert bool((lp != plain).any())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sc2", "sc3"])
@pytest.mark.parametrize("sigma_type", ["relative", "absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_use_sigma_logpost_kernels_match_plain_on_card(lc, lc_flux, cuda_device, which,
                                                       sigma_type, f64):
    """K1 (SC2, 5 parameters) or the SC3 log-posterior (8) with the
    intrinsic scatter, and K6b over it, against their plain versions:
    within 1e-5 (float32) and 1e-10 (float64) of the term scale, the same
    -inf sets, log pi within 1e-12."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp, lo, up = _sigma_case(which, lc, lc_flux, cuda_device, sigma_type)
        p = torch.as_tensor(_window_walkers(lo, up, 2048, 1), device=cuda_device)
        rel = 1e-10 if f64 else 1e-5
        name = "sc2_logpost" if which == "sc2" else "sc3_logpost"
        n0 = kernels.LAUNCHES[name]
        got = lp(p)
        assert kernels.LAUNCHES[name] == n0 + 1
        _assert_scaled(got, lp.forward_plain(p), rel, lp.log_likelihood.term_scales(p))
        assert torch.isneginf(got[-3:]).all() and torch.isfinite(got[:-3]).all()
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        x = torch.as_tensor((p[:2040].cpu().numpy() - off) / sc, device=cuda_device).float()
        x = x.reshape(4, 2, 255, len(lo)).contiguous()
        pri, ll = ladder.ladder_init(lp, x, off, sc)
        want_pri, want_ll = ladder.ladder_init_plain(*ladder.plain_functions(lp, off, sc), x)
        fin = torch.isfinite(want_pri)
        assert torch.equal(torch.isneginf(pri), torch.isneginf(want_pri))
        assert bool(((pri - want_pri).abs()[fin] <= 1e-12).all())
        pa = common.absolute_params(x, off, sc)
        _assert_scaled(ll, want_ll, rel, lp.log_likelihood.term_scales(pa))
    finally:
        config.set_compute_dtype(config.AUTO)


def _half_step_case(lp, off, sc, x0, h, seed, rel):
    """One kernel half-step (K2 or the SC3 one, by the model) against the
    plain one under shared draws: accept flags equal except near-ties
    (within 1e-5 of the term scale), new states bit-equal and new
    log-posteriors within ``rel`` of the term scale where they agree."""
    dev = x0.device
    half, ndim = x0.shape[1], x0.shape[2]
    l0 = kernels.log_posterior(lp, x0.reshape(-1, ndim), off, sc).reshape(2, half)
    g = torch.Generator(device=dev).manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)
    xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
    ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
    ap = torch.zeros_like(ak)
    kernels.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, off, sc, n_accept=ak)

    def plain(q):   # in chunks: SC3's plain version holds a (W, 149, 89) cube
        return torch.cat([common.log_posterior_plain(lp, c, off, sc) for c in q.split(4096)])
    common.stretch_half_step_plain(plain, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
    agree = ak[h] == ap[h]
    y, z = common.propose_stretch(u_z, j, x0[h], x0[1 - h])
    gap = (torch.log(u_acc).double() - ((ndim - 1.0) * torch.log(z).double() + plain(y)
                                        - l0[h])).abs()
    scale = lp.log_likelihood.term_scales(common.absolute_params(y, off, sc)) \
        + lp.log_likelihood.term_scales(common.absolute_params(x0[h], off, sc))
    assert bool((agree | (gap <= 1e-5 * scale)).all())
    assert torch.equal(xk[h][agree], xp[h][agree])
    assert torch.equal(xk[1 - h], x0[1 - h]) and torch.equal(ak[1 - h], ap[1 - h])
    _assert_scaled(lk[h][agree], lpp[h][agree], rel,
                   lp.log_likelihood.term_scales(common.absolute_params(xk[h], off, sc))[agree])
    assert 0.02 < float(ak[h].float().mean()) < 0.98


def _tempered_case(lp, off, sc, x0, h, seed, rel):
    """One K6a half-step of every rung against the plain one under shared
    draws: flags equal except near-ties, states and log pi bit-equal and
    log L within ``rel`` of the term scale where they agree, the other half
    and its accept counts untouched."""
    dev = x0.device
    R, _, half, ndim = x0.shape
    pri0, ll0 = ladder.ladder_init(lp, x0, off, sc)
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (R, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev)
    xk, pk, lk = x0.clone(), pri0.clone(), ll0.clone()
    xp, pp, lpl = x0.clone(), pri0.clone(), ll0.clone()
    ak = torch.zeros(shape, dtype=torch.int32, device=dev)
    ap = torch.zeros_like(ak)
    n0 = kernels.LAUNCHES["tempered_half_step"]
    ladder.tempered_half_step(lp, xk, pk, lk, betas, h, u_z, j, u_acc, 2.0, off, sc, ak)
    assert kernels.LAUNCHES["tempered_half_step"] == n0 + 1
    fns = ladder.plain_functions(lp, off, sc)
    ladder.tempered_half_step_plain(*fns, xp, pp, lpl, betas, h, u_z, j, u_acc, 2.0, ap)
    agree = ak[:, h] == ap[:, h]
    y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
    pri_y, ll_y = fns[0](y), fns[1](y)
    b = betas[:, None]
    ratio = ((ndim - 1.0) * torch.log(z) + pri_y + b * ll_y - pri0[:, h] - b * ll0[:, h])
    gap = (torch.log(u_acc[:, h]).double() - ratio).abs()
    scale_y = lp.log_likelihood.term_scales(common.absolute_params(y, off, sc))
    scale = scale_y + lp.log_likelihood.term_scales(common.absolute_params(x0[:, h], off, sc))
    assert bool((agree | (gap <= 1e-5 * scale)).all())
    assert torch.equal(xk[:, h][agree], xp[:, h][agree])
    assert torch.equal(pk[:, h][agree], pp[:, h][agree])
    assert torch.equal(xk[:, 1 - h], x0[:, 1 - h]) and torch.equal(ak[:, 1 - h], ap[:, 1 - h])
    _assert_scaled(lk[:, h][agree], lpl[:, h][agree], rel,
                   lp.log_likelihood.term_scales(common.absolute_params(xk[:, h], off, sc))[agree])
    assert 0.02 < float(ak[:, h].float().mean()) < 0.98


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sc2", "sc3", "cs1"])
@pytest.mark.parametrize("sigma_type", ["relative", "absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_use_sigma_half_steps_match_plain_on_card(lc, lc_flux, request, cuda_device, which,
                                                  sigma_type, f64):
    """K2, the SC3 half-step or the CS half-step (both a warp per walker),
    and K6a over the model (over CS1 a warp per walker), with the intrinsic
    scatter (h = 0, 1) on the float32 rescaled state."""
    ia = request.getfixturevalue("ia") if which == "cs1" else None
    try:
        if f64:
            config.set_compute_dtype(None)
        lp, lo, up = _sigma_case(which, lc, lc_flux, cuda_device, sigma_type, ia)
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        rng = np.random.default_rng(2)
        W = 2048 if which == "sc2" else 1024
        x0 = torch.as_tensor((rng.uniform(lo, up, size=(W, len(lo))) - off) / sc,
                             device=cuda_device).float().reshape(2, W // 2, len(lo)).contiguous()
        xl = torch.as_tensor((rng.uniform(lo, up, size=(5 * 256, len(lo))) - off) / sc,
                             device=cuda_device).float().reshape(5, 2, 128, len(lo)).contiguous()
        for h in (0, 1):
            _half_step_case(lp, off, sc, x0, h, 3 + h, 1e-10 if f64 else 1e-5)
            _tempered_case(lp, off, sc, xl, h, 5 + h, 1e-10 if f64 else 1e-5)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("half", [32, 16384, 65536])
@pytest.mark.parametrize("sigma_type", [None, "relative"], ids=["no-sigma", "sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_sc3_warp_half_step_matches_plain_on_card(lc, lc_flux, cuda_device, half, sigma_type,
                                                  f64):
    """The SC3 half-step (a warp per walker) at the main path's widths
    (half 32: the 64-walker fit; 16384: the 32768-walker fit; 65536: the
    131072-walker comparison), with and without the intrinsic scatter, in
    float32 and float64, h = 0, 1: flags equal except near-ties, new states
    bit-equal and new log-posteriors within 1e-5 (float32) or 1e-10
    (float64) of the term scale where they agree."""
    try:
        if f64:
            config.set_compute_dtype(None)
        if sigma_type is None:
            lp = make_log_posterior(ShockCooling3(lc_flux), lc_flux, _sc3_priors(),
                                    device=cuda_device)
            lo, up = SC3_LO, SC3_UP
        else:
            lp, lo, up = _sigma_case("sc3", lc, lc_flux, cuda_device, sigma_type)
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        rng = np.random.default_rng(half)
        x0 = torch.as_tensor((rng.uniform(lo, up, size=(2 * half, len(lo))) - off) / sc,
                             device=cuda_device).float().reshape(2, half, len(lo)).contiguous()
        n0 = kernels.LAUNCHES["sc3_half_step"]
        for h in (0, 1):
            _half_step_case(lp, off, sc, x0, h, 7 + h, 1e-10 if f64 else 1e-5)
        assert kernels.LAUNCHES["sc3_half_step"] == n0 + 2
    finally:
        config.set_compute_dtype(config.AUTO)


def _whitened_sigma(lc, device, n_chains, sigma_type, seed=12):
    """_whitened with the intrinsic scatter as a fifth parameter (Gaussian
    prior on (0, 10)), its whitening from draws with sigma near 1."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    pri = [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
           GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2),
           GaussianPrior(0.0, 10.0, 1.0, 1.0)]
    lp = make_log_posterior(ShockCooling2(lc), lc, pri, use_sigma=True, sigma_type=sigma_type,
                            device=device)
    bounds = BoundsTransform([q.p_min for q in pri], [q.p_max for q in pri])
    rng = np.random.default_rng(seed)
    x = np.array([37.58, 5.326, 16.25, 57468.6999, 1.0]) + rng.normal(size=(400, 5)) * [
        0.145, 0.053, 0.110, 0.00018, 0.1]
    x[:, 3] = 57468.7 - 1e-6 - np.abs(rng.normal(size=400)) * 0.00018
    warm_u = bounds.to_unbounded(x)
    white = WhitenedPosterior(warm_u)
    w0 = np.ascontiguousarray(white.to_w(warm_u[:n_chains]))
    return WhitenedLogPosterior(lp, bounds, white), torch.as_tensor(w0, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", ["relative", "absolute"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_use_sigma_gradient_kernels_match_plain_on_card(lc, cuda_device, sigma_type, f64):
    """K7 with the intrinsic scatter (the sigma column of the gradient
    included) against autograd through the plain log-posterior, within
    1e-4 (float32) and 1e-9 (float64) of the gradient term scales; K9 and
    K7h on a 5-parameter whitened target against their plain transitions."""
    from lightcurve_fitting_tpu_torch.parallel.hmc import hmc_transition_plain
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition
    try:
        if f64:
            config.set_compute_dtype(None)
        lp, lo, up = _sigma_case("sc2", lc, None, cuda_device, sigma_type)
        p = torch.as_tensor(_window_walkers(lo, up, 2048, 4), device=cuda_device)
        rel, grel = (1e-10, 1e-9) if f64 else (1e-5, 1e-4)
        v, g = kernels.log_posterior_and_grad(lp, p)
        vp, gp = sc2.log_posterior_and_grad_plain(lp, p)
        _assert_scaled(v, vp, rel, lp.log_likelihood.term_scales(p))
        assert torch.equal(g == 0, gp == 0) and bool((g[:-3, 4] != 0).all())
        assert bool(((g - gp).abs() <= grel * lp.grad_term_scales(p)).all())
        target, q0 = _whitened_sigma(lc, cuda_device, 16, sigma_type)
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        z = torch.randn((16, 5), generator=gen, device=cuda_device, dtype=torch.float64)
        u = torch.rand((16, 7, 66), generator=gen, device=cuda_device, dtype=torch.float64)
        u_acc = torch.rand(16, generator=gen, device=cuda_device, dtype=torch.float64)
        n_used = torch.randint(8, 17, (16,), generator=gen, device=cuda_device)
        eps = torch.tensor(0.1, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(5, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        fn = target.logp_and_grad_plain if f64 else target.logp_and_grad
        got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, 7)
        want = make_nuts_transition(fn, 5, 7, margins=True)(q0, logp0, z, u, eps, inv_mass)
        _transitions_agree(got, want[:5], want[5:], 1e-6 if f64 else 1e-3, 1e-8)
        args = (q0, logp0, z, u_acc, n_used, eps, inv_mass, 16)
        got = gradient.hmc_transition(target, *args)
        want = hmc_transition_plain(fn, *args, margins=True)
        _transitions_agree(got, want[:3], want[3:], 1e-6 if f64 else 1e-3, 1e-8)
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["depth9", "deep"])
@pytest.mark.parametrize("ndim", [4, 5])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k9_block_matches_plain_on_card(lc_ext, cuda_device, case, ndim, f64):
    """K9 (a block per chain) against the plain transition under shared
    draws, for ndim 4 and 5 (the intrinsic scatter): at max_depth 9 and eps
    0.1 (the lightcurve_hmc default depth), and on deep trees (eps 0.01,
    max_depth 10, some chain at depth >= 7); float64 over the plain gradient,
    float32 over K7's evaluations, equal except near-ties. Every chain's
    log-posterior is K7's at its new state, bit for bit: the block form folds
    the points in the warp form's order."""
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition
    try:
        if f64:
            config.set_compute_dtype(None)
        C = 32
        target, q0 = (_whitened(lc_ext, cuda_device, C) if ndim == 4
                      else _whitened_sigma(lc_ext, cuda_device, C, "relative"))
        D, eps = (9, 0.1) if case == "depth9" else (10, 0.01)
        g = torch.Generator(device=cuda_device).manual_seed(11 + ndim)
        z = torch.randn((C, ndim), generator=g, device=cuda_device, dtype=torch.float64)
        u = torch.rand((C, D, 2 ** (D - 1) + 2), generator=g, device=cuda_device,
                       dtype=torch.float64)
        eps = torch.tensor(eps, dtype=torch.float64, device=cuda_device)
        inv_mass = torch.ones(ndim, dtype=torch.float64, device=cuda_device)
        logp0 = target.logp_and_grad(q0)[0]
        n0 = kernels.LAUNCHES["nuts_transition"]
        got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, D)
        assert kernels.LAUNCHES["nuts_transition"] == n0 + 1
        fn = target.logp_and_grad_plain if f64 else target.logp_and_grad
        want = make_nuts_transition(fn, ndim, D, margins=True)(q0, logp0, z, u, eps, inv_mass)
        _transitions_agree(got, want[:5], want[5:], 1e-6 if f64 else 1e-3, 1e-8)
        assert torch.equal(target.logp_and_grad(got[0])[0], got[1])
        assert got[3].min() >= 1 and (got[3].max() >= 7 if case == "deep" else got[3].max() > 1)
    finally:
        config.set_compute_dtype(config.AUTO)


# -------------------------------------------------- the companion-shocking path

CS_PRIORS = {  # tests/test_companion_shocking.py:112-114, and CS1's factors, CS3's angle
    2: [UniformPrior(57815.0, 57825.0), UniformPrior(0.01, 5.0), UniformPrior(0.1, 10.0),
        UniformPrior(57835.0, 57845.0), UniformPrior(0.6, 1.6), UniformPrior(-5.0, 5.0),
        UniformPrior(-5.0, 5.0)]}
CS_PRIORS[1] = CS_PRIORS[2][:5] + [UniformPrior(0.1, 10.0)] * 3
CS_PRIORS[3] = CS_PRIORS[2][:2] + [UniformPrior(0.0, 180.0)] + CS_PRIORS[2][3:]
CS_LO = {2: np.array([57818.0, 0.2, 0.5, 57838.0, 0.8, -1.0, -1.0])}
CS_UP = {2: np.array([57822.0, 1.0, 2.0, 57842.0, 1.2, 1.0, 1.0])}
CS_LO[1], CS_UP[1] = np.append(CS_LO[2][:5], [0.8] * 3), np.append(CS_UP[2][:5], [1.2] * 3)
CS_LO[3], CS_UP[3] = CS_LO[2].copy(), CS_UP[2].copy()
CS_LO[3][2], CS_UP[3][2] = 0.0, 90.0


def _ia_lc(seed=3):
    """tests/test_companion_shocking.py::make_ia_lc with the port's LC and
    CompanionShocking2 in float64 on the CPU: 18 epochs x UBVgri of a Kasen
    shock (a13 = 0.5, Mc_v9_7 = 1, t_0 = 57820) + SiFTO (t_peak = 57840,
    s = 1), 4% errors; returns the light curve and the seed curve the
    generating model was built on (its SiFTO scaling is the truth's)."""
    from lightcurve_fitting_tpu_torch.models import CompanionShocking2
    rng = np.random.default_rng(seed)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    epochs = np.linspace(57820.5, 57855.0, 18)
    t = np.repeat(epochs, len(filters))
    f = np.array(filters * len(epochs))
    rows_lum = np.full(len(t), 2e15)
    lc0 = LC([t, f, rows_lum, 0.05 * rows_lum], names=["MJD", "filter", "lum", "dlum"])
    y_true = CompanionShocking2(lc0)(t, f, 57820.0, 0.5, 1.0, 57840.0, 1.0, 0.0, 0.0)
    dy = 0.04 * np.maximum(y_true, 0.05 * np.median(y_true))
    y = y_true + rng.normal(scale=dy)
    return LC([t, f, y, dy], names=["MJD", "filter", "lum", "dlum"]), lc0


@pytest.fixture(scope="module")
def ia():
    return _ia_lc()


@pytest.fixture(scope="module")
def ia_lc(ia):
    return ia[0]


def _cs_model(variant, ia, device=None):
    """CS1, CS2 or CS3 with the SiFTO scaling of the truth of ``ia``."""
    from lightcurve_fitting_tpu_torch import models
    cls = {1: models.CompanionShocking, 2: models.CompanionShocking2,
           3: models.CompanionShocking3}[variant]
    return cls(ia[1], device=device)


def _cs_walkers(variant, n, seed, use_sigma=False):
    """n walkers of the CS window, 1% outside the priors, and the last
    eighth with t_0 in (57821, 57824), after the first epochs (t < t_0
    there; inside the t_0 prior)."""
    lo, up = CS_LO[variant], CS_UP[variant]
    if use_sigma:
        lo, up = np.append(lo, 0.5), np.append(up, 3.0)
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, up, size=(n, len(lo)))
    out = rng.choice(n - n // 8, n // 100, replace=False)
    p[out, rng.integers(0, len(lo), out.size)] = -1e4
    p[n - n // 8:, 0] = rng.uniform(57821.0, 57824.0, n // 8)
    return p


def test_cs_param_blocks_match_the_c_structs():
    """struct CSParams: 14 pointers, 8 ints, 6 doubles, 7 arrays of
    LP_MAX_DIM; struct SiftoParams: 11 pointers, 4 ints, 1 double."""
    from lightcurve_fitting_tpu_torch.kernels import cs
    assert ctypes.sizeof(cs._CSParams) == 8 * (14 + 8 + 6) + 7 * 9 * 8
    assert _c_fields("CSParams") == [name for name, _ in cs._CSParams._fields_]
    assert ctypes.sizeof(cs._SiftoParams) == 8 * (11 + 4 + 1)
    assert _c_fields("SiftoParams") == [name for name, _ in cs._SiftoParams._fields_]


def test_module_for_routes_the_companion_models(ia, ia_lc):
    """CS1-3 route to kernels.cs, whose parameter block takes CS1 with the
    intrinsic scatter (9 parameters); on the CPU the wrappers run the plain
    versions and launch nothing; the gradient kernels refuse CS."""
    from lightcurve_fitting_tpu_torch.kernels import cs
    for variant in (1, 2, 3):
        assert kernels.module_for(_cs_model(variant, ia)) is cs
    lp = make_log_posterior(_cs_model(1, ia), ia_lc, CS_PRIORS[1] + [_SIGMA_PRIOR],
                            use_sigma=True, device="cpu")
    with pytest.raises(ValueError, match="ndim = 8"):
        cs._kernel_params(lp, 8, None, None)
    P = cs._kernel_params(lp, 9, None, None)
    assert (P.n_points, P.n_coef, P.n_bands, P.n_knots) == (108, 25, 6, 103)
    assert (P.variant, P.ndim, P.use_sigma, P.kappa, P.kappa_m35) == (1, 9, 1, 1.0, 1.0)
    assert cs._kernel_params(lp, 9, None, None) is P     # cached
    ll = lp.log_likelihood
    assert tuple(ll.sifto_rows.shape) == (6, 4, 102) and ll.sifto_band.dtype == torch.int64
    assert torch.equal(ll.quad["sifto_c"], ll.sifto_rows[ll.sifto_band])
    q = torch.as_tensor(_cs_walkers(1, 16, 0, use_sigma=True))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.log_posterior(lp, q), lp.forward_plain(q))
    assert kernels.LAUNCHES == before           # the plain path launches nothing
    with pytest.raises(ValueError, match="runs on CUDA"):
        cs.log_posterior(lp, torch.empty((4, 9), device="meta"))
    quad = {k: v.to("meta") for k, v in ll.quad.items()}
    with pytest.raises(ValueError, match="K8 runs on CUDA"):
        cs.sifto(ll.t.to("meta"), quad, 57840.0, 1.0)
    with pytest.raises(NotImplementedError, match="has no gradient kernel"):
        kernels.log_posterior_and_grad(lp, torch.empty((4, 9), dtype=torch.float64,
                                                       device="meta"))


def _k8_case(ia, ia_lc, device, W=4096, seed=0):
    """K8's inputs: 108 points a day apart from t_ref (integer phases: knots,
    both ends, just and far outside) through the model's bands; W walkers
    with t_peak on whole days, stretches 1, 0.5, 2 or drawn, integer or
    drawn U/i shifts; the first rows with t_peak NaN, stretch 0, inf and -1."""
    from lightcurve_fitting_tpu_torch.models.base import _quad_tensors
    model = _cs_model(2, ia, device)
    f = np.asarray(ia_lc["filter"])
    t = torch.as_tensor(57820.0 + np.arange(len(f)) - 30.0, device=device)
    quad = _quad_tensors(model.prepare_quad(f), device)
    rng = np.random.default_rng(seed)
    tpk = 57820.0 + rng.integers(-20, 120, size=W).astype(float)
    s = rng.choice([1.0, 0.5, 2.0, -1.0], size=W)
    drawn = rng.random(W) < 0.3
    s[drawn] = rng.uniform(0.6, 1.6, drawn.sum())
    dtu = np.where(rng.random(W) < 0.5, rng.integers(-5, 6, W), rng.uniform(-5, 5, W))
    dti = np.where(rng.random(W) < 0.5, rng.integers(-5, 6, W), rng.uniform(-5, 5, W))
    tpk[0], s[1], s[2], s[3] = np.nan, 0.0, np.inf, -1.0
    cols = [torch.as_tensor(c[:, None], device=device) for c in (tpk, s, dtu, dti)]
    peak = quad["sifto_rows"][quad["sifto_band"], 3].abs().amax(dim=-1)
    return model, t, quad, cols, peak


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_k8_matches_plain_on_card(ia, ia_lc, cuda_device, f64):
    """K8 against sifto_points_plain: within 1e-6 (float32) and 1e-13
    (float64) of each band's template peak, the same zero set; 0-d
    parameters give (N,)."""
    from lightcurve_fitting_tpu_torch.kernels import cs
    from lightcurve_fitting_tpu_torch.models.companion_shocking import sifto_points_plain
    try:
        if f64:
            config.set_compute_dtype(None)
        model, t, quad, cols, peak = _k8_case(ia, ia_lc, cuda_device)
        n0 = kernels.LAUNCHES["sifto"]
        got = cs.sifto(t, quad, *cols)
        assert kernels.LAUNCHES["sifto"] == n0 + 1
        want = sifto_points_plain(t, quad, *cols)
        assert got.dtype == (torch.float64 if f64 else torch.float32) and got.shape == want.shape
        assert torch.equal(got == 0, want == 0) and torch.isfinite(got).all()
        assert bool(((got - want).abs() <= (1e-13 if f64 else 1e-6) * peak).all())
        assert 0 < int((got == 0).sum()) < got.numel()
        one = cs.sifto(t, quad, 57840.0, 1.0, 0.5, -0.5)
        assert one.shape == t.shape
        assert torch.equal(one, cs.sifto(t, quad, *[torch.full((1, 1), v, device=cuda_device)
                                                   for v in (57840.0, 1.0, 0.5, -0.5)])[0])
        # evaluate on the card launches K8 and equals the plain evaluation
        t_np = np.asarray(ia_lc["MJD"], float)
        f = np.asarray(ia_lc["filter"])
        args = (57820.0, 0.5, 1.0, 57840.0, 1.0, 0.3, -0.2)
        n0 = kernels.LAUNCHES["sifto"]
        y = model.evaluate(t_np, f, *args)
        assert kernels.LAUNCHES["sifto"] == n0 + 1
        want = _cs_model(2, ia).evaluate(t_np, f, *args)
        np.testing.assert_allclose(y, want, rtol=1e-12 if f64 else 1e-5,
                                   atol=0.0 if f64 else 1e-6 * np.abs(want).max())
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,use_sigma", [(1, False), (2, False), (3, False), (1, True)],
                         ids=["cs1", "cs2", "cs3", "cs1-sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("W", CS_WIDTHS)
def test_cs_logpost_matches_plain_on_card(ia, ia_lc, cuda_device, variant, use_sigma, f64, W):
    """The CS log-posterior against its plain version at the fits' widths:
    within 1e-5 (float32) and 1e-10 (float64) of the term scale, the same
    -inf sets; t < t_0 walkers finite; the rescaled float32 state too."""
    from lightcurve_fitting_tpu_torch.kernels import cs
    try:
        if f64:
            config.set_compute_dtype(None)
        pri = CS_PRIORS[variant] + ([_SIGMA_PRIOR] if use_sigma else [])
        lp = make_log_posterior(_cs_model(variant, ia), ia_lc, pri, use_sigma=use_sigma,
                                device=cuda_device)
        p = _cs_walkers(variant, W, 1, use_sigma)
        if W < 100:
            p[0, 1] = -1e4   # (a hundredth of W rounds to none) one outside the priors
        p = torch.as_tensor(p, device=cuda_device)
        late = W // 8
        rel = 1e-10 if f64 else 1e-5
        n0 = kernels.LAUNCHES["cs_logpost"]
        got = lp(p)
        assert kernels.LAUNCHES["cs_logpost"] == n0 + 1
        want = _chunked(lp.forward_plain, p)
        _assert_scaled(got, want, rel, lp.log_likelihood.term_scales(p))
        assert 0 < int(torch.isneginf(got).sum()) <= max(1, W // 100)
        assert torch.isfinite(got[-late:]).all()
        lo, up = CS_LO[variant], CS_UP[variant]
        if use_sigma:
            lo, up = np.append(lo, 0.5), np.append(up, 3.0)
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        fin = torch.isfinite(want[:-late])
        q = ((p[:-late][fin] - torch.as_tensor(off, device=cuda_device))
             / torch.as_tensor(sc, device=cuda_device)).float()
        _assert_scaled(cs.log_posterior(lp, q, off, sc),
                       _chunked(lambda c: common.log_posterior_plain(lp, c, off, sc), q),
                       rel, lp.log_likelihood.term_scales(common.absolute_params(q, off, sc)))
        # any other walker dimension is refused: by the wrapper, and by the
        # launch itself (cudaErrorInvalidValue = 1), which has the warp form
        # at ndim 7, 8 and 9 only
        with pytest.raises(ValueError, match="ndim"):
            cs.log_posterior(lp, q[:, :-1].contiguous(), off[:-1], sc[:-1])
        P = cs._CSParams.from_buffer_copy(cs._kernel_params(lp, len(lo), off, sc))
        out = torch.empty(q.shape[0], dtype=torch.float64, device=cuda_device)
        dev, stream = common.cuda_args(q.device)
        for bad in (6, 10):
            P.ndim = bad
            assert build.library().cs_logpost_launch(ctypes.addressof(P), dev, int(f64),
                                                     q.data_ptr(), 0, q.shape[0],
                                                     out.data_ptr(), stream) == 1
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,use_sigma", [(1, False), (2, False), (3, False), (1, True)],
                         ids=["cs1", "cs2", "cs3", "cs1-sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_cs_logpost_repeats_the_half_steps_values_on_card(ia, ia_lc, cuda_device, variant,
                                                           use_sigma, f64):
    """The CS batch log-posterior and half-step run one warp form
    (CSWarpModel; the batch kernel at a compile-time ndim, 7-9, the
    half-step at a runtime one): on the states that two half-steps left at
    u_acc = 0 (every proposal inside the priors accepted), the batch kernel
    returns the log-posterior the half-step stored, bit for bit, on the
    sampler's float32 rescaled state."""
    from lightcurve_fitting_tpu_torch.kernels import cs
    try:
        if f64:
            config.set_compute_dtype(None)
        pri = CS_PRIORS[variant] + ([_SIGMA_PRIOR] if use_sigma else [])
        lp = make_log_posterior(_cs_model(variant, ia), ia_lc, pri, use_sigma=use_sigma,
                                device=cuda_device)
        lo, up = CS_LO[variant], CS_UP[variant]
        if use_sigma:
            lo, up = np.append(lo, 0.5), np.append(up, 3.0)
        ndim, half = len(lo), 1024
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        pos = (np.random.default_rng(5).uniform(lo, up, size=(2 * half, ndim)) - off) / sc
        x = torch.as_tensor(pos.reshape(2, half, ndim), device=cuda_device).float().contiguous()
        logp = cs.log_posterior(lp, x.reshape(-1, ndim), off, sc).reshape(2, half)
        g = torch.Generator(device=cuda_device).manual_seed(6)
        acc = torch.zeros((2, half), dtype=torch.int32, device=cuda_device)
        for h in (0, 1):
            u_z = torch.rand(half, generator=g, device=cuda_device)
            j = torch.randint(0, half, (half,), generator=g, device=cuda_device)
            cs.stretch_half_step(lp, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                                 n_accept=acc)
        assert 0.5 < float(acc.float().mean()) < 1.0   # the proposals inside the priors
        assert torch.equal(cs.log_posterior(lp, x.reshape(-1, ndim), off, sc),
                           logp.reshape(-1))
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_type", [None, "relative"], ids=["no-sigma", "sigma"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_epoch_logpost_repeats_the_half_steps_values_on_card(cuda_device, f64, sigma_type):
    """K4's values and the epoch half-step run one warp form (EpochBBModel):
    on the states that two half-steps of 40 epochs x 32 walkers left at
    u_acc = 0 (every proposal inside the priors accepted), K4 returns the
    log-posterior the half-step stored, bit for bit, in both of its forms,
    on the bolometric path's float32 walker state."""
    use_sigma = sigma_type is not None
    priors = _EPOCH_PRIORS + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
    try:
        if f64:
            config.set_compute_dtype(None)
        E, half = 40, 16
        ep = batched.EpochPosterior(_epoch_pack(E, cuda_device), priors, use_sigma=use_sigma)
        rng = np.random.default_rng(4)
        x = np.exp(rng.uniform(np.log([5.0, 1.0]), np.log([20.0, 30.0]), size=(E, 2, half, 2)))
        if use_sigma:
            x = np.concatenate([x, rng.uniform(0.5, 3.0, size=(E, 2, half, 1))], axis=-1)
        x = torch.as_tensor(x, device=cuda_device).float().contiguous()
        ndim = x.shape[-1]
        logp = ep(x.reshape(E, 2 * half, ndim)).reshape(E, 2, half).contiguous()
        g = torch.Generator(device=cuda_device).manual_seed(6)
        acc = torch.zeros((E, 2, half), dtype=torch.int32, device=cuda_device)
        for h in (0, 1):
            u_z = torch.rand((E, 2, half), generator=g, device=cuda_device)
            j = torch.randint(0, half, (E, 2, half), generator=g, device=cuda_device)
            epoch_bb.stretch_half_step(ep, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0,
                                       n_accept=acc)
        assert 0.5 < float(acc.float().mean()) <= 1.0   # the proposals inside the priors
        xs = x.reshape(E, 2 * half, ndim)
        assert torch.equal(ep(xs), logp.reshape(E, -1))
        for form in ("warp", "thread"):
            assert torch.equal(epoch_bb._launch_k4(ep, xs, False, form)[0], logp.reshape(E, -1))
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
@pytest.mark.parametrize("half,rungs,rung_half", [(1024, 5, 256), (16, 7, 32), (16384, 17, 2048)],
                         ids=["half1024-5x256", "fits-half16-7x32", "fits-half16384-17x2048"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_cs_half_steps_match_plain_on_card(ia, ia_lc, cuda_device, half, rungs, rung_half, f64):
    """The CS half-step and K6a over CS2 (both a warp per walker; h = 0, 1)
    against their plain versions under shared draws, at the fits' widths
    (half 16: the 32-walker fit; 16384: the 32768-walker fit; K6a at 7
    rungs x half 32: the PT fit; 17 x 2048: the evidence) beside half 1024
    and 5 x 256; K6b over CS2 as K1's."""
    try:
        if f64:
            config.set_compute_dtype(None)
        lp = make_log_posterior(_cs_model(2, ia), ia_lc, CS_PRIORS[2], device=cuda_device)
        lo, up = CS_LO[2], CS_UP[2]
        off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
        rng = np.random.default_rng(7)
        x0 = torch.as_tensor((rng.uniform(lo, up, size=(2 * half, 7)) - off) / sc,
                             device=cuda_device).float().reshape(2, half, 7).contiguous()
        xl = torch.as_tensor((rng.uniform(lo, up, size=(rungs * 2 * rung_half, 7)) - off) / sc,
                             device=cuda_device).float().reshape(rungs, 2, rung_half, 7)
        xl = xl.contiguous()
        n0 = kernels.LAUNCHES["cs_half_step"]
        for h in (0, 1):
            _half_step_case(lp, off, sc, x0, h, 3 + h, 1e-10 if f64 else 1e-5)
            _tempered_case(lp, off, sc, xl, h, 5 + h, 1e-10 if f64 else 1e-5)
        assert kernels.LAUNCHES["cs_half_step"] == n0 + 2
        n0 = kernels.LAUNCHES["ladder_init"]
        pri, ll = ladder.ladder_init(lp, xl, off, sc)
        assert kernels.LAUNCHES["ladder_init"] == n0 + 1
        want_pri, want_ll = ladder.ladder_init_plain(*ladder.plain_functions(lp, off, sc), xl)
        assert torch.equal(pri, want_pri)
        _assert_scaled(ll, want_ll, 1e-10 if f64 else 1e-5,
                       lp.log_likelihood.term_scales(common.absolute_params(xl, off, sc)))
    finally:
        config.set_compute_dtype(config.AUTO)


@pytest.mark.cuda
def test_cs_fits_run_through_the_kernels_on_card(ia, ia_lc, cuda_device, monkeypatch):
    """lightcurve_mcmc, lightcurve_evidence, lightcurve_ptmcmc and
    compare_models on CS models launch the CS kernels and no plain version."""
    from lightcurve_fitting_tpu_torch.fitting import (compare_models, lightcurve_evidence,
                                                      lightcurve_mcmc, lightcurve_ptmcmc)

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    from lightcurve_fitting_tpu_torch.kernels import cs
    monkeypatch.setattr(cs, "stretch_half_step_plain", no_plain)
    monkeypatch.setattr(cs, "log_posterior_plain", no_plain)
    for name in ("tempered_half_step_plain", "ladder_init_plain", "replica_swap_plain",
                 "rung_block_terms_plain"):
        monkeypatch.setattr(ladder, name, no_plain)
    kernels.reset_launch_counts()
    s = lightcurve_mcmc(ia_lc, _cs_model(2, ia), CS_PRIORS[2], p_lo=list(CS_LO[2]),
                        p_up=list(CS_UP[2]), nwalkers=64, nsteps=20, nsteps_burnin=20, seed=3,
                        quiet=True, device=cuda_device)
    assert s.flatchain.shape == (20 * 64, 7) and np.isfinite(s.flatchain).all()
    assert kernels.LAUNCHES["cs_half_step"] == 80 and kernels.LAUNCHES["cs_logpost"] >= 1
    kw = dict(nwalkers=64, n_rungs=3, nsteps=10, nsteps_burnin=10, seed=4, quiet=True,
              device=cuda_device)
    log_z, err, info = lightcurve_evidence(ia_lc, _cs_model(3, ia), CS_PRIORS[3],
                                           p_lo=list(CS_LO[3]), p_up=list(CS_UP[3]), **kw)
    assert np.isfinite(log_z) and np.isfinite(err)
    table = compare_models(ia_lc, [_cs_model(2, ia), _cs_model(1, ia)],
                           [CS_PRIORS[2], CS_PRIORS[1]], p_lo=[list(CS_LO[2]), list(CS_LO[1])],
                           p_up=[list(CS_UP[2]), list(CS_UP[1])], **kw)
    assert len(table) == 2 and np.isfinite(np.asarray(table["log_z"], float)).all()
    pt = lightcurve_ptmcmc(ia_lc, _cs_model(1, ia), CS_PRIORS[1] + [_SIGMA_PRIOR],
                           p_lo=list(CS_LO[1]) + [0.5], p_up=list(CS_UP[1]) + [3.0],
                           use_sigma=True, **kw)
    assert pt.flatchain.shape == (10 * 64, 9) and np.isfinite(pt.flatchain).all()
    assert kernels.LAUNCHES["tempered_half_step"] == 4 * 40 and kernels.LAUNCHES["ladder_init"] == 4
