#!/usr/bin/env python3
"""Drive lightcurve_fitting_tpu_torch's main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc (``/usr/local/cuda`` or ``CUDA_HOME``) and PyTorch built for CUDA,
and imports nothing of JAX. Phases, each printing one line (any failure
raises and the script exits non-zero):

1. environment: torch/CUDA versions, the card, its power limit;
2. build: nvcc compiles K1 and K2 from ``kernels/csrc/``;
3. K1 against its plain PyTorch version at 131072 walkers on the flagship
   (SN 2016bkv, ShockCooling2), float32 (<= 1e-5 |ll|, same -inf set) and
   float64 (<= 1e-10 |ll|), including t < t_exp under a widened t_0 prior;
4. K2 against the plain half-step on the same state and draws: accept flags
   agree except at near-ties, and where they agree the new states are equal;
5. the public ``fitting.lightcurve_mcmc``: (a) the reference-default
   64-walker fit, (b) 131072 walkers x 300 steps from the init window, whose
   mean acceptance must be 0.4685 +- 0.01; the launch counters show both ran
   through K1 and K2;
6. K3 (``bandflux_kernel``) against ``bandflux_pointwise_plain`` at 131072
   walkers x the 149 flagship points with E(B-V) per walker in [0, 1] and
   t < t_exp walkers, float32 (<= 1e-5 relative per point) and float64
   (<= 1e-12);
7. the fused ShockCooling3 log-posterior against ``forward_plain`` at 131072
   walkers (1% outside the priors, a set with t < t_exp): float32
   <= 1e-5 |ll|, float64 <= 1e-10 |ll|, identical -inf sets;
8. the SC3 half-step against the plain half-step, as in 4;
9. the ShockCooling3 fit of SN 2016bkv through ``fitting.lightcurve_mcmc``:
   (a) 64 walkers x 200+200 steps, (b) 32768 walkers x 300 steps from the
   init window, whose mean acceptance must be within 0.01 of the JAX
   package's float64 value, and ``ShockCooling3.evaluate`` on the card at
   the medians (chi2/dof printed); the launch counters, reset before this
   path, show it ran through K3 and both SC3 kernels.

The last lines are the card's name and power limit, one JSON line with each
kernel's launches, error and time, and ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EVENT_REPEATS = 20

META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
P_LO = [20.0, 2.0, 20.0, 57468.5]
P_UP = [50.0, 5.0, 50.0, 57468.7]
HEADLINE_WALKERS = 131072
ACCEPTANCE_REF = 0.4685   # flagship at 131072 x 300 from the init window (chip-free)

# ShockCooling3 on the same light curve (flux), d_L pinned by dm = 30.79
D_L = 10 ** (30.79 / 5 + 1) / 1e6
SC3_LO = [0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5]
SC3_UP = [2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7]
SC3_WALKERS = 32768
# mean acceptance of the JAX package, float64 on the CPU, for this fit: 32768
# walkers x 300 steps from the SC3 window, no burn-in, seed 7 (shard=False)
SC3_ACCEPTANCE_REF = 0.21477925618489585
SC3_CHI2_PROBE = 96.0     # chi2/dof of the best draw of the JAX package's CPU probe
PLAIN_CHUNK = 16384       # walkers per call of a plain quadrature version: its
                          # (W, 149, 89) cube stays near 1 GB a tensor


def phase(name, msg):
    print(f"[chip_smoke] {name}: {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=EVENT_REPEATS):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def flagship_lc():
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    lc = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


def flagship_priors(t0_lo=57468.0, t0_hi=57468.7):
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    return [UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
            UniformPrior(t0_lo, t0_hi)]


def ll_scale(ll, const=0.0):
    """The magnitude a float32 log-posterior's rounding scales with:
    |ll - c| + |c|, where c is the normalization constant added to the
    residual sum in the compute type (|ll| when c = 0). Near the best fit
    of a flux model the two terms cancel and |ll| alone understates it."""
    return (ll - const).abs() + abs(const)


def compare_ll(name, got, want, rel, const=0.0):
    """Same -inf set, |got - want| <= rel * ll_scale(want, const) where
    finite; returns the largest absolute and relative differences."""
    import torch
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{name}: NaN log-posterior")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        n = int((torch.isneginf(got) != torch.isneginf(want)).sum())
        raise AssertionError(f"{name}: -inf sets differ at {n} walkers")
    fin = torch.isfinite(want)
    d = (got[fin] - want[fin]).abs()
    r = d / ll_scale(want[fin], const)
    if not bool((r <= rel).all()):
        raise AssertionError(f"{name}: max |delta|/scale = {float(r.max()):.3e} > {rel:.0e}")
    return float(d.max()), float(r.max()), int(fin.sum())


def phase_k1(lc, rng_seed=0):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import ShockCooling2

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    rng = np.random.default_rng(rng_seed)
    p = rng.uniform(P_LO, P_UP, size=(W, 4))
    out = rng.choice(W, W // 100, replace=False)          # 1% outside the priors
    dims = rng.integers(0, 4, size=out.size)
    p[out, dims] = np.where(rng.random(out.size) < 0.5, -1.0, 1e5)
    p_late = rng.uniform([20.0, 2.0, 10.0, 57468.8], [50.0, 5.0, 50.0, 57472.0], size=(W, 4))
    p = torch.as_tensor(p, device=dev)
    p_late = torch.as_tensor(p_late, device=dev)

    res = {}
    n0 = kernels.LAUNCHES["sc2_logpost"]
    for label, dtype in (("f32", "auto"), ("f64", None)):
        try:
            if dtype is None:
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(), device=dev)
            lp_wide = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(57460.0, 57480.0),
                                         device=dev)
            rel = 1e-5 if label == "f32" else 1e-10
            a = compare_ll(f"K1 {label}", lp(p), lp.forward_plain(p), rel)
            b = compare_ll(f"K1 {label} t<t_exp", lp_wide(p_late), lp_wide.forward_plain(p_late),
                           rel)
            if torch.isfinite(lp_wide(p_late)).sum() != W:
                raise AssertionError("t < t_exp walkers must have finite log-posteriors")
            res[label] = (max(a[0], b[0]), max(a[1], b[1]), a[2])
            if label == "f32":
                k1_ms = cuda_ms(lambda: lp(p))
                plain_ms = cuda_ms(lambda: lp.forward_plain(p), repeats=5)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("K1", f"{W} walkers (1% outside the priors, {W} more with t < t_exp): "
          f"f32 max |d| {res['f32'][0]:.3e} (max |d|/|ll| {res['f32'][1]:.2e} <= 1e-5), "
          f"f64 max |d| {res['f64'][0]:.3e} (max |d|/|ll| {res['f64'][1]:.2e} <= 1e-10), "
          f"-inf sets equal; {kernels.LAUNCHES['sc2_logpost'] - n0} comparison launches; "
          f"K1 {k1_ms:.4f} ms vs plain {plain_ms:.4f} ms per {W}-walker batch (f32)")
    return {"max_abs_err": res["f32"][0], "ms": k1_ms, "plain_ms": plain_ms}


def phase_k2(lc, seed=1):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import sc2
    from lightcurve_fitting_tpu_torch.models import ShockCooling2

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    half = W // 2
    lp = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(), device=dev)
    kw = _state_rescaling(torch.float32, P_LO, P_UP, dev)   # what "auto" gives on CUDA
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(P_LO, P_UP, size=(W, 4)) - off) / sc
    x0 = torch.as_tensor(pos.reshape(2, half, 4), device=dev).to(torch.float32).contiguous()
    logp0 = sc2.log_posterior(lp, x0.reshape(W, 4), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev)

    def plain_log_prob(q):
        return sc2.log_posterior_plain(lp, q, off, sc)

    max_abs, n_ties = 0.0, 0
    for h in (0, 1):
        xk, lk = x0.clone(), logp0.clone()
        xp, lpp = x0.clone(), logp0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ck = torch.empty((2, half, 4), device=dev)
        clk = torch.empty((2, half), dtype=torch.float64, device=dev)
        sc2.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, off, sc, ck, clk, ak)
        sc2.stretch_half_step_plain(plain_log_prob, xp, lpp, h, u_z, j, u_acc, 2.0,
                                    n_accept=ap)
        torch.cuda.synchronize()
        acc_k, acc_p = ak[h] == 1, ap[h] == 1
        agree = acc_k == acc_p
        # near-ties: |ln u - log_ratio| <= 1e-5 |ll| (float32 log-posterior budget)
        y, z = sc2.propose_stretch(u_z, j, x0[h], x0[1 - h])
        lp_y = plain_log_prob(y)
        log_ratio = 3.0 * torch.log(z) + lp_y - logp0[h]
        gap = (torch.log(u_acc).double() - log_ratio).abs()
        tie_ok = gap <= 1e-5 * lp_y.abs()
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"K2 h={h}: {int((~agree & ~tie_ok).sum())} accept flags "
                                 "differ away from near-ties")
        if not torch.equal(xk[h][agree], xp[h][agree]):
            raise AssertionError(f"K2 h={h}: new states differ where the flags agree")
        if not torch.equal(xk[1 - h], x0[1 - h]) or not torch.equal(ck[h], xk[h]) \
                or not torch.equal(clk[h], lk[h]):
            raise AssertionError(f"K2 h={h}: wrong half or chain slot written")
        fin = agree & torch.isfinite(lk[h])
        max_abs = max(max_abs, float((lk[h][fin] - lpp[h][fin]).abs().max()))
        n_ties += int((~agree).sum())
    xk, lk = x0.clone(), logp0.clone()
    ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
    k2_ms = cuda_ms(lambda: sc2.stretch_half_step(lp, xk, lk, 0, u_z, j, u_acc, 2.0, off, sc,
                                                  n_accept=ak))
    xp, lpp = x0.clone(), logp0.clone()
    plain_ms = cuda_ms(lambda: sc2.stretch_half_step_plain(plain_log_prob, xp, lpp, 0, u_z, j,
                                                           u_acc, 2.0), repeats=5)
    phase("K2", f"half-steps h=0,1 of {W} walkers (f32 state, f64 logp): accept flags agree "
          f"except {n_ties} near-ties, new states bit-equal where they agree, new-logp max "
          f"|d| {max_abs:.3e}; K2 {k2_ms:.4f} ms vs plain {plain_ms:.4f} ms per half-step")
    return {"max_abs_err": max_abs, "ms": k2_ms, "plain_ms": plain_ms}


def fmt(values):
    """A parameter vector on one line."""
    return "[" + ", ".join(f"{v:.8g}" for v in values) + "]"


def sc3_priors(t0_hi=57468.7):
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    return [UniformPrior(0.0, 10.0), UniformPrior(0.0, 10.0), UniformPrior(0.0, 100.0),
            UniformPrior(0.0, 100.0), UniformPrior(D_L - 0.01, D_L + 0.01),
            UniformPrior(0.0, 1.0), UniformPrior(57468.0, t0_hi)]


def flux_lc(lc):
    out = lc.where(MJD_min=57468.0, MJD_max=57485.0)
    out.calcFlux()
    return out


def chunked(fn, *xs):
    """``fn`` over walker chunks of PLAIN_CHUNK rows, concatenated."""
    import torch
    parts = zip(*(x.split(PLAIN_CHUNK) for x in xs))
    return torch.cat([fn(*part) for part in parts])


def sc3_walkers(rng, W):
    """W walkers from the SC3 init window, 1% of them outside the priors;
    and W more with t_0 in (57468.8, 57472), after the first points."""
    import numpy as np
    p = rng.uniform(SC3_LO, SC3_UP, size=(W, 7))
    out = rng.choice(W, W // 100, replace=False)
    dims = rng.integers(0, 7, size=out.size)
    p[out, dims] = np.where(rng.random(out.size) < 0.5, -1.0, 1e5)
    late = rng.uniform(SC3_LO, SC3_UP, size=(W, 7))
    late[:, 6] = rng.uniform(57468.8, 57472.0, W)
    return p, late


def phase_k3(lcf, rng_seed=2):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import ShockCooling3
    from lightcurve_fitting_tpu_torch.models.blackbody import (bandflux_pointwise,
                                                               bandflux_pointwise_plain)

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    rng = np.random.default_rng(rng_seed)
    p = rng.uniform(SC3_LO, SC3_UP, size=(W, 7))
    p[: W // 8, 6] = rng.uniform(57468.8, 57472.0, W // 8)    # t < t_exp: T = 0
    cols = [torch.as_tensor(p[:, i:i + 1], device=dev) for i in range(7)]
    ebv = torch.as_tensor(rng.uniform(0.0, 1.0, size=(W, 1)), device=dev)
    res = {}
    n0 = kernels.LAUNCHES["bandflux"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            model = ShockCooling3(lcf, device=dev)
            ll = make_log_posterior(model, lcf, sc3_priors(), device=dev).log_likelihood
            T, R = model._tr_points(ll.t, *cols[:4], cols[6])
            args = (ll.nodes, ll.weights, T, R)
            kw = dict(k_ext=ll.k_ext, ebv=ebv, band_ids=ll.band_ids)
            got = bandflux_pointwise(*args, **kw)
            want = chunked(lambda T_, R_, e_: bandflux_pointwise_plain(
                ll.nodes, ll.weights, T_, R_, k_ext=ll.k_ext, ebv=e_, band_ids=ll.band_ids),
                T, R, ebv)
            if not torch.isfinite(got).all() or not bool((got[T <= 0] == 0).all()):
                raise AssertionError(f"K3 {label}: non-finite flux, or T <= 0 not 0")
            d = (got - want).abs()
            r = float((d / want.abs().clamp_min(torch.finfo(want.dtype).tiny)).max())
            rel = 1e-5 if label == "f32" else 1e-12
            if not bool((d <= rel * want.abs()).all()):
                raise AssertionError(f"K3 {label}: max relative difference {r:.3e} > {rel:.0e}")
            res[label] = (float(d.max()), r, int((T <= 0).sum()))
            if label == "f32":
                k3_ms = cuda_ms(lambda: bandflux_pointwise(*args, **kw))
                plain_ms = cuda_ms(lambda: chunked(lambda T_, R_, e_: bandflux_pointwise_plain(
                    ll.nodes, ll.weights, T_, R_, k_ext=ll.k_ext, ebv=e_,
                    band_ids=ll.band_ids), T, R, ebv), repeats=3)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("K3", f"{W} walkers x 149 points x 89 nodes ({res['f32'][2]} points with T <= 0 give "
          f"0): f32 max |d| {res['f32'][0]:.3e} W/Hz (max relative {res['f32'][1]:.2e} <= 1e-5), "
          f"f64 max |d| {res['f64'][0]:.3e} (max relative {res['f64'][1]:.2e} <= 1e-12); "
          f"{kernels.LAUNCHES['bandflux'] - n0} comparison launches; K3 {k3_ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms per {W}-walker batch (f32)")
    return {"max_abs_err": res["f32"][0], "ms": k3_ms, "plain_ms": plain_ms}


def phase_sc3_logpost(lcf, rng_seed=3):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    p, late = sc3_walkers(np.random.default_rng(rng_seed), W)
    p, late = torch.as_tensor(p, device=dev), torch.as_tensor(late, device=dev)
    res = {}
    n0 = kernels.LAUNCHES["sc3_logpost"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(), device=dev)
            wide = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(57480.0), device=dev)
            rel = 1e-5 if label == "f32" else 1e-10
            c = lp.log_likelihood.log_norm_const
            a = compare_ll(f"SC3 log-posterior {label}", lp(p), chunked(lp.forward_plain, p),
                           rel, c)
            got_late = wide(late)
            b = compare_ll(f"SC3 log-posterior {label} t<t_exp", got_late,
                           chunked(wide.forward_plain, late), rel, c)
            if torch.isfinite(got_late).sum() != W:
                raise AssertionError("t < t_exp walkers must have finite log-posteriors")
            res[label] = (max(a[0], b[0]), max(a[1], b[1]), a[2])
            if label == "f32":
                k_ms = cuda_ms(lambda: lp(p))
                plain_ms = cuda_ms(lambda: chunked(lp.forward_plain, p), repeats=2)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("SC3 log-posterior", f"{W} walkers (1% outside the priors, {W} more with t < t_exp): "
          f"f32 max |d| {res['f32'][0]:.3e} (max |d|/(|ll - c| + |c|) {res['f32'][1]:.2e} "
          f"<= 1e-5, c = {c:.2f} the normalization constant), f64 max |d| {res['f64'][0]:.3e} "
          f"(max |d|/(|ll - c| + |c|) {res['f64'][1]:.2e} <= 1e-10), "
          f"-inf sets equal; {kernels.LAUNCHES['sc3_logpost'] - n0} comparison launches; "
          f"kernel {k_ms:.4f} ms vs plain {plain_ms:.4f} ms per {W}-walker batch (f32)")
    return {"max_abs_err": res["f32"][0], "ms": k_ms, "plain_ms": plain_ms}


def phase_sc3_half_step(lcf, seed=4):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    half = W // 2
    lp = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(), device=dev)
    kw = _state_rescaling(torch.float32, SC3_LO, SC3_UP, dev)   # what "auto" gives on CUDA
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(SC3_LO, SC3_UP, size=(W, 7)) - off) / sc
    x0 = torch.as_tensor(pos.reshape(2, half, 7), device=dev).to(torch.float32).contiguous()
    logp0 = kernels.log_posterior(lp, x0.reshape(W, 7), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev)

    def plain_log_prob(q):
        return chunked(lambda c: common.log_posterior_plain(lp, c, off, sc), q)

    max_abs, n_ties, n_acc = 0.0, 0, 0
    for h in (0, 1):
        xk, lk = x0.clone(), logp0.clone()
        xp, lpp = x0.clone(), logp0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ck = torch.empty((2, half, 7), device=dev)
        clk = torch.empty((2, half), dtype=torch.float64, device=dev)
        kernels.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, off, sc, ck, clk, ak)
        common.stretch_half_step_plain(plain_log_prob, xp, lpp, h, u_z, j, u_acc, 2.0,
                                       n_accept=ap)
        torch.cuda.synchronize()
        acc_k, acc_p = ak[h] == 1, ap[h] == 1
        agree = acc_k == acc_p
        # near-ties: |ln u - log_ratio| within the float32 log-posterior budget
        y, z = common.propose_stretch(u_z, j, x0[h], x0[1 - h])
        lp_y = plain_log_prob(y)
        log_ratio = 6.0 * torch.log(z) + lp_y - logp0[h]
        gap = (torch.log(u_acc).double() - log_ratio).abs()
        tie_ok = gap <= 1e-5 * ll_scale(lp_y, lp.log_likelihood.log_norm_const)
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"SC3 half-step h={h}: {int((~agree & ~tie_ok).sum())} accept "
                                 "flags differ away from near-ties")
        if not torch.equal(xk[h][agree], xp[h][agree]):
            raise AssertionError(f"SC3 half-step h={h}: new states differ where the flags agree")
        if not torch.equal(xk[1 - h], x0[1 - h]) or not torch.equal(ck[h], xk[h]) \
                or not torch.equal(clk[h], lk[h]):
            raise AssertionError(f"SC3 half-step h={h}: wrong half or chain slot written")
        fin = agree & torch.isfinite(lk[h])
        max_abs = max(max_abs, float((lk[h][fin] - lpp[h][fin]).abs().max()))
        n_ties += int((~agree).sum())
        n_acc += int(acc_k.sum())
    xk, lk = x0.clone(), logp0.clone()
    ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
    k_ms = cuda_ms(lambda: kernels.stretch_half_step(lp, xk, lk, 0, u_z, j, u_acc, 2.0, off, sc,
                                                     n_accept=ak))
    xp, lpp = x0.clone(), logp0.clone()
    plain_ms = cuda_ms(lambda: common.stretch_half_step_plain(plain_log_prob, xp, lpp, 0, u_z,
                                                              j, u_acc, 2.0), repeats=2)
    phase("SC3 half-step", f"half-steps h=0,1 of {W} walkers (f32 state, f64 logp): {n_acc} "
          f"accepts, flags agree except {n_ties} near-ties, new states bit-equal where they "
          f"agree, new-logp max |d| {max_abs:.3e}; kernel {k_ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms per half-step")
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": plain_ms}


def phase_sc3_main_path(lc, smi):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_mcmc
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    priors = sc3_priors()
    bounds = np.array([[p.p_min, p.p_max] for p in priors])
    kernels.reset_launch_counts()
    s = lightcurve_mcmc(lc, ShockCooling3(lc), priors, p_lo=SC3_LO, p_up=SC3_UP, nwalkers=64,
                        nsteps=200, nsteps_burnin=200, seed=7, quiet=False)
    flat = s.flatchain
    if flat.shape != (64 * 200, 7) or not np.isfinite(flat).all() \
            or not np.isfinite(s.flatlnprobability).all():
        raise AssertionError(f"9a: bad chain {flat.shape}")
    if not ((flat > bounds[:, 0]) & (flat < bounds[:, 1])).all():
        raise AssertionError("9a: chain values outside the priors")
    med = np.median(flat, axis=0)
    if not 0.0 <= med[5] <= 0.1:
        raise AssertionError(f"9a: E(B-V) median {med[5]} outside [0, 0.1]")
    phase("SC3 main path 9a", f"lightcurve_mcmc ShockCooling3 64 walkers x 200+200 steps: "
          f"medians {fmt(med)}, acceptance {np.mean(s.acceptance_fraction):.4f}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = lightcurve_mcmc(lc, ShockCooling3(lc), priors, p_lo=SC3_LO, p_up=SC3_UP,
                        nwalkers=SC3_WALKERS, nsteps=300, nsteps_burnin=0, seed=7, quiet=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    acc = float(np.mean(s.acceptance_fraction))
    if abs(acc - SC3_ACCEPTANCE_REF) > 0.01:
        raise AssertionError(f"9b: mean acceptance {acc:.4f} not within 0.01 of "
                             f"{SC3_ACCEPTANCE_REF:.4f}")
    flat = s.flatchain
    if flat.shape != (SC3_WALKERS * 300, 7) or not np.isfinite(flat).all():
        raise AssertionError("9b: bad chain")
    med = np.median(flat, axis=0)
    model = ShockCooling3(lc, device="cuda")
    t = np.asarray(lc["MJD"], float)
    y_fit = model.evaluate(t, np.asarray(lc["filter"]), *med)
    resid = (np.asarray(lc["flux"], float) - y_fit) / np.asarray(lc["dflux"], float)
    if y_fit.shape != t.shape or not np.isfinite(y_fit).all() or not (y_fit > 0).any():
        raise AssertionError("9b: evaluate at the medians gave no finite flux")
    chi2_dof = float(np.sum(resid ** 2) / (len(t) - 7))
    launches = dict(kernels.LAUNCHES)
    for k in ("bandflux", "sc3_logpost", "sc3_half_step"):
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the SC3 path: {launches}")
    evals = SC3_WALKERS * 300
    phase("SC3 main path 9b", f"lightcurve_mcmc ShockCooling3 {SC3_WALKERS} walkers x 300 "
          f"steps: mean acceptance {acc:.4f} (JAX float64 CPU {SC3_ACCEPTANCE_REF:.4f} +- 0.01), "
          f"medians {fmt(med)}, {elapsed:.3f} s end to end incl. setup and chain readback, "
          f"{evals / elapsed:.4e} log-posterior evals/s (information only, on {smi}); "
          f"evaluate on the card at the medians: chi2/dof {chi2_dof:.2f} (the JAX CPU probe's "
          f"best draw: ~{SC3_CHI2_PROBE:.0f}); launches on this path {launches}")
    return launches


def phase_main_path(lc, smi):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_mcmc
    from lightcurve_fitting_tpu_torch.models import ShockCooling2

    priors = flagship_priors()
    bounds = np.array([[p.p_min, p.p_max] for p in priors])
    kernels.reset_launch_counts()
    s = lightcurve_mcmc(lc, ShockCooling2(lc), priors, p_lo=P_LO, p_up=P_UP, nwalkers=64,
                        nsteps=200, nsteps_burnin=200, seed=7, quiet=False)
    after_a = dict(kernels.LAUNCHES)
    flat = s.flatchain
    if flat.shape != (64 * 200, 4) or not np.isfinite(flat).all() \
            or not np.isfinite(s.flatlnprobability).all():
        raise AssertionError(f"5a: bad chain {flat.shape}")
    if not ((flat > bounds[:, 0]) & (flat < bounds[:, 1])).all():
        raise AssertionError("5a: chain values outside the priors")
    med = np.median(flat, axis=0)
    expect = [(25.0, 45.0), (3.0, 6.0), (10.0, 40.0), (57468.6, 57468.7)]
    if not all(lo < m < hi for m, (lo, hi) in zip(med, expect)):
        raise AssertionError(f"5a: medians {med} outside the expected posterior region")
    phase("main path 5a", f"lightcurve_mcmc 64 walkers x 200+200 steps: medians {med}, "
          f"acceptance {np.mean(s.acceptance_fraction):.4f}, launches {after_a}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = lightcurve_mcmc(lc, ShockCooling2(lc), priors, p_lo=P_LO, p_up=P_UP,
                        nwalkers=HEADLINE_WALKERS, nsteps=300, nsteps_burnin=0, seed=7,
                        quiet=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for k in ("sc2_logpost", "stretch_half_step"):
        v = launches[k]
        if v <= after_a[k] or after_a[k] == 0:
            raise AssertionError(f"kernel {k} was not launched in both runs: {after_a} -> {launches}")
    acc = float(np.mean(s.acceptance_fraction))
    if abs(acc - ACCEPTANCE_REF) > 0.01:
        raise AssertionError(f"5b: mean acceptance {acc:.4f} not within 0.01 of {ACCEPTANCE_REF}")
    if s.flatchain.shape != (HEADLINE_WALKERS * 300, 4) or not np.isfinite(s.flatchain).all():
        raise AssertionError("5b: bad chain")
    evals = HEADLINE_WALKERS * 300
    phase("main path 5b", f"lightcurve_mcmc {HEADLINE_WALKERS} walkers x 300 steps: "
          f"mean acceptance {acc:.4f} (reference {ACCEPTANCE_REF} +- 0.01), "
          f"{elapsed:.3f} s end to end incl. setup and chain readback, "
          f"{evals / elapsed:.4e} log-posterior evals/s (information only, on {smi}), "
          f"launches {launches}")
    return launches


def main():
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: PyTorch is not installed")
    if not os.path.isdir(os.path.join(REPO, "lightcurve_fitting_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository "
                         "(lightcurve_fitting_tpu_torch/ not found beside it)")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on the GPU only")
    sys.path.insert(0, REPO)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    phase("environment", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {name} (count {torch.cuda.device_count()}), "
          f"nvidia-smi: {smi}")

    from lightcurve_fitting_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    info = build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", f"{'built' if info['built'] else 'reused'} {os.path.relpath(info['path'], REPO)} "
          f"in {time.perf_counter() - t0:.2f} s; ptxas: {len(regs)} kernels, "
          f"{sorted(set(r.split('Used ')[-1] for r in regs))[:4]}")

    lc = flagship_lc()
    k1 = phase_k1(lc)
    k2 = phase_k2(lc)
    launches = phase_main_path(lc, smi)
    lcf = flux_lc(lc)
    k3 = phase_k3(lcf)
    k_sc3 = phase_sc3_logpost(lcf)
    k_sc3_half = phase_sc3_half_step(lcf)
    launches_sc3 = phase_sc3_main_path(lc, smi)
    if any(m.startswith("jax") or m.startswith("lightcurve_fitting_tpu.") or
           m == "lightcurve_fitting_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    src = "lightcurve_fitting_tpu_torch/kernels/csrc/sc2_logpost.cu"
    src3 = "lightcurve_fitting_tpu_torch/kernels/csrc/sc3_logpost.cu"
    kernels = [
        dict(name="sc2_logpost_kernel (K1)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/fitting.py:62", launches=launches["sc2_logpost"],
             **k1),
        dict(name="stretch_half_step_kernel (K2)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches["stretch_half_step"], **k2),
        dict(name="bandflux_kernel (K3)", route="cuda", source=src3,
             replaces="0ee4f99:lightcurve_fitting_tpu/ops/pallas_bandflux.py:61",
             launches=launches_sc3["bandflux"], **k3),
        dict(name="sc3_logpost_kernel (SC3 log-posterior)", route="cuda", source=src3,
             replaces="lightcurve_fitting_tpu/models/shock_cooling.py:201",
             launches=launches_sc3["sc3_logpost"], **k_sc3),
        dict(name="stretch_half_step_kernel<SC3Model> (SC3 half-step)", route="cuda",
             source=src3, replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches_sc3["sc3_half_step"], **k_sc3_half),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
