#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card at the shapes of ``chip_smoke.py``
and of the fits, float32 compute, by CUDA events:

* K1 at 131072 walkers; K2 per half-step of half 32, 16384 and 65536 (the
  64- and 131072-walker fits); K6a per ladder half-step of 7 rungs x 32 and
  17 x 4096 (ShockCooling2: the PT fit and the evidence) and of 17 x 512
  (ShockCooling3), with K6b's initial state hashed; K7 at 131072 walkers
  and at the MAP ascent's 64 starts (float32 and float64), and, where the
  checkout has K7's two forms, each form at 1, 6, 64, 132, 264, 528, 1056,
  1584, 2112 and 4096 rows (``K7_W*_block_dev``, ``K7_W*_warp_dev``; a checkout
  without them times its one form as ``warp``); K7h per 64- and 16-chain
  HMC transition (32 jittered leapfrogs, eps 0.1), hashed in float32 and
  float64;
* the companion-shocking kernels (CompanionShocking2 on the synthetic Ia
  curve): the CS half-step per half 16, 16384 and 65536 (the 32- and
  32768-walker fits and the 131072-walker comparison), K6a over CS per
  ladder half-step of 7 rungs x 64 (the PT fit) and 17 x 4096 (the
  evidence), K6b over CS at 17 x 4096, the CS log-posterior and K8 at
  131072 walkers;
* K9 per NUTS transition of 64 and of 16 whitened flagship chains at eps
  0.1, max_depth 9, and at the ``lightcurve_hmc`` defaults (``K9_hmc``: the
  16 chains, adapted step size and inverse mass of a ``lightcurve_hmc`` run,
  seed 3, over 50 successive transitions from its last state, with their
  mean depth and bound);
* the SC3 half-step per half-step of half 32, 16384 and 65536 (the 64- and
  32768-walker fits and the 131072-walker comparison), hashed from the
  plain version's initial values;
* the batch log-posteriors at the widths of the fits' initial states and
  131072 (SC3: 64, 4096, 32768; CS2: 32, 4096, 32768), hashed; K6c per
  production step at the ladders' shapes (17 rungs x 4096 and x 32, 7 x 32
  and x 64), K3 and K8 at one walker (``evaluate``), and a one-element add,
  the card's time for a kernel with no work;
* the bolometric path at the bench shape (256 epochs): the epoch half-step
  per half-step of 16 walkers; K4 with its gradient at 256 x 8 (the width
  of the Adam step that a checkout without K4p launches 300 times a
  centering) and K4p, the whole polish (8 starts x 300 steps), where the
  checkout has it, each in float32 and float64; the centering's wall
  (``_map_centers``: the cloud's scoring and the polish);
* K1 at the widths of the SC2 fits' initial states (48, 64, 4096 and
  131072: ``K1_W*_f32``, ``K1_W*_f64``, float32 and float64 compute); K6b as
  each ladder calls it, one set of starting states for every rung (over
  SC2 at 17 rungs x 4096, 7 x 32 and 17 x 32, over CS2 at 17 x 4096 and 7
  x 64, over SC3 at 17 x 512: ``K6b_*``; a checkout whose ``ladder_init``
  has no ``copies`` evaluates every rung's copy); K4s at the bolometric
  paths' 65 and 256 epochs (``K4s_E*``, ``K4s_E*_f64``: float32 and float64
  compute); the CS log-posterior in float64 compute at 32, 4096, 32768 and
  131072 walkers (``CS_logpost_W*_f64``); each timed and hashed;
* K4's values at the bolometric paths' widths: the centering's cloud (256
  and 65 epochs x 512 float64 candidates, ``K4_cloud_E*``) and the initial
  state (x 32 float32 walkers, ``K4_init_E*``), float32 and float64
  compute (``_f64``), and, where the checkout has K4's two value forms,
  each form (``K4_*_thread_dev``, ``K4_*_warp_dev``) and each form's cloud
  at 64, 96, 128 and 192 of the bench epochs (``K4_cross_E*``: about the
  forms' crossover); K6d at the ladders' shapes
  (150 steps x 17 rungs x 4096 walkers: ``K6d``; 250 x 7 x 32, 250 x 17 x
  32 and 250 x 7 x 64: ``K6d_*``); each timed and hashed; K6d at the
  bench shape with its splits aimed at 2, 4 and 8 CTAs an SM
  (``K6d_cta*_dev``), timed;
* hashed only, at ``chip_smoke.py``'s shapes: K3, K4 with its gradient,
  K4s, K5, K6c and K6d;
* with ``--fits``, the wall times of ``calculate_bolometric`` on SN
  2016bkv (``chip_smoke.py`` 13a) and of the bolometric bench shape (13b:
  the centering and 256 x 32 x (200 + 100) with summaries, seed 1) with a
  profiled 13b run's device busy time and idle share, of
  ``lightcurve_map`` (20a), of ``lightcurve_hmc(sampler="hmc")`` (20d), of ``lightcurve_hmc``
  at its defaults in float32 and float64 (20c), of the ShockCooling3 fits
  of phase 9 (9a: 64 walkers x 200 + 200; 9b: 32768 x 300; 9c: 4096 x 300,
  seed 1), of the ShockCooling2 fits of phases 5 and 16 (5a: 64
  walkers x 200 + 200; 5b: 131072 x 300; 16a: the evidence at 4096 x 17
  rungs x 150 + 150; 16b: the PT fit, 32 x 7 rungs x 350 + 250) and of the
  CompanionShocking2 fits of phase 24 (a: 32 walkers x 300 + 250; b: 32768
  x 300; c: the evidence at 4096 x 17 rungs x 150 + 150).

Each time is printed twice: by CUDA events around a run of launches (the
stream's time per launch, which a kernel shorter than its wrapper's host
time does not fill) and, as ``NAME_dev`` for the half-steps, K6a, K6b, K1,
the batch log-posteriors, K6c, K3 and K8 at one walker, K8, K7 at its
small widths, K7h, K4 at 256 x 8, K4's values, K4p, K4s and K6d, by the
profiler's device timestamps (the kernel's own time). The centering's wall is in
milliseconds, by the host clock to a synchronize. ``--sass NAME`` prints a
hash of the SASS of each kernel whose name holds NAME (``cuobjdump``), to
tell a kernel's code apart from its placement.
Each kernel's outputs at fixed inputs are hashed (``digest``): two checkouts
whose kernel computes the same bits print the same digest. The ptxas report
of the gradient kernels, of the SC2, SC3, CS and epoch warp kernels, of K4
(both forms), K4p, K6c, K6d and K4s (registers, stack frame, spills) comes
from the build.

Usage: ``python3 tools/time_port_kernels.py [--repo PATH] [--label NAME]
[--fits]``. ``--repo`` is the checkout whose ``lightcurve_fitting_tpu_torch``
is timed (default: this one), so that two versions can be compared on one
card, in turns: run it on each checkout in the order A, B, B, A on the same
machine. Each run builds its checkout's kernels first. The last line of the
output is one JSON object with the card, its power limit, each kernel's
milliseconds (the minimum over the repeats, and all repeats), the digests
and the ptxas report.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

META = dict(dm=30.79, redshift=0.002, extinction={
    "U": 0.069, "B": 0.061, "g": 0.055, "V": 0.045, "0": 0.035,
    "r": 0.038, "R": 0.035, "i": 0.028, "I": 0.020})
P_LO = [20.0, 2.0, 20.0, 57468.5]
P_UP = [50.0, 5.0, 50.0, 57468.7]
TRUTH_MED = [37.58, 5.326, 16.25, 57468.6999]
TRUTH_STD = [0.145, 0.053, 0.110, 0.00018]
D_L = 10 ** (30.79 / 5 + 1) / 1e6
SC3_LO = [0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5]
SC3_UP = [2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7]
# the ptxas report covers the entry functions whose mangled names hold these
PTXAS_KERNELS = ("nuts_transition", "hmc_transition", "logpost_grad", "SC2WarpModel",
                 "SC3WarpModel", "stretch_half_step_kernelI8SC3Model", "CSWarpModel",
                 "epoch_map_polish", "EpochBBModel", "replica_swap", "epoch_summary",
                 "epoch_logpost", "rung_block_terms")


def events_ms(fn, launches, repeats):
    """Milliseconds per call of ``fn``: for each repeat, CUDA events around
    ``launches`` calls after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return out


def device_ms(fn, match, launches, repeats):
    """Milliseconds per launch of the kernels whose name holds ``match``, from
    the profiler's device timestamps: for each repeat, their mean duration
    over ``launches`` calls of ``fn`` after a warm-up call. Unlike
    events_ms, the host's launch rate does not enter: a kernel shorter than
    its wrapper's host time is timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and match in e.key]
        n = sum(e.count for e in evs)
        out.append(sum(e.self_device_time_total for e in evs) / 1e3 / n if n else float("nan"))
    return out


def digest(*tensors):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas_report(log):
    """{entry function: [registers, stack frame bytes, spill stores, spill
    loads]} from nvcc's -Xptxas -v output, for PTXAS_KERNELS. The stack
    frame and spills are those of the entry function's own "Function
    properties" block, not of a function it calls."""
    out, name, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in PTXAS_KERNELS) else None
            if name:
                out[name] = [None, None, None, None]
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == name:
            out[name][1:] = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return out


def flagship(repo):
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    lc = LC.read(os.path.join(repo, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    lc.calcAbsMag()
    lc.calcLum()
    return lc.where(MJD_min=57468.0, MJD_max=57485.0)


def gauss_priors():
    from lightcurve_fitting_tpu_torch.models import GaussianPrior
    return [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
            GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sass", action="append", default=[], metavar="NAME",
                    help="hash the SASS of the kernels whose names hold NAME (repeatable)")
    ap.add_argument("--fits", action="store_true",
                    help="also time lightcurve_map, lightcurve_hmc (HMC; NUTS in f32, f64), "
                         "the SC3 32768 x 300 fit, the SC2 fits of chip_smoke.py phases 5 and "
                         "16 and the CS2 fits of phase 24")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_port_kernels: CUDA is not available; this script runs on the GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import (_state_rescaling, lightcurve_evidence,
                                                      lightcurve_hmc, lightcurve_map,
                                                      lightcurve_mcmc, lightcurve_ptmcmc,
                                                      make_log_posterior)
    from lightcurve_fitting_tpu_torch.kernels import build, common, cs, gradient, ladder, sc2, sc3
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, ShockCooling3, UniformPrior
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    import chip_smoke   # the checkout's own: its synthetic Ia curve and CS window
    build.library()
    ptxas = ptxas_report(build.build_info()["log"])
    dev = torch.device("cuda")
    lc = flagship(repo)
    priors = [UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0), UniformPrior(0.0, 100.0),
              UniformPrior(57468.0, 57468.7)]
    lp = make_log_posterior(ShockCooling2(lc), lc, priors, device=dev)
    kw = _state_rescaling(torch.float32, P_LO, P_UP, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev)
    times, digests, info, walls = {}, {}, {}, {}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def half_step(name, step, x, logp, half, seed, launches=20):
        """Time one in-place half-step kernel on (x, logp) and hash one step
        from the same start."""
        g.manual_seed(seed)
        u_z = torch.rand(half, generator=g, device=dev)
        j = torch.randint(0, half, (half,), generator=g, device=dev)
        u_acc = torch.rand(half, generator=g, device=dev)
        xd, ld = x.clone(), logp.clone()
        ad = torch.zeros((2, half), dtype=torch.int32, device=dev)
        step(xd, ld, u_z, j, u_acc, ad)
        digests[name] = digest(xd, ld, ad)
        acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
        times[name] = events_ms(lambda: step(x, logp, u_z, j, u_acc, acc), launches,
                                args.repeats)
        times[name + "_dev"] = device_ms(lambda: step(x, logp, u_z, j, u_acc, acc),
                                         "stretch_half_step_kernel", launches, args.repeats)

    def tempered(name, target, x, off_, sc_, seed):
        """Time K6a over ``target`` on the ladder state x (R, 2, half, ndim),
        and hash one half-step and K6b's initial state from the same start."""
        R_, _, hl, _ = x.shape
        pri_, ll_ = ladder.ladder_init(target, x, off_, sc_)
        digests[name + "_K6b"] = digest(pri_, ll_)
        betas_ = torch.as_tensor(make_beta_ladder(R_ - 1), device=dev)
        shape_ = (R_, 2, hl)
        g.manual_seed(seed)
        uz_ = torch.rand(shape_, generator=g, device=dev)
        jl_ = torch.randint(0, hl, shape_, generator=g, device=dev)
        ua_ = torch.rand(shape_, generator=g, device=dev)
        xd_, pd_, ld_ = x.clone(), pri_.clone(), ll_.clone()
        ad_ = torch.zeros(shape_, dtype=torch.int32, device=dev)
        ladder.tempered_half_step(target, xd_, pd_, ld_, betas_, 0, uz_, jl_, ua_, 2.0, off_, sc_,
                                  ad_)
        digests[name] = digest(xd_, pd_, ld_, ad_)
        acc_ = torch.zeros(shape_, dtype=torch.int32, device=dev)

        def step():
            ladder.tempered_half_step(target, x, pri_, ll_, betas_, 0, uz_, jl_, ua_, 2.0, off_,
                                      sc_, acc_, check_partners=False)
        launches = 20 if R_ * hl > 1024 else 100
        times[name] = events_ms(step, launches, args.repeats)
        times[name + "_dev"] = device_ms(step, "tempered_half_step_kernel", launches,
                                         args.repeats)
        return pri_, ll_

    # K1 at 131072 walkers; K2 per half-step at half 32 (the 64-walker fits),
    # 16384 and 65536 (the 131072-walker fit), float32 rescaled state
    W = 131072
    half = W // 2
    p = torch.as_tensor(rng.uniform(P_LO, P_UP, size=(W, 4)), device=dev)
    times["K1"] = events_ms(lambda: sc2.log_posterior(lp, p), 20, args.repeats)
    digests["K1"] = digest(sc2.log_posterior(lp, p))
    for h2 in (32, 16384, half):
        x = torch.as_tensor(((rng.uniform(P_LO, P_UP, size=(2 * h2, 4)) - off) / sc)
                            .reshape(2, h2, 4), device=dev).float().contiguous()
        logp = sc2.log_posterior(lp, x.reshape(2 * h2, 4), off, sc).reshape(2, h2)
        half_step(f"K2_half_{h2}", lambda x_, l_, uz, j_, ua, a_: sc2.stretch_half_step(
            lp, x_, l_, 0, uz, j_, ua, 2.0, off, sc, n_accept=a_, check_partners=False),
            x, logp, h2, 1, launches=20 if h2 > 32 else 100)

    # K6a over SC2: a ladder half-step of 7 rungs x 32 walkers (the PT fit)
    # and of 17 x 4096 (the evidence), and K6b's initial state there
    for R, Wl in ((7, 32), (17, 4096)):
        q = (rng.uniform(P_LO, P_UP, size=(R * Wl, 4)) - off) / sc
        xl = torch.as_tensor(q.reshape(R, 2, Wl // 2, 4), device=dev).float().contiguous()
        tempered(f"K6a_{R}x{Wl}", lp, xl, off, sc, 1)

    # K7 at 131072 walkers of the init window, and at the MAP ascent's 64
    # starts (lightcurve_map's width) in float32 and float64
    times["K7"] = events_ms(lambda: sc2.log_posterior_and_grad(lp, p), 20, args.repeats)
    digests["K7"] = digest(*sc2.log_posterior_and_grad(lp, p))
    p64 = p[:64].contiguous()
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            lp7 = make_log_posterior(ShockCooling2(lc), lc, priors, device=dev)
            times[f"K7_64_{label}"] = events_ms(lambda: sc2.log_posterior_and_grad(lp7, p64), 100,
                                                args.repeats)
            times[f"K7_64_{label}_dev"] = device_ms(lambda: sc2.log_posterior_and_grad(lp7, p64),
                                                    "logpost_grad", 100, args.repeats)
            digests[f"K7_64_{label}"] = digest(*sc2.log_posterior_and_grad(lp7, p64))
        finally:
            config.set_compute_dtype(config.AUTO)
    # K7's two forms at the widths around their crossover (a checkout with one
    # form runs the warp form at every width)
    two_forms = hasattr(sc2, "logpost_grad_launch")
    for w in (1, 6, 64, 132, 264, 528, 1056, 1584, 2112, 4096):
        pw = p[:w].contiguous()
        for form in ("block", "warp") if two_forms else ("warp",):
            def k7():
                if two_forms:
                    return sc2.logpost_grad_launch(lp, pw, None, form)
                return sc2.log_posterior_and_grad(lp, pw)
            times[f"K7_W{w}_{form}_dev"] = device_ms(k7, "logpost_grad", 100, args.repeats)
            digests[f"K7_W{w}_{form}_dev"] = digest(*k7())

    # K9 and K7h on whitened flagship chains (lightcurve_hmc's target)
    gpri = gauss_priors()
    glp = make_log_posterior(ShockCooling2(lc), lc, gpri, device=dev)
    bounds = BoundsTransform([b.p_min for b in gpri], [b.p_max for b in gpri])
    wr = np.random.default_rng(12)
    xs = np.asarray(TRUTH_MED) + wr.normal(size=(400, 4)) * np.asarray(TRUTH_STD)
    xs[:, 3] = 57468.7 - 1e-6 - np.abs(wr.normal(size=400)) * TRUTH_STD[3]
    warm_u = bounds.to_unbounded(xs)
    white = WhitenedPosterior(warm_u)
    target = WhitenedLogPosterior(glp, bounds, white)
    C, D = 64, 9
    q0 = torch.as_tensor(np.ascontiguousarray(white.to_w(warm_u[:C])), device=dev)
    logp0 = target.logp_and_grad(q0)[0]
    g.manual_seed(13)
    z = torch.randn((C, 4), generator=g, device=dev, dtype=torch.float64)
    u = torch.rand((C, D, 2 ** (D - 1) + 2), generator=g, device=dev, dtype=torch.float64)
    eps = torch.tensor(0.1, dtype=torch.float64, device=dev)
    inv_mass = torch.ones(4, dtype=torch.float64, device=dev)
    times["K9_64"] = events_ms(lambda: gradient.nuts_transition(target, q0, logp0, z, u, eps,
                                                                inv_mass, D), 5, args.repeats)
    digests["K9_64"] = digest(*gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, D))
    digests["K7w"] = digest(*kernels.log_posterior_and_grad(glp, q0, white=target))
    digests["K7w_16"] = digest(*kernels.log_posterior_and_grad(glp, q0[:16].contiguous(),
                                                               white=target))
    q16, l16, z16, u16 = (a[:16].contiguous() for a in (q0, logp0, z, u))
    times["K9_16"] = events_ms(lambda: gradient.nuts_transition(target, q16, l16, z16, u16, eps,
                                                                inv_mass, D), 5, args.repeats)
    digests["K9_16"] = digest(*gradient.nuts_transition(target, q16, l16, z16, u16, eps,
                                                        inv_mass, D))
    n_used = torch.randint(16, 33, (C,), generator=g, device=dev)
    u_acc = torch.rand(C, generator=g, device=dev, dtype=torch.float64)
    # K7h per transition of the 64 chains and of lightcurve_hmc's 16
    # (float32), hashed in float32 and float64 compute
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            tgt = target if label == "f32" else WhitenedLogPosterior(
                make_log_posterior(ShockCooling2(lc), lc, gpri, device=dev), bounds, white)
            l0 = tgt.logp_and_grad(q0)[0]
            suffix = "" if label == "f32" else "_f64"
            if label == "f64":
                digests["K7w_f64"] = digest(*tgt.logp_and_grad(q0))
            for c in (C, 16):
                hargs = tuple(a[:c].contiguous() for a in (q0, l0, z, u_acc, n_used)) + (
                    eps, inv_mass, 32)
                name = ("K7h" if c == C else f"K7h_{c}") + suffix
                digests[name] = digest(*gradient.hmc_transition(tgt, *hargs))
                if label == "f32":
                    times[name] = events_ms(lambda: gradient.hmc_transition(tgt, *hargs), 5,
                                            args.repeats)
                    times[name + "_dev"] = device_ms(
                        lambda: gradient.hmc_transition(tgt, *hargs), "hmc_transition", 5,
                        args.repeats)
        finally:
            config.set_compute_dtype(config.AUTO)

    # K9 at the lightcurve_hmc defaults: its adapted sampler, 50 transitions
    with contextlib.redirect_stdout(io.StringIO()):
        res = lightcurve_hmc(lc, ShockCooling2(lc), gpri, seed=3, quiet=True, device=dev)
    smp = res.sampler
    xh = smp._tensor(smp._last_pos)
    lh = smp._tensor(smp._last_logp)
    eps_h, im_h = smp._tensor(smp.step_size), smp._tensor(smp.inv_mass)
    draws = [smp._draws(smp._draw_count + i) for i in range(50)]

    def k9_run():
        x_, l_ = xh, lh
        depths = []
        for z_, u_ in draws:
            x_, l_, _, d_, _ = gradient.nuts_transition(smp._target, x_, l_, z_, u_, eps_h, im_h,
                                                        smp.max_depth)
            depths.append(d_)
        return torch.stack(depths)

    depth = k9_run().to(torch.int64)
    evals = int((2 ** depth - 1 + depth).sum())
    times["K9_hmc"] = [t / 50 for t in events_ms(k9_run, 1, args.repeats)]
    ops = evals / 50 * chip_smoke.sc2_grad_ops(glp.log_likelihood)
    info["K9_hmc"] = {"step_size": smp.step_size, "inv_mass": smp.inv_mass.tolist(),
                      "mean_depth": float(depth.double().mean()),
                      "evals_per_transition": evals / 50,
                      "bound_ms": chip_smoke.bound(ops, 16 * (4 * 8 * 3 + 8 * 3 + 4 * 2)
                                                   + 16 * D * (2 ** (D - 1) + 2) * 8)[0]}
    # the SC3 half-step at half 32, 16384 and 65536 (float32 rescaled state)
    lcf = chip_smoke.flux_lc(lc)
    lp3 = make_log_posterior(ShockCooling3(lcf), lcf, chip_smoke.sc3_priors(), device=dev)
    kw3 = _state_rescaling(torch.float32, SC3_LO, SC3_UP, dev)
    off3, sc3_ = kw3["param_offset"], kw3["param_scale"]
    for h3 in (32, 16384, 65536):
        pos = (rng.uniform(SC3_LO, SC3_UP, size=(2 * h3, 7)) - off3) / sc3_
        x3 = torch.as_tensor(pos.reshape(2, h3, 7), device=dev).float().contiguous()
        l3 = sc3.log_posterior(lp3, x3.reshape(2 * h3, 7), off3, sc3_).reshape(2, h3)
        if h3 == 65536:
            digests["SC3_logpost"] = digest(l3)
        # the half-step starts from the plain version's values, so that its
        # digest holds the half-step's bits alone, not the batch kernel's
        l3 = torch.cat([common.log_posterior_plain(lp3, c, off3, sc3_)
                        for c in x3.reshape(2 * h3, 7).split(16384)]).reshape(2, h3)
        half_step(f"SC3_half_{h3}", lambda x_, l_, uz_, j_, ua_, a_: sc3.stretch_half_step(
            lp3, x_, l_, 0, uz_, j_, ua_, 2.0, off3, sc3_, n_accept=a_, check_partners=False),
            x3, l3, h3, 4, launches=20 if h3 > 32 else 100)

    # K6a over ShockCooling3, 17 rungs x 512 walkers (chip_smoke.py phase 14)
    q3 = (rng.uniform(SC3_LO, SC3_UP, size=(17 * 512, 7)) - off3) / sc3_
    tempered("K6a_SC3", lp3, torch.as_tensor(q3.reshape(17, 2, 256, 7), device=dev).float()
             .contiguous(), off3, sc3_, 2)

    # at chip_smoke.py's shapes: K3 on the flagship's points (SC3's T and R,
    # E(B-V) per walker), K4 with its gradient, the epoch half-step (also
    # timed), K4s and K5 at the bolometric bench shape, K6c and K6d at the
    # evidence shape, hashed
    from lightcurve_fitting_tpu_torch.bolometric import _pseudo_grid
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb, quantile as kq
    from lightcurve_fitting_tpu_torch.models.blackbody import bandflux_pointwise
    from lightcurve_fitting_tpu_torch.parallel.batched import EpochPosterior
    ll3 = lp3.log_likelihood
    p3 = torch.as_tensor(rng.uniform(SC3_LO, SC3_UP, size=(4096, 7)), device=dev)
    T3, R3 = ShockCooling3(lcf, device=dev)._tr_points(ll3.t, *[p3[:, i:i + 1] for i in
                                                              (0, 1, 2, 3, 6)])
    ebv = torch.as_tensor(rng.uniform(0.0, 1.0, size=(4096, 1)), device=dev)
    digests["K3"] = digest(bandflux_pointwise(ll3.nodes, ll3.weights, T3, R3, k_ext=ll3.k_ext,
                                              ebv=ebv, band_ids=ll3.band_ids))
    # K3 at the width of its one launch on the SC3 path (evaluate at 9b's
    # medians: one walker x the 149 points)

    def k3_one():
        return bandflux_pointwise(ll3.nodes, ll3.weights, T3[:1], R3[:1], k_ext=ll3.k_ext,
                                  ebv=ebv[:1], band_ids=ll3.band_ids)
    times["K3_W1"] = events_ms(k3_one, 100, args.repeats)
    times["K3_W1_dev"] = device_ms(k3_one, "bandflux", 100, args.repeats)
    packed, truth = chip_smoke.bench_epochs(np.random.default_rng(0), dev)
    ep = EpochPosterior(packed, chip_smoke.bol_priors())
    E = ep.n_epochs
    q4 = torch.as_tensor(chip_smoke.epoch_params(rng, E, 512), device=dev)
    digests["K4"] = digest(*epoch_bb.log_posterior(ep, q4, with_grad=True))
    x4 = np.abs(np.stack([truth, np.full(E, 10.0)], axis=1)[:, None, None, :]
                * (1 + 0.3 * rng.normal(size=(E, 2, 16, 2))))
    x4 = torch.as_tensor(x4, device=dev).float().contiguous()
    l4 = ep(x4.reshape(E, 32, 2)).reshape(E, 2, 16)
    g.manual_seed(6)
    draws4 = (torch.rand((E, 2, 16), generator=g, device=dev),
              torch.randint(0, 16, (E, 2, 16), generator=g, device=dev),
              torch.rand((E, 2, 16), generator=g, device=dev))
    a4 = torch.zeros((E, 2, 16), dtype=torch.int32, device=dev)
    epoch_bb.stretch_half_step(ep, x4, l4, 0, *draws4, 2.0, n_accept=a4)
    digests["epoch_half"] = digest(x4, l4, a4)

    def epoch_half():
        epoch_bb.stretch_half_step(ep, x4, l4, 0, *draws4, 2.0, n_accept=a4,
                                   check_partners=False)
    times["epoch_half"] = events_ms(epoch_half, 100, args.repeats)
    times["epoch_half_dev"] = device_ms(epoch_half, "stretch_half_step_kernel", 100, args.repeats)
    # the MAP centering of the bench epochs (batched_map_centers's polish:
    # 8 starts x 300 Adam steps): K4 with the gradient at the parent's
    # per-step width (256 x 8), K4p where the checkout has it, in float32
    # and float64, and the centering's wall (_map_centers: the cloud's
    # scoring, the starts and the polish)
    from lightcurve_fitting_tpu_torch.parallel import batched
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            epc = EpochPosterior(packed, chip_smoke.bol_priors())
            cloud_u = torch.rand((E, 512, 2), generator=batched._generator(dev, 1, -1),
                                 device=dev, dtype=torch.float64)
            if label == "f32":
                times["centering"] = [wall(lambda: batched._map_centers(epc, cloud_u))[0] * 1e3
                                      for _ in range(args.repeats)]
            # the starts as _map_centers takes them (the parent has no _polish_starts)
            bounds4, log_lo, log_up = batched._candidate_box(epc.priors)
            cloud = torch.exp(cloud_u * torch.as_tensor(log_up - log_lo, device=dev)
                              + torch.as_tensor(log_lo, device=dev))
            top = torch.sort(epc(cloud), dim=-1, descending=True, stable=True).indices[:, :8]
            u8 = bounds4.to_unbounded(torch.gather(cloud, 1, top[..., None].expand(-1, -1, 2)))
            x8 = bounds4.to_bounded(u8).contiguous()
            times[f"K4_grad_8_{label}"] = events_ms(
                lambda: epoch_bb.log_posterior(epc, x8, with_grad=True), 100, args.repeats)
            times[f"K4_grad_8_{label}_dev"] = device_ms(
                lambda: epoch_bb.log_posterior(epc, x8, with_grad=True), "epoch_logpost_kernel",
                100, args.repeats)
            digests[f"K4_grad_8_{label}"] = digest(*epoch_bb.log_posterior(epc, x8,
                                                                           with_grad=True))
            if hasattr(epoch_bb, "map_polish"):
                u8 = u8.contiguous()
                times[f"K4p_{label}"] = events_ms(
                    lambda: epoch_bb.map_polish(epc, u8, bounds4), 1, args.repeats)
                times[f"K4p_{label}_dev"] = device_ms(
                    lambda: epoch_bb.map_polish(epc, u8, bounds4), "epoch_map_polish", 1,
                    args.repeats)
                digests[f"K4p_{label}"] = digest(*epoch_bb.map_polish(epc, u8, bounds4,
                                                                      return_starts=True))
        finally:
            config.set_compute_dtype(config.AUTO)
    centre = np.exp(rng.uniform(np.log([4.0, 1.0]), np.log([20.0, 30.0]), size=(E, 2)))
    chain = np.abs(centre[None, :, None, :] * (1 + 0.05 * rng.normal(size=(100, E, 32, 2))))
    chain = torch.as_tensor(chain, device=dev).float().contiguous()
    nu = torch.as_tensor(_pseudo_grid(), device=dev)
    wq = torch.ones_like(nu)
    wq[0] = wq[-1] = 0.5
    rows = epoch_bb.summary_samples(chain, nu, wq, np.inf, torch.float32)
    digests["K4s"] = digest(rows)
    digests["K5"] = digest(kq.percentile_rows(rows.reshape(E * 4, -1).contiguous(),
                                              [16.0, 50.0, 84.0]))
    R6, h6 = 17, 2048
    x6 = torch.as_tensor(rng.normal(size=(R6, 2, h6, 4)), device=dev).float()
    pri6 = torch.zeros((R6, 2, h6), dtype=torch.float64, device=dev)
    ll6 = torch.as_tensor(-12990.0 + 10.0 * rng.normal(size=(R6, 2, h6)), device=dev)
    swap_out = [torch.zeros((R6, 2, h6), dtype=torch.int32, device=dev),
                torch.empty((R6, 2, h6), dtype=torch.float64, device=dev),
                torch.empty((2, h6, 4), device=dev)]
    ladder.replica_swap(x6, pri6, ll6, torch.as_tensor(make_beta_ladder(R6 - 1), device=dev),
                        torch.as_tensor(rng.random((R6, 2, h6)), device=dev).float(), 1, *swap_out)
    digests["K6c"] = digest(x6, pri6, ll6, *swap_out)
    logl6 = torch.as_tensor(-12990.0 + 10.0 * rng.normal(size=(150, R6, 2 * h6)), device=dev)
    digests["K6d"] = digest(ladder.rung_block_terms(
        logl6, torch.as_tensor(np.diff(make_beta_ladder(R6 - 1)), device=dev),
        ((0, 38), (38, 76), (76, 113), (113, 150))))

    # the companion-shocking kernels (CompanionShocking2, float32 rescaled state)
    lc_ia, lc0 = chip_smoke.ia_lc()
    lo_c, up_c = chip_smoke.CS_LO[2], chip_smoke.CS_UP[2]
    lpc = make_log_posterior(chip_smoke.cs_model(2, lc0), lc_ia, chip_smoke.cs_priors(2),
                             device=dev)
    kwc = _state_rescaling(torch.float32, lo_c, up_c, dev)
    offc, scc = kwc["param_offset"], kwc["param_scale"]
    pc = torch.as_tensor(rng.uniform(lo_c, up_c, size=(W, 7)), device=dev)
    times["CS_logpost"] = events_ms(lambda: cs.log_posterior(lpc, pc), 20, args.repeats)
    # "logpost": the kernel of either form (a checkout's cs_logpost_kernel or
    # logpost_warp_kernel)
    times["CS_logpost_dev"] = device_ms(lambda: cs.log_posterior(lpc, pc), "logpost", 20,
                                        args.repeats)
    digests["CS_logpost"] = digest(cs.log_posterior(lpc, pc))
    t_c, quad_c = lpc.log_likelihood.t, lpc.log_likelihood.quad
    k8_args = [pc[:, k:k + 1].contiguous() for k in (3, 4, 5, 6)]   # t_peak, s, dtU, dti
    times["K8"] = events_ms(lambda: cs.sifto(t_c, quad_c, *k8_args), 20, args.repeats)
    times["K8_dev"] = device_ms(lambda: cs.sifto(t_c, quad_c, *k8_args), "sifto_kernel", 20,
                                args.repeats)
    digests["K8"] = digest(cs.sifto(t_c, quad_c, *k8_args))
    # K8 at the width of its launches on the CS path (evaluate: one walker)
    k8_one = [a[:1] for a in k8_args]
    times["K8_W1"] = events_ms(lambda: cs.sifto(t_c, quad_c, *k8_one), 100, args.repeats)
    times["K8_W1_dev"] = device_ms(lambda: cs.sifto(t_c, quad_c, *k8_one), "sifto_kernel", 100,
                                   args.repeats)
    for hc in (16, 16384, 65536):
        xc = torch.as_tensor((rng.uniform(lo_c, up_c, size=(2 * hc, 7)) - offc) / scc,
                             device=dev).float().reshape(2, hc, 7).contiguous()
        lcs = cs.log_posterior(lpc, xc.reshape(2 * hc, 7), offc, scc).reshape(2, hc)
        half_step(f"CS_half_{hc}", lambda x_, l_, uz_, j_, ua_, a_: cs.stretch_half_step(
            lpc, x_, l_, 0, uz_, j_, ua_, 2.0, offc, scc, n_accept=a_, check_partners=False),
            xc, lcs, hc, 17, launches=20 if hc > 16 else 100)
    for rc, hc in ((7, 32), (17, 2048)):
        qc = (rng.uniform(lo_c, up_c, size=(rc * 2 * hc, 7)) - offc) / scc
        xlc = torch.as_tensor(qc.reshape(rc, 2, hc, 7), device=dev).float().contiguous()
        if rc == 17:   # K6b on the state before K6a's timing moves it
            x6b = xlc.clone()
            times["CS_K6b"] = events_ms(lambda: ladder.ladder_init(lpc, x6b, offc, scc), 20,
                                        args.repeats)
            times["CS_K6b_dev"] = device_ms(lambda: ladder.ladder_init(lpc, x6b, offc, scc),
                                            "ladder_init_kernel", 20, args.repeats)
            digests["CS_K6b"] = digest(*ladder.ladder_init(lpc, x6b, offc, scc))
        tempered(f"CS_K6a_{rc}x{2 * hc}", lpc, xlc, offc, scc, 18)

    # the batch log-posteriors at the widths whose initial state the fits
    # compute (SC3: 64 in 9a, 4096 in 9c, 32768 in 9b; CS2: 32 in 24a, 32768
    # in 24b; and 4096 and 131072 beside them), on the sampler's float32
    # rescaled state, timed and hashed; an rng of their own, so the digests
    # above keep their inputs
    rng_b = np.random.default_rng(30)
    for name, fn_lp, lpb, lo_b, up_b, off_b, sc_b, widths in (
            ("SC3_logpost", sc3.log_posterior, lp3, SC3_LO, SC3_UP, off3, sc3_,
             (64, 4096, 32768, 131072)),
            ("CS_logpost", cs.log_posterior, lpc, lo_c, up_c, offc, scc,
             (32, 4096, 32768, 131072))):
        for wb in widths:
            qb = torch.as_tensor((rng_b.uniform(lo_b, up_b, size=(wb, 7)) - off_b) / sc_b,
                                 device=dev).float().contiguous()

            def batch(fn_lp=fn_lp, lpb=lpb, qb=qb, off_b=off_b, sc_b=sc_b):
                return fn_lp(lpb, qb, off_b, sc_b)
            launches = 20 if wb > 4096 else 100
            times[f"{name}_W{wb}"] = events_ms(batch, launches, args.repeats)
            # "logpost": the kernel of either form (the thread form's
            # sc3_logpost_kernel / cs_logpost_kernel, logpost_warp_kernel)
            times[f"{name}_W{wb}_dev"] = device_ms(batch, "logpost", launches, args.repeats)
            digests[f"{name}_W{wb}"] = digest(batch())

    # K6c at the ladders' shapes: the evidence (16a, 24c: 17 rungs x 4096),
    # compare_models on synthetic photometry (16c: 17 x 32) and the PT fits
    # (16b: 7 x 32; 24c: 7 x 64), a production step (all outputs); beside
    # them a one-element add, the card's time for a kernel with no work
    for Rk, Wk in ((17, 4096), (17, 32), (7, 32), (7, 64)):
        hk = Wk // 2
        xk = torch.as_tensor(rng_b.normal(size=(Rk, 2, hk, 4)), device=dev).float()
        prik = torch.zeros((Rk, 2, hk), dtype=torch.float64, device=dev)
        llk = torch.as_tensor(-12990.0 + 10.0 * rng_b.normal(size=(Rk, 2, hk)), device=dev)
        betak = torch.as_tensor(make_beta_ladder(Rk - 1), device=dev)
        uk = torch.as_tensor(rng_b.random((Rk, 2, hk)), device=dev).float()
        outk = [torch.zeros((Rk, 2, hk), dtype=torch.int32, device=dev),
                torch.empty((Rk, 2, hk), dtype=torch.float64, device=dev),
                torch.empty((2, hk, 4), device=dev)]

        def swap(xk=xk, prik=prik, llk=llk, betak=betak, uk=uk, outk=outk):
            ladder.replica_swap(xk, prik, llk, betak, uk, 1, *outk)
        times[f"K6c_{Rk}x{Wk}"] = events_ms(swap, 100, args.repeats)
        times[f"K6c_{Rk}x{Wk}_dev"] = device_ms(swap, "replica_swap", 100, args.repeats)
    one = torch.zeros(1, device=dev)
    times["add1"] = events_ms(lambda: one.add_(1.0), 100, args.repeats)
    times["add1_dev"] = device_ms(lambda: one.add_(1.0), "elementwise", 100, args.repeats)

    # K1 at the widths of the SC2 fits' initial states (20b: 48; 5a and 20c's
    # warm start: 64; 5c: 4096; 5b: 131072), float32 and float64 compute on
    # the sampler's rescaled state of the same precision; K6b as each
    # ladder calls it (16a: 17 rungs x 4096 walkers; 16b: 7 x 32; 16c: 17 x
    # 32; over CS, 24c: 17 x 4096 and 7 x 64; over SC3, phase 14's 17 x 512;
    # a checkout whose ladder_init takes ``copies`` evaluates the rungs'
    # one set of starting states once, an older one every rung's copy of
    # it); K4s at the bolometric paths' shapes (13a: 65 epochs, 13b: 256;
    # 100 steps x 32 walkers); device times and digests, an rng of their own
    rng_m = np.random.default_rng(40)
    import inspect
    copies_arg = "copies" in inspect.signature(ladder.ladder_init).parameters
    for label, cdt in (("f32", torch.float32), ("f64", torch.float64)):
        try:
            config.set_compute_dtype(cdt)
            lp_m = make_log_posterior(ShockCooling2(lc), lc, priors, device=dev)
            # float32: the rescaled float32 state; float64: absolute float64
            kw_m = _state_rescaling(cdt, P_LO, P_UP, dev)
            off_m, sc_m = kw_m.get("param_offset", 0.0), kw_m.get("param_scale", 1.0)
            for wm in (48, 64, 4096, 131072):
                qm = torch.as_tensor((rng_m.uniform(P_LO, P_UP, size=(wm, 4)) - off_m) / sc_m,
                                     device=dev).to(kw_m.get("dtype", torch.float64))

                def k1(lp_m=lp_m, qm=qm.contiguous(), kw_m=kw_m):
                    return sc2.log_posterior(lp_m, qm, kw_m.get("param_offset"),
                                             kw_m.get("param_scale"))
                launches = 20 if wm > 4096 else 100
                times[f"K1_W{wm}_{label}"] = events_ms(k1, launches, args.repeats)
                # "logpost": the kernel of either form (a checkout's thread
                # form or logpost_warp_kernel)
                times[f"K1_W{wm}_{label}_dev"] = device_ms(k1, "logpost", launches, args.repeats)
                digests[f"K1_W{wm}_{label}"] = digest(k1())
        finally:
            config.set_compute_dtype(config.AUTO)

    def k6b_as_called(name, target, lo, up, off_, sc_, R_, W_):
        """K6b as a ladder of R_ rungs x W_ walkers calls it: one set of
        starting states for every rung."""
        q_ = (rng_m.uniform(lo, up, size=(W_, len(lo))) - off_) / sc_
        x1 = torch.as_tensor(q_.reshape(1, 2, W_ // 2, len(lo)), device=dev).float().contiguous()
        xr = x1.expand(R_, 2, W_ // 2, len(lo)).contiguous()

        def init(target=target, x1=x1, xr=xr):
            if copies_arg:
                return ladder.ladder_init(target, x1, off_, sc_, copies=R_)
            return ladder.ladder_init(target, xr, off_, sc_)
        launches = 20 if R_ * W_ > 4096 else 100
        times[name] = events_ms(init, launches, args.repeats)
        times[name + "_dev"] = device_ms(init, "ladder_init_kernel", launches, args.repeats)
        digests[name] = digest(*init())
    for R_, W_ in ((17, 4096), (7, 32), (17, 32)):
        k6b_as_called(f"K6b_SC2_{R_}x{W_}", lp, P_LO, P_UP, off, sc, R_, W_)
    for R_, W_ in ((17, 4096), (7, 64)):
        k6b_as_called(f"K6b_CS_{R_}x{W_}", lpc, lo_c, up_c, offc, scc, R_, W_)
    k6b_as_called("K6b_SC3_17x512", lp3, SC3_LO, SC3_UP, off3, sc3_, 17, 512)
    nu_m = torch.as_tensor(_pseudo_grid(), device=dev)
    wq_m = torch.ones_like(nu_m)
    wq_m[0] = wq_m[-1] = 0.5
    for Em in (65, 256):
        centre_m = np.exp(rng_m.uniform(np.log([4.0, 1.0]), np.log([20.0, 30.0]), size=(Em, 2)))
        chain_m = np.abs(centre_m[None, :, None, :]
                         * (1 + 0.05 * rng_m.normal(size=(100, Em, 32, 2))))
        chain_m = torch.as_tensor(chain_m, device=dev).float().contiguous()

        def k4s(chain_m=chain_m):
            return epoch_bb.summary_samples(chain_m, nu_m, wq_m, np.inf, torch.float32)
        times[f"K4s_E{Em}"] = events_ms(k4s, 20, args.repeats)
        times[f"K4s_E{Em}_dev"] = device_ms(k4s, "epoch_summary", 20, args.repeats)
        digests[f"K4s_E{Em}"] = digest(k4s())

        def k4s_f64(chain_m=chain_m.double()):
            return epoch_bb.summary_samples(chain_m, nu_m, wq_m, np.inf, torch.float64)
        times[f"K4s_E{Em}_f64"] = events_ms(k4s_f64, 20, args.repeats)
        times[f"K4s_E{Em}_f64_dev"] = device_ms(k4s_f64, "epoch_summary", 20, args.repeats)
        digests[f"K4s_E{Em}_f64"] = digest(k4s_f64())

    # the CS log-posterior in float64 compute at the widths above, on the
    # absolute float64 state of a float64 fit (CS_logpost_W*_f64)
    try:
        config.set_compute_dtype(torch.float64)
        lpc64 = make_log_posterior(chip_smoke.cs_model(2, lc0), lc_ia, chip_smoke.cs_priors(2),
                                   device=dev)
        for wb in (32, 4096, 32768, 131072):
            qb = torch.as_tensor(rng_m.uniform(lo_c, up_c, size=(wb, 7)), device=dev)

            def batch64(qb=qb):
                return cs.log_posterior(lpc64, qb)
            launches = 20 if wb > 4096 else 100
            times[f"CS_logpost_W{wb}_f64"] = events_ms(batch64, launches, args.repeats)
            times[f"CS_logpost_W{wb}_f64_dev"] = device_ms(batch64, "logpost", launches,
                                                           args.repeats)
            digests[f"CS_logpost_W{wb}_f64"] = digest(batch64())
    finally:
        config.set_compute_dtype(config.AUTO)

    # K4's values at the bolometric paths' widths, the centering's cloud
    # (float64 candidates, 512 an epoch) and the initial state (the float32
    # walker state, 32 an epoch), at 13b's 256 bench epochs and 13a's 65 SN
    # 2016bkv epochs (K4_cloud_E*, K4_init_E*; _f64: float64 compute);
    # where the checkout has K4's two value forms, each form alone
    # (K4_*_thread_dev, K4_*_warp_dev), and the cloud's first 64, 96, 128
    # and 192 bench epochs in each form (K4_cross_E*: the widths about
    # k4_form's crossover); and K6d at the ladders' shapes (16a
    # and 24c: 150 steps x 17 rungs x 4096 walkers, K6d; 16b: 250 x 7 x 32;
    # 16c: 250 x 17 x 32; 24c's PT fit: 250 x 7 x 64), 4 blocks, and at the
    # bench shape with the splits aimed at 2, 4 and 8 CTAs an SM in place
    # of K6D_CTAS_PER_SM (K6d_cta*_dev); device times and
    # digests, an rng of their own
    rng_k = np.random.default_rng(41)
    shapes4 = {256: packed, 65: chip_smoke.sn2016bkv_packed(dev)}
    clouds = {}
    for label, cdt in (("", torch.float32), ("_f64", torch.float64)):
        try:
            config.set_compute_dtype(cdt)
            for Ek, packed_k in shapes4.items():
                epk = EpochPosterior(packed_k, chip_smoke.bol_priors())
                _, log_lo, log_up = batched._candidate_box(epk.priors)
                u_k = torch.as_tensor(rng_k.random((Ek, 512, 2)), device=dev)
                cloud_k = torch.exp(u_k * torch.as_tensor(log_up - log_lo, device=dev)
                                    + torch.as_tensor(log_lo, device=dev)).contiguous()
                clouds[Ek] = cloud_k
                init_k = torch.as_tensor(np.exp(rng_k.uniform(np.log([4.0, 1.0]),
                                                              np.log([20.0, 30.0]),
                                                              size=(Ek, 32, 2))),
                                         device=dev).float().contiguous()
                for what, qk in (("cloud", cloud_k), ("init", init_k)):
                    name = f"K4_{what}_E{Ek}{label}"

                    def k4(epk=epk, qk=qk):
                        return epoch_bb.log_posterior(epk, qk)[0]
                    times[name] = events_ms(k4, 20, args.repeats)
                    times[name + "_dev"] = device_ms(k4, "logpost", 20, args.repeats)
                    digests[name] = digest(k4())
                    if hasattr(epoch_bb, "k4_form"):
                        for form in ("warp", "thread"):
                            def k4f(epk=epk, qk=qk, form=form):
                                return epoch_bb._launch_k4(epk, qk, False, form)[0]
                            times[f"{name}_{form}_dev"] = device_ms(k4f, "logpost", 20,
                                                                   args.repeats)
                            digests[f"{name}_{form}"] = digest(k4f())
            if hasattr(epoch_bb, "k4_form"):
                for Ek in (64, 96, 128, 192):
                    epk = EpochPosterior({k: v[:Ek] for k, v in packed.items()},
                                         chip_smoke.bol_priors())
                    for form in ("warp", "thread"):
                        def k4c(epk=epk, qk=clouds[256][:Ek].contiguous(), form=form):
                            return epoch_bb._launch_k4(epk, qk, False, form)[0]
                        times[f"K4_cross_E{Ek}{label}_{form}_dev"] = device_ms(
                            k4c, "logpost", 20, args.repeats)
        finally:
            config.set_compute_dtype(config.AUTO)
    for steps_k, R_k, W_k in ((150, 17, 4096), (250, 7, 32), (250, 17, 32), (250, 7, 64)):
        ll_k = torch.as_tensor(-12990.0 + 10.0 * rng_k.normal(size=(steps_k, R_k, W_k)),
                               device=dev)
        db_k = torch.as_tensor(np.diff(make_beta_ladder(R_k - 1)), device=dev)
        bounds_k = tuple((int(i[0]), int(i[-1]) + 1)
                         for i in np.array_split(np.arange(steps_k), 4))
        name = "K6d" if W_k == 4096 else f"K6d_{steps_k}x{R_k}x{W_k}"

        def k6d(ll_k=ll_k, db_k=db_k, bounds_k=bounds_k):
            return ladder.rung_block_terms(ll_k, db_k, bounds_k)
        times[name] = events_ms(k6d, 100, args.repeats)
        times[name + "_dev"] = device_ms(k6d, "rung_block_terms", 100, args.repeats)
        digests[name + ("_timed" if W_k == 4096 else "")] = digest(k6d())
        if W_k == 4096 and hasattr(ladder, "K6D_CTAS_PER_SM"):
            aim = ladder.K6D_CTAS_PER_SM
            try:
                for c in (2, 4, 8):
                    ladder.K6D_CTAS_PER_SM = c
                    times[f"K6d_cta{c}_dev"] = device_ms(k6d, "rung_block_terms", 100,
                                                         args.repeats)
            finally:
                ladder.K6D_CTAS_PER_SM = aim

    if args.fits:
        # the bolometric fits of chip_smoke.py phase 13, two runs each: (13a)
        # calculate_bolometric on the full SN 2016bkv curve, (13b) the bench
        # shape (the centering, then 32 walkers x 200 + 100 steps with the
        # device summaries) from seed 1's guesses, and a profiled 13b run's
        # device busy time
        import warnings
        from lightcurve_fitting_tpu_torch.bolometric import _pseudo_grid as pseudo_grid
        from lightcurve_fitting_tpu_torch.bolometric import calculate_bolometric
        from lightcurve_fitting_tpu_torch.lightcurve import LC
        lc_full = LC.read(os.path.join(repo, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
        lc_full.meta.update(META)
        for rep in range(2):
            with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
                warnings.simplefilter("ignore")
                walls[f"bol_13a_{rep}"], _ = wall(lambda: calculate_bolometric(
                    lc_full, batch_mode=True, save_corners=False, nwalkers=32, seed=7))
        def bench_13b():
            centers = batched.batched_map_centers(packed, chip_smoke.bol_priors(), seed=1)
            gs = np.random.default_rng(1).normal(size=(E, 32, 2)) * 0.5 + centers[:, None, :]
            gs[gs <= 0.0] = 1.0
            return batched.batched_blackbody_mcmc(
                packed, chip_smoke.bol_priors(), gs, 32, 200, 100, seed=1, return_chains=False,
                summaries={"z": 0.0, "pseudo_nu": pseudo_grid()})
        for rep in range(2):
            walls[f"bol_13b_{rep}"], out13 = wall(bench_13b)
        walls["bol_13b_acceptance"] = float(np.mean(out13[1]))
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bench_13b()
            torch.cuda.synchronize()
            wall13 = time.perf_counter() - t0
        busy13 = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type.name == "CUDA") / 1e6
        walls["bol_13b_profiled"] = {"wall": wall13, "busy": busy13,
                                     "idle_share": 1 - busy13 / wall13}

        # the gradient path's fits of chip_smoke.py phase 20, two runs each:
        # (20a) lightcurve_map, (20d) lightcurve_hmc(sampler="hmc") at 16
        # chains x 150 + 100
        for rep in range(2):
            walls[f"map_20a_{rep}"], _ = wall(lambda: lightcurve_map(
                lc, ShockCooling2(lc), gpri, seed=0, quiet=True, device=dev))
        for rep in range(2):
            walls[f"hmc_20d_{rep}"], _ = wall(lambda: lightcurve_hmc(
                lc, ShockCooling2(lc), gpri, sampler="hmc", nchains=16, nsamples=100,
                n_warmup=150, seed=4, quiet=True, device=dev))
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(torch.float64)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lightcurve_hmc(lc, ShockCooling2(lc), gpri, seed=3, quiet=True, device=dev)
                torch.cuda.synchronize()
                walls[f"lightcurve_hmc_{label}"] = time.perf_counter() - t0
            finally:
                config.set_compute_dtype(config.AUTO)
        # the ShockCooling3 fits of chip_smoke.py phase 9, two runs each:
        # (9a) 64 walkers x 200 + 200, (9b) 32768 x 300, (9c) 4096 x 300 at
        # seed 1
        sc3_kw = dict(p_lo=SC3_LO, p_up=SC3_UP, quiet=True)
        for rep in range(2):
            walls[f"sc3_9a_{rep}"], _ = wall(lambda: lightcurve_mcmc(
                lc, ShockCooling3(lc), chip_smoke.sc3_priors(), nwalkers=64, nsteps=200,
                nsteps_burnin=200, seed=7, **sc3_kw))
        for rep in range(2):
            walls[f"sc3_32768x300_{rep}"], s = wall(lambda: lightcurve_mcmc(
                lc, ShockCooling3(lc), chip_smoke.sc3_priors(), nwalkers=32768, nsteps=300,
                nsteps_burnin=0, seed=7, **sc3_kw))
        walls["sc3_acceptance"] = float(np.mean(s.acceptance_fraction))
        for rep in range(2):
            walls[f"sc3_9c_{rep}"], _ = wall(lambda: lightcurve_mcmc(
                lc, ShockCooling3(lc), chip_smoke.sc3_priors(), nwalkers=4096, nsteps=300,
                nsteps_burnin=0, seed=1, **sc3_kw))

        # the ShockCooling2 fits of chip_smoke.py phases 5 and 16, two runs
        # each: (5a) 64 walkers x 200 + 200, (5b) 131072 x 300 from the
        # window, (16a) lightcurve_evidence at 4096 walkers x 16 rungs + beta
        # = 1 x 150 + 150, (16b) lightcurve_ptmcmc at 32 walkers x 6 rungs +
        # beta = 1 x 350 + 250
        sc2_kw = dict(p_lo=P_LO, p_up=P_UP, quiet=True)
        for rep in range(2):
            walls[f"sc2_5a_{rep}"], _ = wall(lambda: lightcurve_mcmc(
                lc, ShockCooling2(lc), priors, nwalkers=64, nsteps=200, nsteps_burnin=200,
                seed=7, **sc2_kw))
        for rep in range(2):
            walls[f"sc2_5b_{rep}"], s = wall(lambda: lightcurve_mcmc(
                lc, ShockCooling2(lc), priors, nwalkers=131072, nsteps=300, nsteps_burnin=0,
                seed=7, **sc2_kw))
        walls["sc2_5b_acceptance"] = float(np.mean(s.acceptance_fraction))
        for rep in range(2):
            walls[f"sc2_16a_{rep}"], ev = wall(lambda: lightcurve_evidence(
                lc, ShockCooling2(lc), priors, nwalkers=chip_smoke.EV_WALKERS,
                n_rungs=chip_smoke.EV_RUNGS, nsteps=chip_smoke.EV_STEPS,
                nsteps_burnin=chip_smoke.EV_BURNIN, seed=1, **sc2_kw))
        walls["sc2_16a_log_z"] = [float(ev[0]), float(ev[1])]
        for rep in range(2):
            walls[f"sc2_16b_{rep}"], _ = wall(lambda: lightcurve_ptmcmc(
                lc, ShockCooling2(lc), gpri, p_lo=[20, 2, 20, 57468.4],
                p_up=[50, 5, 50, 57468.69], nwalkers=32, n_rungs=6, nsteps=250,
                nsteps_burnin=350, seed=2, quiet=True))

        # the companion-shocking fits of chip_smoke.py phase 24, two runs each:
        # (a) CS2 32 walkers x 300 + 250, (b) 32768 x 300 from the window, (c)
        # lightcurve_evidence at 4096 walkers x 16 rungs + beta = 1 x 150 + 150
        cs_kw = dict(p_lo=lo_c, p_up=up_c, quiet=True)
        for rep in range(2):
            walls[f"cs2_24a_{rep}"], s = wall(lambda: lightcurve_mcmc(
                lc_ia, chip_smoke.cs_model(2, lc0), chip_smoke.cs_priors(2), nwalkers=32,
                nsteps=250, nsteps_burnin=300, seed=12, **cs_kw))
        for rep in range(2):
            walls[f"cs2_24b_{rep}"], s = wall(lambda: lightcurve_mcmc(
                lc_ia, chip_smoke.cs_model(2, lc0), chip_smoke.cs_priors(2),
                nwalkers=chip_smoke.CS_WALKERS, nsteps=300, nsteps_burnin=0, seed=7, **cs_kw))
        walls["cs2_24b_acceptance"] = float(np.mean(s.acceptance_fraction))
        for rep in range(2):
            walls[f"cs2_24c_{rep}"], ev = wall(lambda: lightcurve_evidence(
                lc_ia, chip_smoke.cs_model(2, lc0), chip_smoke.cs_priors(2),
                nwalkers=chip_smoke.EV_WALKERS, n_rungs=chip_smoke.EV_RUNGS,
                nsteps=chip_smoke.EV_STEPS, nsteps_burnin=chip_smoke.EV_BURNIN, seed=1, **cs_kw))
        walls["cs2_24c_log_z"] = [float(ev[0]), float(ev[1])]

    sass = {}
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        dump = subprocess.run([cuobjdump, "-sass", build.build_info()["path"]], capture_output=True,
                              text=True, check=True, timeout=600).stdout
        for func in re.split(r"\n\s*Function : ", dump)[1:]:
            name = func.split("\n", 1)[0].strip()
            if any(k in name for k in args.sass):
                code = [line.split("*/", 1)[1].strip() for line in func.splitlines()
                        if re.match(r"\s*/\*[0-9a-f]{4,}\*/", line)]
                sass[name] = [len(code), hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for k, v in times.items():
        print(f"[time_port_kernels] {args.label} {k}: min {min(v):.4f} ms, repeats "
              f"{', '.join(f'{t:.4f}' for t in v)}"
              + (f", digest {digests[k]}" if k in digests else ""), flush=True)
    for k, v in digests.items():
        if k not in times:
            print(f"[time_port_kernels] {args.label} {k}: digest {v}", flush=True)
    for k, v in {**info, **walls}.items():
        print(f"[time_port_kernels] {args.label} {k}: {v}", flush=True)
    for k, v in ptxas.items():
        print(f"[time_port_kernels] {args.label} ptxas {k}: registers {v[0]}, stack frame "
              f"{v[1]} bytes, spill stores {v[2]}, spill loads {v[3]}", flush=True)
    for k, v in sass.items():
        print(f"[time_port_kernels] {args.label} sass {k}: {v[0]} instructions, hash {v[1]}",
              flush=True)
    print(json.dumps({"label": args.label, "repo": repo, "card": smi,
                      "ms": {k: min(v) for k, v in times.items()}, "repeats": times,
                      "digests": digests, "info": info, "walls": walls, "ptxas": ptxas,
                      "sass": sass}),
          flush=True)


if __name__ == "__main__":
    main()
