#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card at the shapes of ``chip_smoke.py``
and of the fits, float32 compute, by CUDA events:

* K1 at 131072 walkers; K2 per half-step of 131072; K6a per ladder
  half-step of 17 rungs x 4096 (ShockCooling2) and of 17 x 512
  (ShockCooling3); K7 at 131072 walkers and at the MAP ascent's 64 starts
  (float32 and float64); K7h per 64-chain HMC transition (32 jittered
  leapfrogs, eps 0.1);
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
  32768-walker fits and the 131072-walker comparison);
* with ``--fits``, the wall times of ``lightcurve_hmc`` at its defaults in
  float32 and float64, of the ShockCooling3 fit at 32768 x 300 and of the
  CompanionShocking2 fits of ``chip_smoke.py`` phase 24 (a: 32 walkers x
  300 + 250; b: 32768 x 300; c: the evidence at 4096 x 17 rungs x 150 +
  150).

Each time is printed twice: by CUDA events around a run of launches (the
stream's time per launch, which a kernel shorter than its wrapper's host
time does not fill) and, as ``NAME_dev`` for the half-steps, K6a, K6b over
CS, the CS log-posterior, K8 and K7 at 64 walkers, by the profiler's device
timestamps (the kernel's own time). ``--sass NAME`` prints a hash of the
SASS of each kernel whose name holds NAME (``cuobjdump``), to tell a
kernel's code apart from its placement.
Each kernel's outputs at fixed inputs are hashed (``digest``): two checkouts
whose kernel computes the same bits print the same digest. The ptxas report
of the gradient and SC3 kernels (registers, stack frame, spills) comes from
the build.

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
PTXAS_KERNELS = ("nuts_transition", "hmc_transition", "logpost_grad", "SC3WarpModel",
                 "stretch_half_step_kernelI8SC3Model", "CSWarpModel", "I7CSModel")


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
                    help="also time lightcurve_hmc (f32, f64), the SC3 32768 x 300 fit and "
                         "the CS2 fits of chip_smoke.py phase 24")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_port_kernels: CUDA is not available; this script runs on the GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import (_state_rescaling, lightcurve_evidence,
                                                      lightcurve_hmc, lightcurve_mcmc,
                                                      make_log_posterior)
    from lightcurve_fitting_tpu_torch.kernels import build, cs, gradient, ladder, sc2, sc3
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
    times, digests, info = {}, {}, {}

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

    # K1 at 131072 walkers, K2 per half-step of 131072 (float32 rescaled state)
    W = 131072
    half = W // 2
    p = torch.as_tensor(rng.uniform(P_LO, P_UP, size=(W, 4)), device=dev)
    times["K1"] = events_ms(lambda: sc2.log_posterior(lp, p), 20, args.repeats)
    digests["K1"] = digest(sc2.log_posterior(lp, p))
    x = torch.as_tensor(((p.cpu().numpy() - off) / sc).reshape(2, half, 4),
                        device=dev).float().contiguous()
    logp = sc2.log_posterior(lp, x.reshape(W, 4), off, sc).reshape(2, half)
    half_step("K2", lambda x_, l_, uz, j_, ua, a_: sc2.stretch_half_step(
        lp, x_, l_, 0, uz, j_, ua, 2.0, off, sc, n_accept=a_, check_partners=False),
        x, logp, half, 1)

    # K6a: one ladder half-step of 17 rungs x 4096 walkers
    R, Wl = 17, 4096
    q = (rng.uniform(P_LO, P_UP, size=(R * Wl, 4)) - off) / sc
    xl = torch.as_tensor(q.reshape(R, 2, Wl // 2, 4), device=dev).float().contiguous()
    pri, ll = ladder.ladder_init(lp, xl, off, sc)
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    shape = (R, 2, Wl // 2)
    g.manual_seed(1)
    uz = torch.rand(shape, generator=g, device=dev)
    jl = torch.randint(0, Wl // 2, shape, generator=g, device=dev)
    ua = torch.rand(shape, generator=g, device=dev)
    xd, pd, ld = xl.clone(), pri.clone(), ll.clone()
    ad = torch.zeros(shape, dtype=torch.int32, device=dev)
    ladder.tempered_half_step(lp, xd, pd, ld, betas, 0, uz, jl, ua, 2.0, off, sc, ad)
    digests["K6a"] = digest(xd, pd, ld, ad)
    al = torch.zeros(shape, dtype=torch.int32, device=dev)
    times["K6a"] = events_ms(lambda: ladder.tempered_half_step(lp, xl, pri, ll, betas, 0, uz, jl,
                                                               ua, 2.0, off, sc, al,
                                                               check_partners=False),
                             20, args.repeats)

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
                                                    "logpost_grad_kernel", 100, args.repeats)
            digests[f"K7_64_{label}"] = digest(*sc2.log_posterior_and_grad(lp7, p64))
        finally:
            config.set_compute_dtype(config.AUTO)

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
    q16, l16, z16, u16 = (a[:16].contiguous() for a in (q0, logp0, z, u))
    times["K9_16"] = events_ms(lambda: gradient.nuts_transition(target, q16, l16, z16, u16, eps,
                                                                inv_mass, D), 5, args.repeats)
    n_used = torch.randint(16, 33, (C,), generator=g, device=dev)
    u_acc = torch.rand(C, generator=g, device=dev, dtype=torch.float64)
    hargs = (q0, logp0, z, u_acc, n_used, eps, inv_mass, 32)
    times["K7h"] = events_ms(lambda: gradient.hmc_transition(target, *hargs), 5, args.repeats)
    digests["K7h"] = digest(*gradient.hmc_transition(target, *hargs))

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
        half_step(f"SC3_half_{h3}", lambda x_, l_, uz_, j_, ua_, a_: sc3.stretch_half_step(
            lp3, x_, l_, 0, uz_, j_, ua_, 2.0, off3, sc3_, n_accept=a_, check_partners=False),
            x3, l3, h3, 4, launches=20 if h3 > 32 else 100)

    def tempered(name, target, x, off_, sc_, seed):
        """Time K6a over ``target`` on the ladder state x (R, 2, half, ndim),
        and hash one half-step and K6b's initial state from the same start."""
        R_, _, hl, _ = x.shape
        pri_, ll_ = ladder.ladder_init(target, x, off_, sc_)
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

    # K6a over ShockCooling3, 17 rungs x 512 walkers (chip_smoke.py phase 14)
    q3 = (rng.uniform(SC3_LO, SC3_UP, size=(17 * 512, 7)) - off3) / sc3_
    tempered("K6a_SC3", lp3, torch.as_tensor(q3.reshape(17, 2, 256, 7), device=dev).float()
             .contiguous(), off3, sc3_, 2)

    # the companion-shocking kernels (CompanionShocking2, float32 rescaled state)
    lc_ia, lc0 = chip_smoke.ia_lc()
    lo_c, up_c = chip_smoke.CS_LO[2], chip_smoke.CS_UP[2]
    lpc = make_log_posterior(chip_smoke.cs_model(2, lc0), lc_ia, chip_smoke.cs_priors(2),
                             device=dev)
    kwc = _state_rescaling(torch.float32, lo_c, up_c, dev)
    offc, scc = kwc["param_offset"], kwc["param_scale"]
    pc = torch.as_tensor(rng.uniform(lo_c, up_c, size=(W, 7)), device=dev)
    times["CS_logpost"] = events_ms(lambda: cs.log_posterior(lpc, pc), 20, args.repeats)
    times["CS_logpost_dev"] = device_ms(lambda: cs.log_posterior(lpc, pc), "cs_logpost_kernel", 20,
                                        args.repeats)
    digests["CS_logpost"] = digest(cs.log_posterior(lpc, pc))
    t_c, quad_c = lpc.log_likelihood.t, lpc.log_likelihood.quad
    k8_args = [pc[:, k:k + 1].contiguous() for k in (3, 4, 5, 6)]   # t_peak, s, dtU, dti
    times["K8"] = events_ms(lambda: cs.sifto(t_c, quad_c, *k8_args), 20, args.repeats)
    times["K8_dev"] = device_ms(lambda: cs.sifto(t_c, quad_c, *k8_args), "sifto_kernel", 20,
                                args.repeats)
    digests["K8"] = digest(cs.sifto(t_c, quad_c, *k8_args))
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

    walls = {}
    if args.fits:
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
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = lightcurve_mcmc(lc, ShockCooling3(lc), chip_smoke.sc3_priors(), p_lo=SC3_LO,
                                p_up=SC3_UP, nwalkers=32768, nsteps=300, nsteps_burnin=0, seed=7,
                                quiet=True)
            torch.cuda.synchronize()
            walls[f"sc3_32768x300_{rep}"] = time.perf_counter() - t0
        walls["sc3_acceptance"] = float(np.mean(s.acceptance_fraction))

        # the companion-shocking fits of chip_smoke.py phase 24, two runs each:
        # (a) CS2 32 walkers x 300 + 250, (b) 32768 x 300 from the window, (c)
        # lightcurve_evidence at 4096 walkers x 16 rungs + beta = 1 x 150 + 150
        def wall(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

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
