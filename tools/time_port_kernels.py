#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card at the shapes of ``chip_smoke.py``
and of the fits, float32 compute, by CUDA events:

* the population kernels (where the checkout has them; ``--pop-only``
  alone): P1, P2 (one half-step writing the chain slot) and P3 (the whole
  16-start, 400-step ascent) on examples/fit_population.py's population at
  S = 64 and 512 (``--pop-sizes``), 64 walkers, float32 compute
  (``P1_S*``, ``P2_S*``, ``P3_S*``, each ``_dev`` too), each hashed; where
  the checkout has P1's, P2's and P3's two forms, each form too, in the
  order A, B, B, A (``P1_S*_{warp,latency}{1,2}``,
  ``P2_S*_{warp,latency}{1,2}``, ``P3_S*_{warp,pair}{1,2}``, each hashed:
  equal digests, equal bits), and P1's forms and P2's warp form at the
  exact-refit CV's widths (``--pop-refit-shapes``: ``P1_R*``, ``P2_R*``);
  with ``--fits`` the walls of ``chip_smoke.py`` 28a-b
  (``fit_population`` at the example's defaults, S = 64 and 512, twice
  each, ``pop_28*``) and a profiled run's device busy time and idle share,
  28c's fit (8 transients with chains) with P2 in the rule's form and in
  the warp form, A B B A (``pop_28c_*``), and 29's exact-refit CV
  (``refit_*``: the flagship chain, ``information_criteria(refit=True)``
  twice and profiled);
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
* K3 in each of its forms at 1, 8, 64, 96, 128, 160, 192, 256, 512 and
  4096 walkers x the 149 flagship points (``K3_W*_thread_dev``,
  ``K3_W*_warp_dev``: the forms' crossover lies among them; a checkout
  with one form times it as ``thread``) and at 131072 (``K3_W131072_dev``),
  and K8 in each of its forms at 1-16384 walkers and 131072 x the 108
  points of the synthetic Ia curve (``K8_W*_staged_dev``,
  ``K8_W*_direct_dev``: the forms' crossover lies among them; a checkout
  with one form times it as ``staged``), and K5 (16/50/84) on the summary
  rows of the bolometric paths' 65 and
  256 epochs x 3200 samples (``K5_E65``, ``K5_E256``, each ``_dev``); each
  timed and hashed;
* K10 and its half-step (``K10_*``, ``K10_half_*``; where the checkout has
  them) on SN 2016bkv's 9-filter epoch under the default priors and a
  512-component KDE temperature prior, at 5 walkers (the sequential path's
  half) and 4096 (the half-step at half 5 and 2048), float32 compute, float64
  state; a segment of 300 proposals at half 5 and 32 as 600 half-step
  launches (``K10_seg_*``; ``_dev``: 600 x a half-step's device time) and,
  where the checkout has it, as one launch of K10's run form
  (``K10_run_*``), on the same draws; each timed and hashed;
* the ShockCooling (SW17) and ShockCooling4 (MSW23) kernels, where the
  checkout has them (``time_sc``): the batch log-posterior at 64 and 4096
  walkers (``--sc-logpost``: other widths, as the form rule's crossover was
  fitted) in each form in the order warp, latency, latency, warp
  (``SC_logpost_W{w}_{form}{1,2}``, ``SC4_...``; a checkout with one form
  times it as ``warp`` twice), the half-step at
  half 32, 2048 and 65536 (``--sc-halves``: other widths, as the form
  rule's crossover was fitted) in each form in the order warp, latency,
  latency, warp (``SC_half_{half}_{form}{1,2}``; a checkout with one form
  times it as ``warp`` twice), K6a at 26b's 25 rungs x 64 walkers in the
  rule's form (``SC_K6a_25x64``), K6b as 26b calls it and at the distinct
  states of ``--sc-k6b`` in each form in that order
  (``SC_K6b_25x64_{form}{1,2}``, ``SC_K6b_S{n}_{form}{1,2}``), and K6a in
  each form at the ladders of
  ``--sc-ladders`` (rungs x walkers a rung; default 25x64) in the order
  warp, latency, latency, warp (``SC_K6a_{R}x{W}_{form}{1,2}``; a checkout
  with one form times it as ``warp`` twice), each timed and hashed; with
  ``--fits`` the walls of ``chip_smoke.py`` 26a (one seed), 26b and 26c
  and each one's device busy time and idle share, K6a's kernels listed,
  the profiled window primed with spin kernels; ``--sc-only`` times these
  alone;
* hashed only, at ``chip_smoke.py``'s shapes: K3, K4 with its gradient,
  K4s, K5, K6c and K6d; and SN 2016bkv's 65 packed epochs
  (``SN2016bkv_inputs``: ``y``, ``dy``, ``nodes``, ``weights``, ``mask``,
  ``yscale``), which tells a change of the bolometric inputs from one of
  the kernels;
* with ``--fits``, the wall times of ``calculate_bolometric`` on SN
  2016bkv (``chip_smoke.py`` 13a; the sequential path of 13c at the
  defaults and at ``min_nfilt=1``, ``bol_13c_*``) and of the bolometric bench shape (13b:
  the centering and 256 x 32 x (200 + 100) with summaries, seed 1) with a
  profiled 13b run's device busy time and idle share, of
  ``lightcurve_map`` (20a), of ``lightcurve_hmc(sampler="hmc")`` (20d), of ``lightcurve_hmc``
  at its defaults in float32 and float64 (20c), of the ShockCooling3 fits
  of phase 9 (9a: 64 walkers x 200 + 200; 9b: 32768 x 300; 9c: 4096 x 300,
  seed 1), of the ShockCooling2 fits of phases 5 and 16 (5a: 64
  walkers x 200 + 200; 5b: 131072 x 300; 16a: the evidence at 4096 x 17
  rungs x 150 + 150; 16b: the PT fit, 32 x 7 rungs x 350 + 250), of the
  ShockCooling3 evidence of phase 16d (512 walkers x 17 rungs x 150 + 150,
  seed 1: ``sc3_16d_*``) and of the
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
(both forms), K4p, K6c, K6d, K4s, K3 (both forms) and K5 (registers, stack
frame, spills) comes from the build.

Usage: ``python3 tools/time_port_kernels.py [--repo PATH] [--label NAME]
[--fits] [--sc-only] [--sc-logpost 64,4096,...] [--sc-k6b 4096,...] [--sc-halves 32,2048,...]
[--sc-ladders 25x64,...]``. ``--repo`` is the
checkout whose ``lightcurve_fitting_tpu_torch`` is timed (default: this
one), so that two versions can be compared on one card, in turns: run it
on each checkout in the order A, B, B, A on the same machine. Each run builds its checkout's kernels first. The last line of the
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
                 "SC3WarpModel", "CSWarpModel",
                 "epoch_map_polish", "EpochBBModel", "replica_swap", "epoch_summary",
                 "epoch_logpost", "rung_block_terms", "bandflux", "percentile", "sifto_kernel",
                 "SEDWarpModel", "SCWarpModel", "SC4WarpModel", "pop_map_kernel")


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
    ap.add_argument("--sc-only", action="store_true",
                    help="time the SC and SC4 kernels alone (with --fits, their fits alone)")
    ap.add_argument("--sc-halves", default="32,2048,65536",
                    help="the SC and SC4 half-steps' widths, half walkers, comma-separated")
    ap.add_argument("--sc-logpost", default="64,4096",
                    help="the SC and SC4 batch log-posterior in each form at these widths, "
                         "walkers, comma-separated (the crossover's sweep: 4096,16384,...)")
    ap.add_argument("--sc-k6b", default="",
                    help="K6b over SC and SC4 in each form at these numbers of distinct "
                         "states (one copy each), comma-separated")
    ap.add_argument("--sc-ladders", default="25x64",
                    help="K6a over SC and SC4 in each form at these ladders, rungs x walkers "
                         "a rung, comma-separated (as 25x64,16x2048,17x4096,32x4096)")
    ap.add_argument("--pop-only", action="store_true",
                    help="time the population kernels P1-P3 alone (with --fits, and the "
                         "population walls 28a-c)")
    ap.add_argument("--pop-sizes", default="64,512",
                    help="the populations' sizes S for P1-P3, comma-separated")
    ap.add_argument("--pop-refit-shapes", default="5x143,1x148",
                    help="the exact-refit CV's widths for P1's forms and P2's warp form, "
                         "S x padded points, comma-separated")
    ap.add_argument("--pop-epochs", default="4,8",
                    help="a transient's epochs, lo,hi (6 points each; the example's 4,8: 24-42 "
                         "points); other than the default the rows are named P*_S{S}_E{lo}-{hi}")
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

    def half_step(name, step, x, logp, half, seed, launches=20,
                  match="stretch_half_step_kernel"):
        """Time one in-place half-step kernel (the kernels holding ``match``)
        on (x, logp) and hash one step from the same start."""
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
        times[name + "_dev"] = device_ms(lambda: step(x, logp, u_z, j, u_acc, acc), match,
                                         launches, args.repeats)

    def tempered(name, target, x, off_, sc_, seed, match="tempered_half_step_kernel", **fkw):
        """Time K6a over ``target`` on the ladder state x (R, 2, half, ndim)
        (the kernels holding ``match``; ``fkw``: the form, where the checkout
        has K6a's two), and hash one half-step and K6b's initial state from
        the same start."""
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
                                  ad_, **fkw)
        digests[name] = digest(xd_, pd_, ld_, ad_)
        acc_ = torch.zeros(shape_, dtype=torch.int32, device=dev)

        def step():
            ladder.tempered_half_step(target, x, pri_, ll_, betas_, 0, uz_, jl_, ua_, 2.0, off_,
                                      sc_, acc_, check_partners=False, **fkw)
        launches = 20 if R_ * hl > 1024 else 100
        times[name] = events_ms(step, launches, args.repeats)
        times[name + "_dev"] = device_ms(step, match, launches, args.repeats)
        return pri_, ll_

    if hasattr(chip_smoke, "pop_example"):
        time_pop(args, dev, chip_smoke, times, digests, walls)
    if args.pop_only:
        return report(args, repo, build, times, digests, info, walls, ptxas)
    if hasattr(chip_smoke, "SC_NAMES"):
        time_sc(args, dev, lc, chip_smoke, times, digests, walls, half_step, tempered)
    if args.sc_only:
        return report(args, repo, build, times, digests, info, walls, ptxas)

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
    # K3 in each form at 1-4096 walkers x the 149 points, about k3_form's
    # crossover (96-256 walkers on 132 SMs; a checkout without
    # sc3.bandflux_launch times its one form as "thread"), and at 131072 as
    # the wrapper picks
    rng_k3 = np.random.default_rng(41)   # its own stream: the draws below stay as they were
    p3w = torch.as_tensor(rng_k3.uniform(SC3_LO, SC3_UP, size=(131072, 7)), device=dev)
    T3w, R3w = ShockCooling3(lcf, device=dev)._tr_points(ll3.t, *[p3w[:, i:i + 1] for i in
                                                                (0, 1, 2, 3, 6)])
    ebv3w = torch.as_tensor(rng_k3.uniform(0.0, 1.0, size=(131072, 1)), device=dev)
    k3_forms = ("thread", "warp") if hasattr(sc3, "bandflux_launch") else ("thread",)
    for w3 in (1, 8, 64, 96, 128, 160, 192, 256, 512, 4096):
        for form in k3_forms:
            def k3(w3=w3, form=form):
                args3 = (ll3.nodes, ll3.weights, T3w[:w3], R3w[:w3])
                kw3_ = dict(k_ext=ll3.k_ext, ebv=ebv3w[:w3], band_ids=ll3.band_ids)
                if len(k3_forms) == 1:
                    return bandflux_pointwise(*args3, **kw3_)
                return sc3.bandflux_launch(form, *args3, **kw3_)
            times[f"K3_W{w3}_{form}_dev"] = device_ms(k3, "bandflux", 100 if w3 < 4096 else 20,
                                                      args.repeats)
            digests[f"K3_W{w3}_{form}"] = digest(k3())

    def k3_wide():
        return bandflux_pointwise(ll3.nodes, ll3.weights, T3w, R3w, k_ext=ll3.k_ext, ebv=ebv3w,
                                  band_ids=ll3.band_ids)
    times["K3_W131072_dev"] = device_ms(k3_wide, "bandflux", 5, args.repeats)
    digests["K3_W131072"] = digest(k3_wide())
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
    # K8 in each form about its crossover (K8_W*_{staged,direct}_dev; a
    # checkout with one form, which stages the rows, times it as staged)
    k8_forms = ("staged", "direct") if hasattr(cs, "sifto_launch") else ("staged",)
    for w8 in (1, 2, 8, 32, 128, 512, 1024, 2048, 4096, 8192, 16384, W):
        k8_w = [a[:w8] for a in k8_args]
        for form in k8_forms:
            def k8(k8_w=k8_w, form=form):
                if len(k8_forms) == 1:
                    return cs.sifto(t_c, quad_c, *k8_w)
                return cs.sifto_launch(form, t_c, quad_c, *k8_w)
            times[f"K8_W{w8}_{form}_dev"] = device_ms(k8, "sifto_kernel",
                                                      100 if w8 <= 4096 else 20, args.repeats)
            digests[f"K8_W{w8}_{form}_dev"] = digest(k8())
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
        # K5 on those summary rows (Em x 4 rows of 3200 samples: 13a's and
        # 13b's widths), 16/50/84

        def k5(rows_m=k4s().reshape(Em * 4, -1).contiguous()):
            return kq.percentile_rows(rows_m, [16.0, 50.0, 84.0])
        times[f"K5_E{Em}"] = events_ms(k5, 20, args.repeats)
        times[f"K5_E{Em}_dev"] = device_ms(k5, "percentile", 20, args.repeats)
        digests[f"K5_E{Em}"] = digest(k5())

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
    digests["SN2016bkv_inputs"] = digest(*(shapes4[65][k] for k in ("y", "dy", "nodes",
                                                                     "weights", "mask",
                                                                     "yscale")))
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

    # K10 and its half-step (the sequential bolometric path), where the
    # checkout has them: on SN 2016bkv's 9-filter epoch (11 points), float32
    # compute, float64 state, under the default priors and a 512-component
    # KDE temperature prior, at the path's width (5 walkers) and 4096
    if hasattr(kernels, "sed"):
        from lightcurve_fitting_tpu_torch.bolometric import SEDLogPosterior
        from lightcurve_fitting_tpu_torch.kernels import sed
        groups = chip_smoke.sn2016bkv_seds()
        nine = next(ep for ep in groups if chip_smoke.n_detected(ep) == 9)
        kdes = chip_smoke.sed_kdes()
        for which in ("default", "kde512"):
            lps = SEDLogPosterior(nine, chip_smoke.sed_priors(which, False, kdes),
                                  META["redshift"], device=dev)
            for W in (5, 4096):
                qs = chip_smoke.sed_states(np.random.default_rng(W), 2, W, dev)
                name = f"K10_{which}_W{W}"

                def k10(lps=lps, qs=qs):
                    return sed.log_posterior(lps, qs)
                times[name] = events_ms(k10, 20, args.repeats)
                times[name + "_dev"] = device_ms(k10, "logpost_warp_kernel", 20, args.repeats)
                digests[name] = digest(k10())
                half = W // 2 if W > 5 else 5
                x10 = torch.as_tensor(np.abs(np.array([12.0, 3.0]) * (
                    1 + 0.02 * np.random.default_rng(half).normal(size=(2, half, 2)))),
                    device=dev).contiguous()
                l10 = sed.log_posterior(lps, x10.reshape(-1, 2)).reshape(2, half)
                g.manual_seed(half)
                u_z = torch.rand(half, generator=g, device=dev, dtype=torch.float64)
                j = torch.randint(0, half, (half,), generator=g, device=dev)
                u_acc = torch.rand(half, generator=g, device=dev, dtype=torch.float64)
                xd, ld = x10.clone(), l10.clone()
                ad = torch.zeros((2, half), dtype=torch.int32, device=dev)
                for h in (0, 1):
                    sed.stretch_half_step(lps, xd, ld, h, u_z, j, u_acc, 2.0, n_accept=ad)
                name = f"K10_half_{which}_{half}"
                digests[name] = digest(xd, ld, ad)

                def k10h(lps=lps, x10=x10, l10=l10, u_z=u_z, j=j, u_acc=u_acc, ad=ad):
                    sed.stretch_half_step(lps, x10, l10, 0, u_z, j, u_acc, 2.0, n_accept=ad,
                                          check_partners=False)
                times[name] = events_ms(k10h, 20, args.repeats)
                times[name + "_dev"] = device_ms(k10h, "stretch_half_step_kernel", 20,
                                                 args.repeats)
            # a segment of 300 proposals at the path's half (5) and the run
            # form's largest (32): the 600 half-step launches (K10_seg_*, every
            # checkout) and, where the checkout has it, the run form's one
            # launch (K10_run_*) on the same draws, each hashed
            for half in (5, 32):
                xs0 = torch.as_tensor(np.abs(np.array([10.7, 3.6]) * (
                    1 + 0.02 * np.random.default_rng(half).normal(size=(2, half, 2)))),
                    device=dev).contiguous()
                ls0 = sed.log_posterior(lps, xs0.reshape(-1, 2)).reshape(2, half)
                g.manual_seed(100 + half)
                dz = torch.rand((300, 2, half), generator=g, device=dev, dtype=torch.float64)
                dj = torch.randint(0, half, (300, 2, half), generator=g, device=dev)
                du = torch.rand((300, 2, half), generator=g, device=dev, dtype=torch.float64)

                def seg_state():
                    return (xs0.clone(), ls0.clone(),
                            torch.zeros((2, half), dtype=torch.int32, device=dev),
                            torch.empty((300, 2, half, 2), dtype=torch.float64, device=dev),
                            torch.empty((300, 2, half), dtype=torch.float64, device=dev))
                st = seg_state()

                def seg(st=st, dz=dz, dj=dj, du=du, lps=lps):
                    for s_ in range(300):
                        for h in (0, 1):
                            sed.stretch_half_step(lps, st[0], st[1], h, dz[s_, h], dj[s_, h],
                                                  du[s_, h], 2.0, None, None, st[3][s_],
                                                  st[4][s_], st[2], check_partners=False)
                name = f"K10_seg_{which}_{half}"
                st0 = seg_state()
                seg(st0)
                digests[name] = digest(*st0)
                times[name] = events_ms(seg, 1, args.repeats)
                times[name + "_dev"] = [600 * v for v in device_ms(
                    lambda: sed.stretch_half_step(lps, st[0], st[1], 0, dz[0, 0], dj[0, 0],
                                                  du[0, 0], 2.0, n_accept=st[2],
                                                  check_partners=False),
                    "stretch_half_step_kernel", 20, args.repeats)]
                if hasattr(sed, "stretch_run"):
                    def run(st=st, dz=dz, dj=dj, du=du, lps=lps):
                        sed.stretch_run(lps, *st[:2], dz, dj, du, 2.0, None, None, st[3], st[4],
                                        st[2], check_partners=False)
                    name = f"K10_run_{which}_{half}"
                    st0 = seg_state()
                    run(st0)
                    digests[name] = digest(*st0)
                    times[name] = events_ms(run, 5, args.repeats)
                    times[name + "_dev"] = device_ms(run, "stretch_run_kernel", 5, args.repeats)

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

        # (13c) the sequential path, where the checkout has it:
        # calculate_bolometric(batch_mode=False) at the defaults and at
        # min_nfilt=1 (KDE chaining), seed 7
        if hasattr(kernels, "sed"):
            for label, kw13 in (("defaults", {}), ("min_nfilt_1", {"min_nfilt": 1})):
                for rep in range(2):
                    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
                        warnings.simplefilter("ignore")
                        walls[f"bol_13c_{label}_{rep}"], _ = wall(lambda: calculate_bolometric(
                            lc_full.copy(), batch_mode=False, save_corners=False, seed=7,
                            **kw13))

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
        # (16d) lightcurve_evidence on ShockCooling3 at 512 walkers x 16 rungs +
        # beta = 1 x 150 + 150, seed 1
        for rep in range(2):
            walls[f"sc3_16d_{rep}"], ev = wall(lambda: lightcurve_evidence(
                lc, ShockCooling3(lc), chip_smoke.sc3_priors(), p_lo=SC3_LO, p_up=SC3_UP,
                nwalkers=512, n_rungs=chip_smoke.EV_RUNGS, nsteps=chip_smoke.EV_STEPS,
                nsteps_burnin=chip_smoke.EV_BURNIN, seed=1, quiet=True))
        walls["sc3_16d_log_z"] = [float(ev[0]), float(ev[1])]
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

    report(args, repo, build, times, digests, info, walls, ptxas)


def report(args, repo, build, times, digests, info, walls, ptxas):
    """Print every time, digest, wall and ptxas line (and with ``--sass``
    the SASS hashes), then the one JSON line."""
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


def time_pop(args, dev, chip_smoke, times, digests, walls):
    """P1, P2 and P3 on examples/fit_population.py's population at each S of
    ``--pop-sizes`` (float32 compute, the rescaled float32 state of 64
    walkers a transient; P3 16 starts x 400 steps): ``P1_S{S}`` on every
    walker, ``P2_S{S}`` one half-step writing the chain slot (as production
    does), ``P3_S{S}`` the whole ascent, each with ``_dev`` (the profiler's
    device time) and a digest of one call from the same start."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    epochs = tuple(int(v) for v in args.pop_epochs.split(","))
    for S in [int(v) for v in args.pop_sizes.split(",")]:
        if epochs == (4, 8):
            lcs, models, _ = chip_smoke.pop_example(S, dev)
        else:
            lcs, models, _ = chip_smoke.pop_example(S, dev, epochs=epochs)
        tag = f"S{S}" if epochs == (4, 8) else f"S{S}_E{epochs[0]}-{epochs[1]}"
        priors, lo, up = chip_smoke.pop_priors()
        pp = PopulationPosterior(pack_population(models, lcs, False, dev), models[0], priors)
        q, off, sc = chip_smoke.pop_state(pp, lo, up, 64, 0, dev)
        x = q.reshape(S, 2, 32, 3).contiguous()
        logp = kpop.log_posterior(pp, q, off, sc).reshape(S, 2, 32)
        digests[f"P1_{tag}"] = digest(logp)
        g = torch.Generator(device=dev)
        g.manual_seed(S)
        shape = (S, 2, 32)
        u_z = torch.rand(shape, generator=g, device=dev)
        j = torch.randint(0, 32, shape, generator=g, device=dev)
        u_acc = torch.rand(shape, generator=g, device=dev)
        acc = torch.zeros(shape, dtype=torch.int32, device=dev)
        cx, cl = torch.empty_like(x), torch.empty(shape, dtype=torch.float64, device=dev)
        xd, ld = x.clone(), logp.clone()
        kpop.stretch_half_step(pp, xd, ld, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc)
        digests[f"P2_{tag}"] = digest(xd, ld, acc)
        x_0, l_0 = x.clone(), logp.clone()   # the start of each form's hashed step
        bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
        x_st = np.random.default_rng(S).uniform(lo, up, size=(S, 16, 3))
        u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
        digests[f"P3_{tag}"] = digest(*kpop.map_ascent(pp, u0, bounds, 400))

        def p2(**fkw):
            kpop.stretch_half_step(pp, x, logp, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                                   check_partners=False, **fkw)
        for name, fn, match, launches in (
                (f"P1_{tag}", lambda: kpop.log_posterior(pp, q, off, sc), "logpost_", 20),
                (f"P2_{tag}", p2, "stretch_half_step", 20),
                (f"P3_{tag}", lambda: kpop.map_ascent(pp, u0, bounds, 400), "pop_map_kernel", 1)):
            times[name] = events_ms(fn, launches, args.repeats)
            times[name + "_dev"] = device_ms(fn, match, launches, args.repeats)
        if "form" not in kpop.stretch_half_step.__code__.co_varnames:
            continue
        if "form" in kpop.log_posterior.__code__.co_varnames:
            time_p1_forms(args, kpop, pp, q, off, sc, tag, times, digests)
        for key, forms, step in (("P2", ("warp", "latency"), lambda f: p2(form=f)),
                                 ("P3", ("warp", "pair")[:1 + (pp.bb_coeffs.shape[1]
                                                                <= kpop.MAP_PAIR_MAX_POINTS)],
                                  lambda f: kpop.map_ascent(pp, u0, bounds, 400, form=f))):
            for k, form in enumerate(forms + forms[::-1]):
                name = f"{key}_{tag}_{form}{1 + (k >= len(forms))}"
                if key == "P2":
                    xd, ld = x_0.clone(), l_0.clone()
                    ad = torch.zeros(shape, dtype=torch.int32, device=dev)
                    kpop.stretch_half_step(pp, xd, ld, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, ad,
                                           form=form)
                    digests[name] = digest(xd, ld, ad)
                else:
                    digests[name] = digest(*step(form))
                n = 20 if key == "P2" else 1
                times[name] = events_ms(lambda: step(form), n, args.repeats)
                times[name + "_dev"] = device_ms(lambda: step(form),
                                                 "stretch_half_step" if key == "P2"
                                                 else "pop_map_kernel", n, args.repeats)
    if hasattr(chip_smoke, "POP_REFIT_SHAPES"):
        time_pop_refit_shapes(args, dev, chip_smoke, times, digests)
    if args.fits:
        time_pop_fits(args, dev, chip_smoke, walls)
        if hasattr(chip_smoke, "REFIT_CHAIN"):
            time_refit(dev, chip_smoke, walls)


def time_refit(dev, chip_smoke, walls):
    """The wall of ``chip_smoke.py`` 29's exact-refit CV: the flagship chain
    (``chip_smoke.REFIT_CHAIN``, ``refit_chain``, s), then
    ``information_criteria(group_by="filter", refit=True)`` at
    ``_exact_cv_elpd``'s defaults twice (``refit_ic_{rep}``, s) and a
    profiled run's busy time, idle share and population kernels' device
    time (``refit_ic_profiled``)."""
    import torch
    from lightcurve_fitting_tpu_torch import fitting
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    lc = chip_smoke.flagship_lc()
    model = ShockCooling2(lc, device=dev)
    priors = chip_smoke.flagship_priors()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain = fitting.lightcurve_mcmc(lc, model, priors=priors, p_lo=chip_smoke.REFIT_WINDOW[0],
                                    p_up=chip_smoke.REFIT_WINDOW[1], quiet=True, device=dev,
                                    **chip_smoke.REFIT_CHAIN)
    torch.cuda.synchronize()
    walls["refit_chain"] = time.perf_counter() - t0

    def ic():
        return fitting.information_criteria(lc, model, chain.flatchain, group_by="filter",
                                            refit=True, priors=priors, seed=0, quiet=True,
                                            device=dev)
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ic()
        torch.cuda.synchronize()
        walls[f"refit_ic_{rep}"] = time.perf_counter() - t0
    walls["refit_flagged"] = {k: len(r["refit"]["labels"]) + r["refit"]["n_failed"]
                              for k, r in (("points", out), ("bands", out["logo"]))
                              if "refit" in r}
    wall_p, busy, top = fit_busy(ic, match="PopSC2WarpModel")
    walls["refit_ic_profiled"] = {"wall": wall_p, "busy": busy, "idle_share": 1 - busy / wall_p,
                                  "top_kernels_ms": top}


def time_p1_forms(args, kpop, pp, q, off, sc, tag, times, digests):
    """P1 in each form on the states q, in the order warp, latency, latency,
    warp (``P1_{tag}_{form}{1,2}``, each ``_dev`` too, each hashed: equal
    digests, equal bits)."""
    forms = ("warp", "latency")
    for k, form in enumerate(forms + forms[::-1]):
        name = f"P1_{tag}_{form}{1 + (k >= len(forms))}"

        def p1(form=form):
            return kpop.log_posterior(pp, q, off, sc, form=form)
        digests[name] = digest(p1())
        times[name] = events_ms(p1, 20, args.repeats)
        times[name + "_dev"] = device_ms(p1, "logpost_", 20, args.repeats)


def time_pop_refit_shapes(args, dev, chip_smoke, times, digests):
    """P1 in each form (:func:`time_p1_forms`) and P2's warp form (one
    half-step with the chain slot; its latency form takes at most 128
    points) at the exact-refit CV's widths, ``--pop-refit-shapes`` (S x
    padded points, 64 walkers, float32 compute, t_exp fitted as the
    flagship's refits fit it: ``chip_smoke.pop_example``'s MJD-scale curves
    cut to so many points): ``P1_R{S}x{N}_*``, ``P2_R{S}x{N}_warp``, each
    with ``_dev`` and a digest."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    for shape in args.pop_refit_shapes.split(","):
        S, n = (int(v) for v in shape.split("x"))
        tag = f"R{S}x{n}"
        lcs, models, _ = chip_smoke.pop_example(S, dev, True, chip_smoke.POP_REFIT_EPOCHS, n)
        priors, lo, up = chip_smoke.pop_priors(mjd=True)
        pp = PopulationPosterior(pack_population(models, lcs, False, dev), models[0], priors)
        q, off, sc = chip_smoke.pop_state(pp, lo, up, 64, 0, dev)
        time_p1_forms(args, kpop, pp, q, off, sc, tag, times, digests)
        x = q.reshape(S, 2, 32, -1).contiguous()
        logp = kpop.log_posterior(pp, q, off, sc).reshape(S, 2, 32)
        g = torch.Generator(device=dev)
        g.manual_seed(S)
        shape = (S, 2, 32)
        u_z = torch.rand(shape, generator=g, device=dev)
        j = torch.randint(0, 32, shape, generator=g, device=dev)
        u_acc = torch.rand(shape, generator=g, device=dev)
        acc = torch.zeros(shape, dtype=torch.int32, device=dev)
        cx, cl = torch.empty_like(x), torch.empty(shape, dtype=torch.float64, device=dev)
        xd, ld = x.clone(), logp.clone()
        kpop.stretch_half_step(pp, xd, ld, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                               form="warp")
        digests[f"P2_{tag}_warp"] = digest(xd, ld, acc)

        def p2():
            kpop.stretch_half_step(pp, x, logp, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                                   check_partners=False, form="warp")
        times[f"P2_{tag}_warp"] = events_ms(p2, 20, args.repeats)
        times[f"P2_{tag}_warp_dev"] = device_ms(p2, "stretch_half_step", 20, args.repeats)


def time_pop_fits(args, dev, chip_smoke, walls):
    """The walls of ``chip_smoke.py`` 28a-b: ``fit_population`` at
    examples/fit_population.py's defaults (64 walkers, 100 + 500 steps,
    init="map" with 16 starts x 400 steps, seed 1, summaries, no chains) on
    S = 64 and 512 transients, twice each (``pop_28{a,b}_{rep}``, s), and a
    profiled run's device busy time, idle share and the population kernels'
    device time (``fit_busy``; ``pop_28*_profiled``); then 28c's
    (:func:`time_pop_28c`)."""
    import torch
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    for S, tag in ((64, "28a"), (512, "28b")):
        lcs, models, _ = chip_smoke.pop_example(S, dev)
        priors = chip_smoke.pop_priors()[0]

        def fit():
            return fit_population(models, lcs, priors, p_lo=chip_smoke.POP_LO,
                                  p_up=chip_smoke.POP_UP, nwalkers=chip_smoke.POP_WALKERS,
                                  nsteps=chip_smoke.POP_STEPS,
                                  nsteps_burnin=chip_smoke.POP_BURNIN, seed=1, init="map",
                                  summaries=True, return_chains=False)
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, acc, _ = fit()
            torch.cuda.synchronize()
            walls[f"pop_{tag}_{rep}"] = time.perf_counter() - t0
        walls[f"pop_{tag}_acceptance"] = float(np.mean(acc))
        # (P3 is among the four kernels of most device time)
        wall_p, busy, top = fit_busy(fit, match="PopSC2WarpModel")
        walls[f"pop_{tag}_profiled"] = {"wall": wall_p, "busy": busy,
                                        "idle_share": 1 - busy / wall_p, "top_kernels_ms": top}
    time_pop_28c(dev, chip_smoke, walls)


def time_pop_28c(dev, chip_smoke, walls):
    """The fit of ``chip_smoke.py`` 28c (``fit_population`` on the example's
    first POP_DIAG transients with chains, init="map", seed 1) with P2 in
    the form ``kernels/pop.py::half_form`` picks (``rule``) and in the warp
    form (``warp``; a checkout without the rule times its one form as
    ``rule``), in the order rule, warp, warp, rule: per slot two walls
    (``pop_28c_{form}{1,2}_{rep}``, s) and a profiled run's busy time,
    idle share and population kernels' device time
    (``pop_28c_{form}{1,2}_profiled``); the mean acceptance per form."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    lcs, models, _ = chip_smoke.pop_example(chip_smoke.POP_DIAG, dev)
    priors = chip_smoke.pop_priors()[0]
    rule = getattr(kpop, "half_form", None)
    forms = ("rule", "warp") if rule else ("rule",)

    def fit():
        return fit_population(models, lcs, priors, p_lo=chip_smoke.POP_LO,
                              p_up=chip_smoke.POP_UP, nwalkers=chip_smoke.POP_WALKERS,
                              nsteps=chip_smoke.POP_STEPS, nsteps_burnin=chip_smoke.POP_BURNIN,
                              seed=1, init="map")
    for k, form in enumerate(forms + forms[::-1]):
        slot = f"pop_28c_{form}{1 + (k >= len(forms))}"
        if form == "warp":
            kpop.half_form = lambda *a: "warp"
        try:
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, acc = fit()
                torch.cuda.synchronize()
                walls[f"{slot}_{rep}"] = time.perf_counter() - t0
            walls[f"pop_28c_{form}_acceptance"] = float(np.mean(acc))
            wall_p, busy, top = fit_busy(fit, match="PopSC2WarpModel")
        finally:
            if rule:
                kpop.half_form = rule
        walls[f"{slot}_profiled"] = {"wall": wall_p, "busy": busy,
                                     "idle_share": 1 - busy / wall_p, "top_kernels_ms": top}


def fit_busy(fn, primes=256, match=None):
    """(wall s, device busy s, the four kernels of most device time and,
    with ``match``, every kernel whose name holds it: {name: [launches,
    ms]}) of one fn() under the profiler (the device's activity alone), the
    window first primed with ``primes`` spin kernels (the profiler drops a
    window's first records after long traces; the spins are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(primes):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and "spin" not in e.key]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:4]
    top += [e for e in evs if match is not None and match in e.key and e not in top]
    return wall, busy, {e.key.split("(")[0][:90]: [e.count, e.self_device_time_total / 1e3]
                        for e in top}


def time_sc(args, dev, lc, chip_smoke, times, digests, walls, half_step, tempered):
    """The ShockCooling (SW17) and ShockCooling4 (MSW23) kernels at
    ``chip_smoke.py`` phase 25-26's shapes, float32 compute: the batch
    log-posterior at 64 and 4096 walkers of the window in the sampler's
    float32 rescaled state (the fits' initial states; or the widths of
    ``--sc-logpost``) in each form, in the order warp, latency,
    latency, warp (``SC_logpost_W{w}_{form}{1,2}``, ``SC4_...``; a checkout
    with one form times it as ``warp`` twice); the half-step per half-step of half
    32 (26c), 2048 (26a) and 65536 (or the widths of ``--sc-halves``) in
    each form, in the order warp, latency, latency, warp
    (``SC_half_{half}_{form}{1,2}``; a checkout with one form times it as
    ``warp`` twice); K6a per ladder half-step of 25
    rungs x 64 walkers (26b) in the rule's form (``SC_K6a_25x64``) and K6b
    as 26b calls it, one set of 64 starting states written to the 25 rungs,
    in each form in that order (``SC_K6b_25x64_{form}{1,2}``), and at the
    distinct states of ``--sc-k6b``, one copy each
    (``SC_K6b_S{n}_{form}{1,2}``); K6a in each form, in the order
    warp, latency, latency, warp, at the ladders of ``--sc-ladders``
    (``SC_K6a_{R}x{W}_{form}{1,2}``: the form rule's crossover); each timed
    and hashed. With ``--fits``: the walls of
    26a (``lightcurve_mcmc`` 4096 x 300 from the window, seed 1, twice),
    26b (``compare_models``, seed 7) and 26c (``compare_models_loo``, seed
    7), and each one's device busy time and idle share (``fit_busy``; K6a's
    kernels among the listed)."""
    import torch
    from lightcurve_fitting_tpu_torch.fitting import (_state_rescaling, compare_models,
                                                      compare_models_loo, lightcurve_mcmc,
                                                      make_log_posterior)
    from lightcurve_fitting_tpu_torch.kernels import ladder
    from lightcurve_fitting_tpu_torch.kernels import sc as ksc
    two_forms = "form" in ksc.half_step_launch.__code__.co_varnames
    two_tempered = "form" in ladder.tempered_half_step.__code__.co_varnames
    two_logpost = "form" in ksc.logpost_launch.__code__.co_varnames
    two_init = "form" in ladder.ladder_init.__code__.co_varnames

    def by_form(key, call, match, two, launches=20):
        """Time call({"form": form}) (call({}) in a checkout with one form)
        in the order warp, latency, latency, warp (warp twice with one form)
        as ``{key}_{form}{1,2}``, by events and by the device time of the
        kernels holding ``match`` (``_dev``), each run's outputs hashed."""
        order = ("warp", "latency", "latency", "warp") if two else ("warp", "warp")
        for k, form in enumerate(order):
            name = f"{key}_{form}{1 + (k >= len(order) // 2)}"
            fkw = {"form": form} if two else {}
            out = call(fkw)
            digests[name] = digest(*(out if isinstance(out, tuple) else (out,)))
            times[name] = events_ms(lambda: call(fkw), launches, args.repeats)
            times[name + "_dev"] = device_ms(lambda: call(fkw), match, launches, args.repeats)
    lo, up = chip_smoke.SC_LO, chip_smoke.SC_UP
    R, LW = chip_smoke.SC_LADDER
    for name in chip_smoke.SC_NAMES:
        prefix = chip_smoke.SC_PREFIX[name]
        tag = prefix.upper()
        lps = make_log_posterior(chip_smoke.sc_model(name, lc), lc, chip_smoke.sc_priors(),
                                 device=dev)
        kw = _state_rescaling(torch.float32, lo, up, dev)
        off, sc = kw["param_offset"], kw["param_scale"]
        for w in map(int, args.sc_logpost.split(",")):
            # a fit's initial state: the window's walkers, the sampler's
            # float32 rescaled state
            q = (np.random.default_rng(w).uniform(lo, up, size=(w, 5)) - off) / sc
            q = torch.as_tensor(q, device=dev).float()
            by_form(f"{tag}_logpost_W{w}", lambda fkw, q=q: ksc.logpost_launch(
                prefix, lps, q, off, sc, **fkw), "logpost_", two_logpost)
        for h2 in map(int, args.sc_halves.split(",")):
            q = (np.random.default_rng(h2).uniform(lo, up, size=(2 * h2, 5)) - off) / sc
            x = torch.as_tensor(q.reshape(2, h2, 5), device=dev).float().contiguous()
            logp = ksc.logpost_launch(prefix, lps, x.reshape(-1, 5), off, sc).reshape(2, h2)
            order = ("warp", "latency", "latency", "warp") if two_forms else ("warp", "warp")
            for k, form in enumerate(order):
                fkw = {"form": form} if two_forms else {}
                half_step(f"{tag}_half_{h2}_{form}{1 + (k >= len(order) // 2)}",
                          lambda x_, l_, uz, j_, ua, a_, fkw=fkw: ksc.half_step_launch(
                              prefix, lps, x_, l_, 0, uz, j_, ua, 2.0, off, sc, n_accept=a_,
                              check_partners=False, **fkw),
                          x.clone(), logp.clone(), h2, 1, launches=20 if h2 > 2048 else 100,
                          match="stretch_half_step")
        kwl = _state_rescaling("auto", lo, up, dev)
        offl, scl = kwl["param_offset"], kwl["param_scale"]
        q = (np.random.default_rng(R).uniform(lo, up, size=(R * LW, 5)) - offl) / scl
        xl = torch.as_tensor(q.reshape(R, 2, LW // 2, 5), device=dev).to(kwl["dtype"])
        tempered(f"{tag}_K6a_{R}x{LW}", lps, xl.contiguous(), offl, scl, 1,
                 match="tempered_half_step")
        for R2, W2 in (map(int, s.split("x")) for s in args.sc_ladders.split(",")):
            q2 = (np.random.default_rng(R2 * W2).uniform(lo, up, size=(R2 * W2, 5)) - offl) / scl
            x2 = torch.as_tensor(q2.reshape(R2, 2, W2 // 2, 5), device=dev).to(kwl["dtype"])
            order = ("warp", "latency", "latency", "warp") if two_tempered else ("warp", "warp")
            for k, form in enumerate(order):
                fkw = {"form": form} if two_tempered else {}
                tempered(f"{tag}_K6a_{R2}x{W2}_{form}{1 + (k >= len(order) // 2)}", lps,
                         x2.clone(), offl, scl, 1, match="tempered_half_step", **fkw)
        x1 = xl[:1].contiguous()
        by_form(f"{tag}_K6b_{R}x{LW}", lambda fkw, x1=x1: ladder.ladder_init(
            lps, x1, offl, scl, copies=R, **fkw), "ladder_init", two_init, launches=100)
        for n in (map(int, args.sc_k6b.split(",")) if args.sc_k6b else ()):
            qn = (np.random.default_rng(n).uniform(lo, up, size=(n, 5)) - offl) / scl
            xn = torch.as_tensor(qn.reshape(1, 2, n // 2, 5), device=dev).to(kwl["dtype"])
            by_form(f"{tag}_K6b_S{n}", lambda fkw, xn=xn.contiguous(): ladder.ladder_init(
                lps, xn, offl, scl, **fkw), "ladder_init", two_init)
    if not args.fits:
        return
    sink = contextlib.redirect_stdout(io.StringIO())
    kw = dict(p_lo=lo, p_up=up, seed=7, quiet=True)
    models = [chip_smoke.sc_model(n, lc) for n in chip_smoke.SC_NAMES]
    runs = {f"{chip_smoke.SC_PREFIX[n]}_26a": lambda n=n: lightcurve_mcmc(
        lc, chip_smoke.sc_model(n, lc), chip_smoke.sc_priors(), nwalkers=chip_smoke.SC_FIT_WALKERS,
        nsteps=300, nsteps_burnin=0, p_lo=lo, p_up=up, seed=1, quiet=True)
        for n in chip_smoke.SC_NAMES}
    runs["sc_26b"] = lambda: compare_models(
        lc, models, chip_smoke.sc_priors(), labels=list(chip_smoke.SC_NAMES), nwalkers=64,
        n_rungs=24, nsteps=400, nsteps_burnin=600, **kw)
    runs["sc_26c"] = lambda: compare_models_loo(
        lc, models, chip_smoke.sc_priors(), labels=list(chip_smoke.SC_NAMES), nwalkers=64,
        nsteps=500, nsteps_burnin=500, **kw)
    with sink:
        for key, fn in runs.items():
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[f"{key}_{rep}"] = time.perf_counter() - t0
            wall_p, busy, top = fit_busy(fn, match="tempered_half_step")
            walls[f"{key}_profiled"] = {"wall": wall_p, "busy": busy,
                                        "idle_share": 1 - busy / wall_p, "top_kernels_ms": top}


if __name__ == "__main__":
    main()
