#!/usr/bin/env python3
"""Drive lightcurve_fitting_tpu_torch's main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc (``/usr/local/cuda`` or ``CUDA_HOME``) and PyTorch built for CUDA,
and imports nothing of JAX. Phases, each printing one line (any failure
raises and the script exits non-zero):

1. environment: torch/CUDA versions, the card, its power limit;
2. build: nvcc compiles the kernels from ``kernels/csrc/``; the
   block-per-chain kernels (K9, K7h, K7's block form), K4p, the epoch
   half-step, K4's values in both forms, the SC3 and CS log-posteriors, K1,
   K6b, K6c, K6d and K4s must have no stack frame and no spills (ptxas);
3. K1 (a warp per walker, the half-step's form) against its plain PyTorch
   version at 131072 walkers on the flagship (SN 2016bkv, ShockCooling2),
   float32 (<= 1e-5 |ll|, same -inf set) and float64 (<= 1e-10 |ll|),
   including t < t_exp under a widened t_0 prior; at the fits' widths (64,
   4096, 131072) the same values bit for bit, each timed (events and the
   profiler's device time) and the profiler showing the warp kernel ran;
   at the states two K2 half-steps accepted, K2's stored values bit for
   bit;
4. K2 (a warp per walker) against the plain half-step on the same state and
   draws at half 65536, 16384 and 32 (the fits' widths), float32 and
   float64: accept flags agree except at near-ties, and where they agree the
   new states are equal and the new log-posteriors within 1e-5 (1e-10) of
   the term scale; each width timed (events and the profiler's device
   time); how many proposals' log-posteriors (u_acc = 0) differ from K7's
   value at the same parameters;
5. the public ``fitting.lightcurve_mcmc``: (a) the reference-default
   64-walker fit, (b) 131072 walkers x 300 steps from the init window, whose
   mean acceptance must be 0.4685 +- 0.01; the launch counters show both ran
   through K1 and K2; (c) 4096 walkers x 300 steps at seeds 1-8 in float32
   and float64, the mean acceptance and its standard error against the JAX
   package's on the CPU at the same seeds and precision (within 4 combined
   standard errors);
6. K3 (``bandflux_kernel``) against ``bandflux_pointwise_plain`` at 131072
   walkers x the 149 flagship points with E(B-V) per walker in [0, 1] and
   t < t_exp walkers, float32 (<= 1e-5 relative per point) and float64
   (<= 1e-12);
7. the fused ShockCooling3 log-posterior (a warp per walker) against
   ``forward_plain`` at 131072 walkers (1% outside the priors, a set with
   t < t_exp): float32 <= 1e-5 |ll|, float64 <= 1e-10 |ll|, identical -inf
   sets; at the fits' widths (64, 4096, 32768) the same values bit for bit,
   each width timed (events and the profiler's device time) and the
   profiler showing the warp kernel ran;
8. the SC3 half-step (a warp per walker) against the plain half-step, as
   in 4, at half 65536 and at the fits' widths, half 16384 and 32, each
   timed;
9. the ShockCooling3 fit of SN 2016bkv through ``fitting.lightcurve_mcmc``:
   (a) 64 walkers x 200+200 steps, (b) 32768 walkers x 300 steps from the
   init window, whose mean acceptance must be within 0.01 of the JAX
   package's float64 value, and ``ShockCooling3.evaluate`` on the card at
   the medians (chi2/dof printed), and a profiled run's time split (the
   half-steps, the initial state); the
   launch counters, reset before this path, show it ran through K3 and both
   SC3 kernels (1400 half-steps);
   (c) 4096 walkers x 300 steps at seeds 1-8, the mean acceptance and its
   standard error against the JAX package's at the same seeds (within 4
   combined standard errors);
10. K4 (the per-epoch blackbody log-posterior and its gradient) against its
    plain version at the bench shape (256 epochs x 6 bands, 512 candidates)
    and on the 65 SN 2016bkv epochs of up to 9 bands at 32 walkers, with
    parameters outside the priors and T <= 0: float32 <= 1e-5 and float64
    <= 1e-10 of |ll - c| + |c| (c the epoch's log_norm), identical -inf
    sets, the gradient within 1e-4 (float32) and 1e-9 (float64) of its
    per-band terms' summed magnitude; K4's values (the epoch half-step's
    warp form, and a thread per vector where the vectors hide the longest
    vector's walk, ``kernels/epoch_bb.py::k4_form``) the same bits in both forms and at
    widths 32 and 512, and at the states two epoch half-steps accepted (256
    x 32 float32 walkers, with and without the scatter) the half-step's
    stored values bit for bit, float32 and float64; the values timed at
    the cloud (256 x 512) and the initial state (256 x 32) in each form;
    K4 with the gradient timed at 256 x
    8, the width of the parent's 300 Adam launches; K4p, the Adam polish of
    the MAP centering in one launch, against ``map_polish_plain`` on the
    card at the bench shape (256 epochs x 8 starts x 300 steps), float32
    and float64: the same alive set, centers within POLISH_REL (a near-tie
    where the two keep different starts), each timed, with its bound;
11. the epoch half-step (a warp per walker; h = 0, 1; 256 epochs x 16)
    against the plain one under shared draws, float32 and float64: flags
    agree except near-ties, new states bit-equal where they agree, new
    log-posteriors within 1e-5 (1e-10) of ``EpochPosterior.term_scales``;
    the profiler shows the warp form ran;
12. K4s and K5 against their plain versions at the bench shape (256 x 3200
    samples): K4s's integral <= 1e-5 relative without a cutoff and with one
    at 600 THz, T, R and (R T^2)^2 equal; K4s's float32 Planck term on a
    one-node grid against 1 / expm1 at its own rounded exponent, x from
    0.05 to 80, in ulp (within 3 / (1 - exp(-x)) + 3 on the special-function
    unit, 3 below x = 0.25); K5's percentiles bit-equal, ``torch.quantile``
    timed beside K5;
13. the bolometric main path: (a) ``calculate_bolometric(batch_mode=True,
    save_corners=False, nwalkers=32, seed=7)`` on the full SN 2016bkv light
    curve (65 rows); (b) the bench shape (256 epochs x 32 walkers x 200 +
    100 steps) through ``batched_map_centers`` and
    ``batched_blackbody_mcmc(summaries=..., return_chains=False)``, epochs/s
    over 5 runs, mean acceptance within 0.02 of the JAX package's float64
    CPU value, and over seeds 1-8 within 4 combined standard errors of the
    JAX package's at the same seeds, a profiled run's time split; the
    launch counters, reset before (a), show it ran through K4, K4p (once a
    centering; K4's gradient form not at all), the epoch half-step, K4s
    and K5;
14. K6a, the tempered half-step (h = 0, 1), against its plain version on the
    ShockCooling2 ladders (a warp per walker) of the evidence bench shape
    (17 rungs x 4096 walkers) and of the PT fit (7 x 32), float32 and
    float64 compute on the float32 rescaled state, each timed, and on a
    ShockCooling3 ladder of 17 x 512: accept flags agree except near-ties,
    new states bit-equal where they agree, log pi and log L within K1's
    tolerances; the proposals' log pi + log L against K7's value as in 4;
15. K6b, the ladder's initial state (a warp per state), against the plain
    split of the log-posterior, float32 and float64: each rung its own
    states (17 x 4096, 1% outside the priors), and as the ladders call it,
    one set of states written to every rung, over each instantiation at
    its ladders' shapes (SC2 17 x 4096, 7 x 32, 17 x 32; CS2 17 x 4096, 7 x
    64; SC3 17 x 512), each timed, the profiler showing the warp kernel;
    K6b at the states K6a left gives K6a's stored values bit for bit (14,
    23); K6c, the replica exchange, bit-equal to its plain version at
    the ladders' shapes (17 rungs x 4096 and x 32, 7 x 32; 17 x 4096 and 7 x
    64 with 7 parameters; both parities, production and burn-in steps, a
    -inf log L row, the beta = 0 rung), each timed (events and the
    profiler's device time); K6d, the stepping-stone block terms (one pass,
    the splits of each block combined in the same launch), float64 <= 1e-12
    relative at the evidence bench shape and two launches bit-equal; its
    edge cases (a NaN, a +inf, one -inf, a split of -inf in a finite block,
    a block of -inf) at block lengths the splits do not divide, with 16-byte
    and scalar loads, NaN positions equal to the plain version's; the one-
    split shapes of the PT fits and compare_models (250 steps x 7 x 32, 17
    x 32, 7 x 64) with a -inf row and the same edge cases;
    ``torch.logsumexp`` timed beside it;
16. the tempered-ladder main path: ``lightcurve_evidence`` on ShockCooling2
    and SN 2016bkv at the JAX package's bench shape (4096 walkers x 16 rungs
    + beta = 1 x 150 + 150 steps; seeds 1, 2 and 1 again, the repeat
    bit-identical), log Z within 4 hypot(err, 0.35) of -12961.48 and of the
    JAX package's float64 CPU value, float64 compute beside float32, the
    time split by a profiled run; (b) ``lightcurve_ptmcmc`` on the flagship
    (32 walkers, 6 rungs, 250 + 350 steps), cold medians in range; (c)
    ``compare_models`` on synthetic ShockCooling2 photometry, snug priors
    against wide ones, the log Bayes factor in (3, 20); the launch counters,
    reset before (a), show it ran through K6a-K6d;
17. K7, the log-posterior and its gradient, against autograd through the
    plain log-posterior at 131072 flagship walkers (1% outside the priors,
    and 131072 more with t < t_exp) and at the MAP's 64 starts: values as
    K1's, gradients within 1e-4 (float32) and 1e-9 (float64) of their
    per-point terms' summed magnitudes, zero (masked) at the same places;
    in the whitened space at 64 and 131072 rows; at each width its block
    form (a block per row) and its warp form (a warp per row) bit-equal,
    and the profiler shows the wrapper ran the block form at 64 rows and the
    warp form at 131072 (``kernels/gradient.py::k7_form``);
18. K9, the NUTS transition (a block per chain), against the plain
    transition under shared draws on 64 whitened flagship chains, max_depth
    9: float64 over the plain gradient, float32 over K7's own evaluations,
    equal except near-ties (and the float32 kernel against the fully plain
    float32 transition reported); every chain's new log-posterior equal to
    K7's at its new state, bit for bit; the deep trees (max_depth 12);
19. K7h, the HMC transition (a block per chain, 32 jittered leapfrogs),
    the same way at 64 chains and at ``lightcurve_hmc``'s 16, float32 and
    float64, the profiler showing the block kernel ran;
20. the gradient main path, counters reset before (a): (a)
    ``lightcurve_map`` on the flagship with tests/test_map.py:92-104's
    criteria, (b) ``lightcurve_mcmc(init="map")`` with test_map.py:59-79's,
    (c) ``lightcurve_hmc`` at its defaults (16 chains x 800 + 1000, max_depth
    9, warm start 64 x 300; seed 3) in float32 and float64 compute, both
    held to tests/test_hmc.py:147-159's criteria, wall times, a profiled
    run's time split in each, (d)
    ``lightcurve_hmc(sampler="hmc")``, its wall time and a profiled run's
    split (20a's too); the counters show K7, K9 and K7h ran;
21. the intrinsic scatter: every kernel that branches on ``use_sigma``
    against its plain version with the scatter on (SC2 with 5 parameters,
    SC3 with 8, CS1 with 9; both sigma_types; float32 and float64): K1, the
    SC3 or the CS log-posterior, K2, the SC3 or the CS half-step, K6a and
    K6b over each, and K7 in both forms, bit-equal (the sigma column of the
    gradient included; the block form's N = 5), K9 and K7h over SC2, held
    to the tolerances above over the term scale (0.5 x the summed residual
    terms' magnitudes, the scatter's log term included, + |constant|);
22. K8, the SiFTO spline, against ``sifto_points_plain`` at 131072 walkers x
    the 108 points of the synthetic SN 2017cbv-style Ia curve
    (tests/test_companion_shocking.py::make_ia_lc, rebuilt with the port),
    and on whole-day times whose phases fall on the knots, at both ends,
    outside, NaN and infinite: float32 <= 1e-6 and float64 <= 1e-13 of the
    band's template peak, identical zero sets;
23. the CS log-posterior (a warp per walker, the half-step's form) of
    CompanionShocking, CompanionShocking2, CompanionShocking3 and
    CompanionShocking with the scatter (9 parameters) against its plain
    version at 131072 walkers (1% outside the
    priors, an eighth with t_0 after the first epochs): float32 <= 1e-5,
    float64 <= 1e-10 of the term scale, identical -inf sets; CS2 at the
    fits' widths (32, 4096, 32768) the same values bit for bit, each timed
    (events, device time), the profiler showing the warp kernel ran; the CS
    half-step (h = 0, 1; a warp per walker) at half 65536 and at the fits'
    widths, half 16384 and 16, K6a and K6b (a warp per walker) at 17 rungs
    x 4096 and at the PT fit's 7 x 64, as in 4, 14, 15, float32 and
    float64;
24. the companion-shocking main path, counters reset before (a): (a)
    ``lightcurve_mcmc`` CS2 as tests/test_companion_shocking.py:106-123
    (32 walkers x 300 + 250, seed 12) with its truth criteria; (b) CS2 at
    32768 walkers x 300 from the window, four timed runs and a profiled one,
    mean acceptance within 0.01 of the JAX package's float64 CPU value; (c)
    ``lightcurve_evidence`` CS2 at 4096 x 16 rungs + beta = 1 x 150 + 150,
    log Z within 4 hypot(err, err_ref) of the JAX package's float64 CPU
    value, a profiled run's time split, ``compare_models`` CS2 against CS3
    and ``lightcurve_ptmcmc`` CS2
    (t_0 and t_peak within 1 d); (d) the three models' ``evaluate`` on the
    card (K8); the counters show K8, the CS log-posterior
    and half-step, K6a and K6b ran, and no plain version did.

The last lines are the card's name and power limit, one JSON line with each
kernel's launches, error, time, bound and library time, and ``{"ok": true,
"device": ...}``. A kernel's bound is the larger of its operations' time and
its bytes (inputs read once, outputs written once) over 3.35 TB/s, from
this run's shapes. Operations count on two pipes: arithmetic at the FP32
rate (67 TFLOP/s) and special functions (expm1, exp, log, pow, sqrt, an
IEEE division), each the time of 16 FP32 operations (the special-function
unit issues 16 a clock per SM against 128 FP32 lanes of 2 flops). In float32
the unit issues beside the FP32 pipe, so the time is the larger pipe's; a
kernel bound at the FP64 rate (34 TFLOP/s) has no such unit and adds them.
"""

import contextlib
import io
import itertools
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
# the JAX package's mean acceptance on the CPU of the flagship fit at 4096
# walkers x 300 steps from the init window over seeds 1-8, and its standard
# error: float64, and float32 compute over the float32 rescaled state
# (tests/test_torch_sc3.py::jax_sc2_acceptance)
SC2_SEEDS, SC2_SEED_WALKERS = tuple(range(1, 9)), 4096
SC2_SEEDS_REF = {"f64": (0.47225474039713544, 0.0003145498430522239),
                 "f32": (0.4722075398763021, 0.0004930160311681418)}

# ShockCooling3 on the same light curve (flux), d_L pinned by dm = 30.79
D_L = 10 ** (30.79 / 5 + 1) / 1e6
SC3_LO = [0.5, 0.5, 5.0, 1.0, D_L - 0.005, 0.0, 57468.5]
SC3_UP = [2.0, 2.0, 20.0, 5.0, D_L + 0.005, 0.1, 57468.7]
SC3_WALKERS = 32768
# mean acceptance of the JAX package, float64 on the CPU, for this fit: 32768
# walkers x 300 steps from the SC3 window, no burn-in, seed 7 (shard=False)
SC3_ACCEPTANCE_REF = 0.21477925618489585
SC3_CHI2_PROBE = 96.0     # chi2/dof of the best draw of the JAX package's CPU probe
# the JAX package's mean acceptance, float64 on the CPU, of the same fit at
# 4096 walkers x 300 steps over seeds 1-8, and its standard error
# (tests/test_torch_sc3.py::jax_sc3_acceptance)
SC3_SEEDS, SC3_SEED_WALKERS = tuple(range(1, 9)), 4096
SC3_SEEDS_REF = (0.21567057291666666, 0.0012260149284139086)
PLAIN_CHUNK = 16384       # walkers per call of a plain quadrature version: its
                          # (W, 149, 89) cube stays near 1 GB a tensor

# the bolometric bench shape (bench.py:108-166) and the JAX package's mean
# acceptance there, float64 on the CPU: the epochs of rng 0, centers and
# guesses of seed 1 (the first run after the epochs), 256 x 32 x (200 + 100)
# (tests/test_torch_batched.py::jax_bench_acceptance)
BOL_EPOCHS, BOL_WALKERS, BOL_BURNIN, BOL_STEPS = 256, 32, 200, 100
BOL_ACCEPTANCE_REF = 0.706744372844696
BOL_STARTS, BOL_ITER = 8, 300   # batched_map_centers's Adam polish: starts an epoch, steps
# K4p's centers against map_polish_plain on the card, relative: float64; and
# float32, measured on the H100 (PERF.md)
POLISH_REL = {"f64": 1e-9, "f32": 1e-5}

FP32_FLOPS = 67e12        # H100 SXM, FP32 outside the tensor cores
FP64_FLOPS = 34e12        # H100 SXM, FP64 outside the tensor cores
HBM_BYTES = 3.35e12       # H100 SXM HBM3
SFU_OPS = 16              # FP32 operations' time a special function is counted as


class Ops:
    """An operation count on two pipes: ``fp`` arithmetic operations and
    ``sf`` special functions. Adds, and scales by numbers, like a number."""
    __array_ufunc__ = None    # a numpy scalar times Ops defers to __rmul__

    def __init__(self, fp=0.0, sf=0.0):
        self.fp, self.sf = float(fp), float(sf)

    def __add__(self, other):
        o = other if isinstance(other, Ops) else Ops(other)
        return Ops(self.fp + o.fp, self.sf + o.sf)

    __radd__ = __add__

    def __mul__(self, k):
        return Ops(self.fp * float(k), self.sf * float(k))

    __rmul__ = __mul__


SFU = Ops(sf=1)           # one special function


def bound(ops, nbytes, rate=FP32_FLOPS):
    """(bound_ms, bound_by): the least time for ``ops`` (an Ops or a number
    of arithmetic operations) at ``rate`` (FP32 unless given; see the
    docstring for the two pipes) and ``nbytes`` of device-memory traffic."""
    ops = ops if isinstance(ops, Ops) else Ops(ops)
    sf = SFU_OPS * ops.sf
    t_ops = (max(ops.fp, sf) if rate == FP32_FLOPS else ops.fp + sf) / rate
    t_bytes = nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_fields(ops, nbytes, library_ms=None, rate=FP32_FLOPS):
    ms, by = bound(ops, nbytes, rate)
    return {"bound_ms": ms, "bound_by": by, "library_ms": library_ms}


# operations of one evaluation (see the docstring for the counting rule)
PLANCK_TERM = 5 + 2 * SFU          # K4: 5 flops, expm1 and a division
PLANCK_TERM_GRAD = PLANCK_TERM + 6  # with dS/dT: w lnu (1 + 1/expm1) x / T, accumulated
QUAD_TERM = 6 + 3 * SFU            # K3: also the extinction exp
PROPOSAL = 10 + 2 * SFU            # the stretch move and its two logs


def sc2_eval_ops(ll):
    """K1 on one walker: per point the Clenshaw recurrence (3 per degree),
    ~30 flops and 10 special functions (SW17 powers, exp, sqrt, log, divisions)."""
    N, D1 = ll.bb_coeffs.shape
    return N * (3 * (D1 - 1) + 30 + 10 * SFU)


def sc3_eval_ops(ll):
    """The SC3 log-posterior on one walker: each point's native quadrature
    terms plus ~30 flops and 12 special functions of SW17."""
    terms = int(ll.n_native[ll.band_ids].sum())
    return terms * QUAD_TERM + ll.band_ids.shape[0] * (30 + 12 * SFU)


def epoch_eval_ops(ep):
    """K4 on one parameter vector, summed over the epochs: the native terms
    of their real bands plus ~10 flops a band and the log-uniform prior's
    log an epoch."""
    terms = float((ep.n_native * ep.mask).sum())
    return terms * PLANCK_TERM + float(ep.mask.sum()) * 10 + ep.n_epochs * SFU


DRAW_KERNELS = ("distribution", "random", "philox", "uniform", "normal")


def time_split(prof, wall, kernels):
    """Seconds of device time by part of a run from a profiler trace: the
    parts of ``kernels`` (name -> substrings of their kernels' names; the
    first match wins), the draws and the rest, and the host's share (the
    wall time the device was idle). Returns (parts, busy)."""
    parts = dict.fromkeys(kernels, 0.0)
    parts.update(draws=0.0, other=0.0)
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        k = e.key.lower()
        name = next((n for n, subs in kernels.items() if any(w in k for w in subs)), None)
        if name is None:
            name = "draws" if any(w in k for w in DRAW_KERNELS) else "other"
        parts[name] += e.self_device_time_total / 1e6
    busy = sum(parts.values())
    parts["host (device idle)"] = wall - busy
    return parts, busy


def profiled(fn):
    """Wall seconds of fn() under the profiler, and the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


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


def compare_ll(name, got, want, rel, const=0.0, scale=None):
    """Same -inf set, |got - want| <= rel * scale where finite, the scale
    ll_scale(want, const) unless one is given (LogLikelihood.term_scales);
    returns the largest absolute and scaled differences and the finite
    count."""
    import torch
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{name}: NaN log-posterior")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        n = int((torch.isneginf(got) != torch.isneginf(want)).sum())
        raise AssertionError(f"{name}: -inf sets differ at {n} walkers")
    fin = torch.isfinite(want)
    d = (got - want).abs()[fin]
    r = d / (ll_scale(want[fin], const) if scale is None else scale[fin])
    if not bool((r <= rel).all()):
        raise AssertionError(f"{name}: max |delta|/scale = {float(r.max()):.3e} > {rel:.0e}")
    return (float(d.max()) if d.numel() else 0.0, float(r.max()) if r.numel() else 0.0,
            int(fin.sum()))


def check_half_step(name, lp, off, sc, x0, seed, rel):
    """The half-step kernel of lp's model (h = 0, 1) against the plain
    half-step under shared draws on the rescaled state x0 (2, half, ndim):
    accept flags equal except near-ties (|ln u - log ratio| within 1e-5 of
    the term scales of both states), new states bit-equal and new
    log-posteriors within ``rel`` of the term scale where they agree, the
    chain slot holding the new half, the other half and its accept counts
    untouched. Returns (near-ties, accepts, max |d logp|)."""
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.kernels import common
    dev = x0.device
    half, ndim = x0.shape[1], x0.shape[2]
    scales = lp.log_likelihood.term_scales
    l0 = kernels.log_posterior(lp, x0.reshape(-1, ndim), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)

    def plain(q):
        return chunked(lambda c: common.log_posterior_plain(lp, c, off, sc), q)

    ties, acc, max_abs = 0, 0, 0.0
    for h in (0, 1):
        what = f"{name} h={h}"
        xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ck = torch.empty_like(x0)
        clk = torch.empty((2, half), dtype=torch.float64, device=dev)
        kernels.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, off, sc, ck, clk, ak)
        common.stretch_half_step_plain(plain, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
        torch.cuda.synchronize()
        agree = ak[h] == ap[h]
        y, z = common.propose_stretch(u_z, j, x0[h], x0[1 - h])
        gap = (torch.log(u_acc).double() - ((ndim - 1.0) * torch.log(z).double() + plain(y)
                                            - l0[h])).abs()
        tie_ok = gap <= 1e-5 * (scales(common.absolute_params(y, off, sc))
                                + scales(common.absolute_params(x0[h], off, sc)))
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"{what}: {int((~agree & ~tie_ok).sum())} accept flags differ "
                                 "away from near-ties")
        if not torch.equal(xk[h][agree], xp[h][agree]):
            raise AssertionError(f"{what}: new states differ where the flags agree")
        if not torch.equal(xk[1 - h], x0[1 - h]) or not torch.equal(ak[1 - h], ap[1 - h]) \
                or not torch.equal(ck[h], xk[h]) or not torch.equal(clk[h], lk[h]):
            raise AssertionError(f"{what}: wrong half or chain slot written")
        d = compare_ll(f"{what} new logp", lk[h][agree], lpp[h][agree], rel,
                       scale=scales(common.absolute_params(xk[h], off, sc))[agree])
        max_abs = max(max_abs, d[0])
        ties += int((~agree).sum())
        acc += int(ak[h].sum())
    return ties, acc, max_abs


def check_ladder(name, lp, off, sc, x0, seed, rel, same_bits=True):
    """K6b and K6a (h = 0, 1) over lp's model against their plain versions
    on the rescaled ladder state x0 (R, 2, half, ndim), beta_0 = 0. K6b: log
    pi within 1e-12, log L within ``rel`` of the term scale. K6a: flags
    equal except near-ties, states and log pi bit-equal and log L within
    ``rel`` of the term scale where they agree, the other half and its
    accept counts untouched. With ``same_bits`` (K6a a warp per walker, the
    policy of K6b) K6b at the states K6a left gives K6a's stored log pi and
    log L bit for bit. Returns (near-ties, accepts, max |d log L| of K6a,
    max |d log L| of K6b)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import common, ladder
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    dev = x0.device
    R, _, half, ndim = x0.shape
    scales = lp.log_likelihood.term_scales
    fns = ladder.plain_functions(lp, off, sc)
    pri0, ll0 = ladder.ladder_init(lp, x0, off, sc)
    want_pri, want_ll = ladder.ladder_init_plain(*fns, x0)
    fin = torch.isfinite(want_pri)
    if not torch.equal(torch.isneginf(pri0), torch.isneginf(want_pri)) \
            or not bool(((pri0 - want_pri).abs()[fin] <= 1e-12).all()):
        raise AssertionError(f"{name} K6b: log pi differs from the plain version")
    scale0 = scales(common.absolute_params(x0, off, sc))
    d_init = compare_ll(f"{name} K6b", ll0, want_ll, rel, scale=scale0)[0]
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (R, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev)
    ties, acc, max_abs = 0, 0, 0.0
    for h in (0, 1):
        what = f"{name} K6a h={h}"
        xk, pk, lk = x0.clone(), pri0.clone(), ll0.clone()
        xp, pp, lpl = x0.clone(), pri0.clone(), ll0.clone()
        ak = torch.zeros(shape, dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ladder.tempered_half_step(lp, xk, pk, lk, betas, h, u_z, j, u_acc, 2.0, off, sc, ak)
        ladder.tempered_half_step_plain(*fns, xp, pp, lpl, betas, h, u_z, j, u_acc, 2.0, ap)
        torch.cuda.synchronize()
        agree = ak[:, h] == ap[:, h]
        y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
        pri_y, ll_y = fns[0](y), fns[1](y)
        b = betas[:, None]
        ratio = ((ndim - 1.0) * torch.log(z) + pri_y + torch.where(b > 0, b * ll_y, 0.0)
                 - pri0[:, h] - torch.where(b > 0, b * ll0[:, h], 0.0))
        gap = (torch.log(u_acc[:, h]).double() - ratio).abs()
        tie_ok = gap <= 1e-5 * (scales(common.absolute_params(y, off, sc)) + scale0[:, h])
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"{what}: {int((~agree & ~tie_ok).sum())} accept flags differ "
                                 "away from near-ties")
        if not torch.equal(xk[:, h][agree], xp[:, h][agree]) \
                or not torch.equal(pk[:, h][agree], pp[:, h][agree]):
            raise AssertionError(f"{what}: new states or log pi differ where the flags agree")
        if not torch.equal(xk[:, 1 - h], x0[:, 1 - h]) or not torch.equal(ak[:, 1 - h],
                                                                           ap[:, 1 - h]):
            raise AssertionError(f"{what}: the other half was written")
        if same_bits:
            pri_k, ll_k = ladder.ladder_init(lp, xk, off, sc)
            if not torch.equal(pri_k, pk) or not torch.equal(ll_k, lk):
                raise AssertionError(f"{what}: K6b at the new states differs from the values "
                                     "K6a stored")
        d = compare_ll(what, lk[:, h][agree], lpl[:, h][agree], rel,
                       scale=scales(common.absolute_params(xk[:, h], off, sc))[agree])
        max_abs = max(max_abs, d[0])
        ties += int((~agree).sum())
        acc += int(ak[:, h].sum())
    return ties, acc, max_abs, d_init


# the widths whose initial state a fit computes with K1: 5a's 64 walkers
# (and lightcurve_hmc's warm start, 20c), 5c's 4096 and 5b's 131072
K1_WIDTHS = (64, 4096, HEADLINE_WALKERS)


def k1_repeats_k2(lp, off, sc, half, seed):
    """Two K2 half-steps (h = 0, 1) at u_acc = 0 (every proposal inside the
    priors accepted) on a rescaled float32 state of 2 x half walkers from
    the init window, then K1 on the new states: the number of walkers
    whose K1 value differs in any bit from the log-posterior K2 stored, and
    the number K2 moved."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sc2
    dev = torch.device("cuda")
    pos = (np.random.default_rng(seed).uniform(P_LO, P_UP, size=(2 * half, 4)) - off) / sc
    x = torch.as_tensor(pos.reshape(2, half, 4), device=dev).float().contiguous()
    logp = sc2.log_posterior(lp, x.reshape(-1, 4), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
    for h in (0, 1):
        u_z = torch.rand(half, generator=g, device=dev)
        j = torch.randint(0, half, (half,), generator=g, device=dev)
        sc2.stretch_half_step(lp, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                              n_accept=acc)
    again = sc2.log_posterior(lp, x.reshape(-1, 4), off, sc)
    return int((again != logp.reshape(-1)).sum()), int(acc.sum())


def phase_k1(lc, rng_seed=0):
    """3: K1 (a warp per walker, the half-step's form) against forward_plain
    at 131072 walkers, float32 and float64, t < t_exp included; at the
    fits' widths (64, 4096, 131072) the same values bit for bit, each
    timed on the rescaled float32 state, the profiler showing the warp
    kernel ran; K1 at the states K2 accepted equal to K2's stored values."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import sc2
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
    kw = _state_rescaling(torch.float32, P_LO, P_UP, dev)   # what "auto" gives on CUDA
    off, sc = kw["param_offset"], kw["param_scale"]

    res, widths, names, repeats = {}, {}, {}, {}
    n0 = kernels.LAUNCHES["sc2_logpost"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(), device=dev)
            lp_wide = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(57460.0, 57480.0),
                                         device=dev)
            rel = 1e-5 if label == "f32" else 1e-10
            got = lp(p)
            a = compare_ll(f"K1 {label}", got, lp.forward_plain(p), rel)
            got_late = lp_wide(p_late)
            b = compare_ll(f"K1 {label} t<t_exp", got_late, lp_wide.forward_plain(p_late), rel)
            if torch.isfinite(got_late).sum() != W:
                raise AssertionError("t < t_exp walkers must have finite log-posteriors")
            res[label] = (max(a[0], b[0]), max(a[1], b[1]), a[2])
            widths[label], names[label] = batch_widths(
                f"K1 {label}", sc2.log_posterior, lp, p, off, sc, K1_WIDTHS, got,
                "logpost_warp_kernel", ("SC2WarpModel", ", 4>"), sc2_eval_ops(lp.log_likelihood))
            repeats[label] = k1_repeats_k2(lp, off, sc, 2048, rng_seed + 1)
            if repeats[label][0]:
                raise AssertionError(f"K1 {label}: {repeats[label][0]} values at states K2 "
                                     "accepted differ from K2's stored ones")
            if label == "f32":
                plain_ms = cuda_ms(lambda: lp.forward_plain(p), repeats=5)
        finally:
            config.set_compute_dtype(config.AUTO)
    t32 = widths["f32"]
    phase("K1", f"{names['f32']}, {W} walkers (1% outside the priors, {W} more with t < t_exp): "
          f"f32 max |d| {res['f32'][0]:.3e} (max |d|/|ll| {res['f32'][1]:.2e} <= 1e-5), "
          f"f64 max |d| {res['f64'][0]:.3e} (max |d|/|ll| {res['f64'][1]:.2e} <= 1e-10), "
          f"-inf sets equal; at the fits' widths {', '.join(map(str, K1_WIDTHS))} the same "
          "values bit for bit (f32, f64); at the states two K2 half-steps (u_acc = 0) left, "
          + ", ".join(f"{lab} {r[0]} of {2 * 2048} values differ from K2's stored ones "
                      f"({r[1]} moves)" for lab, r in repeats.items())
          + f"; {kernels.LAUNCHES['sc2_logpost'] - n0} comparison launches; kernel (events; the "
          "profiler's device time) on the rescaled f32 state "
          + ", ".join(f"{v[0]:.4f}; {v[1]:.4f} ms at {w} (bound {v[2]['bound_ms']:.5f})"
                      for w, v in t32.items())
          + f"; plain {plain_ms:.4f} ms per {W}-walker batch (f32)")
    return {"max_abs_err": res["f32"][0], "ms": t32[W][0], "plain_ms": plain_ms, **t32[W][2]}


# K2's widths: the 131072-walker fit (5b), 16384, and the 64-walker fits (5a
# and lightcurve_hmc's warm start, 20c)
K2_HALVES = (HEADLINE_WALKERS // 2, 16384, 32)


def launched_kernels(fn, match, calls=20):
    """The names of the CUDA kernels holding ``match`` that ``calls`` calls
    of fn launch, from the profiler. A profile of a few calls can come back
    empty (3 calls of K7 at 131072 rows did once on the H100), so an empty
    one is taken again, twice at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type.name == "CUDA" and match in e.key})
        if names:
            break
    return names


def expect_kernel(fn, match, *marks, calls=20):
    """The one kernel holding ``match`` that fn launches, whose name must
    also hold each of ``marks`` (a form, a policy, a template argument:
    "true>" for the tempered half-step's warp form, ", 4>" for ndim 4)."""
    names = launched_kernels(fn, match, calls)
    if len(names) != 1 or not all(m in names[0] for m in marks):
        raise AssertionError(f"expected one {match} holding {marks}, the profiler saw {names}")
    return names[0].split("(")[0]


def k7_value_differences(lp, off, sc, x0, seed):
    """K2 over lp's model with u_acc = 0 (every proposal inside the priors
    accepted, so each new log-posterior is a proposal's) on the rescaled
    state x0 (2, half, ndim), then K7 at the new states: (proposals
    compared, how many differ from K7's value in any bit, the largest
    difference)."""
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.kernels import common
    dev = x0.device
    half, ndim = x0.shape[1], x0.shape[2]
    x = x0.clone()
    logp = kernels.log_posterior(lp, x.reshape(-1, ndim), off, sc).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev, dtype=x.dtype)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
    kernels.stretch_half_step(lp, x, logp, 0, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                              n_accept=acc)
    moved = acc[0] == 1
    k7 = kernels.log_posterior_and_grad(lp, common.absolute_params(x[0], off, sc))[0]
    d = (logp[0] - k7)[moved].abs()
    return int(moved.sum()), int((d != 0).sum()), float(d.max())


def phase_k2(lc, seed=1):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import sc2
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    kw = _state_rescaling(torch.float32, P_LO, P_UP, dev)   # what "auto" gives on CUDA
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(seed)
    res, k_ms, k_bounds, k7_diff = {}, {}, {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(), device=dev)
            for half in K2_HALVES:
                pos = (rng.uniform(P_LO, P_UP, size=(2 * half, 4)) - off) / sc
                x0 = torch.as_tensor(pos.reshape(2, half, 4), device=dev).float().contiguous()
                res[(label, half)] = check_half_step(f"K2 {label} {half}", lp, off, sc, x0, seed,
                                                     1e-5 if label == "f32" else 1e-10)
                if half == K2_HALVES[0]:
                    k7_diff[label] = k7_value_differences(lp, off, sc, x0, seed + 1)
                if label == "f64":
                    continue
                logp0 = sc2.log_posterior(lp, x0.reshape(2 * half, 4), off, sc).reshape(2, half)
                g = torch.Generator(device=dev)
                g.manual_seed(seed)
                u_z = torch.rand(half, generator=g, device=dev)
                j = torch.randint(0, half, (half,), generator=g, device=dev)
                u_acc = torch.rand(half, generator=g, device=dev)
                xk, lk = x0.clone(), logp0.clone()
                ak = torch.zeros((2, half), dtype=torch.int32, device=dev)

                def step():
                    sc2.stretch_half_step(lp, xk, lk, 0, u_z, j, u_acc, 2.0, off, sc,
                                          n_accept=ak, check_partners=False)
                if half == K2_HALVES[0]:
                    name = expect_kernel(step, "stretch_half_step_kernel", "SC2WarpModel")
                    xp, lpp = x0.clone(), logp0.clone()
                    plain_ms = cuda_ms(lambda: sc2.stretch_half_step_plain(
                        lambda q: sc2.log_posterior_plain(lp, q, off, sc), xp, lpp, 0, u_z, j,
                        u_acc, 2.0), repeats=5)
                k_ms[half] = (cuda_ms(step), device_ms(step, "stretch_half_step_kernel", 20, 1)[0])
                k_bounds[half] = bound_fields(half * (sc2_eval_ops(lp.log_likelihood) + PROPOSAL),
                                              half * (2 * 4 * 4 + 8 + 16 + 4)
                                              + half * (4 * 4 + 8 + 4))
        finally:
            config.set_compute_dtype(config.AUTO)
    top = K2_HALVES[0]
    phase("K2", f"{name}: half-steps h=0,1 (f32 state, f64 logp, a warp per walker) at half "
          + "; ".join(f"{half} {lab}: {c[1]} accepts, {c[0]} near-ties, new-logp max |d| "
                      f"{c[2]:.3e}" for (lab, half), c in res.items())
          + " (flags agree except the near-ties, new states bit-equal where they agree; <= 1e-5"
          " / 1e-10 of the term scale); kernel (events; the profiler's device time) "
          + ", ".join(f"{k_ms[h][0]:.4f}; {k_ms[h][1]:.4f} ms per half {h} (bound "
                      f"{k_bounds[h]['bound_ms']:.5f})" for h in K2_HALVES)
          + f", plain {plain_ms:.4f} ms per half {top} (f32)")
    phase("K2 against K7", "proposals' log-posteriors in K2 (u_acc = 0, half "
          f"{top}) that differ from K7's value at the same float64 parameters: "
          + ", ".join(f"{lab} {v[1]} of {v[0]} (max |d| {v[2]:.3e})" for lab, v in k7_diff.items()))
    return {"max_abs_err": max(c[2] for (lab, _), c in res.items() if lab == "f32"),
            "ms": k_ms[top][0], "plain_ms": plain_ms, **k_bounds[top]}


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
    N, K = ll.band_ids.shape[0], ll.nodes.shape[1]
    k3_bound = bound_fields(W * N * K * QUAD_TERM, W * N * 4 * 4 + W * 4)
    phase("K3", f"{W} walkers x 149 points x 89 nodes ({res['f32'][2]} points with T <= 0 give "
          f"0): f32 max |d| {res['f32'][0]:.3e} W/Hz (max relative {res['f32'][1]:.2e} <= 1e-5), "
          f"f64 max |d| {res['f64'][0]:.3e} (max relative {res['f64'][1]:.2e} <= 1e-12); "
          f"{kernels.LAUNCHES['bandflux'] - n0} comparison launches; K3 {k3_ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms per {W}-walker batch (f32), bound "
          f"{k3_bound['bound_ms']:.4f} ms ({k3_bound['bound_by']})")
    return {"max_abs_err": res["f32"][0], "ms": k3_ms, "plain_ms": plain_ms, **k3_bound}


# the widths whose initial state a fit computes with the SC3 log-posterior:
# 9a's 64 walkers, 9c's 4096 and 9b's 32768
SC3_LP_WIDTHS = (64, 4096, SC3_WALKERS)


def batch_widths(name, fn, lp, x, off, sc, widths, whole, match, marks, eval_ops):
    """The batch log-posterior wrapper ``fn`` on the first w rows of the
    absolute parameters x at each width w of ``widths``: its values equal
    those of ``whole`` (fn's at every row of x) bit for bit, so they are
    held to the plain version there; then, on the rows in the sampler's
    float32 rescaled state (off, sc), its time by events and by the
    profiler's device time, its bound, and the kernel the profiler saw
    (holding ``match`` and ``marks``). Returns ({w: (events ms, device ms,
    bound)}, the kernel's name)."""
    import torch
    from time_port_kernels import device_ms
    dev = x.device
    out, name_seen = {}, None
    for w in widths:
        if not torch.equal(fn(lp, x[:w]), whole[:w]):
            raise AssertionError(f"{name}: the values at width {w} differ from the batch's")
        q = ((x[:w] - torch.as_tensor(off, device=dev)) / torch.as_tensor(sc, device=dev)).float()

        def call():
            return fn(lp, q, off, sc)
        name_seen = expect_kernel(call, match, *marks)
        out[w] = (cuda_ms(call), device_ms(call, match, 20, 1)[0],
                  bound_fields(w * eval_ops, w * (q.shape[1] * 4 + 8)))
    return out, name_seen


def phase_sc3_logpost(lcf, rng_seed=3):
    """7: the SC3 log-posterior (a warp per walker) against forward_plain at
    131072 walkers, float32 and float64; at the fits' widths (64, 4096,
    32768) the same values, each timed on the rescaled float32 state, the
    profiler showing the warp kernel ran."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import sc3
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    p, late = sc3_walkers(np.random.default_rng(rng_seed), W)
    p, late = torch.as_tensor(p, device=dev), torch.as_tensor(late, device=dev)
    kw = _state_rescaling(torch.float32, SC3_LO, SC3_UP, dev)   # what "auto" gives on CUDA
    res, widths, names = {}, {}, {}
    n0 = kernels.LAUNCHES["sc3_logpost"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(), device=dev)
            wide = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(57480.0), device=dev)
            rel = 1e-5 if label == "f32" else 1e-10
            c = lp.log_likelihood.log_norm_const
            got = lp(p)
            a = compare_ll(f"SC3 log-posterior {label}", got, chunked(lp.forward_plain, p),
                           rel, c)
            got_late = wide(late)
            b = compare_ll(f"SC3 log-posterior {label} t<t_exp", got_late,
                           chunked(wide.forward_plain, late), rel, c)
            if torch.isfinite(got_late).sum() != W:
                raise AssertionError("t < t_exp walkers must have finite log-posteriors")
            res[label] = (max(a[0], b[0]), max(a[1], b[1]), a[2])
            widths[label], names[label] = batch_widths(
                f"SC3 log-posterior {label}", sc3.log_posterior, lp, p, kw["param_offset"],
                kw["param_scale"], SC3_LP_WIDTHS + (W,), got, "logpost_warp_kernel",
                ("SC3WarpModel",), sc3_eval_ops(lp.log_likelihood))
            if label == "f32":
                plain_ms = cuda_ms(lambda: chunked(lp.forward_plain, p), repeats=2)
        finally:
            config.set_compute_dtype(config.AUTO)
    t32 = widths["f32"]
    phase("SC3 log-posterior", f"{names['f32']}, {W} walkers (1% outside the priors, {W} more "
          f"with t < t_exp): f32 max |d| {res['f32'][0]:.3e} (max |d|/(|ll - c| + |c|) "
          f"{res['f32'][1]:.2e} <= 1e-5, c = {c:.2f} the normalization constant), f64 max |d| "
          f"{res['f64'][0]:.3e} (max |d|/(|ll - c| + |c|) {res['f64'][1]:.2e} <= 1e-10), "
          f"-inf sets equal; at the fits' widths {', '.join(map(str, SC3_LP_WIDTHS))} the "
          f"same values bit for bit (f32, f64); {kernels.LAUNCHES['sc3_logpost'] - n0} "
          "comparison launches; kernel (events; the profiler's device time) on the rescaled "
          "f32 state " + ", ".join(f"{v[0]:.4f}; {v[1]:.4f} ms at {w} (bound "
                                   f"{v[2]['bound_ms']:.4f})" for w, v in t32.items())
          + f"; plain {plain_ms:.4f} ms per {W}-walker batch (f32)")
    return {"max_abs_err": res["f32"][0], "ms": t32[W][0], "plain_ms": plain_ms, **t32[W][2]}


def phase_sc3_half_step(lcf, seed=4):
    """8: the SC3 half-step (a warp per walker) against the plain half-step
    at half 65536 and at the fits' widths, half 16384 (9b) and 32 (9a); its
    time at each, the plain version's at 65536."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    dev = torch.device("cuda")
    lp = make_log_posterior(ShockCooling3(lcf), lcf, sc3_priors(), device=dev)
    kw = _state_rescaling(torch.float32, SC3_LO, SC3_UP, dev)   # what "auto" gives on CUDA
    off, sc = kw["param_offset"], kw["param_scale"]
    rng = np.random.default_rng(seed)
    checks, times, bounds = [], {}, {}
    for half in (HEADLINE_WALKERS // 2, SC3_WALKERS // 2, 32):
        W = 2 * half
        pos = (rng.uniform(SC3_LO, SC3_UP, size=(W, 7)) - off) / sc
        x0 = torch.as_tensor(pos.reshape(2, half, 7), device=dev).to(torch.float32).contiguous()
        checks.append(check_half_step(f"SC3 half-step {half}", lp, off, sc, x0, seed, 1e-5))
        logp0 = kernels.log_posterior(lp, x0.reshape(W, 7), off, sc).reshape(2, half)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        u_z = torch.rand(half, generator=g, device=dev)
        j = torch.randint(0, half, (half,), generator=g, device=dev)
        u_acc = torch.rand(half, generator=g, device=dev)
        xk, lk = x0.clone(), logp0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
        times[half] = cuda_ms(lambda: kernels.stretch_half_step(
            lp, xk, lk, 0, u_z, j, u_acc, 2.0, off, sc, n_accept=ak, check_partners=False))
        bounds[half] = bound_fields(half * (sc3_eval_ops(lp.log_likelihood) + PROPOSAL),
                                    half * (2 * 7 * 4 + 8 + 16 + 4) + half * (7 * 4 + 8 + 4))
        if half == HEADLINE_WALKERS // 2:
            xp, lpp = x0.clone(), logp0.clone()
            plain_ms = cuda_ms(lambda: common.stretch_half_step_plain(
                lambda q: chunked(lambda c: common.log_posterior_plain(lp, c, off, sc), q), xp,
                lpp, 0, u_z, j, u_acc, 2.0), repeats=2)
    head = HEADLINE_WALKERS // 2
    phase("SC3 half-step", "half-steps h=0,1 (f32 state, f64 logp, a warp per walker) at half "
          + "; ".join(f"{h}: {c[1]} accepts, flags agree except {c[0]} near-ties, new states "
                      f"bit-equal where they agree, new-logp max |d| {c[2]:.3e}"
                      for h, c in zip(times, checks))
          + " (<= 1e-5 of the term scale); kernel "
          + ", ".join(f"{times[h]:.4f} ms per half {h} (bound {bounds[h]['bound_ms']:.4f} ms, "
                      f"{bounds[h]['bound_by']})" for h in times)
          + f"; plain {plain_ms:.4f} ms per half {head}")
    return {"max_abs_err": max(c[2] for c in checks), "ms": times[head], "plain_ms": plain_ms,
            **bounds[head]}


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
    wall, prof = profiled(lambda: lightcurve_mcmc(
        lc, ShockCooling3(lc), priors, p_lo=SC3_LO, p_up=SC3_UP, nwalkers=SC3_WALKERS,
        nsteps=300, nsteps_burnin=0, seed=8, quiet=True))
    parts, busy = time_split(prof, wall, {"half-steps": ("stretch_half_step",),
                                          "initial state": ("logpost_warp",)})
    for k in ("bandflux", "sc3_logpost", "sc3_half_step"):
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the SC3 path: {launches}")
    if launches["sc3_half_step"] != 2 * (200 + 200) + 2 * 300:
        raise AssertionError(f"9a and 9b make 1400 SC3 half-steps, not {launches}")
    evals = SC3_WALKERS * 300
    phase("SC3 main path 9b", f"lightcurve_mcmc ShockCooling3 {SC3_WALKERS} walkers x 300 "
          f"steps: mean acceptance {acc:.4f} (JAX float64 CPU {SC3_ACCEPTANCE_REF:.4f} +- 0.01), "
          f"medians {fmt(med)}, {elapsed:.3f} s end to end incl. setup and chain readback, "
          f"{evals / elapsed:.4e} log-posterior evals/s (information only, on {smi}); "
          f"evaluate on the card at the medians: chi2/dof {chi2_dof:.2f} (the JAX CPU probe's "
          f"best draw: ~{SC3_CHI2_PROBE:.0f}); profiled run (seed 8) {wall:.4f} s, device busy "
          f"{busy:.4f} s (idle share {1 - busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
          + f"; launches on 9a and 9b {launches}")

    # 9c: the acceptance at matched seeds against the JAX package's
    mean, err, acc = seed_acceptance(lambda seed: lightcurve_mcmc(
        lc, ShockCooling3(lc), priors, p_lo=SC3_LO, p_up=SC3_UP, nwalkers=SC3_SEED_WALKERS,
        nsteps=300, nsteps_burnin=0, seed=seed, quiet=True), SC3_SEEDS)
    gap = mean - SC3_SEEDS_REF[0]
    if abs(gap) > 4 * np.hypot(err, SC3_SEEDS_REF[1]):
        raise AssertionError(f"9c: mean acceptance {mean:.5f} +- {err:.5f} against the JAX "
                             f"package's {SC3_SEEDS_REF[0]:.5f} +- {SC3_SEEDS_REF[1]:.5f}")
    phase("SC3 main path 9c", f"lightcurve_mcmc ShockCooling3 {SC3_SEED_WALKERS} walkers x 300 "
          f"steps, seeds {SC3_SEEDS[0]}-{SC3_SEEDS[-1]}: mean acceptance {mean:.5f} +- "
          f"{err:.5f} (per seed {fmt(acc)}) against the JAX package's float64 CPU "
          f"{SC3_SEEDS_REF[0]:.5f} +- {SC3_SEEDS_REF[1]:.5f} at the same seeds: difference "
          f"{gap:+.5f} = {gap / np.hypot(err, SC3_SEEDS_REF[1]):+.2f} combined standard errors")
    return launches


def bench_epochs(rng, dev):
    """The bench's synthetic epochs (bench.py:129-143): 256 blackbodies of
    T in [4, 20] kK, R in [1, 30] through U B g V r i with 5% errors, made
    with numpy and the port's planck_lnu; returns (packed, true T)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.filters import filtdict
    from lightcurve_fitting_tpu_torch.models.blackbody import planck_lnu
    from lightcurve_fitting_tpu_torch.ops.filterbank import FilterBank
    from lightcurve_fitting_tpu_torch.parallel.batched import pack_epochs
    from lightcurve_fitting_tpu_torch.utils.table import Table
    filts = [filtdict[n] for n in ["U", "B", "g", "V", "r", "i"]]
    bank = FilterBank(filts)
    nodes = torch.as_tensor(bank.emitted_nodes(0.0))
    epochs, truth = [], []
    for _ in range(BOL_EPOCHS):
        T, R = rng.uniform(4.0, 20.0), rng.uniform(1.0, 30.0)
        y = (bank.weights * planck_lnu(nodes, torch.tensor(T), torch.tensor(R)).numpy()).sum(-1)
        dy = 0.05 * np.abs(y)
        y = y + rng.normal(scale=dy)
        epochs.append(Table([filts, y, dy], names=["filter", "lum", "dlum"]))
        truth.append(T)
    return pack_epochs(epochs, bank, 0.0, device=dev), np.array(truth)


def bol_priors():
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior, UniformPrior
    return [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)]


def sn2016bkv_packed(dev):
    """The 65 epochs of >= 3 filters of the full SN 2016bkv light curve at
    res = 1 day, packed as calculate_bolometric packs them."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.bolometric import _prepare_epoch_seds
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.ops.filterbank import bank_for
    from lightcurve_fitting_tpu_torch.parallel.batched import pack_epochs
    lc = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    dmag = np.ma.MaskedArray(lc["dmag"])
    lc = lc[np.isfinite(np.ma.filled(dmag.astype(float), np.nan)) & np.ma.filled(dmag > 0, False)]
    with contextlib.redirect_stdout(io.StringIO()):     # per-epoch extinction notes
        groups = [g for g in _prepare_epoch_seds(lc, 1.0, ())
                  if len(set(g.where(nondet=False)["filter"])) >= 3]
    bank = bank_for(sorted({f for g in groups for f in g["filter"]}))
    return pack_epochs(groups, bank, META["redshift"], device=dev)


def epoch_params(rng, E, M):
    """Log-uniform (T, R) over and beyond the default priors (T in [0.5,
    150] kK against (1, 100), R in [0.005, 2000] against (0.01, 1000)),
    with T <= 0 in the first two of every epoch."""
    import numpy as np
    p = np.exp(rng.uniform(np.log([0.5, 0.005]), np.log([150.0, 2000.0]), size=(E, M, 2)))
    p[:, :2, 0] = [-1.0, 0.0]
    return p


def k4_repeats_the_half_step(ep, x0, seed):
    """K4's values at the states that two epoch half-steps left at u_acc = 0
    (every proposal inside the priors accepted) against the log-posteriors
    the half-steps stored, bit for bit, in each of K4's two forms; x0 (E, 2,
    half, ndim) the float32 walker state. Returns the accepts."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb
    E, _, half, ndim = x0.shape
    x = x0.clone()
    logp = ep(x.reshape(E, 2 * half, ndim)).reshape(E, 2, half).contiguous()
    g = torch.Generator(device=x.device).manual_seed(seed)
    acc = torch.zeros((E, 2, half), dtype=torch.int32, device=x.device)
    for h in (0, 1):
        u_z = torch.rand((E, 2, half), generator=g, device=x.device)
        j = torch.randint(0, half, (E, 2, half), generator=g, device=x.device)
        epoch_bb.stretch_half_step(ep, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0,
                                   n_accept=acc)
    xs = x.reshape(E, 2 * half, ndim)
    for form in ("warp", "thread"):
        if not torch.equal(epoch_bb._launch_k4(ep, xs, False, form)[0], logp.reshape(E, -1)):
            raise AssertionError(f"K4's {form} form: the initial state's values differ from "
                                 "the half-step's stored values")
    if not torch.equal(ep(xs), logp.reshape(E, -1)):
        raise AssertionError("K4: the initial state's values differ from the half-step's")
    return int(acc.sum())


def phase_k4(rng_seed=5):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb
    from lightcurve_fitting_tpu_torch.models import GaussianPrior
    from lightcurve_fitting_tpu_torch.parallel.batched import EpochPosterior
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(rng_seed)
    bench_packed, truth = bench_epochs(np.random.default_rng(0), dev)
    shapes = {"bench": (bench_packed, 512), "SN 2016bkv": (sn2016bkv_packed(dev), 32)}
    res, repeats = {}, {}
    n0 = kernels.LAUNCHES["epoch_logpost"] + kernels.LAUNCHES["epoch_logpost_grad"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            rel, grel = (1e-5, 1e-4) if label == "f32" else (1e-10, 1e-9)
            for (name, (packed, M)), sigma_type in itertools.product(
                    shapes.items(), (None, "relative", "absolute")):
                use_sigma = sigma_type is not None
                priors = bol_priors() + ([GaussianPrior(0.0, 10.0)] if use_sigma else [])
                ep = EpochPosterior(packed, priors, use_sigma=use_sigma,
                                    sigma_type=sigma_type or "relative")
                E = ep.n_epochs
                q = epoch_params(rng, E, M)
                if use_sigma:        # sigma in dy units, both signs (the prior is even)
                    q = np.concatenate([q, rng.uniform(-4.0, 6.0, size=(E, M, 1))], axis=-1)
                q = torch.as_tensor(q, device=dev)
                lp, grad = epoch_bb.log_posterior(ep, q, with_grad=True)
                lp0, _ = epoch_bb.log_posterior(ep, q)
                want = ep.plain(q)
                ll_scale, g_scale = ep.term_scales(q)
                fin = torch.isfinite(want)
                what = f"K4 {label} {name} sigma={sigma_type}"
                # the values' two forms, and a vector's value at another width
                forms = [epoch_bb._launch_k4(ep, q, False, f)[0] for f in ("warp", "thread")]
                if not all(torch.equal(lp0, v) for v in forms) or not torch.equal(
                        epoch_bb.log_posterior(ep, q[:, :32].contiguous())[0], lp0[:, :32]):
                    raise AssertionError(f"{what}: the value forms or widths differ in bits")
                r = 0.0
                for v in (lp0, lp):
                    if not torch.equal(torch.isneginf(v), torch.isneginf(want)):
                        raise AssertionError(f"{what}: -inf sets differ")
                    d = (v - want).abs()[fin]
                    r = max(r, float((d / ll_scale[fin]).max()))
                    if r > rel:
                        raise AssertionError(f"{what}: max |d|/scale {r:.3e} > {rel:.0e}")
                d = (lp0 - want).abs()[fin]
                qq = q.clone().requires_grad_(True)
                g_want, = torch.autograd.grad(ep.plain(qq).sum(), qq)
                ok = fin[..., None] & torch.isfinite(g_want)
                gr = ((grad - g_want).abs() / (g_scale + g_want.abs())).masked_fill(~ok, 0.0)
                gr = gr.amax(dim=(0, 1)).tolist()
                if max(gr) > grel:
                    raise AssertionError(f"{what}: gradient max |d|/scale per parameter "
                                         f"{fmt(gr)} > {grel:.0e}")
                res[(label, name, sigma_type)] = (float(d.max()), r, gr, int(fin.sum()), E * M)
                if name == "bench" and sigma_type in (None, "relative"):
                    # the initial state: the bench's 256 epochs x 32 float32 walkers
                    x0 = np.abs(np.stack([truth, np.full(E, 10.0)], axis=1)[:, None, None, :]
                                * (1 + 0.3 * rng.normal(size=(E, 2, BOL_WALKERS // 2, 2))))
                    if use_sigma:
                        x0 = np.concatenate([x0, rng.uniform(0.5, 3.0, x0.shape[:-1] + (1,))],
                                            axis=-1)
                    x0 = torch.as_tensor(x0, device=dev).float().contiguous()
                    repeats[(label, sigma_type)] = k4_repeats_the_half_step(ep, x0, rng_seed)
                if label == "f32" and name == "bench" and not use_sigma:
                    k_ms = cuda_ms(lambda: epoch_bb.log_posterior(ep, q))
                    kg_ms = cuda_ms(lambda: epoch_bb.log_posterior(ep, q, with_grad=True))
                    q8 = q[:, :BOL_STARTS].contiguous()   # the parent's Adam step's width
                    kg8 = (cuda_ms(lambda: epoch_bb.log_posterior(ep, q8, with_grad=True)),
                           device_ms(lambda: epoch_bb.log_posterior(ep, q8, with_grad=True),
                                     "epoch_logpost_kernel", 20, 1)[0])
                    xi = x0.reshape(E, BOL_WALKERS, 2)
                    dev_ms = {(w, f): device_ms(lambda: epoch_bb._launch_k4(ep, qw, False, f),
                                                "logpost", 20, 1)[0]
                              for w, qw in (("cloud", q), ("init", xi))
                              for f in ("warp", "thread")}
                    forms_run = {w: epoch_bb.k4_form(qw.shape[0] * qw.shape[1],
                                                     torch.cuda.get_device_properties(dev)
                                                     .multi_processor_count,
                                                     epoch_bb.longest_terms(ep))
                                 for w, qw in (("cloud", q), ("init", xi))}
                    plain_ms = cuda_ms(lambda: ep.plain(q), repeats=5)
                    ops = epoch_eval_ops(ep) * M
                    k4_bound = bound_fields(ops, q.numel() * 8 + E * M * 8
                                            + 2 * 4 * ep.nodes.numel())
        finally:
            config.set_compute_dtype(config.AUTO)
    launches = kernels.LAUNCHES["epoch_logpost"] + kernels.LAUNCHES["epoch_logpost_grad"] - n0
    parts = "; ".join(f"{lab} {name} sigma={st} ({v[4]} vectors, {v[3]} finite): max |d| "
                      f"{v[0]:.3e}, max |d|/scale {v[1]:.2e} (values, and with the gradient), "
                      f"gradient max |d|/scale per parameter "
                      f"[{', '.join(f'{x:.2e}' for x in v[2])}]"
                      for (lab, name, st), v in res.items())
    phase("K4", f"{parts}; -inf sets equal; the values' warp and thread forms bit-equal, and "
          f"at width 32 the values at 512; at the states two epoch half-steps accepted "
          f"(u_acc = 0, {BOL_EPOCHS} x {BOL_WALKERS}) both forms give the stored values bit for "
          f"bit (" + ", ".join(f"{lab} sigma={st}: {n} accepts" for (lab, st), n in
                               repeats.items()) + f"); {launches} comparison launches; K4's "
          f"values {k_ms:.4f} ms (events; the {forms_run['cloud']} form) at {BOL_EPOCHS} epochs "
          f"x 512 (f32, no intrinsic scatter; with the gradient {kg_ms:.4f} ms) vs plain "
          f"{plain_ms:.4f} ms, bound {k4_bound['bound_ms']:.4f} ms ({k4_bound['bound_by']}); "
          "device time " + ", ".join(f"{f} {v:.4f} ms at the {w}" for (w, f), v in
                                     dev_ms.items())
          + f" (the rule runs the {forms_run['init']} form at the initial state's "
          f"{BOL_EPOCHS} x {BOL_WALKERS}); with the gradient at {BOL_EPOCHS} x {BOL_STARTS} "
          f"(the parent's Adam step) {kg8[0]:.4f} ms (events; the profiler's device time "
          f"{kg8[1]:.4f} ms)")
    return {"max_abs_err": res[("f32", "bench", None)][0], "ms": k_ms, "plain_ms": plain_ms,
            **k4_bound}


def polish_ops(ep, n_starts, n_iter):
    """K4p's operations: each start's n_iter evaluations of the value and
    gradient (the native terms with dS/dT, ~30 flops a band for the
    residual and its derivatives, the priors' log and division), its
    bijection and Adam step (~15 flops, the sigmoid's exp and division,
    Adam's two divisions and square root a parameter), then its last
    value."""
    terms = float((ep.n_native * ep.mask).sum())
    bands = float(ep.mask.sum())
    E, ndim = ep.n_epochs, len(ep.priors)
    step = terms * PLANCK_TERM_GRAD + bands * 30 + E * (2 * SFU + ndim * (15 + 5 * SFU))
    last = terms * PLANCK_TERM + bands * 10 + E * (SFU + ndim * 2 * SFU)
    return n_starts * (n_iter * step + last)


def check_polish(name, got, want, rel):
    """K4p's (centers, alive, last iterates, their log-posteriors) against
    map_polish_plain's: the same alive set; centers within ``rel`` relative
    where both keep the same start; where they keep different starts, a
    near-tie (the plain log-posteriors of the two within 1e-5 of their
    magnitude). Returns (the largest relative and absolute center
    differences where the starts agree, the near-ties, the largest |du| of
    the last iterates)."""
    import torch
    c, alive, u, lp = got
    cp, alive_p, up, lpp = want
    if not torch.equal(alive, alive_p):
        raise AssertionError(f"{name}: alive sets differ at {int((alive != alive_p).sum())} "
                             "epochs")
    def best(v):
        return torch.argmin(torch.where(torch.isfinite(v), -v, torch.full_like(v, torch.inf)),
                            dim=1)
    b, bp = best(lp), best(lpp)
    rows = torch.arange(len(b), device=b.device)
    same = (b == bp) & alive
    d = (c - cp).abs()[same]
    r = (d / cp.abs()[same]) if d.numel() else d
    max_r = float(r.max()) if r.numel() else 0.0
    if max_r > rel:
        raise AssertionError(f"{name}: centers differ by {max_r:.3e} relative > {rel:.0e}")
    tie = ~same & alive
    gap = (lpp[rows, b] - lpp[rows, bp]).abs()
    if bool((gap > 1e-5 * lpp[rows, bp].abs())[tie].any()):
        raise AssertionError(f"{name}: a different start kept away from a near-tie")
    fin = torch.isfinite(lp) & torch.isfinite(lpp)
    du = (u - up).abs().amax(dim=-1)[fin]
    return (max_r, float(d.max()) if d.numel() else 0.0, int(tie.sum()),
            float(du.max()) if du.numel() else 0.0)


def phase_k4p(seed=1):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb
    from lightcurve_fitting_tpu_torch.parallel.batched import (EpochPosterior, _generator,
                                                               _polish_starts)
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    packed = bench_epochs(np.random.default_rng(0), dev)[0]
    res, times = {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            ep = EpochPosterior(packed, bol_priors())
            cloud_u = torch.rand((ep.n_epochs, 512, 2), generator=_generator(dev, seed, -1),
                                 device=dev, dtype=torch.float64)
            bounds, u0 = _polish_starts(ep, cloud_u, BOL_STARTS)

            def polish():
                return epoch_bb.map_polish(ep, u0, bounds, BOL_ITER, return_starts=True)
            got = polish()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = epoch_bb.map_polish_plain(ep, u0, bounds, BOL_ITER, return_starts=True)
            end.record()
            torch.cuda.synchronize()
            res[label] = check_polish(f"K4p {label}", got, want, POLISH_REL[label])
            x8 = bounds.to_bounded(u0).contiguous()   # the parent's first Adam step's input
            times[label] = (cuda_ms(polish, repeats=5),
                            float(np.mean(device_ms(polish, "epoch_map_polish", 5, 2))),
                            start.elapsed_time(end),
                            device_ms(lambda: epoch_bb.log_posterior(ep, x8, with_grad=True),
                                      "epoch_logpost_kernel", 20, 1)[0])
            nbytes = (2 * ep.nodes.element_size() * ep.nodes.numel() + u0.numel() * 8
                      + ep.n_epochs * (2 * 8 + 1))
            if label == "f32":
                k4p_bound = bound_fields(polish_ops(ep, BOL_STARTS, BOL_ITER), nbytes)
            else:
                k4p_bound64 = bound_fields(polish_ops(ep, BOL_STARTS, BOL_ITER), nbytes,
                                           rate=FP64_FLOPS)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("K4p", f"the Adam polish of {BOL_EPOCHS} bench epochs x {BOL_STARTS} starts x "
          f"{BOL_ITER} steps in one launch (a block per epoch, a warp per start) against "
          "map_polish_plain on the card: "
          + "; ".join(f"{lab}: alive sets equal, centers max relative difference {v[0]:.3e} "
                      f"(max |d| {v[1]:.3e}; <= {POLISH_REL[lab]:.0e}), {v[2]} epochs keep "
                      f"another start at a near-tie, last iterates max |du| {v[3]:.3e}; K4p "
                      f"{times[lab][0]:.4f} ms (events; device {times[lab][1]:.4f} ms) vs plain "
                      f"{times[lab][2]:.1f} ms; the parent's 300 launches of K4 with the gradient "
                      f"at {BOL_EPOCHS} x {BOL_STARTS}, device {times[lab][3]:.4f} ms each"
                      for lab, v in res.items())
          + f"; bound {k4p_bound['bound_ms']:.4f} ms f32 ({k4p_bound['bound_by']}), "
          f"{k4p_bound64['bound_ms']:.4f} ms f64")
    return {"max_abs_err": res["f32"][1], "ms": times["f32"][0], "plain_ms": times["f32"][2],
            **k4p_bound}


def phase_epoch_half_step(seed=6):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import common, epoch_bb
    from lightcurve_fitting_tpu_torch.parallel.batched import EpochPosterior
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    E, half = BOL_EPOCHS, BOL_WALKERS // 2
    rng = np.random.default_rng(seed)
    packed, truth = bench_epochs(np.random.default_rng(0), dev)
    x0 = np.abs(np.stack([truth, np.full(E, 10.0)], axis=1)[:, None, None, :]
                * (1 + 0.3 * rng.normal(size=(E, 2, half, 2))))
    x0 = torch.as_tensor(x0, device=dev).float().contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand((E, 2, half), generator=g, device=dev)
    j = torch.randint(0, half, (E, 2, half), generator=g, device=dev)
    u_acc = torch.rand((E, 2, half), generator=g, device=dev)
    res, names = {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            rel = 1e-5 if label == "f32" else 1e-10
            ep = EpochPosterior(packed, bol_priors())
            l0 = ep(x0.reshape(E, 2 * half, 2)).reshape(E, 2, half)
            max_r, max_abs, n_ties, n_acc = 0.0, 0.0, 0, 0
            for h in (0, 1):
                xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
                ak = torch.zeros((E, 2, half), dtype=torch.int32, device=dev)
                ap = torch.zeros_like(ak)
                cx = torch.empty_like(x0)
                cl = torch.empty((E, 2, half), device=dev)
                epoch_bb.stretch_half_step(ep, xk, lk, h, u_z, j, u_acc, 2.0, cx, cl, ak)
                epoch_bb.stretch_half_step_plain(ep.plain, xp, lpp, h, u_z, j, u_acc, 2.0,
                                                 n_accept=ap)
                torch.cuda.synchronize()
                agree = ak[:, h] == ap[:, h]
                y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
                lp_y = ep.plain(y)
                scale_y, _ = ep.term_scales(y)
                gap = (torch.log(u_acc[:, h]).double() - (torch.log(z) + lp_y - l0[:, h])).abs()
                tie_ok = gap <= rel * scale_y
                if not bool((agree | tie_ok).all()):
                    raise AssertionError(f"epoch half-step {label} h={h}: "
                                         f"{int((~agree & ~tie_ok).sum())} accept flags differ "
                                         "away from near-ties")
                if not torch.equal(xk[:, h][agree], xp[:, h][agree]):
                    raise AssertionError(f"epoch half-step {label} h={h}: new states differ "
                                         "where the flags agree")
                if not torch.equal(xk[:, 1 - h], x0[:, 1 - h]) \
                        or not torch.equal(cx[:, h], xk[:, h]) \
                        or not torch.equal(cl[:, h], lk[:, h].float()):
                    raise AssertionError(f"epoch half-step {label} h={h}: wrong half or chain "
                                         "slot written")
                moved = agree & (ak[:, h] == 1)
                d = (lk[:, h] - lpp[:, h]).abs()[moved]
                r = d / scale_y[moved]
                if r.numel() and float(r.max()) > rel:
                    raise AssertionError(f"epoch half-step {label} h={h}: new log-posteriors "
                                         f"{float(r.max()):.3e} of the term scale > {rel:.0e}")
                max_r = max(max_r, float(r.max()) if r.numel() else 0.0)
                max_abs = max(max_abs, float(d.max()) if d.numel() else 0.0)
                n_ties += int((~agree).sum())
                n_acc += int(ak[:, h].sum())
            xk, lk = x0.clone(), l0.clone()
            ak = torch.zeros((E, 2, half), dtype=torch.int32, device=dev)

            def step():
                epoch_bb.stretch_half_step(ep, xk, lk, 0, u_z, j, u_acc, 2.0, n_accept=ak,
                                           check_partners=False)
            names[label] = expect_kernel(step, "stretch_half_step_kernel", "EpochBBModel")
            res[label] = (n_acc, n_ties, max_r, cuda_ms(step),
                          device_ms(step, "stretch_half_step_kernel", 20, 1)[0], max_abs)
            if label == "f32":
                xp, lpp = x0.clone(), l0.clone()
                plain_ms = cuda_ms(lambda: epoch_bb.stretch_half_step_plain(
                    ep.plain, xp, lpp, 0, u_z, j, u_acc, 2.0), repeats=5)
                hs_bound = bound_fields(epoch_eval_ops(ep) * half
                                        + E * half * PROPOSAL,
                                        E * half * (2 * 2 * 4 + 8 + 16 + 4)
                                        + E * half * (2 * 4 + 8 + 4) + 2 * 4 * ep.nodes.numel())
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("epoch half-step", f"{names['f32']}: half-steps h=0,1 of {E} epochs x {half} walkers "
          "(f32 state, f64 logp, a warp per walker) "
          + "; ".join(f"{lab}: {v[0]} accepts, flags agree except {v[1]} near-ties, new states "
                      f"bit-equal where they agree, new-logp max |d| {v[5]:.3e}, max "
                      f"|d|/scale {v[2]:.2e} (<= 1e-5 / 1e-10); kernel "
                      f"{v[3]:.4f} ms (events; the profiler's device time {v[4]:.4f} ms)"
                      for lab, v in res.items())
          + f"; plain {plain_ms:.4f} ms per half-step (f32), bound {hs_bound['bound_ms']:.5f} "
          f"ms ({hs_bound['bound_by']})")
    return {"max_abs_err": res["f32"][5], "ms": res["f32"][3], "plain_ms": plain_ms, **hs_bound}


K4S_CUTOFF = 600.0   # THz, a cutoff frequency inside the pseudobolometric grid


def k4s_term_ulps(dev):
    """K4s's float32 Planck term on a one-node grid (nu 500 THz, w = 1, R =
    1) over T such that x = c1 nu / T runs from 0.05 to 87, against 1 /
    expm1 in float64 at the kernel's own rounded exponent (t = b / T on the
    special-function unit, t in [-125, -0.25 log2(e)]; c1 nu / T elsewhere),
    in ulp (2^-23 relative). Fails beyond 3 / (1 - exp(-x)) + 3 ulp on the
    unit (ex2's error grown by the cancellation in 1 - q, then rcp and the
    three products' roundings) or 3 elsewhere (expm1, the division, the
    products), unless both forms ran, or unless T <= 0 gives 0. Returns
    (max ulp on the unit, max ulp / bound there, max ulp elsewhere)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core.constants import c1, c2
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb

    f32 = np.float32
    nu = 500.0
    T = np.append(f32(c1 * nu) / np.geomspace(0.05, 87.0, 4096), [0.0, -1.0]).astype(f32)
    chain = torch.as_tensor(np.stack([T, np.ones_like(T)], axis=-1)[:, None, None, :],
                            device=dev)
    one = torch.full((1,), nu, dtype=torch.float64, device=dev)
    got = epoch_bb.summary_samples(chain, one, torch.ones_like(one), np.inf, torch.float32)
    got = got[0, 3].cpu().numpy().astype(np.float64)
    if not (got[-2:] == 0).all():
        raise AssertionError(f"K4s: T <= 0 must give 0, got {got[-2:]}")
    T, got = T[:-2], got[:-2]
    inv_T = (f32(1) / T).astype(f32)
    t = (f32(-c1 * nu * 1.4426950408889634) * inv_T).astype(f32)
    sfu = (t <= f32(-0.36067376022224085)) & (t >= f32(-125.0))
    if not 0 < sfu.sum() < sfu.size:
        raise AssertionError(f"K4s: {sfu.sum()} of {sfu.size} terms on the unit; both forms "
                             "must run")
    x = np.where(sfu, -t.astype(np.float64) * np.log(2.0),
                 (f32(f32(c1) * f32(nu)) * inv_T).astype(f32).astype(np.float64))
    want = float(f32(c2)) * float(f32(nu ** 3)) / np.expm1(x)
    ulps = np.abs(got - want) / (want * 2.0 ** -23)
    bound = np.where(sfu, 3.0 / -np.expm1(-x) + 3.0, 3.0)
    if not (ulps <= bound).all():
        i = int((ulps / bound).argmax())
        raise AssertionError(f"K4s: the float32 term {ulps[i]:.2f} ulp from 1 / expm1 at x = "
                             f"{x[i]:.4f} (bound {bound[i]:.2f})")
    return float(ulps[sfu].max()), float((ulps / bound)[sfu].max()), float(ulps[~sfu].max())


def phase_k4s_k5(seed=7):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.bolometric import _pseudo_grid
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb, quantile as kq
    from lightcurve_fitting_tpu_torch.ops.quantile import percentile_f32_plain

    dev = torch.device("cuda")
    E, nw, steps = BOL_EPOCHS, BOL_WALKERS, BOL_STEPS
    rng = np.random.default_rng(seed)
    centre = np.exp(rng.uniform(np.log([4.0, 1.0]), np.log([20.0, 30.0]), size=(E, 2)))
    chain = np.abs(centre[None, :, None, :] * (1 + 0.05 * rng.normal(size=(steps, E, nw, 2))))
    chain = torch.as_tensor(chain, device=dev).float().contiguous()
    nu = torch.as_tensor(_pseudo_grid(), device=dev)
    w = torch.ones_like(nu)
    w[0] = w[-1] = 0.5
    res = {}
    for cutoff in (K4S_CUTOFF, np.inf):   # the rows without one kept for K5
        rows = epoch_bb.summary_samples(chain, nu, w, cutoff, torch.float32)
        want = epoch_bb.summary_samples_plain(chain, nu, w, cutoff, torch.float32)
        if not torch.equal(rows[:, :3], want[:, :3]):
            raise AssertionError(f"K4s (cutoff {cutoff}): T, R or (R T^2)^2 differ from the "
                                 "plain version")
        d = (rows[:, 3] - want[:, 3]).abs().double()
        r = float((d / want[:, 3].abs().double()).max())
        if r > 1e-5:
            raise AssertionError(f"K4s (cutoff {cutoff}): integral max relative difference "
                                 f"{r:.3e} > 1e-5")
        res[cutoff] = (float(d.max()), r)
    ulps = k4s_term_ulps(dev)
    s_ms = cuda_ms(lambda: epoch_bb.summary_samples(chain, nu, w, np.inf, torch.float32))
    s_plain_ms = cuda_ms(lambda: epoch_bb.summary_samples_plain(chain, nu, w, np.inf,
                                                                torch.float32), repeats=5)
    S, F = steps * nw, nu.shape[0]
    s_bound = bound_fields(E * S * (F * PLANCK_TERM + 5),
                           chain.numel() * 4 + rows.numel() * 4)
    phase("K4s", f"{E} epochs x {S} samples x {F} frequencies: T, R, (R T^2)^2 equal, the "
          "integral " + "; ".join(f"cutoff {c} max |d| {v[0]:.3e} W/Hz (max relative {v[1]:.2e} "
                                  "<= 1e-5)" for c, v in res.items())
          + f"; the float32 term on the special-function unit (x 0.25-86.6) within "
          f"{ulps[0]:.2f} ulp of 1 / expm1 at its exponent ({ulps[1]:.3f} of its bound), "
          f"elsewhere (x 0.05-0.25, 86.6-87) within {ulps[2]:.2f} ulp (bound 3); kernel "
          f"{s_ms:.4f} ms vs plain "
          f"{s_plain_ms:.4f} ms (f32), bound {s_bound['bound_ms']:.4f} ms "
          f"({s_bound['bound_by']})")

    flat = want.reshape(E * 4, S).contiguous()
    q = [16.0, 50.0, 84.0]
    got = kq.percentile_rows(flat, q)
    ref = percentile_f32_plain(flat, q, axis=1)
    if not torch.equal(got, ref):
        raise AssertionError(f"K5: {int((got != ref).sum())} percentiles differ from the plain "
                             "version")
    qs = torch.tensor([0.16, 0.50, 0.84], device=dev)
    lib = torch.quantile(flat, qs, dim=1, interpolation="linear")
    lib_err = float(((lib.double() - got).abs() / got.abs()).max())
    p_ms = cuda_ms(lambda: kq.percentile_rows(flat, q))
    p_plain_ms = cuda_ms(lambda: percentile_f32_plain(flat, q, axis=1), repeats=5)
    lib_ms = cuda_ms(lambda: torch.quantile(flat, qs, dim=1, interpolation="linear"))
    p_bound = bound_fields(E * 4 * (32 * 2 * len(q) * S + 4 * S),
                           flat.numel() * 4 + len(q) * E * 4 * 8, lib_ms)
    phase("K5", f"{E * 4} rows x {S}: percentiles 16/50/84 bit-equal to the plain version "
          f"(torch.quantile in f32 differs by up to {lib_err:.1e} relative); kernel {p_ms:.4f} ms vs "
          f"plain {p_plain_ms:.4f} ms vs torch.quantile {lib_ms:.4f} ms, bound "
          f"{p_bound['bound_ms']:.4f} ms ({p_bound['bound_by']})")
    return ({"max_abs_err": float(d.max()), "ms": s_ms, "plain_ms": s_plain_ms, **s_bound},
            {"max_abs_err": 0.0, "ms": p_ms, "plain_ms": p_plain_ms, **p_bound})


BOL_KERNELS = ("epoch_logpost", "epoch_map_polish", "epoch_half_step", "epoch_summary",
               "percentile")
# the JAX package's mean acceptance, float64 on the CPU, at the bench shape
# over seeds 1-8 (each seed's centers and guesses after the previous seed's,
# as 13b draws them), and its standard error
# (tests/test_torch_batched.py::jax_bench_acceptance)
BOL_SEEDS = tuple(range(1, 9))
BOL_ACCEPTANCE_SEEDS_REF = (0.7061326503753662, 0.0002736880704670472)
# the bolometric path's kernels in a profile (the first match wins)
BOL_SPLIT = {"K4 (cloud, initial state)": ("epoch_logpost", "logpost_warp_kernel"),
             "K4p (Adam polish)": ("epoch_map_polish",),
             "epoch half-step": ("stretch_half_step",), "K4s": ("epoch_summary",),
             "K5": ("percentile",)}


def bol_launches_ok(launches, what, centerings=1):
    """Every bolometric kernel ran, K4p once a centering, and K4's gradient
    form never (the polish runs in K4p)."""
    if any(launches[k] == 0 for k in BOL_KERNELS) or launches["epoch_logpost_grad"] != 0 \
            or launches["epoch_map_polish"] != centerings:
        raise AssertionError(f"{what}: a kernel not launched, K4p not once a centering, or K4's "
                             f"gradient form launched: {launches}")


def phase_bolometric_main_path(smi):
    import warnings
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.bolometric import calculate_bolometric, _pseudo_grid
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.parallel.batched import (batched_blackbody_mcmc,
                                                               batched_map_centers)

    lc = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    notes = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(notes):
        warnings.simplefilter("ignore")
        t = calculate_bolometric(lc, batch_mode=True, save_corners=False, nwalkers=32, seed=7)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    bol_launches_ok(launches, "13a")
    temp, temp_mcmc = np.asarray(t["temp"], float), np.asarray(t["temp_mcmc"], float)
    if len(t) != 65 or not np.isfinite(temp_mcmc).all() \
            or not np.isfinite(np.asarray(t["L_mcmc"], float)).all():
        raise AssertionError(f"13a: {len(t)} rows (65 expected) or non-finite MCMC columns")
    ok = np.isfinite(temp)
    dev_t = np.abs(temp_mcmc[ok] - temp[ok]) / temp[ok]
    def col(name):
        return np.ma.filled(np.ma.MaskedArray(t[name]).astype(float), np.nan)

    cols = {c: col(c) for c in ("MJD", "temp", "temp_mcmc", "dtemp_mcmc0", "dtemp_mcmc1",
                                "radius_mcmc", "L_mcmc", "L_bol_mcmc")}
    rows = "\n".join(
        f"  MJD {cols['MJD'][i]:.3f} T {cols['temp'][i]:8.4f} T_mcmc {cols['temp_mcmc'][i]:8.4f} "
        f"(-{cols['dtemp_mcmc0'][i]:.4f} +{cols['dtemp_mcmc1'][i]:.4f}) R_mcmc "
        f"{cols['radius_mcmc'][i]:8.4f} L_mcmc {cols['L_mcmc'][i]:.4e} L_bol_mcmc "
        f"{cols['L_bol_mcmc'][i]:.4e}" for i in range(len(t)))
    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("ignore")
        wall_a, prof_a = profiled(lambda: calculate_bolometric(
            lc, batch_mode=True, save_corners=False, nwalkers=32, seed=7))
    parts_a, busy_a = time_split(prof_a, wall_a, BOL_SPLIT)
    phase("bolometric main path 13a", f"calculate_bolometric(batch_mode=True, "
          f"save_corners=False, nwalkers=32, seed=7) on the full SN 2016bkv light curve: "
          f"{len(t)} rows in {elapsed:.3f} s (host stages included; on {smi}); median "
          f"|temp_mcmc - temp| / temp {np.median(dev_t):.4f} over {ok.sum()} curve_fit rows; "
          f"{len(notes.getvalue().splitlines())} host notes hidden; launches {launches}; a "
          f"profiled run {wall_a:.4f} s, device busy {busy_a:.4f} s (idle share "
          f"{1 - busy_a / wall_a:.3f}): " + ", ".join(f"{k} {v:.4f} s" for k, v in parts_a.items())
          + f"\n{rows}")

    # 13b: the bench shape, timed
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    packed, truth = bench_epochs(rng, dev)
    priors = bol_priors()
    summaries = {"z": 0.0, "pseudo_nu": _pseudo_grid()}

    def run(seed, stages=None):
        """One bench run; ``stages`` collects the seconds of the centering
        and of the MCMC with its summaries (host clock to a synchronize)."""
        t0 = time.perf_counter()
        centers = batched_map_centers(packed, priors, seed=seed)
        t1 = time.perf_counter()
        guesses = rng.normal(size=(BOL_EPOCHS, BOL_WALKERS, 2)) * 0.5 + centers[:, None, :]
        guesses[guesses <= 0.0] = 1.0
        out = batched_blackbody_mcmc(packed, priors, guesses, BOL_WALKERS, BOL_BURNIN,
                                     BOL_STEPS, seed=seed, summaries=summaries,
                                     return_chains=False)
        if stages is not None:
            stages.append((t1 - t0, time.perf_counter() - t1))
        return out

    kernels.reset_launch_counts()
    _, acc, summ = run(1)          # the reference's seed; also the warm-up
    launches_b = dict(kernels.LAUNCHES)
    accs = {1: float(np.mean(acc))}
    times, stages = [], []
    for seed in range(2, 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs[seed] = float(np.mean(run(seed, stages)[1]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # the device's busy share over one more run: kernel time from the profiler
    out = []
    wall, prof = profiled(lambda: out.append(run(7)))
    accs[7] = float(np.mean(out[0][1]))
    parts, busy = time_split(prof, wall, BOL_SPLIT)
    for seed in BOL_SEEDS[7:]:
        accs[seed] = float(np.mean(run(seed)[1]))
    acc_mean = accs[1]
    if abs(acc_mean - BOL_ACCEPTANCE_REF) > 0.02:
        raise AssertionError(f"13b: mean acceptance {acc_mean:.4f} not within 0.02 of the JAX "
                             f"package's {BOL_ACCEPTANCE_REF:.4f}")
    if not np.isfinite(summ).all():
        raise AssertionError("13b: non-finite summaries")
    bol_launches_ok(launches_b, "13b")
    a_seeds = np.array([accs[k] for k in BOL_SEEDS])
    m_port, se_port = float(a_seeds.mean()), float(a_seeds.std(ddof=1) / np.sqrt(len(a_seeds)))
    m_jax, se_jax = BOL_ACCEPTANCE_SEEDS_REF
    z = abs(m_port - m_jax) / float(np.hypot(se_port, se_jax))
    if z > 4:
        raise AssertionError(f"13b: mean acceptance over seeds 1-8 {m_port:.5f} +- "
                             f"{se_port:.5f}, {z:.2f} combined standard errors from the JAX "
                             f"package's {m_jax:.5f} +- {se_jax:.5f}")
    inside = float(np.mean((summ[:, 0, 0] <= truth) & (truth <= summ[:, 0, 2])))
    med = float(np.median(times))
    phase("bolometric main path 13b", f"{BOL_EPOCHS} epochs x {BOL_WALKERS} walkers x "
          f"{BOL_BURNIN}+{BOL_STEPS} steps (centering, MCMC, device summaries): "
          f"{BOL_EPOCHS / med:.2f} epochs/s (median of 5 runs {med:.4f} s, runs "
          f"{', '.join(f'{x:.4f}' for x in times)}; on {smi}); mean acceptance {acc_mean:.4f} "
          f"(JAX float64 CPU {BOL_ACCEPTANCE_REF:.4f} +- 0.02); seeds 1-8: "
          f"{', '.join(f'{a:.5f}' for a in a_seeds)}, mean {m_port:.5f} +- {se_port:.5f} "
          f"against the JAX package's {m_jax:.5f} +- {se_jax:.5f} ({z:.2f} combined standard "
          f"errors); true T inside the 16-84 interval for {inside:.3f} of the epochs; stages "
          f"(median): centering {np.median([a for a, _ in stages]):.4f} s, MCMC and summaries "
          f"{np.median([b for _, b in stages]):.4f} s; profiled run (seed 7) {wall:.4f} s, "
          f"device busy {busy:.4f} s (idle share {1 - busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
          + f"; launches per run {launches_b}")
    return launches


# the evidence bench shape (bench.py:189-232) and what its log Z is held to:
# the JAX package's bench record (BENCH_r05.json "evidence_ladder"; a
# statistical result, not a speed) and the JAX package's float64 CPU runs of
# the same configuration (tests/test_torch_evidence.py::jax_bench_evidence)
EV_WALKERS, EV_RUNGS, EV_STEPS, EV_BURNIN = 4096, 16, 150, 150
EV_LOGZ_BENCH = (-12961.48, 0.35)
EV_LOGZ_JAX = {1: (-12961.726035036969, 0.35948034181695665),
               2: (-12961.6943474302, 0.36863427679266486)}
LADDER_KERNELS = ("tempered_half_step", "ladder_init", "replica_swap", "rung_block_terms")
# K6c's shapes (rungs, walkers, ndim): the evidence of SC2 (16a) and CS2 (24c),
# compare_models on synthetic photometry (16c), the PT fits of SC2 (16b) and
# CS2 (24c)
K6C_SHAPES = ((EV_RUNGS + 1, EV_WALKERS, 4), (EV_RUNGS + 1, 32, 4), (7, 32, 4),
              (EV_RUNGS + 1, EV_WALKERS, 7), (7, 64, 7))
# K6d's one-split shapes (steps, rungs, walkers): the production log L of the
# PT fits of SC2 (16b) and CS2 (24c) and of compare_models (16c)
K6D_ONE_SPLIT_SHAPES = ((250, 7, 32), (250, 17, 32), (250, 7, 64))


def window_states(rng, lo, up, n, outside=0.0):
    """n parameter vectors from the window [lo, up], a share ``outside`` of
    them with one coordinate at -1 or just above its prior's upper bound."""
    import numpy as np
    p = rng.uniform(lo, up, size=(n, len(lo)))
    out = rng.choice(n, int(n * outside), replace=False)
    dims = rng.integers(0, len(lo), size=out.size)
    p[out, dims] = np.where(rng.random(out.size) < 0.5, -1.0, np.asarray(up)[dims] + 60.0)
    return p


def ladder_setup(model, lc, priors, lo, up, R, W, rng, dev, outside=0.0):
    """(LogPosterior, offset, scale, float32 rescaled ladder state (R, 2,
    W/2, ndim)) as ``lightcurve_evidence`` gives them on CUDA."""
    import torch
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    lp = make_log_posterior(model, lc, priors, device=dev)
    kw = _state_rescaling("auto", lo, up, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    q = (window_states(rng, lo, up, R * W, outside) - off) / sc
    x = torch.as_tensor(q.reshape(R, 2, W // 2, len(lo)), device=dev).to(kw["dtype"])
    return lp, off, sc, x.contiguous()


# K6a over SC2's widths, (rungs, half): the evidence (16a) and the PT fit (16b)
K6A_LADDERS = ((EV_RUNGS + 1, EV_WALKERS // 2), (7, 16))


def phase_k6a(lc, lcf, seed=8):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import common, ladder
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, ShockCooling3
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    n0 = kernels.LAUNCHES["tempered_half_step"]
    lads, a_ms, a_bounds = {}, {}, {}
    rng = np.random.default_rng(seed)
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            for rungs, half in K6A_LADDERS:
                lp, off, sc, x0 = ladder_setup(ShockCooling2(lc), lc, flagship_priors(), P_LO,
                                               P_UP, rungs, 2 * half, rng, dev)
                lads[(label, rungs, half)] = check_ladder(
                    f"SC2 ladder {label} {rungs} x {half}", lp, off, sc, x0, seed,
                    1e-5 if label == "f32" else 1e-10)
                pri0, ll0 = ladder.ladder_init(lp, x0, off, sc)
                betas = torch.as_tensor(make_beta_ladder(rungs - 1), device=dev)
                g = torch.Generator(device=dev)
                g.manual_seed(seed)
                shape = (rungs, 2, half)
                u_z = torch.rand(shape, generator=g, device=dev)
                j = torch.randint(0, half, shape, generator=g, device=dev)
                u_acc = torch.rand(shape, generator=g, device=dev)
                if rungs == K6A_LADDERS[0][0]:
                    # u_acc = 0: every proposal inside the priors accepted, its
                    # log pi + log L against K7's value at the new state
                    xs, ps, ls = x0.clone(), pri0.clone(), ll0.clone()
                    acc = torch.zeros(shape, dtype=torch.int32, device=dev)
                    ladder.tempered_half_step(lp, xs, ps, ls, betas, 0, u_z, j,
                                              torch.zeros_like(u_z), 2.0, off, sc, acc)
                    moved = acc[:, 0] == 1
                    k7 = kernels.log_posterior_and_grad(
                        lp, common.absolute_params(xs[:, 0], off, sc).reshape(-1, 4))[0]
                    d = ((ps[:, 0] + ls[:, 0]).reshape(-1) - k7)[moved.reshape(-1)].abs()
                    lads[(label, rungs, half)] += (int(moved.sum()), int((d != 0).sum()),
                                                   float(d.max()))
                if label == "f64":
                    continue
                xk, pk, lk = x0.clone(), pri0.clone(), ll0.clone()
                ak = torch.zeros(shape, dtype=torch.int32, device=dev)

                def step():
                    ladder.tempered_half_step(lp, xk, pk, lk, betas, 0, u_z, j, u_acc, 2.0, off,
                                              sc, ak, check_partners=False)
                a_ms[rungs] = (cuda_ms(step),
                               device_ms(step, "tempered_half_step_kernel", 20, 1)[0])
                n = rungs * half
                a_bounds[rungs] = bound_fields(n * (sc2_eval_ops(lp.log_likelihood) + PROPOSAL),
                                               n * (2 * 4 * 4 + 2 * 8 + 4 + 8 + 4) + rungs * 8
                                               + n * (4 * 4 + 2 * 8 + 4))
                if rungs == K6A_LADDERS[0][0]:
                    name = expect_kernel(step, "tempered_half_step_kernel", "SC2WarpModel",
                                         "true>")
                    fns = ladder.plain_functions(lp, off, sc)
                    xp, pp, lpl = x0.clone(), pri0.clone(), ll0.clone()
                    plain_ms = cuda_ms(lambda: ladder.tempered_half_step_plain(
                        *fns, xp, pp, lpl, betas, 0, u_z, j, u_acc, 2.0), repeats=5)
        finally:
            config.set_compute_dtype(config.AUTO)
    # K6a over SC3 (a thread per walker), 17 rungs x 512
    R = EV_RUNGS + 1
    lp3, off3, sc3_, x3 = ladder_setup(ShockCooling3(lcf), lcf, sc3_priors(), SC3_LO, SC3_UP, R,
                                       512, np.random.default_rng(seed), dev)
    t3 = check_ladder("SC3 ladder", lp3, off3, sc3_, x3, seed, 1e-5, same_bits=False)
    # its time (no main path runs it yet)
    pri3, ll3 = ladder.ladder_init(lp3, x3, off3, sc3_)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape3 = (R, 2, 256)
    uz3 = torch.rand(shape3, generator=g, device=dev)
    j3 = torch.randint(0, 256, shape3, generator=g, device=dev)
    ua3 = torch.rand(shape3, generator=g, device=dev)
    betas3 = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    state3 = (x3.clone(), pri3.clone(), ll3.clone())
    a3 = torch.zeros(shape3, dtype=torch.int32, device=dev)

    def step3():
        ladder.tempered_half_step(lp3, *state3, betas3, 0, uz3, j3, ua3, 2.0, off3, sc3_, a3,
                                  check_partners=False)
    sc3_ms = (cuda_ms(step3), device_ms(step3, "tempered_half_step_kernel", 20, 1)[0])
    plain3 = (x3.clone(), pri3.clone(), ll3.clone())
    sc3_plain_ms = cuda_ms(lambda: ladder.tempered_half_step_plain(
        *ladder.plain_functions(lp3, off3, sc3_), *plain3, betas3, 0, uz3, j3, ua3, 2.0),
        repeats=2)
    n3 = R * 256
    sc3_bound = bound_fields(n3 * (sc3_eval_ops(lp3.log_likelihood) + PROPOSAL),
                             n3 * (2 * 7 * 4 + 2 * 8 + 4 + 8 + 4) + R * 8 + n3 * (7 * 4 + 2 * 8 + 4))
    top = K6A_LADDERS[0][0]
    phase("K6a", f"{name}: tempered half-steps h=0,1 (f32 rescaled state, f64 log pi and log "
          "L, beta_0 = 0; log L within 1e-5 / 1e-10 of the term scale): SC2 "
          + "; ".join(f"{r} x {2 * hh} {lab}: {v[1]} accepts, flags agree except {v[0]} "
                      f"near-ties, log L max |d| {v[2]:.3e} (K6b {v[3]:.3e})"
                      for (lab, r, hh), v in lads.items())
          + f"; SC3 {R} x 512: {t3[1]} accepts, {t3[0]} near-ties, log L max |d| {t3[2]:.3e} "
          f"(K6b {t3[3]:.3e}); states and log pi bit-equal where the flags agree; "
          f"{kernels.LAUNCHES['tempered_half_step'] - n0} comparison launches; K6a over SC2 "
          "(events; the profiler's device time) " + ", ".join(
              f"{a_ms[r][0]:.4f}; {a_ms[r][1]:.4f} ms per {r} x half {hh} (bound "
              f"{a_bounds[r]['bound_ms']:.5f})" for r, hh in K6A_LADDERS)
          + f", plain {plain_ms:.4f} ms per {top} x half {EV_WALKERS // 2} (f32); K6a over SC3 "
          f"(a thread per walker) {sc3_ms[0]:.4f}; {sc3_ms[1]:.4f} ms per {R} x half 256 (bound "
          f"{sc3_bound['bound_ms']:.5f}), plain {sc3_plain_ms:.4f} ms; "
          "proposals' log pi + log L (u_acc = 0) that differ from K7's value: "
          + ", ".join(f"{lab} {v[5]} of {v[4]} (max |d| {v[6]:.3e})"
                      for (lab, r, hh), v in lads.items() if len(v) > 4))
    return {"max_abs_err": max(v[2] for k, v in lads.items() if k[0] == "f32"),
            "ms": a_ms[top][0], "plain_ms": plain_ms, **a_bounds[top]}


# K6b's ladders (rungs, walkers) as the fits call it: the evidence (16a)
# and compare_models (16c) of SC2, its PT fit (16b); over CS2 the evidence
# (24c; compare_models CS2 against CS3 at the same shape) and the PT fit;
# over SC3 phase 14's ladder
K6B_LADDERS = {"sc2": ((EV_RUNGS + 1, EV_WALKERS), (7, 32), (EV_RUNGS + 1, 32)),
               "cs": ((EV_RUNGS + 1, EV_WALKERS), (7, 64)),
               "sc3": ((EV_RUNGS + 1, 512),)}


def k6b_as_called(name, lp, lo, up, R, W, rng, eval_ops, marks, plain_repeats=0):
    """K6b as a ladder of R rungs x W walkers calls it (every rung starts
    from one set of W states, 1% outside the priors: the set once, copies =
    R) on the rescaled state of ``ladder_setup``, against its plain version:
    R equal rows, the same -inf sets, log pi within 1e-12 and log L within
    1e-5 (float32) or 1e-10 (float64) of the term scale; in float32 also
    its time (events; the profiler's device time), its bound, the kernel
    the profiler saw (holding ``marks``) and, with ``plain_repeats``, the
    plain version's time. Returns (max |d log L|, events ms, device ms,
    bound fields, kernel name, plain ms); the times None in float64."""
    import torch
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling
    from lightcurve_fitting_tpu_torch.kernels import common, ladder
    from time_port_kernels import device_ms
    dev = torch.device("cuda")
    kw = _state_rescaling("auto", lo, up, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    x = torch.as_tensor((window_states(rng, lo, up, W, 0.01) - off) / sc, device=dev)
    x = x.to(kw["dtype"]).reshape(1, 2, W // 2, len(lo)).contiguous()
    fns = ladder.plain_functions(lp, off, sc)
    pri, ll = ladder.ladder_init(lp, x, off, sc, copies=R)
    want_pri, want_ll = ladder.ladder_init_plain(*fns, x, copies=R)
    if pri.shape != (R, 2, W // 2) or not all(torch.equal(pri[r], pri[0]) and
                                               torch.equal(ll[r], ll[0]) for r in range(R)):
        raise AssertionError(f"{name}: the {R} rows of one set of states differ")
    fin = torch.isfinite(want_pri)
    if not torch.equal(torch.isneginf(pri), torch.isneginf(want_pri)) \
            or not bool(((pri - want_pri).abs()[fin] <= 1e-12).all()):
        raise AssertionError(f"{name}: log pi differs from the plain version")
    rel = 1e-10 if lp.log_likelihood.compute_dtype == torch.float64 else 1e-5
    scale = lp.log_likelihood.term_scales(common.absolute_params(x, off, sc))
    d = compare_ll(f"{name} log L", ll, want_ll, rel, scale=scale.expand(R, -1, -1))[0]
    if lp.log_likelihood.compute_dtype == torch.float64:
        return d, None, None, None, None, None

    def call():
        return ladder.ladder_init(lp, x, off, sc, copies=R)
    kernel = expect_kernel(call, "ladder_init_kernel", *marks)
    plain_ms = cuda_ms(lambda: ladder.ladder_init_plain(*fns, x, copies=R),
                       repeats=plain_repeats) if plain_repeats else None
    return (d, cuda_ms(call), device_ms(call, "ladder_init_kernel", 20, 1)[0],
            bound_fields(W * eval_ops, W * x.shape[-1] * 4 + R * W * 2 * 8), kernel, plain_ms)


def phase_k6bcd(lc, lcf, lc_ia, lc0, seed=9):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import ladder
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, ShockCooling3
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    R, W = EV_RUNGS + 1, EV_WALKERS
    n = R * W
    # K6b: each rung its own states (copies = 1), 1% outside the priors
    res = {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            rng = np.random.default_rng(seed)
            lp, off, sc, x = ladder_setup(ShockCooling2(lc), lc, flagship_priors(), P_LO, P_UP,
                                          R, W, rng, dev, outside=0.01)
            pri, ll = ladder.ladder_init(lp, x, off, sc)
            fns = ladder.plain_functions(lp, off, sc)
            want_pri, want_ll = ladder.ladder_init_plain(*fns, x)
            fin = torch.isfinite(want_pri)
            if not torch.equal(torch.isneginf(pri), torch.isneginf(want_pri)) \
                    or not bool(((pri - want_pri).abs()[fin] <= 1e-12).all()):
                raise AssertionError(f"K6b {label}: log pi differs from the plain version")
            d = compare_ll(f"K6b {label}", ll, want_ll, 1e-5 if label == "f32" else 1e-10)
            res[label] = (d[0], d[1], int((~fin).sum()), int(torch.isfinite(ll).sum()), ll)
        finally:
            config.set_compute_dtype(config.AUTO)
    # the float32 kernel's log L against the float64 kernel's on the same states:
    # a bias b in every log L moves log Z by b (the dbeta sum to 1)
    l32, l64 = res["f32"][4], res["f64"][4]
    both = torch.isfinite(l32) & torch.isfinite(l64)
    near = both & (l64 > l64[both].max() - 1000.0)
    bias = [(float((l32 - l64)[m].mean()), float((l32 - l64)[m].std()), int(m.sum()))
            for m in (both, near)]
    # K6b as the ladders call it (one set of states, copies = the rungs), over
    # each instantiation (SC2 ndim 4, CS2 ndim 7, SC3 ndim 7) at its ladders'
    # shapes, float32 and float64 compute; timed in float32
    models = {"sc2": (lambda: ShockCooling2(lc), lc, flagship_priors(), P_LO, P_UP,
                      sc2_eval_ops, ("SC2WarpModel", ", 4>")),
              "cs": (lambda: cs_model(2, lc0), lc_ia, cs_priors(2), CS_LO[2], CS_UP[2],
                     cs_eval_ops, ("CSWarpModel", ", 7>")),
              "sc3": (lambda: ShockCooling3(lcf), lcf, sc3_priors(), SC3_LO, SC3_UP,
                      sc3_eval_ops, ("SC3WarpModel", ", 7>"))}
    rng = np.random.default_rng(seed + 3)
    called = {}
    for which, (model, lc_m, pri_m, lo, up, ops, marks) in models.items():
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(None)
                lp = make_log_posterior(model(), lc_m, pri_m, device=dev)
                for R_b, W_b in K6B_LADDERS[which]:
                    called[(which, label, R_b, W_b)] = k6b_as_called(
                        f"K6b over {which} {label} {R_b} x {W_b}", lp, lo, up, R_b, W_b, rng,
                        ops(lp.log_likelihood), marks,
                        3 if (R_b, W_b) in ((R, W), (R, 512)) and label == "f32" else 0)
            finally:
                config.set_compute_dtype(config.AUTO)
    timed = {k: v for k, v in called.items() if v[1] is not None}
    phase("K6b", f"{timed[('sc2', 'f32', R, W)][4]} and its CS2 and SC3 instantiations: each "
          f"rung its own states (copies = 1), {n} states ({res['f32'][2]} outside the priors, "
          f"log L finite at {res['f32'][3]}): log pi within 1e-12 of the plain split, -inf sets "
          f"equal; log L f32 max |d| {res['f32'][0]:.3e} (max |d|/|ll| {res['f32'][1]:.2e} <= "
          f"1e-5), f64 max |d| {res['f64'][0]:.3e} (max |d|/|ll| {res['f64'][1]:.2e} <= 1e-10); "
          "float32 - float64 kernel log L on the same states: mean "
          f"{bias[0][0]:+.4e}, std {bias[0][1]:.4e} over {bias[0][2]} states; within 1000 of the "
          f"best: mean {bias[1][0]:+.4e}, std {bias[1][1]:.4e} over {bias[1][2]}; as the "
          "ladders call it (one set of states, 1% outside the priors, each written to every "
          "rung: rows equal, log pi within 1e-12, log L within 1e-5 / 1e-10 of the term scale "
          "of the plain version): " + "; ".join(
              f"{w} {lab} {r} x {wk}: log L max |d| {v[0]:.3e}" for (w, lab, r, wk), v in
              called.items())
          + "; kernel (events; the profiler's device time) " + ", ".join(
              f"{w} {v[1]:.4f}; {v[2]:.5f} ms at {r} x {wk} (bound {v[3]['bound_ms']:.5f})"
              for (w, lab, r, wk), v in timed.items())
          + f"; plain {timed[('sc2', 'f32', R, W)][5]:.4f} ms at SC2 {R} x {W}, "
          f"{timed[('cs', 'f32', R, W)][5]:.4f} ms at CS2 {R} x {W}, "
          f"{timed[('sc3', 'f32', R, 512)][5]:.4f} ms at SC3 {R} x 512 (f32)")
    k6b = {}
    for which in ("sc2", "cs"):
        v = timed[(which, "f32", R, W)]
        k6b[which] = {"max_abs_err": max(d[0] for k, d in called.items()
                                         if k[:2] == (which, "f32")),
                      "ms": v[1], "plain_ms": v[5], **v[3]}

    # K6c: the replica exchange, bit for bit, at the ladders' shapes (the
    # first shape's inputs drawn from the generator that K6d's continue)
    rng, rng_more = np.random.default_rng(seed + 1), np.random.default_rng(seed + 2)
    checks, c_ms, c_bounds = [], {}, {}
    for R_c, W_c, nd in K6C_SHAPES:
        half = W_c // 2
        gen = rng if (R_c, W_c, nd) == K6C_SHAPES[0] else rng_more
        betas = torch.as_tensor(make_beta_ladder(R_c - 1), device=dev)
        x = torch.as_tensor(gen.normal(size=(R_c, 2, half, nd)), device=dev).float()
        pri = torch.zeros((R_c, 2, half), dtype=torch.float64, device=dev)
        ll = torch.as_tensor(-12990.0 + 10.0 * gen.normal(size=(R_c, 2, half)), device=dev)
        ll[3, 0, :min(100, half)] = -np.inf    # NaN-likelihood starts: never exchanged
        u = torch.as_tensor(gen.random((R_c, 2, half)), device=dev).float()

        def outputs():
            return [torch.zeros((R_c, 2, half), dtype=torch.int32, device=dev),
                    torch.empty((R_c, 2, half), dtype=torch.float64, device=dev),
                    torch.empty((2, half, nd), device=dev)]
        n_swaps = []
        for parity, production in itertools.product((0, 1), (True, False)):
            outs = []
            for fn in (ladder.replica_swap, ladder.replica_swap_plain):
                state = [x.clone(), pri.clone(), ll.clone()]
                extra = outputs() if production else []
                fn(*state, betas, u, parity, *extra)
                outs.append(state + extra)
            torch.cuda.synchronize()
            for name, got, want in zip(("x", "logpri", "logl", "n_swap", "logl_out", "cold"),
                                       *outs):
                if not torch.equal(got, want):
                    raise AssertionError(f"K6c {R_c} x {W_c} (ndim {nd}) parity {parity}: "
                                         f"{name} differs from the plain version")
            if production:
                if int(outs[0][3][3, 0, :min(100, half)].sum()):
                    raise AssertionError("K6c: a -inf log L state was exchanged")
                n_swaps.append(int(outs[0][3].sum()) // 2)
        checks.append(n_swaps)
        args = [x.clone(), pri.clone(), ll.clone(), betas, u, 1] + outputs()
        c_ms[(R_c, W_c, nd)] = (cuda_ms(lambda: ladder.replica_swap(*args)),
                                device_ms(lambda: ladder.replica_swap(*args), "replica_swap",
                                          100, 1)[0])
        n = R_c * W_c
        c_bounds[(R_c, W_c, nd)] = bound_fields(
            n * 8, n * (nd * 4 + 2 * 8 + 4 + 4) + R_c * 8 + n * (nd * 4 + 2 * 8 + 4 + 8)
            + W_c * nd * 4)
        if (R_c, W_c, nd) == K6C_SHAPES[0]:
            c_plain_ms = cuda_ms(lambda: ladder.replica_swap_plain(*args), repeats=5)
            c_name = expect_kernel(lambda: ladder.replica_swap(*args), "replica_swap_kernel",
                                   f", {nd}>")
    phase("K6c", f"{c_name}: " + "; ".join(
              f"{r} rungs x {w} walkers, ndim {nd} ({s[0]} and {s[1]} exchanges)"
              for (r, w, nd), s in zip(K6C_SHAPES, checks))
          + " (beta_0 = 0, the walkers of rung 3 at log L = -inf), both parities, production "
          "and burn-in steps: states, log pi, log L, swap counts, the production log L row and "
          "the cold states bit-equal to the plain version; kernel (events; the profiler's "
          "device time) " + ", ".join(f"{v[0]:.4f}; {v[1]:.5f} ms at {r} x {w} x {nd} (bound "
                                      f"{c_bounds[(r, w, nd)]['bound_ms']:.5f})"
                                      for (r, w, nd), v in c_ms.items())
          + f"; plain {c_plain_ms:.4f} ms per production step at {R} x {W}")
    k6c = {"max_abs_err": 0.0, "ms": c_ms[K6C_SHAPES[0]][1], "plain_ms": c_plain_ms,
           **c_bounds[K6C_SHAPES[0]]}

    # K6d: the stepping-stone block terms at the bench shape's production log L,
    # two launches bit-equal; then the edge cases (a NaN, a +inf, one -inf
    # among finite values, a whole split of -inf in a finite block, a block of
    # -inf) at block lengths that the splits do not divide, over the 16-byte
    # loads (an even walker count) and the scalar ones (an odd count)
    logl = torch.as_tensor(-12990.0 + 10.0 * rng.normal(size=(EV_STEPS, R, W)), device=dev)
    db = torch.as_tensor(np.diff(make_beta_ladder(EV_RUNGS)), device=dev)
    bounds = tuple((int(i[0]), int(i[-1]) + 1)
                   for i in np.array_split(np.arange(EV_STEPS), 4))
    got = ladder.rung_block_terms(logl, db, bounds)
    want = ladder.rung_block_terms_plain(logl, db, bounds)
    rel = float(((got - want).abs() / want.abs()).max())
    if got.shape != (4, EV_RUNGS) or rel > 1e-12:
        raise AssertionError(f"K6d: max relative difference {rel:.3e} > 1e-12")
    if not torch.equal(ladder.rung_block_terms(logl, db, bounds), got):
        raise AssertionError("K6d: two launches on the same log L gave other bits")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = ladder.k6d_splits(4 * EV_RUNGS, (EV_STEPS // 4) * W // 2, n_sm)
    edge = {}
    for We in (998, 999):
        steps_e, R_e = 37, 9
        ll = torch.as_tensor(-5000.0 - 100.0 * rng.random((steps_e, R_e, We)), device=dev)
        bnd = tuple((int(i[0]), int(i[-1]) + 1) for i in np.array_split(np.arange(steps_e), 4))
        ll[bnd[0][0] + 3, 1, 7] = np.nan                  # rung 1, block 0: NaN
        ll[bnd[1][0] + 2, 2, 5] = np.inf                  # rung 2, block 1: NaN
        ll[bnd[2][0] + 1, 3, 11] = -np.inf                # rung 3, block 2: the -inf adds 0
        ll[bnd[3][0]:bnd[3][0] + 3, 4] = -np.inf          # rung 4, block 3: split 0 all -inf
        ll[bnd[1][0]:bnd[1][1], 5] = -np.inf              # rung 5, block 1: NaN
        dbe = torch.as_tensor(np.diff(make_beta_ladder(R_e - 1)), device=dev)
        ge = ladder.rung_block_terms(ll, dbe, bnd)
        we = ladder.rung_block_terms_plain(ll, dbe, bnd)
        nan = torch.isnan(we)
        re = float(((ge - we).abs() / we.abs())[~nan].max())
        if not torch.equal(torch.isnan(ge), nan) or int(nan.sum()) != 3 or re > 1e-12 \
                or not torch.equal(ladder.rung_block_terms(ll, dbe, bnd).nan_to_num(),
                                   ge.nan_to_num()):
            raise AssertionError(f"K6d edge cases at {We} walkers: NaN at "
                                 f"{nan.nonzero().tolist()} against "
                                 f"{torch.isnan(ge).nonzero().tolist()}, max relative "
                                 f"difference {re:.3e}")
        edge[We] = (re, ladder.k6d_splits(4 * (R_e - 1), 9 * (We // 2 if We % 2 == 0 else We),
                                          n_sm))
    # the small ladders' shapes run one split, where the CTA writes the term
    # itself: each with a -inf row (a walker's NaN-likelihood start, every
    # rung) and the edge cases above, against the plain version
    rng1 = np.random.default_rng(15)
    one = {}
    for steps_o, R_o, W_o in K6D_ONE_SPLIT_SHAPES:
        ll = torch.as_tensor(-12990.0 + 10.0 * rng1.normal(size=(steps_o, R_o, W_o)), device=dev)
        bnd = tuple((int(i[0]), int(i[-1]) + 1) for i in np.array_split(np.arange(steps_o), 4))
        splits_o = ladder.k6d_splits(4 * (R_o - 1), min(b1 - b0 for b0, b1 in bnd) * W_o // 2,
                                     n_sm)
        if splits_o != 1:
            raise AssertionError(f"K6d at {steps_o} x {R_o} x {W_o}: {splits_o} splits, not 1")
        ll[bnd[0][0] + 5, :, 3] = -np.inf                 # every rung, block 0: adds 0
        ll[bnd[0][0] + 3, 1, 7] = np.nan                  # rung 1, block 0: NaN
        ll[bnd[1][0] + 2, 2, 5] = np.inf                  # rung 2, block 1: NaN
        ll[bnd[2][0] + 1, 3, 11] = -np.inf                # rung 3, block 2: adds 0
        ll[bnd[1][0]:bnd[1][1], 5] = -np.inf              # rung 5, block 1: NaN
        dbo = torch.as_tensor(np.diff(make_beta_ladder(R_o - 1)), device=dev)
        go = ladder.rung_block_terms(ll, dbo, bnd)
        wo = ladder.rung_block_terms_plain(ll, dbo, bnd)
        nan = torch.isnan(wo)
        ro = float(((go - wo).abs() / wo.abs())[~nan].max())
        if nan.nonzero().tolist() != [[0, 1], [1, 2], [1, 5]] \
                or not torch.equal(torch.isnan(go), nan) or ro > 1e-12 \
                or not torch.equal(ladder.rung_block_terms(ll, dbo, bnd).nan_to_num(),
                                   go.nan_to_num()):
            raise AssertionError(f"K6d at {steps_o} x {R_o} x {W_o} (one split): NaN at "
                                 f"{nan.nonzero().tolist()} against "
                                 f"{torch.isnan(go).nonzero().tolist()}, max relative "
                                 f"difference {ro:.3e}")
        one[(steps_o, R_o, W_o)] = ro
    w = db[None, :, None] * logl[:, :EV_RUNGS]
    d_ms = cuda_ms(lambda: ladder.rung_block_terms(logl, db, bounds))
    d_dev = device_ms(lambda: ladder.rung_block_terms(logl, db, bounds), "rung_block_terms",
                      20, 1)[0]
    d_plain_ms = cuda_ms(lambda: ladder.rung_block_terms_plain(logl, db, bounds), repeats=5)
    lib_ms = cuda_ms(lambda: [torch.logsumexp(w[b0:b1], dim=(0, 2)) for b0, b1 in bounds])
    m = EV_STEPS * EV_RUNGS * W
    # one pass: a multiply, a compare, a subtraction, an exp and an add a value
    d_bound = bound_fields(m * (4 + SFU), m * 8 + EV_RUNGS * 8 + 4 * EV_RUNGS * 8, lib_ms,
                           rate=FP64_FLOPS)
    phase("K6d", f"{EV_STEPS} steps x {R} rungs x {W} walkers, 4 blocks, {splits} splits a "
          f"(block, rung): max relative difference {rel:.2e} <= 1e-12, two launches bit-equal; "
          "edge cases (a NaN, a +inf, a block of -inf: NaN as the plain version; one -inf, a "
          "split of -inf: 0) at 37 steps x 9 rungs: " + ", ".join(
              f"{We} walkers ({v[1]} splits, blocks of 9-10 steps) max relative difference "
              f"{v[0]:.2e}" for We, v in edge.items())
          + "; one split, a -inf row and the edge cases: " + ", ".join(
              f"{a} x {b} x {c} max relative difference {v:.2e}" for (a, b, c), v in one.items())
          + f", NaN positions equal, repeat bit-equal; kernel {d_ms:.4f} ms (events; the "
          f"profiler's device time {d_dev:.4f} ms) vs plain {d_plain_ms:.4f} ms vs "
          f"torch.logsumexp over the 4 blocks of dbeta log L {lib_ms:.4f} ms, bound "
          f"{d_bound['bound_ms']:.4f} ms ({d_bound['bound_by']}, float64)")
    k6d = {"max_abs_err": float((got - want).abs().max()), "ms": d_ms, "plain_ms": d_plain_ms,
           **d_bound}
    return k6b, k6c, k6d


def phase_ladder_main_path(lc, smi):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.filters import filtdict
    from lightcurve_fitting_tpu_torch.fitting import (compare_models, lightcurve_evidence,
                                                      lightcurve_ptmcmc)
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.models import GaussianPrior, ShockCooling2, UniformPrior

    priors = flagship_priors()
    kw = dict(p_lo=P_LO, p_up=P_UP, nwalkers=EV_WALKERS, n_rungs=EV_RUNGS, nsteps=EV_STEPS,
              nsteps_burnin=EV_BURNIN, quiet=True)
    model = ShockCooling2(lc)
    kernels.reset_launch_counts()
    runs, times = [], []
    for seed in (1, 2, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(lightcurve_evidence(lc, model, priors, seed=seed, **kw))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(runs) == 1:
            launches = dict(kernels.LAUNCHES)
    for k in LADDER_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the ladder path: {launches}")
    if runs[2][:2] != runs[0][:2]:
        raise AssertionError(f"a repeated seed gave another log Z: {runs[0][:2]} {runs[2][:2]}")
    for (log_z, err, _), seed in zip(runs[:2], (1, 2)):
        for ref, (z_ref, e_ref) in (("bench", EV_LOGZ_BENCH), ("JAX CPU", EV_LOGZ_JAX[seed])):
            if not np.isfinite(err) or abs(log_z - z_ref) > 4 * np.hypot(err, e_ref):
                raise AssertionError(f"16a seed {seed}: log Z {log_z:.4f} +- {err:.4f} not "
                                     f"within 4 hypot of the {ref} value {z_ref} +- {e_ref}")
    info = runs[0][2]
    # float32 against float64 compute, paired by seed (the same draws)
    seeds = range(1, 9)
    runs32 = [r[:2] for r in runs[:2]] + [
        lightcurve_evidence(lc, model, priors, seed=seed, **kw)[:2] for seed in seeds[2:]]
    try:
        config.set_compute_dtype(None)
        runs64 = [lightcurve_evidence(lc, ShockCooling2(lc), priors, seed=seed, **kw)[:2]
                  for seed in seeds]
    finally:
        config.set_compute_dtype(config.AUTO)
    for (z64, e64), (z32, e32) in zip(runs64, runs32):
        if abs(z64 - z32) > 4 * np.hypot(e64, e32):
            raise AssertionError(f"16a: float64 compute log Z {z64} +- {e64} disagrees with "
                                 f"float32's {z32} +- {e32}")
    diff = np.array([a[0] - b[0] for a, b in zip(runs64, runs32)])
    wall, prof = profiled(lambda: lightcurve_evidence(lc, model, priors, seed=2, **kw))
    parts, busy = time_split(prof, wall, {
        "step loop (K6a)": ("tempered_half_step",), "swaps (K6c)": ("replica_swap",),
        "reduction (K6d)": ("rung_block_terms",), "init (K6b)": ("ladder_init_kernel",)})
    med = float(np.median(times))
    evals = (EV_RUNGS + 1) * EV_WALKERS * (EV_STEPS + EV_BURNIN)
    logl_mb = EV_STEPS * (EV_RUNGS + 1) * EV_WALKERS * 8 / 1e6
    phase("ladder main path 16a", f"lightcurve_evidence ShockCooling2 {EV_WALKERS} walkers x "
          f"{EV_RUNGS} rungs + beta = 1 x {EV_BURNIN}+{EV_STEPS} steps: log Z seed 1 "
          f"{runs[0][0]:.4f} +- {runs[0][1]:.4f}, seed 2 {runs[1][0]:.4f} +- {runs[1][1]:.4f} "
          f"(bench record {EV_LOGZ_BENCH[0]} +- {EV_LOGZ_BENCH[1]}; JAX float64 CPU seed 1 "
          f"{EV_LOGZ_JAX[1][0]:.4f} +- {EV_LOGZ_JAX[1][1]:.4f}, seed 2 {EV_LOGZ_JAX[2][0]:.4f} "
          f"+- {EV_LOGZ_JAX[2][1]:.4f}); seed 1 again bit-identical; float64 compute seed 1 "
          f"{runs64[0][0]:.4f} +- {runs64[0][1]:.4f}, seed 2 {runs64[1][0]:.4f} +- "
          f"{runs64[1][1]:.4f}; float64 - float32 log Z over seeds 1-8 (same draws) "
          f"{fmt(diff)}: mean {diff.mean():+.4f} +- {diff.std(ddof=1) / np.sqrt(diff.size):.4f}; "
          f"float32 log Z over seeds 1-8 mean {np.mean([z for z, _ in runs32]):.4f}, float64 "
          f"{np.mean([z for z, _ in runs64]):.4f}; rung acceptance "
          f"{fmt(info['acceptance'])}; swap rates {fmt(info['swap_rate'])}; "
          f"{evals / med:.4e} ladder evals/s (median of 3 runs {med:.4f} s, runs "
          f"{', '.join(f'{t:.4f}' for t in times)}; on {smi}); production log L buffer "
          f"{logl_mb:.1f} MB; profiled run {wall:.4f} s, device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.3f}): " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
          + f"; launches in one run {launches}")

    # 16b: parallel tempering on the flagship (tests/test_ptmcmc.py:55-71)
    gauss = [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
             GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]
    t0 = time.perf_counter()
    pt = lightcurve_ptmcmc(lc, ShockCooling2(lc), gauss, p_lo=[20, 2, 20, 57468.4],
                           p_up=[50, 5, 50, 57468.69], nwalkers=32, n_rungs=6, nsteps=250,
                           nsteps_burnin=350, seed=2, quiet=True)
    torch.cuda.synchronize()
    pt_s = time.perf_counter() - t0
    med = np.median(pt.flatchain, axis=0)
    if pt.flatchain.shape != (250 * 32, 4) or not (30.0 < med[0] < 45.0 and 4.5 < med[1] < 6.0) \
            or not np.isfinite(pt.log_z) or not pt.log_z_err < 20.0 or pt.swap_rate.shape != (7,):
        raise AssertionError(f"16b: PT chain {pt.flatchain.shape}, medians {med}, log Z "
                             f"{pt.log_z} +- {pt.log_z_err}")
    phase("ladder main path 16b", f"lightcurve_ptmcmc ShockCooling2 32 walkers x 6 rungs + "
          f"beta = 1 x 350+250 steps in {pt_s:.3f} s: cold medians {fmt(med)} (T_1 in (30, 45), "
          f"L_1 in (4.5, 6)), cold acceptance {pt.acceptance_fraction[0]:.4f}, swap rates "
          f"{fmt(pt.swap_rate)}, log Z {pt.log_z:.4f} +- {pt.log_z_err:.4f}")

    # 16c: compare_models on synthetic ShockCooling2 photometry (tests/test_evidence.py:76-107)
    rng = np.random.default_rng(3)
    filters = [filtdict[n] for n in ["g", "r", "i"]]
    t = np.repeat(np.linspace(1.0, 8.0, 5), len(filters))
    f = np.array(filters * 5)
    y_true = ShockCooling2()(t, f, 12.0, 2.0, 35.0, 0.0)
    dy = 0.05 * y_true
    syn = LC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
    snug = [UniformPrior(8.0, 16.0), UniformPrior(1.0, 3.0), UniformPrior(25.0, 45.0),
            UniformPrior(-0.5, 0.5)]
    wide = [UniformPrior(1.0, 81.0), UniformPrior(0.1, 20.1), UniformPrior(5.0, 205.0),
            UniformPrior(-5.0, 5.0)]
    table = compare_models(syn, [ShockCooling2(syn), ShockCooling2(syn)], [snug, wide],
                           labels=["snug", "wide"], nwalkers=32, n_rungs=16, nsteps=250,
                           nsteps_burnin=250, seed=4, quiet=True)
    rows = {table["model"][i]: (float(table["log_z"][i]), float(table["dlog_z"][i]))
            for i in range(len(table))}
    dz = rows["snug"][0] - rows["wide"][0]
    if not 3.0 < dz < 20.0:
        raise AssertionError(f"16c: Occam log Bayes factor {dz} outside (3, 20): {rows}")
    phase("ladder main path 16c", f"compare_models on synthetic ShockCooling2 photometry: log Z "
          f"snug {rows['snug'][0]:.4f} +- {rows['snug'][1]:.4f}, wide {rows['wide'][0]:.4f} +- "
          f"{rows['wide'][1]:.4f}, log Bayes factor {dz:.4f} in (3, 20); launches since 16a "
          f"began {dict(kernels.LAUNCHES)}")
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

def seed_acceptance(fit, seeds):
    """The mean acceptance of ``fit(seed)`` (a sampler) over ``seeds`` and
    its standard error, and each seed's."""
    import numpy as np
    acc = [float(np.mean(fit(seed).acceptance_fraction)) for seed in seeds]
    return float(np.mean(acc)), float(np.std(acc, ddof=1) / np.sqrt(len(acc))), acc


def phase_sc2_seeds(lc):
    """5c: the flagship acceptance at matched seeds 1-8, 4096 walkers x 300
    steps from the init window, in float32 (float32 compute and rescaled
    state: what the fits run on CUDA) and float64 (compute and state),
    each held within 4 combined standard errors of the JAX package's on the
    CPU at the same seeds and precision."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_mcmc
    from lightcurve_fitting_tpu_torch.models import ShockCooling2

    res = {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            res[label] = seed_acceptance(lambda seed: lightcurve_mcmc(
                lc, ShockCooling2(lc), flagship_priors(), p_lo=P_LO, p_up=P_UP,
                nwalkers=SC2_SEED_WALKERS, nsteps=300, nsteps_burnin=0, seed=seed, quiet=True,
                state_dtype=np.float32 if label == "f32" else np.float64), SC2_SEEDS)
        finally:
            config.set_compute_dtype(config.AUTO)
        mean, err, _ = res[label]
        ref, ref_err = SC2_SEEDS_REF[label]
        if abs(mean - ref) > 4 * np.hypot(err, ref_err):
            raise AssertionError(f"5c {label}: mean acceptance {mean:.5f} +- {err:.5f} against "
                                 f"the JAX package's {ref:.5f} +- {ref_err:.5f}")
    phase("main path 5c", f"lightcurve_mcmc {SC2_SEED_WALKERS} walkers x 300 steps, seeds "
          f"{SC2_SEEDS[0]}-{SC2_SEEDS[-1]}: " + "; ".join(
              f"{lab} mean acceptance {m:.5f} +- {e:.5f} (per seed {fmt(a)}) against the JAX "
              f"package's CPU {SC2_SEEDS_REF[lab][0]:.5f} +- {SC2_SEEDS_REF[lab][1]:.5f}: "
              f"difference {m - SC2_SEEDS_REF[lab][0]:+.5f} = "
              f"{(m - SC2_SEEDS_REF[lab][0]) / np.hypot(e, SC2_SEEDS_REF[lab][1]):+.2f} combined "
              f"standard errors" for lab, (m, e, a) in res.items())
          + f" (the 131072-walker gate of 5b holds {ACCEPTANCE_REF}, a TPU run of the JAX "
          "package, +- 0.01)")


# ---------------------------------------------------------- the gradient path

GRAD_KERNELS = ("logpost_grad", "nuts_transition", "hmc_transition")
TRUTH_MED = [37.58, 5.326, 16.25, 57468.6999]   # tests/test_hmc.py:131-135
TRUTH_STD = [0.145, 0.053, 0.110, 0.00018]
GRAD_CHAINS, GRAD_DEPTH, GRAD_LEAPFROG = 64, 9, 32
GRAD_STARTS = 64        # lightcurve_map's n_starts: the rows of each K7 launch of its ascent
HMC_CHAINS = 16         # lightcurve_hmc's nchains (20c, 20d)


def sc2_grad_ops(ll):
    """K7 on one walker: K1's evaluation plus the reverse pass per point: the
    Clenshaw derivative recurrence (4 per degree) and ~30 flops and 7 more
    special functions (the power laws' derivatives and divisions)."""
    N, D1 = ll.bb_coeffs.shape
    return sc2_eval_ops(ll) + N * (4 * (D1 - 1) + 30 + 7 * SFU)


def gauss_priors():
    """tests/test_hmc.py::_flagship_priors, the gradient fits' priors."""
    from lightcurve_fitting_tpu_torch.models import GaussianPrior
    return [GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(0.0, 100.0, 4.0, 3.0),
            GaussianPrior(0.0, 100.0, 30.0, 15.0), GaussianPrior(57468.0, 57468.7, 57468.5, 0.2)]


def compare_grad(name, got, want, scale, rel):
    """The masked gradients: zero at the same places, and within rel x the
    summed magnitudes of their per-point terms elsewhere; returns the
    largest absolute and scaled differences."""
    import torch
    if not torch.equal(got == 0, want == 0):
        n = int(((got == 0) != (want == 0)).sum())
        raise AssertionError(f"{name}: the masked (zero) components differ at {n} places")
    d = (got - want).abs()
    r = d / scale.clamp_min(1e-300)
    if not bool((d <= rel * scale).all()):
        raise AssertionError(f"{name}: max |delta|/scale = {float(r.max()):.3e} > {rel:.0e}")
    return float(d.max()), float(r.max())


def k7_forms_equal(lp, x, white=None):
    """K7's block form and warp form at the rows x: bit-equal values and
    gradients (raises otherwise); returns the block form's."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sc2
    vb, gb = sc2.logpost_grad_launch(lp, x, white, "block")
    vw, gw = sc2.logpost_grad_launch(lp, x, white, "warp")
    if not (torch.equal(vb, vw) and torch.equal(gb, gw)):
        n = int(((vb != vw) | (gb != gw).any(dim=1)).sum())
        raise AssertionError(f"K7's block and warp forms differ at {n} of {x.shape[0]} rows")
    return vb, gb


def compare_white(name, got, want, rel):
    """K7 in the whitened space against the plain whitened log-posterior:
    values as K1's, gradients within 1e-2 (float32) or 1e-6 (float64) of 1 +
    |gradient| (tests/test_torch_kernels.py::test_k7_matches_plain_on_card);
    returns the largest value and gradient differences."""
    import torch
    a = compare_ll(f"{name} value", got[0], want[0], rel)
    d = (got[1] - want[1]).abs()
    tol = (1e-2 if rel > 1e-8 else 1e-6) * (1 + want[1].abs())
    if not bool((d <= tol).all()):
        raise AssertionError(f"{name} gradient: max |delta| {float(d.max()):.3e}")
    return a[0], float(d.max())


def phase_k7(lc, rng_seed=10):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import gradient, sc2
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    W, S = HEADLINE_WALKERS, GRAD_STARTS
    rng = np.random.default_rng(rng_seed)
    p = rng.uniform(P_LO, P_UP, size=(W, 4))
    out = rng.choice(W, W // 100, replace=False)          # 1% outside the priors
    p[out, rng.integers(0, 4, size=out.size)] = np.where(rng.random(out.size) < 0.5, -1.0, 1e5)
    late = rng.uniform([20.0, 2.0, 10.0, 57468.8], [50.0, 5.0, 50.0, 57472.0], size=(W, 4))
    p, late = torch.as_tensor(p, device=dev), torch.as_tensor(late, device=dev)
    small = torch.cat([p[:S - 2], p[out[:2]]])            # the MAP's width, two rows outside
    w_big = torch.as_tensor(rng.normal(size=(W, 4)), device=dev)
    forms = {W: gradient.k7_form(W, gradient.sm_count(dev)),
             S: gradient.k7_form(S, gradient.sm_count(dev))}
    if forms != {W: "warp", S: "block"}:
        raise AssertionError(f"K7's forms by width: {forms}")

    def plain(lp_, x):
        parts = [sc2.log_posterior_and_grad_plain(lp_, c) for c in x.split(PLAIN_CHUNK)]
        return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])

    def plain_white(target, x):
        parts = [target.logp_and_grad_plain(c) for c in x.split(PLAIN_CHUNK)]
        return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])

    res, white_res, names = {}, {}, {}
    n0 = kernels.LAUNCHES["logpost_grad"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(), device=dev)
            wide = make_log_posterior(ShockCooling2(lc), lc, flagship_priors(57460.0, 57480.0),
                                      device=dev)
            rel, grel = (1e-5, 1e-4) if label == "f32" else (1e-10, 1e-9)
            stats = []
            for lp_, x, what in ((lp, p, ""), (wide, late, " t<t_exp"), (lp, small, f" {S}")):
                v, g = sc2.log_posterior_and_grad(lp_, x)
                vb, gb = k7_forms_equal(lp_, x)
                if not (torch.equal(v, vb) and torch.equal(g, gb)):
                    raise AssertionError(f"K7 {label}{what}: the wrapper's bits are not the forms'")
                vp, gp = plain(lp_, x)
                a = compare_ll(f"K7 {label}{what} value", v, vp, rel)
                scale = torch.cat([lp_.grad_term_scales(c) for c in x.split(PLAIN_CHUNK)])
                b = compare_grad(f"K7 {label}{what} gradient", g, gp, scale, grel)
                stats.append((a[0], b[0], b[1], int((g == 0).sum())))
            if not torch.isfinite(wide(late)).all():
                raise AssertionError("t < t_exp walkers must have finite log-posteriors")
            res[label] = [max(s[i] for s in stats) for i in range(3)] + [stats[1][3]]
            # the whitened space of the gradient samplers: the MAP's width of
            # lightcurve_hmc's chains, and the headline width
            target, w0 = whitened_flagship(lc, dev, S)
            for x in (torch.as_tensor(w0, device=dev), w_big):
                got = kernels.log_posterior_and_grad(target.log_posterior, x, white=target)
                vb, gb = k7_forms_equal(target.log_posterior, x, target)
                if not (torch.equal(got[0], vb) and torch.equal(got[1], gb)):
                    raise AssertionError(f"K7 {label} whitened: the wrapper's bits are not the "
                                         "forms'")
                white_res[(label, x.shape[0])] = compare_white(
                    f"K7 {label} whitened {x.shape[0]}", got, plain_white(target, x), rel)
            if label == "f32":
                for x in (p, small):
                    names[x.shape[0]] = expect_kernel(
                        lambda: sc2.log_posterior_and_grad(lp, x), "logpost_grad",
                        "logpost_grad_block_kernel" if forms[x.shape[0]] == "block"
                        else "logpost_grad_kernel")
                k_ms = cuda_ms(lambda: sc2.log_posterior_and_grad(lp, p))
                plain_ms = cuda_ms(lambda: plain(lp, small), repeats=5)
                s_dev = {f: device_ms(lambda: sc2.logpost_grad_launch(lp, small, None, f),
                                      "logpost_grad", 100, 1)[0] for f in ("block", "warp")}
        finally:
            config.set_compute_dtype(config.AUTO)
    ll = lp.log_likelihood
    k7_bound = bound_fields(W * sc2_grad_ops(ll), W * (4 * 8 * 2 + 8) + 4 * ll.bb_coeffs.numel())
    s_bound = bound_fields(S * sc2_grad_ops(ll), S * (4 * 8 * 2 + 8) + 4 * ll.bb_coeffs.numel())
    phase("K7", f"{W} walkers (1% outside the priors, {W} more with t < t_exp) and the MAP's {S} "
          f"starts: value f32 max |d| {res['f32'][0]:.3e}, f64 {res['f64'][0]:.3e} (K1's "
          f"tolerances, -inf sets equal); gradient f32 max |d| {res['f32'][1]:.3e} (max "
          f"|d|/term scale {res['f32'][2]:.2e} <= 1e-4), f64 max |d| {res['f64'][1]:.3e} "
          f"({res['f64'][2]:.2e} <= 1e-9), masked zeros equal ({res['f32'][3]} of the t<t_exp "
          f"components); whitened (value, gradient max |d|): "
          + ", ".join(f"{lab} {n} {v[0]:.3e}, {v[1]:.3e}" for (lab, n), v in white_res.items())
          + f"; the block and warp forms bit-equal at every width, f32 and f64, whitened or "
          f"not; the wrapper ran {names[W]} at {W} and {names[S]} at {S} (k7_form); "
          f"{kernels.LAUNCHES['logpost_grad'] - n0} comparison launches; K7 {k_ms:.4f} ms per "
          f"{W}-walker batch (f32 events, bound {k7_bound['bound_ms']:.4f} ms "
          f"({k7_bound['bound_by']})); at {S} rows (the profiler's device time) block "
          f"{s_dev['block']:.4f} ms, warp {s_dev['warp']:.4f} ms, plain (autograd) "
          f"{plain_ms:.4f} ms (f32), bound {s_bound['bound_ms']:.5f} ms ({s_bound['bound_by']})")
    return {"max_abs_err": res["f32"][1], "ms": s_dev["block"], "plain_ms": plain_ms, **s_bound}


def whitened_flagship(lc, dev, n_chains, seed=12):
    """A WhitenedLogPosterior of the flagship as lightcurve_hmc builds it,
    its whitening from Gaussian draws around the converged posterior (t_0
    just inside its upper bound), and n_chains states from those draws."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    pri = gauss_priors()
    lp = make_log_posterior(ShockCooling2(lc), lc, pri, device=dev)
    bounds = BoundsTransform([q.p_min for q in pri], [q.p_max for q in pri])
    rng = np.random.default_rng(seed)
    x = np.asarray(TRUTH_MED) + rng.normal(size=(400, 4)) * np.asarray(TRUTH_STD)
    x[:, 3] = 57468.7 - 1e-6 - np.abs(rng.normal(size=400)) * TRUTH_STD[3]
    warm_u = bounds.to_unbounded(x)
    white = WhitenedPosterior(warm_u)
    w0 = np.ascontiguousarray(white.to_w(warm_u[:n_chains]))
    return WhitenedLogPosterior(lp, bounds, white), w0


def compare_transitions(name, got, want, gaps, gap_nats, rel):
    """Kernel transition ``got`` against ``want`` (q', logp', statistic,
    [depth, diverged]): per chain the same depth and divergence flag, q'
    within rel and logp' within rel |logp|, except near-ties: chains whose
    energy decisions came within ``gap_nats`` (or whose U-turn criteria came
    within ``rel``) of going the other way. Returns (near-ties, max |dq|,
    max |dlogp|)."""
    import torch
    same = ((got[0] - want[0]).abs() <= rel).all(dim=1) \
        & ((got[1] - want[1]).abs() <= rel * want[1].abs())
    for k in range(3, len(got)):
        same &= got[k].to(torch.int64) == want[k].to(torch.int64)
    near = gaps[0] < gap_nats
    if len(gaps) > 1:
        near |= gaps[1] < rel
    if not bool((same | near).all()):
        raise AssertionError(f"{name}: {int((~same & ~near).sum())} chains differ away from "
                             "near-ties")
    if not bool(same.any()):
        raise AssertionError(f"{name}: no chain agrees")
    return (int((~same).sum()), float((got[0] - want[0])[same].abs().max()),
            float((got[1] - want[1])[same].abs().max()))


def phase_k9(lc, seed=13):
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import gradient
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition

    dev = torch.device("cuda")
    C, D = GRAD_CHAINS, GRAD_DEPTH
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    z = torch.randn((C, 4), generator=g, device=dev, dtype=torch.float64)
    u = torch.rand((C, D, 2 ** (D - 1) + 2), generator=g, device=dev, dtype=torch.float64)
    eps = torch.tensor(0.1, dtype=torch.float64, device=dev)
    inv_mass = torch.ones(4, dtype=torch.float64, device=dev)
    res = {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            target, w0 = whitened_flagship(lc, dev, C)
            q0 = torch.as_tensor(w0, device=dev)
            logp0 = target.logp_and_grad(q0)[0]
            got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, D)
            torch.cuda.synchronize()
            if not torch.equal(target.logp_and_grad(got[0])[0], got[1]):
                raise AssertionError(f"K9 {label}: a chain's log-posterior is not K7's at its "
                                     "new state, bit for bit")
            # f64: against the plain transition over the plain (autograd)
            # gradient; f32: over K7's own evaluations, the same float32
            # arithmetic, so that the comparison isolates the transition,
            # and the fully plain float32 transition beside it
            full = make_nuts_transition(target.logp_and_grad_plain, 4, D, margins=True)(
                q0, logp0, z, u, eps, inv_mass)
            over_k7 = make_nuts_transition(target.logp_and_grad, 4, D, margins=True)(
                q0, logp0, z, u, eps, inv_mass)
            ref = full if label == "f64" else over_k7
            cmp = compare_transitions(f"K9 {label}", got, ref[:5], ref[5:], 1e-6 if label == "f64"
                                      else 1e-3, 1e-8)
            n_full = int(((got[3] == full[3]) & (got[4] == full[4])
                          & ((got[0] - full[0]).abs() <= 1e-4).all(dim=1)).sum())
            depth = got[3].to(torch.int64)
            evals = int((2 ** depth - 1 + depth).sum())
            res[label] = cmp + (n_full, float(depth.double().mean()), int(got[4].sum()), evals)
            if label == "f32":
                k_ms = cuda_ms(lambda: gradient.nuts_transition(target, q0, logp0, z, u, eps,
                                                                inv_mass, D), repeats=5)
                q16, l16 = q0[:16].contiguous(), logp0[:16].contiguous()
                k16_ms = cuda_ms(lambda: gradient.nuts_transition(
                    target, q16, l16, z[:16].contiguous(), u[:16].contiguous(), eps, inv_mass, D),
                    repeats=5)
                plain_ms = cuda_ms(lambda: gradient.nuts_transition_plain(
                    target, q0, logp0, z, u, eps, inv_mass, D), repeats=1)
                ops = evals * sc2_grad_ops(target.log_posterior.log_likelihood)
                k9_bound = bound_fields(ops, C * (4 * 8 * 3 + 8 * 3 + 4 * 2) + u.numel() * 8)
        finally:
            config.set_compute_dtype(config.AUTO)
    deep = k9_deep_trees(lc, g)
    phase("K9", f"{C} whitened flagship chains (a block of {-(-149 // 32)} warps each), max_depth "
          f"{D}, eps 0.1, shared draws: every chain's log-posterior K7's at its new state bit for "
          f"bit (f32, f64); f64 against "
          f"the plain transition: {res['f64'][0]} near-ties, max |dq'| {res['f64'][1]:.3e}, max "
          f"|dlogp'| {res['f64'][2]:.3e}; f32 against the plain transition over K7's float32 "
          f"evaluations: {res['f32'][0]} near-ties, max |dq'| {res['f32'][1]:.3e}, max |dlogp'| "
          f"{res['f32'][2]:.3e}; f32 kernel equal to the fully plain float32 transition (depth, "
          f"divergence, |dq'| <= 1e-4) at {res['f32'][3]} of {C} chains; mean depth "
          f"{res['f32'][4]:.3f}, {res['f32'][5]} divergent, {res['f32'][6]} evaluations; K9 "
          f"{k_ms:.4f} ms per {C}-chain transition, {k16_ms:.4f} ms per 16 chains, plain "
          f"{plain_ms:.4f} ms (f32), bound {k9_bound['bound_ms']:.4f} ms "
          f"({k9_bound['bound_by']}); {deep}")
    return {"max_abs_err": res["f32"][1], "ms": k_ms, "plain_ms": plain_ms, **k9_bound}


def k9_deep_trees(lc, g):
    """K9 against the plain transition on deep trees: eps 0.01 at max_depth
    12 grows subtrees of 64 steps and more, whose U-turn blocks and Gumbel
    pick spread over the lanes; the float32 trajectory buffer lies in shared
    memory, the float64 one in the global scratch. Returns the report."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import gradient
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition

    dev = torch.device("cuda")
    C, D = GRAD_CHAINS, 12
    z = torch.randn((C, 4), generator=g, device=dev, dtype=torch.float64)
    u = torch.rand((C, D, 2 ** (D - 1) + 2), generator=g, device=dev, dtype=torch.float64)
    eps = torch.tensor(0.01, dtype=torch.float64, device=dev)
    inv_mass = torch.ones(4, dtype=torch.float64, device=dev)
    res = {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            target, w0 = whitened_flagship(lc, dev, C)
            q0 = torch.as_tensor(w0, device=dev)
            logp0 = target.logp_and_grad(q0)[0]
            got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, D)
            if not torch.equal(target.logp_and_grad(got[0])[0], got[1]):
                raise AssertionError(f"K9 deep {label}: a chain's log-posterior is not K7's")
            # as above: f64 over the plain gradient, f32 over K7's evaluations
            fn = target.logp_and_grad_plain if label == "f64" else target.logp_and_grad
            ref = make_nuts_transition(fn, 4, D, margins=True)(q0, logp0, z, u, eps, inv_mass)
            cmp = compare_transitions(f"K9 deep {label}", got, ref[:5], ref[5:],
                                      1e-6 if label == "f64" else 1e-3, 1e-8)
            depth = got[3].to(torch.int64)
            res[label] = cmp + (int((depth >= 7).sum()), int(depth.max()),
                                gradient.nuts_scratch_len(target, C, D, dev))
        finally:
            config.set_compute_dtype(config.AUTO)
    if min(r[3] for r in res.values()) == 0:
        raise AssertionError(f"K9 deep: no tree reached depth 7: {res}")
    if res["f32"][5] != 0 or res["f64"][5] == 0:
        raise AssertionError("K9 deep: the float32 buffer must lie in shared memory and the "
                             f"float64 one in scratch (scratch doubles {res['f32'][5]}, "
                             f"{res['f64'][5]})")
    return (f"deep trees (eps 0.01, max_depth {D}, {C} chains): f32 (buffer in shared memory) "
            f"{res['f32'][0]} near-ties, max |dq'| {res['f32'][1]:.3e}, max |dlogp'| "
            f"{res['f32'][2]:.3e}, {res['f32'][3]} chains at depth >= 7, max depth "
            f"{res['f32'][4]}; f64 (buffer in {res['f64'][5]} doubles of scratch) "
            f"{res['f64'][0]} near-ties, max |dq'| {res['f64'][1]:.3e}, max |dlogp'| "
            f"{res['f64'][2]:.3e}, {res['f64'][3]} chains at depth >= 7, max depth "
            f"{res['f64'][4]}")


def phase_k7h(lc, seed=14):
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import gradient
    from lightcurve_fitting_tpu_torch.parallel.hmc import hmc_transition_plain

    dev = torch.device("cuda")
    L = GRAD_LEAPFROG
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    z = torch.randn((GRAD_CHAINS, 4), generator=g, device=dev, dtype=torch.float64)
    u_acc = torch.rand(GRAD_CHAINS, generator=g, device=dev, dtype=torch.float64)
    n_used = torch.randint((L + 1) // 2, L + 1, (GRAD_CHAINS,), generator=g, device=dev)
    eps = torch.tensor(0.1, dtype=torch.float64, device=dev)
    inv_mass = torch.ones(4, dtype=torch.float64, device=dev)
    res, k_ms, plain_ms, h_bound = {}, {}, {}, {}
    for label, C in itertools.product(("f32", "f64"), (GRAD_CHAINS, HMC_CHAINS)):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            target, w0 = whitened_flagship(lc, dev, C)
            q0 = torch.as_tensor(w0, device=dev)
            logp0 = target.logp_and_grad(q0)[0]
            args = (q0, logp0, z[:C].contiguous(), u_acc[:C].contiguous(),
                    n_used[:C].contiguous(), eps, inv_mass, L)
            got = gradient.hmc_transition(target, *args)
            torch.cuda.synchronize()
            launched = expect_kernel(lambda: gradient.hmc_transition(target, *args),
                                     "hmc_transition", ", 4>")
            if label == "f32":
                name = launched
            full = hmc_transition_plain(target.logp_and_grad_plain, *args, margins=True)
            over_k7 = hmc_transition_plain(target.logp_and_grad, *args, margins=True)
            ref = full if label == "f64" else over_k7
            cmp = compare_transitions(f"K7h {label} {C}", got, ref[:3], ref[3:],
                                      1e-6 if label == "f64" else 1e-3, 1e-8)
            n_full = int(((got[0] - full[0]).abs() <= 1e-4).all(dim=1).sum())
            evals = int((args[4] + 1).sum())
            res[(label, C)] = cmp + (n_full, float(got[2].mean()), evals)
            if label == "f32":
                k_ms[C] = cuda_ms(lambda: gradient.hmc_transition(target, *args), repeats=5)
                plain_ms[C] = cuda_ms(lambda: gradient.hmc_transition_plain(target, *args),
                                      repeats=1)
                ops = evals * sc2_grad_ops(target.log_posterior.log_likelihood)
                h_bound[C] = bound_fields(ops, C * (4 * 8 * 3 + 8 * 4 + 8 * 2))
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("K7h", f"{name} (a block per chain), whitened flagship chains, {L} leapfrogs "
          f"jittered, eps 0.1, shared draws: "
          + "; ".join(f"{C} chains: f64 against the plain transition: {res[('f64', C)][0]} "
                      f"near-ties, max |dq'| {res[('f64', C)][1]:.3e}, max |dlogp'| "
                      f"{res[('f64', C)][2]:.3e}; f32 against the plain transition over K7's "
                      f"float32 evaluations: {res[('f32', C)][0]} near-ties, max |dq'| "
                      f"{res[('f32', C)][1]:.3e}; f32 kernel within 1e-4 of the fully plain "
                      f"float32 transition at {res[('f32', C)][3]} of {C} chains; mean accept "
                      f"probability {res[('f32', C)][4]:.4f}, {res[('f32', C)][5]} evaluations; "
                      f"K7h {k_ms[C]:.4f} ms vs plain {plain_ms[C]:.4f} ms per {C}-chain "
                      f"transition (f32), bound {h_bound[C]['bound_ms']:.4f} ms "
                      f"({h_bound[C]['bound_by']})" for C in (GRAD_CHAINS, HMC_CHAINS)))
    C = HMC_CHAINS   # lightcurve_hmc's width (20d)
    return {"max_abs_err": max(res[("f32", c)][1] for c in (GRAD_CHAINS, HMC_CHAINS)),
            "ms": k_ms[C], "plain_ms": plain_ms[C], **h_bound[C]}


def hmc_checks(result, name):
    """tests/test_hmc.py:147-159's criteria on a lightcurve_hmc result."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.parallel.diagnostics import split_rhat
    flat = result.flatchain
    med, std = np.median(flat, axis=0), flat.std(axis=0)
    rhat = np.atleast_1d(split_rhat(result._chain))
    fails = []
    if not result.acceptance_fraction.mean() > 0.5:
        fails.append("acceptance")
    if not result.sampler.divergence_rate < 0.02:
        fails.append("divergence rate")
    for d in range(4):
        if not abs(med[d] - TRUTH_MED[d]) < 3.0 * TRUTH_STD[d]:
            fails.append(f"median {d}")
        if not TRUTH_STD[d] / 1.6 < std[d] < TRUTH_STD[d] * 1.6:
            fails.append(f"std {d}")
    if not np.all(rhat < 1.2):
        fails.append("split R-hat")
    line = (f"{name}: medians {fmt(med)}, stds {fmt(std)}, split R-hat {fmt(rhat)}, acceptance "
            f"{result.acceptance_fraction.mean():.4f}, divergence rate "
            f"{result.sampler.divergence_rate:.4f}, mean tree depth "
            f"{result.sampler.mean_tree_depth:.3f}, step size {result.step_size:.4g}")
    return fails, line


def phase_gradient_main_path(lc, smi):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import (lightcurve_hmc, lightcurve_map,
                                                      lightcurve_mcmc)
    from lightcurve_fitting_tpu_torch.models import ShockCooling2

    kernels.reset_launch_counts()
    # (a) tests/test_map.py:82-104
    t0 = time.perf_counter()
    r = lightcurve_map(lc, ShockCooling2(lc), gauss_priors(), seed=0, quiet=True, device="cuda")
    map_s = time.perf_counter() - t0
    ok = all(abs(r.parameters[d] - TRUTH_MED[d]) < TRUTH_STD[d] for d in range(4)) \
        and r.covariance_ok and list(r.at_bound) == [False, False, False, True] \
        and all(TRUTH_STD[d] / 1.3 < r.stderr[d] < TRUTH_STD[d] * 1.3 for d in range(3)) \
        and r.stderr[3] == 0.0 and r.flatchain.shape == (1000, 4) \
        and np.ptp(r.flatchain[:, 3]) == 0.0 and np.isfinite(r.log_posterior)
    if not ok:
        raise AssertionError(f"20a: MAP {r.parameters}, stderr {r.stderr}, at_bound "
                             f"{r.at_bound}, covariance_ok {r.covariance_ok}")
    wall, prof = profiled(lambda: lightcurve_map(lc, ShockCooling2(lc), gauss_priors(), seed=0,
                                                 quiet=True, device="cuda"))
    parts, busy = time_split(prof, wall, {"K7": ("logpost_grad",)})
    phase("gradient main path 20a", f"lightcurve_map SN 2016bkv seed 0 in {map_s:.3f} s: "
          f"{fmt(r.parameters)} +- {fmt(r.stderr)}, at_bound {[bool(b) for b in r.at_bound]}, "
          f"log-posterior "
          f"{r.log_posterior:.4f} (test_map.py:92-104's criteria met); profiled run {wall:.4f} "
          f"s, device busy {busy:.4f} s (idle share {1 - busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))
    # (b) tests/test_map.py:59-79
    s = lightcurve_mcmc(lc, ShockCooling2(lc), priors=gauss_priors(), p_lo=[20, 2, 20, 57468.4],
                        p_up=[50, 5, 50, 57468.69], nwalkers=48, nsteps=100, nsteps_burnin=80,
                        init="map", seed=1, quiet=True, device="cuda")
    med, std = np.median(s.flatchain, axis=0), s.flatchain.std(axis=0)
    if not all(abs(med[d] - TRUTH_MED[d]) < 4 * TRUTH_STD[d]
               and TRUTH_STD[d] / 2 < std[d] < TRUTH_STD[d] * 2 for d in range(4)):
        raise AssertionError(f"20b: medians {med}, stds {std}")
    phase("gradient main path 20b", f"lightcurve_mcmc(init=\"map\") 48 walkers x 80+100 steps: "
          f"medians {fmt(med)}, stds {fmt(std)} (test_map.py:73-79's criteria met)")
    # (c) the default width, float32 (the default on the card) and float64
    runs = {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = lightcurve_hmc(lc, ShockCooling2(lc), gauss_priors(), seed=3, quiet=True,
                                 device="cuda")
            torch.cuda.synchronize()
            runs[label] = (res, time.perf_counter() - t0) + hmc_checks(res, label)
        finally:
            config.set_compute_dtype(config.AUTO)
    splits = []
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            wall, prof = profiled(lambda: lightcurve_hmc(lc, ShockCooling2(lc), gauss_priors(),
                                                         seed=3, quiet=True, device="cuda"))
        finally:
            config.set_compute_dtype(config.AUTO)
        parts, busy = time_split(prof, wall, {
            "NUTS transitions (K9)": ("nuts_transition",),
            "warm start (K1, K2)": ("stretch_half_step", "logpost_warp_kernel"),
            "K7": ("logpost_grad",)})
        splits.append(f"profiled {label} run {wall:.4f} s, device busy {busy:.4f} s (idle share "
                      f"{1 - busy / wall:.3f}): "
                      + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))
    phase("gradient main path 20c", f"lightcurve_hmc NUTS 16 chains x 800+1000, max_depth 9, "
          f"warm start 64 x 300, seed 3: float32 compute {runs['f32'][1]:.3f} s, {runs['f32'][3]}"
          f", failed {runs['f32'][2] or 'none'}; float64 compute {runs['f64'][1]:.3f} s, "
          f"{runs['f64'][3]}, failed {runs['f64'][2] or 'none'} (test_hmc.py:147-159's "
          f"criteria; on {smi}); " + "; ".join(splits))
    for label in ("f32", "f64"):
        if runs[label][2]:
            raise AssertionError(f"20c: the {label} run misses the criteria: {runs[label][2]}")
    # (d) fixed-length HMC, a short run
    def hmc_run():
        return lightcurve_hmc(lc, ShockCooling2(lc), gauss_priors(), sampler="hmc",
                              nchains=HMC_CHAINS, nsamples=100, n_warmup=150, seed=4, quiet=True,
                              device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = hmc_run()
    torch.cuda.synchronize()
    hmc_s = time.perf_counter() - t0
    wall, prof = profiled(hmc_run)
    parts, busy = time_split(prof, wall, {
        "HMC transitions (K7h)": ("hmc_transition",),
        "warm start (K1, K2)": ("stretch_half_step", "logpost_warp_kernel"),
        "K7": ("logpost_grad",)})
    launches = dict(kernels.LAUNCHES)
    if not np.isfinite(h.flatchain).all() or h.flatchain.shape != (1600, 4):
        raise AssertionError("20d: bad HMC chain")
    phase("gradient main path 20d", f"lightcurve_hmc(sampler=\"hmc\") 16 chains x 150+100, "
          f"n_leapfrog 32 in {hmc_s:.3f} s: finite chain, acceptance "
          f"{h.acceptance_fraction.mean():.4f}, step size {h.step_size:.4g}, medians "
          f"{fmt(np.median(h.flatchain, axis=0))}; profiled run {wall:.4f} s, device busy "
          f"{busy:.4f} s (idle share {1 - busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()) + f"; launches {launches}")
    for k in GRAD_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the gradient path: {launches}")
    return launches


# ------------------------------------------------ the intrinsic scatter (21)

SIGMA_WALKERS = 16384


def sigma_window(which):
    import numpy as np
    if which == "SC2":
        return np.append(P_LO, 0.5), np.append(P_UP, 3.0)
    if which == "CS1":
        return np.append(CS_LO[1], 0.5), np.append(CS_UP[1], 3.0)
    return np.append(SC3_LO, 0.5), np.append(SC3_UP, 3.0)


def whitened_sigma(lc, dev, n_chains, sigma_type, seed=12):
    """whitened_flagship with the intrinsic scatter as a fifth parameter
    (Gaussian prior on (0, 10)), its whitening from draws with sigma ~1."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.models import GaussianPrior, ShockCooling2
    from lightcurve_fitting_tpu_torch.parallel.hmc import (BoundsTransform, WhitenedLogPosterior,
                                                           WhitenedPosterior)
    pri = gauss_priors() + [GaussianPrior(0.0, 10.0, 1.0, 1.0)]
    lp = make_log_posterior(ShockCooling2(lc), lc, pri, use_sigma=True, sigma_type=sigma_type,
                            device=dev)
    bounds = BoundsTransform([q.p_min for q in pri], [q.p_max for q in pri])
    rng = np.random.default_rng(seed)
    x = np.append(TRUTH_MED, 1.0) + rng.normal(size=(400, 5)) * np.append(TRUTH_STD, 0.1)
    x[:, 3] = 57468.7 - 1e-6 - np.abs(rng.normal(size=400)) * TRUTH_STD[3]
    warm_u = bounds.to_unbounded(x)
    white = WhitenedPosterior(warm_u)
    w0 = np.ascontiguousarray(white.to_w(warm_u[:n_chains]))
    return WhitenedLogPosterior(lp, bounds, white), w0


def phase_use_sigma(lc, lcf, lc_ia, lc0, seed=15):
    """21: every kernel that branches on use_sigma against its plain version
    with the intrinsic scatter on (SC2 with 5 parameters, SC3 with 8, CS1
    with 9 on the synthetic Ia curve), both sigma_types, float32 and
    float64: K1, the SC3 or the CS log-posterior, K2, the SC3 or the CS
    half-step, K6a and K6b over each; K7 (the sigma column of the gradient
    included), K9 and K7h over SC2."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import gradient, sc2
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior, ShockCooling2, ShockCooling3
    from lightcurve_fitting_tpu_torch.parallel.hmc import hmc_transition_plain
    from lightcurve_fitting_tpu_torch.parallel.nuts import make_nuts_transition

    dev = torch.device("cuda")
    lines = []
    for which, sigma_type, label in itertools.product(("SC2", "SC3", "CS1"),
                                                      ("relative", "absolute"), ("f32", "f64")):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            rel, grel = (1e-5, 1e-4) if label == "f32" else (1e-10, 1e-9)
            pri = ({"SC2": flagship_priors, "SC3": sc3_priors, "CS1": lambda: cs_priors(1)}[which]()
                   + [LogUniformPrior(0.01, 10.0)])
            model, data = {"SC2": (ShockCooling2(lc), lc), "SC3": (ShockCooling3(lcf), lcf),
                           "CS1": (cs_model(1, lc0), lc_ia)}[which]
            lp = make_log_posterior(model, data, pri, use_sigma=True, sigma_type=sigma_type,
                                    device=dev)
            lo, up = sigma_window(which)
            rng = np.random.default_rng(seed)
            p = torch.as_tensor(window_states(rng, lo, up, SIGMA_WALKERS, outside=0.01), device=dev)
            what = f"21 {which} sigma={sigma_type} {label}"
            d_lp = compare_ll(f"{what} log-posterior", lp(p), chunked(lp.forward_plain, p), rel,
                              scale=lp.log_likelihood.term_scales(p))
            off, sc = (lo + up) / 2, (up - lo) / 2 * (1 + 1e-6)
            W = 2048 if which == "SC3" else 4096
            x0 = torch.as_tensor((rng.uniform(lo, up, size=(W, len(lo))) - off) / sc, device=dev)
            x0 = x0.float().reshape(2, W // 2, len(lo)).contiguous()
            hs = check_half_step(f"{what} half-step", lp, off, sc, x0, seed, rel)
            xl = torch.as_tensor((window_states(rng, lo, up, 8 * 512, outside=0.01) - off) / sc,
                                 device=dev).float().reshape(8, 2, 256, len(lo)).contiguous()
            lad = check_ladder(what, lp, off, sc, xl, seed, rel, same_bits=which != "SC3")
            line = (f"{what}: log-posterior max |d| {d_lp[0]:.3e} (max |d|/scale {d_lp[1]:.2e}), "
                    f"half-step {hs[1]} accepts, {hs[0]} near-ties, new logp max |d| "
                    f"{hs[2]:.3e}, K6a {lad[1]} accepts, {lad[0]} near-ties, log L max |d| "
                    f"{lad[2]:.3e}, K6b log L max |d| {lad[3]:.3e}")
            if which == "SC2":
                # K7 at the width of these walkers (the warp form) and at the
                # MAP's (the block form, N = 5), both forms bit-equal at each
                ps = torch.cat([p[-(GRAD_STARTS - 2):], p[:2]])
                for x, form in ((p, "logpost_grad_kernel"), (ps, "logpost_grad_block_kernel")):
                    v, g = sc2.log_posterior_and_grad(lp, x)
                    vb, gb = k7_forms_equal(lp, x)
                    if not (torch.equal(v, vb) and torch.equal(g, gb)):
                        raise AssertionError(f"{what}: K7's wrapper bits are not the forms'")
                    expect_kernel(lambda: sc2.log_posterior_and_grad(lp, x), "logpost_grad",
                                  form)
                    parts = [sc2.log_posterior_and_grad_plain(lp, c) for c in x.split(PLAIN_CHUNK)]
                    vp, gp = torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])
                    compare_ll(f"{what} K7 value", v, vp, rel,
                               scale=lp.log_likelihood.term_scales(x))
                    gscale = torch.cat([lp.grad_term_scales(c) for c in x.split(PLAIN_CHUNK)])
                    gd = compare_grad(f"{what} K7 gradient", g, gp, gscale, grel)
                    if not bool((g[torch.isfinite(v), 4] != 0).all()):
                        raise AssertionError(f"{what}: K7's sigma column is 0 at a finite walker")
                target, w0 = whitened_sigma(lc, dev, 32, sigma_type)
                wq = torch.as_tensor(w0, device=dev)
                got = kernels.log_posterior_and_grad(target.log_posterior, wq, white=target)
                vb, gb = k7_forms_equal(target.log_posterior, wq, target)
                if not (torch.equal(got[0], vb) and torch.equal(got[1], gb)):
                    raise AssertionError(f"{what}: K7's whitened bits are not the forms'")
                wd = compare_white(f"{what} K7 whitened", got, target.logp_and_grad_plain(wq),
                                   rel)
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
                q0 = torch.as_tensor(w0, device=dev)
                z = torch.randn((32, 5), generator=gen, device=dev, dtype=torch.float64)
                u = torch.rand((32, 7, 66), generator=gen, device=dev, dtype=torch.float64)
                u_acc = torch.rand(32, generator=gen, device=dev, dtype=torch.float64)
                n_used = torch.randint(8, 17, (32,), generator=gen, device=dev)
                eps = torch.tensor(0.1, dtype=torch.float64, device=dev)
                inv_mass = torch.ones(5, dtype=torch.float64, device=dev)
                logp0 = target.logp_and_grad(q0)[0]
                fn = target.logp_and_grad_plain if label == "f64" else target.logp_and_grad
                gap = 1e-6 if label == "f64" else 1e-3
                got = gradient.nuts_transition(target, q0, logp0, z, u, eps, inv_mass, 7)
                ref = make_nuts_transition(fn, 5, 7, margins=True)(q0, logp0, z, u, eps, inv_mass)
                k9 = compare_transitions(f"{what} K9", got, ref[:5], ref[5:], gap, 1e-8)
                args = (q0, logp0, z, u_acc, n_used, eps, inv_mass, 16)
                got = gradient.hmc_transition(target, *args)
                expect_kernel(lambda: gradient.hmc_transition(target, *args), "hmc_transition",
                              ", 5>")
                ref = hmc_transition_plain(fn, *args, margins=True)
                k7h = compare_transitions(f"{what} K7h", got, ref[:3], ref[3:], gap, 1e-8)
                line += (f", K7 gradient max |d|/term scale {gd[1]:.2e} (the {GRAD_STARTS}-row "
                         f"block form; both forms bit-equal at {p.shape[0]} and {GRAD_STARTS} "
                         f"rows and at 32 whitened, max |dvalue|, |dgrad| {wd[0]:.2e}, "
                         f"{wd[1]:.2e}), K9 {k9[0]} near-ties max |dq'| {k9[1]:.2e}, K7h (a "
                         f"block per chain, N = 5) {k7h[0]} near-ties max |dq'| {k7h[1]:.2e}")
            lines.append(line)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("use_sigma 21", f"{SIGMA_WALKERS} walkers from the window with sigma in [0.5, 3] dy "
          f"units (1% outside the priors), tolerances as without the scatter over the term "
          f"scale (0.5 x the summed |residual terms|, log term included, + |constant|): "
          + "; ".join(lines) + f"; launches so far {dict(kernels.LAUNCHES)}")


# ---------------------------------------------- the companion-shocking path

# tests/test_companion_shocking.py:106-123: the synthetic SN 2017cbv-style Ia
# curve's truth, priors and window (CS2); CS1's factors and CS3's angle added
CS_TRUTH = dict(t_exp=57820.0, a13=0.5, Mc_v9_7=1.0, t_peak=57840.0, stretch=1.0)
CS_PRIORS = {2: [(57815.0, 57825.0), (0.01, 5.0), (0.1, 10.0), (57835.0, 57845.0), (0.6, 1.6),
                 (-5.0, 5.0), (-5.0, 5.0)]}
CS_PRIORS[1] = CS_PRIORS[2][:5] + [(0.1, 10.0)] * 3
CS_PRIORS[3] = CS_PRIORS[2][:2] + [(0.0, 180.0)] + CS_PRIORS[2][3:]
CS_LO = {2: [57818.0, 0.2, 0.5, 57838.0, 0.8, -1.0, -1.0]}
CS_UP = {2: [57822.0, 1.0, 2.0, 57842.0, 1.2, 1.0, 1.0]}
CS_LO[1], CS_UP[1] = CS_LO[2][:5] + [0.8] * 3, CS_UP[2][:5] + [1.2] * 3
CS_LO[3], CS_UP[3] = CS_LO[2][:2] + [0.0] + CS_LO[2][3:], CS_UP[2][:2] + [90.0] + CS_UP[2][3:]
CS_WALKERS = 32768
# the widths whose initial state a CS fit computes with the CS log-posterior:
# 24a's 32 walkers, a 4096-walker fit, 24b's 32768
CS_LP_WIDTHS = (32, 4096, CS_WALKERS)
# the JAX package, float64 on the CPU, for CS2 on this curve (its generating
# model), the priors and window above: the mean acceptance at 32768 walkers
# x 300 steps, no burn-in, seed 7 (shard=False), and the stepping-stone log Z
# at 4096 walkers x 16 rungs + beta = 1 x 150 + 150 steps, seed 1
# (tests/test_torch_companion.py::jax_cs_references)
CS_ACCEPTANCE_REF = 0.34658192952473954
CS_LOGZ_REF = (-4776.580381286037, 0.09502462437832584)
CS_KERNELS = ("sifto", "cs_logpost", "cs_half_step", "tempered_half_step", "ladder_init")


def cs_priors(variant):
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    return [UniformPrior(lo, hi) for lo, hi in CS_PRIORS[variant]]


def ia_lc(seed=3):
    """tests/test_companion_shocking.py::make_ia_lc with the port's LC and
    CompanionShocking2 in float64 on the CPU: 18 epochs x UBVgri = 108
    points of a Kasen shock + SiFTO at CS_TRUTH, 4% errors, noise from
    seed 3. Returns the curve and the seed curve (every point 2e15) that the
    generating model was built on: a model built on it has the truth's
    SiFTO scaling, which is data-derived (reference models.py:716)."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.filters import filtdict
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.models import CompanionShocking2
    rng = np.random.default_rng(seed)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    epochs = np.linspace(CS_TRUTH["t_exp"] + 0.5, CS_TRUTH["t_peak"] + 15.0, 18)
    t = np.repeat(epochs, len(filters))
    f = np.array(filters * len(epochs))
    lum = np.full(len(t), 2e15)
    lc0 = LC([t, f, lum, 0.05 * lum], names=["MJD", "filter", "lum", "dlum"])
    y_true = CompanionShocking2(lc0, device="cpu")(t, f, *CS_TRUTH.values(), 0.0, 0.0)
    dy = 0.04 * np.maximum(y_true, 0.05 * np.median(y_true))
    lc = LC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
    lc.meta["redshift"] = 0.0
    return lc, lc0


def cs_model(variant, lc0, device=None):
    from lightcurve_fitting_tpu_torch import models
    cls = {1: models.CompanionShocking, 2: models.CompanionShocking2,
           3: models.CompanionShocking3}[variant]
    return cls(lc0, device=device)


def cs_eval_ops(ll):
    """The CS log-posterior on one walker: per point K1's Clenshaw (3 per
    degree), ~50 flops and 10 special functions (the Kasen log, exp and two
    powers, log T, exp, the phase division, the residual's), and K8's
    7-step knot search and cubic (~16)."""
    N, D1 = ll.bb_coeffs.shape
    return N * (3 * (D1 - 1) + 50 + 16 + 10 * SFU)


SIFTO_OPS = 16 + SFU      # K8 per element: search, cubic, subtractions; the division


def cs_walkers(rng, variant, W, use_sigma=False):
    """W walkers of the CS window, 1% outside the priors, the last eighth
    with t_0 in (57821, 57824), after the first epochs (inside the prior)."""
    import numpy as np
    lo, up = CS_LO[variant], CS_UP[variant]
    if use_sigma:
        lo, up = lo + [0.5], up + [3.0]
    p = window_states(rng, lo, up, W, outside=0.01)
    p[W - W // 8:] = rng.uniform(lo, up, size=(W // 8, len(lo)))
    p[W - W // 8:, 0] = rng.uniform(57821.0, 57824.0, W // 8)
    return p


def phase_k8(lc, lc0, rng_seed=16):
    """22: K8 against sifto_points_plain at 131072 walkers x the 108 points,
    and on a grid of 108 whole-day times whose phases fall on the knots, at
    both ends, just and far outside, with NaN and infinite phases."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import cs
    from lightcurve_fitting_tpu_torch.models.base import _quad_tensors
    from lightcurve_fitting_tpu_torch.models.companion_shocking import sifto_points_plain

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    rng = np.random.default_rng(rng_seed)
    f = np.asarray(lc["filter"])
    t_lc = np.asarray(lc["MJD"], float)
    t_grid = 57820.0 + np.arange(len(f)) - 30.0
    cols = {"curve": [rng.uniform(57835.0, 57845.0, W), rng.uniform(0.6, 1.6, W),
                      rng.uniform(-5.0, 5.0, W), rng.uniform(-5.0, 5.0, W)]}
    g_tpk = 57820.0 + rng.integers(-20, 120, size=W).astype(float)
    g_s = rng.choice([1.0, 0.5, 2.0, -1.0], size=W)
    g_du = np.where(rng.random(W) < 0.5, rng.integers(-5, 6, W), rng.uniform(-5.0, 5.0, W))
    g_di = np.where(rng.random(W) < 0.5, rng.integers(-5, 6, W), rng.uniform(-5.0, 5.0, W))
    g_tpk[0], g_s[1], g_s[2] = np.nan, 0.0, np.inf
    cols["grid"] = [g_tpk, g_s, g_du, g_di]
    res = {}
    n0 = kernels.LAUNCHES["sifto"]
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            quad = _quad_tensors(cs_model(2, lc0).prepare_quad(f), dev)
            peak = quad["sifto_rows"][quad["sifto_band"], 3].abs().amax(dim=-1)
            tol = 1e-6 if label == "f32" else 1e-13
            for name, t in (("curve", t_lc), ("grid", t_grid)):
                t = torch.as_tensor(t, device=dev)
                args = [torch.as_tensor(c[:, None], device=dev) for c in cols[name]]
                got = cs.sifto(t, quad, *args)
                want = sifto_points_plain(t, quad, *args)
                if not torch.equal(got == 0, want == 0) or not torch.isfinite(got).all():
                    raise AssertionError(f"K8 {label} {name}: the zero sets differ, or a value "
                                         "is not finite")
                d = (got - want).abs() / peak
                if float(d.max()) > tol:
                    raise AssertionError(f"K8 {label} {name}: max |d|/peak {float(d.max()):.3e} "
                                         f"> {tol:.0e}")
                res[(label, name)] = (float((got - want).abs().max()), float(d.max()),
                                      int((got == 0).sum()))
                if label == "f32" and name == "curve":
                    k_ms = cuda_ms(lambda: cs.sifto(t, quad, *args))
                    plain_ms = cuda_ms(lambda: sifto_points_plain(t, quad, *args), repeats=5)
        finally:
            config.set_compute_dtype(config.AUTO)
    N = len(f)
    rows = quad["sifto_rows"]
    k8_bound = bound_fields(W * N * SIFTO_OPS, W * N * 4 + W * 4 * 8 + N * (4 + 8 + 2)
                            + 4 * (rows.numel() + quad["sifto_knots"].numel()))
    phase("K8 22", f"{W} walkers x {N} points, the curve's times and a grid of whole days "
          f"(knots, both ends, outside; t_peak NaN, stretch 0 and inf): f32 max |d| "
          f"{res[('f32', 'curve')][0]:.3e} W/Hz, max |d|/peak {max(res[('f32', n)][1] for n in cols):.2e}"
          f" <= 1e-6; f64 max |d|/peak {max(res[('f64', n)][1] for n in cols):.2e} <= 1e-13; zero "
          f"sets equal ({res[('f32', 'grid')][2]} zeros on the grid); "
          f"{kernels.LAUNCHES['sifto'] - n0} comparison launches; K8 {k_ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms (f32), bound {k8_bound['bound_ms']:.4f} ms ({k8_bound['bound_by']})")
    return {"max_abs_err": res[("f32", "curve")][0], "ms": k_ms, "plain_ms": plain_ms, **k8_bound}


def phase_cs_logpost(lc, lc0, rng_seed=17):
    """23: the CS log-posterior (a warp per walker, the half-step's form) of
    CS1, CS2, CS3 and CS1 with the intrinsic scatter (9 parameters) against
    its plain version at 131072 walkers, and CS2 at the fits' widths (32,
    4096, 32768) the same values bit for bit, timed, the profiler showing
    the warp kernel;
    over CS2, the CS half-step at half 65536, 16384 and 16, K6a and K6b
    (each rung its own states) at 17 x 4096 and 7 x 64 walkers, float32 and
    float64 (K6b as the ladders call it: phase 15)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import common, cs, ladder
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    rng = np.random.default_rng(rng_seed)
    res, widths, names = {}, {}, {}
    n0 = kernels.LAUNCHES["cs_logpost"]
    for (variant, use_sigma), label in itertools.product(((1, False), (2, False), (3, False),
                                                          (1, True)), ("f32", "f64")):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            pri = cs_priors(variant) + ([LogUniformPrior(0.01, 10.0)] if use_sigma else [])
            lp = make_log_posterior(cs_model(variant, lc0), lc, pri, use_sigma=use_sigma,
                                    device=dev)
            p = torch.as_tensor(cs_walkers(rng, variant, W, use_sigma), device=dev)
            got = lp(p)
            what = f"CS{variant}{' sigma' if use_sigma else ''} {label}"
            d = compare_ll(f"CS log-posterior {what}", got, chunked(lp.forward_plain, p),
                           1e-5 if label == "f32" else 1e-10, scale=lp.log_likelihood.term_scales(p))
            if not torch.isfinite(got[W - W // 8:]).all():
                raise AssertionError(f"{what}: t < t_0 walkers must have finite log-posteriors")
            res[(variant, use_sigma, label)] = d + (int(torch.isneginf(got).sum()),)
            if variant == 2 and not use_sigma:
                kw = _state_rescaling(torch.float32, CS_LO[2], CS_UP[2], dev)
                widths[label], names[label] = batch_widths(
                    f"CS log-posterior {label}", cs.log_posterior, lp, p, kw["param_offset"],
                    kw["param_scale"], CS_LP_WIDTHS + (W,), got, "logpost_warp_kernel",
                    ("CSWarpModel",), cs_eval_ops(lp.log_likelihood))
            if label == "f32" and variant == 2:
                plain_ms = cuda_ms(lambda: chunked(lp.forward_plain, p), repeats=3)
                lp2 = lp
        finally:
            config.set_compute_dtype(config.AUTO)
    launches_cmp = kernels.LAUNCHES["cs_logpost"] - n0
    ll = lp2.log_likelihood
    t32 = widths["f32"]
    phase("CS log-posterior 23", f"{names['f32']}, {W} walkers (1% outside the priors, {W // 8} "
          f"with t_0 after the first epochs): " + "; ".join(
              f"CS{v}{' sigma' if s else ''} {lab} max |d| {r[0]:.3e} (max |d|/scale {r[1]:.2e}), "
              f"{r[2]} at -inf" for (v, s, lab), r in res.items())
          + f" (f32 <= 1e-5, f64 <= 1e-10 of the term scale; -inf sets equal); CS2 at the fits' "
          f"widths {', '.join(map(str, CS_LP_WIDTHS))} the same values bit for bit (f32, f64); "
          f"{launches_cmp} comparison launches; kernel (events; the profiler's device time) on "
          "the rescaled f32 state " + ", ".join(
              f"{v[0]:.4f}; {v[1]:.4f} ms at {w} (bound {v[2]['bound_ms']:.5f})"
              for w, v in t32.items())
          + f"; plain {plain_ms:.4f} ms per {W}-walker CS2 batch (f32)")
    out = {"logpost": {"max_abs_err": res[(2, False, "f32")][0], "ms": t32[W][0],
                       "plain_ms": plain_ms, **t32[W][2]}}

    # the CS half-step (a warp per walker) on the sampler's float32 rescaled
    # state, CS2, at half 65536 and at the fits' widths, half 16384 (24b) and
    # 16 (24a), float32 and float64 compute; timed in float32
    kw = _state_rescaling(torch.float32, CS_LO[2], CS_UP[2], dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    halves = (W // 2, CS_WALKERS // 2, 16)
    hs, h_ms, h_bounds = {}, {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp_h = lp2 if label == "f32" else make_log_posterior(cs_model(2, lc0), lc,
                                                                 cs_priors(2), device=dev)
            for half in halves:
                x0 = torch.as_tensor((rng.uniform(CS_LO[2], CS_UP[2], size=(2 * half, 7)) - off)
                                     / sc, device=dev).float().reshape(2, half, 7).contiguous()
                hs[(label, half)] = check_half_step(f"CS half-step {label} {half}", lp_h, off, sc,
                                                    x0, rng_seed, 1e-5 if label == "f32" else 1e-10)
                if label == "f64":
                    continue
                l0 = cs.log_posterior(lp2, x0.reshape(2 * half, 7), off, sc).reshape(2, half)
                g = torch.Generator(device=dev)
                g.manual_seed(rng_seed)
                u_z = torch.rand(half, generator=g, device=dev)
                j = torch.randint(0, half, (half,), generator=g, device=dev)
                u_acc = torch.rand(half, generator=g, device=dev)
                xk, lk = x0.clone(), l0.clone()
                ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
                def step():
                    cs.stretch_half_step(lp2, xk, lk, 0, u_z, j, u_acc, 2.0, off, sc, n_accept=ak,
                                         check_partners=False)
                h_ms[half] = (cuda_ms(step), device_ms(step, "stretch_half_step_kernel", 20, 1)[0])
                h_bounds[half] = bound_fields(half * (cs_eval_ops(ll) + PROPOSAL),
                                              half * (2 * 7 * 4 + 8 + 16 + 4)
                                              + half * (7 * 4 + 8 + 4))
                if half == W // 2:
                    xp, lpp = x0.clone(), l0.clone()
                    h_plain_ms = cuda_ms(lambda: common.stretch_half_step_plain(
                        lambda q: chunked(lambda c: common.log_posterior_plain(lp2, c, off, sc), q),
                        xp, lpp, 0, u_z, j, u_acc, 2.0), repeats=3)
        finally:
            config.set_compute_dtype(config.AUTO)
    out["half"] = {"max_abs_err": max(c[2] for (lab, _), c in hs.items() if lab == "f32"),
                   "ms": h_ms[W // 2][0], "plain_ms": h_plain_ms, **h_bounds[W // 2]}

    # K6a (a warp per walker) and K6b over CS2 at the evidence shape, 17 x
    # 4096 (half 2048), and K6a at the PT fit's, 7 x 64 (half 32), float32 and
    # float64 compute on the sampler's float32 rescaled state; timed in float32
    R = EV_RUNGS + 1
    kw = _state_rescaling("auto", CS_LO[2], CS_UP[2], dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    ladders = ((R, EV_WALKERS // 2), (7, 32))
    lads, a_ms, a_bounds = {}, {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp_l = lp2 if label == "f32" else make_log_posterior(cs_model(2, lc0), lc,
                                                                 cs_priors(2), device=dev)
            for rungs, half in ladders:
                xl = torch.as_tensor((window_states(rng, CS_LO[2], CS_UP[2], rungs * 2 * half, 0.01)
                                      - off) / sc, device=dev).to(kw["dtype"])
                xl = xl.reshape(rungs, 2, half, 7).contiguous()
                lads[(label, rungs, half)] = check_ladder(
                    f"CS2 ladder {label} {rungs} x {half}", lp_l, off, sc, xl, rng_seed,
                    1e-5 if label == "f32" else 1e-10)
                if label == "f64":
                    continue
                pri, lll = ladder.ladder_init(lp2, xl, off, sc)
                betas = torch.as_tensor(make_beta_ladder(rungs - 1), device=dev)
                shape = (rungs, 2, half)
                g = torch.Generator(device=dev)
                g.manual_seed(rng_seed)
                uz = torch.rand(shape, generator=g, device=dev)
                jl = torch.randint(0, half, shape, generator=g, device=dev)
                ua = torch.rand(shape, generator=g, device=dev)
                al = torch.zeros(shape, dtype=torch.int32, device=dev)
                state = (xl.clone(), pri.clone(), lll.clone())
                def step():
                    ladder.tempered_half_step(lp2, *state, betas, 0, uz, jl, ua, 2.0, off, sc, al,
                                              check_partners=False)
                a_ms[rungs] = (cuda_ms(step),
                               device_ms(step, "tempered_half_step_kernel", 20, 1)[0])
                n = rungs * half
                a_bounds[rungs] = bound_fields(n * (cs_eval_ops(ll) + PROPOSAL),
                                               n * (2 * 7 * 4 + 2 * 8 + 4 + 8 + 4) + rungs * 8
                                               + n * (7 * 4 + 2 * 8 + 4))
                if rungs == R:
                    fns = ladder.plain_functions(lp2, off, sc)
                    state = (xl.clone(), pri.clone(), lll.clone())
                    a_plain_ms = cuda_ms(lambda: ladder.tempered_half_step_plain(
                        *fns, *state, betas, 0, uz, jl, ua, 2.0), repeats=3)
        finally:
            config.set_compute_dtype(config.AUTO)
    out["k6a"] = {"max_abs_err": max(v[2] for k, v in lads.items() if k[0] == "f32"),
                  "ms": a_ms[R][0], "plain_ms": a_plain_ms, **a_bounds[R]}
    phase("CS half-step and ladder 23", "CS half-steps h=0,1 (f32 state, a warp per walker) at "
          "half " + "; ".join(f"{half} {lab}: {c[1]} accepts, {c[0]} near-ties, new-logp max |d| "
                              f"{c[2]:.3e}" for (lab, half), c in hs.items())
          + " (new states bit-equal where the flags agree; <= 1e-5 / 1e-10 of the term scale); "
          "kernel (events; the profiler's device time) " + ", ".join(
              f"{h_ms[h][0]:.4f}; {h_ms[h][1]:.4f} ms per half {h} (bound "
              f"{h_bounds[h]['bound_ms']:.5f})" for h in halves)
          + f", plain {h_plain_ms:.4f} ms per half {W // 2}; K6a and K6b (a warp per walker) "
          f"over CS2 (1% outside the priors; K6b at the states K6a left equal to K6a's stored "
          "values bit for bit): " + "; ".join(
              f"{r} x {2 * hh} {lab}: {v[1]} accepts, {v[0]} near-ties, K6a log L max |d| "
              f"{v[2]:.3e}, K6b log L max |d| {v[3]:.3e}" for (lab, r, hh), v in lads.items())
          + "; K6a " + ", ".join(f"{a_ms[r][0]:.4f}; {a_ms[r][1]:.4f} ms per {r} x half {hh} "
                                 f"(bound {a_bounds[r]['bound_ms']:.5f})" for r, hh in ladders)
          + f", plain {a_plain_ms:.4f} ms per {R} x half {EV_WALKERS // 2} (f32)")
    return out


class PlainCalls:
    """Counts the calls of the plain versions of the CS path's kernels while
    it is entered (each wrapped where the wrappers look it up)."""

    NAMES = [("lightcurve_fitting_tpu_torch.kernels", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels", "stretch_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.cs", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.cs", "stretch_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.ladder", "tempered_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.ladder", "ladder_init_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.ladder", "replica_swap_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.ladder", "rung_block_terms_plain"),
             ("lightcurve_fitting_tpu_torch.models.companion_shocking", "sifto_points_plain")]

    def __enter__(self):
        import importlib
        self.count, self.saved = 0, []
        for mod, name in self.NAMES:
            m = importlib.import_module(mod)
            fn = getattr(m, name)
            self.saved.append((m, name, fn))

            def wrapped(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def phase_cs_main_path(lc, lc0, smi):
    """24: the companion-shocking main path, the launch counters reset first:
    (a) lightcurve_mcmc CS2 as tests/test_companion_shocking.py:106-123;
    (b) CS2 at 32768 x 300 from the window, timed over 4 runs, acceptance
    held to the JAX package's float64 value; (c) lightcurve_evidence CS2,
    log Z held to the JAX package's, a profiled run's time split,
    compare_models CS2 against CS3 and lightcurve_ptmcmc CS2;
    (d) CompanionShocking{,2,3}.evaluate on the card at the medians."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import (compare_models, lightcurve_evidence,
                                                      lightcurve_mcmc, lightcurve_ptmcmc)

    kernels.reset_launch_counts()
    with PlainCalls() as plain:
        s = lightcurve_mcmc(lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2], p_up=CS_UP[2],
                            nwalkers=32, nsteps=250, nsteps_burnin=300, seed=12, quiet=True)
        med = np.median(s.flatchain, axis=0)
        s_lo, s_hi = np.percentile(s.flatchain[:, 4], [16.0, 84.0])
        acc_a = float(np.mean(s.acceptance_fraction))
        ok = (abs(med[0] - CS_TRUTH["t_exp"]) < 1.0 and abs(med[3] - CS_TRUTH["t_peak"]) < 1.0
              and abs(med[4] - CS_TRUTH["stretch"]) < 0.15 and 0.1 < acc_a < 0.9)
        phase("CS main path 24a", f"lightcurve_mcmc CompanionShocking2 32 walkers x 300+250, "
              f"seed 12: medians {fmt(med)}, acceptance {acc_a:.4f} (test_companion_shocking.py:"
              f"119-123: t_0 within 1 d of {CS_TRUTH['t_exp']}, t_peak within 1 d of "
              f"{CS_TRUTH['t_peak']}, s within 0.15 of 1, acceptance in (0.1, 0.9): "
              f"{'met' if ok else 'MISSED'}); s 16-84 interval [{s_lo:.4f}, {s_hi:.4f}]")
        if not ok:
            raise AssertionError(f"24a: medians {med}, acceptance {acc_a}")

        # (b) 32768 x 300, timed: four runs, seeds 7-10
        times, accs = [], []
        for seed in (7, 8, 9, 10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = lightcurve_mcmc(lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2], p_up=CS_UP[2],
                                nwalkers=CS_WALKERS, nsteps=300, nsteps_burnin=0, seed=seed,
                                quiet=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            accs.append(float(np.mean(s.acceptance_fraction)))
            if seed == 7:
                flat = s.flatchain
        if abs(accs[0] - CS_ACCEPTANCE_REF) > 0.01:
            raise AssertionError(f"24b: mean acceptance {accs[0]:.4f} not within 0.01 of the JAX "
                                 f"package's {CS_ACCEPTANCE_REF:.4f}")
        if flat.shape != (CS_WALKERS * 300, 7) or not np.isfinite(flat).all():
            raise AssertionError("24b: bad chain")
        med_b = np.median(flat, axis=0)
        wall, prof = profiled(lambda: lightcurve_mcmc(
            lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2], p_up=CS_UP[2],
            nwalkers=CS_WALKERS, nsteps=300, nsteps_burnin=0, seed=11, quiet=True))
        parts, busy = time_split(prof, wall, {"half-steps": ("stretch_half_step",),
                                              "initial state": ("logpost_warp_kernel",)})
        evals = CS_WALKERS * 300
        med_t = float(np.median(times))
        phase("CS main path 24b", f"lightcurve_mcmc CompanionShocking2 {CS_WALKERS} walkers x 300 "
              f"steps from the window: mean acceptance seed 7 {accs[0]:.4f} (JAX float64 CPU "
              f"{CS_ACCEPTANCE_REF} +- 0.01), seeds 8-10 {fmt(accs[1:])}; medians {fmt(med_b)}; "
              f"{evals / min(times):.4e} evals/s at the fastest and {evals / med_t:.4e} at the "
              f"median of 4 runs ({', '.join(f'{t:.4f}' for t in times)} s, setup and chain "
              f"readback included; on {smi}); profiled run {wall:.4f} s, device busy {busy:.4f} s "
              f"(idle share {1 - busy / wall:.3f}): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))

        # (c) the evidence and the comparison of CS2 with CS3
        kw = dict(nwalkers=EV_WALKERS, n_rungs=EV_RUNGS, nsteps=EV_STEPS,
                  nsteps_burnin=EV_BURNIN, quiet=True)
        t0 = time.perf_counter()
        log_z, err, info = lightcurve_evidence(lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2],
                                               p_up=CS_UP[2], seed=1, **kw)
        ev_s = time.perf_counter() - t0
        if not np.isfinite(err) or abs(log_z - CS_LOGZ_REF[0]) > 4 * np.hypot(err, CS_LOGZ_REF[1]):
            raise AssertionError(f"24c: log Z {log_z} +- {err} not within 4 hypot of the JAX "
                                 f"package's {CS_LOGZ_REF}")
        ev_wall, prof = profiled(lambda: lightcurve_evidence(
            lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2], p_up=CS_UP[2], seed=1, **kw))
        ev_parts, ev_busy = time_split(prof, ev_wall, {
            "K6a": ("tempered_half_step",), "swaps": ("replica_swap",),
            "init (K6b)": ("ladder_init_kernel",), "block terms": ("rung_block_terms",)})
        table = compare_models(lc, [cs_model(2, lc0), cs_model(3, lc0)],
                               [cs_priors(2), cs_priors(3)], p_lo=[CS_LO[2], CS_LO[3]],
                               p_up=[CS_UP[2], CS_UP[3]], labels=["CS2", "CS3"], seed=2, **kw)
        rows = {table["model"][i]: (float(table["log_z"][i]), float(table["dlog_z"][i]))
                for i in range(len(table))}
        if not all(np.isfinite(v).all() for v in rows.values()):
            raise AssertionError(f"24c: compare_models gave {rows}")
        pt = lightcurve_ptmcmc(lc, cs_model(2, lc0), cs_priors(2), p_lo=CS_LO[2], p_up=CS_UP[2],
                               nwalkers=64, n_rungs=6, nsteps=250, nsteps_burnin=350, seed=3,
                               quiet=True)
        med_pt = np.median(pt.flatchain, axis=0)
        if pt.flatchain.shape != (250 * 64, 7) or not np.isfinite(pt.flatchain).all() \
                or abs(med_pt[0] - CS_TRUTH["t_exp"]) > 1.0 \
                or abs(med_pt[3] - CS_TRUTH["t_peak"]) > 1.0 or not np.isfinite(pt.log_z):
            raise AssertionError(f"24c: PT chain {pt.flatchain.shape}, medians {med_pt}, log Z "
                                 f"{pt.log_z}")
        phase("CS main path 24c", f"lightcurve_evidence CompanionShocking2 {EV_WALKERS} walkers x "
              f"{EV_RUNGS} rungs + beta = 1 x {EV_BURNIN}+{EV_STEPS}, seed 1: log Z {log_z:.4f} +- "
              f"{err:.4f} (JAX float64 CPU {CS_LOGZ_REF}, within 4 hypot) in {ev_s:.3f} s; "
              f"profiled run {ev_wall:.4f} s, device busy {ev_busy:.4f} s (idle share "
              f"{1 - ev_busy / ev_wall:.3f}): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in ev_parts.items()) + "; rung "
              f"acceptance {fmt(info['acceptance'])}; compare_models CS2 vs CS3 (seed 2): "
              + ", ".join(f"{k} {v[0]:.4f} +- {v[1]:.4f}" for k, v in rows.items())
              + f"; lightcurve_ptmcmc CS2 64 walkers x 6 rungs + beta = 1 x 350+250: cold "
              f"medians {fmt(med_pt)}, swap rates {fmt(pt.swap_rate)}, log Z {pt.log_z:.4f} +- "
              f"{pt.log_z_err:.4f}")

        # (d) the three models' evaluate on the card at the medians
        t = np.asarray(lc["MJD"], float)
        f = np.asarray(lc["filter"])
        y, dy = np.asarray(lc["lum"], float), np.asarray(lc["dlum"], float)
        chi = []
        for variant, p in ((2, med_b), (1, list(med_b[:5]) + [1.0, 1.0, 1.0]),
                           (3, list(med_b[:2]) + [0.0] + list(med_b[3:]))):
            y_fit = cs_model(variant, lc0, device="cuda").evaluate(t, f, *p)
            if y_fit.shape != t.shape or not np.isfinite(y_fit).all() or not (y_fit > 0).any():
                raise AssertionError(f"24d: CS{variant} evaluate gave no finite luminosity")
            chi.append(float(np.sum(((y - y_fit) / dy) ** 2) / (len(t) - 7)))
    launches = dict(kernels.LAUNCHES)
    for k in CS_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the CS path: {launches}")
    if plain.count:
        raise AssertionError(f"{plain.count} plain versions ran on the CS path")
    phase("CS main path 24d", f"CompanionShocking2, CompanionShocking (factors 1) and "
          f"CompanionShocking3 (theta 0) evaluate on the card at the 24b medians: chi2/dof "
          f"{fmt(chi)}; no plain version ran on 24a-d; launches {launches}")
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
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from time_port_kernels import ptxas_report
    report = ptxas_report(info["log"])
    block = {}
    for what, key, n in (("K9", "nuts_transition_kernel", 4), ("K7h", "hmc_transition_kernel", 4),
                         ("K7's block form", "logpost_grad_block_kernel", 4),
                         ("K4p", "epoch_map_polish_kernel", 4),
                         ("the epoch half-step", "stretch_half_step_kernelI12EpochBBModel", 32),
                         ("K4's warp form", "logpost_warp_kernelI12EpochBBModel", 8),
                         ("K4's thread form", "epoch_logpost_thread_kernel", 8),
                         ("K6d", "rung_block_terms_kernel", 2),
                         ("the SC3 log-posterior", "logpost_warp_kernelI12SC3WarpModel", 8),
                         ("K1", "logpost_warp_kernelI12SC2WarpModel", 8),
                         ("K6b", "ladder_init_kernel", 28),
                         ("K6c", "replica_swap_kernel", 18),
                         ("the CS log-posterior", "logpost_warp_kernelI11CSWarpModel", 12),
                         ("K4s", "epoch_summary_kernel", 4)):
        block[what] = [v for k, v in report.items() if key in k]
        if len(block[what]) != n or any(v[1] or v[2] or v[3] for v in block[what]):
            raise AssertionError(f"{what} ({n} instantiations) must keep its state in "
                                 f"registers: {block[what]}")
    phase("build", f"{'built' if info['built'] else 'reused'} {os.path.relpath(info['path'], REPO)} "
          f"in {time.perf_counter() - t0:.2f} s; ptxas: {len(regs)} kernels, "
          f"{sorted(set(r.split('Used ')[-1] for r in regs))[:4]}; no stack frame and no "
          "spills in the block-per-chain kernels (ndim 4, 5; f32, f64), K4p (ndim 2, 3; f32, "
          "f64), the epoch half-step (ndim 2, 3; its 16 dtype instantiations each), K4's "
          "values in both forms (ndim 2, 3; 4 dtype instantiations each), K6d (16-byte and "
          "scalar loads), the SC3 "
          "log-posterior (ndim 7, 8; its 4 dtype instantiations each), K1 (ndim 4, 5; 4 each), "
          "K6b (over SC2 ndim 4, 5, over SC3 7, 8, over CS 7, 8, 9; 4 each), K6c (ndim 1-9; "
          "f32, f64 state), the CS log-posterior (ndim 7, 8, 9; 4 each) and K4s (4 dtype "
          "instantiations): "
          + "; ".join(f"{what} registers {sorted(set(v[0] for v in ks))}, stack frames "
                      f"{sorted(set(v[1] for v in ks))} bytes, spills "
                      f"{sorted(set(v[2] + v[3] for v in ks))}" for what, ks in block.items()))

    lc = flagship_lc()
    k1 = phase_k1(lc)
    k2 = phase_k2(lc)
    launches = phase_main_path(lc, smi)
    phase_sc2_seeds(lc)
    lcf = flux_lc(lc)
    k3 = phase_k3(lcf)
    k_sc3 = phase_sc3_logpost(lcf)
    k_sc3_half = phase_sc3_half_step(lcf)
    launches_sc3 = phase_sc3_main_path(lc, smi)
    k4 = phase_k4()
    k4p = phase_k4p()
    k_epoch_half = phase_epoch_half_step()
    k4s, k5 = phase_k4s_k5()
    launches_bol = phase_bolometric_main_path(smi)
    k6a = phase_k6a(lc, lcf)
    lc_ia, lc0 = ia_lc()
    k6b, k6c, k6d = phase_k6bcd(lc, lcf, lc_ia, lc0)
    launches_ladder = phase_ladder_main_path(lc, smi)
    k7 = phase_k7(lc)
    k9 = phase_k9(lc)
    k7h = phase_k7h(lc)
    launches_grad = phase_gradient_main_path(lc, smi)
    phase_use_sigma(lc, lcf, lc_ia, lc0)
    k8 = phase_k8(lc_ia, lc0)
    k_cs = phase_cs_logpost(lc_ia, lc0)
    launches_cs = phase_cs_main_path(lc_ia, lc0, smi)
    if any(m.startswith("jax") or m.startswith("lightcurve_fitting_tpu.") or
           m == "lightcurve_fitting_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    src = "lightcurve_fitting_tpu_torch/kernels/csrc/sc2_logpost.cu"
    src3 = "lightcurve_fitting_tpu_torch/kernels/csrc/sc3_logpost.cu"
    src4 = "lightcurve_fitting_tpu_torch/kernels/csrc/epoch_bb.cu"
    src_cs = "lightcurve_fitting_tpu_torch/kernels/csrc/companion.cu"
    kernels = [
        dict(name="logpost_warp_kernel<SC2WarpModel<C, N>> (K1)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/fitting.py:62", launches=launches["sc2_logpost"],
             **k1),
        dict(name="stretch_half_step_kernel<SC2WarpModel> (K2)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches["stretch_half_step"], **k2),
        dict(name="bandflux_kernel (K3)", route="cuda", source=src3,
             replaces="0ee4f99:lightcurve_fitting_tpu/ops/pallas_bandflux.py:61",
             launches=launches_sc3["bandflux"], **k3),
        dict(name="logpost_warp_kernel<SC3WarpModel> (SC3 log-posterior)", route="cuda",
             source=src3,
             replaces="lightcurve_fitting_tpu/models/shock_cooling.py:201",
             launches=launches_sc3["sc3_logpost"], **k_sc3),
        dict(name="stretch_half_step_kernel<SC3WarpModel> (SC3 half-step)", route="cuda",
             source=src3, replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches_sc3["sc3_half_step"], **k_sc3_half),
        dict(name="logpost_warp_kernel<EpochBBModel<C, N>> / epoch_logpost_thread_kernel<C, S, "
                  "N> (K4)", route="cuda", source=src4,
             replaces="lightcurve_fitting_tpu/parallel/batched.py:53",
             launches=launches_bol["epoch_logpost"] + launches_bol["epoch_logpost_grad"], **k4),
        dict(name="epoch_map_polish_kernel (K4p)", route="cuda", source=src4,
             replaces="lightcurve_fitting_tpu/parallel/batched.py:355",
             launches=launches_bol["epoch_map_polish"], **k4p),
        dict(name="stretch_half_step_kernel<EpochBBModel> (epoch half-step)",
             route="cuda", source=src4, replaces="lightcurve_fitting_tpu/parallel/batched.py:245",
             launches=launches_bol["epoch_half_step"], **k_epoch_half),
        dict(name="epoch_summary_kernel (K4s)", route="cuda", source=src4,
             replaces="lightcurve_fitting_tpu/parallel/batched.py:129",
             launches=launches_bol["epoch_summary"], **k4s),
        dict(name="percentile_kernel (K5)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/quantile.cu",
             replaces="lightcurve_fitting_tpu/ops/quantile.py:46",
             launches=launches_bol["percentile"], **k5),
        dict(name="tempered_half_step_kernel<SC2WarpModel, WARP> (K6a)", route="cuda",
             source=src,
             replaces="lightcurve_fitting_tpu/parallel/evidence.py:60",
             launches=launches_ladder["tempered_half_step"], **k6a),
        dict(name="ladder_init_kernel<SC2WarpModel<C, N>> (K6b)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/ladder.cuh",
             replaces="lightcurve_fitting_tpu/parallel/evidence.py:229",
             launches=launches_ladder["ladder_init"], **k6b["sc2"]),
        dict(name="replica_swap_kernel<S, N> (K6c)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/ladder.cu",
             replaces="lightcurve_fitting_tpu/parallel/evidence.py:95",
             launches=launches_ladder["replica_swap"], **k6c),
        dict(name="rung_block_terms_kernel<V> (K6d)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/ladder.cu",
             replaces="lightcurve_fitting_tpu/parallel/evidence.py:473",
             launches=launches_ladder["rung_block_terms"], **k6d),
        dict(name="logpost_grad_block_kernel<SC2Model, N> / logpost_grad_kernel<SC2Model> (K7)",
             route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/gradient.cuh",
             replaces="lightcurve_fitting_tpu/parallel/nuts.py:102",
             launches=launches_grad["logpost_grad"], **k7),
        dict(name="nuts_transition_kernel<SC2Model, N> (K9)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/gradient.cuh",
             replaces="lightcurve_fitting_tpu/parallel/nuts.py:98",
             launches=launches_grad["nuts_transition"], **k9),
        dict(name="hmc_transition_kernel<SC2Model, N> (K7h)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/gradient.cuh",
             replaces="lightcurve_fitting_tpu/parallel/hmc.py:241",
             launches=launches_grad["hmc_transition"], **k7h),
        dict(name="sifto_kernel (K8)", route="cuda", source=src_cs,
             replaces="lightcurve_fitting_tpu/models/companion_shocking.py:45",
             launches=launches_cs["sifto"], **k8),
        dict(name="logpost_warp_kernel<CSWarpModel<C, N>> (CS log-posterior)", route="cuda",
             source=src_cs,
             replaces="lightcurve_fitting_tpu/models/companion_shocking.py:120",
             launches=launches_cs["cs_logpost"], **k_cs["logpost"]),
        dict(name="stretch_half_step_kernel<CSWarpModel> (CS half-step)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches_cs["cs_half_step"], **k_cs["half"]),
        dict(name="tempered_half_step_kernel<CSWarpModel, WARP> (K6a over CS)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/evidence.py:60",
             launches=launches_cs["tempered_half_step"], **k_cs["k6a"]),
        dict(name="ladder_init_kernel<CSWarpModel<C, N>> (K6b over CS)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/evidence.py:229",
             launches=launches_cs["ladder_init"], **k6b["cs"]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
