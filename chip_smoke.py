#!/usr/bin/env python3
"""Drive lightcurve_fitting_tpu_torch's main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc (``/usr/local/cuda`` or ``CUDA_HOME``) and PyTorch built for CUDA,
and imports nothing of JAX. Phases, each printing one line (any failure
raises and the script exits non-zero):

1. environment: torch/CUDA versions, the card, its power limit;
2. build: nvcc compiles the kernels from ``kernels/csrc/``; the
   block-per-chain kernels (K9, K7h, K7's block form), K4p, the epoch
   half-step, K4's values in both forms, the SC3, CS, SC and SC4
   log-posteriors, K1, K6b (over every model), K6c, K6d, K4s, K3's warp
   form, K5, K8, K10 and K10's run form must have no stack frame and no
   spills (ptxas); K6a over SC3's, the SC and SC4 half-steps' and K6a's and
   K10's half-step's reports are printed; the native host
   kernels must have built from the port's own source
   (``utils/native/lcf_native.cpp``: the bolometric packing assumes them);
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
6. K3 (``bandflux_kernel``, a thread per (walker, point)) against
   ``bandflux_pointwise_plain`` at 131072 walkers x the 149 flagship points
   with E(B-V) per walker in [0, 1] and t < t_exp walkers, float32 (<= 1e-5
   relative per point) and float64 (<= 1e-12); its two forms (a thread or a
   warp per pair, ``kernels/sc3.py::k3_form``) bit-equal in float32 and
   float64 at one walker, on each side of the crossover and at 131072, the
   profiler showing the form the wrapper picks, each form timed (the
   profiler's device time);
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
   the medians (chi2/dof printed; the profiler showing K3's warp form ran),
   and a profiled run's time split (the
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
    unit, 3 below x = 0.25); K5 (a radix select) bit-equal to its plain
    version there and on its edge cases (``K5_EDGE_CASES``: IEEE specials,
    subnormals, ties, 1, 2 and 3201 values, a 70000-value row past the
    block's shared memory, 1 and 8 percentiles, 0 and 100), the profiler
    showing the kernel ran, ``torch.quantile`` timed beside K5;
13. K10, the SED log-posterior of the sequential bolometric path (a warp
    per walker, ``logpost_warp_kernel<SEDWarpModel<C, N>>``), against its
    plain version on every SN 2016bkv epoch of at least one filter (79), 64
    states each (R < 0; T <= 0 inside a KDE prior), under the default
    priors and KDE temperature priors of 512 and 100 components, with and
    without the intrinsic scatter, float32 (<= 1e-5) and float64 (<= 1e-12
    of the term scale), identical -inf sets; timed at the path's width (5
    walkers) and at 4096 on the 9-filter epoch, with and without the KDE
    prior, beside the plain KDE prior and ``torch.logsumexp`` over its
    components; K10's half-step (h = 0, 1) against the plain half-step
    under shared draws at half 5 and 2048, on the 9-filter epoch and on a
    KDE single-filter one, float32 and float64, as in 4, and K10 at the
    states two half-steps left giving their stored values bit for bit;
    K10's run form (``stretch_run_kernel<SEDWarpModel<C, N>>``, a whole
    segment in one block) at half 5 and 32 on the same two epochs, float32
    and float64, with and without the scatter, thin_by 1 and 2: 300
    proposals bit-equal to 600 K10 half-step launches on the same draws
    (states, log-posteriors, accept counts, chain), K10 at its last states
    their stored values, against its plain version over 60 proposals as in
    4, and timed against those 600 launches;
    the bolometric main path: (a) ``calculate_bolometric(batch_mode=True,
    save_corners=False, nwalkers=32, seed=7)`` on the full SN 2016bkv light
    curve (65 rows); (b) the bench shape (256 epochs x 32 walkers x 200 +
    100 steps) through ``batched_map_centers`` and
    ``batched_blackbody_mcmc(summaries=..., return_chains=False)``, epochs/s
    over 5 runs, mean acceptance within 0.02 of the JAX package's float64
    CPU value, and over seeds 1-8 within 4 combined standard errors of the
    JAX package's at the same seeds, a profiled run's time split; the
    launch counters, reset before (a), show it ran through K4, K4p (once a
    centering; K4's gradient form not at all), the epoch half-step, K4s
    and K5; (c) ``calculate_bolometric(batch_mode=False, save_corners=False,
    seed=7)`` on the full curve at the defaults (65 rows) and at
    ``min_nfilt=1`` (77 fits, ~66 under a KDE prior), every fit one K10
    launch and two of K10's run form (burn-in and production) and nothing
    else, no K10 half-step, the least-squares columns
    the JAX package's (rtol 1e-6; a single-filter row its own solve from
    the previous chain's medians), the MCMC medians of T and R within 2
    hypot(half-widths) of the JAX package's float64 CPU run (seed 7) in >=
    95% of the epochs and within 4 in all: every epoch at the defaults, at
    ``min_nfilt=1`` the epochs up to the first chained one; and at
    ``min_nfilt=1`` every epoch, the port's median over seeds 7-9 against
    the JAX package's, the scale both packages' widths and seed scatter
    (downstream of the chaining each prior is a KDE of an earlier chain;
    ``tests/jax_sequential_bolometric.json``), each package's agreement
    with itself over its seed pairs printed beside it;
    ``batch_mode=True, min_nfilt=1`` bit-equal to it, the walls, and a
    profiled run over the curve's first 15 fits (6 chained): its idle share
    and time split, the profiler showing K10 and its run form and no plain
    version; (d) ``spectrum_mcmc(planck_fast)`` at 64 walkers x 300 + 300
    steps, seeds 1-8, on the 9-filter epoch and on a KDE single-filter
    epoch, the mean acceptance within 4 combined standard errors of the JAX
    package's at the same seeds, every fit one K10 launch and two runs; at
    128 walkers (past the run form's block) K10's half-step twice a step,
    the acceptance within 0.02 of the 64 walkers';
14. K6a, the tempered half-step (h = 0, 1), against its plain version on the
    ShockCooling2 ladders (a warp per walker) of the evidence bench shape
    (17 rungs x 4096 walkers) and of the PT fit (7 x 32), float32 and
    float64 compute on the float32 rescaled state, each timed, and on the
    ShockCooling3 ladder of the SC3 evidence (16d: 17 x 512, a warp per
    walker, the profiler showing ``SC3WarpModel``; float32 within 1e-5 and
    float64 within 1e-12 of the term scale), timed: accept flags agree
    except near-ties, new states bit-equal where they agree, log pi and log
    L within K1's tolerances, and K6b at the states K6a left gives its
    stored values bit for bit; the proposals' log pi + log L against K7's
    value as in 4;
15. K6b, the ladder's initial state (a warp per state), against the plain
    split of the log-posterior, float32 and float64: each rung its own
    states (17 x 4096, 1% outside the priors), and as the ladders call it,
    one set of states written to every rung, over each instantiation at
    its ladders' shapes (SC2 17 x 4096, 7 x 32, 17 x 32; CS2 17 x 4096, 7 x
    64; SC3 17 x 512), each timed, the profiler showing the warp kernel;
    K6b at the states K6a left gives K6a's stored values bit for bit (14,
    23); K6c, the replica exchange, bit-equal to its plain version at
    the ladders' shapes (17 rungs x 4096 and x 32, 7 x 32; 17 x 4096, 7 x
    64 and 17 x 512 with 7 parameters; both parities, production and
    burn-in steps, a
    -inf log L row, the beta = 0 rung), each timed (events and the
    profiler's device time); K6d, the stepping-stone block terms (one pass,
    the splits of each block combined in the same launch), float64 <= 1e-12
    relative at the evidence bench shape and at the SC3 evidence's (150 x 17
    x 512), two launches bit-equal; its
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
    reset before (a), show it ran through K6a-K6d; (d) ``lightcurve_evidence``
    on ShockCooling3 (the priors and window of 9; 512 walkers x 16 rungs +
    beta = 1 x 150 + 150; seeds 1 and 2), log Z within 4 hypot(err,
    err_jax) of the JAX package's float64 CPU values and the mean rung
    acceptance within 4 sigma of the JAX package's seeds 1-8, the counters,
    reset before, showing one run's 600 K6a (over ``SC3WarpModel``), 300
    K6c, 1 K6b and 1 K6d launches and no plain version, a profiled run's
    time split, and seed 1's log Z at 32 and 64 rungs beside it;
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
22. K8, the SiFTO spline, in each form (the rows staged once a block, or
    read where they lie: ``kernels/cs.py::k8_form``) against
    ``sifto_points_plain`` at 131072 walkers x the 108 points of the
    synthetic SN 2017cbv-style Ia curve
    (tests/test_companion_shocking.py::make_ia_lc, rebuilt with the port),
    and on whole-day times whose phases fall on the knots, at both ends,
    outside, NaN and infinite: float32 <= 1e-6 and float64 <= 1e-13 of the
    band's template peak, identical zero sets; the two forms bit-equal
    there and at 1, 2 and the crossover's walkers +- 1, the profiler showing
    the form the wrapper picks; each form timed at 1 and 131072 walkers; the
    direct form's row of the kernels line at one walker (evaluate's width),
    its bytes the table entries that its phases touch;
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
    card (K8's direct form); (e) the model plot's posterior curves (the JAX
    package's ``lightcurve_model_plot``): CS2's ``evaluate`` over 100 draws
    of the 24b chain x 1000 times x the 6 bands on the card (K8's staged
    form), held to the CPU's float64 evaluate (rtol 1e-5, atol 1e-6 of the
    peak), K8's staged form timed on that input (its row of the kernels
    line); the counters show each form of K8, the CS log-posterior and
    half-step, K6a and K6b ran, and no plain version did;
25. the ShockCooling (SW17) and ShockCooling4 (MSW23) kernels of
    ``kernels/csrc/sc_logpost.cu`` (a warp per walker, batched:
    ``SCWarpModel``, ``SC4WarpModel``) against their plain versions on SN
    2016bkv's early curve at examples/compare_models.py's priors and
    window: the batch log-posterior at 131072 walkers (1% outside the
    priors, an eighth with t < t_0), float32 <= 1e-5 and float64 <= 1e-10
    of the term scale, identical -inf sets, at the fits' widths (64, 4096)
    the same values bit for bit, each timed in the form
    ``kernels/sc.py::logpost_form`` picks; its latency form
    (``logpost_latency_kernel`` of ``kernels/csrc/stretch.cuh``: a block
    per walker, one point a thread) bit-equal to its warp form at 64, 4096,
    16384 and (forced) 131072, float32 and float64, with and without the
    scatter, each form timed on the window's walkers; n = 3, RW and kappa
    = 0.7 at 4096; the half-step at half 65536, 2048 and 32 in the form
    ``kernels/sc.py::sc_half_form`` picks (the latency form below each
    model's crossover: a walker's points over ceil(N / 32) warps, one a
    thread; SC4's warp form at 65536), K6a (each rung its own states) and K6b as
    called at 26b's 25 rungs x 64, as in 4, 14 and 15, float32 and
    float64, each timed, K6b's values the batch log-posterior's bits; K6b's
    latency form (``ladder_init_latency_kernel`` of
    ``kernels/csrc/ladder.cuh``: a block per state) bit-equal to its warp
    form at 26b's 25 x 64 and at 17 x 4096 (log L outside the priors too),
    float32 and float64, with and without the scatter, each form timed; at
    each of those widths, in float32 and float64, with and without the
    scatter, the latency form bit-equal to the warp form (h = 0, 1: states,
    log-posteriors, accepts, the chain slot) and the batch log-posterior
    (both forms) at its new states the stored bits, each form timed (the
    profiler's device time); K6a's latency form (``tempered_half_step_latency_kernel``
    of ``kernels/csrc/ladder.cuh``: a block per (rung, walker), one point a
    thread) bit-equal to its warp form at 26b's 25 x 64, at
    ``lightcurve_evidence``'s default 33 x 64, at 17 x 4096 (past SC4's
    crossover in ``kernels/sc.py::tempered_form``) and at 40 x 4096 (past
    both models') (h = 0, 1, beta_0 = 0:
    states, log pi, log L, accepts), float32 and float64, with and without
    the scatter, K6b and the batch log-posterior (both forms of each) at
    its new states the stored bits, each form timed at each ladder (the
    median of three profiler windows); phase 21 covers the other use_sigma
    branches;
26. SW17 against MSW23, the counters reset before (a): (a)
    ``lightcurve_mcmc`` of each at 4096 walkers x 300, seeds 1-8, the mean
    acceptance within 4 combined standard errors of the JAX package's
    float64 CPU value at those seeds; (b) ``compare_models`` at
    tests/test_evidence.py:124-131's settings (64 walkers, 24 rungs, 600 +
    400, seed 7): each log Z within 4 hypot(err, err_jax) of the JAX
    package's and inside that test's bands, SW17 first; (c)
    ``compare_models_loo`` at examples/compare_models.py's settings (64 x
    500 + 500, seed 7): log10(-elpd_loo) within 4x the JAX package's seed
    scatter of its mean (seeds 7-16, at which the ranking itself changes),
    a decisive ranking the JAX seeds' majority's,
    ``information_criteria(group_by="filter")`` and ``goodness_of_fit`` on
    the winner (a finite chi2, p in [0, 1]), the discrepancy op timed on
    the card against the host; the counters show every SC and SC4 kernel
    ran, and no plain version did, and the per-form counts that each
    half-step of (a) (half 2048) and of (b)-(c) (half 32) ran in the form
    ``kernels/sc.py::sc_half_form`` picks at its width, and each of (b)'s
    2 x 2000 K6a launches in the form ``kernels/sc.py::tempered_form``
    picks at 25 x 32 (the latency form), each initial state of (a) and (c)
    in the form ``kernels/sc.py::logpost_form`` picks at 4096 and 64
    walkers, and (b)'s K6b in the form ``kernels/sc.py::ladder_init_form``
    picks at 64 states (the latency forms);
27. the population kernels against their plain versions (``kernels/pop.py``):
    on examples/fit_population.py's population (S = 64 and 512, and 28c's
    8, three parameters), its MJD-scale twin (S = 64, t_exp the fourth) and
    S = 64 with the intrinsic scatter, float32 and float64 compute, 64 walkers in
    the rescaled float32 state: P1 within 1e-5 (1e-12) of the term scale,
    same -inf sets, and at the states two P2 half-steps accepted P2's
    stored values bit for bit; P2 as K2 (h = 0, 1); P3 (16 starts x 400
    Adam steps) the same finite set, each transient's best start the plain
    ascent's or a near-tie, the log-posterior at its MAP point within 1e-5
    (1e-9) of the term scale of the plain ascent's, in float64 the point
    within 1e-9 of the prior's width (float32 with the intrinsic scatter
    reported, not held: ``pop_check_map``), and each float32 ascent, P3's
    and the plain one, at each transient's best MAP point within
    ``POP_MAP_F64`` of the term scale of the float64 plain ascent's in
    float64 -log p (``pop_map_f64_gaps``: P3 within 2e-5, the plain ascent
    within 2e-5, or 0.5 with the scatter);
    P2's warp and latency forms bit for bit (two half-steps: states,
    log-posteriors, accept counts, chain slot) and P3's warp and pair forms
    bit for bit, at S = 8, 64 and 512, ndim 3, 4 (t_exp, or the scatter)
    and 5, float32 and float64; at S = 64 a copy whose transients' last real point
    (and so its padded copies) has a model value of +inf: P1's -inf set the
    plain version's, P2's forms bit for bit, -inf kept
    (``pop_check_poisoned``); each timed at S = 8, 64 and 512 (events, the
    profiler's device time, the plain version; P2 and P3 in each form), the
    profiler showing P1 on ``PopSC2WarpModel``, ptxas's report of the
    three, P3 and P2's latency form (12 instantiations each) without a
    spill;
28. the population path (run first), the counters reset before each fit: (a) ``fit_population`` at
    the example's defaults on S = 64 (64 walkers, 100 + 500 steps,
    ``init="map"`` with 16 x 400, seed 1, summaries, no chains) and (b) on
    S = 512: P1 once, P2 twice a step in the form ``kernels/pop.py::half_form``
    picks, P3 once in the form ``map_form`` picks, and K5, nothing else; every
    transient's acceptance above 0.1, the mean within 0.01 of the JAX
    package's float64 CPU value at the same seed (``POP_REF``), the
    transients recovered (T_1 within 20%, L_1 within 30%) no fewer than
    the JAX run's less a few; the wall, and a profiled repeat's busy time
    and idle share; (c) the example's diagnostics: its first 8 transients
    refit with chains, ``population_goodness_of_fit`` and
    ``population_information_criteria`` on the card against the same
    functions on the CPU in float64;
30. simulation-based calibration at examples/calibration_check.py's full
    size (``simulation_based_calibration``: ShockCooling2, 128 simulations,
    32 walkers x 400 + 600, init="map"): P3, P1 and P2 over SC2 in their
    rules' forms and nothing else, the mean acceptance within 0.01 of the
    JAX package's float64 CPU run (``SBC_REF``), every p-value above 0.01,
    the wall and the idle share;
31. P1 and P2 over ShockCooling and ShockCooling4 (``kernels/csrc/pop_sc.cu``)
    against their plain versions as 27 holds them (S = 64 and 4, t_exp and
    the scatter, f32 and f64, both forms bit for bit, the poisoned copy),
    and at 32's widths (SN 2016bkv without a band or a point: P1's forms
    bit for bit and against the plain version, P2 as K2), their 96
    instantiations without a spill, each timed; then
    ``fit_population`` over a 64-transient survey of each class from the
    window, the mean acceptance within 0.01 of the JAX package's
    (``SC_POP_REF``), the launches by form, the walls and idle shares;
32. 26c's ``compare_models_loo`` with ``refit=True``,
    ``refit_options={"init": "window"}`` and ``group_by="filter"``: each
    refit call P1 once and P2 twice a step over its class's policy, the
    repaired labels the flagged ones, each model's leave-one-band-out
    refits and 16 of its leave-one-point-out ones again on the CPU in
    float64, the mean of the card's acceptance less the CPU's within four
    standard errors of the seed's own effect (``REFIT_SC_SD``).

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
import shutil
import subprocess
import sys
import tempfile
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
INT32_OPS = 16.7e12       # H100 SXM, 32-bit integer: 64 lanes an SM x 132 SMs x 1.98 GHz
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


def sc_eval_ops(ll):
    """The SC log-posterior on one walker: per point the Clenshaw recurrence
    (3 per degree), ~40 flops and 14 special functions (the SW17 powers,
    two exp, sqrt, log, the divisions)."""
    N, D1 = ll.bb_coeffs.shape
    return N * (3 * (D1 - 1) + 40 + 14 * SFU)


def sc4_eval_ops(ll):
    """The SC4 log-posterior on one walker: per point two Clenshaw
    recurrences, ~50 flops and 15 special functions (the MSW23 powers, three
    exp, two log, sqrt, the divisions); the walker's breakout scales (eight
    float64 powers) once a walker, not counted."""
    N, D1 = ll.bb_coeffs.shape
    return N * (6 * (D1 - 1) + 50 + 15 * SFU)


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


def time_split(prof, wall, kernels, averages=None):
    """Seconds of device time by part of a run from a profiler trace: the
    parts of ``kernels`` (name -> substrings of their kernels' names; the
    first match wins), the draws and the rest, and the host's share (the
    wall time the device was idle). ``averages``: the trace's
    ``key_averages()`` where the caller has them (a long trace takes tens
    of seconds to reduce). Returns (parts, busy)."""
    parts = dict.fromkeys(kernels, 0.0)
    parts.update(draws=0.0, other=0.0)
    for e in (prof.key_averages() if averages is None else averages):
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


def profiled(fn, cpu=True):
    """Wall seconds of fn() under the profiler, and the profile; with
    ``cpu=False`` the device's activity alone (a long host-led run records
    ~10x fewer events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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


# one-element adds launched at the start of each profile of
# launched_kernels, by try: the profiler can drop the first kernel records
# of a window (on the H100 with torch 2.11: the first 3-5 of every window
# after a long device-only trace, up to 20 or more of every other window
# after idle minutes, whatever the kernels' length; PERF.md,
# tools/profiler_window_probe.py), so these take the loss
PROFILE_PRIMES = (256, 4096, 65536)


def launched_kernels(fn, match, calls=20):
    """The names of the CUDA kernels holding ``match`` that ``calls`` calls
    of fn launch, from the profiler. Each window first launches
    ``PROFILE_PRIMES`` one-element adds; an empty profile is taken again,
    twice at most, with more of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    one = torch.zeros(1, device="cuda")
    for prime in PROFILE_PRIMES:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(prime):
                one.add_(1.0)
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
    return k3_forms(ll, T, R, ebv)


def k3_forms(ll, T, R, ebv):
    """K3's two forms at one walker (ShockCooling3.evaluate's width), on
    each side of k3_form's crossover and at the whole batch of T, R (W, 149)
    with E(B-V) (W, 1), float32 and float64: the same bits, both held to the
    plain version at phase_k3's tolerances, the form the wrapper picks seen
    by the profiler, each form's device time. Returns the kernel line's
    fields at one walker: the warp form's float32 error and device time."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import sc3
    from lightcurve_fitting_tpu_torch.kernels.gradient import sm_count
    from lightcurve_fitting_tpu_torch.models.blackbody import (bandflux_pointwise,
                                                               bandflux_pointwise_plain)
    from time_port_kernels import device_ms
    N, K = ll.band_ids.shape[0], ll.nodes.shape[1]
    n_sm = sm_count(T.device)
    cross = -(-sc3.K3_THREAD_PAIRS_PER_SM * n_sm // N)     # the fewest walkers a thread each
    widths = (1, cross - 1, cross, T.shape[0])
    kernel_of = {"warp": "bandflux_warp_kernel", "thread": "bandflux_kernel"}
    lines, ms, err = [], {}, {}
    for w in widths:
        args = (ll.nodes, ll.weights, T[:w], R[:w])
        kw = dict(k_ext=ll.k_ext, ebv=ebv[:w], band_ids=ll.band_ids)
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(None)
                forms = {f: sc3.bandflux_launch(f, *args, **kw) for f in kernel_of}
                if not torch.equal(forms["warp"], forms["thread"]):
                    d = (forms["warp"] - forms["thread"]).abs().max()
                    raise AssertionError(f"K3 at {w} walkers ({label}): the warp and thread "
                                         f"forms differ, max |d| {float(d):.3e}")
                want = chunked(lambda T_, R_, e_: bandflux_pointwise_plain(
                    ll.nodes, ll.weights, T_, R_, k_ext=ll.k_ext, ebv=e_,
                    band_ids=ll.band_ids), T[:w], R[:w], ebv[:w])
                d = (forms["warp"] - want).abs()
                rel = 1e-5 if label == "f32" else 1e-12
                if not bool((d <= rel * want.abs()).all()):
                    r = float((d / want.abs().clamp_min(torch.finfo(want.dtype).tiny)).max())
                    raise AssertionError(f"K3's warp form at {w} walkers ({label}): max "
                                         f"relative difference {r:.3e} > {rel:.0e}")
                err[w, label] = float(d.max())
                picked = sc3.k3_form(w * N, n_sm)
                seen = expect_kernel(lambda: bandflux_pointwise(*args, **kw), "bandflux",
                                     kernel_of[picked] + "<")
                if label == "f32":
                    for f in kernel_of:
                        ms[w, f] = device_ms(lambda f=f: sc3.bandflux_launch(f, *args, **kw),
                                             "bandflux", 20, 1)[0]
            finally:
                config.set_compute_dtype(config.AUTO)
        lines.append(f"{w} walkers: the {picked} form ({seen}); max |d| to plain f32 "
                     f"{err[w, 'f32']:.3e}, f64 {err[w, 'f64']:.3e}; device ms warp "
                     f"{ms[w, 'warp']:.4f}, thread {ms[w, 'thread']:.4f}")
    args1 = (ll.nodes, ll.weights, T[:1], R[:1])
    kw1 = dict(k_ext=ll.k_ext, ebv=ebv[:1], band_ids=ll.band_ids)
    plain_ms = cuda_ms(lambda: bandflux_pointwise_plain(*args1, **kw1))
    one = bound_fields(N * K * QUAD_TERM, N * 4 * 4 + 4)
    phase("K3 forms", f"crossover at {cross} walkers x {N} points ({sc3.K3_THREAD_PAIRS_PER_SM} "
          f"pairs an SM, {n_sm} SMs); the two forms bit-equal in f32 and f64 at each width, "
          f"and within 1e-5 (f32), 1e-12 (f64) relative of the plain version; "
          + "; ".join(lines) + f"; at one walker plain {plain_ms:.4f} ms, bound "
          f"{one['bound_ms']:.6f} ms ({one['bound_by']})")
    return {"max_abs_err": err[1, "f32"], "ms": ms[1, "warp"], "plain_ms": plain_ms, **one}


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
    fits = []
    k3_seen = launched_kernels(lambda: fits.append(model.evaluate(t, np.asarray(lc["filter"]),
                                                                  *med)), "bandflux", calls=1)
    if k3_seen != [k for k in k3_seen if "bandflux_warp_kernel<" in k] or not k3_seen:
        raise AssertionError(f"9b: evaluate at one walker must run K3's warp form, the "
                             f"profiler saw {k3_seen}")
    y_fit = fits[-1]
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
          f"evaluate on the card at the medians (K3's warp form): chi2/dof {chi2_dof:.2f} "
          f"(the JAX CPU probe's "
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


# K5's edge cases, each bit-equal to the plain version on the card
# (tests/test_torch_quantile.py holds the plain version to the JAX function
# on all but "long"): IEEE specials, subnormals, ties, short rows, a row
# length the block does not divide, a row past the block's shared memory
# (the global-memory branch), one and eight percentiles, the ends 0 and 100
K5_EDGE_CASES = ("specials", "subnormal", "all-equal", "n1", "n2", "n3201", "long", "q1", "q8",
                 "q0-100")
K5_Q = [16.0, 50.0, 84.0]


def k5_edge_case(name):
    """(rows (B, N) float32 numpy, percentiles) of K5's edge case ``name``."""
    import numpy as np
    rng = np.random.default_rng(K5_EDGE_CASES.index(name))
    rows = rng.normal(scale=5.0, size=(4, 3200)).astype(np.float32)
    q = K5_Q
    if name == "specials":           # +-0.0, +-inf among normal values, ties at each
        specials = np.array([0.0, -0.0, np.inf, -np.inf], np.float32)
        for r in range(4):
            idx = rng.choice(3200, 800 * (r + 1) // 2, replace=False)
            rows[r, idx] = rng.choice(specials, idx.size)
    elif name == "subnormal":        # below 1.18e-38, both signs, beside zeros and normals
        sub = np.array([1e-45, -1e-45, 1e-40, -1e-40, 1.1e-38, -1.1e-38, 0.0, -0.0], np.float32)
        rows[:2] = rng.choice(sub, size=(2, 3200))
        rows[2:, ::2] = rng.choice(sub, size=(2, 1600))
    elif name == "all-equal":
        rows[:] = np.float32(2.5)
        rows[1] = np.float32(-0.0)
    elif name == "n1":
        rows = rows[:, :1]
    elif name == "n2":
        rows = rows[:, :2]
    elif name == "n3201":
        rows = rng.normal(scale=5.0, size=(4, 3201)).astype(np.float32)
    elif name == "long":             # 280 KB of keys: past the block's shared-memory limit
        rows = rng.normal(scale=5.0, size=(3, 70000)).astype(np.float32)
        rows[2, ::7] = np.float32(1.0)
    elif name == "q1":
        q = [50.0]
    elif name == "q8":
        q = [0.0, 5.0, 16.0, 25.0, 50.0, 75.0, 84.0, 100.0]
    elif name == "q0-100":
        q = [0.0, 100.0]
    return rows, q


def k5_edge_cases_match(dev):
    """K5 on every edge case against the plain version on the same card,
    bit for bit; returns the number of percentiles compared."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import quantile as kq
    from lightcurve_fitting_tpu_torch.ops.quantile import percentile_f32_plain
    n = 0
    for name in K5_EDGE_CASES:
        rows, q = k5_edge_case(name)
        x = torch.as_tensor(rows, device=dev)
        got, want = kq.percentile_rows(x, q), percentile_f32_plain(x, q, axis=1)
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"K5 edge case {name}: {int((got != want).sum())} of "
                                 f"{got.numel()} percentiles differ from the plain version")
        n += got.numel()
    return n


def k5_ops(keys, n_q):
    """The radix select's integer operations on ``keys`` values: the key
    and the first pass's digit and add (5), then in each of three passes
    the key's load, the 2Q prefix compares, the digit (2) and the add; at
    INT32_OPS, not the FP32 rate."""
    return keys * (5 + 3 * (1 + 2 * n_q + 2 + 1))


def phase_k4s_k5(seed=7):
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.bolometric import _pseudo_grid
    from lightcurve_fitting_tpu_torch.kernels import epoch_bb, quantile as kq
    from lightcurve_fitting_tpu_torch.ops.quantile import percentile_f32_plain
    from time_port_kernels import device_ms

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
    q = K5_Q
    got = kq.percentile_rows(flat, q)
    ref = percentile_f32_plain(flat, q, axis=1)
    if not torch.equal(got, ref):
        raise AssertionError(f"K5: {int((got != ref).sum())} percentiles differ from the plain "
                             "version")
    n_edge = k5_edge_cases_match(dev)
    k5_kernel = expect_kernel(lambda: kq.percentile_rows(flat, q), "percentile_kernel", "<6>")
    qs = torch.tensor([0.16, 0.50, 0.84], device=dev)
    lib = torch.quantile(flat, qs, dim=1, interpolation="linear")
    lib_err = float(((lib.double() - got).abs() / got.abs()).max())
    p_events_ms = cuda_ms(lambda: kq.percentile_rows(flat, q))
    p_ms = device_ms(lambda: kq.percentile_rows(flat, q), "percentile_kernel", 20, 1)[0]
    p_plain_ms = cuda_ms(lambda: percentile_f32_plain(flat, q, axis=1), repeats=5)
    lib_ms = cuda_ms(lambda: torch.quantile(flat, qs, dim=1, interpolation="linear"))
    p_bound = bound_fields(k5_ops(flat.numel(), len(q)),
                           flat.numel() * 4 + len(q) * E * 4 * 8, lib_ms, rate=INT32_OPS)
    bisection_bound = bound(E * 4 * (32 * 2 * len(q) * S + 4 * S), 0)[0]
    phase("K5", f"{E * 4} rows x {S}: percentiles 16/50/84 bit-equal to the plain version "
          f"(torch.quantile in f32 differs by up to {lib_err:.1e} relative); the edge cases "
          f"({', '.join(K5_EDGE_CASES)}: {n_edge} percentiles) bit-equal; the profiler saw "
          f"{k5_kernel}; kernel {p_ms:.4f} ms (the profiler's device time; events "
          f"{p_events_ms:.4f}) vs plain {p_plain_ms:.4f} ms vs torch.quantile "
          f"{lib_ms:.4f} ms, bound {p_bound['bound_ms']:.4f} ms ({p_bound['bound_by']}: the "
          f"radix select's bytes against its integer operations; the bisection's compares "
          f"bounded it at {bisection_bound:.4f} ms)")
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


# ------------------------------------------------- the sequential bolometric path

# K10 and its half-step on SN 2016bkv's SEDs: the epochs at res = 1 day with
# at least one detected filter (79 of 91), each under the default priors and
# under KDE temperature priors of 512 (subsampled from 5000) and 100
# components, with and without the intrinsic scatter, 64 states each
SED_STATES = 64
SED_REL = {"f32": 1e-5, "f64": 1e-12}    # of SEDLogPosterior.term_scales
SED_PATH_WALKERS = 5                     # calculate_bolometric's 10 walkers, a half
SED_WIDE = 4096
# the JAX package's float64 CPU references of 13c and 13d
# (tests/test_torch_sed.py::jax_sequential_bolometric, jax_sed_acceptance)
SED_REFERENCE = os.path.join("tests", "jax_sequential_bolometric.json")
SED_SEEDS, SED_WALKERS, SED_BURNIN, SED_STEPS = tuple(range(1, 9)), 64, 300, 300
SED_WIDE_WALKERS = 128                   # 13d past the run form's block: K10's half-step
SED_CHAIN_SEEDS = (7, 8, 9)              # 13c's min_nfilt=1 seeds, as the JAX reference's
SED_PROFILE_MJD_MAX = 57495.0            # 13c profiles the curve up to here: 15 fits, 6 chained
SED_SPLIT = {"K10 (initial state)": ("logpost_warp_kernel",),
             "K10 run": ("stretch_run_kernel",)}
# what a plain SED log-posterior launches on the card, and K10 does not
PLAIN_MARKS = ("log_kernel", "exp_kernel", "logsumexp", "clamp", "where", "pow_tensor",
               "reduce_kernel")


def sn2016bkv_seds():
    """SN 2016bkv's per-epoch SEDs at res = 1 day, as calculate_bolometric
    prepares them (91 epochs; the port's host code)."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.bolometric import _prepare_epoch_seds
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    lc = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc.meta.update(META)
    dmag = np.ma.MaskedArray(lc["dmag"])
    lc = lc[np.isfinite(np.ma.filled(dmag.astype(float), np.nan)) & np.ma.filled(dmag > 0, False)]
    with contextlib.redirect_stdout(io.StringIO()):     # per-epoch extinction notes
        return _prepare_epoch_seds(lc, 1.0, ())


def n_detected(epoch1):
    return len(set(epoch1.where(nondet=False)["filter"]))


def sed_priors(which, use_sigma, kdes):
    from lightcurve_fitting_tpu_torch.models import GaussianPrior, LogUniformPrior, UniformPrior
    first = UniformPrior(1.0, 100.0) if which == "default" else kdes[which]
    return [first, LogUniformPrior(0.01, 1000.0)] + ([GaussianPrior(0.0, 10.0)] if use_sigma
                                                      else [])


def sed_kdes():
    """The KDE temperature priors of K10's checks: 512 components subsampled
    from 5000 draws, and 100 (all of them)."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.models import KDEPrior
    rng = np.random.default_rng(21)
    return {"kde512": KDEPrior(rng.normal(10.7, 0.3, 5000)),
            "kde100": KDEPrior(rng.normal(10.7, 0.3, 100))}


def sed_states(rng, ndim, W, dev):
    """W float64 states around SN 2016bkv's temperatures and radii: R < 0
    (outside every prior) in state 7, T = -1 and T = 0 in states 8 and 9
    (outside the uniform prior, inside a KDE one: zero flux)."""
    import numpy as np
    import torch
    p = np.abs(rng.normal([10.0, 4.0, 1.0][:ndim], [3.0, 1.5, 0.5][:ndim], size=(W, ndim)))
    if W > 9:
        p[7, 1] = -0.5
        p[8, 0], p[9, 0] = -1.0, 0.0
    return torch.as_tensor(p, device=dev).contiguous()


def kde_ops(n):
    """What the KDE prior's log-density needs a walker over ``n`` components:
    one pass of a subtraction, a multiply by 1/bandwidth, a square, the max,
    the add and an exp each (float64; the kernel's separate max pass is its
    own cost, not the function's)."""
    return n * (5 + SFU)


def k10_ops(lp, W):
    """K10's operations on W walkers: per point the Clenshaw recurrence (3 a
    link), ~6 float32 operations, ln T and the exp (float32); ~8 float64
    operations, a log and a division; per walker the priors (a log, or the
    KDE prior's ``kde_ops``). Returns (float32 ops, float64 ops)."""
    from lightcurve_fitting_tpu_torch.kernels import sed
    N, K = lp.coef.shape
    kde = sed.kde_prior_of(lp.priors)
    prior = kde_ops(len(kde.samples)) if kde is not None else 2 + SFU
    return (W * N * (3 * (K - 1) + 6 + 2 * SFU),
            W * (N * (8 + 2 * SFU) + prior + 4 + SFU))


def k10_bound(lp, W, extra64=0.0, library_ms=None):
    """K10's bound on W walkers: the larger of the float32 and float64
    operations' times (separate pipes, which overlap across warps), against
    the bytes (the states and the values, the points' rows, the
    components); ``extra64``: float64 operations besides (the half-step's
    proposals)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sed
    o32, o64 = k10_ops(lp, W)
    f32 = lp.compute_dtype == torch.float32
    t32 = bound(o32, 0, FP32_FLOPS if f32 else FP64_FLOPS)[0]
    t64 = bound(o64 + extra64, 0, FP64_FLOPS)[0]
    N, K = lp.coef.shape
    kde = sed.kde_prior_of(lp.priors)
    nbytes = (W * (lp.ndim + 1) * 8 + N * (K + 2) * (4 if f32 else 8) + 3 * N * 8
              + (8 * len(kde.samples) if kde is not None else 0))
    t_bytes = 1e3 * nbytes / HBM_BYTES
    return {"bound_ms": max(t32, t64, t_bytes),
            "bound_by": "operations" if max(t32, t64) >= t_bytes else "bytes",
            "library_ms": library_ms}


def phase_k10(groups, seed=18):
    """K10 against its plain version on every epoch of at least one filter;
    its times at the path's width and at 4096 walkers, with the KDE
    prior's."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.bolometric import SEDLogPosterior
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import sed
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    z = META["redshift"]
    kdes = sed_kdes()
    epochs = [g for g in groups if n_detected(g) >= 1]
    rng = np.random.default_rng(seed)
    worst, counts = {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            for which in ("default", "kde512", "kde100"):
                for use_sigma in (False, True):
                    key = (label, which, use_sigma)
                    worst[key], counts[key] = (0.0, 0.0), [0, 0]
                    for ep in epochs:
                        pri = sed_priors(which, use_sigma, kdes)
                        lp = SEDLogPosterior(ep, pri, z, 0.0, {}, use_sigma,
                                             device=dev)
                        q = sed_states(rng, lp.ndim, SED_STATES, dev)
                        n0 = kernels.LAUNCHES["sed_logpost"]
                        got = sed.log_posterior(lp, q)
                        if kernels.LAUNCHES["sed_logpost"] != n0 + 1:
                            raise AssertionError("K10 did not count its launch")
                        d = compare_ll(f"K10 {key}", got, lp.forward_plain(q), SED_REL[label],
                                       scale=lp.term_scales(q))
                        worst[key] = (max(worst[key][0], d[0]), max(worst[key][1], d[1]))
                        counts[key][0] += d[2]
                        counts[key][1] += int(torch.isneginf(got).sum())
        finally:
            config.set_compute_dtype(config.AUTO)

    # times (float32, the card's default) on the 9-filter epoch (11 points)
    nine = next(g for g in epochs if n_detected(g) == 9)
    times = {}
    for which in ("default", "kde512"):
        lp = SEDLogPosterior(nine, sed_priors(which, False, kdes), z, device=dev)
        for W in (SED_PATH_WALKERS, SED_WIDE):
            q = sed_states(np.random.default_rng(W), 2, W, dev)
            if W > 9:
                q[7:10] = q[10:13]                      # all inside the priors
            fn = lambda: sed.log_posterior(lp, q)       # noqa: E731
            if W == SED_PATH_WALKERS and which == "default":
                name = expect_kernel(fn, "logpost_warp_kernel", "SEDWarpModel")
            times[(which, W)] = dict(
                ms=float(np.nanmin(device_ms(fn, "logpost_warp_kernel", 20, 3))),
                events=cuda_ms(fn),
                plain=cuda_ms(lambda: lp.forward_plain(q), repeats=5), lp=lp, q=q)
    # the KDE prior alone: its plain version and torch.logsumexp over the
    # components (the library call), at both widths
    kde = kdes["kde512"]
    comp = kde.components(dev)
    kde_rows = {}
    for W in (SED_PATH_WALKERS, SED_WIDE):
        t = times[("kde512", W)]["q"][:, 0].contiguous()
        zz = (t[:, None] - comp) / kde.bandwidth
        a = -0.5 * zz * zz
        kde_rows[W] = dict(plain=cuda_ms(lambda: kde.logp(t), repeats=5),
                           library=cuda_ms(lambda: torch.logsumexp(a, dim=-1)),
                           share=times[("kde512", W)]["ms"] - times[("default", W)]["ms"])
    rows = {}
    for which in ("default", "kde512"):
        for W in (SED_PATH_WALKERS, SED_WIDE):
            t = times[(which, W)]
            rows[(which, W)] = {**k10_bound(t["lp"], W), "ms": t["ms"], "plain_ms": t["plain"]}
    kde_bound = {W: bound(W * kde_ops(len(kde.samples)), 8 * len(kde.samples) + 16 * W,
                          FP64_FLOPS) for W in kde_rows}
    phase("K10", f"in {time.perf_counter() - t_phase:.1f} s: "
          f"{name}: against its plain version (f32 compute <= {SED_REL['f32']:.0e}, "
          f"f64 <= {SED_REL['f64']:.0e} of the term scale; -inf sets equal) on {len(epochs)} "
          f"SN 2016bkv epochs x {SED_STATES} states: "
          + "; ".join(f"{lab} {wh}{' sigma' if us else ''}: max |d| {w[0]:.3e} (scaled "
                      f"{w[1]:.2e}), {counts[(lab, wh, us)][0]} finite, "
                      f"{counts[(lab, wh, us)][1]} -inf"
                      for (lab, wh, us), w in worst.items())
          + "; times (f32, the 9-filter epoch, 11 points; the profiler's device time, events, "
          "plain, bound): "
          + "; ".join(f"{wh} W={W} {times[(wh, W)]['ms']:.4f}, {times[(wh, W)]['events']:.4f}, "
                      f"{times[(wh, W)]['plain']:.4f}, {rows[(wh, W)]['bound_ms']:.6f} ms"
                      for (wh, W) in times)
          + "; the KDE prior (512 components): "
          + "; ".join(f"W={W} its share of K10 {r['share']:.4f} ms, plain {r['plain']:.4f}, "
                      f"torch.logsumexp {r['library']:.4f}, bound {kde_bound[W][0]:.6f} ms"
                      for W, r in kde_rows.items()))
    f32_err = max(w[0] for (lab, _, _), w in worst.items() if lab == "f32")
    return {"max_abs_err": f32_err, **rows[("default", SED_PATH_WALKERS)]}


def check_sed_half_step(name, lp, x0, seed, rel):
    """K10's half-step (h = 0, 1) against the plain half-step under shared
    draws on the float64 state x0 (2, half, ndim), as check_half_step;
    then K10 at the states the kernel left gives its stored values bit for
    bit. Returns (near-ties, accepts, max |d logp|)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import common, sed
    dev = x0.device
    half, ndim = x0.shape[1], x0.shape[2]
    l0 = sed.log_posterior(lp, x0.reshape(-1, ndim)).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u_z = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, (half,), generator=g, device=dev)
    u_acc = torch.rand(half, generator=g, device=dev, dtype=x0.dtype)
    ties, acc, max_abs = 0, 0, 0.0
    xs, ls = x0.clone(), l0.clone()              # two half-steps in a row
    a_s = torch.zeros((2, half), dtype=torch.int32, device=dev)
    for h in (0, 1):
        what = f"{name} h={h}"
        xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ck = torch.empty_like(x0)
        clk = torch.empty((2, half), dtype=torch.float64, device=dev)
        sed.stretch_half_step(lp, xk, lk, h, u_z, j, u_acc, 2.0, None, None, ck, clk, ak)
        sed.stretch_half_step_plain(lp, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
        sed.stretch_half_step(lp, xs, ls, h, u_z, j, u_acc, 2.0, n_accept=a_s)
        torch.cuda.synchronize()
        agree = ak[h] == ap[h]
        y, zst = common.propose_stretch(u_z, j, x0[h], x0[1 - h])
        gap = (torch.log(u_acc)
               - ((ndim - 1.0) * torch.log(zst) + lp.forward_plain(y) - l0[h])).abs()
        tie_ok = gap <= 1e-5 * (lp.term_scales(y) + lp.term_scales(x0[h]))
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"{what}: {int((~agree & ~tie_ok).sum())} accept flags differ "
                                 "away from near-ties")
        if not torch.equal(xk[h][agree], xp[h][agree]):
            raise AssertionError(f"{what}: new states differ where the flags agree")
        if not torch.equal(xk[1 - h], x0[1 - h]) or not torch.equal(ak[1 - h], ap[1 - h]) \
                or not torch.equal(ck[h], xk[h]) or not torch.equal(clk[h], lk[h]):
            raise AssertionError(f"{what}: wrong half or chain slot written")
        d = compare_ll(f"{what} new logp", lk[h][agree], lpp[h][agree], rel,
                       scale=lp.term_scales(xk[h])[agree])
        max_abs = max(max_abs, d[0])
        ties += int((~agree).sum())
        acc += int(ak[h].sum())
    again = sed.log_posterior(lp, xs.reshape(-1, ndim)).reshape(2, half)
    if not torch.equal(again, ls):
        raise AssertionError(f"{name}: K10 at the half-steps' states differs from their stored "
                             f"values at {int((again != ls).sum())} walkers")
    return ties, acc, max_abs


def phase_k10_half(groups, seed=19):
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.bolometric import SEDLogPosterior
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import sed
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    z = META["redshift"]
    kdes = sed_kdes()
    nine = next(g for g in groups if n_detected(g) == 9)
    single = next(g for g in groups if n_detected(g) == 1
                  and abs(float(np.median(np.asarray(g["MJD"], float))) - 57487.1) < 0.5)
    res = {}
    rng = np.random.default_rng(seed)
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            for ep_name, ep, which in (("nine", nine, "default"), ("single", single, "kde512")):
                for use_sigma in (False, True):
                    lp = SEDLogPosterior(ep, sed_priors(which, use_sigma, kdes), z,
                                         0.0, {}, use_sigma, device=dev)
                    for half in (SED_PATH_WALKERS, SED_WIDE // 2):
                        centre = [10.7, 3.6, 1.0][:lp.ndim]
                        x0 = torch.as_tensor(np.abs(np.array(centre) * (
                            1 + 0.05 * rng.normal(size=(2, half, lp.ndim)))), device=dev)
                        res[(label, ep_name, use_sigma, half)] = check_sed_half_step(
                            f"K10 half {label} {ep_name} {half}", lp, x0.contiguous(), seed,
                            SED_REL[label])
        finally:
            config.set_compute_dtype(config.AUTO)
    # times (f32) on the 9-filter epoch
    lp = SEDLogPosterior(nine, sed_priors("default", False, kdes), z, device=dev)
    timed = {}
    for half in (SED_PATH_WALKERS, SED_WIDE // 2):
        x0 = torch.as_tensor(np.abs(np.array([12.0, 3.0]) * (
            1 + 0.02 * rng.normal(size=(2, half, 2)))), device=dev).contiguous()
        l0 = sed.log_posterior(lp, x0.reshape(-1, 2)).reshape(2, half)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        u_z = torch.rand(half, generator=g, device=dev, dtype=torch.float64)
        j = torch.randint(0, half, (half,), generator=g, device=dev)
        u_acc = torch.rand(half, generator=g, device=dev, dtype=torch.float64)
        xk, lk = x0.clone(), l0.clone()
        ak = torch.zeros((2, half), dtype=torch.int32, device=dev)

        def step():
            sed.stretch_half_step(lp, xk, lk, 0, u_z, j, u_acc, 2.0, n_accept=ak,
                                  check_partners=False)
        if half == SED_PATH_WALKERS:
            name = expect_kernel(step, "stretch_half_step_kernel", "SEDWarpModel")
        xp, lpp = x0.clone(), l0.clone()
        plain = cuda_ms(lambda: sed.stretch_half_step_plain(lp, xp, lpp, 0, u_z, j, u_acc, 2.0),
                        repeats=5)
        bnd = k10_bound(lp, half, extra64=half * PROPOSAL)
        timed[half] = {"ms": float(np.nanmin(device_ms(step, "stretch_half_step_kernel", 20, 3))),
                       "events": cuda_ms(step), "plain_ms": plain, **bnd}
    phase("K10 half", f"in {time.perf_counter() - t_phase:.1f} s: "
          f"{name}: half-steps h=0,1 (f64 state and logp, a warp per walker) "
          "against the plain half-step under shared draws, at half "
          + "; ".join(f"{h} {lab} {ep}{' sigma' if us else ''}: {c[1]} accepts, {c[0]} "
                      f"near-ties, new-logp max |d| {c[2]:.3e}"
                      for (lab, ep, us, h), c in res.items())
          + " (flags agree except the near-ties, new states bit-equal where they agree; "
          f"<= {SED_REL['f32']:.0e} / {SED_REL['f64']:.0e} of the term scale; K10 at the states "
          "two half-steps left gives their stored values bit for bit); times (f32, the 9-filter "
          "epoch; device, events, plain, bound): "
          + "; ".join(f"half {h} {t['ms']:.4f}, {t['events']:.4f}, {t['plain_ms']:.4f}, "
                      f"{t['bound_ms']:.6f} ms" for h, t in timed.items()))
    err = max(c[2] for (lab, _, _, _), c in res.items() if lab == "f32")
    t = timed[SED_PATH_WALKERS]
    return {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}


def k10_run_bound(lp, half, n_prop, thin_by=1):
    """K10's run form's bound over n_prop proposals of 2 x half walkers:
    the operations of the 2 n_prop half-steps it replaces (k10_ops and the
    proposals, the two pipes' larger time), against its bytes read and
    written once (the state and its values, the draws, the table and the
    components, the thinned chain, the accept counts)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sed
    W = 2 * half * n_prop
    o32, o64 = k10_ops(lp, W)
    f32 = lp.compute_dtype == torch.float32
    t32 = bound(o32, 0, FP32_FLOPS if f32 else FP64_FLOPS)[0]
    t64 = bound(o64 + W * PROPOSAL, 0, FP64_FLOPS)[0]
    N, K = lp.coef.shape
    kde = sed.kde_prior_of(lp.priors)
    nd = lp.ndim
    nbytes = (2 * 2 * half * (nd + 1) * 8 + W * 3 * 8 + N * (K + 2) * (4 if f32 else 8)
              + 3 * N * 8 + (8 * len(kde.samples) if kde is not None else 0)
              + (n_prop // thin_by) * 2 * half * (nd + 1) * 8 + 2 * half * 4)
    t_bytes = 1e3 * nbytes / HBM_BYTES
    return {"bound_ms": max(t32, t64, t_bytes),
            "bound_by": "operations" if max(t32, t64) >= t_bytes else "bytes",
            "library_ms": None}


def sed_run_draws(n, half, dtype, dev, seed):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.rand((n, 2, half), generator=g, device=dev, dtype=dtype),
            torch.randint(0, half, (n, 2, half), generator=g, device=dev),
            torch.rand((n, 2, half), generator=g, device=dev, dtype=dtype))


def sed_run_pair(lp, x0, l0, draws, thin_by):
    """K10's run form and the loop of K10 half-steps it replaces, from the
    same state and draws: ((x, logp, n_accept, chain_x, chain_logp) of each)."""
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.kernels import sed
    u_z, j, u_acc = draws
    n, _, half = u_z.shape
    out = []
    for run in (True, False):
        x, logp = x0.clone(), l0.clone()
        acc = torch.zeros((2, half), dtype=torch.int32, device=x0.device)
        cx = torch.empty((n // thin_by, 2, half, x0.shape[2]), dtype=x0.dtype, device=x0.device)
        cl = torch.empty((n // thin_by, 2, half), dtype=torch.float64, device=x0.device)
        before = dict(kernels.LAUNCHES)
        if run:
            sed.stretch_run(lp, x, logp, u_z, j, u_acc, 2.0, None, None, cx, cl, acc, thin_by)
            want = {"sed_run": 1}
        else:
            for s in range(n):
                st = s % thin_by == thin_by - 1
                for h in (0, 1):
                    sed.stretch_half_step(lp, x, logp, h, u_z[s, h], j[s, h], u_acc[s, h], 2.0,
                                          None, None, cx[s // thin_by] if st else None,
                                          cl[s // thin_by] if st else None, acc,
                                          check_partners=False)
            want = {"sed_half_step": 2 * n}
        moved = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        if moved != want:
            raise AssertionError(f"K10 run: launches {moved}, expected {want}")
        out.append((x, logp, acc, cx, cl))
    torch.cuda.synchronize()
    return out


def run_against_plain(name, lp, x0, l0, draws, rel):
    """K10's run form against stretch_run_plain on the same draws (thin_by
    1), to phase 4's rule: the accept flags of every half-step agree except
    at near-ties (gap <= 1e-5 of the term scales), the states are equal where
    they agree and the log-posteriors within rel of the term scale. The
    chains agree up to the first half-step whose flags differ (the walkers
    there at a near-tie) and are compared no further. Returns (half-steps
    compared, near-ties, max |d logp|)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import common, sed
    u_z, j, u_acc = draws
    n, _, half = u_z.shape
    nd = x0.shape[2]
    res = []
    for fn in (sed.stretch_run, sed.stretch_run_plain):
        x, logp = x0.clone(), l0.clone()
        acc = torch.zeros((2, half), dtype=torch.int32, device=x0.device)
        cx = torch.empty((n, 2, half, nd), dtype=x0.dtype, device=x0.device)
        cl = torch.empty((n, 2, half), dtype=torch.float64, device=x0.device)
        fn(lp, x, logp, u_z, j, u_acc, 2.0, None, None, cx, cl, acc, 1)
        res.append((cx, cl))
    (ck, lk), (cp, lpl) = res
    prev_x, prev_l = x0, l0
    max_abs, steps = 0.0, 0
    for s in range(n):
        for h in (0, 1):
            # the state before this half-step (equal in both runs so far)
            x_move = prev_x[h]
            x_other = cp[s, 0] if h == 1 else prev_x[1]
            # a walker accepted where its state moved (each run's stored
            # log-posteriors are its own: the plain run's differ in their last
            # bits under the KDE prior)
            agree = (ck[s, h] != x_move).any(-1) == (cp[s, h] != x_move).any(-1)
            if not bool(agree.all()):
                y, zst = common.propose_stretch(u_z[s, h], j[s, h], x_move, x_other)
                gap = (torch.log(u_acc[s, h]) - ((nd - 1.0) * torch.log(zst)
                                                  + lp.forward_plain(y) - prev_l[h])).abs()
                tie = gap <= 1e-5 * (lp.term_scales(y) + lp.term_scales(x_move))
                if not bool((agree | tie).all()):
                    raise AssertionError(f"{name}: proposal {s} half {h}: accept flags differ "
                                         "away from near-ties")
            if not torch.equal(ck[s, h][agree], cp[s, h][agree]):
                raise AssertionError(f"{name}: proposal {s} half {h}: states differ where the "
                                     "flags agree")
            d = compare_ll(f"{name} proposal {s} half {h}", lk[s, h][agree], lpl[s, h][agree],
                           rel, scale=lp.term_scales(ck[s, h])[agree])
            max_abs = max(max_abs, d[0])
            steps += 1
            if not bool(agree.all()):
                return steps, int((~agree).sum()), max_abs
            prev_x = torch.stack([ck[s, 0], prev_x[1]]) if h == 0 else ck[s]
            prev_l = torch.stack([lk[s, 0], prev_l[1]]) if h == 0 else lk[s]
    return steps, 0, max_abs


SED_RUN_PROPOSALS = 300      # K10's run form against 600 half-step launches
SED_RUN_PLAIN = 60           # ... and against its plain version (~5 ms a half-step)
SED_RUN_HALVES = (SED_PATH_WALKERS, 32)   # the path's half and the run form's largest


def phase_k10_run(groups, seed=20):
    """K10's run form (a whole segment in one launch): against the K10
    half-steps it replaces, bit for bit, and against its plain version; K10
    at its last states; its time against those 600 launches."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.bolometric import SEDLogPosterior
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import sed
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    z = META["redshift"]
    kdes = sed_kdes()
    nine = next(g for g in groups if n_detected(g) == 9)
    single = next(g for g in groups if n_detected(g) == 1
                  and abs(float(np.median(np.asarray(g["MJD"], float))) - 57487.1) < 0.5)
    rng = np.random.default_rng(seed)
    same, plain = {}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            for ep_name, ep, which in (("nine", nine, "default"), ("single", single, "kde512")):
                for use_sigma in (False, True):
                    lp = SEDLogPosterior(ep, sed_priors(which, use_sigma, kdes), z, 0.0, {},
                                         use_sigma, device=dev)
                    for half in SED_RUN_HALVES:
                        centre = [10.7, 3.6, 1.0][:lp.ndim]
                        x0 = torch.as_tensor(np.abs(np.array(centre) * (
                            1 + 0.05 * rng.normal(size=(2, half, lp.ndim)))),
                            device=dev).contiguous()
                        l0 = sed.log_posterior(lp, x0.reshape(-1, lp.ndim)).reshape(2, half)
                        draws = sed_run_draws(SED_RUN_PROPOSALS, half, torch.float64, dev,
                                              seed + half)
                        key = (label, ep_name, use_sigma, half)
                        for thin_by in (1, 2):
                            run, loop = sed_run_pair(lp, x0, l0, draws, thin_by)
                            what = ("x", "logp", "n_accept", "chain_x", "chain_logp")
                            differ = [w for w, a, b in zip(what, run, loop)
                                      if not torch.equal(a, b)]
                            if differ:
                                raise AssertionError(f"K10 run {key} thin_by {thin_by}: {differ} "
                                                     f"differ from {2 * SED_RUN_PROPOSALS} "
                                                     "half-step launches")
                            again = sed.log_posterior(lp, run[0].reshape(-1, lp.ndim))
                            if not torch.equal(again.reshape(2, half), run[1]):
                                raise AssertionError(f"K10 run {key}: K10 at the run's last "
                                                     "states differs from their stored values")
                            same[key] = int(run[2].sum())
                        plain[key] = run_against_plain(
                            f"K10 run {key}", lp, x0, l0,
                            tuple(d[:SED_RUN_PLAIN].contiguous() for d in draws), SED_REL[label])
        finally:
            config.set_compute_dtype(config.AUTO)

    # times (f32 compute, f64 state): the run form's one launch against the
    # 600 half-step launches it replaces, on the 9-filter epoch under the
    # default priors and on the single-filter one under the KDE prior
    timed = {}
    for ep_name, ep, which in (("nine", nine, "default"), ("single", single, "kde512")):
        lp = SEDLogPosterior(ep, sed_priors(which, False, kdes), z, device=dev)
        for half in SED_RUN_HALVES:
            x0 = torch.as_tensor(np.abs(np.array([10.7, 3.6]) * (
                1 + 0.02 * rng.normal(size=(2, half, 2)))), device=dev).contiguous()
            l0 = sed.log_posterior(lp, x0.reshape(-1, 2)).reshape(2, half)
            u_z, j, u_acc = sed_run_draws(SED_RUN_PROPOSALS, half, torch.float64, dev, seed)
            x, logp = x0.clone(), l0.clone()
            acc = torch.zeros((2, half), dtype=torch.int32, device=dev)
            cx = torch.empty((SED_RUN_PROPOSALS, 2, half, 2), dtype=torch.float64, device=dev)
            cl = torch.empty((SED_RUN_PROPOSALS, 2, half), dtype=torch.float64, device=dev)

            def run():
                sed.stretch_run(lp, x, logp, u_z, j, u_acc, 2.0, None, None, cx, cl, acc,
                                check_partners=False)

            def loop():
                for s in range(SED_RUN_PROPOSALS):
                    for h in (0, 1):
                        sed.stretch_half_step(lp, x, logp, h, u_z[s, h], j[s, h], u_acc[s, h],
                                              2.0, None, None, cx[s], cl[s], acc,
                                              check_partners=False)
            if half == SED_PATH_WALKERS and which == "default":
                name = expect_kernel(run, "stretch_run_kernel", "SEDWarpModel", calls=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sed.stretch_run_plain(lp, x, logp, u_z, j, u_acc, 2.0, None, None, cx, cl, acc)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            timed[(ep_name, half)] = dict(
                ms=float(np.nanmin(device_ms(run, "stretch_run_kernel", 5, 3))),
                events=cuda_ms(run, repeats=5),
                loop_dev=2 * SED_RUN_PROPOSALS * float(np.nanmin(device_ms(
                    lambda: sed.stretch_half_step(lp, x, logp, 0, u_z[0, 0], j[0, 0],
                                                  u_acc[0, 0], 2.0, n_accept=acc,
                                                  check_partners=False),
                    "stretch_half_step_kernel", 20, 3))),
                loop_events=cuda_ms(loop, repeats=2), plain_ms=plain_ms,
                **k10_run_bound(lp, half, SED_RUN_PROPOSALS))
    phase("K10 run", f"in {time.perf_counter() - t_phase:.1f} s: {name}: "
          f"{SED_RUN_PROPOSALS} proposals (f64 state, a warp per walker, one block) bit-equal "
          f"to {2 * SED_RUN_PROPOSALS} K10 half-step launches on the same draws (x, logp, "
          "n_accept, chain_x, chain_logp; thin_by 1 and 2), and K10 at its last states their "
          "stored values: "
          + "; ".join(f"{lab} {ep}{' sigma' if us else ''} half {h}: {a} accepts"
                      for (lab, ep, us, h), a in same.items())
          + f"; against its plain version over {SED_RUN_PLAIN} proposals (flags agree except "
          f"near-ties, states bit-equal where they agree, logp within {SED_REL['f32']:.0e} / "
          f"{SED_REL['f64']:.0e} of the term scale): "
          + "; ".join(f"{lab} {ep}{' sigma' if us else ''} half {h}: {c[0]} half-steps, {c[1]} "
                      f"near-ties, max |d logp| {c[2]:.3e}"
                      for (lab, ep, us, h), c in plain.items())
          + f"; times of {SED_RUN_PROPOSALS} proposals (f32 compute; the run's device time, "
          "its events, the 600 half-steps' device time and events, the plain run, bound): "
          + "; ".join(f"{ep} half {h} {t['ms']:.4f}, {t['events']:.4f}, {t['loop_dev']:.4f}, "
                      f"{t['loop_events']:.4f}, {t['plain_ms']:.1f}, {t['bound_ms']:.6f} ms"
                      for (ep, h), t in timed.items()))
    err = max(c[2] for (lab, _, _, _), c in plain.items() if lab == "f32")
    t = timed[("nine", SED_PATH_WALKERS)]
    return {"max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}


def sed_reference():
    with open(os.path.join(REPO, SED_REFERENCE)) as f:
        return json.load(f)


def mcmc_columns(t):
    """The MCMC medians and half-widths of T and R of a bolometric table (the
    port's, or the JAX reference's dict of lists) as float arrays, NaN where
    masked: {"temp": (medians, half-widths), "radius": ...}."""
    import numpy as np

    def col(name):
        return np.ma.filled(np.ma.MaskedArray(t[name]).astype(float), np.nan)

    return {c: (col(f"{c}_mcmc"), (col(f"d{c}_mcmc0") + col(f"d{c}_mcmc1")) / 2)
            for c in ("temp", "radius")}


def width_distances(t, ref):
    """Each epoch's MCMC median of T and R against the JAX package's, in units
    of hypot(the two half-widths)."""
    import numpy as np
    a, b = mcmc_columns(ref), mcmc_columns(t)
    return {c: np.abs(a[c][0] - b[c][0]) / np.hypot(a[c][1], b[c][1]) for c in a}


def seed_distances(tables, refs):
    """Each epoch's median over seeds of the port's MCMC medians (``tables``)
    against the same of the JAX package's (``refs``), in units of
    hypot(both packages' mean half-widths, both packages' standard deviations
    of the medians over their seeds). Also each package's agreement with
    itself: for every pair of its seeds, the share of epochs whose medians
    lie within 2 hypot(half-widths) of each other; and the root mean square
    of each package's seed spread. Returns (distances, {package: {column:
    (pair shares, rms spread)}})."""
    import itertools
    import numpy as np
    cols = {"port": [mcmc_columns(t) for t in tables], "JAX": [mcmc_columns(r) for r in refs]}
    dist, own = {}, {}
    for c in ("temp", "radius"):
        med = {k: np.stack([v[c][0] for v in vs]) for k, vs in cols.items()}
        hw = {k: np.stack([v[c][1] for v in vs]) for k, vs in cols.items()}
        sd = {k: np.std(m, axis=0, ddof=1) for k, m in med.items()}
        scale = np.sqrt(sum(np.mean(hw[k], axis=0) ** 2 + sd[k] ** 2 for k in med))
        dist[c] = np.abs(np.median(med["port"], axis=0) - np.median(med["JAX"], axis=0)) / scale
        for k in med:
            pairs = [float(np.mean(np.abs(med[k][i] - med[k][j])
                                   <= 2 * np.hypot(hw[k][i], hw[k][j])))
                     for i, j in itertools.combinations(range(len(med[k])), 2)]
            own.setdefault(k, {})[c] = (pairs, float(np.sqrt(np.mean(sd[k] ** 2))))
    return dist, own


def within_widths(k, name, rows=slice(None)):
    """The gate on ``width_distances``: within 2 in >= 95% of the epochs (of
    ``rows``) and within 4 in all. Returns (share within 2, max) a column."""
    import numpy as np
    out = {}
    for c, kc in k.items():
        kc = kc[rows]
        if not np.isfinite(kc).all() or np.mean(kc <= 2) < 0.95 or kc.max() > 4:
            raise AssertionError(f"{name}: {c}_mcmc against the JAX package's: share within 2 "
                                 f"{np.mean(kc <= 2):.3f}, max {kc.max():.2f}")
        out[c] = (float(np.mean(kc <= 2)), float(kc.max()))
    return out


def lstsq_consistent(t, ref, groups, name):
    """The least-squares columns: where the epoch has several filters (p0 =
    (10, 10) in both packages) the JAX package's within rtol 1e-6; where it
    has one (p0 = the previous chain's medians) the port's own solve from
    the previous row's medians, under the KDE prior's bounds. Returns the
    largest relative difference of each kind."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.bolometric import blackbody_lstsq
    T = np.ma.filled(np.ma.MaskedArray(t["temp"]).astype(float), np.nan)
    R = np.ma.filled(np.ma.MaskedArray(t["radius"]).astype(float), np.nan)
    npts = np.asarray(t["npoints"], int)
    multi = npts > 1
    rel = 0.0
    for mine, want in ((T, ref["temp"]), (R, ref["radius"])):
        mine, want = mine[multi], np.asarray(want, float)[multi]
        if not np.array_equal(np.isnan(mine), np.isnan(want)):
            raise AssertionError(f"{name}: least-squares failures differ from the JAX package's")
        ok = ~np.isnan(want)
        rel = max(rel, float(np.max(np.abs(mine[ok] / want[ok] - 1), initial=0.0)))
    if not rel <= 1e-6:
        raise AssertionError(f"{name}: least squares {rel:.2e} from the JAX package's (rtol 1e-6)")
    fitted = [g for g in groups if n_detected(g) >= 1]
    fitted = fitted[len(fitted) - len(npts):]       # the epochs with a row
    own = 0.0
    for i in np.flatnonzero(~multi):
        p0 = [float(t["temp_mcmc"][i - 1]), float(t["radius_mcmc"][i - 1])]
        with contextlib.redirect_stdout(io.StringIO()):
            mine = blackbody_lstsq(fitted[i], META["redshift"], p0, (-np.inf, np.inf),
                                   (0.01, 1000.0))
        if np.isnan(T[i]):
            continue                        # a failed solve: masked, as the JAX package's
        own = max(own, abs(mine[0] / T[i] - 1), abs(mine[1] / R[i] - 1))
    if not own <= 1e-6:
        raise AssertionError(f"{name}: a single-filter epoch's least squares {own:.2e} from the "
                             "solve from the previous chain's medians")
    return rel, own, int((~multi).sum())


def phase_sequential_bolometric(groups, smi):
    """13c: calculate_bolometric(batch_mode=False) on the full SN 2016bkv curve."""
    t_phase = time.perf_counter()
    import warnings
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import bolometric as tbol, kernels
    from lightcurve_fitting_tpu_torch.lightcurve import LC

    ref = sed_reference()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_")   # the fits' outpath; they save nothing
    lc0 = LC.read(os.path.join(REPO, "lightcurve_fitting_tpu", "data", "SN2016bkv.csv"))
    lc0.meta.update(META)
    real = tbol.spectrum_mcmc
    fits = []

    def spy(*args, **kwargs):
        before = dict(kernels.LAUNCHES)
        s = real(*args, **kwargs)
        fits.append((type(args[2][0]).__name__,
                     {k: kernels.LAUNCHES[k] - before[k] for k in ("sed_logpost",
                                                                   "sed_half_step", "sed_run")}))
        return s

    def run(lc=lc0, seed=7, **kw):
        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            return tbol.calculate_bolometric(lc.copy(), batch_mode=kw.pop("batch_mode", False),
                                             save_corners=False, seed=seed, outpath=outdir, **kw)

    out, walls, launches = {}, {}, {}

    def counted(label, fn):
        """fn() with the counters reset before; every fit must be one K10
        launch and two launches of K10's run form (the burn-in's segment and
        the production's), no K10 half-step, and nothing else may run."""
        fits.clear()
        kernels.reset_launch_counts()
        t = fn()
        got = dict(kernels.LAUNCHES)
        n = len(fits)
        moved = {k: v for k, v in got.items() if v and not k.startswith("sed_")}
        if moved or got["sed_logpost"] != n or got["sed_run"] != 2 * n \
                or got["sed_half_step"] or any(
                    f[1] != {"sed_logpost": 1, "sed_half_step": 0, "sed_run": 2} for f in fits):
            raise AssertionError(f"13c {label}: launches {got} for {n} fits (1 K10 and 2 K10 "
                                 "runs a fit, no K10 half-step, nothing else)")
        got["kde_fits"] = sum(f[0] == "KDEPrior" for f in fits)
        return t, got

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = fn()
        torch.cuda.synchronize()
        return t, time.perf_counter() - t0

    tbol.spectrum_mcmc = spy
    try:
        (out["defaults"], walls["defaults"]), launches["defaults"] = counted(
            "defaults", lambda: timed(run))
        # min_nfilt=1 at each seed of the JAX reference's; then at seed 7 with
        # batch_mode=True: the chain cut falls at epoch 0 (a single-filter
        # epoch), so nothing batches and the run must give the same table
        chain_runs, chain_walls = {}, {}
        for seed in SED_CHAIN_SEEDS:
            (chain_runs[seed], chain_walls[seed]), got = counted(
                f"min_nfilt_1 seed {seed}", lambda: timed(lambda: run(seed=seed, min_nfilt=1)))
            launches.setdefault("min_nfilt_1", got)
        out["min_nfilt_1"], walls["min_nfilt_1"] = chain_runs[7], chain_walls[7]
        (t_c, _), launches_c = counted(
            "batch_mode=True", lambda: timed(lambda: run(batch_mode=True, min_nfilt=1)))
        # the device's activity (its busy time and the kernels by name) over
        # the curve's first fits, 6 of them chained: a trace of the whole
        # curve holds ~10^5 kernels and takes ~40 s to reduce
        res = []
        (wall_p, prof), launches_p = counted("profiled", lambda: profiled(
            lambda: res.append(run(lc=lc0.where(MJD_max=SED_PROFILE_MJD_MAX), min_nfilt=1)),
            cpu=False))
    finally:
        tbol.spectrum_mcmc = real
    kde_fits = launches["min_nfilt_1"]["kde_fits"]
    if launches_c != launches["min_nfilt_1"]:
        raise AssertionError(f"13c: batch_mode=True launched {launches_c}")
    for c in out["min_nfilt_1"].colnames:
        if not np.array_equal(np.asarray(out["min_nfilt_1"][c]), np.asarray(t_c[c])):
            raise AssertionError(f"13c: batch_mode=True column {c} differs from batch_mode=False")
    averages = prof.key_averages()
    parts, busy = time_split(prof, wall_p, SED_SPLIT, averages)
    del prof
    names = sorted({e.key for e in averages if e.device_type.name == "CUDA"})
    k10_names = [n for n in names if "SEDWarpModel" in n]
    plain_kernels = [n for n in names if any(m in n for m in PLAIN_MARKS)]
    if sorted(next((m for m in ("logpost_warp_kernel", "stretch_run_kernel") if m in n), n)
              for n in k10_names) != ["logpost_warp_kernel", "stretch_run_kernel"] \
            or plain_kernels:
        raise AssertionError(f"13c: the profiler saw K10 as {k10_names} (K10 and its run form "
                             f"expected) and plain kernels {plain_kernels}")
    checks, chained = {}, {}
    for label, t in out.items():
        r = ref["sequential"][label]
        want_rows = {"defaults": 65, "min_nfilt_1": 77}[label]
        if len(t) != want_rows or len(r["MJD"]) != want_rows:
            raise AssertionError(f"13c {label}: {len(t)} rows, the JAX package {len(r['MJD'])}, "
                                 f"{want_rows} expected")
        if not np.allclose(np.asarray(t["MJD"], float), r["MJD"], rtol=1e-12, atol=0):
            raise AssertionError(f"13c {label}: MJD differs from the JAX package's")
        # the medians against the JAX package's at seed 7: every row at the
        # defaults; at min_nfilt=1 the rows up to the first single-filter fit
        # (no earlier chain in their prior). Downstream of the chaining each
        # epoch's temperature prior is a KDE of an earlier chain, so two runs
        # of either package differ by more than their widths (the JAX
        # package's seeds 7 and 8: 26% of the epochs within 2, up to 11.4;
        # PERF.md): there every row holds the port's median over seeds 7-9
        # to the JAX package's, the scale both packages' seed scatter and
        # widths (seed_distances)
        plain = width_distances(t, r)
        first = int(np.flatnonzero(np.asarray(r["npoints"]) == 1)[0]) \
            if label == "min_nfilt_1" else len(t) - 1
        gated = within_widths(plain, f"13c {label}", slice(0, first + 1))
        if label == "min_nfilt_1":
            refs = [r] + [ref["sequential"]["min_nfilt_1_seeds"][str(s_)]
                          for s_ in SED_CHAIN_SEEDS[1:]]
            for s_, t_s in chain_runs.items():
                if not np.allclose(np.asarray(t_s["MJD"], float), r["MJD"], rtol=1e-12, atol=0):
                    raise AssertionError(f"13c {label} seed {s_}: MJD differs from the JAX "
                                         "package's")
            dist, own = seed_distances(list(chain_runs.values()), refs)
            chained[label] = (first, within_widths(dist, f"13c {label} (medians over seeds "
                                                         f"{SED_CHAIN_SEEDS})"),
                              {c: (float(np.mean(k <= 2)), float(k.max()))
                               for c, k in plain.items()}, own)
        checks[label] = (lstsq_consistent(t, r, groups, f"13c {label}"), gated)
    phase("bolometric main path 13c", f"in {time.perf_counter() - t_phase:.1f} s: "
          f"calculate_bolometric(batch_mode=False, "
          f"save_corners=False, seed=7) on the full SN 2016bkv curve: "
          + "; ".join(f"{lab} {len(out[lab])} rows in {walls[lab]:.3f} s "
                      f"({launches[lab]['sed_logpost']} fits, {launches[lab]['kde_fits']} under "
                      f"a KDE prior, {launches[lab]['sed_run']} K10 runs; least "
                      f"squares within {checks[lab][0][0]:.1e} of the JAX package's, "
                      f"{checks[lab][0][2]} single-filter rows within {checks[lab][0][1]:.1e} of "
                      f"their own solve; T, R medians within 2 hypot(half-widths) of the JAX "
                      f"package's in {checks[lab][1]['temp'][0]:.3f}, "
                      f"{checks[lab][1]['radius'][0]:.3f} of the epochs "
                      + ("" if lab not in chained else f"up to the first chained one (row "
                         f"{chained[lab][0]}) ")
                      + f"and at most {checks[lab][1]['temp'][1]:.2f}, "
                      f"{checks[lab][1]['radius'][1]:.2f}"
                      + ("" if lab not in chained else
                         f"; every row, the port's median over seeds {SED_CHAIN_SEEDS} against "
                         f"the JAX package's, in hypot(both packages' widths and seed "
                         f"scatter): {chained[lab][1]['temp'][0]:.3f}, "
                         f"{chained[lab][1]['radius'][0]:.3f} within 2, at most "
                         f"{chained[lab][1]['temp'][1]:.2f}, {chained[lab][1]['radius'][1]:.2f} "
                         f"(seed 7 alone against the JAX package's seed 7 in hypot(widths): "
                         f"{chained[lab][2]['temp'][0]:.3f}, "
                         f"{chained[lab][2]['radius'][0]:.3f} within 2, at most "
                         f"{chained[lab][2]['temp'][1]:.2f}, {chained[lab][2]['radius'][1]:.2f}); "
                         f"each package against itself, the share of epochs within 2 "
                         f"hypot(widths) for the seed pairs 7-8, 7-9, 8-9 and the rms seed "
                         f"scatter: " + "; ".join(
                             f"{k} {c} {', '.join(f'{v:.3f}' for v in o[c][0])}, rms "
                             f"{o[c][1]:.4g}" for k, o in chained[lab][3].items()
                             for c in ("temp", "radius"))
                         + f"; walls at seeds {SED_CHAIN_SEEDS} "
                         + ", ".join(f"{w:.3f}" for w in chain_walls.values()) + " s")
                      + ")" for lab in out)
          + f"; batch_mode=True, min_nfilt=1 bit-equal to batch_mode=False (the cut at epoch "
          f"0); the profiled min_nfilt=1 run to MJD {SED_PROFILE_MJD_MAX} "
          f"({launches_p['sed_logpost']} fits, {launches_p['kde_fits']} under a KDE prior) "
          f"{wall_p:.3f} s, device busy {busy:.4f} s (idle share {1 - busy / wall_p:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
          + f"; the profiler saw {k10_names} and no plain version; JAX reference: "
          f"{ref['run']}; on {smi}")
    if not kde_fits >= 60:
        raise AssertionError(f"13c: {kde_fits} fits under a KDE prior (~66 expected)")
    shutil.rmtree(outdir, ignore_errors=True)
    return launches


def sed_acceptance_epochs(groups):
    """13d's epochs with their priors and starting centers, as
    tests/test_torch_sed.py::sed_acceptance_epochs builds them: the 9-filter
    epoch under the default priors from its least-squares solution, and the
    single-filter epoch of MJD 57487.1 (U) under a KDE temperature prior of
    default_rng(4).normal(10.7, 0.12, 2000), from (10.7, 3.6)."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.bolometric import blackbody_lstsq
    from lightcurve_fitting_tpu_torch.models import KDEPrior, LogUniformPrior, UniformPrior
    nine = next(g for g in groups if n_detected(g) == 9)
    single = next(g for g in groups
                  if abs(float(np.median(np.asarray(g["MJD"], float))) - 57487.1) < 0.5)
    with contextlib.redirect_stdout(io.StringIO()):
        center = np.array(blackbody_lstsq(nine, META["redshift"], [10.0, 10.0], (1.0, 100.0),
                                          (0.01, 1000.0))[:2])
    kde = KDEPrior(np.random.default_rng(4).normal(10.7, 0.12, size=2000))
    return {"nine": (nine, [UniformPrior(1.0, 100.0), LogUniformPrior(0.01, 1000.0)], center),
            "single": (single, [kde, LogUniformPrior(0.01, 1000.0)], np.array([10.7, 3.6]))}


def phase_sed_acceptance(groups, smi):
    """13d: spectrum_mcmc's mean acceptance at seeds 1-8 against the JAX
    package's float64 CPU seeds."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import bolometric as tbol, kernels
    from lightcurve_fitting_tpu_torch.models.blackbody import planck_fast

    ref = sed_reference()["acceptance"]
    outdir = tempfile.mkdtemp(prefix="chip_smoke_")   # spectrum_mcmc's outpath; it saves nothing
    kernels.reset_launch_counts()
    res, walls = {}, {}
    for name, (ep, pri, center) in sed_acceptance_epochs(groups).items():
        accs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in SED_SEEDS:
            guesses = np.random.default_rng(seed).normal(size=(SED_WALKERS, 2)) + center
            guesses[guesses <= 0.0] = 1.0
            s = tbol.spectrum_mcmc(planck_fast, ep, pri, guesses, z=META["redshift"],
                                   nwalkers=SED_WALKERS, burnin_steps=SED_BURNIN,
                                   steps=SED_STEPS, seed=seed, make_corner=False,
                                   outpath=outdir)
            accs.append(float(np.mean(s.acceptance_fraction)))
        walls[name] = (time.perf_counter() - t0) / len(SED_SEEDS)
        a, b = np.array(accs), np.array(ref[name])
        m_p, se_p = a.mean(), a.std(ddof=1) / np.sqrt(len(a))
        m_j, se_j = b.mean(), b.std(ddof=1) / np.sqrt(len(b))
        zz = abs(m_p - m_j) / np.hypot(se_p, se_j)
        if zz > 4:
            raise AssertionError(f"13d {name}: mean acceptance {m_p:.5f} +- {se_p:.5f}, {zz:.2f} "
                                 f"combined standard errors from the JAX package's {m_j:.5f} +- "
                                 f"{se_j:.5f}")
        res[name] = (accs, m_p, se_p, m_j, se_j, zz)
    launches = dict(kernels.LAUNCHES)
    n = 2 * len(SED_SEEDS)
    if launches["sed_logpost"] != n or launches["sed_run"] != 2 * n \
            or launches["sed_half_step"]:
        raise AssertionError(f"13d: launches {launches} (1 K10 and 2 K10 runs a fit expected)")
    # past the run form's block (64 walkers) spectrum_mcmc launches K10's
    # half-step twice a step: the 9-filter epoch at 128 walkers, seed 1
    ep, pri, center = sed_acceptance_epochs(groups)["nine"]
    guesses = np.random.default_rng(1).normal(size=(SED_WIDE_WALKERS, 2)) + center
    guesses[guesses <= 0.0] = 1.0
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = tbol.spectrum_mcmc(planck_fast, ep, pri, guesses, z=META["redshift"],
                           nwalkers=SED_WIDE_WALKERS, burnin_steps=SED_BURNIN, steps=SED_STEPS,
                           seed=1, make_corner=False, outpath=outdir)
    wide_wall = time.perf_counter() - t0
    shutil.rmtree(outdir, ignore_errors=True)
    wide = dict(kernels.LAUNCHES)
    wide_acc = float(np.mean(s.acceptance_fraction))
    if wide["sed_logpost"] != 1 or wide["sed_run"] or wide["sed_half_step"] != 2 * (
            SED_BURNIN + SED_STEPS):
        raise AssertionError(f"13d at {SED_WIDE_WALKERS} walkers: launches {wide}")
    if not np.isfinite(s.flatchain).all() or abs(wide_acc - res["nine"][1]) > 0.02:
        raise AssertionError(f"13d at {SED_WIDE_WALKERS} walkers: acceptance {wide_acc:.4f}, "
                             f"{res['nine'][1]:.4f} at {SED_WALKERS}")
    phase("bolometric main path 13d", f"in {time.perf_counter() - t_phase:.1f} s: "
          f"spectrum_mcmc(planck_fast) {SED_WALKERS} walkers x "
          f"{SED_BURNIN}+{SED_STEPS} steps at seeds 1-8: "
          + "; ".join(f"{k} epoch: acceptance {', '.join(f'{x:.4f}' for x in r[0])}, mean "
                      f"{r[1]:.5f} +- {r[2]:.5f} against the JAX package's {r[3]:.5f} +- "
                      f"{r[4]:.5f} ({r[5]:.2f} combined standard errors); {walls[k]:.3f} s a fit"
                      for k, r in res.items())
          + f"; launches {launches['sed_logpost']} K10, {launches['sed_run']} K10 runs; at "
          f"{SED_WIDE_WALKERS} walkers (past the run form's block; seed 1, the 9-filter epoch) "
          f"{wide['sed_logpost']} K10 and {wide['sed_half_step']} K10 half-steps, acceptance "
          f"{wide_acc:.4f} (within 0.02 of the {SED_WALKERS} walkers' mean), {wide_wall:.3f} s; "
          f"on {smi}")
    return wide


# the evidence bench shape (bench.py:189-232) and what its log Z is held to:
# the JAX package's bench record (BENCH_r05.json "evidence_ladder"; a
# statistical result, not a speed) and the JAX package's float64 CPU runs of
# the same configuration (tests/test_torch_evidence.py::jax_bench_evidence)
EV_WALKERS, EV_RUNGS, EV_STEPS, EV_BURNIN = 4096, 16, 150, 150
EV_LOGZ_BENCH = (-12961.48, 0.35)
EV_LOGZ_JAX = {1: (-12961.726035036969, 0.35948034181695665),
               2: (-12961.6943474302, 0.36863427679266486)}
LADDER_KERNELS = ("tempered_half_step", "ladder_init", "replica_swap", "rung_block_terms")
# ShockCooling3's evidence (16d): SC3's priors and window (phase 9), 512
# walkers x 16 rungs + beta = 1 x 150 + 150 steps, held to the JAX package's
# float64 CPU log Z at the same seeds and shape, made by
# `PYTHONPATH=. python tests/test_torch_evidence.py sc3`
# (tests/test_torch_evidence.py::jax_sc3_evidence)
SC3_EV_WALKERS = 512
SC3_EV_LOGZ_JAX = {1: (2472.1758707502495, 77.54078680865939),
                   2: (2478.443727283485, 91.37822305342651)}
# and its per-rung stretch acceptance (beta = 0 first) at seeds 1-8, the
# same command: each card run's mean over the rungs is held to these seeds'
# (sc3_acceptance_gate)
SC3_EV_ACC_JAX = {
    1: [0.21678385416666668, 0.15157552083333334, 0.13830729166666667, 0.145234375,
        0.15473958333333335, 0.17028645833333333, 0.18126302083333334, 0.19019531250000002,
        0.20888020833333334, 0.21748697916666668, 0.23089843750000003, 0.24481770833333336,
        0.2646875, 0.30641927083333337, 0.3261979166666667, 0.3472526041666667,
        0.37214843750000004],
    2: [0.21639322916666667, 0.15276041666666668, 0.14039062500000002, 0.14579427083333335,
        0.16466145833333334, 0.1758984375, 0.19131510416666667, 0.20397135416666667,
        0.22153645833333335, 0.2251171875, 0.23843750000000002, 0.25661458333333337,
        0.2777213541666667, 0.301640625, 0.3086197916666667, 0.34523437500000004,
        0.37270833333333336],
    3: [0.21602864583333334, 0.15389322916666667, 0.14134114583333335, 0.14579427083333335,
        0.1584375, 0.17430989583333334, 0.18803385416666668, 0.2037890625, 0.207109375,
        0.2179947916666667, 0.22074218750000002, 0.23625000000000002, 0.2521744791666667,
        0.263359375, 0.29794270833333336, 0.3027473958333334, 0.35638020833333334],
    4: [0.21690104166666668, 0.15709635416666667, 0.14184895833333333, 0.15302083333333336,
        0.16100260416666667, 0.17511718750000002, 0.19516927083333335, 0.2034635416666667,
        0.213671875, 0.23184895833333335, 0.24091145833333336, 0.26394531250000003, 0.285859375,
        0.2999348958333333, 0.30779947916666667, 0.3425651041666667, 0.34856770833333334],
    5: [0.21567708333333335, 0.15899739583333333, 0.1436328125, 0.14986979166666667,
        0.15759114583333333, 0.178984375, 0.19108072916666669, 0.205078125, 0.21927083333333336,
        0.23497395833333334, 0.2523958333333334, 0.2664973958333334, 0.2931119791666667,
        0.3030859375, 0.33319010416666667, 0.36066406250000005, 0.36375],
    6: [0.21071614583333334, 0.1625390625, 0.15027343750000002, 0.15330729166666668,
        0.16404947916666668, 0.17897135416666668, 0.19970052083333334, 0.21071614583333334,
        0.2221744791666667, 0.22759114583333334, 0.23977864583333336, 0.26058593750000003,
        0.2721744791666667, 0.30391927083333337, 0.32438802083333335, 0.34088541666666666,
        0.3639453125],
    7: [0.21997395833333336, 0.15589843750000001, 0.1414453125, 0.15235677083333335,
        0.16432291666666668, 0.18498697916666668, 0.19394531250000002, 0.20765625000000001,
        0.22614583333333335, 0.24223958333333334, 0.24927083333333336, 0.24759114583333336,
        0.2719270833333334, 0.29664062500000005, 0.328671875, 0.34352864583333337, 0.3644921875],
    8: [0.21859375, 0.15610677083333335, 0.14608072916666667, 0.15364583333333334,
        0.17118489583333335, 0.18973958333333335, 0.2076953125, 0.2167057291666667,
        0.23859375000000002, 0.2504296875, 0.2643359375, 0.27665364583333335, 0.2974479166666667,
        0.31972656250000003, 0.32941406250000005, 0.3623307291666667, 0.3654557291666667]}
# the ladders beside 16d's (seed 1, not gated): the log Z error by rungs
SC3_EV_MORE_RUNGS = (32, 64)
# K6c's shapes (rungs, walkers, ndim): the evidence of SC2 (16a) and CS2 (24c),
# compare_models on synthetic photometry (16c), the PT fits of SC2 (16b) and
# CS2 (24c), the evidence of SC3 (16d)
K6C_SHAPES = ((EV_RUNGS + 1, EV_WALKERS, 4), (EV_RUNGS + 1, 32, 4), (7, 32, 4),
              (EV_RUNGS + 1, EV_WALKERS, 7), (7, 64, 7), (EV_RUNGS + 1, SC3_EV_WALKERS, 7))
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
                    name = expect_kernel(step, "tempered_half_step_kernel", "SC2WarpModel")
                    fns = ladder.plain_functions(lp, off, sc)
                    xp, pp, lpl = x0.clone(), pri0.clone(), ll0.clone()
                    plain_ms = cuda_ms(lambda: ladder.tempered_half_step_plain(
                        *fns, xp, pp, lpl, betas, 0, u_z, j, u_acc, 2.0), repeats=5)
        finally:
            config.set_compute_dtype(config.AUTO)
    # K6a over SC3 (a warp per walker), 17 rungs x 512: the ladder of the
    # SC3 evidence (16d), float32 and float64 compute, K6b at the states it
    # left giving its stored values bit for bit; timed in float32
    R = EV_RUNGS + 1
    t3 = {}
    for label in ("f64", "f32"):       # (float32 last: its ladder is timed below)
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            lp3, off3, sc3_, x3 = ladder_setup(ShockCooling3(lcf), lcf, sc3_priors(), SC3_LO,
                                               SC3_UP, R, SC3_EV_WALKERS,
                                               np.random.default_rng(seed), dev)
            t3[label] = check_ladder(f"SC3 ladder {label}", lp3, off3, sc3_, x3, seed,
                                     1e-5 if label == "f32" else 1e-12)
        finally:
            config.set_compute_dtype(config.AUTO)
    pri3, ll3 = ladder.ladder_init(lp3, x3, off3, sc3_)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h3 = SC3_EV_WALKERS // 2
    shape3 = (R, 2, h3)
    uz3 = torch.rand(shape3, generator=g, device=dev)
    j3 = torch.randint(0, h3, shape3, generator=g, device=dev)
    ua3 = torch.rand(shape3, generator=g, device=dev)
    betas3 = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    state3 = (x3.clone(), pri3.clone(), ll3.clone())
    a3 = torch.zeros(shape3, dtype=torch.int32, device=dev)

    def step3():
        ladder.tempered_half_step(lp3, *state3, betas3, 0, uz3, j3, ua3, 2.0, off3, sc3_, a3,
                                  check_partners=False)
    name3 = expect_kernel(step3, "tempered_half_step_kernel", "SC3WarpModel<float, 0>")
    sc3_ms = (cuda_ms(step3), device_ms(step3, "tempered_half_step_kernel", 20, 1)[0])
    plain3 = (x3.clone(), pri3.clone(), ll3.clone())
    sc3_plain_ms = cuda_ms(lambda: ladder.tempered_half_step_plain(
        *ladder.plain_functions(lp3, off3, sc3_), *plain3, betas3, 0, uz3, j3, ua3, 2.0),
        repeats=2)
    n3 = R * h3
    sc3_bound = bound_fields(n3 * (sc3_eval_ops(lp3.log_likelihood) + PROPOSAL),
                             n3 * (2 * 7 * 4 + 2 * 8 + 4 + 8 + 4) + R * 8 + n3 * (7 * 4 + 2 * 8 + 4))
    top = K6A_LADDERS[0][0]
    phase("K6a", f"{name}: tempered half-steps h=0,1 (f32 rescaled state, f64 log pi and log "
          "L, beta_0 = 0; log L within 1e-5 / 1e-10 of the term scale): SC2 "
          + "; ".join(f"{r} x {2 * hh} {lab}: {v[1]} accepts, flags agree except {v[0]} "
                      f"near-ties, log L max |d| {v[2]:.3e} (K6b {v[3]:.3e})"
                      for (lab, r, hh), v in lads.items())
          + "; SC3 " + "; ".join(
              f"{R} x {SC3_EV_WALKERS} {lab}: {v[1]} accepts, {v[0]} near-ties, log L max |d| "
              f"{v[2]:.3e} (K6b {v[3]:.3e})" for lab, v in t3.items())
          + "; states and log pi bit-equal where the flags agree, and K6b at the states K6a "
          "left (SC2, SC3) its stored log pi and log L bit for bit; "
          f"{kernels.LAUNCHES['tempered_half_step'] - n0} comparison launches; K6a over SC2 "
          "(events; the profiler's device time) " + ", ".join(
              f"{a_ms[r][0]:.4f}; {a_ms[r][1]:.4f} ms per {r} x half {hh} (bound "
              f"{a_bounds[r]['bound_ms']:.5f})" for r, hh in K6A_LADDERS)
          + f", plain {plain_ms:.4f} ms per {top} x half {EV_WALKERS // 2} (f32); K6a over SC3 "
          f"({name3}) {sc3_ms[0]:.4f}; {sc3_ms[1]:.4f} ms per {R} x half {h3} (bound "
          f"{sc3_bound['bound_ms']:.5f}), plain {sc3_plain_ms:.4f} ms; "
          "proposals' log pi + log L (u_acc = 0) that differ from K7's value: "
          + ", ".join(f"{lab} {v[5]} of {v[4]} (max |d| {v[6]:.3e})"
                      for (lab, r, hh), v in lads.items() if len(v) > 4))
    return ({"max_abs_err": max(v[2] for k, v in lads.items() if k[0] == "f32"),
             "ms": a_ms[top][0], "plain_ms": plain_ms, **a_bounds[top]},
            {"max_abs_err": t3["f32"][2], "ms": sc3_ms[1], "plain_ms": sc3_plain_ms,
             **sc3_bound})


# K6b's ladders (rungs, walkers) as the fits call it: the evidence (16a)
# and compare_models (16c) of SC2, its PT fit (16b); over CS2 the evidence
# (24c; compare_models CS2 against CS3 at the same shape) and the PT fit;
# over SC3 the evidence (16d)
K6B_LADDERS = {"sc2": ((EV_RUNGS + 1, EV_WALKERS), (7, 32), (EV_RUNGS + 1, 32)),
               "cs": ((EV_RUNGS + 1, EV_WALKERS), (7, 64)),
               "sc3": ((EV_RUNGS + 1, SC3_EV_WALKERS),)}


def k6b_as_called(name, lp, lo, up, R, W, rng, eval_ops, marks, plain_repeats=0,
                  match="ladder_init_kernel"):
    """K6b as a ladder of R rungs x W walkers calls it (every rung starts
    from one set of W states, 1% outside the priors: the set once, copies =
    R) on the rescaled state of ``ladder_setup``, against its plain version:
    R equal rows, the same -inf sets, log pi within 1e-12 and log L within
    1e-5 (float32) or 1e-10 (float64) of the term scale; in float32 also
    its time (events; the profiler's device time), its bound, the kernel
    the profiler saw (holding ``marks``) and, with ``plain_repeats``, the
    plain version's time. Returns (max |d log L|, events ms, device ms,
    bound fields, kernel name, plain ms); the times None in float64.
    ``match``: what the launched kernel's name holds (over SC and SC4
    "ladder_init", the rule's form of two)."""
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
    kernel = expect_kernel(call, match, *marks)
    plain_ms = cuda_ms(lambda: ladder.ladder_init_plain(*fns, x, copies=R),
                       repeats=plain_repeats) if plain_repeats else None
    return (d, cuda_ms(call), device_ms(call, match, 20, 1)[0],
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
                        3 if (R_b, W_b) in ((R, W), (R, SC3_EV_WALKERS)) and label == "f32"
                        else 0)
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
          f"{timed[('sc3', 'f32', R, SC3_EV_WALKERS)][5]:.4f} ms at SC3 {R} x "
          f"{SC3_EV_WALKERS} (f32)")
    k6b = {}
    for which, w_b in (("sc2", W), ("cs", W), ("sc3", SC3_EV_WALKERS)):
        v = timed[(which, "f32", R, w_b)]
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
    # the SC3 evidence's production log L (16d: 150 steps x 17 rungs x 512)
    logl3 = torch.as_tensor(2400.0 + 10.0 * np.random.default_rng(seed + 4).normal(
        size=(EV_STEPS, R, SC3_EV_WALKERS)), device=dev)
    got3 = ladder.rung_block_terms(logl3, db, bounds)
    rel3 = float(((got3 - ladder.rung_block_terms_plain(logl3, db, bounds)).abs()
                  / got3.abs()).max())
    if rel3 > 1e-12 or not torch.equal(ladder.rung_block_terms(logl3, db, bounds), got3):
        raise AssertionError(f"K6d at {EV_STEPS} x {R} x {SC3_EV_WALKERS}: max relative "
                             f"difference {rel3:.3e} > 1e-12, or two launches differ")
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
          f"at the SC3 evidence's {EV_STEPS} x {R} x {SC3_EV_WALKERS} {rel3:.2e}, bit-equal; "
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


def sc3_acceptance_gate(acc):
    """A card run's mean stretch acceptance over the rungs (``acc``) against
    the JAX package's seeds (SC3_EV_ACC_JAX): |mean - m| / (4 sigma), m the
    seeds' mean of it, sigma^2 = s^2 (1 + 1/S) the variance of a run's
    difference from m, s the seeds' standard deviation, S the seeds. At most
    1 passes. (Each rung alone spreads too unevenly over the seeds, 0.0004
    at beta = 0 to 0.02 near beta = 1, to gate it from S seeds.)"""
    import numpy as np
    ref = np.array(list(SC3_EV_ACC_JAX.values())).mean(axis=1)
    sigma = ref.std(ddof=1) * np.sqrt(1 + 1 / ref.size)
    return float(abs(np.mean(acc) - ref.mean()) / (4 * sigma)), float(ref.mean()), float(sigma)


def phase_sc3_ladder_main_path(lc, smi):
    """16d: lightcurve_evidence on ShockCooling3 (SC3's priors and window,
    SC3_EV_WALKERS walkers x 16 rungs + beta = 1 x 150 + 150 steps), seeds 1
    and 2, each log Z within 4 hypot(err, err_jax) of the JAX package's
    float64 CPU value and the mean rung acceptance within 4 sigma of the
    JAX package's seeds (sc3_acceptance_gate); seed 1's log Z at
    SC3_EV_MORE_RUNGS rungs, not gated; the counters, reset first, show one
    run's 600 K6a, 300 K6c, 1 K6b and 1 K6d launches and no plain version;
    the profiler
    shows K6a over SC3WarpModel; a profiled run's time split."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.fitting import lightcurve_evidence
    from lightcurve_fitting_tpu_torch.models import ShockCooling3

    priors = sc3_priors()
    kw = dict(p_lo=SC3_LO, p_up=SC3_UP, nwalkers=SC3_EV_WALKERS, n_rungs=EV_RUNGS,
              nsteps=EV_STEPS, nsteps_burnin=EV_BURNIN, quiet=True)
    kernels.reset_launch_counts()
    runs, times = [], []
    with PlainCalls() as plain:
        for seed in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(lightcurve_evidence(lc, ShockCooling3(lc), priors, seed=seed, **kw))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if seed == 1:
                launches = dict(kernels.LAUNCHES)
        wall, prof = profiled(lambda: lightcurve_evidence(lc, ShockCooling3(lc), priors, seed=2,
                                                          **kw))
    if plain.count:
        raise AssertionError(f"{plain.count} plain versions ran on the SC3 ladder path")
    want = {"tempered_half_step": 2 * (EV_STEPS + EV_BURNIN), "replica_swap": EV_STEPS + EV_BURNIN,
            "ladder_init": 1, "rung_block_terms": 1}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"16d: one run launches {want}, not {launches}")
    k6a_names = sorted({e.key.split("(")[0] for e in prof.key_averages()
                        if e.device_type.name == "CUDA" and "tempered_half_step" in e.key})
    if len(k6a_names) != 1 or "SC3WarpModel" not in k6a_names[0]:
        raise AssertionError(f"16d: K6a must run over SC3WarpModel, the profiler saw {k6a_names}")
    gates = []
    for (log_z, err, info), seed in zip(runs, (1, 2)):
        z_ref, e_ref = SC3_EV_LOGZ_JAX[seed]
        if not np.isfinite(err) or abs(log_z - z_ref) > 4 * np.hypot(err, e_ref):
            raise AssertionError(f"16d seed {seed}: log Z {log_z:.4f} +- {err:.4f} not within 4 "
                                 f"hypot of the JAX package's {z_ref} +- {e_ref}")
        gate, acc_ref, acc_sigma = sc3_acceptance_gate(info["acceptance"])
        gates.append(gate)
        if gate > 1:
            raise AssertionError(f"16d seed {seed}: mean rung acceptance "
                                 f"{np.mean(info['acceptance']):.5f} not within 4 sigma of the "
                                 f"JAX package's {acc_ref:.5f} +- {acc_sigma:.5f}")
    more = {k: lightcurve_evidence(lc, ShockCooling3(lc), priors, seed=1,
                                   **dict(kw, n_rungs=k))[:2] for k in SC3_EV_MORE_RUNGS}
    parts, busy = time_split(prof, wall, {
        "step loop (K6a)": ("tempered_half_step",), "swaps (K6c)": ("replica_swap",),
        "reduction (K6d)": ("rung_block_terms",), "init (K6b)": ("ladder_init_kernel",)})
    info = runs[0][2]
    evals = (EV_RUNGS + 1) * SC3_EV_WALKERS * (EV_STEPS + EV_BURNIN)
    phase("ladder main path 16d", f"lightcurve_evidence ShockCooling3 {SC3_EV_WALKERS} walkers x "
          f"{EV_RUNGS} rungs + beta = 1 x {EV_BURNIN}+{EV_STEPS} steps: log Z seed 1 "
          f"{runs[0][0]:.4f} +- {runs[0][1]:.4f}, seed 2 {runs[1][0]:.4f} +- {runs[1][1]:.4f} "
          f"(JAX float64 CPU seed 1 {SC3_EV_LOGZ_JAX[1][0]:.4f} +- {SC3_EV_LOGZ_JAX[1][1]:.4f}, "
          f"seed 2 {SC3_EV_LOGZ_JAX[2][0]:.4f} +- {SC3_EV_LOGZ_JAX[2][1]:.4f}; within 4 hypot); "
          f"rung acceptance {fmt(info['acceptance'])}, mean seed 1 "
          f"{np.mean(runs[0][2]['acceptance']):.5f}, seed 2 "
          f"{np.mean(runs[1][2]['acceptance']):.5f} (the JAX package's seeds "
          f"{min(SC3_EV_ACC_JAX)}-{max(SC3_EV_ACC_JAX)} {acc_ref:.5f} +- {acc_sigma:.5f}; within "
          f"4 sigma, the farther {4 * max(gates):.2f}); swap rates {fmt(info['swap_rate'])}; "
          f"seed 1 at "
          + ", ".join(f"{k} rungs log Z {z:.4f} +- {e:.4f}" for k, (z, e) in more.items())
          + "; "
          f"{evals / times[0]:.4e} ladder evals/s (runs {', '.join(f'{t:.4f}' for t in times)} s"
          f"; on {smi}); profiled run {wall:.4f} s, device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.3f}): " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
          + f"; K6a {k6a_names[0]}; no plain version ran; launches in one run {launches}")
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
    if which in ("SC", "SC4"):
        return np.append(SC_LO, 0.5), np.append(SC_UP, 3.0)
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
    with 9 on the synthetic Ia curve, SC and SC4 with 6), both sigma_types,
    float32 and float64: K1, the SC3, CS, SC or SC4 log-posterior, K2, the
    SC3, CS, SC or SC4 half-step, K6a and K6b over each; K7 (the sigma
    column of the gradient included), K9 and K7h over SC2."""
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
    for which, sigma_type, label in itertools.product(("SC2", "SC3", "CS1", "SC", "SC4"),
                                                      ("relative", "absolute"), ("f32", "f64")):
        try:
            if label == "f64":
                config.set_compute_dtype(None)
            rel, grel = (1e-5, 1e-4) if label == "f32" else (1e-10, 1e-9)
            pri = ({"SC2": flagship_priors, "SC3": sc3_priors, "CS1": lambda: cs_priors(1),
                    "SC": sc_priors, "SC4": sc_priors}[which]()
                   + [LogUniformPrior(0.01, 10.0)])
            model, data = {"SC2": (ShockCooling2(lc), lc), "SC3": (ShockCooling3(lcf), lcf),
                           "CS1": (cs_model(1, lc0), lc_ia),
                           "SC": (sc_model("ShockCooling", lc), lc),
                           "SC4": (sc_model("ShockCooling4", lc), lc)}[which]
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
CS_KERNELS = ("sifto_direct", "sifto_staged", "cs_logpost", "cs_half_step", "tempered_half_step",
              "ladder_init")
# the posterior draws of the model plot's curves (24e): the default
# num_models_to_plot of the JAX package's lightcurve_model_plot (fitting.py:1809)
POSTERIOR_CURVES = 100


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


def k8_table_entries(t, quad, cols):
    """The SiFTO table's entries that K8's (walker, point) phases inside the
    template touch: the four coefficients of each (band, interval) pair and
    the knots that bound those intervals (the searchsorted interval of each
    phase, in float64). ``cols``: t_peak, stretch, dtU, dti as (W, 1)
    columns, dtU and dti possibly None."""
    import numpy as np
    knots = quad["sifto_knots"].cpu().numpy()
    band = quad["sifto_band"].cpu().numpy()
    is_U, is_i = quad["is_U"].cpu().numpy(), quad["is_i"].cpu().numpy()
    tpk, s, du, di = [np.zeros((1, 1)) if c is None else c.cpu().numpy().reshape(-1, 1)
                      for c in cols]
    x = (t.cpu().numpy() - tpk - np.where(is_i, di, np.where(is_U, du, 0.0))) / s
    inside = (x >= knots[0]) & (x <= knots[-1])
    i = np.clip(np.searchsorted(knots, x[inside], side="right") - 1, 0, len(knots) - 2)
    pairs = np.unique(np.broadcast_to(band, x.shape)[inside] * (len(knots) - 1) + i).size
    return 4 * pairs + np.unique(np.concatenate([i, i + 1])).size


def k8_bound(t, quad, cols):
    """K8's float32 bound at W walkers x N points: its operations (SIFTO_OPS
    an element) against its bytes (the output written once, each walker's
    four parameters and each point's record read once, and the table entries
    these phases touch, k8_table_entries)."""
    W, N = cols[0].shape[0], t.shape[-1]
    return bound_fields(W * N * SIFTO_OPS, W * N * 4 + W * 4 * 8 + N * (4 + 8 + 2)
                        + 4 * k8_table_entries(t, quad, cols))


def phase_k8(lc, lc0, rng_seed=16):
    """22: K8 in each form (the rows staged once a block, or read where they
    lie: kernels/cs.py::k8_form) against sifto_points_plain at 131072
    walkers x the 108 points, and on a grid of 108 whole-day times whose
    phases fall on the knots, at both ends, just and far outside, with NaN
    and infinite phases; the two forms bit-equal there, at one and two
    walkers and about the crossover, where the profiler shows the form the
    wrapper picks; each form timed (the profiler's device time)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import cs, gradient
    from lightcurve_fitting_tpu_torch.models.base import _quad_tensors
    from lightcurve_fitting_tpu_torch.models.companion_shocking import sifto_points_plain
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    N = len(lc)
    cross = -(-cs.K8_STAGED_ELEMENTS_PER_SM * gradient.sm_count(dev) // N)
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
    res, picks, dev_ms = {}, {}, {}
    n0 = kernels.LAUNCHES["sifto_direct"] + kernels.LAUNCHES["sifto_staged"]
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
                want = sifto_points_plain(t, quad, *args)
                got = {form: cs.sifto_launch(form, t, quad, *args)
                       for form in ("staged", "direct")}
                if not torch.equal(got["staged"], got["direct"]) \
                        or not torch.equal(cs.sifto(t, quad, *args), got["staged"]):
                    raise AssertionError(f"K8 {label} {name}: the two forms differ")
                for form, k in got.items():
                    if not torch.equal(k == 0, want == 0) or not torch.isfinite(k).all():
                        raise AssertionError(f"K8 {label} {name} {form}: the zero sets differ, "
                                             "or a value is not finite")
                    d = (k - want).abs() / peak
                    if float(d.max()) > tol:
                        raise AssertionError(f"K8 {label} {name} {form}: max |d|/peak "
                                             f"{float(d.max()):.3e} > {tol:.0e}")
                res[(label, name)] = (float((got["direct"] - want).abs().max()),
                                      float(((got["direct"] - want).abs() / peak).max()),
                                      int((got["direct"] == 0).sum()))
                # the forms at the path's width (one walker), two, and about the crossover
                for w in (1, 2, cross - 1, cross):
                    sub = [a[:w] for a in args]
                    one = {form: cs.sifto_launch(form, t, quad, *sub)
                           for form in ("staged", "direct")}
                    if not torch.equal(one["staged"], one["direct"]) \
                            or not torch.equal(one["direct"], got["direct"][:w]):
                        raise AssertionError(f"K8 {label} {name} at {w} walkers: the forms "
                                             "differ, or differ from the full batch's rows")
                    if label == "f32" and name == "curve":
                        picks[w] = expect_kernel(lambda: cs.sifto(t, quad, *sub), "sifto_kernel",
                                                 "true>" if w >= cross else "false>", calls=3)
                if label == "f32" and name == "curve":
                    one_w = [a[:1] for a in args]
                    for form in ("staged", "direct"):
                        dev_ms[(form, W)] = device_ms(
                            lambda: cs.sifto_launch(form, t, quad, *args), "sifto_kernel", 20,
                            1)[0]
                        dev_ms[(form, 1)] = device_ms(
                            lambda: cs.sifto_launch(form, t, quad, *one_w), "sifto_kernel", 100,
                            1)[0]
                    k_ms = cuda_ms(lambda: cs.sifto(t, quad, *args))
                    plain_ms = cuda_ms(lambda: sifto_points_plain(t, quad, *args), repeats=5)
                    plain1_ms = cuda_ms(lambda: sifto_points_plain(t, quad, *one_w), repeats=20)
                    # the direct form's row at the path's width: the timed input's error
                    err1 = float((cs.sifto_launch("direct", t, quad, *one_w)
                                  - sifto_points_plain(t, quad, *one_w)).abs().max())
                    b_big, b_one = k8_bound(t, quad, args), k8_bound(t, quad, one_w)
        finally:
            config.set_compute_dtype(config.AUTO)
    phase("K8 22", f"{W} walkers x {N} points, the curve's times and a grid of whole days "
          f"(knots, both ends, outside; t_peak NaN, stretch 0 and inf): both forms (staged, "
          f"direct) bit-equal and equal to the wrapper's pick; f32 max |d| "
          f"{res[('f32', 'curve')][0]:.3e} W/Hz, max |d|/peak {max(res[('f32', n)][1] for n in cols):.2e}"
          f" <= 1e-6; f64 max |d|/peak {max(res[('f64', n)][1] for n in cols):.2e} <= 1e-13; zero "
          f"sets equal ({res[('f32', 'grid')][2]} zeros on the grid); at 1, 2, {cross - 1} and "
          f"{cross} walkers (the crossover, {cs.K8_STAGED_ELEMENTS_PER_SM} elements an SM) the "
          f"forms bit-equal, the wrapper running " + ", ".join(
              f"{w}: {k}" for w, k in picks.items())
          + f"; {kernels.LAUNCHES['sifto_direct'] + kernels.LAUNCHES['sifto_staged'] - n0} "
          f"comparison launches; device ms (the profiler's)"
          f" at {W} x {N}: staged {dev_ms[('staged', W)]:.4f}, direct {dev_ms[('direct', W)]:.4f}"
          f" (the wrapper {k_ms:.4f} ms by events, plain {plain_ms:.4f} ms; bound "
          f"{b_big['bound_ms']:.4f} ms, {b_big['bound_by']}); at 1 x {N} (evaluate's width): "
          f"staged "
          f"{dev_ms[('staged', 1)]:.4f}, direct {dev_ms[('direct', 1)]:.4f} (max |d| "
          f"{err1:.3e} W/Hz; plain {plain1_ms:.4f} ms; bound {b_one['bound_ms']:.6f} ms, "
          f"{b_one['bound_by']})")
    return {"max_abs_err": err1, "ms": dev_ms[("direct", 1)], "plain_ms": plain1_ms, **b_one}


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
    """Counts the calls of the plain versions of the CS, SC3, SC and SC4
    paths' kernels while it is entered (each wrapped where the wrappers look
    it up)."""

    NAMES = [("lightcurve_fitting_tpu_torch.kernels", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels", "stretch_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.cs", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.cs", "stretch_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.sc3", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.sc3", "stretch_half_step_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.sc", "log_posterior_plain"),
             ("lightcurve_fitting_tpu_torch.kernels.sc", "stretch_half_step_plain"),
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
    (d) CompanionShocking{,2,3}.evaluate on the card at the medians (K8's
    direct form); (e) the model plot's posterior curves, POSTERIOR_CURVES
    draws of the 24b chain over 1000 times in each band (K8's staged form),
    checked and measured by phase_posterior_curves. Returns the launches and
    the staged form's row."""
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

        # (e) the model plot's posterior curves (the JAX package's
        # lightcurve_model_plot, fitting.py:1808, through _model_plot_grid and
        # _posterior_curves): POSTERIOR_CURVES draws of the 24b chain over
        # 1000 times in each of the curve's bands, one evaluate in outer mode
        t_fit = np.linspace(t.min(), t.max(), 1000)
        ufilts = np.array(sorted(set(f)), dtype=object)
        draws = flat[np.random.default_rng(0).choice(flat.shape[0], POSTERIOR_CURVES)].T
        staged0 = kernels.LAUNCHES["sifto_staged"]
        curves = cs_model(2, lc0, device="cuda")(t_fit, ufilts, *draws)
        if kernels.LAUNCHES["sifto_staged"] != staged0 + 1:
            raise AssertionError("24e: the posterior curves must run K8's staged form once")
    launches = dict(kernels.LAUNCHES)
    for k in CS_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the CS path: {launches}")
    if plain.count:
        raise AssertionError(f"{plain.count} plain versions ran on the CS path")
    phase("CS main path 24d", f"CompanionShocking2, CompanionShocking (factors 1) and "
          f"CompanionShocking3 (theta 0) evaluate on the card at the 24b medians: chi2/dof "
          f"{fmt(chi)}; no plain version ran on 24a-e; launches {launches}")
    return launches, phase_posterior_curves(lc0, t_fit, ufilts, draws, curves)


def phase_posterior_curves(lc0, t_fit, ufilts, draws, curves):
    """24e: the card's posterior curves (B, 1000, POSTERIOR_CURVES) against
    the same evaluate on the CPU in float64 (rtol 1e-5, atol 1e-6 of the
    peak, as test_k8_matches_plain_on_card), finite, the same zero set; K8's
    staged form on the curves' input (the evaluate's outer-mode tiling)
    timed against sifto_points_plain, its error and bound: the kernels
    line's row of the staged form."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.kernels import cs, gradient
    from lightcurve_fitting_tpu_torch.models.base import _quad_tensors
    from lightcurve_fitting_tpu_torch.models.companion_shocking import sifto_points_plain
    from time_port_kernels import device_ms

    B, N, W = len(ufilts), len(t_fit), draws.shape[1]
    want = cs_model(2, lc0, device="cpu")(t_fit, ufilts, *draws)
    if curves.shape != (B, N, W) or not np.isfinite(curves).all() \
            or not np.array_equal(curves == 0, want == 0):
        raise AssertionError(f"24e: curves {curves.shape}, not finite or other zeros than the "
                             "CPU's")
    np.testing.assert_allclose(curves, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    rel = float((np.abs(curves - want) / np.abs(want).max()).max())

    dev = torch.device("cuda")
    t = torch.as_tensor(np.tile(t_fit, B), device=dev)
    quad = _quad_tensors(cs_model(2, lc0).prepare_quad(np.repeat(ufilts, N)), dev)
    args = [torch.as_tensor(draws[k][:, None], device=dev) for k in (3, 4, 5, 6)]
    if cs.k8_form(W * B * N, gradient.sm_count(dev)) != "staged":
        raise AssertionError("24e: the curves' width must take K8's staged form")
    ms = device_ms(lambda: cs.sifto(t, quad, *args), "sifto_kernel", 20, 1)[0]
    direct_ms = device_ms(lambda: cs.sifto_launch("direct", t, quad, *args), "sifto_kernel", 20,
                          1)[0]
    plain_ms = cuda_ms(lambda: sifto_points_plain(t, quad, *args), repeats=20)
    got = cs.sifto(t, quad, *args)
    if not torch.equal(got, cs.sifto_launch("direct", t, quad, *args)):
        raise AssertionError("24e: K8's two forms differ on the curves' input")
    err = float((got - sifto_points_plain(t, quad, *args)).abs().max())
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **k8_bound(t, quad, args)}
    phase("CS main path 24e", f"the model plot's posterior curves: CompanionShocking2 evaluate "
          f"on the card over {W} draws of the 24b chain x {N} times x {B} bands (K8's staged "
          f"form, {W} x {B * N}): max |d| {rel:.2e} of the peak against the CPU's float64 "
          f"evaluate (rtol 1e-5, atol 1e-6 of the peak), the same {int((want == 0).sum())} "
          f"zeros; K8 staged on that input {ms:.4f} ms (the profiler's; the direct form "
          f"{direct_ms:.4f}, the same bits), max |d| {err:.3e} W/Hz "
          f"against sifto_points_plain ({plain_ms:.4f} ms; bound {row['bound_ms']:.6f} ms, "
          f"{row['bound_by']}, {k8_table_entries(t, quad, args)} table entries touched)")
    return row


# ------------------------------------------- SW17 against MSW23: SC and SC4

# examples/compare_models.py:55-60: the priors and window SW17 (ShockCooling)
# and MSW23 (ShockCooling4) share, f_rho M log-uniform (prior kind 1)
SC_LO = [0.5, 0.5, 0.1, 0.1, 57468.3]
SC_UP = [10.0, 20.0, 10.0, 20.0, 57468.7]
SC_NAMES = ("ShockCooling", "ShockCooling4")
SC_PREFIX = {"ShockCooling": "sc", "ShockCooling4": "sc4"}
SC_MARK = {"ShockCooling": "SCWarpModel<", "ShockCooling4": "SC4WarpModel<"}
# the widths whose initial state the phase-26 fits compute with the batch
# log-posterior: 26b's and 26c's 64 walkers, 26a's 4096
SC_LP_WIDTHS = (64, 4096)
SC_FIT_WALKERS = 4096
SC_LADDER = (25, 64)      # 26b: 24 rungs + beta = 1 of 64 walkers
SC_SEEDS = tuple(range(1, 9))
# the JAX package, float64 on the CPU, on SN 2016bkv's early curve at the
# priors and window above (tests/test_torch_shock_cooling.py): the mean
# acceptance of lightcurve_mcmc at 4096 walkers x 300 steps from the window,
# no burn-in, seeds 1-8, and its standard error over the seeds
# (jax_sc_acceptance); the stepping-stone log Z and its error at
# tests/test_evidence.py:124-131's settings, seed 7 (jax_sc_evidence); the
# compare_models_loo elpd_loo at examples/compare_models.py's settings, seeds
# 7-16 (jax_sc_loo). At those settings the chains have not converged (up to
# 145 of 149 points with pareto_k > 0.7) and the elpd is heavy-tailed: SW17
# ranks first at seeds 7 and 8, MSW23 at 9-16, and a seed's elpd ranges over
# two decades. So 26c holds the port's elpd to the JAX seeds' spread of
# log10(-elpd), and its ranking to the JAX seeds' where it is decisive.
SC_ACCEPTANCE_REF = {"ShockCooling": (0.12312754313151042, 0.0007730547269497997),
                     "ShockCooling4": (0.1918968709309896, 0.0005269842573617547)}
SC_LOGZ_REF = {"ShockCooling": (-12994.828263087811, 5.5020102002564),
               "ShockCooling4": (-18737.90283685428, 12.443939308308114)}
SC_LOGZ_BANDS = {"ShockCooling": (-13100.0, -12900.0),    # tests/test_evidence.py:138-139
                 "ShockCooling4": (-19000.0, -18400.0)}
SC_LOO_REF = {"ShockCooling": (-226429.0139959561, -208583.70626222115, -523496.98994218983,
                               -1919137.8892653217, -410482.36831153545, -4139313.5629127636,
                               -577189.9587275713, -452919.1311785844, -13626482.328044344,
                               -666385.3214617084),
              "ShockCooling4": (-309499.3360946681, -239697.14123929793, -250053.76092233552,
                                -510397.4552649079, -311957.0218055521, -459922.2474004346,
                                -271314.8269287782, -239318.95408847494, -2653245.444642906,
                                -196189.85060277674)}
SC_KERNELS = ("sc_logpost", "sc_half_step", "sc_tempered_half_step", "sc_ladder_init",
              "sc4_logpost", "sc4_half_step", "sc4_tempered_half_step", "sc4_ladder_init")
# the half-steps' widths in phase 25: 65536 (past SC4's crossover in
# kernels/sc.py::sc_half_form, before SC's), 26a's 2048 and 26c's 32
SC_HALVES = (HEADLINE_WALKERS // 2, SC_FIT_WALKERS // 2, SC_LP_WIDTHS[0] // 2)
# K6a's ladders in phase 25, rungs x walkers a rung: 26b's, lightcurve_evidence's
# default (32 rungs + beta = 1 of 64 walkers), the evidence bench shape (17 x half
# 2048 = 34816 walkers a launch: past SC4's crossover in kernels/sc.py::tempered_form,
# before SC's) and 40 x 4096 (81920 walkers, past both)
SC_K6A_LADDERS = (SC_LADDER, (33, 64), (17, 4096), (40, 4096))
# the batch log-posterior's two forms in phase 25: 26c's and 26a's widths,
# 16384 (past both models' crossovers in kernels/sc.py::logpost_form) and
# 131072 (the warp form's width, the latency form forced); K6b's: 26b's
# ladder and the evidence bench shape's 17 x 4096
SC_LP_FORM_WIDTHS = SC_LP_WIDTHS + (16384, HEADLINE_WALKERS)
SC_K6B_LADDERS = (SC_LADDER, (17, 4096))


def sc_priors(t0_hi=57468.7):
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior, UniformPrior
    return [UniformPrior(0.1, 20.0), UniformPrior(0.1, 30.0), LogUniformPrior(0.01, 100.0),
            UniformPrior(0.01, 50.0), UniformPrior(57468.0, t0_hi)]


def sc_model(name, lc, **kw):
    from lightcurve_fitting_tpu_torch import models
    return getattr(models, name)(lc, **kw)


SC_EVAL_OPS = {"ShockCooling": sc_eval_ops, "ShockCooling4": sc4_eval_ops}


def sc_walkers(rng, W):
    """W states: W - W/8 from the window with 1% outside the priors, and W/8
    from the window with t_0 in (57468.8, 57472) (t < t_0 at the first
    points; inside the t_0 prior widened to 57472)."""
    import numpy as np
    late = rng.uniform(SC_LO, SC_UP, size=(W // 8, 5))
    late[:, 4] = rng.uniform(57468.8, 57472.0, W // 8)
    return np.concatenate([window_states(rng, SC_LO, SC_UP, W - W // 8, 0.01), late])


def sc_sigma_prior():
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior
    return [LogUniformPrior(0.01, 10.0)]


def sc_logpost_forms_equal(what, prefix, lp, q, off, scale):
    """The SC or SC4 batch log-posterior in its warp and latency forms at the
    walker states q (W, ndim), rescaled by (off, scale) or absolute where
    they are None: the same bits, each form's launch under its own count.
    Returns the values."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sc
    got = {}
    for form in ("warp", "latency"):
        n0 = {f: sc.LAUNCHES[f"{prefix}_logpost_{f}"] for f in ("warp", "latency")}
        got[form] = sc.logpost_launch(prefix, lp, q, off, scale, form=form)
        moved = {f: sc.LAUNCHES[f"{prefix}_logpost_{f}"] - n for f, n in n0.items()}
        if moved != {f: int(f == form) for f in n0}:
            raise AssertionError(f"{what}: one batch log-posterior in the {form} form counted "
                                 f"{moved}")
    if not torch.equal(got["warp"], got["latency"]):
        raise AssertionError(f"{what}: the batch log-posterior's latency form differs from its "
                             "warp form")
    return got["warp"]


def sc_k6b_forms_equal(what, prefix, lp, x, off, scale, copies=1):
    """K6b over SC or SC4 in its warp and latency forms on the ladder state x
    (S, 2, half, ndim), each set written to ``copies`` rows: log pi and log
    L bit-equal (log L evaluated whatever the prior), each form's launch
    under its own count. Returns (logpri, logl)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import ladder, sc
    name = f"{prefix}_ladder_init"
    got = {}
    for form in ("warp", "latency"):
        n0 = {f: sc.LAUNCHES[f"{name}_{f}"] for f in ("warp", "latency")}
        got[form] = ladder.ladder_init(lp, x, off, scale, copies=copies, form=form)
        moved = {f: sc.LAUNCHES[f"{name}_{f}"] - n for f, n in n0.items()}
        if moved != {f: int(f == form) for f in n0}:
            raise AssertionError(f"{what}: one K6b launch in the {form} form counted {moved}")
    if not all(torch.equal(a, b) for a, b in zip(got["warp"], got["latency"])):
        raise AssertionError(f"{what}: K6b's latency form's log pi or log L differ from its "
                             "warp form's")
    return got["warp"]


def sc_forms_equal(what, prefix, lp, off, scale, x0, seed):
    """The SC or SC4 half-step (h = 0, then 1) in its warp and latency forms
    from the rescaled state x0 (2, half, ndim) under shared draws, the chain
    slot in float64: new states, log-posteriors, accept counts and chain
    bit-equal, and the batch log-posterior (both forms) at the new states
    the stored values' bits. Returns the accepts."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import sc
    dev = x0.device
    half, ndim = x0.shape[1], x0.shape[2]
    l0 = sc.logpost_launch(prefix, lp, x0.reshape(-1, ndim), off, scale).reshape(2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    draws = [(torch.rand(half, generator=g, device=dev, dtype=x0.dtype),
              torch.randint(0, half, (half,), generator=g, device=dev),
              torch.rand(half, generator=g, device=dev, dtype=x0.dtype)) for _ in (0, 1)]
    out = []
    for form in ("warp", "latency"):
        st = (x0.clone(), l0.clone(), torch.zeros((2, half), dtype=torch.int32, device=dev),
              torch.empty((2, half, ndim), dtype=torch.float64, device=dev),
              torch.empty((2, half), dtype=torch.float64, device=dev))
        n0 = {f: sc.LAUNCHES[f"{prefix}_half_step_{f}"] for f in ("warp", "latency")}
        for h in (0, 1):
            sc.half_step_launch(prefix, lp, st[0], st[1], h, *draws[h], 2.0, off, scale, st[3],
                                st[4], st[2], form=form)
        moved = {f: sc.LAUNCHES[f"{prefix}_half_step_{f}"] - n for f, n in n0.items()}
        if moved != {f: 2 * (f == form) for f in n0}:
            raise AssertionError(f"{what}: two half-steps in the {form} form counted {moved}")
        out.append(st)
    if not all(torch.equal(a, b) for a, b in zip(*out)):
        raise AssertionError(f"{what}: the latency form's states, log-posteriors, accepts or "
                             "chain differ from the warp form's")
    again = sc_logpost_forms_equal(what, prefix, lp, out[1][0].reshape(-1, ndim), off, scale)
    if not torch.equal(again.reshape(2, half), out[1][1]):
        raise AssertionError(f"{what}: the batch log-posterior at the new states is not the "
                             "stored values' bits")
    return int(out[1][2].sum())


def sc_tempered_forms_equal(what, prefix, lp, off, scale, x0, seed):
    """K6a over SC or SC4 (h = 0, then 1) in its warp and latency forms from
    the rescaled ladder state x0 (R, 2, half, ndim), beta_0 = 0, under shared
    draws: new states, log pi, log L and accept counts bit-equal, each
    form's launches under its own count, and K6b and the batch log-posterior
    (both forms of each) at the new states the stored values' bits. Returns
    the accepts."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import ladder, sc
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    dev = x0.device
    R, _, half, ndim = x0.shape
    pri0, ll0 = ladder.ladder_init(lp, x0, off, scale)
    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (R, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)
    name = f"{prefix}_tempered_half_step"
    out = []
    for form in ("warp", "latency"):
        st = (x0.clone(), pri0.clone(), ll0.clone(),
              torch.zeros(shape, dtype=torch.int32, device=dev))
        n0 = {f: sc.LAUNCHES[f"{name}_{f}"] for f in ("warp", "latency")}
        for h in (0, 1):
            ladder.tempered_half_step(lp, st[0], st[1], st[2], betas, h, u_z, j, u_acc, 2.0, off,
                                      scale, st[3], form=form)
        moved = {f: sc.LAUNCHES[f"{name}_{f}"] - n for f, n in n0.items()}
        if moved != {f: 2 * (f == form) for f in n0}:
            raise AssertionError(f"{what}: two K6a launches in the {form} form counted {moved}")
        out.append(st)
    if not all(torch.equal(a, b) for a, b in zip(*out)):
        raise AssertionError(f"{what}: K6a's latency form's states, log pi, log L or accepts "
                             "differ from the warp form's")
    x, pri, ll, acc = out[1]
    pri_k, ll_k = sc_k6b_forms_equal(what, prefix, lp, x, off, scale)
    if not torch.equal(pri_k, pri) or not torch.equal(ll_k, ll):
        raise AssertionError(f"{what}: K6b at the new states differs from the values K6a stored")
    val = sc_logpost_forms_equal(what, prefix, lp, x.reshape(-1, ndim), off,
                                 scale).reshape(shape)
    fin = torch.isfinite(pri)
    if not torch.equal((pri + ll)[fin], val[fin]) or not bool(torch.isneginf(val[~fin]).all()):
        raise AssertionError(f"{what}: the batch log-posterior at the new states is not the "
                             "stored values' bits")
    n_acc = int(acc.sum())
    if not 0 < n_acc < acc.numel():
        raise AssertionError(f"{what}: {n_acc} accepts of {acc.numel()}")
    return n_acc


def phase_sc_kernels(lc, rng_seed=21):
    """25: the SC and SC4 kernels (SCWarpModel, SC4WarpModel: a warp per
    walker) against their plain versions on SN 2016bkv's early curve. The
    batch log-posterior at 131072 walkers (1% outside the priors, an eighth
    with t < t_0) in float32 (<= 1e-5) and float64 (<= 1e-10 of the term
    scale), identical -inf sets; at the fits' widths (64, 4096) the same
    values bit for bit, each timed; n = 3, RW and kappa = 0.7 (SC) and
    kappa = 0.7 (SC4) at 4096 walkers. The half-step at half 65536, 2048
    and 32, K6a (each rung its own states) at 26b's ladder, 25 rungs x 64
    walkers, and K6b as that ladder calls it, as phases 4, 14 and 15,
    float32 and float64; K6b's values the batch log-posterior's bits; K6a's
    two forms bit for bit at SC_K6A_LADDERS (sc_tempered_forms_equal), each
    form timed there; the batch log-posterior's two forms bit for bit at
    SC_LP_FORM_WIDTHS and K6b's at SC_K6B_LADDERS (f32, f64, with and
    without the scatter), each form timed (f32). Returns each kernel's row
    of the kernels line."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling, make_log_posterior
    from lightcurve_fitting_tpu_torch.kernels import common, ladder
    from lightcurve_fitting_tpu_torch.kernels import sc as ksc
    from lightcurve_fitting_tpu_torch.kernels.gradient import sm_count
    from lightcurve_fitting_tpu_torch.parallel.evidence import make_beta_ladder
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    W = HEADLINE_WALKERS
    R, LW = SC_LADDER
    rng = np.random.default_rng(rng_seed)
    rows, lines = {}, []

    def dev_ms(fn, match="stretch_half_step"):   # a half-step's device ms, the median of
        # 3 profiler windows (one whose records the profiler dropped, PERF.md §7, is NaN and
        # left out)
        got = sorted(v for v in device_ms(fn, match, 20, 3) if v == v)
        return got[len(got) // 2] if got else float("nan")
    for name in SC_NAMES:
        mod = getattr(kernels, SC_PREFIX[name])
        eval_ops, mark = SC_EVAL_OPS[name], SC_MARK[name]
        res, widths, halves, forms, lads, k6b, variants = {}, {}, {}, {}, {}, {}, []
        tforms, ttimes, lpforms, k6bforms = {}, {}, {}, {}
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(None)
                rel = 1e-5 if label == "f32" else 1e-10
                lp = make_log_posterior(sc_model(name, lc), lc, sc_priors(57472.0), device=dev)
                p = torch.as_tensor(sc_walkers(rng, W), device=dev)
                got = lp(p)
                res[label] = compare_ll(f"{name} log-posterior {label}", got,
                                        chunked(lp.forward_plain, p), rel,
                                        scale=lp.log_likelihood.term_scales(p))
                if not torch.isfinite(got[W - W // 8:]).all():
                    raise AssertionError(f"25 {name} {label}: t < t_0 walkers must have finite "
                                         "log-posteriors")
                kw = _state_rescaling(torch.float32, SC_LO, SC_UP, dev)
                widths[label], kname = batch_widths(
                    f"{name} log-posterior {label}", mod.log_posterior, lp, p, kw["param_offset"],
                    kw["param_scale"], SC_LP_WIDTHS + (W,), got, "logpost_", (mark,),
                    eval_ops(lp.log_likelihood))
                if label == "f32":
                    plain_ms = cuda_ms(lambda: chunked(lp.forward_plain, p), repeats=3)
                    lp32, ll32 = lp, lp.log_likelihood
                # the options at one width
                opts = ([{"n": 3.0}, {"RW": True}, {"kappa": 0.7}] if name == "ShockCooling"
                        else [{"kappa": 0.7}])
                for opt in opts:
                    lpo = make_log_posterior(sc_model(name, lc, **opt), lc, sc_priors(57472.0),
                                             device=dev)
                    q = p[W - 4096:]
                    d = compare_ll(f"{name} {opt} {label}", lpo(q), lpo.forward_plain(q), rel,
                                   scale=lpo.log_likelihood.term_scales(q))
                    variants.append(f"{opt} {label} max |d| {d[0]:.3e}")
                # the half-step (h = 0, 1) on the sampler's float32 rescaled state,
                # in the form the rule picks against the plain version, and in
                # both forms bit for bit, with and without the scatter
                off, sc = kw["param_offset"], kw["param_scale"]
                lph = make_log_posterior(sc_model(name, lc), lc, sc_priors(), device=dev)
                lps = make_log_posterior(sc_model(name, lc), lc, sc_priors() + sc_sigma_prior(),
                                         use_sigma=True, device=dev)
                kws = _state_rescaling(torch.float32, SC_LO + [0.5], SC_UP + [3.0], dev)
                # the batch log-posterior's two forms bit for bit at
                # SC_LP_FORM_WIDTHS (1% outside the priors, an eighth with t <
                # t_0), with and without the scatter, on the sampler's float32
                # rescaled state; in float32 each form timed on the window's
                # walkers (a fit's initial state) beside the rule's pick
                lpl = make_log_posterior(sc_model(name, lc), lc, sc_priors(57472.0)
                                         + sc_sigma_prior(), use_sigma=True, device=dev)
                N = ll32.bb_coeffs.shape[0]
                for w in SC_LP_FORM_WIDTHS:
                    pw = torch.cat([p[:w - w // 8], p[W - w // 8:]])
                    sc_logpost_forms_equal(
                        f"25 {name} {label} log-posterior at {w}", SC_PREFIX[name], lp,
                        ((pw - torch.as_tensor(off, device=dev))
                         / torch.as_tensor(sc, device=dev)).float(), off, sc)
                    ps = np.concatenate([sc_walkers(rng, w), rng.uniform(0.5, 3.0, (w, 1))], 1)
                    sc_logpost_forms_equal(
                        f"25 {name} {label} log-posterior at {w} use_sigma", SC_PREFIX[name],
                        lpl, torch.as_tensor((ps - kws["param_offset"]) / kws["param_scale"],
                                             device=dev).float(),
                        kws["param_offset"], kws["param_scale"])
                    if label == "f32":
                        qw = torch.as_tensor((rng.uniform(SC_LO, SC_UP, (w, 5)) - off) / sc,
                                             device=dev).float()
                        lpforms[w] = (
                            {f: dev_ms(lambda f=f, qw=qw: ksc.logpost_launch(
                                SC_PREFIX[name], lph, qw, off, sc, form=f), "logpost_")
                             for f in ("warp", "latency")},
                            mod.logpost_form(w, N, sm_count(dev)),
                            bound_fields(w * eval_ops(ll32), w * (5 * 4 + 8)))
                for half in SC_HALVES:
                    x0 = torch.as_tensor((rng.uniform(SC_LO, SC_UP, size=(2 * half, 5)) - off)
                                         / sc, device=dev).float().reshape(2, half, 5).contiguous()
                    c = check_half_step(f"{name} half-step {label} {half}", lph, off, sc, x0,
                                        rng_seed, rel)
                    xs = torch.as_tensor((rng.uniform(SC_LO + [0.5], SC_UP + [3.0],
                                                      size=(2 * half, 6))
                                          - kws["param_offset"]) / kws["param_scale"],
                                         device=dev).float().reshape(2, half, 6).contiguous()
                    forms[(label, half)] = (
                        sc_forms_equal(f"25 {name} {label} half {half}", SC_PREFIX[name], lph,
                                       off, sc, x0, rng_seed),
                        sc_forms_equal(f"25 {name} {label} half {half} use_sigma",
                                       SC_PREFIX[name], lps, kws["param_offset"],
                                       kws["param_scale"], xs, rng_seed))
                    if label == "f64":
                        halves[(label, half)] = (c, None)
                        continue
                    l0 = mod.log_posterior(lph, x0.reshape(2 * half, 5), off, sc).reshape(2, half)
                    g = torch.Generator(device=dev)
                    g.manual_seed(rng_seed)
                    u_z = torch.rand(half, generator=g, device=dev)
                    j = torch.randint(0, half, (half,), generator=g, device=dev)
                    u_acc = torch.rand(half, generator=g, device=dev)
                    xk, lk = x0.clone(), l0.clone()
                    ak = torch.zeros((2, half), dtype=torch.int32, device=dev)

                    def step(form=None):
                        ksc.half_step_launch(SC_PREFIX[name], lph, xk, lk, 0, u_z, j, u_acc, 2.0,
                                             off, sc, n_accept=ak, check_partners=False,
                                             form=form)
                    t = (cuda_ms(step), dev_ms(step),
                         bound_fields(half * (eval_ops(ll32) + PROPOSAL),
                                      half * (2 * 5 * 4 + 8 + 16 + 4) + half * (5 * 4 + 8 + 4)),
                         {f: dev_ms(lambda: step(f)) for f in ("warp", "latency")},
                         mod.sc_half_form(half, ll32.bb_coeffs.shape[0], sm_count(dev)))
                    if half == SC_FIT_WALKERS // 2:
                        xp, lpp = x0.clone(), l0.clone()
                        t += (cuda_ms(lambda: common.stretch_half_step_plain(
                            lambda q: chunked(lambda cc: common.log_posterior_plain(
                                lph, cc, off, sc), q), xp, lpp, 0, u_z, j, u_acc, 2.0),
                            repeats=3),)
                    halves[(label, half)] = (c, t)
                # K6a and K6b at 26b's ladder on lightcurve_evidence's state
                kwl = _state_rescaling("auto", SC_LO, SC_UP, dev)
                offl, scl = kwl["param_offset"], kwl["param_scale"]
                xl = torch.as_tensor((window_states(rng, SC_LO, SC_UP, R * LW, 0.01) - offl) / scl,
                                     device=dev).to(kwl["dtype"])
                xl = xl.reshape(R, 2, LW // 2, 5).contiguous()
                lads[label] = check_ladder(f"{name} ladder {label} {R} x {LW}", lph, offl, scl,
                                           xl, rng_seed, rel)
                # K6a's two forms bit for bit at 26b's ladder, lightcurve_evidence's
                # default and past the crossovers, with and without the
                # scatter, each form timed (f32)
                kwls = _state_rescaling("auto", SC_LO + [0.5], SC_UP + [3.0], dev)
                # K6b's two forms bit for bit as SC_K6B_LADDERS call it (one
                # set of states, some outside the priors, written to every
                # rung), with and without the scatter; in float32 each form
                # timed beside the rule's pick
                for Rb, Wb in SC_K6B_LADDERS:
                    for sig, lpx, kk in ((False, lph, kwl), (True, lps, kwls)):
                        lo_, up_ = (SC_LO + [0.5], SC_UP + [3.0]) if sig else (SC_LO, SC_UP)
                        xb = torch.as_tensor((window_states(rng, lo_, up_, Wb, max(0.01, 2 / Wb))
                                              - kk["param_offset"]) / kk["param_scale"],
                                             device=dev).to(kk["dtype"])
                        xb = xb.reshape(1, 2, Wb // 2, len(lo_)).contiguous()
                        what = f"25 {name} {label} K6b {Rb} x {Wb}" + (" use_sigma" if sig else "")
                        prib, llb = sc_k6b_forms_equal(what, SC_PREFIX[name], lpx, xb,
                                                       kk["param_offset"], kk["param_scale"], Rb)
                        out_ = ~torch.isfinite(prib[0])
                        if not bool(out_.any()) or (Wb > 64 and not bool(
                                torch.isfinite(llb[0][out_]).any())):
                            raise AssertionError(f"{what}: no state outside the priors, or none "
                                                 "of them with a finite log L")
                        if label == "f64" or sig:
                            continue
                        k6bforms[(Rb, Wb)] = (
                            {f: dev_ms(lambda f=f, xb=xb: ladder.ladder_init(
                                lph, xb, offl, scl, copies=Rb, form=f), "ladder_init")
                             for f in ("warp", "latency")},
                            mod.ladder_init_form(Wb, N, sm_count(dev)))
                for Rl, Wl in SC_K6A_LADDERS:
                    for sig, lpx, kk in ((False, lph, kwl), (True, lps, kwls)):
                        lo_, up_ = (SC_LO + [0.5], SC_UP + [3.0]) if sig else (SC_LO, SC_UP)
                        xs = torch.as_tensor((window_states(rng, lo_, up_, Rl * Wl, 0.01)
                                              - kk["param_offset"]) / kk["param_scale"],
                                             device=dev).to(kk["dtype"])
                        xs = xs.reshape(Rl, 2, Wl // 2, len(lo_)).contiguous()
                        tforms[(label, Rl, Wl, sig)] = sc_tempered_forms_equal(
                            f"25 {name} {label} K6a {Rl} x {Wl}" + (" use_sigma" if sig else ""),
                            SC_PREFIX[name], lpx, kk["param_offset"], kk["param_scale"], xs,
                            rng_seed)
                        if label == "f64" or sig:
                            continue
                        pt, lt = ladder.ladder_init(lpx, xs, offl, scl)
                        bt = torch.as_tensor(make_beta_ladder(Rl - 1), device=dev)
                        gt = torch.Generator(device=dev)
                        gt.manual_seed(rng_seed)
                        sh = (Rl, 2, Wl // 2)
                        uzt = torch.rand(sh, generator=gt, device=dev, dtype=xs.dtype)
                        jt = torch.randint(0, Wl // 2, sh, generator=gt, device=dev)
                        uat = torch.rand(sh, generator=gt, device=dev, dtype=xs.dtype)
                        at = torch.zeros(sh, dtype=torch.int32, device=dev)

                        def tstep(form, st=(xs.clone(), pt, lt), bt=bt, uzt=uzt, jt=jt, uat=uat,
                                  at=at):
                            ladder.tempered_half_step(lpx, *st, bt, 0, uzt, jt, uat, 2.0, offl,
                                                      scl, at, check_partners=False, form=form)
                        ttimes[(Rl, Wl)] = (
                            {f: dev_ms(lambda f=f: tstep(f), "tempered_half_step")
                             for f in ("warp", "latency")},
                            mod.tempered_form(Rl * Wl // 2, lph.log_likelihood.bb_coeffs.shape[0],
                                              sm_count(dev)))
                pri, lll = ladder.ladder_init(lph, xl, offl, scl)
                val = mod.log_posterior(lph, xl.reshape(-1, 5), offl, scl).reshape(pri.shape)
                fin = torch.isfinite(pri)
                if not torch.equal((pri + lll)[fin], val[fin]) \
                        or not bool(torch.isneginf(val[~fin]).all()):
                    raise AssertionError(f"25 {name} {label}: K6b's values are not the batch "
                                         "log-posterior's bits")
                k6b[label] = k6b_as_called(f"25 {name} K6b {label}", lph, SC_LO, SC_UP, R, LW,
                                           rng, eval_ops(ll32), (mark,), plain_repeats=3,
                                           match="ladder_init")
                if label == "f32":
                    betas = torch.as_tensor(make_beta_ladder(R - 1), device=dev)
                    shape = (R, 2, LW // 2)
                    g = torch.Generator(device=dev)
                    g.manual_seed(rng_seed)
                    uz = torch.rand(shape, generator=g, device=dev)
                    jl = torch.randint(0, LW // 2, shape, generator=g, device=dev)
                    ua = torch.rand(shape, generator=g, device=dev)
                    al = torch.zeros(shape, dtype=torch.int32, device=dev)
                    state = (xl.clone(), pri.clone(), lll.clone())

                    def lstep():
                        ladder.tempered_half_step(lph, *state, betas, 0, uz, jl, ua, 2.0, offl,
                                                  scl, al, check_partners=False)
                    n = R * LW // 2
                    a_t = (cuda_ms(lstep), dev_ms(lstep, "tempered_half_step"),
                           bound_fields(n * (eval_ops(ll32) + PROPOSAL),
                                        n * (2 * 5 * 4 + 2 * 8 + 4 + 8 + 4) + R * 8
                                        + n * (5 * 4 + 2 * 8 + 4)))
                    fns = ladder.plain_functions(lph, offl, scl)
                    state = (xl.clone(), pri.clone(), lll.clone())
                    a_plain = cuda_ms(lambda: ladder.tempered_half_step_plain(
                        *fns, *state, betas, 0, uz, jl, ua, 2.0), repeats=3)
            finally:
                config.set_compute_dtype(config.AUTO)
        prefix = SC_PREFIX[name]
        t32 = widths["f32"]
        hW = halves[("f32", SC_FIT_WALKERS // 2)][1]
        rows[prefix] = {
            "logpost": {"max_abs_err": res["f32"][0], "ms": t32[W][0], "plain_ms": plain_ms,
                        **t32[W][2]},
            "half": {"max_abs_err": max(v[0][2] for k, v in halves.items() if k[0] == "f32"),
                     "ms": hW[0], "plain_ms": hW[5], **hW[2]},
            "k6a": {"max_abs_err": lads["f32"][2], "ms": a_t[0], "plain_ms": a_plain, **a_t[2]},
            "k6a_forms": ttimes,
            "logpost_forms": lpforms,
            "k6b_forms": k6bforms,
            "k6b": {"max_abs_err": k6b["f32"][0], "ms": k6b["f32"][1], "plain_ms": k6b["f32"][5],
                    **k6b["f32"][3]}}
        lines.append(
            f"{name} ({kname}): log-posterior at {W} (1% outside the priors, {W // 8} with "
            "t < t_0) " + "; ".join(f"{lab} max |d| {r[0]:.3e} (max |d|/scale {r[1]:.2e})"
                                     for lab, r in res.items())
            + f", the same values bit for bit at widths {', '.join(map(str, SC_LP_WIDTHS))} "
            "(f32, f64), kernel (events; the profiler's device time) " + ", ".join(
                f"{v[0]:.4f}; {v[1]:.4f} ms at {w} (bound {v[2]['bound_ms']:.5f})"
                for w, v in t32.items())
            + f", plain {plain_ms:.4f} ms at {W} (f32); at 4096 " + ", ".join(variants)
            + "; half-step " + "; ".join(
                f"{lab} half {h}: {c[1]} accepts, {c[0]} near-ties, new-logp max |d| {c[2]:.3e}"
                + (f", the {t[4]} form {t[0]:.4f}; {t[1]:.4f} ms (bound "
                   f"{t[2]['bound_ms']:.5f}; device: warp form {t[3]['warp']:.4f}, latency "
                   f"form {t[3]['latency']:.4f})" if t else "")
                + f"; the latency form bit-equal to the warp form ({forms[(lab, h)][0]} "
                f"accepts; with use_sigma {forms[(lab, h)][1]}) and the batch log-posterior "
                "at its new states the stored bits"
                for (lab, h), (c, t) in halves.items())
            + f", plain {hW[5]:.4f} ms at half {SC_FIT_WALKERS // 2}; K6a {R} x {LW} "
            + "; ".join(
                f"{lab}: {v[1]} accepts, {v[0]} near-ties, log L max |d| {v[2]:.3e}, K6b at "
                f"K6a's states its stored bits, K6b log L max |d| {v[3]:.3e}"
                for lab, v in lads.items())
            + f", {a_t[0]:.4f}; {a_t[1]:.4f} ms (bound {a_t[2]['bound_ms']:.5f}), plain "
            f"{a_plain:.4f} ms; K6a's latency form bit-equal to its warp form, K6b and the "
            "batch log-posterior at its new states the stored bits (accepts f32, f64; with "
            "use_sigma), device ms by form: " + "; ".join(
                f"{Rl} x {Wl}: accepts {tforms[('f32', Rl, Wl, False)]}, "
                f"{tforms[('f64', Rl, Wl, False)]}; {tforms[('f32', Rl, Wl, True)]}, "
                f"{tforms[('f64', Rl, Wl, True)]}, warp form {t[0]['warp']:.4f}, latency "
                f"form {t[0]['latency']:.4f}, the rule's {t[1]}"
                for (Rl, Wl), t in ttimes.items())
            + f"; K6b as called ({k6b['f32'][4]}, {R} copies of {LW}): "
            f"{k6b['f32'][1]:.4f}; {k6b['f32'][2]:.4f} ms (bound "
            f"{k6b['f32'][3]['bound_ms']:.5f}), plain {k6b['f32'][5]:.4f} ms, log L max |d| "
            f"f32 {k6b['f32'][0]:.3e}, f64 {k6b['f64'][0]:.3e}; K6b's values the batch "
            "log-posterior's bits; the batch log-posterior's latency form bit-equal to its "
            f"warp form at {', '.join(map(str, SC_LP_FORM_WIDTHS))} (f32, f64; with "
            "use_sigma), device ms by form on the window's walkers: " + "; ".join(
                f"{w}: warp form {t[0]['warp']:.4f}, latency form {t[0]['latency']:.4f}, the "
                f"rule's {t[1]} (bound {t[2]['bound_ms']:.5f})" for w, t in lpforms.items())
            + "; K6b's latency form bit-equal to its warp form (log L outside the priors too) "
            "at " + ", ".join(f"{Rb} x {Wb}" for Rb, Wb in SC_K6B_LADDERS) + " (f32, f64; "
            "with use_sigma), device ms by form: " + "; ".join(
                f"{Rb} x {Wb}: warp form {t[0]['warp']:.4f}, latency form "
                f"{t[0]['latency']:.4f}, the rule's {t[1]}" for (Rb, Wb), t in k6bforms.items()))
    phase("SC and SC4 kernels 25", " | ".join(lines))
    return rows


def hushed(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its standard output dropped (a fit's column
    rebuild prints a note a band, as the reference does)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def phase_sc_main_path(lc, smi):
    """26: SW17 against MSW23, the launch counters reset before (a): (a)
    lightcurve_mcmc of each at 4096 walkers x 300 steps from the window,
    seeds 1-8, the mean acceptance within 4 combined standard errors of the
    JAX package's float64 CPU value at those seeds; (b) compare_models at
    tests/test_evidence.py:124-131's settings (64 walkers, 24 rungs + beta =
    1, 600 + 400 steps, seed 7): each log Z within 4 hypot(err, err_jax) of
    the JAX package's float64 CPU value and inside that test's bands, SW17
    first; (c) compare_models_loo at examples/compare_models.py's settings
    (64 x 500 + 500, seed 7): log10(-elpd_loo) of each within 4x the JAX
    package's seed scatter of its mean (seeds 7-16), and a decisive ranking
    (|d_elpd| > 4 se) the JAX seeds' majority's; then
    information_criteria(group_by="filter") and goodness_of_fit
    on the winner, called directly: a finite chi2 and p in [0, 1]; the
    discrepancy op (1024 draws, torch ops on the card) timed against the
    same call on the host. The counters show every SC and SC4 kernel ran,
    and no plain version did, and each half-step of (a) (half 2048) and of
    (b)-(c) (half 32) ran in the form kernels/sc.py::sc_half_form picks at
    its width, and each of (b)'s 2 x 2000 K6a launches in the form
    kernels/sc.py::tempered_form picks at 25 x 32, each initial state of (a)
    (4096 walkers) and (c) (64) in the form kernels/sc.py::logpost_form
    picks and (b)'s K6b (64 states) in the form
    kernels/sc.py::ladder_init_form picks, by the per-form counts. Returns
    (the launches, the discrepancy's row for PERF.md)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import fitting, kernels
    from lightcurve_fitting_tpu_torch.fitting import (compare_models, compare_models_loo,
                                                      goodness_of_fit, information_criteria,
                                                      lightcurve_mcmc)
    from lightcurve_fitting_tpu_torch.kernels.gradient import sm_count

    kernels.reset_launch_counts()
    calls = {"discrepancy": 0}
    discrepancy = fitting._posterior_discrepancy

    def counted(*a, **k):
        calls["discrepancy"] += 1
        return discrepancy(*a, **k)
    fitting._posterior_discrepancy = counted
    try:
        with PlainCalls() as plain:
            # (a) the acceptance at seeds 1-8
            acc, t_a = {}, time.perf_counter()
            for name in SC_NAMES:
                mean, se, each = seed_acceptance(lambda seed: hushed(
                    lightcurve_mcmc,
                    lc, sc_model(name, lc), sc_priors(), p_lo=SC_LO, p_up=SC_UP,
                    nwalkers=SC_FIT_WALKERS, nsteps=300, nsteps_burnin=0, seed=seed, quiet=True),
                    SC_SEEDS)
                ref, ref_se = SC_ACCEPTANCE_REF[name]
                if abs(mean - ref) > 4 * np.hypot(se, ref_se):
                    raise AssertionError(f"26a {name}: mean acceptance {mean:.5f} +- {se:.5f} not "
                                         f"within 4 combined standard errors of the JAX "
                                         f"package's {ref:.5f} +- {ref_se:.5f}")
                acc[name] = (mean, se, each)
            t_a = time.perf_counter() - t_a
            after_a = dict(kernels.LAUNCHES)
            phase("SW17 vs MSW23 26a", f"lightcurve_mcmc {SC_FIT_WALKERS} walkers x 300 steps "
                  f"from the window, seeds 1-8: " + "; ".join(
                      f"{k} mean acceptance {v[0]:.5f} +- {v[1]:.5f} (JAX float64 CPU "
                      f"{SC_ACCEPTANCE_REF[k][0]:.5f} +- {SC_ACCEPTANCE_REF[k][1]:.5f}, within 4 "
                      f"combined standard errors), each {fmt(v[2])}" for k, v in acc.items())
                  + f"; {t_a:.3f} s for the 16 fits")

            # (b) the evidence comparison
            t0 = time.perf_counter()
            table = hushed(compare_models, lc, [sc_model(n, lc) for n in SC_NAMES], sc_priors(),
                                   p_lo=SC_LO, p_up=SC_UP, labels=list(SC_NAMES), nwalkers=64,
                                   n_rungs=24, nsteps=400, nsteps_burnin=600, seed=7, quiet=True)
            t_b = time.perf_counter() - t0
            rows = {table["model"][i]: (float(table["log_z"][i]), float(table["dlog_z"][i]))
                    for i in range(len(table))}
            for name, (z, err) in rows.items():
                ref, ref_err = SC_LOGZ_REF[name]
                lo, hi = SC_LOGZ_BANDS[name]
                if not (np.isfinite(err) and abs(z - ref) <= 4 * np.hypot(err, ref_err)
                        and lo < z < hi and err < 20):
                    raise AssertionError(f"26b {name}: log Z {z} +- {err} (JAX float64 CPU "
                                         f"{ref} +- {ref_err}, band ({lo}, {hi}))")
            if table["model"][0] != "ShockCooling":
                raise AssertionError(f"26b: SW17 must rank first: {rows}")
            phase("SW17 vs MSW23 26b", "compare_models 64 walkers x 24 rungs + beta = 1 x "
                  "600+400, seed 7: " + "; ".join(
                      f"{k} log Z {v[0]:.4f} +- {v[1]:.4f} (JAX float64 CPU "
                      f"{SC_LOGZ_REF[k][0]:.4f} +- {SC_LOGZ_REF[k][1]:.4f}, within 4 hypot; band "
                      f"{SC_LOGZ_BANDS[k]})" for k, v in rows.items())
                  + f"; SW17 first, delta log Z {float(table['delta_log_z'][1]):.4f}; "
                  f"{t_b:.3f} s")

            # (c) the predictive comparison, then the winner's diagnostics
            t0 = time.perf_counter()
            loo = hushed(compare_models_loo, lc, [sc_model(n, lc) for n in SC_NAMES],
                         sc_priors(), p_lo=SC_LO, p_up=SC_UP, labels=list(SC_NAMES), nwalkers=64,
                         nsteps=500, nsteps_burnin=500, seed=7, quiet=True)
            t_c = time.perf_counter() - t0
            ranking = [str(m) for m in loo["model"]]
            elpd = {str(m): float(e) for m, e in zip(loo["model"], loo["elpd_loo"])}
            for name, e in elpd.items():
                ref = np.log10(-np.asarray(SC_LOO_REF[name]))
                if not (e < 0 and abs(np.log10(-e) - ref.mean()) <= 4 * ref.std(ddof=1)):
                    raise AssertionError(f"26c {name}: elpd_loo {e}: log10(-elpd) not within 4 x "
                                         f"the JAX package's seed scatter {ref.std(ddof=1):.3f} "
                                         f"of its mean {ref.mean():.3f}")
            d_elpd, se_d = float(loo["d_elpd"][1]), float(loo["se_d_elpd"][1])
            majority = max(SC_NAMES, key=lambda n: sum(
                a > b for a, b in zip(SC_LOO_REF[n], SC_LOO_REF[SC_NAMES[SC_NAMES[0] == n]])))
            if abs(d_elpd) > 4 * se_d and ranking[0] != majority:
                raise AssertionError(f"26c: a decisive ranking {ranking} (d_elpd {d_elpd} +- "
                                     f"{se_d}) against the JAX seeds' {majority} first")
            best = ranking[0]
            model = loo.meta["models"][best]
            flat = loo.meta["samplers"][best].flatchain
            ic = hushed(information_criteria, lc, model, flat, group_by="filter", quiet=True)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                gof = goodness_of_fit(lc, model, flat)
            line = out.getvalue().strip().splitlines()[-1]
            if not (np.isfinite(gof["chi2"]) and 0.0 <= gof["p_value"] <= 1.0
                    and line.startswith("goodness of fit: chi^2/dof")):
                raise AssertionError(f"26c: goodness of fit {gof}, printed {line!r}")
            logo = ic["logo"]
            if not np.isfinite(logo["elpd_logo"]) or len(logo["groups"]) < 2:
                raise AssertionError(f"26c: leave-one-band-out {logo['elpd_logo']}")
    finally:
        fitting._posterior_discrepancy = discrepancy
    launches = dict(kernels.LAUNCHES)
    for k in SC_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the SW17-vs-MSW23 path: "
                                 f"{launches}")
    if plain.count:
        raise AssertionError(f"{plain.count} plain versions ran on the SW17-vs-MSW23 path")
    # each half-step in the form the rule picks at its run's width
    ran_forms = {}
    sms = sm_count(torch.device("cuda"))
    for run, (before, after, half) in {
            "26a": ({k: 0 for k in launches}, after_a, SC_FIT_WALKERS // 2),
            "26b-c": (after_a, launches, SC_LP_WIDTHS[0] // 2)}.items():
        for prefix in ("sc", "sc4"):
            want = getattr(kernels, prefix).sc_half_form(half, len(lc), sms)
            got = {f: after[f"{prefix}_half_step_{f}"] - before[f"{prefix}_half_step_{f}"]
                   for f in ("warp", "latency")}
            total = after[f"{prefix}_half_step"] - before[f"{prefix}_half_step"]
            if total == 0 or got[want] != total:
                raise AssertionError(f"{run}: {total} {prefix.upper()} half-steps at half {half}, "
                                     f"by form {got}: not all in the {want} form the rule picks")
            ran_forms[(run, prefix)] = (half, got)
    # each initial state (26a's 8 fits a model at 4096 walkers, 26c's one at
    # 64) and 26b's K6b (one a model, 64 states) in the form its rule picks
    ran_logpost, ran_init = {}, {}
    for run, (before, after, n_walkers, n_launches) in {
            "26a": ({k: 0 for k in launches}, after_a, SC_FIT_WALKERS, len(SC_SEEDS)),
            "26b-c": (after_a, launches, SC_LP_WIDTHS[0], 1)}.items():
        for prefix in ("sc", "sc4"):
            want = getattr(kernels, prefix).logpost_form(n_walkers, len(lc), sms)
            name = f"{prefix}_logpost"
            got = {f: after[f"{name}_{f}"] - before[f"{name}_{f}"] for f in ("warp", "latency")}
            total = after[name] - before[name]
            if total != n_launches or got[want] != total:
                raise AssertionError(f"{run}: {total} {prefix.upper()} batch log-posteriors at "
                                     f"{n_walkers} walkers, by form {got}: not {n_launches}, "
                                     f"all in the {want} form the rule picks")
            ran_logpost[(run, prefix)] = (n_walkers, got)
    for prefix in ("sc", "sc4"):
        want = getattr(kernels, prefix).ladder_init_form(SC_LADDER[1], len(lc), sms)
        name = f"{prefix}_ladder_init"
        got = {f: launches[f"{name}_{f}"] - after_a[f"{name}_{f}"] for f in ("warp", "latency")}
        total = launches[name] - after_a[name]
        if total != 1 or got[want] != total:
            raise AssertionError(f"26b: {total} K6b launches over {prefix.upper()} at "
                                 f"{SC_LADDER[1]} states, by form {got}: not 1 in the {want} "
                                 "form the rule picks")
        ran_init[prefix] = got
    # each K6a launch of 26b (2 x (600 + 400) a model) in the form the rule
    # picks over its launch's 25 x 32 walkers
    R26, W26 = SC_LADDER
    ran_tempered = {}
    for prefix in ("sc", "sc4"):
        want = getattr(kernels, prefix).tempered_form(R26 * W26 // 2, len(lc),
                                                      sm_count(torch.device("cuda")))
        name = f"{prefix}_tempered_half_step"
        got = {f: launches[f"{name}_{f}"] - after_a[f"{name}_{f}"] for f in ("warp", "latency")}
        total = launches[name] - after_a[name]
        if total != 2 * (600 + 400) or got[want] != total:
            raise AssertionError(f"26b: {total} K6a launches over {prefix.upper()} at {R26} x "
                                 f"{W26}, by form {got}: not 2000, all in the {want} form the "
                                 "rule picks")
        ran_tempered[prefix] = got

    # the discrepancy op on the winner's chain: 1024 draws x 149 points, torch
    # ops on the card, against the same call on the host (float64)
    draws = flat[np.random.default_rng(0).choice(len(flat), 1024, replace=False)]
    card, _, _ = hushed(discrepancy, lc, model, draws, False, "relative", "pointwise_ll")
    host, _, _ = hushed(discrepancy, lc, model, draws, False, "relative", "pointwise_ll",
                        device="cpu")
    fin = np.isfinite(host)
    if not np.array_equal(np.isfinite(card), fin):
        raise AssertionError("26c: the card's discrepancy has other non-finite entries")
    err = float(np.max(np.abs(card[fin] - host[fin]) / (np.abs(host[fin]) + 1.0)))
    if err > 1e-4:
        raise AssertionError(f"26c: the card's pointwise log-density differs from the host's "
                             f"float64 by {err:.2e} (relative to |ll| + 1)")
    ms = cuda_ms(lambda: hushed(discrepancy, lc, model, draws, False, "relative", "pointwise_ll"),
                 repeats=5)
    t0 = time.perf_counter()
    for _ in range(3):
        hushed(discrepancy, lc, model, draws, False, "relative", "pointwise_ll", device="cpu")
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    N = len(lc)
    eval_ops = SC_EVAL_OPS[best](fitting.make_log_posterior(
        model, lc, sc_priors(), device="cuda").log_likelihood) + N * (10 + 2 * SFU)
    drow = {"ms": ms, "plain_ms": host_ms, "max_abs_err": err, "calls": calls["discrepancy"],
            **bound_fields(1024 * eval_ops, 1024 * 5 * 8 + 1024 * N * 8)}
    phase("SW17 vs MSW23 26c", f"compare_models_loo 64 walkers x 500+500, seed 7: ranking "
          f"{ranking} (the JAX package's at seeds 7-16: SW17 first at 2, MSW23 at 8; held "
          f"where decisive, |d_elpd| > 4 se), elpd_loo " + ", ".join(
              f"{k} {v:.1f} (JAX seeds 7-16 {fmt(SC_LOO_REF[k])}: log10(-elpd) within 4 x their "
              f"scatter of their mean)" for k, v in elpd.items())
          + f", d_elpd {float(loo['d_elpd'][1]):.1f} +- {float(loo['se_d_elpd'][1]):.1f}, "
          f"{int(np.sum(loo.meta['ics'][best]['pareto_k'] > 0.7))} of {N} points of {best} "
          f"with pareto_k > 0.7; {t_c:.3f} s; {best}: leave-one-band-out elpd "
          f"{logo['elpd_logo']:.1f} +- {logo['se_elpd_logo']:.1f} over {len(logo['groups'])} "
          f"bands; printed {line!r}; the discrepancy op (1024 draws x {N} points, the pointwise "
          f"log-density, torch ops on the card) {ms:.4f} ms (events, host work included; bound "
          f"{drow['bound_ms']:.5f} ms), the same call on the host {host_ms:.2f} ms, max "
          f"|d|/(|ll| + 1) {err:.2e} against it; {calls['discrepancy']} calls on 26a-c; no plain "
          f"version ran; the half-steps by form, each run's all in the rule's form: " + "; ".join(
              f"{run} {p.upper()} (half {h}) warp {got['warp']}, latency {got['latency']}"
              for (run, p), (h, got) in ran_forms.items())
          + "; 26b's K6a by form, all in the rule's form: " + "; ".join(
              f"{p.upper()} ({R26} x {W26}) warp {got['warp']}, latency {got['latency']}"
              for p, got in ran_tempered.items())
          + "; the initial states by form, all in the rule's form: " + "; ".join(
              f"{run} {p.upper()} ({w} walkers) warp {got['warp']}, latency {got['latency']}"
              for (run, p), (w, got) in ran_logpost.items())
          + "; 26b's K6b by form, all in the rule's form: " + "; ".join(
              f"{p.upper()} ({SC_LADDER[1]} states) warp {got['warp']}, latency "
              f"{got['latency']}" for p, got in ran_init.items())
          + f"; launches {launches}")
    return launches, drow

# ------------------------------------------------------- the population path (27-28)

POP_PRIORS = [(1.0, 50.0), (0.1, 20.0), (5.0, 100.0)]   # examples/fit_population.py
POP_LO, POP_UP = [5.0, 0.5, 20.0], [25.0, 5.0, 60.0]
POP_MJD_PRIOR, POP_MJD_LO, POP_MJD_UP = (57999.0, 58000.5), 57999.5, 58000.4   # t_exp
POP_SIGMA_PRIOR, POP_SIGMA_LO, POP_SIGMA_UP = (0.0, 5.0), 0.01, 1.0
POP_SIZES = (64, 512)       # the example's S, and the survey scale (population.py:147, :598)
POP_WALKERS, POP_BURNIN, POP_STEPS = 64, 100, 500
POP_STARTS, POP_ITER = 16, 400
POP_DIAG = 8                # the example's subset refit with chains for the diagnostics
POP_KERNELS = ("pop_logpost", "pop_half_step", "pop_map")
POP_FORMS = {"pop_logpost": ("warp", "latency"), "pop_half_step": ("warp", "latency"),
             "pop_map": ("warp", "pair")}
POP_SPLIT = {"P3 (MAP ascent)": ("pop_map_kernel",),   # time_split's lowercased names
             "P2 (half-steps)": ("stretch_half_step_kernel<popsc2warpmodel",
                                 "stretch_half_step_latency_kernel<popsc2warpmodel"),
             "P1 (initial state)": ("logpost_warp_kernel<popsc2warpmodel",
                                    "logpost_latency_kernel<popsc2warpmodel"),
             "K5 (summaries)": ("percentile",)}
# the exact-refit CV's widths for P1's two forms in 27, (S, padded points),
# 64 walkers: SN 2016bkv's leave-one-band-out refit of VALIDATION.md's five
# flagged bands (5 transients, 121-143 points) and a leave-one-point-out
# refit (148 points), as pop_example's curves of 25-26 epochs cut to so many
# points
POP_REFIT_SHAPES = ((5, 143), (1, 148))
POP_REFIT_EPOCHS = (25, 27)
# the JAX package's fit of the example at its defaults (seed 1), float64 on
# the CPU: (mean acceptance, its standard error over the transients, the
# transients whose T_1 median lies within 20% of the truth and L_1 within
# 30%, the least acceptance); PYTHONPATH=. python tests/test_torch_population.py 64 512
POP_REF = {64: (0.630556640625, 0.0009502654467231553, 64, 0.6149687500000001),
           512: (0.6311514892578125, 0.0003242441348258378, 512, 0.61178125)}
POP_ACC_TOL = 0.01          # the port's mean acceptance against POP_REF's (5b's gate)
POP_MAP_REL = {"f64": 1e-9, "f32": 1e-5}   # P3 against the plain ascent (pop_check_map)
# each float32 ascent's best MAP point against the float64 plain ascent's, in
# float64 -log p over the term scale (pop_map_f64_gaps), without and with the
# intrinsic scatter: ~5x the largest of 27's cases from five sets of starts
# (python3 tools/probe_pop_map.py --f64 27,1,2,3,4 on the H100: P3 at most
# 4.2e-6, the plain ascent 2.8e-6 without the scatter and 9.3e-2 with it)
POP_MAP_F64 = {False: {"kernel": 2e-5, "plain": 2e-5}, True: {"kernel": 2e-5, "plain": 0.5}}


def pop_example(S, dev, mjd=False, epochs=(4, 8), n_points=None):
    """examples/fit_population.py's synthetic population of S transients
    (default_rng(0): 6 filters, 4-7 epochs each, so 24-42 points), through
    the port: (lcs, models, truths). ``mjd``: the times at MJD scale (t_exp
    = 58000, fitted as a fourth parameter, the t_exp prior's window), as
    tests/test_population.py's float32 phase test. ``epochs``: the range of
    a transient's epochs, [lo, hi) (longer curves for the P2 form rule's
    crossover in points). ``n_points``: each curve cut to its first so many
    points (the exact-refit CV's widths, POP_REFIT_SHAPES)."""
    import numpy as np
    from lightcurve_fitting_tpu_torch.filters import filtdict
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    rng = np.random.default_rng(0)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    t0 = 58000.0 if mjd else 0.0
    lcs, models, truths = [], [], []
    for _ in range(S):
        T1, L1, ttr = rng.uniform(8.0, 20.0), rng.uniform(1.0, 4.0), rng.uniform(25.0, 50.0)
        truths.append((T1, L1, ttr))
        n_epochs = rng.integers(*epochs)
        t = t0 + np.repeat(np.linspace(1.0, 8.0, n_epochs), len(filters))
        f = np.array(filters * n_epochs)
        y_true = ShockCooling2()(t, f, T1, L1, ttr, t0)
        dy = 0.05 * y_true
        lc = LC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
        if n_points is not None:
            lc = lc[:n_points]
        lcs.append(lc)
        models.append(ShockCooling2(lc, device=dev))
    return lcs, models, np.array(truths)


def pop_priors(mjd=False, sigma=False):
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    bounds = POP_PRIORS + [POP_MJD_PRIOR] * mjd + [POP_SIGMA_PRIOR] * sigma
    lo = POP_LO + [POP_MJD_LO] * mjd + [POP_SIGMA_LO] * sigma
    up = POP_UP + [POP_MJD_UP] * mjd + [POP_SIGMA_UP] * sigma
    return [UniformPrior(*b) for b in bounds], lo, up


def pop_points(pp):
    """The population's real points: the padded ones copy their transient's
    last real point with weight 0, so the bounds do not count them."""
    return int(pp.mask.sum())


def pop_eval_ops(pp):
    """P1 at one walker and one real point: the point of the class's single
    fit (sc2_eval_ops: K1's; sc_eval_ops, sc4_eval_ops)."""
    D1 = pp.bb_coeffs.shape[-1]
    if pp.family == "sc":
        return 3 * (D1 - 1) + 40 + 14 * SFU
    if pp.family == "sc4":
        return 6 * (D1 - 1) + 50 + 15 * SFU
    return 3 * (D1 - 1) + 30 + 10 * SFU


def pop_grad_ops(pp):
    """P3's evaluation at one real point: P1's point plus K7's reverse pass
    (sc2_grad_ops)."""
    D1 = pp.bb_coeffs.shape[-1]
    return pop_eval_ops(pp) + 4 * (D1 - 1) + 30 + 7 * SFU


def pop_table_bytes(pp):
    """The per-point data a launch must read once: at each real point the
    table row and the seven per-point arrays in the compute type; a
    transient's real points (int32) and three float64 scalars."""
    S, _, D1 = pp.bb_coeffs.shape
    n = pop_points(pp)
    return n * (D1 + 7) * pp.bb_coeffs.element_size() + 4 * S + 3 * 8 * S


def pop_state(pp, lo, up, W, seed, dev):
    """W walker states a transient (S, W, ndim), rescaled float32 over the
    window [lo, up] (what "auto" gives on CUDA), 1% outside the priors; and
    the map's offset and scale."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.fitting import _state_rescaling
    rng = np.random.default_rng(seed)
    S = pp.n_transients
    p = rng.uniform(lo, up, size=(S, W, len(lo)))
    out = rng.random((S, W)) < 0.01
    p[out, 0] = -1.0
    kw = _state_rescaling(torch.float32, lo, up, dev)
    off, sc = kw["param_offset"], kw["param_scale"]
    return torch.as_tensor((p - off) / sc, device=dev).float().contiguous(), off, sc


def pop_check_half_step(name, pp, off, sc, x0, seed, rel):
    """P2 (h = 0, 1) against its plain version under shared draws on the
    rescaled state x0 (S, 2, half, ndim), as check_half_step: accept flags
    equal except near-ties, new states bit-equal and new log-posteriors within
    ``rel`` of the term scale where they agree, the chain slot the new half,
    the other half untouched. Returns (near-ties, accepts, max |d logp|)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    dev = x0.device
    S, _, half, ndim = x0.shape
    l0 = kpop.log_posterior(pp, x0.reshape(S, 2 * half, ndim), off, sc).reshape(S, 2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (S, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)

    def plain(q):
        return kpop.log_posterior_plain(pp, q, off, sc)

    def scales(q):
        return pp.term_scales(common.absolute_params(q, off, sc))

    ties, acc, max_abs = 0, 0, 0.0
    for h in (0, 1):
        what = f"{name} h={h}"
        xk, lk, xp, lpp = x0.clone(), l0.clone(), x0.clone(), l0.clone()
        ak = torch.zeros(shape, dtype=torch.int32, device=dev)
        ap = torch.zeros_like(ak)
        ck = torch.empty_like(x0)
        clk = torch.empty(shape, dtype=torch.float64, device=dev)
        kpop.stretch_half_step(pp, xk, lk, h, u_z, j, u_acc, 2.0, off, sc, ck, clk, ak)
        kpop.stretch_half_step_plain(plain, xp, lpp, h, u_z, j, u_acc, 2.0, n_accept=ap)
        torch.cuda.synchronize()
        agree = ak[:, h] == ap[:, h]
        y, z = common.propose_stretch(u_z[:, h], j[:, h], x0[:, h], x0[:, 1 - h])
        gap = (torch.log(u_acc[:, h]).double() - ((ndim - 1.0) * torch.log(z).double() + plain(y)
                                                  - l0[:, h])).abs()
        tie_ok = gap <= 1e-5 * (scales(y) + scales(x0[:, h]))
        if not bool((agree | tie_ok).all()):
            raise AssertionError(f"{what}: {int((~agree & ~tie_ok).sum())} accept flags differ "
                                 "away from near-ties")
        if not torch.equal(xk[:, h][agree], xp[:, h][agree]):
            raise AssertionError(f"{what}: new states differ where the flags agree")
        if not torch.equal(xk[:, 1 - h], x0[:, 1 - h]) or not torch.equal(ak[:, 1 - h],
                                                                           ap[:, 1 - h]) \
                or not torch.equal(ck[:, h], xk[:, h]) or not torch.equal(clk[:, h], lk[:, h]):
            raise AssertionError(f"{what}: wrong half or chain slot written")
        d = compare_ll(f"{what} new logp", lk[:, h][agree], lpp[:, h][agree], rel,
                       scale=scales(xk[:, h])[agree])
        max_abs = max(max_abs, d[0])
        ties += int((~agree).sum())
        acc += int(ak[:, h].sum())
    return ties, acc, max_abs


def pop_p1_repeats_p2(pp, off, sc, x0, seed):
    """Two P2 half-steps at u_acc = 0 (every proposal inside the priors
    accepted) from x0, then P1 at the new states: the number of walkers
    whose P1 value differs in any bit from the value P2 stored, and the
    number P2 moved."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    S, _, half, ndim = x0.shape
    x = x0.clone()
    logp = kpop.log_posterior(pp, x.reshape(S, 2 * half, ndim), off, sc).reshape(S, 2, half)
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    shape = (S, 2, half)
    u_z = torch.rand(shape, generator=g, device=x.device, dtype=x.dtype)
    j = torch.randint(0, half, shape, generator=g, device=x.device)
    acc = torch.zeros(shape, dtype=torch.int32, device=x.device)
    for h in (0, 1):
        kpop.stretch_half_step(pp, x, logp, h, u_z, j, torch.zeros_like(u_z), 2.0, off, sc,
                               n_accept=acc)
    again = kpop.log_posterior(pp, x.reshape(S, 2 * half, ndim), off, sc).reshape(S, 2, half)
    return int((again != logp).sum()), int(acc.sum())


def pop_check_p1_forms(name, pp, off, sc, q):
    """P1's warp and latency forms bit for bit at the states q (S, W,
    ndim). Returns the values (S, W)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    got = [kpop.log_posterior(pp, q, off, sc, form=f) for f in POP_FORMS["pop_logpost"]]
    if not torch.equal(*got):
        raise AssertionError(f"{name}: P1's warp and latency forms differ at "
                             f"{int((got[0] != got[1]).sum())} walkers")
    return got[0]


def pop_check_forms(name, pp, off, sc, x0, u0, bounds, seed):
    """P1's two forms bit for bit at x0 (S, 2, half, ndim), then P2's: two
    half-steps (h = 0, 1) from x0 under shared draws, writing the chain
    slot, in each form; their states, log-posteriors, accept counts and
    chain slots equal. With ``u0`` (S, n_starts, ndim), P3's two forms too:
    the last iterates and -log p equal. Returns (accepts, -inf
    log-posteriors after the steps)."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    dev = x0.device
    S, _, half, ndim = x0.shape
    l0 = pop_check_p1_forms(name, pp, off, sc, x0.reshape(S, 2 * half, ndim)).reshape(S, 2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (S, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev, dtype=x0.dtype)
    out = {}
    for form in POP_FORMS["pop_half_step"]:
        x, lg = x0.clone(), l0.clone()
        acc = torch.zeros(shape, dtype=torch.int32, device=dev)
        cx, cl = torch.empty_like(x0), torch.empty(shape, dtype=torch.float64, device=dev)
        for h in (0, 1):
            kpop.stretch_half_step(pp, x, lg, h, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                                   form=form)
        out[form] = (x, lg, acc, cx, cl)
    torch.cuda.synchronize()
    for a, b, what in zip(*out.values(), ("states", "log-posteriors", "accept counts",
                                          "chain states", "chain log-posteriors")):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: P2's warp and latency forms differ in {what}")
    if u0 is not None:
        m = [kpop.map_ascent(pp, u0, bounds, POP_ITER, form=f) for f in POP_FORMS["pop_map"]]
        if not (torch.equal(m[0][0], m[1][0]) and torch.equal(m[0][1], m[1][1])):
            raise AssertionError(f"{name}: P3's warp and pair forms differ")
    lg = out["warp"][1]
    return int(out["warp"][2].sum()), int(torch.isinf(lg).sum())


def pop_poisoned(pp, every=5):
    """A copy of pp whose transients 0, every, 2 every, ... have the table
    row of their last real point, and so of its padded copies, lifted by a
    constant term of 1e30: the model value there is +inf, the real point's
    term inf and each padded one's (0 - inf) * 0 = NaN. Returns it and the
    poisoned transients."""
    import copy
    import torch
    bad = copy.copy(pp)
    bad.bb_coeffs = pp.bb_coeffs.clone()
    bad.kernel_params = {}
    rows = torch.arange(0, pp.n_transients, every)
    for e in rows.tolist():
        bad.bb_coeffs[e, int(pp.n_real[e]) - 1:, 0] = 1e30
    return bad, rows


def pop_check_poisoned(name, pp, off, sc, q, seed):
    """On :func:`pop_poisoned`'s copy: P1 -inf at every walker of the
    poisoned transients and its plain version's -inf set the same, in each
    form; P1's and P2's two forms bit for bit (:func:`pop_check_forms`),
    the poisoned transients' log-posteriors still -inf. Returns the -inf
    values P2 kept."""
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    bad, rows = pop_poisoned(pp)
    want = kpop.log_posterior_plain(bad, q, off, sc)
    for form in POP_FORMS["pop_logpost"]:
        got = kpop.log_posterior(bad, q, off, sc, form=form)
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)) or not bool(
                torch.isneginf(got[rows.to(got.device)]).all()):
            raise AssertionError(f"{name}: P1's -inf set ({form} form) differs from the plain "
                                 "version's, or a poisoned transient is finite")
    S = q.shape[0]
    x0 = q.reshape(S, 2, q.shape[1] // 2, -1).contiguous()
    _, n_inf = pop_check_forms(name, bad, off, sc, x0, None, None, seed)
    if n_inf < len(rows) * q.shape[1]:
        raise AssertionError(f"{name}: the poisoned transients' log-posteriors left -inf")
    return n_inf


def pop_check_map(name, pp, u0, bounds, rel, points):
    """P3 against map_ascent_plain from the starts u0 (S, n_starts, ndim):
    the same finite set of final -log p; each transient's best start (the
    first of the least -log p, as _map_seeded_guesses keeps it) the same or
    a near-tie (the plain values of the two within 1e-5 of their
    magnitude); where it is the same, the plain log-posterior at its MAP
    point (the bijection of its last iterate) within ``rel`` of the term
    scale of the plain ascent's, and with ``points`` the MAP points within
    ``rel`` of the prior's width (a one-sided or open dimension: of max(|x|,
    1)); ``rel`` None reports the differences without holding them. In
    float32 a MAP point drifts along the posterior's flat directions, so
    float32 holds the values alone; with the intrinsic scatter not even
    those: the plain ascent's float32 sigma gradient parts from the
    kernel's from the first Adam step and lands 1e-2 to 1e-1 of the term
    scale from the float64 MAP, where P3 lands within 1e-6 (the float64
    ascents agree to 1e-14 over 400 steps, sigma or not: PERF.md §6), so
    :func:`pop_map_f64_gaps` holds both float32 ascents to the float64 one
    instead. Returns a dict: ``max_v`` (the largest scaled value
    difference), ``ties`` (the near-ties), ``max_x`` (the largest scaled
    MAP point difference), ``max_dx`` (the largest absolute one),
    ``best_kernel`` and ``best_plain`` (each transient's best MAP point
    (S, ndim) float64 of either ascent) and ``plain_ms`` (the plain ascent's
    time, by CUDA events)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    u_k, n_k = kpop.map_ascent(pp, u0, bounds, POP_ITER)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    u_p, n_p = kpop.map_ascent_plain(pp, u0, bounds, POP_ITER)
    end.record()
    torch.cuda.synchronize()
    fin_k, fin_p = torch.isfinite(n_k), torch.isfinite(n_p)
    if not torch.equal(fin_k, fin_p):
        raise AssertionError(f"{name}: finite sets of -log p differ at "
                             f"{int((fin_k != fin_p).sum())} starts")

    def best(n):
        return torch.argmin(torch.where(torch.isfinite(n), n, torch.full_like(n, torch.inf)),
                            dim=1)
    b_k, b_p = best(n_k), best(n_p)
    rows = torch.arange(len(b_k), device=b_k.device)
    alive = torch.isfinite(n_p[rows, b_p])
    same = (b_k == b_p) & alive
    x_k = bounds.to_bounded(u_k[rows, b_k])
    x_p = bounds.to_bounded(u_p[rows, b_p])
    lp_k, lp_p = (pp.plain(x[:, None])[:, 0] for x in (x_k, x_p))
    dv = ((lp_k - lp_p).abs() / pp.term_scales(x_p[:, None])[:, 0])[same]
    max_v = float(dv.max()) if dv.numel() else 0.0
    width = torch.as_tensor(np.where(bounds.two_sided, bounds._width, 1.0), device=x_p.device)
    width = torch.where(torch.as_tensor(bounds.two_sided, device=x_p.device), width,
                        x_p.abs().clamp_min(1.0))
    d = (x_k - x_p).abs()[same]
    dx = (d / width[same]).amax(dim=1) if d.numel() else d
    max_x = float(dx.max()) if dx.numel() else 0.0
    if rel is not None and (max_v > rel or (points and max_x > rel)):
        raise AssertionError(f"{name}: MAP log-posteriors differ by {max_v:.3e} of the term "
                             f"scale, points by {max_x:.3e} of the width (> {rel:.0e})")
    tie = ~same & alive
    gap = (n_p[rows, b_k] - n_p[rows, b_p]).abs()
    if rel is not None and bool((gap > 1e-5 * n_p[rows, b_p].abs())[tie].any()):
        raise AssertionError(f"{name}: another start kept away from a near-tie")
    return {"max_v": max_v, "ties": int(tie.sum()), "max_x": max_x,
            "max_dx": float(d.max()) if d.numel() else 0.0, "best_kernel": x_k,
            "best_plain": x_p, "plain_ms": start.elapsed_time(end)}


def pop_map_f64_gaps(name, pp64, best, best64, limit):
    """How near each float32 ascent lands to the float64 MAP: for each
    transient, the float64 -log p (``pp64``, the same population in float64
    compute) at the ascent's best MAP point less that at the float64 plain
    ascent's (``best64``, (S, ndim)), over the term scale there, from the
    same starts. ``best``: ascent name -> (S, ndim) float64 points. Raises
    where a gap's magnitude passes ``limit[name]`` (None: reported alone).
    Returns name -> the largest |gap|, and the transients where the first
    ascent of ``best`` lands nearer than the second."""
    import torch
    ref = pp64.plain(best64[:, None])[:, 0]
    scale = pp64.term_scales(best64[:, None])[:, 0]
    alive = torch.isfinite(ref)
    gaps = {k: ((ref - pp64.plain(x[:, None])[:, 0]) / scale)[alive] for k, x in best.items()}
    out = {k: float(g.abs().max()) if g.numel() else 0.0 for k, g in gaps.items()}
    if limit is not None:
        for k, v in out.items():
            if not v <= limit[k]:
                raise AssertionError(f"{name}: the {k} ascent's best MAP point lies {v:.3e} of "
                                     f"the term scale from the float64 plain ascent's in float64 "
                                     f"-log p (> {limit[k]:.0e})")
    first, second = (gaps[k].abs() for k in best)
    return out, int((first < second).sum())


def phase_pop_kernels(seed=27):
    """27: P1, P2 and P3 against their plain versions on the card: the
    example's population at S = 64 and 512 and at 28c's POP_DIAG (three
    parameters, P2 in the latency form there), its MJD-scale
    twin at S = 64 (t_exp the fourth) and at S = 64 with the intrinsic
    scatter (ndim 4), float32 and float64 compute, 64 walkers; P1 at the
    states P2 accepted gives P2's stored values bit for bit; each kernel
    timed at each of these S in float32 (events and the profiler's device
    time) beside its plain version and its bound."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    from time_port_kernels import device_ms

    dev = torch.device("cuda")
    cases = [("S64", 64, False, False), ("S512", 512, False, False),
             (f"S{POP_DIAG}", POP_DIAG, False, False), ("S64 MJD t_exp", 64, True, False),
             ("S64 sigma", 64, False, True)]
    pops = {S: pop_example(S, dev) for S in POP_SIZES + (POP_DIAG,)}
    pops.update({("mjd", S): pop_example(S, dev, mjd=True) for S in POP_SIZES + (POP_DIAG,)})
    pops["mjd"] = pops[("mjd", POP_SIZES[0])]
    n0 = {k: kernels.LAUNCHES[k] for k in POP_KERNELS}
    lines, times, errs, best32 = [], {}, {"P1": 0.0, "P2": 0.0, "P3": 0.0}, {}
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            for case, S, mjd, sigma in cases:
                lcs, models, _ = pops["mjd"] if mjd else pops[S]
                priors, lo, up = pop_priors(mjd, sigma)
                pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                         priors, sigma)
                rel = 1e-5 if label == "f32" else 1e-12
                q, off, sc = pop_state(pp, lo, up, POP_WALKERS, seed, dev)
                p_abs = common.absolute_params(q, off, sc)
                got = kpop.log_posterior(pp, q, off, sc)
                want = kpop.log_posterior_plain(pp, q, off, sc)
                d1 = compare_ll(f"P1 {label} {case}", got.flatten(), want.flatten(), rel,
                                scale=pp.term_scales(p_abs).flatten())
                x0 = q.reshape(S, 2, POP_WALKERS // 2, -1).contiguous()
                rep = pop_p1_repeats_p2(pp, off, sc, x0, seed + 1)
                if rep[0]:
                    raise AssertionError(f"P1 {label} {case}: {rep[0]} values at states P2 "
                                         "accepted differ from P2's stored ones")
                t2 = pop_check_half_step(f"P2 {label} {case}", pp, off, sc, x0, seed + 2, rel)
                bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
                x_st = np.random.default_rng(seed).uniform(lo, up, size=(S, POP_STARTS, len(lo)))
                u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
                rel_map = None if label == "f32" and sigma else POP_MAP_REL[label]
                t3 = pop_check_map(f"P3 {label} {case}", pp, u0, bounds, rel_map,
                                   points=label == "f64")
                lines.append(f"{label} {case}: P1 max |d| {d1[0]:.3e} (<= {rel:.0e} of the term "
                             f"scale), P1 at the states P2 accepted: {rep[0]} of "
                             f"{S * POP_WALKERS} differ ({rep[1]} moves); P2 {t2[0]} near-ties, "
                             f"{t2[1]} accepts, max |d logp| {t2[2]:.3e}; P3 the MAP points' "
                             f"log-posteriors within {t3['max_v']:.3e} of the term scale ("
                             + (f"<= {rel_map:.0e}" if rel_map else "not held: float32 with the "
                                "scatter") + f"), the points within {t3['max_x']:.3e} of the "
                             f"width{' (<= 1e-09)' if label == 'f64' else ''} (max |d| "
                             f"{t3['max_dx']:.3e}), {t3['ties']} near-ties")
                if label == "f32":
                    for k, v in (("P1", d1[0]), ("P2", t2[2]), ("P3", t3["max_dx"])):
                        errs[k] = max(errs[k], v)
                    best32[case] = {"kernel": t3["best_kernel"], "plain": t3["best_plain"]}
                    if not mjd and not sigma:
                        times[S] = pop_times(pp, q, off, sc, x0, u0, bounds, t3["plain_ms"],
                                             device_ms)
                else:
                    g, nearer = pop_map_f64_gaps(f"P3 f32 {case}", pp, best32[case],
                                                 t3["best_plain"], POP_MAP_F64[sigma])
                    lines.append(f"f32 {case} against the float64 plain ascent: P3's best MAP "
                                 f"points {g['kernel']:.3e} of the term scale from its float64 "
                                 f"-log p (<= {POP_MAP_F64[sigma]['kernel']:.0e}), the "
                                 f"float32 plain ascent's {g['plain']:.3e} (<= "
                                 f"{POP_MAP_F64[sigma]['plain']:.0e}); P3 nearer at {nearer} "
                                 f"of {S}")
        finally:
            config.set_compute_dtype(config.AUTO)
    lines.append(pop_forms_checks(pops, seed))
    refit_line, refit_times = pop_refit_shape_checks(seed + 6, device_ms)
    lines.append(refit_line)
    launched = {k: kernels.LAUNCHES[k] - n0[k] for k in POP_KERNELS}
    from lightcurve_fitting_tpu_torch.kernels import build
    from time_port_kernels import ptxas_report
    report = {k: v for k, v in ptxas_report(build.build_info()["log"]).items()
              if "PopSC2WarpModel" in k or "pop_map_kernel" in k}
    regs = {what: sorted({tuple(v) for k, v in report.items() if key in k})
            for what, key in (("P1 warp form", "logpost_warp_kernel"),
                              ("P1 latency form", "logpost_latency_kernel"),
                              ("P2 warp form", "stretch_half_step_kernel"),
                              ("P2 latency form", "stretch_half_step_latency_kernel"),
                              ("P3", "pop_map_kernel"))}
    for what, key, n in (("P3", "pop_map_kernel", 12),
                         ("P2's latency form", "stretch_half_step_latency_kernel", 12)):
        ks = {k: v for k, v in report.items() if key in k}
        if len(ks) != n or any(v[2] or v[3] for v in ks.values()):
            raise AssertionError(f"{what} ({n} instantiations) must not spill: {ks}")
    names = [expect_kernel(lambda: kpop.log_posterior(pp, q, off, sc, form=f),
                           f"logpost_{f}_kernel", "PopSC2WarpModel", calls=2)
             for f in POP_FORMS["pop_logpost"]]
    phase("population kernels", "; ".join(lines) + f"; {launched} comparison launches; "
          + "; ".join(f"S = {S}: " + ", ".join(
              f"{k} {v['ms']:.4f} ms (device {v['dev']:.4f}; plain {v['plain_ms']:.4f}; bound "
              f"{v['bound_ms']:.5f}, {v['bound_by']}"
              + (", device by form " + ", ".join(f"{f} {ms:.4f}" for f, ms in v["forms"].items())
                 if "forms" in v else "") + ")" for k, v in t.items())
              for S, t in times.items()) + f"; the profiler saw {names}; ptxas (registers, stack "
          f"frame, spill stores, spill loads) by kernel over its instantiations: {regs}")
    return {k: {"max_abs_err": errs[k], "ms": times[POP_SIZES[0]][k]["ms"],
                "plain_ms": times[POP_SIZES[0]][k]["plain_ms"],
                **{f: times[POP_SIZES[0]][k][f] for f in ("bound_ms", "bound_by", "library_ms")},
                "at": {S: (t[k]["ms"], t[k]["dev"], t[k]["plain_ms"], t[k]["bound_ms"])
                       for S, t in times.items()},
                **({"forms": {S: t[k]["forms"] for S, t in times.items()}}
                   if "forms" in times[POP_SIZES[0]][k] else {}),
                **({"refit": refit_times} if k == "P1" else {})} for k in errs}


def pop_forms_checks(pops, seed):
    """27's forms: P2's two forms bit for bit at S = 64, 512 and POP_DIAG
    (28c's, where the rule picks the latency form), ndim 3
    (T_1, L_1, t_tr), 4 (t_exp fitted, or the intrinsic scatter) and 5
    (both), float32 and float64 compute; P3's two forms bit for bit on the
    same populations; and at S = 64 without and with the scatter the
    poisoned copies (:func:`pop_check_poisoned`). Returns the phase's line."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    dev = torch.device("cuda")
    parts = []
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            for S in POP_SIZES + (POP_DIAG,):
                for mjd, sigma in ((False, False), (True, False), (False, True), (True, True)):
                    lcs, models, _ = pops[("mjd", S) if mjd else S]
                    priors, lo, up = pop_priors(mjd, sigma)
                    pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                             priors, sigma)
                    q, off, sc = pop_state(pp, lo, up, POP_WALKERS, seed + 3, dev)
                    x0 = q.reshape(S, 2, POP_WALKERS // 2, -1).contiguous()
                    bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
                    x_st = np.random.default_rng(seed).uniform(lo, up,
                                                               size=(S, POP_STARTS, len(lo)))
                    u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
                    what = f"{label} S = {S} ndim {len(lo)}{' (scatter)' if sigma else ''}"
                    acc, _ = pop_check_forms(f"27 forms {what}", pp, off, sc, x0, u0, bounds,
                                             seed + 4)
                    msg = f"{what}: {acc} accepts"
                    if S == POP_SIZES[0] and not mjd:
                        msg += (f", poisoned: {pop_check_poisoned(f'27 poisoned {what}', pp, off, sc, q, seed + 5)}"
                                " -inf log-posteriors kept")
                    parts.append(msg)
        finally:
            config.set_compute_dtype(config.AUTO)
    return ("P1's warp and latency forms bit for bit, P2's warp and latency forms bit for bit "
            "(two half-steps: states, log-posteriors, accept counts, chain slot) and P3's warp "
            "and pair forms bit for bit (last iterates, -log p) at " + "; ".join(parts))


def pop_refit_shape_checks(seed, device_ms):
    """27 at the exact-refit CV's widths (POP_REFIT_SHAPES, 64 walkers): P1's
    two forms bit for bit (:func:`pop_check_p1_forms`) and within 1e-5
    (float32) or 1e-12 (float64) of the term scale of the plain version, on
    the rescaled states, 1% outside the priors; ndim 3 (T_1, L_1, t_tr), 4
    (t_exp fitted, as the flagship's refits, or the intrinsic scatter) and
    5, float32 and float64 compute; each form's -inf set the plain
    version's on :func:`pop_poisoned`'s copy; in float32 at ndim 4 (t_exp)
    the device time of P1 in each form, of its plain version (events) and
    of P2's warp form (one half-step with the chain slot: P2's latency form
    takes at most 128 points). Returns (the line, {(S, N): {"warp": ms,
    "latency": ms, "plain": ms, "p2_warp": ms, "bound_ms": ms}})."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    dev = torch.device("cuda")
    parts, times = [], {}
    for S, n in POP_REFIT_SHAPES:
        pops = {mjd: pop_example(S, dev, mjd, POP_REFIT_EPOCHS, n) for mjd in (False, True)}
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(torch.float64)
                rel = 1e-5 if label == "f32" else 1e-12
                worst = 0.0
                for mjd, sigma in ((False, False), (True, False), (False, True), (True, True)):
                    lcs, models, _ = pops[mjd]
                    priors, lo, up = pop_priors(mjd, sigma)
                    pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                             priors, sigma)
                    what = (f"27 refit shape {S} x {POP_WALKERS} at {n} points {label} ndim "
                            f"{len(lo)}")
                    q, off, sc = pop_state(pp, lo, up, POP_WALKERS, seed, dev)
                    got = pop_check_p1_forms(what, pp, off, sc, q)
                    want = kpop.log_posterior_plain(pp, q, off, sc)
                    d = compare_ll(what, got.flatten(), want.flatten(), rel,
                                   scale=pp.term_scales(common.absolute_params(q, off, sc))
                                   .flatten())
                    worst = max(worst, d[1])
                    bad, rows = pop_poisoned(pp, every=2)
                    want_bad = torch.isneginf(kpop.log_posterior_plain(bad, q, off, sc))
                    for form in POP_FORMS["pop_logpost"]:
                        got_bad = torch.isneginf(kpop.log_posterior(bad, q, off, sc, form=form))
                        if not torch.equal(got_bad, want_bad) or not bool(
                                got_bad[rows.to(dev)].all()):
                            raise AssertionError(f"{what}: P1's -inf set on the poisoned copy "
                                                 f"({form} form) is not the plain version's")
                    if label == "f32" and mjd and not sigma:
                        times[(S, n)] = pop_refit_times(pp, q, off, sc, seed, device_ms)
                parts.append(f"{S} x {POP_WALKERS} at {n} points {label} (rule: "
                             f"{kpop.logpost_form(S, POP_WALKERS, n, pop_sms())}): ndim 3-5 "
                             f"bit-equal, max |d|/scale {worst:.3e} (<= {rel:.0e}), -inf kept")
            finally:
                config.set_compute_dtype(config.AUTO)
    line = ("P1's two forms at the exact-refit CV's widths: " + "; ".join(parts)
            + "; device ms (f32, ndim 4) " + "; ".join(
                f"{S} x {POP_WALKERS} at {n}: P1 warp {t['warp']:.4f}, latency {t['latency']:.4f}"
                f", plain {t['plain']:.4f}, bound {t['bound_ms']:.5f}; P2 warp form "
                f"{t['p2_warp']:.4f}" for (S, n), t in times.items()))
    return line, times


def pop_sms():
    import torch
    from lightcurve_fitting_tpu_torch.kernels.gradient import sm_count
    return sm_count(torch.device("cuda"))


def pop_times(pp, q, off, sc, x0, u0, bounds, plain_map_ms, device_ms):
    """Each population kernel's events and device time, its plain version's
    and its bound, at the population of pp (float32 compute, the rescaled
    float32 state): P1 on its walkers, P2 one half-step with the chain slot
    (as production writes it), P3 the whole ascent (its plain version's
    time ``plain_map_ms``, from :func:`pop_check_map`; none without the
    starts ``u0``)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    dev = q.device
    S, _, half, ndim = x0.shape
    W = 2 * half
    x = x0.clone()
    logp = kpop.log_posterior(pp, x.reshape(S, W, ndim), off, sc).reshape(S, 2, half)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    shape = (S, 2, half)
    u_z = torch.rand(shape, generator=g, device=dev)
    j = torch.randint(0, half, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev)
    acc = torch.zeros(shape, dtype=torch.int32, device=dev)
    cx, cl = torch.empty_like(x), torch.empty(shape, dtype=torch.float64, device=dev)

    def p1(**fkw):
        return kpop.log_posterior(pp, q, off, sc, **fkw)

    def p2(**fkw):
        kpop.stretch_half_step(pp, x, logp, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                               check_partners=False, **fkw)

    def p3(**fkw):
        return kpop.map_ascent(pp, u0, bounds, POP_ITER, **fkw)

    def p2_plain():
        kpop.stretch_half_step_plain(lambda y: kpop.log_posterior_plain(pp, y, off, sc),
                                     x.clone(), logp.clone(), 0, u_z, j, u_acc, 2.0)

    tables = pop_table_bytes(pp)
    n = pop_points(pp)
    ev, ev_g = pop_eval_ops(pp), pop_grad_ops(pp)
    out = {}
    kinds = [("P1", p1, lambda: kpop.log_posterior_plain(pp, q, off, sc), "logpost_",
              W * n * ev, q.numel() * 4 + tables + S * W * 8),
             ("P2", p2, p2_plain, "stretch_half_step", half * n * ev + S * half * PROPOSAL,
              S * W * ndim * 4 + S * half * ndim * 4 * 2 + S * half * (4 + 8 + 4 + 8 + 8 + 4 * 2)
              + tables)]
    if u0 is not None:
        n_starts = u0.shape[1]
        kinds.append(("P3", p3, None, "pop_map_kernel", n_starts * (POP_ITER + 1) * n * ev_g,
                      u0.numel() * 8 * 2 + S * n_starts * 8 + POP_ITER * 24 + tables))
    for name, fn, plain, match, ops, nbytes in kinds:
        out[name] = {"ms": cuda_ms(fn, repeats=2 if name == "P3" else 20),
                     "dev": float(np.nanmedian(device_ms(fn, match, 3 if name == "P3" else 10, 3))),
                     # P3's plain ascent (~5 s) was timed in pop_check_map
                     "plain_ms": plain_map_ms if name == "P3" else cuda_ms(plain, repeats=3),
                     **bound_fields(ops, nbytes)}
    # each form's device time (the rule's form is timed above)
    for name, fn, key, match in (("P1", p1, "pop_logpost", "logpost_"),
                                 ("P2", p2, "pop_half_step", "stretch_half_step"),
                                 ("P3", p3, "pop_map", "pop_map_kernel"))[:len(kinds)]:
        out[name]["forms"] = {f: float(np.nanmedian(device_ms(
            lambda: fn(form=f), match, 3 if name == "P3" else 10, 3))) for f in POP_FORMS[key]}
    return out


def pop_fit(S, dev, profile=False):
    """examples/fit_population.py's joint fit at its defaults on S
    transients (64 walkers, 100 + 500 steps, init="map" with 16 starts x 400
    Adam steps, seed 1, summaries on the card, no chains): its wall time, the
    launches, the recovery, the acceptance against the JAX package's;
    ``profile`` adds a profiled repeat's busy time and idle share."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.parallel import fit_population

    lcs, models, truths = pop_example(S, dev)
    priors = pop_priors()[0]

    def fit():
        return fit_population(models, lcs, priors, p_lo=POP_LO, p_up=POP_UP,
                              nwalkers=POP_WALKERS, nsteps=POP_STEPS, nsteps_burnin=POP_BURNIN,
                              seed=1, init="map", summaries=True, return_chains=False)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat, acc, summ = fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, forms = pop_run_launches(f"28 S = {S}", dict(kernels.LAUNCHES), S, POP_WALKERS,
                                       max(len(lc) for lc in lcs), POP_BURNIN + POP_STEPS,
                                       map_starts=POP_STARTS, others=("percentile",))
    if flat is not None or summ.shape != (S, 3, 3) or not np.isfinite(summ).all() \
            or acc.shape != (S,) or not np.isfinite(acc).all():
        raise AssertionError(f"28 S = {S}: bad outputs")
    med = summ[:, :, 1]
    ok = (np.abs(med[:, 0] - truths[:, 0]) < 0.2 * truths[:, 0]) & \
        (np.abs(med[:, 1] - truths[:, 1]) < 0.3 * truths[:, 1])
    mean_acc = float(np.mean(acc))
    ref = POP_REF[S]
    if not np.all(acc > 0.1) or abs(mean_acc - ref[0]) > POP_ACC_TOL or ok.sum() < ref[2] - max(
            2, S // 32):
        raise AssertionError(f"28 S = {S}: mean acceptance {mean_acc:.4f} (JAX {ref[0]:.4f} +- "
                             f"{POP_ACC_TOL}), least {acc.min():.3f} (> 0.1), {int(ok.sum())} "
                             f"of {S} recovered (JAX {ref[2]})")
    res = {"S": S, "wall": wall, "launches": launches, "forms": forms,
           "acc": mean_acc, "min_acc": float(acc.min()), "ok": int(ok.sum())}
    if profile:
        wall_p, prof = profiled(fit, cpu=False)
        parts, busy = time_split(prof, wall_p, POP_SPLIT)
        res.update(wall_p=wall_p, busy=busy, parts=parts)
    return res


def pop_run_launches(what, launches, S, W, N, steps, count="pop", map_starts=None, others=()):
    """One fit_population run's ``launches`` (counted from 0 just before it)
    over S transients of W walkers on rows of N padded points: P1 once and
    P2 twice each of ``steps`` steps under ``count``'s names (``pop`` over
    ShockCooling2, ``pop_sc``, ``pop_sc4``), each in the form
    ``kernels/pop.py``'s rules pick, P3 once in its rule's form with
    ``map_starts`` starts (init="map"), each kernel of ``others`` at least
    once, nothing else. Returns ({kernel or kernel_form: launches}, {kernel:
    form})."""
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    sms = pop_sms()
    p1, p2 = f"{count}_logpost", f"{count}_half_step"
    forms = {p1: kpop.logpost_form(S, W, N, sms), p2: kpop.half_form(S, W // 2, N, sms)}
    want = {p1: 1, p2: 2 * steps}
    kinds = {p1: "pop_logpost", p2: "pop_half_step"}
    if map_starts:
        forms["pop_map"], want["pop_map"], kinds["pop_map"] = \
            kpop.map_form(S, map_starts, N, sms), 1, "pop_map"
    for k, kind in kinds.items():
        want.update({f"{k}_{f}": want[k] if f == forms[k] else 0 for f in POP_FORMS[kind]})
    got = {k: launches.get(k, 0) for k in want}
    extra = {k: v for k, v in launches.items() if v and k not in want and k not in others}
    if got != want or extra or any(launches.get(k, 0) < 1 for k in others):
        raise AssertionError(f"{what}: launches {got} and {extra}, expected {want} and "
                             f"{others} at least once")
    return got, forms


def pop_diagnostics(dev):
    """The example's survey diagnostics: its first POP_DIAG transients refit
    with chains (its launches counted from 0 and held to the rules' forms at
    S = POP_DIAG, as 28a-b's), then population_goodness_of_fit and
    population_information_criteria on the card, held to the same functions
    on the CPU in float64 (the flux in the card's float32 compute dtype):
    chi2 and the elpds within 1e-3 relative, p within 1e-3."""
    import warnings
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    from lightcurve_fitting_tpu_torch.parallel.population import (
        population_goodness_of_fit, population_information_criteria)

    lcs, models, _ = pop_example(POP_DIAG, dev)
    kernels.reset_launch_counts()
    flat, acc = fit_population(models, lcs, pop_priors()[0], p_lo=POP_LO, p_up=POP_UP,
                               nwalkers=POP_WALKERS, nsteps=POP_STEPS, nsteps_burnin=POP_BURNIN,
                               seed=1, init="map")
    launches, forms = pop_run_launches("28c", dict(kernels.LAUNCHES), POP_DIAG, POP_WALKERS,
                                       max(len(lc) for lc in lcs), POP_BURNIN + POP_STEPS,
                                       map_starts=POP_STARTS)
    if flat.shape != (POP_DIAG, POP_WALKERS * POP_STEPS, 3) or not np.isfinite(flat).all():
        raise AssertionError(f"28c: bad chains {flat.shape}")
    import scipy.stats  # noqa: F401  (imported by the goodness of fit: ~4 s the first time)
    t0 = time.perf_counter()
    gof = population_goodness_of_fit(models, lcs, flat, seed=0, quiet=True)
    ic = population_information_criteria(models, lcs, flat, seed=0, quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = [type(m)(lc) for m, lc in zip(models, lcs)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gof_c = population_goodness_of_fit(cpu, lcs, flat, seed=0, quiet=True, device="cpu")
        ic_c = population_information_criteria(cpu, lcs, flat, seed=0, quiet=True, device="cpu")
    worst = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
                for a, b, keys in ((gof, gof_c, ("chi2",)), (ic, ic_c, ("elpd_loo", "elpd_waic")))
                for k in keys)
    worst_p = float(np.max(np.abs(gof["p_value"] - gof_c["p_value"])))
    if not (np.isfinite(gof["chi2"]).all() and np.all((gof["p_value"] >= 0) & (gof["p_value"]
                                                                                 <= 1))
            and np.isfinite(ic["elpd_loo"]).all()) or worst > 1e-3 or worst_p > 1e-3:
        raise AssertionError(f"28c: diagnostics {gof}, {ic['elpd_loo']}; worst relative "
                             f"difference from the CPU's {worst:.3e}, of p {worst_p:.3e}")
    return {"launches": launches, "forms": forms,
            "acc": float(np.mean(acc)), "chi2_nu": gof["chi2_nu"], "p": gof["p_value"],
            "elpd_loo": ic["elpd_loo"], "k_max": [float(np.max(k)) for k in ic["pareto_k"]],
            "wall": wall, "worst": worst, "worst_p": worst_p}


def phase_pop_main_path(smi):
    """28: examples/fit_population.py through the public fit_population at
    its defaults, S = 64 (a) and 512 (b), the counters reset before each:
    P1 once, P2 twice a step, P3 once and K5 for the summaries, nothing
    else; each transient's acceptance above 0.1 and the mean within
    POP_ACC_TOL of the JAX package's float64 CPU value at the same seed;
    the recovered transients (T_1 within 20%, L_1 within 30%) no fewer than
    the JAX run's less a few; the wall, a profiled repeat's busy time and
    idle share; (c) the diagnostics of the example's subset, its fit's
    launches counted and held as (a)-(b)'s. Returns each run's launches
    {"28a": ..., "28b": ..., "28c": ...}."""
    import torch
    dev = torch.device("cuda")
    runs = [pop_fit(S, dev, profile=True) for S in POP_SIZES]
    diag = pop_diagnostics(dev)
    for r in runs:
        phase(f"population main path 28{'ab'[POP_SIZES.index(r['S'])]}",
              f"fit_population S = {r['S']}, {POP_WALKERS} walkers x {POP_BURNIN} + "
              f"{POP_STEPS} steps, init=\"map\" ({POP_STARTS} x {POP_ITER}), summaries, no "
              f"chains: {r['wall']:.3f} s end to end (pack and host stages included; on "
              f"{smi}); launches {r['launches']}; mean acceptance {r['acc']:.4f} (JAX float64 "
              f"CPU {POP_REF[r['S']][0]:.4f} +- {POP_ACC_TOL}), least {r['min_acc']:.3f}; "
              f"{r['ok']} of {r['S']} transients recovered (JAX {POP_REF[r['S']][2]}); profiled "
              f"repeat {r['wall_p']:.3f} s, device busy {r['busy']:.3f} s (idle share "
              f"{1 - r['busy'] / r['wall_p']:.3f}): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in r["parts"].items()))
    phase("population diagnostics 28c", f"the first {POP_DIAG} transients refit with chains "
          f"(launches {diag['launches']}; mean acceptance {diag['acc']:.4f}); "
          "population_goodness_of_fit and "
          f"population_information_criteria on the card in {diag['wall']:.3f} s: chi2_nu "
          f"{fmt(diag['chi2_nu'])}, p {fmt(diag['p'])}, elpd_loo {fmt(diag['elpd_loo'])}, max "
          f"pareto_k {fmt(diag['k_max'])}; against the CPU's float64: chi2 and elpds within "
          f"{diag['worst']:.3e} relative (<= 1e-3), p within {diag['worst_p']:.3e} (<= 1e-3)")
    return {**{f"28{'ab'[k]}": r["launches"] for k, r in enumerate(runs)},
            "28c": diag["launches"]}


# ----------------------------------------------------- the exact-refit CV (29)

# tools/validate_logo_refit.py's flagship chain: SN 2016bkv MJD 57468-57485,
# ShockCooling2, the priors of flagship_priors() and this window
REFIT_CHAIN = dict(nwalkers=128, nsteps=1000, nsteps_burnin=2000, init="map", seed=0)
REFIT_WINDOW = ([20.0, 2.0, 20.0, 57468.5], [50.0, 5.0, 50.0, 57468.7])
# _exact_cv_elpd's defaults (the refits' walkers, steps and MAP starts)
REFIT_WALKERS, REFIT_STEPS, REFIT_BURNIN = 64, 500, 500
# VALIDATION.md:262-270, the JAX package's leave-one-band-out table on its
# own chain (refits of 64 walkers x 1000 + 1000): band -> (pareto_k, PSIS
# elpd, elpd shipped); printed beside the port's, not held (other chains)
REFIT_JAX_LOGO = {"unfilt.": (0.78, -441.2, -441.4), "U": (5.80, -5910.1, -6399.2),
                  "B": (1.82, -1878.3, -1883.3), "V": (2.46, -1667.2, -1694.9),
                  "g": (0.10, -830.2, -830.2), "r": (0.67, -767.4, -767.4),
                  "i": (0.50, -742.8, -742.8), "R": (0.32, -343.4, -343.4),
                  "I": (1.19, -425.5, -425.5)}
REFIT_ACC_TOL = 0.02        # a refit's acceptance on the card against the CPU's float64
REFIT_SPLIT = {"P2 (half-steps)": ("stretch_half_step_kernel<popsc2warpmodel",
                                   "stretch_half_step_latency_kernel<popsc2warpmodel"),
               "P3 (MAP ascent)": ("pop_map_kernel",),
               "P1 (initial state)": ("logpost_warp_kernel<popsc2warpmodel",
                                      "logpost_latency_kernel<popsc2warpmodel")}


def refit_calls(record):
    """A wrapper of the port's fit_population that ``information_criteria``
    reaches (``fitting._exact_cv_elpd`` imports it at each call): each
    call's arguments, results and launches (counted from the call's start)
    appended to ``record``. Returns (install, restore)."""
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.parallel import population
    original = population.fit_population

    def wrapped(models, lcs, priors, **kw):
        n0 = dict(kernels.LAUNCHES)
        out = original(models, lcs, priors, **kw)
        record.append({"models": models, "lcs": lcs, "priors": priors, "kw": kw, "flat": out[0],
                       "acc": out[1], "launches": {k: v - n0[k] for k, v in
                                                   kernels.LAUNCHES.items() if v != n0[k]}})
        return out

    def install():
        population.fit_population = wrapped

    def restore():
        population.fit_population = original
    return install, restore


def refit_cpu_repeat(call, model_cpu):
    """The leave-one-band-out refit's fit_population call again on the CPU in
    float64 (the same curves, box, options and seed) and its held-out scores;
    against the card's: each refit's acceptance within REFIT_ACC_TOL, every
    transient's parameter medians within 1 sigma of the CPU chain's and its
    widths' ratios in (0.6, 1.7) (ROADMAP's stage-1 criteria). Returns
    (acceptances, worst median gap in sigma, width ratios' range, seconds,
    the CPU's chains)."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    kw = dict(call["kw"], device="cpu")
    models = [model_cpu.clone_for(sub) for sub in call["lcs"]]
    t0 = time.perf_counter()
    try:
        config.set_compute_dtype(torch.float64)
        flat, acc = fit_population(models, call["lcs"], call["priors"], **kw)
    finally:
        config.set_compute_dtype(config.AUTO)
    seconds = time.perf_counter() - t0
    flat_gpu = np.asarray(call["flat"], float)
    if not np.all(np.abs(np.asarray(call["acc"]) - acc) <= REFIT_ACC_TOL):
        raise AssertionError(f"29: the leave-one-band-out refits' acceptances {call['acc']} on "
                             f"the card, {acc} on the CPU (within {REFIT_ACC_TOL})")
    med_c, med_g = np.median(flat, axis=1), np.median(flat_gpu, axis=1)
    sd_c, sd_g = np.std(flat, axis=1), np.std(flat_gpu, axis=1)
    gap = np.abs(med_g - med_c) / sd_c
    ratio = sd_g / sd_c
    if not (np.all(gap < 1.0) and np.all((ratio > 0.6) & (ratio < 1.7))):
        raise AssertionError(f"29: the refits' medians {gap.max():.3f} sigma apart (< 1), width "
                             f"ratios {ratio.min():.3f}-{ratio.max():.3f} (in (0.6, 1.7))")
    return acc, float(gap.max()), (float(ratio.min()), float(ratio.max())), seconds, flat


def phase_refit(smi, dev=None):
    """29: the exact-refit CV on the card. The flagship chain as
    tools/validate_logo_refit.py runs it (lightcurve_mcmc ShockCooling2, 128
    walkers x 1000 + 2000, init="map", seed 0), then
    information_criteria(group_by="filter", refit=True, priors=...) at
    _exact_cv_elpd's defaults, the counters reset just before it: one
    fit_population call for the flagged points (leave-one-point-out, 148
    points each) and one for the flagged bands (121-143), each launching P3
    once, P1 once and P2 2000 times in the forms their rules pick, nothing
    else; no refit failed, every pointwise value finite, elpd the sum of the
    pointwise values, the repaired and failed labels exactly the entries
    with pareto_k above 0.7 or NaN. The leave-one-band-out call repeated on
    the CPU in float64 (:func:`refit_cpu_repeat`) and its held-out scores
    beside the card's and VALIDATION.md's JAX values; the wall and a
    profiled repeat's busy time and idle share (``dev``: the card unless
    given). Returns the runs' launches {"29 LOPO": ..., "29 LOGO": ...}."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import fitting, kernels
    from lightcurve_fitting_tpu_torch.models import ShockCooling2
    dev = torch.device("cuda") if dev is None else dev
    lc = flagship_lc()
    model = ShockCooling2(lc, device=dev)
    priors = flagship_priors()
    t0 = time.perf_counter()
    chain = fitting.lightcurve_mcmc(lc, model, priors=priors, p_lo=REFIT_WINDOW[0],
                                    p_up=REFIT_WINDOW[1], quiet=True, device=dev, **REFIT_CHAIN)
    chain_s = time.perf_counter() - t0
    flat = chain.flatchain

    def ic():
        return fitting.information_criteria(lc, model, flat, group_by="filter", refit=True,
                                            priors=priors, seed=0, quiet=True, device=dev)
    record = []
    install, restore = refit_calls(record)
    install()
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ic()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = {k: v for k, v in kernels.LAUNCHES.items() if v}
        calls = list(record)
        wall_p, prof = profiled(ic, cpu=False)
    finally:
        restore()
    parts, busy = time_split(prof, wall_p, REFIT_SPLIT)
    lg = out["logo"]
    kinds = [("LOPO", out, "elpd_loo", np.arange(len(lc))), ("LOGO", lg, "elpd_logo",
                                                               np.asarray(lg["groups"]))]
    runs, lines, by_kind = {}, [], {}
    i = 0
    for kind, res, key, names in kinds:
        flagged = names[~(res["pareto_k"] <= 0.7)]
        got = list(res["refit"]["labels"]) + list(res["refit"]["failed_labels"]) \
            if "refit" in res else []
        if sorted(map(str, got)) != sorted(map(str, flagged)):
            raise AssertionError(f"29 {kind}: repaired {got} are not the flagged {flagged}")
        if not np.all(np.isfinite(res["pointwise"])) or not np.isclose(
                res[key], float(np.sum(res["pointwise"])), rtol=1e-12, atol=0):
            raise AssertionError(f"29 {kind}: pointwise values {res['pointwise']}, {key} "
                                 f"{res[key]}")
        if not len(flagged):
            continue
        if res["refit"]["n_failed"]:
            raise AssertionError(f"29 {kind}: {res['refit']['n_failed']} refits failed")
        S, N = len(calls[i]["lcs"]), max(len(sub) for sub in calls[i]["lcs"])
        launches, forms = pop_run_launches(f"29 {kind}", calls[i]["launches"], S, REFIT_WALKERS,
                                           N, REFIT_STEPS + REFIT_BURNIN, map_starts=POP_STARTS)
        runs[f"29 {kind}"] = launches
        by_kind[kind] = calls[i]
        lines.append(f"{kind}: {len(flagged)} flagged, S = {S} x {N} points, launches "
                     f"{ {k: v for k, v in launches.items() if v} } (forms {forms}), "
                     f"acceptance {fmt(res['refit']['acceptance'])}")
        i += 1
    if i != len(calls) or total != {k: sum(r.get(k, 0) for r in runs.values())
                                    for k in total}:
        raise AssertionError(f"29: {len(calls)} fit_population calls, launches {total}")
    cpu_line = "no band flagged: no leave-one-band-out refit to repeat on the CPU"
    if "LOGO" in by_kind:
        masks = [np.asarray(lc["filter"]) == g for g in lg["refit"]["labels"]]
        acc_c, gap, ratio, cpu_s, flat_c = refit_cpu_repeat(
            by_kind["LOGO"], ShockCooling2(lc, device="cpu"))
        elpd_c = fitting._held_out_elpd(lc, ShockCooling2(lc, device="cpu"), flat_c, masks,
                                        False, "relative", 1024, 0, device="cpu")
        rows = []
        for j, g in enumerate(lg["refit"]["labels"]):
            k = float(lg["pareto_k"][list(map(str, lg["groups"])).index(str(g))])
            jax = REFIT_JAX_LOGO.get(str(g))
            rows.append(f"{g}: k {k:.2f}, PSIS {lg['refit']['elpd_psis'][j]:.1f}, exact "
                        f"{lg['refit']['elpd_exact'][j]:.1f} (CPU float64 {elpd_c[j]:.1f}; JAX "
                        + (f"k {jax[0]:.2f}, PSIS {jax[1]:.1f}, exact {jax[2]:.1f}"
                           if jax else "-") + ")")
        cpu_line = (f"the leave-one-band-out call again on the CPU in float64 ({cpu_s:.1f} s): "
                    f"acceptances {fmt(acc_c)} (card within {REFIT_ACC_TOL}), medians within "
                    f"{gap:.3f} sigma (< 1), width ratios {ratio[0]:.3f}-{ratio[1]:.3f} (in "
                    f"(0.6, 1.7)); by band " + "; ".join(rows))
    phase("exact-refit CV 29", f"the flagship chain (lightcurve_mcmc 128 x 1000 + 2000, "
          f"init=\"map\", seed 0) in {chain_s:.2f} s; information_criteria(group_by=\"filter\", "
          f"refit=True) at {REFIT_WALKERS} walkers x {REFIT_BURNIN} + {REFIT_STEPS}: elpd_loo "
          f"{out['elpd_loo']:.1f} +- {out['se_elpd_loo']:.1f}, elpd_logo {lg['elpd_logo']:.1f} "
          f"+- {lg['se_elpd_logo']:.1f}; " + "; ".join(lines) + f"; {cpu_line}; wall "
          f"{wall:.3f} s (on {smi}); profiled repeat {wall_p:.3f} s, device busy {busy:.4f} s "
          f"(idle share {1 - busy / wall_p:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))
    return runs


# ---------------------------------------- simulation-based calibration (30)

# examples/calibration_check.py's SBC at its full size: ShockCooling2, these
# priors (t_exp the fourth), 5 epochs x 4 bands, 32 walkers x 400 + 600 steps
SBC_PRIORS = [(8.0, 20.0), (1.0, 4.0), (25.0, 50.0), (-1.0, 1.0)]
SBC_SIMS, SBC_RANKS, SBC_WALKERS, SBC_BURNIN, SBC_STEPS, SBC_SEED = 128, 63, 32, 400, 600, 3
SBC_EPOCHS, SBC_BANDS = 5, ("g", "r", "i", "B")
# the JAX package's run of the same call, float64 on the CPU: (mean
# acceptance, least acceptance, p-values); PYTHONPATH=. python tests/test_torch_sbc.py
SBC_REF = (0.5522513834635417, 0.51625,
           (0.22528702361367522, 0.304140404581717, 0.621600913232516, 0.06096785784181019))
SBC_ACC_TOL = 0.01
SBC_P_MIN = 0.01            # the JAX verdict "consistent with calibrated inference"


def phase_sbc(smi):
    """30: examples/calibration_check.py's simulation-based calibration at
    its full size through the public ``simulation_based_calibration``
    (SBC_PRIORS, 128 simulations of linspace(1, 8, 5) x g, r, i, B, n_ranks
    63, 32 walkers x 400 + 600 steps, init="map", seed 3), the counters
    reset before it: P3 once, P1 once, P2 twice a step, each in its rule's
    form, nothing else; the mean acceptance within SBC_ACC_TOL of the JAX
    package's float64 CPU run of the same call (SBC_REF) and the smallest
    p-value above 0.01 (the JAX verdict "consistent with calibrated
    inference"); the p-values, the wall and a profiled repeat's busy time by
    kernel and idle share. Returns the run's launches."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.models import ShockCooling2, UniformPrior
    from lightcurve_fitting_tpu_torch.parallel import simulation_based_calibration
    priors = [UniformPrior(*b) for b in SBC_PRIORS]

    def run():
        return simulation_based_calibration(
            ShockCooling2(), priors, times=np.linspace(1.0, 8.0, SBC_EPOCHS),
            filters=list(SBC_BANDS), n_sims=SBC_SIMS, n_ranks=SBC_RANKS, nwalkers=SBC_WALKERS,
            nsteps=SBC_STEPS, nsteps_burnin=SBC_BURNIN, init="map", seed=SBC_SEED, quiet=True)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, forms = pop_run_launches("30", dict(kernels.LAUNCHES), SBC_SIMS, SBC_WALKERS,
                                       SBC_EPOCHS * len(SBC_BANDS), SBC_BURNIN + SBC_STEPS,
                                       map_starts=POP_STARTS)
    acc, pv, ranks = np.asarray(res["acceptance"]), np.asarray(res["p_values"]), res["ranks"]
    mean_acc = float(np.mean(acc))
    if ranks.shape != (SBC_SIMS, len(SBC_PRIORS)) or ranks.min() < 0 \
            or ranks.max() > SBC_RANKS or not np.isfinite(acc).all():
        raise AssertionError(f"30: ranks {ranks.shape} in [{ranks.min()}, {ranks.max()}], "
                             f"acceptance {acc}")
    if abs(mean_acc - SBC_REF[0]) > SBC_ACC_TOL or not float(pv.min()) > SBC_P_MIN:
        raise AssertionError(f"30: mean acceptance {mean_acc:.4f} (JAX float64 CPU "
                             f"{SBC_REF[0]:.4f} +- {SBC_ACC_TOL}), p-values {pv} (each > "
                             f"{SBC_P_MIN})")
    wall_p, prof = profiled(run, cpu=False)
    parts, busy = time_split(prof, wall_p, POP_SPLIT)
    phase("SBC 30", f"simulation_based_calibration ShockCooling2, {SBC_SIMS} simulations x "
          f"{SBC_EPOCHS * len(SBC_BANDS)} points, {SBC_WALKERS} walkers x {SBC_BURNIN} + "
          f"{SBC_STEPS}, init=\"map\", seed {SBC_SEED}: p-values {fmt(pv)} (JAX float64 CPU "
          f"{fmt(SBC_REF[2])}; each > {SBC_P_MIN}); mean acceptance {mean_acc:.4f} (JAX "
          f"{SBC_REF[0]:.4f} +- {SBC_ACC_TOL}), least {acc.min():.4f} (JAX {SBC_REF[1]:.4f}); "
          f"launches {launches} (forms {forms}); {wall:.3f} s end to end (the simulations on "
          f"the host included; on {smi}); profiled repeat {wall_p:.3f} s, device busy "
          f"{busy:.4f} s (idle share {1 - busy / wall_p:.3f}): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))
    return launches


# ------------------------------------ the SW17 and MSW23 populations (31)

# the surveys of tests/test_torch_population.py::sc_example_population:
# examples/fit_population.py's generator (default_rng(0); U, B, V, g, r, i;
# 4-7 epochs over days 1-8; 5% errors) with each truth (v_s*, M_env, f_rho M,
# R) drawn uniformly from this box, where both classes' curves are finite and
# positive over those days (t_exp = 0, so n_model = 4);
# examples/compare_models.py's priors and window without t_0
SC_POP_BOX = ([1.0, 1.0, 0.5, 1.0], [5.0, 10.0, 5.0, 10.0])
SC_POP_LO, SC_POP_UP = [0.5, 0.5, 0.1, 0.1], [10.0, 20.0, 10.0, 20.0]
SC_POP_S = 64
SC_POP_SMALL = 4            # a launch whose rules take the latency forms
SC_POP_COUNT = {"ShockCooling": "pop_sc", "ShockCooling4": "pop_sc4"}
# the JAX package's fit of each survey at the example's 64 walkers x 100 +
# 500 steps from the window (init="window"), seed 1, float64 on the CPU:
# (mean acceptance, its standard error over the transients, the least);
# PYTHONPATH=. python tests/test_torch_population.py ShockCooling 64 (and
# ShockCooling4)
SC_POP_REF = {"ShockCooling": (0.17981396484375, 0.004217867294352526, 0.1239375),
              "ShockCooling4": (0.17646728515625, 0.004403688592196407, 0.10228125)}
SC_POP_SPLIT = {"P2 (half-steps)": tuple(f"{k}<{m}" for k in ("stretch_half_step_kernel",
                                                                "stretch_half_step_latency_kernel")
                                         for m in ("popscwarpmodel", "popsc4warpmodel")),
                "P1 (initial state)": tuple(f"{k}<{m}" for k in ("logpost_warp_kernel",
                                                                  "logpost_latency_kernel")
                                            for m in ("popscwarpmodel", "popsc4warpmodel")),
                "K5 (summaries)": ("percentile",)}


def sc_pop_example(name, S, dev, mjd=False):
    """The SW17 (``name`` "ShockCooling") or MSW23 ("ShockCooling4") survey of
    S transients described above, through the port: (lcs, models, truths).
    ``mjd``: the times at MJD scale (t_exp = 58000, the fifth parameter
    under POP_MJD_PRIOR), as :func:`pop_example`'s."""
    import numpy as np
    from lightcurve_fitting_tpu_torch import models as tmodels
    from lightcurve_fitting_tpu_torch.filters import filtdict
    from lightcurve_fitting_tpu_torch.lightcurve import LC
    Model = getattr(tmodels, name)
    rng = np.random.default_rng(0)
    filters = [filtdict[n] for n in ["U", "B", "V", "g", "r", "i"]]
    t0 = 58000.0 if mjd else 0.0
    lcs, models, truths = [], [], []
    for _ in range(S):
        truth = rng.uniform(*SC_POP_BOX)
        truths.append(truth)
        n_epochs = rng.integers(4, 8)
        t = t0 + np.repeat(np.linspace(1.0, 8.0, n_epochs), len(filters))
        f = np.array(filters * n_epochs)
        y_true = Model()(t, f, *truth, t0)
        dy = 0.05 * y_true
        lc = LC([t, f, y_true + rng.normal(scale=dy), dy], names=["MJD", "filter", "lum", "dlum"])
        lcs.append(lc)
        models.append(Model(lc, device=dev))
    return lcs, models, np.array(truths)


def sc_pop_priors(mjd=False, sigma=False):
    from lightcurve_fitting_tpu_torch.models import LogUniformPrior, UniformPrior
    priors = ([UniformPrior(0.1, 20.0), UniformPrior(0.1, 30.0), LogUniformPrior(0.01, 100.0),
               UniformPrior(0.01, 50.0)] + [UniformPrior(*POP_MJD_PRIOR)] * mjd
              + [UniformPrior(*POP_SIGMA_PRIOR)] * sigma)
    lo = SC_POP_LO + [POP_MJD_LO] * mjd + [POP_SIGMA_LO] * sigma
    up = SC_POP_UP + [POP_MJD_UP] * mjd + [POP_SIGMA_UP] * sigma
    return priors, lo, up


# the exact-refit CV's widths of P1 and P2 over SW17 and MSW23 in 31, 32's
# refits of SN 2016bkv: the curve without one of these bands (4 transients
# of 121-143 points; P1's latency form, P2's warp form) and without one
# point (149 transients of 148 points; the warp forms), 64 walkers, t_exp
# fitted (ndim 5), or and the intrinsic scatter (6)
SC_REFIT_BANDS = ("U", "B", "g", "I")
SC_REFIT_KINDS = ("LOGO", "LOPO")


def sc_refit_population(name, kind, dev):
    """SN 2016bkv's early curve (:func:`flagship_lc`) cut as 32's refits cut
    it, ``kind`` "LOGO" (without each band of SC_REFIT_BANDS) or "LOPO"
    (without each point), through the port: (lcs, models), the models the
    full curve's model cloned for each cut, as ``fitting._exact_cv_elpd``
    builds them."""
    import numpy as np
    lc = flagship_lc()
    if kind == "LOGO":
        bands = np.array([f.name for f in lc["filter"]])
        lcs = [lc[bands != b] for b in SC_REFIT_BANDS]
    else:
        lcs = [lc[np.arange(len(lc)) != i] for i in range(len(lc))]
    model = sc_model(name, lc, device=dev)
    return lcs, [model.clone_for(sub) for sub in lcs]


def pop_sc_refit_checks(seed, device_ms):
    """31 at the exact-refit CV's widths (:func:`sc_refit_population`, 64
    walkers, t_exp fitted and without and with the intrinsic scatter, float32
    and float64 compute): P1's two forms bit for bit and within 1e-5
    (1e-12) of the term scale of the plain version, the same -inf sets, and
    on :func:`pop_poisoned`'s copy each form's -inf set the plain
    version's; P2 as K2 against its plain version (h = 0, 1) and P1 at the
    states P2 accepted P2's stored bits, P2 in the rule's form (the warp
    form: the latency form takes at most 128 points); in float32 without
    the scatter the device time of P1 in each form, of its plain version
    (events), of P2's warp form (one half-step with the chain slot) and
    the bound. Returns (the line, the largest float32 |d| of P1 and P2,
    {(name, kind): {"S": S, "n": points, "warp": ms, "latency": ms,
    "plain": ms, "p2_warp": ms, "bound_ms": ms}})."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import common
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.models import UniformPrior
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    dev = torch.device("cuda")
    parts, times, errs = [], {}, {"P1": 0.0, "P2": 0.0}
    for name in SC_NAMES:
        for kind in SC_REFIT_KINDS:
            lcs, models = sc_refit_population(name, kind, dev)
            S, n = len(lcs), max(len(sub) for sub in lcs)
            for label in ("f32", "f64"):
                try:
                    if label == "f64":
                        config.set_compute_dtype(torch.float64)
                    rel = 1e-5 if label == "f32" else 1e-12
                    worst, msg = [0.0, 0.0], []
                    for sigma in (False, True):
                        priors = sc_priors() + [UniformPrior(*POP_SIGMA_PRIOR)] * sigma
                        lo, up = SC_LO + [POP_SIGMA_LO] * sigma, SC_UP + [POP_SIGMA_UP] * sigma
                        what = f"31 {name} {kind} {S} x {POP_WALKERS} at {n} points {label} " \
                               f"ndim {len(lo)}"
                        pp = PopulationPosterior(pack_population(models, lcs, sigma, dev),
                                                 models[0], priors, sigma)
                        q, off, sc = pop_state(pp, lo, up, POP_WALKERS, seed, dev)
                        got = pop_check_p1_forms(what, pp, off, sc, q)
                        d1 = compare_ll(f"P1 {what}", got.flatten(),
                                        kpop.log_posterior_plain(pp, q, off, sc).flatten(), rel,
                                        scale=pp.term_scales(common.absolute_params(q, off, sc))
                                        .flatten())
                        bad, rows = pop_poisoned(pp, every=2)
                        want_bad = torch.isneginf(kpop.log_posterior_plain(bad, q, off, sc))
                        for form in POP_FORMS["pop_logpost"]:
                            got_bad = torch.isneginf(kpop.log_posterior(bad, q, off, sc,
                                                                        form=form))
                            if not torch.equal(got_bad, want_bad) or not bool(
                                    got_bad[rows.to(dev)].all()):
                                raise AssertionError(f"{what}: P1's -inf set on the poisoned "
                                                     f"copy ({form} form) is not the plain "
                                                     "version's")
                        x0 = q.reshape(S, 2, POP_WALKERS // 2, -1).contiguous()
                        rep = pop_p1_repeats_p2(pp, off, sc, x0, seed + 1)
                        if rep[0]:
                            raise AssertionError(f"P1 {what}: {rep[0]} values at states P2 "
                                                 "accepted differ from P2's stored ones")
                        t2 = pop_check_half_step(f"P2 {what}", pp, off, sc, x0, seed + 2, rel)
                        worst = [max(worst[0], d1[1]), max(worst[1], t2[2])]
                        if label == "f32":
                            errs["P1"] = max(errs["P1"], d1[0])
                            errs["P2"] = max(errs["P2"], t2[2])
                        msg.append(f"ndim {len(lo)} P2 {t2[0]} near-ties, {t2[1]} accepts, "
                                   f"{rep[1]} moves")
                        if label == "f32" and not sigma:
                            times[(name, kind)] = pop_refit_times(pp, q, off, sc, seed,
                                                                  device_ms)
                    parts.append(
                        f"{name} {kind} {S} x {POP_WALKERS} at {n} points {label} (rules: P1 "
                        f"{kpop.logpost_form(S, POP_WALKERS, n, pop_sms())}, P2 "
                        f"{kpop.half_form(S, POP_WALKERS // 2, n, pop_sms())}): P1's forms "
                        f"bit-equal, max |d|/scale {worst[0]:.3e} (<= {rel:.0e}), -inf kept; "
                        f"P2 max |d logp| {worst[1]:.3e}, P1 at P2's states its bits; "
                        + ", ".join(msg))
                finally:
                    config.set_compute_dtype(config.AUTO)
    line = ("at the exact-refit CV's widths: " + "; ".join(parts) + "; device ms (f32, ndim 5) "
            + "; ".join(f"{c} {k} {t['S']} x {POP_WALKERS} at {t['n']}: P1 warp {t['warp']:.4f}, "
                        f"latency {t['latency']:.4f}, plain {t['plain']:.4f}, bound "
                        f"{t['bound_ms']:.5f}; P2 warp form {t['p2_warp']:.4f}, bound "
                        f"{t['p2_bound_ms']:.5f}"
                        for (c, k), t in times.items()))
    return line, errs, times


def pop_refit_times(pp, q, off, sc, seed, device_ms):
    """At the exact-refit CV's widths (27, 31), float32 compute, the states q
    (S, POP_WALKERS, ndim): the device time of P1 in each form, of its plain
    version (events) and of P2's warp form (one half-step with the chain
    slot: P2's latency form takes at most 128 points), and the bounds of P1
    and P2: {"warp", "latency", "plain", "p2_warp", "bound_ms",
    "p2_bound_ms", "S", "n"}."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    dev = q.device
    S = q.shape[0]
    x0 = q.reshape(S, 2, POP_WALKERS // 2, -1).contiguous()
    logp = kpop.log_posterior(pp, q, off, sc).reshape(S, 2, POP_WALKERS // 2)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (S, 2, POP_WALKERS // 2)
    u_z = torch.rand(shape, generator=g, device=dev)
    j = torch.randint(0, POP_WALKERS // 2, shape, generator=g, device=dev)
    u_acc = torch.rand(shape, generator=g, device=dev)
    acc = torch.zeros(shape, dtype=torch.int32, device=dev)
    x, cx = x0.clone(), torch.empty_like(x0)
    cl = torch.empty(shape, dtype=torch.float64, device=dev)

    def p2():
        kpop.stretch_half_step(pp, x, logp, 0, u_z, j, u_acc, 2.0, off, sc, cx, cl, acc,
                               check_partners=False, form="warp")
    t = {f: float(np.nanmedian(device_ms(
        lambda f=f: kpop.log_posterior(pp, q, off, sc, form=f), "logpost_", 10, 3)))
        for f in POP_FORMS["pop_logpost"]}
    t["plain"] = cuda_ms(lambda: kpop.log_posterior_plain(pp, q, off, sc), repeats=3)
    t["p2_warp"] = float(np.nanmedian(device_ms(p2, "stretch_half_step", 10, 3)))
    t["bound_ms"] = bound(POP_WALKERS * pop_points(pp) * pop_eval_ops(pp),
                          q.numel() * 4 + pop_table_bytes(pp) + S * POP_WALKERS * 8)[0]
    half, ndim = POP_WALKERS // 2, q.shape[-1]
    t["p2_bound_ms"] = bound(half * pop_points(pp) * pop_eval_ops(pp) + S * half * PROPOSAL,
                             S * POP_WALKERS * ndim * 4 + S * half * ndim * 4 * 2
                             + S * half * (4 + 8 + 4 + 8 + 8 + 4 * 2) + pop_table_bytes(pp))[0]
    t["S"], t["n"] = S, int(pp.bb_coeffs.shape[1])
    return t


def phase_pop_sc_kernels(seed=31):
    """31 (kernels): P1 and P2 over ShockCooling and ShockCooling4
    (``kernels/csrc/pop_sc.cu``) against their plain versions on the card,
    as 27 holds them over ShockCooling2: each class's survey at S = 64 (four
    parameters), its MJD-scale twin (t_exp the fifth), S = 64 with the
    intrinsic scatter, and S = SC_POP_SMALL (the launch the rules take the
    latency forms at) with t_exp and the scatter (ndim 6), float32 and float64
    compute, 64 walkers in the rescaled float32 state: P1 within 1e-5
    (1e-12) of the term scale, same -inf sets, P2's stored values at the
    states it accepted P1's bit for bit, P2 as K2 (h = 0, 1), P1's and P2's
    warp and latency forms bit for bit (:func:`pop_check_forms`), and at S =
    64 the copy with a +inf model value at each poisoned transient's last
    real point (-inf kept, :func:`pop_check_poisoned`); each timed at S =
    64 in float32 (events, the profiler's device time, each form, the plain
    version, the bound); the same checks at 32's widths
    (:func:`pop_sc_refit_checks`); ptxas's report of their 96 instantiations
    without a spill. Returns {"P1": ..., "P2": ...} for the kernels line."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import build, common
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    from time_port_kernels import device_ms, ptxas_report
    dev = torch.device("cuda")
    cases = [("S64", SC_POP_S, False, False), ("S64 MJD t_exp", SC_POP_S, True, False),
             ("S64 sigma", SC_POP_S, False, True),
             (f"S{SC_POP_SMALL} MJD t_exp sigma", SC_POP_SMALL, True, True)]
    lines, times, errs = [], {}, {"P1": 0.0, "P2": 0.0}
    for name in SC_NAMES:
        pops = {(S, mjd): sc_pop_example(name, S, dev, mjd) for _, S, mjd, _ in cases}
        for label in ("f32", "f64"):
            try:
                if label == "f64":
                    config.set_compute_dtype(torch.float64)
                rel = 1e-5 if label == "f32" else 1e-12
                for case, S, mjd, sigma in cases:
                    what = f"31 {name} {label} {case}"
                    lcs, models, _ = pops[(S, mjd)]
                    priors, lo, up = sc_pop_priors(mjd, sigma)
                    pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                             priors, sigma)
                    q, off, sc = pop_state(pp, lo, up, POP_WALKERS, seed, dev)
                    p_abs = common.absolute_params(q, off, sc)
                    d1 = compare_ll(f"P1 {what}", kpop.log_posterior(pp, q, off, sc).flatten(),
                                    kpop.log_posterior_plain(pp, q, off, sc).flatten(), rel,
                                    scale=pp.term_scales(p_abs).flatten())
                    x0 = q.reshape(S, 2, POP_WALKERS // 2, -1).contiguous()
                    rep = pop_p1_repeats_p2(pp, off, sc, x0, seed + 1)
                    if rep[0]:
                        raise AssertionError(f"P1 {what}: {rep[0]} values at states P2 accepted "
                                             "differ from P2's stored ones")
                    t2 = pop_check_half_step(f"P2 {what}", pp, off, sc, x0, seed + 2, rel)
                    acc, _ = pop_check_forms(what, pp, off, sc, x0, None, None, seed + 3)
                    msg = (f"{name} {label} {case}: P1 max |d| {d1[0]:.3e} (<= {rel:.0e} of the "
                           f"term scale), at the states P2 accepted {rep[0]} of "
                           f"{S * POP_WALKERS} differ ({rep[1]} moves); P2 {t2[0]} near-ties, "
                           f"{t2[1]} accepts, max |d logp| {t2[2]:.3e}; forms bit for bit "
                           f"({acc} accepts)")
                    if S == SC_POP_S and not mjd and not sigma:
                        n_inf = pop_check_poisoned(f"{what} poisoned", pp, off, sc, q, seed + 4)
                        msg += f", poisoned: {n_inf} -inf log-posteriors kept"
                        if label == "f32":
                            times[name] = pop_times(pp, q, off, sc, x0, None, None, None,
                                                    device_ms)
                    if label == "f32":
                        errs["P1"] = max(errs["P1"], d1[0])
                        errs["P2"] = max(errs["P2"], t2[2])
                    lines.append(msg)
            finally:
                config.set_compute_dtype(config.AUTO)
    refit_line, refit_errs, refit_times = pop_sc_refit_checks(seed + 5, device_ms)
    lines.append(refit_line)
    errs = {k: max(v, refit_errs[k]) for k, v in errs.items()}
    report = ptxas_report(build.build_info()["log"])
    regs = {}
    for policy in ("PopSCWarpModel", "PopSC4WarpModel"):
        for what, key in (("P1 warp", "logpost_warp_kernel"),
                          ("P1 latency", "logpost_latency_kernel"),
                          ("P2 warp", "stretch_half_step_kernel"),
                          ("P2 latency", "stretch_half_step_latency_kernel")):
            ks = {k: v for k, v in report.items() if key + "I" in k and policy + "I" in k}
            if len(ks) != 12 or any(v[2] or v[3] for v in ks.values()):
                raise AssertionError(f"31: {what} over {policy} (12 instantiations) must not "
                                     f"spill: {ks}")
            regs[f"{what} {policy}"] = (sorted({v[0] for v in ks.values()}),
                                        sorted({v[1] for v in ks.values()}),
                                        sorted({v[2] + v[3] for v in ks.values()}))
    phase("SW17 and MSW23 population kernels 31", "; ".join(lines) + "; S = 64, f32: " + "; ".join(
        f"{n}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (device {v['dev']:.4f}; by form "
            + ", ".join(f"{f} {ms:.4f}" for f, ms in v["forms"].items())
            + f"; plain {v['plain_ms']:.4f}; bound {v['bound_ms']:.5f}, {v['bound_by']})"
            for k, v in t.items()) for n, t in times.items())
          + f"; ptxas (registers, stack frames, spill bytes) by kernel over its 12 "
          f"instantiations: {regs}")
    first = times[SC_NAMES[0]]
    return {k: {"max_abs_err": errs[k], "ms": first[k]["ms"], "plain_ms": first[k]["plain_ms"],
                **{f: first[k][f] for f in ("bound_ms", "bound_by", "library_ms")},
                "at": {n: (t[k]["ms"], t[k]["dev"], t[k]["plain_ms"], t[k]["bound_ms"])
                       for n, t in times.items()},
                "forms": {n: t[k]["forms"] for n, t in times.items()},
                "refit": refit_times} for k in errs}


def phase_pop_sc_main_path(smi):
    """31 (fits): ``fit_population`` over each class's survey of SC_POP_S
    transients at examples/fit_population.py's 64 walkers x 100 + 500 steps
    from the window (init="window"), seed 1, summaries on the card, no
    chains, the counters reset before each: P1 once, P2 twice a step in the
    forms the rules pick, K5, nothing else; finite summaries; the mean
    acceptance within POP_ACC_TOL of the JAX package's float64 CPU run of
    the same call (SC_POP_REF); the wall and a profiled repeat's busy time
    and idle share. Returns each run's launches."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import kernels
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    dev = torch.device("cuda")
    runs = {}
    for name in SC_NAMES:
        lcs, models, _ = sc_pop_example(name, SC_POP_S, dev)
        priors = sc_pop_priors()[0]

        def fit():
            return fit_population(models, lcs, priors, p_lo=SC_POP_LO, p_up=SC_POP_UP,
                                  nwalkers=POP_WALKERS, nsteps=POP_STEPS,
                                  nsteps_burnin=POP_BURNIN, seed=1, init="window",
                                  summaries=True, return_chains=False)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat, acc, summ = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, forms = pop_run_launches(
            f"31 {name}", dict(kernels.LAUNCHES), SC_POP_S, POP_WALKERS,
            max(len(lc) for lc in lcs), POP_BURNIN + POP_STEPS, SC_POP_COUNT[name],
            others=("percentile",))
        if flat is not None or summ.shape != (SC_POP_S, 4, 3) or not np.isfinite(summ).all() \
                or not np.isfinite(acc).all():
            raise AssertionError(f"31 {name}: bad outputs")
        ref = SC_POP_REF[name]
        mean_acc = float(np.mean(acc))
        if abs(mean_acc - ref[0]) > POP_ACC_TOL:
            raise AssertionError(f"31 {name}: mean acceptance {mean_acc:.4f} (JAX float64 CPU "
                                 f"{ref[0]:.4f} +- {POP_ACC_TOL})")
        wall_p, prof = profiled(fit, cpu=False)
        parts, busy = time_split(prof, wall_p, SC_POP_SPLIT)
        runs[f"31 {name}"] = launches
        phase(f"SW17 and MSW23 populations 31 {name}",
              f"fit_population S = {SC_POP_S}, {POP_WALKERS} walkers x {POP_BURNIN} + "
              f"{POP_STEPS} steps, init=\"window\", summaries, no chains: {wall:.3f} s end to end "
              f"(on {smi}); launches {launches} (forms {forms}); mean acceptance {mean_acc:.4f} "
              f"(JAX float64 CPU {ref[0]:.4f} +- {POP_ACC_TOL}), least {acc.min():.3f} (JAX "
              f"{ref[2]:.3f}); profiled repeat {wall_p:.3f} s, device busy {busy:.4f} s (idle "
              f"share {1 - busy / wall_p:.3f}): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items()))
    return runs


# -------------------------------- the exact-refit CV over SW17 and MSW23 (32)

# 32 holds, for each model, the mean over its pooled refits (every
# leave-one-band-out refit and REFIT_SC_SUBSET leave-one-point-out ones,
# evenly spaced) of the card's acceptance less that of the same refits run
# again on the CPU in float64, within 4 standard errors. One refit's
# acceptance moves with the seed alone by REFIT_SC_SD, on either side: the
# standard deviation over seeds 0-5 pooled over 16 (SW17) and 22 (MSW23)
# such refits, float64 on the CPU, in the box of 26c's chain drawn on the
# CPU (python3 tools/probe_refit_spread.py --device cpu --cpu-seeds 6; the
# card's own spread at the card chain's box: the same tool on the H100,
# PERF.md section 6, PR 28)
REFIT_SC_SUBSET = 16
REFIT_SC_SD = {"ShockCooling": 0.0297, "ShockCooling4": 0.0424}


def refit_sc_limit(name, n):
    """4 standard errors of the mean of n paired card-less-CPU acceptances."""
    import math
    return 4.0 * math.sqrt(2.0 / n) * REFIT_SC_SD[name]


def refit_sc_pool(calls):
    """32's pooled refits of one model from its refit calls ({"LOPO": call,
    "LOGO": call}, either may be missing): every leave-one-band-out refit and
    REFIT_SC_SUBSET leave-one-point-out ones, evenly spaced. Returns (lcs,
    the card's acceptances, the card's chains, the labels)."""
    import numpy as np
    lcs, acc, flat, labels = [], [], [], []
    for kind in ("LOGO", "LOPO"):
        if kind not in calls:
            continue
        call = calls[kind]
        S = len(call["lcs"])
        idx = range(S) if kind == "LOGO" else np.unique(
            np.linspace(0, S - 1, min(S, REFIT_SC_SUBSET)).round().astype(int))
        for i in idx:
            lcs.append(call["lcs"][i])
            acc.append(float(call["acc"][i]))
            flat.append(np.asarray(call["flat"][i], float))
            labels.append(f"{kind} {i}")
    return lcs, np.array(acc), np.array(flat), labels


def refit_sc_cpu(calls, model_cpu, seed=None):
    """:func:`refit_sc_pool`'s refits again on the CPU in float64, in one
    fit_population call with the refit calls' box and options (and their
    seed, unless ``seed``). Returns (the CPU's acceptances, its chains,
    seconds)."""
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    call = next(iter(calls.values()))
    lcs = refit_sc_pool(calls)[0]
    kw = dict(call["kw"], device="cpu")
    if seed is not None:
        kw["seed"] = seed
    t0 = time.perf_counter()
    try:
        config.set_compute_dtype(torch.float64)
        flat, acc = fit_population([model_cpu.clone_for(sub) for sub in lcs], lcs,
                                   call["priors"], **kw)
    finally:
        config.set_compute_dtype(config.AUTO)
    return acc, flat, time.perf_counter() - t0


def refit_sc_check(name, calls, model_cpu):
    """32's held statistic for one model (see REFIT_SC_SD): the mean of the
    card's acceptance less the CPU's over the pooled refits within
    :func:`refit_sc_limit`; the medians' gaps in the CPU's sigma and the
    widths' ratios reported (26c's chains have not converged). Returns the
    line."""
    import numpy as np
    _, acc_g, flat_g, labels = refit_sc_pool(calls)
    acc_c, flat_c, seconds = refit_sc_cpu(calls, model_cpu)
    d = acc_g - acc_c
    limit = refit_sc_limit(name, len(d))
    if not abs(float(d.mean())) <= limit:
        raise AssertionError(f"32 {name}: the card's acceptance less the CPU's float64 run's, "
                             f"mean over {len(d)} refits {float(d.mean()):.4f} (within {limit:.4f})"
                             f"; card {acc_g}, CPU {acc_c}")
    sd_c = np.std(flat_c, axis=1)
    gap = np.abs(np.median(flat_g, axis=1) - np.median(flat_c, axis=1)) / sd_c
    ratio = np.std(flat_g, axis=1) / sd_c
    return (f"{len(d)} refits ({', '.join(labels)}) again on the CPU in float64 ({seconds:.1f} s):"
            f" acceptances {fmt(acc_c)}, the card's less the CPU's mean {float(d.mean()):.4f} "
            f"(within {limit:.4f}), each within {float(np.abs(d).max()):.4f}; medians within "
            f"{float(gap.max()):.3f} sigma, width ratios {float(ratio.min()):.3f}-"
            f"{float(ratio.max()):.3f} (reported)")


def phase_refit_sc(smi):
    """32: 26c's ``compare_models_loo`` (SW17 against MSW23 on SN 2016bkv, 64
    walkers x 500 + 500, seed 7) with ``refit=True``,
    ``refit_options={"init": "window"}`` (P3 over these classes waits for
    item 22) and ``group_by="filter"``, the counters reset before it: each
    model's refits one fit_population call for its flagged points and one
    for its flagged bands, each P1 once and P2 twice a step over the model's
    policy in its rules' forms, no P3; every pointwise value finite, elpd
    their sum, the repaired and failed labels exactly the flagged entries;
    each model's pooled refits again on the CPU in float64, the mean of the
    card's acceptance less the CPU's within 4 standard errors
    (:func:`refit_sc_check`); the wall. Returns the refit calls'
    launches."""
    import numpy as np
    import torch
    from lightcurve_fitting_tpu_torch import fitting, kernels
    lc = flagship_lc()
    dev = torch.device("cuda")
    record = []
    install, restore = refit_calls(record)
    install()
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = hushed(fitting.compare_models_loo, lc, [sc_model(n, lc) for n in SC_NAMES],
                       sc_priors(), p_lo=SC_LO, p_up=SC_UP, labels=list(SC_NAMES), nwalkers=64,
                       nsteps=500, nsteps_burnin=500, seed=7, refit=True,
                       refit_options={"init": "window"}, group_by="filter", quiet=True,
                       device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    calls = iter(record)
    runs, lines = {}, []
    for name in SC_NAMES:
        by_kind = {}
        ic = table.meta["ics"][name]
        lg = ic["logo"]
        for kind, res, key, labels in (("LOPO", ic, "elpd_loo", np.arange(len(lc))),
                                       ("LOGO", lg, "elpd_logo", np.asarray(lg["groups"]))):
            flagged = labels[~(res["pareto_k"] <= 0.7)]
            got = list(res["refit"]["labels"]) + list(res["refit"]["failed_labels"]) \
                if "refit" in res else []
            if sorted(map(str, got)) != sorted(map(str, flagged)):
                raise AssertionError(f"32 {name} {kind}: repaired {got} are not the flagged "
                                     f"{flagged}")
            if not np.all(np.isfinite(res["pointwise"])) or not np.isclose(
                    res[key], float(np.sum(res["pointwise"])), rtol=1e-12, atol=0):
                raise AssertionError(f"32 {name} {kind}: pointwise {res['pointwise']}, {key} "
                                     f"{res[key]}")
            if not len(flagged):
                continue
            call = next(calls)
            S, N = len(call["lcs"]), max(len(sub) for sub in call["lcs"])
            if type(call["models"][0]).__name__ != name or S != len(flagged):
                raise AssertionError(f"32 {name} {kind}: a refit call of {S} "
                                     f"{type(call['models'][0]).__name__} curves")
            launches, forms = pop_run_launches(f"32 {name} {kind}", call["launches"], S,
                                               REFIT_WALKERS, N, REFIT_STEPS + REFIT_BURNIN,
                                               SC_POP_COUNT[name])
            runs[f"32 {name} {kind}"] = launches
            by_kind[kind] = call
            lines.append(f"{name} {kind}: {len(flagged)} flagged, {res['refit']['n_failed']} "
                         f"failed, S = {S} x {N} points, forms {forms}, acceptance "
                         f"{fmt(res['refit']['acceptance'])}")
        if not by_kind:
            raise AssertionError(f"32 {name}: no refit")
        lines.append(f"{name}: " + refit_sc_check(name, by_kind,
                                                  sc_model(name, lc, device="cpu")))
    if next(calls, None) is not None:
        raise AssertionError(f"32: {len(record)} fit_population calls")
    ranking = [str(m) for m in table["model"]]
    phase("exact-refit CV over SW17 and MSW23 32", f"compare_models_loo 64 walkers x 500 + 500, "
          f"seed 7, refit=True, init=\"window\", group_by=\"filter\": ranking {ranking}, elpd_loo "
          + ", ".join(f"{m} {float(e):.1f}" for m, e in zip(table["model"], table["elpd_loo"]))
          + "; " + "; ".join(lines) + f"; {wall:.3f} s (on {smi})")
    return runs


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
                         ("K6b", "ladder_init_kernel", 44),
                         ("K6c", "replica_swap_kernel", 18),
                         ("the CS log-posterior", "logpost_warp_kernelI11CSWarpModel", 12),
                         ("K4s", "epoch_summary_kernel", 4),
                         ("K3's warp form", "bandflux_warp_kernel", 2),
                         ("K5", "percentile_kernel", 8),
                         ("K8", "sifto_kernel", 4),
                         ("K10", "logpost_warp_kernelI12SEDWarpModel", 8),
                         ("K10's run form", "stretch_run_kernelI12SEDWarpModel", 32),
                         ("the SC log-posterior", "logpost_warp_kernelI11SCWarpModel", 8),
                         ("the SC4 log-posterior", "logpost_warp_kernelI12SC4WarpModel", 8),
                         ("the SC log-posterior's latency form",
                          "logpost_latency_kernelI11SCWarpModel", 8),
                         ("the SC4 log-posterior's latency form",
                          "logpost_latency_kernelI12SC4WarpModel", 8),
                         ("K6b's latency form over SC", "ladder_init_latency_kernelI11SCWarpModel",
                          8),
                         ("K6b's latency form over SC4",
                          "ladder_init_latency_kernelI12SC4WarpModel", 8),
                         ("P1's latency form", "logpost_latency_kernelI15PopSC2WarpModel", 12)):
        block[what] = [v for k, v in report.items() if key in k]
        if len(block[what]) != n or any(v[1] or v[2] or v[3] for v in block[what]):
            raise AssertionError(f"{what} ({n} instantiations) must keep its state in "
                                 f"registers: {block[what]}")
    k6a_latency = {k: v for k, v in report.items() if "tempered_half_step_latency_kernel" in k}
    if len(k6a_latency) != 8 or any(v[2] or v[3] for v in k6a_latency.values()):
        raise AssertionError(f"K6a's latency form (8 instantiations) must not spill: "
                             f"{k6a_latency}")
    phase("build", f"{'built' if info['built'] else 'reused'} {os.path.relpath(info['path'], REPO)} "
          f"in {time.perf_counter() - t0:.2f} s; ptxas: {len(regs)} kernels, "
          f"{sorted(set(r.split('Used ')[-1] for r in regs))[:4]}; no stack frame and no "
          "spills in the block-per-chain kernels (ndim 4, 5; f32, f64), K4p (ndim 2, 3; f32, "
          "f64), the epoch half-step (ndim 2, 3; its 16 dtype instantiations each), K4's "
          "values in both forms (ndim 2, 3; 4 dtype instantiations each), K6d (16-byte and "
          "scalar loads), the SC3 "
          "log-posterior (ndim 7, 8; its 4 dtype instantiations each), K1 (ndim 4, 5; 4 each), "
          "K6b (over SC2 ndim 4, 5, over SC3 7, 8, over CS 7, 8, 9, over SC and SC4 5, 6; 4 "
          "each), K6c (ndim 1-9; "
          "f32, f64 state), the CS log-posterior (ndim 7, 8, 9; 4 each), K4s (4 dtype "
          "instantiations), K3's warp form (f32, f64), K5 (1-8 percentiles), K8 (both "
          "forms, f32, f64), K10 (ndim 2, 3; 4 dtype instantiations each), K10's run "
          "form (ndim 2, 3; its 16 dtype instantiations each), the SC and SC4 "
          "log-posteriors (ndim 5, 6; 4 each), the latency forms of the SC and SC4 "
          "log-posteriors and of K6b over them (ndim 5, 6; 4 each) and P1's latency form "
          "(ndim 3-5; 4 each): "
          + "; ".join(f"{what} registers {sorted(set(v[0] for v in ks))}, stack frames "
                      f"{sorted(set(v[1] for v in ks))} bytes, spills "
                      f"{sorted(set(v[2] + v[3] for v in ks))}" for what, ks in block.items())
          + "; K6a over SC3 (the walker's dimension at run time) " + "; ".join(
              f"registers {v[0]}, stack frame {v[1]} bytes, spills {v[2] + v[3]}"
              for k, v in report.items()
              if "tempered_half_step_kernelI12SC3WarpModel" in k)
          + "; the SC and SC4 half-steps and K6a over them (the walker's dimension at run "
          "time) " + "; ".join(
              f"{k.split('(')[0][4:]}: registers {v[0]}, stack frame {v[1]} bytes, spills "
              f"{v[2] + v[3]}" for k, v in report.items()
              if any(m in k for m in ("half_step_kernelI11SCWarpModel",
                                      "half_step_kernelI12SC4WarpModel")))
          + "; the SC and SC4 half-steps' latency form (16 dtype instantiations each) " + "; ".join(
              f"{m}: registers {sorted({v[0] for k, v in report.items() if key in k})}, stack "
              f"frames {sorted({v[1] for k, v in report.items() if key in k})} bytes, spills "
              f"{sorted({v[2] + v[3] for k, v in report.items() if key in k})}"
              for m, key in (("SC", "stretch_half_step_latency_kernelI11SCWarpModel"),
                             ("SC4", "stretch_half_step_latency_kernelI12SC4WarpModel")))
          + "; K6a's latency form over SC and SC4 (4 dtype instantiations each) " + "; ".join(
              f"{k.split('(')[0][4:]}: registers {v[0]}, stack frame {v[1]} bytes, spills "
              f"{v[2] + v[3]}" for k, v in k6a_latency.items())
          + "; K10's half-step (SEDWarpModel, 32 instantiations) " + ", ".join(
              f"registers {v[0]}, stack frame {v[1]} bytes, spills {v[2] + v[3]}"
              for v in sorted({tuple(v) for k, v in report.items()
                               if "stretch_half_step_kernelI12SEDWarpModel" in k})))
    # the bolometric packing (SN 2016bkv's bins) assumes the native binning,
    # built from the port's own source: the numpy fallback gives other bits
    from lightcurve_fitting_tpu_torch.utils import native
    if not native.available():
        raise AssertionError(f"the native host kernels did not build from "
                             f"{os.path.relpath(native._SRC, REPO)} (g++?): the bolometric "
                             "packing assumes them")
    phase("native", f"host kernels built from {os.path.relpath(native._SRC, REPO)} into "
          f"{os.path.relpath(native._LIB_PATH, REPO)}")

    k_pop = phase_pop_kernels()
    launches_pop = phase_pop_main_path(smi)
    launches_refit = phase_refit(smi)
    launches_sbc = phase_sbc(smi)
    k_pop_sc = phase_pop_sc_kernels()
    launches_pop_sc = phase_pop_sc_main_path(smi)
    launches_refit_sc = phase_refit_sc(smi)
    kernels = pop_kernel_entries(k_pop, {**launches_pop, **launches_refit, "30": launches_sbc})
    kernels += pop_sc_kernel_entries(k_pop_sc, {**launches_pop_sc, **launches_refit_sc})

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
    groups = sn2016bkv_seds()
    k10 = phase_k10(groups)
    k10_half = phase_k10_half(groups)
    k10_run = phase_k10_run(groups)
    launches_seq = phase_sequential_bolometric(groups, smi)
    launches_wide = phase_sed_acceptance(groups, smi)
    k6a, k6a_sc3 = phase_k6a(lc, lcf)
    lc_ia, lc0 = ia_lc()
    k6b, k6c, k6d = phase_k6bcd(lc, lcf, lc_ia, lc0)
    launches_ladder = phase_ladder_main_path(lc, smi)
    launches_sc3_ladder = phase_sc3_ladder_main_path(lc, smi)
    k7 = phase_k7(lc)
    k9 = phase_k9(lc)
    k7h = phase_k7h(lc)
    launches_grad = phase_gradient_main_path(lc, smi)
    phase_use_sigma(lc, lcf, lc_ia, lc0)
    k8 = phase_k8(lc_ia, lc0)
    k_cs = phase_cs_logpost(lc_ia, lc0)
    launches_cs, k8_staged = phase_cs_main_path(lc_ia, lc0, smi)
    k_sc = phase_sc_kernels(lc)
    launches_sc, _ = phase_sc_main_path(lc, smi)
    if any(m.startswith("jax") or m.startswith("lightcurve_fitting_tpu.") or
           m == "lightcurve_fitting_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    src = "lightcurve_fitting_tpu_torch/kernels/csrc/sc2_logpost.cu"
    src3 = "lightcurve_fitting_tpu_torch/kernels/csrc/sc3_logpost.cu"
    src4 = "lightcurve_fitting_tpu_torch/kernels/csrc/epoch_bb.cu"
    src_cs = "lightcurve_fitting_tpu_torch/kernels/csrc/companion.cu"
    src_sc = "lightcurve_fitting_tpu_torch/kernels/csrc/sc_logpost.cu"
    kernels = [
        *kernels,
        dict(name="logpost_warp_kernel<SC2WarpModel<C, N>> (K1)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/fitting.py:62", launches=launches["sc2_logpost"],
             **k1),
        dict(name="stretch_half_step_kernel<SC2WarpModel> (K2)", route="cuda", source=src,
             replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches["stretch_half_step"], **k2),
        dict(name="bandflux_warp_kernel / bandflux_kernel (K3)", route="cuda", source=src3,
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
        dict(name="percentile_kernel<T> (K5, radix select)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/quantile.cu",
             replaces="lightcurve_fitting_tpu/ops/quantile.py:46",
             launches=launches_bol["percentile"], **k5),
        dict(name="tempered_half_step_kernel<SC2WarpModel> (K6a)", route="cuda",
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
        dict(name="sifto_kernel<C, false> (K8, direct form)", route="cuda", source=src_cs,
             replaces="lightcurve_fitting_tpu/models/companion_shocking.py:45",
             launches=launches_cs["sifto_direct"], **k8),
        dict(name="sifto_kernel<C, true> (K8, staged form)", route="cuda", source=src_cs,
             replaces="lightcurve_fitting_tpu/models/companion_shocking.py:45",
             launches=launches_cs["sifto_staged"], **k8_staged),
        dict(name="logpost_warp_kernel<CSWarpModel<C, N>> (CS log-posterior)", route="cuda",
             source=src_cs,
             replaces="lightcurve_fitting_tpu/models/companion_shocking.py:120",
             launches=launches_cs["cs_logpost"], **k_cs["logpost"]),
        dict(name="stretch_half_step_kernel<CSWarpModel> (CS half-step)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches_cs["cs_half_step"], **k_cs["half"]),
        dict(name="tempered_half_step_kernel<CSWarpModel> (K6a over CS)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/evidence.py:60",
             launches=launches_cs["tempered_half_step"], **k_cs["k6a"]),
        dict(name="ladder_init_kernel<CSWarpModel<C, N>> (K6b over CS)", route="cuda",
             source=src_cs, replaces="lightcurve_fitting_tpu/parallel/evidence.py:229",
             launches=launches_cs["ladder_init"], **k6b["cs"]),
        dict(name="tempered_half_step_kernel<SC3WarpModel> (K6a over SC3)", route="cuda",
             source=src3, replaces="lightcurve_fitting_tpu/parallel/evidence.py:60",
             launches=launches_sc3_ladder["tempered_half_step"], **k6a_sc3),
        dict(name="ladder_init_kernel<SC3WarpModel<C, N>> (K6b over SC3)", route="cuda",
             source=src3, replaces="lightcurve_fitting_tpu/parallel/evidence.py:229",
             launches=launches_sc3_ladder["ladder_init"], **k6b["sc3"]),
        dict(name="logpost_warp_kernel<SEDWarpModel<C, N>> (K10)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/sed.cu",
             replaces="lightcurve_fitting_tpu/bolometric.py:81",
             launches=launches_seq["min_nfilt_1"]["sed_logpost"], **k10),
        dict(name="stretch_half_step_kernel<SEDWarpModel<C, N>> (K10 half-step)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/sed.cu",
             replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
             launches=launches_wide["sed_half_step"], **k10_half),
        dict(name="stretch_run_kernel<SEDWarpModel<C, N>> (K10 run form)", route="cuda",
             source="lightcurve_fitting_tpu_torch/kernels/csrc/stretch.cuh",
             replaces="lightcurve_fitting_tpu/parallel/sampler.py:205",
             launches=launches_seq["min_nfilt_1"]["sed_run"], **k10_run),
    ]
    for prefix, policy, replaces in (
            ("sc", "SCWarpModel", "lightcurve_fitting_tpu/models/shock_cooling.py:71"),
            ("sc4", "SC4WarpModel", "lightcurve_fitting_tpu/models/shock_cooling.py:247")):
        what = prefix.upper()
        kernels += [
            dict(name=f"logpost_warp_kernel<{policy}<C, N>> / logpost_latency_kernel<{policy}<"
                      f"C, N>> ({what} log-posterior; launched on 26a-c ({SC_FIT_WALKERS}, "
                      f"{SC_LP_WIDTHS[0]} walkers): warp form "
                      f"{launches_sc[f'{prefix}_logpost_warp']}, latency form "
                      f"{launches_sc[f'{prefix}_logpost_latency']}; times at {HEADLINE_WALKERS} "
                      "in the rule's form; device ms by form on the window's walkers: "
                      + "; ".join(f"{w} warp {t[0]['warp']:.4f}, latency {t[0]['latency']:.4f}"
                                  for w, t in k_sc[prefix]["logpost_forms"].items()) + ")",
                 route="cuda", source=src_sc, replaces=replaces,
                 launches=launches_sc[f"{prefix}_logpost"], **k_sc[prefix]["logpost"]),
            dict(name=f"stretch_half_step_kernel<{policy}> / stretch_half_step_latency_kernel<"
                      f"{policy}> ({what} half-step; launched on 26a-c (half "
                      f"{SC_FIT_WALKERS // 2}, {SC_LP_WIDTHS[0] // 2}): warp form "
                      f"{launches_sc[f'{prefix}_half_step_warp']}, latency form "
                      f"{launches_sc[f'{prefix}_half_step_latency']}; times at half "
                      f"{SC_FIT_WALKERS // 2} in the rule's form)", route="cuda",
                 source=src_sc, replaces="lightcurve_fitting_tpu/parallel/sampler.py:86",
                 launches=launches_sc[f"{prefix}_half_step"], **k_sc[prefix]["half"]),
            dict(name=f"tempered_half_step_kernel<{policy}> / tempered_half_step_latency_kernel<"
                      f"{policy}> (K6a over {what}; launched on 26b ({SC_LADDER[0]} x "
                      f"{SC_LADDER[1]}): warp form "
                      f"{launches_sc[f'{prefix}_tempered_half_step_warp']}, latency form "
                      f"{launches_sc[f'{prefix}_tempered_half_step_latency']}; times at "
                      f"{SC_LADDER[0]} x {SC_LADDER[1]} in the rule's form; device ms by form: "
                      + "; ".join(f"{Rl} x {Wl} warp {t[0]['warp']:.4f}, latency "
                                  f"{t[0]['latency']:.4f}"
                                  for (Rl, Wl), t in k_sc[prefix]["k6a_forms"].items()) + ")",
                 route="cuda", source="lightcurve_fitting_tpu_torch/kernels/csrc/ladder.cuh",
                 replaces="lightcurve_fitting_tpu/parallel/evidence.py:60",
                 launches=launches_sc[f"{prefix}_tempered_half_step"],
                 **k_sc[prefix]["k6a"]),
            dict(name=f"ladder_init_kernel<{policy}<C, N>> / ladder_init_latency_kernel<"
                      f"{policy}<C, N>> (K6b over {what}; launched on 26b ({SC_LADDER[1]} "
                      f"states): warp form {launches_sc[f'{prefix}_ladder_init_warp']}, latency "
                      f"form {launches_sc[f'{prefix}_ladder_init_latency']}; times at "
                      f"{SC_LADDER[0]} x {SC_LADDER[1]} in the rule's form; device ms by form: "
                      + "; ".join(f"{Rb} x {Wb} warp {t[0]['warp']:.4f}, latency "
                                  f"{t[0]['latency']:.4f}"
                                  for (Rb, Wb), t in k_sc[prefix]["k6b_forms"].items()) + ")",
                 route="cuda", source="lightcurve_fitting_tpu_torch/kernels/csrc/ladder.cuh",
                 replaces="lightcurve_fitting_tpu/parallel/evidence.py:229",
                 launches=launches_sc[f"{prefix}_ladder_init"], **k_sc[prefix]["k6b"])]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def pop_kernel_entries(k_pop, launches):
    """The kernels line's rows of P1-P3: launches from 28a (the example at
    its defaults; 28a-c's by form in the name), errors from 27's float32
    cases, times at S = 64 (27; the other sizes' in the name)."""
    src = "lightcurve_fitting_tpu_torch/kernels/csrc/population.cu"
    rows = []
    for key, kname, count, replaces in (
            ("P1", "logpost_warp_kernel<PopSC2WarpModel<C, N>> / logpost_latency_kernel<"
                   "PopSC2WarpModel<C, N>, S, true> (P1)", "pop_logpost",
             "lightcurve_fitting_tpu/parallel/population.py:349"),
            ("P2", "stretch_half_step_kernel<PopSC2WarpModel<C, N>> / "
                   "stretch_half_step_latency_kernel<PopSC2WarpModel<C, N>> (P2)", "pop_half_step",
             "lightcurve_fitting_tpu/parallel/population.py:413"),
            ("P3", "pop_map_kernel<C, N, WPS> (P3)", "pop_map",
             "lightcurve_fitting_tpu/parallel/population.py:204")):
        v = dict(k_pop[key])
        at = v.pop("at")
        forms = v.pop("forms", None)
        refit = v.pop("refit", None)
        name = f"{kname}; ms by S (events, device, plain, bound): " + "; ".join(
            f"{S}: {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.5f}" for S, t in at.items())
        if forms:
            name += ("; launched by form: " + "; ".join(
                f"{run} " + ", ".join(f"{f} {n[f'{count}_{f}']}" for f in POP_FORMS[count])
                for run, n in launches.items())
                + "; device ms by form and S: " + "; ".join(
                    f"{S}: " + ", ".join(f"{f} {ms:.4f}" for f, ms in fs.items())
                    for S, fs in forms.items()))
        if refit:
            name += ("; device ms by form at the exact-refit CV's widths (S x walkers at padded "
                     "points): " + "; ".join(
                         f"{S} x {POP_WALKERS} at {n}: warp {t['warp']:.4f}, latency "
                         f"{t['latency']:.4f} (bound {t['bound_ms']:.5f})"
                         for (S, n), t in refit.items()))
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches["28a"][count], **v))
    return rows


def pop_sc_kernel_entries(k_pop_sc, launches):
    """The kernels line's rows of P1 and P2 over SW17 and MSW23: launches
    summed over 31's fits and 32's refits (each run counted from 0 just
    before it; by run and form in the name), errors from 31's float32 cases
    over both classes and 32's widths, times at S = 64 over SW17 (31;
    MSW23's and those at 32's widths in the name)."""
    src = "lightcurve_fitting_tpu_torch/kernels/csrc/pop_sc.cu"
    rows = []
    for key, kname, kind, replaces in (
            ("P1", "logpost_warp_kernel<PopSCWarpModel<C, N>> / logpost_latency_kernel<"
                   "PopSCWarpModel<C, N>, S, true> and the same over PopSC4WarpModel<C, N> (P1 "
                   "over SW17 and MSW23)", "logpost",
             "lightcurve_fitting_tpu/parallel/population.py:349"),
            ("P2", "stretch_half_step_kernel<PopSCWarpModel<C, N>> / "
                   "stretch_half_step_latency_kernel<PopSCWarpModel<C, N>> and the same over "
                   "PopSC4WarpModel<C, N> (P2 over SW17 and MSW23)", "half_step",
             "lightcurve_fitting_tpu/parallel/population.py:413")):
        v = dict(k_pop_sc[key])
        at, forms, refit = v.pop("at"), v.pop("forms"), v.pop("refit")
        counts = {run: ("pop_sc4" if any(c.startswith("pop_sc4_") for c in n) else "pop_sc", n)
                  for run, n in launches.items()}
        name = (f"{kname}; ms at S = {SC_POP_S} x {POP_WALKERS} by class (events, device, plain, "
                "bound): " + "; ".join(f"{c}: {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.5f}"
                                        for c, t in at.items())
                + "; device ms by form: " + "; ".join(
                    f"{c}: " + ", ".join(f"{f} {ms:.4f}" for f, ms in fs.items())
                    for c, fs in forms.items())
                + "; device ms at the exact-refit CV's widths (S x walkers at padded points): "
                + "; ".join(f"{c} {k} {t['S']} x {POP_WALKERS} at {t['n']}: " + (
                    f"warp {t['warp']:.4f}, latency {t['latency']:.4f}, plain {t['plain']:.4f}"
                    + f" (bound {t['bound_ms']:.5f})" if key == "P1"
                    else f"warp {t['p2_warp']:.4f} (bound {t['p2_bound_ms']:.5f})")
                    for (c, k), t in refit.items())
                + "; launched by run and form: " + "; ".join(
                    f"{run} " + ", ".join(f"{f} {n[f'{c}_{kind}_{f}']}"
                                          for f in ("warp", "latency"))
                    for run, (c, n) in counts.items()))
        rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=sum(n[f"{c}_{kind}"] for c, n in counts.values()), **v))
    return rows


if __name__ == "__main__":
    main()
