#!/usr/bin/env python3
"""How far an exact-refit CV refit's acceptance moves with the seed alone, at
``chip_smoke.py`` 32's own refits, on the card and on the CPU.

Runs 32's ``compare_models_loo`` (SW17 against MSW23 on SN 2016bkv, 64
walkers x 500 + 500, seed 7, ``refit=True``, ``init="window"``,
``group_by="filter"``) on the card and keeps its refit calls (their box is
the card chain's [2, 98] percentiles, as in 32). Then, for each model:

* each refit call again on the card (float32 compute, as 32) at seeds 0 to
  ``--card-seeds`` - 1;
* 32's pooled refits (``chip_smoke.refit_sc_pool``: every
  leave-one-band-out refit and 16 leave-one-point-out ones) again on the
  CPU in float64 (``chip_smoke.refit_sc_cpu``) at seeds 0 to
  ``--cpu-seeds`` - 1.

With ``--device cpu`` the whole run stays on the CPU: the chain of 32's
``compare_models_loo`` is drawn on the CPU, its refit calls are kept but
not fitted (their box and curves are what matter), and only the CPU's
seeds run.

It prints, over the pooled refits, each refit's standard deviation over the
seeds pooled over the refits, on the card and on the CPU
(``chip_smoke.REFIT_SC_SD`` holds the CPU's of a ``--device cpu`` run),
the standard error of 32's statistic (the mean of the card's acceptance
less the CPU's) that they give, and the statistic at each seed both sides
ran, whose spread over the seeds that standard error should match. The
last line is one JSON object of these.

    python3 tools/probe_refit_spread.py [--card-seeds 8] [--cpu-seeds 3] [--device cpu]

Needs a CUDA card unless ``--device cpu``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pooled_sd(accs):
    """Each refit's standard deviation over the seeds (rows), pooled over the
    refits (columns) as the root of the mean variance."""
    return float(np.sqrt(np.mean(np.var(np.asarray(accs), axis=0, ddof=1))))


def kept_calls(record):
    """A stand-in for the port's fit_population that ``_exact_cv_elpd``
    reaches: each call's arguments appended to ``record``, no fit, 16 draws
    a refit at its box's middle and acceptance 0 returned. Returns
    (install, restore)."""
    from lightcurve_fitting_tpu_torch.parallel import population
    original = population.fit_population

    def kept(models, lcs, priors, **kw):
        mid = (np.asarray(kw["p_lo"], float) + np.asarray(kw["p_up"], float)) / 2
        record.append({"models": models, "lcs": lcs, "priors": priors, "kw": kw,
                       "flat": np.tile(mid, (len(lcs), 16, 1)), "acc": np.zeros(len(lcs))})
        return record[-1]["flat"], record[-1]["acc"]

    def install():
        population.fit_population = kept

    def restore():
        population.fit_population = original
    return install, restore


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card-seeds", type=int, default=8)
    ap.add_argument("--cpu-seeds", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from lightcurve_fitting_tpu_torch import fitting
    from lightcurve_fitting_tpu_torch.parallel import fit_population
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        sys.exit("probe_refit_spread: needs a CUDA card (or --device cpu)")
    dev = torch.device(args.device)
    lc = cs.flagship_lc()
    record = []
    install, restore = (cs.refit_calls if on_card else kept_calls)(record)
    install()
    try:
        t0 = time.perf_counter()
        cs.hushed(fitting.compare_models_loo, lc, [cs.sc_model(n, lc) for n in cs.SC_NAMES],
                  cs.sc_priors(), p_lo=cs.SC_LO, p_up=cs.SC_UP, labels=list(cs.SC_NAMES),
                  nwalkers=64, nsteps=500, nsteps_burnin=500, seed=7, refit=True,
                  refit_options={"init": "window"}, group_by="filter", quiet=True, device=dev)
        print(f"compare_models_loo with its refits: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        restore()
    out = {}
    for name in cs.SC_NAMES:
        calls = {}
        for call in record:
            if type(call["models"][0]).__name__ == name:
                kind = "LOGO" if max(len(sub) for sub in call["lcs"]) < len(lc) - 1 else "LOPO"
                calls[kind] = call
        print(f"{name}: refit calls " + ", ".join(
            f"{k} S = {len(c['lcs'])}, seed {c['kw']['seed']}, mean acceptance "
            f"{float(np.mean(c['acc'])):.4f}" for k, c in calls.items())
              + f"; box {np.round(next(iter(calls.values()))['kw']['p_lo'], 4)} to "
              f"{np.round(next(iter(calls.values()))['kw']['p_up'], 4)}", flush=True)
        card = []
        for seed in range(args.card_seeds if on_card else 0):
            again = {}
            for kind, call in calls.items():
                _, acc = fit_population(call["models"], call["lcs"], call["priors"],
                                        **dict(call["kw"], seed=seed))
                again[kind] = dict(call, acc=acc)
            card.append(cs.refit_sc_pool(again)[1])
            print(f"  card seed {seed}: pooled acceptances {np.round(card[-1], 4)}", flush=True)
        cpu = []
        model_cpu = cs.sc_model(name, lc, device="cpu")
        for seed in range(args.cpu_seeds):
            acc, _, seconds = cs.refit_sc_cpu(calls, model_cpu, seed=seed)
            cpu.append(acc)
            print(f"  CPU float64 seed {seed} ({seconds:.1f} s): {np.round(acc, 4)}", flush=True)
        sd_cpu = pooled_sd(cpu)
        sd_card = pooled_sd(card) if on_card else sd_cpu
        n = len(cpu[0])
        se = float(np.sqrt((sd_card ** 2 + sd_cpu ** 2) / n))
        stat = [float(np.mean(card[s] - cpu[s])) for s in range(min(len(card), len(cpu)))]
        out[name] = {"sd_card": sd_card if on_card else None, "sd_cpu": sd_cpu, "n": n,
                     "se": se, "stat_by_seed": stat,
                     "card_mean": float(np.mean(card)) if on_card else None,
                     "cpu_mean": float(np.mean(cpu))}
        print(f"{name}: over {n} pooled refits, one refit's standard deviation over the seeds "
              + (f"{sd_card:.4f} on the card ({args.card_seeds} seeds), " if on_card else "")
              + f"{sd_cpu:.4f} on the CPU ({args.cpu_seeds}); the statistic's standard error "
              f"{se:.4f}" + (" (the card's spread taken as the CPU's)" if not on_card else "")
              + (f", its values at seeds 0-{len(stat) - 1} {np.round(stat, 4)}; mean "
                 f"acceptance card {out[name]['card_mean']:.4f}, CPU "
                 f"{out[name]['cpu_mean']:.4f}" if on_card else ""), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
