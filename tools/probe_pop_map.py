#!/usr/bin/env python3
"""How far P3 (the population's MAP ascent, ``kernels/pop.py::map_ascent``)
and its plain version part, step by step, on the card.

On examples/fit_population.py's population (S = 64, ``chip_smoke.pop_example``),
16 starts a transient from ``default_rng(27)`` (``chip_smoke.py`` 27's),
without and with the intrinsic scatter, in float32 and float64 compute:
for n = 1, 2, 3, 10, 50 and 400 Adam steps from the same starts, the largest
and the median |u_kernel - u_plain| over all starts, the start where it is
largest with both iterates, and the largest relative difference of the
final -log p. Run on the card from the repository root:
``python3 tools/probe_pop_map.py``.

``--f64 SEEDS`` prints instead, for ``chip_smoke.py`` 27's four cases (S =
64 and 512, the MJD-scale twin, the intrinsic scatter) and starts from
``default_rng(seed)`` for each comma-separated seed, how far each float32
ascent (P3's, the plain one's) lands from the float64 plain ascent's MAP:
each transient's best MAP point's float64 -log p less the float64 ascent's,
over the term scale (``chip_smoke.pop_map_f64_gaps``), the readings that
``chip_smoke.POP_MAP_F64`` is set from.
"""

import os
import sys

import numpy as np


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_pop_map: CUDA is not available; this script runs on the GPU")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.kernels import pop as kpop
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    if "--f64" in sys.argv:
        return f64_gaps(chip_smoke, dev, [int(v) for v in
                                          sys.argv[sys.argv.index("--f64") + 1].split(",")])
    lcs, models, _ = chip_smoke.pop_example(64, dev)
    for label in ("f32", "f64"):
        try:
            if label == "f64":
                config.set_compute_dtype(torch.float64)
            for sigma in (False, True):
                priors, lo, up = chip_smoke.pop_priors(False, sigma)
                pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                         priors, sigma)
                bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
                x_st = np.random.default_rng(27).uniform(lo, up, size=(64, 16, len(lo)))
                u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
                for n in (1, 2, 3, 10, 50, 400):
                    u_k, n_k = kpop.map_ascent(pp, u0, bounds, n)
                    u_p, n_p = kpop.map_ascent_plain(pp, u0, bounds, n)
                    du = (u_k - u_p).abs()
                    dn = (n_k - n_p).abs() / n_p.abs().clamp_min(1e-12)
                    s, k = divmod(int(du.amax(dim=-1).flatten().argmax()), u0.shape[1])
                    print(f"{label} sigma={sigma} n_iter={n}: max |du| {float(du.max()):.3e} "
                          f"(transient {s} start {k}: kernel u {u_k[s, k].tolist()}, plain u "
                          f"{u_p[s, k].tolist()}), median |du| {float(du.median()):.3e}, max "
                          f"relative d(-log p) {float(dn.max()):.3e}", flush=True)
        finally:
            config.set_compute_dtype(config.AUTO)


def f64_gaps(chip_smoke, dev, seeds):
    import torch
    from lightcurve_fitting_tpu_torch.core import config
    from lightcurve_fitting_tpu_torch.parallel.hmc import BoundsTransform
    from lightcurve_fitting_tpu_torch.parallel.population import (PopulationPosterior,
                                                                  pack_population)
    cases = [("S64", 64, False, False), ("S512", 512, False, False),
             ("S64 MJD t_exp", 64, True, False), ("S64 sigma", 64, False, True)]
    pops = {(S, mjd): chip_smoke.pop_example(S, dev, mjd=mjd) for _, S, mjd, _ in cases}
    for seed in seeds:
        for case, S, mjd, sigma in cases:
            lcs, models, _ = pops[(S, mjd)]
            priors, lo, up = chip_smoke.pop_priors(mjd, sigma)
            bounds = BoundsTransform([p.p_min for p in priors], [p.p_max for p in priors])
            x_st = np.random.default_rng(seed).uniform(lo, up, size=(S, chip_smoke.POP_STARTS,
                                                                     len(lo)))
            u0 = torch.as_tensor(bounds.to_unbounded(x_st), device=dev).contiguous()
            got = {}
            for label in ("f32", "f64"):
                try:
                    if label == "f64":
                        config.set_compute_dtype(torch.float64)
                    pp = PopulationPosterior(pack_population(models, lcs, sigma, dev), models[0],
                                             priors, sigma)
                    got[label] = chip_smoke.pop_check_map(case, pp, u0, bounds, None, False)
                    if label == "f64":
                        g, nearer = chip_smoke.pop_map_f64_gaps(
                            case, pp, {"kernel": got["f32"]["best_kernel"],
                                       "plain": got["f32"]["best_plain"]},
                            got["f64"]["best_plain"], None)
                finally:
                    config.set_compute_dtype(config.AUTO)
            print(f"seed {seed} {case}: f32 P3 {g['kernel']:.3e}, f32 plain {g['plain']:.3e} "
                  f"of the term scale from the float64 plain ascent's -log p; P3 nearer at "
                  f"{nearer} of {S}; f64 P3 against f64 plain {got['f64']['max_v']:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
